"""Waveform / spectrogram rendering (reference visualization.py:15-41,157-190).

`draw_waveform` / `draw_spectrum` render stacked subplot panels to a BGR
uint8 ndarray (cv2.imwrite-ready) — used by the denoiser eval to save
side-by-side comparisons (m2 predict.py:485-516) and by the tensorboard
batch visualizer (m2 agent.py:206-233).

The port's copy of `sos_tpu/utils/visualization.py` (less the ffmpeg
video renderer, which the eval chain never calls). matplotlib is imported
inside each function, not with the module: a host without matplotlib
imports the port whole and fails only when it draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fig_to_bgr(fig) -> np.ndarray:
    plt = _pyplot()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf[..., ::-1].copy()  # RGB -> BGR


def draw_waveform(signals: Sequence[np.ndarray], sr: int = 14000,
                  titles: Optional[List[str]] = None) -> np.ndarray:
    plt = _pyplot()
    n = len(signals)
    fig, axes = plt.subplots(n, 1, figsize=(10, 2 * n), squeeze=False)
    for i, sig in enumerate(signals):
        ax = axes[i][0]
        t = np.arange(len(sig)) / sr
        ax.plot(t, sig, linewidth=0.4)
        ax.set_xlim(0, max(t[-1], 1e-3) if len(t) else 1)
        ax.set_ylim(-1, 1)
        if titles and i < len(titles):
            ax.set_title(titles[i], fontsize=9)
    fig.tight_layout()
    return _fig_to_bgr(fig)


def draw_spectrum(signals: Sequence[np.ndarray], sr: int = 14000,
                  titles: Optional[List[str]] = None,
                  n_fft: int = 510, hop_length: int = 158,
                  win_length: int = 400) -> np.ndarray:
    import torch

    from sos_tpu_torch.dsp.stft import stft

    plt = _pyplot()
    n = len(signals)
    fig, axes = plt.subplots(n, 1, figsize=(10, 2 * n), squeeze=False)
    for i, sig in enumerate(signals):
        ax = axes[i][0]
        spec = stft(torch.from_numpy(np.asarray(sig, np.float32))[None],
                    n_fft, hop_length, win_length)[0].numpy()
        mag = np.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2)
        db = 20 * np.log10(np.maximum(mag, 1e-8))
        db -= db.max()
        ax.imshow(db, origin="lower", aspect="auto", cmap="magma",
                  vmin=-80, vmax=0)
        if titles and i < len(titles):
            ax.set_title(titles[i], fontsize=9)
    fig.tight_layout()
    return _fig_to_bgr(fig)


def draw_bitstream_overlay(signal: np.ndarray, sr: int, bitstream: str,
                           framerate: float = 30.0) -> np.ndarray:
    """Waveform with silent intervals shaded (reference
    plot_wav_bitstream_overlay, m1 tools.py:580-660)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 3))
    t = np.arange(len(signal)) / sr
    ax.plot(t, signal, linewidth=0.4, zorder=2)
    for i, bit in enumerate(bitstream):
        if bit == "0":
            ax.axvspan(i / framerate, (i + 1) / framerate, color="orange",
                       alpha=0.3, linewidth=0, zorder=1)
    ax.set_xlim(0, max(t[-1], 1e-3) if len(t) else 1)
    ax.set_ylim(-1, 1)
    ax.set_xlabel("time (s)")
    fig.tight_layout()
    return _fig_to_bgr(fig)


def draw_floatstream_overlay(signal: np.ndarray, sr: int,
                             float_streams: np.ndarray,
                             labels: Optional[List[str]] = None,
                             framerate: float = 30.0) -> np.ndarray:
    """Waveform with per-frame confidence curves overlaid (reference
    plot_wav_floatstreams_overlay, m1 tools.py:663-767)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 3))
    t = np.arange(len(signal)) / sr
    ax.plot(t, signal, linewidth=0.4, alpha=0.6)
    streams = np.atleast_2d(np.asarray(float_streams))
    ft = (np.arange(streams.shape[1]) + 0.5) / framerate
    for k, stream in enumerate(streams):
        label = labels[k] if labels and k < len(labels) else f"stream{k}"
        ax.plot(ft, stream, linewidth=1.0, label=label)
    ax.legend(fontsize=8)
    ax.set_xlabel("time (s)")
    fig.tight_layout()
    return _fig_to_bgr(fig)


def save_image(path: str, bgr: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, bgr)
    except ImportError:  # matplotlib fallback
        _pyplot().imsave(path, bgr[..., ::-1])
