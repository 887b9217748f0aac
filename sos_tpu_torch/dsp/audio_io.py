"""WAV I/O and resampling (a copy of `sos_tpu/dsp/audio_io.py`).

The port keeps its own copy of this numpy/scipy module so that it never
imports `sos_tpu`; the two must stay byte-for-byte equivalent in what
they read and write (`tests/test_torch_serve.py` holds them together).

The reference leans on librosa/soundfile for decode+resample
(m1 dataset.py:226, m1 tools.py:797-798); neither is available here, so
this module decodes RIFF/WAVE directly with numpy (PCM 8/16/24/32,
IEEE float32/64), downmixes to mono, and resamples with a polyphase
kaiser-windowed filter (scipy.signal.resample_poly) — the same family of
resampler as librosa's `kaiser_best`.
"""

from __future__ import annotations

import math
import struct
import wave
from typing import Optional, Tuple

import numpy as np
from scipy import signal as _signal


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 samples in [-1, 1] shaped (n,) or (n, ch), sr)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_fmt, channels, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE and len(raw) >= 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1 if bits != 32 else 3
    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}: {path}")
    elif audio_fmt == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_fmt}: {path}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    return x, sr


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write float waveform as 16-bit PCM WAV (librosa.output.write_wav analogue)."""
    y = np.asarray(y, dtype=np.float32)
    pcm = np.clip(y, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase kaiser resampling (librosa `kaiser_best`-class quality)."""
    if orig_sr == target_sr:
        return np.asarray(y, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = _signal.resample_poly(y, up, down, window=("kaiser", 12.9846))
    return out.astype(np.float32)


def load(
    path: str,
    sr: Optional[int] = None,
    mono: bool = True,
    offset: float = 0.0,
    duration: Optional[float] = None,
) -> Tuple[np.ndarray, int]:
    """librosa.load-compatible: decode, mono-downmix (channel mean), resample.

    Returns (float32 waveform, sample_rate). `sr=None` keeps the native rate.
    """
    y, native_sr = read_wav(path)
    if mono and y.ndim > 1:
        y = y.mean(axis=1)
    if offset or duration is not None:
        start = int(round(offset * native_sr))
        stop = len(y) if duration is None else start + int(round(duration * native_sr))
        y = y[start:stop]
    if sr is not None and sr != native_sr:
        y = resample(y, native_sr, sr)
        return y.astype(np.float32), sr
    return np.asarray(y, dtype=np.float32), native_sr


def duration_seconds(path: str) -> float:
    """Duration of a WAV file in seconds (ffprobe replacement for WAVs)."""
    y, sr = read_wav(path)
    n = len(y) if y.ndim == 1 else y.shape[0]
    return n / float(sr)
