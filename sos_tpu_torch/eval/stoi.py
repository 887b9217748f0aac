"""Short-Time Objective Intelligibility (STOI) — native implementation.

The port's copy of `sos_tpu/eval/stoi.py`.

The reference delegates to pystoi (`metrics.py:341-343`), which is not
available here; this reimplements the classic STOI measure (Taal,
Hendriks, Heusdens, Jensen, ICASSP 2010) with the standard constants so
scores are comparable with pystoi:

  10 kHz analysis rate; 256-sample Hann frames, 50% overlap, 512 FFT;
  silent-frame removal at 40 dB below the loudest clean frame; 15
  one-third-octave bands from 150 Hz; 384 ms (30-frame) segments;
  normalization + clipping at -15 dB SDR; averaged band correlations.

pystoi-faithful details deliberately matched: frames are taken with
pystoi's exclusive range (a final exactly-fitting frame is dropped —
pystoi deviates from the MATLAB original here) and resampling to 10 kHz
uses scipy.signal.resample_poly, the same resampler pystoi calls.
Validated against an independently-transcribed per-band/per-segment
literal oracle in tests/test_stoi_literal.py.
"""

from __future__ import annotations

import numpy as np

from scipy.signal import resample_poly as _resample_poly

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150.0
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0
_EPS = np.finfo(np.float64).eps


def _hann_interior(n: int) -> np.ndarray:
    return np.hanning(n + 2)[1:-1]


def _frame(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    # pystoi's exclusive range: range(0, len(x) - framelen, hop)
    starts = range(0, len(x) - framelen, hop)
    out = [x[s:s + framelen] for s in starts]
    return np.stack(out) if out else np.zeros((0, framelen))


def _overlap_add(frames: np.ndarray, hop: int) -> np.ndarray:
    n, flen = frames.shape
    out = np.zeros((n - 1) * hop + flen)
    for i in range(n):
        out[i * hop:i * hop + flen] += frames[i]
    return out


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    w = _hann_interior(N_FRAME)
    hop = N_FRAME // 2
    xf = _frame(x, N_FRAME, hop) * w
    yf = _frame(y, N_FRAME, hop) * w
    if len(xf) == 0:
        return x, y
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + _EPS)
    mask = energies > np.max(energies) - DYN_RANGE
    if not np.any(mask):
        return np.zeros(0), np.zeros(0)
    return _overlap_add(xf[mask], hop), _overlap_add(yf[mask], hop)


def _third_octave_matrix():
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUMBAND, dtype=np.float64)
    freq_low = MINFREQ * np.power(2.0, (2 * k - 1) / 6)
    freq_high = MINFREQ * np.power(2.0, (2 * k + 1) / 6)
    obm = np.zeros((NUMBAND, len(f)))
    for i in range(NUMBAND):
        lo = int(np.argmin(np.square(f - freq_low[i])))
        hi = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, lo:hi] = 1.0
    return obm


def _band_envelopes(sig: np.ndarray, obm: np.ndarray) -> np.ndarray:
    w = _hann_interior(N_FRAME)
    frames = _frame(sig, N_FRAME, N_FRAME // 2) * w
    spec = np.fft.rfft(frames, NFFT, axis=1)  # (T, 257)
    power = np.abs(spec) ** 2
    return np.sqrt(power @ obm.T).T  # (NUMBAND, T)


def stoi(clean: np.ndarray, denoised: np.ndarray, fs: int,
         extended: bool = False) -> float:
    """STOI score in [~0, 1]; higher is more intelligible."""
    if extended:
        raise NotImplementedError("extended STOI is not used by the pipeline")
    clean = np.asarray(clean, dtype=np.float64)
    denoised = np.asarray(denoised, dtype=np.float64)
    n = min(len(clean), len(denoised))
    clean, denoised = clean[:n], denoised[:n]
    if fs != FS:
        clean = _resample_poly(clean, FS, fs).astype(np.float64)
        denoised = _resample_poly(denoised, FS, fs).astype(np.float64)

    clean, denoised = _remove_silent_frames(clean, denoised)
    if len(clean) < N_FRAME * 2:
        return float("nan")

    obm = _third_octave_matrix()
    x = _band_envelopes(clean, obm)      # (15, T)
    y = _band_envelopes(denoised, obm)
    num_frames = x.shape[1]
    if num_frames < N_SEG:
        return float("nan")

    clip_value = 10 ** (-BETA / 20)
    corrs = []
    for m in range(N_SEG, num_frames + 1):
        xs = x[:, m - N_SEG:m]
        ys = y[:, m - N_SEG:m]
        alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
            np.linalg.norm(ys, axis=1, keepdims=True) + _EPS)
        ys_prime = np.minimum(ys * alpha, xs * (1 + clip_value))
        xs_c = xs - xs.mean(axis=1, keepdims=True)
        ys_c = ys_prime - ys_prime.mean(axis=1, keepdims=True)
        xs_n = xs_c / (np.linalg.norm(xs_c, axis=1, keepdims=True) + _EPS)
        ys_n = ys_c / (np.linalg.norm(ys_c, axis=1, keepdims=True) + _EPS)
        corrs.append(np.sum(xs_n * ys_n, axis=1))
    return float(np.mean(np.stack(corrs)))
