"""Native ITU-T P.862 (PESQ, narrowband) implementation in pure numpy.

The port's copy of `sos_tpu/eval/pesq.py`.

The reference pipeline scores every denoised utterance with PESQ via the
`pypesq` C extension (reference metrics.py:341-401, requirements.txt:10)
and folds it into the CSIG/CBAK/COVL composites. Neither `pypesq` nor
`pesq` (nor any other P.862 binary) exists in this environment, so this
module re-implements the P.862 narrowband algorithm end to end:

1. level alignment   — normalise both signals to 1e7 active-band power
                       (350-3250 Hz FFT filter);
2. input filtering   — IRS-receive-like FFT filter on both signals;
3. time alignment    — envelope cross-correlation (crude) + sample-level
                       cross-correlation refinement (fine);
4. perceptual model  — 32 ms Hann frames @50% overlap -> power spectra ->
                       Bark-band grouping -> partial frequency compensation
                       (bounded [0.01,100]) -> short-term gain compensation
                       (bounded [3e-4,5], 1st-order smoothed) -> Zwicker
                       loudness (exponent 0.23, low-band modification
                       (6/(z+2))^0.15 clipped at 2^0.15) -> centre-clipped
                       loudness-difference disturbance with 0.25*min masking;
5. asymmetry         — ((deg+50)/(ref+50))^1.2 per band, zeroed below 3,
                       clipped at 12;
6. aggregation       — width-weighted Lp over bands (p=2 symmetric, p=1
                       asymmetric), frame weighting ((P_ref+1e5)/1e7)^0.04,
                       clip 45, L6 over 20-frame "syllables" (hop 10),
                       L2 over syllables;
7. score             — PESQ = 4.5 - 0.1*d_sym - 0.0309*d_asym, the raw
                       P.862 score `pypesq` returns (no LQO mapping).

Fidelity note (documented deviation): the ITU reference parameter header
(pesqpar.h) carries five hand-tuned per-band tables. Those exact tables
are not redistributable data available in this environment; the Bark band
centres below were reconstructed from the P.862 reference implementation's
narrowband grid, and the derived quantities (band widths, FFT-bin
partition, power-density correction, absolute hearing threshold via
Terhardt's threshold-in-quiet) are regenerated programmatically. Scores
therefore track conformant PESQ closely but are not guaranteed bit-exact;
if a conformant `pesq`/`pypesq` package is ever importable it takes
precedence (see `eval/speech.py` pesq_score dispatch). Time
alignment treats the file as a single utterance (no recursive utterance
splitting / bad-interval realignment): the denoising eval scores pairs
that are sample-aligned by construction (m2 predict.py:455-466), where
per-utterance splitting is a no-op.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Constants (P.862 narrowband)
# ---------------------------------------------------------------------------

TARGET_AVG_POWER = 1.0e7
DATAPADDING_MS = 320
SEARCHBUFFER = 75          # in Downsample units
ZWICKER_POWER = 0.23
Sp_NB = 6.910853e-6        # power scaling, narrowband
Sl_NB = 1.866055e-1        # loudness scaling, narrowband
MIN_SCALE = 3.0e-4
MAX_SCALE = 5.0
SYLLABLE_FRAMES = 20       # frames per "syllable" interval
D_POW_F, D_POW_T = 2.0, 2.0   # symmetric: band Lp / time Lp
A_POW_F, A_POW_T = 1.0, 2.0   # asymmetric
D_POW_S = 6.0                 # within-syllable Lp (both)

# Band-pass curve for level alignment: flat 350-3250 Hz, -500 dB outside
# (P.862 align_filter characteristic).
_ALIGN_FILTER_DB = np.array([
    [0, -500], [50, -500], [100, -500], [125, -500], [160, -500],
    [200, -500], [250, -500], [300, -500], [350, 0], [400, 0],
    [500, 0], [600, 0], [630, 0], [800, 0], [1000, 0], [1300, 0],
    [1600, 0], [2000, 0], [2500, 0], [3000, 0], [3250, 0],
    [3500, -500], [4000, -500], [5000, -500], [6300, -500],
    [8000, -500]], dtype=np.float64)

# IRS-receive-like input filter characteristic (P.862 standard input
# filter; approximated as an FFT-domain piecewise-log-linear curve).
# Normalised to a 0 dB pass-band plateau: level alignment runs BEFORE
# this filter, so the plateau level directly scales every power density
# seen by the 1e7-calibrated perceptual constants.
_IRS_FILTER_DB = np.array([
    [0, -212], [50, -52], [100, -32], [125, -24], [160, -18], [200, -12],
    [250, -8], [300, -6], [350, -4], [400, -2], [500, -1], [600, 0],
    [700, 0], [800, 0], [1000, 0], [1300, 0], [1600, 0],
    [2000, 0], [2500, 0], [3000, 0], [3250, 0], [3500, -8],
    [4000, -212], [5000, -212], [6300, -212], [8000, -212]],
    dtype=np.float64)

# Narrowband Bark-band centre grid (42 bands, 8 kHz mode), reconstructed
# from the P.862 reference implementation's band partition. The 16 kHz
# narrowband mode extends the same grid with 7 further bands (see
# _band_tables).
_CENTRE_BARK_8K = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450, 1.624217,
    1.962597, 2.305636, 2.653383, 3.005889, 3.363201, 3.725371,
    4.092449, 4.464486, 4.841533, 5.223642, 5.610866, 6.003256,
    6.400869, 6.803755, 7.211971, 7.625571, 8.044611, 8.469146,
    8.899232, 9.334927, 9.776288, 10.223374, 10.676242, 11.134952,
    11.599563, 12.070135, 12.546731, 13.029408, 13.518232, 14.013264,
    14.514566, 15.022202, 15.536238, 16.056736, 16.583761, 17.117382,
], dtype=np.float64)

_CENTRE_HZ_8K = np.array([
    7.867213, 31.634144, 63.655895, 96.124611, 129.044968, 162.421738,
    196.259659, 230.563568, 265.338348, 300.588867, 336.320129,
    372.537140, 409.244934, 446.448578, 484.568604, 526.600586,
    570.303833, 619.423340, 672.121643, 728.525696, 785.675964,
    846.835693, 909.691650, 977.063293, 1049.861694, 1129.635986,
    1217.257568, 1312.109497, 1412.501465, 1517.999390, 1628.894165,
    1746.194336, 1871.568848, 2008.776123, 2158.979248, 2326.743164,
    2513.787109, 2722.488770, 2952.586670, 3205.835449, 3492.679932,
    3820.219238], dtype=np.float64)


def _terhardt_threshold_db(f_hz: np.ndarray) -> np.ndarray:
    """Threshold in quiet (dB SPL), Terhardt 1979 — used to regenerate the
    per-band absolute hearing threshold table."""
    f = np.maximum(np.asarray(f_hz, np.float64), 1.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


@dataclass(frozen=True)
class _BandTables:
    fs: int
    n_fft: int
    downsample: int
    centre_bark: np.ndarray
    centre_hz: np.ndarray
    width_bark: np.ndarray
    width_hz: np.ndarray
    nr_bins: np.ndarray        # FFT bins per band (sums to n_fft//2)
    pow_dens_corr: np.ndarray  # grouping-granularity compensation
    abs_thresh: np.ndarray     # absolute hearing threshold (power units)


@lru_cache(maxsize=None)
def _band_tables(fs: int) -> _BandTables:
    if fs == 8000:
        n_fft, downsample = 256, 32
        centre_bark = _CENTRE_BARK_8K.copy()
        centre_hz = _CENTRE_HZ_8K.copy()
    elif fs == 16000:
        n_fft, downsample = 512, 64
        # Extend the 42-band grid by 7 bands covering 4-8 kHz: continue
        # the smooth growth of the bark diffs and hz ratios.
        bark = list(_CENTRE_BARK_8K)
        hz = list(_CENTRE_HZ_8K)
        d_bark = bark[-1] - bark[-2]
        r_bark = d_bark / (bark[-2] - bark[-3])
        r_hz = hz[-1] / hz[-2]
        for _ in range(7):
            d_bark *= r_bark
            bark.append(bark[-1] + d_bark)
            r_hz += 0.004
            hz.append(min(hz[-1] * r_hz, 7.99e3))
        centre_bark = np.asarray(bark)
        centre_hz = np.asarray(hz)
    else:
        raise ValueError(f"PESQ narrowband supports fs 8000/16000, got {fs}")

    nb = len(centre_bark)
    df = fs / n_fft
    n_bins = n_fft // 2

    # Widths from centre spacing (half-distance to each neighbour).
    def widths(c: np.ndarray, lo: float, hi: float) -> np.ndarray:
        edges = np.empty(len(c) + 1)
        edges[1:-1] = 0.5 * (c[1:] + c[:-1])
        edges[0], edges[-1] = lo, hi
        return np.diff(edges)

    width_hz = widths(centre_hz, 0.0, fs / 2)
    width_bark = widths(centre_bark, 0.0,
                        centre_bark[-1] + 0.5 * (centre_bark[-1]
                                                 - centre_bark[-2]))

    # Partition FFT bins 0..n_bins-1 (bin k centred at k*df) to the band
    # with the nearest hz centre -> contiguous groups covering all bins.
    bin_hz = np.arange(n_bins) * df
    assign = np.abs(bin_hz[:, None] - centre_hz[None, :]).argmin(axis=1)
    nr_bins = np.bincount(assign, minlength=nb)
    # Every band must own >=1 bin; steal from the widest neighbour run.
    for b in np.nonzero(nr_bins == 0)[0]:
        donor = b - 1 if b > 0 and nr_bins[b - 1] > 1 else b + 1
        nr_bins[donor] -= 1
        nr_bins[b] += 1
    assert nr_bins.sum() == n_bins and (nr_bins > 0).all()

    # Correction for bin-grouping granularity: ratio of the band's nominal
    # hz width to the width actually covered by its integer bin count.
    pow_dens_corr = width_hz / (nr_bins * df)

    abs_thresh = 10.0 ** (_terhardt_threshold_db(centre_hz) / 10.0)
    return _BandTables(fs, n_fft, downsample, centre_bark, centre_hz,
                       width_bark, width_hz, nr_bins.astype(np.int64),
                       pow_dens_corr, abs_thresh)


# ---------------------------------------------------------------------------
# Stage 1-2: level alignment + input filter (FFT-domain piecewise filter)
# ---------------------------------------------------------------------------


def _apply_fft_filter(x: np.ndarray, fs: int, curve_db: np.ndarray
                      ) -> np.ndarray:
    n = len(x)
    n_pow2 = 1 << int(np.ceil(np.log2(max(n, 2))))
    spec = np.fft.rfft(x, n_pow2)
    freqs = np.fft.rfftfreq(n_pow2, 1.0 / fs)
    gain_db = np.interp(freqs, curve_db[:, 0], curve_db[:, 1])
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n_pow2)[:n]


def _fix_power_level(x: np.ndarray, fs: int, n_active: int) -> np.ndarray:
    """Scale so the 350-3250 Hz band power over the active length hits
    TARGET_AVG_POWER (P.862 fix_power_level)."""
    filtered = _apply_fft_filter(x, fs, _ALIGN_FILTER_DB)
    power = float(np.sum(filtered[:n_active] ** 2)) / max(n_active, 1)
    if power <= 0:
        return x
    return x * np.sqrt(TARGET_AVG_POWER / power)


# ---------------------------------------------------------------------------
# Stage 3: time alignment
# ---------------------------------------------------------------------------


def _crude_align(ref: np.ndarray, deg: np.ndarray, downsample: int) -> int:
    """Global delay estimate (samples, deg relative to ref) from the
    cross-correlation of per-4ms log-energy envelopes."""
    def envelope(x: np.ndarray) -> np.ndarray:
        n = len(x) // downsample
        e = np.abs(x[: n * downsample].reshape(n, downsample)).sum(axis=1)
        floor = max(float(e.max()) * 1e-5, 1e-10)
        return np.log(np.maximum(e, floor) / floor)

    er, ed = envelope(ref), envelope(deg)
    n = 1 << int(np.ceil(np.log2(len(er) + len(ed))))
    corr = np.fft.irfft(np.conj(np.fft.rfft(er, n)) * np.fft.rfft(ed, n), n)
    lag = int(np.argmax(corr))
    if lag > n // 2:
        lag -= n
    return lag * downsample


def _fine_align(ref: np.ndarray, deg: np.ndarray, crude: int,
                downsample: int) -> int:
    """Refine the crude delay by direct cross-correlation of rectified
    signals within +-1 envelope frame."""
    span = downsample
    best_lag, best = crude, -np.inf
    ar, ad = np.abs(ref), np.abs(deg)
    n = len(ar)
    for lag in range(crude - span, crude + span + 1):
        lo_r, hi_r = max(0, -lag), min(n, len(ad) - lag)
        if hi_r - lo_r < downsample:
            continue
        seg_r = ar[lo_r:hi_r]
        seg_d = ad[lo_r + lag:hi_r + lag]
        denom = np.sqrt(float(seg_r @ seg_r) * float(seg_d @ seg_d))
        score = float(seg_r @ seg_d) / denom if denom > 0 else 0.0
        if score > best:
            best, best_lag = score, lag
    return best_lag


# ---------------------------------------------------------------------------
# Stage 4-6: perceptual model
# ---------------------------------------------------------------------------


def _frames_power(x: np.ndarray, start: int, n_frames: int, n_fft: int
                  ) -> np.ndarray:
    """Hann-windowed power spectra, frames hop n_fft//2. (n_frames, n_fft//2)."""
    hop = n_fft // 2
    idx = start + hop * np.arange(n_frames)[:, None] + np.arange(n_fft)[None]
    idx = np.clip(idx, 0, len(x) - 1)
    valid = (idx >= 0) & (start + hop * np.arange(n_frames)[:, None]
                          + np.arange(n_fft)[None] < len(x))
    frames = np.where(valid, x[idx], 0.0)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    spec = np.fft.rfft(frames * window, axis=1)[:, : n_fft // 2]
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float64)


def _group_to_bark(hz_power: np.ndarray, t: _BandTables) -> np.ndarray:
    """Sum FFT-bin powers into Bark bands -> pitch power densities."""
    splits = np.cumsum(t.nr_bins)[:-1]
    groups = np.split(hz_power, splits, axis=1)
    banded = np.stack([g.sum(axis=1) for g in groups], axis=1)
    return banded * t.pow_dens_corr[None, :] * Sp_NB


def _total_audible(pds: np.ndarray, t: _BandTables, factor: float = 1.0
                   ) -> np.ndarray:
    """Per-frame sum of band powers above factor*threshold, bands 1.. ."""
    p = pds[:, 1:]
    thr = factor * t.abs_thresh[None, 1:]
    return np.where(p > thr, p, 0.0).sum(axis=1)


def _loudness(pds: np.ndarray, t: _BandTables) -> np.ndarray:
    """Zwicker loudness densities with P.862's low-band exponent tweak."""
    h = np.minimum(6.0 / (t.centre_bark + 2.0), 2.0)
    h = np.where(t.centre_bark < 4.0, h ** 0.15, 1.0)
    zw = ZWICKER_POWER * h
    thr = t.abs_thresh[None, :]
    loud = ((thr / 0.5) ** zw[None, :]
            * ((0.5 + 0.5 * pds / thr) ** zw[None, :] - 1.0)) * Sl_NB
    return np.where(pds > thr, loud, 0.0)


def _band_lp(d: np.ndarray, width: np.ndarray, p: float) -> np.ndarray:
    """Width-weighted Lp over bands 1.. (P.862 pseudo_Lp), per frame."""
    w = width[1:]
    total_w = float(w.sum())
    acc = ((np.abs(d[:, 1:]) * w[None, :]) ** p).sum(axis=1)
    return (acc / total_w) ** (1.0 / p) * total_w


def _lpq_time(d: np.ndarray, p_syl: float, p_time: float) -> float:
    """L_{p_syl} over 20-frame syllables (hop 10), L_{p_time} across."""
    n = len(d)
    if n == 0:
        return 0.0
    hop = SYLLABLE_FRAMES // 2
    starts = np.arange(0, n, hop)
    vals = []
    for s in starts:
        seg = d[s: s + SYLLABLE_FRAMES]
        vals.append((np.mean(seg ** p_syl)) ** (1.0 / p_syl))
    vals = np.asarray(vals)
    return float((np.mean(vals ** p_time)) ** (1.0 / p_time))


def _perceptual_model(ref: np.ndarray, deg: np.ndarray, fs: int,
                      delay: int, n_active: int) -> Tuple[float, float]:
    t = _band_tables(fs)
    n_fft, hop = t.n_fft, t.n_fft // 2
    n_frames = max((n_active - n_fft) // hop + 1, 1)

    hz_ref = _frames_power(ref, 0, n_frames, n_fft)
    hz_deg = _frames_power(deg, delay, n_frames, n_fft)
    pds_ref = _group_to_bark(hz_ref, t)
    pds_deg = _group_to_bark(hz_deg, t)

    # --- partial frequency (linear-filtering) compensation: scale REF's
    # band powers toward DEG's long-term spectrum, bounded [0.01, 100].
    audible_ref = _total_audible(pds_ref, t)
    active = audible_ref > 1.0e7
    if not active.any():
        active = np.ones(n_frames, dtype=bool)
    avg_ref = pds_ref[active].mean(axis=0)
    avg_deg = pds_deg[active].mean(axis=0)
    h = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    pds_ref_eq = pds_ref * h[None, :]

    # --- short-term gain compensation: scale DEG frame powers toward REF,
    # first-order smoothed over frames, bounded [MIN_SCALE, MAX_SCALE].
    audible_ref_eq = _total_audible(pds_ref_eq, t)
    audible_deg = _total_audible(pds_deg, t)
    raw = (audible_ref_eq + 5.0e3) / (audible_deg + 5.0e3)
    scale = np.empty(n_frames)
    prev = 1.0
    for i in range(n_frames):
        # AGC-slow tracking: mostly the previous scale, so short pauses
        # between speech keep the speech-frame gain (noise audible in
        # pauses is penalised, sustained level offsets are forgiven).
        s = raw[i] if i == 0 else 0.8 * prev + 0.2 * raw[i]
        prev = s
        scale[i] = np.clip(s, MIN_SCALE, MAX_SCALE)
    pds_deg_eq = pds_deg * scale[:, None]

    # --- loudness + masked disturbance
    loud_ref = _loudness(pds_ref_eq, t)
    loud_deg = _loudness(pds_deg_eq, t)
    diff = loud_deg - loud_ref
    mask = 0.25 * np.minimum(loud_ref, loud_deg)
    d = np.where(diff > mask, diff - mask,
                 np.where(diff < -mask, diff + mask, 0.0))

    # --- asymmetry factor from (compensated) pitch power densities
    ratio = ((pds_deg_eq + 50.0) / (pds_ref_eq + 50.0)) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))

    d_frame = _band_lp(d, t.width_bark, D_POW_F)
    da_frame = _band_lp(d * asym, t.width_bark, A_POW_F)

    # --- frame weighting by reference loudness, clip at 45
    weight = ((audible_ref_eq + 1.0e5) / 1.0e7) ** 0.04
    d_frame = np.minimum(d_frame / weight, 45.0)
    da_frame = np.minimum(da_frame / weight, 45.0)

    d_ind = _lpq_time(d_frame, D_POW_S, D_POW_T)
    da_ind = _lpq_time(da_frame, D_POW_S, A_POW_T)
    return d_ind, da_ind


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def pesq_nb(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    """Raw P.862 narrowband score (range ~[-0.5, 4.5]) for float or PCM
    waveforms at 8 or 16 kHz. Mirrors `pypesq.pesq(ref, deg, fs)`."""
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    if ref.ndim != 1 or deg.ndim != 1:
        raise ValueError("pesq_nb expects mono 1-D waveforms")
    n = min(len(ref), len(deg))
    if n < fs // 4:
        raise ValueError("signals too short for PESQ (<0.25 s)")
    ref, deg = ref[:n], deg[:n]
    # Accept [-1,1] float audio: P.862 operates at 16-bit PCM scale, and
    # while level alignment removes most absolute-scale sensitivity, the
    # envelope floor in crude alignment does not.
    peak = max(float(np.abs(ref).max()), float(np.abs(deg).max()), 1e-12)
    if peak <= 1.5:
        ref = ref * 32768.0
        deg = deg * 32768.0

    t = _band_tables(fs)
    pad = SEARCHBUFFER * t.downsample
    datapad = (DATAPADDING_MS * fs) // 1000
    full_ref = np.concatenate([np.zeros(pad), ref, np.zeros(pad + datapad)])
    full_deg = np.concatenate([np.zeros(pad), deg, np.zeros(pad + datapad)])

    n_active = n + 2 * pad
    full_ref = _fix_power_level(full_ref, fs, n_active)
    full_deg = _fix_power_level(full_deg, fs, n_active)
    full_ref = _apply_fft_filter(full_ref, fs, _IRS_FILTER_DB)
    full_deg = _apply_fft_filter(full_deg, fs, _IRS_FILTER_DB)

    crude = _crude_align(full_ref, full_deg, t.downsample)
    max_shift = pad // 2
    crude = int(np.clip(crude, -max_shift, max_shift))
    delay = _fine_align(full_ref, full_deg, crude, t.downsample)

    d_ind, da_ind = _perceptual_model(full_ref, full_deg, fs, delay,
                                      n + datapad + pad)
    score = 4.5 - 0.1 * d_ind - 0.0309 * da_ind
    return float(np.clip(score, -0.5, 4.5))
