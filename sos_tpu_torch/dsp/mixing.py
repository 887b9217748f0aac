"""Bitstream -> silence sample mask -> gate (port of `sos_tpu/dsp/mixing.py`).

Reproduces the reference's mask quirks (m1 tools.py:770-792) exactly as
`sos_tpu` does:

* each video-frame bit writes samples `[int(f*r), int((f+1)*r - 1))`,
  leaving a 1-sample gap at every frame boundary;
* runs shorter than `despeckle_min_run` samples flip, which with the
  production geometry means: an interior gap flips iff both neighbouring
  frames are silent, and the final gap + tail flips iff the last frame is.
  Geometries whose frame bodies are shorter than `despeckle_min_run`, or
  clipped, take the generic run-length despeckle.

`bitstream_to_sample_mask` takes `sos_tpu`'s two routes: the dense
(frames, samples) matrices up to 2^24 elements, O(num_samples) gather
maps (`_frame_sample_maps`) past them, so a window of any length runs.

Kernel K2 (`mask_gate`, `csrc/mask_gate.cu`) fuses the mask with the gate
multiply `mixed * mask`, or, with `complement=True`, `x * (1 - mask)`
(the training recipe's silencing of the clean signal). Its geometry
table (two int16 halves a sample, and the frames each 256-sample chunk
reads) is built here on the host from the gather maps, in O(L). Its
despeckle instance runs the generic despeckle on the card.

`mix_at_snr` is the batched on-device SNR mix of the training step
(`sos_tpu`'s jnp version, per-item SNR, joint peak normalisation).

The host numpy helpers of the eval chain (`*_np`, `truncate_padding`,
`bandpass_filter`, `filter_bitstream`) are copied from `sos_tpu` as they
are.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sos_tpu_torch.kernels import aligned16, launch, on_device

# Above this many (num_frames * num_samples) elements the dense
# assignment/gap matrices are replaced by O(num_samples) gather maps
# (sos_tpu's limit: a 60 s window's matrices would take ~6 GB).
_DENSE_MASK_MAX_ELEMS = 1 << 24
# K2's table words hold frame indices in int16 halves
_MAX_GATE_FRAMES = 32767
# K2: samples a (first, end) pair of its table covers; samples of one
# despeckle block; rows a block; shared memory a block may take
_GATE_CHUNK = 256
_GATE_SPAN = 1024
_GATE_ROWS = 8
_GATE_SMEM = 232448


@functools.lru_cache(maxsize=32)
def frame_sample_matrix(num_frames: int, num_samples: int,
                        ratio: float) -> np.ndarray:
    """(num_frames, num_samples) 0/1 assignment matrix A.

    A[f, i] = 1 iff sample i is written by frame f, i.e.
    int(f*ratio) <= i < int((f+1)*ratio) - 1 (the 1-sample boundary gap).
    """
    a = np.zeros((num_frames, num_samples), dtype=np.float32)
    for f in range(num_frames):
        lo = int(f * ratio)
        hi = int((f + 1) * ratio - 1)
        a[f, lo:min(hi, num_samples)] = 1.0
    return a


@functools.lru_cache(maxsize=32)
def _despeckle_gap_matrix(num_frames: int, num_samples: int, ratio: float,
                          min_run: int) -> Optional[np.ndarray]:
    """(num_frames, num_samples) matrix G turning despeckle into a matmul.

    The despeckled mask is `(1-b) @ A + [(1-b[:-1])*(1-b[1:]), 1-b[-1:]] @ G`.
    Returns None when the geometry breaks the "short runs are only gaps"
    invariant (clipped frame bodies, bodies shorter than `min_run`); the
    caller then needs the generic `despeckle_mask`.
    """
    g = np.zeros((num_frames, num_samples), dtype=np.float32)
    if min_run <= 1:
        return g  # nothing can flip: despeckle is the identity
    last_hi = int(num_frames * ratio - 1)
    if last_hi > num_samples:
        return None  # clipped frame bodies: generic path
    for f in range(num_frames):
        lo = int(f * ratio)
        hi = int((f + 1) * ratio - 1)
        if hi - lo < min_run:
            return None  # a frame body itself could be a short run
        if f < num_frames - 1:
            g[f, hi] = 1.0  # interior gap: flips iff frames f, f+1 silent
    tail_len = num_samples - last_hi
    if 0 < tail_len < min_run:
        g[num_frames - 1, last_hi:] = 1.0  # final gap+tail short run
    return g


@functools.lru_cache(maxsize=8)
def _frame_sample_maps(num_frames: int, num_samples: int, ratio: float,
                       min_run: int):
    """O(num_samples) equivalent of the dense matrices (copied from
    sos_tpu as it is): per-sample covering-frame index + in-body
    indicator, and the despeckle gap map (same short-run geometry as
    `_despeckle_gap_matrix`; `gap_ok=False` means the caller must use the
    generic despeckle)."""
    f = np.arange(num_frames, dtype=np.float64)
    lo = (f * ratio).astype(np.int64)
    hi = ((f + 1.0) * ratio - 1.0).astype(np.int64)
    hi_c = np.minimum(hi, num_samples)
    idx = np.arange(num_samples, dtype=np.int64)
    fmap = np.clip(np.searchsorted(lo, idx, side="right") - 1,
                   0, num_frames - 1)
    body = ((idx >= lo[fmap]) & (idx < hi_c[fmap])).astype(np.float32)
    # gap map: mirrors _despeckle_gap_matrix's validity conditions
    gmap = np.zeros(num_samples, dtype=np.int32)
    gmask = np.zeros(num_samples, dtype=np.float32)
    gap_ok = True
    if min_run > 1:
        last_hi = int(num_frames * ratio - 1)
        if last_hi > num_samples or np.any(hi - lo < min_run):
            gap_ok = False  # clipped/short frame bodies: generic path
        else:
            # all interior gaps lie strictly below last_hi <= num_samples
            # (monotone hi, ratio > min_run >= 2), so no filtering —
            # gap at hi[f] is gated by pair element f
            interior = hi[:-1]
            gmask[interior] = 1.0
            gmap[interior] = np.arange(num_frames - 1, dtype=np.int32)
            tail_len = num_samples - last_hi
            if 0 < tail_len < min_run:
                gmask[last_hi:] = 1.0
                gmap[last_hi:] = num_frames - 1
    return fmap.astype(np.int32), body, gmap, gmask, gap_ok


class GateTables(NamedTuple):
    """K2's geometry on one device."""
    words: torch.Tensor   # (L,) int32: body frame low int16, gap pair high
    spans: torch.Tensor   # (chunks, 2) int32: frames each chunk reads
    span_frames: int      # the most frames one 1,024-sample span reads
    despeckle: bool       # the generic despeckle instance
    rows_per_block: int   # the despeckle instance's rows a block


def gate_words(num_frames: int, num_samples: int, ratio: float,
               min_run: int) -> Tuple[np.ndarray, bool]:
    """K2's table words from the gather maps, in O(L): one int32 a
    sample, the frame whose body covers it in the low int16 and the gap
    pair that gates it in the high int16 (-1 = none); and whether the
    geometry needs the generic despeckle."""
    fmap, body, gmap, gmask, gap_ok = _frame_sample_maps(
        num_frames, num_samples, ratio, min_run)
    body_idx = np.where(body > 0, fmap, -1).astype(np.int64)
    pair_idx = np.where(gmask > 0, gmap, -1).astype(np.int64)
    words = (pair_idx << 16) | (body_idx & 0xFFFF)
    return words.astype(np.int32), min_run > 1 and not gap_ok


def gate_spans(words: np.ndarray, num_frames: int) -> np.ndarray:
    """(first, end) of the frames each 256-sample chunk's words read:
    its bodies' frames and g, g + 1 of its gaps (first 32,767 and end 0
    where it reads none)."""
    body, pair = (words << 16) >> 16, words >> 16
    none = _MAX_GATE_FRAMES
    lo = np.minimum(np.where(body >= 0, body, none),
                    np.where(pair >= 0, pair, none))
    hi = np.maximum(np.where(body >= 0, body + 1, 0),
                    np.where(pair >= 0, np.minimum(pair + 2, num_frames), 0))
    pad = -len(words) % _GATE_CHUNK
    lo = np.pad(lo, (0, pad), constant_values=none).reshape(-1, _GATE_CHUNK)
    hi = np.pad(hi, (0, pad)).reshape(-1, _GATE_CHUNK)
    return np.stack([lo.min(axis=1), hi.max(axis=1)], axis=1).astype(np.int32)


def _span_frames(spans: np.ndarray) -> int:
    """The most frames the chunks of one 1,024-sample span read."""
    per = _GATE_SPAN // _GATE_CHUNK
    pad = -len(spans) % per
    first = np.pad(spans[:, 0], (0, pad), constant_values=_MAX_GATE_FRAMES)
    end = np.pad(spans[:, 1], (0, pad))
    width = end.reshape(-1, per).max(axis=1) - first.reshape(-1, per).min(axis=1)
    return max(1, int(width.max(initial=0)))


def _despeckle_rows(min_run: int) -> int:
    """Rows a block of K2's despeckle instance takes: each row's window of
    1,024 + 2 (min_run - 1) floats, beside one window of ints, the span's
    1,024 floats and the block scan's 2 KB."""
    window = _GATE_SPAN + 2 * (min_run - 1)
    free = (_GATE_SMEM - 2048) // 4 - window - _GATE_SPAN
    return min(_GATE_ROWS, max(0, free // window))


@functools.lru_cache(maxsize=16)
def _gate_tables(num_frames: int, num_samples: int, ratio: float,
                 min_run: int, device: torch.device) -> GateTables:
    """K2's geometry on `device` (see `GateTables`). Raises past the
    int16 halves' 32,767 frames, and where one block's shared memory
    cannot hold what it stages."""
    if num_frames > _MAX_GATE_FRAMES:
        raise ValueError(f"mask_gate: {num_frames} frames exceed the "
                         f"kernel's {_MAX_GATE_FRAMES} (int16 frame "
                         "indices in its table)")
    words, despeckle = gate_words(num_frames, num_samples, ratio, min_run)
    spans = gate_spans(words, num_frames)
    span_frames = _span_frames(spans)
    if _GATE_ROWS * span_frames * 4 > _GATE_SMEM:
        raise ValueError(f"mask_gate: {span_frames} frames in "
                         f"{_GATE_SPAN} samples exceed a block's shared "
                         "memory (ratio below 1/6 sample a frame)")
    rows = 0
    if despeckle:
        rows = _despeckle_rows(min_run)
        if rows < 1:
            window = ((_GATE_SMEM - 2048) // 4 - _GATE_SPAN) // 2
            most = (window - _GATE_SPAN) // 2 + 1
            raise ValueError(f"mask_gate: despeckle_min_run {min_run} "
                             "exceeds a block's shared memory (at most "
                             f"{most})")
    return GateTables(torch.from_numpy(words).to(device),
                      torch.from_numpy(spans).to(device), span_frames,
                      despeckle, rows)


def despeckle_mask(mask: torch.Tensor, min_run: int = 5) -> torch.Tensor:
    """Run-length despeckle of `(..., L)` 0/1 masks: runs shorter than
    `min_run` flip, run membership taken on the original mask."""
    length = mask.shape[-1]
    flat = mask.reshape(-1, length)
    change = torch.ones_like(flat, dtype=torch.int64)
    change[:, 1:] = (flat[:, 1:] != flat[:, :-1]).to(torch.int64)
    run_id = torch.cumsum(change, dim=-1) - 1
    run_len = torch.zeros_like(run_id).scatter_add_(
        1, run_id, torch.ones_like(run_id))
    flip = torch.gather(run_len, 1, run_id) < min_run
    return torch.where(flip, 1.0 - flat, flat).reshape(mask.shape)


def bitstream_to_sample_mask(bits: torch.Tensor, ratio: float, num_samples: int,
                             despeckle_min_run: int = 5) -> torch.Tensor:
    """Batched bits `(..., num_frames)` -> despeckled mask `(..., num_samples)`."""
    num_frames = bits.shape[-1]
    inv = 1.0 - bits.float()
    dev = inv.device
    if num_frames * num_samples > _DENSE_MASK_MAX_ELEMS:
        fmap, body, gmap, gmask, gap_ok = _frame_sample_maps(
            num_frames, num_samples, ratio, despeckle_min_run)
        mask = (torch.index_select(inv, -1, torch.from_numpy(fmap).to(dev))
                * torch.from_numpy(body).to(dev))
        if despeckle_min_run <= 1:
            return mask
        if not gap_ok:
            return despeckle_mask(mask, despeckle_min_run)
        pair = torch.cat([inv[..., :-1] * inv[..., 1:], inv[..., -1:]], dim=-1)
        return mask + (torch.index_select(pair, -1,
                                          torch.from_numpy(gmap).to(dev))
                       * torch.from_numpy(gmask).to(dev))
    a = torch.from_numpy(frame_sample_matrix(num_frames, num_samples, ratio))
    mask = torch.matmul(inv, a.to(dev))
    gap = _despeckle_gap_matrix(num_frames, num_samples, ratio,
                                despeckle_min_run)
    if gap is None:
        return despeckle_mask(mask, despeckle_min_run)
    pair = torch.cat([inv[..., :-1] * inv[..., 1:], inv[..., -1:]], dim=-1)
    return mask + torch.matmul(pair, torch.from_numpy(gap).to(dev))


def mask_gate_plain(mixed: torch.Tensor, bits: torch.Tensor, ratio: float,
                    despeckle_min_run: int = 5,
                    complement: bool = False) -> torch.Tensor:
    """Plain version of K2: `mixed * bitstream_to_sample_mask(bits)`, or
    `mixed * (1 - mask)` with `complement`."""
    mask = bitstream_to_sample_mask(bits, ratio, mixed.shape[-1],
                                    despeckle_min_run)
    return mixed.float() * ((1.0 - mask) if complement else mask)


def mask_gate(mixed: torch.Tensor, bits: torch.Tensor, ratio: float,
              despeckle_min_run: int = 5,
              complement: bool = False) -> torch.Tensor:
    """Gate `(B, L)` samples by the silence mask of `(B, num_frames)` bits:
    `mixed * mask`, or `mixed * (1 - mask)` with `complement`.

    Kernel K2 on CUDA tensors, `mask_gate_plain` on CPU tensors. Any
    window length up to 32,767 frames runs on the card; a geometry that
    needs the generic despeckle runs K2's despeckle instance. Launches
    count under "mask_gate_despeckle" (the despeckle instance),
    "mask_gate_long" (a window past the dense matrices' 2^24 elements),
    "mask_gate_complement" or "mask_gate".
    """
    if mixed.device.type == "cpu" and bits.device.type == "cpu":
        return mask_gate_plain(mixed, bits, ratio, despeckle_min_run,
                               complement)
    if mixed.device.type != "cuda" or bits.device != mixed.device:
        raise ValueError(f"mask_gate: tensors on {mixed.device} and "
                         f"{bits.device}; the kernel needs one CUDA device")
    if mixed.dim() != 2 or bits.dim() != 2 or bits.shape[0] != mixed.shape[0]:
        raise ValueError(f"mask_gate: expected (B, L) samples and (B, F) "
                         f"bits, got {tuple(mixed.shape)} and "
                         f"{tuple(bits.shape)}")
    batch, length = mixed.shape
    num_frames = bits.shape[1]
    geom = _gate_tables(num_frames, length, ratio, despeckle_min_run,
                        mixed.device)
    if geom.despeckle:
        name = "mask_gate_despeckle"
    elif num_frames * length > _DENSE_MASK_MAX_ELEMS:
        name = "mask_gate_long"
    else:
        name = "mask_gate_complement" if complement else "mask_gate"
    # `aligned16`: 16-byte rows for the kernel's four-sample route
    mixed = aligned16(mixed.float())
    bits = bits.float().contiguous()
    out = torch.empty_like(mixed)
    with on_device(mixed.device) as stream:
        if geom.despeckle:
            launch(name, "sos_mask_despeckle", mixed.data_ptr(),
                   bits.data_ptr(), geom.words.data_ptr(), out.data_ptr(),
                   batch, length, num_frames, despeckle_min_run,
                   geom.rows_per_block, int(complement), stream)
        else:
            launch(name, "sos_mask_gate", mixed.data_ptr(), bits.data_ptr(),
                   geom.words.data_ptr(), geom.spans.data_ptr(),
                   out.data_ptr(), batch, length, num_frames,
                   geom.span_frames, int(complement), stream)
    return out


# ---------------------------------------------------------------------------
# Power / SNR mixing on the device (the training step's)
# ---------------------------------------------------------------------------


def signal_power(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """sum(|x|^2) (reference `power_of_signal`, m1 tools.py:800-801)."""
    return torch.sum(torch.abs(x * x), dim=dim)


def mix_at_snr(signal: torch.Tensor, noise: torch.Tensor,
               snr_db: torch.Tensor, norm: Optional[float] = 0.5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scale `noise` to `snr_db` below `signal` and mix; peak-normalise
    jointly (`sos_tpu/dsp/mixing.py:44-77`, the reference's `add_signals`,
    m1 tools.py:804-843) for batched `(..., L)` inputs and per-item
    `snr_db` `(...)`. A silent signal (power 0) takes the noise unscaled.
    Returns (mixed, clean, noise), all scaled by the same factor."""
    snr_db = torch.as_tensor(snr_db, dtype=signal.dtype, device=signal.device)
    p_sig = signal_power(signal)
    p_noise = signal_power(noise)
    pn = p_sig / torch.pow(torch.tensor(10.0, dtype=signal.dtype,
                                        device=signal.device), snr_db / 10.0)
    ratio = torch.sqrt(p_noise) / torch.sqrt(torch.clamp(pn, min=1e-30))
    safe_ratio = torch.where(ratio == 0, torch.ones_like(ratio), ratio)
    scaled_noise = noise / safe_ratio[..., None]
    scaled_noise = torch.where((p_sig == 0)[..., None], noise, scaled_noise)
    mixed = signal + scaled_noise
    if norm:
        scale = torch.amax(torch.abs(mixed), dim=-1) / norm
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)[..., None]
        return mixed / scale, signal / scale, scaled_noise / scale
    return mixed, signal, scaled_noise


# ---------------------------------------------------------------------------
# Host numpy helpers of the eval chain (copied from sos_tpu as they are)
# ---------------------------------------------------------------------------


def signal_power_np(x: np.ndarray) -> np.ndarray:
    return np.sum(np.abs(x ** 2))


def mix_at_snr_np(
    signal: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    norm: Optional[float] = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side reference-exact `add_signals` (m1 tools.py:804-843)."""
    p_sig = signal_power_np(signal)
    mixed = np.copy(signal)
    if p_sig == 0:
        new_noise = noise
    else:
        pn = p_sig / np.power(10.0, snr_db / 10.0)
        ratio = np.sqrt(signal_power_np(noise)) / np.sqrt(pn)
        new_noise = noise if ratio == 0 else noise / ratio
    mixed = mixed + new_noise
    if norm:
        scale = np.max(np.abs(mixed)) / norm
        if scale != 0:
            return mixed / scale, signal / scale, new_noise / scale
    return mixed, signal, new_noise


def crop_noise_np(
    noise: np.ndarray,
    target_len: int,
    start: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Crop (and zero-pad) a noise track to `target_len` samples.

    Reference `add_noise_to_audio` crop logic (m1 tools.py:846-866).
    """
    if start is None:
        slack = len(noise) - target_len
        if slack > 0:
            rng = rng or np.random.default_rng()
            start = int(rng.integers(0, slack + 1))
        elif slack == 0:
            start = 0
        else:
            raise ValueError(
                f"noise shorter than target: {len(noise)} < {target_len}")
    cropped = noise[start:start + target_len]
    if len(cropped) < target_len:
        cropped = np.concatenate(
            [cropped, np.zeros(target_len - len(cropped), dtype=cropped.dtype)])
    return cropped


def bitstream_to_sample_mask_np(
    bits: np.ndarray, ratio: float, num_samples: int, despeckle_min_run: int = 5
) -> np.ndarray:
    """Silence sample mask (1=silent) from per-frame bits (0=silent, 1=voiced).

    Host-exact `convert_bitstreammask_to_audiomask` (m1 tools.py:770-792):
    frame writes with the boundary gap, then runs shorter than
    `despeckle_min_run` are flipped.
    """
    bits = np.asarray(bits, dtype=np.float32)
    # O(num_samples) difference-array expansion — exactly `(1-bits) @ A`
    # for the frame_sample_matrix geometry, WITHOUT materializing the
    # dense (num_frames, num_samples) matrix: full-utterance eval calls
    # this with whole-file lengths (a 60 s file at 14 kHz/30 fps would
    # be an 1800 x 840000 ~ 6 GB matrix, and the lru_cache would pin 32
    # of them). Frame bodies are disjoint, so a +/- at each body's
    # [lo, hi) edges followed by a cumsum reproduces the matmul exactly.
    num_frames = len(bits)
    f = np.arange(num_frames, dtype=np.float64)
    lo = (f * ratio).astype(np.int64)
    hi = ((f + 1.0) * ratio - 1.0).astype(np.int64)  # 1-sample boundary gap
    hi = np.clip(np.minimum(hi, num_samples), 0, None)
    lo = np.minimum(lo, num_samples)
    hi = np.maximum(hi, lo)
    inv = 1.0 - bits
    diff = np.zeros(num_samples + 1, dtype=np.float32)
    np.add.at(diff, lo, inv)
    np.add.at(diff, hi, -inv)
    mask = np.cumsum(diff[:-1], dtype=np.float32)
    return despeckle_mask_np(mask, despeckle_min_run)


def despeckle_mask_np(mask: np.ndarray, min_run: int = 5) -> np.ndarray:
    """Flip 0/1 runs shorter than `min_run` (based on the original runs)."""
    mask = np.asarray(mask, dtype=np.float32).copy()
    n = len(mask)
    if n == 0:
        return mask
    change = np.ones(n, dtype=bool)
    change[1:] = mask[1:] != mask[:-1]
    run_id = np.cumsum(change) - 1
    run_len = np.bincount(run_id)
    flip = run_len[run_id] < min_run
    mask[flip] = 1.0 - mask[flip]
    return mask



# Bitstream string helpers (host)


def truncate_padding(bitstream: str) -> Tuple[int, int]:
    """Indices (start, end) trimming leading/trailing '2' padding chars.

    Reference `truncate` (m1 tools.py:270-274) returns (idx, -idx2); here
    `end` is a normal positive end index. Raises if the stream has no '2'
    padding on either side (callers fall back to the full span, matching
    the reference's try/except at tools.py:305-309).
    """
    n = len(bitstream)
    start = 0
    while start < n and bitstream[start] == "2":
        start += 1
    end = n
    while end > start and bitstream[end - 1] == "2":
        end -= 1
    if start == 0 and end == n and ("2" not in bitstream):
        return 0, n
    return start, end


def bandpass_filter(signal: np.ndarray, lowcut: float, highcut: float,
                    sr: int, order: int = 5) -> np.ndarray:
    """Butterworth band-pass (reference's experimental helper,
    m2 tools.py:365-380; kept for the commented 300-3400 Hz speech-band
    post-filter in m2 predict.py)."""
    from scipy.signal import butter, lfilter

    nyq = 0.5 * sr
    b, a = butter(order, [lowcut / nyq, highcut / nyq], btype="band")
    return lfilter(b, a, signal).astype(np.float32)


def filter_bitstream(bits: str, min_silent_interval: int) -> str:
    """Overwrite '0'-runs shorter than `min_silent_interval` with '1's.

    Reference `filter_bitstream` (m1 tools.py:277-294).
    """
    out = list(bits)
    i = 0
    n = len(bits)
    while i < n:
        j = i
        while j < n and bits[j] == bits[i]:
            j += 1
        if bits[i] == "0" and (j - i) < min_silent_interval:
            for k in range(i, j):
                out[k] = "1"
        i = j
    return "".join(out)
