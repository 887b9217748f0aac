"""Bitstream -> silence sample mask -> gate (port of `sos_tpu/dsp/mixing.py`).

Reproduces the reference's mask quirks (m1 tools.py:770-792) exactly as
`sos_tpu` does:

* each video-frame bit writes samples `[int(f*r), int((f+1)*r - 1))`,
  leaving a 1-sample gap at every frame boundary;
* runs shorter than `despeckle_min_run` samples flip, which with the
  production geometry means: an interior gap flips iff both neighbouring
  frames are silent, and the final gap + tail flips iff the last frame is.

Kernel K2 (`mask_gate`, `csrc/mask_gate.cu`) fuses the mask with the gate
multiply `mixed * mask`. Its geometry table (two int16 halves a sample)
is built here on the host in float64 from the same matrices `sos_tpu`
uses.

The host numpy helpers of the eval chain (`*_np`, `truncate_padding`,
`bandpass_filter`, `filter_bitstream`) are copied from `sos_tpu` as they
are. `bitstream_to_sample_mask_np` expands bits with an O(num_samples)
difference array, so the full-utterance predictors have no length
limit; the dense device path (K2 and its plain version) keeps its 2^24
limit.

Not ported yet: the >2^24-element gather-map path of the device mask
(`_frame_sample_maps`) and the jnp `mix_at_snr` of training.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sos_tpu_torch.kernels import aligned16, launch, on_device

# Above this many (num_frames * num_samples) elements sos_tpu swaps the
# dense matrices for O(num_samples) gather maps; that path is not ported.
_DENSE_MASK_MAX_ELEMS = 1 << 24
# K2 keeps 8 rows of bits in a block's 227 KB of shared memory
_MAX_GATE_FRAMES = 232448 // (8 * 4)


def _check_dense(num_frames: int, num_samples: int) -> None:
    """Both the plain path and K2's tables build dense (frames, samples)
    matrices on the host; past sos_tpu's dense limit they raise."""
    if num_frames * num_samples > _DENSE_MASK_MAX_ELEMS:
        raise NotImplementedError(
            "bitstream_to_sample_mask: the >2^24-element gather-map path "
            "is not ported yet (ROADMAP.md queue 1 item 3, queue 2 A1); "
            "the eval chain's bitstream_to_sample_mask_np has no limit")


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


def _column_owner(mat: np.ndarray) -> np.ndarray:
    """Per column, the row holding its single 1, or -1 for an empty column."""
    if np.any(mat.sum(axis=0) > 1):
        raise ValueError("mask geometry: a sample belongs to two frames")
    return np.where(mat.any(axis=0), mat.argmax(axis=0), -1).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _gate_tables(num_frames: int, num_samples: int, ratio: float,
                 min_run: int, device: torch.device) -> torch.Tensor:
    """K2's geometry on `device`: one int32 word a sample, the frame whose
    body covers it in the low int16 and the gap pair that gates it in the
    high int16 (-1 = none; frames < 32,768)."""
    _check_dense(num_frames, num_samples)
    if num_frames > _MAX_GATE_FRAMES:
        raise ValueError(f"mask_gate: {num_frames} frames exceed the "
                         f"kernel's {_MAX_GATE_FRAMES} (int16 tables, one "
                         "block's shared memory)")
    gap = _despeckle_gap_matrix(num_frames, num_samples, ratio, min_run)
    if gap is None:
        raise NotImplementedError(
            "mask_gate: this clip geometry needs the generic despeckle, "
            "which has no kernel yet (ROADMAP.md queue 2 A1); run on "
            "the CPU")
    body = _column_owner(frame_sample_matrix(num_frames, num_samples, ratio))
    pair = _column_owner(gap)
    words = (pair.astype(np.int64) << 16) | (body.astype(np.int64) & 0xFFFF)
    return torch.from_numpy(words.astype(np.int32)).to(device)


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
    _check_dense(num_frames, num_samples)
    inv = 1.0 - bits.float()
    a = torch.from_numpy(frame_sample_matrix(num_frames, num_samples, ratio))
    mask = torch.matmul(inv, a.to(inv.device))
    gap = _despeckle_gap_matrix(num_frames, num_samples, ratio,
                                despeckle_min_run)
    if gap is None:
        return despeckle_mask(mask, despeckle_min_run)
    pair = torch.cat([inv[..., :-1] * inv[..., 1:], inv[..., -1:]], dim=-1)
    return mask + torch.matmul(pair, torch.from_numpy(gap).to(inv.device))


def mask_gate_plain(mixed: torch.Tensor, bits: torch.Tensor, ratio: float,
                    despeckle_min_run: int = 5) -> torch.Tensor:
    """Plain version of K2: `mixed * bitstream_to_sample_mask(bits)`."""
    mask = bitstream_to_sample_mask(bits, ratio, mixed.shape[-1],
                                    despeckle_min_run)
    return mixed.float() * mask


def mask_gate(mixed: torch.Tensor, bits: torch.Tensor, ratio: float,
              despeckle_min_run: int = 5) -> torch.Tensor:
    """Gate `(B, L)` samples by the silence mask of `(B, num_frames)` bits.

    Kernel K2 on CUDA tensors, `mask_gate_plain` on CPU tensors. On the
    card a geometry without a gap matrix raises (see `_gate_tables`).
    """
    if mixed.device.type == "cpu" and bits.device.type == "cpu":
        return mask_gate_plain(mixed, bits, ratio, despeckle_min_run)
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
    # `aligned16`: 16-byte rows for the kernel's four-sample route
    mixed = aligned16(mixed.float())
    bits = bits.float().contiguous()
    out = torch.empty_like(mixed)
    with on_device(mixed.device) as stream:
        launch("mask_gate", "sos_mask_gate", mixed.data_ptr(),
               bits.data_ptr(), geom.data_ptr(), out.data_ptr(), batch,
               length, num_frames, stream)
    return out


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
