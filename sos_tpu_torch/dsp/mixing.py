"""Bitstream -> silence sample mask -> gate (device half of `sos_tpu/dsp/mixing.py`).

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

Not ported yet: the >2^24-element gather-map path (`_frame_sample_maps`)
and `mix_at_snr`; the slice's 60 x 28000 clips never reach them.
"""

from __future__ import annotations

import functools
from typing import Optional

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
            "is not ported yet (ROADMAP.md queue 1 item 2)")


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
            "which has no kernel yet (ROADMAP.md queue 2 item 2); run on "
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
