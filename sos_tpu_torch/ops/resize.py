"""torch.nn.functional.interpolate-compatible nearest resizing
(port of `sos_tpu/ops/resize.py`).

The source index is `floor(dst * in/out)`, computed once in float64 on
the host and applied with `index_select`; `dynamic_nearest_time` takes
per-row valid widths on the device and computes its indices there in
integer arithmetic. `F.interpolate` is not used:
its float scale can pick other indices than `sos_tpu`. The index tensor
is kept on its device: a fresh host copy on every call would make the
launching thread wait for the stream to drain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _nearest_indices(in_len: int, out_len: int) -> np.ndarray:
    # torch nearest (recompute_scale_factor default): src = floor(dst * in/out)
    idx = np.floor(np.arange(out_len) * (in_len / out_len)).astype(np.int32)
    return np.minimum(idx, in_len - 1)


@functools.lru_cache(maxsize=None)
def nearest_index_tensor(in_len: int, out_len: int,
                         device: torch.device) -> torch.Tensor:
    """`_nearest_indices` as an int64 tensor on `device`, built once."""
    idx = _nearest_indices(in_len, out_len).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def nearest_resize_1d(x: torch.Tensor, out_len: int, dim: int) -> torch.Tensor:
    """Nearest-neighbour resize along `dim` with torch index semantics."""
    in_len = x.shape[dim]
    if in_len == out_len:
        return x
    return torch.index_select(x, dim,
                              nearest_index_tensor(in_len, out_len, x.device))


def nearest_resize_2d(x: torch.Tensor, out_hw, h_dim: int,
                      w_dim: int) -> torch.Tensor:
    """Nearest 2-D resize used by InpaintNet's skip-shape fixups."""
    x = nearest_resize_1d(x, out_hw[0], h_dim)
    return nearest_resize_1d(x, out_hw[1], w_dim)


def dynamic_nearest_time(x: torch.Tensor, v_src: torch.Tensor,
                         v_dst: torch.Tensor, out_t: int) -> torch.Tensor:
    """Nearest time-resize of each row's valid region (NCHW, time dim 3).

    Output column j of row b reads input column
    `floor(j * v_src[b] / max(v_dst[b], 1))` (exact integer floor,
    clipped to the input), for j < out_t; columns at or past v_dst[b]
    are zeroed. `v_src`, `v_dst`: `(B,)` integer tensors on x's device.
    """
    b, c, f, t_in = x.shape
    j = torch.arange(out_t, device=x.device)
    idx = (j[None, :] * v_src[:, None]) // torch.clamp(v_dst, min=1)[:, None]
    idx = torch.clamp(idx, 0, t_in - 1)
    y = torch.gather(x, 3, idx[:, None, None, :].expand(b, c, f, out_t))
    keep = (j[None, :] < v_dst[:, None]).to(y.dtype)
    return y * keep[:, None, None, :]
