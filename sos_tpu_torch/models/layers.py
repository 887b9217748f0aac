"""Building blocks with `sos_tpu`'s numerics (port of `sos_tpu/models/layers.py`).

All blocks work NCHW = (B, C, F, T), eval mode only (running BN
statistics). `DownConvBlock` and `UpConvBlock` also run the exact
length-bucketed variant: given per-row valid widths `valid_t` `(B,)`
(integer tensors on the device, never read on the host), they re-zero
each row's time tail, inject the end-of-signal reflection at each row's
own boundary (`zero_time_tail`, `reflect_time_tail`), and return
`(y, valid_out)`.
Parameters are float32; the forward casts them to the input's dtype, as
flax's `dtype=compute_dtype` does, so a bf16 input runs a bf16 conv.
The convolutions are cuDNN's (`sos_tpu` leaves them to XLA's stock
conv); the caller decides about TF32: `exact_fp32` turns it off for
matmuls and convolutions, as `infer/fused.py` and the int8 calibration
do.

* :class:`ConvBlock`     Conv2d("same" dilated padding) + BN + ReLU.
* :class:`DownConvBlock` ReflectionPad + strided Conv2d + BN + PReLU.
* :class:`UpConvBlock`   ConvTranspose2d(output_padding=1) + BN + PReLU.
* `zero_time_tail`, `reflect_time_tail`: the per-row time-tail ops.
* :class:`TorchLinear`   x @ W^T + b.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


_fp32_lock = threading.Lock()
_fp32_users = 0
_fp32_saved: Tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def exact_fp32():
    """Full-fp32 matmuls and convolutions (no TF32) inside the block.

    The TF32 switches are process-global, and the serve loop runs device
    work on two threads at once, so the blocks share one reference
    count under a lock: the first to enter saves both switches and turns
    TF32 off, the last to leave restores them. Nested and concurrent
    blocks never turn TF32 back on while any thread is inside one."""
    global _fp32_users, _fp32_saved
    with _fp32_lock:
        if _fp32_users == 0:
            _fp32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _fp32_users += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_users -= 1
            if _fp32_users == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _fp32_saved


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for the CPU. Raises when a CUDA device is asked for and none is
    available; it never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain PyTorch "
                               "versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev


def _uniform(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    p.data.uniform_(-bound, bound, generator=generator)


class PReLU(nn.Module):
    """Channel-shared PReLU with a scalar slope (torch default init 0.25)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class TorchBatchNorm(nn.Module):
    """Eval-mode BatchNorm2d (eps 1e-5) in flax's order of operations:
    `(x - mean) * (rsqrt(var + eps) * scale) + bias`, computed in float32
    and cast back to the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Non-trivial running statistics, so that import mistakes show."""
        n = self.running_mean.shape[0]
        self.running_mean.copy_(torch.randn(n, generator=generator) * 0.3)
        self.running_var.copy_(torch.rand(n, generator=generator) + 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class ConvBlock(nn.Module):
    """Conv2d (per-side padding `(k-1)//2 * d`, no bias) + BN + ReLU
    (m1/m2 networks.py Conv2dBlock)."""

    def __init__(self, in_ch: int, features: int, kernel_size: Tuple[int, int],
                 dilation: Tuple[int, int] = (1, 1)):
        super().__init__()
        kf, kt = kernel_size
        self.dilation = tuple(dilation)
        self.padding = ((kf - 1) // 2 * dilation[0], (kt - 1) // 2 * dilation[1])
        self.weight = nn.Parameter(torch.empty(features, in_ch, kf, kt))
        self.bn = TorchBatchNorm(features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.weight.to(x.dtype), padding=self.padding,
                     dilation=self.dilation)
        return torch.relu(self.bn(x))


def _reflect_index(size: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of numpy's "reflect" padding by (lo, hi) of a
    length-`size` axis, for any pad: the extension of period 2(size-1)."""
    i = torch.arange(-lo, size + hi, device=device)
    if size == 1:
        return torch.zeros_like(i)
    m = torch.remainder(i, 2 * (size - 1))
    return torch.where(m >= size, 2 * (size - 1) - m, m)


def reflect_pad(x: torch.Tensor, pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """`F.pad(x, pads, mode="reflect")` of NCHW `x` (pads = left, right,
    top, bottom), also where a pad reaches the width of its axis, as
    `jnp.pad(mode="reflect")` allows (a short utterance's mid blocks):
    there, an index gather of the same values."""
    left, right, top, bottom = pads
    h, w = x.shape[2], x.shape[3]
    if max(left, right) < w and max(top, bottom) < h:
        return F.pad(x, pads, mode="reflect")
    x = torch.index_select(x, 3, _reflect_index(w, left, right, x.device))
    return torch.index_select(x, 2, _reflect_index(h, top, bottom, x.device))


def time_mask(x: torch.Tensor, valid_t: torch.Tensor) -> torch.Tensor:
    """`(B, 1, 1, T)` mask in x's dtype of each row's time steps (dim 3)
    below valid_t[b]."""
    steps = torch.arange(x.shape[3], device=x.device)
    return (steps[None, :] < valid_t[:, None]).to(x.dtype)[:, None, None, :]


def zero_time_tail(x: torch.Tensor, valid_t: torch.Tensor) -> torch.Tensor:
    """Zero each row's entries at time index (dim 3) >= valid_t[b]."""
    return x * time_mask(x, valid_t)


def reflect_time_tail(x: torch.Tensor, valid_t: torch.Tensor, pad: int,
                      offset: int = 0) -> torch.Tensor:
    """Write each row's end-of-signal reflection at its own boundary:
    columns [offset+v, offset+v+pad) of row b (v = valid_t[b]) become
    x[..., offset+v-2-j], j < pad (sources clipped to the width), as an
    unpadded program's ReflectionPad would place them. The caller keeps
    offset+v+pad <= T; like sos_tpu's dynamic_update_slice, a start past
    T - pad is moved back to T - pad. A gather of the sources, then a
    scatter into a copy."""
    b, c, f, t = x.shape
    j = torch.arange(pad, device=x.device)
    src = torch.clamp(offset + valid_t[:, None] - 2 - j[None, :], 0, t - 1)
    start = torch.clamp(offset + valid_t, 0, t - pad)
    dst = start[:, None] + j[None, :]
    shape = (b, c, f, pad)
    vals = torch.gather(x, 3, src[:, None, None, :].expand(shape))
    return x.scatter(3, dst[:, None, None, :].expand(shape), vals)


class DownConvBlock(nn.Module):
    """ReflectionPad + Conv2d(no pad, stride s) + BN + PReLU
    (m2 networks.py:97-117). `final=True` is InpaintNet's output block:
    a conv with bias, no BN, no activation."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, final: bool = False):
        super().__init__()
        k = kernel_size
        self.stride, self.dilation = stride, dilation
        self.pad = (k - 1) // 2 * dilation
        self.weight = nn.Parameter(torch.empty(features, in_ch, k, k))
        if final:
            self.bias = nn.Parameter(torch.empty(features))
            self.bn, self.act = None, None
        else:
            self.bias = None
            self.bn, self.act = TorchBatchNorm(features), PReLU()

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        _uniform(self.weight, fan_in, generator)
        if self.bias is not None:
            _uniform(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor, valid_t: Optional[torch.Tensor] = None):
        """`x` (B, C, F, T) -> y; with `valid_t` `(B,)`, the exact
        length-bucketed variant -> (y, valid_out): frequency is reflected
        in full, time on the left (its start is real), and on the right
        the tail is zeroed and each row's reflection injected at its
        valid boundary; y is re-zeroed past valid_out."""
        p = self.pad
        if p and valid_t is None:
            x = reflect_pad(x, (p, p, p, p))
        elif p:
            x = zero_time_tail(x, valid_t)
            x = reflect_pad(x, (p, 0, p, p))
            x = F.pad(x, (0, p))
            x = reflect_time_tail(x, valid_t, p, offset=p)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(x, self.weight.to(x.dtype), bias, stride=self.stride,
                     dilation=self.dilation)
        if self.bn is not None:
            x = self.act(self.bn(x))
        if valid_t is None:
            return x
        keff = self.dilation * (self.weight.shape[-1] - 1) + 1
        valid_out = torch.div(valid_t + 2 * p - keff, self.stride,
                              rounding_mode="floor") + 1
        return zero_time_tail(x, valid_out), valid_out


class UpConvBlock(nn.Module):
    """ConvTranspose2d(k, s, p=(k-1)//2, output_padding=1) + BN + PReLU
    (m2 networks.py:120-149).

    output_padding=1 replicates the reference's quirk: it passes
    `dilation` positionally into ConvTranspose2d's output_padding slot.
    The weight is torch's (in, out, kH, kW), unflipped.
    """

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 2):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, (k - 1) // 2
        self.weight = nn.Parameter(torch.empty(in_ch, features, k, k))
        self.bn = TorchBatchNorm(features)
        self.act = PReLU()

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor, valid_t: Optional[torch.Tensor] = None):
        """`x` (B, C, F, T) -> y; with `valid_t` `(B,)` -> (y, valid_out):
        the input's tail is zeroed first (it then adds nothing below the
        exact width), y re-zeroed past
        valid_out = (valid_t - 1) * s - 2p + k + 1 (output_padding 1)."""
        if valid_t is not None:
            x = zero_time_tail(x, valid_t)
        x = F.conv_transpose2d(x, self.weight.to(x.dtype), stride=self.stride,
                               padding=self.padding, output_padding=1)
        x = self.act(self.bn(x))
        if valid_t is None:
            return x
        k = self.weight.shape[-1]
        valid_out = (valid_t - 1) * self.stride - 2 * self.padding + k + 1
        return zero_time_tail(x, valid_out), valid_out


class TorchLinear(nn.Module):
    """`x @ W^T + b` with torch's (out, in) weight layout."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1]
        _uniform(self.weight, fan_in, generator)
        _uniform(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.to(x.dtype).t()) + self.bias.to(x.dtype)


def init_state_dict(module: nn.Module, generator: torch.Generator) -> dict:
    """Fill `module` with random weights in torch's default-init ranges
    and non-trivial BN running statistics, drawn from `generator`; return
    its state_dict. Weights for runs without a checkpoint."""
    with torch.no_grad():
        for m in module.modules():
            reset = getattr(m, "reset_parameters", None)
            if reset is not None:
                reset(generator)
    return module.state_dict()
