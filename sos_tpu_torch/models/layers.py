"""Building blocks with `sos_tpu`'s numerics (port of `sos_tpu/models/layers.py`).

All blocks work NCHW = (B, C, F, T), eval mode only (running BN
statistics); the `valid_t` length-bucketing variants are not ported yet.
Parameters are float32; the forward casts them to the input's dtype, as
flax's `dtype=compute_dtype` does, so a bf16 input runs a bf16 conv.
The convolutions are cuDNN's (`sos_tpu` leaves them to XLA's stock
conv); the caller decides about TF32: `exact_fp32` turns it off for
matmuls and convolutions, as `infer/fused.py` and the int8 calibration
do.

* :class:`ConvBlock`     Conv2d("same" dilated padding) + BN + ReLU.
* :class:`DownConvBlock` ReflectionPad + strided Conv2d + BN + PReLU.
* :class:`UpConvBlock`   ConvTranspose2d(output_padding=1) + BN + PReLU.
* :class:`TorchLinear`   x @ W^T + b.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def exact_fp32():
    """Full-fp32 matmuls and convolutions (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            p = self.pad
            x = F.pad(x, (p, p, p, p), mode="reflect")
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(x, self.weight.to(x.dtype), bias, stride=self.stride,
                     dilation=self.dilation)
        if self.bn is None:
            return x
        return self.act(self.bn(x))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv_transpose2d(x, self.weight.to(x.dtype), stride=self.stride,
                               padding=self.padding, output_padding=1)
        return self.act(self.bn(x))


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
