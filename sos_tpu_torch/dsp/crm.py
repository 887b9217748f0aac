"""Complex ratio mask (cRM) math (port of `sos_tpu/dsp/crm.py`).

The sigmoid-compressed cRM of the reference (transform.py:92-99,
156-169), with `sos_tpu`'s epsilon placement kept exactly. These are the
plain versions; on the card the pipeline's recover and complex multiply
run inside kernel K3 (`dsp/stft.py` `crm_istft`), which uses the same
expressions.

Layout: spectrograms are `(..., F, T, 2)` with real/imag last.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def complex_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex product of two (..., 2) real/imag-packed tensors."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log that gives the same bits in every process.

    `torch.log` on the CPU goes to MKL's vector math, whose first call in
    a fresh process can run one thread's chunk on a less accurate path
    (float32: up to 1.4e-4 relative near log 0; float64: about 5e-13),
    so CPU tensors take numpy's log instead."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.log(x.numpy()))
    return torch.log(x)


def crm_sigmoid_recover(o: torch.Tensor, a: float = 0.1,
                        b: float = 0.0) -> torch.Tensor:
    """Inverse of the sigmoid cRM compression (transform.py:97-99).

    Evaluated in float64 and rounded once to `o`'s dtype, so each value
    is within an ulp or so of the exact one, and identical from one run
    to the next."""
    x = o.double()
    y = 1.0 / a * (_log(x / (1.0 - x + _EPS) + 1e-10) + b)
    return y.to(o.dtype)


def apply_mask_complex(noisy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """S = M * Y with (..., 2) real/imag packing."""
    return complex_mul(mask, noisy)


def apply_compressed_crm(noisy: torch.Tensor, crm: torch.Tensor,
                         a: float = 0.1, b: float = 0.0) -> torch.Tensor:
    """Recover the clean spectrogram from a compressed cRM prediction
    (reference `batch_fast_icRM_sigmoid`, transform.py:156-169)."""
    return apply_mask_complex(noisy, crm_sigmoid_recover(crm, a, b))
