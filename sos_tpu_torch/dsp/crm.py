"""Complex ratio mask (cRM) math (port of `sos_tpu/dsp/crm.py`).

The sigmoid-compressed cRM of the reference (transform.py:36-54, 92-99,
130-169) and its tanh family (transform.py:57-89, 102-127), with
`sos_tpu`'s epsilon placement kept exactly (`_EPS` at the mask's
denominator and inside both recovers). The training step builds the
ground-truth mask with `compressed_crm` and takes its stage-2 loss
through `apply_compressed_crm`, differentiably. On the card the
inference pipeline's recover and complex multiply run inside kernel K3
(`dsp/stft.py` `crm_istft`), which uses the same expressions.

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
    so CPU tensors take numpy's log instead, unless a gradient must flow
    (the callers' float64 keeps torch's log within 5e-13 there)."""
    if x.device.type == "cpu" and not x.requires_grad:
        return torch.from_numpy(np.log(x.numpy()))
    return torch.log(x)


def complex_ratio_mask(noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """M = clean / noisy in the complex field, eps-regularised (reference
    `generate_cRM(Y, S)`, transform.py:36-54)."""
    yr, yi = noisy[..., 0], noisy[..., 1]
    sr, si = clean[..., 0], clean[..., 1]
    denom = yr * yr + yi * yi + _EPS
    m_re = (yr * sr + yi * si) / denom
    m_im = (yr * si - yi * sr) / denom
    return torch.stack([m_re, m_im], dim=-1)


def crm_sigmoid_compress(m: torch.Tensor, a: float = 0.1,
                         b: float = 0.0) -> torch.Tensor:
    """Compress an unbounded cRM into (0, 1) (transform.py:92-94)."""
    return 1.0 / (1.0 + torch.exp(-a * m + b))


def crm_sigmoid_recover(o: torch.Tensor, a: float = 0.1,
                        b: float = 0.0) -> torch.Tensor:
    """Inverse of the sigmoid cRM compression (transform.py:97-99).

    Evaluated in float64 and rounded once to `o`'s dtype, so each value
    is within an ulp or so of the exact one, and identical from one run
    to the next."""
    x = o.double()
    y = 1.0 / a * (_log(x / (1.0 - x + _EPS) + 1e-10) + b)
    return y.to(o.dtype)


def crm_tanh_compress(m: torch.Tensor, k: float = 10.0,
                      c: float = 0.1) -> torch.Tensor:
    """Hyperbolic-tangent cRM compression into (-K, K) (transform.py:57-74);
    the reference's alternative to the sigmoid family."""
    return k * torch.tanh(c / 2.0 * m)


def crm_tanh_recover(o: torch.Tensor, k: float = 10.0,
                     c: float = 0.1) -> torch.Tensor:
    """Inverse of `crm_tanh_compress` with the reference's epsilons
    (transform.py:77-89), evaluated in float64 and rounded once."""
    x = o.double()
    y = -(1.0 / c) * _log((k - x + _EPS) / (k + x + _EPS))
    return y.to(o.dtype)


def compressed_crm(clean: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """Ground-truth compressed cRM (reference `fast_cRM_sigmoid`,
    transform.py:130-138)."""
    return crm_sigmoid_compress(complex_ratio_mask(noisy, clean))


def compressed_crm_tanh(clean: torch.Tensor, noisy: torch.Tensor,
                        k: float = 10.0, c: float = 0.1) -> torch.Tensor:
    """Tanh-compressed ground-truth cRM (reference `fast_cRM`,
    transform.py:102-112)."""
    return crm_tanh_compress(complex_ratio_mask(noisy, clean), k, c)


def apply_compressed_crm_tanh(noisy: torch.Tensor, crm: torch.Tensor,
                              k: float = 10.0, c: float = 0.1) -> torch.Tensor:
    """S = tanh_recover(crm) * Y (reference `fast_icRM`, transform.py:115-127)."""
    return apply_mask_complex(noisy, crm_tanh_recover(crm, k, c))


def apply_mask_complex(noisy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """S = M * Y with (..., 2) real/imag packing."""
    return complex_mul(mask, noisy)


def apply_compressed_crm(noisy: torch.Tensor, crm: torch.Tensor,
                         a: float = 0.1, b: float = 0.0) -> torch.Tensor:
    """Recover the clean spectrogram from a compressed cRM prediction
    (reference `batch_fast_icRM_sigmoid`, transform.py:156-169)."""
    return apply_mask_complex(noisy, crm_sigmoid_recover(crm, a, b))
