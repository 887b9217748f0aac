"""Int8 post-training quantization of the conv trunks (port of `sos_tpu/models/quant.py`).

The int8 profile's models, built from the port's own state_dicts:

* `QuantizedDetector`: the detector's conv trunk in int8 (kernel K6),
  BiLSTM [K4] and FC head in float32 (bf16 LSTM input projection by
  default);
* `QuantizedDenoiser`: both ContextAggNet encoders in int8 [K6] and the
  InpaintNet in int8 [K7], with the float32 `out` conv (cuDNN) and the
  float32 mask head.

The scheme is sos_tpu's, unchanged: BatchNorm folds into the conv;
weights are symmetric per-output-channel int8 over the folded kernel,
with the input activation scale (per input channel for a concat) folded
in before quantizing; activations are symmetric per-tensor int8 with
static scales from calibration (max |x| * 1.1 / 127); every block
consumes int8 and emits int8 through a fused `act(acc * w_s + b)`
requantize epilogue, 1/s_out folded into w_s and b; accumulation is
int32. The folding and quantizing is the same numpy host code as
sos_tpu's, so the folded weights and scales are bit-identical.

Layouts: activations are NHWC `(B, F, T, C)` int8 between blocks; the
public entries keep sos_tpu's `(B, F, T, 2)` spectra and packed
`(B, T, F)` (re, im) pairs.

Not ported yet: the `valid_t` length-bucketed paths (K6 with the time
mask, K7 with the time tails and rows over 192; the int8 slice after the
f32/bf16 bucketed predictors, ROADMAP.md queue 1 item 3 and queue 2
A3-A4) and the "bfloat16" InpaintNet mode (queue 1 item 4). The int8
predictors run whole utterances at their own length.

Calibration runs folded-float convs; on the card it must run with TF32
off, so `calibrate` enters `exact_fp32` itself.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sos_tpu_torch.config import DenoiserModelConfig, DetectorModelConfig
from sos_tpu_torch.models.layers import TorchLinear, exact_fp32, resolve_device
from sos_tpu_torch.ops.int8_conv import (conv_same_int8, inpaint_conv_int8,
                                         lhs_dilate, pack_weight, up_pads)
from sos_tpu_torch.ops.lstm import BiLSTM
from sos_tpu_torch.ops.resize import (nearest_index_tensor, nearest_resize_1d,
                                      nearest_resize_2d)

_BN_EPS = 1e-5  # TorchBatchNorm: torch defaults
# activation scale = max|x| * margin / 127 (sos_tpu/models/quant.py:343)
_CALIBRATION_MARGIN = 1.1
log = logging.getLogger(__name__)


def fold_conv_bn(kernel: np.ndarray, scale: np.ndarray, bias: np.ndarray,
                 mean: np.ndarray, var: np.ndarray,
                 eps: float = _BN_EPS) -> Tuple[np.ndarray, np.ndarray]:
    """Fold inference BatchNorm into the preceding HWIO conv kernel.

    y = scale * (conv(x, w) - mean) / sqrt(var + eps) + bias
      = conv(x, w * g) + (bias - mean * g),  g = scale / sqrt(var + eps)
    """
    g = np.asarray(scale) / np.sqrt(np.asarray(var) + eps)
    return (np.asarray(kernel) * g[None, None, None, :],
            np.asarray(bias) - np.asarray(mean) * g)


def quantize_weight(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8: returns (w_q, scale[Cout])."""
    amax = np.max(np.abs(kernel), axis=(0, 1, 2))
    scale = np.maximum(amax, 1e-12) / 127.0
    w_q = np.clip(np.round(kernel / scale[None, None, None, :]),
                  -127, 127).astype(np.int8)
    return w_q, scale.astype(np.float32)


def _quantize_weight_folded(w_f: np.ndarray, s_in) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """Quantize with the input activation scale(s) folded into the kernel.

    s_in: scalar, or per-input-channel vector (Cin,) for concat inputs.
    Reconstruction: conv(x_q, w_q) * w_s ~= conv(x_q * s_in, w_f).
    """
    s_vec = np.broadcast_to(np.asarray(s_in, np.float64), (w_f.shape[2],))
    w_eff = np.asarray(w_f, np.float64) * s_vec[None, None, :, None]
    return quantize_weight(w_eff.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _scale_tensor(scale: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(scale, dtype=torch.float32, device=device)


def _quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """`clip(round(x / scale))` to int8, contiguous.

    A true division, as sos_tpu's: the scale goes in as a tensor on x's
    device, because PyTorch's CUDA division by a CPU scalar multiplies by
    its reciprocal instead, which rounds some values the other way. The
    tensor is built once per scale and device (a fresh host copy would
    make the launching thread wait for the stream to drain)."""
    q = torch.clamp(torch.round(x.float() / _scale_tensor(scale, x.device)),
                    -127, 127)
    return q.to(torch.int8).contiguous()


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _to_scale(amax: float) -> float:
    return amax * _CALIBRATION_MARGIN / 127.0 + 1e-12


def _on_device(x, device: torch.device, what: str) -> torch.Tensor:
    """`x` as float32, checked to lie on the model's device: a tensor
    elsewhere raises instead of being copied over."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(x)}")
    if x.device.type != device.type or (
            device.index is not None and x.device.index != device.index):
        raise ValueError(f"{what}: input on {x.device}, model on {device}")
    return x.float()


def _folded_block(state: Mapping, prefix: str, up: bool = False):
    """(HWIO folded kernel, folded bias) of a conv + BN block of a port
    state_dict; `up`: a transposed conv's (in, out, kH, kW) weight."""
    w = _numpy(state[prefix + "weight"])
    kernel = w.transpose(2, 3, 0, 1) if up else w.transpose(2, 3, 1, 0)
    return fold_conv_bn(kernel, _numpy(state[prefix + "bn.weight"]),
                        _numpy(state[prefix + "bn.bias"]),
                        _numpy(state[prefix + "bn.running_mean"]),
                        _numpy(state[prefix + "bn.running_var"]))


def _oihw(w_hwio: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1))).to(device)


def _vec(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)


def _submodule(module: torch.nn.Module, state: Mapping, prefix: str,
               device) -> torch.nn.Module:
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                            if k.startswith(prefix)})
    return module.to(device).eval()


class QuantEncoderParams:
    """Folded parameters for one encoder stack (float until `finalize`).

    `prefix`: the blocks' state_dict prefix (`conv` for the detector,
    `context.enc_x` / `context.enc_n` for the denoiser); blocks are
    `{prefix}{i}` and the 1x1 projection `proj_name`."""

    def __init__(self, state: Mapping, prefix: str, n_blocks: int, device,
                 proj_name: str = None):
        self.device = resolve_device(device)
        names = [f"{prefix}{i}" for i in range(n_blocks)] + \
            [proj_name or f"{prefix}proj"]
        self.blocks_f: List[Tuple[np.ndarray, np.ndarray]] = []
        for name in names:
            w_f, b_f = _folded_block(state, name + ".")
            self.blocks_f.append((w_f, b_f.astype(np.float32)))
        # act_scales[i] = input scale of block i (== output scale of
        # block i-1); filled by calibration, consumed by finalize().
        self.act_scales: List[float] = [1.0] * len(names)
        # finalized: (packed w_q, dequant scale, bias, requant) per block
        self.blocks: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                bool]] = []

    def finalize(self) -> None:
        self.blocks = []
        n = len(self.blocks_f)
        for i, (w_f, b_f) in enumerate(self.blocks_f):
            w_q, w_s = _quantize_weight_folded(w_f, self.act_scales[i])
            requant = i + 1 < n
            if requant:
                s_out = self.act_scales[i + 1]
                w_s, b_f = w_s / s_out, b_f / s_out
            self.blocks.append((pack_weight(w_q).to(self.device),
                                _vec(w_s, self.device),
                                _vec(b_f, self.device), requant))


def _run_encoder_int8(enc: QuantEncoderParams, specs, x: torch.Tensor,
                      time_take=None) -> torch.Tensor:
    """Int8-resident conv trunk (detector trunk, ContextAggNet encoders):
    float x NHWC `(B, F, T, C)` (any strides: the packed spectra come as
    views) is quantized once, every block runs K6, and the proj block
    returns float32 NHWC (the only f32 tensor: it feeds the float head).

    `time_take` (int64 index tensor on x's device): subset the time axis of the int8 tensor
    right before the final 1x1 proj block, which commutes with it."""
    assert enc.blocks, "finalize() must run before the first forward"
    h_q = _quantize_act(x, enc.act_scales[0])
    last = len(enc.blocks) - 1
    h = None
    for i, ((w, w_s, b, requant), (ks, dil)) in enumerate(
            zip(enc.blocks, specs)):
        if i == last and time_take is not None:
            assert tuple(ks) == (1, 1), "time_take requires a 1x1 final block"
            h_q = h_q.index_select(2, time_take)
        out = conv_same_int8(h_q, w, w_s, b, ks, dil, out_f32=not requant)
        if requant:
            h_q = out
        else:
            h = out
    return h


def _run_encoder_float_maxes(enc: QuantEncoderParams, specs,
                             x: torch.Tensor) -> List[float]:
    """Folded-float pass over NHWC `x` recording per-block input maxima
    (calibration)."""
    x = x.float().permute(0, 3, 1, 2)  # NCHW for cuDNN
    maxes = []
    for (w_f, b_f), ((kf, kt), (df, dt)) in zip(enc.blocks_f, specs):
        maxes.append(float(x.abs().max()))
        y = F.conv2d(x, _oihw(w_f, x.device),
                     padding=((kf - 1) // 2 * df, (kt - 1) // 2 * dt),
                     dilation=(df, dt)) + _vec(b_f, x.device)[:, None, None]
        x = torch.clamp_min(y, 0.0)
    return maxes


class QuantInpaintParams:
    """Folded + quantized InpaintNet blocks, keyed by block name.

    Block geometry mirrors `models/denoiser.py` InpaintNet (with the
    output_padding=1 ConvTranspose quirk and the nearest resize fix-ups).
    The final `out` block stays float32 (64 -> 2) with its int8 input's
    dequant scale folded into the kernel.
    """

    # (name, kind, kernel, stride, dilation) in forward order
    SPEC = [
        ("a_in", "down", 5, 1, 1), ("a_d1", "down", 5, 2, 1),
        ("a_d2", "down", 5, 1, 1),
        ("b_in", "down", 5, 1, 1), ("b_d1", "down", 5, 2, 1),
        ("b_d2", "down", 5, 1, 1),
        ("mid0", "down", 3, 2, 1), ("mid1", "down", 3, 1, 1),
        ("mid_dil2", "down", 3, 1, 2), ("mid_dil4", "down", 3, 1, 4),
        ("mid_dil8", "down", 3, 1, 8), ("mid_dil16", "down", 3, 1, 16),
        ("mid2", "down", 3, 1, 1), ("mid3", "down", 3, 1, 1),
        ("mid_up", "up", 3, 2, 1),
        ("up1_conv", "down", 3, 1, 1), ("up1_up", "up", 3, 2, 1),
        ("up2_conv", "down", 3, 1, 1),
    ]

    # Per-block input-scale composition. A list means the input is a
    # channel-concat of those producers' outputs in order, equal channel
    # widths; "__gated__"/"__mixed__" are the two network inputs.
    SCALE_SOURCES = {
        "a_in": ["__gated__"], "a_d1": ["a_in"], "a_d2": ["a_d1"],
        "b_in": ["__mixed__"], "b_d1": ["b_in"], "b_d2": ["b_d1"],
        "mid0": ["a_d2", "b_d2"], "mid1": ["mid0"],
        "mid_dil2": ["mid1"], "mid_dil4": ["mid_dil2"],
        "mid_dil8": ["mid_dil4"], "mid_dil16": ["mid_dil8"],
        "mid2": ["mid_dil16"], "mid3": ["mid2"], "mid_up": ["mid3"],
        "up1_conv": ["mid_up", "b_d2"], "up1_up": ["up1_conv"],
        "up2_conv": ["up1_up", "b_in"],
    }

    # Concat inputs whose producer scales differ by more than this factor
    # get their smaller-scale half's weights quantized against a max
    # dominated by the other half: finalize() warns.
    CONCAT_SCALE_RATIO_WARN = 16.0

    def __init__(self, state: Mapping, device, prefix: str = "inpaint."):
        self.device = resolve_device(device)
        self.blocks_f: Dict[str, tuple] = {}
        for name, kind, k, s, d in self.SPEC:
            p = f"{prefix}{name}."
            w_f, b_f = _folded_block(state, p, up=kind == "up")
            alpha = float(_numpy(state[p + "act.weight"]))
            self.blocks_f[name] = (w_f, b_f.astype(np.float32), alpha)
        self.out_kernel_f = _numpy(state[prefix + "out.weight"]).transpose(
            2, 3, 1, 0)
        self.out_bias = state[prefix + "out.bias"].detach().float().to(
            self.device)
        # out_scales[name] = activation scale of that block's OUTPUT, plus
        # the "__gated__"/"__mixed__" input scales. Set by calibration.
        self.out_scales: Dict[str, float] = {}
        self.blocks: Dict[str, tuple] = {}
        self.out_kernel: Optional[torch.Tensor] = None

    def finalize(self) -> None:
        self.blocks = {}
        for name, kind, k, s, d in self.SPEC:
            w_f, b_f, alpha = self.blocks_f[name]
            sources = self.SCALE_SOURCES[name]
            cin = w_f.shape[2]
            assert cin % len(sources) == 0, (name, cin, sources)
            per = cin // len(sources)
            src_scales = [self.out_scales[src] for src in sources]
            if len(src_scales) > 1:
                ratio = max(src_scales) / max(min(src_scales), 1e-30)
                if ratio > self.CONCAT_SCALE_RATIO_WARN:
                    log.warning(
                        "int8 concat block %r: producer activation scales "
                        "differ by %.1fx (%s) — the smaller-scale half's "
                        "weights lose int8 resolution; verify mask drift "
                        "for this checkpoint", name, ratio,
                        dict(zip(sources, src_scales)))
            s_in = np.repeat(np.asarray(src_scales, np.float64), per)
            w_q, w_s = _quantize_weight_folded(w_f, s_in)
            s_out = self.out_scales[name]
            self.blocks[name] = (
                pack_weight(w_q, flip=kind == "up").to(self.device),
                _vec(w_s / s_out, self.device),
                _vec((b_f / s_out).astype(np.float32), self.device),
                torch.tensor([alpha], dtype=torch.float32,
                             device=self.device))
        # float output head: fold the int8 input's dequant scale in
        self.out_kernel = _oihw(
            (self.out_kernel_f * self.out_scales["up2_conv"])
            .astype(np.float32), self.device)


_INPAINT_BY_NAME = {name: (kind, k, st, d)
                    for name, kind, k, st, d in QuantInpaintParams.SPEC}


def _encoder_specs(cfg) -> list:
    return list(zip(cfg.kernel_sizes, cfg.dilations)) + [((1, 1), (1, 1))]


def _pack_nhwc(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(re, im) `(B, T, F)` -> `(B, F, T, 2)` (a view of one stack)."""
    return torch.stack([re, im], dim=-1).transpose(1, 2)


def cat_to_nhwc(spec_cat: torch.Tensor) -> torch.Tensor:
    """Packed STFT `(B, T, 2F)` = [re | im] -> `(B, F, T, 2)` view."""
    b, t, two_f = spec_cat.shape
    return spec_cat.view(b, t, 2, two_f // 2).permute(0, 3, 1, 2)


class QuantizedDenoiser:
    """JointDenoiser with int8 ContextAggNet encoders and InpaintNet.

    `__call__(mixed, gated)` takes and returns sos_tpu's `(B, F, T, 2)`
    spectra: (noise_pred, compressed cRM). The LSTM/FC mask head is
    float32 except the hoisted LSTM input projection, which runs in bf16
    by default (`bf16_head_proj`). `calibrate()` or `load_calibration()`
    must run before the first forward (static activation scales).
    `device`: "cuda" (default) or "cpu", as for `FusedDenoisePipeline`.
    """

    def __init__(self, cfg: DenoiserModelConfig, state: Mapping,
                 bf16_head_proj: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = device = resolve_device(device)
        self.bf16_head_proj = bf16_head_proj
        n = len(cfg.kernel_sizes)
        self.enc_x = QuantEncoderParams(state, "context.enc_x", n, device)
        self.enc_n = QuantEncoderParams(state, "context.enc_n", n, device)
        self.qinpaint = QuantInpaintParams(state, device)
        feats = (cfg.outf_mixed + cfg.outf_noise) * cfg.freq_bins
        self.lstm = _submodule(BiLSTM(feats, cfg.lstm_hidden,
                                      bf16_proj=bf16_head_proj),
                               state, "context.lstm.", device)
        self.fc0 = _submodule(TorchLinear(2 * cfg.lstm_hidden, cfg.fc_hidden),
                              state, "context.fc0.", device)
        self.fc1 = _submodule(TorchLinear(cfg.fc_hidden, cfg.fc_hidden),
                              state, "context.fc1.", device)
        self.fc2 = _submodule(TorchLinear(cfg.fc_hidden, 2 * cfg.freq_bins),
                              state, "context.fc2.", device)
        self._calibrated = False

    # -- InpaintNet ------------------------------------------------------

    def _inpaint_geometry(self, gated: torch.Tensor, mixed: torch.Tensor,
                          blk) -> torch.Tensor:
        """The InpaintNet dataflow with a pluggable per-block op `blk`,
        written once for the int8 pass (int8 NHWC in and out of every
        block) and the float calibration pass. Returns the float32 noise
        prediction NCHW `(B, 2, F, T)`."""
        d1 = blk("a_in", gated)
        d2 = blk("a_d2", blk("a_d1", d1))
        d3 = blk("b_in", mixed)
        d4 = blk("b_d2", blk("b_d1", d3))
        x = torch.cat([d2, d4], dim=-1)
        for nm in ("mid0", "mid1", "mid_dil2", "mid_dil4", "mid_dil8",
                   "mid_dil16", "mid2", "mid3", "mid_up"):
            x = blk(nm, x)
        if x.shape[1:3] != d4.shape[1:3]:
            x = nearest_resize_2d(x, d4.shape[1:3], 1, 2)
        x = blk("up1_up", blk("up1_conv", torch.cat([x, d4], dim=-1)))
        if x.shape[1:3] != d3.shape[1:3]:
            x = nearest_resize_2d(x, d3.shape[1:3], 1, 2)
        x = blk("up2_conv", torch.cat([x, d3], dim=-1))
        # float head; for the int8 pass the input dequant scale is folded
        # into out_kernel by finalize()
        qp = self.qinpaint
        kernel = (qp.out_kernel if x.dtype == torch.int8
                  else _oihw(qp.out_kernel_f, x.device))
        xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1),
                   mode="reflect")
        return F.conv2d(xp, kernel) + qp.out_bias[:, None, None]

    def _inpaint_block_int8(self, name: str, x_q: torch.Tensor):
        """Consumes int8 (producer-scaled), emits int8 (own out scale): K7."""
        kind, k, s, d = _INPAINT_BY_NAME[name]
        w, w_s, b, alpha = self.qinpaint.blocks[name]
        return inpaint_conv_int8(x_q, w, w_s, b, alpha, kind, k, s, d)

    def _inpaint_block_float(self, name: str, x: torch.Tensor,
                             record: Dict) -> torch.Tensor:
        """Folded-float block recording OUTPUT maxima (calibration)."""
        kind, k, s, d = _INPAINT_BY_NAME[name]
        w_f, b, alpha = self.qinpaint.blocks_f[name]
        x = x.permute(0, 3, 1, 2).float()
        if kind == "down":
            pad = (k - 1) // 2 * d
            xp = F.pad(x, (pad,) * 4, mode="reflect") if pad else x
            y = F.conv2d(xp, _oihw(w_f, x.device), stride=s, dilation=d)
        else:
            lo, hi = up_pads(k)
            y = F.conv2d(lhs_dilate(x, s, lo, hi),
                         _oihw(w_f[::-1, ::-1], x.device))
        y = y + _vec(b, x.device)[:, None, None]
        y = torch.where(y >= 0, y, alpha * y)
        record[name] = max(record.get(name, 0.0), float(y.abs().max()))
        return y.permute(0, 2, 3, 1)

    def _inpaint_int8(self, gated: torch.Tensor,
                      mixed: torch.Tensor) -> torch.Tensor:
        qp = self.qinpaint
        return self._inpaint_geometry(
            _quantize_act(gated, qp.out_scales["__gated__"]),
            _quantize_act(mixed, qp.out_scales["__mixed__"]),
            self._inpaint_block_int8)

    # -- forward ---------------------------------------------------------

    def _encoder_int8(self, enc: QuantEncoderParams,
                      x: torch.Tensor) -> torch.Tensor:
        """NHWC float -> channel-major features `(B, T, C*F)`."""
        h = _run_encoder_int8(enc, _encoder_specs(self.cfg), x)
        bsz, f, t, c = h.shape
        return h.permute(0, 2, 3, 1).reshape(bsz, t, c * f)

    def _head(self, f_x: torch.Tensor, f_n: torch.Tensor) -> torch.Tensor:
        h = self.lstm(torch.cat([f_x, f_n], dim=-1))
        h = torch.relu(self.fc0(h))
        h = torch.relu(self.fc1(h))
        return torch.sigmoid(self.fc2(h))

    def _forward(self, mixed: torch.Tensor, gated: torch.Tensor):
        """NHWC spectra -> (noise NCHW, packed sigmoid head (B, T, 2F))."""
        assert self._calibrated, "call calibrate() before the first forward"
        with torch.no_grad(), exact_fp32():
            noise = self._inpaint_int8(gated, mixed)
            f_x = self._encoder_int8(self.enc_x, mixed)
            f_n = self._encoder_int8(self.enc_n, noise.permute(0, 2, 3, 1))
            return noise, self._head(f_x, f_n)

    def forward_cat(self, mixed_cat: torch.Tensor, gated_cat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed STFTs `(B, T, 2F)` -> (noise prediction NCHW
        `(B, 2, F, T)`, packed compressed cRM `(B, T, 2F)`)."""
        return self._forward(cat_to_nhwc(mixed_cat), cat_to_nhwc(gated_cat))

    def crm_cat(self, mixed_cat: torch.Tensor,
                gated_cat: torch.Tensor) -> torch.Tensor:
        """Packed STFTs `(B, T, 2F)` -> packed compressed cRM `(B, T, 2F)`
        (the layout kernel K3 reads)."""
        return self.forward_cat(mixed_cat, gated_cat)[1]

    def crm_packed(self, mixed_re, mixed_im, gated_re, gated_im
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Spectra as (re, im) pairs of `(B, T, F)` -> the compressed cRM
        as (crm_re, crm_im), same packing."""
        h = self._forward(_pack_nhwc(mixed_re, mixed_im),
                          _pack_nhwc(gated_re, gated_im))[1]
        f = self.cfg.freq_bins
        return h[..., :f], h[..., f:]

    def __call__(self, mixed: torch.Tensor, gated_noise: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`(B, F, T, 2)` spectra -> (noise_pred, crm), both `(B, F, T, 2)`."""
        noise, h = self._forward(mixed, gated_noise)
        bsz, t, _ = h.shape
        crm = h.reshape(bsz, t, 2, self.cfg.freq_bins).permute(0, 3, 1, 2)
        return noise.permute(0, 2, 3, 1), crm

    # -- calibration -----------------------------------------------------

    def calibrate(self, sample_batches: List[Tuple[torch.Tensor, torch.Tensor]]
                  ) -> None:
        """sample_batches: [(mixed, gated)] `(B, F, T, 2)` spectra on the
        model's device."""
        maxes_x = maxes_n = None
        rec: Dict[str, float] = {}
        with torch.no_grad(), exact_fp32():
            for mixed, gated in sample_batches:
                mixed = _on_device(mixed, self.device, "calibrate")
                gated = _on_device(gated, self.device, "calibrate")
                rec["__gated__"] = max(rec.get("__gated__", 0.0),
                                       float(gated.abs().max()))
                rec["__mixed__"] = max(rec.get("__mixed__", 0.0),
                                       float(mixed.abs().max()))
                noise = self._inpaint_geometry(
                    gated, mixed,
                    lambda nm, x: self._inpaint_block_float(nm, x, rec))
                specs = _encoder_specs(self.cfg)
                mx = _run_encoder_float_maxes(self.enc_x, specs, mixed)
                mn = _run_encoder_float_maxes(self.enc_n, specs,
                                              noise.permute(0, 2, 3, 1))
                maxes_x = mx if maxes_x is None else [
                    max(a, b) for a, b in zip(maxes_x, mx)]
                maxes_n = mn if maxes_n is None else [
                    max(a, b) for a, b in zip(maxes_n, mn)]
        self.enc_x.act_scales = [_to_scale(m) for m in maxes_x]
        self.enc_n.act_scales = [_to_scale(m) for m in maxes_n]
        self.enc_x.finalize()
        self.enc_n.finalize()
        self.qinpaint.out_scales = {k: _to_scale(m) for k, m in rec.items()}
        self.qinpaint.finalize()
        self._calibrated = True

    def calibration_state(self) -> Dict:
        """The calibrated activation scales as a JSON-serializable dict,
        the same schema sos_tpu writes."""
        assert self._calibrated
        return {"enc_x": list(self.enc_x.act_scales),
                "enc_n": list(self.enc_n.act_scales),
                "inpaint": dict(self.qinpaint.out_scales)}

    def load_calibration(self, state: Dict) -> None:
        self.enc_x.act_scales = [float(s) for s in state["enc_x"]]
        self.enc_n.act_scales = [float(s) for s in state["enc_n"]]
        self.enc_x.finalize()
        self.enc_n.finalize()
        self.qinpaint.out_scales = {k: float(v)
                                    for k, v in state["inpaint"].items()}
        self.qinpaint.finalize()
        self._calibrated = True


class QuantizedDetector:
    """SilenceDetector with an int8 conv trunk [K6]; BiLSTM + FC head stay
    float32 except the hoisted LSTM input projection (bf16 by default).
    `__call__(spec, num_frames)` takes sos_tpu's `(B, F, T, 2)`;
    `logits_packed` the (re, im) `(B, T, F)` pair. `device`: "cuda"
    (default) or "cpu"."""

    def __init__(self, cfg: DetectorModelConfig, state: Mapping,
                 bf16_head_proj: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = device = resolve_device(device)
        self.bf16_head_proj = bf16_head_proj
        self.enc = QuantEncoderParams(state, "conv", len(cfg.kernel_sizes),
                                      device, proj_name="proj")
        self.lstm = _submodule(BiLSTM(cfg.outf * cfg.freq_bins,
                                      cfg.lstm_hidden,
                                      bf16_proj=bf16_head_proj),
                               state, "lstm.", device)
        self.fc1 = _submodule(TorchLinear(2 * cfg.lstm_hidden, cfg.fc_hidden),
                              state, "fc1.", device)
        self.fc2 = _submodule(TorchLinear(cfg.fc_hidden, 1), state, "fc2.",
                              device)
        self._calibrated = False

    def calibrate(self, sample_specs: List[torch.Tensor]) -> None:
        """sample_specs: [(B, F, T, 2) mixed spectrograms] on the model's
        device."""
        maxes = None
        with torch.no_grad(), exact_fp32():
            for spec in sample_specs:
                spec = _on_device(spec, self.device, "calibrate")
                m = _run_encoder_float_maxes(
                    self.enc, _encoder_specs(self.cfg), spec)
                maxes = m if maxes is None else [max(a, b)
                                                 for a, b in zip(maxes, m)]
        self.enc.act_scales = [_to_scale(m) for m in maxes]
        self.enc.finalize()
        self._calibrated = True

    def calibration_state(self) -> Dict:
        assert self._calibrated
        return {"conv": list(self.enc.act_scales)}

    def load_calibration(self, state: Dict) -> None:
        self.enc.act_scales = [float(s) for s in state["conv"]]
        self.enc.finalize()
        self._calibrated = True

    def _head(self, x: torch.Tensor, num_frames: int,
              pre_resampled: bool = False) -> torch.Tensor:
        bsz, f, t, c = x.shape
        x = x.permute(0, 2, 3, 1).reshape(bsz, t, c * f)
        if pre_resampled:
            assert t == num_frames
        else:
            x = nearest_resize_1d(x, num_frames, dim=1)
        x = self.lstm(x.float())
        x = torch.relu(self.fc1(x))
        return self.fc2(x)[..., 0]

    def _time_take(self, t_in: int, num_frames: int) -> torch.Tensor:
        return nearest_index_tensor(t_in, num_frames, self.device)

    def _logits_nhwc(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        """Fixed-shape path: resample time on int8 BEFORE the 1x1 proj
        (bit-identical; the proj commutes with time subsetting)."""
        assert self._calibrated, "call calibrate() before the first forward"
        with torch.no_grad(), exact_fp32():
            h = _run_encoder_int8(self.enc, _encoder_specs(self.cfg), x,
                                  time_take=self._time_take(x.shape[2],
                                                            num_frames))
            return self._head(h, num_frames, pre_resampled=True)

    def __call__(self, spec: torch.Tensor, num_frames: int) -> torch.Tensor:
        """`(B, F, T, 2)` -> logits `(B, num_frames)`."""
        return self._logits_nhwc(spec, num_frames)

    def logits_packed(self, re: torch.Tensor, im: torch.Tensor,
                      num_frames: int) -> torch.Tensor:
        return self._logits_nhwc(_pack_nhwc(re, im), num_frames)

    def logits_cat(self, spec_cat: torch.Tensor,
                   num_frames: int) -> torch.Tensor:
        """Packed STFT `(B, T, 2F)` -> logits `(B, num_frames)`."""
        return self._logits_nhwc(cat_to_nhwc(spec_cat), num_frames)


# The exception set load_calibration can raise on a wrong-schema scale
# mapping (AttributeError: a non-dict where a mapping belongs hits
# .items()). Every parser of the persisted calibration schema catches
# exactly this tuple.
CALIBRATION_SCHEMA_ERRORS = (AttributeError, IndexError, KeyError,
                             TypeError, ValueError)


def parse_calibration_file(path: str):
    """File-level parse of a persisted int8 activation-scale JSON
    ({"denoiser": scales, "detector": scales}, the schema both packages
    write). Returns `(state, None)` or `(None, problem)`, `problem` one
    of "not found", "unreadable (...)", "not a JSON object"."""
    if not os.path.exists(path):
        return None, "not found"
    try:
        with open(path) as fp:
            state = json.load(fp)
    except (OSError, ValueError) as exc:
        return None, f"unreadable ({exc})"
    if not isinstance(state, dict):
        return None, "not a JSON object"
    return state, None


def read_calibration_state(path: str, key: str) -> Optional[Dict]:
    """The `key` sub-state of a persisted calibration JSON, or None with
    a logged warning naming the file and the problem (an absent file is
    the normal first run: no warning)."""
    if not os.path.exists(path):
        return None
    state, problem = parse_calibration_file(path)
    if state is None:
        log.warning("calibration file %s: %s — self-calibrating instead",
                    path, problem)
        return None
    if key not in state:
        log.warning('calibration file %s: missing the "%s" key — '
                    "self-calibrating instead", path, key)
        return None
    return state[key]


def load_persisted_calibration(quant, path: str, key: str) -> bool:
    """Load `quant`'s scales from the calibration JSON at `path`; False,
    with a logged warning, when the file is absent, unreadable or of the
    wrong scale schema (callers then self-calibrate). Only for
    not-yet-calibrated quant objects: a failed load may leave partial
    scales, harmless while `_calibrated` stays False."""
    state = read_calibration_state(path, key)
    if state is None:
        return False
    try:
        quant.load_calibration(state)
        return True
    except CALIBRATION_SCHEMA_ERRORS as exc:
        log.warning("calibration file %s: wrong scale schema (%s) — "
                    "self-calibrating instead", path, exc)
        return False
