"""Reference-layout `.pth` checkpoints -> the port's state_dicts.

The reference's released checkpoints (detector `ckpt_epoch87.pth`,
denoiser `ckpt_epoch24.pth`; `{model_state_dict, optimizer_state_dict,
scheduler_state_dict, clock}`, m1 agent.py:62-100) do not load into the
port's modules as they are: the reference nests its blocks in
`nn.Sequential`s (`block.0`, `block.1`, ...) and names its heads
`fc1.0`/`fc1.2`, where the port names its modules after `sos_tpu`'s flax
modules (`conv0`, `proj`, `inpaint.a_in`, ...).

So a checkpoint takes the path `sos_tpu` weights take into the port:
the numpy layout rules of `sos_tpu/models/torch_import.py` (copied
here, :40-253 there, the channel widening of `sos_tpu`'s fast profiles
included) turn it into a flax-layout tree of numpy arrays, and
`models/convert.py` turns that tree into a state_dict. Nothing of JAX or
flax is needed for either step.

* Conv2d  (O,I,kF,kT) -> HWIO (kF,kT,I,O)
* ConvTranspose2d (I,O,kH,kW) -> (kH,kW,I,O)
* BatchNorm weight/bias -> scale/bias; running stats -> batch_stats
* LSTM weight_ih/hh (4H,C) -> (C,4H)/(H,4H); torch gate order kept
* Linear (O,I) -> (I,O)
* PReLU single-slope weight -> scalar alpha
* `module.`-prefix stripping for DataParallel-saved checkpoints
* the fast profiles' widening (`nf`, `nf_noise`): a conv trunk
  zero-padded to the profile's width, losslessly (`pad_conv_stack`)
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sos_tpu_torch.models.convert import denoiser_from_jax, detector_from_jax


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.asarray(value, dtype=np.float32)


def strip_data_parallel(state: Mapping[str, "np.ndarray"]) -> Dict[str, np.ndarray]:
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state.items()
    }


def _convert_conv(state, tkey, params, batch_stats, fpath, has_bn=True,
                  bias=False, transpose=False):
    """One Conv(+BN)(+PReLU) block. `fpath` is the flax ConvBlock path."""
    w = _np(state[f"{tkey}.weight"])
    if transpose:
        kernel = w.transpose(2, 3, 0, 1)  # (I,O,kH,kW) -> (kH,kW,I,O)
        _set(params, fpath + ("kernel",), kernel)
    else:
        kernel = w.transpose(2, 3, 1, 0)  # (O,I,kF,kT) -> HWIO
        _set(params, fpath + ("Conv_0", "kernel"), kernel)
    if bias:
        target = fpath + (("bias",) if transpose else ("Conv_0", "bias"))
        _set(params, target, _np(state[f"{tkey}.bias"]))
    if has_bn:
        bn = fpath + ("TorchBatchNorm_0", "BatchNorm_0")
        _set(params, bn + ("scale",), _np(state[f"{tkey}.bn.weight"]))
        _set(params, bn + ("bias",), _np(state[f"{tkey}.bn.bias"]))
        _set(batch_stats, bn + ("mean",), _np(state[f"{tkey}.bn.running_mean"]))
        _set(batch_stats, bn + ("var",), _np(state[f"{tkey}.bn.running_var"]))


def _convert_prelu(state, tkey, params, fpath):
    _set(params, fpath + ("act", "alpha"), _np(state[tkey]).reshape(()))


def _convert_lstm(state, prefix, params, fpath):
    for torch_sfx, mine in (("l0", "fwd"), ("l0_reverse", "bwd")):
        _set(params, fpath + (f"w_ih_{mine}",),
             _np(state[f"{prefix}.weight_ih_{torch_sfx}"]).T)
        _set(params, fpath + (f"w_hh_{mine}",),
             _np(state[f"{prefix}.weight_hh_{torch_sfx}"]).T)
        _set(params, fpath + (f"b_ih_{mine}",),
             _np(state[f"{prefix}.bias_ih_{torch_sfx}"]))
        _set(params, fpath + (f"b_hh_{mine}",),
             _np(state[f"{prefix}.bias_hh_{torch_sfx}"]))


def _convert_linear(state, tkey, params, fpath):
    _set(params, fpath + ("kernel",), _np(state[f"{tkey}.weight"]).T)
    _set(params, fpath + ("bias",), _np(state[f"{tkey}.bias"]))


def _pad_axis(a: np.ndarray, axis: int, new: int, fill: float = 0.0) -> np.ndarray:
    """Zero-pad one axis to `new` entries (channel widening)."""
    if a.shape[axis] >= new:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, new - a.shape[axis])
    return np.pad(a, pad, constant_values=fill)


def pad_conv_stack(params: Dict, stats: Dict, names, width: int) -> None:
    """Widen a trunk of ConvBlocks to `width` channels, losslessly (the
    fast profiles, `sos_tpu/models/torch_import.py` :98-129).

    Extra output channels get zero kernels; extra input channels (which
    only ever see zeros) get zero kernels too; BN pads use identity stats
    (scale 1, bias 0, mean 0, var 1), so the widened network computes
    exactly the same values on the original channels. `names` lists the
    trunk block names in order, then the projection block (whose output
    width is not padded)."""
    for idx, name in enumerate(names):
        block = params[name]
        kernel = block["Conv_0"]["kernel"]  # HWIO
        if idx > 0:
            kernel = _pad_axis(kernel, 2, width)
        if idx < len(names) - 1:
            kernel = _pad_axis(kernel, 3, width)
        block["Conv_0"]["kernel"] = kernel
        if idx < len(names) - 1 and "TorchBatchNorm_0" in block:
            bn = block["TorchBatchNorm_0"]["BatchNorm_0"]
            bn["scale"] = _pad_axis(bn["scale"], 0, width, fill=1.0)
            bn["bias"] = _pad_axis(bn["bias"], 0, width, fill=0.0)
            sn = stats[name]["TorchBatchNorm_0"]["BatchNorm_0"]
            sn["mean"] = _pad_axis(sn["mean"], 0, width, fill=0.0)
            sn["var"] = _pad_axis(sn["var"], 0, width, fill=1.0)


def detector_torch_to_flax(state: Mapping[str, np.ndarray],
                           nf: Optional[int] = None) -> Dict:
    """Reference `AudioVisualNet` state_dict -> {'params':..., 'batch_stats':...}.

    `nf` widens the conv trunk (zero-pad, lossless) to a fast-profile
    `SilenceDetector` config's width (`fast_detector_config`: 64)."""
    state = strip_data_parallel(state)
    params: Dict = {}
    stats: Dict = {}

    def conv_block(tprefix, fname):
        # Sequential layout: block.0=Conv2d, block.1=BatchNorm2d
        remap = {
            f"{tprefix}.conv.weight": state[f"{tprefix}.block.0.weight"],
            f"{tprefix}.bn.weight": state[f"{tprefix}.block.1.weight"],
            f"{tprefix}.bn.bias": state[f"{tprefix}.block.1.bias"],
            f"{tprefix}.bn.running_mean": state[f"{tprefix}.block.1.running_mean"],
            f"{tprefix}.bn.running_var": state[f"{tprefix}.block.1.running_var"],
        }
        shim = {k.replace(".conv", ""): v for k, v in remap.items()}
        _convert_conv(shim, tprefix, params, stats, (fname,))

    n_blocks = 1 + max(
        int(k.split(".")[1]) for k in state if k.startswith("encoder_audio."))
    for i in range(n_blocks - 1):
        conv_block(f"encoder_audio.{i}", f"conv{i}")
    conv_block(f"encoder_audio.{n_blocks - 1}", "proj")
    if nf is not None:
        names = [f"conv{i}" for i in range(n_blocks - 1)] + ["proj"]
        pad_conv_stack(params, stats, names, nf)
    _convert_lstm(state, "lstm", params, ("lstm",))
    _convert_linear(state, "fc1.0", params, ("fc1",))
    _convert_linear(state, "fc1.2", params, ("fc2",))
    return {"params": params, "batch_stats": stats}


def denoiser_torch_to_flax(state: Mapping[str, np.ndarray],
                           nf_noise: Optional[int] = None) -> Dict:
    """Reference `JointModel` state_dict -> {'params':..., 'batch_stats':...}.

    `nf_noise` widens the ContextAggNet noise encoder (zero-pad, lossless)
    to `fast_denoiser_config`'s width (64)."""
    state = strip_data_parallel(state)
    params: Dict = {}
    stats: Dict = {}

    def seq_conv(tprefix, fpath, conv_idx, bn_idx, act_idx=None,
                 bias=False, transpose=False):
        shim = {}
        shim[f"{tprefix}.weight"] = state[f"{tprefix}.block.{conv_idx}.weight"]
        if bias:
            shim[f"{tprefix}.bias"] = state[f"{tprefix}.block.{conv_idx}.bias"]
        has_bn = bn_idx is not None
        if has_bn:
            for name in ("weight", "bias", "running_mean", "running_var"):
                shim[f"{tprefix}.bn.{name}"] = state[f"{tprefix}.block.{bn_idx}.{name}"]
        _convert_conv(shim, tprefix, params, stats, fpath, has_bn=has_bn,
                      bias=bias, transpose=transpose)
        if act_idx is not None:
            key = f"{tprefix}.block.{act_idx}.weight"
            if key in state:
                _convert_prelu(state, key, params, fpath)

    def down(tprefix, fpath, final=False):
        # DownConvBlock Sequential: 0=ReflectionPad, 1=Conv, 2=BN, 3=PReLU
        if final:  # norm_fn=None, act=None: 0=pad, 1=conv(+bias)
            seq_conv(tprefix, fpath, conv_idx=1, bn_idx=None, bias=True)
        else:
            seq_conv(tprefix, fpath, conv_idx=1, bn_idx=2, act_idx=3)

    def up(tprefix, fpath):
        # UpConvBlock Sequential: 0=ConvTranspose, 1=BN, 2=PReLU
        seq_conv(tprefix, fpath, conv_idx=0, bn_idx=1, act_idx=2, transpose=True)

    # --- InpaintNet (stage1) ---
    s1 = ("inpaint",)
    down("stage1.down1.0", s1 + ("a_in",))
    down("stage1.down2.0", s1 + ("a_d1",))
    down("stage1.down2.1", s1 + ("a_d2",))
    down("stage1.down3.0", s1 + ("b_in",))
    down("stage1.down4.0", s1 + ("b_d1",))
    down("stage1.down4.1", s1 + ("b_d2",))
    mid_names = ["mid0", "mid1", "mid_dil2", "mid_dil4", "mid_dil8",
                 "mid_dil16", "mid2", "mid3"]
    for i, name in enumerate(mid_names):
        down(f"stage1.mid.{i}", s1 + (name,))
    up("stage1.mid.8", s1 + ("mid_up",))
    down("stage1.up1.0", s1 + ("up1_conv",))
    up("stage1.up1.1", s1 + ("up1_up",))
    down("stage1.up2.0", s1 + ("up2_conv",))
    down("stage1.up2.1", s1 + ("out",), final=True)

    # --- ContextAggNet (stage2) ---
    s2 = ("context",)

    def enc_block(tprefix, fname):
        shim = {
            f"{tprefix}.weight": state[f"{tprefix}.block.0.weight"],
            f"{tprefix}.bn.weight": state[f"{tprefix}.block.1.weight"],
            f"{tprefix}.bn.bias": state[f"{tprefix}.block.1.bias"],
            f"{tprefix}.bn.running_mean": state[f"{tprefix}.block.1.running_mean"],
            f"{tprefix}.bn.running_var": state[f"{tprefix}.block.1.running_var"],
        }
        _convert_conv(shim, tprefix, params, stats, s2 + (fname,))

    n_enc = 1 + max(
        int(k.split(".")[2]) for k in state if k.startswith("stage2.encoder_x."))
    for i in range(n_enc - 1):
        enc_block(f"stage2.encoder_x.{i}", f"enc_x{i}")
        enc_block(f"stage2.encoder_n.{i}", f"enc_n{i}")
    enc_block(f"stage2.encoder_x.{n_enc - 1}", "enc_xproj")
    enc_block(f"stage2.encoder_n.{n_enc - 1}", "enc_nproj")
    if nf_noise is not None:
        names = [f"enc_n{i}" for i in range(n_enc - 1)] + ["enc_nproj"]
        pad_conv_stack(params["context"], stats["context"], names, nf_noise)
    _convert_lstm(state, "stage2.lstm", params, s2 + ("lstm",))
    _convert_linear(state, "stage2.fc.0", params, s2 + ("fc0",))
    _convert_linear(state, "stage2.fc.2", params, s2 + ("fc1",))
    _convert_linear(state, "stage2.fc.4", params, s2 + ("fc2",))
    return {"params": params, "batch_stats": stats}


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """Load a reference checkpoint file's model_state_dict as numpy."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model_state_dict", ckpt)
    return {k: _np(v) for k, v in state.items()}


def import_detector_checkpoint(path: str, nf: Optional[int] = None) -> Dict:
    """Reference detector `.pth` -> port `SilenceDetector` state_dict
    (`nf`: widened to that trunk width)."""
    return detector_from_jax(detector_torch_to_flax(load_pth(path), nf=nf))


def import_denoiser_checkpoint(path: str, nf_noise: Optional[int] = None) -> Dict:
    """Reference denoiser `.pth` -> port `JointDenoiser` state_dict
    (`nf_noise`: the noise encoder widened to that width)."""
    return denoiser_from_jax(denoiser_torch_to_flax(load_pth(path),
                                                    nf_noise=nf_noise))
