"""Train and eval steps of both stages, the optimizer and its schedule
(port of `sos_tpu/train/loop.py`).

Losses are the reference agents':

* detector — `BCEWithLogitsLoss` over per-frame logits against the
  60-frame labels (m1 agent.py:185-206); eval adds per-frame accuracy at
  sigmoid >= 0.5 (m1 agent.py:208-232);
* denoiser — `MSE(noise_pred, full_noise) + MSE(icrm(mixed, mask),
  clean)` through the differentiable cRM inverse (m2 agent.py:176-190,
  transform.py:156-169).

Optimizer: `torch.optim.Adam` (betas 0.9/0.999, eps 1e-8, as
`optax.adam`) with a StepLR staircase, `lr * gamma^floor(count /
(steps_per_epoch * lr_step_size))`, evaluated at the optimizer's own
count of applied steps (a skipped step does not advance it), as
`sos_tpu` reads optax's schedule count.

A step runs, on the model's device: the device mix and STFTs
(`data/pipeline.py`: kernels K1 and K2 on the card), the model in
training mode, the loss, the backward (K4b for the BiLSTM), and the
guarded update: when any gradient is not finite the parameters, the
Adam moments and count and the BatchNorm running statistics all stay as
they were, and the step's `finite` metric is 0. The forward and the
backward both run inside `exact_fp32`: cuDNN's convolutions (and their
weight- and data-gradient kernels) and the matmuls stay in full fp32,
`sos_tpu`'s reference-exact f32. Checking the gradients costs one host
synchronisation a step.

`cfg.train.compute_dtype = "bfloat16"` runs the conv trunks in bf16, as
`sos_tpu`'s does (parameters float32, cast to bf16 at each conv;
BatchNorm's statistics and normalisation in float32, its output cast
back; the gradients reach the float32 parameters through those casts).
The BiLSTM (K4's training instance and K4b), the heads, the models'
outputs and so the losses stay float32, so no bf16 matmul runs (PyTorch's
reduced-precision bf16 reductions do not arise) and `exact_fp32` still
holds the float32 parts to full fp32. `cfg.train.remat = False` keeps
every block's activations instead of running its forward again.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.data.pipeline import (device_mix_and_stft_denoiser,
                                         device_mix_and_stft_detector)
from sos_tpu_torch.dsp.crm import apply_compressed_crm
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.layers import (batch_norms, commit_batch_stats,
                                         discard_batch_stats, exact_fp32,
                                         init_state_dict, resolve_device)
from sos_tpu_torch.train.state import TrainState

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_lr_schedule(cfg: ExperimentConfig,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR(step_size=lr_step_size, gamma) as a staircase over the
    optimizer's count of applied steps."""
    boundary = max(1, steps_per_epoch * cfg.train.lr_step_size)
    return lambda count: cfg.train.lr * cfg.train.lr_gamma ** (count // boundary)


def make_optimizer(cfg: ExperimentConfig,
                   model: torch.nn.Module) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg.train.lr,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """Steps the optimizer has applied (its own count, which a skipped
    non-finite step leaves as it was; 0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def fresh_state_dict(model: torch.nn.Module, seed: int) -> Dict:
    """Weights to train from: torch's default-init ranges from a seeded
    generator, BatchNorm at flax's start (scale 1, bias 0, running mean
    0, running variance 1)."""
    init_state_dict(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for bn in batch_norms(model):
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
    return model.state_dict()


def _init_state(model: torch.nn.Module, cfg: ExperimentConfig, device,
                state_dict: Optional[Dict], seed: Optional[int]) -> TrainState:
    if state_dict is None:
        state_dict = fresh_state_dict(
            model, cfg.train.seed if seed is None else seed)
    model.load_state_dict(state_dict)
    model.to(resolve_device(device))
    return TrainState(model, make_optimizer(cfg, model), 0)


def init_detector_state(cfg: ExperimentConfig, device="cuda",
                        state_dict: Optional[Dict] = None,
                        seed: Optional[int] = None
                        ) -> Tuple[SilenceDetector, TrainState]:
    """A detector to train on `device` (the card unless "cpu") in
    `cfg.train.compute_dtype`, from `state_dict` or from fresh weights
    seeded by `seed` (default `cfg.train.seed`)."""
    model = SilenceDetector(cfg.detector,
                            compute_dtype=cfg.train.compute_dtype,
                            remat=cfg.train.remat)
    return model, _init_state(model, cfg, device, state_dict, seed)


def init_denoiser_state(cfg: ExperimentConfig, device="cuda",
                        state_dict: Optional[Dict] = None,
                        seed: Optional[int] = None
                        ) -> Tuple[JointDenoiser, TrainState]:
    model = JointDenoiser(cfg.denoiser,
                          compute_dtype=cfg.train.compute_dtype,
                          remat=cfg.train.remat)
    return model, _init_state(model, cfg, device, state_dict, seed)


# ---------------------------------------------------------------------------
# The guarded update and the losses
# ---------------------------------------------------------------------------


def all_finite(model: torch.nn.Module) -> bool:
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return True
    return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())


def guarded_update(state: TrainState, lr: float, enabled: bool) -> bool:
    """Apply Adam and the BatchNorm statistics only when EVERY gradient
    is finite (with `enabled`; else always). A skipped step leaves the
    parameters, the Adam moments and count and the running statistics
    as they were. Returns whether the update was applied."""
    finite = all_finite(state.model) if enabled else True
    if finite:
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        commit_batch_stats(state.model)
    else:
        discard_batch_stats(state.model)
    state.optimizer.zero_grad(set_to_none=True)
    return finite


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # mean over all frames/batch, identical to BCEWithLogitsLoss default
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             weights: Tuple[float, float] = (1.0, 1.0)
                             ) -> torch.Tensor:
    """Class-weighted BCE (reference `weighted_binary_cross_entropy`,
    m1 tools.py:541-577 — kept available though the final detector uses
    the unweighted loss). weights = (w_negative, w_positive)."""
    p = F.logsigmoid(logits)
    q = F.logsigmoid(-logits)  # log(1 - sigmoid)
    loss = -(weights[1] * labels * p + weights[0] * (1.0 - labels) * q)
    return torch.mean(loss)


def _on_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


# ---------------------------------------------------------------------------
# Detector steps
# ---------------------------------------------------------------------------


def detector_inputs(cfg: ExperimentConfig, batch: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """The detector step's device stage on `device`: mix + STFT ->
    `{"audio", "label"}`."""
    b = _on_device(batch, device)
    return device_mix_and_stft_detector(b["clean"], b["noise"], b["snr"],
                                        b["bits"], cfg.data, cfg.stft)


def detector_loss(cfg: ExperimentConfig, model: torch.nn.Module,
                  inputs: Dict[str, torch.Tensor]):
    """The detector step's forward from its `detector_inputs`: logits,
    BCE -> (loss, logits, label). The caller sets the model's mode and
    `exact_fp32`."""
    logits = model(inputs["audio"], num_frames=cfg.data.clip_frames)
    return _bce_with_logits(logits, inputs["label"]), logits, inputs["label"]


def make_detector_train_step(cfg: ExperimentConfig,
                             steps_per_epoch: int) -> Callable:
    schedule = make_lr_schedule(cfg, steps_per_epoch)

    def train_step(state: TrainState, batch: Dict[str, np.ndarray]):
        state.model.train()
        lr = schedule(adam_count(state.optimizer))
        with exact_fp32():
            inputs = detector_inputs(cfg, batch, _device_of(state.model))
            loss, logits, label = detector_loss(cfg, state.model, inputs)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            finite = guarded_update(state, lr, cfg.train.skip_nonfinite_updates)
        acc = torch.mean(((torch.sigmoid(logits.detach()) >= 0.5).float()
                          == label).float())
        state.step += 1
        return state, {"loss": float(loss.detach()), "accuracy": float(acc),
                       "finite": float(finite), "lr": lr}

    return train_step


def make_detector_eval_step(cfg: ExperimentConfig) -> Callable:
    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, np.ndarray]):
        state.model.eval()
        with exact_fp32():
            inputs = detector_inputs(cfg, batch, _device_of(state.model))
            loss, logits, label = detector_loss(cfg, state.model, inputs)
        pred = (torch.sigmoid(logits) >= 0.5).float()
        acc = torch.mean((pred == label).float())
        return {"loss": float(loss), "accuracy": float(acc),
                "pred": pred.cpu().numpy(), "label": label.cpu().numpy()}

    return eval_step


# ---------------------------------------------------------------------------
# Denoiser steps
# ---------------------------------------------------------------------------


def denoiser_inputs(cfg: ExperimentConfig, batch: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """The denoiser step's device stage on `device`: mix + four STFTs +
    the ground-truth cRM (`device_mix_and_stft_denoiser`'s dict)."""
    b = _on_device(batch, device)
    return device_mix_and_stft_denoiser(b["clean"], b["noise"], b["snr"],
                                        b["bits"], cfg.data, cfg.stft)


def denoiser_loss(cfg: ExperimentConfig, model: torch.nn.Module,
                  d: Dict[str, torch.Tensor]):
    """The denoiser step's forward from its `denoiser_inputs` `d`: the
    model, both MSEs -> (loss, stage1, stage2). The caller sets the
    model's mode and `exact_fp32`."""
    noise_pred, mask = model(d["mixed"], d["noise"])
    rec = apply_compressed_crm(d["mixed"], mask)
    loss_inpaint = torch.mean((noise_pred - d["full_noise"]) ** 2)
    loss_rec = torch.mean((rec - d["clean"]) ** 2)
    return loss_inpaint + loss_rec, loss_inpaint, loss_rec


def make_denoiser_train_step(cfg: ExperimentConfig,
                             steps_per_epoch: int) -> Callable:
    schedule = make_lr_schedule(cfg, steps_per_epoch)

    def train_step(state: TrainState, batch: Dict[str, np.ndarray]):
        state.model.train()
        lr = schedule(adam_count(state.optimizer))
        with exact_fp32():
            inputs = denoiser_inputs(cfg, batch, _device_of(state.model))
            loss, l1, l2 = denoiser_loss(cfg, state.model, inputs)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            finite = guarded_update(state, lr, cfg.train.skip_nonfinite_updates)
        state.step += 1
        return state, {"loss": float(loss.detach()), "stage1": float(l1.detach()),
                       "stage2": float(l2.detach()), "finite": float(finite),
                       "lr": lr}

    return train_step


def make_denoiser_eval_step(cfg: ExperimentConfig) -> Callable:
    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, np.ndarray]):
        state.model.eval()
        with exact_fp32():
            inputs = denoiser_inputs(cfg, batch, _device_of(state.model))
            _, l1, l2 = denoiser_loss(cfg, state.model, inputs)
        return {"stage1": float(l1), "stage2": float(l2)}

    return eval_step
