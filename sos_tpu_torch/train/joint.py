"""Joint training: the detector and the denoiser in one step (port of
`sos_tpu/train/joint.py`, on one device).

The reference trains the stages apart (stage 2 consumes ground-truth
silent intervals, m2 dataset.py:167-193). One joint step:

  * runs the denoiser's device stage once (`device_mix_and_stft_denoiser`:
    K2's complement, K2 and one K1 launch over the four stacked signals)
    and feeds both models from it;
  * trains the detector with per-frame BCE of its logits on the mixed
    STFT against the ground-truth bits;
  * trains the denoiser with the dual MSE, its gated-noise input built
    from the ground-truth bits (teacher forcing: the detector's
    thresholded output is not differentiable);
  * updates each model with its own guarded Adam step: one stage may
    skip a non-finite step while the other applies, and `finite` is 1
    only when both applied.

Both `step` counters advance every step. The step runs in
`cfg.train.compute_dtype` as `train/loop.py`'s steps do. `sos_tpu`'s
psum over the data mesh waits for the port's data-parallel slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.models.layers import exact_fp32
from sos_tpu_torch.train.loop import (adam_count, denoiser_inputs,
                                      denoiser_loss, detector_loss,
                                      guarded_update, init_denoiser_state,
                                      init_detector_state, make_lr_schedule)
from sos_tpu_torch.train.state import TrainState


def init_joint_states(cfg: ExperimentConfig, device="cuda", seed: int = 0):
    """((detector, state), (denoiser, state)) on `device` (the card
    unless "cpu"): fresh weights, the detector's seeded by `seed` and
    the denoiser's by `seed + 1`, as `sos_tpu`'s PRNG keys."""
    return (init_detector_state(cfg, device, seed=seed),
            init_denoiser_state(cfg, device, seed=seed + 1))


def joint_inputs(cfg: ExperimentConfig, batch: Dict[str, np.ndarray],
                 device) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """The joint step's device stage on `device`: (the denoiser's inputs,
    `denoiser_inputs`' dict; the detector's, its mixed STFT and the
    ground-truth bits as `{"audio", "label"}`)."""
    d = denoiser_inputs(cfg, batch, device)
    return d, {"audio": d["mixed"],
               "label": torch.as_tensor(batch["bits"]).to(device)}


def _backward_and_update(state: TrainState, loss: torch.Tensor, lr: float,
                         guard: bool) -> bool:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    return guarded_update(state, lr, guard)


def make_joint_train_step(cfg: ExperimentConfig,
                          steps_per_epoch: int) -> Callable:
    """`train_step(det_state, den_state, batch) -> (det_state, den_state,
    metrics)` with `sos_tpu`'s metric keys."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    guard = cfg.train.skip_nonfinite_updates

    def train_step(det_state: TrainState, den_state: TrainState,
                   batch: Dict[str, np.ndarray]
                   ) -> Tuple[TrainState, TrainState, Dict[str, float]]:
        det_state.model.train()
        den_state.model.train()
        lr_det = schedule(adam_count(det_state.optimizer))
        lr_den = schedule(adam_count(den_state.optimizer))
        dev = next(den_state.model.parameters()).device
        with exact_fp32():
            d, det_in = joint_inputs(cfg, batch, dev)
            det_loss, logits, bits = detector_loss(cfg, det_state.model,
                                                   det_in)
            det_fin = _backward_and_update(det_state, det_loss, lr_det, guard)
            den_loss, l1, l2 = denoiser_loss(cfg, den_state.model, d)
            den_fin = _backward_and_update(den_state, den_loss, lr_den, guard)
        acc = torch.mean(((torch.sigmoid(logits.detach()) >= 0.5).float()
                          == bits).float())
        det_state.step += 1
        den_state.step += 1
        return det_state, den_state, {
            "detector_loss": float(det_loss.detach()),
            "detector_accuracy": float(acc),
            "denoiser_loss": float(den_loss.detach()),
            "stage1": float(l1.detach()), "stage2": float(l2.detach()),
            "finite": float(det_fin and den_fin)}

    return train_step
