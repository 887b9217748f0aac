"""The body of tests/test_torch_parallel.py's processes: the port's
detector, denoiser and joint train steps, and sync-BN's moments in
float64, run in a gloo process group of `world` CPU processes (each on
its slice of the global batch) or, with `world` 1 and no group, on the
whole batch. Imports only `sos_tpu_torch` (the processes start fresh,
without JAX); the weights, the batch and the config come from a file
the test writes."""

import copy

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.models.layers import batch_moments, batch_norms
from sos_tpu_torch.parallel import distributed
from sos_tpu_torch.train import joint, loop

STEPS_PER_EPOCH = 4


def _local(batch, rank: int, world: int):
    n = len(batch["snr"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _recording(state, seen: dict, key: str):
    """Record the gradients `state`'s optimizer steps with (after the
    group's average)."""
    def hook(optimizer, args, kwargs):
        seen[key] = {n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()}
    state.optimizer.register_step_pre_hook(hook)


def _state(pcfg, stage, state_dict):
    init = (loop.init_detector_state if stage == "detector"
            else loop.init_denoiser_state)
    return init(pcfg, device="cpu", state_dict=copy.deepcopy(state_dict))[1]


def _bn_stats(model):
    return {n: t.clone() for n, t in model.state_dict().items()
            if "running" in n}


def train_steps(inputs: dict, rank: int = 0, world: int = 1,
                cases=("detector", "denoiser", "joint")) -> dict:
    """One step of each stage and one joint step (those of `cases`), from
    the same weights, on this process's slice of the global batch: {case:
    {"metrics", "grads" (as Adam stepped with them), "state", "stats"}}."""
    pcfg = ExperimentConfig.from_json(inputs["cfg"])
    batch = _local(inputs["batch"], rank, world)
    out = {}
    for stage in (c for c in ("detector", "denoiser") if c in cases):
        state = _state(pcfg, stage, inputs[stage])
        distributed.replicate([state.model])
        seen = {}
        _recording(state, seen, stage)
        make = (loop.make_detector_train_step if stage == "detector"
                else loop.make_denoiser_train_step)
        _, metrics = make(pcfg, STEPS_PER_EPOCH)(state, batch)
        assert all(bn.pending_stats is None
                   for bn in batch_norms(state.model))
        out[stage] = {"metrics": metrics, "grads": seen[stage],
                      "state": state.model.state_dict(),
                      "stats": _bn_stats(state.model)}
    if "joint" not in cases:
        return out
    det = _state(pcfg, "detector", inputs["detector"])
    den = _state(pcfg, "denoiser", inputs["denoiser"])
    seen = {}
    _recording(det, seen, "detector")
    _recording(den, seen, "denoiser")
    det, den, metrics = joint.make_joint_train_step(pcfg, STEPS_PER_EPOCH)(
        det, den, batch)
    out["joint"] = {"metrics": metrics, "grads": seen,
                    "state": {"detector": det.model.state_dict(),
                              "denoiser": den.model.state_dict()},
                    "stats": {**{"detector." + k: v for k, v in
                                 _bn_stats(det.model).items()},
                              **{"denoiser." + k: v for k, v in
                                 _bn_stats(den.model).items()}}}
    return out


def sync_bn_float64(inputs: dict, rank: int = 0, world: int = 1) -> dict:
    """BatchNorm's training-mode normalisation in float64 over this
    process's slice of `inputs["bn_x"]`, from `batch_moments` (synced in a
    group), and its input gradient under the fixed upstream gradient
    `inputs["bn_g"]`: {"y", "dx", "mean", "var"}."""
    n = inputs["bn_x"].shape[0] // world
    x = inputs["bn_x"][rank * n:(rank + 1) * n].clone().requires_grad_(True)
    g = inputs["bn_g"][rank * n:(rank + 1) * n]
    mean, var = batch_moments(x)
    y = (x - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
    (y * g).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "mean": mean.detach(),
            "var": var.detach()}


def worker(rank: int, world: int, port: int, path: str) -> None:
    """A process of the group: run both cases, save its results."""
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, require=True,
                           device="cpu")
    try:
        inputs = torch.load(f"{path}/inputs.pt", weights_only=False)
        results = {"steps": train_steps(inputs, rank, world),
                   "bn": sync_bn_float64(inputs, rank, world)}
        torch.save(results, f"{path}/rank{rank}.pt")
    finally:
        distributed.shutdown()

