"""Checkpoints in torch format with the reference's names and semantics
(port of `sos_tpu/train/checkpoints.py`).

Reference behaviour kept (m1 agent.py:62-100, train.py:84-95): one
checkpoint per epoch named `ckpt_epoch{N}`, a rolling `latest` and a
`best_acc` snapshot; each holds the model's weights and BatchNorm
statistics, the optimizer's state (Adam's moments and count, from which
the schedule's position follows) and the step, with the TrainClock in a
strict-JSON sidecar. Loading by epoch number restores all of them.

A checkpoint `<name>` is one `torch.save` file `<model_dir>/<name>.pt`
(`{"model": state_dict, "optimizer": state_dict, "step": int}`) and
`<model_dir>/<name>.clock.json`, each written to a temporary file,
flushed to disk and renamed over the old one, so a kill mid-write
leaves the previous file whole. `load_model_state` reads the weights
alone, as the eval and serving CLIs take them.
`sos_tpu`'s orbax checkpoints (a directory `<model_dir>/<name>/`) need
JAX to read and are not read here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

from sos_tpu_torch.train.state import TrainClock, TrainState


class CheckpointNotReadable(ValueError):
    """A checkpoint that is missing, or in a layout the port cannot read;
    the message names the path looked for."""


def load_model_state(model_dir: str, name: str) -> Dict[str, torch.Tensor]:
    """The model's state_dict of checkpoint `name` (`latest`, `best_acc`,
    `ckpt_epoch{N}`) in `model_dir`, on the CPU. Raises
    `CheckpointNotReadable` when `<model_dir>/<name>.pt` is missing; when
    `<model_dir>/<name>/` is a directory instead (`sos_tpu`'s orbax
    layout), it says so."""
    path = os.path.join(model_dir, name + ".pt")
    if os.path.isfile(path):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return blob["model"]
    orbax = os.path.join(model_dir, name)
    if os.path.isdir(orbax):
        raise CheckpointNotReadable(
            f"{orbax} is sos_tpu's orbax checkpoint: reading it needs JAX, "
            f"which sos_tpu_torch does not use; the port reads {path}, "
            f"which its train and import_checkpoint CLIs write")
    raise CheckpointNotReadable(f"no checkpoint {path}")


def _replace_durably(tmp: str, path: str) -> None:
    with open(tmp, "rb+") as fp:
        os.fsync(fp.fileno())
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, model_dir: str):
        self.model_dir = os.path.abspath(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, name + ".pt")

    def _clock_path(self, name: str) -> str:
        return os.path.join(self.model_dir, name + ".clock.json")

    # -- save ---------------------------------------------------------------
    def save(self, state: TrainState, clock: TrainClock, name: str) -> str:
        path = self._path(name)
        tmp = path + ".tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step)}, tmp)
        _replace_durably(tmp, path)
        # the sidecar after the weights: a kill between the two leaves new
        # weights with the previous clock, and the resume then replays a
        # bounded suffix of minibatches deterministically; a torn clock
        # would crash every --continue
        tmp = self._clock_path(name) + ".tmp"
        with open(tmp, "w") as fp:
            json.dump(clock.to_dict(), fp, allow_nan=False)
        _replace_durably(tmp, self._clock_path(name))
        return path

    def save_epoch(self, state: TrainState, clock: TrainClock) -> str:
        path = self.save(state, clock, f"ckpt_epoch{clock.epoch}")
        self.save(state, clock, "latest")
        return path

    # -- load ---------------------------------------------------------------
    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def peek_best_metric(self, name: str) -> float:
        """`best_metric` from a checkpoint's clock sidecar (-inf when the
        sidecar or the field is absent or torn), so fit() can seed its
        best-metric tracking from the best_acc snapshot itself, which can
        be newer than the resumed clock's copy."""
        try:
            with open(self._clock_path(name)) as fp:
                return float(json.load(fp).get("best_metric", float("-inf")))
        # AttributeError: valid JSON that is not an object; TypeError:
        # {"best_metric": null}
        except (OSError, ValueError, TypeError, AttributeError):
            return float("-inf")

    def load(self, name: str, state: TrainState) -> Tuple[TrainState, TrainClock]:
        """Restore checkpoint `name` into `state`'s model and optimizer
        (on the model's device) and return it with the saved clock."""
        device = next(state.model.parameters()).device
        blob = torch.load(self._path(name), map_location=device,
                          weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        clock = TrainClock()
        if os.path.exists(self._clock_path(name)):
            with open(self._clock_path(name)) as fp:
                clock = TrainClock.from_dict(json.load(fp))
        return state, clock

    def load_epoch(self, epoch: int,
                   state: TrainState) -> Tuple[TrainState, TrainClock]:
        return self.load(f"ckpt_epoch{epoch}", state)
