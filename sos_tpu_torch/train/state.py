"""Training state + the reference's TrainClock bookkeeping (port of
`sos_tpu/train/state.py`).

`sos_tpu`'s state is a functional pytree (params, batch stats, optimizer
state, step); here it is the stateful trio PyTorch trains with: the
model (parameters and BatchNorm buffers), its Adam optimizer and the
step. The clock is copied as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0  # global minibatch counter (every step, skipped or not)


@dataclasses.dataclass
class TrainClock:
    epoch: int = 0
    minibatch: int = 0
    step: int = 0
    # best validation metric seen so far (drives the best_acc checkpoint;
    # persisted so a --continue resume cannot clobber a better snapshot
    # with its first post-resume epoch)
    best_metric: float = float("-inf")

    def tick(self) -> None:
        self.minibatch += 1
        self.step += 1

    def tock(self) -> None:
        self.epoch += 1
        self.minibatch = 0

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # keep the sidecar strict JSON: json.dump writes -inf as the
        # non-standard `-Infinity` token, which external tooling (jq,
        # non-Python parsers) rejects — omit the field until a real
        # best is recorded (from_dict restores the -inf default)
        if not math.isfinite(d["best_metric"]):
            del d["best_metric"]
        return d

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "TrainClock":
        if not d:
            return TrainClock()
        return TrainClock(epoch=int(d.get("epoch", 0)),
                          minibatch=int(d.get("minibatch", 0)),
                          step=int(d.get("step", 0)),
                          best_metric=float(
                              d.get("best_metric", float("-inf"))))
