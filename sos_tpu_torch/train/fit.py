"""The epoch loop of training, shared by both stages (port of
`sos_tpu/train/fit.py`, on one device).

Reproduces the reference training protocol (m1 train.py:44-99):

* epoch loop over the train batcher, batches assembled one ahead on a
  host thread (`data/prefetch.py`);
* a validation step every `val_frequency` train steps via a cycled test
  iterator;
* per-epoch full validation; with `track_accuracy` (the detector) the
  best accuracy keeps a `best_acc` checkpoint (train.py:84-88), which a
  `--continue` resume cannot clobber with a worse one;
* `ckpt_epoch{N}` + `latest` checkpoints each `save_frequency` epochs,
  a mid-epoch `latest` every `save_step_frequency` steps, and an exact
  mid-epoch resume (the batchers' `iter_from`);
* SIGTERM (`GracefulStop`): finish the step, save `latest`, return;
* scalars to `<log_dir>/metrics.jsonl`, and to tensorboardX writers when
  tensorboardX imports.

With `profile_dir`, steps [10, 15) (`PROFILE_STEPS`) run under
`torch.profiler`, whose Chrome trace is written to
`<profile_dir>/trace.json`.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.data.prefetch import prefetch
from sos_tpu_torch.train.checkpoints import CheckpointManager
from sos_tpu_torch.train.state import TrainClock, TrainState
from sos_tpu_torch.utils import StepTimer, cycle

_log = logging.getLogger(__name__)


def _writers(log_dir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None, None
    return (SummaryWriter(os.path.join(log_dir, "train.events")),
            SummaryWriter(os.path.join(log_dir, "val.events")))


def _scalars(metrics: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


class GracefulStop:
    """SIGTERM-aware preemption flag: the signal only sets a flag; fit()
    checks it at step boundaries, saves `latest` and returns cleanly, so
    a preempted run resumes exactly via `--continue`. Installed for the
    duration of fit() only; the previous handler is restored."""

    _NOT_INSTALLED = object()  # distinct from a previous handler of None

    def __init__(self):
        self.requested = False
        self._prev = self._NOT_INSTALLED

    def _handler(self, signum, frame):
        self.requested = True

    def install(self) -> "GracefulStop":
        import signal

        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:  # not the main thread (e.g. under a test runner)
            self._prev = self._NOT_INSTALLED
        return self

    def uninstall(self) -> None:
        import signal

        if self._prev is not self._NOT_INSTALLED:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = self._NOT_INSTALLED


class MetricsLog:
    """Append-only JSONL training log: one line per event,
    {"kind": "train"|"val"|"epoch", "step", "epoch", ...metrics}; append
    mode keeps the history across resumed runs."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._fp = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                        buffering=1)

    def write(self, kind: str, step: int, epoch: int, metrics: Dict) -> None:
        row = {"kind": kind, "step": step, "epoch": epoch}
        row.update(_scalars(metrics))
        self._fp.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._fp.close()


# the train steps [start, stop) that `profile_dir` traces
PROFILE_STEPS = (10, 15)


class StepProfile:
    """A `torch.profiler` trace over PROFILE_STEPS, written as a Chrome
    trace to `<profile_dir>/trace.json`."""

    def __init__(self, profile_dir: Optional[str]):
        self.dir, self._prof = profile_dir, None

    def at(self, step: int) -> None:
        if self.dir and self._prof is None and step == PROFILE_STEPS[0]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and step >= PROFILE_STEPS[1]:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        self._prof = None


def fit(
    cfg: ExperimentConfig,
    state: TrainState,
    clock: TrainClock,
    train_step: Callable,
    eval_step: Callable,
    train_batcher,
    val_batcher,
    model_dir: str,
    log_dir: str,
    track_accuracy: bool = False,
    profile_dir: Optional[str] = None,
) -> TrainState:
    """Train to cfg.train.nr_epochs on the model's device."""
    mgr = CheckpointManager(model_dir)
    train_tb, val_tb = _writers(log_dir)
    jsonl = MetricsLog(log_dir)
    timer = StepTimer()
    # restored on --continue (clock.best_metric persists in the sidecar)
    # so the first post-resume epoch cannot clobber a better best_acc
    # snapshot. On a resume the best_acc sidecar itself is the authority
    # when it is newer than the resumed clock; a fresh run (zero clock)
    # into a reused model_dir does not peek, like the reference's
    # per-run in-memory best (m1 train.py:57,84-88).
    best_metric = clock.best_metric
    if track_accuracy and (clock.step > 0 or clock.epoch > 0):
        best_metric = max(best_metric, mgr.peek_best_metric("best_acc"))

    val_batcher.set_epoch(0)
    has_val = len(val_batcher) > 0
    val_iter = cycle(lambda: iter(val_batcher)) if has_val else None

    start_epoch, start_minibatch = clock.epoch, clock.minibatch
    stop = GracefulStop().install()
    profiler = StepProfile(profile_dir)
    preempted = False
    try:
        for epoch in range(start_epoch, cfg.train.nr_epochs):
            train_batcher.set_epoch(epoch)
            skip = start_minibatch if epoch == start_epoch else 0
            if skip:
                # exact mid-epoch resume: the batch order is epoch-seeded
                # and deterministic, so skipping the completed minibatches
                # continues the run bit for bit
                _log.info("resuming epoch %d at minibatch %d", epoch, skip)
            if skip and hasattr(train_batcher, "iter_from"):
                src = train_batcher.iter_from(skip)
            else:
                src = iter(train_batcher)
                if skip:
                    src = itertools.islice(src, skip, None)
            # close() the prefetcher on EVERY loop exit (SIGTERM break,
            # train_step exception), or its thread would keep assembling
            prefetcher = prefetch(src, depth=2)
            try:
                for batch in prefetcher:
                    profiler.at(clock.step)
                    timer.start()
                    state, metrics = train_step(state, batch)
                    timer.stop()
                    if clock.step % 10 == 0:
                        if train_tb:
                            for k, v in _scalars(metrics).items():
                                train_tb.add_scalar(k, v, global_step=clock.step)
                            train_tb.add_scalar("steps_per_sec",
                                                timer.steps_per_sec,
                                                global_step=clock.step)
                        jsonl.write("train", clock.step, clock.epoch,
                                    dict(metrics,
                                         steps_per_sec=timer.steps_per_sec))
                    if has_val and clock.step % cfg.train.val_frequency == 0:
                        vmetrics = eval_step(state, next(val_iter))
                        if val_tb:
                            for k, v in _scalars(vmetrics).items():
                                val_tb.add_scalar(k, v, global_step=clock.step)
                        jsonl.write("val", clock.step, clock.epoch, vmetrics)
                    clock.tick()
                    if (cfg.train.save_step_frequency and clock.step
                            % cfg.train.save_step_frequency == 0):
                        mgr.save(state, clock, "latest")
                    if stop.requested:
                        # preemption: fall through to the final `latest`
                        # save; the minibatch cursor in the clock resumes
                        # at the NEXT batch of this epoch exactly
                        _log.warning("SIGTERM: stopping at step %d (epoch "
                                     "%d, minibatch %d); saving latest",
                                     clock.step, clock.epoch, clock.minibatch)
                        preempted = True
                        break
            finally:
                prefetcher.close()
            if preempted:
                break
            clock.tock()

            # full validation pass
            val_batcher.set_epoch(epoch)
            agg: Dict[str, list] = {}
            for batch in val_batcher:
                for k, v in _scalars(eval_step(state, batch)).items():
                    agg.setdefault(k, []).append(v)
            epoch_metrics = {k: float(np.mean(v)) for k, v in agg.items()}
            if val_tb:
                for k, v in epoch_metrics.items():
                    val_tb.add_scalar(f"epoch_{k}", v, global_step=epoch)
            # `epoch` (the loop index) matches the train/val rows of this
            # epoch; clock.epoch has already tocked to epoch+1, the
            # ckpt_epoch{N} name the epoch's checkpoint gets
            jsonl.write("epoch", clock.step, epoch,
                        dict(epoch_metrics, ckpt_epoch=clock.epoch))
            if (track_accuracy
                    and epoch_metrics.get("accuracy", -np.inf) > best_metric):
                best_metric = epoch_metrics["accuracy"]
                clock.best_metric = best_metric  # persists with every save
                mgr.save(state, clock, "best_acc")
            if clock.epoch % cfg.train.save_frequency == 0:
                mgr.save_epoch(state, clock)
        # the final 'latest' save runs while the SIGTERM handler is still
        # installed: a repeated signal must not kill the process while it
        # writes the checkpoint the graceful stop exists to save
        mgr.save(state, clock, "latest")
    finally:
        profiler.close()
        stop.uninstall()
        jsonl.close()
        for writer in (train_tb, val_tb):
            if writer is not None:
                writer.close()
    return state
