"""The port's checkpoints, `fit()` and train CLIs on the CPU at tiny
widths: a checkpoint round trip, the exact mid-epoch resume, SIGTERM's
resumable `latest`, `best_acc` kept across a resume, the strict-JSON
clock sidecar, and both train CLIs as `--device cpu` subprocesses on a
tiny WAV corpus."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.data import (DatasetIndex, DetectorBatcher, NoiseBank,
                                detector_windows)
from sos_tpu_torch.train import loop
from sos_tpu_torch.train.checkpoints import CheckpointManager
from sos_tpu_torch.train.fit import fit
from sos_tpu_torch.train.state import TrainClock

from tests.torch_port_fixtures import tiny_configs, training_corpus

REPO = Path(__file__).resolve().parents[1]


def _strict(text: str):
    def refuse(token):
        raise ValueError(f"non-standard JSON token {token}")
    return json.loads(text, parse_constant=refuse)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return training_corpus(tmp_path_factory.mktemp("fit"))


def _cfg(**train) -> ExperimentConfig:
    _, pcfg = tiny_configs()
    train = {"nr_epochs": 1, "batch_size": 2, "val_frequency": 2, **train}
    return dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train,
                                                               **train))


def _batchers(cfg, corpus):
    ds_json, noise_dir = corpus
    windows = detector_windows(DatasetIndex.load(ds_json).files,
                               cfg.data.clip_frames)
    noise = NoiseBank.from_roots([noise_dir], cfg.data.sample_rate)
    return (DetectorBatcher(windows, noise, cfg.data, 2, True, cfg.train.seed),
            DetectorBatcher(windows[:4], noise, cfg.data, 2, False, 1))


def _run(cfg, corpus, root, clock=None, state=None, wrap=None, name="run"):
    train_b, val_b = _batchers(cfg, corpus)
    if state is None:
        _, state = loop.init_detector_state(cfg, device="cpu")
    step = loop.make_detector_train_step(cfg, max(1, len(train_b)))
    if wrap is not None:
        step = wrap(step)
    return fit(cfg, state, clock or TrainClock(), step,
               loop.make_detector_eval_step(cfg), train_b, val_b,
               str(root / name / "model"), str(root / name / "log"),
               track_accuracy=True)


def test_checkpoint_round_trip(tmp_path):
    cfg = _cfg()
    _, state = loop.init_detector_state(cfg, device="cpu")
    batch = next(iter(_batchers(cfg, training_corpus(tmp_path / "c"))[0]))
    loop.make_detector_train_step(cfg, 4)(state, batch)
    mgr = CheckpointManager(str(tmp_path / "model"))
    clock = TrainClock(epoch=2, minibatch=3, step=11, best_metric=0.75)
    mgr.save(state, clock, "ckpt_epoch2")
    assert mgr.exists("ckpt_epoch2") and not mgr.exists("latest")
    _, fresh = loop.init_detector_state(cfg, device="cpu")
    fresh, got = mgr.load_epoch(2, fresh)
    assert got == clock and fresh.step == state.step == 1
    for name, value in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], value), name
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for k, v in a["state"].items():
        for kk, vv in v.items():
            assert torch.equal(torch.as_tensor(b["state"][k][kk]),
                               torch.as_tensor(vv))
    assert mgr.peek_best_metric("ckpt_epoch2") == 0.75
    assert mgr.peek_best_metric("absent") == float("-inf")


def test_clock_sidecar_is_strict_json(tmp_path):
    cfg = _cfg()
    _, state = loop.init_detector_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, TrainClock(), "latest")
    text = (tmp_path / "latest.clock.json").read_text()
    assert "best_metric" not in _strict(text)  # -inf is omitted
    assert TrainClock.from_dict(_strict(text)).best_metric == float("-inf")
    assert not list(tmp_path.glob("*.tmp"))


def test_midepoch_resume_is_exact(tmp_path, corpus):
    """An epoch stopped after 2 steps by SIGTERM (which saves a resumable
    `latest`) and resumed with `--continue` ends bit-identical to the
    same epoch run through."""
    cfg = _cfg(save_step_frequency=1)
    whole = _run(cfg, corpus, tmp_path, name="whole")

    def stop_after_two(step):
        calls = []

        def wrapped(state, batch):
            out = step(state, batch)
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped
    _run(cfg, corpus, tmp_path, wrap=stop_after_two, name="cut")
    mgr = CheckpointManager(str(tmp_path / "cut" / "model"))
    clock = TrainClock.from_dict(_strict(
        (tmp_path / "cut" / "model" / "latest.clock.json").read_text()))
    assert (clock.epoch, clock.minibatch, clock.step) == (0, 2, 2)
    assert not mgr.exists("ckpt_epoch1")  # the epoch did not finish

    _, state = loop.init_detector_state(cfg, device="cpu")
    state, clock = mgr.load("latest", state)
    assert state.step == 2
    resumed = _run(cfg, corpus, tmp_path, clock=clock, state=state,
                   name="cut")
    assert resumed.step == whole.step
    for name, value in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name
    assert loop.adam_count(resumed.optimizer) == loop.adam_count(whole.optimizer)
    done = TrainClock.from_dict(_strict(
        (tmp_path / "cut" / "model" / "latest.clock.json").read_text()))
    assert (done.epoch, done.minibatch) == (1, 0)
    rows = [json.loads(line) for line in
            (tmp_path / "cut" / "log" / "metrics.jsonl").read_text().splitlines()]
    assert {r["kind"] for r in rows} >= {"train", "val", "epoch"}


def test_best_acc_survives_a_resume(tmp_path, corpus):
    """A resume whose epochs score below the best_acc snapshot's metric
    leaves that snapshot alone, even when the resumed clock holds no
    best (the sidecar of best_acc is the authority)."""
    cfg = _cfg(nr_epochs=1)
    _run(cfg, corpus, tmp_path)
    model_dir = tmp_path / "run" / "model"
    best = model_dir / "best_acc.clock.json"
    assert np.isfinite(_strict(best.read_text())["best_metric"])
    data = _strict(best.read_text())
    data["best_metric"] = 1.5  # no accuracy reaches it
    best.write_text(json.dumps(data))
    before = (model_dir / "best_acc.pt").read_bytes()

    cfg2 = _cfg(nr_epochs=2)
    _, state = loop.init_detector_state(cfg2, device="cpu")
    state, clock = CheckpointManager(str(model_dir)).load("latest", state)
    clock.best_metric = float("-inf")
    _run(cfg2, corpus, tmp_path, clock=clock, state=state)
    assert (model_dir / "best_acc.pt").read_bytes() == before
    assert _strict(best.read_text())["best_metric"] == 1.5
    assert (model_dir / "ckpt_epoch2.pt").exists()


def _cli(stage, corpus, root, *extra):
    ds_json, noise_dir = corpus
    cfg, _ = tiny_configs()
    cfg_json = root / "cfg.json"
    cfg_json.write_text(cfg.to_json())
    cmd = [sys.executable, "-m", f"sos_tpu_torch.cli.train_{stage}",
           "--device", "cpu", "--dataset_json", ds_json, "--noise_root",
           noise_dir, "--config_json", str(cfg_json), "--output_root",
           str(root / "out"), "--name", "tiny", "--batch_size", "2",
           "--save_step_frequency", "1", *extra]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_train_cli_trains_and_resumes_on_cpu(tmp_path, corpus, stage):
    first = _cli(stage, corpus, tmp_path, "--epochs", "1")
    assert first.returncode == 0, first.stderr[-3000:]
    model_dir = tmp_path / "out" / f"tiny_{stage}" / "model"
    clock1 = _strict((model_dir / "latest.clock.json").read_text())
    assert clock1["epoch"] == 1 and clock1["step"] > 0
    assert (model_dir / "ckpt_epoch1.pt").exists()
    second = _cli(stage, corpus, tmp_path, "--epochs", "2", "--continue",
                  "--ckpt", "latest")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from latest at epoch 1" in second.stdout
    clock2 = _strict((model_dir / "latest.clock.json").read_text())
    assert clock2["epoch"] == 2 and clock2["step"] == 2 * clock1["step"]
    log = (tmp_path / "out" / f"tiny_{stage}" / "log" / "metrics.jsonl")
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    train = [r for r in rows if r["kind"] == "train"]
    assert train and all(np.isfinite(r["loss"]) and r["finite"] == 1.0
                         for r in train)


# bfloat16 training, once refused here, is a case of its own below (ids
# kept as they were). The multi-process flags, refused before the port
# trained data-parallel, now train (tests/test_torch_parallel.py); here
# they refuse what cannot run: --distributed with no torchrun
# environment to join, a coordinator without the group's size and this
# process's index, and 4 processes for a global batch of 15.
@pytest.mark.parametrize("flags,match,error", [
    pytest.param(["--distributed"], "torchrun environment", RuntimeError,
                 id="flags1-multi-process"),
    pytest.param(["--coordinator", "localhost:1234"], "--num_processes",
                 SystemExit, id="flags2-multi-process"),
    pytest.param(["--num_devices", "4"], "must divide the global batch 15",
                 ValueError, id="flags3-data-parallel"),
])
def test_train_cli_refuses_what_a_later_slice_brings(tmp_path, corpus, flags,
                                                      match, error, capsys,
                                                      monkeypatch):
    from sos_tpu_torch.cli import train_detector

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    ds_json, noise_dir = corpus
    with pytest.raises(error) as exit_info:
        train_detector.main(["--device", "cpu", "--dataset_json", ds_json,
                             "--noise_root", noise_dir, "--output_root",
                             str(tmp_path / "out"), *flags])
    if error is SystemExit:
        assert exit_info.value.code == 2
        assert match in capsys.readouterr().err
    else:
        assert match in str(exit_info.value)
    assert not (tmp_path / "out").exists()


def test_train_cli_trains_bfloat16_without_remat(tmp_path, corpus):
    """`--compute_dtype bfloat16 --no_remat` (a usage error before the
    port trained in bf16): the detector CLI trains an epoch with finite
    steps and saves float32 weights."""
    run = _cli("detector", corpus, tmp_path, "--epochs", "1",
               "--compute_dtype", "bfloat16", "--no_remat")
    assert run.returncode == 0, run.stderr[-3000:]
    model_dir = tmp_path / "out" / "tiny_detector" / "model"
    blob = torch.load(model_dir / "latest.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in blob["model"].values()
               if v.is_floating_point())
    log = tmp_path / "out" / "tiny_detector" / "log" / "metrics.jsonl"
    train = [json.loads(line) for line in log.read_text().splitlines()
             if json.loads(line)["kind"] == "train"]
    assert train and all(np.isfinite(r["loss"]) and r["finite"] == 1.0
                         for r in train)
