"""A model the port trains is read by the port's own eval and serving
CLIs, and a reference `.pth` is imported into the same layout; on the
CPU at the tiny widths of tests/torch_port_fixtures.py.

* `train_joint --device cpu` (1 epoch) writes both stages'
  `ckpt_epoch1.pt` and `latest.pt` and its metrics log; then
  `predict_detector --ckpt latest` -> `bridge` -> `predict_denoiser
  --ckpt latest` give 11 finite metrics, and `denoise` and `serve` with
  `--detector_ckpt latest --denoiser_ckpt latest` write finite audio
  (ROADMAP.md queue 3's guard);
* `import_checkpoint` of a synthetic `ckpt_epoch3.pth`: the saved
  state_dict equals `import_detector_checkpoint`'s and the clock is at
  epoch 3; `train_detector --continue --ckpt 3 --epochs 4` then ends at
  epoch 4 in strict JSON;
* `--pth` wins over `--ckpt`; an orbax directory and a missing file are
  usage errors naming the path; `train_joint --continue` is refused, and
  `import_checkpoint --fast_profile` is not ignored: it writes the
  widened import.
"""

import argparse
import io
import json
import math
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sos_tpu_torch.cli import (bridge, common, denoise, import_checkpoint,
                               predict_denoiser, predict_detector, serve,
                               train_detector, train_joint)
from sos_tpu_torch.config import DetectorModelConfig
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.models.torch_import import import_detector_checkpoint
from sos_tpu_torch.train.checkpoints import load_model_state

from tests.torch_oracles import DetectorOracle, randomize_bn_stats
from tests.torch_port_fixtures import SPECS, tiny_configs, training_corpus

METRICS = ("l1", "stoi", "csig", "cbak", "covl", "pesq", "ssnr_regular",
           "ssnr_shift", "ssnr_clip", "ssnr_exsi", "overall_snr")


def _strict(path: Path):
    def refuse(token):
        raise ValueError(f"non-standard JSON token {token}")
    return json.loads(path.read_text(), parse_constant=refuse)


def _main(monkeypatch, module, argv):
    """`module.main()` as `python -m` would run it with `argv`."""
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A corpus and an experiment `tiny` trained jointly for one epoch
    on the CPU."""
    root = tmp_path_factory.mktemp("ckpt_cli")
    ds_json, noise = training_corpus(root, durations=(4.0, 3.0))
    cfg, _ = tiny_configs()
    (root / "cfg.json").write_text(cfg.to_json())
    exp = ["--config_json", str(root / "cfg.json"), "--output_root",
           str(root / "out"), "--name", "tiny", "--device", "cpu"]
    train_joint.main(["--dataset_json", ds_json, "--noise_root", noise,
                      "--batch_size", "2", "--epochs", "1", *exp])
    return {"root": root, "ds_json": ds_json, "noise": noise, "exp": exp}


def _model_dir(trained, stage):
    return trained["root"] / "out" / f"tiny_{stage}" / "model"


def test_train_joint_writes_both_stages(trained):
    for stage in ("detector", "denoiser"):
        model_dir = _model_dir(trained, stage)
        for name in ("ckpt_epoch1", "latest"):
            assert (model_dir / f"{name}.pt").is_file()
            clock = _strict(model_dir / f"{name}.clock.json")
            assert clock["epoch"] == 1 and clock["step"] > 0
        blob = torch.load(model_dir / "latest.pt", weights_only=True)
        assert blob["step"] == clock["step"]
        assert load_model_state(str(model_dir), "latest").keys() == \
            blob["model"].keys()
    log = trained["root"] / "out" / "tiny_detector" / "log" / "metrics.jsonl"
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    train = [r for r in rows if r["kind"] == "train"]
    assert train and all(math.isfinite(r["detector_loss"])
                         and math.isfinite(r["denoiser_loss"])
                         and r["finite"] == 1.0 for r in train)
    assert [r["kind"] for r in rows][-1] == "epoch"


def test_eval_chain_reads_the_port_trained_checkpoints(trained, monkeypatch):
    out = trained["root"] / "eval"
    _main(monkeypatch, predict_detector, [
        "--dataset_json", trained["ds_json"], "--noise_root",
        trained["noise"], "--ckpt", "latest", "--snr_idx", "3",
        "--outputs", str(out / "det"), *trained["exp"]])
    _main(monkeypatch, bridge, ["--input_json",
                                str(out / "det" / "eval_results_snr0.json"),
                                "--snr", "0"])
    _main(monkeypatch, predict_denoiser, [
        "--pred_data", str(out / "det" / "pred_data_snr0.json"),
        "--ckpt", "latest", "--snr", "0", "--outputs", str(out / "den"),
        *trained["exp"]])
    stats = _strict(out / "den" / "eval_results_snr0.json")[
        "denoise_statistics"]
    assert set(stats) == {f"avg_{k}" for k in METRICS}
    assert all(math.isfinite(v) for v in stats.values())


def test_serving_clis_read_the_port_trained_checkpoints(trained,
                                                        monkeypatch,
                                                        capsys):
    root = trained["root"]
    wav = root / "in.wav"
    audio_io.write_wav(str(wav), (np.random.default_rng(5).standard_normal(
        35000) * 0.2).astype(np.float32), 14000)
    ckpts = ["--detector_ckpt", "latest", "--denoiser_ckpt", "latest"]
    _main(monkeypatch, denoise, ["--input", str(wav), "--output",
                                 str(root / "denoised.wav"), *ckpts,
                                 *trained["exp"]])
    out, _ = audio_io.read_wav(str(root / "denoised.wav"))
    assert out.shape == (35000,) and np.isfinite(out).all()

    monkeypatch.setattr(signal, "signal", lambda *a: None)  # keep pytest's
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        f"PING\n{wav}\t{root / 'served.wav'}\nQUIT\n"))
    capsys.readouterr()
    _main(monkeypatch, serve, [*ckpts, *trained["exp"]])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "READY" and lines[1] == "PONG"
    assert lines[2].startswith("OK ") and lines[-1] == "BYE"
    served, _ = audio_io.read_wav(str(root / "served.wav"))
    assert np.isfinite(served).all()


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference-layout detector checkpoint of a seeded oracle, named
    like a released epoch."""
    cfg, _ = tiny_configs()
    torch.manual_seed(1)
    d = cfg.detector
    det = DetectorOracle(SPECS, freq_bins=d.freq_bins, nf=d.nf, outf=d.outf,
                         hidden=d.lstm_hidden, fc_hidden=d.fc_hidden)
    with torch.no_grad():
        randomize_bn_stats(det, torch.Generator().manual_seed(2))
    path = tmp_path_factory.mktemp("pth") / "ckpt_epoch3.pth"
    torch.save({"model_state_dict": det.state_dict(), "clock": {}}, path)
    return path


def test_import_checkpoint_then_continue_training(trained, reference_pth,
                                                  tmp_path, capsys):
    root = trained["root"]
    exp = ["--config_json", str(root / "cfg.json"), "--output_root",
           str(tmp_path), "--name", "imported"]
    import_checkpoint.main(["--stage", "detector", "--pth",
                            str(reference_pth), *exp])
    model_dir = tmp_path / "imported_detector" / "model"
    want = import_detector_checkpoint(str(reference_pth))
    for name in ("ckpt_epoch3", "latest"):
        got = load_model_state(str(model_dir), name)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), name
        assert _strict(model_dir / f"{name}.clock.json")["epoch"] == 3
    capsys.readouterr()
    train_detector.main(["--dataset_json", trained["ds_json"], "--noise_root",
                         trained["noise"], "--batch_size", "2", "--continue",
                         "--ckpt", "3", "--epochs", "4", "--device", "cpu",
                         *exp])
    assert "resumed from ckpt_epoch3 at epoch 3" in capsys.readouterr().out
    clock = _strict(model_dir / "latest.clock.json")
    assert clock["epoch"] == 4 and clock["step"] > 0
    assert (model_dir / "ckpt_epoch4.pt").is_file()


def test_pth_wins_over_ckpt(trained, reference_pth):
    """`--pth` is read even where `--ckpt` names no checkpoint."""
    cfg = common.config_from_args(argparse.Namespace(
        config_json=str(trained["root"] / "cfg.json"), name="tiny",
        output_root=str(trained["root"] / "out")))
    parser = argparse.ArgumentParser()
    got = common.load_stage_state(parser, cfg, "detector", "99",
                                  str(reference_pth))
    want = import_detector_checkpoint(str(reference_pth))
    assert all(torch.equal(got[k], want[k]) for k in want)
    trained_state = common.load_stage_state(parser, cfg, "detector",
                                            "latest")
    assert not all(torch.equal(trained_state[k], want[k]) for k in want)


def _refused(monkeypatch, capsys, module, argv):
    capsys.readouterr()
    with pytest.raises(SystemExit) as exit_info:
        _main(monkeypatch, module, argv)
    assert exit_info.value.code == 2
    return capsys.readouterr().err


@pytest.mark.parametrize("case", ["orbax directory", "missing file"])
def test_unreadable_checkpoints_are_usage_errors(trained, tmp_path,
                                                 monkeypatch, capsys, case):
    exp = ["--config_json", str(trained["root"] / "cfg.json"),
           "--output_root", str(tmp_path), "--name", "tiny", "--device",
           "cpu"]
    model_dir = tmp_path / "tiny_denoiser" / "model"
    if case == "orbax directory":
        (model_dir / "ckpt_epoch7").mkdir(parents=True)
        looked_for = model_dir / "ckpt_epoch7"
    else:
        looked_for = model_dir / "ckpt_epoch7.pt"
    err = _refused(monkeypatch, capsys, predict_denoiser, [
        "--pred_data", "unused.json", "--ckpt", "7", "--snr", "0", *exp])
    assert str(looked_for) in " ".join(err.split())
    assert "--pth" in err
    if case == "orbax directory":
        assert "orbax" in err and "JAX" in err


@pytest.mark.parametrize("module,flags,match", [
    (train_joint, ["--continue"], "never reads"),
    (import_checkpoint, ["--stage", "detector", "--fast_profile"], None),
], ids=["train_joint --continue", "import_checkpoint --fast_profile"])
def test_cli_refuses_flags_it_would_ignore(trained, tmp_path, monkeypatch,
                                           capsys, module, flags, match):
    """A flag the CLI would ignore is a usage error; `--fast_profile` is
    not ignored: a reference-width detector checkpoint is imported at
    `fast_detector_config`'s widths (as sos_tpu's CLI, the stage's config
    is the fast profile's), its trunk widened to 64 channels as
    `import_detector_checkpoint(nf=64)` widens it."""
    argv = list(flags)
    if module is import_checkpoint:
        d = DetectorModelConfig()
        torch.manual_seed(3)
        det = DetectorOracle(tuple(zip(d.kernel_sizes, d.dilations)),
                             freq_bins=d.freq_bins, nf=d.nf, outf=d.outf,
                             hidden=d.lstm_hidden, fc_hidden=d.fc_hidden)
        pth = tmp_path / "ckpt_epoch5.pth"
        torch.save({"model_state_dict": det.state_dict()}, pth)
        _main(monkeypatch, module, argv + [
            "--pth", str(pth), "--output_root", str(tmp_path / "out"),
            "--name", "wide"])
        got = load_model_state(
            str(tmp_path / "out" / "wide_detector" / "model"), "latest")
        want = import_detector_checkpoint(str(pth), nf=64)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert got["conv0.weight"].shape[0] == 64
        return
    if module is train_joint:
        argv += ["--dataset_json", trained["ds_json"], "--noise_root",
                 trained["noise"], "--device", "cpu"]
    err = _refused(monkeypatch, capsys, module,
                   argv + ["--output_root", str(tmp_path / "out")])
    assert match in " ".join(err.split())
    assert not (tmp_path / "out").exists()
