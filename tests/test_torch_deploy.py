"""The port's deployment path against `sos_tpu`, on the CPU.

`calibrate`, `export_serving` + `load_denoise_program`, `doctor`,
`parity_check` and the `python -m sos_tpu_torch` dispatcher, at the tiny
widths of tests/torch_port_fixtures.py, on seeded reference-layout
`.pth` files that both packages import. Bounds:

* calibration scales: the same keys, within rtol 1e-5 (the float
  calibration convs sum in another order; tests/test_torch_quant.py);
* an artifact against the port's eager pipeline on the same device:
  bits equal, waveform within 1e-5; against `sos_tpu`'s artifact on the
  same weights: f32 within 1e-4 with equal bits, int8 within
  tests/test_torch_quant.py's fused bounds (bits equal wherever
  `sos_tpu`'s sigmoid is more than 1e-3 from the threshold, waveform
  within 5e-3);
* `parity_check`: the negative control of
  tests/test_parity_check_control.py, one perturbed tensor -> exit 1.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sos_tpu.config import (DataConfig, DenoiserModelConfig,
                            DetectorModelConfig, ExperimentConfig)
from sos_tpu.dsp import audio_io
from sos_tpu.infer.export import export_denoise_program as jax_export
from sos_tpu.infer.export import load_denoise_program as jax_load
from sos_tpu.models.torch_import import (import_denoiser_checkpoint as
                                         jax_import_denoiser,
                                         import_detector_checkpoint as
                                         jax_import_detector)
from sos_tpu_torch import __main__ as dispatcher
from sos_tpu_torch.cli import calibrate, doctor, export_serving, parity_check
from sos_tpu_torch.config import ExperimentConfig as PortConfig
from sos_tpu_torch.infer.export import (export_denoise_program,
                                        load_denoise_program)
from sos_tpu_torch.infer.fused import FusedDenoisePipeline, wire_encode
from sos_tpu_torch.models.torch_import import (import_denoiser_checkpoint,
                                               import_detector_checkpoint)

from tests.test_model_parity import DILS, KS, SPECS
from tests.torch_oracles import DetectorOracle, JointOracle, randomize_bn_stats
from tests.torch_port_fixtures import make_clips, tiny_configs

SR = 14000
BUDGET = 5e-3  # sos_tpu tests/test_quant.py:100


def _save_pth(path, state_dict, epoch):
    """Reference checkpoint layout (m1 agent.py:62-83)."""
    torch.save({"clock": {"epoch": epoch, "minibatch": 0, "step": 100},
                "model_state_dict": state_dict, "optimizer_state_dict": {},
                "scheduler_state_dict": {}}, path)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Seeded oracles at the tiny widths as `.pth` files (the detector
    head sharpened, so that random weights give mixed bits), the config
    JSON, and a corpus of 4 s and 2.5 s WAVs (four 2 s clips)."""
    cfg, port_cfg = tiny_configs()
    root = tmp_path_factory.mktemp("deploy")
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(100)
    d, n = cfg.detector, cfg.denoiser
    det = DetectorOracle(tuple(zip(d.kernel_sizes, d.dilations)),
                         freq_bins=d.freq_bins, nf=d.nf, outf=d.outf,
                         hidden=d.lstm_hidden, fc_hidden=d.fc_hidden)
    den = JointOracle(tuple(zip(n.kernel_sizes, n.dilations)),
                      freq_bins=n.freq_bins, ch=n.inpaint_ch, nf=n.nf_mixed,
                      hidden=n.lstm_hidden, fc_hidden=n.fc_hidden)
    with torch.no_grad():
        randomize_bn_stats(det, gen)
        randomize_bn_stats(den, gen)
    paths = {"det": str(root / "ckpt_epoch87.pth"),
             "den": str(root / "ckpt_epoch24.pth"),
             "cfg": str(root / "tiny_config.json"),
             "corpus": str(root / "corpus"), "root": root}
    clips = make_clips(3, seed=5)
    # centre the logits on the corpus's median, then sharpen: mixed bits
    _save_pth(paths["det"], det.state_dict(), 87)
    from sos_tpu_torch.dsp.stft import stft
    from sos_tpu_torch.models import SilenceDetector

    probe = SilenceDetector(port_cfg.detector).eval()
    probe.load_state_dict(import_detector_checkpoint(paths["det"]))
    with torch.no_grad():
        logits = probe(stft(torch.from_numpy(clips)), 60)
        det.fc1[2].bias.sub_(float(logits.median()))
        det.fc1[2].weight.mul_(40)
        det.fc1[2].bias.mul_(40)
    _save_pth(paths["det"], det.state_dict(), 87)
    _save_pth(paths["den"], den.state_dict(), 24)
    with open(paths["cfg"], "w") as fp:
        fp.write(cfg.to_json())
    os.makedirs(paths["corpus"])
    audio_io.write_wav(os.path.join(paths["corpus"], "a.wav"),
                       np.concatenate([clips[0], clips[1]]), SR)
    audio_io.write_wav(os.path.join(paths["corpus"], "b.wav"),
                       np.concatenate([clips[2], clips[0][:7000]]), SR)
    return cfg, port_cfg, paths


def _flags(paths, name):
    return ["--config_json", paths["cfg"], "--name", name,
            "--output_root", str(paths["root"] / "model_output"),
            "--detector_pth", paths["det"], "--denoiser_pth", paths["den"]]


def _flat(state):
    den, det = state["denoiser"], state["detector"]
    return np.array(den["enc_x"] + den["enc_n"] + det["conv"]
                    + [den["inpaint"][k] for k in sorted(den["inpaint"])])


@pytest.fixture(scope="module")
def scales(env):
    """One calibrate run in each package on the same `.pth` files and
    corpus: (sos_tpu's scale file, the port's)."""
    _, _, paths = env
    common = ["--input_dir", paths["corpus"], "--batch", "2",
              "--max_clips", "4"]
    ours = str(paths["root"] / "port_scales.json")
    calibrate.main(_flags(paths, "cal") + common
                   + ["--out", ours, "--device", "cpu"])
    from sos_tpu.cli import calibrate as jax_calibrate

    ref = str(paths["root"] / "sos_tpu_scales.json")
    saved = sys.argv
    sys.argv = ["calibrate"] + _flags(paths, "cal") + common + ["--out", ref]
    try:
        jax_calibrate.main()
    finally:
        sys.argv = saved
    return ref, ours


def test_calibrate_cli_matches_sos_tpu(scales):
    ref_path, path = scales
    with open(ref_path) as fp:
        ref = json.load(fp)
    with open(path) as fp:
        got = json.load(fp)
    assert sorted(got) == sorted(ref) == ["denoiser", "detector"]
    assert sorted(got["denoiser"]) == sorted(ref["denoiser"])
    assert sorted(got["denoiser"]["inpaint"]) == sorted(ref["denoiser"]["inpaint"])
    assert sorted(got["detector"]) == sorted(ref["detector"])
    np.testing.assert_allclose(_flat(got), _flat(ref), rtol=1e-5, atol=0)


def test_calibrate_gates_by_the_detector_bits(env):
    """Stage 1 feeds the denoiser the gated spectrum, not the mixed one:
    the detector's bits silence part of each clip."""
    _, port_cfg, paths = env
    from sos_tpu_torch.models import SilenceDetector

    det = SilenceDetector(port_cfg.detector)
    det.load_state_dict(import_detector_checkpoint(paths["det"]))
    clips = calibrate.chunk_corpus(
        sorted(os.path.join(paths["corpus"], f)
               for f in os.listdir(paths["corpus"])), SR, 28000, 4)
    assert clips.shape == (4, 28000)
    pairs = calibrate.calibration_pairs(port_cfg, det.eval(), clips, 2, 2.0,
                                        0.5, torch.device("cpu"))
    assert len(pairs) == 2 and pairs[0][0].shape == (2, 256, 178, 2)
    ratio = [float(g.abs().sum() / m.abs().sum()) for m, g in pairs]
    assert all(0.0 < r < 1.0 for r in ratio), ratio


# -- export ----------------------------------------------------------------


@pytest.fixture(scope="module")
def weights(env):
    _, _, paths = env
    return (import_detector_checkpoint(paths["det"]),
            import_denoiser_checkpoint(paths["den"]),
            jax_import_detector(paths["det"]), jax_import_denoiser(paths["den"]))


@pytest.fixture(scope="module")
def mixed():
    return make_clips(2, seed=9)


@pytest.mark.parametrize("profile,wire", [("f32", "float32"),
                                          ("int8", "float32"),
                                          ("int8", "int16")])
def test_export_round_trip_matches_eager_and_sos_tpu(env, weights, scales,
                                                     mixed, tmp_path,
                                                     profile, wire):
    cfg, port_cfg, _ = env
    det_state, den_state, det_vars, den_vars = weights
    calib = scales[1] if profile == "int8" else None
    path = export_denoise_program(port_cfg, det_state, den_state,
                                  str(tmp_path / "b2.pt"), batch=2,
                                  profile=profile, calibration_path=calib,
                                  wire_dtype=wire, platforms=["cpu"])
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert json.loads(payload["config"]) == json.loads(port_cfg.to_json())
    with open(path + ".json") as fp:
        meta = json.load(fp)
    assert meta == {"batch": 2, "clip_samples": 28000, "sample_rate": SR,
                    "profile": profile, "threshold": 0.5,
                    "platforms": ["cpu"], "wire_dtype": wire}
    serve = load_denoise_program(path, device="cpu")
    x = wire_encode(mixed) if wire == "int16" else mixed
    denoised, bits = serve(torch.from_numpy(x))
    eager = FusedDenoisePipeline(port_cfg, det_state, den_state,
                                 profile=profile, calibration_path=calib,
                                 wire_dtype=wire, device="cpu")
    ref_y, ref_bits = eager(torch.from_numpy(x))
    assert torch.equal(bits, ref_bits)
    assert denoised.dtype == ref_y.dtype
    np.testing.assert_allclose(denoised.float().numpy(),
                               ref_y.float().numpy(), atol=1e-5, rtol=0)
    assert 0 < ref_bits.sum() < ref_bits.numel()
    if wire == "int16":
        with pytest.raises(ValueError, match="int16"):
            serve(torch.from_numpy(mixed))
        return
    jpath = jax_export(cfg, det_vars, den_vars, str(tmp_path / "b2.jaxprog"),
                       batch=2, profile=profile, calibration_path=calib,
                       platforms=("cpu",))
    with open(jpath + ".json") as fp:
        jmeta = json.load(fp)
    assert sorted(jmeta) == sorted(meta)
    j_y, j_bits = (np.asarray(a) for a in jax_load(jpath)(jnp.asarray(mixed)))
    if profile == "f32":
        np.testing.assert_array_equal(bits.numpy(), j_bits)
        np.testing.assert_allclose(denoised.numpy(), j_y, atol=1e-4)
        return
    from sos_tpu.infer.fused import FusedDenoisePipeline as JaxPipeline
    from sos_tpu.dsp.stft import stft as jstft
    jpipe = JaxPipeline(cfg, det_vars, den_vars, profile="int8",
                        calibration_path=calib)
    assert jpipe.ensure_calibrated()
    spec = jstft(jnp.asarray(mixed), 510, 158, 400)
    prob = jax.nn.sigmoid(jpipe._quant_det(spec, num_frames=60))
    clear = np.abs(np.asarray(prob) - 0.5) > 1e-3
    np.testing.assert_array_equal(bits.numpy()[clear], j_bits[clear])
    if not np.array_equal(bits.numpy(), j_bits):
        denoised = eager.denoise_with_bits(torch.from_numpy(mixed), j_bits)
    assert float(np.abs(denoised.numpy() - j_y).max()) <= BUDGET


def test_export_cli_writes_and_refuses(env, scales, tmp_path, capsys):
    _, port_cfg, paths = env
    out = str(tmp_path / "int8_b2.pt")
    export_serving.main(_flags(paths, "exp") + [
        "--output", out, "--batch", "2", "--profile", "int8",
        "--calibration_json", scales[1], "--platforms", "cpu"])
    assert "exported" in capsys.readouterr().out
    payload = torch.load(out, map_location="cpu", weights_only=True)
    assert json.loads(payload["calibration"]) == json.load(open(scales[1]))
    with pytest.raises(SystemExit) as exc:
        export_serving.main(_flags(paths, "exp") + [
            "--output", str(tmp_path / "x.pt"), "--platforms", "tpu", "cpu"])
    assert exc.value.code == 2
    assert "JAX package" in capsys.readouterr().err
    # an int8 export without scales: the default scale file is absent
    with pytest.raises(ValueError, match="int8_calibration.json"):
        export_serving.main(_flags(paths, "noscales") + [
            "--output", str(tmp_path / "y.pt"), "--profile", "int8"])
    det_state, den_state = (import_detector_checkpoint(paths["det"]),
                            import_denoiser_checkpoint(paths["den"]))
    with pytest.raises(ValueError, match="calibration JSON"):
        export_denoise_program(port_cfg, det_state, den_state,
                               str(tmp_path / "z.pt"), batch=2,
                               profile="int8")
    with pytest.raises(ValueError, match="not cuda"):
        load_denoise_program(out, device="cuda")


# -- doctor, dispatcher ------------------------------------------------------


def _doctor(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        doctor.main(argv)
    return exc.value.code, json.loads(capsys.readouterr().out)


def test_doctor_json_on_the_cpu(tmp_path, capsys):
    code, report = _doctor(["--device", "cpu", "--json"], capsys)
    checks = {c["name"]: c["status"] for c in report["checks"]}
    assert code == 0 and report["ok"]
    assert list(checks) == ["accelerator", "compile-cache", "native-engine",
                            "media-tools", "pesq-backend"]
    assert "FAIL" not in checks.values()
    assert checks["accelerator"] == "warn"  # the plain path on the CPU
    assert checks["native-engine"] == "ok"  # g++ builds the engine here
    # an experiment with the port's checkpoint layout, then a missing one
    for stage in ("detector", "denoiser"):
        model = tmp_path / f"exp_{stage}" / "model"
        model.mkdir(parents=True)
        (model / "latest.pt").write_bytes(b"")
    (tmp_path / "exp_denoiser" / "model" / "int8_calibration.json").write_text("{}")
    code, report = _doctor(["--device", "cpu", "--json", "--output_root",
                            str(tmp_path), "--name", "exp"], capsys)
    assert code == 0
    assert {c["name"]: c["status"] for c in report["checks"]}[
        "experiment/int8-calibration"] == "ok"
    code, report = _doctor(["--device", "cpu", "--json", "--output_root",
                            str(tmp_path), "--name", "missing"], capsys)
    assert code == 1 and not report["ok"]
    assert [c["name"] for c in report["checks"] if c["status"] == "FAIL"] == [
        "experiment/detector", "experiment/denoiser"]


def test_dispatcher_help_and_commands(capsys):
    from sos_tpu import __main__ as jax_dispatcher

    assert dispatcher.COMMANDS == jax_dispatcher.COMMANDS
    for name in dispatcher.COMMANDS:
        assert os.path.exists(os.path.join(
            os.path.dirname(dispatcher.__file__), "cli", f"{name}.py"))
    out = subprocess.run(
        [sys.executable, "-c", "import sys; from sos_tpu_torch import "
         "__main__ as m; rc = m.main(['--help']); "
         "print(sorted(k for k in sys.modules if k.startswith("
         "'sos_tpu_torch.cli'))); sys.exit(rc)"],
        capture_output=True, text=True, check=True)
    assert out.stdout.splitlines()[-1] == "[]"  # no CLI module imported
    for name in dispatcher.COMMANDS:
        assert f"  {name:<18} {dispatcher._summary(name)}" in out.stdout
        assert dispatcher._summary(name)
    assert dispatcher.main([]) == 2
    assert dispatcher.main(["no_such_command"]) == 2
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        dispatcher.main(["doctor", "--device", "cpu", "--json"])
    assert exc.value.code == 0
    assert json.loads(capsys.readouterr().out)["ok"]


# -- parity_check ------------------------------------------------------------


def test_parity_check_fails_on_perturbed_checkpoint(tmp_path, capsys):
    """tests/test_parity_check_control.py on the port: its own output as
    manifest passes; one perturbed tensor (the mask head's output bias)
    moves avg_pesq/avg_stoi past 0.01 and exits 1."""
    root = str(tmp_path)
    torch.manual_seed(21)
    det = DetectorOracle(SPECS, freq_bins=256, nf=8, outf=4, hidden=8,
                         fc_hidden=8)
    den = JointOracle(SPECS, freq_bins=256, ch=(8, 12, 16), nf=8, hidden=8,
                      fc_hidden=16)
    gen = torch.Generator().manual_seed(22)
    with torch.no_grad():
        randomize_bn_stats(det, gen)
        randomize_bn_stats(den, gen)
    det_pth, den_pth = (os.path.join(root, "ckpt_det.pth"),
                        os.path.join(root, "ckpt_den.pth"))
    _save_pth(det_pth, det.state_dict(), 87)
    _save_pth(den_pth, den.state_dict(), 24)
    rng = np.random.default_rng(3)
    for sub in ("clips", "noise"):
        os.makedirs(os.path.join(root, sub))
    for i in range(2):
        y = np.zeros(2 * SR, np.float32)
        for s in range(0, 2 * SR, SR // 2):
            y[s:s + SR // 4] = rng.standard_normal(SR // 4) * 0.3
        audio_io.write_wav(os.path.join(root, "clips", f"c{i}.wav"), y, SR)
        audio_io.write_wav(os.path.join(root, "noise", f"n{i}.wav"),
                           rng.standard_normal(3 * SR).astype(np.float32)
                           * 0.2, SR)
    cfg = ExperimentConfig(
        detector=DetectorModelConfig(nf=8, outf=4, kernel_sizes=KS,
                                     dilations=DILS, lstm_hidden=8,
                                     fc_hidden=8),
        denoiser=DenoiserModelConfig(nf_mixed=8, nf_noise=4, outf_mixed=8,
                                     outf_noise=4, kernel_sizes=KS,
                                     dilations=DILS, lstm_hidden=8,
                                     fc_hidden=16, inpaint_ch=(8, 12, 16)),
        data=DataConfig())
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as fp:
        fp.write(PortConfig.from_json(cfg.to_json()).to_json())
    from sos_tpu.cli import preprocess

    ds = os.path.join(root, "ds.json")
    saved = sys.argv
    sys.argv = ["prog", "--audio_dir", os.path.join(root, "clips"),
                "--output_json", ds, "--label_silence"]
    try:
        preprocess.main()
    finally:
        sys.argv = saved

    def run(den_path, extra):
        parity_check.main([
            "--detector_pth", det_pth, "--denoiser_pth", den_path,
            "--dataset_json", ds, "--noise_root", os.path.join(root, "noise"),
            "--output_root", os.path.join(root, "model_output"),
            "--config_json", cfg_path, "--name", "parity_ctl",
            "--outputs", os.path.join(root, "parity_out"), "--snr_idx", "3",
            "--device", "cpu"] + extra)

    run(den_pth, [])
    manifest = os.path.join(root, "parity_out", "eval_results_snr0.json")
    stats = json.load(open(manifest))["denoise_statistics"]
    assert all(np.isfinite(float(v)) for v in stats.values())
    kept = os.path.join(root, "manifest.json")
    with open(kept, "w") as fp:
        json.dump(json.load(open(manifest)), fp)
    run(den_pth, ["--manifest", kept])
    assert "PARITY OK" in capsys.readouterr().out

    state = torch.load(den_pth, weights_only=False)
    key = "stage2.fc.4.bias"
    state["model_state_dict"][key] = state["model_state_dict"][key] + 4.0
    den_bad = os.path.join(root, "ckpt_den_bad.pth")
    torch.save(state, den_bad)
    report_path = os.path.join(root, "report.json")
    with pytest.raises(SystemExit) as exc:
        run(den_bad, ["--manifest", manifest, "--out", report_path])
    assert exc.value.code == 1
    assert "PARITY FAIL" in capsys.readouterr().err
    with open(report_path) as fp:
        report = json.load(fp)
    assert report["pass"] is False
    assert max(abs(report["delta"]["avg_pesq"]),
               abs(report["delta"]["avg_stoi"])) > 0.01, report["delta"]
