"""The port's eval chain (`sos_tpu_torch.infer.evaluate` and the CLIs
`predict_detector` -> `bridge` -> `predict_denoiser`) against
`sos_tpu`'s, on the CPU.

A tiny dataset JSON (utterances of 2.0, 3.1 and 7.2 s: the last past the
dense mask's 6.3 s) and a noise bank of seeded WAVs go through
`evaluate_detector` -> `create_data_from_prediction` ->
`evaluate_denoiser` in both packages, batched-bucketed and per item,
with weights from the same reference-layout `.pth` files (seeded torch
oracles; random weights put every confidence near one value, so the
detector's last layer is rescaled about the median logit of a first
pass, and the threshold is put in the widest gap of the middle half of
the confidences, which splits the frames about in half).

Checked: the JSON keys and the file layout are equal; bits, `match`,
`prediction_statistics`, noise and recovered WAVs are equal; detector
confidences within 5e-5; the 11 `denoise_statistics` finite and within
atol 1e-3 + rtol 1e-3 of `sos_tpu`'s (the waveforms agree to 1e-4, and
the metrics run on 16 kHz resamples of them). The CLIs run once in a
`--device cpu` subprocess and must write what the in-process chain
writes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sos_tpu.data import NoiseBank as JaxNoiseBank
from sos_tpu.dsp import audio_io as jax_audio_io
from sos_tpu.infer import evaluate as jax_evaluate
from sos_tpu.infer.denoise import DenoiserPredictor as JaxDenoiserPredictor
from sos_tpu.infer.detect import DetectorPredictor as JaxDetectorPredictor
from sos_tpu.models.torch_import import (
    import_denoiser_checkpoint as jax_import_denoiser,
    import_detector_checkpoint as jax_import_detector)
from sos_tpu_torch.data import NoiseBank
from sos_tpu_torch.infer import evaluate
from sos_tpu_torch.infer.denoise import DenoiserPredictor
from sos_tpu_torch.infer.detect import DetectorPredictor
from sos_tpu_torch.models.torch_import import (import_denoiser_checkpoint,
                                               import_detector_checkpoint)

from tests.torch_oracles import DetectorOracle, JointOracle, randomize_bn_stats
from tests.torch_port_fixtures import SPECS, tiny_configs

REPO = Path(__file__).resolve().parent.parent
SR = 14000
DURATIONS = (2.0, 3.1, 7.2)
BUCKETS = (256, 1024)
SNR_IDX = 3  # 0 dB
METRICS = ("l1", "stoi", "csig", "cbak", "covl", "pesq", "ssnr_regular",
           "ssnr_shift", "ssnr_clip", "ssnr_exsi", "overall_snr")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    rng = np.random.default_rng(31)
    files = []
    (root / "clips").mkdir()
    for i, dur in enumerate(DURATIONS):
        n = int(dur * SR)
        y = np.zeros(n, np.float32)
        for s in range(0, n, SR):  # 0.5 s bursts, 0.5 s of silence
            y[s:s + SR // 2] = rng.standard_normal(
                min(SR // 2, n - s)).astype(np.float32) * 0.3
        path = str(root / "clips" / f"c{i}.wav")
        jax_audio_io.write_wav(path, y, SR)
        frames = int(dur * 30)
        files.append({
            "path": path, "audio_path": path, "framerate": 30,
            "audio_sample_rate": SR, "audio_samples": n, "duration": dur,
            "num_frames": frames, "bit_stream": "".join(
                "1" if (j // 15) % 2 == 0 else "0" for j in range(frames))})
    ds_json = root / "ds.json"
    ds_json.write_text(json.dumps({"dataset_path": str(root / "clips"),
                                   "num_videos": len(files),
                                   "files": files}))
    (root / "noise").mkdir()
    noises = [(rng.standard_normal(SR * 5) * 0.2).astype(np.float32)
              for _ in range(2)]
    for i, y in enumerate(noises):
        jax_audio_io.write_wav(str(root / "noise" / f"n{i}.wav"), y, SR)

    cfg, port_cfg = tiny_configs()
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(100)
    d, n = cfg.detector, cfg.denoiser
    det = DetectorOracle(SPECS, freq_bins=d.freq_bins, nf=d.nf, outf=d.outf,
                         hidden=d.lstm_hidden, fc_hidden=d.fc_hidden)
    den = JointOracle(SPECS, freq_bins=n.freq_bins, ch=n.inpaint_ch,
                      nf=n.nf_mixed, hidden=n.lstm_hidden,
                      fc_hidden=n.fc_hidden)
    with torch.no_grad():
        randomize_bn_stats(det, gen)
        randomize_bn_stats(den, gen)
    torch.save({"model_state_dict": det.state_dict()}, root / "det.pth")
    torch.save({"model_state_dict": den.state_dict()}, root / "den.pth")
    (root / "cfg.json").write_text(cfg.to_json())
    corpus = {"root": root, "ds_json": str(ds_json), "cfg": cfg,
              "port_cfg": port_cfg, "threshold": 0.5}
    conf = _probe(corpus, "probe0")
    median = float(np.log(np.median(conf) / (1 - np.median(conf))))
    with torch.no_grad():  # logit -> 40 (logit - median)
        last = det.fc1[2]
        last.weight.mul_(40)
        last.bias.sub_(median).mul_(40)
    torch.save({"model_state_dict": det.state_dict()}, root / "det.pth")
    conf = _probe(corpus, "probe1")
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(conf[lo + 1:hi + 1] - conf[lo:hi]))
    corpus["threshold"] = float((conf[k] + conf[k + 1]) / 2)
    corpus["margin"] = float(conf[k + 1] - conf[k]) / 2
    return corpus


def _probe(corpus, name: str) -> np.ndarray:
    """The port's sorted detector confidences over the corpus."""
    run = _chain(corpus, "port", name, stages=1)
    return np.sort(np.concatenate([
        np.float64(r["confidence"])
        for r in _load(run, "det/eval_results_snr0.json")["data"]]))


def _chain(corpus, package: str, mode: str, stages: int = 3) -> Path:
    """The three stages in one package; returns the run's directory."""
    root = corpus["root"]
    out = root / f"{package}_{mode}"
    buckets = BUCKETS if mode == "batched" else None
    batch = 2 if mode == "batched" else None
    if package == "jax":
        cfg, ev = corpus["cfg"], jax_evaluate
        det = JaxDetectorPredictor(cfg, jax_import_detector(str(root / "det.pth")),
                                   buckets=buckets)
        den = JaxDenoiserPredictor(cfg, jax_import_denoiser(str(root / "den.pth")),
                                   buckets=buckets)
        bank = JaxNoiseBank.from_roots([str(root / "noise")], SR)
    else:
        cfg, ev = corpus["port_cfg"], evaluate
        det = DetectorPredictor(cfg, import_detector_checkpoint(str(root / "det.pth")),
                                buckets=buckets, device="cpu")
        den = DenoiserPredictor(cfg, import_denoiser_checkpoint(str(root / "den.pth")),
                                buckets=buckets, device="cpu")
        bank = NoiseBank.from_roots([str(root / "noise")], SR)
    snr = cfg.data.snrs[SNR_IDX]
    det.threshold = corpus["threshold"]
    res = ev.evaluate_detector(cfg, det, corpus["ds_json"], str(out / "det"),
                               noise_bank=bank, snr_idx=SNR_IDX,
                               batch_size=batch)
    if stages == 1:
        return out
    pred = ev.create_data_from_prediction(cfg, res, noise_snr=snr)
    ev.evaluate_denoiser(cfg, den, pred, str(out / "den"), snr=snr,
                         batch_size=batch)
    return out


@pytest.fixture(scope="module")
def runs(corpus):
    return {(p, m): _chain(corpus, p, m)
            for p in ("jax", "port") for m in ("batched", "item")}


def _files(run: Path):
    return sorted(str(p.relative_to(run)) for p in run.rglob("*")
                  if p.is_file())


def _load(run: Path, rel: str):
    return json.loads((run / rel).read_text())


def _keys(obj):
    """The nested key structure of a JSON value."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return None


def _strip(obj, run: Path):
    """Paths made relative to the run's directory."""
    return json.loads(json.dumps(obj).replace(str(run), "<run>"))


@pytest.mark.parametrize("mode", ["batched", "item"])
def test_chain_writes_sos_tpus_layout_and_schema(runs, mode):
    jax_run, port_run = runs[("jax", mode)], runs[("port", mode)]
    assert _files(port_run) == _files(jax_run)
    for rel in _files(jax_run):
        if rel.endswith(".json"):
            assert _keys(_load(port_run, rel)) == _keys(_load(jax_run, rel)), rel


@pytest.mark.parametrize("mode", ["batched", "item"])
def test_detector_eval_matches_sos_tpu(corpus, runs, mode):
    # no frame within the detector's 5e-5 tolerance of the threshold
    assert corpus["margin"] > 5e-5
    rel = "det/eval_results_snr0.json"
    got, ref = _load(runs[("port", mode)], rel), _load(runs[("jax", mode)], rel)
    assert got["prediction_statistics"] == ref["prediction_statistics"]
    by_id = {r["id"]: r for r in got["data"]}
    assert len(by_id) == len(DURATIONS)
    for r in ref["data"]:
        g = by_id[r["id"]]
        for key in ("path", "label", "pred_label", "match", "full_bit_stream"):
            assert g[key] == r[key], key
        np.testing.assert_allclose(np.float64(g["confidence"]),
                                   np.float64(r["confidence"]), atol=5e-5)
    pred = [b for r in ref["data"] for b in r["pred_label"]]
    assert 0.2 < pred.count("1") / len(pred) < 0.8
    for rel in _files(runs[("jax", mode)]):
        if rel.startswith("det/") and rel.endswith(".wav"):  # noise, recovered
            assert ((runs[("port", mode)] / rel).read_bytes()
                    == (runs[("jax", mode)] / rel).read_bytes()), rel


@pytest.mark.parametrize("mode", ["batched", "item"])
def test_bridge_matches_sos_tpu(runs, mode):
    rel = "det/pred_data_snr0.json"
    jax_run, port_run = runs[("jax", mode)], runs[("port", mode)]
    assert (_strip(_load(port_run, rel), port_run)
            == _strip(_load(jax_run, rel), jax_run))


@pytest.mark.parametrize("mode", ["batched", "item"])
def test_denoiser_eval_matches_sos_tpu(runs, mode):
    rel = "den/eval_results_snr0.json"
    jax_run, port_run = runs[("jax", mode)], runs[("port", mode)]
    got, ref = _load(port_run, rel), _load(jax_run, rel)
    stats, ref_stats = got["denoise_statistics"], ref["denoise_statistics"]
    assert list(stats) == [f"avg_{k}" for k in METRICS]
    for key, value in stats.items():
        assert np.isfinite(value), key
        np.testing.assert_allclose(value, ref_stats[key], atol=1e-3,
                                   rtol=1e-3, err_msg=key)
    for g, r in zip(got["files"], ref["files"]):
        assert g["bitstream"] == r["bitstream"]
        for key in METRICS:
            np.testing.assert_allclose(g[key], r[key], atol=1e-3, rtol=1e-3,
                                       err_msg=key)
    wav = "den/snr0/c2/denoised_output.wav"  # the 7.2 s utterance
    got_y = jax_audio_io.load(str(port_run / wav), sr=SR)[0]
    ref_y = jax_audio_io.load(str(jax_run / wav), sr=SR)[0]
    assert len(got_y) == len(ref_y) == int(7.2 * SR) // 158 * 158
    np.testing.assert_allclose(got_y, ref_y, atol=2e-4)


def test_batched_equals_per_item_in_the_port(runs):
    a, b = runs[("port", "batched")], runs[("port", "item")]
    det = "det/eval_results_snr0.json"
    assert (_load(a, det)["prediction_statistics"]
            == _load(b, det)["prediction_statistics"])
    den = "den/eval_results_snr0.json"
    for key, value in _load(a, den)["denoise_statistics"].items():
        np.testing.assert_allclose(value, _load(b, den)["denoise_statistics"][key],
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_clis_on_pth_files_write_the_in_process_results(corpus, runs):
    """predict_detector -> bridge -> predict_denoiser as subprocesses
    with --device cpu on the .pth files write what the in-process
    batched chain wrote."""
    root = corpus["root"]
    out = root / "cli_run"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    common = ["--config_json", str(root / "cfg.json"), "--output_root",
              str(root / "model_output"), "--name", "tiny", "--device", "cpu",
              "--buckets", *map(str, BUCKETS), "--eval_batch_size", "2"]

    def run(module, *args):
        subprocess.run([sys.executable, "-m", f"sos_tpu_torch.cli.{module}",
                        *args], cwd=REPO, env=env, check=True, timeout=240,
                       capture_output=True, text=True)

    run("predict_detector", "--dataset_json", corpus["ds_json"],
        "--pth", str(root / "det.pth"), "--noise_root", str(root / "noise"),
        "--snr_idx", str(SNR_IDX), "--outputs", str(out / "det"),
        "--threshold", repr(corpus["threshold"]), *common)
    run("bridge", "--input_json", str(out / "det" / "eval_results_snr0.json"),
        "--snr", "0")
    run("predict_denoiser", "--pred_data",
        str(out / "det" / "pred_data_snr0.json"), "--pth",
        str(root / "den.pth"), "--snr", "0", "--outputs", str(out / "den"),
        *common)
    ref = runs[("port", "batched")]
    assert _files(out) == _files(ref)
    for rel in ("det/eval_results_snr0.json", "det/pred_data_snr0.json"):
        assert _strip(_load(out, rel), out) == _strip(_load(ref, rel), ref)
    got = _load(out, "den/eval_results_snr0.json")["denoise_statistics"]
    assert got == _load(ref, "den/eval_results_snr0.json")["denoise_statistics"]


def test_predict_clis_refuse_a_ckpt_without_pth(corpus):
    """`--ckpt latest` without `--pth` reads the experiment's
    `latest.pt`, which the port's train CLIs write; where there is none
    it is a usage error naming the path it looked for (once a refusal of
    every `--ckpt`)."""
    root = corpus["root"]
    proc = subprocess.run(
        [sys.executable, "-m", "sos_tpu_torch.cli.predict_detector",
         "--dataset_json", corpus["ds_json"], "--ckpt", "latest",
         "--output_root", str(root / "refused"), "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    looked_for = root / "refused" / "experiment_detector" / "model" / "latest.pt"
    assert str(looked_for) in " ".join(proc.stderr.split())
    assert "--pth" in proc.stderr
