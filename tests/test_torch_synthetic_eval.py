"""The port's synthetic per-SNR evaluation (`sos_tpu_torch.infer.
synthetic_eval`, `cli/eval_synthetic.py`) against `sos_tpu`'s on the
CPU, at the tiny widths of tests/torch_port_fixtures.py, on a tiny
corpus at one pinned SNR (0 dB), 2 batches of 2 clips, f32 and int8.

* The denoised and clean waveforms of each batch within 1e-4 (+ rtol
  1e-3, the repo's rule) of `sos_tpu`'s (its jitted body: the device
  mix, the model, `apply_compressed_crm`, `istft`); int8 denoised within
  the 5e-3 int8 budget of tests/test_torch_quant.py, both packages on
  `sos_tpu`'s first-batch scales.
* Every `avg_*` (and, in f32, `noisy_avg_*`) within 1e-3 relative of
  `sos_tpu`'s, except the composite measures (`COMPOSITE_RTOL`).
* The port's first-batch int8 scales equal `sos_tpu`'s within 1e-5.
* `eval_synthetic --device cpu` on the port's own checkpoint writes the
  per-SNR report with the 11 metrics finite.
* The port's copy of the PESQ conformance corpus
  (`eval/pesq_conformance.py`) is `sos_tpu`'s and scores the committed
  manifest exactly (one pair of each family).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_tpu.data import DatasetIndex as JaxIndex
from sos_tpu.data import DenoiserBatcher as JaxBatcher
from sos_tpu.data import NoiseBank as JaxNoiseBank
from sos_tpu.data import denoiser_windows as jax_windows
from sos_tpu.data.pipeline import device_mix_and_stft_denoiser as jax_mix
from sos_tpu.dsp.crm import apply_compressed_crm
from sos_tpu.dsp.stft import istft as jax_istft
from sos_tpu.infer.synthetic_eval import evaluate_synthetic as jax_evaluate
from sos_tpu.models import JointDenoiser as JaxJointDenoiser
from sos_tpu.models.quant import QuantizedDenoiser as JaxQuantizedDenoiser
from sos_tpu_torch.data import (DatasetIndex, DenoiserBatcher, NoiseBank,
                                denoiser_windows)
from sos_tpu_torch.infer.synthetic_eval import (METRIC_KEYS,
                                                SyntheticDenoise,
                                                evaluate_synthetic)

from tests.torch_port_fixtures import (oracle_variables, port_states,
                                       tiny_configs, training_corpus)

REPO = Path(__file__).resolve().parents[1]
SNR_IDX = 3          # 0 dB
BATCH = 2
MAX_BATCHES = 2
# csig, cbak and covl regress on the mean of the 95 % lowest frame
# LLRs and WSS distances (`eval/speech.py` `composite_eval`): a waveform
# 1e-7 apart moves a frame across that cut, and the noisy baselines,
# whose waveforms agree to 3e-8, differ there by up to 1.7e-3 relative
COMPOSITE_RTOL = {"csig": 5e-3, "cbak": 5e-3, "covl": 5e-3}
INT8_BUDGET = 5e-3


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch on 2 threads in this module (tiny widths): the suite's other
    workers share the host's cores, and more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    cfg, pcfg = tiny_configs()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, snr_idx=SNR_IDX))
    pcfg = dataclasses.replace(pcfg, data=dataclasses.replace(
        pcfg.data, snr_idx=SNR_IDX))
    root = tmp_path_factory.mktemp("corpus")
    ds_json, noise_dir = training_corpus(root)
    _, den_vars = oracle_variables(cfg, seed=7)
    _, den_state = port_states(_, den_vars)
    return cfg, pcfg, den_vars, den_state, ds_json, noise_dir, root


def _batchers(env):
    cfg, pcfg, *_, ds_json, noise_dir, _ = env
    idx = JaxIndex.load(ds_json)
    jb = JaxBatcher(jax_windows(idx.files, cfg.data.clip_seconds,
                                cfg.data.overlap_seconds),
                    JaxNoiseBank.from_roots([noise_dir], cfg.data.sample_rate),
                    cfg.data, BATCH, shuffle=False,
                    seed=cfg.data.pred_random_seed)
    idx = DatasetIndex.load(ds_json)
    pb = DenoiserBatcher(denoiser_windows(idx.files, pcfg.data.clip_seconds,
                                          pcfg.data.overlap_seconds),
                         NoiseBank.from_roots([noise_dir],
                                              pcfg.data.sample_rate),
                         pcfg.data, BATCH, shuffle=False,
                         seed=pcfg.data.pred_random_seed)
    return jb, pb


@pytest.fixture(scope="module", params=["f32", "int8"])
def reports(request, env):
    cfg, pcfg, den_vars, den_state = env[:4]
    jb, pb = _batchers(env)
    # the noisy baseline scores the mixtures, the same in every profile:
    # once, with f32
    kw = dict(max_batches=MAX_BATCHES, profile=request.param,
              noisy_baseline=request.param == "f32")
    return (request.param, jax_evaluate(cfg, den_vars, jb, **kw),
            evaluate_synthetic(pcfg, den_state, pb, device="cpu", **kw))


def test_reports_match_sos_tpu(reports):
    _, ref, got = reports
    assert list(got) == list(ref)
    assert got["num_clips"] == ref["num_clips"] == BATCH * MAX_BATCHES
    for key in (k for k in ref if k != "num_clips"):
        metric = key.split("avg_", 1)[1]
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], ref[key],
                                   rtol=COMPOSITE_RTOL.get(metric, 1e-3),
                                   atol=1e-9, err_msg=key)


def _jax_body(cfg, quant):
    """`sos_tpu`'s jitted synthetic-eval body (`run` of its
    `evaluate_synthetic`, without the noisy baseline): (variables, clean,
    noise, snr, bits) -> (denoised, clean) waveforms."""
    model = JaxJointDenoiser(cfg.denoiser)
    s = cfg.stft
    geometry = (s.n_fft, s.hop_length, s.win_length)

    @jax.jit
    def run(variables, clean, noise, snr, bits):
        d = jax_mix(clean, noise, snr, bits, cfg.data, cfg.stft)
        if quant is not None:
            _, crm = quant(d["mixed"], d["noise"])
        else:
            _, crm = model.apply(variables, d["mixed"], d["noise"],
                                 train=False)
        return (jax_istft(apply_compressed_crm(d["mixed"], crm), *geometry),
                jax_istft(d["clean"], *geometry))
    return run


@pytest.mark.parametrize("profile", ["f32", "int8"])
def test_waveforms_match_sos_tpu(env, profile):
    cfg, pcfg, den_vars, den_state = env[:4]
    jb, pb = _batchers(env)
    run = SyntheticDenoise(pcfg, den_state, profile, device="cpu")
    quant = body = None
    for b_idx, (jbatch, pbatch) in enumerate(zip(jb, pb)):
        if b_idx == MAX_BATCHES:
            break
        for key in jbatch:
            np.testing.assert_array_equal(jbatch[key], pbatch[key])
        if profile == "int8" and quant is None:
            quant = JaxQuantizedDenoiser(cfg.denoiser, den_vars,
                                         inpaint_dtype="int8")
            d = jax_mix(*(jnp.asarray(jbatch[k]) for k in
                          ("clean", "noise", "snr", "bits")),
                        cfg.data, cfg.stft)
            quant.calibrate([(d["mixed"], d["noise"])])
            run.calibrate(pbatch)
            ref_scales, scales = (quant.calibration_state(),
                                  run.quant.calibration_state())
            for part in ("enc_x", "enc_n"):
                np.testing.assert_allclose(scales[part], ref_scales[part],
                                           rtol=1e-5)
            for k, v in ref_scales["inpaint"].items():
                np.testing.assert_allclose(scales["inpaint"][k], v, rtol=1e-5)
            run.quant.load_calibration(ref_scales)  # one scale file
        if body is None:
            body = _jax_body(cfg, quant)
        ref_den, ref_clean = (np.asarray(w) for w in body(
            den_vars, *(jnp.asarray(jbatch[k]) for k in
                        ("clean", "noise", "snr", "bits"))))
        denoised, clean, mixed = run(pbatch)
        assert mixed is None
        np.testing.assert_allclose(clean.numpy(), ref_clean, atol=1e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(
            denoised.numpy(), ref_den, rtol=1e-3,
            atol=1e-4 if profile == "f32" else INT8_BUDGET)


def test_eval_synthetic_cli_writes_the_report(env, tmp_path, capsys):
    """`eval_synthetic --device cpu` on the port's own checkpoint
    (`--ckpt latest`) writes the per-SNR report, 11 finite metrics."""
    from sos_tpu_torch.cli import eval_synthetic

    _, pcfg, _, den_state, ds_json, noise_dir, _ = env
    model_dir = tmp_path / "out" / "tiny_denoiser" / "model"
    model_dir.mkdir(parents=True)
    torch.save({"model": den_state}, model_dir / "latest.pt")
    cfg_json = tmp_path / "tiny.json"
    cfg_json.write_text(pcfg.to_json())
    report = tmp_path / "report.json"
    eval_synthetic.main([
        "--device", "cpu", "--config_json", str(cfg_json), "--name", "tiny",
        "--output_root", str(tmp_path / "out"), "--dataset_json", ds_json,
        "--noise_root", noise_dir, "--snr_idx", str(SNR_IDX), "--batch_size",
        "2", "--max_batches", "1", "--out", str(report)])
    got = json.loads(report.read_text())
    assert list(got) == ["snr_0"]
    row = got["snr_0"]
    assert row["num_clips"] == 2 and len(row) == 1 + len(METRIC_KEYS)
    assert all(np.isfinite(row["avg_" + k]) for k in METRIC_KEYS)
    assert "SNR +0 dB: l1=" in capsys.readouterr().out


def test_pesq_conformance_corpus_matches_the_manifest(monkeypatch):
    """The port's copy of the PESQ conformance corpus is `sos_tpu`'s,
    pair for pair and sample for sample, and `score_corpus` scores it as
    the committed manifest (`sos_tpu`'s tests/test_pesq.py pins the same
    file and scores all 13 pairs), exactly: one pair of each degradation
    family here."""
    from sos_tpu.eval.pesq_conformance import build_corpus as jax_corpus
    from sos_tpu_torch.eval import pesq_conformance

    want = json.loads((REPO / "tests" / "fixtures" /
                       "pesq_native_scores.json").read_text())
    corpus, ref = pesq_conformance.build_corpus(), jax_corpus()
    assert list(corpus) == list(ref) and set(corpus) == set(want)
    for name, (clean, deg) in corpus.items():
        np.testing.assert_array_equal(clean, ref[name][0])
        np.testing.assert_array_equal(deg, ref[name][1])
    picked = ("awgn_snr+10", "clip_0.25", "lowpass_2000")
    monkeypatch.setattr(pesq_conformance, "build_corpus",
                        lambda fs: {k: corpus[k] for k in picked})
    got = pesq_conformance.score_corpus("native")
    assert list(got) == list(picked)
    for name in picked:
        assert got[name] == pytest.approx(want[name], abs=1e-9), name
