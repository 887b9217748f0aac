"""The port's full-utterance predictors (`sos_tpu_torch.infer.detect`,
`infer.denoise`) against `sos_tpu`'s, on the CPU, in every mode: exact
(`buckets=None`), bucketed and batched-bucketed, at the same buckets,
with the same weights and inputs.

Lengths as tests/test_infer.py's bucketed tests, plus one utterance past
the dense mask's 6.3 s. Tolerances: bits equal (frames whose `sos_tpu`
confidence lies within 1e-4 of the threshold are compared with
`sos_tpu`'s own bits of the other mode instead); detector confidences
atol 5e-5; waveforms atol 1e-4, rtol 1e-3 (the repo's 1e-4); within the
port, bucketed against exact atol 2e-5 (detector) and 3e-5 (waveforms),
`sos_tpu`'s own bounds (tests/test_infer.py); bf16 against f32: drift
< 0.05 and <= 2 % flipped bits (`sos_tpu/infer/detect.py:57`); int8
against `sos_tpu`'s int8 with one scale file: bits equal, confidences and
waveforms within the 5e-3 int8 budget (tests/test_torch_quant.py).
"""

import json

import numpy as np
import pytest
import torch

from sos_tpu.infer.denoise import DenoiserPredictor as JaxDenoiserPredictor
from sos_tpu.infer.detect import DetectorPredictor as JaxDetectorPredictor
from sos_tpu_torch.infer import DenoiserPredictor, DetectorPredictor
from sos_tpu_torch.kernels import LAUNCHES

from tests.torch_port_fixtures import oracle_variables, port_states, tiny_configs

DET_LENGTHS = (28000, 20000, 33000, 100000)  # the last is 7.1 s
DEN_LENGTHS = (28000, 22000, 31000, 100000)
DET_BUCKETS = (256, 512, 1024)
DEN_BUCKETS = (256, 1024)
KEYS = ("denoised", "predicted_noise", "gated_noise")


@pytest.fixture(scope="module")
def env():
    cfg, port_cfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=21)
    det_state, den_state = port_states(det_vars, den_vars)
    rng = np.random.default_rng(22)
    det_wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
                for n in DET_LENGTHS]
    frames = [int(n / 14000 * 30) for n in DET_LENGTHS]
    den_wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
                for n in DEN_LENGTHS]
    bits = ["".join(rng.choice(list("01"), int(n / 14000 * 30)))
            for n in DEN_LENGTHS]
    return (cfg, port_cfg, det_vars, den_vars, det_state, den_state,
            det_wavs, frames, den_wavs, bits)


def _assert_bits(got, ref, ref_conf, threshold=0.5):
    clear = np.abs(ref_conf - threshold) > 1e-4
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert clear.mean() > 0.9


@pytest.fixture(scope="module")
def detections(env):
    """{mode: [(bits, conf)]} of both packages, f32."""
    cfg, port_cfg, det_vars, _, det_state, _, wavs, frames = env[:8]
    out = {}
    for mode, buckets in (("exact", None), ("bucketed", DET_BUCKETS)):
        jax_pred = JaxDetectorPredictor(cfg, det_vars, buckets=buckets)
        port = DetectorPredictor(port_cfg, det_state, buckets=buckets,
                                 device="cpu")
        out[("jax", mode)] = [jax_pred.predict_waveform(w, n)
                              for w, n in zip(wavs, frames)]
        out[("port", mode)] = [port.predict_waveform(w, n)
                               for w, n in zip(wavs, frames)]
        if buckets is not None:
            out[("jax", "batched")] = jax_pred.predict_batch(wavs, frames,
                                                             batch_size=2)
            out[("port", "batched")] = port.predict_batch(wavs, frames,
                                                          batch_size=2)
    return out


@pytest.mark.parametrize("mode", ["exact", "bucketed", "batched"])
def test_detector_predictor_matches_sos_tpu(detections, mode):
    for (bits, conf), (ref_bits, ref_conf) in zip(detections[("port", mode)],
                                                  detections[("jax", mode)]):
        assert bits.shape == ref_bits.shape and bits.dtype == np.int64
        np.testing.assert_allclose(conf, ref_conf, atol=5e-5)
        _assert_bits(bits, ref_bits, ref_conf)


@pytest.mark.parametrize("mode", ["bucketed", "batched"])
def test_detector_bucketed_equals_exact(detections, mode):
    for (bits, conf), (ref_bits, ref_conf) in zip(
            detections[("port", mode)], detections[("port", "exact")]):
        np.testing.assert_allclose(conf, ref_conf, atol=2e-5)
        _assert_bits(bits, ref_bits, ref_conf)


def test_detector_bf16_stays_near_f32(env, detections):
    _, port_cfg, _, _, det_state, _, wavs, frames = env[:8]
    bf16 = DetectorPredictor(port_cfg, det_state, buckets=DET_BUCKETS,
                             profile="bf16", device="cpu")
    got = bf16.predict_batch(wavs, frames, batch_size=4)
    conf = np.concatenate([c for _, c in got])
    ref = np.concatenate([c for _, c in detections[("port", "bucketed")]])
    bits = np.concatenate([b for b, _ in got])
    ref_bits = np.concatenate([b for b, _ in detections[("port", "bucketed")]])
    assert np.abs(conf - ref).max() < 0.05
    assert (bits != ref_bits).mean() <= 0.02


@pytest.fixture(scope="module")
def denoisings(env):
    cfg, port_cfg, _, den_vars, _, den_state = env[:6]
    wavs, bits = env[8], env[9]
    out = {}
    for mode, buckets in (("exact", None), ("bucketed", DEN_BUCKETS)):
        jax_pred = JaxDenoiserPredictor(cfg, den_vars, buckets=buckets)
        port = DenoiserPredictor(port_cfg, den_state, buckets=buckets,
                                 device="cpu")
        out[("jax", mode)] = [jax_pred.denoise_waveform(w, b)
                              for w, b in zip(wavs, bits)]
        out[("port", mode)] = [port.denoise_waveform(w, b)
                               for w, b in zip(wavs, bits)]
        if buckets is not None:
            # 3 utterances in bucket 256 at batch 2: the second tile
            # repeats its one row
            out[("jax", "batched")] = jax_pred.denoise_batch(wavs, bits,
                                                             batch_size=2)
            before = dict(LAUNCHES)
            out[("port", "batched")] = port.denoise_batch(wavs, bits,
                                                          batch_size=2)
            assert LAUNCHES == before  # CPU tensors: the plain versions
    return out


@pytest.mark.parametrize("mode", ["exact", "bucketed", "batched"])
def test_denoiser_predictor_matches_sos_tpu(denoisings, mode):
    for n, got, ref in zip(DEN_LENGTHS, denoisings[("port", mode)],
                           denoisings[("jax", mode)]):
        for key in KEYS:
            assert got[key].shape == ref[key].shape == ((n // 158) * 158,)
            np.testing.assert_allclose(got[key], ref[key], atol=1e-4,
                                       rtol=1e-3, err_msg=f"{key}@{n}")


@pytest.mark.parametrize("mode", ["bucketed", "batched"])
def test_denoiser_bucketed_equals_exact(denoisings, mode):
    for n, got, ref in zip(DEN_LENGTHS, denoisings[("port", mode)],
                           denoisings[("port", "exact")]):
        for key in KEYS:
            np.testing.assert_allclose(got[key], ref[key], atol=3e-5,
                                       err_msg=f"{key}@{n}")


def test_denoise_batch_keys_select_outputs(env, denoisings):
    _, port_cfg, _, _, _, den_state = env[:6]
    port = DenoiserPredictor(port_cfg, den_state, buckets=DEN_BUCKETS,
                             device="cpu")
    got = port.denoise_batch(env[8][:2], env[9][:2], batch_size=2,
                             keys=("denoised",))
    for out, ref in zip(got, denoisings[("port", "batched")]):
        assert list(out) == ["denoised"]
        np.testing.assert_array_equal(out["denoised"], ref["denoised"])


def test_int8_exact_matches_sos_tpu_with_one_scale_file(env, tmp_path):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env[:6]
    det_wavs, frames, den_wavs, bits = env[6:10]
    jax_det = JaxDetectorPredictor(cfg, det_vars, profile="int8")
    jax_den = JaxDenoiserPredictor(cfg, den_vars, profile="int8")
    ref_det = [jax_det.predict_waveform(w, n)
               for w, n in zip(det_wavs[2:], frames[2:])]
    ref_den = [jax_den.denoise_waveform(w, b)
               for w, b in zip(den_wavs[2:], bits[2:])]
    path = tmp_path / "int8_calibration.json"
    path.write_text(json.dumps({
        "detector": jax_det._quant.calibration_state(),
        "denoiser": jax_den._quant.calibration_state()}))
    det = DetectorPredictor(port_cfg, det_state, profile="int8",
                            calibration_path=str(path), device="cpu")
    den = DenoiserPredictor(port_cfg, den_state, profile="int8",
                            calibration_path=str(path), device="cpu")
    for (b, c), (rb, rc) in zip(
            [det.predict_waveform(w, n)
             for w, n in zip(det_wavs[2:], frames[2:])], ref_det):
        np.testing.assert_allclose(c, rc, atol=5e-3)
        _assert_bits(b, rb, rc)
    assert det._quant.calibration_state() == jax_det._quant.calibration_state()
    for got, ref in zip([den.denoise_waveform(w, b)
                         for w, b in zip(den_wavs[2:], bits[2:])], ref_den):
        for key in KEYS:
            np.testing.assert_allclose(got[key], ref[key], atol=5e-3)


def test_int8_with_buckets_raises(env):
    _, port_cfg, _, _, det_state, den_state = env[:6]
    for cls, state in ((DetectorPredictor, det_state),
                       (DenoiserPredictor, den_state)):
        for device in ("cpu", "cuda"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                cls(port_cfg, state, buckets=(256,), profile="int8",
                    device=device)


def test_predictors_default_to_the_card(env):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, port_cfg, _, _, det_state, den_state = env[:6]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectorPredictor(port_cfg, det_state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenoiserPredictor(port_cfg, den_state, buckets=(256,))
