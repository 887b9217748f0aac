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
against `sos_tpu`'s int8 with one scale file: confidences and waveforms
within the 5e-3 int8 budget (tests/test_torch_quant.py), bits equal
(the bucketed modes: where `sos_tpu`'s confidence lies more than that
budget from the threshold). The int8 bucketed modes run the lengths
of bucket 256 (the JAX side stays small: one program a predictor).
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


INT8_BUDGET = 5e-3  # sos_tpu tests/test_quant.py:100
INT8_LENGTHS = 3    # the first three: bucket 256 in both predictors


def _assert_bits(got, ref, ref_conf, threshold=0.5, margin=1e-4):
    clear = np.abs(ref_conf - threshold) > margin
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


@pytest.fixture(scope="module")
def int8_calibration(env, tmp_path_factory):
    """One scale file for both packages' int8 predictors: sos_tpu's
    self-calibration on the first utterance of each stage."""
    cfg, _, det_vars, den_vars = env[:4]
    det_wavs, frames, den_wavs, bits = env[6:10]
    jax_det = JaxDetectorPredictor(cfg, det_vars, buckets=DET_BUCKETS,
                                   profile="int8")
    jax_den = JaxDenoiserPredictor(cfg, den_vars, buckets=DEN_BUCKETS,
                                   profile="int8")
    jax_det._maybe_calibrate(det_wavs[0])
    jax_den.denoise_waveform(den_wavs[0], bits[0])  # calibrates on it
    path = tmp_path_factory.mktemp("int8") / "int8_calibration.json"
    path.write_text(json.dumps({
        "detector": jax_det._quant.calibration_state(),
        "denoiser": jax_den._quant.calibration_state()}))
    return str(path), jax_det, jax_den


@pytest.fixture(scope="module")
def int8_detections(env, int8_calibration):
    """{(package, mode): [(bits, conf)]} of the int8 bucketed modes."""
    _, port_cfg, _, _, det_state = env[:5]
    wavs, frames = env[6][:INT8_LENGTHS], env[7][:INT8_LENGTHS]
    path, jax_det, _ = int8_calibration

    def port():  # a fresh predictor: each mode loads the scale file
        return DetectorPredictor(port_cfg, det_state, buckets=DET_BUCKETS,
                                 profile="int8", calibration_path=path,
                                 device="cpu")
    return {
        ("jax", "int8_bucketed"): [jax_det.predict_waveform(w, n)
                                   for w, n in zip(wavs, frames)],
        ("port", "int8_bucketed"): [port().predict_waveform(w, n)
                                    for w, n in zip(wavs, frames)],
        ("jax", "int8_batched"): jax_det.predict_batch(wavs, frames,
                                                       batch_size=2),
        ("port", "int8_batched"): port().predict_batch(wavs, frames,
                                                       batch_size=2)}


@pytest.mark.parametrize("mode", ["exact", "bucketed", "batched",
                                  "int8_bucketed", "int8_batched"])
def test_detector_predictor_matches_sos_tpu(request, mode):
    int8 = mode.startswith("int8")
    runs = request.getfixturevalue("int8_detections" if int8
                                   else "detections")
    atol = INT8_BUDGET if int8 else 5e-5
    for (bits, conf), (ref_bits, ref_conf) in zip(runs[("port", mode)],
                                                  runs[("jax", mode)]):
        assert bits.shape == ref_bits.shape and bits.dtype == np.int64
        np.testing.assert_allclose(conf, ref_conf, atol=atol)
        _assert_bits(bits, ref_bits, ref_conf,
                     margin=INT8_BUDGET if int8 else 1e-4)


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


@pytest.fixture(scope="module")
def int8_denoisings(env, int8_calibration):
    _, port_cfg, _, _, _, den_state = env[:6]
    wavs, bits = env[8][:INT8_LENGTHS], env[9][:INT8_LENGTHS]
    path, _, jax_den = int8_calibration

    def port():  # a fresh predictor: each mode loads the scale file
        return DenoiserPredictor(port_cfg, den_state, buckets=DEN_BUCKETS,
                                 profile="int8", calibration_path=path,
                                 device="cpu")
    return {
        ("jax", "int8_bucketed"): [jax_den.denoise_waveform(w, b)
                                   for w, b in zip(wavs, bits)],
        ("port", "int8_bucketed"): [port().denoise_waveform(w, b)
                                    for w, b in zip(wavs, bits)],
        ("jax", "int8_batched"): jax_den.denoise_batch(wavs, bits,
                                                       batch_size=2),
        ("port", "int8_batched"): port().denoise_batch(wavs, bits,
                                                       batch_size=2)}


@pytest.mark.parametrize("mode", ["exact", "bucketed", "batched",
                                  "int8_bucketed", "int8_batched"])
def test_denoiser_predictor_matches_sos_tpu(request, mode):
    int8 = mode.startswith("int8")
    runs = request.getfixturevalue("int8_denoisings" if int8
                                   else "denoisings")
    for n, got, ref in zip(DEN_LENGTHS, runs[("port", mode)],
                           runs[("jax", mode)]):
        for key in KEYS:
            assert got[key].shape == ref[key].shape == ((n // 158) * 158,)
            if int8:
                np.testing.assert_allclose(got[key], ref[key],
                                           atol=INT8_BUDGET,
                                           err_msg=f"{key}@{n}")
            else:
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


@pytest.mark.parametrize("stage", ["detect", "denoise"])
def test_int8_bucketed_equals_exact(request, env, int8_calibration, stage):
    """Within the int8 profile the bucket changes nothing: the bucketed
    modes equal the exact one within sos_tpu's own bounds (2e-5
    confidences, 3e-5 waveforms; tests/test_infer.py), bits equal."""
    _, port_cfg, _, _, det_state, den_state = env[:6]
    path = int8_calibration[0]
    if stage == "detect":
        runs = request.getfixturevalue("int8_detections")
        exact = DetectorPredictor(port_cfg, det_state, profile="int8",
                                  calibration_path=path, device="cpu")
        wavs, frames = env[6][:INT8_LENGTHS], env[7][:INT8_LENGTHS]
        refs = [exact.predict_waveform(w, n) for w, n in zip(wavs, frames)]
        for mode in ("int8_bucketed", "int8_batched"):
            for (bits, conf), (ref_bits, ref_conf) in zip(
                    runs[("port", mode)], refs):
                np.testing.assert_allclose(conf, ref_conf, atol=2e-5)
                _assert_bits(bits, ref_bits, ref_conf)
        return
    runs = request.getfixturevalue("int8_denoisings")
    exact = DenoiserPredictor(port_cfg, den_state, profile="int8",
                              calibration_path=path, device="cpu")
    refs = [exact.denoise_waveform(w, b)
            for w, b in zip(env[8][:INT8_LENGTHS], env[9][:INT8_LENGTHS])]
    for mode in ("int8_bucketed", "int8_batched"):
        for got, ref in zip(runs[("port", mode)], refs):
            for key in KEYS:
                np.testing.assert_allclose(got[key], ref[key], atol=3e-5,
                                           err_msg=f"{mode} {key}")


def test_predictors_default_to_the_card(env):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, port_cfg, _, _, det_state, den_state = env[:6]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectorPredictor(port_cfg, det_state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenoiserPredictor(port_cfg, den_state, buckets=(256,))


def test_int8_exact_short_utterance_matches_sos_tpu(env, tmp_path):
    """A 0.5 s utterance (45 frames): the InpaintNet's mid_dil16 block
    pads 16 columns on a 12-wide input, where `jnp.pad` reflects again;
    the port's int8 exact denoiser computes it as `sos_tpu` does (within
    the int8 budget, with one scale file)."""
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env[:6]
    rng = np.random.default_rng(23)
    wav = (rng.standard_normal(7000) * 0.2).astype(np.float32)
    bits = "".join(rng.choice(list("01"), 15))
    jax_det = JaxDetectorPredictor(cfg, det_vars, profile="int8")
    jax_den = JaxDenoiserPredictor(cfg, den_vars, profile="int8")
    ref_bits, ref_conf = jax_det.predict_waveform(wav, 15)
    ref = jax_den.denoise_waveform(wav, bits)
    path = tmp_path / "int8_calibration.json"
    path.write_text(json.dumps({
        "detector": jax_det._quant.calibration_state(),
        "denoiser": jax_den._quant.calibration_state()}))
    det = DetectorPredictor(port_cfg, det_state, profile="int8",
                            calibration_path=str(path), device="cpu")
    den = DenoiserPredictor(port_cfg, den_state, profile="int8",
                            calibration_path=str(path), device="cpu")
    got_bits, got_conf = det.predict_waveform(wav, 15)
    np.testing.assert_allclose(got_conf, ref_conf, atol=INT8_BUDGET)
    _assert_bits(got_bits, ref_bits, ref_conf, margin=INT8_BUDGET)
    got = den.denoise_waveform(wav, bits)
    for key in KEYS:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], atol=INT8_BUDGET,
                                   err_msg=key)
