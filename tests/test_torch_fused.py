"""Port fused pipeline (`sos_tpu_torch.infer.fused`) against
`sos_tpu.infer.fused`, end to end on the CPU.

Tolerances: f32 bits equal (after checking the JAX run keeps every
sigmoid more than 1e-3 from the threshold), waveform atol=1e-4,
rtol=1e-3, int16 wire within 1 LSB; bf16 (fed the JAX bits) waveform
relative L2 error <= 2e-2.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sos_tpu.infer.fused import FusedDenoisePipeline as JaxPipeline
from sos_tpu.infer.fused import wire_decode as jax_wire_decode
from sos_tpu.infer.fused import wire_encode as jax_wire_encode
from sos_tpu.models import SilenceDetector as JaxSilenceDetector
from sos_tpu_torch.infer.fused import FusedDenoisePipeline, wire_decode, wire_encode
from sos_tpu_torch.kernels import LAUNCHES

from tests.torch_port_fixtures import (CLIP, make_clips, oracle_variables,
                                       port_states, tiny_configs)

HALO = CLIP + 3000  # a streaming detector-context window: 66 bits
jstft = importlib.import_module("sos_tpu.dsp.stft")


@pytest.fixture(scope="module")
def env():
    cfg, port_cfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=1)
    # a sharper head, so the random detector gives mixed bits that sit
    # clear of the threshold
    fc2 = det_vars["params"]["fc2"]
    fc2["kernel"], fc2["bias"] = fc2["kernel"] * 40, fc2["bias"] * 40
    det_state, den_state = port_states(det_vars, den_vars)
    clips = make_clips(2, seed=22)
    return cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips


@pytest.fixture(scope="module")
def f32_pair(env):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state, _ = env
    return (JaxPipeline(cfg, det_vars, den_vars),
            FusedDenoisePipeline(port_cfg, det_state, den_state, device="cpu"))


def _margin(cfg, det_vars, clips, num_frames=None):
    """The JAX run's smallest |sigmoid - 0.5| over all frames."""
    logits = JaxSilenceDetector(cfg.detector).apply(
        det_vars, jstft.stft(jnp.asarray(clips)), num_frames=num_frames)
    return float(np.abs(np.asarray(jax.nn.sigmoid(logits)) - 0.5).min())


def test_call_f32_matches(env, f32_pair):
    cfg, _, det_vars, _, _, _, clips = env
    assert _margin(cfg, det_vars, clips) > 1e-3
    ref_y, ref_bits = (np.asarray(a) for a in f32_pair[0](clips))
    before = dict(LAUNCHES)
    y, bits = f32_pair[1](clips)
    assert LAUNCHES == before  # device="cpu": plain versions only
    assert 0 < ref_bits.sum() < ref_bits.size  # the mask path really gates
    np.testing.assert_array_equal(bits.numpy(), ref_bits)
    assert y.shape == ref_y.shape == (2, 27966)
    np.testing.assert_allclose(y.numpy(), ref_y, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("n_samples,n_bits", [(CLIP, 60), (HALO, 66)])
def test_detect_bits_matches(env, f32_pair, n_samples, n_bits):
    cfg, _, det_vars, _, _, _, _ = env
    clips = make_clips(2, seed=22)
    if n_samples > CLIP:
        clips = np.concatenate([make_clips(2, seed=23)[:, :n_samples - CLIP], clips], 1)
    assert _margin(cfg, det_vars, clips, n_bits) > 1e-3
    ref = np.asarray(f32_pair[0].detect_bits(clips))
    got = f32_pair[1].detect_bits(clips).numpy()
    assert got.shape == ref.shape == (2, n_bits)
    np.testing.assert_array_equal(got, ref)


def test_denoise_with_bits_matches(env, f32_pair):
    clips = env[-1]
    bits = (np.random.default_rng(24).random((2, 60)) < 0.5).astype(np.float32)
    ref = np.asarray(f32_pair[0].denoise_with_bits(clips, bits))
    got = f32_pair[1].denoise_with_bits(clips, bits).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-3)


def test_int16_wire_within_one_lsb(env):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips = env
    wire = wire_encode(clips)
    ref_y, ref_bits = JaxPipeline(cfg, det_vars, den_vars, wire_dtype="int16")(wire)
    y, bits = FusedDenoisePipeline(port_cfg, det_state, den_state,
                                   wire_dtype="int16", device="cpu")(wire)
    assert y.dtype == torch.int16 and np.asarray(ref_y).dtype == np.int16
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))
    diff = np.abs(y.numpy().astype(np.int32) - np.asarray(ref_y).astype(np.int32))
    assert diff.max() <= 1


def test_bf16_denoise_with_jax_bits(env, f32_pair):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips = env
    bits = np.array(f32_pair[0](clips)[1])
    ref = np.asarray(JaxPipeline(cfg, det_vars, den_vars,
                                 profile="bf16").denoise_with_bits(clips, bits))
    got = FusedDenoisePipeline(port_cfg, det_state, den_state, profile="bf16",
                               device="cpu").denoise_with_bits(clips, bits).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 2e-2, rel


def test_wire_codec_matches():
    y = np.random.default_rng(25).uniform(-1.2, 1.2, 1000).astype(np.float32)
    np.testing.assert_array_equal(wire_encode(y), jax_wire_encode(y))
    np.testing.assert_array_equal(wire_decode(wire_encode(y)),
                                  jax_wire_decode(jax_wire_encode(y)))


def test_bad_arguments_raise(env):
    _, port_cfg, _, _, det_state, den_state, _ = env
    with pytest.raises(ValueError, match="profile"):
        FusedDenoisePipeline(port_cfg, det_state, den_state, profile="fp8",
                             device="cpu")
    with pytest.raises(ValueError, match="wire_dtype"):
        FusedDenoisePipeline(port_cfg, det_state, den_state,
                             wire_dtype="int8", device="cpu")
    pipe = FusedDenoisePipeline(port_cfg, det_state, den_state, device="cpu")
    with pytest.raises(ValueError, match="28000"):
        pipe(np.zeros((2, 27000), np.float32))
