"""Port models (`sos_tpu_torch.models`, `ops.resize`, `config`) against
`sos_tpu`, on the CPU, with weights carried across by the port's
converter. Tolerances: detector logits atol=5e-5, rtol=1e-4; denoiser
noise and mask atol=1e-4, rtol=1e-3 (test_model_parity.py's); bf16
detector logits atol=2e-2; resizes exact."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sos_tpu.models import JointDenoiser as JaxJointDenoiser
from sos_tpu.models import SilenceDetector as JaxSilenceDetector
from sos_tpu.models.layers import UpConvBlock as JaxUpConvBlock
from sos_tpu.ops.resize import nearest_resize_1d as jax_resize_1d
from sos_tpu.ops.resize import nearest_resize_2d as jax_resize_2d
from sos_tpu_torch.config import ExperimentConfig as PortExperimentConfig
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.convert import denoiser_from_jax, detector_from_jax
from sos_tpu_torch.models.layers import UpConvBlock, init_state_dict
from sos_tpu_torch.ops.resize import nearest_resize_1d, nearest_resize_2d

from tests.torch_port_fixtures import (make_clips, oracle_states,
                                      oracle_variables, tiny_configs)

jstft = importlib.import_module("sos_tpu.dsp.stft")


@pytest.fixture(scope="module")
def env():
    cfg, port_cfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=3)
    clips = make_clips(2, seed=4)
    spec = np.array(jstft.stft(jnp.asarray(clips)))  # (2, 256, 178, 2)
    gated = spec * np.random.default_rng(5).uniform(0, 1, spec.shape).astype(np.float32)
    return cfg, port_cfg, det_vars, den_vars, spec, gated


def _port(model, state):
    model.load_state_dict(state)  # strict: every key carried across
    return model.eval()


def test_config_json_roundtrip_matches_sos_tpu(env):
    cfg, port_cfg = env[:2]
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    assert PortExperimentConfig.from_json(port_cfg.to_json()) == port_cfg


def test_detector_logits_match(env):
    cfg, port_cfg, det_vars, _, spec, _ = env
    ref = np.asarray(JaxSilenceDetector(cfg.detector).apply(det_vars, jnp.asarray(spec)))
    model = _port(SilenceDetector(port_cfg.detector), detector_from_jax(det_vars))
    with torch.no_grad():
        got = model(torch.from_numpy(spec)).numpy()
    assert got.shape == ref.shape == (2, 60)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def test_detector_bf16_logits_match(env):
    cfg, port_cfg, det_vars, _, spec, _ = env
    ref = np.asarray(JaxSilenceDetector(
        cfg.detector, compute_dtype="bfloat16", bf16_head_proj=True).apply(
            det_vars, jnp.asarray(spec)))
    model = _port(SilenceDetector(port_cfg.detector, "bfloat16", True),
                  detector_from_jax(det_vars))
    with torch.no_grad():
        got = model(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2)


def test_denoiser_noise_and_mask_match(env):
    cfg, port_cfg, _, den_vars, spec, gated = env
    ref_noise, ref_mask = JaxJointDenoiser(cfg.denoiser).apply(
        den_vars, jnp.asarray(spec), jnp.asarray(gated))
    model = _port(JointDenoiser(port_cfg.denoiser), denoiser_from_jax(den_vars))
    with torch.no_grad():
        noise, mask = model(torch.from_numpy(spec), torch.from_numpy(gated))
    assert noise.shape == mask.shape == (2, 256, 178, 2)
    np.testing.assert_allclose(noise.numpy(), np.asarray(ref_noise), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), atol=1e-4, rtol=1e-3)


def test_denoiser_packed_head_is_the_mask_layout(env):
    """forward_packed's (B, T, 2F) head is the (B, F, T, 2) mask, packed
    [re-channel | im-channel] (what kernel K3 reads)."""
    _, port_cfg, _, den_vars, spec, gated = env
    model = _port(JointDenoiser(port_cfg.denoiser), denoiser_from_jax(den_vars))
    s, g = torch.from_numpy(spec), torch.from_numpy(gated)
    with torch.no_grad():
        _, mask = model(s, g)
        _, packed = model.forward_packed(s.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2))
    torch.testing.assert_close(packed[..., :256], mask[..., 0].transpose(1, 2), atol=0, rtol=0)
    torch.testing.assert_close(packed[..., 256:], mask[..., 1].transpose(1, 2), atol=0, rtol=0)


@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_fast_profile_padded_import_matches_sos_tpu(env, tmp_path, stage):
    """The fast profiles (`import_checkpoint --fast_profile`): the port's
    `fast_*_config` are sos_tpu's; a reference `.pth` imported widened
    (here the tiny trunk's 4 channels to 8) equals sos_tpu's padded tree,
    converted, tensor for tensor; one f32 call of the widened model
    matches the unwidened port model (the padding is lossless; that model
    is held against sos_tpu above) and, for the detector, sos_tpu's
    widened model (the models' tolerances)."""
    from sos_tpu import config as jconfig
    from sos_tpu.models import torch_import as jimport
    from sos_tpu_torch import config as pconfig
    from sos_tpu_torch.models import torch_import as pimport
    cfg, port_cfg, det_vars, den_vars, spec, gated = env
    for name in ("fast_detector_config", "fast_denoiser_config"):
        assert dataclasses.asdict(getattr(pconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)())
    state = oracle_states(cfg, seed=3)[stage == "denoiser"]
    path = tmp_path / "ckpt.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in state.items()}}, path)
    if stage == "detector":
        wide, port_wide = (dataclasses.replace(c.detector, nf=8)
                           for c in (cfg, port_cfg))
        got = pimport.import_detector_checkpoint(str(path), nf=8)
        ref_vars = jimport.detector_torch_to_flax(state, nf=8)
        want = detector_from_jax(ref_vars)
        args = (spec,)
        ref = [JaxSilenceDetector(wide).apply(ref_vars, jnp.asarray(spec))]
        model = _port(SilenceDetector(port_wide), got)
        narrow = _port(SilenceDetector(port_cfg.detector),
                       detector_from_jax(det_vars))
        tol = dict(atol=5e-5, rtol=1e-4)
    else:
        port_wide = dataclasses.replace(port_cfg.denoiser, nf_noise=8)
        got = pimport.import_denoiser_checkpoint(str(path), nf_noise=8)
        ref_vars = jimport.denoiser_torch_to_flax(state, nf_noise=8)
        want = denoiser_from_jax(ref_vars)
        args = (spec, gated)
        ref = ()
        model = _port(JointDenoiser(port_wide), got)
        narrow = _port(JointDenoiser(port_cfg.denoiser),
                       denoiser_from_jax(den_vars))
        tol = {}
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(got[k].shape != narrow.state_dict()[k].shape for k in got)
    with torch.no_grad():
        outs = model(*(torch.from_numpy(a) for a in args))
        lossless = narrow(*(torch.from_numpy(a) for a in args))
    outs = outs if isinstance(outs, tuple) else (outs,)
    lossless = lossless if isinstance(lossless, tuple) else (lossless,)
    for o, n in zip(outs, lossless):
        np.testing.assert_allclose(o.numpy(), n.numpy(), atol=1e-5, rtol=0)
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol)


def test_converter_takes_flax_init_trees():
    """Detector variables straight from flax `init` (not via
    torch_import) load strictly and give the same logits."""
    cfg, port_cfg = tiny_configs()
    x = jnp.asarray(np.random.default_rng(6).standard_normal((1, 256, 40, 2)),
                    jnp.float32)
    det = JaxSilenceDetector(cfg.detector)
    variables = det.init(jax.random.PRNGKey(0), x)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = _port(SilenceDetector(port_cfg.detector), detector_from_jax(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(got, np.asarray(det.apply(variables, x)),
                               atol=5e-5, rtol=1e-4)


def test_up_conv_block_output_padding_matches():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)  # NHWC
    block = JaxUpConvBlock(features=3, kernel_size=3, stride=2, output_padding=1)
    variables = block.init(jax.random.PRNGKey(2), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    ref = np.asarray(block.apply(variables, jnp.asarray(x)))
    port = UpConvBlock(5, 3, 3, 2)
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in
                          detector_from_jax({"params": {"b": variables["params"]},
                                             "batch_stats": {"b": variables["batch_stats"]}}).items()})
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 18, 14, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("in_len,out_len", [(178, 60), (90, 89), (45, 89), (7, 7)])
def test_nearest_resize_1d_exact(in_len, out_len):
    x = np.random.default_rng(in_len).standard_normal((2, in_len, 3)).astype(np.float32)
    got = nearest_resize_1d(torch.from_numpy(x), out_len, dim=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_resize_1d(jnp.asarray(x), out_len, axis=1)))


def test_nearest_resize_2d_exact():
    x = np.random.default_rng(8).standard_normal((2, 3, 64, 46)).astype(np.float32)
    got = nearest_resize_2d(torch.from_numpy(x), (64, 45), 2, 3).numpy()
    ref = np.asarray(jax_resize_2d(jnp.asarray(x), (64, 45), h_axis=2, w_axis=3))
    np.testing.assert_array_equal(got, ref)


def test_init_state_dict_is_seeded_with_nontrivial_bn_stats():
    _, port_cfg = tiny_configs()
    a = init_state_dict(SilenceDetector(port_cfg.detector), torch.Generator().manual_seed(9))
    b = init_state_dict(SilenceDetector(port_cfg.detector), torch.Generator().manual_seed(9))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["conv0.bn.running_mean"].abs().sum() > 0
    assert not torch.equal(a["conv0.bn.running_var"], torch.ones(4))
    den = init_state_dict(JointDenoiser(port_cfg.denoiser), torch.Generator().manual_seed(9))
    assert float(den["inpaint.a_in.act.weight"]) == 0.25  # torch's PReLU init
