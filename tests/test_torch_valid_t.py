"""The port's length-bucketed (`valid_t`) ops, layers and models against
`sos_tpu`, on the CPU.

The port takes one batch with a valid length per row (`(B,)` tensors);
`sos_tpu` runs one scalar `valid_t` per item (its predictors vmap over
rows), so each row is held against `sos_tpu` run once on that item
alone. Every batch has a row at the full bucket and rows of 1-2 frames.
Tolerances: the tail ops, resizes and masks exact; conv blocks atol
1e-5, rtol 1e-5; STFT atol 1e-5; iSTFT and cRM + iSTFT atol 1e-4, rtol
1e-4 (the recovered masks reach +-46); BiLSTM atol 1e-5; detector logits
atol 5e-5, rtol 1e-4; denoiser noise and mask atol 1e-4, rtol 1e-3
(tests/test_torch_models.py's).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sos_tpu.dsp import crm as jcrm
from sos_tpu.models import JointDenoiser as JaxJointDenoiser
from sos_tpu.models import SilenceDetector as JaxSilenceDetector
from sos_tpu.models import layers as jlayers
from sos_tpu.ops.lstm import BiLSTM as JaxBiLSTM
from sos_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from sos_tpu.ops.resize import dynamic_nearest_time as jax_dynamic_nearest_time
from sos_tpu_torch.dsp import stft as tstft
from sos_tpu_torch.kernels import LAUNCHES
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models import layers as tlayers
from sos_tpu_torch.models.convert import (bilstm_from_jax, denoiser_from_jax,
                                          detector_from_jax)
from sos_tpu_torch.ops import lstm as tlstm
from sos_tpu_torch.ops.resize import dynamic_nearest_time

from tests.torch_port_fixtures import oracle_variables, tiny_configs

jstft = importlib.import_module("sos_tpu.dsp.stft")

T = 20
VALID = (T, 1, 2, 13)  # the full bucket, 1 and 2 frames, one between


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _x(seed, b=len(VALID), c=3, f=9, t=T) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, f, t, c)).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_zero_time_tail_matches_sos_tpu():
    x = _x(0)
    got = tlayers.zero_time_tail(_nchw(x), torch.tensor(VALID))
    for row, v in enumerate(VALID):
        ref = np.asarray(jlayers.zero_time_tail(jnp.asarray(x[row:row + 1]), v))
        np.testing.assert_array_equal(_nhwc(got[row:row + 1]), ref)


@pytest.mark.parametrize("pad,offset", [(2, 2), (4, 4), (1, 0)])
def test_reflect_time_tail_matches_sos_tpu(pad, offset):
    """The row at the full bucket writes up to the last column (offset
    + T + pad = the width at offset = pad)."""
    x = _x(1, t=T + 2 * pad)
    got = tlayers.reflect_time_tail(_nchw(x), torch.tensor(VALID), pad, offset)
    for row, v in enumerate(VALID):
        ref = np.asarray(jlayers.reflect_time_tail(
            jnp.asarray(x[row:row + 1]), jnp.int32(v), pad, offset=offset))
        np.testing.assert_array_equal(_nhwc(got[row:row + 1]), ref)


def _jax_block(block, x, seed):
    """Init a flax block with random BN statistics and PReLU slope."""
    variables = block.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    if "batch_stats" in variables:
        st = variables["batch_stats"]["TorchBatchNorm_0"]["BatchNorm_0"]
        st["mean"] = (rng.standard_normal(st["mean"].shape) * 0.3).astype(np.float32)
        st["var"] = (rng.uniform(0.5, 1.5, st["var"].shape)).astype(np.float32)
    if "act" in variables["params"]:
        variables["params"]["act"]["alpha"] = np.float32(rng.uniform(0.1, 0.4))
    return variables


def _port_block(port, variables):
    state = detector_from_jax({"params": {"b": variables["params"]},
                               "batch_stats": {"b": variables.get("batch_stats", {})}})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    return port.eval()


# (features, kernel, stride, dilation, final): InpaintNet's block kinds
DOWN_CASES = [(5, 5, 1, 1, False), (5, 5, 2, 1, False), (4, 3, 1, 2, False),
              (4, 3, 2, 1, False), (2, 3, 1, 1, True)]


@pytest.mark.parametrize("features,k,stride,dil,final", DOWN_CASES)
def test_down_conv_block_valid_t_matches_sos_tpu(features, k, stride, dil, final):
    x = _x(2 + k + stride + dil)
    kw = dict(norm=None, act=None) if final else {}
    block = jlayers.DownConvBlock(features=features, kernel_size=k,
                                  stride=stride, dilation=dil, **kw)
    variables = _jax_block(block, x, seed=k * 10 + stride)
    port = _port_block(tlayers.DownConvBlock(3, features, k, stride, dil,
                                             final=final), variables)
    with torch.no_grad():
        got, vout = port(_nchw(x), torch.tensor(VALID))
    for row, v in enumerate(VALID):
        ref, ref_v = block.apply(variables, jnp.asarray(x[row:row + 1]),
                                 valid_t=jnp.int32(v))
        assert int(vout[row]) == int(ref_v)
        np.testing.assert_allclose(_nhwc(got[row:row + 1]), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


def test_up_conv_block_valid_t_matches_sos_tpu():
    """ConvTranspose2d k3 s2 with output_padding=1: valid_out carries the
    +1 of the reference's quirk."""
    x = _x(9)
    block = jlayers.UpConvBlock(features=4, kernel_size=3, stride=2,
                                output_padding=1)
    variables = _jax_block(block, x, seed=9)
    port = _port_block(tlayers.UpConvBlock(3, 4, 3, 2), variables)
    with torch.no_grad():
        got, vout = port(_nchw(x), torch.tensor(VALID))
    assert got.shape == (4, 4, 18, 2 * T)
    for row, v in enumerate(VALID):
        ref, ref_v = block.apply(variables, jnp.asarray(x[row:row + 1]),
                                 valid_t=jnp.int32(v))
        assert int(vout[row]) == int(ref_v) == 2 * v
        np.testing.assert_allclose(_nhwc(got[row:row + 1]), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


def test_dynamic_nearest_time_matches_sos_tpu():
    x = _x(3, t=11)
    v_src, v_dst = (11, 1, 2, 6), (T, 1, 3, 13)
    got = dynamic_nearest_time(_nchw(x), torch.tensor(v_src),
                               torch.tensor(v_dst), T)
    for row in range(len(VALID)):
        ref = np.asarray(jax_dynamic_nearest_time(
            jnp.asarray(x[row:row + 1]), jnp.int32(v_src[row]),
            jnp.int32(v_dst[row]), T))
        np.testing.assert_array_equal(_nhwc(got[row:row + 1]), ref)


def test_nearest_rules_tie_as_sos_tpu():
    """`sos_tpu`'s two nearest-resize rules part at a tie: the fixed-shape
    (exact mode) index floor(j * (in / out)) in float64, the bucketed
    mode's floor(j * in / out) in integers. A 10.09 s utterance (894 STFT
    frames, 302 video frames) has one at j = 151: 446 against 447, so
    the two modes' detector confidences differ at that frame (a
    seed-0 utterance of scripts/int8_bucket_seeds.py). The port keeps
    both rules as they are."""
    from sos_tpu.ops.resize import _nearest_indices as jax_nearest_indices
    from sos_tpu_torch.ops.resize import nearest_index_tensor

    fixed = nearest_index_tensor(894, 302, torch.device("cpu"))
    assert fixed.tolist() == jax_nearest_indices(894, 302).tolist()
    x = torch.arange(894, dtype=torch.float32).reshape(1, 1, 1, 894)
    dyn = dynamic_nearest_time(x, torch.tensor([894]), torch.tensor([302]),
                               302)
    ref = np.asarray(jax_dynamic_nearest_time(
        jnp.asarray(x.numpy().reshape(1, 1, 894, 1)), jnp.int32(894),
        jnp.int32(302), 302)).reshape(-1)
    np.testing.assert_array_equal(dyn.reshape(-1).numpy(), ref)
    assert (int(fixed[151]), int(dyn[0, 0, 0, 151])) == (446, 447)
    differ = (fixed != dyn.reshape(-1).long()).nonzero().reshape(-1)
    assert differ.tolist() == [151]


def _buffers(lengths, bucket_t):
    """The bucketed predictors' buffers: reflect pad, zero extension."""
    hop, n_fft = 158, 510
    need = (bucket_t - 1) * hop + n_fft
    rng = np.random.default_rng(len(lengths))
    out = np.zeros((len(lengths), need), np.float32)
    for row, n in enumerate(lengths):
        y = (rng.standard_normal(n) * 0.3).astype(np.float32)
        r = np.pad(y, n_fft // 2, mode="reflect")
        out[row, :min(len(r), need)] = r[:need]
    return out


def test_stft_center_false_matches_sos_tpu():
    buf = _buffers((31, 3000, 20000, (64 - 1) * 158), 64)
    got = tstft.stft(torch.from_numpy(buf), center=False)
    ref = np.asarray(jstft.stft(jnp.asarray(buf), center=False))
    assert got.shape == ref.shape == (4, 256, 64, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_istft_valid_t_matches_sos_tpu():
    rng = np.random.default_rng(7)
    spec = rng.standard_normal((4, 256, T, 2)).astype(np.float32)
    before = dict(LAUNCHES)
    got = tstft.istft(torch.from_numpy(spec), valid_t=torch.tensor(VALID))
    assert LAUNCHES == before  # plain on the CPU
    for row, v in enumerate(VALID):
        ref = np.asarray(jstft.istft(jnp.asarray(spec[row:row + 1]),
                                     valid_t=jnp.int32(v)))
        np.testing.assert_allclose(got[row:row + 1].numpy(), ref,
                                   atol=1e-4, rtol=1e-4)


def test_crm_istft_plain_valid_t_matches_sos_tpu():
    rng = np.random.default_rng(8)
    spec = (rng.standard_normal((4, T, 512)) * 0.5).astype(np.float32)
    crm = rng.uniform(0.01, 0.99, (4, T, 512)).astype(np.float32)
    got = tstft.crm_istft(torch.from_numpy(crm), torch.from_numpy(spec),
                          valid_t=torch.tensor(VALID))
    for row, v in enumerate(VALID):
        s, c = jnp.asarray(spec[row:row + 1]), jnp.asarray(crm[row:row + 1])
        rr = jcrm.crm_sigmoid_recover(c[..., :256])
        ri = jcrm.crm_sigmoid_recover(c[..., 256:])
        mr, mi = s[..., :256], s[..., 256:]
        out = jnp.stack([rr * mr - ri * mi, rr * mi + ri * mr], axis=-1)
        ref = np.asarray(jstft.istft(jnp.swapaxes(out, -3, -2),
                                     valid_t=jnp.int32(v)))
        np.testing.assert_allclose(got[row:row + 1].numpy(), ref,
                                   atol=1e-4, rtol=1e-4)


def test_bilstm_per_row_valid_len_matches_sos_tpu():
    b, c, h = len(VALID), 12, 8
    rng = np.random.default_rng(11)
    bound = 1.0 / np.sqrt(h)
    u = lambda *shape: rng.uniform(-bound, bound, shape).astype(np.float32)
    params = {}
    for d in ("fwd", "bwd"):
        params[f"w_ih_{d}"], params[f"w_hh_{d}"] = u(c, 4 * h), u(h, 4 * h)
        params[f"b_ih_{d}"], params[f"b_hh_{d}"] = u(4 * h), u(4 * h)
    x = rng.standard_normal((b, T, c)).astype(np.float32)
    model = tlstm.BiLSTM(c, h)
    model.load_state_dict(bilstm_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), valid_len=torch.tensor(VALID)).numpy()
    for row, v in enumerate(VALID):
        ref = np.asarray(JaxBiLSTM(hidden=h).apply(
            {"params": params}, jnp.asarray(x[row:row + 1]),
            valid_len=jnp.int32(v)))
        np.testing.assert_allclose(got[row:row + 1], ref, atol=1e-5)
        assert not got[row, v:].any()


def test_lstm_scan_per_row_mask_matches_sos_tpu():
    rng = np.random.default_rng(12)
    xp = rng.standard_normal((T, 4, 16)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (4, 16)) / 2).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.asarray(VALID)[None]).astype(np.float32)
    got = tlstm.lstm_scan(torch.from_numpy(xp), torch.from_numpy(w_hh),
                          reverse=True, step_mask=torch.from_numpy(mask))
    for row in range(4):
        ref = np.asarray(jax_lstm_scan(
            jnp.asarray(xp[:, row:row + 1]), jnp.asarray(w_hh), reverse=True,
            step_mask=jnp.asarray(mask[:, row])))
        np.testing.assert_allclose(got[:, row:row + 1].numpy(), ref, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    cfg, port_cfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=13)
    return cfg, port_cfg, det_vars, den_vars


BUCKET = 64
LENGTHS = ((BUCKET - 1) * 158, 200, 158, 5000)  # 64, 2, 2 and 32 frames


def _specs():
    buf = _buffers(LENGTHS, BUCKET)
    spec = np.array(jstft.stft(jnp.asarray(buf), center=False))
    valid_t = np.asarray([1 + n // 158 for n in LENGTHS])
    return spec, valid_t


def test_detector_valid_t_matches_sos_tpu(models):
    cfg, port_cfg, det_vars, _ = models
    spec, valid_t = _specs()
    frames = np.asarray([64, 1, 2, 11])  # the last row's stream is short
    model = SilenceDetector(port_cfg.detector)
    model.load_state_dict(detector_from_jax(det_vars))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(spec), 64,
                           valid_t=torch.from_numpy(valid_t),
                           valid_frames=torch.from_numpy(frames)).numpy()
    jmodel = JaxSilenceDetector(cfg.detector)
    for row in range(len(LENGTHS)):
        ref = np.asarray(jmodel.apply(
            det_vars, jnp.asarray(spec[row:row + 1]), num_frames=64,
            valid_t=jnp.int32(valid_t[row]),
            valid_frames=jnp.int32(frames[row])))
        np.testing.assert_allclose(got[row:row + 1, :frames[row]],
                                   ref[:, :frames[row]], atol=5e-5, rtol=1e-4)


def test_joint_denoiser_valid_t_matches_sos_tpu(models):
    cfg, port_cfg, _, den_vars = models
    spec, valid_t = _specs()
    gated = spec * np.random.default_rng(14).uniform(0, 1, spec.shape).astype(np.float32)
    model = JointDenoiser(port_cfg.denoiser)
    model.load_state_dict(denoiser_from_jax(den_vars))
    with torch.no_grad():
        noise, crm = model.eval()(torch.from_numpy(spec),
                                  torch.from_numpy(gated),
                                  valid_t=torch.from_numpy(valid_t))
    jmodel = JaxJointDenoiser(cfg.denoiser)
    for row, v in enumerate(valid_t):
        ref_noise, ref_crm = jmodel.apply(
            den_vars, jnp.asarray(spec[row:row + 1]),
            jnp.asarray(gated[row:row + 1]), valid_t=jnp.int32(v))
        np.testing.assert_allclose(noise[row:row + 1, :, :v].numpy(),
                                   np.asarray(ref_noise)[:, :, :v],
                                   atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(crm[row:row + 1, :, :v].numpy(),
                                   np.asarray(ref_crm)[:, :, :v],
                                   atol=1e-4, rtol=1e-3)
