"""The int8 profile's length-bucketed (`valid_t`) path of the port
(`sos_tpu_torch.models.quant`, `ops.int8_conv`) against `sos_tpu`'s on
the CPU, at the tiny widths of tests/torch_port_fixtures.py.

`sos_tpu` takes one scalar `valid_t` a call, the port a `(B,)` tensor,
so `sos_tpu` runs one row a call and every batch mixes a full-width row,
short rows and rows of a few frames. The same numpy inputs and one scale
state go to both packages. Inputs carry nonzero values past each row's
valid width: the port must not read them where `sos_tpu` does not.

Tolerances:
* one block (K6's, K7's plain versions): the same int8 output up to
  1 LSB on at most 0.1 % of elements (XLA may contract `acc * w_s + b`
  into an FMA; the port never does: tests/test_torch_quant.py), the
  proj block's float output within 1e-6, the valid widths equal;
* models against `sos_tpu`: logits, noise and cRM within the int8
  budget 5e-3 of sos_tpu's tests/test_quant.py;
* the port bucketed against the port at the utterance's own width:
  2e-5 (logits) and 3e-5 (noise, cRM), sos_tpu's own bounds for this
  comparison (tests/test_quant.py, tests/test_infer.py);
* per-row `valid_t` in one batch against one row a call: 1e-6 (the
  float head's sums at another batch size).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sos_tpu.models.layers import reflect_time_tail as jax_reflect_tail
from sos_tpu.models.layers import zero_time_tail as jax_zero_tail
from sos_tpu.models.quant import QuantizedDenoiser as JaxQuantDenoiser
from sos_tpu.models.quant import QuantizedDetector as JaxQuantDetector
from sos_tpu.models.quant import _conv_same
from sos_tpu_torch.kernels import LAUNCHES
from sos_tpu_torch.models.quant import (QuantizedDenoiser, QuantizedDetector,
                                        _run_encoder_int8)
from sos_tpu_torch.ops import int8_conv

from tests.torch_port_fixtures import (make_clips, oracle_variables,
                                       port_states, tiny_configs)

jstft = importlib.import_module("sos_tpu.dsp.stft")
BUDGET = 5e-3  # sos_tpu tests/test_quant.py:100
T_BUCKET = 96  # the models' bucket width in frames


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _vt(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64)


@pytest.fixture(scope="module")
def quants():
    """sos_tpu's quant models self-calibrated on two clips' spectrum, the
    port's loaded with the same scales."""
    cfg, port_cfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=5)
    fc2 = det_vars["params"]["fc2"]  # a sharper head: mixed logits
    fc2["kernel"], fc2["bias"] = fc2["kernel"] * 40, fc2["bias"] * 40
    det_state, den_state = port_states(det_vars, den_vars)
    spec = jstft.stft(jnp.asarray(make_clips(2, seed=23)))
    jq = JaxQuantDenoiser(cfg.denoiser, den_vars)
    jq.calibrate([(spec, spec)])
    jd = JaxQuantDetector(cfg.detector, det_vars)
    jd.calibrate([spec])
    pq = QuantizedDenoiser(port_cfg.denoiser, den_state, device="cpu")
    pq.load_calibration(jq.calibration_state())
    pd = QuantizedDetector(port_cfg.detector, det_state, device="cpu")
    pd.load_calibration(jd.calibration_state())
    return jq, jd, pq, pd


def _rand_int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape,
                                                dtype=np.int8)


def _assert_within_one_lsb(got: np.ndarray, ref: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size, np.count_nonzero(diff)


@pytest.mark.parametrize("pad", [1, 2, 4, 16])
def test_valid_columns_are_sos_tpus_padding(pad):
    """`valid_columns` (the column rule K7's patch warp and copy pass
    apply) builds the padded time axis sos_tpu builds: the tail zeroed,
    reflect on the left, zeros on the right, `reflect_time_tail` at the
    row's boundary; with v = W, numpy's reflect."""
    wid = 40
    x = np.random.default_rng(pad).integers(-127, 128, (1, 3, wid, 2)
                                            ).astype(np.int32)
    for v in sorted({0, 1, 2, 3, pad - 1, pad, pad + 1, wid - pad - 1,
                     wid - pad, wid - 1, wid}):
        if v < 0:
            continue
        ref = jax_zero_tail(jnp.asarray(x), v)
        ref = jnp.pad(ref, ((0, 0), (0, 0), (pad, 0), (0, 0)), mode="reflect")
        ref = jnp.pad(ref, ((0, 0), (0, 0), (0, pad), (0, 0)))
        ref = np.asarray(jax_reflect_tail(ref, v, pad, offset=pad))
        idx, keep = int8_conv.valid_columns(_vt([v]), pad, wid)
        got = x[:, :, idx[0].numpy()] * keep[0].numpy()[None, None, :, None]
        np.testing.assert_array_equal(got, ref, err_msg=f"v={v}")
    idx, keep = int8_conv.valid_columns(_vt([wid]), pad, wid)
    assert keep.all()
    assert idx[0].tolist() == [abs(u) if u < wid else 2 * wid - 2 - u
                               for u in range(-pad, wid + pad)]


@pytest.mark.parametrize("block", [0, 1, 2])
def test_encoder_block_valid_t_matches_sos_tpu(quants, block):
    """One encoder block with per-row `valid_t` (K6's plain version;
    block 0 takes Cin 2, block 2 is the 1x1 proj with its float32 output)
    against `_conv_same` + `_run_encoder_int8`'s epilogue and tmask, one
    row a call. The input is taken as it is (garbage past v)."""
    jq, _, pq, _ = quants
    jw, js, jb, requant = jq.enc_x.blocks[block]
    pw, ps, pb, _ = pq.enc_x.blocks[block]
    ks, dil = (list(zip(jq.cfg.kernel_sizes, jq.cfg.dilations))
               + [((1, 1), (1, 1))])[block]
    vts = [40, 17, 1, 38]
    x = _rand_int8((4, 24, 40, np.asarray(jw).shape[2]), seed=50 + block)
    got = int8_conv.conv_same_int8(_t(x), pw, ps, pb, ks, dil,
                                   out_f32=not requant, valid_t=_vt(vts))
    for row, v in enumerate(vts):
        acc = _conv_same(jnp.asarray(x[row:row + 1]), jw, dil, ks, jnp.int32)
        y = jnp.maximum(acc.astype(jnp.float32) * js[None, None, None, :]
                        + jb, 0.0)
        tmask = (jnp.arange(40) < v)[None, None, :, None]
        if requant:
            ref = jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8)
            _assert_within_one_lsb(got[row:row + 1].numpy(),
                                   np.asarray(ref * tmask.astype(jnp.int8)))
        else:
            np.testing.assert_allclose(got[row:row + 1].numpy(),
                                       np.asarray(y * tmask), rtol=1e-6,
                                       atol=1e-6)
        assert not got[row, :, v:].any()


# (block, input NHWC shape, per-row valid widths): the Cin 2 input
# block, a strided down block, dilations 2 and 16 (v within the pad of
# the width, and v below the pad), the transposed up block
INPAINT_BLOCKS = [
    ("a_in", (3, 20, 40, 2), [40, 13, 1]),
    ("a_d1", (4, 24, 40, 4), [40, 39, 21, 2]),
    ("mid_dil2", (3, 16, 24, 8), [24, 23, 5]),
    ("mid_dil16", (4, 40, 36, 8), [36, 30, 17, 3]),
    ("mid_up", (3, 16, 12, 8), [12, 11, 1]),
    ("up1_up", (3, 12, 20, 6), [20, 7, 2]),
]


@pytest.mark.parametrize("name,shape,vts", INPAINT_BLOCKS,
                         ids=[b[0] for b in INPAINT_BLOCKS])
def test_inpaint_block_valid_t_matches_sos_tpu(quants, name, shape, vts):
    """One InpaintNet block with per-row valid widths (K7's plain
    version) against sos_tpu's `_inpaint_block_int8(name, x, v)`, one row
    a call: the same int8 output and the same propagated width."""
    jq, _, pq, _ = quants
    x = _rand_int8(shape, seed=len(name) + shape[2])
    got, v_out = pq._inpaint_block_int8(name, _t(x), _vt(vts))
    assert got.dtype == torch.int8
    for row, v in enumerate(vts):
        ref, ref_v = jq._inpaint_block_int8(name, jnp.asarray(x[row:row + 1]),
                                            v)
        assert int(v_out[row]) == int(ref_v)
        assert got[row:row + 1].shape == ref.shape
        _assert_within_one_lsb(got[row:row + 1].numpy(), np.asarray(ref))
        assert not got[row, :, int(ref_v):].any()


@pytest.mark.parametrize("kind,k,s,d", [("down", 5, 1, 1), ("down", 5, 2, 1),
                                        ("down", 3, 1, 8), ("up", 3, 2, 1)])
def test_inpaint_full_valid_width_is_the_static_block(kind, k, s, d):
    """valid_t = W on every row gives the static block's output, and
    `inpaint_valid_out` its output width."""
    gen = torch.Generator().manual_seed(k + s + d)
    x = torch.randint(-127, 128, (2, 12, 21, 16), generator=gen,
                      dtype=torch.int8)
    w = int8_conv.pack_weight(np.random.default_rng(d).integers(
        -127, 128, (k, k, 16, 8)).astype(np.int8))
    w_s, b = torch.full((8,), 1e-3), torch.linspace(-20, 20, 8)
    alpha = torch.tensor([0.25])
    ref = int8_conv.inpaint_conv_int8(x, w, w_s, b, alpha, kind, k, s, d)
    got = int8_conv.inpaint_conv_int8(x, w, w_s, b, alpha, kind, k, s, d,
                                      valid_t=_vt([21, 21]))
    assert torch.equal(got, ref)
    assert int8_conv.inpaint_valid_out(kind, k, s, d, 21) == ref.shape[2]


def test_encoder_refuses_time_take_with_valid_t(quants):
    _, _, pq, _ = quants
    x = torch.zeros(1, 8, 10, 2)
    with pytest.raises(ValueError, match="time_take"):
        _run_encoder_int8(pq.enc_x, [((1, 7), (1, 1))], x,
                          time_take=torch.arange(5), valid_t=_vt([10]))


def _specs(rows: int, t: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((rows, 256, t, 2))
            * 0.3).astype(np.float32)


DET_VTS, DET_VFS, DET_FRAMES = [96, 70, 9], [40, 30, 4], 40


def test_quantized_detector_valid_t_matches_sos_tpu(quants):
    """`QuantizedDetector(spec, frames, valid_t, valid_frames)` against
    sos_tpu's, one row a call, on each row's valid frames."""
    _, jd, _, pd = quants
    spec = _specs(3, T_BUCKET, seed=60)
    got = pd(_t(spec), DET_FRAMES, _vt(DET_VTS), _vt(DET_VFS))
    assert got.shape == (3, DET_FRAMES)
    for row, (v, vf) in enumerate(zip(DET_VTS, DET_VFS)):
        ref = np.asarray(jd(jnp.asarray(spec[row:row + 1]), DET_FRAMES,
                            valid_t=jnp.int32(v), valid_frames=jnp.int32(vf)))
        np.testing.assert_allclose(got[row, :vf].numpy(), ref[0, :vf],
                                   atol=BUDGET)


DEN_VTS = [96, 61, 20]


def test_quantized_denoiser_valid_t_matches_sos_tpu(quants):
    """`QuantizedDenoiser(mixed, gated, valid_t)` against sos_tpu's, one
    row a call: noise prediction and cRM on each row's valid frames."""
    jq, _, pq, _ = quants
    mixed, gated = _specs(3, T_BUCKET, seed=61), _specs(3, T_BUCKET, seed=62)
    noise, crm = pq(_t(mixed), _t(gated), _vt(DEN_VTS))
    for row, v in enumerate(DEN_VTS):
        rn, rc = jq(jnp.asarray(mixed[row:row + 1]),
                    jnp.asarray(gated[row:row + 1]), valid_t=jnp.int32(v))
        np.testing.assert_allclose(noise[row, :, :v].numpy(),
                                   np.asarray(rn)[0, :, :v], atol=BUDGET)
        np.testing.assert_allclose(crm[row, :, :v].numpy(),
                                   np.asarray(rc)[0, :, :v], atol=BUDGET)


def test_quantized_detector_bucketed_equals_exact(quants):
    """The port's valid_t path with garbage past each row's frames equals
    the port at the row's own width (the fixed-shape path, time_take)."""
    _, _, _, pd = quants
    spec = _specs(3, T_BUCKET, seed=63)
    vfs = [DET_FRAMES] * 3
    got = pd(_t(spec), DET_FRAMES, _vt(DET_VTS), _vt(vfs))
    for row, v in enumerate(DET_VTS):
        ref = pd(_t(spec[row:row + 1, :, :v]), DET_FRAMES)
        np.testing.assert_allclose(got[row].numpy(), ref[0].numpy(),
                                   atol=2e-5)


# widths whose static InpaintNet runs (its mid_dil16 reflect pad, 16,
# needs mid blocks wider than 16, as in sos_tpu's fixed-shape program)
EXACT_VTS = [96, 81, 66]


def test_quantized_denoiser_bucketed_equals_exact(quants):
    _, _, pq, _ = quants
    mixed, gated = _specs(3, T_BUCKET, seed=64), _specs(3, T_BUCKET, seed=65)
    noise, crm = pq(_t(mixed), _t(gated), _vt(EXACT_VTS))
    for row, v in enumerate(EXACT_VTS):
        rn, rc = pq(_t(mixed[row:row + 1, :, :v]),
                    _t(gated[row:row + 1, :, :v]))
        np.testing.assert_allclose(noise[row, :, :v].numpy(), rn[0].numpy(),
                                   atol=3e-5)
        np.testing.assert_allclose(crm[row, :, :v].numpy(), rc[0].numpy(),
                                   atol=3e-5)


def test_valid_t_rows_in_one_batch_equal_one_row_a_call(quants):
    """Per-row valid widths in one batch give each row what it gets in a
    call of its own: the rows do not see each other's widths."""
    _, _, pq, pd = quants
    spec = _specs(3, T_BUCKET, seed=66)
    mixed, gated = _specs(3, T_BUCKET, seed=67), _specs(3, T_BUCKET, seed=68)
    before = dict(LAUNCHES)
    logits = pd(_t(spec), DET_FRAMES, _vt(DET_VTS), _vt(DET_VFS))
    noise, crm = pq(_t(mixed), _t(gated), _vt(DEN_VTS))
    assert LAUNCHES == before  # CPU tensors: the plain versions
    for row in range(3):
        one = slice(row, row + 1)
        ref = pd(_t(spec[one]), DET_FRAMES, _vt(DET_VTS[one]),
                 _vt(DET_VFS[one]))
        vf = DET_VFS[row]
        np.testing.assert_allclose(logits[row, :vf].numpy(),
                                   ref[0, :vf].numpy(), atol=1e-6)
        rn, rc = pq(_t(mixed[one]), _t(gated[one]), _vt(DEN_VTS[one]))
        v = DEN_VTS[row]
        np.testing.assert_allclose(noise[row, :, :v].numpy(),
                                   rn[0, :, :v].numpy(), atol=1e-6)
        np.testing.assert_allclose(crm[row, :, :v].numpy(),
                                   rc[0, :, :v].numpy(), atol=1e-6)
