"""Port int8 profile (`sos_tpu_torch.models.quant`, `ops.int8_conv`,
`ops.int8_gemm` and `FusedDenoisePipeline(profile="int8")`) against
`sos_tpu.models.quant` on the CPU, at the tiny widths of
tests/torch_port_fixtures.py.

Tolerances:
* folded int8 weights, dequant scales, biases and PReLU slopes are
  bit-identical (the same numpy host code folds them);
* one int8 block, given the same scales, gives the same int8 output as
  sos_tpu, up to 1 LSB on at most 0.1 % of elements: XLA on the CPU may
  contract `acc * w_s + b` into an FMA, which the port's plain version
  (and its kernel) never does, so a value on a rounding boundary can
  land one step apart;
* detector logits and the compressed cRM within atol 5e-3, the int8
  budget of sos_tpu's own tests/test_quant.py;
* the fused int8 pipeline: bits equal wherever sos_tpu's sigmoid is more
  than 1e-3 from the threshold, the waveform within atol 5e-3;
* self-calibrated scales within rtol 1e-5 (the float calibration convs
  sum in another order); scales carried by a calibration file are equal;
* the "bfloat16" InpaintNet mode (`QuantizedDenoiser(inpaint_dtype=
  "bfloat16")`: int8 trunks, a float InpaintNet in bf16): the compressed
  cRM within 5e-3 of `sos_tpu`'s same mode (both self-calibrate on the
  same batch) and within 5e-3 of the port's f32 `JointDenoiser` (the
  bound of sos_tpu's own test of this mode, tests/test_quant.py:149).
"""

import importlib
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from sos_tpu.infer.fused import FusedDenoisePipeline as JaxPipeline
from sos_tpu.models.quant import QuantizedDenoiser as JaxQuantDenoiser
from sos_tpu.models.quant import QuantizedDetector as JaxQuantDetector
from sos_tpu.models.quant import _conv_same
from sos_tpu_torch.infer.fused import FusedDenoisePipeline
from sos_tpu_torch.kernels import LAUNCHES
from sos_tpu_torch.models import JointDenoiser
from sos_tpu_torch.models.quant import (QuantizedDenoiser, QuantizedDetector,
                                        load_persisted_calibration,
                                        parse_calibration_file)
from sos_tpu_torch.ops.int8_conv import (conv_same_int8, inpaint_conv_int8,
                                         pack_weight, unpack_weight)
from sos_tpu_torch.ops.int8_gemm import (int8_matmul, int8_matmul_nt,
                                         int8_matmul_plain)

from tests.torch_port_fixtures import (make_clips, oracle_variables,
                                       port_states, tiny_configs)

jstft = importlib.import_module("sos_tpu.dsp.stft")
BUDGET = 5e-3  # sos_tpu tests/test_quant.py:100


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def env():
    cfg, port_cfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=1)
    # a sharper detector head, so random weights give mixed bits
    fc2 = det_vars["params"]["fc2"]
    fc2["kernel"], fc2["bias"] = fc2["kernel"] * 40, fc2["bias"] * 40
    det_state, den_state = port_states(det_vars, den_vars)
    clips = make_clips(2, seed=22)
    return cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips


@pytest.fixture(scope="module")
def quants(env):
    """sos_tpu's quant models self-calibrated on the clips' spectrum, and
    the port's loaded with the same scales."""
    cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips = env
    spec = jstft.stft(jnp.asarray(clips))
    jq = JaxQuantDenoiser(cfg.denoiser, den_vars)
    jq.calibrate([(spec, spec)])
    jd = JaxQuantDetector(cfg.detector, det_vars)
    jd.calibrate([spec])
    pq = QuantizedDenoiser(port_cfg.denoiser, den_state, device="cpu")
    pq.load_calibration(jq.calibration_state())
    pd = QuantizedDetector(port_cfg.detector, det_state, device="cpu")
    pd.load_calibration(jd.calibration_state())
    return jq, jd, pq, pd


def _assert_within_one_lsb(got: np.ndarray, ref: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size, np.count_nonzero(diff)


def test_folded_int8_weights_bit_identical(quants):
    jq, jd, pq, pd = quants
    for jenc, penc in ((jq.enc_x, pq.enc_x), (jq.enc_n, pq.enc_n),
                       (jd.enc, pd.enc)):
        assert len(jenc.blocks) == len(penc.blocks)
        for (jw, js, jb, jr), (pw, ps, pb, pr) in zip(jenc.blocks,
                                                      penc.blocks):
            jw = np.asarray(jw)
            kh, kw, cin, _ = jw.shape
            assert jr == pr
            oihw = unpack_weight(pw, kh, kw, cin).to(torch.int8).numpy()
            assert np.array_equal(oihw, jw.transpose(3, 2, 0, 1))
            assert np.array_equal(ps.numpy(), np.asarray(js))
            assert np.array_equal(pb.numpy(), np.asarray(jb))
    for name, kind, k, _, _ in pq.qinpaint.SPEC:
        jw, js, jb, alpha = jq.qinpaint.blocks[name]
        pw, ps, pb, palpha = pq.qinpaint.blocks[name]
        jw = np.asarray(jw)
        flipped = jw[::-1, ::-1] if kind == "up" else jw
        oihw = unpack_weight(pw, k, k, jw.shape[2]).to(torch.int8).numpy()
        assert np.array_equal(oihw, flipped.transpose(3, 2, 0, 1)), name
        assert np.array_equal(ps.numpy(), np.asarray(js)), name
        assert np.array_equal(pb.numpy(), np.asarray(jb)), name
        assert palpha.item() == np.float32(alpha), name
    assert np.array_equal(pq.qinpaint.out_kernel.numpy(),
                          np.asarray(jq.qinpaint.out_kernel).transpose(3, 2, 0, 1))


def _rand_int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape,
                                                dtype=np.int8)


@pytest.mark.parametrize("block", [1, 2])
def test_encoder_block_int8_matches_sos_tpu(quants, block):
    """One encoder block (K6's plain version; block 2 is the 1x1 proj
    with its float32 output) against `_conv_same` + sos_tpu's epilogue."""
    jq, _, pq, _ = quants
    jw, js, jb, requant = jq.enc_x.blocks[block]
    pw, ps, pb, _ = pq.enc_x.blocks[block]
    ks, dil = (list(zip(jq.cfg.kernel_sizes, jq.cfg.dilations))
               + [((1, 1), (1, 1))])[block]
    x = _rand_int8((2, 64, 40, np.asarray(jw).shape[2]), seed=30 + block)
    acc = _conv_same(jnp.asarray(x), jw, dil, ks, jnp.int32)
    y = jnp.maximum(acc.astype(jnp.float32) * js[None, None, None, :] + jb,
                    0.0)
    got = conv_same_int8(_t(x), pw, ps, pb, ks, dil, out_f32=not requant)
    if requant:
        ref = np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))
        assert got.dtype == torch.int8
        _assert_within_one_lsb(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name,shape", [("a_d1", (2, 64, 40, 4)),
                                        ("mid_dil2", (2, 16, 12, 8)),
                                        ("mid_dil16", (2, 40, 20, 8)),
                                        ("mid_up", (2, 16, 12, 8))])
def test_inpaint_block_int8_matches_sos_tpu(quants, name, shape):
    """One InpaintNet block (K7's plain version) against sos_tpu's
    `_inpaint_block_int8`: reflect-padded strided/dilated down convs and
    the lhs-dilated transposed up conv."""
    jq, _, pq, _ = quants
    x = _rand_int8(shape, seed=40)
    ref = np.asarray(jq._inpaint_block_int8(name, jnp.asarray(x)))
    got = pq._inpaint_block_int8(name, _t(x))
    assert got.dtype == torch.int8 and got.shape == ref.shape
    _assert_within_one_lsb(got.numpy(), ref)


def test_up_block_equals_conv_transpose(quants):
    """The lhs-dilated gather form of the up block is the reference's
    ConvTranspose2d(k3, s2, p1, output_padding=1), exactly."""
    _, _, pq, _ = quants
    w, w_s, b, alpha = pq.qinpaint.blocks["mid_up"]
    x = _t(_rand_int8((2, 9, 7, 8), seed=41))
    got = inpaint_conv_int8(x, w, w_s, b, alpha, "up", 3, 2, 1)
    w_io = unpack_weight(w, 3, 3, 8).flip(2, 3).transpose(0, 1)  # (I, O, k, k)
    acc = F.conv_transpose2d(x.permute(0, 3, 1, 2).double(), w_io, stride=2,
                             padding=1, output_padding=1)
    y = acc.permute(0, 2, 3, 1).float() * w_s + b
    y = torch.where(y >= 0, y, alpha * y)
    ref = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    assert got.shape == (2, 18, 14, 6)
    assert torch.equal(got, ref)


def test_detector_logits_packed_within_int8_budget(env, quants):
    _, _, _, _, _, _, clips = env
    _, jd, _, pd = quants
    mr, mi = jstft.stft_packed(jnp.asarray(clips))
    ref = np.asarray(jd.logits_packed(mr, mi, 60))
    got = pd.logits_packed(_t(mr), _t(mi), 60)
    err = float(np.abs(got.numpy() - ref).max())
    print(f"int8 detector logits: max |port - sos_tpu| {err:.3e}")
    assert got.shape == (2, 60) and err <= BUDGET


def test_denoiser_crm_packed_within_int8_budget(env, quants):
    _, _, _, _, _, _, clips = env
    jq, _, pq, _ = quants
    gated = clips * (np.arange(clips.shape[1]) % 7000 < 3500)
    mr, mi = jstft.stft_packed(jnp.asarray(clips))
    gr, gi = jstft.stft_packed(jnp.asarray(gated))
    ref = [np.asarray(a) for a in jq.crm_packed(mr, mi, gr, gi)]
    got = pq.crm_packed(_t(mr), _t(mi), _t(gr), _t(gi))
    err = max(float(np.abs(g.numpy() - r).max()) for g, r in zip(got, ref))
    print(f"int8 cRM: max |port - sos_tpu| {err:.3e}")
    assert got[0].shape == ref[0].shape == (2, 178, 256) and err <= BUDGET


def test_denoiser_call_layouts_match(env, quants):
    """`__call__` on sos_tpu's (B, F, T, 2) spectra returns the same
    (noise_pred, crm) as sos_tpu's."""
    _, _, _, _, _, _, clips = env
    jq, _, pq, _ = quants
    spec = jstft.stft(jnp.asarray(clips))
    gated = jstft.stft(jnp.asarray(clips[:, ::-1].copy()))
    ref_n, ref_c = (np.asarray(a) for a in jq(spec, gated))
    got_n, got_c = pq(_t(spec), _t(gated))
    assert got_n.shape == ref_n.shape and got_c.shape == ref_c.shape
    np.testing.assert_allclose(got_c.numpy(), ref_c, atol=BUDGET)
    np.testing.assert_allclose(got_n.numpy(), ref_n, atol=5e-2)


@pytest.fixture(scope="module")
def int8_pair(env, tmp_path_factory):
    """sos_tpu's int8 pipeline self-calibrates and writes its scale file;
    the port's pipeline loads that file."""
    cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips = env
    path = str(tmp_path_factory.mktemp("calib") / "int8_calibration.json")
    jax_pipe = JaxPipeline(cfg, det_vars, den_vars, profile="int8",
                           calibration_path=path)
    ref = [np.asarray(a) for a in jax_pipe(clips)]
    port = FusedDenoisePipeline(port_cfg, det_state, den_state,
                                profile="int8", calibration_path=path,
                                device="cpu")
    return jax_pipe, port, ref, path


def _jax_margin(jax_pipe, clips, num_frames=60):
    mr, mi = jstft.stft_packed(jnp.asarray(clips))
    logits = jax_pipe._quant_det.logits_packed(mr, mi, num_frames)
    return np.abs(np.asarray(jax.nn.sigmoid(logits)) - jax_pipe.threshold)


def test_fused_int8_matches_sos_tpu(env, int8_pair):
    clips = env[-1]
    jax_pipe, port, (ref_y, ref_bits), _ = int8_pair
    assert port.ensure_calibrated()
    before = dict(LAUNCHES)
    y, bits = port(clips)
    assert LAUNCHES == before  # device="cpu": plain versions only
    assert 0 < ref_bits.sum() < ref_bits.size
    clear = _jax_margin(jax_pipe, clips) > 1e-3
    np.testing.assert_array_equal(bits.numpy()[clear], ref_bits[clear])
    if not np.array_equal(bits.numpy(), ref_bits):
        y = port.denoise_with_bits(clips, ref_bits)
    assert y.shape == ref_y.shape == (2, 27966)
    err = float(np.abs(y.numpy() - ref_y).max())
    print(f"int8 pipeline waveform: max |port - sos_tpu| {err:.3e}")
    assert err <= BUDGET


def test_fused_int8_split_entries_match_sos_tpu(env, int8_pair):
    clips = env[-1]
    jax_pipe, port, _, _ = int8_pair
    ref_bits = np.asarray(jax_pipe.detect_bits(clips))
    clear = _jax_margin(jax_pipe, clips) > 1e-3
    bits = port.detect_bits(clips).numpy()
    np.testing.assert_array_equal(bits[clear], ref_bits[clear])
    other = (np.random.default_rng(26).random((2, 60)) < 0.5
             ).astype(np.float32)
    ref = np.asarray(jax_pipe.denoise_with_bits(clips, other))
    got = port.denoise_with_bits(clips, other).numpy()
    np.testing.assert_allclose(got, ref, atol=BUDGET)


def test_calibration_file_written_by_sos_tpu_loads_in_port(int8_pair):
    jax_pipe, port, _, path = int8_pair
    assert port.ensure_calibrated()  # loads the file sos_tpu wrote
    state, problem = parse_calibration_file(path)
    assert problem is None
    assert port._quant.calibration_state() == state["denoiser"]
    assert port._quant_det.calibration_state() == state["detector"]
    assert jax_pipe._quant.calibration_state() == state["denoiser"]


def test_calibration_file_written_by_port_loads_in_sos_tpu(env, tmp_path):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips = env
    path = str(tmp_path / "port_calibration.json")
    port = FusedDenoisePipeline(port_cfg, det_state, den_state,
                                profile="int8", calibration_path=path,
                                device="cpu")
    port.detect_bits(clips)  # the first batch calibrates and publishes
    with open(path) as fp:
        state = json.load(fp)
    assert set(state) == {"denoiser", "detector"}
    jax_pipe = JaxPipeline(cfg, det_vars, den_vars, profile="int8",
                           calibration_path=path)
    assert jax_pipe.ensure_calibrated()
    assert jax_pipe._quant.calibration_state() == state["denoiser"]
    assert jax_pipe._quant_det.calibration_state() == state["detector"]
    assert port._quant.calibration_state() == state["denoiser"]


def _flat_scales(state):
    den, det = state["denoiser"], state["detector"]
    return np.array(den["enc_x"] + den["enc_n"] + det["conv"]
                    + [den["inpaint"][k] for k in sorted(den["inpaint"])])


def test_self_calibrated_scales_agree(env):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state, clips = env
    jax_pipe = JaxPipeline(cfg, det_vars, den_vars, profile="int8")
    jax_pipe.detect_bits(clips)
    port = FusedDenoisePipeline(port_cfg, det_state, den_state,
                                profile="int8", device="cpu")
    assert not port.ensure_calibrated()
    port.detect_bits(clips)
    ref = {"denoiser": jax_pipe._quant.calibration_state(),
           "detector": jax_pipe._quant_det.calibration_state()}
    got = {"denoiser": port._quant.calibration_state(),
           "detector": port._quant_det.calibration_state()}
    assert sorted(got["denoiser"]["inpaint"]) == sorted(
        ref["denoiser"]["inpaint"])
    np.testing.assert_allclose(_flat_scales(got), _flat_scales(ref),
                               rtol=1e-5, atol=0)


def test_bad_calibration_files(env, tmp_path):
    _, port_cfg, _, _, det_state, den_state, clips = env
    port = FusedDenoisePipeline(port_cfg, det_state, den_state,
                                profile="int8", device="cpu")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert not port.load_calibration_file(str(bad))
    with pytest.raises(ValueError, match="unreadable"):
        port.load_calibration_file(str(bad), strict=True)
    port.detect_bits(clips)
    good = {"denoiser": port._quant.calibration_state(),
            "detector": port._quant_det.calibration_state()}
    bad.write_text(json.dumps({"denoiser": good["denoiser"]}))
    with pytest.raises(ValueError, match="detector"):
        port.load_calibration_file(str(bad), strict=True)
    bad.write_text(json.dumps({"denoiser": {"enc_x": [1.0]},
                               "detector": good["detector"]}))
    assert not port.load_calibration_file(str(bad))
    # a rejected file leaves the scales the pipeline had
    assert port._quant.calibration_state() == good["denoiser"]
    assert port._quant_det.calibration_state() == good["detector"]


def test_int8_matmul_plain_exact():
    rng = np.random.default_rng(50)
    a = rng.integers(-127, 128, (96, 1280), dtype=np.int8)
    b = rng.integers(-127, 128, (1280, 48), dtype=np.int8)
    got = int8_matmul(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert torch.equal(got, int8_matmul_plain(_t(a), _t(b)))


def test_int8_matmul_nt_takes_b_transposed():
    rng = np.random.default_rng(52)
    a = rng.integers(-127, 128, (64, 160), dtype=np.int8)
    bt = rng.integers(-127, 128, (24, 160), dtype=np.int8)
    got = int8_matmul_nt(_t(a), _t(bt))
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ bt.astype(np.int64).T)
    assert torch.equal(got, int8_matmul(_t(a), _t(bt).t()))


def test_pack_weight_layout():
    w = _rand_int8((5, 3, 6, 4), seed=51)
    packed = pack_weight(w)
    assert packed.shape == (4, 128) and packed.dtype == torch.int8
    assert not packed[:, 90:].any()
    k = (2 * 3 + 1) * 6 + 5  # tap (2, 1), channel 5
    assert torch.equal(packed[:, k], torch.from_numpy(w[2, 1, 5]))
    assert np.array_equal(unpack_weight(packed, 5, 3, 6).to(torch.int8).numpy(),
                          w.transpose(3, 2, 0, 1))
    flipped = pack_weight(w, flip=True)
    assert torch.equal(flipped[:, 5], torch.from_numpy(w[4, 2, 5]))


def test_load_persisted_calibration(env, quants, tmp_path):
    """The standalone loader: absent file, missing key and wrong scale
    schema return False; sos_tpu's detector scales load."""
    _, port_cfg, _, _, det_state, _, _ = env
    _, jd, _, _ = quants
    path = str(tmp_path / "scales.json")
    det = QuantizedDetector(port_cfg.detector, det_state, device="cpu")
    assert not load_persisted_calibration(det, path, "detector")
    with open(path, "w") as fp:
        json.dump({"detector": jd.calibration_state()}, fp)
    assert not load_persisted_calibration(det, path, "denoiser")
    assert load_persisted_calibration(det, path, "detector")
    assert det.calibration_state() == jd.calibration_state()
    with open(path, "w") as fp:
        json.dump({"detector": {"conv": "x"}}, fp)
    fresh = QuantizedDetector(port_cfg.detector, det_state, device="cpu")
    assert not load_persisted_calibration(fresh, path, "detector")
    assert not fresh._calibrated


def test_quant_models_run_on_the_card_by_default(env, monkeypatch):
    """Like the pipeline, the int8 models default to the card and raise
    without one rather than carry on on the CPU."""
    _, port_cfg, _, _, det_state, den_state, _ = env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantizedDetector(port_cfg.detector, det_state)
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantizedDenoiser(port_cfg.denoiser, den_state)
    with pytest.raises(ValueError, match="unsupported device"):
        QuantizedDetector(port_cfg.detector, det_state, device="meta")


def test_calibrate_refuses_inputs_off_the_model_device(env):
    """calibrate raises on an input elsewhere than the model instead of
    copying it over, and leaves the model uncalibrated."""
    _, port_cfg, _, _, det_state, den_state, _ = env
    det = QuantizedDetector(port_cfg.detector, det_state, device="cpu")
    den = QuantizedDenoiser(port_cfg.denoiser, den_state, device="cpu")
    spec = torch.empty(1, 256, 178, 2, device="meta")
    with pytest.raises(ValueError, match="meta"):
        det.calibrate([spec])
    with pytest.raises(ValueError, match="meta"):
        den.calibrate([(spec, spec)])
    with pytest.raises(TypeError, match="torch.Tensor"):
        det.calibrate([np.zeros((1, 256, 178, 2), np.float32)])
    assert not det._calibrated and not den._calibrated


@pytest.fixture(scope="module")
def bf16_pair(env):
    cfg, port_cfg, _, den_vars, _, den_state, clips = env
    spec = jstft.stft(jnp.asarray(clips))
    gated = jstft.stft(jnp.asarray(clips[:, ::-1].copy()))
    jq = JaxQuantDenoiser(cfg.denoiser, den_vars, inpaint_dtype="bfloat16")
    jq.calibrate([(spec, gated)])
    pq = QuantizedDenoiser(port_cfg.denoiser, den_state,
                           inpaint_dtype="bfloat16", device="cpu")
    x, g = torch.from_numpy(np.array(spec)), torch.from_numpy(np.array(gated))
    pq.calibrate([(x, g)])
    return jq, pq, spec, gated, x, g


def test_bf16_inpaint_mode_matches_sos_tpu(bf16_pair):
    jq, pq, spec, gated, x, g = bf16_pair
    assert pq.qinpaint is None and pq.inpaint is not None
    assert pq.inpaint.dtype == torch.bfloat16
    state = pq.calibration_state()
    assert sorted(state) == sorted(jq.calibration_state()) == ["enc_n",
                                                               "enc_x"]
    np.testing.assert_allclose(state["enc_x"],
                               jq.calibration_state()["enc_x"], rtol=1e-5)
    ref_n, ref_c = (np.asarray(a) for a in jq(spec, gated))
    got_n, got_c = pq(x, g)
    assert got_c.shape == ref_c.shape and got_n.shape == ref_n.shape
    err = float(np.abs(got_c.numpy() - ref_c).max())
    print(f"bf16-InpaintNet cRM: max |port - sos_tpu| {err:.3e}")
    assert err <= BUDGET


def test_bf16_inpaint_mode_near_f32_joint_denoiser(env, bf16_pair):
    port_cfg, den_state = env[1], env[5]
    _, pq, _, _, x, g = bf16_pair
    model = JointDenoiser(port_cfg.denoiser)
    model.load_state_dict(den_state)
    with torch.no_grad():
        _, ref_c = model.eval()(x, g)
    _, got_c = pq(x, g)
    err = float((got_c - ref_c).abs().max())
    print(f"bf16-InpaintNet cRM: max |mode - f32| {err:.3e}")
    assert err < 5e-3
    with pytest.raises(ValueError, match="inpaint_dtype"):
        QuantizedDenoiser(port_cfg.denoiser, den_state, inpaint_dtype="fp8",
                          device="cpu")
