"""Port DSP (`sos_tpu_torch.dsp`) against `sos_tpu.dsp`, on the CPU.

The same numpy inputs go through both packages. Tolerances:
stft/istft atol=rtol=1e-4 (the repo's parity rule); masks exact; cRM
rtol=1e-5 + atol=1e-5. The kernels against their plain versions:
test_torch_kernels.py; their FFT algorithm on the CPU: test_torch_fft.py.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sos_tpu.dsp import crm as jcrm
from sos_tpu.dsp import mixing as jmix
from sos_tpu_torch.dsp import crm as tcrm
from sos_tpu_torch.dsp import mixing as tmix
from sos_tpu_torch.dsp import stft as tstft
from sos_tpu_torch.kernels import LAUNCHES

from tests.torch_port_fixtures import CLIP

# sos_tpu.dsp re-exports the function `stft`, which shadows the module
jstft = importlib.import_module("sos_tpu.dsp.stft")

RATIO = 14000 / 30.0


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(11).standard_normal((2, CLIP)).astype(np.float32) * 0.3


@pytest.fixture(scope="module")
def spec():
    """A random (2, 256, 178, 2) spectrogram."""
    return np.random.default_rng(12).standard_normal((2, 256, 178, 2)).astype(np.float32)


def test_dft_matrices_and_window_are_identical():
    np.testing.assert_array_equal(tstft._analysis_matrix(510, 400),
                                  jstft._analysis_matrix(510, 400))
    np.testing.assert_array_equal(tstft._synthesis_matrix(510, 400),
                                  jstft._synthesis_matrix(510, 400))
    np.testing.assert_array_equal(tstft.padded_window(), jstft.padded_window())


@pytest.mark.parametrize("length,n_fft,hop", [(1000, 510, 158), (97, 16, 5),
                                              (64, 16, 16)])
def test_frame_signal_and_overlap_add_match(length, n_fft, hop):
    y = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    frames = tstft.frame_signal(torch.from_numpy(y), n_fft, hop)
    ref = np.asarray(jstft.frame_signal(jnp.asarray(y), n_fft, hop))
    np.testing.assert_array_equal(frames.numpy(), ref)
    # same summation order as sos_tpu: bit-equal sums
    np.testing.assert_array_equal(
        tstft.overlap_add(frames.contiguous(), hop).numpy(),
        np.asarray(jstft.overlap_add(jnp.asarray(ref), hop)))


def test_stft_matches(clips):
    ref = np.asarray(jstft.stft(jnp.asarray(clips)))
    got = tstft.stft(torch.from_numpy(clips)).numpy()
    assert got.shape == ref.shape == (2, 256, 178, 2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_stft_packed_matches(clips):
    ref_re, ref_im = jstft.stft_packed(jnp.asarray(clips))
    re, im = tstft.stft_packed(torch.from_numpy(clips))
    np.testing.assert_allclose(re.numpy(), np.asarray(ref_re), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(im.numpy(), np.asarray(ref_im), atol=1e-4, rtol=1e-4)


def test_istft_matches(spec):
    ref = np.asarray(jstft.istft(jnp.asarray(spec)))
    got = tstft.istft(torch.from_numpy(spec)).numpy()
    assert got.shape == ref.shape == (2, 177 * 158)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_istft_packed_matches(spec):
    re = np.ascontiguousarray(spec[..., 0].transpose(0, 2, 1))
    im = np.ascontiguousarray(spec[..., 1].transpose(0, 2, 1))
    ref = np.asarray(jstft.istft_packed(jnp.asarray(re), jnp.asarray(im)))
    got = tstft.istft_packed(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_stft_istft_roundtrip(clips):
    y = torch.from_numpy(clips)
    back = tstft.istft(tstft.stft(y)).numpy()
    np.testing.assert_allclose(back, clips[:, :back.shape[1]], atol=1e-4)


def test_crm_recover_and_apply_match(spec):
    o = np.random.default_rng(13).uniform(0.01, 0.99, spec.shape).astype(np.float32)
    # atol: the recovered values cross zero (min |ref| is 1.26e-4), where
    # float32 rounding alone exceeds any relative tolerance
    np.testing.assert_allclose(
        tcrm.crm_sigmoid_recover(torch.from_numpy(o)).numpy(),
        np.asarray(jcrm.crm_sigmoid_recover(jnp.asarray(o))), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        tcrm.apply_compressed_crm(torch.from_numpy(spec), torch.from_numpy(o)).numpy(),
        np.asarray(jcrm.apply_compressed_crm(jnp.asarray(spec), jnp.asarray(o))),
        rtol=1e-5, atol=1e-5)  # atol: re = rr*mr - ri*mi cancels near 0


_RECOVER_IN_FRESH_PROCESS = """
import sys
import numpy as np
import torch
from sos_tpu_torch.dsp.crm import crm_sigmoid_recover
o = np.random.default_rng(13).uniform(0.01, 0.99, (2, 256, 178, 2)).astype(np.float32)
np.save(sys.argv[1], crm_sigmoid_recover(torch.from_numpy(o)).numpy())
assert "jax" not in sys.modules
"""


def test_crm_recover_same_bytes_in_fresh_processes(tmp_path):
    """The plain recover gives identical bytes in every fresh process
    (no JAX imported), each within 1e-5 of the float64 value: torch's
    CPU log once computed one thread's chunk off by up to 4e-4 on its
    first call in a process."""
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (str(repo), os.environ.get("PYTHONPATH")))))
    outs = [tmp_path / f"recover_{i}.npy" for i in range(8)]
    procs = [subprocess.Popen([sys.executable, "-c", _RECOVER_IN_FRESH_PROCESS,
                               str(out)], cwd=repo, env=env)
             for out in outs]
    assert [p.wait(timeout=120) for p in procs] == [0] * len(procs)
    o = np.random.default_rng(13).uniform(0.01, 0.99, (2, 256, 178, 2)).astype(np.float32)
    od = o.astype(np.float64)
    exact = 10.0 * np.log(od / (1.0 - od + 1e-8) + 1e-10)
    results = [np.load(out) for out in outs]
    assert results[0].dtype == np.float32 and results[0].shape == o.shape
    for got in results:
        assert got.tobytes() == results[0].tobytes()
        assert np.abs(got - exact).max() <= 1e-5
    # the same bytes in this process too
    assert (tcrm.crm_sigmoid_recover(torch.from_numpy(o)).numpy().tobytes()
            == results[0].tobytes())


def test_crm_istft_plain_uses_the_recover(monkeypatch):
    """K3's plain path recovers through `dsp/crm.py`'s function."""
    calls = []
    real = tstft.crm_sigmoid_recover
    monkeypatch.setattr(tstft, "crm_sigmoid_recover",
                        lambda o: calls.append(o.shape) or real(o))
    o = torch.full((1, 178, 512), 0.5)
    tstft.crm_istft_plain(o, torch.zeros(1, 178, 512))
    assert calls == [(1, 178, 256), (1, 178, 256)]


def test_crm_istft_matches_sos_tpu(clips):
    """K3's plain version == sos_tpu's apply_compressed_crm + istft."""
    o = np.random.default_rng(14).uniform(0.02, 0.98, (2, 178, 512)).astype(np.float32)
    mixed_cat = tstft.stft_cat(torch.from_numpy(clips))
    before = dict(LAUNCHES)
    got = tstft.crm_istft(torch.from_numpy(o), mixed_cat).numpy()
    assert LAUNCHES == before  # CPU tensors take the plain version
    crm = jnp.transpose(jnp.asarray(o).reshape(2, 178, 2, 256), (0, 3, 1, 2))
    ref = np.asarray(jstft.istft(jcrm.apply_compressed_crm(
        jstft.stft(jnp.asarray(clips)), crm)))
    assert got.shape == ref.shape == (2, 27966)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def _bit_patterns():
    rng = np.random.default_rng(15)
    yield "random", (rng.random((3, 60)) < 0.5).astype(np.float32)
    yield "silent", np.zeros((1, 60), np.float32)
    yield "voiced", np.ones((1, 60), np.float32)
    yield "alternating", (np.arange(60) % 2).astype(np.float32)[None]
    yield "pairs", ((np.arange(60) // 2) % 2).astype(np.float32)[None]


@pytest.mark.parametrize("name,bits", list(_bit_patterns()))
def test_bitstream_mask_dense_path_exact(name, bits):
    ref = np.asarray(jmix.bitstream_to_sample_mask(jnp.asarray(bits), RATIO, CLIP))
    got = tmix.bitstream_to_sample_mask(torch.from_numpy(bits), RATIO, CLIP)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("frames,samples,ratio", [
    (20, 80, 4.0),          # frame bodies shorter than min_run
    (10, 4000, RATIO),      # clipped frame bodies
])
def test_bitstream_mask_generic_despeckle_exact(frames, samples, ratio):
    assert tmix._despeckle_gap_matrix(frames, samples, ratio, 5) is None
    bits = (np.random.default_rng(frames).random((2, frames)) < 0.5).astype(np.float32)
    ref = np.asarray(jmix.bitstream_to_sample_mask(jnp.asarray(bits), ratio, samples))
    got = tmix.bitstream_to_sample_mask(torch.from_numpy(bits), ratio, samples)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_despeckle_mask_exact():
    rng = np.random.default_rng(16)
    mask = (rng.random((4, 300)) < 0.7).astype(np.float32)
    got = tmix.despeckle_mask(torch.from_numpy(mask), 5).numpy()
    for row_got, row in zip(got, mask):
        np.testing.assert_array_equal(row_got, jmix.despeckle_mask_np(row, 5))


def test_mask_gate_plain_is_mixed_times_sos_tpu_mask(clips):
    bits = (np.random.default_rng(17).random((2, 60)) < 0.5).astype(np.float32)
    before = dict(LAUNCHES)
    got = tmix.mask_gate(torch.from_numpy(clips), torch.from_numpy(bits), RATIO)
    assert LAUNCHES == before  # CPU tensors take the plain version
    mask = np.asarray(jmix.bitstream_to_sample_mask(jnp.asarray(bits), RATIO, CLIP))
    np.testing.assert_array_equal(got.numpy(), clips * mask)


def test_gate_tables_rebuild_the_dense_mask():
    """K2's host table (two int16 halves a sample), evaluated with the
    kernel's formula in numpy, gives exactly the dense-path mask (the
    kernel itself needs a card)."""
    tables = tmix._gate_tables(60, CLIP, RATIO, 5, torch.device("cpu"))
    packed = tables.words
    assert packed.dtype == torch.int32 and packed.shape == (CLIP,)
    assert not tables.despeckle
    words = packed.numpy()
    body, pair = (words << 16) >> 16, words >> 16  # the kernel's int16 halves
    assert body.dtype == pair.dtype == np.int32
    assert not np.any((body >= 0) & (pair >= 0))  # bodies and gaps disjoint
    assert pair[-1] == 59 and np.count_nonzero(body < 0) == 60
    bits = (np.random.default_rng(18).random((3, 60)) < 0.5).astype(np.float32)
    inv = 1.0 - bits
    pair_val = np.concatenate([inv[:, :-1] * inv[:, 1:], inv[:, -1:]], axis=1)
    mask = (np.where(body >= 0, inv[:, np.maximum(body, 0)], 0.0)
            + np.where(pair >= 0, pair_val[:, np.maximum(pair, 0)], 0.0))
    ref = np.asarray(jmix.bitstream_to_sample_mask(jnp.asarray(bits), RATIO, CLIP))
    np.testing.assert_array_equal(mask.astype(np.float32), ref)


def test_gate_tables_refuse_geometry_without_gap_matrix():
    """A geometry without a gap matrix (frame bodies shorter than
    min_run) no longer raises: its table selects K2's generic-despeckle
    instance and holds no gap pairs."""
    tables = tmix._gate_tables(20, 80, 4.0, 5, torch.device("cpu"))
    assert tables.despeckle and tables.rows_per_block == 8
    assert np.all(tables.words.numpy() >> 16 == -1)


def test_gather_map_path_not_ported():
    """The gather-map path past 2^24 elements (60 s: 1800 x 840000) is
    ported: the mask equals sos_tpu's exactly, and K2's table is built
    from the maps without a dense matrix."""
    bits = (np.random.default_rng(19).random((1, 1800)) < 0.5).astype(np.float32)
    got = tmix.bitstream_to_sample_mask(torch.from_numpy(bits), RATIO, 840000)
    ref = np.asarray(jmix.bitstream_to_sample_mask(jnp.asarray(bits), RATIO,
                                                   840000))
    np.testing.assert_array_equal(got.numpy(), ref)
    tables = tmix._gate_tables(1800, 840000, RATIO, 5, torch.device("cpu"))
    assert tables.words.shape == (840000,) and not tables.despeckle
