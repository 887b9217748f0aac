"""The port at STFT geometries other than the default (n_fft 510, hop
158, win 400), against `sos_tpu` on the CPU.

* `stft_cat_plain`, `stft` (centered and `center=False`), `istft` and
  `crm_istft_plain` (with and without `valid_t`) at five geometries, odd
  n_fft among them: the STFT within atol 1e-4 (the spectra reach ~40),
  the iSTFT within atol 1e-5 + rtol 1e-5, the cRM recover + iSTFT within
  atol 1e-4 + rtol 1e-4, the kernels' bound (a recovered cRM reaches
  +-46, and fp32 sums of such terms in another order move ~3e-5);
* the f32 `FusedDenoisePipeline` at (1022, 256, 1022) with 512 bins at
  the tiny widths, on 1 s clips: bits equal (the JAX run's sigmoids checked clear of
  the threshold), waveform within 1e-5;
* which kernel instance each geometry launches on a card (`kernel_instance`:
  the prime-factor FFT at the default, the "fft" instance where the
  transform factors, the dense generic one elsewhere), checked without a
  card.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sos_tpu.config import StftConfig as JaxStftConfig
from sos_tpu.infer.fused import FusedDenoisePipeline as JaxPipeline
from sos_tpu.models import SilenceDetector as JaxSilenceDetector
from sos_tpu_torch.config import ExperimentConfig as PortConfig
from sos_tpu_torch.dsp import stft as pstft
from sos_tpu_torch.infer.fused import FusedDenoisePipeline
from sos_tpu_torch.kernels import LAUNCHES

from tests.torch_port_fixtures import (make_clips, oracle_variables,
                                       port_states, tiny_configs)

jstft = importlib.import_module("sos_tpu.dsp.stft")
jcrm = importlib.import_module("sos_tpu.dsp.crm")

SECOND = 14000
GEOMETRIES = [(511, 158, 400), (512, 128, 512), (1022, 256, 1022),
              (254, 64, 254), (400, 100, 300)]


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(7)
    y = (rng.standard_normal((2, 14097)) * 0.3).astype(np.float32)
    y[:, :300:17] += 3.0  # spikes where the reflect padding reads
    return y


@pytest.mark.parametrize("n_fft,hop,win", GEOMETRIES)
def test_stft_matches_sos_tpu(signals, n_fft, hop, win):
    ref = np.asarray(jstft.stft(jnp.asarray(signals), n_fft, hop, win))
    got = pstft.stft(torch.from_numpy(signals), n_fft, hop, win).numpy()
    assert got.shape == ref.shape == (2, n_fft // 2 + 1,
                                      1 + 14097 // hop, 2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    cat = pstft.stft_cat_plain(torch.from_numpy(signals), n_fft, hop, win)
    np.testing.assert_array_equal(cat.numpy()[..., :n_fft // 2 + 1],
                                  got[..., 0].transpose(0, 2, 1))
    # center=False over the buffer as given
    ref = np.asarray(jstft.stft(jnp.asarray(signals), n_fft, hop, win,
                                center=False))
    got = pstft.stft(torch.from_numpy(signals), n_fft, hop, win,
                     center=False).numpy()
    assert got.shape == ref.shape and got.shape[2] == 1 + (14097 - n_fft) // hop
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("geometry,length", [((511, 100, 400), 28000),
                                             ((511, 64, 511), 256)])
def test_odd_n_fft_frame_count_matches_sos_tpu(geometry, length):
    """Odd n_fft where the hop divides the length: the centered STFT has
    1 + (L - 1) // hop frames in `sos_tpu`, in the plain version and in
    the count the card path allocates (`stft_num_frames`)."""
    n_fft, hop, win = geometry
    y = np.random.default_rng(length).standard_normal((1, length)).astype(
        np.float32)
    ref = np.asarray(jstft.stft(jnp.asarray(y), n_fft, hop, win))
    got = pstft.stft(torch.from_numpy(y), n_fft, hop, win).numpy()
    frames = 1 + (length - 1) // hop
    assert got.shape == ref.shape == (1, n_fft // 2 + 1, frames, 2)
    assert pstft.stft_num_frames(length, n_fft, hop) == frames
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_bucket_buffer_frames_at_odd_n_fft():
    """The length-bucketed predictors' framing (`bucket_buffer`, then
    `center=False`) at odd n_fft where the hop divides the length: the
    centered STFT's frames, then the one more that the predictors' (and
    `sos_tpu`'s) count `1 + L // hop` takes from the zero extension."""
    from sos_tpu_torch.infer.detect import bucket_buffer

    n_fft, hop, win, length = 511, 100, 400, 28000
    y = np.random.default_rng(3).standard_normal(length).astype(np.float32)
    valid_t = 1 + length // hop
    buf = bucket_buffer(y, n_fft, (valid_t - 1) * hop + n_fft)
    assert np.all(buf[length + n_fft - 1:] == 0)
    framed = pstft.stft_cat_plain(torch.from_numpy(buf), n_fft, hop, win,
                                  center=False)
    centered = pstft.stft_cat_plain(torch.from_numpy(y), n_fft, hop, win)
    assert framed.shape[0] == valid_t == centered.shape[0] + 1
    np.testing.assert_allclose(framed[:-1].numpy(), centered.numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_fft,hop,win", GEOMETRIES)
def test_istft_and_crm_istft_match_sos_tpu(signals, n_fft, hop, win):
    spec = np.asarray(jstft.stft(jnp.asarray(signals), n_fft, hop, win))
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop, win))
    got = pstft.istft(torch.from_numpy(spec.copy()), n_fft, hop, win).numpy()
    frames = spec.shape[2]
    assert got.shape == ref.shape == (2, (frames - 1) * hop + n_fft % 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # the cRM recover + iSTFT (K3's plain version), with a valid frame
    # count per row as the length-bucketed denoiser has (sos_tpu vmaps
    # its istft over the rows)
    crm = np.random.default_rng(n_fft).uniform(
        0.01, 0.99, spec.shape).astype(np.float32)
    rec = np.asarray(jcrm.apply_compressed_crm(jnp.asarray(spec),
                                               jnp.asarray(crm)))
    packed = [torch.from_numpy(np.concatenate([a[..., 0], a[..., 1]], 1)
                               .transpose(0, 2, 1).copy())
              for a in (crm, spec)]
    for valid_t in (None, (frames, frames // 3)):
        if valid_t is None:
            want = np.asarray(jstft.istft(jnp.asarray(rec), n_fft, hop, win))
        else:
            want = np.stack([np.asarray(jstft.istft(
                jnp.asarray(rec[i]), n_fft, hop, win,
                valid_t=jnp.asarray(v))) for i, v in enumerate(valid_t)])
        got = pstft.crm_istft_plain(
            *packed, n_fft, hop, win,
            valid_t=None if valid_t is None else torch.tensor(valid_t))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_kernel_instance_by_geometry():
    """On a card the default geometry launches its prime-factor FFT; a
    geometry whose transform splits into odd prime powers <= 73 and a
    power of two, n_fft <= 2048, the "fft" instance; every other one the
    generic dense instance (never the plain path)."""
    assert pstft.kernel_instance(510, 158, 400) == "pfa"
    fft = {(1022, 256, 1022): (7, 73), (511, 158, 400): (7, 73),
           (512, 128, 512): (256,), (400, 100, 300): (8, 25),
           (510, 158, 510): (3, 5, 17), (510, 159, 400): (3, 5, 17),
           (2048, 512, 2048): (1024,)}
    for geometry, factors in fft.items():
        assert pstft.kernel_instance(*geometry) == "fft"
        assert pstft.fft_factors(geometry[0]) == factors
    # 127 and 89 are primes above 73; 4100 (2 * 25 * 41) is over the cap;
    # at hop 1 a K3 block cannot hold the 1,022 frames of one hop
    for geometry in [(254, 64, 254), (178, 64, 178), (4100, 1024, 4100),
                     (1022, 1, 1022)]:
        assert pstft.kernel_instance(*geometry) == "generic"
    assert pstft.fft_factors(254) is None and pstft.fft_factors(178) is None
    assert pstft.fft_factors(4100) == (2, 25, 41)
    assert pstft.fft_launch_shape(1022, 1) is None


def _geometry_configs(n_fft, hop, win):
    cfg, _ = tiny_configs()
    bins = n_fft // 2 + 1
    cfg = dataclasses.replace(
        cfg, stft=JaxStftConfig(n_fft, hop, win),
        detector=dataclasses.replace(cfg.detector, freq_bins=bins),
        denoiser=dataclasses.replace(cfg.denoiser, freq_bins=bins))
    return cfg, PortConfig.from_json(cfg.to_json())


def test_fused_f32_at_another_geometry_matches_sos_tpu():
    """Random detectors give one bit at this geometry whatever the head's
    scale, so the threshold sits in the widest gap of sos_tpu's middle
    confidences, more than 1e-4 from each."""
    cfg, port_cfg = _geometry_configs(1022, 256, 1022)
    assert port_cfg.stft.n_fft == 1022 and port_cfg.denoiser.freq_bins == 512
    det_vars, den_vars = oracle_variables(cfg, seed=2)
    det_state, den_state = port_states(det_vars, den_vars)
    clips = make_clips(2, seed=22)[:, :SECOND]  # 1 s clips: 30 bits
    probs = np.sort(np.asarray(jax.nn.sigmoid(JaxSilenceDetector(
        cfg.detector).apply(det_vars, jstft.stft(jnp.asarray(clips), 1022,
                                                  256, 1022),
                            num_frames=30))).ravel())
    mid = probs[probs.size // 4: 3 * probs.size // 4 + 1]
    gap = int(np.diff(mid).argmax())
    threshold = float(mid[gap] + mid[gap + 1]) / 2
    assert mid[gap + 1] - mid[gap] > 2e-4
    ref_y, ref_bits = (np.asarray(a) for a in JaxPipeline(
        cfg, det_vars, den_vars, threshold=threshold, clip_seconds=1.0)(clips))
    before = dict(LAUNCHES)
    y, bits = FusedDenoisePipeline(port_cfg, det_state, den_state,
                                   threshold=threshold, clip_seconds=1.0,
                                   device="cpu")(clips)
    assert LAUNCHES == before  # device="cpu": plain versions only
    assert 0 < ref_bits.sum() < ref_bits.size
    np.testing.assert_array_equal(bits.numpy(), ref_bits)
    assert bits.shape == (2, 30)
    assert y.shape == ref_y.shape == (2, 54 * 256)
    np.testing.assert_allclose(y.numpy(), ref_y, atol=1e-5, rtol=0)
