"""The training data path of the port against `sos_tpu` on the CPU:
`mix_at_snr`, the cRM compressions (sigmoid and tanh families), the
device mix + STFT stages of both stages, and the batchers (the same
batches and the same `iter_from` resumes for the same seed). Seeded
numpy inputs; tolerance atol 1e-5 (fp32 in another order), the
ground-truth cRM of the denoiser stage 5e-5 (see the test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_tpu.data import pipeline as jpipe
from sos_tpu.data.index import DatasetIndex as JaxIndex
from sos_tpu.data.sampling import NoiseBank as JaxNoiseBank
from sos_tpu.data.windows import denoiser_windows as jax_den_windows
from sos_tpu.data.windows import detector_windows as jax_det_windows
from sos_tpu.dsp import crm as jcrm
from sos_tpu.dsp import mixing as jmix
from sos_tpu_torch.data import (DatasetIndex, DenoiserBatcher, DetectorBatcher,
                                NoiseBank, denoiser_windows, detector_windows)
from sos_tpu_torch.data import pipeline as tpipe
from sos_tpu_torch.dsp import crm as tcrm
from sos_tpu_torch.dsp import mixing as tmix
from sos_tpu_torch.kernels import LAUNCHES

from tests.torch_port_fixtures import make_clips, tiny_configs, training_corpus


def _signals(seed, n=3):
    rng = np.random.default_rng(seed)
    clean = make_clips(n, seed)
    clean[-1] = 0.0  # a silent signal takes the noise unscaled
    noise = (rng.standard_normal((n, 28000)) * 0.1).astype(np.float32)
    snr = np.asarray([-5.0, 0.0, 10.0][:n], np.float32)
    bits = (rng.random((n, 60)) < 0.5).astype(np.float32)
    return clean, noise, snr, bits


@pytest.mark.parametrize("norm", [0.5, None])
def test_mix_at_snr_matches_sos_tpu(norm):
    clean, noise, snr, _ = _signals(1)
    ref = jmix.mix_at_snr(jnp.asarray(clean), jnp.asarray(noise),
                          jnp.asarray(snr), norm=norm)
    got = tmix.mix_at_snr(torch.from_numpy(clean), torch.from_numpy(noise),
                          torch.from_numpy(snr), norm=norm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    np.testing.assert_array_equal(got[2][-1].numpy(), (
        noise[-1] / (np.abs(noise[-1]).max() / norm) if norm else noise[-1]))


def test_complement_gate_is_one_minus_the_mask():
    """`mask_gate(complement=True)` (K2's complement instance; its plain
    version here) is sos_tpu's `clean * (1 - mask)`, exactly."""
    clean, _, _, bits = _signals(2)
    ratio = 14000 / 30.0
    mask = np.asarray(jmix.bitstream_to_sample_mask(jnp.asarray(bits), ratio,
                                                    28000, 5))
    before = dict(LAUNCHES)
    got = tmix.mask_gate(torch.from_numpy(clean), torch.from_numpy(bits),
                         ratio, complement=True)
    assert LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), clean * (1.0 - mask))


def _specs(seed):
    rng = np.random.default_rng(seed)
    noisy = rng.standard_normal((2, 256, 20, 2)).astype(np.float32)
    clean = (noisy * rng.uniform(-1, 1.5, noisy.shape)).astype(np.float32)
    noisy[0, :3, :2] = 0.0  # |Y| = 0: the epsilon's bins
    return noisy, clean


def test_crm_compress_family_matches_sos_tpu():
    noisy, clean = _specs(3)
    tn, tc = torch.from_numpy(noisy), torch.from_numpy(clean)
    jn, jc = jnp.asarray(noisy), jnp.asarray(clean)
    pairs = [
        (tcrm.complex_ratio_mask(tn, tc), jcrm.complex_ratio_mask(jn, jc)),
        (tcrm.compressed_crm(tc, tn), jcrm.compressed_crm(jc, jn)),
        (tcrm.compressed_crm_tanh(tc, tn), jcrm.compressed_crm_tanh(jc, jn)),
    ]
    m = tcrm.compressed_crm_tanh(tc, tn)
    pairs += [
        (tcrm.crm_tanh_recover(m), jcrm.crm_tanh_recover(jnp.asarray(m.numpy()))),
        (tcrm.apply_compressed_crm_tanh(tn, m),
         jcrm.apply_compressed_crm_tanh(jn, jnp.asarray(m.numpy()))),
        (tcrm.crm_sigmoid_compress(tc), jcrm.crm_sigmoid_compress(jc)),
        (tcrm.crm_tanh_compress(tc), jcrm.crm_tanh_compress(jc)),
    ]
    for got, ref in pairs:
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * scale)


def test_apply_compressed_crm_is_differentiable():
    """The stage-2 loss differentiates through the cRM recover (float64
    inside, torch's log where a gradient must flow): the gradient of the
    recovered spectrogram against sos_tpu's `jax.grad`."""
    import jax

    noisy, _ = _specs(4)
    crm = np.random.default_rng(5).uniform(0.05, 0.95,
                                           noisy.shape).astype(np.float32)
    w = np.random.default_rng(6).standard_normal(noisy.shape).astype(np.float32)
    ref = jax.grad(lambda m: jnp.sum(jcrm.apply_compressed_crm(
        jnp.asarray(noisy), m) * w))(jnp.asarray(crm))
    m = torch.from_numpy(crm).requires_grad_(True)
    (tcrm.apply_compressed_crm(torch.from_numpy(noisy), m)
     * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(ref),
                               atol=1e-5 * scale)


@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_device_mix_and_stft_matches_sos_tpu(stage):
    cfg, pcfg = tiny_configs()
    clean, noise, snr, bits = _signals(7)
    j = [jnp.asarray(a) for a in (clean, noise, snr, bits)]
    t = [torch.from_numpy(a) for a in (clean, noise, snr, bits)]
    if stage == "detector":
        ref = jpipe.device_mix_and_stft_detector(*j, cfg.data, cfg.stft)
        got = tpipe.device_mix_and_stft_detector(*t, pcfg.data, pcfg.stft)
    else:
        ref = jpipe.device_mix_and_stft_denoiser(*j, cfg.data, cfg.stft)
        got = tpipe.device_mix_and_stft_denoiser(*t, pcfg.data, pcfg.stft)
    assert set(got) == set(ref)
    for key in ref:
        r = np.asarray(ref[key])
        assert got[key].shape == r.shape, key
        scale = max(1.0, float(np.abs(r).max()))
        # the ground-truth cRM divides by the mixed STFT: bins near
        # |Y| = 0 amplify the two STFTs' ~1e-7 differences (4 of 273,408
        # values at 1.2e-5 here), so it gets 5e-5
        atol = 5e-5 if key == "mask" else 1e-5
        np.testing.assert_allclose(got[key].numpy(), r, atol=atol * scale,
                                   err_msg=key)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return training_corpus(tmp_path_factory.mktemp("train_data"))


def _batchers(corpus, stage, shuffle, seed):
    cfg, pcfg = tiny_configs()
    ds_json, noise_dir = corpus
    j_idx, t_idx = JaxIndex.load(ds_json), DatasetIndex.load(ds_json)
    j_noise = JaxNoiseBank.from_roots([noise_dir], cfg.data.sample_rate)
    t_noise = NoiseBank.from_roots([noise_dir], pcfg.data.sample_rate)
    if stage == "detector":
        jw = jax_det_windows(j_idx.files, cfg.data.clip_frames)
        tw = detector_windows(t_idx.files, pcfg.data.clip_frames)
        jb = jpipe.DetectorBatcher(jw, j_noise, cfg.data, 2, shuffle, seed)
        tb = DetectorBatcher(tw, t_noise, pcfg.data, 2, shuffle, seed)
    else:
        jw = jax_den_windows(j_idx.files, cfg.data.clip_seconds,
                             cfg.data.overlap_seconds)
        tw = denoiser_windows(t_idx.files, pcfg.data.clip_seconds,
                              pcfg.data.overlap_seconds)
        jb = jpipe.DenoiserBatcher(jw, j_noise, cfg.data, 2, shuffle, seed)
        tb = DenoiserBatcher(tw, t_noise, pcfg.data, 2, shuffle, seed)
    jb.cache._engine = None  # sos_tpu's native decoder is not ported
    return jb, tb


def _assert_same(jit, tit):
    jl, tl = list(jit), list(tit)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_batchers_match_sos_tpu(corpus, stage):
    jb, tb = _batchers(corpus, stage, shuffle=True, seed=3)
    assert len(jb) == len(tb) >= 3
    for epoch in (0, 2):
        jb.set_epoch(epoch)
        tb.set_epoch(epoch)
        _assert_same(jb, tb)
        # an exact mid-epoch resume replays the skipped draws
        _assert_same(jb.iter_from(2), tb.iter_from(2))
        _assert_same(list(tb)[2:], tb.iter_from(2))


def test_batcher_shard_matches_sos_tpu(corpus):
    jb, tb = _batchers(corpus, "denoiser", shuffle=True, seed=5)
    jb.shard(1, 2)
    tb.shard(1, 2)
    assert tb.seed == jb.seed
    _assert_same(jb, tb)


def test_batcher_refuses_another_framerate(corpus):
    _, pcfg = tiny_configs()
    ds_json, noise_dir = corpus
    idx = DatasetIndex.load(ds_json)
    windows = detector_windows(idx.files, pcfg.data.clip_frames)
    windows[0] = type(windows[0])(**{**windows[0].__dict__, "framerate": 25.0})
    with pytest.raises(ValueError, match="framerates"):
        DetectorBatcher(windows, NoiseBank.from_roots([noise_dir], 14000),
                        pcfg.data, 2, True)
