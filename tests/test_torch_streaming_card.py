"""The port's streaming layer on the card against itself on the CPU.

This file imports neither JAX nor `sos_tpu`, so it runs on the machine
with the card, where JAX is absent (tests/conftest.py imports it, hence
`--noconftest`):

    python -m pytest tests/test_torch_streaming_card.py -q --noconftest -p no:cacheprovider

On a host without a card every test skips. Small widths (the int8 ones
wide enough for the Hopper int8 tile); 2 s and 6 s chunks. The
threshold splits the CPU's detector probabilities in half (random
weights put them all near one value). Bits must be equal wherever the
CPU's sigmoid is more than 1e-3 from the threshold; where a frame within
1e-3 flipped, both sides denoise with the CPU's bits. Waveforms: f32
within atol 1e-4, rtol 1e-3 (test_torch_kernels.py's small pipeline),
int8 within atol 5e-3 (the int8 budget of test_torch_quant.py: K1 sits
within 2e-5 of its plain version, which moves the rounding of a few
quantized inputs by one step; 1.8e-3 measured at 6 s chunks).
"""

import threading

import numpy as np
import pytest
import torch

from sos_tpu_torch.config import (DataConfig, DenoiserModelConfig,
                                  DetectorModelConfig, ExperimentConfig)
from sos_tpu_torch.infer import StreamingDenoiser, StreamingSession
from sos_tpu_torch.infer.fused import _nchw
from sos_tpu_torch.kernels import LAUNCHES, reset_launches
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.layers import exact_fp32, init_state_dict

pytestmark = pytest.mark.cuda

SR = 14000
KERNELS = {"f32": ("stft", "mask_gate", "crm_istft", "bilstm"),
           "int8": ("stft", "mask_gate", "crm_istft", "bilstm", "int8_conv",
                    "int8_inpaint")}
GEOMETRIES = {"2s": dict(chunk_seconds=2.0, overlap_seconds=0.5),
              "6s": dict(chunk_seconds=6.0, overlap_seconds=1.0)}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py covers streaming there)")
    return torch.device("cuda")


def _config(profile: str) -> ExperimentConfig:
    ks, dils = ((1, 7), (5, 5)), ((1, 1), (2, 2))
    if profile == "int8":
        det = DetectorModelConfig(nf=16, outf=2, kernel_sizes=ks,
                                  dilations=dils, lstm_hidden=4, fc_hidden=4)
        den = DenoiserModelConfig(nf_mixed=32, nf_noise=16, outf_mixed=8,
                                  outf_noise=4, kernel_sizes=ks,
                                  dilations=dils, lstm_hidden=8,
                                  fc_hidden=16, inpaint_ch=(16, 32, 64))
    else:
        det = DetectorModelConfig(nf=4, outf=2, kernel_sizes=ks,
                                  dilations=dils, lstm_hidden=4, fc_hidden=4)
        den = DenoiserModelConfig(nf_mixed=8, nf_noise=4, outf_mixed=8,
                                  outf_noise=4, kernel_sizes=ks,
                                  dilations=dils, lstm_hidden=8,
                                  fc_hidden=16, inpaint_ch=(4, 6, 8))
    return ExperimentConfig(detector=det, denoiser=den, data=DataConfig())


def utterance(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    bursts = np.sin(2 * np.pi * 220.0 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
    return (0.4 * bursts + rng.standard_normal(n) * 0.05).astype(np.float32)


def _starts(s, n):
    return [0] if n <= s.chunk else list(range(0, n, s.stride))


def _probs(s, wav) -> np.ndarray:
    """The detector's sigmoid over each chunk window (no threshold)."""
    pipe = s.pipeline
    windows = torch.from_numpy(s._det_windows(wav, _starts(s, len(wav))))
    nf = pipe._nf(windows.shape[1])
    with torch.no_grad(), exact_fp32():
        cat = pipe._stft(pipe._ingest(windows))
        if pipe._quant_det is not None:
            logits = pipe._quant_det.logits_cat(cat, nf)
        else:
            logits = pipe.detector.forward_nchw(_nchw(cat), nf)
    return torch.sigmoid(logits).cpu().numpy()[:, s.det_halo_frames:]


def _reconciled(s, arr, n):
    starts = _starts(s, n)
    return s.reconcile_bits(arr, starts) if len(starts) > 1 else arr


def _bits(s, wav):
    windows = s._det_windows(wav, _starts(s, len(wav)))
    bits = s._batched(s.pipeline.detect_bits, [windows])[:, s.det_halo_frames:]
    return _reconciled(s, np.ascontiguousarray(bits), len(wav))


def _denoise_with_bits(s, wav, bits):
    starts = _starts(s, len(wav))
    chunks = np.zeros((len(starts), s.chunk), np.float32)
    for i, st in enumerate(starts):
        chunks[i, :len(wav[st:st + s.chunk])] = wav[st:st + s.chunk]
    out = s._batched(s.pipeline.denoise_with_bits, [chunks, bits])
    return s._assemble(out, [(0, starts, len(wav))])[0]


def _pair(profile, geometry, tmp_path, **kw):
    """(card, cpu) StreamingDenoisers on seeded random weights, one
    threshold and, for int8, one scale file (the CPU calibrates)."""
    cfg = _config(profile)
    gen = torch.Generator().manual_seed(0)
    det = init_state_dict(SilenceDetector(cfg.detector), gen)
    den = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    if profile == "int8":
        kw["calibration_path"] = str(tmp_path / "int8_calibration.json")
    args = dict(profile=profile, **GEOMETRIES[geometry], **kw)
    host = StreamingDenoiser(cfg, det, den, device="cpu", **args)
    wav = utterance(13 * SR, seed=1)
    host.denoise(wav[:host.chunk])  # int8: calibrates and writes the file
    p = _probs(host, wav)
    host.pipeline.threshold = float(np.median(p))
    card = StreamingDenoiser(cfg, det, den, threshold=host.pipeline.threshold,
                             **args)
    return card, host, wav


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("profile", ["f32", "int8"])
def test_streaming_card_matches_cpu(cuda_device, tmp_path, profile, geometry):
    card, host, wav = _pair(profile, geometry, tmp_path)
    reset_launches()
    got = card.denoise(wav)
    torch.cuda.synchronize()
    assert all(LAUNCHES[k] > 0 for k in KERNELS[profile]), dict(LAUNCHES)
    ref = host.denoise(wav)
    assert got.shape == ref.shape == wav.shape
    bits_card, bits_host = _bits(card, wav), _bits(host, wav)
    margin = _reconciled(host, np.abs(_probs(host, wav)
                                      - host.pipeline.threshold), len(wav))
    clear = margin > 1e-3
    assert 0 < bits_host.sum() < bits_host.size
    np.testing.assert_array_equal(bits_card[clear], bits_host[clear])
    if not np.array_equal(bits_card, bits_host):
        got = _denoise_with_bits(card, wav, bits_host)
    atol, rtol = (1e-4, 1e-3) if profile == "f32" else (5e-3, 0.0)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's default f32 algorithms at these widths differ from run to
    run by ~8e-7; with deterministic ones any difference is a race."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_card_async_and_threads_equal_sync(cuda_device, tmp_path,
                                           deterministic_cudnn,
                                           transfer_dtype):
    """Dispatch on one thread, finalize on others, while another thread
    runs its own requests on the same denoiser (one stream): every
    result equals the sequential one bit for bit."""
    card, _, wav = _pair("f32", "2s", tmp_path, batch_chunks=4,
                         transfer_dtype=transfer_dtype)
    waves = [wav[:n] for n in (45000, 70000, 182000)]
    want = card.denoise_many(waves)
    want_one = [card.denoise(w) for w in waves]
    results, errors = {}, []

    def finisher(fin, key):
        try:
            results[key] = fin()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    def other():
        try:
            results["other"] = [card.denoise(w) for w in waves]
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=other)]
    threads[0].start()
    for i in range(3):
        t = threading.Thread(target=finisher,
                             args=(card.denoise_many_async(waves), i))
        t.start()
        threads.append(t)
    for t in threads:
        t.join(120)
    assert not errors, errors
    for key in (0, 1, 2):
        for a, b in zip(results[key], want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(results["other"], want_one):
        np.testing.assert_array_equal(a, b)


def test_card_session_equals_offline(cuda_device, tmp_path):
    card, _, wav = _pair("f32", "2s", tmp_path)
    want = card.denoise(wav)
    sess = StreamingSession(card)
    outs = [sess.push(wav[i:i + 3500]) for i in range(0, len(wav), 3500)]
    got = np.concatenate(outs + [sess.flush()])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
