"""The port's native audio engine (`sos_tpu_torch.runtime`) on the CPU.

Held against the port's Python decode/resample/mix (`dsp/audio_io`,
`dsp/mixing.mix_at_snr_np`) with the bounds of tests/test_runtime.py
(decode 1e-6, resample 2e-4 and one sample of length, mix 1e-5), and
against `sos_tpu`'s engine on the same files. Also: where the library
is built, and the two callers' routes (the training WAV cache and the
denoiser eval's decode).
"""

import numpy as np
import pytest

from sos_tpu.runtime import NativeAudioEngine as SosEngine
from sos_tpu.runtime import native_available as sos_native_available
from sos_tpu_torch.data import pipeline
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.dsp.mixing import mix_at_snr_np
from sos_tpu_torch.infer import evaluate
from sos_tpu_torch.runtime import NativeAudioEngine, engine, native_available


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 44.1 kHz files (resampled) and two at 14 kHz (decode only)."""
    root = tmp_path_factory.mktemp("runtime")
    rng = np.random.default_rng(7)
    paths = {}
    for i, (sr, n) in enumerate([(44100, 30000), (44100, 44100),
                                 (44100, 12345), (14000, 20000),
                                 (14000, 9000)]):
        y = (rng.standard_normal(n) * 0.2).astype(np.float32)
        if i == 1:
            y = (np.sin(2 * np.pi * 440 * np.arange(n) / sr) * 0.5
                 ).astype(np.float32)
        path = str(root / f"f{i}_{sr}.wav")
        audio_io.write_wav(path, y, sr)
        paths[path] = sr
    return paths


@pytest.fixture(scope="module")
def native():
    assert native_available(), "g++ builds the engine on this host"
    return NativeAudioEngine(num_threads=2)


def test_library_is_built_under_build_not_beside_its_source(native):
    path = engine.library_path()
    assert path.exists() and path.parent == engine.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "sos_tpu_torch")
    assert not list(engine.SOURCE.parent.glob("*.so"))


def test_engine_matches_python_and_sos_tpu(corpus, native):
    assert sos_native_available()
    sos = SosEngine(num_threads=2)
    for path, sr in corpus.items():
        ours, got_sr = native.load(path)
        ref, ref_sr = audio_io.load(path)
        assert got_sr == ref_sr == sr
        np.testing.assert_allclose(ours, ref, atol=1e-6)
        np.testing.assert_array_equal(ours, sos.load(path)[0])
        res, _ = native.load(path, sr=14000)
        ref, _ = audio_io.load(path, sr=14000)
        assert abs(len(res) - len(ref)) <= 1
        n = min(len(res), len(ref))
        np.testing.assert_allclose(res[:n], ref[:n], atol=2e-4)
        np.testing.assert_allclose(res, sos.load(path, sr=14000)[0],
                                   atol=1e-6, rtol=0)


def test_load_batch_matches_serial_loads(corpus, native):
    paths = list(corpus)
    out, lengths = native.load_batch(paths, target_sr=14000, max_samples=12000)
    sos_out, sos_lengths = SosEngine(num_threads=2).load_batch(
        paths, target_sr=14000, max_samples=12000)
    np.testing.assert_array_equal(lengths, sos_lengths)
    np.testing.assert_allclose(out, sos_out, atol=1e-6, rtol=0)
    for i, p in enumerate(paths):
        ref = audio_io.load(p, sr=14000)[0]
        n = min(int(lengths[i]), 12000, len(ref))
        np.testing.assert_allclose(out[i, :n], ref[:n], atol=2e-4)


def test_native_mix_matches_python():
    rng = np.random.default_rng(8)
    clean = rng.standard_normal(8000).astype(np.float32)
    noise = rng.standard_normal(8000).astype(np.float32)
    m, c, n = NativeAudioEngine(num_threads=1).mix_at_snr(
        clean, noise, snr_db=3.0, norm=0.5)
    rm, rc, rn = mix_at_snr_np(clean.astype(np.float64),
                               noise.astype(np.float64), 3.0, norm=0.5)
    for got, ref in ((m, rm), (c, rc), (n, rn)):
        np.testing.assert_allclose(got, ref, atol=1e-5)
    sm, sc, sn = SosEngine(num_threads=1).mix_at_snr(clean, noise, 3.0, 0.5)
    for got, ref in ((m, sm), (c, sc), (n, sn)):
        np.testing.assert_array_equal(got, ref)


def test_wav_cache_takes_the_native_route(corpus):
    """The training cache decodes through the engine (bulk prefetch of a
    batch's misses), as sos_tpu's does; the Python fallback gives the
    same samples where no resample is needed."""
    cache = pipeline._WavCache(14000)
    assert cache._engine is not None
    paths = list(corpus)
    cache.prefetch_paths(paths)
    assert set(cache._store) == set(paths)
    for p, sr in corpus.items():
        native_wav = cache.get(p)
        ref = audio_io.load(p, sr=14000)[0]
        if sr == 14000:
            np.testing.assert_array_equal(native_wav, ref)
        else:
            n = min(len(native_wav), len(ref))
            np.testing.assert_allclose(native_wav[:n], ref[:n], atol=2e-4)


def test_eval_decode_is_native_only_without_resample(corpus, monkeypatch):
    """`_load_many` takes the engine's threaded decode for 14 kHz files
    (the serial path's samples exactly) and the Python route when any
    file needs resampling."""
    same = [p for p, sr in corpus.items() if sr == 14000]
    calls = []
    real = NativeAudioEngine.load_batch
    monkeypatch.setattr(NativeAudioEngine, "load_batch",
                        lambda self, *a: calls.append(a) or real(self, *a))
    got = evaluate._load_many(same, 14000)
    assert len(calls) == 1
    for g, p in zip(got, same):
        np.testing.assert_array_equal(g, audio_io.load(p, sr=14000)[0])
    mixed = list(corpus)
    got = evaluate._load_many(mixed, 14000)
    assert len(calls) == 1
    for g, p in zip(got, mixed):
        np.testing.assert_array_equal(g, audio_io.load(p, sr=14000)[0])
