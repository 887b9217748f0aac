"""Port streaming (`sos_tpu_torch.infer.streaming`) against
`sos_tpu.infer.streaming` on the CPU, and the port's `exact_fp32`
under two threads.

The same numpy utterances and the same weights (tests/torch_port_fixtures.py,
the detector head sharpened so that the random detector gives mixed bits
clear of the threshold) go through both packages' `StreamingDenoiser`
(the port with `device="cpu"`).

Tolerances:
* f32 waveforms within atol 1e-4, rtol 1e-3 (test_torch_fused.py's),
  equal lengths, and equal reconciled bits wherever sos_tpu's sigmoid
  is more than 1e-3 from the threshold (where a frame within 1e-3
  flipped, the waveforms are compared with sos_tpu's bits in both, the
  rule of test_torch_fused.py and test_torch_quant.py);
* int16 transfer: the same, the output carrying one wire LSB (3.1e-5);
* the numpy helpers (`reconcile_bits`, `_overlap_add`, `_weights`,
  `_det_windows`) bit-exact;
* int8, with one scale file written by sos_tpu and loaded by both:
  bits equal where sos_tpu's int8 sigmoid is clear of the threshold,
  waveform within atol 5e-3 (the int8 budget of test_torch_quant.py);
* the port against itself: `denoise_many_async` == `denoise_many`
  exactly; `denoise_many` == per-utterance `denoise` exactly where each
  utterance takes the same route (a single-chunk utterance batched with
  longer ones takes the two-pass route instead of the fused call: within
  1e-5, sos_tpu's own bound, tests/test_infer.py); a `StreamingSession`
  == offline within atol 2e-6 (sos_tpu's own test's bound: the session
  runs width-1 batches, offline runs power-of-two ones), single-chunk
  streams exactly.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sos_tpu.infer.streaming import StreamingDenoiser as JaxStreaming
from sos_tpu.infer.streaming import StreamingSession as JaxSession
from sos_tpu.models import SilenceDetector as JaxSilenceDetector
from sos_tpu_torch.infer import StreamingDenoiser, StreamingSession
from sos_tpu_torch.kernels import LAUNCHES
from sos_tpu_torch.models.layers import exact_fp32

from tests.torch_port_fixtures import (oracle_variables, port_states,
                                       tiny_configs)

jstft = importlib.import_module("sos_tpu.dsp.stft")
SR = 14000
CHUNK, VALID = 28000, 27966
INT8_BUDGET = 5e-3  # tests/test_torch_quant.py


def utterance(n: int, seed: int) -> np.ndarray:
    """Tone bursts with silent gaps plus noise, float32 (n,)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    bursts = np.sin(2 * np.pi * 220.0 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
    return (0.4 * bursts + rng.standard_normal(n) * 0.05).astype(np.float32)


# -- exact_fp32 under two threads -------------------------------------------


def test_exact_fp32_is_thread_safe():
    """A enters, B enters, A leaves: B must still run without TF32, and
    the switches come back only when both have left."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    a_in, b_in, a_out, b_read = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with exact_fp32():
            a_in.set()
            assert b_in.wait(10)
        a_out.set()

    def thread_b():
        assert a_in.wait(10)
        with exact_fp32():
            b_in.set()
            assert a_out.wait(10)
            seen["matmul"] = torch.backends.cuda.matmul.allow_tf32
            seen["cudnn"] = torch.backends.cudnn.allow_tf32
        b_read.set()

    try:
        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert b_read.is_set()
        assert seen == {"matmul": False, "cudnn": False}
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with exact_fp32():  # nested blocks restore only at the outermost
            with exact_fp32():
                pass
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- the pair of packages ----------------------------------------------------


@pytest.fixture(scope="module")
def env():
    cfg, port_cfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=1)
    fc2 = det_vars["params"]["fc2"]
    fc2["kernel"], fc2["bias"] = fc2["kernel"] * 40, fc2["bias"] * 40
    det_state, den_state = port_states(det_vars, den_vars)
    return cfg, port_cfg, det_vars, den_vars, det_state, den_state


@pytest.fixture(scope="module")
def pair(env):
    """pair(**kw) -> (sos_tpu's, the port's) StreamingDenoiser, cached,
    so that sos_tpu's compiled programs are reused across tests."""
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env
    made = {}

    def make(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            made[key] = (JaxStreaming(cfg, det_vars, den_vars, **kw),
                         StreamingDenoiser(port_cfg, det_state, den_state,
                                           device="cpu", **kw))
        return made[key]

    return make


def _starts(s, n):
    return [0] if n <= s.chunk else list(range(0, n, s.stride))


def reconciled_bits(s, wav) -> np.ndarray:
    """The bits `denoise` gates one utterance with, by either package's
    own pieces: detector windows, detect, crop, reconcile."""
    starts = _starts(s, len(wav))
    windows = s._det_windows(wav, starts)
    bits = np.asarray(s._batched(s.pipeline.detect_bits, [windows]),
                      np.float32)[:, s.det_halo_frames:]
    if s.consistent_boundaries and len(starts) > 1:
        bits = s.reconcile_bits(bits, starts)
    return bits


def jax_margins(s, wav, logits_fn) -> np.ndarray:
    """sos_tpu's |sigmoid - threshold| for each final bit: per detector
    window, cropped and moved by the reconciliation as the bits are."""
    starts = _starts(s, len(wav))
    windows = s._det_windows(wav, starts)
    n = windows.shape[1]  # sos_tpu's frame count rule (fused.py _nf)
    nf = (s.pipeline.num_frames if n == s.chunk
          else int(round(n * s.cfg.data.frame_rate / s.cfg.data.sample_rate)))
    margin = np.abs(np.asarray(jax.nn.sigmoid(logits_fn(windows, nf)))
                    - s.pipeline.threshold)[:, s.det_halo_frames:]
    if s.consistent_boundaries and len(starts) > 1:
        margin = s.reconcile_bits(margin, starts)
    return margin


def denoise_with_bits(s, wav, bits) -> np.ndarray:
    """`denoise` of one utterance with the given final bits."""
    starts = _starts(s, len(wav))
    chunks = np.zeros((len(starts), s.chunk), np.float32)
    for i, st in enumerate(starts):
        seg = wav[st:st + s.chunk]
        chunks[i, :len(seg)] = seg
    out = s._batched(s.pipeline.denoise_with_bits, [chunks, bits])
    return s._assemble(out, [(0, starts, len(wav))])[0]


def assert_matches(env, js, ps, wav, atol=1e-4, rtol=1e-3, logits_fn=None):
    """The port's `denoise` against sos_tpu's. Bits must be equal
    wherever sos_tpu's sigmoid is more than 1e-3 from the threshold;
    where a frame within 1e-3 flipped, the waveforms are compared with
    sos_tpu's bits in both (test_torch_fused.py's rule)."""
    cfg, _, det_vars = env[:3]
    if logits_fn is None:
        def logits_fn(windows, nf):
            return JaxSilenceDetector(cfg.detector).apply(
                det_vars, jstft.stft(jnp.asarray(windows)), num_frames=nf)
    before = dict(LAUNCHES)
    got = ps.denoise(wav)
    assert LAUNCHES == before  # device="cpu": plain versions only
    ref = js.denoise(wav)
    assert got.dtype == np.float32 and got.shape == ref.shape
    jbits, pbits = reconciled_bits(js, wav), reconciled_bits(ps, wav)
    assert 0 < jbits.sum() < jbits.size  # the gate really gates
    if not np.array_equal(pbits, jbits):
        clear = jax_margins(js, wav, logits_fn) > 1e-3
        np.testing.assert_array_equal(pbits[clear], jbits[clear])
        got = denoise_with_bits(ps, wav, jbits)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)
    print(f"max |port - sos_tpu| {np.abs(got - ref).max():.3e}, bits "
          f"equal {np.array_equal(pbits, jbits)}")
    return got


GEOMETRIES = {"2.0/0.5": dict(chunk_seconds=2.0, overlap_seconds=0.5),
              "2.0/0.0": dict(chunk_seconds=2.0, overlap_seconds=0.0)}
LENGTHS = {"1.5s": 21000, "one chunk": CHUNK,
           "in (valid, chunk]": VALID + 20, "5s": 70000, "9.7s": 135800}


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("length", LENGTHS)
def test_denoise_matches_sos_tpu(env, pair, geometry, length):
    n = LENGTHS[length]
    js, ps = pair(**GEOMETRIES[geometry])
    got = assert_matches(env, js, ps, utterance(n, seed=n))
    assert len(got) == (n if n > CHUNK else min(n, VALID))


@pytest.mark.parametrize("mode", ["one-pass", "int16 transfer",
                                  "3s detector context"])
def test_modes_match_sos_tpu(env, pair, mode):
    kw = {"one-pass": dict(consistent_boundaries=False),
          "int16 transfer": dict(transfer_dtype="int16"),
          "3s detector context": dict(detector_context_seconds=3.0)}[mode]
    js, ps = pair(**kw)
    # int16: one wire LSB on top of the f32 tolerance
    atol = 1e-4 + (1 / 32768 if mode == "int16 transfer" else 0.0)
    assert_matches(env, js, ps, utterance(70000, seed=5), atol=atol)
    if mode == "3s detector context":
        assert ps.det_halo == 14000 and ps.det_halo_frames == 30


# -- numpy helpers, bit-exact --------------------------------------------------


HELPER_GEOMETRIES = [(2.0, 0.5), (2.0, 0.0), (1.0, 0.25), (0.5, 0.1)]


@pytest.mark.parametrize("chunk_s,overlap_s", HELPER_GEOMETRIES)
def test_numpy_helpers_bit_exact(env, chunk_s, overlap_s):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env
    kw = dict(chunk_seconds=chunk_s, overlap_seconds=overlap_s,
              detector_context_seconds=chunk_s + 0.5)
    js = JaxStreaming(cfg, det_vars, den_vars, **kw)
    ps = StreamingDenoiser(port_cfg, det_state, den_state, device="cpu", **kw)
    assert (ps.chunk, ps.valid, ps.overlap, ps.stride, ps.det_halo,
            ps.det_halo_frames) == (js.chunk, js.valid, js.overlap,
                                    js.stride, js.det_halo,
                                    js.det_halo_frames)
    rng = np.random.default_rng(int(chunk_s * 100 + overlap_s * 10))
    np.testing.assert_array_equal(ps._weights(), js._weights())
    for n_chunks in (1, 2, 5):
        weighted = rng.standard_normal((n_chunks, js.valid)).astype(np.float32)
        total = (n_chunks - 1) * js.stride + js.valid
        np.testing.assert_array_equal(ps._overlap_add(weighted, total),
                                      js._overlap_add(weighted, total))
        frames = js.pipeline.num_frames
        bits = (rng.random((n_chunks, frames)) < 0.5).astype(np.float32)
        starts = [i * js.stride for i in range(n_chunks)]
        np.testing.assert_array_equal(ps.reconcile_bits(bits, starts),
                                      js.reconcile_bits(bits, starts))
    wav = rng.standard_normal(3 * js.chunk + 123).astype(np.float32)
    starts = _starts(js, len(wav))
    np.testing.assert_array_equal(ps._det_windows(wav, starts),
                                  js._det_windows(wav, starts))


# -- the port against itself --------------------------------------------------


def test_denoise_many_equals_per_utterance(pair):
    _, ps = pair(chunk_seconds=2.0, overlap_seconds=0.5)
    waves = [utterance(n, seed=n) for n in (70000, 45000, 135800)]
    many = ps.denoise_many(waves)
    for wav, got in zip(waves, many):
        np.testing.assert_array_equal(got, ps.denoise(wav))
    # a single-chunk utterance batched with longer ones takes the
    # two-pass route instead of the one fused call
    short = utterance(20000, seed=3)
    got = ps.denoise_many([short, waves[0]])[0]
    assert got.shape == (20000,)
    np.testing.assert_allclose(got, ps.denoise(short), atol=1e-5, rtol=0)


@pytest.mark.parametrize("lengths", [(9000, 70000, 30000), (9000, 20000)],
                         ids=["two-pass", "all single-chunk"])
def test_denoise_many_async_equals_sync(pair, lengths):
    _, ps = pair(chunk_seconds=2.0, overlap_seconds=0.5, batch_chunks=4)
    waves = [utterance(n, seed=n) for n in lengths]
    sync = ps.denoise_many(waves)
    fin = ps.denoise_many_async(waves)
    for a, b in zip(sync, fin()):
        np.testing.assert_array_equal(a, b)
    assert ps.denoise_many_async([])() == []


PUSH_CASES = {"2.0/0.5 two-pass": dict(chunk_seconds=2.0, overlap_seconds=0.5),
              "2.0/0.0 two-pass": dict(chunk_seconds=2.0, overlap_seconds=0.0),
              "2.0/0.5 one-pass": dict(chunk_seconds=2.0, overlap_seconds=0.5,
                                       consistent_boundaries=False),
              "3s detector context": dict(detector_context_seconds=3.0)}


@pytest.mark.parametrize("case", PUSH_CASES)
def test_session_push_equals_offline(pair, case):
    _, ps = pair(**PUSH_CASES[case])
    wav = utterance(102000, seed=11)
    want = ps.denoise(wav)
    sess = StreamingSession(ps)
    outs, pos = [], 0
    push_rng = np.random.default_rng(42)
    bound = ps.chunk + (2 if ps.consistent_boundaries else 1) * ps.stride
    while pos < len(wav):
        step = int(push_rng.integers(1000, 9000))
        outs.append(sess.push(wav[pos:pos + step]))
        pos = min(pos + step, len(wav))
        assert pos - sum(len(o) for o in outs) <= bound  # latency bound
    outs.append(sess.flush())
    got = np.concatenate(outs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_session_single_chunk_and_empty(pair):
    _, ps = pair(chunk_seconds=2.0, overlap_seconds=0.5)
    wav = utterance(20000, seed=4)
    sess = StreamingSession(ps)
    a, b = sess.push(wav[:9000]), sess.push(wav[9000:])
    assert len(a) == len(b) == 0  # nothing final before flush
    got = np.concatenate([a, b, sess.flush()])
    np.testing.assert_array_equal(got, ps.denoise(wav))
    assert len(StreamingSession(ps).flush()) == 0
    with pytest.raises(AssertionError):
        sess.flush()
    with pytest.raises(AssertionError):
        sess.push(wav)


def test_session_matches_sos_tpu_session(env, pair):
    js, ps = pair(chunk_seconds=2.0, overlap_seconds=0.5)
    wav = utterance(60000, seed=12)
    outs = []
    for s in (JaxSession(js), StreamingSession(ps)):
        parts = [s.push(wav[i:i + 7000]) for i in range(0, len(wav), 7000)]
        outs.append(([len(p) for p in parts], np.concatenate(
            parts + [s.flush()])))
    assert outs[0][0] == outs[1][0]  # the same samples final at each push
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-4, rtol=1e-3)


# -- dispatch structure (the port's own) ----------------------------------------


class _LazyFetch:
    """A stand-in result that records when the host fetches it."""

    def __init__(self, t, tag, log):
        self.t, self.tag, self.log = t, tag, log

    def numpy(self):
        self.log.append(("fetch", self.tag))
        return self.t.numpy()


@pytest.mark.parametrize("depth,n_chunks", [(2, 8), (1, 6)])
def test_batched_async_keeps_depth_in_flight(env, depth, n_chunks):
    _, port_cfg, _, _, det_state, den_state = env
    s = StreamingDenoiser(port_cfg, det_state, den_state, batch_chunks=2,
                          pipeline_depth=depth, device="cpu")
    log = []

    def probe(m):
        i = len([e for e in log if e[0] == "dispatch"])
        log.append(("dispatch", i))
        return _LazyFetch(m, i, log)

    chunks = np.random.default_rng(0).standard_normal(
        (n_chunks, s.chunk)).astype(np.float32)
    fin = s._batched_async(probe, [chunks])
    in_flight = 0
    for kind, _ in log:
        in_flight += 1 if kind == "dispatch" else -1
        assert in_flight <= depth + 1  # the new dispatch + depth older
    if depth == 2:  # batch 1 goes out before batch 0 is fetched
        assert log.index(("dispatch", 1)) < log.index(("fetch", 0))
    assert len([e for e in log if e[0] == "fetch"]) == n_chunks // 2 - depth
    out = fin()
    fetches = [t for k, t in log if k == "fetch"]
    assert fetches == sorted(fetches) == list(range(n_chunks // 2))
    np.testing.assert_array_equal(out, chunks)


def test_batched_pads_to_pow2_bucket(env):
    _, port_cfg, _, _, det_state, den_state = env
    s = StreamingDenoiser(port_cfg, det_state, den_state, batch_chunks=16,
                          device="cpu")
    widths = []

    def probe(m):
        widths.append(m.shape[0])
        return m

    for n_chunks, want in ((1, [1]), (3, [4]), (5, [8]), (16, [16]),
                           (17, [16, 1])):
        widths.clear()
        chunks = np.ones((n_chunks, s.chunk), np.float32)
        np.testing.assert_array_equal(s._batched(probe, [chunks]), chunks)
        assert widths == want


def test_warmup_widths_and_calls_match_sos_tpu(env):
    """warmup returns sos_tpu's widths list (the non-power-of-two full
    width included) and makes the same calls at the same batch shapes;
    sos_tpu's calls are recorded without running its programs."""
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env
    kw = dict(batch_chunks=3, detector_context_seconds=2.5)
    js = JaxStreaming(cfg, det_vars, den_vars, **kw)
    ps = StreamingDenoiser(port_cfg, det_state, den_state, device="cpu", **kw)
    jlog, plog = [], []

    def jax_batched(fn, arrays):
        jlog.append(tuple(np.shape(a) for a in arrays))
        return np.zeros((len(arrays[0]), js.det_halo_frames + 60), np.float32)

    js._batched = jax_batched
    js._one_pass = lambda chunks: jlog.append((np.shape(chunks),))
    port_batched = ps._batched
    ps._batched = lambda fn, arrays: plog.append(
        tuple(np.shape(a) for a in arrays)) or port_batched(fn, arrays)
    assert ps.warmup() == js.warmup() == [1, 2, 3]
    assert plog == jlog and len(plog) == 9


def test_int8_warmup_waits_for_scales(env, tmp_path):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env
    path = str(tmp_path / "none.json")
    js = JaxStreaming(cfg, det_vars, den_vars, profile="int8",
                      calibration_path=path)
    ps = StreamingDenoiser(port_cfg, det_state, den_state, profile="int8",
                           calibration_path=path, device="cpu")
    assert ps.warmup() == js.warmup() == []


# -- int8 -----------------------------------------------------------------------


def test_int8_matches_sos_tpu_with_its_scale_file(env, tmp_path):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env
    path = str(tmp_path / "int8_calibration.json")
    wav = utterance(70000, seed=5)
    js = JaxStreaming(cfg, det_vars, den_vars, profile="int8",
                      calibration_path=path)
    ref = js.denoise(wav)  # self-calibrates, writes the file
    ps = StreamingDenoiser(port_cfg, det_state, den_state, profile="int8",
                           calibration_path=path, device="cpu")
    assert ps.pipeline.ensure_calibrated()
    assert (ps.pipeline._quant.calibration_state()
            == js.pipeline._quant.calibration_state())

    def logits_fn(windows, nf):
        mr, mi = jstft.stft_packed(jnp.asarray(windows))
        return js.pipeline._quant_det.logits_packed(mr, mi, nf)

    assert_matches(env, js, ps, wav, atol=INT8_BUDGET, rtol=0,
                   logits_fn=logits_fn)


# -- errors ----------------------------------------------------------------------


ERRORS = {
    "transfer dtype": (dict(transfer_dtype="int8"), ValueError),
    "overlap past half the valid span": (dict(overlap_seconds=1.2),
                                         AssertionError),
    "pipeline depth 0": (dict(pipeline_depth=0), AssertionError),
    "halo in one-pass mode": (dict(detector_context_seconds=3.0,
                                   consistent_boundaries=False), ValueError),
    "context shorter than a chunk": (dict(detector_context_seconds=1.5),
                                     ValueError),
    "context not whole frames": (dict(detector_context_seconds=2.05),
                                 ValueError),
}


@pytest.mark.parametrize("case", ERRORS)
def test_bad_arguments_raise_as_sos_tpu(env, case):
    cfg, port_cfg, det_vars, den_vars, det_state, den_state = env
    kw, exc = ERRORS[case]
    with pytest.raises(exc) as ref:
        JaxStreaming(cfg, det_vars, den_vars, **kw)
    with pytest.raises(exc) as got:
        StreamingDenoiser(port_cfg, det_state, den_state, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


def test_profile_from_compute_dtype(env):
    _, port_cfg, _, _, det_state, den_state = env
    for kw, want in ((dict(), "f32"), (dict(compute_dtype="bfloat16"), "bf16"),
                     (dict(compute_dtype="bfloat16", profile="f32"), "f32")):
        s = StreamingDenoiser(port_cfg, det_state, den_state, device="cpu",
                              **kw)
        assert s.pipeline.profile == want
    with pytest.raises(ValueError, match="compute_dtype"):
        StreamingDenoiser(port_cfg, det_state, den_state,
                          compute_dtype="float16", device="cpu")


def test_without_a_card_raises_instead_of_running_on_the_cpu(env):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, port_cfg, _, _, det_state, den_state = env
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingDenoiser(port_cfg, det_state, den_state)
