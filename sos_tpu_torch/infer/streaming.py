"""Long-form streaming denoise (port of `sos_tpu/infer/streaming.py`).

Chunked inference with overlap-add crossfade over `FusedDenoisePipeline`:
an utterance of any length is cut into fixed-size chunks, the chunks of
one or many utterances are batched through the pipeline, and the
results are overlap-added with triangular crossfades. The chunking, the
length contract, the two-pass boundary-consistent mode, the
most-interior-decision-wins `reconcile_bits` and the crossfade arithmetic
are `sos_tpu`'s, line for line (its module docstring has the reasoning
and the geometry guidance); the numpy helpers give the same bits.

Length contract: a multi-chunk utterance returns exactly its input
length; an utterance that fits ONE chunk returns min(n, valid) samples,
valid = floor(chunk/hop)*hop, the iSTFT's valid span.

Device work. `sos_tpu` leans on JAX's asynchronous dispatch: a host
array and a jitted call only enqueue work. Here every device call of one
`StreamingDenoiser` runs on one CUDA stream that it owns; the thread that
dispatches and the thread that runs a `finalize` both enter it, so the
order work is enqueued in is the order it runs in. A chunk batch goes up
from pinned host memory (`non_blocking`), the pipeline's kernels are
enqueued behind it, the result comes back into a pinned buffer
(`non_blocking`) and an event is recorded behind that copy; fetching a
result waits on its event, never on the whole device. The pinned input,
the device tensors and the pinned output stay referenced until the
event has completed: the caching allocators then may hand their blocks
out again, and since every allocation of this work is made on the one
stream, a block freed by one thread is reused in stream order by the
other. On the CPU (`device="cpu"`) the same calls run the plain
versions synchronously.

Batch widths stay `sos_tpu`'s power-of-two buckets: a partial batch
pads to the next power of two (at most `batch_chunks`), so the card sees
a handful of fixed batch shapes.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Mapping, Optional

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.infer.fused import (FusedDenoisePipeline, wire_decode,
                                       wire_encode)

_PROFILES = {"float32": "f32", "bfloat16": "bf16"}


class StreamingDenoiser:
    def __init__(self, cfg: ExperimentConfig, detector_state: Mapping,
                 denoiser_state: Mapping, chunk_seconds: float = 2.0,
                 overlap_seconds: float = 0.5, batch_chunks: int = 16,
                 threshold: float = 0.5, compute_dtype: str = "float32",
                 consistent_boundaries: bool = True,
                 profile: Optional[str] = None,
                 calibration_path: Optional[str] = None,
                 transfer_dtype: str = "float32",
                 pipeline_depth: int = 2, bf16_head_proj: bool = True,
                 detector_context_seconds: Optional[float] = None,
                 device="cuda"):
        """The arguments are `sos_tpu`'s, plus `device` ("cuda", the
        default, or "cpu").

        `profile` ("f32" | "bf16" | "int8") wins; without it
        `compute_dtype` picks "f32" (float32) or "bf16" (bfloat16).

        `transfer_dtype="int16"` ships waveform chunks to the card and
        denoised audio back as int16 wire samples (`infer/fused.py`):
        half the bytes each way, lossless on input for 16-bit PCM.
        Inputs past full scale clamp to [-1, 32767/32768] on the way in.

        `pipeline_depth`: how many chunk-batch dispatches may be in
        flight at once (see `_batched_async`).

        `detector_context_seconds` (two-pass mode only): the window the
        detector sees per chunk; beyond `chunk_seconds` it prepends real
        left context (zeros before the utterance head), whose frames are
        cropped before reconciliation. The excess must be a whole number
        of detector frames and samples."""
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype must be float32|int16, "
                             f"got {transfer_dtype!r}")
        if profile is None:
            if compute_dtype not in _PROFILES:
                raise ValueError(f"compute_dtype must be float32|bfloat16, "
                                 f"got {compute_dtype!r}")
            profile = _PROFILES[compute_dtype]
        self.transfer_dtype = transfer_dtype
        self.cfg = cfg
        self.pipeline = FusedDenoisePipeline(
            cfg, detector_state, denoiser_state, threshold=threshold,
            clip_seconds=chunk_seconds, profile=profile,
            calibration_path=calibration_path, wire_dtype=transfer_dtype,
            bf16_head_proj=bf16_head_proj, device=device)
        self.device = self.pipeline.device
        # the one stream all of this denoiser's device work runs on
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        sr = cfg.data.sample_rate
        hop = cfg.stft.hop_length
        self.chunk = self.pipeline.clip_samples
        # iSTFT yields floor(L/hop)*hop samples per chunk
        self.valid = (self.chunk // hop) * hop
        self.overlap = int(overlap_seconds * sr)
        # at most two chunks cover a sample: the crossfade ramps stay
        # complementary and reconcile_bits stays pairwise
        assert 0 <= 2 * self.overlap <= self.valid, (
            f"overlap_seconds={overlap_seconds} must satisfy "
            f"0 <= overlap <= {self.valid / (2 * sr):.4f}s (half the "
            f"iSTFT-valid span of a {chunk_seconds}s chunk, so every "
            "sample is covered by at most two chunks)")
        self.stride = self.valid - self.overlap
        self.batch_chunks = batch_chunks
        self.consistent_boundaries = consistent_boundaries
        assert pipeline_depth >= 1, pipeline_depth
        self.pipeline_depth = pipeline_depth
        # detector-context halo (left context, two-pass mode only)
        ctx = detector_context_seconds
        if ctx is None or ctx == chunk_seconds:
            self.det_halo = 0
            self.det_halo_frames = 0
        else:
            if not consistent_boundaries:
                raise ValueError(
                    "detector_context_seconds requires the two-pass "
                    "consistent_boundaries mode (one-pass denoising is "
                    "a single fused program with no separate detect)")
            if ctx < chunk_seconds:
                raise ValueError(
                    f"detector_context_seconds={ctx} must be >= "
                    f"chunk_seconds={chunk_seconds}")
            halo_s = ctx - chunk_seconds
            fps = cfg.data.frame_rate
            halo_frames = halo_s * fps
            halo_samples = halo_s * sr
            if (abs(halo_frames - round(halo_frames)) > 1e-6
                    or abs(halo_samples - round(halo_samples)) > 1e-6):
                raise ValueError(
                    f"detector context excess {halo_s}s must be a whole "
                    f"number of detector frames (x{fps}/s) and samples "
                    f"(x{sr}/s) so context frames crop exactly")
            self.det_halo = int(round(halo_samples))
            self.det_halo_frames = int(round(halo_frames))

    def _det_windows(self, wav: np.ndarray, starts) -> np.ndarray:
        """Detector-halo windows: chunk i's window covers
        [start_i - det_halo, start_i + chunk), zero-padded outside the
        utterance."""
        halo = self.det_halo
        out = np.zeros((len(starts), halo + self.chunk), dtype=np.float32)
        for i, s in enumerate(starts):
            lo = s - halo
            seg = wav[max(0, lo): s + self.chunk]
            dst = max(0, -lo)
            out[i, dst: dst + len(seg)] = seg
        return out

    def _weights(self) -> np.ndarray:
        w = np.ones(self.valid, dtype=np.float32)
        if self.overlap == 0:
            return w  # no crossfade: chunks abut exactly
        # ramp centred on the half-sample grid: every position keeps a
        # strictly positive weight, aligned pairs still sum to exactly 1
        ramp = ((np.arange(self.overlap) + 0.5) / self.overlap).astype(
            np.float32)
        w[: self.overlap] = ramp
        w[-self.overlap:] = ramp[::-1]
        return w

    def denoise(self, waveform: np.ndarray) -> np.ndarray:
        """Denoise arbitrary-length audio at the processing sample rate."""
        return self.denoise_many([waveform])[0]

    def warmup(self, max_width: Optional[int] = None) -> list:
        """Run every power-of-two chunk-batch width up to `max_width`
        (default: batch_chunks) and the full width once, so a live server
        meets no first-use cost mid-traffic (kernel library load, cuDNN
        algorithm choice, device tables, allocator growth). In two-pass
        mode the detect/denoise pair runs too. An int8 profile without
        final scales (no scale file, not calibrated) is not warmed: the
        first real request calibrates. Returns the widths ([] when
        skipped)."""
        if not self.pipeline.ensure_calibrated():
            logging.getLogger(__name__).warning(
                "warmup skipped: int8 profile has no calibration scales "
                "yet (no persisted file) — the first real request will "
                "calibrate")
            return []
        cap = max_width or self.batch_chunks
        widths, w = [], 1
        while w < cap:
            widths.append(w)
            w *= 2
        # full batches dispatch at exactly batch_chunks, which need not
        # be a power of two
        widths.append(cap)
        rng = np.random.default_rng(0)
        for w in widths:
            chunks = (rng.standard_normal((w, self.chunk)) * 0.01).astype(
                np.float32)
            if self.consistent_boundaries:
                det_in = chunks if not self.det_halo else np.concatenate(
                    [np.zeros((w, self.det_halo), np.float32), chunks],
                    axis=1)
                bits = self._batched(self.pipeline.detect_bits, [det_in])
                bits = np.asarray(bits,
                                  np.float32)[:, self.det_halo_frames:]
                self._batched(self.pipeline.denoise_with_bits,
                              [chunks, bits])
            self._one_pass(chunks)
        return widths

    def denoise_many(self, waveforms) -> list:
        """Denoise several utterances, their chunks batched into shared
        dispatches. Per-utterance outputs equal `denoise` one at a time:
        chunking, bit reconciliation and overlap-add stay per-utterance."""
        return self.denoise_many_async(waveforms)()

    def denoise_many_async(self, waveforms):
        """Dispatch `denoise_many` without waiting; returns a
        `finalize() -> [wav, ...]` callable that waits for the results.

        The dispatch only enqueues work on this denoiser's stream, so a
        caller can overlap the fetch and host overlap-add of batch N with
        the dispatch of batch N+1 by running `finalize` on another thread
        (the serve loop's writer does). Call `finalize` exactly once; any
        thread may."""
        if not waveforms:
            return lambda: []
        slices = []  # (start_row, starts, n) per utterance
        all_chunks = []
        row = 0
        for wav in waveforms:
            n = len(wav)
            # one chunk when the utterance fits, else stride-spaced
            starts = [0] if n <= self.chunk else list(
                range(0, n, self.stride))
            chunks = np.zeros((len(starts), self.chunk), dtype=np.float32)
            for i, s in enumerate(starts):
                seg = wav[s:s + self.chunk]
                chunks[i, : len(seg)] = seg
            all_chunks.append(chunks)
            slices.append((row, starts, n))
            row += len(starts)
        stacked = np.concatenate(all_chunks, axis=0)

        # reconciliation is a no-op when every utterance fits one chunk:
        # the fused one-dispatch call serves that case, padded only to
        # the next power-of-two width
        all_single = all(len(starts) == 1 for _, starts, _ in slices)
        if self.consistent_boundaries and not all_single:
            # two-pass: detect goes out now; the bits fetch, host
            # reconciliation, denoise and overlap-add wait in finalize
            if self.det_halo:
                det_stacked = np.concatenate(
                    [self._det_windows(wav, sl[1])
                     for wav, sl in zip(waveforms, slices)], axis=0)
            else:
                det_stacked = stacked
            detect_fin = self._batched_async(self.pipeline.detect_bits,
                                             [det_stacked])

            def finalize():
                bits = detect_fin()
                if self.det_halo_frames:  # crop the left-context frames
                    bits = np.ascontiguousarray(
                        bits[:, self.det_halo_frames:])
                for r, starts, _ in slices:
                    bits[r:r + len(starts)] = self.reconcile_bits(
                        bits[r:r + len(starts)], starts)
                denoised = self._batched(self.pipeline.denoise_with_bits,
                                         [stacked, bits])
                return self._assemble(denoised, slices)
        else:
            fin = self._batched_async(lambda m: self.pipeline(m)[0],
                                      [stacked])

            def finalize():
                return self._assemble(fin(), slices)

        return finalize

    def _assemble(self, denoised: np.ndarray, slices) -> list:
        """Per-utterance crossfade/trim of the stacked denoised chunks."""
        w = self._weights()
        outs = []
        for r, starts, n in slices:
            chunks_out = denoised[r:r + len(starts)]
            if len(starts) == 1:
                outs.append(np.asarray(chunks_out[0])[: min(n, self.valid)])
                continue
            total = starts[-1] + self.valid
            acc = self._overlap_add(chunks_out * w, total)
            wsum = self._overlap_add(
                np.broadcast_to(w, chunks_out.shape), total)
            nz = wsum > 1e-8
            acc[nz] /= wsum[nz]
            outs.append(acc[:n])
        return outs

    def _overlap_add(self, weighted: np.ndarray, total: int) -> np.ndarray:
        """Vectorized overlap-add: chunk i occupies [i*stride, i*stride+valid),
        as K = ceil(valid/stride) stride-aligned phase blocks, phase p of
        chunk i landing on output block i+p."""
        n_chunks = len(weighted)
        k = -(-self.valid // self.stride)
        padded = np.zeros((n_chunks, k * self.stride), dtype=np.float32)
        padded[:, : self.valid] = weighted
        blocks = padded.reshape(n_chunks, k, self.stride)
        acc = np.zeros((n_chunks + k - 1, self.stride), dtype=np.float32)
        for p in range(k):
            acc[p : p + n_chunks] += blocks[:, p, :]
        return acc.reshape(-1)[:total]

    # ------------------------------------------------------------------

    def _batched(self, fn, arrays):
        """Run `fn` over fixed-size chunk batches; waits for the result.
        See `_batched_async`."""
        return self._batched_async(fn, arrays)()

    def _batched_async(self, fn, arrays):
        """Dispatch `fn` over fixed-size chunk batches without waiting;
        returns `finalize() -> stacked results` (numpy).

        Bucketing: a partial batch pads only to the next power of two
        (a lone 2 s request runs at width 1), at most `batch_chunks`.

        Pipelining: each batch is enqueued on the denoiser's stream
        (`_dispatch`) before older results are fetched; at most
        `pipeline_depth` batches are in flight (the oldest is fetched
        when the window fills), the rest are fetched in `finalize`."""
        if self.transfer_dtype == "int16":
            # only f32 waveform chunks take the wire encode; later arrays
            # (reconciled bits) stay float32, and a second encode of
            # bits or pre-encoded data is refused
            assert (arrays[0].dtype == np.float32
                    and arrays[0].shape[-1] in (
                        self.chunk, self.chunk + self.det_halo)), (
                "wire encode expects f32 waveform chunks (or detector-"
                "halo windows) first, got "
                f"{arrays[0].dtype} {arrays[0].shape}")
            arrays = [wire_encode(arrays[0]), *arrays[1:]]
        n = len(arrays[0])
        outs = []
        pending = deque()  # in-flight dispatches, oldest first

        def _fetch_one():
            host, done, _held, real = pending.popleft()
            if done is not None:
                done.synchronize()
            outs.append(host.numpy()[:real])

        for b in range(0, n, self.batch_chunks):
            tiles = [a[b:b + self.batch_chunks] for a in arrays]
            real = len(tiles[0])
            width = min(self.batch_chunks, 1 << (real - 1).bit_length())
            if real < width:
                tiles = [np.concatenate(
                    [t, np.zeros((width - real,) + t.shape[1:],
                                 dtype=t.dtype)]) for t in tiles]
            pending.append(self._dispatch(fn, tiles) + (real,))
            while len(pending) > self.pipeline_depth:
                _fetch_one()

        def finalize():
            while pending:
                _fetch_one()
            result = np.concatenate(outs, axis=0)
            if result.dtype == np.int16:  # wire-format denoised audio
                result = wire_decode(result)
            return result

        return finalize

    def _dispatch(self, fn, tiles):
        """Enqueue `fn` on one batch of host tiles. Returns
        `(host result, completion event or None, held tensors)`; the
        host result is complete once the event has."""
        tensors = [torch.from_numpy(np.ascontiguousarray(t)) for t in tiles]
        if self.stream is None:  # CPU: runs now
            return fn(*tensors), None, None
        with torch.cuda.stream(self.stream):
            pinned = [t.pin_memory() for t in tensors]
            inputs = [p.to(self.device, non_blocking=True) for p in pinned]
            out = fn(*inputs)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return host, done, (pinned, inputs, out)

    def _one_pass(self, chunks: np.ndarray) -> np.ndarray:
        return self._batched(lambda m: self.pipeline(m)[0], [chunks])

    def reconcile_bits(self, bits: np.ndarray, starts) -> np.ndarray:
        """Most-interior-decision-wins bit reconciliation across overlaps.

        Two-way, so both sides of every crossfade gate the same decisions
        over the whole overlap: in the leading half of the overlap chunk
        i adopts chunk i-1's decision (chunk i-1 saw those samples with
        full left context), in the trailing half chunk i-1 adopts chunk
        i's. Frame centres are matched to the nearest absolute-time
        centre (strides need not be whole frames)."""
        sr = self.cfg.data.sample_rate
        fps = self.cfg.data.frame_rate
        bits = bits.copy()
        num_frames = bits.shape[1]
        centers = (np.arange(num_frames) + 0.5) / fps  # chunk-local seconds
        half_ov = 0.5 * self.overlap / sr
        ov = self.overlap / sr
        for i in range(1, len(starts)):
            delta = (starts[i] - starts[i - 1]) / sr  # chunk offset, seconds
            lead = centers < half_ov
            prev_idx = np.round((centers + delta) * fps - 0.5).astype(int)
            ok = lead & (prev_idx >= 0) & (prev_idx < num_frames)
            bits[i, np.nonzero(ok)[0]] = bits[i - 1, prev_idx[ok]]
            # chunk i-1's frames in the trailing half of the overlap
            # ([delta+half_ov, delta+ov) in i-1-local time) adopt chunk
            # i's (own, un-replaced: local centers >= half_ov) decision
            trail = (centers >= delta + half_ov) & (centers < delta + ov)
            next_idx = np.round((centers - delta) * fps - 0.5).astype(int)
            ok = trail & (next_idx >= 0) & (next_idx < num_frames)
            bits[i - 1, np.nonzero(ok)[0]] = bits[i, next_idx[ok]]
        return bits


class StreamingSession:
    """Incremental streaming: push audio in, pull finalized audio out.

    `StreamingDenoiser.denoise` needs the whole waveform up front; a
    session takes pushes of any size and returns denoised audio as soon
    as every chunk covering it is final, with memory bounded by a chunk
    plus the detector-context halo (which looks back only, so it adds no
    latency).

    Equality contract: the concatenation of every `push()` return plus
    `flush()` equals `StreamingDenoiser.denoise(full_waveform)` to within
    float rounding (the session dispatches chunks at width 1, the offline
    path in power-of-two batches; single-chunk streams take the offline
    call itself). It replays the offline chunking, two-way bit
    reconciliation and crossfade incrementally:

    * a chunk is detected once its full window has been pushed;
    * detecting chunk k finalizes chunk k-1's bits (reconciliation is
      strictly pairwise, by 2*overlap <= valid);
    * chunk k-1 is then denoised and crossfaded into the carry, which
      finalizes every sample before k*stride (a sample is covered by at
      most two chunks, and a sum of two floats does not depend on their
      order, so the incremental sum is the offline one);
    * `flush()` zero-pads and processes the tail chunks as the offline
      layout does.

    Worst-case latency: a pushed sample comes out after at most
    `chunk + 2*stride` further samples (or at flush); one-pass mode
    (`consistent_boundaries=False`) has no cross-chunk dependency and
    the bound drops to `chunk + stride`.
    """

    def __init__(self, denoiser: StreamingDenoiser):
        self.d = denoiser
        self.chunk = denoiser.chunk
        self.stride = denoiser.stride
        self.valid = denoiser.valid
        self._w = denoiser._weights()
        self._buf = np.zeros(0, dtype=np.float32)  # samples >= _base
        self._base = 0            # absolute index of _buf[0]
        self._n = 0               # total samples pushed
        self._pending_bits = []   # raw bits, chunks [_next_den.._next_det)
        self._next_det = 0        # next chunk index to detect
        self._next_den = 0        # next chunk index to denoise
        self._acc = np.zeros(0, dtype=np.float32)   # crossfade carry
        self._wsum = np.zeros(0, dtype=np.float32)  # from _emit onward
        self._emit = 0            # absolute index of next sample to emit
        self._finished = False

    # -- internal ----------------------------------------------------------

    def _chunk_wave(self, k: int) -> np.ndarray:
        s = k * self.stride - self._base
        seg = self._buf[s: s + self.chunk]
        if len(seg) < self.chunk:  # flush-time tail: zero-pad
            seg = np.concatenate(
                [seg, np.zeros(self.chunk - len(seg), np.float32)])
        return seg

    def _det_wave(self, k: int) -> np.ndarray:
        """Chunk k's detector window [k*stride - det_halo, k*stride +
        chunk), zero-padded before absolute sample 0 and at the
        flush-time tail (the offline `_det_windows` stimulus)."""
        halo = self.d.det_halo
        lo = k * self.stride - halo  # absolute window start, may be < 0
        out = np.zeros(halo + self.chunk, np.float32)
        a = max(lo, 0)
        seg = self._buf[a - self._base:
                        k * self.stride + self.chunk - self._base]
        out[a - lo: a - lo + len(seg)] = seg
        return out

    def _detect(self, k: int) -> None:
        wave = self._det_wave(k) if self.d.det_halo else self._chunk_wave(k)
        bits = self.d._batched(self.d.pipeline.detect_bits, [wave[None]])
        self._pending_bits.append(
            np.asarray(bits[0], np.float32)[self.d.det_halo_frames:])
        self._next_det = k + 1
        if k > 0:
            # pairwise reconcile (k-1, k): finalizes k-1's bits, edits
            # k's leading half — the rule and order of reconcile_bits
            i = k - self._next_den  # local index of chunk k
            pair = np.stack([self._pending_bits[i - 1],
                             self._pending_bits[i]])
            pair = self.d.reconcile_bits(
                pair, [(k - 1) * self.stride, k * self.stride])
            self._pending_bits[i - 1] = pair[0]
            self._pending_bits[i] = pair[1]

    def _denoise_next(self) -> None:
        """Denoise chunk _next_den into the carry (two-pass: with its
        final reconciled bits; one-pass: one fused call)."""
        k = self._next_den
        wave = self._chunk_wave(k)
        if self.d.consistent_boundaries:
            out = self.d._batched(
                self.d.pipeline.denoise_with_bits,
                [wave[None], self._pending_bits.pop(0)[None]])[0]
        else:
            out = self.d._one_pass(wave[None])[0]
        self._next_den = k + 1
        # grow the carry to cover [emit_abs, k*stride + valid)
        start = k * self.stride
        end = start + self.valid
        acc_abs = self._emit
        need = end - acc_abs
        if len(self._acc) < need:
            pad = need - len(self._acc)
            self._acc = np.concatenate([self._acc,
                                        np.zeros(pad, np.float32)])
            self._wsum = np.concatenate([self._wsum,
                                         np.zeros(pad, np.float32)])
        lo = start - acc_abs
        self._acc[lo: lo + self.valid] += np.asarray(out,
                                                     np.float32) * self._w
        self._wsum[lo: lo + self.valid] += self._w
        # drop consumed input: chunk k+1 starts at (k+1)*stride, and its
        # detector window reaches det_halo samples further back
        new_base = max(0, (k + 1) * self.stride - self.d.det_halo)
        if new_base > self._base:
            self._buf = self._buf[new_base - self._base:]
            self._base = new_base

    def _take(self, upto_abs: int) -> np.ndarray:
        """Normalize + emit carry samples in [_emit, upto_abs)."""
        m = upto_abs - self._emit
        if m <= 0:
            return np.zeros(0, np.float32)
        out = self._acc[:m].copy()
        ws = self._wsum[:m]
        nz = ws > 1e-8
        out[nz] /= ws[nz]
        self._acc = self._acc[m:]
        self._wsum = self._wsum[m:]
        self._emit = upto_abs
        return out

    # -- public ------------------------------------------------------------

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed more audio; returns newly final denoised samples (possibly
        empty). Concatenated pushes + flush == offline denoise."""
        assert not self._finished, "push() after flush()"
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, samples])
        self._n += len(samples)
        # two-pass: detect every chunk whose full window is in, denoise
        # each chunk whose bits are final; one-pass: denoise each full
        # window at once. Either way nothing is emitted until the stream
        # provably has >= 2 chunks (the single-chunk offline fast path).
        if self.d.consistent_boundaries:
            while self._next_det * self.stride + self.chunk <= self._n:
                self._detect(self._next_det)
                if self._next_det >= 2:  # chunk _next_det-2 is final
                    self._denoise_next()
        else:
            while self._next_den * self.stride + self.chunk <= self._n:
                if self._next_den == 0 and self._n <= self.chunk:
                    break  # could still be a single-chunk stream
                self._denoise_next()
        if self._next_den == 0:
            return np.zeros(0, np.float32)
        return self._take(self._next_den * self.stride)

    def flush(self) -> np.ndarray:
        """End of stream: process the tail chunks, return the remaining
        audio. Total emitted == len(pushed audio) (a single-chunk stream
        returns min(n, valid))."""
        assert not self._finished, "flush() twice"
        self._finished = True
        n = self._n
        if n == 0:
            return np.zeros(0, np.float32)
        if n <= self.chunk and self._next_den == 0 and self._next_det <= 1:
            # the offline single-chunk layout: one fused call, no
            # crossfade; _base is still 0, so _buf holds the n samples
            return self.d.denoise(self._buf)
        # remaining chunk starts: every k*stride < n (offline layout)
        if self.d.consistent_boundaries:
            while self._next_det * self.stride < n:
                self._detect(self._next_det)
            while self._next_den < self._next_det:
                self._denoise_next()
        else:
            while self._next_den * self.stride < n:
                self._denoise_next()
        return self._take(n)
