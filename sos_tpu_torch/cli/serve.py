"""Long-lived denoising server on the card: load once, serve many requests
(port of `sos_tpu/cli/serve.py`).

Usage:
    python -m sos_tpu_torch.cli.serve [--detector_ckpt latest \
        --denoiser_ckpt latest | --detector_pth det.pth \
        --denoiser_pth den.pth] [--profile int8] [--warmup] \
        [--chunk_seconds 2.0] [--threshold 0.5] [--device cpu]

Protocol (stdin/stdout, one request per line), `sos_tpu`'s:

    <input.wav>\t<output.wav>      denoise input -> output
    PING                           liveness check -> "PONG"
    STATS                          counters -> "STATS ok=N err=N audio_s=X
                                   busy_s=Y rtf=Z" (busy_s = compute-stage
                                   wall; rtf = served audio seconds per
                                   second of busy time, lifetime)
    QUIT                           graceful shutdown (drains pending work)

SIGTERM behaves like QUIT. Responses: "OK <output> <seconds_of_audio>
<wall_seconds>" or "ERR <message>"; `--warmup` prints "WARMED
widths=[...]" before "READY". The pipeline (weights on the card, the
kernel library, int8 scales) stays loaded across requests.

The serve loop is a three-stage pipeline over bounded queues:

    reader/decoder thread  ->  device dispatch (main)  ->  writer thread

so the host decodes request N+1 and writes result N-1 while the card
denoises request N. With `StreamingDenoiser.denoise_many_async` the
middle stage only enqueues device work on the denoiser's CUDA stream;
the wait for the results moves to the writer thread, so the card also
stays busy across batch boundaries. Responses to denoise requests are
emitted in request order; PONG is emitted at once by the reader.
"""

import argparse
import queue
import signal
import sys
import threading
import time

import numpy as np

from sos_tpu_torch.cli.common import (add_serving_args, config_from_args,
                                      default_calibration_path,
                                      experiment_dirs, load_checkpoint_states)
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.infer.streaming import StreamingDenoiser

_DONE = ("__done__", None, None)


def _one_line(exc: Exception) -> str:
    # one-line protocol: CUDA and torch errors are often multi-line
    return f"{type(exc).__name__}: " + " ".join(str(exc).split())[:500]


class ServeLoop:
    """The request pipeline, decoupled from stdin/stdout for testing.

    `denoise(wav) -> wav`, `load(path) -> (wav, sr)`,
    `write(path, wav, sr)`, `emit(line)` are injectable.
    """

    def __init__(self, denoise, load, write, sample_rate: int,
                 emit=None, depth: int = 4, denoise_many=None,
                 denoise_many_async=None):
        """`denoise_many([wav, ...]) -> [wav, ...]` (optional): batch
        concurrent requests into shared device dispatches (e.g.
        StreamingDenoiser.denoise_many); falls back to per-request
        `denoise` when absent.

        `denoise_many_async([wav, ...]) -> finalize` (optional): like
        denoise_many but split into a non-blocking device DISPATCH (the
        return) and a blocking `finalize() -> [wav, ...]` fetch. When
        present, the compute stage only dispatches: the writer thread
        runs finalize, so the card computes request batch N while the
        main loop dispatches batch N+1 and the writer fetches/writes
        batch N-1 — the device never idles between batches the way a
        synchronous compute stage leaves it idle during every result
        fetch + WAV write."""
        self.denoise = denoise
        self.denoise_many = denoise_many
        self.denoise_many_async = denoise_many_async
        self.load = load
        self.write = write
        self.sample_rate = sample_rate
        # Default emit: ONE atomic write call per line (print() issues
        # separate write(s)/write('\\n') calls, which can interleave
        # between the reader's PONGs and the writer's OK/ERR lines) plus
        # a lock so custom emit callables stay safe too.
        if emit is None:
            def emit(s):
                sys.stdout.write(s + "\n")
                sys.stdout.flush()
        lock = threading.Lock()
        raw_emit = emit
        self._emit_failed = None

        def locked_emit(s):
            with lock:
                raw_emit(s)

        self.emit = locked_emit
        self.depth = depth
        # lifetime counters (written by the writer thread, read by the
        # reader for STATS — plain attributes; torn reads are harmless)
        self.n_ok = 0
        self.n_err = 0
        self.audio_s = 0.0
        self.busy_s = 0.0
        # set here, NOT in run(): a SIGTERM during --warmup (handler is
        # installed before the warmup runs) must not be lost when
        # run() starts afterwards
        self._shutdown = False
        # True while the reader holds a request line it has not yet
        # enqueued (decode in progress) — the SIGTERM drain waits on it
        self._reader_busy = False

    def _fill_batch(self, q_dec, first):
        """One compute batch: `first` plus whatever else is already
        queued, up to `depth` — concurrent requests' chunks then share
        device dispatches via denoise_many."""
        batch = [first]
        while len(batch) < self.depth:
            try:
                batch.append(q_dec.get_nowait())
            except queue.Empty:
                break
        return batch

    def _process_batch(self, batch, q_out) -> None:
        """Denoise a drained batch and enqueue responses in ARRIVAL
        order (errors stay at their position relative to the requests
        drained with them); '__done__' sentinels are skipped."""
        reqs = [payload for kind, payload, _ in batch if kind == "req"]
        if reqs and self.denoise_many_async is not None:
            # pipelined path: dispatch here, fetch in the writer — the
            # next batch's dispatch overlaps this one's compute/fetch
            try:
                fin = self.denoise_many_async([wav for _, wav, _ in reqs])
            except Exception:
                fin = None  # dispatch failed: isolate per request below
            if fin is not None:
                entries = [e for e in batch if e[0] != "__done__"]
                q_out.put(("batch", (fin, entries), None))
                return
        # outs[i]: denoised wav or ("err", msg) — a failing request
        # must NOT poison the others drained with it
        outs: list = []
        if reqs:
            t_busy = time.perf_counter()
            if len(reqs) > 1 and self.denoise_many is not None:
                try:
                    outs = list(self.denoise_many(
                        [wav for _, wav, _ in reqs]))
                except Exception:
                    outs = []  # isolate per request below
            if not outs:
                for _, wav, _ in reqs:
                    try:
                        outs.append(self.denoise(wav))
                    except Exception as exc:
                        outs.append(("err", _one_line(exc)))
            # busy time measured around the compute stage only:
            # per-request walls overlap under pipelining, this does
            # not (STATS rtf stays meaningful)
            self.busy_s += time.perf_counter() - t_busy
        it = iter(outs)
        for kind, payload, err in batch:
            if kind == "err":
                q_out.put(("err", None, err))
            elif kind == "req":
                out = next(it)
                if isinstance(out, tuple) and out[0] == "err":
                    q_out.put(("err", None, out[1]))
                    continue
                dst, wav, t0 = payload
                q_out.put(("req", (dst, out,
                                   len(wav) / self.sample_rate, t0),
                           None))

    def request_shutdown(self) -> None:
        """Graceful EXTERNAL shutdown (SIGTERM from a supervisor):
        equivalent to a QUIT line — stop accepting new requests, finish
        everything already queued, emit BYE, return from run(). Safe to
        call from a signal handler: the sentinel is delivered from a
        helper thread so the handler never blocks on a full queue."""
        self._shutdown = True
        q = getattr(self, "_q_dec", None)
        if q is not None:
            threading.Thread(target=q.put, args=(_DONE,),
                             daemon=True).start()

    def run(self, lines) -> None:
        q_dec: "queue.Queue" = queue.Queue(maxsize=self.depth)
        q_out: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._q_dec = q_dec
        if self._shutdown:
            # SIGTERM already arrived (e.g. during --warmup): serve
            # nothing, still drain politely and emit BYE
            q_dec.put(_DONE)

        def reader_decoder():
            it = iter(lines)
            try:
                while True:
                    # shutdown/emit-failure are checked BEFORE pulling the
                    # next line, never after: a line the reader has already
                    # read off the input was received and must be answered
                    # (decoded + enqueued) even when SIGTERM lands while it
                    # is being handled — otherwise a supervisor redeploy
                    # silently drops a successfully submitted request.
                    if self._emit_failed is not None:
                        break  # client gone: stop accepting work
                    if self._shutdown:
                        break  # SIGTERM: stop accepting, drain queued
                    try:
                        raw = next(it)
                    except StopIteration:
                        break
                    # busy until this line's request (if any) is safely
                    # in q_dec — the SIGTERM drain keys off it, so a
                    # request whose decode is in flight when the signal
                    # lands still gets its response
                    self._reader_busy = True
                    try:
                        line = raw.strip()
                        if not line:
                            continue
                        if line == "QUIT":
                            break
                        if line == "PING":
                            self.emit("PONG")
                            continue
                        if line == "STATS":
                            # busy_s = non-overlapping compute-stage wall,
                            # so rtf = served audio per sec of card time
                            rtf = self.audio_s / self.busy_s \
                                if self.busy_s > 0 else 0.0
                            self.emit(
                                f"STATS ok={self.n_ok} err={self.n_err} "
                                f"audio_s={self.audio_s:.2f} "
                                f"busy_s={self.busy_s:.2f} rtf={rtf:.1f}")
                            continue
                        try:
                            src, dst = line.split("\t")
                        except ValueError:
                            q_dec.put(("err", None,
                                       f"bad request line: {line[:100]!r}"))
                            continue
                        t0 = time.perf_counter()
                        try:
                            wav, _ = self.load(src)
                        except Exception as exc:
                            q_dec.put(("err", None, _one_line(exc)))
                            continue
                        q_dec.put(("req",
                                   (dst, np.asarray(wav, np.float32), t0),
                                   None))
                    finally:
                        self._reader_busy = False
            finally:
                q_dec.put(_DONE)

        def finish_one(kind, payload, err):
            """Emit one response (ERR, or write + OK)."""
            if kind == "err":
                self.n_err += 1
                self.emit(f"ERR {err}")
                return
            dst, out, secs, t0 = payload
            try:
                self.write(dst, out, self.sample_rate)
            except Exception as exc:
                self.n_err += 1
                self.emit(f"ERR {_one_line(exc)}")
                return
            wall = time.perf_counter() - t0
            self.n_ok += 1
            self.audio_s += secs
            self.emit(f"OK {dst} {secs:.2f} {wall:.2f}")

        def finish_batch(payload):
            """Pipelined batch: fetch the dispatched results here (the
            main loop is already dispatching the NEXT batch), then emit
            responses in arrival order."""
            fin, entries = payload
            reqs = [p for k, p, _ in entries if k == "req"]
            t_busy = time.perf_counter()
            try:
                outs = list(fin())
            except Exception:
                # a failing request must not poison the batch: re-run
                # per request (rare path; compute lands on this thread)
                outs = []
                for _, wav, _ in reqs:
                    try:
                        outs.append(self.denoise(wav))
                    except Exception as exc:
                        outs.append(("err", _one_line(exc)))
            # busy_s sums the writer-side fetch walls — non-overlapping
            # (single writer thread), so STATS rtf stays meaningful
            self.busy_s += time.perf_counter() - t_busy
            it = iter(outs)
            for kind, payload, err in entries:
                if kind == "err":
                    finish_one("err", None, err)
                    continue
                out = next(it)
                if isinstance(out, tuple) and out[0] == "err":
                    finish_one("err", None, out[1])
                    continue
                dst, wav, t0 = payload
                finish_one("req", (dst, out,
                                   len(wav) / self.sample_rate, t0), None)

        def writer():
            # A dead client (BrokenPipeError from emit) must NOT strand
            # the pipeline: record the failure and keep DRAINING the
            # queue so the main loop's puts never block forever.
            while True:
                kind, payload, err = q_out.get()
                if kind == "__done__":
                    break
                if self._emit_failed is not None:
                    continue  # drain without emitting
                try:
                    if kind == "batch":
                        finish_batch(payload)
                    else:
                        finish_one(kind, payload, err)
                except Exception as exc:  # emit itself failed
                    self._emit_failed = exc

        rt = threading.Thread(target=reader_decoder, daemon=True)
        wt = threading.Thread(target=writer, daemon=True)
        rt.start()
        wt.start()
        done = False
        try:
            while not done:
                # Greedily drain whatever else is already queued: with a
                # denoiser exposing denoise_many, concurrent requests'
                # chunks share device dispatches instead of each paying
                # a mostly-empty chunk batch.
                batch = self._fill_batch(q_dec, q_dec.get())
                done = any(k == "__done__" for k, _, _ in batch)
                self._process_batch(batch, q_out)
            # final drain, SIGTERM path only: request_shutdown's _DONE is
            # injected out-of-band and can overtake a request the reader
            # is decoding right now — that request must still get a
            # response before BYE, HOWEVER long its decode takes: while
            # the reader is alive and mid-line (_reader_busy) the drain
            # keeps waiting; once the reader is idle (blocked on the
            # input stream) and the queue is empty, nothing is in flight.
            # (On the QUIT path the reader enqueues its own sentinel
            # strictly after its last request, so there is nothing to
            # wait for.)
            while self._shutdown:
                try:
                    first = q_dec.get(timeout=0.2)
                except queue.Empty:
                    if rt.is_alive() and self._reader_busy:
                        continue  # decode in flight: wait for its enqueue
                    break
                self._process_batch(self._fill_batch(q_dec, first), q_out)
        finally:
            q_out.put(_DONE)
            wt.join()
        if self._emit_failed is not None:
            raise self._emit_failed  # exit like the pre-pipelined loop did
        self.emit("BYE")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_serving_args(parser)
    parser.add_argument("--chunk_seconds", type=float, default=2.0)
    parser.add_argument("--overlap_seconds", type=float, default=0.5)
    parser.add_argument("--detector_context_seconds", type=float,
                        default=None,
                        help="total detector window per chunk "
                             "(two-pass mode): > chunk_seconds "
                             "prepends left context for low-SNR "
                             "detection without changing chunk "
                             "latency (e.g. 6.0 below ~-5 dB SNR)")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--profile", type=str, default=None,
                        choices=("f32", "bf16", "int8"))
    parser.add_argument("--calibration_json", type=str, default=None)
    parser.add_argument("--transfer_dtype", type=str, default="float32",
                        choices=("float32", "int16"),
                        help="wire dtype for host<->device waveforms; "
                             "int16 halves transfer bytes (lossless for "
                             "16-bit PCM inputs, output within 1/65536)")
    parser.add_argument("--exact_f32_head", action="store_true",
                        help="int8 profile: exact-f32 LSTM input "
                             "projection instead of the default bf16")
    parser.add_argument("--warmup", action="store_true",
                        help="run every power-of-two chunk-batch width "
                             "before READY, so no request meets a "
                             "first-use cost")
    args = parser.parse_args()

    cfg = config_from_args(args)
    det_state, den_state = load_checkpoint_states(parser, args, cfg)
    _, _, den_dir = experiment_dirs(cfg, "denoiser")
    calib = default_calibration_path(den_dir, args.profile,
                                     args.calibration_json)
    stream = StreamingDenoiser(
        cfg, det_state, den_state, chunk_seconds=args.chunk_seconds,
        detector_context_seconds=args.detector_context_seconds,
        overlap_seconds=args.overlap_seconds, threshold=args.threshold,
        profile=args.profile, calibration_path=calib,
        transfer_dtype=args.transfer_dtype,
        bf16_head_proj=not args.exact_f32_head, device=args.device)

    loop = ServeLoop(
        denoise=stream.denoise,
        denoise_many=stream.denoise_many,
        denoise_many_async=stream.denoise_many_async,
        load=lambda p: audio_io.load(p, sr=cfg.data.sample_rate),
        write=audio_io.write_wav,
        sample_rate=cfg.data.sample_rate)
    # SIGTERM (supervisor redeploy) == a QUIT line: finish queued work,
    # answer everything received, emit BYE, exit 0
    signal.signal(signal.SIGTERM, lambda *_: loop.request_shutdown())

    if args.warmup:
        widths = stream.warmup()
        print(f"WARMED widths={widths}", flush=True)
    print("READY", flush=True)
    loop.run(sys.stdin)


if __name__ == "__main__":
    main()
