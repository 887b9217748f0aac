"""Background batch prefetching (the reference's 60-70 DataLoader workers,
m1 common.py:57 / m2 common.py:53, re-shaped for the TPU split; the
port's copy of `sos_tpu/data/prefetch.py`).

Host batch assembly here is pure indexing + memcpy (decode is cached, DSP
runs on device), so ONE background thread with a small bounded queue is
enough to hide it behind the device step — the equivalent of torch's
worker pool + pin-memory prefetch for this pipeline. The thread fills
`depth` batches ahead; the train loop pops ready batches without blocking
on assembly.

Exceptions raised by the producer re-raise in the consumer; the thread is
a daemon and also stops promptly when the consumer drops the iterator
(close()/GC) mid-epoch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher(Iterator[T]):
    """Iterate `src` on a background thread, `depth` items ahead."""

    def __init__(self, src: Iterable[T], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err = None
        self._thread = threading.Thread(
            target=self._fill, args=(iter(src),), daemon=True)
        self._thread.start()

    def _fill(self, it) -> None:
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as exc:  # propagate to consumer
            self._err = exc
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self) -> "Prefetcher[T]":
        return self

    def __next__(self) -> T:
        # after exhaustion/close() the sentinel was already consumed —
        # a further next() must raise StopIteration per the iterator
        # protocol, not block forever on the empty queue
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._stop.set()
            if self._err is not None:
                err, self._err = self._err, None  # raise once
                raise err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # Drain so a producer blocked on the full queue observes the
        # stop flag, then WAIT for it to exit: the producer mutates the
        # batcher's shared (non-thread-safe) wav cache, so returning
        # while it still runs would race any post-close() user of the
        # batcher. Bounded join — the thread is a daemon and at worst
        # finishes its in-flight batch (decode included).
        deadline = 30.0
        while self._thread.is_alive() and deadline > 0:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            deadline -= 0.1
        # A consumer on ANOTHER thread may be blocked in __next__'s
        # q.get() (it checked _stop before we set it); the producer is
        # gone and its sentinel may have been drained above, so nothing
        # would ever wake it. Re-inject a sentinel non-blockingly — the
        # queue was just drained so this succeeds, and a stray sentinel
        # is harmless (post-close __next__ raises StopIteration before
        # reading the queue).
        try:
            self._q.put_nowait(_SENTINEL)
        except queue.Full:
            pass

    def __del__(self):  # pragma: no cover - GC timing
        self.close()


def prefetch(src: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Convenience wrapper: `for batch in prefetch(batcher): ...`"""
    return Prefetcher(src, depth=depth)
