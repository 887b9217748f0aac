"""ctypes bindings for the C++ audio runtime (port of
`sos_tpu/runtime/engine.py`; `audio_engine.cpp` is `sos_tpu`'s source).

The library is built with g++ on first use into the git-ignored
`<repo>/build/sos_tpu_torch/libsosaudio_<hash>.so`, named by a hash of
the source and flags as `kernels/build.py` names the CUDA library, so an
edited source builds anew and the source tree stays clean. Every entry
point has the pure-Python route of `sos_tpu_torch.dsp.audio_io`, which
the callers take when the library cannot be built (no compiler): the
same samples for decoding; the native resampler differs from scipy's by
float rounding.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "audio_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sos_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    """Where the library for the current source and flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsosaudio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (if not built yet) and return the library's path; raises
    when g++ is missing or fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE),
                        "-lpthread", "-lm"],
                       check=True, capture_output=True)
        os.replace(tmp, target)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError):
            _failed = True
            return None
        lib.decode_wav.restype = ctypes.c_int64
        lib.decode_wav.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int32)]
        lib.wav_info.restype = ctypes.c_int64
        lib.wav_info.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int32)]
        lib.resample_poly.restype = ctypes.c_int64
        lib.resample_poly.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.POINTER(ctypes.c_float)]
        lib.mix_at_snr.restype = None
        lib.mix_at_snr.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.load_batch.restype = ctypes.c_int32
        lib.load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return lib


def resampled_length(n: int, native_sr: int, target_sr: int) -> int:
    """Output length of the engine's polyphase resampler for an n-sample
    input: ceil(n * up / down), the convention `NativeAudioEngine.load`
    and the C++ `load_worker` clamp share."""
    if native_sr == target_sr:
        return n
    g = math.gcd(target_sr, native_sr)
    up, down = target_sr // g, native_sr // g
    return (n * up + down - 1) // down


def native_available() -> bool:
    """True when the library is built (or builds now) and loads."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeAudioEngine:
    """Decode/resample/mix through the C++ library (numpy in/out)."""

    def __init__(self, num_threads: int = 4):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("libsosaudio unavailable (g++ missing?)")
        self.num_threads = num_threads

    def info(self, path: str) -> Tuple[int, int]:
        sr = ctypes.c_int32(0)
        n = self.lib.wav_info(path.encode(), ctypes.byref(sr))
        if n < 0:
            raise IOError(f"wav_info failed: {path}")
        return int(n), int(sr.value)

    def load(self, path: str,
             sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
        n, native_sr = self.info(path)
        buf = np.empty(n, dtype=np.float32)
        got_sr = ctypes.c_int32(0)
        got = self.lib.decode_wav(path.encode(), _fptr(buf), n,
                                  ctypes.byref(got_sr))
        if got < 0:
            raise IOError(f"decode failed: {path}")
        buf = buf[:got]
        if sr is None or sr == native_sr:
            return buf, native_sr
        g = math.gcd(sr, native_sr)
        up, down = sr // g, native_sr // g
        out = np.empty(resampled_length(len(buf), native_sr, sr),
                       dtype=np.float32)
        m = self.lib.resample_poly(_fptr(buf), len(buf), up, down, 12.9846,
                                   _fptr(out))
        return out[:m], sr

    def load_batch(self, paths: List[str], target_sr: int,
                   max_samples: int) -> Tuple[np.ndarray, np.ndarray]:
        """Threaded decode+resample of many files into one (N, max) buffer."""
        n = len(paths)
        out = np.zeros((n, max_samples), dtype=np.float32)
        lengths = np.zeros(n, dtype=np.int64)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        status = self.lib.load_batch(
            arr, n, _fptr(out.reshape(-1)), max_samples, target_sr,
            self.num_threads,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if status != 0:
            bad = [paths[i] for i in range(n) if lengths[i] < 0]
            raise IOError(f"load_batch failures: {bad}")
        return out, lengths

    def mix_at_snr(self, clean: np.ndarray, noise: np.ndarray,
                   snr_db: float, norm: float = 0.5):
        n = len(clean)
        clean = np.ascontiguousarray(clean, dtype=np.float32)
        noise = np.ascontiguousarray(noise, dtype=np.float32)
        mixed = np.empty(n, np.float32)
        c_out = np.empty(n, np.float32)
        n_out = np.empty(n, np.float32)
        self.lib.mix_at_snr(_fptr(clean), _fptr(noise), n, float(snr_db),
                            float(norm or 0.0), _fptr(mixed), _fptr(c_out),
                            _fptr(n_out))
        return mixed, c_out, n_out
