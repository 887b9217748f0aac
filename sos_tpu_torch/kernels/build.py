"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` is compiled by its own nvcc process, all started
together, for sm_90a; the objects are linked into one shared library
under `<repo>/build/sos_tpu_torch/`, named by a hash of the sources and
flags so that an edited source builds anew; the compilers' output
(`-Xptxas=-v`: each kernel's registers, shared memory and spills) is
kept beside it in a `.log` file of the same name. The sources have a plain C
interface and include no PyTorch header, which keeps the build to
seconds. Each C entry point launches on the stream it is given,
allocates nothing, and returns `cudaGetLastError()`; `launch` raises if
that is not 0.

Nothing is built when this module is imported: the first `library()`
call builds (hosts without nvcc import every module).

`--use_fast_math` is deliberately absent: `logf`, `expf` and `tanhf`
must stay the accurate ones (the cRM epsilons of K3 sit far below the
fast versions' error).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sos_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    # y, PFA float table, PFA slots, out, B, L, T, pad (255 centered, 0
    # for center=False), stream
    "sos_stft": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # K1's generic instance: y, the analysis table's rows in the window's
    # support, zero-padded to whole tiles (k_pad, n_pad), out, B, L, T,
    # n_out, n_pad, hop, pad (n_fft // 2 centered, 0 for center=False),
    # the window's first table row and its length, stream
    "sos_stft_dense": (_P, _P, _P) + (_I,) * 9 + (_P,),
    # K1's "fft" instance: y, the `device_fft_tables` floats and ints, out,
    # B, L, T, n_fft, hop, pad (n_fft // 2 centered, 0 for center=False),
    # the window's first sample and its length, transforms a block,
    # shared bytes (`fft_launch_shape`), stream
    "sos_stft_fft": (_P,) * 4 + (_I,) * 10 + (_P,),
    # mixed, bits, geometry (body | gap << 16), frames of each 256-sample
    # chunk, out, B, L, num_frames, the most frames a span reads,
    # complement (1: gate by 1 - mask), stream
    "sos_mask_gate": (_P,) * 5 + (_I,) * 5 + (_P,),
    # the generic despeckle: mixed, bits, geometry, out, B, L, num_frames,
    # min_run, rows a block, complement, stream
    "sos_mask_despeckle": (_P,) * 4 + (_I,) * 6 + (_P,),
    # crm, spec, PFA float table, PFA slots, valid_t (int32 (B,) or NULL),
    # out, B, T, out_len, stream
    "sos_crm_istft": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # K3's generic instance: crm, spec, synthesis table (2F, n_fft), the
    # squared window, valid_t (int32 (B,) or NULL), out, B, T, F, n_fft,
    # hop, out_len, stream
    "sos_crm_istft_dense": (_P,) * 6 + (_I,) * 6 + (_P,),
    # K3's "fft" instance: crm, spec, the `device_fft_tables` floats and
    # ints, valid_t (int32 (B,) or NULL), out, B, T, n_fft, hop, output
    # hops a block, transforms a block, shared bytes (`fft_launch_shape`),
    # out_len, stream
    "sos_crm_istft_fft": (_P,) * 6 + (_I,) * 8 + (_P,),
    # xp_fwd, xp_bwd, w_hh_fwd, w_hh_bwd, lengths ((B,) int32 or int64,
    # or NULL), their stride in elements and their width in bytes, out,
    # B, T, H, then the plan: rows a block, cluster, lanes a unit, float4
    # columns of W_hh a lane holds, units a block, threads, shared bytes;
    # stream
    "sos_bilstm": (_P,) * 5 + (_I, _I, _P) + (_I,) * 10 + (_P,),
    # the training instance: xp_fwd, xp_bwd, w_hh_fwd, w_hh_bwd, out, c
    # (2, B, T, H), activated gates (2, B, T, 4H), B, T, H, the plan as
    # above; stream
    "sos_bilstm_train": (_P,) * 7 + (_I,) * 10 + (_P,),
    # K4b: dout (B, T, 2H), gates, c, w_hh_fwd, w_hh_bwd, dxp (2, B, T,
    # 4H), B, T, H, then `backward_plan`: rows a block, cluster, lanes a
    # quad of units, float4 columns a lane, threads, shared bytes; stream
    "sos_bilstm_bwd": (_P,) * 6 + (_I,) * 9 + (_P,),
    # K4's wide route: xp_fwd, xp_bwd, w_hh_fwd, w_hh_bwd, lengths (or
    # NULL), their stride and width, out, c and activated gates (the
    # training instance; else NULL), the zeroed scratch, B, T, H, then
    # `wide_plan`: blocks a direction, rows a task, rows staged, columns
    # staged, threads, shared bytes; stream
    "sos_bilstm_wide": (_P,) * 5 + (_I, _I) + (_P,) * 4 + (_I,) * 9 + (_P,),
    # K4b's wide route: dout, gates, c, W_hh^T fwd and bwd (H, 4H), dxp,
    # the zeroed scratch, B, T, H, the plan as above; stream
    "sos_bilstm_wide_bwd": (_P,) * 7 + (_I,) * 9 + (_P,),
    # K4's inference instance and K4b: rows a block, cluster, lanes a
    # unit, float4 columns a lane, threads, shared bytes, int* count
    "sos_bilstm_max_clusters": (_I,) * 6 + (_P,),
    "sos_bilstm_bwd_max_clusters": (_I,) * 6 + (_P,),
    # the wide route: rows a task, mode (0 K4, 1 its training instance, 2
    # K4b), W_hh's rows float4-aligned, threads, shared bytes, int* count
    "sos_bilstm_wide_coresident": (_I,) * 5 + (_P,),
    # a (M, K), b^T (N, K), out, M, N, K, tile width, stream
    "sos_int8_gemm": (_P, _P, _P) + (_I,) * 4 + (_P,),
    # x, w, w_s, bias, out, valid_t (int32 (B,) or NULL), B, H, W, Cin,
    # Cout, kh, kw, dh, dw, kpad, out_f32, stream
    "sos_int8_conv_same": (_P,) * 6 + (_I,) * 11 + (_P,),
    # x, w, w_s, bias, out, valid_t (int32 (B,) or NULL), plan (host
    # int32), B, H, W, Cin, Cout, kh, kw, dh, dw, kpad, stream
    "sos_int8_conv_same_halo": (_P,) * 7 + (_I,) * 10 + (_P,),
    # K6's first layer: x, w, w_s, bias, out, valid_t (int32 (B,) or
    # NULL), B, H, W, Cout, kpad, stream
    "sos_int8_conv_first": (_P,) * 6 + (_I,) * 5 + (_P,),
    # K6's projection: x, w, w_s, bias, out (float32), valid_t (int32 (B,)
    # or NULL), B, H, W, Cin, Cout, kpad, stream
    "sos_int8_conv_proj": (_P,) * 6 + (_I,) * 6 + (_P,),
    # x, w, w_s, bias, alpha, out, valid_t in and out (int32 (B,) or
    # NULL), B, H, W, Cin, Ho, Wo, Cout, k, stride, dil, pad, up, kpad,
    # stream
    "sos_int8_conv_inpaint": (_P,) * 8 + (_I,) * 13 + (_P,),
    # x, xg (gather scratch or NULL), w, w_s, bias, alpha, out, valid_t
    # in and out (int32 (B,) or NULL), plan (host int32), B, H, W, Cin,
    # Cout, kpad, stream
    "sos_int8_inpaint_halo": (_P,) * 10 + (_I,) * 6 + (_P,),
}

# Launches per kernel: each wrapper adds one where it launches its kernel
# (one CUDA launch per wrapper call), under a lock, since the serve loop
# launches from two threads. The length-bucketed cases count apart: K1
# with center=False, K3 with per-row valid_t, K4 with per-row lengths,
# K6 and K7 with per-row valid_t; so do the training path's instances:
# K2 gating by 1 - mask, K4's training forward and its backward K4b; and
# K2's windows past 2^24 mask elements and its generic despeckle; and
# K1's and K3's "fft" and generic instances (every STFT geometry but the
# default); and K4's and K4b's wide route past the register plans'
# hidden sizes.
LAUNCHES: Dict[str, int] = {"stft": 0, "stft_center_false": 0,
                            "stft_fft": 0, "stft_fft_center_false": 0,
                            "stft_generic": 0,
                            "stft_generic_center_false": 0,
                            "mask_gate": 0, "mask_gate_complement": 0,
                            "mask_gate_long": 0, "mask_gate_despeckle": 0,
                            "crm_istft": 0,
                            "crm_istft_valid_t": 0,
                            "crm_istft_fft": 0, "crm_istft_fft_valid_t": 0,
                            "crm_istft_generic": 0,
                            "crm_istft_generic_valid_t": 0, "bilstm": 0,
                            "bilstm_lengths": 0, "bilstm_train": 0,
                            "bilstm_bwd": 0, "bilstm_wide": 0,
                            "bilstm_lengths_wide": 0,
                            "bilstm_train_wide": 0, "bilstm_bwd_wide": 0,
                            "int8_gemm": 0,
                            "int8_conv": 0, "int8_conv_valid_t": 0,
                            "int8_inpaint": 0, "int8_inpaint_valid_t": 0}
# The same launches by C entry point (K6 has four routes, K7 two)
ENTRY_LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES
                                  if not name.endswith(("_max_clusters",
                                                        "_coresident"))}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, ENTRY_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile (if not built yet) and return the shared library's path."""
    target = BUILD_DIR / f"libsos_kernels_{_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, logs = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out.decode(errors='replace')}")
            if proc.returncode != 0:
                errors.append(logs[-1])
        # ptxas' registers, shared memory and spills of every kernel
        target.with_suffix(".log").write_text("\n".join(logs))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib, target)  # atomic: concurrent builds agree
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.sos_error_string.argtypes = [ctypes.c_int]
            lib.sos_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def aligned16(x: "torch.Tensor") -> "torch.Tensor":
    """`x` contiguous and 16-byte aligned, for kernels that copy it in
    16-byte chunks: a view at an odd offset is cloned."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


@contextlib.contextmanager
def on_device(device: "torch.device"):
    """Make `device` current for a launch (only if it is not already) and
    yield the handle of its current stream, read as an int as Triton's
    launcher does: building a `torch.cuda.Stream` and switching devices
    on every call cost more host time than a small kernel takes."""
    import torch
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        yield torch._C._cuda_getCurrentRawStream(index)
        return
    with torch.cuda.device(index):
        yield torch._C._cuda_getCurrentRawStream(index)


def launch(kernel: str, symbol: str, *args) -> None:
    """Call one C entry point, raise on a CUDA error, count the launch."""
    lib = library()
    rc = getattr(lib, symbol)(*args)
    if rc != 0:
        msg = lib.sos_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
    with _count_lock:
        LAUNCHES[kernel] += 1
        ENTRY_LAUNCHES[symbol] += 1
