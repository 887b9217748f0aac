#!/usr/bin/env python3
"""Time K6's first-layer and projection kernels (`csrc/int8_conv_edge.cu`)
on one card across launch shapes, and with parts of them taken out.

    python3 scripts/k6_edge_sweep.py [VARIANT ...]

Each variant is a copy of `csrc/int8_conv_edge.cu` under
`build/k6_edge_sweep/` with the edits `VARIANTS` lists (the kernel as it
is: "as_is"), built with nvcc as `kernels/build.py` does (all at once).
At every first-layer and projection shape of the int8 main path, 128
clips, each variant's entry point is timed with CUDA events
(`chip_smoke.time_ms`) and, unless it takes a part out, checked against
the plain version bit for bit. Variants whose names start with "no_"
compute nothing right: their difference from "as_is" is what the part
costs. Prints the card's name and power limit first. Compare variants
only within one run: two runs may land on two cards.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from sos_tpu_torch.kernels import build as kbuild  # noqa: E402
from sos_tpu_torch.ops import int8_conv  # noqa: E402

SOURCE = "int8_conv_edge.cu"
# variant -> (text, replacement) edits of the copy
VARIANTS = {
    "as_is": (),
    "first_chunk4": (
        ("constexpr int kFirstChunk = 16;", "constexpr int kFirstChunk = 4;"),),
    "first_bounds2": (
        ("__launch_bounds__(kFirstThreads, 4)",
         "__launch_bounds__(kFirstThreads, 2)"),),
    "proj_threads256": (
        ("constexpr int kProjThreads = 128;",
         "constexpr int kProjThreads = 256;"),),
    "no_first_loads": (
        ("geo.valid(q, &t, 3) ? __ldg(x16 + q) : 0;",
         "geo.valid(q, &t, 3) ? (uint16_t)(q * 40503u) : 0;"),),
    "no_first_epilogue": (
        ("q[2 * j + e] = requant_bits(\n"
         "            dequant_relu(acc[j][2 * r + e], ws[2 * j + e], "
         "b[2 * j + e]));",
         "q[2 * j + e] = (uint32_t)acc[j][2 * r + e];"),),
}
# (label, Cin, Cout, kernel, T, float32 out) at F 256, 128 clips
SHAPES = (
    ("first 2->48", 2, 48, (1, 7), 178, False),
    ("first 2->96", 2, 96, (1, 7), 178, False),
    ("proj 96->8", 96, 8, (1, 1), 178, True),
    ("proj 48->4", 48, 4, (1, 1), 178, True),
    ("proj 48->8 T60", 48, 8, (1, 1), 60, True),
)
BATCH = 128
ROOT = Path(kbuild.BUILD_DIR).parent / "k6_edge_sweep"


def build_variants(names) -> dict:
    """Each variant's library, built in parallel."""
    text = (kbuild.CSRC / SOURCE).read_text()
    procs = {}
    for name in names:
        d = ROOT / name
        d.mkdir(parents=True, exist_ok=True)
        src = text
        for old, new in VARIANTS[name]:
            if old not in src:
                raise RuntimeError(f"{name}: edit target not found: {old!r}")
            src = src.replace(old, new)
        (d / SOURCE).write_text(src)
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, f"-I{kbuild.CSRC}", "-shared",
             "-o", str(d / "lib.so"), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               f"{out.decode()[-3000:]}")
        regs = [ln.strip() for ln in out.decode().splitlines()
                if "registers" in ln]
        print(f"{name}: " + "; ".join(regs), flush=True)
        lib = ctypes.CDLL(str(ROOT / name / "lib.so"))
        for sym in ("sos_int8_conv_first", "sos_int8_conv_proj"):
            getattr(lib, sym).argtypes = list(kbuild.SIGNATURES[sym])
            getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_variants(names)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, cin, cout, ks, t, f32 in SHAPES:
        taps = ks[0] * ks[1] * cin
        kpad = -(-taps // 64) * 64
        w = torch.randint(-127, 128, (cout, kpad), generator=gen, device=dev,
                          dtype=torch.int8)
        w[:, taps:] = 0
        ws = (torch.rand(cout, generator=gen, device=dev) + 0.5) * 0.01 \
            / taps ** 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 20
        x = torch.randint(-127, 128, (BATCH, 256, t, cin), generator=gen,
                          device=dev, dtype=torch.int8)
        ref = int8_conv.conv_same_int8_plain(x, w, ws, b, ks, (1, 1), f32)
        out = torch.empty_like(ref)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [v.data_ptr() for v in (x, w, ws, b, out)]
        row = []
        for name, lib in libs.items():
            if f32:
                call = lambda lib=lib: lib.sos_int8_conv_proj(  # noqa: E731
                    *ptrs, None, BATCH, 256, t, cin, cout, kpad, stream)
            else:
                call = lambda lib=lib: lib.sos_int8_conv_first(  # noqa: E731
                    *ptrs, None, BATCH, 256, t, cout, kpad, stream)
            out.zero_()
            rc = call()
            if rc != 0:
                raise RuntimeError(f"{name} {label}: CUDA error {rc}")
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, ref))
            if not name.startswith("no_") and not exact:
                raise RuntimeError(f"{name} {label}: differs from plain")
            row.append(f"{name} {chip_smoke.time_ms(call):.4f}"
                       + ("" if exact else " (not exact)"))
        print(f"{label}: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
