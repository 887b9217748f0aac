#!/usr/bin/env python3
"""Time K7's masked instance (`csrc/int8_inpaint.cu`, per-row valid widths)
on one card, as it is and with parts of it changed or taken out.

    python3 scripts/k7_masked_sweep.py [VARIANT ...]

Each variant is a copy of `csrc/int8_inpaint.cu` under
`build/k7_masked_sweep/` with the edits `VARIANTS` lists (the kernel as it
is: "as_is"), built with nvcc as `kernels/build.py` does (all at once),
and run through `ops/int8_conv.py` `inpaint_conv_int8` (its entry point
swapped in). At the four InpaintNet blocks of `chip_smoke.py` phase 3's
K7 valid-width case, 8 rows of a 1,024-frame bucket, each variant is
timed with CUDA events (`chip_smoke.time_ms`) at three sets of per-row
widths (`WIDTHS`: fixed widths of a full bucket, widths spread over 2 ..
W as phase 3 draws them, every row full) and without widths (the
segments instance, the same code in every variant unless an edit says
otherwise), and, unless it takes a part out, checked against the plain
version bit for bit. Variants whose names start with "no_" compute
nothing right: their difference from "as_is" is what the part costs.
Prints the card's name and power limit first and each variant's
registers. Compare variants only within one run: two runs may land on
two cards.
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

SOURCE = "int8_inpaint.cu"
ENTRY = "sos_int8_inpaint_halo"
# variant -> (text, replacement) edits of the copy
VARIANTS = {
    "as_is": (),
    # a warpgroup of a one-row item that starts past the row's output
    # width multiplies nothing (its stages' fences with no wgmma)
    "wg_skip": (
        ("    const int vo = kMode == kMasked ? out_width(p, it.b) : p.wout;\n",
         "    const int vo = kMode == kMasked ? out_width(p, it.b) : p.wout;\n"
         "    const bool live = kMode != kMasked || p.rows > 1 ||\n"
         "        (it.seg * p.seg_len + 64 * wg) * p.os + f.pw < vo;\n"),
        ("        for (int s = 0; s < f.steps; ++s) {",
         "        for (int s = 0; s < (live ? f.steps : 0); ++s) {")),
    # the zero flag as a branch around the arithmetic
    "zero_branch": (
        ("  char2 q;  // then a select, not a branch: ptxas made the branch "
         "slow\n"
         "  q.x = sos8::requant(y0 >= 0.f ? y0 : __fmul_rn(alpha, y0));\n"
         "  q.y = sos8::requant(y1 >= 0.f ? y1 : __fmul_rn(alpha, y1));\n"
         "  if (zero) q = make_char2(0, 0);",
         "  char2 q = make_char2(0, 0);\n  if (!zero) {\n"
         "    q.x = sos8::requant(y0 >= 0.f ? y0 : __fmul_rn(alpha, y0));\n"
         "    q.y = sos8::requant(y1 >= 0.f ? y1 : __fmul_rn(alpha, y1));\n"
         "  }"),),
    # every item walked, as before the live walk (dead ones zeroed twice)
    "walk_all": (
        ("    if constexpr (kMode == kMasked) {\n      const int per",
         "    if constexpr (false) {\n      const int per"),),
    # the copy pass writes every column
    "copy_all": (
        ("      if (col % wh >= (live > 0 ? (live - 1) * p.seg_len + p.pitch "
         ": 0))",
         "      if (live < 0)"),),
    "no_zero_flag": (
        ("zero[h] = kMode == kMasked && ow * p.os + f.pw >= vo;",
         "zero[h] = false;"),),
    "no_prezero": (
        ("      if (p.os == 1) {  // the columns lie side by side",
         "      if (from < 0) {"),
        ("      } else {\n        for (int k = tid; k < (p.wo - from) * c16;",
         "      } else if (from < 0) {\n"
         "        for (int k = tid; k < (p.wo - from) * c16;")),
    "no_vt_patch": (
        ("p.patch = !gather && (p.lead > 0 || (vt_in != nullptr && "
         "p.rpatch > 0));",
         "p.patch = !gather && p.lead > 0;"),),
}
# (label, kind, k, stride, dilation, Cin, Cout, H, W): phase 3's K7 case
CASES = (
    ("a_in", "down", 5, 1, 1, 2, 64, 256, 1024),
    ("a_d1", "down", 5, 2, 1, 64, 128, 256, 1024),
    ("mid_dil16", "down", 3, 1, 16, 256, 256, 64, 256),
    ("mid_up", "up", 3, 2, 1, 256, 128, 64, 256),
)
BATCH = 8
FULL_BUCKET = (1024, 918, 877, 640, 571, 764, 530, 613)  # scaled to W
ROOT = Path(kbuild.BUILD_DIR).parent / "k7_masked_sweep"


def widths(name: str, w: int, gen: torch.Generator, dev) -> torch.Tensor:
    if name == "bucket":
        return torch.tensor([-(-v * w // 1024) for v in FULL_BUCKET],
                            device=dev)
    if name == "spread":
        return chip_smoke.valid_widths(BATCH, w, gen, dev)
    return torch.full((BATCH,), w, device=dev)


WIDTHS = ("bucket", "spread", "full")


class Swapped:
    """The kernel library with the variant's K7 entry point."""

    def __init__(self, main, variant):
        self._main, self._variant = main, variant

    def __getattr__(self, name):
        return getattr(self._variant if name == ENTRY else self._main, name)


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
        regs = [ln.split("registers")[0].split()[-1] for ln in
                out.decode().splitlines() if "Used" in ln]
        print(f"{name}: registers " + " ".join(regs), flush=True)
        lib = ctypes.CDLL(str(ROOT / name / "lib.so"))
        getattr(lib, ENTRY).argtypes = list(kbuild.SIGNATURES[ENTRY])
        getattr(lib, ENTRY).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    main_lib = kbuild.library()
    libs = build_variants(names)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.tensor([0.25], device=dev)
    try:
        for label, kind, k, s, d, cin, cout, h, w in CASES:
            taps = k * k * cin
            wq = torch.randint(-127, 128, (cout, -(-taps // 64) * 64),
                               generator=gen, device=dev, dtype=torch.int8)
            wq[:, taps:] = 0
            ws = (torch.rand(cout, generator=gen, device=dev) + 0.5) * 0.01 \
                / taps ** 0.5
            b = torch.randn(cout, generator=gen, device=dev) * 20
            x = torch.randint(-127, 128, (BATCH, h, w, cin), generator=gen,
                              device=dev, dtype=torch.int8)
            plan = int8_conv.inpaint_plan(kind, k, s, d, h, w, cin, cout)
            sets = {n: widths(n, w, gen, dev) for n in WIDTHS}
            shares = {n: plan.live_share(int8_conv.inpaint_valid_out(
                kind, k, s, d, vt).tolist()) for n, vt in sets.items()}
            refs = {n: int8_conv.inpaint_conv_int8_plain(
                x, wq, ws, b, alpha, kind, k, s, d, vt)
                for n, vt in sets.items()}
            refs[None] = int8_conv.inpaint_conv_int8_plain(
                x, wq, ws, b, alpha, kind, k, s, d)
            print(f"{label}: live items " + ", ".join(
                f"{n} {v:.4f}" for n, v in shares.items()), flush=True)
            for name, lib in libs.items():
                kbuild._lib = Swapped(main_lib, lib)
                row = []
                for n in (*WIDTHS, None):
                    vt = None if n is None else sets[n]

                    def call(vt=vt):
                        return int8_conv.inpaint_conv_int8(
                            x, wq, ws, b, alpha, kind, k, s, d, valid_t=vt)

                    exact = bool(torch.equal(call(), refs[n]))
                    if not name.startswith("no_") and not exact:
                        raise RuntimeError(f"{name} {label} {n}: differs "
                                           "from plain")
                    row.append(f"{n or 'segments'} "
                               f"{chip_smoke.time_ms(call):.4f}"
                               + ("" if exact else " (not exact)"))
                print(f"  {name}: " + ", ".join(row), flush=True)
    finally:
        kbuild._lib = main_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
