#!/usr/bin/env python3
"""Time K1's and K3's "fft" instances on one card: across block shapes,
and with parts of the kernels taken out.

    python3 scripts/fft_sweep.py

At (1022, 256, 1022), (511, 158, 400) and (512, 128, 512), 128 seeded
clips of 28,000 samples, CUDA graphs (`chip_smoke.graph_ms`):

* sweep: K1 at 1-16 transforms a block and K3 at 1-32 output hops a
  block, each with the shared bytes `dsp/stft.py` counts for it, through
  the kernels' C entry points (the shape `fft_launch_shape` picks is
  printed beside); each result is checked against the plain version;
* ablation: copies of `csrc/stft_fft.cu` and `csrc/crm_istft_fft.cu`
  under `build/fft_sweep/`, built with nvcc as `kernels/build.py` does,
  with the passes left out ("no_passes"), the split / overlap-add left
  out ("no_out") or K3's cRM recover left out ("no_recover"), at the
  launch shape `fft_launch_shape` picks. The differences from "full"
  are what those parts cost; the left-out versions compute nothing
  right.

Prints the card's name and power limit first. Compare two versions only
within one run: two runs may land on two cards.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from sos_tpu_torch.dsp import stft as st  # noqa: E402
from sos_tpu_torch.kernels import build as kbuild  # noqa: E402
from sos_tpu_torch.kernels import library, on_device  # noqa: E402

GEOMETRIES = ((1022, 256, 1022), (511, 158, 400), (512, 128, 512))
K1_BLOCKS = (1, 2, 3, 4, 6, 8, 10, 12, 16)
K3_HOPS = (1, 2, 4, 7, 10, 13, 16, 24, 32)
SMEM_LIMIT = 227 * 1024
# variant -> (source, text, replacement) edits of the kernels' copies
ABLATIONS = {
    "full": (),
    "no_passes": (
        ("stft_fft.cu", "run_passes<false, kPad>(A, B, nt, S, plan, coefs)", "A"),
        ("crm_istft_fft.cu", "run_passes<true, kPad>(A, B, nt, S, plan, coefs)", "A")),
    "no_out": (
        ("stft_fft.cu", "for_points(bins, [&](int k, int t_begin",
         "for_points(0, [&](int k, int t_begin"),
        ("crm_istft_fft.cu", "for (int i = tid; i < hops * hop; i += blockDim.x)",
         "for (int i = tid; i < 0; i += blockDim.x)")),
    "no_recover": (
        ("crm_istft_fft.cu", "crm_recover(__ldg(crm + r + k))", "__ldg(crm + r + k)"),
        ("crm_istft_fft.cu", "crm_recover(__ldg(crm + r + bins + k))",
         "__ldg(crm + r + bins + k)")),
}


class Case:
    """One geometry's inputs, tables and plain results on the card."""

    def __init__(self, nf, hop, win, y, gen, dev):
        self.nf, self.hop, self.win, self.y = nf, hop, win, y
        self.tab, self.ints = st.device_fft_tables(nf, win, dev)
        self.m = st.fft_points(nf)
        self.ncoef = int(st.fft_tables(nf, win)["plan"][3])
        self.frames = st.stft_num_frames(y.shape[1], nf, hop)
        self.spec = st.stft_cat_plain(y, nf, hop, win)
        self.crm = (torch.rand(self.spec.shape, generator=gen) * 0.98 + 0.01).to(dev)
        self.ref3 = st.crm_istft_plain(self.crm, self.spec, nf, hop, win)
        self.out = torch.empty_like(self.spec)
        self.out_len = (self.frames - 1) * hop + nf % 2
        self.o3 = torch.empty(y.shape[0], self.out_len, device=dev)

    def k1(self, lib, per, smem):
        with on_device(self.y.device) as stream:
            rc = lib.sos_stft_fft(
                self.y.data_ptr(), self.tab.data_ptr(), self.ints.data_ptr(),
                self.out.data_ptr(), self.y.shape[0], self.y.shape[1], self.frames,
                self.nf, self.hop, self.nf // 2, (self.nf - self.win) // 2, self.win,
                per, smem, stream)
        if rc:
            raise RuntimeError(f"sos_stft_fft: CUDA error {rc}")

    def k3(self, lib, hops, per, smem):
        with on_device(self.y.device) as stream:
            rc = lib.sos_crm_istft_fft(
                self.crm.data_ptr(), self.spec.data_ptr(), self.tab.data_ptr(),
                self.ints.data_ptr(), None, self.o3.data_ptr(), self.y.shape[0],
                self.frames, self.nf, self.hop, hops, per, smem, self.out_len, stream)
        if rc:
            raise RuntimeError(f"sos_crm_istft_fft: CUDA error {rc}")

    def errors(self):
        torch.cuda.synchronize()
        return (float((self.out - self.spec).abs().max()),
                float((self.o3 - self.ref3).abs().max()))


def sweep(case: Case, lib) -> None:
    shared = st._fft_shared_bytes
    k1, k3 = [], []
    pair = 1 + case.nf % 2
    for per in K1_BLOCKS:
        smem = shared(case.ncoef, per, case.m)
        if smem > SMEM_LIMIT or per * pair > 2 * st.FFT_MAX_FRAMES:
            continue
        case.k1(lib, per, smem)
        err = case.errors()[0]
        ms = chip_smoke.graph_ms(lambda: case.k1(lib, per, smem))
        k1.append(f"{per} ({smem // 1024} KB) {ms:.4f} ms (err {err:.1e})")
    chunks = -(-case.nf // case.hop)
    for hops in K3_HOPS:
        per = -(-(hops + chunks - 1) // pair)
        smem = shared(case.ncoef, per, case.m)
        if smem > SMEM_LIMIT:
            continue
        case.k3(lib, hops, per, smem)
        err = case.errors()[1]
        ms = chip_smoke.graph_ms(lambda: case.k3(lib, hops, per, smem))
        k3.append(f"{hops} ({smem // 1024} KB) {ms:.4f} ms (err {err:.1e})")
    geo = f"({case.nf}, {case.hop}, {case.win})"
    print(f"{geo} fft_launch_shape {st.fft_launch_shape(case.nf, case.hop)}", flush=True)
    print(f"{geo} K1 by transforms a block: " + "; ".join(k1), flush=True)
    print(f"{geo} K3 by output hops a block: " + "; ".join(k3), flush=True)


def ablation_libraries() -> dict:
    root = kbuild.BUILD_DIR.parent / "fft_sweep"
    procs = {}
    for name, edits in ABLATIONS.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in kbuild.CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        for f in ("stft_fft.cu", "crm_istft_fft.cu"):
            shutil.copy(kbuild.CSRC / f, d)
        for f, text, repl in edits:
            src = (d / f).read_text()
            if text not in src:
                raise RuntimeError(f"{name}: {text!r} is not in {f}")
            (d / f).write_text(src.replace(text, repl))
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "stft_fft.cu"), str(d / "crm_istft_fft.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode()[-3000:]}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for sym in ("sos_stft_fft", "sos_crm_istft_fft"):
            getattr(lib, sym).argtypes = list(kbuild.SIGNATURES[sym])
            getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
    return libs


def ablation(case: Case, libs: dict) -> None:
    per, smem, hops, per3, smem3 = st.fft_launch_shape(case.nf, case.hop)
    parts = []
    for name, lib in libs.items():
        case.k1(lib, per, smem)
        case.k3(lib, hops, per3, smem3)
        case.errors()
        t1 = chip_smoke.graph_ms(lambda: case.k1(lib, per, smem))
        t3 = chip_smoke.graph_ms(lambda: case.k3(lib, hops, per3, smem3))
        parts.append(f"{name} K1 {t1:.4f} K3 {t3:.4f}")
    print(f"({case.nf}, {case.hop}, {case.win}) ablation, ms: " + "; ".join(parts),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("fft_sweep: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.phase_card()
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    y = (torch.randn(chip_smoke.BATCH, chip_smoke.CLIP, generator=gen) * 0.3).to(dev)
    cases = [Case(nf, hop, win, y, gen, dev) for nf, hop, win in GEOMETRIES]
    lib = library()
    for case in cases:
        sweep(case, lib)
    libs = ablation_libraries()
    for case in cases:
        ablation(case, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
