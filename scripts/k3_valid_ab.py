#!/usr/bin/env python3
"""K3's valid-width instances in two checkouts of `sos_tpu_torch`, in
turns on one card (A, B, B, A): their outputs bit for bit, and their
times.

    python3 scripts/k3_valid_ab.py OTHER_CHECKOUT [LABEL_A LABEL_B]

OTHER_CHECKOUT is a directory holding another version of the package
(`git archive <commit> sos_tpu_torch | tar -x -C DIR`); the checkout this
script lies in is B. Each turn is a process of its own, which imports
the package from its checkout and builds its kernels. A turn runs, on
seeded inputs (the same in every turn), the cases of `chip_smoke.py`
phase 3 that K3's instances with per-row `valid_t` serve: 16 rows of a
1,024-frame bucket, valid_t drawn over 2-1,024 with the first row full,
at the default geometry (the prime-factor instance, `csrc/crm_istft.cu`),
at (1022, 256, 1022) (the "fft" instance) and at (254, 64, 254) (the
generic instance); the same three with rows of 0, 1, 2 and 1,024 frames;
and the instances without valid_t at phase 3's shapes (128 clips of 2 s:
the default geometry, the "fft" instance at its three geometries, the
generic one), which the valid_t change must leave as they were. Each is
timed with CUDA events (20 calls after 50 ms of warm-up calls) and its
output saved. The script prints the card's name and power limit, each
turn's times, then whether A's and B's outputs are equal bit for bit (and
each version's two turns), and exits 1 if any differ. Compare two
versions only within one run: two runs may land on two cards.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

BUCKET = 1024
ROWS = 16
CLIP = 28000
BATCH = 128
# (label, n_fft, hop, win)
GEOMETRIES = (("pfa", 510, 158, 400), ("fft", 1022, 256, 1022),
              ("generic", 254, 64, 254))
# the "fft" instance's geometries of phase 3's row (summed there)
FFT_FULL = ((1022, 256, 1022), (511, 158, 400), (512, 128, 512))
OUT_DIR = os.path.join("build", "k3_valid_ab")


def event_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cases():
    """(name, n_fft, hop, win, rows, frames, valid_t or None) of every
    case, valid_t a list."""
    import torch
    gen = torch.Generator().manual_seed(21)
    out = []
    for label, nf, hop, win in GEOMETRIES:
        vt = torch.randint(2, BUCKET + 1, (ROWS,), generator=gen)
        vt[0] = BUCKET
        out.append((f"{label} valid_t 2-{BUCKET}", nf, hop, win, ROWS, BUCKET,
                    vt.tolist()))
        out.append((f"{label} valid_t 0/1/2/{BUCKET}", nf, hop, win, 4,
                    BUCKET, [0, 1, 2, BUCKET]))
    for label, nf, hop, win in ((("pfa", 510, 158, 400),)
                                + tuple(("fft",) + g for g in FFT_FULL)
                                + (("generic", 254, 64, 254),)):
        frames = 1 + (CLIP + 2 * (nf // 2) - nf) // hop
        out.append((f"{label} ({nf}, {hop}, {win}) no valid_t", nf, hop, win,
                    BATCH, frames, None))
    return out


def turn(label: str, index: int) -> None:
    import torch

    from sos_tpu_torch.dsp.stft import crm_istft
    from sos_tpu_torch.kernels import library
    library()
    dev = torch.device("cuda")
    saved, lines = {}, []
    for n, (name, nf, hop, win, rows, frames, vt) in enumerate(cases()):
        gen = torch.Generator().manual_seed(100 + n)
        shape = (rows, frames, 2 * (nf // 2 + 1))
        spec = (torch.randn(shape, generator=gen) * 0.3).to(dev)
        crm = (torch.rand(shape, generator=gen) * 0.98 + 0.01).to(dev)
        valid_t = None if vt is None else torch.tensor(vt).to(dev)

        def call():
            return crm_istft(crm, spec, nf, hop, win, valid_t=valid_t)
        saved[name] = call().cpu()
        ms = event_ms(call)
        live = "" if vt is None else f", {sum(vt)} valid frames"
        lines.append(f"  {name}: {ms:.4f} ms ({rows} x {frames} frames{live})")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.save(saved, os.path.join(OUT_DIR, f"{index}.pt"))
    print(f"turn {index} {label} ({os.getcwd()}):", flush=True)
    print("\n".join(lines), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        turn(sys.argv[2], int(sys.argv[3]))
        return 0
    if len(sys.argv) not in (2, 4):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    names = sys.argv[2:] or ["A", "B"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    turns = ((other, names[0]), (here, names[1]), (here, names[1]),
             (other, names[0]))
    for index, (root, name) in enumerate(turns):
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                        "--turn", name, str(index)], cwd=root, env=env,
                       check=True)
    outs = [torch.load(os.path.join(root, OUT_DIR, f"{i}.pt"))
            for i, (root, _) in enumerate(turns)]
    ok = True
    for what, (i, j) in ((f"{names[0]} against {names[1]}", (0, 1)),
                         (f"{names[0]} against itself", (0, 3)),
                         (f"{names[1]} against itself", (1, 2))):
        for case in outs[i]:
            a, b = outs[i][case], outs[j][case]
            same = a.shape == b.shape and torch.equal(
                a.view(torch.int32), b.view(torch.int32))
            ok = ok and same
            diff = (float((a - b).abs().max()) if a.shape == b.shape
                    else float("nan"))
            print(f"{what}, {case}: bit-equal {same} (max |diff| {diff:.3e})",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
