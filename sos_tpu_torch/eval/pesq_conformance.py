"""PESQ conformance corpus: quantify native-vs-conformant deltas (the
port's framework-free copy of `sos_tpu/eval/pesq_conformance.py`).

The native P.862 implementation (`eval/pesq.py`, `sos_tpu`'s copied)
reconstructs its Bark-band tables rather than copying the ITU originals,
so its absolute scores are NOT certified conformant (the reference
metrics.py:341-343 uses pypesq). This module makes the error
quantifiable the moment a conformant backend is importable:

* `build_corpus()` — a DETERMINISTIC synthetic corpus: one speech-like
  clean signal degraded by additive noise at 7 SNRs, hard clipping at 3
  severities, and low-pass bandwidth loss at 3 cutoffs (13 pairs) —
  the degradation families the composite Csig/Cbak/Covl metrics see.
* `score_corpus(backend)` — scores every pair with the requested
  backend ("native", "pypesq" or "pesq").
* `main()` (`python -m sos_tpu_torch.eval.pesq_conformance`) — prints
  the native scores; when a conformant backend is importable, prints
  per-pair deltas and the max |delta|.

The manifest `tests/fixtures/pesq_native_scores.json` pins the native
scores on this corpus for both packages.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

from sos_tpu_torch.eval.speech import pesq_backend

FS = 16000


def _speechlike(seconds: float = 3.0, fs: int = FS) -> np.ndarray:
    """Harmonic complex with syllabic (3 Hz) AM — silence gaps included.

    Same generator as `sos_tpu`'s tests/test_pesq.py, so the corpus
    matches the behavioral tests' operating range.
    """
    t = np.arange(int(fs * seconds)) / fs
    f0 = 170.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    sig = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * 3.0 * t), 0.0, None)
    return (sig * env * 0.25).astype(np.float64)


def build_corpus(fs: int = FS) -> "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]":
    """name -> (clean, degraded), all deterministic (seeded)."""
    rng = np.random.default_rng(20260819)
    clean = _speechlike(fs=fs)
    power = float(np.mean(clean ** 2))
    corpus: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
    noise = rng.standard_normal(len(clean))
    noise /= np.sqrt(np.mean(noise ** 2))
    for snr in (-10, -5, 0, 5, 10, 15, 20):
        deg = clean + noise * np.sqrt(power / (10 ** (snr / 10.0)))
        corpus[f"awgn_snr{snr:+d}"] = (clean, deg)
    peak = np.max(np.abs(clean))
    for frac in (0.5, 0.25, 0.1):
        corpus[f"clip_{frac}"] = (clean, np.clip(clean, -peak * frac,
                                                 peak * frac))
    from scipy.signal import butter, lfilter

    for cutoff in (3400, 2000, 1000):
        b, a = butter(6, cutoff / (fs / 2))
        corpus[f"lowpass_{cutoff}"] = (clean, lfilter(b, a, clean))
    return corpus


def score_corpus(backend: str = "native", fs: int = FS) -> Dict[str, float]:
    scores = {}
    for name, (clean, deg) in build_corpus(fs).items():
        if backend == "native":
            from sos_tpu_torch.eval.pesq import pesq_nb

            scores[name] = float(pesq_nb(clean, deg, fs))
        elif backend == "pypesq":
            from pypesq import pesq as _p  # type: ignore

            scores[name] = float(_p(clean, deg, fs))
        elif backend == "pesq":
            from pesq import pesq as _p  # type: ignore

            scores[name] = float(_p(fs, clean, deg, "nb"))
        else:
            raise ValueError(backend)
    return scores


def conformant_backend() -> str | None:
    """The first importable conformant P.862 backend, or None.

    Delegates to speech.pesq_backend() so there is exactly ONE probe
    (and one backend-preference order) in the codebase."""
    backend = pesq_backend()
    return None if backend == "native" else backend


def main() -> None:
    native = score_corpus("native")
    print(f"{'pair':<16} {'native':>8}", end="")
    backend = conformant_backend()
    ref = score_corpus(backend) if backend else None
    if ref:
        print(f" {backend:>8} {'delta':>8}")
    else:
        print("   (no conformant pesq/pypesq importable — install one "
              "and re-run to quantify the delta)")
    for name, v in native.items():
        line = f"{name:<16} {v:8.3f}"
        if ref:
            line += f" {ref[name]:8.3f} {v - ref[name]:+8.3f}"
        print(line)
    if ref:
        mx = max(abs(native[k] - ref[k]) for k in native)
        print(f"\nmax |native - {backend}| = {mx:.3f}")


if __name__ == "__main__":
    main()
