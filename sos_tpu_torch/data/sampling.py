"""Noise corpus management and deterministic pred-phase noise/SNR assignment.

The port's copy of `sos_tpu/data/sampling.py`.

Mirrors the reference's noise handling (m1 dataset.py:108-147):

* a `NoiseBank` holds every noise track resampled to the processing rate
  (DEMAND + AudioSet roots; m1 dataset.py:45-49);
* training draws a random track + random crop + random SNR per item;
* prediction assigns each *file* a fixed (noise, snr) pair up front using
  a dedicated seed (PRED_RANDOM_SEED=100), concatenating random tracks
  until the file's duration is covered (m1 tools.py:954-972), so a whole
  evaluation is reproducible and the assignment can be saved alongside
  results (m1 predict.py:79-104).
"""

from __future__ import annotations

import math
import os
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sos_tpu_torch.data.index import FileRecord
from sos_tpu_torch.dsp import audio_io


def find_noise_files(roots: Sequence[str]) -> List[str]:
    if isinstance(roots, (str, os.PathLike)):  # a bare path, not a list —
        roots = [roots]  # iterating the string would rglob "/" etc.
    out: List[str] = []
    for root in roots:
        if root and os.path.isdir(root):
            out.extend(str(p.resolve()) for p in Path(root).rglob("*.wav"))
    return out


class NoiseBank:
    def __init__(self, paths: Sequence[str], sample_rate: int,
                 num_threads: int = 8):
        """Preloads every noise track, decoding in a thread pool — the
        reference preloads with joblib multiprocessing (m1 dataset.py:125).
        Order (and therefore every seeded draw) matches the serial load."""
        self.sample_rate = sample_rate
        self.paths = list(paths)
        if num_threads > 1 and len(self.paths) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                self.tracks: List[np.ndarray] = list(
                    pool.map(lambda p: audio_io.load(p, sr=sample_rate)[0],
                             self.paths))
        else:
            self.tracks = [audio_io.load(p, sr=sample_rate)[0]
                           for p in self.paths]

    @staticmethod
    def from_roots(roots: Sequence[str], sample_rate: int) -> "NoiseBank":
        paths = find_noise_files(roots)
        if not paths:
            # fail HERE with the roots in hand, not later with a cryptic
            # "high <= 0" from random_track inside the batch loop
            raise ValueError(
                f"no noise WAVs found under noise root(s) {list(roots)} — "
                "check --noise_root (files are discovered recursively by "
                "extension)")
        return NoiseBank(paths, sample_rate)

    @staticmethod
    def from_arrays(tracks: Sequence[np.ndarray], sample_rate: int) -> "NoiseBank":
        bank = NoiseBank.__new__(NoiseBank)
        bank.sample_rate = sample_rate
        bank.paths = [f"<array:{i}>" for i in range(len(tracks))]
        bank.tracks = [np.asarray(t, dtype=np.float32) for t in tracks]
        return bank

    def __len__(self) -> int:
        return len(self.tracks)

    def random_track(self, rng: np.random.Generator) -> np.ndarray:
        return self.tracks[int(rng.integers(0, len(self.tracks)))]

    def concat_for_duration(self, num_samples: int, rng: random.Random) -> np.ndarray:
        """Concatenate random tracks until `num_samples` are covered
        (m1 tools.py:954-972 semantics: keep appending while remaining > -1)."""
        chunks = [rng.choice(self.tracks)]
        remaining = num_samples - len(chunks[-1])
        while remaining > -1:
            chunks.append(rng.choice(self.tracks))
            remaining -= len(chunks[-1])
        return np.concatenate(chunks)

    def assign_for_prediction(
        self,
        files: Sequence[FileRecord],
        snrs: Sequence[float],
        snr_idx: Optional[int] = None,
        seed: int = 100,
    ) -> Dict[int, Tuple[np.ndarray, float]]:
        """Deterministic per-file (noise, snr): m1 dataset.py:129-147."""
        rng = random.Random(seed)
        sr = self.sample_rate
        out: Dict[int, Tuple[np.ndarray, float]] = {}
        for f_idx, f in enumerate(files):
            need = int(math.ceil(f.duration)) * sr
            noise = self.concat_for_duration(f.audio_samples or need, rng)
            start = rng.randint(0, max(0, len(noise) - need))
            cropped = noise[start:start + need]
            snr = rng.choice(list(snrs)) if snr_idx is None else snrs[snr_idx]
            out[f_idx] = (cropped, float(snr))
        return out
