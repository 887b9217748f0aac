"""Bitstream -> training/eval window lists for both stages.

The port's copy of `sos_tpu/data/windows.py`.

Reproduces the two window recipes:

* detector (frame-indexed, 50% overlap): m1 tools.py:297-356 —
  truncate '2' padding, slide a `clip_frames` window with stride
  `clip_frames//2`; pred phase emits one full-span window per file.
* denoiser (second-indexed): m2 tools.py:134-205 — windows of
  `data_len_sec` stepped by `len - overlap` inside the truncated span
  (bit slice indexed with the reference's absolute-seconds formula,
  including its start-offset quirk); pred phase emits the full span.

Subsampling uses numpy's legacy seeded `choice` exactly like
`create_sample_list_from_indices` so sample sets match run-for-run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from sos_tpu_torch.data.index import FileRecord
from sos_tpu_torch.dsp.mixing import truncate_padding


@dataclasses.dataclass(frozen=True)
class DetectorWindow:
    file_index: int
    start_frame: int          # index into the file's full bitstream
    bits: Sequence[int]       # len == clip_frames (or full stream in pred)
    audio_path: str
    framerate: float


@dataclasses.dataclass(frozen=True)
class DenoiserWindow:
    file_index: int
    start_sec: float
    end_sec: float
    bits: str                 # bitstream chars covering the window
    audio_path: str
    framerate: float


def detector_windows(
    files: Sequence[FileRecord],
    clip_frames: int,
    pred: bool = False,
) -> List[DetectorWindow]:
    out: List[DetectorWindow] = []
    for i, f in enumerate(files):
        start, end = truncate_padding(f.bit_stream)
        bits = f.bit_stream[start:end]
        if pred:
            out.append(DetectorWindow(i, start, [int(b) for b in bits],
                                      f.audio_path, f.framerate))
            continue
        # stride = clip_frames//2 (50% overlap), windows fully inside span
        last_start = end + 1 - clip_frames
        for x in range(start, max(start, last_start), clip_frames // 2):
            # window indices are relative to the truncated stream
            rel = x - start
            seg = bits[rel:rel + clip_frames]
            if len(seg) < clip_frames:
                break
            out.append(DetectorWindow(i, x, [int(b) for b in seg],
                                      f.audio_path, f.framerate))
    return out


def denoiser_windows(
    files: Sequence[FileRecord],
    data_len_sec: float,
    data_overlap_sec: float,
    pred: bool = False,
) -> List[DenoiserWindow]:
    assert data_len_sec != data_overlap_sec
    out: List[DenoiserWindow] = []
    for i, f in enumerate(files):
        start, end = truncate_padding(f.bit_stream)
        bits = f.bit_stream[start:end]
        fps = f.framerate
        start_sec = start / fps
        end_sec = end / fps
        if pred:
            out.append(DenoiserWindow(i, start_sec, end_sec, bits,
                                      f.audio_path, fps))
            continue
        duration = min(f.duration, f.audio_samples / float(f.audio_sample_rate),
                       end_sec) - start_sec
        if duration < data_len_sec:
            continue
        step = data_len_sec - data_overlap_sec
        n = math.floor((duration - data_len_sec) / step) + 1
        for j in range(n):
            x = start_sec + j * step
            # NOTE: reference indexes the *truncated* stream with the
            # absolute-seconds index (m2 tools.py:176); kept verbatim.
            seg = bits[int(x * fps):int((x + data_len_sec) * fps)]
            out.append(DenoiserWindow(i, x, x + data_len_sec, seg,
                                      f.audio_path, fps))
    return out


def subsample_windows(windows: List, num: Optional[int] = None,
                      fraction: Optional[float] = None,
                      seed: Optional[int] = None) -> List:
    """Seeded random subsample, order-preserving (sorted indices)."""
    if num is None and fraction is None:
        return list(windows)
    if fraction is not None:
        fraction = min(max(fraction, 0.0), 1.0)
        num = int(len(windows) * fraction)
    num = min(num, len(windows))
    rs = np.random.RandomState(seed)
    idx = sorted(rs.choice(len(windows), num, replace=False))
    return [windows[i] for i in idx]
