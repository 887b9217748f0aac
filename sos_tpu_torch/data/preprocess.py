"""Dataset preprocessing: build the dataset JSON from raw WAVs (the
port's copy of `sos_tpu/data/preprocess.py`; host work, no device).

Equivalent of `preprocessing/preprocessor_audioonly.py:14-160` without the
ffmpeg/ffprobe subprocesses: durations/sample counts come from the native
WAV reader, resampling to the canonical 44.1 kHz uses the polyphase
resampler. Also implements the ground-truth silence labeling algorithm the
reference keeps as a commented block (preprocessing/util.py:600-778):
per-video-frame L2 energy, peak-normalized, thresholded at 0.08, with
optional '2' padding at the clip edges.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np

from sos_tpu_torch.data.index import DatasetIndex, FileRecord
from sos_tpu_torch.dsp import audio_io

CANONICAL_SR = 44100  # preprocessing/tools.py:18 (AUDIO_SAMPLE_RATE)
FRAMERATE = 30.0      # preprocessing/tools.py:17


def label_bitstream(
    waveform: np.ndarray,
    sr: int,
    framerate: float = FRAMERATE,
    threshold: float = 0.08,
    pad_seconds: float = 0.0,
) -> str:
    """Ground-truth silence labels from clean audio energy.

    Per video frame: bit '0' if the frame's L2 energy, normalized by the
    max frame energy, falls below `threshold`, else '1'; the first/last
    `pad_seconds` of frames become '2' padding (preprocessing/util.py
    commented algorithm; the released data used 15 s padding for
    YouTube-clip margins — 0 is the right default for standalone WAVs).
    """
    spf = sr / framerate  # samples per video frame
    num_frames = int(math.floor(len(waveform) / spf))
    if num_frames == 0:
        return ""
    energies = np.empty(num_frames)
    for i in range(num_frames):
        seg = waveform[int(i * spf):int((i + 1) * spf)]
        energies[i] = np.linalg.norm(seg)
    peak = energies.max()
    norm = energies / peak if peak > 0 else energies
    bits = np.where(norm < threshold, "0", "1")
    pad_frames = int(pad_seconds * framerate)
    if pad_frames:
        bits[:pad_frames] = "2"
        bits[len(bits) - pad_frames:] = "2"
    return "".join(bits)


def process_audio_file(
    path: str,
    framerate: float = FRAMERATE,
    canonical_sr: int = CANONICAL_SR,
    label_silence: bool = False,
    label_threshold: float = 0.08,
    label_pad_seconds: float = 0.0,
) -> FileRecord:
    """One WAV -> FileRecord (preprocessor_audioonly.py:58-85 field recipe)."""
    y, native_sr = audio_io.load(path, sr=None, mono=True)
    duration = len(y) / float(native_sr)
    if native_sr != canonical_sr:
        y_canon = audio_io.resample(y, native_sr, canonical_sr)
    else:
        y_canon = y
    num_frames = int(math.ceil(duration * framerate))
    if label_silence:
        bit_stream = label_bitstream(y_canon, canonical_sr, framerate,
                                     label_threshold,
                                     pad_seconds=label_pad_seconds)
        # the trailing partial frame (duration ceil vs the labeler's
        # floor) has no energy label; when an ignore margin is in force
        # it lies inside that margin and must stay '2', not become a
        # spurious sound-positive
        tail = "2" if int(label_pad_seconds * framerate) > 0 else "1"
        bit_stream = bit_stream.ljust(num_frames, tail)[:num_frames]
    else:
        bit_stream = "1" * num_frames
    return FileRecord(
        path=os.path.abspath(path),
        audio_path=os.path.abspath(path),
        framerate=framerate,
        audio_sample_rate=canonical_sr,
        audio_samples=len(y_canon),
        duration=duration,
        num_frames=num_frames,
        bit_stream=bit_stream,
    )


def build_dataset_json(
    audio_dir: str,
    output_json: str,
    file_list: Optional[Sequence[str]] = None,
    label_silence: bool = False,
    label_threshold: float = 0.08,
    label_pad_seconds: float = 0.0,
) -> DatasetIndex:
    """Directory of WAVs -> dataset JSON (preprocessor `build_json_better`)."""
    if file_list is None:
        file_list = sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(audio_dir)
            for f in files if f.lower().endswith(".wav"))
    records: List[FileRecord] = [
        process_audio_file(p, label_silence=label_silence,
                           label_threshold=label_threshold,
                           label_pad_seconds=label_pad_seconds)
        for p in file_list]
    index = DatasetIndex(dataset_path=os.path.abspath(audio_dir),
                         files=records)
    os.makedirs(os.path.dirname(os.path.abspath(output_json)), exist_ok=True)
    index.save(output_json)
    return index
