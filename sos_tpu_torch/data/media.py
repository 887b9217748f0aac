"""ffmpeg/ffprobe helpers for non-WAV media (port of `sos_tpu/data/media.py`,
copied as it is; gated on tool availability).

The reference preprocesses arbitrary video/audio via ffmpeg subprocesses
(preprocessing/util.py:189-300). WAV files never need these (native
decode in sos_tpu_torch.dsp.audio_io); they exist for parity when users
feed mp4/mp3 sources. Every function raises RuntimeError with a clear message
when ffmpeg/ffprobe are not installed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Tuple


def _tool(name: str) -> str:
    path = shutil.which(name)
    if not path:
        raise RuntimeError(
            f"{name} not found; install ffmpeg or preprocess to WAV first")
    return path


def ffprobe_json(path: str) -> dict:
    out = subprocess.run(
        [_tool("ffprobe"), "-v", "quiet", "-print_format", "json",
         "-show_format", "-show_streams", path],
        capture_output=True, check=True)
    return json.loads(out.stdout)


def get_duration(path: str) -> float:
    """Media duration in seconds (preprocessing/util.py `get_duration2_audio`)."""
    info = ffprobe_json(path)
    return float(info["format"]["duration"])


def get_framerate(path: str) -> float:
    info = ffprobe_json(path)
    for stream in info["streams"]:
        if stream.get("codec_type") == "video":
            num, den = stream["r_frame_rate"].split("/")
            return float(num) / float(den)
    raise RuntimeError(f"no video stream in {path}")


def get_audio_info(path: str) -> Tuple[int, int]:
    """(sample_rate, num_samples) of the first audio stream."""
    info = ffprobe_json(path)
    for stream in info["streams"]:
        if stream.get("codec_type") == "audio":
            sr = int(stream["sample_rate"])
            dur = float(stream.get("duration") or info["format"]["duration"])
            return sr, int(dur * sr)
    raise RuntimeError(f"no audio stream in {path}")


def extract_audio(path: str, out_wav: str, sample_rate: int = 44100,
                  channels: int = 2) -> str:
    """Transcode any media's audio track to WAV
    (preprocessing/util.py `change_audiosamplerate`)."""
    subprocess.run(
        [_tool("ffmpeg"), "-y", "-v", "quiet", "-i", path,
         "-ar", str(sample_rate), "-ac", str(channels), out_wav],
        check=True)
    return out_wav


def media_tools_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None
