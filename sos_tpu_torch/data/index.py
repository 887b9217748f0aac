"""Dataset-JSON index: the on-disk handshake format shared with the reference.

The port's copy of `sos_tpu/data/index.py`.

Schema (see the reference's data/sounds_of_silence.json and the FIELDS list
in preprocessing/tools.py:28-31):

    {"dataset_path": str, "num_videos": int,
     "files": [{"path", "clip_start_time", "clip_end_time", "face_x",
                "face_y", "framerate", "audio_sample_rate", "audio_samples",
                "duration", "num_frames", "bit_stream",
                "silence_total_ratio", "avg_silenceInterval_silcenceTotal_ratio",
                "frames_path", "flows_path", "audio_path"}]}

`bit_stream` is a string over {'0','1','2'}: one char per video frame,
0=silent, 1=voiced, 2=padding at clip edges.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, List, Optional

FIELDS = (
    "path", "clip_start_time", "clip_end_time", "face_x", "face_y",
    "framerate", "audio_sample_rate", "audio_samples", "duration",
    "num_frames", "bit_stream", "silence_total_ratio",
    "avg_silenceInterval_silcenceTotal_ratio", "frames_path", "flows_path",
    "audio_path",
)


@dataclasses.dataclass
class FileRecord:
    path: str
    audio_path: str
    framerate: float = 30.0
    audio_sample_rate: int = 44100
    audio_samples: int = 0
    duration: float = 0.0
    num_frames: int = 0
    bit_stream: str = ""
    clip_start_time: float = 0.0
    clip_end_time: float = 0.0
    face_x: float = 0.0
    face_y: float = 0.0
    silence_total_ratio: float = 0.0
    avg_silence_ratio: float = 0.0
    frames_path: Optional[str] = None
    flows_path: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "FileRecord":
        known = {
            "path": obj.get("path", ""),
            "audio_path": obj.get("audio_path", obj.get("path", "")),
            "framerate": float(obj.get("framerate", 30.0)),
            "audio_sample_rate": int(obj.get("audio_sample_rate", 44100)),
            "audio_samples": int(obj.get("audio_samples", 0)),
            "duration": float(obj.get("duration", 0.0)),
            "num_frames": int(obj.get("num_frames", 0)),
            "bit_stream": obj.get("bit_stream", ""),
            "clip_start_time": float(obj.get("clip_start_time", 0.0)),
            "clip_end_time": float(obj.get("clip_end_time", 0.0)),
            "face_x": float(obj.get("face_x", 0.0) or 0.0),
            "face_y": float(obj.get("face_y", 0.0) or 0.0),
            "silence_total_ratio": float(obj.get("silence_total_ratio", 0.0)),
            "avg_silence_ratio": float(
                obj.get("avg_silenceInterval_silcenceTotal_ratio", 0.0)),
            "frames_path": obj.get("frames_path"),
            "flows_path": obj.get("flows_path"),
        }
        extra = {k: v for k, v in obj.items()
                 if k not in FIELDS and k != "avg_silenceInterval_silcenceTotal_ratio"}
        return FileRecord(extra=extra, **known)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "path": self.path,
            "clip_start_time": self.clip_start_time,
            "clip_end_time": self.clip_end_time,
            "face_x": self.face_x,
            "face_y": self.face_y,
            "framerate": self.framerate,
            "audio_sample_rate": self.audio_sample_rate,
            "audio_samples": self.audio_samples,
            "duration": self.duration,
            "num_frames": self.num_frames,
            "bit_stream": self.bit_stream,
            "silence_total_ratio": self.silence_total_ratio,
            "avg_silenceInterval_silcenceTotal_ratio": self.avg_silence_ratio,
            "frames_path": self.frames_path,
            "flows_path": self.flows_path,
            "audio_path": self.audio_path,
        }
        out.update(self.extra)
        return out


@dataclasses.dataclass
class DatasetIndex:
    dataset_path: str
    files: List[FileRecord]

    @property
    def num_files(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[FileRecord]:
        return iter(self.files)

    def __getitem__(self, i: int) -> FileRecord:
        return self.files[i]

    @staticmethod
    def load(path: str) -> "DatasetIndex":
        with open(path, "r") as fp:
            raw = json.load(fp)
        if not isinstance(raw, dict) or "files" not in raw:
            raise ValueError(
                f"{path} is not a dataset JSON (missing the 'files' list; "
                "expected the schema written by sos_tpu.cli.preprocess / "
                "data/sounds_of_silence.json)")
        return DatasetIndex(
            dataset_path=raw.get("dataset_path", os.path.dirname(path)),
            files=[FileRecord.from_json(f) for f in raw["files"]],
        )

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(
                {
                    "dataset_path": self.dataset_path,
                    "num_videos": len(self.files),
                    "files": [f.to_json() for f in self.files],
                },
                fp, indent=4,
            )


def combine_datasets(paths, dataset_path: str = "") -> "DatasetIndex":
    """Merge several dataset JSONs into one (preprocessing/tools.py:170-205
    `combine_alljson`)."""
    files: List[FileRecord] = []
    common = dataset_path
    for p in paths:
        idx = DatasetIndex.load(p)
        files.extend(idx.files)
        if not dataset_path:
            common = os.path.commonprefix([common, idx.dataset_path]) \
                if common else idx.dataset_path
    return DatasetIndex(dataset_path=common, files=files)
