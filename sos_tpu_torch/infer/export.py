"""Serving artifacts: the fused denoise program as one file (port of
`sos_tpu/infer/export.py`).

`sos_tpu` exports StableHLO with the weights embedded and re-compiles it
with `jax.jit(exported.call)`. The port's artifact is one `torch.save`
file read back with `torch.load(weights_only=True)`, so loading it runs
no code: the `ExperimentConfig` as JSON, both models' state_dicts, the
int8 calibration scales (required for int8 and loaded strictly), and
the metadata, which also goes to `<path>.json` with `sos_tpu`'s keys
(`batch`, `clip_samples`, `sample_rate`, `profile`, `threshold`,
`platforms`, `wire_dtype`).

    path = export_denoise_program(cfg, det_state, den_state,
                                  "denoise_b128.pt", batch=128,
                                  profile="int8",
                                  calibration_path="int8_calibration.json")
    serve = load_denoise_program(path)            # on the card
    denoised, bits = serve(mixed)   # (B, clip_samples) float32 or int16

`load_denoise_program` rebuilds the fixed-shape `FusedDenoisePipeline`.
On the card it runs warm-up calls on a side stream, then captures one
whole call into a CUDA graph over static input and output buffers:
compiled once for its shape, one replay a call (the counterpart of
`jax.jit(exported.call)`). A failed capture raises; nothing falls back
to eager calls. Kernel launches (`kernels.LAUNCHES`) are counted when
they are captured, not when they are replayed: `capture_launches` keeps
them. On the CPU the loader runs the pipeline eagerly.

Unlike `sos_tpu`'s artifact, the port's needs the `sos_tpu_torch`
package installed: its kernels are built from the package's sources.
Artifacts are per (batch, clip_seconds): export one per serving bucket.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.infer.fused import FusedDenoisePipeline
from sos_tpu_torch.models.layers import resolve_device
from sos_tpu_torch.models.quant import parse_calibration_file

FORMAT = "sos_tpu_torch.denoise_program"
VERSION = 1
PLATFORMS = ("cuda", "cpu")
WARMUP_CALLS = 3


def check_platforms(platforms: Sequence[str]) -> list:
    """`platforms` as a list of "cuda" and "cpu"; anything else raises
    (a TPU artifact is `sos_tpu`'s, the JAX package's)."""
    platforms = list(platforms)
    if "tpu" in platforms:
        raise ValueError("platform 'tpu': the port's artifacts run on "
                         "'cuda' and 'cpu'; a TPU artifact is exported "
                         "by the JAX package (python -m sos_tpu "
                         "export_serving)")
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms {platforms}: each one of {PLATFORMS}")
    return platforms


def export_denoise_program(
    cfg: ExperimentConfig,
    detector_state: Mapping,
    denoiser_state: Mapping,
    path: str,
    batch: int,
    clip_seconds: float = 2.0,
    threshold: float = 0.5,
    profile: str = "f32",
    calibration_path: Optional[str] = None,
    platforms: Sequence[str] = PLATFORMS,
    wire_dtype: str = "float32",
    bf16_head_proj: bool = True,
) -> str:
    """Write the artifact for a fixed (batch, clip) shape; returns `path`.

    For the int8 profile a calibration JSON is REQUIRED and must load
    strictly: exported scales never depend on whatever batch happens to
    flow first. `wire_dtype="int16"`: the artifact takes and returns
    int16 PCM (`fused.wire_encode`/`wire_decode` convert)."""
    platforms = check_platforms(platforms)
    # built on the CPU: checks the profile, the states and the scales
    pipe = FusedDenoisePipeline(cfg, detector_state, denoiser_state,
                                threshold=threshold,
                                clip_seconds=clip_seconds, profile=profile,
                                wire_dtype=wire_dtype,
                                bf16_head_proj=bf16_head_proj, device="cpu")
    calibration = ""
    if profile == "int8":
        if not calibration_path:
            raise ValueError(
                "int8 export requires a calibration JSON (run `calibrate`, "
                "or the serving pipeline once with calibration_path set, "
                "then export with the same path)")
        pipe.load_calibration_file(calibration_path, strict=True)
        calibration = json.dumps(parse_calibration_file(calibration_path)[0])
    meta = {
        "batch": batch,
        "clip_samples": pipe.clip_samples,
        "sample_rate": cfg.data.sample_rate,
        "profile": profile,
        "threshold": threshold,
        "platforms": platforms,
        "wire_dtype": wire_dtype,
    }
    payload = {
        "format": FORMAT,
        "version": VERSION,
        "config": cfg.to_json(),
        "detector": {k: v.detach().cpu() for k, v in detector_state.items()},
        "denoiser": {k: v.detach().cpu() for k, v in denoiser_state.items()},
        "calibration": calibration,
        "meta": meta,
        "options": {"clip_seconds": clip_seconds,
                    "bf16_head_proj": bf16_head_proj},
    }
    torch.save(payload, path)
    with open(path + ".json", "w") as fp:
        json.dump(meta, fp, indent=1)
    return path


class DenoiseProgram:
    """`serve(mixed) -> (denoised, bits)` over one fixed-shape pipeline:
    a CUDA graph replay on the card, an eager call on the CPU. Inputs
    are copied into the static input buffer; outputs are copies."""

    def __init__(self, pipe: FusedDenoisePipeline, meta: Dict):
        self.pipe = pipe
        self.device = pipe.device
        self.in_dtype = (torch.int16 if meta["wire_dtype"] == "int16"
                         else torch.float32)
        self.shape = (meta["batch"], meta["clip_samples"])
        self.capture_launches: Dict[str, int] = {}
        self._graph = None
        if self.device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        from sos_tpu_torch.kernels import LAUNCHES

        self._input = torch.zeros(self.shape, dtype=self.in_dtype,
                                  device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.pipe(self._input)
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._output = self.pipe(self._input)
        self.capture_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                                 if LAUNCHES[k] != before[k]}
        self._graph = graph

    def __call__(self, mixed) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.as_tensor(mixed)
        if tuple(x.shape) != self.shape or x.dtype != self.in_dtype:
            raise ValueError(f"artifact takes {self.in_dtype} "
                             f"{self.shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if self._graph is None:
            return self.pipe(x.to(self.device))
        self._input.copy_(x)
        self._graph.replay()
        return tuple(t.clone() for t in self._output)


def load_denoise_program(path: str, device="cuda") -> DenoiseProgram:
    """Rebuild the exported pipeline on `device` ("cuda", the default, or
    "cpu", each only if the artifact lists it) as a `DenoiseProgram`. The
    file is read with `weights_only=True`: loading it runs no code."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT or payload.get("version") != VERSION:
        raise ValueError(f"{path}: not a {FORMAT} artifact of version "
                         f"{VERSION}")
    meta, options = payload["meta"], payload["options"]
    if torch.device(device).type not in meta["platforms"]:
        raise ValueError(f"{path}: exported for {meta['platforms']}, "
                         f"not {torch.device(device).type}")
    device = resolve_device(device)
    cfg = ExperimentConfig.from_json(payload["config"])
    pipe = FusedDenoisePipeline(
        cfg, payload["detector"], payload["denoiser"],
        threshold=meta["threshold"], clip_seconds=options["clip_seconds"],
        profile=meta["profile"], wire_dtype=meta["wire_dtype"],
        bf16_head_proj=options["bf16_head_proj"], device=device)
    if meta["profile"] == "int8":
        pipe.load_calibration_state(json.loads(payload["calibration"]),
                                    strict=True,
                                    source=f"artifact {path}")
    return DenoiseProgram(pipe, meta)
