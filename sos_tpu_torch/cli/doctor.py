"""Environment and deployment diagnostics: answers "why doesn't it work here?".

    python -m sos_tpu_torch doctor [--device cuda|cpu]
                                   [--output_root model_output --name exp]
                                   [--dataset_json ds.json] [--json]

(Port of `sos_tpu/cli/doctor.py`: the same lines, `--json` and exit
codes; each check means what it can on this stack.)

Checks (one `[ ok ]/[warn]/[FAIL]` line each):
  accelerator    the CUDA card(s): name and count, a tiny matmul round
                 trip, the kernel library built and loaded, and kernel
                 K2 launched once against its plain version (with
                 `--device cpu`: a warning, the plain path)
  compile-cache  the nvcc build directory resolves and is writable, and
                 whether the library for the current sources is built
  native-engine  C++ audio engine builds/loads and decodes a probe wav
  media-tools    ffmpeg/ffprobe on PATH (video preprocessing only)
  pesq-backend   conformant pypesq/pesq vs the native fallback
  experiment     (with --name) per-stage checkpoints
                 (`<name>_<stage>/model/latest.pt`) and the int8
                 calibration file under --output_root
  dataset        (with --dataset_json) loads and its audio paths resolve

Exit code 0 when nothing FAILs (warnings allowed), 1 otherwise.
warn = a condition with a built-in fallback (native PESQ, gated media
tools, first-request self-calibration, the CPU's plain path); FAIL =
the core pipeline breaks.
"""

import argparse
import json
import os
import sys
import tempfile
import time

from sos_tpu_torch.cli.common import add_device_arg


def _check_accelerator(results, device: str) -> None:
    import torch

    if device == "cpu":
        results.append(("accelerator", "warn",
                        f"--device cpu: the kernels' plain PyTorch versions "
                        f"(torch {torch.__version__}); fine for tests, the "
                        "CUDA card expected in production"))
        return
    if not torch.cuda.is_available():
        results.append(("accelerator", "FAIL",
                        f"no CUDA card visible (torch {torch.__version__}, "
                        f"built for CUDA {torch.version.cuda}); run with "
                        "--device cpu for the plain path"))
        return
    try:
        from sos_tpu_torch.dsp.mixing import mask_gate, mask_gate_plain
        from sos_tpu_torch.kernels import LAUNCHES, library

        count = torch.cuda.device_count()
        name = torch.cuda.get_device_name(0)
        t0 = time.perf_counter()
        x = torch.ones(128, 128, device="cuda")
        val = float((x @ x).sum())
        assert val == 128.0 ** 3, val  # (ones @ ones) is all-128s
        matmul_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        library()
        build_s = time.perf_counter() - t0
        gen = torch.Generator().manual_seed(0)
        y = torch.randn(2, 28000, generator=gen).cuda()
        bits = (torch.rand(2, 60, generator=gen) < 0.5).float().cuda()
        before = LAUNCHES["mask_gate"]
        got = mask_gate(y, bits, 14000 / 30.0)
        assert LAUNCHES["mask_gate"] == before + 1, "K2 did not launch"
        assert torch.equal(got, mask_gate_plain(y, bits, 14000 / 30.0)), \
            "K2 disagrees with its plain version"
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - diagnostic surface
        results.append(("accelerator", "FAIL",
                        f"CUDA path broken: {type(exc).__name__}: {exc}"))
        return
    results.append(("accelerator", "ok",
                    f"cuda x{count} ({name}), matmul round trip "
                    f"{matmul_s:.1f}s, kernel library loaded in "
                    f"{build_s:.1f}s, K2 exact against its plain version"))


def _check_compile_cache(results, device: str) -> None:
    from sos_tpu_torch.kernels import build as kbuild

    target = kbuild.BUILD_DIR / f"libsos_kernels_{kbuild._digest()}.so"
    built = target.exists()
    state = ("built" if built else "not built yet (nvcc builds it at the "
             "first kernel call, ~10 s)")
    try:
        kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=kbuild.BUILD_DIR):
            pass
    except OSError as exc:
        status = "warn" if built or device == "cpu" else "FAIL"
        results.append(("compile-cache", status,
                        f"{kbuild.BUILD_DIR} not writable ({exc}); "
                        f"{target.name} {state}"))
        return
    results.append(("compile-cache", "ok",
                    f"{kbuild.BUILD_DIR} writable; {target.name} {state}"))


def _check_native_engine(results) -> None:
    import numpy as np

    from sos_tpu_torch.runtime import engine

    if not engine.native_available():
        results.append(("native-engine", "warn",
                        "libsosaudio unavailable (g++ missing?) — wav "
                        "decode/resample falls back to Python (slower "
                        "host data path, same decoded samples)"))
        return
    from sos_tpu_torch.dsp import audio_io

    probe = (np.sin(np.linspace(0, 440 * np.pi, 14000))
             .astype(np.float32) * 0.5)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "probe.wav")
        audio_io.write_wav(path, probe, 14000)
        decoded, sr = engine.NativeAudioEngine(num_threads=1).load(path)
    # 16-bit wav round trip: one LSB of quantization, nothing more
    if sr == 14000 and decoded.shape == probe.shape and \
            float(np.abs(decoded - probe).max()) < 2.0 / 32767:
        results.append(("native-engine", "ok",
                        f"{engine.library_path().name} loaded; decode "
                        "round-trip exact"))
    else:
        results.append(("native-engine", "FAIL",
                        f"decode round-trip wrong (sr={sr}, "
                        f"shape={decoded.shape}) — rebuild: delete "
                        f"{engine.library_path()}"))


def _check_media_tools(results) -> None:
    from sos_tpu_torch.data.media import media_tools_available

    if media_tools_available():
        results.append(("media-tools", "ok", "ffmpeg + ffprobe on PATH"))
    else:
        results.append(("media-tools", "warn",
                        "ffmpeg/ffprobe not on PATH — video/non-wav "
                        "preprocessing is gated off; wav-only pipelines "
                        "unaffected"))


def _check_pesq_backend(results) -> None:
    from sos_tpu_torch.eval.speech import pesq_backend

    backend = pesq_backend()
    if backend == "native":
        results.append(("pesq-backend", "warn",
                        "native P.862 fallback (pypesq/pesq not "
                        "importable) — scores are self-consistent but "
                        "not certified conformant"))
    else:
        results.append(("pesq-backend", "ok", f"conformant `{backend}`"))


def _check_experiment(results, output_root: str, name: str) -> None:
    from sos_tpu_torch.cli.common import default_calibration_path

    for stage in ("detector", "denoiser"):
        model_dir = os.path.join(output_root, f"{name}_{stage}", "model")
        if not os.path.isdir(model_dir):
            results.append((f"experiment/{stage}", "FAIL",
                            f"{model_dir} missing — train or "
                            "import_checkpoint first"))
            continue
        ckpts = sorted(n[:-3] for n in os.listdir(model_dir)
                       if n.endswith(".pt"))
        if not ckpts:
            results.append((f"experiment/{stage}", "FAIL",
                            f"{model_dir} has no checkpoints (*.pt)"))
            continue
        tag = "ok" if "latest" in ckpts else "warn"
        results.append((f"experiment/{stage}", tag,
                        f"{len(ckpts)} checkpoints"
                        + ("" if "latest" in ckpts else
                           " (no `latest.pt` — `--ckpt latest` will "
                           "fail)")))
    cal = default_calibration_path(
        os.path.join(output_root, f"{name}_denoiser", "model"), "int8")
    if os.path.isfile(cal):
        results.append(("experiment/int8-calibration", "ok", cal))
    else:
        results.append(("experiment/int8-calibration", "warn",
                        f"{cal} absent — int8 serving self-calibrates "
                        "from the first request (numerics then depend "
                        "on traffic order); run `python -m sos_tpu_torch "
                        "calibrate` for the pinned path"))


def _check_dataset(results, dataset_json: str) -> None:
    from sos_tpu_torch.data import DatasetIndex

    try:
        index = DatasetIndex.load(dataset_json)
    except Exception as exc:  # noqa: BLE001 - diagnostic surface
        results.append(("dataset", "FAIL", f"{dataset_json}: {exc}"))
        return
    missing = [f.audio_path for f in index.files
               if not os.path.isfile(f.audio_path)]
    if missing:
        results.append(("dataset", "FAIL",
                        f"{len(missing)}/{len(index.files)} audio paths "
                        f"missing (first: {missing[0]})"))
    else:
        results.append(("dataset", "ok",
                        f"{len(index.files)} files, all audio paths "
                        "resolve"))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output_root", type=str, default=None,
                        help="with --name: check that experiment's "
                             "checkpoints + calibration")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--dataset_json", type=str, default=None,
                        help="also validate this dataset JSON")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output (one JSON object)")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    results = []
    _check_accelerator(results, args.device)
    _check_compile_cache(results, args.device)
    _check_native_engine(results)
    _check_media_tools(results)
    _check_pesq_backend(results)
    if args.name:
        _check_experiment(results, args.output_root or "model_output",
                          args.name)
    if args.dataset_json:
        _check_dataset(results, args.dataset_json)

    failed = any(status == "FAIL" for _, status, _ in results)
    if args.json:
        print(json.dumps({
            "ok": not failed,
            "checks": [{"name": n, "status": s, "detail": d}
                       for n, s, d in results]}))
    else:
        marks = {"ok": "[ ok ]", "warn": "[warn]", "FAIL": "[FAIL]"}
        for name, status, detail in results:
            print(f"{marks[status]} {name}: {detail}")
        print("doctor: " + ("FAIL — see lines above" if failed
                            else "all checks passed (warnings are "
                                 "fallback conditions)"))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
