"""Top-level dispatcher: `python -m sos_tpu_torch <command> [args...]`
(port of `sos_tpu/__main__.py`).

One discoverable entry for every CLI of the port:

    python -m sos_tpu_torch train_detector --dataset_json data/train.json ...
    python -m sos_tpu_torch denoise --input noisy.wav --output clean.wav ...

`python -m sos_tpu_torch.cli.<command>` remains equivalent; this wrapper
only resolves the name and delegates, so both forms share argparse
behavior. Every command with device work runs on the CUDA card unless
given `--device cpu`; `preprocess` and `report` are host work.
"""
import ast
import importlib
import os
import sys

COMMANDS = (
    "preprocess", "train_detector", "train_denoiser", "train_joint",
    "predict_detector", "bridge", "predict_denoiser", "report",
    "denoise", "serve", "eval_synthetic", "export_serving",
    "import_checkpoint", "calibrate", "parity_check", "doctor",
)


def _summary(name: str) -> str:
    """First docstring line of sos_tpu_torch/cli/<name>.py WITHOUT
    importing it (each CLI module pulls torch and the models; --help
    must stay instant)."""
    path = os.path.join(os.path.dirname(__file__), "cli", f"{name}.py")
    try:
        with open(path) as fp:
            doc = ast.get_docstring(ast.parse(fp.read())) or ""
    except (OSError, SyntaxError):
        return ""
    return doc.strip().splitlines()[0] if doc.strip() else ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m sos_tpu_torch <command> [args...]\n\n"
              "commands:")
        for name in COMMANDS:
            print(f"  {name:<18} {_summary(name)}")
        print("\nper-command help: python -m sos_tpu_torch <command> --help")
        return 0 if argv else 2
    name, rest = argv[0], argv[1:]
    if name not in COMMANDS:
        print(f"unknown command {name!r}; one of: {', '.join(COMMANDS)}",
              file=sys.stderr)
        return 2
    mod = importlib.import_module(f"sos_tpu_torch.cli.{name}")
    sys.argv = [f"sos_tpu_torch {name}"] + rest
    mod.main()
    return 0


if __name__ == "__main__":
    sys.exit(main())
