"""Shared CLI plumbing of the serving and eval entry points (the part of
`sos_tpu/cli/common.py` that `serve`, `denoise`, `predict_detector` and
`predict_denoiser` use): experiment dirs, config construction, the
flags, checkpoint loading, the int8 scale-file convention. The training
and distributed flags come with the training slice."""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Tuple

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.models.torch_import import (import_denoiser_checkpoint,
                                               import_detector_checkpoint)


def experiment_dirs(cfg: ExperimentConfig, stage: str,
                    make: bool = True) -> Tuple[str, str, str]:
    """(exp_dir, log_dir, model_dir) under output_root/{name}_{stage},
    `sos_tpu`'s layout, created unless `make=False` (a path lookup, as
    the detector CLI makes for the denoiser's scale file)."""
    exp_dir = os.path.join(cfg.output_root, f"{cfg.name}_{stage}")
    log_dir = os.path.join(exp_dir, "log")
    model_dir = os.path.join(exp_dir, "model")
    if make:
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(model_dir, exist_ok=True)
    return exp_dir, log_dir, model_dir


def add_serving_args(parser: argparse.ArgumentParser) -> None:
    """The flags both serving CLIs take: `sos_tpu`'s experiment flags
    (`--output_root`, `--name`, `--config_json`), the checkpoints and
    the device. The training and distributed flags of `sos_tpu`'s
    `add_common_train_args` come with the training slice."""
    parser.add_argument("--output_root", type=str, default="model_output")
    parser.add_argument("--name", type=str, default="experiment")
    parser.add_argument("--config_json", type=str, default=None,
                        help="ExperimentConfig JSON file (CLI flags override)")
    parser.add_argument("--detector_pth", type=str, default=None,
                        help="reference-layout detector checkpoint (.pth)")
    parser.add_argument("--denoiser_pth", type=str, default=None,
                        help="reference-layout denoiser checkpoint (.pth)")
    parser.add_argument("--detector_ckpt", type=str, default=None,
                        help="sos_tpu orbax checkpoint name: not readable "
                             "without JAX (use --detector_pth)")
    parser.add_argument("--denoiser_ckpt", type=str, default=None,
                        help="sos_tpu orbax checkpoint name: not readable "
                             "without JAX (use --denoiser_pth)")
    add_device_arg(parser)


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"),
                        help="cuda (default): the hand-written kernels on "
                             "the card; cpu: their plain PyTorch versions")


def add_eval_args(parser: argparse.ArgumentParser,
                  need_dataset: bool = True) -> None:
    """The flags of the eval CLIs (`predict_detector`, `predict_denoiser`):
    `sos_tpu`'s experiment, dataset and checkpoint flags, and the
    device."""
    parser.add_argument("--ckpt", type=str, default=None,
                        help="sos_tpu orbax checkpoint ('latest' or an "
                             "epoch): not readable without JAX (use --pth)")
    parser.add_argument("--pth", type=str, default=None,
                        help="reference-layout PyTorch checkpoint (.pth)")
    parser.add_argument("--dataset_json", type=str, required=need_dataset,
                        help="dataset JSON")
    parser.add_argument("--noise_root", type=str, action="append",
                        default=[],
                        help="noise corpus root(s) (DEMAND/AudioSet style)")
    parser.add_argument("--output_root", type=str, default="model_output")
    parser.add_argument("--name", type=str, default="experiment")
    parser.add_argument("--config_json", type=str, default=None,
                        help="ExperimentConfig JSON file (CLI flags override)")
    add_device_arg(parser)


def load_pth_state(parser: argparse.ArgumentParser, args, stage: str):
    """The `stage` ("detector" | "denoiser") state_dict from `--pth`.
    Without one it is a usage error: `sos_tpu`'s orbax checkpoints
    (`--ckpt`) need JAX to read."""
    if args.pth is None:
        parser.error(
            "sos_tpu_torch reads reference-layout .pth checkpoints: pass "
            "--pth. sos_tpu's orbax checkpoints (--ckpt) need JAX to read; "
            "their import comes with the port's training slice "
            "(ROADMAP.md queue 1 item 5)")
    load = (import_detector_checkpoint if stage == "detector"
            else import_denoiser_checkpoint)
    return load(args.pth)


def config_from_args(args) -> ExperimentConfig:
    """The experiment config: `--config_json` when given (with `--name`
    and `--output_root` applied), else the defaults."""
    if getattr(args, "config_json", None):
        with open(args.config_json) as fp:
            base = ExperimentConfig.from_json(fp.read())
        return dataclasses.replace(base, name=args.name,
                                   output_root=args.output_root)
    return ExperimentConfig(name=args.name, output_root=args.output_root)


def load_checkpoint_states(parser: argparse.ArgumentParser, args):
    """(detector state_dict, denoiser state_dict) from the `.pth` files.
    `sos_tpu`'s orbax checkpoints cannot be read without JAX: that route
    ends in a usage error."""
    if args.detector_ckpt is not None or args.denoiser_ckpt is not None \
            or args.detector_pth is None or args.denoiser_pth is None:
        parser.error(
            "sos_tpu_torch reads reference-layout .pth checkpoints: pass "
            "--detector_pth and --denoiser_pth. sos_tpu's orbax "
            "checkpoints (--detector_ckpt/--denoiser_ckpt) need JAX to "
            "read; their import comes with the port's training slice "
            "(ROADMAP.md queue 1 item 5)")
    return (import_detector_checkpoint(args.detector_pth),
            import_denoiser_checkpoint(args.denoiser_pth))


def default_calibration_path(denoiser_model_dir: str, profile,
                             explicit: str = None):
    """The int8 activation-scale file convention shared by the serving
    CLIs: <denoiser model dir>/int8_calibration.json (None for non-int8
    profiles; an explicit path always wins)."""
    if explicit is not None:
        return explicit
    if profile != "int8":
        return None
    return os.path.join(denoiser_model_dir, "int8_calibration.json")
