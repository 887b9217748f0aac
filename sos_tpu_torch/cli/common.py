"""Shared CLI plumbing (port of `sos_tpu/cli/common.py`): experiment
dirs, config construction, the flags of the serving, eval and training
entry points, checkpoint loading, the int8 scale-file convention.

Training runs on one device in float32: `--compute_dtype bfloat16`,
`--distributed`, `--coordinator` and `--num_devices` above 1 are usage
errors that name the later slice (ROADMAP.md queue 1 item 5)."""

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
    the device."""
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


def add_common_train_args(parser: argparse.ArgumentParser,
                          need_dataset: bool = True) -> None:
    """`sos_tpu`'s training flags, and the device."""
    parser.add_argument("--continue", dest="cont", action="store_true",
                        help="continue training from checkpoint; a "
                             "mid-epoch checkpoint (see "
                             "--save_step_frequency) resumes exactly at "
                             "the next minibatch of that epoch")
    parser.add_argument("--save_step_frequency", type=int, default=None,
                        help="save a mid-epoch 'latest' checkpoint every "
                             "N steps (0/unset = per-epoch only)")
    parser.add_argument("--ckpt", type=str, default="latest",
                        help="checkpoint to restore ('latest', 'best_acc' "
                             "or an epoch number)")
    parser.add_argument("--dataset_json", type=str, required=need_dataset,
                        help="dataset JSON")
    parser.add_argument("--test_dataset_json", type=str, default=None)
    parser.add_argument("--noise_root", type=str, action="append", default=[],
                        help="noise corpus root(s) (DEMAND/AudioSet style)")
    parser.add_argument("--output_root", type=str, default="model_output")
    parser.add_argument("--name", type=str, default="experiment")
    parser.add_argument("--config_json", type=str, default=None,
                        help="ExperimentConfig JSON file (CLI flags override)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None,
                        help="training seed (init + batch order)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="devices to train on: 1 (data parallelism is "
                             "a later slice)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="training compute dtype: float32 (bfloat16 "
                             "training is a later slice)")
    parser.add_argument("--no_remat", action="store_true",
                        help="disable per-block rematerialization "
                             "(faster; needs the activations to fit)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process training: a later slice")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-process coordinator: a later slice")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps "
                             "[10, 15) here")
    add_device_arg(parser)


def check_single_device(parser: argparse.ArgumentParser, args) -> None:
    """Refuse what the port cannot train yet, rather than silently train
    something else (float32 on one card)."""
    later = ("is a later slice of the port (ROADMAP.md queue 1 item 5); "
             "this one trains float32 on one device")
    if args.compute_dtype == "bfloat16":
        parser.error(f"--compute_dtype bfloat16: bfloat16 training {later}")
    if args.distributed or args.coordinator:
        parser.error(f"--distributed/--coordinator: multi-process training "
                     f"{later}")
    if args.num_devices is not None and args.num_devices != 1:
        parser.error(f"--num_devices {args.num_devices}: data-parallel "
                     f"training {later}")


def train_config_from_args(args, stage: str) -> ExperimentConfig:
    """`config_from_args` plus `sos_tpu`'s training overrides; the
    denoiser's batch defaults to 40 (m2 common.py:52) without a config
    file."""
    base = config_from_args(args)
    train_kw = {}
    if args.epochs is not None:
        train_kw["nr_epochs"] = args.epochs
    if args.batch_size is not None:
        train_kw["batch_size"] = args.batch_size
    elif stage == "denoiser" and not args.config_json:
        train_kw["batch_size"] = 40
    if args.lr is not None:
        train_kw["lr"] = args.lr
    if args.seed is not None:
        train_kw["seed"] = args.seed
    if args.save_step_frequency is not None:
        train_kw["save_step_frequency"] = args.save_step_frequency
    if args.compute_dtype is not None:
        train_kw["compute_dtype"] = args.compute_dtype
    if args.no_remat:
        train_kw["remat"] = False
    if not train_kw:
        return base
    return dataclasses.replace(
        base, train=dataclasses.replace(base.train, **train_kw))


def checkpoint_name(ckpt: str) -> str:
    """`--ckpt` -> a checkpoint name: 'latest', 'best_acc' or
    'ckpt_epoch{N}'."""
    return ckpt if ckpt in ("latest", "best_acc") else f"ckpt_epoch{ckpt}"


def run_training(stage: str, doc: str, argv=None) -> None:
    """The body of `train_detector` and `train_denoiser`: `sos_tpu`'s
    windows, batchers, state, resume and `fit`, on `--device`."""
    from sos_tpu_torch.data import (DatasetIndex, DenoiserBatcher,
                                    DetectorBatcher, NoiseBank,
                                    denoiser_windows, detector_windows,
                                    subsample_windows)
    from sos_tpu_torch.train import loop
    from sos_tpu_torch.train.checkpoints import CheckpointManager
    from sos_tpu_torch.train.fit import fit
    from sos_tpu_torch.train.state import TrainClock

    parser = argparse.ArgumentParser(description=doc)
    add_common_train_args(parser)
    args = parser.parse_args(argv)
    check_single_device(parser, args)
    cfg = train_config_from_args(args, stage)
    _, log_dir, model_dir = experiment_dirs(cfg, stage)

    train_idx = DatasetIndex.load(args.dataset_json)
    test_idx = DatasetIndex.load(args.test_dataset_json or args.dataset_json)
    noise = NoiseBank.from_roots(args.noise_root, cfg.data.sample_rate)
    if stage == "detector":
        train_windows = subsample_windows(
            detector_windows(train_idx.files, cfg.data.clip_frames),
            num=cfg.data.num_train_samples, seed=cfg.data.random_seed)
        base_test = detector_windows(test_idx.files, cfg.data.clip_frames)
        test_windows = subsample_windows(
            base_test, num=max(cfg.train.batch_size, len(base_test) // 10),
            seed=cfg.data.random_seed)
        batcher = DetectorBatcher
    else:
        train_windows = denoiser_windows(
            train_idx.files, cfg.data.clip_seconds, cfg.data.overlap_seconds)
        test_windows = subsample_windows(
            denoiser_windows(test_idx.files, cfg.data.clip_seconds,
                             cfg.data.overlap_seconds),
            fraction=0.1, seed=cfg.data.random_seed)
        batcher = DenoiserBatcher
    train_b = batcher(train_windows, noise, cfg.data, cfg.train.batch_size,
                      shuffle=True, seed=cfg.train.seed)
    test_b = batcher(test_windows, noise, cfg.data, cfg.train.batch_size,
                     shuffle=False, seed=cfg.train.seed + 1)

    steps_per_epoch = max(1, len(train_b))
    init = (loop.init_detector_state if stage == "detector"
            else loop.init_denoiser_state)
    _, state = init(cfg, device=args.device)
    clock = TrainClock()
    if args.cont:
        name = checkpoint_name(args.ckpt)
        state, clock = CheckpointManager(model_dir).load(name, state)
        print(f"resumed from {name} at epoch {clock.epoch}")
    if stage == "detector":
        train_step = loop.make_detector_train_step(cfg, steps_per_epoch)
        eval_step = loop.make_detector_eval_step(cfg)
    else:
        train_step = loop.make_denoiser_train_step(cfg, steps_per_epoch)
        eval_step = loop.make_denoiser_eval_step(cfg)
    fit(cfg, state, clock, train_step, eval_step, train_b, test_b,
        model_dir, log_dir, track_accuracy=stage == "detector",
        profile_dir=args.profile_dir)
