"""Shared CLI plumbing (port of `sos_tpu/cli/common.py`): experiment
dirs, config construction, the flags of the serving, eval and training
entry points, checkpoint loading, the int8 scale-file convention.

Checkpoints: as in `sos_tpu`, `--ckpt` (eval CLIs) and
`--detector_ckpt`/`--denoiser_ckpt` (`serve`, `denoise`) default to
`latest` and name `<output_root>/<name>_<stage>/model/<ckpt>.pt`, which
the train and import_checkpoint CLIs write; a reference-layout `.pth`
(`--pth`, `--detector_pth`, `--denoiser_pth`) wins when given.

Training runs in float32 or bfloat16 on one device or data-parallel
over several, one process a card (`parallel/distributed.py`):
`--num_devices N` starts N processes on this host (default: every
visible card, the most that divides the batch; one on the CPU);
`--distributed` joins the processes torchrun started, `--coordinator
host:port --num_processes N --process_id K` an explicit group. Each
process trains on its shard of the data at its slice of the global
`--batch_size`."""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import Tuple

import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.models.torch_import import (import_denoiser_checkpoint,
                                               import_detector_checkpoint)
from sos_tpu_torch.parallel import distributed
from sos_tpu_torch.train.checkpoints import (CheckpointNotReadable,
                                             load_model_state)


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
    parser.add_argument("--detector_ckpt", type=str, default="latest",
                        help="the detector's checkpoint in the experiment "
                             "('latest', 'best_acc' or an epoch)")
    parser.add_argument("--denoiser_ckpt", type=str, default="latest",
                        help="the denoiser's checkpoint in the experiment "
                             "('latest', 'best_acc' or an epoch)")
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
    parser.add_argument("--ckpt", type=str, default="latest",
                        help="checkpoint in the experiment ('latest', "
                             "'best_acc' or an epoch)")
    parser.add_argument("--pth", type=str, default=None,
                        help="reference-layout PyTorch checkpoint (.pth); "
                             "wins over --ckpt")
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


def load_stage_state(parser: argparse.ArgumentParser, cfg: ExperimentConfig,
                     stage: str, ckpt: str, pth=None, pth_flag="--pth"):
    """The `stage` ("detector" | "denoiser") state_dict: from the
    reference-layout `pth` when given, else checkpoint `ckpt` of the
    experiment (`checkpoint_name`), as `sos_tpu`'s
    `load_detector_variables` picks. A checkpoint the port cannot read
    is a usage error that names the path it looked for."""
    if pth:
        load = (import_detector_checkpoint if stage == "detector"
                else import_denoiser_checkpoint)
        return load(pth)
    _, _, model_dir = experiment_dirs(cfg, stage, make=False)
    try:
        return load_model_state(model_dir, checkpoint_name(ckpt))
    except CheckpointNotReadable as e:
        parser.error(f"{stage} checkpoint: {e}; or pass {pth_flag} with a "
                     f"reference-layout .pth")


def config_from_args(args) -> ExperimentConfig:
    """The experiment config: `--config_json` when given (with `--name`
    and `--output_root` applied), else the defaults."""
    if getattr(args, "config_json", None):
        with open(args.config_json) as fp:
            base = ExperimentConfig.from_json(fp.read())
        return dataclasses.replace(base, name=args.name,
                                   output_root=args.output_root)
    return ExperimentConfig(name=args.name, output_root=args.output_root)


def load_checkpoint_states(parser: argparse.ArgumentParser, args,
                           cfg: ExperimentConfig):
    """(detector state_dict, denoiser state_dict) of the serving CLIs:
    `--detector_pth`/`--denoiser_pth` when given, else
    `--detector_ckpt`/`--denoiser_ckpt` of the experiment."""
    return tuple(load_stage_state(parser, cfg, stage,
                                  getattr(args, f"{stage}_ckpt"),
                                  getattr(args, f"{stage}_pth"),
                                  f"--{stage}_pth")
                 for stage in ("detector", "denoiser"))


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
                        help="data-parallel device count, one process a "
                             "device (default: every visible card, the "
                             "most that divides the batch; 1 on the CPU)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="training compute dtype of the conv trunks: "
                             "float32 (default, reference-exact) or "
                             "bfloat16 (the BiLSTM, heads and losses stay "
                             "float32); pair it with --no_remat")
    parser.add_argument("--no_remat", action="store_true",
                        help="disable per-block rematerialization "
                             "(faster; needs the activations to fit)")
    parser.add_argument("--distributed", action="store_true",
                        help="join a process group of one process a card "
                             "(torchrun's environment, or --coordinator) "
                             "and train on this process's data shard")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="process group address host:port (with "
                             "--num_processes and --process_id; implies "
                             "--distributed)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="processes in the group (one a card)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's index in the group")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps "
                             "[10, 15) here")
    add_device_arg(parser)


def launch_data_parallel(parser: argparse.ArgumentParser, args, argv,
                         module: str, cfg: ExperimentConfig) -> bool:
    """`--num_devices` N > 1 outside a process group: start N processes
    of `module` on this host (one a card; gloo processes with `--device
    cpu`), wait for them and return True. False when this process trains
    itself. Without `--num_devices`: every visible card, less until the
    count divides the batch (`sos_tpu`'s warning); one on the CPU."""
    if args.distributed or args.coordinator:
        return False
    n = args.num_devices
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    if n is None:
        n = max(1, cards)
        while cfg.train.batch_size % n:
            n -= 1
        if n < cards:
            logging.getLogger(__name__).warning(
                "batch_size=%d does not divide %d devices; training on %d "
                "device(s). Pick a divisible batch to use every card.",
                cfg.train.batch_size, cards, n)
    if n < 1:
        parser.error(f"--num_devices {n}: at least 1")
    if n == 1:
        return False
    if args.device == "cuda" and n > cards:
        parser.error(f"--num_devices {n}: this host has {cards} card(s)")
    if cfg.train.batch_size % n:
        raise ValueError(
            f"process count {n} must divide the global batch "
            f"{cfg.train.batch_size} (pick batch_size as a multiple of {n})")
    argv = list(sys.argv[1:] if argv is None else argv)
    if args.num_devices is None:
        argv += ["--num_devices", str(n)]
    distributed.spawn_local(module, argv, n, cpu=args.device == "cpu")
    return True


def setup_distributed(parser: argparse.ArgumentParser, args) -> Tuple[int, int]:
    """With `--distributed` or `--coordinator`: join the process group
    (raising when it cannot be joined; nothing trains alone instead).
    Returns (process index, process count). Call before any device
    use."""
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        parser.error("--coordinator needs --num_processes and --process_id "
                     "(or start the processes with torchrun and pass "
                     "--distributed)")
    if args.distributed or args.coordinator:
        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id, require=True,
                               device=args.device)
        n = distributed.process_count()
        if args.num_devices is not None and args.num_devices != n:
            parser.error(f"--num_devices {args.num_devices}: the process "
                         f"group has {n} processes (one a device)")
    return distributed.process_index(), distributed.process_count()


def shard_batchers_for_host(*batchers, cfg: ExperimentConfig, pid: int,
                            nproc: int):
    """Per-process data sharding: disjoint balanced window shards and
    this process's slice of the global batch size."""
    if nproc > 1:
        local_bs = distributed.process_local_batch_size(cfg.train.batch_size)
        for b in batchers:
            b.shard(pid, nproc)
            b.batch_size = local_bs
    return batchers if len(batchers) > 1 else batchers[0]


def train_config_from_args(args, stage: str) -> ExperimentConfig:
    """`config_from_args` plus `sos_tpu`'s training overrides; the
    denoiser's batch defaults to 40 (m2 common.py:52) without a config
    file, the detector's and the joint step's (`stage="joint"`) to
    `TrainConfig`'s 15."""
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
    windows, batchers, state, resume and `fit`, on `--device`, in one
    process or one a device (`launch_data_parallel`,
    `setup_distributed`)."""
    parser = argparse.ArgumentParser(description=doc)
    add_common_train_args(parser)
    args = parser.parse_args(argv)
    cfg = train_config_from_args(args, stage)
    if launch_data_parallel(parser, args, argv,
                            f"sos_tpu_torch.cli.train_{stage}", cfg):
        return
    pid, nproc = setup_distributed(parser, args)
    try:
        _train_stage(stage, args, cfg, pid, nproc)
    finally:
        distributed.shutdown()


def _train_stage(stage: str, args, cfg: ExperimentConfig, pid: int,
                 nproc: int) -> None:
    from sos_tpu_torch.data import (DatasetIndex, DenoiserBatcher,
                                    DetectorBatcher, NoiseBank,
                                    denoiser_windows, detector_windows,
                                    subsample_windows)
    from sos_tpu_torch.train import loop
    from sos_tpu_torch.train.checkpoints import CheckpointManager
    from sos_tpu_torch.train.fit import fit
    from sos_tpu_torch.train.state import TrainClock

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
    train_b, test_b = shard_batchers_for_host(train_b, test_b, cfg=cfg,
                                              pid=pid, nproc=nproc)

    steps_per_epoch = max(1, len(train_b))
    init = (loop.init_detector_state if stage == "detector"
            else loop.init_denoiser_state)
    _, state = init(cfg, device=distributed.local_device(args.device))
    clock = TrainClock()
    if args.cont:
        name = checkpoint_name(args.ckpt)
        state, clock = CheckpointManager(model_dir).load(name, state)
        if pid == 0:
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
