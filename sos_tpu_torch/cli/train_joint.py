"""Train the detector and the denoiser together, one step for both, on
one device (port of `sos_tpu/cli/train_joint.py`).

Usage:
    python -m sos_tpu_torch.cli.train_joint --dataset_json data/train.json \
        --noise_root data/noise_data_DEMAND/train_noise \
        [--compute_dtype bfloat16 --no_remat] [--device cpu]

One data pipeline (the denoiser's windows and batcher, at
`--batch_size`, 15 by default) and one step (`train/joint.py`) train the
detector (BCE) and the denoiser (dual MSE); each epoch writes both
stages' `ckpt_epoch{N}` and `latest` under `<name>_detector/model` and
`<name>_denoiser/model`, which the predict, serve and denoise CLIs read
with `--ckpt latest`. Every 10 steps a line goes to stdout and to
`<name>_detector/log/metrics.jsonl`. On the card unless `--device cpu`.

`sos_tpu`'s joint trainer parses `--continue`, `--save_step_frequency`
and `--test_dataset_json` and never reads them; here they are usage
errors rather than ignored.
"""

import argparse

from sos_tpu_torch.cli.common import (add_common_train_args,
                                      check_single_device, experiment_dirs,
                                      train_config_from_args)
from sos_tpu_torch.data import (DatasetIndex, DenoiserBatcher, NoiseBank,
                                denoiser_windows)
from sos_tpu_torch.train.checkpoints import CheckpointManager
from sos_tpu_torch.train.fit import MetricsLog, StepProfile
from sos_tpu_torch.train.joint import init_joint_states, make_joint_train_step
from sos_tpu_torch.train.state import TrainClock
from sos_tpu_torch.utils import StepTimer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    args = parser.parse_args(argv)
    check_single_device(parser, args)
    unread = [flag for flag, given in (
        ("--continue", args.cont),
        ("--save_step_frequency", args.save_step_frequency is not None),
        ("--test_dataset_json", args.test_dataset_json is not None)) if given]
    if unread:
        parser.error(f"{'/'.join(unread)}: the joint trainer does not read "
                     f"it (sos_tpu's parses it and never reads it); it "
                     f"trains from fresh weights and saves each epoch")
    cfg = train_config_from_args(args, "joint")
    _, det_log_dir, det_model_dir = experiment_dirs(cfg, "detector")
    _, _, den_model_dir = experiment_dirs(cfg, "denoiser")

    train_idx = DatasetIndex.load(args.dataset_json)
    noise = NoiseBank.from_roots(args.noise_root, cfg.data.sample_rate)
    windows = denoiser_windows(train_idx.files, cfg.data.clip_seconds,
                               cfg.data.overlap_seconds)
    batcher = DenoiserBatcher(windows, noise, cfg.data, cfg.train.batch_size,
                              shuffle=True, seed=cfg.train.seed)
    steps_per_epoch = max(1, len(batcher))

    (_, det_state), (_, den_state) = init_joint_states(
        cfg, device=args.device, seed=cfg.train.seed)
    step = make_joint_train_step(cfg, steps_per_epoch)
    det_mgr = CheckpointManager(det_model_dir)
    den_mgr = CheckpointManager(den_model_dir)
    clock = TrainClock()
    # the joint run's log lives under the detector stage dir, as sos_tpu's
    jsonl = MetricsLog(det_log_dir)
    timer = StepTimer()
    profiler = StepProfile(args.profile_dir)
    try:
        for epoch in range(cfg.train.nr_epochs):
            batcher.set_epoch(epoch)
            for batch in batcher:
                profiler.at(clock.step)
                timer.start()
                det_state, den_state, metrics = step(det_state, den_state,
                                                     batch)
                timer.stop()
                if clock.step % 10 == 0:
                    det_loss = metrics["detector_loss"]
                    den_loss = metrics["denoiser_loss"]
                    print(f"step {clock.step}: det={det_loss:.4f} "
                          f"den={den_loss:.4f}", flush=True)
                    jsonl.write("train", clock.step, epoch,
                                dict(metrics,
                                     steps_per_sec=timer.steps_per_sec))
                clock.tick()
            clock.tock()
            det_mgr.save_epoch(det_state, clock)
            den_mgr.save_epoch(den_state, clock)
            jsonl.write("epoch", clock.step, epoch, {})
    finally:
        profiler.close()
        jsonl.close()
    print("joint training complete")


if __name__ == "__main__":
    main()
