"""Import a reference PyTorch checkpoint into the experiment layout
(port of `sos_tpu/cli/import_checkpoint.py`).

Usage:
    python -m sos_tpu_torch.cli.import_checkpoint --stage detector \
        --pth ckpt_epoch87.pth [--name experiment] [--output_root model_output]

Reads a released `.pth` (m1/m2 agent.py:62-83 layout) through
`models/torch_import.py` and saves it, with a fresh Adam state and the
clock at the epoch in the file's name (`epoch(\\d+)`, else 0), as
`ckpt_epoch{N}` and `latest` under `{output_root}/{name}_{stage}/model/`,
the files the port's train CLIs write. Every other CLI then reads it
with `--ckpt {N}` or `--ckpt latest`, and `train_* --continue --ckpt N`
fine-tunes it. The import moves weights between files and runs nothing
on a device.

`--fast_profile` (`sos_tpu`'s lossless widening of the 48-channel
encoders to 64, a TPU layout profile) is a usage error: the port runs
the reference widths only.
"""

import argparse
import os
import re

from sos_tpu_torch.cli.common import config_from_args, experiment_dirs
from sos_tpu_torch.models.torch_import import (import_denoiser_checkpoint,
                                               import_detector_checkpoint)
from sos_tpu_torch.train.checkpoints import CheckpointManager
from sos_tpu_torch.train.loop import init_denoiser_state, init_detector_state
from sos_tpu_torch.train.state import TrainClock


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--stage", choices=("detector", "denoiser"),
                        required=True)
    parser.add_argument("--pth", type=str, required=True)
    parser.add_argument("--name", type=str, default="experiment")
    parser.add_argument("--output_root", type=str, default="model_output")
    parser.add_argument("--config_json", type=str, default=None)
    parser.add_argument("--fast_profile", action="store_true",
                        help="sos_tpu's TPU width padding: not carried by "
                             "the port (a usage error)")
    args = parser.parse_args(argv)
    if args.fast_profile:
        parser.error("--fast_profile widens sos_tpu's 48-channel encoders "
                     "to 64 for the TPU's layout; sos_tpu_torch runs the "
                     "reference widths only and does not carry it")
    cfg = config_from_args(args)
    _, _, model_dir = experiment_dirs(cfg, args.stage)

    if args.stage == "detector":
        state_dict = import_detector_checkpoint(args.pth)
        init = init_detector_state
    else:
        state_dict = import_denoiser_checkpoint(args.pth)
        init = init_denoiser_state
    _, state = init(cfg, device="cpu", state_dict=state_dict)
    match = re.search(r"epoch(\d+)", os.path.basename(args.pth))
    clock = TrainClock(epoch=int(match.group(1)) if match else 0)
    path = CheckpointManager(model_dir).save_epoch(state, clock)
    print(f"imported {args.pth} -> {path} (and 'latest')")


if __name__ == "__main__":
    main()
