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

`--fast_profile` widens the stage's 48-channel encoder to 64 (the
detector's trunk, or the denoiser's noise encoder) losslessly, as
`sos_tpu`'s does: zero-padded weights, identity BatchNorm statistics on
the new channels (`models/torch_import.py` `pad_conv_stack`), the
stage's config replaced by `fast_detector_config()` /
`fast_denoiser_config()`. The other CLIs then read the checkpoint with a
config JSON of those widths.
"""

import argparse
import dataclasses
import os
import re

from sos_tpu_torch.cli.common import config_from_args, experiment_dirs
from sos_tpu_torch.config import fast_denoiser_config, fast_detector_config
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
                        help="widen 48-ch encoders to 64 (lossless zero-pad)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if args.fast_profile:
        if args.stage == "detector":
            cfg = dataclasses.replace(cfg, detector=fast_detector_config())
        else:
            cfg = dataclasses.replace(cfg, denoiser=fast_denoiser_config())
    _, _, model_dir = experiment_dirs(cfg, args.stage)

    if args.stage == "detector":
        state_dict = import_detector_checkpoint(
            args.pth, nf=cfg.detector.nf if args.fast_profile else None)
        init = init_detector_state
    else:
        state_dict = import_denoiser_checkpoint(
            args.pth,
            nf_noise=cfg.denoiser.nf_noise if args.fast_profile else None)
        init = init_denoiser_state
    _, state = init(cfg, device="cpu", state_dict=state_dict)
    match = re.search(r"epoch(\d+)", os.path.basename(args.pth))
    clock = TrainClock(epoch=int(match.group(1)) if match else 0)
    path = CheckpointManager(model_dir).save_epoch(state, clock)
    print(f"imported {args.pth} -> {path} (and 'latest')")


if __name__ == "__main__":
    main()
