"""Train the stage-1 silent-interval detector.

Usage:
    python -m sos_tpu_torch.cli.train_detector --dataset_json data/train.json \
        --noise_root data/noise_data_DEMAND/train_noise \
        [--continue --ckpt latest] [--compute_dtype bfloat16 --no_remat] \
        [--num_devices N] [--device cpu]

The port of `sos_tpu.cli.train_detector` (model_1 `train.py`, m1
train.py:29-99): 100 epochs, BCE loss, Adam + StepLR(15), val every 10
steps, best-acc tracking; float32
(or bfloat16 conv trunks), on the card unless `--device cpu`;
data-parallel over `--num_devices` cards (one process a card) or a
torchrun group (`--distributed`).
"""

from sos_tpu_torch.cli.common import run_training


def main(argv=None) -> None:
    run_training("detector", __doc__, argv)


if __name__ == "__main__":
    main()
