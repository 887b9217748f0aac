"""Train the stage-2 joint denoiser on one device.

Usage:
    python -m sos_tpu_torch.cli.train_denoiser --dataset_json data/train.json \
        --noise_root data/noise_data_DEMAND/train_noise \
        [--continue --ckpt latest] [--compute_dtype bfloat16 --no_remat] \
        [--device cpu]

The port of `sos_tpu.cli.train_denoiser` (model_2 `train.py`, m2
train.py:27-92): dual MSE loss (inpainted noise against the full noise
+ the cRM-reconstructed spectrogram against the clean one), batch 40,
Adam + StepLR(15); float32 (or bfloat16 conv trunks), on the card unless `--device cpu`.
"""

from sos_tpu_torch.cli.common import run_training


def main(argv=None) -> None:
    run_training("denoiser", __doc__, argv)


if __name__ == "__main__":
    main()
