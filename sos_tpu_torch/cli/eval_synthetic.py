"""Batched synthetic-mixture quality evaluation per SNR (port of
`sos_tpu/cli/eval_synthetic.py`).

Usage:
    python -m sos_tpu_torch.cli.eval_synthetic --dataset_json data/test.json \
        --noise_root data/noise_data_DEMAND/test_noise \
        [--ckpt latest | --pth ckpt_epoch24.pth] [--snr_idx 0 3 6] \
        [--batch_size 32] [--profile f32|bf16|int8] [--noisy_baseline] \
        [--out results.json] [--device cpu]

BASELINE config[1]: mixes the test set with corpus noise at each
requested SNR, denoises with the ground-truth intervals
(`infer/synthetic_eval.py`) and reports the 11 speech metrics' averages
per SNR in one command, and in the JSON `--out` as `{"snr_<dB>":
{"num_clips", "avg_<metric>", ...}}`. The denoiser is the experiment's
checkpoint `--ckpt` (default `latest`) or a reference-layout `--pth`. On
the card unless `--device cpu`.

It takes `sos_tpu`'s training flags, as `sos_tpu`'s does (`--batch_size`
and the config's data settings matter); it runs in one process on one
device, so the multi-process flags, which `sos_tpu`'s parses and never
reads, are usage errors here.
"""

import argparse
import dataclasses
import json

from sos_tpu_torch.cli.common import (add_common_train_args, load_stage_state,
                                      train_config_from_args)
from sos_tpu_torch.data import (DatasetIndex, DenoiserBatcher, NoiseBank,
                                denoiser_windows)
from sos_tpu_torch.infer.synthetic_eval import evaluate_synthetic


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    parser.add_argument("--pth", type=str, default=None,
                        help="reference-layout PyTorch checkpoint (.pth); "
                             "wins over --ckpt")
    parser.add_argument("--snr_idx", type=int, nargs="*", default=[0, 3, 6],
                        help="indices into the SNR set (-10..10)")
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--profile", type=str, default=None,
                        choices=("f32", "bf16", "int8"),
                        help="serving profile to evaluate (measures the "
                             "profile's quality delta on this checkpoint)")
    parser.add_argument("--noisy_baseline", action="store_true",
                        help="also score the noisy mixtures vs clean "
                             "(noisy_* columns) to show the improvement")
    args = parser.parse_args(argv)
    if (args.distributed or args.coordinator or args.num_processes
            or args.process_id is not None
            or args.num_devices not in (None, 1)):
        parser.error("--distributed/--coordinator/--num_processes/"
                     "--process_id/--num_devices: eval_synthetic runs in one "
                     "process on one device")
    cfg = train_config_from_args(args, "denoiser")
    state = load_stage_state(parser, cfg, "denoiser", args.ckpt, args.pth)

    index = DatasetIndex.load(args.dataset_json)
    noise = NoiseBank.from_roots(args.noise_root, cfg.data.sample_rate)
    windows = denoiser_windows(index.files, cfg.data.clip_seconds,
                               cfg.data.overlap_seconds)

    report = {}
    for idx in args.snr_idx:
        snr_cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, snr_idx=idx))
        batcher = DenoiserBatcher(windows, noise, snr_cfg.data,
                                  cfg.train.batch_size, shuffle=False,
                                  seed=cfg.data.pred_random_seed)
        agg = evaluate_synthetic(snr_cfg, state, batcher,
                                 max_batches=args.max_batches,
                                 profile=args.profile,
                                 noisy_baseline=args.noisy_baseline,
                                 device=args.device)
        snr = cfg.data.snrs[idx]
        report[f"snr_{snr}"] = agg
        print(f"SNR {snr:+d} dB: " + " ".join(
            f"{k.replace('avg_', '')}={v:.4f}" for k, v in agg.items()
            if k.startswith("avg_")))
        if args.noisy_baseline:
            print("  noisy baseline: " + " ".join(
                f"{k.replace('noisy_avg_', '')}={v:.4f}"
                for k, v in agg.items() if k.startswith("noisy_avg_")))
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=4)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
