"""Stage bridge: eval_results.json -> pred_data.json + recovered wavs
(port of `sos_tpu/cli/bridge.py`; host numpy only, no device).

Usage:
    python -m sos_tpu_torch.cli.bridge --input_json outputs/sos/eval_results.json \
        [--snr 0] [--unknown_clean_signal true]

Equivalent of model_1 `create_data_from_pred.py` (:38-271): groups the
per-window predictions back into per-file bitstreams, re-mixes the saved
noise at the assigned SNR (when the clean signal is known) and emits the
stage-2 input JSON.
"""

import argparse

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.infer.evaluate import create_data_from_prediction


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_json", type=str, required=True)
    parser.add_argument("--output_json", type=str, default=None)
    parser.add_argument("--snr", type=float, default=None)
    parser.add_argument(
        "--unknown_clean_signal",
        type=lambda x: str(x).lower() in ("true", "1", "yes"), default=False)
    parser.add_argument(
        "--save_results",
        type=lambda x: str(x).lower() in ("true", "1", "yes"), default=True)
    args = parser.parse_args()
    out = create_data_from_prediction(
        ExperimentConfig(), args.input_json, output_json=args.output_json,
        noise_snr=args.snr, clean_audio=not args.unknown_clean_signal,
        save_results=args.save_results)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
