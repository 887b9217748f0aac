"""The eval pipeline: stage-1 eval, stage bridge, stage-2 eval — schema-exact
(port of `sos_tpu/infer/evaluate.py`: the same functions, JSON schema and
file layout, over the port's predictors).

These produce/consume the same on-disk artifacts as the reference CLIs so
results remain interchangeable:

* :func:`evaluate_detector`  -> `eval_results{suffix}.json` + `noise{suffix}/`
  wavs+json (m1 predict.py:38-233)
* :func:`create_data_from_prediction` -> `pred_data{suffix}.json` +
  `recovered{suffix}/` `*_mixed.wav`/`*_clean.wav`/`*_full_noise.wav`
  (m1 create_data_from_pred.py:38-271)
* :func:`evaluate_denoiser`  -> per-file `denoised_output.wav` etc. +
  `eval_results{suffix}.json` with the speech-metric suite
  (m2 predict.py:255-575)

Known reference quirks handled deliberately: the bridge's noise crop
tuple-slice no-op (create_data_from_pred.py:159) is replaced by a correct
crop (same net behavior since add_noise re-crops at start_pos=0), and
metrics are computed at 16 kHz after resampling (m2 predict.py:461-466).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from itertools import groupby
from typing import Dict, List, Optional

import numpy as np

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.data.index import DatasetIndex
from sos_tpu_torch.data.sampling import NoiseBank
from sos_tpu_torch.data.windows import detector_windows
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.dsp.mixing import (
    bitstream_to_sample_mask_np,
    crop_noise_np,
    mix_at_snr_np,
)
from sos_tpu_torch.eval.detection import detection_statistics
from sos_tpu_torch.eval.speech import evaluate_metrics
from sos_tpu_torch.infer.denoise import DenoiserPredictor
from sos_tpu_torch.infer.detect import DetectorPredictor


def snr_suffix(snr: Optional[float]) -> str:
    """'_snr{v}' with '.'->'_' (m1 tools.py:873-893), '' when None."""
    if snr is None:
        return ""
    value = float(snr)
    value = int(value) if value.is_integer() else value
    return "_snr" + str(value).replace(".", "_")


def _basename_noext(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


# ---------------------------------------------------------------------------
# Stage 1: detector evaluation
# ---------------------------------------------------------------------------


def evaluate_detector(
    cfg: ExperimentConfig,
    predictor: DetectorPredictor,
    dataset_json: str,
    output_dir: str,
    noise_bank: Optional[NoiseBank] = None,
    snr_idx: Optional[int] = None,
    clean_audio: bool = True,
    save_noise_info: bool = True,
    save_individual_results: bool = False,
    batch_size: Optional[int] = None,
) -> str:
    """Run full-utterance detection over a dataset JSON; write eval_results.

    `save_individual_results` saves the mixed input wav for "interesting"
    items — any with mismatched or silent frames (m1 predict.py:150-176
    keeps audio/plots for label != pred or silent cases).

    `batch_size` (with a bucketed predictor) dispatches same-bucket
    utterances through one call per tile instead of the
    reference's batch-1 loop (m1 predict.py:71) — same bits, confidences
    within float rounding. The predictor runs on its own device.
    """
    os.makedirs(output_dir, exist_ok=True)
    index = DatasetIndex.load(dataset_json)
    windows = detector_windows(index.files, cfg.data.clip_frames, pred=True)
    sr = cfg.data.sample_rate
    suffix = snr_suffix(cfg.data.snrs[snr_idx]) if (
        clean_audio and snr_idx is not None) else ""

    assignment: Dict[int, tuple] = {}
    if clean_audio:
        assert noise_bank is not None, "clean_audio=True needs a noise bank"
        assignment = noise_bank.assign_for_prediction(
            index.files, cfg.data.snrs, snr_idx, seed=cfg.data.pred_random_seed)
        if save_noise_info:
            # the noise-assignment JSON is keyed by wav basename (the
            # reference's schema, m1 predict.py:79-104) — two dataset
            # files sharing a basename would silently overwrite each
            # other's assignment and the bridge would re-mix file A with
            # file B's noise; fail loudly instead
            from collections import Counter
            counts = Counter(os.path.basename(index[f_idx].path)
                             for f_idx in assignment)
            dups = sorted(n for n, c in counts.items() if c > 1)
            if dups:
                raise ValueError(
                    "duplicate wav basenames in the dataset (the noise "
                    f"assignment is keyed by basename): {dups[:5]} — "
                    "rename the files or evaluate the directories "
                    "separately")
            noise_dir = os.path.join(output_dir, "noise" + suffix)
            os.makedirs(noise_dir, exist_ok=True)
            noise_files = OrderedDict()
            for f_idx, (noise, snr) in assignment.items():
                stem = _basename_noext(index[f_idx].path)
                noise_name = stem + "_noise.wav"
                audio_io.write_wav(os.path.join(noise_dir, noise_name), noise, sr)
                noise_files[os.path.basename(index[f_idx].path)] = OrderedDict(
                    [("audio", stem + ".wav"), ("noise", noise_name),
                     ("snr", snr)])
            with open(os.path.join(noise_dir,
                                   (suffix[1:] or "noise") + ".json"), "w") as fp:
                json.dump({"snrs": list(cfg.data.snrs), "files": noise_files},
                          fp, indent=4)

    # Phase 1: assemble all mixed inputs on the host.
    mixed_all: List[np.ndarray] = []
    labels_all_items: List[np.ndarray] = []
    for w in windows:
        f = index[w.file_index]
        snd, _ = audio_io.load(f.audio_path, sr=sr)
        labels = np.asarray(w.bits, dtype=np.int64)
        if clean_audio:
            ratio = float(sr) / w.framerate
            mask = bitstream_to_sample_mask_np(
                labels.astype(np.float32), ratio, len(snd),
                cfg.data.despeckle_min_run)
            clean = snd * (1 - mask)
            noise, snr = assignment[w.file_index]
            start_pos = int(w.start_frame / w.framerate * sr)
            cropped = crop_noise_np(noise, len(clean), start=start_pos)
            mixed, _, _ = mix_at_snr_np(clean, cropped, snr,
                                        norm=cfg.data.mix_norm)
        else:
            mixed = snd
        mixed_all.append(mixed.astype(np.float32))
        labels_all_items.append(labels)

    # Phase 2: detect (batched over same-bucket utterances when enabled).
    if batch_size is not None and predictor.buckets is not None:
        predictions = predictor.predict_batch(
            mixed_all, [len(lb) for lb in labels_all_items],
            batch_size=batch_size)
    else:
        predictions = [predictor.predict_waveform(m, num_frames=len(lb))
                       for m, lb in zip(mixed_all, labels_all_items)]

    # Phase 3: per-item records.
    records: List[OrderedDict] = []
    for data_id, w in enumerate(windows):
        f = index[w.file_index]
        mixed = mixed_all[data_id]
        labels = labels_all_items[data_id]
        bits, conf = predictions[data_id]
        extra: Dict[str, str] = {}
        if save_individual_results and (
                not np.array_equal(bits, labels) or 0 in labels or 0 in bits):
            audio_dir = os.path.join(output_dir, "audio" + suffix)
            os.makedirs(audio_dir, exist_ok=True)
            wav_rel = os.path.join("audio" + suffix, f"{data_id}.wav")
            audio_io.write_wav(os.path.join(output_dir, wav_rel), mixed, sr)
            extra["audio"] = wav_rel
            # Overlay plots for mismatched/silent items (m1 predict.py:150-183
            # saves waveform+bitstream pngs alongside the audio).
            from sos_tpu_torch.utils.visualization import (
                draw_bitstream_overlay, draw_floatstream_overlay, save_image)
            gt_png = os.path.join("audio" + suffix, f"{data_id}_gt.png")
            pred_png = os.path.join("audio" + suffix, f"{data_id}_pred.png")
            save_image(os.path.join(output_dir, gt_png), draw_bitstream_overlay(
                mixed, sr, "".join(str(int(b)) for b in labels), w.framerate))
            save_image(os.path.join(output_dir, pred_png),
                     draw_floatstream_overlay(
                         mixed, sr, np.asarray(conf, np.float32)[None, :],
                         labels=["confidence"], framerate=w.framerate))
            extra["plot_gt"] = gt_png
            extra["plot_pred"] = pred_png
        records.append(OrderedDict([
            ("id", data_id),
            ("path", f.path),
            ("full_bit_stream", f.bit_stream),
            ("num_frames", f.num_frames),
            ("framerate", f.framerate),
            ("audio_sample_rate", f.audio_sample_rate),
            ("audio_samples", f.audio_samples),
            ("duration", f.duration),
            ("frame_start_idx", w.start_frame),
            ("label", [str(int(b)) for b in labels]),
            ("pred_label", [str(int(b)) for b in bits]),
            ("match", [str(int(b)) for b in labels] ==
                      [str(int(b)) for b in bits]),
            ("confidence", [str(c) for c in conf]),
        ] + list(extra.items())))

    labels_all = [int(b) for r in records for b in r["label"]]
    preds_all = [int(b) for r in records for b in r["pred_label"]]
    stat_dict = OrderedDict([
        ("data_total_frames", cfg.data.clip_frames),
        ("data_center_frames", cfg.data.silent_consecutive_frames),
        ("sigmoid_threshold", predictor.threshold),
        ("snr", cfg.data.snrs[snr_idx] if snr_idx is not None else None),
        ("prediction_statistics",
         OrderedDict([("all", detection_statistics(labels_all, preds_all))])),
        ("data", sorted(records, key=lambda r: -np.mean(
            [float(c) for c in r["confidence"]]))),
    ])
    out_path = os.path.join(output_dir, f"eval_results{suffix}.json")
    with open(out_path, "w") as fp:
        json.dump(stat_dict, fp, indent=4)
    return out_path


# ---------------------------------------------------------------------------
# Stage bridge: eval_results.json -> pred_data.json + recovered wavs
# ---------------------------------------------------------------------------


def create_data_from_prediction(
    cfg: ExperimentConfig,
    input_json: str,
    output_json: Optional[str] = None,
    noise_snr: Optional[float] = None,
    clean_audio: bool = True,
    save_results: bool = True,
    save_pr_curve: bool = False,
) -> str:
    with open(input_json) as fp:
        payload = json.load(fp)
    records = sorted(payload["data"], key=lambda r: r["id"])
    nsuffix = snr_suffix(noise_snr)
    base_dir = os.path.dirname(os.path.abspath(input_json))
    if output_json is None:
        output_json = os.path.join(base_dir, f"pred_data{nsuffix}.json")
    sr = cfg.data.sample_rate

    groups = []
    for path, recs in groupby(records, key=lambda r: r["path"]):
        recs = list(recs)
        head = recs[0]
        groups.append(OrderedDict([
            ("path", path),
            ("num_frames", head["num_frames"]),
            ("framerate", head["framerate"]),
            ("audio_sample_rate", head["audio_sample_rate"]),
            ("audio_samples", head["audio_samples"]),
            ("duration", head["duration"]),
            ("bit_stream", head["full_bit_stream"]),
            ("ground_truth_bit_stream",
             "".join(str(int(b)) for r in recs for b in r["label"])),
            ("predicted_bit_stream",
             "".join(str(int(b)) for r in recs for b in r["pred_label"])),
            ("recovered_prediction", None),
            ("overlay_original", None),
            ("overlay_predicted", None),
        ]))

    labels: List[int] = []
    preds: List[int] = []
    ds_path = ""
    # recovered/ wavs anchor at the OUTPUT json's directory: pred_data
    # records them as paths relative to itself and evaluate_denoiser
    # resolves them against dirname(pred_data_json) — anchoring at the
    # input side would break --output_json into another directory
    # (reference parity: create_data_from_pred.py:148 writes next to
    # its output json). Noise-info reads stay at base_dir (they were
    # written next to eval_results by stage 1).
    out_dir = os.path.dirname(os.path.abspath(output_json))
    save_dir = os.path.join(out_dir, "recovered" + nsuffix)
    if save_results:
        # recovered/ stems are wav basenames — duplicates would silently
        # overwrite each other's mixed/clean/noise outputs (the loud
        # guard in evaluate_detector only runs on the save_noise_info
        # path); fail loudly here too
        from collections import Counter
        counts = Counter(_basename_noext(it["path"]) for it in groups)
        dups = sorted(s for s, c in counts.items() if c > 1)
        if dups:
            raise ValueError(
                "duplicate wav basenames in eval_results (recovered/ "
                f"outputs are keyed by basename): {dups[:5]} — rename "
                "the files or bridge the directories separately")
    noise_info_all = None
    if save_results and clean_audio:
        noise_json = os.path.join(
            base_dir, "noise" + nsuffix, (nsuffix[1:] or "noise") + ".json")
        with open(noise_json) as fp:
            noise_info_all = json.load(fp)["files"]
    for item in groups:
        ds_path = item["path"] if not ds_path else os.path.commonprefix(
            [ds_path, item["path"]])
        item["num_frames"] = len(item["bit_stream"])
        item["recovered_prediction"] = item["predicted_bit_stream"]
        # Deliberate fix vs the reference (create_data_from_pred.py:
        # 114-115): it zips the FULL '2'-padded bit_stream against the
        # truncated-span predictions, so leading padding shifts every
        # label and the '2's themselves corrupt the binary statistics.
        # ground_truth_bit_stream is built from the same windows as the
        # predictions, so the pair is exactly aligned; identical to the
        # reference pairing whenever the stream has no padding (e.g. the
        # golden demo fixtures, pinned by tests/test_golden_bridge.py).
        labels += [int(c) for c in item["ground_truth_bit_stream"]]
        preds += [int(c) for c in item["recovered_prediction"]]

        if not save_results:
            continue
        os.makedirs(save_dir, exist_ok=True)
        wav_path = item["path"]
        if wav_path.endswith(".mp4"):
            # video-era dataset records: the record path names the clip,
            # the detected audio lives beside it as .wav (reference
            # parity: create_data_from_pred.py:129; evaluate_detector
            # itself reads the record's audio_path)
            wav_path = wav_path[:-4] + ".wav"
        stem = _basename_noext(wav_path)
        snd, _ = audio_io.load(wav_path, sr=sr)
        if clean_audio:
            noise_info = noise_info_all[os.path.basename(wav_path)]
            noise, _ = audio_io.load(
                os.path.join(base_dir, "noise" + nsuffix, noise_info["noise"]),
                sr=sr)
            noise_crop = crop_noise_np(noise, len(snd), start=0)
            mixed, clean, full_noise = mix_at_snr_np(
                snd, noise_crop, noise_info["snr"], norm=cfg.data.mix_norm)
            for name, sig in (("_mixed", mixed), ("_clean", clean),
                              ("_full_noise", full_noise)):
                audio_io.write_wav(
                    os.path.join(save_dir, stem + name + ".wav"), sig, sr)
            item["mixed_audio"] = os.path.join(
                os.path.basename(save_dir), stem + "_mixed.wav")
            item["clean_audio"] = os.path.join(
                os.path.basename(save_dir), stem + "_clean.wav")
            item["full_noise"] = os.path.join(
                os.path.basename(save_dir), stem + "_full_noise.wav")
            item["audio_path"] = os.path.join(save_dir, stem + "_clean.wav")
        else:
            audio_io.write_wav(
                os.path.join(save_dir, stem + "_mixed.wav"), snd, sr)
            item["mixed_audio"] = os.path.join(
                os.path.basename(save_dir), stem + "_mixed.wav")

    hierarchy = OrderedDict([
        ("dataset_path", ds_path),
        ("num_videos", len(groups)),
        ("data_total_frames", payload["data_total_frames"]),
        ("data_center_frames", payload["data_center_frames"]),
        ("sigmoid_threshold", payload["sigmoid_threshold"]),
        ("snr", noise_snr),
        ("prediction_statistics", detection_statistics(labels, preds)),
        ("files", groups),
    ])

    if save_pr_curve:
        # precision-recall over scaled confidences, silent class positive
        # (create_data_from_pred.py:223-259)
        confidences = [1.0 - float(c) for r in records for c in r["confidence"]]
        try:
            from sklearn.metrics import auc as _auc, precision_recall_curve

            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            p1, r1, _ = precision_recall_curve(labels, confidences, pos_label=0)
            ap = _auc(r1, p1)
            plt.figure()
            plt.plot(r1, p1, label=f"confidence; AP={ap:.3f}")
            plt.xlabel("Recall")
            plt.ylabel("Precision")
            plt.legend()
            pr_path = output_json.replace(".json", "_pr.png")
            plt.savefig(pr_path)
            plt.close()
            hierarchy["prediction_statistics"]["pr_curve"] = \
                os.path.basename(pr_path)
        except ImportError:
            pass
    with open(output_json, "w") as fp:
        json.dump(hierarchy, fp, indent=4)
    return output_json


# ---------------------------------------------------------------------------
# Stage 2: denoiser evaluation
# ---------------------------------------------------------------------------


def _load_many(paths: List[str], sr: int) -> List[np.ndarray]:
    """Decode many wavs; the threaded C++ engine (`runtime/`) when its
    library builds AND no resample is needed (the native resampler
    differs from the python one by float rounding; decode-only gives
    the serial path's samples)."""
    from sos_tpu_torch.runtime import NativeAudioEngine, native_available

    if paths and native_available():
        eng = NativeAudioEngine(num_threads=8)
        infos = [eng.info(p) for p in paths]
        if all(s == sr for _, s in infos):
            max_n = max(n for n, _ in infos)
            buf, lengths = eng.load_batch(paths, sr, max_n)
            return [buf[i, : lengths[i]].copy() for i in range(len(paths))]
    return [audio_io.load(p, sr=sr)[0] for p in paths]


def evaluate_denoiser(
    cfg: ExperimentConfig,
    predictor: DenoiserPredictor,
    pred_data_json: str,
    output_dir: str,
    snr: Optional[float] = None,
    unknown_clean_signal: bool = False,
    save_individual_results: bool = True,
    save_visualizations: bool = False,
    metrics_sr: int = 16000,
    batch_size: Optional[int] = None,
) -> str:
    """`batch_size` (with a bucketed predictor) dispatches same-bucket
    utterances through one call per tile, instead of the reference's
    one-utterance-at-a-time loop (m2 predict.py:405-526)."""
    with open(pred_data_json) as fp:
        payload = json.load(fp)
    base_dir = os.path.dirname(os.path.abspath(pred_data_json))
    os.makedirs(output_dir, exist_ok=True)
    sr = cfg.data.sample_rate

    files = payload["files"]
    if files and "mixed_audio" not in files[0]:
        raise ValueError(
            "pred_data records carry no 'mixed_audio' — the bridge was "
            "run with save_results=False, which skips writing the "
            "recovered/ wavs stage 2 consumes. Re-run sos_tpu_torch.cli.bridge "
            "with --save_results true.")
    mixed_paths = [os.path.join(base_dir, d["mixed_audio"]) for d in files]
    mixed_all = _load_many(mixed_paths, sr)
    use_batched = batch_size is not None and predictor.buckets is not None
    if use_batched:
        framerates = {d["framerate"] for d in files}
        outs_all = []
        for fr in sorted(framerates):  # denoise_batch takes one framerate
            idxs = [i for i, d in enumerate(files) if d["framerate"] == fr]
            keys = ("denoised", "predicted_noise", "gated_noise") \
                if save_individual_results else ("denoised",)
            outs = predictor.denoise_batch(
                [mixed_all[i] for i in idxs],
                [files[i]["recovered_prediction"] for i in idxs],
                framerate=fr, batch_size=batch_size, keys=keys)
            outs_all.extend(zip(idxs, outs))
        outs_by_item = dict(outs_all)

    # Metric suite in a thread pool: WSS/LLR/PESQ per utterance are the
    # host bottleneck once inference is batched (numpy releases the GIL;
    # the reference computes them serially, m2 predict.py:455-466).
    _metrics_by_item: Dict[int, OrderedDict] = {}
    if not unknown_clean_signal and files:
        from concurrent.futures import ThreadPoolExecutor

        if use_batched:
            outs_cache = outs_by_item
        else:
            outs_cache = {i: predictor.denoise_waveform(
                mixed_all[i], files[i]["recovered_prediction"],
                framerate=files[i]["framerate"]) for i in range(len(files))}

        def _one_metrics(i):
            data = files[i]
            clean, _ = audio_io.load(
                os.path.join(base_dir, data["clean_audio"]), sr=sr)
            gt_mask = bitstream_to_sample_mask_np(
                np.asarray([0 if c == "0" else 1
                            for c in data["bit_stream"]], np.float32),
                float(sr) / data["framerate"], len(clean),
                cfg.data.despeckle_min_run)
            clean = clean * (1 - gt_mask)
            denoised = outs_cache[i]["denoised"]
            out_16k = audio_io.resample(denoised, sr, metrics_sr)
            clean_16k = audio_io.resample(clean[: len(denoised)], sr,
                                          metrics_sr)
            return i, evaluate_metrics(out_16k, clean_16k, sr=metrics_sr)

        with ThreadPoolExecutor(max_workers=8) as pool:
            for i, m in pool.map(_one_metrics, range(len(files))):
                _metrics_by_item[i] = m

    stat: List[OrderedDict] = []
    for item_idx, data in enumerate(files):
        mixed_path = mixed_paths[item_idx]
        mixed = mixed_all[item_idx]
        bits = data["recovered_prediction"]
        if not unknown_clean_signal:
            outs = outs_cache[item_idx]
        elif use_batched:
            outs = outs_by_item[item_idx]
        else:
            outs = predictor.denoise_waveform(mixed, bits,
                                              framerate=data["framerate"])
        denoised = outs["denoised"]

        info = OrderedDict([
            ("id", _basename_noext(data["path"])),
            ("path", data["path"]),
        ])
        if not unknown_clean_signal:
            # (the silence-gated clean signal itself is only needed by
            # _one_metrics above — no need to re-decode it here)
            clean_path = os.path.join(base_dir, data["clean_audio"])
            info["clean_audio_path"] = clean_path
            info["mixed_audio_path"] = mixed_path
            info["full_noise_path"] = os.path.join(base_dir, data["full_noise"])
            info["bitstream"] = bits
            info["sr"] = sr
            info["snr"] = snr
            info.update(_metrics_by_item[item_idx])
        else:
            info["mixed_audio_path"] = mixed_path
            info["bitstream"] = bits
            info["sr"] = sr
            info["snr"] = snr

        if save_individual_results:
            save_dir = os.path.join(output_dir, snr_suffix(snr)[1:] or "",
                                    str(info["id"]))
            os.makedirs(save_dir, exist_ok=True)
            audio_io.write_wav(os.path.join(save_dir, "noisy_input.wav"),
                               mixed, sr)
            audio_io.write_wav(os.path.join(save_dir, "noise_intervals.wav"),
                               outs["gated_noise"], sr)
            audio_io.write_wav(
                os.path.join(save_dir, "predicted_full_noise.wav"),
                outs["predicted_noise"], sr)
            audio_io.write_wav(os.path.join(save_dir, "denoised_output.wav"),
                               denoised, sr)
            info["noisy_input"] = os.path.join(save_dir, "noisy_input.wav")
            info["noise_intervals"] = os.path.join(save_dir,
                                                   "noise_intervals.wav")
            info["predicted_full_noise"] = os.path.join(
                save_dir, "predicted_full_noise.wav")
            info["denoised_output"] = os.path.join(save_dir,
                                                   "denoised_output.wav")
            if save_visualizations:
                from sos_tpu_torch.utils.visualization import (
                    draw_spectrum, draw_waveform, save_image)

                sigs = [mixed, outs["gated_noise"], outs["predicted_noise"],
                        denoised]
                titles = ["Noisy Input", "Noise Intervals",
                          "Predicted Full Noise", "Denoised Output"]
                save_image(os.path.join(save_dir, "waveform.png"),
                           draw_waveform(sigs, sr=sr, titles=titles))
                save_image(os.path.join(save_dir, "spectrum.png"),
                           draw_spectrum(sigs, sr=sr, titles=titles))
                info["waveform"] = os.path.join(save_dir, "waveform.png")
                info["spectrum"] = os.path.join(save_dir, "spectrum.png")
            with open(os.path.join(save_dir, "stat.json"), "w") as fp:
                json.dump(info, fp, indent=4)
        stat.append(info)

    data_info = OrderedDict([
        ("dataset_path", payload["dataset_path"]),
        ("num_videos", payload["num_videos"]),
        ("data_total_frames", payload["data_total_frames"]),
        ("data_center_frames", payload["data_center_frames"]),
        ("sigmoid_threshold", payload["sigmoid_threshold"]),
        ("snr", snr),
    ])
    if not unknown_clean_signal and stat:
        keys = ("l1", "stoi", "csig", "cbak", "covl", "pesq", "ssnr_regular",
                "ssnr_shift", "ssnr_clip", "ssnr_exsi", "overall_snr")
        data_info["denoise_statistics"] = OrderedDict(
            (f"avg_{k}", float(np.mean([item[k] for item in stat])))
            for k in keys)
    data_info["files"] = stat

    out_path = os.path.join(output_dir, f"eval_results{snr_suffix(snr)}.json")
    with open(out_path, "w") as fp:
        json.dump(data_info, fp, indent=4)
    return out_path
