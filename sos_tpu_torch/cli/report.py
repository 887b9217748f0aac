"""Aggregate per-SNR eval results into metric-vs-SNR plots and a table,
and render training curves from the fit() metrics log.

Usage:
    python -m sos_tpu_torch report --results_dir outputs/ [--plot report.png]
    python -m sos_tpu_torch report --quality quality.json --html report.html
    python -m sos_tpu_torch report --train_log <log_dir> \
        [--train_plot curves.png]
    python -m sos_tpu_torch report --results_dir outputs/ \
        --train_log <log_dir> --html report.html

The port's copy of `sos_tpu/cli/report.py`, with its flags, tables and
HTML; host work over the port's `eval_results_snr*.json`
(`predict_detector`, `predict_denoiser`), `eval_synthetic --out` JSONs
and `fit`'s `metrics.jsonl`. matplotlib is needed only for `--plot`,
`--train_plot` and `--html`.

`--results_dir` renders BOTH stages from eval_results_snr*.json files:
denoise metrics when present ('denoise_statistics') and the stage-1
silence-detection table (accuracy/precision/recall/F1/ROC-AUC/MCC vs
input SNR from 'prediction_statistics', the reference show_metrics
set). `--quality` accepts an `eval_synthetic --out` JSON and renders
the same denoise-vs-SNR section plus the unprocessed noisy-input
baseline rows/curves when it carries them.

Equivalent of model_2 `draw_agg_stats.py` (:10-127) for the per-SNR
table/plots; the training-curve view renders the durable
`metrics.jsonl` written by train/fit.py (train/val loss, steps/sec,
epoch validation metrics) — the dashboard the reference only had via a
live tensorboard process. `--html` bundles every requested section
(per-SNR table+plot, training summary+curves, profile deltas) into ONE
self-contained file (plots embedded as base64 PNGs, numeric tables
alongside every chart) that can be archived with the experiment or
attached to a report.
"""

import argparse
import glob
import html as _html
import json
import os
import re
from collections import OrderedDict

METRIC_KEYS = ("avg_l1", "avg_stoi", "avg_csig", "avg_cbak", "avg_covl",
               "avg_pesq", "avg_ssnr_regular", "avg_ssnr_shift",
               "avg_ssnr_clip", "avg_ssnr_exsi", "avg_overall_snr")

# Paul Tol's published colorblind-safe "bright" hues; train/val are
# additionally separated by linestyle so identity never rides on color
# alone. Single-series panels always use the first hue (color follows
# the entity, not the panel).
_C_TRAIN = "#4477AA"
_C_VAL = "#EE6677"

# metrics whose values depend on the P.862 backend (csig/cbak/covl are
# MOS regressions over the raw PESQ score, reference metrics.py:346-401)
_PESQ_DERIVED = ("avg_pesq", "avg_csig", "avg_cbak", "avg_covl")


def _pesq_caveat(keys) -> str:
    """Non-empty when PESQ-derived columns were produced by the native
    (non-certified) backend — every report that shows them must say so."""
    if not any(k in _PESQ_DERIVED for k in keys):
        return ""
    from sos_tpu_torch.eval.speech import pesq_backend

    if pesq_backend() != "native":
        return ""
    return ("pesq (and csig/cbak/covl, which regress on it) computed by "
            "the native P.862 implementation — reconstructed Bark-band "
            "tables, NOT certified ITU-conformant; comparable within "
            "this tool, quantify vs a conformant backend with "
            "`python -m sos_tpu_torch.eval.pesq_conformance` (docs/PARITY.md)")


def _scan_results(results_dir: str):
    """One pass over eval_results*snr*.json: yields (snr, payload).

    The per-record 'data' payloads make these files large; every
    consumer shares this single read/parse."""
    for path in glob.glob(os.path.join(results_dir, "eval_results*snr*.json")):
        m = re.search(r"_snr(-?[0-9_]+)\.json$", path)
        if not m:
            continue
        snr = float(m.group(1).replace("_", "."))
        with open(path) as fp:
            yield snr, json.load(fp)


def collect_all(results_dir: str):
    """(denoise_table, detection_table), each snr-sorted, parsing every
    results file exactly once."""
    denoise, detect = {}, {}
    for snr, payload in _scan_results(results_dir):
        stats = payload.get("denoise_statistics")
        if stats:
            denoise[snr] = stats
        dstats = (payload.get("prediction_statistics") or {}).get("all")
        if dstats:
            detect[snr] = dstats
    return (OrderedDict(sorted(denoise.items())),
            OrderedDict(sorted(detect.items())))


def collect(results_dir: str) -> "OrderedDict[float, dict]":
    return collect_all(results_dir)[0]


# stage-1 quality columns, in reference show_metrics order
# (m1 predict.py prediction_statistics; 'base' = majority-class floor)
DETECT_KEYS = ("base", "accuracy", "precision", "true_pos_rate(recall)",
               "f1", "roc_auc", "mcc")


def collect_detection(results_dir: str) -> "OrderedDict[float, dict]":
    """Per-SNR detector quality from predict_detector's
    eval_results_snr*.json ('prediction_statistics'/'all' — the files
    collect() skips because they carry no denoise stats)."""
    return collect_all(results_dir)[1]


def load_quality(path: str) -> "OrderedDict[float, dict]":
    """An `eval_synthetic --out` JSON ({'snr_N': {avg_*...}}) as a
    collect()-shaped table, so every denoise-vs-SNR renderer accepts
    either source. `noisy_avg_*` baseline columns pass through."""
    with open(path) as fp:
        payload = json.load(fp)
    out = {}
    for key, stats in payload.items():
        if key.startswith("snr_"):
            out[float(key[4:])] = stats
    return OrderedDict(sorted(out.items()))


def load_train_log(path: str):
    """path: a metrics.jsonl file or the log dir containing it.

    The log is append-mode across crash-resumes, so replayed steps can
    appear twice (pre-crash rows, then the resumed run's rows): keep the
    LAST row per (kind, step/epoch) and return in step order."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    latest = {}
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            key = (r["kind"],
                   r["epoch"] if r["kind"] == "epoch" else r["step"])
            latest[key] = r
    return sorted(latest.values(),
                  key=lambda r: (r["step"], r["epoch"], r["kind"]))


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _metric_lower_is_better(key: str) -> bool:
    return any(t in key for t in ("loss", "stage", "l1", "wss", "llr"))


def train_summary(rows):
    """Digest the metrics log into printable/renderable tables:
    (last_train_row_items, epoch_rows, best_per_epoch_metric)."""
    by_kind = {}
    for r in rows:
        by_kind.setdefault(r["kind"], []).append(r)
    train = by_kind.get("train", [])
    epochs = by_kind.get("epoch", [])
    skip = ("kind", "step", "epoch", "ckpt_epoch")
    best = []
    if epochs:
        keys = [k for k in epochs[-1] if k not in skip]
        for key in keys:
            lower = _metric_lower_is_better(key)
            series = [(r, r[key]) for r in epochs if key in r]
            best_r, best_v = (min if lower else max)(series,
                                                     key=lambda t: t[1])
            best.append({"metric": f"epoch_{key}",
                         "which": "min" if lower else "max",
                         "value": best_v, "epoch": best_r["epoch"],
                         "ckpt_epoch": best_r.get("ckpt_epoch")})
    return by_kind, best


def train_curves_figure(by_kind):
    plt = _plt()
    train = by_kind.get("train", [])
    val = by_kind.get("val", [])
    epochs = by_kind.get("epoch", [])
    metric_keys = []
    for r in train + val:
        for k in r:
            if k not in ("kind", "step", "epoch") and k not in metric_keys:
                metric_keys.append(k)
    epoch_keys = []
    for r in epochs:
        for k in r:
            if (k not in ("kind", "step", "epoch", "ckpt_epoch")
                    and k not in epoch_keys):
                epoch_keys.append(k)
    n = len(metric_keys) + len(epoch_keys)
    cols = 3
    rows_n = max(1, -(-n // cols))
    fig, axes = plt.subplots(rows_n, cols, figsize=(4 * cols, 3 * rows_n),
                             squeeze=False)
    flat = axes.flat
    for i, key in enumerate(metric_keys):
        ax = flat[i]
        plotted = 0
        for kind, series, style, color in (
                ("train", train, "-", _C_TRAIN),
                ("val", val, "--", _C_VAL)):
            pts = [(r["step"], r[key]) for r in series if key in r]
            if pts:
                # short series would be invisible as a bare line (a
                # single point has no segment): add markers until the
                # line carries the shape on its own
                marker = "o" if len(pts) < 25 else None
                ax.plot(*zip(*pts), style, color=color, label=kind,
                        alpha=0.85, linewidth=1.6, marker=marker,
                        markersize=4)
                plotted += 1
        ax.set_title(key)
        ax.set_xlabel("step")
        if plotted > 1:  # a single series is named by the title
            ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    for j, key in enumerate(epoch_keys):
        ax = flat[len(metric_keys) + j]
        pts = [(r["epoch"], r[key]) for r in epochs if key in r]
        ax.plot(*zip(*pts), marker="o", color=_C_TRAIN, linewidth=1.6)
        ax.set_title(f"epoch {key}")
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    for ax in list(flat)[n:]:
        ax.axis("off")
    fig.tight_layout()
    return fig


def snr_figure(table, keys):
    plt = _plt()
    n = len(keys)
    cols = 3
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    snrs = list(table.keys())
    has_noisy = any(f"noisy_{k}" in table[s] for k in keys for s in snrs)
    for ax, key in zip(axes.flat, keys):
        ax.plot(snrs, [table[s].get(key) for s in snrs], marker="o",
                color=_C_TRAIN, linewidth=1.6,
                label="denoised" if has_noisy else None)
        noisy = [table[s].get(f"noisy_{key}") for s in snrs]
        if any(v is not None for v in noisy):
            ax.plot(snrs, noisy, marker="o", linestyle="--",
                    color=_C_VAL, linewidth=1.6, label="noisy input")
            ax.legend(fontsize=7)
        ax.set_title(key.replace("avg_", ""))
        ax.set_xlabel("input SNR (dB)")
        ax.grid(alpha=0.3)
    for ax in list(axes.flat)[n:]:
        ax.axis("off")
    fig.tight_layout()
    return fig


def detection_figure(table):
    plt = _plt()
    keys = [k for k in DETECT_KEYS
            if k != "base" and k in next(iter(table.values()))]
    cols = 3
    rows = -(-len(keys) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    snrs = list(table.keys())
    for ax, key in zip(axes.flat, keys):
        ax.plot(snrs, [table[s].get(key) for s in snrs], marker="o",
                color=_C_TRAIN, linewidth=1.6)
        if key == "accuracy":  # majority-class floor contextualizes it
            base = [table[s].get("base") for s in snrs]
            if any(v is not None for v in base):
                ax.plot(snrs, base, marker="o", linestyle="--",
                        color=_C_VAL, linewidth=1.6, label="base rate")
                ax.legend(fontsize=7)
        ax.set_title(key)
        ax.set_xlabel("input SNR (dB)")
        ax.grid(alpha=0.3)
    for ax in list(axes.flat)[len(keys):]:
        ax.axis("off")
    fig.tight_layout()
    return fig


def train_report(rows, plot_path=None) -> None:
    by_kind, best = train_summary(rows)
    train = by_kind.get("train", [])
    epochs = by_kind.get("epoch", [])
    if train:
        last = train[-1]
        keys = [k for k in last if k not in ("kind", "step", "epoch")]
        print(f"train: {len(train)} logged steps, last step {last['step']}: "
              + " ".join(f"{k}={last[k]:.5g}" for k in keys))
    if epochs:
        skip = ("kind", "step", "epoch", "ckpt_epoch")
        last = epochs[-1]
        keys = [k for k in last if k not in skip]
        print(f"epoch {last['epoch']}: "
              + " ".join(f"{k}={last[k]:.5g}" for k in keys))
        for b in best:
            ck_s = (f" (ckpt_epoch{b['ckpt_epoch']})"
                    if b["ckpt_epoch"] is not None else "")
            print(f"  best({b['which']}) {b['metric']}: {b['value']:.5g} "
                  f"@ epoch {b['epoch']}{ck_s}")
    if plot_path:
        fig = train_curves_figure(by_kind)
        fig.savefig(plot_path, dpi=120)
        print(f"wrote {plot_path}")


def load_compare(path_a: str, path_b: str):
    """Per-SNR metric deltas between two eval JSONs (e.g. the f32 and
    int8 outputs of `cli.eval_synthetic --out`): certifies a serving
    profile's quality cost. Returns (rows, snrs_only_in_one)."""
    with open(path_a) as fp:
        a = json.load(fp)
    with open(path_b) as fp:
        b = json.load(fp)
    rows = []
    for snr_key in sorted(set(a) & set(b),
                          key=lambda k: float(k.split("_", 1)[1])):
        keys = [k for k in a[snr_key]
                if k.startswith("avg_") and k in b[snr_key]]
        rows.append((snr_key, [(k, b[snr_key][k] - a[snr_key][k])
                               for k in keys]))
    only = sorted((set(a) | set(b)) - (set(a) & set(b)))
    return rows, only


def compare_evals(path_a: str, path_b: str, loaded=None) -> None:
    rows, only = loaded if loaded is not None else load_compare(path_a, path_b)
    print(f"delta = {os.path.basename(path_b)} - {os.path.basename(path_a)}")
    for snr_key, deltas in rows:
        print(f"{snr_key}: " + " ".join(
            f"{k.replace('avg_', '')}{d:+.4f}" for k, d in deltas))
    if only:
        print(f"(SNRs present in only one file: {only})")


# -- self-contained HTML dashboard ---------------------------------------

_HTML_CSS = """
body { font: 14px/1.5 system-ui, sans-serif; color: #222; margin: 2em auto;
       max-width: 1280px; padding: 0 1em; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 2em; }
table { border-collapse: collapse; margin: 0.8em 0; }
th, td { border: 1px solid #ccc; padding: 3px 9px; text-align: right;
         font-variant-numeric: tabular-nums; }
th { background: #f2f2f2; text-align: center; }
td.l, th.l { text-align: left; }
img { max-width: 100%; border: 1px solid #eee; margin: 0.5em 0; }
.meta { color: #666; font-size: 0.9em; }
"""


def _fig_b64(fig) -> str:
    import base64
    import io

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _table_html(header, rows):
    e = _html.escape
    out = ["<table><tr>"]
    out += [f'<th class="l">{e(str(header[0]))}</th>']
    out += [f"<th>{e(str(h))}</th>" for h in header[1:]]
    out.append("</tr>")
    for row in rows:
        out.append("<tr>" + f'<td class="l">{e(str(row[0]))}</td>' + "".join(
            f"<td>{e(str(c))}</td>" for c in row[1:]) + "</tr>")
    out.append("</table>")
    return "".join(out)


def html_report(out_path, snr_table=None, train_rows=None, compare=None,
                detect_table=None, sources=None) -> None:
    """Write one self-contained HTML file with every requested section;
    each chart is paired with its numeric table (the table IS the
    accessible/table view of the chart, not an extra)."""
    e = _html.escape
    parts = ["<!doctype html><html><head><meta charset='utf-8'>"
             "<title>sos_tpu report</title>"
             f"<style>{_HTML_CSS}</style></head><body>",
             "<h1>sos_tpu experiment report</h1>"]
    if sources:
        parts.append("<p class='meta'>" + "<br>".join(
            f"{e(k)}: <code>{e(str(v))}</code>" for k, v in sources.items())
            + "</p>")

    if detect_table:
        keys = [k for k in DETECT_KEYS
                if k in next(iter(detect_table.values()))]
        parts.append("<h2>Silence detection quality vs input SNR "
                     "(stage 1)</h2>")
        parts.append(_table_html(
            ["snr_db"] + list(keys),
            [[f"{snr:+.0f}"] + [f"{stats.get(k, float('nan')):.4f}"
                                for k in keys]
             for snr, stats in detect_table.items()]))
        fig = detection_figure(detect_table)
        parts.append(f'<img alt="detection-metric-vs-SNR curves" '
                     f'src="data:image/png;base64,{_fig_b64(fig)}">')

    if snr_table:
        keys = [k for k in METRIC_KEYS if k in next(iter(snr_table.values()))]
        parts.append("<h2>Denoising quality vs input SNR</h2>")
        parts.append(_table_html(
            ["snr_db"] + [k.replace("avg_", "") for k in keys],
            [[f"{snr:+.0f}"] + [f"{stats.get(k, float('nan')):.4f}"
                                for k in keys]
             for snr, stats in snr_table.items()]))
        noisy_keys = [k for k in keys if any(
            f"noisy_{k}" in s for s in snr_table.values())]
        if noisy_keys:
            parts.append("<p class='meta'>unprocessed noisy-input "
                         "baseline (same clips and metrics):</p>")
            parts.append(_table_html(
                ["snr_db"] + [k.replace("avg_", "") for k in noisy_keys],
                [[f"{snr:+.0f}"]
                 + [f"{stats.get(f'noisy_{k}', float('nan')):.4f}"
                    for k in noisy_keys]
                 for snr, stats in snr_table.items()]))
        fig = snr_figure(snr_table, keys)
        parts.append(f'<img alt="metric-vs-SNR curves" '
                     f'src="data:image/png;base64,{_fig_b64(fig)}">')
        caveat = _pesq_caveat(keys)
        if caveat:
            parts.append(f"<p class='meta'>&#9888; {e(caveat)}</p>")

    if train_rows:
        by_kind, best = train_summary(train_rows)
        parts.append("<h2>Training</h2>")
        train = by_kind.get("train", [])
        epochs = by_kind.get("epoch", [])
        if train:
            last = train[-1]
            keys = [k for k in last if k not in ("kind", "step", "epoch")]
            parts.append(f"<p>{len(train)} logged steps; last step "
                         f"{last['step']}: " + ", ".join(
                             f"{e(k)}={last[k]:.5g}" for k in keys) + "</p>")
        if best:
            parts.append(_table_html(
                ["best epoch metric", "value", "epoch", "checkpoint"],
                [[f"{b['which']} {b['metric']}", f"{b['value']:.5g}",
                  b["epoch"],
                  (f"ckpt_epoch{b['ckpt_epoch']}"
                   if b["ckpt_epoch"] is not None else "—")] for b in best]))
        if train or by_kind.get("val") or epochs:
            fig = train_curves_figure(by_kind)
            parts.append(f'<img alt="training curves" '
                         f'src="data:image/png;base64,{_fig_b64(fig)}">')

    if compare:
        rows, only = compare
        parts.append("<h2>Profile comparison (metric deltas)</h2>")
        if rows:
            # Column set = union over rows: SNR entries sharing only a
            # subset of metrics must not shift their cells under the
            # first row's header.
            keys = []
            for _, deltas in rows:
                keys.extend(k for k, _ in deltas if k not in keys)
            by_key = [(snr_key, dict(deltas)) for snr_key, deltas in rows]
            parts.append(_table_html(
                ["snr"] + [k.replace("avg_", "") for k in keys],
                [[snr_key] + [f"{d[k]:+.4f}" if k in d else "—"
                              for k in keys]
                 for snr_key, d in by_key]))
        if only:
            parts.append(f"<p class='meta'>SNRs present in only one file: "
                         f"{e(str(only))}</p>")

    parts.append("</body></html>")
    with open(out_path, "w") as fp:
        fp.write("".join(parts))
    print(f"wrote {out_path}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--results_dir", type=str, default=None)
    parser.add_argument("--plot", type=str, default=None)
    parser.add_argument("--train_log", type=str, default=None,
                        help="metrics.jsonl (or its log dir) from training")
    parser.add_argument("--train_plot", type=str, default=None)
    parser.add_argument("--compare", type=str, nargs=2, default=None,
                        metavar=("BASE.json", "OTHER.json"),
                        help="print per-SNR metric deltas between two "
                             "eval_synthetic --out files (profile "
                             "certification)")
    parser.add_argument("--html", type=str, default=None,
                        help="bundle every requested section into one "
                             "self-contained HTML dashboard")
    parser.add_argument("--quality", type=str, default=None,
                        help="an `eval_synthetic --out` JSON; renders "
                             "the same denoise-vs-SNR section (plus the "
                             "noisy-input baseline when present)")
    args = parser.parse_args()
    if not (args.results_dir or args.train_log or args.compare
            or args.quality):
        parser.error("need --results_dir, --quality, --train_log "
                     "and/or --compare")

    train_rows = load_train_log(args.train_log) if args.train_log else None
    compare_data = load_compare(*args.compare) if args.compare else None
    if args.compare:
        compare_evals(*args.compare, loaded=compare_data)
    if train_rows is not None:
        train_report(train_rows, args.train_plot)

    table = None
    detect_table = None
    if args.results_dir:
        table, detect_table = collect_all(args.results_dir)
        if not table and not detect_table:
            print("no eval_results_snr*.json files found")
    if args.quality:
        qtable = load_quality(args.quality)
        if table:
            # both sources present: results_dir wins for overlapping
            # SNRs (it is the richer per-record artifact)
            qtable.update(table)
        table = OrderedDict(sorted(qtable.items()))

    # Column sets are the UNION across rows, not the first row's keys:
    # --quality rows merged with results_dir rows can carry different
    # metric subsets, and a column present only in later rows must not
    # silently vanish from the table.
    if detect_table:
        keys = [k for k in DETECT_KEYS
                if any(k in s for s in detect_table.values())]
        print("detection: snr_db " + " ".join(keys))
        for snr, stats in detect_table.items():
            print(f"{snr:+.0f} " + " ".join(
                f"{stats.get(k, float('nan')):.4f}" for k in keys))
    if table:
        keys = [k for k in METRIC_KEYS
                if any(k in s for s in table.values())]
        print("snr_db " + " ".join(k.replace("avg_", "") for k in keys))
        for snr, stats in table.items():
            print(f"{snr:+.0f} " + " ".join(
                f"{stats.get(k, float('nan')):.4f}" for k in keys))
        caveat = _pesq_caveat(keys)
        if caveat:
            print(f"note: {caveat}")
        if args.plot:
            snr_figure(table, keys).savefig(args.plot, dpi=120)
            print(f"wrote {args.plot}")

    if args.html:
        sources = {}
        if args.results_dir:
            sources["results_dir"] = args.results_dir
        if args.quality:
            sources["quality"] = args.quality
        if args.train_log:
            sources["train_log"] = args.train_log
        if args.compare:
            sources["compare"] = f"{args.compare[1]} - {args.compare[0]}"
        html_report(args.html, snr_table=table or None,
                    train_rows=train_rows,
                    compare=compare_data,
                    detect_table=detect_table or None,
                    sources=sources)


if __name__ == "__main__":
    main()
