"""The port's `report` CLI against `sos_tpu`'s on the same fixtures: eval
JSONs at 3 SNRs (denoise and detection statistics), an `eval_synthetic
--out` quality JSON with its noisy baseline, a `metrics.jsonl` and a
`--compare` pair. One run of each CLI with every flag: the standard
output and the numbers in the HTML tables must be equal (the module name
in the PESQ caveat aside), and the caveat appears where `sos_tpu`'s
does."""

import json
import re
import sys

import numpy as np
import pytest

from sos_tpu.cli import report as jax_report
from sos_tpu_torch import __main__ as dispatcher
from sos_tpu_torch.cli import report

SNRS = (-5, 0, 5)


def _stats(rng, prefix=""):
    return {f"{prefix}{k}": float(rng.uniform(0.1, 3.0))
            for k in report.METRIC_KEYS}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("report")
    rng = np.random.default_rng(9)
    (root / "results").mkdir()
    for snr in SNRS:
        detect = {k: float(rng.uniform(0.5, 1.0)) for k in report.DETECT_KEYS}
        (root / "results" / f"eval_results_snr{snr}.json").write_text(
            json.dumps({"denoise_statistics": _stats(rng),
                        "prediction_statistics": {"all": detect},
                        "data": [{"name": "x"}]}))
    (root / "quality.json").write_text(json.dumps(
        {f"snr_{s}": {**_stats(rng), **_stats(rng, "noisy_")}
         for s in SNRS + (10,)}))
    for name in ("f32.json", "int8.json"):
        (root / name).write_text(json.dumps(
            {f"snr_{s}": _stats(rng) for s in SNRS[:2 + (name == "f32.json")]}))
    rows = []
    for step in range(0, 40, 10):
        rows.append({"kind": "train", "step": step, "epoch": step // 20,
                     "loss": 1.0 / (step + 1), "steps_per_sec": 3.5})
        rows.append({"kind": "val", "step": step, "epoch": step // 20,
                     "loss": 1.2 / (step + 1)})
    rows += [{"kind": "epoch", "step": 20 * e, "epoch": e,
              "loss": 0.5 - 0.1 * e, "ckpt_epoch": e + 1} for e in range(2)]
    rows.append(dict(rows[0], loss=9.0))  # a replayed step: the last wins
    (root / "log").mkdir()
    (root / "log" / "metrics.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\n")
    return root


def _run(main, root, html, capsys):
    saved = sys.argv
    sys.argv = ["report", "--results_dir", str(root / "results"),
                "--quality", str(root / "quality.json"),
                "--train_log", str(root / "log"),
                "--compare", str(root / "f32.json"), str(root / "int8.json"),
                "--html", str(root / html)]
    try:
        main()
    finally:
        sys.argv = saved
    out = capsys.readouterr().out.replace(str(root / html), "REPORT")
    return out.replace("sos_tpu_torch.", "sos_tpu.")


def _cells(html: str):
    return re.findall(r"<t[dh][^>]*>([^<]*)</t[dh]>", html)


def test_report_matches_sos_tpu(fixtures, capsys, monkeypatch):
    # sos_tpu's figures are not compared: it skips encoding them
    monkeypatch.setattr(jax_report, "_fig_b64", lambda fig: "")
    ref = _run(jax_report.main, fixtures, "jax.html", capsys)
    got = _run(lambda: dispatcher.main(["report"] + sys.argv[1:]), fixtures,
               "port.html", capsys)
    assert got == ref
    assert "detection: snr_db" in got and "snr_db l1 stoi" in got
    assert ("note: pesq" in got) == ("note: pesq" in ref)
    ref_html = (fixtures / "jax.html").read_text()
    got_html = (fixtures / "port.html").read_text()
    assert _cells(got_html) == _cells(ref_html)
    assert len(_cells(got_html)) > 100
    assert ("NOT certified" in got_html) == ("NOT certified" in ref_html)
    assert got_html.count("data:image/png;base64,") == 3


def test_report_needs_an_input(capsys):
    saved = sys.argv
    sys.argv = ["report"]
    try:
        with pytest.raises(SystemExit) as exc:
            report.main()
    finally:
        sys.argv = saved
    assert exc.value.code == 2
    assert "need --results_dir" in capsys.readouterr().err
