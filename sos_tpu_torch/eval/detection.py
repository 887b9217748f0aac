"""Per-frame silence-detection statistics.

The port's copy of `sos_tpu/eval/detection.py`.

Equivalent of the reference's `show_metrics` (m1 tools.py:91-197) with the
same conventions: the *silent* class (bit 0) is treated as positive (both
arrays are flipped before counting), `roc_auc` is balanced accuracy
((TPR+TNR)/2), and NaNs serialize as null. Key names/order match the
committed golden files (eval_results.json:5-24).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np


def _nan_to_none(x: float) -> Optional[float]:
    return None if (x is None or (isinstance(x, float) and np.isnan(x))) else x


def detection_statistics(y_true: Sequence[int], y_pred: Sequence[int]) -> OrderedDict:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    n = len(y_true)
    n_silent = int(np.sum(y_true == 0))
    n_voiced = int(np.sum(y_true == 1))

    base = float(np.sum(y_true == 1)) / n
    accuracy = float(np.sum(y_true == y_pred)) / n

    # silent (0) is the positive class
    t = 1 - y_true
    p = 1 - y_pred
    tp = int(np.sum(t * p))
    fp = int(np.sum((t == 0) * p))
    tn = int(np.sum((t == 0) * (p == 0)))
    fn = int(np.sum(t * (p == 0)))

    def _div(a, b):
        return float(a) / b if b else float("nan")

    tpr = _div(tp, tp + fn)
    fpr = _div(fp, fp + tn)
    precision = _div(tp, tp + fp) if (tp + fp) else 0.0
    tnr = 1.0 - fpr if not np.isnan(fpr) else float("nan")
    f1 = _div(2 * tp, 2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
    auc = (tpr + tnr) / 2 if not (np.isnan(tpr) or np.isnan(tnr)) else float("nan")
    denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    mcc = 0.0 if denom == 0 else float(tp * tn - fp * fn) / denom

    return OrderedDict([
        ("num_samples", n),
        ("num_silent_samples", n_silent),
        ("num_non_silent_samples", n_voiced),
        ("base", base),
        ("accuracy", accuracy),
        ("true_positive", tp),
        ("false_positive", fp),
        ("true_negative", tn),
        ("false_negative", fn),
        ("true_pos_rate(recall)", _nan_to_none(tpr)),
        ("false_pos_rate", _nan_to_none(fpr)),
        ("precision", _nan_to_none(precision)),
        ("true_neg_rate", _nan_to_none(tnr)),
        ("f1", _nan_to_none(f1)),
        ("roc_auc", _nan_to_none(auc)),
        ("mcc", _nan_to_none(mcc)),
    ])
