"""Evaluation suite: detection statistics and speech-quality metrics
(the port's copy of `sos_tpu/eval`, numpy and scipy only, with the
PESQ conformance corpus `pesq_conformance`)."""

from sos_tpu_torch.eval.detection import detection_statistics  # noqa: F401
from sos_tpu_torch.eval.speech import composite_eval, evaluate_metrics  # noqa: F401
from sos_tpu_torch.eval.stoi import stoi  # noqa: F401
