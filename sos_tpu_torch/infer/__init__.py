"""Inference: the fused two-stage pipeline, long-form streaming, and
the full-utterance predictors and the eval chain (ports of
`sos_tpu/infer/{fused,streaming,detect,denoise,evaluate,export}.py`)."""

from sos_tpu_torch.infer.denoise import DenoiserPredictor  # noqa: F401
from sos_tpu_torch.infer.detect import DetectorPredictor  # noqa: F401
from sos_tpu_torch.infer.fused import FusedDenoisePipeline  # noqa: F401
from sos_tpu_torch.infer.streaming import (  # noqa: F401
    StreamingDenoiser,
    StreamingSession,
)
