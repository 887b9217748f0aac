"""Inference: the fused two-stage pipeline and long-form streaming
(ports of `sos_tpu/infer/fused.py` and `sos_tpu/infer/streaming.py`)."""

from sos_tpu_torch.infer.fused import FusedDenoisePipeline  # noqa: F401
from sos_tpu_torch.infer.streaming import (  # noqa: F401
    StreamingDenoiser,
    StreamingSession,
)
