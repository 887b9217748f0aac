"""Utilities: meters, host helpers and the eval chain's plots (the port's
copies of `sos_tpu/utils/{meters,io,visualization}.py`)."""

from sos_tpu_torch.utils.io import cycle, ensure_dir  # noqa: F401
from sos_tpu_torch.utils.meters import AverageMeter, StepTimer  # noqa: F401
