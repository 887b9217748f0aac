"""Data layer of the eval chain: the dataset-JSON index, bitstream
windows and the noise bank (the port's copies of
`sos_tpu/data/{index,windows,sampling}.py`; the training pipelines come
with the training slice)."""

from sos_tpu_torch.data.index import DatasetIndex, FileRecord  # noqa: F401
from sos_tpu_torch.data.sampling import NoiseBank  # noqa: F401
from sos_tpu_torch.data.windows import (  # noqa: F401
    denoiser_windows,
    detector_windows,
    subsample_windows,
)
