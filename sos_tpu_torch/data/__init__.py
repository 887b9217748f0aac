"""Data layer: the dataset-JSON index, bitstream windows, the noise bank
and the training pipelines (the port's copies of
`sos_tpu/data/{index,windows,sampling,pipeline,prefetch,media}.py`)."""

from sos_tpu_torch.data.index import DatasetIndex, FileRecord  # noqa: F401
from sos_tpu_torch.data.pipeline import (  # noqa: F401
    DenoiserBatcher,
    DetectorBatcher,
    device_mix_and_stft_denoiser,
    device_mix_and_stft_detector,
)
from sos_tpu_torch.data.sampling import NoiseBank  # noqa: F401
from sos_tpu_torch.data.windows import (  # noqa: F401
    denoiser_windows,
    detector_windows,
    subsample_windows,
)
