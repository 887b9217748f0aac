"""Native (C++) host runtime: audio decode/resample/mix engine (port of
`sos_tpu/runtime/`)."""

from sos_tpu_torch.runtime.engine import (  # noqa: F401
    NativeAudioEngine,
    native_available,
    resampled_length,
)
