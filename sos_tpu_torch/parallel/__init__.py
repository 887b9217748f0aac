"""Data parallelism (port of `sos_tpu/parallel/`): training as one
process a card over `torch.distributed` (`distributed`), inference as
one replica a device in one process (`mesh`, used by
`FusedDenoisePipeline.shard`)."""

from sos_tpu_torch.parallel import distributed  # noqa: F401
from sos_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_batch,
    make_mesh,
    shard_batch,
)
