"""Devices and batch splitting of data parallelism in one process (port
of `sos_tpu/parallel/mesh.py`).

`sos_tpu` places a batch on a 1-D `data` mesh of chips, sharded along
dim 0, with the parameters replicated, and lets one SPMD program run on
every chip. The port's counterpart is a list of devices, one replica of
the model on each (`infer/fused.py` `FusedDenoisePipeline.shard`), and
helpers that split a batch over the list in order and concatenate the
results back. `make_mesh` and `shard_batch` keep `sos_tpu`'s names;
`sos_tpu`'s `batch_sharding` and `replicated` have no counterpart of
their own, since a device list is both the batch's placement and the
replicas'. Training across cards runs one process a card instead
(`parallel/distributed.py`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: the devices the batch dim is split over."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first `num_devices` of `devices` (default: every
    visible card)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


Batch = Union[torch.Tensor, np.ndarray, Mapping]


def split_sizes(batch_size: int, parts: int) -> List[int]:
    """Equal slices of a batch dim; the size must divide evenly, as
    `sos_tpu`'s batch-sharded arrays require."""
    if batch_size % parts:
        raise ValueError(f"batch {batch_size} must divide the mesh size "
                         f"{parts} (pick a multiple of {parts})")
    return [batch_size // parts] * parts


def shard_batch(batch: Batch, mesh: Mesh) -> List[Batch]:
    """Split `batch` (a tensor, an array, or a dict of them) along dim 0
    into one slice a device, in order, each moved to its device."""
    if isinstance(batch, Mapping):
        parts = [shard_batch(v, mesh) for v in batch.values()]
        return [dict(zip(batch.keys(), vals)) for vals in zip(*parts)]
    t = torch.as_tensor(batch)
    sizes = split_sizes(t.shape[0], mesh.size)
    return [piece.to(dev) for piece, dev in
            zip(torch.split(t, sizes), mesh.devices)]


def gather_batch(pieces: Sequence[torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    """The slices' results, concatenated along dim 0 on `device`."""
    return torch.cat([p.to(device) for p in pieces])
