"""Multi-process data parallelism over `torch.distributed` (port of
`sos_tpu/parallel/distributed.py`).

`sos_tpu` runs one JAX process per host over all of its chips and lets
XLA compile the gradient psum. The port follows PyTorch's idiom instead:
**one process per card**, each holding a full replica of the model and
training on its slice of the global batch; BatchNorm reduces its batch
statistics over the group (`models/layers.py`, sync-BN, as `sos_tpu`'s
statistics over the sharded global batch), and `reduce_gradients`
averages the gradients before every update. So `--num_processes` and
`--process_id` count processes, which means cards, not hosts.

Usage (each process):

    from sos_tpu_torch.parallel import distributed
    distributed.initialize(require=True)   # torchrun's environment
    device = distributed.local_device("cuda")
    batcher.shard(distributed.process_index(), distributed.process_count())
    ... fit(...) as usual: the train steps reduce over the group.

The group comes from torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`; `sos_tpu`'s TPU-pod
auto-detection) or from an explicit coordinator `host:port` with the
process count and this process's index (`tcp://host:port`). The backend
follows the device: NCCL for cards, gloo for the CPU. Nothing falls
back: a failed bring-up under `require` raises, and NCCL failing on a
card is an error, never a gloo run.

Gloo reduces CUDA tensors only with `all_reduce` and `broadcast`, so the
helpers here use nothing else; host flags travel as tensors on
`comm_device()`.
"""

from __future__ import annotations

import datetime
import importlib
import os
import socket
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# how long a collective may wait for the slowest process
TIMEOUT = datetime.timedelta(minutes=10)

_device: Optional[torch.device] = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               require: bool = False, device="cuda",
               backend: Optional[str] = None) -> None:
    """Join the process group. A no-op when already joined, or when no
    group is configured (no torchrun environment, no coordinator) and
    `require` is false.

    `require=True` (the CLIs' `--distributed`): a failed bring-up raises
    instead of training alone; every process would otherwise train the
    whole dataset and race on the checkpoint directory.

    `device`: "cuda" (one card a process: `LOCAL_RANK`, else the process
    index modulo the card count), a card ("cuda:k": every process on it)
    or "cpu". `backend` defaults to the device's, NCCL or gloo; a
    different one is an explicit choice of the caller."""
    global _device
    if is_initialized():
        return
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None and num_processes is None:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            if require:
                raise RuntimeError(
                    f"--distributed requested but the torchrun environment "
                    f"is missing {', '.join(missing)} (not started by "
                    f"torchrun?). Start every process with torchrun, or "
                    f"pass --coordinator host:port --num_processes N "
                    f"--process_id K explicitly, or use --num_devices N "
                    f"for the cards of one host, or drop --distributed "
                    f"for single-device training.")
            return
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("an explicit process group needs the "
                             "coordinator address, the process count and "
                             "this process's index")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} not in "
                             f"[0, {num_processes})")
        init_method = f"tcp://{coordinator_address}"
        rank, world = process_id, num_processes
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu for CPU processes (gloo)")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=TIMEOUT,
            device_id=dev if backend == "nccl" else None)
    except Exception as exc:
        raise RuntimeError(
            f"process group bring-up failed ({backend}, {init_method}, "
            f"rank {rank} of {world}): {exc}") from exc
    _device = dev


def local_device(device="cuda") -> torch.device:
    """The device this process trains on: the one `initialize` chose
    within a group, else `device` itself."""
    return _device if is_initialized() and _device is not None \
        else torch.device(device)


def comm_device() -> torch.device:
    """Where host values travel for a collective: the card under NCCL,
    the host under gloo."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_local_batch_size(global_batch: int) -> int:
    """This process's slice of the global batch (must divide evenly)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(
            f"process count {n} must divide the global batch "
            f"{global_batch} (pick batch_size as a multiple of {n})")
    return global_batch // n


def replicate(modules: Iterable[torch.nn.Module]) -> None:
    """Make every process hold process 0's parameters and buffers
    (a broadcast, in place). A no-op outside a group."""
    if process_count() == 1:
        return
    for module in modules:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def reduce_gradients(module: torch.nn.Module) -> None:
    """Average every parameter's gradient over the group, in place: one
    all-reduce of the gradients flattened into one buffer. With equal
    local batches the mean of the local gradients is the gradient of
    the global batch's mean loss. A no-op outside a group."""
    if not is_initialized():
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= process_count()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_over_processes(values: Dict[str, float],
                        keys: Sequence[str]) -> Dict[str, float]:
    """`values` with the entries named by `keys` averaged over the group
    (one all-reduce); the others as they are."""
    if not is_initialized():
        return values
    names = [k for k in keys if k in values]
    t = torch.tensor([float(values[k]) for k in names], dtype=torch.float64,
                     device=comm_device())
    dist.all_reduce(t)
    out = dict(values)
    for k, v in zip(names, (t / process_count()).tolist()):
        out[k] = v
    return out


def any_process(flag: bool) -> bool:
    """Whether `flag` is set on any process of the group."""
    if not is_initialized():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_float(value: float) -> float:
    """Process 0's `value` on every process."""
    if not is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.float64, device=comm_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (the end of a worker's run)."""
    global _device
    if is_initialized():
        dist.destroy_process_group()
    _device = None


def free_port() -> int:
    """A TCP port of 127.0.0.1 free at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_worker(index: int, module: str, argv: Sequence[str],
                  nprocs: int, port: int, threads: int) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(index), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    importlib.import_module(module).main(list(argv) + ["--distributed"])


def spawn_local(module: str, argv: Sequence[str], nprocs: int,
                cpu: bool = False) -> None:
    """Run `module.main(argv + ["--distributed"])` in `nprocs` fresh
    processes of this host, process k with torchrun's variables for rank
    k of `nprocs` (a free port on 127.0.0.1), and wait for all of them;
    raises when one fails. `cpu`: the processes split the host's
    threads."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // nprocs) if cpu else 0
    mp.start_processes(_local_worker,
                       args=(module, list(argv), nprocs, free_port(),
                             threads),
                       nprocs=nprocs, join=True, start_method="spawn")
