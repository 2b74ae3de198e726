"""Multi-process set-up on torch.distributed, ported from
km_tpu/parallel/distributed.py.

A run over several processes is started by torchrun (``python -m
torch.distributed.run``), which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT for every process; :func:`initialize` reads
them and opens the default process group. Without them it does nothing:
one process is the default, as km_tpu's single-host no-op.

Unlike km_tpu, which reads any RuntimeError on its implicit path as
"already live" and carries on (km_tpu/parallel/distributed.py:47-60),
every failure to open the group raises.

The backend follows the device: NCCL for ``cuda`` (one card per process,
``cuda:LOCAL_RANK``), gloo for ``cpu`` and ``host``.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
BACKEND = {"cuda": "nccl", "cpu": "gloo"}
# the mesh's dimension names (parallel/__init__.py)
READS_AXIS, SHARD_AXIS = "reads", "shard"


def _kind(device) -> str:
    return "cpu" if device == "host" else resolve_device(device).type


def initialize(device: str = "cuda") -> bool:
    """Open the default process group from torchrun's environment;
    returns True when this call opened it.

    No torchrun variable set, or a group already live: nothing to do
    (False). Some set but not all: raises. For ``cuda`` the process
    first takes card LOCAL_RANK."""
    if dist.is_initialized():
        return False
    present = [v for v in TORCHRUN_ENV if v in os.environ]
    if not present:
        return False
    if len(present) < len(TORCHRUN_ENV):
        raise RuntimeError(
            "incomplete torchrun environment: %s set, %s missing"
            % (present, sorted(set(TORCHRUN_ENV) - set(present))))
    kind = _kind(device)
    if kind == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(BACKEND[kind], init_method="env://")
    return True


@contextlib.contextmanager
def session(device: str = "cuda"):
    """:func:`initialize` for the length of a command; the group is
    destroyed at the end if this opened it."""
    opened = initialize(device)
    try:
        yield
    finally:
        if opened:
            dist.destroy_process_group()


def local_device(kind: str) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for 'cuda' (raises
    without such a card), else the CPU."""
    if _kind(kind) == "cuda":
        return resolve_device("cuda:%d" % int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def group_size_rank(group=None) -> tuple[int, int]:
    """(size, rank in the group) of a live group; raises when no process
    group is live."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is live: run under torchrun "
                           "and call initialize(), or init_process_group")
    return dist.get_world_size(group), dist.get_rank(group)


def check_backend(group, device: torch.device) -> None:
    """Raise unless ``group``'s backend carries tensors on ``device``
    (NCCL takes CUDA tensors, gloo CPU ones)."""
    want = BACKEND[device.type]
    got = dist.get_backend(group)
    if want not in got:
        raise ValueError("a %s process group cannot carry %s tensors; "
                         "it needs %s" % (got, device.type, want))


def global_mesh(device: str, reads: int | None = None):
    """A DeviceMesh over every process of the world group: 1-D
    (SHARD_AXIS,), or with ``reads`` a 2-D (READS_AXIS, SHARD_AXIS) mesh,
    data-parallel over ``reads`` rows and the table sharded over the
    rest, as pipeline_step takes it."""
    from torch.distributed.device_mesh import init_device_mesh

    n, _ = group_size_rank()
    kind = _kind(device)
    if reads is None:
        return init_device_mesh(kind, (n,), mesh_dim_names=(SHARD_AXIS,))
    if n % reads:
        raise ValueError("%d processes do not split into %d read groups"
                         % (n, reads))
    return init_device_mesh(kind, (reads, n // reads),
                            mesh_dim_names=(READS_AXIS, SHARD_AXIS))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_read_shards(paths: list[str]) -> list[str]:
    """Process i of P takes paths i, i+P, i+2P, ... (the reference's
    per-sample shell fan-out, across processes)."""
    return list(paths)[process_index()::process_count()]
