"""Multi-process (multi-host) helpers on ``torch.distributed``.

Counterpart of ``aero_tpu/parallel/multihost.py`` (read its docstring for
the two deployment shapes: a station per host, or one very wide stream
time-sharded over every host).  ``jax.distributed`` becomes a
``torch.distributed`` process group, and a global mesh is this process's
shards times the processes (``parallel/mesh.py``).

The caller names the backend, and nothing falls back from one to the
other:

- ``nccl``: each process has its own card, and halos and gathers move
  between the cards (NCCL refuses two processes on one card);
- ``gloo``: compute stays on each process's device (a card or the CPU),
  and what crosses between processes is copied through host memory
  explicitly, because gloo sends no CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.parallel.mesh import Mesh, gather, shard_over_vfo


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str):
    """Join the process group (call once per process, before any mesh
    that spans processes).  ``coordinator``: "host:port" that every
    process reaches; ``backend``: "nccl" or "gloo"."""
    import torch.distributed as dist
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _group():
    """(process count, this process's index, backend) of the group, or
    (1, 0, None) outside one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def make_global_mesh(vfo_per_host: bool = True, local_devices=None) -> Mesh:
    """The mesh over every process's devices.

    ``local_devices``: this process's shards (the same number in every
    process); by default one, the card ``cuda:(rank % visible cards)``.
    vfo_per_host=True with several processes -> ("host", "vfo"): VFO
    banks sharded within each process, processes independent.  Otherwise
    ("time",): one stream time-sharded over all of them, in process
    order."""
    n, rank, backend = _group()
    if local_devices is None:
        resolve_device("cuda")
        local_devices = [torch.device("cuda",
                                      rank % torch.cuda.device_count())]
    if vfo_per_host and n > 1:
        return Mesh(local_devices, ("host", "vfo"), n, rank, backend)
    return Mesh(local_devices, ("time",), n, rank, backend)


def host_local_slice(n_total_vfos: int) -> slice:
    """Which VFO indices this process owns under station-per-host."""
    n, i, _ = _group()
    per = -(-n_total_vfos // n)
    return slice(i * per, min((i + 1) * per, n_total_vfos))


def scatter_time_shards(mesh: Mesh, local_block, axis: str = "time") -> list:
    """This process's contiguous slice of the wideband stream, cut into
    its shards of the globally time-sharded block (each process passes
    its own slice, in process order; no process holds the whole stream).
    The result feeds the time-sharded functions of
    ``parallel/time_shard.py``."""
    return shard_over_vfo(Mesh(mesh.devices, (axis,)),
                          torch.as_tensor(np.ascontiguousarray(local_block)),
                          axis)


def gather_to_hosts(mesh: Mesh, shards, dim: int = 0,
                    axis: str = "time") -> np.ndarray:
    """A sharded tensor replicated onto every process as numpy
    (``all_gather`` across processes, then the join): the egress step for
    small results.  Large streams stay sharded."""
    return gather(mesh, shards, dim, axis).cpu().numpy()
