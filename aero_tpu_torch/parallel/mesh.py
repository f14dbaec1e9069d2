"""Device meshes and sharding over a leading row axis (torch).

Counterpart of ``aero_tpu/parallel/mesh.py``.  A JAX ``Mesh`` is one
controller over several devices, and XLA partitions one program over
them.  Here a ``Mesh`` names axes over a list of ``torch.device``s, and
the port's code steps each shard on its device in turn:

- **sharded** means each leaf's leading row axis is cut into contiguous
  chunks, one per mesh position along the axis, in mesh order; a sharded
  tree is a list of trees, one per device of this process;
- **replicated** means a copy on each device (0-d leaves, the wideband
  filterbank carries).

The same device may appear more than once: that is how the CPU tests and
a one-card machine hold several shards.  A mesh made by
``multihost.make_global_mesh`` also spans the other processes of a
``torch.distributed`` group; its ``backend`` says how tensors cross
between them (``nccl``: each process has its own card and sends from it;
``gloo``: compute stays on each process's device and what crosses is
copied through host memory, because gloo moves no CUDA tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.utils.trees import tree_map


class Mesh:
    """Named axes over devices.

    ``devices``: this process's devices, in mesh order.  ``axis_names``:
    one axis (``("vfo",)`` or ``("time",)``), or ``("host", "vfo")``
    whose first axis is the process.  ``process_count`` /
    ``process_index`` / ``backend`` describe the process group a global
    mesh spans (1 / 0 / None for a mesh inside one process)."""

    def __init__(self, devices, axis_names=("vfo",), process_count: int = 1,
                 process_index: int = 0, backend: str | None = None):
        self.devices = tuple(_indexed(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        n = len(self.devices)
        if len(self.axis_names) == 1:
            dims = (process_count * n,)
        elif len(self.axis_names) == 2:
            dims = (process_count, n)
        else:
            raise ValueError(f"axis_names {axis_names}: one or two axes")
        if process_count > 1 and backend not in ("nccl", "gloo"):
            raise ValueError(f"a mesh over {process_count} processes needs "
                             f"backend 'nccl' or 'gloo', not {backend!r}")
        self.shape = dict(zip(self.axis_names, dims))
        self.process_count = process_count
        self.process_index = process_index
        self.backend = backend

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, {self.shape}, "
                f"process {self.process_index}/{self.process_count})")

    def coords(self, axis: str) -> list:
        """Each local device's position along ``axis``: which chunk of a
        tree sharded over ``axis`` it holds."""
        dims = tuple(self.shape.values())
        flat = (self.process_index * len(self.devices)
                + np.arange(len(self.devices)))
        return [int(c) for c in
                np.unravel_index(flat, dims)[self.axis_names.index(axis)]]

    def rows(self, n: int, axis: str = "vfo") -> list:
        """(lo, hi) of each local device's rows when ``n`` rows are cut
        over ``axis``; ValueError unless the axis divides ``n``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} rows not divisible by mesh axis {axis!r} "
                             f"of size {size}")
        per = n // size
        return [(c * per, (c + 1) * per) for c in self.coords(axis)]

    def spans_processes(self, axis: str) -> bool:
        """Whether the chunks along ``axis`` live in several processes
        (else every process holds all of them)."""
        if sorted(set(self.coords(axis))) == list(range(self.shape[axis])):
            return False
        if len(self.axis_names) == 1:
            return True
        raise ValueError(f"mesh {self.shape}: gathering over {axis!r} is "
                         "not supported")


def _indexed(device) -> torch.device:
    """``device`` resolved, a bare ``cuda`` as the current card's index
    (so that it compares equal to its tensors' device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, axis: str = "vfo",
              device="cuda") -> Mesh:
    """A one-axis mesh inside this process.

    ``device="cuda"`` (no index): the first ``n_devices`` visible cards,
    by default all (RuntimeError without CUDA, ValueError if fewer cards
    are visible).  A device with an index, or ``"cpu"``: ``n_devices``
    shards on that one device (default 1)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"{n} cards requested, {count} visible")
        return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))
    return Mesh([dev] * (1 if n_devices is None else n_devices), (axis,))


def shard_over_vfo(mesh: Mesh, tree, axis: str = "vfo") -> list:
    """Every leaf of ``tree`` with its LEADING axis cut over ``axis``
    (0-d leaves replicated): one tree per local device, its chunk on that
    device.  Leaves may be tensors or numpy arrays; a chunk is a view
    when it stays on its leaf's device (the steps never write in
    place)."""
    out = []
    for dev, c in zip(mesh.devices, mesh.coords(axis)):
        def put(leaf, _dev=dev, _c=c):
            leaf = torch.as_tensor(leaf)
            if leaf.ndim == 0:
                return leaf.to(_dev)
            size = mesh.shape[axis]
            if leaf.shape[0] % size:
                raise ValueError(f"{leaf.shape[0]} rows not divisible by "
                                 f"mesh axis {axis!r} of size {size}")
            per = leaf.shape[0] // size
            return leaf[_c * per:(_c + 1) * per].to(_dev)
        out.append(tree_map(put, tree))
    return out


def replicate(mesh: Mesh, tree) -> list:
    """A copy of ``tree`` on each local device."""
    return [tree_map(lambda leaf, _d=dev: torch.as_tensor(leaf).to(_d), tree)
            for dev in mesh.devices]


def gather(mesh: Mesh, pieces, dim: int = 0, axis: str = "vfo",
           device=None) -> torch.Tensor:
    """The local devices' pieces of a tensor sharded over ``axis`` along
    ``dim``, joined in mesh order on ``device`` (default the mesh's first
    device); over a mesh that spans processes, every process gets the
    whole tensor (``all_gather``).  One piece on its target device is
    returned as it is."""
    device = mesh.devices[0] if device is None else _indexed(device)
    pieces = list(pieces)
    if len(pieces) == 1 and pieces[0].device == device:
        local = pieces[0]
    else:
        local = torch.cat([p.to(device) for p in pieces], dim)
    if not mesh.spans_processes(axis):
        return local
    return torch.cat(all_gather(mesh, local, device), dim)


def gather_tree(mesh: Mesh, trees, axis: str = "vfo", device=None):
    """Inverse of ``shard_over_vfo``: the local trees' leaves joined on
    their leading axis (0-d leaves from the first tree)."""
    return tree_map(
        lambda *ls: (ls[0].to(device or mesh.devices[0]) if ls[0].ndim == 0
                     else gather(mesh, ls, 0, axis, device)), *trees)


# ---- what crosses between processes ----

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A tensor as the process group moves it: complex as float pairs,
    bool as bytes, and on the host under gloo."""
    if t.is_complex():
        t = torch.view_as_real(t)
    elif t.dtype == torch.bool:
        t = t.view(torch.uint8)
    if mesh.backend == "gloo":
        t = t.cpu()
    return t.contiguous()


def _unwire(w: torch.Tensor, like: torch.Tensor, device) -> torch.Tensor:
    w = w.to(device)
    if like.is_complex():
        return torch.view_as_complex(w)
    if like.dtype == torch.bool:
        return w.view(torch.bool)
    return w


def all_gather(mesh: Mesh, t: torch.Tensor, device) -> list:
    """Every process's ``t`` (equal shapes), in process order, on
    ``device``."""
    import torch.distributed as dist
    w = _wire(mesh, t)
    bufs = [torch.empty_like(w) for _ in range(mesh.process_count)]
    dist.all_gather(bufs, w)
    return [_unwire(b, t, device) for b in bufs]


def shift_right(mesh: Mesh, t: torch.Tensor, device):
    """Send ``t`` to the next process and receive the previous one's (of
    the same shape and dtype) on ``device``; None on process 0."""
    import torch.distributed as dist
    w = _wire(mesh, t)
    rank, n = mesh.process_index, mesh.process_count
    ops, buf = [], None
    if rank + 1 < n:
        ops.append(dist.P2POp(dist.isend, w, rank + 1))
    if rank > 0:
        buf = torch.empty_like(w)
        ops.append(dist.P2POp(dist.irecv, buf, rank - 1))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return None if buf is None else _unwire(buf, t, device)
