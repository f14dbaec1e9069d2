"""Device meshes, VFO-axis sharding and time sharding (the counterpart of
``aero_tpu.parallel``): a mesh names axes over ``torch.device``s, within
one process or across the processes of a ``torch.distributed`` group."""

from aero_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_over_vfo
from aero_tpu_torch.parallel.vfo_bank import MskVfoBank, OqpskVfoBank

__all__ = ["Mesh", "make_mesh", "shard_over_vfo", "MskVfoBank",
           "OqpskVfoBank"]
