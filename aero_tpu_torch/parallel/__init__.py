"""Batched multi-VFO demodulation banks on one device (the counterpart of
``aero_tpu.parallel``'s ``vfo_bank``; meshes and sharding are not ported
yet)."""

from aero_tpu_torch.parallel.vfo_bank import MskVfoBank, OqpskVfoBank

__all__ = ["MskVfoBank", "OqpskVfoBank"]
