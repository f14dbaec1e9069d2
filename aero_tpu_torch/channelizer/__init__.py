"""WOLA polyphase filterbank (torch) and the SDRReceiver-compatible INI
config (a verbatim copy of ``aero_tpu.channelizer.config``)."""

from aero_tpu_torch.channelizer.config import (ChannelizerConfig,
                                               MainVfoConfig, SubVfoConfig,
                                               load_ini)

__all__ = ["ChannelizerConfig", "MainVfoConfig", "SubVfoConfig", "load_ini"]
