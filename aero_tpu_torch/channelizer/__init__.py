"""The aero-publish half on torch: the batched tree channelizer
(``Channelizer``), the WOLA polyphase filterbank (``pfb``), and the
SDRReceiver-compatible INI config (a verbatim copy of
``aero_tpu.channelizer.config``)."""

from aero_tpu_torch.channelizer.config import (ChannelizerConfig,
                                               MainVfoConfig, SubVfoConfig,
                                               load_ini)
from aero_tpu_torch.channelizer.channelizer import Channelizer

__all__ = ["Channelizer", "ChannelizerConfig", "MainVfoConfig",
           "SubVfoConfig", "load_ini"]
