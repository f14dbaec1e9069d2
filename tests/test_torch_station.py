"""Port parity for the slice as a whole: the fused station, free-running.

On the bank of tests/torch_station_bank.py, with int16 and int4 ingest,
the port's ``FusedStation`` (on the CPU, where its framer banks decode on
the host) emits the same ACARS (topic, message) set and the same frames /
su_ok / su_bad counts as JAX's ``FusedStation`` with batch framing off and
on: the port's one framing path is held to both of JAX's.  Exact
equality: the decoded content, not a float.
"""

import numpy as np
import pytest
import torch

from aero_tpu.runtime.fused_station import FusedStation as JaxStation
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.runtime.fused_station import FusedStation
from torch_station_bank import INI, make_wideband

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wideband():
    return make_wideband()


def _run(cls, wb, **kw):
    got = []
    st = cls(load_ini(INI, is_text=True),
             on_acars=lambda v, item: got.append((v, item.message)), **kw)
    w = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
    for i in range(0, (len(w) // st.block_len) * st.block_len,
                   st.block_len):
        st.process(w[i:i + st.block_len])
    st.flush()
    return (sorted(set(got)), st.stats.frames, st.stats.su_ok,
            st.stats.su_bad), st


@pytest.mark.parametrize("ingest", ["int16", "int4"])
@pytest.mark.parametrize("batch", [False, True])
def test_station_same_acars_as_jax(wideband, ingest, batch):
    want, _ = _run(JaxStation, wideband, ingest_dtype=ingest,
                   batch_host_framing=batch)
    got, st = _run(FusedStation, wideband, ingest_dtype=ingest,
                   device="cpu")
    assert ("X", "BATCH XX") in got[0] and ("Y", "BATCH YY") in got[0]
    assert got == want
    assert all(t.device.type == "cpu" for t in st._state["pfb"].values())


def test_multi_block_dispatch_same_result(wideband):
    """blocks_per_step and pipeline_depth change when the host uploads
    and drains, never what is decoded."""
    one, _ = _run(FusedStation, wideband, ingest_dtype="int4",
                  device="cpu", pipeline_depth=0)
    many, st = _run(FusedStation, wideband, ingest_dtype="int4",
                    device="cpu", blocks_per_step=3, pipeline_depth=1)
    assert many == one and one[0]
    assert not st._inflight and not st._pending


def test_unported_vfo_kinds_raise():
    """VFO kinds that the JAX station does not serve either raise its
    ValueError: an unknown continuous rate, and a burst VFO at 8400 (R/T
    channels are 600/1200 MSK or 10500 OQPSK)."""
    base = ("[General]\nsample_rate=288000\ncenter_frequency=1545000000\n"
            "[vfos]\nsize=1\n1\\frequency=1545024000\n1\\topic=V\n")
    for extra, match in (("1\\data_rate=4800\n", "unsupported data_rate"),
                         ("1\\data_rate=8400\n1\\burst=1\n", "burst VFO")):
        cfg = load_ini(base + extra, is_text=True)
        with pytest.raises(ValueError, match=match):
            JaxStation(cfg)
        with pytest.raises(ValueError, match=match):
            FusedStation(cfg, device="cpu")
