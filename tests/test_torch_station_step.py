"""Port parity for the fused station's device step, teacher-forced.

JAX runs the bank of tests/torch_station_bank.py for 3 blocks to lock;
then, for 3 blocks, its state is carried into the port (``convert``) and
both step the same quantized block.  The packed uint8 buffers must agree:
soft bytes within +-1 on >= 99.9% of the bytes (as in
tests/test_torch_msk.py), lock flags and slips exactly, mse to 1e-4
relative, Eb/N0 to 1e-3 dB and the tracked frequencies to 2e-3 Hz (the
float32 tolerances of tests/test_torch_msk.py).  The state carried back
out (``convert.fused_state_to_numpy``) must run in the JAX station to a
bit-identical buffer: the round trip is lossless.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.runtime.fused_station import FusedStation as JaxStation
from aero_tpu_torch import convert
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.runtime.fused_station import FusedStation, TEL_SLOTS
from torch_station_bank import INI, make_wideband

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wideband():
    return make_wideband()


def _check_packed(st, tp, jp):
    soft_t, soft_j = tp[: st._soft_total], jp[: st._soft_total]
    d = np.abs(soft_t.astype(np.int32) - soft_j.astype(np.int32))
    assert (d <= 1).mean() >= 0.999, (d > 1).mean()
    tel_t = tp[st._soft_total:].view(np.float32)
    tel_j = jp[st._soft_total:].view(np.float32)
    for key in st._order:
        nb = len(st.groups[key])
        o = st._tel_ofs[key]
        t = tel_t[o: o + TEL_SLOTS * nb].reshape(TEL_SLOTS, nb)
        j = tel_j[o: o + TEL_SLOTS * nb].reshape(TEL_SLOTS, nb)
        np.testing.assert_array_equal(t[0], j[0])            # lock flags
        np.testing.assert_allclose(t[1], j[1], rtol=1e-4)    # mse
        np.testing.assert_allclose(t[2], j[2], atol=1e-3)    # Eb/N0 dB
        np.testing.assert_allclose(t[3], j[3], atol=2e-3)    # freq Hz
        np.testing.assert_array_equal(t[4], j[4])            # slips


@pytest.mark.parametrize("ingest", ["int16", "int4"])
def test_station_step_teacher_forced(wideband, ingest):
    cfg = load_ini(INI, is_text=True)
    jst = JaxStation(cfg, ingest_dtype=ingest)
    tst = FusedStation(cfg, ingest_dtype=ingest, device="cpu")
    assert tst._soft_total == jst._soft_total
    step = jst._get_step(1)
    L = jst.block_len
    locked = 0
    for b in range(6):
        q = jst.quantize(wideband[b * L:(b + 1) * L])
        arr, scale = q if isinstance(q, tuple) else (q, np.float32(1.0))
        jnew, jpacked = step(jst._state, jnp.asarray(arr[None]),
                             jnp.asarray([scale], jnp.float32))
        jpacked = np.asarray(jpacked)[0]
        if b >= 3:
            tstate = convert.fused_state_from_numpy(
                jax.tree.map(np.asarray, jst._state))
            _, tpacked = tst._step(tstate, torch.from_numpy(arr),
                                   torch.tensor(np.float32(scale)))
            assert tpacked.dtype == torch.uint8
            assert tpacked.shape == jpacked.shape
            _check_packed(tst, tpacked.numpy(), jpacked)
            back = jax.tree.map(jnp.asarray,
                                convert.fused_state_to_numpy(tstate))
            _, jpacked2 = step(back, jnp.asarray(arr[None]),
                               jnp.asarray([scale], jnp.float32))
            np.testing.assert_array_equal(np.asarray(jpacked2)[0], jpacked)
            tel = jpacked[jst._soft_total:].view(np.float32)
            locked += int(tel[jst._tel_ofs[(24000, 1200, False)]:][:2].sum())
        jst._state = jnew
    assert locked > 0, "the forced blocks never saw a locked VFO"
