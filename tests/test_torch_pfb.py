"""Port parity: the WOLA filterbank and the ingest dequantizer.

``pfb_channelize_fused`` / ``pfb_channelize`` run over 3 consecutive
blocks with the carry, on the same input, in JAX (CPU) and in the port.
Tolerance: the outputs are sums of ~8K float32 products followed by a
128/24-point FFT, summed in another order on each side; agreement is
asserted to 2e-5 of the block's peak magnitude (a few float32 ulp of the
largest term), and the carries — plain copies of the input — exactly.

The dequantizer is compared for all five ingest dtypes against
``FusedStation._dequantize`` on a namespace holding only what it reads;
the decode is elementwise integer work plus one float32 scale, so the
outputs agree to 1 ulp (rtol 1e-7)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from aero_tpu.channelizer import pfb as jpfb
from aero_tpu.ops.compat import unpack_c64
from aero_tpu.runtime.fused_station import FusedStation as JaxStation
from aero_tpu_torch.channelizer import pfb as tpfb
from aero_tpu_torch.runtime.fused_station import FusedStation as TorchStation

torch.set_num_threads(2)


@pytest.mark.parametrize("K,fused", [(128, True), (128, False),
                                     (24, True), (24, False)])
def test_pfb_three_blocks_with_carry(K, fused):
    rng = np.random.default_rng(K)
    M = K // 2
    T = M * 64
    js = jpfb.pfb_init(K)
    ts = tpfb.pfb_init(K)
    jf = jpfb.pfb_channelize_fused if fused else jpfb.pfb_channelize
    tf = tpfb.pfb_channelize_fused if fused else tpfb.pfb_channelize
    for _ in range(3):
        x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)
             ).astype(np.complex64)
        js, jz = jf(js, jnp.asarray(x), K)
        ts, tz = tf(ts, torch.from_numpy(x), K)
        jz = np.asarray(jz)
        assert tz.shape == jz.shape == (K, T // M)
        peak = np.abs(jz).max()
        np.testing.assert_allclose(tz.numpy(), jz, rtol=0, atol=2e-5 * peak)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_pfb_fused_equals_reference_form():
    rng = np.random.default_rng(9)
    K, T = 128, 64 * 40
    x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)
         ).astype(np.complex64)
    st = tpfb.pfb_init(K)
    _, za = tpfb.pfb_channelize(st, torch.from_numpy(x), K)
    _, zb = tpfb.pfb_channelize_fused(st, torch.from_numpy(x), K)
    peak = za.abs().max().item()
    np.testing.assert_allclose(zb.numpy(), za.numpy(), rtol=0,
                               atol=2e-5 * peak)


@pytest.mark.parametrize("dtype", ["int2", "int4", "int8", "int16",
                                   "float32"])
def test_dequantize_matches_jax(dtype):
    rng = np.random.default_rng(11)
    T = 4096
    iq = (0.3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
          ).astype(np.complex64)
    scale_of = {"int2": 1.0, "int4": 7.0, "int8": 127.0, "int16": 32767.0,
                "float32": 1.0}
    ns = SimpleNamespace(ingest_dtype=dtype, _iscale=scale_of[dtype])
    q = JaxStation.quantize(ns, iq)
    arr, scale = q if isinstance(q, tuple) else (q, np.float32(1.0))
    want = np.asarray(JaxStation._dequantize(ns, jnp.asarray(arr),
                                             jnp.float32(scale)))
    got = TorchStation._dequantize(ns, torch.from_numpy(np.asarray(arr)),
                                   torch.tensor(np.float32(scale)))
    assert got.dtype == torch.complex64 and got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


def test_pfb_state_layout_matches_jax_packing():
    """The JAX station keeps the PFB carry as float32 [2, N] planes; the
    port as complex64 [N] — convert maps one onto the other."""
    from aero_tpu_torch import convert
    rng = np.random.default_rng(12)
    z = (rng.standard_normal(960) + 1j * rng.standard_normal(960)
         ).astype(np.complex64)
    planes = np.stack([z.real, z.imag]).astype(np.float32)
    st = convert.fused_state_from_numpy({"pfb": {24000: planes}, "grp": {}})
    np.testing.assert_array_equal(st["pfb"][24000].numpy(), z)
    np.testing.assert_array_equal(
        np.asarray(unpack_c64(jnp.asarray(planes))), z)
    back = convert.fused_state_to_numpy(st)
    np.testing.assert_array_equal(back["pfb"][24000], planes)
