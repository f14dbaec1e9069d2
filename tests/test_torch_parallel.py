"""Port parity for the multi-device slice: ``aero_tpu_torch.parallel``
(meshes, time sharding, sharded banks), ``FusedStation.shard``,
``Station(mesh=...)``, checkpoints across sharded and unsharded stations,
and the dry run, on CPU shards.

- The three time-shard functions over 4 and 8 shards are bit-identical to
  the port's unsharded pass (the filterbank across 3 blocks with a
  carried state) and within 1e-5 x peak of JAX's time-sharded result on
  its 8-device virtual mesh.
- ``MskVfoBank`` over 8 shards gives equal rows for equal inputs, and,
  teacher-forced from JAX's sharded bank every block, soft bytes within
  +-1 on >= 99.9% with lock flags and slips exact; ``OqpskVfoBank``
  sharded equals its unsharded bank.
- ``FusedStation.shard`` over 2 and 4 shards (two or more rows per shard)
  on the dry run's five-path INI with 8 VFOs a path: against the
  unsharded port, packed soft bytes within +-1 on >= 99.9% and telemetry
  to rtol = atol = 1e-4 over free-running blocks (a shard of one row may
  differ more: torch's CPU FFT, matmul and conv take other paths for a
  batch of one, and an unlocked 8400 demod on noise amplifies that);
  teacher-forced against JAX's station sharded the same way, within
  tests/test_torch_cuda.py:check_packed (the two acquisition blocks on
  noise within the mse gaps that ``_check_acquisition`` states and
  explains).  A group that the axis does not
  divide raises ValueError, as in JAX.
- Checkpoints: a JAX checkpoint loaded and then sharded, a sharded save
  loaded unsharded, and a sharded port save loaded by JAX, each resumes
  to the uninterrupted run's ACARS (tests/test_checkpoint.py's
  two-message stream); the classic station too.
- ``Station(mesh=...)`` gives JAX's ACARS; ``dryrun_multidevice(4,
  device="cpu")`` passes; without CUDA a mesh on ``cuda`` raises.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from aero_tpu.channelizer import load_ini as jax_load_ini
from aero_tpu.runtime.fused_station import FusedStation as JaxFused
from aero_tpu.runtime.station import Station as JaxStation
from aero_tpu_torch import convert
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.channelizer.pfb import pfb_channelize, pfb_init
from aero_tpu_torch.models.msk import MskState
from aero_tpu_torch.ops.design import HALFBAND_TAPS
from aero_tpu_torch.ops.fir import fir_apply, fir_decimate_apply, fir_init
from aero_tpu_torch.parallel import time_shard as ts
from aero_tpu_torch.parallel.dryrun import dryrun_multidevice, five_path_ini
from aero_tpu_torch.parallel.mesh import (Mesh, gather, make_mesh,
                                          shard_over_vfo)
from aero_tpu_torch.parallel.vfo_bank import MskVfoBank, OqpskVfoBank
from aero_tpu_torch.runtime.fused_station import FusedStation
from aero_tpu_torch.runtime.station import Station
from tests.test_checkpoint import INI, _wideband
from tests.test_torch_checkpoint import _blocks, _run
from tests.test_torch_classic_station import _jax_states
from tests.test_torch_cuda import check_packed
from tests.test_torch_msk import _check_soft, _modem_signal

torch.set_num_threads(2)


def _cpu_mesh(n, axis="vfo"):
    return make_mesh(n, axis, device="cpu")


def _jax_mesh(n, axis):
    return JaxMesh(np.array(jax.devices()[:n]), (axis,))


# ---- meshes ----

def test_mesh_rows_and_coords():
    m = _cpu_mesh(4)
    assert m.shape == {"vfo": 4} and m.rows(8) == [(0, 2), (2, 4), (4, 6),
                                                   (6, 8)]
    with pytest.raises(ValueError):
        m.rows(6)
    # a global mesh's local devices hold their process's chunks
    g = Mesh(["cpu"] * 2, ("time",), process_count=3, process_index=1,
             backend="gloo")
    assert g.shape == {"time": 6} and g.coords("time") == [2, 3]
    assert g.rows(12, "time") == [(4, 6), (6, 8)] and g.spans_processes(
        "time")
    h = Mesh(["cpu"] * 2, ("host", "vfo"), process_count=3, process_index=1,
             backend="gloo")
    assert h.coords("vfo") == [0, 1] and not h.spans_processes("vfo")
    with pytest.raises(ValueError):
        Mesh(["cpu"], ("time",), process_count=2, process_index=0)


def test_global_mesh_outside_a_process_group():
    """Without a process group, multihost's helpers describe one process:
    a ("time",) mesh of its shards, and every VFO its own."""
    from aero_tpu_torch.parallel.multihost import (host_local_slice,
                                                   make_global_mesh)
    m = make_global_mesh(local_devices=["cpu"] * 2)
    assert m.axis_names == ("time",) and m.shape == {"time": 2}
    assert m.process_count == 1 and not m.spans_processes("time")
    assert host_local_slice(10) == slice(0, 10)


def test_shard_and_gather_round_trip():
    m = _cpu_mesh(4)
    st = MskState(*(torch.arange(8 * (i + 1), dtype=torch.float32).reshape(
        8, i + 1) for i in range(len(MskState._fields))))
    shards = shard_over_vfo(m, {"s": st, "k": torch.tensor(3.0)})
    assert len(shards) == 4 and shards[1]["s"].freq.shape[0] == 2
    assert all(float(s["k"]) == 3.0 for s in shards)
    back = gather(m, [s["s"].tail for s in shards])
    assert torch.equal(back, st.tail)


def test_cuda_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: nothing to refuse")
    for call in (lambda: make_mesh(2, device="cuda"),
                 lambda: MskVfoBank(4, 24000.0, 1200.0),
                 lambda: dryrun_multidevice(2)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# ---- time sharding ----

def _port_unsharded(kind, x):
    if kind == "fir":
        taps = HALFBAND_TAPS[23]
        return fir_apply(fir_init(len(taps), dtype=x.dtype), x, taps)[1]
    taps = HALFBAND_TAPS[11]
    return fir_decimate_apply(fir_init(len(taps), dtype=x.dtype), x, taps,
                              2)[1]


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("kind", ["fir", "decimate"])
def test_time_sharded_filters_bit_exact(kind, n):
    rng = np.random.default_rng(0 if kind == "fir" else 1)
    x = (rng.normal(size=16384) + 1j * rng.normal(size=16384)
         ).astype(np.complex64)
    mesh = _cpu_mesh(n, "time")
    if kind == "fir":
        fn = ts.halo_filter_time_sharded(mesh, HALFBAND_TAPS[23])
        from aero_tpu.parallel.time_shard import halo_filter_time_sharded
        jfn = halo_filter_time_sharded(_jax_mesh(8, "time"),
                                       HALFBAND_TAPS[23].astype(np.float32))
    else:
        fn = ts.halo_decimate_time_sharded(mesh, HALFBAND_TAPS[11], 2)
        from aero_tpu.parallel.time_shard import halo_decimate_time_sharded
        jfn = halo_decimate_time_sharded(_jax_mesh(8, "time"),
                                         HALFBAND_TAPS[11].astype(np.float32),
                                         2)
    xt = torch.from_numpy(x)
    shards = fn(shard_over_vfo(mesh, xt, "time"))
    assert [s.shape[0] for s in shards] == [len(x) // n // (
        1 if kind == "fir" else 2)] * n
    y = gather(mesh, shards, 0, "time")
    assert torch.equal(y, _port_unsharded(kind, xt))
    jx = jax.device_put(jnp.asarray(x), NamedSharding(_jax_mesh(8, "time"),
                                                      P("time")))
    want = np.asarray(jfn(jx))
    peak = np.abs(want).max()
    assert np.abs(y.numpy() - want).max() <= 1e-5 * peak


@pytest.mark.parametrize("n", [4, 8])
def test_pfb_time_sharded_bit_identical(n):
    from aero_tpu.channelizer.pfb import pfb_init as jax_pfb_init
    from aero_tpu.parallel.time_shard import pfb_channelize_time_sharded
    K = 32
    M = K // 2
    T = 8 * M * 40
    mesh = _cpu_mesh(n, "time")
    fn = ts.pfb_channelize_time_sharded(mesh, K)
    jfn = pfb_channelize_time_sharded(_jax_mesh(8, "time"), K)
    rng = np.random.default_rng(0)
    state = pfb_init(K)
    jstate = jax_pfb_init(K)
    for _ in range(3):
        x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)
             ).astype(np.complex64)
        xt = torch.from_numpy(x)
        ref_state, z_ref = pfb_channelize(state, xt, K)
        z = gather(mesh, fn(state, shard_over_vfo(mesh, xt, "time")), 1,
                   "time")
        assert torch.equal(z, z_ref)
        want = np.asarray(jfn(jstate, jnp.asarray(x)))
        assert np.abs(z.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        state, jstate = ref_state, jnp.asarray(x[-(8 * K - M):])


def test_time_shard_rejects_short_and_misaligned_shards():
    mesh = _cpu_mesh(4, "time")
    fn = ts.pfb_channelize_time_sharded(mesh, 32)   # history 240 samples
    x = torch.zeros(4 * 224, dtype=torch.complex64)
    with pytest.raises(ValueError, match="shorter than the PFB history"):
        fn(pfb_init(32), shard_over_vfo(mesh, x, "time"))
    x = torch.zeros(4 * 272, dtype=torch.complex64)
    with pytest.raises(ValueError, match="multiple of K"):
        fn(pfb_init(32), shard_over_vfo(mesh, x, "time"))
    with pytest.raises(ValueError, match="filter history"):
        ts.halo_filter_time_sharded(mesh, HALFBAND_TAPS[23])(
            shard_over_vfo(mesh, torch.zeros(4 * 16), "time"))


# ---- sharded banks ----

def test_msk_vfo_bank_sharded_consistent():
    from aero_tpu_torch.models.msk import msk_modulate
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 4000).astype(np.uint8)
    sig = msk_modulate(bits, 24000, 1200, freq=1000.0)[:16000]
    bank = MskVfoBank(8, 24000.0, 1200.0, mesh=_cpu_mesh(8))
    assert len(bank._shards) == 8
    soft = bank.process_block(np.tile(sig, (8, 1)))["soft_bits"].numpy()
    assert soft.shape == (8, 800)
    for r in range(1, 8):
        np.testing.assert_array_equal(soft[0], soft[r])


def test_msk_vfo_bank_sharded_teacher_forced_vs_jax():
    """JAX's bank shards its 8 rows over the 8 virtual devices; the
    port's over 8 CPU shards.  Each block starts from JAX's state."""
    from aero_tpu.ops.compat import tree_unpack
    from aero_tpu.parallel.vfo_bank import MskVfoBank as JaxBank
    from tests.test_torch_msk import _check_state
    xs = [_modem_signal(24000, 1200, -120.0 + 35.0 * k, 10.0 + 2.0 * k,
                        seed=k) for k in range(8)]
    n = min(len(v) for v in xs)
    x = np.stack([v[:n] for v in xs]).astype(np.float32)
    jb = JaxBank(8, 24000.0, 1200.0)
    assert jb.mesh.shape["vfo"] == 8
    tb = MskVfoBank(8, 24000.0, 1200.0, mesh=_cpu_mesh(8))
    L = jb.cfg.block_len
    for i in range(min(4, n // L)):
        blk = x[:, i * L:(i + 1) * L]
        tb.states = _jax_states(jb, MskState)
        to = tb.process_block(blk)
        jo = jb.process_block(blk)
        _check_soft(to["soft_bits"].numpy(), np.asarray(jo["soft_bits"]),
                    f"block {i}")
        for k in ("slip", "signal"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
        _check_state(tb.states, jax.tree.map(
            np.asarray, jax.vmap(tree_unpack)(jb.states)), f"block {i}")


def test_oqpsk_vfo_bank_sharded():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.1, (4, 3 * 16000)).astype(np.float32)
    full = OqpskVfoBank(4, 48000.0, 10500.0, device="cpu")
    shard = OqpskVfoBank(4, 48000.0, 10500.0, mesh=_cpu_mesh(2))
    for b in range(3):
        blk = x[:, b * 16000:(b + 1) * 16000]
        a, s = full.process_block(blk), shard.process_block(blk)
        assert s["soft_bits"].shape == (4, 3500)
        for k in a:
            torch.testing.assert_close(s[k], a[k], rtol=1e-4, atol=1e-4)
    shard.retune([1, 2], [9000.0, 11000.0])
    np.testing.assert_array_equal(shard.states.freq.numpy()[1:3],
                                  [9000.0, 11000.0])


def test_shard_rejects_a_group_the_axis_does_not_divide():
    st = FusedStation(load_ini(five_path_ini(3), is_text=True),
                      ingest_dtype="int4", base_block=160, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        st.shard(_cpu_mesh(2))
    with pytest.raises(ValueError, match="not divisible"):
        MskVfoBank(3, 24000.0, 1200.0, mesh=_cpu_mesh(2))


# ---- the fused station, sharded ----

FIVE = five_path_ini(8)


def _five_station(cls, **kw):
    cfg = (jax_load_ini if cls is JaxFused else load_ini)(FIVE, is_text=True)
    return cls(cfg, ingest_dtype="int4", base_block=160, pipeline=False,
               **kw)


def _noise_blocks(st, n, seed):
    rng = np.random.default_rng(seed)
    return [st.quantize((0.02 * (rng.standard_normal((st.block_len, 2))
                                 @ [1, 1j])).astype(np.complex64))
            for _ in range(n)]


def _step_and_drain(st, arr):
    """One block through the station's dispatch and drain; its packed
    buffer as numpy."""
    st._pending.append((arr, np.float32(1.0)))
    st._dispatch()
    packed = st._inflight.pop()
    st._drain(packed)
    return packed[0].numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_fused_station_sharded_matches_unsharded(n):
    full = _five_station(FusedStation, device="cpu")
    shard = _five_station(FusedStation, device="cpu").shard(_cpu_mesh(n))
    assert [len(s["grp"][(24000, 1200, False)]["phase"])
            for s in shard._shards] == [8 // n] * n
    soft_n = full._soft_total
    for blk in _noise_blocks(full, 4, seed=1):
        a, b = [_step_and_drain(st, blk) for st in (full, shard)]
        d = np.abs(a[:soft_n].astype(int) - b[:soft_n].astype(int))
        assert (d > 1).mean() <= 0.001
        np.testing.assert_allclose(b[soft_n:].view(np.float32),
                                   a[soft_n:].view(np.float32),
                                   rtol=1e-4, atol=1e-4)
    assert shard.vfo_telemetry().keys() == full.vfo_telemetry().keys()
    for topic in ("V7", "Q3", "C5"):
        np.testing.assert_allclose(shard.vfo_spectrum(topic)[1],
                                   full.vfo_spectrum(topic)[1], rtol=1e-4,
                                   atol=1e-4)
    assert shard.vfo_spectrum("B0") is None
    # the whole-station view of a sharded state is the unsharded layout
    assert convert.tree_leaves(convert.fused_state_to_numpy(shard._state))[
        0].shape == convert.tree_leaves(convert.fused_state_to_numpy(
            full._state))[0].shape


def _check_acquisition(st, a, b, block):
    """The packed buffers of an acquisition block (0 or 1 from the initial
    state, on noise).  There each package's timing and phase estimates are
    angles of noise-floor tone coefficients (``_tone_pair_sync``), which
    amplify float32 summation order: a row's mse may differ by up to 1e-3
    relative (tests/test_torch_msk.py::
    test_acquisition_mse_gap_on_noise_is_the_tone_sync_angles).  At 8400
    the first block's input is also the 2049-tap ``fir_apply_fft`` from a
    zero history, whose float32 FFT error is ~1e-3 of that transient
    output's peak: its mse may differ by up to 2e-2, and its soft bytes
    are not compared in block 0.  Every other slot as ``check_packed``."""
    fixed = a.copy()
    ta = fixed[st._soft_total:].view(np.float32)
    tb = b[st._soft_total:].view(np.float32)
    order = []
    for key in st._order:
        if not key[2]:
            nb = len(st.groups[key])
            mse = slice(st._tel_ofs[key] + nb, st._tel_ofs[key] + 2 * nb)
            gap = np.abs(ta[mse] - tb[mse]) / np.abs(tb[mse])
            bound = 2e-2 if key[1] == 8400 else 1e-3
            assert gap.max() <= bound, (key, block, float(gap.max()))
            ta[mse] = tb[mse]
            if key[1] == 8400 and block == 0:
                continue
        order.append(key)
    check_packed(SimpleNamespace(_order=order, groups=st.groups,
                                 _soft_total=st._soft_total,
                                 _soft_ofs=st._soft_ofs,
                                 _tel_ofs=st._tel_ofs), fixed, b)


@pytest.mark.parametrize("n", [2, 4])
def test_fused_station_sharded_teacher_forced_vs_jax(n):
    """JAX's station sharded over n virtual devices and the port's over n
    CPU shards, each block from JAX's state, from the initial state on:
    the first two blocks (acquisition on noise) within the gaps of
    ``_check_acquisition``, the rest within ``check_packed``."""
    jst = _five_station(JaxFused).shard(_jax_mesh(n, "vfo"))
    tst = _five_station(FusedStation, device="cpu").shard(_cpu_mesh(n))
    step = jst._get_step(1)
    one = np.float32(1.0)
    for i, arr in enumerate(_noise_blocks(tst, 5, seed=2)):
        tst._state = convert.fused_state_from_numpy(
            jax.tree.map(np.asarray, jst._state))
        _, tpacked = tst._step_shards(tst._shards, torch.from_numpy(arr),
                                      torch.tensor(one))
        jst._state, jpacked = step(jst._state, jnp.asarray(arr[None]),
                                   jnp.asarray([one]))
        if i >= 2:
            check_packed(tst, tpacked.numpy(), np.asarray(jpacked)[0])
        else:
            _check_acquisition(tst, tpacked.numpy(), np.asarray(jpacked)[0],
                               i)


# ---- checkpoints across sharded and unsharded stations ----

@pytest.fixture(scope="module")
def two_messages():
    cfg = load_ini(INI, is_text=True)
    wide = _wideband()
    return {k: _blocks(k, cfg, wide) for k in ("fused", "classic")}


def _port(kind, msgs, mesh=None):
    cfg = load_ini(INI, is_text=True)
    sink = dict(on_acars=lambda v, it: msgs.append((v, it.message)))
    if kind == "fused":
        st = FusedStation(cfg, device="cpu", **sink)
        return st.shard(mesh) if mesh is not None else st
    return Station(cfg, device="cpu", mesh=mesh, **sink)


def _jax(kind, msgs):
    cls = JaxFused if kind == "fused" else JaxStation
    return cls(jax_load_ini(INI, is_text=True),
               on_acars=lambda v, it: msgs.append((v, it.message)))


@pytest.mark.parametrize("writer,reader", [("jax", "sharded"),
                                           ("sharded", "port"),
                                           ("sharded", "jax")])
@pytest.mark.parametrize("kind", ["fused", "classic"])
def test_checkpoint_crosses_sharded_and_unsharded(two_messages, tmp_path,
                                                  kind, writer, reader):
    """The writer runs to the split (the first message out, the second in
    flight) and saves; the reader loads (a port reader of the fused kind
    then shards, as JAX's dry run does; a sharded classic station
    re-shards on load) and runs the rest: the messages of both runs are
    the uninterrupted run's."""
    blocks = two_messages[kind]
    mesh = _cpu_mesh(3)
    ref = []
    split = _run(_jax(kind, ref), blocks, ref)
    assert ref == [("V1", "BEFORE RESTART"), ("V1", "AFTER RESTART")]
    msgs_a, msgs_b = [], []
    st_a = (_jax(kind, msgs_a) if writer == "jax"
            else _port(kind, msgs_a, mesh))
    for b in blocks[:split]:
        st_a.process(b)
    ckpt = str(tmp_path / "c.ckpt")
    st_a.save_checkpoint(ckpt)
    if reader == "jax":
        st_b = _jax(kind, msgs_b)
        st_b.load_checkpoint(ckpt)
    elif kind == "fused":
        st_b = _port(kind, msgs_b)
        st_b.load_checkpoint(ckpt)
        if reader == "sharded":
            st_b.shard(mesh)
    else:
        st_b = _port(kind, msgs_b, mesh if reader == "sharded" else None)
        st_b.load_checkpoint(ckpt)
    if reader == "sharded":
        bank_or_st = (st_b if kind == "fused"
                      else next(iter(st_b.banks.values())))
        assert len(bank_or_st._shards) == 3
    _run(st_b, blocks[split:])
    assert msgs_a + msgs_b == ref


def test_classic_station_on_a_mesh_gives_jax_acars(two_messages):
    jmsgs, tmsgs = [], []
    jst = _jax("classic", jmsgs)
    tst = _port("classic", tmsgs, _cpu_mesh(3))
    assert all(len(b._shards) == 3 for b in tst.banks.values())
    for b in two_messages["classic"]:
        jst.process(b)
        tst.process(b)
    assert tmsgs == jmsgs == [("V1", "BEFORE RESTART"),
                              ("V1", "AFTER RESTART")]
    assert (tst.stats.frames, tst.stats.su_ok, tst.stats.su_bad) == (
        jst.stats.frames, jst.stats.su_ok, jst.stats.su_bad)


def test_dryrun_multidevice_on_cpu_shards():
    dryrun_multidevice(4, device="cpu")
