"""The port's counterpart of the JAX package's compiled steps
(``aero_tpu_torch/utils/graphs.py``), on the CPU.

On a card each device step is captured once into a CUDA graph and
replayed; here the same ``GraphedStep`` runs the step eagerly through the
same static buffers (inputs copied in, the new state written back in
place, the outputs copied out), which is the discipline replay relies on.
Each test holds that static-buffer path to the plain functional path,
exactly (the same ops on the same inputs):

- ``GraphedStep`` itself: write-back through views, a state set in place
  or with a new layout, copies that later steps leave alone, ``out=``;
- the fused station at 1 and 4 blocks per step with 2 steps in flight
  (an output aliased across dispatches would show), across a
  ``save_checkpoint`` / ``load_checkpoint`` in mid-stream, and under
  ``device.disable_graphs()``;
- an MSK bank with a retune between two steps (written in place into the
  static state);
- the tree channelizer, block by block;
- one teacher-forced comparison of the helper-driven fused station with
  JAX's step, at the tolerances of tests/test_torch_station_step.py.

The card's side (capture, replay, graphed against eager byte for byte,
a capture that syncs raising) is in tests/test_torch_cuda.py.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.channelizer.pfb import PfbChannelizer as JaxPfb
from aero_tpu.models import burst_common as jbc
from aero_tpu.models import burst_msk as jbm
from aero_tpu.models import burst_oqpsk as jbo
from aero_tpu.models import msk as jmsk
from aero_tpu.models import oqpsk as joq
from aero_tpu.protocol import batch_framing as jbf
from aero_tpu.runtime import decoder as jdecoder
from aero_tpu.runtime.fused_station import FusedStation as JaxStation
from aero_tpu_torch import convert
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.channelizer.channelizer import Channelizer
from aero_tpu_torch.channelizer.pfb import PfbChannelizer
from aero_tpu_torch.device import disable_graphs, graphs_enabled
from aero_tpu_torch.io.output import to_output_format
from aero_tpu_torch.models import burst_common as tbc
from aero_tpu_torch.models import burst_msk as tbm
from aero_tpu_torch.models import burst_oqpsk as tbo
from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
from aero_tpu_torch.models.burst_oqpsk import BurstOqpskDemodulator
from aero_tpu_torch.models.msk import MskDemodulator, msk_modulate, msk_step
from aero_tpu_torch.models.oqpsk import (OqpskDemodulator, OqpskState,
                                         oqpsk_step)
from aero_tpu_torch.ops import viterbi_kernel as vk
from aero_tpu_torch.parallel.vfo_bank import MskVfoBank
from aero_tpu_torch.protocol import batch_framing as tbf
from aero_tpu_torch.protocol.batch_framing import BatchPChannelFramerBank
from aero_tpu_torch.protocol.framing import FRAME_SPECS
from aero_tpu_torch.protocol.interleaver import deinterleave_indices
from aero_tpu_torch.runtime.decoder import Decoder, DecoderOptions
from aero_tpu_torch.runtime.fused_station import FusedStation
from aero_tpu_torch.utils import graphs
from aero_tpu_torch.utils.graphs import GraphedStep, count_launch, stateless
from aero_tpu_torch.utils.trees import tree_leaves, tree_map
import test_torch_burst as tbt
import test_torch_channelizer as tch
import test_torch_msk as tmsk
import test_torch_oqpsk as toq
import test_torch_station_step as tss
import test_torch_viterbi as tv
from torch_station_bank import INI, make_wideband

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wideband():
    return make_wideband()


def _same_tree(a, b):
    """Two trees of tensors equal leaf by leaf (dict leaves by key)."""
    assert len(tree_leaves(a)) == len(tree_leaves(b))

    def same(x, y):
        assert x.dtype == y.dtype and torch.equal(x, y)
    tree_map(same, a, b)


# ---- GraphedStep ----------------------------------------------------------

def _acc_step(state, x):
    """A carry whose new value is partly a view of the old one (the
    shifted history) and partly fresh."""
    hist = torch.cat([state["hist"][1:], x[:1]])
    return {"hist": hist, "n": state["n"] + 1}, {"sum": hist.sum() + x}


def test_graphed_step_equals_the_functional_step():
    state = {"hist": torch.arange(4, dtype=torch.float32),
             "n": torch.zeros((), dtype=torch.int64)}
    st = GraphedStep(_acc_step, state, "acc")
    ref = tree_map(torch.clone, state)
    outs = []
    for k in range(5):
        x = torch.full((3,), float(k))
        outs.append(st(x))
        ref, want = _acc_step(ref, x)
        _same_tree(outs[-1], want)
        _same_tree(st.state, ref)
    # the outputs handed out are copies that later steps leave alone
    assert torch.equal(outs[0]["sum"], torch.full((3,), 6.0))
    assert st.captures == 0


def test_graphed_step_write_back_through_views():
    """A new state leaf that views another leaf's old buffer is copied
    aside before any buffer is written."""
    def swap(state, x):
        return {"a": state["b"][:2], "b": torch.cat([state["a"], x])}, x
    st = GraphedStep(swap, {"a": torch.tensor([1., 2.]),
                            "b": torch.tensor([3., 4., 5.])}, "swap")
    st(torch.tensor([9.]))
    assert st.state["a"].tolist() == [3., 4.]
    assert st.state["b"].tolist() == [1., 2., 9.]


def test_graphed_step_state_setter_and_snapshot():
    state = {"hist": torch.zeros(4), "n": torch.zeros((), dtype=torch.int64)}
    st = GraphedStep(_acc_step, state, "acc")
    buf = st.state["hist"]
    st.state = {"n": torch.tensor(7), "hist": torch.ones(4)}   # same layout
    assert st.state["hist"] is buf and buf.tolist() == [1.] * 4
    snap = st.snapshot()
    st(torch.ones(3))
    assert snap["n"].item() == 7 and st.state["n"].item() == 8
    st.state = {"hist": torch.ones(6), "n": torch.tensor(0)}   # new layout
    assert st.state["hist"] is not buf and st.state["hist"].shape == (6,)


def test_graphed_step_copies_into_out():
    def step(state, x):
        return state + x, (state + x) * 2
    st = GraphedStep(step, torch.zeros(3), "double")
    out = torch.empty(2, 3)
    for i in range(2):
        assert st(torch.ones(3), out=out[i]) is not None
    assert out.tolist() == [[2.] * 3, [4.] * 3]


def test_disable_graphs_switch():
    assert graphs_enabled()
    with disable_graphs():
        assert not graphs_enabled()
        with disable_graphs():
            assert not graphs_enabled()
        assert not graphs_enabled()
    assert graphs_enabled()
    with pytest.raises(KeyError):
        with disable_graphs():
            raise KeyError("out")
    assert graphs_enabled()


# ---- the fused station ----------------------------------------------------

def _blocks(st, wb, extra=2):
    w = np.concatenate([wb, np.zeros(extra * st.block_len, np.complex64)])
    L = st.block_len
    return [w[i:i + L] for i in range(0, (len(w) // L) * L, L)]


def _drained(st, blocks):
    """Each block's packed row as drained by ``st`` (numpy)."""
    rows, drain = [], st._drain

    def recording(packed):
        rows.extend(packed.cpu().numpy())
        drain(packed)
    st._drain = recording
    for b in blocks:
        st.process(b)
    st.flush()
    st._drain = drain
    return rows


def _functional(st, blocks):
    """The same blocks through ``FusedStation._step`` from ``st``'s
    state: (packed rows, final state)."""
    state, rows = st._state, []
    for b in blocks:
        q = st.quantize(b)
        arr, scale = q if isinstance(q, tuple) else (q, np.float32(1.0))
        state, packed = st._step(state, torch.from_numpy(arr),
                                 torch.tensor(np.float32(scale)))
        rows.append(packed.numpy())
    return rows, state


def _station(**kw):
    return FusedStation(load_ini(INI, is_text=True), ingest_dtype="int4",
                        device="cpu", **kw)


@pytest.mark.parametrize("bps", [1, 4])
def test_fused_station_static_path_equals_functional(wideband, bps):
    st = _station(blocks_per_step=bps, pipeline_depth=2)
    blocks = _blocks(st, wideband)
    want, state = _functional(_station(), blocks)
    got = _drained(st, blocks)
    assert len(got) == len(want) == len(blocks) >= 8
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"block {i}")
    _same_tree(st._state, state)


def test_fused_station_checkpoint_mid_stream(wideband, tmp_path):
    st = _station(blocks_per_step=2, pipeline_depth=1)
    blocks = _blocks(st, wideband)
    want, _ = _functional(_station(), blocks)
    k = 5
    first = _drained(st, blocks[:k])
    path = str(tmp_path / "mid.ckpt")
    st.save_checkpoint(path)
    resumed = _station(blocks_per_step=2, pipeline_depth=1)
    resumed.load_checkpoint(path)
    got = first + _drained(resumed, blocks[k:])
    on = _drained(st, blocks[k:])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"block {i}")
    for i, (g, w) in enumerate(zip(on, want[k:])):
        np.testing.assert_array_equal(g, w, err_msg=f"block {k + i}")


def test_fused_station_under_disable_graphs(wideband):
    st = _station(blocks_per_step=4, pipeline_depth=2)
    blocks = _blocks(st, wideband)
    want, _ = _functional(_station(), blocks)
    with disable_graphs():
        got = _drained(st, blocks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert st.captures == 0


def test_fused_station_state_reads_are_copies(wideband):
    st = _station(pipeline_depth=0)
    blocks = _blocks(st, wideband, extra=0)[:2]
    before = st._state
    st.process(blocks[0])
    after = st._state
    assert not torch.equal(before["pfb"][24000], after["pfb"][24000])
    assert torch.equal(before["pfb"][24000],
                       _station()._state["pfb"][24000])
    # the setter writes the live buffers in place: the step objects stay
    steps = list(st._steps)
    st._state = before
    assert st._steps == steps
    _same_tree(st._state, before)


def test_helper_driven_station_teacher_forced_vs_jax(wideband):
    cfg = load_ini(INI, is_text=True)
    jst = JaxStation(cfg, ingest_dtype="int4")
    tst = FusedStation(cfg, ingest_dtype="int4", pipeline_depth=0,
                       device="cpu")
    rows, drain = [], tst._drain
    tst._drain = lambda packed: (rows.append(packed.numpy()[0]),
                                 drain(packed))
    step = jst._get_step(1)
    L = jst.block_len
    for b in range(6):
        arr = jst.quantize(wideband[b * L:(b + 1) * L])
        if b >= 3:
            tst._state = convert.fused_state_from_numpy(
                jax.tree.map(np.asarray, jst._state))
            tst.process(arr)
        jst._state, jpacked = step(jst._state, jnp.asarray(arr[None]),
                                   jnp.asarray([1.0], jnp.float32))
        if b >= 3:
            tss._check_packed(tst, rows[-1], np.asarray(jpacked)[0])
    assert len(rows) == 3


# ---- the demod bank -------------------------------------------------------

def _retuned(st, rows, freqs):
    """JAX's retune (``VfoBank.retune``), functionally."""
    rows = torch.as_tensor(rows)

    def put(field, value):
        out = field.clone()
        out[rows] = value
        return out
    return st._replace(
        freq=put(st.freq, torch.as_tensor(freqs)), mse=put(st.mse, 2.0),
        have_lock_refs=put(st.have_lock_refs, False),
        agc_ema=put(st.agc_ema, 0.0), coarse_y=put(st.coarse_y, 20.0),
        slope=put(st.slope, 0.0), grid_rate=put(st.grid_rate, 0.0))


def test_vfo_bank_retune_between_steps():
    rng = np.random.default_rng(4)
    sig = msk_modulate(rng.integers(0, 2, 4000), 24000, 1200, freq=1000.0)
    x = [(np.stack([np.roll(sig, 97 * r)[:16000] for r in range(4)])
          + 0.05 * rng.standard_normal((4, 16000))).astype(np.float32)
         for _ in range(3)]
    bank = MskVfoBank(4, 24000, 1200, device="cpu")
    state = bank.states
    steps = list(bank._steps)
    for i, blk in enumerate(x):
        if i == 1:
            bank.retune([1, 3], [1500.0, 800.0])
            state = _retuned(state, [1, 3], np.float32([1500.0, 800.0]))
        got = bank.process_block(blk)
        state, want = msk_step(state, torch.from_numpy(blk), bank.cfg)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        _same_tree(bank.states, state)
    assert bank._steps == steps and bank.captures == 0
    snap = bank.states
    snap.freq.fill_(0.0)                    # a copy: the bank keeps its own
    assert not torch.equal(bank.states.freq, snap.freq)


# ---- the tree channelizer -------------------------------------------------

def _functional_channelizer(ch, blocks):
    """``Channelizer.process``'s payloads, block by block, from each
    group step's function and a copy of its state."""
    main = {d: s.snapshot() for d, s in ch._main_steps.items()}
    sub = {k: s.snapshot() for k, s in ch._sub_steps.items()}
    out = []
    for iq in blocks:
        x = torch.from_numpy(iq)
        payloads, main_out = [], {}
        for decim, idxs in ch.main_groups.items():
            main[decim], z = ch._main_steps[decim].fn(main[decim], x)
            for row, i in enumerate(idxs):
                main_out[i] = z[row]
                m = ch.cfg.mains[i]
                if m.topic:
                    payloads.append((m.topic, m.out_rate, ch._compress_nibbles(
                        z[row].numpy(), m.compress_scale)))
        for key, idxs in ch.sub_groups.items():
            src = x if key[0] < 0 else main_out[key[0]]
            sub[key], pcm = ch._sub_steps[key].fn(sub[key], src)
            for row, i in enumerate(idxs):
                s = ch.cfg.subs[i]
                payloads.append((s.topic, s.out_rate,
                                 pcm[row].numpy().astype("<i2").tobytes()))
        out.append(payloads)
    return out, main, sub


@pytest.mark.parametrize("ini", ["tree", "late"])
def test_tree_channelizer_static_path_equals_functional(ini):
    text = {"tree": tch.INI_TREE.replace("correct_dc_bias=1",
                                         "correct_dc_bias=0"),
            "late": tch.INI_LATE}[ini]
    cfg = load_ini(text, is_text=True)
    blocks = [tch._wide(n, seed) for seed, n in
              enumerate((38400, 76800, 38400, 38400))]
    want, main, sub = _functional_channelizer(
        Channelizer(cfg, device="cpu"), blocks)
    ch = Channelizer(cfg, device="cpu")
    for i, b in enumerate(blocks):
        assert ch.process(b) == want[i], f"block {i}"
    _same_tree(ch._main_state, main)
    _same_tree(ch._sub_state, sub)
    assert ch.captures == 0


# ---- stateless steps and the kernel's launch count -------------------------

def test_stateless_step_keys_on_shapes_and_static_arguments():
    """A step without state: tensors are inputs (copied into the static
    buffers of their key), other arguments static (part of the key, as
    ``jax.jit``'s static arguments), keywords too."""
    calls = []

    def fn(x, k, *, scale):
        calls.append((tuple(x.shape), k, scale))
        return {"y": x * k + scale}
    st = stateless(fn, "affine", "cpu")
    a, b = torch.arange(4.0), torch.arange(6.0)
    assert torch.equal(st(a, 2, scale=1.0)["y"], a * 2 + 1)
    assert torch.equal(st(b, 2, scale=1.0)["y"], b * 2 + 1)
    assert torch.equal(st(a, 3, scale=0.5)["y"], a * 3 + 0.5)
    assert len(st._eager_io) == 3 and st.captures == st.replays == 0
    assert calls == [((4,), 2, 1.0), ((6,), 2, 1.0), ((4,), 3, 0.5)]
    with pytest.raises(ValueError, match="name its device"):
        GraphedStep(lambda s, x: (s, x), (), "no device")


def test_kernel_launches_counted_through_replays():
    """The Viterbi wrapper counts through ``count_launch``: at once
    outside a capture; a warm-up's launches not at all; a capture's at
    each replay of its graph (a replay runs no host code)."""
    before = vk.LAUNCHES
    count_launch(vk._count_launch)
    assert vk.LAUNCHES == before + 1
    with graphs._collecting_launches([]):               # a warm-up
        count_launch(vk._count_launch)
    with graphs._collecting_launches([]) as captured:   # a capture
        count_launch(vk._count_launch)
        count_launch(vk._count_launch)
    assert vk.LAUNCHES == before + 1 and len(captured) == 2

    class Stub:
        replayed = 0

        def replay(self):
            self.replayed += 1
    g = graphs._Graph(Stub(), [], None, captured)
    g.replay()
    g.replay()
    assert g.graph.replayed == 2 and vk.LAUNCHES == before + 5


# ---- the batched P decode --------------------------------------------------

@pytest.fixture(scope="module")
def p_frames():
    """17 consecutive 1200 bps frames in noise, deinterleaved as the bank
    prepares them: (payloads [17, 1152], prefixes [17, 62])."""
    spec = FRAME_SPECS[1200]
    _, soft = tv._frames(1200, 18, seed=12, noise=60.0)
    tb, hb = spec.total_bits, spec.header_bits
    didx = deinterleave_indices(spec.cols)
    payloads, prefixes = [], []
    prev = np.full(62, 128.0, np.float32)
    for j in range(17):
        pay = soft[j * tb + hb: j * tb + hb + spec.payload_soft_bits]
        de = np.concatenate(
            [pay[b * 64 * spec.cols:(b + 1) * 64 * spec.cols][didx]
             for b in range(spec.blocks_per_frame)])
        payloads.append(de)
        prefixes.append(prev)
        prev = de[-62:]
    return np.stack(payloads), np.stack(prefixes)


@pytest.mark.parametrize("n", [1, 3, 5, 17])
def test_batch_decode_step_equals_plain_and_jax(p_frames, n):
    """The bank's graphed decode, on a batch padded to a power of two with
    128s as ``flush`` pads it: bit-exact with the plain function, with
    JAX's ``batch_decode_p_frames`` (``use_pallas=False``) on the same
    padded batch, and, on the first n rows, with JAX on the n rows."""
    payloads, prefixes = (a[:n] for a in p_frames)
    n_pad = 1 << (n - 1).bit_length()

    def pad(a):
        return np.concatenate([a, np.full((n_pad - n,) + a.shape[1:], 128.0,
                                          np.float32)])
    kw = dict(rate=1200, pre_deinterleaved=True)
    bank = BatchPChannelFramerBank(1200, [], device="cpu")
    got = bank._decode(bank._tensor(pad(payloads)),
                       bank._tensor(pad(prefixes)), **kw)
    plain = tbf.batch_decode_p_frames(torch.from_numpy(pad(payloads)),
                                      torch.from_numpy(pad(prefixes)), **kw)
    want_pad = jbf.batch_decode_p_frames(jnp.asarray(pad(payloads)),
                                         jnp.asarray(pad(prefixes)), **kw)
    want = jbf.batch_decode_p_frames(jnp.asarray(payloads),
                                     jnp.asarray(prefixes), **kw)
    for k in ("info_bits", "su_ok"):
        assert got[k].shape[0] == n_pad
        assert torch.equal(got[k], plain[k]), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want_pad[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy()[:n], np.asarray(want[k]),
                                      err_msg=k)
    assert got["su_ok"].numpy()[:n].any()
    # a second call of the same key goes through the same static buffers
    # (rows decode apart: reversed rows give the rows reversed)
    again = bank._decode(bank._tensor(pad(payloads[::-1])),
                         bank._tensor(pad(prefixes[::-1])), **kw)
    for k in ("info_bits", "su_ok"):
        assert torch.equal(again[k][:n], plain[k][:n].flip(0)), k
    assert len(bank._decode._eager_io) == 1 and bank._decode.captures == 0


# ---- burst detection and window demodulators -------------------------------

@pytest.mark.parametrize("n_pad", [16384, 32768])
def test_detection_statistics_steps_equal_plain_and_jax(n_pad):
    """``_envelope`` and ``_autocorr_rho`` as the burst demodulator's
    graphed steps (the two detection arms), on ring buckets of 16384 and
    32768 samples: equal to the plain arms, their statistics equal to the
    plain functions, and within 1e-5 of JAX's (relative to the largest
    value: float32 FFTs and convolutions summed in another order)."""
    dm = BurstMskDemodulator(12000, 600, device="cpu")
    x = tbt._burst_audio(12000.0, 600.0, False, seed=5)[:n_pad]
    smooth, lag, det = dm._smooth_len(), 40, 320
    plan = torch.from_numpy(tbc._scan_plan(n_pad - 1000, 0.0))
    power_kw = dict(smooth=smooth, gate_ratio=2.5, min_run=2 * smooth)
    rho_kw = dict(lag=lag, smooth=det, threshold=0.35, min_run=160)
    nf = plan[tbc._NF]
    power = dm._envelope(dm._put(x), plan, nf, **power_kw)
    corr = dm._autocorr_rho(dm._put(x), plan, **rho_kw)
    plain = tbc._power_arm(torch.from_numpy(x), plan, nf, **power_kw)
    assert all(torch.equal(power[k], plain[k]) for k in plain)
    plain = tbc._rho_arm(torch.from_numpy(x), plan, **rho_kw)
    assert all(torch.equal(corr[k], plain[k]) for k in plain)
    env, rho = power["env"], corr["rho"]
    assert torch.equal(env, tbm._envelope(torch.from_numpy(x), smooth))
    assert torch.equal(rho, tbc._autocorr_rho(torch.from_numpy(x), lag, det))
    je = np.asarray(jbm._envelope(x, smooth))
    jr = np.asarray(jbc._autocorr_rho(x, lag, det))
    np.testing.assert_allclose(env.numpy(), je, rtol=0,
                               atol=1e-5 * np.abs(je).max())
    np.testing.assert_allclose(rho.numpy(), jr, rtol=0, atol=1e-5 * jr.max())
    assert [len(s._eager_io) for s in dm.steps] == [1, 1, 0]


@pytest.mark.parametrize("kind", ["msk", "oqpsk"])
def test_window_step_across_set_center(kind):
    """The window function as the demodulator's graphed step, its center
    a 0-d input: before and after ``set_center`` (one key, the same
    static buffers) equal to the plain function at that center, and soft
    bytes within one LSB of JAX's, equal on >= 99%."""
    if kind == "msk":
        fs, fb, jmod, tmod = 12000.0, 600.0, jbm, tbm
        dm = BurstMskDemodulator(fs, fb, device="cpu")
        centers = (dm.freq_center + 40.0, dm.freq_center + 163.0)
    else:
        fs, fb, jmod, tmod = 48000.0, 10500.0, jbo, tbo
        dm = BurstOqpskDemodulator(fs, fb, device="cpu")
        centers = (7300.0, 7450.0)
    cfg = dm.cfg
    window = getattr(tmod, f"burst_{kind}_window")
    jwindow = getattr(jmod, f"burst_{kind}_window")
    x = tbt._burst_audio(fs, fb, kind == "oqpsk", seed=4)[: cfg.window_len]
    gate = tbt._gate(x, 8 * cfg.sps if kind == "msk" else 33)
    for c in centers:
        dm.set_center(c)
        fc = np.float32(dm.freq_center)
        got = dm._window_fn(dm._put(x), dm._put(gate), cfg, dm._put(fc))
        plain = window(torch.from_numpy(x), torch.from_numpy(gate), cfg, fc)
        for k in plain:
            assert torch.equal(got[k], plain[k]), (c, k)
        jout = jwindow(x, gate, jmod.make_config(fs, fb), fc)
        tbt._check_window(jout, got)
        js = np.asarray(jout["soft"])
        assert (got["soft"].numpy() == js).mean() >= 0.99, c
    assert len(dm._window_fn._eager_io) == 1


# ---- the single-VFO demodulators ------------------------------------------

def _retune(dec_cls, demod, freq):
    """``Decoder._set_center`` on a decoder holding ``demod``."""
    dec_cls._set_center(SimpleNamespace(demod=demod), freq)


@pytest.mark.parametrize("kind", ["msk", "oqpsk"])
def test_single_vfo_demod_across_a_retune(kind):
    """``MskDemodulator`` / ``OqpskDemodulator`` through their graphed
    step, teacher-forced block by block from JAX's demodulator (its state
    written into the static buffers), with a ``Decoder._set_center``
    retune before block 2 on both sides: each block equals the plain
    ``msk_step`` / ``oqpsk_step`` on the same state exactly, and JAX's
    outputs and state within the tolerances of tests/test_torch_msk.py
    and tests/test_torch_oqpsk.py; the retune writes in place."""
    if kind == "msk":
        fs, fb = 24000.0, 1200.0
        x = tmsk._modem_signal(fs, fb, cfo=60.0, snr=14.0)
        jd, td = jmsk.MskDemodulator(fs, fb), MskDemodulator(fs, fb,
                                                             device="cpu")
        plain, check, state_cls = msk_step, tmsk._check_state, None
    else:
        fs, fb = 48000.0, 10500.0
        x = toq._two_vfos(10500, seed=7)[0]
        jd, td = joq.OqpskDemodulator(fs, fb), OqpskDemodulator(fs, fb,
                                                                device="cpu")
        plain, check, state_cls = oqpsk_step, toq._check_state, OqpskState
    L = td.cfg.block_len
    bufs = tree_leaves(td._step.state)
    locked = 0
    for b in range(4):
        js = jax.tree.map(lambda a: np.asarray(a)[None], jd.state)
        td.state = (convert.msk_state_from_numpy(js) if state_cls is None
                    else convert.state_from_numpy(js, state_cls))
        if b == 2:
            _retune(jdecoder.Decoder, jd, 1500.0 if kind == "msk" else 8200.0)
            _retune(Decoder, td, 1500.0 if kind == "msk" else 8200.0)
        ts = td.state
        blk = x[b * L:(b + 1) * L]
        jout, = jd.process(blk)
        tout, = td.process(blk)
        new, want = plain(ts, torch.from_numpy(blk)[None], td.cfg)
        for k in want:
            np.testing.assert_array_equal(tout[k], want[k][0].numpy(),
                                          err_msg=f"block {b} {k}")
        _same_tree(td.state, new)
        ctx = f"{kind} block {b}"
        tmsk._check_soft(tout["soft_bits"], np.asarray(jout["soft_bits"]),
                         ctx)
        for k in ("slip", "signal"):
            np.testing.assert_array_equal(tout[k], np.asarray(jout[k]),
                                          err_msg=ctx)
        check(td.state, jax.tree.map(lambda a: np.asarray(a)[None],
                                     jd.state), ctx)
        locked += int(tout["signal"])
    assert locked > 0
    assert all(a is b for a, b in zip(tree_leaves(td._step.state), bufs))
    assert td._step.captures == 0 and len(td._step._eager_io) == 1


# ---- the PFB channelizer ---------------------------------------------------

def test_pfb_channelizer_static_path_equals_plain_and_jax():
    """``PfbChannelizer`` with a graphed step per rate group: the payloads
    of every block equal the plain group function's on a copy of the
    state, and JAX's within the channelizer parity of
    tests/test_torch_channelizer.py (int16 audio within one LSB); the
    carries read back are JAX's; a state assigned mid-stream (a reset to
    zeros on both sides) is written into the static buffers."""
    vfos = "".join(
        f"{i + 1}\\frequency={1545002000 + i * 19000}\n"
        f"{i + 1}\\data_rate={600 if i % 2 else 1200}\n"
        f"{i + 1}\\topic=V{i}\n" for i in range(6))
    cfg = load_ini("[General]\nsample_rate=1536000\n"
                   "center_frequency=1545000000\n[vfos]\nsize=6\n" + vfos,
                   is_text=True)
    jch, ch = JaxPfb(cfg), PfbChannelizer(cfg, device="cpu")
    state = {r: s.snapshot() for r, s in ch._steps.items()}
    bufs = {r: tree_leaves(s.state) for r, s in ch._steps.items()}
    for b, T in enumerate((64 * 250, 64 * 251, 64 * 400, 64 * 250)):
        iq = tch._wide(T, b)
        if b == 2:      # a reset, as a checkpoint load writes it
            ch._state = {r: torch.zeros_like(c) for r, c in ch._state.items()}
            ch._phase = {r: torch.zeros_like(p) for r, p in ch._phase.items()}
            for r in state:
                state[r] = tree_map(torch.zeros_like, state[r])
                jch._state[r] = jnp.zeros_like(jch._state[r])
                jch._phase[r] = jnp.zeros_like(jch._phase[r])
        got = ch.process(iq)
        want = []
        for r, idxs in ch.groups.items():
            state[r], pcm = ch._steps[r].fn(state[r], torch.from_numpy(iq))
            want += [(cfg.subs[i].topic, r, pcm[row].numpy().astype(
                "<i2").tobytes()) for row, i in enumerate(idxs)]
        assert got == want, f"block {b}"
        tch._check_outputs(got, jch.process(iq))
    for r, s in ch._steps.items():
        _same_tree(s.state, state[r])
        assert all(x is y for x, y in zip(tree_leaves(s.state), bufs[r]))
        np.testing.assert_allclose(ch._phase[r].numpy(),
                                   np.asarray(jch._phase[r]), atol=1e-6)
    assert len(ch._steps) == 2 and ch.captures == 0


# ---- the single-VFO decoder end to end ------------------------------------

def test_decoder_on_the_1200_fixture_same_acars_as_jax(capsys):
    """``Decoder`` (graphed demodulator; here its static-buffer path) on
    tests/fixtures/synthetic_1200.wav prints the ACARS that JAX's
    ``Decoder`` prints, in order."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "synthetic_1200.wav")

    def acars(dec):
        dec.run_file(path)
        return [to_output_format("jsondump", "X", False, it, now=0.0)
                for it in dec.items]
    want = acars(jdecoder.Decoder(jdecoder.DecoderOptions(bitrate=1200)))
    got = acars(Decoder(DecoderOptions(bitrate=1200, device="cpu")))
    capsys.readouterr()
    assert len(want) >= 3 and got == want
