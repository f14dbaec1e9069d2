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

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.runtime.fused_station import FusedStation as JaxStation
from aero_tpu_torch import convert
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.channelizer.channelizer import Channelizer
from aero_tpu_torch.device import disable_graphs, graphs_enabled
from aero_tpu_torch.models.msk import msk_modulate, msk_step
from aero_tpu_torch.parallel.vfo_bank import MskVfoBank
from aero_tpu_torch.runtime.fused_station import FusedStation
from aero_tpu_torch.utils.graphs import GraphedStep
from aero_tpu_torch.utils.trees import tree_leaves, tree_map
import test_torch_channelizer as tch
import test_torch_station_step as tss
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
                        batch_host_framing=True, device="cpu", **kw)


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
