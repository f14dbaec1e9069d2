"""Port parity for the classic station: ``aero_tpu_torch.parallel.vfo_bank``
and ``aero_tpu_torch.runtime.station.Station`` (tree and PFB backends),
against JAX on the CPU.

- ``VfoBank.process_block`` teacher-forced: before every block the JAX
  bank's state is carried into the port's bank, both step the same
  samples, and the outputs and new states are compared with the
  tolerances of tests/test_torch_msk.py (soft bytes within +-1 on 99.9%,
  lock flags and slips exact, carries to float32 error).
- ``retune`` resets exactly the fields JAX's does, to the same values,
  and leaves every other field and row as it was (exact).
- The classic ``Station`` free-running, tree and PFB backends, on
  tests/test_checkpoint.py's two-message signal: the same ACARS in the
  same order and the same frame and SU counts as JAX (exact).
- ``station_main --backend tree`` on configs/aor_w_54_lband.ini, used
  unmodified, over the synthetic capture of tests/torch_lband54.py: the
  same jsondump records as JAX's CLI, every planted message, the R
  packet, no bad SU; split in two runs by ``--checkpoint``, the second
  run resumes and gives the rest of the messages, whether the first run
  was the port's or JAX's (exact: the texts of JAX's uninterrupted run,
  in order).  ``--backend pfb`` and ``--backend fused`` stop at JAX's
  asserts on that file.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from aero_tpu.channelizer import load_ini as jax_load_ini
from aero_tpu.ops.compat import tree_unpack
from aero_tpu.parallel import vfo_bank as jvb
from aero_tpu.runtime import station_main as jax_main
from aero_tpu.runtime.station import Station as JaxStation
from aero_tpu_torch import convert
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.models.msk import MskState
from aero_tpu_torch.models.oqpsk import OqpskState
from aero_tpu_torch.parallel import vfo_bank as tvb
from aero_tpu_torch.runtime import station_main as torch_main
from aero_tpu_torch.runtime.station import Station
from tests.test_checkpoint import INI, _wideband
from tests.test_torch_msk import _check_soft, _check_state, _modem_signal
import torch_lband54 as l54

torch.set_num_threads(2)


def _jax_states(bank, cls):
    """The JAX bank's packed per-VFO states -> the port's state type."""
    return convert.state_from_numpy(jax.tree.map(np.asarray, bank.states),
                                    cls, "cpu", c64_axis=1)


@pytest.mark.parametrize("fs,fb", [(24000, 1200), (12000, 600)])
def test_vfo_bank_teacher_forced(fs, fb):
    xs = [_modem_signal(fs, fb, c, s, seed=k)
          for k, (c, s) in enumerate([(-80.0, 9.0), (40.0, 25.0)])]
    n = min(len(v) for v in xs)
    x = np.stack([v[:n] for v in xs]).astype(np.float32)
    jb = jvb.MskVfoBank(2, float(fs), float(fb))
    tb = tvb.MskVfoBank(2, float(fs), float(fb), device="cpu")
    assert tuple(tb.cfg) == tuple(jb.cfg)
    L = jb.cfg.block_len
    for i in range(min(6, n // L)):
        blk = x[:, i * L:(i + 1) * L]
        tb.states = _jax_states(jb, MskState)
        to = tb.process_block(blk)
        jo = jb.process_block(blk)
        ctx = f"block {i}"
        _check_soft(to["soft_bits"].numpy(), np.asarray(jo["soft_bits"]), ctx)
        for k in ("slip", "signal"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                          err_msg=ctx)
        _check_state(tb.states, jax.tree.map(
            np.asarray, jax.vmap(tree_unpack)(jb.states)), ctx)


@pytest.mark.parametrize("kind", ["msk", "oqpsk"])
def test_vfo_bank_retune_resets_the_fields_jax_resets(kind):
    if kind == "msk":
        jb, tb, cls = (jvb.MskVfoBank(3, 24000.0, 1200.0),
                       tvb.MskVfoBank(3, 24000.0, 1200.0, device="cpu"),
                       MskState)
        x = np.stack([_modem_signal(24000, 1200, 50.0 * k, 20.0, seed=k)
                      [: jb.cfg.block_len] for k in range(3)])
    else:
        jb, tb, cls = (jvb.OqpskVfoBank(3, 48000.0, 10500.0),
                       tvb.OqpskVfoBank(3, 48000.0, 10500.0, device="cpu"),
                       OqpskState)
        x = np.random.default_rng(1).normal(
            0, 0.1, (3, jb.cfg.block_len)).astype(np.float32)
    jb.process_block(x)          # every field away from its initial value
    tb.states = _jax_states(jb, cls)
    before = {f: getattr(tb.states, f).clone() for f in cls._fields}
    jb.retune([0, 2], [1500.0, 2750.5])
    tb.retune([0, 2], [1500.0, 2750.5])
    want = _jax_states(jb, cls)
    reset = {"freq", "mse", "have_lock_refs", "agc_ema", "coarse_y",
             "slope", "grid_rate"}
    for f in cls._fields:
        got = getattr(tb.states, f)
        assert torch.equal(got, getattr(want, f)), f
        if f not in reset:
            assert torch.equal(got, before[f]), f
    np.testing.assert_array_equal(tb.states.freq.numpy()[[0, 2]],
                                  np.float32([1500.0, 2750.5]))
    assert torch.equal(tb.states.freq[1], before["freq"][1])


def _two_message_blocks(cfg):
    B = cfg.buflen_complex
    w = np.concatenate([_wideband(), np.zeros(4 * B, np.complex64)])
    return [w[i:i + B] for i in range(0, (len(w) // B) * B, B)]


@pytest.mark.parametrize("backend", ["tree", "pfb"])
def test_classic_station_same_as_jax(backend):
    cfg = load_ini(INI, is_text=True)
    blocks = _two_message_blocks(cfg)
    res = []
    for cls, kw in ((JaxStation, {}), (Station, {"device": "cpu"})):
        msgs = []
        st = cls(jax_load_ini(INI, is_text=True) if cls is JaxStation
                 else cfg, backend=backend,
                 on_acars=lambda v, it: msgs.append((v, it.message)), **kw)
        for b in blocks:
            st.process(b)
        res.append((msgs, st.stats.frames, st.stats.su_ok, st.stats.su_bad))
    want, got = res
    assert got == want
    assert got[0] == [("V1", "BEFORE RESTART"), ("V1", "AFTER RESTART")]


@pytest.fixture(scope="module")
def capture54(tmp_path_factory):
    d = tmp_path_factory.mktemp("l54")
    wide = l54.make_capture()
    paths = {"all": d / "all.cf32", "a": d / "a.cf32", "b": d / "b.cf32"}
    wide.tofile(paths["all"])
    wide[: l54.SPLIT * l54.BLOCK].tofile(paths["a"])
    wide[l54.SPLIT * l54.BLOCK:].tofile(paths["b"])
    return {k: str(v) for k, v in paths.items()}


def _cli(main, argv, **kw):
    """(jsondump records on stdout, stderr lines) of one CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv, **kw) == 0
    recs = []
    for line in out.getvalue().splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            r.pop("t", None)
            recs.append(r)
    return recs, err.getvalue().splitlines()


def _texts(recs):
    """The ACARS texts of jsondump records (the R packet's record has
    none)."""
    return [r["isu"].get("acars", {}).get("msg_text") for r in recs]


ARGV54 = ["-c", l54.INI_PATH, "--backend", "tree", "--format", "jsondump",
          "-s", "TEST", "--stats-every", "1e9"]


@pytest.fixture(scope="module")
def jax_run54(capture54):
    """JAX's CLI over the whole 54W capture: its jsondump records."""
    recs, _ = _cli(jax_main.main, ARGV54 + ["--iq-file", capture54["all"],
                                            "--platform", "cpu"])
    return recs


def test_station_main_54w_tree_same_as_jax_and_resumes(capture54, jax_run54,
                                                       tmp_path):
    argv = list(ARGV54)
    want = jax_run54
    seen = []
    got, err = _cli(torch_main.main,
                    argv + ["--iq-file", capture54["all"], "--device", "cpu"],
                    on_station=seen.append)
    assert got == want
    st = seen[0]
    assert {m for _, m in l54.planted()} <= set(_texts(got))
    assert st.stats.su_bad == 0 and st.stats.burst_packets == 1
    assert [e.infofield[:17] for e in st.rt_framers[l54.R_TOPIC].events
            if e.kind == "R"] == [l54.R_INFO]
    assert any("VFOs may not keep up" in line for line in err)

    # the same capture in two runs joined by a checkpoint
    ckpt = str(tmp_path / "st.ckpt")
    argv += ["--device", "cpu", "--checkpoint", ckpt]
    first, _ = _cli(torch_main.main, argv + ["--iq-file", capture54["a"]])
    second, err = _cli(torch_main.main, argv + ["--iq-file", capture54["b"]])
    assert any("resumed_from" in line for line in err)
    assert first and second
    assert _texts(first) + _texts(second) == _texts(got)


def test_station_main_54w_jax_checkpoint_resumes_in_port(capture54, jax_run54,
                                                         tmp_path):
    """JAX's tree CLI runs the first half and checkpoints; the port's CLI
    resumes from that file (main chain, both banks, the R watchers) over
    the second half.  Together they give JAX's uninterrupted texts."""
    ckpt = str(tmp_path / "jax.ckpt")
    first, _ = _cli(jax_main.main, ARGV54 + [
        "--iq-file", capture54["a"], "--platform", "cpu",
        "--checkpoint", ckpt])
    second, err = _cli(torch_main.main, ARGV54 + [
        "--iq-file", capture54["b"], "--device", "cpu",
        "--checkpoint", ckpt])
    assert any("resumed_from" in line for line in err)
    assert first and second
    assert _texts(first) + _texts(second) == _texts(jax_run54)


@pytest.mark.parametrize("backend,match", [
    ("pfb", "sub-VFO audio only"), ("fused", "sub-VFO banks only")])
def test_station_main_54w_pfb_and_fused_assert_as_jax(backend, match):
    argv = ["-c", l54.INI_PATH, "--backend", backend, "--iq-stdin"]
    with pytest.raises(AssertionError, match=match):
        jax_main.main(argv + ["--platform", "cpu"])
    with pytest.raises(AssertionError, match=match):
        torch_main.main(argv + ["--device", "cpu"])
