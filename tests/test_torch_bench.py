"""The port's bench (``aero_tpu_torch.bench``) against the JAX bench.

Each section's builder runs one step from its initial state at B=2, and
the test builds the same step from ``aero_tpu``'s public functions
exactly as ``bench.py`` does (its packing at the boundary,
``ops/compat.py``, included), on the same input.  Tolerances:

- soft bytes within +-1 LSB on at least 99.5% of them;
- state floats within 1e-4 of the field's largest magnitude in JAX
  (relative), booleans exact.

On the two chain sections the bench's wideband tone falls outside every
VFO's demod band, so the MSK demod acquires on filterbank leakage
(``pfb_full_chain``) or on the rounding noise of the Hilbert USB
cancellation (``cascade_full_chain``).  Its tone-sync estimates there are
angles of noise-floor coefficients (ROADMAP C2): the carrier phase, the
strobe grid, and what they place (the strobe tail, the differential
decoder's memories, the matched filter's history of that noise) are not
held to 1e-4; the chain's own carries and the demod's mixer phase,
frequency, drift, fold spectrum, AGC and mse are, and the soft bytes are
gated as above.  On the demod, OQPSK and burst sections every float is
held.

The latency stream equals JAX's construction (bits exactly, the wideband
within 1e-6); the Viterbi section decodes its bits exactly on the CPU
twin; ``main`` prints one JSON line without the TPU normalization, and a
failing section fails the run.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aero_tpu.ops.compat import tree_pack, tree_unpack
from aero_tpu_torch import bench as tb

torch.set_num_threads(2)
B = 2


def _check_soft(t, j):
    d = np.abs(np.asarray(t).astype(np.int32) - np.asarray(j).astype(np.int32))
    assert (d <= 1).mean() >= 0.995, ((d <= 1).mean(), d.max())


def _check_floats(got: dict, want: dict):
    for f, t in got.items():
        t, j = np.asarray(t), np.asarray(want[f]).reshape(np.shape(t))
        if t.dtype == bool:
            np.testing.assert_array_equal(t, j, err_msg=f)
            continue
        assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max(), f


def _unpack_vmapped(tree):
    """``tree_pack`` under ``vmap``: complex leaves [B, 2, ...]."""
    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"__c64__"}:
                f = np.asarray(node["__c64__"])
                return f[:, 0] + 1j * f[:, 1]
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, list):
            return [walk(v) for v in node]
        return np.asarray(node)
    return walk(tree)


def _wideband2(L):
    n = np.arange(L)
    wb = (0.1 * np.exp(2j * np.pi * 0.01 * n)).astype(np.complex64)
    return jnp.asarray(np.stack([wb.real, wb.imag]))


# the demod fields held on the chain sections (see the module docstring)
CHAIN_DEMOD = ("nco_phase", "freq", "slope", "coarse_y", "agc_ema",
               "grid_rate", "have_lock_refs", "mse")


def _demod(state, fields):
    return {f: np.asarray(getattr(state, f)) for f in fields}


def test_full_chain_pfb_step_matches_jax():
    from aero_tpu.channelizer.pfb import pfb_channelize_fused, pfb_init
    from aero_tpu.models.msk import make_config, msk_init, msk_step

    K, M = 128, 64
    cfg = make_config(24000.0, 1200.0)
    bins = np.linspace(2, K - 2, B).round().astype(np.int32)
    resid = np.linspace(-0.04, 0.04, B).astype(np.float32)

    def init(_):
        return tree_pack({
            "pfb": pfb_init(K), "phase": jnp.zeros((B,), jnp.float32),
            "demod": jax.vmap(lambda _: msk_init(cfg))(jnp.arange(B))})

    def step(stp, wideband2):
        st = tree_unpack(stp)
        new = dict(st)
        wideband = (wideband2[0] + 1j * wideband2[1]).astype(jnp.complex64)
        new["pfb"], z = pfb_channelize_fused(st["pfb"], wideband, K)
        zb = z[jnp.asarray(bins)]
        F = zb.shape[1]
        n = jnp.arange(F, dtype=jnp.float32)
        ramp = st["phase"][:, None] + jnp.asarray(resid)[:, None] * n
        osc = jnp.exp(2j * jnp.pi * jnp.mod(ramp, 1.0)).astype(jnp.complex64)
        new["phase"] = jnp.mod(st["phase"] + jnp.asarray(resid) * F, 1.0)
        audio = (zb * osc).real * 10.0
        new["demod"], out = jax.vmap(lambda s, x: msk_step(s, x, cfg))(
            st["demod"], audio)
        return tree_pack(new), out["soft_bits"]

    jn, jsoft = jax.jit(step)(jax.jit(init)(0), _wideband2(cfg.block_len * M))
    jn = tree_unpack(jn)
    state, wideband, tstep = tb.full_chain_pfb(B, "cpu")
    tn, tsoft = tstep(state, wideband)
    _check_soft(tsoft.numpy(), jsoft)
    _check_floats({"pfb": tn["pfb"].numpy(), "phase": tn["phase"].numpy(),
                   **_demod(tn["demod"], CHAIN_DEMOD)},
                  {"pfb": jn["pfb"], "phase": jn["phase"],
                   **_demod(jn["demod"], CHAIN_DEMOD)})


def test_cascade_chain_step_matches_jax():
    from aero_tpu.models.msk import make_config, msk_init, msk_step
    from aero_tpu.ops import HALFBAND_TAPS, hilbert_design
    from aero_tpu.ops.fir import (delay_apply, delay_init, fir_apply,
                                  fir_decimate_apply, fir_decimate_init,
                                  fir_init)
    from aero_tpu.ops.nco import nco_mix

    stages = 6
    cfg = make_config(24000.0, 1200.0)
    hb = HALFBAND_TAPS[11].astype(np.float32)
    hilb = hilbert_design(125).astype(np.float32)

    def chain_init(_):
        return {"nco": jnp.asarray(0.0, jnp.float32),
                "hb": [fir_decimate_init(11, dtype=jnp.complex64)
                       for _ in range(stages)],
                "hilb": fir_init(125), "dly": delay_init(62),
                "demod": msk_init(cfg)}

    def chain_step(stp, wideband2, f):
        st = tree_unpack(stp)
        new = dict(st)
        wideband = (wideband2[0] + 1j * wideband2[1]).astype(jnp.complex64)
        new["nco"], z = nco_mix(st["nco"], wideband, f)
        hbs = []
        for s in st["hb"]:
            s, z = fir_decimate_apply(s, z, jnp.asarray(hb), 2)
            hbs.append(s)
        new["hb"] = hbs
        new["hilb"], h = fir_apply(st["hilb"], z.imag, jnp.asarray(hilb))
        new["dly"], d = delay_apply(st["dly"], z.real)
        new["demod"], out = msk_step(st["demod"], (d - h) * 10.0, cfg)
        return tree_pack(new), out["soft_bits"]

    states = jax.jit(lambda: jax.vmap(
        lambda _: tree_pack(chain_init(0)))(jnp.arange(B)))()
    freqs = jnp.asarray(np.linspace(-0.4, 0.4, B, dtype=np.float32))
    jn, jsoft = jax.jit(lambda s, w: jax.vmap(
        chain_step, in_axes=(0, None, 0))(s, w, freqs))(
        states, _wideband2(cfg.block_len * 2 ** stages))
    jn = _unpack_vmapped(jn)
    state, wideband, tstep = tb.full_chain(B, "cpu")
    tn, tsoft = tstep(state, wideband)
    _check_soft(tsoft.numpy(), jsoft)
    got = {k: tn[k].numpy() for k in ("nco", "hilb", "dly")}
    want = {k: jn[k] for k in ("nco", "hilb", "dly")}
    for i in range(stages):
        got[f"hb{i}"], want[f"hb{i}"] = tn["hb"][i].numpy(), jn["hb"][i]
    _check_floats({**got, **_demod(tn["demod"], CHAIN_DEMOD)},
                  {**want, **_demod(jn["demod"], CHAIN_DEMOD)})


def test_demod_only_step_matches_jax():
    from aero_tpu.models.msk import make_config, msk_init, msk_modulate, \
        msk_step

    cfg = make_config(24000.0, 1200.0)
    rng = np.random.default_rng(0)
    one = msk_modulate(rng.integers(0, 2, 4000).astype(np.uint8), 24000.0,
                       1200.0)[: cfg.block_len]
    samples = jnp.asarray(np.tile(one, (B, 1)), jnp.float32)
    states = jax.jit(lambda: jax.vmap(
        lambda _: tree_pack(msk_init(cfg)))(jnp.arange(B)))()

    def one_fn(p, x):
        s2, out = msk_step(tree_unpack(p), x, cfg)
        return tree_pack(s2), out

    jn, jout = jax.jit(jax.vmap(one_fn))(states, samples)
    jn = _unpack_vmapped(jn)
    state, x, tstep = tb.demod_only(B, "cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(samples))
    tn, tsoft = tstep(state, x)
    _check_soft(tsoft.numpy(), jout["soft_bits"])
    _check_floats(_demod(tn, tn._fields), _demod(jn, tn._fields))


def test_oqpsk_demod_step_matches_jax():
    from aero_tpu.models.oqpsk import make_config, oqpsk_init, oqpsk_step

    cfg = make_config(48000.0, 10500.0)
    rng = np.random.default_rng(0)
    samples = jnp.asarray(
        rng.standard_normal((B, cfg.block_len)).astype(np.float32))
    states = jax.jit(lambda: jax.vmap(
        lambda _: tree_pack(oqpsk_init(cfg)))(jnp.arange(B)))()

    def one_fn(p, x):
        s2, out = oqpsk_step(tree_unpack(p), x, cfg)
        return tree_pack(s2), out

    jn, jout = jax.jit(jax.vmap(one_fn))(states, samples)
    jn = _unpack_vmapped(jn)
    state, x, tstep = tb.oqpsk_demod(B, "cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(samples))
    tn, tsoft = tstep(state, x)
    _check_soft(tsoft.numpy(), jout["soft_bits"])
    _check_floats(_demod(tn, tn._fields), _demod(jn, tn._fields))


def test_burst_window_matches_jax():
    from aero_tpu.models.burst_msk import burst_msk_window, make_config

    cfg = make_config(24000.0, 1200.0)
    rng = np.random.default_rng(0)
    samples = jnp.asarray(
        rng.standard_normal((B, cfg.window_len)).astype(np.float32))
    gate = jnp.ones((B, cfg.window_len), jnp.float32)
    jout = jax.jit(jax.vmap(lambda x, g: burst_msk_window(x, g, cfg)))(
        samples, gate)
    state, xg, tstep = tb.burst_window(B, "cpu")
    np.testing.assert_array_equal(xg[0].numpy(), np.asarray(samples))
    _, tout = tstep(state, xg)
    _check_soft(tout["soft"].numpy(), jout["soft"])
    _check_floats({k: tout[k].numpy() for k in
                   ("active", "freq_offset", "tone_quality")}, jout)


def test_latency_stream_equals_jax_construction():
    """bench.py:411-432 at two messages (the bench sends 24)."""
    from scipy.signal import resample_poly
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.protocol.framing import build_p_frames
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu

    n_msgs = 2
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    fields = []
    for k in range(n_msgs):
        ud = make_acars_userdata("2", "VH-LAT", "!", "AA", "M",
                                 f"LATENCY {k:04d}")
        sus = [append_crc16_bytes(b)
               for b in segment_isu(ud, 0x654321, 0x41)]
        sus += [fill] * (6 - len(sus))
        fields.append(b"".join(sus))
    bits = build_p_frames(fields, 1200, lead_frames=6)
    audio = np.asarray(msk_modulate(bits, 24000, 1200, freq=1000.0))
    bb = resample_poly(audio.astype(np.float64), 64, 1).astype(np.float32)
    delta = (1545002000 + 1 * 19000) - 1545000000
    t = np.arange(len(bb)) / 1536000.0
    wide = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)

    tbits, twide = tb.latency_stream(n_msgs)
    np.testing.assert_array_equal(tbits, bits)
    assert twide.dtype == np.complex64 and twide.shape == wide.shape
    assert np.abs(twide - wide).max() <= 1e-6


def test_viterbi_section_decodes_its_bits_on_the_twin():
    from aero_tpu.protocol.viterbi import conv_encode

    T = 64
    state, soft, step = tb.viterbi(B, T, "cpu")
    bits = tb.viterbi_bits(B, T)
    coded = np.stack([conv_encode(b) for b in bits]).astype(np.float32)
    np.testing.assert_array_equal(
        soft.numpy(), np.clip((coded * 2 - 1) * 127 + 128, 0, 255))
    _, dec = step(state, soft)
    np.testing.assert_array_equal(dec.numpy(), bits)
    rounds = tb.Rounds(1)
    m = tb.bench_viterbi(rounds, B=B, T=T, n_iter=1, device="cpu")
    rounds.run()
    assert math.isfinite(m["best"]) and m["best"] > 0


QUICK = ["--quick", "--device", "cpu", "--vfos", "2", "--n-iter", "1",
         "--repeats", "1"]


def test_main_prints_one_json_line_without_tpu_normalization(capsys):
    assert tb.main(QUICK) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    for k in ("metric", "value", "unit", "vs_baseline", "median",
              "spread_pct", "calibration_gflops", *tb.SECTION_KEYS):
        assert k in rec, k
    for k in ("cal_ref_gflops", "norm_factor", "value_norm", "norm"):
        assert k not in rec, k
    assert rec["unit"] == "MSamples/s/card"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert 0 < rec["calibration_gflops"] < 1.05 * tb.FP32_PEAK_GFLOPS
    # --quick runs the calibration and the headline only
    assert all(rec[k] is None for k in tb.SECTION_KEYS)
    assert rec["device"] == {"name": "cpu", "power_limit": None,
                             "torch": torch.__version__,
                             "cuda": torch.version.cuda}


def test_a_failing_section_fails_the_run(monkeypatch, capsys):
    def broken(B, device):
        raise RuntimeError("section broke")
    monkeypatch.setattr(tb, "full_chain_pfb", broken)
    with pytest.raises(RuntimeError, match="section broke"):
        tb.main(QUICK)
    assert capsys.readouterr().out == ""


def test_no_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs on it")
    res = subprocess.run([sys.executable, "-m", "aero_tpu_torch.bench",
                          "--quick"], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode != 0 and res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr
