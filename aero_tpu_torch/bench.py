"""Benchmarks of the port on one card.  Prints ONE JSON line to stdout
(headline: full-chain wideband throughput); the other sections' lines go
to stderr.

Counterpart of the JAX package's ``bench.py``, section for section, with
the same workload shapes, signals and round-robin repeats:

- ``calibration``: a fixed float32 2048^3 matmul (TF32 off), the card's
  fp32 rate on the day of the run;
- ``pfb_full_chain`` (headline): one WOLA polyphase filterbank pass over
  a 1.536 MS/s block (K=128), bin gather, residual mix and a batched
  ``msk_step`` over B VFOs;
- ``cascade_full_chain``: the reference's per-VFO tree (NCO mix, six
  halfband decimators, Hilbert USB demod, ``msk_step``);
- ``demod_only``, ``oqpsk_demod``, ``burst_window``: the demod banks;
- ``cuda_viterbi``: the batched soft Viterbi through the CUDA kernel
  (``csrc/viterbi.cu``), checked bit for bit against the encoded bits;
- ``fused_station`` (int4 and int2): the realtime factor of the
  production ``FusedStation``;
- ``fused_station_latency``: emit time minus arrival time of ACARS
  messages at real-time pacing.

The two station sections run the station as it runs by default, its
device step a CUDA-graph replay per block, and again inside
``device.disable_graphs()`` (the step's ops one by one); the eager
figures are printed beside the graphed ones on stderr and the JSON line
carries the graphed ones.

Run on the card (the default) or, small, on the CPU:

    python -m aero_tpu_torch.bench
    python -m aero_tpu_torch.bench --quick --device cpu --vfos 2 \\
        --n-iter 1 --repeats 1

Where it differs from ``bench.py``: a failing section raises and the run
exits non-zero (nothing is caught and passed over); there is no
cross-round normalization, because the reference rate it divided by was
a TPU's; state stays in complex tensors (no packing at a boundary); the
JSON line carries the card's name and power limit and the torch and CUDA
versions.  Timing synchronizes the card where the JAX bench blocks on
its results, and every step is warmed before it is timed (the first
block pays the CUDA, cuFFT and cuDNN set-up).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.channelizer.pfb import pfb_channelize_fused, pfb_init
from aero_tpu_torch.device import (disable_graphs, resolve_device,
                                   set_fp32_precision)
from aero_tpu_torch.models import burst_msk, msk, oqpsk
from aero_tpu_torch.ops import viterbi_kernel as vk
from aero_tpu_torch.ops.design import HALFBAND_TAPS, hilbert_design
from aero_tpu_torch.ops.fir import (delay_apply, delay_init, fir_apply,
                                    fir_decimate_apply, fir_decimate_init,
                                    fir_init)
from aero_tpu_torch.ops.nco import cis, fused_mul_add, nco_mix
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import build_p_frames
from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu_torch.protocol.viterbi import conv_encode
from aero_tpu_torch.runtime.fused_station import FusedStation

FS_WB = 1536000.0
# the H100's float32 rate outside the tensor cores (NVIDIA's data sheet,
# SXM part at 700 W); a calibration above 105% of it means TF32 crept in
FP32_PEAK_GFLOPS = 67000.0
# the JSON line's section keys; a section the run skips (--quick) is null
SECTION_KEYS = ("cascade_best_msps", "demod_best_msps", "oqpsk_best_msps",
                "burst_best_msps", "viterbi_best_mbps",
                "fused_station_rt_best", "fused_station_int2_rt_best",
                "latency_bps8_p50_ms", "latency_bps8_p99_ms",
                "latency_bps1_p50_ms", "latency_bps1_p99_ms", "latency_msgs")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Rounds:
    """Warmed, timed batches repeated round-robin: one repeat of EACH
    metric per round (A,B,C,...,A,B,C,...), so a transient stall of the
    host or the card degrades every metric slightly instead of wiping one
    metric's repeat set.

    ``measure`` registers a batch and returns a dict that ``run`` fills:
    ``best`` is work over the least time (the speed-of-light estimate
    under outside noise), ``median`` work over the median time, and
    ``spread_pct`` the range of the times over their median."""

    def __init__(self, repeats: int = 7):
        self.repeats = repeats
        self._pending = []

    def measure(self, run_batch, work_per_batch) -> dict:
        m = {"best": 0.0, "median": 0.0, "spread_pct": 0.0}
        self._pending.append((run_batch, work_per_batch, m))
        return m

    def run(self) -> None:
        times = [[] for _ in self._pending]
        for _ in range(self.repeats):
            for i, (batch, _, _) in enumerate(self._pending):
                times[i].append(batch())
        for ts, (_, work, m) in zip(times, self._pending):
            ts.sort()
            med = ts[len(ts) // 2]
            m.update(best=work / ts[0], median=work / med,
                     spread_pct=100.0 * (ts[-1] - ts[0]) / med)
        self._pending.clear()


def _fmt(m, scale=1e6):
    return (f"{m['best']/scale:.1f} best / {m['median']/scale:.1f} median "
            f"(spread {m['spread_pct']:.0f}%)")


def _warmed_batch(step, state, inputs, n_iter: int, device):
    """Run ``step`` once outside the timed region, then return (a batch
    that times ``n_iter`` steps carrying the state and ends in a
    synchronize, the warm call's output)."""
    state, out = step(state, inputs)
    _sync(device)

    def batch():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n_iter):
            state, _ = step(state, inputs)
        _sync(device)
        return time.perf_counter() - t0

    return batch, out


def _tone(n: int) -> np.ndarray:
    """The wideband test signal: a complex exponential keeps every demod
    branch active without mattering for throughput."""
    k = np.arange(n)
    return (0.1 * np.exp(2j * np.pi * 0.01 * k)).astype(np.complex64)


# ---- section builders: (state, inputs, step), step(state, inputs) ->
# (state, output); the tests hold each step against the JAX bench's ----

def calibration(device):
    rng = np.random.default_rng(42)
    a, b = (torch.from_numpy(rng.standard_normal((2048, 2048)).astype(
        np.float32)).to(device) for _ in range(2))
    return None, (a, b), lambda state, ab: (state, ab[0] @ ab[1])


def full_chain_pfb(B: int, device):
    """WOLA filterbank (K=128, 2x oversampled) over the 1.536 MS/s block,
    the B VFOs' bins, a residual mix to real audio, batched ``msk_step``."""
    out_rate = 24000.0
    K = int(2 * FS_WB / out_rate)
    cfg = msk.make_config(out_rate, 1200.0)
    bins = torch.from_numpy(
        np.linspace(2, K - 2, B).round().astype(np.int64)).to(device)
    resid = torch.from_numpy(
        np.linspace(-0.04, 0.04, B).astype(np.float32)).to(device)
    state = {"pfb": pfb_init(K, device=device),
             "phase": torch.zeros(B, dtype=torch.float32, device=device),
             "demod": msk.msk_init(cfg, B, device)}
    wideband = torch.from_numpy(_tone(cfg.block_len * (K // 2))).to(device)

    def step(st, x):
        pfb, z = pfb_channelize_fused(st["pfb"], x, K)
        zb = z[bins]                                             # [B, F]
        F = zb.shape[1]
        n = torch.arange(F, dtype=torch.float32, device=zb.device)
        # the ramps round once, as XLA's CPU compiler computes them
        ramp = fused_mul_add(resid[:, None], n, st["phase"][:, None])
        osc = cis((2.0 * math.pi) * torch.remainder(ramp, 1.0))
        phase = torch.remainder(fused_mul_add(resid, F, st["phase"]), 1.0)
        audio = (zb * osc).real * 10.0
        demod, out = msk.msk_step(st["demod"], audio, cfg)
        return {"pfb": pfb, "phase": phase, "demod": demod}, out["soft_bits"]

    return state, wideband, step


def full_chain(B: int, device):
    """The reference's per-VFO tree: NCO mix, six 2:1 halfband stages
    (1536000 / 2^6 = 24000), Hilbert USB demod, batched ``msk_step``."""
    stages = 6
    cfg = msk.make_config(24000.0, 1200.0)
    hb = torch.from_numpy(HALFBAND_TAPS[11].astype(np.float32)).to(device)
    hilb = torch.from_numpy(hilbert_design(125).astype(np.float32)).to(device)
    state = {"nco": torch.zeros(B, dtype=torch.float32, device=device),
             "hb": [fir_decimate_init(11, (B,), torch.complex64, device)
                    for _ in range(stages)],
             "hilb": fir_init(125, (B,), device=device),
             "dly": delay_init(62, (B,), device=device),
             "demod": msk.msk_init(cfg, B, device)}
    freqs = torch.from_numpy(
        np.linspace(-0.4, 0.4, B, dtype=np.float32)).to(device)
    wideband = torch.from_numpy(_tone(cfg.block_len * 2 ** stages)).to(device)

    def step(st, x):
        nco, z = nco_mix(st["nco"], x, freqs)
        hbs = []
        for s in st["hb"]:
            s, z = fir_decimate_apply(s, z, hb, 2)
            hbs.append(s)
        hs, h = fir_apply(st["hilb"], z.imag, hilb)
        ds, d = delay_apply(st["dly"], z.real)
        demod, out = msk.msk_step(st["demod"], (d - h) * 10.0, cfg)
        return ({"nco": nco, "hb": hbs, "hilb": hs, "dly": ds,
                 "demod": demod}, out["soft_bits"])

    return state, wideband, step


def demod_only(B: int, device):
    """Batched ``msk_step`` on one modulated block tiled over B VFOs."""
    cfg = msk.make_config(24000.0, 1200.0)
    rng = np.random.default_rng(0)
    one = msk.msk_modulate(rng.integers(0, 2, 4000).astype(np.uint8),
                           24000.0, 1200.0)[: cfg.block_len]
    samples = torch.from_numpy(
        np.tile(one, (B, 1)).astype(np.float32)).to(device)

    def step(st, x):
        st, out = msk.msk_step(st, x, cfg)
        return st, out["soft_bits"]

    return msk.msk_init(cfg, B, device), samples, step


def oqpsk_demod(B: int, device):
    """Batched ``oqpsk_step`` (10500 bps, 48 kS/s) on seeded noise."""
    cfg = oqpsk.make_config(48000.0, 10500.0)
    rng = np.random.default_rng(0)
    samples = torch.from_numpy(
        rng.standard_normal((B, cfg.block_len)).astype(np.float32)).to(device)

    def step(st, x):
        st, out = oqpsk.oqpsk_step(st, x, cfg)
        return st, out["soft_bits"]

    return oqpsk.oqpsk_init(cfg, B, device), samples, step


def burst_window(B: int, device):
    """``burst_msk_window`` on B candidate windows of seeded noise."""
    cfg = burst_msk.make_config(24000.0, 1200.0)
    rng = np.random.default_rng(0)
    samples = torch.from_numpy(
        rng.standard_normal((B, cfg.window_len)).astype(np.float32)).to(device)
    gate = torch.ones((B, cfg.window_len), dtype=torch.float32, device=device)

    def step(st, xg):
        return st, burst_msk.burst_msk_window(xg[0], xg[1], cfg)

    return None, (samples, gate), step


def viterbi_bits(B: int, T: int) -> np.ndarray:
    """The random bits the Viterbi section encodes (seeded)."""
    return np.random.default_rng(0).integers(0, 2, size=(B, T)).astype(
        np.uint8)


def viterbi(B: int, T: int, device):
    """Hard-decision soft bytes (1 or 255) of the conv-encoded random bits;
    the step decodes them through ``viterbi_decode_soft_cuda``."""
    coded = np.stack([conv_encode(b) for b in viterbi_bits(B, T)])
    soft = np.clip((coded.astype(np.float32) * 2 - 1) * 127 + 128, 0, 255)
    soft = torch.from_numpy(soft.astype(np.uint8)).to(device)
    return None, soft, lambda st, s: (st, vk.viterbi_decode_soft_cuda(s))


# ---- sections ----

def bench_calibration(rounds: Rounds, n_iter=30, device="cuda"):
    """The card's fp32 matmul rate on the day of the run (a fixed
    2048^3 workload, TF32 off)."""
    dev = resolve_device(device)
    state, ab, step = calibration(dev)
    batch, _ = _warmed_batch(step, state, ab, n_iter, dev)
    return rounds.measure(batch, n_iter * 2 * 2048 ** 3)


def bench_full_chain(rounds: Rounds, B=50, n_iter=10, device="cuda"):
    dev = resolve_device(device)
    state, wideband, step = full_chain(B, dev)
    batch, _ = _warmed_batch(step, state, wideband, n_iter, dev)
    return rounds.measure(batch, n_iter * wideband.shape[0]), B


def bench_full_chain_pfb(rounds: Rounds, B=50, n_iter=10, device="cuda"):
    dev = resolve_device(device)
    state, wideband, step = full_chain_pfb(B, dev)
    batch, _ = _warmed_batch(step, state, wideband, n_iter, dev)
    return rounds.measure(batch, n_iter * wideband.shape[0]), B


def bench_demod_only(rounds: Rounds, B=128, n_iter=60, device="cuda"):
    dev = resolve_device(device)
    state, samples, step = demod_only(B, dev)
    batch, _ = _warmed_batch(step, state, samples, n_iter, dev)
    return rounds.measure(batch, n_iter * samples.numel())


def bench_oqpsk_demod(rounds: Rounds, B=64, n_iter=60, device="cuda"):
    """OQPSK 10500 (C-band P channel) batched demod bank."""
    dev = resolve_device(device)
    state, samples, step = oqpsk_demod(B, dev)
    batch, _ = _warmed_batch(step, state, samples, n_iter, dev)
    return rounds.measure(batch, n_iter * samples.numel())


def bench_burst_window(rounds: Rounds, B=64, n_iter=60, device="cuda"):
    """Burst MSK window demod (R/T channels): B candidate windows at once."""
    dev = resolve_device(device)
    state, sg, step = burst_window(B, dev)
    batch, _ = _warmed_batch(step, state, sg, n_iter, dev)
    return rounds.measure(batch, n_iter * sg[0].numel())


def bench_viterbi(rounds: Rounds, B=128, T=2496, n_iter=40, device="cuda"):
    """The batched soft Viterbi (the CUDA kernel on a card, its plain twin
    on the CPU).  The warm call must decode the random bits exactly
    (AssertionError otherwise)."""
    dev = resolve_device(device)
    state, soft, step = viterbi(B, T, dev)
    batch, dec = _warmed_batch(step, state, soft, n_iter, dev)
    if not np.array_equal(dec.cpu().numpy(), viterbi_bits(B, T)):
        raise AssertionError(f"the Viterbi decode at B={B} T={T} differs "
                             "from the encoded bits")
    return rounds.measure(batch, n_iter * B * T)


def bank_ini(B: int) -> str:
    """The production 50-VFO MSK-1200 bank's settings (VFOs every 19 kHz
    from 1545.002 MHz, 1.536 MS/s), cut to B VFOs."""
    vfos = "".join(
        f"{i+1}\\frequency={1545002000 + i*19000}\n{i+1}\\data_rate=1200\n"
        f"{i+1}\\topic=V{i}\n{i+1}\\gain=100\n" for i in range(B))
    return (f"[General]\nsample_rate=1536000\ncenter_frequency=1545000000\n"
            f"[vfos]\nsize={B}\n{vfos}")


def bench_fused_station(B=50, n_iter=16, ingest="int4", blocks_per_step=8,
                        pipeline_depth=2, repeats=5, device="cuda"):
    """END-TO-END: quantized ingest -> device chain -> host framers, via
    the production FusedStation, as x real time, in throughput mode
    (8 blocks per step, 2 steps in flight)."""
    st = FusedStation(load_ini(bank_ini(B), is_text=True),
                      ingest_dtype=ingest, blocks_per_step=blocks_per_step,
                      pipeline_depth=pipeline_depth,
                      device=resolve_device(device))
    rng = np.random.default_rng(0)
    blk = st.quantize((0.02 * (rng.standard_normal((st.block_len, 2))
                               @ [1, 1j])).astype(np.complex64))
    for _ in range(2 * blocks_per_step):
        st.process(blk)
    st.flush()
    rates = []
    for _ in range(repeats):
        st.stats.wideband_samples = 0
        st.stats.wall_seconds = 0.0
        for _ in range(n_iter):
            st.process(blk)
        st.flush()
        rates.append(st.stats.realtime_factor / FS_WB)
    rates.sort()
    med = rates[len(rates) // 2]
    return {"best": rates[-1], "median": med,
            "spread_pct": 100.0 * (rates[-1] - rates[0]) / max(med, 1e-9)}, B


def latency_stream(n_msgs: int):
    """Back-to-back single-message P frames (message k's SUs padded with
    fill SUs to the 6-SU infofield) at 1200 bps on VFO 1 of the bank:
    (the frame bits, the 1.536 MS/s complex wideband stream)."""
    from scipy.signal import resample_poly

    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    fields = []
    for k in range(n_msgs):
        ud = make_acars_userdata("2", "VH-LAT", "!", "AA", "M",
                                 f"LATENCY {k:04d}")
        sus = [append_crc16_bytes(b)
               for b in segment_isu(ud, 0x654321, 0x41)]
        assert len(sus) <= 6
        sus += [fill] * (6 - len(sus))
        fields.append(b"".join(sus))
    bits = build_p_frames(fields, 1200, lead_frames=6)
    audio = np.asarray(msk.msk_modulate(bits, 24000, 1200, freq=1000.0))
    bb = resample_poly(audio.astype(np.float64), 64, 1).astype(np.float32)
    delta = (1545002000 + 1 * 19000) - 1545000000
    t = np.arange(len(bb)) / FS_WB
    wide = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)
    return bits, wide


def bench_fused_station_latency(B=50, n_msgs=24, device="cuda"):
    """END-TO-END LATENCY: wideband-sample arrival -> ACARS emit, real-time
    paced.  blocks_per_step=8 / pipeline_depth=2 (the throughput shape)
    holds results for up to 8 x 667 ms of batch fill plus two steps in
    flight; blocks_per_step=1 / pipeline_depth=0 drains every block.

    A mapping pass (1 block per step, depth 0, unpaced) records for each
    message the block whose processing emitted it, the block holding the
    last soft bit the deframer needed; it must decode at least half the
    messages (RuntimeError otherwise).  The paced passes feed block i at
    its arrival time (i+1) x block_len/fs and report p50/p99 of emit time
    minus the arrival of the needed block."""
    dev = resolve_device(device)
    cfg = load_ini(bank_ini(B), is_text=True)
    _, wide = latency_stream(n_msgs)
    st0 = FusedStation(cfg, blocks_per_step=1, pipeline_depth=0, device=dev)
    blk_len = st0.block_len
    wide = np.concatenate(
        [wide, np.zeros((-len(wide)) % blk_len + 2 * blk_len,
                        np.complex64)])
    blocks = [wide[i:i + blk_len] for i in range(0, len(wide), blk_len)]
    block_dur = blk_len / FS_WB

    def msg_index(item):
        return int(item.message.split()[-1])

    need_block = {}
    cur = [0]
    st0.on_acars = lambda v, it: need_block.setdefault(msg_index(it),
                                                       cur[0])
    for i, b in enumerate(blocks):
        cur[0] = i
        st0.process(b)
    st0.flush()
    if len(need_block) < max(2, n_msgs // 2):
        raise RuntimeError(f"latency mapping decoded only "
                           f"{len(need_block)}/{n_msgs} messages")

    def paced_pass(blocks_per_step, pipeline_depth):
        lats = {}
        st = FusedStation(cfg, blocks_per_step=blocks_per_step,
                          pipeline_depth=pipeline_depth, device=dev)
        arrive = {}

        def on_acars(v, it):
            k = msg_index(it)
            if k in need_block and k not in lats:
                lats[k] = time.perf_counter() - arrive[need_block[k]]

        st.on_acars = on_acars
        # warm every step shape the paced loop uses (the full batch and
        # the flush remainder) outside the timed region
        for _ in range(blocks_per_step):
            st.process(np.zeros(blk_len, np.complex64))
        st.flush()
        rem = len(blocks) % blocks_per_step
        if rem:
            for _ in range(rem):
                st.process(np.zeros(blk_len, np.complex64))
            st.flush()
        t_start = time.perf_counter()
        for i, b in enumerate(blocks):
            target = t_start + (i + 1) * block_dur   # block fully arrived
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
            arrive[i] = max(now, target)
            st.process(b)
        st.flush()
        v = sorted(1e3 * x for x in lats.values())
        if not v:
            raise RuntimeError("latency pass decoded nothing")
        return v[len(v) // 2], v[min(len(v) - 1, int(0.99 * len(v)))]

    p50_tp, p99_tp = paced_pass(8, 2)     # throughput shape (RT bench)
    p50_lat, p99_lat = paced_pass(1, 0)   # latency shape
    return {"bps8": (p50_tp, p99_tp), "bps1": (p50_lat, p99_lat),
            "n": len(need_block)}


def card_info(device) -> dict:
    """The device the run measured: a card's name and power limit as
    nvidia-smi gives them, and the torch and CUDA versions."""
    dev = torch.device(device)
    name, power = "cpu", None
    if dev.type == "cuda":
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        name, power = (s.strip() for s in lines[idx].rsplit(",", 1))
    return {"name": name, "power_limit": power, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def _sizes(args, **defaults) -> dict:
    """A section's size arguments: its defaults (JAX's), with B and n_iter
    replaced where the command line gives them."""
    if args.vfos is not None and "B" in defaults:
        defaults["B"] = args.vfos
    if args.n_iter is not None and "n_iter" in defaults:
        defaults["n_iter"] = args.n_iter
    return defaults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aero_tpu_torch.bench",
        description="The port's benchmarks on one card: one JSON line on "
                    "stdout, one line per section on stderr.")
    ap.add_argument("--quick", action="store_true",
                    help="calibration and the headline pfb_full_chain only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    ap.add_argument("--vfos", type=int, default=None,
                    help="every section's B (default: each section's own)")
    ap.add_argument("--n-iter", type=int, default=None,
                    help="every section's steps per timed batch")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed batches per section (default 7; the fused "
                         "station's 5)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_fp32_precision()
    info = card_info(dev)
    print(f"device: {info['name']}, {info['power_limit']}; torch "
          f"{info['torch']}, cuda {info['cuda']}", file=sys.stderr)
    full = not args.quick
    extras = dict.fromkeys(SECTION_KEYS)
    rounds = Rounds(args.repeats or 7)
    launches = vk.LAUNCHES

    cal = bench_calibration(rounds, device=dev, **_sizes(args, n_iter=30))
    chain, B = bench_full_chain_pfb(rounds, device=dev,
                                    **_sizes(args, B=50, n_iter=10))
    if full:
        casc, _ = bench_full_chain(rounds, device=dev,
                                   **_sizes(args, B=50, n_iter=10))
        demod = bench_demod_only(rounds, device=dev,
                                 **_sizes(args, B=128, n_iter=60))
        oq = bench_oqpsk_demod(rounds, device=dev,
                               **_sizes(args, B=64, n_iter=60))
        bw = bench_burst_window(rounds, device=dev,
                                **_sizes(args, B=64, n_iter=60))
        vit = bench_viterbi(rounds, device=dev,
                            **_sizes(args, B=128, n_iter=40))
    # all metrics repeat round-robin so a stall cannot wipe one
    rounds.run()

    cal_gflops = cal["best"] / 1e9
    print(f"calibration: {_fmt(cal, 1e9)} GFLOP/s fixed f32 2048^3 matmul "
          f"(TF32 off; the card's fp32 peak is {FP32_PEAK_GFLOPS:.0f})",
          file=sys.stderr)
    if cal_gflops >= 1.05 * FP32_PEAK_GFLOPS:
        raise AssertionError(f"calibration read {cal_gflops:.1f} GFLOP/s, "
                             "above the card's fp32 peak: TF32 is on")
    stations = chain["best"] / FS_WB
    print(f"pfb_full_chain: {_fmt(chain)} MS/s wideband, {stations:.1f} "
          f"stations x {B} VFOs per card", file=sys.stderr)
    if full:
        print(f"cascade_full_chain: {_fmt(casc)} MS/s wideband, "
              f"{casc['best'] / FS_WB:.1f} stations (reference-shaped "
              f"tree)", file=sys.stderr)
        print(f"demod_only: {_fmt(demod)} MS/s audio", file=sys.stderr)
        print(f"oqpsk_demod: {_fmt(oq)} MS/s audio (10500 bps C-band)",
              file=sys.stderr)
        print(f"burst_window: {_fmt(bw)} MS/s audio (batched R/T "
              f"candidate windows)", file=sys.stderr)
        print(f"cuda_viterbi: {_fmt(vit)} Mbit/s decoded (the encoded "
              f"bits exactly)", file=sys.stderr)
        extras.update(cascade_best_msps=casc["best"] / 1e6,
                      demod_best_msps=demod["best"] / 1e6,
                      oqpsk_best_msps=oq["best"] / 1e6,
                      burst_best_msps=bw["best"] / 1e6,
                      viterbi_best_mbps=vit["best"] / 1e6)

        # last: end to end
        fused = _sizes(args, B=50, n_iter=16)
        reps = args.repeats or 5
        rtf, B2 = bench_fused_station(device=dev, repeats=reps, **fused)
        rtf2, _ = bench_fused_station(ingest="int2", device=dev,
                                      repeats=reps, **fused)
        lat = bench_fused_station_latency(B=B2, device=dev)
        with disable_graphs():
            eager = bench_fused_station(device=dev, repeats=reps, **fused)[0]
            eager2 = bench_fused_station(ingest="int2", device=dev,
                                         repeats=reps, **fused)[0]
            lat_e = bench_fused_station_latency(B=B2, device=dev)
        print(f"fused_station: {rtf['best']:.1f}x best / "
              f"{rtf['median']:.1f}x median real time END TO END "
              f"({B2} VFOs, int4 ingest, incl. host framing and host-card "
              f"transfers; eager step {eager['best']:.1f}x / "
              f"{eager['median']:.1f}x)", file=sys.stderr)
        print(f"fused_station_int2: {rtf2['best']:.1f}x best / "
              f"{rtf2['median']:.1f}x median real time END TO END "
              f"(2-bit sign-magnitude ingest, 0.5 B/sample to the card; "
              f"eager step {eager2['best']:.1f}x / "
              f"{eager2['median']:.1f}x)", file=sys.stderr)
        (p50_tp, p99_tp), (p50_lo, p99_lo) = lat["bps8"], lat["bps1"]
        (e50_tp, e99_tp), (e50_lo, e99_lo) = lat_e["bps8"], lat_e["bps1"]
        print(f"fused_station_latency: p50 {p50_tp:.0f} ms / p99 "
              f"{p99_tp:.0f} ms ingest->ACARS at blocks_per_step=8 "
              f"depth=2 (throughput shape); p50 {p50_lo:.1f} ms / p99 "
              f"{p99_lo:.1f} ms at blocks_per_step=1 depth=0 (latency "
              f"shape; {lat['n']} msgs, real-time paced, {B2} VFOs; "
              f"p99 = worst observed at this sample count); eager step "
              f"p50 {e50_tp:.0f} / p99 {e99_tp:.0f} ms and p50 "
              f"{e50_lo:.1f} / p99 {e99_lo:.1f} ms", file=sys.stderr)
        extras.update(fused_station_rt_best=rtf["best"],
                      fused_station_int2_rt_best=rtf2["best"],
                      latency_bps8_p50_ms=p50_tp, latency_bps8_p99_ms=p99_tp,
                      latency_bps1_p50_ms=p50_lo, latency_bps1_p99_ms=p99_lo,
                      latency_msgs=lat["n"])

    print(json.dumps({
        "metric": "full_chain_wideband_throughput",
        "value": chain["best"] / 1e6,
        "unit": "MSamples/s/card",
        "vs_baseline": stations,
        "median": chain["median"] / 1e6,
        "spread_pct": chain["spread_pct"],
        **extras,
        "calibration_gflops": cal_gflops,
        "viterbi_launches": vk.LAUNCHES - launches,
        "device": info,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
