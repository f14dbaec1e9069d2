#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``aero_tpu_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; the stations'
and banks' device steps run as CUDA-graph replays, the port's default):

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; CUDA must be available; full-fp32 math is set; the
   port's native host libraries (g++ from aero_tpu_torch/native) must
   build, and their files are logged.
2. The CUDA Viterbi kernel (built by nvcc for sm_90a from
   aero_tpu_torch/csrc/viterbi.cu) against its plain-torch twin on the
   card, bit-exact on uint8 soft bytes, at the 1200 bps frame shape (B=64,
   T=631), the 10500 shape (B=256, T=2551) and the R/T checkpoint shapes
   (B=1, T=160, 352, 1600: R 5 rows, T 11 rows, MSK T 50 rows), on
   integral, uniform random, extreme (0/255) and all-tie (128) inputs,
   and at (1, 1), (130, 95) and the largest T the wrapper takes.  Each
   main shape is timed after warm-up two ways (tools/viterbi_time.py):
   the wrapper called back to back (the kernels line's "ms") and the
   device time in a CUDA graph ("device_ms"), beside its bound (the
   larger of its operations at the card's fp32 rate and its bytes at the
   memory rate), the share of the bound and the time per trellis step.
3. The L-band path: ``aero_tpu_torch.runtime.station_main.main``
   in-process with ``--backend fused --batch-framing --device cuda
   --ingest-dtype int4`` on the 50-VFO MSK-1200 bank (1.536 MS/s at
   1545 MHz, VFOs every 19 kHz, 1,024,000-sample blocks) plus the two
   burst MSK-1200 R-channel watchers of configs/aor_w_54_lband.ini in free
   raster slots, over 14 blocks of wideband IQ that carry distinct ACARS
   messages on 4 VFOs and one R burst on one watcher, in noise.  Every
   planted message and the R packet must come out, with no bad SU on the
   content VFOs; the kernel's launch count must be > 0; the station's
   state tensors must live on the card.
4. One step of that station on the card against the same step on the
   host CPU (same state, same block): the packed buffers must agree
   within the limits of tests/test_torch_cuda.py:check_packed.
5. The C-band path: ``station_main.main`` with the same flags plus
   ``--voice-out`` on a 44-VFO bank at 1.536 MS/s (48 kS/s channels,
   filterbank K=64, 512,000-sample blocks): 32 OQPSK 10500 P channels,
   8 OQPSK 8400 C channels and 4 burst OQPSK 10500 T watchers, 34 kHz
   apart, over 27 blocks (9 s): distinct ACARS on 2 P VFOs, two C frames
   of known voice and signalling on 1 C VFO, one T burst carrying ACARS
   on 1 T watcher, noise on every VFO.  Every planted message must come
   out on its VFO (no bad SU on the content P VFOs), the voice file must
   hold the planted 300-byte frames in order, the kernel must have been
   launched by the P bank, by the C bank and by the R/T framers (counted
   apart), and
   the station's state tensors must live on the card.
6. One step of the C-band station on the card against the same step on
   the host CPU, as phase 4.
7. The classic path: ``station_main.main`` with ``--backend tree --device
   cuda`` on configs/aor_w_54_lband.ini, unmodified (one main VFO with
   its nibble topic, 24 P subs at 600/1200 bps on a 2.5 kHz raster, 2
   burst R watchers; 384,000-sample blocks), over the 32-block capture of
   tests/torch_lband54.py: ACARS on 4 subs (600 and 1200) and one R
   burst on RCH01.  The burst is planted 30 times stronger than the P
   signals, a workaround and not real traffic: at the file's sub gain the
   watchers decode no R burst at the P signals' level (see that module).
   Every planted message and the R packet must come out, with no bad SU
   on the content VFOs; the R/T framers must have launched the kernel;
   the station's carries must live on the card.
   Then, on 12 warm blocks, the mean time per block of the channelizer,
   the demod banks and the host framing, and under torch.profiler the
   device operations per block and the device's idle share; and one
   block through the channelizer and every bank on the card against the
   host CPU from the same state (carried by a checkpoint).
8. Checkpoints on the card: the phase 3 capture (fused bank) cut after 5
   blocks and the phase 7 capture (classic bank) cut after 16, each run
   as two ``station_main --checkpoint`` runs: the second resumes, and
   the ACARS of both, per VFO in order, equal the uninterrupted run's.
9. ``station_main --backend pfb`` (the classic station on the polyphase
   filterbank) on the phase 3 capture and bank: every planted message on
   its VFO, no bad SU there.
10. Multi-device (``aero_tpu_torch.parallel``) on a mesh whose shards are
    dealt over the visible cards (on one card, every shard on cuda:0;
    the script prints which): the three time-shard functions against
    their unsharded pass on one L-band block (within 1e-5 of the peak);
    phase 3 again with the station sharded over two shards
    (``FusedStation.shard`` before the first block): phase 3's ACARS, its
    R packet, the Viterbi kernel launched, and the per-block time and
    device idle share of both stations on the same warm blocks; the
    sharded station's checkpoint loaded unsharded and re-sharded, the
    next block's telemetry against it; ``Station(mesh=...)`` with three
    shards on the phase 7 capture: phase 7's ACARS and R packet, and
    phase 7's stage times.
11. Two ``python -m aero_tpu_torch.parallel.selftest`` processes of two
    shards each (NCCL, a card per process, with two or more cards; else
    gloo, both on cuda:0): every ``MH-*-OK`` line of both.
12. The reference's envelopes free-running on the card, from
    tests/torch_impair.py (JAX's streams, built on the port): the MSK
    150 Hz/s ramp (61 s) and 500 ppm, the OQPSK 240 Hz/s ramp (62 s) and
    +100 ppm, MSK under ramp, ppm and phase noise at once, burst R under
    them, the FusedStation at 400 ppm and its C channel at 100 ppm, and
    the classic Station at 400 ppm: one line each with the frames (or
    messages) recovered, JAX's threshold (tests/test_impairments.py) and
    the seconds; each must meet its threshold, every demodulator and
    station must hold its state on the card.  Then the fused soak of
    tests/test_soak.py (int16 ingest, batched host framing, the hunter,
    a T burst, a checkpoint restore halfway): all three messages, the
    hunted VFO within 200 Hz of 2500.  Then tools/torch_parity_check.py
    --device cuda on the three fixtures of tests/fixtures: 100% on the
    synthetic ones, >= 95% on the jaero drill.  The kernel's launches in
    this phase (the R/T framers, the soak's batched framing) join the
    kernels line's.
13. ``python -m aero_tpu_torch.bench`` in full on cuda, as a subprocess
    (the port's counterpart of bench.py: calibration, the PFB and cascade
    chains, the MSK, OQPSK and burst demods, the CUDA Viterbi at B=128,
    T=2496, the fused station's realtime factor at int4 and int2, emit
    latency at real-time pacing): exit code 0, every section's best
    positive and finite, the calibration below 105% of the card's fp32
    peak (no TF32), at least 12 of the 24 latency messages mapped (JAX's
    gate); the bench asserts that the kernel decoded its random bits
    exactly.  Its JSON line is printed prefixed ``bench:``, its Viterbi
    launches join the kernels line's; then the kernel at the bench's
    shape is timed as in phase 2, beside its bound and plain torch, and
    the fused station's realtime factor is read at 8 blocks per step with
    2 and 0 steps in flight and at 1 block per step, in turns.

14. The device steps as CUDA-graph replays (``aero_tpu_torch/utils/
    graphs.py``; every phase above runs them graphed, the default): the
    stations' steps, and the steps of their drains and host loops (the
    framer banks' batched P decodes, whose replays launch the Viterbi
    kernel and count its launches, the burst watchers' detection
    statistics and window demods), the filterbank backend's groups and
    the single-VFO demodulators.  The L band, the C band, the classic
    54W, the ``--backend pfb`` station of phase 9, the L band over two
    shards, the bench's station at 8 blocks per step with 2 steps in
    flight and ``decode_main`` on the three fixtures (a retune after
    block 3; the parity of phase 12), each run eager
    (``device.disable_graphs()``), graphed and eager again on the same
    input; the graphed run must give the eager run's packed buffers,
    telemetry, batched decodes, burst outputs, ACARS, voice file,
    channelizer payloads, bank outputs and demodulated blocks byte for
    byte (unless the two eager runs already differ), with one capture
    per device step object (the classic hunters' and the decoder's
    retunes capture nothing new) and one per key of each drain step.
    Then each path's times in both modes in turns (eager, graphed,
    graphed, eager): the serial block's stages with the drain split by
    stage (the tracer's self times: D2H, batched decode, burst watchers,
    UW search, frame preparation, frame bookkeeping, SU dispatch, the
    drain's own), the step alone (host enqueue, CUDA events, device
    operations, graph launches, device time, idle share) and the
    captures, the filterbank station's channelizer and the decoder's
    block.

The last two lines of standard output are the kernels' JSON record and the
result line ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, the script fails before printing a
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from aero_tpu_torch import bench, convert, native
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.channelizer.pfb import PfbChannelizer, pfb_channelize
from aero_tpu_torch.device import (disable_graphs, graphs_enabled,
                                   set_fp32_precision)
from aero_tpu_torch.models.msk import msk_modulate
from aero_tpu_torch.ops import viterbi_kernel as vk
from aero_tpu_torch.ops.design import HALFBAND_TAPS
from aero_tpu_torch.ops.fir import fir_apply, fir_decimate_apply, fir_init
from aero_tpu_torch.parallel.mesh import Mesh, gather, shard_over_vfo
from aero_tpu_torch.parallel.time_shard import (
    halo_decimate_time_sharded, halo_filter_time_sharded,
    pfb_channelize_time_sharded)
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import build_p_frames
from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu_torch.protocol.rt_framing import build_r_burst
from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft
from aero_tpu_torch.runtime import station_main
from aero_tpu_torch.runtime.fused_station import FusedStation
from aero_tpu_torch.runtime.station import Station
from aero_tpu_torch.utils.profiling import PREFIX, TRACER

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "tools")]
# shared with the tests and the kernel's timing tool (none imports JAX)
from torch_soft import KERNEL_KINDS, soft_bytes  # noqa: E402
from test_torch_cuda import (cband_ini, cband_layout,  # noqa: E402
                             cband_wideband, check_packed, content_vfos)
from viterbi_time import MAIN_SHAPES, call_ms, device_ms  # noqa: E402
import torch_impair as ti  # noqa: E402
import torch_lband54 as l54  # noqa: E402
import torch_parity_check as tpc  # noqa: E402

FS = 1536000
CENTER = 1545000000
N_VFOS = 50
N_BLOCKS = 14
CONTENT = {3: ("VH-AAA", "CHIP SMOKE ALPHA", "CHIP SMOKE BRAVO"),
           17: ("N123CS", "CHIP SMOKE CHARLIE", "CHIP SMOKE DELTA"),
           31: ("G-SMKE", "CHIP SMOKE ECHO", "CHIP SMOKE FOXTROT"),
           46: ("C-FCUD", "CHIP SMOKE GOLF", "CHIP SMOKE HOTEL")}
# the two burst R-channel watchers (1200 bps, burst=1) sit in the free
# raster slots 50 and 51; one R burst is planted on the second, whose
# frequency is 1 kHz from its filterbank bin centre (slot 50's is 4 kHz
# off, which puts one image of the 6 kHz burst audio at 10 kHz, beyond
# the filterbank's 9 kHz passband edge)
R_SLOTS = (50, 51)
R_PLANTED = R_SLOTS[1]
R_INFO = (bytes([0x1B, 0x28, 0x0A, 0x0B, 0x0C, 0x77]) + b"SMOKE R"
          ).ljust(17, b"\0")
R_START_S = 3.0
# phase 8 cuts the L-band capture after 5 blocks (3.33 s): between each
# content VFO's first message (its frame ends at 3 s) and its second
FUSED_SPLIT = 5
# the C-band bank (phase 5)
CB_BLOCKS = 27
CB_P_TEXTS = (("CHIP SMOKE CBAND ONE", "CHIP SMOKE CBAND TWO"),
              ("CHIP SMOKE CBAND THREE", "CHIP SMOKE CBAND FOUR"))
CB_T_TEXT = "CHIP SMOKE T BURST"


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- phase 1 ---------------------------------------------------------------

def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip smoke: torch.cuda.is_available() is False")
    log(f"device 0: {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    set_fp32_precision()
    t0 = time.perf_counter()
    if not (native.have_native() and native.have_native_ingest()):
        raise AssertionError("the port's native host libraries did not "
                             "build (g++, aero_tpu_torch/native)")
    for name, path in sorted(native.library_paths().items()):
        log(f"native {name}: {os.path.relpath(path, ROOT)} ({card})")
    log(f"native libraries ready in {time.perf_counter() - t0:.1f} s")
    return card


# ---- phase 2 ---------------------------------------------------------------

# the card's peak rates (NVIDIA H100 SXM data sheet, at 700 W): fp32
# outside the tensor cores, and device memory
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# operations per trellis step and stream: 6 for the branch metrics, an
# add, a compare and a select for each of the 64 states' two candidates
OPS_PER_STEP = 6 + 4 * 64


def viterbi_bound_ms(B: int, T: int) -> tuple[float, str]:
    """The least time the card could take to decode B streams of T steps:
    the larger of the operations at the fp32 rate and the bytes (2T soft
    bytes in, T bits out per stream) at the memory rate."""
    ops_ms = 1e3 * B * T * OPS_PER_STEP / PEAK_OPS
    bytes_ms = 1e3 * B * 3 * T / PEAK_BYTES
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def _check_kernel(dev, B: int, T: int, kind: str, seed: int) -> int:
    soft = torch.from_numpy(soft_bytes(kind, B, T, seed=seed)).to(
        device=dev, dtype=torch.uint8)
    got = vk.viterbi_decode_soft_cuda(soft)
    torch.cuda.synchronize()
    want = viterbi_decode_soft(soft)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    log(f"viterbi B={B} T={T} {kind}: max |kernel - plain| = {err}")
    if not torch.equal(got, want):
        raise AssertionError(f"kernel != plain at B={B} T={T} ({kind})")
    return err


def phase_kernel(card: str) -> dict:
    t0 = time.perf_counter()
    so = vk.build(verbose=True)
    log(f"built {os.path.relpath(so, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s (host; {card})")
    dev = torch.device("cuda")
    max_err = 0
    for B, T in MAIN_SHAPES + ((1, 1), (130, 95)):
        for kind in KERNEL_KINDS:
            max_err = max(max_err, _check_kernel(dev, B, T, kind, B + T))
    T_max = vk.max_t(dev)
    log(f"viterbi: the largest T one block's shared memory holds: {T_max}")
    max_err = max(max_err, _check_kernel(dev, 1, T_max, "extreme", 3))
    timing = {}
    for B, T in MAIN_SHAPES:
        soft = torch.from_numpy(soft_bytes("integral", B, T, seed=1)).to(
            device=dev, dtype=torch.uint8)
        ms = call_ms(lambda: vk.viterbi_decode_soft_cuda(soft))
        dev_ms = device_ms(lambda: vk.viterbi_decode_soft_cuda(soft))
        plain_ms = call_ms(lambda: viterbi_decode_soft(soft), 2)
        bound_ms, bound_by = viterbi_bound_ms(B, T)
        timing[(B, T)] = (ms, dev_ms, plain_ms, bound_ms, bound_by)
        log(f"viterbi B={B} T={T}: wrapper call {ms:.4f} ms (back to back, "
            f"host and device); kernel {dev_ms:.4f} ms (device, CUDA "
            f"graph), {1e6 * dev_ms / T:.1f} ns per trellis step; bound "
            f"{1e3 * bound_ms:.4f} us (by {bound_by}), "
            f"{100 * bound_ms / dev_ms:.3f}% of it by device time, "
            f"{100 * bound_ms / ms:.3f}% by call; plain torch "
            f"{plain_ms:.2f} ms  ({card})")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"SM clock after the timings, and its maximum: {clocks} ({card})")
    # the R/T framer's own decode entry point, as phases 3 and 5 call it
    for T in (160, 352, 1600):
        soft = soft_bytes("random", 1, T, seed=T)
        got = vk.stream_decoder(dev)(soft[0])
        want = viterbi_decode_soft(torch.from_numpy(soft))[0].numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"stream decoder != plain at T={T}")
    return {"max_abs_err": max_err, "timing": timing}


# ---- phase 3 ---------------------------------------------------------------

def bank_ini() -> str:
    """The 50-VFO MSK-1200 bank of bench.py's fused-station headline, plus
    the two burst R-channel watchers in raster slots 50 and 51."""
    vfos = "".join(
        f"{i + 1}\\frequency={CENTER + 2000 + i * 19000}\n"
        f"{i + 1}\\data_rate=1200\n{i + 1}\\topic=V{i}\n"
        f"{i + 1}\\gain=100\n" for i in range(N_VFOS))
    vfos += "".join(
        f"{i + 1}\\frequency={CENTER + 2000 + i * 19000}\n"
        f"{i + 1}\\data_rate=1200\n{i + 1}\\topic=R{i}\n"
        f"{i + 1}\\burst=1\n" for i in R_SLOTS)
    return (f"[General]\nsample_rate={FS}\ncenter_frequency={CENTER}\n"
            f"[vfos]\nsize={N_VFOS + len(R_SLOTS)}\n{vfos}")


def make_wideband(block_len: int, n_blocks: int,
                  seed: int = 0) -> np.ndarray:
    """Wideband IQ at 1.536 MS/s: one ACARS message per P frame on each
    content VFO (then fill frames to the end) and one R burst on an R
    watcher, upconverted from 24 kS/s audio with resample_poly and
    shifted to the VFO's frequency, plus complex Gaussian noise."""
    from scipy.signal import resample_poly
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    n = block_len * n_blocks
    rng = np.random.default_rng(seed)
    wide = (0.04 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    t = np.arange(n) / FS
    for v, (reg, *texts) in CONTENT.items():
        fields = []
        for k, text in enumerate(texts):
            ud = make_acars_userdata("2", reg, "!", "H1", "A", text)
            sus = [append_crc16_bytes(b)
                   for b in segment_isu(ud, 0x400000 + v, 0x41)]
            assert len(sus) <= 6
            fields.append(b"".join(sus + [fill] * (6 - len(sus))))
        # fill frames after the messages keep the carrier up to the end
        # of the capture, so no content VFO decodes noise as frames
        fields += [fill * 6] * (n // (FS * 1) + 1)
        audio = msk_modulate(build_p_frames(fields, 1200, lead_frames=3),
                             24000, 1200.0, freq=1000.0, amplitude=0.2)
        bb = resample_poly(audio.astype(np.float64), 64, 1)[:n]
        delta = 2000 + v * 19000
        wide[: len(bb)] += (bb * np.exp(2j * np.pi * delta * t[: len(bb)])
                            ).astype(np.complex64)
    # the R burst at the watcher's audio centre (24 kS/s / 4) + 40 Hz
    audio = msk_modulate(build_r_burst(R_INFO, preamble_bits=96), 24000,
                         1200.0, freq=6040.0, amplitude=0.2)
    bb = resample_poly(audio.astype(np.float64), 64, 1)
    i0 = int(R_START_S * FS)
    bb = bb[: max(0, n - i0)]
    delta = 2000 + R_PLANTED * 19000
    wide[i0: i0 + len(bb)] += (bb * np.exp(
        2j * np.pi * delta * t[i0: i0 + len(bb)])).astype(np.complex64)
    return wide


def run_station_main(argv, box, heard, su, err=None, prepare=None):
    """Run station_main.main in-process with the station instrumented:
    ``box`` gets the station and the R/T framers' launch counter,
    ``heard`` every (topic, ACARS text), ``su`` [ok, bad] SU counts of the
    given P topics; ``err``, a list, gets the lines written to stderr;
    ``prepare(station)`` runs first, before any block (phase 10 shards
    the station there).  Returns (jsondump records on stdout, kernel
    launches over the run)."""
    def on_station(st):
        if prepare is not None:
            prepare(st)
        box["st"] = st
        box["rt"] = count_rt_launches(st)
        box["c"] = count_c_launches(st)
        emit = st.on_acars

        def on_acars(topic, item):
            heard.append((topic, item.message))
            emit(topic, item)
        st.on_acars = on_acars
        for topic in su:
            framer = st.framers[topic]
            finish = framer._finish_frame

            def counting(pre, info, su_ok, _finish=finish, _t=topic):
                ev = _finish(pre, info, su_ok)
                su[_t][0] += sum(bool(x) for x in ev.su_crc_ok)
                su[_t][1] += sum(not x for x in ev.su_crc_ok)
                return ev
            framer._finish_frame = counting

    out, errs = io.StringIO(), io.StringIO()
    vk.reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(out))
        if err is not None:
            stack.enter_context(contextlib.redirect_stderr(errs))
        rc = station_main.main(argv, on_station=on_station)
    torch.cuda.synchronize()
    if err is not None:
        err += errs.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"station_main returned {rc}")
    records = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    return records, vk.LAUNCHES


def count_rt_launches(st) -> list:
    """Wrap each R/T framer's checkpoint decoder so that the kernel
    launches it makes are counted apart from the P bank's; returns the
    one-element counter."""
    box = [0]
    for fr in st.rt_framers.values():
        def counted(soft, _dec=fr.decoder):
            before = vk.LAUNCHES
            bits = _dec(soft)
            box[0] += vk.LAUNCHES - before
            return bits
        fr.decoder = counted
    return box


def count_c_launches(st) -> list:
    """Wrap each C bank's batched decode (a station with batched framing
    and C channels) so that the kernel launches it makes are counted
    apart from the P banks'; returns the one-element counter."""
    box = [0]
    for bank in getattr(st, "_c_banks", {}).values():
        def counted(rows, _run=bank._run):
            before = vk.LAUNCHES
            out = _run(rows)
            box[0] += vk.LAUNCHES - before
            return out
        bank._run = counted
    return box


def _state_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _state_tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _state_tensors(v)


def phase_main_path(card: str, workdir: str) -> dict:
    """Drive station_main on the card over the bank's wideband file."""
    ini = os.path.join(workdir, "bank.ini")
    with open(ini, "w") as f:
        f.write(bank_ini())
    block_len = 16000 * 64
    t0 = time.perf_counter()
    wide = make_wideband(block_len, N_BLOCKS)
    iq = os.path.join(workdir, "wide.cf32")
    wide.tofile(iq)
    del wide
    log(f"wideband: {N_BLOCKS} blocks x {block_len} samples "
        f"({N_BLOCKS * block_len / FS:.2f} s at {FS} S/s), made in "
        f"{time.perf_counter() - t0:.1f} s (host; {card})")

    box, heard = {}, []
    su = {f"V{v}": [0, 0] for v in CONTENT}
    argv = ["-c", ini, "--iq-file", iq, "--backend", "fused",
            "--batch-framing", "--device", "cuda", "--ingest-dtype", "int4",
            "--format", "jsondump", "-s", "CHIP-SMOKE",
            "--stats-every", "1e9"]
    records, launches = run_station_main(argv, box, heard, su)
    st = box["st"]
    log(f"main path: {len(records)} jsondump records on stdout, "
        f"{len(heard)} ACARS, frames {st.stats.frames}, "
        f"su_ok {st.stats.su_ok}, su_bad {st.stats.su_bad}")
    stdout_texts = {r["isu"]["acars"].get("msg_text") for r in records
                    if "acars" in r.get("isu", {})}
    for v, (reg, *texts) in CONTENT.items():
        for text in texts:
            if (f"V{v}", text) not in heard or text not in stdout_texts:
                raise AssertionError(f"message {text!r} missing on V{v}")
        ok, bad = su[f"V{v}"]
        log(f"V{v}: su_ok {ok} su_bad {bad}")
        if bad != 0 or ok == 0:
            raise AssertionError(f"V{v}: su_ok {ok}, su_bad {bad}")
    r_topic = f"R{R_PLANTED}"
    r_events = [e for e in st.rt_framers[r_topic].events if e.kind == "R"]
    log(f"{r_topic}: {len(r_events)} R packets, burst windows "
        f"{st.stats.burst_windows}, packets {st.stats.burst_packets}")
    if not any(e.infofield[:17] == R_INFO for e in r_events):
        raise AssertionError(f"the planted R packet is missing on {r_topic}")
    rt = box["rt"][0]
    if launches <= 0 or rt <= 0:
        raise AssertionError(f"kernel launches {launches} (R/T {rt}): the "
                             "path did not run the kernel")
    devs = {t.device.type for t in _state_tensors(st._state)}
    if devs != {"cuda"}:
        raise AssertionError(f"station state on {devs}, expected cuda")
    n = st.stats.wideband_samples // st.block_len
    rtf = st.stats.realtime_factor / FS
    per_block = 1e3 * st.stats.wall_seconds / max(n, 1)
    log(f"main path: {n} blocks, kernel launches {launches} (P bank "
        f"{launches - rt}, R/T framers {rt}), realtime factor {rtf:.2f}x, "
        f"{per_block:.1f} ms per block (host wall clock incl. first-block "
        f"warm-up; {card})")
    return {"station": st, "launches": launches, "ini": ini, "iq": iq,
            "heard": heard, "block_len": block_len}


# ---- phase 4 ---------------------------------------------------------------

def phase_step_vs_cpu(st, wide, label: str) -> None:
    """One block through the card's station step and the host CPU's, from
    the same state: the packed buffers must agree within the limits of
    tests/test_torch_cuda.py:check_packed."""
    cpu = FusedStation(st.cfg, ingest_dtype=st.ingest_dtype, device="cpu")
    arr = st.quantize(wide)
    state_np = convert.fused_state_to_numpy(st._state)
    _, gp = st._step(convert.fused_state_from_numpy(state_np, "cuda"),
                     torch.from_numpy(arr).cuda(),
                     torch.tensor(np.float32(1.0), device="cuda"))
    _, cp = cpu._step(convert.fused_state_from_numpy(state_np, "cpu"),
                      torch.from_numpy(arr), torch.tensor(np.float32(1.0)))
    worst = check_packed(st, gp.cpu().numpy(), cp.numpy())
    log(f"{label} step on card vs CPU: soft bytes within +-1 on "
        f"{worst['soft_le1']:.6f} and equal on {worst['soft_eq']:.6f} (worst "
        f"group), lock flags and slips equal, max rel mse diff "
        f"{worst['mse_rel']:.3g}, max |Eb/N0| diff {worst['ebno_db']:.3g} dB, "
        f"max |freq| diff {worst['freq_hz']:.3g} Hz, burst audio within "
        f"{worst['audio_lsb']} LSB")


# ---- phase 5 ---------------------------------------------------------------

def cband_content():
    """The C-band bank's layout and what is planted on it."""
    layout = cband_layout(32, 8, 4, 34000)
    p_topics = content_vfos(FS, layout, "P", 2)
    rng = np.random.default_rng(11)
    cframes = [([append_crc16_bytes(bytes([0x30]) + bytes(
        rng.integers(0, 256, 9).tolist())) for _ in range(3)],
        bytes(rng.integers(0, 256, 300).tolist())) for _ in range(2)]
    content = {p_topics[0]: ("P", CB_P_TEXTS[0]),
               p_topics[1]: ("P", CB_P_TEXTS[1]),
               content_vfos(FS, layout, "C", 1)[0]: ("C", cframes),
               content_vfos(FS, layout, "T", 1)[0]: ("T", CB_T_TEXT, 2.0)}
    return layout, content


def phase_cband(card: str, workdir: str) -> dict:
    """Drive station_main on the card over the C-band bank's file."""
    layout, content = cband_content()
    ini = os.path.join(workdir, "cband.ini")
    with open(ini, "w") as f:
        f.write(cband_ini(FS, layout))
    block_len = 16000 * (FS // 48000)         # 16000 samples per channel
    t0 = time.perf_counter()
    wide = cband_wideband(FS, layout, content, CB_BLOCKS * block_len, seed=5)
    iq = os.path.join(workdir, "cband.cf32")
    wide.tofile(iq)
    del wide
    log(f"C-band wideband: {CB_BLOCKS} blocks x {block_len} samples "
        f"({CB_BLOCKS * block_len / FS:.2f} s at {FS} S/s, {len(layout)} "
        f"VFOs), made in {time.perf_counter() - t0:.1f} s (host; {card})")
    voice = os.path.join(workdir, "voice.bin")
    p_topics = [t for t, c in content.items() if c[0] == "P"]
    box, heard = {}, []
    su = {t: [0, 0] for t in p_topics}
    argv = ["-c", ini, "--iq-file", iq, "--backend", "fused",
            "--batch-framing", "--device", "cuda", "--ingest-dtype", "int4",
            "--voice-out", voice, "--format", "jsondump", "-s", "CHIP-SMOKE",
            "--stats-every", "1e9"]
    records, launches = run_station_main(argv, box, heard, su)
    st = box["st"]
    rt, c = box["rt"][0], box["c"][0]
    log(f"C-band path: {len(records)} jsondump records, {len(heard)} ACARS, "
        f"frames {st.stats.frames}, su_ok {st.stats.su_ok}, su_bad "
        f"{st.stats.su_bad}, voice frames {st.stats.voice_frames}, burst "
        f"windows {st.stats.burst_windows}, packets {st.stats.burst_packets}")
    for topic, spec in content.items():
        if spec[0] == "P":
            for text in spec[1]:
                if (topic, text) not in heard:
                    raise AssertionError(f"message {text!r} missing on "
                                         f"{topic}")
            ok, bad = su[topic]
            log(f"{topic}: su_ok {ok} su_bad {bad}")
            if bad != 0 or ok == 0:
                raise AssertionError(f"{topic}: su_ok {ok}, su_bad {bad}")
        elif spec[0] == "T" and (topic, spec[1]) not in heard:
            raise AssertionError(f"T burst message missing on {topic}")
        elif spec[0] == "C":
            with open(voice, "rb") as f:
                got = f.read()
            frames = [got[i:i + 300] for i in range(0, len(got), 300)]
            planted = [v for _, v in spec[1]]
            log(f"{topic}: voice file {len(got)} bytes, "
                f"{len(frames)} frames")
            if len(got) % 300 or [v for v in frames
                                  if v in planted] != planted:
                raise AssertionError("the voice file does not hold the "
                                     "planted frames in order")
    if launches - rt - c <= 0 or rt <= 0 or c <= 0:
        raise AssertionError(f"kernel launches: P bank {launches - rt - c}"
                             f", C bank {c}, R/T framers {rt}; each must "
                             "be > 0")
    devs = {t.device.type for t in _state_tensors(st._state)}
    if devs != {"cuda"}:
        raise AssertionError(f"station state on {devs}, expected cuda")
    n = st.stats.wideband_samples // st.block_len
    rtf = st.stats.realtime_factor / FS
    per_block = 1e3 * st.stats.wall_seconds / max(n, 1)
    log(f"C-band path: {n} blocks, kernel launches {launches} (P bank "
        f"{launches - rt - c}, C bank {c}, R/T framers {rt}), realtime "
        f"factor {rtf:.2f}x, {per_block:.1f} ms per block (host wall clock "
        f"incl. first-block warm-up; {card})")
    return {"station": st, "launches": launches, "rt": rt, "c": c,
            "ini": ini, "iq": iq, "layout": layout, "content": content}


# a fused station's drain stages as the tracer names them
# (aero_tpu_torch/utils/profiling.py), the drain's own self time last
DRAIN_STAGES = ("drain.d2h", "framers.decode", "drain.burst",
                "framers.search", "framers.prepare", "framers.finish",
                "framers.dispatch", "station.drain")


def stage_split(rec) -> dict:
    """Each drain stage's self ms in each drain of the tracer's records
    ``rec`` (stage -> [ms per drain])."""
    drains = sorted(rec.by_block("station.drain"))
    if not drains:
        raise AssertionError("no drain traced: build the station with the "
                             "tracer on")
    by = {k: rec.by_block(k) for k in DRAIN_STAGES}
    return {k: [v.get(b, 0) / 1e6 for b in drains] for k, v in by.items()}


def split_text(split: dict, windows: int = 0) -> str:
    """A drain split as text: each stage's median and mean self ms per
    drain, and the burst windows demodulated."""
    parts = [f"{k} {float(np.median(v)):.3f} / {float(np.mean(v)):.3f}"
             for k, v in split.items()]
    if windows:
        parts.append(f"{windows} burst windows")
    return "self ms median / mean per drain: " + ", ".join(parts)


def stage_times(st, wide, card: str, label: str) -> dict:
    """Where a warm station's block goes, on the blocks of ``wide``.

    Serially per block, on the host clock: quantize, device step (upload
    and one step, up to a synchronize) and drain (the packed buffer's copy
    back, host framing, burst windows and decodes), the drain split by
    stage from the tracer's spans (``stage_split``; the station was built
    with the tracer on).  Then the step alone on the last block
    (``step_times``).  The station's sinks are silenced first (the run
    that fed them is over).  Returns the medians, the split and the
    step's figures."""
    st.flush()
    st.on_acars = lambda *a: None
    st.on_voice = lambda *a: None
    L = st.block_len
    times = {"quantize": [], "device step": [], "drain": []}
    TRACER.take()
    windows = st.stats.burst_windows
    for b in range(len(wide) // L):
        t0 = time.perf_counter()
        q = st.quantize(wide[b * L:(b + 1) * L])
        t1 = time.perf_counter()
        st._pending.append(q if isinstance(q, tuple)
                           else (q, np.float32(1)))
        st._dispatch()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st._drain(st._inflight.popleft())
        t3 = time.perf_counter()
        for name, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[name].append(1e3 * dt)
    split = stage_split(TRACER.take())
    mode = "graphed" if graphs_enabled() else "eager"
    log(f"{label} block of {L} samples ({mode}), median of {len(wide) // L} "
        "warm blocks, serial: " + ", ".join(
            f"{k} {float(np.median(v)):.3f} ms" for k, v in times.items())
        + f"; drain split, "
        f"{split_text(split, st.stats.burst_windows - windows)} ({card})")
    out = {k: float(np.median(v)) for k, v in times.items()}
    out["split"] = split
    out.update(step_times(st, q, card, label))
    return out


def step_times(st, q, card: str, label: str) -> dict:
    """One block's device step alone, as the station runs it (a graph
    replay per shard, or eagerly inside ``disable_graphs()``), on a
    quantized block ``q``: host enqueue and CUDA-event device time per
    step over 10 steps, and under torch.profiler over 3 steps the device
    operations per step (the kernels and copies the profiler reports on
    the device, a replay's kernels included), the graph launches the host
    made, their summed device time and the device's idle share of the
    step; and the station's captures so far.  The station's state is put
    back afterwards."""
    iq = torch.from_numpy(q[0] if isinstance(q, tuple) else q).to(st.device)
    scale = torch.tensor(np.float32(1.0), device=st.device)
    out = torch.empty(st._packed_len, dtype=torch.uint8, device=st.device)
    saved = st._state
    st._run_block(iq, scale, out)                 # warm (or capture)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(n):
        st._run_block(iq, scale, out)
    ev1.record()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    step_ms = ev0.elapsed_time(ev1) / n
    from torch.profiler import ProfilerActivity, profile
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            st._run_block(iq, scale, out)
        torch.cuda.synchronize()
    st._state = saved
    # the tracer's ranges' device-side annotations are host spans, not work
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith(PREFIX)]
    launches = sum(e.name == "cudaGraphLaunch" for e in prof.events())
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n
    idle = 100 * (1 - busy_ms / step_ms)
    mode = "graphed" if graphs_enabled() else "eager"
    log(f"{label} step alone ({mode}): host enqueue {enqueue_ms:.3f} ms, "
        f"device (CUDA events) {step_ms:.3f} ms per step; profiler: "
        f"{len(dev) / n:.1f} device operations and {launches / n:.1f} graph "
        f"launches per step, {busy_ms:.3f} ms of device time per step, "
        f"device idle {idle:.1f}%; captures {st.captures} ({card})")
    top = sorted((e for e in prof.key_averages()
                  if not e.key.startswith(PREFIX)),
                 key=lambda e: -e.self_device_time_total)
    log(f"{label} step ({mode}), largest device times per step: " +
        ", ".join(f"{e.key} {e.self_device_time_total / 1e3 / n:.3f} ms"
                  for e in top[:6]))
    return {"enqueue_ms": enqueue_ms, "step_ms": step_ms,
            "device_ops": len(dev) / n, "graph_launches": launches / n,
            "busy_ms": busy_ms, "idle": idle, "captures": st.captures,
            "table": prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40)}


# ---- phase 7 ---------------------------------------------------------------

def phase_classic(card: str, workdir: str) -> dict:
    """Drive station_main --backend tree on configs/aor_w_54_lband.ini,
    unmodified, over the capture of tests/torch_lband54.py."""
    t0 = time.perf_counter()
    wide = l54.make_capture()
    paths = {k: os.path.join(workdir, f"l54_{k}.cf32") for k in "wab"}
    wide.tofile(paths["w"])
    wide[: l54.SPLIT * l54.BLOCK].tofile(paths["a"])
    wide[l54.SPLIT * l54.BLOCK:].tofile(paths["b"])
    log(f"54W capture: {l54.N_BLOCKS} blocks x {l54.BLOCK} samples "
        f"({l54.N_BLOCKS * l54.BLOCK / l54.FS:.2f} s at {l54.FS} S/s), made "
        f"in {time.perf_counter() - t0:.1f} s (host; {card})")
    box, heard = {}, []
    su = {t: [0, 0] for t in l54.CONTENT}
    argv = ["-c", l54.INI_PATH, "--iq-file", paths["w"], "--backend", "tree",
            "--device", "cuda", "--format", "jsondump",
            "-s", "CHIP-SMOKE", "--stats-every", "1e9"]
    t0 = time.perf_counter()
    records, launches = run_station_main(argv, box, heard, su)
    wall = time.perf_counter() - t0
    st, rt = box["st"], box["rt"][0]
    log(f"classic path: {len(records)} jsondump records, {len(heard)} ACARS, "
        f"frames {st.stats.frames}, su_ok {st.stats.su_ok}, su_bad "
        f"{st.stats.su_bad}, burst windows {st.stats.burst_windows}, "
        f"packets {st.stats.burst_packets}")
    missing = l54.planted() - set(heard)
    if missing:
        raise AssertionError(f"classic path: messages missing: {missing}")
    for topic, (ok, bad) in su.items():
        log(f"{topic}: su_ok {ok} su_bad {bad}")
        if bad != 0 or ok == 0:
            raise AssertionError(f"{topic}: su_ok {ok}, su_bad {bad}")
    r_events = [e for e in st.rt_framers[l54.R_TOPIC].events
                if e.kind == "R"]
    if not any(e.infofield[:17] == l54.R_INFO for e in r_events):
        raise AssertionError(f"the planted R packet is missing on "
                             f"{l54.R_TOPIC}")
    if rt <= 0:
        raise AssertionError(f"classic path: R/T kernel launches {rt}")
    devs = {t.device.type for t in _state_tensors(st.device_state())}
    if devs != {"cuda"}:
        raise AssertionError(f"classic station state on {devs}")
    log(f"classic path: {l54.N_BLOCKS} blocks in {wall:.2f} s of host wall "
        f"clock (station_main, first-block warm-up included), kernel "
        f"launches {launches} (R/T framers {rt}), realtime factor "
        f"{st.stats.realtime_factor / l54.FS:.2f}x ({card})")
    return {"station": st, "launches": launches, "rt": rt, "paths": paths,
            "heard": heard}


def classic_stage_times(st, wide, card: str, label: str = "classic") -> None:
    """Where a warm classic station's block goes, over the blocks of
    ``wide`` fed serially: the channelizer (its int16 payloads copied to
    the host), the demod banks (one step, up to a synchronize) and the
    rest of ``Station.process`` (host framing, hunters, burst watchers and
    their decodes), as means per wideband block; then under
    torch.profiler over 4 blocks the device operations per block, their
    summed device time and the device's idle share of the block.  The
    station's sinks are silenced first (the run that fed them is over)."""
    st.on_acars = lambda *a: None
    L = st.cfg.buflen_complex
    n = len(wide) // L
    spent = {"channelizer": 0.0, "banks": 0.0}
    ch_process = st.channelizer.process

    def timed_channelizer(iq):
        t0 = time.perf_counter()
        out = ch_process(iq)
        spent["channelizer"] += time.perf_counter() - t0
        return out
    st.channelizer.process = timed_channelizer
    bank_steps = {}
    for key, bank in st.banks.items():
        bank_steps[key] = bank.process_block

        def timed_bank(x, _step=bank.process_block):
            t0 = time.perf_counter()
            out = _step(x)
            torch.cuda.synchronize()
            spent["banks"] += time.perf_counter() - t0
            return out
        bank.process_block = timed_bank
    t0 = time.perf_counter()
    for b in range(n):
        st.process(wide[b * L:(b + 1) * L])
    total = time.perf_counter() - t0
    host = total - spent["channelizer"] - spent["banks"]
    mode = "graphed" if graphs_enabled() else "eager"
    log(f"{label} block of {L} samples ({mode}), mean of {n} warm blocks, "
        "serial: "
        f"channelizer {1e3 * spent['channelizer'] / n:.3f} ms, banks "
        f"{1e3 * spent['banks'] / n:.3f} ms, host framing and burst "
        f"watchers {1e3 * host / n:.3f} ms, total {1e3 * total / n:.3f} ms "
        f"({card})")
    del st.channelizer.process
    for key, bank in st.banks.items():
        del bank.process_block
    from torch.profiler import ProfilerActivity, profile
    k = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(k):
            st.process(wide[b * L:(b + 1) * L])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / k
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith(PREFIX)]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / k
    log(f"{label} block under the profiler ({mode}): {len(dev) / k:.1f} "
        f"device operations, {busy_ms:.3f} ms of device time per block of "
        f"{wall_ms:.3f} ms, device idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
        f"captures {st.captures} ({card})")


def phase_classic_vs_cpu(st, block, workdir: str) -> None:
    """One classic block on the card against the host CPU from the same
    state (carried by a checkpoint): the channelizer's payloads (int16
    audio within one LSB on >= 99% of each payload, main nibbles equal on
    >= 99.8% of the bytes, the limits of tests/test_torch_channelizer.py)
    and each demod bank's step (soft bytes within +-1 on >= 99.9%, lock
    flags and slips equal, as tests/test_torch_msk.py)."""
    path = os.path.join(workdir, "classic_vs_cpu.ckpt")
    st.save_checkpoint(path)
    cpu = Station(st.cfg, device="cpu")
    cpu.load_checkpoint(path)
    got = st.channelizer.process(block)
    want = cpu.channelizer.process(block)
    worst_lsb, worst_frac, worst_nib = 0, 0.0, 0.0
    for (topic, rate, g), (t2, r2, w) in zip(got, want):
        if (topic, rate) != (t2, r2):
            raise AssertionError(f"channelizer outputs differ: {topic}/{t2}")
        if topic.startswith("WB"):
            frac = float((np.frombuffer(g, np.uint8)
                          != np.frombuffer(w, np.uint8)).mean())
            worst_nib = max(worst_nib, frac)
            continue
        d = np.abs(np.frombuffer(g, "<i2").astype(np.int32)
                   - np.frombuffer(w, "<i2").astype(np.int32))
        worst_lsb = max(worst_lsb, int(d.max(initial=0)))
        worst_frac = max(worst_frac, float((d > 0).mean()) if len(d) else 0)
    if worst_lsb > 1 or worst_frac > 0.01 or worst_nib > 0.002:
        raise AssertionError(f"classic channelizer card vs CPU: {worst_lsb} "
                             f"LSB, {worst_frac} off, nibbles {worst_nib}")
    audio = {t: np.frombuffer(p, "<i2").astype(np.float32) / 32768.0
             for t, _, p in want}
    soft_le1 = 1.0
    for key, bank in st.banks.items():
        topics = [st.cfg.subs[i].topic for i in st.groups[key]]
        L = bank.cfg.block_len
        x = np.stack([np.resize(audio[t], L) for t in topics])
        go = bank.process_block(x)
        co = cpu.banks[key].process_block(x)
        d = np.abs(go["soft_bits"].cpu().numpy().astype(np.int32)
                   - co["soft_bits"].numpy().astype(np.int32))
        soft_le1 = min(soft_le1, float((d <= 1).mean()))
        for k in ("signal", "slip"):
            if not np.array_equal(go[k].cpu().numpy(), co[k].numpy()):
                raise AssertionError(f"bank {key}: {k} differs card vs CPU")
    if soft_le1 < 0.999:
        raise AssertionError(f"classic banks card vs CPU: soft bytes within "
                             f"+-1 on {soft_le1}")
    log(f"classic block on card vs CPU: int16 audio within {worst_lsb} LSB "
        f"(off by one on at most {worst_frac:.5f} of a payload), main "
        f"nibbles differ on {worst_nib:.5f}, bank soft bytes within +-1 on "
        f"{soft_le1:.6f} (worst bank), lock flags and slips equal")


# ---- phase 8 ---------------------------------------------------------------

def _split_file(src: str, block_len: int, n_first: int, workdir: str,
                tag: str):
    """The capture ``src`` cut after n_first blocks into two files."""
    wide = np.fromfile(src, np.complex64)
    a = os.path.join(workdir, f"{tag}_a.cf32")
    b = os.path.join(workdir, f"{tag}_b.cf32")
    wide[: n_first * block_len].tofile(a)
    wide[n_first * block_len:].tofile(b)
    return a, b


def _by_topic(heard) -> dict:
    """topic -> its ACARS texts in order."""
    out = {}
    for topic, text in heard:
        out.setdefault(topic, []).append(text)
    return out


def _resumed_run(argv_of, first: str, second: str, ckpt: str, label: str):
    """Two station_main runs joined by ``--checkpoint``: the ACARS of each
    (topic, text), the second run's stderr and its kernel launches."""
    heard_a, heard_b, err = [], [], []
    run_station_main(argv_of(first) + ["--checkpoint", ckpt], {}, heard_a,
                     {})
    size = os.path.getsize(ckpt)
    _, launches = run_station_main(argv_of(second) + ["--checkpoint", ckpt],
                                   {}, heard_b, {}, err)
    if not any("resumed_from" in line for line in err):
        raise AssertionError(f"{label}: the second run did not resume")
    log(f"{label}: checkpoint {size} bytes; {len(heard_a)} ACARS before it, "
        f"{len(heard_b)} after")
    return heard_a, heard_b, launches


def phase_checkpoints(card: str, workdir: str, lband: dict,
                      classic: dict) -> None:
    """The 50-VFO fused bank and the 54W classic bank each save at a
    middle block and a fresh station (a second station_main run) resumes
    from the file: the ACARS of both runs, in order, equal the
    uninterrupted run's."""
    fused_argv = ["-c", lband["ini"], "--backend", "fused",
                  "--batch-framing", "--device", "cuda",
                  "--ingest-dtype", "int4", "--format", "jsondump",
                  "-s", "CHIP-SMOKE", "--stats-every", "1e9"]
    a, b = _split_file(lband["iq"], lband["block_len"], FUSED_SPLIT,
                       workdir, "fused")
    ha, hb, _ = _resumed_run(lambda f: fused_argv + ["--iq-file", f], a, b,
                             os.path.join(workdir, "fused.ckpt"),
                             "fused checkpoint")
    if _by_topic(ha + hb) != _by_topic(lband["heard"]) or not ha or not hb:
        raise AssertionError("fused resume: the messages differ from the "
                             "uninterrupted run's")
    classic_argv = ["-c", l54.INI_PATH, "--backend", "tree", "--device",
                    "cuda", "--format", "jsondump", "-s", "CHIP-SMOKE",
                    "--stats-every", "1e9"]
    ha, hb, launches = _resumed_run(
        lambda f: classic_argv + ["--iq-file", f], classic["paths"]["a"],
        classic["paths"]["b"], os.path.join(workdir, "classic.ckpt"),
        "classic checkpoint")
    if _by_topic(ha + hb) != _by_topic(classic["heard"]) or not ha or not hb:
        raise AssertionError("classic resume: the messages differ from the "
                             "uninterrupted run's")
    log(f"checkpoints on {card}: fused and classic resumes equal the "
        f"uninterrupted runs; R/T kernel launches after the classic resume: "
        f"{launches}")


# ---- phase 9 ---------------------------------------------------------------

def phase_pfb(card: str, lband: dict) -> dict:
    """station_main --backend pfb on the 50-VFO L-band bank (no main
    topics): every planted message on its VFO."""
    box, heard = {}, []
    su = {f"V{v}": [0, 0] for v in CONTENT}
    argv = ["-c", lband["ini"], "--iq-file", lband["iq"], "--backend", "pfb",
            "--device", "cuda", "--format", "jsondump",
            "-s", "CHIP-SMOKE", "--stats-every", "1e9"]
    t0 = time.perf_counter()
    _, launches = run_station_main(argv, box, heard, su)
    wall = time.perf_counter() - t0
    st = box["st"]
    for v, (reg, *texts) in CONTENT.items():
        for text in texts:
            if (f"V{v}", text) not in heard:
                raise AssertionError(f"pfb: message {text!r} missing on V{v}")
        ok, bad = su[f"V{v}"]
        if bad != 0 or ok == 0:
            raise AssertionError(f"pfb V{v}: su_ok {ok}, su_bad {bad}")
    devs = {t.device.type for t in _state_tensors(st.device_state())}
    if devs != {"cuda"}:
        raise AssertionError(f"pfb station state on {devs}")
    log(f"pfb path: {len(heard)} ACARS, frames {st.stats.frames}, su_ok "
        f"{st.stats.su_ok}, su_bad {st.stats.su_bad}; "
        f"{st.stats.wideband_samples // st.cfg.buflen_complex} blocks in "
        f"{wall:.2f} s of host wall clock, realtime factor "
        f"{st.stats.realtime_factor / FS:.2f}x, kernel launches {launches} "
        f"({card})")
    return {"launches": launches}


# ---- phase 10 --------------------------------------------------------------

def card_mesh(n: int, axis: str = "vfo") -> Mesh:
    """A mesh of n shards dealt over the visible cards in turn: n shards
    of cuda:0 on a one-card machine."""
    count = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % count) for i in range(n)], (axis,))


def _shards_text(mesh: Mesh) -> str:
    return (f"{len(mesh.devices)} shards on "
            + ", ".join(str(d) for d in mesh.devices))


def phase_time_shards(card: str, block_len: int) -> None:
    """The three time-shard functions on a mesh of two shards against the
    unsharded pass on the card, on one L-band block of complex noise: the
    halfband FIR (23 taps), the halfband decimator (11 taps, by 2) and the
    WOLA filterbank (K=128) from a random carry.  On the CPU they are
    bit-identical; here cuDNN and cuFFT may pick another algorithm for a
    shorter input, so the largest difference must stay within 1e-5 of
    the output's peak."""
    mesh = card_mesh(2, "time")
    log(f"time mesh: {_shards_text(mesh)}")
    rng = np.random.default_rng(3)

    def noise(n):
        return torch.from_numpy((0.1 * (rng.standard_normal(n) + 1j
                                        * rng.standard_normal(n))
                                 ).astype(np.complex64)).cuda()
    x = noise(block_len)
    xs = shard_over_vfo(mesh, x, "time")
    K = 128
    carry = noise(8 * K - K // 2)
    h23, h11 = HALFBAND_TAPS[23], HALFBAND_TAPS[11]
    fir = halo_filter_time_sharded(mesh, h23)
    dec = halo_decimate_time_sharded(mesh, h11, 2)
    pfb = pfb_channelize_time_sharded(mesh, K)
    cases = {
        "halo FIR, 23 taps": (
            lambda: fir(xs), 0, lambda: fir_apply(
                fir_init(len(h23), dtype=x.dtype, device=x.device), x,
                h23)[1]),
        "halo decimator, 11 taps by 2": (
            lambda: dec(xs), 0, lambda: fir_decimate_apply(
                fir_init(len(h11), dtype=x.dtype, device=x.device), x, h11,
                2)[1]),
        f"WOLA filterbank, K={K}": (
            lambda: pfb(carry, xs), 1,
            lambda: pfb_channelize(carry, x, K)[1]),
    }
    for name, (sharded, dim, plain) in cases.items():
        got = gather(mesh, sharded(), dim, "time")
        want = plain()
        err = float((got - want).abs().max())
        peak = float(want.abs().max())
        ms, plain_ms = call_ms(sharded, 20), call_ms(plain, 20)
        log(f"time-sharded {name}: {block_len} samples, max |sharded - "
            f"unsharded| = {err:.3g} (limit {1e-5 * peak:.3g}, 1e-5 of "
            f"the peak), bit-identical {torch.equal(got, want)}; "
            f"{ms:.3f} ms sharded, {plain_ms:.3f} ms unsharded per call "
            f"({card})")
        if err > 1e-5 * peak:
            raise AssertionError(f"time-sharded {name} differs by {err}")


def phase_sharded_fused(card: str, lband: dict) -> dict:
    """Phase 3 again with the station sharded over two shards before its
    first block (``FusedStation.shard`` in station_main's station hook):
    phase 3's ACARS on each VFO, no bad SU on the content VFOs, the R
    packet, the Viterbi kernel launched; then the per-block time and the
    device idle share of phase 3's station and of this one, on the same
    warm blocks."""
    mesh = card_mesh(2)
    log(f"vfo mesh of the sharded L-band bank: {_shards_text(mesh)}")
    box, heard = {}, []
    su = {f"V{v}": [0, 0] for v in CONTENT}
    argv = ["-c", lband["ini"], "--iq-file", lband["iq"], "--backend",
            "fused", "--batch-framing", "--device", "cuda",
            "--ingest-dtype", "int4", "--format", "jsondump",
            "-s", "CHIP-SMOKE", "--stats-every", "1e9"]
    _, launches = run_station_main(argv, box, heard, su,
                                   prepare=lambda st: st.shard(mesh))
    st, rt = box["st"], box["rt"][0]
    if _by_topic(heard) != _by_topic(lband["heard"]):
        raise AssertionError("sharded L-band: the messages differ from "
                             "phase 3's")
    for topic, (ok, bad) in su.items():
        if bad != 0 or ok == 0:
            raise AssertionError(f"sharded {topic}: su_ok {ok}, su_bad {bad}")
    if not any(e.kind == "R" and e.infofield[:17] == R_INFO
               for e in st.rt_framers[f"R{R_PLANTED}"].events):
        raise AssertionError("sharded L-band: the R packet is missing")
    if launches - rt <= 0 or rt <= 0:
        raise AssertionError(f"sharded L-band: kernel launches P bank "
                             f"{launches - rt}, R/T framers {rt}")
    devs = {(t.device.type, t.device.index) for s in st._shards
            for t in _state_tensors(s)}
    if len(st._shards) != 2 or {d for d, _ in devs} != {"cuda"}:
        raise AssertionError(f"sharded L-band: {len(st._shards)} shards "
                             f"on {devs}")
    log(f"sharded L-band path: {len(heard)} ACARS (phase 3's, per VFO in "
        f"order), frames {st.stats.frames}, su_ok {st.stats.su_ok}, su_bad "
        f"{st.stats.su_bad}, kernel launches {launches} (P bank "
        f"{launches - rt}, R/T framers {rt}), realtime factor "
        f"{st.stats.realtime_factor / FS:.2f}x ({card})")
    wide = make_wideband(st.block_len, 4, seed=9)
    ref = stage_times(lband["station"], wide, card, "L-band unsharded")
    got = stage_times(st, wide, card, "L-band sharded")
    log(f"L-band block, unsharded vs {len(mesh.devices)} shards: device "
        f"step {ref['device step']:.3f} vs {got['device step']:.3f} ms, "
        f"step alone {ref['step_ms']:.3f} vs {got['step_ms']:.3f} ms "
        f"(host enqueue {ref['enqueue_ms']:.3f} vs {got['enqueue_ms']:.3f} "
        f"ms), device operations {ref['device_ops']:.1f} vs "
        f"{got['device_ops']:.1f}, device idle {ref['idle']:.1f}% vs "
        f"{got['idle']:.1f}% ({card})")
    return {"station": st, "mesh": mesh, "launches": launches, "rt": rt}


def phase_sharded_checkpoint(card: str, workdir: str, sharded: dict) -> None:
    """The sharded station saves (its shards gathered into the one file
    layout); a station that loads the file unsharded, and one that loads
    it and shards the same way, step the next block beside the saved
    station: the re-sharded one's telemetry equal to it, the unsharded
    one's within 1e-4 (its batches are twice as large)."""
    st, mesh = sharded["station"], sharded["mesh"]
    path = os.path.join(workdir, "sharded.ckpt")
    st.save_checkpoint(path)

    def loaded():
        s = FusedStation(st.cfg, ingest_dtype="int4",
                         batch_host_framing=True, device="cuda")
        s.load_checkpoint(path)
        return s
    plain = loaded()
    again = loaded().shard(mesh)
    block = st.quantize(make_wideband(st.block_len, 1, seed=10))
    for s in (st, plain, again):
        s.process(block)
        s.flush()
    if not np.array_equal(again.telemetry, st.telemetry):
        raise AssertionError("re-sharded resume: telemetry differs")
    err = float(np.abs(plain.telemetry - st.telemetry).max())
    if not np.allclose(plain.telemetry, st.telemetry, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"unsharded resume: telemetry differs by {err}")
    log(f"sharded checkpoint ({os.path.getsize(path)} bytes): loaded and "
        f"re-sharded, the next block's telemetry is equal; loaded "
        f"unsharded, max |difference| {err:.3g} (bit-identical "
        f"{np.array_equal(plain.telemetry, st.telemetry)}) ({card})")


def phase_sharded_classic(card: str, classic: dict) -> dict:
    """``Station(mesh=...)`` on phase 7's 54W capture: three shards, the
    smallest count above one that divides both of its banks (3 subs at
    600 bps, 21 at 1200); phase 7's ACARS on each VFO and its R packet;
    then phase 7's stage times on this station."""
    mesh = card_mesh(3)
    heard = []
    st = Station(load_ini(l54.INI_PATH), mesh=mesh, device="cuda",
                 station_id="CHIP-SMOKE",
                 on_acars=lambda t, it: heard.append((t, it.message)))
    rt = count_rt_launches(st)
    wide = np.fromfile(classic["paths"]["w"], np.complex64)
    L = st.cfg.buflen_complex
    vk.reset_launches()
    t0 = time.perf_counter()
    for b in range(len(wide) // L):
        st.process(wide[b * L:(b + 1) * L])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vk.LAUNCHES
    if _by_topic(heard) != _by_topic(classic["heard"]):
        raise AssertionError("sharded classic: the messages differ from "
                             "phase 7's")
    if not any(e.kind == "R" and e.infofield[:17] == l54.R_INFO
               for e in st.rt_framers[l54.R_TOPIC].events):
        raise AssertionError("sharded classic: the R packet is missing")
    if any(len(b._shards) != 3 for b in st.banks.values()) or rt[0] <= 0:
        raise AssertionError(f"sharded classic: shards or R/T launches "
                             f"{rt[0]}")
    devs = {t.device.type for t in _state_tensors(st.device_state())}
    if devs != {"cuda"}:
        raise AssertionError(f"sharded classic station state on {devs}")
    log(f"sharded classic path ({_shards_text(mesh)}): {len(heard)} ACARS "
        f"(phase 7's, per VFO in order), frames {st.stats.frames}, su_ok "
        f"{st.stats.su_ok}, su_bad {st.stats.su_bad}; {len(wide) // L} "
        f"blocks in {wall:.2f} s of host wall clock (first-block set-up "
        f"included), {1e3 * wall / (len(wide) // L):.3f} ms per block, "
        f"kernel launches {launches} (R/T framers {rt[0]}) ({card})")
    classic_stage_times(st, wide[: 12 * l54.BLOCK], card, "sharded classic")
    return {"launches": launches}


# ---- phase 11 --------------------------------------------------------------

SELFTEST_STAGES = ("SELFTEST", "PFBTIME", "VFOBANK", "FUSEDSTATION")


def phase_selftest(card: str) -> None:
    """Two ``aero_tpu_torch.parallel.selftest`` processes on the card(s),
    each with two shards: NCCL with a card per process where two or more
    are visible, else gloo with both processes on cuda:0.  Every
    ``MH-*-OK`` line of both must appear."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "aero_tpu_torch.parallel.selftest",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), "--shards-per-process", "2",
         "--device", "cuda", "--backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("MH-"):
                log(f"{line} ({backend}; {card})")
        if p.returncode != 0 or any(f"MH-{stage}-OK proc={i}" not in out
                                    for stage in SELFTEST_STAGES):
            raise AssertionError(f"selftest process {i} (rc {p.returncode}):"
                                 f"\n{out[-3000:]}")
    if backend == "gloo":
        log("MH-SCALING: both processes share cuda:0, so its efficiency is "
            "no scaling figure")


# ---- phase 12 --------------------------------------------------------------

# the impairment scenarios of tests/torch_impair.py run on the card, each
# held to JAX's threshold (tests/test_impairments.py)
CARD_ENVELOPES = ("msk_ramp_150", "msk_ppm_+500", "oqpsk_ramp_240",
                  "oqpsk_ppm_+100", "msk_combined", "burst_r_combined",
                  "fused_ppm_400", "fused_c_ppm_100", "classic_ppm_400")
# fixture -> (bit rate, least parity %), as tests/test_parity_fixture.py
PARITY_FIXTURES = {"synthetic_1200": (1200, 100.0),
                   "synthetic_10500": (10500, 100.0),
                   "jaero_drill_1200": (1200, 95.0)}


def _check_on_card(label: str, built: list) -> None:
    """Every demodulator and station a scenario built runs on the card,
    with its state tensors there (no CPU fallback)."""
    for obj in built:
        if isinstance(obj, Station):
            tree = obj.device_state()
        elif isinstance(obj, FusedStation):
            tree = obj._state
        else:
            tree = obj.state
        devs = {t.device.type for t in _state_tensors(tree)}
        if obj.device.type != "cuda" or devs - {"cuda"}:
            raise AssertionError(f"{label}: {type(obj).__name__} on "
                                 f"{obj.device}, state on {devs}")
    if not built:
        raise AssertionError(f"{label}: no demodulator or station ran")


def phase_envelopes(card: str, workdir: str) -> dict:
    """The reference's impairment envelopes, its fused soak with a
    checkpoint restore, and the frame-parity tool, free-running on the
    card: each scenario against JAX's threshold, the soak's three messages
    and hunted carrier, and tools/torch_parity_check.py --device cuda at
    100% on the synthetic fixtures and >= 95% on the drill."""
    set_fp32_precision()
    vk.reset_launches()
    for name in CARD_ENVELOPES:
        run, sent, need = ti.ENVELOPES[name]
        before = vk.LAUNCHES
        t0 = time.perf_counter()
        built = []
        got = run("cuda", built)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check_on_card(name, built)
        steady = ""
        if name in ti.STEADY:
            first, frames, share = ti.STEADY[name]
            n = len([i for i in got if i >= first])
            steady = (f", steady state {n} of {frames} (JAX's least share "
                      f"{share})")
            if n / frames < share:
                raise AssertionError(f"{name}: steady state {n} of {frames}")
        launches = vk.LAUNCHES - before
        log(f"envelope {name}: {len(got)} of {sent} recovered, JAX's "
            f"threshold {need}{steady}, {dt:.2f} s on cuda, kernel "
            f"launches {launches} ({card})")
        if len(got) < need:
            raise AssertionError(f"{name}: {len(got)} of {sent}, JAX's "
                                 f"threshold {need}")
        if name == "burst_r_combined" and launches <= 0:
            raise AssertionError("burst R: the R/T framer did not launch "
                                 "the kernel")
    before = vk.LAUNCHES
    t0 = time.perf_counter()
    built = []
    got, tel = ti.fused_soak("cuda", workdir, built)
    torch.cuda.synchronize()
    _check_on_card("fused soak", built)
    texts = {m for _, m in got}
    soak_launches = vk.LAUNCHES - before
    log(f"fused soak (int16, batched host framing, hunter, T burst, "
        f"checkpoint restore): {sorted(texts)}, hunted VFO at "
        f"{tel['OFF']['freq']:.1f} Hz, BR packets {tel['BR']['packets']}, "
        f"{time.perf_counter() - t0:.2f} s on cuda, kernel launches "
        f"{soak_launches} ({card})")
    if (set(ti.SOAK_TEXTS) - texts or abs(tel["OFF"]["freq"] - 2500.0)
            >= 200.0 or tel["BR"]["packets"] < 1 or soak_launches <= 0):
        raise AssertionError("fused soak failed on the card")
    for fixture, (rate, least) in PARITY_FIXTURES.items():
        base = os.path.join(ROOT, "tests", "fixtures", fixture)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = tpc.main([base + ".wav", base + ".expected.jsonl", "-b",
                           str(rate), "--min-parity", str(least),
                           "--device", "cuda"])
        rep = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"tools/torch_parity_check.py --device cuda {fixture}: "
            f"{json.dumps(rep)} (least {least}%), "
            f"{time.perf_counter() - t0:.2f} s ({card})")
        if rc != 0 or rep["parity_pct"] < least:
            raise AssertionError(f"parity on {fixture}: {rep}")
    return {"launches": vk.LAUNCHES, "soak_launches": soak_launches}


# ---- phase 13 --------------------------------------------------------------

# the bench's figures that must be positive and finite: every section's best
BENCH_POSITIVE = ("value", "calibration_gflops") + tuple(
    k for k in bench.SECTION_KEYS if k != "latency_msgs")


def phase_bench(card: str) -> dict:
    """``python -m aero_tpu_torch.bench`` in full on the card: exit code 0,
    every section's best positive and finite, no TF32 in the calibration,
    at least 12 of 24 latency messages mapped, the Viterbi kernel
    launched (the bench checks its decode bit for bit); then the kernel
    at the bench's shape timed as phase 2 times it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", "aero_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=env)
    for line in res.stderr.strip().splitlines():
        log(f"bench | {line}")
    if res.returncode != 0:
        raise AssertionError(f"the bench exited {res.returncode}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    log("bench: " + json.dumps(rec))
    bad = [k for k in BENCH_POSITIVE
           if not (isinstance(rec[k], (int, float)) and math.isfinite(rec[k])
                   and rec[k] > 0)]
    if bad:
        raise AssertionError(f"bench figures not positive and finite: {bad}")
    if rec["calibration_gflops"] >= 1.05 * bench.FP32_PEAK_GFLOPS:
        raise AssertionError(f"calibration {rec['calibration_gflops']} "
                             "GFLOP/s: TF32 is on")
    if rec["latency_msgs"] < 12:
        raise AssertionError(f"latency mapping: {rec['latency_msgs']} of 24")
    if rec["viterbi_launches"] <= 0:
        raise AssertionError("the bench did not launch the Viterbi kernel")
    B, T = 128, 2496
    _, soft, _ = bench.viterbi(B, T, torch.device("cuda"))
    ms = call_ms(lambda: vk.viterbi_decode_soft_cuda(soft))
    dev_ms = device_ms(lambda: vk.viterbi_decode_soft_cuda(soft))
    plain_ms = call_ms(lambda: viterbi_decode_soft(soft), 2)
    bound_ms, bound_by = viterbi_bound_ms(B, T)
    log(f"viterbi B={B} T={T} (the bench's shape): wrapper call {ms:.4f} ms; "
        f"kernel {dev_ms:.4f} ms (device, CUDA graph), "
        f"{1e6 * dev_ms / T:.1f} ns per trellis step; bound "
        f"{1e3 * bound_ms:.4f} us (by {bound_by}), "
        f"{100 * bound_ms / dev_ms:.3f}% of it by device time; plain torch "
        f"{plain_ms:.2f} ms; bench launches {rec['viterbi_launches']} "
        f"({card})")
    # the fused station's pipelining, in this process on the same card:
    # the bench's throughput shape against no step in flight and against
    # one block per step, in turns
    rates = {}
    for bps, depth in ((8, 2), (8, 0), (1, 0), (8, 2), (8, 0), (1, 0)):
        m, _ = bench.bench_fused_station(blocks_per_step=bps,
                                         pipeline_depth=depth, repeats=3,
                                         device="cuda")
        rates.setdefault((bps, depth), []).append(m["best"])
    log("fused station realtime factor (best of 3 x 16 blocks, twice, in "
        "turns) by blocks_per_step / pipeline_depth: " + "; ".join(
            f"{bps} / {d}: {', '.join(f'{r:.2f}x' for r in rs)}"
            for (bps, d), rs in rates.items()) + f" ({card})")
    return {"launches": rec["viterbi_launches"]}


# ---- phase 14 --------------------------------------------------------------

def _mode(name: str):
    return disable_graphs() if name == "eager" else contextlib.nullcontext()


def _canon(obj) -> str:
    """A telemetry or output record as text, NaN equal to NaN."""
    return json.dumps(obj, sort_keys=True, default=repr)


def _fused_run(argv, prepare=None) -> tuple:
    """``station_main`` over ``argv`` with each drained packed buffer,
    the telemetry after each drain, each batched decode's bits and CRC
    flags per frame, each burst watcher's outputs (soft bits, frequency,
    tone quality) and the ACARS recorded; returns (the record, the
    station)."""
    rec = {"packed": [], "telemetry": [], "frames": [], "bursts": [],
           "captured": []}

    def hook(st):
        if prepare is not None:
            prepare(st)
        drain = st._drain

        def recording(packed, _drain=drain):
            rec["packed"].append(packed.cpu().numpy())
            _drain(packed)
            rec["telemetry"].append(_canon(st.vfo_telemetry()))
            _mark_captures(st, rec, len(rec["packed"]))
        st._drain = recording
        for bank in st._batch_banks.values():
            for topic, framer in bank.framers.items():
                def finish(pre, info, su_ok, _f=framer._finish_frame,
                           _t=topic):
                    rec["frames"].append((_t, bytes(info),
                                          np.asarray(su_ok).tobytes()))
                    return _f(pre, info, su_ok)
                framer._finish_frame = finish
        for bank in getattr(st, "_c_banks", {}).values():
            for topic, framer in bank.framers.items():
                def c_finish(item, out, _f=framer._finish, _t=topic):
                    rec["frames"].append((_t, np.asarray(out).tobytes()))
                    return _f(item, out)
                framer._finish = c_finish
        _record_bursts(st, rec)
    box, heard = {}, []
    run_station_main(argv, box, heard, {}, prepare=hook)
    rec["acars"] = heard
    return rec, box["st"]


def _record_bursts(st, rec: dict) -> None:
    """Record each burst watcher's outputs (soft bits, frequency, tone
    quality) into ``rec["bursts"]``."""
    for topic, dm in st.burst_demods.items():
        def process(samples, _p=dm.process, _t=topic):
            outs = _p(samples)
            rec["bursts"] += [(_t, o["soft_bits"].tobytes(), repr(o["freq"]),
                               repr(o["tone_quality"])) for o in outs]
            return outs
        dm.process = process


def _mark_captures(st, rec: dict, unit: int) -> None:
    """Note in ``rec["captured"]`` the step objects of ``st`` (by name:
    device and drain steps) that captured since the last note, at drain
    or block ``unit`` (counted from 1)."""
    now = {}
    for s in (*device_steps(st), *drain_steps(st).values()):
        now[s.name] = now.get(s.name, 0) + s.captures
    seen = rec.get("seen", {})
    new = {k: v - seen.get(k, 0) for k, v in now.items()
           if v > seen.get(k, 0)}
    if new:
        rec["captured"].append((unit, new))
    rec["seen"] = now


def _capture_timeline(rec: dict) -> str:
    """``rec["captured"]`` as text: each drain or block with a capture,
    and what captured there."""
    return "; ".join(f"{u}: " + ", ".join(f"{k} {n}" for k, n in new.items())
                     for u, new in rec.get("captured", ())) or "none"


# the single-VFO decoder's retune in phase 14: after this many blocks
DECODE_RETUNE_BLOCK = 3


def _decode_main_run(fixture: str) -> tuple:
    """``decode_main`` in-process on cuda on a fixture of tests/fixtures,
    with each demodulated block's outputs and the jsondump records
    (timestamps aside) recorded, and a retune in the stream: after block
    ``DECODE_RETUNE_BLOCK`` the decoder's ``_set_center`` retunes the
    demodulator to the frequency it tracks (mse, slope and clock carries
    reset, as a hunter's retune does).  Its ACARS must reach the
    fixture's parity of phase 12.  Returns (the record, the decoder)."""
    from aero_tpu_torch.runtime import decode_main, decoder as decoder_mod
    rate, least = PARITY_FIXTURES[fixture]
    base = os.path.join(ROOT, "tests", "fixtures", fixture)
    rec = {"blocks": [], "acars": [], "captured": []}
    box = {}
    plain = decoder_mod.Decoder

    class Recorded(plain):
        def __init__(self, opts):
            super().__init__(opts)
            box["dec"] = self

        def _consume(self, out):
            rec["blocks"].append(b"".join(
                np.ascontiguousarray(out[k]).tobytes() for k in sorted(out)))
            _mark_captures(self, rec, len(rec["blocks"]))
            if len(rec["blocks"]) == DECODE_RETUNE_BLOCK:
                self._set_center(float(self.demod.state.freq[0]))
            super()._consume(out)
    out = io.StringIO()
    decoder_mod.Decoder = Recorded
    try:
        with contextlib.redirect_stdout(out):
            rc = decode_main.main([
                "-b", str(rate), "--input-file", base + ".wav", "--device",
                "cuda", "--format", "jsondump", "-s", "CHIP-SMOKE"])
    finally:
        decoder_mod.Decoder = plain
    torch.cuda.synchronize()
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    got = tpc.parity(lines, base + ".expected.jsonl")
    if rc != 0 or got["parity_pct"] < least:
        raise AssertionError(f"decode_main {fixture}: rc {rc}, parity {got}")
    for ln in lines:
        r = json.loads(ln)
        r.pop("t", None)
        rec["acars"].append(_canon(r))
    rec["parity"] = got["parity_pct"]
    return rec, box["dec"]


def device_steps(st) -> list:
    """The graphed device steps of a station (one key each: the captures
    ``st.captures`` counts) or of a single-VFO decoder (its
    demodulator's)."""
    if isinstance(st, FusedStation):
        return list(st._steps)
    if not hasattr(st, "channelizer"):
        return list(st.demod.steps)
    ch = st.channelizer
    groups = (list(ch._steps.values()) if isinstance(ch, PfbChannelizer)
              else [*ch._main_steps.values(), *ch._sub_steps.values()])
    return groups + [s for b in st.banks.values() for s in b._steps]


def drain_steps(st) -> dict:
    """The graphed steps a station runs in its drain or host loop, by
    name: each framer bank's batched decode, P or C (a key per padded
    batch) and each burst watcher's detection statistics (a key per ring
    bucket) and window function (one key)."""
    banks = [*getattr(st, "_batch_banks", {}).items(),
             *getattr(st, "_c_banks", {}).items()]
    out = {f"{key} {bank._decode.name}": bank._decode for key, bank in banks}
    for topic, dm in getattr(st, "burst_demods", {}).items():
        out.update({f"{topic} {s.name}": s for s in dm.steps})
    return out


def _captures_text(steps: dict) -> str:
    """Captures by step name (a family: its watchers' or banks' steps
    together), with the step objects and keys."""
    fams = {}
    for s in steps.values():
        c = fams.setdefault(s.name, [0, 0, 0])
        c[0] += s.captures
        c[1] += 1
        c[2] += s.keys
    return "; ".join(f"{f}: {c} captures in {n} objects, {k} keys"
                     for f, (c, n, k) in fams.items()) or "none"


def _classic_run(argv) -> tuple:
    """``station_main`` with the classic station (``--backend tree`` or
    ``pfb``): the channelizer's payloads, every bank output, the burst
    watchers' outputs and the ACARS recorded, and the hunters' retunes
    counted; returns (the record, the station)."""
    rec = {"channelizer": [], "banks": [], "bursts": [], "retunes": 0,
           "captured": []}

    def hook(st):
        process = st.channelizer.process

        def channelizer(iq, _p=process):
            _mark_captures(st, rec, len(rec["channelizer"]))
            out = _p(iq)
            rec["channelizer"].append(out)
            return out
        st.channelizer.process = channelizer
        _record_bursts(st, rec)
        for key, bank in st.banks.items():
            def step(x, _p=bank.process_block, _k=key):
                out = _p(x)
                rec["banks"].append((repr(_k), {
                    k: v.cpu().numpy() for k, v in out.items()}))
                return out

            def retune(rows, freqs, _r=bank.retune):
                rec["retunes"] += 1
                _r(rows, freqs)
            bank.process_block, bank.retune = step, retune
    box, heard = {}, []
    run_station_main(argv, box, heard, {}, prepare=hook)
    _mark_captures(box["st"], rec, len(rec["channelizer"]))
    rec["acars"] = heard
    return rec, box["st"]


def _bench_run(blocks) -> tuple:
    """The bench's throughput station (the 50-VFO bank, int4, 8 blocks
    per step, 2 steps in flight) over quantized ``blocks``, each drained
    packed buffer recorded; returns (the record, the station)."""
    st = FusedStation(load_ini(bench.bank_ini(50), is_text=True),
                      ingest_dtype="int4", blocks_per_step=8,
                      pipeline_depth=2, device="cuda")
    rec = {"packed": [], "telemetry": [], "depth": 0, "acars": []}
    st.on_acars = lambda topic, item: rec["acars"].append(
        (topic, item.message))
    drain = st._drain

    def recording(packed):
        rec["depth"] = max(rec["depth"], len(st._inflight) + 1)
        rec["packed"].append(packed.cpu().numpy())
        drain(packed)
        rec["telemetry"].append(_canon(st.vfo_telemetry()))
    st._drain = recording
    for q in blocks:
        st.process(q)
    st.flush()
    return rec, st


def _differences(a: dict, b: dict) -> list:
    """What differs between two runs' records (empty: byte for byte
    equal)."""
    out = []
    for k in a:
        if k in ("retunes", "depth", "captured", "seen"):
            continue
        x, y = a[k], b[k]
        if k == "packed":
            if len(x) != len(y):
                out.append(f"{k}: {len(x)} vs {len(y)} buffers")
                continue
            n = sum(int((u != v).sum()) for u, v in zip(x, y))
            if n:
                out.append(f"packed: {n} of {sum(u.size for u in x)} "
                           "bytes differ")
        elif k == "banks":
            n = sum(int((u[1][f] != v[1][f]).sum())
                    for u, v in zip(x, y) for f in u[1])
            if len(x) != len(y) or n:
                out.append(f"banks: {n} values differ over {len(x)} steps")
        elif x != y:
            out.append(f"{k} differ")
    return out


def phase_graphs(card: str, workdir: str, lband: dict, cband: dict,
                 classic: dict) -> None:
    """Graphed against eager on every path: the L band, the C band, the
    classic 54W, the filterbank station of phase 9, the L band over two
    shards, the bench's 8-per-step, depth-2 station and ``decode_main``
    on the three fixtures with a retune in the stream, each run eager,
    graphed and eager again on the same input: the graphed run must equal
    the eager one byte for byte (packed buffers, telemetry after every
    drain, each batched decode's bits and CRC flags, each burst window's
    outputs, ACARS in order, the C band's voice file, the classic
    channelizers' payloads and bank outputs, the decoder's every block),
    unless two eager runs already differ; every device step object must
    have been captured once (the hunters' and the decoder's retunes
    recapture nothing), and every step of a drain (batched decodes, burst
    statistics and windows) once per key.  Then each path's times in both
    modes, in turns (eager, graphed, graphed, eager): the serial block's
    stages with the drain split by stage, the step alone (host enqueue,
    CUDA events, the profiler's device operations, graph launches and
    device time, the idle share) and the captures; the filterbank
    station's channelizer and the decoder's block."""
    fused = ["--backend", "fused", "--batch-framing", "--device", "cuda",
             "--ingest-dtype", "int4", "--format", "jsondump", "-s",
             "CHIP-SMOKE", "--stats-every", "1e9"]
    l_argv = ["-c", lband["ini"], "--iq-file", lband["iq"]] + fused
    voices = iter(range(100))
    classic_flags = ["--device", "cuda", "--format", "jsondump", "-s",
                     "CHIP-SMOKE", "--stats-every", "1e9"]
    k_argv = ["-c", l54.INI_PATH, "--iq-file", classic["paths"]["w"],
              "--backend", "tree"] + classic_flags
    p_argv = ["-c", lband["ini"], "--iq-file", lband["iq"], "--backend",
              "pfb"] + classic_flags
    rng = np.random.default_rng(12)
    probe = FusedStation(load_ini(bench.bank_ini(50), is_text=True),
                         ingest_dtype="int4", device="cpu")
    blocks = [probe.quantize((0.02 * (rng.standard_normal(
        (probe.block_len, 2)) @ [1, 1j])).astype(np.complex64))
        for _ in range(40)]
    del probe

    def c_run():
        voice = os.path.join(workdir, f"voice{next(voices)}.bin")
        rec, st = _fused_run(["-c", cband["ini"], "--iq-file", cband["iq"],
                              "--voice-out", voice] + fused)
        with open(voice, "rb") as f:
            rec["voice"] = f.read()
        return rec, st
    paths = {
        "L band": lambda: _fused_run(l_argv),
        "C band": c_run,
        "classic 54W": lambda: _classic_run(k_argv),
        "pfb": lambda: _classic_run(p_argv),
        "L band, 2 shards": lambda: _fused_run(
            l_argv, prepare=lambda st: st.shard(card_mesh(2))),
        "bench 8 per step, depth 2": lambda: _bench_run(blocks),
    }
    paths.update({f"decode_main {fx}": (lambda fx=fx: _decode_main_run(fx))
                  for fx in PARITY_FIXTURES})
    stations = {}
    for name, run in paths.items():
        t0 = time.perf_counter()
        recs, drains = {}, {}
        for i, mode in enumerate(("eager", "graphed", "eager")):
            with _mode(mode):
                recs[i], st = run()
            torch.cuda.synchronize()
            drains[mode] = drain_steps(st)
            if mode == "graphed":
                stations[name] = st
        g = stations[name]
        steps = device_steps(g)
        captures = sum(s.captures for s in steps)
        eager_eager = _differences(recs[0], recs[2])
        graph_eager = _differences(recs[1], recs[0])
        extra = (f", {recs[1]['retunes']} hunter retunes"
                 if "retunes" in recs[1] else "")
        extra += (f", {recs[1]['depth']} dispatches in flight at most"
                  if "depth" in recs[1] else "")
        extra += (f", {len(recs[1]['frames'])} batch-decoded frames, "
                  f"{len(recs[1]['bursts'])} burst outputs"
                  if "frames" in recs[1] else "")
        extra += (f", a retune after block {DECODE_RETUNE_BLOCK}, parity "
                  f"{recs[1]['parity']}%" if "parity" in recs[1] else "")
        n_units = len(recs[1].get("packed", recs[1].get(
            "channelizer", recs[1].get("blocks"))))
        log(f"graphs, {name}: graphed vs eager "
            f"{graph_eager or 'byte for byte equal'}; eager vs eager "
            f"{eager_eager or 'byte for byte equal'}; {n_units} drains or "
            f"blocks, {len(recs[1]['acars'])} ACARS; captures {captures} "
            f"for {len(steps)} device step objects{extra}; drain steps: "
            f"{_captures_text(drains['graphed'])}; captured at drain or "
            f"block: {_capture_timeline(recs[1])} "
            f"({time.perf_counter() - t0:.1f} s; {card})")
        if graph_eager and not eager_eager:
            raise AssertionError(f"{name}: graphed differs from eager: "
                                 f"{graph_eager}")
        if captures != len(steps):
            raise AssertionError(f"{name}: {captures} captures for "
                                 f"{len(steps)} steps")
        twice = [k for k, s in drains["graphed"].items()
                 if s.captures != s.keys]
        eager_captured = [k for k, s in drains["eager"].items() if s.captures]
        if twice or eager_captured:
            raise AssertionError(f"{name}: drain steps captured twice for a "
                                 f"key {twice}, or eagerly {eager_captured}")
        if "frames" in recs[1] and not any(
                s.captures for s in drains["graphed"].values()):
            raise AssertionError(f"{name}: no drain step was graphed")
        if "depth" in recs[1] and recs[1]["depth"] < 2:
            raise AssertionError(f"{name}: never two dispatches in flight")
    os.remove(cband["iq"])

    # times, in turns
    wide = {"L band": make_wideband(lband["block_len"], 6, seed=9),
            "C band": cband_wideband(FS, cband["layout"], cband["content"],
                                     6 * stations["C band"].block_len,
                                     seed=8)}
    k_wide = np.fromfile(classic["paths"]["w"], np.complex64)[
        : 12 * l54.BLOCK]
    k_st, retunes = stations["classic 54W"], [0]
    captures = k_st.captures
    for bank in k_st.banks.values():
        def counted(rows, freqs, _r=bank.retune):
            retunes[0] += 1
            _r(rows, freqs)
        bank.retune = counted
    for mode in ("eager", "graphed", "graphed", "eager"):
        with _mode(mode):
            for name, st in stations.items():
                if name in wide:
                    stage_times(st, wide[name], card, name)
                elif name == "classic 54W":
                    classic_stage_times(st, k_wide, card, name)
                elif name == "pfb":
                    classic_stage_times(st, wide["L band"], card, name)
                elif name.startswith("decode_main"):
                    decoder_times(st, name.split()[1], card)
                else:
                    q = blocks[0] if name.startswith("bench") else \
                        st.quantize(wide["L band"][: st.block_len])
                    step_times(st, q, card, name)
    # the empty VFOs' hunters retune their banks (15 silent bank steps,
    # one per 2.67 blocks): in place, no capture
    n = 0
    while retunes[0] == 0 and n < 96:
        k_st.process(k_wide[(n % 12) * l54.BLOCK:(n % 12 + 1) * l54.BLOCK])
        n += 1
    log(f"classic 54W hunters: {retunes[0]} bank retunes over the timed "
        f"blocks and {n} more, captures {k_st.captures} ({card})")
    if retunes[0] == 0 or k_st.captures != captures:
        raise AssertionError(f"classic 54W: {retunes[0]} retunes, captures "
                             f"{captures} -> {k_st.captures}")
    for name, st in stations.items():
        twice = [k for k, s in drain_steps(st).items() if s.captures != s.keys]
        if twice or sum(s.captures for s in device_steps(st)) != len(
                device_steps(st)):
            raise AssertionError(f"{name}: recaptured while timed: {twice}")


def decoder_times(dec, fixture: str, card: str) -> None:
    """The single-VFO decoder's time per block on a fixture, fed again to
    the decoder of a ``decode_main`` run (warm; its graph, in a graphed
    run, captured): the demodulator's step with its outputs copied back,
    and the whole ``feed_audio`` of the block (with the host framing, SU
    dispatch and ACARS out), medians over the blocks, host clock."""
    import wave
    with wave.open(os.path.join(ROOT, "tests", "fixtures",
                                fixture + ".wav"), "rb") as w:
        rate, data = w.getframerate(), w.readframes(w.getnframes())
    L = dec.demod.cfg.block_len
    demod_ms, block_ms = [], []
    process = dec.demod.process

    def timed(x):
        t0 = time.perf_counter()
        out = process(x)
        demod_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    dec.demod.process = timed
    with contextlib.redirect_stdout(io.StringIO()):
        for b in range(len(data) // (2 * L)):
            t0 = time.perf_counter()
            dec.feed_audio(data[2 * L * b: 2 * L * (b + 1)], rate)
            block_ms.append(1e3 * (time.perf_counter() - t0))
    del dec.demod.process
    mode = "graphed" if graphs_enabled() else "eager"
    log(f"decode_main {fixture} ({mode}): block of {L} samples at {rate} "
        f"S/s ({1e3 * L / rate:.1f} ms of audio), median of "
        f"{len(block_ms)}: demodulator {float(np.median(demod_ms)):.3f} ms, "
        f"feed_audio {float(np.median(block_ms)):.3f} ms; captures "
        f"{sum(s.captures for s in dec.demod.steps)} ({card})")


def main() -> int:
    # every station is built traced: the stage times read its spans
    TRACER.on = True
    card = phase_environment()
    kern = phase_kernel(card)
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=workdir)
    try:
        t0 = time.perf_counter()
        lband = phase_main_path(card, tmp)
        st = lband["station"]
        phase_step_vs_cpu(st, make_wideband(st.block_len, 1, seed=7),
                          "L-band")
        log(f"phases 3-4: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        cband = phase_cband(card, tmp)
        st = cband["station"]
        stage_times(st, cband_wideband(FS, cband["layout"], cband["content"],
                                       6 * st.block_len, seed=8),
                    card, "C-band")
        phase_step_vs_cpu(st, cband_wideband(
            FS, cband["layout"], cband["content"], st.block_len, seed=7),
            "C-band")
        log(f"phases 5-6: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        classic = phase_classic(card, tmp)
        st = classic["station"]
        wide = np.fromfile(classic["paths"]["w"], np.complex64)
        classic_stage_times(st, wide[: 12 * l54.BLOCK], card)
        phase_classic_vs_cpu(st, wide[12 * l54.BLOCK: 13 * l54.BLOCK], tmp)
        del wide
        log(f"phase 7: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        phase_checkpoints(card, tmp, lband, classic)
        log(f"phase 8: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        pfb = phase_pfb(card, lband)
        log(f"phase 9: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        phase_time_shards(card, lband["block_len"])
        sharded = phase_sharded_fused(card, lband)
        phase_sharded_checkpoint(card, tmp, sharded)
        sclassic = phase_sharded_classic(card, classic)
        log(f"phase 10: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        phase_selftest(card)
        log(f"phase 11: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        envelopes = phase_envelopes(card, tmp)
        log(f"phase 12: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        benched = phase_bench(card)
        log(f"phase 13: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        phase_graphs(card, tmp, lband, cband, classic)
        log(f"phase 14: {time.perf_counter() - t0:.1f} s ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = (lband["launches"] + cband["launches"] + classic["launches"]
                + pfb["launches"] + sharded["launches"]
                + sclassic["launches"] + envelopes["launches"]
                + benched["launches"])
    log(f"kernel launches on the main paths: {launches} (L-band "
        f"{lband['launches']}, C-band P bank "
        f"{cband['launches'] - cband['rt'] - cband['c']}, C-band C bank "
        f"{cband['c']}, C-band R/T framers "
        f"{cband['rt']}, classic 54W R/T framers {classic['rt']}, pfb "
        f"{pfb['launches']}, sharded L-band {sharded['launches']} (P bank "
        f"{sharded['launches'] - sharded['rt']}, R/T framers "
        f"{sharded['rt']}), sharded classic 54W {sclassic['launches']}, "
        f"envelopes and soak {envelopes['launches']} (soak "
        f"{envelopes['soak_launches']}), bench {benched['launches']})")
    ms, dev_ms, plain_ms, bound_ms, bound_by = kern["timing"][(64, 631)]
    print(json.dumps({"kernels": [{
        "name": "viterbi_decode_soft_cuda",
        "route": "cuda",
        "source": "aero_tpu_torch/csrc/viterbi.cu",
        "replaces": "aero_tpu/ops/pallas/viterbi_kernel.py:105",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": ms,
        "device_ms": dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
