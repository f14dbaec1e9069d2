#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``aero_tpu_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; CUDA must be available; full-fp32 math is set.
2. The CUDA Viterbi kernel (built by nvcc for sm_90a from
   aero_tpu_torch/csrc/viterbi.cu) against its plain-torch twin on the
   card, bit-exact, at the 1200 bps frame shape (B=64, T=631) and the
   10500 shape (B=256, T=2551), on integral, float and all-tie (128)
   soft inputs; both timed with CUDA events after warm-up.
3. The main path: ``aero_tpu_torch.runtime.station_main.main`` in-process
   with ``--backend fused --batch-framing --device cuda --ingest-dtype
   int4`` on the 50-VFO MSK-1200 bank (1.536 MS/s at 1545 MHz, VFOs every
   19 kHz, 1,024,000-sample blocks) over 14 blocks of wideband IQ that
   carry distinct ACARS messages on 4 VFOs in noise.  Every planted
   message must come out on its VFO with no bad SU on the content VFOs,
   the kernel's launch count over this run must be > 0, and the station's
   state tensors must live on the card.
4. One station step on the card against the same step on the host CPU
   (same state, same block): the packed buffer must agree within the
   parity tests' tolerances.

The last two lines of standard output are the kernels' JSON record and the
result line ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, the script fails before printing a
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from aero_tpu_torch import convert
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.device import set_fp32_precision
from aero_tpu_torch.models.msk import msk_modulate
from aero_tpu_torch.ops import viterbi_kernel as vk
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import build_p_frames
from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft
from aero_tpu_torch.runtime import station_main
from aero_tpu_torch.runtime.fused_station import FusedStation, TEL_SLOTS

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_soft import soft_bytes  # noqa: E402  (shared with the tests)

FS = 1536000
CENTER = 1545000000
N_VFOS = 50
N_BLOCKS = 14
CONTENT = {3: ("VH-AAA", "CHIP SMOKE ALPHA", "CHIP SMOKE BRAVO"),
           17: ("N123CS", "CHIP SMOKE CHARLIE", "CHIP SMOKE DELTA"),
           31: ("G-SMKE", "CHIP SMOKE ECHO", "CHIP SMOKE FOXTROT"),
           46: ("C-FCUD", "CHIP SMOKE GOLF", "CHIP SMOKE HOTEL")}


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
    return card


# ---- phase 2 ---------------------------------------------------------------

def _time_ms(fn, n: int) -> float:
    fn()                                   # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def phase_kernel(card: str) -> dict:
    t0 = time.perf_counter()
    so = vk.build(verbose=True)
    log(f"built {os.path.relpath(so, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    max_err = 0
    timing = {}
    for B, T in ((64, 631), (256, 2551)):
        for kind in ("integral", "float", "all128"):
            soft = torch.from_numpy(soft_bytes(kind, B, T,
                                               seed=B + T)).to(dev)
            got = vk.viterbi_decode_soft_cuda(soft)
            torch.cuda.synchronize()
            want = viterbi_decode_soft(soft)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            max_err = max(max_err, err)
            log(f"viterbi B={B} T={T} {kind}: max |kernel - plain| = {err}")
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain at B={B} T={T} "
                                     f"({kind})")
        soft = torch.from_numpy(soft_bytes("integral", B, T, seed=1)).to(dev)
        ms = _time_ms(lambda: vk.viterbi_decode_soft_cuda(soft), 50)
        plain_ms = _time_ms(lambda: viterbi_decode_soft(soft), 2)
        timing[(B, T)] = (ms, plain_ms)
        log(f"viterbi B={B} T={T}: kernel {ms:.4f} ms, plain torch "
            f"{plain_ms:.2f} ms  ({card})")
    return {"max_abs_err": max_err, "timing": timing}


# ---- phase 3 ---------------------------------------------------------------

def bank_ini() -> str:
    """The 50-VFO MSK-1200 bank of bench.py's fused-station headline."""
    vfos = "".join(
        f"{i + 1}\\frequency={CENTER + 2000 + i * 19000}\n"
        f"{i + 1}\\data_rate=1200\n{i + 1}\\topic=V{i}\n"
        f"{i + 1}\\gain=100\n" for i in range(N_VFOS))
    return (f"[General]\nsample_rate={FS}\ncenter_frequency={CENTER}\n"
            f"[vfos]\nsize={N_VFOS}\n{vfos}")


def make_wideband(block_len: int, n_blocks: int,
                  seed: int = 0) -> np.ndarray:
    """Wideband IQ at 1.536 MS/s: one ACARS message per P frame on each
    content VFO (then fill frames to the end), upconverted from 24 kS/s
    audio with resample_poly and shifted to the VFO's frequency, plus
    complex Gaussian noise."""
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
    return wide


def _state_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _state_tensors(v)
    elif isinstance(tree, tuple):
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
        f"{time.perf_counter() - t0:.1f} s")

    box = {}
    heard = []
    su = {f"V{v}": [0, 0] for v in CONTENT}

    def on_station(st):
        box["st"] = st
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

    argv = ["-c", ini, "--iq-file", iq, "--backend", "fused",
            "--batch-framing", "--device", "cuda", "--ingest-dtype", "int4",
            "--format", "jsondump", "-s", "CHIP-SMOKE",
            "--stats-every", "1e9"]
    out = io.StringIO()
    vk.reset_launches()
    with contextlib.redirect_stdout(out):
        rc = station_main.main(argv, on_station=on_station)
    torch.cuda.synchronize()
    launches = vk.LAUNCHES
    if rc != 0:
        raise AssertionError(f"station_main returned {rc}")
    st = box["st"]
    records = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
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
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    devs = {t.device.type for t in _state_tensors(st._state)}
    if devs != {"cuda"}:
        raise AssertionError(f"station state on {devs}, expected cuda")
    n = st.stats.wideband_samples // st.block_len
    rtf = st.stats.realtime_factor / FS
    per_block = 1e3 * st.stats.wall_seconds / max(n, 1)
    log(f"main path: {n} blocks, kernel launches {launches}, "
        f"realtime factor {rtf:.2f}x, {per_block:.1f} ms per block "
        f"(host wall clock incl. first-block warm-up; {card})")
    os.remove(iq)
    return {"station": st, "launches": launches, "ini": ini}


# ---- phase 4 ---------------------------------------------------------------

def phase_step_vs_cpu(st) -> None:
    """One block through the card's station step and the host CPU's, from
    the same state: the packed buffers must agree (tolerances of
    tests/test_torch_station_step.py)."""
    cfg = st.cfg
    cpu = FusedStation(cfg, ingest_dtype=st.ingest_dtype, device="cpu")
    wide = make_wideband(st.block_len, 1, seed=7)
    arr = st.quantize(wide)
    state_np = convert.fused_state_to_numpy(st._state)
    _, gp = st._step(convert.fused_state_from_numpy(state_np, "cuda"),
                     torch.from_numpy(arr).cuda(),
                     torch.tensor(np.float32(1.0), device="cuda"))
    _, cp = cpu._step(convert.fused_state_from_numpy(state_np, "cpu"),
                      torch.from_numpy(arr), torch.tensor(np.float32(1.0)))
    gp, cp = gp.cpu().numpy(), cp.numpy()
    d = np.abs(gp[: st._soft_total].astype(np.int32)
               - cp[: st._soft_total].astype(np.int32))
    frac = float((d <= 1).mean())
    # one rate group: the telemetry is [TEL_SLOTS, 50]
    tg = gp[st._soft_total:].view(np.float32).reshape(TEL_SLOTS, -1)
    tc = cp[st._soft_total:].view(np.float32).reshape(TEL_SLOTS, -1)
    mse_rel = np.abs(tg[1] - tc[1]) / np.maximum(np.abs(tc[1]), 1e-30)
    log(f"step on card vs CPU: soft bytes within +-1 on {frac:.6f}, "
        f"lock flags equal {bool((tg[0] == tc[0]).all())}, "
        f"max rel mse diff {float(mse_rel.max()):.3g}, "
        f"max |Eb/N0| diff {float(np.abs(tg[2] - tc[2]).max()):.3g} dB, "
        f"max |freq| diff {float(np.abs(tg[3] - tc[3]).max()):.3g} Hz, "
        f"slips equal {bool((tg[4] == tc[4]).all())}")
    if not np.isfinite(tg).all():
        raise AssertionError("non-finite telemetry on the card")
    if frac < 0.999:
        raise AssertionError(f"soft bytes agree on only {frac:.6f}")
    np.testing.assert_array_equal(tg[0], tc[0])              # lock flags
    np.testing.assert_allclose(tg[1], tc[1], rtol=1e-4)      # mse
    np.testing.assert_allclose(tg[2], tc[2], atol=1e-3)      # Eb/N0 dB
    np.testing.assert_allclose(tg[3], tc[3], atol=2e-3)      # freq Hz
    np.testing.assert_array_equal(tg[4], tc[4])              # slips


def main() -> int:
    card = phase_environment()
    kern = phase_kernel(card)
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=workdir)
    try:
        main_path = phase_main_path(card, tmp)
        phase_step_vs_cpu(main_path["station"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms, plain_ms = kern["timing"][(64, 631)]
    print(json.dumps({"kernels": [{
        "name": "viterbi_decode_soft_cuda",
        "route": "cuda",
        "source": "aero_tpu_torch/csrc/viterbi.cu",
        "replaces": "aero_tpu/ops/pallas/viterbi_kernel.py:105",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
