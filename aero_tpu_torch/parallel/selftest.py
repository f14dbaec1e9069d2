"""Multi-process (multi-host) self-test worker (torch).

Counterpart of ``aero_tpu/parallel/selftest.py``: run one instance per
process; together they form one global mesh over ``torch.distributed``
and run, each stage checked against a local unsharded pass:

- ``MH-SELFTEST``: the time-sharded halo FIR, halos crossing the process
  boundary, against ``np.convolve`` (max error < 1e-4);
- ``MH-THROUGHPUT``: its aggregate rate over the processes;
- ``MH-PFBTIME``: the time-sharded WOLA filterbank, bit-identical to the
  local unsharded pass;
- ``MH-VFOBANK``: an MSK bank whose rows live in different processes
  (soft bytes within +-1 on > 99.9%);
- ``MH-SCALING``: the same bank's rate in one process alone against all
  processes together;
- ``MH-FUSEDSTATION``: the whole fused station step sharded over the
  processes (soft bytes within +-1 on > 99.9%, telemetry to
  rtol = atol = 1e-4).

Usage (one line per process, the same coordinator):

    python -m aero_tpu_torch.parallel.selftest --process-id 0 \\
        --num-processes 2 --device cpu --backend gloo
    python -m aero_tpu_torch.parallel.selftest --process-id 1 \\
        --num-processes 2 --device cpu --backend gloo

``--device cuda`` computes on card ``process_id % visible cards``;
``--backend nccl`` needs a card per process, ``gloo`` copies what crosses
between processes through host memory (two processes may then share one
card).  ``--shards-per-process`` shards each process's part over that many
shards of its device.  Exit code 0 only when every stage passed.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from aero_tpu_torch.device import resolve_device, set_fp32_precision
from aero_tpu_torch.parallel.mesh import Mesh
from aero_tpu_torch.parallel.multihost import (gather_to_hosts,
                                               init_distributed,
                                               make_global_mesh,
                                               scatter_time_shards)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="127.0.0.1:29621")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--shards-per-process", type=int, default=4)
    ap.add_argument("--samples-per-device", type=int, default=8192)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    args = ap.parse_args(argv)

    # one intra-op thread per process: the processes of one host share
    # its cores, and at these shapes (banks of a few rows) more threads
    # cost more in their waits than they compute
    torch.set_num_threads(1)
    if args.device == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", args.process_id
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        set_fp32_precision()
    else:
        dev = torch.device("cpu")

    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     args.backend)
    try:
        mesh = make_global_mesh(vfo_per_host=False,
                                local_devices=[dev] * args.shards_per_process)
        return _stages(args, dev, mesh)
    finally:
        dist.destroy_process_group()


def _stages(args, dev: torch.device, mesh: Mesh) -> int:
    """Every stage on this process's part of the global mesh; 0 when all
    passed."""
    from aero_tpu_torch.ops.design import HALFBAND_TAPS
    from aero_tpu_torch.parallel.time_shard import (
        halo_filter_time_sharded, pfb_channelize_time_sharded)

    n_dev = mesh.shape["time"]
    n_local = len(mesh.devices)
    per_dev = args.samples_per_device
    local_n = n_local * per_dev
    total = n_dev * per_dev
    pid = args.process_id

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # deterministic global signal; each process makes only its slice
    def sig(i0, n):
        t = np.arange(i0, i0 + n, dtype=np.float64)
        return (np.sin(2 * np.pi * 0.01 * t)
                + 0.25 * np.sin(2 * np.pi * 0.07 * t + 0.5)
                ).astype(np.float32)

    local = sig(pid * local_n, local_n)
    taps = HALFBAND_TAPS[23].astype(np.float32)
    fn = halo_filter_time_sharded(mesh, taps)
    y = gather_to_hosts(mesh, fn(scatter_time_shards(mesh, local)))
    ref = np.convolve(sig(0, total), taps, mode="full")[:total]
    err = float(np.max(np.abs(y - ref)))
    ok = err < 1e-4
    print(f"MH-SELFTEST-{'OK' if ok else 'FAIL'} proc={pid} "
          f"procs={args.num_processes} devices={n_dev} "
          f"samples={total} max_err={err:.2e}", flush=True)

    # aggregate rate of the cross-process filter (each iteration
    # exchanges its halos; on CPU shards this is the host's rate)
    gx = scatter_time_shards(mesh, local)
    fn(gx)
    sync()
    t0 = time.perf_counter()
    iters = 20
    for _ in range(iters):
        fn(gx)
    sync()
    dt = time.perf_counter() - t0
    print(f"MH-THROUGHPUT proc={pid} "
          f"{iters * total / dt / 1e6:.1f} MS/s aggregate over "
          f"{args.num_processes} processes", flush=True)

    # ---- stage 1b: the time-sharded WOLA filterbank across processes,
    # bit-identical to the local unsharded pass ----
    from aero_tpu_torch.channelizer.pfb import pfb_channelize, pfb_init

    Kp = 32
    Tp = n_dev * (Kp // 2) * 24
    prng = np.random.default_rng(5)
    xg = (prng.standard_normal(Tp)
          + 1j * prng.standard_normal(Tp)).astype(np.complex64)
    per_proc = Tp // args.num_processes
    z_sh = gather_to_hosts(
        mesh, pfb_channelize_time_sharded(mesh, Kp)(
            pfb_init(Kp, device=dev),
            scatter_time_shards(mesh, xg[pid * per_proc:(pid + 1) * per_proc])),
        dim=1)
    _, z_ref = pfb_channelize(pfb_init(Kp, device=dev),
                              torch.from_numpy(xg).to(dev), Kp)
    ok1b = bool(np.array_equal(z_sh, z_ref.cpu().numpy()))
    print(f"MH-PFBTIME-{'OK' if ok1b else 'FAIL'} proc={pid} "
          f"K={Kp} T={Tp}", flush=True)

    # ---- stage 2: an MSK bank whose rows live in different processes,
    # against an unsharded per-row local reference ----
    from aero_tpu_torch.models.msk import (make_config, msk_init, msk_modulate,
                                           msk_step)
    from aero_tpu_torch.parallel.vfo_bank import MskVfoBank

    vmesh = Mesh(mesh.devices, ("vfo",), mesh.process_count,
                 mesh.process_index, mesh.backend)
    B = n_dev
    kw = dict(block_len=4800, nfft=4096, fine_step_hz=1.0)
    cfg = make_config(24000.0, 1200.0, **kw)
    L = cfg.block_len
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 700).astype(np.uint8)
    one = msk_modulate(bits, 24000.0, 1200.0)[: 2 * L]
    amps = (0.5 + 0.05 * np.arange(B)).astype(np.float32)
    rows = (amps[:, None] * one[None, :]).astype(np.float32)

    bank = MskVfoBank(B, 24000.0, 1200.0, mesh=vmesh, **kw)
    got = np.concatenate([bank.process_block(rows[:, b * L:(b + 1) * L])
                          ["soft_bits"].cpu().numpy() for b in range(2)],
                         axis=-1)
    ref_rows = []
    for r in range(B):
        st = msk_init(cfg, 1, dev)
        row = []
        for b in range(2):
            st, out = msk_step(st, torch.from_numpy(
                rows[r:r + 1, b * L:(b + 1) * L]).to(dev), cfg)
            row.append(out["soft_bits"][0].cpu().numpy())
        ref_rows.append(np.concatenate(row))
    ref2 = np.stack(ref_rows)
    # a shard steps fewer rows than the whole bank, so a reduction may
    # run in another order and flip a rounded soft byte by 1 at a
    # quantization boundary — demand near-exactness
    close = np.abs(got.astype(int) - ref2.astype(int)) <= 1
    ok2 = bool(close.mean() > 0.999)
    print(f"MH-VFOBANK-{'OK' if ok2 else 'FAIL'} proc={pid} "
          f"rows={B} match={100.0 * close.mean():.2f}%", flush=True)

    # ---- scaling efficiency: the same bank workload in one process
    # alone (the others wait at a barrier, so they cannot deflate the
    # baseline) against all processes together ----
    def time_bank(bk, x, iters=30):
        bk.process_block(x)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            bk.process_block(x)
        sync()
        return iters / (time.perf_counter() - t0)

    lo = pid * n_local
    rate1 = 0.0
    for turn in range(args.num_processes):
        dist.barrier()
        if turn == pid:
            lbank = MskVfoBank(n_local, 24000.0, 1200.0,
                               mesh=Mesh(mesh.devices, ("vfo",)), **kw)
            rate1 = time_bank(lbank, rows[lo:lo + n_local, :L]) * n_local * L
    dist.barrier()
    gbank = MskVfoBank(B, 24000.0, 1200.0, mesh=vmesh, **kw)
    rateN = time_bank(gbank, rows[:, :L]) * B * L
    eff = rateN / (args.num_processes * rate1)
    print(f"MH-SCALING proc={pid} single={rate1 / 1e6:.1f} "
          f"MS/s ({n_local} rows) aggregate={rateN / 1e6:.1f} MS/s "
          f"({B} rows over {args.num_processes} procs) "
          f"efficiency={100.0 * eff:.0f}%", flush=True)

    # ---- stage 3: the whole fused station step, its VFO rows in
    # different processes, against a local unsharded step of the same
    # block ----
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.fused_station import FusedStation

    vfos = "".join(
        f"{i+1}\\frequency={1545002000 + i * 19000}\n"
        f"{i+1}\\data_rate=1200\n{i+1}\\topic=V{i}\n{i+1}\\gain=100\n"
        for i in range(B))
    ini = ("[General]\nsample_rate=1536000\ncenter_frequency=1545000000\n"
           f"[vfos]\nsize={B}\n{vfos}")

    def mk():
        return FusedStation(load_ini(ini, is_text=True), ingest_dtype="int4",
                            base_block=160, pipeline=False, hunt=False,
                            device=dev)

    srng = np.random.default_rng(7)
    ref_st = mk()
    blk = ref_st.quantize((0.02 * (srng.standard_normal(
        (ref_st.block_len, 2)) @ [1, 1j])).astype(np.complex64))
    iq = torch.from_numpy(blk).to(dev)
    scale = torch.tensor(1.0, device=dev)
    st = mk().shard(vmesh)
    _, packed = st._step_shards(st._shards, iq, scale)
    _, ref_packed = ref_st._step(ref_st._state, iq, scale)
    got_row, ref_row = packed.cpu().numpy(), ref_packed.cpu().numpy()
    soft_n = ref_st._soft_total
    soft_close = (np.abs(got_row[:soft_n].astype(int)
                         - ref_row[:soft_n].astype(int)) <= 1).mean()
    tel_ok = np.allclose(got_row[soft_n:].view(np.float32),
                         ref_row[soft_n:].view(np.float32),
                         rtol=1e-4, atol=1e-4)
    ok3 = bool(tel_ok and soft_close > 0.999)
    print(f"MH-FUSEDSTATION-{'OK' if ok3 else 'FAIL'} "
          f"proc={pid} vfos={B} "
          f"soft_match={100.0 * soft_close:.2f}% tel_match={tel_ok}",
          flush=True)
    return 0 if (ok and ok1b and ok2 and ok3) else 1


if __name__ == "__main__":
    sys.exit(main())
