"""The multi-device dry run at tiny shapes (torch).

Counterpart of ``__graft_entry__.py:dryrun_multichip``: the two parallel
axes of the system on an n-device mesh, then the whole fused station
sharded over it.

1. a ``time`` mesh runs the time-sharded halfband decimator and the
   time-sharded WOLA filterbank (filter histories crossing as halos);
2. a ``vfo`` mesh runs a sharded MSK bank step;
3. the fused station over all five channel paths (MSK 1200 and 600 P,
   OQPSK 10500 P, OQPSK 8400 C, burst MSK 600) sharded over the ``vfo``
   mesh, with a checkpoint round trip: a station loaded from the sharded
   one's file and sharded the same way steps the next block to equal
   telemetry.

``dryrun_multidevice(4, device="cpu")`` holds 4 shards on the CPU;
``device="cuda"`` takes the first n cards, ``"cuda:0"`` n shards on one.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

# (data rate, first frequency, spacing, topic prefix, extra key) of the
# five channel paths, n VFOs each
FIVE_PATHS = (("1200", 1545002000, 19000, "V", ""),
              ("10500", 1545300000, 48000, "Q", ""),
              ("600", 1544800000, 19000, "S", ""),
              ("8400", 1544300000, 96000, "C", ""),
              ("600", 1544600000, 19000, "B", "burst=1"))


def five_path_ini(nv: int) -> str:
    """The INI text of ``nv`` VFOs on each of the five paths, 1.536 MS/s
    at 1545 MHz (the JAX dry run's bank)."""
    vfos = ""
    idx = 0
    for rate, f0, spacing, tag, extra in FIVE_PATHS:
        for i in range(nv):
            idx += 1
            vfos += (f"{idx}\\frequency={f0 + i * spacing}\n"
                     f"{idx}\\data_rate={rate}\n{idx}\\topic={tag}{i}\n"
                     f"{idx}\\gain=100\n")
            if extra:
                vfos += f"{idx}\\{extra}\n"
    return (f"[General]\nsample_rate=1536000\ncenter_frequency=1545000000\n"
            f"[vfos]\nsize={5 * nv}\n{vfos}")


def dryrun_multidevice(n_devices: int, device="cuda") -> None:
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.channelizer.pfb import pfb_init
    from aero_tpu_torch.device import set_fp32_precision
    from aero_tpu_torch.models.msk import make_config
    from aero_tpu_torch.ops.design import HALFBAND_TAPS
    from aero_tpu_torch.parallel.mesh import gather, make_mesh, shard_over_vfo
    from aero_tpu_torch.parallel.time_shard import (
        halo_decimate_time_sharded, pfb_channelize_time_sharded)
    from aero_tpu_torch.parallel.vfo_bank import MskVfoBank
    from aero_tpu_torch.runtime.fused_station import FusedStation

    set_fp32_precision()

    # --- stage 1: time-sharded channelizer stages ---
    tmesh = make_mesh(n_devices, "time", device)
    T = 512 * n_devices
    x = shard_over_vfo(tmesh, torch.zeros(T, dtype=torch.complex64), "time")
    decim = halo_decimate_time_sharded(tmesh, HALFBAND_TAPS[11], 2)
    y = gather(tmesh, decim(x), 0, "time")
    assert y.shape == (T // 2,)
    Kp = 16
    Tp = n_devices * (Kp // 2) * 16   # shard >= PFB history (7.5*Kp)
    xp = shard_over_vfo(tmesh, torch.zeros(Tp, dtype=torch.complex64),
                        "time")
    z = gather(tmesh, pfb_channelize_time_sharded(tmesh, Kp)(pfb_init(Kp),
                                                             xp), 1, "time")
    assert z.shape == (Kp, Tp // (Kp // 2))

    # --- stage 2: vfo-sharded demod bank ---
    vmesh = make_mesh(n_devices, "vfo", device)
    cfg = make_config(24000.0, 1200.0, block_len=1600, nfft=1024,
                      fine_step_hz=1.0)
    B = 2 * n_devices
    bank = MskVfoBank(B, 24000.0, 1200.0, mesh=vmesh, block_len=1600,
                      nfft=1024, fine_step_hz=1.0)
    out = bank.process_block(np.zeros((B, cfg.block_len), np.float32))
    assert out["soft_bits"].shape == (B, cfg.block_len // (2 * cfg.sps) * 2)

    # --- stage 3: the fused station's five paths, sharded ---
    def make_station():
        return FusedStation(load_ini(five_path_ini(n_devices), is_text=True),
                            ingest_dtype="int4", base_block=160,
                            pipeline=False, device=vmesh.devices[0])

    st = make_station().shard(vmesh)
    rng = np.random.default_rng(0)
    blk = st.quantize((0.02 * (rng.standard_normal((st.block_len, 2))
                               @ [1, 1j])).astype(np.complex64))
    st.process(blk)
    st.flush()
    assert st.telemetry.shape == (5 * 5 * n_devices,)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mesh.ckpt.npz")
        st.save_checkpoint(path)
        st2 = make_station()
        st2.load_checkpoint(path)
        st2.shard(vmesh)
        blk2 = st.quantize((0.02 * (rng.standard_normal((st.block_len, 2))
                                    @ [1, 1j])).astype(np.complex64))
        st.process(blk2)
        st.flush()
        st2.process(blk2)
        st2.flush()
        assert np.array_equal(st.telemetry, st2.telemetry)
