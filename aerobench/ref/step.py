"""The reference of the fused station's device step, plain PyTorch.

Per wideband block, for a bank of sub VFOs: quantize on the host as the
station's ingest does, dequantize, one WOLA filterbank pass per channel
rate, the bin gather and residual mix to real audio, then per group of
(channel rate, data rate, burst) either the batched MSK or OQPSK demod
step with the hunter, or, for burst watchers, int16 audio with its RMS
and peak; all packed into one uint8 buffer in the station's wire layout
(soft bits or audio bytes of every group, then float32 telemetry per
group, five slots of [rows]).  A frozen, eager rewrite of the port's
``FusedStation._shard_step`` on its own copies of the filterbank and the
demodulators; it takes nothing of the port, so the benchmark can hold
the port's graphed step to it.

``precision``: ``"fp32"`` is the configuration's arithmetic (float32,
TF32 off in cuBLAS and cuDNN); ``"tf32"``, the next step down (TF32
allowed in both), is the control's, the reference run in the program's
place.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict

import numpy as np
import torch

from aerobench.ref import msk as _msk
from aerobench.ref import oqpsk as _oq
from aerobench.ref.nco import cis, fused_mul_add
from aerobench.ref.pfb import (pfb_bin_for_freq, pfb_channelize,
                               pfb_channelize_fused, pfb_init)

AUDIO_I16_SCALE = 4096.0
TEL_SLOTS = 5
GAIN = 10.0              # the station's audio gain after the residual mix
HUNT_MAX_TRIES = 6       # blocks without signal before the hunter steps
BASE_BLOCK = 16000       # channel samples per block at the lowest rate
ISCALE = {"int2": 1.0, "int4": 7.0, "int8": 127.0, "int16": 32767.0,
          "float32": 1.0}


def out_rate(data_rate: int) -> int:
    return {600: 12000, 1200: 24000}.get(data_rate, 48000)


def quantize(iq: np.ndarray, dtype: str) -> np.ndarray:
    """complex64 [T] -> the ingest wire format: int4 packs re << 4 | im as
    two's-complement nibbles of round-half-even(x * 7) clipped to [-8, 7];
    int8/int16 planar [2, T], x * scale clipped to +-scale and truncated
    toward zero; float32 planar."""
    lim = np.float32(ISCALE[dtype])
    re = np.asarray(iq.real, np.float32)
    im = np.asarray(iq.imag, np.float32)
    if dtype == "int4":
        r = np.clip(np.round(re * lim), -8, 7).astype(np.int64)
        i = np.clip(np.round(im * lim), -8, 7).astype(np.int64)
        return (((r & 0xF) << 4) | (i & 0xF)).astype(np.uint8)
    pair = np.stack([re, im])
    if dtype == "float32":
        return pair
    return np.clip(pair * lim, -lim, lim).astype(dtype)


@contextlib.contextmanager
def arithmetic(precision: str):
    """float32 with TF32 off (``"fp32"``) or allowed (``"tf32"``)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
        torch.set_float32_matmul_precision(flags[2])


class RefStation:
    """``vfos``: [(topic, offset_hz, data_rate, burst)] in bank order."""

    def __init__(self, vfos, fs: int, ingest_dtype: str = "int4",
                 hunt: bool = True, device="cpu", precision: str = "fp32"):
        self.device = torch.device(device)
        self.fs = fs
        self.ingest_dtype = ingest_dtype
        self.hunt = hunt
        self.precision = precision
        groups = defaultdict(list)
        for i, (_, _, rate, burst) in enumerate(vfos):
            groups[(out_rate(rate), rate, bool(burst))].append(i)
        self.groups = dict(groups)
        self.order = sorted(self.groups)
        self.K = {r: 2 * fs // r for r, _, _ in self.groups}
        self.block_len = max(BASE_BLOCK * K // 2 for K in self.K.values())
        self.topics, self.params, self.dcfg, self.hunt_cfg = {}, {}, {}, {}
        for key, idxs in self.groups.items():
            r, rate, burst = key
            K = self.K[r]
            F = self.block_len // (K // 2)
            bins, resid = [], []
            for i in idxs:
                delta = vfos[i][1]
                k = pfb_bin_for_freq(delta, fs, K)
                kc = k if k < K // 2 else k - K
                bins.append(k)
                resid.append(-(delta - kc * fs / K) / r)
            self.topics[key] = [vfos[i][0] for i in idxs]
            self.params[key] = (
                torch.as_tensor(np.asarray(bins, np.int64), device=self.device),
                torch.as_tensor(np.asarray(resid, np.float32),
                                device=self.device))
            if burst:
                continue
            mod = _msk if rate in (600, 1200) else _oq
            nfft = min(8192, 1 << (F.bit_length() - 1))
            self.dcfg[key] = (mod, mod.make_config(float(r), float(rate),
                                                   block_len=F, nfft=nfft))
            lo, hi, bw = ((0.0, 6000.0, 900.0) if rate <= 1200
                          else (0.0, 25000.0, 10500.0))
            hi = min(hi, r / 2.0 - rate / 2.0)
            self.hunt_cfg[key] = (lo, hi, bw, self.dcfg[key][1].freq_center)
        self.layout = {}
        pos = tel = 0
        for key in self.order:
            nb = len(self.groups[key])
            if key[2]:
                per = 2 * (self.block_len // (self.K[key[0]] // 2))
            else:
                c = self.dcfg[key][1]
                per = int(round(c.block_len * c.fb / c.fs))
            self.layout[key] = (pos, per, tel)
            pos += nb * per
            tel += TEL_SLOTS * nb
        self.soft_total = pos
        self.packed_len = pos + 4 * tel

    def init_state(self) -> dict:
        st = {"pfb": {r: pfb_init(K, device=self.device)
                      for r, K in self.K.items()}, "grp": {}}
        for key, idxs in self.groups.items():
            nb = len(idxs)
            g = {"phase": torch.zeros(nb, dtype=torch.float32,
                                      device=self.device)}
            st["grp"][key] = g
            if key[2]:
                continue
            mod, c = self.dcfg[key]
            init = mod.msk_init if mod is _msk else mod.oqpsk_init
            g["demod"] = init(c, nb, self.device)
            if self.hunt:
                g["hunt"] = {
                    "tries": torch.zeros(nb, dtype=torch.int32,
                                         device=self.device),
                    "center": torch.full((nb,), self.hunt_cfg[key][3],
                                         dtype=torch.float32,
                                         device=self.device)}
        return st

    def adopt(self, tree) -> dict:
        """A state tree of the station's layout (its demod states are
        named tuples with the same fields) as this reference's, copied
        onto its device."""
        def conv(v):
            return v.detach().to(self.device).clone()
        st = {"pfb": {r: conv(z) for r, z in tree["pfb"].items()},
              "grp": {}}
        for key, g in tree["grp"].items():
            ng = {"phase": conv(g["phase"])}
            if "demod" in g:
                mod = self.dcfg[key][0]
                cls = mod.MskState if mod is _msk else mod.OqpskState
                ng["demod"] = cls(**{f: conv(getattr(g["demod"], f))
                                     for f in cls._fields})
            if "hunt" in g:
                ng["hunt"] = {k: conv(v) for k, v in g["hunt"].items()}
            st["grp"][key] = ng
        return st

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        s = ISCALE[self.ingest_dtype]
        if self.ingest_dtype == "int4":
            hi = (q >> 4).to(torch.int32)
            lo = (q & 0xF).to(torch.int32)
            re = torch.where(hi > 7, hi - 16, hi).to(torch.float32)
            im = torch.where(lo > 7, lo - 16, lo).to(torch.float32)
            return torch.complex(re / s, im / s)
        return torch.complex(q[0].to(torch.float32) / s,
                             q[1].to(torch.float32) / s)

    def _hunt(self, key, s2, sig, hunt):
        lo, hi, bw, _ = self.hunt_cfg[key]
        tries = torch.where(sig, torch.zeros_like(hunt["tries"]),
                            hunt["tries"] + 1)
        fire = tries >= HUNT_MAX_TRIES
        tries = torch.where(fire, torch.zeros_like(tries), tries)
        center = torch.where(fire, hunt["center"] + bw / 2.0, hunt["center"])
        center = torch.where(center > hi, torch.full_like(center,
                                                          lo + bw / 2.0),
                             center)
        c = self.dcfg[key][1]
        tune = torch.clamp(center, 100.0, c.fs / 2.0 - 100.0)
        f = fire[:, None]
        s2 = s2._replace(
            freq=torch.where(fire, tune, s2.freq),
            mse=torch.where(fire, torch.full_like(s2.mse, 2.0), s2.mse),
            have_lock_refs=s2.have_lock_refs & ~fire,
            agc_ema=torch.where(fire, torch.zeros_like(s2.agc_ema),
                                s2.agc_ema),
            coarse_y=torch.where(f, torch.full_like(s2.coarse_y, 20.0),
                                 s2.coarse_y),
            slope=torch.where(fire, torch.zeros_like(s2.slope), s2.slope),
            grid_rate=torch.where(fire, torch.zeros_like(s2.grid_rate),
                                  s2.grid_rate))
        return s2, {"tries": tries, "center": center}

    def step(self, state: dict, iq: np.ndarray):
        """(state, complex64 block [block_len]) -> (new state, packed
        uint8 [packed_len]); the state is not changed in place."""
        q = torch.as_tensor(quantize(iq, self.ingest_dtype),
                            device=self.device)
        with arithmetic(self.precision):
            return self._step(state, q)

    def _step(self, state, q):
        x = self.dequantize(q)
        dev = x.device
        new = {"pfb": {}, "grp": {}}
        z_by = {}
        for r, K in self.K.items():
            chan = (pfb_channelize_fused if (x.shape[-1] // (K // 2)) % 2 == 0
                    else pfb_channelize)
            new["pfb"][r], z_by[r] = chan(state["pfb"][r], x, K)
        parts = {}
        for key in self.order:
            bins, resid = self.params[key]
            g = state["grp"][key]
            zb = z_by[key[0]][bins]
            F = zb.shape[1]
            n = torch.arange(F, dtype=torch.float32, device=dev)
            ramp = fused_mul_add(resid[:, None], n, g["phase"][:, None])
            osc = cis((2.0 * math.pi) * torch.remainder(ramp, 1.0))
            audio = (zb * osc).real.float() * GAIN
            ng = {"phase": torch.remainder(fused_mul_add(resid, F,
                                                         g["phase"]), 1.0)}
            new["grp"][key] = ng
            if key[2]:
                a16 = torch.clamp(torch.round(audio * AUDIO_I16_SCALE),
                                  -32767, 32767).to(torch.int16)
                rms = torch.sqrt(torch.mean(audio * audio, dim=1))
                peak = torch.amax(torch.abs(audio), dim=1)
                zero = torch.zeros_like(rms)
                parts[key] = (a16.contiguous().view(torch.uint8),
                              torch.stack([rms, peak, zero, zero, zero]))
                continue
            mod, c = self.dcfg[key]
            stepf = mod.msk_step if mod is _msk else mod.oqpsk_step
            s2, out = stepf(g["demod"], audio, c)
            if "hunt" in g:
                s2, ng["hunt"] = self._hunt(key, s2, out["signal"], g["hunt"])
            ng["demod"] = s2
            parts[key] = (out["soft_bits"], torch.stack(
                [out["signal"].to(torch.float32), out["mse"].float(),
                 out["ebno"].float(), s2.freq.float(),
                 out["slip"].to(torch.float32)]))
        soft = [parts[k][0].to(torch.uint8).reshape(-1) for k in self.order]
        tel = torch.cat([parts[k][1].float().reshape(-1) for k in self.order])
        return new, torch.cat(soft + [tel.contiguous().view(torch.uint8)])
