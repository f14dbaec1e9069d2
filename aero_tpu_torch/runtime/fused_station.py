"""Device-resident station on PyTorch: one device step per wideband block.

Counterpart of ``aero_tpu/runtime/fused_station.py`` (read its docstring
for the design).  Per wideband block the step does, on the station's
device,

    quantized IQ (int2/int4/int8/int16/float32)
      -> dequantize -> complex wideband
      -> one WOLA polyphase filterbank pass per output rate (all VFOs)
      -> per-VFO residual mix -> real audio
      -> continuous VFOs: a batched demod step per rate group (MSK
         600/1200 -> P channel, OQPSK 10500 -> P, OQPSK 8400 -> C)
         + per-VFO signal hunting
      -> burst (R/T) VFOs: int16 audio for the host burst window
         demodulators, with its RMS and peak as telemetry
      -> ONE packed uint8 buffer: soft bits / burst audio [B, n] + float32
         telemetry (lock/mse/EbN0/freq/slip) viewed as bytes

and only that buffer leaves the device; its layout is byte-compatible with
the JAX station's.  Host work is the same code as in JAX: P-channel
framers (batched decode on the station's device with ``--batch-framing``),
C-channel framers (voice + signalling) for 8400 (with ``--batch-framing``
a drain's C frames decode in one batched call on the station's device,
``protocol/batch_c_framing.py``), and for burst VFOs the
burst window demodulators and R/T framers, whose window functions,
detection statistics and checkpoint Viterbi decodes run on the station's
device.

Where JAX jits the step (``_get_step``), the port runs it on a card as
one CUDA-graph replay per block (``utils/graphs.py``): each shard's step
(dequantize, filterbank, residual mix, demods, hunter, burst audio and the
packing) is captured once, its state held in static buffers that the
replay updates in place; ``device.disable_graphs()`` runs the same step
eagerly.  The upload, the joins of several shards, ``_drain`` with its
host framing, the Viterbi kernel and the burst window demods stay eager.

``blocks_per_step``: m blocks upload together and run as m steps (m
replays of the one-block graph, which also serves the shorter last
dispatch of a ``flush``; JAX scans m blocks in one executable) before one
packed [m, n] result is queued, a fresh tensor that no later replay
writes.  ``pipeline_depth``: d such results stay in flight (the device
runs ahead of the host framing) before the host copies the oldest back.

``shard(mesh)`` cuts every per-VFO carry over a device mesh
(``parallel/mesh.py``); each shard then steps its rows on its device, and
the shards' outputs are joined into the one packed buffer of JAX's layout.

``pfb_oversample``: the filterbank plan (``channelizer/pfb.py``).  2, the
default, is JAX's: K = 2*fs/out_rate bins, hop K/2, a passband that holds
a VFO's band only near its bin's centre.  4: K = 4*fs/out_rate, hop K/4,
the same channel rate, block and packed layout, bins half as far apart
and a prototype that passes a VFO anywhere in its bin with its band (the
C band's 34 kHz raster puts VFOs up to 11 kHz from a 24 kHz bin's
centre, 5 kHz from a 12 kHz one's).  On the 4x plan each VFO's residual
mix also starts at the phase of the filterbank's delay
(``channelizer/pfb.py:pfb_delay``), so the mix runs on the input's clock
as a mixer at the VFO would: a VFO d Hz from its bin's centre otherwise
leaves the filterbank with its carrier turned by 2 pi d delay / fs, and
the real part of a signal carried on both sides of the VFO scales by the
cosine of that angle (on the 2x plan, JAX's, whose residual phases start
at 0, a C-band VFO 5 kHz off its bin's centre keeps 0.13 of its
amplitude, an L-band VFO half a bin off none).  The state's filterbank
carry is L - M samples of the plan; a checkpoint restores only into a
station of the same plan.
"""

from __future__ import annotations

import functools
import math
import time
from collections import defaultdict, deque

import numpy as np
import torch

from aero_tpu_torch.channelizer.config import ChannelizerConfig
from aero_tpu_torch.channelizer.pfb import (pfb_channelize,
                                            pfb_channelize_fused,
                                            pfb_bin_for_freq, pfb_delay,
                                            pfb_init, pfb_plan)
from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.models import msk as _msk
from aero_tpu_torch.models import oqpsk as _oq
from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
from aero_tpu_torch.models.burst_oqpsk import BurstOqpskDemodulator
from aero_tpu_torch.ops.nco import cis, fused_mul_add
from aero_tpu_torch.ops.viterbi_kernel import stream_decoder
from aero_tpu_torch.parallel.mesh import (Mesh, gather, gather_tree,
                                          replicate, shard_over_vfo)
from aero_tpu_torch.protocol.batch_c_framing import BatchCChannelFramerBank
from aero_tpu_torch.protocol.batch_framing import TracedPChannelFramer
from aero_tpu_torch.protocol.c_framing import CChannelFramer
from aero_tpu_torch.protocol.framing import PChannelFramer, apply_slip
from aero_tpu_torch.protocol.rt_framing import RTChannelFramer
from aero_tpu_torch.protocol.su_dispatch import PChannelSUDispatcher
from aero_tpu_torch.utils.graphs import GraphedStep
from aero_tpu_torch.utils.profiling import TRACER, traced
from aero_tpu_torch.utils.trees import tree_map
from aero_tpu_torch.runtime.station import (StationStats,
                                            account_framer_events,
                                            account_burst_outputs,
                                            new_burst_stats)

# 2-bit dequantization gain: levels {-3,-1,+1,+3} * INT2_GAIN * sigma
INT2_GAIN = 0.47

# burst VFO audio leaves the device as int16 at this scale (8x headroom
# over a unit signal; the JAX wire layout)
AUDIO_I16_SCALE = 4096.0

# per-VFO telemetry floats packed after the soft bits:
# signal / mse / ebno / freq / slip
TEL_SLOTS = 5

# the 4x plan's low-pass for a burst OQPSK watcher's audio
WATCHER_TAPS = 63
WATCHER_BETA = 7.5
WATCHER_CUTOFF_HZ = 15400.0


@functools.lru_cache(maxsize=None)
def _watcher_taps(out_rate: float, M: int, device) -> torch.Tensor:
    """The low-pass a burst OQPSK (T) watcher's real audio takes on the 4x
    plan before it leaves the device as int16, as conv1d weights [1, 1,
    63]: a Kaiser-windowed sinc (beta 7.5) cut at 15.4 kHz.  At 48 kS/s it
    passes 13.25 kHz (the watcher's 8 kHz carrier plus the 5.25 kHz half
    band of OQPSK 10500 at RRC alpha 1) within 1e-3 dB and stops from 17.5
    kHz by 78 dB.  Its DC gain 1/(2M) undoes the filterbank's channel gain
    2M, so the audio reads the wideband amplitude times the station's
    gain, and the int16 audio's +-8 holds a carrier at the level the int4
    ingest is scaled for.

    Why: the 4x prototype passes a neighbour 34 kHz away from 15.7 kHz
    off a bin's centre, and its near side lands in a watcher's audio from
    18.6 kHz up (a VFO 5 kHz off its bin's centre); at the channel gain a
    T burst at level 0.1 reads 64 and the noise alone 5 of the int16
    audio's 8.  The watcher beside a C channel found no burst in the
    neighbour's energy, and the hard-limited long bursts of others failed
    their CRCs.  The 2x plan's narrower prototype stops most of that
    neighbour; its watchers' audio is left as JAX makes it."""
    n = np.arange(WATCHER_TAPS) - (WATCHER_TAPS - 1) / 2.0
    fc = WATCHER_CUTOFF_HZ / out_rate
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.kaiser(WATCHER_TAPS,
                                                     WATCHER_BETA)
    h = (h / np.sum(h) / (2 * M)).astype(np.float32)
    return torch.from_numpy(h[None, None, :]).to(device)


def _traced_account(stats, data_rate, evs, dispatcher=None) -> None:
    """``account_framer_events`` as a ``framers.dispatch`` span, for a
    framer that returned events."""
    if evs:
        with TRACER.span("framers.dispatch"):
            account_framer_events(stats, data_rate, evs, dispatcher)


def _traced_c_feed(feed):
    """A C-channel framer's ``feed`` as a ``framers.c`` span (its UW
    search and frame cuts; the sequential framer's Viterbi decodes, or a
    C bank's flush on its group's last framer, whose batched decode is a
    ``framers.c.decode`` span; the voice sinks), its frames counted in
    ``c.frames``."""
    def call(soft_bytes, slip=0):
        with TRACER.span("framers.c"):
            evs = feed(soft_bytes, slip=slip)
        if evs:
            TRACER.count("c.frames", len(evs))
        return evs
    return call


class FusedStation:
    """One device step per block over a uniform sub-VFO bank."""

    def __init__(self, cfg: ChannelizerConfig, on_acars=None, on_voice=None,
                 station_id: str = "AERO-TPU", ingest_dtype: str = "int16",
                 gain: float = 10.0, pipeline: bool = True,
                 pipeline_depth: int = 2, blocks_per_step: int = 1,
                 base_block: int = 16000, hunt: bool = True,
                 hunt_max_tries: int = 6, aircraft_db=None,
                 batch_host_framing: bool = False, pfb_oversample: int = 2,
                 device="cuda"):
        assert not cfg.mains, "FusedStation serves sub-VFO banks only"
        self.device = resolve_device(device)
        self.cfg = cfg
        self.fs = cfg.sample_rate
        self.station_id = station_id
        self.on_acars = on_acars or (lambda vfo, item: None)
        self.on_voice = on_voice or (lambda vfo, data, hex_aes: None)
        self.stats = StationStats()
        self.ingest_dtype = ingest_dtype
        if isinstance(aircraft_db, str):
            from aero_tpu_torch.protocol.database import DataBaseCSVUser
            aircraft_db = DataBaseCSVUser(aircraft_db)
        self._db = aircraft_db
        self.hunt = hunt
        self.hunt_max_tries = int(hunt_max_tries)
        self._iscale = {"int2": 1.0, "int4": 7.0, "int8": 127.0,
                        "int16": 32767.0, "float32": 1.0}[ingest_dtype]

        # group sub VFOs by (out_rate, data_rate, burst); one PFB pass per
        # distinct out_rate
        groups = defaultdict(list)
        for i, s in enumerate(cfg.subs):
            burst = bool(getattr(s, "burst", False))
            if burst:
                if s.data_rate not in (600, 1200, 10500):
                    raise ValueError(
                        f"burst VFO {s.topic!r}: data_rate {s.data_rate} not "
                        "supported (R/T channels are 600/1200 MSK or 10500 "
                        "OQPSK; ref decode/aerol.h:548-850)")
            elif s.data_rate not in (600, 1200, 8400, 10500):
                raise ValueError(
                    f"VFO {s.topic!r}: unsupported data_rate {s.data_rate}")
            groups[(s.out_rate, s.data_rate, burst)].append(i)
        self.groups = dict(groups)
        self._order = sorted(self.groups)

        self.pfb_oversample = pfb_oversample
        self._M = {}
        self._K = {}
        for out_rate, _, _ in self.groups:
            self._K[out_rate], self._M[out_rate] = pfb_plan(
                self.fs, out_rate, pfb_oversample)
        self.block_len = max(base_block * M for M in self._M.values())

        self._group_cfg = {}
        self._params = {}
        self._phase0 = {}
        self._hunt_cfg = {}
        self.topics = {}
        self.framers = {}
        self.dispatchers = {}
        self.burst_demods = {}
        self.rt_framers = {}
        self.burst_stats = {}
        self._batch_banks = {}
        self._c_banks = {}
        for key, idxs in self.groups.items():
            out_rate, rate, burst = key
            K = self._K[out_rate]
            F = self.block_len // self._M[out_rate]
            bins, resid, phase0 = [], [], []
            delay = (pfb_delay(K, pfb_oversample) if pfb_oversample == 4
                     else 0)
            for i in idxs:
                delta = cfg.subs[i].freq - cfg.center_frequency
                k = pfb_bin_for_freq(delta, self.fs, K)
                kc = k if k < K // 2 else k - K
                d = delta - kc * self.fs / K      # Hz from the bin's centre
                bins.append(k)
                resid.append(-d / out_rate)
                phase0.append((d * delay / self.fs) % 1.0)
            self._phase0[key] = np.asarray(phase0, np.float32)
            self._params[key] = (
                torch.as_tensor(np.asarray(bins, np.int64),
                                device=self.device),
                torch.as_tensor(np.asarray(resid, np.float32),
                                device=self.device))
            self.topics[key] = [cfg.subs[i].topic for i in idxs]

            if burst:
                # host burst window demodulators and R/T framers; the
                # window functions, detection statistics and checkpoint
                # decodes (the Viterbi kernel) run on the station's device
                self._group_cfg[key] = (None, None)
                demod = (BurstOqpskDemodulator if rate > 1200
                         else BurstMskDemodulator)
                for t in self.topics[key]:
                    dm = self.burst_demods[t] = demod(
                        float(out_rate), float(rate), device=self.device)
                    if TRACER.on:
                        dm.process = traced(dm.process, "drain.burst")
                    self.rt_framers[t] = RTChannelFramer(
                        oqpsk=rate > 1200, on_acars=self._mk_sink(t),
                        db=self._db, decoder=stream_decoder(self.device))
                    self.burst_stats[t] = new_burst_stats()
                continue

            mod = _msk if rate in (600, 1200) else _oq
            nfft = min(8192, 1 << (F.bit_length() - 1))
            dcfg = mod.make_config(float(out_rate), float(rate),
                                   block_len=F, nfft=nfft)
            self._group_cfg[key] = (mod, dcfg)
            # hunter scan (ref decode/decode.cpp:169,198), capped below the
            # audio Nyquist minus half the symbol rate
            if rate <= 1200:
                lo, hi, bw = 0.0, 6000.0, 900.0       # L band
            else:
                lo, hi, bw = 0.0, 25000.0, 10500.0    # C band
            hi = min(hi, out_rate / 2.0 - rate / 2.0)
            self._hunt_cfg[key] = (lo, hi, bw, dcfg.freq_center)
            group_topics = self.topics[key]
            if rate == 8400:
                # C channels: voice + signalling framers.  With batched
                # framing the group's frames decode in one call per drain
                # on the station's device, which the group's last
                # framer's feed makes (a C bank, never in
                # ``_batch_banks``: those are P banks)
                sinks = {t: self._mk_voice_sink(t) for t in group_topics}
                if batch_host_framing:
                    bank = self._c_banks[key] = BatchCChannelFramerBank(
                        group_topics, on_voice=sinks, device=self.device)
                    framers = bank.framers
                else:
                    framers = {t: CChannelFramer(on_voice=sinks[t])
                               for t in group_topics}
                for t, f in framers.items():
                    self.framers[t] = f
                    if TRACER.on:
                        f.feed = _traced_c_feed(f.feed)
                continue
            if batch_host_framing:
                # one batched decode per drain for all pending frames of
                # the group, on the station's device
                from aero_tpu_torch.protocol.batch_framing import (
                    BatchPChannelFramerBank)
                bank = BatchPChannelFramerBank(rate, group_topics,
                                               device=self.device)
                self._batch_banks[key] = bank
                for t in group_topics:
                    self.framers[t] = bank.framers[t]
                    self.dispatchers[t] = PChannelSUDispatcher(
                        on_acars=self._mk_sink(t), db=self._db)
                continue
            framer = TracedPChannelFramer if TRACER.on else PChannelFramer
            for t in group_topics:
                self.framers[t] = framer(rate)
                self.dispatchers[t] = PChannelSUDispatcher(
                    on_acars=self._mk_sink(t), db=self._db)

        self._gain = gain
        # output packing: soft bits of every group, then float32 telemetry
        # viewed as bytes — the JAX station's exact layout
        self._soft_ofs = {}
        self._tel_ofs = {}
        soft_pos = tel_pos = 0
        for key in self._order:
            nb = len(self.groups[key])
            if key[2]:
                # int16 audio bytes
                per_vfo = 2 * (self.block_len // self._M[key[0]])
            else:
                _, dcfg = self._group_cfg[key]
                per_vfo = int(round(dcfg.block_len * dcfg.fb / dcfg.fs))
            self._soft_ofs[key] = (soft_pos, per_vfo)
            soft_pos += nb * per_vfo
            self._tel_ofs[key] = tel_pos
            tel_pos += TEL_SLOTS * nb
        self._soft_total = soft_pos
        self._packed_len = soft_pos + 4 * tel_pos
        self.mesh, self._axis = Mesh([self.device]), "vfo"
        self._shard_params = [self._params]
        self._steps = []
        self._state = self._init_state()
        self.pipeline_depth = pipeline_depth if pipeline else 0
        self.blocks_per_step = max(1, int(blocks_per_step))
        self._inflight = deque()
        self._pending = []
        # blocks fed, stepped and drained: the block ids of the spans
        self._fed = self._stepped = self._drained = 0
        self._account_framer_events = account_framer_events
        if TRACER.on:
            self.process, self.quantize = (self._traced_process,
                                           self._traced_quantize)
            self._run_block, self._drain = (self._traced_run_block,
                                            self._traced_drain)
            self._account_framer_events = _traced_account

    def _mk_sink(self, topic):
        def sink(item):
            self.stats.acars += 1
            self.on_acars(topic, item)
        return sink

    def _mk_voice_sink(self, topic):
        def sink(data, hex_aes):
            self.stats.voice_frames += 1
            if TRACER.on:
                TRACER.count("voice.frames")
            self.on_voice(topic, data, hex_aes)
        return sink

    # ---- device step ----

    def _init_state(self):
        """{"pfb": {out_rate: complex64 [L-M]}, "grp": {key: {"phase" [nb],
        "demod": MskState or OqpskState [nb, ...], "hunt": {"tries",
        "center"} [nb]}}}; a burst group carries only "phase", and on the
        4x plan an OQPSK one "chan" too (float32 [nb, 62], its low-pass's
        carry) (``convert`` maps it to and from the JAX station's tree).
        The residual phases start at ``_phase0``: 0 on the 2x plan, the
        filterbank's delay on the 4x plan."""
        st = {"pfb": {}, "grp": {}}
        for out_rate, K in self._K.items():
            st["pfb"][out_rate] = pfb_init(K, device=self.device,
                                           oversample=self.pfb_oversample)
        for key, idxs in self.groups.items():
            nb = len(idxs)
            g = {"phase": torch.as_tensor(self._phase0[key],
                                          device=self.device)}
            st["grp"][key] = g
            if key[2]:
                if key[1] > 1200 and self.pfb_oversample == 4:
                    # the OQPSK watcher's low-pass carry
                    g["chan"] = torch.zeros(nb, WATCHER_TAPS - 1,
                                            dtype=torch.float32,
                                            device=self.device)
                continue
            mod, dcfg = self._group_cfg[key]
            init = mod.msk_init if mod is _msk else mod.oqpsk_init
            g["demod"] = init(dcfg, nb, self.device)
            if self.hunt:
                center0 = self._hunt_cfg[key][3]
                g["hunt"] = {
                    "tries": torch.zeros(nb, dtype=torch.int32,
                                         device=self.device),
                    "center": torch.full((nb,), center0, dtype=torch.float32,
                                         device=self.device),
                }
        return st

    def _dequantize(self, iq2, scale):
        """One quantized block + its scale -> complex64 wideband [T].

        int2: [T/2] uint8, 4 codes per byte (s0.re s0.im s1.re s1.im from
        the MSB; bit1 = sign, bit0 = |x| >= sigma), the layout ``quantize``
        writes.  int4: [T] uint8, re << 4 | im as two's-complement nibbles.
        Others: planar [2, T].  Shifts and masks stay in uint8."""
        if self.ingest_dtype == "int2":
            c = torch.stack([iq2 >> 6, (iq2 >> 4) & 3,
                             (iq2 >> 2) & 3, iq2 & 3])
            v = (((c & 2).to(torch.float32) - 1.0)
                 * (1.0 + 2.0 * (c & 1).to(torch.float32)))
            v = v * (INT2_GAIN * scale)
            re = torch.stack([v[0], v[2]], dim=-1).reshape(-1)
            im = torch.stack([v[1], v[3]], dim=-1).reshape(-1)
            return torch.complex(re, im)
        if self.ingest_dtype == "int4":
            hi = (iq2 >> 4).to(torch.int32)
            lo = (iq2 & 0xF).to(torch.int32)
            re = torch.where(hi > 7, hi - 16, hi).to(torch.float32)
            im = torch.where(lo > 7, lo - 16, lo).to(torch.float32)
            return torch.complex(re / self._iscale, im / self._iscale)
        return torch.complex(iq2[0].to(torch.float32) / self._iscale,
                             iq2[1].to(torch.float32) / self._iscale)

    def _hunt_update(self, key, s2, sig, hunt):
        """Batched SignalHunter: count consecutive no-signal blocks per
        VFO; every hunt_max_tries misses step the audio centre by
        bandwidth/2 across [lo, hi] with wrap and force re-acquisition
        there (ref decode/hunter.cpp:20-40)."""
        lo, hi, bw, _ = self._hunt_cfg[key]
        tries = torch.where(sig, torch.zeros_like(hunt["tries"]),
                            hunt["tries"] + 1)
        fire = tries >= self.hunt_max_tries
        tries = torch.where(fire, torch.zeros_like(tries), tries)
        center = torch.where(fire, hunt["center"] + bw / 2.0, hunt["center"])
        center = torch.where(center > hi, torch.full_like(center,
                                                          lo + bw / 2.0),
                             center)
        _, dcfg = self._group_cfg[key]
        tune = torch.clamp(center, 100.0, dcfg.fs / 2.0 - 100.0)
        f = fire[:, None]
        s2 = s2._replace(
            freq=torch.where(fire, tune, s2.freq),
            mse=torch.where(fire, torch.full_like(s2.mse, 2.0), s2.mse),
            have_lock_refs=s2.have_lock_refs & ~fire,
            agc_ema=torch.where(fire, torch.zeros_like(s2.agc_ema),
                                s2.agc_ema),
            coarse_y=torch.where(f, torch.full_like(s2.coarse_y, 20.0),
                                 s2.coarse_y),
            # stale Doppler-slope / clock-rate carries would chirp the
            # newly hunted band and block re-acquisition there
            slope=torch.where(fire, torch.zeros_like(s2.slope), s2.slope),
            grid_rate=torch.where(fire, torch.zeros_like(s2.grid_rate),
                                  s2.grid_rate))
        return s2, {"tries": tries, "center": center}

    def _split(self, tree) -> list:
        """A whole-station state tree placed on the mesh, one tree per
        shard: the filterbank carries replicated, the per-VFO carries
        (demod, hunter, residual phase) cut by rows."""
        grp = shard_over_vfo(self.mesh, tree["grp"], self._axis)
        return [{"pfb": pfb, "grp": g} for pfb, g in
                zip(replicate(self.mesh, tree["pfb"]), grp)]

    def _join(self, shards) -> dict:
        """Inverse of ``_split``, on the station's device."""
        return {"pfb": {r: z.to(self.device)
                        for r, z in shards[0]["pfb"].items()},
                "grp": gather_tree(self.mesh, [s["grp"] for s in shards],
                                   self._axis, self.device)}

    @property
    def _state(self):
        """A copy of the device state as one tree, every row, on the
        station's device (the layout ``convert`` maps to and from JAX's);
        assigning it writes the shards' static state buffers."""
        return tree_map(torch.clone, self._join(self._shards))

    @_state.setter
    def _state(self, tree):
        self._shards = self._split(tree)

    @property
    def _shards(self) -> list:
        """Each shard's live state tree (its graphed step's static
        buffers; the next block updates them in place)."""
        return [s.state for s in self._steps]

    @_shards.setter
    def _shards(self, trees):
        if len(trees) == len(self._steps):
            for s, tree in zip(self._steps, trees):
                s.state = tree
            return
        self._steps = [GraphedStep(self._shard_fn(i), tree,
                                   f"FusedStation shard {i} of {len(trees)}")
                       for i, tree in enumerate(trees)]

    def _shard_fn(self, i: int):
        def step(state, iq2, scale):
            return self._shard_step(state, iq2, scale, self._shard_params[i])
        return step

    @property
    def captures(self) -> int:
        """CUDA graphs captured by the station's steps so far."""
        return sum(s.captures for s in self._steps)

    def _step(self, state, iq2, scale):
        """One block: (state tree, quantized block, scale) -> (new state
        tree, packed uint8 buffer), through the station's shards; eager
        and functional (the station's own state is not touched)."""
        new, packed = self._step_shards(self._split(state), iq2, scale)
        return self._join(new), packed

    def _step_shards(self, shards, iq2, scale):
        """One block over the shards, eagerly: each steps its rows on its
        device, and their packed buffers are joined (``_join_packed``).
        One thread enqueues every shard in turn, so N shards in a process
        cost about N times the host launch time of a block's demod
        steps."""
        new, parts = [], []
        for sh, dev, params in zip(shards, self.mesh.devices,
                                   self._shard_params):
            n, p = self._shard_step(sh, iq2.to(dev), scale.to(dev), params)
            new.append(n)
            parts.append(p)
        return new, self._join_packed(parts)

    def _run_block(self, iq2, scale, out):
        """One block through the station's graphed steps into ``out``
        (the packed row of its dispatch), advancing the station's state:
        one replay per shard, then the joins."""
        if len(self._steps) == 1 and not self.mesh.spans_processes(
                self._axis):
            self._steps[0](iq2, scale, out=out)
            return
        out.copy_(self._join_packed(
            [s(iq2, scale) for s in self._steps]))

    def _join_packed(self, parts):
        """The shards' packed buffers, each its rows in the station's
        layout, joined into the station's (JAX's): per group the soft
        rows in row order, then per group the telemetry slots, each
        slot's rows in row order."""
        if len(parts) == 1 and not self.mesh.spans_processes(self._axis):
            return parts[0].to(self.device)
        size = self.mesh.shape[self._axis]
        rows = {key: len(self.groups[key]) // size for key in self._order}
        pos = 0
        tpos = sum(r * self._soft_ofs[key][1] for key, r in rows.items())
        soft, tel = [], []
        for key in self._order:
            r, per = rows[key], self._soft_ofs[key][1]
            soft.append(gather(self.mesh, [p[pos:pos + r * per].view(r, per)
                                           for p in parts], 0, self._axis,
                               self.device).reshape(-1))
            n = TEL_SLOTS * 4 * r
            tel.append(gather(self.mesh,
                              [p[tpos:tpos + n].view(TEL_SLOTS, 4 * r)
                               for p in parts], 1, self._axis,
                              self.device).reshape(-1))
            pos += r * per
            tpos += n
        return torch.cat(soft + tel)

    def _shard_step(self, state, iq2, scale, params):
        """One shard's block on its device: (its state, quantized block,
        scale, its rows' bins and residuals) -> (new state, packed uint8
        buffer of its rows in the station's layout: per group the soft
        bits or burst audio bytes [rows, n], then per group the float32
        telemetry [TEL_SLOTS, rows] as bytes)."""
        x = self._dequantize(iq2, scale)
        dev = x.device
        new = {"pfb": {}, "grp": {}}
        z_by_rate = {}
        o = self.pfb_oversample
        for out_rate, K in self._K.items():
            chan = (pfb_channelize_fused
                    if (x.shape[-1] // self._M[out_rate]) % o == 0
                    else pfb_channelize)
            new["pfb"][out_rate], z_by_rate[out_rate] = chan(
                state["pfb"][out_rate], x, K, oversample=o)
        parts = {}
        for key in self._order:
            out_rate = key[0]
            mod, dcfg = self._group_cfg[key]
            bins, resid = params[key]
            gst = state["grp"][key]
            zb = z_by_rate[out_rate][bins]
            F = zb.shape[1]
            # residual mix: floor-mod of a float32 ramp (F = 16000 per
            # block) rounded once, as JAX computes it on the CPU;
            # torch.remainder, never fmod — the residuals are negative for
            # VFOs above their bin centre
            n = torch.arange(F, dtype=torch.float32, device=dev)
            ramp = fused_mul_add(resid[:, None], n, gst["phase"][:, None])
            osc = cis((2.0 * math.pi) * torch.remainder(ramp, 1.0))
            audio = (zb * osc).real * self._gain
            ng = {"phase": torch.remainder(
                fused_mul_add(resid, F, gst["phase"]), 1.0)}
            new["grp"][key] = ng
            if key[2]:
                # burst VFOs: int16 audio for the host window demodulators,
                # its RMS and peak in the first two telemetry slots; on
                # the 4x plan an OQPSK watcher's audio is its band only
                if "chan" in gst:
                    hist = torch.cat([gst["chan"], audio], dim=1)
                    ng["chan"] = hist[:, F:]
                    audio = torch.nn.functional.conv1d(
                        hist[:, None, :], _watcher_taps(
                            out_rate, self._M[out_rate], dev))[:, 0]
                a16 = torch.clamp(torch.round(audio * AUDIO_I16_SCALE),
                                  -32767, 32767).to(torch.int16)
                rms = torch.sqrt(torch.mean(audio * audio, dim=1))
                peak = torch.amax(torch.abs(audio), dim=1)
                zero = torch.zeros_like(rms)
                parts[key] = (a16.contiguous().view(torch.uint8),
                              torch.stack([rms, peak, zero, zero, zero]))
                continue

            step = mod.msk_step if mod is _msk else mod.oqpsk_step
            s2, out = step(gst["demod"], audio, dcfg)
            if "hunt" in gst:
                s2, ng["hunt"] = self._hunt_update(key, s2, out["signal"],
                                                   gst["hunt"])
            ng["demod"] = s2
            parts[key] = (out["soft_bits"], torch.stack(
                [out["signal"].to(torch.float32), out["mse"], out["ebno"],
                 s2.freq, out["slip"].to(torch.float32)]))
        soft = [parts[key][0].reshape(-1) for key in self._order]
        tel = torch.cat([parts[key][1].reshape(-1) for key in self._order])
        # ONE flat uint8 buffer: soft bits, then the float32 telemetry's
        # bytes (little-endian on both x86 hosts and the card)
        return new, torch.cat(soft + [tel.view(torch.uint8)])

    # ---- host driver ----

    def quantize(self, iq: np.ndarray):
        """complex64 [T] -> ingest array of the configured dtype:
        [2, T] for int8/int16/float32, packed [T] uint8 for int4,
        (packed [T/2] uint8, sigma) for int2."""
        if self.ingest_dtype != "float32":
            from aero_tpu_torch import native
            if native.have_native_ingest():
                return native.quantize_native(
                    np.ascontiguousarray(iq, np.complex64),
                    self.ingest_dtype)
        lim = self._iscale
        if self.ingest_dtype == "int2":
            arms = np.stack([iq.real, iq.imag], axis=-1).astype(np.float32)
            sigma = float(np.sqrt(np.mean(arms * arms))) or 1.0
            code = (((arms >= 0).astype(np.uint8) << 1)
                    | (np.abs(arms) >= sigma).astype(np.uint8))
            q = code.reshape(-1, 4)
            packed = ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2)
                      | q[:, 3]).astype(np.uint8)
            return packed, np.float32(sigma)
        if self.ingest_dtype == "int4":
            re = np.clip(np.round(iq.real * lim), -8, 7).astype(np.int64)
            im = np.clip(np.round(iq.imag * lim), -8, 7).astype(np.int64)
            return (((re & 0xF) << 4) | (im & 0xF)).astype(np.uint8)
        pair = np.stack([iq.real, iq.imag])
        if self.ingest_dtype == "float32":
            return pair.astype(np.float32)
        return np.clip(pair * lim, -lim, lim).astype(self.ingest_dtype)

    def _want_shape(self):
        if self.ingest_dtype == "int2":
            return (self.block_len // 2,)
        if self.ingest_dtype == "int4":
            return (self.block_len,)
        return (2, self.block_len)

    def process(self, iq_or_quantized):
        """Feed one wideband block (block_len samples): complex64 [T],
        a pre-quantized array, or a ``quantize()`` result."""
        t0 = time.perf_counter()
        scale = np.float32(1.0)
        arr = iq_or_quantized
        had_scale = isinstance(arr, tuple)
        if had_scale:
            arr, scale = arr
        arr = np.asarray(arr)
        if np.iscomplexobj(arr):
            q = self.quantize(arr.astype(np.complex64))
            arr, scale = q if isinstance(q, tuple) else (q, scale)
        elif self.ingest_dtype == "int2" and not had_scale:
            raise ValueError("int2 ingest requires (packed, sigma) as "
                             "returned by quantize(); got a bare array")
        if arr.shape != self._want_shape():
            raise ValueError(f"block shape {arr.shape}, expected "
                             f"{self._want_shape()}")
        self._pending.append((arr, scale))
        if len(self._pending) >= self.blocks_per_step:
            self._dispatch()
        while len(self._inflight) > self.pipeline_depth:
            self._drain(self._inflight.popleft())
        self.stats.wideband_samples += self.block_len
        self.stats.wall_seconds += time.perf_counter() - t0

    def _dispatch(self):
        """Upload the pending blocks in one copy, run one device step per
        block (a graph replay per shard on a card), and queue the packed
        buffers [m, n], a fresh tensor that no later step writes."""
        if TRACER.on:
            TRACER.open("station.upload", self._stepped)
        iqs = torch.from_numpy(np.stack([a for a, _ in self._pending])).to(
            self.device)
        scales = torch.from_numpy(np.asarray(
            [s for _, s in self._pending], np.float32)).to(self.device)
        self._pending = []
        packed = torch.empty((iqs.shape[0], self._packed_len),
                             dtype=torch.uint8, device=self.device)
        if TRACER.on:
            TRACER.close()
        for i in range(iqs.shape[0]):
            self._run_block(iqs[i], scales[i], packed[i])
        self._inflight.append(packed)

    def shard(self, mesh, axis_name: str = "vfo"):
        """Cut the per-VFO banks over one mesh axis (``parallel/mesh.py``;
        JAX's ``FusedStation.shard``).  Per-VFO carries (demod, hunter
        scan state, residual phases, burst groups' phases) and each
        group's bins and residuals are cut by rows; the wideband
        filterbank carries are replicated, so every shard runs the
        filterbank on the whole block, as XLA partitions the JAX step.
        Every group's VFO count must divide the axis (ValueError).  The
        batched P framers (and with them the Viterbi kernel), the burst
        watchers and the packed buffer stay on the station's device.
        Call after construction or after ``load_checkpoint``; returns
        self."""
        n_axis = mesh.shape[axis_name]
        for key, idxs in self.groups.items():
            if len(idxs) % n_axis:
                raise ValueError(
                    f"group {key}: {len(idxs)} VFOs not divisible by "
                    f"mesh axis {axis_name!r} of size {n_axis}")
        state = self._state
        self.mesh, self._axis = mesh, axis_name
        self._shard_params = shard_over_vfo(mesh, self._params, axis_name)
        self._steps = []        # new devices: new static buffers, graphs
        self._state = state
        return self

    def _shard_row(self, key, row: int):
        """(shard index, row in that shard) of a group's row."""
        for i, (lo, hi) in enumerate(self.mesh.rows(len(self.groups[key]),
                                                    self._axis)):
            if lo <= row < hi:
                return i, row - lo
        raise LookupError(f"row {row} of group {key} is held by another "
                          "process")

    def flush(self):
        """Drain pending and in-flight blocks (call at end of stream)."""
        t0 = time.perf_counter()
        if self._pending:
            self._dispatch()
        while self._inflight:
            self._drain(self._inflight.popleft())
        self.stats.wall_seconds += time.perf_counter() - t0

    def _drain(self, packed):
        rows = packed.cpu().numpy()
        for row in rows:
            soft = row[: self._soft_total]
            self.telemetry = row[self._soft_total:].view(np.float32)
            for key in self._order:
                out_rate, rate, burst = key
                pos, per_vfo = self._soft_ofs[key]
                nb = len(self.groups[key])
                sb = soft[pos: pos + nb * per_vfo].reshape(nb, per_vfo)
                if burst:
                    for r, topic in enumerate(self.topics[key]):
                        audio = (sb[r].view(np.int16).astype(np.float32)
                                 / AUDIO_I16_SCALE)
                        account_burst_outputs(
                            self.stats, self.burst_stats[topic],
                            self.burst_demods[topic].process(audio),
                            self.rt_framers[topic])
                    continue
                # timing-grid slips (5th telemetry slot) realign the soft
                # stream before any deframer sees it — a clock-offset
                # renormalization then costs two soft-bit erasures, not
                # a frame (tests/test_impairments.py)
                t0 = self._tel_ofs[key]
                slips = self.telemetry[t0 + 4 * nb: t0 + 5 * nb]
                if key in self._batch_banks:
                    # one batched device decode for the whole group's
                    # pending frames (the bank API takes plain arrays, so
                    # slips are realigned here rather than in feed())
                    evs_by_topic = self._batch_banks[key].feed(
                        {topic: apply_slip(sb[r], int(slips[r]))
                         for r, topic in enumerate(self.topics[key])})
                    for topic, evs in evs_by_topic.items():
                        self._account_framer_events(
                            self.stats, rate, evs,
                            self.dispatchers.get(topic))
                    continue
                for r, topic in enumerate(self.topics[key]):
                    self._account_framer_events(
                        self.stats, rate,
                        self.framers[topic].feed(sb[r].astype(np.float32),
                                                 slip=int(slips[r])),
                        self.dispatchers.get(topic))

    # ---- spans, for a station built while the tracer is on
    # (utils/profiling.py): the block fed or drained, and the calls ----

    def _traced_process(self, iq_or_quantized):
        with TRACER.span("station.process", self._fed):
            FusedStation.process(self, iq_or_quantized)
        self._fed += 1
        TRACER.count("blocks.in")

    def _traced_quantize(self, iq):
        with TRACER.span("station.quantize", self._fed):
            return FusedStation.quantize(self, iq)

    def _traced_run_block(self, iq2, scale, out):
        with TRACER.span("station.step", self._stepped):
            FusedStation._run_block(self, iq2, scale, out)
        self._stepped += 1

    def _traced_drain(self, packed):
        """The drain of the packed rows [m, n] of blocks ``_drained`` on,
        its D2H a span of its own."""
        with TRACER.span("station.drain", self._drained):
            with TRACER.span("drain.d2h"):
                host = packed.cpu()
            FusedStation._drain(self, host)
        self._drained += len(packed)
        TRACER.count("blocks.drained", len(packed))

    # ---- checkpoint/resume (runtime/checkpoint.py) ----

    def save_checkpoint(self, path: str, residual=None):
        """Write the full station state (device state, deframer locks and
        trellis history, reassembly buffers, stats) to one .npz in the JAX
        station's format; drains pending/in-flight blocks first.
        ``residual`` stores caller-held wideband IQ (a partial block) so
        resume is sample-contiguous."""
        from aero_tpu_torch.runtime.checkpoint import save_station_checkpoint
        save_station_checkpoint(self, path, residual=residual)

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint written by this station or the JAX
        one; the station must have the same VFO configuration (checked)."""
        from aero_tpu_torch.runtime.checkpoint import load_station_checkpoint
        load_station_checkpoint(self, path)

    def vfo_spectrum(self, topic: str, nbins: int = 256):
        """(freqs_hz, dB) fold-spectrum snapshot for one continuous VFO,
        fetched on demand from the device-resident demod state (the
        Plottables analogue at station scale; burst VFOs have no
        coarse-spectrum carry — returns None for them)."""
        from aero_tpu_torch.models.coarse_freq import spectrum_display
        for key in self._order:
            if key[2] or topic not in self.topics[key]:
                continue
            row = self.topics[key].index(topic)
            shard, row = self._shard_row(key, row)
            st = self._shards[shard]["grp"][key]["demod"]
            _, dcfg = self._group_cfg[key]
            coarse = st.coarse_y[row].cpu().numpy()
            return spectrum_display(coarse, dcfg.fs, nbins)
        return None

    def vfo_telemetry(self):
        """Last drained block's per-VFO state by topic.

        Continuous VFOs: (signal, mse, ebno, freq) from the device step.
        Burst VFOs: device-side audio level/peak plus the host burst
        counters (windows demodulated, R/T packets framed, last
        tone_quality and carrier freq) — a dead burst watcher is now
        distinguishable from a quiet channel (VERDICT r3 weak #3; the
        reference's per-demod SignalStatus signals)."""
        tel = getattr(self, "telemetry", None)
        if tel is None:
            return {}
        out = {}
        for key in self._order:
            nb = len(self.groups[key])
            t = tel[self._tel_ofs[key]:
                    self._tel_ofs[key] + TEL_SLOTS * nb].reshape(TEL_SLOTS,
                                                                 nb)
            for row, topic in enumerate(self.topics[key]):
                if key[2]:
                    bs = self.burst_stats[topic]
                    out[topic] = {"signal": bs["windows"] > 0,
                                  "level": float(t[0, row]),
                                  "peak": float(t[1, row]),
                                  "windows": bs["windows"],
                                  "packets": bs["packets"],
                                  "tone_quality": bs["last_tone_quality"],
                                  "freq": bs["last_freq"],
                                  "burst": True}
                else:
                    out[topic] = {"signal": bool(t[0, row] > 0.5),
                                  "mse": float(t[1, row]),
                                  "ebno": float(t[2, row]),
                                  "freq": float(t[3, row]),
                                  "burst": False}
        return out
