"""Batched block channelizer: wideband IQ -> per-topic payloads (torch).

Counterpart of ``aero_tpu/channelizer/channelizer.py`` (read its docstring
for the reference semantics).  All main VFOs of one decimation process the
same wideband block as one batch over their mix frequencies; each group of
like-shaped sub VFOs is one batch over its members: every state tensor
carries a leading [n] member axis where JAX vmaps.  Every filter carries
overlap state, so output streams are continuous across blocks.

Per-VFO chains:
  main: NCO mix (center - rf) -> halfband^k
        publish as 4-bit-packed IQ nibbles (cstyle 1)
  sub:  NCO mix (main_rf - rf) -> halfband^k
        [-> lowpass decimate x5/x6]
        -> USB demod: delay(Re) - hilbert(Im)
        [-> audio lowpass filter_bw]
        -> gain * 32768 -> int16 audio

The chain states are dicts of the JAX ``_chain_init`` keys (``nco``,
``hb``, ``late``, ``hilb``, ``dly``, ``post``) with JAX's shapes and
dtypes, complex carries as complex64 tensors (``convert`` maps them to and
from the JAX checkpoint layout).  JAX packs complex values as float pairs
at its jit boundaries (``aero_tpu/ops/compat.py``); torch has complex
tensors at every boundary, so the port has no such packing.

Where JAX jits one step per decimation and one per sub group
(``_jit_main``, ``_jit_sub``), each runs on a card as one CUDA-graph
replay (``utils/graphs.py``), its chain state in static buffers.  The
copies back of each group's output, the int16 and nibble packing on the
host, and the DC correction stay as they are.
"""

from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np
import torch

from aero_tpu_torch import native
from aero_tpu_torch.channelizer.config import ChannelizerConfig
from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.ops.design import (HALFBAND_TAPS, hilbert_design,
                                       low_pass_design)
from aero_tpu_torch.ops.fir import (delay_apply, delay_init, fir_apply,
                                    fir_decimate_apply, fir_decimate_init,
                                    fir_init, halfband_cascade_apply,
                                    halfband_cascade_init)
from aero_tpu_torch.ops.nco import nco_init, nco_mix
from aero_tpu_torch.utils.graphs import GraphedStep

_HB = HALFBAND_TAPS[11].astype(np.float32)   # vfo.init uses 11 taps (vfo.cpp:106-108)
_HILBERT_NTAPS = 125                          # vfo.cpp:112


def dc_correct_python(iq: np.ndarray, alpha: float,
                      state: np.ndarray) -> np.ndarray:
    """Exact one-pole DC tracker, vectorized (scipy lfilter).

    Same recurrence as ``native.dc_correct_native`` / the reference
    (publisher.cpp:292-296): ``dc += alpha*(x-dc); y = x-dc``, i.e.
    ``dc[n] = alpha*x[n] + (1-alpha)*dc[n-1]`` with lfilter initial state
    ``zi = (1-alpha)*dc_prev``.  ``state`` is the float32 [2] {re, im}
    carry shared with the native path, updated in place.  Returns a new
    complex64 array.
    """
    from scipy.signal import lfilter
    d0 = complex(state[0], state[1])
    dc, _ = lfilter(np.asarray([alpha], np.float32),
                    np.asarray([1.0, -(1.0 - alpha)], np.float32),
                    iq, zi=np.asarray([(1.0 - alpha) * d0], np.complex64))
    out = (iq - dc).astype(np.complex64)
    last = dc[-1] if len(dc) else d0
    state[0] = np.float32(last.real)
    state[1] = np.float32(last.imag)
    return out


def _chain_init(decim_count: int, usb: bool, late: int, ntaps_late: int,
                ntaps_post: int, n: int, device):
    """The carries of n like-shaped chains, each with a leading [n]."""
    b = (n,)
    st = {
        "nco": nco_init(0.0, device, b),
        "hb": halfband_cascade_init(decim_count, len(_HB), b,
                                    torch.complex64, device),
    }
    if late:
        st["late"] = fir_decimate_init(ntaps_late, b, torch.complex64, device)
    if usb:
        st["hilb"] = fir_init(_HILBERT_NTAPS, b, device=device)
        st["dly"] = delay_init((_HILBERT_NTAPS - 1) // 2, b, device=device)
        if ntaps_post:
            st["post"] = fir_init(ntaps_post, b, device=device)
    return st


def _mix_and_halfband(st, x, freqs, hb):
    """NCO mix of the shared block x [T] by each member's frequency, then
    the halfband cascade: returns (new chain dict, z [n, T / 2**k])."""
    new = dict(st)
    new["nco"], z = nco_mix(st["nco"], x, freqs)
    new["hb"], z = halfband_cascade_apply(st["hb"], z, hb)
    return new, z


def _sub_chain(st, x, *, freqs, gains, hb, hilb, late, late_taps,
               post_taps):
    """A sub group's chain on its source block x [T]: (new chain dict,
    int16 pcm [n, T_out])."""
    new, z = _mix_and_halfband(st, x, freqs, hb)
    if late:
        new["late"], z = fir_decimate_apply(st["late"], z, late_taps, late)
    new["hilb"], h = fir_apply(st["hilb"], z.imag, hilb)
    new["dly"], d = delay_apply(st["dly"], z.real)
    audio = d - h
    if post_taps is not None:
        new["post"], audio = fir_apply(st["post"], audio, post_taps)
    pcm = torch.clamp(audio * gains[:, None] * 32768.0, -32767.0,
                      32767.0).to(torch.int16)
    return new, pcm


class Channelizer:
    """Host driver around the batched per-group VFO chains, on ``device``."""

    def __init__(self, cfg: ChannelizerConfig, device="cuda"):
        self.cfg = cfg
        self.fs = cfg.sample_rate
        self.device = resolve_device(device)
        dev = self.device
        self._dc_state = np.zeros(2, np.float32)   # per-sample DC carry
        self._hb = torch.from_numpy(_HB).to(dev)
        self._hilb = torch.from_numpy(
            hilbert_design(_HILBERT_NTAPS).astype(np.float32)).to(dev)

        # ---- main VFO groups by decim_count ----
        self.main_groups = defaultdict(list)     # decim -> [main indices]
        for i, m in enumerate(cfg.mains):
            self.main_groups[m.decim_count].append(i)
        self._main_steps = {}
        for decim, idxs in self.main_groups.items():
            freqs = np.array([(cfg.center_frequency - cfg.mains[i].freq)
                              / self.fs for i in idxs], np.float32)
            self._main_steps[decim] = GraphedStep(
                functools.partial(_mix_and_halfband,
                                  freqs=torch.from_numpy(freqs).to(dev),
                                  hb=self._hb),
                _chain_init(decim, False, 0, 0, 0, len(idxs), dev),
                f"Channelizer main decim {decim}")

        # ---- sub VFO groups ----
        # group key: (main_idx, decim, late, filter_bw, out_rate)
        self.sub_groups = defaultdict(list)
        for i, s in enumerate(cfg.subs):
            key = (s.main_idx, s.decim_count, s.late_decimate, s.filter_bw,
                   s.out_rate)
            self.sub_groups[key].append(i)
        self._sub_steps = {}
        for key, idxs in self.sub_groups.items():
            main_idx, decim, late, filter_bw, out_rate = key
            main_rf = (cfg.mains[main_idx].freq if main_idx >= 0
                       else cfg.center_frequency)
            in_rate = (cfg.mains[main_idx].out_rate if main_idx >= 0
                       else self.fs)
            freqs = np.array([(main_rf - cfg.subs[i].freq) / in_rate
                              for i in idxs], np.float32)
            gains = np.asarray([cfg.subs[i].gain for i in idxs], np.float32)
            late_taps = post_taps = None
            if late:
                target = out_rate
                late_taps = low_pass_design(
                    2.0, target * late, target / 2,
                    target / (late - 1)).astype(np.float32)
            if filter_bw > 0:
                post_taps = low_pass_design(2.0, out_rate, filter_bw,
                                            filter_bw / 4).astype(np.float32)
            state = _chain_init(
                decim, True, late, 0 if late_taps is None else len(late_taps),
                0 if post_taps is None else len(post_taps), len(idxs), dev)

            def put(a):
                return None if a is None else torch.from_numpy(a).to(dev)
            self._sub_steps[key] = GraphedStep(
                functools.partial(_sub_chain, freqs=put(freqs),
                                  gains=put(gains), hb=self._hb,
                                  hilb=self._hilb, late=late,
                                  late_taps=put(late_taps),
                                  post_taps=put(post_taps)),
                state, f"Channelizer sub group {key}")

    # ---- chain states (checkpoints, convert) ----

    @property
    def _main_state(self) -> dict:
        """A copy of each main group's chain state, by decimation."""
        return {k: s.snapshot() for k, s in self._main_steps.items()}

    @_main_state.setter
    def _main_state(self, tree):
        for k, s in self._main_steps.items():
            s.state = tree[k]

    @property
    def _sub_state(self) -> dict:
        """A copy of each sub group's chain state, by group key."""
        return {k: s.snapshot() for k, s in self._sub_steps.items()}

    @_sub_state.setter
    def _sub_state(self, tree):
        for k, s in self._sub_steps.items():
            s.state = tree[k]

    @property
    def captures(self) -> int:
        """CUDA graphs captured by the group steps so far."""
        return sum(s.captures for s in (*self._main_steps.values(),
                                        *self._sub_steps.values()))

    # ---- host driver ----

    def process(self, iq: np.ndarray) -> list:
        """iq: complex64 [T] wideband block (T divisible by every VFO's total
        decimation).  Returns [(topic, out_rate, payload_bytes), ...].
        """
        iq = np.asarray(iq, np.complex64)
        if self.cfg.correct_dc_bias:
            # one-pole DC tracker, alpha = 1e-6 (ref: publisher.cpp:292-296)
            alpha = 1e-6
            if native.have_native_ingest():
                # exact per-sample form (native/ingest.cc aero_dc_correct);
                # copy first: the C routine corrects in place
                iq = iq.copy()
                native.dc_correct_native(iq, alpha, self._dc_state)
            else:
                # the same recurrence, vectorized by scipy: both paths give
                # the same stream up to float32 rounding
                iq = dc_correct_python(iq, alpha, self._dc_state)

        x = torch.from_numpy(np.ascontiguousarray(iq)).to(self.device)
        outputs = []

        main_out = {}          # main idx -> complex [T'] tensor
        for decim, idxs in self.main_groups.items():
            z = self._main_steps[decim](x)
            zh = None
            for row, i in enumerate(idxs):
                main_out[i] = z[row]
                m = self.cfg.mains[i]
                if m.topic:
                    if zh is None:
                        zh = z.cpu().numpy()
                    payload = self._compress_nibbles(zh[row],
                                                     m.compress_scale)
                    outputs.append((m.topic, m.out_rate, payload))

        for key, idxs in self.sub_groups.items():
            main_idx = key[0]
            src = x if main_idx < 0 else main_out[main_idx]
            pcm = self._sub_steps[key](src)
            pcm = pcm.cpu().numpy()
            for row, i in enumerate(idxs):
                s = self.cfg.subs[i]
                outputs.append((s.topic, s.out_rate,
                                pcm[row].astype("<i2").tobytes()))
        return outputs

    @staticmethod
    def _compress_nibbles(z: np.ndarray, scale: int) -> bytes:
        """cstyle 1: keep the top nibble of each scaled arm
        (ref: vfo.cpp:262-275)."""
        re = np.clip((z.real / scale) * 128.0, -128, 127).astype(np.int8)
        im = np.clip((z.imag / scale) * 128.0, -128, 127).astype(np.int8)
        packed = (re.astype(np.uint8) & 0xF0) | ((im.astype(np.uint8) & 0xF0) >> 4)
        return packed.astype(np.uint8).tobytes()
