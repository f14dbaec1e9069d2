"""The benchmark's one traffic generator: a configuration and a mix in,
one pass of wideband IQ and the list of what it carries out.

The configuration (``configs/<name>.json``) fixes the bank: its VFOs, their
kinds and rates.  The mix (``traffic/<name>.json``) fixes what is on the
air: which VFOs carry a carrier, how many ACARS messages of which lengths,
voice, bursts, the level and the noise.  The seed draws the texts, the
registrations, the voice and burst bytes and the order of the message
lengths; the set of lengths and every arrival time are the same for every
seed, so two seeds make the same amount of work.

Every continuous stream (P and C channels) fills the pass with whole
frames and is encoded tail-biting, and the capture is synthesized
periodic (``synth.py``), so a replay in a loop is one endless signal: the
framers stay locked across the seam, and every message of every pass is
due to come out.  Each continuous stream starts at its own point of the
pass, fixed by the VFO's index, as independent transmitters do.  The capture lives in host memory, as an SDR's samples
would.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from aerobench import synth, tx

TEXT_ALPHABET = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ./-"))
REG_ALPHABET = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"))
R_TYPES = (0x20, 0x22, 0x23, 0x61, 0x62, 0x12, 0x30, 0x15, 0x17, 0x60)
GESID = 0x41


def out_rate(data_rate: int) -> int:
    """A sub VFO's channel rate, as the SDRReceiver INI schema derives
    it from the data rate."""
    return {600: 12000, 1200: 24000}.get(data_rate, 48000)


@dataclass(frozen=True)
class Vfo:
    topic: str
    kind: str            # P, C, R or T
    data_rate: int
    offset_hz: int       # from the centre frequency
    burst: bool


def bank(cfg: dict) -> list:
    """The configuration's VFOs in INI order."""
    first, step = cfg["raster"]["first_hz"], cfg["raster"]["spacing_hz"]
    out = []
    for grp in cfg["vfos"]:
        for slot in range(*grp["slots"], grp.get("step", 1)):
            out.append(Vfo(grp["topic"].format(slot=slot), grp["kind"],
                           grp["data_rate"],
                           first + slot * step - cfg["center_frequency"],
                           grp["kind"] in ("R", "T")))
    return out


def ini_text(cfg: dict) -> str:
    """The bank as SDRReceiver INI text (``station_main -c``)."""
    lines = ["[General]", f"sample_rate={cfg['sample_rate']}",
             f"center_frequency={cfg['center_frequency']}", "[vfos]"]
    vfos = bank(cfg)
    lines.append(f"size={len(vfos)}")
    gains = {g["topic"].format(slot=s): g.get("gain")
             for g in cfg["vfos"] for s in range(*g["slots"], g.get("step", 1))}
    for i, v in enumerate(vfos, 1):
        lines += [f"{i}\\frequency={cfg['center_frequency'] + v.offset_hz}",
                  f"{i}\\data_rate={v.data_rate}", f"{i}\\topic={v.topic}"]
        if gains[v.topic] is not None:
            lines.append(f"{i}\\gain={gains[v.topic]}")
        if v.burst:
            lines.append(f"{i}\\burst=1")
    return "\n".join(lines) + "\n"


def block_len(cfg: dict) -> int:
    """Samples per station block: 16000 channel samples at the lowest
    channel rate of the bank."""
    return 16000 * max(cfg["sample_rate"] // out_rate(v.data_rate)
                       for v in bank(cfg))


@dataclass
class Expected:
    """One thing the capture carries that must come out: an ACARS
    message (key (reg, text)), a voice frame (its 300 bytes), an R packet
    (its 17 bytes) or a T packet (its 4 header bytes), due once the
    sample ``due`` of the pass has been received."""
    kind: str
    topic: str
    key: object
    due: int


@dataclass
class Traffic:
    iq: np.ndarray                  # complex64, one pass
    expected: list = field(default_factory=list)
    block_len: int = 0
    blocks: int = 0
    seconds: int = 0


def _text(rng, n: int, taken: set) -> str:
    while True:
        s = "".join(rng.choice(TEXT_ALPHABET, n))
        if s[0] != " " and s[-1] != " " and s not in taken:
            taken.add(s)
            return s


def _reg(rng) -> str:
    return "N" + "".join(rng.choice(REG_ALPHABET, 5))


def _lengths(lo: int, hi: int, v: int, n: int) -> list:
    """A fixed ladder of text lengths for VFO ``v``: the same for every
    seed."""
    span = hi - lo + 1
    return [lo + (j * 7 + v * 3) % span for j in range(n)]


def _p_frames(rng, rate: int, n_frames: int, spec: dict, v: int,
              aesid: int, reg: str, taken: set):
    """One pass of infofields for a P VFO, and its messages as
    (reg, text, frame holding the last SU)."""
    S = tx.p_sus_per_frame(rate)
    share = float(spec.get("acars_frame_share", 0.0))
    per = int(spec.get("messages_per_frame", 1))
    lo, hi = spec.get("text_len", (8, 40))
    frames = [[] for _ in range(n_frames)]
    msgs = []
    if share > 0:
        # how many chunks of ``per`` messages fit, from the fixed ladder
        ladder = _lengths(lo, hi, v, 4 * n_frames * per)
        chunks, used, j = [], 0, 0
        while True:
            lens = ladder[j:j + per]
            need = -(-sum(tx.n_acars_sus(n) for n in lens) // S)
            gap = int(round(need * (1.0 - share) / share))
            if used + need + gap > n_frames:
                break
            chunks.append(need)
            used += need + gap
            j += per
        lens = [ladder[k] for k in rng.permutation(j)]
        pos = 0
        for c in range(len(chunks)):
            sus = []
            for n in lens[c * per:(c + 1) * per]:
                text = _text(rng, n, taken)
                sus += tx.acars_sus(aesid, GESID, reg, text)
                msgs.append((reg, text, pos + (len(sus) - 1) // S))
            need = -(-len(sus) // S)
            for f in range(need):
                frames[pos + f] = sus[f * S:(f + 1) * S]
            pos += need + int(round(need * (1.0 - share) / share))
    fields = [b"".join(f + [tx.FILL_SU] * (S - len(f))) for f in frames]
    return fields, msgs


def make(cfg: dict, mix: dict, seed: int, device) -> Traffic:
    """The capture of one pass and what it carries, from ``seed``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    fs = cfg["sample_rate"]
    L = block_len(cfg)
    n_blocks = int(mix["capture_blocks"])
    n = L * n_blocks
    assert n % fs == 0, "a pass lasts a whole number of seconds"
    T = n // fs
    cap = synth.Capture(fs, T, device)
    level = float(mix["level"])
    vfos = bank(cfg)
    cont = [v for v in vfos if v.kind in ("P", "C")]
    n_on = int(round(float(mix.get("carrier_share", 1.0)) * len(cont)))
    on = {cont[k].topic for k in sorted(rng.permutation(len(cont))[:n_on])}
    out = Traffic(iq=None, block_len=L, blocks=n_blocks, seconds=T)
    taken: set = set()

    def due(t_s: float) -> int:
        return (int(math.ceil(t_s * fs)) - 1) % n

    def lag(v_idx: int, grid: int) -> int:
        """Where a continuous VFO's stream starts, in samples of a grid
        of ``grid`` per second: fixed by the VFO's index (the same for
        every seed), so that no two carriers send the same bits at once.
        Frames aligned and alike (fill) on every VFO would add up in phase
        every 1/spacing seconds and clip the ingest."""
        return int(((v_idx * 0.6180339887498949) % 1.0) * T * grid)

    for v_idx, v in enumerate(vfos):
        aesid = 0x400000 + 0x100 * v_idx + 1
        if v.kind == "P" and v.topic in on:
            FB = tx.p_frame_bits(v.data_rate)
            n_frames = T * v.data_rate // FB
            assert n_frames * FB == T * v.data_rate and n_frames % 16 == 0
            reg = _reg(rng)
            fields, msgs = _p_frames(rng, v.data_rate, n_frames,
                                     mix.get("p", {}), v_idx, aesid, reg,
                                     taken)
            bits = tx.p_stream(fields, v.data_rate)
            if v.data_rate <= 1200:
                fa = out_rate(v.data_rate)
                shift = lag(v_idx, fa)
                start = shift / fa
                cap.add_real_audio(torch.roll(synth.msk_audio(
                    bits, fa * T, fa, v.data_rate, 1000.0, level,
                    periodic=True, device=device), shift), fa, v.offset_hz)
            else:
                shift = lag(v_idx, 16 * v.data_rate)
                # the OQPSK train starts two symbols (4 bits) in
                start = (shift + 64) / (16 * v.data_rate)
                _add_oqpsk(cap, bits, v, level, shift, T, device)
            for reg_, text, j in msgs:
                out.expected.append(Expected(
                    "acars", v.topic, (reg_, text),
                    due(start + (j + 1) * FB / v.data_rate)))
        elif v.kind == "C" and v.topic in on:
            FB = tx.c_frame_bits()
            n_frames = T * v.data_rate // FB
            assert n_frames * FB == T * v.data_rate and n_frames % 2 == 0
            shift = lag(v_idx, 16 * v.data_rate)
            start = (shift + 64) / (16 * v.data_rate)
            frames = []
            for j in range(n_frames):
                sig = [tx.with_crc(bytes([0x30]) + rng.bytes(9))
                       for _ in range(3)]
                voice = rng.bytes(300)
                frames.append((sig, voice))
                out.expected.append(Expected(
                    "voice", v.topic, voice,
                    due(start + (j + 1) * FB / v.data_rate)))
            _add_oqpsk(cap, tx.c_stream(frames), v, level, shift, T, device)
        elif v.kind in ("R", "T"):
            spec = mix.get("bursts", {}).get(v.kind)
            if not spec:
                continue
            b_level = float(spec.get("level", level))
            n_w = sum(1 for w in vfos if w.kind == v.kind)
            w_idx = [w.topic for w in vfos if w.kind == v.kind].index(v.topic)
            t0 = float(spec["first_s"]) + w_idx * float(spec["every_s"]) / n_w
            fa = out_rate(v.data_rate)
            audio = torch.zeros(fa * T, dtype=torch.float32, device=device)
            bursts = []
            while True:
                if v.kind == "R":
                    # byte 2 names the R message; bit 3 of byte 1 clear:
                    # not a user-data ISU
                    head = rng.bytes(2)
                    info = (bytes([head[0], head[1] & 0xF7,
                                   R_TYPES[int(rng.integers(len(R_TYPES)))]])
                            + rng.bytes(14))
                    bits = tx.r_burst(info)
                    dur = len(bits) / v.data_rate
                    key = info
                else:
                    reg = _reg(rng)
                    lo, hi = spec.get("text_len", (8, 40))
                    text = _text(rng, lo + (len(bursts) * 7 + w_idx * 3)
                                 % (hi - lo + 1), taken)
                    sus = tx.segment_isu(tx.acars_userdata(
                        "2", reg, "!", "H1", "A", text), aesid, GESID)
                    bits = tx.t_burst(aesid, GESID, sus)
                    dur = (len(bits) + 4) / v.data_rate
                    key = bytes([(aesid >> 16) & 0xFF, (aesid >> 8) & 0xFF,
                                 aesid & 0xFF, GESID])
                if t0 + dur > T - 0.5:
                    break
                bursts.append((t0, bits))
                out.expected.append(Expected(v.kind, v.topic, key,
                                             due(t0 + dur)))
                if v.kind == "T":
                    out.expected.append(Expected(
                        "acars", v.topic, (reg, text), due(t0 + dur)))
                t0 += float(spec["every_s"])
            if v.kind == "R":
                for t_b, bits in bursts:
                    audio += synth.msk_audio(
                        bits, fa * T, fa, v.data_rate, fa / 4 + 40.0, b_level,
                        start=int(round(t_b * fa)), device=device)
                cap.add_real_audio(audio, fa, v.offset_hz)
            else:
                n_hi = 16 * v.data_rate * T
                train = sum(synth.oqpsk_train(
                    bits, n_hi, v.data_rate,
                    int(round(t_b * 16 * v.data_rate)), device)
                    for t_b, bits in bursts)
                cap.add_baseband(synth.oqpsk_spectrum(
                    train, v.data_rate, b_level), 16 * v.data_rate,
                    v.offset_hz, 8000.0, _band(v.data_rate))
    iq = cap.iq(float(mix["noise"]), gen)
    out.iq = iq.cpu().numpy()
    out.expected.sort(key=lambda e: e.due)
    return out


def _band(rate: int) -> float:
    return 8000.0 if rate != 8400 else 6000.0


def _add_oqpsk(cap, bits, v, level, start_hi, T, device) -> None:
    n_hi = 16 * v.data_rate * T
    assert len(bits) * 16 == n_hi, "a periodic stream fills the pass"
    train = synth.oqpsk_train(bits, n_hi, v.data_rate, start_hi, device)
    cap.add_baseband(synth.oqpsk_spectrum(train, v.data_rate, level),
                     16 * v.data_rate, v.offset_hz, 8000.0,
                     _band(v.data_rate))
