"""What decides ``correct``: the station's outputs against what the
traffic carries, its device step against the plain reference, and its
batched decode against the plain Viterbi.

- Outputs.  Every ACARS message (matched on VFO, registration and text,
  from the jsondump lines), voice frame (its 300 bytes, in order per C
  channel) and R/T packet due in the window's blocks has to come out
  within ``SLACK`` blocks of the block that holds its last sample, and
  nothing may come out, from the window's first drain on, that the
  traffic does not carry.  The capture repeats each pass, so an output is
  matched to the earliest unmatched copy due at most ``SLACK`` blocks
  before the drain that emitted it.
- Device step.  The packed buffers (soft bits, burst audio, telemetry)
  the station drained for some blocks against the configuration's
  reference (``run.reference_of``: ``ref.step.RefStation`` unless the
  configuration names a copy, which keeps its wire layout and
  ``TEL_SLOTS``) over the same blocks: from the reference's own initial state over the
  capture's first blocks, and from a copy of the station's state taken
  just before the window over the window's first blocks.
- Decode.  Each batched P decode made while those blocks drained, its
  info bits and SU CRC flags, against ``ref.viterbi`` on the reference's
  own soft bytes of the same frames.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from aerobench import tx
from aerobench.ref import viterbi as ref_viterbi
from aerobench.ref.step import TEL_SLOTS

SLACK = 4


def acars_key(line: str) -> tuple:
    """(registration, message text) of one jsondump line."""
    acars = json.loads(line)["isu"].get("acars", {})
    text = "".join(acars.get(k, "") for k in
                   ("msg_num", "msg_num_seq", "flight", "msg_text"))
    return acars.get("reg", "").lstrip("."), text


def match(traffic, emitted, first: int, last: int) -> dict:
    """``emitted``: [(kind, topic, key, drain block, time)].  Returns the
    matches {(kind, topic, key, due block): (drain block, time)}, the
    attempted [(Expected, due block)] of blocks ``first``..``last - 1``,
    the unplanted outputs, and the voice frames out of order."""
    L, nb = traffic.block_len, traffic.blocks
    index = defaultdict(list)
    for e in traffic.expected:
        index[(e.kind, e.topic, e.key)].append(e.due // L)
    matched, unplanted = {}, []
    last_voice = {}
    disorder = 0
    for kind, topic, key, d, t in emitted:
        hit = None
        for s_b in index.get((kind, topic, key), ()):
            p = (d - s_b) // nb
            for b in (p * nb + s_b, (p - 1) * nb + s_b):
                if d - SLACK <= b <= d and (kind, topic, key, b) not in matched:
                    if hit is None or b < hit:
                        hit = b
        if hit is None:
            if d >= first:
                unplanted.append((kind, topic, key, d))
            continue
        matched[(kind, topic, key, hit)] = (d, t)
        if kind == "voice":
            if hit < last_voice.get(topic, -1) and d >= first:
                disorder += 1
            last_voice[topic] = max(hit, last_voice.get(topic, -1))
    attempted = []
    for e in traffic.expected:
        s_b = e.due // L
        for p in range(first // nb - 1, last // nb + 2):
            b = p * nb + s_b
            if first <= b < last:
                attempted.append((e, b))
    return {"matched": matched, "attempted": attempted,
            "unplanted": unplanted, "disorder": disorder}


def missing(result) -> list:
    m = result["matched"]
    return [(e, b) for e, b in result["attempted"]
            if (e.kind, e.topic, e.key, b) not in m]


def compare_packed(ref, pairs) -> dict:
    """[(station's packed row, reference's packed row)] -> the numbers:
    ``soft_mad`` mean |difference| of the soft bytes (uint8 units),
    ``soft_off`` share of soft bytes off by more than 1, ``audio_mad``
    mean |difference| of burst audio (int16 units), ``tel_rel`` largest
    relative difference of a telemetry value (floor 1e-3), ``flags`` lock
    and slip flags that differ."""
    soft_d, audio_d, tel = [], [], 0.0
    flags = 0
    for got, want in pairs:
        for key in ref.order:
            pos, per, t0 = ref.layout[key]
            nb = len(ref.groups[key])
            a = got[pos:pos + nb * per]
            b = want[pos:pos + nb * per]
            if key[2]:
                audio_d.append(np.abs(a.view(np.int16).astype(np.int64)
                                      - b.view(np.int16).astype(np.int64)))
            else:
                soft_d.append(np.abs(a.astype(np.int64) - b.astype(np.int64)))
            ta = got[ref.soft_total:].view(np.float32)[t0:t0 + TEL_SLOTS * nb]
            tb = want[ref.soft_total:].view(np.float32)[t0:t0 + TEL_SLOTS * nb]
            ta, tb = ta.reshape(TEL_SLOTS, nb), tb.reshape(TEL_SLOTS, nb)
            vals = (0, 1) if key[2] else (1, 2, 3)
            for s in vals:
                rel = (np.abs(ta[s].astype(np.float64) - tb[s])
                       / np.maximum(np.abs(tb[s]), 1e-3))
                tel = max(tel, float(np.max(rel)) if rel.size else 0.0)
            if not key[2]:
                flags += int(np.sum(ta[0] != tb[0]) + np.sum(ta[4] != tb[4]))
    soft = np.concatenate(soft_d) if soft_d else np.zeros(1)
    audio = np.concatenate(audio_d) if audio_d else np.zeros(1)
    return {"soft_mad": float(np.mean(soft)),
            "soft_off": float(np.mean(soft > 1)),
            "audio_mad": float(np.mean(audio)),
            "tel_rel": tel, "flags": flags}


def realign(soft: np.ndarray, slip: int) -> np.ndarray:
    """One block's soft bytes of a VFO, realigned at a timing-grid slip
    as the drain realigns them: +1 puts two erasures (128) before them,
    -1 drops the first two."""
    soft = np.asarray(soft, np.float32)
    if slip > 0:
        return np.concatenate([np.full(2, 128.0, np.float32), soft])
    return soft[2:] if slip < 0 else soft


def p_streams(ref, rows) -> dict:
    """Packed rows of consecutive blocks -> {topic: soft stream}: each
    continuous P VFO's soft bytes over the blocks, realigned at the slips
    its telemetry reports."""
    out = {}
    for key in ref.order:
        if key[2] or key[1] not in tx.P_SPECS:
            continue
        pos, per, t0 = ref.layout[key]
        nb = len(ref.groups[key])
        parts = {t: [] for t in ref.topics[key]}
        for row in rows:
            slips = row[ref.soft_total:].view(np.float32)[
                t0 + 4 * nb:t0 + 5 * nb]
            sb = row[pos:pos + nb * per].reshape(nb, per)
            for r, t in enumerate(ref.topics[key]):
                parts[t].append(realign(sb[r], int(slips[r])))
        for t, p in parts.items():
            out[t] = np.concatenate(p) if p else np.zeros(0, np.float32)
    return out


def uw_flips(uw_soft: np.ndarray, rate: int) -> np.ndarray:
    """The soft bytes of a UW -> for each arm, whether it reads inverted
    (more than half its bits wrong)."""
    rep = tx.P_SPECS[rate][4]
    uw = np.repeat(tx.UW_BITS, rep)
    hard = (np.asarray(uw_soft) >= 128).astype(np.uint8)
    return np.array([np.sum(hard[a::rep] != uw[a::rep]) > len(uw) // rep // 2
                     for a in range(rep)])


def frame_payload(frame: np.ndarray, rate: int,
                  flips: np.ndarray) -> np.ndarray:
    """One P frame cut from the soft stream (header, dummy, payload, UW)
    -> its deinterleaved payload, the arms that ``flips`` names
    inverted."""
    cols, blocks, hdr, dummy, rep = tx.P_SPECS[rate]
    f = np.asarray(frame, np.float32).copy()
    for a in range(rep):
        if flips[a]:
            f[a::rep] = 255.0 - f[a::rep]
    n = 64 * cols
    d = tx.deinterleave_indices(cols)
    p0 = hdr + dummy
    return f[p0:p0 + n * blocks].reshape(blocks, n)[:, d].reshape(-1)


def _ends(stream: np.ndarray, tail: np.ndarray) -> np.ndarray:
    """Every position just past an occurrence of ``tail`` in ``stream``."""
    k = len(tail)
    cand = np.arange(max(0, len(stream) - k + 1))
    for j in range(k):
        cand = cand[stream[cand + j] == tail[j]]
        if not cand.size:
            break
    return cand + k


def compare_decodes(decodes, streams) -> dict:
    """The station's batched decodes against the plain Viterbi of the
    reference's own soft bytes.

    ``decodes``: [(drained block, rate, topics, frames, prefixes, info
    bits, SU flags)], one real row per frame, in the order the framers
    cut them; ``streams``: drained block -> ({topic: the station's soft
    stream}, {topic: the reference's}, the block's place in the run of
    compared blocks, their number).  Each frame is found in the station's
    stream by its bytes.  The reference's bytes at the same place are cut,
    polarity-set and deinterleaved here, with the reference's previous
    frame's last 62 as the history prefix, and decoded by ``ref.viterbi``,
    bit for bit against the station's.  As a framer does, each arm's
    polarity is read from the UW the lock was found on, the one just
    before the first frame, and held while the lock lasts; a frame whose
    station prefix is neutral is the first of a lock.  A frame drained so
    early in the run that it may begin before the compared blocks and is
    not found is skipped; one drained later whose bytes are not in the
    station's stream is ``decode_unfound``.  ``frames``: the frames
    compared; ``bad``: those of them whose bits or SU flags differ;
    ``diffs``: the first frames that differ."""
    bits = sus = frames = bad = unfound = 0
    held = {}                   # (stream, topic) -> (end of frame, flips)
    diffs = []
    for b, rate, topics, raws, pre, info, ok in decodes:
        if b not in streams:
            continue
        S, R, k, nb = streams[b]
        L = 32 * tx.P_SPECS[rate][4]
        soft_r, pre_r, idx = [], [], []
        for i, (t, raw) in enumerate(zip(topics, raws)):
            n = len(raw)
            s, r = S[t], R[t]
            ends = _ends(s, raw[-64:])
            starts = [e - n for e in ends if e - n >= 0
                      and np.array_equal(s[e - n:e], raw)]
            if not starts:
                # the frame ends in block k's bytes, so it lies wholly in
                # the stream once k blocks before it hold it (slips move
                # a block's count by 2)
                unfound += int(k * len(s) / nb >= n + 64)
                continue
            p0 = starts[0]
            if len(r) < p0 + n:
                unfound += 1
                continue
            first = bool(np.all(pre[i] == 128))
            last = held.get((id(R), t))
            if not first and last is not None and last[0] == p0:
                flips = last[1]
            elif p0 >= L:
                flips = uw_flips(r[p0 - L:p0], rate)
            else:
                continue
            held[(id(R), t)] = (p0 + n, flips)
            if first:
                h = np.full(ref_viterbi.HISTORY, 128.0, np.float32)
            elif p0 >= n:
                h = frame_payload(r[p0 - n:p0], rate,
                                  flips)[-ref_viterbi.HISTORY:]
            else:
                continue
            soft_r.append(frame_payload(r[p0:p0 + n], rate, flips))
            pre_r.append(h)
            idx.append(i)
        if not idx:
            continue
        r_info, r_ok = ref_viterbi.decode_p_frames(np.stack(soft_r),
                                                   np.stack(pre_r), rate)
        d_bits = np.sum(r_info != info[idx], axis=1)
        bits += int(d_bits.sum())
        d_sus = np.sum(r_ok != ok[idx], axis=1)
        sus += int(d_sus.sum())
        frames += len(idx)
        bad += int(np.count_nonzero(d_bits + d_sus))
        for j in np.flatnonzero(d_bits)[:max(0, 5 - len(diffs))]:
            i = idx[j]
            diffs.append([int(b), topics[i], int(d_bits[j]),
                          bool(np.all(pre[i] == 128)),
                          ok[i].astype(int).tolist(),
                          r_ok[j].astype(int).tolist()])
    return {"decode_bits": bits, "decode_sus": sus, "frames": frames,
            "bad": bad, "decode_unfound": unfound, "diffs": diffs}
