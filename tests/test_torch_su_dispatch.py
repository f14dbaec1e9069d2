"""The port's SU dispatcher and ACARS parser against ``aero_tpu``'s.

``aero_tpu_torch/protocol/su_dispatch.py`` and ``acars.py`` are no longer
verbatim copies: the dispatcher routes each SU through one body and
formats the display line only when asked (``display=False`` returns
``""`` at once for a type whose only product is that line), and the
parser checks and strips parity by table.  This file holds both to the
reference behaviour on the same SU streams:

- per kind of SU, the port with display on returns the reference's lines,
  and with display on and off emits the reference's ``on_acars`` items
  (every field, nested ISU item and field types included), ``on_error``
  strings, ``on_fragment`` items and C-channel assignments, in order;
- the parser on random user data, some of it ACARS-shaped with parity
  faults, returns, emits and reports what the reference's does;
- on a ``cband_busy``-like stream (``aerobench/traffic.py:_p_frames``,
  10500 bps, two messages a frame), the port's dispatcher without
  display and the benchmark's callback (``enrich``, then
  ``to_output_format("jsondump")`` at a fixed time) give the reference's
  jsondump lines byte for byte.
"""

import dataclasses

import numpy as np
import pytest

from aero_tpu.io.output import to_output_format as ref_output
from aero_tpu.protocol.acars import ParserISU as RefParser
from aero_tpu.protocol.acars_apps import enrich as ref_enrich
from aero_tpu.protocol.isu import ISUItem as RefISUItem
from aero_tpu.protocol.su_dispatch import PChannelSUDispatcher as RefDispatcher
from aero_tpu_torch.io.output import to_output_format
from aero_tpu_torch.protocol.acars import ParserISU
from aero_tpu_torch.protocol.acars_apps import enrich
from aero_tpu_torch.protocol.crc import append_crc16_bytes as crc
from aero_tpu_torch.protocol.isu import (ISUItem, make_acars_userdata,
                                         segment_isu)
from aero_tpu_torch.protocol.su_dispatch import (DISPLAY_ONLY,
                                                PChannelSUDispatcher)

AES, GES = 0x3C0123, 0x44


def _su(*body) -> bytes:
    """A 12-byte SU: ``body`` padded to 10 bytes, then its CRC."""
    return crc(bytes(body).ljust(10, b"\x00"))


def _isu(ud: bytes, aesid: int = AES, qno: int = 0, refno: int = 0) -> list:
    return [crc(s) for s in segment_isu(ud, aesid, GES, qno, refno)]


def _acars(reg="N12345", text="FST01TEST MESSAGE", bi="A", etb=False,
           label="H1"):
    return make_acars_userdata("2", reg, "!", label, bi, text, etb=etb)


def _flip(ud: bytes, k: int) -> bytes:
    """``ud`` with the parity bit of byte ``k`` flipped."""
    out = bytearray(ud)
    out[k] ^= 0x80
    return bytes(out)


# the system-table broadcasts: Psmc/Rsmc with each lsu (<= 1 is one
# branch, 2 and 3 the other), satellite id with one and two channels
# (east and west), P/R-channel control with and without a spot beam
_TABLES = {
    "fill": [_su(0x01)],
    "psmc_rsmc": [_su(0x05, 0, (s << 2) | lsu, 0x41, 0x12, 0x34, 0x05, 0x67,
                      0x0A, 0xBC) for s, lsu in ((3, 0), (4, 1), (5, 2),
                                                 (6, 3))],
    "satellite_id_one": [_su(0x0C, 0, 0x15, 0x70, 0, 0x6F, 0x81, 0x23, 0,
                             0)],
    "satellite_id_two": [_su(0x0C, 0, 0x16, 0xA0, 0, 0xC8, 0x01, 0x23,
                             0x82, 0x45)],
    "logon_confirm": [_su(0x11, 0x3C, 0x01, 0x23, GES)],
    "call_announcement": [_su(0x21, 0x3C, 0x01, 0x23, GES, 0, 0x81, 0x10,
                              0x02, 0x20)],
    "c_assignment": [_su(m, 0x3C, 0x01, 0x23, GES, 0, 0x81 * (m & 1),
                         0x10 + m, 0x80 * (m >> 1 & 1), 0x20 + m)
                     for m in (0x31, 0x32, 0x33, 0x34)],
    "pr_channel_control": [_su(0x40, 0, 0, 0, GES, 0, 0, 0x60, 0x81, 0x23),
                           _su(0x40, 0, 0, 0, GES, 0, 0, 0xF0, 0x01, 0x23)],
    "unknown": [_su(0x63, 1, 2, 3), _su(0x99, 4, 5, 6), _su(0x00),
                _su(0x3F, 7)],
}

_KINDS = dict(_TABLES, **{
    "acars": _isu(_acars()),
    "acars_no_text": _isu(_acars(text="")),
    "moretocome_pair": (_isu(_acars(text="FIRST PART ", etb=True), refno=1)
                        + _isu(_acars(text="SECOND PART", bi="B"),
                               refno=2)),
    "non_acars": _isu(bytes(range(0x10, 0x2E))),
    "reg_parity_error": _isu(_flip(_acars(), 6)),
    "text_parity_error": _isu(_flip(_acars(), 21)),
    "del_byte": _isu(_acars(text="AB\x7fCD\x7f")),
    "aesid_zero": _isu(_acars(), aesid=0),
    # SSUs with no initial SU held; then a whole ISU whose second SSU is
    # lost, so its last SSU finds no item at the sequence it needs
    "missing_ssu": ([_su(0xC1, 0x00, 1, 2, 3, 4, 5, 6, 7, 8),
                     _su(0xC0, 0x23, 9)]
                    + [s for j, s in enumerate(_isu(_acars(text="X" * 30)))
                       if j != 2]),
})

_MIXED = [su for kind in ("fill", "psmc_rsmc", "acars", "satellite_id_one",
                          "unknown", "missing_ssu", "pr_channel_control",
                          "fill", "c_assignment", "logon_confirm")
          for su in _KINDS[kind]]


def _snap(v):
    """A field-for-field picture of an item: every field's type and
    value, nested items too."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,
                tuple((f.name, _snap(getattr(v, f.name)))
                      for f in dataclasses.fields(v)))
    return (type(v).__name__, v)


def _run(cls, sus, **kw):
    """Everything a dispatcher returns and emits over ``sus``."""
    out = {k: [] for k in ("lines", "acars", "fragments", "errors", "c")}
    d = cls(on_acars=lambda it: out["acars"].append(_snap(it)),
            on_fragment=lambda it: out["fragments"].append(_snap(it)),
            on_error=out["errors"].append,
            on_c_assignment=lambda it: out["c"].append(_snap(it)), **kw)
    for su in sus:
        out["lines"].append(d.dispatch(su))
    return out


@pytest.mark.parametrize("kind", list(_KINDS) + ["mixed"])
def test_dispatch_matches_the_reference(kind):
    sus = _MIXED if kind == "mixed" else _KINDS[kind]
    ref = _run(RefDispatcher, sus)
    on = _run(PChannelSUDispatcher, sus)
    off = _run(PChannelSUDispatcher, sus, display=False)
    assert on == ref
    assert off["lines"] == [""] * len(sus)
    assert {k: v for k, v in off.items() if k != "lines"} == \
        {k: v for k, v in ref.items() if k != "lines"}
    # every line the reference formats is there, and not empty
    assert all(ref["lines"])


@pytest.mark.parametrize("kind, expect", [
    ("acars", {"acars": 1, "fragments": 1}),
    ("moretocome_pair", {"acars": 1, "fragments": 2}),
    ("non_acars", {"acars": 1}),
    ("reg_parity_error", {"errors": 1}),
    ("text_parity_error", {"errors": 1}),
    ("aesid_zero", {"errors": 1}),
    ("c_assignment", {"acars": 4, "c": 4}),
    ("call_announcement", {"acars": 1}),
    ("logon_confirm", {"acars": 1}),
])
def test_each_kind_does_what_it_names(kind, expect):
    """The streams reach the paths they are named for (so the comparison
    above compares something)."""
    out = _run(PChannelSUDispatcher, _KINDS[kind], display=False)
    assert {k: len(v) for k, v in out.items() if v and k != "lines"} == \
        expect


def test_the_reference_lines_show_the_named_details():
    lines = _run(RefDispatcher, _KINDS["missing_ssu"])["lines"]
    assert lines[0].endswith(" SSU missing")
    item = dict(_run(RefDispatcher, _KINDS["del_byte"])["acars"][0][1])
    assert item["message"] == ("str", "AB<DEL>CD<DEL>")
    lines = _run(RefDispatcher, _KINDS["satellite_id_two"])["lines"]
    assert "W" in lines[0] and "Psmc2" in lines[0]


@pytest.mark.parametrize("hide", [(0x01,), (0xC0,), (0x05, 0x40, 0x71),
                                  (0x01, 0x0C, 0xC0, 0x11)])
def test_do_not_display_matches_the_reference(hide):
    ref = _run(RefDispatcher, _MIXED, do_not_display=hide)
    assert _run(PChannelSUDispatcher, _MIXED, do_not_display=hide) == ref
    off = _run(PChannelSUDispatcher, _MIXED, do_not_display=hide,
               display=False)
    assert off["lines"] == [""] * len(_MIXED)
    assert off["acars"] == ref["acars"] and off["c"] == ref["c"]
    assert "" in ref["lines"]


def test_display_only_is_what_routes_nothing():
    """A type marked display-only emits nothing and touches no reassembly
    state in the reference; every other type does something there."""
    for m in range(256):
        calls = []
        d = RefDispatcher(on_acars=calls.append,
                          on_c_assignment=calls.append)
        d.dispatch(_su(m, 0x3C, 0x01, 0x23, GES, 0, 0x81, 0x10, 0x02, 0x20))
        touched = bool(calls) or bool(d.isudata.items) or \
            d.isudata.missingssu
        assert DISPLAY_ONLY[m] == (not touched), hex(m)


def _parse(cls, item_cls, ud, aesid=AES):
    out = {k: [] for k in ("acars", "fragments", "errors")}
    p = cls(on_acars=lambda it: out["acars"].append(_snap(it)),
            on_fragment=lambda it: out["fragments"].append(_snap(it)),
            on_error=out["errors"].append)
    out["ok"] = p.parse(item_cls(AESID=aesid, GESID=GES, QNO=3, REFNO=5,
                                 userdata=ud))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_parse_matches_the_reference_on_random_userdata(seed):
    """Random user data: ACARS-shaped (with and without text, parity
    faults anywhere, DEL bytes, ETB) and not; every outcome the same."""
    rng = np.random.default_rng(seed)
    outcomes = set()
    for _ in range(300):
        n = int(rng.integers(1, 60))
        ud = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        if n > 16 and rng.random() < 0.8:
            text = "".join(chr(c) for c in rng.integers(0x20, 0x80, n // 2))
            ud = bytearray(_acars(text=text if rng.random() < 0.8 else "",
                                  etb=bool(rng.random() < 0.2)))
            for k in rng.integers(0, len(ud), int(rng.integers(0, 3))):
                if rng.random() < 0.3:
                    ud[k] ^= 0x80
        ud = bytes(ud)
        ref = _parse(RefParser, RefISUItem, ud)
        port = _parse(ParserISU, ISUItem, ud)
        assert port == ref, ud.hex()
        outcomes.add((ref["ok"], bool(ref["errors"]), bool(ref["fragments"])))
    # acars parsed, parity errors, non-ACARS all occurred
    assert {(True, False, True), (False, True, False),
            (True, False, False)} <= outcomes


def _busy_stream(seed: int, vfos: int):
    """The CRC-good SUs of ``vfos`` P VFOs' pass as ``cband_busy`` makes
    them (10500 bps, a 32 s pass, two messages a frame, 8-40
    characters), VFO by VFO, and the number of messages."""
    from aerobench import tx
    from aerobench.traffic import _p_frames, _reg
    rng = np.random.default_rng(seed)
    spec = {"acars_frame_share": 1.0, "messages_per_frame": 2,
            "text_len": [8, 40]}
    n_frames = 32 * 10500 // tx.p_frame_bits(10500)
    taken, streams, n_msgs = set(), [], 0
    for v in range(vfos):
        aesid = 0x400000 + 0x100 * v + 1
        fields, msgs = _p_frames(rng, 10500, n_frames, spec, v, aesid,
                                 _reg(rng), taken)
        streams.append([f[k:k + 12] for f in fields
                        for k in range(0, len(f), 12)])
        n_msgs += len(msgs)
    return streams, n_msgs


def _jsondump(cls, enrich_fn, output_fn, streams, **kw):
    lines = []

    def on_acars(item):
        enrich_fn(item)
        lines.append(output_fn("jsondump", "AERO-TPU", False, item,
                               now=1760000000.25))
    for sus in streams:
        d = cls(on_acars=on_acars, **kw)
        for su in sus:
            d.dispatch(su)
    return lines


def test_busy_stream_gives_the_reference_jsondump_lines():
    streams, n_msgs = _busy_stream(20260423, 4)
    sus = [su for s in streams for su in s]
    share = sum(DISPLAY_ONLY[su[0]] for su in sus) / len(sus)
    assert 0.3 < share < 0.6
    ref = _jsondump(RefDispatcher, ref_enrich, ref_output, streams)
    assert len(ref) == n_msgs > 100
    assert _jsondump(PChannelSUDispatcher, enrich, to_output_format,
                     streams, display=False) == ref
    assert _jsondump(PChannelSUDispatcher, enrich, to_output_format,
                     streams) == ref
