"""ACARS application-layer decoding (native libacars replacement).

The reference shells out to libacars-2: it strips the sublabel/MFI for
uplinks (la_acars_extract_sublabel_and_mfi, ref: decode/decode.cpp:33-45)
and merges `la_acars_decode_apps`' JSON tree into ``ACARSItem.parsed``
(ref: decode.cpp:50-58), which the jsondump output embeds.

This module implements the decoders natively:

- sublabel / MFI extraction ("#<sublabel><MFI>..." uplink prefixes)
- ARINC 622 ATS envelope parse (`/<addr>.<IMI>.<7-char reg><hex>`)
  with CRC-16/CCITT check over IMI + registration + binary payload
- ADS-C group decode (protocol/adsc.py, DO-258A tagged binary)
- CPDLC FANS-1/A decode (protocol/cpdlc.py, ASN.1 UPER)
- AFN (ATS facilities notification) field split
- Media Advisory (label SA) decode
- OOOI event labels (QA..QD)

Unknown applications pass through untouched — exactly what the reference
does when libacars has no decoder.
"""

from __future__ import annotations

import re

from . import adsc, cpdlc

# label -> OOOI event (subset of the conventional assignments)
_OOOI = {"QA": "out", "QB": "off", "QC": "on", "QD": "in"}

_ARINC622_IMIS = ("AT1", "CR1", "CC1", "DR1", "AFN", "ADS", "DIS")
_IMI_APP = {"AT1": "cpdlc", "CR1": "cpdlc", "CC1": "cpdlc", "DR1": "cpdlc",
            "AFN": "afn", "ADS": "ads-c", "DIS": "ads-c"}


def extract_sublabel_mfi(label: str, text: str):
    """Uplink messages may carry '#<2-char sublabel><2-char MFI>' at the
    start of the text (ref libacars semantics used at decode.cpp:33-45).

    Returns (sublabel, mfi, remaining_text)."""
    m = re.match(r"^#([0-9A-Z]{2})([0-9A-Z]{2})?", text or "")
    if not m:
        return "", "", text
    sublabel = m.group(1)
    mfi = m.group(2) or ""
    return sublabel, mfi, text[m.end():]


def _crc16_ccitt(data: bytes, init: int = 0xFFFF) -> int:
    """CRC-16/CCITT-FALSE (poly 0x1021, MSB-first) as used to protect
    ARINC 622 ATS messages.  Appending the 2 CRC bytes big-endian makes
    the running CRC of the whole sequence zero."""
    crc = init
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) \
                & 0xFFFF
    return crc


def _decode_afn(rest: str) -> dict:
    """AFN payload: '/'-separated 3-letter-tag fields, e.g.
    'AFN/FMHN104UA,260790/FPON12345W123456,...' (+ optional 4-hex CRC
    as the final comma field)."""
    out: dict = {"fields": []}
    m = re.search(r",([0-9A-F]{4})$", rest)
    if m:
        out["crc_hex"] = m.group(1)
        rest = rest[:m.start()]
    for field in rest.split("/"):
        if not field:
            continue
        tag, val = field[:3], field[3:]
        out["fields"].append({"tag": tag, "data": val})
    return out


def decode_arinc622(text: str, downlink: bool = True) -> dict | None:
    """Parse an ARINC 622 ATS envelope and deep-decode its payload.

    Binary apps (CPDLC AT1/CR1/CC1/DR1, ADS-C ADS/DIS) carry
    `.<7-char registration (dot-padded)><hex payload><4 hex CRC>` after
    the IMI; AFN is text.  Returns {"arinc622": {...}, "app": ...,
    maybe "cpdlc"/"adsc"/"afn"} or None if not an ATS envelope.
    """
    m = re.match(r"^/([A-Z0-9]{4,8})\.([A-Z0-9]{2,3})(.*)$", text or "",
                 re.DOTALL)
    if not m:
        return None
    gnd, imi, rest = m.groups()
    if imi not in _ARINC622_IMIS:
        return None
    out = {"gs_addr": gnd, "imi": imi}
    result = {"arinc622": out, "app": _IMI_APP[imi]}
    if imi == "AFN":
        result["afn"] = _decode_afn(rest.lstrip("/"))
        return result
    # binary apps: .<reg7><hex...>
    bm = re.match(r"^\.([A-Z0-9.\-]{7})([0-9A-F]*)$", rest, re.DOTALL)
    if not bm:
        out["payload"] = rest
        return result
    reg7, hexpart = bm.groups()
    out["reg"] = reg7.lstrip(".")
    if len(hexpart) < 4 or len(hexpart) % 2:
        out["payload"] = hexpart
        return result
    blob = bytes.fromhex(hexpart)
    payload = blob[:-2]          # trailing 2 bytes are the ARINC 622 CRC
    covered = (imi + "." + reg7).encode("latin-1") + blob
    out["crc_ok"] = _crc16_ccitt(covered) == 0
    out["payload_hex"] = payload.hex().upper()
    if imi in ("ADS", "DIS"):
        result.update(adsc.decode(payload, downlink=downlink))
    else:
        result.update(cpdlc.decode(imi, payload, downlink=downlink))
    return result


def decode_media_advisory(text: str) -> dict | None:
    """Label SA media advisory: '0<E|L>V<version..>/<links>' style."""
    m = re.match(r"^(\d)([EL])([0-9A-Z])(\d{6})([VSHGCM2XIA]+)", text or "")
    if not m:
        return None
    ver, el, link, t, links = m.groups()
    return {"media_advisory": {
        "version": ver,
        "state": "established" if el == "E" else "lost",
        "current_link": link,
        "time": f"{t[0:2]}:{t[2:4]}:{t[4:6]}",
        "available_links": list(links),
    }}


def decode_apps(label: str, text: str, downlink: bool) -> dict:
    """Returns a dict to merge into ACARSItem.parsed (may be empty).

    Downlink texts carry a 10-char msg_num(4)+flight(6) preamble before
    the application payload; the reference strips it before handing to
    libacars (`message.mid(10)`, ref: decode/decode.cpp:26-31).  We try
    the stripped form first and fall back to the raw text so synthetic
    or nonstandard messages still decode."""
    parsed: dict = {}
    body = text or ""
    if not downlink:
        sublabel, mfi, body = extract_sublabel_mfi(label, body)
        if sublabel:
            parsed["sublabel"] = sublabel
        if mfi:
            parsed["mfi"] = mfi
    bodies = [body[10:], body] if downlink and len(body) > 10 else [body]
    if label in _OOOI:
        parsed["oooi_event"] = _OOOI[label]
    if label == "SA":
        for b in bodies:
            adv = decode_media_advisory(b)
            if adv:
                parsed.update(adv)
                break
    for b in bodies:
        a622 = decode_arinc622(b, downlink=downlink)
        if a622:
            parsed.update(a622)
            break
    return parsed


def enrich(item) -> None:
    """Populate item.parsed in place (the forwarder-thread hook,
    ref decode.cpp:368-416 calls libacarsDecode per item)."""
    if item.nonacars or not item.message:
        return
    label = item.LABEL.decode("latin-1") if isinstance(item.LABEL, bytes) \
        else str(item.LABEL)
    parsed = decode_apps(label, item.message, item.downlink)
    if parsed:
        item.parsed.update(parsed)


# builders for synthetic end-to-end tests -------------------------------

def build_arinc622(gs_addr: str, imi: str, reg: str, payload: bytes) -> str:
    """Assemble the ATS envelope text (inverse of decode_arinc622)."""
    reg7 = reg.upper().rjust(7, ".")
    covered = (imi + "." + reg7).encode("latin-1") + payload
    crc = _crc16_ccitt(covered)
    return f"/{gs_addr}.{imi}.{reg7}{payload.hex().upper()}{crc:04X}"
