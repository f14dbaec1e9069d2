"""ADS-C (FANS-1/A Automatic Dependent Surveillance - Contract) decoding.

The reference forwards ADS-C payloads to libacars
(`la_acars_decode_apps`, ref: decode/decode.cpp:50-58).  aero-tpu decodes
them natively.  Wire picture (ARINC 622 ATS envelope, see acars_apps):

    /<ground addr>.ADS.<air reg><hex payload><4 hex CRC chars>

The binary payload is a concatenation of tagged groups (DO-258A).  Each
group is a 1-byte tag followed by a fixed-size body; field widths and
LSBs below follow DO-258A as implemented by libacars' adsc decoder:

  latitude / longitude   21-bit two's complement, LSB 180/2^20 deg
  altitude               16-bit two's complement, LSB 4 ft
  timestamp              15 bits, LSB 0.125 s (seconds within the hour)
  figure of merit        redundancy(1) accuracy(3) tcas(1) + 2 spare
  true track / heading   12 bits, LSB 360/4096 deg
  ground speed           13 bits, LSB 0.5 kt
  mach                   13 bits, LSB 0.0005
  vertical rate          12-bit two's complement, LSB 16 ft/min
  wind speed             9 bits, LSB 0.5 kt
  wind direction         9 bits, LSB 360/512 deg
  temperature            12-bit two's complement, LSB 0.25 deg C
  flight id              8 x 6-bit ICAO chars

Unknown or partially-understood groups degrade to a hex dump instead of
failing the whole message; the decoder never raises on malformed input.
Synthetic encoders for every decoded group live alongside so the format
is round-trip tested (tests/test_acars_apps.py) — the reference has no
oracle for this layer either (its only oracle is a live satellite).
"""

from __future__ import annotations

from .bitio import BitReader, BitWriter

LAT_LSB = 180.0 / (1 << 20)
TRACK_LSB = 360.0 / 4096.0
WINDDIR_LSB = 360.0 / 512.0

# downlink group tags (air -> ground, seen on the R/T burst channels)
DOWNLINK_TAGS = {
    3: "ack",
    4: "nak",
    5: "noncompliance_notification",
    6: "cancel_emergency_mode",
    7: "basic_report",
    9: "emergency_basic_report",
    10: "lateral_deviation_change_event",
    12: "flight_id",
    13: "predicted_route",
    14: "earth_ref",
    15: "air_ref",
    16: "meteo",
    17: "airframe_id",
    18: "vertical_rate_change_event",
    19: "altitude_range_change_event",
    20: "waypoint_change_event",
    22: "intermediate_projected_intent",
    23: "fixed_projected_intent",
}

# uplink group tags (ground -> air contract requests, seen on P channel)
UPLINK_TAGS = {
    1: "cancel_all_contracts",
    2: "cancel_contract",
    7: "periodic_contract_request",
    8: "event_contract_request",
    9: "emergency_periodic_contract_request",
    10: "cancel_emergency_mode",
}

ACCURACY = {
    0: "no FOM available",
    1: "<30 nm",
    2: "<15 nm",
    3: "<8 nm",
    4: "<4 nm",
    5: "<1 nm",
    6: "<0.25 nm",
    7: "<0.05 nm",
}


def _sixbit_chars(r: BitReader, n: int) -> str:
    """ICAO 6-bit character set: 1..26 -> A..Z, 0x20..0x3F -> itself."""
    out = []
    for _ in range(n):
        v = r.read(6)
        out.append(chr(v + 0x40) if v < 0x20 else chr(v))
    return "".join(out).strip()


def _basic_report(r: BitReader) -> dict:
    lat = r.read_signed(21) * LAT_LSB
    lon = r.read_signed(21) * LAT_LSB
    alt = r.read_signed(16) * 4
    ts = r.read(15) * 0.125
    red = r.read(1)
    acc = r.read(3)
    tcas = r.read(1)
    r.skip(2)
    return {
        "lat": round(lat, 7), "lon": round(lon, 7), "alt_ft": alt,
        "timestamp_s": ts,
        "nav_redundancy_ok": bool(red),
        "accuracy": ACCURACY[acc],
        "tcas_operational": bool(tcas),
    }


def _flight_id(r: BitReader) -> dict:
    return {"flight_id": _sixbit_chars(r, 8)}


def _earth_ref(r: BitReader) -> dict:
    trk = r.read(12) * TRACK_LSB
    gs = r.read(13) * 0.5
    vr = r.read_signed(12) * 16
    r.skip(3)
    return {"true_track_deg": round(trk, 2), "gs_kt": gs,
            "vert_rate_fpm": vr}


def _air_ref(r: BitReader) -> dict:
    hdg = r.read(12) * TRACK_LSB
    mach = r.read(13) * 0.0005
    vr = r.read_signed(12) * 16
    r.skip(3)
    return {"true_heading_deg": round(hdg, 2), "mach": round(mach, 4),
            "vert_rate_fpm": vr}


def _meteo(r: BitReader) -> dict:
    ws = r.read(9) * 0.5
    wd = r.read(9) * WINDDIR_LSB
    temp = r.read_signed(12) * 0.25
    r.skip(2)
    return {"wind_speed_kt": ws, "wind_dir_deg": round(wd, 2),
            "temp_c": temp}


def _airframe_id(r: BitReader) -> dict:
    return {"icao_hex": f"{r.read(24):06X}"}


def _predicted_route(r: BitReader) -> dict:
    nxt = {
        "lat": round(r.read_signed(21) * LAT_LSB, 7),
        "lon": round(r.read_signed(21) * LAT_LSB, 7),
        "alt_ft": r.read_signed(16) * 4,
        "eta_s": r.read(14),
    }
    nxt1 = {
        "lat": round(r.read_signed(21) * LAT_LSB, 7),
        "lon": round(r.read_signed(21) * LAT_LSB, 7),
        "alt_ft": r.read_signed(16) * 4,
    }
    r.skip(6)
    return {"next_waypoint": nxt, "next_plus_one": nxt1}


def _fixed_intent(r: BitReader) -> dict:
    out = {
        "lat": round(r.read_signed(21) * LAT_LSB, 7),
        "lon": round(r.read_signed(21) * LAT_LSB, 7),
        "alt_ft": r.read_signed(16) * 4,
    }
    r.skip(6)
    return out


def _intermediate_intent(r: BitReader) -> dict:
    """Sequence of {distance, track, altitude} points, 6 bytes each,
    running to the end of the group payload (the group is last-in-message
    by convention)."""
    pts = []
    while r.bits_left >= 48:
        pts.append({
            "distance_nm": r.read(16) * 0.125,
            "track_deg": round(r.read(12) * TRACK_LSB, 2),
            "alt_ft": r.read_signed(16) * 4,
        })
        r.skip(4)
    return {"points": pts}


# tag -> (body size in bytes, parser).  None size = variable (to end).
_DOWNLINK_PARSERS = {
    3: (1, lambda r: {"contract_request_num": r.read(8)}),
    4: (2, lambda r: {"contract_request_num": r.read(8),
                      "reason": r.read(8)}),
    6: (0, lambda r: {}),
    7: (10, _basic_report),
    9: (10, _basic_report),
    10: (10, _basic_report),
    12: (6, _flight_id),
    13: (17, _predicted_route),
    14: (5, _earth_ref),
    15: (5, _air_ref),
    16: (4, _meteo),
    17: (3, _airframe_id),
    18: (10, _basic_report),
    19: (10, _basic_report),
    20: (10, _basic_report),
    22: (None, _intermediate_intent),
    23: (8, _fixed_intent),
}

REPORT_INTERVAL_SCALE = (1, 8, 64, 256)     # seconds per LSB, by 2-bit scale

# group-request tags inside a periodic contract request: the downlink
# group tag followed by a 1-byte modulus ("include every Nth report")
_MODULUS_GROUPS = {12: "flight_id", 13: "predicted_route", 14: "earth_ref",
                   15: "air_ref", 16: "meteo", 17: "airframe_id"}


def _periodic_contract(r: BitReader) -> dict:
    """Periodic / emergency-periodic contract request: contract number,
    then group-request tags to end of payload (DO-258A structure;
    reporting interval = 2-bit scale x 6-bit count, documented
    reconstruction — round-trip tested like the rest of this module)."""
    out: dict = {"contract_num": r.read(8)}
    requests = []
    while r.bits_left >= 8:
        tag = r.read(8)
        if tag == 0:                                 # reporting interval
            scale = r.read(2)
            count = r.read(6)
            out["reporting_interval_s"] = REPORT_INTERVAL_SCALE[scale] * count
        elif tag in _MODULUS_GROUPS:
            requests.append({"group": _MODULUS_GROUPS[tag], "tag": tag,
                             "modulus": r.read(8)})
        else:
            out["unknown_request_hex"] = (bytes([tag]).hex().upper()
                                          + r.remainder_hex())
            break
    if requests:
        out["group_requests"] = requests
    return out


def _event_contract(r: BitReader) -> dict:
    """Event contract request: contract number, then event tags with
    thresholds (reconstruction, see _periodic_contract)."""
    out: dict = {"contract_num": r.read(8)}
    events = []
    while r.bits_left >= 8:
        tag = r.read(8)
        if tag == 10:                                # lateral deviation
            events.append({"event": "lateral_deviation_change", "tag": tag,
                           "threshold_nm": r.read(8) * 0.25})
        elif tag == 18:                              # vertical rate
            events.append({"event": "vertical_rate_change", "tag": tag,
                           "threshold_fpm": r.read_signed(16) * 16})
        elif tag == 19:                              # altitude range
            events.append({"event": "altitude_range_change", "tag": tag,
                           "ceiling_ft": r.read_signed(16) * 4,
                           "floor_ft": r.read_signed(16) * 4})
        elif tag == 20:                              # waypoint change
            events.append({"event": "waypoint_change", "tag": tag})
        else:
            out["unknown_event_hex"] = (bytes([tag]).hex().upper()
                                        + r.remainder_hex())
            break
    if events:
        out["events"] = events
    return out


def _noncompliance(r: BitReader) -> dict:
    """Noncompliance notification: contract request number + the list of
    (group tag, reason) pairs the aircraft cannot comply with."""
    out: dict = {"contract_request_num": r.read(8)}
    items = []
    while r.bits_left >= 16:
        items.append({"tag": r.read(8), "reason": r.read(8)})
    if items:
        out["noncomplying_groups"] = items
    return out


_DOWNLINK_PARSERS[5] = (None, _noncompliance)

_UPLINK_PARSERS = {
    1: (0, lambda r: {}),
    2: (1, lambda r: {"contract_num": r.read(8)}),
    7: (None, _periodic_contract),
    8: (None, _event_contract),
    9: (None, _periodic_contract),
    10: (0, lambda r: {}),
}


def decode(payload: bytes, downlink: bool = True) -> dict:
    """Decode an ADS-C binary payload (CRC already stripped by the ARINC
    622 envelope layer) into {"adsc": {"groups": [...], ...}}."""
    tags = DOWNLINK_TAGS if downlink else UPLINK_TAGS
    parsers = _DOWNLINK_PARSERS if downlink else _UPLINK_PARSERS
    groups = []
    err = False
    buf = memoryview(payload)
    i = 0
    while i < len(buf):
        tag = buf[i]
        i += 1
        name = tags.get(tag, f"tag_{tag}")
        size, fn = parsers.get(tag, (None, None))
        if fn is None:
            # unknown group: geometry unknowable, dump the rest
            groups.append({"group": name, "tag": tag,
                           "raw_hex": bytes(buf[i:]).hex().upper()})
            err = tag not in tags
            break
        body = bytes(buf[i:]) if size is None else bytes(buf[i:i + size])
        if size is not None and len(body) < size:
            groups.append({"group": name, "tag": tag, "truncated": True,
                           "raw_hex": body.hex().upper()})
            err = True
            break
        try:
            fields = fn(BitReader(body))
        except EOFError:
            groups.append({"group": name, "tag": tag, "truncated": True,
                           "raw_hex": body.hex().upper()})
            err = True
            break
        groups.append({"group": name, "tag": tag, **fields})
        i += len(body) if size is None else size
    out: dict = {"groups": groups}
    if err:
        out["decode_error"] = True
    return {"adsc": out}


# ---------------------------------------------------------------- encoders
# Synthetic builders used by the round-trip tests (and by anyone who wants
# to exercise a ground station end-to-end without an aircraft).

def encode_basic_report(lat: float, lon: float, alt_ft: int,
                        timestamp_s: float, redundancy=True, accuracy=7,
                        tcas=True, tag: int = 7) -> bytes:
    w = BitWriter()
    w.write(tag, 8)
    w.write_signed(round(lat / LAT_LSB), 21)
    w.write_signed(round(lon / LAT_LSB), 21)
    w.write_signed(alt_ft // 4, 16)
    w.write(round(timestamp_s / 0.125), 15)
    w.write(int(redundancy), 1)
    w.write(accuracy, 3)
    w.write(int(tcas), 1)
    w.write(0, 2)
    return w.to_bytes()


def encode_flight_id(flight: str) -> bytes:
    w = BitWriter()
    w.write(12, 8)
    s = flight.upper().ljust(8)[:8]
    for ch in s:
        v = ord(ch)
        w.write(v - 0x40 if 0x41 <= v <= 0x5A else v & 0x3F, 6)
    return w.to_bytes()


def encode_earth_ref(track_deg: float, gs_kt: float,
                     vert_rate_fpm: int) -> bytes:
    w = BitWriter()
    w.write(14, 8)
    w.write(round(track_deg / TRACK_LSB) % 4096, 12)
    w.write(round(gs_kt / 0.5), 13)
    w.write_signed(vert_rate_fpm // 16, 12)
    w.write(0, 3)
    return w.to_bytes()


def encode_air_ref(heading_deg: float, mach: float,
                   vert_rate_fpm: int) -> bytes:
    w = BitWriter()
    w.write(15, 8)
    w.write(round(heading_deg / TRACK_LSB) % 4096, 12)
    w.write(round(mach / 0.0005), 13)
    w.write_signed(vert_rate_fpm // 16, 12)
    w.write(0, 3)
    return w.to_bytes()


def encode_meteo(wind_speed_kt: float, wind_dir_deg: float,
                 temp_c: float) -> bytes:
    w = BitWriter()
    w.write(16, 8)
    w.write(round(wind_speed_kt / 0.5), 9)
    w.write(round(wind_dir_deg / WINDDIR_LSB) % 512, 9)
    w.write_signed(round(temp_c / 0.25), 12)
    w.write(0, 2)
    return w.to_bytes()


def encode_airframe_id(icao_hex: str) -> bytes:
    w = BitWriter()
    w.write(17, 8)
    w.write(int(icao_hex, 16), 24)
    return w.to_bytes()


def encode_predicted_route(next_wp: dict, next_plus_one: dict) -> bytes:
    w = BitWriter()
    w.write(13, 8)
    w.write_signed(round(next_wp["lat"] / LAT_LSB), 21)
    w.write_signed(round(next_wp["lon"] / LAT_LSB), 21)
    w.write_signed(next_wp["alt_ft"] // 4, 16)
    w.write(next_wp["eta_s"], 14)
    w.write_signed(round(next_plus_one["lat"] / LAT_LSB), 21)
    w.write_signed(round(next_plus_one["lon"] / LAT_LSB), 21)
    w.write_signed(next_plus_one["alt_ft"] // 4, 16)
    w.write(0, 6)
    return w.to_bytes()


def encode_ack(contract_request_num: int) -> bytes:
    return bytes([3, contract_request_num & 0xFF])


def encode_periodic_contract_request(contract_num: int,
                                     interval_s: int | None = None,
                                     group_moduli: dict | None = None,
                                     emergency: bool = False) -> bytes:
    """Uplink periodic (or emergency-periodic) contract request.
    ``group_moduli``: {downlink group tag: modulus}."""
    w = BitWriter()
    w.write(9 if emergency else 7, 8)
    w.write(contract_num & 0xFF, 8)
    if interval_s is not None:
        for scale_idx in range(len(REPORT_INTERVAL_SCALE)):
            scale = REPORT_INTERVAL_SCALE[scale_idx]
            if interval_s % scale == 0 and interval_s // scale < 64:
                break
        else:
            raise ValueError(f"unencodable interval {interval_s}")
        w.write(0, 8)
        w.write(scale_idx, 2)
        w.write(interval_s // scale, 6)
    for tag, modulus in (group_moduli or {}).items():
        w.write(tag, 8)
        w.write(modulus & 0xFF, 8)
    return w.to_bytes()


def encode_event_contract_request(contract_num: int, events: list) -> bytes:
    """Uplink event contract request.  ``events``: list of dicts shaped
    like _event_contract's output entries."""
    w = BitWriter()
    w.write(8, 8)
    w.write(contract_num & 0xFF, 8)
    for ev in events:
        tag = ev["tag"]
        w.write(tag, 8)
        if tag == 10:
            w.write(round(ev["threshold_nm"] / 0.25), 8)
        elif tag == 18:
            w.write_signed(ev["threshold_fpm"] // 16, 16)
        elif tag == 19:
            w.write_signed(ev["ceiling_ft"] // 4, 16)
            w.write_signed(ev["floor_ft"] // 4, 16)
        elif tag != 20:
            raise ValueError(f"unknown event tag {tag}")
    return w.to_bytes()


def encode_noncompliance(contract_request_num: int, groups: list) -> bytes:
    """Downlink noncompliance notification.  ``groups``: [(tag, reason)]."""
    w = BitWriter()
    w.write(5, 8)
    w.write(contract_request_num & 0xFF, 8)
    for tag, reason in groups:
        w.write(tag, 8)
        w.write(reason, 8)
    return w.to_bytes()
