"""CPDLC (FANS-1/A controller-pilot data link) decoding.

The reference forwards CPDLC payloads to libacars
(`la_acars_decode_apps`, ref: decode/decode.cpp:50-58); aero-tpu decodes
the FANS-1/A ASN.1 UPER encoding natively.  Wire picture (ARINC 622):

    /<addr>.AT1.<reg><hex UPER payload><4 hex CRC chars>      CPDLC message
    /<addr>.CR1.<reg><hex>                                    connect request
    /<addr>.CC1.<reg><hex>                                    connect confirm
    /<addr>.DR1.<reg><hex>                                    disconnect req

FANS-1/A AT1 payload (unaligned PER, no extensibility markers):

  ATCMessage ::= SEQUENCE {                -- preamble: 1 bit (seqOf?)
    header SEQUENCE {                      -- preamble: 2 bits
      msgId  INTEGER (0..63),              -- 6 bits
      msgRef INTEGER (0..63) OPTIONAL,     -- 6 bits
      timestamp SEQUENCE {                 -- 5 + 6 + 6 bits
        hours (0..23), minutes (0..59), seconds (0..59) } OPTIONAL },
    element   MsgElementId,                -- CHOICE: 8b uplink / 7b downlink
    moreElems SEQUENCE SIZE(1..4) OF MsgElementId OPTIONAL }  -- 2-bit count-1

The uplink element CHOICE has 183 alternatives (UM0..UM182) and the
downlink 81 (DM0..DM80); the choice index IS the UM/DM number.  Message
titles follow ICAO Doc 4444 Appendix 5 / the FANS-1/A message set.

Argument decoding policy: EVERY element's argument is structurally
decoded via the FANS-1/A type set in ``fans.py`` (altitudes, speeds,
positions, routes, unit names, position reports, …) into an ``args``
dict, and the element title's bracketed slots are rendered with the
decoded values into ``text``.  Free-text elements (UM169/UM170,
DM67/DM68: IA5String SIZE(1..256)) additionally keep the legacy
``freetext`` key.  If an argument fails to decode (malformed or a
layout mismatch vs our DO-219 reconstruction — see fans.py docstring),
that element degrades to ``args_hex`` with the remaining bits; headers
and message identity (the operationally load-bearing part) always
decode.  The decoder never raises.
"""

from __future__ import annotations

from . import fans
from .bitio import BitReader, BitWriter

# ----------------------------------------------------------- message sets
# Titles per ICAO Doc 4444 / FANS-1/A.  Index == UM/DM number.

UPLINK_TITLES = {
    0: "UNABLE", 1: "STANDBY", 2: "REQUEST DEFERRED", 3: "ROGER",
    4: "AFFIRM", 5: "NEGATIVE",
    6: "EXPECT [altitude]",
    7: "EXPECT CLIMB AT [time]", 8: "EXPECT CLIMB AT [position]",
    9: "EXPECT DESCENT AT [time]", 10: "EXPECT DESCENT AT [position]",
    11: "EXPECT CRUISE CLIMB AT [time]",
    12: "EXPECT CRUISE CLIMB AT [position]",
    13: "AT [time] EXPECT CLIMB TO [altitude]",
    14: "AT [position] EXPECT CLIMB TO [altitude]",
    15: "AT [time] EXPECT DESCENT TO [altitude]",
    16: "AT [position] EXPECT DESCENT TO [altitude]",
    17: "AT [time] EXPECT CRUISE CLIMB TO [altitude]",
    18: "AT [position] EXPECT CRUISE CLIMB TO [altitude]",
    19: "MAINTAIN [altitude]",
    20: "CLIMB TO AND MAINTAIN [altitude]",
    21: "AT [time] CLIMB TO AND MAINTAIN [altitude]",
    22: "AT [position] CLIMB TO AND MAINTAIN [altitude]",
    23: "DESCEND TO AND MAINTAIN [altitude]",
    24: "AT [time] DESCEND TO AND MAINTAIN [altitude]",
    25: "AT [position] DESCEND TO AND MAINTAIN [altitude]",
    26: "CLIMB TO REACH [altitude] BY [time]",
    27: "CLIMB TO REACH [altitude] BY [position]",
    28: "DESCEND TO REACH [altitude] BY [time]",
    29: "DESCEND TO REACH [altitude] BY [position]",
    30: "MAINTAIN BLOCK [altitude] TO [altitude]",
    31: "CLIMB TO AND MAINTAIN BLOCK [altitude] TO [altitude]",
    32: "DESCEND TO AND MAINTAIN BLOCK [altitude] TO [altitude]",
    33: "CRUISE [altitude]", 34: "CRUISE CLIMB TO [altitude]",
    35: "CRUISE CLIMB ABOVE [altitude]",
    36: "EXPEDITE CLIMB TO [altitude]",
    37: "EXPEDITE DESCENT TO [altitude]",
    38: "IMMEDIATELY CLIMB TO [altitude]",
    39: "IMMEDIATELY DESCEND TO [altitude]",
    40: "IMMEDIATELY STOP CLIMB AT [altitude]",
    41: "IMMEDIATELY STOP DESCENT AT [altitude]",
    42: "EXPECT TO CROSS [position] AT [altitude]",
    43: "EXPECT TO CROSS [position] AT OR ABOVE [altitude]",
    44: "EXPECT TO CROSS [position] AT OR BELOW [altitude]",
    45: "EXPECT TO CROSS [position] AT AND MAINTAIN [altitude]",
    46: "CROSS [position] AT [altitude]",
    47: "CROSS [position] AT OR ABOVE [altitude]",
    48: "CROSS [position] AT OR BELOW [altitude]",
    49: "CROSS [position] AT AND MAINTAIN [altitude]",
    50: "CROSS [position] BETWEEN [altitude] AND [altitude]",
    51: "CROSS [position] AT [time]",
    52: "CROSS [position] AT OR BEFORE [time]",
    53: "CROSS [position] AT OR AFTER [time]",
    54: "CROSS [position] BETWEEN [time] AND [time]",
    55: "CROSS [position] AT [speed]",
    56: "CROSS [position] AT OR LESS THAN [speed]",
    57: "CROSS [position] AT OR GREATER THAN [speed]",
    58: "CROSS [position] AT [time] AT [altitude]",
    59: "CROSS [position] AT OR BEFORE [time] AT [altitude]",
    60: "CROSS [position] AT OR AFTER [time] AT [altitude]",
    61: "CROSS [position] AT AND MAINTAIN [altitude] AT [speed]",
    62: "AT [time] CROSS [position] AT AND MAINTAIN [altitude]",
    63: "AT [time] CROSS [position] AT AND MAINTAIN [altitude] AT [speed]",
    64: "OFFSET [distance] [direction] OF ROUTE",
    65: "AT [position] OFFSET [distance] [direction] OF ROUTE",
    66: "AT [time] OFFSET [distance] [direction] OF ROUTE",
    67: "PROCEED BACK ON ROUTE",
    68: "REJOIN ROUTE BY [position]", 69: "REJOIN ROUTE BY [time]",
    70: "EXPECT BACK ON ROUTE BY [position]",
    71: "EXPECT BACK ON ROUTE BY [time]",
    72: "RESUME OWN NAVIGATION",
    73: "[predeparture clearance]",
    74: "PROCEED DIRECT TO [position]",
    75: "WHEN ABLE PROCEED DIRECT TO [position]",
    76: "AT [time] PROCEED DIRECT TO [position]",
    77: "AT [position] PROCEED DIRECT TO [position]",
    78: "AT [altitude] PROCEED DIRECT TO [position]",
    79: "CLEARED TO [position] VIA [route clearance]",
    80: "CLEARED [route clearance]",
    81: "CLEARED [procedure name]",
    82: "CLEARED TO DEVIATE UP TO [distance] [direction] OF ROUTE",
    83: "AT [position] CLEARED [route clearance]",
    84: "AT [position] CLEARED [procedure name]",
    85: "EXPECT [route clearance]",
    86: "AT [position] EXPECT [route clearance]",
    87: "EXPECT DIRECT TO [position]",
    88: "AT [position] EXPECT DIRECT TO [position]",
    89: "AT [time] EXPECT DIRECT TO [position]",
    90: "AT [altitude] EXPECT DIRECT TO [position]",
    91: "HOLD AT [position] MAINTAIN [altitude] INBOUND TRACK [degrees] "
        "[direction] TURN LEG TIME [leg type]",
    92: "HOLD AT [position] AS PUBLISHED MAINTAIN [altitude]",
    93: "EXPECT FURTHER CLEARANCE AT [time]",
    94: "TURN [direction] HEADING [degrees]",
    95: "TURN [direction] GROUND TRACK [degrees]",
    96: "CONTINUE PRESENT HEADING",
    97: "AT [position] FLY HEADING [degrees]",
    98: "IMMEDIATELY TURN [direction] HEADING [degrees]",
    99: "EXPECT [procedure name]",
    100: "AT [time] EXPECT [speed]",
    101: "AT [position] EXPECT [speed]",
    102: "AT [altitude] EXPECT [speed]",
    103: "AT [time] EXPECT [speed] TO [speed]",
    104: "AT [position] EXPECT [speed] TO [speed]",
    105: "AT [altitude] EXPECT [speed] TO [speed]",
    106: "MAINTAIN [speed]", 107: "MAINTAIN PRESENT SPEED",
    108: "MAINTAIN [speed] OR GREATER", 109: "MAINTAIN [speed] OR LESS",
    110: "MAINTAIN [speed] TO [speed]",
    111: "INCREASE SPEED TO [speed]",
    112: "INCREASE SPEED TO [speed] OR GREATER",
    113: "REDUCE SPEED TO [speed]",
    114: "REDUCE SPEED TO [speed] OR LESS",
    115: "DO NOT EXCEED [speed]", 116: "RESUME NORMAL SPEED",
    117: "CONTACT [unit name] [frequency]",
    118: "AT [position] CONTACT [unit name] [frequency]",
    119: "AT [time] CONTACT [unit name] [frequency]",
    120: "MONITOR [unit name] [frequency]",
    121: "AT [position] MONITOR [unit name] [frequency]",
    122: "AT [time] MONITOR [unit name] [frequency]",
    123: "SQUAWK [beacon code]", 124: "STOP SQUAWK",
    125: "SQUAWK ALTITUDE", 126: "STOP ALTITUDE SQUAWK",
    127: "REPORT BACK ON ROUTE",
    128: "REPORT LEAVING [altitude]", 129: "REPORT LEVEL [altitude]",
    130: "REPORT PASSING [position]",
    131: "REPORT REMAINING FUEL AND SOULS ON BOARD",
    132: "CONFIRM POSITION", 133: "CONFIRM ALTITUDE",
    134: "CONFIRM SPEED", 135: "CONFIRM ASSIGNED ALTITUDE",
    136: "CONFIRM ASSIGNED SPEED", 137: "CONFIRM ASSIGNED ROUTE",
    138: "CONFIRM TIME OVER REPORTED WAYPOINT",
    139: "CONFIRM REPORTED WAYPOINT", 140: "CONFIRM NEXT WAYPOINT",
    141: "CONFIRM NEXT WAYPOINT ETA", 142: "CONFIRM ENSUING WAYPOINT",
    143: "CONFIRM REQUEST", 144: "CONFIRM SQUAWK",
    145: "CONFIRM HEADING", 146: "CONFIRM GROUND TRACK",
    147: "REQUEST POSITION REPORT",
    148: "WHEN CAN YOU ACCEPT [altitude]",
    149: "CAN YOU ACCEPT [altitude] AT [position]",
    150: "CAN YOU ACCEPT [altitude] AT [time]",
    151: "WHEN CAN YOU ACCEPT [speed]",
    152: "WHEN CAN YOU ACCEPT [distance] [direction] OFFSET",
    153: "ALTIMETER [altimeter]",
    154: "RADAR SERVICES TERMINATED",
    155: "RADAR CONTACT [position]", 156: "RADAR CONTACT LOST",
    157: "CHECK STUCK MICROPHONE [frequency]",
    158: "ATIS [atis code]",
    159: "ERROR [error information]",
    160: "NEXT DATA AUTHORITY [facility designation]",
    161: "END SERVICE", 162: "SERVICE UNAVAILABLE",
    163: "[facility designation]",
    164: "WHEN READY", 165: "THEN",
    166: "DUE TO TRAFFIC", 167: "DUE TO AIRSPACE RESTRICTION",
    168: "DISREGARD", 169: "[free text]", 170: "[free text]",
    171: "CLIMB AT [vertical rate] MINIMUM",
    172: "CLIMB AT [vertical rate] MAXIMUM",
    173: "DESCEND AT [vertical rate] MINIMUM",
    174: "DESCEND AT [vertical rate] MAXIMUM",
    175: "REPORT REACHING [altitude]",
    176: "MAINTAIN OWN SEPARATION AND VMC",
    177: "AT PILOTS DISCRETION",
    178: "[reserved]",
    179: "SQUAWK IDENT",
    180: "REPORT REACHING BLOCK [altitude] TO [altitude]",
    181: "REPORT DISTANCE [to/from] [position]",
    182: "CONFIRM ATIS CODE",
}

DOWNLINK_TITLES = {
    0: "WILCO", 1: "UNABLE", 2: "STANDBY", 3: "ROGER", 4: "AFFIRM",
    5: "NEGATIVE",
    6: "REQUEST [altitude]",
    7: "REQUEST BLOCK [altitude] TO [altitude]",
    8: "REQUEST CRUISE CLIMB TO [altitude]",
    9: "REQUEST CLIMB TO [altitude]",
    10: "REQUEST DESCENT TO [altitude]",
    11: "AT [position] REQUEST CLIMB TO [altitude]",
    12: "AT [position] REQUEST DESCENT TO [altitude]",
    13: "AT [time] REQUEST CLIMB TO [altitude]",
    14: "AT [time] REQUEST DESCENT TO [altitude]",
    15: "REQUEST OFFSET [distance] [direction] OF ROUTE",
    16: "AT [position] REQUEST OFFSET [distance] [direction] OF ROUTE",
    17: "AT [time] REQUEST OFFSET [distance] [direction] OF ROUTE",
    18: "REQUEST [speed]", 19: "REQUEST [speed] TO [speed]",
    20: "REQUEST VOICE CONTACT",
    21: "REQUEST VOICE CONTACT [frequency]",
    22: "REQUEST DIRECT TO [position]",
    23: "REQUEST [procedure name]", 24: "REQUEST [route clearance]",
    25: "REQUEST CLEARANCE",
    26: "REQUEST WEATHER DEVIATION TO [position] VIA [route clearance]",
    27: "REQUEST WEATHER DEVIATION UP TO [distance] [direction] OF ROUTE",
    28: "LEAVING [altitude]", 29: "CLIMBING TO [altitude]",
    30: "DESCENDING TO [altitude]", 31: "PASSING [position]",
    32: "PRESENT ALTITUDE [altitude]", 33: "PRESENT POSITION [position]",
    34: "PRESENT SPEED [speed]", 35: "PRESENT HEADING [degrees]",
    36: "PRESENT GROUND TRACK [degrees]",
    37: "LEVEL [altitude]",
    38: "ASSIGNED ALTITUDE [altitude]", 39: "ASSIGNED SPEED [speed]",
    40: "ASSIGNED ROUTE [route clearance]",
    41: "BACK ON ROUTE",
    42: "NEXT WAYPOINT [position]", 43: "NEXT WAYPOINT ETA [time]",
    44: "ENSUING WAYPOINT [position]",
    45: "REPORTED WAYPOINT [position]", 46: "REPORTED WAYPOINT [time]",
    47: "SQUAWKING [beacon code]",
    48: "POSITION REPORT [position report]",
    49: "WHEN CAN WE EXPECT [speed]",
    50: "WHEN CAN WE EXPECT [speed] TO [speed]",
    51: "WHEN CAN WE EXPECT BACK ON ROUTE",
    52: "WHEN CAN WE EXPECT LOWER ALTITUDE",
    53: "WHEN CAN WE EXPECT HIGHER ALTITUDE",
    54: "WHEN CAN WE EXPECT CRUISE CLIMB TO [altitude]",
    55: "PAN PAN PAN", 56: "MAYDAY MAYDAY MAYDAY",
    57: "[remaining fuel] OF FUEL REMAINING AND [souls] SOULS ON BOARD",
    58: "CANCEL EMERGENCY",
    59: "DIVERTING TO [position] VIA [route clearance]",
    60: "OFFSETTING [distance] [direction] OF ROUTE",
    61: "DESCENDING TO [altitude]",
    62: "ERROR [error information]",
    63: "NOT CURRENT DATA AUTHORITY",
    64: "[facility designation]",
    65: "DUE TO WEATHER", 66: "DUE TO AIRCRAFT PERFORMANCE",
    67: "[free text]", 68: "[free text]",
    69: "REQUEST VMC DESCENT",
    70: "REQUEST HEADING [degrees]",
    71: "REQUEST GROUND TRACK [degrees]",
    72: "REACHING [altitude]",
    73: "[version number]",
    74: "MAINTAIN OWN SEPARATION AND VMC",
    75: "AT PILOTS DISCRETION",
    76: "REACHING BLOCK [altitude] TO [altitude]",
    77: "ASSIGNED BLOCK [altitude] TO [altitude]",
    78: "AT [time] [distance] [to/from] [position]",
    79: "ATIS [atis code]",
    80: "DEVIATING [distance] [direction] OF ROUTE",
}

N_UPLINK = 183           # UM0..UM182 -> 8-bit choice index
N_DOWNLINK = 81          # DM0..DM80  -> 7-bit choice index

# element -> UPER argument type (complete: every UM/DM is mapped)
UPLINK_ARGS = fans.UM_ARGS
DOWNLINK_ARGS = fans.DM_ARGS

UPLINK_FREETEXT = {169, 170}
DOWNLINK_FREETEXT = {67, 68}

IMI_NAMES = {
    "AT1": "cpdlc_message",
    "CR1": "cpdlc_connect_request",
    "CC1": "cpdlc_connect_confirm",
    "DR1": "cpdlc_disconnect_request",
}


def _decode_element(r: BitReader, downlink: bool) -> tuple[dict, bool]:
    """Returns (element dict, can_continue)."""
    nbits = 7 if downlink else 8
    titles = DOWNLINK_TITLES if downlink else UPLINK_TITLES
    argmap = DOWNLINK_ARGS if downlink else UPLINK_ARGS
    freetexts = DOWNLINK_FREETEXT if downlink else UPLINK_FREETEXT
    n_alts = N_DOWNLINK if downlink else N_UPLINK
    idx = r.read(nbits)
    kind = "DM" if downlink else "UM"
    el: dict = {"id": f"{kind}{idx}"}
    if idx >= n_alts:
        el["title"] = "unknown element"
        return el, False
    title = titles.get(idx, f"{kind}{idx}")
    el["title"] = title
    args_start = r.pos
    try:
        args = argmap[idx].dec(r)
    except (EOFError, ValueError) as e:
        r.pos = args_start
        el["args_hex"] = r.remainder_hex()
        el["args_error"] = str(e)
        return el, False
    if args is not True:                    # non-NULL argument
        if idx in freetexts:
            el["freetext"] = args
        else:
            el["args"] = args
        el["text"] = fans.render_title(title, args)
    else:
        el["text"] = title
    return el, True


def decode_at1(payload: bytes, downlink: bool) -> dict:
    """Decode a FANS-1/A ATC message (AT1 IMI, CRC already stripped)."""
    out: dict = {}
    try:
        r = BitReader(payload)
        has_more = r.read(1)
        hdr_pre = r.read(2)
        out["msg_id"] = r.read(6)
        if hdr_pre & 2:
            out["msg_ref"] = r.read(6)
        if hdr_pre & 1:
            h, m, s = r.read(5), r.read(6), r.read(6)
            out["timestamp"] = f"{h:02d}:{m:02d}:{s:02d}"
        elements = []
        el, ok = _decode_element(r, downlink)
        elements.append(el)
        if ok and has_more:
            count = r.read(2) + 1
            for _ in range(count):
                el, ok = _decode_element(r, downlink)
                elements.append(el)
                if not ok:
                    break
        out["elements"] = elements
        if not ok and r.bits_left:
            elements[-1].setdefault("args_hex", r.remainder_hex())
    except EOFError:
        out["decode_error"] = "truncated"
    return out


# DO-219 CPDLC connection management.  The ground's connect request
# (CR1) carries flight-plan correlation data the avionics checks against
# the active FMS flight plan before confirming (CC1): aircraft flight
# identification, departure and destination ICAO airports, and an
# optional departure time (EDCT).  The disconnect request (DR1) carries
# no mandatory data.  The reference forwards these to libacars
# (ref: decode/decode.cpp:50-58); like the AT1 set, the exact UPER
# layout is a documented clean-room reconstruction (fans.py docstring),
# so acceptance is guarded: structure is only surfaced when the parse
# consumes the payload cleanly (zero pad bits, valid charsets) and the
# raw hex is always kept alongside.
CONNECT_DATA = fans.SEQ_CONNECT_DATA


def _clean_tail(r: BitReader) -> bool:
    """True iff <8 bits remain and all of them are zero padding."""
    if r.bits_left >= 8:
        return False
    return r.read(r.bits_left) == 0 if r.bits_left else True


def decode_session(imi: str, payload: bytes) -> dict:
    """Structural decode of a CR1/CC1/DR1 session-management payload."""
    out = {"payload_hex": payload.hex().upper()}
    if not payload:
        out["empty"] = True
        return out
    if imi in ("CR1", "CC1"):
        try:
            r = BitReader(payload)
            data = CONNECT_DATA.dec(r)
            fid = data.get("flight_id", "")
            airports = [data.get(k) for k in
                        ("airport_departure", "airport_destination")]
            if (_clean_tail(r)
                    and all("A" <= c <= "Z" or "0" <= c <= "9" for c in fid)
                    and all(a is None or all("A" <= c <= "Z" for c in a)
                            for a in airports)):
                out.update(data)
                # the CR1/CC1 UPER layout is a clean-room reconstruction;
                # flag structurally-guessed fields so consumers can
                # distinguish them from the always-correct payload_hex
                # (ADVICE r3)
                out["structural"] = True
                return out
        except (EOFError, ValueError):
            pass
    # fallback (and the DR1 path): a bare 4-letter facility designation
    try:
        r = BitReader(payload)
        fac = fans.FACILITY_DESIGNATION.dec(r)
        if _clean_tail(r) and all("A" <= c <= "Z" for c in fac):
            out["facility_designation"] = fac
    except (EOFError, ValueError):
        pass
    return out


def encode_session(flight_id: str, airport_departure: str | None = None,
                   airport_destination: str | None = None,
                   time_departure: str | None = None) -> bytes:
    """Build a CR1/CC1 connect-management payload (tests / synthetic)."""
    v: dict = {"flight_id": flight_id}
    if airport_departure is not None:
        v["airport_departure"] = airport_departure
    if airport_destination is not None:
        v["airport_destination"] = airport_destination
    if time_departure is not None:
        h, m = (int(x) for x in time_departure.split(":"))
        v["time_departure"] = {"hours": h, "minutes": m}
    w = BitWriter()
    CONNECT_DATA.enc(w, v)
    return w.to_bytes()


def decode(imi: str, payload: bytes, downlink: bool) -> dict:
    """Decode any CPDLC-family IMI.  Returns {"cpdlc": {...}}."""
    body: dict = {"type": IMI_NAMES.get(imi, imi)}
    if imi == "AT1":
        body.update(decode_at1(payload, downlink))
    else:
        body.update(decode_session(imi, payload))
    return {"cpdlc": body}


# ---------------------------------------------------------------- encoder

def encode_at1(msg_id: int, elements, msg_ref: int | None = None,
               timestamp: str | None = None, downlink: bool = True) -> bytes:
    """Build a FANS-1/A AT1 UPER payload (tests / synthetic ground).

    ``elements``: list of (um_or_dm_number, args) where ``args`` is the
    JSON-able value for that element's argument type (fans.UM_ARGS /
    fans.DM_ARGS) — a str for free-text elements, None for NULL ones."""
    w = BitWriter()
    w.write(1 if len(elements) > 1 else 0, 1)
    w.write((2 if msg_ref is not None else 0) |
            (1 if timestamp is not None else 0), 2)
    w.write(msg_id, 6)
    if msg_ref is not None:
        w.write(msg_ref, 6)
    if timestamp is not None:
        h, m, s = (int(x) for x in timestamp.split(":"))
        w.write(h, 5)
        w.write(m, 6)
        w.write(s, 6)
    nbits = 7 if downlink else 8
    argmap = DOWNLINK_ARGS if downlink else UPLINK_ARGS

    def put(num, args):
        w.write(num, nbits)
        if args is not None:
            argmap[num].enc(w, args)

    put(*elements[0])
    if len(elements) > 1:
        w.write(len(elements) - 2, 2)
        for num, args in elements[1:]:
            put(num, args)
    return w.to_bytes()
