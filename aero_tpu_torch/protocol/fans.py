"""FANS-1/A CPDLC message-element argument types (ASN.1 UPER).

The reference forwards CPDLC to libacars, whose decoder is generated
from the DO-219 FANS-1/A ASN.1 module (ref: decode/decode.cpp:50-58).
This module is the native equivalent: every uplink (UM0..UM182) and
downlink (DM0..DM80) message element is mapped to its argument type,
built from the UPER combinators in ``uper.py``.

The type *structure* (which elements take which argument kinds, the
CHOICE alternative sets, SEQUENCE field order and optionality) follows
the FANS-1/A message set as published in ICAO Doc 4444 Appendix 5 and
DO-219.  Exact integer ranges/units are a documented reconstruction —
this environment has no on-air oracle (neither does the reference: its
only oracle is a live satellite, SURVEY.md §4) — so, like the ADS-C
decoder, every layout is round-trip tested against this module's own
encoders (tests/test_acars_apps.py) and kept self-consistent end to end.

Decoded values are plain JSON-able dicts that drop into
``ACARSItem.parsed["cpdlc"]["elements"][i]["args"]``.
"""

from __future__ import annotations

from .uper import CHOICE, ENUM, IA5, INT, NULL, NUMSTR, SEQ, SEQOF, Uper

# ------------------------------------------------------------- leaf types

TIME = SEQ(("hours", INT(0, 23)), ("minutes", INT(0, 59)))

ALTITUDE = CHOICE(
    ("feet_qnh", INT(-60, 7000, 10)),            # 10 ft LSB
    ("meters_qnh", INT(-30, 25000)),
    ("feet_qfe", INT(-60, 7000, 10)),
    ("meters_qfe", INT(-30, 25000)),
    ("feet_gnss", INT(-60, 7000, 10)),
    ("meters_gnss", INT(-30, 25000)),
    ("flight_level", INT(30, 600)),
    ("flight_level_metric", INT(100, 2500, 10)),  # metres
)

SPEED = CHOICE(
    ("indicated_knots", INT(0, 400)),
    ("true_knots", INT(0, 2000)),
    ("ground_knots", INT(-50, 2000)),
    ("mach", INT(500, 4000, 0.001)),
)

DEGREES = CHOICE(
    ("degrees_magnetic", INT(1, 360)),
    ("degrees_true", INT(1, 360)),
)

DIRECTION = ENUM("left", "right", "either_side")

DISTANCE_OFFSET = CHOICE(
    ("nm", INT(1, 128)),
    ("km", INT(1, 256)),
)

DISTANCE = CHOICE(
    ("nm", INT(0, 9999, 0.1)),
    ("km", INT(0, 8000)),
)

LATITUDE = SEQ(
    ("direction", ENUM("north", "south")),
    ("degrees", INT(0, 90)),
    ("minutes", INT(0, 5999, 0.01), True),       # hundredths of minutes
)
LONGITUDE = SEQ(
    ("direction", ENUM("east", "west")),
    ("degrees", INT(0, 180)),
    ("minutes", INT(0, 5999, 0.01), True),
)
LATLON = SEQ(("latitude", LATITUDE), ("longitude", LONGITUDE))

PLACE_BEARING = SEQ(
    ("fix_name", IA5(1, 5)),
    ("latitude_longitude", LATLON, True),
    ("degrees", DEGREES),
)
PLACE_BEARING_DISTANCE = SEQ(
    ("fix_name", IA5(1, 5)),
    ("latitude_longitude", LATLON, True),
    ("degrees", DEGREES),
    ("distance", DISTANCE),
)

POSITION = CHOICE(
    ("fix_name", IA5(1, 5)),
    ("navaid", IA5(1, 4)),
    ("airport", IA5(4, 4)),
    ("latitude_longitude", LATLON),
    ("place_bearing_distance", PLACE_BEARING_DISTANCE),
)

FREQUENCY = CHOICE(
    ("hf_khz", INT(2850, 28000)),
    ("vhf_mhz", INT(23600, 27398, 0.005)),       # 118.000..136.990 MHz
    ("uhf_mhz", INT(9000, 15999, 0.025)),        # 225.000..399.975 MHz
    ("sat_channel", NUMSTR(12, 12)),
)

ALTIMETER = CHOICE(
    ("inhg", INT(2200, 3200, 0.01)),
    ("hpa", INT(7500, 12500, 0.1)),
)

VERTICAL_RATE = CHOICE(
    ("feet_per_minute", INT(0, 300, 100)),
    ("meters_per_minute", INT(0, 150, 10)),
)

BEACON_CODE = SEQOF(4, 4, INT(0, 7))             # 4 octal digits

ATIS_CODE = IA5(1, 1)

ERROR_INFORMATION = ENUM(
    "application_error", "duplicate_msg_identification_number",
    "unrecognized_msg_reference_number", "end_service_with_pending_msgs",
    "end_service_with_no_valid_response", "insufficient_msg_storage_capacity",
    "no_available_msg_identification_numbers", "commanded_termination",
    "insufficient_data", "unexpected_data", "invalid_data",
)

FACILITY_DESIGNATION = IA5(4, 4)                 # ICAO 4-letter

UNIT_NAME = SEQ(
    ("facility", CHOICE(("designation", FACILITY_DESIGNATION),
                        ("name", IA5(3, 18)))),
    ("function", ENUM("center", "approach", "tower", "final",
                      "ground_control", "clearance_delivery", "departure",
                      "control", "radio")),
)

TO_FROM = ENUM("to", "from")

FREE_TEXT = IA5(1, 256)

TEMPERATURE = CHOICE(("celsius", INT(-100, 100)),
                     ("fahrenheit", INT(-150, 200)))

WINDS = SEQ(
    ("direction_degrees", INT(1, 360)),
    ("speed", CHOICE(("knots", INT(0, 255)), ("kmh", INT(0, 511)))),
)

VERSION_NUMBER = INT(0, 15)

# CPDLC connect-management (CR1/CC1) flight-plan correlation data:
# flight id + departure/destination airports (+ optional EDCT), the
# fields the avionics verifies against the FMS before confirming the
# connection (DO-219 connection management; consumed by cpdlc.py).
SEQ_CONNECT_DATA = SEQ(
    ("flight_id", IA5(2, 8)),
    ("airport_departure", IA5(4, 4), True),
    ("airport_destination", IA5(4, 4), True),
    ("time_departure", TIME, True),
)

PROCEDURE_NAME = SEQ(
    ("type", ENUM("arrival", "approach", "departure")),
    ("procedure", IA5(1, 20)),
    ("transition", IA5(1, 5), True),
)

RUNWAY = SEQ(
    ("direction", INT(1, 36)),
    ("configuration", ENUM("left", "right", "center", "none")),
)

LEG_TYPE = CHOICE(
    ("leg_time_minutes", INT(1, 10, 0.5)),
    ("leg_distance_nm", INT(1, 50)),
    ("leg_distance_km", INT(1, 128)),
)

ROUTE_INFORMATION = CHOICE(
    ("published_identifier", SEQ(("fix_name", IA5(1, 5)),
                                 ("latitude_longitude", LATLON, True))),
    ("latitude_longitude", LATLON),
    ("place_bearing_place_bearing", SEQOF(2, 2, PLACE_BEARING)),
    ("place_bearing_distance", PLACE_BEARING_DISTANCE),
    ("airway_identifier", IA5(1, 5)),
    ("track_detail", SEQ(("track_name", IA5(1, 5)),
                         ("latitude_longitudes", SEQOF(1, 4, LATLON)))),
)

ROUTE_CLEARANCE = SEQ(
    ("airport_departure", IA5(4, 4), True),
    ("airport_destination", IA5(4, 4), True),
    ("runway_departure", RUNWAY, True),
    ("procedure_departure", PROCEDURE_NAME, True),
    ("runway_arrival", RUNWAY, True),
    ("procedure_approach", PROCEDURE_NAME, True),
    ("procedure_arrival", PROCEDURE_NAME, True),
    ("airway_intercept", SEQOF(1, 8, IA5(1, 5)), True),
    ("route_information", SEQOF(1, 128, ROUTE_INFORMATION), True),
)

HOLD_CLEARANCE = SEQ(
    ("position", POSITION),
    ("altitude", ALTITUDE),
    ("degrees", DEGREES),
    ("direction", DIRECTION),
    ("leg_type", LEG_TYPE, True),
)

PREDEPARTURE_CLEARANCE = SEQ(
    ("flight_id", IA5(2, 8)),
    ("aircraft_type", IA5(1, 4), True),
    ("atis_code", ATIS_CODE, True),
    ("time_departure", TIME, True),
    ("runway_departure", RUNWAY, True),
    ("revision_number", INT(1, 16), True),
    ("route_clearance", ROUTE_CLEARANCE),
)

POSITION_REPORT = SEQ(
    ("position_current", POSITION),
    ("time_at_position", TIME),
    ("altitude", ALTITUDE),
    ("fix_next", POSITION, True),
    ("time_eta_at_fix_next", TIME, True),
    ("fix_next_plus_one", POSITION, True),
    ("time_eta_destination", TIME, True),
    ("remaining_fuel", TIME, True),
    ("temperature", TEMPERATURE, True),
    ("winds", WINDS, True),
    ("turbulence", ENUM("light", "moderate", "severe"), True),
    ("icing", ENUM("trace", "light", "moderate", "severe"), True),
    ("speed", SPEED, True),
    ("speed_ground_knots", INT(-50, 2000), True),
    ("vertical_change", SEQ(("direction", ENUM("up", "down")),
                            ("rate", VERTICAL_RATE)), True),
    ("track_angle", DEGREES, True),
    ("true_heading", DEGREES, True),
    ("distance", DISTANCE, True),
    ("supplementary_information", FREE_TEXT, True),
    ("reported_waypoint_position", POSITION, True),
    ("reported_waypoint_time", TIME, True),
    ("reported_waypoint_altitude", ALTITUDE, True),
)

# --------------------------------------------------------- composite args
# SEQUENCE field order mirrors the bracketed slots in the message titles.

_S = SEQ
TIME_ALT = _S(("time", TIME), ("altitude", ALTITUDE))
POS_ALT = _S(("position", POSITION), ("altitude", ALTITUDE))
ALT_TIME = _S(("altitude", ALTITUDE), ("time", TIME))
ALT_POS = _S(("altitude", ALTITUDE), ("position", POSITION))
ALT_ALT = _S(("altitude1", ALTITUDE), ("altitude2", ALTITUDE))
POS_ALT_ALT = _S(("position", POSITION), ("altitude1", ALTITUDE),
                 ("altitude2", ALTITUDE))
POS_TIME = _S(("position", POSITION), ("time", TIME))
POS_TIME_TIME = _S(("position", POSITION), ("time1", TIME), ("time2", TIME))
POS_SPEED = _S(("position", POSITION), ("speed", SPEED))
POS_TIME_ALT = _S(("position", POSITION), ("time", TIME),
                  ("altitude", ALTITUDE))
POS_ALT_SPEED = _S(("position", POSITION), ("altitude", ALTITUDE),
                   ("speed", SPEED))
TIME_POS = _S(("time", TIME), ("position", POSITION))
TIME_POS_ALT = _S(("time", TIME), ("position", POSITION),
                  ("altitude", ALTITUDE))
TIME_POS_ALT_SPEED = _S(("time", TIME), ("position", POSITION),
                        ("altitude", ALTITUDE), ("speed", SPEED))
POS_POS = _S(("position1", POSITION), ("position2", POSITION))
DIST_DIR = _S(("distance_offset", DISTANCE_OFFSET), ("direction", DIRECTION))
POS_DIST_DIR = _S(("position", POSITION),
                  ("distance_offset", DISTANCE_OFFSET),
                  ("direction", DIRECTION))
TIME_DIST_DIR = _S(("time", TIME), ("distance_offset", DISTANCE_OFFSET),
                   ("direction", DIRECTION))
TIME_SPEED = _S(("time", TIME), ("speed", SPEED))
ALT_SPEED = _S(("altitude", ALTITUDE), ("speed", SPEED))
TIME_SPEED_SPEED = _S(("time", TIME), ("speed1", SPEED), ("speed2", SPEED))
POS_SPEED_SPEED = _S(("position", POSITION), ("speed1", SPEED),
                     ("speed2", SPEED))
ALT_SPEED_SPEED = _S(("altitude", ALTITUDE), ("speed1", SPEED),
                     ("speed2", SPEED))
SPEED_SPEED = _S(("speed1", SPEED), ("speed2", SPEED))
DIR_DEG = _S(("direction", DIRECTION), ("degrees", DEGREES))
POS_DEG = _S(("position", POSITION), ("degrees", DEGREES))
POS_PROC = _S(("position", POSITION), ("procedure_name", PROCEDURE_NAME))
POS_ROUTE = _S(("position", POSITION), ("route_clearance", ROUTE_CLEARANCE))
UNIT_FREQ = _S(("unit_name", UNIT_NAME), ("frequency", FREQUENCY))
POS_UNIT_FREQ = _S(("position", POSITION), ("unit_name", UNIT_NAME),
                   ("frequency", FREQUENCY))
TIME_UNIT_FREQ = _S(("time", TIME), ("unit_name", UNIT_NAME),
                    ("frequency", FREQUENCY))
FACILITY_TP4 = _S(("facility_designation", FACILITY_DESIGNATION),
                  ("tp4_table", ENUM("label_a", "label_b")))
TO_FROM_POS = _S(("to_from", TO_FROM), ("position", POSITION))
TIME_DIST_TO_FROM_POS = _S(("time", TIME), ("distance", DISTANCE),
                           ("to_from", TO_FROM), ("position", POSITION))
FUEL_SOULS = _S(("remaining_fuel", TIME), ("remaining_souls", INT(1, 1024)))

_NULL = NULL()

# --------------------------------------------- element -> argument type

UM_ARGS: dict[int, Uper] = {
    **{i: _NULL for i in (0, 1, 2, 3, 4, 5, 67, 72, 96, 107, 116, 124, 125,
                          126, 127, 131, 132, 133, 134, 135, 136, 137, 138,
                          139, 140, 141, 142, 143, 144, 145, 146, 147, 154,
                          156, 161, 162, 164, 165, 166, 167, 168, 176, 177,
                          178, 179, 182)},
    6: ALTITUDE, 7: TIME, 8: POSITION, 9: TIME, 10: POSITION,
    11: TIME, 12: POSITION,
    13: TIME_ALT, 14: POS_ALT, 15: TIME_ALT, 16: POS_ALT,
    17: TIME_ALT, 18: POS_ALT,
    19: ALTITUDE, 20: ALTITUDE,
    21: TIME_ALT, 22: POS_ALT, 23: ALTITUDE, 24: TIME_ALT, 25: POS_ALT,
    26: ALT_TIME, 27: ALT_POS, 28: ALT_TIME, 29: ALT_POS,
    30: ALT_ALT, 31: ALT_ALT, 32: ALT_ALT,
    33: ALTITUDE, 34: ALTITUDE, 35: ALTITUDE, 36: ALTITUDE, 37: ALTITUDE,
    38: ALTITUDE, 39: ALTITUDE, 40: ALTITUDE, 41: ALTITUDE,
    42: POS_ALT, 43: POS_ALT, 44: POS_ALT, 45: POS_ALT,
    46: POS_ALT, 47: POS_ALT, 48: POS_ALT, 49: POS_ALT,
    50: POS_ALT_ALT,
    51: POS_TIME, 52: POS_TIME, 53: POS_TIME, 54: POS_TIME_TIME,
    55: POS_SPEED, 56: POS_SPEED, 57: POS_SPEED,
    58: POS_TIME_ALT, 59: POS_TIME_ALT, 60: POS_TIME_ALT,
    61: POS_ALT_SPEED, 62: TIME_POS_ALT, 63: TIME_POS_ALT_SPEED,
    64: DIST_DIR, 65: POS_DIST_DIR, 66: TIME_DIST_DIR,
    68: POSITION, 69: TIME, 70: POSITION, 71: TIME,
    73: PREDEPARTURE_CLEARANCE,
    74: POSITION, 75: POSITION, 76: TIME_POS, 77: POS_POS, 78: ALT_POS,
    79: POS_ROUTE, 80: ROUTE_CLEARANCE, 81: PROCEDURE_NAME,
    82: DIST_DIR, 83: POS_ROUTE, 84: POS_PROC, 85: ROUTE_CLEARANCE,
    86: POS_ROUTE, 87: POSITION, 88: POS_POS, 89: TIME_POS, 90: ALT_POS,
    91: HOLD_CLEARANCE, 92: POS_ALT, 93: TIME,
    94: DIR_DEG, 95: DIR_DEG, 97: POS_DEG, 98: DIR_DEG,
    99: PROCEDURE_NAME,
    100: TIME_SPEED, 101: POS_SPEED, 102: ALT_SPEED,
    103: TIME_SPEED_SPEED, 104: POS_SPEED_SPEED, 105: ALT_SPEED_SPEED,
    106: SPEED, 108: SPEED, 109: SPEED, 110: SPEED_SPEED,
    111: SPEED, 112: SPEED, 113: SPEED, 114: SPEED, 115: SPEED,
    117: UNIT_FREQ, 118: POS_UNIT_FREQ, 119: TIME_UNIT_FREQ,
    120: UNIT_FREQ, 121: POS_UNIT_FREQ, 122: TIME_UNIT_FREQ,
    123: BEACON_CODE,
    128: ALTITUDE, 129: ALTITUDE, 130: POSITION,
    148: ALTITUDE, 149: ALT_POS, 150: ALT_TIME, 151: SPEED, 152: DIST_DIR,
    153: ALTIMETER, 155: POSITION, 157: FREQUENCY, 158: ATIS_CODE,
    159: ERROR_INFORMATION, 160: FACILITY_DESIGNATION, 163: FACILITY_TP4,
    169: FREE_TEXT, 170: FREE_TEXT,
    171: VERTICAL_RATE, 172: VERTICAL_RATE, 173: VERTICAL_RATE,
    174: VERTICAL_RATE, 175: ALTITUDE,
    180: ALT_ALT, 181: TO_FROM_POS,
}

DM_ARGS: dict[int, Uper] = {
    **{i: _NULL for i in (0, 1, 2, 3, 4, 5, 20, 25, 41, 51, 52, 53, 55, 56,
                          58, 63, 65, 66, 69, 74, 75)},
    6: ALTITUDE, 7: ALT_ALT, 8: ALTITUDE, 9: ALTITUDE, 10: ALTITUDE,
    11: POS_ALT, 12: POS_ALT, 13: TIME_ALT, 14: TIME_ALT,
    15: DIST_DIR, 16: POS_DIST_DIR, 17: TIME_DIST_DIR,
    18: SPEED, 19: SPEED_SPEED,
    21: FREQUENCY, 22: POSITION, 23: PROCEDURE_NAME, 24: ROUTE_CLEARANCE,
    26: POS_ROUTE, 27: DIST_DIR,
    28: ALTITUDE, 29: ALTITUDE, 30: ALTITUDE, 31: POSITION, 32: ALTITUDE,
    33: POSITION, 34: SPEED, 35: DEGREES, 36: DEGREES,
    37: ALTITUDE, 38: ALTITUDE, 39: SPEED, 40: ROUTE_CLEARANCE,
    42: POSITION, 43: TIME, 44: POSITION, 45: POSITION, 46: TIME,
    47: BEACON_CODE, 48: POSITION_REPORT,
    49: SPEED, 50: SPEED_SPEED, 54: ALTITUDE,
    57: FUEL_SOULS,
    59: POS_ROUTE, 60: DIST_DIR, 61: ALTITUDE, 62: ERROR_INFORMATION,
    64: FACILITY_DESIGNATION,
    67: FREE_TEXT, 68: FREE_TEXT,
    70: DEGREES, 71: DEGREES, 72: ALTITUDE, 73: VERSION_NUMBER,
    76: ALT_ALT, 77: ALT_ALT, 78: TIME_DIST_TO_FROM_POS,
    79: ATIS_CODE, 80: DIST_DIR,
}


# --------------------------------------------------------- text rendering

_LEAF_FMT = {
    "feet_qnh": "{} ft", "feet_qfe": "{} ft QFE", "feet_gnss": "{} ft GNSS",
    "meters_qnh": "{} m", "meters_qfe": "{} m QFE",
    "meters_gnss": "{} m GNSS",
    "flight_level": "FL{}", "flight_level_metric": "{} m (metric FL)",
    "indicated_knots": "{} kt IAS", "true_knots": "{} kt TAS",
    "ground_knots": "{} kt GS", "mach": "M{}",
    "speed_ground_knots": "{} kt GS",
    "degrees_magnetic": "{}°M", "degrees_true": "{}°T",
    "nm": "{} nm", "km": "{} km",
    "hf_khz": "{} kHz", "vhf_mhz": "{} MHz", "uhf_mhz": "{} MHz",
    "sat_channel": "SAT {}",
    "inhg": "{} inHg", "hpa": "{} hPa",
    "feet_per_minute": "{} ft/min", "meters_per_minute": "{} m/min",
    "leg_time_minutes": "{} min legs", "leg_distance_nm": "{} nm legs",
    "leg_distance_km": "{} km legs",
    "remaining_souls": "{} souls",
    "hours": None, "minutes": None,         # handled as a pair below
}


def _fmt_latlon(v: dict) -> str:
    def one(part, width):
        d = part["degrees"]
        m = part.get("minutes", 0.0)
        return f"{part['direction'][0].upper()}{d:0{width}d}°{m:05.2f}'"
    return (one(v["latitude"], 2) + " " + one(v["longitude"], 3))


def format_leaves(value) -> list[str]:
    """Flatten a decoded argument into display strings, title order."""
    if isinstance(value, dict):
        if set(value) == {"hours", "minutes"}:
            return [f"{value['hours']:02d}:{value['minutes']:02d}"]
        if set(value) >= {"latitude", "longitude"}:
            return [_fmt_latlon(value)]
        if set(value) == {"facility", "function"}:       # ICAO unit name
            fac = next(iter(value["facility"].values()))
            return [f"{fac} {value['function'].replace('_', ' ').upper()}"]
        out = []
        for k, v in value.items():
            if k in _LEAF_FMT and not isinstance(v, (dict, list)):
                fmt = _LEAF_FMT[k]
                if fmt:
                    out.append(fmt.format(v))
            elif isinstance(v, (dict, list)):
                out.extend(format_leaves(v))
            elif isinstance(v, bool):
                pass
            elif isinstance(v, str):
                out.append(v.replace("_", " ").upper()
                           if k in ("direction", "to_from", "function",
                                    "configuration", "type", "turbulence",
                                    "icing", "tp4_table") else v)
            else:
                out.append(str(v))
        return out
    if isinstance(value, list):
        if all(isinstance(x, int) for x in value):
            return ["".join(str(x) for x in value)]     # beacon code
        out = []
        for x in value:
            out.extend(format_leaves(x))
        return out
    if isinstance(value, bool):
        return []
    if isinstance(value, str):
        return [value.replace("_", " ").upper()]
    return [str(value)]


def render_title(title: str, args) -> str:
    """Substitute decoded argument leaves into a title's [slots]."""
    leaves = format_leaves(args) if args is not None else []
    out, i = [], 0
    pos = 0
    while True:
        lb = title.find("[", pos)
        if lb < 0:
            out.append(title[pos:])
            break
        rb = title.find("]", lb)
        if rb < 0:
            out.append(title[pos:])
            break
        out.append(title[pos:lb])
        out.append(leaves[i] if i < len(leaves) else title[lb:rb + 1])
        i += 1
        pos = rb + 1
    return "".join(out)
