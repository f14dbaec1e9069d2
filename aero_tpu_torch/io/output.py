"""Output formatting: jsondump (airframes.io style), jaero-compatible JSON,
and one-line text.

Behavioral equivalent of toOutputFormat (ref: decode/output.cpp:12-171).
"""

from __future__ import annotations

import json
import time
from datetime import datetime, timezone

from aero_tpu_torch.protocol.isu import ACARSItem

APP_NAME = "aero-tpu"
APP_VERSION = "0.1.0"


def _tak_str(tak: int) -> str:
    return "!" if tak == 0x15 else chr(tak)


def _label_str(label: bytes) -> str:
    l0 = chr(label[0]) if len(label) > 0 else " "
    l1 = " "
    if len(label) > 1:
        l1 = "d" if label[1] == 127 else chr(label[1])
    return l0 + l1


def _clean_message(message: str) -> str:
    m = message.replace("\r", "\n").replace("\n\n", "\n")
    if m.endswith("\n"):
        m = m[:-1]
    if m.startswith("\n"):
        m = m[1:]
    return m.replace("\n", "\n\t")


def to_output_format(fmt: str, station_id: str, disable_reassembly: bool,
                     item: ACARSItem, now: float | None = None) -> str:
    """fmt in {'jsondump', 'jaero', 'text'} (ref: decode/output.h)."""
    t = now if now is not None else time.time()
    dt = datetime.fromtimestamp(t, tz=timezone.utc)

    if fmt in ("jsondump", "jaero"):
        message = _clean_message(item.message)
        if fmt == "jsondump":
            root: dict = {
                "app": {"name": APP_NAME, "ver": APP_VERSION},
            }
            aes = {"type": "Aircraft Earth Station",
                   "addr": f"{item.isuitem.AESID:06X}"}
            ges = {"type": "Ground Earth Station",
                   "addr": f"{item.isuitem.GESID:02X}"}
            isu: dict = {}
            if not item.nonacars:
                acars: dict = {
                    "mode": chr(item.MODE),
                    "ack": _tak_str(item.TAK),
                    "blk_id": chr(item.BI),
                    "label": _label_str(item.LABEL),
                    "reg": item.PLANEREG.decode("latin-1"),
                }
                if message:
                    if item.downlink:
                        acars["msg_num"] = message[0:3]
                        acars["msg_num_seq"] = message[3:4]
                        acars["flight"] = message[4:10]
                        acars["msg_text"] = message[10:]
                    else:
                        acars["msg_text"] = message
                    acars.update(item.parsed)
                isu["acars"] = acars
            isu["refno"] = f"{item.isuitem.REFNO:02X}"
            isu["qno"] = f"{item.isuitem.QNO:02X}"
            isu["src"] = aes if item.downlink else ges
            isu["dst"] = ges if item.downlink else aes
            if item.dbinfo:
                # aircraft-DB enrichment (schema: protocol/database.py;
                # absent when no DB is configured — wire-compatible)
                root["aircraft"] = item.dbinfo
            root["t"] = {"sec": int(t), "usec": int((t % 1) * 1e6) // 1000 * 1000}
            root["isu"] = isu
            root["station"] = station_id
            return json.dumps(root, separators=(",", ":"))
        root = {
            "TIME": int(t),
            "TIME_UTC": dt.strftime("%Y-%m-%d %H:%M:%S"),
            "NAME": APP_NAME,
            "NONACARS": item.nonacars,
            "AESID": f"{item.isuitem.AESID:06X}",
            "GESID": f"{item.isuitem.GESID:02X}",
            "QNO": f"{item.isuitem.QNO:02X}",
            "REFNO": f"{item.isuitem.REFNO:02X}",
            "REG": item.PLANEREG.decode("latin-1"),
        }
        if not item.nonacars:
            root["MODE"] = chr(item.MODE)
            root["TAK"] = _tak_str(item.TAK)
            root["LABEL"] = _label_str(item.LABEL)
            root["BI"] = chr(item.BI)
        return json.dumps(root, separators=(",", ":"))

    if fmt == "text":
        message = (item.message.replace("\n", "\\n").replace("\r", "\\r")
                   .replace("\t", "\\t").replace("\a", "\\a"))
        out = (f"{dt.strftime('%Y-%m-%dT%H:%M:%SZ')} "
               f"AES:{item.isuitem.AESID:06X} GES:{item.isuitem.GESID:06X}")
        if not item.nonacars:
            reg = item.PLANEREG.decode("latin-1")
            out += (f" [{reg:>7}] ACK={_tak_str(item.TAK):1} "
                    f"BLK={chr(item.BI)} ")
            if disable_reassembly:
                out += f"M={'1' if item.moretocome else '0'} "
            out += f"LBL={_label_str(item.LABEL)} "
            if message:
                if item.downlink:
                    out += (f"MSN={message[0:4]} FLT={message[4:10]} "
                            f"{message[10:]}")
                else:
                    out += message
        return out

    raise ValueError(f"unknown output format {fmt!r}")
