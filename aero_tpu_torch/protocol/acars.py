"""ACARS parsing from reassembled ISU userdata.

Behavioral equivalent of ParserISU (ref: decode/aerol.cpp:326-489): per-byte
odd-parity check and strip (256-entry tables through ``bytes.translate``),
ACARS pattern gate (FF FF .. STX/ETX), MODE / TAK / LABEL / BI /
tail-number extraction, <DEL> substitution, fragment defragmentation.
Non-ACARS SUs are reported as upper-case hex with ``nonacars=True``.
"""

from __future__ import annotations

from typing import Callable

from aero_tpu_torch.protocol.isu import ACARSItem, ACARSDefragmenter, ISUItem


# by byte value: 1 where the 8th bit makes the byte odd-parity (ref:
# aerol.cpp:343-356), so that ``0 in seg.translate(ODD)`` finds a parity
# error in ``seg``; and the byte with its parity bit stripped
ODD = bytes(bin(b).count("1") & 1 for b in range(256))
STRIP = bytes(b & 0x7F for b in range(256))


class ParserISU:
    """Parses ISU userdata into ACARSItems.

    ``on_acars(item)`` fires for complete (defragmented) messages;
    ``on_fragment(item)`` for every valid ACARS ISU before reassembly;
    ``on_error(str)`` for parity/validation failures.
    """

    def __init__(self, on_acars: Callable | None = None,
                 on_fragment: Callable | None = None,
                 on_error: Callable | None = None,
                 db=None):
        self.downlink = False
        self.defrag = ACARSDefragmenter()
        self.on_acars = on_acars or (lambda item: None)
        self.on_fragment = on_fragment or (lambda item: None)
        self.on_error = on_error or (lambda msg: None)
        # aircraft-registration lookup before final emission
        # (ref aerol.cpp:460-524 dbtu->request -> acarslookupresult;
        # stubbed there, a working CSV impl here — protocol/database.py)
        self.db = db

    def parse(self, isuitem: ISUItem) -> bool:
        if isuitem.AESID == 0:
            self.on_error("Error: AESID == 0")
            return False
        ud = bytes(isuitem.userdata)
        textish = ud.translate(STRIP)

        isacars = (len(ud) > 16 and ud[0] == 0xFF and ud[1] == 0xFF
                   and (ud[15] == 0x83 or ud[15] == 0x02))

        item = ACARSItem()
        item.downlink = self.downlink
        item.isuitem = isuitem

        if not isacars:
            item.message = ud.hex().upper()
            item.nonacars = True
            item.valid = True
            item.PLANEREG = _strip_dots(item.PLANEREG)
            self.on_acars(item)
            return True

        item.MODE = ud[3] & 0x7F
        item.TAK = textish[11]
        item.LABEL = textish[12:14]
        item.BI = textish[14]
        item.hastext = ud[15] == 0x02
        if ud[len(ud) - 1 - 3] == 0x97:
            item.moretocome = True
        if 0 in ud[4:4 + 7].translate(ODD):
            self.on_error(
                f"ISU: AESID = {isuitem.AESID:X} GESID = {isuitem.GESID:X} "
                f"QNO = {isuitem.QNO:02X} REFNO = {isuitem.REFNO:02X} : "
                f"Parity error")
            return False
        item.PLANEREG = textish[4:4 + 7]

        if item.hastext:
            end = len(ud) - 1 - 3
            if 0 in ud[16:end].translate(ODD):
                self.on_error(
                    f"ISU: AESID = {isuitem.AESID:X} GESID = "
                    f"{isuitem.GESID:X} QNO = {isuitem.QNO:02X} REFNO = "
                    f"{isuitem.REFNO:02X} : Parity error")
                return False
            item.message = textish[16:end].decode("latin-1").replace(
                "\x7f", "<DEL>")

        item.valid = True
        self.on_fragment(item)
        if self.defrag.defragment(item):
            item.PLANEREG = _strip_dots(item.PLANEREG)
            if self.db is not None:
                from aero_tpu_torch.protocol.database import DATABASE_SCHEMA
                row = self.db.lookup(f"{isuitem.AESID:06X}")
                if row:
                    item.dbinfo = dict(zip(DATABASE_SCHEMA, row))
            self.on_acars(item)
        return True


def _strip_dots(reg: bytes) -> bytes:
    """Remove leading '.' padding from the tail number
    (ref: aerol.cpp:497-503)."""
    i = 0
    while i < len(reg) and reg[i: i + 1] == b".":
        i += 1
    return reg[i:]
