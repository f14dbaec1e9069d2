"""ISU / SSU reassembly for P/T channels and R-channel fragments.

Behavioral equivalents of ISUData (ref: decode/aerol.cpp:123-227), RISUData
(ref: aerol.cpp:8-119) and ACARSDefragmenter (ref: aerol.cpp:229-324).
Pure-Python bookkeeping over 12-byte signal units; runs on the host per
decoded frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ISUItem:
    AESID: int = 0
    GESID: int = 0
    QNO: int = 0
    SEQNO: int = 0
    REFNO: int = 0
    NOOCTLESTINLASTSSU: int = 0
    userdata: bytes = b""
    count: int = 0


@dataclass
class RISUItem(ISUItem):
    SEQINDICATOR: int = 0
    SUTYPE: int = 0
    filledarray: int = 0


class ISUData:
    """Defragments 0x71 initial SUs with their 0xC0 SSU continuations
    (ref: aerol.cpp:123-227).  Items age out after 10 updates."""

    def __init__(self):
        self.items: list[ISUItem] = []
        self.missingssu = False
        # the reference keys SSUs on the AES/GES of the most recent 0x71
        # (member-state carryover, aerol.cpp:192-224) — reproduced here
        self._last_aesid = 0
        self._last_gesid = 0

    def reset(self):
        self.items.clear()

    def _age(self):
        for it in list(self.items):
            it.count += 1
            if it.count > 10:
                self.items.remove(it)

    def update(self, data: bytes):
        """Feed one 10-byte SU body; returns a completed ISUItem or None."""
        self.missingssu = False
        assert len(data) >= 10
        message = data[0]
        if message == 0x71:
            self._age()
            it = ISUItem(
                AESID=data[1] << 16 | data[2] << 8 | data[3],
                GESID=data[4],
                QNO=(data[5] >> 4) & 0x0F,
                REFNO=data[5] & 0x0F,
                SEQNO=data[6] & 0x3F,
                NOOCTLESTINLASTSSU=(data[7] >> 4) & 0x0F,
                userdata=bytes(data[8:10]),
            )
            self._last_aesid, self._last_gesid = it.AESID, it.GESID
            if it.NOOCTLESTINLASTSSU <= 8:
                for i, old in enumerate(self.items):
                    if (old.AESID, old.GESID, old.QNO, old.REFNO) == \
                            (it.AESID, it.GESID, it.QNO, it.REFNO):
                        self.items[i] = it
                        return None
            self.items.append(it)
            return None
        if (message & 0xC0) != 0xC0:
            return None
        seqno = message & 0x3F
        qno = (data[1] >> 4) & 0x0F
        refno = data[1] & 0x0F
        for it in self.items:
            if (it.AESID == self._last_aesid and it.GESID == self._last_gesid
                    and it.SEQNO == seqno + 1 and it.QNO == qno
                    and it.REFNO == refno):
                it.SEQNO -= 1
                if it.SEQNO == 0:
                    it.userdata += bytes(data[2: 2 + it.NOOCTLESTINLASTSSU])
                    self.items.remove(it)
                    return it
                it.userdata += bytes(data[2:10])
                return None
        self.missingssu = True
        return None


_R_SEQ = {1: (1, 0), 2: (2, 0), 3: (2, 1), 4: (3, 0), 5: (3, 1), 6: (3, 2)}


class RISUData:
    """R-channel SU fragment reassembly with a 3-slot bitmap
    (ref: aerol.cpp:8-119)."""

    def __init__(self):
        self.items: list[RISUItem] = []

    def reset(self):
        self.items.clear()

    def _age(self):
        for it in list(self.items):
            it.count += 1
            if it.count > 10:
                self.items.remove(it)

    def update(self, data: bytes):
        self._age()
        b1, b2, b3, b4, b5, b6 = data[0], data[1], data[2], data[3], data[4], data[5]
        it = RISUItem(
            SEQINDICATOR=(b1 & 0xF0) >> 4,
            SUTYPE=b1 & 0x0F,
            QNO=(b2 & 0xF0) >> 4,
            REFNO=b2 & 0x07,
            AESID=b3 << 16 | b4 << 8 | b5,
            GESID=b6,
        )
        if not (1 <= it.SUTYPE <= 11):
            found = None
        else:
            found = next((o for o in self.items
                          if (o.GESID, o.AESID, o.QNO, o.REFNO)
                          == (it.GESID, it.AESID, it.QNO, it.REFNO)), None)
        if found is None:
            self.items.append(it)
            found = it
        found.count = 0

        total, index = _R_SEQ.get(it.SEQINDICATOR, (0, 0))
        bytes_in_su = it.SUTYPE if 1 <= it.SUTYPE <= 11 else 0
        signaling = it.SUTYPE == 15
        thisnum = 11 * total - 11 + bytes_in_su
        ud = bytearray(found.userdata)
        if thisnum > 0:
            if len(ud) == 0:
                ud = bytearray(thisnum)
            elif thisnum < len(ud):
                ud = ud[:thisnum]
        if not signaling:
            seg = data[6: 6 + bytes_in_su]
            start = 11 * index
            ud[start:start + len(seg)] = seg
            found.filledarray |= (1 << index)
        else:
            ud = bytearray()
        found.userdata = bytes(ud)

        done = (signaling
                or (found.filledarray == 7 and total == 3)
                or (found.filledarray == 3 and total == 2)
                or (found.filledarray == 1 and total == 1))
        if done:
            self.items.remove(found)
            return found
        return None


# ---------------------------------------------------------------------------
# TX-side helpers (absent in the reference — used for synthetic test vectors
# and the modulator pipeline)
# ---------------------------------------------------------------------------

def _with_parity(byte: int) -> int:
    """Set bit 7 so the byte has odd parity (ACARS convention)."""
    b = byte & 0x7F
    return b | 0x80 if bin(b).count("1") % 2 == 0 else b


def make_acars_userdata(mode: str, reg: str, tak: str, label: str, bi: str,
                        text: str = "", etb: bool = False) -> bytes:
    """Build ISU userdata bytes for an ACARS message, parity bits included,
    laid out as ParserISU expects (ref: aerol.cpp:358-452)."""
    out = bytearray([0xFF, 0xFF, _with_parity(0x01), _with_parity(ord(mode))])
    for ch in reg.rjust(7, "."):
        out.append(_with_parity(ord(ch)))
    out.append(_with_parity(ord(tak)))
    assert len(label) == 2
    out.append(_with_parity(ord(label[0])))
    out.append(_with_parity(ord(label[1])))
    out.append(_with_parity(ord(bi)))
    if text:
        out.append(_with_parity(0x02))            # STX
        for ch in text:
            out.append(_with_parity(ord(ch)))
        out.append(_with_parity(0x97 if etb else 0x83))  # ETB/ETX
    else:
        out.append(_with_parity(0x83))
    out += bytes([0x93, 0xAB])                    # BSC (no parity)
    out.append(_with_parity(0x7F))                # DEL
    return bytes(out)


def segment_isu(userdata: bytes, aesid: int, gesid: int, qno: int = 0,
                refno: int = 0) -> list[bytes]:
    """Split userdata into one 0x71 initial SU + 0xC0 SSUs (10-byte bodies,
    CRC not yet appended) such that ISUData.update reassembles it."""
    n = len(userdata)
    nssu = max(0, -(-(n - 2) // 8))
    nooct = n - 2 - 8 * (nssu - 1) if nssu else 0
    sus = [bytes([0x71,
                  (aesid >> 16) & 0xFF, (aesid >> 8) & 0xFF, aesid & 0xFF,
                  gesid, ((qno & 0xF) << 4) | (refno & 0xF),
                  nssu & 0x3F, (nooct & 0xF) << 4]) + userdata[:2]]
    pos = 2
    for k in range(nssu):
        seq = nssu - 1 - k
        chunk = userdata[pos: pos + 8]
        pos += len(chunk)
        body = bytes([0xC0 | seq, ((qno & 0xF) << 4) | (refno & 0xF)]) + chunk
        sus.append(body.ljust(10, b"\x00"))
    return sus


@dataclass
class ACARSItem:
    isuitem: ISUItem = field(default_factory=ISUItem)
    MODE: int = 0
    TAK: int = 0
    LABEL: bytes = b""
    BI: int = 0
    PLANEREG: bytes = b""
    nonacars: bool = False
    downlink: bool = False
    valid: bool = False
    hastext: bool = False
    moretocome: bool = False
    message: str = ""
    parsed: dict = field(default_factory=dict)
    dbinfo: dict = field(default_factory=dict)   # aircraft DB row, if found


class ACARSDefragmenter:
    """Multi-ISU ACARS continuation by block-id increment
    (BI+1-'A') % 26 + 'A', age-out 30 (ref: aerol.cpp:229-324)."""

    def __init__(self):
        self.frags: list[list] = []  # [item, count]

    def defragment(self, item: ACARSItem) -> bool:
        """Returns True when ``item`` (possibly merged in place) is complete."""
        for fr in list(self.frags):
            fr[1] += 1
            if fr[1] > 30:
                self.frags.remove(fr)

        idx = -1
        for i, (old, _) in enumerate(self.frags):
            if (item.PLANEREG == old.PLANEREG and item.LABEL == old.LABEL
                    and item.MODE == old.MODE
                    and item.isuitem.AESID == old.isuitem.AESID
                    and item.isuitem.GESID == old.isuitem.GESID
                    and old.moretocome):
                if item.TAK != old.TAK:
                    continue
                if ((old.BI + 1 - ord("A")) % 26) + ord("A") == item.BI:
                    idx = i
                    break
        if idx < 0:
            if not item.moretocome:
                return True
            self.frags.append([item, 0])
            return False
        old, _ = self.frags[idx]
        self.frags[idx][1] = 0
        old.BI = item.BI
        old.message += item.message
        old.moretocome = item.moretocome
        if item.moretocome:
            return False
        item.__dict__.update(old.__dict__)
        self.frags.pop(idx)
        return True
