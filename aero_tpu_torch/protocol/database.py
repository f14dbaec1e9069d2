"""Aircraft-registration database lookup (stub, like the reference).

The reference deliberately stubbed JAERO's aircraft DB out
(ref: decode/databasetext.cpp:42-61 — request() always answers "not found";
its README TODO says "Cut out plane registration database code").  The
schema enum is retained (ref: decode/databasetext.h:36-44) and the hook is
still called before the final ACARS emission so a real DB can be dropped in.
"""

from __future__ import annotations

from typing import Callable

DATABASE_SCHEMA = (
    "ICAO24", "Registration", "Manufacturer", "ICAOTypeCode", "Type",
    "RegisteredOwners",
)


class DataBaseTextUser:
    """Async-lookalike lookup; the stub answers immediately and empty."""

    def __init__(self, on_result: Callable | None = None):
        self.on_result = on_result or (lambda ok, ref, result: None)
        self._refcount = 0
        self._userdata = {}

    def lookup(self, aes_hex: str) -> list | None:
        """Synchronous form used by the parser; stub: never found."""
        return None

    def request(self, dirname: str, aes_hex: str, userdata=None) -> int:
        self._refcount += 1
        ref = self._refcount
        self._userdata[ref] = userdata
        row = self.lookup(aes_hex)
        self.on_result(row is not None, ref, row or [])
        return ref

    def get_userdata(self, ref: int):
        return self._userdata.pop(ref, None)


class DataBaseCSVUser(DataBaseTextUser):
    """Working lookup over a CSV keyed by ICAO24 hex — the capability the
    reference cut out (its README TODO) restored as an opt-in.

    CSV columns follow DATABASE_SCHEMA:
        ICAO24,Registration,Manufacturer,ICAOTypeCode,Type,RegisteredOwners
    (the common BaseStation.sqb CSV export shape).  A header line is
    skipped automatically; short rows are padded with empty strings.
    """

    def __init__(self, path: str, on_result: Callable | None = None):
        super().__init__(on_result)
        import csv

        self._rows: dict[str, list[str]] = {}
        with open(path, newline="") as f:
            for rec in csv.reader(f):
                if not rec or rec[0].strip().upper() in ("", "ICAO24"):
                    continue
                key = rec[0].strip().upper().lstrip("0") or "0"
                row = [c.strip() for c in rec[: len(DATABASE_SCHEMA)]]
                row += [""] * (len(DATABASE_SCHEMA) - len(row))
                self._rows[key] = row

    def __len__(self) -> int:
        return len(self._rows)

    def lookup(self, aes_hex: str) -> list | None:
        return self._rows.get(aes_hex.strip().upper().lstrip("0") or "0")
