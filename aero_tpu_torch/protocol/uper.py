"""Minimal ASN.1 unaligned-PER (UPER) codec combinators.

The reference delegates CPDLC payload decoding to libacars, which runs
asn1c-generated UPER decoders over the FANS-1/A module (ref:
decode/decode.cpp:50-58).  aero-tpu decodes natively; this module is the
hand-rolled equivalent of the asn1c runtime: a small set of composable
type objects, each with ``dec(BitReader) -> value`` and
``enc(BitWriter, value)``, covering exactly the UPER subset the FANS-1/A
module uses (no extensibility markers, constrained ranges <= 16 bits of
field width after unit choice):

  - constrained INTEGER  -> minimal-width bit field, offset from lower
    bound, optional display scaling
  - ENUMERATED           -> index bit field, decoded to the name
  - NULL                 -> zero bits
  - SEQUENCE             -> leading presence bit per OPTIONAL field,
    fields in order; decodes to a dict (absent optionals omitted)
  - CHOICE               -> index bit field + chosen alternative;
    decodes to a single-key dict {alt_name: value}
  - SEQUENCE OF          -> (count - lo) bit field + elements
  - IA5String            -> (len - lo) bit field (absent when fixed
    size) + 7-bit characters
  - NumericString        -> same but 4-bit characters over " 0123456789"

Values are plain JSON-able Python (dict/list/str/int/float) so decoded
messages drop straight into ``ACARSItem.parsed``.  Every combinator is
its own inverse: ``dec(enc(v)) == v`` is the round-trip oracle used by
tests/test_acars_apps.py (like the reference, we have no on-air oracle
in this environment).  Host-side per-frame bookkeeping, never on device.
"""

from __future__ import annotations

from .bitio import BitReader, BitWriter


def _width(n_values: int) -> int:
    """Bits needed to index ``n_values`` values (0 when only one)."""
    return max(0, (n_values - 1).bit_length())


class Uper:
    """Base combinator: subclasses implement dec/enc."""

    def dec(self, r: BitReader):
        raise NotImplementedError

    def enc(self, w: BitWriter, v) -> None:
        raise NotImplementedError


class NULL(Uper):
    def dec(self, r):
        return True                         # presence marker in dicts

    def enc(self, w, v):
        pass


class INT(Uper):
    """Constrained INTEGER (lo..hi), optional display scale.

    With ``scale`` the decoded value is ``raw * scale`` (float when the
    scale is fractional); encode divides and rounds back.
    """

    def __init__(self, lo: int, hi: int, scale: float = 1):
        self.lo, self.hi, self.scale = lo, hi, scale
        self.nbits = _width(hi - lo + 1)

    def dec(self, r):
        raw = self.lo + r.read(self.nbits)
        if raw > self.hi:
            raise ValueError(f"INTEGER out of range: {raw} > {self.hi}")
        if self.scale == 1:
            return raw
        v = raw * self.scale
        return round(v, 10) if isinstance(v, float) else v

    def enc(self, w, v):
        raw = int(round(v / self.scale)) if self.scale != 1 else int(v)
        if not (self.lo <= raw <= self.hi):
            raise ValueError(f"INTEGER {raw} outside ({self.lo}..{self.hi})")
        w.write(raw - self.lo, self.nbits)


class ENUM(Uper):
    def __init__(self, *names: str):
        self.names = names
        self.nbits = _width(len(names))

    def dec(self, r):
        i = r.read(self.nbits)
        if i >= len(self.names):
            raise ValueError(f"ENUMERATED index {i} out of range")
        return self.names[i]

    def enc(self, w, v):
        w.write(self.names.index(v), self.nbits)


class SEQ(Uper):
    """SEQUENCE of (name, type[, optional]) fields -> dict."""

    def __init__(self, *fields):
        self.fields = [(f[0], f[1], len(f) > 2 and f[2]) for f in fields]
        self.n_opt = sum(1 for _, _, o in self.fields if o)

    def dec(self, r):
        present = {}
        for name, _, opt in self.fields:
            present[name] = (not opt) or bool(r.read(1))
        out = {}
        for name, typ, _ in self.fields:
            if present[name]:
                out[name] = typ.dec(r)
        return out

    def enc(self, w, v):
        for name, _, opt in self.fields:
            if opt:
                w.write(1 if name in v else 0, 1)
            elif name not in v:
                raise ValueError(f"missing required field {name!r}")
        for name, typ, _ in self.fields:
            if name in v:
                typ.enc(w, v[name])


class CHOICE(Uper):
    """CHOICE of (name, type) alternatives -> {name: value}."""

    def __init__(self, *alts):
        self.alts = alts
        self.nbits = _width(len(alts))

    def dec(self, r):
        i = r.read(self.nbits)
        if i >= len(self.alts):
            raise ValueError(f"CHOICE index {i} out of range")
        name, typ = self.alts[i]
        return {name: typ.dec(r)}

    def enc(self, w, v):
        (name, value), = v.items()
        for i, (n, typ) in enumerate(self.alts):
            if n == name:
                w.write(i, self.nbits)
                typ.enc(w, value)
                return
        raise ValueError(f"unknown CHOICE alternative {name!r}")


class SEQOF(Uper):
    def __init__(self, lo: int, hi: int, typ: Uper):
        self.lo, self.hi, self.typ = lo, hi, typ
        self.nbits = _width(hi - lo + 1)

    def dec(self, r):
        n = self.lo + r.read(self.nbits)
        if n > self.hi:
            raise ValueError(f"SEQUENCE OF count {n} > {self.hi}")
        return [self.typ.dec(r) for _ in range(n)]

    def enc(self, w, v):
        if not (self.lo <= len(v) <= self.hi):
            raise ValueError(f"SEQUENCE OF count {len(v)} outside range")
        w.write(len(v) - self.lo, self.nbits)
        for item in v:
            self.typ.enc(w, item)


class _String(Uper):
    CHAR_BITS = 7
    ALPHABET: str | None = None             # None = raw IA5 code points

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self.len_bits = _width(hi - lo + 1)

    def dec(self, r):
        n = self.lo + r.read(self.len_bits)
        if n > self.hi:
            raise ValueError(f"string length {n} > {self.hi}")
        if self.ALPHABET is None:
            return "".join(chr(r.read(self.CHAR_BITS)) for _ in range(n))
        return "".join(self.ALPHABET[r.read(self.CHAR_BITS)]
                       for _ in range(n))

    def enc(self, w, v):
        if not (self.lo <= len(v) <= self.hi):
            raise ValueError(f"string length {len(v)} outside range")
        w.write(len(v) - self.lo, self.len_bits)
        for ch in v:
            code = (ord(ch) & 0x7F if self.ALPHABET is None
                    else self.ALPHABET.index(ch))
            w.write(code, self.CHAR_BITS)


class IA5(_String):
    pass


class NUMSTR(_String):
    CHAR_BITS = 4
    ALPHABET = " 0123456789"
