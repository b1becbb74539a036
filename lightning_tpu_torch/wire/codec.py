"""Declarative BOLT wire codec framework.

The reference generates per-message towire_*/fromwire_* C functions from
CSV specs (tools/generate-wire.py over wire/peer_wire.csv etc.).  Here the
single source of truth is a declarative Python spec per message; codecs
are derived at class-definition time.  Same idea — spec-driven codec —
without code generation, since Python can build codecs at runtime.
The port's own copy of the JAX package's wire/codec.py: its registry
holds the same types under the same names.

Field kinds:
  u8/u16/u32/u64          big-endian integers
  tu16/tu32/tu64          truncated integers (TLV payloads)
  bigsize                 BOLT#1 variable-length integer
  bytes:N                 fixed N raw bytes
  varbytes                u16 length-prefixed bytes
  remainder               all remaining bytes
  point                   33-byte compressed pubkey
  signature               64-byte compact sig
  chain_hash/sha256       32 raw bytes
  short_channel_id        u64
  array:L:E               count-prefixed array: L in {u8,u16,bigsize} is
                          the count encoding, E any fixed-size kind;
                          value is a list (e.g. commitment_signed's
                          htlc_signatures = array:u16:signature)
  tlvs                    trailing TLV stream (dict {type: raw bytes})
"""
from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field as dc_field
from typing import Any


class WireError(Exception):
    pass


def write_bigsize(n: int) -> bytes:
    if n < 0xFD:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfd" + n.to_bytes(2, "big")
    if n <= 0xFFFFFFFF:
        return b"\xfe" + n.to_bytes(4, "big")
    return b"\xff" + n.to_bytes(8, "big")


def read_bigsize(buf: bytes, off: int) -> tuple[int, int]:
    if off >= len(buf):
        raise WireError("truncated bigsize")
    b0 = buf[off]
    if b0 < 0xFD:
        return b0, off + 1
    size = {0xFD: 2, 0xFE: 4, 0xFF: 8}[b0]
    if off + 1 + size > len(buf):
        raise WireError("truncated bigsize")
    val = int.from_bytes(buf[off + 1 : off + 1 + size], "big")
    # canonical-encoding check (BOLT#1: minimal encodings only)
    if val < {2: 0xFD, 4: 0x10000, 8: 0x100000000}[size]:
        raise WireError("non-minimal bigsize")
    return val, off + 1 + size


def write_tu(n: int, maxbytes: int) -> bytes:
    out = n.to_bytes(maxbytes, "big").lstrip(b"\x00")
    return out


def read_tu(buf: bytes, maxbytes: int) -> int:
    if len(buf) > maxbytes:
        raise WireError("truncated int too long")
    if buf and buf[0] == 0:
        raise WireError("non-minimal truncated int")
    return int.from_bytes(buf, "big")


def write_tlv_stream(tlvs: dict[int, bytes]) -> bytes:
    out = b""
    for t in sorted(tlvs):
        v = tlvs[t]
        out += write_bigsize(t) + write_bigsize(len(v)) + v
    return out


def read_tlv_stream(buf: bytes, off: int = 0) -> dict[int, bytes]:
    out: dict[int, bytes] = {}
    last_t = -1
    while off < len(buf):
        t, off = read_bigsize(buf, off)
        if t <= last_t:
            raise WireError("TLV types not strictly increasing")
        last_t = t
        ln, off = read_bigsize(buf, off)
        if off + ln > len(buf):
            raise WireError("truncated TLV value")
        out[t] = buf[off : off + ln]
        off += ln
    return out


_INT_FMT = {"u8": ">B", "u16": ">H", "u32": ">I", "u64": ">Q", "s64": ">q"}
_FIXED_LEN = {"point": 33, "signature": 64, "chain_hash": 32, "sha256": 32}


def _write_count(kind: str, n: int) -> bytes:
    if kind == "bigsize":
        return write_bigsize(n)
    return struct.pack(_INT_FMT[kind], n)


def _read_count(kind: str, buf: bytes, off: int) -> tuple[int, int]:
    if kind == "bigsize":
        return read_bigsize(buf, off)
    sz = struct.calcsize(_INT_FMT[kind])
    if off + sz > len(buf):
        raise WireError("truncated array count")
    return struct.unpack_from(_INT_FMT[kind], buf, off)[0], off + sz


@dataclass(frozen=True)
class FieldSpec:
    name: str
    kind: str  # one of the kinds above; "bytes:N" for fixed raw

    @property
    def fixed_bytes(self) -> int | None:
        if self.kind in _INT_FMT:
            return struct.calcsize(_INT_FMT[self.kind])
        if self.kind in _FIXED_LEN:
            return _FIXED_LEN[self.kind]
        if self.kind.startswith("bytes:"):
            return int(self.kind.split(":")[1])
        if self.kind == "short_channel_id":
            return 8
        return None

    @functools.cached_property
    def array_parts(self) -> tuple[str, "FieldSpec"] | None:
        """For array:L:E kinds: (count_kind, element FieldSpec)."""
        if not self.kind.startswith("array:"):
            return None
        _, lk, ek = self.kind.split(":", 2)
        if lk not in ("u8", "u16", "bigsize"):
            raise TypeError(f"{self.name}: bad array count kind {lk}")
        elem = FieldSpec(self.name + "[]", ek)
        if elem.fixed_bytes is None:
            raise TypeError(f"{self.name}: array element {ek} not fixed-size")
        return lk, elem


class MessageMeta(type):
    registry: dict[int, type] = {}

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        if ns.get("TYPE") is not None and ns.get("FIELDS") is not None:
            cls.FIELDS = [FieldSpec(n, k) for n, k in ns["FIELDS"]]
            # tu*/remainder/tlvs consume the rest of the message on parse,
            # so they are only well-defined as the final field
            for f in cls.FIELDS[:-1]:
                if f.kind.startswith("tu") or f.kind in ("remainder", "tlvs"):
                    raise TypeError(
                        f"{name}.{f.name}: kind {f.kind} must be the last field"
                    )
            for f in cls.FIELDS:
                f.array_parts  # validates (and caches) array:L:E specs now
            MessageMeta.registry[ns["TYPE"]] = cls
        return cls


class Message(metaclass=MessageMeta):
    """Base for spec-declared wire messages."""

    TYPE: int | None = None
    FIELDS: list | None = None

    def __init__(self, **kwargs):
        for f in self.FIELDS:
            setattr(self, f.name, kwargs.pop(f.name, self._default(f)))
        if kwargs:
            raise TypeError(f"unknown fields {list(kwargs)} for {type(self).__name__}")

    @staticmethod
    def _default(f: FieldSpec):
        if f.kind in _INT_FMT or f.kind in ("bigsize", "short_channel_id") or f.kind.startswith("tu"):
            return 0
        if f.kind == "tlvs":
            return {}
        if f.kind.startswith("array:"):
            return []
        n = f.fixed_bytes
        return b"\x00" * n if n is not None and f.kind not in _INT_FMT else b""

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS
        )

    def __repr__(self):
        args = ", ".join(f"{f.name}={getattr(self, f.name)!r}" for f in self.FIELDS)
        return f"{type(self).__name__}({args})"

    def serialize(self) -> bytes:
        out = [struct.pack(">H", self.TYPE)]
        for f in self.FIELDS:
            v = getattr(self, f.name)
            k = f.kind
            if k in _INT_FMT:
                out.append(struct.pack(_INT_FMT[k], v))
            elif k == "short_channel_id":
                out.append(struct.pack(">Q", v))
            elif k == "bigsize":
                out.append(write_bigsize(v))
            elif k in _FIXED_LEN or k.startswith("bytes:"):
                n = f.fixed_bytes
                if len(v) != n:
                    raise WireError(f"{f.name}: need {n} bytes, got {len(v)}")
                out.append(v)
            elif k == "varbytes":
                out.append(struct.pack(">H", len(v)) + v)
            elif k.startswith("array:"):
                lk, elem = f.array_parts
                out.append(_write_count(lk, len(v)))
                for item in v:
                    if elem.kind in _INT_FMT:
                        out.append(struct.pack(_INT_FMT[elem.kind], item))
                    else:
                        if len(item) != elem.fixed_bytes:
                            raise WireError(
                                f"{f.name}: element needs {elem.fixed_bytes}"
                                f" bytes, got {len(item)}"
                            )
                        out.append(item)
            elif k == "remainder":
                out.append(v)
            elif k in ("tu16", "tu32", "tu64"):
                # truncated int: minimal big-endian, must be last field
                # (BOLT#1 TLV payloads)
                out.append(write_tu(v, int(k[2:]) // 8))
            elif k == "tlvs":
                out.append(write_tlv_stream(v))
            else:
                raise WireError(f"unknown field kind {k}")
        return b"".join(out)

    @classmethod
    def parse(cls, msg: bytes):
        (t,) = struct.unpack_from(">H", msg, 0)
        if t != cls.TYPE:
            raise WireError(f"wrong type {t} for {cls.__name__}")
        off = 2
        vals: dict[str, Any] = {}
        for f in cls.FIELDS:
            k = f.kind
            if k in _INT_FMT:
                n = f.fixed_bytes
                if off + n > len(msg):
                    raise WireError(f"truncated at {f.name}")
                (vals[f.name],) = struct.unpack_from(_INT_FMT[k], msg, off)
                off += n
            elif k == "short_channel_id":
                (vals[f.name],) = struct.unpack_from(">Q", msg, off)
                off += 8
            elif k == "bigsize":
                vals[f.name], off = read_bigsize(msg, off)
            elif k in _FIXED_LEN or k.startswith("bytes:"):
                n = f.fixed_bytes
                if off + n > len(msg):
                    raise WireError(f"truncated at {f.name}")
                vals[f.name] = msg[off : off + n]
                off += n
            elif k == "varbytes":
                if off + 2 > len(msg):
                    raise WireError(f"truncated at {f.name}")
                (ln,) = struct.unpack_from(">H", msg, off)
                off += 2
                if off + ln > len(msg):
                    raise WireError(f"truncated at {f.name}")
                vals[f.name] = msg[off : off + ln]
                off += ln
            elif k.startswith("array:"):
                lk, elem = f.array_parts
                cnt, off = _read_count(lk, msg, off)
                esz = elem.fixed_bytes
                if off + cnt * esz > len(msg):
                    raise WireError(f"truncated at {f.name}")
                items = []
                for _ in range(cnt):
                    raw = msg[off : off + esz]
                    if elem.kind in _INT_FMT:
                        items.append(
                            struct.unpack(_INT_FMT[elem.kind], raw)[0]
                        )
                    else:
                        items.append(raw)
                    off += esz
                vals[f.name] = items
            elif k == "remainder":
                vals[f.name] = msg[off:]
                off = len(msg)
            elif k in ("tu16", "tu32", "tu64"):
                vals[f.name] = read_tu(msg[off:], int(k[2:]) // 8)
                off = len(msg)
            elif k == "tlvs":
                vals[f.name] = read_tlv_stream(msg, off)
                off = len(msg)
            else:
                raise WireError(f"unknown field kind {k}")
        if off != len(msg) and not any(f.kind in ("remainder", "tlvs") for f in cls.FIELDS):
            # BOLT#1: additional data in messages is allowed (ignore)
            pass
        return cls(**vals)


def parse_message(msg: bytes):
    """Parse any registered message type; returns (cls instance) or raises
    WireError for unknown types (caller decides odd/even rule)."""
    if len(msg) < 2:
        raise WireError("no type")
    (t,) = struct.unpack_from(">H", msg, 0)
    cls = MessageMeta.registry.get(t)
    if cls is None:
        raise WireError(f"unknown message type {t}")
    return cls.parse(msg)


def msg_type(msg: bytes) -> int:
    if len(msg) < 2:
        raise WireError("no type")
    return struct.unpack_from(">H", msg, 0)[0]
