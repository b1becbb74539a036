"""Minimal Bitcoin transaction model: segwit serialization, txid, and
BIP143 sighash — the subset Lightning channel machinery needs (the
reference uses libwally for this; see bitcoin/tx.c and
bitcoin/signature.c:120 bitcoin_tx_hash_for_sig).
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

SIGHASH_ALL = 1
SIGHASH_NONE = 2
SIGHASH_SINGLE = 3
SIGHASH_ANYONECANPAY = 0x80
# BOLT#3 option_anchors: counterparty HTLC-tx signatures commit to only
# their own input/output so fees can be bumped later
SIGHASH_SINGLE_ANYONECANPAY = SIGHASH_SINGLE | SIGHASH_ANYONECANPAY


def sha256d(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def write_varint(n: int) -> bytes:
    if n < 0xFD:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfd" + struct.pack("<H", n)
    if n <= 0xFFFFFFFF:
        return b"\xfe" + struct.pack("<I", n)
    return b"\xff" + struct.pack("<Q", n)


def read_varint(buf: bytes, off: int) -> tuple[int, int]:
    b0 = buf[off]
    if b0 < 0xFD:
        return b0, off + 1
    if b0 == 0xFD:
        return struct.unpack_from("<H", buf, off + 1)[0], off + 3
    if b0 == 0xFE:
        return struct.unpack_from("<I", buf, off + 1)[0], off + 5
    return struct.unpack_from("<Q", buf, off + 1)[0], off + 9


@dataclass
class TxInput:
    txid: bytes  # 32 bytes, "display order" (big-endian hex order)
    vout: int
    script_sig: bytes = b""
    sequence: int = 0xFFFFFFFF
    witness: list = field(default_factory=list)

    def serialize(self) -> bytes:
        return (
            self.txid[::-1]
            + struct.pack("<I", self.vout)
            + write_varint(len(self.script_sig))
            + self.script_sig
            + struct.pack("<I", self.sequence)
        )

    @property
    def outpoint(self) -> bytes:
        return self.txid[::-1] + struct.pack("<I", self.vout)


@dataclass
class TxOutput:
    amount_sat: int
    script_pubkey: bytes

    def serialize(self) -> bytes:
        return (
            struct.pack("<q", self.amount_sat)
            + write_varint(len(self.script_pubkey))
            + self.script_pubkey
        )


@dataclass
class Tx:
    version: int = 2
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    locktime: int = 0

    def has_witness(self) -> bool:
        return any(i.witness for i in self.inputs)

    def serialize(self, include_witness: bool = True) -> bytes:
        wit = include_witness and self.has_witness()
        out = struct.pack("<i", self.version)
        if wit:
            out += b"\x00\x01"
        out += write_varint(len(self.inputs))
        for i in self.inputs:
            out += i.serialize()
        out += write_varint(len(self.outputs))
        for o in self.outputs:
            out += o.serialize()
        if wit:
            for i in self.inputs:
                out += write_varint(len(i.witness))
                for item in i.witness:
                    out += write_varint(len(item)) + item
        out += struct.pack("<I", self.locktime)
        return out

    def txid(self) -> bytes:
        """Display-order (big-endian) txid."""
        return sha256d(self.serialize(include_witness=False))[::-1]

    def wtxid(self) -> bytes:
        return sha256d(self.serialize())[::-1]

    def weight(self) -> int:
        base = len(self.serialize(include_witness=False))
        total = len(self.serialize())
        return base * 3 + total

    @classmethod
    def parse(cls, raw: bytes) -> "Tx":
        return cls.parse_from(raw, 0)[0]

    @classmethod
    def parse_from(cls, raw: bytes, off: int) -> tuple["Tx", int]:
        """Parse one tx starting at `off`; returns (tx, next_offset) —
        used for block bodies (chain/backend.py)."""
        (version,) = struct.unpack_from("<i", raw, off)
        off += 4
        has_wit = raw[off] == 0 and raw[off + 1] == 1
        if has_wit:
            off += 2
        n_in, off = read_varint(raw, off)
        inputs = []
        for _ in range(n_in):
            txid = raw[off : off + 32][::-1]
            off += 32
            (vout,) = struct.unpack_from("<I", raw, off)
            off += 4
            slen, off = read_varint(raw, off)
            script = raw[off : off + slen]
            off += slen
            (seq,) = struct.unpack_from("<I", raw, off)
            off += 4
            inputs.append(TxInput(txid, vout, script, seq))
        n_out, off = read_varint(raw, off)
        outputs = []
        for _ in range(n_out):
            (amt,) = struct.unpack_from("<q", raw, off)
            off += 8
            slen, off = read_varint(raw, off)
            outputs.append(TxOutput(amt, raw[off : off + slen]))
            off += slen
        if has_wit:
            for i in inputs:
                n_items, off = read_varint(raw, off)
                items = []
                for _ in range(n_items):
                    ilen, off = read_varint(raw, off)
                    items.append(raw[off : off + ilen])
                    off += ilen
                i.witness = items
        (locktime,) = struct.unpack_from("<I", raw, off)
        off += 4
        return cls(version, inputs, outputs, locktime), off

    # -- BIP143 (segwit v0) sighash --------------------------------------

    def sighash_segwit(self, input_index: int, script_code: bytes,
                      amount_sat: int, sighash: int = SIGHASH_ALL) -> bytes:
        """BIP143 digest.  Channels use SIGHASH_ALL everywhere except the
        counterparty's HTLC-tx signatures under option_anchors, which BOLT#3
        requires to be SIGHASH_SINGLE|ANYONECANPAY (the holder may attach
        extra fee inputs/outputs when broadcasting)."""
        base = sighash & 0x1F
        anyonecanpay = bool(sighash & SIGHASH_ANYONECANPAY)
        zero32 = bytes(32)
        if anyonecanpay:
            hash_prevouts = zero32
        else:
            hash_prevouts = sha256d(b"".join(i.outpoint for i in self.inputs))
        if anyonecanpay or base in (SIGHASH_SINGLE, SIGHASH_NONE):
            hash_sequence = zero32
        else:
            hash_sequence = sha256d(
                b"".join(struct.pack("<I", i.sequence) for i in self.inputs)
            )
        if base == SIGHASH_SINGLE:
            hash_outputs = (
                sha256d(self.outputs[input_index].serialize())
                if input_index < len(self.outputs) else zero32
            )
        elif base == SIGHASH_NONE:
            hash_outputs = zero32
        else:
            hash_outputs = sha256d(b"".join(o.serialize() for o in self.outputs))
        inp = self.inputs[input_index]
        pre = (
            struct.pack("<i", self.version)
            + hash_prevouts
            + hash_sequence
            + inp.outpoint
            + write_varint(len(script_code))
            + script_code
            + struct.pack("<q", amount_sat)
            + struct.pack("<I", inp.sequence)
            + hash_outputs
            + struct.pack("<I", self.locktime)
            + struct.pack("<I", sighash)
        )
        return sha256d(pre)


def sig_to_der(r: int, s: int, sighash: int = SIGHASH_ALL) -> bytes:
    """Compact (r, s) → DER + sighash byte (witness encoding)."""

    def enc(x: int) -> bytes:
        b = x.to_bytes((x.bit_length() + 7) // 8 or 1, "big")
        if b[0] & 0x80:
            b = b"\x00" + b
        return b

    rb, sb = enc(r), enc(s)
    body = b"\x02" + bytes([len(rb)]) + rb + b"\x02" + bytes([len(sb)]) + sb
    return b"\x30" + bytes([len(body)]) + body + bytes([sighash])


def der_to_sig(der: bytes) -> tuple[int, int, int]:
    """DER+sighash byte → (r, s, sighash_flag)."""
    assert der[0] == 0x30
    rl = der[3]
    r = int.from_bytes(der[4 : 4 + rl], "big")
    sl = der[5 + rl]
    s = int.from_bytes(der[6 + rl : 6 + rl + sl], "big")
    return r, s, der[-1]
