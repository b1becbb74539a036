"""Bitcoin script building + the BOLT#3 channel script templates.

Spec source: BOLT#3 (public).  Parity targets in the reference:
common/initial_commit_tx.c / channeld/commit_tx.c script construction.
"""
from __future__ import annotations

import hashlib

OP_0 = 0x00
OP_PUSHDATA1 = 0x4C
OP_1 = 0x51
OP_2 = 0x52
OP_16 = 0x60
OP_IF = 0x63
OP_NOTIF = 0x64
OP_ELSE = 0x67
OP_ENDIF = 0x68
OP_DROP = 0x75
OP_DUP = 0x76
OP_IFDUP = 0x73
OP_SWAP = 0x7C
OP_SIZE = 0x82
OP_EQUAL = 0x87
OP_EQUALVERIFY = 0x88
OP_ADD = 0x93
OP_HASH160 = 0xA9
OP_CHECKSIG = 0xAC
OP_CHECKSIGVERIFY = 0xAD
OP_CHECKMULTISIG = 0xAE
OP_CHECKLOCKTIMEVERIFY = 0xB1
OP_CHECKSEQUENCEVERIFY = 0xB2


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def hash160(b: bytes) -> bytes:
    return hashlib.new("ripemd160", hashlib.sha256(b).digest()).digest()


def ripemd160(b: bytes) -> bytes:
    return hashlib.new("ripemd160", b).digest()


def push(data: bytes) -> bytes:
    if len(data) == 0:
        return bytes([OP_0])
    if len(data) == 1 and 1 <= data[0] <= 16:
        return bytes([OP_1 + data[0] - 1])
    if len(data) < OP_PUSHDATA1:
        return bytes([len(data)]) + data
    assert len(data) <= 0xFF
    return bytes([OP_PUSHDATA1, len(data)]) + data


def push_num(n: int) -> bytes:
    """Minimal CScriptNum push."""
    if n == 0:
        return bytes([OP_0])
    if 1 <= n <= 16:
        return bytes([OP_1 + n - 1])
    out = []
    neg = n < 0
    v = abs(n)
    while v:
        out.append(v & 0xFF)
        v >>= 8
    if out[-1] & 0x80:
        out.append(0x80 if neg else 0)
    elif neg:
        out[-1] |= 0x80
    return push(bytes(out))


def script(*parts) -> bytes:
    out = b""
    for p in parts:
        out += bytes([p]) if isinstance(p, int) else p
    return out


def p2wsh(witness_script: bytes) -> bytes:
    return bytes([OP_0, 32]) + sha256(witness_script)


def p2wpkh(pubkey: bytes) -> bytes:
    return bytes([OP_0, 20]) + hash160(pubkey)


def dust_floor_sat(spk: bytes) -> int:
    """Relay-policy dust floor for an output paying to this script
    (Core policy/policy.cpp GetDustThreshold at the 3000 sat/kvB
    dust relay rate): OP_RETURN outputs carry no value by design,
    witness programs get the discounted 294/330 floors, everything
    else the legacy 546."""
    if spk[:1] == b"\x6a":
        return 0
    if spk and spk[0] == 0x00 and len(spk) in (22, 34):
        return 294 if len(spk) == 22 else 330
    if spk and 0x51 <= spk[0] <= 0x60 and len(spk) >= 4:
        return 330                     # v1+ witness program (taproot)
    return 546


# ---------------------------------------------------------------------------
# BOLT#3 templates


def funding_script(pubkey1: bytes, pubkey2: bytes) -> bytes:
    """2-of-2 multisig, keys in lexical order (BOLT#3 'Funding Transaction
    Output')."""
    k1, k2 = sorted([pubkey1, pubkey2])
    return script(OP_2, push(k1), push(k2), OP_2, OP_CHECKMULTISIG)


def to_local_script(revocation_pubkey: bytes, to_self_delay: int,
                    local_delayed_pubkey: bytes) -> bytes:
    return script(
        OP_IF, push(revocation_pubkey),
        OP_ELSE, push_num(to_self_delay), OP_CHECKSEQUENCEVERIFY, OP_DROP,
        push(local_delayed_pubkey),
        OP_ENDIF, OP_CHECKSIG,
    )


def to_remote_anchor_script(remote_pubkey: bytes) -> bytes:
    """option_anchors to_remote: 1-block CSV encumbered P2WSH."""
    return script(push(remote_pubkey), OP_CHECKSIGVERIFY,
                  push_num(1), OP_CHECKSEQUENCEVERIFY)


def anchor_script(funding_pubkey: bytes) -> bytes:
    return script(push(funding_pubkey), OP_CHECKSIG, OP_IFDUP, OP_NOTIF,
                  push_num(16), OP_CHECKSEQUENCEVERIFY, OP_ENDIF)


def offered_htlc_script(revocation_pubkey: bytes, remote_htlcpubkey: bytes,
                        local_htlcpubkey: bytes, payment_hash: bytes,
                        anchors: bool) -> bytes:
    tail = (script(push_num(1), OP_CHECKSEQUENCEVERIFY, OP_DROP)
            if anchors else b"")
    return script(
        OP_DUP, OP_HASH160, push(hash160(revocation_pubkey)), OP_EQUAL,
        OP_IF, OP_CHECKSIG,
        OP_ELSE, push(remote_htlcpubkey), OP_SWAP, OP_SIZE, push_num(32),
        OP_EQUAL,
        OP_NOTIF,
        OP_DROP, push_num(2), OP_SWAP, push(local_htlcpubkey), push_num(2),
        OP_CHECKMULTISIG,
        OP_ELSE,
        # payment_hash is already sha256(preimage): the on-stack preimage is
        # OP_HASH160'd, so the constant is ripemd160(payment_hash)
        OP_HASH160, push(ripemd160(payment_hash)), OP_EQUALVERIFY, OP_CHECKSIG,
        OP_ENDIF,
        tail,
        OP_ENDIF,
    )


def received_htlc_script(revocation_pubkey: bytes, remote_htlcpubkey: bytes,
                         local_htlcpubkey: bytes, payment_hash: bytes,
                         cltv_expiry: int, anchors: bool) -> bytes:
    tail = (script(push_num(1), OP_CHECKSEQUENCEVERIFY, OP_DROP)
            if anchors else b"")
    return script(
        OP_DUP, OP_HASH160, push(hash160(revocation_pubkey)), OP_EQUAL,
        OP_IF, OP_CHECKSIG,
        OP_ELSE, push(remote_htlcpubkey), OP_SWAP, OP_SIZE, push_num(32),
        OP_EQUAL,
        OP_IF,
        OP_HASH160, push(ripemd160(payment_hash)), OP_EQUALVERIFY,
        push_num(2), OP_SWAP, push(local_htlcpubkey), push_num(2),
        OP_CHECKMULTISIG,
        OP_ELSE,
        OP_DROP, push_num(cltv_expiry), OP_CHECKLOCKTIMEVERIFY, OP_DROP,
        OP_CHECKSIG,
        OP_ENDIF,
        tail,
        OP_ENDIF,
    )
