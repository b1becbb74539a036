"""BOLT#9 feature bits: construction, queries, and the compatibility rule.

Functional parity target: the reference's common/features.c (esp.
feature_set semantics and features.c:613 `features_unsupported` — "it's OK
to be odd": an unknown ODD bit is fine, an unknown EVEN bit means we must
fail the connection).

Encoding (BOLT#1/#7): a big-endian bitfield where bit 0 is the least
significant bit of the LAST byte; leading zero bytes are trimmed.
"""
from __future__ import annotations

# Assigned feature bits (BOLT#9).  The odd (optional) form is bit|1.
DATA_LOSS_PROTECT = 0
UPFRONT_SHUTDOWN_SCRIPT = 4
GOSSIP_QUERIES = 6
VAR_ONION = 8
GOSSIP_QUERIES_EX = 10
STATIC_REMOTEKEY = 12
PAYMENT_SECRET = 14
BASIC_MPP = 16
LARGE_CHANNELS = 18
ANCHORS_ZERO_FEE_HTLC = 22
ROUTE_BLINDING = 24
SHUTDOWN_ANYSEGWIT = 26
CHANNEL_TYPE = 44
SCID_ALIAS = 46
PAYMENT_METADATA = 48
ZEROCONF = 50


def _odd(bit: int) -> int:
    return bit | 1


# What this node advertises in init.features: everything we implement, in
# optional (odd) form so we can talk to minimal peers.  static_remotekey
# and var_onion are the modern baseline the channel code assumes.
DEFAULT_FEATURES: tuple[int, ...] = (
    _odd(DATA_LOSS_PROTECT),
    _odd(GOSSIP_QUERIES),
    _odd(VAR_ONION),
    _odd(STATIC_REMOTEKEY),
    _odd(PAYMENT_SECRET),
    _odd(BASIC_MPP),
    _odd(ANCHORS_ZERO_FEE_HTLC),
    _odd(SHUTDOWN_ANYSEGWIT),
)


def from_bits(bits) -> bytes:
    """Bit numbers → BOLT-encoded bitfield bytes."""
    if not bits:
        return b""
    nbytes = max(bits) // 8 + 1
    arr = bytearray(nbytes)
    for b in bits:
        arr[nbytes - 1 - b // 8] |= 1 << (b % 8)
    return bytes(arr)


def has_bit(features: bytes, bit: int) -> bool:
    byte_i = len(features) - 1 - bit // 8
    if byte_i < 0:
        return False
    return bool(features[byte_i] >> (bit % 8) & 1)


def has_feature(features: bytes, feature: int) -> bool:
    """True if either the compulsory or optional form is set."""
    base = feature & ~1
    return has_bit(features, base) or has_bit(features, base | 1)


def all_bits(features: bytes) -> list[int]:
    out = []
    n = len(features)
    for i, byte in enumerate(features):
        for j in range(8):
            if byte >> j & 1:
                out.append((n - 1 - i) * 8 + j)
    return sorted(out)


def unsupported_features(ours: bytes, theirs: bytes) -> list[int]:
    """EVEN bits the peer requires that we do not understand at all
    (features.c:613 semantics).  Empty list = compatible."""
    bad = []
    for bit in all_bits(theirs):
        if bit % 2 == 1:
            continue  # it's OK to be odd
        if has_feature(ours, bit):
            continue  # we support it (in either form)
        bad.append(bit)
    return bad


def combine(*feature_sets: bytes) -> bytes:
    n = max((len(f) for f in feature_sets), default=0)
    out = bytearray(n)
    for f in feature_sets:
        for i, byte in enumerate(f):
            out[n - len(f) + i] |= byte
    return bytes(out)
