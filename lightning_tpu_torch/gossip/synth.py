"""Synthetic gossip_store generator for the port's tests and chip smoke.

Writes a spec-valid store in Core Lightning's on-disk format:
n_channels channel_announcements (4 signatures each), updates_per_channel
channel_updates per channel and one node_announcement per node, the
workload shape of a gossip_store replay.  Everything comes from one
numpy ``default_rng(seed)``: keys, topology, nonces, and the seeded
faults that give a verify run known answers:

* ``n_corrupt`` signatures with one bit of r flipped;
* ``off_curve`` nodes whose announced key x has no point on the curve;
* ``bad_tag`` nodes whose announced key starts with 0x04 (not 0x02/0x03);
* ``oversized`` node_announcements whose signed region exceeds the
  device hash rows (hashed on the host by the verifier).

Every signature by an off-curve or bad-tag node is invalid, as is every
corrupted one; all others are valid.  ``expected_sig_ok`` lists the
verdicts in the verifier's item order (channel_announcement slots first,
slot-major, then node_announcements, then channel_updates).

Signing runs on the sign path's kernels, as the JAX package's synth
signs with ecdsa_sign_simple_kernel: node keys d*G by S1
(``engines.derive_pubkeys``), and each signature by S2 with one random
nonce and no grinding (``engines.ecdsa_sign_simple``), low-S; their plain
versions on the CPU.  A verify run that samples signatures against the
exact-int host oracle guards against this circularity.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .. import device as D
from ..crypto import field as F
from ..crypto import engines as E
from ..crypto import ref_python as ref
from . import wire
from .store import StoreWriter

P, N = ref.P, ref.N
SIGN_BUCKET = 65536
# Core Lightning's mainnet-scale shape (the JAX package's --mainnet preset)
MAINNET_CHANNELS = 250_000
MAINNET_NODES = 60_000


def _sha256d(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def _rand_scalars(rng: np.random.Generator, n: int) -> list[int]:
    raw = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    return [int.from_bytes(row.tobytes(), "big") % (N - 1) + 1 for row in raw]


def sign_bulk(hashes: list[bytes], keys: list[int], rng,
              device) -> np.ndarray:
    """ECDSA with random nonces from `rng` (no grinding), low-S: (N, 64)."""
    ks = _rand_scalars(rng, len(hashes))
    z = np.frombuffer(b"".join(hashes), np.uint8).reshape(-1, 32)
    return E.ecdsa_sign_simple(z, keys, ks, SIGN_BUCKET, device)


def make_signed_batch(n: int, rng: np.random.Generator | None = None,
                      device=None):
    """n signed channel_update-sized messages (130-byte signed regions),
    as the JAX package's make_signed_batch builds them: keys by S1 and
    signatures by S2 on `device` (the card unless device="cpu").  Returns
    (rows, n_blocks, sigs, pubs), rows being sha-padded signed regions in
    the (n, MAX_BLOCKS * 64) layout verify_items consumes."""
    from ..utils import native
    from .verify import MAX_BLOCKS

    dev = D.resolve(device)
    rng = rng or np.random.default_rng(0)
    keys = _rand_scalars(rng, n)
    pubs = E.derive_pubkeys(F.from_int_array(keys).numpy(), SIGN_BUCKET, dev)
    msg_len = 130
    raw = rng.integers(0, 256, n * msg_len).astype(np.uint8)
    offs = np.arange(n, dtype=np.int64) * msg_len
    rows, nb = native.sha256_pack(raw, offs, np.full(n, msg_len, np.int64),
                                  MAX_BLOCKS)
    hashes = [_sha256d(raw[i * msg_len:(i + 1) * msg_len].tobytes())
              for i in range(n)]
    return rows, nb, sign_bulk(hashes, keys, rng, dev), pubs


def _off_curve_key(rng) -> bytes:
    while True:
        x = _rand_scalars(rng, 1)[0] % P
        y2 = (x * x * x + 7) % P
        if pow(y2, (P - 1) // 2, P) != 1:
            return b"\x02" + x.to_bytes(32, "big")


def _scid_for(i: int) -> int:
    return (500000 + i // 2016) << 40 | (i % 2016) << 16 | 0


def make_network_store(path: str, n_channels: int, n_nodes: int | None = None,
                       updates_per_channel: int = 2, seed: int = 7,
                       device=None, n_corrupt: int = 0, off_curve: int = 0,
                       bad_tag: int = 0, oversized: int = 0) -> dict:
    """Write a synthetic store to `path` and return its counts, the
    expected per-signature verdicts and the seeded fault lists."""
    dev = D.resolve(device)
    rng = np.random.default_rng(seed)
    n_nodes = n_nodes or max(2, n_channels // 8)
    seckeys = _rand_scalars(rng, n_nodes)
    pub = [bytes(p) for p in E.derive_pubkeys(
        F.from_int_array(seckeys).numpy(), SIGN_BUCKET, dev)]
    special = rng.permutation(n_nodes)[:off_curve + bad_tag + oversized]
    bad_nodes = np.zeros(n_nodes, bool)
    for i in special[:off_curve]:
        pub[i] = _off_curve_key(rng)
    for i in special[off_curve:off_curve + bad_tag]:
        pub[i] = b"\x04" + pub[i][1:]
    bad_nodes[special[:off_curve + bad_tag]] = True
    big_nodes = set(int(i) for i in special[off_curve + bad_tag:])

    # channel endpoints; BOLT 7: node_id_1 is the lexically lesser key
    a = rng.integers(0, n_nodes, n_channels)
    b = (a + 1 + rng.integers(0, n_nodes - 1, n_channels)) % n_nodes
    swap = np.array([pub[x] > pub[y] for x, y in zip(a, b)], bool)
    n1 = np.where(swap, b, a)
    n2 = np.where(swap, a, b)

    msgs, hashes, signers, patches = [], [], [], []

    def add(msg: bytearray, signed_offset: int, sig_slots):
        h = _sha256d(bytes(msg[signed_offset:]))
        for off, signer in sig_slots:
            hashes.append(h)
            signers.append(int(signer))
            patches.append((len(msgs), off))
        msgs.append(msg)

    for i in range(n_channels):
        ca = wire.ChannelAnnouncement(
            short_channel_id=_scid_for(i), node_id_1=pub[n1[i]],
            node_id_2=pub[n2[i]], bitcoin_key_1=pub[n1[i]],
            bitcoin_key_2=pub[n2[i]])
        add(bytearray(ca.serialize()), wire.CA_SIGNED_OFFSET,
            zip(wire.CA_SIG_OFFSETS, (n1[i], n2[i], n1[i], n2[i])))
    n_ca_msgs = len(msgs)
    fees = rng.integers(0, 10000, (n_channels, updates_per_channel, 3))
    for i in range(n_channels):
        for d in range(updates_per_channel):
            direction = d % 2
            cu = wire.ChannelUpdate(
                short_channel_id=_scid_for(i), timestamp=1700000000 + i,
                channel_flags=direction,
                htlc_maximum_msat=int(fees[i, d, 0]) << 20,
                fee_base_msat=int(fees[i, d, 1]) % 5000,
                fee_proportional_millionths=int(fees[i, d, 2]))
            add(bytearray(cu.serialize()), wire.CU_SIGNED_OFFSET,
                [(wire.CU_SIG_OFFSET, (n1 if direction == 0 else n2)[i])])
    n_cu = len(msgs) - n_ca_msgs
    for i in range(n_nodes):
        # 86 IPv4 address descriptors push the signed region past the
        # verifier's 8 SHA blocks
        addrs = (b"\x01\x7f\x00\x00\x01\x26\x07" * 86
                 if i in big_nodes else b"")
        na = wire.NodeAnnouncement(
            timestamp=1700000000 + i, node_id=pub[i], addresses=addrs,
            alias=(b"gpu-node-%06d" % i).ljust(32, b"\x00"))
        add(bytearray(na.serialize()), wire.NA_SIGNED_OFFSET,
            [(wire.NA_SIG_OFFSET, i)])

    n_sigs = len(hashes)
    sigs = sign_bulk(hashes, [seckeys[s] for s in signers], rng, dev)
    corrupt = np.sort(rng.choice(n_sigs, size=n_corrupt, replace=False))
    sigs[corrupt, 31] ^= 1                      # flip the low bit of r
    for (m, off), sig in zip(patches, sigs):
        msgs[m][off:off + 64] = sig.tobytes()
    with StoreWriter(path) as w:
        w.append_many([bytes(m) for m in msgs],
                      [1700000000 + k for k in range(len(msgs))])

    bad = bad_nodes[np.asarray(signers)]
    bad[corrupt] = True
    # job order: CA (4 per message, in slot order), CU, NA; the
    # verifier's item order is CA slot-major, then NA, then CU
    n_ca_sigs = 4 * n_channels
    bad_ca = bad[:n_ca_sigs].reshape(n_channels, 4)
    bad_cu = bad[n_ca_sigs:n_ca_sigs + n_cu]
    bad_na = bad[n_ca_sigs + n_cu:]
    expected = ~np.concatenate([bad_ca.T.reshape(-1), bad_na, bad_cu])
    return {
        "channels": n_channels, "nodes": n_nodes, "channel_updates": n_cu,
        "node_announcements": n_nodes, "sigs": n_sigs,
        "corrupt": corrupt, "off_curve_nodes": special[:off_curve],
        "bad_tag_nodes": special[off_curve:off_curve + bad_tag],
        "oversized_nodes": sorted(big_nodes),
        "expected_sig_ok": expected,
        "expected_ca_valid": ~bad_ca.any(axis=1),
        "seckeys": seckeys,
    }
