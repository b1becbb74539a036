"""The port's hsmd subset and BOLT #3 commitment against the JAX
package's.

* ``Hsm(secret)``: node key, channel basepoints, per-commitment points and
  the single host signatures equal the JAX package's; ``sign_htlc_batch``
  at B = 2 (which the JAX package signs on its host oracle) is byte for
  byte the same on rows with a low-R candidate among the four;
* ``channel/commitment.py``: the HTLC sighashes of a commitment with
  BOLT #2's max_accepted_htlcs = 483 HTLCs, anchors on and off, byte for
  byte the reference's;
* ``check_sigs_batch(device="cpu")`` on the port's signatures: all True,
  and False on a flipped row.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from lightning_tpu.btc import keys as JK
from lightning_tpu.channel import commitment as JC
from lightning_tpu.daemon import hsmd as JH
from lightning_tpu_torch.channel import commitment as TC
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import ref_python as ref
from lightning_tpu_torch.daemon import hsmd as TH

torch.set_num_threads(1)

US, THEM = b"\x11" * 32, b"\x22" * 32
PEER = b"\x03" + b"\x44" * 32
MAX_HTLCS = 483            # BOLT #2 max_accepted_htlcs


def _pair(hsmd):
    """Our Hsm with a channel client, and the peer's."""
    us, them = hsmd.Hsm(US), hsmd.Hsm(THEM)
    return (us, us.client(hsmd.CAP_MASTER, PEER, dbid=1),
            them, them.client(hsmd.CAP_MASTER, PEER, dbid=1))


def _point(p) -> tuple[int, int]:
    return p.x, p.y


def test_hsm_derivations_match_the_jax_package():
    t_us, t_cl, _, _ = _pair(TH)
    j_us, j_cl, _, _ = _pair(JH)
    assert _point(t_us.node_pubkey) == _point(j_us.node_pubkey)
    tb, jb = t_us.channel_basepoints(t_cl), j_us.channel_basepoints(j_cl)
    for name in ("funding_pubkey", "revocation", "payment",
                 "delayed_payment", "htlc"):
        assert _point(getattr(tb, name)) == _point(getattr(jb, name))
    for n in (0, 1, 47):
        assert _point(t_us.per_commitment_point(t_cl, n)) == \
            _point(j_us.per_commitment_point(j_cl, n))
    h = hashlib.sha256(b"announce").digest()
    assert t_us.sign_channel_announcement(t_cl, h) == \
        j_us.sign_channel_announcement(j_cl, h)
    assert t_us.sign_remote_commitment(t_cl, h) == \
        j_us.sign_remote_commitment(j_cl, h)
    pt = t_us.per_commitment_point(t_cl, 3)
    assert t_us.sign_remote_htlc_to_us(t_cl, h, pt) == \
        j_us.sign_remote_htlc_to_us(j_cl, h, JK.per_commitment_point(
            j_us.per_commitment_secret(j_cl, 3)))
    with pytest.raises(TH.HsmError):
        t_us.sign_htlc_batch(t_us.client(TH.CAP_SIGN_GOSSIP), [h], pt)


def _commitment(C, hsmd, n_htlcs: int, anchors: bool, number: int = 0):
    """The peer's (remote) commitment `number` with n_htlcs HTLCs, half
    offered and half received, as our node builds it to sign its HTLC
    transactions: (sighashes, their per-commitment point, our HTLC
    pubkey)."""
    us, cl, them, their_cl = _pair(hsmd)
    point = them.per_commitment_point(their_cl, number)
    keys = C.CommitmentKeys.derive(them.channel_basepoints(their_cl),
                                   us.channel_basepoints(cl), point)
    params = C.CommitmentParams(
        funding_txid=hashlib.sha256(b"funding").digest(),
        funding_output_index=0, funding_sat=16_777_215, opener=C.Side.LOCAL,
        opener_payment_basepoint=keys.remote_pubkey,
        accepter_payment_basepoint=ref.pubkey_serialize(
            them.channel_basepoints(their_cl).payment),
        to_self_delay=144, dust_limit_sat=546, feerate_per_kw=253,
        anchors=anchors,
        local_funding_pubkey=ref.pubkey_serialize(
            them.channel_basepoints(their_cl).funding_pubkey),
        remote_funding_pubkey=ref.pubkey_serialize(
            us.channel_basepoints(cl).funding_pubkey))
    htlcs = [C.Htlc(offered=i % 2 == 0, amount_msat=(20_000 + 37 * i) * 1000,
                    payment_hash=hashlib.sha256(b"preimage%d" % i).digest(),
                    cltv_expiry=800_000 + i, id=i) for i in range(n_htlcs)]
    tx, hmap = C.build_commitment_tx(params, keys, number, 6_000_000_000,
                                     500_000_000, htlcs,
                                     holder_is_opener=False)
    sighashes = [h for _, h in C.htlc_sighashes(
        tx, hmap, keys, 144, params.feerate_per_kw, anchors)]
    return sighashes, point, keys.remote_htlcpubkey


@pytest.mark.parametrize("anchors", [True, False], ids=["anchors", "plain"])
def test_htlc_sighashes_match_the_jax_package(anchors):
    got = _commitment(TC, TH, MAX_HTLCS, anchors)
    want = _commitment(JC, JH, MAX_HTLCS, anchors)
    assert len(got[0]) == MAX_HTLCS
    assert got[0] == want[0]
    assert got[2] == want[2]


def test_sign_htlc_batch_and_check_sigs():
    """Two HTLC sighashes with a low-R candidate among their four: the
    port's batch (S2's plain version here) equals the JAX package's, which
    signs a batch of two on its host oracle.  The check is all True, and
    False where a signature's bit is flipped."""
    sighashes, point, pub = _commitment(TC, TH, 6, anchors=True)
    t_us, t_cl, _, _ = _pair(TH)
    j_us, j_cl, j_them, j_their_cl = _pair(JH)
    t_us.device = "cpu"
    priv = t_us.htlc_privkey(t_cl, point)
    low = [E.sign_with_candidates(int.from_bytes(h, "big"), priv,
                                  E.rfc6979_candidates(h, priv))[3]
           for h in sighashes]
    pick = [h for h, lo in zip(sighashes, low) if lo][:2]
    j_point = j_them.per_commitment_point(j_their_cl, 0)
    assert np.array_equal(t_us.sign_htlc_batch(t_cl, pick, point),
                          j_us.sign_htlc_batch(j_cl, pick, j_point))
    sigs = t_us.sign_htlc_batch(t_cl, sighashes, point)
    assert ref.pubkey_serialize(ref.pubkey_create(priv)) == pub
    hashes = np.stack([np.frombuffer(h, np.uint8) for h in sighashes])
    pubs = np.tile(np.frombuffer(pub, np.uint8), (len(sighashes), 1))
    assert t_us.check_sigs_batch(hashes, sigs, pubs).all()
    sigs[3, 50] ^= 1
    assert t_us.check_sigs_batch(hashes, sigs, pubs).tolist() == \
        [True] * 3 + [False] + [True] * (len(sighashes) - 4)
