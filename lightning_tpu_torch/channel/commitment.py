"""BOLT#3 commitment & HTLC transaction construction.

Parity targets in the reference: channeld/commit_tx.c:111 (commit_tx),
common/initial_commit_tx.c, common/htlc_tx.c — rebuilt from the public
BOLT#3 spec.  The *construction* is host-side (cheap, per-channel); the
per-HTLC signing fan-out it feeds is the batched device path (hsmd
service), replacing the serial hsm round-trips of channeld/channeld.c:1048.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from enum import Enum

from ..btc import script as SC
from ..btc import tx as T
from ..btc import keys as K
from ..crypto import ref_python as ref

# BOLT#3 weights
COMMITMENT_TX_WEIGHT = 724
COMMITMENT_TX_WEIGHT_ANCHORS = 1124
COMMITMENT_HTLC_WEIGHT = 172
HTLC_TIMEOUT_WEIGHT = 663
HTLC_TIMEOUT_WEIGHT_ANCHORS = 666
HTLC_SUCCESS_WEIGHT = 703
HTLC_SUCCESS_WEIGHT_ANCHORS = 706
ANCHOR_OUTPUT_SAT = 330


class Side(Enum):
    LOCAL = 0
    REMOTE = 1

    @property
    def other(self):
        return Side.REMOTE if self is Side.LOCAL else Side.LOCAL


@dataclass(frozen=True)
class Htlc:
    """A live HTLC from the perspective of the commitment holder.
    offered=True means the commitment holder offered it."""

    offered: bool
    amount_msat: int
    payment_hash: bytes
    cltv_expiry: int
    id: int = 0


@dataclass
class CommitmentKeys:
    """The per-commitment key set for one side's commitment tx."""

    per_commitment_point: ref.Point
    local_htlcpubkey: bytes
    remote_htlcpubkey: bytes
    local_delayedpubkey: bytes
    remote_pubkey: bytes  # payment key of the other side
    revocation_pubkey: bytes

    @classmethod
    def derive(cls, holder_base: K.Basepoints, other_base: K.Basepoints,
               per_commitment_point: ref.Point) -> "CommitmentKeys":
        ser = ref.pubkey_serialize
        return cls(
            per_commitment_point=per_commitment_point,
            local_htlcpubkey=ser(K.derive_pubkey(holder_base.htlc, per_commitment_point)),
            remote_htlcpubkey=ser(K.derive_pubkey(other_base.htlc, per_commitment_point)),
            local_delayedpubkey=ser(
                K.derive_pubkey(holder_base.delayed_payment, per_commitment_point)
            ),
            # with option_static_remotekey (assumed; the modern default the
            # reference requires) the to_remote key is the plain payment
            # basepoint, not derived
            remote_pubkey=ser(other_base.payment),
            revocation_pubkey=ser(
                K.derive_revocation_pubkey(other_base.revocation, per_commitment_point)
            ),
        )


def obscured_commitment_number(commitment_number: int,
                               opener_payment_basepoint: bytes,
                               accepter_payment_basepoint: bytes) -> int:
    h = hashlib.sha256(opener_payment_basepoint + accepter_payment_basepoint).digest()
    return commitment_number ^ (int.from_bytes(h[-6:], "big"))


def htlc_fee_sat(feerate_per_kw: int, success: bool, anchors: bool) -> int:
    if success:
        w = HTLC_SUCCESS_WEIGHT_ANCHORS if anchors else HTLC_SUCCESS_WEIGHT
    else:
        w = HTLC_TIMEOUT_WEIGHT_ANCHORS if anchors else HTLC_TIMEOUT_WEIGHT
    return feerate_per_kw * w // 1000


def is_trimmed(htlc: Htlc, feerate_per_kw: int, dust_limit_sat: int,
               anchors: bool) -> bool:
    """BOLT#3 trimming: output below dust after deducting the HTLC-tx fee."""
    fee = htlc_fee_sat(feerate_per_kw, success=not htlc.offered, anchors=anchors)
    return htlc.amount_msat // 1000 < dust_limit_sat + fee


@dataclass
class CommitmentParams:
    funding_txid: bytes
    funding_output_index: int
    funding_sat: int
    opener: Side  # who pays the fee
    opener_payment_basepoint: bytes
    accepter_payment_basepoint: bytes
    to_self_delay: int
    dust_limit_sat: int
    feerate_per_kw: int
    anchors: bool = True
    local_funding_pubkey: bytes = b""
    remote_funding_pubkey: bytes = b""


def build_commitment_tx(
    params: CommitmentParams,
    keys: CommitmentKeys,
    commitment_number: int,
    to_local_msat: int,
    to_remote_msat: int,
    htlcs: list[Htlc],
    holder_is_opener: bool,
) -> tuple[T.Tx, list[Htlc | None]]:
    """Build one side's commitment transaction.

    Returns (tx, per-output htlc map) where the map entry is the Htlc for
    HTLC outputs and None for non-HTLC outputs (needed to know which
    outputs need HTLC signatures — the batched signer consumes this).
    """
    p = params
    obscured = obscured_commitment_number(
        commitment_number, p.opener_payment_basepoint, p.accepter_payment_basepoint
    )
    locktime = (0x20 << 24) | (obscured & 0xFFFFFF)
    sequence = (0x80 << 24) | ((obscured >> 24) & 0xFFFFFF)

    untrimmed = [h for h in htlcs
                 if not is_trimmed(h, p.feerate_per_kw, p.dust_limit_sat, p.anchors)]
    weight = (COMMITMENT_TX_WEIGHT_ANCHORS if p.anchors else COMMITMENT_TX_WEIGHT)
    weight += COMMITMENT_HTLC_WEIGHT * len(untrimmed)
    base_fee = p.feerate_per_kw * weight // 1000

    to_local = to_local_msat // 1000
    to_remote = to_remote_msat // 1000
    if holder_is_opener:
        to_local -= base_fee
        if p.anchors:
            to_local -= 2 * ANCHOR_OUTPUT_SAT
    else:
        to_remote -= base_fee
        if p.anchors:
            to_remote -= 2 * ANCHOR_OUTPUT_SAT
    # fee floor: opener output can't go negative (it's dust-trimmed below)

    outputs: list[tuple[T.TxOutput, Htlc | None, int]] = []

    for h in untrimmed:
        if h.offered:
            ws = SC.offered_htlc_script(
                keys.revocation_pubkey, keys.remote_htlcpubkey,
                keys.local_htlcpubkey, h.payment_hash, p.anchors,
            )
        else:
            ws = SC.received_htlc_script(
                keys.revocation_pubkey, keys.remote_htlcpubkey,
                keys.local_htlcpubkey, h.payment_hash, h.cltv_expiry, p.anchors,
            )
        outputs.append(
            (T.TxOutput(h.amount_msat // 1000, SC.p2wsh(ws)), h, h.cltv_expiry)
        )

    has_local = to_local >= p.dust_limit_sat
    has_remote = to_remote >= p.dust_limit_sat
    if has_local:
        ws = SC.to_local_script(keys.revocation_pubkey, p.to_self_delay,
                                keys.local_delayedpubkey)
        outputs.append((T.TxOutput(to_local, SC.p2wsh(ws)), None, 0))
    if has_remote:
        if p.anchors:
            spk = SC.p2wsh(SC.to_remote_anchor_script(keys.remote_pubkey))
        else:
            spk = SC.p2wpkh(keys.remote_pubkey)
        outputs.append((T.TxOutput(to_remote, spk), None, 0))
    if p.anchors:
        # anchors exist iff the side has an output or untrimmed HTLCs
        if has_local or untrimmed:
            outputs.append((
                T.TxOutput(ANCHOR_OUTPUT_SAT,
                           SC.p2wsh(SC.anchor_script(p.local_funding_pubkey))),
                None, 0,
            ))
        if has_remote or untrimmed:
            outputs.append((
                T.TxOutput(ANCHOR_OUTPUT_SAT,
                           SC.p2wsh(SC.anchor_script(p.remote_funding_pubkey))),
                None, 0,
            ))

    # BIP69 ordering with BOLT#3 tiebreak: identical (amount, script)
    # entries sort by cltv_expiry
    outputs.sort(key=lambda o: (o[0].amount_sat, o[0].script_pubkey, o[2]))

    tx = T.Tx(
        version=2,
        inputs=[T.TxInput(p.funding_txid, p.funding_output_index,
                          sequence=sequence)],
        outputs=[o[0] for o in outputs],
        locktime=locktime,
    )
    return tx, [o[1] for o in outputs]


def build_htlc_tx(
    commitment_txid: bytes,
    output_index: int,
    htlc: Htlc,
    keys: CommitmentKeys,
    to_self_delay: int,
    feerate_per_kw: int,
    anchors: bool,
) -> T.Tx:
    """HTLC-timeout (for offered) / HTLC-success (for received) tx."""
    success = not htlc.offered
    fee = htlc_fee_sat(feerate_per_kw, success, anchors)
    amount = htlc.amount_msat // 1000 - fee
    ws = SC.to_local_script(keys.revocation_pubkey, to_self_delay,
                            keys.local_delayedpubkey)
    return T.Tx(
        version=2,
        inputs=[T.TxInput(commitment_txid, output_index,
                          sequence=1 if anchors else 0)],
        outputs=[T.TxOutput(amount, SC.p2wsh(ws))],
        locktime=0 if success else htlc.cltv_expiry,
    )


def htlc_sighashes(
    commitment_tx: T.Tx,
    htlc_map: list[Htlc | None],
    keys: CommitmentKeys,
    to_self_delay: int,
    feerate_per_kw: int,
    anchors: bool,
) -> list[tuple[int, bytes]]:
    """(output_index, sighash) for every HTLC output — the batch fed to the
    device signer (replacing channeld/channeld.c:1048's serial loop)."""
    out = []
    txid = commitment_tx.txid()
    for idx, h in enumerate(htlc_map):
        if h is None:
            continue
        htx = build_htlc_tx(txid, idx, h, keys, to_self_delay,
                            feerate_per_kw, anchors)
        if h.offered:
            ws = SC.offered_htlc_script(
                keys.revocation_pubkey, keys.remote_htlcpubkey,
                keys.local_htlcpubkey, h.payment_hash, anchors,
            )
        else:
            ws = SC.received_htlc_script(
                keys.revocation_pubkey, keys.remote_htlcpubkey,
                keys.local_htlcpubkey, h.payment_hash, h.cltv_expiry, anchors,
            )
        # BOLT#3: with option_anchors the counterparty's HTLC signature
        # (the one we produce here and ship in commitment_signed
        # htlc_signatures) uses SIGHASH_SINGLE|ANYONECANPAY
        sighash = htx.sighash_segwit(0, ws, h.amount_msat // 1000,
                                     htlc_sighash_flags(anchors))
        out.append((idx, sighash))
    return out


def htlc_sighash_flags(anchors: bool) -> int:
    """The sighash byte that accompanies HTLC-tx signatures in witnesses."""
    return T.SIGHASH_SINGLE_ANYONECANPAY if anchors else T.SIGHASH_ALL
