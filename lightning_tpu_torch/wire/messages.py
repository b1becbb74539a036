"""BOLT peer-protocol message definitions (declarative, from the public
BOLT specs — the same surface the reference generates from
wire/peer_wire.csv).

Grouped per BOLT: #1 setup/control, #2 channel establishment & HTLC
commitment flow, #7 gossip & queries, extension messages (stfu, peer
storage) as shipped by the reference (peer_wire.csv:1-60).  The port's
own copy of the JAX package's wire/messages.py."""
from __future__ import annotations

import struct

from .codec import Message, WireError

# ---------------------------------------------------------------------------
# BOLT#1


class Warning_(Message):
    TYPE = 1
    FIELDS = [("channel_id", "bytes:32"), ("data", "varbytes")]


class Stfu(Message):
    TYPE = 2
    FIELDS = [("channel_id", "bytes:32"), ("initiator", "u8")]


class PeerStorage(Message):
    TYPE = 7
    FIELDS = [("blob", "varbytes")]


class PeerStorageRetrieval(Message):
    TYPE = 9
    FIELDS = [("blob", "varbytes")]


class Init(Message):
    TYPE = 16
    FIELDS = [
        ("globalfeatures", "varbytes"),
        ("features", "varbytes"),
        ("tlvs", "tlvs"),
    ]


class Error(Message):
    TYPE = 17
    FIELDS = [("channel_id", "bytes:32"), ("data", "varbytes")]


class Ping(Message):
    TYPE = 18
    FIELDS = [("num_pong_bytes", "u16"), ("ignored", "varbytes")]


class Pong(Message):
    TYPE = 19
    FIELDS = [("ignored", "varbytes")]


# ---------------------------------------------------------------------------
# BOLT#2 — channel establishment v1


class OpenChannel(Message):
    TYPE = 32
    FIELDS = [
        ("chain_hash", "chain_hash"),
        ("temporary_channel_id", "bytes:32"),
        ("funding_satoshis", "u64"),
        ("push_msat", "u64"),
        ("dust_limit_satoshis", "u64"),
        ("max_htlc_value_in_flight_msat", "u64"),
        ("channel_reserve_satoshis", "u64"),
        ("htlc_minimum_msat", "u64"),
        ("feerate_per_kw", "u32"),
        ("to_self_delay", "u16"),
        ("max_accepted_htlcs", "u16"),
        ("funding_pubkey", "point"),
        ("revocation_basepoint", "point"),
        ("payment_basepoint", "point"),
        ("delayed_payment_basepoint", "point"),
        ("htlc_basepoint", "point"),
        ("first_per_commitment_point", "point"),
        ("channel_flags", "u8"),
        ("tlvs", "tlvs"),
    ]


class AcceptChannel(Message):
    TYPE = 33
    FIELDS = [
        ("temporary_channel_id", "bytes:32"),
        ("dust_limit_satoshis", "u64"),
        ("max_htlc_value_in_flight_msat", "u64"),
        ("channel_reserve_satoshis", "u64"),
        ("htlc_minimum_msat", "u64"),
        ("minimum_depth", "u32"),
        ("to_self_delay", "u16"),
        ("max_accepted_htlcs", "u16"),
        ("funding_pubkey", "point"),
        ("revocation_basepoint", "point"),
        ("payment_basepoint", "point"),
        ("delayed_payment_basepoint", "point"),
        ("htlc_basepoint", "point"),
        ("first_per_commitment_point", "point"),
        ("tlvs", "tlvs"),
    ]


class FundingCreated(Message):
    TYPE = 34
    FIELDS = [
        ("temporary_channel_id", "bytes:32"),
        ("funding_txid", "bytes:32"),
        ("funding_output_index", "u16"),
        ("signature", "signature"),
    ]


class FundingSigned(Message):
    TYPE = 35
    FIELDS = [("channel_id", "bytes:32"), ("signature", "signature")]


# ---------------------------------------------------------------------------
# BOLT#2 — channel establishment v2 (dual funding) + interactive tx
# construction (peer_wire.csv types 64-74)


class OpenChannel2(Message):
    TYPE = 64
    FIELDS = [
        ("chain_hash", "chain_hash"),
        ("temporary_channel_id", "bytes:32"),
        ("funding_feerate_perkw", "u32"),
        ("commitment_feerate_perkw", "u32"),
        ("funding_satoshis", "u64"),
        ("dust_limit_satoshis", "u64"),
        ("max_htlc_value_in_flight_msat", "u64"),
        ("htlc_minimum_msat", "u64"),
        ("to_self_delay", "u16"),
        ("max_accepted_htlcs", "u16"),
        ("locktime", "u32"),
        ("funding_pubkey", "point"),
        ("revocation_basepoint", "point"),
        ("payment_basepoint", "point"),
        ("delayed_payment_basepoint", "point"),
        ("htlc_basepoint", "point"),
        ("first_per_commitment_point", "point"),
        ("second_per_commitment_point", "point"),
        ("channel_flags", "u8"),
        ("tlvs", "tlvs"),
    ]


class AcceptChannel2(Message):
    TYPE = 65
    FIELDS = [
        ("temporary_channel_id", "bytes:32"),
        ("funding_satoshis", "u64"),
        ("dust_limit_satoshis", "u64"),
        ("max_htlc_value_in_flight_msat", "u64"),
        ("htlc_minimum_msat", "u64"),
        ("minimum_depth", "u32"),
        ("to_self_delay", "u16"),
        ("max_accepted_htlcs", "u16"),
        ("funding_pubkey", "point"),
        ("revocation_basepoint", "point"),
        ("payment_basepoint", "point"),
        ("delayed_payment_basepoint", "point"),
        ("htlc_basepoint", "point"),
        ("first_per_commitment_point", "point"),
        ("second_per_commitment_point", "point"),
        ("tlvs", "tlvs"),
    ]


class TxAddInput(Message):
    TYPE = 66
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("serial_id", "u64"),
        ("prevtx", "varbytes"),
        ("prevtx_vout", "u32"),
        ("sequence", "u32"),
        ("tlvs", "tlvs"),
    ]


class TxAddOutput(Message):
    TYPE = 67
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("serial_id", "u64"),
        ("sats", "u64"),
        ("script", "varbytes"),
    ]


class TxRemoveInput(Message):
    TYPE = 68
    FIELDS = [("channel_id", "bytes:32"), ("serial_id", "u64")]


class TxRemoveOutput(Message):
    TYPE = 69
    FIELDS = [("channel_id", "bytes:32"), ("serial_id", "u64")]


class TxComplete(Message):
    TYPE = 70
    FIELDS = [("channel_id", "bytes:32")]


class TxSignatures(Message):
    TYPE = 71
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("txid", "bytes:32"),
        # u16 count, then per input: u16 num_elements, each
        # (u16 len || element) — parsed by daemon/dualopend helpers
        ("witnesses", "remainder"),
    ]


class TxInitRbf(Message):
    TYPE = 72
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("locktime", "u32"),
        ("feerate", "u32"),
        ("tlvs", "tlvs"),
    ]


class TxAckRbf(Message):
    TYPE = 73
    FIELDS = [("channel_id", "bytes:32"), ("tlvs", "tlvs")]


class TxAbort(Message):
    TYPE = 74
    FIELDS = [("channel_id", "bytes:32"), ("data", "varbytes")]


class SpliceInit(Message):
    TYPE = 80
    FIELDS = [
        ("channel_id", "bytes:32"),
        # >0: splice-in (adding funds); <0: splice-out
        ("funding_contribution_satoshis", "s64"),
        ("funding_feerate_perkw", "u32"),
        ("locktime", "u32"),
        ("funding_pubkey", "point"),
        ("tlvs", "tlvs"),
    ]


class SpliceAck(Message):
    TYPE = 81
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("funding_contribution_satoshis", "s64"),
        ("funding_pubkey", "point"),
        ("tlvs", "tlvs"),
    ]


class SpliceLocked(Message):
    TYPE = 77
    FIELDS = [("channel_id", "bytes:32"), ("splice_txid", "sha256")]


class ChannelReady(Message):
    TYPE = 36
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("second_per_commitment_point", "point"),
        ("tlvs", "tlvs"),
    ]


class Shutdown(Message):
    TYPE = 38
    FIELDS = [("channel_id", "bytes:32"), ("scriptpubkey", "varbytes")]


class ClosingSigned(Message):
    TYPE = 39
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("fee_satoshis", "u64"),
        ("signature", "signature"),
        ("tlvs", "tlvs"),
    ]


# ---------------------------------------------------------------------------
# BOLT#2 — HTLC / commitment flow

ONION_PACKET_LEN = 1366


class UpdateAddHtlc(Message):
    TYPE = 128
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("id", "u64"),
        ("amount_msat", "u64"),
        ("payment_hash", "sha256"),
        ("cltv_expiry", "u32"),
        ("onion_routing_packet", f"bytes:{ONION_PACKET_LEN}"),
        ("tlvs", "tlvs"),
    ]


class UpdateFulfillHtlc(Message):
    TYPE = 130
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("id", "u64"),
        ("payment_preimage", "bytes:32"),
    ]


class UpdateFailHtlc(Message):
    TYPE = 131
    FIELDS = [("channel_id", "bytes:32"), ("id", "u64"), ("reason", "varbytes")]


class CommitmentSigned(Message):
    """signature + u16-counted per-HTLC signature array — the wire image of
    the reference's per-HTLC signing loop (channeld/channeld.c:1039-1071),
    which this framework computes as one batched device call."""

    TYPE = 132
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("signature", "signature"),
        ("htlc_signatures", "array:u16:signature"),
        ("tlvs", "tlvs"),
    ]


class RevokeAndAck(Message):
    TYPE = 133
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("per_commitment_secret", "bytes:32"),
        ("next_per_commitment_point", "point"),
    ]


class UpdateFee(Message):
    TYPE = 134
    FIELDS = [("channel_id", "bytes:32"), ("feerate_per_kw", "u32")]


class UpdateFailMalformedHtlc(Message):
    TYPE = 135
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("id", "u64"),
        ("sha256_of_onion", "sha256"),
        ("failure_code", "u16"),
    ]


class ChannelReestablish(Message):
    TYPE = 136
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("next_commitment_number", "u64"),
        ("next_revocation_number", "u64"),
        ("your_last_per_commitment_secret", "bytes:32"),
        ("my_current_per_commitment_point", "point"),
        ("tlvs", "tlvs"),
    ]


# ---------------------------------------------------------------------------
# BOLT#7 — gossip control (the gossip payloads themselves are in
# gossip/wire.py, beside the batched verify on the card)


class AnnouncementSignatures(Message):
    TYPE = 259
    FIELDS = [
        ("channel_id", "bytes:32"),
        ("short_channel_id", "short_channel_id"),
        ("node_signature", "signature"),
        ("bitcoin_signature", "signature"),
    ]


class QueryShortChannelIds(Message):
    TYPE = 261
    FIELDS = [
        ("chain_hash", "chain_hash"),
        ("encoded_short_ids", "varbytes"),
        ("tlvs", "tlvs"),
    ]


class ReplyShortChannelIdsEnd(Message):
    TYPE = 262
    FIELDS = [("chain_hash", "chain_hash"), ("full_information", "u8")]


class QueryChannelRange(Message):
    TYPE = 263
    FIELDS = [
        ("chain_hash", "chain_hash"),
        ("first_blocknum", "u32"),
        ("number_of_blocks", "u32"),
        ("tlvs", "tlvs"),
    ]


class ReplyChannelRange(Message):
    TYPE = 264
    FIELDS = [
        ("chain_hash", "chain_hash"),
        ("first_blocknum", "u32"),
        ("number_of_blocks", "u32"),
        ("sync_complete", "u8"),
        ("encoded_short_ids", "varbytes"),
        ("tlvs", "tlvs"),
    ]


class GossipTimestampFilter(Message):
    TYPE = 265
    FIELDS = [
        ("chain_hash", "chain_hash"),
        ("first_timestamp", "u32"),
        ("timestamp_range", "u32"),
    ]


class OnionMessage(Message):
    TYPE = 513
    FIELDS = [("path_key", "point"), ("onionmsg", "varbytes")]
