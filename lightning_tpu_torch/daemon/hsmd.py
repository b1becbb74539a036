"""hsmd-equivalent: the key service, for the HTLC-signature fan-out.

Core Lightning's hsmd (hsmd/hsmd.c, dispatch in libhsmd.c) is the sole
holder of secrets; every signature crosses a socketpair to it, one
request at a time, so a commitment with 483 HTLCs costs 483 round trips
(channeld/channeld.c).  This service keeps the same trust boundary (one
object owns the secret; callers hold capability-scoped client handles, as
hsmd/permissions.h scopes them) and signs a whole commitment's HTLC
sighashes in one device call (``sign_htlc_batch``: S2 on the card) and
checks them in one (``check_sigs_batch``: the verify main path, K1 + K2 +
K3).

The subset of the JAX package's daemon/hsmd.py the fan-out needs, with
the same derivations, so a secret gives the same keys and signatures in
both (``tests/test_torch_hsmd.py``).  The single signatures (gossip,
funding, on-chain claims) stay on the host, ``ref.ecdsa_sign``, as they
are in the JAX package.  Not here: the wallet's ``bip32_base`` /
``sign_withdrawal``.

Both batched calls are supervised dispatches: the sign under the "sign"
circuit breaker (flight family "sign"), the check under the "verify"
breaker it shares with the gossip replay (flight family "check"), each
with its span, fault seam and flight record.  A failed or refused
dispatch raises: nothing is signed or checked on the host in its place.
"""
from __future__ import annotations

import hashlib
import hmac
import os
from dataclasses import dataclass

import numpy as np

from .. import device as D
from ..btc import keys as K
from ..crypto import engines as E
from ..crypto import ref_python as ref
from ..obs import families as _families
from ..obs import flight as _flight
from ..resilience import breaker as _breaker
from ..resilience import faultinject as _fault
from ..utils import trace

_M_SIGN_SIGS = _families.SIGN_BATCH_SIGS
_M_SIGN_CALLS = _families.SIGN_CALLS


def _note_sign(op: str, n_sigs: int, path: str) -> None:
    _M_SIGN_SIGS.labels(op).observe(n_sigs)
    _M_SIGN_CALLS.labels(op, path).inc()


def _sign_batch_resilient(op: str, msg_hashes: np.ndarray,
                          seckeys: list[int], device) -> np.ndarray:
    """Batched sign under the "sign" circuit breaker, one flight-recorded
    "sign" dispatch.  An open breaker raises ``BreakerOpen`` and a failed
    dispatch raises."""
    device = D.resolve(device)
    B = msg_hashes.shape[0]
    brk = _breaker.get("sign")
    # the carrier links the caller's span (the enqueue point) to this
    # dispatch span
    corr = trace.new_corr()
    with _flight.dispatch("sign", n_real=B, lanes=B, shape=(B, 32),
                          corr_ids=(corr.corr_id,),
                          breaker_state=brk.state) as rec:
        with trace.span("sign/dispatch", corr=corr, op=op,
                        dispatch_id=rec["dispatch_id"]):
            with trace.annotation("sign/dispatch", device):
                return _sign_dispatch(op, msg_hashes, seckeys, brk, rec, B,
                                      device)


def _sign_dispatch(op: str, msg_hashes: np.ndarray, seckeys: list[int],
                   brk, rec: dict, B: int, device) -> np.ndarray:
    if not brk.allow():
        raise _breaker.BreakerOpen("sign", brk.retry_in_s())
    try:
        _fault.fire("sign", "sign")
        # operand staging: B 32-byte hashes and B 32-byte keys up, B
        # compact signatures back
        rec["h2d_bytes"] = int(msg_hashes.nbytes) + 32 * B
        _families.TRANSFER_BYTES.labels("sign", "h2d").inc(rec["h2d_bytes"])
        out = E.ecdsa_sign_batch(msg_hashes, seckeys, device=device)
    except Exception:
        brk.record_failure()
        raise
    brk.record_success()
    rec["outcome"] = "ok"
    rec["d2h_bytes"] = 64 * B
    _families.TRANSFER_BYTES.labels("sign", "d2h").inc(64 * B)
    _note_sign(op, B, "device")
    return out


def _check_sigs_resilient(msg_hashes: np.ndarray, sigs64: np.ndarray,
                          pubkeys33: np.ndarray, device) -> np.ndarray:
    """Batched sig-check under the "verify" breaker it shares with the
    gossip replay (the same kernels, the same health signal), one
    flight-recorded dispatch of its own family "check".  An open breaker
    raises ``BreakerOpen`` and a failed dispatch raises."""
    device = D.resolve(device)
    B = msg_hashes.shape[0]
    brk = _breaker.get("verify")
    corr = trace.new_corr()
    with _flight.dispatch("check", n_real=B, lanes=B, shape=(B, 32),
                          corr_ids=(corr.corr_id,),
                          breaker_state=brk.state) as rec:
        with trace.span("check/dispatch", corr=corr,
                        dispatch_id=rec["dispatch_id"]):
            if not brk.allow():
                raise _breaker.BreakerOpen("verify", brk.retry_in_s())
            try:
                _fault.fire("dispatch", "verify")
                out = E.ecdsa_verify_batch(msg_hashes, sigs64, pubkeys33,
                                           bucket=E.SIGN_BUCKET,
                                           device=device)
            except Exception:
                brk.record_failure()
                raise
            brk.record_success()
            rec["outcome"] = "ok"
            return out

# Capability bits (shape mirrors hsmd/permissions.h)
CAP_ECDH = 1
CAP_SIGN_GOSSIP = 2
CAP_SIGN_ONCHAIN = 4
CAP_SIGN_COMMITMENT = 8
CAP_MASTER = 0xFF


class HsmError(Exception):
    pass


@dataclass
class HsmClient:
    """A capability-scoped handle (one per subdaemon in Core Lightning,
    hsmd/hsm_control.c)."""

    hsm: "Hsm"
    caps: int
    channel_seed: bytes | None = None

    def _need(self, cap: int):
        if not (self.caps & cap):
            raise HsmError("capability denied")


def _compact(r: int, s: int) -> bytes:
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


class Hsm:
    """Owner of hsm_secret.  Channel basepoints and the shachain are
    deterministic from the one secret (the JAX package's scheme).  The
    batched calls run on `device`, the card unless device="cpu"."""

    def __init__(self, secret: bytes, device=None):
        assert len(secret) == 32
        self._secret = secret
        self.device = device
        self.node_key = self._derive_int(b"nodeid")
        self.node_pubkey = ref.pubkey_create(self.node_key)

    @classmethod
    def generate(cls, device=None) -> "Hsm":
        return cls(os.urandom(32), device)

    def _derive(self, tag: bytes) -> bytes:
        return hmac.new(self._secret, tag, hashlib.sha256).digest()

    def _derive_int(self, tag: bytes) -> int:
        v = int.from_bytes(self._derive(tag), "big") % ref.N
        return v or 1

    def client(self, caps: int, peer_id: bytes = b"",
               dbid: int = 0) -> HsmClient:
        chseed = None
        if dbid:
            chseed = self._derive(b"chan" + peer_id + dbid.to_bytes(8, "big"))
        return HsmClient(self, caps, chseed)

    # -- node-level ops ---------------------------------------------------

    def ecdh(self, client: HsmClient, point: ref.Point) -> bytes:
        client._need(CAP_ECDH)
        return hashlib.sha256(
            ref.pubkey_serialize(ref.point_mul(self.node_key, point))
        ).digest()

    def sign_node_announcement_hash(self, client: HsmClient, h32: bytes):
        client._need(CAP_SIGN_GOSSIP)
        return ref.ecdsa_sign(h32, self.node_key)

    def sign_channel_announcement(self, client: HsmClient,
                                  h32: bytes) -> tuple[bytes, bytes]:
        """(node_signature, bitcoin_signature) over a channel_announcement
        hash: the node identity key and the channel's funding key
        (hsmd_cannouncement_sig_req)."""
        client._need(CAP_SIGN_GOSSIP)
        secs = self.channel_secrets(client)
        return (_compact(*ref.ecdsa_sign(h32, self.node_key)),
                _compact(*ref.ecdsa_sign(h32, secs.funding)))

    # -- channel-level ops ------------------------------------------------

    def channel_secrets(self, client: HsmClient) -> K.BaseSecrets:
        if client.channel_seed is None:
            raise HsmError("client has no channel")
        return K.BaseSecrets.from_seed(client.channel_seed)

    def channel_basepoints(self, client: HsmClient) -> K.Basepoints:
        return self.channel_secrets(client).basepoints()

    def per_commitment_secret(self, client: HsmClient,
                              commitment_number: int) -> bytes:
        self.channel_secrets(client)            # a channel client only
        shaseed = hashlib.sha256(client.channel_seed + b"shachain").digest()
        return K.shachain_derive_secret(
            shaseed, K.LARGEST_INDEX - commitment_number)

    def per_commitment_point(self, client: HsmClient,
                             commitment_number: int) -> ref.Point:
        return K.per_commitment_point(
            self.per_commitment_secret(client, commitment_number))

    # -- batched signing: the HTLC fan-out --------------------------------

    def htlc_privkey(self, client: HsmClient,
                     remote_per_commitment_point: ref.Point) -> int:
        """Our HTLC key on the remote commitment at that point."""
        return K.derive_privkey(self.channel_secrets(client).htlc,
                                remote_per_commitment_point)

    def sign_htlc_batch(self, client: HsmClient, sighashes: list[bytes],
                        remote_per_commitment_point: ref.Point) -> np.ndarray:
        """Every HTLC sighash of a remote commitment in ONE device call
        (``engines.ecdsa_sign_batch``: S2 with four candidates), where
        Core Lightning makes one hsmd_sign_remote_htlc_tx round trip per
        HTLC.  Returns (N, 64) compact signatures."""
        client._need(CAP_SIGN_COMMITMENT)
        if not sighashes:
            return np.zeros((0, 64), np.uint8)
        with trace.span("hsmd/sign_htlc_batch", n=len(sighashes)):
            priv = self.htlc_privkey(client, remote_per_commitment_point)
            hashes = np.frombuffer(b"".join(sighashes),
                                   np.uint8).reshape(-1, 32)
            return _sign_batch_resilient("htlc", hashes,
                                         [priv] * len(sighashes),
                                         self.device)

    def sign_remote_commitment(self, client: HsmClient,
                               sighash: bytes) -> bytes:
        """The single funding-key signature on the remote commitment tx."""
        client._need(CAP_SIGN_COMMITMENT)
        return _compact(*ref.ecdsa_sign(
            sighash, self.channel_secrets(client).funding))

    # -- on-chain resolution signing (hsmd_wire.csv equivalents) ----------

    def sign_delayed_payment_to_us(self, client: HsmClient, sighash: bytes,
                                   per_commitment_point: ref.Point) -> bytes:
        """hsmd_sign_any_delayed_payment_to_us: our to_local claim after
        the CSV delay on OUR unilateral close."""
        client._need(CAP_SIGN_ONCHAIN)
        secs = self.channel_secrets(client)
        k = K.derive_privkey(secs.delayed_payment, per_commitment_point)
        return _compact(*ref.ecdsa_sign(sighash, k))

    def sign_penalty_to_us(self, client: HsmClient, sighash: bytes,
                           their_per_commitment_secret: int) -> bytes:
        """hsmd_sign_penalty_to_us: revocation-key spend of a REVOKED
        remote commitment's outputs."""
        client._need(CAP_SIGN_ONCHAIN)
        secs = self.channel_secrets(client)
        k = K.derive_revocation_privkey(secs.revocation,
                                        their_per_commitment_secret)
        return _compact(*ref.ecdsa_sign(sighash, k))

    def sign_to_remote_to_us(self, client: HsmClient,
                             sighash: bytes) -> bytes:
        """Claim our to_remote output on THEIR commitment (static
        remotekey: the plain payment basepoint)."""
        client._need(CAP_SIGN_ONCHAIN)
        return _compact(*ref.ecdsa_sign(
            sighash, self.channel_secrets(client).payment))

    def sign_remote_htlc_to_us(self, client: HsmClient, sighash: bytes,
                               per_commitment_point: ref.Point) -> bytes:
        """Claim an HTLC output on THEIR commitment (success with the
        preimage, or timeout), keyed by our HTLC basepoint at their
        point."""
        client._need(CAP_SIGN_ONCHAIN)
        return _compact(*ref.ecdsa_sign(
            sighash, self.htlc_privkey(client, per_commitment_point)))

    def check_sigs_batch(self, msg_hashes: np.ndarray, sigs: np.ndarray,
                         pubkeys: np.ndarray) -> np.ndarray:
        """Batched verify in ONE device call (the self-check Core
        Lightning makes per HTLC with check_tx_sig): the default engine
        pallas_fbj+pp, K1 + K2 + K3 on the card."""
        return _check_sigs_resilient(msg_hashes, sigs, pubkeys, self.device)
