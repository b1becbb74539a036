"""Batched gossip-signature verification on the card.

Core Lightning's gossipd checks each gossip signature inline and serially
(gossipd/sigcheck.c: four ECDSA verifies per channel_announcement, one
per channel_update and node_announcement, each after a sha256d).  Here a
whole store becomes flat arrays and the signatures verify in buckets:

  host:   mmap store -> native scan -> vectorized field gathers
  device: sha256d of the signed regions -> z-row gather -> byte unpack
          -> range checks -> prep -> u1, u2 -> dual mul -> projective
          x(R) = r check

under one verify engine (``crypto/engines.py``); the default,
``pallas_fbj+pp``, runs K1 prep -> GLV split and digits -> K2 tables ->
K3 scan.

Signatures are sorted by message row and cut into self-contained buckets
(``_plan_buckets``): a bucket's signatures reference only the bucket's
own rows, so each bucket hashes its rows and verifies its signatures
with no data from any other bucket.  Rows whose signed region does not
fit MAX_BLOCKS (n_blocks == 0) are hashed on the host; their signatures
still verify on the card, with the host hash.  The pubkey tag rule
(0x02 or 0x03) is applied on the host at the end.

The replay is a pipeline under supervision (``verify_items``): a
producer thread preps the buckets ahead of the dispatch loop, every
bucket dispatch runs under the "verify" circuit breaker and quarantine
bisection, each is one flight record (``obs/flight.py``), and the
``clntpu_replay_*`` counters split its time into prep, the prep stall
the dispatch thread sees, dispatch and the one readback.
"""
from __future__ import annotations

import functools
import hashlib
import logging
import queue as _queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as D
from .. import obs
from ..crypto import field as F
from ..crypto import engines as E
from ..crypto import secp256k1 as S
from ..crypto import sha256 as SH
from ..obs import families as _families
from ..obs import flight as _flight
from ..resilience import breaker as _breaker
from ..resilience import faultinject as _fault
from ..resilience import quarantine as _quarantine
from ..utils import native, trace
from . import wire
from .store import StoreIndex

DEFAULT_BUCKET = 65536
MAX_BLOCKS = 8  # 512-byte signed regions cover all standard gossip msgs

log = logging.getLogger("lightning_tpu_torch.gossip.verify")

# -- metrics (the JAX package's names, help texts and buckets) --------------
_M_FLUSH_SECONDS = obs.histogram(
    "clntpu_verify_flush_seconds",
    "End-to-end wall time of one verify_items replay (plan + stream + "
    "readback + host fallback)")
_M_BATCH_SIGS = obs.histogram(
    "clntpu_verify_batch_sigs",
    "Signatures per verify_items call", buckets=obs.SIZE_BUCKETS)
_M_OCCUPANCY = obs.histogram(
    "clntpu_verify_batch_occupancy_ratio",
    "Real lanes / padded lanes per verify_items call "
    "(1.0 = no bucket padding waste)", buckets=obs.RATIO_BUCKETS)
_M_LANES = obs.counter(
    "clntpu_verify_lanes_total",
    "Device lanes dispatched (real + pad), by kind",
    labelnames=("kind",))
_M_DEVICE_BYTES = obs.counter(
    "clntpu_verify_device_bytes_total",
    "Host->device bytes staged for verify dispatches")
# the port hashes these rows on the host and verifies them on the card
_M_OVERSIZED = obs.counter(
    "clntpu_verify_oversized_host_total",
    "Oversized rows (n_blocks == 0) verified on the host fallback path")
# the pipeline's stages: "prep" is the host's bucket build, "stall" the
# part of prep the dispatch thread waited for (all of it at depth 0),
# "dispatch" the upload and kernel enqueue, "readback" the one transfer
# of the verdicts; overlap = 1 - stall / prep
_M_R_PREP = _families.REPLAY_PREP
_M_R_STALL = _families.REPLAY_STALL
_M_R_DISPATCH = _families.REPLAY_DISPATCH
_M_R_READBACK = _families.REPLAY_READBACK
_M_R_OVERLAP = _families.REPLAY_OVERLAP
_M_R_QDEPTH = _families.REPLAY_QDEPTH
_M_R_BUCKETS = _families.REPLAY_BUCKETS
_M_TRANSFER = _families.TRANSFER_BYTES


@dataclass
class VerifyItems:
    """One flat signature-check workload.

    ``rows``, ``n_blocks``, ``z_host`` and the region arrays are per
    unique MESSAGE (M rows); sigs and pubkeys are per SIGNATURE (N
    items).  ``row_of_item`` maps each signature to its row (None: 1:1).
    ``region_off``/``region_len`` locate each row's signed region in the
    store buffer, for host re-checks."""

    rows: np.ndarray          # (M, MAX_BLOCKS*64) uint8 padded regions
    n_blocks: np.ndarray      # (M,) uint32; 0 = oversized, host-hashed
    sigs: np.ndarray          # (N, 64) uint8
    pubkeys: np.ndarray       # (N, 33) uint8
    msg_index: np.ndarray     # (N,) int64
    z_host: np.ndarray | None = None        # (M, 32) where n_blocks == 0
    row_of_item: np.ndarray | None = None   # (N,) int64
    region_off: np.ndarray | None = None    # (M,) uint64
    region_len: np.ndarray | None = None    # (M,) uint32

    @staticmethod
    def concat(items: list["VerifyItems"]) -> "VerifyItems":
        zh = None
        if any(x.z_host is not None for x in items):
            zh = np.concatenate([
                x.z_host if x.z_host is not None
                else np.zeros((x.rows.shape[0], 32), np.uint8)
                for x in items])
        rois, base = [], 0
        for x in items:
            roi = (np.arange(len(x), dtype=np.int64)
                   if x.row_of_item is None else x.row_of_item)
            rois.append(roi + base)
            base += x.rows.shape[0]

        def cat(name):
            parts = [getattr(x, name) for x in items]
            return None if any(p is None for p in parts) \
                else np.concatenate(parts)

        return VerifyItems(
            cat("rows"), cat("n_blocks"), cat("sigs"), cat("pubkeys"),
            cat("msg_index"), zh, np.concatenate(rois),
            cat("region_off"), cat("region_len"))

    def row_index(self) -> np.ndarray:
        if self.row_of_item is None:
            return np.arange(len(self), dtype=np.int64)
        return self.row_of_item

    def __len__(self):
        return len(self.sigs)


def _host_hash_oversized(buf, offsets, lengths, nb):
    """sha256d of the rows the packer flagged oversized (n_blocks == 0);
    None when there are none."""
    which = np.nonzero(nb == 0)[0]
    if len(which) == 0:
        return None
    z = np.zeros((len(nb), 32), np.uint8)
    for i in which:
        o, n = int(offsets[i]), int(lengths[i])
        z[i] = np.frombuffer(_sha256d(buf[o:o + n].tobytes()), np.uint8)
    return z


def _sha256d(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def _regions(idx: StoreIndex, signed_offset: int):
    off = idx.offsets + signed_offset
    ln = (idx.lengths - signed_offset).astype(np.uint32)
    rows, nb = native.sha256_pack(idx.buf, off, ln, MAX_BLOCKS)
    return rows, nb, _host_hash_oversized(idx.buf, off, ln, nb), off, ln


def _be_uint(raw: np.ndarray) -> np.ndarray:
    out = np.zeros(raw.shape[0], np.uint64)
    for b in range(raw.shape[1]):
        out = (out << np.uint64(8)) | raw[:, b].astype(np.uint64)
    return out


def extract_channel_announcements(idx: StoreIndex) -> VerifyItems:
    """Four (sig, key) pairs per channel_announcement, slot-major."""
    n = len(idx)
    if n == 0:
        return _empty_items()
    off = idx.offsets
    rows, nb, z_host, r_off, r_len = _regions(idx, wire.CA_SIGNED_OFFSET)
    flen = _be_uint(native.gather_fields(idx.buf, off, wire.CA_FLEN_OFFSET, 2))
    key_base = wire.CA_FLEN_OFFSET + 2 + flen + 32 + 8
    sigs, keys = [], []
    for i, sig_off in enumerate(wire.CA_SIG_OFFSETS):
        sigs.append(native.gather_fields(idx.buf, off, sig_off, 64))
        keys.append(native.gather_fields(idx.buf, off + key_base, 33 * i, 33))
    rep = np.tile(np.arange(n, dtype=np.int64), 4)
    return VerifyItems(rows, nb, np.concatenate(sigs), np.concatenate(keys),
                       rep, z_host, rep.copy(), r_off, r_len)


def extract_node_announcements(idx: StoreIndex) -> VerifyItems:
    n = len(idx)
    if n == 0:
        return _empty_items()
    off = idx.offsets
    rows, nb, z_host, r_off, r_len = _regions(idx, wire.NA_SIGNED_OFFSET)
    flen = _be_uint(native.gather_fields(idx.buf, off, 66, 2))
    sigs = native.gather_fields(idx.buf, off, wire.NA_SIG_OFFSET, 64)
    keys = native.gather_fields(idx.buf, off + flen, 68 + 4, 33)
    return VerifyItems(rows, nb, sigs, keys, np.arange(n, dtype=np.int64),
                       z_host, None, r_off, r_len)


def extract_channel_updates(idx: StoreIndex, scid_to_nodes) -> VerifyItems:
    """A channel_update is signed by the direction-selected node of its
    channel; scid_to_nodes maps (scid, direction) to that node's key."""
    n = len(idx)
    if n == 0:
        return _empty_items()
    off = idx.offsets
    rows, nb, z_host, r_off, r_len = _regions(idx, wire.CU_SIGNED_OFFSET)
    sigs = native.gather_fields(idx.buf, off, wire.CU_SIG_OFFSET, 64)
    scid = _be_uint(native.gather_fields(idx.buf, off, wire.CU_SCID_OFFSET, 8))
    flags = native.gather_fields(idx.buf, off, wire.CU_FLAGS_OFFSET + 1, 1)
    keys = scid_to_nodes(scid, flags[:, 0] & 1)
    return VerifyItems(rows, nb, sigs, keys, np.arange(n, dtype=np.int64),
                       z_host, None, r_off, r_len)


def message_items(msgs, update_key) -> VerifyItems:
    """Parsed gossip messages (wire objects) as one VerifyItems workload:
    one hashed row a message, row_of_item fanning a
    channel_announcement's 4 signatures onto its row (the store replay's
    layout).  A channel_update is checked against
    ``update_key(scid, direction)``, the 33-byte key of that endpoint of
    its channel; the other two kinds carry their signers."""
    regions: list[bytes] = []
    sigs: list[bytes] = []
    keys: list[bytes] = []
    midx: list[int] = []
    roi: list[int] = []
    for i, p in enumerate(msgs):
        row = len(regions)
        regions.append(p.signed_region())
        if p.TYPE == wire.MSG_CHANNEL_ANNOUNCEMENT:
            pairs = p.signature_tuples()
        elif p.TYPE == wire.MSG_CHANNEL_UPDATE:
            pairs = [(p.signature,
                      update_key(p.short_channel_id, p.direction))]
        else:  # node_announcement (self-signed)
            pairs = [(p.signature, p.node_id)]
        for sig, key in pairs:
            sigs.append(sig)
            keys.append(key)
            midx.append(i)
            roi.append(row)
    buf = np.frombuffer(b"".join(regions), np.uint8)
    lengths = np.array([len(r) for r in regions], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    rows, nb = native.sha256_pack(buf, offsets, lengths, MAX_BLOCKS)
    return VerifyItems(
        rows, nb, np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64),
        np.frombuffer(b"".join(k.ljust(33, b"\0") for k in keys),
                      np.uint8).reshape(-1, 33),
        np.array(midx, np.int64),
        _host_hash_oversized(buf, offsets, lengths, nb),
        np.array(roi, np.int64))


def _empty_items() -> VerifyItems:
    return VerifyItems(
        np.zeros((0, MAX_BLOCKS * 64), np.uint8), np.zeros(0, np.uint32),
        np.zeros((0, 64), np.uint8), np.zeros((0, 33), np.uint8),
        np.zeros(0, np.int64), None, None,
        np.zeros(0, np.uint64), np.zeros(0, np.uint32))


def make_scid_map(ca_idx: StoreIndex):
    """scid -> node_id_1 | node_id_2 resolver built from the
    channel_announcements (sorted array + searchsorted).  An unknown scid
    resolves to the zero key, which fails verification."""
    n = len(ca_idx)
    if n == 0:
        return lambda scids, direction: np.zeros((len(scids), 33), np.uint8)
    off = ca_idx.offsets
    flen = _be_uint(native.gather_fields(ca_idx.buf, off,
                                         wire.CA_FLEN_OFFSET, 2))
    scid = _be_uint(native.gather_fields(
        ca_idx.buf, off + flen, wire.CA_FLEN_OFFSET + 2 + 32, 8))
    key_base = wire.CA_FLEN_OFFSET + 2 + flen + 40
    node1 = native.gather_fields(ca_idx.buf, off + key_base, 0, 33)
    node2 = native.gather_fields(ca_idx.buf, off + key_base, 33, 33)
    order = np.argsort(scid, kind="stable")
    scid_sorted = scid[order]
    node1s, node2s = node1[order], node2[order]

    def lookup(scids: np.ndarray, direction: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(scid_sorted, scids)
        pos_c = np.clip(pos, 0, n - 1)
        found = (pos < n) & (scid_sorted[pos_c] == scids)
        keys = np.where((direction == 0)[:, None], node1s[pos_c],
                        node2s[pos_c])
        keys[~found] = 0
        return keys

    return lookup


# ---------------------------------------------------------------------------
# Buckets


def _plan_buckets(roi_sorted: np.ndarray, bucket: int) -> list[tuple]:
    """Cut the row-sorted signature stream into self-contained buckets of
    at most `bucket` signatures AND at most `bucket` distinct rows.  A row
    whose signatures straddle a cut is hashed by both buckets.  Returns
    [(sig_start, sig_end, row_start, row_end), ...]."""
    N = len(roi_sorted)
    out = []
    start = 0
    while start < N:
        cap = min(start + bucket, N)
        r0 = int(roi_sorted[start])
        end = start + int(np.searchsorted(roi_sorted[start:cap],
                                          r0 + bucket, side="left"))
        out.append((start, end, r0, int(roi_sorted[end - 1]) + 1))
        start = end
    return out


@dataclass
class _Bucket:
    """One bucket's host operands, ready to upload: numpy arrays, or
    pinned tensors when the bucket goes to the card."""

    sel: np.ndarray        # (n,) item indices in dispatch order
    blocks: object         # (R, mb, 16) int64 words
    n_blocks: object       # (R,) int64
    roi_local: object      # (n,) int64, row within the bucket
    sigs: object           # (n, 64) uint8
    pubkeys: object        # (n, 33) uint8
    z_fix_rows: object     # rows (within the bucket) hashed on the host
    z_fix: object          # (len(z_fix_rows), 32) uint8 host sha256d
    staged_bytes: int = 0
    prep_seconds: float = 0.0


_OPERANDS = ("blocks", "n_blocks", "roi_local", "sigs", "pubkeys",
             "z_fix_rows", "z_fix")


_TORCH_DTYPE = {np.int64: torch.int64, np.uint8: torch.uint8}


def _host_array(shape, dtype, pin: bool):
    """An empty host operand: for the card a pinned tensor (the array to
    fill is its numpy view), so the upload is asynchronous with no
    second copy; a numpy array otherwise.  Returns (operand, array)."""
    if not pin:
        a = np.empty(shape, dtype)
        return a, a
    t = torch.empty(shape, dtype=_TORCH_DTYPE[dtype], pin_memory=True)
    return t, t.numpy()


def _prep_bucket(items: VerifyItems, order, roi_sorted, chunk,
                 pin: bool = False, corrs=()) -> _Bucket:
    """Host side of one bucket: slice the rows and signatures and pack
    the hash rows into words, written straight into pinned memory for
    the card.  Host work only: it runs on the replay's producer
    thread."""
    with trace.span("replay/prep", corr=corrs):
        t0 = time.perf_counter()
        _fault.fire("prep", "verify")
        start, end, r0, r1 = chunk
        sel = order[start:end]
        n, R = end - start, r1 - r0
        nb = items.n_blocks[r0:r1]
        mb = max(1, int(nb.max(initial=0)))
        fix = np.nonzero(nb == 0)[0]
        if len(fix) and items.z_host is None:
            raise ValueError("oversized rows (n_blocks == 0) require z_host")
        ops, arr = {}, {}
        for k, shape, dtype in (
                ("blocks", (R, mb, 16), np.int64), ("n_blocks", R, np.int64),
                ("roi_local", n, np.int64), ("sigs", (n, 64), np.uint8),
                ("pubkeys", (n, 33), np.uint8),
                ("z_fix_rows", len(fix), np.int64),
                ("z_fix", (len(fix), 32), np.uint8)):
            ops[k], arr[k] = _host_array(shape, dtype, pin)
        SH.bytes_to_words(items.rows[r0:r1], mb, out=arr["blocks"])
        np.copyto(arr["n_blocks"], nb)
        np.subtract(roi_sorted[start:end], r0, out=arr["roi_local"])
        np.take(items.sigs, sel, axis=0, out=arr["sigs"])
        np.take(items.pubkeys, sel, axis=0, out=arr["pubkeys"])
        arr["z_fix_rows"][:] = fix
        if len(fix):
            arr["z_fix"][:] = items.z_host[r0 + fix]
        staged = sum(a.nbytes for a in arr.values())
        return _Bucket(sel, **ops, staged_bytes=staged,
                       prep_seconds=time.perf_counter() - t0)


def _upload(a, device: torch.device) -> torch.Tensor:
    """One operand onto `device`: asynchronous from pinned memory (the
    caching host allocator keeps the block until the copy has run, so
    the caller may drop it at once), a plain copy otherwise."""
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=a.is_pinned())
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def verify_bucket(b: _Bucket, device: torch.device,
                  engine: str = E.DEFAULT_ENGINE) -> torch.Tensor:
    """One bucket on `device`: sha256d of its rows, host hashes for the
    oversized rows, z gather, byte unpack, then ECDSA under `engine`.
    Returns bool (n,) on `device`."""
    blocks, n_blocks, roi_local, sig, pub, z_fix_rows, z_fix = (
        _upload(getattr(b, k), device) for k in _OPERANDS)
    z_rows = SH.digest_words_to_limbs(SH.sha256d_blocks(blocks, n_blocks))
    if len(b.z_fix_rows):
        z_rows[z_fix_rows] = F.from_bytes_be_dev(z_fix)
    z = z_rows[roi_local]
    r = F.from_bytes_be_dev(sig[:, :32])
    s = F.from_bytes_be_dev(sig[:, 32:])
    qx = F.from_bytes_be_dev(pub[:, 1:])
    parity = pub[:, 0].to(torch.int64) & 1
    return E.ecdsa_verify_kernel(z, r, s, qx, parity, engine)


def _subbucket(b: _Bucket, lanes: np.ndarray) -> _Bucket:
    """A subset of a bucket's signature lanes as a bucket of its own.
    The hash rows are shared; only the per-signature operands and their
    row indices narrow."""
    def take(a):
        return a[torch.from_numpy(lanes)] if isinstance(a, torch.Tensor) \
            else a[lanes]

    return _Bucket(b.sel[lanes], b.blocks, b.n_blocks, take(b.roi_local),
                   take(b.sigs), take(b.pubkeys), b.z_fix_rows, b.z_fix)


# ---------------------------------------------------------------------------
# The supervised, pipelined replay


class CardLost(RuntimeError):
    """A dispatch failed and the card no longer answers: the CUDA context
    is lost (a sticky error fails every later call on it), so nothing is
    bisected or dispatched again."""


def _card_answers(device: torch.device) -> bool:
    """True unless `device` is a card whose synchronize raises."""
    if device.type != "cuda":
        return True
    try:
        torch.cuda.synchronize(device)
    except Exception:
        return False
    return True


def _merge(n: int, parts, device: torch.device) -> torch.Tensor:
    """Scatter bisected parts' verdicts into one (n,) result on `device`;
    lanes no part covers (quarantined) stay False."""
    out = torch.zeros(n, dtype=torch.bool, device=device)
    for lanes, res in parts:
        out[torch.from_numpy(lanes).to(device)] = res.to(device)
    return out


def _wrap_resilient(device_fn, device: torch.device, quarantined: list,
                    corrs=(), sink: list | None = None):
    """Supervise one bucket dispatcher with the "verify" circuit breaker
    and poisoned-batch quarantine:

    * breaker open: raises ``BreakerOpen``;
    * dispatch raises and the card still answers: the breaker records
      the failure and the bucket bisects, its clean sub-buckets on the
      card; the isolated rows go to ``quarantined``;
    * dispatch raises and the card does not answer: ``CardLost`` at
      once, with no bisection.

    Nothing is re-checked on the host.  Every call is one
    flight-recorded dispatch: the record lands in ``sink`` (dispatch
    order) and its span carries the replay's corr carriers.  A
    successful dispatch's record is sealed at the readback, which
    decides its final outcome (flight.defer); a raising one is sealed at
    once.  ``dispatch_ms`` is the host's enqueue time."""
    brk = _breaker.get("verify")
    corr_ids = _flight.corr_ids(corrs)

    def attempt(b: _Bucket):
        def run(lanes):
            try:
                return device_fn(_subbucket(b, lanes))
            except Exception as e:
                if not _card_answers(device):
                    raise CardLost(f"the card stopped answering: {e}") from e
                raise
        return run

    def _dispatch_inner(b: _Bucket, rec: dict) -> torch.Tensor:
        n = len(b.sel)
        if not brk.allow():
            raise _breaker.BreakerOpen("verify", brk.retry_in_s())
        try:
            _fault.fire("dispatch", "verify")
            rec["h2d_bytes"] = b.staged_bytes
            _M_TRANSFER.labels("verify", "h2d").inc(b.staged_bytes)
            ok = device_fn(b)
        except Exception as e:
            brk.record_failure()
            if not _card_answers(device):
                raise CardLost(f"the card stopped answering: {e}") from e
            rec["outcome"] = "bisect"
            rec["error"] = type(e).__name__
            log.warning("verify bucket dispatch failed (%s); bisecting %d "
                        "lanes", e, n)
            parts, bad = _quarantine.bisect(np.arange(n), attempt(b),
                                            family="verify",
                                            fatal=(CardLost,))
            quarantined.extend(b.sel[np.asarray(bad, np.int64)].tolist())
            return _merge(n, parts, device)
        brk.record_success()
        rec["outcome"] = "ok"
        return ok

    def dispatch(b: _Bucket, queue_wait: float = 0.0) -> torch.Tensor:
        rec = _flight.begin(
            "verify", corr_ids=corr_ids,
            shape=(len(b.sel), int(b.blocks.shape[1])), n_real=len(b.sel),
            lanes=len(b.sel), queue_wait_ms=queue_wait * 1e3,
            prep_ms=b.prep_seconds * 1e3, breaker_state=brk.state)
        if sink is not None:
            sink.append(rec)
        t0 = time.perf_counter()
        try:
            with trace.span("verify/dispatch", corr=corrs,
                            dispatch_id=rec["dispatch_id"]):
                with trace.annotation("verify/dispatch", device):
                    ok = _dispatch_inner(b, rec)
        except BaseException as e:
            if rec["outcome"] is None:
                rec["outcome"] = "error"
            _flight.finish(rec,
                           dispatch_ms=(time.perf_counter() - t0) * 1e3,
                           error=type(e).__name__)
            raise
        rec["dispatch_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        _flight.defer(rec)
        return ok

    return dispatch


_DONE = object()


def _to_host(oks: list) -> list:
    """Every bucket's verdict tensor on the host: ONE device-to-host
    transfer for all of them."""
    flat = torch.cat([ok.reshape(-1) for ok in oks]).cpu().numpy()
    out, pos = [], 0
    for ok in oks:
        out.append(flat[pos:pos + ok.numel()])
        pos += ok.numel()
    return out


def _run_pipeline(items: VerifyItems, roi: np.ndarray, bucket: int,
                  depth: int, device_fn, device: torch.device,
                  quarantined: list, corrs=(),
                  dispatch_map: np.ndarray | None = None):
    """Sort signatures by row, cut self-contained buckets, and stream
    them: a producer thread preps bucket i+1 while bucket i is dispatched
    to the card.  ``depth`` bounds the prepared-bucket queue; depth 0 is
    serial (prep inline on the dispatch thread, the baseline the overlap
    metrics are read against).  Returns (out, n_buckets, stage seconds).
    """
    N = len(items)
    order = np.argsort(roi, kind="stable")
    roi_sorted = roi[order]
    chunks = _plan_buckets(roi_sorted, bucket)
    # every bucket dispatch (injected test doubles included) runs under
    # the breaker and quarantine, and is one flight-recorded dispatch
    # whose record lands in `flight_recs` (dispatch order)
    flight_recs: list[dict] = []
    dispatch = _wrap_resilient(device_fn, device, quarantined, corrs=corrs,
                               sink=flight_recs)
    prep = functools.partial(_prep_bucket, items, order, roi_sorted,
                             pin=device.type == "cuda", corrs=corrs)

    out = np.zeros(N, bool)
    # pending holds (sel, verdicts) only: keeping the _Bucket would pin
    # every bucket's host operands (about the re-packed store) until the
    # final readback
    pending: list[tuple[np.ndarray, torch.Tensor]] = []
    t_prep = t_stall = t_dispatch = 0.0
    staged_bytes = 0

    def run(b: _Bucket, wait: float, visible: float) -> None:
        nonlocal t_prep, t_stall, t_dispatch, staged_bytes
        t_prep += b.prep_seconds
        t_stall += visible
        t0 = time.perf_counter()
        ok = dispatch(b, queue_wait=wait)
        t_dispatch += time.perf_counter() - t0
        staged_bytes += b.staged_bytes
        if dispatch_map is not None:
            dispatch_map[b.sel] = flight_recs[-1]["dispatch_id"]
        pending.append((b.sel, ok))

    try:
        if depth > 0 and len(chunks) > 1:
            q: _queue.Queue = _queue.Queue(maxsize=depth)
            stop = threading.Event()  # the dispatch loop ended: stop

            def _put(item) -> bool:
                # stop-aware: a producer raced by a dispatch failure
                # never blocks forever on a full queue nobody drains
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        return True
                    except _queue.Full:
                        pass
                return False

            def _producer():
                try:
                    for c in chunks:
                        if stop.is_set():
                            return
                        _fault.fire("producer", "verify")
                        if not _put(prep(c)):
                            return
                    _put(_DONE)
                except BaseException as e:  # surfaces on the dispatch thread
                    _put(e)

            th = threading.Thread(target=_producer, name="replay-prep",
                                  daemon=True)
            th.start()
            try:
                while True:
                    t0 = time.perf_counter()
                    b = q.get()
                    wait = time.perf_counter() - t0
                    if b is _DONE:
                        t_stall += wait
                        break
                    if isinstance(b, BaseException):
                        raise b
                    _M_R_QDEPTH.observe(q.qsize() + 1)
                    run(b, wait, wait)
            finally:
                # a producer parked on a full queue after the dispatch
                # loop raised is told to stop and drained until it exits
                stop.set()
                while th.is_alive():
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        pass
                    th.join(timeout=0.005)
        else:
            for c in chunks:
                b = prep(c)
                run(b, 0.0, b.prep_seconds)   # serial: all prep is visible

        # the ONLY device-to-host transfer of the replay
        t0 = time.perf_counter()
        brk = _breaker.get("verify")
        with trace.span("replay/readback", corr=corrs, buckets=len(pending)):
            try:
                host, lost = _to_host([ok for _, ok in pending]), None
            except Exception as e:
                host, lost = None, e
            t_xfer = time.perf_counter() - t0
            for i, ((sel, _), rec) in enumerate(zip(pending, flight_recs)):
                t0b = time.perf_counter()
                try:
                    _fault.fire("readback", "verify")
                    if lost is not None:
                        raise lost
                except Exception as e:
                    brk.record_failure()
                    rec["outcome"] = "error"
                    rec["error"] = type(e).__name__
                    raise
                out[sel] = host[i]
                rec["d2h_bytes"] = host[i].nbytes
                _M_TRANSFER.labels("verify", "d2h").inc(host[i].nbytes)
                # each bucket waited for the one transfer, then its slice
                rec["readback_ms"] = round(
                    (t_xfer + time.perf_counter() - t0b) * 1e3, 3)
                _flight.finish(rec)
        t_readback = time.perf_counter() - t0
    finally:
        # records of buckets whose readback never came (the replay
        # raised) are sealed too; finish() leaves sealed ones alone
        for rec in flight_recs:
            _flight.finish(rec)

    _M_R_READBACK.inc(t_readback)
    _M_R_PREP.inc(t_prep)
    _M_R_STALL.inc(t_stall)
    _M_R_DISPATCH.inc(t_dispatch)
    if t_prep > 0:
        _M_R_OVERLAP.observe(max(0.0, 1.0 - t_stall / t_prep))
    lanes = sum(len(sel) for sel, _ in pending)
    _M_LANES.labels("verify").inc(lanes)
    _M_LANES.labels("hash").inc(lanes)
    _M_DEVICE_BYTES.inc(staged_bytes)
    return out, len(chunks), {"prep": t_prep, "prep_stall": t_stall,
                              "dispatch": t_dispatch,
                              "readback": t_readback}


@torch.inference_mode()
def verify_items(items: VerifyItems, bucket: int = DEFAULT_BUCKET,
                 device=None, stats: dict | None = None,
                 engine: str = E.DEFAULT_ENGINE, *, depth: int = 2,
                 device_fn=None, corr=None,
                 dispatch_map: np.ndarray | None = None) -> np.ndarray:
    """Verify every signature of `items` on `device` (the card unless
    device="cpu") under the verify engine `engine`.  Returns bool (N,).

    The replay streams self-contained buckets: a producer thread preps
    bucket i+1 (host numpy, pinned for the card) while bucket i is
    dispatched, ``depth`` buckets ahead (0: serial).  The verdicts stay
    on the card until one readback at the end.  Every bucket dispatch is
    supervised by the "verify" breaker and quarantine bisection
    (``_wrap_resilient``), and is one flight record; the
    ``clntpu_replay_*`` counters split the time into prep, prep stall,
    dispatch and readback.

    Nothing is re-checked on the host: an open breaker raises
    ``BreakerOpen``, a failed readback raises, and rows isolated by
    bisection raise ``Quarantined`` once every other bucket is done (its
    ``verdicts`` hold every other row's result, the isolated rows
    False).

    `device_fn` replaces the bucket dispatcher (tests): it takes a
    bucket and returns its (n,) bool verdict tensor.  `stats`, if given,
    receives the bucket count and the stage seconds; ``corr`` (a
    trace.Carrier or a list of them) rides every span and flight record
    of the replay.  ``dispatch_map`` (int64 (N,), caller-allocated), if
    given, receives each signature's flight-record dispatch_id.
    Inference mode is thread-local, so it is set here:
    the live ingest calls this on a worker thread."""
    dev = D.resolve(device)
    N = len(items)
    if stats is not None:
        stats.update(buckets=0, prep=0.0, prep_stall=0.0, dispatch=0.0,
                     readback=0.0)
    if N == 0:
        return np.zeros(0, bool)
    t_start = time.perf_counter()
    corrs = trace.as_carriers(corr)
    roi = items.row_index()
    if device_fn is None:
        def device_fn(b):
            _M_R_BUCKETS.labels("card").inc()
            return verify_bucket(b, dev, engine)
    quarantined: list[int] = []
    out, n_buckets, stages = _run_pipeline(
        items, roi, bucket, depth, device_fn, dev, quarantined, corrs=corrs,
        dispatch_map=dispatch_map)
    if stats is not None:
        stats["buckets"] = n_buckets
        stats.update(stages)
    n_over = int((items.n_blocks[roi] == 0).sum())
    if n_over:
        _M_OVERSIZED.inc(n_over)
    _M_BATCH_SIGS.observe(N)
    _M_OCCUPANCY.observe(N / (n_buckets * bucket))
    _M_FLUSH_SECONDS.observe(time.perf_counter() - t_start)
    tag_ok = (items.pubkeys[:, 0] == 2) | (items.pubkeys[:, 0] == 3)
    out &= tag_ok
    if quarantined:
        rows = sorted(quarantined)
        out[rows] = False
        raise _quarantine.Quarantined("verify", rows, out)
    return out


def host_verify_items(items: VerifyItems, buf: np.ndarray,
                      which: np.ndarray) -> np.ndarray:
    """The exact-int host oracle on the signatures `which`, with z hashed
    by hashlib from each signed region of the store buffer `buf`."""
    rows = items.row_index()[which]
    z = np.zeros((len(rows), 32), np.uint8)
    for i, r in enumerate(rows):
        o, n = int(items.region_off[r]), int(items.region_len[r])
        z[i] = np.frombuffer(_sha256d(buf[o:o + n].tobytes()), np.uint8)
    return S.host_verify_batch(z, items.sigs[which], items.pubkeys[which])


@dataclass
class StoreVerifyResult:
    n_records: int
    n_sigs: int
    ca_valid: np.ndarray   # per channel_announcement (all 4 sigs)
    cu_valid: np.ndarray
    na_valid: np.ndarray
    sig_ok: np.ndarray     # per signature: CA slot-major, then NA, CU
    items: VerifyItems
    buckets: int = 0
    seconds: dict = field(default_factory=dict)


def extract_store(idx: StoreIndex):
    """All alive gossip signatures of a store as one VerifyItems (CA
    slot-major, then NA, then CU) and the per-type counts."""
    alive = idx.select(idx.alive())
    ca = alive.select(alive.types == wire.MSG_CHANNEL_ANNOUNCEMENT)
    na = alive.select(alive.types == wire.MSG_NODE_ANNOUNCEMENT)
    cu = alive.select(alive.types == wire.MSG_CHANNEL_UPDATE)
    items_ca = extract_channel_announcements(ca)
    items_na = extract_node_announcements(na)
    items_cu = extract_channel_updates(cu, make_scid_map(ca))
    items = VerifyItems.concat([items_ca, items_na, items_cu])
    return items, (len(items_ca), len(items_na), len(items_cu)), len(alive)


def verify_store(idx: StoreIndex, bucket: int = DEFAULT_BUCKET,
                 device=None, engine: str = E.DEFAULT_ENGINE, *,
                 depth: int = 2) -> StoreVerifyResult:
    """Verify every signature on every alive gossip message of a store
    on `device` (the card unless device="cpu") under the verify engine
    `engine`, the replay's buckets prepped `depth` ahead.  ``seconds``
    holds extract and verify, and the verify's stages: prep, prep_stall,
    dispatch and readback."""
    dev = D.resolve(device)
    t0 = time.perf_counter()
    with trace.span("gossip/extract", records=int(len(idx))):
        items, (n_ca, n_na, n_cu), n_alive = extract_store(idx)
    t1 = time.perf_counter()
    stats: dict = {}
    with trace.span("gossip/verify", sigs=int(len(items))):
        # the replay's enqueue point: every bucket's prep, dispatch and
        # readback span carries this carrier
        ok = verify_items(items, bucket, dev, stats, engine, depth=depth,
                          corr=trace.new_corr())
    t2 = time.perf_counter()
    ca_ok = ok[:n_ca].reshape(4, -1).all(axis=0) if n_ca \
        else np.zeros(0, bool)
    return StoreVerifyResult(
        n_records=n_alive, n_sigs=len(items), ca_valid=ca_ok,
        cu_valid=ok[n_ca + n_na:], na_valid=ok[n_ca:n_ca + n_na],
        sig_ok=ok, items=items, buckets=stats["buckets"],
        seconds={"extract": t1 - t0, "verify": t2 - t1,
                 **{k: stats[k] for k in ("prep", "prep_stall", "dispatch",
                                          "readback")}})
