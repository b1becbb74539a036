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
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as D
from ..crypto import field as F
from ..crypto import engines as E
from ..crypto import secp256k1 as S
from ..crypto import sha256 as SH
from ..utils import native
from . import wire
from .store import StoreIndex

DEFAULT_BUCKET = 65536
MAX_BLOCKS = 8  # 512-byte signed regions cover all standard gossip msgs


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
    """One bucket's host arrays, ready to upload."""

    sel: np.ndarray        # (n,) item indices in dispatch order
    blocks: np.ndarray     # (R, mb, 16) int64 words
    n_blocks: np.ndarray   # (R,) int64
    roi_local: np.ndarray  # (n,) int64, row within the bucket
    sigs: np.ndarray       # (n, 64) uint8
    pubkeys: np.ndarray    # (n, 33) uint8
    z_fix_rows: np.ndarray  # rows (within the bucket) hashed on the host
    z_fix: np.ndarray      # (len(z_fix_rows), 32) uint8 host sha256d


def _prep_bucket(items: VerifyItems, order, roi_sorted, chunk) -> _Bucket:
    start, end, r0, r1 = chunk
    sel = order[start:end]
    nb = items.n_blocks[r0:r1].astype(np.int64)
    mb = max(1, int(nb.max(initial=0)))
    blocks = SH.bytes_to_words(
        np.ascontiguousarray(items.rows[r0:r1, :mb * 64]), mb)
    fix = np.nonzero(nb == 0)[0]
    if len(fix) and items.z_host is None:
        raise ValueError("oversized rows (n_blocks == 0) require z_host")
    z_fix = items.z_host[r0 + fix] if len(fix) else np.zeros((0, 32), np.uint8)
    return _Bucket(sel, blocks, nb, roi_sorted[start:end] - r0,
                   items.sigs[sel], items.pubkeys[sel], fix, z_fix)


def verify_bucket(b: _Bucket, device: torch.device,
                  engine: str = E.DEFAULT_ENGINE) -> torch.Tensor:
    """One bucket on `device`: sha256d of its rows, host hashes for the
    oversized rows, z gather, byte unpack, then ECDSA under `engine`.
    Returns bool (n,) on `device`."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    z_rows = SH.digest_words_to_limbs(
        SH.sha256d_blocks(up(b.blocks), up(b.n_blocks)))
    if len(b.z_fix_rows):
        z_rows[up(b.z_fix_rows)] = F.from_bytes_be_dev(up(b.z_fix))
    z = z_rows[up(b.roi_local)]
    sig, pub = up(b.sigs), up(b.pubkeys)
    r = F.from_bytes_be_dev(sig[:, :32])
    s = F.from_bytes_be_dev(sig[:, 32:])
    qx = F.from_bytes_be_dev(pub[:, 1:])
    parity = pub[:, 0].to(torch.int64) & 1
    return E.ecdsa_verify_kernel(z, r, s, qx, parity, engine)


@torch.inference_mode()
def verify_items(items: VerifyItems, bucket: int = DEFAULT_BUCKET,
                 device=None, stats: dict | None = None,
                 engine: str = E.DEFAULT_ENGINE) -> np.ndarray:
    """Verify every signature of `items` on `device` (the card unless
    device="cpu") under the verify engine `engine`.  Returns bool (N,).
    `stats`, if given, receives the bucket count.  Inference mode is
    thread-local, so it is set here: the live ingest calls this on a
    worker thread."""
    dev = D.resolve(device)
    N = len(items)
    if stats is not None:
        stats["buckets"] = 0
    if N == 0:
        return np.zeros(0, bool)
    roi = items.row_index()
    order = np.argsort(roi, kind="stable")
    roi_sorted = roi[order]
    chunks = _plan_buckets(roi_sorted, bucket)
    sels, oks = [], []
    for c in chunks:
        b = _prep_bucket(items, order, roi_sorted, c)
        oks.append(verify_bucket(b, dev, engine))
        sels.append(b.sel)
    out = np.zeros(N, bool)
    out[np.concatenate(sels)] = torch.cat(oks).cpu().numpy()
    if stats is not None:
        stats["buckets"] = len(chunks)
    tag_ok = (items.pubkeys[:, 0] == 2) | (items.pubkeys[:, 0] == 3)
    return out & tag_ok


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
                 device=None,
                 engine: str = E.DEFAULT_ENGINE) -> StoreVerifyResult:
    """Verify every signature on every alive gossip message of a store
    on `device` (the card unless device="cpu") under the verify engine
    `engine`."""
    dev = D.resolve(device)
    t0 = time.perf_counter()
    items, (n_ca, n_na, n_cu), n_alive = extract_store(idx)
    t1 = time.perf_counter()
    stats: dict = {}
    ok = verify_items(items, bucket, dev, stats, engine)
    t2 = time.perf_counter()
    ca_ok = ok[:n_ca].reshape(4, -1).all(axis=0) if n_ca \
        else np.zeros(0, bool)
    return StoreVerifyResult(
        n_records=n_alive, n_sigs=len(items), ca_valid=ca_ok,
        cu_valid=ok[n_ca + n_na:], na_valid=ok[n_ca:n_ca + n_na],
        sig_ok=ok, items=items, buckets=stats["buckets"],
        seconds={"extract": t1 - t0, "verify": t2 - t1})
