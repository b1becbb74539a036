#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lightning_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 7] [--channels 100000] [--nodes 12500]
                          [--bucket 65536] [--mainnet]
                          [--ingest-channels 10000] [--ingest-nodes 1250]
                          [--ingest-runs 1]

Phases, each fatal on failure:

1. device and build: the card's name and power limit; the ten CUDA
   kernels (the verify path's K1-K6, the sign path's S1 and S2, the
   routing path's R1 and R2) built for sm_90a with nvcc, all at once,
   with each one's ptxas report, and the blocks an SM holds of K2-K6, S1,
   S2, R1 and R2; the CALL instructions in R1's and R2's SASS
   (cuobjdump -sass; a call of the int64 division routine is one), which
   must be none;
2. each kernel against its plain PyTorch version on the card, at the
   bucket size, a ragged batch (bucket + 37) and edge inputs, compared
   exactly after normalization mod p or n: K5 also with every digit 0
   (the table's infinity entry) and every digit 15, at both sizes; K1 on
   edge x and s, and at the ragged size with s = 0, n and 2^256 - 1 at
   the first and last thread of its first two blocks and at B - 1; K2 on
   carry-edge coordinates (0, 1, p - 1, p - 2, p, words of all ones);
   every kernel engine's dual multiplication on edge scalars (u = 0, 1,
   n - 1 on both sides, and u1*G = -u2*Q) on the card, in the plain path
   and in the exact-int oracle; a verify batch of edge signatures (s = 0,
   off-curve x, u = 0, u = n - 1, r < p - n, high S, bad tag) under every
   kernel engine, on the card, in the plain path and in the oracle; S1
   and S2 (C = 1 and C = 4) at the bucket size and bucket + 37, with edge
   rows (k = 0, 1, n - 1, n, digits of 0, z = 2^256 - 1, z >= n, a row
   with no low-R nonce among its four RFC6979 candidates), and S2 on a
   1,024-row sample against the exact-int four-candidate rule, which must
   hold rows with no low-R candidate;
3. the main path: a synthetic gossip_store (612,500 signatures by
   default, with seeded corrupted signatures, an off-curve key, a bad key
   tag and oversized rows) through load_store -> check_crcs ->
   verify_store(device="cuda") under the default engine pallas_fbj+pp;
   the verdicts must be exactly "every signature valid except the seeded
   faults", a sample must agree with the exact-int host oracle, and each
   of K1-K3's launch counts must equal the bucket count;
3b. the same store replayed under each other kernel engine (pallas+pp,
   pallas_v2+pp, pallas_glv+pp, pallas_fb+pp, pallas_fb): exactly the
   seeded verdicts again, and the bucket count of launches for exactly
   that engine's kernels, 0 for the others;
4. timing: each kernel's ms per call at the bucket size (CUDA events),
   its plain version's ms and its bound; K3, K4 and K5 once more with
   every digit (and K3's joint index) one fixed value (coalesced or
   broadcast reads: the gap is what their gathers cost); K1's bound with
   its batch inversion beside the bound of a Fermat chain per signature;
   S1 and S2 (C = 4), their bounds counted from what the data needs (the
   nonzero digits, the candidates up to the first low R) with one Fermat
   chain a block, beside the bound with a chain per row; S2 also at C = 1
   and at a commitment's 483 rows;
5. the sign path at full width, with the launch counters set to 0 just
   before and read just after: one remote commitment with BOLT #2's 483
   HTLCs (anchors on) built by channel/commitment.py, signed by
   Hsm.sign_htlc_batch (S2) and checked by Hsm.check_sigs_batch (K1 + K2
   + K3), every signature the exact-int rule's; the bulk fan-out of 136
   such commitments, each with its own HTLC key, 65,688 sighashes in one
   ecdsa_sign_batch call (host nonce and device seconds apart), all
   verifying, a 1,024-row sample the exact-int rule's; derive_pubkeys of
   a bucket of keys (S1), a 1,024-row sample against ref.pubkey_create;
   schnorr_verify_batch (K2 + K3) on 1,024 signatures and 64 flipped
   ones, exact.
6. live gossip ingest at the width of a regtest 10k-channel node: a
   synth store of 10,000 channels and 1,250 nodes (61,250 signatures,
   faults seeded as in phase 3) fed message by message through
   gossip/ingest.py's GossipIngest on the card, as gossipd feeds it
   (wait_capacity, then submit; the reference's flush size, window and
   watermarks), with 100 exact duplicates, about 5 % of the updates and
   node announcements before their channel, and 20 updates re-signed
   with an older timestamp fed after a drain (the gap wave: related
   messages the backlog's hard cap apart); then the same store to a new
   ingest in BOLT #7's sync order (each channel_announcement, its
   channel_updates, its nodes' announcements); each wave with the launch
   counters set to 0 just before and read just after.  Each wave's
   stats, state tables, pending maps and stored multiset must equal a
   sequential model of the ingest's rules given the live run's sheds
   (the BOLT #7 wave's pending count plus the updates held live for a
   channel still queued); K1-K3 launch once a flush; each written store
   replays all true on the card and its gossmap has the model's
   channels and nodes; a 1,024-message sample of the gap wave's store
   agrees with the exact-int oracle; a copy of it torn mid-record with 8
   corrupted timestamps recovers with the torn record cut and the 8
   requalified by a re-check on the card.  With --ingest-runs N the
   phase runs N times, each after a reading of K3, and prints the
   spread.
7. routing over phase 3's graph (100,000 channels, 12,500 nodes by
   default): R1 against its plain version on the 1,024 queries of the
   route mix, 64 a launch, with each query's sweeps run and edges priced
   (median and maximum), and R2 on 8 of the mcf mix and 8 multi-part
   ones with each query's rounds and arcs visited (mismatches counted
   exactly, each R2 dispatch timed); each kernel's time at every cluster
   size (R2's labels in shared memory where they fit), each size equal
   to the plain version, and the clusters the card holds at once; then,
   with the launch counters set to 0 just before and read just after,
   1,093 getroute queries (bench.py route's
   1,024, 64 log-uniform amounts with some excluded scids, five named
   edge cases) through solve_batch and 1,024 through RouteService, and
   66 getroutes queries (bench.py mcf's 64, one with reservations,
   biases and a disabled scid, one over a layer-created channel that
   the host must answer) through solve_mcf_batch and McfService; the
   services' answers equal solve_batch's; samples of 64 and 16 against
   dijkstra.getroute and mcf.getroutes; 100 channel_updates patched
   into the planes, equal to a fresh build; R1 and R2 timed.
8. the supervised, pipelined replay of phase 3's store, with the launch
   counters set to 0 just before and read just after: three replays
   through verify_store at depth 0 (serial prep) and three at depth 2
   (a producer thread preps two buckets ahead), in turns, each with
   phase 3's verdicts; the medians of sig/s, prep, prep stall, dispatch
   and readback seconds and the overlap ratio, each a delta of
   obs.snapshot(), and the flight ring's "verify" summary; a replay with
   dispatch:verify:raise:0.3 armed and a dispatcher that rejects 4
   signatures: it raises Quarantined with exactly those rows, every
   other verdict phase 3's, every clean sub-bucket launched on the card
   and the dispatch outcomes counted equal to the flight records' (the
   4 rows, checked here by the host oracle, are phase 3's too); one
   supervised sign_htlc_batch and check_sigs_batch of phase 5's width,
   both flight records "ok", clntpu_sign_total{path="device"} counted.
9. supervised routing and the observability spine over phase 7's graph,
   every journey sampled: (9.1) the route mix's 1,024 getroute queries
   through RouteService in waves of 64 and the mcf mix's 64 getroutes
   (each with a journey key) through McfService in waves of 8 (a flush a
   wave, for the flush percentiles), with the launch counters set to 0
   just before and read just after: the answers solve_batch's and
   solve_mcf_batch's on the same graph, one flight record a flush, all
   "ok", the clntpu_dispatches_total deltas the records', the device
   queries counted, R1's and R2's launches the records' batches, the
   records' staged bytes the clntpu_transfer_bytes_total deltas; the
   attribution report of the route, mcf and verify families (the kernel
   rate 65,536 over phase 4's K1 + K2 + K3 ms) and the card's memory;
   (9.2) with an incident recorder and a health engine on an injected
   clock: dispatch:route:raise:1.0 for seven flushes (five "error", the
   breaker opens, two "breaker" refused with BreakerOpen and no launch),
   the engine ticked past the breaker_open SLO's 5 s (in breach, not
   healthy), then disarmed, after the backoff a half-open probe and one
   more flush "ok" and exact, and a hang with a 0.05 s deadline on a
   fresh service ("deadline", its queries failing); no host dijkstra but
   the exactness rows; (9.3) exactly one incident bundle, breaker_open,
   the deadline and SLO breach absorbed, its seven artifacts, a
   trace.json that validates with route/flush and mcf/flush spans and
   their flight events; the engine healthy again; every MCF journey
   enqueue -> mcf_flush -> parts.
10. peer gossip at the width of a regtest 10k-channel node, with the
   launch counters set to 0 just before and read just after: node A, a
   LightningNode with a Gossipd on the card, loads a synth store of
   10,000 channels and 1,250 nodes (61,250 signatures, seed 7, no
   faults) with load_existing(verify=True), K1-K3 on the card; blank node
   B dials A over loopback TCP with BOLT #8 Noise and its Seeker (seeded
   rng, a fixed clock) ticks until B's accepted channels, updates and
   node announcements equal A's, at most 5 rounds, each round's seconds,
   sig/s and sheds printed; node C dials A and sends 1,000 fresh
   channel_updates (signed on S2, 25 with a corrupted signature): A
   accepts exactly the 975 good ones and fans them out to B under B's
   timestamp filter, and B ends with exactly those; B's store replays
   all valid on the card and holds each message of A's stores once; each
   K1-K3 launch is booked, by CUDA events, to A's replay or a flush of A
   or B, once a bucket; the Noise bytes each way and the AEAD's share of
   the phase.

Prints one {"kernels": [...]} line (each verify kernel's launches counted
on the replay of the first engine that runs it, named as "path"; S1's and
S2's on phase 5's sign path; each kernel's launches in phase 6's waves
as "live_ingest_launches"; R1's and R2's on phase 7's routing path; each
kernel's launches in phase 8's six replays as
"supervised_replay_launches"; R1's and R2's in phase 9 as
"supervised_routing_launches"; K1-K3's in phase 10's replay and
flushes as "peer_gossip_launches"; the fault replay's and the supervised
sign and check's only in the log), the
nvidia-smi name and power limit,
and as its last line {"ok": true, "device": {...}}.  Exits non-zero with
no result line when there is no CUDA device or no port package beside it.
"""
from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM: SMs, and 32-bit integer multiply(-add) results per clock per
# SM for compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table); HBM3 rate from NVIDIA's data sheet.
SMS = 132
INT32_MAD_PER_CLK_SM = 64
HBM_BYTES_PER_S = 3.35e12
MAD_PER_PRODUCT = 2  # a 32x32 -> 64-bit product is a low and a high half

REPLACES = {
    "verify_prep": "lightning_tpu/crypto/pallas_secp.py:322",
    "build_tables": "lightning_tpu/crypto/pallas_secp.py:735",
    "glv_scan": "lightning_tpu/crypto/pallas_secp.py:627",
    "glv_scan2": "lightning_tpu/crypto/pallas_secp.py:627",
    "dual_mul_v2": "lightning_tpu/crypto/pallas_secp.py:462",
    "dual_mul_planes": "lightning_tpu/crypto/pallas_secp.py:807",
    # the sign path's kernels replace XLA programs, not pallas_calls
    "fixed_base": "lightning_tpu/crypto/secp256k1.py:451",
    "ecdsa_sign": "lightning_tpu/crypto/secp256k1.py:405",
}
SOURCES = {k: f"lightning_tpu_torch/crypto/csrc/{k}.cu" for k in REPLACES}
# the routing kernels replace XLA programs of the JAX package's routing
ROUTING_REPLACES = {
    "route_sweep": "lightning_tpu/routing/device.py:144",
    "mcf_ssp": "lightning_tpu/routing/mcf_device.py:419",
}
# the wrapper of each kernel, where its name is not the kernel's
WRAPPER = {"verify_prep": "verify_prep_core",
           "fixed_base": "fixed_base_affine", "mcf_ssp": "mcf_solve"}
MAX_HTLCS = 483         # BOLT #2 max_accepted_htlcs

# The kernels (by wrapper) each kernel engine launches once a bucket; the
# "+pp" prep is K1.  pallas_fbj+pp is the main path.
MAIN = "pallas_fbj+pp"
ENGINE_KERNELS = {
    MAIN: ("verify_prep_core", "build_tables", "glv_scan"),
    "pallas+pp": ("verify_prep_core", "dual_mul_planes"),
    "pallas_v2+pp": ("verify_prep_core", "dual_mul_v2"),
    "pallas_glv+pp": ("verify_prep_core", "glv_scan2"),
    "pallas_fb+pp": ("verify_prep_core", "build_tables", "glv_scan2"),
    "pallas_fb": ("build_tables", "glv_scan2"),
}


def log(*a):
    print(*a, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sm_clock_hz() -> float:
    mhz = smi("clocks.max.sm").splitlines()[0].split()[0]
    return float(mhz) * 1e6


# ---------------------------------------------------------------------------
# Phase 2 inputs and comparisons


def rand_limbs(gen, B, mod_int, dev, F):
    """B random canonical values below mod_int, as (B, 20) limbs."""
    raw = gen.integers(0, 256, (B, 32), dtype=np.uint8)
    vals = [int.from_bytes(r.tobytes(), "big") % mod_int for r in raw]
    return F.from_int_array(vals, dev)


def mismatches(F, mod, got, want):
    """(rows that differ after normalization, max |limb difference|)."""
    a, b = F.normalize(mod, got), F.normalize(mod, want)
    bad = int((a != b).any(dim=-1).sum())
    return bad, int((a - b).abs().max()) if a.numel() else 0


def k1_inputs(gen, B, dev, F):
    qx = rand_limbs(gen, B, F.P_INT, dev, F)
    s = rand_limbs(gen, B, F.N_INT, dev, F)
    return qx, s


def k1_edges(dev, F, ref):
    off = next(x for x in range(1, 100)
               if pow((x ** 3 + 7) % ref.P, (ref.P - 1) // 2, ref.P) != 1)
    xs = [ref.G.x, off, 0, ref.P - 1, ref.P, 2 ** 256 - 1, ref.G.x, ref.G.x]
    ss = [0, 1, ref.N - 1, ref.N, 2 ** 256 - 1, 1, 2, (ref.N - 1) // 2]
    return F.from_int_array(xs, dev), F.from_int_array(ss, dev)


def compare_k1(H, F, qx, s):
    got = H.verify_prep_core(qx, s)
    want = H.verify_prep_plain(qx, s)
    res = [mismatches(F, m, g, w)
           for m, g, w in zip((F.FP, F.FP, F.FN), got, want)]
    return sum(r[0] for r in res), max(r[1] for r in res)


def k1_zero_cases(gen, B, dev, F, H, ref):
    """K1 inputs at size B with s = 0, n and 2^256 - 1 at the first and
    last thread of the first two blocks and at B - 1."""
    qx, s = k1_inputs(gen, B, dev, F)
    ss = F.to_int_list(s.cpu())
    T = H.PREP_THREADS
    for j, i in enumerate((0, T - 1, T, 2 * T - 1, B - 1)):
        ss[i] = (0, ref.N, 2 ** 256 - 1)[j % 3]
    return qx, F.from_int_array(ss, dev)


def k2_edges(gen, dev, F, torch):
    """K2 on every pair of carry-edge coordinates, either sign flip."""
    xs = [a for a in F.P_EDGES for _ in F.P_EDGES]
    ys = [b for _ in F.P_EDGES for b in F.P_EDGES]
    flip = torch.as_tensor(gen.integers(0, 2, len(xs)), device=dev)
    return F.from_int_array(xs, dev), F.from_int_array(ys, dev), flip


def k2_inputs(gen, B, dev, F, torch):
    bx = rand_limbs(gen, B, F.P_INT, dev, F)
    by = rand_limbs(gen, B, F.P_INT, dev, F)
    flip = torch.as_tensor(gen.integers(0, 2, B), device=dev)
    return bx, by, flip


def compare_k2(H, F, bx, by, flip):
    got = H.tables_to_limbs(H.build_tables(bx, by, flip))
    want = H.build_tables_plain(bx, by, flip)
    bad, err = 0, 0
    for g_half, w_half in zip(got, want):
        for g, w in zip(g_half, w_half):
            b, e = mismatches(F, F.FP, g, w)
            bad, err = bad + b, max(err, e)
    return bad, err


def k3_inputs(gen, B, dev, H, F, torch):
    bx, by, flip = k2_inputs(gen, B, dev, F, torch)
    d2l, d2h = (torch.as_tensor(gen.integers(0, 16, (33, B)), device=dev)
                for _ in range(2))
    gidx = torch.as_tensor(gen.integers(0, 1024, (33, B)), device=dev)
    return d2l, d2h, gidx, bx, by, flip


def compare_k3(H, F, d2l, d2h, gidx, bx, by, flip):
    tab = H.build_tables(bx, by, flip)
    got = H.glv_scan(d2l, d2h, gidx, tab)
    want = H.glv_scan_plain(d2l, d2h, gidx, *H.tables_to_limbs(tab))
    return point_mismatches(F, got, want)


def rand_words(gen, shape, dev, torch):
    """Random canonical field elements (< 2^255 < p) as int32 kernel
    words, shape (..., 8, B)."""
    w = gen.integers(0, 2**32, shape, dtype=np.uint32)
    w[..., 7, :] &= 0x7FFFFFFF
    return torch.as_tensor(w.view(np.int32), device=dev)


def point_mismatches(F, got, want):
    res = [mismatches(F, F.FP, g, w) for g, w in zip(got, want)]
    return sum(r[0] for r in res), max(r[1] for r in res)


def k4_inputs(gen, B, dev, H, F, torch):
    bx, by, flip = k2_inputs(gen, B, dev, F, torch)
    d2l, d2h = (torch.as_tensor(gen.integers(0, 16, (33, B)), device=dev)
                for _ in range(2))
    g1, g2 = (rand_words(gen, (33, 3, 8, B), dev, torch) for _ in range(2))
    return d2l, d2h, H.build_tables(bx, by, flip), g1, g2


def compare_k4(H, F, d2l, d2h, tab, g1, g2):
    got = H.glv_scan2(d2l, d2h, tab, g1, g2)
    want = H.glv_scan2_plain(d2l, d2h, *H.tables_to_limbs(tab), g1, g2)
    return point_mismatches(F, got, want)


def k5_inputs(gen, B, dev, torch, digit=None):
    """K5's operands: digits (random, or every one `digit`), the per-key
    table in its (B, 16, 3, 8) layout and the G planes."""
    d2 = torch.as_tensor(gen.integers(0, 16, (64, B)), device=dev)
    if digit is not None:
        d2.fill_(digit)
    qtab = rand_words(gen, (16, 3, 8, B), dev, torch)
    return (d2, qtab.permute(3, 0, 1, 2).contiguous(),
            rand_words(gen, (64, 3, 8, B), dev, torch))


def compare_k5(H, F, d2, qtab, gs):
    return point_mismatches(F, H.dual_mul_v2(d2, qtab, gs),
                            H.dual_mul_v2_plain(d2, qtab, gs))


def k6_inputs(gen, B, dev, torch):
    return tuple(rand_words(gen, (64, 3, 8, B), dev, torch)
                 for _ in range(2))


def compare_k6(H, F, qs, gs):
    return point_mismatches(F, H.dual_mul_planes(qs, gs),
                            H.dual_mul_planes_plain(qs, gs))


def engine_edges(E, F, ref, dev, engine):
    """One kernel engine's dual multiplication on edge scalars: the
    inputs of tests/test_pallas_secp.py:81-84 (default_rng(8); u = 0, 1
    and n - 1 on both sides), a row with u1*G = -u2*Q and rows of
    u = 0 / n - 1 against one key, on the card against the plain path
    on the CPU, and both against the exact-int oracle.  Returns
    (mismatching rows, max |limb difference|, rows off the oracle)."""
    rng = np.random.default_rng(8)
    k1s = [0, 1, ref.N - 1] + [int.from_bytes(rng.bytes(32), "big") % ref.N
                               for _ in range(5)]
    k2s = [1, 0, ref.N - 1] + [int.from_bytes(rng.bytes(32), "big") % ref.N
                               for _ in range(5)]
    pts = [ref.pubkey_create(int.from_bytes(rng.bytes(32), "big") % ref.N
                             or 1) for _ in range(8)]
    k1s.append(12345)
    k2s.append((ref.N - 12345) * pow(7, -1, ref.N) % ref.N)
    pts.append(ref.pubkey_create(7))                  # u1*G = -u2*Q
    q = ref.pubkey_create(0xC0FFEE)
    for a, b in ((0, ref.N - 1), (ref.N - 1, 0), (0, 0), (ref.N - 1,
                                                          ref.N - 1)):
        k1s.append(a)
        k2s.append(b)
        pts.append(q)
    args = [F.from_int_array(v) for v in (k1s, k2s, [p.x for p in pts],
                                          [p.y for p in pts])]
    fn = E.resolve_dual_mul(E.resolve_engine_names(engine)[0])
    got = [t.cpu() for t in fn(*(a.to(dev) for a in args))]
    want = fn(*args)
    bad, err = point_mismatches(F, got, want)
    off = 0
    X, Y, Z = (F.to_int_list(F.normalize(F.FP, c)) for c in got)
    for i, (a, b, p) in enumerate(zip(k1s, k2s, pts)):
        e = ref.point_add(ref.point_mul(a, ref.G), ref.point_mul(b, p))
        if e.inf:
            off += Z[i] != 0
        else:
            zi = pow(Z[i], -1, ref.P) if Z[i] else 0
            off += (X[i] * zi % ref.P, Y[i] * zi % ref.P) != (e.x, e.y)
    return bad, err, off


def verify_edges(E, S, F, ref, dev, torch, engine):
    """Edge signatures through the card's verify under `engine`, the
    plain verify on the CPU and the exact-int oracle: all three must
    agree."""
    d = 0xA11CE
    pk = ref.pubkey_serialize(ref.pubkey_create(d))
    z = 0x1234567890ABCDEF << 64
    r, s = ref.ecdsa_sign(z.to_bytes(32, "big"), d)
    off = next(x for x in range(1, 100)
               if pow((x ** 3 + 7) % ref.P, (ref.P - 1) // 2, ref.P) != 1)
    cases = [  # (z, r, s, pubkey bytes)
        (z, r, s, pk),                                # valid
        (z, r, 0, pk),                                # s = 0
        (z, r, ref.N - s, pk),                        # high S
        (z, r, s, b"\x02" + off.to_bytes(32, "big")),  # off-curve x
        (0, r, s, pk),                                # u1 = 0
        ((ref.N - s) % ref.N, r, s, pk),              # u1 = n - 1
        (z, 7, s, pk),                                # r < p - n
        (z, r, s, b"\x04" + pk[1:]),                  # bad tag
    ]
    zb = np.array([list(c[0].to_bytes(32, "big")) for c in cases], np.uint8)
    sig = np.array([list(c[1].to_bytes(32, "big") + c[2].to_bytes(32, "big"))
                    for c in cases], np.uint8)
    pub = np.array([list(c[3]) for c in cases], np.uint8)
    tag = (pub[:, 0] == 2) | (pub[:, 0] == 3)

    def run(device):
        zt = F.from_bytes_be_dev(torch.as_tensor(zb, device=device))
        sg = torch.as_tensor(sig, device=device)
        pb = torch.as_tensor(pub, device=device)
        ok = E.ecdsa_verify_kernel(
            zt, F.from_bytes_be_dev(sg[:, :32]),
            F.from_bytes_be_dev(sg[:, 32:]), F.from_bytes_be_dev(pb[:, 1:]),
            pb[:, 0].to(torch.int64) & 1, engine)
        return ok.cpu().numpy() & tag

    return run(dev), run("cpu"), S.host_verify_batch(zb, sig, pub)


def s1_inputs(gen, B, dev, F, ref):
    """S1's scalars as (8, B) words: k = 0, 1, 2, n - 1, n, 2^256 - 1,
    2^128 and 2^252 first (infinity; digits of 0), then random."""
    ks = [int.from_bytes(r.tobytes(), "big")
          for r in gen.integers(0, 256, (B, 32), dtype=np.uint8)]
    ks[:8] = [0, 1, 2, ref.N - 1, ref.N, 2**256 - 1, 2**128, 2**252]
    return F.words_from_be_bytes(F.ints_to_be_bytes(ks), dev)


def s2_inputs(gen, B, C, dev, F, E, ref, torch):
    """S2's z, d (8, B) and ks (C, 8, B) words: row 0 the hash
    sha256(b"h14") with the key from b"d14" and its four RFC6979
    candidates (none gives a low R), rows 1-2 z = 2^256 - 1 and z = n + 5,
    row 3 the candidates 1, n - 1, 2^128, 2^252; the rest random (about 1
    row in 16 has no low-R candidate among four)."""
    import hashlib

    def rnd(shape, m):
        raw = gen.integers(0, 256, (*shape, 32), dtype=np.uint8)
        return [int.from_bytes(r.tobytes(), "big") % m
                for r in raw.reshape(-1, 32)]

    zs = rnd((B,), 2**256)
    ds = [v + 1 for v in rnd((B,), ref.N - 1)]
    ks = [v + 1 for v in rnd((B, 4), ref.N - 1)]
    ks = [ks[4 * i:4 * i + 4] for i in range(B)]
    h14 = hashlib.sha256(b"h14").digest()
    zs[0] = int.from_bytes(h14, "big")
    ds[0] = int.from_bytes(hashlib.sha256(b"d14").digest(), "big") \
        % (ref.N - 1) + 1
    ks[0] = E.rfc6979_candidates(h14, ds[0])
    zs[1], zs[2] = 2**256 - 1, ref.N + 5
    ks[3] = [1, ref.N - 1, 2**128, 2**252]

    def words(vals):
        return F.words_from_be_bytes(F.ints_to_be_bytes(vals), dev)

    return (words(zs), words(ds),
            torch.stack([words([k[c] for k in ks]) for c in range(C)]))


def compare_s1(H, F, k8):
    got, want = H.fixed_base_affine(k8), H.fixed_base_affine_plain(k8)
    return point_mismatches(F, [F.from_u32x8(g) for g in got],
                            [F.from_u32x8(w) for w in want])


def compare_s2(H, F, z8, d8, ks8):
    """S2 against its plain version: rows where r, s, ok or grind
    differ, and the max |limb difference| of r and s."""
    got, want = H.ecdsa_sign(z8, d8, ks8), H.ecdsa_sign_plain(z8, d8, ks8)
    rows = (got[2] != want[2]) | (got[3] != want[3])
    err = 0
    for g, w in zip(got[:2], want[:2]):
        a, b = F.from_u32x8(g), F.from_u32x8(w)
        rows |= (a != b).any(dim=-1)
        err = max(err, int((a - b).abs().max()))
    return int(rows.sum()), err, got


def s2_rule_sample(E, F, gen, z8, d8, ks8, got, n):
    """S2's outputs on n sampled rows (the 4 edge rows and random ones)
    against the exact-int four-candidate rule; returns (rows off the
    rule, rows of the sample with no low-R candidate)."""
    B = z8.shape[-1]
    rows = np.concatenate([np.arange(4), np.sort(gen.choice(
        np.arange(4, B), min(n, B) - 4, replace=False))])

    def ints(w):
        return [int.from_bytes(b.tobytes(), "big")
                for b in F.words_to_be_bytes(w[:, rows])]

    zs, ds, rs, ss = (ints(w) for w in (z8, d8, got[0], got[1]))
    ks = [ints(kc) for kc in ks8]
    ok, grind = got[2].cpu().numpy()[rows], got[3].cpu().numpy()[rows]
    off = 0
    for i in range(len(rows)):
        want = E.sign_with_candidates(zs[i], ds[i], [k[i] for k in ks])
        off += (rs[i], ss[i], bool(ok[i]), bool(grind[i])) != want
    return off, int((~grind).sum())


# ---------------------------------------------------------------------------
# Phase 5: the sign path


def remote_commitment(C, hsmd, ref, us, client, them, their_client,
                      number: int, n_htlcs: int):
    """The peer's commitment `number` with n_htlcs HTLCs (half offered,
    anchors on), built as our node builds it to sign the HTLC
    transactions: (sighashes (n, 32) uint8, our HTLC key, our HTLC
    pubkey)."""
    import hashlib

    point = them.per_commitment_point(their_client, number)
    theirs = them.channel_basepoints(their_client)
    ours = us.channel_basepoints(client)
    keys = C.CommitmentKeys.derive(theirs, ours, point)
    params = C.CommitmentParams(
        funding_txid=hashlib.sha256(b"funding").digest(),
        funding_output_index=0, funding_sat=16_777_215, opener=C.Side.LOCAL,
        opener_payment_basepoint=keys.remote_pubkey,
        accepter_payment_basepoint=ref.pubkey_serialize(theirs.payment),
        to_self_delay=144, dust_limit_sat=546, feerate_per_kw=253,
        anchors=True,
        local_funding_pubkey=ref.pubkey_serialize(theirs.funding_pubkey),
        remote_funding_pubkey=ref.pubkey_serialize(ours.funding_pubkey))
    htlcs = [C.Htlc(offered=i % 2 == 0, amount_msat=(20_000 + 37 * i) * 1000,
                    payment_hash=hashlib.sha256(
                        b"%d preimage %d" % (number, i)).digest(),
                    cltv_expiry=800_000 + i, id=i) for i in range(n_htlcs)]
    tx, hmap = C.build_commitment_tx(params, keys, number, 6_000_000_000,
                                     500_000_000, htlcs,
                                     holder_is_opener=False)
    sighashes = [h for _, h in C.htlc_sighashes(
        tx, hmap, keys, params.to_self_delay, params.feerate_per_kw, True)]
    assert len(sighashes) == n_htlcs, "an HTLC was trimmed"
    hashes = np.frombuffer(bytearray(b"".join(sighashes)), np.uint8)
    return hashes.reshape(-1, 32), us.htlc_privkey(client, point), \
        keys.remote_htlcpubkey


def sign_path(args, gen, dev, card, torch, F, E, H, ref):
    """Phase 5; returns the launch counts of the sign path's run."""
    from lightning_tpu_torch.channel import commitment as C
    from lightning_tpu_torch.daemon import hsmd

    us, them = hsmd.Hsm(b"\x11" * 32, dev), hsmd.Hsm(b"\x22" * 32, dev)
    peer = b"\x03" + b"\x44" * 32
    client = us.client(hsmd.CAP_MASTER, peer, dbid=1)
    their_client = them.client(hsmd.CAP_MASTER, peer, dbid=1)
    n_sample = min(1024, args.htlcs * args.commitments)
    t0 = time.perf_counter()
    commits = [remote_commitment(C, hsmd, ref, us, client, them,
                                 their_client, n, args.htlcs)
               for n in range(args.commitments)]
    log(f"sign path: {args.commitments} remote commitments of "
        f"{args.htlcs} HTLCs built in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    H.reset_launches()
    # 5.1: one commitment through hsmd
    hashes, priv, pub = commits[0]
    point = them.per_commitment_point(their_client, 0)
    t0 = time.perf_counter()
    sigs = us.sign_htlc_batch(client, [bytes(h) for h in hashes], point)
    t_sign = time.perf_counter() - t0
    pubs = np.tile(np.frombuffer(pub, np.uint8), (len(hashes), 1))
    ok = us.check_sigs_batch(hashes, sigs, pubs)
    rule = E.host_sign_grind_batch(hashes, [priv] * len(hashes))
    same = int((sigs == rule).all(axis=1).sum())
    log(f"commitment: {len(hashes)} HTLC signatures by sign_htlc_batch in "
        f"{t_sign:.3f} s, check_sigs_batch {int(ok.sum())}/{len(ok)} true, "
        f"{same}/{len(hashes)} equal to the exact-int rule")
    assert ok.all() and same == len(hashes), "commitment fan-out"

    # 5.2: the bulk fan-out, one ecdsa_sign_batch call
    hashes = np.concatenate([c[0] for c in commits])
    keys = [c[1] for c in commits for _ in range(len(c[0]))]
    pubs = np.stack([np.frombuffer(c[2], np.uint8) for c in commits
                     for _ in range(len(c[0]))])
    sec: dict = {}
    sigs = E.ecdsa_sign_batch(hashes, keys, bucket=args.bucket, device=dev,
                              seconds=sec)
    ok = E.ecdsa_verify_batch(hashes, sigs, pubs, bucket=args.bucket,
                              device=dev)
    rows = np.sort(gen.choice(len(hashes), n_sample, replace=False))
    rule = E.host_sign_grind_batch(hashes[rows], [keys[i] for i in rows])
    same = int((sigs[rows] == rule).all(axis=1).sum())
    total = sec["nonces"] + sec["device"]
    log(f"bulk fan-out: {len(hashes)} sighashes ({args.commitments} x "
        f"{args.htlcs}) in one ecdsa_sign_batch: host nonces "
        f"{sec['nonces']:.3f} s, device {sec['device']:.3f} s, "
        f"{len(hashes) / total:.0f} sig/s ({len(hashes) / sec['device']:.0f}"
        f" sig/s on the device part); verified {int(ok.sum())}/{len(ok)}; "
        f"{same}/{n_sample} of a sample equal to the exact-int rule; on "
        f"{card}")
    assert ok.all() and same == n_sample, "bulk fan-out"

    # 5.3: public keys
    seckeys = [int.from_bytes(r.tobytes(), "big") % (ref.N - 1) + 1
               for r in gen.integers(0, 256, (args.bucket, 32), np.uint8)]
    t0 = time.perf_counter()
    pk = E.derive_pubkeys(F.from_int_array(seckeys).numpy(), args.bucket,
                          device=dev)
    t_derive = time.perf_counter() - t0
    rows = gen.choice(len(seckeys), min(1024, len(seckeys)), replace=False)
    same = sum(bytes(pk[i]) == ref.pubkey_serialize(
        ref.pubkey_create(seckeys[i])) for i in rows)
    log(f"derive_pubkeys: {len(seckeys)} keys in {t_derive:.3f} s, "
        f"{same}/{len(rows)} of a sample equal to ref.pubkey_create")
    assert same == len(rows), "derive_pubkeys"

    # 5.4: BIP340
    n_s = min(1024, args.bucket)
    msgs = [gen.bytes(32) for _ in range(n_s)]
    sigs = [ref.schnorr_sign(m, k) for m, k in zip(msgs, seckeys)]
    xonly = [bytes(p[1:]) for p in pk[:n_s]]
    flip = gen.choice(n_s, 64, replace=False)
    bad = [bytearray(sigs[i]) for i in flip]
    for j, b in enumerate(bad):
        b[j % 64] ^= 1 << (j % 8)
    M, SG, PK = (np.stack([np.frombuffer(bytes(x), np.uint8) for x in xs])
                 for xs in (msgs + [msgs[i] for i in flip],
                            sigs + bad, xonly + [xonly[i] for i in flip]))
    got = E.schnorr_verify_batch(M, SG, PK, bucket=args.bucket, device=dev)
    want = np.arange(len(got)) < n_s
    log(f"schnorr_verify_batch: {int(got[:n_s].sum())}/{n_s} valid true, "
        f"{int(got[n_s:].sum())}/64 flipped true")
    assert np.array_equal(got, want), "schnorr verdicts"
    counts = H.launch_counts()
    log(f"launches on the sign path: {json.dumps(counts)}")
    n_sign = -(-len(hashes) // args.bucket)        # slices of the bulk
    n_schnorr = -(-len(got) // args.bucket)
    want = {"ecdsa_sign": 1 + n_sign, "fixed_base_affine": 1,
            "verify_prep_core": 1 + n_sign,
            "build_tables": 1 + n_sign + n_schnorr,
            "glv_scan": 1 + n_sign + n_schnorr}
    assert counts == {k: want.get(k, 0) for k in counts}, \
        "sign path launch counts"
    return counts


# ---------------------------------------------------------------------------
# Phase 6: live ingest


def ingest_messages(wire, path, info):
    """The synth store's messages with their parsed forms and verdicts:
    (raws, parsed, valid, ca_of) in store order (CAs, CUs channel-major,
    NAs); ca_of[i] is the channel index of message i (-1 for an NA)."""
    from lightning_tpu_torch.gossip import store as ST

    idx = ST.load_store(path)
    raws = [idx.message(i) for i in range(len(idx))]
    parsed = [wire.parse_gossip(m) for m in raws]
    n, nn = info["channels"], info["nodes"]
    exp = info["expected_sig_ok"]
    valid = np.concatenate([info["expected_ca_valid"],
                            exp[4 * n + nn:], exp[4 * n:4 * n + nn]])
    ca_of = np.concatenate([np.arange(n), np.arange(2 * n) // 2,
                            np.full(nn, -1)])
    return raws, parsed, valid, ca_of


def ingest_feed(parsed, valid, ca_of, gen, gap, n_dup=100, early=0.05):
    """The order the live phase submits the store's messages in, as
    indices into them.  Step t submits channel_announcement t, then the
    channel_updates of channel t - `gap` and the node_announcements whose
    node's first valid channel is t - `gap`, so every step up to n +
    `gap` holds at least 2 signatures.  A seeded `early` share of the
    updates and node announcements comes before its channel instead and
    waits in the pending maps; `n_dup` exact duplicates of messages
    through before step n - `gap` come `gap` to 2 * `gap` steps after.
    With `gap` at least the backlog's hard cap (in signatures), no
    message meets a related one still in flight, so a sequential model
    of the ingest predicts every count."""
    n = int((ca_of >= 0).sum() // 3)
    assert n > gap, "the gap must be shorter than the channel count"
    first_any, first_valid = {}, {}
    for c in range(n):
        for nid in (parsed[c].node_id_1, parsed[c].node_id_2):
            first_any.setdefault(nid, c)
            if valid[c]:
                first_valid.setdefault(nid, c)
    keys, ready = [], []
    for i, p in enumerate(parsed):
        if i < n:
            keys.append((i, 0, i))
            ready.append(i)
            continue
        if i < 3 * n:
            before = through = int(ca_of[i])
        else:
            before = first_any.get(p.node_id)
            through = first_valid.get(p.node_id, before or 0)
        ready.append(through + gap)
        if before is not None and gen.random() < early:
            step = int(gen.integers(max(0, before - gap), before)) \
                if before else -1
            keys.append((step, 2, i))
        else:
            keys.append((through + gap, 1, i))
    ready = np.array(ready)
    for i in gen.choice(np.nonzero(ready < n - gap)[0], n_dup,
                        replace=False):
        keys.append((int(ready[i]) + gap + int(gen.integers(0, gap)), 3,
                     int(i)))
    return [k[2] for k in sorted(keys)]


class IngestModel:
    """The ingest's rules (gossip/ingest.py) applied one message at a
    time, each verified and applied before the next, with the seeded
    verdicts for signatures.  `sheds` holds the (message bytes, n-th
    submission of those bytes) pairs the live run shed: whether the
    backlog had room depends on timing, everything else follows."""

    def __init__(self, wire, ingest, valid: dict, sheds: set):
        self.W, self.I, self.valid, self.sheds = wire, ingest, valid, sheds
        self.seen: dict = {}
        self.channels, self.updates, self.nodes = {}, {}, {}
        self.channeled: set = set()
        self.pending_updates: dict = {}
        self.pending_nodes: dict = {}
        self.tokens: dict = {}
        self.dropped: dict = {}
        self.accepted: list = []
        self.batched_sigs = 0

    def drop(self, reason):
        self.dropped[reason] = self.dropped.get(reason, 0) + 1

    def submit(self, raw: bytes):
        W, I = self.W, self.I
        k = self.seen.get(raw, 0)
        self.seen[raw] = k + 1
        shed = (raw, k) in self.sheds
        p = W.parse_gossip(raw)
        if p.TYPE == W.MSG_CHANNEL_ANNOUNCEMENT:
            if p.short_channel_id in self.channels:
                return self.drop(I.R_DUP)
        elif p.TYPE == W.MSG_CHANNEL_UPDATE:
            key = (p.short_channel_id, p.direction)
            if self.updates.get(key, -1) >= p.timestamp:
                return self.drop(I.R_STALE)
            if p.short_channel_id not in self.channels:
                held = self.pending_updates.setdefault(p.short_channel_id,
                                                       {})
                prev = held.get(p.direction)
                if prev is None:
                    if shed:                          # the pending cap
                        return self.drop(I.R_SHED)
                    held[p.direction] = raw
                elif W.parse_gossip(prev).timestamp < p.timestamp:
                    held[p.direction] = raw
                return self.drop(I.R_NO_CHANNEL)
        elif self.nodes.get(p.node_id, -1) >= p.timestamp:
            return self.drop(I.R_STALE)
        if shed:
            return self.drop(I.R_SHED)
        if p.TYPE == W.MSG_CHANNEL_UPDATE:
            key = (p.short_channel_id, p.direction)
            used = self.tokens.get(key, 0)
            if used >= I.RATELIMIT_BURST:
                return self.drop(I.R_RATELIMIT)
            self.tokens[key] = used + 1
        self.batched_sigs += 4 if p.TYPE == W.MSG_CHANNEL_ANNOUNCEMENT else 1
        if not self.valid[raw]:
            return self.drop(I.R_BADSIG)
        self.apply(raw, p)

    def apply(self, raw, p):
        W, I = self.W, self.I
        if p.TYPE == W.MSG_CHANNEL_ANNOUNCEMENT:
            self.channels[p.short_channel_id] = (p.node_id_1, p.node_id_2)
            self.channeled.update((p.node_id_1, p.node_id_2))
            self.accepted.append(raw)
            for q in self.pending_updates.pop(p.short_channel_id,
                                              {}).values():
                self.submit(q)
            for nid in (p.node_id_1, p.node_id_2):
                q = self.pending_nodes.pop(nid, None)
                if q is not None:
                    self.submit(q)
        elif p.TYPE == W.MSG_CHANNEL_UPDATE:
            key = (p.short_channel_id, p.direction)
            if self.updates.get(key, -1) >= p.timestamp:
                return self.drop(I.R_STALE)
            self.updates[key] = p.timestamp
            self.accepted.append(raw)
        elif p.node_id not in self.channeled:
            prev = self.pending_nodes.get(p.node_id)
            if prev is None or \
                    W.parse_gossip(prev).timestamp < p.timestamp:
                self.pending_nodes[p.node_id] = raw
            self.drop(I.R_NO_CHANNEL)
        elif self.nodes.get(p.node_id, -1) >= p.timestamp:
            self.drop(I.R_STALE)
        else:
            self.nodes[p.node_id] = p.timestamp
            self.accepted.append(raw)


def stale_updates(wire, ref, parsed, ca_of, info, pubs, gen, n):
    """`n` channel_updates re-signed with a timestamp 1,000 s older than
    the store's, on channels whose two nodes have their derived keys."""
    import dataclasses

    key_of = {bytes(pk): d for pk, d in zip(pubs, info["seckeys"])}
    out = []
    for i in gen.permutation(np.nonzero(ca_of >= 0)[0]):
        p = parsed[i]
        if p.TYPE != wire.MSG_CHANNEL_UPDATE:
            continue
        ca = parsed[ca_of[i]]
        signer = (ca.node_id_1, ca.node_id_2)[p.direction]
        if ca.node_id_1 not in key_of or ca.node_id_2 not in key_of:
            continue
        m = bytearray(dataclasses.replace(
            p, timestamp=p.timestamp - 1000).serialize())
        r, s = ref.ecdsa_sign(ref.sha256d(bytes(m[wire.CU_SIGNED_OFFSET:])),
                              key_of[signer])
        m[wire.CU_SIG_OFFSET:wire.CU_SIG_OFFSET + 64] = \
            r.to_bytes(32, "big") + s.to_bytes(32, "big")
        out.append(bytes(m))
        if len(out) == n:
            return out
    raise AssertionError("too few channels for the stale updates")


def bolt7_feed(parsed, ca_of):
    """The store's messages in BOLT #7's sync order, as indices: each
    channel_announcement, then its channel_updates, then the
    node_announcements of its nodes not sent before (the node
    announcements of nodes in no channel last)."""
    n = int((ca_of >= 0).sum() // 3)
    na_of = {parsed[i].node_id: i for i in range(3 * n, len(parsed))}
    order = []
    for c in range(n):
        order += [c, n + 2 * c, n + 2 * c + 1]
        for nid in (parsed[c].node_id_1, parsed[c].node_id_2):
            i = na_of.pop(nid, None)
            if i is not None:
                order.append(i)
    return order + sorted(na_of.values())


def pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else 0.0


def drive_ingest(I, V, H, torch, dev, out, high_wm, waves):
    """Feeds each wave of raw messages through one GossipIngest on `dev`
    as gossipd feeds it (wait_capacity, then submit), with a drain after
    each wave, then closes it.  Times every flush, the verify_items inside
    it, each kernel launch inside it (CUDA events on its stream) and each
    submit; keeps every shed as (message bytes, n-th submission of them)
    and the launch counts of the run (set to 0 just before)."""
    import asyncio
    import collections

    r = {"sheds": set(), "flushes": [], "verify": [], "waited": [],
         "submit": {True: [], False: []}, "spans": [],
         "seen": collections.Counter(), "kernel_ms": collections.Counter()}
    verify_items, launch = V.verify_items, H._launch
    kernel_events = []

    def timed_verify(items, bucket, device=None, **kw):
        t = time.perf_counter()
        ok = verify_items(items, bucket, device=device, **kw)
        r["verify"].append(time.perf_counter() - t)
        return ok

    def timed_launch(name, *tensors, B, entry=None):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        launch(name, *tensors, B=B, entry=entry)
        b.record()
        kernel_events.append((name, a, b))

    async def run():
        ing = I.GossipIngest(out, device=dev, high_wm=high_wm,
                             low_wm=high_wm // 2)
        submit, flush = ing.submit, ing.flush
        seen = r["seen"]

        async def counted_submit(raw, source=None):
            k = seen[raw]
            seen[raw] += 1
            before = ing.stats.dropped.get(I.R_SHED, 0)
            await submit(raw, source)
            if ing.stats.dropped.get(I.R_SHED, 0) > before:
                r["sheds"].add((raw, k))

        async def timed_flush():
            n = ing._queued_sigs
            t = time.perf_counter()
            await flush()
            if n:
                r["flushes"].append((n, time.perf_counter() - t))

        ing.submit, ing.flush = counted_submit, timed_flush
        ing.start()
        for wave in waves:
            t = time.perf_counter()
            for raw in wave:
                r["waited"].append(await ing.wait_capacity())
                busy = ing._flushing
                ts = time.perf_counter()
                await ing.submit(raw, "peer")
                r["submit"][busy].append(time.perf_counter() - ts)
            await ing.drain()
            r["spans"].append(time.perf_counter() - t)
        await ing.close()
        return ing

    if dev.type == "cuda":
        torch.cuda.synchronize()
    H.reset_launches()
    V.verify_items = timed_verify
    if dev.type == "cuda":
        H._launch = timed_launch
    try:
        r["ing"] = asyncio.run(run())
    finally:
        V.verify_items, H._launch = verify_items, launch
    r["launches"] = H.launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        for name, a, b in kernel_events:
            r["kernel_ms"][name] += a.elapsed_time(b)
    return r


def report_ingest(tag, r, wire, card, n_msgs, n_sigs):
    """Logs a live run's flushes, stalls, waits and sheds; returns its
    end-to-end figures (of the first wave)."""
    import collections

    st, ing = r["ing"].stats, r["ing"]
    fl = np.array([f[1] for f in r["flushes"]])
    span = r["spans"][0]
    out = {"sig_s": n_sigs / span, "msg_s": n_msgs / span,
           "p50_ms": pct(fl, 50) * 1e3, "p99_ms": pct(fl, 99) * 1e3,
           "flushes": st.flushes, "sheds": len(r["sheds"])}
    log(f"live ingest, {tag}, on {card}: {st.flushes} flushes, "
        f"{st.batched_sigs} signatures verified, "
        f"{st.batched_sigs / max(1, st.flushes):.1f} a flush "
        f"(max {st.max_batch}); flush wall p50 {out['p50_ms']:.1f} ms, "
        f"p99 {out['p99_ms']:.1f} ms, max {fl.max() * 1e3:.1f} ms; "
        f"verify_items {sum(r['verify']) / fl.sum() * 100:.1f} % of flush "
        f"time; end to end {out['sig_s']:.0f} sig/s, {out['msg_s']:.0f} "
        f"msg/s ({span:.2f} s from the first submit to drain)"
        + "".join(f", then {s:.2f} s" for s in r["spans"][1:]))
    for busy, name in ((True, "during a flush"), (False, "otherwise")):
        xs = np.array(r["submit"][busy]) * 1e6
        log(f"  submit() {name}: {len(xs)} calls, p50 {pct(xs, 50):.1f} "
            f"us, p99 {pct(xs, 99):.1f} us, max {xs.max(initial=0):.1f} us")
    sizes = np.array([f[0] for f in r["flushes"]])
    small = sizes < ing.flush_size
    log(f"  flushes below flush_size ({ing.flush_size} signatures): "
        f"{int(small.sum())}, {sizes[small].mean() if small.any() else 0:.1f}"
        f" signatures and {fl[small].mean() * 1e3 if small.any() else 0:.1f}"
        f" ms on average; the others: {int((~small).sum())}, "
        f"{sizes[~small].mean() if (~small).any() else 0:.1f} signatures "
        f"and {fl[~small].mean() * 1e3 if (~small).any() else 0:.1f} ms")
    k_all = sum(r["kernel_ms"].values())
    log(f"  kernels inside the flushes (CUDA events): "
        f"{json.dumps({k: round(v, 4) for k, v in r['kernel_ms'].items()})}"
        f" ms, {k_all:.3f} ms in all, {k_all / 1e3 / fl.sum() * 100:.3f} % "
        f"of flush wall")
    w = np.array(r["waited"])
    names = {wire.MSG_CHANNEL_ANNOUNCEMENT: "CA",
             wire.MSG_CHANNEL_UPDATE: "CU", wire.MSG_NODE_ANNOUNCEMENT: "NA"}
    kinds = collections.Counter(   # a message's first submission, or later
        (names[wire.msg_type(raw)], "again" if k else "first")
        for raw, k in r["sheds"])
    log(f"  wait_capacity: {int((w > 0).sum())} waits, {w.sum():.2f} s in "
        f"all; {len(r['sheds'])} sheds "
        f"{json.dumps({f'{t}:{how}': n for (t, how), n in kinds.items()})};"
        f" stats {json.dumps(st.dropped)}, accepted {st.accepted}; "
        f"launches {json.dumps(r['launches'])}")
    return out


def check_ingest(tag, r, model, no_channel_extra, dev, I):
    """The live run's stats, state tables and pending maps against the
    sequential model, and one launch of K1-K3 a flush."""
    ing, st = r["ing"], r["ing"].stats
    dropped = dict(model.dropped)
    if no_channel_extra:
        dropped[I.R_NO_CHANNEL] = dropped.get(I.R_NO_CHANNEL, 0) + \
            no_channel_extra
    want = {"accepted": len(model.accepted), "dropped": dropped,
            "batched_sigs": model.batched_sigs}
    got = {"accepted": st.accepted, "dropped": st.dropped,
           "batched_sigs": st.batched_sigs}
    log(f"  model ({tag}): {json.dumps(want)}")
    assert got == want, f"{tag}: ingest stats off the model"
    assert (ing.channels, ing.updates, ing.nodes) == (
        model.channels, model.updates, model.nodes), f"{tag}: state tables"
    assert {s: sorted(d) for s, d in ing.pending_updates.items()} == {
        s: sorted(d) for s, d in model.pending_updates.items() if d}
    assert sorted(ing.pending_nodes) == sorted(model.pending_nodes)
    if dev.type == "cuda":
        assert r["launches"] == {
            k: st.flushes * (k in ENGINE_KERNELS[MAIN])
            for k in r["launches"]}, f"{tag}: live ingest launch counts"


def check_store(tag, path, model, V, ST, GM, bucket, dev):
    """The written store: its messages are the model's accepted multiset
    and replay all true on the card; returns its index, messages and
    gossmap."""
    import collections

    idx = ST.load_store(path)
    msgs = [idx.message(i) for i in range(len(idx))]
    assert collections.Counter(msgs) == collections.Counter(
        model.accepted), f"{tag}: stored multiset"
    res = V.verify_store(idx, bucket, device=dev)
    assert res.sig_ok.all() and idx.check_crcs().all(), f"{tag}: replay"
    g = GM.from_store(idx)
    nodes = {n for pair in model.channels.values() for n in pair}
    log(f"  store ({tag}): {len(idx)} records, replay "
        f"{int(res.sig_ok.sum())}/{res.n_sigs} true, multiset equal to "
        f"the model's; gossmap {g.n_channels} channels, {g.n_nodes} nodes")
    assert (g.n_channels, g.n_nodes) == (len(model.channels), len(nodes))
    return idx, msgs


def live_ingest(args, gen, dev, card, torch, F, E, H, S, ref, tmpdir,
                high_wm=None):
    """Phase 6; returns K1-K3's launch counts of the live runs and each
    wave's end-to-end figures."""
    import shutil

    from lightning_tpu_torch.gossip import gossmap as GM
    from lightning_tpu_torch.gossip import ingest as I
    from lightning_tpu_torch.gossip import store as ST
    from lightning_tpu_torch.gossip import synth
    from lightning_tpu_torch.gossip import verify as V
    from lightning_tpu_torch.gossip import wire

    src = os.path.join(tmpdir, "ingest_src.gs")
    t0 = time.perf_counter()
    info = synth.make_network_store(
        src, args.ingest_channels, args.ingest_nodes, seed=args.seed + 6,
        device=dev, n_corrupt=8, off_curve=1, bad_tag=1, oversized=3)
    raws, parsed, valid, ca_of = ingest_messages(wire, src, info)
    high_wm = high_wm or I.INGEST_HIGH_WM
    gap = high_wm + 2 * (high_wm // 4)          # the backlog's hard cap
    feed = [raws[i] for i in ingest_feed(parsed, valid, ca_of, gen, gap)]
    feed_b = [raws[i] for i in bolt7_feed(parsed, ca_of)]
    pubs = E.derive_pubkeys(F.from_int_array(info["seckeys"]).numpy(),
                            args.bucket, device=dev)
    stale = stale_updates(wire, ref, parsed, ca_of, info, pubs, gen, 20)
    verdict = dict(zip(raws, valid.tolist()))
    verdict.update((m, True) for m in stale)

    def sigs(ms):
        return sum(4 if wire.msg_type(m) == wire.MSG_CHANNEL_ANNOUNCEMENT
                   else 1 for m in ms)

    log(f"live ingest: {len(raws)} messages ({info['channels']} CA, "
        f"{info['channel_updates']} CU, {info['nodes']} NA; "
        f"{info['sigs']} signatures) made in "
        f"{time.perf_counter() - t0:.1f} s; the gap wave feeds "
        f"{len(feed)} messages, {sigs(feed)} signatures (100 duplicates, "
        f"gap {gap} steps), then {len(stale)} stale updates; the BOLT #7 "
        f"wave feeds the store's {len(feed_b)} in sync order to a new "
        f"ingest")

    # the gap wave: related messages a hard cap apart, so the sequential
    # model predicts every count given the live sheds
    out = os.path.join(tmpdir, "ingest.gs")
    ra = drive_ingest(I, V, H, torch, dev, out, high_wm, (feed, stale))
    figures = {"gap": report_ingest("gap wave", ra, wire, card, len(feed),
                                    sigs(feed))}
    model = IngestModel(wire, I, verdict, ra["sheds"])
    for raw in feed + stale:
        model.submit(raw)
    check_ingest("gap wave", ra, model, 0, dev, I)
    st = ra["ing"].stats
    assert all(st.dropped.get(r, 0) > 0 for r in (
        I.R_DUP, I.R_STALE, I.R_NO_CHANNEL, I.R_BADSIG)), "a path unused"
    idx, msgs = check_store("gap wave", out, model, V, ST, GM, args.bucket,
                            dev)
    rows = gen.choice(len(msgs), min(1024, len(msgs)), replace=False)
    sample = [wire.parse_gossip(msgs[i]) for i in rows]
    items = V.message_items(sample, lambda s, d: model.channels[s][d])
    z = np.stack([np.frombuffer(ref.sha256d(p.signed_region()), np.uint8)
                  for p in sample])[items.row_index()]
    oracle = S.host_verify_batch(z, items.sigs, items.pubkeys)
    log(f"  oracle: {int(oracle.sum())}/{len(oracle)} signatures of "
        f"{len(rows)} stored messages true")
    assert oracle.all(), "oracle sample"

    # the BOLT #7 wave: each channel's updates right behind it, so they
    # meet it still queued or in flight and wait in the pending map.  The
    # model applies each message before the next, so it holds none of
    # them: a channel_update held live and resubmitted counts one more
    # pending_no_channel, and a shed at either submission is a shed at
    # the model's one
    out_b = os.path.join(tmpdir, "ingest_bolt7.gs")
    rb = drive_ingest(I, V, H, torch, dev, out_b, high_wm, (feed_b,))
    figures["bolt7"] = report_ingest("BOLT #7 wave", rb, wire, card,
                                     len(feed_b), sigs(feed_b))
    cu = wire.MSG_CHANNEL_UPDATE
    model_b = IngestModel(wire, I, verdict, {
        (raw, 0 if wire.msg_type(raw) == cu else k)
        for raw, k in rb["sheds"]})
    for raw in feed_b:
        model_b.submit(raw)
    held = sum(1 for raw, k in rb["seen"].items()
               if k > 1 and wire.msg_type(raw) == cu)
    log(f"  BOLT #7 wave: {held} channel_updates held for their channel "
        f"and resubmitted")
    check_ingest("BOLT #7 wave", rb, model_b, held, dev, I)
    check_store("BOLT #7 wave", out_b, model_b, V, ST, GM, args.bucket, dev)

    # recovery: a copy of the gap wave's store torn mid-record, 8
    # timestamps corrupted
    cp = os.path.join(tmpdir, "ingest_torn.gs")
    shutil.copyfile(out, cp)
    bad = np.sort(gen.choice(len(idx) - 1, 8, replace=False))
    last = int(idx.offsets[-1]) - 12            # the torn record's start
    torn = (12 + int(idx.lengths[-1])) // 2
    with open(cp, "r+b") as f:
        for i in bad:
            f.seek(int(idx.offsets[i]) - 4)
            f.write(int(idx.timestamps[i] ^ 0x5A5A).to_bytes(4, "big"))
        f.truncate(last + torn)
    del idx
    keys = V.make_scid_map(ST.load_store(out).select(np.asarray(
        [wire.msg_type(m) == wire.MSG_CHANNEL_ANNOUNCEMENT for m in msgs])))

    def check_on_card(ms):
        items = V.message_items(
            [wire.parse_gossip(m) for m in ms],
            lambda s, d: keys(np.array([s], np.uint64),
                              np.array([d]))[0].tobytes())
        ok = V.verify_items(items, device=dev)
        return [bool(ok[items.msg_index == i].all()) for i in range(len(ms))]

    H.reset_launches()
    ridx, rep = ST.recover_store(cp, check_sigs=check_on_card)
    rc = H.launch_counts()
    log(f"  recovery: torn {rep.truncated_bytes} bytes, {rep.crc_bad} "
        f"CRC-bad, {rep.requalified} requalified on the card, "
        f"{rep.dropped} dropped, {rep.records} records; launches "
        f"{json.dumps(rc)}")
    if dev.type == "cuda":
        assert rc == {k: int(k in ENGINE_KERNELS[MAIN]) for k in rc}, \
            "the re-check did not run on the card"
    assert (rep.truncated_bytes, rep.crc_bad, rep.requalified, rep.dropped,
            rep.records) == (torn, 8, 8, 0, len(msgs) - 1), "recovery"
    assert ridx.alive().all()
    return {k: ra["launches"][k] + rb["launches"][k]
            for k in ENGINE_KERNELS[MAIN]}, figures


# ---------------------------------------------------------------------------
# Phase 7: routing on the card


def route_mix(RD, g, rng_seed, n):
    """bench.py route's traffic: random node pairs, 1,000,000 msat."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(n):
        a, b = rng.integers(0, g.n_nodes, 2)
        if a == b:
            b = (b + 1) % g.n_nodes
        out.append(RD.RouteQuery(bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                                 1_000_000))
    return out


def route_extra(RD, g, gen, n):
    """Amounts log-uniform from 10^3 to 10^9 msat, 5 % of the queries
    with 1-3 excluded scids."""
    out = []
    for _ in range(n):
        a, b = gen.choice(g.n_nodes, 2, replace=False)
        q = RD.RouteQuery(bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                          int(10 ** gen.uniform(3, 9)))
        if gen.random() < 0.05:
            q.excluded_scids = {int(s) for s in gen.choice(
                g.scids, int(gen.integers(1, 4)), replace=False)}
        out.append(q)
    return out


def route_edges(RD, g):
    """The named edge cases and the answer each must get."""
    a, b = bytes(g.node_ids[0]), bytes(g.node_ids[1])
    return {
        "src_is_dst": (RD.RouteQuery(a, a, 1_000),
                       ("noroute", "source is destination")),
        "unknown_node": (RD.RouteQuery(a, b"\x02" + b"\xee" * 32, 1_000),
                         ("error",)),
        "amount_cap": (RD.RouteQuery(a, b, RD.ROUTE_MAX_AMOUNT_MSAT + 1),
                       ("fallback", RD.R_AMOUNT_CAP)),
        "riskfactor_cap": (RD.RouteQuery(
            a, b, 1_000, riskfactor=RD.ROUTE_MAX_RISKFACTOR + 1),
            ("fallback", RD.R_RISKFACTOR_CAP)),
        "max_hops_10": (RD.RouteQuery(a, b, 1_000, max_hops=10),
                        ("fallback", RD.R_MAX_HOPS)),
    }


def mcf_mix(MD, g, rng_seed, n):
    """bench.py mcf's traffic: random pairs, 100,000 to 50,000,000 msat,
    max_parts 8."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(n):
        a, b = rng.integers(0, g.n_nodes, 2)
        if a == b:
            b = (b + 1) % g.n_nodes
        out.append(MD.McfQuery(bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                               int(rng.integers(100_000, 50_000_000)),
                               max_parts=8))
    return out


def hops(route):
    return [(h.node_id, h.scid, h.direction, h.amount_msat, h.delay)
            for h in route]


def route_parity(RD, DJ, g, queries, results):
    """Each device answer against dijkstra.getroute as the reference's
    parity test holds it: the same outcome, the same route cost, and
    where the hops are the same, the same amount and delay at the
    source.  Returns (differing answers, same-cost routes whose hops
    differ: equal-cost ties broken otherwise)."""
    bad = ties = 0
    for q, r in zip(queries, results):
        try:
            route, src = DJ.getroute(
                g, q.source, q.destination, q.amount_msat,
                final_cltv=q.final_cltv, riskfactor=q.riskfactor,
                excluded_scids=q.excluded_scids, with_source=True)
            want = "ok"
        except DJ.NoRoute:
            want = "noroute"
        if r[0] != want:
            bad += 1
            continue
        if want == "ok":
            if RD.route_cost_msat(g, r[1], q.riskfactor) != \
                    RD.route_cost_msat(g, route, q.riskfactor):
                bad += 1
            elif hops(r[1]) != hops(route):
                ties += 1
            elif r[2] != src:
                bad += 1
    return bad, ties


def serve(svc, calls):
    """Start `svc`, await every call concurrently, close it; returns
    (answers or exceptions, seconds)."""
    async def go():
        svc.start()
        t0 = time.perf_counter()
        out = await asyncio.gather(*(c(svc) for c in calls),
                                   return_exceptions=True)
        dt = time.perf_counter() - t0
        await svc.close()
        return out, dt
    return asyncio.run(go())


async def _waves(svc, waves, before=None):
    """Each wave's calls concurrently, one wave after the other (a wave
    of a batch's queries is one flush); ``before(i)`` runs ahead of wave
    i.  Returns each wave's answers or exceptions."""
    svc.start()
    out = []
    try:
        for i, wave in enumerate(waves):
            if before is not None:
                before(i)
            out.append(await asyncio.gather(*(c(svc) for c in wave),
                                            return_exceptions=True))
    finally:
        await svc.close()
    return out


def by_label(s1, s0, name):
    """{label values joined by "/": increase} of a counter between two
    obs snapshots, zero entries left out."""
    def vals(snap):
        fam = snap["metrics"].get(name, {"samples": []})
        return {"/".join(x["labels"].values()): x["value"]
                for x in fam["samples"]}
    a, b = vals(s0), vals(s1)
    return {k: v - a.get(k, 0) for k, v in sorted(b.items())
            if v != a.get(k, 0)}


def serve_counted(svc, calls, wave=None):
    """serve(), or with ``wave`` the calls in waves of that many (a wave
    a flush), with what the service's family counted meanwhile: its
    flight records, queries by (path, outcome), host answers by reason,
    flush-loop restarts and every flight outcome."""
    from lightning_tpu_torch import obs
    from lightning_tpu_torch.obs import flight

    fam = svc.FAMILY
    base = max([r["dispatch_id"] for r in flight.recent(fam)] or [0])
    s0 = obs.snapshot()
    if wave is None:
        answers, dt = serve(svc, calls)
    else:
        t0 = time.perf_counter()
        got = asyncio.run(_waves(svc, [calls[i:i + wave] for i in range(
            0, len(calls), wave)]))
        dt = time.perf_counter() - t0
        answers = [a for w in got for a in w]
    s1 = obs.snapshot()
    st = {"records": [r for r in flight.recent(fam)
                      if r["dispatch_id"] > base],
          "queries": by_label(s1, s0, f"clntpu_{fam}_queries_total"),
          "host": by_label(s1, s0, f"clntpu_{fam}_fallback_total"),
          "restarts": delta(s1, s0, "clntpu_loop_restarts_total",
                            loop=f"{fam}_flush"),
          "dispatches": by_label(s1, s0, "clntpu_dispatches_total"),
          "s0": s0, "s1": s1}
    return answers, dt, st


def service_line(tag, st, n, dt):
    recs = st["records"]
    fl = [r["dispatch_ms"] for r in recs]
    log(f"{tag}: {n} concurrent queries in {dt:.3f} s ({n / dt:.1f} q/s), "
        f"{len(recs)} flushes, flush p50 {pct(fl, 50):.2f} ms p99 "
        f"{pct(fl, 99):.2f} ms (flight records' dispatch_ms), device "
        f"occupancy {sum(r['n_real'] for r in recs)}/"
        f"{sum(r['lanes'] for r in recs)} lanes, outcomes "
        f"{sorted({r['outcome'] for r in recs})}, queries by (path, "
        f"outcome) {st['queries']}, host answers by reason {st['host']}, "
        f"restarts {st['restarts']}")


def same_route_answer(res, ans):
    """A solve_batch tuple and a service answer (route, src) or error."""
    if res[0] == "ok":
        return (not isinstance(ans, BaseException)
                and hops(ans[0]) == hops(res[1]) and ans[1] == res[2])
    return isinstance(ans, BaseException)


def cluster_sizes(HR, r1_args, r1_want, in_off, arcs, r2_lanes, r2_want,
                  n_mcf, card, torch):
    """Each routing kernel at every cluster size (R2's node entries in
    shared memory where they fit, as its wrapper decides): every size
    equal to the plain version, then its ms a call (CUDA events, 10 calls
    after 2 warm-ups) and the clusters the card holds at once.  Returns
    {kernel: {"C=<size>": ms}}."""
    from lightning_tpu_torch import _build

    runs = {}
    for C in HR.CLUSTER_SIZES:
        runs[("route_sweep", C)] = (
            (lambda C=C: HR.route_sweep(*r1_args, in_off=in_off,
                                        _cluster=C)),
            r1_want, _build.lib("route_sweep").route_sweep_max_clusters(C),
            "global")
        per, _ = HR.split(n_mcf, C)
        shared = HR.r2_shared(per)
        runs[("mcf_ssp", C)] = (
            (lambda C=C: HR.mcf_solve(*arcs, *r2_lanes, n_mcf,
                                      _cluster=C)),
            r2_want, _build.lib("mcf_ssp").mcf_ssp_max_clusters(
                C, per, int(shared)), "shared" if shared else "global")
    out = {"route_sweep": {}, "mcf_ssp": {}}
    for (k, C), (fn, want, fit, where) in runs.items():
        got = fn()
        bad = sum(int((a != b).sum()) for a, b in zip(got, want))
        ms = time_cuda(torch, fn, reps=10)
        log(f"  {k} C={C} (labels in {where} memory): {ms:.4f} ms/call, "
            f"{fit} clusters at once, {bad} mismatching elements, on "
            f"{card}")
        assert bad == 0, f"{k} C={C} disagrees with its plain version"
        out[k][f"C={C}"] = ms
    for k, C in (("route_sweep", HR.R1_CLUSTER),
                 ("mcf_ssp", HR.R2_CLUSTER)):
        best = min(out[k], key=out[k].get)
        log(f"{k}: fastest {best} ({out[k][best]:.4f} ms); the default is "
            f"a cluster of {C}")
    return out


def routing(args, g, dev, card, torch):
    """Phase 7: getroute (R1) and getroutes (R2) over phase 3's graph on
    the card.  Returns the two kernels' records for the kernels line."""
    from lightning_tpu_torch.routing import device as RD
    from lightning_tpu_torch.routing import dijkstra as DJ
    from lightning_tpu_torch.routing import hopper_route as HR
    from lightning_tpu_torch.routing import mcf as MCF
    from lightning_tpu_torch.routing import mcf_device as MD
    from lightning_tpu_torch.routing.planes import RoutePlanes

    gen = np.random.default_rng(args.seed + 7)
    t_phase = t0 = time.perf_counter()
    planes = RoutePlanes.build(g, dev)
    plane_args, _ = RD._device_plane_args(planes)
    mp = MD.McfPlanes.build(g, dev)
    arcs = mp.device_arcs()
    torch.cuda.synchronize()
    on_card = sum(t.numel() * t.element_size()
                  for t in (*planes.dev.values(), *mp.dev.values()))
    log(f"routing planes of {g.n_channels} channels, {g.n_nodes} nodes "
        f"in {time.perf_counter() - t0:.2f} s: n_pad {planes.n_pad}, "
        f"e_pad {planes.e_pad} ({planes.e_real} edges), A_fwd_pad "
        f"{mp.a_fwd_pad} ({mp.a_fwd_real} forward arcs), {on_card} bytes "
        f"of planes on the card")

    # 7.1: each kernel against its plain version on the card
    rmix = route_mix(RD, g, 11, 1024)
    B = RD.ROUTE_BATCH
    in_off = planes.dev["in_off"]

    def r1_lanes(chunk):
        lanes = [np.stack([planes.edge_ok_mask()] * len(chunk)),
                 np.array([g.node_index(q.source) for q in chunk], np.int32),
                 np.array([g.node_index(q.destination) for q in chunk],
                          np.int32),
                 np.full(len(chunk), 1_000_000, np.int64),
                 np.full(len(chunk), 18, np.int64),
                 np.full(len(chunk), 10, np.int64)]
        return (*plane_args,
                *(torch.as_tensor(a, device=dev) for a in lanes),
                planes.n_pad, RD.DEFAULT_MAX_HOPS)

    r1_bad, r1_err, r1_work, r1_reach, r1_ovf = [0, 0, 0], 0, [], 0, 0
    for start in range(0, len(rmix), B):
        args_ = r1_lanes(rmix[start:start + B])
        got = HR.route_sweep(*args_, in_off=in_off, work=r1_work)
        want = HR.route_sweep_plain(*args_)
        r1_bad = [x + int((a != b).sum()) for x, a, b in
                  zip(r1_bad, got, want)]
        r1_err = max(r1_err, *(int((a.long() - b.long()).abs().max())
                               for a, b in zip(got, want)))
        r1_reach += int((got[0] < HR.INF_COST).sum())
        r1_ovf += int(got[2].sum())
        if start == 0:
            r1_args, r1_want = args_, want
    w1 = torch.cat(r1_work).cpu().numpy()
    log(f"R1 against route_sweep_plain, the {len(rmix)} queries of the "
        f"route mix, {B} a launch: mismatching elements (dist_src, via, "
        f"ovf) {r1_bad}; {r1_reach} reachable, {r1_ovf} overflow; per "
        f"query sweeps run median {np.median(w1[:, 0]):.1f} max "
        f"{w1[:, 0].max()} (of {RD.DEFAULT_MAX_HOPS}), edges priced median "
        f"{np.median(w1[:, 1]):.1f} max {w1[:, 1].max()} (a full sweep "
        f"prices {planes.e_pad}, all {RD.DEFAULT_MAX_HOPS} "
        f"{planes.e_pad * RD.DEFAULT_MAX_HOPS})")
    mmix = mcf_mix(MD, g, 13, 64)
    big = [MD.McfQuery(q.source, q.destination,
                       int(gen.integers(10**10, 10**11)), max_parts=8)
           for q in mmix[:MD.MCF_BATCH]]
    r2_bad, r2_err, r2_work, r2_s = [0, 0, 0, 0], 0, [], []
    for chunk in (mmix[:MD.MCF_BATCH], big):
        ops = MD._prep_chunk(mp, chunk, MD.MCF_BATCH, 1.0,
                             [None] * len(chunk))
        lanes2 = [torch.as_tensor(a, device=dev) for a in ops]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = HR.mcf_solve(*arcs, *lanes2, mp.n_pad, work=r2_work)
        torch.cuda.synchronize()
        r2_s.append(time.perf_counter() - t0)
        want = HR.mcf_solve_plain(*arcs[:2], *lanes2, mp.n_pad)
        r2_bad = [x + int((a != b).sum()) for x, a, b in
                  zip(r2_bad, got, want)]
        r2_err = max(r2_err, *(int((a.long() - b.long()).abs().max())
                               for a, b in zip(got, want)))
        if len(r2_s) == 1:
            r2_lanes, r2_want = lanes2, want
    w2 = torch.cat(r2_work).cpu().numpy()
    work = w2.tolist()
    log(f"R2 against mcf_solve_plain, {MD.MCF_BATCH} queries of the mcf mix "
        f"and {MD.MCF_BATCH} of 10^10-10^11 msat: mismatching elements "
        f"(flow, remaining, nopath, walkfail) {r2_bad}; per query "
        f"(augmentations, rounds, frontier arcs visited) {work}; rounds "
        f"median {np.median(w2[:, 1]):.1f} max {w2[:, 1].max()}, arcs "
        f"median {np.median(w2[:, 2]):.1f} max {w2[:, 2].max()}; one "
        f"dispatch each, {r2_s[0] * 1e3:.1f} and {r2_s[1] * 1e3:.1f} ms")
    assert sum(r1_bad) == 0 and sum(r2_bad) == 0, \
        "a routing kernel disagrees with its plain version"
    assert any(w[0] > 1 for w in work), "no multi-part solve compared"
    sizes = cluster_sizes(HR, r1_args, r1_want, in_off, arcs, r2_lanes,
                          r2_want, mp.n_pad, card, torch)

    # 7.2: the main path, counts set to 0 just before and read just after
    extra = route_extra(RD, g, gen, 64)
    edges = route_edges(RD, g)
    queries = rmix + extra + [q for q, _ in edges.values()]
    torch.cuda.synchronize()
    HR.reset_launches()
    t0 = time.perf_counter()
    res = RD.solve_batch(planes, queries, batch=B)
    t_batch = time.perf_counter() - t0
    kinds = {k: sum(r[0] == k for r in res)
             for k in ("ok", "noroute", "fallback", "error")}
    reasons = {}
    for r in res[:len(rmix) + len(extra)]:
        if r[0] == "fallback":
            reasons[r[1]] = reasons.get(r[1], 0) + 1
    log(f"getroute solve_batch: {len(queries)} queries at B={B} in "
        f"{t_batch:.3f} s ({len(queries) / t_batch:.1f} q/s): {kinds}; "
        f"host answers outside the edge cases by reason {reasons}")
    for (name, (q, want)), r in zip(edges.items(), res[-len(edges):]):
        log(f"  edge case {name}: {r[0]} {r[1] if len(r) > 1 else ''}")
        assert r[:len(want)] == want, f"edge case {name}: {r}"
    assert set(reasons) <= {RD.R_OVERFLOW, RD.R_RECONSTRUCT}, reasons

    svc = RD.RouteService(lambda: g, device=dev, high_wm=4 * len(queries))
    answers, dt, st = serve_counted(svc, [
        (lambda q: lambda s: s.getroute(
            q.source, q.destination, q.amount_msat, q.final_cltv,
            q.riskfactor, q.max_hops, q.excluded_scids,
            with_source=True))(q) for q in rmix])
    service_line("getroute RouteService", st, len(rmix), dt)
    diff = sum(not same_route_answer(r, a) for r, a in zip(res, answers))
    log(f"RouteService against solve_batch: {diff} answers differ")
    assert diff == 0 and st["restarts"] == 0
    assert set(st["host"]) <= {RD.R_OVERFLOW, RD.R_RECONSTRUCT}
    flush_ms = {"route": [r["dispatch_ms"] for r in st["records"]]}

    mq = mmix + [MD.McfQuery(
        mmix[0].source, mmix[0].destination, 2_000_000,
        layers=MCF.Layers(
            disabled={int(g.scids[5])},
            biases={int(s): float(b) for s, b in zip(
                g.scids[10:20], gen.integers(-500, 2000, 10))},
            reserved={(int(s), 0): 500_000 for s in g.scids[20:40]}),
        max_parts=8)]
    layered = MD.McfQuery(
        mmix[1].source, b"\x03" * 33, 30_000, layers=MCF.Layers(
            created={999_999: {"source": mmix[1].source,
                               "destination": b"\x03" * 33,
                               "capacity_sat": 50_000}},
            updates={(999_999, 0): {"enabled": True}}))
    t0 = time.perf_counter()
    mres = MD.solve_mcf_batch(mp, mq + [layered])
    t_mcf = time.perf_counter() - t0
    log(f"getroutes solve_mcf_batch: {len(mq) + 1} queries at "
        f"B={MD.MCF_BATCH} in {t_mcf:.3f} s ({(len(mq) + 1) / t_mcf:.1f} "
        f"q/s): {[r[0] for r in mres].count('ok')} ok, "
        f"{[r[0] for r in mres].count('mcferr')} unroutable, answers "
        f"{[r if r[0] != 'ok' else r[0] for r in mres if r[0] != 'ok']}")
    assert mres[-1] == ("fallback", MD.R_LAYERED), mres[-1]
    assert all(r[0] in ("ok", "mcferr") for r in mres[:-1]), \
        "a getroutes host answer outside the named reasons"

    msvc = MD.McfService(lambda: g, device=dev, high_wm=4 * len(mq))
    manswers, dt, mst = serve_counted(msvc, [
        (lambda q: lambda s: s.getroutes(
            q.source, q.destination, q.amount_msat, layers=q.layers,
            max_parts=q.max_parts))(q) for q in mq + [layered]])
    service_line("getroutes McfService", mst, len(mq) + 1, dt)
    flush_ms["mcf"] = [r["dispatch_ms"] for r in mst["records"]]
    mdiff = sum(not (r[1] == a if r[0] == "ok"
                     else isinstance(a, BaseException))
                for r, a in zip(mres[:-1], manswers[:-1]))
    log(f"McfService against solve_mcf_batch: {mdiff} answers differ; the "
        f"layer-created channel's query answered by the host: "
        f"{mst['host']}")
    assert mdiff == 0 and mst["host"] == {MD.R_LAYERED: 1}
    assert not isinstance(manswers[-1], BaseException)
    counts = HR.launch_counts()
    torch.cuda.synchronize()
    log(f"routing launches on the main path: {json.dumps(counts)}")
    assert all(n > 0 for n in counts.values()), "a routing kernel unused"

    # 7.3: the host oracles on samples
    sample = list(range(0, len(rmix), len(rmix) // 64))[:64]
    t0 = time.perf_counter()
    bad, ties = route_parity(RD, DJ, g, [queries[i] for i in sample],
                             [res[i] for i in sample])
    t_dj = (time.perf_counter() - t0) / len(sample)
    log(f"dijkstra.getroute on {len(sample)} sampled queries: {bad} "
        f"answers differ, {ties} equal-cost routes with other hops; the "
        f"host oracle takes {t_dj * 1e3:.1f} ms a query (for scale)")
    msample = list(range(0, len(mq), len(mq) // 16))[:15] + [len(mq) - 1]
    t0 = time.perf_counter()
    mbad = 0
    for i in msample:
        q = mq[i]
        try:
            want = ("ok", MCF.getroutes(g, q.source, q.destination,
                                        q.amount_msat, layers=q.layers,
                                        max_parts=q.max_parts))
        except MCF.McfError as e:
            want = ("mcferr", str(e))
        mbad += json.dumps(want, default=str) != json.dumps(
            mres[i], default=str)
    t_host = (time.perf_counter() - t0) / len(msample)
    log(f"mcf.getroutes on {len(msample)} sampled queries (the layered "
        f"one included): {mbad} result dicts differ; the host oracle "
        f"takes {t_host * 1e3:.1f} ms a query (for scale)")
    assert bad == 0 and mbad == 0, "a device answer differs from its oracle"

    # 7.4: 100 channel_updates, patched planes against a fresh build
    for c in gen.choice(g.n_channels, 100, replace=False):
        d = int(gen.integers(0, 2))
        assert g.apply_channel_update(
            int(g.scids[c]), d, timestamp=int(g.timestamps[d, c]) + 1,
            disabled=bool(gen.random() < 0.2), cltv_delta=40,
            htlc_min_msat=int(gen.integers(0, 1000)),
            htlc_max_msat=int(gen.integers(0, 10_000)) << 20,
            fee_base_msat=int(gen.integers(0, 5000)),
            fee_ppm=int(gen.integers(0, 10000)))
    patched = RoutePlanes.current(g, planes, dev)
    fresh = RoutePlanes.build(g, dev)
    resample = [queries[i] for i in sample]
    n_patch = 0 if patched.patch_idx is None else len(patched.patch_idx)
    a = RD.solve_batch(patched, resample, batch=B)
    b = RD.solve_batch(fresh, resample, batch=B)
    same_planes = all(torch.equal(patched.dev[k], fresh.dev[k])
                      for k in RD._PLANE_ORDER)
    log(f"100 channel_updates: {n_patch} lanes "
        f"patched, planes equal to a fresh build: {same_planes}; re-solve "
        f"of {len(resample)} queries equal: {repr(a) == repr(b)}")
    assert n_patch > 0 and same_planes and repr(a) == repr(b)

    # 7.5: timing (CUDA events, 20 calls after 2 warm-ups)
    ops = MD._prep_chunk(mp, mmix[:MD.MCF_BATCH], MD.MCF_BATCH, 1.0,
                         [None] * MD.MCF_BATCH)
    lanes2 = [torch.as_tensor(x, device=dev) for x in ops]
    E, N, Af = planes.e_pad, planes.n_pad, mp.a_fwd_pad
    Bm = MD.MCF_BATCH
    runs = {
        # planes 48 bytes an edge, the mask, the query lanes; dist, via,
        # ovf out
        "route_sweep": (lambda: HR.route_sweep(*r1_args, in_off=in_off),
                        lambda: HR.route_sweep_plain(*r1_args),
                        48 * E + B * E + 32 * B + B * (8 + 4 * N + 1)),
        # arc endpoints, the arcs by tail, costs and residuals, the query
        # lanes; flows, remaining and the flags out
        "mcf_ssp": (lambda: HR.mcf_solve(*arcs, *lanes2, mp.n_pad),
                    lambda: HR.mcf_solve_plain(*arcs[:2], *lanes2, mp.n_pad),
                    16 * Af + 4 * (mp.n_pad + 1) + 4 * arcs[3].numel()
                    + 16 * Bm * Af + 20 * Bm + Bm * (8 * Af + 10)),
    }
    records = []
    mism = {"route_sweep": (sum(r1_bad), r1_err),
            "mcf_ssp": (sum(r2_bad), r2_err)}
    cluster = {"route_sweep": HR.R1_CLUSTER, "mcf_ssp": HR.R2_CLUSTER}
    work_median = {
        "route_sweep": {"sweeps": float(np.median(w1[:, 0])),
                        "edges_priced": float(np.median(w1[:, 1]))},
        "mcf_ssp": {"augmentations": float(np.median(w2[:, 0])),
                    "rounds": float(np.median(w2[:, 1])),
                    "arcs": float(np.median(w2[:, 2]))}}
    for k, (kern, plain, nbytes) in runs.items():
        ms = time_cuda(torch, kern, reps=20)
        plain_ms = time_cuda(torch, plain, reps=1, warm=1)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"time {k}: {ms:.4f} ms/call, plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.4f} ms (bytes: {nbytes} read and written once) on "
            f"{card}")
        records.append({
            "name": k, "route": "cuda",
            "source": f"lightning_tpu_torch/routing/csrc/{k}.cu",
            "replaces": ROUTING_REPLACES[k],
            "launches": counts[WRAPPER.get(k, k)], "path": "routing",
            "max_abs_err": mism[k][1], "mismatches": mism[k][0], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
            "library_ms": None, "cluster": cluster[k],
            "work": work_median[k], "cluster_ms": sizes[k]})
    log(f"phase 7 in {time.perf_counter() - t_phase:.1f} s")
    return records, flush_ms


# ---------------------------------------------------------------------------
# Phase 8: the supervised, pipelined replay


STAGES = {"prep": "clntpu_replay_prep_seconds_total",
          "prep_stall": "clntpu_replay_prep_stall_seconds_total",
          "dispatch": "clntpu_replay_dispatch_seconds_total",
          "readback": "clntpu_replay_readback_seconds_total"}


def metric(snap, name, **labels):
    """A counter's value, or a histogram's (count, sum), summed over the
    samples of `name` whose labels match."""
    fam = snap["metrics"].get(name, {"kind": "counter", "samples": []})
    xs = [x for x in fam["samples"]
          if all(x["labels"].get(k) == v for k, v in labels.items())]
    if fam["kind"] == "histogram":
        return sum(x["count"] for x in xs), sum(x["sum"] for x in xs)
    return sum(x["value"] for x in xs)


def delta(s1, s0, name, **labels):
    a, b = metric(s1, name, **labels), metric(s0, name, **labels)
    return tuple(x - y for x, y in zip(a, b)) if isinstance(a, tuple) \
        else a - b


def expect_raises(exc, fn, *a, **kw):
    """fn's exception of type `exc`; anything else (or nothing) fails."""
    try:
        fn(*a, **kw)
    except exc as e:
        return e
    raise AssertionError(f"{getattr(fn, '__name__', fn)} did not raise "
                         f"{exc.__name__}")


def supervised_replay(args, path, expected, dev, card, torch, H, V, ST, E,
                      ref):
    """Phase 8: phase 3's store through the supervised, pipelined replay
    at depth 0 and depth 2, a fault-injected replay, and one supervised
    sign and check at phase 5's width; returns the launch counts of the
    six replays, set to 0 just before them and read just after."""
    import collections

    from lightning_tpu_torch import obs
    from lightning_tpu_torch.channel import commitment as C
    from lightning_tpu_torch.daemon import hsmd
    from lightning_tpu_torch.obs import flight
    from lightning_tpu_torch.resilience import breaker, faultinject
    from lightning_tpu_torch.resilience import quarantine

    t_phase = time.perf_counter()
    breaker.reset_for_tests()
    flight.reset_for_tests()
    torch.cuda.synchronize()
    H.reset_launches()

    # 8.1: three replays at depth 0 and three at depth 2, in turns; each
    # number is a delta of obs.snapshot()
    runs: dict = {0: [], 2: []}
    n_buckets = 0
    for depth in (0, 2, 2, 0, 0, 2):
        s0 = obs.snapshot()
        t0 = time.perf_counter()
        idx = ST.load_store(path)
        assert idx.check_crcs().all(), "store crc mismatch"
        res = V.verify_store(idx, args.bucket, device=dev, depth=depth)
        wall = time.perf_counter() - t0
        s1 = obs.snapshot()
        wrong = np.nonzero(res.sig_ok != expected)[0]
        assert len(wrong) == 0, \
            f"depth {depth}: wrong verdicts at {wrong[:20].tolist()}"
        d = {k: delta(s1, s0, n) for k, n in STAGES.items()}
        n_fl, t_fl = delta(s1, s0, "clntpu_verify_flush_seconds")
        n_ov, ov = delta(s1, s0, "clntpu_replay_overlap_ratio")
        assert n_fl == 1 and n_ov == 1, "one replay, one observation"
        d.update(sig_s=res.n_sigs / t_fl, verify_s=t_fl, overlap=ov,
                 wall_s=wall)
        runs[depth].append(d)
        n_buckets = res.buckets
        log(f"replay depth {depth}: {res.n_sigs} signatures, 0 wrong, "
            + json.dumps({k: round(v, 4) for k, v in d.items()}))
        del idx, res
    torch.cuda.synchronize()
    counts = H.launch_counts()
    log(f"launches in phase 8's six replays: {json.dumps(counts)}")
    main = ENGINE_KERNELS[MAIN]
    assert all(counts[k] == 6 * n_buckets for k in main) and \
        sum(counts.values()) == 6 * n_buckets * len(main), \
        "K1-K3 once a bucket of each replay, nothing else"
    med = {depth: {k: float(np.median([r[k] for r in rs])) for k in rs[0]}
           for depth, rs in runs.items()}
    log(f"phase 8 medians of 3 replays (obs.snapshot deltas; sig/s over "
        f"clntpu_verify_flush_seconds) on {card}: " + json.dumps(
            {f"depth {k}": {m: round(v, 4) for m, v in x.items()}
             for k, x in med.items()}))
    fam = flight.summary()["families"]["verify"]
    last = {k: fam["last"][k] for k in (
        "dispatch_id", "n_real", "queue_wait_ms", "prep_ms", "dispatch_ms",
        "readback_ms", "h2d_bytes", "d2h_bytes", "outcome")}
    log(f"flight ring, verify: {fam['total']} dispatches, {fam['ring']} "
        f"in the ring, last {json.dumps(last)}")
    log("last replay's buckets (queue wait, prep, dispatch, readback ms): "
        + json.dumps([[r[k] for k in ("queue_wait_ms", "prep_ms",
                                      "dispatch_ms", "readback_ms")]
                      for r in flight.recent("verify", n_buckets)]))

    # 8.2: a fault-injected replay.  The dispatch seam fails a few whole
    # buckets (each bisects; its first attempt, the whole bucket, runs
    # on the card); the rows a dispatcher rejects are isolated by the
    # bisection and raise Quarantined
    idx = ST.load_store(path)
    items, _, _ = V.extract_store(idx)
    n = len(items)
    poison = sorted({17, n // 2, n // 2 + 1, n - 1})
    spec = "dispatch:verify:raise:0.3"
    done = []

    def rejecting(b):
        if not set(poison).isdisjoint(b.sel.tolist()):
            raise ValueError("operand rejected")
        done.append(len(b.sel))
        return V.verify_bucket(b, dev)

    keep = np.ones(n, bool)
    keep[poison] = False
    breaker.reset_for_tests()
    torch.cuda.synchronize()
    H.reset_launches()
    s0 = obs.snapshot()
    t0 = time.perf_counter()
    with faultinject.arm(spec):
        q = expect_raises(quarantine.Quarantined, V.verify_items, items,
                          args.bucket, device=dev, device_fn=rejecting)
    t_q = time.perf_counter() - t0
    s1 = obs.snapshot()
    fault_counts = H.launch_counts()
    launched = fault_counts["glv_scan"]
    recs = flight.recent("verify", n_buckets)
    counted = {o: delta(s1, s0, "clntpu_dispatches_total", family="verify",
                        outcome=o) for o in flight.OUTCOMES}
    counted = {o: int(c) for o, c in counted.items() if c}
    recorded = dict(collections.Counter(r["outcome"] for r in recs))
    host = V.host_verify_items(items, idx.buf, np.asarray(poison))
    log(f"fault replay ({spec}): Quarantined rows {q.rows} in {t_q:.2f} s; "
        f"outcomes counted {json.dumps(counted)}, in the flight records "
        f"{json.dumps(recorded)}; {len(done)} clean (sub-)buckets, "
        f"{launched} K3 launches; the rows by the host oracle "
        f"{host.astype(int).tolist()}, phase 3 "
        f"{expected[poison].astype(int).tolist()}; its launches "
        f"{json.dumps(fault_counts)}")
    assert q.rows == poison, "quarantined rows"
    assert np.array_equal(q.verdicts[keep], expected[keep]), "verdicts"
    assert not q.verdicts[poison].any(), "quarantined rows left False"
    assert np.array_equal(host, expected[poison]), "host oracle on the rows"
    assert launched == len(done) > n_buckets, "clean sub-buckets on the card"
    assert counted == recorded and recorded.get("bisect", 0) > 0
    breaker.reset_for_tests()
    del idx, items

    # 8.3: one supervised sign and one check at phase 5's width
    torch.cuda.synchronize()
    H.reset_launches()
    us, them = hsmd.Hsm(b"\x11" * 32, dev), hsmd.Hsm(b"\x22" * 32, dev)
    peer = b"\x03" + b"\x44" * 32
    client = us.client(hsmd.CAP_MASTER, peer, dbid=1)
    their_client = them.client(hsmd.CAP_MASTER, peer, dbid=1)
    hashes, priv, pub = remote_commitment(C, hsmd, ref, us, client, them,
                                          their_client, 0, args.htlcs)
    point = them.per_commitment_point(their_client, 0)
    s0 = obs.snapshot()
    sigs = us.sign_htlc_batch(client, [bytes(h) for h in hashes], point)
    pubs = np.tile(np.frombuffer(pub, np.uint8), (len(hashes), 1))
    ok = us.check_sigs_batch(hashes, sigs, pubs)
    s1 = obs.snapshot()
    sign_rec, check_rec = flight.recent("sign")[-1], flight.recent("check")[-1]
    n_dev = delta(s1, s0, "clntpu_sign_total", op="htlc", path="device")
    log(f"supervised sign_htlc_batch ({len(hashes)} HTLCs): outcome "
        f"{sign_rec['outcome']}, {sign_rec['dispatch_ms']} ms, h2d "
        f"{sign_rec['h2d_bytes']} B; check_sigs_batch: outcome "
        f"{check_rec['outcome']}, {int(ok.sum())}/{len(ok)} true; "
        f"clntpu_sign_total{{path=device}} +{n_dev}")
    assert ok.all() and (sigs == E.host_sign_grind_batch(
        hashes, [priv] * len(hashes))).all(), "supervised sign"
    assert (sign_rec["outcome"], check_rec["outcome"], n_dev) == \
        ("ok", "ok", 1), "sign and check flight records"

    torch.cuda.synchronize()
    check_counts = H.launch_counts()
    log(f"launches of the supervised sign and check: "
        f"{json.dumps(check_counts)}; phase 8 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    assert all(check_counts[k] > 0 for k in main + ("ecdsa_sign",)), \
        "a kernel of the sign or check was not launched"
    return counts


# ---------------------------------------------------------------------------
# Phase 9: supervised routing and the observability spine


def route_calls(qs):
    return [(lambda q: lambda s: s.getroute(
        q.source, q.destination, q.amount_msat, q.final_cltv, q.riskfactor,
        q.max_hops, q.excluded_scids, with_source=True))(q) for q in qs]


def supervised_routing(args, g, dev, card, torch, kernel_rate, flush_ms7):
    """Phase 9: RouteService and McfService supervised on the card (the
    route mix and the mcf mix over phase 7's graph), under faults, with
    an incident recorder, a health engine on an injected clock and every
    journey sampled.  Returns R1's and R2's launches in the phase."""
    import contextlib
    import shutil

    from lightning_tpu_torch import obs
    from lightning_tpu_torch.obs import attribution, flight, health
    from lightning_tpu_torch.obs import incident, journey, traceexport
    from lightning_tpu_torch.resilience import breaker as BR
    from lightning_tpu_torch.resilience import deadline as DL
    from lightning_tpu_torch.resilience import faultinject as FI
    from lightning_tpu_torch.routing import device as RD
    from lightning_tpu_torch.routing import hopper_route as HR
    from lightning_tpu_torch.routing import mcf_device as MD
    from lightning_tpu_torch.routing.planes import RoutePlanes

    t_phase = time.perf_counter()
    B, Bm = RD.ROUTE_BATCH, MD.MCF_BATCH
    rmix = route_mix(RD, g, 11, 1024)
    mmix = mcf_mix(MD, g, 13, 64)
    keys = [hashlib.sha256(b"phase9-%d" % i).digest()
            for i in range(len(mmix))]
    journey.configure(sample=1, max_entities=4096)
    # the answers to hold the services to: solve_batch and
    # solve_mcf_batch on phase 7's graph as it stands (after its
    # channel_updates), launched before the counts are set to 0
    want_r = RD.solve_batch(RoutePlanes.build(g, dev), rmix, batch=B)
    want_m = MD.solve_mcf_batch(MD.McfPlanes.build(g, dev), mmix)

    # 9.1: clean, a batch's queries a wave (a flush each), counts set to
    # 0 just before and read just after
    torch.cuda.synchronize()
    HR.reset_launches()
    svc = RD.RouteService(lambda: g, device=dev, high_wm=4 * len(rmix))
    answers, dt, st = serve_counted(svc, route_calls(rmix), wave=B)
    service_line("phase 9 getroute RouteService", st, len(rmix), dt)
    msvc = MD.McfService(lambda: g, device=dev, high_wm=4 * len(mmix))
    manswers, mdt, mst = serve_counted(msvc, [
        (lambda q, k: lambda s: s.getroutes(
            q.source, q.destination, q.amount_msat, max_parts=q.max_parts,
            journey_key=k))(q, k) for q, k in zip(mmix, keys)], wave=Bm)
    service_line("phase 9 getroutes McfService", mst, len(mmix), mdt)
    torch.cuda.synchronize()
    c91 = HR.launch_counts()
    s0, s1 = st["s0"], mst["s1"]
    recs, mrecs = st["records"], mst["records"]
    diff = sum(not same_route_answer(r, a) for r, a in zip(want_r, answers))
    mdiff = sum(not (r[1] == a if r[0] == "ok"
                     else isinstance(a, BaseException))
                for r, a in zip(want_m, manswers))
    host = by_label(s1, s0, "clntpu_route_fallback_total")
    n_dev = sum(r["n_real"] for r in recs)
    dq = sum(v for k, v in by_label(s1, s0, "clntpu_route_queries_total")
             .items() if k.startswith("device/"))
    disp = {k: v for k, v in by_label(s1, s0, "clntpu_dispatches_total")
            .items() if k.split("/")[0] in ("route", "mcf")}
    io = {f"{f}/{d}": sum(r[f"{d}_bytes"] for r in rs)
          for f, rs in (("route", recs), ("mcf", mrecs))
          for d in ("h2d", "d2h")}
    io_counted = by_label(s1, s0, "clntpu_transfer_bytes_total")
    log(f"9.1 clean: answers differing from solve_batch {diff}, from "
        f"solve_mcf_batch {mdiff}; flight records route {len(recs)} mcf "
        f"{len(mrecs)}, clntpu_dispatches_total deltas {disp}; route "
        f"queries to the card {n_dev}, counted path=device {dq}, host "
        f"answers {host}; launches {json.dumps(c91)} against batches "
        f"route {sum(r['lanes'] // B for r in recs)} mcf "
        f"{sum(r['lanes'] // Bm for r in mrecs)}; staged bytes on the "
        f"records {io}, counted {io_counted}")
    assert diff == 0 and mdiff == 0, "a supervised answer differs"
    assert {r["outcome"] for r in recs + mrecs} == {"ok"}
    assert disp == {"mcf/ok": len(mrecs), "route/ok": len(recs)}
    assert set(host) <= {RD.R_OVERFLOW, RD.R_RECONSTRUCT}
    assert dq == n_dev - sum(host.values()) and n_dev == len(rmix)
    assert c91["route_sweep"] == sum(r["lanes"] // B for r in recs)
    assert c91["mcf_solve"] == sum(r["lanes"] // Bm for r in mrecs)
    assert io == io_counted, "staged bytes off the counters"
    report = attribution.report_local(kernel_rate=kernel_rate,
                                      families=["route", "mcf", "verify"])
    for fam, sec in report["families"].items():
        log(f"attribution {fam} (the flight ring's records since phase 8 "
            f"reset it): {sec['dispatches']} dispatches, {sec['pipeline']}, "
            f"stages "
            f"{json.dumps(sec['stages'])}, critical path "
            f"{sec['critical_path_s']} s, wall span {sec['wall_span_s']} s, "
            f"idle {sec['idle_s']} s, bottleneck {sec['bottleneck']}, "
            f"throughput {sec['throughput_per_s']}/s, roofline "
            f"{json.dumps(sec.get('roofline'))}")
    log(f"attribution kernel_rate {kernel_rate:.1f} items/s (65,536 over "
        f"phase 4's K1 + K2 + K3 ms on {card}); device memory "
        f"{json.dumps(attribution.sample_device_memory())}")
    fl9 = {"route": [r["dispatch_ms"] for r in recs],
           "mcf": [r["dispatch_ms"] for r in mrecs]}
    for fam in ("route", "mcf"):
        log(f"flush {fam}: phase 9 p50 {pct(fl9[fam], 50):.2f} ms p99 "
            f"{pct(fl9[fam], 99):.2f} ms ({len(fl9[fam])} flushes); "
            f"phase 7 p50 {pct(flush_ms7[fam], 50):.2f} ms p99 "
            f"{pct(flush_ms7[fam], 99):.2f} ms ({len(flush_ms7[fam])})")

    # 9.2: faults, with the incident recorder and the health engine on
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_incidents_")
    rec = incident.install(tmpdir)
    rec.start()
    clock = {"t": 0.0}
    eng = health.install(health.HealthEngine(
        interval_s=1.0, short_ticks=2, long_ticks=4, recover_ticks=2,
        now=lambda: clock["t"]))
    eng.tick()
    brk = BR.get("route")
    real_getroute = RD.DJ.getroute
    host_calls = []

    def counted_getroute(*a, **kw):
        host_calls.append(1)
        return real_getroute(*a, **kw)

    armed = contextlib.ExitStack()
    seen = {}

    def before(i):
        if i == 0:
            armed.enter_context(FI.arm("dispatch:route:raise:1.0"))
        if i == 7:
            armed.close()
            seen["launches_before_probe"] = HR.launch_counts()["route_sweep"]
            seen["state"] = brk.state
            for _ in range(2):
                clock["t"] += 1.0
                eng.tick()
            clock["t"] += 6.0
            eng.tick()
            seen["health"] = eng.report()
            time.sleep(brk.retry_in_s() + 0.05)

    HR.reset_launches()
    RD.DJ.getroute = counted_getroute
    try:
        s0 = obs.snapshot()
        base = max([r["dispatch_id"] for r in flight.recent("route")]
                   or [0])
        waves = [route_calls(rmix[i * B:(i + 1) * B]) for i in range(9)]
        svc = RD.RouteService(lambda: g, device=dev, high_wm=4 * len(rmix))
        got = asyncio.run(_waves(svc, waves, before))
        torch.cuda.synchronize()
        c92 = HR.launch_counts()
        # a hung dispatch on a fresh service with a deadline
        dsvc = RD.RouteService(lambda: g, device=dev, deadline_s=0.05)
        with FI.arm("dispatch:route:hang:1:0.3"):
            dgot = asyncio.run(_waves(dsvc, [route_calls(rmix[:B])]))[0]
        time.sleep(0.5)        # the hung dispatch's worker finishes
        torch.cuda.synchronize()
        s1 = obs.snapshot()
    finally:
        RD.DJ.getroute = real_getroute
        armed.close()
    frecs = [r for r in flight.recent("route") if r["dispatch_id"] > base]
    outcomes = [r["outcome"] for r in frecs]
    hrep = seen["health"]
    host = by_label(s1, s0, "clntpu_route_fallback_total")
    kinds = [sorted({type(a).__name__ for a in w}) for w in got]
    log(f"9.2 faults: outcomes {outcomes}, answer types a wave {kinds}, "
        f"deadline wave {sorted({type(a).__name__ for a in dgot})}; "
        f"breaker {seen['state']} before the probe, R1 launches "
        f"{seen['launches_before_probe']} before it and "
        f"{c92['route_sweep']} after the recovery waves; transitions "
        f"{by_label(s1, s0, 'clntpu_breaker_transitions_total')}; "
        f"host answers {host} ({len(host_calls)} dijkstra calls); health "
        f"at +6 s {hrep['state']}, breached {hrep['breached']}")
    assert outcomes == ["error"] * 5 + ["breaker"] * 2 + ["ok"] * 2 + [
        "deadline"], outcomes
    assert all(isinstance(a, FI.FaultInjected) for w in got[:5] for a in w)
    assert all(isinstance(a, BR.BreakerOpen) and a.retry_in_s > 0
               for w in got[5:7] for a in w)
    assert all(isinstance(a, DL.DeadlineExceeded) for a in dgot)
    assert seen["state"] == "open" and seen["launches_before_probe"] == 0
    assert c92["route_sweep"] == 2 and brk.state == "closed"
    assert all(same_route_answer(want_r[i * B + j], a)
               for i in (7, 8) for j, a in enumerate(got[i]))
    assert set(host) <= {RD.R_OVERFLOW, RD.R_RECONSTRUCT}
    assert len(host_calls) == sum(host.values())
    assert "breaker_open" in hrep["breached"] and hrep["state"] != "healthy"
    assert by_label(s1, s0, "clntpu_breaker_transitions_total") == {
        "route/closed": 1, "route/half_open": 1, "route/open": 1}

    # 9.3: the spine on the card
    ticks = 0
    while eng.state_name() != "healthy" and ticks < 30:
        clock["t"] += 1.0
        eng.tick()
        ticks += 1
    final = eng.report()
    assert rec.drain(30.0)
    rec.stop()
    summ = rec.summary()
    bundles = summ["incidents"]
    man = rec.get(bundles[0]["id"])["manifest"] if bundles else {}
    tr = rec.get(bundles[0]["id"], "trace.json")["artifact"]["content"] \
        if bundles else {}
    problems = traceexport.validate(tr)
    names = {e["name"] for e in tr.get("traceEvents", ())
             if e.get("ph") == "X"}
    jsum = journey.summary()
    paths = {tuple(h["hop"] for h in journey.lookup("payment", k)["hops"])
             for k in keys}
    log(f"9.3 spine: {len(bundles)} incident bundle(s) "
        f"{[b['trigger'] for b in bundles]}, history "
        f"{[(h['class'], h['action']) for h in man.get('history', ())]}, "
        f"absorbed {man.get('suppressed')}, artifacts "
        f"{sorted(man.get('artifacts', {}))}, capture errors "
        f"{man.get('capture_errors')}, correlation "
        f"{man.get('correlation')}, {summ['total_bytes']} bytes; "
        f"trace.json {len(tr.get('traceEvents', ()))} events, "
        f"{len(problems)} problems; health after {ticks} more ticks "
        f"{final['state']} (breached {final['breached']}); journeys "
        f"{jsum['entities']} entities, hops {sorted(jsum['by_hop'])}, MCF "
        f"journeys' hop sequences {sorted(paths)}")
    assert len(bundles) == 1 and bundles[0]["trigger"] == "breaker_open"
    assert man["correlation"]["family"] == "route"
    assert {"deadline", "slo_breach"} <= set(man["suppressed"])
    assert sorted(man["artifacts"]) == sorted(incident.ARTIFACTS)
    assert man["capture_errors"] == {} and man["trace_problems"] == 0
    assert problems == [] and {"route/flush", "mcf/flush", "dispatch/route",
                               "dispatch/mcf"} <= names
    assert final["state"] == "healthy"
    assert paths == {("enqueue", "mcf_flush", "parts")}
    health.install(None)
    incident.install(None)
    journey.configure()
    shutil.rmtree(tmpdir, ignore_errors=True)
    counts = {k: c91[k] + c92[k] for k in c91}
    log(f"supervised routing launches in phase 9: {json.dumps(counts)}; "
        f"phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: peer gossip


PEER_KEYS = (0xA10A, 0xB10B, 0xC10C)   # nodes A, B and C
N_LIVE, N_LIVE_BAD = 1000, 25           # C's channel_updates, corrupted
MAX_ROUNDS = 5                          # seeker rounds for B to converge
# the seeker's prune clock: a day past the synth store's timestamps
SYNTH_NOW = 1_700_086_400.0


def fresh_updates(wire, synth, E, F, info, parsed, gen, bucket, dev):
    """N_LIVE channel_updates on distinct (channel, direction) pairs of
    the store, each 1,000 s newer with another fee, signed on the card
    (S2) by the direction's node; N_LIVE_BAD of them with a flipped bit
    of r.  Returns (raws, the corrupted ones)."""
    import dataclasses

    n = info["channels"]
    pubs = E.derive_pubkeys(F.from_int_array(info["seckeys"]).numpy(),
                            bucket, device=dev)
    key_of = {bytes(pk): d for pk, d in zip(pubs, info["seckeys"])}
    picks = gen.choice(2 * n, N_LIVE, replace=False)
    msgs, hashes, keys = [], [], []
    for pick in picks:
        c, d = divmod(int(pick), 2)
        p, ca = parsed[n + pick], parsed[c]
        assert (p.short_channel_id, p.direction) == (ca.short_channel_id, d)
        m = bytearray(dataclasses.replace(
            p, timestamp=p.timestamp + 1000,
            fee_base_msat=(p.fee_base_msat + 1) % 5000).serialize())
        msgs.append(m)
        hashes.append(hashlib.sha256(hashlib.sha256(
            bytes(m[wire.CU_SIGNED_OFFSET:])).digest()).digest())
        keys.append(key_of[(ca.node_id_1, ca.node_id_2)[d]])
    sigs = synth.sign_bulk(hashes, keys, gen, dev)
    bad = set(gen.choice(N_LIVE, N_LIVE_BAD, replace=False).tolist())
    out, corrupt = [], set()
    for i, (m, sig) in enumerate(zip(msgs, sigs)):
        sig = bytearray(sig.tobytes())
        if i in bad:
            sig[31] ^= 1                        # as synth corrupts r
        m[wire.CU_SIG_OFFSET:wire.CU_SIG_OFFSET + 64] = sig
        out.append(bytes(m))
        if i in bad:
            corrupt.add(out[-1])
    return out, corrupt


def accepted_view(g):
    """A gossipd's accepted set: channels, updates by (scid, direction)
    and node announcements, with their timestamps."""
    ing = g.ingest
    return set(ing.channels), dict(ing.updates), dict(ing.nodes)


def peer_gossip(args, gen, dev, card, torch, H, tmpdir):
    """Phase 10; returns K1-K3's launches in it and its figures."""
    import collections
    import contextvars
    import random

    from lightning_tpu_torch import obs
    from lightning_tpu_torch.crypto import chachapoly as AEAD
    from lightning_tpu_torch.crypto import engines as E
    from lightning_tpu_torch.crypto import field as F
    from lightning_tpu_torch.daemon.node import LightningNode
    from lightning_tpu_torch.gossip import gossipd as GD
    from lightning_tpu_torch.gossip import ingest as I
    from lightning_tpu_torch.gossip import seeker as SK
    from lightning_tpu_torch.gossip import store as ST
    from lightning_tpu_torch.gossip import synth
    from lightning_tpu_torch.gossip import verify as V
    from lightning_tpu_torch.gossip import wire

    t_phase = time.perf_counter()
    src = os.path.join(tmpdir, "peer_src.gs")
    info = synth.make_network_store(src, args.ingest_channels,
                                    args.ingest_nodes, seed=args.seed,
                                    device=dev)
    raws, parsed, _, _ = ingest_messages(wire, src, info)
    live, corrupt = fresh_updates(wire, synth, E, F, info, parsed, gen,
                                  args.bucket, dev)
    log(f"peer gossip: A's store {len(raws)} messages ({info['channels']} "
        f"CA, {info['channel_updates']} CU, {info['nodes']} NA; "
        f"{info['sigs']} signatures) and C's {len(live)} fresh updates "
        f"({len(corrupt)} corrupted) made in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # every kernel launch inside the phase, timed by CUDA events and
    # booked to the flush or replay that made it: the ingests' flush
    # loops and the replays run under their own context (asyncio.to_thread
    # carries it into the verify's worker thread)
    owner = contextvars.ContextVar("owner", default="other")
    events_by = collections.defaultdict(list)
    launch = H._launch

    def timed_launch(name, *tensors, B, entry=None):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        launch(name, *tensors, B=B, entry=entry)
        b.record()
        events_by[owner.get()].append((name, a, b))

    aead = {"s": 0.0, "calls": 0}
    enc, dec = AEAD.encrypt, AEAD.decrypt

    def timed(fn):
        def call(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                aead["s"] += time.perf_counter() - t
                aead["calls"] += 1
        return call

    rounds, flushes_b, replay, store_s, lags = [], [], {}, [], []
    waits, drains = [], []
    verify_store = V.verify_store

    def timed_verify_store(idx, *a, **kw):
        t = time.perf_counter()
        res = verify_store(idx, *a, **kw)
        replay.update(s=time.perf_counter() - t, sigs=res.n_sigs,
                      buckets=res.buckets)
        return res

    async def run():
        na, nb, nc = (LightningNode(privkey=k) for k in PEER_KEYS)
        ga = GD.Gossipd(na, os.path.join(tmpdir, "peer_a.gs"), device=dev)
        gb = GD.Gossipd(nb, os.path.join(tmpdir, "peer_b.gs"), device=dev)
        flush_b = gb.ingest.flush

        async def timed_flush():
            n = gb.ingest._queued_sigs
            t = time.perf_counter()
            await flush_b()
            if n:
                flushes_b.append((n, time.perf_counter() - t))

        gb.ingest.flush = timed_flush
        append_b = gb.ingest.writer.append_many

        def timed_append(*a, **kw):
            t = time.perf_counter()
            append_b(*a, **kw)
            store_s.append(time.perf_counter() - t)

        gb.ingest.writer.append_many = timed_append

        async def watch_loop():
            """The event loop's lag: how late a 1 ms sleep wakes."""
            while True:
                t = time.perf_counter()
                await asyncio.sleep(0.001)
                lags.append(time.perf_counter() - t - 0.001)

        out = {}
        try:
            # A: the store replayed through K1-K3 on the card
            tok = owner.set("A replay")
            V.verify_store = timed_verify_store
            t0 = time.perf_counter()
            try:
                n_loaded = ga.load_existing(src, verify=True)
            finally:
                V.verify_store = verify_store
            out["load_s"] = time.perf_counter() - t0
            owner.reset(tok)
            assert n_loaded == len(raws), "A's store did not load whole"
            for g, who in ((ga, "A"), (gb, "B")):
                tok = owner.set(who)
                g.start()
                owner.reset(tok)

            # B: blank, dials A over loopback Noise; its seeker syncs
            port = await na.listen()
            await nb.connect("127.0.0.1", port, na.node_id)
            wait_b = gb.ingest.wait_capacity

            async def timed_wait(max_wait=None):
                waited = await wait_b(max_wait)
                waits.append(waited)
                return waited

            gb.ingest.wait_capacity = timed_wait
            while nb.node_id not in na.peers:    # A's side of the init
                await asyncio.sleep(0.005)
            writer_a = na.peers[nb.node_id].stream.writer
            drain_a = writer_a.drain

            async def timed_drain():
                t = time.perf_counter()
                await drain_a()
                drains.append(time.perf_counter() - t)

            writer_a.drain = timed_drain
            sk = SK.Seeker(gb, rng=random.Random(args.seed),
                           clock=lambda: SYNTH_NOW)
            want = accepted_view(ga)
            watch = asyncio.get_running_loop().create_task(watch_loop())
            for r in range(MAX_ROUNDS):
                st, ov = gb.ingest.stats, gb.ingest.overload
                s0 = (st.batched_sigs, st.flushes, st.accepted,
                      st.dropped.get(I.R_SHED, 0), dict(ov.shed_counts))
                state = sk.state
                t0 = time.perf_counter()
                await sk.tick()
                await gb.ingest.drain()
                dt = time.perf_counter() - t0
                sheds = st.dropped.get(I.R_SHED, 0) - s0[3]
                by = {f"{p}:{why}": n - s0[4].get((p, why), 0)
                      for (p, why), n in ov.shed_counts.items()
                      if n - s0[4].get((p, why), 0)}
                got = accepted_view(gb)
                rounds.append({
                    "state": state, "seconds": dt,
                    "sigs": st.batched_sigs - s0[0],
                    "flushes": st.flushes - s0[1],
                    "accepted": st.accepted - s0[2], "sheds": sheds,
                    "missing": (len(want[0] - got[0]),
                                len(set(want[1].items())
                                    - set(got[1].items())),
                                len(set(want[2].items())
                                    - set(got[2].items())))})
                rr = rounds[-1]
                log(f"  round {r + 1} ({state}): {dt:.2f} s, "
                    f"{rr['sigs']} signatures in {rr['flushes']} flushes "
                    f"({rr['sigs'] / dt:.0f} sig/s), {rr['accepted']} "
                    f"accepted, {sheds} shed {json.dumps(by)}; B misses "
                    f"(channels, updates, nodes) {rr['missing']}")
                if got == want:
                    break
            watch.cancel()
            assert accepted_view(gb) == want, \
                f"B short of A after {len(rounds)} seeker rounds"

            # C: 1,000 fresh updates to A, 25 corrupted; A fans the good
            # ones out to B under B's timestamp filter
            sa, sb = ga.ingest.stats, gb.ingest.stats
            a0 = (sa.accepted, sa.dropped.get(I.R_BADSIG, 0))
            b0 = (sb.accepted, sb.dropped.get(I.R_BADSIG, 0))
            peer_ca = await nc.connect("127.0.0.1", port, na.node_id)
            t0 = time.perf_counter()
            for raw in live:
                await peer_ca.send_raw(raw)
            keys, good = {}, {}
            for raw in live:
                p = wire.parse_gossip(raw)
                k = (p.short_channel_id, p.direction)
                keys[k] = p.timestamp
                if raw not in corrupt:
                    good[k] = p.timestamp
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline and not (
                    sa.dropped.get(I.R_BADSIG, 0) - a0[1] >= N_LIVE_BAD
                    and all(gb.ingest.updates.get(k) == ts
                            for k, ts in good.items())):
                await asyncio.sleep(0.02)
            await ga.ingest.drain()
            await gb.ingest.drain()
            out["live_s"] = time.perf_counter() - t0
            await asyncio.sleep(0.2)             # any straggler fan-out
            await gb.ingest.drain()
            a_acc = sa.accepted - a0[0]
            a_bad = sa.dropped.get(I.R_BADSIG, 0) - a0[1]
            b_acc = sb.accepted - b0[0]
            b_bad = sb.dropped.get(I.R_BADSIG, 0) - b0[1]
            log(f"  live: C sent {len(live)} updates to A in "
                f"{out['live_s']:.2f} s to B's last acceptance; A accepted "
                f"{a_acc}, rejected {a_bad} bad signatures; B accepted "
                f"{b_acc}, rejected {b_bad}")
            assert (a_acc, a_bad) == (N_LIVE - N_LIVE_BAD, N_LIVE_BAD), \
                "A's live acceptance"
            assert (b_acc, b_bad) == (N_LIVE - N_LIVE_BAD, 0), \
                "B's live acceptance"
            for k, ts in keys.items():
                want_ts = ts if k in good else ts - 1000
                assert ga.ingest.updates[k] == want_ts, f"A at {k}"
                assert gb.ingest.updates[k] == want_ts, f"B at {k}"
            assert accepted_view(gb) == accepted_view(ga), \
                "B's accepted set differs from A's after the live wave"
            out["flushes"] = {"A": sa.flushes, "B": sb.flushes}
        finally:
            for x in (ga, gb, na, nb, nc):
                await x.close()
        return out

    snap0 = obs.snapshot()
    torch.cuda.synchronize()
    H.reset_launches()
    H._launch = timed_launch
    AEAD.encrypt, AEAD.decrypt = timed(enc), timed(dec)
    try:
        out = asyncio.run(run())
    finally:
        H._launch = launch
        AEAD.encrypt, AEAD.decrypt = enc, dec
    counts = H.launch_counts()
    snap1 = obs.snapshot()
    t_main = time.perf_counter() - t_phase

    # B's store read back on the card: all valid, and the messages of
    # A's store and of A's live store, each once
    tok = owner.set("B readback")
    idx = ST.load_store(os.path.join(tmpdir, "peer_b.gs"))
    res = V.verify_store(idx, args.bucket, device=dev)
    owner.reset(tok)
    a_live = ST.load_store(os.path.join(tmpdir, "peer_a.gs"))
    b_msgs = collections.Counter(idx.message(i) for i in range(len(idx)))
    a_msgs = collections.Counter(raws + [a_live.message(i)
                                         for i in range(len(a_live))])
    log(f"  B's store: {len(idx)} records, replay "
        f"{int(res.sig_ok.sum())}/{res.n_sigs} true on the card; A's "
        f"store {len(raws)} + {len(a_live)} live records")
    assert res.sig_ok.all() and idx.check_crcs().all(), "B's store replay"
    assert b_msgs == a_msgs, "B's store holds other messages than A's"
    assert not set(b_msgs) & corrupt

    n_sigs = info["sigs"]
    torch.cuda.synchronize()
    ms = collections.defaultdict(collections.Counter)
    n_by = collections.defaultdict(collections.Counter)
    for who, evs in events_by.items():
        for name, a, b in evs:
            ms[who][name] += a.elapsed_time(b)
            n_by[who][name] += 1
    main = ENGINE_KERNELS[MAIN]
    by_wrapper = {WRAPPER.get(k, k): k for k in SOURCES}
    booked = {w: sum(n_by[who][by_wrapper[w]] for who in n_by
                     if who != "B readback") for w in counts}
    log(f"  launches (K1-K3 once a flush or replay bucket; CUDA events, "
        f"ms): " + json.dumps({who: {k: [n_by[who][k], round(ms[who][k], 4)]
                                     for k in n_by[who]} for who in n_by}))
    assert counts == booked, "launches outside a flush or replay"
    assert replay["sigs"] == n_sigs, "A's replay"
    for who, n in (("A replay", replay["buckets"]),
                   ("A", out["flushes"]["A"]),
                   ("B", out["flushes"]["B"])):
        for w in counts:
            k = by_wrapper[w]
            assert n_by[who][k] == n * (w in main), \
                f"{who}: {k} launched {n_by[who][k]} times, not {n}"
    assert all(n_by["B"][by_wrapper[w]] > 0 for w in main), \
        "B's flushes launched no kernel"

    fl = np.array([f[1] for f in flushes_b])
    sizes = np.array([f[0] for f in flushes_b])
    lag = np.array(lags) * 1e3
    log(f"  B's flushes: signatures p10 {pct(sizes, 10):.0f}, p50 "
        f"{pct(sizes, 50):.0f}, p90 {pct(sizes, 90):.0f}, max "
        f"{sizes.max(initial=0)}; store appends (fsync'd) "
        f"{sum(store_s):.2f} s in all, p50 {pct(store_s, 50) * 1e3:.1f} "
        f"ms; the event loop during the sync: {len(lag)} 1 ms sleeps, late "
        f"p50 {pct(lag, 50):.2f} ms, p99 {pct(lag, 99):.2f} ms, max "
        f"{lag.max(initial=0):.1f} ms")
    w, dr = np.array(waits), np.array(drains)
    log(f"  B's backpressure (wait_capacity): {int((w > 0).sum())} waits of "
        f"{len(w)}, {w.sum():.2f} s in all; A's sends to B: {len(dr)} "
        f"drains, {int((dr > 1e-3).sum())} over 1 ms, {dr.sum():.2f} s in "
        f"all; the ingests' overload transitions "
        f"{by_label(snap1, snap0, 'clntpu_overload_transitions_total')}")
    nbytes = {d: delta(snap1, snap0, "clntpu_peer_bytes_total", direction=d)
              for d in ("in", "out")}
    sync_s = sum(r["seconds"] for r in rounds)
    log(f"peer gossip on {card}: A's replay (verify_store) "
        f"{replay['s']:.3f} s ({n_sigs / replay['s']:.0f} sig/s, "
        f"{replay['buckets']} bucket(s)), load_existing {out['load_s']:.2f} "
        f"s ({n_sigs / out['load_s']:.0f} sig/s); B's sync {len(rounds)} "
        f"round(s), {sync_s:.2f} s ("
        + ", ".join(f"{r['sigs'] / r['seconds']:.0f}" for r in rounds)
        + " sig/s a round); B's flushes p50 "
        f"{pct(fl, 50) * 1e3:.1f} ms, p99 {pct(fl, 99) * 1e3:.1f} ms, "
        f"{len(fl)} flushes; Noise bytes in {nbytes['in']:.0f}, out "
        f"{nbytes['out']:.0f}; the AEAD {aead['calls']} calls, "
        f"{aead['s']:.3f} s, {aead['s'] / t_main * 100:.2f} % of the phase; "
        f"phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return ({w: booked[w] for w in counts},
            {"replay_s": replay["s"], "load_s": out["load_s"],
             "rounds": rounds,
             "aead_s": aead["s"], "bytes": nbytes})


# ---------------------------------------------------------------------------
# Phase 4 timing


def time_cuda(torch, fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(ops_counts, H, B, nbytes, clock_hz):
    products = sum(H.PRODUCTS[k] * v for k, v in ops_counts.items())
    t_ops = B * products * MAD_PER_PRODUCT / (SMS * INT32_MAD_PER_CLK_SM
                                              * clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--channels", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=12_500)
    ap.add_argument("--bucket", type=int, default=65536)
    ap.add_argument("--htlcs", type=int, default=MAX_HTLCS,
                    help="HTLCs a commitment in phase 5")
    ap.add_argument("--commitments", type=int, default=136,
                    help="commitments of the bulk fan-out in phase 5")
    ap.add_argument("--ingest-channels", type=int, default=10_000,
                    help="channels of phase 6's live ingest and phase 10's "
                         "peer gossip")
    ap.add_argument("--ingest-nodes", type=int, default=1_250,
                    help="nodes of phase 6's live ingest and phase 10's "
                         "peer gossip")
    ap.add_argument("--ingest-runs", type=int, default=1,
                    help="times phase 6 runs (its spread is printed)")
    ap.add_argument("--mainnet", action="store_true",
                    help="250,000 channels and 60,000 nodes "
                         "(about 1.56 M signatures)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from lightning_tpu_torch import _build
        from lightning_tpu_torch.crypto import engines as E
        from lightning_tpu_torch.crypto import field as F
        from lightning_tpu_torch.crypto import hopper_secp as H
        from lightning_tpu_torch.crypto import ref_python as ref
        from lightning_tpu_torch.crypto import secp256k1 as S
        from lightning_tpu_torch.gossip import gossmap as GM
        from lightning_tpu_torch.gossip import store as ST
        from lightning_tpu_torch.gossip import synth
        from lightning_tpu_torch.gossip import verify as V
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2
    if args.mainnet:
        args.channels, args.nodes = synth.MAINNET_CHANNELS, synth.MAINNET_NODES
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 1: device and build
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    log(f"device: {name} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {len(reports)} kernels for sm_90a "
        f"({' '.join(_build.NVCC_FLAGS)}) in {time.perf_counter() - t0:.1f} s")
    for k, rep in reports.items():
        smem = "" if "smem" in rep else " | 0 bytes static smem"
        log(f"  ptxas {k}: " + " | ".join(rep.splitlines()) + smem)
    for k in ("build_tables", "glv_scan", "glv_scan2", "dual_mul_v2",
              "dual_mul_planes", "fixed_base", "ecdsa_sign", "route_sweep",
              "mcf_ssp"):
        n = getattr(_build.lib(k), f"{k}_blocks_per_sm")()
        log(f"  {k}: {n} blocks resident per SM")
    for k in ("route_sweep", "mcf_ssp"):
        calls = _build.sass_calls(_build.sass(_build._lib_path(k)) or {})
        log(f"  {k} SASS (cuobjdump -sass), per instantiation [CALL "
            f"instructions, IMAD.HI / IMAD.WIDE multiply-highs]: "
            f"{json.dumps(calls)}")
        assert calls and all(c == 0 for c, _ in calls.values()), \
            f"{k}: a subroutine call (an int64 division?) in its SASS"

    # -- phase 2: kernels against their plain versions on the card
    gen = np.random.default_rng(args.seed)
    Bk = args.bucket
    result = {k: {"mismatch": 0, "err": 0} for k in SOURCES}

    def note(k, got):
        result[k]["mismatch"] += got[0]
        result[k]["err"] = max(result[k]["err"], got[1])

    for B in (Bk, Bk + 37):
        note("verify_prep", compare_k1(H, F, *k1_inputs(gen, B, dev, F)))
        note("build_tables", compare_k2(H, F, *k2_inputs(gen, B, dev, F,
                                                         torch)))
        note("glv_scan", compare_k3(H, F, *k3_inputs(gen, B, dev, H, F,
                                                     torch)))
        note("glv_scan2", compare_k4(H, F, *k4_inputs(gen, B, dev, H, F,
                                                      torch)))
        note("dual_mul_v2", compare_k5(H, F, *k5_inputs(gen, B, dev, torch)))
        note("dual_mul_planes", compare_k6(H, F, *k6_inputs(gen, B, dev,
                                                            torch)))
        note("fixed_base", compare_s1(H, F, s1_inputs(gen, B, dev, F, ref)))
        for C in H.SIGN_CANDIDATES:
            bad, err, _ = compare_s2(H, F, *s2_inputs(
                gen, B, C, dev, F, E, ref, torch))
            note("ecdsa_sign", (bad, err))
        torch.cuda.synchronize()
        log(f"compare B={B}: " + json.dumps(result))
        for digit in (0, 15):
            got = compare_k5(H, F, *k5_inputs(gen, B, dev, torch, digit))
            note("dual_mul_v2", got)
            log(f"compare dual_mul_v2 B={B}, every digit {digit}: {got[0]} "
                f"rows differ, max |limb difference| {got[1]}")
    ops = s2_inputs(gen, Bk, 4, dev, F, E, ref, torch)
    bad, err, got = compare_s2(H, F, *ops)
    note("ecdsa_sign", (bad, err))
    off, high = s2_rule_sample(E, F, gen, *ops, got, 1024)
    log(f"S2 against the exact-int four-candidate rule: {off} of 1024 "
        f"sampled rows differ; {high} of them have no low-R candidate")
    assert off == 0 and high > 0, "S2 off the four-candidate rule"
    note("verify_prep", compare_k1(H, F, *k1_edges(dev, F, ref)))
    B_zero = max(Bk, 2 * H.PREP_THREADS) + 37
    note("verify_prep", compare_k1(H, F, *k1_zero_cases(gen, B_zero, dev, F,
                                                        H, ref)))
    note("build_tables", compare_k2(H, F, *k2_edges(gen, dev, F, torch)))
    log("compare K1 ragged and zero cases, K2 carry edges: "
        + json.dumps({k: result[k] for k in ("verify_prep", "build_tables")}))
    by_wrapper = {WRAPPER.get(k, k): k for k in SOURCES}
    for engine, kernels in ENGINE_KERNELS.items():
        if not engine.endswith("+pp"):
            continue
        bad, err, off = engine_edges(E, F, ref, dev, engine)
        log(f"edge dual mul {engine}: {bad} rows differ from the plain "
            f"path, {off} from the oracle")
        assert off == 0, f"{engine}: edge dual mul off the oracle"
        for w in kernels[1:]:
            note(by_wrapper[w], (bad, err))
        card_v, plain_v, oracle_v = verify_edges(E, S, F, ref, dev, torch,
                                                 engine)
        log(f"edge verdicts {engine}: card {card_v.astype(int).tolist()} "
            f"plain {plain_v.astype(int).tolist()} oracle "
            f"{oracle_v.astype(int).tolist()}")
        assert (card_v == plain_v).all() and (card_v == oracle_v).all() \
            and card_v[0], f"{engine}: edge verdicts disagree"
    log("kernels vs plain: " + json.dumps(result))
    assert all(v["mismatch"] == 0 for v in result.values()), \
        "a kernel disagrees with its plain version"

    # -- phase 3: the main path
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    path = os.path.join(tmp.name, "store.gs")
    t0 = time.perf_counter()
    info = synth.make_network_store(
        path, args.channels, args.nodes, seed=args.seed, device=dev,
        n_corrupt=64, off_curve=1, bad_tag=1, oversized=3)
    t_synth = time.perf_counter() - t0
    log(f"synth: {info['sigs']} signatures ({args.channels} channels, "
        f"{args.nodes} nodes, 2 updates/channel) signed on S1 and S2 in "
        f"{t_synth:.1f} s")
    expected = info["expected_sig_ok"]

    def replay(engine):
        """load_store -> check_crcs -> verify_store under `engine`, with
        the launch counters set to 0 just before and read just after."""
        torch.cuda.synchronize()
        H.reset_launches()
        t0 = time.perf_counter()
        idx = ST.load_store(path)
        crc_ok = idx.check_crcs()
        res = V.verify_store(idx, args.bucket, device="cuda", engine=engine)
        t_replay = time.perf_counter() - t0
        counts = H.launch_counts()
        assert crc_ok.all(), "store crc mismatch"
        wrong = np.nonzero(res.sig_ok != expected)[0]
        log(f"replay {engine}: {res.n_sigs} signatures, {res.buckets} "
            f"buckets, {int((~expected).sum())} expected invalid, "
            f"{len(wrong)} wrong verdicts, {t_replay:.2f} s "
            f"({res.n_sigs / t_replay:.0f} sig/s; extract "
            f"{res.seconds['extract']:.2f} s, verify "
            f"{res.seconds['verify']:.2f} s) on {card}")
        assert res.n_sigs == info["sigs"] and len(wrong) == 0, \
            f"{engine}: wrong verdicts at {wrong[:20].tolist()}"
        assert (res.ca_valid == info["expected_ca_valid"]).all()
        log(f"launches under {engine}: {json.dumps(counts)}")
        want = {k: res.buckets * (k in ENGINE_KERNELS[engine])
                for k in counts}
        assert counts == want, f"{engine}: launch counts"
        return idx, res, counts

    idx, res, counts = replay(MAIN)
    sample = np.unique(np.concatenate([
        gen.choice(res.n_sigs, 256, replace=False),
        np.nonzero(~expected)[0][:64]]))
    host = V.host_verify_items(res.items, idx.buf, sample)
    agree = int((host == res.sig_ok[sample]).sum())
    log(f"host oracle sample: {agree}/{len(sample)} agree "
        f"({int((~host).sum())} invalid in the sample)")
    assert agree == len(sample), "host oracle disagrees"
    del idx, res

    # -- phase 3b: the other kernel engines on the same store
    launches = {k: (MAIN, counts[k]) for k in ENGINE_KERNELS[MAIN]}
    for engine in ENGINE_KERNELS:
        if engine == MAIN:
            continue
        _, _, c = replay(engine)
        for k in ENGINE_KERNELS[engine]:
            launches.setdefault(k, (engine, c[k]))
    route_graph = GM.from_store(ST.load_store(path))    # phase 7's graph

    # -- phase 4: timing at the bucket size
    clock = sm_clock_hz()
    opc = H.field_op_counts()
    qx, s = k1_inputs(gen, Bk, dev, F)
    bx, by, flip = k2_inputs(gen, Bk, dev, F, torch)
    d2l, d2h, gidx, *_ = k3_inputs(gen, Bk, dev, H, F, torch)
    _, _, _, g1, g2 = k4_inputs(gen, Bk, dev, H, F, torch)
    d2, qtab, gs = k5_inputs(gen, Bk, dev, torch)
    qs, _ = k6_inputs(gen, Bk, dev, torch)
    x8, s8 = F.to_u32x8(qx), F.to_u32x8(s)
    o8 = [torch.empty_like(x8) for _ in range(3)]
    bx8, by8 = F.to_u32x8(bx), F.to_u32x8(by)
    f32 = flip.to(torch.int32).contiguous()
    tab = torch.empty((6, 16, 8, Bk), dtype=torch.int32, device=dev)
    dig = [t.to(torch.int32).contiguous() for t in (d2l, d2h, gidx)]
    d2_32 = d2.to(torch.int32).contiguous()
    jt = H._joint_table_u32(str(dev))
    H._launch("build_tables", bx8, by8, f32, tab, B=Bk)
    lohi = H.tables_to_limbs(tab)
    pt_bytes = 3 * 32             # one point: three 8-word coordinates
    runs = {
        "verify_prep": (lambda: H._launch("verify_prep", x8, s8, *o8, B=Bk),
                        lambda: H.verify_prep_plain(qx, s),
                        Bk * 5 * 32),
        "build_tables": (lambda: H._launch("build_tables", bx8, by8, f32, tab,
                                           B=Bk),
                         lambda: H.build_tables_plain(bx, by, flip),
                         Bk * (2 * 32 + 4 + 6 * 16 * 32)),
        "glv_scan": (lambda: H._launch("glv_scan", *dig, tab, jt, *o8, B=Bk),
                     lambda: H.glv_scan_plain(d2l, d2h, gidx, *lohi),
                     Bk * (3 * 33 * 4 + 6 * 16 * 32 + pt_bytes)
                     + jt.numel() * 4),
        "glv_scan2": (lambda: H._launch("glv_scan2", *dig[:2], tab, g1, g2,
                                        *o8, B=Bk),
                      lambda: H.glv_scan2_plain(d2l, d2h, *lohi, g1, g2),
                      Bk * (2 * 33 * 4 + 6 * 16 * 32 + 2 * 33 * pt_bytes
                            + pt_bytes)),
        "dual_mul_v2": (lambda: H._launch("dual_mul_v2", d2_32, qtab, gs, *o8,
                                          B=Bk),
                        lambda: H.dual_mul_v2_plain(d2, qtab, gs),
                        Bk * (64 * 4 + 16 * pt_bytes + 64 * pt_bytes
                              + pt_bytes)),
        "dual_mul_planes": (lambda: H._launch("dual_mul_planes", qs, gs, *o8,
                                              B=Bk),
                            lambda: H.dual_mul_planes_plain(qs, gs),
                            Bk * (2 * 64 * pt_bytes + pt_bytes)),
    }
    kernels = []
    for k, (kern, plain, nbytes) in runs.items():
        ms = time_cuda(torch, kern, reps=20)
        plain_ms = time_cuda(torch, plain, reps=1, warm=1)
        b_ms, b_by = bound_ms(opc[k], H, Bk, nbytes, clock)
        log(f"time {k}: {ms:.4f} ms/call at B={Bk}, plain {plain_ms:.1f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; field ops {opc[k]}; SM clock "
            f"{clock / 1e6:.0f} MHz)")
        on_path, n = launches[WRAPPER.get(k, k)]
        if k in ("glv_scan", "glv_scan2"):
            fixed = [torch.full_like(t, 5) for t in dig]
            rest = (tab, jt) if k == "glv_scan" else (tab, g1, g2)
            n_dig = 3 if k == "glv_scan" else 2
            ms_fixed = time_cuda(torch, lambda: H._launch(
                k, *fixed[:n_dig], *rest, *o8, B=Bk), reps=20)
            log(f"time {k} fixed digits: {ms_fixed:.4f} ms/call with "
                f"every digit{' and joint index' * (n_dig == 3)} 5, "
                f"{ms:.4f} ms with random ones: the gathers cost "
                f"{ms - ms_fixed:.4f} ms")
        if k == "dual_mul_v2":
            d2_5 = torch.full_like(d2_32, 5)
            ms_fixed = time_cuda(torch, lambda: H._launch(
                k, d2_5, qtab, gs, *o8, B=Bk), reps=20)
            log(f"time {k} fixed digits: {ms_fixed:.4f} ms/call with "
                f"every digit 5, {ms:.4f} ms with random ones: the gather "
                f"costs {ms - ms_fixed:.4f} ms")
        if k == "verify_prep":
            old_ms, _ = bound_ms(opc["verify_prep_chain_per_signature"], H,
                                 Bk, nbytes, clock)
            log(f"bound verify_prep: {b_ms:.4f} ms with one Fermat chain a "
                f"block of {H.PREP_THREADS}, {old_ms:.4f} ms with a chain "
                f"per signature")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": n, "path": on_path,
            "max_abs_err": result[k]["err"], "mismatches":
            result[k]["mismatch"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # S1 and S2 (C = 4) at the bucket size; their work depends on the
    # data: the nonzero digits of each scalar, and for S2 the candidates
    # each row tries (up to its first low R, read from S2 at C = 1 on
    # each candidate alone).  Their bounds count a batch inversion a
    # block, as the kernels invert; beside them the bound of a chain a row
    comb = H._comb_words(str(dev))
    k8 = s1_inputs(gen, Bk, dev, F, ref)
    z8, d8, ks8 = s2_inputs(gen, Bk, 4, dev, F, E, ref, torch)
    xy = [torch.empty((8, Bk), dtype=torch.int32, device=dev)
                 for _ in range(2)]
    flags = [torch.empty(Bk, dtype=torch.uint8, device=dev) for _ in range(2)]
    low = torch.stack([H.ecdsa_sign(z8, d8, ks8[c:c + 1])[3]
                       for c in range(4)])
    adds, points = H.sign_work(ks8, low)
    s1_adds = H.nonzero_digits(k8).double().mean().item()
    table_bytes = comb.numel() * 4

    def s2_bytes(B, C):
        return B * (2 * 32 + C * 32 + 2 * 32 + 2) + table_bytes

    sign_runs = {
        "fixed_base": (lambda: H._launch("fixed_base", k8, comb, *xy, B=Bk),
                       lambda: H.fixed_base_affine_plain(k8),
                       Bk * 3 * 32 + table_bytes, (s1_adds, 1, 2, 0)),
        "ecdsa_sign": (lambda: H._launch("ecdsa_sign", z8, d8, ks8, comb,
                                         *xy, *flags, B=Bk,
                                         entry="ecdsa_sign4"),
                       lambda: H.ecdsa_sign_plain(z8, d8, ks8),
                       s2_bytes(Bk, 4), (adds, points, 1, 1)),
    }
    log(f"S1 data: {s1_adds:.3f} nonzero digits a scalar; S2 data: "
        f"{points:.4f} candidates tried a row, {adds:.3f} comb additions")
    sign_records = {}
    for k, (kern, plain, nbytes, work) in sign_runs.items():
        ms = time_cuda(torch, kern, reps=20)
        plain_ms = time_cuda(torch, plain, reps=1, warm=1)
        ops = H.comb_op_counts(opc, *work)
        b_ms, b_by = bound_ms(ops, H, Bk, nbytes, clock)
        row_ms, _ = bound_ms(H.comb_op_counts(opc, *work, batched=False), H,
                             Bk, nbytes, clock)
        log(f"time {k}: {ms:.4f} ms/call at B={Bk}, plain {plain_ms:.1f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; field ops a row {ops}; SM clock "
            f"{clock / 1e6:.0f} MHz)")
        log(f"bound {k}: {b_ms:.4f} ms with one Fermat chain a block of "
            f"{H.SIGN_THREADS}, {row_ms:.4f} ms with a chain per row")
        sign_records[k] = {
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": None, "path": "sign",
            "max_abs_err": result[k]["err"], "mismatches":
            result[k]["mismatch"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bound_chain_per_row_ms": row_ms}
        kernels.append(sign_records[k])

    # S2 at C = 1 (the synthetic store's bulk signer) on candidate 0, and
    # at C = 4 on the first 483 rows (one commitment's HTLCs, hsmd's call)
    n_c = MAX_HTLCS
    k1 = ks8[:1].contiguous()
    zc, dc, kc = (t[..., :n_c].contiguous() for t in (z8, d8, ks8))
    xyc = [t[:, :n_c].contiguous() for t in xy]
    flc = [t[:n_c].contiguous() for t in flags]
    extra = {
        "c1": (lambda: H._launch("ecdsa_sign", z8, d8, k1, comb, *xy, *flags,
                                 B=Bk, entry="ecdsa_sign1"),
               Bk, s2_bytes(Bk, 1),
               (H.nonzero_digits(k1).double().mean().item(), 1, 1, 1)),
        "483": (lambda: H._launch("ecdsa_sign", zc, dc, kc, comb, *xyc,
                                  *flc, B=n_c, entry="ecdsa_sign4"),
                n_c, s2_bytes(n_c, 4),
                (*H.sign_work(kc, low[:, :n_c].contiguous()), 1, 1)),
    }
    for tag, (kern, n, nbytes, work) in extra.items():
        ms = time_cuda(torch, kern, reps=20)
        b_ms, _ = bound_ms(H.comb_op_counts(opc, *work), H, n, nbytes, clock)
        row_ms, _ = bound_ms(H.comb_op_counts(opc, *work, batched=False), H,
                             n, nbytes, clock)
        log(f"time ecdsa_sign {'C = 1' if tag == 'c1' else 'C = 4'}: "
            f"{ms:.4f} ms/call at B={n}, bound {b_ms:.4f} ms (a chain a "
            f"block), {row_ms:.4f} ms (a chain a row)")
        sign_records["ecdsa_sign"].update({f"ms_{tag}": ms,
                                           f"bound_{tag}_ms": b_ms})

    # -- phase 5: the sign path at full width
    counts = sign_path(args, gen, dev, card, torch, F, E, H, ref)
    for k, rec in sign_records.items():
        rec["launches"] = counts[WRAPPER.get(k, k)]

    # -- phase 6: live gossip ingest at the width of a 10k-channel node,
    # each run after a reading of K3 on phase 4's inputs (the card's state)
    counts, spread = dict.fromkeys(ENGINE_KERNELS[MAIN], 0), []
    for run in range(args.ingest_runs):
        k3_ms = time_cuda(torch, runs["glv_scan"][0], reps=20)
        log(f"phase 6 run {run + 1} of {args.ingest_runs}: K3 "
            f"{k3_ms:.4f} ms/call at B={Bk} just before")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as d:
            c, figures = live_ingest(args, gen, dev, card, torch, F, E, H,
                                     S, ref, d)
        counts = {k: counts[k] + c[k] for k in counts}
        spread.append((k3_ms, figures))
    if args.ingest_runs > 1:
        for wave in ("gap", "bolt7"):
            log(f"phase 6 spread, {wave} wave, {args.ingest_runs} runs on "
                f"{card} (K3 ms, sig/s, msg/s, flush p50 ms, p99 ms, "
                f"flushes, sheds): " + json.dumps([
                    [round(k3, 4)] + [round(f[wave][m], 1) for m in (
                        "sig_s", "msg_s", "p50_ms", "p99_ms", "flushes",
                        "sheds")] for k3, f in spread]))
    for rec in kernels:
        rec["live_ingest_launches"] = counts.get(
            WRAPPER.get(rec["name"], rec["name"]), 0)

    # -- phase 7: routing on the card over phase 3's graph
    records, flush_ms = routing(args, route_graph, dev, card, torch)
    kernels += records

    # -- phase 8: the supervised, pipelined replay of phase 3's store;
    # each kernel's launches in its six replays
    counts = supervised_replay(args, path, expected, dev, card, torch, H, V,
                               ST, E, ref)
    tmp.cleanup()
    for rec in kernels:
        rec["supervised_replay_launches"] = counts.get(
            WRAPPER.get(rec["name"], rec["name"]), 0)

    # -- phase 9: supervised routing and the observability spine over
    # phase 7's graph; R1's and R2's launches in it
    k_ms = sum(r["ms"] for r in kernels
               if r["name"] in ("verify_prep", "build_tables", "glv_scan"))
    counts = supervised_routing(args, route_graph, dev, card, torch,
                                Bk / (k_ms / 1e3), flush_ms)
    for rec in kernels:
        rec["supervised_routing_launches"] = counts.get(
            WRAPPER.get(rec["name"], rec["name"]), 0)

    # -- phase 10: peer gossip at the width of a 10k-channel node; K1-K3's
    # launches in A's replay and the two nodes' flushes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_peer_") as d:
        counts, _ = peer_gossip(args, gen, dev, card, torch, H, d)
    for rec in kernels:
        rec["peer_gossip_launches"] = counts.get(
            WRAPPER.get(rec["name"], rec["name"]), 0)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
