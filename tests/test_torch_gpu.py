"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and the CUDA toolkit; without a card
they skip.  On the card:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import field as F
from lightning_tpu_torch.crypto import hopper_secp as H
from lightning_tpu_torch.crypto import ref_python as ref

pytestmark = pytest.mark.gpu

B = 1000 + 37      # not a multiple of a 128- or 256-thread block
FULL = 65536 + 37  # the bucket size and a ragged 37


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode); "
                    "run on the card with -m gpu")
    return torch.device("cuda")


def _rand(gen, n, mod_int, dev):
    raw = gen.integers(0, 256, (n, 32), dtype=np.uint8)
    return F.from_int_array(
        [int.from_bytes(r.tobytes(), "big") % mod_int for r in raw], dev)


def _same(mod, a, b):
    assert torch.equal(F.normalize(mod, a).cpu(), F.normalize(mod, b).cpu())


def test_verify_prep_kernel_matches_plain(cuda):
    gen = np.random.default_rng(41)
    qx, s = _rand(gen, B, 2**256, cuda), _rand(gen, B, 2**256, cuda)
    before = H.verify_prep_core.launches
    got = H.verify_prep_core(qx, s)
    assert H.verify_prep_core.launches == before + 1
    for mod, g, w in zip((F.FP, F.FP, F.FN), got, H.verify_prep_plain(qx, s)):
        _same(mod, g, w)


# s values that are 0 mod n, or the largest 256-bit value
ZERO_S = (0, ref.N, 2**256 - 1)


def test_verify_prep_kernel_ragged_zero_cases(cuda):
    """K1's block batch inversion at a ragged B (3 blocks and 37 threads):
    s = 0, n and 2^256 - 1 at the first and last thread of the first two
    blocks and at B - 1 (0 and n give w = 0, and neither disturbs the
    other threads of its block)."""
    gen = np.random.default_rng(48)
    n = 3 * H.PREP_THREADS + 37
    T = H.PREP_THREADS
    ss = [int.from_bytes(gen.bytes(32), "big") for _ in range(n)]
    for j, i in enumerate((0, T - 1, T, 2 * T - 1, n - 1)):
        ss[i] = ZERO_S[j % 3]
    qx, s = _rand(gen, n, 2**256, cuda), F.from_int_array(ss, cuda)
    got = H.verify_prep_core(qx, s)
    for mod, g, w in zip((F.FP, F.FP, F.FN), got, H.verify_prep_plain(qx, s)):
        _same(mod, g, w)
    assert F.limbs_to_int(got[2][0].cpu()) == 0


# Field values at the carry edges of the 8 x 32-bit words
EDGES = [0, 1, 2, F.P_INT - 1, F.P_INT - 2, F.P_INT, F.P_INT + 1, 2**32 - 1,
         2**64 - 1, 2**255, 2**256 - 2**32, 2**256 - 1]


def test_verify_prep_kernel_at_carry_edges(cuda):
    xs = [a for a in EDGES for _ in range(len(ZERO_S) + 3)]
    ss = [b for _ in EDGES for b in (*ZERO_S, 1, ref.N - 1, ref.N + 1)]
    qx, s = F.from_int_array(xs, cuda), F.from_int_array(ss, cuda)
    for mod, g, w in zip((F.FP, F.FP, F.FN), H.verify_prep_core(qx, s),
                         H.verify_prep_plain(qx, s)):
        _same(mod, g, w)


def test_build_tables_kernel_at_carry_edges(cuda):
    gen = np.random.default_rng(49)
    bx = F.from_int_array([a for a in EDGES for _ in EDGES], cuda)
    by = F.from_int_array([b for _ in EDGES for b in EDGES], cuda)
    flip = torch.as_tensor(gen.integers(0, 2, len(EDGES) ** 2), device=cuda)
    got = H.tables_to_limbs(H.build_tables(bx, by, flip))
    for g_half, w_half in zip(got, H.build_tables_plain(bx, by, flip)):
        for g, w in zip(g_half, w_half):
            _same(F.FP, g, w)


def test_build_tables_kernel_matches_plain(cuda):
    gen = np.random.default_rng(42)
    bx, by = _rand(gen, B, F.P_INT, cuda), _rand(gen, B, F.P_INT, cuda)
    flip = torch.as_tensor(gen.integers(0, 2, B), device=cuda)
    got = H.tables_to_limbs(H.build_tables(bx, by, flip))
    want = H.build_tables_plain(bx, by, flip)
    for g_half, w_half in zip(got, want):
        for g, w in zip(g_half, w_half):
            _same(F.FP, g, w)


def test_build_tables_kernel_full_bucket_ragged(cuda):
    """K2 at the bucket size plus a ragged 37, not a multiple of its
    block: a full wave of blocks at its launch bounds and a last block
    partly empty."""
    gen = np.random.default_rng(51)
    bx, by = _rand(gen, FULL, F.P_INT, cuda), _rand(gen, FULL, F.P_INT, cuda)
    flip = torch.as_tensor(gen.integers(0, 2, FULL), device=cuda)
    got = H.tables_to_limbs(H.build_tables(bx, by, flip))
    for g_half, w_half in zip(got, H.build_tables_plain(bx, by, flip)):
        for g, w in zip(g_half, w_half):
            _same(F.FP, g, w)


def test_glv_scan_kernel_matches_plain(cuda):
    gen = np.random.default_rng(43)
    bx, by = _rand(gen, B, F.P_INT, cuda), _rand(gen, B, F.P_INT, cuda)
    flip = torch.as_tensor(gen.integers(0, 2, B), device=cuda)
    d2l, d2h = (torch.as_tensor(gen.integers(0, 16, (33, B)), device=cuda)
                for _ in range(2))
    gidx = torch.as_tensor(gen.integers(0, 1024, (33, B)), device=cuda)
    tab = H.build_tables(bx, by, flip)
    got = H.glv_scan(d2l, d2h, gidx, tab)
    want = H.glv_scan_plain(d2l, d2h, gidx, *H.tables_to_limbs(tab))
    for g, w in zip(got, want):
        _same(F.FP, g, w)


def test_glv_scan_kernel_full_bucket_ragged(cuda):
    """K3 at the bucket size plus a ragged 37: more blocks of 256
    threads than one wave of 2 blocks an SM (72 KB slots each) holds,
    the last block partly empty."""
    gen = np.random.default_rng(50)
    n = FULL
    bx, by = _rand(gen, n, F.P_INT, cuda), _rand(gen, n, F.P_INT, cuda)
    flip = torch.as_tensor(gen.integers(0, 2, n), device=cuda)
    d2l, d2h = (torch.as_tensor(gen.integers(0, 16, (33, n)), device=cuda)
                for _ in range(2))
    gidx = torch.as_tensor(gen.integers(0, 1024, (33, n)), device=cuda)
    tab = H.build_tables(bx, by, flip)
    got = H.glv_scan(d2l, d2h, gidx, tab)
    want = H.glv_scan_plain(d2l, d2h, gidx, *H.tables_to_limbs(tab))
    for g, w in zip(got, want):
        _same(F.FP, g, w)


def test_dual_mul_on_card_matches_oracle(cuda):
    gen = np.random.default_rng(44)
    n = 8
    ks = [int.from_bytes(gen.bytes(32), "big") % ref.N or 1 for _ in range(n)]
    pts = [ref.pubkey_create(k) for k in ks]
    u1 = [0, ref.N - 1] + [int.from_bytes(gen.bytes(32), "big") % ref.N
                           for _ in range(n - 2)]
    u2 = [ref.N - 1, 0] + [int.from_bytes(gen.bytes(32), "big") % ref.N
                           for _ in range(n - 2)]
    X, Y, Z = (t.cpu() for t in E.dual_mul_pallas_fbj(
        F.from_int_array(u1, cuda), F.from_int_array(u2, cuda),
        F.from_int_array([p.x for p in pts], cuda),
        F.from_int_array([p.y for p in pts], cuda)))
    for i in range(n):
        want = ref.point_add(ref.point_mul(u1[i], ref.G),
                             ref.point_mul(u2[i], pts[i]))
        z = F.limbs_to_int(Z[i]) % ref.P
        zi = pow(z, -1, ref.P)
        assert (F.limbs_to_int(X[i]) * zi % ref.P,
                F.limbs_to_int(Y[i]) * zi % ref.P) == (want.x, want.y)


def _words(gen, shape, dev):
    """Random canonical field elements (< 2^255 < p) as int32 words,
    (..., 8, B)."""
    w = gen.integers(0, 2**32, shape, dtype=np.uint32)
    w[..., 7, :] &= 0x7FFFFFFF
    return torch.as_tensor(w.view(np.int32), device=dev)


def _same_point(got, want):
    for g, w in zip(got, want):
        _same(F.FP, g, w)


def test_glv_scan2_kernel_matches_plain(cuda):
    gen = np.random.default_rng(45)
    bx, by = _rand(gen, B, F.P_INT, cuda), _rand(gen, B, F.P_INT, cuda)
    flip = torch.as_tensor(gen.integers(0, 2, B), device=cuda)
    d2l, d2h = (torch.as_tensor(gen.integers(0, 16, (33, B)), device=cuda)
                for _ in range(2))
    g1, g2 = (_words(gen, (33, 3, 8, B), cuda) for _ in range(2))
    tab = H.build_tables(bx, by, flip)
    before = H.glv_scan2.launches
    got = H.glv_scan2(d2l, d2h, tab, g1, g2)
    assert H.glv_scan2.launches == before + 1
    _same_point(got, H.glv_scan2_plain(d2l, d2h, *H.tables_to_limbs(tab),
                                       g1, g2))


def test_glv_scan2_kernel_full_bucket_ragged(cuda):
    """K4 at the bucket size plus a ragged 37: the shared scan body at
    n_g = 2, its 96 KB shared-memory slots at 2 blocks an SM, over more
    blocks than one wave holds, the last block partly empty."""
    gen = np.random.default_rng(52)
    bx, by = _rand(gen, FULL, F.P_INT, cuda), _rand(gen, FULL, F.P_INT, cuda)
    flip = torch.as_tensor(gen.integers(0, 2, FULL), device=cuda)
    d2l, d2h = (torch.as_tensor(gen.integers(0, 16, (33, FULL)), device=cuda)
                for _ in range(2))
    g1, g2 = (_words(gen, (33, 3, 8, FULL), cuda) for _ in range(2))
    tab = H.build_tables(bx, by, flip)
    got = H.glv_scan2(d2l, d2h, tab, g1, g2)
    _same_point(got, H.glv_scan2_plain(d2l, d2h, *H.tables_to_limbs(tab),
                                       g1, g2))


def _qtab(gen, n, dev):
    """A random per-key table in K5's layout, (n, 16, 3, 8) int32 words
    of canonical field elements."""
    return _words(gen, (16, 3, 8, n), dev).permute(3, 0, 1, 2).contiguous()


def test_dual_mul_v2_kernel_matches_plain(cuda):
    gen = np.random.default_rng(46)
    d2 = torch.as_tensor(gen.integers(0, 16, (64, B)), device=cuda)
    qtab, gs = _qtab(gen, B, cuda), _words(gen, (64, 3, 8, B), cuda)
    before = H.dual_mul_v2.launches
    got = H.dual_mul_v2(d2, qtab, gs)
    assert H.dual_mul_v2.launches == before + 1
    _same_point(got, H.dual_mul_v2_plain(d2, qtab, gs))


def test_dual_mul_v2_kernel_full_bucket_ragged(cuda):
    """K5 at the bucket size plus a ragged 37: the 64-window scan body
    at 256 threads a block and 2 blocks an SM, its 48 KB shared-memory
    slots (the table entry in 16-byte chunks, the G row word by word),
    over more blocks than one wave holds, the last block partly empty."""
    gen = np.random.default_rng(53)
    d2 = torch.as_tensor(gen.integers(0, 16, (64, FULL)), device=cuda)
    qtab, gs = _qtab(gen, FULL, cuda), _words(gen, (64, 3, 8, FULL), cuda)
    _same_point(H.dual_mul_v2(d2, qtab, gs),
                H.dual_mul_v2_plain(d2, qtab, gs))


@pytest.mark.parametrize("digit", [0, 15])
def test_dual_mul_v2_kernel_fixed_digit(cuda, digit):
    """K5 with every digit 0 (the table's infinity entry in every window)
    and with every digit 15 (the last entry of every key's table)."""
    gen = np.random.default_rng(54 + digit)
    d2 = torch.full((64, B), digit, dtype=torch.int64, device=cuda)
    qtab, gs = _qtab(gen, B, cuda), _words(gen, (64, 3, 8, B), cuda)
    _same_point(H.dual_mul_v2(d2, qtab, gs),
                H.dual_mul_v2_plain(d2, qtab, gs))


def test_dual_mul_v2_refuses_misaligned_table(cuda):
    """K5 copies table entries in 16-byte pieces: a table that does not
    start on 16 bytes is refused, and nothing is launched."""
    gen = np.random.default_rng(56)
    n = 64
    d2 = torch.as_tensor(gen.integers(0, 16, (64, n)), device=cuda)
    flat = torch.zeros(n * 16 * 3 * 8 + 1, dtype=torch.int32, device=cuda)
    qtab = flat[1:].view(n, 16, 3, 8)
    before = H.dual_mul_v2.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        H.dual_mul_v2(d2, qtab, _words(gen, (64, 3, 8, n), cuda))
    assert H.dual_mul_v2.launches == before


def test_dual_mul_planes_kernel_matches_plain(cuda):
    gen = np.random.default_rng(47)
    qs, gs = (_words(gen, (64, 3, 8, B), cuda) for _ in range(2))
    before = H.dual_mul_planes.launches
    got = H.dual_mul_planes(qs, gs)
    assert H.dual_mul_planes.launches == before + 1
    _same_point(got, H.dual_mul_planes_plain(qs, gs))


def test_dual_mul_planes_kernel_full_bucket_ragged(cuda):
    """K6 at the bucket size plus a ragged 37: the 64-window scan body
    at 256 threads a block and 2 blocks an SM, its 48 KB shared-memory
    slots (both plane rows word by word), over more blocks than one wave
    holds, the last block partly empty."""
    gen = np.random.default_rng(55)
    qs, gs = (_words(gen, (64, 3, 8, FULL), cuda) for _ in range(2))
    _same_point(H.dual_mul_planes(qs, gs), H.dual_mul_planes_plain(qs, gs))


# ---------------------------------------------------------------------------
# S1 and S2, the sign path's kernels


def _sign_key(tag: bytes) -> int:
    import hashlib
    return int.from_bytes(hashlib.sha256(tag).digest(), "big") % \
        (ref.N - 1) + 1


def _int_words(vals, dev):
    return F.words_from_be_bytes(F.ints_to_be_bytes(vals), dev)


def _sign_planes(zs, ds, ks, C, dev):
    return (_int_words(zs, dev), _int_words(ds, dev),
            torch.stack([_int_words([k[c] for k in ks], dev)
                         for c in range(C)]))


def _sign_inputs(gen, n, C, dev):
    """z, d (8, n) and ks (C, 8, n) words: row 0 the hash sha256(b"h14")
    with key from b"d14" and its RFC6979 candidates (no low R among the
    four), rows 1-2 z = 2^256 - 1 and z = n + 5, row 3 candidates k = 1,
    n - 1, 2^128 and 2^252 (digits of 0), the rest random (as far as n
    reaches)."""
    import hashlib

    def rnd(m):
        return int.from_bytes(gen.bytes(32), "big") % m

    zs = [rnd(2**256) for _ in range(n)]
    ds = [rnd(ref.N - 1) + 1 for _ in range(n)]
    ks = [[rnd(ref.N - 1) + 1 for _ in range(4)] for _ in range(n)]
    h14 = hashlib.sha256(b"h14").digest()
    zs[0], ds[0] = int.from_bytes(h14, "big"), _sign_key(b"d14")
    ks[0] = E.rfc6979_candidates(h14, ds[0])
    edges = [(1, "z", 2**256 - 1), (2, "z", ref.N + 5),
             (3, "k", [1, ref.N - 1, 2**128, 2**252])]
    for i, what, v in edges[:max(n - 1, 0)]:
        (zs if what == "z" else ks)[i] = v
    return _sign_planes(zs, ds, ks, C, dev)


def _high_r_nonces(gen, count):
    """`count` random nonces whose r = x(k*G) mod n has bit 255 set, picked
    with the exact-int oracle."""
    out = []
    while len(out) < count:
        k = int.from_bytes(gen.bytes(32), "big") % (ref.N - 1) + 1
        if ref.point_mul(k, ref.G).x % ref.N >= 2**255:
            out.append(k)
    return out


def _same_sign(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


# S1 and S2 at one row, a commitment's 483, a batch that is not a multiple
# of a block, and the bucket and a ragged 37
SIGN_SIZES = [1, 483, B, FULL]
SIGN_IDS = ["one", "commitment", "small", "full"]


@pytest.mark.parametrize("n", SIGN_SIZES, ids=SIGN_IDS)
def test_fixed_base_kernel_matches_plain(cuda, n):
    """S1 against its plain version; the first rows are k = 0, 1, 2, n - 1,
    n, 2^256 - 1, 2^128 and 2^252 (infinity, and digits of 0)."""
    gen = np.random.default_rng(80)
    ks = [int.from_bytes(gen.bytes(32), "big") for _ in range(n)]
    edges = [0, 1, 2, ref.N - 1, ref.N, 2**256 - 1, 2**128, 2**252]
    ks[:min(n, 8)] = edges[:min(n, 8)]
    k8 = _int_words(ks, cuda)
    before = H.fixed_base_affine.launches
    got = H.fixed_base_affine(k8)
    assert H.fixed_base_affine.launches == before + 1
    _same_sign(got, H.fixed_base_affine_plain(k8))
    x = F.words_to_be_bytes(got[0])
    assert not x[0].any()
    if n > 4:
        assert int.from_bytes(x[3].tobytes(), "big") == ref.G.x
        assert not x[4].any()


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("n", SIGN_SIZES, ids=SIGN_IDS)
def test_ecdsa_sign_kernel_matches_plain(cuda, C, n):
    gen = np.random.default_rng(81 + C)
    z8, d8, ks8 = _sign_inputs(gen, n, C, cuda)
    before = H.ecdsa_sign.launches
    got = H.ecdsa_sign(z8, d8, ks8)
    assert H.ecdsa_sign.launches == before + 1
    want = H.ecdsa_sign_plain(z8, d8, ks8)
    _same_sign(got, want)
    assert bool(got[2].all())
    if C == 4:
        assert not bool(got[3][0])                  # h14: candidate 0


@pytest.mark.parametrize("n", [483, FULL], ids=["commitment", "full"])
def test_ecdsa_sign_kernel_rows_past_three_high_candidates(cuda, n):
    """S2 (C = 4) on a batch in which every row's first three candidates
    have a high r, drawn from a pool picked with the exact-int oracle; the
    fourth is random (low about half the time), and every ninth row's too
    is from the pool (no low r among four: candidate 0's).  Against the
    plain version and, on a sample, the exact-int rule."""
    gen = np.random.default_rng(84)
    pool = _high_r_nonces(gen, 256)

    def rnd(m):
        return int.from_bytes(gen.bytes(32), "big") % m

    zs = [rnd(2**256) for _ in range(n)]
    ds = [rnd(ref.N - 1) + 1 for _ in range(n)]
    pick = gen.integers(0, len(pool), (n, 4))
    ks = [[pool[j] for j in pick[i, :3]]
          + [pool[pick[i, 3]] if i % 9 == 0 else rnd(ref.N - 1) + 1]
          for i in range(n)]
    z8, d8, ks8 = _sign_planes(zs, ds, ks, 4, cuda)
    got = H.ecdsa_sign(z8, d8, ks8)
    _same_sign(got, H.ecdsa_sign_plain(z8, d8, ks8))
    grind = got[3].cpu().numpy()
    assert not grind[::9].any() and grind.sum() > n // 4
    r, s = (F.words_to_be_bytes(w) for w in got[:2])
    for i in sorted({0, 1, n - 1, *gen.choice(n, 24, replace=False)}):
        want = E.sign_with_candidates(zs[i], ds[i], ks[i])
        assert (int.from_bytes(r[i].tobytes(), "big"),
                int.from_bytes(s[i].tobytes(), "big"),
                bool(got[2][i]), bool(grind[i])) == want


def test_sign_entry_points_on_card_match_oracle(cuda):
    """ecdsa_sign_batch, derive_pubkeys and schnorr_verify_batch on the
    card against the exact-int rule and oracle, each through its kernels."""
    import hashlib

    from lightning_tpu_torch.crypto import engines as E

    tags = [b"h%d" % i for i in range(8, 40)]
    keys = [_sign_key(b"d%d" % i) for i in range(8, 40)]
    hashes = np.stack([np.frombuffer(hashlib.sha256(t).digest(), np.uint8)
                       for t in tags])
    H.reset_launches()
    assert np.array_equal(E.ecdsa_sign_batch(hashes, keys, device="cuda"),
                          E.host_sign_grind_batch(hashes, keys))
    pubs = E.derive_pubkeys(F.from_int_array(keys).numpy(), device="cuda")
    assert [bytes(p) for p in pubs] == \
        [ref.pubkey_serialize(ref.pubkey_create(k)) for k in keys]
    sigs = np.stack([np.frombuffer(ref.schnorr_sign(bytes(h), k), np.uint8)
                     for h, k in zip(hashes, keys)])
    sigs[5, 40] ^= 1
    xonly = np.ascontiguousarray(pubs[:, 1:])
    got = E.schnorr_verify_batch(hashes, sigs, xonly, device="cuda")
    assert got.tolist() == [i != 5 for i in range(len(keys))]
    counts = H.launch_counts()
    assert counts["ecdsa_sign"] == counts["fixed_base_affine"] == 1
    assert counts["build_tables"] == counts["glv_scan"] == 1


# The kernels each engine launches once a bucket on the card (K1 is the
# "+pp" prep's).
ENGINE_KERNELS = {
    "pallas_fbj+pp": {"verify_prep_core", "build_tables", "glv_scan"},
    "pallas+pp": {"verify_prep_core", "dual_mul_planes"},
    "pallas_v2+pp": {"verify_prep_core", "dual_mul_v2"},
    "pallas_glv+pp": {"verify_prep_core", "glv_scan2"},
    "pallas_fb+pp": {"verify_prep_core", "build_tables", "glv_scan2"},
    "pallas_fb": {"build_tables", "glv_scan2"},
    "glv": set(),
}


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    from lightning_tpu_torch.gossip import synth

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode); "
                    "run on the card with -m gpu")
    path = str(tmp_path_factory.mktemp("gpu") / "gpu.gs")
    info = synth.make_network_store(path, 300, 40, seed=9, device="cuda",
                                    n_corrupt=7, off_curve=1, bad_tag=1,
                                    oversized=2)
    return path, info


@pytest.mark.parametrize("engine", list(ENGINE_KERNELS))
def test_verify_store_on_card(small_store, engine):
    from lightning_tpu_torch.gossip import store, verify

    path, info = small_store
    H.reset_launches()
    res = verify.verify_store(store.load_store(path), bucket=512,
                              device="cuda", engine=engine)
    assert np.array_equal(res.sig_ok, info["expected_sig_ok"])
    assert H.launch_counts() == {
        k.__name__: res.buckets * (k.__name__ in ENGINE_KERNELS[engine])
        for k in H.KERNELS}


def test_live_ingest_on_card_matches_cpu(small_store, tmp_path):
    """The small store's messages in a seeded order (many updates before
    their channel), plus duplicates, through GossipIngest on the card and
    on the CPU, flushed at the same points under one fake clock: the same
    store bytes and stats, and K1-K3 launched once a flush on the card."""
    import asyncio
    import dataclasses

    from lightning_tpu_torch.gossip import ingest, store

    path, _ = small_store
    idx = store.load_store(path)
    msgs = [idx.message(i) for i in range(len(idx))]
    gen = np.random.default_rng(17)
    feed = [msgs[i] for i in gen.permutation(len(msgs))]
    feed += [feed[i] for i in gen.choice(len(feed), 40, replace=False)]

    async def run(device, out):
        ing = ingest.GossipIngest(out, device=device, now=lambda: 0.0)
        for i, m in enumerate(feed):
            await ing.submit(m)
            if i % 400 == 399:
                await ing.flush()
        while ing._queue:
            await ing.flush()
        await ing.close()
        return ing

    H.reset_launches()
    card = asyncio.run(run("cuda", str(tmp_path / "card.gs")))
    counts = H.launch_counts()
    cpu = asyncio.run(run("cpu", str(tmp_path / "cpu.gs")))
    with open(tmp_path / "card.gs", "rb") as a, \
            open(tmp_path / "cpu.gs", "rb") as b:
        assert a.read() == b.read()
    assert dataclasses.asdict(card.stats) == dataclasses.asdict(cpu.stats)
    assert card.stats.accepted > 0 and card.stats.dropped[
        ingest.R_BADSIG] > 0 and card.stats.dropped[ingest.R_NO_CHANNEL] > 0
    assert counts == {k.__name__: card.stats.flushes * (
        k.__name__ in ENGINE_KERNELS["pallas_fbj+pp"]) for k in H.KERNELS}


def _route_graph(small_store):
    from lightning_tpu_torch.gossip import gossmap, store

    return gossmap.from_store(store.load_store(small_store[0]))


def _replay_items(small_store):
    from lightning_tpu_torch.gossip import store, verify

    path, info = small_store
    items, _, _ = verify.extract_store(store.load_store(path))
    return items, info["expected_sig_ok"]


def test_pipelined_replay_on_card_equals_serial(small_store):
    """verify_items on the card at depth 2 (producer thread, pinned
    operands, asynchronous uploads) equals depth 0 and the seeded
    verdicts, with K1-K3 launched once a bucket either way."""
    from lightning_tpu_torch.gossip import verify

    items, expected = _replay_items(small_store)
    for depth in (0, 2):
        H.reset_launches()
        stats: dict = {}
        ok = verify.verify_items(items, 512, device="cuda", stats=stats,
                                 depth=depth)
        assert np.array_equal(ok, expected)
        assert stats["buckets"] > 2
        assert H.launch_counts() == {
            k.__name__: stats["buckets"] * (
                k.__name__ in ENGINE_KERNELS["pallas_fbj+pp"])
            for k in H.KERNELS}


def test_fault_injected_buckets_bisect_on_the_card(small_store):
    """A dispatch fault on every other bucket bisects, and the bisection's
    dispatches run on the card: K3 launches once for every (sub-)bucket
    that completed.  Rows a dispatcher rejects raise Quarantined, every
    other verdict the seeded one, the clean sub-buckets on the card."""
    from lightning_tpu_torch.gossip import verify
    from lightning_tpu_torch.obs import flight
    from lightning_tpu_torch.resilience import breaker
    from lightning_tpu_torch.resilience import faultinject as fi
    from lightning_tpu_torch.resilience import quarantine

    items, expected = _replay_items(small_store)
    poison: set = set()
    done = []

    def dispatcher(b):
        if poison & set(b.sel.tolist()):
            raise ValueError("row rejected")
        done.append(len(b.sel))
        return verify.verify_bucket(b, torch.device("cuda"))

    breaker.reset_for_tests()
    flight.reset_for_tests()
    H.reset_launches()
    with fi.arm("dispatch:verify:raise:0.5"):
        ok = verify.verify_items(items, 512, device="cuda",
                                 device_fn=dispatcher)
    assert np.array_equal(ok, expected)
    assert H.launch_counts()["glv_scan"] == len(done)
    assert "bisect" in {r["outcome"] for r in flight.recent("verify")}
    poison.update({3, 700, 701, len(items) - 1})
    done.clear()
    H.reset_launches()
    with pytest.raises(quarantine.Quarantined) as e:
        verify.verify_items(items, 512, device="cuda", device_fn=dispatcher)
    assert e.value.rows == sorted(poison)
    keep = np.ones(len(items), bool)
    keep[e.value.rows] = False
    assert np.array_equal(e.value.verdicts[keep], expected[keep])
    assert H.launch_counts()["glv_scan"] == len(done) > 0
    breaker.reset_for_tests()


def test_out_of_memory_in_the_first_dispatch_bisects_and_completes(
        small_store):
    from lightning_tpu_torch.gossip import verify
    from lightning_tpu_torch.obs import flight
    from lightning_tpu_torch.resilience import breaker

    items, expected = _replay_items(small_store)
    calls = []

    def oom_once(b):
        calls.append(len(b.sel))
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
        return verify.verify_bucket(b, torch.device("cuda"))

    breaker.reset_for_tests()
    flight.reset_for_tests()
    ok = verify.verify_items(items, 512, device="cuda", device_fn=oom_once)
    assert np.array_equal(ok, expected)
    first = flight.recent("verify")[0]
    assert (first["outcome"], first["error"]) == ("bisect",
                                                  "OutOfMemoryError")
    assert calls[1] == calls[0]          # the whole bucket, on the card
    breaker.reset_for_tests()


def test_route_sweep_kernel_matches_plain(small_store):
    """R1 against its plain version on the card at a ragged batch (67
    queries), at every cluster size: dist at the source, via and the
    overflow flag equal,
    with excluded edges, amounts up to 2^48 and riskfactors 0 to 10^6,
    and the sweeps stop before max_hops on this small graph; then
    solve_batch on the card answers as on the CPU."""
    from lightning_tpu_torch.routing import device as RD
    from lightning_tpu_torch.routing import hopper_route as HR
    from lightning_tpu_torch.routing.planes import RoutePlanes

    g = _route_graph(small_store)
    g.fee_ppm[:, :20] = 9_999           # overflow at the largest amounts
    g.htlc_max_msat[:, :20] = 0
    planes = RoutePlanes.build(g, "cuda")
    args, _ = RD._device_plane_args(planes)
    in_off = planes.dev["in_off"]
    gen = np.random.default_rng(5)
    Bq = 67
    ok = np.stack([planes.edge_ok_mask()] * Bq)
    ok &= gen.random(ok.shape) < 0.95
    lanes = [ok, gen.integers(0, g.n_nodes, Bq).astype(np.int32),
             gen.integers(0, g.n_nodes, Bq).astype(np.int32),
             gen.choice([0, 1_000, 10**6, 10**9, 1 << 47, 1 << 48],
                        Bq).astype(np.int64),
             gen.integers(9, 40, Bq).astype(np.int64),
             gen.choice([0, 1, 10, 10**6], Bq).astype(np.int64)]
    lanes = [torch.as_tensor(a, device="cuda") for a in lanes]
    want = HR.route_sweep_plain(*args, *lanes, planes.n_pad, 20)
    for cluster in HR.CLUSTER_SIZES:
        before = HR.route_sweep.launches
        work = []
        got = HR.route_sweep(*args, *lanes, planes.n_pad, 20, in_off=in_off,
                             work=work, _cluster=cluster)
        torch.cuda.synchronize()
        assert HR.route_sweep.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), cluster
        sweeps = work[0][:, 0]
        assert (sweeps >= 1).all() and (sweeps < 20).all(), sweeps
    assert got[2].any() and (got[0] < HR.INF_COST).any()
    qs = []
    for _ in range(70):
        a, b = gen.choice(g.n_nodes, 2, replace=False)
        qs.append(RD.RouteQuery(bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                                int(gen.integers(1_000, 10**9))))
    card = RD.solve_batch(planes, qs)
    cpu = RD.solve_batch(RoutePlanes.build(g, "cpu"), qs)
    assert repr(card) == repr(cpu)


def test_route_sweep_stops_at_its_fixed_point_and_keeps_the_hop_cap(cuda):
    """Two chains in one graph: 21 edges i + 1 -> i (nodes 0 .. 21) and
    3 edges 33 -> 32 -> 31 -> 30.  A path of exactly 20 hops is found,
    one of 21 is not (20 sweeps run); the 3-hop chain's queries stop
    after 4 sweeps (the last changes nothing) having priced 3 edges; at
    every cluster size, equal to the plain version."""
    from lightning_tpu_torch.routing import hopper_route as HR
    from lightning_tpu_torch.routing.planes import in_csr

    dev = cuda
    E, n = 256, 64
    u = np.r_[np.arange(1, 22), [31, 32, 33]].astype(np.int32)
    v = np.r_[np.arange(0, 21), [30, 31, 32]].astype(np.int32)
    m = len(u)
    planes = [np.zeros(E, np.int32), np.zeros(E, np.int32)] + [
        np.zeros(E, np.int64) for _ in range(5)]
    planes[0][:m], planes[1][:m] = u, v
    planes[2][:m] = 1                              # base fee
    planes[4][:m] = 6                              # cltv delta
    in_off = torch.as_tensor(in_csr(v, n), device=dev)
    planes = [torch.as_tensor(p, device=dev) for p in planes]
    ok = np.zeros((4, E), bool)
    ok[:, :m] = True
    lanes = [ok, np.array([20, 21, 33, 5], np.int32),
             np.array([0, 0, 30, 30], np.int32),
             np.full(4, 10_000, np.int64), np.full(4, 18, np.int64),
             np.full(4, 10, np.int64)]
    lanes = [torch.as_tensor(a, device=dev) for a in lanes]
    want = HR.route_sweep_plain(*planes, *lanes, n, 20)
    assert want[0][0] < HR.INF_COST and want[0][1] >= HR.INF_COST
    for cluster in HR.CLUSTER_SIZES:
        work = []
        got = HR.route_sweep(*planes, *lanes, n, 20, in_off=in_off,
                             work=work, _cluster=cluster)
        for a, b in zip(got, want):
            assert torch.equal(a, b), cluster
        assert work[0].tolist() == [[20, 20], [20, 20], [4, 3], [4, 3]], \
            cluster


def test_mcf_solve_kernel_matches_plain(small_store):
    """R2 against its plain version on the card, at every cluster size:
    the small store's lanes (single- and multi-part amounts), then random
    residual graphs with equal and -0.0 costs, negative cycles (walk
    failures), dead ends and augmentation caps, padded to 64 nodes (the
    node entries in shared memory at every size) and to 2^17 (in global
    memory at every size); flows, remaining and both flags equal; then
    solve_mcf_batch on the card answers as on the CPU."""
    from lightning_tpu_torch.routing import hopper_route as HR
    from lightning_tpu_torch.routing import mcf_device as MD

    g = _route_graph(small_store)
    planes = MD.McfPlanes.build(g, "cuda")
    gen = np.random.default_rng(9)
    qs = []
    for i in range(16):
        a, b = gen.choice(g.n_nodes, 2, replace=False)
        amt = int(gen.integers(10**5, 5 * 10**7)) if i < 8 \
            else int(gen.integers(10**10, 10**11))
        qs.append(MD.McfQuery(bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                              amt, max_parts=8))
    arcs = planes.device_arcs()
    cases = []
    for chunk in (qs[:8], qs[8:]):
        ops = MD._prep_chunk(planes, chunk, 8, 1.0, [None] * 8)
        cases.append((arcs, ops, planes.n_pad))
    for case in range(6):
        af = 64
        fs = gen.integers(0, 12, af).astype(np.int32)
        fd = gen.integers(0, 12, af).astype(np.int32)
        vals = (np.array([0.0, -0.0, 1.0, 2.0, -1.0, 0.5, 1e-10])
                if case % 2 else gen.normal(0, 5, 20))
        ops = (gen.choice(vals, (8, af)).astype(np.float64),
               (gen.integers(0, 50, (8, af))
                * (gen.random((8, af)) < 0.7)).astype(np.int64),
               gen.integers(0, 12, 8).astype(np.int32),
               gen.integers(0, 12, 8).astype(np.int32),
               gen.integers(1, 200, 8).astype(np.int64),
               gen.integers(0, 65, 8).astype(np.int32))
        a_src = torch.as_tensor(np.stack([fs, fd], 1).reshape(-1),
                                device="cuda")
        a_dst = torch.as_tensor(np.stack([fd, fs], 1).reshape(-1),
                                device="cuda")
        for n_pad in (64, 1 << 17):
            tail = HR.tail_csr(a_src, 2 * af, n_pad)
            cases.append(((a_src, a_dst, *tail,
                           *HR.tail_order(a_dst, tail[1])), ops, n_pad))
    assert HR.r2_shared(HR.split(64, 1)[0])
    assert not HR.r2_shared(HR.split(1 << 17, 16)[0])
    seen = np.zeros(3, int)
    for arcs, ops, n_pad in cases:
        t = [torch.as_tensor(o, device="cuda") for o in ops]
        want = HR.mcf_solve_plain(*arcs[:2], *t, n_pad)
        for cluster in HR.CLUSTER_SIZES:
            before = HR.mcf_solve.launches
            got = HR.mcf_solve(*arcs, *t, n_pad, _cluster=cluster)
            torch.cuda.synchronize()
            assert HR.mcf_solve.launches == before + 1
            for x, y in zip(got, want):
                assert torch.equal(x, y), (cluster, n_pad)
        seen += [int((got[1] > 0).sum()), int(got[2].sum()),
                 int(got[3].sum())]
    assert (seen > 0).all()
    card = MD.solve_mcf_batch(planes, qs)
    cpu = MD.solve_mcf_batch(MD.McfPlanes.build(g, "cpu"), qs)
    assert repr(card) == repr(cpu)
    assert sum(r[0] == "ok" for r in card) >= 8


def _supervised_run(svc, calls, fam):
    import asyncio

    from lightning_tpu_torch.obs import flight

    base = max([r["dispatch_id"] for r in flight.recent(fam)] or [0])

    async def go():
        svc.start()
        out = await asyncio.gather(*(c(svc) for c in calls),
                                   return_exceptions=True)
        await svc.close()
        return out
    out = asyncio.run(go())
    return out, [r for r in flight.recent(fam) if r["dispatch_id"] > base]


@pytest.mark.parametrize("spec", [None, "dispatch:*:raise:1.0"],
                         ids=["clean", "faulted"])
def test_supervised_services_on_card_match_cpu(small_store, spec):
    """RouteService and McfService on the card and on the CPU: clean, the
    same answers, one "ok" flight record a flush and R1's / R2's launches
    the records' batches on the card; with every dispatch faulted, the
    card's queries fail with the injected error, records "error", no
    launch, no host answer."""
    import contextlib

    from lightning_tpu_torch.resilience import breaker, faultinject
    from lightning_tpu_torch.routing import device as RD
    from lightning_tpu_torch.routing import hopper_route as HR
    from lightning_tpu_torch.routing import mcf_device as MD

    g = _route_graph(small_store)
    gen = np.random.default_rng(12)
    pairs = [gen.choice(g.n_nodes, 2, replace=False) for _ in range(40)]
    rq = [(bytes(g.node_ids[a]), bytes(g.node_ids[b]),
           int(gen.integers(10**3, 10**8))) for a, b in pairs]
    mq = rq[:9]
    out = {}
    for dev in ("cpu", "cuda"):
        breaker.reset_for_tests()
        HR.reset_launches()
        arm = faultinject.arm(spec) if spec and dev == "cuda" \
            else contextlib.nullcontext()
        with arm:
            r, rrec = _supervised_run(
                RD.RouteService(lambda: g, device=dev, batch=16),
                [(lambda q: lambda s: s.getroute(*q, with_source=True))(q)
                 for q in rq], "route")
            m, mrec = _supervised_run(
                MD.McfService(lambda: g, device=dev),
                [(lambda q: lambda s: s.getroutes(*q, max_parts=8))(q)
                 for q in mq], "mcf")
        out[dev] = (r, rrec, m, mrec, HR.launch_counts())
    r, rrec, m, mrec, counts = out["cuda"]
    if spec is None:
        assert repr(r) == repr(out["cpu"][0])
        assert repr(m) == repr(out["cpu"][2])
        assert {x["outcome"] for x in rrec + mrec} == {"ok"}
        assert counts == {
            "route_sweep": sum(x["lanes"] // 16 for x in rrec),
            "mcf_solve": sum(x["lanes"] // MD.MCF_BATCH for x in mrec)}
    else:
        assert all(isinstance(x, faultinject.FaultInjected) for x in r + m)
        assert {x["outcome"] for x in rrec + mrec} == {"error"}
        assert counts == {"route_sweep": 0, "mcf_solve": 0}
    breaker.reset_for_tests()


def test_sample_device_memory_reads_the_caching_allocator(cuda):
    from lightning_tpu_torch.obs import attribution

    x = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
    mem = attribution.sample_device_memory()
    stats = mem[f"cuda:{torch.cuda.current_device()}"]
    assert stats["bytes_in_use"] >= x.numel()
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_reserved"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1]
    del x


def test_peer_gossip_sync_on_card(cuda, tmp_path):
    """Two port nodes over loopback Noise, both verifying on the card: A
    replays a 200-channel store through K1-K3, blank B syncs it with its
    seeker (at most 5 rounds); B's accepted set equals A's, and K1-K3
    launched once a flush of B's."""
    import asyncio
    import random

    from lightning_tpu_torch.daemon.node import LightningNode
    from lightning_tpu_torch.gossip import gossipd as GD
    from lightning_tpu_torch.gossip import seeker as SK
    from lightning_tpu_torch.gossip import synth

    src = str(tmp_path / "src.gs")
    info = synth.make_network_store(src, 200, 40, seed=11, device=cuda)

    def view(g):
        return (set(g.ingest.channels), dict(g.ingest.updates),
                dict(g.ingest.nodes))

    async def body():
        na, nb = LightningNode(privkey=0xA1), LightningNode(privkey=0xB1)
        ga = GD.Gossipd(na, str(tmp_path / "a.gs"), device=cuda)
        gb = GD.Gossipd(nb, str(tmp_path / "b.gs"), device=cuda)
        H.reset_launches()
        assert ga.load_existing(src, verify=True) == 200 + 400 + 40
        assert H.launch_counts()["glv_scan"] == 1
        H.reset_launches()
        ga.start()
        gb.start()
        try:
            port = await na.listen()
            await nb.connect("127.0.0.1", port, na.node_id)
            sk = SK.Seeker(gb, rng=random.Random(1),
                           clock=lambda: 1_700_086_400.0)
            for _ in range(5):
                await sk.tick()
                await gb.ingest.drain()
                if view(gb) == view(ga):
                    break
            assert view(gb) == view(ga)
            assert len(gb.ingest.channels) == info["channels"]
            flushes = gb.ingest.stats.flushes
            assert flushes > 0 and ga.ingest.stats.flushes == 0
            assert H.launch_counts() == {
                k.__name__: flushes * (k.__name__ in ENGINE_KERNELS[
                    "pallas_fbj+pp"]) for k in H.KERNELS}
        finally:
            for x in (ga, gb, na, nb):
                await x.close()

    asyncio.run(asyncio.wait_for(body(), 300))
