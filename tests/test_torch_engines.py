"""Every verify engine of the port against the JAX package.

One batch of 17 signatures serves every engine, so that each engine
costs one plain-torch verify (about 3 s on one CPU thread):

* rows 0-7 are tests/test_pallas_secp.py's test_full_verify_fused_engines
  cases (default_rng(12), one corrupted signature, an off-curve key,
  s = 0);
* rows 8-15 carry that file's dual-mul inputs (default_rng(8), edge
  scalars 0, 1 and n - 1 on both sides, and u1*G = -u2*Q) as signatures
  with s = 1, so that the verify path's u1 = z and u2 = r;
* row 16 is row 0 under the bad key tag 0x04.

Under each engine, ecdsa_verify_batch(device="cpu") must give the JAX
package's host_verify_batch verdicts, and the engine's dual
multiplication, and with it the plain versions of K4 (pallas_glv,
pallas_fb), K5 (pallas_v2) and K6 (pallas), the exact-int oracle's
points on rows 8-15.  Engine names parse as the JAX package's
resolve_dual_mul, resolve_prep and _resolve_engine_names parse them
(pure Python, with the names passed so that no environment variable is
read).  No JAX EC program is compiled: the constant tables are compared
as the JAX package's numpy arrays.  CPU tensors throughout (the wrappers
take the plain versions for CPU tensors).
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from lightning_tpu.crypto import pallas_secp as PS
from lightning_tpu.crypto import ref_python as ref
from lightning_tpu.crypto import secp256k1 as JS
from lightning_tpu_torch import convert
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import field as F
from lightning_tpu_torch.crypto import hopper_secp as H
from lightning_tpu_torch.crypto import secp256k1 as S

torch.set_num_threads(1)

B = 8
P, N = ref.P, ref.N
ENGINES = ["xla", "glv+pp", "pallas+pp", "pallas_v2+pp", "pallas_glv+pp",
           "pallas_fb", "pallas_fbj+pp"]   # every dual mul, both preps


def _signature_rows(hashes, sigs, keys):
    pubs = np.zeros((len(keys), 33), np.uint8)
    for i, p in enumerate(keys):
        pubs[i, 0] = 2 + (p.y & 1)
        pubs[i, 1:] = np.frombuffer(p.x.to_bytes(32, "big"), np.uint8)
    return hashes, sigs, pubs


def _verify_cases():
    """test_full_verify_fused_engines' cases: default_rng(12), signature
    2 corrupted, key 4 off the curve, s = 0 in signature 5."""
    rng = np.random.default_rng(12)
    msgs = rng.integers(0, 256, (B, 32)).astype(np.uint8)
    keys = [int.from_bytes(rng.bytes(32), "big") % N or 1 for _ in range(B)]
    hashes = np.stack([np.frombuffer(hashlib.sha256(bytes(m)).digest(),
                                     np.uint8) for m in msgs])
    sigs = np.zeros((B, 64), np.uint8)
    for i, k in enumerate(keys):
        r, s = ref.ecdsa_sign(bytes(hashes[i]), k)
        sigs[i] = np.frombuffer(r.to_bytes(32, "big") + s.to_bytes(32, "big"),
                                np.uint8)
    hashes, sigs, pubs = _signature_rows(
        hashes, sigs, [ref.pubkey_create(k) for k in keys])
    sigs[2, 40] ^= 0xFF
    pubs[4, 1:] = 0
    pubs[4, 32] = 5
    sigs[5, 32:] = 0
    return hashes, sigs, pubs


def _dual_mul_cases():
    """tests/test_pallas_secp.py's dual-mul inputs: default_rng(8), edge
    scalars 0, 1 and n - 1 on both sides; the last row has
    u1*G = -u2*Q.  As signatures with s = 1, so that the verify path's
    u1 = z and u2 = r."""
    rng = np.random.default_rng(8)
    k1s = [0, 1, N - 1] + [int.from_bytes(rng.bytes(32), "big") % N
                           for _ in range(B - 3)]
    k2s = [1, 0, N - 1] + [int.from_bytes(rng.bytes(32), "big") % N
                           for _ in range(B - 3)]
    pts = [ref.pubkey_create(int.from_bytes(rng.bytes(32), "big") % N or 1)
           for _ in range(B)]
    pts[-1] = ref.pubkey_create(7)
    k2s[-1] = (N - k1s[-1]) * pow(7, -1, N) % N
    hashes = np.stack([np.frombuffer(k.to_bytes(32, "big"), np.uint8)
                       for k in k1s])
    sigs = np.stack([np.frombuffer(k.to_bytes(32, "big")
                                   + (1).to_bytes(32, "big"), np.uint8)
                     for k in k2s])
    want = [ref.point_add(ref.point_mul(a, ref.G), ref.point_mul(b, q))
            for a, b, q in zip(k1s, k2s, pts)]
    assert want[-1].inf
    return _signature_rows(hashes, sigs, pts), k1s, k2s, want


@pytest.fixture(scope="module")
def batch():
    """One batch for every engine: rows 0-7 the verify cases, rows 8-15
    the dual-mul cases, row 16 row 0 under the bad key tag 0x04."""
    vh, vs, vp = _verify_cases()
    (dh, ds, dp), k1s, k2s, points = _dual_mul_cases()
    hashes, sigs, pubs = (np.concatenate([a, b, a[:1]])
                          for a, b in ((vh, dh), (vs, ds), (vp, dp)))
    pubs[-1, 0] = 4
    host = JS.host_verify_batch(hashes, sigs, pubs)
    expect = np.ones(B, bool)
    expect[[2, 4, 5]] = False
    assert np.array_equal(host[:B], expect) and not host[-1]
    return hashes, sigs, pubs, host, k1s, k2s, points


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_end_to_end(engine, batch, monkeypatch):
    """ecdsa_verify_batch(device="cpu") -> ecdsa_verify_kernel under
    `engine` gives the JAX package's host_verify_batch verdicts, and the
    engine's dual multiplication (for K4-K6, their plain versions) gives
    the oracle's u1*G + u2*Q on the dual-mul rows, Z = 0 at infinity."""
    hashes, sigs, pubs, host, k1s, k2s, points = batch
    impl, _ = E.resolve_engine_names(engine)
    real, seen = E.DUAL_MUL[impl], []

    def spy(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    monkeypatch.setitem(E.DUAL_MUL, impl, spy)
    got = E.ecdsa_verify_batch(hashes, sigs, pubs, engine=engine,
                               device="cpu")
    assert np.array_equal(got, host)
    (u1, u2, _, _), (X, Y, Z) = seen[0]
    for j, want in enumerate(points):
        i = B + j
        assert F.limbs_to_int(u1[i]) == k1s[j]
        assert F.limbs_to_int(u2[i]) == k2s[j]
        z = F.limbs_to_int(Z[i]) % P
        if want.inf:
            assert z == 0, j
            continue
        zi = pow(z, -1, P)
        assert (F.limbs_to_int(X[i]) * zi % P,
                F.limbs_to_int(Y[i]) * zi % P) == (want.x, want.y), j


NAMES = ["xla", "scan", "glv", "pallas", "pallas_v2", "pallas_glv",
         "pallas_fb", "pallas_fbj", "pallas_fbj+pp", "pallas_fb+pp",
         "pallas+xla", "glv+pallas", "pallas_v2+pp"]


def test_engine_names_parse_as_the_jax_package():
    """The JAX parse takes the prep of a name without a suffix from an
    environment variable whose default is xla: pass that default."""
    for name in NAMES:
        assert E.resolve_engine_names(name) \
            == JS._resolve_engine_names(name, "xla"), name
        impl, pname = E.resolve_engine_names(name)
        got = E.resolve_dual_mul(impl)
        want = JS.resolve_dual_mul(impl)
        if want is None:                 # the JAX package's own XLA scan
            assert got is S.dual_mul
        else:
            assert got.__name__ == want.__name__
        assert (E.resolve_prep(pname) is H.verify_prep) \
            == (JS.resolve_prep(pname) is PS.verify_prep_pallas)
    assert E.resolve_engine_names(E.DEFAULT_ENGINE) == ("pallas_fbj",
                                                        "pallas")
    assert E.resolve_engine("pallas_fb") == (E.prep_xla,
                                             E.dual_mul_pallas_fb)


@pytest.mark.parametrize("bad", ["pallas_v3", "pallas_fb+tpu", "fbj+pp"])
def test_unknown_engine_names_raise_key_error(bad):
    with pytest.raises(KeyError):
        impl, prep = JS._resolve_engine_names(bad, "xla")
        JS.resolve_dual_mul(impl)
        JS.resolve_prep(prep)
    with pytest.raises(KeyError):
        E.resolve_engine(bad)


EDGES = [0, 1, 2, N - 1, N, P - 1, 2**256 - 1, 12345, 3]   # odd B too


def test_inv_batch_and_pow_const_match_pow():
    for mod in (F.FN, F.FP):
        a = F.from_int_array(EDGES)
        want = [pow(x % mod.m, mod.m - 2, mod.m) for x in EDGES]
        assert F.to_int_list(F.normalize(mod, F.inv_batch(mod, a))) == want
        assert F.to_int_list(F.normalize(mod, F.pow_const(mod, a, 65537))) \
            == [pow(x, 65537, mod.m) for x in EDGES]
    a, b = F.from_int_array(EDGES), F.from_int_array(EDGES[::-1])
    assert F.to_int_list(F.normalize(F.FP, F.add3(F.FP, a, b, a))) \
        == [(2 * x + y) % P for x, y in zip(EDGES, EDGES[::-1])]
    assert F.odd(F.normalize(F.FP, F.sqr(F.FP, a))).tolist() \
        == [bool(x * x % P & 1) for x in EDGES]


def test_decompress_and_prep_xla_match_oracle():
    rng = np.random.default_rng(13)
    pts = [ref.pubkey_create(int.from_bytes(rng.bytes(32), "big") % N or 1)
           for _ in range(B - 2)]
    off = next(x for x in range(1, 100)
               if pow((x ** 3 + 7) % P, (P - 1) // 2, P) != 1)
    xs = [p.x for p in pts] + [off, 0]
    parity = torch.as_tensor([p.y & 1 for p in pts] + [0, 1]) ^ \
        torch.as_tensor([0, 1] * (B // 2))
    ss = [int.from_bytes(rng.bytes(32), "big") for _ in range(B - 1)] + [0]
    qx = F.from_int_array(xs)
    y, on_curve = S.decompress(qx, parity)
    qy, on_curve2, w = E.prep_xla(qx, parity, F.from_int_array(ss))
    assert torch.equal(y, qy) and torch.equal(on_curve, on_curve2)
    assert on_curve.tolist() == [True] * (B - 2) + [False, False]
    for i, p in enumerate(pts):
        want = ref.pubkey_parse(bytes([2 + int(parity[i])])
                                + p.x.to_bytes(32, "big")).y
        assert F.limbs_to_int(F.normalize(F.FP, y)[i]) == want
    assert F.to_int_list(F.normalize(F.FN, w)) \
        == [pow(s % N, N - 2, N) for s in ss]


def test_kernel_word_tables_equal_the_jax_arrays():
    """The G tables the engines gather from, in kernel words, hold the
    JAX package's values."""
    for name, jax_arr in (("g", JS._g_window_proj()),
                          ("g_signed", PS._signed_g_tables()[0]),
                          ("phi_g_signed", PS._signed_g_tables()[1])):
        want = convert.limbs(jax_arr)
        got = F.from_u32x8(E.shared_words(name, "cpu").reshape(-1, 8).T)
        assert torch.equal(got.reshape(want.shape), want), name
