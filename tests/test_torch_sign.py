"""The sign path's plain versions and batch entry points on the CPU,
against the exact-int oracle and the JAX package.

* S2's plain version (``hopper_secp.ecdsa_sign`` on CPU tensors) and
  ``engines.ecdsa_sign_batch`` against the four-candidate rule
  ``engines.sign_with_candidates``, with a row that has no low-R nonce
  among its first four (hash sha256(b"h14"), key from b"d14") and hashes
  z >= n;
* rows with a low-R candidate against the JAX package's host signer
  ``lightning_tpu.crypto.secp256k1.host_sign_batch`` byte for byte (pure
  Python: no JAX EC program is compiled);
* S1's plain version and ``engines.derive_pubkeys`` against
  ``ref.pubkey_create``; ``schnorr_verify_batch`` against
  ``ref.schnorr_verify``;
* the comb table carried over from the JAX package, and the synthetic
  store's bytes (signed through S1 and S2) pinned by digest.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from lightning_tpu.crypto import ref_python as jref
from lightning_tpu.crypto import secp256k1 as JS
from lightning_tpu_torch import convert
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import field as F
from lightning_tpu_torch.crypto import hopper_secp as H
from lightning_tpu_torch.crypto import ref_python as ref
from lightning_tpu_torch.crypto import secp256k1 as S
from lightning_tpu_torch.gossip import synth

torch.set_num_threads(1)

N = ref.N


def _key(tag: bytes) -> int:
    return int.from_bytes(hashlib.sha256(tag).digest(), "big") % (N - 1) + 1


def _hashes(tags) -> np.ndarray:
    return np.stack([np.frombuffer(hashlib.sha256(t).digest(), np.uint8)
                     for t in tags])


def test_ref_point_mul_matches_the_jax_package_oracle():
    """The port's Jacobian double-and-add gives the affine chain's points,
    infinity and off-curve inputs included."""
    rng = np.random.default_rng(70)
    ks = [0, 1, 2, N - 1, N, N + 1, 2**256 - 1] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(6)]
    for p in (jref.G, jref.point_mul(7, jref.G), jref.Point(5, 9)):
        for k in ks:
            a, b = ref.point_mul(k, ref.Point(p.x, p.y)), jref.point_mul(k, p)
            assert (a.x, a.y, a.inf) == (b.x, b.y, b.inf)


def test_inv_p_chain_and_comb_match_oracle():
    rng = np.random.default_rng(71)
    vals = [0, 1, ref.P - 1] + [int.from_bytes(rng.bytes(32), "big") % ref.P
                                for _ in range(3)]
    got = F.to_int_list(F.normalize(F.FP, S.inv_p(F.from_int_array(vals))))
    assert got == [pow(v, ref.P - 2, ref.P) for v in vals]
    ks = [1, 2**4, 2**252, N - 1, 0x1000000010000001, 0]
    x, y = S.derive_pubkeys_kernel(F.from_int_array(ks))
    for i, k in enumerate(ks):
        want = ref.point_mul(k, ref.G)
        assert (F.limbs_to_int(x[i]), F.limbs_to_int(y[i])) == \
            ((0, 0) if want.inf else (want.x, want.y))


def test_comb_table_carries_over_from_the_jax_package():
    assert torch.equal(convert.comb_table(JS._comb_table()),
                       torch.as_tensor(S._comb_table()))


def _rule_rows():
    """(z, d, four candidates): h14 (no low R among its four RFC6979
    nonces), two RFC6979 rows, z = 2^256 - 1 and z = n + 5 with seeded
    candidates, and candidates k = 1, n - 1."""
    rows = []
    for i in (14, 3, 5):
        h = hashlib.sha256(b"h%d" % i).digest()
        d = _key(b"d%d" % i)
        rows.append((int.from_bytes(h, "big"), d,
                     E.rfc6979_candidates(h, d)))
    rng = np.random.default_rng(72)
    rand = [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
            for _ in range(12)]
    rows.append((2**256 - 1, rand[0], rand[1:5]))
    rows.append((N + 5, rand[5], rand[6:10]))
    rows.append((rand[10], rand[11], [1, N - 1, 7, 9]))
    return rows


@pytest.mark.parametrize("C", [1, 4])
def test_plain_sign_matches_four_candidate_rule(C):
    rows = _rule_rows()
    z8 = F.words_from_be_bytes(F.ints_to_be_bytes([r[0] for r in rows]))
    d8 = F.words_from_be_bytes(F.ints_to_be_bytes([r[1] for r in rows]))
    ks8 = torch.stack([F.words_from_be_bytes(F.ints_to_be_bytes(
        [r[2][c] for r in rows])) for c in range(C)])
    r8, s8, ok, grind = H.ecdsa_sign(z8, d8, ks8)
    rs = F.words_to_be_bytes(r8)
    ss = F.words_to_be_bytes(s8)
    for i, (z, d, ks) in enumerate(rows):
        wr, ws, wok, wgrind = E.sign_with_candidates(z, d, ks[:C])
        assert (int.from_bytes(rs[i].tobytes(), "big"),
                int.from_bytes(ss[i].tobytes(), "big"),
                bool(ok[i]), bool(grind[i])) == (wr, ws, wok, wgrind), i
    if C == 4:
        assert not grind[0] and grind[1:3].all()


def test_sign_batch_matches_rule_and_jax_host_signer():
    """ecdsa_sign_batch (S2's plain version) equals the exact-int rule on
    every row; where a row has a low-R candidate among its four it also
    equals the JAX package's host signer, and on h14, which has none, the
    port returns candidate 0's high R where the JAX host signer grinds
    on to a low one."""
    tags = [b"h%d" % i for i in range(12, 20)]
    keys = [_key(b"d%d" % i) for i in range(12, 20)]
    hashes = _hashes(tags)
    got = E.ecdsa_sign_batch(hashes, keys, device="cpu")
    assert np.array_equal(got, E.host_sign_grind_batch(hashes, keys))
    jax_host = JS.host_sign_batch(hashes, keys)
    low = [E.sign_with_candidates(int.from_bytes(bytes(h), "big"), d,
                                  E.rfc6979_candidates(bytes(h), d))[3]
           for h, d in zip(hashes, keys)]
    assert low == [True, True, False] + [True] * 5     # row 2 is h14
    for i, is_low in enumerate(low):
        assert np.array_equal(got[i], jax_host[i]) == is_low
    assert got[2, 0] >= 0x80 and jax_host[2, 0] < 0x80
    sigs = np.asarray(got)
    for h, d, sig in zip(hashes, keys, sigs):
        assert ref.ecdsa_verify(bytes(h), int.from_bytes(sig[:32], "big"),
                                int.from_bytes(sig[32:], "big"),
                                ref.pubkey_create(d))


def test_sign_batch_raises_on_a_degenerate_row(monkeypatch):
    """A real row whose s is 0 raises, as the JAX package's batch asserts
    (z = -r d mod n for candidate 0 of a row with a low R)."""
    h = hashlib.sha256(b"h3").digest()
    d = _key(b"d3")
    k = E.rfc6979_candidates(h, d)[0]
    r = ref.point_mul(k, ref.G).x % N
    assert r < 2**255
    z = (-r * d) % N
    monkeypatch.setattr(E, "rfc6979_candidates",
                        lambda msg, key, count=4: [k] * count)
    with pytest.raises(RuntimeError, match="degenerate nonce"):
        E.ecdsa_sign_batch(F.ints_to_be_bytes([z]), [d], device="cpu")


def test_derive_pubkeys_matches_oracle():
    rng = np.random.default_rng(73)
    ks = [1, 2, 2**4, 2**128, N - 1] + [
        int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in range(3)]
    got = E.derive_pubkeys(F.from_int_array(ks).numpy(), device="cpu")
    assert [bytes(p) for p in got] == \
        [ref.pubkey_serialize(ref.pubkey_create(k)) for k in ks]


def _odd_r_signature(msg: bytes, d: int) -> bytes:
    """A BIP340 signature whose R = s*G - e*P has x(R) = r but odd y:
    the signer's nonce point is left with odd y instead of negated."""
    p = ref.pubkey_create(d)
    d = d if p.y % 2 == 0 else N - d
    k = next(k for k in range(2, 100) if ref.pubkey_create(k).y % 2)
    rx = ref.pubkey_create(k).x
    e = int.from_bytes(ref.tagged_hash(
        "BIP0340/challenge", rx.to_bytes(32, "big") + p.x.to_bytes(32, "big")
        + msg), "big") % N
    return rx.to_bytes(32, "big") + ((k + e * d) % N).to_bytes(32, "big")


def test_schnorr_verify_batch_matches_oracle():
    """Valid signatures (keys of even and odd y), a corrupted s, a
    corrupted message and an R of odd y, against ref.schnorr_verify."""
    keys = [_key(b"s%d" % i) for i in range(4)]
    assert {ref.pubkey_create(k).y % 2 for k in keys} == {0, 1}
    msgs = [hashlib.sha256(b"m%d" % i).digest() for i in range(7)]
    sigs = [ref.schnorr_sign(m, k) for m, k in zip(msgs, keys)]
    sigs += [bytearray(sigs[0]), sigs[1], _odd_r_signature(msgs[6], keys[2])]
    sigs[4][40] ^= 1                                   # corrupted s
    msgs[5] = msgs[1][:-1] + bytes([msgs[1][-1] ^ 1])  # corrupted message
    pubs = [ref.pubkey_create(k).x.to_bytes(32, "big")
            for k in keys + [keys[0], keys[1], keys[2]]]

    def arr(xs):
        return np.stack([np.frombuffer(bytes(x), np.uint8) for x in xs])

    got = E.schnorr_verify_batch(arr(msgs), arr(sigs), arr(pubs),
                                 device="cpu")
    want = [ref.schnorr_verify(bytes(m), int.from_bytes(p, "big"), bytes(s))
            for m, s, p in zip(msgs, sigs, pubs)]
    assert want == [True] * 4 + [False] * 3
    assert got.tolist() == want


def test_sign_wrappers_refuse_other_devices():
    x = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        H.fixed_base_affine(x)
    with pytest.raises(ValueError, match="unsupported device"):
        H.ecdsa_sign(x, x, x[None])


# sha256 of the store make_network_store(path, 24, 8, seed=5,
# device="cpu", n_corrupt=2, off_curve=1, bad_tag=1, oversized=1) wrote
# before its signatures moved onto S1 and S2 (the same nonces, r, s and
# low-S rule: the bytes must not change)
STORE_SHA256 = \
    "ff31710956393ff19fe0628ff30a6108c68067623995241f70dec21c72f2194e"


def test_synth_store_bytes_unchanged(tmp_path):
    path = str(tmp_path / "s.gs")
    synth.make_network_store(path, 24, 8, seed=5, device="cpu", n_corrupt=2,
                             off_curve=1, bad_tag=1, oversized=1)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == STORE_SHA256
