"""ChaCha20 and the ChaCha20-Poly1305 AEAD (RFC 8439 sections 2.4 and
2.8): BOLT #8's transport cipher, and the stream of the onion code.

``encrypt`` / ``decrypt`` / ``chacha20_stream`` run the C version in
``native/chachapoly.c``, built with ``cc`` at first use (``utils/native``);
a failed build raises, and nothing falls back to Python.  The ``*_plain``
functions are the same cipher in plain Python, the tests' oracle.
"""
from __future__ import annotations

import ctypes
import struct

from ..utils import native

TAG_LEN = 16


class TagError(ValueError):
    """The Poly1305 tag did not authenticate the ciphertext and AD."""


def _check(key: bytes, nonce: bytes, nonce_len: int) -> None:
    if len(key) != 32:
        raise ValueError("ChaCha20 key must be 32 bytes")
    if len(nonce) != nonce_len:
        raise ValueError(f"nonce must be {nonce_len} bytes")


def encrypt(key: bytes, nonce12: bytes, ad: bytes, pt: bytes) -> bytes:
    """ciphertext || 16-byte tag."""
    _check(key, nonce12, 12)
    out = ctypes.create_string_buffer(len(pt) + TAG_LEN)
    native.get_lib().chachapoly_encrypt(key, nonce12, ad, len(ad), pt,
                                        len(pt), out)
    return out.raw


def decrypt(key: bytes, nonce12: bytes, ad: bytes, ct: bytes) -> bytes:
    """The plaintext of ciphertext || tag; raises TagError on a bad tag."""
    _check(key, nonce12, 12)
    n = len(ct) - TAG_LEN
    if n < 0:
        raise TagError("ciphertext shorter than its tag")
    out = ctypes.create_string_buffer(max(n, 1))
    if native.get_lib().chachapoly_decrypt(key, nonce12, ad, len(ad), ct, n,
                                           out):
        raise TagError("AEAD tag failure")
    return out.raw[:n]


def chacha20_stream(key: bytes, nonce16: bytes, n: int) -> bytes:
    """n bytes of keystream; `nonce16` is the 32-bit little-endian block
    counter and the 96-bit nonce (the 16-byte IV of OpenSSL's ChaCha20)."""
    _check(key, nonce16, 16)
    out = ctypes.create_string_buffer(max(n, 1))
    native.get_lib().chacha20_xor16(key, nonce16, None, out, n)
    return out.raw[:n]


# ---------------------------------------------------------------------------
# The plain-Python version

_M32 = 0xFFFFFFFF
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_P1305 = (1 << 130) - 5


def _rotl(v: int, c: int) -> int:
    return ((v << c) & _M32) | (v >> (32 - c))


def _quarter(x: list, a: int, b: int, c: int, d: int) -> None:
    x[a] = (x[a] + x[b]) & _M32
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & _M32
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & _M32
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & _M32
    x[b] = _rotl(x[b] ^ x[c], 7)


def _block(state: list) -> bytes:
    x = list(state)
    for _ in range(10):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return struct.pack("<16I", *((a + b) & _M32 for a, b in zip(x, state)))


def _stream(key: bytes, iv16: bytes, n: int) -> bytes:
    state = [*_SIGMA, *struct.unpack("<8I", key), *struct.unpack("<4I", iv16)]
    out = bytearray()
    while len(out) < n:
        out += _block(state)
        state[12] = (state[12] + 1) & _M32
        if state[12] == 0:
            state[13] = (state[13] + 1) & _M32
    return bytes(out[:n])


def _xor(a: bytes, b: bytes) -> bytes:
    return (int.from_bytes(a, "little") ^ int.from_bytes(b, "little")
            ).to_bytes(len(a), "little")


def _poly1305(otk: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(otk[:16], "little") \
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(otk[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i:i + 16]
        acc = (acc + int.from_bytes(chunk + b"\x01", "little")) * r % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _tag(key: bytes, nonce12: bytes, ad: bytes, ct: bytes) -> bytes:
    otk = _stream(key, b"\x00" * 4 + nonce12, 32)
    mac_data = (ad + _pad16(ad) + ct + _pad16(ct)
                + struct.pack("<QQ", len(ad), len(ct)))
    return _poly1305(otk, mac_data)


def encrypt_plain(key: bytes, nonce12: bytes, ad: bytes, pt: bytes) -> bytes:
    _check(key, nonce12, 12)
    ct = _xor(pt, _stream(key, b"\x01\x00\x00\x00" + nonce12, len(pt)))
    return ct + _tag(key, nonce12, ad, ct)


def decrypt_plain(key: bytes, nonce12: bytes, ad: bytes, ct: bytes) -> bytes:
    _check(key, nonce12, 12)
    if len(ct) < TAG_LEN:
        raise TagError("ciphertext shorter than its tag")
    body, tag = ct[:-TAG_LEN], ct[-TAG_LEN:]
    if _tag(key, nonce12, ad, body) != tag:
        raise TagError("AEAD tag failure")
    return _xor(body, _stream(key, b"\x01\x00\x00\x00" + nonce12, len(body)))


def chacha20_stream_plain(key: bytes, nonce16: bytes, n: int) -> bytes:
    _check(key, nonce16, 16)
    return _stream(key, nonce16, n)
