"""Build-on-demand loader for the port's native (C) host helpers.

The sources are the port's own copies under ``native/``; they are built
with ``cc`` at first use into the package's ``_build/`` directory (listed
in .gitignore) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_ROOT, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libgossip_native.so")
_SOURCES = ["crc32c.c", "gossip_native.c", "chachapoly.c"]
_lock = threading.Lock()
_lib = None


def _build() -> str:
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    newest = max(os.path.getmtime(s) for s in srcs)
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < newest:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", tmp, *srcs],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            vp = ctypes.c_void_p
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                   ctypes.c_size_t]
            lib.crc32c_batch.restype = None
            lib.crc32c_batch.argtypes = [vp, vp, vp, vp, vp, ctypes.c_size_t]
            lib.gossip_store_scan.restype = ctypes.c_int64
            lib.gossip_store_scan.argtypes = [
                vp, ctypes.c_uint64, ctypes.c_uint64, vp, vp, vp, vp, vp, vp]
            lib.sha256_pack.restype = ctypes.c_int64
            lib.sha256_pack.argtypes = [vp, vp, vp, ctypes.c_size_t, vp,
                                        ctypes.c_uint64, vp]
            lib.gather_fields.restype = None
            lib.gather_fields.argtypes = [vp, vp, ctypes.c_size_t,
                                          ctypes.c_uint64, ctypes.c_uint32, vp]
            cp, sz = ctypes.c_char_p, ctypes.c_size_t
            lib.chacha20_xor16.restype = None
            lib.chacha20_xor16.argtypes = [cp, cp, cp, vp, sz]
            lib.chachapoly_encrypt.restype = None
            lib.chachapoly_encrypt.argtypes = [cp, cp, cp, sz, cp, sz, vp]
            lib.chachapoly_decrypt.restype = ctypes.c_int
            lib.chachapoly_decrypt.argtypes = [cp, cp, cp, sz, cp, sz, vp]
            _lib = lib
    return _lib


def crc32c(seed: int, data: bytes) -> int:
    return get_lib().crc32c(seed & 0xFFFFFFFF, data, len(data))


def crc32c_batch(buf: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                 seeds: np.ndarray) -> np.ndarray:
    """crc32c over records inside one contiguous uint8 buffer."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lengths = np.ascontiguousarray(lengths, dtype=np.uint32)
    seeds = np.ascontiguousarray(seeds, dtype=np.uint32)
    out = np.empty(len(offsets), dtype=np.uint32)
    get_lib().crc32c_batch(buf.ctypes.data, offsets.ctypes.data,
                           lengths.ctypes.data, seeds.ctypes.data,
                           out.ctypes.data, len(offsets))
    return out


def gossip_store_scan(buf: np.ndarray, start_off: int = 1) -> dict:
    """Scan store records into flat arrays (offsets point at each
    message body; lengths exclude the 12-byte header)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    cap = max(1, (len(buf) - start_off) // 12 + 1)
    arrays = {"offsets": np.empty(cap, np.uint64),
              "lengths": np.empty(cap, np.uint32),
              "flags": np.empty(cap, np.uint16),
              "timestamps": np.empty(cap, np.uint32),
              "crcs": np.empty(cap, np.uint32),
              "types": np.empty(cap, np.uint16)}
    n = get_lib().gossip_store_scan(
        buf.ctypes.data, len(buf), start_off,
        *(a.ctypes.data for a in arrays.values()))
    if n < 0:
        raise ValueError("truncated gossip store")
    return {k: a[:n] for k, a in arrays.items()}


def sha256_pack(buf: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                max_blocks: int):
    """Pack signed regions into pre-padded SHA-256 rows: (rows (n,
    max_blocks*64) uint8, n_blocks (n,) uint32).  Regions that do not fit
    get n_blocks == 0 and a zeroed row; the caller hashes them on the
    host."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lengths = np.ascontiguousarray(lengths, dtype=np.uint32)
    n = len(offsets)
    out = np.empty((n, max_blocks * 64), np.uint8)
    n_blocks = np.empty(n, np.uint32)
    get_lib().sha256_pack(buf.ctypes.data, offsets.ctypes.data,
                          lengths.ctypes.data, n, out.ctypes.data,
                          max_blocks * 64, n_blocks.ctypes.data)
    return out, n_blocks


def gather_fields(buf: np.ndarray, offsets: np.ndarray, field_off: int,
                  field_len: int) -> np.ndarray:
    """out[i] = buf[offsets[i] + field_off : + field_len], (n, field_len)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    out = np.empty((len(offsets), field_len), np.uint8)
    get_lib().gather_fields(buf.ctypes.data, offsets.ctypes.data,
                            len(offsets), field_off, field_len,
                            out.ctypes.data)
    return out
