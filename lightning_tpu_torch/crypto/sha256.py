"""Batched SHA-256 / SHA-256d in plain PyTorch.

A batch of B messages is packed on the host into (B, max_blocks, 16)
big-endian words with the SHA-256 padding applied (``pack_messages``,
or the native ``sha256_pack`` for store rows); the device runs the
compression function over the block axis with a per-message active-block
mask.  Words live in int64 and are masked to 32 bits after every add:
torch lacks shifts and rotates on uint32 for most devices.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2]

_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state: list, block: torch.Tensor) -> list:
    """One compression.  state: 8 tensors (...,); block: (..., 16)."""
    w = [block[..., i] for i in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g & M32)
        t1 = h + s1 + ch + _K[t] + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & M32
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _iv(shape, device) -> list:
    return [torch.full(shape, v, dtype=torch.int64, device=device)
            for v in _IV]


def sha256_blocks(blocks: torch.Tensor, n_blocks: torch.Tensor):
    """blocks: (B, max_blocks, 16) int64 words (padding included);
    n_blocks: (B,) active block counts.  Returns (B, 8) int64 digests."""
    state = _iv(blocks.shape[:-2], blocks.device)
    for i in range(blocks.shape[-2]):
        new = _compress(state, blocks[..., i, :])
        active = i < n_blocks
        state = [torch.where(active, n, s) for n, s in zip(new, state)]
    return torch.stack(state, dim=-1)


def sha256_fixed(words: torch.Tensor):
    """SHA-256 where every message has the same static block count."""
    state = _iv(words.shape[:-2], words.device)
    for i in range(words.shape[-2]):
        state = _compress(state, words[..., i, :])
    return torch.stack(state, dim=-1)


def _digest_to_block(digest: torch.Tensor) -> torch.Tensor:
    """Pad a 32-byte digest (8 words) into one SHA-256 block."""
    pad = torch.tensor([0x80000000, 0, 0, 0, 0, 0, 0, 256],
                       dtype=torch.int64, device=digest.device)
    pad = pad.expand(*digest.shape[:-1], 8)
    return torch.cat([digest, pad], dim=-1)[..., None, :]


def sha256d_blocks(blocks: torch.Tensor, n_blocks: torch.Tensor):
    """Batched double SHA-256: the gossip signed hash."""
    return sha256_fixed(_digest_to_block(sha256_blocks(blocks, n_blocks)))


def digest_words_to_limbs(digest: torch.Tensor) -> torch.Tensor:
    """(..., 8) big-endian digest words -> (..., 20) canonical radix-2^13
    limbs of the big-endian 256-bit integer."""
    out = []
    for k in range(20):
        t0 = 13 * k
        wi = 7 - t0 // 32
        sh = t0 % 32
        v = digest[..., wi] >> sh
        if sh + 13 > 32 and wi >= 1:
            v = v | (digest[..., wi - 1] << (32 - sh))
        out.append(v & 0x1FFF)
    return torch.stack(out, dim=-1)


def digest_to_bytes(digest) -> np.ndarray:
    """(..., 8) digest words -> host (..., 32) uint8 big-endian."""
    if isinstance(digest, torch.Tensor):
        digest = digest.detach().cpu().numpy()
    digest = np.asarray(digest, dtype=np.int64)
    b = np.stack([(digest >> s) & 0xFF for s in (24, 16, 8, 0)], axis=-1)
    return b.astype(np.uint8).reshape(*digest.shape[:-1], 32)


def bytes_to_words(rows: np.ndarray, max_blocks: int,
                   out: np.ndarray | None = None) -> np.ndarray:
    """The first max_blocks 64-byte blocks of (B, k*64) uint8 rows ->
    (B, max_blocks, 16) int64 big-endian words, written into `out` when
    it is given."""
    B = rows.shape[0]
    w = rows.reshape(B, -1, 16, 4)[:, :max_blocks]
    if out is None:
        out = np.empty((B, max_blocks, 16), np.int64)
    np.left_shift(w[..., 0], 24, out=out, dtype=np.int64)
    out |= np.left_shift(w[..., 1], 16, dtype=np.int64)
    out |= np.left_shift(w[..., 2], 8, dtype=np.int64)
    out |= w[..., 3]
    return out


def pack_messages(msgs: list[bytes], max_blocks: int | None = None):
    """Pack variable-length messages with SHA-256 padding.
    Returns (blocks (B, max_blocks, 16) int64, n_blocks (B,) int32)."""
    padded, counts = [], []
    for m in msgs:
        bitlen = len(m) * 8
        m = m + b"\x80"
        m = m + b"\x00" * ((56 - len(m)) % 64)
        m = m + bitlen.to_bytes(8, "big")
        padded.append(m)
        counts.append(len(m) // 64)
    nb = max_blocks or max(counts)
    assert nb >= max(counts), "message exceeds max_blocks"
    out = np.zeros((len(msgs), nb * 64), dtype=np.uint8)
    for i, m in enumerate(padded):
        out[i, :len(m)] = np.frombuffer(m, np.uint8)
    return bytes_to_words(out, nb), np.array(counts, dtype=np.int32)
