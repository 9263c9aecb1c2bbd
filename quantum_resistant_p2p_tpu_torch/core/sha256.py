"""Batched SHA-256, HMAC-SHA256 and HKDF-SHA256 in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/core/sha256.py``.  Every function
takes ``(..., L)`` uint8 tensors with any leading batch shape and runs where
its input lies: on a CUDA tensor each compression, and each multi-block
absorb, is one launch of kernel K12 (``sha256_cuda``, ``csrc/sha2.cu``); on a
CPU tensor it runs :func:`compress_plain`, the plain PyTorch version that the
tests hold to the JAX functions and ``hashlib``.

State words are int64 tensors holding values in [0, 2^32): PyTorch on the
CPU has no uint32 shift or add.  The plain version masks every sum before
it reaches a shift, and feeds the rotations a 64-bit copy ``x | x << 32``,
so that one right shift and one final mask give each rotate.

A midstate may have fewer leading dims than the data it finishes: a state of
shape ``(B, 1, ..., 1, 8)`` serves every row of its batch entry, which is how
SPHINCS+ resumes its one ``pk_seed`` block under millions of hashes; the
kernel then reads each state once for its rows instead of a copy per row.
"""

from __future__ import annotations

import functools
import math

import torch

from . import sha256_cuda

# Round constants: fractional parts of cube roots of the first 64 primes.
_K = (
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
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

M32 = 0xFFFFFFFF
BLOCK = 64
#: big-endian byte weights of a 32-bit word
_BE4 = (1 << 24, 1 << 16, 1 << 8, 1)


def _block_words(block: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 -> (..., 16) int64 big-endian words."""
    b = block.to(torch.int64).reshape(block.shape[:-1] + (16, 4))
    return (b * torch.tensor(_BE4, dtype=torch.int64, device=b.device)).sum(-1)


def _sigma(x: torch.Tensor, r1: int, r2: int, r3: int, shr: bool = False) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (rotr or shr)(x, r3) of 32-bit words."""
    x2 = x | (x << 32)
    return ((x2 >> r1) ^ (x2 >> r2) ^ ((x if shr else x2) >> r3)) & M32


def compress_plain(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression: state (..., 8) int64 words, block (..., 64)
    uint8 -> (..., 8) int64.  The state's leading dims broadcast against
    the block's."""
    # word-major copies, so that every op below runs on contiguous rows
    w = list(_block_words(block).movedim(-1, 0).contiguous().unbind(0))
    a, b, c, d, e, f, g, h = state.movedim(-1, 0).contiguous().unbind(0)
    bc = b ^ c
    for t in range(64):
        if t >= 16:
            i = t % 16
            s0 = _sigma(w[(t - 15) % 16], 7, 18, 3, shr=True)
            s1 = _sigma(w[(t - 2) % 16], 17, 19, 10, shr=True)
            w[i] = (w[i] + s0 + w[(t - 7) % 16] + s1) & M32
        t1 = h + _sigma(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + (w[t % 16] + _K[t])
        ab = a ^ b
        t2 = _sigma(a, 2, 13, 22) + (b ^ (ab & bc))  # maj(a, b, c)
        a, b, c, d, e, f, g, h = (t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g
        bc = ab
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)) & M32


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression where the tensors lie: K12 on a CUDA tensor,
    :func:`compress_plain` on a CPU tensor."""
    if block.device.type == "cpu":
        return compress_plain(state, block)
    return _absorb(state, block)


def _pad(data: torch.Tensor, prefix_blocks: int = 0) -> torch.Tensor:
    """FIPS 180-4 padding; the bit length counts ``prefix_blocks`` * 512."""
    msg_len = data.shape[-1]
    total_bits = (prefix_blocks * BLOCK + msg_len) * 8
    tail = _tail(data.device, (55 - msg_len) % 64 + 9, total_bits)
    return torch.cat([data, tail.expand(data.shape[:-1] + tail.shape)], dim=-1)


@functools.lru_cache(maxsize=256)
def _tail(device: torch.device, pad_len: int, total_bits: int, width: int = 8) -> torch.Tensor:
    """The padding bytes: 0x80, zeros, then the bit length big-endian in
    ``width`` bytes.  Kept per device and length: a tensor built from Python
    values on a GPU is a copy that waits for the stream."""
    tail = bytes([0x80]) + bytes(pad_len - 1 - width) + total_bits.to_bytes(width, "big")
    return torch.tensor(list(tail), dtype=torch.uint8, device=device)


def state_rows(state: torch.Tensor, lead: tuple[int, ...]) -> tuple[torch.Tensor, int]:
    """A state broadcastable to ``lead`` as ``(S, width)`` rows, and how many
    consecutive data rows each row serves: the trailing dims over which the
    state is broadcast cost no copy, any other broadcast is copied out."""
    state = state.expand(lead + state.shape[-1:])
    k = len(lead)
    while k and (state.stride(k - 1) == 0 or lead[k - 1] == 1):
        k -= 1
    head = state[(slice(None),) * k + (0,) * (len(lead) - k)]
    return head.reshape(-1, state.shape[-1]), math.prod(lead[k:])


def _absorb(state: torch.Tensor, padded: torch.Tensor) -> torch.Tensor:
    """Compress every 64-byte block of ``padded`` into ``state``; on a CUDA
    tensor all blocks go in one K12 launch."""
    lead = tuple(padded.shape[:-1])
    if padded.device.type == "cpu":
        for i in range(padded.shape[-1] // BLOCK):
            state = compress_plain(state, padded[..., i * BLOCK:(i + 1) * BLOCK])
        return state.expand(lead + (8,))
    states, per = state_rows(state, lead)
    out = sha256_cuda.compress(states, padded.reshape(-1, padded.shape[-1]), per)
    return out.reshape(lead + (8,))


def _digest(state: torch.Tensor) -> torch.Tensor:
    """(..., 8) int64 words -> (..., 32) uint8 big-endian: the low four bytes
    of each little-endian int64, in reverse."""
    b = state.contiguous().view(torch.uint8).reshape(state.shape[:-1] + (8, 8))
    return b[..., :4].flip(-1).reshape(state.shape[:-1] + (32,))


@functools.cache
def _h0(device: torch.device) -> torch.Tensor:
    return torch.tensor(_H0, dtype=torch.int64, device=device)


def init_state(batch_shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    return _h0(torch.device(device)).expand(batch_shape + (8,))


def sha256(data: torch.Tensor) -> torch.Tensor:
    """(..., L) uint8 -> (..., 32) uint8."""
    state = init_state(tuple(data.shape[:-1]), data.device)
    return _digest(_absorb(state, _pad(data)))


def sha256_from_midstate(state: torch.Tensor, data: torch.Tensor,
                         prefix_blocks: int) -> torch.Tensor:
    """Finish SHA-256 from a state over ``prefix_blocks`` blocks already
    absorbed; ``state``'s leading dims broadcast against ``data``'s."""
    return _digest(_absorb(state, _pad(data, prefix_blocks)))


def midstate(prefix: torch.Tensor) -> torch.Tensor:
    """State after absorbing a (..., 64k) uint8 prefix (no padding)."""
    if prefix.shape[-1] % BLOCK:
        raise ValueError("midstate prefix must be a multiple of 64 bytes")
    return _absorb(init_state(tuple(prefix.shape[:-1]), prefix.device), prefix)


# --------------------------------------------------------------------------
# HMAC-SHA256 and HKDF (RFC 2104 / RFC 5869), batched
# --------------------------------------------------------------------------


def hmac_sha256(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """key (..., kl) uint8, data (..., L) uint8 -> (..., 32) uint8."""
    if key.shape[-1] > BLOCK:
        key = sha256(key)
    pad_k = torch.zeros(key.shape[:-1] + (BLOCK - key.shape[-1],), dtype=torch.uint8,
                        device=key.device)
    k64 = torch.cat([key, pad_k], dim=-1)
    inner = sha256(torch.cat([k64 ^ 0x36, data], dim=-1))
    return sha256(torch.cat([k64 ^ 0x5C, inner], dim=-1))


def hkdf_sha256(ikm: torch.Tensor, salt: torch.Tensor, info: torch.Tensor,
                length: int = 32) -> torch.Tensor:
    """RFC 5869 extract and expand; length <= 8160."""
    prk = hmac_sha256(salt, ikm)
    okm = []
    t = torch.zeros(ikm.shape[:-1] + (0,), dtype=torch.uint8, device=ikm.device)
    for i in range(1, -(-length // 32) + 1):
        ctr = torch.full(ikm.shape[:-1] + (1,), i, dtype=torch.uint8, device=ikm.device)
        t = hmac_sha256(prk, torch.cat([t, info, ctr], dim=-1))
        okm.append(t)
    return torch.cat(okm, dim=-1)[..., :length]
