"""Batched SHA-512 in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/core/sha512.py``, which holds each
64-bit word as a (hi, lo) uint32 pair.  Here a word is one int64 tensor
element with the word's bit pattern.  Additions rely on int64 wrapping
modulo 2^64 (the tests pin it against ``hashlib`` with carries across bits
31 and 63); right shifts of int64 are arithmetic, so every one is masked
back to the bits a logical shift keeps.

On a CUDA tensor each compression, and each multi-block absorb, is one
launch of kernel K13 (``sha512_cuda``, ``csrc/sha2.cu``); on a CPU tensor it
runs :func:`compress_plain`.  A midstate broadcasts over the data's leading
dims as in ``core.sha256``.
"""

from __future__ import annotations

import functools

import torch

from . import sha512_cuda
from .sha256 import _tail, state_rows


def _signed(x: int) -> int:
    """A 64-bit word as the int64 with its bit pattern."""
    return x - (1 << 64) if x >> 63 else x


_K64 = (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
)
_K = tuple(_signed(k) for k in _K64)

_H64 = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
_H0 = tuple(_signed(h) for h in _H64)

BLOCK = 128


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def _block_words(block: torch.Tensor) -> torch.Tensor:
    """(..., 128) uint8 -> (..., 16) int64 big-endian words (bit patterns)."""
    b = block.to(torch.int64).reshape(block.shape[:-1] + (16, 8))
    w = b[..., 0]
    for j in range(1, 8):
        w = (w << 8) | b[..., j]
    return w


def compress_plain(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-512 compression: state (..., 8) int64 words, block (..., 128)
    uint8 -> (..., 8) int64.  The state's leading dims broadcast against
    the block's."""
    # word-major copies, so that every op below runs on contiguous rows
    w = list(_block_words(block).movedim(-1, 0).contiguous().unbind(0))
    a, b, c, d, e, f, g, h = state.movedim(-1, 0).contiguous().unbind(0)
    bc = b ^ c
    for t in range(80):
        if t >= 16:
            i = t % 16
            x15, x2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = _rotr(x15, 1) ^ _rotr(x15, 8) ^ _shr(x15, 7)
            s1 = _rotr(x2, 19) ^ _rotr(x2, 61) ^ _shr(x2, 6)
            w[i] = w[i] + s0 + w[(t - 7) % 16] + s1
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        t1 = h + s1 + (g ^ (e & (f ^ g))) + (w[t % 16] + _K[t])
        ab = a ^ b
        t2 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        t2 = t2 + (b ^ (ab & bc))  # maj(a, b, c)
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
        bc = ab
    return state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-512 compression where the tensors lie: K13 on a CUDA tensor,
    :func:`compress_plain` on a CPU tensor."""
    if block.device.type == "cpu":
        return compress_plain(state, block)
    return _absorb(state, block)


def _pad(data: torch.Tensor, prefix_blocks: int = 0) -> torch.Tensor:
    msg_len = data.shape[-1]
    total_bits = (prefix_blocks * BLOCK + msg_len) * 8
    tail = _tail(data.device, (111 - msg_len) % 128 + 17, total_bits, 16)
    return torch.cat([data, tail.expand(data.shape[:-1] + tail.shape)], dim=-1)


def _absorb(state: torch.Tensor, padded: torch.Tensor) -> torch.Tensor:
    """Compress every 128-byte block of ``padded`` into ``state``; on a CUDA
    tensor all blocks go in one K13 launch."""
    lead = tuple(padded.shape[:-1])
    if padded.device.type == "cpu":
        for i in range(padded.shape[-1] // BLOCK):
            state = compress_plain(state, padded[..., i * BLOCK:(i + 1) * BLOCK])
        return state.expand(lead + (8,))
    states, per = state_rows(state, lead)
    out = sha512_cuda.compress(states, padded.reshape(-1, padded.shape[-1]), per)
    return out.reshape(lead + (8,))


def _digest(state: torch.Tensor) -> torch.Tensor:
    """(..., 8) int64 words -> (..., 64) uint8 big-endian: the bytes of each
    little-endian int64, in reverse."""
    b = state.contiguous().view(torch.uint8).reshape(state.shape[:-1] + (8, 8))
    return b.flip(-1).reshape(state.shape[:-1] + (64,))


@functools.cache
def _h0(device: torch.device) -> torch.Tensor:
    return torch.tensor(_H0, dtype=torch.int64, device=device)


def init_state(batch_shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    return _h0(torch.device(device)).expand(batch_shape + (8,))


def sha512(data: torch.Tensor) -> torch.Tensor:
    """(..., L) uint8 -> (..., 64) uint8."""
    state = init_state(tuple(data.shape[:-1]), data.device)
    return _digest(_absorb(state, _pad(data)))


def midstate(prefix: torch.Tensor) -> torch.Tensor:
    """State after absorbing a (..., 128k) uint8 prefix (no padding)."""
    if prefix.shape[-1] % BLOCK:
        raise ValueError("midstate prefix must be a multiple of 128 bytes")
    return _absorb(init_state(tuple(prefix.shape[:-1]), prefix.device), prefix)


def sha512_from_midstate(state: torch.Tensor, data: torch.Tensor,
                         prefix_blocks: int) -> torch.Tensor:
    return _digest(_absorb(state, _pad(data, prefix_blocks)))
