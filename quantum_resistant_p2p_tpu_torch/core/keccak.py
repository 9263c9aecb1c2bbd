"""Batched Keccak-f[1600] and the SHA-3 / SHAKE sponges in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/core/keccak.py``.  Every function
takes ``(..., L)`` uint8 tensors with any leading batch shape and runs where
its input lies: on a CUDA tensor every sponge, whatever its length, is one
launch of kernel K1 (``keccak_cuda.sponge``, ``csrc/sponge.cu``); on a CPU
tensor it runs :func:`sponge_plain`, the plain PyTorch version that the
tests hold to the JAX functions and ``hashlib``.

The plain version keeps each 64-bit lane in an int64 tensor.  PyTorch has
no unsigned 64-bit shifts on the CPU and ``int64 >>`` sign-extends, so every
right shift is masked back to the bits a logical shift would keep.
"""

from __future__ import annotations

import math

import torch

from . import keccak_cuda

# Flat lane index l = x + 5*y (x = column, y = row), as in the reference.


def _rho_offsets() -> list[int]:
    r = [0] * 25
    x, y = 1, 0
    for t in range(24):
        r[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return r


def _pi_source() -> list[int]:
    """src[dst] such that after rho+pi, out[dst] = rot(in[src], RHO[src])."""
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return src


def _round_constants() -> list[int]:
    """The 24 iota constants as signed int64 values."""

    def rc_bit(t: int) -> int:
        if t % 255 == 0:
            return 1
        reg = 1
        for _ in range(t % 255):
            reg <<= 1
            if reg & 0x100:
                reg ^= 0x171
        return reg & 1

    out = []
    for ir in range(24):
        rc = 0
        for j in range(7):
            if rc_bit(j + 7 * ir):
                rc |= 1 << (2**j - 1)
        out.append(rc - (1 << 64) if rc >> 63 else rc)
    return out


RHO = _rho_offsets()
PI_SRC = _pi_source()
RC = _round_constants()


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on ``(..., 25)`` int64 lanes (the bits of uint64)."""
    dev = state.device
    src = torch.tensor(PI_SRC, device=dev)
    rot = torch.tensor([RHO[s] for s in PI_SRC], dtype=torch.int64, device=dev)
    back = (64 - rot) % 64  # the right shift of each rotation; 0 where rot == 0
    keep = torch.tensor([(1 << r) - 1 for r in (RHO[s] for s in PI_SRC)],
                        dtype=torch.int64, device=dev)
    rc = torch.tensor(RC, dtype=torch.int64, device=dev)
    shape = state.shape
    s = state.reshape(-1, 5, 5)  # [b, y, x]
    for r in range(24):
        # theta
        c = s[:, 0] ^ s[:, 1] ^ s[:, 2] ^ s[:, 3] ^ s[:, 4]
        cn = torch.roll(c, -1, dims=-1)  # C[x+1]
        d = torch.roll(c, 1, dims=-1) ^ ((cn << 1) | ((cn >> 63) & 1))
        s = s ^ d[:, None, :]
        # rho + pi
        b = s.reshape(-1, 25)[:, src]
        b = (b << rot) | ((b >> back) & keep)
        b = b.reshape(-1, 5, 5)
        # chi
        s = b ^ (~torch.roll(b, -1, dims=-1) & torch.roll(b, -2, dims=-1))
        # iota
        s = s.reshape(-1, 25)
        s = torch.cat([s[:, :1] ^ rc[r], s[:, 1:]], dim=1).reshape(-1, 5, 5)
    return s.reshape(shape)


def pad_message(data: torch.Tensor, rate: int, ds_byte: int) -> torch.Tensor:
    """``(..., L)`` uint8 -> ``(..., (L // rate + 1) * rate)`` padded blocks:
    the message, the domain byte, zeros, and 0x80 in the last byte."""
    msg_len = data.shape[-1]
    padded_len = (msg_len // rate + 1) * rate
    out = torch.zeros(data.shape[:-1] + (padded_len,), dtype=torch.uint8,
                      device=data.device)
    out[..., :msg_len] = data
    out[..., msg_len] = ds_byte
    out[..., padded_len - 1] |= 0x80
    return out


def sponge_plain(data: torch.Tensor, rate: int, ds_byte: int, out_len: int) -> torch.Tensor:
    """The plain PyTorch sponge: ``(..., L)`` uint8 -> ``(..., out_len)``."""
    batch = data.shape[:-1]
    nwords = rate // 8
    padded = pad_message(data.reshape(math.prod(batch), data.shape[-1]), rate, ds_byte)
    blocks = padded.view(torch.int64).reshape(padded.shape[0], -1, nwords)
    state = torch.zeros((padded.shape[0], 25), dtype=torch.int64, device=data.device)
    for blk in range(blocks.shape[1]):
        state = torch.cat([state[:, :nwords] ^ blocks[:, blk], state[:, nwords:]], dim=1)
        state = keccak_f1600(state)
    out = []
    for blk in range(-(-out_len // rate)):
        if blk:
            state = keccak_f1600(state)
        out.append(state[:, :nwords].contiguous().view(torch.uint8))
    return torch.cat(out, dim=1)[:, :out_len].reshape(batch + (out_len,))


def sponge(data: torch.Tensor, rate: int, ds_byte: int, out_len: int) -> torch.Tensor:
    """Keccak sponge over ``(..., L)`` uint8 rows -> ``(..., out_len)`` uint8.

    rate in bytes: 168 SHAKE128, 136 SHAKE256/SHA3-256, 72 SHA3-512;
    ds_byte 0x1F for SHAKE, 0x06 for SHA3.  CPU tensors take the plain
    version; any other device goes to kernel K1, which raises unless the
    tensor is on a CUDA device.
    """
    if data.device.type == "cpu":
        return sponge_plain(data, rate, ds_byte, out_len)
    return keccak_cuda.sponge(data, rate, ds_byte, out_len)


def sponge_varlen_plain(data: torch.Tensor, lengths: torch.Tensor, rate: int, ds_byte: int,
                        out_len: int) -> torch.Tensor:
    """The plain varlen sponge: ``(..., LMAX)`` uint8 rows whose true byte
    lengths are ``lengths`` (``(...,)``, each in [0, LMAX]) -> ``(..., out_len)``.

    Bytes at index >= the row's length are ignored (masked to zero), the
    domain byte lands at the length and 0x80 at the end of the block that
    holds it (one byte when length % rate == rate - 1: the bits are
    disjoint, so xor is the spec's or).  The absorb runs over
    ``LMAX // rate + 1`` blocks, and a row keeps its state once its
    message has ended."""
    batch = data.shape[:-1]
    lmax = data.shape[-1]
    n = math.prod(batch)
    nwords = rate // 8
    nblocks = lmax // rate + 1
    padded_len = nblocks * rate
    dev = data.device
    mlen = lengths.to(torch.int64).expand(batch).reshape(n, 1)
    idx = torch.arange(padded_len, device=dev)
    buf = torch.zeros((n, padded_len), dtype=torch.uint8, device=dev)
    buf[:, :lmax] = data.reshape(n, lmax)
    buf = torch.where(idx < mlen, buf, 0)
    buf = buf ^ torch.where(idx == mlen, ds_byte, 0).to(torch.uint8)
    last_block = mlen // rate
    buf = buf ^ torch.where(idx == (last_block + 1) * rate - 1, 0x80, 0).to(torch.uint8)
    blocks = buf.view(torch.int64).reshape(n, nblocks, nwords)
    state = torch.zeros((n, 25), dtype=torch.int64, device=dev)
    for blk in range(nblocks):
        nxt = keccak_f1600(torch.cat([state[:, :nwords] ^ blocks[:, blk], state[:, nwords:]],
                                     dim=1))
        state = torch.where(blk <= last_block, nxt, state)
    out = []
    for blk in range(-(-out_len // rate)):
        if blk:
            state = keccak_f1600(state)
        out.append(state[:, :nwords].contiguous().view(torch.uint8))
    return torch.cat(out, dim=1)[:, :out_len].reshape(batch + (out_len,))


def sponge_varlen(data: torch.Tensor, lengths: torch.Tensor, rate: int, ds_byte: int,
                  out_len: int) -> torch.Tensor:
    """Keccak sponge over per-row variable-length messages: ``(..., LMAX)``
    uint8 rows, ``(...,)`` true lengths in [0, LMAX] -> ``(..., out_len)``
    uint8 (see :func:`sponge_varlen_plain`).  CPU tensors take the plain
    version; any other device goes to kernel K1's per-row-length entry."""
    if data.device.type == "cpu":
        return sponge_varlen_plain(data, lengths, rate, ds_byte, out_len)
    return keccak_cuda.sponge_varlen(data, lengths, rate, ds_byte, out_len)


def shake256_varlen(data: torch.Tensor, lengths: torch.Tensor, out_len: int) -> torch.Tensor:
    """(..., LMAX) uint8 + (...,) true lengths -> (..., out_len) uint8."""
    return sponge_varlen(data, lengths, 136, 0x1F, out_len)


def seed_rows(seeds: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Flatten ``(..., L)`` XOF/PRF seeds to contiguous ``(B, L)`` rows plus
    the batch shape: the input convention of the sampler kernels, which
    absorb and pad each row themselves (the counterpart of the reference's
    ``seed_block_words``, which pre-padded and word-transposed for the
    TPU)."""
    batch = tuple(seeds.shape[:-1])
    return seeds.reshape(math.prod(batch), seeds.shape[-1]).contiguous(), batch


def compact_accepted(cand: torch.Tensor, accepted: torch.Tensor) -> torch.Tensor:
    """The first 256 of ``cand`` (..., C) in order of (accepted first, then
    index): a rejection sampler's accepted candidates in order and, if
    fewer than 256 passed, the rejected ones in order.  This is the order
    of the reference's sort keys (reject bit above the index), and the
    order in which the sampler kernels append."""
    order = torch.argsort((~accepted).to(torch.int8), dim=-1, stable=True)
    return cand.gather(-1, order[..., :256])


def shake128(data: torch.Tensor, out_len: int) -> torch.Tensor:
    return sponge(data, 168, 0x1F, out_len)


def shake256(data: torch.Tensor, out_len: int) -> torch.Tensor:
    return sponge(data, 136, 0x1F, out_len)


def sha3_256(data: torch.Tensor) -> torch.Tensor:
    return sponge(data, 136, 0x06, 32)


def sha3_512(data: torch.Tensor) -> torch.Tensor:
    return sponge(data, 72, 0x06, 64)
