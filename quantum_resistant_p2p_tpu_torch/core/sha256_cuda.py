"""Kernel K12: the batched SHA-256 compression on the GPU (``csrc/sha2.cu``).

Replaces ``quantum_resistant_p2p_tpu/core/sha256_pallas.py:compress_words``.
:func:`compress` takes the row-major tensors of ``core.sha256``: ``(S, 8)``
int64 state words (values in [0, 2^32)) and ``(N, 64k)`` uint8 rows of k
message blocks, ``N = S * rows_per_state``, on one CUDA device.  One thread
compresses the k blocks of one row, in order, from the state of its group
of ``rows_per_state`` consecutive rows, and writes ``(N, 8)`` int64 words.
With k = 1 it is ``core.sha256.compress``; its plain version is
``core.sha256.compress_plain`` (block by block for k > 1, as
``core.sha256._absorb`` runs it on the CPU).  Any other tensor raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda

_P = ctypes.c_void_p
#: both entry points of the library, so whichever wrapper loads it first
#: declares the other's too
SIGNATURES = {
    # state, blocks, out, n_rows, rows_per_state, n_blocks, stream
    "qrp_sha256_compress": [_P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _P],
    "qrp_sha512_compress": [_P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _P],
}


def launch(fn: str, block_bytes: int, states: torch.Tensor, blocks: torch.Tensor,
           rows_per_state: int, what: str) -> torch.Tensor:
    """Shared launch of K12 / K13: check the operands, launch ``fn``, raise
    on a CUDA error; -> (N, 8) int64."""
    states = cuda.expect_cuda(states, torch.int64, f"{what} state")
    blocks = cuda.expect_cuda(blocks, torch.uint8, f"{what} blocks")
    if states.dim() != 2 or states.shape[1] != 8:
        raise ValueError(f"{what}: state must be (S, 8), got {tuple(states.shape)}")
    if blocks.dim() != 2 or blocks.shape[1] == 0 or blocks.shape[1] % block_bytes:
        raise ValueError(f"{what}: blocks must be (N, {block_bytes}k), k >= 1, "
                         f"got {tuple(blocks.shape)}")
    if rows_per_state < 1 or blocks.shape[0] != states.shape[0] * rows_per_state:
        raise ValueError(f"{what}: {blocks.shape[0]} rows for {states.shape[0]} states of "
                         f"{rows_per_state} rows each")
    if blocks.device != states.device:
        raise ValueError(f"{what}: blocks on {blocks.device}, state on {states.device}")
    if blocks.data_ptr() % 16:  # the kernel reads blocks as 16-byte vectors
        blocks = blocks.clone()
    out = torch.empty((blocks.shape[0], 8), dtype=torch.int64, device=blocks.device)
    if blocks.shape[0]:
        lib = cuda.library("sha2", SIGNATURES)
        with torch.cuda.device(blocks.device):
            err = getattr(lib, fn)(states.data_ptr(), blocks.data_ptr(), out.data_ptr(),
                                   blocks.shape[0], rows_per_state,
                                   blocks.shape[1] // block_bytes, cuda.stream_of(blocks))
        cuda.check(lib, err, f"{what} launch")
    return out


def compress(states: torch.Tensor, blocks: torch.Tensor, rows_per_state: int = 1) -> torch.Tensor:
    """K12: ``(S, 8)`` int64 and ``(S * rows_per_state, 64k)`` uint8 on a CUDA
    device -> ``(S * rows_per_state, 8)`` int64."""
    out = launch("qrp_sha256_compress", 64, states, blocks, rows_per_state, "sha256 compress")
    if blocks.shape[0]:
        compress.launches += 1
    return out


compress.launches = 0
