"""Kernel K12: the batched SHA-256 compression on the GPU (``csrc/sha2.cu``).

Replaces ``quantum_resistant_p2p_tpu/core/sha256_pallas.py:compress_words``.
:func:`compress` takes the row-major tensors of ``core.sha256``: ``(S, 8)``
int64 state words (values in [0, 2^32)) and ``(N, 64k)`` uint8 rows of k
message blocks, ``N = S * rows_per_state``, on one CUDA device.  Each row's
k blocks are compressed, in order, from the state of its group of
``rows_per_state`` consecutive rows, into ``(N, 8)`` int64 words.  With
k = 1 it is ``core.sha256.compress``; its plain version is
``core.sha256.compress_plain`` (block by block for k > 1, as
``core.sha256._absorb`` runs it on the CPU).  Any other tensor raises.

A launch takes one of two paths (``csrc/sha2.cu``), by :func:`split_rule`:
the rows path, one thread a row, or, for rows of several blocks too few to
fill the card (SPHINCS+ T_l), the few-row path, where a schedule warp feeds
each group of 32 rows' round warp through shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda

_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P]
#: both entry points of the library, so whichever wrapper loads it first
#: declares the other's too: state, blocks, out, n_rows, rows_per_state,
#: n_blocks, path (0 rows, 1 few-row), stream
SIGNATURES = {"qrp_sha256_compress": _ARGS, "qrp_sha512_compress": _ARGS}
#: K12's and K13's entry point and name, by block bytes
ENTRIES = {64: ("qrp_sha256_compress", "sha256 compress"),
           128: ("qrp_sha512_compress", "sha512 compress")}
PATHS = ("rows", "split")
#: K12 and K13 take the few-row path below this many rows an SM (rows of
#: two blocks or more).  Measured on the H100 (132 SMs) at 2, 3, 4 and 10
#: blocks a row: the few-row path is the faster of the two at 8,192 rows
#: (62 an SM) and below, at every block count, by 8-46%; at 12,288 (93 an
#: SM) the rows path wins at 2 blocks and K12's at 3 and 4.
SPLIT_ROWS_PER_SM = 64


def split_rule(rows: int, blocks: int, sms: int) -> bool:
    """Whether a launch of ``rows`` rows of ``blocks`` blocks each takes the
    few-row path on a card of ``sms`` SMs: rows of more than one block, and
    fewer than SPLIT_ROWS_PER_SM of them an SM.  (With one block a row the
    schedule warp has no block to run ahead on.)"""
    return blocks > 1 and rows < SPLIT_ROWS_PER_SM * sms


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(block_bytes: int, states: torch.Tensor, blocks: torch.Tensor,
           rows_per_state: int = 1, path: str | None = None) -> tuple[torch.Tensor, str]:
    """Shared launch of K12 (64-byte blocks) / K13 (128): check the
    operands, pick the path (by :func:`split_rule` unless ``path`` names
    one, as tests and timing do), launch, raise on a CUDA error; -> ((N, 8)
    int64, the path taken).  Counts nothing: :func:`compress` does."""
    fn, what = ENTRIES[block_bytes]
    if path is not None and path not in PATHS:
        raise ValueError(f"{what}: path must be one of {PATHS} or None, got {path!r}")
    if states.dim() != 2 or states.shape[1] != 8:
        raise ValueError(f"{what}: state must be (S, 8), got {tuple(states.shape)}")
    if blocks.dim() != 2 or blocks.shape[1] == 0 or blocks.shape[1] % block_bytes:
        raise ValueError(f"{what}: blocks must be (N, {block_bytes}k), k >= 1, "
                         f"got {tuple(blocks.shape)}")
    if rows_per_state < 1 or blocks.shape[0] != states.shape[0] * rows_per_state:
        raise ValueError(f"{what}: {blocks.shape[0]} rows for {states.shape[0]} states of "
                         f"{rows_per_state} rows each")
    states = cuda.expect_cuda(states, torch.int64, f"{what} state")
    blocks = cuda.expect_cuda(blocks, torch.uint8, f"{what} blocks")
    if blocks.device != states.device:
        raise ValueError(f"{what}: blocks on {blocks.device}, state on {states.device}")
    if blocks.data_ptr() % 16:  # the kernels read blocks as 16-byte vectors
        blocks = blocks.clone()
    out = torch.empty((blocks.shape[0], 8), dtype=torch.int64, device=blocks.device)
    rows, n_blocks = blocks.shape[0], blocks.shape[1] // block_bytes
    if path is None:  # one-block launches (most of SPHINCS+) never ask for the SM count
        split = n_blocks > 1 and split_rule(rows, n_blocks, _sm_count(blocks.device))
        path = PATHS[split]
    if rows:
        lib = cuda.library("sha2", SIGNATURES)
        with torch.cuda.device(blocks.device):
            err = getattr(lib, fn)(states.data_ptr(), blocks.data_ptr(), out.data_ptr(), rows,
                                   rows_per_state, n_blocks, PATHS.index(path),
                                   cuda.stream_of(blocks))
        cuda.check(lib, err, f"{what} launch")
    return out, path


def count(wrapper, rows: int, path: str) -> None:
    """One launch of ``wrapper`` (none for 0 rows), and one of its path."""
    if rows:
        cuda.count_launch(wrapper)
        if path == "split":
            cuda.count_launch(wrapper, "split_launches")


def compress(states: torch.Tensor, blocks: torch.Tensor, rows_per_state: int = 1) -> torch.Tensor:
    """K12: ``(S, 8)`` int64 and ``(S * rows_per_state, 64k)`` uint8 on a CUDA
    device -> ``(S * rows_per_state, 8)`` int64, by :func:`split_rule`'s path."""
    out, path = launch(64, states, blocks, rows_per_state)
    count(compress, blocks.shape[0], path)
    return out


compress.launches = 0
#: the launches of ``launches`` that took the few-row path
compress.split_launches = 0
