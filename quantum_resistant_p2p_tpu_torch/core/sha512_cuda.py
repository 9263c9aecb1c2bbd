"""Kernel K13: the batched SHA-512 compression on the GPU (``csrc/sha2.cu``).

Replaces ``quantum_resistant_p2p_tpu/core/sha512_pallas.py:compress_words``.
The same contract as K12 (``core.sha256_cuda``) with 128-byte blocks and
int64 words holding the 64-bit bit patterns: ``(S, 8)`` int64 states and
``(S * rows_per_state, 128k)`` uint8 rows on one CUDA device ->
``(N, 8)`` int64, by the same two paths under the same rule.  Its plain
version is ``core.sha512.compress_plain``.  Any other tensor raises.
"""

from __future__ import annotations

import torch

from . import sha256_cuda


def compress(states: torch.Tensor, blocks: torch.Tensor, rows_per_state: int = 1) -> torch.Tensor:
    """K13: ``(S, 8)`` int64 and ``(S * rows_per_state, 128k)`` uint8 on a
    CUDA device -> ``(S * rows_per_state, 8)`` int64, by K12's path rule
    (``sha256_cuda.split_rule``: one crossover, measured for both)."""
    out, path = sha256_cuda.launch(128, states, blocks, rows_per_state)
    sha256_cuda.count(compress, blocks.shape[0], path)
    return out


compress.launches = 0
#: the launches of ``launches`` that took the few-row path
compress.split_launches = 0
