"""Kernel K13: the batched SHA-512 compression on the GPU (``csrc/sha2.cu``).

Replaces ``quantum_resistant_p2p_tpu/core/sha512_pallas.py:compress_words``.
The same contract as K12 (``core.sha256_cuda``) with 128-byte blocks and
int64 words holding the 64-bit bit patterns: ``(S, 8)`` int64 states and
``(S * rows_per_state, 128k)`` uint8 rows on one CUDA device ->
``(N, 8)`` int64.  Its plain version is ``core.sha512.compress_plain``.
Any other tensor raises.
"""

from __future__ import annotations

import torch

from .sha256_cuda import launch


def compress(states: torch.Tensor, blocks: torch.Tensor, rows_per_state: int = 1) -> torch.Tensor:
    """K13: ``(S, 8)`` int64 and ``(S * rows_per_state, 128k)`` uint8 on a
    CUDA device -> ``(S * rows_per_state, 8)`` int64."""
    out = launch("qrp_sha512_compress", 128, states, blocks, rows_per_state, "sha512 compress")
    if blocks.shape[0]:
        compress.launches += 1
    return out


compress.launches = 0
