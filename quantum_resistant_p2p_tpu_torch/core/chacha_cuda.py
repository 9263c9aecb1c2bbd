"""Kernel K8: the batched ChaCha20 block function on the GPU (``csrc/chacha.cu``).

Replaces ``quantum_resistant_p2p_tpu/core/chacha_pallas.py:chacha_blocks``.
The wrapper takes what :func:`core.chacha.chacha_blocks` takes, ``(N, 12)``
int32 block inputs (8 key words, the counter, 3 nonce words, each the bits
of a uint32) on a CUDA device, and launches one thread per block; it raises
for any other tensor.  Its plain version is ``core.chacha.chacha_blocks_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda

_SIGNATURES = {
    # in, out, n, stream
    "qrp_chacha_blocks": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
}


def chacha_blocks(states: torch.Tensor) -> torch.Tensor:
    """K8: ``(N, 12)`` int32 on a CUDA device -> ``(N, 16)`` int32."""
    states = cuda.expect_cuda(states, torch.int32, "chacha blocks")
    if states.dim() != 2 or states.shape[1] != 12:
        raise ValueError(f"chacha blocks: states must be (N, 12), got {tuple(states.shape)}")
    if states.data_ptr() % 16:  # the kernel moves rows as 16-byte vectors
        states = states.clone()
    out = torch.empty((states.shape[0], 16), dtype=torch.int32, device=states.device)
    if states.shape[0]:
        lib = cuda.library("chacha", _SIGNATURES)
        with torch.cuda.device(states.device):
            err = lib.qrp_chacha_blocks(states.data_ptr(), out.data_ptr(), states.shape[0],
                                        cuda.stream_of(states))
        cuda.check(lib, err, "chacha blocks launch")
        cuda.count_launch(chacha_blocks)
    return out


chacha_blocks.launches = 0
