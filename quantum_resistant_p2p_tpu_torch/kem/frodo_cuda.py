"""Kernels K9-K11: FrodoKEM's products with A and its sampler on the GPU
(``csrc/frodo.cu``).

=================  ==========================================================
wrapper            replaces (quantum_resistant_p2p_tpu/kem/frodo_pallas.py)
=================  ==========================================================
``a_times_s``      ``a_times_s_words`` (K9)
``s_times_a``      ``s_times_a_words`` (K10)
``cdf_sample``     ``cdf_sample_words`` (K11)
=================  ==========================================================

Each wrapper takes what its plain version in ``kem/frodo.py`` takes, the
parameter set and row-major tensors (``s`` (..., n, NBAR) and ``sp``
(..., NBAR, n) int32, ``seed_a`` (..., 16) uint8 with the same batch shape,
``r16`` (...,) int32), on one CUDA device; it launches its kernel and
counts the launch in its ``launches`` attribute.  Any other tensor raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils import cuda
from .frodo_params import NBAR, FrodoParams

_P = ctypes.c_void_p
_SIGNATURES = {
    # seed_a, s, out, batch, n, q_mask, stream
    "qrp_frodo_a_times_s": [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P],
    # seed_a, sp, out, batch, n, q_mask, stream
    "qrp_frodo_s_times_a": [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P],
    # r, out, m, cdf (host), n_cdf, q_mask, stream
    "qrp_frodo_cdf_sample": [_P, _P, ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int, _P],
}


def _product(wrapper, fn: str, p: FrodoParams, x: torch.Tensor, seed_a: torch.Tensor,
             mat_shape: tuple[int, int], what: str) -> torch.Tensor:
    """Shared launch of K9/K10: x (..., *mat_shape) int32 and seed_a (..., 16)
    -> (..., *mat_shape) int32 in [0, q), one lane per batch row."""
    x = cuda.expect_cuda(x, torch.int32, what)
    seed_a = cuda.expect_cuda(seed_a, torch.uint8, f"{what} seed_a")
    batch = tuple(x.shape[:-2])
    if tuple(x.shape[-2:]) != mat_shape:
        raise ValueError(f"{what}: operand must be (..., {mat_shape[0]}, {mat_shape[1]}), "
                         f"got {tuple(x.shape)}")
    if tuple(seed_a.shape) != batch + (16,):
        raise ValueError(f"{what}: seed_a must be {batch + (16,)}, got {tuple(seed_a.shape)}")
    if seed_a.device != x.device:
        raise ValueError(f"{what}: seed_a on {seed_a.device}, operand on {x.device}")
    lanes = math.prod(batch)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if lanes:
        lib = cuda.library("frodo", _SIGNATURES)
        with torch.cuda.device(x.device):
            err = getattr(lib, fn)(seed_a.data_ptr(), x.data_ptr(), out.data_ptr(), lanes, p.n,
                                   p.q - 1, cuda.stream_of(x))
        cuda.check(lib, err, f"{what} launch")
        cuda.count_launch(wrapper)
    return out


def a_times_s(p: FrodoParams, s: torch.Tensor, seed_a: torch.Tensor) -> torch.Tensor:
    """K9: A.S, s (..., n, NBAR) int32, seed_a (..., 16) uint8 -> (..., n, NBAR)."""
    return _product(a_times_s, "qrp_frodo_a_times_s", p, s, seed_a, (p.n, NBAR),
                    "frodo a_times_s")


def s_times_a(p: FrodoParams, sp: torch.Tensor, seed_a: torch.Tensor) -> torch.Tensor:
    """K10: S'.A, sp (..., NBAR, n) int32, seed_a (..., 16) uint8 -> (..., NBAR, n)."""
    return _product(s_times_a, "qrp_frodo_s_times_a", p, sp, seed_a, (NBAR, p.n),
                    "frodo s_times_a")


def cdf_sample(p: FrodoParams, r16: torch.Tensor) -> torch.Tensor:
    """K11: (...,) int32 16-bit randoms -> (...,) int32 CDF samples mod q."""
    r16 = cuda.expect_cuda(r16, torch.int32, "frodo cdf_sample")
    out = torch.empty_like(r16)
    if r16.numel():
        table = np.asarray(p.cdf[:-1], dtype=np.int32)
        lib = cuda.library("frodo", _SIGNATURES)
        with torch.cuda.device(r16.device):
            err = lib.qrp_frodo_cdf_sample(r16.data_ptr(), out.data_ptr(), r16.numel(),
                                           table.ctypes.data, len(table), p.q - 1,
                                           cuda.stream_of(r16))
        cuda.check(lib, err, "frodo cdf_sample launch")
        cuda.count_launch(cdf_sample)
    return out


a_times_s.launches = 0
s_times_a.launches = 0
cdf_sample.launches = 0
