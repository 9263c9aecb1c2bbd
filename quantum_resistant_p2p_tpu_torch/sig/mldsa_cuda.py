"""Kernels K5-K7: ML-DSA sampling and NTT on the GPU (``csrc/mldsa.cu``).

=================  ==========================================================
wrapper            replaces (quantum_resistant_p2p_tpu/sig/mldsa_pallas.py)
=================  ==========================================================
``rej_ntt``        ``rej_ntt_words`` (K5)
``rej_bounded``    ``rej_bounded_words`` (K6)
``ntt``            ``ntt_words`` (K7)
``ntt_inv``        ``ntt_words(inverse=True)`` (K7)
=================  ==========================================================

Each wrapper takes what its plain version in ``sig/mldsa.py`` takes
(row-major seed bytes or ``(..., 256)`` int32 polynomials) on a CUDA device,
launches its kernel and counts the launch in its ``launches`` attribute.
Any other tensor raises.

K7's schedule is built here and loaded into the kernel's tables (see
``csrc/mldsa.cuh``): a half-warp transforms one polynomial, 16 coefficients
a lane.  In stage A lane t's register j holds coefficient t + 16 j, in stage
B 16 t + j (:func:`ntt_coefficient`, from ``utils/ntt_layout.py``, which
K3's fused NTT shares); each stage runs four layers, pairing registers j
and j + h, whose zeta sits at slot :func:`ntt_slot` of the stage's table.
``NTT_ZETA_INDEX`` names the zeta of every (direction, stage, slot, lane);
the tables hold those zetas and their Shoup companions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.keccak import seed_rows
from ..utils import cuda, ntt_layout
from .params import N, N_INV, Q, ZETAS

_P = ctypes.c_void_p
_SIGNATURES = {
    "qrp_mldsa_init": [_P, _P],
    # seeds, out, n, stream
    "qrp_mldsa_rej_ntt": [_P, _P, ctypes.c_int64, _P],
    # seeds, out, n, eta, stream
    "qrp_mldsa_rej_bounded": [_P, _P, ctypes.c_int64, ctypes.c_int, _P],
    # in, out, n, inverse, stream
    "qrp_mldsa_ntt": [_P, _P, ctypes.c_int64, ctypes.c_int, _P],
}
#: registers a lane and lanes a polynomial in K7, and zeta slots a stage
NTT_REGS, NTT_LANES = ntt_layout.REGS, ntt_layout.LANES
NTT_SLOTS = 15
#: the half-distance h between paired registers, layer by layer, of a
#: forward stage (an inverse stage runs them in reverse)
NTT_HALVES = (8, 4, 2, 1)
ntt_coefficient = ntt_layout.coefficient
ntt_slot = ntt_layout.slot
#: (direction: 0 forward, 1 inverse; stage; slot; lane) -> index into ZETAS
NTT_ZETA_INDEX = np.stack([np.stack(ntt_layout.zeta_indices((NTT_HALVES, NTT_HALVES), inverse,
                                                            "K7"))
                           for inverse in (False, True)])


def _ntt_tables() -> tuple[np.ndarray, np.ndarray]:
    """K7's tables as ``qrp_mldsa_init`` loads them: ``uniform`` (2, 2, 16)
    = (direction, zeta or companion, slot) of stage A, the same for every
    lane (the inverse's slot 0 times 256^-1, its slot 15 256^-1 itself), and
    ``lanes`` (2, 2, 15, 16) = (direction, zeta or companion, slot, lane)
    of stage B."""
    z = np.asarray(ZETAS, dtype=np.int64)[NTT_ZETA_INDEX]
    a = np.zeros((2, 16), dtype=np.uint32)
    a[:, :NTT_SLOTS] = z[:, 0, :, 0]
    a[1, 0] = a[1, 0].astype(np.int64) * N_INV % Q
    a[1, 15] = N_INV
    uniform = np.ascontiguousarray(np.stack([a, ntt_layout.shoup(a, Q)], axis=1))
    b = z[:, 1].astype(np.uint32)
    lanes = np.ascontiguousarray(np.stack([b, ntt_layout.shoup(b, Q)], axis=1))
    return uniform, lanes


NTT_UNIFORM, NTT_LANE_TABLE = _ntt_tables()


def _lib(device: torch.device) -> ctypes.CDLL:
    """The library, with K7's tables loaded on ``device``."""
    return cuda.device_library("mldsa", _SIGNATURES, device,
                               lambda lib: lib.qrp_mldsa_init(NTT_UNIFORM.ctypes.data,
                                                              NTT_LANE_TABLE.ctypes.data))


def _seed_launch(wrapper, seeds: torch.Tensor, seed_len: int, what: str,
                 call) -> torch.Tensor:
    """Shared shape handling of K5/K6: ``(..., seed_len)`` uint8 seeds ->
    ``(..., 256)`` int32, one kernel thread per row; counts the launch on
    ``wrapper``."""
    seeds = cuda.expect_cuda(seeds, torch.uint8, what)
    if seeds.shape[-1] != seed_len:
        raise ValueError(f"{what}: seeds must be {seed_len} bytes, got {seeds.shape[-1]}")
    rows, batch = seed_rows(seeds)
    out = torch.empty((rows.shape[0], N), dtype=torch.int32, device=seeds.device)
    if rows.shape[0]:
        with torch.cuda.device(seeds.device):
            lib = _lib(seeds.device)
            err = call(lib, rows.data_ptr(), out.data_ptr(), rows.shape[0],
                       cuda.stream_of(seeds))
        cuda.check(lib, err, f"{what} launch")
        cuda.count_launch(wrapper)
    return out.reshape(batch + (N,))


def rej_ntt(seeds: torch.Tensor) -> torch.Tensor:
    """K5: ``(..., 34)`` uint8 seeds rho || s || r -> ``(..., 256)`` int32."""
    return _seed_launch(rej_ntt, seeds, 34, "mldsa rej_ntt",
                        lambda lib, s, o, n, st: lib.qrp_mldsa_rej_ntt(s, o, n, st))


def rej_bounded(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    """K6: ``(..., 66)`` uint8 seeds rho' || n -> ``(..., 256)`` int32 raw
    accepted nibbles (before the eta map)."""
    if eta not in (2, 4):
        raise ValueError(f"mldsa rej_bounded: eta must be 2 or 4, got {eta}")
    return _seed_launch(rej_bounded, seeds, 66, "mldsa rej_bounded",
                        lambda lib, s, o, n, st: lib.qrp_mldsa_rej_bounded(s, o, n, eta, st))


def _ntt_launch(wrapper, f: torch.Tensor, inverse: int) -> torch.Tensor:
    what = "mldsa ntt_inv" if inverse else "mldsa ntt"
    f = cuda.expect_cuda(f, torch.int32, what)
    if f.shape[-1] != N:
        raise ValueError(f"{what}: polynomials must have {N} coefficients")
    out = torch.empty_like(f)  # f is contiguous, so out has its row-major layout
    if f.numel():
        with torch.cuda.device(f.device):
            lib = _lib(f.device)
            err = lib.qrp_mldsa_ntt(f.data_ptr(), out.data_ptr(), f.numel() // N, inverse,
                                    cuda.stream_of(f))
        cuda.check(lib, err, f"{what} launch")
        cuda.count_launch(wrapper)
    return out


def ntt(f: torch.Tensor) -> torch.Tensor:
    """K7 forward: ``(..., 256)`` int32 in [0, q) -> NTT domain."""
    return _ntt_launch(ntt, f, 0)


def ntt_inv(f: torch.Tensor) -> torch.Tensor:
    """K7 inverse, scaled by 256^-1 = 8347681 mod q."""
    return _ntt_launch(ntt_inv, f, 1)


rej_ntt.launches = 0
rej_bounded.launches = 0
ntt.launches = 0
ntt_inv.launches = 0
