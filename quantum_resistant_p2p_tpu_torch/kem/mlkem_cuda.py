"""Kernels K2-K4: ML-KEM sampling and NTT on the GPU (``csrc/mlkem.cu``).

=================  ==========================================================
wrapper            replaces (quantum_resistant_p2p_tpu/kem/mlkem_pallas.py)
=================  ==========================================================
``sample_ntt``     ``sample_ntt_words`` (K2)
``prf_cbd``        ``cbd_words`` (K3, fuse_ntt = 0)
``prf_cbd_ntt``    ``cbd_ntt_words`` (K3, fuse_ntt = 1)
``ntt``            ``ntt_words`` (K4)
``ntt_inv``        ``ntt_words(inverse=True)`` (K4)
=================  ==========================================================

Each wrapper takes what its plain version in ``kem/mlkem.py`` takes
(row-major seed bytes or ``(..., 256)`` int32 polynomials) on a CUDA device,
launches its kernel and counts the launch in its ``launches`` attribute.
Any other tensor raises.

K3's fused NTT and K4 take K7's layout (``utils/ntt_layout.py``;
``csrc/ntt_halfwarp.cuh`` and ``csrc/mlkem.cuh`` hold the kernel side): a
half-warp transforms one polynomial, 16 coefficients a lane.  In stage A
lane t's register j holds coefficient t + 16 j, in stage B 16 t + j
(:func:`ntt_coefficient`); stage A runs the layers of length 128..16,
stage B those of length 8..2, pairing registers j and j + h, whose zeta
sits at slot :func:`ntt_slot` of the stage's table.  The forward runs A
then B, the inverse B then A.  ``NTT_ZETA_INDEX_A`` / ``NTT_ZETA_INDEX_B``
name the zeta of every slot (and lane) of the forward, ``NTT_INV_ZETA_INDEX_A``
/ ``NTT_INV_ZETA_INDEX_B`` of the inverse; the tables hold those zetas and
their Shoup companions, the inverse's with 128^-1 = 3303 folded into its
last layer.
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
    "qrp_mlkem_init_ntt": [_P, _P],
    # seeds, out, n, stream
    "qrp_mlkem_sample_ntt": [_P, _P, ctypes.c_int64, _P],
    # seeds, out, n, eta, fuse_ntt, stream
    "qrp_mlkem_prf_cbd": [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P],
    # in, out, n, inverse, stream
    "qrp_mlkem_ntt": [_P, _P, ctypes.c_int64, ctypes.c_int, _P],
}
#: registers a lane and lanes a polynomial in the half-warp NTT
NTT_REGS, NTT_LANES = ntt_layout.REGS, ntt_layout.LANES
#: the half-distance h between paired registers, layer by layer, of stage
#: A (layers of length 128..16) and stage B (8..2) in forward order (the
#: inverse runs each stage's in reverse); and each stage's slots
NTT_HALVES = ((8, 4, 2, 1), (8, 4, 2))
NTT_SLOTS = (15, 7)
ntt_coefficient = ntt_layout.coefficient
ntt_slot = ntt_layout.slot
#: ZETAS index of stage A's slots (15,), the same for every lane, and of
#: stage B's (slot, lane) (7, 16); forward, then inverse
_INDEX_A, NTT_ZETA_INDEX_B = ntt_layout.zeta_indices(NTT_HALVES, what="K3/K4 NTT")
NTT_ZETA_INDEX_A = _INDEX_A[:, 0]
_INV_INDEX_A, NTT_INV_ZETA_INDEX_B = ntt_layout.zeta_indices(NTT_HALVES, True, "K4 inverse NTT")
NTT_INV_ZETA_INDEX_A = _INV_INDEX_A[:, 0]


def _ntt_tables(index_a: np.ndarray, index_b: np.ndarray,
                inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """One direction's tables: ``uniform`` (2, 16) = (zeta or companion,
    slot) of stage A, ``lanes`` (2, 7, 16) = (zeta or companion, slot,
    lane) of stage B.  The forward leaves slot 15 of stage A unused; the
    inverse holds zeta * 128^-1 at slot 0 (the last layer's) and 128^-1 at
    slot 15."""
    z = np.asarray(ZETAS, dtype=np.int64)
    a = np.zeros(16, dtype=np.uint32)
    a[:NTT_SLOTS[0]] = z[index_a]
    if inverse:
        a[0] = int(a[0]) * N_INV % Q
        a[15] = N_INV
    b = z[index_b].astype(np.uint32)
    return (np.ascontiguousarray(np.stack([a, ntt_layout.shoup(a, Q)])),
            np.ascontiguousarray(np.stack([b, ntt_layout.shoup(b, Q)])))


NTT_UNIFORM, NTT_LANE_TABLE = _ntt_tables(NTT_ZETA_INDEX_A, NTT_ZETA_INDEX_B, False)
NTT_INV_UNIFORM, NTT_INV_LANE_TABLE = _ntt_tables(NTT_INV_ZETA_INDEX_A, NTT_INV_ZETA_INDEX_B,
                                                  True)
#: what qrp_mlkem_init_ntt loads: (direction, ...) of both directions
_INIT_UNIFORM = np.ascontiguousarray(np.stack([NTT_UNIFORM, NTT_INV_UNIFORM]))
_INIT_LANES = np.ascontiguousarray(np.stack([NTT_LANE_TABLE, NTT_INV_LANE_TABLE]))


def _init(lib: ctypes.CDLL) -> int:
    return lib.qrp_mlkem_init_ntt(_INIT_UNIFORM.ctypes.data, _INIT_LANES.ctypes.data)


def _lib(device: torch.device) -> ctypes.CDLL:
    """The library, with the NTT tables of K3 and K4 on ``device``."""
    return cuda.device_library("mlkem", _SIGNATURES, device, _init)


def _seed_launch(wrapper, seeds: torch.Tensor, seed_len: int, what: str,
                 call) -> torch.Tensor:
    """Shared shape handling of K2/K3: ``(..., seed_len)`` uint8 seeds ->
    ``(..., 256)`` int32, one kernel thread (sponge) per row; counts the
    launch on ``wrapper``."""
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


def sample_ntt(seeds: torch.Tensor) -> torch.Tensor:
    """K2: ``(..., 34)`` uint8 XOF seeds -> ``(..., 256)`` int32."""
    return _seed_launch(sample_ntt, seeds, 34, "mlkem sample_ntt",
                        lambda lib, s, o, n, st: lib.qrp_mlkem_sample_ntt(s, o, n, st))


def prf_cbd(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    """K3: ``(..., 33)`` uint8 PRF seeds -> ``(..., 256)`` int32 CBD_eta."""
    return _seed_launch(prf_cbd, seeds, 33, "mlkem prf_cbd",
                        lambda lib, s, o, n, st: lib.qrp_mlkem_prf_cbd(s, o, n, eta, 0, st))


def prf_cbd_ntt(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    """K3 with the NTT fused: ``(..., 33)`` uint8 -> ``(..., 256)`` int32."""
    return _seed_launch(prf_cbd_ntt, seeds, 33, "mlkem prf_cbd_ntt",
                        lambda lib, s, o, n, st: lib.qrp_mlkem_prf_cbd(s, o, n, eta, 1, st))


def _ntt_launch(wrapper, f: torch.Tensor, inverse: int) -> torch.Tensor:
    what = "mlkem ntt_inv" if inverse else "mlkem ntt"
    f = cuda.expect_cuda(f, torch.int32, what)
    if f.shape[-1] != N:
        raise ValueError(f"{what}: polynomials must have {N} coefficients")
    rows = f.reshape(-1, N)
    out = torch.empty_like(rows)
    if rows.shape[0]:
        with torch.cuda.device(f.device):
            lib = _lib(f.device)
            err = lib.qrp_mlkem_ntt(rows.data_ptr(), out.data_ptr(), rows.shape[0],
                                    inverse, cuda.stream_of(f))
        cuda.check(lib, err, f"{what} launch")
        cuda.count_launch(wrapper)
    return out.reshape(f.shape)


def ntt(f: torch.Tensor) -> torch.Tensor:
    """K4 forward: ``(..., 256)`` int32 in [0, q) -> NTT domain."""
    return _ntt_launch(ntt, f, 0)


def ntt_inv(f: torch.Tensor) -> torch.Tensor:
    """K4 inverse, scaled by 128^-1 = 3303 mod q."""
    return _ntt_launch(ntt_inv, f, 1)


sample_ntt.launches = 0
prf_cbd.launches = 0
prf_cbd_ntt.launches = 0
ntt.launches = 0
ntt_inv.launches = 0
