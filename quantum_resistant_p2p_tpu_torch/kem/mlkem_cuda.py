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
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..core.keccak import seed_rows
from ..utils import cuda
from .params import N, ZETAS

_P = ctypes.c_void_p
_SIGNATURES = {
    "qrp_mlkem_init": [_P],
    # seeds, out, n, stream
    "qrp_mlkem_sample_ntt": [_P, _P, ctypes.c_int64, _P],
    # seeds, out, n, eta, fuse_ntt, stream
    "qrp_mlkem_prf_cbd": [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P],
    # in, out, n, inverse, stream
    "qrp_mlkem_ntt": [_P, _P, ctypes.c_int64, ctypes.c_int, _P],
}
_ZETAS = np.asarray(ZETAS, dtype=np.int32)
_zeta_lock = threading.Lock()
_zeta_devices: set[int] = set()


def _lib(device: torch.device) -> ctypes.CDLL:
    """The library, with the zetas in ``device``'s constant memory.

    ``__constant__`` memory is per device, so the zetas are uploaded the
    first time each device is seen.  Call inside ``torch.cuda.device``.
    """
    lib = cuda.library("mlkem", _SIGNATURES)
    with _zeta_lock:
        if device.index not in _zeta_devices:
            cuda.check(lib, lib.qrp_mlkem_init(_ZETAS.ctypes.data), "mlkem zeta upload")
            _zeta_devices.add(device.index)
    return lib


def _seed_launch(wrapper, seeds: torch.Tensor, seed_len: int, what: str,
                 call) -> torch.Tensor:
    """Shared shape handling of K2/K3: ``(..., seed_len)`` uint8 seeds ->
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
        wrapper.launches += 1
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
        wrapper.launches += 1
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
