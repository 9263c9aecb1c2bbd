"""Kernel K1: the batched Keccak sponge on the GPU (``csrc/sponge.cu``).

Replaces ``quantum_resistant_p2p_tpu/core/keccak_pallas.py:sponge_words``.
:func:`sponge` takes what :func:`core.keccak.sponge` takes, ``(..., L)``
uint8 rows on a CUDA device, and launches the kernel; it raises for any
other tensor.  Its plain version is ``core.keccak.sponge_plain``.
:func:`sponge_varlen` is the same kernel with a true length per row (the
fused handshake's transcripts); its plain version is
``core.keccak.sponge_varlen_plain``.  Each wrapper counts its own launches.

The kernel runs a sponge a thread where the rows fill the device, and
splits each sponge over five lanes of a warp where they do not (the rule
is in ``csrc/sponge.cu``).  :func:`split_table` is the split path's
schedule, which the kernel loads into registers: lane p of a group holds
column x = p at the start of a round and row y = p after pi.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..utils import cuda

_RATES = (72, 136, 168)


_SIGNATURES = {
    "qrp_keccak_init": [ctypes.c_void_p],
    # in, out, n_rows, in_len, rate, ds, out_len, stream
    "qrp_keccak_sponge": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # in, lengths, out, n_rows, lmax, rate, ds, out_len, stream
    "qrp_keccak_sponge_varlen": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p],
}


#: lanes of a warp that run one sponge on the split path
SPLIT_LANES = 5


def split_pi_source(p: int, k: int) -> int:
    """Group lane whose column slot k is pi's row slot k of lane p: lane
    (x, y) = (s, k) goes to (y, 2x + 3y), row 2s + 3k = p, so s = 3p + k."""
    return (3 * p + k) % 5


@functools.cache
def split_table() -> np.ndarray:
    """(5, 22) int32, row p for group lane p, as ``g_split`` in
    ``csrc/sponge.cu`` reads it: [0, 5) the rho amount of column slot y
    (lane (p, y)); [5, 10) pi's source lane of step k; [10, 12) the lanes
    of theta's C[p - 1] and C[p + 1]; [12, 17) the exchange-buffer lane
    that row slot x (lane (x, p)) goes to after chi; [17, 22) the buffer
    lane that column slot y comes from for the next round."""
    from .keccak import RHO

    t = np.zeros((SPLIT_LANES, 22), dtype=np.int32)
    for p in range(SPLIT_LANES):
        t[p, 0:5] = [RHO[p + 5 * y] for y in range(5)]
        t[p, 5:10] = [split_pi_source(p, k) for k in range(5)]
        t[p, 10:12] = [(p - 1) % 5, (p + 1) % 5]
        t[p, 12:17] = [x + 5 * p for x in range(5)]
        t[p, 17:22] = [p + 5 * y for y in range(5)]
    return t


def _lib(device: torch.device) -> ctypes.CDLL:
    """The library, with the split path's table loaded on ``device``."""
    return cuda.device_library("sponge", _SIGNATURES, device,
                               lambda lib: lib.qrp_keccak_init(split_table().ctypes.data))


def _check_rate(rate: int) -> None:
    if rate not in _RATES:
        raise ValueError(f"keccak sponge: rate must be one of {_RATES}, got {rate}")


def sponge(data: torch.Tensor, rate: int, ds_byte: int, out_len: int) -> torch.Tensor:
    """K1: ``(..., L)`` uint8 on a CUDA device -> ``(..., out_len)`` uint8."""
    _check_rate(rate)
    data = cuda.expect_cuda(data, torch.uint8, "keccak sponge")
    batch = tuple(data.shape[:-1])
    n_rows = math.prod(batch)  # data is contiguous: row-major (n_rows, L)
    out = torch.empty(batch + (out_len,), dtype=torch.uint8, device=data.device)
    if n_rows and out_len:
        with torch.cuda.device(data.device):
            lib = _lib(data.device)
            err = lib.qrp_keccak_sponge(data.data_ptr(), out.data_ptr(), n_rows, data.shape[-1],
                                        rate, ds_byte, out_len, cuda.stream_of(data))
        cuda.check(lib, err, "keccak sponge launch")
        cuda.count_launch(sponge)
    return out


sponge.launches = 0


def sponge_varlen(data: torch.Tensor, lengths: torch.Tensor, rate: int, ds_byte: int,
                  out_len: int) -> torch.Tensor:
    """K1 with per-row lengths: ``(..., LMAX)`` uint8 and ``(...,)`` true
    lengths (int32, each in [0, LMAX]; the kernel clamps to that range so a
    bad length cannot read outside its row) on one CUDA device ->
    ``(..., out_len)`` uint8."""
    _check_rate(rate)
    data = cuda.expect_cuda(data, torch.uint8, "keccak sponge_varlen")
    batch = tuple(data.shape[:-1])
    n_rows = math.prod(batch)  # data and lens are contiguous: row-major
    lens = cuda.expect_cuda(lengths.expand(batch), torch.int32, "keccak sponge_varlen lengths")
    if lens.device != data.device:
        raise ValueError(f"keccak sponge_varlen: lengths on {lens.device}, data on {data.device}")
    out = torch.empty(batch + (out_len,), dtype=torch.uint8, device=data.device)
    if n_rows and out_len:
        with torch.cuda.device(data.device):
            lib = _lib(data.device)
            err = lib.qrp_keccak_sponge_varlen(data.data_ptr(), lens.data_ptr(), out.data_ptr(),
                                               n_rows, data.shape[-1], rate, ds_byte, out_len,
                                               cuda.stream_of(data))
        cuda.check(lib, err, "keccak sponge_varlen launch")
        cuda.count_launch(sponge_varlen)
    return out


sponge_varlen.launches = 0
