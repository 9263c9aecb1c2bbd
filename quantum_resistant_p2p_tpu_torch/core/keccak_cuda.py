"""Kernel K1: the batched Keccak sponge on the GPU (``csrc/sponge.cu``).

Replaces ``quantum_resistant_p2p_tpu/core/keccak_pallas.py:sponge_words``.
:func:`sponge` takes what :func:`core.keccak.sponge` takes, ``(..., L)``
uint8 rows on a CUDA device, and launches one thread per row; it raises for
any other tensor.  Its plain version is ``core.keccak.sponge_plain``.
:func:`sponge_varlen` is the same kernel with a true length per row (the
fused handshake's transcripts); its plain version is
``core.keccak.sponge_varlen_plain``.  Each wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import cuda

_RATES = (72, 136, 168)


_SIGNATURES = {
    # in, out, n_rows, in_len, rate, ds, out_len, stream
    "qrp_keccak_sponge": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # in, lengths, out, n_rows, lmax, rate, ds, out_len, stream
    "qrp_keccak_sponge_varlen": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p],
}


def _check_rate(rate: int) -> None:
    if rate not in _RATES:
        raise ValueError(f"keccak sponge: rate must be one of {_RATES}, got {rate}")


def sponge(data: torch.Tensor, rate: int, ds_byte: int, out_len: int) -> torch.Tensor:
    """K1: ``(..., L)`` uint8 on a CUDA device -> ``(..., out_len)`` uint8."""
    _check_rate(rate)
    data = cuda.expect_cuda(data, torch.uint8, "keccak sponge")
    batch = tuple(data.shape[:-1])
    rows = data.reshape(math.prod(batch), data.shape[-1])
    out = torch.empty((rows.shape[0], out_len), dtype=torch.uint8, device=data.device)
    if rows.shape[0] and out_len:
        lib = cuda.library("sponge", _SIGNATURES)
        with torch.cuda.device(data.device):
            err = lib.qrp_keccak_sponge(rows.data_ptr(), out.data_ptr(), rows.shape[0],
                                        rows.shape[1], rate, ds_byte, out_len,
                                        cuda.stream_of(data))
        cuda.check(lib, err, "keccak sponge launch")
        sponge.launches += 1
    return out.reshape(batch + (out_len,))


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
    rows = data.reshape(math.prod(batch), data.shape[-1])
    lens = cuda.expect_cuda(lengths.expand(batch), torch.int32,
                            "keccak sponge_varlen lengths").reshape(-1)
    if lens.device != data.device:
        raise ValueError(f"keccak sponge_varlen: lengths on {lens.device}, data on {data.device}")
    out = torch.empty((rows.shape[0], out_len), dtype=torch.uint8, device=data.device)
    if rows.shape[0] and out_len:
        lib = cuda.library("sponge", _SIGNATURES)
        with torch.cuda.device(data.device):
            err = lib.qrp_keccak_sponge_varlen(rows.data_ptr(), lens.data_ptr(), out.data_ptr(),
                                               rows.shape[0], rows.shape[1], rate, ds_byte,
                                               out_len, cuda.stream_of(data))
        cuda.check(lib, err, "keccak sponge_varlen launch")
        sponge_varlen.launches += 1
    return out.reshape(batch + (out_len,))


sponge_varlen.launches = 0
