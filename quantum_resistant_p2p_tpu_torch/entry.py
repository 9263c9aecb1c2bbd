"""Flagship entry point of the port: batched ML-KEM-768 encapsulation.

Counterpart of the reference's ``__graft_entry__.entry``: ``entry()``
returns the batched encaps step and example arguments for it, at the batch
of 4096 that the north-star target (50k encaps/s) is stated for.  The
arguments live on the GPU unless the caller asks for another device; with
no GPU, ``device="cuda"`` raises.

    fn, args = entry()
    key, ct = fn(*args)   # (4096, 32), (4096, 1088) uint8 on the GPU
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .kem import mlkem
from .utils.cuda import require_device

BATCH = 4096


def entry(device="cuda"):
    """-> (fn, (ek, m)): ML-KEM-768 encaps over ``BATCH`` rows of one
    public key (made by keygen from d = 0..31, z = 0) and seeded m."""
    dev = require_device(device)
    p = mlkem.MLKEM768
    d = torch.arange(32, dtype=torch.uint8, device=dev)
    ek, _ = mlkem.keygen(p, d, torch.zeros(32, dtype=torch.uint8, device=dev))
    eks = ek.expand(BATCH, p.ek_len).contiguous()
    rng = np.random.default_rng(0)
    ms = torch.from_numpy(rng.integers(0, 256, size=(BATCH, 32), dtype=np.uint8)).to(dev)
    return functools.partial(mlkem.encaps, p), (eks, ms)
