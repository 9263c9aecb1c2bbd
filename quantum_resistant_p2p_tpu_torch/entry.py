"""Flagship entry point of the port: batched ML-KEM-768 encapsulation.

Counterpart of the reference's ``__graft_entry__.entry``: ``entry()``
returns the batched encaps step and example arguments for it, at the batch
of 4096 that the north-star target (50k encaps/s) is stated for.  The
arguments live on the GPU unless the caller asks for another device; with
no GPU, ``device="cuda"`` raises.

    fn, args = entry()
    key, ct = fn(*args)   # (4096, 32), (4096, 1088) uint8 on the GPU

``dryrun_multichip(n)`` is the counterpart of the reference's
``__graft_entry__.dryrun_multichip``: the handshake step split across the
first ``n`` GPUs, then the KEM and signature providers with
``devices=n`` on batches the mesh does not divide.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .kem import mlkem
from .parallel import make_mesh, make_sharded_handshake
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


def dryrun_multichip(n_devices: int) -> dict:
    """The port's serving path split across the first ``n_devices`` GPUs
    (raises when fewer exist): the sharded ML-KEM-768 handshake step at
    ``2 n`` rows, every secret agreeing; ``get_kem("ML-KEM-768",
    devices=n)`` keygen, encaps and decaps at ``2 n + 1`` rows; and
    ``get_signature("ML-DSA-44", devices=n)`` sign and verify at ``2 n +
    1`` rows, all verifying.  -> what ran, by rows."""
    from .provider import get_kem, get_signature

    return run_multichip(make_mesh(n_devices), get_kem("ML-KEM-768", devices=n_devices),
                         get_signature("ML-DSA-44", devices=n_devices))


def run_multichip(mesh, kem, sig) -> dict:
    """:func:`dryrun_multichip`'s checks on a given mesh and providers that
    split across it; raises RuntimeError at the first that fails."""
    step = make_sharded_handshake(mesh, "ML-KEM-768")
    batch = 2 * mesh.size
    rng = np.random.default_rng(1)
    d, z, m = (rng.integers(0, 256, size=(batch, 32), dtype=np.uint8) for _ in range(3))
    _, _, key_e, key_d, n_ok = step(d, z, m)
    if n_ok != batch or not np.array_equal(key_e, key_d):
        raise RuntimeError(f"sharded handshake: {n_ok} of {batch} secrets agree")

    n = 2 * mesh.size + 1
    eks, dks = kem.generate_keypair_batch(n)
    cts, keys = kem.encapsulate_batch(eks)
    if not np.array_equal(kem.decapsulate_batch(dks, cts), keys):
        raise RuntimeError("split provider KEM: decaps disagrees with encaps")

    pk, sk = sig.generate_keypair()
    sks = np.broadcast_to(np.frombuffer(sk, np.uint8), (n, len(sk)))
    pks = np.broadcast_to(np.frombuffer(pk, np.uint8), (n, len(pk)))
    msgs = [b"mesh-dryrun-%d" % i for i in range(n)]
    sigs = sig.sign_batch(sks, msgs)
    if not sig.verify_batch(pks, msgs, sigs).all():
        raise RuntimeError("split provider signature: a signature does not verify")
    return {"devices": [str(dev) for dev in mesh.devices], "handshake_rows": batch,
            "handshake_ok": n_ok, "provider_rows": n}
