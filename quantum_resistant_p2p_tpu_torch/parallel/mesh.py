"""Device mesh and the sharded batched handshake step, across GPUs.

Counterpart of the JAX package's ``parallel/mesh.py``.  Handshakes are
independent of each other, so the batch axis is the one axis a batch is
split along: each GPU runs its contiguous share of keygen, encaps and
decaps with no traffic between GPUs, and only the count of agreeing
secrets is summed across them (the counterpart of the JAX package's
``psum``).

A :class:`Mesh` here is a tuple of ``torch.device``s that one process
drives, each share launched under ``torch.cuda.device(dev)`` on that
device's current stream.  It is not ``torch.distributed``'s
``DeviceMesh``, which needs a process group a device.  :func:`make_mesh`
and :func:`shard_devices` take the first GPUs and raise when fewer exist:
nothing degrades to fewer GPUs or to the CPU.  ``Mesh(devices)`` also takes
an explicit list, which may repeat a device: the tests split over CPU
"devices" that way, and the smoke run over one GPU listed several times.

The split itself (padding, one share a device, gathering, zeroing the
device copies) is ``provider.base``'s, beside ``mesh_dispatch``, which
splits the providers' batches the same way.
"""

from __future__ import annotations

import functools

import torch

from ..kem import mlkem
from ..utils.wipe import wipe

BATCH_AXIS = "batch"


class Mesh:
    """A 1-D mesh: the devices that shares of a batch run on, in order."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (BATCH_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def shard_devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` GPUs (default: all) as ``torch.device("cuda", i)``.

    The placement twin of :func:`make_mesh`: where the mesh splits ONE
    batch across GPUs, the scheduler's placement axis
    (provider/scheduler.py) runs each queue flush whole on one of these.
    Raises RuntimeError when fewer GPUs exist, or none."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n is None else n
    if want < 1 or have < want:
        raise RuntimeError(f"need {want if n is not None else 'at least 1'} GPU(s), have "
                           f"{have} (torch.cuda.device_count()); a mesh does not fall back "
                           "to fewer GPUs or to the CPU")
    return [torch.device("cuda", i) for i in range(want)]


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` GPUs (default: all); raises
    like :func:`shard_devices`."""
    return Mesh(shard_devices(n_devices))


def handshake_step(p, d: torch.Tensor, z: torch.Tensor, m: torch.Tensor):
    """One full KEM handshake over a batch: keygen -> encaps -> decaps.

    -> (ek, ct, key_initiator, key_responder, n_ok), n_ok the count of rows
    whose two secrets agree (an int32 tensor on the batch's device)."""
    ek, dk = mlkem.keygen(p, d, z)
    key_e, ct = mlkem.encaps(p, ek, m)
    key_d = mlkem.decaps(p, dk, ct)
    n_ok = (key_e == key_d).all(dim=-1).sum(dtype=torch.int32)
    wipe(dk)
    return ek, ct, key_e, key_d, n_ok


@functools.cache
def make_sharded_handshake(mesh: Mesh, param_name: str = "ML-KEM-768"):
    """The handshake step split across ``mesh``: -> ``step(d, z, m)`` over
    host rows whose batch the mesh divides, returning host arrays (ek, ct,
    key_e, key_d) gathered in order and n_ok summed over the devices."""
    from ..provider.base import join_shares, split_run  # provider.base imports this module

    p = mlkem.PARAMS[param_name]
    one = functools.partial(handshake_step, p)

    def step(d, z, m):
        if len(d) % mesh.size:
            raise ValueError(f"sharded handshake: {len(d)} rows do not divide over "
                             f"{mesh.size} devices")
        parts = split_run(one, mesh, d, z, m)
        ek, ct, key_e, key_d = join_shares([part[:4] for part in parts], len(d))
        return ek, ct, key_e, key_d, sum(int(part[4]) for part in parts)

    return step
