"""Serving across GPUs: a device mesh and the sharded batched handshake.

Counterpart of the JAX package's ``parallel/``.  The batch axis is the
axis a batch is split along: each GPU runs its share of the handshakes
with no traffic between GPUs, and only the count of agreeing secrets is
summed across them.  The providers split their batches through
``provider.base.mesh_dispatch`` on the same mesh; the split itself
(``shard_batch`` and its helpers) lives there.
"""

from .mesh import (  # noqa: F401
    BATCH_AXIS,
    Mesh,
    handshake_step,
    make_mesh,
    make_sharded_handshake,
    shard_devices,
)
