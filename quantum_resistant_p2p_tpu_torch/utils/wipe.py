"""End-of-life zeroing of key buffers."""

from __future__ import annotations

import numpy as np
import torch


def wipe(*bufs) -> None:
    """Zero secret buffers in place: ``bytearray``, writable numpy arrays
    and tensors (on any device).  Immutable ``bytes`` and read-only array
    views are left to the garbage collector; passing them here still marks
    where their lifetime ends."""
    for buf in bufs:
        if isinstance(buf, torch.Tensor):
            buf.zero_()
        elif isinstance(buf, bytearray):
            buf[:] = bytes(len(buf))
        elif isinstance(buf, np.ndarray) and buf.flags.writeable:
            buf[...] = 0
