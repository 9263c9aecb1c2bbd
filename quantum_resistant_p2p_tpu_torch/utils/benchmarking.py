"""Honest device timing helpers.

Counterpart of the JAX package's ``utils/benchmarking.py``.  A CUDA launch
returns as soon as the work is queued, so a host clock read right after a
call times the launch, not the kernels.  :func:`sync` fences every CUDA
tensor of a result (``torch.cuda.synchronize`` on each device it lies on),
and :func:`timeit` times ``reps`` back-to-back calls ended by one such
fence, so the per-call launch overhead pipelines the way it does in
production (the batching queues also issue back-to-back batches).

The JAX package's persistent compile cache (``enable_compile_cache``) has
no counterpart: the port compiles no programs at run time.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree: Any) -> None:
    """Wait until every CUDA tensor in ``tree`` (nested lists, tuples and
    dicts) is computed: one ``torch.cuda.synchronize`` a device.  CPU
    tensors and anything that is not a tensor pass through."""
    devices = []
    for leaf in _leaves(tree):
        if leaf.is_cuda and leaf.device not in devices:
            devices.append(leaf.device)
    for device in devices:
        torch.cuda.synchronize(device)


def timeit(fn: Callable, *args, min_time_s: float = 1.5, trials: int = 2) -> float:
    """Best-of-``trials`` mean seconds per call of ``fn(*args)``.

    The first call (kernel library loads, allocator warm-up) is excluded.
    Each trial times ``reps`` back-to-back calls ending in one :func:`sync`
    of the last result; ``reps`` grows until a trial takes at least
    ``min_time_s``, so the fence's fixed cost is a small share of it.
    """
    sync(fn(*args))

    def trial(reps: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = fn(*args)
        sync(out)
        return time.perf_counter() - t0

    reps = 1
    total = trial(reps)
    while total < min_time_s:
        reps = max(reps * 2, int(reps * min_time_s / max(total, 1e-6)) + 1)
        total = trial(reps)
    best = total
    for _ in range(trials - 1):
        best = min(best, trial(reps))
    return best / reps
