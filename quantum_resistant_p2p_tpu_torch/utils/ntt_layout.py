"""The register layout of the half-warp NTT that K7 (``csrc/mldsa.cuh``)
and K3's fused NTT (``csrc/mlkem.cuh``) share, and the zeta tables their
kernels load.

A half-warp transforms one polynomial of 256 coefficients, 16 a lane.  In
stage A lane t's register j holds coefficient t + 16 j, in stage B 16 t + j
(:func:`coefficient`).  A layer pairs registers j and j + h of one lane,
whose zeta sits at slot :func:`slot` of the stage's table: stage A's layers
have length 16 h, so their zetas are the same in every lane; stage B's have
length h, one zeta a lane.  The two wrappers (``sig/mldsa_cuda.py``,
``kem/mlkem_cuda.py``) pass their own q, zetas and stage halves.
"""

from __future__ import annotations

import numpy as np

#: coefficients a polynomial; registers a lane and lanes a polynomial
N = 256
REGS = LANES = 16


def coefficient(stage: int, lane: int, reg: int) -> int:
    """The coefficient that register ``reg`` of ``lane`` holds in stage 0
    (A) or 1 (B)."""
    return lane + LANES * reg if stage == 0 else REGS * lane + reg


def slot(h: int, reg: int) -> int:
    """Table slot of the zeta of the pair (reg, reg + h) of layer h."""
    return 8 // h - 1 + reg // (2 * h)


def zeta_indices(stage_halves: tuple[tuple[int, ...], ...], inverse: bool = False,
                 what: str = "NTT") -> list[np.ndarray]:
    """Index into the zetas of every (slot, lane) of each stage, one
    ``(slots, 16)`` int64 array a stage, where ``stage_halves[stage]`` lists
    the stage's h in forward order.  The butterfly on coefficients i and
    i + len of group g = i // (2 len) takes zeta 128 / len + g forward and
    2 * 128 / len - 1 - g inverse, as the plain versions number them."""
    idx = []
    for stage, halves in enumerate(stage_halves):
        at_stage = np.full((16 // halves[-1] - 1, LANES), -1, dtype=np.int64)
        for h in halves:
            length = h * (LANES if stage == 0 else 1)
            groups = N // (2 * length)
            for lane in range(LANES):
                for reg in range(REGS):
                    if reg & h:
                        continue
                    g = coefficient(stage, lane, reg) // (2 * length)
                    k = 2 * groups - 1 - g if inverse else groups + g
                    at = (slot(h, reg), lane)
                    if at_stage[at] not in (-1, k):
                        raise AssertionError(f"{what} schedule: two zetas at slot {stage, at}")
                    at_stage[at] = k
        if (at_stage < 0).any():
            raise AssertionError(f"{what} schedule: a slot without a zeta")
        idx.append(at_stage)
    if not (idx[0] == idx[0][:, :1]).all():
        raise AssertionError(f"{what} schedule: stage A's zetas differ across lanes")
    return idx


def shoup(w: np.ndarray, q: int) -> np.ndarray:
    """Shoup companions floor(w * 2^32 / q) of the kernel's products."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)
