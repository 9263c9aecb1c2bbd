#!/usr/bin/env python3
"""The port's plain Keccak-f and its "cpu" ML-DSA-65 sign at B = 1, timed on
this machine's CPU with one PyTorch thread, for the port found under each
ROOT, so that a change and its parent can be compared on one host, each
run in a fresh process and the roots in the order given:

    git archive <parent> | tar -x -C build/parent
    python3 cpu_sign_ab.py build/parent . . build/parent

Per run: ``keccak_f1600`` on one all-zero state, 400 times after 5 warm
calls (ms a permutation), then a keypair from a pinned ``os.urandom`` and
SIGNS signatures through ``MLDSASignature(3, "cpu").sign_batch`` with fixed
(message, rnd) pairs, so every root runs the same rejection-loop attempts;
each signature verifies.  Prints one line a run: the root, ms a
permutation, and the signs' median, least and most seconds.  No GPU is
used or needed.
"""

from __future__ import annotations

import subprocess
import sys

SIGNS = 15

RUN = r"""
import hashlib, os, statistics, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from quantum_resistant_p2p_tpu_torch.core import keccak
from quantum_resistant_p2p_tpu_torch.provider.sig_providers import MLDSASignature

state = torch.zeros((1, 25), dtype=torch.int64)
for _ in range(5):
    state = keccak.keccak_f1600(state)
t0 = time.perf_counter()
for _ in range(400):
    state = keccak.keccak_f1600(state)
perm_ms = (time.perf_counter() - t0) / 400 * 1e3
dsa = MLDSASignature(3, backend="cpu")
urandom = os.urandom
os.urandom = lambda n: hashlib.shake_256(b"cpu_sign_ab key").digest(n)
pk, sk = dsa.generate_keypair()
os.urandom = urandom
sks = np.frombuffer(sk, np.uint8)[None]
times = []
for i in range(int(sys.argv[1])):
    msg, rnd = b"message %d" % i, hashlib.sha256(b"rnd %d" % i).digest()
    t0 = time.perf_counter()
    sig = dsa.sign_batch(sks, [msg], rnd=[rnd])[0]
    times.append(time.perf_counter() - t0)
    assert dsa.verify(pk, msg, sig)
print(f"{perm_ms:.4f} {statistics.median(times):.4f} {min(times):.4f} {max(times):.4f}")
"""


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__)
        return 2
    for root in roots:
        out = subprocess.run([sys.executable, "-c", RUN, str(SIGNS)], cwd=root,
                             capture_output=True, text=True, check=True)
        perm_ms, median, least, most = out.stdout.split()
        print(f"{root}: keccak_f1600 at B = 1 {perm_ms} ms a permutation; ML-DSA-65 sign on "
              f"\"cpu\" at B = 1, {SIGNS} signs: median {median} s (least {least}, most {most})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
