#!/usr/bin/env python3
"""K12 and K13 (csrc/sha2.cu) at the SPHINCS+ shapes, and SPHINCS+-SHA2
sign and verify batches, timed on one GPU for the port found under ROOT, so
that a change and its parent can be compared in one call, a process each:

    git archive <parent> quantum_resistant_p2p_tpu_torch | tar -x -C build/parent
    python3 chip_sha2_ab.py build/parent parent OUT_DIR
    python3 chip_sha2_ab.py . change OUT_DIR
    (then change and parent again)

The timers (``cuda_ms``, ``device_ms``), the plain absorb and the shapes
(``SHA2_SHAPES``) are those of chip_smoke.py, beside this file.  Each shape
runs through the wrapper's ``compress`` (its own path) and, where the port
can force a path (``sha256_cuda.launch(width, ..., path)``), through each
path forced; every output is held bitwise to the plain absorb.  The
batches: SPHINCS+-SHA2-128f keygen, sign and verify at B = 1024, and
SPHINCS+-SHA2-128s verify at B = 2048 (signed in chunks of 256), every
signature verified and one with a flipped byte refused; timed with CUDA
events around each call, so the host's work to launch its kernels counts
wherever the GPU waits for it.  Last, the wrapper's own host time: the
host clock over 400 ``compress`` calls of one row (1 or 10 blocks), fewer
than the launch queue holds, so the host sets the pace.  Writes
OUT_DIR/TAG.json and prints a line a measurement.  Without a GPU it exits 2.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import chip_smoke

SIGN_SET, SIGN_BATCH = "SPHINCS+-SHA2-128f-simple", 1024
VERIFY_SET, VERIFY_BATCH, VERIFY_CHUNK = "SPHINCS+-SHA2-128s-simple", 2048, 256


def kernel_rows(torch, np, sha256, sha256_cuda, sha512, sha512_cuda) -> list:
    rng = np.random.default_rng(2026)
    forced = hasattr(sha256_cuda, "launch") and hasattr(sha256_cuda, "ENTRIES")
    rows = []
    for name, lanes, per, nblocks, what in chip_smoke.SHA2_SHAPES:
        mod, kmod, width = ((sha256, sha256_cuda, 64) if name.startswith("sha256")
                            else (sha512, sha512_cuda, 128))
        lo, hi = (0, 2**32) if width == 64 else (-2**63, 2**63)
        states = torch.from_numpy(rng.integers(lo, hi, size=(lanes, 8), dtype=np.int64)).cuda()
        blocks = torch.from_numpy(rng.integers(0, 256, size=(lanes * per, nblocks * width),
                                               dtype=np.uint8)).cuda()
        want = chip_smoke.plain_absorb(mod, states, blocks, per, width)
        runs = [("compress", lambda k=kmod.compress, s=states, b=blocks, r=per: k(s, b, r))]
        if forced:
            runs += [(p, lambda s=states, b=blocks, r=per, w=width, p=p:
                      sha256_cuda.launch(w, s, b, r, p)[0]) for p in sha256_cuda.PATHS]
        for how, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{name} {what} ({how}): differs from the plain absorb")
            row = {"name": name, "what": what, "how": how,
                   "device_ms": chip_smoke.device_ms(torch, fn, 20),
                   "ms": chip_smoke.cuda_ms(torch, fn, 20)}
            rows.append(row)
            print(f"[sha2] {name} {what}, {how}: device {row['device_ms']:.4f} ms, "
                  f"with the launch {row['ms']:.4f} ms", flush=True)
    return rows


def batches(torch, np, sphincs, slhdsa_params) -> dict:
    out = {}
    p, seeds, r, digest = chip_smoke.sphincs_batch_inputs(torch, np, slhdsa_params, SIGN_SET,
                                                          SIGN_BATCH)
    kg, sign, verify = sphincs.get(p.name)
    pk, sk = kg(*seeds)
    sig = sign(sk, r, digest)
    check(torch, p, verify, pk, digest, sig)
    for what, fn, reps in (("keygen", lambda: kg(*seeds), 5),
                           ("sign", lambda: sign(sk, r, digest), 9),
                           ("verify", lambda: verify(pk, digest, sig), 9)):
        out[f"128f_{what}_ms"] = chip_smoke.cuda_ms(torch, fn, reps)

    p, seeds, r, digest = chip_smoke.sphincs_batch_inputs(torch, np, slhdsa_params, VERIFY_SET,
                                                          VERIFY_BATCH)
    kg, sign, verify = sphincs.get(p.name)
    pk, sk = kg(*seeds)
    sig = torch.cat([sign(sk[i:i + VERIFY_CHUNK], r[i:i + VERIFY_CHUNK],
                          digest[i:i + VERIFY_CHUNK])
                     for i in range(0, VERIFY_BATCH, VERIFY_CHUNK)])
    check(torch, p, verify, pk, digest, sig)
    out["128s_verify_ms"] = chip_smoke.cuda_ms(torch, lambda: verify(pk, digest, sig), 9)
    print("[batches] " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    return out


def wrapper_host_us(torch, np, sha256_cuda, sha512_cuda) -> dict:
    """Host microseconds a ``compress`` call, median of 5 loops of 400."""
    rng = np.random.default_rng(7)
    out = {}
    for name, kmod, width, nblocks in (("sha256_1x1", sha256_cuda, 64, 1),
                                       ("sha256_1x10", sha256_cuda, 64, 10),
                                       ("sha512_1x10", sha512_cuda, 128, 10)):
        states = torch.from_numpy(rng.integers(0, 2**31, size=(1, 8), dtype=np.int64)).cuda()
        blocks = torch.from_numpy(rng.integers(0, 256, size=(1, nblocks * width),
                                               dtype=np.uint8)).cuda()
        loops = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(400):
                kmod.compress(states, blocks)
            loops.append(1e6 * (time.perf_counter() - t0) / 400)
        torch.cuda.synchronize()
        out[name] = sorted(loops[1:])[2]  # the first loop warms up
    print("[host] compress, host us a call: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()),
          flush=True)
    return out


def check(torch, p, verify, pk, digest, sig) -> None:
    bad = sig.clone()
    bad[:, p.n + 7] ^= 1
    ok, refused = verify(pk, digest, sig), verify(pk, digest, bad)
    torch.cuda.synchronize()
    if not bool(ok.all()) or bool(refused.any()):
        raise SystemExit(f"{p.name}: {int(ok.sum())} of {ok.numel()} verified, "
                         f"{int(refused.sum())} flipped signatures verified")


def main() -> int:
    if len(sys.argv) != 4:
        print(__doc__, file=sys.stderr)
        return 2
    root, tag, out_dir = Path(sys.argv[1]).resolve(), sys.argv[2], Path(sys.argv[3])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_sha2_ab: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from quantum_resistant_p2p_tpu_torch.core import sha256, sha256_cuda, sha512, sha512_cuda
    from quantum_resistant_p2p_tpu_torch.sig import slhdsa_params, sphincs
    from quantum_resistant_p2p_tpu_torch.utils import cuda
    if Path(sha256_cuda.__file__).resolve().parents[2] != root:
        raise SystemExit(f"the port was imported from {sha256_cuda.__file__}, not {root}")
    card = chip_smoke.smi("name,power.limit")
    t0 = time.perf_counter()
    cuda.build(("sha2",))
    print(f"[{tag}] {root} on {card}; sha2 built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    result = {"tag": tag, "root": str(root), "card": card,
              "kernels": kernel_rows(torch, np, sha256, sha256_cuda, sha512, sha512_cuda),
              "batches": batches(torch, np, sphincs, slhdsa_params),
              "wrapper_host_us": wrapper_host_us(torch, np, sha256_cuda, sha512_cuda)}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
