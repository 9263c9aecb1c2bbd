#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quantum_resistant_p2p_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1) if anything is wrong:

1. build    compile csrc/sponge.cu and csrc/mlkem.cu with nvcc (sm_90a),
            both at once, and print the ptxas register/spill summary and
            the SASS of K1's Keccak round loop;
2. kernels  run every kernel and its plain PyTorch version on the GPU at
            the shapes of the batch-4096 ML-KEM-768 path, require bitwise
            equality, and time both with CUDA events;
3. kat      tests/vectors/mlkem_768.json through keygen/encaps/decaps on
            the GPU, byte-exact, implicit rejection included;
4. serve    BatchedKEM over get_kem("ML-KEM-768") (GPU backend) with
            max_batch 4096 and max_wait 2 ms: 1024 concurrent clients each
            run keygen -> encaps -> decaps, then encapsulate twice to one
            server key (the operand cache must hit); all secrets agree;
5. flagship entry(): batched ML-KEM-768 encaps at B = 4096, checked
            against the CPU path on its first rows, timed with CUDA events;
6. profile  torch.profiler over five flagship batches: device time per
            kernel, and the device busy share of that window from its
            trace (after the counts are read).

Every kernel wrapper counts its launches.  The counts are set to 0 just
before phase 4 and read just after it, then again for phase 5: every
kernel must have run in phase 4, and every kernel that encaps runs in
phase 5.  The last three lines of output are the card's name and power limit
(nvidia-smi), one JSON object with key "kernels", and the result line
{"ok": true, "device": {...}}.  Without a GPU, or without the package
beside this file, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 4096
SERVE_CLIENTS = 1024
#: H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: Hopper SM: 4 partitions x 16 INT32 lanes
INT32_LANES_PER_SM = 64
#: one Keccak round in 32-bit instructions of sm_90, where a 3-input logic
#: op is one LOP3 and a 64-bit rotate two funnel shifts: theta's column
#: parities 5 x 2 halves x 2 LOP3, rotl(C, 1) 5 x 2 SHF, A ^= C[x-1] ^
#: rotl(C[x+1], 1) 25 x 2 LOP3; rho 24 rotates x 2 SHF; chi 25 x 2 LOP3
#: (b ^ (~b1 & b2)); iota 2.  The build phase prints the SASS round loop
#: beside it.
KECCAK_ROUND_OPS = 20 + 10 + 50 + 48 + 50 + 2
KECCAK_F_OPS = 24 * KECCAK_ROUND_OPS
#: one NTT butterfly as written in csrc/mlkem.cuh: mul, %, +, %, -, +, %
BUTTERFLY_OPS = 7
NTT_OPS = 7 * 128 * BUTTERFLY_OPS
NTT_INV_OPS = NTT_OPS + 2 * 256  # the final scaling by 3303
SRC = "quantum_resistant_p2p_tpu"
#: the kernels that one encaps launches (its forward NTTs are fused in K3)
ENCAPS_KERNELS = ("keccak_sponge", "mlkem_sample_ntt", "mlkem_prf_cbd", "mlkem_prf_cbd_ntt",
                  "mlkem_ntt_inv")


class PhaseFailed(RuntimeError):
    pass


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of fn() in ms over reps runs, after one warm run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(cuda) -> dict:
    t0 = time.perf_counter()
    seconds = cuda.build(("sponge", "mlkem"))
    print(f"[build] nvcc seconds per source {seconds}, total {time.perf_counter() - t0:.2f}")
    ptxas = {}
    for name in ("sponge", "mlkem"):
        text = cuda.library_path(name).with_suffix(".ptxas.txt").read_text()
        for fn, body in re.findall(r"Function properties for (\S+)\n(.*?)Compile time",
                                   text, flags=re.S):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            smem = re.search(r"(\d+) bytes smem", body)
            ptxas[fn] = {"registers": int(regs.group(1)),
                         "spill_stores": int(spill.group(1)), "spill_loads": int(spill.group(2)),
                         "smem": int(smem.group(1)) if smem else 0}
    for fn, info in sorted(ptxas.items()):
        print(f"[build] ptxas {fn}: {info}")
    return ptxas


def keccak_round_sass(cuda) -> dict:
    """SASS of the built K1: for each sponge kernel, the instruction count
    of the innermost loops of 100 to 400 instructions (the round loop of
    each inlined keccak_f1600, kept rolled) and their opcodes, to hold
    KECCAK_ROUND_OPS against what the card runs."""
    exe = Path(cuda.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(exe), "-sass", str(cuda.library_path("sponge"))], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    out = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)", text, flags=re.S):
        labels, insns = {}, []  # label -> address of the instruction after it; (address, text)
        for line in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if lab:
                labels[lab.group(1)] = None
            elif ins:
                insns.append((int(ins.group(1), 16), ins.group(2)))
                labels.update({k: insns[-1][0] for k, v in labels.items() if v is None})
        index = {addr: i for i, (addr, _) in enumerate(insns)}
        back = []  # (first, last) instruction index of every backward branch's loop
        for last, (addr, ins) in enumerate(insns):
            target = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", ins)
            if target:
                tag = target.group(1)
                to = labels.get(tag) if tag.startswith(".") else int(tag, 16)
                if to is not None and to <= addr and to in index:
                    back.append((index[to], last))
        loops = []
        for first, last in back:
            innermost = not any(first <= f and l < last for f, l in back)
            if innermost and 100 <= last - first + 1 <= 400:
                ops = {}
                for _, ins in insns[first:last + 1]:
                    op = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0].split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
                loops.append({"instructions": last - first + 1, "opcodes": ops})
        if loops:
            out[fn] = loops
    for fn, loops in out.items():
        print(f"[build] SASS {fn}: round loop instructions {[lp['instructions'] for lp in loops]};"
              f" opcodes of the first {loops[0]['opcodes']}")
    if not out:
        print("[build] SASS: no round loop found in the sponge kernels")
    return out


def sample_ntt_perms(torch, keccak, q, seeds) -> int:
    """Keccak-f calls K2 needs for these seeds: the blocks until the 256th
    accepted candidate, or 4 + 4 where the second pass runs."""
    buf = keccak.sponge_plain(seeds, 168, 0x1F, 672).to(torch.int32)
    t = buf.reshape(buf.shape[0], -1, 3)
    cand = torch.stack([t[..., 0] + 256 * (t[..., 1] % 16), t[..., 1] // 16 + 16 * t[..., 2]],
                       dim=-1).reshape(buf.shape[0], -1)
    cum = (cand < q).to(torch.int32).cumsum(-1)
    full = cum[:, -1] >= 256
    first = (cum >= 256).to(torch.int8).argmax(-1)
    blocks = torch.where(full, first // 112 + 1, torch.full_like(first, 8))
    return int(blocks.sum())


def phase_kernels(torch, np, keccak, keccak_cuda, mlkem, mlkem_cuda, int_rate) -> list:
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / int_rate
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    cases = []  # (name, replaces, kernel, plain, in bytes, out bytes, int32 ops, shape)
    sponge_calls = [("H", 1184, 136, 0x06, 32), ("G", 64, 72, 0x06, 64),
                    ("J", 1120, 136, 0x1F, 32)]
    for tag, length, rate, ds, out_len in sponge_calls:
        x = u8(BATCH, length)
        perms = length // rate + 1 + -(-out_len // rate) - 1
        cases.append(("keccak_sponge", f"{SRC}/core/keccak_pallas.py:177",
                      lambda x=x, r=rate, d=ds, o=out_len: keccak_cuda.sponge(x, r, d, o),
                      lambda x=x, r=rate, d=ds, o=out_len: keccak.sponge_plain(x, r, d, o),
                      x.numel() + BATCH * out_len, BATCH * perms * KECCAK_F_OPS,
                      f"{tag}: ({BATCH}, {length}) -> ({BATCH}, {out_len})"))
    seeds = u8(BATCH * 9, 34)
    cases.append(("mlkem_sample_ntt", f"{SRC}/kem/mlkem_pallas.py:97",
                  lambda: mlkem_cuda.sample_ntt(seeds), lambda: mlkem.sample_ntt_plain(seeds),
                  seeds.numel() + 4 * 256 * seeds.shape[0],
                  sample_ntt_perms(torch, keccak, mlkem.Q, seeds) * KECCAK_F_OPS,
                  f"({BATCH * 9}, 34) -> ({BATCH * 9}, 256)"))
    prf = u8(BATCH * 3, 33)
    for eta in (2, 3):
        perms = 1 if eta == 2 else 2
        for name, line, fused, kern, plain in (
                ("mlkem_prf_cbd", 159, False, mlkem_cuda.prf_cbd, mlkem.prf_cbd_plain),
                ("mlkem_prf_cbd_ntt", 315, True, mlkem_cuda.prf_cbd_ntt,
                 mlkem.prf_cbd_ntt_plain)):
            ops = prf.shape[0] * (perms * KECCAK_F_OPS + (NTT_OPS if fused else 0))
            cases.append((name if eta == 2 else f"{name}[eta=3]",
                          f"{SRC}/kem/mlkem_pallas.py:{line}",
                          lambda k=kern, e=eta: k(prf, e), lambda p=plain, e=eta: p(prf, e),
                          prf.numel() + 4 * 256 * prf.shape[0], ops,
                          f"eta={eta}: ({BATCH * 3}, 33) -> ({BATCH * 3}, 256)"))
    polys = torch.from_numpy(rng.integers(0, 3329, size=(BATCH * 3, 256),
                                          dtype=np.int32)).to(dev)
    for name, kern, plain, ops in (("mlkem_ntt", mlkem_cuda.ntt, mlkem.ntt_plain, NTT_OPS),
                                   ("mlkem_ntt_inv", mlkem_cuda.ntt_inv, mlkem.ntt_inv_plain,
                                    NTT_INV_OPS)):
        cases.append((name, f"{SRC}/kem/mlkem_pallas.py:253",
                      lambda k=kern: k(polys), lambda p=plain: p(polys),
                      2 * polys.numel() * 4, polys.shape[0] * ops,
                      f"({BATCH * 3}, 256) int32"))

    rows = []
    for name, replaces, kern, plain, nbytes, ops, shape in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise PhaseFailed(f"{name} {shape}: kernel differs from plain (max |err| {err})")
        ms, plain_ms = cuda_ms(torch, kern, 20), cuda_ms(torch, plain, 3)
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({"name": name, "replaces": replaces, "shape": shape, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes, "int32_ops": ops})
        print(f"[kernels] {name} {shape}: equal, {ms:.4f} ms (plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by})")
    return rows


def phase_kat(torch, mlkem) -> None:
    data = json.loads((ROOT / "tests" / "vectors" / "mlkem_768.json").read_text())
    p = mlkem.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8,
                            device="cuda")

    ek, dk = mlkem.keygen(p, col("d"), col("z"))
    key, ct = mlkem.encaps(p, ek, col("m"))
    key2 = mlkem.decaps(p, dk, ct)
    bad = ct.clone()
    bad[:, 0] ^= 1
    rej = mlkem.decaps(p, dk, bad)
    for i, rec in enumerate(recs):
        for name, t in (("ek", ek), ("dk", dk), ("ct", ct), ("ss", key), ("ss", key2),
                        ("ss_reject", rej)):
            got = bytes(t[i].cpu().numpy())
            want = rec.get(name)
            ok = (got.hex() == want) if want is not None else (
                hashlib.sha256(got).hexdigest() == rec[name + "_sha256"])
            if not ok:
                raise PhaseFailed(f"KAT {data['algorithm']} count {rec['count']}: {name} differs")
    print(f"[kat] {data['algorithm']}: {len(recs)} vectors byte-exact on the GPU "
          "(keygen, encaps, decaps, implicit rejection)")


async def serve(BatchedKEM, kem) -> dict:
    lat = {"keygen": [], "encaps": [], "decaps": []}

    async def timed(op, coro):
        t0 = time.perf_counter()
        out = await coro
        lat[op].append(time.perf_counter() - t0)
        return out

    with BatchedKEM(kem, max_batch=4096, max_wait_ms=2.0) as bk:
        async def client():
            pk, sk = await timed("keygen", bk.generate_keypair())
            ct, ss = await timed("encaps", bk.encapsulate(pk))
            return ss == await timed("decaps", bk.decapsulate(sk, ct))

        t0 = time.perf_counter()
        agreed = await asyncio.gather(*(client() for _ in range(SERVE_CLIENTS)))
        wall = time.perf_counter() - t0
        if not all(agreed):
            raise PhaseFailed(f"serve: {agreed.count(False)} of {SERVE_CLIENTS} secrets differ")
        server_pk, server_sk = await bk.generate_keypair()
        for _ in range(2):  # the first round fills the operand cache, the second hits it
            outs = await asyncio.gather(*(timed("encaps", bk.encapsulate(server_pk))
                                          for _ in range(SERVE_CLIENTS)))
            keys = await asyncio.gather(*(bk.decapsulate(server_sk, ct) for ct, _ in outs))
            if any(k != ss for k, (_, ss) in zip(keys, outs)):
                raise PhaseFailed("serve: a server-key secret differs")
        stats = bk.stats()
    cache = kem.opcache.stats()
    if cache["hits"] < 1:
        raise PhaseFailed(f"serve: the single-key encaps path never hit the cache {cache}")

    def pct(xs, q):
        return 1e3 * sorted(xs)[min(len(xs) - 1, int(q / 100 * len(xs)))]

    out = {"clients": SERVE_CLIENTS, "handshake_wall_s": wall,
           "handshakes_per_s": SERVE_CLIENTS / wall, "opcache": cache,
           "queues": stats,
           "latency_ms": {op: {"p50": pct(v, 50), "p99": pct(v, 99)} for op, v in lat.items()}}
    return out


def phase_flagship(torch, mlkem, entry) -> dict:
    fn, (eks, ms) = entry()
    key, ct = fn(eks, ms)
    torch.cuda.synchronize()
    if key.shape != (BATCH, 32) or ct.shape != (BATCH, mlkem.MLKEM768.ct_len):
        raise PhaseFailed(f"flagship: shapes {tuple(key.shape)} {tuple(ct.shape)}")
    ref_key, ref_ct = mlkem.encaps(mlkem.MLKEM768, eks[:16].cpu(), ms[:16].cpu())
    if not (torch.equal(key[:16].cpu(), ref_key) and torch.equal(ct[:16].cpu(), ref_ct)):
        raise PhaseFailed("flagship: GPU encaps differs from the CPU path")
    reps = 20
    ms_dev = cuda_ms(torch, lambda: fn(eks, ms), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(eks, ms)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    out = {"batch": BATCH, "ms_per_batch_cuda_events": ms_dev, "ms_per_batch_wall": wall_ms,
           "encaps_per_s": BATCH / (ms_dev / 1e3), "encaps_per_s_wall": BATCH / (wall_ms / 1e3)}
    print(f"[flagship] ML-KEM-768 encaps B={BATCH}: {ms_dev:.3f} ms/batch (CUDA events), "
          f"{out['encaps_per_s']:.0f} encaps/s; host wall {wall_ms:.3f} ms/batch")
    return out


def busy_share(events: list, window: str) -> tuple[float, float]:
    """-> (window us, device-busy us inside it) from a chrome trace: the
    union of kernel, memcpy and memset intervals clipped to the span of
    the user annotation named ``window``."""
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == window)
    lo, hi = span["ts"], span["ts"] + span["dur"]
    busy, reached = 0.0, lo
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")):
        a, b = max(a, reached), min(b, hi)
        if b > a:
            busy += b - a
            reached = b
    return hi - lo, busy


def phase_profile(torch, entry) -> dict:
    """Where a flagship batch spends device time: torch.profiler over a few
    warm batches; device time per kernel (ours and PyTorch's), and the
    device busy share of that window from its trace.  The same window is
    also timed without the profiler, which slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    plain_wall_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("flagship_window"):
                for _ in range(reps):
                    fn(*args)
                torch.cuda.synchronize()
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        window_us, busy_us = busy_share(json.loads(trace.read_text())["traceEvents"],
                                        "flagship_window")
    device_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                 and ev.key != "flagship_window"}  # the annotation's own span on the GPU
    total_us = sum(device_us.values())
    ours = ("::sponge_kernel<", "::sample_ntt_kernel(", "::prf_cbd_kernel<", "::ntt_kernel<")
    ours_us = sum(v for k, v in device_us.items() if any(o in k for o in ours))
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:12]
    out = {"batches": reps, "window_ms_per_batch": window_us / reps / 1e3,
           "busy_ms_per_batch": busy_us / reps / 1e3, "device_busy_share": busy_us / window_us,
           "unprofiled_wall_ms_per_batch": plain_wall_us / reps / 1e3,
           "device_ms_per_batch": total_us / reps / 1e3,
           "port_kernels_ms_per_batch": ours_us / reps / 1e3, "device_kinds": len(device_us),
           "top_device_ms_per_batch": [[k, v / reps / 1e3] for k, v in top]}
    print(f"[profile] flagship batch under the profiler: window {out['window_ms_per_batch']:.3f}"
          f" ms, device busy {out['busy_ms_per_batch']:.3f} ms (busy share "
          f"{out['device_busy_share']:.3f}, from the trace); without the profiler the same "
          f"window takes {out['unprofiled_wall_ms_per_batch']:.3f} ms per batch")
    print(f"[profile] kernel time {out['device_ms_per_batch']:.3f} ms per batch, of which the "
          f"port's kernels {out['port_kernels_ms_per_batch']:.3f} ms; {len(device_us)} kinds")
    for name, ms in out["top_device_ms_per_batch"]:
        print(f"[profile]   {ms:.4f} ms  {name[:110]}")
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from quantum_resistant_p2p_tpu_torch.core import keccak, keccak_cuda
        from quantum_resistant_p2p_tpu_torch.entry import entry
        from quantum_resistant_p2p_tpu_torch.kem import mlkem, mlkem_cuda
        from quantum_resistant_p2p_tpu_torch.provider import BatchedKEM, get_kem
        from quantum_resistant_p2p_tpu_torch.utils import cuda
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}", file=sys.stderr)
        return 2

    card = smi("name,power.limit")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}; {sms} SMs, "
          f"max SM clock {max_sm_mhz:.0f} MHz -> int32 peak {int_rate / 1e12:.2f} Tops/s")

    wrappers = {"keccak_sponge": keccak_cuda.sponge, "mlkem_sample_ntt": mlkem_cuda.sample_ntt,
                "mlkem_prf_cbd": mlkem_cuda.prf_cbd, "mlkem_prf_cbd_ntt": mlkem_cuda.prf_cbd_ntt,
                "mlkem_ntt": mlkem_cuda.ntt, "mlkem_ntt_inv": mlkem_cuda.ntt_inv}
    sources = {"keccak_sponge": "quantum_resistant_p2p_tpu_torch/csrc/sponge.cu"}

    try:
        ptxas = phase_build(cuda)
        sass = keccak_round_sass(cuda)
        rows = phase_kernels(torch, np, keccak, keccak_cuda, mlkem, mlkem_cuda, int_rate)
        phase_kat(torch, mlkem)

        def reset():
            for w in wrappers.values():
                w.launches = 0

        def read(phase, expected):
            counts = {name: w.launches for name, w in wrappers.items()}
            print(f"[launches] {phase}: {counts}")
            idle = [name for name in expected if counts[name] == 0]
            if idle:
                raise PhaseFailed(f"{phase}: kernels not launched on the main path: {idle}")
            return counts

        reset()
        kem = get_kem("ML-KEM-768")
        if kem.backend != "cuda":
            raise PhaseFailed(f"serve: default backend is {kem.backend}")
        served = asyncio.run(serve(BatchedKEM, kem))
        launches = {"serve": read("serve", wrappers)}
        print(f"[serve] {SERVE_CLIENTS} clients: {served['handshakes_per_s']:.1f} handshakes/s "
              f"(keygen+encaps+decaps, {served['handshake_wall_s']:.3f} s); "
              f"latency ms {served['latency_ms']}; opcache {served['opcache']}")
        for op, st in served["queues"].items():
            print(f"[serve] {op} queue: {st}")
        reset()
        flagship = phase_flagship(torch, mlkem, entry)
        launches["flagship"] = read("flagship", ENCAPS_KERNELS)

        # launches of one batched call of each op (after the counted window)
        def count(call):
            reset()
            out = call()
            return out, {name: w.launches for name, w in wrappers.items()}

        p = mlkem.MLKEM768
        d = torch.zeros((BATCH, 32), dtype=torch.uint8, device="cuda")
        per_op = {}
        (ek, dk), per_op["keygen"] = count(lambda: mlkem.keygen(p, d, d))
        (_, ct), per_op["encaps"] = count(lambda: mlkem.encaps(p, ek, d))
        _, per_op["decaps"] = count(lambda: mlkem.decaps(p, dk, ct))
        print(f"[launches] per batched op: {per_op}")
        profiled = phase_profile(torch, entry)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    # one entry per kernel wrapper at its main-path shapes; the sponge's
    # three calls (H, G, J) are summed, eta = 3 stays in the detail line
    kernels = []
    for name in wrappers:
        mine = [r for r in rows if r["name"] == name]
        nbytes, ops = sum(r["bytes"] for r in mine), sum(r["int32_ops"] for r in mine)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / int_rate
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, "quantum_resistant_p2p_tpu_torch/csrc/mlkem.cu"),
            "replaces": mine[0]["replaces"],
            "launches": launches["serve"][name] + launches["flagship"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "shapes": [r["shape"] for r in mine]})
    print(json.dumps({"detail": {"ptxas": ptxas, "keccak_round_sass": sass,
                                 "kernel_rows": rows, "serve": served, "flagship": flagship,
                                 "launches": launches, "launches_per_op": per_op,
                                 "profile": profiled}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
