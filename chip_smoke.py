#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quantum_resistant_p2p_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1) if anything is wrong:

1. build     compile csrc/sponge.cu, csrc/mlkem.cu, csrc/mldsa.cu,
             csrc/chacha.cu, csrc/frodo.cu and csrc/sha2.cu with nvcc
             (sm_90a), all at once, and print the ptxas register/spill
             summary, the SASS of K1's Keccak round loop, K8's opcodes and
             those of K12's and K13's block loops (their bound counts them);
2. kernels   run every kernel and its plain PyTorch version on the GPU at
             the shapes of the batch-4096 ML-KEM-768 and ML-DSA-65 paths,
             K1 with per-row lengths on 4096 transcripts of up to 3458
             bytes, K8 on 4096 x 65 and 4096 x 1025 ChaCha20 blocks, K9 and
             K10 at FrodoKEM-640-SHAKE, B = 1024 (BASELINE.json config 3's
             batch) and FrodoKEM-1344-SHAKE, B = 256, and K11 at the sample
             count of that 640 encaps batch, K12 at a 128f chain step
             (1024 x 8 x 35 rows) and at the 128f FORS leaves (1024 x 33 x 64)
             of B = 1024, K13 at 192f's first FORS level of B = 256
             (256 x 33 x 128), both over 10-block rows (a WOTS public key's
             T_l) too; require bitwise equality, and time both with CUDA
             events (K11 beside torch.searchsorted);
3. kat       tests/vectors/mlkem_768.json through keygen/encaps/decaps,
             tests/vectors/mldsa_65.json through keygen/sign/verify and the
             six tests/vectors/frodo_*.json through keygen/encaps/decaps on
             the GPU, byte-exact; the RFC 8439 §2.3.2 block, §2.5.2 Poly1305
             and §2.8.2 AEAD vectors through core.chacha on the GPU; the
             six tests/vectors/slhdsa_*.json through keygen/sign/verify and
             the keygen records of acvp_slhdsa128f_fixture.json on the GPU;
             the health gate (ML-KEM-768 KAT, ML-DSA-65 round trip, fused
             keygen_sign, AEAD KAT, FrodoKEM-640-SHAKE KAT, FrodoKEM-640-AES
             round trip, SPHINCS+-SHA2-128s and -128f round trips) on the
             "cuda" providers with their "cpu" twins;
4. serve     BatchedKEM over get_kem("ML-KEM-768") (GPU backend) with
             max_batch 4096 and max_wait 2 ms: 1024 concurrent clients each
             run keygen -> encaps -> decaps, then encapsulate twice to one
             server key (the operand cache must hit); all secrets agree,
             and a tampered ciphertext does not give the secret;
5. flagship  entry(): batched ML-KEM-768 encaps at B = 4096, checked
             against the CPU path on its first rows, timed with CUDA events;
6. sig serve BatchedSignature over get_signature("ML-DSA-65") (GPU
             backend), max_batch 4096, max_wait 2 ms: one server key made
             in the phase, 1024 concurrent clients sign with it twice (the
             operand cache must miss once, then hit), then 1024 verify those
             signatures (all True) and one flipped byte (False);
7. sig flagship  sign_mu_pre and verify_mu_pre at B = 4096 over one
             ML-DSA-65 key's precompute, timed with CUDA events, with the
             number of attempts the sign loop ran; the CPU path builds the
             precompute from the key itself, which must equal the GPU's,
             and signs and verifies the first rows the same;
8. handshake the default handshake pair, ML-KEM-768 + ML-DSA-65 with
             ChaCha20-Poly1305 as the AEAD, trip by trip as the reference's
             SecureMessaging runs it: 1024 initiators (own ML-DSA-65 keys,
             made in the phase by one batched keygen) and one gateway,
             through one BatchedFused a side: keygen_sign, then
             encaps_verify_sign, then decaps_verify_sign, then the
             gateway's verify of the confirm through BatchedSignature;
             every secret agrees, the first signatures verify on the CPU,
             and one more session whose init transcript is changed on the
             way is refused (ok False);
9. data plane session keys by HKDF-SHA256 as derive_message_key does; 1024
             clients BatchedAEAD.encrypt a 256-byte message and the gateway
             decrypts it (a tampered frame fails); then one seal_batch and
             open_batch of 4096 messages of 4 KiB;
10. frodo serve  phase 4 over get_kem("FrodoKEM-640-SHAKE"): a gateway
             serving FrodoKEM peers;
11. frodo batch  BASELINE.json config 3: encaps at B = 1024 of
             FrodoKEM-640-AES and FrodoKEM-640-SHAKE, to 1024 keys (K10,
             resp. the AES chunk loop) and to one key over its precompute
             (encaps_pre), checked against the CPU path on the first rows,
             timed with CUDA events and the host clock;
12. sphincs serve  BASELINE.json config 4's "SPHINCS+-SHA2-128s verify":
             2048 SPHINCS+-SHA2-128s keys from one batched keygen, one
             message signed under each by sign_batch (in chunks that fit the
             device's free memory), then 2048 asyncio clients verify through
             one BatchedSignature (max_batch 4096, max_wait 2 ms); all
             verify, a flipped byte does not, the "cpu" twin verifies one;
13. sphincs batch  keygen, sign_digest and verify_digest at B = 1024 of
             SPHINCS+-SHA2-128f and at B = 256 of SPHINCS+-SHA2-192f (its
             H and T_l run K13), timed with CUDA events; all verify, a
             flipped byte does not; then the memory rule of sign_batch's
             chunks: every set's device bytes a row in flight at the peak
             of one sign_digest (B = 16) within sphincs.BYTES_PER_ROW, and
             one SPHINCS+-SHA2-256s sign_batch of three chunks whose peak
             stays within the provider's budget, every signature verified;
14. profile  torch.profiler over the KEM flagship, one sign batch, five
             verify batches, one 4096 x 4 KiB seal batch, one
             FrodoKEM-640-SHAKE encaps batch of 1024 keys, one 128f sign
             batch of 1024 and one 128s verify batch of 2048: device time
             per kernel, launches, and the device busy share of each window
             from its trace (after the counts are read).

Every kernel wrapper counts its launches.  The counts are set to 0 just
before each of phases 4-13 and read just after it: every ML-KEM kernel
must have run in phase 4, every kernel that encaps runs in phase 5, every
ML-DSA kernel and K1 in phase 6, K1 and K7 in phase 7, every kernel but
K8 (K1 with per-row lengths included) in phase 8, K8 in phase 9, K1 and
K9-K11 in phase 10, K1, K10 and K11 in phase 11, K12 in phase 12 and in
each set of phase 13, and K13 in phase 13's 192f run and in its memory
check.  The last three lines of output are the card's name and power
limit (nvidia-smi), one JSON object with key "kernels", and the result
line {"ok": true, "device": {...}}.  Without a GPU, or without the package
beside this file, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import re
import statistics
import hmac
import os
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 4096
SERVE_CLIENTS = 1024
#: ML-DSA-65 widths of the kernel phase: ExpandA of a 1024-key keygen
#: batch (30 polynomials a key), ExpandS of it (11), and one sign attempt's
#: widest transform at B = 4096 (k = 6 polynomials a lane)
KEYGEN_KEYS = 1024
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
#: one NTT butterfly mod 8380417 as the work needs it, Harvey's lazy
#: butterfly on values in [0, 4q): a Shoup product left in [0, 2q)
#: (umulhi and two multiply-adds), 2q taken off the other input where it
#: is >= 2q (subtract, unsigned min), then the sum and the difference + 2q.
#: csrc/mldsa.cuh as written keeps every value canonical and spends 11.
MLDSA_BUTTERFLY_OPS = 3 + 2 + 2
#: + the final reduction of each coefficient from [0, 4q) to [0, q)
MLDSA_NTT_OPS = 8 * 128 * MLDSA_BUTTERFLY_OPS + 256 * 4
#: + the final Shoup scaling by 8347681 and its subtraction of q
MLDSA_NTT_INV_OPS = 8 * 128 * MLDSA_BUTTERFLY_OPS + 256 * 5
SRC = "quantum_resistant_p2p_tpu"
SOURCES = ("sponge", "mlkem", "mldsa", "chacha", "frodo", "sha2")
#: the kernels that one encaps launches (its forward NTTs are fused in K3)
ENCAPS_KERNELS = ("keccak_sponge", "mlkem_sample_ntt", "mlkem_prf_cbd", "mlkem_prf_cbd_ntt",
                  "mlkem_ntt_inv")
KEM_KERNELS = ENCAPS_KERNELS + ("mlkem_ntt",)
#: the kernels the ML-DSA serve phase (keygen, sign, verify) runs, and the
#: ones sign and verify over a precompute run
SIG_KERNELS = ("keccak_sponge", "mldsa_rej_ntt", "mldsa_rej_bounded", "mldsa_ntt",
               "mldsa_ntt_inv")
SIG_PRE_KERNELS = ("keccak_sponge", "mldsa_ntt", "mldsa_ntt_inv")
#: the kernels of the handshake phase (keys are made in it, so K6 too)
HANDSHAKE_KERNELS = KEM_KERNELS + SIG_KERNELS[1:] + ("keccak_sponge_varlen",)
#: one ChaCha20 block: 80 quarter rounds of 4 adds, 4 xors and 4 rotates,
#: then 16 feedforward adds (976 instructions); 48 bytes in, 64 out.  The
#: xors (LOP3) and the rotates (one funnel shift, SHF, each) run only on the
#: 64-lane integer pipe; the adds can run as IMAD on the FMA pipe beside
#: them, so the integer pipe's 640 set the bound.  The build phase prints
#: K8's SASS opcodes beside it (H100: 329 IMAD, 320 LOP3, 316 SHF).
CHACHA_BLOCK_OPS = 80 * 8
CHACHA_BLOCK_BYTES = 48 + 64
#: the longest transcript the fused programs hash: tr (64) || 0 0 ||
#: the ML-KEM-768 init template (2 x 1184 hex + 1024 of JSON room)
VARLEN_LMAX = 64 + 2 + 2 * 1184 + 1024
AEAD = "ChaCha20-Poly1305"
HANDSHAKES = 1024
#: max_batch of the handshake's queues
HANDSHAKE_BATCH = 4096
GATEWAY = "gateway"
#: the bulk seal batch of phase 9: 4096 messages of 4 KiB (with a 256-byte
#: AAD bucket, 65 ChaCha20 blocks a row: the Poly1305 key and 64 of stream)
SEAL_BATCH, SEAL_LEN = 4096, 4096
#: BASELINE.json config 3 is "FrodoKEM-640-AES batch=1024"
FRODO_BATCH = 1024
FRODO_SHAKE, FRODO_AES = "FrodoKEM-640-SHAKE", "FrodoKEM-640-AES"
#: the widest set's products in the kernel phase, at a quarter of that batch
FRODO_WIDE = ("FrodoKEM-1344-SHAKE", 256)
FRODO_VECTORS = ("640_aes", "640_shake", "976_aes", "976_shake", "1344_aes", "1344_shake")
#: the kernels of the Frodo serve phase (keygen K9, multi-key encaps and
#: decaps K10) and of the batch phase (encaps only)
FRODO_KERNELS = ("keccak_sponge", "frodo_a_times_s", "frodo_s_times_a", "frodo_cdf_sample")
FRODO_ENCAPS_KERNELS = ("keccak_sponge", "frodo_s_times_a", "frodo_cdf_sample")
SLH_VECTORS = ("128f", "128s", "192f", "192s", "256f", "256s")
#: BASELINE.json config 4's SPHINCS+ half, "SPHINCS+-SHA2-128s verify":
#: keys made and signed in one batch each, then verified by as many clients
SLH_SERVE, SLH_SERVE_KEYS = "SPHINCS+-SHA2-128s-simple", 2048
#: the batch phase: the fast 128-bit set, and a SHA-512 set (K13 on its path)
SLH_BATCHES = (("SPHINCS+-SHA2-128f-simple", 1024), ("SPHINCS+-SHA2-192f-simple", 256))
SLH_HEALTH = ("SPHINCS+-SHA2-128s-simple", "SPHINCS+-SHA2-128f-simple")
#: the memory check: every set's bytes a row in flight at this batch, then
#: one sign_batch of the widest set (360,448 FORS rows a signature, n = 32,
#: SHA-512 H and T_l) over a batch that needs SLH_CHUNKS chunks
SLH_ROW_BATCH, SLH_WIDEST, SLH_CHUNKS = 16, "SPHINCS+-SHA2-256s-simple", 3
#: SASS opcodes of K12/K13's block loop that do not issue on the 64-lane
#: integer pipe: IMAD goes to the FMA pipe beside it (K8's finding), U*
#: run once a warp on the uniform datapath, memory and branches elsewhere
NON_INT_PIPE = ("IMAD", "LDG", "STG", "BRA", "NOP", "EXIT")


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
    seconds = cuda.build(SOURCES)
    print(f"[build] nvcc seconds per source {seconds}, total {time.perf_counter() - t0:.2f}")
    ptxas = {}
    for name in SOURCES:
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


def sass_loops(cuda, lib: str) -> dict:
    """SASS of a built library: for each kernel, the instruction count and
    opcodes of every innermost loop (the body between a backward branch and
    its target)."""
    exe = Path(cuda.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(exe), "-sass", str(cuda.library_path(lib))], check=True,
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
            if not any(first <= f and l < last for f, l in back):  # innermost
                ops = {}
                for _, ins in insns[first:last + 1]:
                    op = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0].split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
                loops.append({"instructions": last - first + 1, "opcodes": ops})
        if loops:
            out[fn] = loops
    return out


def keccak_round_sass(cuda) -> dict:
    """SASS of the built K1: for each sponge kernel, the instruction count
    of the innermost loops of 100 to 400 instructions (the round loop of
    each inlined keccak_f1600, kept rolled) and their opcodes, to hold
    KECCAK_ROUND_OPS against what the card runs."""
    out = {}
    for fn, loops in sass_loops(cuda, "sponge").items():
        rounds = [lp for lp in loops if 100 <= lp["instructions"] <= 400]
        if rounds:
            out[fn] = rounds
    for fn, loops in out.items():
        print(f"[build] SASS {fn}: round loop instructions {[lp['instructions'] for lp in loops]};"
              f" opcodes of the first {loops[0]['opcodes']}")
    if not out:
        print("[build] SASS: no round loop found in the sponge kernels")
    return out


def kernel_sass_opcodes(cuda, lib: str, kernel: str) -> dict:
    """Opcode counts of the SASS of one kernel of a built library (K8 is
    fully unrolled: its instruction count is its work)."""
    exe = Path(cuda.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(exe), "-sass", str(cuda.library_path(lib))], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    ops = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)", text, flags=re.S):
        if kernel in fn:
            for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", body):
                op = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0].split(".")[0]
                ops[op] = ops.get(op, 0) + 1
    print(f"[build] SASS {kernel}: {sum(ops.values())} instructions, opcodes "
          f"{dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    return ops


def sha2_block_sass(cuda) -> dict:
    """K12 and K13: the opcodes of the loop over a row's message blocks (one
    fully unrolled compression) and the integer-pipe instructions it issues,
    which set the kernels' bound by operations."""
    out = {}
    for fn, loops in sass_loops(cuda, "sha2").items():
        kernel = next((k for k in ("sha256_kernel", "sha512_kernel") if k in fn), None)
        if kernel is not None:
            body = max(loops, key=lambda lp: lp["instructions"])
            ops = sum(c for op, c in body["opcodes"].items()
                      if not (op.startswith("U") or op in NON_INT_PIPE))
            out[kernel] = dict(body, int_pipe_ops=ops)
            print(f"[build] SASS {kernel}: block loop {body['instructions']} instructions, "
                  f"{ops} on the integer pipe; opcodes "
                  f"{dict(sorted(body['opcodes'].items(), key=lambda kv: -kv[1]))}")
    if set(out) != {"sha256_kernel", "sha512_kernel"}:
        raise PhaseFailed(f"SASS: no block loop found in K12/K13 (found {sorted(out)})")
    return out


def sampler_perms(torch, accepted, per_block: int, blocks: int) -> int:
    """Keccak-f calls a rejection sampler (K2, K5, K6) needs for these
    rows, given which of its candidates pass (per_block candidates to a
    squeezed block): the blocks until the 256th accepted candidate, or
    blocks + blocks where the second pass runs."""
    cum = accepted.to(torch.int32).cumsum(-1)
    full = cum[:, -1] >= 256
    first = (cum >= 256).to(torch.int8).argmax(-1)
    used = torch.where(full, first // per_block + 1, torch.full_like(first, 2 * blocks))
    return int(used.sum())


def sample_ntt_perms(torch, keccak, q, seeds) -> int:
    buf = keccak.sponge_plain(seeds, 168, 0x1F, 672).to(torch.int32)
    t = buf.reshape(buf.shape[0], -1, 3)
    cand = torch.stack([t[..., 0] + 256 * (t[..., 1] % 16), t[..., 1] // 16 + 16 * t[..., 2]],
                       dim=-1).reshape(buf.shape[0], -1)
    return sampler_perms(torch, cand < q, 112, 4)


def rej_ntt_perms(torch, keccak, q, seeds) -> int:
    buf = keccak.sponge_plain(seeds, 168, 0x1F, 1176).to(torch.int32)
    t = buf.reshape(buf.shape[0], -1, 3)
    cand = t[..., 0] | (t[..., 1] << 8) | ((t[..., 2] & 0x7F) << 16)
    return sampler_perms(torch, cand < q, 56, 7)


def rej_bounded_perms(torch, keccak, seeds, eta: int) -> int:
    b = keccak.sponge_plain(seeds, 136, 0x1F, 512).to(torch.int32)
    z = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(b.shape[0], -1)
    return sampler_perms(torch, z < (15 if eta == 2 else 9), 272, 4)


def frodo_sample_ops(p) -> int:
    """32-bit operations of one CDF sample as the work needs them: a
    compare and an add for each table entry but the last, then the shift,
    the sign (and, negate, select) and the mask."""
    return 2 * (len(p.cdf) - 1) + 5


def plain_absorb(mod, states, blocks, rows_per_state: int, width: int):
    """The plain version of K12/K13's launch: each state's rows, block by
    block, through ``compress_plain`` (``mod`` is core.sha256 or sha512)."""
    st = states[:, None, :]
    rows = blocks.reshape(states.shape[0], rows_per_state, blocks.shape[-1])
    for i in range(blocks.shape[-1] // width):
        st = mod.compress_plain(st, rows[..., i * width:(i + 1) * width])
    return st.reshape(-1, 8)


def phase_kernels(torch, np, keccak, keccak_cuda, mlkem, mlkem_cuda, mldsa, mldsa_cuda,
                  chacha, chacha_cuda, frodo, frodo_cuda, sha2, sha2_ops, int_rate) -> list:
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
    # distinct names: the lambdas above read seeds, prf and polys when called
    p = mldsa.MLDSA65
    n_a, n_s = KEYGEN_KEYS * p.k * p.l, KEYGEN_KEYS * (p.k + p.l)
    a_seeds, s_seeds = u8(n_a, 34), u8(n_s, 66)
    cases.append(("mldsa_rej_ntt", f"{SRC}/sig/mldsa_pallas.py:259",
                  lambda: mldsa_cuda.rej_ntt(a_seeds), lambda: mldsa.rej_ntt_poly_plain(a_seeds),
                  a_seeds.numel() + 4 * 256 * n_a,
                  rej_ntt_perms(torch, keccak, mldsa.Q, a_seeds) * KECCAK_F_OPS,
                  f"({n_a}, 34) -> ({n_a}, 256)"))
    for eta in (4, 2):
        cases.append(("mldsa_rej_bounded" if eta == p.eta else f"mldsa_rej_bounded[eta={eta}]",
                      f"{SRC}/sig/mldsa_pallas.py:130",
                      lambda e=eta: mldsa_cuda.rej_bounded(s_seeds, e),
                      lambda e=eta: mldsa.rej_bounded_poly_plain(s_seeds, e),
                      s_seeds.numel() + 4 * 256 * n_s,
                      rej_bounded_perms(torch, keccak, s_seeds, eta) * KECCAK_F_OPS,
                      f"eta={eta}: ({n_s}, 66) -> ({n_s}, 256)"))
    dsa_polys = torch.from_numpy(rng.integers(0, mldsa.Q, size=(BATCH * p.k, 256),
                                              dtype=np.int32)).to(dev)
    for name, kern, plain, ops in (
            ("mldsa_ntt", mldsa_cuda.ntt, mldsa.ntt_plain, MLDSA_NTT_OPS),
            ("mldsa_ntt_inv", mldsa_cuda.ntt_inv, mldsa.ntt_inv_plain, MLDSA_NTT_INV_OPS)):
        cases.append((name, f"{SRC}/sig/mldsa_pallas.py:227",
                      lambda k=kern: k(dsa_polys), lambda f=plain: f(dsa_polys),
                      2 * dsa_polys.numel() * 4, dsa_polys.shape[0] * ops,
                      f"({BATCH * p.k}, 256) int32"))
    # K1 with per-row lengths on the fused programs' widest transcripts:
    # the lengths run through every value from 0 to LMAX, so every residue
    # mod 136 around each block edge; bound by the blocks these lengths need
    transcripts = u8(BATCH, VARLEN_LMAX)
    lens = torch.arange(BATCH, dtype=torch.int32, device=dev) % (VARLEN_LMAX + 1)
    cases.append(("keccak_sponge_varlen", f"{SRC}/core/keccak_pallas.py:177",
                  lambda: keccak_cuda.sponge_varlen(transcripts, lens, 136, 0x1F, 64),
                  lambda: keccak.sponge_varlen_plain(transcripts, lens, 136, 0x1F, 64),
                  int(lens.sum()) + BATCH * (4 + 64),
                  int((lens // 136 + 1).sum()) * KECCAK_F_OPS,
                  f"({BATCH}, {VARLEN_LMAX}), lengths 0..{VARLEN_LMAX} -> ({BATCH}, 64)"))
    # K8 at the 4 KiB seal batch of phase 9 and at the 64 KiB max_len
    for tag, blocks in (("", 65), ("[64KiB]", 1025)):
        states = torch.from_numpy(rng.integers(-2**31, 2**31, size=(BATCH * blocks, 12),
                                               dtype=np.int32)).to(dev)
        cases.append((f"chacha_blocks{tag}", f"{SRC}/core/chacha_pallas.py:141",
                      lambda s=states: chacha_cuda.chacha_blocks(s),
                      lambda s=states: chacha.chacha_blocks_plain(s),
                      states.shape[0] * CHACHA_BLOCK_BYTES, states.shape[0] * CHACHA_BLOCK_OPS,
                      f"({BATCH} x {blocks}, 12) -> (.., 16) int32"))
    # K9 and K10 at BASELINE config 3's batch of 640-SHAKE and at 1344-SHAKE,
    # B = 256: a row of A is ceil(2n / 168) permutations; bytes are seed_A and
    # S or S' in, the product out.  The plain versions run the plain sponge.
    for pname, lanes in ((FRODO_SHAKE, FRODO_BATCH), FRODO_WIDE):
        fp = frodo.PARAMS[pname]
        seed_a = u8(lanes, 16)
        s = torch.from_numpy(rng.integers(0, fp.q, size=(lanes, fp.n, 8), dtype=np.int32)).to(dev)
        sp = torch.from_numpy(rng.integers(0, fp.q, size=(lanes, 8, fp.n),
                                           dtype=np.int32)).to(dev)
        perms = lanes * fp.n * -(-2 * fp.n // 168)
        nbytes = lanes * (16 + 2 * 4 * 8 * fp.n)
        tag = "" if fp.n == 640 else f"[{fp.n}]"
        cases.append((f"frodo_a_times_s{tag}", f"{SRC}/kem/frodo_pallas.py:256",
                      lambda fp=fp, s=s, a=seed_a: frodo_cuda.a_times_s(fp, s, a),
                      lambda fp=fp, s=s, a=seed_a: frodo.a_times_s_plain(fp, s, a),
                      nbytes, perms * KECCAK_F_OPS, f"n={fp.n}: ({lanes}, {fp.n}, 8) int32"))
        cases.append((f"frodo_s_times_a{tag}", f"{SRC}/kem/frodo_pallas.py:223",
                      lambda fp=fp, s=sp, a=seed_a: frodo_cuda.s_times_a(fp, s, a),
                      lambda fp=fp, s=sp, a=seed_a: frodo.s_times_a_plain(fp, s, a),
                      nbytes, perms * KECCAK_F_OPS, f"n={fp.n}: ({lanes}, 8, {fp.n}) int32"))
    # K11 at the sample count of one 640 encaps batch: S', E' and E''
    fp = frodo.PARAMS[FRODO_SHAKE]
    m = FRODO_BATCH * (2 * 8 * fp.n + 64)
    r16 = torch.from_numpy(rng.integers(0, 1 << 16, size=m, dtype=np.int32)).to(dev)
    cases.append(("frodo_cdf_sample", f"{SRC}/kem/frodo_pallas.py:291",
                  lambda: frodo_cuda.cdf_sample(fp, r16), lambda: frodo.cdf_sample_plain(fp, r16),
                  8 * m, m * frodo_sample_ops(fp), f"({m},) int32"))
    # K12 and K13 as the SPHINCS+ batch phases launch them: one pk_seed
    # midstate a signature serves its rows; a WOTS public key's T_l is one
    # launch over all its blocks.  Bytes: the states, the blocks, the words
    # out; operations: the integer-pipe instructions of one block's SASS.
    sha256, sha256_cuda, sha512, sha512_cuda = sha2
    for name, mod, kern, width, lanes, per, nblocks, what in (
            ("sha256_compress", sha256, sha256_cuda.compress, 64, 1024, 8 * 35, 1,
             "128f chain step, B = 1024"),
            ("sha256_compress", sha256, sha256_cuda.compress, 64, 1024, 33 * 64, 1,
             "128f FORS leaves, B = 1024"),
            ("sha256_compress[T_l]", sha256, sha256_cuda.compress, 64, 1024, 8, 10,
             "128f WOTS pk T_l, B = 1024"),
            ("sha512_compress", sha512, sha512_cuda.compress, 128, 256, 33 * 128, 1,
             "192f FORS level 1, B = 256"),
            ("sha512_compress[T_l]", sha512, sha512_cuda.compress, 128, 256, 8, 10,
             "192f WOTS pk T_l, B = 256")):
        lo, hi = (0, 2**32) if width == 64 else (-2**63, 2**63)
        states = torch.from_numpy(rng.integers(lo, hi, size=(lanes, 8), dtype=np.int64)).to(dev)
        blocks = u8(lanes * per, nblocks * width)
        rows = lanes * per
        ops = rows * nblocks * sha2_ops["sha256_kernel" if width == 64 else "sha512_kernel"]
        cases.append((name, f"{SRC}/core/sha{256 if width == 64 else 512}_pallas.py:"
                            f"{74 if width == 64 else 102}",
                      lambda k=kern, s=states, b=blocks, r=per: k(s, b, r),
                      lambda m=mod, s=states, b=blocks, r=per, w=width: plain_absorb(m, s, b, r, w),
                      states.numel() * 8 + blocks.numel() + rows * 64, ops,
                      f"{what}: ({lanes}, 8) states x {per} rows, {nblocks} block(s) -> "
                      f"({rows}, 8)"))
    # the one PyTorch call for a kernel's function, timed as a yardstick:
    # searchsorted gives K11's magnitude (not constant-time; never used)
    table, half = torch.tensor(fp.cdf[:-1], dtype=torch.int32, device=dev), r16 >> 1
    library = {"frodo_cdf_sample": lambda: torch.searchsorted(table, half)}

    rows = []
    for name, replaces, kern, plain, nbytes, ops, shape in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise PhaseFailed(f"{name} {shape}: kernel differs from plain (max |err| {err})")
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, 1 if name.startswith(("frodo_", "sha")) else 3)
        library_ms = cuda_ms(torch, library[name], 20) if name in library else None
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({"name": name, "replaces": replaces, "shape": shape, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms, "bytes": nbytes,
                     "int32_ops": ops})
        lib_txt = f", library {library_ms:.4f} ms" if library_ms is not None else ""
        print(f"[kernels] {name} {shape}: equal, {ms:.4f} ms (plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by}{lib_txt})")
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


def phase_kat_mldsa(torch, mldsa) -> None:
    """keygen from xi, then sign with the vector's rnd (mu from tr and
    M' = 0 || 0 || msg, on the host): pk, sk and sig by their sha256."""
    data = json.loads((ROOT / "tests" / "vectors" / "mldsa_65.json").read_text())
    p = mldsa.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(rows):
        return torch.tensor([list(r) for r in rows], dtype=torch.uint8, device="cuda")

    pk, sk = mldsa.keygen(p, col(bytes.fromhex(r["xi"]) for r in recs))
    mu = col(hashlib.shake_256(bytes(sk[i, 64:128].cpu().numpy()) + b"\0\0"
                               + bytes.fromhex(r["msg"])).digest(64) for i, r in enumerate(recs))
    sig, done = mldsa.sign_mu(p, sk, mu, col(bytes.fromhex(r["rnd"]) for r in recs))
    ok = mldsa.verify_mu(p, pk, mu, sig)
    if not (bool(done.all()) and bool(ok.all())):
        raise PhaseFailed(f"KAT {data['algorithm']}: done {done.tolist()}, verify {ok.tolist()}")
    for i, rec in enumerate(recs):
        for name, t in (("pk", pk), ("sk", sk), ("sig", sig)):
            if hashlib.sha256(bytes(t[i].cpu().numpy())).hexdigest() != rec[name + "_sha256"]:
                raise PhaseFailed(f"KAT {data['algorithm']} count {rec['count']}: {name} differs")
    print(f"[kat] {data['algorithm']}: {len(recs)} vectors byte-exact on the GPU "
          "(keygen, sign; verify True)")


def phase_kat_frodo(torch, frodo) -> None:
    """The six FrodoKEM vector files through keygen/encaps/decaps on the
    GPU: pk, sk and ct by their sha256, ss by value; a tampered ciphertext
    must not give ss back."""
    for tag in FRODO_VECTORS:
        data = json.loads((ROOT / "tests" / "vectors" / f"frodo_{tag}.json").read_text())
        p = frodo.PARAMS[data["algorithm"]]
        recs = data["tests"]

        def col(key):
            return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8,
                                device="cuda")

        pk, sk = frodo.keygen(p, col("s"), col("seed_se"), col("z"))
        ct, ss = frodo.encaps(p, pk, col("mu"))
        bad = ct.clone()
        bad[:, -1] ^= 1
        ss2, rej = frodo.decaps(p, sk.repeat(2, 1), torch.cat([ct, bad])).split(len(recs))
        for i, rec in enumerate(recs):
            for name, t in (("pk", pk), ("sk", sk), ("ct", ct)):
                if hashlib.sha256(bytes(t[i].cpu().numpy())).hexdigest() != rec[name + "_sha256"]:
                    raise PhaseFailed(f"KAT {p.name} count {rec['count']}: {name} differs")
            for name, t in (("ss", ss), ("ss after decaps", ss2)):
                if bytes(t[i].cpu().numpy()).hex() != rec["ss"]:
                    raise PhaseFailed(f"KAT {p.name} count {rec['count']}: {name} differs")
            if bytes(rej[i].cpu().numpy()).hex() == rec["ss"]:
                raise PhaseFailed(f"KAT {p.name} count {rec['count']}: a tampered ciphertext "
                                  "gave the secret")
        print(f"[kat] {p.name}: {len(recs)} vectors byte-exact on the GPU "
              "(keygen, encaps, decaps, implicit rejection)")


def slh_host_digests(p, slhdsa_params, sks, msgs) -> tuple[list, list]:
    """The provider's host half of a deterministic sign: PRF_msg with
    opt_rand = pk_seed, then H_msg, for each (secret key, message)."""
    rs, digests = [], []
    for skb, msg in zip(sks, msgs):
        pk_seed, pk_root = skb[2 * p.n: 3 * p.n], skb[3 * p.n:]
        r = slhdsa_params.prf_msg(p, skb[p.n: 2 * p.n], pk_seed, msg)
        rs.append(list(r))
        digests.append(list(slhdsa_params.h_msg(p, r, pk_seed, pk_root, msg)))
    return rs, digests


def phase_kat_slhdsa(torch, sphincs, slhdsa_params) -> None:
    """The six tests/vectors/slhdsa_*.json through keygen (pk), deterministic
    sign (sig by its sha256) and verify on the GPU, a flipped byte refused;
    then the keygen records of acvp_slhdsa128f_fixture.json (pk, sk)."""
    def rows(values):
        return torch.tensor([list(v) for v in values], dtype=torch.uint8, device="cuda")

    for tag in SLH_VECTORS:
        data = json.loads((ROOT / "tests" / "vectors" / f"slhdsa_{tag}.json").read_text())
        p = slhdsa_params.PARAMS[data["algorithm"]]
        recs = data["tests"]
        kg, sign, verify = sphincs.get(p.name)
        pk, sk = kg(*(rows(bytes.fromhex(r[k]) for r in recs)
                      for k in ("sk_seed", "sk_prf", "pk_seed")))
        rs, digests = slh_host_digests(p, slhdsa_params, [bytes(x.tolist()) for x in sk],
                                       [bytes.fromhex(r["msg"]) for r in recs])
        digest = rows(digests)
        sig = sign(sk, rows(rs), digest)
        bad = sig.clone()
        bad[:, -1] ^= 1
        ok = verify(pk.repeat(2, 1), digest.repeat(2, 1), torch.cat([sig, bad])).tolist()
        for i, rec in enumerate(recs):
            if bytes(pk[i].tolist()).hex() != rec["pk"]:
                raise PhaseFailed(f"KAT {p.name} count {rec['count']}: pk differs")
            if hashlib.sha256(bytes(sig[i].tolist())).hexdigest() != rec["sig_sha256"]:
                raise PhaseFailed(f"KAT {p.name} count {rec['count']}: sig differs")
        if ok != [True] * len(recs) + [False] * len(recs):
            raise PhaseFailed(f"KAT {p.name}: verify gave {ok}")
        print(f"[kat] {p.name}: {len(recs)} vectors byte-exact on the GPU (keygen, sign; "
              "verify True, a flipped byte False)")
    data = json.loads((ROOT / "tests" / "vectors" / "acvp_slhdsa128f_fixture.json").read_text())
    p = slhdsa_params.PARAMS[data["algorithm"]]
    (group,) = [g for g in data["testGroups"] if "skSeed" in g["tests"][0]]
    tests = group["tests"]
    pk, sk = sphincs.keygen(p, *(rows(bytes.fromhex(t[k]) for t in tests)
                                 for k in ("skSeed", "skPrf", "pkSeed")))
    for i, t in enumerate(tests):
        if bytes(pk[i].tolist()).hex() != t["pk"] or bytes(sk[i].tolist()).hex() != t["sk"]:
            raise PhaseFailed(f"ACVP {p.name} keygen tcId {t['tcId']}: pk or sk differs")
    print(f"[kat] {p.name}: {len(tests)} ACVP-format keygen records byte-exact on the GPU")


#: RFC 8439 vectors: §2.3.2 (block, counter 1), §2.5.2 (Poly1305), §2.8.2 (AEAD)
RFC_BLOCK = (bytes(range(32)), 1, bytes.fromhex("000000090000004a00000000"),
             "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
             "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
RFC_POLY = (bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b"),
            b"Cryptographic Forum Research Group", "a8061dc1305136c6c22b8baf0c0127a9")
RFC_AEAD = (bytes(range(0x80, 0xA0)), bytes([0x07, 0, 0, 0]) + bytes(range(0x40, 0x48)),
            bytes.fromhex("50515253c0c1c2c3c4c5c6c7"),
            b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip for "
            b"the future, sunscreen would be it.",
            "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
            "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
            "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
            "3ff4def08e4b7a9de576d26586cec64b6116", "1ae10b594f09e26a7e902ecbd0600691")


def phase_kat_chacha(torch, np, chacha) -> None:
    """The RFC 8439 vectors through the port's chacha on CUDA tensors."""
    def row(b: bytes, width: int = 0):
        out = np.zeros((1, max(width, len(b))), np.uint8)
        out[0, : len(b)] = np.frombuffer(b, np.uint8)
        return torch.from_numpy(out).to("cuda")

    key, ctr, nonce, want = RFC_BLOCK
    words = np.frombuffer(key + ctr.to_bytes(4, "little") + nonce, np.int32)[None].copy()
    block = chacha.chacha_blocks(torch.from_numpy(words).to("cuda"))
    if bytes(block.cpu().numpy().view(np.uint8)[0]).hex() != want:
        raise PhaseFailed("RFC 8439 §2.3.2 block differs on the GPU")
    pkey, msg, want = RFC_POLY
    padded = row(msg + b"\x01", 48)
    tag = chacha.poly1305_tags(row(pkey[:16]), row(pkey[16:]), padded,
                               torch.ones((1, 3), dtype=torch.bool, device="cuda"),
                               hibit=torch.tensor([[True, True, False]], device="cuda"))
    if bytes(tag.cpu().numpy()[0]).hex() != want:
        raise PhaseFailed("RFC 8439 §2.5.2 Poly1305 tag differs on the GPU")
    key, nonce, aad, pt, ct_hex, tag_hex = RFC_AEAD
    lens = torch.tensor([len(pt)], device="cuda")
    aad_lens = torch.tensor([len(aad)], device="cuda")
    ct, tags = chacha.aead_core(row(key), row(nonce), row(pt, 128), lens, row(aad, 16), aad_lens,
                                seal=True)
    got_ct = bytes(ct.cpu().numpy()[0, : len(pt)])
    if got_ct.hex() != ct_hex or bytes(tags.cpu().numpy()[0]).hex() != tag_hex:
        raise PhaseFailed("RFC 8439 §2.8.2 seal differs on the GPU")
    opened, tags2 = chacha.aead_core(row(key), row(nonce), row(got_ct, 128), lens, row(aad, 16),
                                     aad_lens, seal=False)
    if bytes(opened.cpu().numpy()[0, : len(pt)]) != pt or not torch.equal(tags2, tags):
        raise PhaseFailed("RFC 8439 §2.8.2 open differs on the GPU")
    print("[kat] RFC 8439 §2.3.2 block, §2.5.2 Poly1305 and §2.8.2 AEAD (seal, open) "
          "byte-exact on the GPU")


def phase_health(provider, health, kem, dsa, fused, aead, pk_off, ct_off) -> list:
    """The health gate on the GPU providers, with the "cpu" providers and
    the scalar AEAD as twins: the ML-KEM-768 KAT, the ML-DSA-65 round trip,
    the fused keygen_sign and the AEAD KAT; gate_facades raises on a
    failed verdict."""
    cpu_kem = provider.get_kem(kem.name, backend="cpu")
    cpu_dsa = provider.get_signature(dsa.name, backend="cpu")
    with provider.BatchedKEM(kem) as bk, provider.BatchedSignature(dsa) as bs, \
            provider.BatchedFused(fused, pk_off, ct_off) as bf, provider.BatchedAEAD(aead) as ba:
        try:
            verdicts = health.gate_facades(bk, bs, bf, ba, cpu_kem=cpu_kem, cpu_sig=cpu_dsa,
                                           scalar=provider.get_symmetric(AEAD))
        except RuntimeError as exc:
            raise PhaseFailed(f"health: {exc}") from exc
    for v in verdicts:
        print(f"[health] {v.family}: ok={v.ok} ({v.detail})")
    return [v.as_dict() for v in verdicts]


def phase_health_frodo(provider, health) -> list:
    """The health gate on the GPU providers of FrodoKEM-640-SHAKE (its KAT)
    and FrodoKEM-640-AES (a round trip whose ciphertext the "cpu" twin
    decapsulates)."""
    verdicts = []
    for name in (FRODO_SHAKE, FRODO_AES):
        with provider.BatchedKEM(provider.get_kem(name)) as bk:
            try:
                verdicts += health.gate_facades(bk, cpu_kem=provider.get_kem(name, backend="cpu"))
            except RuntimeError as exc:
                raise PhaseFailed(f"health: {exc}") from exc
    for v in verdicts:
        print(f"[health] {v.family}: ok={v.ok} ({v.detail})")
    return [v.as_dict() for v in verdicts]


def phase_health_sphincs(provider, health) -> list:
    """The health gate on the GPU providers of SPHINCS+-SHA2-128s and -128f:
    a round trip, the "cpu" twin's verify of the device signature, and a
    tampered signature refused."""
    verdicts = []
    for name in SLH_HEALTH:
        with provider.BatchedSignature(provider.get_signature(name)) as bs:
            try:
                verdicts += health.gate_facades(
                    bs, cpu_sig=provider.get_signature(name, backend="cpu"))
            except RuntimeError as exc:
                raise PhaseFailed(f"health: {exc}") from exc
    for v in verdicts:
        print(f"[health] {v.family}: ok={v.ok} ({v.detail})")
    return [v.as_dict() for v in verdicts]


def canonical(data: dict) -> bytes:
    """The canonical JSON every transcript is signed as (sorted keys, no
    spaces), as the reference's SecureMessaging writes it."""
    return json.dumps(data, sort_keys=True, separators=(",", ":")).encode()


def derive_message_key(shared_secret: bytes, id_a: str, id_b: str, aead_name: str) -> bytes:
    """HKDF-SHA256 (RFC 5869) of the KEM secret, salted by the sorted peer
    ids, bound to the AEAD name: the reference's app/messaging.py
    derive_message_key, here on hashlib and hmac."""
    salt = "|".join(sorted([id_a, id_b])).encode()
    prk = hmac.new(salt, shared_secret, hashlib.sha256).digest()
    return hmac.new(prk, b"qrp2p-tpu/msgkey/" + aead_name.encode() + b"\x01",
                    hashlib.sha256).digest()


async def handshake(provider, kem, dsa, fused, cpu_dsa, pk_off, ct_off) -> dict:
    """HANDSHAKES initiators and one gateway run the fused handshake trip by
    trip through one BatchedFused a side, then the gateway verifies each
    confirm through BatchedSignature.  One more initiator's init transcript
    has a byte changed on the way: the gateway must refuse it."""
    lat = {"keygen_sign": [], "encaps_verify_sign": [], "decaps_verify_sign": [], "verify": []}

    async def timed(op, coro):
        t0 = time.perf_counter()
        out = await coro
        lat[op].append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    pks, sks = dsa.generate_keypair_batch(HANDSHAKES)
    gw_pk, gw_sk = dsa.generate_keypair()
    keygen_s = time.perf_counter() - t0
    with provider.BatchedFused(fused, pk_off, ct_off, max_batch=HANDSHAKE_BATCH,
                               max_wait_ms=2.0) as ini, \
            provider.BatchedFused(fused, pk_off, ct_off, max_batch=HANDSHAKE_BATCH,
                                  max_wait_ms=2.0) as gw, \
            provider.BatchedSignature(dsa, max_batch=HANDSHAKE_BATCH, max_wait_ms=2.0) as gw_sig:
        async def session(i: int, tamper: bool = False) -> dict:
            lane = i % HANDSHAKES
            peer, sk = f"peer-{i:04d}", bytes(sks[lane])
            init = {"message_id": str(uuid.UUID(int=i)), "kem": kem.name, "aead": AEAD,
                    "public_key": "0" * (2 * kem.public_key_len), "sender": peer,
                    "recipient": GATEWAY, "timestamp": 1.7e9 + i / 1e3}
            kem_pk, kem_sk, s1 = await timed("keygen_sign", ini.keygen_sign(sk, canonical(init)))
            init["public_key"] = kem_pk.hex()
            init_msg = canonical(init)
            seen = init_msg.replace(b'"sender":"peer', b'"sender":"Peer') if tamper else init_msg
            resp = {"message_id": str(uuid.UUID(int=1 << 64 | i)), "sender": GATEWAY,
                    "ciphertext": "0" * (2 * kem.ciphertext_len), "recipient": peer,
                    "timestamp": 1.7e9 + 1 + i / 1e3}
            ok, ct, ss_gw, s2 = await timed("encaps_verify_sign", gw.encaps_verify_sign(
                kem_pk, bytes(pks[lane]), seen, s1, gw_sk, canonical(resp)))
            out = {"i": i, "ok": ok, "init": (init_msg, s1)}
            if not ok:  # the secret encapsulated for a refused peer is dropped
                return out
            resp["ciphertext"] = ct.hex()
            resp_msg = canonical(resp)
            confirm = canonical({"message_id": str(uuid.UUID(int=2 << 64 | i)), "sender": peer,
                                 "recipient": GATEWAY, "timestamp": 1.7e9 + 2 + i / 1e3})
            ok2, ss_peer, s3 = await timed("decaps_verify_sign", ini.decaps_verify_sign(
                kem_sk, ct, gw_pk, resp_msg, s2, sk, confirm))
            ok3 = await timed("verify", gw_sig.verify(bytes(pks[lane]), confirm, s3))
            out.update(ok2=ok2, ok3=ok3, agree=hmac.compare_digest(ss_gw, ss_peer),
                       resp=(resp_msg, s2), confirm=(confirm, s3), peer=peer,
                       keys=(derive_message_key(ss_peer, peer, GATEWAY, AEAD),
                             derive_message_key(ss_gw, GATEWAY, peer, AEAD)))
            return out

        t0 = time.perf_counter()
        done = await asyncio.gather(*(session(i) for i in range(HANDSHAKES)),
                                    session(HANDSHAKES, tamper=True))
        wall = time.perf_counter() - t0
        stats = {"initiator.keygen_sign": ini.stats()["keygen_sign"],
                 "gateway.encaps_verify_sign": gw.stats()["encaps_verify_sign"],
                 "initiator.decaps_verify_sign": ini.stats()["decaps_verify_sign"],
                 "gateway.verify": gw_sig.stats()["verify"]}
    sessions, tampered = done[:HANDSHAKES], done[HANDSHAKES]
    bad = [r["i"] for r in sessions if not (r["ok"] and r.get("ok2") and r.get("ok3")
                                            and r.get("agree"))]
    if bad:
        raise PhaseFailed(f"handshake: {len(bad)} of {HANDSHAKES} sessions failed, first {bad[:8]}")
    if tampered["ok"]:
        raise PhaseFailed("handshake: the gateway accepted a changed init transcript")
    for r in sessions[:4]:  # the signatures over the rendered transcripts, on the CPU
        checks = ((pks[r["i"]], *r["init"]), (gw_pk, *r["resp"]), (pks[r["i"]], *r["confirm"]))
        if not all(cpu_dsa.verify(bytes(pk), m, s) for pk, m, s in checks):
            raise PhaseFailed(f"handshake: a signature of session {r['i']} fails on the CPU")
    # a handshake is one operation on each of the four queues, and each
    # operation rides one flush; the sessions coalesce when every queue
    # flushes at most ceil(its ops / max_batch) times, so the phase takes at
    # most four device trips per max_batch handshakes
    ops = {k: v["ops"] for k, v in stats.items()}
    want = dict(zip(stats, (HANDSHAKES + 1, HANDSHAKES + 1, HANDSHAKES, HANDSHAKES)))
    if ops != want:
        raise PhaseFailed(f"handshake: queue ops {ops} (want {want})")
    flushes = {k: v["flushes"] for k, v in stats.items()}
    most = {k: -(-n // HANDSHAKE_BATCH) for k, n in ops.items()}
    if any(flushes[k] > most[k] for k in flushes):
        raise PhaseFailed(f"handshake: flushes {flushes}, at most {most} when the sessions "
                          "coalesce")
    trips = sum(ops.values()) / (HANDSHAKES + 1)
    return {"handshakes": HANDSHAKES, "keygen_s": keygen_s, "wall_s": wall,
            "handshakes_per_s": HANDSHAKES / wall, "trips_per_handshake": trips,
            "flushes": flushes, "device_trips": sum(flushes.values()),
            "flush_sizes": {k: v["recent_batch_sizes"] for k, v in stats.items()},
            "queues": stats, "sessions": [(r["peer"], *r["keys"]) for r in sessions],
            "latency_ms": {op: {"p50": pct(v, 50), "p99": pct(v, 99)} for op, v in lat.items()}}


async def data_plane(np, provider, device, sessions) -> dict:
    """Each session's client seals a 256-byte message with AAD through
    BatchedAEAD under its derived key; the gateway opens it under its own
    derivation of the key.  One frame changed on the way must fail."""
    rng = np.random.default_rng(9)
    msgs = [bytes(r) for r in rng.integers(0, 256, size=(len(sessions), 256), dtype=np.uint8)]
    with provider.BatchedAEAD(device, max_batch=4096, max_wait_ms=2.0) as cli, \
            provider.BatchedAEAD(device, max_batch=4096, max_wait_ms=2.0) as gw:
        async def one(i):
            peer, k_peer, k_gw = sessions[i]
            aad = canonical({"message_id": str(uuid.UUID(int=3 << 64 | i)), "sender": peer,
                             "recipient": GATEWAY})
            frame = await cli.encrypt(k_peer, msgs[i], aad)
            return frame, aad, await gw.decrypt(k_gw, frame, aad)

        t0 = time.perf_counter()
        out = await asyncio.gather(*(one(i) for i in range(len(sessions))))
        wall = time.perf_counter() - t0
        frame, aad, _ = out[0]
        changed = frame[:-1] + bytes([frame[-1] ^ 1])
        try:
            await gw.decrypt(sessions[0][2], changed, aad)
            raise PhaseFailed("data plane: a changed frame opened")
        except ValueError:
            pass
        stats = {"client": cli.stats(), "gateway": gw.stats()}
    wrong = [i for i, (_, _, pt) in enumerate(out) if pt != msgs[i]]
    if wrong:
        raise PhaseFailed(f"data plane: {len(wrong)} frames did not open to their plaintext")
    return {"messages": len(sessions), "message_bytes": 256, "wall_s": wall,
            "round_trips_per_s": len(sessions) / wall, "queues": stats}


def seal_batch_inputs(np, sessions):
    """SEAL_BATCH messages of SEAL_LEN bytes under the sessions' keys (each
    key SEAL_BATCH / sessions times, with its own nonce) and a 64-byte AAD."""
    rng = np.random.default_rng(10)
    keys = np.stack([np.frombuffer(sessions[i % len(sessions)][1], np.uint8)
                     for i in range(SEAL_BATCH)])
    nonces = rng.integers(0, 256, size=(SEAL_BATCH, 12), dtype=np.uint8)
    pts = [bytes(r) for r in rng.integers(0, 256, size=(SEAL_BATCH, SEAL_LEN), dtype=np.uint8)]
    aads = [bytes(r) for r in rng.integers(0, 256, size=(SEAL_BATCH, 64), dtype=np.uint8)]
    return keys, nonces, pts, aads


def phase_seal_batch(torch, device, scalar, inputs) -> dict:
    """One seal_batch and one open_batch of SEAL_BATCH x SEAL_LEN on the GPU,
    timed with CUDA events; the first rows are held to the scalar AEAD."""
    keys, nonces, pts, aads = inputs
    sealed = device.seal_batch(keys, nonces, pts, aads)
    for i in range(4):
        if sealed[i] != scalar.seal(bytes(keys[i]), bytes(nonces[i]), pts[i], aads[i]):
            raise PhaseFailed(f"seal batch: row {i} differs from the scalar AEAD")
    opened = device.open_batch(keys, nonces, sealed, aads)
    if opened != pts:
        raise PhaseFailed("seal batch: open_batch did not give back every plaintext")
    seal_ms = cuda_ms(torch, lambda: device.seal_batch(keys, nonces, pts, aads), 3)
    open_ms = cuda_ms(torch, lambda: device.open_batch(keys, nonces, sealed, aads), 3)
    mb = SEAL_BATCH * SEAL_LEN / 1e6
    poly_steps = (256 + SEAL_LEN) // 16 + 1  # AAD bucket, message and length blocks
    out = {"batch": SEAL_BATCH, "message_bytes": SEAL_LEN, "seal_ms": seal_ms,
           "open_ms": open_ms, "seal_mb_per_s": mb / (seal_ms / 1e3),
           "open_mb_per_s": mb / (open_ms / 1e3), "poly1305_blocks_per_row": poly_steps}
    print(f"[seal batch] {SEAL_BATCH} x {SEAL_LEN} B: seal {seal_ms:.3f} ms "
          f"({out['seal_mb_per_s']:.1f} MB/s), open {open_ms:.3f} ms "
          f"({out['open_mb_per_s']:.1f} MB/s) by CUDA events; Poly1305 loop of "
          f"{poly_steps} blocks a row")
    return out


def pct(xs, q):
    return 1e3 * sorted(xs)[min(len(xs) - 1, int(q / 100 * len(xs)))]


def print_served(tag: str, name: str, served: dict) -> None:
    print(f"[{tag}] {name}, {SERVE_CLIENTS} clients: {served['handshakes_per_s']:.1f} "
          f"handshakes/s (keygen+encaps+decaps, {served['handshake_wall_s']:.3f} s); "
          f"latency ms {served['latency_ms']}; opcache {served['opcache']}")
    for op, st in served["queues"].items():
        print(f"[{tag}] {op} queue: {st}")


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
        ct, ss = outs[0]
        tampered = ct[:-1] + bytes([ct[-1] ^ 1])
        if await bk.decapsulate(server_sk, tampered) == ss:  # implicit rejection
            raise PhaseFailed("serve: a tampered ciphertext gave the secret")
        stats = bk.stats()
    cache = kem.opcache.stats()
    if cache["hits"] < 1:
        raise PhaseFailed(f"serve: the single-key encaps path never hit the cache {cache}")
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


async def sig_serve(BatchedSignature, dsa) -> dict:
    """One server key, made here (so keygen's kernels run in the counted
    window); 1024 clients sign with it twice, then verify."""
    lat = {"sign": [], "verify": []}

    async def timed(op, coro):
        t0 = time.perf_counter()
        out = await coro
        lat[op].append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    pk, sk = dsa.generate_keypair()
    keygen_s = time.perf_counter() - t0
    msgs = [b"client %d transcript" % i for i in range(SERVE_CLIENTS)]
    with BatchedSignature(dsa, max_batch=4096, max_wait_ms=2.0) as bs:
        sign_walls = []
        for _ in range(2):  # the first round fills the operand cache, the second hits it
            t0 = time.perf_counter()
            sigs = await asyncio.gather(*(timed("sign", bs.sign(sk, m)) for m in msgs))
            sign_walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        oks = await asyncio.gather(*(timed("verify", bs.verify(pk, m, s))
                                     for m, s in zip(msgs, sigs)))
        verify_wall = time.perf_counter() - t0
        flipped = bytearray(sigs[0])
        flipped[0] ^= 1
        flipped_ok = await bs.verify(pk, msgs[0], bytes(flipped))
        stats = bs.stats()
    if not all(oks):
        raise PhaseFailed(f"sig serve: {oks.count(False)} of {SERVE_CLIENTS} signatures "
                          "did not verify")
    if flipped_ok:
        raise PhaseFailed("sig serve: a signature with a flipped byte verified")
    cache = dsa.opcache.stats()
    if cache["hits"] < 1:
        raise PhaseFailed(f"sig serve: the single-key sign path never hit the cache {cache}")
    return {"clients": SERVE_CLIENTS, "keygen_s": keygen_s, "sign_walls_s": sign_walls,
            "signs_per_s": [SERVE_CLIENTS / w for w in sign_walls], "verify_wall_s": verify_wall,
            "verifies_per_s": SERVE_CLIENTS / verify_wall, "opcache": cache, "queues": stats,
            "latency_ms": {op: {"p50": pct(v, 50), "p99": pct(v, 99)} for op, v in lat.items()}}


def sig_flagship_inputs(torch, np, mldsa):
    """One ML-DSA-65 key pair (from a seeded xi) with its sign and verify
    precompute, and BATCH seeded (mu, rnd) rows, all on the GPU."""
    p = mldsa.MLDSA65
    rng = np.random.default_rng(65)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to("cuda")

    pk, sk = mldsa.keygen(p, u8(32))
    return (pk, sk, mldsa.precompute_sk(p, sk), mldsa.precompute_pk(p, pk), u8(BATCH, 64),
            u8(BATCH, 32))


def phase_sig_flagship(torch, mldsa, inputs) -> dict:
    """sign_mu_pre and verify_mu_pre at B = 4096 over one key's precompute
    (the single-key path a signing node runs), timed with CUDA events."""
    p = mldsa.MLDSA65
    pk, sk, pre_sk, pre_pk, mu, rnd = inputs
    sig, done, kappa = mldsa._sign_mu_core(p, pre_sk, mu, rnd, 0, mldsa.MAX_SIGN_ITERS)
    ok = mldsa.verify_mu_pre(p, pre_pk, mu, sig)
    torch.cuda.synchronize()
    if sig.shape != (BATCH, p.sig_len) or not bool(done.all()) or not bool(ok.all()):
        raise PhaseFailed(f"sig flagship: shape {tuple(sig.shape)}, done {int(done.sum())}, "
                          f"verified {int(ok.sum())} of {BATCH}")
    bad = sig.clone()
    bad[:, 0] ^= 1
    if bool(mldsa.verify_mu_pre(p, pre_pk, mu, bad).any()):
        raise PhaseFailed("sig flagship: a signature with a flipped byte verified")
    # the CPU path builds its own precompute from the key (ExpandA, the key
    # NTTs), so a fault of K5 or K7 in the GPU's shows here too
    cpu_pre = mldsa.precompute_sk(p, sk.cpu())
    cpu_pre_pk = mldsa.precompute_pk(p, pk.cpu())
    for what, gpu, cpu in (("sk", pre_sk, cpu_pre), ("pk", pre_pk, cpu_pre_pk)):
        differ = [k for k in cpu if not torch.equal(gpu[k].cpu(), cpu[k])]
        if gpu.keys() != cpu.keys() or differ:
            raise PhaseFailed(f"sig flagship: GPU {what} precompute differs from the CPU "
                              f"path's: {differ or sorted(gpu.keys() ^ cpu.keys())}")
    ref_sig, _ = mldsa.sign_mu_pre(p, cpu_pre, mu[:4].cpu(), rnd[:4].cpu())
    if not torch.equal(sig[:4].cpu(), ref_sig):
        raise PhaseFailed("sig flagship: GPU signatures differ from the CPU path")
    if mldsa.verify_mu_pre(p, cpu_pre_pk, mu[:4].cpu(), sig[:4].cpu()).tolist() != [True] * 4:
        raise PhaseFailed("sig flagship: the CPU path rejects the GPU signatures")
    attempts = int(kappa.max()) // p.l + 1  # kappa grows by l for each rejected attempt
    lane_attempts = (kappa // p.l + 1).to(torch.float64)
    sign_ms = cuda_ms(torch, lambda: mldsa.sign_mu_pre(p, pre_sk, mu, rnd), 3)
    verify_ms = cuda_ms(torch, lambda: mldsa.verify_mu_pre(p, pre_pk, mu, sig), 10)
    out = {"batch": BATCH, "attempts_per_sign_batch": attempts,
           "mean_attempts_per_lane": float(lane_attempts.mean()),
           "sign_ms_per_batch": sign_ms, "signs_per_s": BATCH / (sign_ms / 1e3),
           "sign_ms_per_attempt": sign_ms / attempts,
           "verify_ms_per_batch": verify_ms, "verifies_per_s": BATCH / (verify_ms / 1e3)}
    print(f"[sig flagship] ML-DSA-65 sign_mu_pre B={BATCH}: {sign_ms:.3f} ms/batch (CUDA "
          f"events), {out['signs_per_s']:.0f} signs/s, {attempts} attempts in the batch "
          f"(mean {out['mean_attempts_per_lane']:.2f} a lane), "
          f"{out['sign_ms_per_attempt']:.3f} ms/attempt")
    print(f"[sig flagship] ML-DSA-65 verify_mu_pre B={BATCH}: {verify_ms:.3f} ms/batch, "
          f"{out['verifies_per_s']:.0f} verifies/s")
    return out


def frodo_batch_inputs(torch, np, frodo, name: str):
    """FRODO_BATCH key pairs of one set made by one keygen batch, the first
    key's precompute, and FRODO_BATCH seeded mu rows, all on the GPU."""
    p = frodo.PARAMS[name]
    rng = np.random.default_rng(p.n + p.aes)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to("cuda")

    pk, sk = frodo.keygen(p, *(u8(FRODO_BATCH, p.len_sec) for _ in range(3)))
    return p, pk, sk, frodo.precompute_pk(p, pk[0]), u8(FRODO_BATCH, p.len_sec)


def phase_frodo_batch(torch, frodo, inputs) -> dict:
    """BASELINE config 3: encaps at B = 1024 to 1024 keys and, over the
    first key's precompute, to one key; the first rows held to the CPU path;
    timed with CUDA events and the host clock."""
    p, pk, sk, pre, mu = inputs
    ct, ss = frodo.encaps(p, pk, mu)
    ct1, ss1 = frodo.encaps_pre(p, pre, mu)
    torch.cuda.synchronize()
    for what, c, k in (("encaps", ct, ss), ("encaps_pre", ct1, ss1)):
        if c.shape != (FRODO_BATCH, p.ct_len) or k.shape != (FRODO_BATCH, p.len_sec):
            raise PhaseFailed(f"{p.name} {what}: shapes {tuple(c.shape)} {tuple(k.shape)}")
    rows = 2
    ref_ct, ref_ss = frodo.encaps(p, pk[:rows].cpu(), mu[:rows].cpu())
    one_ct, one_ss = frodo.encaps(p, pk[:1].expand(rows, -1).cpu(), mu[:rows].cpu())
    if not (torch.equal(ct[:rows].cpu(), ref_ct) and torch.equal(ss[:rows].cpu(), ref_ss)):
        raise PhaseFailed(f"{p.name}: GPU encaps differs from the CPU path")
    if not (torch.equal(ct1[:rows].cpu(), one_ct) and torch.equal(ss1[:rows].cpu(), one_ss)):
        raise PhaseFailed(f"{p.name}: GPU encaps_pre differs from the CPU path's encaps")
    if not torch.equal(frodo.decaps(p, sk[:rows], ct[:rows]), ss[:rows]):
        raise PhaseFailed(f"{p.name}: GPU decaps of the batch's first rows differs")
    out = {"name": p.name, "batch": FRODO_BATCH}
    for what, fn in (("many_keys", lambda: frodo.encaps(p, pk, mu)),
                     ("one_key_pre", lambda: frodo.encaps_pre(p, pre, mu))):
        reps = 5
        ms = cuda_ms(torch, fn, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
        out[what] = {"ms_per_batch_cuda_events": ms, "ms_per_batch_wall": wall_ms,
                     "encaps_per_s": FRODO_BATCH / (ms / 1e3),
                     "encaps_per_s_wall": FRODO_BATCH / (wall_ms / 1e3)}
        print(f"[frodo batch] {p.name} encaps B={FRODO_BATCH} {what}: {ms:.3f} ms/batch (CUDA "
              f"events), {out[what]['encaps_per_s']:.0f} encaps/s; host wall {wall_ms:.3f} "
              f"ms/batch ({out[what]['encaps_per_s_wall']:.0f}/s)")
    return out


async def sphincs_serve(torch, provider, sphincs, slhdsa_params) -> tuple[dict, tuple]:
    """BASELINE config 4's SPHINCS+ half: SLH_SERVE_KEYS 128s keys from one
    batched keygen, one message signed under each by one sign_batch (which
    cuts the batch into chunks that fit the device's memory), then as many
    asyncio clients verify through one BatchedSignature; a flipped byte is
    refused, and the "cpu" twin verifies the first signature."""
    dsa = provider.get_signature(SLH_SERVE)
    p = dsa.params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pks, sks = dsa.generate_keypair_batch(SLH_SERVE_KEYS)
    keygen_s = time.perf_counter() - t0
    msgs = [b"peer %04d handshake transcript" % i for i in range(SLH_SERVE_KEYS)]
    per_chunk = sphincs.signatures_per_chunk(p, dsa.memory_budget())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sigs = dsa.sign_batch(sks, msgs)
    sign_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lat = []

    async def verify(pk, m, sig):
        t0 = time.perf_counter()
        out = await bs.verify(bytes(pk), m, sig)
        lat.append(time.perf_counter() - t0)
        return out

    with provider.BatchedSignature(dsa, max_batch=4096, max_wait_ms=2.0) as bs:
        t0 = time.perf_counter()
        oks = await asyncio.gather(*(verify(pk, m, sig) for pk, m, sig in zip(pks, msgs, sigs)))
        wall = time.perf_counter() - t0
        flipped = bytearray(sigs[0])
        flipped[len(flipped) // 2] ^= 1
        flipped_ok = await bs.verify(bytes(pks[0]), msgs[0], bytes(flipped))
        stats = bs.stats()
    if not all(oks):
        raise PhaseFailed(f"sphincs serve: {oks.count(False)} of {SLH_SERVE_KEYS} signatures "
                          "did not verify")
    if flipped_ok:
        raise PhaseFailed("sphincs serve: a signature with a flipped byte verified")
    if not provider.get_signature(SLH_SERVE, backend="cpu").verify(bytes(pks[0]), msgs[0],
                                                                   sigs[0]):
        raise PhaseFailed("sphincs serve: the cpu twin rejects a GPU signature")
    out = {"name": SLH_SERVE, "keys": SLH_SERVE_KEYS, "keygen_s": keygen_s,
           "keygens_per_s": SLH_SERVE_KEYS / keygen_s, "sign_s": sign_s,
           "signs_per_s": SLH_SERVE_KEYS / sign_s, "signatures_per_chunk": per_chunk,
           "sign_chunks": -(-SLH_SERVE_KEYS // per_chunk), "sign_peak_gb": peak_gb,
           "verify_wall_s": wall, "verifies_per_s": SLH_SERVE_KEYS / wall,
           "verify_latency_ms": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
           "verify_flush_sizes": stats["verify"]["recent_batch_sizes"], "queues": stats}
    print(f"[sphincs serve] {SLH_SERVE}: keygen of {SLH_SERVE_KEYS} keys {keygen_s:.3f} s "
          f"({out['keygens_per_s']:.0f}/s); sign_batch {sign_s:.3f} s ({out['signs_per_s']:.0f}"
          f"/s) in {out['sign_chunks']} chunk(s) of up to {per_chunk}, peak {peak_gb:.1f} GB; "
          f"{SLH_SERVE_KEYS} clients verified in {wall:.3f} s ({out['verifies_per_s']:.0f}/s), "
          f"latency ms {out['verify_latency_ms']}, flush sizes {out['verify_flush_sizes']}")
    return out, (pks, msgs, sigs)


def sphincs_batch_inputs(torch, np, slhdsa_params, name: str, batch: int):
    """Seeded (sk_seed, sk_prf, pk_seed), randomizer and digest rows on the GPU."""
    p = slhdsa_params.PARAMS[name]
    rng = np.random.default_rng(p.n * p.hp)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to("cuda")

    return p, [u8(batch, p.n) for _ in range(3)], u8(batch, p.n), u8(batch, p.m)


def phase_sphincs_batch(torch, sphincs, inputs) -> tuple[dict, tuple]:
    """keygen, sign_digest and verify_digest of one set at its batch, timed
    with CUDA events; every signature verifies, a flipped byte does not."""
    p, seeds, r, digest = inputs
    kg, sign, verify = sphincs.get(p.name)
    batch = digest.shape[0]
    pk, sk = kg(*seeds)
    sig = sign(sk, r, digest)
    ok = verify(pk, digest, sig)
    bad = sig.clone()
    bad[:, p.n + 7] ^= 1
    torch.cuda.synchronize()
    if sig.shape != (batch, p.sig_len) or not bool(ok.all()):
        raise PhaseFailed(f"{p.name} batch: shape {tuple(sig.shape)}, {int(ok.sum())} of "
                          f"{batch} verified")
    if bool(verify(pk, digest, bad).any()):
        raise PhaseFailed(f"{p.name} batch: a signature with a flipped byte verified")
    out = {"name": p.name, "batch": batch}
    for what, fn, reps in (("keygen", lambda: kg(*seeds), 3),
                           ("sign", lambda: sign(sk, r, digest), 3),
                           ("verify", lambda: verify(pk, digest, sig), 5)):
        ms = cuda_ms(torch, fn, reps)
        out[what] = {"ms_per_batch_cuda_events": ms, "per_s": batch / (ms / 1e3)}
    print(f"[sphincs batch] {p.name} B={batch} by CUDA events: keygen "
          f"{out['keygen']['ms_per_batch_cuda_events']:.2f} ms ({out['keygen']['per_s']:.0f}/s), "
          f"sign {out['sign']['ms_per_batch_cuda_events']:.2f} ms ({out['sign']['per_s']:.0f}/s), "
          f"verify {out['verify']['ms_per_batch_cuda_events']:.2f} ms "
          f"({out['verify']['per_s']:.0f}/s)")
    return out, (pk, sk, sig)


def phase_sphincs_memory(torch, np, provider, sphincs, slhdsa_params) -> dict:
    """The chunk rule of SPHINCSSignature.sign_batch held to the card: the
    device bytes one sign_digest call adds at its peak, per row in flight,
    stay within sphincs.BYTES_PER_ROW at every set; then SLH_WIDEST signs a
    batch of SLH_CHUNKS chunks under the provider's own budget, whose peak
    must stay within that budget, and every signature verifies."""
    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    out = {"bytes_per_row_rule": sphincs.BYTES_PER_ROW, "bytes_per_row": {}}
    for name in slhdsa_params.PARAMS:
        p, seeds, r, digest = sphincs_batch_inputs(torch, np, slhdsa_params, name,
                                                   SLH_ROW_BATCH)
        kg, sign, _ = sphincs.get(name)
        _, sk = kg(*seeds)
        _, peak = peak_of(lambda: sign(sk, r, digest))
        out["bytes_per_row"][name] = peak / (SLH_ROW_BATCH * sphincs.rows_in_flight(p))
    print(f"[sphincs memory] device bytes a row in flight at the peak of one sign_digest "
          f"(B = {SLH_ROW_BATCH}, rule {sphincs.BYTES_PER_ROW}): "
          f"{ {k: round(v, 1) for k, v in out['bytes_per_row'].items()} }")
    over = {k: v for k, v in out["bytes_per_row"].items() if v > sphincs.BYTES_PER_ROW}
    if over:
        raise PhaseFailed(f"sphincs memory: more bytes a row than the chunk rule allows: {over}")

    dsa = provider.get_signature(SLH_WIDEST)
    budget = dsa.memory_budget()
    per_chunk = sphincs.signatures_per_chunk(dsa.params, budget)
    n = (SLH_CHUNKS - 1) * per_chunk + 1
    pks, sks = dsa.generate_keypair_batch(n)
    msgs = [b"chunked %d" % i for i in range(n)]
    t0 = time.perf_counter()
    sigs, peak = peak_of(lambda: dsa.sign_batch(sks, msgs))
    sign_s = time.perf_counter() - t0
    oks = dsa.verify_batch(pks, msgs, sigs)
    out.update({"name": SLH_WIDEST, "signatures": n, "signatures_per_chunk": per_chunk,
                "chunks": -(-n // per_chunk), "budget_gb": budget / 1e9, "peak_gb": peak / 1e9,
                "sign_s": sign_s, "signs_per_s": n / sign_s})
    print(f"[sphincs memory] {SLH_WIDEST}: sign_batch of {n} in {out['chunks']} chunks of up "
          f"to {per_chunk}: peak {peak / 1e9:.2f} GB above the start, budget "
          f"{budget / 1e9:.2f} GB; {sign_s:.3f} s ({out['signs_per_s']:.0f} signs/s)")
    if out["chunks"] != SLH_CHUNKS:
        raise PhaseFailed(f"sphincs memory: {out['chunks']} chunks, not {SLH_CHUNKS}")
    if peak > budget:
        raise PhaseFailed(f"sphincs memory: peak {peak} bytes over the budget of {budget}")
    if not oks.all():
        raise PhaseFailed(f"sphincs memory: {int((~oks).sum())} of {n} signatures rejected")
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


def phase_profile(torch, label: str, fn, reps: int) -> dict:
    """Where a batch of ``fn`` spends device time: torch.profiler over
    ``reps`` warm batches; device time per kernel (ours and PyTorch's), and
    the device busy share of that window from its trace.  The same window
    is also timed without the profiler, which slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    plain_wall_us = 1e6 * (time.perf_counter() - t0)
    window = f"{label}_window"
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(window):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        window_us, busy_us = busy_share(events, window)
        launches = sum(1 for e in events if e.get("cat") == "kernel")
    device_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                 and ev.key != window}  # the annotation's own span on the GPU
    total_us = sum(device_us.values())
    ours = ("::sponge_kernel<", "::sample_ntt_kernel(", "::prf_cbd_kernel<", "::ntt_kernel<",
            "::rej_ntt_kernel(", "::rej_bounded_kernel<", "::sponge_varlen_kernel<",
            "::chacha_kernel(", "::a_times_s_kernel<", "::s_times_a_kernel<", "::cdf_kernel(",
            "::sha256_kernel(", "::sha512_kernel(")
    ours_us = sum(v for k, v in device_us.items() if any(o in k for o in ours))
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:12]
    out = {"batches": reps, "window_ms_per_batch": window_us / reps / 1e3,
           "busy_ms_per_batch": busy_us / reps / 1e3, "device_busy_share": busy_us / window_us,
           "unprofiled_wall_ms_per_batch": plain_wall_us / reps / 1e3,
           "device_ms_per_batch": total_us / reps / 1e3,
           "port_kernels_ms_per_batch": ours_us / reps / 1e3, "device_kinds": len(device_us),
           "kernel_launches_per_batch": launches / reps,
           "top_device_ms_per_batch": [[k, v / reps / 1e3] for k, v in top]}
    print(f"[profile] {label} batch under the profiler: window {out['window_ms_per_batch']:.3f}"
          f" ms, device busy {out['busy_ms_per_batch']:.3f} ms (busy share "
          f"{out['device_busy_share']:.3f}, from the trace); without the profiler the same "
          f"window takes {out['unprofiled_wall_ms_per_batch']:.3f} ms per batch")
    print(f"[profile] {label}: kernel time {out['device_ms_per_batch']:.3f} ms per batch, of "
          f"which the port's kernels {out['port_kernels_ms_per_batch']:.3f} ms; "
          f"{len(device_us)} kinds, {out['kernel_launches_per_batch']:.0f} launches")
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
        from quantum_resistant_p2p_tpu_torch import provider
        from quantum_resistant_p2p_tpu_torch.core import (chacha, chacha_cuda, keccak, keccak_cuda,
                                                          sha256, sha256_cuda, sha512,
                                                          sha512_cuda)
        from quantum_resistant_p2p_tpu_torch.entry import entry
        from quantum_resistant_p2p_tpu_torch.kem import frodo, frodo_cuda, mlkem, mlkem_cuda
        from quantum_resistant_p2p_tpu_torch.provider import (BatchedKEM, BatchedSignature,
                                                              get_kem, get_signature, health)
        from quantum_resistant_p2p_tpu_torch.sig import mldsa, mldsa_cuda, slhdsa_params, sphincs
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
                "mlkem_ntt": mlkem_cuda.ntt, "mlkem_ntt_inv": mlkem_cuda.ntt_inv,
                "mldsa_rej_ntt": mldsa_cuda.rej_ntt, "mldsa_rej_bounded": mldsa_cuda.rej_bounded,
                "mldsa_ntt": mldsa_cuda.ntt, "mldsa_ntt_inv": mldsa_cuda.ntt_inv,
                "keccak_sponge_varlen": keccak_cuda.sponge_varlen,
                "chacha_blocks": chacha_cuda.chacha_blocks,
                "frodo_a_times_s": frodo_cuda.a_times_s, "frodo_s_times_a": frodo_cuda.s_times_a,
                "frodo_cdf_sample": frodo_cuda.cdf_sample,
                "sha256_compress": sha256_cuda.compress, "sha512_compress": sha512_cuda.compress}
    sources = {"keccak_sponge": "quantum_resistant_p2p_tpu_torch/csrc/sponge.cu",
               "keccak_sponge_varlen": "quantum_resistant_p2p_tpu_torch/csrc/sponge.cu",
               "chacha_blocks": "quantum_resistant_p2p_tpu_torch/csrc/chacha.cu",
               "sha256_compress": "quantum_resistant_p2p_tpu_torch/csrc/sha2.cu",
               "sha512_compress": "quantum_resistant_p2p_tpu_torch/csrc/sha2.cu"}
    for prefix in ("mldsa", "frodo"):
        sources.update({n: f"quantum_resistant_p2p_tpu_torch/csrc/{prefix}.cu" for n in wrappers
                        if n.startswith(prefix)})

    try:
        ptxas = phase_build(cuda)
        sass = keccak_round_sass(cuda)
        sass["chacha_kernel"] = kernel_sass_opcodes(cuda, "chacha", "chacha_kernel")
        sass.update(sha2_block_sass(cuda))
        sha2_ops = {k: sass[k]["int_pipe_ops"] for k in ("sha256_kernel", "sha512_kernel")}
        rows = phase_kernels(torch, np, keccak, keccak_cuda, mlkem, mlkem_cuda, mldsa, mldsa_cuda,
                             chacha, chacha_cuda, frodo, frodo_cuda,
                             (sha256, sha256_cuda, sha512, sha512_cuda), sha2_ops, int_rate)
        phase_kat(torch, mlkem)
        phase_kat_mldsa(torch, mldsa)
        phase_kat_frodo(torch, frodo)
        phase_kat_chacha(torch, np, chacha)
        phase_kat_slhdsa(torch, sphincs, slhdsa_params)
        kem, dsa = get_kem("ML-KEM-768"), get_signature("ML-DSA-65")
        if (kem.backend, dsa.backend) != ("cuda", "cuda"):
            raise PhaseFailed(f"default backends are {kem.backend}, {dsa.backend}")
        fused, aead = provider.get_fused(kem, dsa), provider.get_batched_aead(AEAD)
        pk_off, ct_off = provider.init_pk_offset(kem.name, AEAD), provider.resp_ct_offset()
        verdicts = phase_health(provider, health, kem, dsa, fused, aead, pk_off, ct_off)
        verdicts += phase_health_frodo(provider, health)
        verdicts += phase_health_sphincs(provider, health)

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
        served = asyncio.run(serve(BatchedKEM, kem))
        launches = {"serve": read("serve", KEM_KERNELS)}
        print_served("serve", kem.name, served)
        reset()
        flagship = phase_flagship(torch, mlkem, entry)
        launches["flagship"] = read("flagship", ENCAPS_KERNELS)

        reset()
        sig_served = asyncio.run(sig_serve(BatchedSignature, dsa))
        launches["sig_serve"] = read("sig serve", SIG_KERNELS)
        print(f"[sig serve] {SERVE_CLIENTS} clients, one ML-DSA-65 key (keygen "
              f"{sig_served['keygen_s']:.3f} s): signs/s "
              f"{[round(x, 1) for x in sig_served['signs_per_s']]} (cache miss, then hit), "
              f"verifies/s {sig_served['verifies_per_s']:.1f}; latency ms "
              f"{sig_served['latency_ms']}; opcache {sig_served['opcache']}")
        for op, st in sig_served["queues"].items():
            print(f"[sig serve] {op} queue: {st}")
        dsa_inputs = sig_flagship_inputs(torch, np, mldsa)
        reset()
        sig_flagship = phase_sig_flagship(torch, mldsa, dsa_inputs)
        launches["sig_flagship"] = read("sig flagship", SIG_PRE_KERNELS)

        cpu_dsa = get_signature("ML-DSA-65", backend="cpu")
        reset()
        shaken = asyncio.run(handshake(provider, kem, dsa, fused, cpu_dsa, pk_off, ct_off))
        launches["handshake"] = read("handshake", HANDSHAKE_KERNELS)
        print(f"[handshake] {HANDSHAKES} fused ML-KEM-768 + ML-DSA-65 handshakes (keys made "
              f"in {shaken['keygen_s']:.3f} s): {shaken['handshakes_per_s']:.1f} handshakes/s "
              f"({shaken['wall_s']:.3f} s), {shaken['trips_per_handshake']:.3f} queue ops a "
              f"handshake, each on one flush; {shaken['device_trips']} device trips in all, "
              f"flushes {shaken['flushes']}; latency ms {shaken['latency_ms']}")
        for op, sizes in shaken["flush_sizes"].items():
            print(f"[handshake] {op} flush sizes {sizes}")
        reset()
        plane = asyncio.run(data_plane(np, provider, aead, shaken["sessions"]))
        seal_inputs = seal_batch_inputs(np, shaken["sessions"])
        plane["seal_batch"] = phase_seal_batch(torch, aead, provider.get_symmetric(AEAD),
                                               seal_inputs)
        launches["data_plane"] = read("data plane", ("chacha_blocks",))
        print(f"[data plane] {plane['messages']} sessions each sealed and opened one 256-byte "
              f"message: {plane['round_trips_per_s']:.1f} round trips/s "
              f"({plane['wall_s']:.3f} s); queues {plane['queues']}")
        shaken.pop("sessions")  # session keys stay out of the printed detail

        frodo_kem = get_kem(FRODO_SHAKE)
        reset()
        frodo_served = asyncio.run(serve(BatchedKEM, frodo_kem))
        launches["frodo_serve"] = read("frodo serve", FRODO_KERNELS)
        print_served("frodo serve", frodo_kem.name, frodo_served)
        frodo_inputs = {name: frodo_batch_inputs(torch, np, frodo, name)
                        for name in (FRODO_AES, FRODO_SHAKE)}
        reset()
        frodo_batch = {name: phase_frodo_batch(torch, frodo, inputs)
                       for name, inputs in frodo_inputs.items()}
        launches["frodo_batch"] = read("frodo batch", FRODO_ENCAPS_KERNELS)

        reset()
        slh_served, slh_signed = asyncio.run(sphincs_serve(torch, provider, sphincs,
                                                           slhdsa_params))
        launches["sphincs_serve"] = read("sphincs serve", ("sha256_compress",))
        slh_inputs = {name: sphincs_batch_inputs(torch, np, slhdsa_params, name, batch)
                      for name, batch in SLH_BATCHES}
        slh_batch, slh_outputs = {}, {}
        for name, inputs in slh_inputs.items():
            reset()
            slh_batch[name], slh_outputs[name] = phase_sphincs_batch(torch, sphincs, inputs)
            launches[f"sphincs_batch_{name}"] = read(
                f"sphincs batch {name}",
                ("sha256_compress",) + (("sha512_compress",) if inputs[0].big_hash else ()))
        reset()
        slh_memory = phase_sphincs_memory(torch, np, provider, sphincs, slhdsa_params)
        launches["sphincs_memory"] = read("sphincs memory", ("sha256_compress",
                                                             "sha512_compress"))

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
        pd = mldsa.MLDSA65
        _, _, pre_sk, pre_pk, dmu, drnd = dsa_inputs
        (dpk, dsk), per_op["mldsa_keygen"] = count(lambda: mldsa.keygen(pd, d))
        (dsig, _), per_op["mldsa_sign"] = count(lambda: mldsa.sign_mu(pd, dsk, dmu, drnd))
        _, per_op["mldsa_verify"] = count(lambda: mldsa.verify_mu(pd, dpk, dmu, dsig))
        for name, (fp, fpk, fsk, fpre, fmu) in frodo_inputs.items():
            fs = fmu[:16]
            _, per_op[f"{name}_keygen"] = count(lambda: frodo.keygen(fp, fs, fs, fs))
            (fct, _), per_op[f"{name}_encaps"] = count(lambda: frodo.encaps(fp, fpk[:16], fs))
            _, per_op[f"{name}_decaps"] = count(lambda: frodo.decaps(fp, fsk[:16], fct))
            _, per_op[f"{name}_encaps_pre"] = count(lambda: frodo.encaps_pre(fp, fpre, fs))
        sp, sseeds, sr, sdigest = slh_inputs[SLH_BATCHES[0][0]]
        skg, ssign, sverify = sphincs.get(sp.name)
        spk, ssk, ssig = slh_outputs[sp.name]
        _, per_op["sphincs_128f_keygen"] = count(lambda: skg(*(x[:16] for x in sseeds)))
        _, per_op["sphincs_128f_sign"] = count(lambda: ssign(ssk[:16], sr[:16], sdigest[:16]))
        _, per_op["sphincs_128f_verify"] = count(lambda: sverify(spk[:16], sdigest[:16],
                                                                 ssig[:16]))
        print(f"[launches] per batched op: {per_op}")
        fn, args = entry()
        profiled = {
            "flagship": phase_profile(torch, "flagship", lambda: fn(*args), 5),
            "sign": phase_profile(torch, "sign",
                                  lambda: mldsa.sign_mu_pre(pd, pre_sk, dmu, drnd), 1),
            "verify": phase_profile(torch, "verify",
                                    lambda: mldsa.verify_mu_pre(pd, pre_pk, dmu, dsig), 5),
            "seal": phase_profile(torch, "seal", lambda: aead.seal_batch(*seal_inputs), 1)}
        fp, fpk, _, _, fmu = frodo_inputs[FRODO_SHAKE]
        profiled["frodo_encaps"] = phase_profile(torch, "frodo_encaps",
                                                 lambda: frodo.encaps(fp, fpk, fmu), 1)
        profiled["sphincs_sign_128f"] = phase_profile(torch, "sphincs_sign_128f",
                                                      lambda: ssign(ssk, sr, sdigest), 1)
        vp = slhdsa_params.PARAMS[SLH_SERVE]
        vpks, vmsgs, vsigs = slh_signed
        vdigests = [list(slhdsa_params.h_msg(vp, sig[: vp.n], bytes(pk[: vp.n]),
                                             bytes(pk[vp.n:]), m))
                    for pk, m, sig in zip(vpks, vmsgs, vsigs)]
        vargs = (torch.from_numpy(np.asarray(vpks)).to("cuda"),
                 torch.tensor(vdigests, dtype=torch.uint8, device="cuda"),
                 torch.tensor([list(sig) for sig in vsigs], dtype=torch.uint8, device="cuda"))
        vverify = sphincs.get(vp.name)[2]
        if not bool(vverify(*vargs).all()):
            raise PhaseFailed("profile: the 128s verify batch rejects a signature")
        profiled["sphincs_verify_128s"] = phase_profile(torch, "sphincs_verify_128s",
                                                        lambda: vverify(*vargs), 1)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    # one entry per kernel wrapper at its main-path shapes; the sponge's
    # three calls (H, G, J) are summed, eta = 3 and K8's 64 KiB shape stay
    # in the detail line
    kernels = []
    for name in wrappers:
        mine = [r for r in rows if r["name"] == name]
        nbytes, ops = sum(r["bytes"] for r in mine), sum(r["int32_ops"] for r in mine)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / int_rate
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, "quantum_resistant_p2p_tpu_torch/csrc/mlkem.cu"),
            "replaces": mine[0]["replaces"],
            "launches": sum(counts[name] for counts in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if any(r["library_ms"] is None for r in mine)
                           else sum(r["library_ms"] for r in mine)),
            "shapes": [r["shape"] for r in mine]})
    print(json.dumps({"detail": {"ptxas": ptxas, "keccak_round_sass": sass,
                                 "kernel_rows": rows, "serve": served, "flagship": flagship,
                                 "sig_serve": sig_served, "sig_flagship": sig_flagship,
                                 "health": verdicts, "handshake": shaken, "data_plane": plane,
                                 "frodo_serve": frodo_served, "frodo_batch": frodo_batch,
                                 "sphincs_serve": slh_served, "sphincs_batch": slh_batch,
                                 "sphincs_memory": slh_memory,
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
