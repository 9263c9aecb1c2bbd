#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quantum_resistant_p2p_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1) if anything is wrong:

1. build     compile csrc/sponge.cu, csrc/mlkem.cu, csrc/mldsa.cu,
             csrc/chacha.cu, csrc/frodo.cu and csrc/sha2.cu with nvcc
             (sm_90a), all at once, and print the ptxas register/spill
             summary, the SASS of K1's round loops (the rows path's and the
             split path's), K8's opcodes and those of K12's and K13's loops
             (both paths; their bound counts a fixed work a block instead);
2. kernels   run every kernel and its plain PyTorch version on the GPU at
             the shapes of the batch-4096 ML-KEM-768 and ML-DSA-65 paths:
             K1 at H, G and J, at one ML-DSA-65 sign attempt's ExpandMask,
             c~ and SampleInBall, at FrodoKEM-640-SHAKE's noise stream and
             one chunk of its A rows (B = 1024), at HQC-256's seedexpand of
             pk_seed (41 B -> 7,205 B) and its K(m || u || v) (14,438 B ->
             64) at B = 1024 and at B = 1, and at the H shape just
             below and past its split rule; K1 with per-row lengths on 4096
             transcripts of up to 3458 bytes; K7 forward and inverse at
             4096, 20480 and 24576 polynomials; K8 on 4096 x 65 and 4096 x
             1025 ChaCha20 blocks, K9 and K10 at FrodoKEM-640-SHAKE, B = 1024
             (BASELINE.json config 3's batch) and FrodoKEM-1344-SHAKE,
             B = 256, and K11 at the sample count of that 640 encaps batch,
             K12 at a 128f chain step (1024 x 8 x 35 rows) and at the 128f
             FORS leaves (1024 x 33 x 64) of B = 1024, K13 at 192f's first
             FORS level of B = 256 (256 x 33 x 128), both over 10-block rows
             (a WOTS public key's T_l: 128f and 192f sign, and K12 at a
             128s verify flush of 2048) too and at 10-block rows just below
             and at the path rule's edge, each by the rule's path and by
             the other path forced; require bitwise equality, and
             time each kernel with CUDA events, as the host launches it
             (ms) and on the device alone (device_ms: the launch enqueued
             while the GPU sleeps; K11 beside torch.searchsorted); K3 also
             at eta 2 over 4096 and 16384 rows (the serve shape, and e1 + e2
             of one encaps batch in one launch), K4's inverse also at 4096
             polynomials (the flagship's v), K5 also at 122880 rows
             (ExpandA of 4096 ML-DSA-65 keys), and K6 at eta 4 and 2 over
             11264 rows (ExpandS of 1024 keys) and at eta 4 over 90112
             (ExpandS of 8192 keys, BASELINE.json config 4's batch);
3. kat       tests/vectors/mlkem_768.json through keygen/encaps/decaps,
             tests/vectors/mldsa_65.json through keygen/sign/verify and the
             six tests/vectors/frodo_*.json through keygen/encaps/decaps on
             the GPU, byte-exact; the RFC 8439 §2.3.2 block, §2.5.2 Poly1305
             and §2.8.2 AEAD vectors through core.chacha on the GPU; the
             six tests/vectors/slhdsa_*.json through keygen/sign/verify and
             the keygen records of acvp_slhdsa128f_fixture.json on the GPU;
             the health gate (ML-KEM-768 KAT, ML-DSA-65 round trip, fused
             keygen_sign, AEAD KAT, FrodoKEM-640-SHAKE KAT, FrodoKEM-640-AES
             round trip, SPHINCS+-SHA2-128s and -128f round trips, the
             pinned HQC-128 vector) on the "cuda" providers with their
             "cpu" twins;
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
11b. hqc     the three tests/vectors/hqc_*.json files and the stanzas of
             PQCgenKAT_hqc128_fixture.rsp (seeds by the KAT harness's
             AES-256 CTR-DRBG, on the host) through keygen/encaps/decaps on
             the GPU, byte-exact, a tampered ciphertext giving K(sigma ||
             u || v); phase 4 over get_kem("HQC-128") (no operand cache);
             keygen, encaps and decaps at B = 1024 of HQC-128 and HQC-256
             (published parameters), the first rows held to the CPU path,
             the odd rows' tampered ciphertexts to their rejection secret and
             the RM and RS decoders to the CPU path on 64 uniform words (most
             RM blocks tied),
             timed with CUDA events and the host clock, with each op's kernel
             launches and K1's device ms (profiler), K1's launches and its
             peak device memory a row;
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
14. obs and faults  the observability and fault layer on the GPU
             providers: warmup() of BatchedKEM (ML-KEM-768),
             BatchedSignature (ML-DSA-65), BatchedFused and BatchedAEAD
             (ChaCha20-Poly1305) under a cost ledger (each one compile
             event); 1024 ML-KEM-768 clients, then 256 fused handshakes,
             under the process tracer with a fresh ledger: one queue.flush
             and one device.dispatch span a flush, each dispatch under its
             flush, the Chrome trace parses, the ledger's device seconds
             are the queues' device histograms' (within 1e-6 s), secrets
             agree; a seeded FaultPlan raising at one ML-KEM-768.enc flush
             and poisoning one slot of a ML-KEM-768.dec flush: exactly those
             futures raise FaultInjected, every other secret agrees, the
             plan's log holds the two faults; 512 bulk and 64
             handshake-lane seals against a bulk capacity of 64: the excess
             is shed with LaneShed and counted, every handshake-lane seal
             served, every frame opens; obs.trace.device_trace around one
             flagship batch holds CUDA kernel events; before it, the serve
             rate of phase 4 with the process tracer and with spans off,
             five serves each, in turns;
15. transport  the transport, session and degrade layers on the GPU
             providers: BatchedKEM, BatchedSignature, BatchedFused and
             BatchedAEAD over one DeviceProgramScheduler (one shard, a
             0.2 s cool-off) with the "cpu" providers and the scalar AEAD
             as their fallbacks, under a cost ledger and an Autotuner; the
             health gate into a fresh verdict cache runs every probe, a
             second gate reads every verdict back; 64 fused handshakes;
             two P2PNodes on 127.0.0.1 negotiate bin1; 256 ML-KEM-768 key
             agreements across the wire in two waves (B's keys to A, A's
             encaps, the ciphertexts back as raw fields, B's decaps) under
             a seeded FaultPlan that raises at the 2nd ML-KEM-768.enc
             flush: its ops are served by the cpu fallback and agree with
             B's device decaps, the breaker trips once, and after the
             cool-off the next flush is the canary on the device and the
             breaker closes (the flight ring holds breaker_open, then the
             close); 1024 messages of 256 B sealed by the AEAD facade, one
             dropped by the plan's net.send rule, the rest opened from the
             frames' memoryviews into a MessageStore in order; one 96 KiB
             message chunked and reassembled; a resumption ticket minted
             by B's STEKRing, A's disconnect and reconnect, the resumed
             key on both sides and a message under it; a replayed and a
             corrupted ticket refused as replayed_ticket and
             bad_ticket_auth; no queue but the faulted one served by its
             fallback, the breaker closed at the end; the largest
             dispatch a queue against degrade_after_ms and
             dispatch_timeout_ms, the ledger's shard_device_time against
             the device histograms, and phase 4's serve rate through the
             scheduler, breaker and autotuner against the plain queues in
             five alternating pairs;
16. engine   in a fresh process of its own on the same card (its launch
             counts come back with its result), the port's
             SecureMessaging (app/messaging.py) between port
             nodes on 127.0.0.1, every engine "cuda" with ML-KEM-768 x
             ML-DSA-65 (fused) and ChaCha20-Poly1305 (the device data
             plane): a gateway, a second gateway with the autotuner off,
             client 0 with queues of its own (autotuner off), and 32
             burst client engines sharing one more engine's queues (as the
             reference's swarm bench builds its clients: many engines'
             device threads in one process launch far slower than one),
             each batched engine gated and warmed by its own warm-up
             thread before the next is built; every engine ready with
             every breaker closed; client 0's handshake alone in at most 4
             trips on its fused queues (no per-op KEM keygen), the keys
             agreeing; every burst client at once against the tuned and
             the static gateway in turns (every key agrees, one
             encaps_verify_sign op a handshake; flush sizes, handshakes/s
             and each client's handshake_latency_s printed); 128 secure
             messages of 256 B sent at once from client 0, signed, sealed,
             opened and verified through the engines' queues, arriving in
             order (one open op each); a ticket resume on a fresh
             connection with no fused, KEM or signature op; a forged
             secure_message that
             reaches no listener and makes the gateway re-key; an
             ML-KEM-1024 client refused with a typed algorithm_mismatch; a
             hot swap of both sides to FrodoKEM-640-SHAKE (the unfused
             path, K9-K11), then to HQC-128 (unfused, K1), each with a full
             re-handshake and messages after it;
             the gateway's /healthz, /readyz and /metrics answering; no
             queue of any engine served by its fallback, every breaker
             closed, every engine ready; the largest device dispatch a
             queue against degrade_after_ms and dispatch_timeout_ms;
17. profile  torch.profiler over the KEM flagship, one sign batch, five
             verify batches, one 4096 x 4 KiB seal batch, one
             FrodoKEM-640-SHAKE encaps batch of 1024 keys, one HQC-128
             encaps batch of 1024 keys, one 128f sign batch of 1024 and
             one 128s verify batch of 2048: device time per kernel (K1's,
             K7's, K2's, K3's, K4's, K5's, K6's, K12's and K13's apart,
             K12's and K13's few-row path also alone), launches, K1's
             wrapper launches beside the trace's, and the device busy
             share of each window from its trace (after the counts are
             read);
18. fleet    in a fresh process of its own (``--fleet-phase``; the parent
             reaps its gateways whatever happens), the port's GatewayFleet
             of 3 gateway processes (``python -m
             quantum_resistant_p2p_tpu_torch.fleet.gateway``) on "cuda",
             each serving ML-KEM-768 x ML-DSA-65 (fused) and
             ChaCha20-Poly1305 with its facades pre-warmed to 32 rows,
             behind the router in the phase's process; 24 client engines
             sharing one engine's queues each ask the router for their
             gateway, handshake at once and send two messages, the second
             round sent once the gateways have opened every first one (the
             heartbeats' message counts); a FaultPlan process rule
             SIGKILLs the gateway the seed picks among those holding
             sessions: its fleet breaker opens within hb_miss_limit x
             hb_interval + 1 s, its clients re-route with it excluded and
             resume with their tickets on their ring successors (no KEM
             or signature op there), every client sends one more message
             that arrives, and no other client re-handshakes;
             restart_member brings the gateway back, its clients return
             to it by ticket and each sends a message; stop() collects
             every gateway's bye (device_served_fraction 1.0, no fallback
             op or trip, the breaker closed, ops > 0, K1-K8 launched) and
             slo_report.json (merged by obs.slo.merge_reports), and no
             gateway process is left; printed: each gateway's seconds from
             spawn to hello, the burst's handshakes/s beside phase 16's,
             the seconds from kill to breaker open, the resumes' p50 and
             max, the device memory a gateway process takes (the card's
             free memory before and after the spawns) and the phase's
             seconds.

Every kernel wrapper counts its launches. The counts are set to 0 just
before each of phases 4-16 (11b included) and read just after it: every
ML-KEM kernel must have run in phase 4, every kernel that encaps runs in
phase 5, every ML-DSA kernel and K1 in phase 6, K1 and K7 in phase 7,
every kernel but K8 (K1 with per-row lengths included) in phase 8, K8 in
phase 9, K1 and K9-K11 in phase 10, K1, K10 and K11 in phase 11, K1 in
phase 11b, K12 in phase 12 and in each set of phase 13, and K13 in phase
13's 192f run and in its memory check; K12's few-row path in phase 12
and 13's 128f run, K13's in 13's 192f run; every kernel of phase 8 and
K8 in phases 14, 15 and 16, K1 and K9-K11 in phase 16's re-handshake after
its FrodoKEM swap, and K1 from HQC's own SHAKE256 calls (counted on their
calling threads, the handshake's signatures apart) in its re-handshake
after the HQC swap.  Phase 18's counts are its gateways', from their
bye frames (each gateway process counts from 0): every kernel of phase 8
and K8, and each gateway that ran full handshakes must have launched the
responder's kernels (K1, K1 with per-row lengths, K2, K3, K4's inverse,
K5, K7 and K8) after it registered.  The last three lines of
output are the card's name and power limit (nvidia-smi), one JSON object
with key "kernels", and the result
line {"ok": true, "device": {...}}.  Without a GPU, or without the package
beside this file, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import re
import shutil
import statistics
import hmac
import os
import random
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
#: the lazy Shoup butterfly mod 3329 of K3's fused NTT and K4: the product
#: up to one q (umulhi, multiply, multiply-add), then a + 2q - t (one
#: 3-input add) and a + t forward, or b + M - a and a + b inverse.  Values
#: stay below 2^16 forward and 2^19 inverse, so no conditional subtract.
KEM_LAZY_BUTTERFLY_OPS = 3 + 2
#: forward: + the final reduction of each coefficient to [0, q) (umulhi,
#: multiply-add, subtract, unsigned min)
KEM_LAZY_NTT_OPS = 7 * 128 * KEM_LAZY_BUTTERFLY_OPS + 256 * 4
#: inverse: + the scaling by 128^-1 folded into the last layer, where each
#: butterfly takes a second Shoup product and both outputs a subtract and
#: an unsigned min
KEM_LAZY_NTT_INV_OPS = 7 * 128 * KEM_LAZY_BUTTERFLY_OPS + 128 * (3 + 2 * 2)
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
#: ~1.5 ms of GPU sleep before each timed kernel run (device_ms)
SLEEP_CYCLES = 3_000_000
#: csrc/sponge.cu's kRowsPerSm: K1 runs a sponge a thread from this many
#: rows an SM on, five lanes a sponge below it
K1_ROWS_PER_SM = 64
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
#: the work of one compression, whatever path runs it, counted from the
#: algorithm and split by pipe.  Only the 64-lane integer pipe runs
#: rotations (SHF), logic (LOP3, three inputs) and byte swaps (PRMT); adds
#: (IADD3, three inputs) and plain shifts run there or on the FMA pipe
#: beside it, as IMAD / IMAD.HI, 64 lanes an SM more.  SHA-256, a block:
#: 16 byte swaps; 48 schedule words of 4 rotations and 2 XORs (sigma0,
#: sigma1), 2 shifts and 2 adds; 64 rounds of 6 rotations and 4 LOP3
#: (Sigma0, Sigma1, Ch, Maj) and 4 adds; 8 feedforward adds.  SHA-512 in
#: 32-bit halves (a 64-bit rotation or XOR is two, a 64-bit shift one
#: funnel shift and one plain shift, a 64-bit add two with the carry): 32
#: byte swaps; 64 schedule words of 14 integer-pipe and 6 other operations;
#: 80 rounds of 20 and 8; 16 feedforward adds.
SHA256_INT_PIPE_OPS = 16 + 48 * 6 + 64 * 10              # 944
SHA256_ALL_OPS = SHA256_INT_PIPE_OPS + 48 * 4 + 64 * 4 + 8  # 1,400
SHA512_INT_PIPE_OPS = 32 + 64 * 14 + 80 * 20             # 2,528
SHA512_ALL_OPS = SHA512_INT_PIPE_OPS + 64 * 6 + 80 * 8 + 16  # 3,568
#: K12's and K13's bound charges a block the larger of its integer-pipe
#: operations and half of all its operations (two pipes), in integer-pipe
#: slots: 944 and 2,528, the integer pipe's share either way.  The rows
#: path's SASS has 1,286 / 3,421 integer-pipe instructions a block: its adds
#: issue as IADD3 there, work the FMA pipe could take, so its count is not
#: the work's.  The build phase prints each path's loops beside it.
SHA256_BLOCK_OPS = max(SHA256_INT_PIPE_OPS, -(-SHA256_ALL_OPS // 2))
SHA512_BLOCK_OPS = max(SHA512_INT_PIPE_OPS, -(-SHA512_ALL_OPS // 2))
#: SASS opcodes that do not issue on the 64-lane integer pipe: IMAD goes to
#: the FMA pipe beside it (K8's finding), U* run once a warp on the uniform
#: datapath, memory, barriers and branches elsewhere
NON_INT_PIPE = ("IMAD", "LDG", "STG", "LDS", "STS", "BAR", "BRA", "NOP", "EXIT")
#: K12's and K13's SPHINCS+ shapes: (name, states, rows a state, blocks a
#: row, what)
SHA2_SHAPES = (("sha256_compress", 1024, 8 * 35, 1, "128f chain step, B = 1024"),
               ("sha256_compress", 1024, 33 * 64, 1, "128f FORS leaves, B = 1024"),
               ("sha256_compress[T_l]", 1024, 8, 10, "128f WOTS pk T_l, B = 1024"),
               ("sha256_compress[T_l verify]", 2048, 1, 10,
                "128s WOTS pk T_l of a verify flush of 2,048"),
               ("sha512_compress", 256, 33 * 128, 1, "192f FORS level 1, B = 256"),
               ("sha512_compress[T_l]", 256, 8, 10, "192f WOTS pk T_l, B = 256"))
#: K12/K13's kernels (csrc/sha2.cu): the rows path and the few-row path
SHA2_KERNELS = {"sha256_compress": ("sha256_kernel", "sha256_split_kernel"),
                "sha512_compress": ("sha512_kernel", "sha512_split_kernel")}
#: the obs and faults phase: fused handshakes traced after the ML-KEM-768
#: clients, the clients of the faulted queues, the bulk lane's capacity and
#: the bulk and handshake-lane seals submitted against it, the plan's seed
OBS_HANDSHAKES, FAULT_CLIENTS = 256, 256
LANE_CAP, BULK_SEALS, LANE_SEALS = 64, 512, 64
FAULT_SEED = 12
#: the serve rate with spans on and off: five pairs, which side runs first
#: alternating
SERVE_RATE_ORDER = ("tracer", "no_tracer", "no_tracer", "tracer") * 2 + ("tracer", "no_tracer")
#: the transport phase: key agreements over the wire (two waves, the
#: second's encaps flush faulted), sealed messages of MESSAGE_BYTES and the
#: one the plan drops, a message past the 64 KiB chunk size, the fused
#: handshakes through the scheduled facades, the breaker's cool-off, the
#: longest wait for a message, and the serve-rate turns against phase 4
AGREEMENTS, MESSAGES, MESSAGE_BYTES, DROP_NTH = 256, 1024, 256, 100
BIG_MESSAGE, TRANSPORT_HANDSHAKES, TRANSPORT_SEED = 96 * 1024, 64, 15
TRANSPORT_COOLOFF_S, TRANSPORT_WAIT_S = 0.2, 60.0
#: serve-rate arms: phase 4's plain queues, the scheduler and its breaker,
#: and the same with the autotuner attached, five rounds in rotating order
SCHED_RATE_ARMS, SCHED_RATE_ROUNDS = ("plain", "scheduled", "tuned"), 5
#: the engine phase: the burst clients (SecureMessaging engines sharing one
#: engine's queues; client 0, with queues of its own, comes on top), the
#: secure messages client 0 sends after its handshake and their size (128:
#: at 1024 the gateway's one-at-a-time opens took 294 s, PERF.md §7 item 8),
#: the messages after the FrodoKEM hot swap, the handshake bursts' gateway
#: (tuned: autotune=True, static: autotune=False) in turn, the trips a lone
#: handshake may take, the longest wait of the phase's checks, and the wait for the
#: secure messages (the gateway opens and verifies them one at a time)
ENGINE_CLIENTS, ENGINE_MESSAGES, ENGINE_MESSAGE_BYTES = 32, 128, 256
#: phase "hqc": the published sets run at HQC_BATCH (nothing cut), the set
#: the serve and the gate run, the vector files and the PQCgenKAT fixture
HQC_BATCH, HQC_BATCHES, HQC_SERVE = 1024, ("HQC-128", "HQC-256"), "HQC-128"
HQC_VECTORS, HQC_RSP = ("128", "192", "256"), "PQCgenKAT_hqc128_fixture.rsp"
#: uniform words through the decoders, card against CPU
HQC_DECODE_ROWS = 64
#: the phase 16 hot swaps, in order: FrodoKEM (the unfused path on K9-K11),
#: then HQC (the unfused path on K1 and PyTorch)
ENGINE_SWAP_MESSAGES, ENGINE_SWAP_KEMS = 16, (FRODO_SHAKE, HQC_SERVE)
#: phase 16's count of the K1 launches inside HQC's own SHAKE256 calls
HQC_OWN_K1 = "keccak_sponge[HQC's own]"
ENGINE_BURSTS = ("tuned", "static", "static", "tuned")
ENGINE_TRIPS_MAX, ENGINE_WAIT_S, ENGINE_MESSAGES_WAIT_S = 4, 120.0, 300.0
ENGINE_PROCESS_TIMEOUT_S = 900.0
#: host threads of the phase's process, each signing ENGINE_THREAD_SIGNS
#: ML-DSA-65 messages at B = 1, after the phase (PERF.md §7 item 8)
ENGINE_THREADS, ENGINE_THREAD_SIGNS = (1, 4, 8), 4
#: phase 18, the fleet: gateway processes, the client engines (all sharing
#: one engine's queues in the phase's process), the seed of the fleet's
#: ring and of the kill's pick, the facades' pre-warm cap (the clients'
#: count rounded up to a power of two), the margin over hb_miss_limit x
#: hb_interval within which the killed gateway's breaker must open, the
#: longest wait of the phase's checks, and the phase process's limit
FLEET_GATEWAYS, FLEET_CLIENTS, FLEET_SEED = 3, 24, 18
FLEET_PREWARM = 1 << (FLEET_CLIENTS - 1).bit_length()
FLEET_OPEN_MARGIN_S, FLEET_WAIT_S, FLEET_PROCESS_TIMEOUT_S = 1.0, 120.0, 600.0
#: how long the fleet waits for its gateways' hello: the manager's 60 s
#: default, raised because three gateway processes start at once on one
#: card, each importing the port, loading the kernel libraries, running its
#: health gate and warming buckets 1-FLEET_PREWARM of three facades (29.2-
#: 29.5 s on the H100, PERF.md §6 PR 16: 60 s would leave 2x of it)
FLEET_REGISTER_TIMEOUT_S = 90.0
#: the environment variable naming the file in which the phase's process
#: keeps its gateways' pids, for the parent to reap
FLEET_PID_FILE = "QRP2P_FLEET_PID_FILE"


class PhaseFailed(RuntimeError):
    pass


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median time of fn() in ms over reps runs, after one warm run, by CUDA
    events recorded around it: the host's time to launch its kernels
    counts wherever the GPU waits for it."""
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


def device_ms(torch, fn, reps: int) -> float:
    """Median device time of fn() in ms over reps runs: each run is
    enqueued while the GPU sleeps (torch.cuda._sleep), so the events hold
    the kernels' own time without the host's time to launch them, which
    cuda_ms counts."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
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
    of the innermost loops of 100 to 400 instructions and their opcodes:
    the rows path's round loop (keccak_f1600, kept rolled), to hold
    KECCAK_ROUND_OPS against what the card runs, and the split path's loop
    of two rounds on a fifth of the state.  Both must be found."""
    out = {}
    for fn, loops in sass_loops(cuda, "sponge").items():
        rounds = [lp for lp in loops if 100 <= lp["instructions"] <= 400]
        if rounds:
            out[fn] = rounds
    for fn, loops in out.items():
        print(f"[build] SASS {fn}: round loop instructions {[lp['instructions'] for lp in loops]};"
              f" opcodes of the first {loops[0]['opcodes']}")
    for path in ("sponge_rows_kernel", "sponge_split_kernel"):
        if not any(path in fn for fn in out):
            raise PhaseFailed(f"SASS: no round loop found in K1's {path}")
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
    """K12 and K13, as information: the opcodes of each kernel's innermost
    loops of 100 instructions or more (the rows path's block loop; the
    few-row path's schedule and round loops), integer-pipe and IMAD counts
    apart.  The bound does not read them (SHA256_BLOCK_OPS,
    SHA512_BLOCK_OPS); every kernel must have its loops."""
    out = {}
    for fn, loops in sass_loops(cuda, "sha2").items():
        kernel = next((k for ks in SHA2_KERNELS.values() for k in ks if k in fn), None)
        if kernel is None:
            continue
        out[kernel] = []
        for lp in sorted(loops, key=lambda lp: -lp["instructions"]):
            if lp["instructions"] < 100:
                continue
            ops = lp["opcodes"]
            alu = sum(c for op, c in ops.items() if not (op.startswith("U") or op in NON_INT_PIPE))
            out[kernel].append(dict(lp, int_pipe=alu, imad=ops.get("IMAD", 0)))
            print(f"[build] SASS {kernel}: loop of {lp['instructions']} instructions, {alu} on "
                  f"the integer pipe, {ops.get('IMAD', 0)} IMAD; opcodes "
                  f"{dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    want = {k for ks in SHA2_KERNELS.values() for k in ks}
    if {k for k, loops in out.items() if loops} != want:
        raise PhaseFailed(f"SASS: K12/K13 loops found in {sorted(out)}, want {sorted(want)}")
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


def sponge_case(name, keccak, keccak_cuda, x, rate, ds, out_len, shape):
    """A K1 case: bytes are the rows in and the digests out; operations
    4,320 a Keccak-f times the permutations each row needs."""
    rows, length = x.shape
    perms = length // rate + 1 + -(-out_len // rate) - 1
    return (name, f"{SRC}/core/keccak_pallas.py:177",
            lambda: keccak_cuda.sponge(x, rate, ds, out_len),
            lambda: keccak.sponge_plain(x, rate, ds, out_len),
            x.numel() + rows * out_len, rows * perms * KECCAK_F_OPS,
            f"{shape}: ({rows}, {length}) -> ({rows}, {out_len})")


def k1_k7_cases(torch, np, rng, keccak, keccak_cuda, mldsa, mldsa_cuda) -> list:
    """K1 and K7 at every shape the main path and FrodoKEM give them, and
    K1 on both sides of its split rule.  The untagged
    names (H + G + J, K7 at 24,576 polynomials, the varlen transcripts) are
    the ones the kernels line sums."""
    dev = torch.device("cuda")

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    from quantum_resistant_p2p_tpu_torch.kem.hqc_params import HQC256

    p = mldsa.MLDSA65
    edge = K1_ROWS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    fp_n, fp_rows = 640, 640 // 16  # FrodoKEM-640: n, and the rows of one of 16 A chunks
    # HQC-256's longest squeeze (h from pk_seed || 2) and longest absorb
    # (K over m || u || v || 4), at phase "hqc"'s batch and alone
    hqc_k = HQC256.k + HQC256.n_bytes + HQC256.n1n2_bytes + 1
    shapes = [("keccak_sponge", "H", BATCH, 1184, 136, 0x06, 32),
              ("keccak_sponge", "G", BATCH, 64, 72, 0x06, 64),
              ("keccak_sponge", "J", BATCH, 1120, 136, 0x1F, 32),
              ("keccak_sponge[ExpandMask]", "ML-DSA-65 sign attempt, ExpandMask",
               BATCH * p.l, 66, 136, 0x1F, 32 * p.z_bits),
              ("keccak_sponge[c~]", "ML-DSA-65 sign attempt, c~", BATCH, 64 + 128 * p.k, 136,
               0x1F, p.ctilde_len),
              ("keccak_sponge[SampleInBall]", "ML-DSA-65 sign attempt, SampleInBall", BATCH,
               p.ctilde_len, 136, 0x1F, 8 + 1024),
              ("keccak_sponge[Frodo noise]", "FrodoKEM-640-SHAKE encaps noise, B = 1024",
               FRODO_BATCH, 33, 168, 0x1F, (2 * 8 * fp_n + 64) * 2),
              ("keccak_sponge[Frodo A rows]", "FrodoKEM-640-SHAKE A, one chunk of 1024 keys",
               FRODO_BATCH * fp_rows, 18, 168, 0x1F, 2 * fp_n),
              ("keccak_sponge[1 row]", "H shape, one sponge: the split path's latency", 1,
               1184, 136, 0x06, 32),
              ("keccak_sponge[HQC seedexpand]", f"HQC-256 seedexpand(pk_seed), B = {HQC_BATCH}",
               HQC_BATCH, 41, 136, 0x1F, HQC256.n_bytes),
              ("keccak_sponge[HQC seedexpand, 1 row]", "HQC-256 seedexpand(pk_seed), B = 1", 1,
               41, 136, 0x1F, HQC256.n_bytes),
              ("keccak_sponge[HQC K]", f"HQC-256 K(m || u || v), B = {HQC_BATCH}", HQC_BATCH,
               hqc_k, 136, 0x1F, 64),
              ("keccak_sponge[HQC K, 1 row]", "HQC-256 K(m || u || v), B = 1", 1, hqc_k, 136,
               0x1F, 64),
              ("keccak_sponge[split edge - 1]", "H shape, last row count of the split path",
               edge - 1, 1184, 136, 0x06, 32),
              ("keccak_sponge[rows edge + 5]", "H shape, past the split rule", edge + 5, 1184,
               136, 0x06, 32)]
    cases = [sponge_case(name, keccak, keccak_cuda, u8(rows, length), rate, ds, out_len, what)
             for name, what, rows, length, rate, ds, out_len in shapes]
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
    # K7 at one sign attempt's widths: c (B), the l = 5 vectors, the k = 6
    for polys, tag in ((BATCH * p.k, ""), (BATCH * p.l, f"[{BATCH * p.l}]"), (BATCH, f"[{BATCH}]")):
        f = torch.from_numpy(rng.integers(0, mldsa.Q, size=(polys, 256), dtype=np.int32)).to(dev)
        for name, kern, plain, ops in (
                ("mldsa_ntt", mldsa_cuda.ntt, mldsa.ntt_plain, MLDSA_NTT_OPS),
                ("mldsa_ntt_inv", mldsa_cuda.ntt_inv, mldsa.ntt_inv_plain, MLDSA_NTT_INV_OPS)):
            cases.append((name + tag, f"{SRC}/sig/mldsa_pallas.py:227",
                          lambda k=kern, f=f: k(f), lambda pl=plain, f=f: pl(f),
                          2 * f.numel() * 4, polys * ops, f"({polys}, 256) int32"))
    return cases


def run_cases(torch, cases, library: dict, int_rate: float) -> list:
    """Each case's kernel against its plain version (bitwise), then its
    time as the host launches it (ms, cuda_ms), its device time alone
    (device_ms), the plain version's time, the bound, and the library
    call's time where there is one."""
    rows = []
    for name, replaces, kern, plain, nbytes, ops, shape in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise PhaseFailed(f"{name} {shape}: kernel differs from plain (max |err| {err})")
        ms, dev_ms = cuda_ms(torch, kern, 20), device_ms(torch, kern, 20)
        slow_plain = name.startswith(("frodo_", "sha", "keccak_sponge[Frodo",
                                      "keccak_sponge[HQC"))
        plain_ms = cuda_ms(torch, plain, 1 if slow_plain else 3)
        library_ms = cuda_ms(torch, library[name], 20) if name in library else None
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / int_rate
        bound_ms, bound_by = 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        rows.append({"name": name, "replaces": replaces, "shape": shape, "max_abs_err": err,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms, "bytes": nbytes,
                     "int32_ops": ops})
        lib_txt = f", library {library_ms:.4f} ms" if library_ms is not None else ""
        print(f"[kernels] {name} {shape}: equal, {ms:.4f} ms ({dev_ms:.4f} on the device "
              f"alone; plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}"
              f"{lib_txt})")
    return rows


def mlkem_sampler_cases(torch, np, rng, keccak, mlkem, mlkem_cuda) -> list:
    """K2 and K3 at the shapes of the batch-4096 ML-KEM-768 path: K2 over
    A (9 rows a key), K3 with and without the NTT at eta 2 and 3 over 3 rows
    a key, and K3 at eta 2 over 4,096 rows (one row a key) and 16,384 (e1
    and e2 of one encaps batch, one launch).  The untagged names are the
    ones the kernels line sums."""
    dev = torch.device("cuda")

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    seeds = u8(BATCH * 9, 34)
    cases = [("mlkem_sample_ntt", f"{SRC}/kem/mlkem_pallas.py:97",
              lambda: mlkem_cuda.sample_ntt(seeds), lambda: mlkem.sample_ntt_plain(seeds),
              seeds.numel() + 4 * 256 * seeds.shape[0],
              sample_ntt_perms(torch, keccak, mlkem.Q, seeds) * KECCAK_F_OPS,
              f"({BATCH * 9}, 34) -> ({BATCH * 9}, 256)")]
    shapes = [(eta, fused, BATCH * 3, "") for eta in (2, 3) for fused in (False, True)]
    shapes += [(2, False, BATCH, f"[{BATCH}]"), (2, False, BATCH * 4, f"[{BATCH * 4}]")]
    for eta, fused, rows, tag in shapes:
        prf = u8(rows, 33)
        name, line, kern, plain = (
            ("mlkem_prf_cbd_ntt", 315, mlkem_cuda.prf_cbd_ntt, mlkem.prf_cbd_ntt_plain) if fused
            else ("mlkem_prf_cbd", 159, mlkem_cuda.prf_cbd, mlkem.prf_cbd_plain))
        perms = 1 if eta == 2 else 2
        ops = rows * (perms * KECCAK_F_OPS + (KEM_LAZY_NTT_OPS if fused else 0))
        cases.append((name + (tag if eta == 2 else f"[eta=3]{tag}"),
                      f"{SRC}/kem/mlkem_pallas.py:{line}",
                      lambda k=kern, e=eta, x=prf: k(x, e), lambda p=plain, e=eta, x=prf: p(x, e),
                      prf.numel() + 4 * 256 * rows, ops,
                      f"eta={eta}: ({rows}, 33) -> ({rows}, 256)"))
    return cases


def k4_k5_cases(torch, np, rng, keccak, mlkem, mlkem_cuda, mldsa, mldsa_cuda) -> list:
    """K4 at u's 12,288 polynomials of the batch-4096 ML-KEM-768 path (3 a
    key), rows of 0 and of q - 1 among them, and the inverse at v's 4,096;
    K5 at ExpandA of the ML-DSA-65 keygen batch (30 rows a key) and of four
    times as many keys.  The untagged names are the ones the kernels line
    sums."""
    dev = torch.device("cuda")
    polys = torch.from_numpy(rng.integers(0, 3329, size=(BATCH * 3, 256), dtype=np.int32))
    polys[0], polys[1] = 0, 3328
    polys = polys.to(dev)
    cases = []
    for name, kern, plain, ops, f in (
            ("mlkem_ntt", mlkem_cuda.ntt, mlkem.ntt_plain, KEM_LAZY_NTT_OPS, polys),
            ("mlkem_ntt_inv", mlkem_cuda.ntt_inv, mlkem.ntt_inv_plain, KEM_LAZY_NTT_INV_OPS,
             polys),
            (f"mlkem_ntt_inv[{BATCH}]", mlkem_cuda.ntt_inv, mlkem.ntt_inv_plain,
             KEM_LAZY_NTT_INV_OPS, polys[BATCH:2 * BATCH].clone())):
        cases.append((name, f"{SRC}/kem/mlkem_pallas.py:253",
                      lambda k=kern, f=f: k(f), lambda p=plain, f=f: p(f),
                      2 * f.numel() * 4, f.shape[0] * ops, f"({f.shape[0]}, 256) int32"))
    p = mldsa.MLDSA65
    n_a = KEYGEN_KEYS * p.k * p.l
    for tag, rows in (("", n_a), (f"[{4 * n_a}]", 4 * n_a)):
        seeds = torch.from_numpy(rng.integers(0, 256, size=(rows, 34), dtype=np.uint8)).to(dev)
        cases.append((f"mldsa_rej_ntt{tag}", f"{SRC}/sig/mldsa_pallas.py:259",
                      lambda x=seeds: mldsa_cuda.rej_ntt(x),
                      lambda x=seeds: mldsa.rej_ntt_poly_plain(x),
                      seeds.numel() + 4 * 256 * rows,
                      rej_ntt_perms(torch, keccak, mldsa.Q, seeds) * KECCAK_F_OPS,
                      f"({rows}, 34) -> ({rows}, 256)"))
    return cases


def k6_cases(torch, np, rng, keccak, mldsa, mldsa_cuda) -> list:
    """K6 at ExpandS of the ML-DSA-65 keygen batch (11 rows a key) at both
    etas, and at eta 4 over ExpandS of 8,192 keys (BASELINE.json config
    4's batch: 90,112 rows, more warps than the card keeps resident).  The
    untagged name is the one the kernels line sums."""
    dev = torch.device("cuda")
    p = mldsa.MLDSA65
    cases = []
    for eta, keys in ((4, KEYGEN_KEYS), (2, KEYGEN_KEYS), (4, 8 * KEYGEN_KEYS)):
        rows = keys * (p.k + p.l)
        seeds = torch.from_numpy(rng.integers(0, 256, size=(rows, 66), dtype=np.uint8)).to(dev)
        tag = "" if eta == p.eta else f"[eta={eta}]"
        tag += "" if keys == KEYGEN_KEYS else f"[{rows}]"
        cases.append((f"mldsa_rej_bounded{tag}", f"{SRC}/sig/mldsa_pallas.py:130",
                      lambda e=eta, x=seeds: mldsa_cuda.rej_bounded(x, e),
                      lambda e=eta, x=seeds: mldsa.rej_bounded_poly_plain(x, e),
                      seeds.numel() + 4 * 256 * rows,
                      rej_bounded_perms(torch, keccak, seeds, eta) * KECCAK_F_OPS,
                      f"eta={eta}: ({rows}, 66) -> ({rows}, 256)"))
    return cases


def sha2_cases(torch, np, rng, sha2) -> list:
    """K12 and K13 (``sha2``: the modules sha256, sha256_cuda, sha512,
    sha512_cuda) as the SPHINCS+ phases launch them: one pk_seed midstate a
    signature serves its rows, and a WOTS public key's T_l is one launch
    over all its blocks (128f / 192f sign: 8 rows a signature; a 128s
    verify flush: one); then at 10 blocks a row just below and at the path
    rule's edge.  Each shape runs the rule's path, then the other path
    forced through ``sha256_cuda.launch`` (tagged).  Bytes: the states,
    the blocks, the words out; operations: the fixed work of a block
    (SHA256_BLOCK_OPS, SHA512_BLOCK_OPS)."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    cases = []
    sha256, sha256_cuda, sha512, sha512_cuda = sha2
    shapes = list(SHA2_SHAPES)
    edge = sha256_cuda.SPLIT_ROWS_PER_SM * sms
    for name in ("sha256_compress", "sha512_compress"):
        shapes += [(f"{name}[edge - 32]", edge - 32, 1, 10, "10-block rows, below the rule's edge"),
                   (f"{name}[edge]", edge, 1, 10, "10-block rows, at the rule's edge")]
    for name, lanes, per, nblocks, what in shapes:
        mod, kmod, width = ((sha256, sha256_cuda, 64) if name.startswith("sha256")
                            else (sha512, sha512_cuda, 128))
        lo, hi = (0, 2**32) if width == 64 else (-2**63, 2**63)
        states = torch.from_numpy(rng.integers(lo, hi, size=(lanes, 8), dtype=np.int64)).to(dev)
        blocks = u8(lanes * per, nblocks * width)
        rows = lanes * per
        ops = rows * nblocks * (SHA256_BLOCK_OPS if width == 64 else SHA512_BLOCK_OPS)
        rule = "split" if sha256_cuda.split_rule(rows, nblocks, sms) else "rows"
        for path in (rule, "rows" if rule == "split" else "split"):
            tag = "" if path == rule else f"[{path} path forced]"
            kern = (kmod.compress if path == rule else
                    lambda s, b, r, w=width, p=path: sha256_cuda.launch(w, s, b, r, p)[0])
            cases.append((name + tag, f"{SRC}/core/sha{256 if width == 64 else 512}_pallas.py:"
                                      f"{74 if width == 64 else 102}",
                          lambda k=kern, s=states, b=blocks, r=per: k(s, b, r),
                          lambda m=mod, s=states, b=blocks, r=per, w=width: plain_absorb(m, s, b,
                                                                                      r, w),
                          states.numel() * 8 + blocks.numel() + rows * 64, ops,
                          f"{what}: ({lanes}, 8) states x {per} rows, {nblocks} block(s) -> "
                          f"({rows}, 8), {path} path{'' if tag else ' (the rule)'}"))
    return cases


def phase_kernels(torch, np, keccak, keccak_cuda, mlkem, mlkem_cuda, mldsa, mldsa_cuda,
                  chacha, chacha_cuda, frodo, frodo_cuda, sha2, int_rate) -> list:
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    # (name, replaces, kernel, plain, bytes, int32 ops, shape)
    cases = k1_k7_cases(torch, np, rng, keccak, keccak_cuda, mldsa, mldsa_cuda)
    cases += mlkem_sampler_cases(torch, np, rng, keccak, mlkem, mlkem_cuda)
    cases += k4_k5_cases(torch, np, rng, keccak, mlkem, mlkem_cuda, mldsa, mldsa_cuda)
    cases += k6_cases(torch, np, rng, keccak, mldsa, mldsa_cuda)
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
    cases += sha2_cases(torch, np, rng, sha2)
    # the one PyTorch call for a kernel's function, timed as a yardstick:
    # searchsorted gives K11's magnitude (not constant-time; never used)
    table, half = torch.tensor(fp.cdf[:-1], dtype=torch.int32, device=dev), r16 >> 1
    library = {"frodo_cdf_sample": lambda: torch.searchsorted(table, half)}

    return run_cases(torch, cases, library, int_rate)


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


def aes256_block(sbox, key: bytes, block: bytes) -> bytes:
    """One AES-256 block encryption on the host (FIPS 197): the cipher of
    the NIST KAT harness's DRBG, for phase "hqc"'s PQCgenKAT stanzas."""
    words = [list(key[4 * i:4 * i + 4]) for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        t = list(words[i - 1])
        if i % 8 == 0:
            t = [sbox[b] for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = (rcon << 1) ^ (0x11B if rcon & 0x80 else 0)
        elif i % 8 == 4:
            t = [sbox[b] for b in t]
        words.append([a ^ b for a, b in zip(words[i - 8], t)])

    def xtime(b: int) -> int:
        return ((b << 1) ^ 0x11B) if b & 0x80 else b << 1

    state = [b ^ k for b, k in zip(block, sum(words[:4], []))]
    for rnd in range(1, 15):
        state = [sbox[b] for b in state]
        state = [state[(i + 4 * (i % 4)) % 16] for i in range(16)]  # ShiftRows
        if rnd < 14:
            mixed = []
            for c in range(4):
                a = state[4 * c:4 * c + 4]
                t = a[0] ^ a[1] ^ a[2] ^ a[3]
                mixed += [a[i] ^ t ^ xtime(a[i] ^ a[(i + 1) % 4]) for i in range(4)]
            state = mixed
        state = [b ^ k for b, k in zip(state, sum(words[4 * rnd:4 * rnd + 4], []))]
    return bytes(state)


class KatDrbg:
    """The NIST PQC KAT harness's randombytes: AES-256 CTR-DRBG without a
    derivation function, seeded by a stanza's 48-byte seed."""

    def __init__(self, sbox, seed: bytes):
        self.sbox, self.key, self.v = sbox, bytes(32), bytearray(16)
        self._update(seed)

    def _block(self) -> bytes:
        for i in range(15, -1, -1):
            self.v[i] = (self.v[i] + 1) & 0xFF
            if self.v[i]:
                break
        return aes256_block(self.sbox, self.key, bytes(self.v))

    def _update(self, provided: bytes | None) -> None:
        temp = b"".join(self._block() for _ in range(3))
        if provided is not None:
            temp = bytes(a ^ b for a, b in zip(temp, provided))
        self.key, self.v = temp[:32], bytearray(temp[32:])

    def random_bytes(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += self._block()
        self._update(None)
        return out[:n]


def rsp_stanzas(text: str) -> list[dict]:
    """The ``key = value`` stanzas of a PQCgenKAT .rsp file."""
    recs, rec = [], {}
    for line in text.splitlines() + [""]:
        line = line.strip()
        if not line or line.startswith("#"):
            if rec:
                recs.append(rec)
            rec = {}
            continue
        key, _, value = line.partition("=")
        rec[key.strip()] = value.strip()
    return recs


def phase_kat_hqc(torch, hqc, sbox) -> None:
    """The three HQC vector files and the PQCgenKAT fixture's stanzas through
    keygen/encaps/decaps on the GPU, byte-exact: pk, sk and ct by their
    sha256 (the files) or bytes (the stanzas, whose seeds the KAT harness's
    DRBG rebuilds), ss by value; a tampered ciphertext gives the rejection
    secret K(sigma || u || v), computed on the host."""
    for tag in HQC_VECTORS:
        data = json.loads((ROOT / "tests" / "vectors" / f"hqc_{tag}.json").read_text())
        p = hqc.PARAMS[data["algorithm"]]
        recs = data["tests"]

        def col(key):
            return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8,
                                device="cuda")

        kg, enc, dec = hqc.get(p.name)
        pk, sk = kg(col("sk_seed"), col("sigma"), col("pk_seed"))
        ct, ss = enc(pk, col("m"), col("salt"))
        bad = ct.clone()
        bad[:, 0] ^= 1
        ss2, rej = dec(sk.repeat(2, 1), torch.cat([ct, bad])).split(len(recs))
        for i, rec in enumerate(recs):
            for name, t in (("pk", pk), ("sk", sk), ("ct", ct)):
                if hashlib.sha256(bytes(t[i].cpu().numpy())).hexdigest() != rec[name + "_sha256"]:
                    raise PhaseFailed(f"KAT {p.name} count {rec['count']}: {name} differs")
            for name, t in (("ss", ss), ("ss after decaps", ss2)):
                if bytes(t[i].cpu().numpy()).hex() != rec["ss"]:
                    raise PhaseFailed(f"KAT {p.name} count {rec['count']}: {name} differs")
            want = hashlib.shake_256(bytes.fromhex(rec["sigma"])
                                     + bytes(bad[i, :-16].cpu().numpy()) + b"").digest(64)
            if bytes(rej[i].cpu().numpy()) != want:
                raise PhaseFailed(f"KAT {p.name} count {rec['count']}: a tampered ciphertext "
                                  "did not give the rejection secret")
        print(f"[kat] {p.name}: {len(recs)} vectors byte-exact on the GPU "
              "(keygen, encaps, decaps, implicit rejection)")
    p = hqc.PARAMS["HQC-128"]
    recs = rsp_stanzas((ROOT / "tests" / "vectors" / HQC_RSP).read_text())
    draws = []
    for rec in recs:
        drbg = KatDrbg(sbox, bytes.fromhex(rec["seed"]))
        draws.append([drbg.random_bytes(n) for n in (40, p.k, 40, p.k, 16)])

    def drawn(j):
        return torch.tensor([list(d[j]) for d in draws], dtype=torch.uint8, device="cuda")

    kg, enc, dec = hqc.get(p.name)
    pk, sk = kg(drawn(0), drawn(1), drawn(2))
    ct, ss = enc(pk, drawn(3), drawn(4))
    ss2 = dec(sk, ct)
    for i, rec in enumerate(recs):
        for name, t in (("pk", pk), ("sk", sk), ("ct", ct), ("ss", ss), ("ss", ss2)):
            if bytes(t[i].cpu().numpy()).hex() != rec[name].lower():
                raise PhaseFailed(f"{HQC_RSP} count {rec['count']}: {name} differs")
    print(f"[kat] {HQC_RSP}: {len(recs)} stanzas byte-exact on the GPU (seeds by the KAT "
          "harness's AES-256 CTR-DRBG; keygen, encaps, decaps)")


def hqc_batch_inputs(torch, np, hqc, name: str):
    """HQC_BATCH seeded rows of each input (sk_seed, sigma, pk_seed, m,
    salt) of one set, on the GPU."""
    p = hqc.PARAMS[name]
    rng = np.random.default_rng(p.n)
    return p, [torch.from_numpy(rng.integers(0, 256, size=(HQC_BATCH, n), dtype=np.uint8))
               .to("cuda") for n in (40, p.k, 40, p.k, 16)]


def kernel_launches(torch, fn) -> tuple[int, float]:
    """(kernels the card ran for one call of fn, PyTorch's and the port's;
    K1's device ms among them), from a torch.profiler trace of its own."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_us = sum(e["dur"] for e in kernels
                if "::sponge_rows_kernel<" in e["name"] or "::sponge_split_kernel<" in e["name"])
    return len(kernels), k1_us / 1e3


def phase_hqc_batch(torch, np, hqc, keccak_cuda, inputs) -> tuple[dict, tuple]:
    """keygen, encaps and decaps at HQC_BATCH of one set: the first rows
    held to the CPU path, the odd rows' tampered ciphertexts to their
    rejection secret and the even rows' to the secret, the RM and RS decoders
    to the CPU path on tie-heavy words; each op timed with
    CUDA events and the host clock, with its kernel launches and K1's device
    ms (profiler), K1's launches and its peak device memory a row."""
    p, (sk_seed, sigma, pk_seed, m, salt) = inputs
    kg, enc, dec = hqc.get(p.name)
    pk, sk = kg(sk_seed, sigma, pk_seed)
    ct, ss = enc(pk, m, salt)
    bad = ct.clone()
    bad[1::2, 3] ^= 0x20
    got = dec(sk, bad)
    torch.cuda.synchronize()
    if (pk.shape, sk.shape, ct.shape, ss.shape) != (
            (HQC_BATCH, p.pk_len), (HQC_BATCH, p.sk_len), (HQC_BATCH, p.ct_len), (HQC_BATCH, 64)):
        raise PhaseFailed(f"{p.name}: shapes {pk.shape} {sk.shape} {ct.shape} {ss.shape}")
    rows = 2
    cpu = [x[:rows].cpu() for x in (sk_seed, sigma, pk_seed, m, salt)]
    cpk, csk = kg(*cpu[:3])
    cct, css = enc(cpk, *cpu[3:])
    cgot = dec(csk, bad[:rows].cpu())
    for name, dev_t, cpu_t in (("pk", pk, cpk), ("sk", sk, csk), ("ct", ct, cct), ("ss", ss, css),
                               ("decaps", got, cgot)):
        if not torch.equal(dev_t[:rows].cpu(), cpu_t):
            raise PhaseFailed(f"{p.name}: GPU {name} differs from the CPU path")
    if not torch.equal(got[0::2], ss[0::2]):
        raise PhaseFailed(f"{p.name}: GPU decaps of honest ciphertexts differs from encaps")
    sig_h, bad_h = sk[1::2, 40:40 + p.k].cpu().numpy(), bad[1::2, :-16].cpu().numpy()
    want = [hashlib.shake_256(bytes(a) + bytes(b) + b"").digest(64)
            for a, b in zip(sig_h, bad_h)]
    if [bytes(r) for r in got[1::2].cpu().numpy()] != want:
        raise PhaseFailed(f"{p.name}: a tampered ciphertext did not give K(sigma || u || v)")
    # a rejected row's m' never reaches the secret, so the decoders are held
    # to the CPU path directly, on uniform words: most RM(1,7) blocks then
    # have several largest |F| (the first must win) and the RS words carry
    # more than delta errors
    words = torch.from_numpy(np.random.default_rng(p.n1).integers(
        0, 2, size=(HQC_DECODE_ROWS, p.n1 * p.n2), dtype=np.uint8))
    rm = hqc._rm_decode(p, words.to("cuda"))
    rs = hqc._rs_decode(p, rm)
    if not (torch.equal(rm.cpu(), hqc._rm_decode(p, words))
            and torch.equal(rs.cpu(), hqc._rs_decode(p, rm.cpu()))):
        raise PhaseFailed(f"{p.name}: the GPU RM/RS decoders differ from the CPU path")
    f = (p.dup - 2 * words.reshape(-1, p.n1, p.dup, 128).sum(-2)).to(torch.float32)
    mag = (f @ hqc._device_consts("cpu")["hadamard"]).abs()
    tied = float(((mag == mag.amax(-1, keepdim=True)).sum(-1) > 1).float().mean())
    if tied == 0:
        raise PhaseFailed(f"{p.name}: the decoder check held no tied RM block")
    print(f"[hqc] {p.name}: RM and RS decoders equal to the CPU path on {HQC_DECODE_ROWS} uniform "
          f"words, {tied:.1%} of their RM blocks tied")
    out = {"name": p.name, "batch": HQC_BATCH, "decode_tied_share": tied}
    for op, fn in (("keygen", lambda: kg(sk_seed, sigma, pk_seed)),
                   ("encaps", lambda: enc(pk, m, salt)), ("decaps", lambda: dec(sk, ct))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k1 = keccak_cuda.sponge.launches
        fn()
        torch.cuda.synchronize()
        k1 = keccak_cuda.sponge.launches - k1
        peak = torch.cuda.max_memory_allocated() - base
        reps = 5
        ms = cuda_ms(torch, fn, reps)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
        launched, k1_ms = kernel_launches(torch, fn)
        out[op] = {"ms_per_batch_cuda_events": ms, "ms_per_batch_wall": wall_ms,
                   "ops_per_s": HQC_BATCH / (ms / 1e3), "kernel_launches": launched,
                   "k1_launches": k1, "k1_device_ms": k1_ms, "peak_bytes_a_row": peak / HQC_BATCH}
        print(f"[hqc] {p.name} {op} B={HQC_BATCH}: {ms:.3f} ms/batch (CUDA events), "
              f"{out[op]['ops_per_s']:.0f} ops/s; host wall {wall_ms:.3f} ms/batch; "
              f"{launched} kernel launches ({k1} of K1, {k1_ms:.4f} ms on the device); peak "
              f"device memory {peak / HQC_BATCH / 1024:.1f} KiB a row")
    return out, (pk, m, salt)


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


def phase_health_hqc(provider, health) -> list:
    """The health gate on the GPU provider of HQC-128: its pinned vector
    (record 0 of tests/vectors/hqc_128.json) through the device."""
    with provider.BatchedKEM(provider.get_kem(HQC_SERVE)) as bk:
        try:
            verdicts = health.gate_facades(bk, cpu_kem=provider.get_kem(HQC_SERVE, backend="cpu"))
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
        sizes = {k: q.stats.batch_sizes[-16:] for k, q in (
            ("initiator.keygen_sign", ini._kg), ("gateway.encaps_verify_sign", gw._enc),
            ("initiator.decaps_verify_sign", ini._dec), ("gateway.verify", gw_sig._verify))}
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
            "flush_sizes": sizes,
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


class NoTracer:
    """Stands in for the process tracer when the serve rate is read without
    spans: records nothing."""

    @contextlib.contextmanager
    def span(self, name, parent=None, **attrs):
        yield None


def attach_cost(facades, ledger) -> list:
    """``ledger`` as the cost ledger of each facade and of its queues; ->
    the queues."""
    from quantum_resistant_p2p_tpu_torch.provider import facade_queues

    queues = []
    for f in facades:
        f.cost = ledger
        for q in facade_queues(f):
            q.cost = ledger
            queues.append(q)
    return queues


async def fused_sessions(kem, dsa, bf, bs, n: int) -> float:
    """``n`` fused handshakes, both sides' steps through one BatchedFused,
    the gateway's verify of each confirm through BatchedSignature; every
    session must agree.  -> wall seconds."""
    pks, sks = dsa.generate_keypair_batch(n)
    gw_pk, gw_sk = dsa.generate_keypair()

    async def session(i: int) -> bool:
        peer, sk, spk = f"peer-{i:04d}", bytes(sks[i]), bytes(pks[i])
        init = {"message_id": str(uuid.UUID(int=4 << 64 | i)), "kem": kem.name, "aead": AEAD,
                "public_key": "0" * (2 * kem.public_key_len), "sender": peer,
                "recipient": GATEWAY, "timestamp": 1.8e9 + i / 1e3}
        kem_pk, kem_sk, s1 = await bf.keygen_sign(sk, canonical(init))
        init["public_key"] = kem_pk.hex()
        resp = {"message_id": str(uuid.UUID(int=5 << 64 | i)), "sender": GATEWAY,
                "ciphertext": "0" * (2 * kem.ciphertext_len), "recipient": peer,
                "timestamp": 1.8e9 + 1 + i / 1e3}
        ok, ct, ss_gw, s2 = await bf.encaps_verify_sign(kem_pk, spk, canonical(init), s1, gw_sk,
                                                        canonical(resp))
        resp["ciphertext"] = ct.hex()
        confirm = canonical({"message_id": str(uuid.UUID(int=6 << 64 | i)), "sender": peer,
                             "recipient": GATEWAY, "timestamp": 1.8e9 + 2 + i / 1e3})
        ok2, ss_peer, s3 = await bf.decaps_verify_sign(kem_sk, ct, gw_pk, canonical(resp), s2,
                                                       sk, confirm)
        ok3 = await bs.verify(spk, confirm, s3)
        return ok and ok2 and ok3 and hmac.compare_digest(ss_gw, ss_peer)

    t0 = time.perf_counter()
    done = await asyncio.gather(*(session(i) for i in range(n)))
    wall = time.perf_counter() - t0
    if not all(done):
        raise PhaseFailed(f"obs: {done.count(False)} of {n} traced fused handshakes failed")
    return wall


async def faulted_kem(provider, faults, kem) -> dict:
    """FAULT_CLIENTS clients through one BatchedKEM under a seeded plan: the
    2nd encaps flush raises at device.dispatch, one slot of the 1st decaps
    flush is poisoned.  Exactly those futures raise FaultInjected; every
    other secret agrees; the plan's log holds exactly the two faults."""
    rules = [faults.FaultRule("device.dispatch", "raise", match={"op": f"{kem.name}.enc"}, nth=2),
             faults.FaultRule("device.dispatch", "poison", match={"op": f"{kem.name}.dec"})]
    plan = faults.FaultPlan(FAULT_SEED, rules)
    with provider.BatchedKEM(kem, max_wait_ms=20.0) as fk, plan.activate():
        pairs = await asyncio.gather(*(fk.generate_keypair() for _ in range(FAULT_CLIENTS)))
        good = await asyncio.gather(*(fk.encapsulate(pk) for pk, _ in pairs))
        failed = await asyncio.gather(*(fk.encapsulate(pk) for pk, _ in pairs),
                                      return_exceptions=True)
        keys = await asyncio.gather(*(fk.decapsulate(sk, ct) for (_, sk), (ct, _)
                                      in zip(pairs, good)), return_exceptions=True)
        flushes = {op: st["flushes"] for op, st in fk.stats().items()}
    if flushes != {"keygen": 1, "encaps": 2, "decaps": 1}:
        raise PhaseFailed(f"faults: the rounds did not each ride one flush: {flushes}")
    applied = [(e["action"], e["op"]) for e in plan.injected]
    if applied != [("raise", f"{kem.name}.enc"), ("poison", f"{kem.name}.dec")]:
        raise PhaseFailed(f"faults: the plan's log is {plan.injected}")
    if not all(isinstance(r, faults.FaultInjected) for r in failed):
        raise PhaseFailed("faults: a future of the raising encaps flush did not raise")
    slot = plan.injected[1]["slot"]
    raised = [i for i, r in enumerate(keys) if isinstance(r, BaseException)]
    if raised != [slot] or not isinstance(keys[slot], faults.FaultInjected):
        raise PhaseFailed(f"faults: decaps futures {raised} raised, the poisoned slot is {slot}")
    if any(keys[i] != good[i][1] for i in range(FAULT_CLIENTS) if i != slot):
        raise PhaseFailed("faults: a secret of an unfaulted future differs")
    return {"clients": FAULT_CLIENTS, "flushes": flushes, "injected": plan.injected,
            "raised": {"encaps": len(failed), "decaps": raised}}


async def lane_shed(np, provider, aead) -> dict:
    """BULK_SEALS bulk seals and LANE_SEALS handshake-lane seals at once
    through a BatchedAEAD whose bulk lane holds LANE_CAP pending: each bulk
    seal past the capacity raises LaneShed and is counted; every
    handshake-lane seal is served; a gateway opens every sealed frame."""
    rng = np.random.default_rng(13)
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    msgs = [bytes(r) for r in rng.integers(0, 256, size=(BULK_SEALS + LANE_SEALS, 256),
                                           dtype=np.uint8)]
    with provider.BatchedAEAD(aead, max_wait_ms=20.0,
                              lane_capacity={provider.LANE_BULK: LANE_CAP}) as cli,             provider.BatchedAEAD(aead, max_wait_ms=2.0) as gw:
        frames = await asyncio.gather(
            *(cli.encrypt(key, m) for m in msgs[:BULK_SEALS]),
            *(cli.encrypt(key, m, lane=provider.LANE_HANDSHAKE) for m in msgs[BULK_SEALS:]),
            return_exceptions=True)
        served = [i for i, f in enumerate(frames) if isinstance(f, bytes)]
        opened = await asyncio.gather(*(gw.decrypt(key, frames[i]) for i in served))
        stats = cli.stats()["seal"]
    shed = [i for i, f in enumerate(frames) if isinstance(f, provider.LaneShed)]
    if len(shed) + len(served) != len(frames):
        raise PhaseFailed("lanes: a seal failed with another error than LaneShed")
    if any(i >= BULK_SEALS for i in shed):
        raise PhaseFailed("lanes: a handshake-lane seal was shed")
    bulk = BULK_SEALS - len(shed)
    if bulk < LANE_CAP or (stats["flushes"] == 1 and bulk != LANE_CAP):
        raise PhaseFailed(f"lanes: {bulk} bulk seals served over {stats['flushes']} flushes "
                          f"with a capacity of {LANE_CAP}")
    if stats["lane_sheds"] != {"bulk": len(shed)}:
        raise PhaseFailed(f"lanes: lane_sheds {stats['lane_sheds']} for {len(shed)} shed seals")
    if opened != [msgs[i] for i in served]:
        raise PhaseFailed("lanes: an opened frame differs from its plaintext")
    return {"bulk_submitted": BULK_SEALS, "bulk_served": bulk, "bulk_shed": len(shed),
            "handshake_served": LANE_SEALS, "seal_flushes": stats["flushes"],
            "lanes": stats["lanes"], "lane_sheds": stats["lane_sheds"]}


def phase_obs_faults(np, provider, faults, obs_cost, obs_trace, kem, dsa, fused, aead, pk_off,
                     ct_off, entry) -> dict:
    """The observability and fault layer on the card: warm-up under a cost
    ledger, traced serving, a seeded fault plan, lane shedding, the
    profiler, and the serve rate with spans and without."""
    t_phase = time.perf_counter()
    out = {"warmup": {}}
    scalar = provider.get_symmetric(AEAD)
    with provider.BatchedKEM(kem) as bk, provider.BatchedSignature(dsa) as bs,             provider.BatchedFused(fused, pk_off, ct_off) as bf,             provider.BatchedAEAD(aead, scalar) as ba:
        warm_ledger = obs_cost.CostLedger()
        attach_cost((bk, bs, bf, ba), warm_ledger)
        for f in (bk, bs, bf, ba):
            t0 = time.perf_counter()
            f.warmup()
            out["warmup"][f.name] = time.perf_counter() - t0
        compiles = warm_ledger.snapshot()["recent_compiles"]
        for f in (bk, bs, bf, ba):
            events = [e for e in compiles if e["queue"] == f.name]
            print(f"[obs] warmup {f.name}: {out['warmup'][f.name]:.4f} s; compile events "
                  f"{[(e['bucket'], e['where'], e['seconds']) for e in events]}")
            if len(events) != 1:
                raise PhaseFailed(f"obs: {f.name} warm-up made {len(events)} compile events")
        out["warm_compiles"] = compiles

        # traced serving: the process tracer from empty, a fresh ledger
        tracer = obs_trace.TRACER
        tracer.reset()
        ledger = obs_cost.CostLedger()
        queues = attach_cost((bk, bs, bf), ledger)
        kem.opcache.attach_cost(ledger, "kem")
        dsa.opcache.attach_cost(ledger, "sig")

        async def traced():
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            t0 = time.perf_counter()
            agreed = await asyncio.gather(*(client() for _ in range(SERVE_CLIENTS)))
            wall = time.perf_counter() - t0
            if not all(agreed):
                raise PhaseFailed(f"obs: {agreed.count(False)} traced secrets differ")
            return wall, await fused_sessions(kem, dsa, bf, bs, OBS_HANDSHAKES)

        kem_wall, fused_wall = asyncio.run(traced())
        spans = tracer.snapshot()
        flushes = {s["span_id"]: s for s in spans if s["name"] == "queue.flush"}
        dispatches = [s for s in spans if s["name"] == "device.dispatch"]
        n_flushes = sum(q.stats.flushes for q in queues)
        if not (len(flushes) == len(dispatches) == n_flushes):
            raise PhaseFailed(f"obs: {len(flushes)} queue.flush and {len(dispatches)} "
                              f"device.dispatch spans for {n_flushes} flushes")
        orphans = [d for d in dispatches if d["parent_id"] not in flushes
                   or flushes[d["parent_id"]]["attrs"]["op"] != d["attrs"]["op"]]
        if orphans or len({d["parent_id"] for d in dispatches}) != len(dispatches):
            raise PhaseFailed(f"obs: device.dispatch spans without their own flush: {orphans[:2]}")
        chrome = json.loads(json.dumps(obs_trace.to_chrome_trace(spans)))
        hist_s = sum(q.stats.device_hist.total for q in queues)
        if abs(ledger.device_seconds_total() - hist_s) > 1e-6:
            raise PhaseFailed(f"obs: ledger device seconds {ledger.device_seconds_total()} "
                              f"against the histograms' {hist_s}")
        out["traced"] = {"kem_clients": SERVE_CLIENTS, "kem_wall_s": kem_wall,
                         "fused_handshakes": OBS_HANDSHAKES, "fused_wall_s": fused_wall,
                         "queue_flush_spans": len(flushes),
                         "device_dispatch_spans": len(dispatches), "flushes": n_flushes,
                         "chrome_events": len(chrome["traceEvents"]),
                         "device_seconds_total": ledger.device_seconds_total(),
                         "device_hist_seconds": hist_s, "cost": ledger.totals(),
                         "flushes_by_queue": {q.label: q.stats.flushes for q in queues}}
        print(f"[obs] traced: {SERVE_CLIENTS} ML-KEM-768 clients in {kem_wall:.3f} s, "
              f"{OBS_HANDSHAKES} fused handshakes in {fused_wall:.3f} s; {len(flushes)} "
              f"queue.flush and {len(dispatches)} device.dispatch spans for {n_flushes} "
              f"flushes {out['traced']['flushes_by_queue']}; ledger device seconds "
              f"{ledger.device_seconds_total():.6f} (histograms {hist_s:.6f}); "
              f"cost {ledger.totals()}")

    out["faults"] = asyncio.run(faulted_kem(provider, faults, kem))
    print(f"[obs] faults: {out['faults']['injected']}; encaps futures raised "
          f"{out['faults']['raised']['encaps']}, decaps {out['faults']['raised']['decaps']}")
    out["lanes"] = asyncio.run(lane_shed(np, provider, aead))
    print(f"[obs] lanes: {out['lanes']}")

    rates = out["serve_rate"] = serve_rates(provider, obs_trace, kem)
    print(f"[obs] ML-KEM-768 serve, {SERVE_CLIENTS} clients, handshakes/s in the order "
          f"{' '.join(SERVE_RATE_ORDER)}: with the process tracer "
          f"{[round(r, 1) for r in rates['tracer']]} (median "
          f"{statistics.median(rates['tracer']):.1f}), with spans off "
          f"{[round(r, 1) for r in rates['no_tracer']]} (median "
          f"{statistics.median(rates['no_tracer']):.1f})")
    out["device_trace"] = traced_flagship(obs_trace, entry)
    print(f"[obs] device_trace over one flagship batch: {out['device_trace']}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[obs] phase took {out['phase_s']:.1f} s")
    return out


def traced_flagship(obs_trace, entry) -> dict:
    """obs.trace.device_trace around one warm flagship batch: the trace
    file must hold the card's kernel events."""
    fn, args = entry()
    fn(*args)
    with tempfile.TemporaryDirectory() as tmp:
        with obs_trace.device_trace(tmp) as path:
            fn(*args)
        events = json.loads(path.read_text())["traceEvents"]
        trace_bytes = path.stat().st_size
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise PhaseFailed("obs: device_trace wrote no CUDA kernel events")
    return {"events": len(events), "kernel_events": len(kernels), "bytes": trace_bytes,
            "kernel_us": sum(e.get("dur", 0) for e in kernels)}


def serve_rates(provider, obs_trace, kem) -> dict:
    """The serve phase's handshakes/s with the process tracer and with
    NoTracer in its place, in the turns of SERVE_RATE_ORDER."""
    tracer = obs_trace.TRACER
    rates = {"tracer": [], "no_tracer": []}
    for mode in SERVE_RATE_ORDER:
        if mode == "no_tracer":
            obs_trace.TRACER = NoTracer()
        try:
            rates[mode].append(asyncio.run(serve(provider.BatchedKEM, kem))["handshakes_per_s"])
        finally:
            obs_trace.TRACER = tracer
    return rates


class Session:
    """What one side of the transport phase keeps: its node, its message
    handlers' inboxes, and a waiter per message type."""

    def __init__(self, node):
        self.node = node
        self.inbox: dict[str, list] = {}
        self._want: dict[str, tuple[int, asyncio.Event]] = {}
        #: the key of the last resumed session (the responder side)
        self.resumed_key = b""

    def listen(self, *msg_types: str) -> None:
        for t in msg_types:
            async def handler(peer_id, msg, t=t):
                box = self.inbox.setdefault(t, [])
                box.append(msg)
                n, ev = self._want.get(t, (0, None))
                if ev is not None and len(box) >= n:
                    ev.set()

            self.node.register_message_handler(t, handler)

    async def wait(self, msg_type: str, n: int) -> list:
        """The first ``n`` messages of ``msg_type``, within TRANSPORT_WAIT_S."""
        ev = asyncio.Event()
        self._want[msg_type] = (n, ev)
        if len(self.inbox.get(msg_type, [])) >= n:
            ev.set()
        try:
            await asyncio.wait_for(ev.wait(), TRANSPORT_WAIT_S)
        except asyncio.TimeoutError:
            raise PhaseFailed(
                f"transport: {self.node.node_id} got {len(self.inbox.get(msg_type, []))} of "
                f"{n} {msg_type} messages in {TRANSPORT_WAIT_S} s; peers "
                f"{self.node.get_peers()}, wire errors {self.node.wire_errors}, inboxes "
                f"{ {k: len(v) for k, v in self.inbox.items()} }") from None
        return self.inbox[msg_type][:n]

    def take(self, msg_type: str) -> list:
        return self.inbox.pop(msg_type, [])


async def until(cond, what: str) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > TRANSPORT_WAIT_S:
            raise PhaseFailed(f"transport: timed out waiting for {what}")
        await asyncio.sleep(0.002)


def validate_resume(res, faults, ring, replay, msg, node_id: str, peer: str, kem: str,
                    sig: str) -> tuple[str, dict]:
    """The responder's check of a presented ticket, as the reference's
    engine runs it: the ticket fault point, open, single use, expiry,
    holder, suite, binder.  -> ("ok", reply) or (reason, {})."""
    blob = bytes(msg["ticket"])
    if "corrupt" in faults.ticket_validation(node_id, peer):
        doctored = bytearray(blob)
        doctored[len(doctored) // 2] ^= 0xFF
        blob = bytes(doctored)
    try:
        fields, rsec = ring.open_ticket(blob)
        if replay.seen(fields["nonce"], fields["expires_at"], time.time()):
            raise res.TicketError("replayed_ticket")
        if fields["expires_at"] <= time.time():
            raise res.TicketError("expired_ticket")
        if fields["holder"] != peer:
            raise res.TicketError("holder_mismatch")
        if (fields["kem"], fields["aead"], fields["sig"]) != (kem, AEAD, sig):
            raise res.TicketError("suite_mismatch")
        data = canonical({"client_nonce": msg["client_nonce"], "sender": peer})
        if not hmac.compare_digest(res.resume_binder(rsec, data, blob), msg["binder"]):
            raise res.TicketError("bad_binder")
    except res.TicketError as e:
        return e.reason, {}
    server_nonce = uuid.uuid4().hex
    key = res.derive_resumed_key(rsec, msg["client_nonce"], server_nonce, AEAD)
    confirm = res.resume_confirm_tag(key, msg["message_id"], msg["client_nonce"], server_nonce)
    return "ok", {"server_nonce": server_nonce, "confirm": confirm, "key": key}


async def transport(np, faults, obs_trace, res, store, p2p, facades, kem, dsa) -> dict:
    """Two P2PNodes on loopback over the scheduled facades: bin1, the key
    agreements (the injected device fault among them), the sealed
    messages (one dropped by the plan), a chunked message, and a resumed
    session with a replayed and a corrupted ticket."""
    from quantum_resistant_p2p_tpu_torch.obs import flight as obs_flight

    bk, _, _, ba = facades
    rng = np.random.default_rng(TRANSPORT_SEED)
    plan = faults.FaultPlan(TRANSPORT_SEED, [
        faults.FaultRule("device.dispatch", "raise", match={"op": f"{kem.name}.enc"}, nth=2),
        faults.FaultRule("net.send", "drop", match={"msg_type": "secure_message"},
                         nth=DROP_NTH),
        faults.FaultRule("ticket", "corrupt", nth=3)])
    a = Session(p2p.P2PNode("node-a", "127.0.0.1", 0, jitter_rng=random.Random(TRANSPORT_SEED)))
    b = Session(p2p.P2PNode("node-b", "127.0.0.1", 0))
    a.listen("kem_pk", "ticket", "resume_ok", "resume_reject")
    b.listen("kem_ct", "secure_message", "file", "resume_message")
    out = {}
    shard = bk.scheduler.shards[0]
    await a.node.start()
    await b.node.start()
    try:
        if await a.node.connect_to_peer("127.0.0.1", b.node.port, timeout=5.0) != "node-b":
            raise PhaseFailed("transport: node-a could not reach node-b")
        await until(lambda: b.node.is_connected("node-a"), "node-b to register node-a")
        wires = (a.node.peer_wire_format("node-b"), b.node.peer_wire_format("node-a"))
        if wires != ("bin1", "bin1"):
            raise PhaseFailed(f"transport: negotiated {wires}, not bin1 on both sides")
        with plan.activate():
            # key agreements in two waves: B's keys travel to A, A
            # encapsulates a wave in one flush and sends the ciphertexts
            # back as raw fields, B decapsulates them on the device
            seq0 = max((e["seq"] for e in obs_flight.RECORDER.snapshot()), default=0)
            pairs = await asyncio.gather(*(bk.generate_keypair() for _ in range(AGREEMENTS)))
            ss_a, ss_b, waves = [None] * AGREEMENTS, [None] * AGREEMENTS, []
            half = AGREEMENTS // 2
            for w, lo in enumerate((0, half)):
                for i in range(lo, lo + half):
                    await b.node.send_message("node-a", "kem_pk", i=i, pk=pairs[i][0])
                got = await a.wait("kem_pk", half)
                a.take("kem_pk")
                enc = await asyncio.gather(*(bk.encapsulate(bytes(m["pk"])) for m in got))
                for m, (ct, ss) in zip(got, enc):
                    ss_a[m["i"]] = ss
                    await a.node.send_message("node-b", "kem_ct", i=m["i"], ct=ct)
                cts = await b.wait("kem_ct", half)
                b.take("kem_ct")
                waves.append(shard.breaker.state)
                if w == 1:
                    # the raised flush was served by the fallback and opened
                    # the breaker: wait out the cool-off, so the next flush
                    # (these decaps) is the canary on the device
                    if shard.breaker.state != "open":
                        raise PhaseFailed(f"transport: the breaker is {shard.breaker.state} "
                                          "after the injected fault, not open")
                    dispatches, mark = shard.dispatches, obs_trace.TRACER.now()
                    await asyncio.sleep(TRANSPORT_COOLOFF_S + 0.1)
                keys = await asyncio.gather(*(bk.decapsulate(pairs[m["i"]][1], bytes(m["ct"]))
                                              for m in cts))
                for m, ss in zip(cts, keys):
                    ss_b[m["i"]] = ss
            ring_events = [(e["kind"], e.get("state")) for e in obs_flight.RECORDER.snapshot()
                           if e["kind"].startswith("breaker") and e["seq"] > seq0]
            healed = (shard.breaker.state, shard.dispatches - dispatches)
            probes = [s["attrs"]["op"] for s in obs_trace.TRACER.snapshot()
                      if s["name"] == "device.dispatch" and s["attrs"].get("route") == "probe"
                      and s["t0"] >= mark]
            if ss_a != ss_b or None in ss_a:
                bad = [i for i in range(AGREEMENTS) if ss_a[i] != ss_b[i]]
                raise PhaseFailed(f"transport: {len(bad)} key agreements differ, first {bad[:4]}")
            enc_q = bk._enc
            faulted = [e for e in plan.injected if e["scope"] == "device.dispatch"]
            if (len(faulted) != 1 or enc_q.stats.breaker_trips != 1
                    or enc_q.stats.fallback_ops != faulted[0]["n_items"]
                    or enc_q.stats.fallback_flushes != 1):
                raise PhaseFailed(f"transport: injected {faulted}, enc queue "
                                  f"{enc_q.stats.as_dict()}")
            if healed[0] != "closed" or healed[1] < 1 or probes != [f"{kem.name}.dec"]:
                raise PhaseFailed(f"transport: after the cool-off the breaker is {healed[0]} "
                                  f"with {healed[1]} more shard dispatches, probes {probes}")
            if ring_events != [("breaker_open", "open"), ("breaker_transition", "half_open"),
                               ("breaker_transition", "closed")]:
                raise PhaseFailed(f"transport: the flight ring's breaker events {ring_events}")
            out["agreements"] = {"n": AGREEMENTS, "faulted_flush": faulted[0]["n_items"],
                                 "breaker_events": ring_events, "canary": probes,
                                 "canary_dispatches": healed[1], "breaker_after_waves": waves}

            # sealed messages: A seals them in one flush, sends each as a
            # raw field; the plan drops one on the way; B opens the rest
            # from the frames' memoryviews, in one flush, into its store
            key_a = derive_message_key(ss_a[1], "node-a", "node-b", AEAD)
            key_b = derive_message_key(ss_b[1], "node-b", "node-a", AEAD)
            msgs = [bytes(r) for r in rng.integers(0, 256, size=(MESSAGES, MESSAGE_BYTES),
                                                   dtype=np.uint8)]
            ad = canonical({"sender": "node-a", "recipient": "node-b"})
            corked = a.node._peers["node-b"].writer
            flushes0 = corked.flushes
            t0 = time.perf_counter()
            frames = await asyncio.gather(*(ba.encrypt(key_a, m, ad) for m in msgs))
            for i, f in enumerate(frames):
                if not await a.node.send_message("node-b", "secure_message", i=i, frame=f):
                    raise PhaseFailed(f"transport: message {i} was not sent")
            got = await b.wait("secure_message", MESSAGES - 1)
            sends = corked.flushes - flushes0
            views = [m["frame"] for m in got]
            if not all(isinstance(v, memoryview) for v in views):
                raise PhaseFailed("transport: a frame did not arrive as a memoryview")
            plain = await asyncio.gather(*(ba.decrypt(key_b, v, ad) for v in views))
            wall = time.perf_counter() - t0
            dropped = [e for e in plan.injected if e["scope"] == "net.send"]
            sent = {m["i"] for m in got}
            missing = sorted(set(range(MESSAGES)) - sent)
            if len(dropped) != 1 or missing != [DROP_NTH - 1]:
                raise PhaseFailed(f"transport: dropped {dropped}, missing {missing}")
            kept = store.MessageStore()
            for m, pt in zip(got, plain):
                kept.add_message("node-a", store.Message(
                    content=pt, sender_id="node-a", recipient_id="node-b",
                    message_id=f"m{m['i']}", key_exchange_algo=kem.name, symmetric_algo=AEAD),
                    unread=True)
            held = kept.get_messages("node-a")
            if [h.content for h in held] != [msgs[i] for i in range(MESSAGES) if i in sent]:
                raise PhaseFailed("transport: the store's messages differ from those sent")
            if kept.get_unread_count("node-a") != MESSAGES - 1:
                raise PhaseFailed("transport: the store's unread count is wrong")
            big = bytes(rng.integers(0, 256, BIG_MESSAGE, dtype=np.uint8))
            await a.node.send_message("node-b", "file", blob=big)
            (f,) = await b.wait("file", 1)
            if bytes(f["blob"]) != big or len(big) <= a.node.chunk_size:
                raise PhaseFailed("transport: the chunked message did not reassemble")
            out["messages"] = {"sent": MESSAGES, "bytes": MESSAGE_BYTES, "dropped": dropped[0],
                               "socket_sends": sends,
                               "opened": len(plain), "wall_s": wall,
                               "messages_per_s": (MESSAGES - 1) / wall,
                               "chunked_bytes": len(big)}

            # resumption: B mints a ticket from agreement 0's secret; A
            # reconnects and presents it; then a replay, and a fresh ticket
            # that the ticket fault point corrupts
            ring, replay = res.STEKRing(), res.ReplayCache()
            rsec_b = res.derive_resumption_secret(ss_b[0], "node-b", "node-a")
            rsec_a = res.derive_resumption_secret(ss_a[0], "node-a", "node-b")

            def mint():
                return ring.seal_ticket(res.mint_fields("node-a", "node-b", rsec_b, kem.name,
                                                       AEAD, dsa.name, time.time() + 600))

            async def on_resume(peer_id, msg):
                verdict, reply = validate_resume(res, faults, ring, replay, msg, "node-b",
                                                 peer_id, kem.name, dsa.name)
                if verdict != "ok":
                    await b.node.send_message(peer_id, "resume_reject", reason=verdict)
                    return
                b.resumed_key = reply.pop("key")
                await b.node.send_message(peer_id, "resume_ok", **reply)

            b.node.register_message_handler("resume", on_resume)
            await b.node.send_message("node-a", "ticket", ticket=mint())
            (t,) = await a.wait("ticket", 1)
            ticket = bytes(t["ticket"])
            await a.node.disconnect_from_peer("node-b", intentional=False)
            await until(lambda: not b.node.is_connected("node-a"), "node-b to drop node-a")
            if not await a.node.reconnect("node-b", timeout=5.0):
                raise PhaseFailed("transport: reconnect failed")
            await until(lambda: b.node.is_connected("node-a"), "node-b to register node-a")
            if a.node.peer_wire_format("node-b") != "bin1":
                raise PhaseFailed("transport: the new connection is not bin1")

            async def present(blob: bytes, k: int):
                cn = uuid.uuid4().hex
                data = canonical({"client_nonce": cn, "sender": "node-a"})
                await a.node.send_message("node-b", "resume", ticket=blob, client_nonce=cn,
                                          message_id=f"resume-{k}",
                                          binder=res.resume_binder(rsec_a, data, blob))
                return cn

            cn = await present(ticket, 0)
            (ok,) = await a.wait("resume_ok", 1)
            key = res.derive_resumed_key(rsec_a, cn, ok["server_nonce"], AEAD)
            if not hmac.compare_digest(res.resume_confirm_tag(key, "resume-0", cn,
                                                              ok["server_nonce"]),
                                       ok["confirm"]):
                raise PhaseFailed("transport: the resume confirmation does not verify")
            note = b"resumed session: first message"
            await a.node.send_message("node-b", "resume_message",
                                      frame=await ba.encrypt(key, note, b"resume"))
            (r,) = await b.wait("resume_message", 1)
            if await ba.decrypt(b.resumed_key, r["frame"], b"resume") != note:
                raise PhaseFailed("transport: the resumed session's message did not open")
            await present(ticket, 1)
            await present(mint(), 2)
            rejects = [m["reason"] for m in await a.wait("resume_reject", 2)]
            if rejects != ["replayed_ticket", "bad_ticket_auth"] or \
                    not set(rejects) <= set(res.REASONS):
                raise PhaseFailed(f"transport: the bad presentations got {rejects}")
            out["resumption"] = {"resumed": True, "rejects": rejects,
                                 "ticket_bytes": len(ticket), "replays": replay.replays}
        out["injected"] = plan.injected
        out["wire_errors"] = (a.node.wire_errors, b.node.wire_errors)
        if out["wire_errors"] != (0, 0):
            raise PhaseFailed(f"transport: wire errors {out['wire_errors']}")
    finally:
        await a.node.stop()
        await b.node.stop()
    return out


def phase_transport(np, provider, faults, health, obs_cost, obs_trace, kem, dsa, fused, aead,
                    pk_off, ct_off) -> dict:
    """Phase 15: the transport, session and degrade layers on the card, over
    the four facades on one DeviceProgramScheduler with the "cpu" providers
    and the scalar AEAD as their fallbacks and an Autotuner attached."""
    from quantum_resistant_p2p_tpu_torch.app import message_store, resumption
    from quantum_resistant_p2p_tpu_torch.net import p2p_node
    from quantum_resistant_p2p_tpu_torch.provider import autotune, facade_queues
    from quantum_resistant_p2p_tpu_torch.provider.scheduler import DeviceProgramScheduler

    t_phase = time.perf_counter()
    out = {}
    cpu_kem = provider.get_kem(kem.name, backend="cpu")
    cpu_dsa = provider.get_signature(dsa.name, backend="cpu")
    scalar = provider.get_symmetric(AEAD)
    sched = DeviceProgramScheduler(shards=1, cooloff_s=TRANSPORT_COOLOFF_S)
    ledger = obs_cost.CostLedger()
    sched.attach_cost(ledger)
    tuner = autotune.Autotuner(scheduler=sched, cost=ledger) \
        if autotune.autotune_enabled_default() else None
    facades = (provider.BatchedKEM(kem, fallback=cpu_kem, scheduler=sched),
               provider.BatchedSignature(dsa, fallback=cpu_dsa, scheduler=sched),
               provider.BatchedFused(fused, pk_off, ct_off, fallback_kem=cpu_kem,
                                     fallback_sig=cpu_dsa, scheduler=sched),
               provider.BatchedAEAD(aead, scalar, scheduler=sched, fallback=scalar))
    queues = attach_cost(facades, ledger)
    if tuner is not None:
        tuner.attach_facades(*facades)
    try:
        # the health gate, twins from the fallbacks, into a fresh verdict
        # cache: every probe runs, then every verdict is read back
        saved = os.environ.get("QRP2P_HEALTH_CACHE")
        with tempfile.TemporaryDirectory() as cache:
            os.environ["QRP2P_HEALTH_CACHE"] = cache
            try:
                first = health.gate_facades(*facades)
                second = health.gate_facades(*facades)
            finally:
                if saved is None:
                    os.environ.pop("QRP2P_HEALTH_CACHE", None)
                else:
                    os.environ["QRP2P_HEALTH_CACHE"] = saved
        if not all(v.ok for v in first + second) or len(first) != 4:
            raise PhaseFailed(f"transport: health verdicts {[v.as_dict() for v in first]}")
        if [v.cached for v in first] != [False] * 4 or [v.cached for v in second] != [True] * 4:
            raise PhaseFailed("transport: the verdict cache did not round-trip: "
                              f"{[(v.family, v.cached) for v in first + second]}")
        out["health"] = [v.as_dict() for v in first + second]
        print(f"[transport] health: {[(v.family, v.cached) for v in first + second]}")

        t0 = time.perf_counter()
        out["fused_wall_s"] = asyncio.run(fused_sessions(kem, dsa, facades[2], facades[1],
                                                         TRANSPORT_HANDSHAKES))
        out["wire"] = asyncio.run(asyncio.wait_for(
            transport(np, faults, obs_trace, resumption, message_store, p2p_node, facades, kem,
                      dsa), 120))
        out["wire_s"] = time.perf_counter() - t0
        faulted = f"{kem.name}.enc"
        fallback = {q.label: q.stats.fallback_ops for q in queues if q.stats.fallback_ops}
        if set(fallback) != {faulted}:
            raise PhaseFailed(f"transport: fallback ops outside the injected fault {fallback}")
        states = [s.breaker.state for s in sched.shards]
        if states != ["closed"]:
            raise PhaseFailed(f"transport: breakers end {states}")
        healthy = {}
        for q in queues:
            st = q.stats
            healthy[q.label] = {"flushes": st.flushes, "device_trips": st.device_trips,
                                "max_device_ms": round(1e3 * (st.device_hist.percentile(100)
                                                              or 0.0), 3),
                                "fallback_ops": st.fallback_ops,
                                "breaker_trips": st.breaker_trips}
        worst = max(h["max_device_ms"] for h in healthy.values())
        q0 = queues[0]
        print(f"[transport] largest dispatch a queue (ms, device worker) against "
              f"degrade_after_ms {1e3 * q0.degrade_after_s:.0f} and dispatch_timeout_ms "
              f"{1e3 * q0.dispatch_timeout_s:.0f} (for <= {q0.degrade_ref_batch} rows): "
              f"{ {k: v['max_device_ms'] for k, v in healthy.items()} }; worst {worst} ms")
        hist_s = sum(q.stats.device_hist.total for q in queues)
        shard_s = ledger.snapshot()["device_seconds_by_shard"]
        print(f"[transport] ledger shard_device_time {shard_s} s; the queues' device_hist "
              f"totals {hist_s:.6f} s")
        out.update(queues=healthy, shard_device_s=shard_s, device_hist_s=hist_s,
                   shard=sched.stats())
        print(f"[transport] {AGREEMENTS} key agreements over bin1 "
              f"({out['wire']['agreements']}); {MESSAGES - 1} of {MESSAGES} sealed "
              f"{MESSAGE_BYTES}-byte messages opened ({out['wire']['messages']['wall_s']:.3f} s, "
              f"sent in {out['wire']['messages']['socket_sends']} socket sends), "
              f"one dropped by the plan; {BIG_MESSAGE} bytes chunked; resumption "
              f"{out['wire']['resumption']}")

        # the serve rate of phase 4 through the scheduler and its breaker,
        # with and without the autotuner, against phase 4's plain queues, in
        # rotating turns; each scheduled arm's facade lives across its
        # turns, so the tuner sees every turn's flushes (closing them is the
        # scheduler's business)
        arms = {"plain": provider.BatchedKEM,
                "scheduled": provider.BatchedKEM(kem, fallback=cpu_kem, scheduler=sched)}
        if tuner is not None:
            arms["tuned"] = provider.BatchedKEM(kem, fallback=cpu_kem, scheduler=sched)
            tuner.attach_facades(arms["tuned"])
        rates, order = {arm: [] for arm in arms}, []
        for r in range(SCHED_RATE_ROUNDS):
            for arm in SCHED_RATE_ARMS[r % 3:] + SCHED_RATE_ARMS[:r % 3]:
                if arm not in arms:
                    continue
                facade = arms[arm]
                served = asyncio.run(serve(facade if arm == "plain"
                                           else lambda algo, facade=facade, **kw: facade, kem))
                if any(st["fallback_ops"] or st["breaker_trips"]
                       for st in served["queues"].values()):
                    raise PhaseFailed(f"transport: a healthy serve degraded: {served['queues']}")
                rates[arm].append(served["handshakes_per_s"])
                order.append(arm)
        out["serve_rate"] = rates
        print(f"[transport] ML-KEM-768 serve, {SERVE_CLIENTS} clients, handshakes/s in the "
              f"order {' '.join(order)}: " + "; ".join(
                  f"{arm} {[round(x, 1) for x in xs]} (median {statistics.median(xs):.1f})"
                  for arm, xs in rates.items()))
        out["autotune"] = tuner.snapshot() if tuner is not None else {"enabled": False}
        print(f"[transport] autotuner: "
              f"{ {k: (v['bucket'], v['window_ms']) for k, v in out['autotune']['queues'].items()} }"
              if tuner is not None else "[transport] autotuner off (QRP2P_AUTOTUNE=0)")
        if [s.breaker.state for s in sched.shards] != ["closed"]:
            raise PhaseFailed("transport: the breaker did not end closed")
    finally:
        for f in facades:
            f.close()
        sched.close()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[transport] phase took {out['phase_s']:.1f} s")
    return out


def engine_queues(engine) -> dict:
    """label -> OpQueue over every live facade of one engine."""
    from quantum_resistant_p2p_tpu_torch.provider import facade_queues

    return {q.label: q for f in (engine._bkem, engine._bsig, engine._bfused, engine._baead)
            if f is not None for q in facade_queues(f)}


def queue_ops(engine, facade: str, op: str) -> int:
    f = getattr(engine, facade)
    return 0 if f is None else f.stats()[op]["ops"]


async def engine_until(cond, what: str, wait_s: float = ENGINE_WAIT_S, detail=None,
                       phase: str = "engine") -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > wait_s:
            raise PhaseFailed(f"{phase}: timed out waiting for {what}"
                              + (f": {detail()}" if detail is not None else ""))
        await asyncio.sleep(0.002)


def queue_brief(q) -> dict:
    """One queue's flushes, ops, p50 dispatch and device ms, and its tuner's
    flush window (None without a tuner or before its first decision)."""
    st = q.stats.as_dict()
    window = q.tuner.wait_s() if q.tuner is not None else None
    return {"ops": st["ops"], "flushes": st["flushes"], "p50_dispatch_ms": st["p50_dispatch_ms"],
            "p50_device_ms": st["p50_device_ms"],
            "window_ms": None if window is None else round(1e3 * window, 3)}


async def engine_run(np, provider, app, p2p, obs_http, counts, backend: str) -> dict:
    """The port's SecureMessaging between port nodes on loopback: a gateway
    (and a second, static gateway for the bursts), client 0 with queues of
    its own, ENGINE_CLIENTS - 1 clients sharing one engine's queues, one
    handshake alone, the bursts, the secure messages, a ticket resume, a
    forged frame, a typed rejection, the FrodoKEM and HQC hot swaps, the
    telemetry endpoints; every check raises PhaseFailed."""
    import urllib.request

    out: dict = {"ready_s": {}}
    nodes, engines = [], []
    #: id -> (engine, label, queue) of every queue any engine has had: a hot
    #: swap replaces facades, and the swapped-out queues are checked too
    seen: dict = {}

    def note_queues() -> None:
        for e in engines:
            for label, q in engine_queues(e).items():
                seen.setdefault(id(q), (e.node_id, label, q))

    async def stack(name: str, **kw):
        """A node and its engine; a batched engine's gate and warm-up run
        before the next engine is built (one warm-up thread at a time)."""
        node = p2p.P2PNode(name, "127.0.0.1", 0)
        await node.start()
        kw.setdefault("use_batching", True)
        kw.setdefault("symmetric", provider.get_symmetric(AEAD))
        t0 = time.perf_counter()
        engine = app.SecureMessaging(node, backend=backend, **kw)
        await engine.wait_ready()
        if engine._warmup_thread is not None:
            out["ready_s"][name] = round(time.perf_counter() - t0, 3)
        nodes.append(node)
        engines.append(engine)
        return engine

    def inbox(engine) -> list:
        box = []
        engine.register_message_listener(
            lambda peer, m: None if m.is_system else box.append(m.content))
        return box

    try:
        t0 = time.perf_counter()
        gw = await stack("gateway", autotune=True)
        static = await stack("gateway-static", autotune=False)
        # client 0's own queues flush at max_batch (no tuner), so a burst of
        # its sends rides one flush a queue and leaves in the order sent
        c0 = await stack("client-000", autotune=False)
        # the other clients share one engine's queues, as the reference's
        # swarm bench builds its clients: one device thread pool for all
        proto = await stack("clients-shared")
        pks, sks = proto.signature.generate_keypair_batch(ENGINE_CLIENTS)
        clients = []
        for i in range(ENGINE_CLIENTS):
            c = await stack(f"client-{i + 1:03d}", use_batching=False, kem=proto.kem,
                            symmetric=proto.symmetric, signature=proto.signature,
                            sig_keypair=(bytes(pks[i]), bytes(sks[i])))
            c._bkem, c._bsig, c._bfused, c._baead = (proto._bkem, proto._bsig, proto._bfused,
                                                    proto._baead)
            c.use_batching = True
            clients.append(c)
        out["setup_s"] = time.perf_counter() - t0
        note_queues()
        armed = sorted(f"{n}:{label}" for n, label, q in seen.values() if q.fallback_fn is not None)
        if armed:
            raise PhaseFailed(f"engine: CPU fallbacks armed on {armed[:4]}")
        not_ready = [(e.node_id, e.ready_status()) for e in engines
                     if not e.ready_status()["ready"]]
        if not_ready:
            raise PhaseFailed(f"engine: not ready after the warm-up: {not_ready[:2]}")
        if (gw.kem.name, gw.signature.name, gw.symmetric.name, gw.kem.backend) != (
                "ML-KEM-768", "ML-DSA-65", AEAD, backend) or gw._bfused is None:
            raise PhaseFailed(f"engine: the gateway runs {gw.kem.name}/{gw.signature.name}/"
                              f"{gw.symmetric.name} on {gw.kem.backend}, fused "
                              f"{gw._bfused is not None}")
        for c in [c0] + clients:
            for g in (gw, static):
                if await c.node.connect_to_peer("127.0.0.1", g.node.port, timeout=5.0) \
                        != g.node_id:
                    raise PhaseFailed(f"engine: {c.node_id} could not reach {g.node_id}")
        await engine_until(lambda: all(g.node.is_connected(c.node_id) for g in (gw, static)
                                       for c in [c0] + clients),
                           "the gateways to register clients")
        await engine_until(lambda: all(c.peer_settings.get(g.node_id) for g in (gw, static)
                                       for c in [c0] + clients), "the settings gossip")
        print(f"[engine] {len(engines)} engines ({backend}, ML-KEM-768 x ML-DSA-65 fused, {AEAD}) "
              f"in {out['setup_s']:.2f} s; each batched engine gated and warmed alone (s): "
              f"{out['ready_s']}")

        # one handshake alone
        before = {"kg": queue_ops(c0, "_bkem", "keygen"),
                  "ks": queue_ops(c0, "_bfused", "keygen_sign"),
                  "dvs": queue_ops(c0, "_bfused", "decaps_verify_sign"),
                  "evs": queue_ops(gw, "_bfused", "encaps_verify_sign")}
        t0 = time.perf_counter()
        if not await c0.initiate_key_exchange(gw.node_id):
            raise PhaseFailed("engine: the lone handshake failed")
        out["lone_s"] = time.perf_counter() - t0
        await engine_until(lambda: gw.verify_key_exchange_state(c0.node_id),
                           "the gateway's confirm")
        trips = c0.metrics()["handshake_trips"]
        after = {"kg": queue_ops(c0, "_bkem", "keygen"),
                 "ks": queue_ops(c0, "_bfused", "keygen_sign"),
                 "dvs": queue_ops(c0, "_bfused", "decaps_verify_sign"),
                 "evs": queue_ops(gw, "_bfused", "encaps_verify_sign")}
        delta = {k: after[k] - before[k] for k in before}
        out["lone"] = {"trips": trips["last"], "ops": delta, "wall_s": out["lone_s"]}
        if trips["last"] is None or trips["last"] > ENGINE_TRIPS_MAX:
            raise PhaseFailed(f"engine: the lone handshake took {trips['last']} trips")
        if delta["ks"] < 1 or delta["dvs"] < 1 or delta["kg"] != 0 or delta["evs"] < 1:
            raise PhaseFailed(f"engine: the lone handshake's queue ops {delta}")
        if c0.shared_keys[gw.node_id] != gw.shared_keys[c0.node_id]:
            raise PhaseFailed("engine: the lone handshake's keys differ")
        print(f"[engine] client 0's handshake alone: {trips['last']} trips on its queues "
              f"(limit {ENGINE_TRIPS_MAX}), {1e3 * out['lone_s']:.1f} ms, queue ops {delta} "
              f"(kg: per-op KEM keygen; ks, dvs: the fused keygen_sign and decaps_verify_sign; "
              f"evs: the gateway's encaps_verify_sign)")

        # every burst client at once, against the tuned and the static gateway in turn
        bursts = []
        for mode in ENGINE_BURSTS:
            g = gw if mode == "tuned" else static
            q = g._bfused._enc
            n0, sizes0 = q.stats.ops, len(q.stats.batch_sizes)
            t0 = time.perf_counter()
            oks = await asyncio.gather(*(c.initiate_key_exchange(g.node_id) for c in clients))
            wall = time.perf_counter() - t0
            await engine_until(lambda g=g: all(g.verify_key_exchange_state(c.node_id)
                                               for c in clients), "the burst's confirms")
            bad = [c.node_id for c, ok in zip(clients, oks)
                   if not ok or c.shared_keys.get(g.node_id) != g.shared_keys.get(c.node_id)]
            if bad:
                raise PhaseFailed(f"engine: {len(bad)} burst handshakes failed or disagree "
                                  f"({mode}), first {bad[:4]}")
            if q.stats.ops - n0 != len(clients):
                raise PhaseFailed(f"engine: the {mode} gateway's encaps_verify_sign ops "
                                  f"{q.stats.ops - n0} for {len(clients)} handshakes")
            lat = [c._handshake_latency.last for c in clients]
            bursts.append({"gateway": mode, "handshakes_per_s": len(clients) / wall,
                           "wall_s": wall, "flush_sizes": q.stats.batch_sizes[sizes0:],
                           "verify_flush_sizes": g._bsig._verify.stats.batch_sizes[-8:],
                           "latency_ms": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
                           "trips": sorted({c.metrics()["handshake_trips"]["last"]
                                            for c in clients})})
            print(f"[engine] burst, {len(clients)} clients -> {mode} gateway: "
                  f"{len(clients) / wall:.1f} handshakes/s ({wall:.3f} s); gateway "
                  f"encaps_verify_sign flush sizes {bursts[-1]['flush_sizes']}; handshake "
                  f"latency ms p50 {bursts[-1]['latency_ms']['p50']:.1f} p99 "
                  f"{bursts[-1]['latency_ms']['p99']:.1f} (each client's handshake_latency_s); "
                  f"trips a handshake {bursts[-1]['trips']}")
        out["bursts"] = bursts

        # the secure messages, client 0 -> gateway, in order
        rng = np.random.default_rng(TRANSPORT_SEED + 1)
        payloads = [bytes(r) for r in rng.integers(0, 256, (ENGINE_MESSAGES,
                                                            ENGINE_MESSAGE_BYTES), dtype=np.uint8)]
        got = inbox(gw)
        opens0 = queue_ops(gw, "_baead", "open")
        seals0 = queue_ops(c0, "_baead", "seal")
        t0 = time.perf_counter()
        sent = await asyncio.gather(*(c0.send_message(gw.node_id, m) for m in payloads))
        if any(m is None for m in sent):
            raise PhaseFailed("engine: a secure message was not sent")
        def gateway_side():
            return {"arrived": len(got), **{k: queue_brief(q) for k, q in (
                ("open", gw._baead._open), ("verify", gw._bsig._verify))}}

        await engine_until(lambda: len(got) >= ENGINE_MESSAGES, "the secure messages",
                           ENGINE_MESSAGES_WAIT_S, gateway_side)
        wall = time.perf_counter() - t0
        if got != payloads:
            raise PhaseFailed("engine: the messages arrived changed or out of order")
        opens = queue_ops(gw, "_baead", "open") - opens0
        seals = queue_ops(c0, "_baead", "seal") - seals0
        if (opens, seals) != (ENGINE_MESSAGES, ENGINE_MESSAGES):
            raise PhaseFailed(f"engine: {seals} seals and {opens} opens through BatchedAEAD "
                              f"for {ENGINE_MESSAGES} messages")
        out["messages"] = {"n": ENGINE_MESSAGES, "bytes": ENGINE_MESSAGE_BYTES, "wall_s": wall,
                           "messages_per_s": ENGINE_MESSAGES / wall,
                           "sign_flush_sizes": c0._bsig._sign.stats.batch_sizes[-4:],
                           "seal_flush_sizes": c0._baead._seal.stats.batch_sizes[-4:],
                           "open_flush_sizes": gw._baead._open.stats.batch_sizes[-4:],
                           "gateway": gateway_side()}
        print(f"[engine] {ENGINE_MESSAGES} secure messages of {ENGINE_MESSAGE_BYTES} B sent at "
              f"once, client 0 -> gateway, each signed, sealed, opened and verified through the "
              f"engines' queues: {ENGINE_MESSAGES / wall:.1f} messages/s ({wall:.3f} s), in order; "
              f"client 0's sign / seal flush sizes {out['messages']['sign_flush_sizes']} / "
              f"{out['messages']['seal_flush_sizes']}; the gateway opens and verifies one "
              f"message at a time (its read loop awaits each): {out['messages']['gateway']}")

        # a ticket resume on a fresh connection: no fused, KEM or signature op
        def handshake_ops():
            return [queue_ops(e, f, op) for e in (c0, gw) for f, op in (
                ("_bfused", "keygen_sign"), ("_bfused", "encaps_verify_sign"),
                ("_bfused", "decaps_verify_sign"), ("_bkem", "keygen"), ("_bkem", "encaps"),
                ("_bkem", "decaps"), ("_bsig", "sign"), ("_bsig", "verify"))]

        if c0.ticket_for(gw.node_id) is None:
            raise PhaseFailed("engine: client 0 holds no ticket from the gateway")
        await c0.node.disconnect_from_peer(gw.node_id, intentional=True)
        await engine_until(lambda: not gw.node.is_connected(c0.node_id), "the disconnect")
        if await c0.node.connect_to_peer("127.0.0.1", gw.node.port, timeout=5.0) != gw.node_id:
            raise PhaseFailed("engine: client 0 could not reconnect")
        await engine_until(lambda: gw.node.is_connected(c0.node_id), "the reconnect")
        ops0 = handshake_ops()
        t0 = time.perf_counter()
        if not await c0.initiate_key_exchange(gw.node_id):
            raise PhaseFailed("engine: the resumed handshake failed")
        out["resume_s"] = time.perf_counter() - t0
        if (c0._ctr_resumes_used.value, gw._ctr_resumes_ok.value) != (1, 1):
            raise PhaseFailed(f"engine: resumes used {c0._ctr_resumes_used.value}, accepted "
                              f"{gw._ctr_resumes_ok.value}")
        if handshake_ops() != ops0:
            raise PhaseFailed(f"engine: the resume ran queue ops {ops0} -> {handshake_ops()}")
        await engine_until(lambda: gw.shared_keys.get(c0.node_id) == c0.shared_keys[gw.node_id],
                           "the resumed key")
        got.clear()
        await c0.send_message(gw.node_id, b"resumed")
        await engine_until(lambda: got == [b"resumed"], "the message under the resumed key")

        # a forged frame never reaches the listener (the gateway re-keys)
        old = gw.shared_keys[c0.node_id]
        await c0.node.send_message(gw.node_id, "secure_message", ct=b"\x00" * 64, ad=b"{}")
        await engine_until(lambda: gw.shared_keys.get(c0.node_id) not in (None, old)
                           and gw.verify_key_exchange_state(c0.node_id)
                           and c0.shared_keys.get(gw.node_id) == gw.shared_keys[c0.node_id],
                           "the re-key after the forged frame")
        if got != [b"resumed"] or gw.metrics()["resilience"]["rekeys"] != 1:
            raise PhaseFailed(f"engine: after the forged frame the listener holds {got[1:]}, "
                              f"rekeys {gw.metrics()['resilience']['rekeys']}")
        print(f"[engine] ticket resume in {1e3 * out['resume_s']:.1f} ms with no queue op; a "
              f"forged secure_message reached no listener and the gateway re-keyed")

        # a typed rejection: a client on ML-KEM-1024 (its gossip pre-check
        # switched off, so the gateway's refusal comes over the wire)
        odd = await stack("client-kem1024", use_batching=False,
                          kem=provider.get_kem("ML-KEM-1024", backend))
        rejects = []

        async def on_reject(peer_id, m):
            rejects.append(m.get("reason"))

        odd.node.register_message_handler("ke_reject", on_reject)
        odd.node.unregister_message_handler("settings_update", odd._handle_settings_update)
        if await odd.node.connect_to_peer("127.0.0.1", gw.node.port, timeout=5.0) != gw.node_id:
            raise PhaseFailed("engine: the ML-KEM-1024 client could not reach the gateway")
        status = await odd._initiate_once(gw.node_id)
        if status != "algorithm_mismatch" or rejects != ["algorithm_mismatch"]:
            raise PhaseFailed(f"engine: the ML-KEM-1024 client got {status}, rejects {rejects}")
        print("[engine] an ML-KEM-1024 client was refused with a typed algorithm_mismatch")

        # the hot swaps (FrodoKEM-640-SHAKE, then HQC-128): the unfused
        # path, a full re-handshake, then messages under the new key
        out["swap_s"], out["swap_counts"] = {}, {}
        for swap_kem in ENGINE_SWAP_KEMS:
            start = counts()
            note_queues()
            t0 = time.perf_counter()
            await gw.set_key_exchange_algorithm(swap_kem)
            await engine_until(lambda: c0.peer_settings.get(gw.node_id, {}).get("kem")
                               == swap_kem, "the gateway's new settings")
            await c0.set_key_exchange_algorithm(swap_kem)
            if c0._bfused is not None or gw._bfused is not None:
                raise PhaseFailed(f"engine: a {swap_kem} engine kept a fused facade")
            await engine_until(lambda: c0.verify_key_exchange_state(gw.node_id)
                               and gw.verify_key_exchange_state(c0.node_id)
                               and c0.shared_keys[gw.node_id] == gw.shared_keys[c0.node_id],
                               f"the {swap_kem} re-handshake")
            out["swap_s"][swap_kem] = time.perf_counter() - t0
            out["swap_counts"][swap_kem] = (start, counts())  # the re-handshake alone
            kem_ops = {op: queue_ops(e, "_bkem", op) for e, op in ((c0, "keygen"), (gw, "encaps"),
                                                                  (c0, "decaps"))}
            if min(kem_ops.values()) < 1 or c0.kem.name != swap_kem or gw.kem.name != swap_kem:
                raise PhaseFailed(f"engine: the {swap_kem} handshake's KEM ops {kem_ops}")
            got.clear()
            swap_msgs = [b"%s %d" % (swap_kem.encode(), i) for i in range(ENGINE_SWAP_MESSAGES)]
            for m in swap_msgs:
                await c0.send_message(gw.node_id, m)
            await engine_until(lambda: len(got) >= len(swap_msgs),
                               f"the messages after the {swap_kem} swap")
            if got != swap_msgs:
                raise PhaseFailed(f"engine: the messages after the {swap_kem} swap differ")
            print(f"[engine] hot swap to {swap_kem} on both sides and a full re-handshake in "
                  f"{out['swap_s'][swap_kem]:.2f} s (KEM queue ops {kem_ops}); "
                  f"{len(swap_msgs)} messages after it")

        # the telemetry endpoints of the gateway
        srv = obs_http.TelemetryServer.for_engine(gw, port=0)
        try:
            def get(path):
                with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                            timeout=10) as r:
                    return r.status, r.read()

            loop = asyncio.get_running_loop()
            answers = {p: await loop.run_in_executor(None, get, p)
                       for p in ("/healthz", "/readyz", "/metrics")}
        finally:
            srv.stop()
        if [answers[p][0] for p in answers] != [200, 200, 200] or \
                b"handshake_trips" not in answers["/metrics"][1]:
            raise PhaseFailed(f"engine: telemetry answered "
                              f"{ {p: a[0] for p, a in answers.items()} }")
        print("[engine] telemetry: /healthz 200, /readyz 200, /metrics names handshake_trips")

        # no fallback anywhere (every queue any engine had, those the hot
        # swaps replaced included), no breaker trip, every engine ready
        note_queues()
        fallback, states, worst = {}, {}, {}
        for node_id, label, q in seen.values():
            if q.fallback_fn is not None or q.stats.fallback_ops:
                fallback[f"{node_id}:{label}"] = q.stats.fallback_ops
            ms = 1e3 * (q.stats.device_hist.percentile(100) or 0.0)
            worst[label] = max(worst.get(label, 0.0), round(ms, 3))
        served = {}
        for e in engines:
            if e._scheduler is None:  # the shared clients: the shared engine's
                continue
            states.update({f"{e.node_id}:shard{s.index}": (s.breaker.state, s.breaker.trips)
                           for s in e._scheduler.shards
                           if s.breaker.state != "closed" or s.breaker.trips})
            m = e.metrics()
            served[e.node_id] = (m["fallback_trips"], m["device_served_fraction"])
        await asyncio.gather(*(e.wait_ready() for e in engines))
        unready = [e.node_id for e in engines if not e.ready_status()["ready"]]
        off_card = {k: v for k, v in served.items() if v != (0, 1.0)}
        if fallback or states or unready or off_card:
            raise PhaseFailed(f"engine: fallbacks armed or served {fallback}, breakers "
                              f"(state, trips) {states}, (fallback_trips, "
                              f"device_served_fraction) {off_card}, not ready {unready}")
        q0 = engine_queues(gw)[f"{gw.kem.name}.enc"]
        out["largest_dispatch_ms"] = worst
        print(f"[engine] {len(seen)} queues over {len(served)} batched engines: no CPU fallback "
              f"armed, no fallback op, no breaker trip, device_served_fraction 1.0 on each")
        print(f"[engine] largest device dispatch a queue over every engine (ms, device worker) "
              f"against degrade_after_ms {1e3 * q0.degrade_after_s:.0f} and dispatch_timeout_ms "
              f"{1e3 * q0.dispatch_timeout_s:.0f}: {worst}")
        out["gateway"] = {"metrics_trips": gw.metrics()["handshake_trips"],
                          "autotune": gw.metrics()["gateway"]["autotune"],
                          "device_served_fraction": gw.metrics()["device_served_fraction"]}
        return out
    finally:
        for node in nodes:
            await node.stop()
        for e in engines:
            e.close()


def phase_engine(np, provider, counts, backend: str = "cuda") -> dict:
    """Phase 16: the port's SecureMessaging engines on the card."""
    from quantum_resistant_p2p_tpu_torch import app
    from quantum_resistant_p2p_tpu_torch.net import p2p_node
    from quantum_resistant_p2p_tpu_torch.obs import http as obs_http

    t0 = time.perf_counter()
    out = asyncio.run(asyncio.wait_for(engine_run(np, provider, app, p2p_node, obs_http,
                                                  counts, backend), 900))
    out["phase_s"] = time.perf_counter() - t0
    print(f"[engine] phase took {out['phase_s']:.1f} s")
    return out


def pct(xs, q):
    return 1e3 * sorted(xs)[min(len(xs) - 1, int(q / 100 * len(xs)))]


def print_served(tag: str, name: str, served: dict) -> None:
    print(f"[{tag}] {name}, {SERVE_CLIENTS} clients: {served['handshakes_per_s']:.1f} "
          f"handshakes/s (keygen+encaps+decaps, {served['handshake_wall_s']:.3f} s); "
          f"latency ms {served['latency_ms']}; opcache {served['opcache']}")
    for op, st in served["queues"].items():
        print(f"[{tag}] {op} queue: {st}")


async def serve(BatchedKEM, kem, expect_cache: bool = True) -> dict:
    """SERVE_CLIENTS asyncio clients through one queue over ``kem``, then
    SERVE_CLIENTS encaps to one server key, twice.  With ``expect_cache``
    the second round must hit the KEM's operand cache; without it the KEM
    must have none (HQC, as the reference's)."""
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
    if expect_cache:
        cache = kem.opcache.stats()
        if cache["hits"] < 1:
            raise PhaseFailed(f"serve: the single-key encaps path never hit the cache {cache}")
    elif getattr(kem, "opcache", None) is not None:
        raise PhaseFailed(f"serve: {kem.name} has an operand cache")
    else:
        cache = None
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
        verify_sizes = bs._verify.stats.batch_sizes[-16:]
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
           "verify_flush_sizes": verify_sizes, "queues": stats}
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
    is also timed without the profiler, which slows the host.  K1's wrapper
    counts its launches in the window too: a trace that holds fewer lost
    events (late in a run, the first few of a window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from quantum_resistant_p2p_tpu_torch.core import keccak_cuda

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    plain_wall_us = 1e6 * (time.perf_counter() - t0)
    window = f"{label}_window"
    k1_counted = keccak_cuda.sponge.launches
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(window):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        k1_counted = keccak_cuda.sponge.launches - k1_counted
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        window_us, busy_us = busy_share(events, window)
        launches = sum(1 for e in events if e.get("cat") == "kernel")
    device_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                 and ev.key != window}  # the annotation's own span on the GPU
    total_us = sum(device_us.values())
    calls = {ev.key: ev.count for ev in prof.key_averages() if ev.key in device_us}
    ours = ("::sponge_rows_kernel<", "::sponge_split_kernel<", "::sample_ntt_kernel(",
            "::prf_cbd_kernel<", "::kem_ntt_kernel<", "::ntt_kernel<", "::rej_ntt_kernel(",
            "::rej_bounded_kernel<", "::chacha_kernel(", "::a_times_s_kernel<",
            "::s_times_a_kernel<", "::cdf_kernel(", "::sha256_kernel(", "::sha512_kernel(",
            "::sha256_split_kernel(", "::sha512_split_kernel(")
    ours_us = sum(v for k, v in device_us.items() if any(o in k for o in ours))
    # K1 (both paths, both entries), K7 (mldsa.cu's ntt_kernel; mlkem.cu's
    # K4 is kem_ntt_kernel, which "::ntt_kernel<" does not match), K2, K3
    # and K4 (every instance), K5, K6 (both etas), K12 and K13 (both paths,
    # and the few-row path alone)
    redesigned = {"k1": lambda k: "::sponge_rows_kernel<" in k or "::sponge_split_kernel<" in k,
                  "k7": lambda k: "::ntt_kernel<" in k and k.endswith(", long)"),
                  "k2": lambda k: "::sample_ntt_kernel(" in k,
                  "k3": lambda k: "::prf_cbd_kernel<" in k,
                  "k4": lambda k: "::kem_ntt_kernel<" in k,
                  "k5": lambda k: "::rej_ntt_kernel(" in k,
                  "k6": lambda k: "::rej_bounded_kernel<" in k,
                  "k12": lambda k: "::sha256_kernel(" in k or "::sha256_split_kernel(" in k,
                  "k12_few_row": lambda k: "::sha256_split_kernel(" in k,
                  "k13": lambda k: "::sha512_kernel(" in k or "::sha512_split_kernel(" in k,
                  "k13_few_row": lambda k: "::sha512_split_kernel(" in k}
    mine = {name: [k for k in device_us if hit(k)] for name, hit in redesigned.items()}
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:12]
    out = {"batches": reps, "window_ms_per_batch": window_us / reps / 1e3,
           "busy_ms_per_batch": busy_us / reps / 1e3, "device_busy_share": busy_us / window_us,
           "unprofiled_wall_ms_per_batch": plain_wall_us / reps / 1e3,
           "device_ms_per_batch": total_us / reps / 1e3,
           "port_kernels_ms_per_batch": ours_us / reps / 1e3, "device_kinds": len(device_us),
           "kernel_launches_per_batch": launches / reps,
           "top_device_ms_per_batch": [[k, v / reps / 1e3] for k, v in top],
           "k1_wrapper_launches_per_batch": k1_counted / reps}
    for name, keys in mine.items():
        out[f"{name}_device_ms_per_batch"] = sum(device_us[k] for k in keys) / reps / 1e3
        out[f"{name}_launches_per_batch"] = sum(calls[k] for k in keys) / reps
    print(f"[profile] {label} batch under the profiler: window {out['window_ms_per_batch']:.3f}"
          f" ms, device busy {out['busy_ms_per_batch']:.3f} ms (busy share "
          f"{out['device_busy_share']:.3f}, from the trace); without the profiler the same "
          f"window takes {out['unprofiled_wall_ms_per_batch']:.3f} ms per batch")
    print(f"[profile] {label}: kernel time {out['device_ms_per_batch']:.3f} ms per batch, of "
          f"which the port's kernels {out['port_kernels_ms_per_batch']:.3f} ms; "
          f"{len(device_us)} kinds, {out['kernel_launches_per_batch']:.0f} launches")
    print(f"[profile] {label}: " + ", ".join(
        f"{name.upper()} {out[f'{name}_device_ms_per_batch']:.4f} ms in "
        f"{out[f'{name}_launches_per_batch']:.0f} launches" for name in redesigned) + " per batch"
          f" (K1's wrapper: {out['k1_wrapper_launches_per_batch']:.0f} launches a batch)")
    for name, ms in out["top_device_ms_per_batch"]:
        print(f"[profile]   {ms:.4f} ms  {name[:110]}")
    return out


def kernel_wrappers() -> dict:
    """Every kernel wrapper by name (each counts its launches); the port must
    be importable."""
    from quantum_resistant_p2p_tpu_torch.fleet.gateway import kernel_wrappers

    return kernel_wrappers()


def launch_counts(wrappers: dict) -> dict:
    """Each wrapper's launches, K12's and K13's few-row path apart."""
    counts = {name: w.launches for name, w in wrappers.items()}
    counts.update({f"{name}[few-row]": wrappers[name].split_launches for name in SHA2_KERNELS})
    return counts


def count_hqc_k1():
    """Count the K1 launches made inside HQC's own SHAKE256 calls, on the
    thread that makes each call (the serving pool's other thread may launch
    K1 for a signature meanwhile), and return the count's reader."""
    import threading
    import types

    from quantum_resistant_p2p_tpu_torch.core import keccak, keccak_cuda
    from quantum_resistant_p2p_tpu_torch.kem import hqc
    from quantum_resistant_p2p_tpu_torch.utils import cuda

    total, lock = [0], threading.Lock()

    def shake256(data, out_len):
        before = cuda.thread_launches(keccak_cuda.sponge)
        try:
            return keccak.shake256(data, out_len)
        finally:
            with lock:
                total[0] += cuda.thread_launches(keccak_cuda.sponge) - before

    hqc.keccak = types.SimpleNamespace(shake256=shake256)
    return lambda: total[0]


def engine_child() -> int:
    """Phase 16 in a process of its own (``--engine-phase``, started by
    phase_engine_process): its launch counts start at 0 in it, and its
    result, the counts included, is its last line of output."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from quantum_resistant_p2p_tpu_torch import provider

    wrappers = kernel_wrappers()
    hqc_k1 = count_hqc_k1()
    try:
        out = phase_engine(np, provider, lambda: {**launch_counts(wrappers), HQC_OWN_K1: hqc_k1()})
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    out["launches"] = launch_counts(wrappers)
    try:
        out["thread_signs"] = thread_signs(provider)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"engine_phase": out}, default=str))
    return 0


def thread_signs(provider) -> dict:
    """Wall seconds of N host threads of this process, each making
    ENGINE_THREAD_SIGNS ML-DSA-65 signatures at B = 1 through the provider
    on the card, for each N of ENGINE_THREADS: the launch-bound work that a
    queue's device pool and several engines in one process launch from
    several threads.  Runs after the phase's launch counts are read."""
    import threading

    import torch

    dsa = provider.get_signature("ML-DSA-65")
    _, sk = dsa.generate_keypair()
    dsa.sign(sk, b"warm")
    torch.cuda.synchronize()
    out = {}
    for n in ENGINE_THREADS:
        errors = []

        def worker():
            try:
                for i in range(ENGINE_THREAD_SIGNS):
                    dsa.sign(sk, b"m%d" % i)
                torch.cuda.synchronize()
            except Exception as exc:  # raised below, on the main thread
                errors.append(exc)

        threads = [threading.Thread(target=worker) for _ in range(n)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if errors:
            raise PhaseFailed(f"engine: a threaded sign failed: {errors[0]!r}")
        out[n] = {"wall_s": wall, "ms_a_sign": 1e3 * wall / (n * ENGINE_THREAD_SIGNS)}
    print(f"[engine] ML-DSA-65 signs at B = 1 from N threads of the phase's process, "
          f"{ENGINE_THREAD_SIGNS} a thread (after its launch counts were read): "
          + "; ".join(f"N = {n}: {v['wall_s']:.3f} s, {v['ms_a_sign']:.1f} ms of wall time a sign"
                      for n, v in out.items()))
    return out


def phase_engine_process() -> dict:
    """Phase 16 in a fresh process on the same card, as a gateway runs: this
    process, after phases 1-15, ran the phase's launch-bound work ~2.5x
    slower than a fresh one (PERF.md §6).  The kernel libraries of
    phase 1 and the verdict cache (QRP2P_HEALTH_CACHE) are shared."""
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--engine-phase"],
                              capture_output=True, text=True, timeout=ENGINE_PROCESS_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise PhaseFailed(f"engine: the phase's process ran past {exc.timeout} s") from None
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        print(line)
    if proc.returncode != 0 or not lines or not lines[-1].startswith('{"engine_phase"'):
        raise PhaseFailed(f"engine: the phase's process exited {proc.returncode}: "
                          f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1])["engine_phase"]


async def fleet_until(cond, what: str, wait_s: float = FLEET_WAIT_S, detail=None) -> None:
    await engine_until(cond, what, wait_s, detail, phase="fleet")


def device_free_bytes(backend: str):
    """The card's free memory (None off the card)."""
    if backend != "cuda":
        return None
    import torch

    return torch.cuda.mem_get_info()[0]


def mib_taken(free0, processes: int):
    """MiB of the card's memory each of ``processes`` new processes took
    since ``free0`` was read (None off the card).  The card's machine shows
    no per-process figure: nvidia-smi's compute-apps query reports every
    process at the card's whole use."""
    if free0 is None:
        return None
    import torch

    return round((free0 - torch.cuda.mem_get_info()[0]) / processes / 2**20, 1)


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


#: the kernels a gateway launches while it serves (the responder's fused
#: encaps_verify_sign, its verify of the confirm and of each message, the
#: ChaCha20-Poly1305 opens): every kernel of the handshake but ML-KEM's
#: forward NTT and ML-DSA's RejBoundedPoly, which only key generation runs
FLEET_SERVING_KERNELS = ENCAPS_KERNELS + ("keccak_sponge_varlen", "mldsa_rej_ntt", "mldsa_ntt",
                                          "mldsa_ntt_inv", "chacha_blocks")


async def fleet_run(provider, app, p2p, fleet_mod, control, faults, slo, backend: str) -> dict:
    """Phase 18: FLEET_GATEWAYS gateway processes behind the port's router
    on 127.0.0.1, FLEET_CLIENTS client engines, a seeded SIGKILL of a
    gateway holding sessions, the resumes on the ring successor, the
    restart and the stop; every check raises PhaseFailed, and a finally
    kills every gateway process."""
    out: dict = {}
    report_dir = Path(tempfile.mkdtemp(prefix="qrp2p-fleet-"))
    fleet = fleet_mod.GatewayFleet(
        FLEET_GATEWAYS, spawn="process", providers="real", seed=FLEET_SEED,
        report_dir=report_dir, register_timeout=FLEET_REGISTER_TIMEOUT_S,
        gateway_kw={"backend": backend, "prewarm_cap": FLEET_PREWARM})
    spawned, registered, dead_at, killed_at = {}, {}, {}, {}
    spawn_member, kill_member = fleet._spawn_member, fleet.kill

    async def timed_spawn(member):
        await spawn_member(member)
        spawned[member.gateway_id] = time.perf_counter()
        note_pids([member.pid])

    def timed_kill(gid):
        killed_at[gid] = time.perf_counter()
        kill_member(gid)

    def on_event(event, gid):
        if event == "registered":
            registered[gid] = time.perf_counter()
        elif event == "gateway_dead":
            dead_at.setdefault(gid, time.perf_counter())

    fleet._spawn_member, fleet.kill = timed_spawn, timed_kill
    fleet.on_event(on_event)
    pids, nodes, clients, proto = set(), [], [], None
    pid_file = os.environ.get(FLEET_PID_FILE)

    def note_pids(new) -> None:
        """Keep each gateway pid, here and in the file the parent reaps."""
        pids.update(new)
        if pid_file:
            Path(pid_file).write_text(" ".join(str(p) for p in sorted(pids)))

    stopped = False

    def logs() -> str:
        return " | ".join(f"{p.name}: {p.read_text(errors='replace')[-1500:]}"
                          for p in sorted(report_dir.glob("*.log")))

    def counts_of(gid) -> int:
        return fleet.members[gid].stats.get("msgs_received") or 0

    async def fresh_heartbeats(gids) -> None:
        marks = {g: fleet.members[g].hb_count for g in gids}
        await fleet_until(lambda: all(fleet.members[g].hb_count >= marks[g] + 2 for g in gids),
                          f"two fresh heartbeats from {sorted(gids)}")

    try:
        print(f"[fleet] register_timeout {FLEET_REGISTER_TIMEOUT_S:.0f} s, not the manager's "
              f"60 s: {FLEET_GATEWAYS} gateway processes start at once on one card, each "
              f"importing the port, loading the kernel libraries, gating its facades and "
              f"warming buckets 1-{FLEET_PREWARM} of three of them, ~30 s on the H100")
        free0 = device_free_bytes(backend)
        t0 = time.perf_counter()
        start = asyncio.ensure_future(fleet.start())
        while not start.done():
            gone = [m.gateway_id for m in fleet.members.values()
                    if m.proc is not None and m.proc.returncode is not None]
            if gone:
                start.cancel()
                await asyncio.gather(start, return_exceptions=True)
                raise PhaseFailed(f"fleet: gateway {gone} exited before registering; "
                                  f"logs: {logs()}")
            await asyncio.sleep(0.05)
        if start.exception() is not None:
            raise PhaseFailed(f"fleet: {start.exception()}; logs: {logs()}")
        out["start_s"] = time.perf_counter() - t0
        first_pids = {g: m.pid for g, m in fleet.members.items()}
        out["register_s"] = {g: round(registered[g] - spawned[g], 3) for g in sorted(fleet.members)}
        print(f"[fleet] {FLEET_GATEWAYS} gateway processes ({backend}, ML-KEM-768 x ML-DSA-65 "
              f"fused, {AEAD}, prewarm_cap {FLEET_PREWARM}) registered in {out['start_s']:.1f} s; "
              f"seconds from spawn to hello: {out['register_s']}")
        out["gateway_mib"] = {"each_of_three": mib_taken(free0, FLEET_GATEWAYS)}
        print(f"[fleet] device memory a gateway process, warm (the card's free memory before "
              f"the spawn less after the hellos, over {FLEET_GATEWAYS}): "
              f"{out['gateway_mib']['each_of_three']} MiB; gateway pids {first_pids}")

        # the client engines: FLEET_CLIENTS sharing one engine's queues
        node = p2p.P2PNode("fleet-clients-shared", "127.0.0.1", 0)
        await node.start()
        nodes.append(node)
        proto = app.SecureMessaging(node, backend=backend, use_batching=True,
                                    symmetric=provider.get_symmetric(AEAD))
        await proto.wait_ready()
        pks, sks = proto.signature.generate_keypair_batch(FLEET_CLIENTS)
        for i in range(FLEET_CLIENTS):
            node = p2p.P2PNode(f"fleet-client-{i:03d}", "127.0.0.1", 0)
            await node.start()
            nodes.append(node)
            c = app.SecureMessaging(node, backend=backend, kem=proto.kem,
                                    symmetric=proto.symmetric, signature=proto.signature,
                                    sig_keypair=(bytes(pks[i]), bytes(sks[i])), auto_heal=False)
            c._bkem, c._bsig, c._bfused, c._baead = (proto._bkem, proto._bsig, proto._bfused,
                                                    proto._baead)
            c.use_batching = True
            clients.append(c)
        await fresh_heartbeats(list(fleet.members))
        base_launches = {g: dict(m.stats["kernel_launches"]) for g, m in fleet.members.items()}

        # each client asks the router for its gateway, connects, handshakes
        home = {}
        for c in clients:
            reply = await control.route_query("127.0.0.1", fleet.ctrl_port, c.node_id)
            if reply.get("type") != control.ROUTE_OK or \
                    reply["gateway"] != fleet.ring.assign(c.node_id):
                raise PhaseFailed(f"fleet: {c.node_id} was routed {reply}, ring owner "
                                  f"{fleet.ring.assign(c.node_id)}")
            home[c.node_id] = reply["gateway"]
            if await c.node.connect_to_peer(reply["host"], reply["port"], timeout=10.0) \
                    != reply["gateway"]:
                raise PhaseFailed(f"fleet: {c.node_id} could not reach {reply['gateway']}")
        await fleet_until(lambda: all(c.peer_settings.get(home[c.node_id]) for c in clients),
                          "the settings gossip")
        out["clients_by_gateway"] = {g: sum(1 for h in home.values() if h == g)
                                     for g in sorted(fleet.members)}
        t0 = time.perf_counter()
        oks = await asyncio.gather(*(c.initiate_key_exchange(home[c.node_id]) for c in clients))
        wall = time.perf_counter() - t0
        bad = [c.node_id for c, ok in zip(clients, oks) if not ok]
        if bad:
            raise PhaseFailed(f"fleet: {len(bad)} handshakes failed, first {bad[:4]}")
        lat = [c._handshake_latency.last for c in clients]
        out["burst"] = {"clients": FLEET_CLIENTS, "wall_s": wall,
                        "handshakes_per_s": FLEET_CLIENTS / wall,
                        "latency_ms": {"p50": pct(lat, 50), "max": 1e3 * max(lat)},
                        "trips": sorted({c.metrics()["handshake_trips"]["last"]
                                         for c in clients})}
        print(f"[fleet] {FLEET_CLIENTS} clients at once (one engine's queues in this process) -> "
              f"{FLEET_GATEWAYS} gateway processes {out['clients_by_gateway']}: "
              f"{out['burst']['handshakes_per_s']:.1f} handshakes/s ({wall:.3f} s); latency ms "
              f"p50 {out['burst']['latency_ms']['p50']:.1f} max "
              f"{out['burst']['latency_ms']['max']:.1f}; trips {out['burst']['trips']}")

        expected = {g: 0 for g in fleet.members}

        async def message_round(label: str, group, route_of) -> float:
            t0 = time.perf_counter()
            sent = await asyncio.gather(*(c.send_message(route_of[c.node_id],
                                                         b"%s from %s" % (label.encode(),
                                                                          c.node_id.encode()))
                                          for c in group))
            if any(m is None for m in sent):
                raise PhaseFailed(f"fleet: a {label} message was not sent")
            for c in group:
                expected[route_of[c.node_id]] += 1
            await fleet_until(lambda: all(counts_of(g) >= n for g, n in expected.items()),
                              f"the {label} messages at the gateways",
                              detail=lambda: {g: (counts_of(g), n) for g, n in expected.items()})
            if any(counts_of(g) != n for g, n in expected.items()):
                raise PhaseFailed(f"fleet: the gateways opened "
                                  f"{ {g: counts_of(g) for g in expected} } messages, sent "
                                  f"{expected}")
            return time.perf_counter() - t0

        # two messages each, the second sent once every first one had arrived
        out["message_s"] = [await message_round("first", clients, home),
                            await message_round("second", clients, home)]
        print(f"[fleet] two messages a client, each round sent at once and opened by the "
              f"gateways before the next ({[round(x, 3) for x in out['message_s']]} s): every "
              f"key agrees, messages in order")

        # the seeded SIGKILL of a gateway holding sessions
        await fresh_heartbeats(list(fleet.members))
        before = {g: dict(m.stats) for g, m in fleet.members.items()}
        handshakes_before = {c.node_id: c._handshake_latency.count for c in clients}
        keys_before = {c.node_id: c.shared_keys[home[c.node_id]] for c in clients}
        victim = random.Random(FLEET_SEED).choice(sorted(set(home.values())))
        vm = fleet.members[victim]
        plan = faults.FaultPlan(FLEET_SEED, [faults.FaultRule(
            "process", "kill_gateway", match={"gateway": victim})])
        with plan.activate():
            await fleet_until(lambda: victim in killed_at, "the plan's kill")
        if plan.injected != [{"scope": "process", "action": "kill_gateway", "n": 1,
                              "gateway": victim}]:
            raise PhaseFailed(f"fleet: the plan injected {plan.injected}")
        limit = fleet.hb_miss_limit * fleet.hb_interval + FLEET_OPEN_MARGIN_S
        await fleet_until(lambda: vm.breaker.state != "closed", "the victim's breaker to open",
                          limit + 10.0)
        out["kill"] = {"gateway": victim, "pid": first_pids[victim],
                       "open_s": dead_at[victim] - killed_at[victim], "limit_s": limit}
        if out["kill"]["open_s"] > limit:
            raise PhaseFailed(f"fleet: the breaker opened {out['kill']['open_s']:.3f} s after "
                              f"the kill (limit {limit:.2f} s)")
        print(f"[fleet] seeded SIGKILL of {victim} (pid {first_pids[victim]}, "
              f"{out['clients_by_gateway'][victim]} sessions) through a FaultPlan process "
              f"rule: its fleet breaker opened {out['kill']['open_s']:.3f} s after the kill "
              f"(limit hb_miss_limit x hb_interval + {FLEET_OPEN_MARGIN_S} = {limit:.2f} s)")

        # its clients re-route with it excluded and resume on the ring successor
        moved = [c for c in clients if home[c.node_id] == victim]
        stayed = [c for c in clients if home[c.node_id] != victim]
        await fleet_until(lambda: not any(c.node.is_connected(victim) for c in moved),
                          "the victim's clients to see the drop")

        async def resume(c, exclude, expect, holder):
            reply = await control.route_query("127.0.0.1", fleet.ctrl_port, c.node_id,
                                              exclude=exclude)
            if reply.get("type") != control.ROUTE_OK or reply["gateway"] != expect:
                raise PhaseFailed(f"fleet: {c.node_id} was routed {reply}, expected {expect}")
            if await c.node.connect_to_peer(reply["host"], reply["port"], timeout=10.0) \
                    != expect:
                raise PhaseFailed(f"fleet: {c.node_id} could not reach {expect}")
            c.adopt_ticket(expect, c.take_ticket(holder))
            used = c._ctr_resumes_used.value
            t0 = time.perf_counter()
            if not await c.initiate_key_exchange(expect):
                raise PhaseFailed(f"fleet: {c.node_id} could not re-establish on {expect}")
            return time.perf_counter() - t0, c._ctr_resumes_used.value > used

        successor = {c.node_id: next(g for g in fleet.ring.successors(c.node_id) if g != victim)
                     for c in moved}
        resumed = await asyncio.gather(*(resume(c, [victim], successor[c.node_id], victim)
                                         for c in moved))
        rehandshakes = [c.node_id for c, (_, ok) in zip(moved, resumed) if not ok]
        resume_s = [dt for dt, ok in resumed if ok]
        out["resume"] = {"clients": len(moved), "resumed": len(resume_s),
                         "rehandshakes": rehandshakes,
                         "successors": sorted(set(successor.values())),
                         "p50_ms": round(pct(resume_s, 50), 3) if resume_s else None,
                         "max_ms": round(1e3 * max(resume_s), 3) if resume_s else None}
        print(f"[fleet] {len(moved)} clients of {victim} re-routed with it excluded to their "
              f"ring successors {out['resume']['successors']}: {len(resume_s)} resumed with "
              f"their tickets (p50 {out['resume']['p50_ms']} ms, max "
              f"{out['resume']['max_ms']} ms), {len(rehandshakes)} had to re-handshake "
              f"{rehandshakes}")
        if not moved:
            raise PhaseFailed(f"fleet: the victim {victim} held no session")
        live = [g for g in fleet.members if g != victim]
        await fresh_heartbeats(live)
        ops = {g: (before[g]["ops"], fleet.members[g].stats["ops"]) for g in live}
        if not rehandshakes and any(a != b for a, b in ops.values()):
            raise PhaseFailed(f"fleet: the resumes ran KEM or signature ops on the "
                              f"successors (before, after): {ops}")
        taken = {g: fleet.members[g].stats["resumes_ok"] - before[g]["resumes_ok"] for g in live}
        if sum(taken.values()) != len(resume_s):
            raise PhaseFailed(f"fleet: the successors accepted {taken} resumes for "
                              f"{len(resume_s)}")

        # one more message from every client: 0 lost established sessions
        route3 = {**home, **successor}
        out["message_s"].append(await message_round("third", clients, route3))
        changed = [c.node_id for c in stayed
                   if c._handshake_latency.count != handshakes_before[c.node_id]
                   or c.shared_keys.get(home[c.node_id]) != keys_before[c.node_id]]
        if changed:
            raise PhaseFailed(f"fleet: clients of the live gateways re-handshook: {changed}")
        out["lost_established_sessions"] = 0
        print(f"[fleet] every client sent one more message, which arrived "
              f"({out['message_s'][-1]:.3f} s): 0 lost established sessions; the "
              f"{len(stayed)} clients of the live gateways did not re-handshake; no KEM or "
              f"signature op on the successors during the resumes (ops {ops})")

        # the dead gateway comes back, re-registers, and its clients return
        free0 = device_free_bytes(backend)
        restart = await fleet.restart_member(victim)
        out["gateway_mib"]["restarted"] = mib_taken(free0, 1)
        if not restart["registered"]:
            raise PhaseFailed(f"fleet: {victim} did not re-register: {restart}; {logs()}")
        restart["register_s"] = round(registered[victim] - spawned[victim], 3)
        out["restart"] = restart
        expected[victim] = 0
        await fresh_heartbeats([victim])
        serving_base = {**base_launches, victim: dict(vm.stats["kernel_launches"])}
        back = await asyncio.gather(*(resume(c, [], victim, successor[c.node_id])
                                      for c in moved))
        out["restart"]["returned_resumed"] = sum(ok for _, ok in back)
        out["message_s"].append(await message_round("fourth", moved,
                                                    {c.node_id: victim for c in moved}))
        print(f"[fleet] restart_member({victim}): re-registered {restart['register_s']} s after "
              f"its spawn ({restart['took_s']} s in all, pid {vm.pid}); its {len(moved)} "
              f"clients routed back to it, {out['restart']['returned_resumed']} resumed with "
              f"their tickets, and each sent a message that arrived; its device memory, warm: "
              f"{out['gateway_mib']['restarted']} MiB")

        # stop: every gateway's bye and slo report
        await fleet.stop()
        stopped = True
        byes = {g: m.final_stats for g, m in fleet.members.items()}
        if any(b is None for b in byes.values()):
            raise PhaseFailed(f"fleet: no bye from {[g for g, b in byes.items() if b is None]}; "
                              f"logs: {logs()}")
        need = HANDSHAKE_KERNELS + ("chacha_blocks",)
        problems = {}
        for g, b in byes.items():
            idle = [n for n in need if not b["kernel_launches"].get(n)]
            served = {n: b["kernel_launches"][n] - serving_base[g][n] for n in need}
            # the gateways that ran full handshakes in this incarnation
            full = g != victim and out["clients_by_gateway"][g]
            idle_serving = [n for n in FLEET_SERVING_KERNELS if full and not served[n]]
            got = (b["device_served_fraction"], b["fallback_ops"], b["fallback_trips"],
                   b["breaker_state"])
            if got != (1.0, 0, 0, "closed") or not b["ops"] or idle or idle_serving:
                problems[g] = {"served_fraction, fallback ops, trips, breaker": got,
                               "ops": b["ops"], "never launched": idle,
                               "not launched serving": idle_serving}
        if problems:
            raise PhaseFailed(f"fleet: gateway byes {problems}")
        out["byes"] = {g: {k: b[k] for k in ("ops", "msgs_received", "resumes_ok",
                                             "tickets_minted", "device_served_fraction",
                                             "fallback_ops", "fallback_trips", "breaker_state",
                                             "kernel_launches")} for g, b in byes.items()}
        out["serving_launches"] = {g: {n: b["kernel_launches"][n] - serving_base[g][n]
                                       for n in need} for g, b in byes.items()}
        for g, b in sorted(out["byes"].items()):
            print(f"[fleet] {g} bye: ops {b['ops']}, messages {b['msgs_received']}, resumes "
                  f"{b['resumes_ok']}, device_served_fraction {b['device_served_fraction']}, "
                  f"fallback ops {b['fallback_ops']} trips {b['fallback_trips']}, breaker "
                  f"{b['breaker_state']}; launches in the process {b['kernel_launches']}; "
                  f"while serving {out['serving_launches'][g]}")
        reports = fleet.collect_reports()
        merged = slo.merge_reports(reports)
        if merged.get("nodes") != sorted(fleet.members):
            raise PhaseFailed(f"fleet: slo reports of {merged.get('nodes')}, gateways "
                              f"{sorted(fleet.members)}")
        out["slo_merged"] = {"nodes": merged["nodes"], "worst_node": merged.get("worst_node"),
                             "alerting": merged.get("alerting")}
        alive = sorted(p for p in pids if pid_alive(p))
        if alive:
            raise PhaseFailed(f"fleet: gateway processes still alive after stop(): {alive}")
        print(f"[fleet] stop(): {len(byes)} byes, slo reports of {merged['nodes']} merged "
              f"(worst node {merged.get('worst_node')}); no gateway pid of {sorted(pids)} alive")
        return out
    finally:
        for c in clients:
            c.close()
        for node in nodes:
            await node.stop()
        if proto is not None:
            proto.close()
        if not stopped:
            try:
                await asyncio.wait_for(fleet.stop(), 60.0)
            except Exception as exc:  # the kill below still runs
                print(f"[fleet] stop() after a failure raised {exc!r}", file=sys.stderr)
        for m in fleet.members.values():
            if m.proc is not None and m.proc.returncode is None:
                m.proc.kill()
                await m.proc.wait()
        for p in pids:
            if pid_alive(p):
                try:
                    os.kill(p, 9)
                except OSError:
                    pass
        shutil.rmtree(report_dir, ignore_errors=True)


def phase_fleet(provider, backend: str = "cuda") -> dict:
    """Phase 18: the port's gateway fleet on the card."""
    from quantum_resistant_p2p_tpu_torch import app, faults
    from quantum_resistant_p2p_tpu_torch import fleet as fleet_mod
    from quantum_resistant_p2p_tpu_torch.fleet import control
    from quantum_resistant_p2p_tpu_torch.net import p2p_node
    from quantum_resistant_p2p_tpu_torch.obs import slo

    t0 = time.perf_counter()
    out = asyncio.run(asyncio.wait_for(fleet_run(provider, app, p2p_node, fleet_mod, control,
                                                 faults, slo, backend),
                                       FLEET_PROCESS_TIMEOUT_S - 60.0))
    out["phase_s"] = time.perf_counter() - t0
    print(f"[fleet] phase took {out['phase_s']:.1f} s")
    return out


def fleet_child() -> int:
    """Phase 18 in a process of its own (``--fleet-phase``, started by
    phase_fleet_process); the gateways are its children, and its result,
    their bye counts included, is its last line of output."""
    sys.path.insert(0, str(ROOT))
    # the gateway processes run ``python -m quantum_resistant_p2p_tpu_torch...``
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    from quantum_resistant_p2p_tpu_torch import provider

    try:
        out = phase_fleet(provider)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"fleet_phase": out}, default=str))
    return 0


def phase_fleet_process() -> dict:
    """Phase 18 in a fresh process on the same card, as phase 16 runs; it
    starts the gateway processes.  The kernel libraries of phase 1 and the
    verdict cache (QRP2P_HEALTH_CACHE) are shared."""
    with tempfile.TemporaryDirectory(prefix="qrp2p-fleet-pids-") as tmp:
        pid_file = Path(tmp) / "pids"
        try:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                   "--fleet-phase"], capture_output=True, text=True,
                                  timeout=FLEET_PROCESS_TIMEOUT_S,
                                  env={**os.environ, FLEET_PID_FILE: str(pid_file)})
        except subprocess.TimeoutExpired as exc:
            raise PhaseFailed(f"fleet: the phase's process ran past {exc.timeout} s") from None
        finally:
            # the gateways run in sessions of their own: none outlives the phase
            for pid in (pid_file.read_text().split() if pid_file.exists() else ()):
                if pid_alive(int(pid)):
                    print(f"[fleet] killing gateway process {pid}, left by the phase",
                          file=sys.stderr)
                    try:
                        os.kill(int(pid), 9)
                    except OSError:
                        pass
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        print(line)
    if proc.returncode != 0 or not lines or not lines[-1].startswith('{"fleet_phase"'):
        raise PhaseFailed(f"fleet: the phase's process exited {proc.returncode}: "
                          f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1])["fleet_phase"]


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
        from quantum_resistant_p2p_tpu_torch import faults, provider
        from quantum_resistant_p2p_tpu_torch.core import (chacha, chacha_cuda, keccak, keccak_cuda,
                                                          sha256, sha256_cuda, sha512,
                                                          sha512_cuda)
        from quantum_resistant_p2p_tpu_torch.entry import entry
        from quantum_resistant_p2p_tpu_torch.core import aes
        from quantum_resistant_p2p_tpu_torch.kem import frodo, frodo_cuda, hqc, mlkem, mlkem_cuda
        from quantum_resistant_p2p_tpu_torch.obs import cost as obs_cost
        from quantum_resistant_p2p_tpu_torch.obs import trace as obs_trace
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

    wrappers = kernel_wrappers()
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
        rows = phase_kernels(torch, np, keccak, keccak_cuda, mlkem, mlkem_cuda, mldsa, mldsa_cuda,
                             chacha, chacha_cuda, frodo, frodo_cuda,
                             (sha256, sha256_cuda, sha512, sha512_cuda), int_rate)
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
        verdicts += phase_health_hqc(provider, health)

        def reset():
            for w in wrappers.values():
                w.launches = 0
            for name in SHA2_KERNELS:
                wrappers[name].split_launches = 0

        def read(phase, expected, few_row=(), counts=None):
            """The launch counts since reset() (or ``counts``, a phase's own
            process's), K12's and K13's few-row path apart
            ("<name>[few-row]"); each of ``expected`` must have run, and each
            of ``few_row`` through its few-row path."""
            if counts is None:
                counts = launch_counts(wrappers)
            print(f"[launches] {phase}: {counts}")
            idle = [name for name in expected if counts[name] == 0]
            idle += [f"{name}[few-row]" for name in few_row if counts[f"{name}[few-row]"] == 0]
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

        # phase "hqc": the vectors, HQC-128 served, then both published sets
        # at B = 1024
        hqc_inputs = {name: hqc_batch_inputs(torch, np, hqc, name) for name in HQC_BATCHES}
        hqc_kem = get_kem(HQC_SERVE)
        reset()
        t_hqc = time.perf_counter()
        phase_kat_hqc(torch, hqc, aes.SBOX)
        hqc_kat_s = time.perf_counter() - t_hqc
        hqc_served = asyncio.run(serve(BatchedKEM, hqc_kem, expect_cache=False))
        print_served("hqc serve", hqc_kem.name, hqc_served)
        hqc_batch, hqc_outputs = {}, {}
        for name, inputs in hqc_inputs.items():
            hqc_batch[name], hqc_outputs[name] = phase_hqc_batch(torch, np, hqc, keccak_cuda,
                                                                 inputs)
        hqc_batch["serve"] = hqc_served
        hqc_batch["phase_s"] = hqc_kat_s + time.perf_counter() - t_hqc
        launches["hqc"] = read("hqc", ("keccak_sponge",))
        print(f"[hqc] phase took {hqc_batch['phase_s']:.1f} s (the vectors {hqc_kat_s:.1f} s)")

        reset()
        slh_served, slh_signed = asyncio.run(sphincs_serve(torch, provider, sphincs,
                                                           slhdsa_params))
        launches["sphincs_serve"] = read("sphincs serve", ("sha256_compress",),
                                         ("sha256_compress",))
        slh_inputs = {name: sphincs_batch_inputs(torch, np, slhdsa_params, name, batch)
                      for name, batch in SLH_BATCHES}
        slh_batch, slh_outputs = {}, {}
        for name, inputs in slh_inputs.items():
            reset()
            slh_batch[name], slh_outputs[name] = phase_sphincs_batch(torch, sphincs, inputs)
            big = inputs[0].big_hash  # H and T_l on SHA-512
            launches[f"sphincs_batch_{name}"] = read(
                f"sphincs batch {name}",
                ("sha256_compress",) + (("sha512_compress",) if big else ()),
                ("sha512_compress",) if big else ("sha256_compress",))
        reset()
        slh_memory = phase_sphincs_memory(torch, np, provider, sphincs, slhdsa_params)
        launches["sphincs_memory"] = read("sphincs memory", ("sha256_compress",
                                                             "sha512_compress"))
        reset()
        observed = phase_obs_faults(np, provider, faults, obs_cost, obs_trace, kem, dsa, fused,
                                    aead, pk_off, ct_off, entry)
        launches["obs_faults"] = read("obs and faults", HANDSHAKE_KERNELS + ("chacha_blocks",))
        reset()
        carried = phase_transport(np, provider, faults, health, obs_cost, obs_trace, kem, dsa,
                                  fused, aead, pk_off, ct_off)
        launches["transport"] = read("transport", HANDSHAKE_KERNELS + ("chacha_blocks",))
        engined = phase_engine_process()
        launches["engine"] = read("engine", HANDSHAKE_KERNELS + ("chacha_blocks",),
                                  counts=engined.pop("launches"))
        # each swap's re-handshake, from set_key_exchange_algorithm until both
        # sides' keys agree, before any message: K1 and K9-K11 in the
        # FrodoKEM one, K1 launched by HQC's own SHAKE256 calls in the HQC
        # one (the handshake's ML-DSA-65 signatures launch K1 too)
        swap_launches = {}
        for swap_kem, need in zip(ENGINE_SWAP_KEMS, (FRODO_KERNELS, (HQC_OWN_K1,))):
            lo, hi = engined["swap_counts"][swap_kem]
            swapped = {name: hi[name] - lo[name] for name in lo}
            swap_launches[swap_kem] = swapped
            print(f"[launches] engine, the {swap_kem} swap's re-handshake: {swapped}")
            if not all(swapped[name] for name in need):
                raise PhaseFailed(f"engine: kernels not launched in the {swap_kem} re-handshake: "
                                  f"{[n for n in need if swapped[n] == 0]}")

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
        hp, hpk, hm, hsalt = hqc.PARAMS[HQC_SERVE], *hqc_outputs[HQC_SERVE]
        profiled["hqc_encaps"] = phase_profile(torch, "hqc_encaps",
                                               lambda: hqc.encaps(hp, hpk, hm, hsalt), 1)
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
        # phase 18: the launches are the gateways', read from their byes (each
        # process counts from 0); SHA-2 runs in no gateway
        fleeted = phase_fleet_process()
        gateway_counts = {name: sum(b["kernel_launches"][name] for b in fleeted["byes"].values())
                          for name in wrappers}
        gateway_counts.update({f"{name}[few-row]": 0 for name in SHA2_KERNELS})
        launches["fleet"] = read("fleet", HANDSHAKE_KERNELS + ("chacha_blocks",),
                                 counts=gateway_counts)
        lone = [b["handshakes_per_s"] for b in engined["bursts"]]
        print(f"[fleet] beside phase 16 in this run: {FLEET_CLIENTS} clients -> "
              f"{FLEET_GATEWAYS} gateway processes at {fleeted['burst']['handshakes_per_s']:.1f} "
              f"handshakes/s, {ENGINE_CLIENTS} clients -> one in-process gateway at "
              f"{[round(x, 1) for x in lone]} handshakes/s; a resume on the successor p50 "
              f"{fleeted['resume']['p50_ms']} ms max {fleeted['resume']['max_ms']} ms, phase "
              f"16's resume {1e3 * engined['resume_s']:.1f} ms")
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    # one entry per kernel wrapper at its main-path shapes; the sponge's
    # three calls (H, G, J) are summed, and K12's and K13's shapes with
    # their T_l (the rows path and the few-row path, each by the rule);
    # eta = 3, K8's 64 KiB shape, the forced paths and the edges stay in
    # the detail line
    kernels = []
    for name in wrappers:
        mine = [r for r in rows if r["name"] in (name, f"{name}[T_l]")]
        nbytes, ops = sum(r["bytes"] for r in mine), sum(r["int32_ops"] for r in mine)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / int_rate
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, "quantum_resistant_p2p_tpu_torch/csrc/mlkem.cu"),
            "replaces": mine[0]["replaces"],
            "launches": sum(counts[name] for counts in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine), "device_ms": sum(r["device_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fleet_launches": launches["fleet"][name],
            "library_ms": (None if any(r["library_ms"] is None for r in mine)
                           else sum(r["library_ms"] for r in mine)),
            "shapes": [r["shape"] for r in mine]})
        if name in SHA2_KERNELS:  # the __global__ kernels these shapes ran
            kernels[-1]["paths"] = sorted({SHA2_KERNELS[name][", split path" in r["shape"]]
                                           for r in mine})
            kernels[-1]["few_row_launches"] = sum(counts[f"{name}[few-row]"]
                                                  for counts in launches.values())
    print(json.dumps({"detail": {"ptxas": ptxas, "keccak_round_sass": sass,
                                 "kernel_rows": rows, "serve": served, "flagship": flagship,
                                 "sig_serve": sig_served, "sig_flagship": sig_flagship,
                                 "health": verdicts, "handshake": shaken, "data_plane": plane,
                                 "frodo_serve": frodo_served, "frodo_batch": frodo_batch,
                                 "hqc": hqc_batch,
                                 "sphincs_serve": slh_served, "sphincs_batch": slh_batch,
                                 "sphincs_memory": slh_memory, "obs_faults": observed,
                                 "transport": carried, "engine": engined, "fleet": fleeted,
                                 "launches": launches, "launches_per_op": per_op,
                                 "engine_swap_launches": swap_launches,
                                 "profile": profiled}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--engine-phase"]:
        sys.exit(engine_child())
    if sys.argv[1:] == ["--fleet-phase"]:
        sys.exit(fleet_child())
    # this run's health verdicts go to a fresh cache, so every gate of the
    # earlier phases probes the card (phase 15 checks the cache itself)
    with tempfile.TemporaryDirectory(prefix="qrp2p-health-") as _cache:
        os.environ["QRP2P_HEALTH_CACHE"] = _cache
        code = main()
    sys.exit(code)
