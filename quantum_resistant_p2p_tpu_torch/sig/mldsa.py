"""Batched ML-DSA (FIPS 204) in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/sig/mldsa.py``, function for
function and byte for byte.  Every function takes tensors with any leading
batch shape and runs where they lie.  Polynomials are ``(..., 256)`` int32
kept in [0, q), q = 8380417; a product of two coefficients needs 46 bits,
so products are taken in int64 and reduced.  Randomness (xi, rnd) and the
message digest mu are explicit inputs, the seam FIPS 204's internal
functions define for KATs.

The steps that were Pallas kernels on the TPU dispatch by device: a CPU
tensor takes the plain PyTorch version defined here (``*_plain``), any
other device goes to the CUDA kernel wrappers in ``sig/mldsa_cuda.py``,
which launch or raise:

====================  ============================  ===========================
module function       plain version                 kernel
====================  ============================  ===========================
``rej_ntt_poly``      ``rej_ntt_poly_plain``        K5 ``mldsa_cuda.rej_ntt``
``rej_bounded_poly``  ``rej_bounded_poly_plain``    K6 ``mldsa_cuda.rej_bounded``
``ntt``               ``ntt_plain``                 K7 ``mldsa_cuda.ntt``
``ntt_inv``           ``ntt_inv_plain``             K7 ``mldsa_cuda.ntt_inv``
====================  ============================  ===========================

Every hash goes through ``core.keccak.sponge`` (kernel K1 on the GPU).

The signing rejection loop runs every lane of a batch until all have
accepted, as the reference's ``lax.while_loop`` does: lanes that accepted
keep their first signature and counter while the others retry.  Here it is
a Python loop over tensors, and checking whether every lane is done costs
one device-to-host synchronisation per attempt.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core import keccak
from . import mldsa_cuda
from .params import (D, MLDSA44, MLDSA65, MLDSA87, N, N_INV, PARAMS,  # noqa: F401  (re-exported)
                     Q, ZETAS, MLDSAParams)

#: attempts of the rejection loop before a lane gives up (P < 1e-12 per
#: lane; a lane needs about 5 on average)
MAX_SIGN_ITERS = 128

#: Test/debug guard: raise if RejBoundedPoly's first 1024 nibbles held
#: fewer than 256 accepted ones, where the output follows the reference's
#: truncated-buffer convention instead of the spec's open-ended loop.  Read
#: at each call; costs a device-to-host copy when on.
STRICT_SAMPLERS = False


def _check_sampler_fill(ok: torch.Tensor, name: str) -> None:
    if not bool(ok.all()):
        raise AssertionError(
            f"{name}: fewer than {N} accepted candidates in the truncated "
            "sort buffer — output diverges from the pyref oracle convention"
        )


@functools.lru_cache(maxsize=None)
def _zetas(device: torch.device) -> torch.Tensor:
    """The zeta table as an int64 tensor, one copy per device."""
    return torch.tensor(ZETAS, dtype=torch.int64, device=device)


# --------------------------------------------------------------------------
# Modular arithmetic
# --------------------------------------------------------------------------


def pw_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod q for int32 a, b in [0, q), broadcast; int32 out."""
    return (a.to(torch.int64) * b % Q).to(torch.int32)


def _center(x: torch.Tensor, m: int = Q) -> torch.Tensor:
    """mod± representative in (-m/2, m/2]."""
    x = x % m
    return torch.where(x > m // 2, x - m, x)


# --------------------------------------------------------------------------
# NTT over Z_q[X]/(X^256+1) (FIPS 204 §7.5): 8 layers, 128 butterflies each
# --------------------------------------------------------------------------


def ntt_plain(f: torch.Tensor) -> torch.Tensor:
    """(..., 256) int32 in [0, q) -> NTT domain; all 128 butterflies of a
    layer at once, in int64."""
    zetas = _zetas(f.device)
    shape = f.shape
    f = f.to(torch.int64)
    k, length = 1, 128
    while length >= 1:
        groups = N // (2 * length)
        fr = f.reshape(shape[:-1] + (groups, 2, length))
        f0, f1 = fr[..., 0, :], fr[..., 1, :]
        t = zetas[k : k + groups, None] * f1 % Q
        f = torch.stack([(f0 + t) % Q, (f0 - t) % Q], dim=-2).reshape(shape)
        k += groups
        length //= 2
    return f.to(torch.int32)


def ntt_inv_plain(f: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ntt_plain`, scaled by 256^-1 mod q."""
    zetas = _zetas(f.device)
    shape = f.shape
    f = f.to(torch.int64)
    k, length = 255, 1
    while length <= 128:
        groups = N // (2 * length)
        z = zetas[k - groups + 1 : k + 1].flip(0)
        fr = f.reshape(shape[:-1] + (groups, 2, length))
        f0, f1 = fr[..., 0, :], fr[..., 1, :]
        s = (f0 + f1) % Q
        t = z[:, None] * ((f1 - f0) % Q) % Q
        f = torch.stack([s, t], dim=-2).reshape(shape)
        k -= groups
        length *= 2
    return (f * N_INV % Q).to(torch.int32)


def ntt(f: torch.Tensor) -> torch.Tensor:
    """Forward NTT: plain on the CPU, kernel K7 on the GPU."""
    if f.device.type == "cpu":
        return ntt_plain(f)
    return mldsa_cuda.ntt(f)


def ntt_inv(f: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (scaled by 256^-1): plain on the CPU, K7 on the GPU."""
    if f.device.type == "cpu":
        return ntt_inv_plain(f)
    return mldsa_cuda.ntt_inv(f)


# --------------------------------------------------------------------------
# Bit packing (FIPS 204 §7.1)
# --------------------------------------------------------------------------


def simple_bit_pack(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., 256) int32 in [0, 2^bits) -> (..., 32*bits) uint8, LSB-first.

    The bitstream repeats every lcm(bits, 8) bits (``pc`` coefficients fill
    ``pb`` bytes), so each output byte is a fixed shift/or of at most a few
    coefficients."""
    period = math.lcm(bits, 8)
    pb, pc = period // 8, period // bits
    g = vals.reshape(vals.shape[:-1] + (N // pc, pc))
    outs = []
    for j in range(pb):
        lo = 8 * j
        acc = None
        for c in range(pc):
            s = c * bits
            if s + bits <= lo or s >= lo + 8:
                continue
            sh = lo - s
            contrib = (g[..., c] >> sh) if sh >= 0 else (g[..., c] << (-sh))
            acc = contrib if acc is None else (acc | contrib)
        outs.append(acc & 0xFF)
    b = torch.stack(outs, dim=-1)  # (..., 256/pc, pb)
    return b.reshape(vals.shape[:-1] + (32 * bits,)).to(torch.uint8)


def simple_bit_unpack(b: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., 32*bits) uint8 -> (..., 256) int32, the inverse of the pack."""
    period = math.lcm(bits, 8)
    pb, pc = period // 8, period // bits
    g = b.reshape(b.shape[:-1] + (N // pc, pb)).to(torch.int32)
    outs = []
    for c in range(pc):
        s = c * bits
        acc = None
        for j in range(pb):
            lo = 8 * j
            if lo + 8 <= s or lo >= s + bits:
                continue
            sh = lo - s
            contrib = (g[..., j] << sh) if sh >= 0 else (g[..., j] >> (-sh))
            acc = contrib if acc is None else (acc | contrib)
        outs.append(acc & ((1 << bits) - 1))
    x = torch.stack(outs, dim=-1)  # (..., 256/pc, pc)
    return x.reshape(b.shape[:-1] + (N,))


def bit_pack(vals: torch.Tensor, up: int, bits: int) -> torch.Tensor:
    return simple_bit_pack(up - _center(vals), bits)


def bit_unpack(b: torch.Tensor, up: int, bits: int) -> torch.Tensor:
    return (up - simple_bit_unpack(b, bits)) % Q


# --------------------------------------------------------------------------
# Rounding (FIPS 204 §7.4)
# --------------------------------------------------------------------------


def power2round(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r = r % Q
    r0 = _center(r, 1 << D)
    return (r - r0) >> D, r0


def decompose(p: MLDSAParams, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    alpha = 2 * p.gamma2
    r = r % Q
    r0 = _center(r, alpha)
    wrap = (r - r0) == (Q - 1)
    r1 = torch.where(wrap, 0, (r - r0) // alpha)
    r0 = torch.where(wrap, r0 - 1, r0)
    return r1, r0


def use_hint(p: MLDSAParams, h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    m = (Q - 1) // (2 * p.gamma2)
    r1, r0 = decompose(p, r)
    up = torch.where(r0 > 0, (r1 + 1) % m, (r1 - 1) % m)
    return torch.where(h != 0, up, r1)


# --------------------------------------------------------------------------
# Samplers (FIPS 204 §7.3), over a fixed squeeze as the reference takes it
# --------------------------------------------------------------------------

_REJ_NTT_BYTES = 168 * 7  # 392 candidates for 256 slots
_REJ_BOUNDED_BYTES = 512  # the first 1024 nibbles: what the reference sorts


def rej_ntt_from_bytes(buf: torch.Tensor) -> torch.Tensor:
    """(..., 1176) uint8 SHAKE-128 output -> (..., 256) int32: the 23-bit
    candidates b0 | b1 << 8 | (b2 & 0x7F) << 16 below q, in order; a short
    fill leaves the rejected candidates (values >= q) in the tail."""
    t = buf.to(torch.int32).reshape(buf.shape[:-1] + (-1, 3))
    cand = t[..., 0] | (t[..., 1] << 8) | ((t[..., 2] & 0x7F) << 16)
    return keccak.compact_accepted(cand, cand < Q)


def rej_ntt_poly_plain(seeds: torch.Tensor) -> torch.Tensor:
    """(..., 34) uint8 seeds rho || s || r -> (..., 256) int32 NTT-domain."""
    return rej_ntt_from_bytes(keccak.sponge_plain(seeds, 168, 0x1F, _REJ_NTT_BYTES))


def rej_ntt_poly(seeds: torch.Tensor) -> torch.Tensor:
    """RejNTTPoly: plain on the CPU, kernel K5 on the GPU."""
    if seeds.device.type == "cpu":
        return rej_ntt_poly_plain(seeds)
    return mldsa_cuda.rej_ntt(seeds)


def _nibble_bound(eta: int) -> int:
    if eta not in (2, 4):
        raise ValueError(f"eta must be 2 or 4, got {eta}")
    return 15 if eta == 2 else 9


def rej_bounded_from_bytes(buf: torch.Tensor, eta: int) -> torch.Tensor:
    """(..., 512) uint8 SHAKE-256 output -> (..., 256) int32 raw nibbles
    (low nibble of each byte first) below the bound, in order; a short fill
    leaves the rejected nibbles in the tail."""
    b = buf.to(torch.int32)
    z = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(buf.shape[:-1] + (-1,))
    return keccak.compact_accepted(z, z < _nibble_bound(eta))


def rej_bounded_poly_plain(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    """(..., 66) uint8 seeds rho' || n -> (..., 256) raw accepted nibbles."""
    buf = keccak.sponge_plain(seeds, 136, 0x1F, _REJ_BOUNDED_BYTES)
    return rej_bounded_from_bytes(buf, eta)


def rej_bounded_poly(eta: int, seeds: torch.Tensor) -> torch.Tensor:
    """RejBoundedPoly: (..., 66) uint8 -> (..., 256) int32 in
    {q-eta .. q+eta} mod q.  The raw nibbles come from the plain version on
    the CPU and kernel K6 on the GPU; the eta map is applied here."""
    if seeds.device.type == "cpu":
        z = rej_bounded_poly_plain(seeds, eta)
    else:
        z = mldsa_cuda.rej_bounded(seeds, eta)
    if STRICT_SAMPLERS:
        # slot N-1 must still hold an accepted nibble
        _check_sampler_fill(z[..., N - 1] < _nibble_bound(eta), "rej_bounded_poly")
    if eta == 2:
        return (2 - z % 5) % Q
    return (4 - z) % Q


def expand_a(p: MLDSAParams, rho: torch.Tensor) -> torch.Tensor:
    """rho (..., 32) -> A_hat (..., k, l, 256); A[r, s] = RejNTTPoly(rho||s||r)."""
    sr = torch.tensor([[s, r] for r in range(p.k) for s in range(p.l)], dtype=torch.uint8,
                      device=rho.device)
    rows = rho.shape[:-1] + (p.k * p.l,)
    seeds = torch.cat([rho[..., None, :].expand(rows + (32,)), sr.expand(rows + (2,))], dim=-1)
    return rej_ntt_poly(seeds).reshape(rho.shape[:-1] + (p.k, p.l, N))


def expand_s(p: MLDSAParams, rhop: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """rhop (..., 64) -> s1 (..., l, 256), s2 (..., k, 256)."""
    total = p.l + p.k
    n16 = torch.zeros((total, 2), dtype=torch.uint8, device=rhop.device)
    n16[:, 0] = torch.arange(total, device=rhop.device) & 0xFF
    rows = rhop.shape[:-1] + (total,)
    seeds = torch.cat([rhop[..., None, :].expand(rows + (64,)), n16.expand(rows + (2,))],
                      dim=-1)
    s = rej_bounded_poly(p.eta, seeds)
    return s[..., : p.l, :], s[..., p.l :, :]


def expand_mask(p: MLDSAParams, rhopp: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
    """rhopp (..., 64), kappa (...,) int32 -> y (..., l, 256): mask l from
    SHAKE-256(rho'' || kappa + r as 2 bytes LE)."""
    kr = kappa[..., None] + torch.arange(p.l, dtype=torch.int32, device=rhopp.device)
    suffix = torch.stack([kr & 0xFF, (kr >> 8) & 0xFF], dim=-1).to(torch.uint8)
    rep = rhopp[..., None, :].expand(rhopp.shape[:-1] + (p.l, 64))
    buf = keccak.shake256(torch.cat([rep, suffix], dim=-1), 32 * p.z_bits)
    return bit_unpack(buf, p.gamma1, p.z_bits)


_BALL_BYTES = 8 + 1024  # fixed SHAKE squeeze, the reference's convention


def sample_in_ball(p: MLDSAParams, ctilde: torch.Tensor) -> torch.Tensor:
    """(..., lambda/4) uint8 -> (..., 256) int32 with tau coefficients ±1.

    The spec's Fisher-Yates over a fixed 1024-byte buffer: at swap s the
    insertion index is i = 256 - tau + s, the source j is the first byte
    after the previous one that is <= i, c[i] = c[j] and c[j] = ±1 by sign
    bit s.  One step per swap (tau steps), each a search over the buffer;
    a lane that runs out of bytes stops swapping, as the reference does."""
    buf = keccak.shake256(ctilde, _BALL_BYTES)
    signs = buf[..., :8].to(torch.int32)
    rejb = buf[..., 8:].to(torch.int32)
    dev = ctilde.device
    batch = ctilde.shape[:-1]
    tau = p.tau
    at_b = torch.arange(rejb.shape[-1], device=dev)
    at_c = torch.arange(N, device=dev)
    c = torch.zeros(batch + (N,), dtype=torch.int32, device=dev)
    prev = torch.full(batch, -1, dtype=torch.int64, device=dev)
    alive = torch.ones(batch, dtype=torch.bool, device=dev)
    for s in range(tau):
        i = N - tau + s
        cand = (rejb <= i) & (at_b > prev[..., None])
        alive = alive & cand.any(dim=-1)
        pos = cand.to(torch.int8).argmax(dim=-1)  # the first candidate byte
        prev = torch.where(alive, pos, prev)
        j = rejb.gather(-1, pos[..., None])
        sign_val = 1 + ((signs[..., s // 8] >> (s % 8)) & 1) * (Q - 2)  # +1 or -1 mod q
        c[..., i] = torch.where(alive, c.gather(-1, j.to(torch.int64))[..., 0], c[..., i])
        c = torch.where((at_c == j) & alive[..., None], sign_val[..., None], c)
    return c


# --------------------------------------------------------------------------
# Hint packing (FIPS 204 §7.1 HintBitPack / HintBitUnpack)
# --------------------------------------------------------------------------


def hint_bit_pack(p: MLDSAParams, h: torch.Tensor) -> torch.Tensor:
    """h (..., k, 256) in {0, 1} -> (..., omega + k) uint8.

    Each set bit's output byte is its rank among the set bits of its row
    plus the earlier rows' total; the positions are scattered there (a set
    bit ranked at omega or beyond has no byte and is dropped)."""
    h = h.to(torch.int32)
    batch = h.shape[:-2]
    counts = h.sum(dim=-1, dtype=torch.int32)
    ends = counts.cumsum(dim=-1, dtype=torch.int32)
    dest = (ends - counts)[..., None] + h.cumsum(dim=-1, dtype=torch.int32) - h
    keep = (h == 1) & (dest < p.omega)
    pos = torch.arange(N, dtype=torch.int32, device=h.device).expand(h.shape)
    idx = torch.where(keep, dest, p.omega).reshape(batch + (-1,)).to(torch.int64)
    src = torch.where(keep, pos, 0).reshape(batch + (-1,))
    packed = torch.zeros(batch + (p.omega + 1,), dtype=torch.int32, device=h.device)
    packed = packed.scatter_add_(-1, idx, src)[..., : p.omega]  # the last column drops
    return torch.cat([packed, ends], dim=-1).to(torch.uint8)


def hint_bit_unpack(p: MLDSAParams, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., omega + k) uint8 -> (h (..., k, 256) int32, ok (...,) bool)."""
    pos = b[..., : p.omega].to(torch.int32)
    ends = b[..., p.omega :].to(torch.int32)
    starts = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], dim=-1)
    ok = (ends >= starts).all(dim=-1) & (ends <= p.omega).all(dim=-1)
    widx = torch.arange(p.omega, device=b.device)
    in_row = (widx >= starts[..., None]) & (widx < ends[..., None])  # (..., k, omega)
    # strictly increasing within each row
    prev_same_row = in_row & (widx > starts[..., None])
    inc_ok = torch.where(prev_same_row,
                         pos[..., None, :] > torch.roll(pos, 1, dims=-1)[..., None, :], True)
    ok = ok & inc_ok.all(dim=-1).all(dim=-1)
    total = ends[..., -1]
    ok = ok & torch.where(widx >= total[..., None], pos == 0, True).all(dim=-1)
    # h[r, pos[w]] = 1 for w in [starts[r], ends[r]); other slots hit the
    # dropped last column
    h = torch.zeros(b.shape[:-1] + (p.k, N + 1), dtype=torch.int32, device=b.device)
    dest = torch.where(in_row, pos[..., None, :], N).to(torch.int64)
    h.scatter_(-1, dest, in_row.to(torch.int32))
    return h[..., :N], ok


# --------------------------------------------------------------------------
# KeyGen (FIPS 204 Algorithm 6)
# --------------------------------------------------------------------------


def _matvec(a_hat: torch.Tensor, v_hat: torch.Tensor) -> torch.Tensor:
    """(..., k, l, 256) ∘ (..., l, 256) -> (..., k, 256) pointwise-NTT matvec."""
    return pw_mul(a_hat, v_hat[..., None, :, :]).sum(dim=-2, dtype=torch.int32) % Q


def keygen(p: MLDSAParams, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ML-DSA.KeyGen_internal: xi (..., 32) uint8 -> (pk (..., pk_len),
    sk (..., sk_len)) uint8."""
    batch = xi.shape[:-1]
    kl = torch.tensor([p.k, p.l], dtype=torch.uint8, device=xi.device).expand(batch + (2,))
    seed = keccak.shake256(torch.cat([xi, kl], dim=-1), 128)
    rho, rhop, cap_k = seed[..., :32], seed[..., 32:96], seed[..., 96:]
    a_hat = expand_a(p, rho)
    s1, s2 = expand_s(p, rhop)
    t = (ntt_inv(_matvec(a_hat, ntt(s1))) + s2) % Q
    t1, t0 = power2round(t)
    pk = torch.cat([rho, simple_bit_pack(t1, 23 - D).reshape(batch + (-1,))], dim=-1)
    tr = keccak.shake256(pk, 64)
    sk = torch.cat([
        rho, cap_k, tr,
        bit_pack(s1, p.eta, p.s_bits).reshape(batch + (-1,)),
        bit_pack(s2, p.eta, p.s_bits).reshape(batch + (-1,)),
        bit_pack(t0, 1 << (D - 1), D).reshape(batch + (-1,)),
    ], dim=-1)
    return pk, sk


# --------------------------------------------------------------------------
# Sign (FIPS 204 Algorithm 7), batched with a masked retry loop
# --------------------------------------------------------------------------


def _unpack_sk(p: MLDSAParams, sk: torch.Tensor):
    batch = sk.shape[:-1]
    rho, cap_k, tr = sk[..., :32], sk[..., 32:64], sk[..., 64:128]
    off = 128
    sb = 32 * p.s_bits
    s1 = bit_unpack(sk[..., off : off + p.l * sb].reshape(batch + (p.l, sb)), p.eta, p.s_bits)
    off += p.l * sb
    s2 = bit_unpack(sk[..., off : off + p.k * sb].reshape(batch + (p.k, sb)), p.eta, p.s_bits)
    off += p.k * sb
    tb = 32 * D
    t0 = bit_unpack(sk[..., off : off + p.k * tb].reshape(batch + (p.k, tb)), 1 << (D - 1), D)
    return rho, cap_k, tr, s1, s2, t0


def _inf_norm(x: torch.Tensor) -> torch.Tensor:
    """max |x mod± q| over the last two axes."""
    return _center(x).abs().amax(dim=(-1, -2))


def precompute_sk(p: MLDSAParams, sk: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-key state the sign loop reuses: K, ExpandA(rho) and the NTTs of
    s1, s2, t0.  May be unbatched (one key) and broadcasts against any
    batch of (mu, rnd).  Owns its memory (K is copied out of ``sk``), so
    the caller may wipe ``sk`` while the state stays cached."""
    rho, cap_k, _tr, s1, s2, t0 = _unpack_sk(p, sk)
    return {"cap_k": cap_k.clone(), "a_hat": expand_a(p, rho), "s1_hat": ntt(s1),
            "s2_hat": ntt(s2), "t0_hat": ntt(t0)}


def precompute_from_numpy(pre: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The reference's ``precompute_sk`` / ``precompute_pk`` dict (numpy:
    ``cap_k`` uint8, every polynomial array int32, unbatched or batched) as
    the port's, on ``device``."""
    return {name: torch.tensor(np.asarray(a), device=device,
                               dtype=torch.uint8 if name == "cap_k" else torch.int32)
            for name, a in pre.items()}


def sign_mu_rounds(p: MLDSAParams, sk: torch.Tensor, mu: torch.Tensor, rnd: torch.Tensor,
                   kappa0, n_iters: int):
    """At most ``n_iters`` rejection-loop attempts from per-lane ``kappa0``
    -> (sigma, done, kappa).  Each lane's kappa sequence depends only on its
    own rho'' and counter, so a caller may resume unfinished lanes from the
    returned kappa with identical results."""
    return _sign_mu_core(p, precompute_sk(p, sk), mu, rnd, kappa0, n_iters)


def _sign_attempt(p: MLDSAParams, pre: dict[str, torch.Tensor], mu: torch.Tensor,
                  rhopp: torch.Tensor, kappa: torch.Tensor):
    """One rejection-loop attempt for every lane -> (ok, sigma)."""
    batch = mu.shape[:-1]
    y = expand_mask(p, rhopp, kappa)
    w = ntt_inv(_matvec(pre["a_hat"], ntt(y)))
    w1, _ = decompose(p, w)
    w1_enc = simple_bit_pack(w1, p.w1_bits).reshape(batch + (-1,))
    ctilde = keccak.shake256(torch.cat([mu, w1_enc], dim=-1), p.ctilde_len)
    c_hat = ntt(sample_in_ball(p, ctilde))[..., None, :]
    z = (y + ntt_inv(pw_mul(c_hat, pre["s1_hat"]))) % Q
    ok = _inf_norm(z) < p.gamma1 - p.beta
    r_minus = (w - ntt_inv(pw_mul(c_hat, pre["s2_hat"]))) % Q
    hi_base, r0 = decompose(p, r_minus)
    ok &= r0.abs().amax(dim=(-1, -2)) < p.gamma2 - p.beta
    ct0 = ntt_inv(pw_mul(c_hat, pre["t0_hat"]))
    ok &= _inf_norm(ct0) < p.gamma2
    hi_with = decompose(p, (_center(r_minus) + _center(ct0)) % Q)[0]
    h = (hi_with != hi_base).to(torch.int32)
    ok &= h.sum(dim=(-1, -2)) <= p.omega
    sigma = torch.cat([ctilde, bit_pack(z, p.gamma1, p.z_bits).reshape(batch + (-1,)),
                       hint_bit_pack(p, h)], dim=-1)
    return ok, sigma


def _sign_mu_core(p: MLDSAParams, pre: dict[str, torch.Tensor], mu: torch.Tensor,
                  rnd: torch.Tensor, kappa0, n_iters: int):
    """Rejection loop over precomputed key state (see ``precompute_sk``):
    attempts run while some lane is not done and fewer than ``n_iters``
    have run; a lane keeps its first accepted signature, and its kappa
    advances by l only while it is not done."""
    batch = mu.shape[:-1]
    cap_k = pre["cap_k"].expand(batch + (32,))
    rhopp = keccak.shake256(torch.cat([cap_k, rnd, mu], dim=-1), 64)
    done = torch.zeros(batch, dtype=torch.bool, device=mu.device)
    kappa = torch.as_tensor(kappa0, dtype=torch.int32, device=mu.device).expand(batch)
    sig = torch.zeros(batch + (p.sig_len,), dtype=torch.uint8, device=mu.device)
    for _ in range(n_iters):
        if bool(done.all()):  # one device-to-host sync per attempt
            break
        ok, sigma = _sign_attempt(p, pre, mu, rhopp, kappa)
        sig = torch.where(((~done) & ok)[..., None], sigma, sig)
        kappa = torch.where(done | ok, kappa, kappa + p.l)
        done = done | ok
    return sig, done, kappa


def sign_mu(p: MLDSAParams, sk: torch.Tensor, mu: torch.Tensor, rnd: torch.Tensor):
    """Core of Algorithm 7 given mu = SHAKE256(tr || M', 64).

    sk (..., sk_len), mu (..., 64), rnd (..., 32) ->
    (sigma (..., sig_len), done (...,) bool).  ``done`` is False for a lane
    that exhausted MAX_SIGN_ITERS attempts; its sigma is all zeros and must
    not be emitted (the provider raises)."""
    sig, done, _ = sign_mu_rounds(p, sk, mu, rnd, 0, MAX_SIGN_ITERS)
    return sig, done


def sign_mu_pre(p: MLDSAParams, pre: dict[str, torch.Tensor], mu: torch.Tensor,
                rnd: torch.Tensor):
    """``sign_mu`` over a ``precompute_sk`` dict: bit-identical output."""
    sig, done, _ = _sign_mu_core(p, pre, mu, rnd, 0, MAX_SIGN_ITERS)
    return sig, done


# --------------------------------------------------------------------------
# Verify (FIPS 204 Algorithm 8)
# --------------------------------------------------------------------------


def precompute_pk(p: MLDSAParams, pk: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-key state verify reuses: ExpandA(rho) and NTT(t1 << d).  May be
    unbatched and broadcasts against any (mu, sigma) batch."""
    rho = pk[..., :32]
    t1 = simple_bit_unpack(pk[..., 32:].reshape(pk.shape[:-1] + (p.k, 32 * (23 - D))), 23 - D)
    return {"a_hat": expand_a(p, rho), "t1_hat": ntt((t1 << D) % Q)}


def verify_mu(p: MLDSAParams, pk: torch.Tensor, mu: torch.Tensor,
              sigma: torch.Tensor) -> torch.Tensor:
    """Core of Algorithm 8 given mu. pk (..., pk_len), mu (..., 64),
    sigma (..., sig_len) -> bool (...,)."""
    return verify_mu_pre(p, precompute_pk(p, pk), mu, sigma)


def verify_mu_pre(p: MLDSAParams, pre: dict[str, torch.Tensor], mu: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
    """``verify_mu`` over a ``precompute_pk`` dict (bit-identical)."""
    batch = mu.shape[:-1]
    ctilde = sigma[..., : p.ctilde_len]
    zb = 32 * p.z_bits
    off = p.ctilde_len
    z = bit_unpack(sigma[..., off : off + p.l * zb].reshape(batch + (p.l, zb)),
                   p.gamma1, p.z_bits)
    h, ok = hint_bit_unpack(p, sigma[..., off + p.l * zb :])
    ok = ok & (_inf_norm(z) < p.gamma1 - p.beta)
    c_hat = ntt(sample_in_ball(p, ctilde))
    az = _matvec(pre["a_hat"], ntt(z))
    ct1 = pw_mul(c_hat[..., None, :], pre["t1_hat"])
    w1 = use_hint(p, h, ntt_inv((az - ct1) % Q))
    w1_enc = simple_bit_pack(w1, p.w1_bits).reshape(batch + (-1,))
    ctilde2 = keccak.shake256(torch.cat([mu, w1_enc], dim=-1), p.ctilde_len)
    return ok & (ctilde == ctilde2).all(dim=-1)


# --------------------------------------------------------------------------
# Per-parameter-set entry points
# --------------------------------------------------------------------------


@functools.cache
def get(name: str):
    """(keygen, sign_mu, verify_mu) for a parameter-set name."""
    p = PARAMS[name]
    return (functools.partial(keygen, p), functools.partial(sign_mu, p),
            functools.partial(verify_mu, p))


def sign_mu_cold(p: MLDSAParams, sk: torch.Tensor, mu: torch.Tensor, rnd: torch.Tensor):
    """Cache-filling sign: the per-key state and the signatures at once."""
    pre = precompute_sk(p, sk)
    sig, done = sign_mu_pre(p, pre, mu, rnd)
    return pre, sig, done


def verify_mu_cold(p: MLDSAParams, pk: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor):
    """Cache-filling verify (see ``sign_mu_cold``)."""
    pre = precompute_pk(p, pk)
    return pre, verify_mu_pre(p, pre, mu, sigma)


@functools.cache
def get_pre(name: str):
    """(sign_mu_cold, sign_mu_pre, verify_mu_cold, verify_mu_pre) for the
    operand cache (provider/opcache.py)."""
    p = PARAMS[name]
    return (functools.partial(sign_mu_cold, p), functools.partial(sign_mu_pre, p),
            functools.partial(verify_mu_cold, p), functools.partial(verify_mu_pre, p))
