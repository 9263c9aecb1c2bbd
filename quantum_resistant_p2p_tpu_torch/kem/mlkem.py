"""Batched ML-KEM (FIPS 203) in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/kem/mlkem.py``, function for
function and byte for byte.  Every function takes tensors with any leading
batch shape and runs where they lie.  Polynomials are ``(..., 256)`` int32
kept in [0, q), q = 3329, so every product fits in int32.  Randomness
(d, z, m) is an explicit input, the seam FIPS 203 defines for KATs.

The five sampling and transform steps that were Pallas kernels on the TPU
dispatch by device: a CPU tensor takes the plain PyTorch version defined
here (``*_plain``), any other device goes to the CUDA kernel wrappers in
``kem/mlkem_cuda.py``, which launch or raise:

=====================  =================  ================================
module function        plain version      kernel
=====================  =================  ================================
``sample_ntt``         ``sample_ntt_plain``   K2 ``mlkem_cuda.sample_ntt``
``prf_cbd``            ``prf_cbd_plain``      K3 ``mlkem_cuda.prf_cbd``
``prf_cbd_ntt``        ``prf_cbd_ntt_plain``  K3 ``mlkem_cuda.prf_cbd_ntt``
``ntt``                ``ntt_plain``          K4 ``mlkem_cuda.ntt``
``ntt_inv``            ``ntt_inv_plain``      K4 ``mlkem_cuda.ntt_inv``
=====================  =================  ================================

Every hash goes through ``core.keccak.sponge`` (kernel K1 on the GPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import keccak
from . import mlkem_cuda
from .params import (GAMMAS, MLKEM512, MLKEM768, MLKEM1024,  # noqa: F401  (re-exported)
                     N, N_INV, PARAMS, Q, ZETAS, MLKEMParams)


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """The zeta or gamma table as an int32 tensor, one copy per device."""
    return torch.tensor(ZETAS if name == "zetas" else GAMMAS, dtype=torch.int32,
                        device=device)


# --------------------------------------------------------------------------
# Byte codecs (FIPS 203 ByteEncode_d / ByteDecode_d)
# --------------------------------------------------------------------------


def byte_decode(b: torch.Tensor, d: int) -> torch.Tensor:
    """(..., 32*d) uint8 -> (..., 256) int32 (mod q when d == 12)."""
    if d != 12:
        shifts = torch.arange(8, dtype=torch.int32, device=b.device)
        bits = (b[..., :, None].to(torch.int32) >> shifts) & 1
        bits = bits.reshape(b.shape[:-1] + (N, d))
        weights = torch.arange(d, dtype=torch.int32, device=b.device)
        return (bits << weights).sum(dim=-1, dtype=torch.int32)
    t = b.to(torch.int32).reshape(b.shape[:-1] + (N // 2, 3))
    lo = t[..., 0] | ((t[..., 1] & 0xF) << 8)
    hi = (t[..., 1] >> 4) | (t[..., 2] << 4)
    return torch.stack([lo, hi], dim=-1).reshape(b.shape[:-1] + (N,)) % Q


def byte_encode(vals: torch.Tensor, d: int) -> torch.Tensor:
    """(..., 256) int32 -> (..., 32*d) uint8, the inverse of byte_decode."""
    if d != 12:
        shifts = torch.arange(d, dtype=torch.int32, device=vals.device)
        bits = (vals[..., :, None] >> shifts) & 1
        bits = bits.reshape(vals.shape[:-1] + (32 * d, 8))
        weights = torch.arange(8, dtype=torch.int32, device=vals.device)
        return (bits << weights).sum(dim=-1, dtype=torch.int32).to(torch.uint8)
    v = vals.reshape(vals.shape[:-1] + (N // 2, 2))
    # mask to 12 bits so a non-canonical input cannot spill into its neighbour
    lo, hi = v[..., 0] & 0xFFF, v[..., 1] & 0xFFF
    out = torch.stack([lo & 0xFF, (lo >> 8) | ((hi & 0xF) << 4), hi >> 4], dim=-1)
    return out.reshape(vals.shape[:-1] + (384,)).to(torch.uint8)


def compress(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << (d + 1)) + Q) // (2 * Q) % (1 << d)


def decompress(y: torch.Tensor, d: int) -> torch.Tensor:
    return (y * Q + (1 << (d - 1))) >> d


# --------------------------------------------------------------------------
# NTT over Z_q[X]/(X^256+1) (FIPS 203 §4.3)
# --------------------------------------------------------------------------


def ntt_plain(f: torch.Tensor) -> torch.Tensor:
    """(..., 256) int32 in [0, q) -> NTT domain; all 128 butterflies of a
    layer at once."""
    zetas = _table("zetas", f.device)
    k, length = 1, 128
    while length >= 2:
        groups = N // (2 * length)
        z = zetas[k : k + groups]
        fr = f.reshape(f.shape[:-1] + (groups, 2, length))
        f0, f1 = fr[..., 0, :], fr[..., 1, :]
        t = (z[:, None] * f1) % Q
        f = torch.stack([(f0 + t) % Q, (f0 - t) % Q], dim=-2).reshape(f.shape)
        k += groups
        length //= 2
    return f


def ntt_inv_plain(f: torch.Tensor) -> torch.Tensor:
    zetas = _table("zetas", f.device)
    k, length = 127, 2
    while length <= 128:
        groups = N // (2 * length)
        z = zetas[k - groups + 1 : k + 1].flip(0)
        fr = f.reshape(f.shape[:-1] + (groups, 2, length))
        f0, f1 = fr[..., 0, :], fr[..., 1, :]
        s = (f0 + f1) % Q
        t = (z[:, None] * ((f1 - f0) % Q)) % Q
        f = torch.stack([s, t], dim=-2).reshape(f.shape)
        k -= groups
        length *= 2
    return (f * N_INV) % Q


def ntt(f: torch.Tensor) -> torch.Tensor:
    """Forward NTT: plain on the CPU, kernel K4 on the GPU."""
    if f.device.type == "cpu":
        return ntt_plain(f)
    return mlkem_cuda.ntt(f)


def ntt_inv(f: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (scaled by 128^-1): plain on the CPU, K4 on the GPU."""
    if f.device.type == "cpu":
        return ntt_inv_plain(f)
    return mlkem_cuda.ntt_inv(f)


def multiply_ntts(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Pairwise base-case products; broadcasts over leading dims."""
    gam = _table("gammas", f.device)
    a0, a1 = f[..., 0::2], f[..., 1::2]
    b0, b1 = g[..., 0::2], g[..., 1::2]
    c0 = (a0 * b0 + (a1 * b1 % Q) * gam) % Q
    c1 = (a0 * b1 + a1 * b0) % Q
    return torch.stack([c0, c1], dim=-1).reshape(torch.broadcast_shapes(f.shape, g.shape))


# --------------------------------------------------------------------------
# Samplers (FIPS 203 §4.2.2)
# --------------------------------------------------------------------------

_SAMPLE_NTT_BYTES = 672  # 4 SHAKE-128 blocks -> 448 candidates for 256 slots


def _compact_accepted(cand: torch.Tensor) -> torch.Tensor:
    """(..., C) 12-bit candidates -> (..., 256): the candidates < q in
    order, then, if fewer than 256 passed, the rejected ones in order.

    This is the in-order compaction that the reference's sort key
    (accepted before rejected, index order within each, ``& 0xFFF``)
    produces; kernel K2 appends in the same order as it parses."""
    return keccak.compact_accepted(cand, cand < Q) & 0xFFF


def sample_ntt_plain(seeds: torch.Tensor) -> torch.Tensor:
    """(..., 34) uint8 XOF seeds -> (..., 256) int32 NTT-domain polynomials.

    Squeezes a fixed 672 bytes, as the reference does, so the coefficients
    match it whenever the spec's loop would stop within 672 bytes."""
    buf = keccak.sponge_plain(seeds, 168, 0x1F, _SAMPLE_NTT_BYTES).to(torch.int32)
    t = buf.reshape(buf.shape[:-1] + (-1, 3))
    d1 = t[..., 0] + 256 * (t[..., 1] % 16)
    d2 = (t[..., 1] // 16) + 16 * t[..., 2]
    cand = torch.stack([d1, d2], dim=-1).reshape(buf.shape[:-1] + (-1,))
    return _compact_accepted(cand)


def sample_ntt(seeds: torch.Tensor) -> torch.Tensor:
    """SampleNTT: plain on the CPU, kernel K2 on the GPU."""
    if seeds.device.type == "cpu":
        return sample_ntt_plain(seeds)
    return mlkem_cuda.sample_ntt(seeds)


def sample_poly_cbd(b: torch.Tensor, eta: int) -> torch.Tensor:
    """(..., 64*eta) uint8 PRF output -> (..., 256) int32 CBD_eta polynomial."""
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    bits = (b[..., :, None].to(torch.int32) >> shifts) & 1
    x = bits.reshape(b.shape[:-1] + (N, 2, eta)).sum(dim=-1, dtype=torch.int32)
    return (x[..., 0] - x[..., 1]) % Q


def prf_cbd_plain(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    """PRF_eta + SamplePolyCBD over (..., 33) seeds s || b -> (..., 256)."""
    return sample_poly_cbd(keccak.sponge_plain(seeds, 136, 0x1F, 64 * eta), eta)


def prf_cbd_ntt_plain(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    return ntt_plain(prf_cbd_plain(seeds, eta))


def prf_cbd(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    """PRF + CBD: plain on the CPU, kernel K3 on the GPU."""
    if seeds.device.type == "cpu":
        return prf_cbd_plain(seeds, eta)
    return mlkem_cuda.prf_cbd(seeds, eta)


def prf_cbd_ntt(seeds: torch.Tensor, eta: int) -> torch.Tensor:
    """``ntt(prf_cbd(...))``: plain on the CPU, one K3 launch (NTT fused)
    on the GPU, so the CBD polynomial never reaches device memory."""
    if seeds.device.type == "cpu":
        return prf_cbd_ntt_plain(seeds, eta)
    return mlkem_cuda.prf_cbd_ntt(seeds, eta)


def _prf_seeds(s: torch.Tensor, n_consts: range) -> torch.Tensor:
    """s (..., 32) and a run of counter bytes -> (..., len(n_consts), 33)
    s || n.  The counters are made on s's device, with no host copy."""
    n = torch.arange(n_consts.start, n_consts.stop, dtype=torch.uint8, device=s.device)
    s_rep = s[..., None, :].expand(s.shape[:-1] + (len(n), 32))
    n_col = n[:, None].expand(s.shape[:-1] + (len(n), 1))
    return torch.cat([s_rep, n_col], dim=-1)


def _prf_cbd(s: torch.Tensor, n_consts: range, eta: int) -> torch.Tensor:
    """PRF_eta + SamplePolyCBD: s (..., 32) -> (..., len(n_consts), 256)."""
    return prf_cbd(_prf_seeds(s, n_consts), eta)


def _prf_cbd_ntt(s: torch.Tensor, n_consts: range, eta: int) -> torch.Tensor:
    """``ntt(_prf_cbd(...))``, bit-identical to the two-step form."""
    return prf_cbd_ntt(_prf_seeds(s, n_consts), eta)


def _expand_matrix(rho: torch.Tensor, k: int) -> torch.Tensor:
    """rho (..., 32) -> A_hat (..., k, k, 256) with A[i,j] = SampleNTT(rho||j||i)."""
    idx = torch.arange(k * k, dtype=torch.uint8, device=rho.device)
    ji = torch.stack([idx % k, idx // k], dim=-1)  # rows (j, i), i major
    rho_rep = rho[..., None, :].expand(rho.shape[:-1] + (k * k, 32))
    ji_rep = ji.expand(rho.shape[:-1] + (k * k, 2))
    a = sample_ntt(torch.cat([rho_rep, ji_rep], dim=-1))
    return a.reshape(rho.shape[:-1] + (k, k, N))


# --------------------------------------------------------------------------
# K-PKE + ML-KEM (FIPS 203 §5-7)
# --------------------------------------------------------------------------


def _kpke_keygen(p: MLKEMParams, d: torch.Tensor):
    k = p.k
    kin = torch.cat([d, torch.full(d.shape[:-1] + (1,), k, dtype=torch.uint8,
                                   device=d.device)], dim=-1)
    g = keccak.sha3_512(kin)
    rho, sigma = g[..., :32], g[..., 32:]
    a_hat = _expand_matrix(rho, k)
    noise_hat = _prf_cbd_ntt(sigma, range(2 * k), p.eta1)
    s_hat = noise_hat[..., :k, :]
    e_hat = noise_hat[..., k:, :]
    t_hat = (multiply_ntts(a_hat, s_hat[..., None, :, :]).sum(dim=-2, dtype=torch.int32)
             + e_hat) % Q
    ek = torch.cat([byte_encode(t_hat, 12).reshape(d.shape[:-1] + (384 * k,)), rho], dim=-1)
    dk_pke = byte_encode(s_hat, 12).reshape(d.shape[:-1] + (384 * k,))
    return ek, dk_pke


def _decode_t_hat(p: MLKEMParams, ek: torch.Tensor) -> torch.Tensor:
    return byte_decode(ek[..., : 384 * p.k].reshape(ek.shape[:-1] + (p.k, 384)), 12)


def _kpke_encrypt(p: MLKEMParams, ek: torch.Tensor, m: torch.Tensor, r: torch.Tensor):
    a_hat = _expand_matrix(ek[..., 384 * p.k :], p.k)
    return _kpke_encrypt_pre(p, _decode_t_hat(p, ek), a_hat, m, r)


def _kpke_encrypt_pre(p: MLKEMParams, t_hat: torch.Tensor, a_hat: torch.Tensor,
                      m: torch.Tensor, r: torch.Tensor):
    """K-PKE.Encrypt over pre-decoded key material.  ``t_hat``/``a_hat``
    may be unbatched (one key) and broadcast against a batched (m, r)."""
    k = p.k
    e12 = _prf_cbd(r, range(k, 2 * k + 1), p.eta2)  # e1 and e2 in one launch
    e1, e2 = e12[..., :k, :], e12[..., k, :]
    y_hat = _prf_cbd_ntt(r, range(k), p.eta1)
    # u = invNTT(A^T o y_hat) + e1: contract over the row index i of A[i, j]
    u = (ntt_inv(multiply_ntts(a_hat, y_hat[..., :, None, :]).sum(dim=-3, dtype=torch.int32)
                 % Q) + e1) % Q
    mu = decompress(byte_decode(m, 1), 1)
    v = (ntt_inv(multiply_ntts(t_hat, y_hat).sum(dim=-2, dtype=torch.int32) % Q)
         + e2 + mu) % Q
    c1e = byte_encode(compress(u, p.du), p.du)  # (..., k, 32*du)
    c1 = c1e.reshape(c1e.shape[:-2] + (32 * p.du * k,))
    c2 = byte_encode(compress(v, p.dv), p.dv)
    return torch.cat([c1, c2], dim=-1)


def _kpke_decrypt(p: MLKEMParams, dk_pke: torch.Tensor, c: torch.Tensor):
    k, du, dv = p.k, p.du, p.dv
    c1 = c[..., : 32 * du * k].reshape(c.shape[:-1] + (k, 32 * du))
    u = decompress(byte_decode(c1, du), du)
    v = decompress(byte_decode(c[..., 32 * du * k :], dv), dv)
    s_hat = byte_decode(dk_pke.reshape(dk_pke.shape[:-1] + (k, 384)), 12)
    w = (v - ntt_inv(multiply_ntts(s_hat, ntt(u)).sum(dim=-2, dtype=torch.int32) % Q)) % Q
    return byte_encode(compress(w, 1), 1)


def keygen(p: MLKEMParams, d: torch.Tensor, z: torch.Tensor):
    """ML-KEM.KeyGen_internal: d, z (..., 32) uint8 -> ek (..., ek_len), dk (..., dk_len)."""
    ek, dk_pke = _kpke_keygen(p, d)
    dk = torch.cat([dk_pke, ek, keccak.sha3_256(ek), z], dim=-1)
    return ek, dk


def encaps(p: MLKEMParams, ek: torch.Tensor, m: torch.Tensor):
    """ML-KEM.Encaps_internal: ek, m (..., 32) -> K (..., 32), c (..., ct_len)."""
    g = keccak.sha3_512(torch.cat([m, keccak.sha3_256(ek)], dim=-1))
    key, r = g[..., :32], g[..., 32:]
    return key, _kpke_encrypt(p, ek, m, r)


def precompute_ek(p: MLKEMParams, ek: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-key state that encaps reuses: the decoded t_hat, ExpandA(rho)
    and H(ek).  May be unbatched; broadcasts against any batch of m."""
    return {
        "t_hat": _decode_t_hat(p, ek),
        "a_hat": _expand_matrix(ek[..., 384 * p.k :], p.k),
        "h_ek": keccak.sha3_256(ek),
    }


def precompute_from_numpy(pre: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The reference's ``precompute_ek`` dict (numpy: ``t_hat`` (k, 256)
    int32, ``a_hat`` (k, k, 256) int32, ``h_ek`` (32,) uint8, or batched
    forms of them) as the port's, on ``device``."""
    dtypes = {"t_hat": torch.int32, "a_hat": torch.int32, "h_ek": torch.uint8}
    return {name: torch.tensor(np.asarray(pre[name]), dtype=dt, device=device)
            for name, dt in dtypes.items()}


def encaps_pre(p: MLKEMParams, pre: dict[str, torch.Tensor], m: torch.Tensor):
    """``encaps`` over a ``precompute_ek`` dict: bit-identical output."""
    h_ek = pre["h_ek"].expand(m.shape[:-1] + (32,))
    g = keccak.sha3_512(torch.cat([m, h_ek], dim=-1))
    key, r = g[..., :32], g[..., 32:]
    return key, _kpke_encrypt_pre(p, pre["t_hat"], pre["a_hat"], m, r)


def encaps_cold(p: MLKEMParams, ek: torch.Tensor, m: torch.Tensor):
    """Cache-filling encaps: the per-key state and the op results at once."""
    pre = precompute_ek(p, ek)
    key, c = encaps_pre(p, pre, m)
    return pre, key, c


def decaps(p: MLKEMParams, dk: torch.Tensor, c: torch.Tensor):
    """ML-KEM.Decaps_internal with implicit rejection (branch-free select)."""
    k = p.k
    dk_pke = dk[..., : 384 * k]
    ek = dk[..., 384 * k : 768 * k + 32]
    h = dk[..., 768 * k + 32 : 768 * k + 64]
    z = dk[..., 768 * k + 64 :]
    m2 = _kpke_decrypt(p, dk_pke, c)
    g = keccak.sha3_512(torch.cat([m2, h], dim=-1))
    key2, r2 = g[..., :32], g[..., 32:]
    key_bar = keccak.shake256(torch.cat([z, c], dim=-1), 32)
    c2 = _kpke_encrypt(p, ek, m2, r2)
    ok = (c == c2).all(dim=-1, keepdim=True)
    return torch.where(ok, key2, key_bar)


@functools.cache
def get(name: str):
    """(keygen, encaps, decaps) for a parameter-set name."""
    p = PARAMS[name]
    return (functools.partial(keygen, p), functools.partial(encaps, p),
            functools.partial(decaps, p))


@functools.cache
def get_pre(name: str):
    """(encaps_cold, encaps_pre) for the operand cache (provider/opcache.py)."""
    p = PARAMS[name]
    return functools.partial(encaps_cold, p), functools.partial(encaps_pre, p)
