"""Batched HQC (round-4 shape) in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/kem/hqc.py``, function for
function and byte for byte.  Every function takes tensors with any leading
batch shape and runs where they lie; randomness (sk_seed, sigma, pk_seed;
m, salt) is an explicit input.  Keys, ciphertexts and secrets are the
reference's bytes.

HQC has no kernel of its own.  Its hashes (the seedexpander and the G and K
hashes, all SHAKE256) go through ``core.keccak``, which is kernel K1 on a
CUDA tensor; the rest is bit and byte arithmetic in PyTorch, written for
few launches rather than for the TPU's gather-free style:

* n-bit vectors of the KEM are held as 64-bit words (``(..., ceil(n/64))``
  int64, bit i in bit i % 64 of word i // 64, bits past n zero), which are
  the wire bytes viewed as int64.  The cyclic product by a sparse vector,
  out[i] = XOR_k dense[(i - p_k) mod n], is one exact integer formulation:
  each rotation is a word window of the doubled vector dense || dense at
  bit offset n - p_k, read with one gather and one funnel shift, and the
  windows are XOR-folded (:func:`_cyclic_words`);
* GF(2^8) products of two variables use a 256 x 256 product table; maps
  that are GF(2^8)-linear with constant coefficients (Reed-Solomon encode,
  the syndromes, the Chien search and both Forney evaluations) are 0/1
  matrices over the bits, applied as one float32 matrix product each
  (exact: every sum is at most 8 * n1 = 720) and reduced mod 2;
* Berlekamp-Massey runs its 2 delta steps in order, each a few batched
  table lookups;
* the RM(1,7) encode is a table of 16-byte codewords, the decode's
  Hadamard transform one matrix product by the 128 x 128 +-1 matrix;
* the fixed-weight sampler's duplicate scan (slot i takes the value i when
  a later slot holds its value) runs in order over the slots, weight - 1
  steps of three batched ops each, with no early exit and no host sync:
  decaps re-draws from theta = H(m' || pk || salt), so a scan whose work
  followed the collisions would time m' (a plaintext-checking oracle).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import keccak
from .hqc_params import (  # noqa: F401  (PARAMS re-exported)
    _GF_EXP,
    _GF_LOG,
    _RM_ENC_TABLE,
    PARAMS,
    RM_N,
    HQCParams,
    _rs_gen_poly,
)

#: elements of one step's (rows, support positions, words) window tensor in
#: the cyclic product: the support is taken in slices that keep each such
#: int64 tensor near 256 MB, whatever the batch
CYCLIC_STEP_ELEMS = 1 << 25

_MASK32 = 0xFFFFFFFF
_MIN64 = -(1 << 63)

# every v of the three sets fills whole 64-bit words
assert all(p.n1 * p.n2 % 64 == 0 for p in PARAMS.values())


def _nwords(nbits: int) -> int:
    return (nbits + 63) // 64


# -- GF(2^8) tables (host) ----------------------------------------------------


def _gf_mul_table() -> np.ndarray:
    """(65536,) int64: the product a * b at index 256 a + b."""
    exp = np.asarray(_GF_EXP, np.int64)
    log = np.asarray(_GF_LOG, np.int64)
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    t = exp[log[a] + log[b]]
    t[(a == 0) | (b == 0)] = 0
    return t.reshape(-1)


_GF_MUL_NP = _gf_mul_table()
_GF_INV_NP = np.array([0] + [_GF_EXP[255 - _GF_LOG[x]] for x in range(1, 256)], np.int64)


def _gf2_matrix(c: np.ndarray) -> np.ndarray:
    """(m, o) GF(2^8) coefficients of a linear map out[j] = XOR_i c[i, j] x[i]
    -> its (8m, 8o) 0/1 matrix over the bits: row 8i + b, column 8j + b' is
    bit b' of 2^b * c[i, j]."""
    c = np.asarray(c, np.int64)
    prod = _GF_MUL_NP[(1 << np.arange(8))[None, :, None] * 256 + c[:, None, :]]
    bits = (prod[..., None] >> np.arange(8)) & 1  # (m, 8, o, 8)
    return bits.reshape(8 * c.shape[0], 8 * c.shape[1]).astype(np.float32)


def _rs_encode_int(p: HQCParams, msg: list[int]) -> list[int]:
    """The LFSR division of the JAX module's ``_rs_encode`` on Python ints:
    k message bytes -> 2 delta parity bytes."""
    g = _rs_gen_poly(p)[: 2 * p.delta]
    rem = [0] * (2 * p.delta)
    for j in range(p.k):
        coef = msg[p.k - 1 - j] ^ rem[-1]
        rem = [0] + rem[:-1]
        rem = [r ^ int(_GF_MUL_NP[coef * 256 + gi]) for r, gi in zip(rem, g)]
    return rem


@functools.cache
def _host_consts(p: HQCParams) -> dict[str, np.ndarray]:
    red, deg, n1 = 2 * p.delta, 2 * p.delta + 1, p.n1
    exp = np.asarray(_GF_EXP, np.int64)
    enc = np.array([_rs_encode_int(p, [int(i == j) for j in range(p.k)]) for i in range(p.k)])
    # S_i = c(alpha^i), i = 1..red
    synd = exp[np.outer(np.arange(p.n1), np.arange(1, red + 1)) % 255]
    # from [sigma (deg), omega (red)] to [sigma(alpha^-j), omega(alpha^-j),
    # sigma'(alpha^-j)] over the n1 positions j
    inv_j = (255 - np.arange(n1)) % 255
    cf = np.zeros((deg + red, 3 * n1), np.int64)
    cf[:deg, :n1] = exp[np.outer(np.arange(deg), inv_j) % 255]
    cf[deg:, n1:2 * n1] = exp[np.outer(np.arange(red), inv_j) % 255]
    odd = np.arange(1, deg, 2)
    cf[odd, 2 * n1:] = exp[np.outer(odd - 1, inv_j) % 255]
    # omega[i] = XOR_{j <= i} sigma[j] synd[i - j]; index red is a zero pad
    i, j = np.meshgrid(np.arange(red), np.arange(red), indexing="ij")
    return {"rs_enc": _gf2_matrix(enc), "synd": _gf2_matrix(synd), "chien_forney": _gf2_matrix(cf),
            "omega_idx": np.where(j <= i, i - j, red)}


@functools.cache
def _device_consts(device: str) -> dict[str, torch.Tensor]:
    x = np.arange(RM_N)
    pop = np.vectorize(lambda v: bin(v).count("1"))(x[:, None] & x[None, :])
    rm = np.array([[(cw >> (8 * i)) & 0xFF for i in range(RM_N // 8)] for cw in _RM_ENC_TABLE],
                  np.uint8)
    return {"mul": torch.tensor(_GF_MUL_NP, device=device),
            "inv": torch.tensor(_GF_INV_NP, device=device),
            "sh8": torch.arange(8, device=device),
            "sh8u": torch.arange(8, dtype=torch.uint8, device=device),
            "hadamard": torch.tensor(1 - 2 * (pop & 1), dtype=torch.float32, device=device),
            "rm_bytes": torch.tensor(rm, device=device)}


@functools.cache
def _param_consts(p: HQCParams, device: str) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(v, device=device) for k, v in _host_consts(p).items()}


# -- GF(2^8) ------------------------------------------------------------------


def _gf_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) product of integer tensors (broadcasting) -> int64."""
    return _device_consts(str(a.device))["mul"][torch.add(b.long(), a.long(), alpha=256)]


def _gf_inv(x: torch.Tensor) -> torch.Tensor:
    """x^-1 in GF(2^8), 0 -> 0 -> int64."""
    return _device_consts(str(x.device))["inv"][x.long()]


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR over one dim of an integer tensor, by halves."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] ^ x[..., h:2 * h]
        if x.shape[-1] % 2:
            y[..., :1] ^= x[..., 2 * h:]
        x = y
    return x[..., 0]


def _gf_lin(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """A GF(2^8)-linear map of byte vectors: x (..., m) -> (..., o) int64,
    ``mat`` its (8m, 8o) 0/1 matrix over the bits (:func:`_gf2_matrix`)."""
    sh8 = _device_consts(str(x.device))["sh8"]
    bits = ((x.long()[..., None] >> sh8) & 1).reshape(x.shape[:-1] + (-1,))
    y = torch.matmul(bits.to(torch.float32), mat).to(torch.int64) & 1
    return (y.reshape(y.shape[:-1] + (-1, 8)) << sh8).sum(-1)


# -- bit / byte / word helpers ------------------------------------------------


def _bytes_to_bits(b: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., L) uint8 -> (..., nbits) uint8 bits, little-endian in a byte."""
    bits = (b[..., :, None] >> _device_consts(str(b.device))["sh8u"]) & 1
    return bits.reshape(b.shape[:-1] + (-1,))[..., :nbits]


def _bytes_to_words(b: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., >= ceil(nbits / 8)) uint8 -> (..., ceil(nbits / 64)) int64: the
    first nbits bits, the rest zero."""
    nb = (nbits + 7) // 8
    buf = torch.zeros(b.shape[:-1] + (8 * _nwords(nbits),), dtype=torch.uint8, device=b.device)
    buf[..., :nb] = b[..., :nb]
    words = buf.view(torch.int64)
    if nbits % 64:
        words[..., -1] &= (1 << (nbits % 64)) - 1
    return words


def _words_to_bytes(w: torch.Tensor, nbytes: int) -> torch.Tensor:
    return w.contiguous().view(torch.uint8)[..., :nbytes]


# -- sampling -----------------------------------------------------------------


def _seedexpand(seed: torch.Tensor, out_len: int) -> torch.Tensor:
    """HQC seedexpander stream: SHAKE256(seed || 0x02) squeezed to out_len;
    callers slice consecutive reads off one stream."""
    return keccak.shake256(F.pad(seed, (0, 1), value=2), out_len)


def _u32s(buf: torch.Tensor) -> torch.Tensor:
    """(..., 4k) uint8 -> (..., k) int64 values of the little-endian uint32s."""
    return buf.contiguous().view(torch.int32).to(torch.int64) & _MASK32


def _fixed_weight_support(p: HQCParams, rand: torch.Tensor, weight: int) -> torch.Tensor:
    """(..., weight) uint32 randoms -> (..., weight) int64 distinct positions.

    HQC vect_set_random_fixed_weight: i + (rand32 * (n - i)) >> 32 (exact in
    int64: the product is below 2^48), then the reverse scan: slot i becomes
    i where a later slot, already fixed, holds its value.  The same ops in
    the same order whatever the draws, and no host sync (module docstring)."""
    i = torch.arange(weight, device=rand.device)
    sup = i + (((rand.long() & _MASK32) * (p.n - i)) >> 32)
    out = sup.clone()
    for s in range(weight - 2, -1, -1):
        out[..., s].masked_fill_((out[..., s + 1:] == sup[..., s, None]).any(-1), s)
    return out


def _support_to_words(p: HQCParams, sup: torch.Tensor) -> torch.Tensor:
    """(..., w) distinct positions -> (..., ceil(n / 64)) int64 words (the
    bits are distinct, so their sum is their OR)."""
    s = sup.long()
    words = torch.zeros(sup.shape[:-1] + (_nwords(p.n),), dtype=torch.int64, device=sup.device)
    return words.scatter_add_(-1, s >> 6, torch.ones_like(s) << (s & 63))


def _sample_random_words(p: HQCParams, seed: torch.Tensor) -> torch.Tensor:
    return _bytes_to_words(_seedexpand(seed, p.n_bytes), p.n)


# -- cyclic arithmetic --------------------------------------------------------


def _doubled(p: HQCParams, dense: torch.Tensor) -> torch.Tensor:
    """(..., ceil(n/64)) words -> the words of dense || dense (2n bits) and
    one zero word past them: dense | dense << n."""
    qn, rn = divmod(p.n, 64)
    width = _nwords(2 * p.n) + 1
    src = F.pad(dense, (qn + 1, width + 1 - dense.shape[-1] - qn))  # src[i] = dense[i - qn - 1]
    shifted = src[..., 1:width + 1] << rn
    if rn:
        shifted |= (src[..., :width] >> (64 - rn)) & ((1 << rn) - 1)
    return F.pad(dense, (0, width - dense.shape[-1])) | shifted


def _cyclic_words(p: HQCParams, dense: torch.Tensor, sup: torch.Tensor) -> torch.Tensor:
    """dense (..., ceil(n/64)) words x support (..., w) -> (..., ceil(n/64))
    words: out[i] = XOR_k dense[(i - p_k) mod n], exact.

    Rotation by p is the window of the doubled vector at bit n - p: word t
    of it is the funnel shift of doubled words q + t and q + t + 1 by r,
    (q, r) = divmod(n - p, 64); the nw + 1 words from q are row q of the
    doubled vector's unfolded view, so one index op reads them all.
    PRECONDITION, as in the JAX module: positions pairwise distinct (a
    repeated one cancels here)."""
    nw = _nwords(p.n)
    batch = dense.shape[:-1]
    rows = math.prod(batch)
    windows = _doubled(p, dense).reshape(rows, -1).unfold(-1, nw + 1, 1)
    start = p.n - sup.reshape(rows, -1).long()
    q, r = start >> 6, (start & 63)[..., None]
    keep = ~((torch.full_like(r, _MIN64) >> r) << 1)  # the low 64 - r bits
    up = 63 - r
    row = torch.arange(rows, device=dense.device)[:, None]
    step = max(1, CYCLIC_STEP_ELEMS // max(1, rows * (nw + 1)))
    out = None
    for c0 in range(0, q.shape[-1], step):
        c1 = min(c0 + step, q.shape[-1])
        g = windows[row, q[:, c0:c1]]  # (rows, c1 - c0, nw + 1)
        win = g[..., :-1] >> r[:, c0:c1]
        win &= keep[:, c0:c1]
        hi = g[..., 1:] << 1
        hi <<= up[:, c0:c1]
        win |= hi
        part = _xor_reduce(win, -2)
        out = part if out is None else out ^ part
    if p.n % 64:
        out[..., -1] &= (1 << (p.n % 64)) - 1
    return out.reshape(batch + (nw,))


# -- Reed-Solomon over GF(2^8) ------------------------------------------------


def _rs_encode(p: HQCParams, msg: torch.Tensor) -> torch.Tensor:
    """(..., k) bytes -> (..., n1) int64 codeword: parity || msg."""
    msg = msg.long()
    return torch.cat([_gf_lin(msg, _param_consts(p, str(msg.device))["rs_enc"]), msg], dim=-1)


def _rs_syndromes(p: HQCParams, cw: torch.Tensor) -> torch.Tensor:
    """(..., n1) -> (..., 2 delta) int64: S_i = cw(alpha^i), i = 1..2 delta."""
    return _gf_lin(cw, _param_consts(p, str(cw.device))["synd"])


def _rs_bm(p: HQCParams, synd: torch.Tensor) -> torch.Tensor:
    """Berlekamp-Massey over all 2 delta steps -> sigma (..., 2 delta + 1).

    As the JAX module: D = x^m B(x) is carried as a shift of a select, and
    a zero discrepancy leaves sigma as it is (its update is then zero).
    Sigma and D are held 2^k wide (entries past 2 delta stay zero), so the
    discrepancy's XOR folds by halves."""
    red, deg = 2 * p.delta, 2 * p.delta + 1
    width = 1 << (deg - 1).bit_length()
    batch = synd.shape[:-1]
    synd = synd.long()
    # rev[red - 1 - t + i] = synd[t - i] for i <= t, 0 past it
    rev = F.pad(synd.flip(-1), (0, width))
    sigma = F.pad(torch.ones(batch + (1,), dtype=torch.int64, device=synd.device), (0, width - 1))
    dpoly = sigma.roll(1, -1)  # x
    length = torch.zeros(batch, dtype=torch.int64, device=synd.device)
    ibb = torch.ones(batch, dtype=torch.int64, device=synd.device)  # 1 / b
    for t in range(red):
        d = _xor_reduce(_gf_mul(sigma, rev[..., red - 1 - t:red - 1 - t + width]), -1)
        upd = _gf_mul(_gf_mul(d, ibb)[..., None], dpoly)
        grow = (d != 0) & (length <= t // 2)
        dpoly = F.pad(torch.where(grow[..., None], sigma, dpoly)[..., :deg - 1], (1, width - deg))
        sigma = sigma ^ upd
        length = torch.where(grow, t + 1 - length, length)
        ibb = torch.where(grow, _gf_inv(d), ibb)
    return sigma[..., :deg]


def _rs_decode(p: HQCParams, cw: torch.Tensor) -> torch.Tensor:
    """(..., n1) -> (..., k) int64 message bytes (corrects <= delta errors).
    Corrections land only where sigma(alpha^-j) = 0 and sigma'(alpha^-j) != 0."""
    red, n1 = 2 * p.delta, p.n1
    pc = _param_consts(p, str(cw.device))
    cw = cw.long()
    synd = _rs_syndromes(p, cw)
    sigma = _rs_bm(p, synd)
    sg = F.pad(synd, (0, 1))[..., pc["omega_idx"]]  # (..., red, red): synd[i - j]
    omega = _xor_reduce(_gf_mul(sigma[..., None, :red], sg), -1)
    ev = _gf_lin(torch.cat([sigma, omega], dim=-1), pc["chien_forney"])
    chien, num, den = ev[..., :n1], ev[..., n1:2 * n1], ev[..., 2 * n1:]
    mag = _gf_mul(num, _gf_inv(den))
    fix = torch.where((chien == 0) & (den != 0), mag, 0)
    return (cw ^ fix)[..., red:]


# -- duplicated RM(1,7) -------------------------------------------------------


def _rm_encode_bytes(p: HQCParams, rs_cw: torch.Tensor) -> torch.Tensor:
    """(..., n1) bytes -> (..., n1n2_bytes) uint8: each byte's 16-byte
    codeword, dup times."""
    cw = _device_consts(str(rs_cw.device))["rm_bytes"][rs_cw.long()]  # (..., n1, 16)
    dup = cw[..., None, :].expand(cw.shape[:-1] + (p.dup, RM_N // 8))
    return dup.reshape(rs_cw.shape[:-1] + (p.n1n2_bytes,))


def _rm_decode(p: HQCParams, bits: torch.Tensor) -> torch.Tensor:
    """(..., n1 * n2) bits -> (..., n1) int64 decoded bytes: the duplicates'
    soft counts, their Hadamard transform (exact in float32: |F| <= 128 dup),
    the first index of the largest |F| and its sign."""
    x = bits.reshape(bits.shape[:-1] + (p.n1, p.dup, RM_N))
    f = p.dup - 2 * x.sum(dim=-2)
    h = torch.matmul(f.to(torch.float32), _device_consts(str(bits.device))["hadamard"])
    best = h.abs().argmax(dim=-1)
    neg = h.gather(-1, best[..., None])[..., 0] < 0
    return best * 2 + neg


# -- hashes -------------------------------------------------------------------


def _hash_dom(data: torch.Tensor, domain: int, out_len: int = 64) -> torch.Tensor:
    """SHAKE256-512 with a TRAILING domain byte (HQC hash.c shake256_512_ds)."""
    return keccak.shake256(F.pad(data, (0, 1), value=domain), out_len)


# -- KEM ----------------------------------------------------------------------


def keygen(p: HQCParams, sk_seed: torch.Tensor, sigma: torch.Tensor, pk_seed: torch.Tensor):
    """sk_seed (..., 40), sigma (..., k), pk_seed (..., 40) uint8 -> (pk, sk)."""
    h = _sample_random_words(p, pk_seed)
    # one sk expander stream: y first, then x
    rand = _u32s(_seedexpand(sk_seed, 8 * p.w))
    y_sup, x_sup = _fixed_weight_support(
        p, rand.reshape(rand.shape[:-1] + (2, p.w)), p.w).unbind(-2)
    s = _support_to_words(p, x_sup) ^ _cyclic_words(p, h, y_sup)
    pk = torch.cat([pk_seed, _words_to_bytes(s, p.n_bytes)], dim=-1)
    return pk, torch.cat([sk_seed, sigma, pk], dim=-1)


def _encrypt(p: HQCParams, pk: torch.Tensor, m: torch.Tensor, theta: torch.Tensor):
    """-> (u, v) as bytes: (..., n_bytes), (..., n1n2_bytes)."""
    s = _bytes_to_words(pk[..., 40:], p.n)
    h = _sample_random_words(p, pk[..., :40])
    # one theta expander stream: r2, e, r1
    rand = _u32s(_seedexpand(theta, 12 * p.wr))
    sups = _fixed_weight_support(p, rand.reshape(rand.shape[:-1] + (3, p.wr)), p.wr)
    r2 = sups[..., 0, :]
    # h r2 and s r2 in one product; r1 and e in one scatter
    hs = _cyclic_words(p, torch.stack([h, s], dim=-2),
                       r2[..., None, :].expand(sups[..., :2, :].shape))
    r1e = _support_to_words(p, sups[..., [2, 1], :])
    u = r1e[..., 0, :] ^ hs[..., 0, :]
    t = hs[..., 1, :] ^ r1e[..., 1, :]
    code = _rm_encode_bytes(p, _rs_encode(p, m)).contiguous().view(torch.int64)
    v = code ^ t[..., : p.n1 * p.n2 // 64]
    return _words_to_bytes(u, p.n_bytes), _words_to_bytes(v, p.n1n2_bytes)


def encaps(p: HQCParams, pk: torch.Tensor, m: torch.Tensor, salt: torch.Tensor):
    """pk, m (..., k), salt (..., 16) uint8 -> (ct (..., ct_len), ss (..., 64))."""
    theta = _hash_dom(torch.cat([m, pk[..., :32], salt], dim=-1), 3)
    u, v = _encrypt(p, pk, m, theta)
    ct = torch.cat([u, v, salt], dim=-1)
    return ct, _hash_dom(torch.cat([m, u, v], dim=-1), 4)


def decaps(p: HQCParams, sk: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """sk, ct uint8 -> (..., 64) shared secrets; implicit rejection: a
    ciphertext that does not re-encrypt to itself gets K(sigma || u || v)."""
    nb, vb = p.n_bytes, p.n1n2_bytes
    sk_seed, sigma, pk = sk[..., :40], sk[..., 40:40 + p.k], sk[..., 40 + p.k:]
    u_b, v_b, salt = ct[..., :nb], ct[..., nb:nb + vb], ct[..., nb + vb:]
    # y = the first fixed-weight draw off the sk expander stream
    y_sup = _fixed_weight_support(p, _u32s(_seedexpand(sk_seed, 4 * p.w)), p.w)
    uy = _cyclic_words(p, _bytes_to_words(u_b, p.n), y_sup)
    v = _bytes_to_words(v_b, p.n1 * p.n2) ^ uy[..., : p.n1 * p.n2 // 64]
    noisy = _bytes_to_bits(_words_to_bytes(v, vb), p.n1 * p.n2)
    m_p = _rs_decode(p, _rm_decode(p, noisy)).to(torch.uint8)
    theta = _hash_dom(torch.cat([m_p, pk[..., :32], salt], dim=-1), 3)
    u2, v2 = _encrypt(p, pk, m_p, theta)
    ok = (u2 == u_b).all(dim=-1, keepdim=True) & (v2 == v_b).all(dim=-1, keepdim=True)
    # K(m' || u || v) and K(sigma || u || v) in one sponge call
    uv = torch.cat([u_b, v_b], dim=-1)[..., None, :]
    both = _hash_dom(torch.cat([torch.stack([m_p, sigma], dim=-2),
                                uv.expand(uv.shape[:-2] + (2, uv.shape[-1]))], dim=-1), 4)
    return torch.where(ok, both[..., 0, :], both[..., 1, :])


@functools.cache
def get(name: str):
    """(keygen, encaps, decaps) for a parameter-set name."""
    p = PARAMS[name]
    return (functools.partial(keygen, p), functools.partial(encaps, p),
            functools.partial(decaps, p))
