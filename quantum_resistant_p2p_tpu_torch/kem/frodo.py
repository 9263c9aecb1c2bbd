"""Batched FrodoKEM (round-3 / ISO specification) in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/kem/frodo.py``, function for
function and byte for byte.  Every function takes tensors with any leading
batch shape and runs where they lie; randomness (s, seedSE, z, mu) is an
explicit input, the seam the specification defines for KATs.  Matrices
are int32 with entries in [0, q), q = 2^15 or 2^16.

The three steps that were Pallas kernels on the TPU dispatch by device: a
CPU tensor takes the plain PyTorch version defined here (``*_plain``), a
CUDA tensor goes to the kernel wrappers of ``kem/frodo_cuda.py``, which
launch or raise:

================  ======================  ================================
module function   plain version           kernel
================  ======================  ================================
``a_times_s``     ``a_times_s_plain``     K9 ``frodo_cuda.a_times_s``
``s_times_a``     ``s_times_a_plain``     K10 ``frodo_cuda.s_times_a``
``_sample``       ``cdf_sample_plain``    K11 ``frodo_cuda.cdf_sample``
================  ======================  ================================

K9 and K10 make the rows of A by SHAKE-128 inside the kernel, so A never
reaches device memory; they serve the SHAKE sets.  The AES sets expand A
in row chunks with ``core.aes`` and multiply each chunk densely.  Every
other hash goes through ``core.keccak`` (kernel K1 on the GPU).

Dense products (:func:`_mat_mod`) run in float64, on the CPU and the GPU
alike, because PyTorch has no integer matrix product on CUDA.  They are
exact: both factors are reduced to [0, q) first, so every product is
below 2^32, and a sum of at most n = 1344 of them is below 2^43 < 2^53.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import aes, keccak
from . import frodo_cuda
from .frodo_params import NBAR, PARAMS, FrodoParams  # noqa: F401  (PARAMS re-exported)

N_CHUNKS = 16  # row chunks of A in the plain products and the AES expansion
#: AES blocks expanded per step of the AES chunk loops: a row chunk of a
#: large batch is split further so that the S-box gathers stay near 0.5 GB
AES_STEP_BLOCKS = 1 << 23


def _shake(p: FrodoParams, data: torch.Tensor, out_len: int) -> torch.Tensor:
    return (keccak.shake128 if p.n == 640 else keccak.shake256)(data, out_len)


def _le16(b: torch.Tensor) -> torch.Tensor:
    """(..., 2k) uint8 -> (..., k) int32 little-endian 16-bit."""
    x = b.to(torch.int32).reshape(b.shape[:-1] + (-1, 2))
    return x[..., 0] | (x[..., 1] << 8)


def _to_le16(v: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 (mod 2^16) -> (..., 2k) uint8."""
    out = torch.stack([v & 0xFF, (v >> 8) & 0xFF], dim=-1).to(torch.uint8)
    return out.reshape(out.shape[:-2] + (-1,))


def _prefixed(byte: int, data: torch.Tensor) -> torch.Tensor:
    """(..., L) uint8 -> (..., 1 + L): one domain byte, then the data."""
    pfx = torch.full(data.shape[:-1] + (1,), byte, dtype=torch.uint8, device=data.device)
    return torch.cat([pfx, data], dim=-1)


def _mat_mod(p: FrodoParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b mod q`` for integer tensors (batched, broadcasting) -> int32
    in [0, q); float64 products, exact (module docstring)."""
    mask = p.q - 1
    prod = torch.matmul((a & mask).to(torch.float64), (b & mask).to(torch.float64))
    return (prod.to(torch.int64) & mask).to(torch.int32)


# -- error sampling: kernel K11 ----------------------------------------------


def cdf_sample_plain(p: FrodoParams, r16: torch.Tensor) -> torch.Tensor:
    """(...,) int32 16-bit randoms -> CDF samples mod q: the count of table
    entries (all but the last) below r >> 1, negated when r is odd.  A
    compare-sum over the whole table, with no early exit."""
    t = r16 >> 1
    e = torch.zeros_like(r16)
    for c in p.cdf[:-1]:
        e += (t > c).to(torch.int32)
    return torch.where((r16 & 1) == 1, -e, e) & (p.q - 1)


def _sample(p: FrodoParams, r16: torch.Tensor) -> torch.Tensor:
    """CDF inversion: plain on the CPU, kernel K11 on the GPU."""
    if r16.device.type == "cpu":
        return cdf_sample_plain(p, r16)
    return frodo_cuda.cdf_sample(p, r16)


# -- packing / encoding ------------------------------------------------------


def _pack(p: FrodoParams, v: torch.Tensor) -> torch.Tensor:
    """(..., m) int32 -> (..., m*d/8) uint8, d bits a value, MSB first.

    Eight values are d bytes.  Byte k of a group starts at bit 8k of the
    group's bit string, inside value i = 8k // d at offset o = 8k - d*i; it
    is bits [2d - 8 - o, 2d - o) of the 2d-bit pair (v_i, v_{i+1})."""
    d = p.d
    k = torch.arange(d, device=v.device)
    i, off = 8 * k // d, 8 * k % d
    g = v.to(torch.int64).reshape(v.shape[:-1] + (-1, 8)) & ((1 << d) - 1)
    g = torch.cat([g, torch.zeros_like(g[..., :1])], dim=-1)  # v_8 = 0 closes the pair
    pair = (g[..., i] << d) | g[..., i + 1]
    out = ((pair >> (2 * d - 8 - off)) & 0xFF).to(torch.uint8)
    return out.reshape(v.shape[:-1] + (-1,))


def _unpack(p: FrodoParams, b: torch.Tensor) -> torch.Tensor:
    """(..., m*d/8) uint8 -> (..., m) int32, the inverse of :func:`_pack`:
    value i of a d-byte group starts at bit d*i, inside byte j = d*i // 8 at
    offset o = d*i % 8, and is read from the 24 bits of bytes j, j+1, j+2."""
    d = p.d
    i = torch.arange(8, device=b.device)
    j, off = d * i // 8, d * i % 8
    g = b.to(torch.int32).reshape(b.shape[:-1] + (-1, d))
    g = torch.cat([g, torch.zeros_like(g[..., :2])], dim=-1)
    word = (g[..., j] << 16) | (g[..., j + 1] << 8) | g[..., j + 2]
    out = (word >> (24 - d - off)) & ((1 << d) - 1)
    return out.reshape(b.shape[:-1] + (-1,))


def _encode(p: FrodoParams, mu: torch.Tensor) -> torch.Tensor:
    """(..., len_sec) uint8 -> (..., 64) int32 (nbar x nbar row-major)."""
    shifts = torch.arange(8, dtype=torch.int32, device=mu.device)
    bits = (mu[..., :, None].to(torch.int32) >> shifts) & 1
    bits = bits.reshape(mu.shape[:-1] + (64, p.b))
    weights = torch.arange(p.b, dtype=torch.int32, device=mu.device)
    return (bits << weights).sum(dim=-1, dtype=torch.int32) << (p.d - p.b)


def _decode(p: FrodoParams, m: torch.Tensor) -> torch.Tensor:
    """(..., 64) int32 -> (..., len_sec) uint8."""
    val = ((((m & (p.q - 1)) << p.b) + (p.q >> 1)) >> p.d) & ((1 << p.b) - 1)
    shifts = torch.arange(p.b, dtype=torch.int32, device=m.device)
    bits = ((val[..., :, None] >> shifts) & 1).reshape(m.shape[:-1] + (-1, 8))
    weights = torch.arange(8, dtype=torch.int32, device=m.device)
    return (bits << weights).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


# -- the matrix A, row chunk by row chunk ------------------------------------


def _shake_rows(p: FrodoParams, seed_a: torch.Tensor, row_start: int, nrows: int,
                sponge) -> torch.Tensor:
    """Rows [row_start, row_start + nrows) of a SHAKE set's A: each row is
    the first n little-endian 16-bit words of SHAKE-128(le16(row) || seed_a)
    (SHAKE-128 for every set) -> (..., nrows, n) int32 masked to q."""
    rows = torch.arange(row_start, row_start + nrows, device=seed_a.device)
    idx = torch.stack([rows & 0xFF, rows >> 8], dim=-1).to(torch.uint8)
    lead = seed_a.shape[:-1] + (nrows,)
    seeds = torch.cat([idx.expand(lead + (2,)), seed_a[..., None, :].expand(lead + (16,))],
                      dim=-1)
    return _le16(sponge(seeds, 168, 0x1F, 2 * p.n)) & (p.q - 1)


def _aes_rows(p: FrodoParams, round_keys: torch.Tensor, row_start: int,
              nrows: int) -> torch.Tensor:
    """Rows of an AES set's A: AES-128 of the blocks le16(row) ||
    le16(col) || 0^12, col = 0, 8, ..., each block giving 8 values."""
    pt = np.zeros((nrows, p.n // 8, 16), dtype=np.uint8)
    rows = np.arange(row_start, row_start + nrows)[:, None]
    cols = np.arange(0, p.n, 8)[None, :]
    pt[..., 0], pt[..., 1] = rows & 0xFF, rows >> 8
    pt[..., 2], pt[..., 3] = cols & 0xFF, cols >> 8
    blocks = torch.from_numpy(pt.reshape(-1, 16)).to(round_keys.device)
    blocks = blocks.expand(round_keys.shape[:-2] + blocks.shape)
    ct = aes.encrypt_blocks(round_keys, blocks)
    vals = _le16(ct.reshape(ct.shape[:-2] + (-1,)))
    return vals.reshape(vals.shape[:-1] + (nrows, p.n)) & (p.q - 1)


def _gen_a_chunk(p: FrodoParams, ctx: torch.Tensor, row_start: int,
                 nrows: int) -> torch.Tensor:
    """-> (..., nrows, n) int32; ctx = round keys (AES) or seed_a (SHAKE).
    The SHAKE rows go through ``core.keccak`` (K1 on the GPU)."""
    if p.aes:
        return _aes_rows(p, ctx, row_start, nrows)
    return _shake_rows(p, ctx, row_start, nrows, keccak.sponge)


def _a_ctx(p: FrodoParams, seed_a: torch.Tensor) -> torch.Tensor:
    return aes.key_schedule(seed_a) if p.aes else seed_a


def _aes_steps(p: FrodoParams, ctx: torch.Tensor):
    """(row_start, nrows) steps of the AES chunk loops: the 16 row chunks,
    each split so that a step expands at most AES_STEP_BLOCKS blocks."""
    per_row = ctx[..., 0, 0].numel() * (p.n // 8)
    rows = p.n // N_CHUNKS
    step = max(1, min(rows, AES_STEP_BLOCKS // per_row))
    for c in range(0, p.n, rows):
        for r in range(c, c + rows, step):
            yield r, min(step, c + rows - r)


# -- the products with A: kernels K9 and K10 ----------------------------------


def a_times_s_plain(p: FrodoParams, s: torch.Tensor, seed_a: torch.Tensor) -> torch.Tensor:
    """A.S of a SHAKE set: s (..., n, NBAR), seed_a (..., 16) -> (..., n,
    NBAR) in [0, q).  A is made and multiplied in 16 row chunks, as the
    reference's ``frodo_pallas.a_times_s_jnp`` does, with the plain sponge."""
    rows = p.n // N_CHUNKS
    return torch.cat([_mat_mod(p, _shake_rows(p, seed_a, c * rows, rows, keccak.sponge_plain),
                               s) for c in range(N_CHUNKS)], dim=-2)


def s_times_a_plain(p: FrodoParams, sp: torch.Tensor, seed_a: torch.Tensor) -> torch.Tensor:
    """S'.A of a SHAKE set: sp (..., NBAR, n), seed_a (..., 16) -> (...,
    NBAR, n) in [0, q), over the same 16 row chunks as ``s_times_a_jnp``."""
    rows = p.n // N_CHUNKS
    acc = torch.zeros(sp.shape[:-1] + (p.n,), dtype=torch.int32, device=sp.device)
    for c in range(N_CHUNKS):
        a_chunk = _shake_rows(p, seed_a, c * rows, rows, keccak.sponge_plain)
        acc = (acc + _mat_mod(p, sp[..., c * rows : (c + 1) * rows], a_chunk)) & (p.q - 1)
    return acc


def a_times_s(p: FrodoParams, s: torch.Tensor, seed_a: torch.Tensor) -> torch.Tensor:
    """A.S with A made from seed_a: plain on the CPU, kernel K9 on the GPU."""
    if s.device.type == "cpu":
        return a_times_s_plain(p, s, seed_a)
    return frodo_cuda.a_times_s(p, s, seed_a)


def s_times_a(p: FrodoParams, sp: torch.Tensor, seed_a: torch.Tensor) -> torch.Tensor:
    """S'.A with A made from seed_a: plain on the CPU, kernel K10 on the GPU."""
    if sp.device.type == "cpu":
        return s_times_a_plain(p, sp, seed_a)
    return frodo_cuda.s_times_a(p, sp, seed_a)


def _a_times_s(p: FrodoParams, ctx: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A @ S: s (..., n, NBAR) -> (..., n, NBAR), A never held whole.  The
    SHAKE sets make A inside K9 (or its plain version); the AES sets expand
    A in row chunks and multiply each densely."""
    if not p.aes:
        return a_times_s(p, s, ctx)
    return torch.cat([_mat_mod(p, _gen_a_chunk(p, ctx, r, k), s)
                      for r, k in _aes_steps(p, ctx)], dim=-2)


def _s_times_a(p: FrodoParams, sp: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """S' @ A: sp (..., NBAR, n) -> (..., NBAR, n); routed as :func:`_a_times_s`."""
    if not p.aes:
        return s_times_a(p, sp, ctx)
    acc = torch.zeros(sp.shape[:-1] + (p.n,), dtype=torch.int32, device=sp.device)
    for r, k in _aes_steps(p, ctx):
        acc = (acc + _mat_mod(p, sp[..., r : r + k], _gen_a_chunk(p, ctx, r, k))) & (p.q - 1)
    return acc


# -- KEM ---------------------------------------------------------------------


def keygen(p: FrodoParams, s: torch.Tensor, seed_se: torch.Tensor, z: torch.Tensor):
    """(..., len_sec) x3 uint8 -> (pk (..., pk_len), sk (..., sk_len))."""
    batch = z.shape[:-1]
    seed_a = _shake(p, z, 16)
    ctx = _a_ctx(p, seed_a)
    r = _le16(_shake(p, _prefixed(0x5F, seed_se), 4 * p.n * NBAR))
    se = _sample(p, r)  # S^T then E, one sampler launch
    st = se[..., : p.n * NBAR].reshape(batch + (NBAR, p.n))
    e = se[..., p.n * NBAR :].reshape(batch + (p.n, NBAR))
    b_mat = (_a_times_s(p, ctx, st.transpose(-1, -2)) + e) & (p.q - 1)
    pk = torch.cat([seed_a, _pack(p, b_mat.reshape(batch + (-1,)))], dim=-1)
    pkh = _shake(p, pk, p.len_sec)
    # stored as centered signed int16 (v - q when v >= q/2), like the spec
    st_c = st.reshape(batch + (-1,))
    st_bytes = _to_le16((st_c - torch.where(st_c >= p.q // 2, p.q, 0)) & 0xFFFF)
    return pk, torch.cat([s, pk, st_bytes, pkh], dim=-1)


def _encaps_noise(p: FrodoParams, mu: torch.Tensor, pkh: torch.Tensor):
    """Deterministic encaps randomness: -> (sp, ep, epp, k)."""
    batch = mu.shape[:-1]
    se_k = _shake(p, torch.cat([pkh, mu], dim=-1), 2 * p.len_sec)
    seed_se, k = se_k[..., : p.len_sec], se_k[..., p.len_sec :]
    r = _le16(_shake(p, _prefixed(0x96, seed_se), (2 * NBAR * p.n + NBAR * NBAR) * 2))
    e = _sample(p, r)  # S', E', E'' in one sampler launch
    sp = e[..., : NBAR * p.n].reshape(batch + (NBAR, p.n))
    ep = e[..., NBAR * p.n : 2 * NBAR * p.n].reshape(batch + (NBAR, p.n))
    epp = e[..., 2 * NBAR * p.n :].reshape(batch + (NBAR, NBAR))
    return sp, ep, epp, k


def _assemble_ct(p: FrodoParams, sp: torch.Tensor, bp: torch.Tensor, b_mat: torch.Tensor,
                 epp: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Shared encaps tail: B' and the unpacked B matrix -> packed ct."""
    batch = mu.shape[:-1]
    v = (_mat_mod(p, sp, b_mat) + epp) & (p.q - 1)
    c = (v.reshape(batch + (-1,)) + _encode(p, mu)) & (p.q - 1)
    return torch.cat([_pack(p, bp.reshape(batch + (-1,))), _pack(p, c)], dim=-1)


def _reencrypt(p: FrodoParams, pk: torch.Tensor, mu: torch.Tensor, pkh: torch.Tensor):
    """Shared encaps core: -> (ct, k)."""
    batch = mu.shape[:-1]
    sp, ep, epp, k = _encaps_noise(p, mu, pkh)
    bp = (_s_times_a(p, sp, _a_ctx(p, pk[..., :16])) + ep) & (p.q - 1)
    b_mat = _unpack(p, pk[..., 16:]).reshape(batch + (p.n, NBAR))
    return _assemble_ct(p, sp, bp, b_mat, epp, mu), k


def encaps(p: FrodoParams, pk: torch.Tensor, mu: torch.Tensor):
    """pk (..., pk_len), mu (..., len_sec) -> (ct (..., ct_len), ss (..., len_sec))."""
    ct, k = _reencrypt(p, pk, mu, _shake(p, pk, p.len_sec))
    return ct, _shake(p, torch.cat([ct, k], dim=-1), p.len_sec)


def decaps(p: FrodoParams, sk: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """sk (..., sk_len), ct (..., ct_len) -> ss (..., len_sec), with implicit
    rejection (a branch-free select of k' or s)."""
    batch = ct.shape[:-1]
    s = sk[..., : p.len_sec]
    pk = sk[..., p.len_sec : p.len_sec + p.pk_len]
    st_off = p.len_sec + p.pk_len
    pkh = sk[..., st_off + 2 * NBAR * p.n :]
    # signed-LE16 mod q == raw 16-bit value masked, since q | 2^16
    st = (_le16(sk[..., st_off : st_off + 2 * NBAR * p.n]) & (p.q - 1)).reshape(
        batch + (NBAR, p.n))
    c1_len = NBAR * p.n * p.d // 8
    bp = _unpack(p, ct[..., :c1_len]).reshape(batch + (NBAR, p.n))
    c = _unpack(p, ct[..., c1_len:])
    bps = _mat_mod(p, bp, st.transpose(-1, -2))
    mu_p = _decode(p, (c - bps.reshape(batch + (-1,))) & (p.q - 1))
    ct2, kp = _reencrypt(p, pk, mu_p, pkh)
    ok = (ct == ct2).all(dim=-1, keepdim=True)
    return _shake(p, torch.cat([ct, torch.where(ok, kp, s)], dim=-1), p.len_sec)


@functools.cache
def get(name: str):
    """(keygen, encaps, decaps) for a parameter-set name."""
    p = PARAMS[name]
    return (functools.partial(keygen, p), functools.partial(encaps, p),
            functools.partial(decaps, p))


# -- per-key precompute (the operand cache, provider/opcache.py) --------------


def precompute_pk(p: FrodoParams, pk: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-key state that encaps reuses: A made whole (int32, 7.2 MB a key
    at n = 1344), the unpacked B and H(pk).  May be unbatched; broadcasts
    against any batch of mu.  The SHAKE rows are one sponge call (K1)."""
    ctx = _a_ctx(p, pk[..., :16])
    steps = _aes_steps(p, ctx) if p.aes else [(0, p.n)]
    a_mat = torch.cat([_gen_a_chunk(p, ctx, r, k) for r, k in steps], dim=-2)
    b_mat = _unpack(p, pk[..., 16:]).reshape(pk.shape[:-1] + (p.n, NBAR))
    return {"a": a_mat, "b": b_mat, "pkh": _shake(p, pk, p.len_sec)}


def precompute_from_numpy(pre: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The reference's ``precompute_pk`` dict (numpy: ``a`` (n, n) int32,
    ``b`` (n, NBAR) int32, ``pkh`` (len_sec,) uint8, or batched forms of
    them) as the port's, on ``device``."""
    dtypes = {"a": torch.int32, "b": torch.int32, "pkh": torch.uint8}
    return {name: torch.tensor(np.asarray(pre[name]), dtype=dt, device=device)
            for name, dt in dtypes.items()}


def encaps_pre(p: FrodoParams, pre: dict[str, torch.Tensor], mu: torch.Tensor):
    """``encaps`` over a ``precompute_pk`` dict: bit-identical output.  With
    one key's A, S'.A of the whole batch is one (B*8, n) @ (n, n) product."""
    batch = mu.shape[:-1]
    sp, ep, epp, k = _encaps_noise(p, mu, pre["pkh"].expand(batch + (p.len_sec,)))
    bp = (_mat_mod(p, sp, pre["a"]) + ep) & (p.q - 1)
    ct = _assemble_ct(p, sp, bp, pre["b"], epp, mu)
    return ct, _shake(p, torch.cat([ct, k], dim=-1), p.len_sec)


def encaps_cold(p: FrodoParams, pk: torch.Tensor, mu: torch.Tensor):
    """Cache-filling encaps: the per-key state and the op results at once."""
    pre = precompute_pk(p, pk)
    ct, ss = encaps_pre(p, pre, mu)
    return pre, ct, ss


@functools.cache
def get_pre(name: str):
    """(encaps_cold, encaps_pre) for the operand cache (provider/opcache.py)."""
    p = PARAMS[name]
    return functools.partial(encaps_cold, p), functools.partial(encaps_pre, p)
