"""Batched SLH-DSA / SPHINCS+-SHA2 'simple' (FIPS 205) in PyTorch.

Counterpart of ``quantum_resistant_p2p_tpu/sig/sphincs.py``, function for
function and byte for byte.  Every function takes uint8 tensors with a
leading batch dim and runs where they lie: every hash is a SHA-256 or
SHA-512 compression of ``core.sha256`` / ``core.sha512``, so on a CUDA
tensor all hashing runs in kernels K12 and K13 and on a CPU tensor in their
plain versions.

The layout is the reference's lock-step one:

* F and PRF resume the midstate of the constant first block
  ``pk_seed || zero pad`` (FIPS 205 §11.2.1), computed once per call; H and
  T_l of the 192/256-bit sets resume a SHA-512 midstate the same way.
* WOTS+ chains run as W - 1 = 15 steps over all chains at once, each chain
  masked in or out of a step by its digit.
* An XMSS tree hashes all 2^h' leaves at once, then h' halving levels;
  FORS hashes all k * 2^a leaves at once.  Auth paths are gathers.
* The hypertree's tree index is an LSB-first bit array; each layer's leaf
  index and 8-byte ADRS tree field are slices of it.
* H_msg and PRF_msg run on the host in the provider; the functions here
  take the m-byte digest.  Signing is deterministic given (sk, R, digest).

The reference has two sign paths that give the same bytes, the second
(``sign_digest_layered``) only because its monolithic programs did not
compile for the s-sets on the TPU.  The port has one, :func:`sign_digest`.
One loop differs in form from the reference: :func:`_fors_pk_from_sig`
climbs all k FORS trees at once over a (..., k) axis instead of one tree
after another, with the same bytes.
"""

from __future__ import annotations

import functools

import torch

from ..core import sha256, sha512
from .slhdsa_params import (FORS_PRF, FORS_ROOTS, FORS_TREE, PARAMS, TREE, W,  # noqa: F401
                            WOTS_HASH, WOTS_PK, WOTS_PRF, SLHDSAParams)

# --------------------------------------------------------------------------
# ADRS construction (compressed 22-byte SHA2 form, FIPS 205 §11.2)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _const(device: torch.device, values: tuple[int, ...], dtype=torch.uint8) -> torch.Tensor:
    """A small constant tensor, kept per device: a tensor built from Python
    values on a GPU is a host-to-device copy that waits for the stream, so
    the hash calls never build one."""
    return torch.tensor(values, dtype=dtype, device=device)


def _be4(x, lead: tuple[int, ...], device) -> torch.Tensor:
    """int or integer tensor -> (..., 4) uint8 big-endian, broadcast to lead."""
    if isinstance(x, int):
        return _const(device, tuple(x.to_bytes(4, "big"))).expand(lead + (4,))
    shifts = _const(device, (24, 16, 8, 0), torch.int64)
    return ((x[..., None] >> shifts) & 0xFF).to(torch.uint8).expand(lead + (4,))


def _fit(a: torch.Tensor, lead_ndim: int) -> torch.Tensor:
    """Insert singleton dims so a (B..., k) tensor broadcasts over lead dims."""
    extra = lead_ndim - (a.dim() - 1)
    if extra < 0:
        raise ValueError("tensor has more batch dims than target")
    return a.reshape(a.shape[:-1] + (1,) * extra + a.shape[-1:]) if extra else a


def _adrs(lead: tuple[int, ...], layer: int, tree8, typ: int, w1, w2, w3,
          device) -> torch.Tensor:
    """(..., 22) uint8 compressed ADRS broadcast over the lead dims:
    layer (1 byte), tree (8), type (1), then three 4-byte words."""
    def byte(v: int) -> torch.Tensor:
        return _const(device, (v,)).expand(lead + (1,))

    tb = _const(device, (0,) * 8) if tree8 is None else _fit(tree8, len(lead))
    return torch.cat([byte(layer), tb.expand(lead + (8,)), byte(typ), _be4(w1, lead, device),
                      _be4(w2, lead, device), _be4(w3, lead, device)], dim=-1)


# --------------------------------------------------------------------------
# Hash engines with precomputed pk_seed midstates
# --------------------------------------------------------------------------


class _Ctx:
    """Per-call context: params + pk_seed midstates (batch shape B)."""

    def __init__(self, p: SLHDSAParams, pk_seed: torch.Tensor):
        self.p = p
        self.batch = tuple(pk_seed.shape[:-1])
        self.device = pk_seed.device
        pad256 = torch.zeros(self.batch + (64 - p.n,), dtype=torch.uint8, device=self.device)
        self.mid_f = sha256.midstate(torch.cat([pk_seed, pad256], dim=-1))
        if p.big_hash:
            pad512 = torch.zeros(self.batch + (128 - p.n,), dtype=torch.uint8,
                                 device=self.device)
            self.mid_t = sha512.midstate(torch.cat([pk_seed, pad512], dim=-1))

    def f(self, adrs: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """F / PRF (always SHA-256): adrs (..., 22), m (..., n) -> (..., n)."""
        data = torch.cat([adrs, m], dim=-1)
        mid = _fit(self.mid_f, data.dim() - 1)  # broadcast, not copied
        return sha256.sha256_from_midstate(mid, data, 1)[..., : self.p.n]

    def t(self, adrs: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """H / T_l: SHA-256 (n = 16) or SHA-512 (n = 24/32)."""
        if not self.p.big_hash:
            return self.f(adrs, m)
        data = torch.cat([adrs, m], dim=-1)
        mid = _fit(self.mid_t, data.dim() - 1)
        return sha512.sha512_from_midstate(mid, data, 1)[..., : self.p.n]

    def arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.device)


# --------------------------------------------------------------------------
# WOTS+ (FIPS 205 §5), all chains in lock-step
# --------------------------------------------------------------------------


def _wots_digits(p: SLHDSAParams, m: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 -> (..., wots_len) int64 base-16 digits + checksum."""
    m = m.to(torch.int64)
    nib = torch.stack([m >> 4, m & 0xF], dim=-1).reshape(m.shape[:-1] + (p.len1,))
    csum = (W - 1 - nib).sum(-1) << 4
    cs = torch.stack([(csum >> 12) & 0xF, (csum >> 8) & 0xF, (csum >> 4) & 0xF], dim=-1)
    return torch.cat([nib, cs], dim=-1)


def _chain(ctx: _Ctx, x: torch.Tensor, d: torch.Tensor, from_start: bool, layer: int,
           tree8, kp) -> torch.Tensor:
    """Lock-step chains: x (..., wots_len, n), d (..., wots_len) digits.

    from_start=True  -> apply F at steps t < d   (sign: 0 -> d)
    from_start=False -> apply F at steps t >= d  (verify: d -> W-1)
    """
    lead = tuple(x.shape[:-1])
    chains = ctx.arange(ctx.p.wots_len)
    for t in range(W - 1):
        adrs = _adrs(lead, layer, tree8, WOTS_HASH, kp, chains, t, ctx.device)
        fx = ctx.f(adrs, x)
        active = (t < d) if from_start else (t >= d)
        x = torch.where(active[..., None], fx, x)
    return x


def _wots_sk(ctx: _Ctx, sk_seed: torch.Tensor, layer: int, tree8, kp, lead) -> torch.Tensor:
    """Secret chain heads: (..., wots_len, n)."""
    p = ctx.p
    adrs = _adrs(lead, layer, tree8, WOTS_PRF, kp, ctx.arange(p.wots_len), 0, ctx.device)
    seed = _fit(sk_seed, len(lead)).expand(lead + (p.n,))
    return ctx.f(adrs, seed)


def _wots_pkgen(ctx: _Ctx, sk_seed: torch.Tensor, layer: int, tree8, kp,
                lead) -> torch.Tensor:
    """kp (..., leaves) -> compressed WOTS pk (..., leaves, n)."""
    p = ctx.p
    chain_lead = lead + (p.wots_len,)
    sk = _wots_sk(ctx, sk_seed, layer, tree8, kp[..., None], chain_lead)
    full = torch.full(chain_lead, W - 1, dtype=torch.int64, device=ctx.device)
    tips = _chain(ctx, sk, full, True, layer, tree8, kp[..., None])
    tmp = tips.reshape(lead + (p.wots_len * p.n,))
    return ctx.t(_adrs(lead, layer, tree8, WOTS_PK, kp, 0, 0, ctx.device), tmp)


# --------------------------------------------------------------------------
# XMSS (FIPS 205 §6)
# --------------------------------------------------------------------------


def _xmss_levels(ctx: _Ctx, sk_seed: torch.Tensor, layer: int, tree8) -> list[torch.Tensor]:
    """All tree levels: levels[z] has shape (B, 2^(hp-z), n)."""
    p = ctx.p
    nl = 1 << p.hp
    leaves = _wots_pkgen(ctx, sk_seed, layer, tree8, ctx.arange(nl), ctx.batch + (nl,))
    levels = [leaves]
    node = leaves
    for z in range(1, p.hp + 1):
        pairs = node.reshape(ctx.batch + (node.shape[-2] // 2, 2 * p.n))
        width = pairs.shape[-2]
        adrs = _adrs(ctx.batch + (width,), layer, tree8, TREE, 0, z, ctx.arange(width),
                     ctx.device)
        node = ctx.t(adrs, pairs)
        levels.append(node)
    return levels


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., R, n), idx (...,) -> (..., n): row idx of each batch entry."""
    index = idx[..., None, None].expand(idx.shape + (1, x.shape[-1]))
    return torch.gather(x, -2, index)[..., 0, :]


def _xmss_sign(ctx: _Ctx, m: torch.Tensor, sk_seed: torch.Tensor, idx: torch.Tensor,
               layer: int, tree8) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (sig_xmss (B, (wots_len+hp)*n), root (B, n)); idx (B,) int64."""
    p = ctx.p
    levels = _xmss_levels(ctx, sk_seed, layer, tree8)
    digits = _wots_digits(p, m)
    chain_lead = ctx.batch + (p.wots_len,)
    sk = _wots_sk(ctx, sk_seed, layer, tree8, idx[..., None], chain_lead)
    sig_w = _chain(ctx, sk, digits, True, layer, tree8, idx[..., None])
    auth = [_gather_rows(levels[j], (idx >> j) ^ 1) for j in range(p.hp)]
    sig = torch.cat([sig_w.reshape(ctx.batch + (p.wots_len * p.n,))] + auth, dim=-1)
    return sig, levels[p.hp][..., 0, :]


def _xmss_pk_from_sig(ctx: _Ctx, idx: torch.Tensor, sig_xmss: torch.Tensor,
                      m: torch.Tensor, layer: int, tree8) -> torch.Tensor:
    p = ctx.p
    wlen = p.wots_len * p.n
    sig_w = sig_xmss[..., :wlen].reshape(ctx.batch + (p.wots_len, p.n))
    digits = _wots_digits(p, m)
    tips = _chain(ctx, sig_w, digits, False, layer, tree8, idx[..., None])
    pk_adrs = _adrs(ctx.batch, layer, tree8, WOTS_PK, idx, 0, 0, ctx.device)
    node = ctx.t(pk_adrs, tips.reshape(ctx.batch + (wlen,)))
    for k in range(p.hp):
        sib = sig_xmss[..., wlen + k * p.n: wlen + (k + 1) * p.n]
        bit = ((idx >> k) & 1).bool()
        adrs = _adrs(ctx.batch, layer, tree8, TREE, 0, k + 1, idx >> (k + 1), ctx.device)
        pair = torch.where(bit[..., None], torch.cat([sib, node], dim=-1),
                           torch.cat([node, sib], dim=-1))
        node = ctx.t(adrs, pair)
    return node


# --------------------------------------------------------------------------
# Hypertree index plumbing: the tree index as an LSB-first bit array
# --------------------------------------------------------------------------


def _msb_bits(b: torch.Tensor) -> torch.Tensor:
    """(..., L) uint8 -> (..., 8L) int64 bits, most significant first."""
    shifts = torch.arange(7, -1, -1, device=b.device)
    return ((b.to(torch.int64)[..., None] >> shifts) & 1).reshape(b.shape[:-1] + (-1,))


def _digest_split(p: SLHDSAParams, digest: torch.Tensor):
    """digest (B, m) -> (md (B, ka), tree_bits (B, h-hp) lsb-first, leaf (B,))."""
    ka = (p.k * p.a + 7) // 8
    t = (p.h - p.hp + 7) // 8
    u = (p.hp + 7) // 8
    md = digest[..., :ka]
    tree_bits = _msb_bits(digest[..., ka: ka + t]).flip(-1)[..., : p.h - p.hp]
    lbits = _msb_bits(digest[..., ka + t: ka + t + u]).flip(-1)[..., : p.hp]
    leaf = (lbits << torch.arange(p.hp, device=digest.device)).sum(-1)
    return md, tree_bits, leaf


def _tree8_at(p: SLHDSAParams, tree_bits: torch.Tensor, j: int) -> torch.Tensor:
    """8-byte BE ADRS tree field for hypertree layer j (idx_tree >> j*hp)."""
    bits = tree_bits[..., j * p.hp:][..., :64]
    pad = torch.zeros(bits.shape[:-1] + (64 - bits.shape[-1],), dtype=bits.dtype,
                      device=bits.device)
    le = torch.cat([bits, pad], dim=-1).reshape(bits.shape[:-1] + (8, 8))
    byte = (le << torch.arange(8, device=bits.device)).sum(-1)  # little-endian bytes
    return byte.flip(-1).to(torch.uint8)


def _leaf_at(p: SLHDSAParams, tree_bits: torch.Tensor, j: int) -> torch.Tensor:
    """Layer-j (>=1) leaf index: bits [(j-1)*hp, j*hp) of idx_tree."""
    bits = tree_bits[..., (j - 1) * p.hp: j * p.hp]
    return (bits << torch.arange(bits.shape[-1], device=bits.device)).sum(-1)


# --------------------------------------------------------------------------
# FORS (FIPS 205 §8)
# --------------------------------------------------------------------------


def _fors_indices(p: SLHDSAParams, md: torch.Tensor) -> torch.Tensor:
    """(B, ka) -> (B, k) int64 base-2^a digits, MSB-first per digit."""
    grp = _msb_bits(md)[..., : p.k * p.a].reshape(md.shape[:-1] + (p.k, p.a))
    return (grp << torch.arange(p.a - 1, -1, -1, device=md.device)).sum(-1)


def _fors_levels(ctx: _Ctx, sk_seed: torch.Tensor, tree8, idx_leaf):
    """levels[z]: (B, k, 2^(a-z), n) -- all k FORS trees in parallel; and
    the secret leaves (B, k, 2^a, n)."""
    p = ctx.p
    npos = 1 << p.a
    ti = ctx.arange(p.k)[:, None]
    gidx = (ti << p.a) + ctx.arange(npos)[None, :]  # (k, 2^a) global node indices
    lead = ctx.batch + (p.k, npos)
    kp = idx_leaf[..., None, None]
    prf_adrs = _adrs(lead, 0, tree8, FORS_PRF, kp, 0, gidx, ctx.device)
    seed = _fit(sk_seed, len(lead)).expand(lead + (p.n,))
    sk = ctx.f(prf_adrs, seed)
    node = ctx.f(_adrs(lead, 0, tree8, FORS_TREE, kp, 0, gidx, ctx.device), sk)
    levels = [node]
    for z in range(1, p.a + 1):
        width = node.shape[-2] // 2
        pairs = node.reshape(ctx.batch + (p.k, width, 2 * p.n))
        g = (ti << (p.a - z)) + ctx.arange(width)[None, :]
        adrs = _adrs(ctx.batch + (p.k, width), 0, tree8, FORS_TREE, kp, z, g, ctx.device)
        node = ctx.t(adrs, pairs)
        levels.append(node)
    return levels, sk


def _fors_sign(ctx: _Ctx, md: torch.Tensor, sk_seed: torch.Tensor, tree8, idx_leaf):
    """-> (sig_fors (B, k*(1+a)*n), indices (B, k), levels)."""
    p = ctx.p
    indices = _fors_indices(p, md)
    levels, sk = _fors_levels(ctx, sk_seed, tree8, idx_leaf)
    # per tree: its secret leaf, then the a auth nodes bottom up
    parts = [_gather_rows(sk, indices)] + [_gather_rows(levels[j], (indices >> j) ^ 1)
                                           for j in range(p.a)]
    sig = torch.stack(parts, dim=-2).reshape(ctx.batch + (p.k * (1 + p.a) * p.n,))
    return sig, indices, levels


def _fors_pk_from_sig(ctx: _Ctx, sig_fors: torch.Tensor, md: torch.Tensor, tree8,
                      idx_leaf) -> torch.Tensor:
    """The FORS public key from a FORS signature: the k trees climb at once,
    over a (..., k) axis."""
    p = ctx.p
    indices = _fors_indices(p, md)
    chunk = sig_fors.reshape(ctx.batch + (p.k, 1 + p.a, p.n))
    lead = ctx.batch + (p.k,)
    kp = idx_leaf[..., None]
    gidx = (ctx.arange(p.k) << p.a) + indices  # (B, k)
    node = ctx.f(_adrs(lead, 0, tree8, FORS_TREE, kp, 0, gidx, ctx.device), chunk[..., 0, :])
    for j in range(p.a):
        sib = chunk[..., 1 + j, :]
        bit = ((gidx >> j) & 1).bool()
        adrs = _adrs(lead, 0, tree8, FORS_TREE, kp, j + 1, gidx >> (j + 1), ctx.device)
        pair = torch.where(bit[..., None], torch.cat([sib, node], dim=-1),
                           torch.cat([node, sib], dim=-1))
        node = ctx.t(adrs, pair)
    pk_adrs = _adrs(ctx.batch, 0, tree8, FORS_ROOTS, idx_leaf, 0, 0, ctx.device)
    return ctx.t(pk_adrs, node.reshape(ctx.batch + (p.k * p.n,)))


# --------------------------------------------------------------------------
# SLH-DSA top level (the device functions take the fixed-size H_msg digest)
# --------------------------------------------------------------------------


def keygen(p: SLHDSAParams, sk_seed: torch.Tensor, sk_prf: torch.Tensor,
           pk_seed: torch.Tensor):
    """Three (B, n) seeds -> (pk (B, 2n), sk (B, 4n))."""
    ctx = _Ctx(p, pk_seed)
    tree8 = torch.zeros(ctx.batch + (8,), dtype=torch.uint8, device=ctx.device)
    levels = _xmss_levels(ctx, sk_seed, p.d - 1, tree8)
    pk = torch.cat([pk_seed, levels[p.hp][..., 0, :]], dim=-1)
    return pk, torch.cat([sk_seed, sk_prf, pk], dim=-1)


def sign_digest(p: SLHDSAParams, sk: torch.Tensor, r: torch.Tensor,
                digest: torch.Tensor) -> torch.Tensor:
    """sk (B, 4n), r (B, n) randomizer, digest (B, m) = H_msg -> sig (B, sig_len)."""
    sk_seed, pk_seed = sk[..., : p.n], sk[..., 2 * p.n: 3 * p.n]
    ctx = _Ctx(p, pk_seed)
    md, tree_bits, idx_leaf = _digest_split(p, digest)
    tree8 = _tree8_at(p, tree_bits, 0)
    sig_fors, _, _ = _fors_sign(ctx, md, sk_seed, tree8, idx_leaf)
    msg = _fors_pk_from_sig(ctx, sig_fors, md, tree8, idx_leaf)
    parts = [r, sig_fors]
    leaf = idx_leaf
    for j in range(p.d):
        sig_x, msg = _xmss_sign(ctx, msg, sk_seed, leaf, j, _tree8_at(p, tree_bits, j))
        parts.append(sig_x)
        if j + 1 < p.d:
            leaf = _leaf_at(p, tree_bits, j + 1)
    return torch.cat(parts, dim=-1)


def verify_digest(p: SLHDSAParams, pk: torch.Tensor, digest: torch.Tensor,
                  sig: torch.Tensor) -> torch.Tensor:
    """pk (B, 2n), digest (B, m), sig (B, sig_len) -> bool (B,)."""
    pk_seed, pk_root = pk[..., : p.n], pk[..., p.n:]
    ctx = _Ctx(p, pk_seed)
    md, tree_bits, idx_leaf = _digest_split(p, digest)
    fors_len = p.k * (1 + p.a) * p.n
    sig_fors = sig[..., p.n: p.n + fors_len]
    sig_ht = sig[..., p.n + fors_len:]
    node = _fors_pk_from_sig(ctx, sig_fors, md, _tree8_at(p, tree_bits, 0), idx_leaf)
    per = (p.wots_len + p.hp) * p.n
    leaf = idx_leaf
    for j in range(p.d):
        chunk = sig_ht[..., j * per: (j + 1) * per]
        node = _xmss_pk_from_sig(ctx, leaf, chunk, node, j, _tree8_at(p, tree_bits, j))
        if j + 1 < p.d:
            leaf = _leaf_at(p, tree_bits, j + 1)
    return (node == pk_root).all(-1)


# --------------------------------------------------------------------------
# Memory: how many signatures one sign call holds at once
# --------------------------------------------------------------------------

#: device bytes a row in flight holds at the widest step of a sign, with
#: room to spare: ADRS 22, data <= 54, padded block 64, state out 64,
#: digest 32, the level or chain value and its masked copy
BYTES_PER_ROW = 512


def rows_in_flight(p: SLHDSAParams) -> int:
    """Rows one signature puts through one hash call at the widest step: all
    FORS leaves, or all chains of an XMSS tree."""
    return max(p.k << p.a, p.wots_len << p.hp)


def signatures_per_chunk(p: SLHDSAParams, budget_bytes: int) -> int:
    """How many signatures one sign call may take within ``budget_bytes``."""
    return max(1, budget_bytes // (rows_in_flight(p) * BYTES_PER_ROW))


@functools.cache
def get(name: str):
    """(keygen, sign_digest, verify_digest) of a parameter set, plain functions."""
    p = PARAMS[name]
    return (functools.partial(keygen, p), functools.partial(sign_digest, p),
            functools.partial(verify_digest, p))
