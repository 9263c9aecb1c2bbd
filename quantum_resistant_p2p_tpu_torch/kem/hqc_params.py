"""HQC parameter sets and code tables (round-4 shape).

The port's own copy: quasi-cyclic vectors of n bits, an outer Reed-Solomon
code [n1, k] over GF(2^8) (field polynomial 0x11D, generator alpha = 2)
correcting delta byte errors, and an inner Reed-Muller RM(1,7) code of
128 bits repeated ``dup`` times.  w and wr are the weights of the secret
and of the encryption randomness.
"""

from __future__ import annotations

from dataclasses import dataclass

RM_N = 128  # inner RM(1,7) length


@dataclass(frozen=True)
class HQCParams:
    name: str
    n: int
    n1: int  # RS length (bytes)
    k: int  # message bytes
    delta: int  # RS correction capability
    dup: int  # RM duplication (n2 = 128 * dup)
    w: int
    wr: int

    @property
    def n2(self) -> int:
        return RM_N * self.dup

    @property
    def n_bytes(self) -> int:
        return (self.n + 7) // 8

    @property
    def n1n2_bytes(self) -> int:
        return self.n1 * self.n2 // 8

    @property
    def pk_len(self) -> int:
        return 40 + self.n_bytes

    @property
    def sk_len(self) -> int:
        return 40 + self.k + self.pk_len

    @property
    def ct_len(self) -> int:
        return self.n_bytes + self.n1n2_bytes + 16

    @property
    def ss_len(self) -> int:
        return 64


HQC128 = HQCParams("HQC-128", n=17669, n1=46, k=16, delta=15, dup=3, w=66, wr=75)
HQC192 = HQCParams("HQC-192", n=35851, n1=56, k=24, delta=16, dup=5, w=100, wr=114)
HQC256 = HQCParams("HQC-256", n=57637, n1=90, k=32, delta=29, dup=5, w=131, wr=149)

PARAMS = {p.name: p for p in (HQC128, HQC192, HQC256)}

# the published sizes (pk, sk, ct) of the three levels
assert (HQC128.pk_len, HQC128.sk_len, HQC128.ct_len) == (2249, 2305, 4433)
assert (HQC192.pk_len, HQC192.sk_len, HQC192.ct_len) == (4522, 4586, 8978)
assert (HQC256.pk_len, HQC256.sk_len, HQC256.ct_len) == (7245, 7317, 14421)


def _build_gf() -> tuple[list[int], list[int]]:
    """alpha^i for i < 512 (wrapping at 255) and the discrete log of 1..255."""
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


_GF_EXP, _GF_LOG = _build_gf()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _GF_EXP[_GF_LOG[a] + _GF_LOG[b]]


def _rs_gen_poly(p: HQCParams) -> list[int]:
    """g(x) = prod_{i=1..2delta} (x - alpha^i); low-degree-first coeffs."""
    g = [1]
    for i in range(1, 2 * p.delta + 1):
        root = _GF_EXP[i]
        ng = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            ng[j] ^= gf_mul(c, root)
            ng[j + 1] ^= c
        g = ng
    return g


def _rm_encode_byte(b: int) -> int:
    """byte -> 128-bit RM(1,7) codeword (int, bit j = position j): bit 0 of
    the byte on the all-ones row, bit t + 1 on the row of j's bit t."""
    cw = 0
    for j in range(RM_N):
        bit = b & 1
        for t in range(7):
            if (b >> (t + 1)) & 1 and (j >> t) & 1:
                bit ^= 1
        cw |= bit << j
    return cw


_RM_ENC_TABLE = [_rm_encode_byte(b) for b in range(256)]
