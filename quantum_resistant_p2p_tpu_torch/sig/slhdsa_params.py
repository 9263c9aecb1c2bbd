"""SLH-DSA / SPHINCS+-SHA2 'simple' parameter sets (FIPS 205) and the two
variable-length message hashes the provider runs on the host.

The port's own copy of what ``quantum_resistant_p2p_tpu/sig/sphincs.py``
takes from the reference's pure-Python SLH-DSA: the parameter sets, the
Winternitz parameter, the ADRS type constants, and PRF_msg / H_msg (FIPS 205
§11.2.1-11.2.2) on ``hashlib`` and ``hmac``.

Security-category hash split (FIPS 205 §11.2): F and PRF use SHA-256 in
every set; H, T_l, H_msg and PRF_msg use SHA-256 for the 128-bit sets and
SHA-512 for the 192/256-bit sets.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

LG_W = 4
W = 16

# ADRS types (FIPS 205 §4.2)
WOTS_HASH, WOTS_PK, TREE, FORS_TREE, FORS_ROOTS, WOTS_PRF, FORS_PRF = range(7)


@dataclass(frozen=True)
class SLHDSAParams:
    name: str
    n: int
    h: int
    d: int
    hp: int  # h' = h/d
    a: int
    k: int
    m: int

    @property
    def len1(self) -> int:
        return 2 * self.n

    @property
    def len2(self) -> int:
        return 3

    @property
    def wots_len(self) -> int:
        return self.len1 + self.len2

    @property
    def pk_len(self) -> int:
        return 2 * self.n

    @property
    def sk_len(self) -> int:
        return 4 * self.n

    @property
    def sig_len(self) -> int:
        # R + FORS(k*(1+a)*n) + HT(d*(wots_len+hp)*n)
        return self.n * (1 + self.k * (1 + self.a) + self.d * (self.wots_len + self.hp))

    @property
    def big_hash(self) -> bool:
        """True -> H/T/H_msg/PRF_msg use SHA-512 (security categories 3, 5)."""
        return self.n > 16


SLH128S = SLHDSAParams("SPHINCS+-SHA2-128s-simple", n=16, h=63, d=7, hp=9, a=12, k=14, m=30)
SLH128F = SLHDSAParams("SPHINCS+-SHA2-128f-simple", n=16, h=66, d=22, hp=3, a=6, k=33, m=34)
SLH192S = SLHDSAParams("SPHINCS+-SHA2-192s-simple", n=24, h=63, d=7, hp=9, a=14, k=17, m=39)
SLH192F = SLHDSAParams("SPHINCS+-SHA2-192f-simple", n=24, h=66, d=22, hp=3, a=8, k=33, m=42)
SLH256S = SLHDSAParams("SPHINCS+-SHA2-256s-simple", n=32, h=64, d=8, hp=8, a=14, k=22, m=47)
SLH256F = SLHDSAParams("SPHINCS+-SHA2-256f-simple", n=32, h=68, d=17, hp=4, a=9, k=35, m=49)

PARAMS = {p.name: p for p in (SLH128S, SLH128F, SLH192S, SLH192F, SLH256S, SLH256F)}


def _sha(big: bool, data: bytes) -> bytes:
    return (hashlib.sha512 if big else hashlib.sha256)(data).digest()


def _mgf1(big: bool, seed: bytes, length: int) -> bytes:
    hlen = 64 if big else 32
    out = b""
    for c in range((length + hlen - 1) // hlen):
        out += _sha(big, seed + c.to_bytes(4, "big"))
    return out[:length]


def prf_msg(p: SLHDSAParams, sk_prf: bytes, opt_rand: bytes, msg: bytes) -> bytes:
    """PRF_msg = HMAC-SHA-X(sk_prf, opt_rand || M), truncated to n bytes."""
    h = hashlib.sha512 if p.big_hash else hashlib.sha256
    return hmac.new(sk_prf, opt_rand + msg, h).digest()[: p.n]


def h_msg(p: SLHDSAParams, r: bytes, pk_seed: bytes, pk_root: bytes, msg: bytes) -> bytes:
    """H_msg = MGF1-SHA-X(R || pk_seed || SHA-X(R || pk_seed || pk_root || M), m)."""
    inner = _sha(p.big_hash, r + pk_seed + pk_root + msg)
    return _mgf1(p.big_hash, r + pk_seed + inner, p.m)
