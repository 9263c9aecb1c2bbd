"""ML-DSA parameter sets and the NTT constant table (FIPS 204 §4, §7.5).

The port's own copy: the table is computed here from its definition,
zeta_i = 1753^bitrev8(i) mod q, as the spec defines it.
"""

from __future__ import annotations

from dataclasses import dataclass

Q = 8380417
N = 256
D = 13  # bits dropped from t by Power2Round
ZETA = 1753  # a primitive 512th root of unity mod q
N_INV = pow(N, -1, Q)  # 8347681: the inverse NTT's final scale


@dataclass(frozen=True)
class MLDSAParams:
    name: str
    k: int
    l: int  # noqa: E741  (the spec's name)
    eta: int
    tau: int
    gamma1: int
    gamma2: int
    omega: int
    lambda_: int  # collision strength in bits; ctilde is lambda/4 bytes

    @property
    def beta(self) -> int:
        return self.tau * self.eta

    @property
    def ctilde_len(self) -> int:
        return self.lambda_ // 4

    @property
    def z_bits(self) -> int:
        return 1 + (self.gamma1 - 1).bit_length()  # 18 or 20

    @property
    def w1_bits(self) -> int:
        return ((Q - 1) // (2 * self.gamma2) - 1).bit_length()  # 6 or 4

    @property
    def s_bits(self) -> int:
        return (2 * self.eta).bit_length()  # 3 (eta 2) or 4 (eta 4)

    @property
    def pk_len(self) -> int:
        return 32 + 32 * (23 - D) * self.k

    @property
    def sk_len(self) -> int:
        return 128 + 32 * self.s_bits * (self.k + self.l) + 32 * D * self.k

    @property
    def sig_len(self) -> int:
        return self.ctilde_len + 32 * self.z_bits * self.l + self.omega + self.k


MLDSA44 = MLDSAParams("ML-DSA-44", k=4, l=4, eta=2, tau=39, gamma1=1 << 17,
                      gamma2=(Q - 1) // 88, omega=80, lambda_=128)
MLDSA65 = MLDSAParams("ML-DSA-65", k=6, l=5, eta=4, tau=49, gamma1=1 << 19,
                      gamma2=(Q - 1) // 32, omega=55, lambda_=192)
MLDSA87 = MLDSAParams("ML-DSA-87", k=8, l=7, eta=2, tau=60, gamma1=1 << 19,
                      gamma2=(Q - 1) // 32, omega=75, lambda_=256)

PARAMS = {p.name: p for p in (MLDSA44, MLDSA65, MLDSA87)}


def _bitrev8(i: int) -> int:
    return int(f"{i:08b}"[::-1], 2)


ZETAS = tuple(pow(ZETA, _bitrev8(i), Q) for i in range(N))
