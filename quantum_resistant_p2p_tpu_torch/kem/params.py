"""ML-KEM parameter sets and NTT constant tables (FIPS 203 §4.3, §8).

The port's own copy: the tables are computed here from their definitions,
zeta_i = 17^bitrev7(i) mod q and gamma_i = 17^(2*bitrev7(i) + 1) mod q.
"""

from __future__ import annotations

from dataclasses import dataclass

Q = 3329
N = 256
N_INV = pow(128, -1, Q)  # 3303: the NTT has 128 base pairs


@dataclass(frozen=True)
class MLKEMParams:
    name: str
    k: int
    eta1: int
    eta2: int
    du: int
    dv: int

    @property
    def ek_len(self) -> int:
        return 384 * self.k + 32

    @property
    def dk_len(self) -> int:
        return 768 * self.k + 96

    @property
    def ct_len(self) -> int:
        return 32 * (self.du * self.k + self.dv)


MLKEM512 = MLKEMParams("ML-KEM-512", k=2, eta1=3, eta2=2, du=10, dv=4)
MLKEM768 = MLKEMParams("ML-KEM-768", k=3, eta1=2, eta2=2, du=10, dv=4)
MLKEM1024 = MLKEMParams("ML-KEM-1024", k=4, eta1=2, eta2=2, du=11, dv=5)

PARAMS = {p.name: p for p in (MLKEM512, MLKEM768, MLKEM1024)}


def _bitrev7(i: int) -> int:
    return int(f"{i:07b}"[::-1], 2)


ZETAS = tuple(pow(17, _bitrev7(i), Q) for i in range(128))
GAMMAS = tuple(pow(17, 2 * _bitrev7(i) + 1, Q) for i in range(128))
