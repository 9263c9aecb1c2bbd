"""FrodoKEM parameter sets (round-3 / ISO specification).

The port's own copy: n x n LWE matrices with nbar = mbar = 8, q = 2^d,
A expanded from seed_A by AES-128 (the -AES sets) or SHAKE-128 (the -SHAKE
sets), and the error distribution given by its CDF table.
"""

from __future__ import annotations

from dataclasses import dataclass

NBAR = 8


@dataclass(frozen=True)
class FrodoParams:
    name: str
    n: int
    d: int  # q = 2^d
    b: int  # bits extracted per coefficient
    len_sec: int  # bytes of s / seedSE / z / pkh / mu / ss
    cdf: tuple[int, ...]
    aes: bool  # True: AES-128 matrix expansion, False: SHAKE-128

    @property
    def q(self) -> int:
        return 1 << self.d

    @property
    def pk_len(self) -> int:
        return 16 + self.n * NBAR * self.d // 8

    @property
    def sk_len(self) -> int:
        return self.len_sec + self.pk_len + 2 * self.n * NBAR + self.len_sec

    @property
    def ct_len(self) -> int:
        return (NBAR * self.n + NBAR * NBAR) * self.d // 8


_CDF640 = (4643, 13363, 20579, 25843, 29227, 31145, 32103, 32525, 32689,
           32745, 32762, 32766, 32767)
_CDF976 = (5638, 15915, 23689, 28571, 31116, 32217, 32613, 32731, 32760,
           32766, 32767)
_CDF1344 = (9142, 23462, 30338, 32361, 32725, 32765, 32767)

FRODO640AES = FrodoParams("FrodoKEM-640-AES", 640, 15, 2, 16, _CDF640, True)
FRODO640SHAKE = FrodoParams("FrodoKEM-640-SHAKE", 640, 15, 2, 16, _CDF640, False)
FRODO976AES = FrodoParams("FrodoKEM-976-AES", 976, 16, 3, 24, _CDF976, True)
FRODO976SHAKE = FrodoParams("FrodoKEM-976-SHAKE", 976, 16, 3, 24, _CDF976, False)
FRODO1344AES = FrodoParams("FrodoKEM-1344-AES", 1344, 16, 4, 32, _CDF1344, True)
FRODO1344SHAKE = FrodoParams("FrodoKEM-1344-SHAKE", 1344, 16, 4, 32, _CDF1344, False)

PARAMS = {p.name: p for p in (FRODO640AES, FRODO640SHAKE, FRODO976AES, FRODO976SHAKE,
                              FRODO1344AES, FRODO1344SHAKE)}

# the published sizes (pk, sk, ct) of the three levels
assert (FRODO640AES.pk_len, FRODO640AES.sk_len, FRODO640AES.ct_len) == (9616, 19888, 9720)
assert (FRODO976AES.pk_len, FRODO976AES.sk_len, FRODO976AES.ct_len) == (15632, 31296, 15744)
assert (FRODO1344AES.pk_len, FRODO1344AES.sk_len, FRODO1344AES.ct_len) == (21520, 43088, 21632)
