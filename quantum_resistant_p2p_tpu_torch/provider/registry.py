"""Algorithm registry: canonical names to provider factories.

The backend is an orthogonal axis, "cuda" (the default) or "cpu".  There
is no "auto": a caller that asks for the GPU gets it or an error.
"""

from __future__ import annotations

from typing import Callable

from .base import BACKENDS, KeyExchangeAlgorithm, SignatureAlgorithm
from .kem_providers import MLKEMKeyExchange
from .sig_providers import MLDSASignature

# name -> factory(backend) -> algorithm
_KEMS: dict[str, Callable[[str], KeyExchangeAlgorithm]] = {}
_SIGS: dict[str, Callable[[str], SignatureAlgorithm]] = {}


def _get(table: dict, kind: str, name: str, backend: str):
    if name not in table:
        raise KeyError(f"unknown {kind} {name!r}; known: {sorted(table)}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
    return table[name](backend)


def register_kem(name: str, factory: Callable[[str], KeyExchangeAlgorithm]) -> None:
    _KEMS[name] = factory


def get_kem(name: str, backend: str = "cuda") -> KeyExchangeAlgorithm:
    return _get(_KEMS, "KEM", name, backend)


def list_kems() -> list[str]:
    return sorted(_KEMS)


def register_signature(name: str, factory: Callable[[str], SignatureAlgorithm]) -> None:
    _SIGS[name] = factory


def get_signature(name: str, backend: str = "cuda") -> SignatureAlgorithm:
    return _get(_SIGS, "signature", name, backend)


def list_signatures() -> list[str]:
    return sorted(_SIGS)


for _level, _name in ((1, "ML-KEM-512"), (3, "ML-KEM-768"), (5, "ML-KEM-1024")):
    register_kem(_name, lambda backend, _level=_level: MLKEMKeyExchange(_level, backend))
for _level, _name in ((2, "ML-DSA-44"), (3, "ML-DSA-65"), (5, "ML-DSA-87")):
    register_signature(_name, lambda backend, _level=_level: MLDSASignature(_level, backend))
