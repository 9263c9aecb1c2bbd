"""Algorithm registry: canonical names to provider factories.

The backend is an orthogonal axis, "cuda" (the default) or "cpu".  There
is no "auto": a caller that asks for the GPU gets it or an error.
"""

from __future__ import annotations

from typing import Callable

from .base import KeyExchangeAlgorithm
from .kem_providers import BACKENDS, MLKEMKeyExchange

# name -> factory(backend) -> algorithm
_KEMS: dict[str, Callable[[str], KeyExchangeAlgorithm]] = {}


def register_kem(name: str, factory: Callable[[str], KeyExchangeAlgorithm]) -> None:
    _KEMS[name] = factory


def get_kem(name: str, backend: str = "cuda") -> KeyExchangeAlgorithm:
    if name not in _KEMS:
        raise KeyError(f"unknown KEM {name!r}; known: {sorted(_KEMS)}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
    return _KEMS[name](backend)


def list_kems() -> list[str]:
    return sorted(_KEMS)


for _level, _name in ((1, "ML-KEM-512"), (3, "ML-KEM-768"), (5, "ML-KEM-1024")):
    register_kem(_name, lambda backend, _level=_level: MLKEMKeyExchange(_level, backend))
