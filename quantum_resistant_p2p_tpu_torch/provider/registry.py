"""Algorithm registry: canonical names to provider factories.

The backend is an orthogonal axis, "cuda" (the default) or "cpu".  There
is no "auto": a caller that asks for the GPU gets it or an error.

Besides the KEMs and signatures it holds the scalar AEADs, the batched
device AEAD capability (ChaCha20-Poly1305; AES-256-GCM has no device
path) and the fused handshake capability of every ML-KEM x ML-DSA pair.
"""

from __future__ import annotations

from typing import Callable

from .aead_device import ChaChaPolyDevice
from .base import (BACKENDS, BatchedAEADOps, FusedHandshakeOps, KeyExchangeAlgorithm,
                   SignatureAlgorithm, SymmetricAlgorithm)
from .fused_providers import FusedMLKEMMLDSA
from .kem_providers import FrodoKEMKeyExchange, MLKEMKeyExchange
from .sig_providers import MLDSASignature
from .symmetric import AES256GCM, ChaCha20Poly1305

# name -> factory(backend) -> algorithm
_KEMS: dict[str, Callable[[str], KeyExchangeAlgorithm]] = {}
_SIGS: dict[str, Callable[[str], SignatureAlgorithm]] = {}
_AEADS: dict[str, Callable[[], SymmetricAlgorithm]] = {
    "AES-256-GCM": AES256GCM,
    "ChaCha20-Poly1305": ChaCha20Poly1305,
}
# (kem name, sig name) -> factory(kem, sig) -> FusedHandshakeOps
_FUSED: dict[tuple[str, str], Callable] = {}
# AEAD name -> factory(backend) -> BatchedAEADOps
_BATCHED_AEADS: dict[str, Callable[[str], BatchedAEADOps]] = {}


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


def register_fused(kem_name: str, sig_name: str, factory) -> None:
    """Register the fused handshake capability of a (KEM, signature) pair:
    ``factory(kem, sig)`` wraps existing provider instances."""
    _FUSED[(kem_name, sig_name)] = factory


def get_fused(kem: KeyExchangeAlgorithm, sig: SignatureAlgorithm) -> FusedHandshakeOps | None:
    """The fused capability of a provider pair, or None for a pair that has
    none registered (the caller then runs the per-op path).  Raises for a
    registered pair whose providers run on different backends."""
    factory = _FUSED.get((kem.name, sig.name))
    return None if factory is None else factory(kem, sig)


def list_fused() -> list[tuple[str, str]]:
    return sorted(_FUSED)


def get_symmetric(name: str) -> SymmetricAlgorithm:
    if name not in _AEADS:
        raise KeyError(f"unknown AEAD {name!r}; known: {sorted(_AEADS)}")
    return _AEADS[name]()


def list_symmetrics() -> list[str]:
    return sorted(_AEADS)


def register_batched_aead(name: str, factory: Callable[[str], BatchedAEADOps]) -> None:
    _BATCHED_AEADS[name] = factory


def get_batched_aead(symmetric, backend: str = "cuda") -> BatchedAEADOps | None:
    """The batched device capability of an AEAD (instance or name), or None
    for an AEAD that has none (AES-256-GCM): the caller then seals on the
    scalar path.  A registered AEAD on a missing device raises."""
    name = getattr(symmetric, "name", symmetric)
    factory = _BATCHED_AEADS.get(name)
    if factory is None:
        return None
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
    return factory(backend)


def list_batched_aeads() -> list[str]:
    return sorted(_BATCHED_AEADS)


for _level, _name in ((1, "ML-KEM-512"), (3, "ML-KEM-768"), (5, "ML-KEM-1024")):
    register_kem(_name, lambda backend, _level=_level: MLKEMKeyExchange(_level, backend))
for _level, _size in ((1, 640), (3, 976), (5, 1344)):
    for _aes in (True, False):
        register_kem(f"FrodoKEM-{_size}-{'AES' if _aes else 'SHAKE'}",
                     lambda backend, _level=_level, _aes=_aes: FrodoKEMKeyExchange(
                         _level, backend, use_aes=_aes))
for _level, _name in ((2, "ML-DSA-44"), (3, "ML-DSA-65"), (5, "ML-DSA-87")):
    register_signature(_name, lambda backend, _level=_level: MLDSASignature(_level, backend))
register_batched_aead("ChaCha20-Poly1305", ChaChaPolyDevice)
for _kem_name in ("ML-KEM-512", "ML-KEM-768", "ML-KEM-1024"):
    for _sig_name in ("ML-DSA-44", "ML-DSA-65", "ML-DSA-87"):
        register_fused(_kem_name, _sig_name, FusedMLKEMMLDSA)
