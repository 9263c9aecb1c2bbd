"""Algorithm registry: canonical names to provider factories.

The backend is an orthogonal axis, "cuda" (the default) or "cpu"; each KEM
and signature is registered with the backends it supports, and asking for
another raises.  There is no "auto": a caller that asks for the GPU gets it
or an error.  A KEM
or signature factory also takes ``devices`` (``get_kem(..., devices=N)``,
the engine's ``mesh_devices``): N > 0 splits each batch of a "cuda"
provider across the first N GPUs, -1 across all of them (raising when
fewer exist); the "cpu" backend splits nothing.  The fused and batched
AEAD capabilities run each batch whole.

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
from .kem_providers import FrodoKEMKeyExchange, HQCKeyExchange, MLKEMKeyExchange
from .sig_providers import MLDSASignature, SPHINCSSignature
from .symmetric import AES256GCM, ChaCha20Poly1305

# name -> (factory(backend, devices) -> algorithm, supported backends)
_KEMS: dict[str, tuple[Callable[[str, int], KeyExchangeAlgorithm], tuple[str, ...]]] = {}
_SIGS: dict[str, tuple[Callable[[str, int], SignatureAlgorithm], tuple[str, ...]]] = {}
_AEADS: dict[str, Callable[[], SymmetricAlgorithm]] = {
    "AES-256-GCM": AES256GCM,
    "ChaCha20-Poly1305": ChaCha20Poly1305,
}
# (kem name, sig name) -> factory(kem, sig) -> FusedHandshakeOps
_FUSED: dict[tuple[str, str], Callable] = {}
# AEAD name -> factory(backend) -> BatchedAEADOps
_BATCHED_AEADS: dict[str, Callable[[str], BatchedAEADOps]] = {}


def _get(table: dict, kind: str, name: str, backend: str, devices: int):
    if name not in table:
        raise KeyError(f"unknown {kind} {name!r}; known: {sorted(table)}")
    factory, backends = table[name]
    if backend not in backends:
        raise ValueError(f"backend {backend!r} not supported (have {backends})")
    return factory(backend, devices)


def register_kem(name: str, factory: Callable[[str, int], KeyExchangeAlgorithm],
                 backends: tuple[str, ...]) -> None:
    _KEMS[name] = (factory, backends)


def get_kem(name: str, backend: str = "cuda", devices: int = 0) -> KeyExchangeAlgorithm:
    return _get(_KEMS, "KEM", name, backend, devices)


def list_kems() -> list[str]:
    return sorted(_KEMS)


def register_signature(name: str, factory: Callable[[str, int], SignatureAlgorithm],
                       backends: tuple[str, ...]) -> None:
    _SIGS[name] = (factory, backends)


def get_signature(name: str, backend: str = "cuda", devices: int = 0) -> SignatureAlgorithm:
    return _get(_SIGS, "signature", name, backend, devices)


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
    register_kem(_name, lambda backend, devices=0, _level=_level: MLKEMKeyExchange(
        _level, backend, devices=devices), BACKENDS)
for _level, _size in ((1, 640), (3, 976), (5, 1344)):
    for _aes in (True, False):
        register_kem(f"FrodoKEM-{_size}-{'AES' if _aes else 'SHAKE'}",
                     lambda backend, devices=0, _level=_level, _aes=_aes: FrodoKEMKeyExchange(
                         _level, backend, use_aes=_aes, devices=devices), BACKENDS)
for _level, _size in ((1, 128), (3, 192), (5, 256)):
    register_kem(f"HQC-{_size}", lambda backend, devices=0, _level=_level: HQCKeyExchange(
        _level, backend, devices=devices), BACKENDS)
for _level, _name in ((2, "ML-DSA-44"), (3, "ML-DSA-65"), (5, "ML-DSA-87")):
    register_signature(_name, lambda backend, devices=0, _level=_level: MLDSASignature(
        _level, backend, devices=devices), BACKENDS)
for _level, _size in ((1, 128), (3, 192), (5, 256)):
    for _fast in (True, False):
        register_signature(f"SPHINCS+-SHA2-{_size}{'f' if _fast else 's'}-simple",
                           lambda backend, devices=0, _level=_level, _fast=_fast:
                           SPHINCSSignature(_level, backend, fast=_fast, devices=devices),
                           BACKENDS)
register_batched_aead("ChaCha20-Poly1305", ChaChaPolyDevice)
for _kem_name in ("ML-KEM-512", "ML-KEM-768", "ML-KEM-1024"):
    for _sig_name in ("ML-DSA-44", "ML-DSA-65", "ML-DSA-87"):
        register_fused(_kem_name, _sig_name, FusedMLKEMMLDSA)
