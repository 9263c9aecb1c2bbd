"""ML-KEM, FrodoKEM and HQC providers on the port's two backends.

``backend="cuda"`` (the default) runs ``kem.mlkem`` / ``kem.frodo`` /
``kem.hqc`` on the GPU, where every sampling, NTT, matrix and hash step that
was a TPU kernel is one of the port's CUDA kernels (HQC's hashes run on K1,
the rest of HQC is PyTorch on the GPU); ``backend="cpu"`` runs the same
functions on CPU tensors, which take the kernels' plain PyTorch versions.
Asking for "cuda" without a GPU raises: nothing falls back to the CPU.

Randomness: seeds (ML-KEM's d, z, m; FrodoKEM's s, seedSE, z, mu; HQC's
sk_seed, sigma, pk_seed, m, salt) are drawn host-side from ``os.urandom``
and fed to the deterministic keygen/encaps cores, the seam KATs use too.

``devices=N`` (the registry's, the engine's ``mesh_devices``) splits every
batch across the first N GPUs through ``base.mesh_dispatch``, -1 across
all of them; the randomness is drawn before the split, so a split batch
has the bytes of an unsplit one.  A split provider keeps no operand cache.
"""

from __future__ import annotations

import numpy as np

from ..kem import frodo, hqc, mlkem
from ..utils.cuda import require_device
from ..utils.wipe import wipe
from .base import (BACKENDS, DeviceIO, KeyExchangeAlgorithm, backend_desc, expect_cols,
                   make_provider_mesh, random_rows)
from .opcache import OPCACHE_KEYS, DeviceOperandCache

_LEVEL_TO_MLKEM = {1: mlkem.MLKEM512, 3: mlkem.MLKEM768, 5: mlkem.MLKEM1024}


class MLKEMKeyExchange(DeviceIO, KeyExchangeAlgorithm):
    """ML-KEM (FIPS 203) at NIST level 1, 3 or 5."""

    def __init__(self, security_level: int = 3, backend: str = "cuda", devices: int = 0,
                 opcache_size: int = OPCACHE_KEYS):
        if security_level not in _LEVEL_TO_MLKEM:
            raise ValueError(f"ML-KEM level must be 1/3/5, got {security_level}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.device = require_device(backend)
        self.params = _LEVEL_TO_MLKEM[security_level]
        self.security_level = security_level
        self.backend = backend
        self.name = self.params.name
        self.display_name = f"{self.name} ({backend})"
        self.description = (f"Module-Lattice KEM, FIPS 203, NIST level {security_level}, "
                            f"{backend_desc(backend)} backend")
        self.public_key_len = self.params.ek_len
        self.secret_key_len = self.params.dk_len
        self.ciphertext_len = self.params.ct_len
        self._kg, self._enc, self._dec = mlkem.get(self.params.name)
        self._enc_cold, self._enc_pre = mlkem.get_pre(self.params.name)
        #: per-key precompute kept on the device: repeat encaps against one
        #: peer key skip the key upload and ExpandA.  0 keeps none.
        self.opcache = DeviceOperandCache(opcache_size) if opcache_size > 0 else None
        self._mesh = make_provider_mesh(devices, backend)

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        d, z = random_rows(n), random_rows(n)
        out = self._dispatch(self._kg, d, z)
        wipe(d, z)
        return out

    def encapsulate_batch(self, public_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        pks = np.asarray(public_keys)
        n = pks.shape[0]
        m_host = random_rows(n)
        if (self.opcache is None or self._mesh is not None
                or not (n and (pks[0] == pks).all())):
            key, ct = self._dispatch(self._enc, pks, m_host)
            wipe(m_host)
            return ct, key
        # Single-key batch (every handshake encaps; hot peers): a hit
        # reuses the key's device state and skips ExpandA; a miss computes
        # it alongside the op and caches it.
        m = self._to_device(m_host)
        pkb = pks[0].tobytes()
        pre = self.opcache.lookup("ek", pkb)
        if pre is None:
            pre, key, ct = self._enc_cold(self._to_device(pks[0]), m)
            self.opcache.put("ek", pkb, pre)
        else:
            key, ct = self._enc_pre(pre, m)
        out = self._to_host(ct), self._to_host(key)
        wipe(m_host, m, key)
        return out

    def decapsulate_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray) -> np.ndarray:
        expect_cols(secret_keys, self.secret_key_len, "secret keys", self.name)
        expect_cols(ciphertexts, self.ciphertext_len, "ciphertexts", self.name)
        return self._dispatch(self._dec, secret_keys, ciphertexts)


_LEVEL_TO_FRODO = {(1, True): frodo.PARAMS["FrodoKEM-640-AES"],
                   (1, False): frodo.PARAMS["FrodoKEM-640-SHAKE"],
                   (3, True): frodo.PARAMS["FrodoKEM-976-AES"],
                   (3, False): frodo.PARAMS["FrodoKEM-976-SHAKE"],
                   (5, True): frodo.PARAMS["FrodoKEM-1344-AES"],
                   (5, False): frodo.PARAMS["FrodoKEM-1344-SHAKE"]}


class FrodoKEMKeyExchange(DeviceIO, KeyExchangeAlgorithm):
    """FrodoKEM at NIST level 1, 3 or 5, with A expanded by AES-128
    (``use_aes``, the reference's default) or SHAKE-128."""

    def __init__(self, security_level: int = 1, backend: str = "cuda", use_aes: bool = True,
                 devices: int = 0, opcache_size: int = OPCACHE_KEYS):
        if (security_level, use_aes) not in _LEVEL_TO_FRODO:
            raise ValueError(f"FrodoKEM level must be 1/3/5, got {security_level}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.device = require_device(backend)
        self.params = _LEVEL_TO_FRODO[(security_level, use_aes)]
        self.security_level = security_level
        self.backend = backend
        self.use_aes = use_aes
        self.name = self.params.name
        self.display_name = f"{self.name} ({backend})"
        self.description = (f"Dense-LWE KEM (FrodoKEM round 3), NIST level {security_level}, "
                            f"{'AES' if use_aes else 'SHAKE'} matrix generation, "
                            f"{backend_desc(backend)} backend")
        self.public_key_len = self.params.pk_len
        self.secret_key_len = self.params.sk_len
        self.ciphertext_len = self.params.ct_len
        self.shared_secret_len = self.params.len_sec
        self._kg, self._enc, self._dec = frodo.get(self.params.name)
        self._enc_cold, self._enc_pre = frodo.get_pre(self.params.name)
        #: per-key precompute kept on the device: repeat encaps against one
        #: peer key skip the expansion of its n x n matrix A.  0 keeps none.
        self.opcache = DeviceOperandCache(opcache_size) if opcache_size > 0 else None
        self._mesh = make_provider_mesh(devices, backend)

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        seeds = [random_rows(n, self.params.len_sec) for _ in range(3)]  # s, seedSE, z
        out = self._dispatch(self._kg, *seeds)
        wipe(*seeds)
        return out

    def encapsulate_batch(self, public_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        pks = np.asarray(public_keys)
        n = pks.shape[0]
        mu_host = random_rows(n, self.params.len_sec)
        if (self.opcache is None or self._mesh is not None
                or not (n and (pks[0] == pks).all())):
            out = self._dispatch(self._enc, pks, mu_host)
            wipe(mu_host)
            return out
        # Single-key batch (every handshake encaps; hot peers): a hit
        # reuses the key's A, B and H(pk) on the device; a miss computes
        # them alongside the op and caches them.
        mu = self._to_device(mu_host)
        pkb = pks[0].tobytes()
        pre = self.opcache.lookup("pk", pkb)
        if pre is None:
            pre, ct, ss = self._enc_cold(self._to_device(pks[0]), mu)
            self.opcache.put("pk", pkb, pre)
        else:
            ct, ss = self._enc_pre(pre, mu)
        out = self._to_host(ct), self._to_host(ss)
        wipe(mu_host, mu, ss)
        return out

    def decapsulate_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray) -> np.ndarray:
        expect_cols(secret_keys, self.secret_key_len, "secret keys", self.name)
        expect_cols(ciphertexts, self.ciphertext_len, "ciphertexts", self.name)
        return self._dispatch(self._dec, secret_keys, ciphertexts)


_LEVEL_TO_HQC = {1: hqc.PARAMS["HQC-128"], 3: hqc.PARAMS["HQC-192"], 5: hqc.PARAMS["HQC-256"]}


class HQCKeyExchange(DeviceIO, KeyExchangeAlgorithm):
    """HQC (round-4 shape) at NIST level 1, 3 or 5: 64-byte secrets.  No
    operand cache: an encaps re-expands h from the key's 40-byte seed."""

    def __init__(self, security_level: int = 1, backend: str = "cuda", devices: int = 0):
        if security_level not in _LEVEL_TO_HQC:
            raise ValueError(f"HQC level must be 1/3/5, got {security_level}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.device = require_device(backend)
        self.params = _LEVEL_TO_HQC[security_level]
        self.security_level = security_level
        self.backend = backend
        self.name = self.params.name
        self.display_name = f"{self.name} ({backend})"
        self.description = (f"Quasi-cyclic code-based KEM (HQC round 4 shape), NIST level "
                            f"{security_level}, {backend_desc(backend)} backend")
        self.public_key_len = self.params.pk_len
        self.secret_key_len = self.params.sk_len
        self.ciphertext_len = self.params.ct_len
        self.shared_secret_len = self.params.ss_len
        self._kg, self._enc, self._dec = hqc.get(self.params.name)
        self._mesh = make_provider_mesh(devices, backend)

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        seeds = (random_rows(n, 40), random_rows(n, self.params.k), random_rows(n, 40))
        out = self._dispatch(self._kg, *seeds)  # sk_seed, sigma, pk_seed
        wipe(*seeds)
        return out

    def encapsulate_batch(self, public_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        n = np.asarray(public_keys).shape[0]
        m_host, salt = random_rows(n, self.params.k), random_rows(n, 16)
        out = self._dispatch(self._enc, public_keys, m_host, salt)
        wipe(m_host)
        return out

    def decapsulate_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray) -> np.ndarray:
        expect_cols(secret_keys, self.secret_key_len, "secret keys", self.name)
        expect_cols(ciphertexts, self.ciphertext_len, "ciphertexts", self.name)
        return self._dispatch(self._dec, secret_keys, ciphertexts)
