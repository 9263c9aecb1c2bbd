"""ML-KEM and FrodoKEM providers on the port's two backends.

``backend="cuda"`` (the default) runs ``kem.mlkem`` / ``kem.frodo`` on the
GPU, where every sampling, NTT, matrix and hash step that was a TPU kernel
is one of the port's CUDA kernels; ``backend="cpu"`` runs the same
functions on CPU tensors, which take the kernels' plain PyTorch versions.
Asking for "cuda" without a GPU raises: nothing falls back to the CPU.

Randomness: seeds (ML-KEM's d, z, m; FrodoKEM's s, seedSE, z, mu) are drawn
host-side from ``os.urandom`` and fed to the deterministic keygen/encaps
cores, the seam KATs use too.
"""

from __future__ import annotations

import numpy as np

from ..kem import frodo, mlkem
from ..utils.cuda import require_device
from ..utils.wipe import wipe
from .base import BACKENDS, DeviceIO, KeyExchangeAlgorithm, expect_cols, random_rows
from .opcache import DeviceOperandCache

_LEVEL_TO_MLKEM = {1: mlkem.MLKEM512, 3: mlkem.MLKEM768, 5: mlkem.MLKEM1024}


class MLKEMKeyExchange(DeviceIO, KeyExchangeAlgorithm):
    """ML-KEM (FIPS 203) at NIST level 1, 3 or 5."""

    def __init__(self, security_level: int = 3, backend: str = "cuda"):
        if security_level not in _LEVEL_TO_MLKEM:
            raise ValueError(f"ML-KEM level must be 1/3/5, got {security_level}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.device = require_device(backend)
        self.params = _LEVEL_TO_MLKEM[security_level]
        self.security_level = security_level
        self.backend = backend
        self.name = self.params.name
        self.public_key_len = self.params.ek_len
        self.secret_key_len = self.params.dk_len
        self.ciphertext_len = self.params.ct_len
        self._kg, self._enc, self._dec = mlkem.get(self.params.name)
        self._enc_cold, self._enc_pre = mlkem.get_pre(self.params.name)
        #: per-key precompute kept on the device: repeat encaps against one
        #: peer key skip the key upload and ExpandA
        self.opcache = DeviceOperandCache()

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        d, z = random_rows(n), random_rows(n)
        dt, zt = self._to_device(d), self._to_device(z)
        ek, dk = self._kg(dt, zt)
        out = self._to_host(ek), self._to_host(dk)
        wipe(d, z, dt, zt, dk)
        return out

    def encapsulate_batch(self, public_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        pks = np.asarray(public_keys)
        n = pks.shape[0]
        m_host = random_rows(n)
        m = self._to_device(m_host)
        if n and (pks[0] == pks).all():
            # Single-key batch (every handshake encaps; hot peers): a hit
            # reuses the key's device state and skips ExpandA; a miss
            # computes it alongside the op and caches it.
            pkb = pks[0].tobytes()
            pre = self.opcache.lookup("ek", pkb)
            if pre is None:
                pre, key, ct = self._enc_cold(self._to_device(pks[0]), m)
                self.opcache.put("ek", pkb, pre)
            else:
                key, ct = self._enc_pre(pre, m)
        else:
            key, ct = self._enc(self._to_device(pks), m)
        out = self._to_host(ct), self._to_host(key)
        wipe(m_host, m, key)
        return out

    def decapsulate_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray) -> np.ndarray:
        expect_cols(secret_keys, self.secret_key_len, "secret keys", self.name)
        expect_cols(ciphertexts, self.ciphertext_len, "ciphertexts", self.name)
        dk = self._to_device(secret_keys)
        key = self._dec(dk, self._to_device(ciphertexts))
        out = self._to_host(key)
        wipe(dk, key)
        return out


_LEVEL_TO_FRODO = {(1, True): frodo.PARAMS["FrodoKEM-640-AES"],
                   (1, False): frodo.PARAMS["FrodoKEM-640-SHAKE"],
                   (3, True): frodo.PARAMS["FrodoKEM-976-AES"],
                   (3, False): frodo.PARAMS["FrodoKEM-976-SHAKE"],
                   (5, True): frodo.PARAMS["FrodoKEM-1344-AES"],
                   (5, False): frodo.PARAMS["FrodoKEM-1344-SHAKE"]}


class FrodoKEMKeyExchange(DeviceIO, KeyExchangeAlgorithm):
    """FrodoKEM at NIST level 1, 3 or 5, with A expanded by AES-128
    (``use_aes``, the reference's default) or SHAKE-128."""

    def __init__(self, security_level: int = 1, backend: str = "cuda", use_aes: bool = True):
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
        self.public_key_len = self.params.pk_len
        self.secret_key_len = self.params.sk_len
        self.ciphertext_len = self.params.ct_len
        self.shared_secret_len = self.params.len_sec
        self._kg, self._enc, self._dec = frodo.get(self.params.name)
        self._enc_cold, self._enc_pre = frodo.get_pre(self.params.name)
        #: per-key precompute kept on the device: repeat encaps against one
        #: peer key skip the expansion of its n x n matrix A
        self.opcache = DeviceOperandCache()

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        seeds = [random_rows(n, self.params.len_sec) for _ in range(3)]  # s, seedSE, z
        dev = [self._to_device(x) for x in seeds]
        pk, sk = self._kg(*dev)
        out = self._to_host(pk), self._to_host(sk)
        wipe(*seeds, *dev, sk)
        return out

    def encapsulate_batch(self, public_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        pks = np.asarray(public_keys)
        n = pks.shape[0]
        mu_host = random_rows(n, self.params.len_sec)
        mu = self._to_device(mu_host)
        if n and (pks[0] == pks).all():
            # Single-key batch (every handshake encaps; hot peers): a hit
            # reuses the key's A, B and H(pk) on the device; a miss
            # computes them alongside the op and caches them.
            pkb = pks[0].tobytes()
            pre = self.opcache.lookup("pk", pkb)
            if pre is None:
                pre, ct, ss = self._enc_cold(self._to_device(pks[0]), mu)
                self.opcache.put("pk", pkb, pre)
            else:
                ct, ss = self._enc_pre(pre, mu)
        else:
            ct, ss = self._enc(self._to_device(pks), mu)
        out = self._to_host(ct), self._to_host(ss)
        wipe(mu_host, mu, ss)
        return out

    def decapsulate_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray) -> np.ndarray:
        expect_cols(secret_keys, self.secret_key_len, "secret keys", self.name)
        expect_cols(ciphertexts, self.ciphertext_len, "ciphertexts", self.name)
        sk = self._to_device(secret_keys)
        ss = self._dec(sk, self._to_device(ciphertexts))
        out = self._to_host(ss)
        wipe(sk, ss)
        return out
