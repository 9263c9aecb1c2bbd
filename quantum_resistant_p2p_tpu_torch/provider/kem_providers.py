"""ML-KEM provider on the port's two backends.

``backend="cuda"`` (the default) runs ``kem.mlkem`` on the GPU, where every
sampling, NTT and hash step is one of the port's CUDA kernels;
``backend="cpu"`` runs the same functions on CPU tensors, which take the
kernels' plain PyTorch versions.  Asking for "cuda" without a GPU raises:
nothing falls back to the CPU.

Randomness: seeds (d, z, m) are drawn host-side from ``os.urandom`` and fed
to the deterministic keygen/encaps cores, the seam KATs use too.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..kem import mlkem
from ..utils.cuda import require_device
from ..utils.wipe import wipe
from .base import KeyExchangeAlgorithm, expect_cols
from .opcache import DeviceOperandCache

_LEVEL_TO_MLKEM = {1: mlkem.MLKEM512, 3: mlkem.MLKEM768, 5: mlkem.MLKEM1024}
BACKENDS = ("cuda", "cpu")
#: keys whose device state the operand cache keeps (LRU)
OPCACHE_KEYS = 8


def _random_rows(n: int, width: int = 32) -> np.ndarray:
    return np.frombuffer(bytearray(os.urandom(width * n)), dtype=np.uint8).reshape(n, width)


class MLKEMKeyExchange(KeyExchangeAlgorithm):
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
        self.opcache = DeviceOperandCache(OPCACHE_KEYS)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # always a copy, so wiping it never touches the caller's array
        return torch.tensor(np.asarray(a, dtype=np.uint8), device=self.device)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        # always a copy, so wiping the tensor afterwards leaves the result
        return t.to("cpu", copy=True).numpy()

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        d, z = _random_rows(n), _random_rows(n)
        dt, zt = self._to_device(d), self._to_device(z)
        ek, dk = self._kg(dt, zt)
        out = self._to_host(ek), self._to_host(dk)
        wipe(d, z, dt, zt, dk)
        return out

    def encapsulate_batch(self, public_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        pks = np.asarray(public_keys)
        n = pks.shape[0]
        m_host = _random_rows(n)
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
