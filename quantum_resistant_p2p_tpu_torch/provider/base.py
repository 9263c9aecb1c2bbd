"""The KEM half of the plugin boundary (counterpart of the reference's
``provider/base.py``).

A KEM reports its ``backend`` ("cuda" or "cpu") and offers ``*_batch``
operations over ``(batch, ...)`` uint8 numpy arrays; the scalar operations
are the batch-of-one case.
"""

from __future__ import annotations

import abc

import numpy as np


def next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def pad_rows(rows: np.ndarray, target: int) -> np.ndarray:
    """Pad the batch dim to ``target`` by repeating the last row, so device
    batches come in power-of-two sizes."""
    n = rows.shape[0]
    if n == target:
        return rows
    pad = np.broadcast_to(rows[-1:], (target - n,) + rows.shape[1:])
    return np.concatenate([np.asarray(rows), pad], axis=0)


class KeyExchangeAlgorithm(abc.ABC):
    """KEM interface; byte-level scalar API + array-level batch API."""

    #: canonical registry name, e.g. "ML-KEM-768"
    name: str = ""
    #: "cuda" (kernels on the GPU) or "cpu" (the plain PyTorch versions)
    backend: str = "cuda"
    public_key_len: int = 0
    secret_key_len: int = 0
    ciphertext_len: int = 0
    shared_secret_len: int = 32

    @abc.abstractmethod
    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (public_keys (n, pk_len), secret_keys (n, sk_len)) uint8"""

    @abc.abstractmethod
    def encapsulate_batch(self, public_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (ciphertexts (n, ct_len), shared_secrets (n, 32)) uint8"""

    @abc.abstractmethod
    def decapsulate_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray) -> np.ndarray:
        """-> shared_secrets (n, 32) uint8"""

    def generate_keypair(self) -> tuple[bytes, bytes]:
        pk, sk = self.generate_keypair_batch(1)
        return bytes(pk[0]), bytes(sk[0])

    def encapsulate(self, public_key: bytes) -> tuple[bytes, bytes]:
        expect_len(public_key, self.public_key_len, "public key", self.name)
        ct, ss = self.encapsulate_batch(np.frombuffer(public_key, dtype=np.uint8)[None])
        return bytes(ct[0]), bytes(ss[0])

    def decapsulate(self, secret_key: bytes, ciphertext: bytes) -> bytes:
        expect_len(secret_key, self.secret_key_len, "secret key", self.name)
        expect_len(ciphertext, self.ciphertext_len, "ciphertext", self.name)
        sk = np.frombuffer(secret_key, dtype=np.uint8)[None]
        ct = np.frombuffer(ciphertext, dtype=np.uint8)[None]
        return bytes(self.decapsulate_batch(sk, ct)[0])


def expect_len(buf: bytes, expected: int, what: str, algo: str) -> None:
    """Reject wrong-length attacker-controlled material before it reaches a
    backend, with a protocol-level ValueError."""
    if len(buf) != expected:
        raise ValueError(f"{algo}: {what} must be {expected} bytes, got {len(buf)}")


def expect_cols(arr: np.ndarray, expected: int, what: str, algo: str) -> None:
    """Batch-array analog of expect_len: trailing dim must match exactly."""
    if arr.ndim != 2 or arr.shape[1] != expected:
        raise ValueError(
            f"{algo}: batched {what} must have shape (n, {expected}), got {arr.shape}"
        )
