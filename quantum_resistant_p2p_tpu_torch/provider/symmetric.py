"""Scalar AEADs: AES-256-GCM and ChaCha20-Poly1305, one message a call on
the host.

Counterpart of the reference's ``provider/symmetric.py``.  Both seal with
OpenSSL through the ``cryptography`` package where it is installed.  Where
it is not, each seals with the port's own code: ChaCha20-Poly1305 with the
plain ``core.chacha.aead_core`` on CPU tensors at batch 1 (the same core the
batched device path runs, with its plain block function), AES-256-GCM with
``core.aesgcm`` in host integers (not constant-time, unlike OpenSSL's
AES-NI).  Neither is a device path: the batched one is
``provider.aead_device.ChaChaPolyDevice``.  ``aes256gcm`` applies the same
rule for the key vault and the audit log (``storage/``).

Wire format: a random 12-byte nonce before ``ciphertext || tag``; a failed
authentication raises ValueError.
"""

from __future__ import annotations

import hmac
import os

import numpy as np
import torch

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers import aead as _aead
except ImportError:  # a machine without the wheel: see the module docstring
    from ..core.aesgcm import InvalidTag

    _aead = None

from ..core import aesgcm, chacha
from .base import SymmetricAlgorithm

#: which AES-256-GCM seals on this machine, for banners and reports
AES256GCM_IMPL = "OpenSSL" if _aead is not None else "port (host)"


def aes256gcm(key: bytes):
    """An AES-256-GCM under ``key`` with ``cryptography``'s ``AESGCM`` calls:
    OpenSSL's where the wheel is installed, else ``core.aesgcm``'s."""
    return (_aead.AESGCM if _aead is not None else aesgcm.AESGCM)(bytes(key))


class _AEADBase(SymmetricAlgorithm):
    """Each subclass's ``_cipher(key)`` gives an AEAD with ``cryptography``'s
    ``encrypt``/``decrypt`` calls."""

    key_size = 32
    nonce_size = 12
    tag_size = 16

    def generate_key(self) -> bytes:
        return os.urandom(self.key_size)

    def _check(self, key: bytes, nonce: bytes) -> None:
        if len(key) != self.key_size:
            raise ValueError(f"{self.name} requires a {self.key_size}-byte key")
        if len(nonce) != self.nonce_size:
            raise ValueError(f"{self.name} requires a {self.nonce_size}-byte nonce")

    def seal(self, key: bytes, nonce: bytes, plaintext: bytes,
             associated_data: bytes | None = None) -> bytes:
        self._check(key, nonce)
        return self._cipher(key).encrypt(bytes(nonce), bytes(plaintext), associated_data)

    def open_(self, key: bytes, nonce: bytes, data: bytes,
              associated_data: bytes | None = None) -> bytes:
        self._check(key, nonce)
        if len(data) < self.tag_size:
            raise ValueError("ciphertext too short")
        try:
            return self._cipher(key).decrypt(bytes(nonce), bytes(data), associated_data)
        except InvalidTag as e:
            raise ValueError("authentication failed") from e

    def encrypt(self, key: bytes, plaintext: bytes, associated_data: bytes | None = None) -> bytes:
        nonce = os.urandom(self.nonce_size)
        return nonce + self.seal(key, nonce, plaintext, associated_data)

    def decrypt(self, key: bytes, data: bytes, associated_data: bytes | None = None) -> bytes:
        if len(data) < self.nonce_size + self.tag_size:
            raise ValueError("ciphertext too short")
        data = memoryview(data)
        return self.open_(key, bytes(data[: self.nonce_size]), data[self.nonce_size:],
                          associated_data)


class AES256GCM(_AEADBase):
    name = "AES-256-GCM"
    display_name = "AES-256-GCM"
    description = "AES in Galois/Counter Mode with 256-bit keys (NIST SP 800-38D)"
    security_level = 5

    @property
    def _cipher(self):
        return aes256gcm


def _row(b: bytes, width: int) -> torch.Tensor:
    """bytes -> (1, width) uint8 zero-padded."""
    out = np.zeros((1, width), np.uint8)
    out[0, : len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(out)


def _plain_core(key: bytes, nonce: bytes, data: bytes, aad: bytes,
                seal: bool) -> tuple[bytes, bytes]:
    """One message through the plain ``aead_core`` -> (other, tag)."""
    width, aad_width = 64 * max(1, -(-len(data) // 64)), 16 * max(1, -(-len(aad) // 16))
    out, tags = chacha.aead_core(_row(key, 32), _row(nonce, 12), _row(data, width),
                                 torch.tensor([len(data)]), _row(aad, aad_width),
                                 torch.tensor([len(aad)]), seal=seal)
    return bytes(out[0, : len(data)].numpy()), bytes(tags[0].numpy())


class ChaCha20Poly1305(_AEADBase):
    name = "ChaCha20-Poly1305"
    display_name = "ChaCha20-Poly1305"
    description = "RFC 8439 ChaCha20-Poly1305 AEAD"
    security_level = 5

    @property
    def _cipher(self):
        return _aead.ChaCha20Poly1305

    def seal(self, key: bytes, nonce: bytes, plaintext: bytes,
             associated_data: bytes | None = None) -> bytes:
        if _aead is not None:
            return super().seal(key, nonce, plaintext, associated_data)
        self._check(key, nonce)
        ct, tag = _plain_core(bytes(key), bytes(nonce), bytes(plaintext),
                              bytes(associated_data or b""), seal=True)
        return ct + tag

    def open_(self, key: bytes, nonce: bytes, data: bytes,
              associated_data: bytes | None = None) -> bytes:
        if _aead is not None:
            return super().open_(key, nonce, data, associated_data)
        self._check(key, nonce)
        data = bytes(data)
        if len(data) < self.tag_size:
            raise ValueError("ciphertext too short")
        pt, tag = _plain_core(bytes(key), bytes(nonce), data[: -self.tag_size],
                              bytes(associated_data or b""), seal=False)
        if not hmac.compare_digest(tag, data[-self.tag_size:]):
            raise ValueError("authentication failed")
        return pt
