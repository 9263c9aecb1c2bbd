"""ML-DSA provider on the port's two backends.

``backend="cuda"`` (the default) runs ``sig.mldsa`` on the GPU, where every
sampling, NTT and hash step is one of the port's CUDA kernels;
``backend="cpu"`` runs the same functions on CPU tensors, which take the
kernels' plain PyTorch versions.  Asking for "cuda" without a GPU raises:
nothing falls back to the CPU.

Host/device split: a variable-length message is hashed to the fixed
64-byte ``mu = SHAKE256(tr || M', 64)`` on the host with ``hashlib``
(public data, cheap); the lattice math runs as fixed-shape batched calls on
the device.  Randomness (xi for keygen, rnd for the hedged signing) is
drawn host-side from ``os.urandom``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..sig import mldsa
from ..utils.cuda import require_device
from ..utils.wipe import wipe
from .base import (BACKENDS, DeviceIO, SignatureAlgorithm, expect_cols, expect_len,
                   random_rows)
from .opcache import DeviceOperandCache

_LEVEL_TO_MLDSA = {2: mldsa.MLDSA44, 3: mldsa.MLDSA65, 5: mldsa.MLDSA87}


def _m_prime(message: bytes, ctx: bytes = b"") -> bytes:
    """FIPS 204 pure-mode framing: M' = 0x00 || len(ctx) || ctx || M."""
    return bytes([0, len(ctx)]) + ctx + message


def _mu(tr: bytes, message: bytes, ctx: bytes = b"") -> bytes:
    """mu = SHAKE256(tr || M', 64)."""
    return hashlib.shake_256(tr + _m_prime(message, ctx)).digest(64)


def _single_key(rows: np.ndarray) -> bool:
    """Every row of a non-empty batch is the same key."""
    return len(rows) > 0 and bool((rows[0] == rows).all())


class MLDSASignature(DeviceIO, SignatureAlgorithm):
    """ML-DSA (FIPS 204) at NIST level 2, 3 or 5.

    ``verify`` returns False for a malformed or invalid signature; a
    device failure raises."""

    def __init__(self, security_level: int = 3, backend: str = "cuda"):
        if security_level not in _LEVEL_TO_MLDSA:
            raise ValueError(f"ML-DSA level must be 2/3/5, got {security_level}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.device = require_device(backend)
        self.params = _LEVEL_TO_MLDSA[security_level]
        self.security_level = security_level
        self.backend = backend
        self.name = self.params.name
        self.public_key_len = self.params.pk_len
        self.secret_key_len = self.params.sk_len
        self.signature_len = self.params.sig_len
        self._kg, self._sign_mu, self._verify_mu = mldsa.get(self.name)
        (self._sign_cold, self._sign_pre,
         self._verify_cold, self._verify_pre) = mldsa.get_pre(self.name)
        #: per-key precompute kept on the device: a node signs with one
        #: long-lived key and verifies a peer's one public key, so ExpandA
        #: and the key NTTs are per-key work
        self.opcache = DeviceOperandCache()

    def generate_keypair(self) -> tuple[bytes, bytes]:
        pks, sks = self.generate_keypair_batch(1)
        out = bytes(pks[0]), bytes(sks[0])
        wipe(sks)
        return out

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        xi = random_rows(n)
        xi_t = self._to_device(xi)
        pk, sk = self._kg(xi_t)
        out = self._to_host(pk), self._to_host(sk)
        wipe(xi, xi_t, sk)
        return out

    def sign(self, secret_key: bytes, message: bytes) -> bytes:
        expect_len(secret_key, self.secret_key_len, "secret key", self.name)
        return self.sign_batch(np.frombuffer(secret_key, np.uint8)[None], [message])[0]

    def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        if len(public_key) != self.public_key_len:
            return False
        pk = np.frombuffer(public_key, np.uint8)[None]
        return bool(self.verify_batch(pk, [message], [signature])[0])

    def sign_batch(self, secret_keys: np.ndarray, messages: list[bytes],
                   rnd: list[bytes] | None = None) -> list[bytes]:
        """Hedged signatures of ``messages`` under the matching rows of
        ``secret_keys``; ``rnd`` (32 bytes a row) replaces the random draw,
        the seam the KATs use.  Raises if a lane exhausted its attempts."""
        expect_cols(secret_keys, self.secret_key_len, "secret keys", self.name)
        sks = np.asarray(secret_keys)
        if len(sks) != len(messages):
            raise ValueError(f"{self.name}: {len(sks)} keys for {len(messages)} messages")
        rnd_host = (random_rows(len(sks)) if rnd is None
                    else np.stack([np.frombuffer(r, np.uint8) for r in rnd]))
        mus = np.stack([np.frombuffer(_mu(bytes(sk[64:128]), m), np.uint8)
                        for sk, m in zip(sks, messages)])
        mu, rnd_t = self._to_device(mus), self._to_device(rnd_host)
        if _single_key(sks):
            # Single-key batch (a node's own long-lived key): a hit reuses
            # the key's device state and skips ExpandA and the key NTTs; a
            # miss computes it alongside the signatures and caches it.
            skb = sks[0].tobytes()
            pre = self.opcache.lookup("sk", skb)
            if pre is None:
                sk = self._to_device(sks[0])
                pre, sigs, done = self._sign_cold(sk, mu, rnd_t)
                self.opcache.put("sk", skb, pre)
            else:
                sk = None
                sigs, done = self._sign_pre(pre, mu, rnd_t)
        else:
            sk = self._to_device(sks)
            sigs, done = self._sign_mu(sk, mu, rnd_t)
        done, sigs = self._to_host(done), self._to_host(sigs)
        wipe(rnd_host, rnd_t, sk)
        if not done.all():
            # an all-zero sigma must never leave the provider as a signature
            raise RuntimeError(f"{self.name}: {int((~done).sum())} lane(s) exhausted the "
                               "rejection-sampling budget")
        return [bytes(s) for s in sigs]

    def verify_batch(self, public_keys: np.ndarray, messages: list[bytes],
                     signatures: list[bytes]) -> np.ndarray:
        """-> (n,) bool; a signature of the wrong length is False."""
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        pks = np.asarray(public_keys)
        if not len(pks) == len(messages) == len(signatures):
            raise ValueError(f"{self.name}: {len(pks)} keys, {len(messages)} messages, "
                             f"{len(signatures)} signatures")
        sized = np.array([len(s) == self.signature_len for s in signatures], dtype=bool)
        blank = bytes(self.signature_len)
        sigs = np.stack([np.frombuffer(bytes(s) if ok else blank, np.uint8)
                         for s, ok in zip(signatures, sized)])
        single = _single_key(pks)
        trs = ([hashlib.shake_256(pks[0].tobytes()).digest(64)] * len(pks) if single
               else [hashlib.shake_256(pk.tobytes()).digest(64) for pk in pks])
        mu = self._to_device(np.stack([np.frombuffer(_mu(tr, m), np.uint8)
                                       for tr, m in zip(trs, messages)]))
        sig = self._to_device(sigs)
        if single:
            # Single-key batch (a peer's long-lived key): cached ExpandA
            # and NTT(t1 << d); see sign_batch.
            pkb = pks[0].tobytes()
            pre = self.opcache.lookup("pk", pkb)
            if pre is None:
                pre, oks = self._verify_cold(self._to_device(pks[0]), mu, sig)
                self.opcache.put("pk", pkb, pre)
            else:
                oks = self._verify_pre(pre, mu, sig)
        else:
            oks = self._verify_mu(self._to_device(pks), mu, sig)
        return self._to_host(oks) & sized
