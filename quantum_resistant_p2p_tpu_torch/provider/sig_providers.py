"""Signature providers on the port's two backends: ML-DSA and SPHINCS+-SHA2.

``backend="cuda"`` (the default) runs ``sig.mldsa`` / ``sig.sphincs`` on the
GPU, where every sampling, NTT and hash step is one of the port's CUDA
kernels; ``backend="cpu"`` runs the same functions on CPU tensors, which
take the kernels' plain PyTorch versions.  Asking for "cuda" without a GPU
raises: nothing falls back to the CPU.

Host/device split: a variable-length message is hashed to a fixed-size
digest on the host with ``hashlib`` (public data, cheap): ML-DSA's 64-byte
``mu = SHAKE256(tr || M', 64)``, SPHINCS+'s PRF_msg randomizer and m-byte
H_msg digest.  The lattice and hash-tree work runs as fixed-shape batched
calls on the device.  Randomness (seeds for keygen, rnd for ML-DSA's hedged
signing) is drawn host-side from ``os.urandom``.

``devices=N`` (the registry's, the engine's ``mesh_devices``) splits every
batch across the first N GPUs through ``base.mesh_dispatch``, -1 across
all of them, after the host work and the randomness: a split batch has the
bytes of an unsplit one.  A split provider keeps no operand cache.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..sig import mldsa, slhdsa_params, sphincs
from ..utils.cuda import require_device
from ..utils.wipe import wipe
from .base import (BACKENDS, DeviceIO, SignatureAlgorithm, backend_desc, expect_cols,
                   expect_len, make_provider_mesh, random_rows)
from .opcache import OPCACHE_KEYS, DeviceOperandCache

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

    def __init__(self, security_level: int = 3, backend: str = "cuda", devices: int = 0,
                 opcache_size: int = OPCACHE_KEYS):
        if security_level not in _LEVEL_TO_MLDSA:
            raise ValueError(f"ML-DSA level must be 2/3/5, got {security_level}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.device = require_device(backend)
        self.params = _LEVEL_TO_MLDSA[security_level]
        self.security_level = security_level
        self.backend = backend
        self.name = self.params.name
        self.display_name = f"{self.name} ({backend})"
        self.description = (f"Module-Lattice signature, FIPS 204, NIST level {security_level}, "
                            f"{backend_desc(backend)} backend")
        self.public_key_len = self.params.pk_len
        self.secret_key_len = self.params.sk_len
        self.signature_len = self.params.sig_len
        self._kg, self._sign_mu, self._verify_mu = mldsa.get(self.name)
        (self._sign_cold, self._sign_pre,
         self._verify_cold, self._verify_pre) = mldsa.get_pre(self.name)
        #: per-key precompute kept on the device: a node signs with one
        #: long-lived key and verifies a peer's one public key, so ExpandA
        #: and the key NTTs are per-key work.  0 keeps none.
        self.opcache = DeviceOperandCache(opcache_size) if opcache_size > 0 else None
        self._mesh = make_provider_mesh(devices, backend)

    def generate_keypair(self) -> tuple[bytes, bytes]:
        pks, sks = self.generate_keypair_batch(1)
        out = bytes(pks[0]), bytes(sks[0])
        wipe(sks)
        return out

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        xi = random_rows(n)
        out = self._dispatch(self._kg, xi)
        wipe(xi)
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
        if self.opcache is None or self._mesh is not None or not _single_key(sks):
            sigs, done = self._dispatch(self._sign_mu, sks, mus, rnd_host)
            wipe(rnd_host)
            return self._signatures(sigs, done)
        # Single-key batch (a node's own long-lived key): a hit reuses the
        # key's device state and skips ExpandA and the key NTTs; a miss
        # computes it alongside the signatures and caches it.
        mu, rnd_t = self._to_device(mus), self._to_device(rnd_host)
        skb = sks[0].tobytes()
        pre = self.opcache.lookup("sk", skb)
        if pre is None:
            sk = self._to_device(sks[0])
            pre, sigs, done = self._sign_cold(sk, mu, rnd_t)
            self.opcache.put("sk", skb, pre)
        else:
            sk = None
            sigs, done = self._sign_pre(pre, mu, rnd_t)
        done, sigs = self._to_host(done), self._to_host(sigs)
        wipe(rnd_host, rnd_t, sk)
        return self._signatures(sigs, done)

    def _signatures(self, sigs: np.ndarray, done: np.ndarray) -> list[bytes]:
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
        mus = np.stack([np.frombuffer(_mu(tr, m), np.uint8) for tr, m in zip(trs, messages)])
        if self.opcache is None or self._mesh is not None or not single:
            return self._dispatch(self._verify_mu, pks, mus, sigs) & sized
        # Single-key batch (a peer's long-lived key): cached ExpandA and
        # NTT(t1 << d); see sign_batch.
        mu, sig = self._to_device(mus), self._to_device(sigs)
        pkb = pks[0].tobytes()
        pre = self.opcache.lookup("pk", pkb)
        if pre is None:
            pre, oks = self._verify_cold(self._to_device(pks[0]), mu, sig)
            self.opcache.put("pk", pkb, pre)
        else:
            oks = self._verify_pre(pre, mu, sig)
        return self._to_host(oks) & sized


_LEVEL_TO_SLH = {
    (1, True): slhdsa_params.SLH128F, (1, False): slhdsa_params.SLH128S,
    (3, True): slhdsa_params.SLH192F, (3, False): slhdsa_params.SLH192S,
    (5, True): slhdsa_params.SLH256F, (5, False): slhdsa_params.SLH256S,
}

#: the host memory a sign call on the "cpu" backend may fill
CPU_SIGN_BUDGET_BYTES = 1 << 30


class SPHINCSSignature(DeviceIO, SignatureAlgorithm):
    """SPHINCS+-SHA2 'simple' (FIPS 205 SLH-DSA) at NIST level 1, 3 or 5, the
    fast ('f') or small ('s') variant.

    Signing is the deterministic variant (PRF_msg with opt_rand = pk_seed),
    as the reference provider signs.  ``sign_batch`` cuts a batch into
    chunks that fit the device's free memory: one s-set signature puts up
    to 360k hash rows in flight at once (split across GPUs, each device's
    share is chunked by that device's memory).  ``verify`` returns False
    for a malformed or invalid signature; a device failure raises."""

    def __init__(self, security_level: int = 1, backend: str = "cuda", fast: bool = True,
                 devices: int = 0):
        if (security_level, fast) not in _LEVEL_TO_SLH:
            raise ValueError(f"SPHINCS+ level must be 1/3/5, got {security_level}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.device = require_device(backend)
        self.params = _LEVEL_TO_SLH[(security_level, fast)]
        self.security_level = security_level
        self.fast = fast
        self.backend = backend
        self.name = self.params.name
        self.display_name = f"{self.name} ({backend})"
        self.description = (f"Stateless hash-based signature, FIPS 205, NIST level "
                            f"{security_level}, {'fast-sign' if fast else 'small-signature'} "
                            f"variant, {backend_desc(backend)} backend")
        self.public_key_len = self.params.pk_len
        self.secret_key_len = self.params.sk_len
        self.signature_len = self.params.sig_len
        self._kg, self._sign_digest, self._verify_digest = sphincs.get(self.name)
        self._mesh = make_provider_mesh(devices, backend)

    def generate_keypair(self) -> tuple[bytes, bytes]:
        pks, sks = self.generate_keypair_batch(1)
        out = bytes(pks[0]), bytes(sks[0])
        wipe(sks)
        return out

    def _keygen_rows(self, seeds: torch.Tensor):
        w = self.params.n
        return self._kg(seeds[:, :w], seeds[:, w:2 * w], seeds[:, 2 * w:])

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        seeds = random_rows(n, 3 * self.params.n)  # sk_seed || sk_prf || pk_seed
        out = self._dispatch(self._keygen_rows, seeds)
        wipe(seeds)
        return out

    def sign(self, secret_key: bytes, message: bytes) -> bytes:
        expect_len(secret_key, self.secret_key_len, "secret key", self.name)
        return self.sign_batch(np.frombuffer(secret_key, np.uint8)[None], [message])[0]

    def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        if len(public_key) != self.public_key_len:
            return False
        pk = np.frombuffer(public_key, np.uint8)[None]
        return bool(self.verify_batch(pk, [message], [signature])[0])

    def memory_budget(self) -> int:
        """Bytes one sign call may fill: half of what the device has free
        (the caching allocator's idle blocks counted as free), or a fixed
        budget on the CPU.  ``self.device`` names no GPU index, so this is
        the current GPU's: a split share's own."""
        if self.device.type == "cpu":
            return CPU_SIGN_BUDGET_BYTES
        free, _ = torch.cuda.mem_get_info(self.device)
        idle = torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        return (free + idle) // 2

    def _sign_chunks(self, sk: torch.Tensor, r: torch.Tensor, digest: torch.Tensor):
        """sign_digest over device rows, in chunks of as many signatures as
        :meth:`memory_budget` holds."""
        step = sphincs.signatures_per_chunk(self.params, self.memory_budget())
        return torch.cat([self._sign_digest(sk[i:i + step], r[i:i + step], digest[i:i + step])
                          for i in range(0, len(sk), step)])

    def sign_batch(self, secret_keys: np.ndarray, messages: list[bytes]) -> list[bytes]:
        """Deterministic signatures of ``messages`` under the matching rows
        of ``secret_keys``, in chunks of as many signatures as
        :meth:`memory_budget` holds."""
        expect_cols(secret_keys, self.secret_key_len, "secret keys", self.name)
        sks = np.asarray(secret_keys)
        if len(sks) != len(messages):
            raise ValueError(f"{self.name}: {len(sks)} keys for {len(messages)} messages")
        p = self.params
        rs, digests = [], []
        for sk, m in zip(sks, messages):
            skb = sk.tobytes()
            pk_seed, pk_root = skb[2 * p.n: 3 * p.n], skb[3 * p.n:]
            r = slhdsa_params.prf_msg(p, skb[p.n: 2 * p.n], pk_seed, m)
            rs.append(np.frombuffer(r, np.uint8))
            digests.append(np.frombuffer(slhdsa_params.h_msg(p, r, pk_seed, pk_root, m),
                                         np.uint8))
        if not rs:
            return []
        sigs = self._dispatch(self._sign_chunks, sks, np.stack(rs), np.stack(digests))
        return [bytes(s) for s in sigs]

    def verify_batch(self, public_keys: np.ndarray, messages: list[bytes],
                     signatures: list[bytes]) -> np.ndarray:
        """-> (n,) bool; a signature of the wrong length is False."""
        expect_cols(public_keys, self.public_key_len, "public keys", self.name)
        pks = np.asarray(public_keys)
        if not len(pks) == len(messages) == len(signatures):
            raise ValueError(f"{self.name}: {len(pks)} keys, {len(messages)} messages, "
                             f"{len(signatures)} signatures")
        p = self.params
        sized = np.array([len(s) == self.signature_len for s in signatures], dtype=bool)
        blank = bytes(self.signature_len)
        sigs = [bytes(s) if ok else blank for s, ok in zip(signatures, sized)]
        digests = np.stack([
            np.frombuffer(slhdsa_params.h_msg(p, sig[: p.n], pk[: p.n].tobytes(),
                                              pk[p.n:].tobytes(), m), np.uint8)
            for pk, m, sig in zip(pks, messages, sigs)])
        sig_rows = np.stack([np.frombuffer(s, np.uint8) for s in sigs])
        return self._dispatch(self._verify_digest, pks, digests, sig_rows) & sized
