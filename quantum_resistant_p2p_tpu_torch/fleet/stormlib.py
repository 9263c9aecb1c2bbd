"""Storm workload environment, shared by every fleet gateway process
(fleet/gateway.py) and the drivers that run a storm against a fleet.

Counterpart of the JAX package's ``fleet/stormlib.py``.  Four things live
here because both sides need them:

* :func:`storm_env` — the process-environment guard a storm run needs:
  raise the fd soft limit (thousands of live TCP sessions in one
  process) and save/restore the module-global ``KEY_EXCHANGE_TIMEOUT``
  of the port's ``app/messaging.py``.  Both effects are PROCESS-LOCAL,
  which is exactly why this is a context manager the fleet harness
  applies inside each gateway subprocess — applying them once in the
  driver would leave every other process at the defaults, and a raising
  storm session must never poison the next run's timeouts (the restore
  runs in the ``finally``).
* :class:`StormAEAD` — bench-only stdlib encrypt-then-MAC AEAD so the
  full handshake (incl. the ke_test probe) and bulk messaging run
  without a real AEAD.  Never registered as a provider.
* :func:`register_storm_providers` — idempotent registration of the
  hash-based STORM-KEM / STORM-SIG toys, so a storm measures the SERVING
  LOOP (transport, protocol, queues, batching, admission) rather than
  raw crypto throughput.  The port's registry takes one factory a name
  and no backend list: a toy reports the backend it was asked for and
  computes on the host whatever that is, so a "cuda" toy rides the
  device-path queue machinery (health gate, warm-up, breaker) without
  touching the GPU, and its "cpu" twin is the gate's reference.
* :func:`prewarm_facades` — run every pow2 flush bucket a live storm can
  land in once before serving, shared by every gateway subprocess's
  engine.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import hmac
import os
from typing import Iterator


def seeded_jitter_rng(seed: int, *labels: str) -> "random.Random":
    """A deterministic per-entity jitter stream: the run's seed XOR a
    digest of the entity labels (e.g. ``gateway_id, router_id`` for one
    control link).  Every backoff/jitter site in the fleet derives its
    RNG here so a seeded storm replays byte-identically — and NEVER via
    ``hash()``, whose per-process salt would silently defeat the seeding
    across gateway subprocesses."""
    import random

    tag = hashlib.sha256(":".join(labels).encode()).digest()[:4]
    return random.Random(int(seed) ^ int.from_bytes(tag, "big"))


def raise_fd_limit(need: int) -> None:
    """A 10k-session storm needs ~2 fds per session in one process: lift
    the soft RLIMIT_NOFILE to the hard cap (best-effort)."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < need:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(max(need, soft), hard), hard))
    except (ImportError, ValueError, OSError):  # pragma: no cover
        pass


@contextlib.contextmanager
def storm_env(ke_timeout: float, fd_need: int = 0) -> Iterator[None]:
    """Enter the storm process environment: generous protocol timeout
    (cold compiles / batched flushes must not race the 20 s default),
    raised fd limit.  Restores ``KEY_EXCHANGE_TIMEOUT`` on exit even when
    the storm raises — a failed fleet session cannot poison the next
    run's timeouts in the same process."""
    from ..app import messaging as _messaging

    if fd_need:
        raise_fd_limit(fd_need)
    old_timeout = _messaging.KEY_EXCHANGE_TIMEOUT
    _messaging.KEY_EXCHANGE_TIMEOUT = ke_timeout
    try:
        yield
    finally:
        _messaging.KEY_EXCHANGE_TIMEOUT = old_timeout


async def prewarm_facades(facades, limit: int, floor: int = 1) -> list[int]:
    """Warm every pow2 flush bucket from ``floor`` up through ``limit``
    on each (non-None) batching facade, off-loop; returns the sizes
    warmed.  A facade's warm-up runs each of its batch functions once at
    each size (on the card: the first launches at that shape and the
    memory they allocate), so a traffic burst's first flushes do not pay
    for them inside the protocol timeout — warming always includes the
    ``floor`` bucket itself, which is what every flush uses when the
    floor exceeds the concurrency level."""
    sizes, b = [], max(1, floor)
    while b <= limit or not sizes:
        sizes.append(b)
        b *= 2
    loop = asyncio.get_running_loop()
    for facade in facades:
        if facade is None:
            continue
        await loop.run_in_executor(None, facade.warmup, tuple(sizes))
    return sizes


class StormAEAD:
    """Stdlib encrypt-then-MAC AEAD (HMAC-SHA256 over a SHA-256 keystream)
    — bench-only: lets the FULL handshake (incl. the ke_test AEAD probe)
    and bulk messaging run without a real AEAD.  Byte-compatible with the
    JAX package's ``StormAEAD``; never registered as a provider."""

    name = "STORM-AEAD"
    display_name = "STORM-AEAD (bench-only stdlib)"
    key_size = 32
    nonce_size = 16

    @staticmethod
    def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
        out = b""
        ctr = 0
        while len(out) < n:
            out += hashlib.sha256(key + nonce + ctr.to_bytes(8, "big")).digest()
            ctr += 1
        return out[:n]

    def encrypt(self, key, plaintext, associated_data=None):
        nonce = os.urandom(self.nonce_size)
        ct = bytes(a ^ b for a, b in
                   zip(plaintext, self._keystream(key, nonce, len(plaintext))))
        tag = hmac.new(key, nonce + ct + (associated_data or b""),
                       hashlib.sha256).digest()
        return nonce + ct + tag

    def decrypt(self, key, data, associated_data=None):
        if len(data) < self.nonce_size + 32:
            raise ValueError("ciphertext too short")
        nonce, ct, tag = (data[: self.nonce_size], data[self.nonce_size:-32],
                          data[-32:])
        want = hmac.new(key, nonce + ct + (associated_data or b""),
                        hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise ValueError("authentication failed")
        return bytes(a ^ b for a, b in
                     zip(ct, self._keystream(key, nonce, len(ct))))


_STORM_REGISTERED = False


def _rows(items) -> "np.ndarray":
    """A list of equal-length byte strings as one (n, len) uint8 array."""
    import numpy as np

    return np.stack([np.frombuffer(bytes(x), dtype=np.uint8) for x in items])


def register_storm_providers() -> None:
    """Register the stdlib STORM-KEM/STORM-SIG toys (every backend: a
    "cuda" toy rides the device-path queue machinery, a "cpu" one is its
    health-gate twin and degrade fallback) — idempotent.  Their bytes are
    the JAX package's toys', so a port engine and a reference engine
    complete a storm handshake with each other."""
    global _STORM_REGISTERED
    if _STORM_REGISTERED:
        return

    from ..provider.base import KeyExchangeAlgorithm, SignatureAlgorithm
    from ..provider.registry import register_kem, register_signature

    class StormKEM(KeyExchangeAlgorithm):
        name = "STORM-KEM"
        display_name = "STORM-KEM (bench-only stdlib)"
        public_key_len = 32
        secret_key_len = 32
        ciphertext_len = 32
        shared_secret_len = 32
        #: the toys hash on the host whatever backend they report
        device = "cpu"

        def __init__(self, backend="cpu"):
            self.backend = backend

        def generate_keypair_batch(self, n):
            sks = [os.urandom(32) for _ in range(n)]
            return (_rows(hashlib.sha256(b"pk" + sk).digest() for sk in sks),
                    _rows(sks))

        def encapsulate_batch(self, public_keys):
            cts = [os.urandom(32) for _ in range(len(public_keys))]
            return _rows(cts), _rows(
                hashlib.sha256(bytes(pk) + ct).digest()
                for pk, ct in zip(public_keys, cts))

        def decapsulate_batch(self, secret_keys, ciphertexts):
            return _rows(
                hashlib.sha256(hashlib.sha256(b"pk" + bytes(sk)).digest()
                               + bytes(ct)).digest()
                for sk, ct in zip(secret_keys, ciphertexts))

    class StormSig(SignatureAlgorithm):
        name = "STORM-SIG"
        display_name = "STORM-SIG (bench-only stdlib)"
        public_key_len = 32
        secret_key_len = 32
        signature_len = 32
        device = "cpu"

        def __init__(self, backend="cpu"):
            self.backend = backend

        def generate_keypair(self):
            sk = os.urandom(32)
            return hashlib.sha256(b"pk" + sk).digest(), sk

        def sign(self, secret_key, message):
            pk = hashlib.sha256(b"pk" + secret_key).digest()
            return hashlib.sha256(b"sig" + pk + message).digest()

        def verify(self, public_key, message, signature):
            return hmac.compare_digest(
                signature,
                hashlib.sha256(b"sig" + public_key + message).digest())

    register_kem("STORM-KEM", StormKEM)
    register_signature("STORM-SIG", StormSig)
    _STORM_REGISTERED = True
