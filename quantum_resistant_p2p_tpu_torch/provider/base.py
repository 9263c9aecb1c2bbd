"""The plugin boundary (counterpart of the reference's ``provider/base.py``):
the KEM and signature interfaces, the fused handshake capability, and the
AEAD interfaces (scalar and batched).

An algorithm reports its ``backend`` ("cuda" or "cpu") and offers
``*_batch`` operations over ``(batch, ...)`` uint8 numpy arrays; the scalar
operations are the batch-of-one case.  The KEM, signature and scalar AEAD
interfaces share :class:`CryptoAlgorithm`, which arms the ``scalar.op``
fault hook (faults/) on their scalar operations.
"""

from __future__ import annotations

import abc
import os

import numpy as np
import torch

from ..faults import instrument_scalar_ops

#: the port's backends: kernels on the GPU, or their plain versions on the CPU
BACKENDS = ("cuda", "cpu")


def next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def random_rows(n: int, width: int = 32) -> np.ndarray:
    """(n, width) uint8 from ``os.urandom``: the seeds and signing
    randomness every provider draws on the host."""
    return np.frombuffer(bytearray(os.urandom(width * n)), dtype=np.uint8).reshape(n, width)


class DeviceIO:
    """Host <-> device copies for a provider that runs on ``self.device``.

    Both directions copy, so wiping either side never touches the other."""

    device: torch.device

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.uint8), device=self.device)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        return t.to("cpu", copy=True).numpy()


def pad_rows(rows: np.ndarray, target: int) -> np.ndarray:
    """Pad the batch dim to ``target`` by repeating the last row, so device
    batches come in power-of-two sizes."""
    n = rows.shape[0]
    if n == target:
        return rows
    pad = np.broadcast_to(rows[-1:], (target - n,) + rows.shape[1:])
    return np.concatenate([np.asarray(rows), pad], axis=0)


class CryptoAlgorithm(abc.ABC):
    """Common base of the KEM, signature and scalar AEAD interfaces.

    When a class deriving from it is created (these interfaces included),
    the scalar ops it defines itself (generate_keypair / encapsulate /
    decapsulate / sign / verify / encrypt / decrypt; abstract ones
    excepted) are wrapped with the ``scalar.op`` fault hook, so a chaos
    plan reaches every provider without monkeypatching.  With no plan
    installed a call pays one global ``None`` check.  The ``*_batch`` ops
    are never wrapped.
    """

    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        instrument_scalar_ops(cls)


class KeyExchangeAlgorithm(CryptoAlgorithm):
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


class SignatureAlgorithm(CryptoAlgorithm):
    """Signature interface; verify returns False for a malformed or invalid
    signature (a device failure raises)."""

    #: canonical registry name, e.g. "ML-DSA-65"
    name: str = ""
    #: "cuda" (kernels on the GPU) or "cpu" (the plain PyTorch versions)
    backend: str = "cuda"
    public_key_len: int = 0
    secret_key_len: int = 0
    signature_len: int = 0

    @abc.abstractmethod
    def generate_keypair(self) -> tuple[bytes, bytes]:
        """-> (public_key, secret_key)"""

    def generate_keypair_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (public_keys (n, pk_len), secret_keys (n, sk_len)) uint8.

        The default loops the scalar path; batched backends override it."""
        pairs = [self.generate_keypair() for _ in range(n)]
        return (np.stack([np.frombuffer(pk, np.uint8) for pk, _ in pairs]),
                np.stack([np.frombuffer(sk, np.uint8) for _, sk in pairs]))

    @abc.abstractmethod
    def sign(self, secret_key: bytes, message: bytes) -> bytes:
        """-> signature"""

    @abc.abstractmethod
    def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        """-> True iff the signature is valid; False for malformed input"""

    def sign_batch(self, secret_keys: np.ndarray, messages: list[bytes]) -> list[bytes]:
        return [self.sign(bytes(sk), m) for sk, m in zip(secret_keys, messages)]

    def verify_batch(self, public_keys: np.ndarray, messages: list[bytes],
                     signatures: list[bytes]) -> np.ndarray:
        return np.array([self.verify(bytes(pk), m, s)
                         for pk, m, s in zip(public_keys, messages, signatures)])


class FusedHandshakeOps(abc.ABC):
    """Composite device programs for a (KEM, signature) provider pair: what
    one handshake step runs back to back (KEM op, transcript hash,
    signature op) in one batched call.

    Found through ``provider.registry.get_fused(kem, sig)``.  ``templates``
    are canonical transcript bytes with a zeroed gap at the given static
    offset, where the device hex-encodes its own output (the fresh public
    key or ciphertext) before hashing; ``msgs_in`` / ``msgs_out`` are
    transcripts the host knows whole.  Sign raises where a lane exhausts
    its rejection budget; verify maps any failure to False.
    """

    kem: KeyExchangeAlgorithm
    sig: SignatureAlgorithm
    name: str = ""
    backend: str = "cuda"
    #: longest template of each kind the programs take
    init_template_len: int = 0
    resp_template_len: int = 0

    @abc.abstractmethod
    def keygen_sign_batch(self, sig_sks: np.ndarray, templates: list[bytes], pk_off: int,
                          rnd=None):
        """-> (public_keys (n, pk_len), secret_keys (n, sk_len), sigs
        list[bytes]): KEM keygen + sign(template with hex(pk) at ``pk_off``)."""

    @abc.abstractmethod
    def encaps_verify_sign_batch(self, public_keys: np.ndarray, peer_sig_pks: np.ndarray,
                                 msgs_in: list[bytes], sigs_in: list[bytes],
                                 sig_sks: np.ndarray, templates: list[bytes], ct_off: int,
                                 m=None, rnd=None):
        """-> (oks (n,) bool, cts, shared_secrets, sigs list[bytes]):
        verify(msgs_in) + KEM encaps + sign(template with hex(ct) at ``ct_off``)."""

    @abc.abstractmethod
    def decaps_verify_sign_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray,
                                 peer_sig_pks: np.ndarray, msgs_in: list[bytes],
                                 sigs_in: list[bytes], sig_sks: np.ndarray,
                                 msgs_out: list[bytes], rnd=None):
        """-> (oks (n,) bool, shared_secrets, sigs list[bytes]):
        verify(msgs_in) + KEM decaps + sign(msgs_out)."""


class SymmetricAlgorithm(CryptoAlgorithm):
    """AEAD interface, scalar (one message a call, on the host).

    The batched device path is a separate capability (:class:`BatchedAEADOps`,
    found through ``provider.registry.get_batched_aead``).  Wire format: a
    12-byte nonce before ``ciphertext || tag``; a failed authentication
    raises ValueError."""

    name: str = ""
    display_name: str = ""
    description: str = ""
    security_level: int = 0
    backend: str = "cpu"
    key_size: int = 32
    nonce_size: int = 12

    @abc.abstractmethod
    def encrypt(self, key: bytes, plaintext: bytes, associated_data: bytes | None = None) -> bytes:
        """-> nonce || ciphertext || tag"""

    @abc.abstractmethod
    def decrypt(self, key: bytes, data: bytes, associated_data: bytes | None = None) -> bytes:
        """-> plaintext; raises ValueError on authentication failure"""

    def seal(self, key: bytes, nonce: bytes, plaintext: bytes,
             associated_data: bytes | None = None) -> bytes:
        """Seal under a given nonce: -> ``ciphertext || tag`` (no nonce
        prefix); ``encrypt`` is a random nonce + seal."""
        raise NotImplementedError(f"{self.name} has no deterministic seal")

    def open_(self, key: bytes, nonce: bytes, data: bytes,
              associated_data: bytes | None = None) -> bytes:
        """Open ``ciphertext || tag`` under a given nonce; ValueError on
        authentication failure."""
        raise NotImplementedError(f"{self.name} has no deterministic open")


class BatchedAEADOps(abc.ABC):
    """Batched device seal/open for one AEAD.

    Keys and nonces are ``(n, key_size)`` / ``(n, nonce_size)`` uint8 rows;
    messages and AADs are ragged lists of bytes-like objects.  A failed
    authentication is a ``ValueError`` instance in the result list, never
    raised, so one tampered ciphertext does not fail its batch mates."""

    name: str = ""
    backend: str = "cuda"
    key_size: int = 32
    nonce_size: int = 12
    tag_size: int = 16
    #: longest message / AAD the device path takes (set by each implementation)
    max_len: int
    max_aad_len: int

    @abc.abstractmethod
    def seal_batch(self, keys: np.ndarray, nonces: np.ndarray, plaintexts: list,
                   aads: list) -> list[bytes]:
        """-> per-item ``ciphertext || tag``."""

    @abc.abstractmethod
    def open_batch(self, keys: np.ndarray, nonces: np.ndarray, data: list, aads: list) -> list:
        """``data`` items are ``ciphertext || tag``; -> per-item plaintext
        bytes, or a ``ValueError`` instance where authentication failed."""


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
