"""The plugin boundary (counterpart of the reference's ``provider/base.py``):
the KEM and signature interfaces, the fused handshake capability, and the
AEAD interfaces (scalar and batched).

An algorithm reports its ``backend`` ("cuda" or "cpu") and offers
``*_batch`` operations over ``(batch, ...)`` uint8 numpy arrays; the scalar
operations are the batch-of-one case.  The KEM, signature and scalar AEAD
interfaces share :class:`CryptoAlgorithm`, which arms the ``scalar.op``
fault hook (faults/) on their scalar operations.  :func:`mesh_dispatch`
splits a provider's batch across the GPUs of its ``devices=`` mesh
(:func:`make_provider_mesh`): one host thread launches every device's
share in turn before any is read back (on an NVIDIA H100 80GB HBM3 at
700.00 W a thread a device took 2.9-4.1x as long; ``chip_smoke.py``
phase 21 measures both).
"""

from __future__ import annotations

import abc
import contextlib
import os

import numpy as np
import torch

from ..faults import instrument_scalar_ops
from ..parallel.mesh import make_mesh
from ..utils.wipe import wipe

#: the port's backends: kernels on the GPU, or their plain versions on the CPU
BACKENDS = ("cuda", "cpu")


def next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def backend_desc(backend: str) -> str:
    """What runs a provider on ``backend``: the last clause of its
    ``description``, where the reference names JAX/TPU or its CPU core."""
    return "batched PyTorch/CUDA" if backend == "cuda" else "plain PyTorch CPU"


def random_rows(n: int, width: int = 32) -> np.ndarray:
    """(n, width) uint8 from ``os.urandom``: the seeds and signing
    randomness every provider draws on the host."""
    return np.frombuffer(bytearray(os.urandom(width * n)), dtype=np.uint8).reshape(n, width)


class DeviceIO:
    """Host <-> device copies for a provider that runs on ``self.device``,
    or splits its batches across ``self._mesh`` (``devices=``).

    Both directions copy, so wiping either side never touches the other."""

    device: torch.device
    #: the mesh a batch is split across, or None to run it whole
    _mesh = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.uint8), device=self.device)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        return t.to("cpu", copy=True).numpy()

    def _dispatch(self, fn, *arrays):
        """``fn`` over host rows: split across the provider's mesh
        (:func:`mesh_dispatch`), or run whole on ``self.device``.  -> its
        host outputs; every device copy is zeroed once read back."""
        if self._mesh is not None:
            return mesh_dispatch(fn, self._mesh, *arrays)
        ins = [self._to_device(a) for a in arrays]
        out = fn(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        host = tuple(self._to_host(o) for o in outs)
        wipe(*ins, *outs)
        return host if len(host) > 1 else host[0]


def pad_rows(rows: np.ndarray, target: int) -> np.ndarray:
    """Pad the batch dim to ``target`` by repeating the last row, so device
    batches come in power-of-two sizes and a split in equal shares."""
    n = rows.shape[0]
    if n == target:
        return rows
    pad = np.broadcast_to(rows[-1:], (target - n,) + rows.shape[1:])
    return np.concatenate([np.asarray(rows), pad], axis=0)


def device_scope(device: torch.device):
    """Make a GPU the current device (its current stream takes the
    launches); a CPU device needs no scope."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_batch(mesh, *arrays):
    """Cut each array's leading (batch) axis into one contiguous share a
    device of ``mesh``, padded to equal shares by repeating the last row,
    and copy each share to its device.  ``arrays`` are host rows (numpy
    arrays or CPU tensors) of one non-empty batch.  -> for each array, the
    list of its shares in mesh order (the list alone for one array)."""
    n = len(arrays[0])
    if n == 0:
        raise ValueError("shard_batch: an empty batch has no last row to pad with")
    per = -(-n // mesh.size)
    out = []
    for a in arrays:
        if len(a) != n:
            raise ValueError(f"shard_batch: batches of {n} and {len(a)} rows")
        a = pad_rows(np.asarray(a), per * mesh.size)
        out.append([torch.tensor(a[i * per:(i + 1) * per], device=dev)
                    for i, dev in enumerate(mesh.devices)])
    return out[0] if len(out) == 1 else tuple(out)


def run_share(fn, device: torch.device, inputs) -> tuple:
    """``fn(*inputs)`` on one device's share, under that device: -> its
    outputs as a tuple of tensors, launched and not waited for."""
    with device_scope(device):
        out = fn(*inputs)
    return out if isinstance(out, tuple) else (out,)


def fetch_share(outputs: tuple) -> tuple:
    """Host copies (numpy) of one share's outputs; waits for its device."""
    return tuple(t.to("cpu", copy=True).numpy() for t in outputs)


def split_run(fn, mesh, *arrays) -> list[tuple]:
    """``fn`` on each device's share of a non-empty batch of host rows,
    every share launched before any is read back: -> each share's host
    outputs, in mesh order.  The device copies are zeroed once read back."""
    split = shard_batch(mesh, *arrays)
    shares = list(zip(*split)) if len(arrays) > 1 else [(s,) for s in split]
    outs = [run_share(fn, dev, share) for dev, share in zip(mesh.devices, shares)]
    parts = [fetch_share(o) for o in outs]
    wipe(*(t for share in shares for t in share), *(t for o in outs for t in o))
    return parts


def join_shares(parts: list, n: int) -> tuple:
    """The shares' host outputs joined in mesh order and trimmed to ``n``
    rows: -> one array an output."""
    return tuple(np.concatenate(col)[:n] for col in zip(*parts))


def mesh_dispatch(fn, mesh, *arrays):
    """Run a batch function with the batch split across ``mesh``.

    ``fn`` takes device tensors and returns a tensor or a tuple of them,
    batch-major; ``arrays`` are host rows.  The batch is padded (last row
    repeated) to a multiple of the mesh's size, each device's contiguous
    share runs ``fn`` under that device and on its current stream, every
    share launched before any is read back, and the outputs gather on the
    host in order, trimmed to the batch: the bytes of one unsplit call.  An
    empty batch runs unsplit on the mesh's first device.  Every device copy
    the split made is zeroed once gathered."""
    n = len(arrays[0])
    if n == 0:
        dev = mesh.devices[0]
        host = fetch_share(run_share(fn, dev, [torch.tensor(np.asarray(a), device=dev)
                                               for a in arrays]))
    else:
        host = join_shares(split_run(fn, mesh, *arrays), n)
    return host if len(host) > 1 else host[0]


def make_provider_mesh(devices: int, backend: str):
    """The provider's device mesh, or None for a provider that runs each
    batch whole.  ``devices`` is the registry's ``devices=`` (the engine's
    ``mesh_devices``): 0 for none, N for the first N GPUs, -1 for all of
    them; ``make_mesh`` raises when fewer GPUs exist.  The "cpu" backend
    splits nothing."""
    if not devices or backend != "cuda":
        return None
    return make_mesh(None if devices < 0 else devices)


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

    #: canonical registry name, e.g. "ML-KEM-768"
    name: str = ""
    #: human-readable name for UIs and the settings gossip
    display_name: str = ""
    description: str = ""
    #: NIST security level
    security_level: int = 0
    #: "cuda" (kernels on the GPU) or "cpu" (the plain PyTorch versions)
    backend: str = "cuda"

    @property
    def is_using_mock(self) -> bool:
        """Never: no provider stands in mock crypto for the real thing."""
        return False

    @property
    def actual_variant(self) -> str:
        return self.name

    def get_security_info(self) -> dict:
        """The reference's metadata dict, ``backend`` "cuda" or "cpu"."""
        return {
            "name": self.name,
            "display_name": self.display_name,
            "description": self.description,
            "security_level": self.security_level,
            "backend": self.backend,
            "mock": self.is_using_mock,
        }


class KeyExchangeAlgorithm(CryptoAlgorithm):
    """KEM interface; byte-level scalar API + array-level batch API."""

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
