"""Fused handshake capability (``base.FusedHandshakeOps``) on the port's
backends.

``FusedMLKEMMLDSA`` wraps an (ML-KEM, ML-DSA) provider pair of one backend
("cuda" by default, "cpu" in tests) and runs the three composite programs
of ``fused.mlkem_mldsa`` at the numpy/bytes level the batching queue
speaks.  Host work mirrors the per-op providers: transcripts the host knows
whole are hashed to the fixed 64-byte mu with ``hashlib``; transcripts that
embed a device output go to the device as templates.  Seeds (d, z, m) and
the signing randomness are drawn on the host from ``os.urandom``.

Counterpart of the reference's ``provider/fused_providers.py``, without
its TPU batch cap (``MAX_DEVICE_BATCH`` slicing) and without ``warmup``:
the port compiles nothing at first use but the kernel libraries.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..fused import mlkem_mldsa as fused_ops
from ..utils.wipe import wipe
from .base import DeviceIO, FusedHandshakeOps, expect_cols, random_rows
from .sig_providers import _mu

#: room past the hex payload for the JSON scaffolding (keys, uuid, peer
#: ids, timestamp repr): one template width covers every realistic
#: transcript
TEMPLATE_HEADROOM = 1024


def init_pk_offset(kem_name: str, aead_name: str) -> int:
    """Byte offset of the public-key hex inside the canonical init
    transcript.  Canonical JSON sorts keys, and every key before
    "public_key" has a fixed-length value (the AEAD and KEM names, the
    36-character uuid4 message_id), so the offset depends only on the
    algorithm names; it is found by probing a canonical dump."""
    probe = {
        "aead": aead_name, "kem": kem_name, "message_id": "x" * 36,
        "public_key": "", "recipient": "", "sender": "", "timestamp": 0,
    }
    s = json.dumps(probe, sort_keys=True, separators=(",", ":"))
    return s.index('"public_key":"') + len('"public_key":"')


def resp_ct_offset() -> int:
    """Byte offset of the ciphertext hex inside the canonical response
    transcript ("ciphertext" sorts first, so the offset is constant)."""
    probe = {
        "ciphertext": "", "message_id": "x" * 36,
        "recipient": "", "sender": "", "timestamp": 0,
    }
    s = json.dumps(probe, sort_keys=True, separators=(",", ":"))
    return s.index('"ciphertext":"') + len('"ciphertext":"')


def _stack_templates(templates: list[bytes], lmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Transcript bytes -> ((n, lmax) uint8 zero-padded, (n,) int32 true
    lengths).  Raises for a template longer than ``lmax``."""
    t = np.zeros((len(templates), lmax), np.uint8)
    lens = np.empty(len(templates), np.int32)
    for i, b in enumerate(templates):
        if len(b) > lmax:
            raise ValueError(f"template of {len(b)} bytes exceeds the {lmax}-byte capacity")
        t[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return t, lens


def _rand(n: int, given) -> np.ndarray:
    """(n, 32) rows: ``given`` (32 bytes each) or fresh randomness."""
    if given is not None:
        return np.stack([np.frombuffer(bytes(r), np.uint8) for r in given])
    return random_rows(n)


def _stack_bytes(items) -> np.ndarray:
    return np.stack([np.frombuffer(bytes(b), np.uint8) for b in items])


class FusedMLKEMMLDSA(DeviceIO, FusedHandshakeOps):
    """Composite ML-KEM + ML-DSA handshake programs on a provider pair of
    one backend."""

    def __init__(self, kem, sig):
        if kem.backend != sig.backend:
            raise ValueError(f"fused ops need one backend, got {kem.backend}/{sig.backend}")
        self.kem = kem
        self.sig = sig
        self.name = f"{kem.name}+{sig.name}"
        self.backend = kem.backend
        self.device = kem.device
        self.init_template_len = 2 * kem.public_key_len + TEMPLATE_HEADROOM
        self.resp_template_len = 2 * kem.ciphertext_len + TEMPLATE_HEADROOM

    def _to_device_i32(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(self.device)

    def _mus_from_peer_pks(self, peer_sig_pks: np.ndarray, msgs_in: list[bytes]) -> np.ndarray:
        trs = [hashlib.shake_256(bytes(pk)).digest(64) for pk in peer_sig_pks]
        return _stack_bytes(_mu(tr, m) for tr, m in zip(trs, msgs_in))

    @staticmethod
    def _mus_from_own_sks(sig_sks: np.ndarray, msgs_out: list[bytes]) -> np.ndarray:
        return _stack_bytes(_mu(bytes(sk[64:128]), m) for sk, m in zip(sig_sks, msgs_out))

    @staticmethod
    def _check_done(done: np.ndarray, what: str) -> None:
        if not done.all():
            # an all-zero sigma must never leave the provider as a signature
            raise RuntimeError(f"fused {what}: {int((~done).sum())} lane(s) exhausted the "
                               "rejection-sampling budget")

    def keygen_sign_batch(self, sig_sks: np.ndarray, templates: list[bytes], pk_off: int,
                          rnd=None):
        expect_cols(sig_sks, self.sig.secret_key_len, "secret keys", self.name)
        n = len(templates)
        d, z, rnds = random_rows(n), random_rows(n), _rand(n, rnd)
        tmpl, lens = _stack_templates(templates, self.init_template_len)
        args = [self._to_device(a) for a in (d, z, sig_sks, rnds, tmpl)]
        ek, dk, sigma, done = fused_ops.keygen_sign(self.kem.name, self.sig.name, pk_off, *args,
                                                    self._to_device_i32(lens))
        done, sigs = self._to_host(done), self._to_host(sigma)
        out = self._to_host(ek), self._to_host(dk)
        wipe(d, z, rnds, dk, *args)
        self._check_done(done, "keygen_sign")
        return out[0], out[1], [bytes(s) for s in sigs]

    def encaps_verify_sign_batch(self, public_keys: np.ndarray, peer_sig_pks: np.ndarray,
                                 msgs_in: list[bytes], sigs_in: list[bytes],
                                 sig_sks: np.ndarray, templates: list[bytes], ct_off: int,
                                 m=None, rnd=None):
        expect_cols(public_keys, self.kem.public_key_len, "public keys", self.name)
        expect_cols(sig_sks, self.sig.secret_key_len, "secret keys", self.name)
        n = len(templates)
        mus_in = self._mus_from_peer_pks(peer_sig_pks, msgs_in)
        ms, rnds = _rand(n, m), _rand(n, rnd)
        tmpl, lens = _stack_templates(templates, self.resp_template_len)
        secret = [self._to_device(a) for a in (ms, sig_sks, rnds)]
        ok, ct, key, sigma, done = fused_ops.encaps_verify_sign(
            self.kem.name, self.sig.name, ct_off, self._to_device(public_keys), secret[0],
            self._to_device(peer_sig_pks), self._to_device(mus_in),
            self._to_device(_stack_bytes(sigs_in)), secret[1], secret[2], self._to_device(tmpl),
            self._to_device_i32(lens))
        done, sigs = self._to_host(done), self._to_host(sigma)
        out = self._to_host(ok), self._to_host(ct), self._to_host(key)
        wipe(ms, rnds, key, *secret)
        self._check_done(done, "encaps_verify_sign")
        return out[0], out[1], out[2], [bytes(s) for s in sigs]

    def decaps_verify_sign_batch(self, secret_keys: np.ndarray, ciphertexts: np.ndarray,
                                 peer_sig_pks: np.ndarray, msgs_in: list[bytes],
                                 sigs_in: list[bytes], sig_sks: np.ndarray,
                                 msgs_out: list[bytes], rnd=None):
        expect_cols(secret_keys, self.kem.secret_key_len, "secret keys", self.name)
        expect_cols(ciphertexts, self.kem.ciphertext_len, "ciphertexts", self.name)
        n = len(msgs_out)
        mus_in = self._mus_from_peer_pks(peer_sig_pks, msgs_in)
        mus_out = self._mus_from_own_sks(sig_sks, msgs_out)
        rnds = _rand(n, rnd)
        secret = [self._to_device(a) for a in (secret_keys, sig_sks, rnds)]
        ok, ss, sigma, done = fused_ops.decaps_verify_sign(
            self.kem.name, self.sig.name, secret[0], self._to_device(ciphertexts),
            self._to_device(peer_sig_pks), self._to_device(mus_in),
            self._to_device(_stack_bytes(sigs_in)), secret[1], self._to_device(mus_out), secret[2])
        done, sigs = self._to_host(done), self._to_host(sigma)
        out = self._to_host(ok), self._to_host(ss)
        wipe(rnds, ss, *secret)
        self._check_done(done, "decaps_verify_sign")
        return out[0], out[1], [bytes(s) for s in sigs]
