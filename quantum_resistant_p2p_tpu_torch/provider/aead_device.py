"""Batched ChaCha20-Poly1305 on the port's backends: the ``BatchedAEADOps``
capability.

Marshals ragged bytes into padded power-of-two buckets, runs one
``core.chacha.aead_core`` call per batch (on the GPU: one launch of kernel
K8 for every ChaCha20 block of the batch, then Poly1305 in PyTorch), and
returns exact-length bytes.  Buckets:

* message length -> ``64 * next_pow2(ceil(len / 64))`` (whole ChaCha20
  blocks), at least ``MSG_BUCKET_FLOOR``, up to :attr:`max_len`;
* AAD length -> ``16 * next_pow2(ceil(len / 16))`` (whole Poly1305
  blocks), at least ``AAD_BUCKET_FLOOR``;
* one batch runs at its largest item's buckets; shorter items ride along
  with masked tails.

Counterpart of the reference's ``provider/aead_device.py`` without its
warm-shape tracking (``compiled_shapes`` / ``covers``): nothing here is
compiled per shape.  ``backend="cuda"`` (the default) raises without a GPU.
"""

from __future__ import annotations

import hmac

import numpy as np
import torch

from ..core import chacha
from ..utils.cuda import require_device
from .base import BACKENDS, BatchedAEADOps, DeviceIO, next_pow2


class ChaChaPolyDevice(DeviceIO, BatchedAEADOps):
    """RFC 8439 ChaCha20-Poly1305 over the batched core."""

    name = "ChaCha20-Poly1305"
    key_size = 32
    nonce_size = 12
    tag_size = 16
    #: the largest message and AAD the device path takes; longer payloads
    #: belong to the scalar provider
    max_len = 64 * 1024
    max_aad_len = 4 * 1024
    #: every message and every AAD of at most 256 bytes shares one bucket
    MSG_BUCKET_FLOOR = 256
    AAD_BUCKET_FLOOR = 256

    def __init__(self, backend: str = "cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.backend = backend
        self.device = require_device(backend)

    @classmethod
    def _msg_bucket(cls, n: int) -> int:
        return max(cls.MSG_BUCKET_FLOOR, 64 * next_pow2(max(1, -(-n // 64))))

    @classmethod
    def _aad_bucket(cls, n: int) -> int:
        return max(cls.AAD_BUCKET_FLOOR, 16 * next_pow2(max(1, -(-n // 16))))

    @staticmethod
    def _pack(items: list, bucket: int) -> tuple[np.ndarray, np.ndarray]:
        out = np.zeros((len(items), bucket), np.uint8)
        lens = np.zeros(len(items), np.int32)
        for i, it in enumerate(items):
            row = np.frombuffer(it, np.uint8)
            out[i, : row.shape[0]] = row
            lens[i] = row.shape[0]
        return out, lens

    def _run(self, keys, nonces, data_items, aads, seal: bool):
        data, lens = self._pack(data_items, self._msg_bucket(max(map(len, data_items),
                                                                 default=1)))
        aad_arr, aad_lens = self._pack(aads, self._aad_bucket(max(map(len, aads), default=1)))
        key_t = self._to_device(keys)
        out, tags = chacha.aead_core(
            key_t, self._to_device(nonces), self._to_device(data),
            torch.from_numpy(lens).to(self.device), self._to_device(aad_arr),
            torch.from_numpy(aad_lens).to(self.device), seal=seal)
        result = self._to_host(out), self._to_host(tags), lens
        key_t.zero_()
        return result

    def seal_batch(self, keys: np.ndarray, nonces: np.ndarray, plaintexts: list,
                   aads: list) -> list[bytes]:
        out, tags, lens = self._run(keys, nonces, plaintexts, aads, seal=True)
        return [bytes(out[i, : lens[i]]) + bytes(tags[i]) for i in range(len(plaintexts))]

    def open_batch(self, keys: np.ndarray, nonces: np.ndarray, data: list, aads: list) -> list:
        views = [memoryview(d) for d in data]
        out, tags, lens = self._run(keys, nonces, [v[: -self.tag_size] for v in views], aads,
                                    seal=False)
        results: list = []
        for i, v in enumerate(views):
            # constant-time compare; a mismatch is this item's ValueError
            if hmac.compare_digest(bytes(tags[i]), bytes(v[-self.tag_size:])):
                results.append(bytes(out[i, : lens[i]]))
            else:
                results.append(ValueError("authentication failed"))
        out[...] = 0  # the opened plaintexts of failed items never leave
        return results
