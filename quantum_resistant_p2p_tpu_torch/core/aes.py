"""Batched AES-128 encryption (ECB) in PyTorch, for FrodoKEM-AES's matrix A.

Counterpart of ``quantum_resistant_p2p_tpu/core/aes.py``: SubBytes is a
256-entry gather, ShiftRows a fixed permutation, MixColumns GF(2^8) xtime
arithmetic, and the key schedule ten small rounds over the batch.  Every
function takes ``(..., 16)`` uint8 rows with any leading batch shape and
runs where they lie.  The reference's table-free bitsliced variant
(``core/aes_bitsliced.py``), which the TPU needed, gives the same bytes and
is not ported: on a GPU the gather is the plain way.
"""

from __future__ import annotations

import functools

import torch


def _make_sbox() -> list[int]:
    """The S-box from the GF(2^8) inverse and the affine map (computed,
    not transcribed)."""
    exp, log = [0] * 256, [0] * 256
    x = 1
    for i in range(255):  # GF(2^8) modulo x^8 + x^4 + x^3 + x + 1 (0x11B)
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    sbox = []
    for v in range(256):
        b = exp[(255 - log[v]) % 255] if v else 0
        r = 0x63
        for sh in range(5):
            r ^= ((b << sh) | (b >> (8 - sh))) & 0xFF
        sbox.append(r)
    return sbox


SBOX = tuple(_make_sbox())
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
# ShiftRows on column-major state bytes (byte i = row i % 4, column i // 4)
_SHIFT = (0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(S-box as uint8, ShiftRows permutation as int64), one copy per device."""
    return (torch.tensor(SBOX, dtype=torch.uint8, device=device),
            torch.tensor(_SHIFT, dtype=torch.int64, device=device))


def _sub(sbox: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return sbox[x.to(torch.int32)]


def key_schedule(key: torch.Tensor) -> torch.Tensor:
    """(..., 16) uint8 -> (..., 11, 16) uint8 round keys."""
    sbox, _ = _tables(key.device)
    w = [key[..., 4 * i : 4 * i + 4] for i in range(4)]
    for r in range(10):
        t = _sub(sbox, torch.roll(w[-1], -1, dims=-1))
        t = torch.cat([t[..., :1] ^ _RCON[r], t[..., 1:]], dim=-1)
        w.append(w[-4] ^ t)
        for _ in range(3):
            w.append(w[-4] ^ w[-1])
    keys = torch.cat(w, dim=-1)
    return keys.reshape(keys.shape[:-1] + (11, 16))


def _xtime(b: torch.Tensor) -> torch.Tensor:
    """Multiplication by x in GF(2^8) on uint8 bytes (the shift drops bit 7)."""
    return (b << 1) ^ ((b >> 7) * 0x1B)


def _mix_columns(s: torch.Tensor) -> torch.Tensor:
    """(..., 16) uint8 column-major state -> MixColumns of it, in uint8."""
    c = s.reshape(s.shape[:-1] + (4, 4))  # (..., column, row)
    a0, a1, a2, a3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    x0, x1, x2, x3 = _xtime(a0), _xtime(a1), _xtime(a2), _xtime(a3)
    b0 = x0 ^ x1 ^ a1 ^ a2 ^ a3
    b1 = a0 ^ x1 ^ x2 ^ a2 ^ a3
    b2 = a0 ^ a1 ^ x2 ^ x3 ^ a3
    b3 = x0 ^ a0 ^ a1 ^ a2 ^ x3
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def encrypt_blocks(round_keys: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """round_keys (..., 11, 16), blocks (..., B, 16) uint8 -> (..., B, 16):
    each block encrypted under the round keys of its batch row."""
    sbox, shift = _tables(blocks.device)
    rk = round_keys[..., None, :, :]  # (..., 1, 11, 16)
    s = blocks ^ rk[..., 0, :]
    for r in range(1, 10):
        s = _mix_columns(_sub(sbox, s)[..., shift]) ^ rk[..., r, :]
    return _sub(sbox, s)[..., shift] ^ rk[..., 10, :]
