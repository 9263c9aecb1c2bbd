"""AES-256-GCM on the host, in plain Python integers (NIST SP 800-38D).

The port's own AEAD for the places that seal with ``cryptography``'s
``AESGCM`` in the JAX package (the key vault, the audit log and the scalar
AES-256-GCM provider) on a machine without that wheel.  The rule that picks
between OpenSSL and this module is ``provider.symmetric.aes256gcm``.

One message a call, 12-byte nonces only: the counter runs from
J0 = nonce || 0^31 || 1, the tag is E(J0) xor GHASH over the AAD, the
ciphertext and their bit lengths.  AES runs on 32-bit words through the
four T-tables (each 1 KiB) built from ``core.aes.SBOX`` at import; GHASH
multiplies by H with a 256-entry table of H times each byte, built once a
key.  Both index tables by secret bytes, so unlike OpenSSL's AES-NI this is
not constant-time: where the wheel is installed, OpenSSL seals.

Plain integers rather than CPU tensors in the way ``core.aes`` runs
FrodoKEM's AES-128: a block of AES-256 is about 800 integer operations,
tens of nanoseconds each, where each of a tensor AES's few hundred calls
costs microseconds.  From
``NUMPY_BLOCKS`` counter blocks on, the keystream runs the same T-tables
over all blocks at once in numpy, whose fixed cost a long message repays.
"""

from __future__ import annotations

import hmac
import struct

import numpy as np

from .aes import SBOX

_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40)
_R = 0xE1 << 120  # x^128 = x^7 + x^2 + x + 1, in GCM's reflected bit order


class InvalidTag(Exception):
    """The tag did not authenticate the ciphertext and AAD."""


def _xtime(b: int) -> int:
    return ((b << 1) ^ (0x1B if b & 0x80 else 0)) & 0xFF


def _t_tables() -> tuple[tuple[int, ...], ...]:
    """Te0..Te3: SubBytes and MixColumns of one byte at each row, as words."""
    te0 = []
    for s in SBOX:
        s2 = _xtime(s)
        te0.append((s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s))
    ror = lambda w, n: ((w >> n) | (w << (32 - n))) & 0xFFFFFFFF  # noqa: E731
    return tuple(tuple(ror(w, 8 * i) for w in te0) for i in range(4))


_TE0, _TE1, _TE2, _TE3 = _t_tables()
_TE_NP = np.array((_TE0, _TE1, _TE2, _TE3), np.uint32)
_SBOX_NP = np.array(SBOX, np.uint32)
# the state's columns each output column reads its bytes 2, 3 and 4 from
_COL1, _COL2, _COL3 = [1, 2, 3, 0], [2, 3, 0, 1], [3, 0, 1, 2]
#: counter blocks from which the keystream runs in numpy (the fixed cost
#: of its ~300 array calls against ~40 us a block in integers)
NUMPY_BLOCKS = 16


def _mul_x8_table() -> tuple[int, ...]:
    """What multiplying by x^8 folds back for each byte shifted out of the
    low end (GCM's x^120..x^127 coefficients)."""
    out = []
    for v in range(256):
        for _ in range(8):
            v = (v >> 1) ^ (_R if v & 1 else 0)
        out.append(v)
    return tuple(out)


_RED8 = _mul_x8_table()


def expand_key(key: bytes) -> tuple[int, ...]:
    """32-byte key -> the 60 round-key words of AES-256."""
    if len(key) != 32:
        raise ValueError("AES-256-GCM requires a 32-byte key")
    w = list(struct.unpack(">8I", key))
    s = SBOX
    for i in range(8, 60):
        t = w[-1]
        if i % 8 == 0:
            t = ((s[(t >> 16) & 255] << 24) | (s[(t >> 8) & 255] << 16)
                 | (s[t & 255] << 8) | s[t >> 24]) ^ (_RCON[i // 8 - 1] << 24)
        elif i % 8 == 4:
            t = ((s[t >> 24] << 24) | (s[(t >> 16) & 255] << 16)
                 | (s[(t >> 8) & 255] << 8) | s[t & 255])
        w.append(w[-8] ^ t)
    return tuple(w)


def encrypt_block(rk: tuple[int, ...], block: bytes) -> bytes:
    """One 16-byte block under the round keys of ``expand_key``."""
    s0, s1, s2, s3 = struct.unpack(">4I", block)
    return struct.pack(">4I", *_rounds(rk, s0 ^ rk[0], s1 ^ rk[1], s2 ^ rk[2], s3 ^ rk[3]))


def _rounds(rk, s0, s1, s2, s3):
    """The 14 rounds after AddRoundKey 0, on the state's four column words."""
    te0, te1, te2, te3 = _TE0, _TE1, _TE2, _TE3
    for i in range(4, 56, 4):
        k0, k1, k2, k3 = rk[i : i + 4]
        s0, s1, s2, s3 = (
            te0[s0 >> 24] ^ te1[(s1 >> 16) & 255] ^ te2[(s2 >> 8) & 255] ^ te3[s3 & 255] ^ k0,
            te0[s1 >> 24] ^ te1[(s2 >> 16) & 255] ^ te2[(s3 >> 8) & 255] ^ te3[s0 & 255] ^ k1,
            te0[s2 >> 24] ^ te1[(s3 >> 16) & 255] ^ te2[(s0 >> 8) & 255] ^ te3[s1 & 255] ^ k2,
            te0[s3 >> 24] ^ te1[(s0 >> 16) & 255] ^ te2[(s1 >> 8) & 255] ^ te3[s2 & 255] ^ k3,
        )
    s = SBOX
    return (
        ((s[s0 >> 24] << 24) | (s[(s1 >> 16) & 255] << 16)
         | (s[(s2 >> 8) & 255] << 8) | s[s3 & 255]) ^ rk[56],
        ((s[s1 >> 24] << 24) | (s[(s2 >> 16) & 255] << 16)
         | (s[(s3 >> 8) & 255] << 8) | s[s0 & 255]) ^ rk[57],
        ((s[s2 >> 24] << 24) | (s[(s3 >> 16) & 255] << 16)
         | (s[(s0 >> 8) & 255] << 8) | s[s1 & 255]) ^ rk[58],
        ((s[s3 >> 24] << 24) | (s[(s0 >> 16) & 255] << 16)
         | (s[(s1 >> 8) & 255] << 8) | s[s2 & 255]) ^ rk[59],
    )


def _keystream_np(rk: tuple[int, ...], nonce: bytes, first: int, count: int) -> bytes:
    """E(nonce || ctr) for ``count`` counters from ``first``, all at once."""
    rkn = np.array(rk, np.uint32).reshape(15, 4)
    s = np.empty((count, 4), np.uint32)
    s[:, :3] = np.frombuffer(nonce, ">u4")
    s[:, 3] = np.arange(first, first + count, dtype=np.uint64).astype(np.uint32)
    s ^= rkn[0]
    te0, te1, te2, te3 = _TE_NP
    for r in range(1, 14):
        s = (te0[s >> 24] ^ te1[(s[:, _COL1] >> 16) & 255]
             ^ te2[(s[:, _COL2] >> 8) & 255] ^ te3[s[:, _COL3] & 255] ^ rkn[r])
    sb = _SBOX_NP
    s = ((sb[s >> 24] << 24) | (sb[(s[:, _COL1] >> 16) & 255] << 16)
         | (sb[(s[:, _COL2] >> 8) & 255] << 8) | sb[s[:, _COL3] & 255]) ^ rkn[14]
    return s.astype(">u4").tobytes()


class AESGCM:
    """AES-256-GCM under one key, with ``cryptography``'s ``AESGCM`` calls:
    ``encrypt(nonce, data, aad) -> ciphertext || tag`` and
    ``decrypt(nonce, ciphertext || tag, aad)``, which raises ``InvalidTag``."""

    def __init__(self, key: bytes):
        self._rk = expand_key(bytes(key))
        h = int.from_bytes(encrypt_block(self._rk, bytes(16)), "big")
        # m[b] = b(x) * H, b's most significant bit the x^0 coefficient
        m = [0] * 256
        for bit in range(7, -1, -1):
            m[1 << bit] = h
            h = (h >> 1) ^ (_R if h & 1 else 0)
        for b in range(1, 256):
            low = b & -b
            if b != low:
                m[b] = m[b ^ low] ^ m[low]
        self._m = m

    def _ghash(self, aad: bytes, ct: bytes) -> int:
        m, red = self._m, _RED8
        y = 0
        for data in (aad, ct):
            data += bytes(-len(data) % 16)
            for off in range(0, len(data), 16):
                y ^= int.from_bytes(data[off : off + 16], "big")
                z = 0
                for b in y.to_bytes(16, "little"):  # Horner from the last byte
                    z = (z >> 8) ^ red[z & 255] ^ m[b]
                y = z
        y ^= (len(aad) << 67) | (len(ct) << 3)
        z = 0
        for b in y.to_bytes(16, "little"):
            z = (z >> 8) ^ red[z & 255] ^ m[b]
        return z

    def _ctr(self, nonce: bytes, data: bytes) -> tuple[bytes, bytes]:
        """-> (data xor the keystream from inc32(J0), E(J0))."""
        if len(nonce) != 12:
            raise ValueError("AES-256-GCM here takes 12-byte nonces")
        rk = self._rk
        n0, n1, n2 = struct.unpack(">3I", nonce)
        n0, n1, n2 = n0 ^ rk[0], n1 ^ rk[1], n2 ^ rk[2]
        pack = struct.Struct(">4I").pack
        e_j0 = pack(*_rounds(rk, n0, n1, n2, 1 ^ rk[3]))
        n = len(data)
        if not n:
            return b"", e_j0
        blocks = (n + 15) // 16
        if blocks >= NUMPY_BLOCKS:
            stream = _keystream_np(rk, nonce, 2, blocks)
        else:
            stream = b"".join(pack(*_rounds(rk, n0, n1, n2, c ^ rk[3]))
                              for c in range(2, 2 + blocks))
        out = int.from_bytes(data, "big") ^ int.from_bytes(stream[:n], "big")
        return out.to_bytes(n, "big"), e_j0

    def encrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        aad = bytes(associated_data or b"")
        ct, e_j0 = self._ctr(bytes(nonce), bytes(data))
        tag = self._ghash(aad, ct) ^ int.from_bytes(e_j0, "big")
        return ct + tag.to_bytes(16, "big")

    def decrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        data, aad = bytes(data), bytes(associated_data or b"")
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the tag")
        ct = data[:-16]
        _, e_j0 = self._ctr(bytes(nonce), b"")
        tag = self._ghash(aad, ct) ^ int.from_bytes(e_j0, "big")
        if not hmac.compare_digest(tag.to_bytes(16, "big"), data[-16:]):
            raise InvalidTag("authentication failed")
        return self._ctr(bytes(nonce), ct)[0]
