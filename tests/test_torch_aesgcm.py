"""The port's host AES-256-GCM (``core/aesgcm.py``) against OpenSSL
through the ``cryptography`` package.

* AES-256 blocks (the integer key schedule and rounds) equal AES-ECB's, and
  the numpy keystream equals the integer one.
* AES-256-GCM seals equal ``AESGCM``'s and each opens the other's: seeded
  numpy keys, nonces, plaintexts of 0-300 bytes and 4096, AAD of 0-40, and
  the message lengths on either side of ``NUMPY_BLOCKS`` (where the
  keystream moves from integers to numpy).
* A flipped byte of the tag, the ciphertext or the AAD is refused, as are
  keys and nonces of the wrong length.

Tolerance: exact bytes.  The parity tests skip without the wheel; the port
code itself does not need it (``tests/test_torch_storage.py`` runs it with
every ``cryptography`` import blocked).
"""

from __future__ import annotations

import numpy as np
import pytest

from quantum_resistant_p2p_tpu_torch.core import aesgcm

SEEDS = (0, 1, 2, 3)


def _ecb(key: bytes, blocks: bytes) -> bytes:
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    enc = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
    return enc.update(blocks) + enc.finalize()


def _openssl(key: bytes):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    return AESGCM(key)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_aes256_block_matches_ecb(seed):
    rng = np.random.default_rng(seed)
    key = rng.bytes(32)
    blocks = [rng.bytes(16) for _ in range(9)]
    rk = aesgcm.expand_key(key)
    assert len(rk) == 60
    ours = b"".join(aesgcm.encrypt_block(rk, b) for b in blocks)
    assert ours == _ecb(key, b"".join(blocks))
    # the numpy keystream is the integer one
    nonce = rng.bytes(12)
    want = b"".join(aesgcm.encrypt_block(rk, nonce + c.to_bytes(4, "big")) for c in range(5, 25))
    assert aesgcm._keystream_np(rk, nonce, 5, 20) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_seal_and_open_match_openssl(seed):
    """Every plaintext length 0..300 (the AAD 0..40 bytes, drawn) and one
    of 4096, each under its own key and nonce."""
    rng = np.random.default_rng(100 + seed)
    for n in list(range(seed, 301, len(SEEDS))) + [4096]:
        key, nonce = rng.bytes(32), rng.bytes(12)
        pt, aad = rng.bytes(n), rng.bytes(int(rng.integers(0, 41)))
        ours, theirs = aesgcm.AESGCM(key), _openssl(key)
        sealed = ours.encrypt(nonce, pt, aad)
        assert sealed == theirs.encrypt(nonce, pt, aad), (n, len(aad))
        assert ours.decrypt(nonce, sealed, aad) == pt
        assert theirs.decrypt(nonce, sealed, aad) == pt


@pytest.mark.parametrize("blocks", [aesgcm.NUMPY_BLOCKS - 1, aesgcm.NUMPY_BLOCKS])
@pytest.mark.parametrize("extra", [-1, 0])
def test_keystream_paths_meet_at_numpy_blocks(blocks, extra):
    rng = np.random.default_rng(blocks * 2 - extra)
    key, nonce = rng.bytes(32), rng.bytes(12)
    pt = rng.bytes(16 * blocks + extra)
    assert aesgcm.AESGCM(key).encrypt(nonce, pt, None) == _openssl(key).encrypt(nonce, pt, None)


@pytest.mark.parametrize("aad", [None, b""])
def test_empty_message_and_no_aad(aad):
    key, nonce = bytes(range(32)), bytes(range(12))
    sealed = aesgcm.AESGCM(key).encrypt(nonce, b"", aad)
    assert len(sealed) == 16
    assert sealed == _openssl(key).encrypt(nonce, b"", aad)
    assert aesgcm.AESGCM(key).decrypt(nonce, sealed, aad) == b""


@pytest.mark.parametrize("where", ["tag", "ciphertext", "aad", "truncated"])
def test_tampering_is_refused(where):
    rng = np.random.default_rng(7)
    key, nonce, pt, aad = rng.bytes(32), rng.bytes(12), rng.bytes(77), rng.bytes(20)
    box = aesgcm.AESGCM(key)
    sealed = bytearray(box.encrypt(nonce, pt, aad))
    if where == "tag":
        sealed[-1] ^= 0x80
    elif where == "ciphertext":
        sealed[3] ^= 1
    elif where == "aad":
        aad = aad[:-1] + bytes([aad[-1] ^ 1])
    else:
        sealed = sealed[:15]
    with pytest.raises(aesgcm.InvalidTag):
        box.decrypt(nonce, bytes(sealed), aad)


def test_wrong_key_and_nonce_lengths_raise():
    with pytest.raises(ValueError, match="32-byte key"):
        aesgcm.AESGCM(bytes(16))
    with pytest.raises(ValueError, match="12-byte nonces"):
        aesgcm.AESGCM(bytes(32)).encrypt(bytes(16), b"x", None)
