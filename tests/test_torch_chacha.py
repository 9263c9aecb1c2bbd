"""The port's ChaCha20-Poly1305 data plane on the CPU: the block function,
Poly1305 and the AEAD core against the JAX package's (jnp paths, jitted on
the CPU) and the RFC 8439 vectors, byte for byte; the scalar and batched
providers, BatchedAEAD and the AEAD health check.

Inputs are made from a seed with numpy and handed to both sides.  Kernel
K8 runs only on a GPU: tests/test_torch_gpu.py holds it to the plain
version there.
"""

import asyncio
import gc
import hashlib

import jax
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.core import chacha_pallas as jc
from quantum_resistant_p2p_tpu.provider.symmetric import ChaCha20Poly1305 as RefChaCha
from quantum_resistant_p2p_tpu.pyref import chacha_ref as ref
from quantum_resistant_p2p_tpu_torch.core import aesgcm as port_aesgcm
from quantum_resistant_p2p_tpu_torch.core import chacha as tc
from quantum_resistant_p2p_tpu_torch.core import chacha_cuda
from quantum_resistant_p2p_tpu_torch.provider import (BatchedAEAD, ChaChaPolyDevice,
                                                      get_batched_aead, get_symmetric,
                                                      list_batched_aeads, list_symmetrics)
from quantum_resistant_p2p_tpu_torch.provider import symmetric as port_symmetric
from quantum_resistant_p2p_tpu_torch.provider.health import _check_aead, gate_facades

#: RFC 8439 §2.8.2 AEAD vector
KEY = bytes(range(0x80, 0xA0))
NONCE = bytes([0x07, 0, 0, 0]) + bytes(range(0x40, 0x48))
AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
PLAINTEXT = (b"Ladies and Gentlemen of the class of '99: If I could offer "
             b"you only one tip for the future, sunscreen would be it.")
CT_HEX = (
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116"
)
TAG_HEX = "1ae10b594f09e26a7e902ecbd0600691"
#: §2.3.2 block function vector (counter 1)
BLOCK_KEY = bytes(range(32))
BLOCK_NONCE = bytes.fromhex("000000090000004a00000000")
BLOCK_OUT_HEX = (
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e"
)
#: §2.5.2 Poly1305 vector
POLY_KEY = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
POLY_MSG = b"Cryptographic Forum Research Group"
POLY_TAG = bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")
#: every masking edge: empty, sub-block, each side of the 16-byte Poly1305
#: and 64-byte ChaCha20 blocks, and across the pow2 length buckets
TAIL_LENS = [0, 1, 15, 16, 17, 31, 32, 63, 64, 65, 127, 128, 129, 255, 256]


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop the JAX programs this module compiled when it ends.  Each
    compiled program holds memory maps in its process, and a test process
    that compiles many programs can reach the kernel's limit on maps."""
    yield
    jax.clear_caches()
    gc.collect()


def _u8(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _words(b: bytes) -> list[int]:
    return list(np.frombuffer(b, "<u4"))


def _pack(items: list[bytes], width: int) -> tuple[np.ndarray, np.ndarray]:
    out = np.zeros((len(items), width), np.uint8)
    for i, it in enumerate(items):
        out[i, : len(it)] = np.frombuffer(it, np.uint8)
    return out, np.array([len(it) for it in items], np.int32)


def _ragged(seed: int, lens: list[int]) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in lens]


def test_chacha_blocks_match_jax_and_rfc_2_3_2():
    states = _u8(1, 300, 48).view("<u4")  # (300, 12) random words
    states[0] = _words(BLOCK_KEY) + [1] + _words(BLOCK_NONCE)
    want = np.asarray(jc.chacha_blocks_jnp(states.T.copy())).T  # (300, 16) uint32
    got = tc.chacha_blocks(torch.from_numpy(states.view(np.int32).copy()))
    assert got.dtype == torch.int32 and got.shape == (300, 16)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert bytes(got[0].numpy().view(np.uint8)).hex() == BLOCK_OUT_HEX


def test_chacha_blocks_cpu_tensor_takes_the_plain_version():
    before = chacha_cuda.chacha_blocks.launches
    x = torch.from_numpy(_u8(2, 5, 48).view(np.int32).copy())
    assert torch.equal(tc.chacha_blocks(x), tc.chacha_blocks_plain(x))
    assert chacha_cuda.chacha_blocks.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        chacha_cuda.chacha_blocks(x)


@pytest.mark.parametrize("n_blocks", [1, 5, 17])
def test_poly1305_tags_match_jax(n_blocks):
    b = 6
    keys, mac = _u8(10 + n_blocks, b, 32), _u8(20 + n_blocks, b, 16 * n_blocks)
    active = np.random.default_rng(n_blocks).random((b, n_blocks)) < 0.7
    active[:, -1] = True
    mac[0] = 0xFF  # limbs at their largest
    keys[1, :16] = 0xFF
    want = np.asarray(jc.poly1305_tags(keys[:, :16], keys[:, 16:], mac, active))
    got = tc.poly1305_tags(*(torch.from_numpy(a) for a in (keys[:, :16], keys[:, 16:], mac,
                                                           active)))
    assert np.array_equal(got.numpy(), want)


def test_poly1305_rfc_2_5_2():
    """A 34-byte message: two full blocks and a short one, padded with
    0x01 and zeros, without the 2^128 bit (§2.5.1)."""
    msg = POLY_MSG + b"\x01" + bytes(47 - len(POLY_MSG))
    key = torch.tensor(list(POLY_KEY), dtype=torch.uint8)[None]
    tags = tc.poly1305_tags(key[:, :16], key[:, 16:],
                            torch.tensor(list(msg), dtype=torch.uint8)[None],
                            torch.ones((1, 3), dtype=torch.bool),
                            hibit=torch.tensor([[True, True, False]]))
    assert bytes(tags[0].numpy()) == POLY_TAG == ref.poly1305_mac(POLY_KEY, POLY_MSG)


def _core_both(seed: int, lens: list[int], aad_lens: list[int], width: int, aad_width: int,
               seal: bool):
    n = len(lens)
    keys, nonces = _u8(seed, n, 32), _u8(seed + 1, n, 12)
    data, dl = _pack(_ragged(seed + 2, lens), width)
    aads, al = _pack(_ragged(seed + 3, aad_lens), aad_width)
    want = [np.asarray(a) for a in jc.aead_core(keys, nonces, data, dl, aads, al, seal=seal,
                                                use_pallas=False)]
    got = tc.aead_core(*(torch.from_numpy(a) for a in (keys, nonces, data, dl, aads, al)),
                       seal=seal)
    return want, [t.numpy() for t in got]


@pytest.mark.parametrize("seal", [True, False])
@pytest.mark.parametrize("width,aad_width", [(256, 16), (256, 256), (1024, 64)])
def test_aead_core_matches_jax(seal, width, aad_width):
    """Seal and open, masked tails of every edge, several buckets."""
    lens = [n for n in TAIL_LENS if n <= width] + [width]
    aad_lens = [(7 * i) % (aad_width + 1) for i in range(len(lens))]
    want, got = _core_both(width + aad_width, lens, aad_lens, width, aad_width, seal)
    for w, g in zip(want, got):
        assert np.array_equal(g, w)


def test_aead_core_rfc_2_8_2_and_pyref_tails():
    keys = [bytes(_u8(40 + i, 32)) for i in range(len(TAIL_LENS))] + [KEY]
    nonces = [bytes(_u8(60 + i, 12)) for i in range(len(TAIL_LENS))] + [NONCE]
    pts = _ragged(5, TAIL_LENS) + [PLAINTEXT]
    aads = [b"" if i % 3 == 0 else bytes(_u8(80 + i, 5 * i + 1)) for i in range(len(TAIL_LENS))]
    aads.append(AAD)
    data, dl = _pack(pts, 256)
    aad, al = _pack(aads, 128)
    out, tags = tc.aead_core(*(torch.tensor(np.stack([np.frombuffer(x, np.uint8) for x in xs]))
                               for xs in (keys, nonces)),
                             torch.from_numpy(data), torch.from_numpy(dl),
                             torch.from_numpy(aad), torch.from_numpy(al), seal=True)
    assert bytes(out[-1, : len(PLAINTEXT)].numpy()).hex() == CT_HEX
    assert bytes(tags[-1].numpy()).hex() == TAG_HEX
    for i, n in enumerate(TAIL_LENS):
        expect = ref.seal(keys[i], nonces[i], pts[i], aads[i])
        assert bytes(out[i, :n].numpy()) + bytes(tags[i].numpy()) == expect, n
        assert not out[i, n:].any()  # zero past the length


def test_chacha_poly_device_round_trip_and_tamper():
    dev = ChaChaPolyDevice(backend="cpu")
    n = 5
    keys, nonces = _u8(90, n, 32), _u8(91, n, 12)
    pts = _ragged(92, [0, 17, 300, 1000, 64])  # buckets 256 and 1024
    aads = _ragged(93, [0, 3, 300, 16, 40])
    sealed = dev.seal_batch(keys, nonces, pts, aads)
    for i in range(n):
        assert sealed[i] == ref.seal(bytes(keys[i]), bytes(nonces[i]), pts[i], aads[i])
    bad = list(sealed)
    bad[2] = bytes([bad[2][0] ^ 1]) + bad[2][1:]
    opened = dev.open_batch(keys, nonces, [memoryview(s) for s in bad], aads)
    assert [o for i, o in enumerate(opened) if i != 2] == [p for i, p in enumerate(pts) if i != 2]
    assert isinstance(opened[2], ValueError)
    assert dev._msg_bucket(1) == 256 and dev._msg_bucket(257) == 512
    assert dev._aad_bucket(4096) == 4096 and (dev.max_len, dev.max_aad_len) == (65536, 4096)


def test_batched_aead_coalesces_and_interops_with_the_jax_package():
    """32 clients seal through BatchedAEAD; the JAX package's scalar
    ChaCha20Poly1305 opens every frame, and frames it seals open through
    the facade; a tampered frame and an oversized message fail alone."""
    device = get_batched_aead("ChaCha20-Poly1305", backend="cpu")
    theirs = RefChaCha()
    key = bytes(_u8(100, 32))
    msgs = _ragged(101, [13 * i for i in range(32)])

    async def run():
        with BatchedAEAD(device, max_wait_ms=20.0) as aead:
            frames = await asyncio.gather(*(aead.encrypt(key, m, b"ad%d" % i)
                                            for i, m in enumerate(msgs)))
            theirs_frames = [theirs.encrypt(key, m, b"ad%d" % i) for i, m in enumerate(msgs)]
            bad = bytes([frames[3][0]]) + bytes([frames[3][1] ^ 1]) + frames[3][2:]
            opened = await asyncio.gather(
                *(aead.decrypt(key, memoryview(f), b"ad%d" % i)
                  for i, f in enumerate(theirs_frames)),
                aead.decrypt(key, bad, b"ad3"), aead.encrypt(key, bytes(65537)),
                aead.decrypt(key, b"short"), return_exceptions=True)
            return frames, opened, aead.stats()

    frames, opened, stats = asyncio.run(run())
    assert [theirs.decrypt(key, f, b"ad%d" % i) for i, f in enumerate(frames)] == msgs
    assert opened[:32] == msgs
    assert all(isinstance(e, ValueError) for e in opened[32:])
    assert stats["seal"]["ops"] == 33 and stats["seal"]["flushes"] < 33
    assert stats["open"]["max_batch_seen"] > 1


def test_batched_aead_failure_reaches_every_waiter():
    class Broken(ChaChaPolyDevice):
        def seal_batch(self, *args):
            raise RuntimeError("device lost")

    async def run():
        with BatchedAEAD(Broken("cpu"), max_wait_ms=20.0) as aead:
            return await asyncio.gather(*(aead.encrypt(bytes(32), b"m") for _ in range(6)),
                                        return_exceptions=True)

    out = asyncio.run(run())
    assert all(isinstance(r, RuntimeError) and str(r) == "device lost" for r in out)


@pytest.mark.parametrize("wheel", [True, False])
def test_scalar_chacha_interops_with_the_jax_package(monkeypatch, wheel):
    """Both branches of the port's scalar ChaCha20-Poly1305 (OpenSSL, and
    the plain core where the wheel is missing) agree with the JAX
    package's scalar provider both ways."""
    if not wheel:
        monkeypatch.setattr(port_symmetric, "_aead", None)
    ours, theirs = get_symmetric("ChaCha20-Poly1305"), RefChaCha()
    key = ours.generate_key()
    for n in (0, 15, 64, 200):
        msg = bytes(_u8(n, n))
        assert theirs.decrypt(key, ours.encrypt(key, msg, b"hdr"), b"hdr") == msg
        assert ours.decrypt(key, theirs.encrypt(key, msg, b"hdr"), b"hdr") == msg
    assert ours.seal(KEY, NONCE, PLAINTEXT, AAD).hex() == CT_HEX + TAG_HEX
    blob = ours.encrypt(key, b"payload", b"ad")
    with pytest.raises(ValueError):
        ours.decrypt(key, blob[:-1] + bytes([blob[-1] ^ 1]), b"ad")
    with pytest.raises(ValueError):
        ours.decrypt(key, blob, b"other ad")


def test_aes_gcm_needs_the_wheel(monkeypatch):
    """AES-256-GCM seals with OpenSSL where the wheel is installed; without
    it, with the port's own ``core.aesgcm``, and each opens the other's."""
    aes = get_symmetric("AES-256-GCM")
    key = aes.generate_key()
    with_wheel = aes.encrypt(key, b"x", b"a")
    assert aes.decrypt(key, with_wheel, b"a") == b"x"
    assert port_symmetric.AES256GCM_IMPL == "OpenSSL"

    def hide_wheel():  # the module's names as its import without the wheel sets them
        monkeypatch.setattr(port_symmetric, "_aead", None)
        monkeypatch.setattr(port_symmetric, "InvalidTag", port_aesgcm.InvalidTag)

    hide_wheel()
    assert type(port_symmetric.aes256gcm(key)).__module__.endswith("core.aesgcm")
    assert aes.decrypt(key, with_wheel, b"a") == b"x"
    without = aes.encrypt(key, b"x")
    monkeypatch.undo()
    assert aes.decrypt(key, without) == b"x"
    hide_wheel()
    with pytest.raises(ValueError, match="authentication failed"):
        aes.decrypt(key, with_wheel, b"other ad")


def test_registry_aeads():
    assert list_symmetrics() == ["AES-256-GCM", "ChaCha20-Poly1305"]
    assert list_batched_aeads() == ["ChaCha20-Poly1305"]
    assert get_batched_aead("AES-256-GCM", backend="cpu") is None
    assert isinstance(get_batched_aead(get_symmetric("ChaCha20-Poly1305"), "cpu"),
                      ChaChaPolyDevice)
    with pytest.raises(KeyError):
        get_symmetric("RC4")
    with pytest.raises(ValueError, match="not supported"):
        get_batched_aead("ChaCha20-Poly1305", backend="auto")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            get_batched_aead("ChaCha20-Poly1305")  # the default backend is the GPU


def test_aead_health_check_passes_and_fails_on_a_broken_device():
    scalar = get_symmetric("ChaCha20-Poly1305")
    with BatchedAEAD(ChaChaPolyDevice("cpu")) as facade:
        verdict = _check_aead(facade, scalar)
        assert verdict.ok, verdict.detail
        assert [v.ok for v in gate_facades(facade, scalar=scalar)] == [True]
        good_seal = facade.algo.seal_batch
        facade.algo.seal_batch = lambda *a: [bytes(len(s)) for s in good_seal(*a)]
        assert not _check_aead(facade, scalar).ok
        with pytest.raises(RuntimeError, match="KAT mismatch"):
            gate_facades(facade, scalar=scalar)
    assert hashlib.sha256(bytes.fromhex(CT_HEX + TAG_HEX)).hexdigest() == (
        "4e54427e462f3beb69677d39865c5da8d57f603a85f7bf71368dce8ec9b9933c")
