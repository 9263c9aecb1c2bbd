"""The port's SHA-256 and SHA-512 (quantum_resistant_p2p_tpu_torch.core.sha256
/ sha512) on the CPU, held byte for byte to the JAX package and to hashlib.

The plain compressions are held to the JAX ``compress`` (jnp route,
QRP2P_PALLAS=0) and to the Pallas kernels' bodies ``_compress_tiles`` run
eagerly, as tests/test_sha256_pallas.py and tests/test_sha512_pallas.py run
them (Pallas interpret mode is unusable on the CPU for these kernels).  The
kernel wrappers raise on CPU tensors: K12 and K13 run only on a GPU
(tests/test_torch_gpu.py)."""

import gc
import hashlib
import hmac

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.core import sha256 as jsha256
from quantum_resistant_p2p_tpu.core import sha256_pallas, sha512_pallas
from quantum_resistant_p2p_tpu.core import sha512 as jsha512
from quantum_resistant_p2p_tpu_torch.core import sha256, sha256_cuda, sha512, sha512_cuda


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_clear_jax():
    """One PyTorch thread (xdist workers share the cores), and JAX's
    compiled programs released at the end (ROADMAP C1: each holds memory
    maps, and a worker process has a limit)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


def _random_256(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, (b, 8), dtype=np.uint32),
            rng.integers(0, 256, (b, 64), dtype=np.uint8))


def _random_512(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, (b, 8), dtype=np.uint32),
            rng.integers(0, 2**32, (b, 8), dtype=np.uint32),
            rng.integers(0, 256, (b, 128), dtype=np.uint8))


def _join(hi, lo) -> torch.Tensor:
    """(hi, lo) uint32 halves -> int64 words with the 64-bit bit pattern."""
    return torch.tensor(((hi.astype(np.uint64) << np.uint64(32)) | lo).view(np.int64))


def _split(words: torch.Tensor):
    u = words.numpy().view(np.uint64)
    return (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def test_sha256_compress_plain_matches_jax_and_pallas_body(monkeypatch):
    monkeypatch.setenv("QRP2P_PALLAS", "0")  # the jnp route of the JAX compress
    state, block = _random_256(6, 64)
    got = sha256.compress_plain(torch.tensor(state.astype(np.int64)), torch.tensor(block))
    assert np.array_equal(got.numpy(), np.asarray(jsha256.compress(jnp.asarray(state),
                                                                    jnp.asarray(block))))
    words = [jnp.asarray(state.T[i]) for i in range(8)] + [
        jsha256._block_words(jnp.asarray(block)).T[i] for i in range(16)]
    tiles = np.stack([np.asarray(o) for o in sha256_pallas._compress_tiles(words)], axis=-1)
    assert np.array_equal(got.numpy(), tiles)
    # the module function takes the plain path for a CPU tensor
    assert torch.equal(sha256.compress(torch.tensor(state.astype(np.int64)),
                                       torch.tensor(block)), got)


def test_sha512_compress_plain_matches_jax_and_pallas_body(monkeypatch):
    monkeypatch.setenv("QRP2P_PALLAS", "0")
    sh, sl, block = _random_512(6, 64)
    got = sha512.compress_plain(_join(sh, sl), torch.tensor(block))
    rh, rl = jsha512.compress((jnp.asarray(sh), jnp.asarray(sl)), jnp.asarray(block))
    gh, gl = _split(got)
    assert np.array_equal(gh, np.asarray(rh)) and np.array_equal(gl, np.asarray(rl))
    bh, bl = jsha512._block_words(jnp.asarray(block))
    words = [(jnp.asarray(sh.T[i]), jnp.asarray(sl.T[i])) for i in range(8)] + [
        (bh.T[i], bl.T[i]) for i in range(16)]
    out = sha512_pallas._compress_tiles(words)
    assert np.array_equal(gh, np.stack([np.asarray(o[0]) for o in out], axis=-1))
    assert np.array_equal(gl, np.stack([np.asarray(o[1]) for o in out], axis=-1))


@pytest.mark.parametrize("length", [0, 1, 3, 32, 55, 56, 63, 64, 65, 127, 128, 300])
def test_sha256_matches_hashlib(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(4, length), dtype=np.uint8)
    out = sha256.sha256(torch.tensor(data)).numpy()
    for i in range(4):
        assert bytes(out[i]) == hashlib.sha256(data[i].tobytes()).digest()


@pytest.mark.parametrize("length", [0, 1, 54, 111, 112, 127, 128, 129, 300])
def test_sha512_matches_hashlib(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(3, length), dtype=np.uint8)
    out = sha512.sha512(torch.tensor(data)).numpy()
    for i in range(3):
        assert bytes(out[i]) == hashlib.sha512(data[i].tobytes()).digest()


def test_sha512_int64_words_wrap_across_bits_31_and_63():
    """The plain SHA-512 relies on int64 addition wrapping modulo 2^64.  All
    0xFF state words and blocks make every addition carry across bit 31 and
    out of bit 63; the result must be the true compression, which a one-
    block message over an all-0xFF midstate checks against hashlib."""
    prefix = np.full((2, 128), 0xFF, dtype=np.uint8)
    tail = np.full((2, 111), 0xFF, dtype=np.uint8)  # pads to exactly one block
    tail[1, ::7] = 0x80
    state = sha512.midstate(torch.tensor(prefix))
    assert (state < 0).any()  # words with bit 63 set are negative int64s
    out = sha512.sha512_from_midstate(state, torch.tensor(tail), 1).numpy()
    for i in range(2):
        assert bytes(out[i]) == hashlib.sha512(prefix[i].tobytes() + tail[i].tobytes()).digest()
    big = torch.tensor([2**63 - 1, -1, -2**63], dtype=torch.int64)
    assert (big + torch.tensor([1, 1, -1])).tolist() == [-2**63, 0, 2**63 - 1]


def test_sha256_midstate_matches_jax_and_hashlib():
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 256, size=(3, 128), dtype=np.uint8)
    tail = rng.integers(0, 256, size=(3, 5, 22 + 16), dtype=np.uint8)
    st = sha256.midstate(torch.tensor(prefix))
    assert np.array_equal(st.numpy(), np.asarray(jsha256.midstate(prefix)).astype(np.int64))
    # one midstate a batch row serves its 5 rows: (3, 1, 8) against (3, 5, 38)
    out = sha256.sha256_from_midstate(st[:, None, :], torch.tensor(tail), 2).numpy()
    ref = np.asarray(jsha256.sha256_from_midstate(
        np.asarray(jsha256.midstate(prefix))[:, None, :].repeat(5, 1), tail, 2))
    assert np.array_equal(out, ref)
    for i in range(3):
        assert bytes(out[i, 4]) == hashlib.sha256(prefix[i].tobytes()
                                                  + tail[i, 4].tobytes()).digest()
    with pytest.raises(ValueError, match="multiple of 64"):
        sha256.midstate(torch.zeros((1, 63), dtype=torch.uint8))


def test_sha512_midstate_matches_jax_and_hashlib():
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, 256, size=(3, 128), dtype=np.uint8)
    tail = rng.integers(0, 256, size=(3, 4, 22 + 32), dtype=np.uint8)
    st = sha512.midstate(torch.tensor(prefix))
    jh, jl = jsha512.midstate(prefix)
    assert torch.equal(st, _join(np.asarray(jh), np.asarray(jl)))
    out = sha512.sha512_from_midstate(st[:, None, :], torch.tensor(tail), 1).numpy()
    ref = np.asarray(jsha512.sha512_from_midstate(
        (np.asarray(jh)[:, None].repeat(4, 1), np.asarray(jl)[:, None].repeat(4, 1)), tail, 1))
    assert np.array_equal(out, ref)
    for i in range(3):
        assert bytes(out[i, 3]) == hashlib.sha512(prefix[i].tobytes()
                                                  + tail[i, 3].tobytes()).digest()


@pytest.mark.parametrize("key_len", [0, 16, 32, 64, 100])
def test_hmac_sha256_matches_jax_and_stdlib(key_len):
    rng = np.random.default_rng(key_len)
    key = rng.integers(0, 256, size=(2, key_len), dtype=np.uint8)
    data = rng.integers(0, 256, size=(2, 77), dtype=np.uint8)
    out = sha256.hmac_sha256(torch.tensor(key), torch.tensor(data)).numpy()
    assert np.array_equal(out, np.asarray(jsha256.hmac_sha256(key, data)))
    for i in range(2):
        assert bytes(out[i]) == hmac.new(key[i].tobytes(), data[i].tobytes(),
                                         hashlib.sha256).digest()


@pytest.mark.parametrize("length", [16, 32, 42, 100])
def test_hkdf_sha256_matches_jax_and_rfc5869(length):
    rng = np.random.default_rng(length)
    ikm = rng.integers(0, 256, size=(2, 22), dtype=np.uint8)
    salt = rng.integers(0, 256, size=(2, 13), dtype=np.uint8)
    info = rng.integers(0, 256, size=(2, 10), dtype=np.uint8)
    out = sha256.hkdf_sha256(torch.tensor(ikm), torch.tensor(salt), torch.tensor(info),
                             length).numpy()
    assert np.array_equal(out, np.asarray(jsha256.hkdf_sha256(ikm, salt, info, length)))
    for i in range(2):  # RFC 5869 by hmac: extract, then expand
        prk = hmac.new(salt[i].tobytes(), ikm[i].tobytes(), hashlib.sha256).digest()
        okm, t = b"", b""
        for c in range(1, -(-length // 32) + 1):
            t = hmac.new(prk, t + info[i].tobytes() + bytes([c]), hashlib.sha256).digest()
            okm += t
        assert bytes(out[i]) == okm[:length]


def test_shared_state_rows_cost_no_copy():
    """The kernel's view of a broadcast midstate: one (S, 8) row per batch
    entry and the rows each serves; a broadcast in the middle is copied out."""
    st = torch.arange(3 * 8, dtype=torch.int64).reshape(3, 1, 1, 8)
    rows, per = sha256.state_rows(st, (3, 5, 7))
    assert rows.shape == (3, 8) and per == 35 and torch.equal(rows, st.reshape(3, 8))
    rows, per = sha256.state_rows(st.reshape(3, 8), (3,))
    assert rows.shape == (3, 8) and per == 1
    rows, per = sha256.state_rows(torch.arange(8, dtype=torch.int64), (4, 2))
    assert rows.shape == (1, 8) and per == 8
    mid = torch.arange(2 * 8, dtype=torch.int64).reshape(1, 2, 8)
    rows, per = sha256.state_rows(mid, (3, 2))
    assert rows.shape == (6, 8) and per == 1 and torch.equal(rows[4], mid[0, 0])


@pytest.mark.parametrize("wrapper,width", [(sha256_cuda.compress, 64),
                                           (sha512_cuda.compress, 128)])
def test_kernel_wrappers_raise_on_cpu_tensors(wrapper, width):
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(torch.zeros((2, 8), dtype=torch.int64), torch.zeros((2, width), dtype=torch.uint8))
    assert wrapper.launches == before


@pytest.mark.parametrize("split_rule,rows,blocks,want", [
    # K12 on a 132-SM card: the SPHINCS+ shapes
    (sha256_cuda.split_rule, 1024 * 8, 10, True),        # 128f T_l, sign at B = 1024
    (sha256_cuda.split_rule, 2048, 10, True),            # 128s T_l of a verify flush
    (sha256_cuda.split_rule, 1024 * 8 * 35, 1, False),   # 128f chain step
    (sha256_cuda.split_rule, 1024 * 33 * 64, 1, False),  # 128f FORS leaves
    # K13 (the same rule): 192f T_l at B = 256, FORS level 1
    (sha256_cuda.split_rule, 256 * 8, 10, True),
    (sha256_cuda.split_rule, 256 * 33 * 128, 1, False),
])
def test_sha2_path_rule_at_the_sphincs_shapes(split_rule, rows, blocks, want):
    assert split_rule(rows, blocks, 132) is want


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
def test_sha2_path_rule_edges(sms):
    """Few rows of two blocks or more take the few-row path, up to the
    crossover's rows an SM (exclusive); one block a row never does."""
    rule, edge = sha256_cuda.split_rule, sha256_cuda.SPLIT_ROWS_PER_SM * sms
    assert rule(1, 2, sms) and rule(edge - 1, 2, sms)
    assert not rule(edge, 2, sms) and not rule(edge, 17, sms)
    assert not rule(1, 1, sms) and not rule(edge - 1, 1, sms)
    assert rule(edge, 2, sms + 1) and not rule(edge - 1, 2, sms - 1)


@pytest.mark.parametrize("wrapper,width", [(sha256_cuda.compress, 64),
                                           (sha512_cuda.compress, 128)])
def test_kernel_wrappers_raise_on_bad_shapes_and_paths(wrapper, width):
    """Shapes and the path are checked before the device: each of these
    raises on the CPU with its own message and counts no launch."""
    st, blk = torch.zeros((2, 8), dtype=torch.int64), torch.zeros((2, width), dtype=torch.uint8)
    before = wrapper.launches, wrapper.split_launches
    for args, match in (((st[:, :7], blk), "state must be"),
                        ((st, blk[:, :-1]), "blocks must be"),
                        ((st, blk[:, :0]), "blocks must be"),
                        ((st, blk, 2), "rows for 2 states"),
                        ((st, blk, 0), "rows for 2 states")):
        with pytest.raises(ValueError, match=match):
            wrapper(*args)
    with pytest.raises(ValueError, match="path must be"):
        sha256_cuda.launch(width, st, blk, path="warp")
    assert (wrapper.launches, wrapper.split_launches) == before
