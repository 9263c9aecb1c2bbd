"""The port's Keccak sponge (quantum_resistant_p2p_tpu_torch.core.keccak)
against the JAX package's sponge and hashlib, byte for byte.

Inputs are made from a seed with numpy and given to both sides; the JAX
side runs on the CPU (tests/conftest.py pins it), so it takes its jnp path.
The CUDA kernel K1 runs only on a GPU: tests/test_torch_gpu.py holds it
to the plain version there.  The module clears JAX's caches at its end
(ROADMAP C1).
"""

import gc
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.core import keccak as jk
from quantum_resistant_p2p_tpu_torch.core import keccak as tk
from quantum_resistant_p2p_tpu_torch.core import keccak_cuda
from quantum_resistant_p2p_tpu_torch.utils import cuda

# name -> (rate, port function, JAX function, hashlib reference)
FUNCS = {
    "shake128": (168, lambda x: tk.shake128(x, 200), lambda x: jk.shake128(x, 200),
                 lambda b: hashlib.shake_128(b).digest(200)),
    "shake256": (136, lambda x: tk.shake256(x, 300), lambda x: jk.shake256(x, 300),
                 lambda b: hashlib.shake_256(b).digest(300)),
    "sha3_256": (136, tk.sha3_256, jk.sha3_256, lambda b: hashlib.sha3_256(b).digest()),
    "sha3_512": (72, tk.sha3_512, jk.sha3_512, lambda b: hashlib.sha3_512(b).digest()),
}


@pytest.fixture(scope="module", autouse=True)
def _release_jax():
    yield
    jax.clear_caches()
    gc.collect()


def _rows(seed: int, n: int, length: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, length), dtype=np.uint8)


@pytest.mark.parametrize("name", sorted(FUNCS))
@pytest.mark.parametrize("offset", [None, -1, 0, 1])
def test_sponge_matches_jax_and_hashlib(name, offset):
    """Message lengths 0, rate-1, rate and rate+1 (block edges)."""
    rate, port_fn, jax_fn, ref = FUNCS[name]
    length = 0 if offset is None else rate + offset
    x = _rows(length + rate, 3, length)
    got = port_fn(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jax_fn(x)))
    for i in range(3):
        assert bytes(got[i]) == ref(x[i].tobytes())


@pytest.mark.parametrize("name", ["sha3_256", "shake256"])
def test_ten_block_absorb(name):
    """H(ek) of ML-KEM-768 absorbs 1184 bytes, 9 full blocks and a tail."""
    _, port_fn, jax_fn, ref = FUNCS[name]
    x = _rows(1184, 2, 1184)
    got = port_fn(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jax_fn(x)))
    assert bytes(got[1]) == ref(x[1].tobytes())


def test_keccak_f1600_matches_jax():
    """The plain permutation on int64 lanes against the JAX hi/lo form."""
    lanes = np.random.default_rng(7).integers(0, 2**64, size=(5, 25), dtype=np.uint64)
    hi = (lanes >> np.uint64(32)).astype(np.uint32)
    lo = (lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    jh, jl = jk.keccak_f1600(jnp.asarray(hi), jnp.asarray(lo))
    want = (np.asarray(jh).astype(np.uint64) << np.uint64(32)) | np.asarray(jl).astype(np.uint64)
    got = tk.keccak_f1600(torch.from_numpy(lanes.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, want)


def _jax_f1600(lanes: np.ndarray) -> np.ndarray:
    hi = (lanes >> np.uint64(32)).astype(np.uint32)
    lo = (lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    jh, jl = jk.keccak_f1600(jnp.asarray(hi), jnp.asarray(lo))
    return (np.asarray(jh).astype(np.uint64) << np.uint64(32)) | np.asarray(jl).astype(np.uint64)


@pytest.mark.parametrize("rows", [1, 3, 64])
def test_lane_major_permutation_matches_jax(rows):
    """The lane-major rounds (row gathers, in-place ops) against the JAX
    permutation at 1, 3 and 64 states, twice in a row, with a leading batch
    shape; the input is left as it was."""
    lanes = np.random.default_rng(rows).integers(0, 2**64, size=(rows, 25), dtype=np.uint64)
    lanes[0, :] = [0, 2**64 - 1, 2**63, 1, 2**63 - 1] * 5  # sign bits, carries of rotl(., 1)
    x = torch.from_numpy(lanes.view(np.int64).copy())
    once = tk.keccak_f1600(x)
    assert torch.equal(x, torch.from_numpy(lanes.view(np.int64)))
    assert np.array_equal(once.numpy().view(np.uint64), _jax_f1600(lanes))
    twice = tk.keccak_f1600(once.reshape(1, rows, 25)).reshape(rows, 25)
    assert np.array_equal(twice.numpy().view(np.uint64), _jax_f1600(_jax_f1600(lanes)))


def test_round_tables_are_built_once_a_device():
    tk.keccak_f1600(torch.zeros((1, 25), dtype=torch.int64))
    hits = tk._round_tables.cache_info().hits
    first = tk._round_tables(torch.device("cpu"))
    tk.sha3_256(torch.zeros((2, 300), dtype=torch.uint8))  # three permutations
    assert tk._round_tables(torch.device("cpu")) is first
    assert tk._round_tables.cache_info().hits >= hits + 4
    assert len(first[-1]) == 24 and first[-1][3].shape == (25, 1)


@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("name", ["shake128", "shake256", "sha3_512"])
def test_multiblock_absorb_and_squeeze_match_jax_and_hashlib(name, rows):
    """Three blocks and a tail absorbed, and (SHAKE) four blocks squeezed,
    at 1, 3 and 64 rows."""
    rate = FUNCS[name][0]
    out_len = 3 * rate + 7
    x = _rows(rows + rate, rows, 3 * rate + 5)
    if name == "sha3_512":
        port, ref = tk.sha3_512, (lambda b: hashlib.sha3_512(b).digest())
        want = np.asarray(jk.sha3_512(x))
    else:
        port = (lambda t: tk.shake128(t, out_len)) if rate == 168 else (
            lambda t: tk.shake256(t, out_len))
        ref = (lambda b: getattr(hashlib, name.replace("shake", "shake_"))(b).digest(out_len))
        want = np.asarray(getattr(jk, name)(x, out_len))
    got = port(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert all(bytes(got[i]) == ref(x[i].tobytes()) for i in range(rows))


@pytest.mark.parametrize("rows", [1, 3, 64])
def test_varlen_sponge_matches_jax_and_hashlib(rows):
    """Per-row lengths over four blocks of 136, every residue near the block
    edges among them, squeezing two blocks."""
    x = _rows(rows, rows, 4 * 136 + 3)
    lens = (np.arange(rows) * 37 + 133) % (x.shape[1] + 1)
    got = tk.shake256_varlen(torch.from_numpy(x), torch.from_numpy(lens), 200).numpy()
    want = np.asarray(jk.shake256_varlen(x, jnp.asarray(lens, jnp.int32), 200))
    assert np.array_equal(got, want)
    for i in range(rows):
        assert bytes(got[i]) == hashlib.shake_256(x[i, :lens[i]].tobytes()).digest(200)


def test_batch_shapes_and_seed_rows():
    x = _rows(3, 6, 34).reshape(2, 3, 34)
    out = tk.shake128(torch.from_numpy(x), 64)
    assert out.shape == (2, 3, 64)
    assert bytes(out[1, 2].numpy()) == hashlib.shake_128(x[1, 2].tobytes()).digest(64)
    rows, batch = tk.seed_rows(torch.from_numpy(x))
    assert rows.shape == (6, 34) and batch == (2, 3) and rows.is_contiguous()


def test_cpu_tensors_never_reach_the_kernel():
    before = keccak_cuda.sponge.launches
    tk.sha3_256(torch.zeros((4, 10), dtype=torch.uint8))
    assert keccak_cuda.sponge.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        keccak_cuda.sponge(torch.zeros((4, 10), dtype=torch.uint8), 136, 0x06, 32)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails must surface as an error, not a fallback."""
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        cuda.build(("sponge",))
    assert not list(tmp_path.glob("*.so"))
