"""The port's ML-KEM (quantum_resistant_p2p_tpu_torch.kem.mlkem) against the
JAX package's, byte for byte, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
functions run jitted on the CPU (tests/conftest.py pins the platform), so
they take their jnp paths; the port's CPU tensors take the plain PyTorch
versions of kernels K2-K4.  Crypto has no tolerance: every comparison is
exact.  The kernels themselves run only on a GPU (tests/test_torch_gpu.py).
"""

import functools
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.core.sortnet import bitonic_sort
from quantum_resistant_p2p_tpu.kem import mlkem as jm
from quantum_resistant_p2p_tpu.pyref import mlkem_ref as ref
from quantum_resistant_p2p_tpu_torch.kem import mlkem as tm
from quantum_resistant_p2p_tpu_torch.kem import mlkem_cuda, params

VECTOR_DIR = Path(__file__).parent / "vectors"
B = 8


def _u8(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jax_fns():
    """One jit per JAX function compared below."""
    return {
        "sample_ntt": jax.jit(jm.sample_ntt),
        "ntt": jax.jit(jm.ntt),
        "ntt_inv": jax.jit(jm.ntt_inv),
        "prf_cbd": {eta: jax.jit(lambda s, eta=eta: jm._prf_cbd(s, np.arange(3), eta))
                    for eta in (2, 3)},
        "prf_cbd_ntt": {eta: jax.jit(lambda s, eta=eta: jm._prf_cbd_ntt(s, np.arange(3), eta))
                        for eta in (2, 3)},
    }


def test_tables_and_params_match_pyref():
    assert params.ZETAS == tuple(ref.ZETAS)
    assert params.GAMMAS == tuple(ref.GAMMAS)
    for name, p in ref.PARAMS.items():
        q = params.PARAMS[name]
        assert (q.k, q.eta1, q.eta2, q.du, q.dv) == (p.k, p.eta1, p.eta2, p.du, p.dv)
        assert (q.ek_len, q.dk_len, q.ct_len) == (p.ek_len, p.dk_len, p.ct_len)


def test_sample_ntt_matches_jax(jax_fns):
    seeds = _u8(1, B, 34)
    got = tm.sample_ntt(_t(seeds)).numpy()
    assert np.array_equal(got, np.asarray(jax_fns["sample_ntt"](seeds)))


@pytest.mark.parametrize("eta", [2, 3])
def test_prf_cbd_matches_jax(jax_fns, eta):
    s = _u8(10 + eta, B, 32)
    got = tm._prf_cbd(_t(s), range(3), eta).numpy()
    assert got.shape == (B, 3, 256)
    assert np.array_equal(got, np.asarray(jax_fns["prf_cbd"][eta](s)))


@pytest.mark.parametrize("eta", [2, 3])
def test_prf_cbd_ntt_matches_jax(jax_fns, eta):
    s = _u8(20 + eta, B, 32)
    got = tm._prf_cbd_ntt(_t(s), range(3), eta).numpy()
    assert np.array_equal(got, np.asarray(jax_fns["prf_cbd_ntt"][eta](s)))


@pytest.mark.parametrize("name", ["ntt", "ntt_inv"])
def test_ntt_matches_jax(jax_fns, name):
    f = np.random.default_rng(30).integers(0, params.Q, size=(B, 256), dtype=np.int32)
    got = getattr(tm, name)(_t(f)).numpy()
    assert np.array_equal(got, np.asarray(jax_fns[name](f)))


def _bitonic_compaction(cand: np.ndarray) -> np.ndarray:
    """The reference's formulation (kem/mlkem.py:212-221): sort key
    accepted-before-rejected | index | value through the bitonic network."""
    nc = cand.shape[-1]
    idx = np.arange(nc, dtype=np.int32)
    key = np.where(cand < params.Q, 0, 1 << 21) | (idx << 12) | cand
    np2 = 1 << (nc - 1).bit_length()
    key = np.pad(key, [(0, 0), (0, np2 - nc)], constant_values=1 << 22)
    return np.asarray(bitonic_sort(jnp.asarray(key, jnp.int32)))[:, :256] & 0xFFF


def test_short_fill_compaction_matches_bitonic_formulation():
    """Rows with more than 192 rejections out of 448, which SHAKE output
    never gives in practice: the tail must hold the rejected candidates in
    order, as the reference's sort key puts them."""
    rng = np.random.default_rng(40)
    rows = []
    for n_rejected in (193, 250, 300, 448, 192, 0):
        cand = rng.integers(0, params.Q, size=448).astype(np.int32)
        pos = rng.choice(448, size=n_rejected, replace=False)
        cand[pos] = rng.integers(params.Q, 4096, size=n_rejected)
        rows.append(cand)
    cand = np.stack(rows)
    got = tm._compact_accepted(_t(cand)).numpy()
    assert np.array_equal(got, _bitonic_compaction(cand))
    assert (got[0] >= params.Q).sum() == 256 - (448 - 193)  # short fill reached


@pytest.fixture(scope="module")
def jax768():
    return jm.get("ML-KEM-768")


def test_mlkem768_keygen_encaps_decaps_match_jax(jax768):
    p = tm.MLKEM768
    kg, enc, dec = jax768
    d, z, m = _u8(50, 4, 32), _u8(51, 4, 32), _u8(52, 4, 32)
    ek_j, dk_j = map(np.asarray, kg(d, z))
    key_j, ct_j = map(np.asarray, enc(ek_j, m))
    key2_j = np.asarray(dec(dk_j, ct_j))

    ek, dk = tm.keygen(p, _t(d), _t(z))
    key, ct = tm.encaps(p, ek, _t(m))
    key2 = tm.decaps(p, dk, ct)
    assert np.array_equal(ek.numpy(), ek_j) and np.array_equal(dk.numpy(), dk_j)
    assert np.array_equal(ct.numpy(), ct_j) and np.array_equal(key.numpy(), key_j)
    assert np.array_equal(key2.numpy(), key2_j) and np.array_equal(key2.numpy(), key_j)


def test_precompute_from_numpy_roundtrip(jax768):
    """The JAX per-key precompute, carried into the port, drives encaps_pre
    (one unbatched key broadcast against a batch of m) to the JAX output."""
    p = tm.MLKEM768
    kg, enc, _ = jax768
    d, z, m = _u8(60, 4, 32), _u8(61, 4, 32), _u8(62, 4, 32)
    ek_j = np.asarray(kg(d, z)[0])
    pre_j = jax.jit(functools.partial(jm.precompute_ek, jm.MLKEM768))(ek_j[0])
    pre_np = {k: np.asarray(v) for k, v in pre_j.items()}
    pre = tm.precompute_from_numpy(pre_np, "cpu")
    assert pre["t_hat"].dtype == torch.int32 and pre["h_ek"].dtype == torch.uint8
    eks = np.broadcast_to(ek_j[:1], ek_j.shape).copy()
    key_j, ct_j = map(np.asarray, enc(eks, m))
    key, ct = tm.encaps_pre(p, pre, _t(m))
    assert np.array_equal(key.numpy(), key_j) and np.array_equal(ct.numpy(), ct_j)
    own = tm.precompute_ek(p, _t(ek_j[0]))
    for name, arr in pre_np.items():
        assert np.array_equal(own[name].numpy(), arr), name
    pre2, key2, ct2 = tm.encaps_cold(p, _t(ek_j[0]), _t(m))
    assert torch.equal(key2, key) and torch.equal(ct2, ct)


def test_tampered_ciphertext_takes_implicit_rejection(jax768):
    p = tm.MLKEM768
    kg, enc, dec = jax768
    d, z, m = _u8(70, 4, 32), _u8(71, 4, 32), _u8(72, 4, 32)
    ek, dk = tm.keygen(p, _t(d), _t(z))
    key, ct = tm.encaps(p, ek, _t(m))
    bad = ct.clone()
    bad[:, 0] ^= 1
    rejected = tm.decaps(p, dk, bad).numpy()
    assert np.array_equal(rejected, np.asarray(dec(dk.numpy(), bad.numpy())))
    for i in range(2):
        z_c = dk[i, -32:].numpy().tobytes() + bad[i].numpy().tobytes()
        assert rejected[i].tobytes() == hashlib.shake_256(z_c).digest(32)
        assert rejected[i].tobytes() != key[i].numpy().tobytes()


def _check(rec: dict, name: str, got: bytes) -> None:
    if name in rec:
        assert got.hex() == rec[name], name
    else:
        assert hashlib.sha256(got).hexdigest() == rec[name + "_sha256"], name


@pytest.mark.parametrize("fname", ["mlkem_512.json", "mlkem_768.json", "mlkem_1024.json"])
def test_vectors_through_the_port(fname):
    data = json.loads((VECTOR_DIR / fname).read_text())
    p = tm.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8)

    ek, dk = tm.keygen(p, col("d"), col("z"))
    key, ct = tm.encaps(p, ek, col("m"))
    key2 = tm.decaps(p, dk, ct)
    bad = ct.clone()
    bad[:, 0] ^= 1
    rej = tm.decaps(p, dk, bad)
    for i, rec in enumerate(recs):
        for name, t in (("ek", ek), ("dk", dk), ("ct", ct), ("ss", key), ("ss", key2),
                        ("ss_reject", rej)):
            _check(rec, name, bytes(t[i].numpy()))


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        mlkem_cuda.sample_ntt(torch.zeros((2, 34), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mlkem_cuda.ntt(torch.zeros((2, 256), dtype=torch.int32))
    before = {n: getattr(mlkem_cuda, n).launches
              for n in ("sample_ntt", "prf_cbd", "prf_cbd_ntt", "ntt", "ntt_inv")}
    tm.keygen(tm.MLKEM512, torch.zeros((1, 32), dtype=torch.uint8),
              torch.zeros((1, 32), dtype=torch.uint8))
    assert before == {n: getattr(mlkem_cuda, n).launches for n in before}
