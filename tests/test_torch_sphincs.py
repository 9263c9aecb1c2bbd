"""The port's SPHINCS+-SHA2 (quantum_resistant_p2p_tpu_torch.sig.sphincs) on
the CPU, held byte for byte to the reference's pure-Python SLH-DSA
(``pyref.slhdsa_ref``, the JAX module's own oracle), to the JAX module's
helpers and to tests/vectors/slhdsa_*.json.

Every hash here runs the plain compressions (~13 ms a call, ~1,000 calls a
128f signature), so signatures are shared through module fixtures.  The
comparisons with the JAX ``sign_digest`` / ``sign_digest_layered`` /
``verify_digest`` compile large programs and are slow-tier, as
tests/test_sphincs.py is."""

import gc
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.pyref import slhdsa_ref
from quantum_resistant_p2p_tpu.sig import sphincs as jsphincs
from quantum_resistant_p2p_tpu_torch.provider import get_signature
from quantum_resistant_p2p_tpu_torch.sig import slhdsa_params, sphincs

VECTOR_DIR = Path(__file__).parent / "vectors"
NAMES = [f"SPHINCS+-SHA2-{s}-simple" for s in ("128s", "128f", "192s", "192f", "256s", "256f")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_clear_jax():
    """One PyTorch thread (xdist workers share the cores), and JAX's
    compiled programs released at the end (ROADMAP C1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


def _rows(rows) -> torch.Tensor:
    return torch.tensor(np.stack([np.frombuffer(r, np.uint8) for r in rows]))


def _host_digests(p, sks, msgs):
    """PRF_msg (opt_rand = pk_seed, the deterministic variant) and H_msg."""
    rs, digests = [], []
    for sk, msg in zip(sks, msgs):
        pk_seed, pk_root = sk[2 * p.n: 3 * p.n], sk[3 * p.n:]
        r = slhdsa_params.prf_msg(p, sk[p.n: 2 * p.n], pk_seed, msg)
        rs.append(r)
        digests.append(slhdsa_params.h_msg(p, r, pk_seed, pk_root, msg))
    return rs, digests


def _through_the_port(fname):
    """keygen, sign and verify of a vector file's records as one batch."""
    data = json.loads((VECTOR_DIR / fname).read_text())
    p = slhdsa_params.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return _rows(bytes.fromhex(r[key]) for r in recs)

    pk, sk = sphincs.keygen(p, col("sk_seed"), col("sk_prf"), col("pk_seed"))
    msgs = [bytes.fromhex(r["msg"]) for r in recs]
    rs, digests = _host_digests(p, [bytes(s.numpy()) for s in sk], msgs)
    sig = sphincs.sign_digest(p, sk, _rows(rs), _rows(digests))
    bad = sig.clone()
    bad[:, -1] ^= 1
    ok = sphincs.verify_digest(p, pk.repeat(2, 1), _rows(digests + digests),
                               torch.cat([sig, bad]))
    return recs, pk, sk, sig, ok, msgs


@pytest.fixture(scope="module")
def vectors_128f():
    return _through_the_port("slhdsa_128f.json")


def _check_vectors(recs, pk, sig, ok):
    for i, rec in enumerate(recs):
        assert bytes(pk[i].numpy()).hex() == rec["pk"]
        assert hashlib.sha256(bytes(sig[i].numpy())).hexdigest() == rec["sig_sha256"]
    assert ok.tolist() == [True] * len(recs) + [False] * len(recs)


# --------------------------------------------------------------------------
# parameters and host hashes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_params_match_pyref(name):
    p, ref = slhdsa_params.PARAMS[name], slhdsa_ref.PARAMS[name]
    for field in ("name", "n", "h", "d", "hp", "a", "k", "m", "len1", "len2", "wots_len",
                  "pk_len", "sk_len", "sig_len", "big_hash"):
        assert getattr(p, field) == getattr(ref, field), field
    assert (slhdsa_params.W, slhdsa_params.LG_W) == (slhdsa_ref.W, slhdsa_ref.LG_W)
    assert ([slhdsa_params.WOTS_HASH, slhdsa_params.WOTS_PK, slhdsa_params.TREE,
             slhdsa_params.FORS_TREE, slhdsa_params.FORS_ROOTS, slhdsa_params.WOTS_PRF,
             slhdsa_params.FORS_PRF]
            == [slhdsa_ref.WOTS_HASH, slhdsa_ref.WOTS_PK, slhdsa_ref.TREE, slhdsa_ref.FORS_TREE,
                slhdsa_ref.FORS_ROOTS, slhdsa_ref.WOTS_PRF, slhdsa_ref.FORS_PRF])
    rng = np.random.default_rng(p.n + p.hp)
    sk_prf, opt, seed, root = (rng.bytes(p.n) for _ in range(4))
    for msg in (b"", rng.bytes(1), rng.bytes(300)):
        r = slhdsa_params.prf_msg(p, sk_prf, opt, msg)
        assert r == slhdsa_ref.prf_msg(ref, sk_prf, opt, msg)
        assert (slhdsa_params.h_msg(p, r, seed, root, msg)
                == slhdsa_ref.h_msg(ref, r, seed, root, msg))


# --------------------------------------------------------------------------
# the helpers, against the JAX module's (eager, cheap)
# --------------------------------------------------------------------------


def test_adrs_matches_jax():
    rng = np.random.default_rng(1)
    tree8 = rng.integers(0, 256, (2, 8), dtype=np.uint8)
    kp = rng.integers(0, 1 << 9, (2,), dtype=np.int64)
    gidx = np.arange(3 * 4).reshape(3, 4)
    lead = (2, 3, 4)
    got = sphincs._adrs(lead, 5, torch.tensor(tree8), slhdsa_params.FORS_TREE,
                        torch.tensor(kp)[:, None, None], 7, torch.tensor(gidx), torch.device("cpu"))
    want = jsphincs._adrs(lead, 5, jnp.asarray(tree8), slhdsa_params.FORS_TREE,
                          jnp.asarray(kp.astype(np.int32))[:, None, None], 7,
                          jnp.asarray(gidx.astype(np.int32)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = sphincs._adrs((2,), 21, None, slhdsa_params.WOTS_PK, 0x01020304, 0, 70000,
                        torch.device("cpu"))
    want = jsphincs._adrs((2,), 21, None, slhdsa_params.WOTS_PK, 0x01020304, 0, 70000)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_index_helpers_match_jax(name):
    """_wots_digits, _digest_split, _tree8_at (every layer), _leaf_at and
    _fors_indices on random digests."""
    p = slhdsa_params.PARAMS[name]
    rng = np.random.default_rng(p.m)
    digest = rng.integers(0, 256, (4, p.m), dtype=np.uint8)
    msg = rng.integers(0, 256, (4, p.n), dtype=np.uint8)
    assert np.array_equal(sphincs._wots_digits(p, torch.tensor(msg)).numpy(),
                          np.asarray(jsphincs._wots_digits(p, jnp.asarray(msg))))
    md, bits, leaf = sphincs._digest_split(p, torch.tensor(digest))
    jmd, jbits, jleaf = jsphincs._digest_split(p, jnp.asarray(digest))
    for got, want in ((md, jmd), (bits, jbits), (leaf, jleaf)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for j in range(p.d):
        assert np.array_equal(sphincs._tree8_at(p, bits, j).numpy(),
                              np.asarray(jsphincs._tree8_at(p, jbits, j)))
        if j:
            assert np.array_equal(sphincs._leaf_at(p, bits, j).numpy(),
                                  np.asarray(jsphincs._leaf_at(p, jbits, j)))
    assert np.array_equal(sphincs._fors_indices(p, md).numpy(),
                          np.asarray(jsphincs._fors_indices(p, jmd)))


@pytest.mark.parametrize("name", ["SPHINCS+-SHA2-128f-simple", "SPHINCS+-SHA2-256f-simple"])
def test_ctx_hashes_match_jax(name):
    """_Ctx.f (SHA-256) and _Ctx.t (SHA-256 at n = 16, SHA-512 at n = 32)
    over a (B, 3, 5) lead, the midstate broadcast from (B, 8)."""
    p = slhdsa_params.PARAMS[name]
    rng = np.random.default_rng(p.n)
    pk_seed = rng.integers(0, 256, (2, p.n), dtype=np.uint8)
    adrs = rng.integers(0, 256, (2, 3, 5, 22), dtype=np.uint8)
    m1 = rng.integers(0, 256, (2, 3, 5, p.n), dtype=np.uint8)
    m2 = rng.integers(0, 256, (2, 3, 5, 2 * p.n), dtype=np.uint8)
    ctx, jctx = sphincs._Ctx(p, torch.tensor(pk_seed)), jsphincs._Ctx(p, jnp.asarray(pk_seed))
    assert np.array_equal(ctx.f(torch.tensor(adrs), torch.tensor(m1)).numpy(),
                          np.asarray(jctx.f(jnp.asarray(adrs), jnp.asarray(m1))))
    got = ctx.t(torch.tensor(adrs), torch.tensor(m2)).numpy()
    assert np.array_equal(got, np.asarray(jctx.t(jnp.asarray(adrs), jnp.asarray(m2))))
    hasher = hashlib.sha512 if p.big_hash else hashlib.sha256
    block = 128 if p.big_hash else 64
    assert bytes(got[1, 2, 4]) == hasher(pk_seed[1].tobytes() + bytes(block - p.n)
                                         + adrs[1, 2, 4].tobytes()
                                         + m2[1, 2, 4].tobytes()).digest()[: p.n]


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_keygen_matches_pyref(name):
    p = slhdsa_params.PARAMS[name]
    rng = np.random.default_rng(3 * p.n + p.hp)
    seeds = [rng.bytes(p.n) for _ in range(3)]
    pk, sk = sphincs.keygen(p, *(_rows([s]) for s in seeds))
    ref_pk, ref_sk = slhdsa_ref.keygen(slhdsa_ref.PARAMS[name], *seeds)
    assert bytes(pk[0].numpy()) == ref_pk and bytes(sk[0].numpy()) == ref_sk


def test_vectors_128f_through_the_plain_path(vectors_128f):
    recs, pk, _, sig, ok, _ = vectors_128f
    _check_vectors(recs, pk, sig, ok)


def test_vectors_128s_through_the_plain_path():
    recs, pk, _, sig, ok, _ = _through_the_port("slhdsa_128s.json")
    _check_vectors(recs, pk, sig, ok)


@pytest.mark.slow
@pytest.mark.parametrize("size", ["192f", "192s", "256f", "256s"])
def test_vectors_other_sets_through_the_plain_path(size):
    recs, pk, _, sig, ok, _ = _through_the_port(f"slhdsa_{size}.json")
    _check_vectors(recs, pk, sig, ok)


def test_acvp_128f_keygen_fixture():
    data = json.loads((VECTOR_DIR / "acvp_slhdsa128f_fixture.json").read_text())
    p = slhdsa_params.PARAMS[data["algorithm"]]
    (group,) = [g for g in data["testGroups"] if "skSeed" in g["tests"][0]]
    tests = group["tests"]

    def col(key):
        return _rows(bytes.fromhex(t[key]) for t in tests)

    pk, sk = sphincs.keygen(p, col("skSeed"), col("skPrf"), col("pkSeed"))
    for i, t in enumerate(tests):
        assert bytes(pk[i].numpy()).hex() == t["pk"]
        assert bytes(sk[i].numpy()).hex() == t["sk"]


def test_verify_accepts_a_pyref_signature_and_rejects_a_flipped_byte():
    p = slhdsa_params.SLH128F
    ref = slhdsa_ref.PARAMS[p.name]
    rng = np.random.default_rng(128)
    pk, sk = slhdsa_ref.keygen(ref, *(rng.bytes(p.n) for _ in range(3)))
    msg = rng.bytes(57)
    sig = slhdsa_ref.sign_internal(ref, msg, sk, None)
    bad = bytearray(sig)
    bad[rng.integers(p.n, p.sig_len)] ^= 0x10
    digests = [slhdsa_params.h_msg(p, s[: p.n], pk[: p.n], pk[p.n:], msg) for s in (sig, bad)]
    ok = sphincs.verify_digest(p, _rows([pk, pk]), _rows(digests), _rows([sig, bytes(bad)]))
    assert ok.tolist() == [True, False]


def test_memory_chunks_give_the_bytes_of_one_call(vectors_128f, monkeypatch):
    """sign_batch with a budget of one signature a chunk signs the three
    128f records in three calls, to the bytes of the one call above."""
    _, _, sk, sig, _, msgs = vectors_128f
    dsa = get_signature("SPHINCS+-SHA2-128f-simple", backend="cpu")
    p = dsa.params
    budget = sphincs.rows_in_flight(p) * sphincs.BYTES_PER_ROW
    assert sphincs.signatures_per_chunk(p, budget) == 1
    assert sphincs.signatures_per_chunk(p, 3 * budget + budget // 2) == 3
    assert sphincs.signatures_per_chunk(p, 0) == 1
    calls = []
    sign = dsa._sign_digest
    dsa._sign_digest = lambda *a: calls.append(len(a[0])) or sign(*a)
    monkeypatch.setattr(dsa, "memory_budget", lambda: budget)
    chunked = dsa.sign_batch(sk.numpy(), msgs)
    assert calls == [1, 1, 1]
    assert chunked == [bytes(s.numpy()) for s in sig]


# --------------------------------------------------------------------------
# against the JAX functions (slow tier: they compile large programs)
# --------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", ["SPHINCS+-SHA2-128f-simple", "SPHINCS+-SHA2-128s-simple"])
def test_sign_and_verify_match_jax(name, monkeypatch):
    monkeypatch.setenv("QRP2P_PALLAS", "0")
    p = slhdsa_params.PARAMS[name]
    rng = np.random.default_rng(p.hp)
    seeds = [rng.integers(0, 256, (2, p.n), dtype=np.uint8) for _ in range(3)]
    pk, sk = sphincs.keygen(p, *(torch.tensor(s) for s in seeds))
    jkg, _, jverify = jsphincs.get(name)
    jpk, jsk = jkg(*seeds)
    assert np.array_equal(pk.numpy(), np.asarray(jpk))
    assert np.array_equal(sk.numpy(), np.asarray(jsk))
    r = rng.integers(0, 256, (2, p.n), dtype=np.uint8)
    digest = rng.integers(0, 256, (2, p.m), dtype=np.uint8)
    sig = sphincs.sign_digest(p, sk, torch.tensor(r), torch.tensor(digest)).numpy()
    skn = sk.numpy()
    assert np.array_equal(sig, np.asarray(jax.jit(
        lambda *a: jsphincs.sign_digest(jsphincs.PARAMS[name], *a))(skn, r, digest)))
    assert np.array_equal(sig, np.asarray(jsphincs.sign_digest_layered(
        jsphincs.PARAMS[name], skn, r, digest)))
    bad = sig.copy()
    bad[1, -1] ^= 1
    both = np.concatenate([sig, bad])
    two = np.concatenate([digest, digest])
    keys = np.concatenate([pk.numpy(), pk.numpy()])
    got = sphincs.verify_digest(p, torch.tensor(keys), torch.tensor(two), torch.tensor(both))
    assert got.tolist() == np.asarray(jverify(keys, two, both)).tolist() == [True, True, True,
                                                                               False]
