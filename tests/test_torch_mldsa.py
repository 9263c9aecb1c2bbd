"""The port's ML-DSA (quantum_resistant_p2p_tpu_torch.sig.mldsa) against the
JAX package's, byte for byte, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
functions run jitted on the CPU (tests/conftest.py pins the platform), so
they take their jnp paths, which tests/test_mldsa_pallas.py holds to the
Pallas kernels; the port's CPU tensors take the plain PyTorch versions of
kernels K5-K7.  Crypto has no tolerance: every comparison is exact.  The
kernels themselves run only on a GPU (tests/test_torch_gpu.py).
"""

import functools
import gc
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.core.sortnet import bitonic_sort, bitonic_sort_pairs
from quantum_resistant_p2p_tpu.pyref import mldsa_ref as ref
from quantum_resistant_p2p_tpu.sig import mldsa as jm
from quantum_resistant_p2p_tpu_torch.sig import mldsa as tm
from quantum_resistant_p2p_tpu_torch.sig import mldsa_cuda, params

VECTOR_DIR = Path(__file__).parent / "vectors"
NAMES = ["ML-DSA-44", "ML-DSA-65", "ML-DSA-87"]
B = 3


@pytest.fixture(scope="module", autouse=True)
def _release_jax():
    """JAX's compiled programs released at the module's end (ROADMAP C1)."""
    yield
    jax.clear_caches()
    gc.collect()


def _u8(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _poly(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, params.Q, size=shape + (256,),
                                                dtype=np.int32)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _jit(fn, *args, **kw):
    return jax.jit(functools.partial(fn, *args, **kw))


def test_tables_and_params_match_pyref():
    assert params.ZETAS == tuple(ref.ZETAS)
    assert params.N_INV == 8347681 == pow(256, -1, ref.Q)
    assert (params.Q, params.N, params.D) == (ref.Q, ref.N, ref.D)
    for name, p in ref.PARAMS.items():
        q = params.PARAMS[name]
        fields = ("k", "l", "eta", "tau", "gamma1", "gamma2", "omega", "lambda_", "beta",
                  "ctilde_len", "z_bits", "w1_bits", "s_bits", "pk_len", "sk_len", "sig_len")
        assert [getattr(q, f) for f in fields] == [getattr(p, f) for f in fields], name


@pytest.mark.parametrize("name", ["ntt", "ntt_inv"])
def test_ntt_matches_jax(name):
    f = _poly(1, 4)
    f[0, :3] = [params.Q - 1, 0, 1]
    got = getattr(tm, name)(_t(f)).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(getattr(jm, name))(f)))


def test_ntt_round_trip():
    f = _t(_poly(2, 2, 3))
    assert torch.equal(tm.ntt_inv(tm.ntt(f)), f)
    assert torch.equal(tm.ntt(tm.ntt_inv(f)), f)


def test_rej_ntt_poly_matches_jax():
    seeds = _u8(3, 6, 34)
    got = tm.rej_ntt_poly(_t(seeds)).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(jm.rej_ntt_poly)(seeds)))


@pytest.mark.parametrize("eta", [2, 4])
def test_rej_bounded_poly_matches_jax(eta):
    seeds = _u8(4 + eta, 6, 66)
    got = tm.rej_bounded_poly(eta, _t(seeds)).numpy()
    assert np.array_equal(got, np.asarray(_jit(jm.rej_bounded_poly, eta)(seeds)))


def _candidate_bytes(cand: np.ndarray) -> np.ndarray:
    """23-bit candidates -> the 3-byte groups RejNTTPoly parses them from
    (bit 7 of the third byte set at random: the sampler must ignore it)."""
    hi = ((cand >> 16) & 0x7F) | (np.random.default_rng(9).integers(0, 2, cand.shape) << 7)
    return np.stack([cand & 0xFF, (cand >> 8) & 0xFF, hi], axis=-1).reshape(
        cand.shape[:-1] + (-1,)).astype(np.uint8)


def test_rej_ntt_short_fill_tail_matches_sort_formulation():
    """Rows where fewer than 256 of the 392 candidates are below q, which
    SHAKE output does not give in practice: the tail holds the rejected
    candidates (values >= q) in order, as the reference's key/value network
    on key = reject << 10 | index leaves them (sig/mldsa.py:rej_ntt_poly)."""
    rng = np.random.default_rng(10)
    rows = []
    for n_rejected in (137, 200, 392, 136, 0):
        cand = rng.integers(0, params.Q, size=392)
        pos = rng.choice(392, size=n_rejected, replace=False)
        cand[pos] = rng.integers(params.Q, 1 << 23, size=n_rejected)
        rows.append(cand)
    cand = np.stack(rows).astype(np.int32)
    got = tm.rej_ntt_from_bytes(_t(_candidate_bytes(cand))).numpy()

    idx = np.arange(392, dtype=np.int32)
    key = np.where(cand < params.Q, 0, 1 << 10) | idx
    key = np.pad(key, [(0, 0), (0, 120)], constant_values=1 << 11)
    _, want = bitonic_sort_pairs(jnp.asarray(key), jnp.asarray(np.pad(cand, [(0, 0), (0, 120)])))
    assert np.array_equal(got, np.asarray(want)[:, :256])
    assert (got[0] >= params.Q).sum() == 256 - (392 - 137)  # short fill reached
    assert (got[2] >= params.Q).all()


@pytest.mark.parametrize("eta", [2, 4])
def test_rej_bounded_short_fill_tail_matches_sort_formulation(eta):
    """Buffers whose first 1024 nibbles hold fewer than 256 below the
    bound: the tail is the rejected raw nibbles in order, as the
    reference's key reject << 16 | index << 4 | nibble gives."""
    bound = 15 if eta == 2 else 9
    rng = np.random.default_rng(20 + eta)
    rows = []
    for n_ok in (255, 100, 0, 256, 1024):
        z = rng.integers(bound, 16, size=1024)
        pos = rng.choice(1024, size=n_ok, replace=False)
        z[pos] = rng.integers(0, bound, size=n_ok)
        rows.append(z)
    z = np.stack(rows).astype(np.int32)
    buf = (z[:, 0::2] | (z[:, 1::2] << 4)).astype(np.uint8)
    got = tm.rej_bounded_from_bytes(_t(buf), eta).numpy()

    key = np.where(z < bound, 0, 1 << 16) | (np.arange(1024, dtype=np.int32) << 4) | z
    want = np.asarray(bitonic_sort(jnp.asarray(key)))[:, :256] & 0xF
    assert np.array_equal(got, want)
    assert (got[0, 255] >= bound) and (got[3, 255] < bound)


def test_strict_sampler_guard(monkeypatch):
    """With the guard on, honest seeds pass; the check trips on a slot 255
    that does not hold an accepted nibble."""
    monkeypatch.setattr(tm, "STRICT_SAMPLERS", True)
    assert tm.rej_bounded_poly(2, _t(_u8(30, 4, 66))).shape == (4, 256)
    with pytest.raises(AssertionError, match="rej_bounded_poly"):
        tm._check_sampler_fill(torch.tensor([True, False]), "rej_bounded_poly")


@pytest.mark.parametrize("name", NAMES)
def test_sample_in_ball_matches_jax(name):
    p, pj = tm.PARAMS[name], jm.PARAMS[name]
    ct = _u8(40, 8, p.ctilde_len)
    got = tm.sample_in_ball(p, _t(ct)).numpy()
    assert np.array_equal(got, np.asarray(_jit(jm.sample_in_ball, pj)(ct)))
    assert ((got == 1) | (got == params.Q - 1)).sum(-1).tolist() == [p.tau] * 8


@pytest.mark.parametrize("first,squeezes", [(136, [136]), (16, [16, 1032])])
@pytest.mark.parametrize("name", NAMES)
def test_sample_in_ball_first_block_and_full_buffer_match_jax(name, first, squeezes,
                                                              monkeypatch):
    """On the CPU the swaps run over the first squeezed block when it holds
    every lane's bytes (one squeeze), else over the reference's whole
    buffer (a second squeeze): forced here with a first try of 16 bytes.
    Both give the JAX function's output at 64 lanes."""
    p, pj = tm.PARAMS[name], jm.PARAMS[name]
    ct = _u8(41, 64, p.ctilde_len)
    lens = []
    shake = tm.keccak.shake256
    monkeypatch.setattr(tm, "_BALL_FIRST_BYTES", first)
    monkeypatch.setattr(tm.keccak, "shake256", lambda x, n: lens.append(n) or shake(x, n))
    got = tm.sample_in_ball(p, _t(ct)).numpy()
    assert lens == squeezes
    assert np.array_equal(got, np.asarray(_jit(jm.sample_in_ball, pj)(ct)))


@pytest.mark.parametrize("bits", [3, 4, 6, 10, 13, 18, 20])
def test_bit_packers_match_jax(bits):
    vals = np.random.default_rng(50 + bits).integers(0, 1 << bits, size=(2, 3, 256),
                                                      dtype=np.int32)
    packed = tm.simple_bit_pack(_t(vals), bits)
    assert np.array_equal(packed.numpy(), np.asarray(jm.simple_bit_pack(jnp.asarray(vals), bits)))
    assert torch.equal(tm.simple_bit_unpack(packed, bits), _t(vals))
    up = (1 << bits) // 2
    centred = _poly(60 + bits, 2) % (2 * up) - up + params.Q
    got = tm.bit_pack(_t(centred % params.Q), up, bits)
    assert np.array_equal(got.numpy(), np.asarray(jm.bit_pack(jnp.asarray(centred % params.Q),
                                                              up, bits)))
    assert np.array_equal(tm.bit_unpack(got, up, bits).numpy(),
                          np.asarray(jm.bit_unpack(jnp.asarray(got.numpy()), up, bits)))


@pytest.mark.parametrize("name", NAMES)
def test_rounding_matches_jax(name):
    p, pj = tm.PARAMS[name], jm.PARAMS[name]
    r = _poly(70, 2, 4)
    r[0, 0, :4] = [0, params.Q - 1, params.Q - 1 - p.gamma2, 2 * p.gamma2]
    h = np.random.default_rng(71).integers(0, 2, size=r.shape, dtype=np.int32)
    for got, want in zip(tm.decompose(p, _t(r)), jm.decompose(pj, jnp.asarray(r))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tm.use_hint(p, _t(h), _t(r)).numpy(),
                          np.asarray(jm.use_hint(pj, jnp.asarray(h), jnp.asarray(r))))
    for got, want in zip(tm.power2round(_t(r)), jm.power2round(jnp.asarray(r))):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_hint_packing_matches_jax(name):
    p, pj = tm.PARAMS[name], jm.PARAMS[name]
    rng = np.random.default_rng(80)
    h = np.zeros((4, p.k, 256), dtype=np.int32)
    for lane, n_set in enumerate((0, p.omega // 2, p.omega, p.omega + 9)):
        flat = rng.choice(p.k * 256, size=n_set, replace=False)
        h[lane].reshape(-1)[flat] = 1
    packed = tm.hint_bit_pack(p, _t(h))
    assert np.array_equal(packed.numpy(), np.asarray(_jit(jm.hint_bit_pack, pj)(h)))
    # the well-formed encodings, then four tampered copies of lane 1 (fewer
    # than omega hints, spread over the rows) that each break one check
    b = packed.numpy()[:3]
    ends = b[1, p.omega:].astype(int)
    row = next(r for r in range(p.k) if ends[r] - (ends[r - 1] if r else 0) >= 2)
    start = ends[row - 1] if row else 0
    bad = np.repeat(b[1:2], 4, axis=0)
    bad[0, p.omega] = p.omega + 1  # a row end past omega
    bad[1, start + 1] = bad[1, start]  # positions in a row not increasing
    bad[2, p.omega - 1] = 7  # a slot past the total is not zero
    bad[3, p.omega: p.omega + 2] = [5, 3]  # row ends that decrease
    enc = np.concatenate([b, bad])
    h_got, ok_got = tm.hint_bit_unpack(p, _t(enc))
    h_want, ok_want = _jit(jm.hint_bit_unpack, pj)(enc)
    assert np.array_equal(h_got.numpy(), np.asarray(h_want))
    assert np.array_equal(ok_got.numpy(), np.asarray(ok_want))
    assert ok_got[:3].all() and not ok_got[3:].any()
    assert np.array_equal(h_got[:3].numpy(), h[:3])


@pytest.mark.parametrize("name", NAMES)
def test_keygen_sign_verify_match_jax(name):
    """keygen (pk, sk), sign (sigma, done and the final kappa of every
    lane) and verify (good, tampered message, tampered signature) under the
    same injected xi, mu and rnd."""
    p, pj = tm.PARAMS[name], jm.PARAMS[name]
    kg_j, _, verify_j = jm.get(name)
    sign_j = _jit(jm.sign_mu_rounds, pj, n_iters=jm.MAX_SIGN_ITERS)
    xi, mu, rnd = _u8(90, B, 32), _u8(91, B, 64), _u8(92, B, 32)

    pk_j, sk_j = (np.asarray(a) for a in kg_j(xi))
    pk, sk = tm.keygen(p, _t(xi))
    assert np.array_equal(pk.numpy(), pk_j) and np.array_equal(sk.numpy(), sk_j)

    sig_j, done_j, kappa_j = (np.asarray(a) for a in sign_j(sk_j, mu, rnd,
                                                            np.zeros(B, np.int32)))
    sig, done, kappa = tm.sign_mu_rounds(p, sk, _t(mu), _t(rnd), 0, tm.MAX_SIGN_ITERS)
    assert np.array_equal(sig.numpy(), sig_j)
    assert np.array_equal(done.numpy(), done_j) and done.all()
    assert np.array_equal(kappa.numpy(), kappa_j)

    bad_mu = mu.copy()
    bad_mu[:, 0] ^= 1
    bad_sig = sig_j.copy()
    bad_sig[:, -1] ^= 0xFF
    for m, s in ((mu, sig_j), (bad_mu, sig_j), (mu, bad_sig)):
        got = tm.verify_mu(p, pk, _t(m), _t(s)).numpy()
        assert np.array_equal(got, np.asarray(verify_j(pk_j, m, s)))
    assert tm.verify_mu(p, pk, _t(mu), sig).all()
    assert not tm.verify_mu(p, pk, _t(mu), _t(bad_sig)).any()


def test_sign_rounds_resume_from_kappa():
    """One attempt at a time, resuming each unfinished lane from its
    returned kappa, gives the signatures of the run-to-completion loop."""
    p = tm.MLDSA65
    _, sk = tm.keygen(p, _t(_u8(100, B, 32)))
    mu, rnd = _t(_u8(101, B, 64)), _t(_u8(102, B, 32))
    sig_full, _, kappa_full = tm.sign_mu_rounds(p, sk, mu, rnd, 0, tm.MAX_SIGN_ITERS)
    kappa = torch.zeros(B, dtype=torch.int32)
    sig = torch.zeros_like(sig_full)
    done = torch.zeros(B, dtype=torch.bool)
    while not done.all():
        s1, d1, kappa = tm.sign_mu_rounds(p, sk, mu, rnd, kappa, 1)
        sig = torch.where((d1 & ~done)[:, None], s1, sig)
        done |= d1
    assert torch.equal(sig, sig_full) and torch.equal(kappa, kappa_full)


def test_precompute_from_numpy_drives_sign_and_verify_pre():
    """The JAX package's per-key precompute, carried into the port, equals
    the port's own and drives sign_mu_pre / verify_mu_pre (one unbatched
    key broadcast against a batch) to the full path's output."""
    p, pj = tm.MLDSA65, jm.MLDSA65
    pk, sk = tm.keygen(p, _t(_u8(110, 1, 32)))
    mu, rnd = _t(_u8(111, B, 64)), _t(_u8(112, B, 32))
    pre_sk_np = {k: np.asarray(v) for k, v in _jit(jm.precompute_sk, pj)(sk[0].numpy()).items()}
    pre_pk_np = {k: np.asarray(v) for k, v in _jit(jm.precompute_pk, pj)(pk[0].numpy()).items()}
    pre_sk = tm.precompute_from_numpy(pre_sk_np, "cpu")
    pre_pk = tm.precompute_from_numpy(pre_pk_np, "cpu")
    assert pre_sk["cap_k"].dtype == torch.uint8 and pre_sk["a_hat"].dtype == torch.int32
    for own, theirs in ((tm.precompute_sk(p, sk[0]), pre_sk_np),
                        (tm.precompute_pk(p, pk[0]), pre_pk_np)):
        assert own.keys() == theirs.keys()
        for name, arr in theirs.items():
            assert np.array_equal(own[name].numpy(), arr), name

    sig, done = tm.sign_mu(p, sk.expand(B, -1), mu, rnd)
    sig_pre, done_pre = tm.sign_mu_pre(p, pre_sk, mu, rnd)
    assert torch.equal(sig_pre, sig) and torch.equal(done_pre, done) and done.all()
    cold_pre, sig_cold, _ = tm.sign_mu_cold(p, sk[0], mu, rnd)
    assert torch.equal(sig_cold, sig) and torch.equal(cold_pre["a_hat"], pre_sk["a_hat"])
    bad = sig.clone()
    bad[1, 5] ^= 1
    assert tm.verify_mu_pre(p, pre_pk, mu, bad).tolist() == [True, False, True]
    assert torch.equal(tm.verify_mu_cold(p, pk[0], mu, bad)[1],
                       tm.verify_mu(p, pk.expand(B, -1), mu, bad))


def _check(rec: dict, name: str, got: bytes) -> None:
    if name in rec:
        assert got.hex() == rec[name], name
    else:
        assert hashlib.sha256(got).hexdigest() == rec[name + "_sha256"], name


@pytest.mark.parametrize("fname", ["mldsa_44.json", "mldsa_65.json", "mldsa_87.json"])
def test_vectors_through_the_port(fname):
    data = json.loads((VECTOR_DIR / fname).read_text())
    p = tm.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8)

    pk, sk = tm.keygen(p, col("xi"))
    mu = torch.tensor([list(hashlib.shake_256(bytes(sk[i, 64:128].numpy()) + b"\0\0"
                                              + bytes.fromhex(r["msg"])).digest(64))
                       for i, r in enumerate(recs)], dtype=torch.uint8)
    sig, done = tm.sign_mu(p, sk, mu, col("rnd"))
    assert done.all() and tm.verify_mu(p, pk, mu, sig).all()
    for i, rec in enumerate(recs):
        for name, t in (("pk", pk), ("sk", sk), ("sig", sig)):
            _check(rec, name, bytes(t[i].numpy()))


def test_acvp_fixture_through_the_port():
    """keyGen, sigGen and sigVer groups of the ACVP-shaped ML-DSA-44 fixture
    (internal interface: the message is M' itself)."""
    data = json.loads((VECTOR_DIR / "acvp_mldsa44_fixture.json").read_text())
    p = tm.PARAMS[data["algorithm"]]
    keygen, siggen, sigver = (g["tests"] for g in data["testGroups"])

    def col(tests, key):
        return torch.tensor([list(bytes.fromhex(t[key])) for t in tests], dtype=torch.uint8)

    def mus(tests, trs):
        return torch.tensor([list(hashlib.shake_256(tr + bytes.fromhex(t["message"]))
                                  .digest(64)) for tr, t in zip(trs, tests)], dtype=torch.uint8)

    pk, sk = tm.keygen(p, col(keygen, "seed"))
    assert [bytes(r.numpy()).hex() for r in pk] == [t["pk"] for t in keygen]
    assert [bytes(r.numpy()).hex() for r in sk] == [t["sk"] for t in keygen]

    sks = col(siggen, "sk")
    sig, done = tm.sign_mu(p, sks, mus(siggen, [bytes(r[64:128].numpy()) for r in sks]),
                           col(siggen, "rnd"))
    assert done.all()
    assert [bytes(r.numpy()).hex() for r in sig] == [t["signature"] for t in siggen]

    pks = col(sigver, "pk")
    trs = [hashlib.shake_256(bytes(r.numpy())).digest(64) for r in pks]
    ok = tm.verify_mu(p, pks, mus(sigver, trs), col(sigver, "signature"))
    assert ok.tolist() == [t["testPassed"] in (True, "True", "true") for t in sigver]
    assert not ok.all()  # the fixture's last case is a tampered message


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        mldsa_cuda.rej_ntt(torch.zeros((2, 34), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mldsa_cuda.rej_bounded(torch.zeros((2, 66), dtype=torch.uint8), 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mldsa_cuda.ntt_inv(torch.zeros((2, 256), dtype=torch.int32))
    with pytest.raises(ValueError, match="eta must be 2 or 4"):
        mldsa_cuda.rej_bounded(torch.zeros((2, 66), dtype=torch.uint8), 3)
    names = ("rej_ntt", "rej_bounded", "ntt", "ntt_inv")
    before = {n: getattr(mldsa_cuda, n).launches for n in names}
    tm.keygen(tm.MLDSA44, torch.zeros((1, 32), dtype=torch.uint8))
    assert before == {n: getattr(mldsa_cuda, n).launches for n in names}
