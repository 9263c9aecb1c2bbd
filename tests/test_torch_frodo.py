"""The port's FrodoKEM (quantum_resistant_p2p_tpu_torch.kem.frodo) against the
JAX package's, byte for byte, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
functions run on the CPU platform, so they take their jnp paths (the
scanned twins of the fused products; the CDF launcher in interpret mode);
the port's CPU tensors take the plain PyTorch versions of kernels K9-K11.
Crypto has no tolerance: every comparison is exact.  All six parameter
sets are held to tests/vectors/frodo_*.json through the port alone; the
AES sets are held to JAX at the AES unit (the JAX package's default
bitsliced AES takes minutes a call on the CPU).  The kernels run only on a
GPU (tests/test_torch_gpu.py).
"""

import gc
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.core import aes as jaes
from quantum_resistant_p2p_tpu.kem import frodo as jfr
from quantum_resistant_p2p_tpu.kem import frodo_pallas as jfp
from quantum_resistant_p2p_tpu.pyref import frodo_ref as ref
from quantum_resistant_p2p_tpu_torch.core import aes
from quantum_resistant_p2p_tpu_torch.kem import frodo, frodo_cuda, frodo_params

VECTOR_DIR = Path(__file__).parent / "vectors"
SHAKE640 = "FrodoKEM-640-SHAKE"
SETS = ("FrodoKEM-640-SHAKE", "FrodoKEM-976-SHAKE", "FrodoKEM-1344-SHAKE")
B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread.  Under xdist several
    workers share the CPU cores, and PyTorch's default of one thread a core
    in each of them oversubscribes the cores: the Frodo paths here, many
    mid-sized ops, then ran tens of times slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop the JAX programs this module compiled when it ends: each holds
    memory maps in its process, and a test process that compiles many can
    reach the kernel's limit on maps."""
    yield
    jfr.get.cache_clear()
    jfr.get_pre.cache_clear()
    jax.clear_caches()
    gc.collect()


def _u8(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _i32(seed: int, lo: int, hi: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int32)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def test_params_match_pyref():
    assert frodo_params.NBAR == ref.NBAR
    assert set(frodo_params.PARAMS) == set(ref.PARAMS)
    for name, p in ref.PARAMS.items():
        q = frodo_params.PARAMS[name]
        assert (q.name, q.n, q.d, q.b, q.len_sec, q.cdf, q.aes) == (
            p.name, p.n, p.d, p.b, p.len_sec, p.cdf, p.aes)
        assert (q.q, q.pk_len, q.sk_len, q.ct_len) == (p.q, p.pk_len, p.sk_len, p.ct_len)


@pytest.mark.parametrize("name", SETS)
def test_codecs_match_jax(name):
    p = frodo.PARAMS[name]
    raw = _u8(1, B, 2 * p.n)
    vals = _i32(2, 0, p.q, B, 8 * p.n)
    packed = _u8(3, B, 8 * p.n * p.d // 8)
    mu = _u8(4, B, p.len_sec)
    m = _i32(5, -2**20, 2**20, B, 64)
    v16 = _i32(6, 0, 1 << 16, B, 64)
    pairs = (
        (frodo._le16(_t(raw)), jfr._le16(jnp.asarray(raw))),
        (frodo._to_le16(_t(v16)), jfr._to_le16(jnp.asarray(v16))),
        (frodo._pack(p, _t(vals)), jfr._pack(p, jnp.asarray(vals))),
        (frodo._unpack(p, _t(packed)), jfr._unpack(p, jnp.asarray(packed))),
        (frodo._encode(p, _t(mu)), jfr._encode(p, jnp.asarray(mu))),
        (frodo._decode(p, _t(m)), jfr._decode(p, jnp.asarray(m))),
    )
    for got, want in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(frodo._unpack(p, frodo._pack(p, _t(vals))).numpy(), vals)


@pytest.mark.parametrize("name", SETS)
def test_cdf_sample_plain_matches_jax(name):
    """The plain sampler against the JAX sampler and the Pallas kernel's tile
    function, on 16-bit randoms and on arbitrary int32 values."""
    p = frodo.PARAMS[name]
    r = np.concatenate([_i32(7, 0, 1 << 16, 4000), _i32(8, -2**31, 2**31, 500)])
    got = frodo.cdf_sample_plain(p, _t(r)).numpy()
    assert np.array_equal(got, np.asarray(jfr._sample(p, jnp.asarray(r))))
    assert np.array_equal(got, np.asarray(jfp._cdf_tiles(jnp.asarray(r), tuple(p.cdf), p.q - 1)))
    assert np.array_equal(frodo._sample(p, _t(r)).numpy(), got)  # the CPU route


def test_cdf_sample_plain_matches_pallas_launcher_interpreted():
    """Against ``cdf_sample_words`` in interpret mode, as
    tests/test_frodo_pallas.py runs it."""
    p = frodo.PARAMS[SHAKE640]
    r = _i32(9, 0, 1 << 16, 300)
    want = jfp.cdf_sample_words(jnp.asarray(r), cdf=tuple(p.cdf), q_mask=p.q - 1, interpret=True)
    assert np.array_equal(frodo.cdf_sample_plain(p, _t(r)).numpy(), np.asarray(want))


def test_products_match_jax_twins():
    """The plain K9/K10 against the JAX package's own CPU route for the
    fused products (``a_times_s_jnp`` / ``s_times_a_jnp``), 640-SHAKE, B = 2."""
    p = frodo.PARAMS[SHAKE640]
    seed_a = _u8(10, B, 16)
    s = _i32(11, 0, p.q, B, p.n, 8)
    sp = _i32(12, 0, p.q, B, 8, p.n)
    want_as = jax.jit(lambda s, a: jfp.a_times_s_jnp(p, s, a))(s, seed_a)
    want_sa = jax.jit(lambda s, a: jfp.s_times_a_jnp(p, s, a))(sp, seed_a)
    got_as = frodo.a_times_s_plain(p, _t(s), _t(seed_a))
    got_sa = frodo.s_times_a_plain(p, _t(sp), _t(seed_a))
    assert np.array_equal(got_as.numpy(), np.asarray(want_as))
    assert np.array_equal(got_sa.numpy(), np.asarray(want_sa))
    # the CPU route of the module functions is the plain version
    assert torch.equal(frodo.a_times_s(p, _t(s), _t(seed_a)), got_as)
    assert torch.equal(frodo.s_times_a(p, _t(sp), _t(seed_a)), got_sa)


@pytest.fixture(scope="module")
def jax_640_shake():
    """JAX keygen/encaps/decaps of 640-SHAKE at B = 2 on seeded inputs."""
    p = frodo.PARAMS[SHAKE640]
    s, se, z, mu = (_u8(20 + i, B, p.len_sec) for i in range(4))
    kg, enc, dec = jfr.get(SHAKE640)
    pk, sk = kg(s, se, z)
    ct, ss = enc(pk, mu)
    bad = np.asarray(ct).copy()
    bad[:, 7] ^= 0x40
    out = {name: np.asarray(v) for name, v in
           (("pk", pk), ("sk", sk), ("ct", ct), ("ss", ss), ("ss_dec", dec(sk, ct)),
            ("ss_rej", dec(sk, bad)))}
    out["pre"] = {k: np.asarray(v) for k, v in
                  jax.jit(lambda pk: jfr.precompute_pk(p, pk))(np.asarray(pk)[0]).items()}
    return (s, se, z, mu, bad), out


def test_kem_640_shake_matches_jax(jax_640_shake):
    (s, se, z, mu, bad), want = jax_640_shake
    p = frodo.PARAMS[SHAKE640]
    pk, sk = frodo.keygen(p, _t(s), _t(se), _t(z))
    ct, ss = frodo.encaps(p, pk, _t(mu))
    got = {"pk": pk, "sk": sk, "ct": ct, "ss": ss, "ss_dec": frodo.decaps(p, sk, ct),
           "ss_rej": frodo.decaps(p, sk, _t(bad))}
    for name, t in got.items():
        assert np.array_equal(t.numpy(), want[name]), name
    assert not np.array_equal(want["ss_rej"], want["ss"])


def test_encaps_pre_over_jax_precompute_equals_encaps(jax_640_shake):
    (_, _, _, mu, _), want = jax_640_shake
    p = frodo.PARAMS[SHAKE640]
    pre = frodo.precompute_from_numpy(want["pre"], "cpu")
    own = frodo.precompute_pk(p, _t(want["pk"][0]))
    assert own.keys() == pre.keys() and all(torch.equal(own[k], pre[k]) for k in pre)
    pk1 = np.broadcast_to(want["pk"][:1], (B, p.pk_len))
    ct, ss = frodo.encaps_pre(p, pre, _t(mu))
    ct_ref, ss_ref = frodo.encaps(p, _t(pk1), _t(mu))
    assert torch.equal(ct, ct_ref) and torch.equal(ss, ss_ref)
    pre2, ct2, ss2 = frodo.encaps_cold(p, _t(want["pk"][0]), _t(mu))
    assert torch.equal(ct2, ct) and torch.equal(ss2, ss)
    assert all(torch.equal(pre2[k], pre[k]) for k in pre)


@pytest.mark.parametrize("tag", ["640_shake", "640_aes", "976_shake", "976_aes", "1344_shake",
                                 "1344_aes"])
def test_vectors_through_the_port(tag):
    """keygen/encaps/decaps byte-exact to the vector file; a tampered
    ciphertext decapsulates to the implicit-rejection secret, not ss."""
    data = json.loads((VECTOR_DIR / f"frodo_{tag}.json").read_text())
    p = frodo.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8)

    s = col("s")
    pk, sk = frodo.keygen(p, s, col("seed_se"), col("z"))
    ct, ss = frodo.encaps(p, pk, col("mu"))
    bad = ct.clone()
    bad[:, -1] ^= 1
    # one decaps call over the honest and the tampered ciphertexts
    ss_dec, ss_rej = frodo.decaps(p, sk.repeat(2, 1), torch.cat([ct, bad])).split(len(recs))
    for i, rec in enumerate(recs):
        for key, t in (("pk", pk), ("sk", sk), ("ct", ct)):
            assert hashlib.sha256(bytes(t[i].numpy())).hexdigest() == rec[key + "_sha256"], key
        assert bytes(ss[i].numpy()).hex() == rec["ss"]
        assert bytes(ss_dec[i].numpy()).hex() == rec["ss"]
        # implicit rejection: SHAKE(ct' || s), the secret s in place of k'
        shake = hashlib.shake_128 if p.n == 640 else hashlib.shake_256
        want_rej = shake(bytes(bad[i].numpy()) + bytes(s[i].numpy())).digest(p.len_sec)
        assert bytes(ss_rej[i].numpy()) == want_rej


def test_aes_matches_jax_gather_aes():
    """``core.aes`` against the JAX package's gather AES, and the cipher of
    the ``cryptography`` package."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    key, blocks = _u8(30, 3, 16), _u8(31, 3, 40, 16)
    rk = aes.key_schedule(_t(key))
    jrk = jaes.key_schedule(jnp.asarray(key))
    assert np.array_equal(rk.numpy(), np.asarray(jrk))
    ct = aes.encrypt_blocks(rk, _t(blocks))
    assert np.array_equal(ct.numpy(), np.asarray(jaes.encrypt_blocks(jrk, jnp.asarray(blocks))))
    for i in range(3):
        enc = Cipher(algorithms.AES(bytes(key[i])), modes.ECB()).encryptor()
        assert bytes(ct[i].numpy()) == enc.update(bytes(blocks[i]))
    assert aes.SBOX == tuple(int(v) for v in jaes._SBOX)


def test_aes_chunk_split_is_exact(monkeypatch):
    """A large batch splits the AES chunk loop into smaller row steps; the
    products come out the same."""
    p = frodo.PARAMS["FrodoKEM-640-AES"]
    ctx = aes.key_schedule(_t(_u8(40, B, 16)))
    s = _t(_i32(41, 0, p.q, B, p.n, 8))
    sp = _t(_i32(42, 0, p.q, B, 8, p.n))
    whole = frodo._a_times_s(p, ctx, s), frodo._s_times_a(p, sp, ctx)
    monkeypatch.setattr(frodo, "AES_STEP_BLOCKS", 3 * B * p.n // 8)  # 3 rows a step
    assert len(list(frodo._aes_steps(p, ctx))) == frodo.N_CHUNKS * 14  # 40 = 13 x 3 + 1
    assert torch.equal(frodo._a_times_s(p, ctx, s), whole[0])
    assert torch.equal(frodo._s_times_a(p, sp, ctx), whole[1])


def test_kernel_wrappers_refuse_cpu_tensors():
    p = frodo.PARAMS[SHAKE640]
    seed_a = torch.zeros((1, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frodo_cuda.a_times_s(p, torch.zeros((1, p.n, 8), dtype=torch.int32), seed_a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frodo_cuda.s_times_a(p, torch.zeros((1, 8, p.n), dtype=torch.int32), seed_a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frodo_cuda.cdf_sample(p, torch.zeros(5, dtype=torch.int32))
