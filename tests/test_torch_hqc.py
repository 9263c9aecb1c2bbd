"""The port's HQC (quantum_resistant_p2p_tpu_torch.kem.hqc) against the JAX
package's, byte for byte, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
functions are called directly under a test-local
``jax.jit(functools.partial(f, p))`` (not through ``hqc.get``, whose FFT
gate writes a marker under the native cache dir); HQC has no Pallas
kernel, and its SHAKE256 streams run the JAX package's own CPU sponge.
The port's CPU tensors take the plain PyTorch sponge (K1's plain version).
Crypto has no tolerance: every comparison is exact.  The JAX comparisons
at HQC-192 and HQC-256 are slow, as in tests/test_hqc.py; all three vector
files and the PQCgenKAT fixture run through the port alone.
"""

import ast
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

from quantum_resistant_p2p_tpu.kem import hqc as jhq
from quantum_resistant_p2p_tpu.pyref import hqc_ref as ref
from quantum_resistant_p2p_tpu_torch.kem import hqc, hqc_params

VECTOR_DIR = Path(__file__).parent / "vectors"
NAMES = ("HQC-128", "HQC-192", "HQC-256")
SLOW_JAX = [pytest.param("HQC-128"), pytest.param("HQC-192", marks=pytest.mark.slow),
            pytest.param("HQC-256", marks=pytest.mark.slow)]
B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: under xdist several
    workers share the CPU cores, and one thread a core in each of them
    oversubscribes them."""
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
    _jit.cache_clear()
    jax.clear_caches()
    gc.collect()


@functools.cache
def _jit(fn_name: str, name: str):
    return jax.jit(functools.partial(getattr(jhq, fn_name), ref.PARAMS[name]))


def _u8(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _pack(bits) -> np.ndarray:
    """(..., nbits) 0/1 -> (..., ceil(nbits / 8)) uint8, little-endian in a
    byte, the last byte zero-padded (JAX's ``_bits_to_bytes``)."""
    return np.packbits(np.asarray(bits, np.uint8), axis=-1, bitorder="little")


def _to_words(p, bits) -> torch.Tensor:
    """n bits -> the port's (..., ceil(n / 64)) int64 words."""
    return hqc._bytes_to_words(_t(_pack(bits)), p.n)


def _to_bits(words: torch.Tensor, nbits: int) -> np.ndarray:
    """The port's words -> (..., nbits) uint8 bits."""
    raw = hqc._words_to_bytes(words, (nbits + 7) // 8).numpy()
    return np.unpackbits(raw, axis=-1, bitorder="little")[..., :nbits]


def _cyclic(p, dense, sup) -> np.ndarray:
    """The port's cyclic product on bits: dense (..., n) x support (..., w)."""
    return _to_bits(hqc._cyclic_words(p, _to_words(p, dense), _t(sup)), p.n)


def _support(seed: int, n: int, rows: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n, size=w, replace=False) for _ in range(rows)]).astype(np.int32)


def _rand_for(p, targets) -> np.ndarray:
    """uint32 randoms that make slot i of the fixed-weight sampler land on
    targets[i] (>= i) before its duplicate scan."""
    out = []
    for i, t in enumerate(targets):
        r = -(-((t - i) << 32) // (p.n - i))
        assert i + ((r * (p.n - i)) >> 32) == t
        out.append(r)
    return np.array(out, np.uint32)


def test_params_and_tables_match_pyref():
    assert set(hqc_params.PARAMS) == set(ref.PARAMS) == set(NAMES)
    for name, p in ref.PARAMS.items():
        q = hqc_params.PARAMS[name]
        assert (q.name, q.n, q.n1, q.k, q.delta, q.dup, q.w, q.wr) == (
            p.name, p.n, p.n1, p.k, p.delta, p.dup, p.w, p.wr)
        assert (q.n2, q.n_bytes, q.n1n2_bytes, q.pk_len, q.sk_len, q.ct_len, q.ss_len) == (
            p.n2, p.n_bytes, p.n1n2_bytes, p.pk_len, p.sk_len, p.ct_len, p.ss_len)
        assert hqc_params._rs_gen_poly(q) == ref._rs_gen_poly(p)
    assert hqc_params._GF_EXP == ref._GF_EXP and hqc_params._GF_LOG == ref._GF_LOG
    assert hqc_params._RM_ENC_TABLE == ref._RM_ENC_TABLE and hqc_params.RM_N == ref.RM_N


def test_module_has_one_exact_cyclic_product_and_no_switch():
    """No FFT, no Toeplitz path, no environment switch or self-check, and no
    import of jax, the JAX package or its pyref/."""
    src = Path(hqc.__file__).read_text().lower()
    for word in ("qrp2p_", "environ", "fft", "selfcheck", "toeplitz", "max_device_batch"):
        assert word not in src, word
    for path in (hqc.__file__, hqc_params.__file__):
        for node in ast.walk(ast.parse(Path(path).read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n.split(".")[0] in ("jax", "quantum_resistant_p2p_tpu")
                               or "pyref" in n for n in names), names


def test_gf_mul_and_inv_exhaustive():
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    want = np.asarray(jax.jit(jhq._gf_mul)(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(hqc._gf_mul(_t(a), _t(b)).numpy(), want)
    x = np.arange(256)
    assert np.array_equal(hqc._gf_inv(_t(x)).numpy(), np.asarray(jax.jit(jhq._gf_inv)(x)))
    assert all(ref.gf_mul(int(v), int(hqc._gf_inv(_t(v)))) == 1 for v in range(1, 256))


@pytest.mark.parametrize("nbits", [8 * 37, 17669, 35851])
def test_bit_byte_and_word_helpers_match_jax(nbits):
    raw = _u8(1, B, (nbits + 7) // 8)
    bits = hqc._bytes_to_bits(_t(raw), nbits)
    assert np.array_equal(bits.numpy(), np.asarray(jhq._bytes_to_bits(jnp.asarray(raw), nbits)))
    back = _pack(bits.numpy())
    assert np.array_equal(back, np.asarray(jhq._bits_to_bytes(jnp.asarray(bits.numpy()))))
    words = hqc._bytes_to_words(_t(raw), nbits)
    assert words.shape[-1] == (nbits + 63) // 64
    assert np.array_equal(hqc._words_to_bytes(words, back.shape[-1]).numpy(), back)  # past n: 0
    stream = _u8(2, B, 4 * 75)
    assert np.array_equal(hqc._u32s(_t(stream)).numpy(),
                          np.asarray(jhq._u32s(jnp.asarray(stream))).astype(np.int64))


def test_fixed_weight_support_on_forced_collisions():
    """Randoms forced to collide, with chains (a slot's value is the index a
    later slot was replaced by), beside random, all-zero and all-ones rows:
    the port's fixed point equals JAX's reverse scan and the oracle's."""
    p, jp = hqc.PARAMS["HQC-128"], ref.PARAMS["HQC-128"]
    w = p.w
    chain = list(range(w))
    for i in range(w - 2, 30, -1):  # slot i lands on i + 1, which slot i + 1 gave up
        chain[i] = i + 1
    clump = [max(i, 40) for i in range(w)]  # slots 0..40 all on 40
    mixed = [i + (7 if i % 3 == 0 else 0) for i in range(w)]
    rows = np.stack([_rand_for(p, chain), _rand_for(p, clump), _rand_for(p, mixed),
                     np.zeros(w, np.uint32), np.full(w, 2**32 - 1, np.uint32),
                     np.random.default_rng(3).integers(0, 2**32, w, dtype=np.uint32)])
    got = hqc._fixed_weight_support(p, _t(rows.astype(np.int64)), w)
    want = np.asarray(jax.jit(lambda r: jhq._fixed_weight_support(jp, r, w))(rows))
    assert np.array_equal(got.numpy(), want)
    for row, r in zip(got.numpy(), rows):
        assert len(set(row.tolist())) == w
        buf = b"".join(int(v).to_bytes(4, "little") for v in r)
        ctx = type("Ctx", (), {"read": lambda self, k: buf[:k]})()
        v = ref.sample_fixed_weight(jp, ctx, w)
        assert v == sum(1 << int(pos) for pos in row)
    # rows batched together settle as each does alone
    assert torch.equal(hqc._fixed_weight_support(p, _t(rows[[0, 1, 0]].astype(np.int64)), w),
                       got[[0, 1, 0]])


#: ATen ops that read a device value on the host (a sync on a CUDA tensor)
SYNC_OPS = {"aten._local_scalar_dense.default", "aten.equal.default", "aten.is_nonzero.default",
            "aten.item.default"}


def _aten_ops(fn, *args):
    """fn(*args) and the ATen ops it dispatched, in order: on a CUDA tensor
    each is a kernel launch or, in SYNC_OPS, a host sync."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record():
        out = fn(*args)
    return out, ops


def test_decaps_ops_do_not_depend_on_colliding_draws():
    """decaps re-draws r2, e and r1 from theta = H(m' || pk || salt), where m'
    is what the sender's ciphertext decodes to, so work that followed the
    draws' collisions would time m'.  Two valid ciphertexts under one key,
    one whose theta draws collide before the duplicate scan and one whose do
    not, dispatch the same ops in the same order, none of them a host sync;
    the sampler alone too."""
    p = hqc.PARAMS["HQC-128"]
    pk, sk = hqc.keygen(p, _t(_u8(40, 1, 40)), _t(_u8(41, 1, p.k)), _t(_u8(42, 1, 40)))
    m = _t(_u8(43, 1, p.k))
    i = torch.arange(p.wr)
    found = {}
    for seed in range(44, 104):
        salt = _t(_u8(seed, 1, 16))
        theta = hqc._hash_dom(torch.cat([m, pk[..., :32], salt], dim=-1), 3)
        rand = hqc._u32s(hqc._seedexpand(theta, 12 * p.wr)).reshape(3, p.wr)
        raw = i + ((rand * (p.n - i)) >> 32)
        found.setdefault(any(len(set(r.tolist())) < p.wr for r in raw), (salt, rand))
        if len(found) == 2:
            break
    assert set(found) == {False, True}
    runs, samples = {}, {}
    for collide, (salt, rand) in found.items():
        ct, ss = hqc.encaps(p, pk, m, salt)
        got, runs[collide] = _aten_ops(hqc.decaps, p, sk, ct)
        assert torch.equal(got, ss)
        _, samples[collide] = _aten_ops(hqc._fixed_weight_support, p, rand, p.wr)
    assert runs[True] == runs[False] and samples[True] == samples[False]
    assert not SYNC_OPS & set(runs[True]) and not SYNC_OPS & set(samples[True])


@pytest.mark.parametrize("name", SLOW_JAX)
def test_cyclic_product_matches_jax_gather_and_fft(name, monkeypatch):
    p, jp = hqc.PARAMS[name], ref.PARAMS[name]
    dense = np.stack([np.ones(p.n, np.uint8),
                      np.random.default_rng(4).integers(0, 2, p.n, dtype=np.uint8)])
    sup = _support(5, p.n, 2, p.wr)
    sup[0, :3] = [0, p.n - 1, 1]  # rotations by 0, n - 1 and 1
    got = _cyclic(p, dense, sup)
    fft = np.asarray(jax.jit(lambda d, s: jhq._cyclic_mul_fft(jp, d, s))(dense, sup))
    monkeypatch.setenv("QRP2P_HQC_GATHER", "1")
    gather = np.asarray(jax.jit(lambda d, s: jhq._cyclic_mul_sparse(jp, d, s))(dense, sup))
    assert np.array_equal(got, fft) and np.array_equal(got, gather)


@pytest.mark.parametrize("name", NAMES)
def test_cyclic_product_against_rolls(name, monkeypatch):
    """The word-window product against np.roll at every set, and split into
    several support slices (a large batch's path) with the same bits."""
    p = hqc.PARAMS[name]
    dense = np.random.default_rng(6).integers(0, 2, (3, p.n), dtype=np.uint8)
    dense[1] = 1
    sup = _support(7, p.n, 3, p.w)
    want = np.stack([np.bitwise_xor.reduce([np.roll(d, int(s)) for s in row])
                     for d, row in zip(dense, sup)])
    assert np.array_equal(_cyclic(p, dense, sup), want)
    monkeypatch.setattr(hqc, "CYCLIC_STEP_ELEMS", 7 * 3 * (p.n // 64 + 2))  # 7 positions a slice
    assert np.array_equal(_cyclic(p, dense, sup), want)


def test_support_and_random_bits_match_jax():
    p, jp = hqc.PARAMS["HQC-128"], ref.PARAMS["HQC-128"]
    sup = _support(8, p.n, B, p.w)
    got = _to_bits(hqc._support_to_words(p, _t(sup)), p.n)
    assert np.array_equal(got, np.asarray(jhq._support_to_bits(jp, jnp.asarray(sup))))
    seed = _u8(9, B, 40)
    assert np.array_equal(_to_bits(hqc._sample_random_words(p, _t(seed)), p.n),
                          np.asarray(_jit("_sample_random_bits", "HQC-128")(seed)))


@pytest.mark.parametrize("name", SLOW_JAX)
def test_rs_encode_and_decode_with_0_to_delta_errors(name):
    p = hqc.PARAMS[name]
    rows = p.delta + 2
    msg = _u8(10, rows, p.k).astype(np.int32)
    cw = hqc._rs_encode(p, _t(msg))
    assert np.array_equal(cw.numpy(), np.asarray(_jit("_rs_encode", name)(msg)))
    # row r carries r byte errors at distinct positions (the last row
    # delta + 1: past the capability, decoded the same wrong way by both)
    rng = np.random.default_rng(11)
    noisy = cw.numpy().copy()
    for r in range(rows):
        pos = rng.choice(p.n1, size=r, replace=False)
        noisy[r, pos] ^= rng.integers(1, 256, size=r)
    got = hqc._rs_decode(p, _t(noisy)).numpy()
    assert np.array_equal(got, np.asarray(_jit("_rs_decode", name)(noisy.astype(np.int32))))
    assert np.array_equal(got[: p.delta + 1], msg[: p.delta + 1])
    assert np.array_equal(hqc._rs_syndromes(p, _t(noisy)).numpy(),
                          np.asarray(_jit("_rs_syndromes", name)(noisy.astype(np.int32))))


@pytest.mark.parametrize("name", SLOW_JAX)
def test_rm_encode_and_tie_heavy_decode(name):
    """RM(1,7) encode against JAX; decode of clean, noisy and tie-heavy rows,
    where several Hadamard coefficients share the largest magnitude and the
    first of them must win, as jnp.argmax takes it."""
    p = hqc.PARAMS[name]
    rs_cw = _u8(12, B, p.n1).astype(np.int32)
    bits = np.unpackbits(hqc._rm_encode_bytes(p, _t(rs_cw)).numpy(), axis=-1, bitorder="little")
    assert np.array_equal(bits, np.asarray(_jit("_rm_encode", name)(rs_cw)))
    rng = np.random.default_rng(13)
    noisy = bits ^ (rng.random(bits.shape) < 0.3)
    uniform = rng.integers(0, 2, (4, p.n1 * p.n2), dtype=np.uint8)  # ties at most blocks
    # each copy a different codeword: three (or five) equal maxima
    blocks = [np.stack([np.frombuffer(ref._RM_ENC_TABLE[v].to_bytes(16, "little"), np.uint8)
                        for v in rng.integers(0, 256, p.dup)]) for _ in range(p.n1)]
    spread = np.unpackbits(np.stack(blocks).astype(np.uint8), axis=-1,
                           bitorder="little").reshape(1, -1)
    rows = np.concatenate([bits, noisy.astype(np.uint8), uniform, spread])
    got = hqc._rm_decode(p, _t(rows)).numpy()
    assert np.array_equal(got, np.asarray(_jit("_rm_decode", name)(rows)))
    assert np.array_equal(got[:B], rs_cw)
    f = (p.dup - 2 * rows.reshape(len(rows), p.n1, p.dup, 128).sum(-2).astype(np.int64))
    h = np.abs(f @ (1 - 2 * (np.vectorize(lambda v: bin(v).count("1"))(
        np.arange(128)[:, None] & np.arange(128)[None, :]) & 1)))
    ties = (h == h.max(-1, keepdims=True)).sum(-1) > 1
    assert ties[B:].mean() > 0.2, "too few tied blocks to hold the first-maximum rule"


@pytest.fixture(scope="module")
def jax_hqc128():
    """JAX keygen/encaps/decaps of HQC-128 at B = 2 on seeded inputs, and the
    tampered ciphertext's rejection secret."""
    return _jax_kem("HQC-128", 20)


def _jax_kem(name, seed):
    p = ref.PARAMS[name]
    ins = (_u8(seed, B, 40), _u8(seed + 1, B, p.k), _u8(seed + 2, B, 40), _u8(seed + 3, B, p.k),
           _u8(seed + 4, B, 16))
    sk_seed, sigma, pk_seed, m, salt = ins
    pk, sk = _jit("keygen", name)(sk_seed, sigma, pk_seed)
    ct, ss = _jit("encaps", name)(pk, m, salt)
    bad = np.asarray(ct).copy()
    bad[:, 7] ^= 0xFF
    dec = _jit("decaps", name)
    out = {k: np.asarray(v) for k, v in (("pk", pk), ("sk", sk), ("ct", ct), ("ss", ss),
                                         ("ss_dec", dec(sk, ct)), ("ss_rej", dec(sk, bad)))}
    return ins, bad, out


def _check_kem(name, case):
    (sk_seed, sigma, pk_seed, m, salt), bad, want = case
    p = hqc.PARAMS[name]
    kg, enc, dec = hqc.get(name)
    pk, sk = kg(_t(sk_seed), _t(sigma), _t(pk_seed))
    ct, ss = enc(pk, _t(m), _t(salt))
    got = {"pk": pk, "sk": sk, "ct": ct, "ss": ss, "ss_dec": dec(sk, ct),
           "ss_rej": dec(sk, _t(bad))}
    for key, t in got.items():
        assert np.array_equal(t.numpy(), want[key]), key
    assert not (want["ss_rej"] == want["ss"]).all(-1).any()
    # the rejection secret is K(sigma || u || v)
    for i in range(B):
        rej = hashlib.shake_256(bytes(sigma[i]) + bytes(bad[i, : p.n_bytes + p.n1n2_bytes])
                                + b"\x04").digest(64)
        assert bytes(got["ss_rej"][i].numpy()) == rej


def test_kem_hqc128_matches_jax(jax_hqc128):
    _check_kem("HQC-128", jax_hqc128)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["HQC-192", "HQC-256"])
def test_kem_wider_sets_match_jax(name):
    _check_kem(name, _jax_kem(name, 30))


def test_decaps_rejects_a_ciphertext_with_bits_past_n(jax_hqc128):
    """u's last byte carries bits past n: the port, like JAX, decodes them
    away, fails the re-encryption check and returns the rejection secret."""
    _, _, want = jax_hqc128
    p = hqc.PARAMS["HQC-128"]
    ct = want["ct"].copy()
    ct[:, p.n_bytes - 1] |= 0x80  # n % 8 = 5: bit 7 of the last byte is past n
    got = hqc.decaps(p, _t(want["sk"]), _t(ct)).numpy()
    assert np.array_equal(got, np.asarray(_jit("decaps", "HQC-128")(want["sk"], ct)))
    assert not (got == want["ss"]).all(-1).any()


@pytest.mark.parametrize("tag", ["128", "192", "256"])
def test_vectors_through_the_port(tag):
    """keygen/encaps/decaps byte-exact to tests/vectors/hqc_<tag>.json, in
    one batch a file; a tampered ciphertext gives the rejection secret."""
    data = json.loads((VECTOR_DIR / f"hqc_{tag}.json").read_text())
    p = hqc.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8)

    kg, enc, dec = hqc.get(p.name)
    pk, sk = kg(col("sk_seed"), col("sigma"), col("pk_seed"))
    ct, ss = enc(pk, col("m"), col("salt"))
    bad = ct.clone()
    bad[:, 0] ^= 1
    ss_dec, ss_rej = dec(sk.repeat(2, 1), torch.cat([ct, bad])).split(len(recs))
    for i, rec in enumerate(recs):
        for key, t in (("pk", pk), ("sk", sk), ("ct", ct)):
            assert hashlib.sha256(bytes(t[i].numpy())).hexdigest() == rec[key + "_sha256"], key
        assert bytes(ss[i].numpy()).hex() == rec["ss"] == bytes(ss_dec[i].numpy()).hex()
        assert bytes(ss_rej[i].numpy()).hex() != rec["ss"]


def _rsp_stanzas(text: str):
    rec: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            if rec:
                yield rec
                rec = {}
            continue
        key, _, value = line.partition("=")
        rec[key.strip()] = value.strip()
    if rec:
        yield rec


def test_pqcgenkat_fixture_through_the_port():
    """Every stanza of PQCgenKAT_hqc128_fixture.rsp: the seeds rebuilt with
    the JAX package's CTR-DRBG (sk_seed, sigma, pk_seed, then m, salt, as
    tests/test_kat.py draws them) and run through the port in one batch."""
    pytest.importorskip("cryptography")  # the DRBG is AES-256-CTR
    from quantum_resistant_p2p_tpu.utils.ctr_drbg import CtrDrbg

    p = hqc.PARAMS["HQC-128"]
    recs = list(_rsp_stanzas((VECTOR_DIR / "PQCgenKAT_hqc128_fixture.rsp").read_text()))
    assert [int(r["count"]) for r in recs] == [0, 1, 2]
    draws = []
    for rec in recs:
        drbg = CtrDrbg(bytes.fromhex(rec["seed"]))
        draws.append([drbg.random_bytes(n) for n in (40, p.k, 40, p.k, 16)])

    def col(j):
        return torch.tensor([list(d[j]) for d in draws], dtype=torch.uint8)

    pk, sk = hqc.keygen(p, col(0), col(1), col(2))
    ct, ss = hqc.encaps(p, pk, col(3), col(4))
    ss_dec = hqc.decaps(p, sk, ct)
    for i, rec in enumerate(recs):
        for key, t in (("pk", pk), ("sk", sk), ("ct", ct), ("ss", ss), ("ss", ss_dec)):
            assert bytes(t[i].numpy()).hex().upper() == rec[key].upper(), key
