"""The port's CUDA kernels and its GPU path, on a GPU.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither jax nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m cuda -q

Each kernel is held bitwise to its plain PyTorch version on the same
device, and the GPU paths of ML-KEM, ML-DSA, the fused handshake programs
and the ChaCha20-Poly1305 core to the CPU paths; FrodoKEM's GPU path to
the vectors in tests/vectors/frodo_*.json, HQC's to
tests/vectors/hqc_*.json and its CPU path (K1 at HQC's long squeezes and
absorbs), and SPHINCS+-SHA2's to tests/vectors/slhdsa_*.json.
"""

import asyncio
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu_torch.core import (chacha, chacha_cuda, keccak, keccak_cuda,
                                                  sha256, sha256_cuda, sha512, sha512_cuda)
from quantum_resistant_p2p_tpu_torch.fused import mlkem_mldsa as fused
from quantum_resistant_p2p_tpu_torch.kem import frodo, frodo_cuda, hqc, mlkem, mlkem_cuda
from quantum_resistant_p2p_tpu_torch.provider import (BatchedAEAD, BatchedKEM, BatchedSignature,
                                                      get_batched_aead, get_kem, get_signature,
                                                      get_symmetric, init_pk_offset,
                                                      resp_ct_offset)
from quantum_resistant_p2p_tpu_torch.sig import mldsa, mldsa_cuda, slhdsa_params, sphincs

pytestmark = pytest.mark.cuda
VECTOR_DIR = Path(__file__).parent / "vectors"


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _u8(seed: int, *shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.parametrize("rate,ds,length,out_len", [
    (136, 0x06, 1184, 32), (72, 0x06, 64, 64), (136, 0x1F, 1120, 32),
    (168, 0x1F, 34, 672), (136, 0x1F, 0, 300), (72, 0x06, 71, 200)])
def test_sponge_kernel_matches_plain(gpu, rate, ds, length, out_len):
    x = _u8(length, 257, length).to(gpu)
    before = keccak_cuda.sponge.launches
    got = keccak.sponge(x, rate, ds, out_len)
    torch.cuda.synchronize()
    assert keccak_cuda.sponge.launches == before + 1
    assert torch.equal(got, keccak.sponge_plain(x, rate, ds, out_len))


def test_mlkem_kernels_match_plain(gpu):
    seeds = _u8(80, 300, 34).to(gpu)
    assert torch.equal(mlkem_cuda.sample_ntt(seeds), mlkem.sample_ntt_plain(seeds))
    prf = _u8(81, 300, 33).to(gpu)
    for eta in (2, 3):
        assert torch.equal(mlkem_cuda.prf_cbd(prf, eta), mlkem.prf_cbd_plain(prf, eta))
        assert torch.equal(mlkem_cuda.prf_cbd_ntt(prf, eta), mlkem.prf_cbd_ntt_plain(prf, eta))
    f = torch.randint(0, mlkem.Q, (300, 256), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(82)).to(gpu)
    assert torch.equal(mlkem_cuda.ntt(f), mlkem.ntt_plain(f))
    assert torch.equal(mlkem_cuda.ntt_inv(f), mlkem.ntt_inv_plain(f))
    torch.cuda.synchronize()


_MLKEM_SAMPLERS = (
    ("sample_ntt", 34, lambda s: mlkem_cuda.sample_ntt(s), lambda s: mlkem.sample_ntt_plain(s)),
    *((f"prf_cbd eta {eta}", 33, lambda s, e=eta: mlkem_cuda.prf_cbd(s, e),
       lambda s, e=eta: mlkem.prf_cbd_plain(s, e)) for eta in (2, 3)),
    *((f"prf_cbd_ntt eta {eta}", 33, lambda s, e=eta: mlkem_cuda.prf_cbd_ntt(s, e),
       lambda s, e=eta: mlkem.prf_cbd_ntt_plain(s, e)) for eta in (2, 3)))


@pytest.mark.parametrize("rows", [0, 1, 31, 32, 33, 4095, 12289])
def test_mlkem_samplers_at_ragged_row_counts(gpu, rows):
    """K2 and K3 (eta 2 and 3, NTT fused or not) parse a warp's 32 rows
    together: full warps, a ragged last warp, a lone row, none."""
    wrappers = (mlkem_cuda.sample_ntt, mlkem_cuda.prf_cbd, mlkem_cuda.prf_cbd_ntt)
    for name, seed_len, kern, plain in _MLKEM_SAMPLERS:
        seeds = _u8(rows + seed_len, rows, seed_len).to(gpu)
        before = [w.launches for w in wrappers]
        got = kern(seeds)
        torch.cuda.synchronize()
        if rows == 0:
            assert got.shape == (0, 256) and [w.launches for w in wrappers] == before, name
        else:
            assert sum(w.launches for w in wrappers) == sum(before) + 1, name
            assert torch.equal(got, plain(seeds)), name


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_mlkem_samplers_read_unaligned_seed_rows(gpu, offset):
    """A seed view 1-3 bytes past an aligned address: the staged loads take
    the aligned words around the rows."""
    for name, seed_len, kern, plain in _MLKEM_SAMPLERS:
        buf = _u8(offset, 1000 * seed_len + 4).to(gpu)
        seeds = buf[offset:offset + 999 * seed_len].view(999, seed_len)
        assert seeds.data_ptr() % 4 == offset % 4
        assert torch.equal(kern(seeds), plain(seeds.clone())), name


@pytest.mark.parametrize("name", ["ML-KEM-512", "ML-KEM-768", "ML-KEM-1024"])
def test_gpu_path_matches_cpu_path(gpu, name):
    p = mlkem.PARAMS[name]
    d, z, m = _u8(90, 16, 32), _u8(91, 16, 32), _u8(92, 16, 32)
    ek, dk = mlkem.keygen(p, d.to(gpu), z.to(gpu))
    key, ct = mlkem.encaps(p, ek, m.to(gpu))
    bad = ct.clone()
    bad[:, 0] ^= 1
    key2, rej = mlkem.decaps(p, dk, ct), mlkem.decaps(p, dk, bad)
    ek_c, dk_c = mlkem.keygen(p, d, z)
    key_c, ct_c = mlkem.encaps(p, ek_c, m)
    for a, b in ((ek, ek_c), (dk, dk_c), (key, key_c), (ct, ct_c), (key2, key_c),
                 (rej, mlkem.decaps(p, dk_c, bad.cpu()))):
        assert torch.equal(a.cpu(), b)


def test_batched_kem_on_the_default_backend(gpu):
    kem = get_kem("ML-KEM-768")
    assert kem.backend == "cuda"

    async def run():
        with BatchedKEM(kem, max_wait_ms=5.0) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            return await asyncio.gather(*(client() for _ in range(64)))

    assert all(asyncio.run(run()))


def test_mldsa_kernels_match_plain(gpu):
    seeds = _u8(100, 300, 34).to(gpu)
    before = mldsa_cuda.rej_ntt.launches
    assert torch.equal(mldsa_cuda.rej_ntt(seeds), mldsa.rej_ntt_poly_plain(seeds))
    assert mldsa_cuda.rej_ntt.launches == before + 1
    rb = _u8(101, 300, 66).to(gpu)
    for eta in (2, 4):
        assert torch.equal(mldsa_cuda.rej_bounded(rb, eta), mldsa.rej_bounded_poly_plain(rb, eta))
    f = torch.randint(0, mldsa.Q, (300, 256), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(102))
    f[0] = mldsa.Q - 1
    f = f.to(gpu)
    assert torch.equal(mldsa_cuda.ntt(f), mldsa.ntt_plain(f))
    assert torch.equal(mldsa_cuda.ntt_inv(f), mldsa.ntt_inv_plain(f))
    torch.cuda.synchronize()


def test_mldsa65_gpu_path_matches_cpu_path(gpu):
    p = mldsa.MLDSA65
    xi, mu, rnd = _u8(110, 8, 32), _u8(111, 8, 64), _u8(112, 8, 32)
    pk, sk = mldsa.keygen(p, xi.to(gpu))
    sig, done, kappa = mldsa.sign_mu_rounds(p, sk, mu.to(gpu), rnd.to(gpu), 0,
                                            mldsa.MAX_SIGN_ITERS)
    ok = mldsa.verify_mu(p, pk, mu.to(gpu), sig)
    pk_c, sk_c = mldsa.keygen(p, xi)
    sig_c, done_c, kappa_c = mldsa.sign_mu_rounds(p, sk_c, mu, rnd, 0, mldsa.MAX_SIGN_ITERS)
    for a, b in ((pk, pk_c), (sk, sk_c), (sig, sig_c), (done, done_c), (kappa, kappa_c)):
        assert torch.equal(a.cpu(), b)
    assert ok.all()
    bad = sig.clone()
    bad[:, -1] ^= 0xFF
    assert not mldsa.verify_mu(p, pk, mu.to(gpu), bad).any()


def test_batched_signature_on_the_default_backend(gpu):
    sig = get_signature("ML-DSA-65")
    assert sig.backend == "cuda"
    pk, sk = sig.generate_keypair()

    async def run():
        with BatchedSignature(sig, max_wait_ms=5.0) as bs:
            msgs = [b"m%d" % i for i in range(32)]
            sigs = await asyncio.gather(*(bs.sign(sk, m) for m in msgs))
            oks = await asyncio.gather(*(bs.verify(pk, m, s) for m, s in zip(msgs, sigs)))
            bad = await bs.verify(pk, b"m0!", sigs[0])
            return oks, bad

    oks, bad = asyncio.run(run())
    assert all(oks) and not bad


def test_sponge_varlen_kernel_matches_plain(gpu):
    """K1 with per-row lengths: every residue of the length around block
    edges at rate 136, 0 and LMAX, garbage past each length."""
    lmax = 1000
    lengths = [0, lmax] + [k * 136 + o for k in range(1, 8) for o in (-2, -1, 0, 1)]
    x = _u8(120, len(lengths), lmax).to(gpu)
    lens = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    before = keccak_cuda.sponge_varlen.launches
    for rate, ds, out_len in ((136, 0x1F, 64), (72, 0x06, 64), (168, 0x1F, 300)):
        got = keccak.sponge_varlen(x, lens, rate, ds, out_len)
        assert torch.equal(got, keccak.sponge_varlen_plain(x, lens, rate, ds, out_len))
    torch.cuda.synchronize()
    assert keccak_cuda.sponge_varlen.launches == before + 3


def _split_edge(gpu) -> int:
    """Row count from which K1 runs a sponge a thread (csrc/sponge.cu:
    kRowsPerSm = 64 rows an SM); below it, five lanes a sponge."""
    return 64 * torch.cuda.get_device_properties(gpu).multi_processor_count


@pytest.mark.parametrize("rate,ds", [(72, 0x06), (136, 0x06), (136, 0x1F), (168, 0x1F)])
def test_sponge_split_and_rows_paths_match_plain(gpu, rate, ds):
    """K1 on both sides of its split rule and at row counts that fill no
    block (1, 7, 25, 31), every message length residue around the first
    block edge, digests of several squeezes, rows skewed off alignment."""
    edge = _split_edge(gpu)
    for rows in (1, 7, 25, 31, edge - 1, edge):
        lengths = range(rate - 9, rate + 9) if rows < 32 else (0, rate - 1, rate, 2 * rate + 3)
        for length in lengths:
            base = _u8(rows * 1000 + length, rows * length + 1).to(gpu)
            x = base[1:].reshape(rows, length)  # one byte off the allocation's alignment
            out_len = 3 * rate + 5
            got = keccak_cuda.sponge(x, rate, ds, out_len)
            assert torch.equal(got, keccak.sponge_plain(x, rate, ds, out_len)), (rows, length)
    torch.cuda.synchronize()


def test_sponge_kernels_take_zero_rows(gpu):
    before = (keccak_cuda.sponge.launches, keccak_cuda.sponge_varlen.launches)
    x = torch.empty((0, 40), dtype=torch.uint8, device=gpu)
    assert keccak_cuda.sponge(x, 136, 0x1F, 32).shape == (0, 32)
    lens = torch.empty((0,), dtype=torch.int32, device=gpu)
    assert keccak_cuda.sponge_varlen(x, lens, 136, 0x1F, 64).shape == (0, 64)
    assert (keccak_cuda.sponge.launches, keccak_cuda.sponge_varlen.launches) == before


def test_sponge_varlen_both_paths_match_plain(gpu):
    """Per-row lengths around every block edge of rate 136 in one launch,
    below and at the split rule's row count: a split group's message ends
    while the others in its warp go on."""
    lmax = 700
    for rows in (29, _split_edge(gpu)):
        lens = torch.tensor([(7 * r) % (lmax + 1) if r % 3 else (r // 3 % 6) * 136 + r % 5 - 2
                             for r in range(rows)], dtype=torch.int32).clamp(0, lmax).to(gpu)
        x = _u8(121 + rows, rows, lmax).to(gpu)
        got = keccak.sponge_varlen(x, lens, 136, 0x1F, 64)
        assert torch.equal(got, keccak.sponge_varlen_plain(x, lens, 136, 0x1F, 64))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [1, 17, 33, 4099])
def test_mldsa_ntt_kernel_edges(gpu, n):
    """K7 at one polynomial and at counts that leave a half-warp or a block
    part empty; inputs of 0 and q - 1; forward then inverse gives the input."""
    f = torch.randint(0, mldsa.Q, (n, 256), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(n))
    f[0, ::2] = mldsa.Q - 1
    f[-1, 1::2] = 0
    f = f.to(gpu)
    fwd = mldsa_cuda.ntt(f)
    assert torch.equal(fwd, mldsa.ntt_plain(f))
    assert torch.equal(mldsa_cuda.ntt_inv(f), mldsa.ntt_inv_plain(f))
    assert torch.equal(mldsa_cuda.ntt_inv(fwd), f)
    extremes = torch.tensor([[0] * 256, [mldsa.Q - 1] * 256], dtype=torch.int32, device=gpu)
    assert torch.equal(mldsa_cuda.ntt(extremes), mldsa.ntt_plain(extremes))
    assert torch.equal(mldsa_cuda.ntt_inv(extremes), mldsa.ntt_inv_plain(extremes))
    torch.cuda.synchronize()


def _stripes(q: int) -> torch.Tensor:
    """Rows of q - 1 and 0 in runs of 2, 4, .., 128 coefficients, both
    phases: each puts one NTT layer's lazy values at their worst."""
    i = torch.arange(256)
    return torch.stack([torch.where((i // run) % 2 == side, q - 1, 0)
                        for run in (2, 4, 8, 16, 32, 64, 128) for side in (0, 1)]).to(torch.int32)


@pytest.mark.parametrize("n", [1, 17, 33, 4099])
def test_mlkem_ntt_kernel_edges(gpu, n):
    """K4 at one polynomial and at counts that leave a half-warp or a block
    part empty; inputs of 0 and q - 1, whole rows of each and striped;
    forward then inverse gives the input."""
    f = torch.randint(0, mlkem.Q, (n, 256), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(n))
    f[0, ::2] = mlkem.Q - 1
    f[-1, 1::2] = 0
    f = f.to(gpu)
    before = (mlkem_cuda.ntt.launches, mlkem_cuda.ntt_inv.launches)
    fwd = mlkem_cuda.ntt(f)
    assert torch.equal(fwd, mlkem.ntt_plain(f))
    assert torch.equal(mlkem_cuda.ntt_inv(f), mlkem.ntt_inv_plain(f))
    assert torch.equal(mlkem_cuda.ntt_inv(fwd), f)
    assert (mlkem_cuda.ntt.launches, mlkem_cuda.ntt_inv.launches) == (before[0] + 1,
                                                                       before[1] + 2)
    extremes = torch.cat([torch.tensor([[0] * 256, [mlkem.Q - 1] * 256], dtype=torch.int32),
                          _stripes(mlkem.Q)]).to(gpu)
    assert torch.equal(mlkem_cuda.ntt(extremes), mlkem.ntt_plain(extremes))
    assert torch.equal(mlkem_cuda.ntt_inv(extremes), mlkem.ntt_inv_plain(extremes))
    torch.cuda.synchronize()


@pytest.mark.parametrize("rows,offset", [(1, 1), (45, 3), (4099, 1)])
def test_mldsa_rej_ntt_at_ragged_rows_from_unaligned_seeds(gpu, rows, offset):
    """K5 over a seed view that starts an odd number of bytes past an
    aligned address, at row counts that leave the last warp ragged; no
    rows, no launch."""
    buf = _u8(rows + offset, rows * 34 + 4).to(gpu)
    seeds = buf[offset:offset + rows * 34].view(rows, 34)
    assert seeds.data_ptr() % 4 == offset % 4
    before = mldsa_cuda.rej_ntt.launches
    got = mldsa_cuda.rej_ntt(seeds)
    torch.cuda.synchronize()
    assert mldsa_cuda.rej_ntt.launches == before + 1
    assert torch.equal(got, mldsa.rej_ntt_poly_plain(seeds.clone()))
    empty = torch.empty((0, 34), dtype=torch.uint8, device=gpu)
    assert mldsa_cuda.rej_ntt(empty).shape == (0, 256)
    assert mldsa_cuda.rej_ntt.launches == before + 1


@pytest.mark.parametrize("eta", [2, 4])
@pytest.mark.parametrize("rows,offset", [(1, 1), (45, 3), (4099, 2), (90_113, 1)])
def test_mldsa_rej_bounded_at_ragged_rows_from_unaligned_seeds(gpu, eta, rows, offset):
    """K6 over a seed view that starts an odd number of bytes past an
    aligned address, at row counts that leave the last warp ragged, up to
    more warps than an H100 keeps resident at once (8,192 ML-DSA-65 keys'
    ExpandS is 90,112 rows); no rows, no launch."""
    buf = _u8(rows + offset + eta, rows * 66 + 4).to(gpu)
    seeds = buf[offset:offset + rows * 66].view(rows, 66)
    assert seeds.data_ptr() % 4 == offset % 4
    before = mldsa_cuda.rej_bounded.launches
    got = mldsa_cuda.rej_bounded(seeds, eta)
    torch.cuda.synchronize()
    assert mldsa_cuda.rej_bounded.launches == before + 1
    assert torch.equal(got, mldsa.rej_bounded_poly_plain(seeds.clone(), eta))
    empty = torch.empty((0, 66), dtype=torch.uint8, device=gpu)
    assert mldsa_cuda.rej_bounded(empty, eta).shape == (0, 256)
    assert mldsa_cuda.rej_bounded.launches == before + 1


def test_chacha_kernel_matches_plain(gpu):
    states = _u8(121, 5000, 48).view(torch.int32).to(gpu)
    before = chacha_cuda.chacha_blocks.launches
    got = chacha.chacha_blocks(states)
    torch.cuda.synchronize()
    assert chacha_cuda.chacha_blocks.launches == before + 1
    assert torch.equal(got, chacha.chacha_blocks_plain(states))
    # a view that is not 16-byte aligned is copied, not misread
    shifted = states.reshape(-1)[1: 1 + 12 * 4999].view(4999, 12)
    assert shifted.data_ptr() % 16
    assert torch.equal(chacha_cuda.chacha_blocks(shifted), chacha.chacha_blocks_plain(shifted))


def test_aead_core_gpu_matches_cpu(gpu):
    b, width, aad_width = 37, 1024, 64
    keys, nonces = _u8(122, b, 32), _u8(123, b, 12)
    data, aads = _u8(124, b, width), _u8(125, b, aad_width)
    lens = torch.tensor([(29 * i) % (width + 1) for i in range(b)])
    aad_lens = torch.tensor([(5 * i) % (aad_width + 1) for i in range(b)])
    for seal in (True, False):
        want = chacha.aead_core(keys, nonces, data, lens, aads, aad_lens, seal=seal)
        got = chacha.aead_core(*(t.to(gpu) for t in (keys, nonces, data, lens, aads, aad_lens)),
                               seal=seal)
        for w, g in zip(want, got):
            assert torch.equal(g.cpu(), w)


def test_fused_programs_gpu_match_cpu(gpu):
    kem, sig = "ML-KEM-768", "ML-DSA-65"
    pk_off, ct_off = init_pk_offset(kem, "ChaCha20-Poly1305"), resp_ct_offset()
    b = 4
    pk, sk = mldsa.keygen(mldsa.MLDSA65, _u8(130, b, 32))
    tmpl = torch.zeros((b, 2 * 1184 + 1024), dtype=torch.uint8)
    tmpl[:, : pk_off + 2368 + 40] = ord("x")
    lens = torch.tensor([pk_off + 2368 + 10 * i for i in range(b)], dtype=torch.int32)
    rtmpl = torch.zeros((b, 2 * 1088 + 1024), dtype=torch.uint8)
    rlens = torch.full((b,), ct_off + 2176 + 7, dtype=torch.int32)
    d, z, m, rnd, mu = (_u8(131 + i, b, w) for i, w in enumerate((32, 32, 32, 32, 64)))

    def run(dev):
        on = [t.to(dev) for t in (d, z, sk, rnd, tmpl, lens)]
        ek, dk, s1, done1 = fused.keygen_sign(kem, sig, pk_off, *on)
        enc = fused.encaps_verify_sign(
            kem, sig, ct_off, ek, m.to(dev), pk.to(dev), mu.to(dev), s1, sk.to(dev), rnd.to(dev), rtmpl.to(dev),
            rlens.to(dev))
        dec = fused.decaps_verify_sign(
            kem, sig, dk, enc[1], pk.to(dev), mu.to(dev), enc[3], sk.to(dev), mu.to(dev), rnd.to(dev))
        return [t.cpu() for t in (ek, dk, s1, done1, *enc, *dec)]

    before = keccak_cuda.sponge_varlen.launches
    got = run(gpu)
    assert keccak_cuda.sponge_varlen.launches == before + 2
    for g, w in zip(got, run("cpu")):
        assert torch.equal(g, w)


def test_batched_aead_on_the_default_backend(gpu):
    device = get_batched_aead("ChaCha20-Poly1305")
    assert device.backend == "cuda"
    scalar = get_symmetric("ChaCha20-Poly1305")
    key = bytes(range(32))
    msgs = [bytes([i]) * (97 * i) for i in range(40)]

    async def run():
        with BatchedAEAD(device, max_wait_ms=5.0) as aead:
            frames = await asyncio.gather(*(aead.encrypt(key, m, b"ad") for m in msgs))
            opened = await asyncio.gather(*(aead.decrypt(key, f, b"ad") for f in frames))
            return frames, opened

    frames, opened = asyncio.run(run())
    assert opened == msgs
    assert [scalar.decrypt(key, f, b"ad") for f in frames] == msgs


@pytest.mark.parametrize("name", ["FrodoKEM-640-SHAKE", "FrodoKEM-976-SHAKE",
                                  "FrodoKEM-1344-SHAKE"])
def test_frodo_kernels_match_plain(gpu, name):
    """K9 and K10 on random S / S' of every residue (full int32 range for
    K9), K11 on 16-bit randoms and on arbitrary int32 values."""
    p = frodo.PARAMS[name]
    rng = np.random.default_rng(p.n)
    seed_a = torch.tensor(rng.integers(0, 256, (3, 16), dtype=np.uint8), device=gpu)
    s = torch.tensor(rng.integers(-2**31, 2**31, (3, p.n, 8), dtype=np.int64).astype(np.int32),
                     device=gpu)
    sp = torch.tensor(rng.integers(0, p.q, (3, 8, p.n), dtype=np.int32), device=gpu)
    counts = (frodo_cuda.a_times_s.launches, frodo_cuda.s_times_a.launches,
              frodo_cuda.cdf_sample.launches)
    assert torch.equal(frodo.a_times_s(p, s, seed_a), frodo.a_times_s_plain(p, s, seed_a))
    assert torch.equal(frodo.s_times_a(p, sp, seed_a), frodo.s_times_a_plain(p, sp, seed_a))
    r = torch.tensor(np.concatenate([rng.integers(0, 1 << 16, 20000),
                                     rng.integers(-2**31, 2**31, 1000)]).astype(np.int32),
                     device=gpu)
    assert torch.equal(frodo._sample(p, r), frodo.cdf_sample_plain(p, r))
    torch.cuda.synchronize()
    assert (frodo_cuda.a_times_s.launches, frodo_cuda.s_times_a.launches,
            frodo_cuda.cdf_sample.launches) == tuple(c + 1 for c in counts)


@pytest.mark.parametrize("tag", ["640_shake", "640_aes", "976_shake", "976_aes", "1344_shake",
                                 "1344_aes"])
def test_frodo_gpu_path_matches_vectors(gpu, tag):
    data = json.loads((VECTOR_DIR / f"frodo_{tag}.json").read_text())
    p = frodo.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8,
                            device=gpu)

    pk, sk = frodo.keygen(p, col("s"), col("seed_se"), col("z"))
    ct, ss = frodo.encaps(p, pk, col("mu"))
    ss2 = frodo.decaps(p, sk, ct)
    bad = ct.clone()
    bad[:, 0] ^= 1
    rej = frodo.decaps(p, sk, bad)
    for i, rec in enumerate(recs):
        for key, t in (("pk", pk), ("sk", sk), ("ct", ct)):
            assert hashlib.sha256(bytes(t[i].cpu().numpy())).hexdigest() == rec[key + "_sha256"]
        assert bytes(ss[i].cpu().numpy()).hex() == rec["ss"]
        assert bytes(ss2[i].cpu().numpy()).hex() == rec["ss"]
        assert bytes(rej[i].cpu().numpy()).hex() != rec["ss"]
    pre = frodo.precompute_pk(p, pk[0])
    ct_pre, ss_pre = frodo.encaps_pre(p, pre, col("mu")[:1])
    assert torch.equal(ct_pre, frodo.encaps(p, pk[:1], col("mu")[:1])[0])
    assert torch.equal(ss_pre, ss[:1])


def test_batched_frodo_on_the_default_backend(gpu):
    kem = get_kem("FrodoKEM-640-SHAKE")
    assert kem.backend == "cuda"

    async def run():
        with BatchedKEM(kem, max_wait_ms=5.0) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            agreed = await asyncio.gather(*(client() for _ in range(32)))
            server_pk, server_sk = await bk.generate_keypair()
            for _ in range(2):  # the first round fills the operand cache
                outs = await asyncio.gather(*(bk.encapsulate(server_pk) for _ in range(16)))
                keys = await asyncio.gather(*(bk.decapsulate(server_sk, ct) for ct, _ in outs))
                agreed += [k == ss for k, (_, ss) in zip(keys, outs)]
            return agreed

    assert all(asyncio.run(run()))
    assert kem.opcache.stats()["hits"] >= 1


@pytest.mark.parametrize("rows", [1, 70, 1024])
def test_sponge_kernel_at_hqc_shapes(gpu, rows):
    """K1 at HQC-256's seedexpand of pk_seed (41 B -> 7,205 B: 53 squeezed
    blocks) and its K(m || u || v) (14,437 B -> 64: 107 absorbed blocks),
    on both of K1's paths (few rows and many)."""
    p = hqc.PARAMS["HQC-256"]
    for length, out_len in ((41, p.n_bytes), (p.k + p.n_bytes + p.n1n2_bytes + 1, 64)):
        x = _u8(length + rows, rows, length).to(gpu)
        before = keccak_cuda.sponge.launches
        got = keccak.shake256(x, out_len)
        torch.cuda.synchronize()
        assert keccak_cuda.sponge.launches == before + 1
        assert torch.equal(got, keccak.sponge_plain(x, 136, 0x1F, out_len))


@pytest.mark.parametrize("tag", ["128", "192", "256"])
def test_hqc_gpu_path_matches_vectors_and_cpu(gpu, tag):
    """The vector file byte for byte on the card, and 64 random rows of
    keygen, encaps and decaps (a tampered half included) equal to the CPU
    path."""
    data = json.loads((VECTOR_DIR / f"hqc_{tag}.json").read_text())
    p = hqc.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8,
                            device=gpu)

    pk, sk = hqc.keygen(p, col("sk_seed"), col("sigma"), col("pk_seed"))
    ct, ss = hqc.encaps(p, pk, col("m"), col("salt"))
    ss2 = hqc.decaps(p, sk, ct)
    for i, rec in enumerate(recs):
        for key, t in (("pk", pk), ("sk", sk), ("ct", ct)):
            assert hashlib.sha256(bytes(t[i].cpu().numpy())).hexdigest() == rec[key + "_sha256"]
        assert bytes(ss[i].cpu().numpy()).hex() == rec["ss"] == bytes(ss2[i].cpu().numpy()).hex()
    ins = [_u8(90 + j, 64, n) for j, n in enumerate((40, p.k, 40, p.k, 16))]
    outs = {}
    for dev in ("cpu", gpu):
        sk_seed, sigma, pk_seed, m, salt = (t.to(dev) for t in ins)
        pk, sk = hqc.keygen(p, sk_seed, sigma, pk_seed)
        ct, ss = hqc.encaps(p, pk, m, salt)
        bad = ct.clone()
        bad[32:, 5] ^= 0x10
        outs[str(dev)] = [t.cpu() for t in (pk, sk, ct, ss, hqc.decaps(p, sk, bad))]
    for want, got in zip(outs["cpu"], outs[str(gpu)]):
        assert torch.equal(got, want)
    assert torch.equal(outs["cpu"][4][:32], outs["cpu"][3][:32])
    assert not (outs["cpu"][4][32:] == outs["cpu"][3][32:]).all(-1).any()


@pytest.mark.parametrize("name", ["HQC-128", "HQC-256"])
def test_hqc_decoders_on_tie_heavy_words_match_cpu(gpu, name):
    """The RM(1,7) and RS decoders on uniform words (a fifth or more of the
    RM blocks have several largest |F|, and the RS words carry more than
    delta errors), the card against the CPU path."""
    p = hqc.PARAMS[name]
    words = _u8(95, 64, p.n1 * p.n2) & 1
    rm = hqc._rm_decode(p, words.to(gpu))
    assert torch.equal(rm.cpu(), hqc._rm_decode(p, words))
    assert torch.equal(hqc._rs_decode(p, rm).cpu(), hqc._rs_decode(p, rm.cpu()))


def test_batched_hqc_on_the_default_backend(gpu):
    kem = get_kem("HQC-128")
    assert kem.backend == "cuda"

    async def run():
        with BatchedKEM(kem, max_wait_ms=5.0) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            return await asyncio.gather(*(client() for _ in range(32)))

    before = keccak_cuda.sponge.launches
    assert all(asyncio.run(run()))
    assert keccak_cuda.sponge.launches > before


@pytest.mark.parametrize("rows", [1000, 70000])
def test_sha2_kernels_match_plain(gpu, rows):
    """K12 and K13, one block a row, on random states (every bit pattern for
    SHA-512's int64 words) against the plain compressions on the GPU."""
    rng = np.random.default_rng(rows)
    for mod, kern, width, words in ((sha256, sha256_cuda.compress, 64, (0, 2**32)),
                                    (sha512, sha512_cuda.compress, 128, (-2**63, 2**63))):
        state = torch.tensor(rng.integers(*words, (rows, 8), dtype=np.int64), device=gpu)
        block = torch.tensor(rng.integers(0, 256, (rows, width), dtype=np.uint8), device=gpu)
        before = kern.launches
        got = mod.compress(state, block)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(got, mod.compress_plain(state, block))


@pytest.mark.parametrize("blocks", [1, 10, 17])
def test_sha2_multiblock_and_shared_state_match_plain(gpu, blocks):
    """The multi-block entry (all blocks of a row in one launch) against the
    plain block-by-block _absorb, with one state serving 7 x 5 rows."""
    rng = np.random.default_rng(blocks)
    for mod, kern, width in ((sha256, sha256_cuda.compress, 64),
                             (sha512, sha512_cuda.compress, 128)):
        prefix = torch.tensor(rng.integers(0, 256, (3, width), dtype=np.uint8), device=gpu)
        mid = mod.midstate(prefix)[:, None, None, :]
        data = torch.tensor(rng.integers(0, 256, (3, 7, 5, blocks * width), dtype=np.uint8),
                            device=gpu)
        before = kern.launches
        got = mod._absorb(mid, data)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        want = mod._absorb(mid.cpu(), data.cpu())
        assert torch.equal(got.cpu(), want)
        hasher = hashlib.sha256 if width == 64 else hashlib.sha512
        tail = data[1, 6, 4, : width - 9].cpu().numpy().tobytes()
        digest = (mod.sha256 if width == 64 else mod.sha512)(data[1:2, 6, 4, : width - 9])
        assert bytes(digest[0].cpu().numpy()) == hasher(tail).digest()


def _sha2_plain_absorb(mod, states, blocks, per, width):
    st = states[:, None, :]
    rows = blocks.reshape(states.shape[0], per, blocks.shape[-1])
    for i in range(blocks.shape[-1] // width):
        st = mod.compress_plain(st, rows[..., i * width:(i + 1) * width])
    return st.reshape(-1, 8)


@pytest.mark.parametrize("path", [None, "rows", "split"])
@pytest.mark.parametrize("blocks", [1, 10, 17])
def test_sha2_paths_match_plain(gpu, path, blocks):
    """K12 and K13 through the rule's path and through each path forced,
    against the plain block-by-block absorb: rows on both sides of the
    crossover, rows not a multiple of 32, and 8 or 7 rows a state (groups
    of 32 rows that straddle states).  The wrapper's launches take the
    few-row path exactly where split_rule says, and count; a forced path,
    through ``sha256_cuda.launch``, does not."""
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    edge = sha256_cuda.SPLIT_ROWS_PER_SM * sms
    for mod, cuda_mod, width, words in (
            (sha256, sha256_cuda, 64, (0, 2**32)),
            (sha512, sha512_cuda, 128, (-2**63, 2**63))):
        for rows, per in ((1000, 8), (2047, 1), (994, 7), (edge - 32, 8), (edge, 1),
                          (edge + 40, 8)):
            rng = np.random.default_rng(rows * 100 + blocks)
            states = torch.tensor(rng.integers(*words, (rows // per, 8), dtype=np.int64),
                                  device=gpu)
            data = torch.tensor(rng.integers(0, 256, (rows, blocks * width), dtype=np.uint8),
                                device=gpu)
            before = cuda_mod.compress.launches, cuda_mod.compress.split_launches
            if path is None:  # the wrapper, by the rule, counted
                got = cuda_mod.compress(states, data, per)
                split = sha256_cuda.split_rule(rows, blocks, sms)
                assert (cuda_mod.compress.launches, cuda_mod.compress.split_launches) == (
                    before[0] + 1, before[1] + split), (width, rows, per)
            else:  # the path forced, as timing forces it: not counted
                got, taken = sha256_cuda.launch(width, states, data, per, path)
                assert taken == path
                assert (cuda_mod.compress.launches,
                        cuda_mod.compress.split_launches) == before, (width, rows, per)
            torch.cuda.synchronize()
            want = _sha2_plain_absorb(mod, states, data, per, width)
            assert torch.equal(got, want), (width, rows, per, path)


def test_sha2_paths_take_zero_rows_and_refuse_unknown_paths(gpu):
    for cuda_mod, width in ((sha256_cuda, 64), (sha512_cuda, 128)):
        before = cuda_mod.compress.launches
        out = cuda_mod.compress(torch.zeros((0, 8), dtype=torch.int64, device=gpu),
                                torch.zeros((0, 3 * width), dtype=torch.uint8, device=gpu))
        assert out.shape == (0, 8) and cuda_mod.compress.launches == before
        for path in ("rows", "split"):
            out, _ = sha256_cuda.launch(width, torch.zeros((0, 8), dtype=torch.int64, device=gpu),
                                        torch.zeros((0, 3 * width), dtype=torch.uint8,
                                                    device=gpu), 1, path)
            assert out.shape == (0, 8)
        with pytest.raises(ValueError, match="path"):
            sha256_cuda.launch(width, torch.zeros((1, 8), dtype=torch.int64, device=gpu),
                               torch.zeros((1, width), dtype=torch.uint8, device=gpu), 1, "warp")


def _slhdsa_on_gpu(gpu, data):
    """keygen -> pk, deterministic sign -> sig_sha256, verify, on the GPU."""
    p = slhdsa_params.PARAMS[data["algorithm"]]
    recs = data["tests"]

    def col(key):
        return torch.tensor([list(bytes.fromhex(r[key])) for r in recs], dtype=torch.uint8,
                            device=gpu)

    kg, sign, verify = sphincs.get(p.name)
    pk, sk = kg(col("sk_seed"), col("sk_prf"), col("pk_seed"))
    rs, digests = [], []
    for i, rec in enumerate(recs):
        skb, msg = bytes(sk[i].cpu().numpy()), bytes.fromhex(rec["msg"])
        r = slhdsa_params.prf_msg(p, skb[p.n:2 * p.n], skb[2 * p.n:3 * p.n], msg)
        rs.append(list(r))
        digests.append(list(slhdsa_params.h_msg(p, r, skb[2 * p.n:3 * p.n], skb[3 * p.n:], msg)))
    digest = torch.tensor(digests, dtype=torch.uint8, device=gpu)
    sig = sign(sk, torch.tensor(rs, dtype=torch.uint8, device=gpu), digest)
    bad = sig.clone()
    bad[:, -1] ^= 1
    ok = verify(pk.repeat(2, 1), digest.repeat(2, 1), torch.cat([sig, bad]))
    return recs, pk, sig, ok


@pytest.mark.parametrize("size", ["128f", "128s", "192f", "192s", "256f", "256s"])
def test_slhdsa_gpu_path_matches_vectors(gpu, size):
    data = json.loads((VECTOR_DIR / f"slhdsa_{size}.json").read_text())
    before = sha256_cuda.compress.launches, sha512_cuda.compress.launches
    recs, pk, sig, ok = _slhdsa_on_gpu(gpu, data)
    for i, rec in enumerate(recs):
        assert bytes(pk[i].cpu().numpy()).hex() == rec["pk"]
        assert hashlib.sha256(bytes(sig[i].cpu().numpy())).hexdigest() == rec["sig_sha256"]
    assert ok.tolist() == [True] * len(recs) + [False] * len(recs)
    assert sha256_cuda.compress.launches > before[0]
    assert (sha512_cuda.compress.launches > before[1]) == (size[:3] != "128")


@pytest.mark.parametrize("size,hasher", [("128f", sha256_cuda), ("192f", sha512_cuda)])
def test_slhdsa_sign_verify_through_the_few_row_path(gpu, size, hasher):
    """A 128f and a 192f keygen, sign and verify of the vector files: their
    T_l launches (few rows of 10 blocks, SHA-256 for 128f and SHA-512 for
    192f) take the few-row path, and the bytes stay the vectors'."""
    data = json.loads((VECTOR_DIR / f"slhdsa_{size}.json").read_text())
    before = hasher.compress.split_launches
    recs, pk, sig, ok = _slhdsa_on_gpu(gpu, data)
    for i, rec in enumerate(recs):
        assert bytes(pk[i].cpu().numpy()).hex() == rec["pk"]
        assert hashlib.sha256(bytes(sig[i].cpu().numpy())).hexdigest() == rec["sig_sha256"]
    assert ok.tolist() == [True] * len(recs) + [False] * len(recs)
    assert hasher.compress.split_launches > before


def test_batched_sphincs_on_the_default_backend(gpu, monkeypatch):
    """BatchedSignature over SPHINCS+-SHA2-128s-simple: clients sign with
    their own keys, signatures verify and one with a flipped byte does not;
    the memory-chunked sign_batch gives the bytes of one call."""
    dsa = get_signature("SPHINCS+-SHA2-128s-simple")
    assert dsa.backend == "cuda"
    pks, sks = dsa.generate_keypair_batch(6)
    msgs = [b"client %d" % i for i in range(6)]

    async def run():
        with BatchedSignature(dsa, max_wait_ms=5.0) as bs:
            sigs = await asyncio.gather(*(bs.sign(bytes(sk), m) for sk, m in zip(sks, msgs)))
            oks = await asyncio.gather(*(bs.verify(bytes(pk), m, s)
                                         for pk, m, s in zip(pks, msgs, sigs)))
            bad = bytearray(sigs[0])
            bad[0] ^= 1
            return sigs, oks, await bs.verify(bytes(pks[0]), msgs[0], bytes(bad))

    sigs, oks, bad_ok = asyncio.run(run())
    assert oks == [True] * 6 and not bad_ok
    budget = 2 * sphincs.rows_in_flight(dsa.params) * sphincs.BYTES_PER_ROW
    monkeypatch.setattr(dsa, "memory_budget", lambda: budget)
    assert dsa.sign_batch(sks, msgs) == sigs


def test_device_trace_records_the_cards_kernels(gpu, tmp_path):
    """obs.trace.device_trace on the card: a Chrome trace of CUDA activity
    that holds the launched kernel, and no host operators."""
    from quantum_resistant_p2p_tpu_torch.obs import trace

    seeds = _u8(130, 64, 34).to(gpu)
    with trace.device_trace(tmp_path) as path:
        mlkem_cuda.sample_ntt(seeds)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" and "sample_ntt_kernel" in e.get("name", "")
               for e in events)
    assert not any(e.get("cat") == "cpu_op" for e in events)


def test_traced_and_faulted_kem_flushes(gpu, monkeypatch):
    """One BatchedKEM on the card under a tracer, a cost ledger and a
    seeded plan: the 2nd encaps flush raises in all its futures, one decaps
    slot is poisoned, every other secret agrees; one queue.flush and one
    device.dispatch span a flush, each dispatch under its flush; the
    ledger's device seconds are the queues' device histograms'."""
    from quantum_resistant_p2p_tpu_torch import faults
    from quantum_resistant_p2p_tpu_torch.obs import cost, trace
    from quantum_resistant_p2p_tpu_torch.provider import facade_queues

    tracer = trace.Tracer()
    monkeypatch.setattr(trace, "TRACER", tracer)
    ledger = cost.CostLedger()
    plan = faults.FaultPlan(12, [
        faults.FaultRule("device.dispatch", "raise", match={"op": "ML-KEM-768.enc"}, nth=2),
        faults.FaultRule("device.dispatch", "poison", match={"op": "ML-KEM-768.dec"})])

    async def run():
        with BatchedKEM(get_kem("ML-KEM-768"), max_wait_ms=5.0) as bk:
            for q in facade_queues(bk):
                q.cost = ledger
            pairs = await asyncio.gather(*(bk.generate_keypair() for _ in range(8)))
            enc = await asyncio.gather(*(bk.encapsulate(pk) for pk, _ in pairs))
            failed = await asyncio.gather(*(bk.encapsulate(pk) for pk, _ in pairs),
                                          return_exceptions=True)
            dec = await asyncio.gather(*(bk.decapsulate(sk, ct) for (_, sk), (ct, _)
                                         in zip(pairs, enc)), return_exceptions=True)
            return enc, failed, dec, facade_queues(bk)

    with plan.activate():
        enc, failed, dec, queues = asyncio.run(run())
    assert all(isinstance(r, faults.FaultInjected) for r in failed)
    poisoned = [i for i, r in enumerate(dec) if isinstance(r, faults.FaultInjected)]
    assert len(poisoned) == 1 and [e["action"] for e in plan.injected] == ["raise", "poison"]
    assert all(dec[i] == enc[i][1] for i in range(8) if i not in poisoned)
    spans = tracer.snapshot()
    flushes = {s["span_id"] for s in spans if s["name"] == "queue.flush"}
    dispatches = [s for s in spans if s["name"] == "device.dispatch"]
    assert len(flushes) == len(dispatches) == sum(q.stats.flushes for q in queues) == 4
    assert {s["parent_id"] for s in dispatches} == flushes
    assert abs(ledger.device_seconds_total()
               - sum(q.stats.device_hist.total for q in queues)) < 1e-9


def test_breaker_never_trips_on_healthy_device_flushes(gpu):
    """ML-KEM-768 and ChaCha20-Poly1305 facades on one scheduler shard
    pinned to the card, each with its CPU fallback armed: 256 clients'
    keygen, encaps and decaps and 256 seals and opens all run on the
    device (no trip, no fallback op, the breaker closed), every secret
    agrees and every frame opens."""
    from quantum_resistant_p2p_tpu_torch.provider import facade_queues
    from quantum_resistant_p2p_tpu_torch.provider.scheduler import DeviceProgramScheduler

    sched = DeviceProgramScheduler(shards=1, devices=[torch.device("cuda", 0)])
    scalar = get_symmetric("ChaCha20-Poly1305")
    key = bytes(range(32))
    msgs = [bytes([i]) * 256 for i in range(256)]

    async def run():
        with BatchedKEM(get_kem("ML-KEM-768"), max_wait_ms=5.0,
                        fallback=get_kem("ML-KEM-768", backend="cpu"), scheduler=sched) as bk, \
                BatchedAEAD(get_batched_aead("ChaCha20-Poly1305"), scalar, max_wait_ms=5.0,
                            scheduler=sched, fallback=scalar) as ba:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            agreed = await asyncio.gather(*(client() for _ in range(256)))
            frames = await asyncio.gather(*(ba.encrypt(key, m, b"ad") for m in msgs))
            opened = await asyncio.gather(*(ba.decrypt(key, memoryview(f), b"ad")
                                            for f in frames))
            return agreed, opened, list(facade_queues(bk)) + list(facade_queues(ba))

    agreed, opened, queues = asyncio.run(run())
    shard = sched.shards[0]
    sched.close()
    assert all(agreed) and opened == msgs
    assert shard.breaker.state == "closed" and shard.breaker.trips == 0
    assert all(q.stats.breaker_trips == q.stats.fallback_ops == 0 for q in queues)
    assert shard.dispatches == shard.breaker.device_trips == sum(q.stats.device_trips
                                                                 for q in queues)


def test_health_cache_round_trip_on_the_card(gpu, tmp_path, monkeypatch):
    """The gate into a fresh cache probes the card (cached false) and reads
    every verdict back (cached true); the fingerprint names the card."""
    from quantum_resistant_p2p_tpu_torch.provider import health

    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path))
    kem = get_kem("ML-KEM-768")
    aead = get_batched_aead("ChaCha20-Poly1305")
    with BatchedKEM(kem, fallback=get_kem("ML-KEM-768", backend="cpu")) as bk, \
            BatchedAEAD(aead, fallback=get_symmetric("ChaCha20-Poly1305")) as ba:
        first = health.gate_facades(bk, ba)
        second = health.gate_facades(bk, ba)
    assert [(v.ok, v.cached) for v in first] == [(True, False)] * 2
    assert [(v.ok, v.cached) for v in second] == [(True, True)] * 2
    fp = health.env_fingerprint(kem.device)
    assert f"dev={torch.cuda.get_device_name(0)}|" in fp and "|cc=9.0|" in fp
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        health._marker(v.family, fp).name for v in first)


def test_two_engines_handshake_and_message_on_the_card(gpu, tmp_path, monkeypatch):
    """Two port ``SecureMessaging`` engines on "cuda" with batching on (the
    default ML-KEM-768 x ML-DSA-65, fused; ChaCha20-Poly1305 on the device
    data plane) over loopback: the handshake takes at most 4 trips on the
    initiator's scheduler, the keys agree, one message arrives, and no
    queue of either engine has a CPU fallback armed or served a fallback
    op."""
    from quantum_resistant_p2p_tpu_torch.app import SecureMessaging
    from quantum_resistant_p2p_tpu_torch.net.p2p_node import P2PNode
    from quantum_resistant_p2p_tpu_torch.provider import facade_queues

    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path))

    async def run():
        nodes = [P2PNode(name, "127.0.0.1", 0) for name in ("gpu-a", "gpu-b")]
        for n in nodes:
            await n.start()
        a, b = (SecureMessaging(n, use_batching=True,
                                symmetric=get_symmetric("ChaCha20-Poly1305")) for n in nodes)
        got = []
        b.register_message_listener(lambda p, m: None if m.is_system else got.append(m))
        try:
            await asyncio.wait_for(asyncio.gather(a.wait_ready(), b.wait_ready()), 300)
            assert a.ready_status()["ready"] and b.ready_status()["ready"]
            assert await asyncio.wait_for(nodes[0].connect_to_peer("127.0.0.1", nodes[1].port),
                                          8) == "gpu-b"
            assert await asyncio.wait_for(a.initiate_key_exchange("gpu-b"), 60)
            assert await a.send_message("gpu-b", b"on the card") is not None
            for _ in range(800):
                if got:
                    break
                await asyncio.sleep(0.01)
            return a, b, got
        finally:
            for n in nodes:
                await n.stop()
            a.close()
            b.close()

    a, b, got = asyncio.run(run())
    assert [m.content for m in got] == [b"on the card"]
    assert a.shared_keys["gpu-b"] == b.shared_keys["gpu-a"]
    assert (a.kem.backend, a.signature.backend) == ("cuda", "cuda")
    assert a.metrics()["handshake_trips"]["last"] <= 4
    assert a._bfused.stats()["keygen_sign"]["ops"] >= 1
    assert b._bfused.stats()["encaps_verify_sign"]["ops"] >= 1
    assert b._baead.stats()["open"]["ops"] == 1
    for e in (a, b):
        m = e.metrics()
        assert m["fallback_trips"] == 0 and m["device_served_fraction"] == 1.0
        assert m["breaker_state"] == "closed" and m["breaker_trips"] == 0
        assert all(q.fallback_fn is None for f in (e._bkem, e._bsig, e._bfused, e._baead)
                   for q in facade_queues(f))


def test_task_fleet_of_real_gateways_serves_on_the_card(gpu, tmp_path, monkeypatch):
    """A task-mode ``GatewayFleet`` of two gateways with the real providers
    on "cuda" (ML-KEM-768 x ML-DSA-65 fused, ChaCha20-Poly1305): one client
    routes, handshakes and sends a message; the gateway's stats show every
    dispatch on the device, no fallback op or trip, and K1-K8 launched in
    this process."""
    from quantum_resistant_p2p_tpu_torch.app import SecureMessaging
    from quantum_resistant_p2p_tpu_torch.fleet import GatewayFleet, control
    from quantum_resistant_p2p_tpu_torch.net.p2p_node import P2PNode

    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path))

    async def run():
        fleet = GatewayFleet(2, spawn="task", providers="real", hb_interval=0.1,
                             register_timeout=300.0, gateway_kw={"prewarm_cap": 2})
        await fleet.start()
        node = P2PNode("fleet-client", "127.0.0.1", 0)
        client = None
        try:
            await node.start()
            client = SecureMessaging(node, use_batching=True,
                                     symmetric=get_symmetric("ChaCha20-Poly1305"))
            await asyncio.wait_for(client.wait_ready(), 300)
            reply = await control.route_query("127.0.0.1", fleet.ctrl_port, node.node_id)
            gid = reply["gateway"]
            assert await asyncio.wait_for(node.connect_to_peer(reply["host"], reply["port"]),
                                          8) == gid
            assert await asyncio.wait_for(client.initiate_key_exchange(gid), 60)
            assert await client.send_message(gid, b"through the fleet") is not None
            member = fleet.members[gid]
            for _ in range(600):
                if (member.stats.get("msgs_received") or 0) >= 1:
                    break
                await asyncio.sleep(0.05)
            return member.stats, client.metrics()
        finally:
            await node.stop()
            if client is not None:
                client.close()
            await fleet.stop()

    stats, client_metrics = asyncio.run(run())
    assert stats["msgs_received"] == 1 and stats["ops"] > 0
    assert stats["device_served_fraction"] == 1.0
    assert stats["fallback_ops"] == 0 and stats["fallback_trips"] == 0
    assert stats["breaker_state"] == "closed"
    assert client_metrics["fallback_trips"] == 0
    launched = stats["kernel_launches"]
    for name in ("keccak_sponge", "keccak_sponge_varlen", "mlkem_sample_ntt", "mlkem_prf_cbd",
                 "mlkem_prf_cbd_ntt", "mlkem_ntt", "mlkem_ntt_inv", "mldsa_rej_ntt",
                 "mldsa_rej_bounded", "mldsa_ntt", "mldsa_ntt_inv", "chacha_blocks"):
        assert launched[name] > 0, name
