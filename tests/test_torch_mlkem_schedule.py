"""The schedules of kernels K2 (SampleNTT) and K3 (PRF + CBD, with and
without the fused NTT mod 3329), held to the plain versions on the CPU.

The CUDA kernels cannot run here, but what they compute can be walked in
numpy step by step as ``csrc/mlkem.cuh`` and ``csrc/mlkem.cu`` do it: the
warp's staged rows read as 32-bit words, K2's per-thread compaction into
its ring and the warp's flush of the rings to the output rows (a lowered
acceptance bound forces rows to a 4th block and to the short fill), K3's
lane-to-coefficient maps, and the fused NTT in K7's layout
from the tables ``kem/mlkem_cuda.py`` uploads, with its lazy Shoup products
and their bounds.  It imports no jax.
"""

import re

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu_torch.core import keccak
from quantum_resistant_p2p_tpu_torch.kem import mlkem, mlkem_cuda as mc
from quantum_resistant_p2p_tpu_torch.kem.params import ZETAS
from quantum_resistant_p2p_tpu_torch.utils.cuda import CSRC

Q = mlkem.Q
M32 = (1 << 32) - 1
SHOUP_ONE = (1 << 32) // Q  # kShoupOne: the Shoup companion of 1
WARP = 32


def _seeds(seed: int, rows: int, length: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=(rows, length), dtype=np.uint8))


def _words(stream: np.ndarray) -> np.ndarray:
    """(rows, bytes) uint8 staged rows -> (rows, bytes / 4) int64 words, as
    the kernels read the staging buffer."""
    return np.ascontiguousarray(stream).view("<u4").astype(np.int64)


def _funnel_r(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh."""
    return (((hi << 32) | lo) >> sh) & M32


def _row_six_bytes(words: np.ndarray, lane: int):
    """row_six_bytes: bytes [6 lane, 6 lane + 6) of each row as two 24-bit
    chunks."""
    i, sh = (6 * lane) >> 2, 8 * ((6 * lane) & 3)
    assert sh in (0, 16)
    x = _funnel_r(words[:, i], words[:, i + 1], sh)
    y = (words[:, i + 1] >> sh) & 0xFFFF
    return x & 0xFFFFFF, (x >> 24) | (y << 8)


# --------------------------------------------------------------------------
# Seeds in
# --------------------------------------------------------------------------


@pytest.mark.parametrize("length", [33, 34])
@pytest.mark.parametrize("skew", [0, 1, 2, 3])
def test_staged_seed_lanes_are_the_padded_block(length, skew):
    """stage_seeds + absorb_staged: a warp's rows start `skew` bytes into the
    first aligned word; lane r's first five 64-bit lanes, assembled from 10
    staged words by funnel shifts, are its seed, the domain byte and zeros,
    and the staged words hold every byte of the rows and no word beyond."""
    rows = _seeds(skew, WARP, length).numpy()
    words = -(-(skew + WARP * length) // 4)
    buf = np.zeros(4 * (words + 16), dtype=np.uint8)  # + the words lane 31 reads past the rows
    buf[skew:skew + rows.size] = rows.reshape(-1)
    sw = _words(buf[None])[0]
    assert 4 * words - (skew + rows.size) < 4 and skew < 4
    for lane in range(WARP):
        o = skew + lane * length
        w = sw[(o >> 2):(o >> 2) + 10]
        sh = 8 * (o & 3)
        lanes = [_funnel_r(w[2 * k], w[2 * k + 1], sh) | (_funnel_r(w[2 * k + 1], w[2 * k + 2], sh)
                                                          << 32) for k in range(4)]
        tail = _funnel_r(w[8], w[9], sh) & ((1 << (8 * (length - 32))) - 1)
        lanes.append(tail | (0x1F << (8 * (length - 32))))
        got = np.array(lanes, dtype=np.uint64).view(np.uint8)
        want = np.zeros(40, dtype=np.uint8)
        want[:length], want[length] = rows[lane], 0x1F
        assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------


RING_SLOTS, RING_STRIDE = 112, 33


def _block_candidates(block: np.ndarray) -> np.ndarray:
    """block_candidate: (rows, 168) squeezed bytes -> (rows, 112), candidate
    c from bits [12 c, 12 c + 12) of the 64-bit lanes."""
    lanes = np.ascontiguousarray(block).view("<u8")
    out = np.empty((block.shape[0], RING_SLOTS), dtype=np.int64)
    for c in range(RING_SLOTS):
        w, sh = (12 * c) >> 6, (12 * c) & 63
        v = lanes[:, w] >> np.uint64(sh)
        if sh > 52:
            v = v | (lanes[:, w + 1] << np.uint64(64 - sh))
        out[:, c] = (v & np.uint64(0xFFF)).astype(np.int64)
    return out


def _sample_ntt_walk(seeds: torch.Tensor, bound: int):
    """sample_ntt_kernel over rows of 34-byte seeds, a warp at a time, with
    candidates < ``bound`` accepted: append_block into each lane's ring
    column, then flush_ring's clamped two-row copies.  Returns the output
    rows and the blocks each row permuted for in the first pass."""
    n = seeds.shape[0]
    stream = keccak.sponge_plain(seeds, 168, 0x1F, 672).numpy()
    cands = [_block_candidates(stream[:, 168 * b:168 * (b + 1)]) for b in range(4)]
    out = np.full((n, 256), -1, dtype=np.int64)
    used = np.zeros(n, dtype=np.int64)
    for row0 in range(0, n, WARP):
        rows = min(WARP, n - row0)
        cnt = [0 if lane < rows else 256 for lane in range(WARP)]
        for want_accepted in (True, False):
            for b in range(4):
                todo = [r for r in range(WARP) if cnt[r] < 256]
                if not todo:
                    break
                ring = np.full(RING_SLOTS * RING_STRIDE, -1, dtype=np.int64)
                k = [0] * WARP
                for lane in todo:
                    used[row0 + lane] += want_accepted
                    off = lane
                    for d in cands[b][row0 + lane]:
                        ring[off] = d
                        if (d < bound) == want_accepted:
                            off += RING_STRIDE
                    k[lane] = (off - lane) // RING_STRIDE
                    assert off < lane + RING_SLOTS * RING_STRIDE + RING_STRIDE
                for step in range(0, len(todo), 2):
                    written = {}
                    for r in todo[step:step + 2]:
                        at, m = cnt[r], min(k[r], 256 - cnt[r])
                        for t in range(16):
                            for j in range(7):
                                if m > 0:
                                    i = min(t + 16 * j, m - 1)
                                    val = ring[i * RING_STRIDE + r]
                                    assert written.setdefault((r, at + i), val) == val
                        got = sorted(i for (rr, i) in written if rr == r)
                        assert got == list(range(at, at + max(m, 0)))
                    for (r, pos), val in written.items():
                        assert out[row0 + r, pos] == -1 and val >= 0
                        out[row0 + r, pos] = val
                for lane in todo:
                    cnt[lane] += k[lane]
    assert (out >= 0).all(), "a slot never written"
    return out, used


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_compaction_matches_sample_ntt_plain(seed):
    seeds = _seeds(seed, 5 * WARP + 5, 34)
    got, used = _sample_ntt_walk(seeds, Q)
    assert np.array_equal(got, mlkem.sample_ntt_plain(seeds).numpy())
    assert used.min() == 3  # 224 candidates never give 256


def test_k2_rows_that_need_a_fourth_block():
    """~0.8% of rows need a 4th block at q: pick such rows from a larger
    draw (found with the plain sampler) and walk them with full warps."""
    seeds = _seeds(99, 4096, 34)
    buf = keccak.sponge_plain(seeds, 168, 0x1F, 504).to(torch.int64).reshape(len(seeds), -1, 3)
    cand = torch.stack([buf[..., 0] + 256 * (buf[..., 1] % 16), buf[..., 1] // 16 + 16 * buf[..., 2]],
                       dim=-1).reshape(len(seeds), -1)
    short = torch.nonzero((cand < Q).sum(-1) < 256).flatten()
    assert len(short) >= 8
    pick = seeds[torch.cat([short, torch.arange(64 - len(short) % 64)])[:64]]
    got, used = _sample_ntt_walk(pick, Q)
    assert np.array_equal(got, mlkem.sample_ntt_plain(pick).numpy())
    assert (used == 4).sum() >= 8


@pytest.mark.parametrize("bound", [3000, 2250, 1200])
def test_k2_fourth_block_and_short_fill_keep_the_reference_order(bound):
    """A lowered acceptance bound sends rows to the 4th block (3000: most
    rows), to the short fill of rejected candidates (2250: most rows, 1200:
    all), against the plain in-order compaction at that bound."""
    seeds = _seeds(bound, 2 * WARP + 7, 34)
    got, used = _sample_ntt_walk(seeds, bound)
    buf = keccak.sponge_plain(seeds, 168, 0x1F, 672).to(torch.int64).reshape(len(seeds), -1, 3)
    cand = torch.stack([buf[..., 0] + 256 * (buf[..., 1] % 16), buf[..., 1] // 16 + 16 * buf[..., 2]],
                       dim=-1).reshape(len(seeds), -1)
    want = keccak.compact_accepted(cand, cand < bound).numpy()
    assert np.array_equal(got, want)
    accepted = (cand < bound).sum(-1).numpy()
    assert (used == 4).any() and ((accepted < 256).any() or bound == 3000)


def test_k2_block_candidates_are_the_blocks_candidates_in_order():
    """block_candidate c is the block's c-th 12-bit candidate: the two
    halves of each 3-byte triple, in order."""
    block = _seeds(5, 64, 168).numpy()
    t = block.astype(np.int64).reshape(64, 56, 3)
    want = np.stack([t[..., 0] | ((t[..., 1] & 0xF) << 8), (t[..., 1] >> 4) | (t[..., 2] << 4)],
                    axis=-1).reshape(64, 112)
    assert np.array_equal(_block_candidates(block), want)


def test_k2_ring_reads_hit_16_banks_a_half_warp():
    """flush_ring: a half-warp reads slot t + 16 j of one row r, at 16-bit
    index 33 i + r, i.e. 32-bit word (33 i + r) // 2: 16 distinct banks."""
    for r in range(WARP):
        for j in range(7):
            banks = {((RING_STRIDE * (t + 16 * j) + r) // 2) % 32 for t in range(16)}
            assert len(banks) == 16


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------


def _prf_stage(seeds: torch.Tensor, eta: int) -> np.ndarray:
    """The staged words of each row (PrfStage<eta>::kWords): eta 2 the first
    block (128 of its bytes read), eta 3 the first block, the second's first
    56 bytes and a padding lane, random here (192 bytes read)."""
    stream = keccak.sponge_plain(seeds, 136, 0x1F, 136 if eta == 2 else 192).numpy()
    if eta == 3:
        pad = np.random.default_rng(7).integers(0, 256, size=(len(stream), 8), dtype=np.uint8)
        stream = np.concatenate([stream, pad], axis=-1)
    return _words(stream)


def _cbd(t, k, bits):
    """Coefficient k of a word of summed eta-bit fields: x - y."""
    mask = (1 << bits) - 1
    return ((t >> (2 * bits * k)) & mask) - ((t >> (2 * bits * k + bits)) & mask)


def _k3_lane_coefficients(words: np.ndarray, eta: int, lane: int) -> np.ndarray:
    """prf_cbd_kernel<eta, false>: lane's 8 canonical coefficients."""
    if eta == 2:
        w = words[:, lane]
        t = (w & 0x55555555) + ((w >> 1) & 0x55555555)
        c = [_cbd(t, k, 2) for k in range(8)]
    else:
        c = []
        for chunk in _row_six_bytes(words, lane):
            t = (chunk & 0x249249) + ((chunk >> 1) & 0x249249) + ((chunk >> 2) & 0x249249)
            c += [_cbd(t, k, 3) for k in range(4)]
    return np.stack(c, axis=-1) % Q


@pytest.mark.parametrize("eta", [2, 3])
def test_k3_lanes_cover_every_coefficient_and_byte_once(eta):
    """Lane l writes coefficients 8 l .. 8 l + 7 from bytes [2 eta l * 2,
    + 2 eta * 2): every coefficient once, every byte of the 64 eta once; for
    eta 3, lane 22 reads chunk 45, bytes 135-137 across the block edge."""
    coeffs = sorted(8 * lane + k for lane in range(WARP) for k in range(8))
    assert coeffs == list(range(256))
    per_lane = 4 if eta == 2 else 6
    read = sorted(per_lane * lane + b for lane in range(WARP) for b in range(per_lane))
    assert read == list(range(64 * eta))
    if eta == 3:
        assert 6 * 22 <= 135 and 137 < 6 * 23 and 3 * 45 == 135


@pytest.mark.parametrize("eta", [2, 3])
def test_k3_decode_matches_prf_cbd_plain(eta):
    seeds = _seeds(10 + eta, 70, 33)
    words = _prf_stage(seeds, eta)
    got = np.concatenate([_k3_lane_coefficients(words, eta, lane) for lane in range(WARP)], -1)
    assert np.array_equal(got, mlkem.prf_cbd_plain(seeds, eta).numpy())


def _cbd_lazy(v, eta):
    """cbd_lazy<eta>: x - y + q from one coefficient's bit field."""
    if eta == 2:
        t = (v & 0x5) + ((v >> 1) & 0x5)
        return (t & 3) + Q - ((t >> 2) & 3)
    t = (v & 0x9) + ((v >> 1) & 0x9) + ((v >> 2) & 0x9)
    return (t & 7) + Q - ((t >> 3) & 7)


def _fused_decode(words: np.ndarray, eta: int) -> np.ndarray:
    """prf_cbd_kernel<eta, true>'s decode into stage-A registers: (rows,
    16 lanes, 16 regs), lane t register j = coefficient t + 16 j."""
    regs = np.empty((words.shape[0], 16, 16), dtype=np.int64)
    for t in range(16):
        for j in range(16):
            if eta == 2:
                v = (words[:, 2 * j + (t >> 3)] >> (4 * (t & 7))) & 0xF
            else:
                a = 3 * j + ((6 * t) >> 5)
                v = _funnel_r(words[:, a], words[:, a + 1], (6 * t) & 31) & 63
            regs[:, t, j] = _cbd_lazy(v, eta)
    return regs


@pytest.mark.parametrize("eta", [2, 3])
def test_k3_fused_decode_reads_each_coefficients_bits(eta):
    """Lane t register j reads bits [2 eta c, 2 eta c + 2 eta) of the
    stream, c = t + 16 j, every coefficient once; the value is the CBD
    coefficient + q, in [q - eta, q + eta]."""
    assert sorted(mc.ntt_coefficient(0, t, j) for t in range(16) for j in range(16)) == \
        list(range(256))
    for t in range(16):
        for j in range(16):
            c = mc.ntt_coefficient(0, t, j)
            if eta == 2:
                start = 32 * (2 * j + (t >> 3)) + 4 * (t & 7)
            else:
                start = 32 * (3 * j + ((6 * t) >> 5)) + ((6 * t) & 31)
            assert start == 2 * eta * c
    seeds = _seeds(20 + eta, 40, 33)
    regs = _fused_decode(_prf_stage(seeds, eta), eta)
    assert ((regs >= Q - eta) & (regs <= Q + eta)).all()
    plain = mlkem.prf_cbd_plain(seeds, eta).numpy()
    for t in range(16):
        for j in range(16):
            assert np.array_equal(regs[:, t, j] % Q, plain[:, mc.ntt_coefficient(0, t, j)])


def _lazy_mul(a, w, w_shoup):
    """kem_mulmod_lazy: a * w - umulhi(a, w') * q mod 2^32, in [0, 2q)."""
    r = (a * w - ((a * w_shoup) >> 32) * Q) & M32
    assert (r < 2 * Q).all()
    return r


def _reduce(x):
    """kem_reduce: a Shoup product by 1, then min(r, r - q) unsigned."""
    r = _lazy_mul(x, 1, SHOUP_ONE)
    return np.minimum(r, (r - Q) & M32)


def _relayout(regs, src_stage, dst_stage):
    coeff = np.empty((regs.shape[0], 256), dtype=np.int64)
    out = np.empty_like(regs)
    for t in range(16):
        for j in range(16):
            coeff[:, mc.ntt_coefficient(src_stage, t, j)] = regs[:, t, j]
    for t in range(16):
        for j in range(16):
            out[:, t, j] = coeff[:, mc.ntt_coefficient(dst_stage, t, j)]
    return out


def _fused_ntt(regs: np.ndarray) -> np.ndarray:
    """kem_ntt_forward on stage-A registers (values below 2q): every
    intermediate checked against the note's bound (2 + 2k) q after layer
    k, below 2^16; returns canonical coefficients in stage-A registers."""
    uni = mc.NTT_UNIFORM.astype(np.int64)
    lanes = mc.NTT_LANE_TABLE.astype(np.int64)
    tables = ((np.broadcast_to(uni[0, :15], (16, 15)), np.broadcast_to(uni[1, :15], (16, 15))),
              (lanes[0].T, lanes[1].T))
    assert (regs < 2 * Q).all()
    layer = 0
    for stage in (0, 1):
        if stage:
            regs = _relayout(regs, 0, 1)
        w, w_shoup = tables[stage]
        for h in mc.NTT_HALVES[stage]:
            for j in range(16):
                if j & h:
                    continue
                s = mc.ntt_slot(h, j)
                a = regs[:, :, j].copy()
                t = _lazy_mul(regs[:, :, j + h], w[:, s], w_shoup[:, s])
                regs[:, :, j + h] = a + 2 * Q - t
                regs[:, :, j] = a + t
            layer += 1
            assert (regs < (2 + 2 * layer) * Q).all() and (regs >= 0).all()
    assert layer == 7 and (regs < 16 * Q).all() and 16 * Q < 1 << 16
    return _relayout(_reduce(regs), 1, 0)


def _unlayout(regs: np.ndarray) -> np.ndarray:
    out = np.empty((regs.shape[0], 256), dtype=np.int64)
    for t in range(16):
        for j in range(16):
            out[:, mc.ntt_coefficient(0, t, j)] = regs[:, t, j]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_ntt_schedule_matches_ntt_plain_within_its_bounds(seed):
    """Inputs over the whole lazy range [0, 2q): the extremes as whole
    polynomials and mixed with random values."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 2 * Q, size=(6, 256), dtype=np.int64)
    f[0], f[1] = 0, 2 * Q - 1
    f[2, ::2] = 2 * Q - 1
    f[3, 1::3] = 0
    regs = np.empty((6, 16, 16), dtype=np.int64)
    for t in range(16):
        for j in range(16):
            regs[:, t, j] = f[:, mc.ntt_coefficient(0, t, j)]
    want = mlkem.ntt_plain(torch.from_numpy((f % Q).astype(np.int32))).numpy()
    assert np.array_equal(_unlayout(_fused_ntt(regs)), want)


@pytest.mark.parametrize("eta", [2, 3])
def test_fused_k3_matches_prf_cbd_ntt_plain(eta):
    seeds = _seeds(30 + eta, 40, 33)
    got = _unlayout(_fused_ntt(_fused_decode(_prf_stage(seeds, eta), eta)))
    assert np.array_equal(got, mlkem.prf_cbd_ntt_plain(seeds, eta).numpy())


@pytest.mark.parametrize("stage", [0, 1], ids=["A", "B"])
def test_fused_ntt_layers_pair_the_plain_butterflies_inside_one_lane(stage):
    """Every butterfly of a stage's layers pairs two registers of one lane,
    exactly the plain layer's pairs, and its slot names the plain zeta."""
    for h in mc.NTT_HALVES[stage]:
        length = h * (16 if stage == 0 else 1)
        groups = 256 // (2 * length)
        plain_pairs = {(g * 2 * length + i, g * 2 * length + i + length)
                       for g in range(groups) for i in range(length)}
        pairs = set()
        for t in range(16):
            for j in range(16):
                if j & h:
                    continue
                i0 = mc.ntt_coefficient(stage, t, j)
                pairs.add((i0, mc.ntt_coefficient(stage, t, j + h)))
                s = mc.ntt_slot(h, j)
                k = mc.NTT_ZETA_INDEX_A[s] if stage == 0 else mc.NTT_ZETA_INDEX_B[s, t]
                assert k == groups + i0 // (2 * length)
        assert pairs == plain_pairs


def test_fused_ntt_tables_hold_the_zetas_and_their_shoup_companions():
    z = np.asarray(ZETAS, dtype=np.int64)
    uni, lanes = mc.NTT_UNIFORM.astype(np.int64), mc.NTT_LANE_TABLE.astype(np.int64)
    assert np.array_equal(uni[0, :15], z[mc.NTT_ZETA_INDEX_A])
    assert np.array_equal(uni[0, :15], z[1:16])
    assert np.array_equal(lanes[0], z[mc.NTT_ZETA_INDEX_B])
    for table in (uni, lanes):
        assert np.array_equal(table[1], (table[0] << 32) // Q)
    src = (CSRC / "mlkem.cuh").read_text()
    assert int(re.search(r"kShoupOne = (\d+)u", src).group(1)) == SHOUP_ONE


def test_shoup_product_and_reduction_exhaustive_over_their_ranges():
    """kem_mulmod_lazy for every a below the NTT's bound 16q and every zeta,
    and kem_reduce for every value below 16q and for 2^20 spread over all
    32-bit values, against %."""
    a = np.arange(16 * Q, dtype=np.int64)
    z = np.asarray(ZETAS, dtype=np.int64)
    for w in z:
        r = _lazy_mul(a, w, (w << 32) // Q)
        assert np.array_equal(r % Q, a * w % Q)
    assert np.array_equal(_reduce(a), a % Q)
    x = np.unique(np.concatenate([np.arange(0, 1 << 32, 4099, dtype=np.int64)[:1 << 20],
                                  np.arange(M32 - 4096, M32 + 1, dtype=np.int64)]))
    assert np.array_equal(_reduce(x), x % Q)


# --------------------------------------------------------------------------
# e1 and e2 in one K3 launch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ML-KEM-512", "ML-KEM-768", "ML-KEM-1024"])
def test_e1_and_e2_from_one_call_equal_the_two_calls(name):
    """K-PKE.Encrypt draws rows k..2k of r in one _prf_cbd call and splits
    them: the same bytes as e1 = rows k..2k-1 and e2 = row 2k apart."""
    p = mlkem.PARAMS[name]
    k = p.k
    r = _seeds(k, 2 * 3, 32).reshape(2, 3, 32)
    e12 = mlkem._prf_cbd(r, range(k, 2 * k + 1), p.eta2)
    e1 = mlkem._prf_cbd(r, range(k, 2 * k), p.eta2)
    e2 = mlkem._prf_cbd(r, range(2 * k, 2 * k + 1), p.eta2)[..., 0, :]
    assert torch.equal(e12[..., :k, :], e1) and torch.equal(e12[..., k, :], e2)
