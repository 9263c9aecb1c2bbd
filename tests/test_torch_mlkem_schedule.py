"""The schedules of kernels K2 (SampleNTT), K3 (PRF + CBD, with and
without the fused NTT mod 3329), K4 (the NTT mod 3329, forward and
inverse), K5 (ML-DSA's RejNTTPoly, on K2's ring) and K6 (ML-DSA's
RejBoundedPoly, on K2's ring), held to the plain versions on the CPU.

The CUDA kernels cannot run here, but what they compute can be walked in
numpy step by step as ``csrc/warp_sampler.cuh``, ``csrc/ntt_halfwarp.cuh``,
``csrc/mlkem.cuh`` and ``csrc/mlkem.cu`` do it: the warp's staged rows read
as 32-bit words, the per-thread compaction into a ring and the warp's
flush of the rings to the output rows (a lowered acceptance bound forces
rows to the later blocks and to the short fill), K3's lane-to-coefficient
maps, and the NTT in K7's layout from the tables ``kem/mlkem_cuda.py``
uploads, with its lazy Shoup products and each layer's bound.  It imports
no jax.
"""

import re

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu_torch.core import keccak
from quantum_resistant_p2p_tpu_torch.kem import mlkem, mlkem_cuda as mc
from quantum_resistant_p2p_tpu_torch.kem.params import N_INV, ZETAS
from quantum_resistant_p2p_tpu_torch.sig import mldsa
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


def _absorb_staged_lanes(sw: np.ndarray, skew: int, lane: int, length: int) -> np.ndarray:
    """absorb_staged's seed lanes: staged_seed_words(length) words from word
    (skew + lane * length) / 4 on, seed word j the funnel of words j and
    j + 1, whole 64-bit lanes from pairs of them, then the lane of the last
    bytes masked with the domain byte 0x1F after them.  Returns the lanes
    up to that one as bytes."""
    n_words = (length + 3) // 4 + 1
    full, tail = length // 8, length % 8
    o = skew + lane * length
    w = sw[(o >> 2):(o >> 2) + n_words]
    sh = 8 * (o & 3)
    x = [_funnel_r(w[k], w[k + 1], sh) for k in range(n_words - 1)] + [0, 0]
    lanes = [x[2 * k] | (x[2 * k + 1] << 32) for k in range(full + 1)]
    lanes[full] = (lanes[full] & ((1 << (8 * tail)) - 1)) | (0x1F << (8 * tail))
    return np.array(lanes, dtype=np.uint64).view(np.uint8)


@pytest.mark.parametrize("length", [33, 34, 35, 36, 37, 38, 39, 66])
@pytest.mark.parametrize("skew", [0, 1, 2, 3])
def test_staged_seed_lanes_are_the_padded_block(length, skew):
    """stage_seeds + absorb_staged: a warp's rows start `skew` bytes into the
    first aligned word; lane r's seed lanes, assembled from the staged words
    by funnel shifts, are its seed, the domain byte and zeros, and the
    staged words hold every byte of the rows and no word beyond.  33 and 34
    are K3's and K2/K5's seeds, 66 K6's (8 whole lanes and 2 bytes); the
    words lane 31 reads stay inside sample_rows' bound on the ring."""
    rows = _seeds(skew, WARP, length).numpy()
    words = -(-(skew + WARP * length) // 4)
    buf = np.zeros(4 * (words + 16), dtype=np.uint8)  # + the words lane 31 reads past the rows
    buf[skew:skew + rows.size] = rows.reshape(-1)
    sw = _words(buf[None])[0]
    assert 4 * words - (skew + rows.size) < 4 and skew < 4
    last_read = (skew + (WARP - 1) * length) // 4 + (length + 3) // 4 + 1
    assert last_read <= (3 + WARP * length + 3) // 4 + 1  # sample_rows' static_assert
    for lane in range(WARP):
        got = _absorb_staged_lanes(sw, skew, lane, length)
        want = np.zeros(8 * (length // 8 + 1), dtype=np.uint8)
        want[:length], want[length] = rows[lane], 0x1F
        assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------


RING_SLOTS, RING_STRIDE = 112, 33


def _block_candidates(block: np.ndarray) -> np.ndarray:
    """SampleNttCands::at: (rows, 168) squeezed bytes -> (rows, 112), candidate
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


def _append_block(ring: np.ndarray, lane: int, cands_row, bound: int, want_accepted: bool,
                  last: bool, last_slots: int, first: int = 0, clamp: int | None = None) -> int:
    """append_block: store each candidate at ring column `lane`'s next slot,
    from slot `first` on, and move on only past a wanted one; in the `last`
    block no candidate from last_slots on is wanted; with a `clamp` (a row
    ring) the next slot is clamped to it every 16 candidates.  Returns the
    slot after the last wanted candidate."""
    nxt = first
    for c, d in enumerate(cands_row):
        if clamp is not None and c % 16 == 0:
            nxt = min(nxt, clamp)
        ring[lane + RING_STRIDE * nxt] = d
        if (d < bound) == want_accepted and (c < last_slots or not last):
            nxt += 1
    assert lane + RING_STRIDE * nxt < len(ring) + RING_STRIDE
    return nxt


def _flush_slots(t: int, m: int, steps: int, whole_rows: bool = False) -> list:
    """The ring slots lane t of a half-warp copies for a run of m: slot
    t + 16 j for each of the ring's steps, clamped to m - 1; a ring that
    holds whole rows copies a full one (m = 256) as slots 64 j + 4 t ..
    64 j + 4 t + 3, one 16-byte store a step."""
    if whole_rows and m == 256:
        return [64 * j + 4 * t + i for j in range(4) for i in range(4)]
    return [min(t + 16 * j, m - 1) for j in range(steps)] if m > 0 else []


def _flush(ring: np.ndarray, out: np.ndarray, row0: int, rows: list, run: list, at: list,
           steps: int, whole_rows: bool = False) -> None:
    """flush_ring: rows two at a time, a half-warp each, m = min(run, 256 -
    at) slots of a row copied to positions at.. (_flush_slots); every slot
    written once, with one value."""
    for step in range(0, len(rows), 2):
        written = {}
        for r in rows[step:step + 2]:
            m = min(run[r], 256 - at[r])
            for t in range(16):
                for i in _flush_slots(t, m, steps, whole_rows):
                    val = ring[i * RING_STRIDE + r]
                    assert written.setdefault((r, at[r] + i), val) == val
            got = sorted(i for (rr, i) in written if rr == r)
            assert got == list(range(at[r], at[r] + max(m, 0)))
        for (r, pos), val in written.items():
            assert out[row0 + r, pos] == -1 and val >= 0
            out[row0 + r, pos] = val


def _ring_walk(cands: list, bound: int, last_slots: int | None = None, row_ring: bool = False):
    """warp_sampler.cuh's sample_rows over rows whose squeezed blocks hold
    ``cands[b]`` (rows, slots), a warp at a time, with candidates below
    ``bound`` accepted and only the first ``last_slots`` of the last block
    read (all of them by default): append_block into each lane's ring
    column, then flush_ring's two-row copies, 16 lanes a row, after each
    block, or with ``row_ring`` (a ring of 256 + 16 slots or more) blocks
    appended to one run a row, clamped every 16 candidates to slot slots -
    16, and copied once at the end of the pass.  Returns the output rows and
    the blocks each row permuted for in the first pass."""
    n, slots = cands[0].shape
    last_slots = slots if last_slots is None else last_slots
    assert row_ring == (slots >= 256 + 16)  # RowRing<C>
    clamp = slots - 16 if row_ring else None
    steps = -(-slots // 16)
    out = np.full((n, 256), -1, dtype=np.int64)
    used = np.zeros(n, dtype=np.int64)
    for row0 in range(0, n, WARP):
        rows = min(WARP, n - row0)
        cnt = [0 if lane < rows else 256 for lane in range(WARP)]
        for want_accepted in (True, False):
            in_pass = [r for r in range(WARP) if cnt[r] < 256]
            if not in_pass:
                break
            at = list(cnt)
            nxt = [0] * WARP
            ring = np.full(slots * RING_STRIDE, -1, dtype=np.int64)
            for b in range(len(cands)):
                todo = [r for r in range(WARP) if cnt[r] < 256]
                if not todo:
                    break
                for lane in todo:
                    used[row0 + lane] += want_accepted
                    nxt[lane] = _append_block(ring, lane, cands[b][row0 + lane], bound,
                                              want_accepted, b == len(cands) - 1, last_slots,
                                              nxt[lane], clamp)
                if row_ring:
                    cnt = [at[r] + nxt[r] for r in range(WARP)]
                else:
                    _flush(ring, out, row0, todo, nxt, cnt, steps)
                    cnt = [cnt[r] + nxt[r] for r in range(WARP)]
                    nxt = [0] * WARP
                    ring[:] = -1
            if row_ring:
                _flush(ring, out, row0, in_pass, nxt, at, steps, whole_rows=True)
    assert (out >= 0).all(), "a slot never written"
    return out, used


def _sample_ntt_walk(seeds: torch.Tensor, bound: int):
    """K2: sample_rows over SampleNttCands (4 blocks of 112 candidates)."""
    stream = keccak.sponge_plain(seeds, 168, 0x1F, 672).numpy()
    return _ring_walk([_block_candidates(stream[:, 168 * b:168 * (b + 1)]) for b in range(4)],
                      bound)


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
    """SampleNttCands::at(s, c) is the block's c-th 12-bit candidate: the two
    halves of each 3-byte triple, in order."""
    block = _seeds(5, 64, 168).numpy()
    t = block.astype(np.int64).reshape(64, 56, 3)
    want = np.stack([t[..., 0] | ((t[..., 1] & 0xF) << 8), (t[..., 1] >> 4) | (t[..., 2] << 4)],
                    axis=-1).reshape(64, 112)
    assert np.array_equal(_block_candidates(block), want)


@pytest.mark.parametrize("slots", [112, 56, 272])
def test_flush_copies_every_run_length_slot_by_slot(slots):
    """flush_ring for K2's, K5's and K6's rings, every run length m from 1
    to the ring: the 16 lanes copy exactly slots 0..m-1, lane t slot
    t + 16 j wherever that lies inside the run; K6's whole rows (m = 256)
    in 4 slots a lane a step, each slot once."""
    steps = -(-slots // 16)
    for m in range(1, slots + 1):
        copied = [_flush_slots(t, m, steps) for t in range(16)]
        assert set().union(*map(set, copied)) == set(range(m))
        assert all(lane[j] == t + 16 * j for t, lane in enumerate(copied)
                   for j in range(steps) if t + 16 * j < m)
    if slots >= 256 + 16:
        whole = [_flush_slots(t, 256, steps, whole_rows=True) for t in range(16)]
        assert sorted(sum(whole, [])) == list(range(256))


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
    """mulmod_lazy<q>: a * w - umulhi(a, w') * q mod 2^32, in [0, 2q)."""
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
    """mulmod_lazy<q> for every a below the NTT's bound 16q and every zeta,
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
# K4
# --------------------------------------------------------------------------


def _layout(f: np.ndarray) -> np.ndarray:
    """(rows, 256) coefficients -> stage-A registers (rows, 16 lanes, 16)."""
    regs = np.empty((f.shape[0], 16, 16), dtype=np.int64)
    for t in range(16):
        for j in range(16):
            regs[:, t, j] = f[:, mc.ntt_coefficient(0, t, j)]
    return regs


def _inv_layer(regs, h, w, w_shoup, bias):
    """ntt_layer<h, true>: a' = a + b, b' = w (b + M - a) up to one q, on
    inputs below the bias M."""
    assert (regs >= 0).all() and (regs < bias).all()
    for j in range(16):
        if j & h:
            continue
        s = mc.ntt_slot(h, j)
        a, b = regs[:, :, j].copy(), regs[:, :, j + h].copy()
        regs[:, :, j] = a + b
        regs[:, :, j + h] = _lazy_mul(b + bias - a, w[:, s], w_shoup[:, s])


def _k4_inverse(f: np.ndarray) -> np.ndarray:
    """kem_ntt_inverse on (rows, 256) canonical coefficients, from the
    inverse tables: stage B's layers h = 2, 4, 8 (biases q, 2q, 4q), the
    transpose, stage A's h = 1, 2, 4 (8q, 16q, 32q), then the last layer
    (64q) with 128^-1 folded in.  Layer k's inputs are asserted below
    2^(k-1) q, its outputs below 2^k q, and the last's canonical."""
    uni = mc.NTT_INV_UNIFORM.astype(np.int64)
    lanes = mc.NTT_INV_LANE_TABLE.astype(np.int64)
    regs = _relayout(_layout(f), 0, 1)
    bound = Q
    for h in (2, 4, 8):
        _inv_layer(regs, h, lanes[0].T, lanes[1].T, bound)
        bound *= 2
        assert (regs < bound).all()
    regs = _relayout(regs, 1, 0)
    aw = (np.broadcast_to(uni[0, :15], (16, 15)), np.broadcast_to(uni[1, :15], (16, 15)))
    for h in (1, 2, 4):
        _inv_layer(regs, h, aw[0], aw[1], bound)
        bound *= 2
        assert (regs < bound).all()
    assert bound == 64 * Q and 2 * bound < 1 << 19
    for j in range(8):
        a, b = regs[:, :, j].copy(), regs[:, :, j + 8].copy()
        assert (a < bound).all() and (b < bound).all()
        for dst, x, slot in ((j, a + b, 15), (j + 8, b + bound - a, 0)):
            r = _lazy_mul(x, uni[0, slot], uni[1, slot])
            regs[:, :, dst] = np.minimum(r, (r - Q) & M32)
    assert (regs < Q).all()
    return _unlayout(regs)


def _k4_inputs(seed: int) -> np.ndarray:
    """Random canonical rows, rows of 0 and of q - 1, and rows of q - 1
    and 0 in runs of 2..128 coefficients, which put one layer's lazy values
    at their worst each (the runs of 128: the last layer's a - b at -64q +
    64, which a bias of 32q would wrap)."""
    rng = np.random.default_rng(seed)
    i = np.arange(256)
    stripes = [np.where((i // run) % 2 == side, Q - 1, 0)
               for run in (2, 4, 8, 16, 32, 64, 128) for side in (0, 1)]
    return np.concatenate([rng.integers(0, Q, size=(6, 256)), np.zeros((1, 256), np.int64),
                           np.full((1, 256), Q - 1), np.stack(stripes)])


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_schedule_matches_ntt_plain_and_ntt_inv_plain_within_its_bounds(seed):
    """K4 = kem_ntt_forward / kem_ntt_inverse on coefficients loaded from
    memory, with the tables the wrapper uploads, both directions."""
    f = _k4_inputs(seed)
    t = torch.from_numpy(f.astype(np.int32))
    assert np.array_equal(_unlayout(_fused_ntt(_layout(f))), mlkem.ntt_plain(t).numpy())
    assert np.array_equal(_k4_inverse(f), mlkem.ntt_inv_plain(t).numpy())


def test_k4_inverse_needs_the_last_layers_full_bias():
    """The striped rows of runs of 128 drive b - a to -(64q - 64) at the
    last layer: its bias 64q keeps b + M - a positive, half of it would
    not."""
    f = _k4_inputs(0)[-2:]  # runs of 128, both phases
    regs = _relayout(_layout(f), 0, 1)
    uni, lanes = mc.NTT_INV_UNIFORM.astype(np.int64), mc.NTT_INV_LANE_TABLE.astype(np.int64)
    bound = Q
    for h in (2, 4, 8):
        _inv_layer(regs, h, lanes[0].T, lanes[1].T, bound)
        bound *= 2
    regs = _relayout(regs, 1, 0)
    for h in (1, 2, 4):
        _inv_layer(regs, h, np.broadcast_to(uni[0, :15], (16, 15)),
                   np.broadcast_to(uni[1, :15], (16, 15)), bound)
        bound *= 2
    gap = (regs[:, :, :8] - regs[:, :, 8:]).max()
    assert gap == 64 * (Q - 1) and 32 * Q < gap < bound


def test_k4_inverse_tables_hold_the_zetas_with_128_inverse_folded_in():
    """Stage A's slot 0 (the length-128 layer) holds zeta 128^-1, slot 15
    128^-1 = 3303, slots 1-14 the plain zetas; stage B's every (slot, lane)
    its plain zeta; each beside its Shoup companion; the forward tables as
    K3 uploads them."""
    z = np.asarray(ZETAS, dtype=np.int64)
    uni, lanes = mc.NTT_INV_UNIFORM.astype(np.int64), mc.NTT_INV_LANE_TABLE.astype(np.int64)
    idx_a = mc.NTT_INV_ZETA_INDEX_A
    assert N_INV == 3303 and 128 * N_INV % Q == 1
    assert uni[0, 0] == z[idx_a[0]] * N_INV % Q and idx_a[0] == 1
    assert np.array_equal(uni[0, 1:15], z[idx_a[1:]]) and uni[0, 15] == N_INV
    assert np.array_equal(lanes[0], z[mc.NTT_INV_ZETA_INDEX_B])
    for table in (uni, lanes):
        assert np.array_equal(table[1], (table[0] << 32) // Q)
    init_uni, init_lanes = mc._INIT_UNIFORM, mc._INIT_LANES
    assert init_uni.shape == (2, 2, 16) and init_lanes.shape == (2, 2, 7, 16)
    assert np.array_equal(init_uni[0], mc.NTT_UNIFORM) and np.array_equal(init_uni[1],
                                                                          mc.NTT_INV_UNIFORM)
    assert np.array_equal(init_lanes[0], mc.NTT_LANE_TABLE)
    assert np.array_equal(init_lanes[1], mc.NTT_INV_LANE_TABLE)


@pytest.mark.parametrize("stage", [0, 1], ids=["A", "B"])
def test_k4_inverse_layers_take_the_plain_inverse_zetas(stage):
    """Every butterfly of an inverse layer pairs the plain layer's two
    coefficients inside one lane, and its slot names the zeta the plain
    inverse takes for its group: 2 * groups - 1 - g."""
    for h in mc.NTT_HALVES[stage]:
        length = h * (16 if stage == 0 else 1)
        groups = 256 // (2 * length)
        pairs = set()
        for t in range(16):
            for j in range(16):
                if j & h:
                    continue
                i0 = mc.ntt_coefficient(stage, t, j)
                pairs.add((i0, mc.ntt_coefficient(stage, t, j + h)))
                s = mc.ntt_slot(h, j)
                k = mc.NTT_INV_ZETA_INDEX_A[s] if stage == 0 else mc.NTT_INV_ZETA_INDEX_B[s, t]
                assert k == 2 * groups - 1 - i0 // (2 * length)
        assert pairs == {(g * 2 * length + i, g * 2 * length + i + length)
                         for g in range(groups) for i in range(length)}


# --------------------------------------------------------------------------
# K5 (ML-DSA RejNTTPoly on K2's ring)
# --------------------------------------------------------------------------


K5_SLOTS = 56


def _k5_candidates(block: np.ndarray) -> np.ndarray:
    """RejNttCands::at: (rows, 168) squeezed bytes -> (rows, 56), candidate
    c from bits [24 c, 24 c + 23) of the 64-bit lanes (the ones at bit 48
    and 56 of a lane from two lanes)."""
    lanes = np.ascontiguousarray(block).view("<u8")
    out = np.empty((block.shape[0], K5_SLOTS), dtype=np.int64)
    for c in range(K5_SLOTS):
        w, sh = (24 * c) >> 6, (24 * c) & 63
        v = lanes[:, w] >> np.uint64(sh)
        if sh > 40:
            v = v | (lanes[:, w + 1] << np.uint64(64 - sh))
        out[:, c] = (v & np.uint64(0x7FFFFF)).astype(np.int64)
    return out


def _k5_walk(seeds: torch.Tensor, bound: int):
    """K5: sample_rows over RejNttCands (7 blocks of 56 candidates)."""
    stream = keccak.sponge_plain(seeds, 168, 0x1F, 1176).numpy()
    return _ring_walk([_k5_candidates(stream[:, 168 * b:168 * (b + 1)]) for b in range(7)],
                      bound)


def test_k5_block_candidates_are_the_blocks_triples_in_order():
    block = _seeds(6, 64, 168).numpy()
    t = block.astype(np.int64).reshape(64, 56, 3)
    want = t[..., 0] | (t[..., 1] << 8) | ((t[..., 2] & 0x7F) << 16)
    assert np.array_equal(_k5_candidates(block), want)
    assert {(24 * c) & 63 for c in range(K5_SLOTS) if (24 * c) & 63 > 40} == {48, 56}


def test_k5_compaction_matches_rej_ntt_poly_plain():
    """A ragged last warp; every row squeezes 5 blocks (224 candidates in
    4), and at q / 2^23 none needs a 6th."""
    seeds = _seeds(40, 3 * WARP + 9, 34)
    got, used = _k5_walk(seeds, mldsa.Q)
    assert np.array_equal(got, mldsa.rej_ntt_poly_plain(seeds).numpy())
    assert (used == 5).all()


@pytest.mark.parametrize("bound", [7_600_000, 6_000_000, 5_000_000, 2_000_000])
def test_k5_later_blocks_and_short_fill_keep_the_reference_order(bound):
    """A lowered acceptance bound sends rows to the 6th block (7,600,000:
    most rows), to the 7th (6,000,000: most rows) and to the short fill of
    rejected candidates (5,000,000: most rows; 2,000,000: all), against the
    plain in-order compaction at that bound."""
    seeds = _seeds(bound % 1009, 2 * WARP + 11, 34)
    got, used = _k5_walk(seeds, bound)
    buf = keccak.sponge_plain(seeds, 168, 0x1F, 1176).to(torch.int64).reshape(len(seeds), -1, 3)
    cand = buf[..., 0] | (buf[..., 1] << 8) | ((buf[..., 2] & 0x7F) << 16)
    assert np.array_equal(got, keccak.compact_accepted(cand, cand < bound).numpy())
    short = ((cand < bound).sum(-1) < 256).numpy()
    assert (used >= 5).all() and (used[short] == 7).all()
    most = {7_600_000: (used == 6) & ~short, 6_000_000: (used == 7) & ~short,
            5_000_000: short, 2_000_000: short}[bound]
    assert most.sum() > len(seeds) // 2 and (bound > 2_000_000 or short.all())


def test_k5_ring_reads_hit_16_banks_a_half_warp():
    """flush_ring over uint32 slots: a half-warp reads slot t + 16 j of row
    r at word 33 (t + 16 j) + r, 16 consecutive banks; four steps cover the
    56 slots."""
    for r in range(WARP):
        for j in range(-(-K5_SLOTS // 16)):
            banks = [(RING_STRIDE * (t + 16 * j) + r) % 32 for t in range(16)]
            assert len(set(banks)) == 16 and banks == [(banks[0] + t) % 32 for t in range(16)]
    assert -(-K5_SLOTS // 16) == 4 and 16 * 4 >= K5_SLOTS


# --------------------------------------------------------------------------
# K6 (ML-DSA RejBoundedPoly on K2's ring)
# --------------------------------------------------------------------------


K6_SLOTS, K6_LAST_SLOTS = 272, 208  # nibbles of a 136-byte block, of the 4th's first 104 bytes


def _k6_candidates(block: np.ndarray) -> np.ndarray:
    """RejBoundedCands::at: (rows, 136) squeezed bytes -> (rows, 272), nibble
    c from bits [4 c, 4 c + 4) of the 64-bit lanes."""
    lanes = np.ascontiguousarray(block).view("<u8")
    out = np.empty((block.shape[0], K6_SLOTS), dtype=np.int64)
    for c in range(K6_SLOTS):
        out[:, c] = ((lanes[:, c >> 4] >> np.uint64(4 * (c & 15))) & np.uint64(0xF)).astype(np.int64)
    return out


def _k6_walk(seeds: torch.Tensor, bound: int, last_slots: int = K6_LAST_SLOTS):
    """K6: sample_rows over RejBoundedCands (4 blocks of 272 nibbles, the
    4th read to nibble 1023 of the row)."""
    stream = keccak.sponge_plain(seeds, 136, 0x1F, 4 * 136).numpy()
    return _ring_walk([_k6_candidates(stream[:, 136 * b:136 * (b + 1)]) for b in range(4)],
                      bound, last_slots, row_ring=True)


def _k6_reference(seeds: torch.Tensor, bound: int) -> np.ndarray:
    """The reference's order stated directly: the 1024 nibbles of the first
    512 squeezed bytes (low nibble first), those below `bound` before the
    rest, index order within each, the first 256."""
    b = keccak.sponge_plain(seeds, 136, 0x1F, 512).numpy().astype(np.int64)
    z = np.stack([b & 0xF, b >> 4], axis=-1).reshape(len(seeds), 1024)
    order = np.argsort(z >= bound, axis=-1, kind="stable")
    return np.take_along_axis(z, order, axis=-1)[:, :256]


def test_k6_block_candidates_are_the_blocks_nibbles_in_order():
    block = _seeds(7, 64, 136).numpy()
    b = block.astype(np.int64)
    want = np.stack([b & 0xF, b >> 4], axis=-1).reshape(64, K6_SLOTS)
    assert np.array_equal(_k6_candidates(block), want)
    assert 3 * K6_SLOTS + K6_LAST_SLOTS == 1024


@pytest.mark.parametrize("eta", [2, 4])
def test_k6_compaction_matches_rej_bounded_poly_plain(eta):
    """A ragged last warp at eta's own bound (15 or 9): every row squeezes
    one or two blocks (eta 4 accepts 9 of 16 nibbles, so most rows take
    two; eta 2 accepts 15 of 16, so many take one)."""
    seeds = _seeds(60 + eta, 3 * WARP + 9, 66)
    bound = 15 if eta == 2 else 9
    got, used = _k6_walk(seeds, bound)
    assert np.array_equal(got, mldsa.rej_bounded_poly_plain(seeds, eta).numpy())
    assert np.array_equal(got, _k6_reference(seeds, bound))
    assert set(used) <= {1, 2} and (used == 2).any()
    assert (used == 1).any() or eta == 4


@pytest.mark.parametrize("bound", [6, 5, 4, 2])
def test_k6_later_blocks_and_short_fill_keep_the_reference_order(bound):
    """A lowered acceptance bound sends rows to the 3rd block (6: most
    rows), to the 4th (5: most rows) and to the short fill of rejected
    nibbles (4: about half the rows; 2: all), against the reference's order
    stated directly and the plain in-order compaction at that bound."""
    seeds = _seeds(bound + 100, 2 * WARP + 11, 66)
    got, used = _k6_walk(seeds, bound)
    want = _k6_reference(seeds, bound)
    assert np.array_equal(got, want)
    b = keccak.sponge_plain(seeds, 136, 0x1F, 512).to(torch.int64)
    z = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(len(seeds), -1)
    assert np.array_equal(want, keccak.compact_accepted(z, z < bound).numpy())
    short = ((z < bound).sum(-1) < 256).numpy()
    assert (used[short] == 4).all()
    most = {6: (used == 3) & ~short, 5: (used == 4) & ~short, 4: short, 2: short}[bound]
    assert most.sum() > len(seeds) // 3 and (bound > 2 or short.all())


@pytest.mark.parametrize("bound", [4, 2])
def test_k6_fourth_block_stops_at_nibble_1023(bound):
    """Short rows read the whole 4th block in the first pass: the walk that
    stops at its nibble 208 (the row's 1023rd) gives the reference on every
    row, one that reads on to 272 appends nibbles from past the 512 bytes
    and differs from it on exactly the short rows."""
    seeds = _seeds(bound + 200, 2 * WARP, 66)
    got, used = _k6_walk(seeds, bound)
    past, _ = _k6_walk(seeds, bound, last_slots=K6_SLOTS)
    want = _k6_reference(seeds, bound)
    short = (used == 4) & (want >= bound).any(-1)
    assert np.array_equal(got, want) and short.any()
    differs = (past != want).any(-1)
    assert np.array_equal(differs, short)


@pytest.mark.parametrize("want_accepted", [True, False])
def test_k6_last_block_append_wants_nothing_past_nibble_1023(want_accepted):
    """append_block in either pass, on a 4th block whose every nibble is
    wanted: only the first 208 count, and the ring column holds them in
    order; a block before the last counts all 272."""
    value = 0 if want_accepted else 15
    cands = np.full(K6_SLOTS, value, dtype=np.int64)
    for last, count in ((True, K6_LAST_SLOTS), (False, K6_SLOTS)):
        ring = np.full(K6_SLOTS * RING_STRIDE, -1, dtype=np.int64)
        k = _append_block(ring, 5, cands, 9, want_accepted, last, K6_LAST_SLOTS)
        assert k == count
        assert (ring[5 + RING_STRIDE * np.arange(count)] == value).all()


@pytest.mark.parametrize("first", [0, 100, 250, 255])
def test_k6_row_ring_clamp_keeps_the_first_256_slots(first):
    """K6's ring holds a row's whole run (256 + 16 slots): appending a block
    whose every nibble is wanted from slot `first` on fills slots first..255
    with its nibbles in order, never stores past slot 271, and ends past
    slot 255, so the row counts as full."""
    cands = np.arange(K6_SLOTS, dtype=np.int64) % 9  # all accepted at bound 9
    ring = np.full(K6_SLOTS * RING_STRIDE, -1, dtype=np.int64)
    nxt = _append_block(ring, 3, cands, 9, True, False, K6_LAST_SLOTS, first, K6_SLOTS - 16)
    assert 256 <= nxt <= K6_SLOTS
    assert np.array_equal(ring[3 + RING_STRIDE * np.arange(first, 256)], cands[:256 - first])
    assert (ring.reshape(K6_SLOTS, RING_STRIDE)[:, 3] >= 0).sum() == K6_SLOTS - first


def test_k6_ring_reads_hit_16_banks_a_half_warp():
    """flush_ring over uint8 slots: a half-warp reads slot t + 16 j of row r
    at byte 33 (t + 16 j) + r, i.e. word (33 (t + 16 j) + r) // 4: t and
    t + 4 are 33 words apart, so 16 distinct banks; 17 steps cover the 272
    slots.  A whole row's copy reads slot 64 j + 4 t + i, again 16 banks a
    half-warp.  The ring is 8,976 bytes a warp (17,952 with uint16 slots)."""
    for r in range(WARP):
        for j in range(-(-K6_SLOTS // 16)):
            banks = {((RING_STRIDE * (t + 16 * j) + r) // 4) % 32 for t in range(16)}
            assert len(banks) == 16
        for j, i in ((j, i) for j in range(4) for i in range(4)):  # a whole row, 4 slots a lane
            banks = {((RING_STRIDE * (64 * j + 4 * t + i) + r) // 4) % 32 for t in range(16)}
            assert len(banks) == 16
    assert -(-K6_SLOTS // 16) == 17 and K6_SLOTS * RING_STRIDE == 8976


def test_k6_traits_in_the_source_match_the_walk():
    """RejBoundedCands in csrc/mldsa.cuh: uint8 slots, 272 a block, 208 in
    the 4th of 4, rate 136, 66-byte seeds, bounds 15 and 9."""
    src = (CSRC / "mldsa.cuh").read_text()
    body = src[src.index("struct RejBoundedCands"):]
    body = body[:body.index("};")]
    for pattern in (r"using Value = uint8_t;", r"kSlots = 2 \* 136;",
                    r"kLastSlots = 2 \* \(512 - 3 \* 136\);", r"kBlocks = 4;",
                    r"kRate = 136;", r"kSeedLen = 66;", r"kBound = ETA == 2 \? 15 : 9;"):
        assert re.search(pattern, body), pattern


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
