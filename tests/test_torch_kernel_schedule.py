"""The schedules of kernels K7 (NTT mod 8380417) and K1's split path
(a Keccak sponge over five lanes of a warp), held to the plain versions on
the CPU.

The CUDA kernels cannot run here, but the tables they load
(``sig/mldsa_cuda.py``: ``NTT_ZETA_INDEX``, ``NTT_UNIFORM``,
``NTT_LANE_TABLE``; ``core/keccak_cuda.py``: ``split_table``) and the
layouts they assume can.  Each test walks the kernel's steps in numpy, lane
by lane and register by register as ``csrc/ntt_halfwarp.cuh``,
``csrc/mldsa.cuh`` and ``csrc/sponge.cu`` do (lazy butterflies with their 32-bit wraps, the
shared-memory transposes, the shuffles of the split permutation), on seeded
inputs, and compares with ``ntt_plain`` / ``ntt_inv_plain`` /
``keccak_f1600``.  It imports no jax.
"""

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu_torch.core import keccak, keccak_cuda
from quantum_resistant_p2p_tpu_torch.sig import mldsa, mldsa_cuda as mc
from quantum_resistant_p2p_tpu_torch.sig.params import ZETAS

Q = mldsa.Q
M32 = (1 << 32) - 1


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------


def _lazy_mul(a, w, w_shoup):
    """mulmod_lazy<q>: a * w - umulhi(a, w') * q mod 2^32, in [0, 2q)."""
    r = (a * w - ((a * w_shoup) >> 32) * Q) & M32
    assert (r < 2 * Q).all()
    return r


def _no_wrap(x):
    assert (x >= 0).all() and (x <= M32).all(), "a lazy sum left 32 bits"
    return x


def _layer(regs, h, inverse, w, w_shoup, bias):
    """ntt_layer<h>: regs (P, 16 lanes, 16 regs) int64, w / w_shoup (16
    lanes, 15 slots)."""
    for j in range(mc.NTT_REGS):
        if j & h:
            continue
        s = mc.ntt_slot(h, j)
        a, b = regs[:, :, j].copy(), regs[:, :, j + h].copy()
        if not inverse:
            t = _lazy_mul(b, w[:, s], w_shoup[:, s])
            regs[:, :, j + h] = _no_wrap(a + 2 * Q - t)
            regs[:, :, j] = _no_wrap(a + t)
        else:
            regs[:, :, j] = _no_wrap(a + b)
            regs[:, :, j + h] = _lazy_mul(_no_wrap(b + bias - a), w[:, s], w_shoup[:, s])


def _relayout(regs, src_stage, dst_stage):
    """A transpose: registers of ``src_stage``'s layout to ``dst_stage``'s,
    through the coefficient order."""
    coeff = np.empty((regs.shape[0], mldsa.N), dtype=np.int64)
    out = np.empty_like(regs)
    for t in range(mc.NTT_LANES):
        for j in range(mc.NTT_REGS):
            coeff[:, mc.ntt_coefficient(src_stage, t, j)] = regs[:, t, j]
    for t in range(mc.NTT_LANES):
        for j in range(mc.NTT_REGS):
            out[:, t, j] = coeff[:, mc.ntt_coefficient(dst_stage, t, j)]
    return out


def _tables(inverse):
    uni, lanes = mc.NTT_UNIFORM[inverse].astype(np.int64), mc.NTT_LANE_TABLE[inverse]
    a = (np.broadcast_to(uni[0, :15], (16, 15)), np.broadcast_to(uni[1, :15], (16, 15)))
    b = (lanes[0].T.astype(np.int64), lanes[1].T.astype(np.int64))
    return a, b, int(uni[0, 15]), int(uni[1, 15])


def _k7(f: np.ndarray, inverse: bool) -> np.ndarray:
    """ntt_kernel<INVERSE> on (P, 256) canonical coefficients."""
    (aw, aws), (bw, bws), ninv, ninv_shoup = _tables(int(inverse))
    regs = np.empty((f.shape[0], 16, 16), dtype=np.int64)
    for t in range(16):
        for j in range(16):
            regs[:, t, j] = f[:, mc.ntt_coefficient(0, t, j)]
    if not inverse:
        for h in mc.NTT_HALVES:
            _layer(regs, h, False, aw, aws, 0)
        regs = _relayout(regs, 0, 1)
        for h in mc.NTT_HALVES:
            _layer(regs, h, False, bw, bws, 0)
        assert (regs < 17 * Q).all()
        r = (regs - (regs >> 23) * Q) & M32
        regs = np.minimum(r, (r - Q) & M32)
        regs = _relayout(regs, 1, 0)
    else:
        regs = _relayout(regs, 0, 1)
        for k, h in enumerate(reversed(mc.NTT_HALVES)):
            _layer(regs, h, True, bw, bws, Q << k)
        regs = _relayout(regs, 1, 0)
        for k, h in enumerate((1, 2, 4)):
            _layer(regs, h, True, aw, aws, (16 * Q) << k)
        for j in range(8):
            a, b = regs[:, :, j].copy(), regs[:, :, j + 8].copy()
            for dst, x, w, ws in ((j, a + b, ninv, ninv_shoup),
                                  (j + 8, b + 128 * Q - a, aw[:, 0], aws[:, 0])):
                r = _lazy_mul(_no_wrap(x), w, ws)
                regs[:, :, dst] = np.minimum(r, (r - Q) & M32)
    out = np.empty_like(f, dtype=np.int64)
    for t in range(16):
        for j in range(16):
            out[:, mc.ntt_coefficient(0, t, j)] = regs[:, t, j]
    return out


def _inputs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.integers(0, Q, size=(6, mldsa.N), dtype=np.int64)
    f[0], f[1] = 0, Q - 1  # the extremes, whole polynomials
    f[2, ::2] = Q - 1      # and mixed with random coefficients
    f[3, 1::3] = 0
    return f


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k7_schedule_matches_the_plain_transform(seed, inverse):
    f = _inputs(seed)
    plain = mldsa.ntt_inv_plain if inverse else mldsa.ntt_plain
    want = plain(torch.from_numpy(f.astype(np.int32))).numpy()
    assert np.array_equal(_k7(f, inverse), want)


def test_k7_lane_maps_cover_every_coefficient_once():
    for stage in (0, 1):
        got = sorted(mc.ntt_coefficient(stage, t, j) for t in range(16) for j in range(16))
        assert got == list(range(mldsa.N))


@pytest.mark.parametrize("stage", [0, 1], ids=["A", "B"])
def test_k7_each_layer_pairs_the_plain_butterflies_inside_one_lane(stage):
    """K7 has no shuffle partners: every butterfly of the stage's layers
    pairs two registers of one lane, exactly the plain layer's pairs, and
    its slot names the plain layer's zeta."""
    for h in mc.NTT_HALVES:
        length = h * (16 if stage == 0 else 1)
        plain_pairs = {(g * 2 * length + i, g * 2 * length + i + length)
                       for g in range(mldsa.N // (2 * length)) for i in range(length)}
        pairs, zetas = set(), {}
        for t in range(16):
            for j in range(16):
                if j & h:
                    continue
                i0, i1 = mc.ntt_coefficient(stage, t, j), mc.ntt_coefficient(stage, t, j + h)
                pairs.add((i0, i1))
                for inverse in (0, 1):
                    zetas[(inverse, i0)] = mc.NTT_ZETA_INDEX[inverse, stage, mc.ntt_slot(h, j), t]
        assert pairs == plain_pairs
        groups = mldsa.N // (2 * length)
        for (inverse, i0), k in zetas.items():
            g = i0 // (2 * length)
            assert k == (2 * groups - 1 - g if inverse else groups + g)


def test_k7_tables_hold_the_zetas_and_their_shoup_companions():
    z = np.asarray(ZETAS, dtype=np.int64)
    for d in (0, 1):
        lanes = mc.NTT_LANE_TABLE[d].astype(np.int64)
        assert np.array_equal(lanes[0], z[mc.NTT_ZETA_INDEX[d, 1]])
        uni = mc.NTT_UNIFORM[d].astype(np.int64)
        for table in (lanes, uni):
            assert np.array_equal(table[1], (table[0] << 32) // Q)
    ninv = pow(mldsa.N, -1, Q)
    assert mc.NTT_UNIFORM[1, 0, 15] == ninv
    assert mc.NTT_UNIFORM[1, 0, 0] == z[mc.NTT_ZETA_INDEX[1, 0, 0, 0]] * ninv % Q
    assert np.array_equal(mc.NTT_UNIFORM[0, 0, :15], z[mc.NTT_ZETA_INDEX[0, 0, :, 0]])


def _banks_distinct(words, group):
    """Shared-memory banks of one warp access, ``group`` threads a
    wavefront (32 for 4-byte accesses, 8 for 16-byte ones)."""
    for lo in range(0, 32, group):
        banks = [b % 32 for w in words[lo:lo + group] for b in range(w, w + 128 // (4 * group))]
        if len(set(banks)) != len(banks):
            return False
    return True


def test_k7_transposes_are_bank_conflict_free():
    """csrc/ntt_halfwarp.cuh: coefficient i at word i + 4 (i // 16); the second
    half-warp's buffer starts 336 words on."""
    def word(half, i):
        return 336 * half + i + 4 * (i // 16)

    lanes = [(lane >> 4, lane & 15) for lane in range(32)]
    for j in range(16):  # stage A: one 4-byte access a register
        words = [word(h, mc.ntt_coefficient(0, t, j)) for h, t in lanes]
        assert words == [336 * h + t + 20 * j for h, t in lanes]
        assert _banks_distinct(words, 32)
    for m in range(4):  # stage B: four 16-byte vectors a lane
        words = [word(h, mc.ntt_coefficient(1, t, 4 * m)) for h, t in lanes]
        assert words == [336 * h + 20 * t + 4 * m for h, t in lanes]
        assert all(w % 4 == 0 for w in words)
        assert _banks_distinct(words, 8)


# --------------------------------------------------------------------------
# K1, split path
# --------------------------------------------------------------------------

TABLE = keccak_cuda.split_table()


def _rotl(x, n):
    n = np.asarray(n, dtype=np.uint64)
    return (x << n) | (x >> ((np.uint64(64) - n) % np.uint64(64)))


def _split_f1600(lanes: np.ndarray) -> np.ndarray:
    """split_f1600 on (S, 25) uint64 states: group lane p keeps a[p][y] =
    lane p + 5y, and everything it reads from another lane goes through the
    table's sources and buffer slots."""
    rho = TABLE[:, 0:5].astype(np.uint64)
    pi_src, theta = TABLE[:, 5:10], TABLE[:, 10:12]
    wr, rd = TABLE[:, 12:17], TABLE[:, 17:22]
    a = np.stack([lanes[:, [p + 5 * y for y in range(5)]] for p in range(5)], axis=1)
    for r in range(24):
        c = np.bitwise_xor.reduce(a, axis=2)  # (S, 5): each lane's own column
        d = c[:, theta[:, 0]] ^ _rotl(c[:, theta[:, 1]], 1)
        a = _rotl(a ^ d[:, :, None], rho[None])
        b = np.stack([a[:, pi_src[:, k], k] for k in range(5)], axis=2)  # b[:, p, k]
        e = b ^ (~np.roll(b, -1, axis=2) & np.roll(b, -2, axis=2))
        e[:, 0, 0] ^= np.uint64(keccak.RC[r] & ((1 << 64) - 1))
        buf = np.zeros((lanes.shape[0], 25), dtype=np.uint64)
        for p in range(5):
            buf[:, wr[p]] = e[:, p]
        a = np.stack([buf[:, rd[p]] for p in range(5)], axis=1)
    out = np.empty_like(lanes)
    for p in range(5):
        out[:, [p + 5 * y for y in range(5)]] = a[:, p]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_permutation_matches_the_plain_one(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**63, size=(8, 25), dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, size=(8, 25), dtype=np.uint64)
    s[0] = 0
    s[1] = np.uint64((1 << 64) - 1)
    want = keccak.keccak_f1600(torch.from_numpy(s.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(_split_f1600(s), want)


def test_split_lane_ownership_and_rho_amounts():
    """Column layout: lane p's slot y is state lane (p, y); row layout
    (after pi): its slot x is (x, p).  Each is a bijection, and each slot's
    rotation is rho of the state lane it holds."""
    column = {(p, y): p + 5 * y for p in range(5) for y in range(5)}
    row = {(p, x): x + 5 * p for p in range(5) for x in range(5)}
    assert sorted(column.values()) == sorted(row.values()) == list(range(25))
    for p in range(5):
        assert [TABLE[p, y] for y in range(5)] == [keccak.RHO[column[p, y]] for y in range(5)]
        assert list(TABLE[p, 12:17]) == [row[p, x] for x in range(5)]
        assert list(TABLE[p, 17:22]) == [column[p, y] for y in range(5)]


def test_split_pi_sources_and_theta_neighbours():
    """Step k of pi: lane p pulls slot k (state lane (s, k)) from group
    lane s, and that lane lands at (k, p), which plain pi says; theta reads
    C[p - 1] and C[p + 1]."""
    for p in range(5):
        for k in range(5):
            s = TABLE[p, 5 + k]
            assert keccak.PI_SRC[k + 5 * p] == s + 5 * k
        assert list(TABLE[p, 10:12]) == [(p - 1) % 5, (p + 1) % 5]
    for k in range(5):  # each step is a permutation of the group
        assert sorted(TABLE[:, 5 + k]) == list(range(5))


def test_split_chi_reads_one_row():
    """chi of row slot x reads slots x + 1 and x + 2 of the same lane: the
    lanes of one plane y, as plain chi does."""
    for p in range(5):
        for x in range(5):
            own = TABLE[p, 12 + x]
            for dx in (1, 2):
                other = TABLE[p, 12 + (x + dx) % 5]
                assert other // 5 == own // 5 and other % 5 == (own % 5 + dx) % 5
