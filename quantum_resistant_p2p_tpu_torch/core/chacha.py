"""Batched RFC 8439 ChaCha20-Poly1305 in PyTorch: the data plane.

Counterpart of ``quantum_resistant_p2p_tpu/core/chacha_pallas.py``.  The
ChaCha20 block function runs where its input lies: on a CUDA tensor it is
one launch of kernel K8 (``chacha_cuda.chacha_blocks``, ``csrc/chacha.cu``)
for every block of a seal or open batch; on a CPU tensor it runs
:func:`chacha_blocks_plain`, the plain version the tests hold to the JAX
package and to the RFC vectors.  Poly1305 is PyTorch code on either device
(as it was jnp in the reference, not a kernel).

torch has no unsigned 32-bit arithmetic on the CPU, so 32-bit words are
held in int64 tensors and masked back to 32 bits after every add and shift.
Kernel operands are int32 tensors holding the words' bits.

Poly1305 keeps the 130-bit accumulator as five 26-bit limbs in int64 (the
reference used twelve 11-bit limbs in uint32).  Bounds, which the limb
width is chosen for: limbs stay below 2^26 + 2^11 between blocks; adding a
block (limbs < 2^26, the pad bit 2^24 in the top limb) gives < 2^27.01;
each product column is five products of that by 5 * r_limb < 2^28.33, so
< 2^57.7, far inside int64; two parallel carry passes (the carry out of the
top limb folded back into limb 0 times 5, as 2^130 = 5 mod 2^130 - 5)
restore the invariant.  A block whose ``active`` bit is False leaves the
accumulator untouched, which is how one batch carries messages of many
lengths.
"""

from __future__ import annotations

import torch

from . import chacha_cuda

M32 = 0xFFFFFFFF
#: ChaCha20 constants "expa" "nd 3" "2-by" "te k" (RFC 8439 §2.3)
_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
#: column then diagonal quarter rounds (§2.3 inner_block)
_QR_SCHEDULE = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)
#: Poly1305 r clamp (§2.5): top 4 bits of bytes 3/7/11/15 and bottom 2 of
#: bytes 4/8/12 cleared
_R_CLAMP = (255, 255, 255, 15, 252, 255, 255, 15,
            252, 255, 255, 15, 252, 255, 255, 15)
_RADIX = 26
_LMASK = (1 << _RADIX) - 1


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensors of the same bits."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate 32-bit words (in int64, < 2^32) left by ``n``."""
    return ((x << n) & M32) | (x >> (32 - n))


def _double_round(x: list) -> list:
    """One column + diagonal double round over 16 word tensors; adds wrap
    mod 2^32 (RFC 8439 §2.1)."""
    x = list(x)
    for a, b, c, d in _QR_SCHEDULE:
        xa, xb, xc, xd = x[a], x[b], x[c], x[d]
        xa = (xa + xb) & M32
        xd = _rotl(xd ^ xa, 16)
        xc = (xc + xd) & M32
        xb = _rotl(xb ^ xc, 12)
        xa = (xa + xb) & M32
        xd = _rotl(xd ^ xa, 8)
        xc = (xc + xd) & M32
        xb = _rotl(xb ^ xc, 7)
        x[a], x[b], x[c], x[d] = xa, xb, xc, xd
    return x


def chacha_blocks_plain(states: torch.Tensor) -> torch.Tensor:
    """The plain block function: ``(N, 12)`` int32 (8 key words, the block
    counter, 3 nonce words) -> ``(N, 16)`` int32, the 20-round state plus
    the feedforward, in the order RFC 8439 serializes it."""
    w = states.to(torch.int64) & M32
    init = [torch.full_like(w[:, 0], c) for c in _CONSTS] + [w[:, i] for i in range(12)]
    x = init
    for _ in range(10):
        x = _double_round(x)
    return _to_int32(torch.stack([(x[i] + init[i]) & M32 for i in range(16)], dim=1))


def chacha_blocks(states: torch.Tensor) -> torch.Tensor:
    """``(N, 12)`` int32 block inputs -> ``(N, 16)`` int32 blocks.  CPU
    tensors take the plain version; any other device goes to kernel K8,
    which raises unless the tensor is on a CUDA device."""
    if states.device.type == "cpu":
        return chacha_blocks_plain(states)
    return chacha_cuda.chacha_blocks(states)


def _le_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 4k) uint8 -> (..., k) int64 little-endian 32-bit words."""
    w = b.to(torch.int64).reshape(b.shape[:-1] + (-1, 4))
    return w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)


def _words_to_u8(w: torch.Tensor) -> torch.Tensor:
    """(..., k) 32-bit words (any integer type) -> (..., 4k) uint8 little-endian."""
    w = w.to(torch.int64)
    b = torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF], dim=-1)
    return b.reshape(w.shape[:-1] + (-1,)).to(torch.uint8)


def _le64(n: torch.Tensor) -> torch.Tensor:
    """(B,) lengths (< 2^31) -> (B, 8) uint8 little-endian."""
    return _words_to_u8(torch.stack([n.to(torch.int64), torch.zeros_like(n, dtype=torch.int64)],
                                    dim=-1))


def _limbs(w: torch.Tensor, hibit) -> torch.Tensor:
    """(..., 4) words of one 16-byte block -> (..., 5) 26-bit limbs, plus
    ``hibit`` (0, 1 or a tensor of them) times 2^128, bit 24 of the top
    limb: the pad bit of a full message block (§2.5.1)."""
    limbs = [w[..., 0] & _LMASK,
             ((w[..., 0] >> 26) | (w[..., 1] << 6)) & _LMASK,
             ((w[..., 1] >> 20) | (w[..., 2] << 12)) & _LMASK,
             ((w[..., 2] >> 14) | (w[..., 3] << 18)) & _LMASK,
             (w[..., 3] >> 8) | (hibit << 24)]
    return torch.stack(limbs, dim=-1)


def _carry(h: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass over (B, 5) limbs; the carry out of the top
    limb re-enters limb 0 times 5."""
    c = h >> _RADIX
    fold = torch.cat([5 * c[:, 4:], c[:, :4]], dim=1)
    return (h & _LMASK) + fold


def _poly_final(h: torch.Tensor, s_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 5) limbs -> (h mod 2^130 - 5) + s mod 2^128 as (B, 16) uint8."""
    h = [h[:, i] for i in range(5)]
    for _ in range(2):  # two sequential passes leave every limb < 2^26
        for i in range(4):
            h[i + 1] = h[i + 1] + (h[i] >> _RADIX)
            h[i] = h[i] & _LMASK
        h[0] = h[0] + 5 * (h[4] >> _RADIX)
        h[4] = h[4] & _LMASK
    # h < 2^130 now; take off p once where h >= p, i.e. where h + 5 >= 2^130
    g, c = [], torch.full_like(h[0], 5)
    for i in range(5):
        v = h[i] + c
        g.append(v & _LMASK)
        c = v >> _RADIX
    h = [torch.where(c > 0, gi, hi) for gi, hi in zip(g, h)]
    # the low 128 bits of h, as four words, plus s with carries
    acc, words = h[0] + (h[1] << 26), []
    for limb, shift in ((h[2], 20), (h[3], 14), (h[4], 8)):
        words.append(acc & M32)
        acc = (acc >> 32) + (limb << shift)
    words.append(acc & M32)
    s = _le_words(s_bytes)
    out, carry = [], torch.zeros_like(words[0])
    for i in range(4):
        v = words[i] + s[:, i] + carry
        out.append(v & M32)
        carry = v >> 32
    return _words_to_u8(torch.stack(out, dim=1))


def poly1305_tags(r_bytes: torch.Tensor, s_bytes: torch.Tensor, mac_bytes: torch.Tensor,
                  active: torch.Tensor, hibit: torch.Tensor | None = None) -> torch.Tensor:
    """Batched Poly1305 over block-aligned MAC input.

    r_bytes / s_bytes: (B, 16) uint8 halves of the one-time key (r is
    clamped here); mac_bytes: (B, 16 n) uint8, every block a full padded
    16-byte block (all an AEAD MACs); active: (B, n) bool, False for a
    block that leaves the accumulator untouched.  ``hibit`` (B, n) bool,
    all True when None, is False for a short final block of a bare
    Poly1305 message, which the caller pads with 0x01 and zeros (§2.5.1).
    Returns (B, 16) uint8 tags.
    """
    b = r_bytes.shape[0]
    clamp = torch.tensor(_R_CLAMP, dtype=torch.uint8, device=r_bytes.device)
    r = _limbs(_le_words(r_bytes & clamp), 0)  # (B, 5)
    # d_i = sum_j h_j * rr[j, i]: r_{i-j}, times 5 where the product wraps past 2^130
    i = torch.arange(5, device=r.device).view(1, 5)
    j = i.view(5, 1)
    rr = r[:, (i - j) % 5] * torch.where(i >= j, 1, 5)  # (B, 5, 5)
    blocks = _limbs(_le_words(mac_bytes).reshape(b, -1, 4),
                    1 if hibit is None else hibit.to(torch.int64))  # (B, n, 5)
    h = torch.zeros_like(r)
    for t in range(blocks.shape[1]):
        d = ((h + blocks[:, t])[:, :, None] * rr).sum(dim=1)
        h = torch.where(active[:, t, None], _carry(_carry(d)), h)
    return _poly_final(h, s_bytes)


def aead_core(keys: torch.Tensor, nonces: torch.Tensor, data: torch.Tensor,
              lens: torch.Tensor, aads: torch.Tensor, aad_lens: torch.Tensor, *,
              seal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ChaCha20-Poly1305 seal or open core.

    keys (B, 32) uint8, nonces (B, 12) uint8, data (B, L) uint8 (plaintext
    when sealing, ciphertext when opening; L a multiple of 64), lens (B,)
    true byte lengths, aads (B, A) uint8 (A a multiple of 16), aad_lens
    (B,).  All on one device.  Returns ``(other, tags)``: ``other`` is the
    ciphertext (seal) or plaintext (open), zero past ``lens``; ``tags`` the
    (B, 16) uint8 Poly1305 tags over the ciphertext either way (the open
    caller compares them with the received tags).

    Every block of the batch goes through one :func:`chacha_blocks` call:
    block 0 of each row (counter 0) is the Poly1305 one-time key, blocks
    1..L/64 are the keystream.
    """
    b, length = data.shape
    dev = data.device
    reps = length // 64 + 1
    lens, aad_lens = lens.to(device=dev, dtype=torch.int64), aad_lens.to(device=dev,
                                                                         dtype=torch.int64)
    ctr = torch.arange(reps, dtype=torch.int64, device=dev).view(1, reps, 1).expand(b, reps, 1)
    states = torch.cat([_le_words(keys)[:, None, :].expand(b, reps, 8), ctr,
                        _le_words(nonces)[:, None, :].expand(b, reps, 3)], dim=-1)
    # int32 words are little-endian on the card and on the host: viewed as
    # bytes they are RFC 8439's serialized blocks
    blocks = chacha_blocks(_to_int32(states.reshape(b * reps, 12))).view(torch.uint8)
    blocks = blocks.reshape(b, reps, 64)
    poly_key = blocks[:, 0, :32]
    ks = blocks[:, 1:, :].reshape(b, length)
    mask = torch.arange(length, device=dev) < lens[:, None]
    other = torch.where(mask, data ^ ks, 0)
    ct = other if seal else torch.where(mask, data, 0)
    # MAC input (§2.8): padded AAD || padded ciphertext || le64 lengths,
    # block-aligned by construction, so per-row lengths mask block-wise
    aad_m = torch.where(torch.arange(aads.shape[1], device=dev) < aad_lens[:, None], aads, 0)
    mac_bytes = torch.cat([aad_m, ct, _le64(aad_lens), _le64(lens)], dim=1)
    active = torch.cat([
        torch.arange(0, aads.shape[1], 16, device=dev) < aad_lens[:, None],
        torch.arange(0, length, 16, device=dev) < lens[:, None],
        torch.ones((b, 1), dtype=torch.bool, device=dev),  # the length block
    ], dim=1)
    tags = poly1305_tags(poly_key[:, :16], poly_key[:, 16:], mac_bytes, active)
    return other, tags
