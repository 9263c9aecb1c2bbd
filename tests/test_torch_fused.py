"""The port's fused ML-KEM-768 x ML-DSA-65 handshake on the CPU: the
variable-length sponge, the transcript helpers and the three fused
programs against the JAX package's, byte for byte; the fused programs
against the port's own separate-op path; the fused provider, BatchedFused,
the registry and the health checks.

Inputs (keys, seeds, transcripts) are made from a seed with numpy and
handed to both sides.  Each JAX program is jitted once, in a module-scoped
fixture.  The kernels (K1 with per-row lengths among them) run only on a
GPU: tests/test_torch_gpu.py holds them to their plain versions there.
"""

import asyncio
import gc
import hashlib
import json
import types

import jax
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.core import keccak as jk
from quantum_resistant_p2p_tpu.fused import mlkem_mldsa as jf
from quantum_resistant_p2p_tpu_torch.core import keccak as tk
from quantum_resistant_p2p_tpu_torch.core import keccak_cuda
from quantum_resistant_p2p_tpu_torch.fused import mlkem_mldsa as tf
from quantum_resistant_p2p_tpu_torch.kem import mlkem as tmk
from quantum_resistant_p2p_tpu_torch.provider import (BatchedFused, BatchedKEM,
                                                      FusedMLKEMMLDSA, get_fused, get_kem,
                                                      get_signature, init_pk_offset,
                                                      list_fused, resp_ct_offset)
from quantum_resistant_p2p_tpu_torch.provider.health import (_check_fused, _check_mlkem_kat,
                                                             _check_sig_roundtrip,
                                                             ensure_validated, gate_facades)
from quantum_resistant_p2p_tpu_torch.sig import mldsa as tsig

KEM, SIG, AEAD = "ML-KEM-768", "ML-DSA-65", "ChaCha20-Poly1305"
B = 2
PK_OFF, CT_OFF = init_pk_offset(KEM, AEAD), resp_ct_offset()
#: the longest init transcript the fused programs hash: tr || 0 0 || template
LMAX = 64 + 2 + 2 * 1184 + 1024


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop the JAX programs this module compiled when it ends.  Each
    compiled program holds memory maps in its process, and a test process
    that compiles many programs can reach the kernel's limit on maps."""
    yield
    for get in (jf.get_keygen_sign, jf.get_encaps_verify_sign, jf.get_decaps_verify_sign):
        get.cache_clear()
    jax.clear_caches()
    gc.collect()


def _u8(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _init_template(i: int) -> bytes:
    d = {"aead": AEAD, "kem": KEM, "message_id": "%036d" % i, "public_key": "0" * 2368,
         "recipient": "gateway", "sender": "peer-%d" % (7 ** i), "timestamp": 1700000000.25 + i}
    return json.dumps(d, sort_keys=True, separators=(",", ":")).encode()


def _resp_template(i: int) -> bytes:
    d = {"ciphertext": "0" * 2176, "message_id": "%036d" % (100 + i),
         "recipient": "peer-%d" % (7 ** i), "sender": "gateway", "timestamp": 1700000001.5}
    return json.dumps(d, sort_keys=True, separators=(",", ":")).encode()


def _stack(templates: list[bytes], width: int) -> tuple[np.ndarray, np.ndarray]:
    out = np.zeros((len(templates), width), np.uint8)
    for i, t in enumerate(templates):
        out[i, : len(t)] = np.frombuffer(t, np.uint8)
    return out, np.array([len(t) for t in templates], np.int32)


def _mu(tr: bytes, msg: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.shake_256(tr + b"\0\0" + msg).digest(64), np.uint8)


# -- the variable-length sponge ----------------------------------------------


def test_shake256_varlen_matches_jax_and_hashlib():
    """Lengths on each side of every multiple of 136 up to LMAX, 0 and
    LMAX, with garbage past each row's length."""
    lengths = sorted({0, LMAX} | {k * 136 + o for k in range(1, LMAX // 136 + 1)
                                  for o in (-1, 0, 1) if k * 136 + o <= LMAX})
    data = _u8(1, len(lengths), LMAX)
    lens = np.array(lengths, np.int32)
    before = keccak_cuda.sponge_varlen.launches
    got = tk.shake256_varlen(_t(data), _t(lens), 64).numpy()
    assert keccak_cuda.sponge_varlen.launches == before  # CPU tensors: the plain version
    assert np.array_equal(got, np.asarray(jk.shake256_varlen(data, lens, 64)))
    for i, n in enumerate(lengths):
        assert bytes(got[i]) == hashlib.shake_256(bytes(data[i, :n])).digest(64)


@pytest.mark.parametrize("rate,ds,out_len,ref", [
    (72, 0x06, 64, lambda b: hashlib.sha3_512(b).digest()),
    (168, 0x1F, 200, lambda b: hashlib.shake_128(b).digest(200))])
def test_sponge_varlen_other_rates_match_hashlib(rate, ds, out_len, ref):
    """Other rates, squeezes past one block, and a length that puts the
    domain byte and 0x80 in one byte (length % rate == rate - 1)."""
    lengths = [0, rate - 1, rate, 2 * rate - 1, 3 * rate + 5, 4 * rate]
    data = _u8(rate, len(lengths), 4 * rate)
    got = tk.sponge_varlen(_t(data), _t(np.array(lengths, np.int32)), rate, ds, out_len)
    for i, n in enumerate(lengths):
        assert bytes(got[i].numpy()) == ref(bytes(data[i, :n]))


def test_sponge_varlen_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        keccak_cuda.sponge_varlen(torch.zeros((2, 8), dtype=torch.uint8),
                                  torch.zeros(2, dtype=torch.int32), 136, 0x1F, 32)
    with pytest.raises(ValueError, match="rate"):
        keccak_cuda.sponge_varlen(torch.zeros((2, 8), dtype=torch.uint8),
                                  torch.zeros(2, dtype=torch.int32), 100, 0x1F, 32)


# -- transcript helpers ------------------------------------------------------


def test_offsets_point_at_the_hex_gaps():
    t, r = _init_template(0), _resp_template(0)
    assert t[PK_OFF - len('"public_key":"'): PK_OFF + 2368 + 1] == (
        b'"public_key":"' + b"0" * 2368 + b'"')
    assert r[CT_OFF - len('"ciphertext":"'): CT_OFF + 2176 + 1] == (
        b'"ciphertext":"' + b"0" * 2176 + b'"')


def test_encode_hex_and_insert_hex_match_jax():
    data = np.frombuffer(bytes(range(256)), np.uint8)
    assert bytes(tf.encode_hex(_t(data)).numpy()) == bytes(range(256)).hex().encode()
    tmpl, _ = _stack([_init_template(i) for i in range(B)], 2 * 1184 + 1024)
    ek = _u8(3, B, 1184)
    got = tf._insert_hex(_t(tmpl), _t(ek), PK_OFF).numpy()
    assert np.array_equal(got, np.asarray(jf._insert_hex(tmpl, ek, PK_OFF)))
    assert np.array_equal(np.asarray(jf.encode_hex(ek)), tf.encode_hex(_t(ek)).numpy())


def test_transcript_mu_matches_jax_and_hashlib():
    sk = _u8(4, B, 4032)
    templates = [_init_template(i) for i in range(B)]
    tmpl, lens = _stack(templates, 2 * 1184 + 1024)
    got = tf.transcript_mu(_t(sk), _t(tmpl), _t(lens)).numpy()
    assert np.array_equal(got, np.asarray(jf.transcript_mu(sk, tmpl, lens)))
    for i in range(B):
        assert np.array_equal(got[i], _mu(bytes(sk[i, 64:128]), templates[i]))


# -- the three fused programs, held to JAX ------------------------------------


@pytest.fixture(scope="module")
def handshake():
    """B initiators with their own ML-DSA-65 keys and one responder key; the
    three programs run on both packages with injected d, z, m and rnd.
    Lane 1's init transcript is tampered with before the responder
    verifies it, so its ok is False on both sides."""
    p = tsig.MLDSA65
    i_pk, i_sk = (t.numpy() for t in tsig.keygen(p, _t(_u8(10, B, 32))))
    r_pk, r_sk = (t.numpy() for t in tsig.keygen(p, _t(_u8(11, 32))))
    r_pks, r_sks = np.repeat(r_pk[None], B, 0), np.repeat(r_sk[None], B, 0)
    d, z, m = _u8(12, B, 32), _u8(13, B, 32), _u8(14, B, 32)
    rnd = [_u8(15 + k, B, 32) for k in range(3)]
    out = {"i_pk": i_pk, "i_sk": i_sk, "r_pk": r_pks, "r_sk": r_sks, "d": d, "z": z, "m": m}
    init_t = [_init_template(i) for i in range(B)]
    tmpl, lens = _stack(init_t, 2 * 1184 + 1024)
    args = (d, z, i_sk, rnd[0], tmpl, lens)
    out["kg"] = ([np.asarray(a) for a in jf.get_keygen_sign(KEM, SIG, PK_OFF)(*args)],
                 [a.numpy() for a in tf.keygen_sign(KEM, SIG, PK_OFF, *map(_t, args))])
    ek, dk, init_sig, _ = out["kg"][1]
    rendered = [BatchedFused._render(t, bytes(e), PK_OFF) for t, e in zip(init_t, ek)]
    seen = [rendered[0], rendered[1][:-2] + b"9}"]  # lane 1 tampered on the wire
    mu_in = np.stack([_mu(hashlib.shake_256(bytes(i_pk[i])).digest(64), seen[i])
                      for i in range(B)])
    resp_t = [_resp_template(i) for i in range(B)]
    rtmpl, rlens = _stack(resp_t, 2 * 1088 + 1024)
    args = (ek, m, i_pk, mu_in, init_sig, r_sks, rnd[1], rtmpl, rlens)
    out["enc"] = ([np.asarray(a) for a in jf.get_encaps_verify_sign(KEM, SIG, CT_OFF)(*args)],
                  [a.numpy() for a in tf.encaps_verify_sign(KEM, SIG, CT_OFF, *map(_t, args))])
    _, ct, key, resp_sig, _ = out["enc"][1]
    r_rendered = [BatchedFused._render(t, bytes(c), CT_OFF) for t, c in zip(resp_t, ct)]
    r_tr = hashlib.shake_256(bytes(r_pk)).digest(64)
    mu_resp = np.stack([_mu(r_tr, r) for r in r_rendered])
    confirm = [b'{"message_id":"c%d","recipient":"gateway","sender":"peer"}' % i
               for i in range(B)]
    mu_out = np.stack([_mu(bytes(i_sk[i, 64:128]), confirm[i]) for i in range(B)])
    args = (dk, ct, r_pks, mu_resp, resp_sig, i_sk, mu_out, rnd[2])
    out["dec"] = ([np.asarray(a) for a in jf.get_decaps_verify_sign(KEM, SIG)(*args)],
                  [a.numpy() for a in tf.decaps_verify_sign(KEM, SIG, *map(_t, args))])
    out.update(rendered=rendered, r_rendered=r_rendered, confirm=confirm, rnd=rnd,
               mu_out=mu_out)
    return out


@pytest.mark.parametrize("step", ["kg", "enc", "dec"])
def test_fused_program_matches_jax(handshake, step):
    want, got = handshake[step]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert np.array_equal(g, w)


def test_fused_outcomes(handshake):
    """Every lane signed; the tampered lane's verify is False and the
    other's True; both sides' secrets agree on the honest lane."""
    _, _, _, done = handshake["kg"][1]
    ok, _, key, _, done2 = handshake["enc"][1]
    ok2, ss, _, done3 = handshake["dec"][1]
    assert done.all() and done2.all() and done3.all()
    assert ok.tolist() == [True, False] and ok2.tolist() == [True, True]
    assert np.array_equal(ss[0], key[0])


def test_fused_matches_the_separate_op_path(handshake):
    """The fused programs against the port's own separate ops on the same
    seeds: keygen, sign over the host-rendered transcript, encaps, decaps,
    verify."""
    h = handshake
    kp, sp = tmk.MLKEM768, tsig.MLDSA65
    ek, dk, init_sig, _ = h["kg"][1]
    ek2, dk2 = tmk.keygen(kp, _t(h["d"]), _t(h["z"]))
    assert np.array_equal(ek2.numpy(), ek) and np.array_equal(dk2.numpy(), dk)
    mus = _t(np.stack([_mu(bytes(h["i_sk"][i, 64:128]), h["rendered"][i]) for i in range(B)]))
    sig2, _ = tsig.sign_mu(sp, _t(h["i_sk"]), mus, _t(h["rnd"][0]))
    assert np.array_equal(sig2.numpy(), init_sig)
    _, ct, key, resp_sig, _ = h["enc"][1]
    key2, ct2 = tmk.encaps(kp, _t(ek), _t(h["m"]))
    assert np.array_equal(key2.numpy(), key) and np.array_equal(ct2.numpy(), ct)
    r_mus = _t(np.stack([_mu(bytes(h["r_sk"][i, 64:128]), h["r_rendered"][i])
                         for i in range(B)]))
    assert np.array_equal(tsig.sign_mu(sp, _t(h["r_sk"]), r_mus, _t(h["rnd"][1]))[0].numpy(),
                          resp_sig)
    _, ss, confirm_sig, _ = h["dec"][1]
    assert np.array_equal(tmk.decaps(kp, _t(dk), _t(ct)).numpy(), ss)
    assert np.array_equal(tsig.sign_mu(sp, _t(h["i_sk"]), _t(h["mu_out"]),
                                       _t(h["rnd"][2]))[0].numpy(), confirm_sig)
    assert tsig.verify_mu(sp, _t(h["i_pk"]), _t(h["mu_out"]), _t(confirm_sig)).all()


# -- provider, queue, registry, health --------------------------------------


@pytest.fixture(scope="module")
def providers():
    kem, sig = get_kem(KEM, backend="cpu"), get_signature(SIG, backend="cpu")
    return kem, sig, get_fused(kem, sig)


def test_registry_fused_pairs(providers):
    kem, sig, fused = providers
    assert isinstance(fused, FusedMLKEMMLDSA) and fused.backend == "cpu"
    assert fused.init_template_len == 2 * 1184 + 1024 == LMAX - 66
    assert len(list_fused()) == 9 and (KEM, SIG) in list_fused()
    assert get_fused(types.SimpleNamespace(name="X"), sig) is None
    with pytest.raises(ValueError, match="one backend"):
        FusedMLKEMMLDSA(types.SimpleNamespace(backend="cuda"), sig)


def _handshakes(fused, sig, n: int, template=_init_template):
    """n initiators (own keys) and one responder through one BatchedFused
    each side, trip by trip; -> (results, initiator stats, responder stats)."""
    pks, sks = sig.generate_keypair_batch(n)
    r_pk, r_sk = sig.generate_keypair()

    async def run():
        with BatchedFused(fused, PK_OFF, CT_OFF, max_wait_ms=50.0) as ini, \
                BatchedFused(fused, PK_OFF, CT_OFF, max_wait_ms=50.0) as resp:
            async def one(i):
                t = template(i)
                kem_pk, kem_sk, s1 = await ini.keygen_sign(bytes(sks[i]), t)
                init_msg = BatchedFused._render(t, kem_pk, PK_OFF)
                ok, ct, ss_r, s2 = await resp.encaps_verify_sign(
                    kem_pk, bytes(pks[i]), init_msg, s1, r_sk, _resp_template(i))
                resp_msg = BatchedFused._render(_resp_template(i), ct, CT_OFF)
                confirm = b'{"confirm":%d}' % i
                ok2, ss_i, s3 = await ini.decaps_verify_sign(kem_sk, ct, r_pk, resp_msg, s2,
                                                             bytes(sks[i]), confirm)
                return ok, ok2, ss_r == ss_i, sig.verify(pks[i].tobytes(), confirm, s3)

            return (await asyncio.gather(*(one(i) for i in range(n)),
                                         return_exceptions=True), ini.stats(), resp.stats())

    return asyncio.run(run())


def test_batched_fused_handshakes_coalesce(providers):
    _, sig, fused = providers
    results, ini, resp = _handshakes(fused, sig, 3)
    assert results == [(True, True, True, True)] * 3
    for stats in (ini["keygen_sign"], resp["encaps_verify_sign"], ini["decaps_verify_sign"]):
        assert stats["ops"] == 3 and stats["flushes"] == 1


def test_batched_fused_malformed_items_fail_alone(providers):
    kem, sig, fused = providers

    async def run():
        pk, sk = sig.generate_keypair()
        with BatchedFused(fused, PK_OFF, CT_OFF, max_wait_ms=20.0) as bf:
            return await asyncio.gather(
                bf.keygen_sign(sk, b"{}"),  # template shorter than the gap
                bf.encaps_verify_sign(bytes(1184), pk, b"m", b"short", sk,
                                      _resp_template(0)),
                bf.decaps_verify_sign(bytes(10), bytes(1088), pk, b"m", bytes(3309), sk, b"c"),
                return_exceptions=True)

    kg, enc, dec = asyncio.run(run())
    assert isinstance(kg, ValueError)
    assert enc == (False, b"", b"", b"") and dec == (False, b"", b"")


def test_batched_fused_failure_reaches_every_waiter(providers):
    _, sig, fused = providers

    class Broken(FusedMLKEMMLDSA):
        def keygen_sign_batch(self, *args, **kw):
            raise RuntimeError("device lost")

    broken = Broken(fused.kem, fused.sig)
    _, sk = sig.generate_keypair()

    async def run():
        with BatchedFused(broken, PK_OFF, CT_OFF, max_wait_ms=20.0) as bf:
            return await asyncio.gather(*(bf.keygen_sign(sk, _init_template(i))
                                          for i in range(4)), return_exceptions=True)

    out = asyncio.run(run())
    assert all(isinstance(r, RuntimeError) and str(r) == "device lost" for r in out)


def test_health_checks_pass_and_fail_on_a_broken_device(providers):
    kem, sig, fused = providers
    assert _check_mlkem_kat(kem).ok
    assert ensure_validated(kem).detail == "cpu backend; no device to gate"
    with BatchedFused(fused, PK_OFF, CT_OFF) as facade, BatchedKEM(kem) as bk:
        verdict = _check_fused(facade, kem, sig)
        assert verdict.ok, verdict.detail
        assert [v.ok for v in gate_facades(facade, bk, cpu_kem=kem, cpu_sig=sig)] == [True, True]
        with pytest.raises(ValueError, match="twins"):
            gate_facades(facade)

    class Broken(FusedMLKEMMLDSA):
        def keygen_sign_batch(self, *args, **kw):
            pks, sks, sigs = super().keygen_sign_batch(*args, **kw)
            return pks, sks, [bytes([s[0] ^ 1]) + s[1:] for s in sigs]

    with BatchedFused(Broken(kem, sig), PK_OFF, CT_OFF) as facade:
        assert not _check_fused(facade, kem, sig).ok
        with pytest.raises(RuntimeError, match="device health fused"):
            gate_facades(facade, cpu_kem=kem, cpu_sig=sig)

    bad = get_signature("ML-DSA-44", backend="cpu")
    bad.backend = "cuda"  # as if on a card whose probe crashes
    bad.generate_keypair = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
    verdict = ensure_validated(bad)
    assert not verdict.ok and "device lost" in verdict.detail


def test_round_trip_probes_pass_and_fail(providers):
    """The probes ensure_validated runs for a GPU signature and for a GPU
    KEM without a pinned vector (here ML-KEM-512), on CPU providers as their
    own twins; a KEM whose twin decapsulates to another secret fails."""
    kem, sig, _ = providers
    assert _check_sig_roundtrip(sig, sig).ok
    other = get_kem("ML-KEM-512", backend="cpu")
    other.backend = "cuda"
    twin = get_kem("ML-KEM-512", backend="cpu")
    verdict = ensure_validated(other, twin)
    assert verdict.ok and verdict.detail == "device roundtrip ok + cpu agreement"
    twin.decapsulate_batch = lambda sks, cts: np.zeros((len(sks), 32), np.uint8)
    verdict = ensure_validated(other, twin)
    assert not verdict.ok and "cpu twin" in verdict.detail
    lax = get_signature(SIG, backend="cpu")
    lax.verify = lambda pk, msg, s: True  # accepts anything, tampered signatures too
    verdict = _check_sig_roundtrip(lax, sig)
    assert not verdict.ok and "tampered" in verdict.detail
