"""The port's signature provider and its batching queue on the CPU backend:
round trips, interop with the JAX package's ML-DSA provider, the operand
cache, BatchedSignature and the registry."""

import asyncio

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.provider.sig_providers import MLDSASignature as RefMLDSA
from quantum_resistant_p2p_tpu.pyref import mldsa_ref as ref
from quantum_resistant_p2p_tpu_torch.provider import (BatchedSignature, MLDSASignature,
                                                      get_signature, list_signatures)
from quantum_resistant_p2p_tpu_torch.provider.base import SignatureAlgorithm


@pytest.fixture(scope="module")
def dsa65():
    return get_signature("ML-DSA-65", backend="cpu")


@pytest.fixture(scope="module")
def keypair(dsa65):
    return dsa65.generate_keypair()


def test_round_trip_and_lengths(dsa65, keypair):
    pk, sk = keypair
    assert (len(pk), len(sk)) == (ref.MLDSA65.pk_len, ref.MLDSA65.sk_len)
    sig = dsa65.sign(sk, b"port provider")
    assert len(sig) == dsa65.signature_len == ref.MLDSA65.sig_len
    assert dsa65.verify(pk, b"port provider", sig)
    assert not dsa65.verify(pk, b"port provider!", sig)
    assert not dsa65.verify(pk, b"port provider", sig[:-1])
    assert not dsa65.verify(pk[:-1], b"port provider", sig)
    with pytest.raises(ValueError, match="secret key must be 4032 bytes"):
        dsa65.sign(sk[:-1], b"x")


def test_interop_with_the_jax_package_provider(dsa65, keypair):
    """A signature from the port verifies under the JAX package's CPU
    provider, and one from that provider verifies under the port."""
    pk, sk = keypair
    theirs = RefMLDSA(3, backend="cpu")
    msg = b"interop across the two packages"
    assert theirs.verify(pk, msg, dsa65.sign(sk, msg))
    their_pk, their_sk = theirs.generate_keypair()
    sig = theirs.sign(their_sk, msg)
    assert dsa65.verify(their_pk, msg, sig)
    assert not dsa65.verify(their_pk, msg + b"?", sig)


def test_sign_batch_with_injected_rnd_matches_pyref(dsa65, keypair):
    _, sk = keypair
    msgs = [b"one", b"two"]
    rnds = [bytes(range(32)), bytes(32)]
    sigs = dsa65.sign_batch(np.stack([np.frombuffer(sk, np.uint8)] * 2), msgs, rnd=rnds)
    for m, r, s in zip(msgs, rnds, sigs):
        assert s == ref.sign(ref.MLDSA65, sk, m, rnd=r)


def test_single_key_batches_use_the_operand_cache():
    """A miss computes the key state beside the op, a hit reuses it: the
    same (key, message, rnd) signs to the same bytes either way."""
    dsa = MLDSASignature(2, backend="cpu")
    pks, sks = dsa.generate_keypair_batch(2)
    msgs, rnds = [b"a", b"b", b"c"], [bytes([i]) * 32 for i in range(3)]
    signed = []
    for round_ in range(2):
        signed.append(dsa.sign_batch(np.repeat(sks[:1], 3, axis=0), msgs, rnd=rnds))
        assert dsa.verify_batch(np.repeat(pks[:1], 3, axis=0), msgs, signed[-1]).all()
        stats = dsa.opcache.stats()
        assert stats["misses"] == 2 and stats["hits"] == 2 * round_, stats  # sk + pk
    assert signed[0] == signed[1]
    # a mixed-key batch skips the cache and still agrees
    sigs = dsa.sign_batch(sks, [b"x", b"y"])
    assert dsa.verify_batch(pks, [b"x", b"y"], sigs).tolist() == [True, True]
    assert dsa.verify_batch(pks, [b"x", b"y"], sigs[::-1]).tolist() == [False, False]
    assert dsa.opcache.stats()["hits"] == 2
    assert dsa.verify_batch(pks, [b"x", b"y"], [sigs[0], sigs[1][:-2]]).tolist() == [True,
                                                                                    False]


def test_exhausted_lane_raises(dsa65, keypair, monkeypatch):
    """A lane that runs out of attempts has no signature: the provider
    raises rather than return its all-zero sigma."""
    from quantum_resistant_p2p_tpu_torch.sig import mldsa

    monkeypatch.setattr(mldsa, "MAX_SIGN_ITERS", 0)
    sks = np.stack([np.frombuffer(keypair[1], np.uint8), np.zeros(4032, np.uint8)])
    for rows in (sks[:1], sks):  # the single-key (cached) and the mixed-key paths
        with pytest.raises(RuntimeError, match="exhausted the rejection-sampling budget"):
            dsa65.sign_batch(rows, [b"never signed"] * len(rows))


def test_batched_signature_coalesces_and_rejects_bad_lengths(dsa65, keypair):
    pk, sk = keypair
    n = 16

    async def run():
        with BatchedSignature(dsa65, max_batch=4096, max_wait_ms=20.0) as bs:
            msgs = [b"msg %d" % i for i in range(n)]
            sigs = await asyncio.gather(*(bs.sign(sk, m) for m in msgs))
            oks = await asyncio.gather(*(bs.verify(pk, m, s) for m, s in zip(msgs, sigs)))
            mixed = await asyncio.gather(
                bs.sign(sk, b"fine"), bs.sign(sk[:-1], b"short key"),
                bs.verify(pk[:-1], b"m", sigs[0]), bs.verify(pk, b"m", sigs[0][:-1]),
                bs.verify(pk, msgs[0], sigs[1]), return_exceptions=True)
            return sigs, oks, mixed, bs.stats()

    sigs, oks, mixed, stats = asyncio.run(run())
    assert all(oks) and all(dsa65.verify(pk, b"msg %d" % i, s) for i, s in enumerate(sigs))
    assert stats["sign"]["ops"] == n + 2 and stats["verify"]["ops"] == n + 3
    assert stats["sign"]["flushes"] < n and stats["sign"]["max_batch_seen"] > 1
    assert stats["verify"]["flushes"] < n
    good, bad_key, bad_pk, bad_sig, wrong = mixed
    assert dsa65.verify(pk, b"fine", good)
    assert isinstance(bad_key, ValueError) and str(bad_key) == "bad secret-key length"
    assert (bad_pk, bad_sig, wrong) == (False, False, False)


class _FailingSig(SignatureAlgorithm):
    name, public_key_len, secret_key_len, signature_len = "broken", 4, 4, 4

    def generate_keypair(self):
        return b"pppp", b"ssss"

    def sign(self, secret_key, message):
        raise RuntimeError("device lost")

    def verify(self, public_key, message, signature):
        raise RuntimeError("device lost")


def test_batched_signature_failure_reaches_every_waiter():
    """No fallback: a flush that raises fails its futures, verify too."""
    async def run():
        with BatchedSignature(_FailingSig(), max_wait_ms=5.0) as bs:
            return await asyncio.gather(bs.sign(b"ssss", b"m"), bs.verify(b"pppp", b"m", b"gggg"),
                                        return_exceptions=True)

    out = asyncio.run(run())
    assert all(isinstance(r, RuntimeError) and str(r) == "device lost" for r in out)


def test_registry_names_and_backends():
    assert list_signatures() == ["ML-DSA-44", "ML-DSA-65", "ML-DSA-87"]
    with pytest.raises(KeyError):
        get_signature("Dilithium3", backend="cpu")
    for bad in ("auto", "tpu"):
        with pytest.raises(ValueError, match="not supported"):
            get_signature("ML-DSA-65", backend=bad)
    assert get_signature("ML-DSA-87", backend="cpu").signature_len == ref.MLDSA87.sig_len
    with pytest.raises(ValueError, match="level must be 2/3/5"):
        MLDSASignature(4, backend="cpu")


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the backend is available")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        get_signature("ML-DSA-65")  # the default backend is the GPU
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MLDSASignature(3)
