"""The port's SPHINCS+-SHA2 provider on the "cpu" backend: the registry,
agreement with the JAX package's CPU provider in both directions,
BatchedSignature, and the health probe.  The "cuda" backend raises here,
where there is no GPU.

Each 128f signature through the plain path takes ~12 s on one thread, so
every test signs at most once."""

import asyncio
import gc

import jax
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.provider.sig_providers import \
    SPHINCSSignature as RefSPHINCSSignature
from quantum_resistant_p2p_tpu_torch.provider import (BatchedSignature, SPHINCSSignature,
                                                      get_signature, list_signatures)
from quantum_resistant_p2p_tpu_torch.provider.health import (_check_sig_roundtrip,
                                                             ensure_validated, gate_facades)
from quantum_resistant_p2p_tpu_torch.sig import slhdsa_params

NAMES = [f"SPHINCS+-SHA2-{s}-simple" for s in ("128f", "128s", "192f", "192s", "256f", "256s")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_clear_jax():
    """One PyTorch thread (xdist workers share the cores), and JAX's
    compiled programs released at the end (ROADMAP C1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


def test_registry_lists_the_six_sets():
    assert set(NAMES) <= set(list_signatures())
    for name in NAMES:
        dsa = get_signature(name, backend="cpu")
        p = slhdsa_params.PARAMS[name]
        assert isinstance(dsa, SPHINCSSignature) and dsa.name == name and dsa.params == p
        assert dsa.backend == "cpu" and dsa.fast == name.endswith("f-simple")
        assert (dsa.public_key_len, dsa.secret_key_len, dsa.signature_len) == (
            p.pk_len, p.sk_len, p.sig_len)
    with pytest.raises(ValueError, match="level"):
        SPHINCSSignature(2, backend="cpu")
    with pytest.raises(ValueError, match="backend"):
        SPHINCSSignature(1, backend="tpu")


def test_signs_and_verifies_across_the_reference_provider():
    """Both sign deterministically, so the port's signature is the
    reference's byte for byte; each verifies the other's, and neither takes
    a signature of another message."""
    port = get_signature("SPHINCS+-SHA2-128f-simple", backend="cpu")
    ref = RefSPHINCSSignature(1, backend="cpu", fast=True)
    pk, sk = port.generate_keypair()
    msg = b"port -> reference"
    sig = port.sign(sk, msg)
    assert sig == ref.sign(sk, msg)
    assert ref.verify(pk, msg, sig) and not ref.verify(pk, msg + b"!", sig)
    rpk, rsk = ref.generate_keypair()
    rsig = ref.sign(rsk, b"reference -> port")
    oks = port.verify_batch(np.frombuffer(rpk, np.uint8)[None].repeat(3, 0),
                            [b"reference -> port", b"another message", b"reference -> port"],
                            [rsig, rsig, rsig[:-1]])
    assert oks.tolist() == [True, False, False]
    assert not port.verify(rpk[:-1], b"reference -> port", rsig)


def test_batched_signature_serves_a_few_clients():
    dsa = get_signature("SPHINCS+-SHA2-128f-simple", backend="cpu")
    pks, sks = dsa.generate_keypair_batch(2)
    msgs = [b"client 0", b"client 1"]

    async def run():
        with BatchedSignature(dsa, max_wait_ms=20.0) as bs:
            sigs = await asyncio.gather(*(bs.sign(bytes(sk), m) for sk, m in zip(sks, msgs)))
            with pytest.raises(ValueError, match="secret-key length"):
                await bs.sign(b"short", b"m")
            bad = bytearray(sigs[1])
            bad[-1] ^= 1
            oks = await asyncio.gather(bs.verify(bytes(pks[0]), msgs[0], sigs[0]),
                                       bs.verify(bytes(pks[1]), msgs[1], sigs[1]),
                                       bs.verify(bytes(pks[1]), msgs[1], bytes(bad)),
                                       bs.verify(bytes(pks[1]), msgs[1], sigs[1][:-1]))
            return oks, bs.stats(), bs._sign.stats.batch_sizes

    oks, stats, sign_sizes = asyncio.run(run())
    assert oks == [True, True, False, False]
    assert stats["sign"]["ops"] == 3 and stats["verify"]["ops"] == 4
    assert sign_sizes[0] == 2


def test_health_probe_passes_with_its_cpu_twin():
    """The probe on a CPU provider marked as if on a card: a round trip,
    the CPU twin's verify, and a tampered signature refused."""
    dsa = get_signature("SPHINCS+-SHA2-128f-simple", backend="cpu")
    dsa.backend = "cuda"
    with BatchedSignature(dsa) as bs:
        (verdict,) = gate_facades(bs, cpu_sig=get_signature(dsa.name, backend="cpu"))
    assert verdict.ok and verdict.detail == "device sign/verify ok + cpu agreement"
    assert ensure_validated(get_signature(dsa.name, backend="cpu")).detail.startswith(
        "cpu backend")


def test_health_probe_fails_with_a_twin_that_rejects():
    class RejectingTwin(SPHINCSSignature):
        def verify(self, public_key, message, signature):
            return False

    dsa = get_signature("SPHINCS+-SHA2-128f-simple", backend="cpu")
    dsa.backend = "cuda"
    verdict = _check_sig_roundtrip(dsa, RejectingTwin(1, backend="cpu"))
    assert not verdict.ok and "cpu twin rejects" in verdict.detail
    dsa.generate_keypair = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
    with BatchedSignature(dsa) as bs, pytest.raises(RuntimeError, match="device lost"):
        gate_facades(bs, cpu_sig=RejectingTwin(1, backend="cpu"))


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SPHINCSSignature(1)
    for name in ("SPHINCS+-SHA2-128s-simple", "SPHINCS+-SHA2-256f-simple"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            get_signature(name)
