"""The port's FrodoKEM provider on the "cpu" backend: the registry, round
trips and agreement with the JAX package's CPU provider in both
directions, the operand cache, BatchedKEM, and the health checks.  The
"cuda" backend raises here, where there is no GPU."""

import asyncio

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.provider.kem_providers import \
    FrodoKEMKeyExchange as RefFrodoKEMKeyExchange
from quantum_resistant_p2p_tpu_torch.kem import frodo
from quantum_resistant_p2p_tpu_torch.provider import (BatchedKEM, FrodoKEMKeyExchange, get_kem,
                                                      list_kems)
from quantum_resistant_p2p_tpu_torch.provider import health, kem_providers
from quantum_resistant_p2p_tpu_torch.provider.health import (HealthVerdict, _check_frodo_kat,
                                                             _check_kem_roundtrip,
                                                             ensure_validated, gate_facades)

NAMES = [f"FrodoKEM-{n}-{v}" for n in (640, 976, 1344) for v in ("AES", "SHAKE")]


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


def test_registry_lists_the_six_sets():
    assert set(NAMES) <= set(list_kems())
    for name in NAMES:
        kem = get_kem(name, backend="cpu")
        p = frodo.PARAMS[name]
        assert isinstance(kem, FrodoKEMKeyExchange) and kem.name == name
        assert kem.use_aes == name.endswith("AES") and kem.backend == "cpu"
        assert (kem.public_key_len, kem.secret_key_len, kem.ciphertext_len,
                kem.shared_secret_len) == (p.pk_len, p.sk_len, p.ct_len, p.len_sec)
    with pytest.raises(ValueError, match="level"):
        FrodoKEMKeyExchange(2, backend="cpu")


@pytest.mark.parametrize("use_aes", [False, True], ids=["SHAKE", "AES"])
def test_round_trip_and_agreement_with_the_reference_provider(use_aes):
    """A port ciphertext decapsulates on the JAX package's CPU provider and
    the other way round, to the same secret."""
    port = FrodoKEMKeyExchange(1, backend="cpu", use_aes=use_aes)
    ref = RefFrodoKEMKeyExchange(1, backend="cpu", use_aes=use_aes)
    pk, sk = port.generate_keypair()
    ct, ss = port.encapsulate(pk)
    assert len(ss) == 16 and port.decapsulate(sk, ct) == ss
    assert ref.decapsulate(sk, ct) == ss
    rpk, rsk = ref.generate_keypair()
    rct, rss = ref.encapsulate(rpk)
    assert port.decapsulate(rsk, rct) == rss
    ct2, ss2 = port.encapsulate(rpk)
    assert ref.decapsulate(rsk, ct2) == ss2
    bad = bytes([ct[0] ^ 1]) + ct[1:]
    assert port.decapsulate(sk, bad) == ref.decapsulate(sk, bad) != ss


def test_operand_cache_misses_once_then_hits_with_the_same_bytes(monkeypatch):
    """Single-key batches: the miss (encaps_cold) and the hit (encaps_pre)
    give the bytes of the uncached encaps for the same mu."""
    kem = get_kem("FrodoKEM-640-SHAKE", backend="cpu")
    p = kem.params
    pk, _ = kem.generate_keypair()
    mus = iter(np.random.default_rng(5).integers(0, 256, (2, 3, p.len_sec), dtype=np.uint8))
    monkeypatch.setattr(kem_providers, "random_rows", lambda n, width=32: next(mus).copy())
    pks = np.stack([np.frombuffer(pk, np.uint8)] * 3)
    outs = [kem.encapsulate_batch(pks) for _ in range(2)]
    assert kem.opcache.stats()["misses"] == 1 and kem.opcache.stats()["hits"] == 1
    for (ct, ss), mu in zip(outs, np.random.default_rng(5).integers(0, 256, (2, 3, p.len_sec),
                                                                     dtype=np.uint8)):
        want_ct, want_ss = frodo.encaps(p, torch.tensor(pks), torch.tensor(mu))
        assert np.array_equal(ct, want_ct.numpy()) and np.array_equal(ss, want_ss.numpy())
    assert kem.opcache.zeroize() == 1


def test_batched_kem_serves_a_handful_of_clients():
    kem = get_kem("FrodoKEM-640-SHAKE", backend="cpu")

    async def run():
        with BatchedKEM(kem, max_wait_ms=20.0) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            agreed = await asyncio.gather(*(client() for _ in range(4)))
            with pytest.raises(ValueError, match="public-key length"):
                await bk.encapsulate(b"short")
            # 3 encaps to one key pad to a batch of 4 by repeating the last
            # row: still a single-key batch, so it takes the operand cache
            pk, sk = await bk.generate_keypair()
            outs = await asyncio.gather(*(bk.encapsulate(pk) for _ in range(3)))
            agreed += [await bk.decapsulate(sk, ct) == ss for ct, ss in outs]
            return agreed, bk.stats(), bk._enc.stats.batch_sizes

    agreed, stats, enc_sizes = asyncio.run(run())
    assert agreed == [True] * 7
    assert stats["keygen"]["ops"] == 5 and stats["encaps"]["ops"] == 8
    assert enc_sizes[-1] == 3
    assert kem.opcache.stats()["misses"] == 1


def test_health_checks_on_cpu_providers():
    """The probes of the Frodo sets, on CPU providers marked as if on a card:
    ensure_validated runs the pinned KAT for a SHAKE set and the round trip
    (with the CPU twin's decaps) for an AES set; a wrong twin and a crashing
    device fail their verdicts."""
    shake = get_kem("FrodoKEM-640-SHAKE", backend="cpu")
    aes = get_kem("FrodoKEM-640-AES", backend="cpu")
    shake.backend = aes.backend = "cuda"
    verdict = ensure_validated(shake)
    assert verdict.ok and verdict.detail == _check_frodo_kat(shake).detail
    with BatchedKEM(aes) as bk:
        (verdict,) = gate_facades(bk, cpu_kem=get_kem("FrodoKEM-640-AES", backend="cpu"))
    assert verdict.ok and "roundtrip ok + cpu agreement" in verdict.detail

    class WrongTwin(FrodoKEMKeyExchange):
        def decapsulate_batch(self, secret_keys, ciphertexts):
            return super().decapsulate_batch(secret_keys, ciphertexts) ^ 1

    verdict = _check_kem_roundtrip(aes, WrongTwin(1, backend="cpu", use_aes=True))
    assert not verdict.ok and "cpu twin" in verdict.detail
    aes.generate_keypair = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
    assert "device lost" in ensure_validated(aes).detail
    with BatchedKEM(aes) as bk, pytest.raises(RuntimeError, match="device health"):
        gate_facades(bk, cpu_kem=aes)


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        FrodoKEMKeyExchange(1)
    for name in ("FrodoKEM-640-AES", "FrodoKEM-1344-SHAKE"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            get_kem(name)


def test_health_of_a_wider_shake_set_runs_its_own_round_trip(monkeypatch):
    """FrodoKEM-976-SHAKE: the pinned 640 vector, then a round trip through
    this set's own kernels with its CPU twin; a twin that decapsulates to
    another secret fails the verdict."""
    kem = get_kem("FrodoKEM-976-SHAKE", backend="cpu")
    kem.backend = "cuda"
    verdict = ensure_validated(kem, get_kem("FrodoKEM-976-SHAKE", backend="cpu"))
    kat = "FrodoKEM-640-SHAKE KAT ok (keygen/encaps/decaps)"
    assert verdict.ok
    assert verdict.detail == f"{kat}; FrodoKEM-976-SHAKE device roundtrip ok + cpu agreement"

    class WrongTwin(FrodoKEMKeyExchange):
        def decapsulate_batch(self, secret_keys, ciphertexts):
            return super().decapsulate_batch(secret_keys, ciphertexts) ^ 1

    # the pinned vector passed above: the wrong twin's round trip is what is left
    monkeypatch.setattr(health, "_check_frodo_kat",
                        lambda algo: HealthVerdict(algo.name, True, kat))
    verdict = ensure_validated(kem, WrongTwin(3, backend="cpu", use_aes=False))
    assert not verdict.ok and "cpu twin decaps disagrees" in verdict.detail
