"""The port's HQC provider on the "cpu" backend: the registry, round trips
and agreement with the JAX package's CPU provider in both directions,
BatchedKEM, and the health probe (the pinned HQC-128 vector, and the round
trip with a CPU twin of the wider sets).  The "cuda" backend raises here,
where there is no GPU."""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.provider.kem_providers import HQCKeyExchange as RefHQCKeyExchange
from quantum_resistant_p2p_tpu_torch.kem import hqc
from quantum_resistant_p2p_tpu_torch.provider import (BatchedKEM, HQCKeyExchange, get_kem,
                                                      list_kems)
from quantum_resistant_p2p_tpu_torch.provider import health
from quantum_resistant_p2p_tpu_torch.provider.health import (_check_hqc_kat, ensure_validated,
                                                             gate_facades)

NAMES = ("HQC-128", "HQC-192", "HQC-256")
LEVELS = {"HQC-128": 1, "HQC-192": 3, "HQC-256": 5}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread: xdist workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _health_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path / "health"))


def test_registry_lists_the_three_sets():
    assert set(NAMES) <= set(list_kems())
    for name in NAMES:
        kem = get_kem(name, backend="cpu")
        p = hqc.PARAMS[name]
        assert isinstance(kem, HQCKeyExchange) and kem.name == name and kem.backend == "cpu"
        assert kem.security_level == LEVELS[name]
        assert (kem.public_key_len, kem.secret_key_len, kem.ciphertext_len,
                kem.shared_secret_len) == (p.pk_len, p.sk_len, p.ct_len, 64)
        ref = RefHQCKeyExchange(LEVELS[name], backend="cpu")
        assert (kem.public_key_len, kem.secret_key_len, kem.ciphertext_len,
                kem.shared_secret_len) == (ref.public_key_len, ref.secret_key_len,
                                           ref.ciphertext_len, ref.shared_secret_len)
    with pytest.raises(ValueError, match="level"):
        HQCKeyExchange(2, backend="cpu")
    with pytest.raises(ValueError, match="backend"):
        HQCKeyExchange(1, backend="tpu")


@pytest.mark.parametrize("name", NAMES)
def test_round_trip_and_agreement_with_the_reference_provider(name):
    """A port ciphertext decapsulates on the JAX package's CPU provider and
    the other way round, to the same secret; a tampered ciphertext gives
    both the same rejection secret."""
    port = get_kem(name, backend="cpu")
    ref = RefHQCKeyExchange(LEVELS[name], backend="cpu")
    pk, sk = port.generate_keypair()
    ct, ss = port.encapsulate(pk)
    assert len(ss) == 64 and port.decapsulate(sk, ct) == ss
    assert ref.decapsulate(sk, ct) == ss
    rpk, rsk = ref.generate_keypair()
    rct, rss = ref.encapsulate(rpk)
    assert port.decapsulate(rsk, rct) == rss
    ct2, ss2 = port.encapsulate(rpk)
    assert ref.decapsulate(rsk, ct2) == ss2
    bad = bytes([ct[0] ^ 1]) + ct[1:]
    assert port.decapsulate(sk, bad) == ref.decapsulate(sk, bad) != ss


def test_batches_and_wrong_lengths():
    kem = get_kem("HQC-128", backend="cpu")
    pks, sks = kem.generate_keypair_batch(3)
    assert pks.shape == (3, kem.public_key_len) and sks.shape == (3, kem.secret_key_len)
    assert len({bytes(r) for r in pks}) == 3
    cts, sss = kem.encapsulate_batch(pks)
    assert np.array_equal(kem.decapsulate_batch(sks, cts), sss)
    with pytest.raises(ValueError, match="public"):
        kem.encapsulate_batch(pks[:, :-1])
    with pytest.raises(ValueError, match="ciphertext"):
        kem.decapsulate_batch(sks, cts[:, 1:])


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        HQCKeyExchange(1)
    for name in NAMES:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            get_kem(name)


def test_batched_kem_serves_concurrent_clients():
    kem = get_kem("HQC-128", backend="cpu")

    async def run():
        with BatchedKEM(kem, max_wait_ms=20.0) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            agreed = await asyncio.gather(*(client() for _ in range(6)))
            out = agreed, bk.stats(), list(bk._enc.stats.batch_sizes)
            with pytest.raises(ValueError, match="public-key length"):
                await bk.encapsulate(b"short")
            return out

    agreed, stats, enc_sizes = asyncio.run(run())
    assert agreed == [True] * 6
    assert stats["keygen"]["ops"] == 6 and stats["encaps"]["ops"] == 6
    assert max(enc_sizes) > 1  # the clients' encaps shared a flush


def test_pinned_vector_is_record_0_of_the_vector_file():
    rec = json.loads((Path(__file__).parent / "vectors" / "hqc_128.json").read_text())["tests"][0]
    kat = health._HQC128_KAT
    for key in ("sk_seed", "sigma", "pk_seed", "m", "salt"):
        assert kat[key] == bytes.fromhex(rec[key])
    for key in ("pk_sha256", "sk_sha256", "ct_sha256"):
        assert kat[key] == rec[key]
    assert kat["ss_hex"] == rec["ss"]


def test_health_verdicts_and_a_corrupted_vector(monkeypatch):
    """HQC-128 runs the pinned vector alone, HQC-256 the vector and then its
    own round trip with its CPU twin; a corrupted vector fails the verdict,
    and a gate over a facade without a fallback then raises."""
    kem = get_kem("HQC-128", backend="cpu")
    kem.backend = "cuda"
    verdict = ensure_validated(kem)
    assert verdict.ok and verdict.detail == "HQC-128 KAT ok (keygen/encaps/decaps)"
    wide = get_kem("HQC-256", backend="cpu")
    wide.backend = "cuda"
    verdict = ensure_validated(wide, get_kem("HQC-256", backend="cpu"))
    assert verdict.ok and verdict.detail == (
        "HQC-128 KAT ok (keygen/encaps/decaps); HQC-256 device roundtrip ok + cpu agreement")
    kat = health._HQC128_KAT
    for key, why in (("ct_sha256", "encaps KAT mismatch (ct)"),
                     ("pk_sha256", "keygen KAT mismatch (pk/sk)"),
                     ("ss_hex", "encaps KAT mismatch (ss)")):
        bad = dict(kat)
        bad[key] = "00" * (len(bad[key]) // 2)
        monkeypatch.setattr(health, "_HQC128_KAT", bad)
        verdict = _check_hqc_kat(kem)
        assert not verdict.ok and verdict.detail == why
        assert not ensure_validated(wide, get_kem("HQC-256", backend="cpu")).ok
    with BatchedKEM(kem) as bk, pytest.raises(RuntimeError, match="device health HQC-128"):
        gate_facades(bk, cpu_kem=get_kem("HQC-128", backend="cpu"))


def test_a_wrong_twin_fails_a_wider_set(monkeypatch):
    wide = get_kem("HQC-192", backend="cpu")
    wide.backend = "cuda"

    class WrongTwin(HQCKeyExchange):
        def decapsulate_batch(self, secret_keys, ciphertexts):
            return super().decapsulate_batch(secret_keys, ciphertexts) ^ 1

    verdict = ensure_validated(wide, WrongTwin(3, backend="cpu"))
    assert not verdict.ok and "cpu twin decaps disagrees" in verdict.detail
