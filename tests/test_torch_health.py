"""The port's health-verdict cache and gate (quantum_resistant_p2p_tpu_torch
.provider.health), on the CPU.

The marker paths are the reference's for the same family and fingerprint;
the fingerprint names its parts and changes with a byte of a kernel
source; negative verdicts are never cached; ``QRP2P_HEALTH_GATE=0`` skips
the gate as in the reference; and ``gate_facades`` takes its CPU twins
from a facade's fallbacks, quarantines the breaker (every shard's, under a
scheduler) of a facade with a fallback armed on a failed verdict, and
raises for a facade without one.  The "cpu" providers stand in for the
device: a probe on the CPU is never cached, so the cache round trip marks
the CPU cacheable for the test.
"""

from __future__ import annotations

import shutil

import pytest
import torch

from quantum_resistant_p2p_tpu.provider import health as ref_health
from quantum_resistant_p2p_tpu_torch.obs import flight
from quantum_resistant_p2p_tpu_torch.provider import (BatchedAEAD, BatchedFused, BatchedKEM,
                                                      BatchedSignature, get_batched_aead,
                                                      get_fused, get_kem, get_signature,
                                                      get_symmetric, health, init_pk_offset,
                                                      resp_ct_offset)
from quantum_resistant_p2p_tpu_torch.provider.scheduler import DeviceProgramScheduler
from quantum_resistant_p2p_tpu_torch.utils import cuda as cuda_build


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread: xdist workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path / "health"))
    return tmp_path / "health"


def test_marker_paths_match_the_reference(cache_dir):
    fp = health.env_fingerprint("cpu")
    for family in ("ML-KEM-768", "aead:ChaCha20-Poly1305", "fused:ML-KEM-768+ML-DSA-65@58"):
        assert health._marker(family, fp) == ref_health._marker(family, fp)
        assert health._marker(family, fp).parent == cache_dir


def test_default_cache_dir_is_under_the_ignored_build_dir(monkeypatch):
    monkeypatch.delenv("QRP2P_HEALTH_CACHE", raising=False)
    assert health._cache_dir() == cuda_build.BUILD_DIR.parent / "health_cache"
    assert health._cache_dir().parent.name == "build"


def test_fingerprint_parts_and_a_changed_kernel_source(tmp_path, monkeypatch):
    """The fingerprint names the torch and CUDA versions, the device, the
    probe version and the source digest; flipping one byte of a copied
    ``csrc/`` file, then of a copied ``kem/mlkem_cuda.py`` (the Python
    that feeds the kernels), or changing the nvcc flags changes it."""
    fp = health.env_fingerprint("cpu")
    parts = dict(p.split("=", 1) for p in fp.split("|"))
    assert parts == {"torch": torch.__version__, "cuda": str(torch.version.cuda), "dev": "cpu",
                     "cc": "-", "probe": "1", "src": health.source_digest()}
    copy = tmp_path / "pkg"
    shutil.copytree(health.PACKAGE_ROOT, copy, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(health, "PACKAGE_ROOT", copy)
    assert health.env_fingerprint("cpu") == fp
    seen = [fp]
    for rel in ("csrc/chacha.cu", "kem/mlkem_cuda.py"):
        src = copy / rel
        data = bytearray(src.read_bytes())
        data[len(data) // 2] ^= 1
        src.write_bytes(bytes(data))
        changed = health.env_fingerprint("cpu")
        assert changed not in seen and changed.rsplit("|", 1)[0] == fp.rsplit("|", 1)[0]
        seen.append(changed)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-G",))
    assert health.env_fingerprint("cpu") not in seen


def test_read_and_write_follow_the_reference_policy(cache_dir):
    """A positive verdict round-trips as ``cached``; a negative one is not
    written; a marker of another fingerprint or family is not trusted; a
    corrupt marker reads as a miss."""
    fp = health.env_fingerprint("cpu")
    health._write_cached("ML-KEM-768", fp, health.HealthVerdict("ML-KEM-768", False, "bad"))
    assert not cache_dir.exists() or not list(cache_dir.iterdir())
    health._write_cached("ML-KEM-768", fp, health.HealthVerdict("ML-KEM-768", True, "good"))
    got = health._read_cached("ML-KEM-768", fp)
    assert got == health.HealthVerdict("ML-KEM-768", True, "good", cached=True)
    assert ref_health._read_cached("ML-KEM-768", fp).detail == "good"  # the same file format
    assert health._read_cached("ML-KEM-768", fp + "x") is None
    assert health._read_cached("ML-DSA-65", fp) is None
    health._marker("ML-KEM-768", fp).write_text("{not json")
    assert health._read_cached("ML-KEM-768", fp) is None


@pytest.fixture
def facades():
    kem = get_kem("ML-KEM-512", backend="cpu")
    dsa = get_signature("ML-DSA-44", backend="cpu")
    kem768, dsa65 = get_kem("ML-KEM-768", backend="cpu"), get_signature("ML-DSA-65",
                                                                          backend="cpu")
    aead, scalar = get_batched_aead("ChaCha20-Poly1305", backend="cpu"), get_symmetric(
        "ChaCha20-Poly1305")
    pk_off = init_pk_offset("ML-KEM-768", "ChaCha20-Poly1305")
    made = (BatchedKEM(kem, fallback=kem), BatchedSignature(dsa, fallback=dsa),
            BatchedFused(get_fused(kem768, dsa65), pk_off, resp_ct_offset(),
                         fallback_kem=kem768, fallback_sig=dsa65),
            BatchedAEAD(aead, scalar, fallback=scalar))
    yield made
    for f in made:
        f.close()


def _as_device(facades):
    """Mark the "cpu" providers as if they ran on a card, so the gate
    probes them instead of passing a CPU backend."""
    for f in facades:
        f.algo.backend = "cuda"


def test_gate_caches_positive_verdicts_and_reads_them_back(monkeypatch, cache_dir, facades):
    """CPU marked cacheable: the first gate probes every facade (cached
    false) with the twins taken from their fallbacks, the second reads
    every verdict back (cached true); the flight events say which."""
    rec = flight.FlightRecorder()
    monkeypatch.setattr(flight, "RECORDER", rec)
    monkeypatch.setattr(health, "_cacheable", lambda device: True)
    _as_device(facades)
    first = health.gate_facades(*facades)
    second = health.gate_facades(*facades)
    assert [v.ok for v in first + second] == [True] * 8
    assert [v.cached for v in first] == [False] * 4 and [v.cached for v in second] == [True] * 4
    assert [v.family for v in first] == [v.family for v in second] == [
        "ML-KEM-512", "ML-DSA-44", f"fused:ML-KEM-768+ML-DSA-65@{facades[2].pk_off}",
        "aead:ChaCha20-Poly1305"]
    assert "cpu agreement" in first[0].detail and "scalar agreement" in first[3].detail
    assert len(list(cache_dir.iterdir())) == 4
    assert [e["cached"] for e in rec.snapshot() if e["kind"] == "health_ok"] == [False] * 4 + \
        [True] * 4


def test_cpu_verdicts_are_never_cached(cache_dir, facades):
    bk, ba = facades[0], facades[3]
    _as_device([bk, ba])
    for _ in range(2):
        assert [(v.ok, v.cached) for v in health.gate_facades(bk, ba)] == [(True, False)] * 2
    assert not cache_dir.exists()


def test_negative_verdicts_are_not_cached(monkeypatch, cache_dir, facades):
    monkeypatch.setattr(health, "_cacheable", lambda device: True)
    bk = facades[0]
    _as_device([bk])
    monkeypatch.setattr(bk.algo, "decapsulate", lambda sk, ct: b"\x00" * 32)
    for _ in range(2):
        (verdict,) = health.gate_facades(bk)
        assert not verdict.ok and not verdict.cached and "decaps" in verdict.detail
    assert not cache_dir.exists() or not list(cache_dir.iterdir())


@pytest.mark.parametrize("value", ["0", "1"])
def test_gate_enabled_matches_the_reference(monkeypatch, value, facades):
    monkeypatch.setenv("QRP2P_HEALTH_GATE", value)
    assert health.gate_enabled() == ref_health.gate_enabled() == (value == "1")
    _as_device(facades)
    verdicts = health.gate_facades(facades[0], facades[3])
    assert len(verdicts) == (2 if value == "1" else 0)
    assert ref_health.gate_facades(None) == []


def _broken_aead(ba):
    ba.algo.seal_batch = lambda *a: [b"\x00" * 130]


def test_failed_verdict_with_a_fallback_quarantines_the_breaker(monkeypatch, facades):
    """A wrong device seal: the AEAD facade's breaker is quarantined (the
    CPU serves it), the verdicts are returned, the others stay closed."""
    rec = flight.FlightRecorder()
    monkeypatch.setattr(flight, "RECORDER", rec)
    bk, _, _, ba = facades
    _broken_aead(ba)
    verdicts = health.gate_facades(bk, ba)
    assert [v.ok for v in verdicts] == [True, False]
    assert ba.breaker.state == "quarantined" and bk.breaker.state == "closed"
    kinds = [e["kind"] for e in rec.snapshot() if e["kind"].startswith(("health", "breaker"))]
    assert kinds == ["health_ok", "health_failed", "breaker_quarantined"]


def test_failed_verdict_under_a_scheduler_quarantines_every_shard():
    sched = DeviceProgramScheduler(shards=3)
    aead, scalar = get_batched_aead("ChaCha20-Poly1305", backend="cpu"), get_symmetric(
        "ChaCha20-Poly1305")
    ba = BatchedAEAD(aead, scalar, scheduler=sched, fallback=scalar)
    _broken_aead(ba)
    (verdict,) = health.gate_facades(ba)
    assert not verdict.ok
    assert [s.breaker.state for s in sched.shards] == ["quarantined"] * 3
    sched.close()


def test_failed_verdict_without_a_fallback_raises():
    """No fallback armed: the gate raises, a deliberate difference from
    the reference, which only logs (no failed device may serve)."""
    with BatchedAEAD(get_batched_aead("ChaCha20-Poly1305", backend="cpu"),
                     get_symmetric("ChaCha20-Poly1305")) as ba:
        _broken_aead(ba)
        with pytest.raises(RuntimeError, match="device health aead:ChaCha20-Poly1305"):
            health.gate_facades(ba)
        assert ba.breaker.state == "closed"


def test_explicit_twins_still_win_and_a_fused_facade_needs_them():
    kem768, dsa65 = get_kem("ML-KEM-768", backend="cpu"), get_signature("ML-DSA-65",
                                                                          backend="cpu")
    pk_off = init_pk_offset("ML-KEM-768", "ChaCha20-Poly1305")
    with BatchedFused(get_fused(kem768, dsa65), pk_off, resp_ct_offset()) as bf:
        with pytest.raises(ValueError, match="cpu_kem and cpu_sig"):
            health.gate_facades(bf)
        (verdict,) = health.gate_facades(bf, cpu_kem=kem768, cpu_sig=dsa65)
        assert verdict.ok and verdict.family == f"fused:ML-KEM-768+ML-DSA-65@{pk_off}"


def test_hqc_gate_caches_and_a_failed_vector_quarantines(monkeypatch, cache_dir):
    """HQC facades through the gate: HQC-128 on its pinned vector, HQC-192
    on the vector and its round trip with the twin taken from the facade's
    fallback, both cached and read back on a GPU; a pinned vector that no
    longer matches fails HQC-128's verdict and quarantines its breaker (a
    fallback is armed), while the cached HQC-192 verdict is read back."""
    monkeypatch.setattr(health, "_cacheable", lambda device: True)
    kem128, kem192 = get_kem("HQC-128", backend="cpu"), get_kem("HQC-192", backend="cpu")
    made = [BatchedKEM(kem, fallback=get_kem(kem.name, backend="cpu"))
            for kem in (kem128, kem192)]
    try:
        _as_device(made)
        first = health.gate_facades(*made)
        assert [(v.family, v.ok, v.cached) for v in first] == [
            ("HQC-128", True, False), ("HQC-192", True, False)]
        assert first[1].detail.endswith("HQC-192 device roundtrip ok + cpu agreement")
        assert [v.cached for v in health.gate_facades(*made)] == [True, True]
        for marker in cache_dir.iterdir():
            if '"HQC-128"' in marker.read_text():
                marker.unlink()
        bad = dict(health._HQC128_KAT, ss_hex="00" * 64)
        monkeypatch.setattr(health, "_HQC128_KAT", bad)
        verdicts = health.gate_facades(*made)
        assert [(v.ok, v.cached) for v in verdicts] == [(False, False), (True, True)]
        assert verdicts[0].detail == "encaps KAT mismatch (ss)"
        assert made[0].breaker.state == "quarantined" and made[1].breaker.state == "closed"
    finally:
        for f in made:
            f.close()
