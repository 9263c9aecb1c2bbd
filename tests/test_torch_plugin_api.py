"""The port's algorithm-plugin boundary against the JAX package's, on the CPU.

* ``CryptoAlgorithm``'s metadata (``is_using_mock``, ``actual_variant``,
  ``get_security_info``) of every registered KEM, signature and AEAD equals
  the reference's ("cpu" on both sides), modulo the last clause of the
  description, which names what runs the backend; on "cuda" the dict names
  "cuda" where the reference's "tpu" provider names "tpu".
* ``opcache_size`` on ``MLKEMKeyExchange``, ``FrodoKEMKeyExchange`` and
  ``MLDSASignature``: the reference's default of 8, and 0 keeps no operand
  cache and gives the same bytes under the same draws.
* ``DeviceOperandCache.clear()`` returns how many entries it released, as
  the reference's does, and ``zeroize`` goes through it.
* ``register_kem`` / ``register_signature`` take the backends a plugin
  supports; ``get_kem`` / ``get_signature`` raise ``ValueError`` for any
  other, with the reference's message.
* ``python -m quantum_resistant_p2p_tpu_torch.demo --backend cpu``, the
  counterpart of ``examples/two_node_demo.py``, runs every step.

Tolerance: exact.  PyTorch runs on one thread; the module clears JAX's
caches at its end (ROADMAP C1).
"""

from __future__ import annotations

import gc
import inspect
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.provider import kem_providers as ref_kem_providers
from quantum_resistant_p2p_tpu.provider import opcache as ref_opcache
from quantum_resistant_p2p_tpu.provider import registry as ref_registry
from quantum_resistant_p2p_tpu.provider import sig_providers as ref_sig_providers
from quantum_resistant_p2p_tpu_torch import demo
from quantum_resistant_p2p_tpu_torch.provider import (kem_providers, opcache, registry,
                                                      sig_providers)
from quantum_resistant_p2p_tpu_torch.provider.base import (BACKENDS, KeyExchangeAlgorithm,
                                                           SignatureAlgorithm)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_release():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def registries(monkeypatch):
    """Both registries as they were after the test."""
    for mod in (registry, ref_registry):
        for table in ("_KEMS", "_SIGS"):
            monkeypatch.setattr(mod, table, dict(getattr(mod, table)))


def _same_but_backend(port: dict, ref: dict, port_backend: str, ref_backend: str) -> None:
    assert port.keys() == ref.keys()
    assert port["backend"] == port_backend and ref["backend"] == ref_backend
    assert port["display_name"] == ref["display_name"].replace(ref_backend, port_backend)
    # the last clause names what runs the backend: JAX/TPU or the native
    # C++ core there, PyTorch here
    assert port["description"].rsplit(", ", 1)[0] == ref["description"].rsplit(", ", 1)[0]
    assert port["description"].endswith(" backend") == ref["description"].endswith(" backend")
    for key in ("name", "security_level", "mock"):
        assert port[key] == ref[key]


@pytest.mark.parametrize("kind", ["KEM", "signature"])
def test_security_info_matches_the_reference(kind):
    get, ref_get, names = ((registry.get_kem, ref_registry.get_kem, registry.list_kems())
                           if kind == "KEM" else
                           (registry.get_signature, ref_registry.get_signature,
                            registry.list_signatures()))
    assert len(names) == (12 if kind == "KEM" else 9)
    for name in names:
        port, ref = get(name, "cpu"), ref_get(name, "cpu")
        assert port.is_using_mock is False and ref.is_using_mock is False
        assert port.actual_variant == ref.actual_variant == name
        _same_but_backend(port.get_security_info(), ref.get_security_info(), "cpu", "cpu")
        assert port.description.endswith("plain PyTorch CPU backend")


@pytest.mark.parametrize("name", ["AES-256-GCM", "ChaCha20-Poly1305"])
def test_aead_security_info_matches_the_reference(name):
    port, ref = registry.get_symmetric(name), ref_registry.get_symmetric(name)
    assert port.get_security_info() == ref.get_security_info()
    assert port.actual_variant == name and port.is_using_mock is False


@pytest.mark.parametrize("cls,ref_cls,args", [
    (kem_providers.MLKEMKeyExchange, ref_kem_providers.MLKEMKeyExchange, (3,)),
    (kem_providers.FrodoKEMKeyExchange, ref_kem_providers.FrodoKEMKeyExchange, (1,)),
    (kem_providers.HQCKeyExchange, ref_kem_providers.HQCKeyExchange, (5,)),
    (sig_providers.MLDSASignature, ref_sig_providers.MLDSASignature, (2,)),
    (sig_providers.SPHINCSSignature, ref_sig_providers.SPHINCSSignature, (3,)),
])
def test_device_security_info_names_cuda_where_the_reference_names_tpu(cls, ref_cls, args,
                                                                       monkeypatch):
    """A "cuda" provider's dict (built here with the device check stubbed:
    nothing runs) against the reference's "tpu" one (built without its
    JAX programs)."""
    for mod in (kem_providers, sig_providers):
        monkeypatch.setattr(mod, "require_device", lambda backend: torch.device("cpu"))
    port = cls(*args, backend="cuda")
    ref = ref_cls.__new__(ref_cls)
    ref_dict = ref_cls(*args, backend="cpu").get_security_info()
    ref.__dict__.update(name=ref_dict["name"], security_level=ref_dict["security_level"],
                        backend="tpu", display_name=ref_dict["display_name"].replace("cpu", "tpu"),
                        description=ref_dict["description"])
    _same_but_backend(port.get_security_info(), ref.get_security_info(), "cuda", "tpu")
    assert port.description.endswith("batched PyTorch/CUDA backend")


@pytest.mark.parametrize("cls,ref_cls", [
    (kem_providers.MLKEMKeyExchange, ref_kem_providers.MLKEMKeyExchange),
    (kem_providers.FrodoKEMKeyExchange, ref_kem_providers.FrodoKEMKeyExchange),
    (sig_providers.MLDSASignature, ref_sig_providers.MLDSASignature),
])
def test_opcache_size_default_and_capacity(cls, ref_cls):
    want = inspect.signature(ref_cls).parameters["opcache_size"].default
    assert inspect.signature(cls).parameters["opcache_size"].default == want == 8
    assert cls(backend="cpu").opcache.capacity == 8
    assert cls(backend="cpu", opcache_size=3).opcache.capacity == 3
    assert cls(backend="cpu", opcache_size=0).opcache is None


def _pinned(monkeypatch, seed: int) -> None:
    monkeypatch.setattr(os, "urandom", random.Random(seed).randbytes)


@pytest.mark.parametrize("name", ["ML-KEM-768", "FrodoKEM-640-SHAKE"])
def test_no_operand_cache_gives_the_same_kem_bytes(name, monkeypatch):
    """Two encaps to one key (a miss, then a hit) with the default cache
    and with ``opcache_size=0``: the same ciphertexts and secrets."""
    level = 3 if name == "ML-KEM-768" else 1
    make = ((lambda size: kem_providers.MLKEMKeyExchange(level, "cpu", opcache_size=size))
            if name == "ML-KEM-768" else
            (lambda size: kem_providers.FrodoKEMKeyExchange(level, "cpu", use_aes=False,
                                                             opcache_size=size)))
    out = {}
    for size in (8, 0):
        kem = make(size)
        _pinned(monkeypatch, 21)
        pk, sk = kem.generate_keypair()
        sent = [kem.encapsulate(pk) for _ in range(2)]
        assert all(kem.decapsulate(sk, ct) == ss for ct, ss in sent)
        out[size] = (pk, sent)
        if size:
            assert kem.opcache.stats()["hits"] == 1 and kem.opcache.stats()["misses"] == 1
        else:
            assert kem.opcache is None
    assert out[8] == out[0]


def test_no_operand_cache_gives_the_same_signature_bytes(monkeypatch):
    msgs = [b"first", b"second"]
    rnd = [bytes(range(32)), bytes(range(32, 64))]
    out = {}
    for size in (8, 0):
        dsa = sig_providers.MLDSASignature(2, "cpu", opcache_size=size)
        _pinned(monkeypatch, 22)
        pk, sk = dsa.generate_keypair()
        sks = np.frombuffer(sk, np.uint8)[None]
        sigs = [dsa.sign_batch(sks, [m], rnd=[r])[0] for m, r in zip(msgs, rnd)]
        oks = [dsa.verify(pk, m, s) for m, s in zip(msgs, sigs)]
        out[size] = (pk, sigs, oks)
        assert (dsa.opcache is None) == (size == 0)
    assert out[8] == out[0] and out[0][2] == [True, True]


def test_opcache_clear_returns_the_count_and_zeroize_goes_through_it(monkeypatch):
    port, ref = opcache.DeviceOperandCache(), ref_opcache.DeviceOperandCache()
    for cache in (port, ref):
        cache.put("sk", b"a", {"k": torch.ones(4, dtype=torch.int32)})
        cache.put("pk", b"b", {"k": torch.ones(4, dtype=torch.int32)})
    held = port.lookup("sk", b"a")["k"]
    assert port.clear() == ref.clear() == 2
    assert port.stats()["entries"] == 0 == len(ref)
    assert not held.any()  # zeroed in place before it was dropped
    assert port.clear() == ref.clear() == 0
    calls = []
    monkeypatch.setattr(port, "clear", lambda: calls.append(1) or 5)
    assert port.zeroize() == 5 and calls == [1]


def test_builtin_plugins_register_both_backends():
    for table in (registry._KEMS, registry._SIGS):
        assert table and all(backends == BACKENDS for _, backends in table.values())


@pytest.mark.parametrize("kind", ["KEM", "signature"])
def test_a_backend_outside_a_plugins_list_raises(kind, registries):
    """A plugin registered for "cpu" alone: "cuda" (and any unknown name)
    raises ValueError with the reference's message; "cpu" builds it."""
    base = KeyExchangeAlgorithm if kind == "KEM" else SignatureAlgorithm

    class Toy(base):
        name = f"TOY-{kind}"
        generate_keypair_batch = encapsulate_batch = decapsulate_batch = None
        generate_keypair = sign = verify = None

        def __init__(self, backend):
            self.backend = backend

    register, get, ref_register, ref_get = (
        (registry.register_kem, registry.get_kem, ref_registry.register_kem,
         ref_registry.get_kem) if kind == "KEM" else
        (registry.register_signature, registry.get_signature, ref_registry.register_signature,
         ref_registry.get_signature))
    register(Toy.name, lambda backend, devices=0: Toy(backend), ("cpu",))
    ref_register(Toy.name, lambda backend, devices=0: Toy(backend), ("cpu",))
    assert get(Toy.name, "cpu").backend == "cpu"
    for backend in ("cuda", "tpu"):
        with pytest.raises(ValueError) as port_err:
            get(Toy.name, backend)
        with pytest.raises(ValueError) as ref_err:
            ref_get(Toy.name, backend)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="not supported"):
        get("ML-KEM-768" if kind == "KEM" else "ML-DSA-65", "tpu")


def test_the_demo_runs_every_step_on_the_cpu(capsys):
    """The reference demo's steps [1]-[9], each passing."""
    assert demo.main(["--backend", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [line.split("]")[0] + "]" for line in lines if line.startswith("[")]
    assert steps == [f"[{i}]" for i in range(1, 10)]
    assert "handshake (ML-KEM-768 + ML-DSA-65): OK" in lines[1]
    assert lines[-1].endswith("every step passed")


def test_the_demo_runs_as_a_module_and_defaults_to_cuda():
    """``python -m``, with its help naming both backends; without a GPU its
    default ("cuda") raises (no fallback to the CPU)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "quantum_resistant_p2p_tpu_torch.demo", "--help"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "{cuda,cpu}" in out.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            demo.main([])
