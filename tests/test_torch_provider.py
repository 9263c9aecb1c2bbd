"""The port's provider layer (quantum_resistant_p2p_tpu_torch.provider) on the
CPU backend: batching queue, operand cache, registry, entry point, and the
rule that the port imports nothing of JAX or the JAX package."""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.pyref import mlkem_ref as ref
from quantum_resistant_p2p_tpu_torch.entry import entry
from quantum_resistant_p2p_tpu_torch.provider import BatchedKEM, MLKEMKeyExchange, OpQueue
from quantum_resistant_p2p_tpu_torch.provider import get_kem, list_kems
from quantum_resistant_p2p_tpu_torch.provider.base import (KeyExchangeAlgorithm, next_pow2,
                                                           pad_rows)
from quantum_resistant_p2p_tpu_torch.provider.opcache import DeviceOperandCache
from quantum_resistant_p2p_tpu_torch.utils.wipe import wipe

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def kem768():
    return get_kem("ML-KEM-768", backend="cpu")


def test_batched_kem_serves_concurrent_clients(kem768):
    """32 concurrent clients, keygen -> encaps -> decaps each: every shared
    secret agrees and each wave of operations went out as one flush."""
    n = 32

    async def run():
        with BatchedKEM(kem768, max_batch=4096, max_wait_ms=20.0) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            agreed = await asyncio.gather(*(client() for _ in range(n)))
            return agreed, bk.stats()

    agreed, stats = asyncio.run(run())
    assert all(agreed)
    for op in ("keygen", "encaps", "decaps"):
        assert stats[op]["ops"] == n
        assert stats[op]["flushes"] < n, op  # coalesced
        assert stats[op]["max_batch_seen"] > 1, op


def test_single_key_encaps_uses_the_operand_cache():
    kem = MLKEMKeyExchange(1, backend="cpu")
    pk, sk = kem.generate_keypair_batch(1)
    pks = np.repeat(pk, 3, axis=0)
    for round_ in range(2):
        cts, sss = kem.encapsulate_batch(pks)
        assert np.array_equal(kem.decapsulate_batch(np.repeat(sk, 3, axis=0), cts), sss)
        assert kem.opcache.stats()["misses"] == 1 and kem.opcache.stats()["hits"] == round_
    # a mixed-key batch skips the cache and still agrees
    pk2, sk2 = kem.generate_keypair_batch(2)
    cts, sss = kem.encapsulate_batch(pk2)
    assert np.array_equal(kem.decapsulate_batch(sk2, cts), sss)
    assert kem.opcache.stats()["hits"] == 1


def test_provider_matches_pyref_scalar_api(kem768):
    pk, sk = kem768.generate_keypair()
    ct, ss = kem768.encapsulate(pk)
    assert ref.decaps(ref.MLKEM768, sk, ct) == ss == kem768.decapsulate(sk, ct)
    with pytest.raises(ValueError, match="public key must be 1184 bytes"):
        kem768.encapsulate(pk[:-1])


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the backend is available")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        get_kem("ML-KEM-768")  # the default backend is the GPU
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MLKEMKeyExchange(3)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        entry()


def test_registry_names_and_backends():
    assert list_kems() == ["FrodoKEM-1344-AES", "FrodoKEM-1344-SHAKE", "FrodoKEM-640-AES",
                           "FrodoKEM-640-SHAKE", "FrodoKEM-976-AES", "FrodoKEM-976-SHAKE",
                           "HQC-128", "HQC-192", "HQC-256",
                           "ML-KEM-1024", "ML-KEM-512", "ML-KEM-768"]
    with pytest.raises(KeyError):
        get_kem("Kyber768", backend="cpu")
    for bad in ("auto", "tpu"):
        with pytest.raises(ValueError, match="not supported"):
            get_kem("ML-KEM-768", backend=bad)
    assert get_kem("ML-KEM-1024", backend="cpu").ciphertext_len == ref.MLKEM1024.ct_len


def test_queue_failure_reaches_every_waiter():
    """A failing flush fails its futures; nothing serves them elsewhere."""
    calls = []

    def broken(items):
        calls.append(len(items))
        raise RuntimeError("device lost")

    async def run():
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            q = OpQueue(broken, ex, max_batch=8, max_wait_ms=5.0)
            return await asyncio.gather(*(q.submit(i) for i in range(5)),
                                        return_exceptions=True)

    out = asyncio.run(run())
    assert calls == [5]
    assert all(isinstance(r, RuntimeError) and str(r) == "device lost" for r in out)


def test_queue_splits_at_max_batch_and_batches_pad_to_pow2():
    seen = []

    def batch_fn(items):
        seen.append(len(items))
        return [i * 2 for i in items]

    async def run():
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            q = OpQueue(batch_fn, ex, max_batch=4, max_wait_ms=5.0)
            return await asyncio.gather(*(q.submit(i) for i in range(10))), q.stats

    out, stats = asyncio.run(run())
    assert out == [2 * i for i in range(10)]
    assert seen == [4, 4, 2] and stats.flushes == 3 and stats.max_batch_seen == 4
    rows = np.arange(6, dtype=np.uint8).reshape(3, 2)
    assert pad_rows(rows, 4).tolist() == [[0, 1], [2, 3], [4, 5], [4, 5]]
    assert [next_pow2(n) for n in (1, 2, 3, 5, 1024, 1025)] == [1, 2, 4, 8, 1024, 2048]


def test_malformed_item_fails_alone(kem768):
    async def run():
        with BatchedKEM(kem768, max_wait_ms=20.0) as bk:
            pk, _ = await bk.generate_keypair()
            return await asyncio.gather(bk.encapsulate(pk), bk.encapsulate(pk[:-3]),
                                        return_exceptions=True)

    good, bad = asyncio.run(run())
    assert isinstance(bad, ValueError) and len(good[0]) == ref.MLKEM768.ct_len


class _RecordingKEM(KeyExchangeAlgorithm):
    """Echo KEM that records the batch sizes the queue hands it."""

    name, public_key_len, secret_key_len, ciphertext_len = "echo", 4, 4, 4

    def __init__(self):
        self.sizes = []

    def generate_keypair_batch(self, n):
        self.sizes.append(n)
        rows = np.arange(4 * n, dtype=np.uint8).reshape(n, 4)
        return rows, rows.copy()

    def encapsulate_batch(self, public_keys):
        self.sizes.append(len(public_keys))
        return public_keys.copy(), public_keys.copy()

    def decapsulate_batch(self, secret_keys, ciphertexts):
        self.sizes.append(len(secret_keys))
        return ciphertexts.copy()


@pytest.mark.parametrize("floor,want", [(1, [4, 4, 4]), (8, [8, 8, 8]), (6, [8, 8, 8])])
def test_bucket_floor_pads_small_flushes(floor, want):
    """Three clients: each flush pads to the pow2 of 3, raised to the floor."""
    algo = _RecordingKEM()

    async def run():
        with BatchedKEM(algo, max_wait_ms=20.0, bucket_floor=floor) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            return await asyncio.gather(*(client() for _ in range(3)))

    assert all(asyncio.run(run()))
    assert algo.sizes == want


def test_entry_on_cpu_matches_pyref():
    fn, (eks, ms) = entry(device="cpu")
    assert eks.shape == (4096, 1184) and ms.shape == (4096, 32)
    eks, ms = eks[:3], ms[:3]
    ek_ref, _ = ref.keygen(ref.MLKEM768, bytes(range(32)), bytes(32))
    assert bytes(eks[2].numpy()) == ek_ref
    key, ct = fn(eks, ms)
    for i in range(3):
        k_ref, c_ref = ref.encaps(ref.MLKEM768, ek_ref, bytes(ms[i].numpy()))
        assert bytes(key[i].numpy()) == k_ref and bytes(ct[i].numpy()) == c_ref


def test_operand_cache_lru_and_zeroize():
    cache = DeviceOperandCache(capacity=2)
    entries = {k: {"t": torch.full((4,), 7, dtype=torch.int32)} for k in (b"a", b"b", b"c")}
    for k, v in entries.items():
        cache.put("ek", k, v)
    assert cache.lookup("ek", b"a") is None  # evicted
    assert cache.lookup("ek", b"c") is entries[b"c"]
    assert cache.stats() == {"entries": 2, "capacity": 2, "hits": 1, "misses": 1,
                             "evictions": 1}
    assert cache.zeroize() == 2 and cache.stats()["entries"] == 0
    assert int(entries[b"c"]["t"].sum()) == 0 and int(entries[b"a"]["t"].sum()) == 28


def test_wipe_zeroes_numpy_tensors_and_bytearrays():
    a = np.arange(1, 9, dtype=np.uint8)
    t = torch.ones(5, dtype=torch.uint8)
    b = bytearray(b"secret")
    ro = np.frombuffer(b"frozen", dtype=np.uint8)
    wipe(a, t, b, ro, b"immutable")
    assert not a.any() and not t.any() and b == bytearray(6)
    assert bytes(ro) == b"frozen"


def test_port_imports_no_jax():
    """Importing the port and running its CPU path loads neither jax nor
    any module of the JAX package (checked in a fresh interpreter, since
    this process has jax loaded already)."""
    code = (
        "import sys, numpy as np\n"
        "from quantum_resistant_p2p_tpu_torch.provider import get_kem, get_signature\n"
        "import quantum_resistant_p2p_tpu_torch.entry, quantum_resistant_p2p_tpu_torch.kem.mlkem_cuda\n"
        "import quantum_resistant_p2p_tpu_torch.sig.mldsa_cuda\n"
        "import quantum_resistant_p2p_tpu_torch.provider.sig_providers\n"
        "from quantum_resistant_p2p_tpu_torch.provider import BatchedSignature\n"
        "import quantum_resistant_p2p_tpu_torch.fused.mlkem_mldsa\n"
        "import quantum_resistant_p2p_tpu_torch.core.chacha, quantum_resistant_p2p_tpu_torch.core.chacha_cuda\n"
        "import quantum_resistant_p2p_tpu_torch.provider.aead_device\n"
        "import quantum_resistant_p2p_tpu_torch.provider.health\n"
        "import quantum_resistant_p2p_tpu_torch.provider.symmetric\n"
        "import quantum_resistant_p2p_tpu_torch.provider.batched, quantum_resistant_p2p_tpu_torch.obs\n"
        "from quantum_resistant_p2p_tpu_torch.obs import cost, flight, metrics, redaction, slo, trace\n"
        "from quantum_resistant_p2p_tpu_torch.faults import plan\n"
        "from quantum_resistant_p2p_tpu_torch.net import p2p_node\n"
        "from quantum_resistant_p2p_tpu_torch.app import message_store, resumption\n"
        "from quantum_resistant_p2p_tpu_torch.app import messaging, SecureMessaging\n"
        "from quantum_resistant_p2p_tpu_torch.obs import http\n"
        "http.TelemetryServer({'/x': http.json_route(dict)}).start().stop()\n"
        "eng = SecureMessaging(p2p_node.P2PNode('m', '127.0.0.1', 0), backend='cpu',\n"
        "                      sig_keypair=(b'p', b's'), telemetry_port=0)\n"
        "assert eng.metrics()['handshake_trips']['count'] == 0 and eng.slo_status()\n"
        "eng.close()\n"
        "from quantum_resistant_p2p_tpu_torch.provider import autotune, scheduler\n"
        "ring = resumption.STEKRing()\n"
        "ring.open_ticket(ring.seal_ticket(resumption.mint_fields(\n"
        "    'a', 'b', bytes(32), 'K', 'A', 'S', 1.0)))\n"
        "scheduler.DeviceProgramScheduler(shards=2).place()\n"
        "p2p_node.P2PNode('n', '127.0.0.1', 0)._hello()\n"
        "with trace.Tracer().span('s'):\n"
        "    cost.CostLedger(metrics.Registry('r')).device_time('q.enc', 0.1)\n"
        "from quantum_resistant_p2p_tpu_torch.provider import get_batched_aead\n"
        "dev = get_batched_aead('ChaCha20-Poly1305', backend='cpu')\n"
        "k, n = np.zeros((1, 32), np.uint8), np.zeros((1, 12), np.uint8)\n"
        "sealed = dev.seal_batch(k, n, [b'frame'], [b'ad'])\n"
        "assert dev.open_batch(k, n, sealed, [b'ad']) == [b'frame']\n"
        "kem = get_kem('ML-KEM-512', backend='cpu')\n"
        "pk, sk = kem.generate_keypair()\n"
        "ct, ss = kem.encapsulate(pk)\n"
        "assert kem.decapsulate(sk, ct) == ss\n"
        "dsa = get_signature('ML-DSA-44', backend='cpu')\n"
        "pk, sk = dsa.generate_keypair()\n"
        "assert dsa.verify(pk, b'm', dsa.sign(sk, b'm'))\n"
        "import quantum_resistant_p2p_tpu_torch.kem.frodo, quantum_resistant_p2p_tpu_torch.kem.frodo_cuda\n"
        "import quantum_resistant_p2p_tpu_torch.core.aes\n"
        "frodo = get_kem('FrodoKEM-640-SHAKE', backend='cpu')\n"
        "pk, sk = frodo.generate_keypair()\n"
        "ct, ss = frodo.encapsulate(pk)\n"
        "assert frodo.decapsulate(sk, ct) == ss\n"
        "import hashlib, torch\n"
        "from quantum_resistant_p2p_tpu_torch.core import sha256, sha512, sha256_cuda, sha512_cuda\n"
        "import quantum_resistant_p2p_tpu_torch.sig.sphincs, quantum_resistant_p2p_tpu_torch.sig.slhdsa_params\n"
        "msg = torch.tensor(list(b'abc'), dtype=torch.uint8)[None]\n"
        "assert bytes(sha256.sha256(msg)[0].tolist()) == hashlib.sha256(b'abc').digest()\n"
        "assert bytes(sha512.sha512(msg)[0].tolist()) == hashlib.sha512(b'abc').digest()\n"
        "assert get_signature('SPHINCS+-SHA2-128s-simple', backend='cpu').signature_len == 7856\n"
        "import quantum_resistant_p2p_tpu_torch.fleet\n"
        "from quantum_resistant_p2p_tpu_torch.fleet import (control, gateway, lease, manager,\n"
        "                                                   ring, stormlib)\n"
        "assert ring.HashRing(['a', 'b']).assign('k') in ('a', 'b')\n"
        "assert lease.LeaderLease('r', 0).role == lease.FOLLOWER\n"
        "assert manager.GatewayFleet(2, spawn='task').providers == 'real'\n"
        "assert gateway.DEFAULTS['backend'] == 'cuda' and control.GW_HELLO\n"
        "stormlib.register_storm_providers()\n"
        "assert get_kem('STORM-KEM', backend='cuda').backend == 'cuda'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'quantum_resistant_p2p_tpu'\n"
        "             or m.startswith('quantum_resistant_p2p_tpu.'))\n"
        "assert any(m.startswith('quantum_resistant_p2p_tpu_torch') for m in sys.modules)\n"
        "print('LOADED', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_gateway_entry_point_refuses_bad_arguments_without_jax():
    """``python -m quantum_resistant_p2p_tpu_torch.fleet.gateway`` with bad
    arguments prints its usage and exits 2, having imported neither jax
    nor any module of the JAX package (the interpreter's import log)."""
    out = subprocess.run([sys.executable, "-X", "importtime", "-m",
                          "quantum_resistant_p2p_tpu_torch.fleet.gateway", "{}", "extra"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "usage: python -m quantum_resistant_p2p_tpu_torch.fleet.gateway" in out.stderr
    imported = [line.rsplit("|", 1)[1].strip() for line in out.stderr.splitlines()
                if line.startswith("import time:") and line.count("|") == 2]
    assert "quantum_resistant_p2p_tpu_torch.fleet" in imported
    bad = [m for m in imported if m == "jax" or m.startswith("jax.")
           or m == "quantum_resistant_p2p_tpu" or m.startswith("quantum_resistant_p2p_tpu.")]
    assert bad == []
