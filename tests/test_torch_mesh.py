"""The port's split of one batch across devices (quantum_resistant_p2p_tpu_torch.parallel
and provider.base.mesh_dispatch) against the JAX package's, on the CPU.

The JAX side runs on the eight virtual CPU devices that tests/conftest.py
pins; the port's side on a ``Mesh`` of eight CPU devices (the explicit
device list is the port's seam for a split without eight GPUs).  Batches
not divisible by the mesh (11) and smaller than it (3) must give the bytes
of the unsplit call on both sides, and the same bytes across the two
packages, with the host randomness pinned where a provider draws it.
Tolerance: exact.

The JAX package's ``sliced_dispatch`` test has no counterpart: its step is
the TPU's per-device batch cap, which the port does not have.
"""

import asyncio
import gc
import os

import jax
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.kem import mlkem as ref_mlkem
from quantum_resistant_p2p_tpu.parallel import mesh as ref_mesh
from quantum_resistant_p2p_tpu.provider import get_kem as ref_get_kem
from quantum_resistant_p2p_tpu.provider import get_signature as ref_get_signature
from quantum_resistant_p2p_tpu.provider.base import mesh_dispatch as ref_mesh_dispatch
from quantum_resistant_p2p_tpu.pyref import mldsa_ref
from quantum_resistant_p2p_tpu_torch import entry
from quantum_resistant_p2p_tpu_torch.app import messaging as msg
from quantum_resistant_p2p_tpu_torch.kem import mlkem
from quantum_resistant_p2p_tpu_torch.net.p2p_node import P2PNode
from quantum_resistant_p2p_tpu_torch.parallel import (Mesh, make_mesh, make_sharded_handshake,
                                                      shard_devices)
from quantum_resistant_p2p_tpu_torch.provider import get_kem, get_signature, scheduler
from quantum_resistant_p2p_tpu_torch.provider.base import (DeviceIO, make_provider_mesh,
                                                           mesh_dispatch, shard_batch)

NDEV = 8
RNG = np.random.default_rng(20261018)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_release_jax():
    """One PyTorch CPU thread (xdist workers share the cores); the JAX
    programs this module compiled are dropped when it ends, since each
    holds memory maps in the process (ROADMAP C1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def cpu_mesh():
    return Mesh([torch.device("cpu")] * NDEV)


@pytest.fixture(scope="module")
def jax_mesh():
    return ref_mesh.make_mesh(NDEV)


def _rows(n: int, width: int = 32) -> np.ndarray:
    return RNG.integers(0, 256, (n, width), dtype=np.uint8)


def _split(provider, mesh):
    """``provider`` with its batches split across ``mesh``."""
    provider._mesh = mesh
    return provider


def _pinned(seed: int):
    """A stand-in for ``os.urandom`` that draws from a fixed seed."""
    rng = np.random.default_rng(seed)
    return lambda n: rng.bytes(n)


def _ml_kem_512_fns():
    return mlkem.get("ML-KEM-512"), ref_mlkem.get("ML-KEM-512")


def _unsplit(fn, *arrays):
    out = fn(*(torch.tensor(a) for a in arrays))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def test_mesh_dispatch_bit_exact_vs_unsplit_and_jax(cpu_mesh, jax_mesh):
    """ML-KEM-512 keygen, encaps and decaps at 11 rows on 8 devices (not
    divisible): the port's split == the port's unsplit call == the JAX
    package's split."""
    (kg, enc, dec), (jkg, jenc, jdec) = _ml_kem_512_fns()
    d, z, m = _rows(11), _rows(11), _rows(11)
    ek, dk = mesh_dispatch(kg, cpu_mesh, d, z)
    for want in (_unsplit(kg, d, z), ref_mesh_dispatch(jkg, jax_mesh, d, z)):
        assert np.array_equal(ek, want[0]) and np.array_equal(dk, want[1])
    key, ct = mesh_dispatch(enc, cpu_mesh, ek, m)
    for want in (_unsplit(enc, ek, m), ref_mesh_dispatch(jenc, jax_mesh, ek, m)):
        assert np.array_equal(key, want[0]) and np.array_equal(ct, want[1])
    key2 = mesh_dispatch(dec, cpu_mesh, dk, ct)
    assert np.array_equal(key2, key)
    assert np.array_equal(key2, ref_mesh_dispatch(jdec, jax_mesh, dk, ct))


def test_mesh_dispatch_batch_smaller_than_mesh(cpu_mesh, jax_mesh):
    """3 rows on 8 devices: padded to one row a device, trimmed back, the
    unsplit call's and the JAX package's bytes."""
    (kg, _, _), (jkg, _, _) = _ml_kem_512_fns()
    d, z = _rows(3), _rows(3)
    ek, dk = mesh_dispatch(kg, cpu_mesh, d, z)
    for want in (_unsplit(kg, d, z), ref_mesh_dispatch(jkg, jax_mesh, d, z)):
        assert np.array_equal(ek, want[0]) and np.array_equal(dk, want[1])


def test_shard_batch_pads_with_the_last_row_and_keeps_order():
    mesh = Mesh(["cpu"] * 4)
    a = np.arange(10, dtype=np.uint8).reshape(5, 2)
    shares = shard_batch(mesh, a)
    assert [s.shape for s in shares] == [(2, 2)] * 4
    assert torch.cat(shares).tolist() == a.tolist() + [[8, 9]] * 3
    two = shard_batch(mesh, a, a[:, :1])
    assert len(two) == 2 and torch.equal(torch.cat(two[1]), torch.cat(shares)[:, :1])
    with pytest.raises(ValueError, match="empty batch"):
        shard_batch(mesh, a[:0])
    with pytest.raises(ValueError, match="batches of 5 and 4"):
        shard_batch(mesh, a, a[:4])


def test_mesh_dispatch_runs_an_empty_batch_whole_and_wipes_its_copies():
    """An empty batch runs once, unsplit, on the mesh's first device; every
    device copy a split makes (inputs and outputs) is zeroed once its host
    copy is gathered."""
    mesh = Mesh(["cpu"] * 3)
    seen = []

    def fn(x):
        seen.append(x)
        out = x + 1
        seen.append(out)
        return out

    assert mesh_dispatch(fn, mesh, np.zeros((0, 4), np.uint8)).shape == (0, 4)
    assert len(seen) == 2
    seen.clear()
    x = np.full((5, 4), 7, np.uint8)
    assert (mesh_dispatch(fn, mesh, x) == 8).all()
    assert len(seen) == 6 and not any(t.any() for t in seen)
    assert (x == 7).all()


def test_provider_dispatch_runs_whole_without_a_mesh_and_wipes_its_copies(cpu_mesh):
    """DeviceIO._dispatch: with no mesh a batch runs once, whole, on the
    provider's device, and its device copies are zeroed once read back;
    with a mesh it is mesh_dispatch's split, with the same bytes."""
    io = DeviceIO()
    io.device = torch.device("cpu")
    seen = []

    def fn(x, y):
        seen.extend([x, y])
        out = (x + y, x ^ y)
        seen.extend(out)
        return out

    x, y = (RNG.integers(0, 256, (11, 4), dtype=np.uint8) for _ in range(2))
    whole = io._dispatch(fn, x, y)
    assert len(seen) == 4 and not any(t.any() for t in seen)
    assert np.array_equal(whole[0], x + y) and np.array_equal(whole[1], x ^ y)
    io._mesh = cpu_mesh
    seen.clear()
    split = io._dispatch(fn, x, y)
    assert len(seen) == 4 * NDEV and all(np.array_equal(a, b) for a, b in zip(split, whole))


def test_kem_provider_mesh_bit_exact_vs_unsplit_and_jax(cpu_mesh, monkeypatch):
    """The ML-KEM-512 provider split across 8 devices against the unsplit
    port provider and the JAX package's provider with ``devices=8``, with
    ``os.urandom`` pinned in both packages' provider modules: the same
    keys, ciphertexts and secrets at 11 rows; decaps agrees."""
    split = _split(get_kem("ML-KEM-512", backend="cpu"), cpu_mesh)
    whole = get_kem("ML-KEM-512", backend="cpu")
    ref = ref_get_kem("ML-KEM-512", backend="tpu", devices=NDEV)
    assert ref._mesh is not None and whole._mesh is None
    outs = []
    for provider in (split, whole, ref):
        monkeypatch.setattr(os, "urandom", _pinned(7))
        eks, dks = provider.generate_keypair_batch(11)
        cts, keys = provider.encapsulate_batch(eks)
        outs.append([np.asarray(x) for x in (eks, dks, cts, keys)])
    for other in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(outs[0], other))
    eks, dks, cts, keys = outs[0]
    assert np.array_equal(split.decapsulate_batch(dks, cts), keys)
    assert split.opcache.stats()["entries"] == 0  # a split provider caches nothing


def test_hqc_provider_split_bit_exact(monkeypatch):
    """HQC-128 split across 2 devices gives the unsplit provider's bytes
    under pinned randomness at 3 rows, and decaps agrees (on the card HQC
    runs each batch whole: it is off the split's main path)."""
    mesh = Mesh(["cpu"] * 2)
    outs = []
    for provider in (_split(get_kem("HQC-128", backend="cpu"), mesh),
                     get_kem("HQC-128", backend="cpu")):
        monkeypatch.setattr(os, "urandom", _pinned(11))
        pks, sks = provider.generate_keypair_batch(3)
        cts, sss = provider.encapsulate_batch(pks)
        outs.append((pks, sks, cts, sss, provider.decapsulate_batch(sks, cts)))
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    assert np.array_equal(outs[0][3], outs[0][4])


def test_frodo_provider_split_encaps_bit_exact(monkeypatch):
    """FrodoKEM-640-SHAKE encaps split across 2 devices gives the unsplit
    provider's ciphertexts and secrets under pinned randomness at 3 rows
    (each share expands A again, so one op: the split path is the one every
    provider shares)."""
    whole = get_kem("FrodoKEM-640-SHAKE", backend="cpu")
    split = _split(get_kem("FrodoKEM-640-SHAKE", backend="cpu"), Mesh(["cpu"] * 2))
    pks, _ = whole.generate_keypair_batch(3)
    outs = []
    for provider in (split, whole):
        monkeypatch.setattr(os, "urandom", _pinned(13))
        outs.append(provider.encapsulate_batch(pks))
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_mldsa_provider_mesh_sign_verify_bit_exact(cpu_mesh):
    """ML-DSA-44 sign (fixed rnd) and verify at 5 rows: split across 8
    devices == unsplit == the JAX package's FIPS 204 oracle (pyref); every
    signature verifies through the split, none of a changed message."""
    split = _split(get_signature("ML-DSA-44", backend="cpu"), cpu_mesh)
    whole = get_signature("ML-DSA-44", backend="cpu")
    pk, sk = whole.generate_keypair()
    n = 5
    sks = np.broadcast_to(np.frombuffer(sk, np.uint8), (n, len(sk)))
    pks = np.broadcast_to(np.frombuffer(pk, np.uint8), (n, len(pk)))
    msgs = [b"mesh msg %d" % i for i in range(n)]
    rnd = [bytes([i]) * 32 for i in range(n)]
    got = split.sign_batch(sks, msgs, rnd=rnd)
    assert got == whole.sign_batch(sks, msgs, rnd=rnd)
    assert got == [mldsa_ref.sign(mldsa_ref.MLDSA44, sk, m, rnd=r) for m, r in zip(msgs, rnd)]
    assert split.verify_batch(pks, msgs, got).all()
    assert not split.verify_batch(pks, [m + b"!" for m in msgs], got).any()


@pytest.mark.slow
def test_sphincs_provider_mesh_verify_bit_exact(cpu_mesh):
    """SPHINCS+-SHA2-128f at 3 rows (the JAX package's test is in the slow
    tier too: its JAX sign compiles for minutes): the split provider signs
    the bytes of the unsplit one and of the JAX package's provider with
    ``devices=8``, and its split verify accepts them and refuses a changed
    message."""
    name = "SPHINCS+-SHA2-128f-simple"
    split = _split(get_signature(name, backend="cpu"), cpu_mesh)
    whole = get_signature(name, backend="cpu")
    ref = ref_get_signature(name, backend="tpu", devices=NDEV)
    pk, sk = whole.generate_keypair()
    n = 3
    sks = np.broadcast_to(np.frombuffer(sk, np.uint8), (n, len(sk)))
    pks = np.broadcast_to(np.frombuffer(pk, np.uint8), (n, len(pk)))
    msgs = [b"slh mesh %d" % i for i in range(n)]
    sigs = split.sign_batch(sks, msgs)
    assert sigs == whole.sign_batch(sks, msgs)
    assert sigs == [bytes(s) for s in ref.sign_batch(sks, msgs)]
    assert split.verify_batch(pks, msgs, sigs).all()
    assert not split.verify_batch(pks, [m + b"x" for m in msgs], sigs).any()


def test_sharded_handshake_matches_jax(cpu_mesh, jax_mesh):
    """The handshake step split across 8 devices at 16 rows: the port's
    ek, ct, both secrets and n_ok equal the JAX package's sharded step's."""
    d, z, m = _rows(16), _rows(16), _rows(16)
    got = make_sharded_handshake(cpu_mesh, "ML-KEM-512")(d, z, m)
    step = ref_mesh.make_sharded_handshake(jax_mesh, "ML-KEM-512")
    want = step(*ref_mesh.shard_batch(jax_mesh, d, z, m))
    for a, b in zip(got[:4], want[:4]):
        assert np.array_equal(a, np.asarray(b))
    assert got[4] == int(want[4]) == 16
    assert make_sharded_handshake(cpu_mesh, "ML-KEM-512") is make_sharded_handshake(
        Mesh(["cpu"] * NDEV), "ML-KEM-512")
    with pytest.raises(ValueError, match="do not divide"):
        make_sharded_handshake(cpu_mesh, "ML-KEM-512")(d[:5], z[:5], m[:5])


def test_multichip_dryrun_checks_on_a_cpu_mesh():
    """entry.run_multichip, the checks of dryrun_multichip, on a mesh of two
    CPU devices with providers split across it; dryrun_multichip itself
    asks for GPUs and raises without them."""
    mesh = Mesh(["cpu"] * 2)
    out = entry.run_multichip(mesh, _split(get_kem("ML-KEM-768", backend="cpu"), mesh),
                              _split(get_signature("ML-DSA-44", backend="cpu"), mesh))
    assert out == {"devices": ["cpu", "cpu"], "handshake_rows": 4, "handshake_ok": 4,
                   "provider_rows": 5}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            entry.dryrun_multichip(1)


def _placed(**kw) -> list:
    sched = scheduler.DeviceProgramScheduler(**kw)
    sched.close()
    return [s.device for s in sched.shards]


def test_make_mesh_and_shard_devices_need_as_many_gpus(monkeypatch):
    """make_mesh and shard_devices take the first GPUs and raise, naming
    the count, when fewer exist, never falling back to fewer or to the CPU;
    make_provider_mesh splits nothing on "cpu" or with 0 devices; a "cuda"
    scheduler places shard i on GPU i, a "cpu" one keeps logical shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_mesh, shard_devices, lambda: make_mesh(1)):
        with pytest.raises(RuntimeError, match="have 0"):
            call()
    with pytest.raises(RuntimeError, match="have 0"):
        scheduler.DeviceProgramScheduler(shards=1, backend="cuda")
    assert make_provider_mesh(NDEV, "cpu") is None and make_provider_mesh(0, "cuda") is None
    assert _placed(shards=2, backend="cpu") == [None, None]
    assert _placed(shards=0, backend="cuda") == [None]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1).size == 1 and make_provider_mesh(-1, "cuda").size == 2
    assert shard_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="need 3 GPU.*have 2"):
        make_mesh(3)
    with pytest.raises(RuntimeError, match="need 3 GPU.*have 2"):
        make_provider_mesh(3, "cuda")
    assert _placed(shards=2, backend="cuda") == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="need 3 GPU"):
        scheduler.DeviceProgramScheduler(shards=3, backend="cuda")


def test_messaging_passes_mesh_devices_to_its_providers(monkeypatch):
    """SecureMessaging(mesh_devices=N) asks the registry for its KEM and
    signature with ``devices=N``, at construction and in both hot swaps."""
    asked = []

    def recording(get):
        def wrapped(name, backend="cuda", devices=0):
            asked.append((name, backend, devices))
            return get(name, backend, devices=devices)
        return wrapped

    monkeypatch.setattr(msg, "get_kem", recording(get_kem))
    monkeypatch.setattr(msg, "get_signature", recording(get_signature))
    e = msg.SecureMessaging(P2PNode("mesh-test-node", "127.0.0.1", 0), backend="cpu",
                            mesh_devices=NDEV)
    try:
        asyncio.run(e.set_key_exchange_algorithm("ML-KEM-512"))
        asyncio.run(e.set_signature_algorithm("ML-DSA-44"))
    finally:
        e.close()
    assert asked == [("ML-KEM-768", "cpu", NDEV), ("ML-DSA-65", "cpu", NDEV),
                     ("ML-KEM-512", "cpu", NDEV), ("ML-DSA-44", "cpu", NDEV)]
    assert e.kem.name == "ML-KEM-512" and e.signature.name == "ML-DSA-44"
