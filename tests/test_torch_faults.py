"""The port's fault engine (quantum_resistant_p2p_tpu_torch.faults) against
the JAX package's, and the scalar-op seam on the port's "cpu" providers.

The same plan seed and rules, driven through the same hook sequence (made
from a numpy seed), must give the same injection logs and the same
outcomes on both sides: tolerance exact.  The seam must fire on the
scalar operations of ML-KEM-512, ML-DSA-44 and ChaCha20-Poly1305 as it
does on the JAX package's "cpu" providers, and never on a batch
operation.  No JAX program runs here: the JAX package's "cpu" providers
are pure Python and native code.
"""

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu import faults as ref_faults
from quantum_resistant_p2p_tpu.provider import registry as ref_registry
from quantum_resistant_p2p_tpu_torch import faults
from quantum_resistant_p2p_tpu_torch.provider import (get_batched_aead, get_kem, get_signature,
                                                      get_symmetric)

SIDES = (faults, ref_faults)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread: xdist workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rules(mod, rng):
    R = mod.FaultRule
    return [
        R("net.send", "corrupt", match={"msg_type": "ke_response"}, nth=int(rng.integers(1, 3)),
          times=2),
        R("net.send", "drop", match={"peer": "p2"}, nth=2),
        R("net.send", "delay", match={"msg_type": "chat"}, nth=1, delay_s=0.25),
        R("device.dispatch", "raise", match={"op": "ML-KEM-768.enc"},
          nth=int(rng.integers(1, 4))),
        R("device.dispatch", "poison", match={"op": "ML-KEM-768.dec"}, nth=1, times=3),
        R("device.dispatch", "raise", match={"lane": "bulk"}, nth=2),
        R("device.dispatch", "delay", match={"op": "ChaCha20-Poly1305.seal"}, nth=3,
          delay_s=0.001),
        R("scalar.op", "raise", match={"algo": "ML-DSA", "op": "sign"}, nth=2),
        R("warmup", "kill", match={"op": "ML-KEM-768.kg"}),
        R("ticket", "expire", match={"peer": "p1"}, nth=1),
        R("process", "pause_gateway", match={"gateway": "gw1"}, nth=2, delay_s=1.5),
        R("process", "kill_router", match={"router": "r0"}, nth=1),
    ]


def _events(seed: int) -> list:
    """A hook sequence: 80 calls over every hook, from seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(80):
        kind = int(rng.integers(8))
        if kind == 0:
            payload = {"ct": bytes(rng.integers(0, 256, 24, dtype=np.uint8)),
                       "pk": bytes(rng.integers(0, 256, 20, dtype=np.uint8)).hex(),
                       "ke_data": {"sig": bytes(rng.integers(0, 256, 16, dtype=np.uint8))},
                       "n": 3, "note": "short"}
            out.append(("net_send", f"p{rng.integers(3)}", f"p{rng.integers(3)}",
                        ("ke_response", "chat", "ke_init")[rng.integers(3)], payload))
        elif kind == 1:
            out.append(("device_dispatch", ("ML-KEM-768.enc", "ML-KEM-768.dec",
                                            "ChaCha20-Poly1305.seal")[rng.integers(3)],
                        int(rng.integers(1, 64)), ("handshake", "bulk", None)[rng.integers(3)]))
        elif kind == 2:
            out.append(("poison_results", ("ML-KEM-768.dec", "ML-KEM-768.enc")[rng.integers(2)],
                        list(range(int(rng.integers(0, 40))))))
        elif kind == 3:
            out.append(("scalar_op", ("ML-DSA-44", "ML-KEM-512")[rng.integers(2)],
                        ("sign", "verify", "encapsulate")[rng.integers(3)]))
        elif kind == 4:
            out.append(("warmup", ("ML-KEM-768.kg", "ML-KEM-768.enc")[rng.integers(2)]))
        elif kind == 5:
            out.append(("ticket_validation", "n1", f"p{rng.integers(3)}"))
        elif kind == 6:
            out.append(("process_control", f"gw{rng.integers(2)}"))
        else:
            out.append(("router_control", f"r{rng.integers(2)}"))
    return out


def _drive(mod, seed: int):
    """Run the hook sequence through the module-level hooks with the plan
    installed; -> (each call's outcome, the injection log)."""
    plan = mod.FaultPlan(seed, _rules(mod, np.random.default_rng(seed)))
    outcomes = []
    with plan.activate():
        assert mod.active() is plan
        for hook, *args in _events(seed):
            try:
                out = getattr(mod.plan, hook)(*args)
            except mod.FaultInjected as exc:
                out = ("raised", str(exc))
            if hook == "poison_results":
                out = [("poisoned", str(r)) if isinstance(r, Exception) else r for r in out]
            elif hook == "device_dispatch" and out is None:
                out = "ok"
            outcomes.append(out)
    assert mod.active() is None
    return outcomes, plan.injected


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_same_seed_and_hooks_give_identical_injection_logs(seed):
    """Inputs: the rule parameters and the 80-call hook sequence from seed;
    exact (every outcome, every log entry, corruption bytes and poisoned
    slots included)."""
    ours, theirs = _drive(faults, seed), _drive(ref_faults, seed)
    assert ours == theirs
    assert ours[1], "the sequence applies at least one fault"
    again = _drive(faults, seed)
    assert again == ours


def test_without_a_plan_every_hook_is_a_no_op():
    payload = {"ct": b"\x00" * 8}
    assert faults.active() is None
    assert faults.net_send("a", "b", "m", payload) == ("send", payload)
    assert faults.device_dispatch("q", 3, lane="bulk") is None
    results = [1, 2]
    assert faults.poison_results("q", results) is results
    assert faults.scalar_op("x", "sign") is None and faults.warmup("q") is None
    assert faults.ticket_validation("n", "p") == []
    assert faults.process_control("g") == [] and faults.router_control("r") == []


def test_install_rules_match_the_reference():
    for mod in SIDES:
        a, b = mod.FaultPlan(1, []), mod.FaultPlan(2, [])
        mod.install(a)
        try:
            mod.install(a)  # the same plan again is fine
            with pytest.raises(RuntimeError, match="already installed"):
                mod.install(b)
            mod.uninstall(b)  # not the installed one: no effect
            assert mod.active() is a
        finally:
            mod.uninstall()
        assert mod.active() is None
        with pytest.raises(ValueError, match="unknown fault scope"):
            mod.FaultRule("disk.write", "raise")
        with pytest.raises(ValueError, match="invalid for scope"):
            mod.FaultRule("warmup", "raise")
    assert faults.SCOPES == ref_faults.SCOPES and faults.ACTIONS == ref_faults.ACTIONS


_PROVIDERS = {
    "ML-KEM-512": (lambda: get_kem("ML-KEM-512", backend="cpu"),
                   lambda: ref_registry.get_kem("ML-KEM-512", backend="cpu")),
    "ML-DSA-44": (lambda: get_signature("ML-DSA-44", backend="cpu"),
                  lambda: ref_registry.get_signature("ML-DSA-44", backend="cpu")),
    "ChaCha20-Poly1305": (lambda: get_symmetric("ChaCha20-Poly1305"),
                          lambda: ref_registry.get_symmetric("ChaCha20-Poly1305")),
}


def _scalar_calls(algo, name: str, seed: int) -> list:
    """Eight scalar operations of ``algo`` in an order from seed; -> each
    call's outcome ("ok" or the injected fault's message)."""
    rng = np.random.default_rng(seed)
    out = []
    if name.startswith("ML-KEM"):
        pk, sk = algo.generate_keypair()
        ct, _ = algo.encapsulate(pk)
        calls = [lambda: algo.generate_keypair(), lambda: algo.encapsulate(pk),
                 lambda: algo.decapsulate(sk, ct)]
    elif name.startswith("ML-DSA"):
        pk, sk = algo.generate_keypair()
        sig = algo.sign(sk, b"m")
        calls = [lambda: algo.generate_keypair(), lambda: algo.sign(sk, b"m"),
                 lambda: algo.verify(pk, b"m", sig)]
    else:
        key = bytes(range(32))
        blob = algo.encrypt(key, b"frame", b"ad")
        calls = [lambda: algo.encrypt(key, b"frame", b"ad"),
                 lambda: algo.decrypt(key, blob, b"ad")]
    for i in rng.integers(0, len(calls), 8):
        try:
            calls[i]()
            out.append("ok")
        except Exception as exc:  # the injected fault of either side
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("name", list(_PROVIDERS))
def test_scalar_seam_fires_on_the_cpu_providers_as_on_the_reference(name):
    """Inputs: the order of eight scalar calls from seed 5; the plan raises
    on the 2nd and 3rd matching call of each op; exact (the outcomes and
    the injection logs of the port's and the JAX package's providers)."""
    logs = []
    for mod, make in zip(SIDES, _PROVIDERS[name]):
        algo = make()
        plan = mod.FaultPlan(5, [mod.FaultRule("scalar.op", "raise", match={"algo": name, "op": op},
                                               nth=2, times=2)
                                 for op in ("generate_keypair", "encapsulate", "decapsulate",
                                            "sign", "verify", "encrypt", "decrypt")])
        outcomes = []
        with plan.activate():
            outcomes = _scalar_calls(algo, name, 5)
        logs.append((outcomes, plan.injected))
    assert logs[0] == logs[1]
    assert any(o != "ok" for o in logs[0][0])


def test_scalar_seam_leaves_batch_ops_alone():
    """A plan whose rule matches every scalar op never sees a batch op:
    its counter stays 0 through the batch API of each provider."""
    kem, dsa = get_kem("ML-KEM-512", backend="cpu"), get_signature("ML-DSA-44", backend="cpu")
    aead = get_batched_aead("ChaCha20-Poly1305", backend="cpu")
    plan = faults.FaultPlan(6, [faults.FaultRule("scalar.op", "raise", times=10**6)])
    with plan.activate():
        pks, sks = kem.generate_keypair_batch(2)
        cts, sss = kem.encapsulate_batch(pks)
        assert (kem.decapsulate_batch(sks, cts) == sss).all()
        dpks, dsks = dsa.generate_keypair_batch(2)
        sigs = dsa.sign_batch(dsks, [b"a", b"b"])
        assert dsa.verify_batch(dpks, [b"a", b"b"], sigs).all()
        keys, nonces = np.zeros((1, 32), np.uint8), np.zeros((1, 12), np.uint8)
        sealed = aead.seal_batch(keys, nonces, [b"frame"], [b""])
        assert aead.open_batch(keys, nonces, sealed, [b""]) == [b"frame"]
        assert plan._matched == [0] and plan.injected == []
        with pytest.raises(faults.FaultInjected):
            kem.encapsulate(bytes(pks[0]))
    assert plan._matched == [1]


def test_scalar_seam_wraps_each_op_once():
    """The wrapper marks itself: instrumenting a class again changes
    nothing, and an op inherited from an interface fires once a call."""
    kem = get_kem("ML-KEM-512", backend="cpu")
    cls = type(kem)
    before = {op: cls.__dict__.get(op) for op in ("generate_keypair", "encapsulate")}
    faults.instrument_scalar_ops(cls)
    assert {op: cls.__dict__.get(op) for op in before} == before
    plan = faults.FaultPlan(7, [faults.FaultRule("scalar.op", "raise",
                                                 match={"op": "generate_keypair"}, nth=2)])
    with plan.activate():
        kem.generate_keypair()
        with pytest.raises(faults.FaultInjected, match="ML-KEM-512.generate_keypair"):
            kem.generate_keypair()
    assert plan._matched == [2]
