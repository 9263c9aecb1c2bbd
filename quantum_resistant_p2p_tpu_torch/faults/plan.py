"""Deterministic, seedable fault-plan engine.

Counterpart of the reference's ``faults/plan.py``.  A :class:`FaultPlan` is
a list of scoped :class:`FaultRule`\\ s injected through EXPLICIT hook
points:

* ``device.dispatch``— :class:`provider.batched.OpQueue`'s device call
                       (raise on the Nth dispatch, poison one batch slot)
* ``scalar.op``      — every concrete provider scalar op, instrumented at
                       class-creation time by ``provider.base`` (raise on the
                       Nth matching call)
* ``warmup``         — a facade warm-up's call of a queue (kill it)
* ``net.send``       — an outbound message before framing (drop / delay /
                       corrupt)
* ``ticket``         — session-ticket validation (force a reject verdict)
* ``process``        — a fleet's health loop (kill, pause, partition or
                       drain a gateway; kill or pause a router)

The port feeds ``device.dispatch`` (both hooks), ``scalar.op``, ``warmup``
and ``net.send`` (``net/p2p_node.py``); it has no protocol engine or fleet
yet, so :func:`ticket_validation`, :func:`process_control` and
:func:`router_control` wait for their callers.

The hooks are no-ops (one module-global ``None`` check) unless a plan is
installed, so production code pays nothing.  All randomness — corruption byte
positions, poisoned slot indices — derives from the plan seed and the rule
index, and rule counters advance only on MATCHED events, so a chaos run is
reproducible from a single seed: same plan, same faults, same order.  No
monkeypatching anywhere.

Usage::

    plan = FaultPlan(seed=7, rules=[
        FaultRule("device.dispatch", "raise", match={"op": "ML-KEM-768.enc"}, nth=3),
        FaultRule("device.dispatch", "poison", match={"op": "ML-KEM-768.dec"}),
    ])
    with plan.activate():
        ...   # drive the stack; plan.injected records what fired
"""

from __future__ import annotations

import random
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

SCOPES = ("net.send", "device.dispatch", "scalar.op", "warmup", "process",
          "ticket")
ACTIONS = {
    "net.send": ("drop", "delay", "corrupt"),
    "device.dispatch": ("raise", "poison", "delay"),
    "scalar.op": ("raise",),
    "warmup": ("kill",),
    # process-scope faults: a fleet health loop polls
    # process_control(gateway) once per gateway per tick, in sorted gateway
    # order on ONE loop — so rule counters advance on a deterministic event
    # stream and the injected log is byte-reproducible from the seed even
    # though the actions themselves are wall-clock chaos (a SIGKILL, a
    # SIGSTOP, a dropped control link).  ``drain_gateway`` runs the
    # graceful-drain protocol mid-storm — composed with a kill rule on the
    # next tick it is the drain-interrupt scenario.
    # ``kill_router``/``pause_router`` target CONTROL-PLANE replicas: a
    # router loop polls router_control(router) once per router per
    # tick, same deterministic-stream discipline.
    "process": ("kill_gateway", "pause_gateway", "partition",
                "drain_gateway", "kill_router", "pause_router"),
    # ticket-scope faults (session-ticket resume validation): each
    # action forces exactly one typed reject verdict on the responder —
    # "corrupt" flips a byte of the presented blob (MAC failure),
    # "expire"/"replay" force those verdicts — so chaos plans exercise
    # every reject + full-handshake-fallback path end-to-end.
    "ticket": ("corrupt", "expire", "replay"),
}


class FaultInjected(RuntimeError):
    """Raised by an injection hook standing in for a real device/net fault."""


@dataclass
class FaultRule:
    """One scoped fault.  The rule fires on matched events number
    ``nth .. nth+times-1`` (1-based) of its scope at this plan."""

    scope: str
    action: str
    match: dict[str, Any] = field(default_factory=dict)
    #: first matching event (1-based) the rule fires on
    nth: int = 1
    #: how many consecutive matching events it fires for
    times: int = 1
    #: for action == "delay"
    delay_s: float = 0.05
    #: for action == "corrupt": payload field to mutate (auto-picked if None)
    corrupt_field: str | None = None

    def __post_init__(self) -> None:
        if self.scope not in SCOPES:
            raise ValueError(f"unknown fault scope {self.scope!r}; have {SCOPES}")
        if self.action not in ACTIONS[self.scope]:
            raise ValueError(
                f"action {self.action!r} invalid for scope {self.scope!r}; "
                f"have {ACTIONS[self.scope]}"
            )

    def matches(self, info: dict[str, Any]) -> bool:
        for key, want in self.match.items():
            got = info.get(key)
            if want == "*":
                continue
            if isinstance(want, str) and isinstance(got, str):
                if want not in got and want != got:
                    return False
            elif got != want:
                return False
        return True


class FaultPlan:
    """A seeded set of fault rules plus the log of what actually fired."""

    def __init__(self, seed: int, rules: list[FaultRule]):
        self.seed = seed
        self.rules = list(rules)
        #: per-rule count of MATCHED events (fired or not)
        self._matched = [0] * len(self.rules)
        #: per-rule deterministic RNG (corruption positions, poison slots)
        self._rngs = [random.Random(seed * 1_000_003 + i)
                      for i in range(len(self.rules))]
        # hooks are hit from the event loop AND executor threads
        self._lock = threading.Lock()
        #: log of injected faults, in firing order (assert on this in tests)
        self.injected: list[dict[str, Any]] = []

    # -- lifecycle -----------------------------------------------------------

    @contextmanager
    def activate(self):
        """Install this plan globally for the duration of the block."""
        install(self)
        try:
            yield self
        finally:
            uninstall(self)

    # -- event matching ------------------------------------------------------

    def _fire(self, scope: str, info: dict[str, Any],
              actions: tuple[str, ...] | None = None):
        """-> list of (rule_index, rule, entry) that fire on this event.

        ``actions`` restricts which rules see the event — the dispatch-entry
        hook and the results-poisoning hook are DIFFERENT events of the same
        scope, and a rule's counter must advance on exactly one of them.

        Entries are NOT logged here: a fired rule may still be shadowed by
        another rule consuming the event (e.g. a drop short-circuiting a
        corrupt), so each hook logs via :meth:`_record` exactly when it
        APPLIES an action — ``plan.injected`` never lists phantom faults.
        """
        out = []
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.scope != scope or not rule.matches(info):
                    continue
                if actions is not None and rule.action not in actions:
                    continue
                self._matched[i] += 1
                n = self._matched[i]
                if rule.nth <= n < rule.nth + rule.times:
                    entry = {"scope": scope, "action": rule.action, "n": n, **info}
                    out.append((i, rule, entry))
        return out

    def _record(self, entry: dict[str, Any]) -> None:
        with self._lock:
            self.injected.append(entry)
        # every injected fault is a flight-recorder trigger (obs/flight.py):
        # chaos runs auto-dump a diagnostic bundle when a dump dir is armed,
        # making seeded scenarios explainable event-by-event.  The entry
        # carries only scope/action/labels — no payload bytes.
        from ..obs import flight as _flight

        _flight.trigger("fault_injected", seed=self.seed, **entry)

    # -- scope hooks (called by the module-level functions below) ------------

    def net_send(self, sender: str, peer: str, msg_type: str,
                 payload: dict[str, Any]):
        """-> ("drop", None) | ("delay", seconds) | ("send", payload).

        A "corrupt" rule returns ("send", mutated-copy): one byte of one
        bytes/hex-string field is flipped at a seed-deterministic position.
        """
        info = {"sender": sender, "peer": peer, "msg_type": msg_type}
        for i, rule, entry in self._fire("net.send", info):
            if rule.action == "drop":
                self._record(entry)
                return ("drop", None)
            if rule.action == "delay":
                self._record(entry)
                return ("delay", rule.delay_s)
            payload = _corrupt_payload(payload, self._rngs[i],
                                       rule.corrupt_field)
            self._record(entry)
        return ("send", payload)

    def device_dispatch(self, label: str, n_items: int,
                        shard: int | None = None,
                        lane: str | None = None) -> None:
        """May raise FaultInjected (a device fault at the dispatch boundary).
        ``shard`` is a placement-axis coordinate (None in the port, which
        has one device a facade) so a plan can kill ONE shard's device:
        match={"shard": i}; ``lane`` is the flush's priority lane name
        ("rekey"/"handshake"/"bulk", provider/batched.py) so a chaos plan
        can target one lane's flushes: match={"lane": "bulk"}."""
        info = {"op": label, "n_items": n_items, "shard": shard, "lane": lane}
        for _i, rule, entry in self._fire("device.dispatch", info,
                                          actions=("raise", "delay")):
            if rule.action == "raise":
                self._record(entry)
                raise FaultInjected(
                    f"injected device fault at dispatch of {label!r}"
                )
            if rule.action == "delay":
                import time

                self._record(entry)
                time.sleep(rule.delay_s)

    def poison_results(self, label: str, results: list[Any]) -> list[Any]:
        """Replace one batch slot's result with an Exception instance (the
        per-item failure convention of provider/batched.py)."""
        if not results:
            return results
        out = results
        info = {"op": label, "n_items": len(results)}
        for i, _rule, entry in self._fire("device.dispatch", info,
                                          actions=("poison",)):
            slot = self._rngs[i].randrange(len(results))
            entry["slot"] = slot
            self._record(entry)
            out = list(out)
            out[slot] = FaultInjected(
                f"injected poisoned batch slot {slot} in {label!r}"
            )
        return out

    def scalar_op(self, algo: str, op: str) -> None:
        """May raise FaultInjected (a fault inside one provider scalar op)."""
        for _i, rule, entry in self._fire("scalar.op", {"algo": algo, "op": op}):
            if rule.action == "raise":
                self._record(entry)
                raise FaultInjected(f"injected scalar fault in {algo}.{op}")

    def warmup(self, label: str) -> None:
        """May raise FaultInjected (a warm-up dies mid-compile)."""
        for _i, rule, entry in self._fire("warmup", {"op": label}):
            if rule.action == "kill":
                self._record(entry)
                raise FaultInjected(f"injected warm-up kill for {label!r}")

    def ticket_validation(self, node: str, peer: str) -> list[str]:
        """-> the ticket-scope actions firing on this resume-validation
        event (the caller applies them: corrupt the presented blob / force
        the expired / replayed verdict).  Every fired entry is recorded to
        ``injected``."""
        out: list[str] = []
        for _i, rule, entry in self._fire("ticket",
                                          {"node": node, "peer": peer}):
            self._record(entry)
            out.append(rule.action)
        return out

    def process_control(self, gateway: str) -> list[dict[str, Any]]:
        """-> the process-scope actions firing on this fleet-tick event.

        One call = one matched event for every ``process`` rule matching
        ``{"gateway": gateway}``; the caller applies the returned entries (``kill_gateway`` -> SIGKILL the subprocess,
        ``pause_gateway`` -> SIGSTOP for ``delay_s`` then SIGCONT,
        ``partition`` -> drop the router<->gateway control traffic for
        ``delay_s``).  Every fired entry is recorded to ``injected``.
        """
        out: list[dict[str, Any]] = []
        for _i, rule, entry in self._fire("process", {"gateway": gateway}):
            if rule.action in ("pause_gateway", "partition"):
                entry["delay_s"] = rule.delay_s
            self._record(entry)
            out.append(entry)
        return out

    def router_control(self, router: str) -> list[dict[str, Any]]:
        """-> the process-scope actions firing on this ROUTER-tick event.

        A router loop polls this once per router per tick in sorted
        router order; a rule matching
        ``{"router": router}`` fires here and never on the gateway
        stream (matches() requires the key to be present), so one plan
        can choreograph both tiers from one seed.  ``kill_router`` ->
        SIGKILL the replica, ``pause_router`` -> SIGSTOP for ``delay_s``
        then SIGCONT.  Every fired entry is recorded to ``injected``.
        """
        out: list[dict[str, Any]] = []
        for _i, rule, entry in self._fire("process", {"router": router}):
            if rule.action == "pause_router":
                entry["delay_s"] = rule.delay_s
            self._record(entry)
            out.append(entry)
        return out


def _corrupt_payload(payload: dict[str, Any], rng: random.Random,
                     field_name: str | None) -> dict[str, Any]:
    """Deterministically flip one byte of one corruptible field.

    Corruptible = a bytes-like value (bytes/bytearray/memoryview — the
    binary wire hands zero-copy views around), or a hex string of >= 16
    chars (the JSON wire encoding for keys/ciphertexts/signatures);
    nested one level into dict values (``ke_data``).  Returns a mutated
    COPY — the caller's dict (and any shared buffer behind a view) is
    never aliased.
    """
    paths: list[tuple[str, ...]] = []

    def scan(prefix: tuple[str, ...], obj: dict[str, Any]) -> None:
        for key in sorted(obj):
            val = obj[key]
            if isinstance(val, (bytes, bytearray, memoryview)) and len(val) > 0:
                paths.append(prefix + (key,))
            elif isinstance(val, str) and len(val) >= 16 and _is_hex(val):
                paths.append(prefix + (key,))
            elif isinstance(val, dict) and not prefix:
                scan(prefix + (key,), val)

    scan((), payload)
    if field_name is not None:
        paths = [p for p in paths if p[-1] == field_name]
    if not paths:
        return payload
    path = paths[rng.randrange(len(paths))]
    out = dict(payload)
    target: dict[str, Any] = out
    for key in path[:-1]:
        target[key] = dict(target[key])
        target = target[key]
    val = target[path[-1]]
    if isinstance(val, (bytes, bytearray, memoryview)):
        pos = rng.randrange(len(val))
        buf = bytearray(val)
        buf[pos] ^= 0xFF
        target[path[-1]] = bytes(buf)
    else:
        pos = 2 * rng.randrange(len(val) // 2)
        byte = int(val[pos:pos + 2], 16) ^ 0xFF
        target[path[-1]] = val[:pos] + format(byte, "02x") + val[pos + 2:]
    return out


def _is_hex(s: str) -> bool:
    try:
        bytes.fromhex(s if len(s) % 2 == 0 else s + "0")
        return True
    except ValueError:
        return False


# -- global installation ------------------------------------------------------

_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE is not plan:
        raise RuntimeError("another FaultPlan is already installed")
    _ACTIVE = plan


def uninstall(plan: FaultPlan | None = None) -> None:
    global _ACTIVE
    if plan is None or _ACTIVE is plan:
        _ACTIVE = None


def active() -> FaultPlan | None:
    return _ACTIVE


# -- hook functions (the only surface production code calls) ------------------


def net_send(sender: str, peer: str, msg_type: str, payload: dict[str, Any]):
    """-> ("send", payload) normally; ("drop", None) / ("delay", s) under a
    plan.  The returned payload may be a corrupted copy."""
    plan = _ACTIVE
    if plan is None:
        return ("send", payload)
    return plan.net_send(sender, peer, msg_type, payload)


def device_dispatch(label: str, n_items: int, shard: int | None = None,
                    lane: str | None = None) -> None:
    plan = _ACTIVE
    if plan is not None:
        plan.device_dispatch(label, n_items, shard=shard, lane=lane)


def poison_results(label: str, results: list[Any]) -> list[Any]:
    plan = _ACTIVE
    if plan is None:
        return results
    return plan.poison_results(label, results)


def scalar_op(algo: str, op: str) -> None:
    plan = _ACTIVE
    if plan is not None:
        plan.scalar_op(algo, op)


def warmup(label: str) -> None:
    plan = _ACTIVE
    if plan is not None:
        plan.warmup(label)


def ticket_validation(node: str, peer: str) -> list:
    """Ticket-scope hook (session resume validation): the fired
    corrupt/expire/replay actions for this presentation, [] without a
    plan."""
    plan = _ACTIVE
    if plan is None:
        return []
    return plan.ticket_validation(node, peer)


def process_control(gateway: str) -> list:
    """Process-scope fleet hook (a fleet health loop): the fired
    kill/pause/partition entries for this gateway's tick, [] without a
    plan."""
    plan = _ACTIVE
    if plan is None:
        return []
    return plan.process_control(gateway)


def router_control(router: str) -> list:
    """Process-scope control-plane hook (a router chaos tick): the fired
    kill_router/pause_router entries for this router's tick, [] without a
    plan."""
    plan = _ACTIVE
    if plan is None:
        return []
    return plan.router_control(router)


# -- provider scalar-op instrumentation ---------------------------------------

#: scalar ops instrumented on every provider class (provider/base.py calls
#: instrument_scalar_ops from CryptoAlgorithm.__init_subclass__)
_SCALAR_OPS = ("generate_keypair", "encapsulate", "decapsulate",
               "sign", "verify", "encrypt", "decrypt")


def instrument_scalar_ops(cls) -> None:
    """Wrap the scalar ops defined on ``cls`` with the ``scalar.op`` hook.

    Idempotent; abstract methods are left alone.  The wrapper is one global
    ``None`` check when no plan is installed — negligible next to any
    crypto op it guards.
    """
    import functools

    for name in _SCALAR_OPS:
        fn = cls.__dict__.get(name)
        if (fn is None or not callable(fn)
                or getattr(fn, "__isabstractmethod__", False)
                or getattr(fn, "_qrp2p_fault_hook", False)):
            continue

        def make(fn=fn, op=name):
            @functools.wraps(fn)
            def wrapper(self, *args, **kwargs):
                plan = _ACTIVE
                if plan is not None:
                    plan.scalar_op(getattr(self, "name", type(self).__name__), op)
                return fn(self, *args, **kwargs)

            wrapper._qrp2p_fault_hook = True
            return wrapper

        setattr(cls, name, make())
