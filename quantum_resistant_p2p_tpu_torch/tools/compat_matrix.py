"""Algorithm-combination compatibility harness.

Counterpart of the JAX package's ``tools/compat_matrix.py`` (itself a port
of the original project's ``crypto_algorithms_tester.py``), over the port's
``P2PNode``, ``SecureMessaging``, ``KeyStorage`` and registry: two full
in-process node stacks on localhost TCP, every KEM x AEAD x SIG combination
exercised end-to-end (key exchange, bidirectional messaging, file transfers
at three sizes), results collected into a PASS/FAIL report with throughput
rankings.

The port's registry holds 12 KEMs (ML-KEM x 3, FrodoKEM AES/SHAKE x 3,
HQC x 3), 2 AEADs and 9 signatures (ML-DSA x 3, SPHINCS+-SHA2 x 6): 216
combinations.

It differs from that module in three places:

* ``--backend`` is "cuda" (the default; that module's is "cpu") or "cpu";
* ``--batch`` (``use_batching``) runs both engines' batching queues, and a
  swap rebuilds every facade the engine has (KEM, signature, fused and
  the ChaCha20-Poly1305 data plane, K8 on "cuda"; that module rebuilds
  the first two), ungated and unwarmed as there; without it every op is
  one scalar provider call, as there;
* the report goes to ``torch_results/`` by default.

Usage::

  python -m quantum_resistant_p2p_tpu_torch.tools.compat_matrix --quick
  python -m quantum_resistant_p2p_tpu_torch.tools.compat_matrix --backend cpu \\
      --kems ML-KEM-512 --sigs ML-DSA-44
  python -m quantum_resistant_p2p_tpu_torch.tools.compat_matrix --batch \\
      --kems ML-KEM-768 --sigs ML-DSA-65
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..app.message_store import Message
from ..app.messaging import SecureMessaging
from ..net.p2p_node import P2PNode
from ..provider import (
    get_kem,
    get_signature,
    get_symmetric,
    list_kems,
    list_signatures,
    list_symmetrics,
)
from ..provider.base import BACKENDS
from ..storage.key_storage import KeyStorage

FILE_SIZES = {"10KB": 10 * 1024, "100KB": 100 * 1024, "1MB": 1024 * 1024}
#: where the report goes unless told otherwise
RESULTS_DIR = "torch_results"


@dataclass
class ComboResult:
    kem: str
    aead: str
    sig: str
    connected: bool = False
    key_exchange_ok: bool = False
    key_exchange_time: float = 0.0
    messaging_ok: bool = False
    file_results: dict = field(default_factory=dict)  # label -> KB/s or None
    error: str | None = None

    @property
    def passed(self) -> bool:
        return (
            self.connected
            and self.key_exchange_ok
            and self.messaging_ok
            and all(v is not None for v in self.file_results.values())
        )


class TestNode:
    """Full stack minus UI: a vault, a node and its engine."""

    def __init__(self, name: str, workdir: Path, backend: str,
                 use_batching: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")
        self.name = name
        self.backend = backend
        self.use_batching = use_batching
        self.storage = KeyStorage(workdir / f"{name}.vault.json")
        assert self.storage.unlock("test_password")
        self.node = P2PNode(node_id=name, host="127.0.0.1", port=0)
        self.messaging: SecureMessaging | None = None
        self.inbox: list[Message] = []
        self.got = asyncio.Event()

    async def start(self):
        await self.node.start()
        self.messaging = SecureMessaging(
            self.node, key_storage=self.storage, backend=self.backend,
            use_batching=self.use_batching,
        )
        self.messaging.register_message_listener(self._on_msg)
        await self.messaging.wait_ready()

    def _on_msg(self, peer_id: str, message: Message):
        if not message.is_system:
            self.inbox.append(message)
            self.got.set()

    def configure(self, kem: str, aead: str, sig: str):
        m = self.messaging
        m.kem = get_kem(kem, self.backend)
        m.symmetric = get_symmetric(aead)
        m.signature = get_signature(sig, self.backend)
        m._sig_keypair = m._load_or_generate_sig_keypair()
        if m.use_batching:
            from ..provider.batched import BatchedKEM, BatchedSignature

            m._bkem = BatchedKEM(m.kem, *m._batch_cfg, fallback=m._cpu_fallback_kem(),
                                 scheduler=m._scheduler, bucket_floor=m._batch_floor,
                                 lane_capacity=m._lane_capacity)
            m._bsig = BatchedSignature(m.signature, *m._batch_cfg,
                                       fallback=m._cpu_fallback_sig(),
                                       scheduler=m._scheduler, bucket_floor=m._batch_floor,
                                       lane_capacity=m._lane_capacity)
            m._bfused = m._make_fused()
            m._baead = m._make_batched_aead()
            m._attach_tuners()
            m._attach_cost()

    def reset_keys(self):
        m = self.messaging
        m.shared_keys.clear()
        m.raw_secrets.clear()
        m.ke_state.clear()

    async def wait_message(self, pred, timeout=30.0) -> Message | None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for msg in self.inbox:
                if pred(msg):
                    return msg
            self.got.clear()
            try:
                await asyncio.wait_for(self.got.wait(), 0.25)
            except asyncio.TimeoutError:
                pass
        return None

    async def stop(self):
        await self.node.stop()
        if self.messaging is not None:
            self.messaging.close()


async def run_combo(a: TestNode, b: TestNode, kem: str, aead: str, sig: str,
                    payloads: dict[str, bytes]) -> ComboResult:
    r = ComboResult(kem, aead, sig)
    a.configure(kem, aead, sig)
    b.configure(kem, aead, sig)
    a.reset_keys()
    b.reset_keys()
    a.inbox.clear()
    b.inbox.clear()
    r.connected = a.node.is_connected(b.name)
    if not r.connected:
        r.error = "not connected"
        return r
    # Re-gossip the new settings and wait for both sides to see them.
    await a.messaging.notify_peers_of_settings_change()
    await b.messaging.notify_peers_of_settings_change()
    for _ in range(200):
        if (a.messaging.settings_match(b.name) is True
                and b.messaging.settings_match(a.name) is True):
            break
        await asyncio.sleep(0.01)
    else:
        r.error = "settings gossip did not converge"
        return r
    t0 = time.perf_counter()
    try:
        ok = await a.messaging.initiate_key_exchange(b.name)
    except Exception as e:
        r.error = f"key exchange raised: {e}"
        return r
    r.key_exchange_time = time.perf_counter() - t0
    # both sides must hold the key
    for _ in range(200):
        if b.name in a.messaging.shared_keys and a.name in b.messaging.shared_keys:
            break
        await asyncio.sleep(0.01)
    r.key_exchange_ok = bool(ok) and a.messaging.shared_keys.get(
        b.name
    ) == b.messaging.shared_keys.get(a.name)
    if not r.key_exchange_ok:
        r.error = "key exchange failed"
        return r
    # bidirectional messaging
    ping = f"ping {kem}/{aead}/{sig}".encode()
    await a.messaging.send_message(b.name, ping)
    got = await b.wait_message(lambda m: m.content == ping)
    pong = b"pong " + ping
    await b.messaging.send_message(a.name, pong)
    got2 = await a.wait_message(lambda m: m.content == pong)
    r.messaging_ok = got is not None and got2 is not None
    if not r.messaging_ok:
        r.error = "messaging failed"
        return r
    # file transfers with throughput
    for label, payload in payloads.items():
        t0 = time.perf_counter()
        sent = await a.messaging.send_message(b.name, payload, is_file=True,
                                              filename=f"{label}.bin")
        got = await b.wait_message(
            lambda m: m.is_file and m.filename == f"{label}.bin"
        )
        dt = time.perf_counter() - t0
        if sent is None or got is None or got.content != payload:
            r.file_results[label] = None
            r.error = f"file {label} failed"
        else:
            r.file_results[label] = round(len(payload) / 1024 / dt, 2)
    return r


def make_report(results: list[ComboResult], out_dir: Path, backend: str) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    passed = [r for r in results if r.passed]
    by_throughput = sorted(
        (r for r in passed if r.file_results),
        key=lambda r: -(sum(v for v in r.file_results.values() if v) / max(len(r.file_results), 1)),
    )
    report = {
        "backend": backend,
        "total": len(results),
        "passed": len(passed),
        "failed": len(results) - len(passed),
        "results": [r.__dict__ for r in results],
        "fastest_key_exchange": sorted(
            ({"combo": f"{r.kem}+{r.sig}", "seconds": round(r.key_exchange_time, 4)}
             for r in passed),
            key=lambda d: d["seconds"],
        )[:10],
        "best_throughput": [
            {
                "combo": f"{r.aead}+{r.sig}",
                "avg_kb_s": round(
                    sum(v for v in r.file_results.values() if v) / max(len(r.file_results), 1), 1
                ),
            }
            for r in by_throughput[:10]
        ],
    }
    stamp = time.strftime("%Y%m%d_%H%M%S")
    (out_dir / f"compat_report_{stamp}.json").write_text(json.dumps(report, indent=2))
    lines = [f"Compatibility report — backend={backend}",
             f"{len(passed)}/{len(results)} combinations passed", ""]
    for r in results:
        mark = "PASS" if r.passed else f"FAIL ({r.error})"
        lines.append(
            f"  {r.kem:24s} {r.aead:20s} {r.sig:30s} {mark}"
            f"  ke={r.key_exchange_time:.3f}s files={r.file_results}"
        )
    (out_dir / f"compat_report_{stamp}.txt").write_text("\n".join(lines))
    return report


async def run_matrix(kems, aeads, sigs, backend: str, out_dir: Path,
                     file_sizes=FILE_SIZES, combos=None, use_batching: bool = False) -> dict:
    """Every (kem, aead, sig) of the three lists (or of ``combos``, a list
    of such triples, when given) through one server and one client node."""
    import tempfile

    if combos is None:
        combos = [(kem, aead, sig) for kem in kems for aead in aeads for sig in sigs]
    workdir = Path(tempfile.mkdtemp(prefix="qrp2p_torch_compat_"))
    payloads = {label: os.urandom(size) for label, size in file_sizes.items()}
    a = TestNode("server", workdir, backend, use_batching)
    b = TestNode("client", workdir, backend, use_batching)
    results = []
    try:
        await a.start()
        await b.start()
        assert await b.node.connect_to_peer("127.0.0.1", a.node.port)
        for _ in range(200):
            if a.node.is_connected("client"):
                break
            await asyncio.sleep(0.01)

        for kem, aead, sig in combos:
            print(f"[{len(results) + 1}] {kem} + {aead} + {sig} ...", flush=True)
            t0 = time.perf_counter()
            r = await run_combo(b, a, kem, aead, sig, payloads)
            print(f"    -> {'PASS' if r.passed else 'FAIL: ' + str(r.error)}"
                  f"  ke={r.key_exchange_time:.3f}s in {time.perf_counter() - t0:.1f}s",
                  flush=True)
            results.append(r)
    finally:
        await a.stop()
        await b.stop()
    return make_report(results, out_dir, backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="cuda", choices=BACKENDS)
    ap.add_argument("--kems", nargs="*", default=None)
    ap.add_argument("--aeads", nargs="*", default=None)
    ap.add_argument("--sigs", nargs="*", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="ML-KEM-only KEMs, small files")
    ap.add_argument("--batch", action="store_true",
                    help="run both engines' batching queues (the data plane on K8)")
    ap.add_argument("--output-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    kems = args.kems or ([k for k in list_kems() if k.startswith("ML-KEM")]
                         if args.quick else list_kems())
    aeads = args.aeads or list_symmetrics()
    sigs = args.sigs or ([s for s in list_signatures() if s.startswith("ML-DSA")]
                         if args.quick else list_signatures())
    sizes = {"10KB": 10240, "100KB": 102400} if args.quick else FILE_SIZES

    report = asyncio.run(
        run_matrix(kems, aeads, sigs, args.backend, Path(args.output_dir), sizes,
                   use_batching=args.batch)
    )
    print(json.dumps({k: report[k] for k in ("backend", "total", "passed", "failed")}))
    return 0 if report["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
