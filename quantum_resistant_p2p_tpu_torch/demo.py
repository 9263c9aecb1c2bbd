"""Two-node demo: the whole post-quantum secure messaging flow through the
port's public API; the counterpart of the JAX package's
``examples/two_node_demo.py``.

    python -m quantum_resistant_p2p_tpu_torch.demo [--backend cuda|cpu]

Builds two complete stacks (an encrypted vault, a TCP node and a protocol
engine) in one process, runs the default authenticated handshake
(ML-KEM-768 + ML-DSA-65, AES-256-GCM) over localhost TCP, sends a verified
message and a file, then prints the audit log's metrics and the key
history, and probes a wrong vault password and a forged ciphertext.  The
engines run on "cuda" (the default; raises without a GPU) or on "cpu".
Exits 0 when every step did what it should.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import tempfile
from pathlib import Path

from .app import SecureMessaging
from .net import P2PNode
from .storage import KeyStorage, SecureLogger

#: the longest the demo waits for a message, a file or a confirm to arrive
WAIT_S = 60.0
#: the time a forged ciphertext gets to reach the application (it must not)
FORGED_WAIT_S = 0.3
FILE_BYTES = b"%PDF-1.4 fake" * 9000  # ~115 KiB: chunked transport


async def _until(cond, what: str) -> None:
    async def poll():
        while not cond():
            await asyncio.sleep(0.01)

    try:
        await asyncio.wait_for(poll(), WAIT_S)
    except asyncio.TimeoutError:
        raise RuntimeError(f"demo: timed out waiting for {what}") from None


async def run(backend: str = "cuda", out=print) -> dict:
    """Run the demo's steps in a scratch directory and return what each
    showed; ``out`` gets the lines the reference's demo prints."""
    with tempfile.TemporaryDirectory(prefix="qrp2p_torch_demo_") as tmpdir:
        tmp = Path(tmpdir)
        stacks = {}
        try:
            for name in ("alice", "bob"):
                vault = KeyStorage(tmp / f"{name}.vault.json")
                if not vault.unlock(f"{name}-password"):
                    raise RuntimeError(f"demo: {name}'s fresh vault did not unlock")
                audit = SecureLogger(vault.get_or_create_purpose_key("audit"),
                                     tmp / f"{name}.logs")
                node = P2PNode(node_id=name, host="127.0.0.1", port=0)
                await node.start()
                stacks[name] = (vault, audit, node, None)
                engine = SecureMessaging(node, key_storage=vault, secure_logger=audit,
                                         backend=backend)
                stacks[name] = (vault, audit, node, engine)
            return await _steps(tmp, stacks, out)
        finally:
            for _, _, node, engine in stacks.values():
                await node.stop()
                if engine is not None:
                    engine.close()


async def _steps(tmp: Path, stacks: dict, out) -> dict:
    alice_vault, alice_audit, alice_node, alice = stacks["alice"]
    _, _, bob_node, bob = stacks["bob"]
    res = {}
    inbox: list = []
    bob.register_message_listener(lambda peer, m: inbox.append((peer, m)))

    res["peer"] = await alice_node.connect_to_peer("127.0.0.1", bob_node.port)
    out(f"[1] alice connected to: {res['peer']}")

    res["handshake"] = await asyncio.wait_for(alice.initiate_key_exchange("bob"), WAIT_S)
    await _until(lambda: "alice" in bob.shared_keys, "bob's key")
    out(f"[2] handshake (ML-KEM-768 + ML-DSA-65): {'OK' if res['handshake'] else 'FAILED'}")
    res["state"] = alice.ke_state["bob"].value
    out(f"    alice state: {res['state']}")
    res["same_key"] = alice.shared_keys["bob"] == bob.shared_keys["alice"]
    out(f"    both sides derived the same AEAD key: {res['same_key']}")

    def texts():
        return [(p, m.content) for p, m in inbox if not m.is_system and not m.is_file]

    await alice.send_message("bob", b"hello post-quantum world")
    await _until(texts, "the message")
    res["texts"] = texts()
    out(f"[3] bob received: {res['texts']}")

    def files():
        return [(m.filename, len(m.content)) for _, m in inbox if m.is_file]

    blob = tmp / "paper.pdf"
    blob.write_bytes(FILE_BYTES)
    await alice.send_file("bob", blob)
    await _until(files, "the file")
    res["files"] = files()
    out(f"[4] bob received file: {res['files']}")

    res["audit"] = alice_audit.get_security_metrics()["event_counts"]
    out(f"[5] alice audit metrics: {res['audit']}")
    hist = alice_vault.list_key_history("bob")
    res["history"] = len(hist)
    res["history_algorithm"] = alice_vault.get_key_history_value(hist[0]["name"])["algorithm"]
    out(f"[6] alice key history entries for bob: {res['history']} (algo: "
        f"{res['history_algorithm']})")

    res["wrong_password_unlocks"] = KeyStorage(tmp / "alice.vault.json").unlock("wrong")
    out(f"[7] vault unlock with wrong password: {res['wrong_password_unlocks']}")

    before = len(texts())
    await alice_node.send_message("bob", "secure_message", ct=b"\x00" * 64, ad=b"{}")
    await asyncio.sleep(FORGED_WAIT_S)
    res["forged_delivered"] = len(texts()) != before
    out(f"[8] forged ciphertext delivered to app layer: {res['forged_delivered']}")
    return res


def passed(res: dict) -> bool:
    """Every step of a :func:`run` did what it should."""
    return (res["peer"] == "bob" and res["handshake"] and res["same_key"]
            and res["texts"] == [("alice", b"hello post-quantum world")]
            and res["files"] == [("paper.pdf", len(FILE_BYTES))]
            and res["history"] >= 1 and not res["wrong_password_unlocks"]
            and not res["forged_delivered"])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m quantum_resistant_p2p_tpu_torch.demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines' crypto runs (default: cuda)")
    args = ap.parse_args(argv)
    res = asyncio.run(run(args.backend))
    ok = passed(res)
    print(f"[9] clean shutdown; every step {'passed' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
