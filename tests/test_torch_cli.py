"""The port's CLI, entry point, node identity and discovery against the JAX
package's, on the CPU.

* The 5 tests of ``tests/test_cli.py`` on the port's ``CLI`` (``backend=
  "cpu"``): two CLIs chat, the obs commands, ``/showkey``'s warning and
  audit, ``/logs``' filters, and a REPL that survives bad commands.  The
  JAX package's banner line about its native core is, in the port, the
  device and which AES-256-GCM seals.
* A port CLI and a JAX-package CLI (both "cpu") agree on a key and each
  receive the other's message, whichever dials.
* ``python -m quantum_resistant_p2p_tpu_torch``: ``--help`` exits 0; on
  "cpu" it unlocks a vault from stdin, prints its banner and quits; three
  wrong passwords exit 1; with no ``--backend`` it runs on "cuda" and, with
  no GPU, fails naming CUDA.  ``CLI()`` on its default backend raises at
  ``start()`` the same way and starts nothing.
* ``load_or_generate_node_id`` gives the JAX package's answers for an id in
  the vault, a plaintext file (moved into the vault) and a fresh id, and an
  unnamed ``P2PNode`` takes the id from its vault.
* A ``node_announcement`` datagram of either package's ``NodeDiscovery`` is
  accepted by the other's (handled in-process: no datagram is sent).

Tolerance: exact.  The JAX package's CLI runs its "cpu" backend, which
compiles no JAX program; JAX's caches are cleared at the module's end all
the same (ROADMAP C1).  Every test sets ``QRP2P_TPU_HOME`` to a temporary
directory.
"""

from __future__ import annotations

import asyncio
import gc
import inspect
import io
import json
import os
import select
import subprocess
import sys
import time
import uuid
from pathlib import Path

import jax
import pytest
import torch

pytest.importorskip("cryptography")  # the JAX package's CLI unlocks its vault with it

from quantum_resistant_p2p_tpu import cli as ref_cli
from quantum_resistant_p2p_tpu.net import discovery as ref_discovery
from quantum_resistant_p2p_tpu.net import identity as ref_identity
from quantum_resistant_p2p_tpu.storage import KeyStorage as RefKeyStorage
from quantum_resistant_p2p_tpu_torch.cli import CLI
from quantum_resistant_p2p_tpu_torch.net import discovery, identity
from quantum_resistant_p2p_tpu_torch.net.p2p_node import P2PNode
from quantum_resistant_p2p_tpu_torch.provider.symmetric import AES256GCM_IMPL
from quantum_resistant_p2p_tpu_torch.storage import KeyStorage

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_release():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path / "health"))


@pytest.fixture
def run():
    loop = asyncio.new_event_loop()
    yield lambda coro: loop.run_until_complete(asyncio.wait_for(coro, 120))
    loop.run_until_complete(loop.shutdown_asyncgens())
    loop.close()


def _mk(tmp_path, name, port=0, cls=CLI):
    out = io.StringIO()
    cli = cls(
        vault_path=str(tmp_path / f"{name}.vault.json"),
        port=port,
        backend="cpu",
        enable_discovery=False,
        out=out,
    )
    assert cli.login("pw-" + name)
    return cli, out


async def _until_in(out, text, what):
    for _ in range(400):
        if text in out.getvalue():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# -- mirrors of tests/test_cli.py -----------------------------------------------------


def test_two_clis_chat(run, tmp_path):
    async def main():
        a, a_out = _mk(tmp_path, "a")
        b, b_out = _mk(tmp_path, "b")
        await a.start()
        await b.start()
        assert await a.handle(f"/connect 127.0.0.1 {b.node.port}")
        await asyncio.sleep(0.05)
        peer_b = a.node.get_peers()[0]
        assert await a.handle(f"/key {peer_b[:8]}")
        assert "shared key established" in a_out.getvalue()
        assert await a.handle(f"/send {peer_b[:8]} hello from cli")
        await _until_in(b_out, "hello from cli", "the message")

        # settings / metrics / logs / keyhistory surfaces all respond
        assert await a.handle("/settings")
        assert "ML-KEM-768" in a_out.getvalue()
        assert await a.handle("/metrics")
        assert await a.handle("/logs")
        assert "key_exchange" in a_out.getvalue()
        assert await a.handle("/keyhistory")
        assert "peer=" in a_out.getvalue()
        assert await a.handle("/set aead ChaCha20-Poly1305")
        assert a.messaging.symmetric.name == "ChaCha20-Poly1305"
        assert await a.handle("/peers")
        assert not await a.handle("/quit")
        await b.stop()

    run(main())


def test_trace_flight_and_prometheus_commands(run, tmp_path):
    async def main():
        a, a_out = _mk(tmp_path, "obs")
        await a.start()
        tpath = tmp_path / "trace.json"
        assert await a.handle(f"/trace {tpath}")
        doc = json.loads(tpath.read_text())
        assert "traceEvents" in doc and doc["displayTimeUnit"] == "ms"
        fpath = tmp_path / "flight.json"
        assert await a.handle(f"/flight {fpath}")
        bundle = json.loads(fpath.read_text())
        assert bundle["trigger"] == "manual"
        assert "events" in bundle and "metrics" in bundle
        assert await a.handle("/metrics prom")
        assert "qrp2p_" in a_out.getvalue()
        assert await a.handle("/metrics")
        assert '"operational"' in a_out.getvalue()
        assert await a.handle("/slo")
        out = a_out.getvalue()
        assert '"handshake_p99"' in out and '"budget_remaining"' in out
        assert "ALERTING" not in out  # a fresh node has burned nothing
        assert not await a.handle("/quit")

    run(main())


def test_showkey_formats_warning_and_audit(run, tmp_path, monkeypatch):
    async def main():
        a, a_out = _mk(tmp_path, "a2")
        b, _ = _mk(tmp_path, "b2")
        await a.start()
        await b.start()
        await a.handle(f"/connect 127.0.0.1 {b.node.port}")
        await asyncio.sleep(0.05)
        peer_b = a.node.get_peers()[0]
        await a.handle(f"/key {peer_b[:8]}")
        entries = a.storage.list_key_history()
        assert entries
        name = entries[0]["name"]

        # declined confirmation: no key material shown, denial audited
        monkeypatch.setattr("builtins.input", lambda *_: "no")
        await a.handle(f"/showkey {name}")
        assert "cancelled" in a_out.getvalue()
        assert "hex:" not in a_out.getvalue()

        monkeypatch.setattr("builtins.input", lambda *_: "YES")
        await a.handle(f"/showkey {name}")
        assert "WARNING" in a_out.getvalue() and "hex:" in a_out.getvalue()
        await a.handle(f"/showkey {name} base64")
        assert "base64:" in a_out.getvalue()
        await a.handle(f"/showkey {name} decimal")
        assert "decimal:" in a_out.getvalue()
        # every access (granted and denied) is in the audit log
        accesses = a.secure_logger.get_events(event_type="key_history_access")
        assert len(accesses) == 4
        assert any(e.get("granted") is False for e in accesses)
        # and the key shown is the one the peer stored for this exchange
        import base64

        shown = a_out.getvalue().split("hex: ")[1].split()[0]
        (theirs,) = b.storage.list_key_history(a.node.node_id)
        stored = b.storage.get_key_history_value(theirs["name"])["key"]
        assert bytes.fromhex(shown) == base64.b64decode(stored)

        await a.stop()
        await b.stop()

    run(main())


def test_logs_time_and_type_filters(run, tmp_path):
    async def main():
        a, out = _mk(tmp_path, "logsf")
        await a.start()
        # the startup line names the device and which AES-256-GCM seals
        assert "device: cpu, AES-256-GCM: OpenSSL)" in out.getvalue()
        a.secure_logger.log_event("connection", peer="x")
        a.secure_logger.log_event("message_sent", peer="x")

        out.truncate(0), out.seek(0)
        await a.handle("/logs connection")
        assert "connection" in out.getvalue() and "message_sent" not in out.getvalue()

        out.truncate(0), out.seek(0)
        await a.handle("/logs --since 1h")
        assert "message_sent" in out.getvalue()

        out.truncate(0), out.seek(0)
        await a.handle("/logs --until 1h")  # everything is newer than 1h ago
        assert "(no events)" in out.getvalue()

        out.truncate(0), out.seek(0)
        await a.handle("/logs --since 23:59 --until 23:59")
        assert "(no events)" in out.getvalue()
        await a.stop()

    run(main())


def test_unknown_command_and_bad_args_keep_repl_alive(run, tmp_path):
    async def main():
        a, out = _mk(tmp_path, "solo")
        await a.start()
        assert await a.handle("/nope")
        assert "unknown command" in out.getvalue()
        assert await a.handle("/connect")  # IndexError -> caught
        assert "error:" in out.getvalue()
        assert await a.handle("not-a-command")
        await a.stop()

    run(main())


# -- with the JAX package's CLI -------------------------------------------------------


@pytest.mark.parametrize("dialer", ["port", "reference"])
def test_port_and_reference_clis_chat(run, tmp_path, dialer):
    async def main():
        clis = {"port": _mk(tmp_path, "port"), "reference": _mk(tmp_path, "ref", cls=ref_cli.CLI)}
        for cli, _ in clis.values():
            await cli.start()
        (a, a_out), (b, b_out) = clis[dialer], clis["reference" if dialer == "port" else "port"]
        assert await a.handle(f"/connect 127.0.0.1 {b.node.port}")
        a_id, b_id = a.node.node_id, b.node.node_id
        assert await a.handle(f"/key {b_id[:8]}")
        assert "shared key established" in a_out.getvalue()
        assert a.messaging.shared_keys[b_id] == b.messaging.shared_keys[a_id]
        assert await a.handle(f"/send {b_id[:8]} from the dialer")
        await _until_in(b_out, f"[{a_id[:8]}] from the dialer", "the dialer's message")
        assert await b.handle(f"/send {a_id[:8]} from the listener")
        await _until_in(a_out, f"[{b_id[:8]}] from the listener", "the listener's message")
        for cli, _ in clis.values():
            await cli.stop()

    run(main())


# -- python -m and the default backend ------------------------------------------------


def _env(tmp_path) -> dict:
    # one PyTorch CPU thread in the child too: test workers share the cores
    return {**os.environ, "QRP2P_TPU_HOME": str(tmp_path / "home"), "PYTHONUNBUFFERED": "1",
            "PYTHONPATH": os.pathsep.join([str(REPO)] + sys.path), "OMP_NUM_THREADS": "1"}


def _python_m(tmp_path, args, stdin: str, timeout: float = 240.0):
    return subprocess.run(
        [sys.executable, "-m", "quantum_resistant_p2p_tpu_torch", *args],
        input=stdin, capture_output=True, text=True, timeout=timeout, cwd=REPO,
        # no controlling terminal: getpass reads the password from stdin
        start_new_session=True, env=_env(tmp_path))


def _read_until(proc, text: str, timeout: float = 240.0) -> str:
    """The child's output up to and including ``text``."""
    buf, end = b"", time.monotonic() + timeout
    while text.encode() not in buf:
        left = end - time.monotonic()
        if left <= 0 or not select.select([proc.stdout], [], [], left)[0]:
            raise AssertionError(f"no {text!r} in {timeout} s: {buf[-2000:]!r}")
        chunk = os.read(proc.stdout.fileno(), 65536)
        if not chunk:
            raise AssertionError(f"the process ended before {text!r}: {buf[-2000:]!r}")
        buf += chunk
    return buf.decode()


def test_python_m_help_exits_0(tmp_path):
    out = _python_m(tmp_path, ["--help"], "")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "usage: quantum_resistant_p2p_tpu_torch" in out.stdout
    assert "{cuda,cpu}" in out.stdout and "--batch" in out.stdout


def test_python_m_unlocks_prints_its_banner_and_quits(tmp_path):
    """The password first (getpass reads stdin through Python's buffer, so
    commands wait for the banner), then commands."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "quantum_resistant_p2p_tpu_torch", "--port", "0", "--backend",
         "cpu", "--no-discovery"], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=REPO, start_new_session=True, env=_env(tmp_path))
    try:
        proc.stdin.write(b"a-password\n")
        proc.stdin.flush()
        banner = _read_until(proc, "type /help for commands")
        proc.stdin.write(b"/settings\n/quit\n")
        proc.stdin.flush()
        settings = _read_until(proc, "signatures: ")
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert f"(backend=cpu, batching=False, device: cpu, AES-256-GCM: {AES256GCM_IMPL})" in banner
    assert "current: kem=ML-KEM-768 aead=AES-256-GCM sig=ML-DSA-65" in settings
    ks = KeyStorage(tmp_path / "home" / "vault.json")
    assert ks.unlock("a-password")
    node_id = ks.retrieve("system_node_id")
    assert f"node {node_id[:12]}… listening" in banner
    # three wrong passwords, and it exits 1 without starting
    out = _python_m(tmp_path, ["--port", "0", "--backend", "cpu", "--no-discovery"],
                    "wrong\nwrong\nwrong\n")
    assert out.returncode == 1
    assert out.stdout.count("unlock failed") == 3 and "listening" not in out.stdout


def test_default_backend_is_cuda_and_raises_without_a_gpu(run, tmp_path, monkeypatch):
    has_gpu = torch.cuda.is_available()
    assert inspect.signature(CLI).parameters["backend"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli = CLI(vault_path=str(tmp_path / "v.json"), port=0, enable_discovery=False,
              out=io.StringIO())
    assert cli.login("pw")
    with pytest.raises(RuntimeError, match="cuda"):
        run(cli.start())
    assert cli.node is None and cli.messaging is None
    if not has_gpu:  # the entry point, through Config's default
        out = _python_m(tmp_path, ["--port", "0", "--no-discovery"], "pw\n")
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
        assert "listening" not in out.stdout


# -- identity -------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["vault", "file", "fresh", "file_no_vault", "fresh_no_vault"])
def test_node_id_matches_the_reference(tmp_path, case):
    """Each package on the same state: the vault's id, the plaintext file's
    (moved into the vault), or a fresh UUID4 kept for the next call."""
    answers = {}
    for name, (vault_cls, fn) in {
            "port": (KeyStorage, identity.load_or_generate_node_id),
            "reference": (RefKeyStorage, ref_identity.load_or_generate_node_id)}.items():
        d = tmp_path / name
        d.mkdir()
        ks = None
        if not case.endswith("no_vault"):
            ks = vault_cls(d / "vault.json")
            assert ks.unlock("pw")
        if case == "vault":
            ks.store("system_node_id", "id-in-the-vault")
        if case.startswith("file"):
            (d / "node_id.txt").write_text("id-in-the-file\n")
        got = fn(ks, data_dir=d)
        assert fn(ks, data_dir=d) == got  # stable
        in_vault = None if ks is None else ks.retrieve("system_node_id") == got
        if case.startswith("fresh"):
            assert str(uuid.UUID(got, version=4)) == got
            got = "a fresh UUID4"
        answers[name] = (got, (d / "node_id.txt").exists(), in_vault)
    assert answers["port"] == answers["reference"]
    want = {"vault": ("id-in-the-vault", False, True), "file": ("id-in-the-file", False, True),
            "fresh": ("a fresh UUID4", False, True),
            "file_no_vault": ("id-in-the-file", True, None),
            "fresh_no_vault": ("a fresh UUID4", True, None)}[case]
    assert answers["port"] == want


def test_unnamed_node_reads_its_id_from_its_vault(tmp_path):
    ref = RefKeyStorage(tmp_path / "vault.json")
    assert ref.unlock("pw")
    ref_id = ref_identity.load_or_generate_node_id(ref)
    ks = KeyStorage(tmp_path / "vault.json")
    assert ks.unlock("pw")
    assert P2PNode(key_storage=ks, port=0).node_id == ref_id
    # without a vault, the data directory's file (QRP2P_TPU_HOME)
    first = P2PNode(port=0).node_id
    assert P2PNode(port=0).node_id == first != ref_id
    assert (Path(os.environ["QRP2P_TPU_HOME"]) / "node_id.txt").read_text() == first


# -- discovery ------------------------------------------------------------------------


@pytest.mark.parametrize("sender", ["port", "reference"])
def test_announcements_cross_the_packages(monkeypatch, sender):
    for mod in (discovery, ref_discovery):
        monkeypatch.setattr(mod, "get_local_ip", lambda: "10.1.2.3")
    mods = {"port": discovery, "reference": ref_discovery}
    tx = mods[sender].NodeDiscovery("node-tx", tcp_port=8123)
    rx = mods["reference" if sender == "port" else "port"].NodeDiscovery("node-rx", tcp_port=1)
    seen = []
    rx.on_discover(lambda *a: seen.append(a))
    datagram = tx._announcement()
    assert datagram == mods["reference" if sender == "port" else "port"].NodeDiscovery(
        "node-tx", tcp_port=8123)._announcement()
    rx._on_datagram(datagram, ("192.0.2.7", 8001))
    assert seen == [("node-tx", "10.1.2.3", 8123)]
    assert rx.get_discovered_nodes()["node-tx"]["port"] == 8123
    # its own announcement, other types and garbage are ignored
    rx._on_datagram(rx._announcement(), ("192.0.2.8", 8001))
    rx._on_datagram(json.dumps({"type": "other", "node_id": "x"}).encode(), ("192.0.2.9", 1))
    rx._on_datagram(b"\xff not json", ("192.0.2.9", 1))
    assert list(rx.get_discovered_nodes()) == ["node-tx"] and len(seen) == 1
