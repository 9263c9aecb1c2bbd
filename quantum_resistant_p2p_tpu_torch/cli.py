"""Interactive CLI: the port's entry point (``qrp2p-torch``, ``python -m
quantum_resistant_p2p_tpu_torch``).

Counterpart of the JAX package's ``cli.py``, command for command: the login
gate over the port's vault, peer list, chat, file transfer, crypto settings
and adopting a peer's, security metrics, the encrypted log viewer, key
history with audited decrypt, password change and destructive reset, driven
by slash-commands over an asyncio stdin reader on the node's event loop.

The engine runs on ``backend`` "cuda" (the default) or "cpu", and raises on
"cuda" without a GPU.  In place of the JAX package's native-core probe, the
banner names the device and which AES-256-GCM seals (``OpenSSL`` where the
``cryptography`` wheel is installed, ``port (host)`` otherwise).  ``stop()``
also closes the engine.
"""

from __future__ import annotations

import asyncio
import getpass
import json
import logging
import shlex
import sys
import time
from pathlib import Path

from .app.message_store import Message, MessageStore
from .app.messaging import SecureMessaging
from .net.discovery import NodeDiscovery
from .net.identity import load_or_generate_node_id
from .net.p2p_node import P2PNode
from .provider import list_kems, list_signatures, list_symmetrics
from .provider.symmetric import AES256GCM_IMPL
from .storage.key_storage import KeyStorage, get_app_data_dir
from .storage.secure_logger import SecureLogger

logger = logging.getLogger(__name__)


def _parse_time_point(text: str) -> float:
    """One /logs time arg -> epoch seconds.

    Accepts relative durations ago ("30m", "2h", "1d"), "HH:MM" (today,
    local), or an ISO "YYYY-MM-DD[THH:MM[:SS]]" stamp.
    """
    import datetime as _dt

    units = {"s": 1, "m": 60, "h": 3600, "d": 86400}
    if len(text) >= 2 and text[-1] in units and text[:-1].isdigit():
        return time.time() - int(text[:-1]) * units[text[-1]]
    if ":" in text and "-" not in text:
        today = _dt.datetime.now().strftime("%Y-%m-%d")
        return _dt.datetime.fromisoformat(f"{today}T{text}").timestamp()
    return _dt.datetime.fromisoformat(text).timestamp()


def _parse_time_range(args: list[str]):
    """Split ``--since T`` / ``--until T`` out of a /logs arg list."""
    start_t = end_t = None
    rest: list[str] = []
    i = 0
    while i < len(args):
        if args[i] in ("--since", "--until"):
            if i + 1 >= len(args):
                raise ValueError(f"{args[i]} needs a time argument (30m, HH:MM, ISO)")
            t = _parse_time_point(args[i + 1])
            if args[i] == "--since":
                start_t = t
            else:
                end_t = t
            i += 2
        else:
            rest.append(args[i])
            i += 1
    return start_t, end_t, rest

def _device_name(backend: str) -> str:
    """The device the engine's providers run on, for the banner; "cuda"
    without a GPU raises here, before the node starts."""
    import torch

    from .utils.cuda import require_device

    dev = require_device(backend)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


HELP = """\
commands:
  /peers                     list discovered + connected peers
  /connect <host> [port]     connect to a peer (default port 8000)
  /key <peer>                establish a shared key (handshake)
  /send <peer> <text...>     send an encrypted message
  /sendfile <peer> <path>    send a file
  /settings                  show current + available algorithms
  /set kem|aead|sig <name>   hot-swap an algorithm
  /adopt <peer>              adopt the peer's gossiped settings
  /metrics [prom]            security + operational metrics (queues, breaker,
                             trips, resilience counters; "prom" prints the
                             Prometheus text exposition instead)
  /slo                       SLO burn-rate report: per-objective fast/slow
                             burn, error budget remaining, alert state
  /trace [path]              export recent spans as chrome://tracing JSON
                             (load in chrome://tracing or ui.perfetto.dev)
  /flight [path]             dump the flight-recorder diagnostic bundle
                             (recent redacted events + metrics snapshot)
  /logs [type] [n] [--since T] [--until T]
                             decrypted audit log (latest n, default 20;
                             T: 30m/2h/1d relative, HH:MM, or ISO date)
  /clearlogs                 delete all audit logs
  /keyhistory [peer]         list stored shared-key history entries
  /showkey <entry> [fmt]     decrypt + display a stored key (audited,
                             confirmation required; fmt: hex|base64|decimal)
  /delkey <entry>            delete one key-history entry
  /clearhistory              delete ALL key-history entries
  /passwd                    change the vault password
  /reset                     DESTRUCTIVE vault reset
  /batchstats                GPU batch-queue statistics (if batching on)
  /quit                      exit
"""


class CLI:
    """Command processor; separable from stdin so tests can drive it."""

    def __init__(
        self,
        vault_path: str | None = None,
        port: int = 8000,
        backend: str = "cuda",
        use_batching: bool = False,
        mesh_devices: int = 0,
        enable_discovery: bool = True,
        telemetry_port: int | None = None,
        out=sys.stdout,
    ):
        self.out = out
        self.port = port
        self.backend = backend
        self.use_batching = use_batching
        self.mesh_devices = mesh_devices
        self.telemetry_port = telemetry_port
        self.enable_discovery = enable_discovery
        self.storage = KeyStorage(vault_path)
        self.node: P2PNode | None = None
        self.discovery: NodeDiscovery | None = None
        self.messaging: SecureMessaging | None = None
        self.secure_logger: SecureLogger | None = None
        self.store = MessageStore()
        self._stop = asyncio.Event()
        self._reader: asyncio.StreamReader | None = None

    # ---------------------------------------------------------------- output

    def print(self, *args) -> None:
        print(*args, file=self.out)

    # ----------------------------------------------------------------- login

    def login(self, password: str) -> bool:
        """Unlock-or-initialise the vault (reference: ui/login_dialog.py:92-138)."""
        return self.storage.unlock(password)

    def login_interactive(self) -> bool:
        for attempt in range(3):
            pw = getpass.getpass("vault password: ")
            if self.login(pw):
                return True
            self.print("unlock failed — wrong password or corrupt vault")
        return False

    # ----------------------------------------------------------------- start

    async def start(self) -> None:
        assert self.storage.is_unlocked, "login first"
        device = _device_name(self.backend)
        log_key = self.storage.get_or_create_purpose_key("secure_logger")
        self.secure_logger = SecureLogger(log_key)
        node_id = load_or_generate_node_id(self.storage)
        self.node = P2PNode(node_id=node_id, host="0.0.0.0", port=self.port)
        await self.node.start()
        if self.enable_discovery:
            self.discovery = NodeDiscovery(node_id, tcp_port=self.node.port)
            await self.discovery.start()
        self.messaging = SecureMessaging(
            self.node,
            key_storage=self.storage,
            secure_logger=self.secure_logger,
            backend=self.backend,
            use_batching=self.use_batching,
            mesh_devices=self.mesh_devices,
            telemetry_port=self.telemetry_port,
        )
        self.messaging.register_message_listener(self._on_message)
        if self.messaging.telemetry_port is not None:
            self.print(f"telemetry endpoints on "
                       f"http://127.0.0.1:{self.messaging.telemetry_port} "
                       "(/metrics /healthz /readyz /slo /trace /cost)")
        self.secure_logger.log_event("initialization", node_id=node_id, port=self.node.port)
        self.print(f"node {node_id[:12]}… listening on :{self.node.port} "
                   f"(backend={self.backend}, batching={self.use_batching}, "
                   f"device: {device}, AES-256-GCM: {AES256GCM_IMPL})")

    async def stop(self) -> None:
        if self.messaging:
            self.messaging.close()
        if self.discovery:
            await self.discovery.stop()
        if self.node:
            await self.node.stop()
        if self.secure_logger:
            # Key hygiene: the log key must not outlive the session.
            self.secure_logger.zeroize()
        self._stop.set()

    def _on_message(self, peer_id: str, message: Message) -> None:
        self.store.add_message(peer_id, message, unread=True)
        if message.is_file:
            # Path(...).name strips directories — a peer-supplied filename like
            # "../../x" or an absolute path must not escape the received dir.
            safe_name = Path(message.filename or "file.bin").name or "file.bin"
            dest = get_app_data_dir() / "received" / safe_name
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_bytes(message.content)
            self.print(f"\n[{peer_id[:8]}] sent file {message.filename} "
                       f"({len(message.content)} bytes) -> {dest}")
        else:
            tag = "system" if message.is_system else peer_id[:8]
            self.print(f"\n[{tag}] {message.content.decode(errors='replace')}")

    # -------------------------------------------------------------- commands

    async def handle(self, line: str) -> bool:
        """Process one command line; returns False when the CLI should exit."""
        line = line.strip()
        if not line:
            return True
        if not line.startswith("/"):
            self.print("commands start with '/'; /help for a list")
            return True
        try:
            parts = shlex.split(line)
        except ValueError as e:
            self.print(f"parse error: {e}")
            return True
        cmd, args = parts[0].lower(), parts[1:]
        try:
            return await self._dispatch(cmd, args)
        except Exception as e:  # keep the REPL alive
            logger.exception("command failed")
            self.print(f"error: {e}")
            return True

    async def _dispatch(self, cmd: str, args: list[str]) -> bool:
        m = self.messaging
        if cmd in ("/help", "/?"):
            self.print(HELP)
        elif cmd == "/quit":
            await self.stop()
            return False
        elif cmd == "/peers":
            connected = set(self.node.get_peers())
            rows = []
            if self.discovery:
                for pid, info in self.discovery.get_discovered_nodes().items():
                    host, port = info["host"], info["port"]
                    status = "connected" if pid in connected else "discovered"
                    if m.verify_key_exchange_state(pid):
                        status = "secure"
                    match = m.settings_match(pid)
                    warn = " ⚠ settings mismatch" if match is False else ""
                    rows.append(f"  {pid[:12]}…  {host}:{port}  {status}{warn}"
                                f"  unread={self.store.get_unread_count(pid)}")
            for pid in connected:
                if not self.discovery or pid not in self.discovery.get_discovered_nodes():
                    status = "secure" if m.verify_key_exchange_state(pid) else "connected"
                    rows.append(f"  {pid[:12]}…  {status}"
                                f"  unread={self.store.get_unread_count(pid)}")
            self.print("\n".join(rows) if rows else "  (no peers)")
        elif cmd == "/connect":
            host = args[0]
            port = int(args[1]) if len(args) > 1 else 8000
            pid = await self.node.connect_to_peer(host, port)
            self.print(f"connected to {pid[:12]}…" if pid else "connect failed")
        elif cmd == "/key":
            ok = await m.initiate_key_exchange(self._peer(args[0]))
            self.print("shared key established" if ok else "key exchange failed")
        elif cmd == "/send":
            sent = await m.send_message(self._peer(args[0]), " ".join(args[1:]).encode())
            self.print("sent" if sent else "send failed")
        elif cmd == "/sendfile":
            sent = await m.send_file(self._peer(args[0]), Path(args[1]))
            self.print("sent" if sent else "send failed")
        elif cmd == "/settings":
            s = m.get_settings()
            self.print(f"current: kem={s['kem']} aead={s['aead']} sig={s['signature']}")
            self.print(f"kems: {', '.join(list_kems())}")
            self.print(f"aeads: {', '.join(list_symmetrics())}")
            self.print(f"signatures: {', '.join(list_signatures())}")
        elif cmd == "/set":
            kind, name = args[0], args[1]
            if kind == "kem":
                await m.set_key_exchange_algorithm(name)
            elif kind == "aead":
                await m.set_symmetric_algorithm(name)
            elif kind == "sig":
                await m.set_signature_algorithm(name)
            else:
                self.print("usage: /set kem|aead|sig <name>")
                return True
            self.print(f"{kind} -> {name}")
        elif cmd == "/adopt":
            ok = await m.adopt_peer_settings(self._peer(args[0]))
            self.print("adopted peer settings" if ok else "no gossiped settings for peer")
        elif cmd == "/metrics":
            if args and args[0] == "prom":
                # the SAME exposition path the HTTP GET /metrics endpoint
                # serves (obs/http.py) — one serializer, two surfaces
                from .obs.metrics import prometheus_text

                self.print(prometheus_text(m.registry))
            else:
                self.print(json.dumps(
                    {
                        "security": self.secure_logger.get_security_metrics(),
                        "operational": m.metrics(),
                    },
                    indent=2, default=str,
                ))
        elif cmd == "/slo":
            status = m.slo_status()
            self.print(json.dumps(status, indent=2, default=str))
            if status["alerting"]:
                self.print(f"ALERTING: {', '.join(status['alerting'])}")
        elif cmd == "/trace":
            from .obs import trace as obs_trace

            records = obs_trace.TRACER.snapshot()
            path = Path(args[0]) if args else (
                get_app_data_dir() / f"trace_{int(time.time())}.json"
            )

            def _export(records=records, path=path):
                # render + serialize + write all off-loop: at the ring cap
                # that is thousands of event dicts, and the loop is also
                # serving TCP peers
                path.write_text(json.dumps(obs_trace.to_chrome_trace(records)))

            await asyncio.get_running_loop().run_in_executor(None, _export)
            self.print(f"{len(records)} span(s) -> {path} "
                       "(load in chrome://tracing or ui.perfetto.dev)")
        elif cmd == "/flight":
            from .obs import flight as obs_flight

            path = Path(args[0]) if args else (
                get_app_data_dir() / f"flight_{int(time.time())}.json"
            )
            bundle = await asyncio.get_running_loop().run_in_executor(
                None, obs_flight.dump, "manual", path
            )
            self.print(f"{len(bundle['events'])} event(s) -> {path}")
        elif cmd == "/logs":
            # Filter surface of the reference's log viewer (event-type combo +
            # time-range pickers, ui/log_viewer_dialog.py:137-151) as args:
            #   /logs [type] [n] [--since T] [--until T]
            # T = relative (30m/2h/1d), HH:MM (today), or ISO date[Ttime].
            start_t, end_t, rest = _parse_time_range(args)
            etype = rest[0] if rest and not rest[0].isdigit() else None
            n = int(rest[-1]) if rest and rest[-1].isdigit() else 20
            events = self.secure_logger.get_events(
                event_type=etype, start_time=start_t, end_time=end_t
            )[-n:]
            for ev in events:
                ts = time.strftime("%H:%M:%S", time.localtime(ev.get("timestamp", 0)))
                fields = {k: v for k, v in ev.items() if k not in ("timestamp", "event_type")}
                self.print(f"  {ts} {ev.get('event_type')} {fields}")
            if not events:
                self.print("  (no events)")
        elif cmd == "/clearlogs":
            self.print(f"deleted {self.secure_logger.clear_logs()} log file(s)")
        elif cmd == "/keyhistory":
            entries = self.storage.list_key_history(args[0] if args else None)
            for e in entries:
                self.print(f"  {e['name']}  peer={e.get('peer_id', '?')[:12]}  "
                           f"algo={e.get('algo', '?')}")
            if not entries:
                self.print("  (none)")
        elif cmd == "/showkey":
            # Parity with the reference's key-history dialog: security
            # warning before decrypt, hex/base64/decimal display, every
            # access audited (ui/key_history_dialog.py:336-501).
            entry = args[0]
            fmt = args[1] if len(args) > 1 else "hex"
            if fmt not in ("hex", "base64", "decimal"):
                self.print("usage: /showkey <entry> [hex|base64|decimal]")
                return True
            self.print(
                "WARNING: displaying a decrypted key exposes secret material\n"
                "on screen and in terminal scrollback. Anyone who records it\n"
                "can decrypt past traffic protected by this key."
            )
            confirm = await self._prompt("type YES to decrypt and display: ")
            if confirm != "YES":
                self.secure_logger.log_event(
                    "key_history_access", entry=entry, granted=False
                )
                self.print("cancelled")
                return True
            v = self.storage.get_key_history_value(entry)
            self.secure_logger.log_event(
                "key_history_access", entry=entry, granted=True, found=v is not None
            )
            if v is None:
                self.print("not found")
            else:
                import base64

                raw = base64.b64decode(v["key"])  # save_peer_shared_key stores b64
                if fmt == "hex":
                    self.print(f"  hex: {raw.hex()}")  # qrlint: disable=flow-secret-format — /key IS the user-invoked decrypt-and-display command (YES-confirmed + audit-logged), parity with the reference's key-view dialog
                elif fmt == "base64":
                    self.print(f"  base64: {base64.b64encode(raw).decode()}")  # qrlint: disable=flow-secret-format — /key IS the user-invoked decrypt-and-display command (YES-confirmed + audit-logged)
                else:
                    self.print(f"  decimal: {' '.join(str(b) for b in raw)}")  # qrlint: disable=flow-secret-format — /key IS the user-invoked decrypt-and-display command (YES-confirmed + audit-logged)
        elif cmd == "/delkey":
            ok = self.storage.delete_key_history(args[0])
            self.secure_logger.log_event("key_history_changed", deleted=args[0], ok=ok)
            self.print("deleted" if ok else "not found")
        elif cmd == "/clearhistory":
            n = self.storage.clear_key_history()
            self.secure_logger.log_event("key_history_changed", cleared=n)
            self.print(f"deleted {n} entries")
        elif cmd == "/passwd":
            old = await self._getpass("old password: ")
            new = await self._getpass("new password: ")
            if new != await self._getpass("confirm: "):
                self.print("mismatch")
            elif self.storage.change_password(old, new):
                self.secure_logger.log_event("password_change")
                self.print("password changed")
            else:
                self.print("wrong password")
        elif cmd == "/reset":
            confirm = await self._prompt("type RESET to destroy the vault and start fresh: ")
            if confirm == "RESET":
                new = await self._getpass("new password: ")
                self.storage.reset_storage(new)
                self.print("vault reset")
            else:
                self.print("cancelled")
        elif cmd == "/batchstats":
            if m._bkem is None:
                self.print("batching disabled (start with --batch)")
            else:
                self.print(json.dumps({"kem": m._bkem.stats(), "sig": m._bsig.stats()},
                                      indent=2))
        else:
            self.print(f"unknown command {cmd}; /help for a list")
        return True

    async def _prompt(self, text: str) -> str:
        """Read one confirmation line.

        Inside the running REPL, stdin belongs to the asyncio reader
        (connect_read_pipe sets the fd non-blocking — a raw input() would
        raise BlockingIOError), so read through it; programmatic callers
        without a REPL get plain input().
        """
        if self._reader is not None:
            self.print(text)
            line = await self._reader.readline()
            return line.decode().strip()
        # No REPL reader: a blocking input() would stall every connected peer
        # (the loop also serves TCP); read it on a worker thread instead.
        line = await asyncio.get_running_loop().run_in_executor(None, input, text)
        return line.strip()

    async def _getpass(self, prompt: str) -> str:
        """Echo-free password read off the event loop (getpass blocks)."""
        return await asyncio.get_running_loop().run_in_executor(
            None, getpass.getpass, prompt
        )

    def _peer(self, prefix: str) -> str:
        """Resolve a peer-id prefix to a full id."""
        candidates = set(self.node.get_peers())
        if self.discovery:
            candidates |= set(self.discovery.get_discovered_nodes())
        matches = [p for p in candidates if p.startswith(prefix)]
        if len(matches) == 1:
            return matches[0]
        if not matches:
            return prefix  # allow full ids for not-yet-listed peers
        raise ValueError(f"ambiguous peer prefix {prefix!r}: {matches}")

    # ------------------------------------------------------------------ REPL

    async def repl(self) -> None:
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin
        )
        self._reader = reader
        self.print("type /help for commands")
        while not self._stop.is_set():
            line = await reader.readline()
            if not line:
                await self.stop()
                break
            if not await self.handle(line.decode()):
                break


def main(argv: list[str] | None = None) -> int:
    import argparse

    from .config import BACKENDS, Config

    ap = argparse.ArgumentParser(prog="quantum_resistant_p2p_tpu_torch")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--vault", default=None, help="vault file path")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="where the crypto runs (default cuda, or QRP2P_BACKEND)")
    ap.add_argument("--batch", action="store_true", help="enable the GPU batch queues")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="split GPU batches across this many devices (0 = one; "
                         "more is not ported and raises)")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    help="serve live read-only telemetry endpoints on this "
                         "localhost port (0 = ephemeral; default off, or "
                         "QRP2P_HTTP_PORT)")
    ap.add_argument("--config", default=None, help="config file path")
    ap.add_argument("--no-discovery", action="store_true")
    ap.add_argument("--tui", action="store_true",
                    help="two-pane curses UI (live peer list + chat)")
    ap.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)

    cfg = Config.load(
        path=args.config,
        port=args.port,
        backend=args.backend,
        use_batching=True if args.batch else None,
        mesh_devices=args.mesh_devices,
    )

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        filename=str(get_app_data_dir() / "system.log"),
    )

    cli = CLI(
        vault_path=args.vault,
        port=cfg.port,
        backend=cfg.backend,
        use_batching=cfg.use_batching,
        mesh_devices=cfg.mesh_devices,
        enable_discovery=not args.no_discovery,
        telemetry_port=args.telemetry_port,
    )
    if not cli.login_interactive():
        return 1

    if args.tui:
        from .tui import run_tui

        try:
            run_tui(cli)
        except KeyboardInterrupt:
            pass
        return 0

    async def run():
        await cli.start()
        await cli.repl()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
