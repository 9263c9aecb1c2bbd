"""Curses TUI — live peer list + chat pane over the CLI core.

Counterpart of the JAX package's ``tui.py`` (stdlib ``curses``): a two-pane
terminal UI with the peer list refreshing every 2 s, unread counts in the
peer rows, a scrolling message pane, and an input line that accepts plain
text (sent to the selected peer) or any slash command of the CLI
(``cli.HELP``).

The command processor is the SAME ``cli.CLI`` object the line client uses —
the TUI replaces stdin/stdout with a key poller and a ring buffer, so every
command path stays single-sourced and tested.  Pure helpers (`peer_rows`,
`wrap_lines`) are testable without a terminal (tests/test_torch_tui.py).

Run: ``qrp2p-torch --tui`` (or ``python -m quantum_resistant_p2p_tpu_torch
--tui``).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time

from .cli import CLI

PEER_PANE_W = 28
POLL_S = 0.05        # key poll cadence
REFRESH_S = 2.0      # peer-list refresh (reference cadence)
HISTORY = 500


def peer_rows(cli: CLI, selected: int) -> list[tuple[str, bool]]:
    """-> [(row text, is_selected)] for the peer pane.

    Mirrors the reference peer list's status column (Discovered /
    Connected / Secure, ui/peer_list.py:166-196) plus unread counts.
    """
    rows: list[tuple[str, bool]] = []
    if cli.messaging is None:
        return rows
    m = cli.messaging
    connected = set(cli.node.get_peers()) if cli.node else set()
    discovered = set()
    if cli.discovery:
        discovered = set(cli.discovery.get_discovered_nodes())
    ordered = sorted(connected) + sorted(discovered - connected)
    for i, pid in enumerate(ordered):
        if pid in connected:
            status = "secure" if m.verify_key_exchange_state(pid) else "conn"
        else:
            status = "disc"
        unread = cli.store.get_unread_count(pid)
        mark = f" ({unread})" if unread else ""
        text = f"{pid[:12]} {status}{mark}"
        rows.append((text[: PEER_PANE_W - 2], i == selected))
    return rows


def wrap_lines(lines, width: int, height: int) -> list[str]:
    """Last ``height`` display rows of ``lines`` wrapped to ``width``."""
    out: list[str] = []
    for line in lines:
        line = str(line)
        if not line:
            out.append("")
            continue
        while line:
            out.append(line[:width])
            line = line[width:]
    return out[-height:]


class _PaneWriter:
    """File-like object capturing CLI .print output into the message pane."""

    def __init__(self, buf: collections.deque):
        self.buf = buf

    def write(self, text: str) -> None:
        for ln in text.split("\n"):
            if ln.strip("\r"):
                self.buf.append(ln.rstrip("\r"))

    def flush(self) -> None:  # pragma: no cover - file protocol
        pass


class Tui:
    def __init__(self, cli: CLI):
        self.cli = cli
        self.lines: collections.deque = collections.deque(maxlen=HISTORY)
        cli.out = _PaneWriter(self.lines)
        self.input = ""
        self.selected = 0
        self._dirty = True

    # ------------------------------------------------------------- selection

    def _ordered_peers(self) -> list[str]:
        connected = set(self.cli.node.get_peers()) if self.cli.node else set()
        discovered = (set(self.cli.discovery.get_discovered_nodes())
                      if self.cli.discovery else set())
        return sorted(connected) + sorted(discovered - connected)

    def selected_peer(self) -> str | None:
        peers = self._ordered_peers()
        if not peers:
            return None
        return peers[min(self.selected, len(peers) - 1)]

    # ------------------------------------------------------------------ keys

    async def on_key(self, ch: int) -> bool:
        """Process one key; returns False when the TUI should exit."""
        import curses

        if ch in (curses.KEY_UP,):
            self.selected = max(0, self.selected - 1)
        elif ch in (curses.KEY_DOWN, 9):  # down or Tab
            self.selected = min(self.selected + 1,
                                max(0, len(self._ordered_peers()) - 1))
        elif ch in (curses.KEY_BACKSPACE, 127, 8):
            self.input = self.input[:-1]
        elif ch in (10, 13):  # Enter
            line = self.input.strip()
            self.input = ""
            if not line:
                return True
            if line.split()[0] in ("/showkey", "/passwd", "/reset"):
                # these flows prompt interactively on stdin, which curses
                # owns; keep them in the line client where the prompt works
                self.lines.append(f"{line.split()[0]} is not available in the "
                                  "TUI — run the line client (qrp2p-torch "
                                  "without --tui) for interactive prompts")
            elif line.startswith("/"):
                if not await self.cli.handle(line):
                    return False
            else:
                peer = self.selected_peer()
                if peer is None:
                    self.lines.append("no peer selected (plain text sends to peer)")
                else:
                    # direct send: no shlex round-trip, so quotes/apostrophes
                    # in chat text survive; peer id is already fully resolved
                    sent = await self.cli.messaging.send_message(
                        peer, line.encode()
                    )
                    self.lines.append(f"[me -> {peer[:8]}] {line}" if sent
                                      else "send failed")
            # reading a peer's pane clears its unread count, like the
            # reference's bold-count reset on selection
            peer = self.selected_peer()
            if peer:
                self.cli.store.mark_read(peer)
        elif 32 <= ch < 127:
            self.input += chr(ch)
        self._dirty = True
        return True

    # ---------------------------------------------------------------- render

    def render(self, scr) -> None:
        import curses

        h, w = scr.getmaxyx()
        scr.erase()
        chat_w = max(20, w - PEER_PANE_W - 1)
        # peer pane
        scr.addnstr(0, 0, "peers (↑/↓ select)".ljust(PEER_PANE_W), PEER_PANE_W,
                    curses.A_BOLD)
        for y, (text, sel) in enumerate(peer_rows(self.cli, self.selected)):
            if y + 1 >= h - 2:
                break
            attr = curses.A_REVERSE if sel else curses.A_NORMAL
            scr.addnstr(y + 1, 0, text.ljust(PEER_PANE_W - 1), PEER_PANE_W - 1, attr)
        for y in range(h - 2):
            scr.addch(y, PEER_PANE_W, curses.ACS_VLINE)
        # message pane
        for y, ln in enumerate(wrap_lines(self.lines, chat_w, h - 3)):
            scr.addnstr(y, PEER_PANE_W + 1, ln, chat_w)
        # input line
        scr.hline(h - 2, 0, curses.ACS_HLINE, w)
        prompt = f"> {self.input}"
        scr.addnstr(h - 1, 0, prompt, w - 1)
        scr.move(h - 1, min(len(prompt), w - 2))
        scr.refresh()

    # ------------------------------------------------------------------ loop

    async def run(self, scr) -> None:
        import curses

        curses.curs_set(1)
        scr.nodelay(True)
        scr.keypad(True)
        self.lines.append("TUI: ↑/↓ pick a peer, type to chat, /help for commands")
        last_refresh = 0.0
        while True:
            ch = scr.getch()
            if ch != -1:
                if not await self.on_key(ch):
                    break
            now = time.monotonic()
            if now - last_refresh > REFRESH_S:
                last_refresh = now
                self._dirty = True
            if self._dirty:
                self._dirty = False
                try:
                    self.render(scr)
                except curses.error:
                    pass  # terminal resized mid-draw; next frame fixes it
                except Exception:
                    logging.getLogger(__name__).exception("TUI render failed")
            await asyncio.sleep(POLL_S)
        await self.cli.stop()


def run_tui(cli: CLI) -> None:
    """Login must have happened; runs the asyncio+curses loop to exit."""
    import curses

    def _main(scr):
        async def amain():
            # swap cli.out into the pane BEFORE start() so the startup
            # banner (port, backend, device, AES-256-GCM) lands in the UI
            tui = Tui(cli)
            await cli.start()
            await tui.run(scr)

        asyncio.run(amain())

    curses.wrapper(_main)
