"""The port's TUI (``quantum_resistant_p2p_tpu_torch/tui.py``): the 4 tests
of ``tests/test_tui.py`` on the port's ``Tui`` and ``CLI`` ("cpu"), its pure
helpers and key handling driven without a terminal.

The render loop needs a real curses screen; everything else — peer rows,
wrapping, the pane writer, and the full key->command path over a live
two-node stack — is exercised here.  Tolerance: exact.  No JAX program;
every test sets ``QRP2P_TPU_HOME`` to a temporary directory.
"""

import asyncio
import collections

import pytest
import torch

from quantum_resistant_p2p_tpu_torch.cli import CLI
from quantum_resistant_p2p_tpu_torch.tui import Tui, _PaneWriter, peer_rows, wrap_lines


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_TPU_HOME", str(tmp_path / "home"))


def test_wrap_lines_wraps_and_tails():
    lines = ["abcdef", "", "xy"]
    assert wrap_lines(lines, 3, 10) == ["abc", "def", "", "xy"]
    assert wrap_lines(lines, 3, 2) == ["", "xy"]


def test_pane_writer_splits_lines():
    buf = collections.deque()
    w = _PaneWriter(buf)
    print("one", file=w)
    print("two\nthree", file=w)
    assert list(buf) == ["one", "two", "three"]


@pytest.fixture
def run():
    loop = asyncio.new_event_loop()
    yield loop.run_until_complete
    loop.run_until_complete(loop.shutdown_asyncgens())
    loop.close()


def _mk(tmp_path, name):
    cli = CLI(vault_path=str(tmp_path / f"{name}.vault.json"), port=0,
              backend="cpu", enable_discovery=False)
    assert cli.login("pw-" + name)
    return cli


def test_tui_keys_drive_chat_over_live_stack(run, tmp_path):
    async def main():
        a = _mk(tmp_path, "a")
        b = _mk(tmp_path, "b")
        await a.start()
        await b.start()
        tui = Tui(a)  # captures a.out into tui.lines

        async def type_line(text):
            for c in text:
                assert await tui.on_key(ord(c))
            return await tui.on_key(10)  # Enter

        await type_line(f"/connect 127.0.0.1 {b.node.port}")
        await asyncio.sleep(0.05)
        peer_b = a.node.get_peers()[0]
        rows = peer_rows(a, 0)
        assert rows and rows[0][1] and peer_b[:12] in rows[0][0]
        assert "conn" in rows[0][0]

        await type_line(f"/key {peer_b[:8]}")
        assert any("shared key established" in ln for ln in tui.lines)
        rows = peer_rows(a, 0)
        assert "secure" in rows[0][0]

        # plain text goes to the selected peer
        got = asyncio.Event()
        b.messaging.register_message_listener(lambda p, m: got.set())
        await type_line("hello from the tui")
        await asyncio.wait_for(got.wait(), 5)

        # backspace edits, /quit exits the loop contract
        for c in "/quitX":
            await tui.on_key(ord(c))
        assert await tui.on_key(127)  # strip the X
        assert tui.input == "/quit"
        assert not await tui.on_key(10)

        await b.stop()

    run(main())


def test_unread_counts_in_peer_rows(run, tmp_path):
    async def main():
        a = _mk(tmp_path, "a3")
        b = _mk(tmp_path, "b3")
        await a.start()
        await b.start()
        await a.handle(f"/connect 127.0.0.1 {b.node.port}")
        await asyncio.sleep(0.05)
        peer_a = b.node.get_peers()[0]
        peer_b = a.node.get_peers()[0]
        await a.handle(f"/key {peer_b[:8]}")
        await a.handle(f"/send {peer_b[:8]} ping")
        for _ in range(100):
            if b.store.get_unread_count(peer_a):
                break
            await asyncio.sleep(0.02)
        rows = peer_rows(b, 0)
        assert any("(" in r[0] for r in rows)  # unread badge shown
        b.store.mark_read(peer_a)
        rows = peer_rows(b, 0)
        assert not any("(" in r[0] for r in rows)
        await a.stop()
        await b.stop()

    run(main())
