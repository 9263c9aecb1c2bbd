"""Atomic, lock-protected file IO for key vaults and audit logs.

Counterpart of the JAX package's ``storage/secure_file.py`` (stdlib only),
copied as it is.

Fills the role of the reference's utils/secure_file.py:118-397 (SecureFile:
fcntl/msvcrt handle locks, PID lock-files with stale detection, atomic
write-via-temp+rename with .bak fallback) with a fresh design:

* ``FileLock`` — an advisory inter-process lock: O_CREAT lockfile holding
  ``pid:timestamp``, fcntl.flock on POSIX; a lock older than STALE_AFTER
  seconds, or whose pid is dead, is broken automatically.
* ``AtomicFile`` — read/write JSON or raw bytes with write-to-temp + fsync +
  os.replace, keeping a ``.bak`` of the previous generation and falling back
  to it when the primary is corrupt.
"""

from __future__ import annotations

import contextlib
import errno
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Any

try:  # POSIX
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX hosts
    fcntl = None  # type: ignore[assignment]

logger = logging.getLogger(__name__)

STALE_AFTER = 3600.0  # seconds after which a lockfile is presumed abandoned

#: lock-retry backoff bounds: start fast (a writer usually finishes in
#: milliseconds), grow 2x per miss so a contended lock doesn't spin the CPU,
#: never wait longer than the cap (keeps worst-case latency additive, not
#: multiplicative, near the deadline)
_BACKOFF_INITIAL = 0.005
_BACKOFF_CAP = 0.25


def backoff_delays(deadline: float):
    """Monotonic-deadline exponential backoff: yields sleep durations until
    ``time.monotonic()`` passes ``deadline``, then stops.

    Pure iterator — it never sleeps itself, so the SAME schedule drives both
    the sync path (``time.sleep``) and the async path (``asyncio.sleep``)
    without this module choosing a blocking primitive for its callers.
    """
    delay = _BACKOFF_INITIAL
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        yield min(delay, remaining, _BACKOFF_CAP)
        delay = min(delay * 2, _BACKOFF_CAP)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM
    return True


class FileLock:
    """Advisory inter-process lock guarding a data file.

    Creates ``<path>.lock`` containing ``pid:monotonic-wallclock``; stale locks
    (dead pid or older than STALE_AFTER) are removed and retaken.
    """

    def __init__(self, path: str | os.PathLike, timeout: float = 10.0):
        self.lock_path = Path(str(path) + ".lock")
        self.timeout = timeout
        self._fd: int | None = None

    def acquire(self) -> None:
        """Take the lock, sleeping between retries (SYNC-ONLY: blocks the
        calling thread; from a coroutine use :meth:`acquire_async` — qrlint's
        blocking-in-async rule rejects direct calls in ``async def``)."""
        delays = backoff_delays(time.monotonic() + self.timeout)
        while not self._try_once():
            delay = next(delays, None)
            if delay is None:
                raise TimeoutError(f"could not lock {self.lock_path}")
            time.sleep(delay)

    async def acquire_async(self) -> None:
        """Async twin of :meth:`acquire`: identical backoff schedule, but
        yields the event loop between retries instead of blocking it."""
        import asyncio

        delays = backoff_delays(time.monotonic() + self.timeout)
        while not self._try_once():
            delay = next(delays, None)
            if delay is None:
                raise TimeoutError(f"could not lock {self.lock_path}")
            await asyncio.sleep(delay)

    def _try_once(self) -> bool:
        """One non-blocking acquisition attempt."""
        self._break_if_stale()
        try:
            fd = os.open(self.lock_path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        except FileExistsError:
            return False
        os.write(fd, f"{os.getpid()}:{time.time()}".encode())
        if fcntl is not None:
            fcntl.flock(fd, fcntl.LOCK_EX)
        self._fd = fd
        return True

    def release(self) -> None:
        if self._fd is None:
            return
        try:
            if fcntl is not None:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
        finally:
            self._fd = None
            with contextlib.suppress(OSError):
                self.lock_path.unlink()

    def _break_if_stale(self) -> None:
        try:
            raw = self.lock_path.read_text()
            pid_s, ts_s = raw.split(":", 1)
            pid, ts = int(pid_s), float(ts_s)
        except (OSError, ValueError):
            return  # no lock, or unreadable (racing); let acquire loop retry
        if not _pid_alive(pid) or (time.time() - ts) > STALE_AFTER:
            logger.warning("breaking stale lock %s (pid=%s)", self.lock_path, pid_s)
            with contextlib.suppress(OSError):
                self.lock_path.unlink()

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    async def __aenter__(self) -> "FileLock":
        await self.acquire_async()
        return self

    async def __aexit__(self, *exc: object) -> None:
        self.release()


class AtomicFile:
    """Crash-safe reads/writes of a single file with backup fallback."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.bak_path = Path(str(path) + ".bak")
        self.lock = FileLock(path)

    # -- JSON ---------------------------------------------------------------

    def read_json(self, default: Any = None) -> Any:
        with self.lock:
            for candidate in (self.path, self.bak_path):
                try:
                    with open(candidate, "r", encoding="utf-8") as f:
                        data = json.load(f)
                    if candidate is self.bak_path:
                        logger.warning("restored %s from backup", self.path)
                    return data
                except FileNotFoundError:
                    continue
                except (json.JSONDecodeError, OSError) as e:
                    logger.error("unreadable %s: %s", candidate, e)
                    continue
            return default

    def write_json(self, data: Any) -> None:
        with self.lock:
            self._replace(json.dumps(data, indent=2).encode("utf-8"))

    # -- raw bytes ----------------------------------------------------------

    def read_bytes(self) -> bytes:
        with self.lock:
            try:
                return self.path.read_bytes()
            except FileNotFoundError:
                return b""

    def write_bytes(self, data: bytes) -> None:
        with self.lock:
            self._replace(data)

    def append_bytes(self, data: bytes) -> None:
        with self.lock:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "ab") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())

    # -- internals ----------------------------------------------------------

    def _replace(self, payload: bytes) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, prefix=self.path.name + ".tmp")
        try:
            os.write(fd, payload)
            os.fsync(fd)
        finally:
            os.close(fd)
        if self.path.exists():
            with contextlib.suppress(OSError):
                os.replace(self.path, self.bak_path)
        os.replace(tmp, self.path)
        os.chmod(self.path, 0o600)
