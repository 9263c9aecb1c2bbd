"""Encrypted, append-only audit log.

Counterpart of the JAX package's ``storage/secure_logger.py``, in the same
file format under the same key, so a log written by either package reads in
the other.  Records are sealed with ``provider.symmetric.aes256gcm``:
OpenSSL's AES-256-GCM where the ``cryptography`` wheel is installed, the
port's own ``core.aesgcm`` otherwise.

Capability parity with the reference's app/logging.py (449 LoC): per-record
AES-256-GCM encryption, length-prefixed records appended to daily files,
thread safety, corruption recovery by scanning forward to the next decryptable
record, filtered queries, event summaries, aggregate security metrics, and
clear_logs.

Record wire format (fresh design):
    magic  b"QL"                  (2 bytes)
    length uint32 big-endian      (nonce + ciphertext length)
    nonce  12 bytes
    ct     AES-256-GCM(key, nonce, json-payload, ad=b"qrp2p-tpu-log-v1")

The magic makes scan-ahead recovery cheap: after a corrupt record, search for
the next b"QL" and try again (reference recovers similarly: app/logging.py:160-207).
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
from collections import Counter
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Iterator

from ..provider.symmetric import aes256gcm

logger = logging.getLogger(__name__)

_MAGIC = b"QL"
_AD = b"qrp2p-tpu-log-v1"


class SecureLogger:
    """AES-GCM encrypted audit log with daily files under ``log_dir``."""

    def __init__(self, key: bytes, log_dir: str | os.PathLike | None = None):
        if len(key) != 32:
            raise ValueError("SecureLogger requires a 32-byte key")
        self._aead = aes256gcm(key)
        from .key_storage import get_app_data_dir

        self.log_dir = Path(log_dir) if log_dir else get_app_data_dir() / "logs"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()

    # -- write --------------------------------------------------------------

    def _current_file(self) -> Path:
        day = datetime.now(timezone.utc).strftime("%Y-%m-%d")
        return self.log_dir / f"{day}.qlog"

    def log_event(self, event_type: str, **fields: Any) -> None:
        record = {"event_type": event_type, "timestamp": time.time(), **fields}
        payload = json.dumps(record, separators=(",", ":")).encode()
        nonce = os.urandom(12)
        ct = self._aead.encrypt(nonce, payload, _AD)
        frame = _MAGIC + struct.pack(">I", len(nonce) + len(ct)) + nonce + ct
        with self._lock:
            with open(self._current_file(), "ab") as f:
                f.write(frame)
                f.flush()
                os.fsync(f.fileno())

    # -- read ---------------------------------------------------------------

    def _iter_file(self, path: Path) -> Iterator[dict]:
        try:
            blob = path.read_bytes()
        except OSError:
            return
        pos = 0
        while pos < len(blob):
            idx = blob.find(_MAGIC, pos)
            if idx < 0:
                break
            try:
                (length,) = struct.unpack_from(">I", blob, idx + 2)
                start = idx + 6
                chunk = blob[start : start + length]
                if len(chunk) != length:
                    raise ValueError("truncated record")
                pt = self._aead.decrypt(chunk[:12], chunk[12:], _AD)
                yield json.loads(pt)
                pos = start + length
            except Exception:
                # Corrupt record: scan ahead to the next magic.
                pos = idx + 2
                logger.debug("skipping corrupt log record in %s @%d", path, idx)

    def get_events(
        self,
        event_type: str | None = None,
        start_time: float | None = None,
        end_time: float | None = None,
        limit: int | None = None,
    ) -> list[dict]:
        with self._lock:
            out: list[dict] = []
            for path in sorted(self.log_dir.glob("*.qlog")):
                for rec in self._iter_file(path):
                    if event_type is not None and rec.get("event_type") != event_type:
                        continue
                    ts = rec.get("timestamp", 0.0)
                    if start_time is not None and ts < start_time:
                        continue
                    if end_time is not None and ts > end_time:
                        continue
                    out.append(rec)
            out.sort(key=lambda r: r.get("timestamp", 0.0))
            if limit is not None:
                out = out[-limit:]
            return out

    def get_event_summary(self) -> dict[str, int]:
        return dict(Counter(rec.get("event_type", "?") for rec in self.get_events()))

    def get_security_metrics(self) -> dict[str, Any]:
        """Aggregate usage metrics (reference: app/logging.py:379-432)."""
        events = self.get_events()
        algos: Counter[str] = Counter()
        totals: Counter[str] = Counter()
        bytes_sent = bytes_received = 0
        for rec in events:
            et = rec.get("event_type", "?")
            totals[et] += 1
            if "algorithm" in rec:
                algos[str(rec["algorithm"])] += 1
            if et == "message_sent":
                bytes_sent += int(rec.get("size", 0))
            elif et == "message_received":
                bytes_received += int(rec.get("size", 0))
        return {
            "total_events": len(events),
            "event_counts": dict(totals),
            "messages_sent": totals.get("message_sent", 0),
            "messages_received": totals.get("message_received", 0),
            "key_exchanges": totals.get("key_exchange", 0),
            "bytes_sent": bytes_sent,
            "bytes_received": bytes_received,
            "algorithms_used": dict(algos),
        }

    # -- hygiene -------------------------------------------------------------

    def zeroize(self) -> None:
        """Drop the AEAD (and with it the only handle on the log key): after
        this the instance can neither write nor decrypt — re-derive the
        purpose key from the vault to resume logging."""
        with self._lock:
            self._aead = None

    def clear_logs(self) -> int:
        with self._lock:
            n = 0
            for path in self.log_dir.glob("*.qlog"):
                path.unlink()
                n += 1
            return n
