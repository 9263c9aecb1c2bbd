"""In-memory message store with unread tracking.

Counterpart of the reference's ``app/message_store.py``: chat history is
memory-only and dies with the process.  Stdlib only.
"""

from __future__ import annotations

import base64
import time
import uuid
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Message:
    """One chat or file message."""

    content: bytes
    sender_id: str
    recipient_id: str
    timestamp: float = field(default_factory=time.time)
    message_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    is_file: bool = False
    filename: str | None = None
    is_system: bool = False
    key_exchange_algo: str = ""
    symmetric_algo: str = ""
    signature_algo: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "content": base64.b64encode(self.content).decode("ascii"),
            "sender_id": self.sender_id,
            "recipient_id": self.recipient_id,
            "timestamp": self.timestamp,
            "message_id": self.message_id,
            "is_file": self.is_file,
            "filename": self.filename,
            "is_system": self.is_system,
            "key_exchange_algo": self.key_exchange_algo,
            "symmetric_algo": self.symmetric_algo,
            "signature_algo": self.signature_algo,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Message":
        d = dict(d)
        d["content"] = base64.b64decode(d["content"])
        return cls(**d)


class MessageStore:
    """Per-conversation history + unread counts (memory only)."""

    def __init__(self) -> None:
        self._conversations: dict[str, list[Message]] = {}
        self._unread: dict[str, int] = {}

    def add_message(self, peer_id: str, message: Message, unread: bool = False) -> None:
        self._conversations.setdefault(peer_id, []).append(message)
        if unread:
            self._unread[peer_id] = self._unread.get(peer_id, 0) + 1

    def get_messages(self, peer_id: str) -> list[Message]:
        return list(self._conversations.get(peer_id, []))

    def get_unread_count(self, peer_id: str) -> int:
        return self._unread.get(peer_id, 0)

    def mark_read(self, peer_id: str) -> None:
        self._unread.pop(peer_id, None)

    def conversations(self) -> list[str]:
        return list(self._conversations)
