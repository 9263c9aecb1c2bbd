"""Application layer: the secure-messaging protocol engine, resumption
tickets and the in-memory message store."""

from .message_store import Message, MessageStore
from .messaging import KeyExchangeState, SecureMessaging

__all__ = ["Message", "MessageStore", "KeyExchangeState", "SecureMessaging"]
