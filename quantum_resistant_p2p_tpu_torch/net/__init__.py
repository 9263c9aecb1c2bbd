"""Host networking: the asyncio TCP P2P transport (stdlib only; the GPU
sits behind the provider layer's batching queues, and this package moves
opaque bytes and JSON)."""

from .p2p_node import P2PNode, WireError

__all__ = ["P2PNode", "WireError"]
