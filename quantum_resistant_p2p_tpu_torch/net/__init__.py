"""Host networking: the asyncio TCP P2P transport, UDP discovery and node
identity (stdlib only; the GPU sits behind the provider layer's batching
queues, and this package moves opaque bytes and JSON)."""

from .discovery import NodeDiscovery
from .identity import load_or_generate_node_id
from .p2p_node import P2PNode, WireError

__all__ = ["NodeDiscovery", "P2PNode", "WireError", "load_or_generate_node_id"]
