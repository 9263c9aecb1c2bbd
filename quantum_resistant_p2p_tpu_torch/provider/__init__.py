"""The provider boundary: KEM providers, their registry and the batching
queue that coalesces concurrent operations into GPU batches."""

from .batched import BatchedKEM, OpQueue, QueueStats
from .kem_providers import MLKEMKeyExchange
from .registry import get_kem, list_kems

__all__ = ["BatchedKEM", "MLKEMKeyExchange", "OpQueue", "QueueStats", "get_kem", "list_kems"]
