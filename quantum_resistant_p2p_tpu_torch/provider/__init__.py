"""The provider boundary: KEM and signature providers, their registry and
the batching queues that coalesce concurrent operations into GPU batches."""

from .batched import BatchedKEM, BatchedSignature, OpQueue, QueueStats
from .kem_providers import MLKEMKeyExchange
from .registry import get_kem, get_signature, list_kems, list_signatures
from .sig_providers import MLDSASignature

__all__ = ["BatchedKEM", "BatchedSignature", "MLDSASignature", "MLKEMKeyExchange", "OpQueue",
           "QueueStats", "get_kem", "get_signature", "list_kems", "list_signatures"]
