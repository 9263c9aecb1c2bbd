"""The provider boundary: KEM (ML-KEM, FrodoKEM), signature (ML-DSA,
SPHINCS+-SHA2) and AEAD providers, the fused handshake capability, their
registry and the batching queues that coalesce concurrent operations into
GPU batches."""

from .aead_device import ChaChaPolyDevice
from .batched import (LANE_BULK, LANE_HANDSHAKE, LANE_NAMES, LANE_REKEY, BatchedAEAD,
                      BatchedFused, BatchedKEM, BatchedSignature, Breaker, LaneShed, OpQueue,
                      QueueStats, facade_queues)
from .fused_providers import FusedMLKEMMLDSA, init_pk_offset, resp_ct_offset
from .kem_providers import FrodoKEMKeyExchange, MLKEMKeyExchange
from .registry import (get_batched_aead, get_fused, get_kem, get_signature, get_symmetric,
                       list_batched_aeads, list_fused, list_kems, list_signatures,
                       list_symmetrics)
from .sig_providers import MLDSASignature, SPHINCSSignature
from .symmetric import AES256GCM, ChaCha20Poly1305

__all__ = ["AES256GCM", "BatchedAEAD", "BatchedFused", "BatchedKEM", "BatchedSignature",
           "Breaker", "ChaCha20Poly1305", "ChaChaPolyDevice", "FrodoKEMKeyExchange", "FusedMLKEMMLDSA",
           "LANE_BULK", "LANE_HANDSHAKE", "LANE_NAMES", "LANE_REKEY", "LaneShed",
           "MLDSASignature", "MLKEMKeyExchange", "OpQueue", "QueueStats", "SPHINCSSignature",
           "facade_queues", "get_batched_aead", "get_fused", "get_kem", "get_signature",
           "get_symmetric", "init_pk_offset", "list_batched_aeads", "list_fused", "list_kems",
           "list_signatures", "list_symmetrics", "resp_ct_offset"]
