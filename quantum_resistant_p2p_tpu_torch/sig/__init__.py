"""Signatures: batched ML-DSA (FIPS 204)."""
