"""Observability pieces the batching queue reads."""
