"""Shared helpers: key-buffer wiping and the CUDA kernel loader."""
