"""Fused handshake programs: one protocol step's device work in one call."""
