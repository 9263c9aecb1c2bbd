"""The session layer: resumption tickets and the in-memory message store."""
