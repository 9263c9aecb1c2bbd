"""Key-encapsulation mechanisms: batched ML-KEM (FIPS 203), FrodoKEM and HQC."""
