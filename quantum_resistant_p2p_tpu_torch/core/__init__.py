"""Hash primitives: the batched Keccak sponge and its CUDA kernel."""
