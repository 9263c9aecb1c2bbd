"""PyTorch/CUDA port of quantum_resistant_p2p_tpu.

The batched post-quantum crypto of the JAX package, rebuilt on PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).  The layout mirrors
the JAX package (``core/keccak.py``, ``kem/mlkem.py``, ``provider/...``) so
each module's reference sits at the same path there.

The port imports nothing of the JAX package.  Module functions run where
their input tensors lie: CPU tensors take each kernel's plain PyTorch
version, CUDA tensors launch the kernel.  The entry points (``entry.py``,
``provider``) default to the GPU and raise when there is none.

Importing this package (or any module in it) builds nothing: kernels are
compiled with ``nvcc`` into ``build/torch_kernels/`` at their first launch.
"""
