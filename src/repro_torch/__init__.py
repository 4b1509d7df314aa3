"""FedHP on PyTorch and CUDA: the port of the JAX package ``repro``.

The same system — data, simulated cluster, strategies, the reference and
fused synchronous round engines — with the fused engine's gossip through
a hand-written Hopper kernel (``kernels/csrc``). The JAX package is the
reference the port's tests hold it against; nothing here imports it.
"""
