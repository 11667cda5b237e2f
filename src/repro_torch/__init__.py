"""PyTorch + CUDA port of the Broken-Booth reproduction (``src/repro``).

The package mirrors ``repro``'s subpackages and names so each counterpart
is found by path.  Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas is a hand-written CUDA kernel for Hopper
(``kernels/csrc``), built on first use.  Entry points take ``device=None``,
which means the GPU; ``device="cpu"`` runs the kernels' plain PyTorch
versions instead (the tests' setting).  Nothing here imports ``jax`` or
``repro``.
"""
