"""PyTorch + CUDA (Hopper) port of ``llmspeculativesampling_tpu``.

The JAX package stays the reference; this package mirrors its sub-package
and module names (``core``, ``quant``, ``kernels``, ``models``, ``cache``,
``ops``, ``engine``) so each counterpart is easy to find. It imports
``torch`` and never ``jax``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``. On a CUDA tensor every kernel wrapper launches its
hand-written kernel (``csrc/``) or raises; the plain PyTorch version beside
each kernel serves CPU tensors (the tests) only.
"""
