"""PyTorch/CUDA port of the ``repro`` package (the serving stack and the
hlslib core) for NVIDIA Hopper.

The JAX package (``src/repro``) is the reference; this package keeps its
module layout so each module's counterpart is easy to find, and imports
``torch`` only — never ``jax`` and nothing of ``repro``.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
