"""PyTorch / CUDA port of deeplearning4j_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/pallas/`` becomes ``ops/kernels/``)
and its public names, with PyTorch as the array layer and hand-written
CUDA kernels where the JAX package had Pallas kernels.  It never imports
``jax`` or ``deeplearning4j_tpu``.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
