"""PyTorch/CUDA port of the SPSNet / IA-SSD detector framework.

The JAX package ``spsnet_tpu`` beside it is the reference; this package
imports nothing of it. Importing it builds nothing: the CUDA kernels in
``csrc/`` are compiled at first use.
"""
