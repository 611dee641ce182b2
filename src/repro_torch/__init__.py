"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

Same sub-package and module names as the reference, so each module's
counterpart is found by name.  Imports ``torch``, ``numpy`` and the
standard library only.
"""
