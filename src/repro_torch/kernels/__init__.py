"""Hand-written CUDA kernels and their plain PyTorch versions.

``ops`` is the dispatch every caller goes through: a CUDA tensor reaches
the kernel (or the call raises), a CPU tensor the plain version in
``ref``.  Kernel sources live in ``csrc/`` and are compiled by ``_build``
at first CUDA use, never at import.
"""
