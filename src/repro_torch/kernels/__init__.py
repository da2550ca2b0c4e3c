"""Hand-written Hopper kernels and their wrappers.

``score_select`` holds the fused HeteRo-Select kernels (K1–K4) and
``flash_attention`` the attention kernel (K5), each CUDA C++ in ``csrc/``
built on first use by ``_build``; ``ops`` is the public surface.
"""
