"""Hand-written Hopper kernels and their wrappers.

``score_select`` holds the fused HeteRo-Select kernels (CUDA C++ in
``csrc/``, built on first use by ``_build``); ``ops`` is the public surface.
"""
