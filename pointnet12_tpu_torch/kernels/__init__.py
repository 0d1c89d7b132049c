"""Wrappers of the hand-written CUDA kernels, their dispatch and build.

Importing a wrapper module builds nothing: ``build.py`` calls nvcc at the
first launch, and every wrapper launches through ``build.launch``.
"""
