"""Decode-path attention ops and the build of their CUDA kernels."""
