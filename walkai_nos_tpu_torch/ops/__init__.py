"""Attention ops (paged decode, full-sequence forward and backward) and
the build of their CUDA kernels."""
