"""Ops: kernel registry, dense attention and the codec kernels."""
