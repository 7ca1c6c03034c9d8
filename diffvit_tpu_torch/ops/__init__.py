"""Quantization primitives and the hand-written kernels."""
