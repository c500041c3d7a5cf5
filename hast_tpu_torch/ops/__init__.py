"""Codec, marker table and the hand-written CUDA kernels (csrc/)."""
