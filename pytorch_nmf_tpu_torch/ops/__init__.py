"""Compute layer: MU engine, fused kernels and their wrappers, solvers."""
