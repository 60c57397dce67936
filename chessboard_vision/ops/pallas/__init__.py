"""Pallas kernels (Triton route) for ops where XLA's lowering leaves headroom."""
