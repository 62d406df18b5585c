"""Kernels and tensor ops of the port (attention, paged KV cache)."""
