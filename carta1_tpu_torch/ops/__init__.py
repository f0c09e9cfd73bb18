"""Batched device ops of the decode path and the kernel wrappers (K1-K3)."""
