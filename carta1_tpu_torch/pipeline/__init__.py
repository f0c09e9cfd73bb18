"""Batched decoder pipeline."""
