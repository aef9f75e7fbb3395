"""Optimizer state and the fused G+D train step."""
