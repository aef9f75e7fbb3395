"""Layers, normalizations and composite blocks."""
