"""The generator and the correspondence network."""
