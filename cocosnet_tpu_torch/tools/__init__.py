"""The port's twins of the JAX package's tools/ scripts."""
