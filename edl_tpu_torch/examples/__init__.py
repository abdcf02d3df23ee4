"""Ports of the JAX package's ``examples/`` scripts."""
