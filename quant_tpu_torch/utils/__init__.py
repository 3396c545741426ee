"""Interchange with the JAX package's variable trees."""
