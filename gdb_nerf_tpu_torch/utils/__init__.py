"""Weight conversion from the JAX package, and file readers."""
