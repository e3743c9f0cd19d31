"""Dense model layers and assembly (the dense subset of the JAX package's models)."""
