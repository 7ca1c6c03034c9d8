"""Model specs, the integer forward and the JAX int-model converter."""
