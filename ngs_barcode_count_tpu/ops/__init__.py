"""Device-side decode ops (plain JAX, compiled by XLA)."""
