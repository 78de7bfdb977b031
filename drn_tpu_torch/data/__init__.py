"""Host data layer of the port (own copies; the JAX package's readers of
real datasets are not ported yet)."""
