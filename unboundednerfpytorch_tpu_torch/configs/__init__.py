"""configs subpackage (the port's own copies of the JAX package's loader and
schema, which contain no JAX code)."""
