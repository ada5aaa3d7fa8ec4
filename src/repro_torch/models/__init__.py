"""Model code of the port: plain functions on tensors, parameters as a
dict in the JAX package's pytree layout."""
