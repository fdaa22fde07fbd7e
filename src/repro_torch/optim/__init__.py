"""Optimizers over parameter trees (the JAX package's ``repro.optim``)."""
