"""Optimizers of the port: AdamW as the JAX package's ``repro.optim``."""
