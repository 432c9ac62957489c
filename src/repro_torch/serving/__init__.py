"""Serving plane: dispatch queues, execution backends and ``EcoreService``."""
