from .ops import decode  # noqa: F401
