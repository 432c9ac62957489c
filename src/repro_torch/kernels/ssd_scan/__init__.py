from .ops import ssd  # noqa: F401
