from .ops import attention  # noqa: F401
