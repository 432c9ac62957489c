from .ops import sobel_grad  # noqa: F401
