from .ops import linear_scan, rglru  # noqa: F401
