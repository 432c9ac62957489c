from .ops import bucket_shape, canny_edge, canny_edge_batch  # noqa: F401
