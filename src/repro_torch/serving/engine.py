"""Dispatch plane: the queued request, its result, and the per-backend
``DispatchQueue`` that batches requests into ``serve_batch`` calls.

The LLM ``Backend`` of ``repro.serving.engine`` waits for a later slice of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 8
    # complexity metadata (the serving analog of the paper's object count):
    group: Optional[int] = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray
    prefill_s: float            # wall time of the WHOLE batch's prefill
    decode_s: float             # wall time of the WHOLE batch's decode
    backend: str
    batch_size: int = 1         # divide the times by this for per-request cost
    # workload-specific extras (the detection face fills these; LLM serving
    # leaves them None): per-request (boxes, scores, classes) plus the
    # modeled device cost actually charged
    detections: Optional[tuple] = None
    time_ms: Optional[float] = None
    energy_mwh: Optional[float] = None


class DispatchQueue:
    """Per-backend request queue with batched flush.

    Requests accumulate until ``backend.max_batch`` is reached, then go out
    batched.  Each flush makes one ``serve_batch`` call per distinct
    payload LENGTH (``len`` of the payload: the frame height for the
    detection face), so every call receives payloads it can stack.  The
    JAX package's ``max_wait_ms`` deadline waits for the traffic plane's
    slice of the port."""

    def __init__(self, backend):
        self.backend = backend
        self.pending: List[Request] = []
        self.calls = 0
        self.served = 0

    def submit(self, req: Request) -> List[Result]:
        """Enqueue; returns flushed results when the batch fills, else
        []."""
        self.pending.append(req)
        if len(self.pending) >= self.backend.max_batch:
            return self.flush()
        return []

    def flush(self) -> List[Result]:
        if not self.pending:
            return []
        batch, self.pending = self.pending, []
        by_len: Dict[int, List[Request]] = {}
        for r in batch:
            by_len.setdefault(len(r.prompt), []).append(r)
        results: List[Result] = []
        for _, group in sorted(by_len.items()):
            self.calls += 1
            self.served += len(group)
            results += self.backend.serve_batch(group)
        return results
