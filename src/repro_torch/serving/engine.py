"""Batched serving engine: the LLM ``Backend`` (prefill + greedy decode
over a dense, MoE, VLM, Mamba-2, RecurrentGemma or Whisper model), the queued
request, its result, and the per-backend ``DispatchQueue`` that batches
requests into ``serve_batch`` calls.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.tokens import modality_inputs
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, decode_step, init_params, prefill
from repro_torch.models.kvcache import bounded_by_max_seq


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


class Backend:
    """One (model x device) pair exposing an inference API.

    Implements the ``ExecutionBackend`` protocol (serving/backend.py);
    registered under kind ``"llm"``.  The model runs on ``device`` (CUDA
    unless the caller asks for the CPU); ``params`` default to seeded
    random weights drawn there.  A vlm model's prefix embeddings (an
    encdec model's frame embeddings) are drawn for each batch from the
    backend's own generator (seeded with ``seed``), as the JAX package's
    backend draws them."""

    def __init__(self, name: str, cfg: ModelConfig, params=None, *,
                 max_batch: int = 8, max_seq: int = 256, seed: int = 0,
                 device="cuda"):
        self.name = name
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else init_params(
            cfg, seed, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self._rng = np.random.default_rng(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def serve_batch(self, requests: List[Request]) -> List[Result]:
        """Greedy-decode a batch of requests (one batch at a time).

        Prompts should share ONE length: shorter prompts are right-padded
        and the first generated token comes from the batch-wide last
        position (prefill only returns last-position logits), so mixed
        lengths corrupt the shorter requests' outputs — ``DispatchQueue``
        groups by length automatically.  With a global attention layer
        (``"attn"``) the prefix embeddings, the prompt and the generated
        tokens must fit ``max_seq`` (that layer's cache, kept in position
        order); an encdec model's frames feed its encoder, not that cache,
        and do not count.  A sliding-window layer's ring (``max_seq`` sizes
        it), an ssm or an RG-LRU state takes any length, as in the JAX
        package."""
        if not requests:
            raise ValueError("serve_batch needs at least one request")
        b = len(requests)
        max_prompt = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        prefix = modality_inputs(self.cfg, b, self._rng,
                                 device=self.device).get("prefix_embeds")
        # the prefix rows that enter the decoder's cache (not the frames)
        n_prefix = (0 if prefix is None or self.cfg.family == "encdec"
                    else prefix.shape[1])
        if bounded_by_max_seq(self.cfg) and \
                n_prefix + max_prompt + max(max_new, 1) - 1 > self.max_seq:
            raise ValueError(
                f"{n_prefix} prefix + {max_prompt} prompt + {max_new} new "
                f"tokens do not fit max_seq={self.max_seq}")
        tokens = np.zeros((b, max_prompt), np.int64)
        for i, r in enumerate(requests):  # right-padded
            tokens[i, :len(r.prompt)] = (np.asarray(r.prompt, np.int64)
                                         % self.cfg.vocab_size)
        tokens = torch.from_numpy(tokens).to(self.device)

        self._sync()
        t0 = time.perf_counter()
        logits, cache = prefill(self.params, self.cfg, tokens, prefix,
                                max_seq=self.max_seq)
        next_tok = logits[:, -1:].argmax(dim=-1)
        self._sync()
        t1 = time.perf_counter()

        out = [next_tok]
        for _ in range(max_new - 1):
            logits, cache = decode_step(self.params, self.cfg, next_tok,
                                        cache)
            next_tok = logits.argmax(dim=-1)
            out.append(next_tok)
        gen = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        t2 = time.perf_counter()
        return [Result(uid=r.uid, tokens=gen[i], prefill_s=t1 - t0,
                       decode_s=t2 - t1, backend=self.name, batch_size=b)
                for i, r in enumerate(requests)]

    def profile_row(self) -> Dict[str, object]:
        return {"kind": "llm", "model": self.name,
                "num_layers": self.cfg.num_layers, "d_model": self.cfg.d_model,
                "max_batch": self.max_batch, "max_seq": self.max_seq}


class DispatchQueue:
    """Per-backend request queue with batched, latency-bounded flush.

    Requests accumulate until ``backend.max_batch`` is reached, then go out
    batched.  Each flush makes one ``serve_batch`` call per distinct
    payload LENGTH (``len`` of the payload: the prompt length for the LLM
    face, the frame height for the detection face), so every call
    receives payloads it can stack.

    ``max_wait_ms`` bounds how long the OLDEST pending request waits for
    the batch to fill: once the deadline passes, the next ``submit`` or
    ``poll`` serves the partial batch, and ``next_deadline`` tells a
    flusher thread when to wake.  ``clock`` is injectable for
    deterministic tests (default ``time.monotonic``, seconds)."""

    def __init__(self, backend, *, max_wait_ms: Optional[float] = None,
                 clock=time.monotonic):
        self.backend = backend
        self.max_wait_ms = max_wait_ms
        self._clock = clock
        self._oldest: Optional[float] = None
        self.pending: List[Request] = []
        self.calls = 0
        self.served = 0
        #: partial batches served because the deadline expired — via
        #: submit, poll, or the service's flusher (which bumps it itself)
        self.deadline_flushes = 0

    def _deadline_passed(self) -> bool:
        return (self.max_wait_ms is not None and self._oldest is not None
                and (self._clock() - self._oldest) * 1e3 >= self.max_wait_ms)

    def next_deadline(self) -> Optional[float]:
        """Clock time (seconds) when the oldest pending request's wait
        bound expires; None without a deadline or with nothing pending."""
        if self.max_wait_ms is None or self._oldest is None or not self.pending:
            return None
        return self._oldest + self.max_wait_ms / 1e3

    def submit(self, req: Request) -> List[Result]:
        """Enqueue; returns flushed results when the batch fills (or the
        oldest pending request's deadline has passed), else []."""
        if not self.pending:
            self._oldest = self._clock()
        self.pending.append(req)
        if len(self.pending) >= self.backend.max_batch:
            return self.flush()
        if self._deadline_passed():
            self.deadline_flushes += 1
            return self.flush()
        return []

    def poll(self) -> List[Result]:
        """Serve the pending partial batch if it has waited past
        ``max_wait_ms``; [] otherwise."""
        if self.pending and self._deadline_passed():
            self.deadline_flushes += 1
            return self.flush()
        return []

    def flush(self) -> List[Result]:
        if not self.pending:
            return []
        batch, self.pending = self.pending, []
        self._oldest = None
        by_len: Dict[int, List[Request]] = {}
        for r in batch:
            by_len.setdefault(len(r.prompt), []).append(r)
        results: List[Result] = []
        for _, group in sorted(by_len.items()):
            self.calls += 1
            self.served += len(group)
            results += self.backend.serve_batch(group)
        return results
