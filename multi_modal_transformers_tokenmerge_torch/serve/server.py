"""Micro-batching policy server.

Counterpart of the JAX package's ``serve/server.py``.  Many robot sessions
share one card: the server coalesces concurrent single-observation
requests into the engine's fixed batch (waiting at most ``max_wait_ms``
after the first, and padding the tail with the last request), runs the
engine, compiled or not, and hands each caller its row.  Host side only.

The batches run on the server's own thread.  A compiled engine's CUDA
graphs are captured on the thread that called ``compile`` and replayed
from this one, on its current stream; nothing is captured here.  A
never-seen instruction runs the text tower eagerly inside the batch.  Each
batch's actions come back to the host with one copy, then one row goes to
each waiter (bfloat16 rows as float32, which holds them exactly: numpy has
no bfloat16).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from .policy import PolicyEngine

__all__ = ["PolicyServer"]


class PolicyServer:
    """Thread-based request batcher around a PolicyEngine.

    The engine must be built (and optionally compiled) for ``batch_size``;
    requests are single observations; the server pads partial batches.
    """

    def __init__(self, engine: PolicyEngine, max_wait_ms: float = 2.0):
        self.engine = engine
        self.batch_size = engine.batch_size
        self.max_wait = max_wait_ms / 1e3
        self._requests: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "PolicyServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # fail pending waiters at once instead of letting each block for
        # its full predict() timeout
        shutdown = RuntimeError("policy server stopped")
        while True:
            try:
                _, _, slot, done = self._requests.get_nowait()
            except queue.Empty:
                break
            slot["error"] = shutdown
            done.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------

    def predict(self, images, instruction=None, timeout: float = 30.0):
        """Blocking single-observation obs -> action.  ``images`` has NO
        batch dim; returns this observation's row of the engine's output
        as a numpy array.

        ``instruction`` (a string or pre-tokenized (T,) ids) selects this
        request's instruction: requests with different instructions batch
        together (per-row cached text embeddings,
        ``PolicyEngine.encode_instruction``).  Without it the engine's
        ``set_instruction`` default applies."""
        if self._thread is None or self._stop.is_set():
            raise RuntimeError(
                "policy server is not running (call start() / use the "
                "context manager before predict())")
        if instruction is None and self.engine._text_embeddings is None:
            # rejected here, not in the batch thread: a bad request raised
            # inside _run would fail every request coalesced with it
            raise ValueError(
                "request without instruction but the engine has no "
                "set_instruction default — pass instruction= or call "
                "engine.set_instruction() first")
        done = threading.Event()
        slot = {}
        self._requests.put((images, instruction, slot, done))
        if self._stop.is_set() and not done.is_set():
            # stop() may have drained the queue between the running check
            # and the put; fail now instead of waiting the whole timeout
            slot["error"] = RuntimeError("policy server stopped")
            done.set()
        if not done.wait(timeout):
            raise TimeoutError("policy server did not respond")
        if "error" in slot:
            raise slot["error"]
        return slot["action"]

    # -- batching loop -----------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._requests.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            t0 = time.perf_counter()
            while len(batch) < self.batch_size:
                remaining = self.max_wait - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    batch.append(self._requests.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run(batch)

    def _pad(self, rows, n):
        """(n, ...) -> (batch_size, ...), the tail repeating the last row."""
        if n == self.batch_size:
            return rows
        pad = rows[-1:].expand(self.batch_size - n, *rows.shape[1:])
        return torch.cat([rows, pad])

    def _run(self, batch):
        try:
            n = len(batch)
            images = self._pad(torch.stack(
                [torch.as_tensor(np.asarray(b[0])) for b in batch]), n)
            if any(b[1] is not None for b in batch):
                # mixed-instruction batch: one cached (T, E) row per
                # request (encode_instruction memoizes; a never-seen
                # instruction costs one text-tower call here)
                default = self.engine._text_embeddings
                rows = []
                for _, instr, _, _ in batch:
                    if instr is not None:
                        rows.append(self.engine.encode_instruction(instr))
                    elif default is not None:
                        rows.append(default[0])
                    else:
                        raise ValueError(
                            "request without instruction but the engine "
                            "has no set_instruction default")
                emb = self._pad(torch.stack(rows), n)
                out = self.engine(images, text_embeddings=emb)
            else:
                out = self.engine(images)
            actions = out.cpu()              # one copy for the whole batch
            if actions.dtype == torch.bfloat16:
                actions = actions.float()    # exact; numpy has no bfloat16
            actions = actions.numpy()
            for i, (_, _, slot, done) in enumerate(batch):
                slot["action"] = actions[i]
                done.set()
        except Exception as e:  # propagate to all waiters
            for _, _, slot, done in batch:
                slot["error"] = e
                done.set()
