"""Asyncio streaming front-end over the SLO scheduler.

Port of ``repro/serve/frontend.py``. The driver steps the engine in a
worker thread; the scheduler makes its own device and stream current
there (``DecodeScheduler._on_device``), so a segment captured on
another thread replays on the stream it was captured beside.

The last layer of the serving stack: per-request **token streams**.
A client calls :meth:`StreamingFrontend.stream` and receives an async
generator yielding events as the engine produces them — the SSE shape
(``format_sse`` renders each event as a ``text/event-stream`` frame,
so an HTTP handler can ``yield`` them verbatim).

Concurrency model — one driver, many consumers:

- The **driver task** owns the device. It repeatedly runs
  ``SLOScheduler.step()`` in a worker thread
  (``asyncio.to_thread`` — a device segment blocks, and blocking the
  event loop would freeze every consumer) and fans the returned
  events out to per-request ``asyncio.Queue``\\ s. It starts lazily
  with the first request and parks when nothing is in flight.
- **Consumers** (the ``stream`` generators) never touch the engine:
  they await their queue. ``SLOScheduler`` serializes ``submit`` vs
  ``step`` on its own lock, so submitting from the event loop while a
  segment runs in the worker thread is safe.
- **Backpressure** is an admission semaphore: at most
  ``max_inflight`` requests are open; ``stream`` waits for a slot
  BEFORE submitting, so an overloaded server queues clients at the
  front door instead of growing the backlog without bound
  (``queue_depth`` exposes the wait).

Preemption is visible but harmless to a consumer: a ``preempted``
event announces the pause; the replayed stream is bit-identical
(scheduler key derivation + emission-index PRNG keying), and the SLO
layer only forwards tokens PAST the already-delivered cursor — a
client never sees a duplicate or a gap.
"""

from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, Dict, Optional

from . import slo as slo_lib


def format_sse(event: dict) -> str:
    """Render one event dict as a Server-Sent-Events frame:
    ``event: <kind>`` + ``data: <json>`` + blank line."""
    kind = event.get("event", "message")
    payload = {k: v for k, v in event.items() if k != "event"}
    return f"event: {kind}\ndata: {json.dumps(payload)}\n\n"


class StreamingFrontend:
    """Fan-out driver: one engine thread, N async token streams.

    Args:
      slo: the scheduling layer (wraps a running-ready
        ``DecodeScheduler``).
      max_inflight: admission-semaphore width — open requests beyond
        this wait at the front door (backpressure), keeping the
        backlog the scheduler sorts each round bounded.
      idle_sleep: seconds the driver parks between polls once nothing
        is in flight (it wakes immediately on a new request).
    """

    def __init__(self, slo: slo_lib.SLOScheduler, *,
                 max_inflight: int = 64, idle_sleep: float = 0.01):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.slo = slo
        self.max_inflight = int(max_inflight)
        self.idle_sleep = float(idle_sleep)
        self._sem = asyncio.BoundedSemaphore(self.max_inflight)
        self._queues: Dict[int, asyncio.Queue] = {}
        self._driver: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._waiting = 0        # streams parked on the semaphore

    @property
    def inflight(self) -> int:
        """Requests admitted and not yet finished."""
        return len(self._queues)

    @property
    def queue_depth(self) -> int:
        """Streams waiting at the front door for a semaphore slot."""
        return self._waiting

    # ---------------- driver ------------------------------------------

    def _ensure_driver(self) -> None:
        if self._driver is None or self._driver.done():
            self._driver = asyncio.get_running_loop().create_task(
                self._drive())

    async def _drive(self) -> None:
        """Own the engine until nothing is in flight. Each iteration
        is one SLO round in a worker thread; the events fan out to the
        consumers' queues on the loop."""
        while True:
            if not self._queues:
                if not self._waiting:
                    return            # park: next stream() restarts us
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           self.idle_sleep)
                except asyncio.TimeoutError:
                    pass
                continue
            try:
                events = await asyncio.to_thread(self.slo.step)
            except Exception as exc:   # engine fault: fail every
                for q in self._queues.values():     # stream loudly,
                    q.put_nowait({"event": "error",  # don't hang them
                                  "message": repr(exc)})
                raise
            for e in events:
                q = self._queues.get(e.request_id)
                if q is None:
                    continue
                if e.kind == "token":
                    q.put_nowait({"event": "token",
                                  "request_id": e.request_id,
                                  "tokens": e.tokens})
                elif e.kind == "preempted":
                    q.put_nowait({"event": "preempted",
                                  "request_id": e.request_id})
                elif e.kind == "finished":
                    if e.tokens:
                        q.put_nowait({"event": "token",
                                      "request_id": e.request_id,
                                      "tokens": e.tokens})
                    f = e.finished
                    q.put_nowait({"event": "done",
                                  "request_id": e.request_id,
                                  "length": f.length,
                                  "hit_eos": bool(f.hit_eos)})

    # ---------------- client API --------------------------------------

    async def stream(self, prompt, *, max_new: int, slo_class="batch",
                     request_id=None, key=None,
                     prefix_embeds=None,
                     frames=None) -> AsyncIterator[dict]:
        """Submit one request and yield its event stream.

        Yields ``{"event": "token", "tokens": [...]}`` dicts as the
        engine emits (bursts under speculation), ``"preempted"``
        notices, and a final ``{"event": "done", ...}``; the generator
        then ends. Pass each dict through :func:`format_sse` for an
        HTTP ``text/event-stream`` response. ``prefix_embeds``: a VLM
        request's patch embeddings; ``frames``: an audio request's frame
        embeddings (``DecodeScheduler.submit``).
        """
        self._waiting += 1
        self._wake.set()
        try:
            await self._sem.acquire()
        finally:
            self._waiting -= 1
        try:
            rid = self.slo.submit(
                prompt, max_new=max_new, slo_class=slo_class,
                request_id=request_id, key=key,
                prefix_embeds=prefix_embeds, frames=frames)
            q: asyncio.Queue = asyncio.Queue()
            self._queues[rid] = q
            self._ensure_driver()
            while True:
                ev = await q.get()
                if ev["event"] == "error":
                    raise RuntimeError(ev["message"])
                yield ev
                if ev["event"] == "done":
                    return
        finally:
            if "rid" in locals():
                self._queues.pop(rid, None)
            self._sem.release()
