"""Cross-request micro-batching for the search hot path.

Copy of sskd_tpu/serve/batcher.py.

The TPU engine's throughput is batch-mode (a corpus sweep amortizes over the
query batch — SURVEY.md 7.3: "the 100k qps/chip and sub-ms p50 targets
jointly imply batch-mode execution"), but HTTP requests arrive one query at
a time. The MicroBatcher coalesces concurrent requests: the first arrival
opens a window (``service.micro_batch_window_ms``); everything that arrives
before it closes (up to ``micro_batch_max_size``) executes as ONE device
call. Under no concurrency a request pays at most the window; under load,
batches fill instantly and per-query cost approaches the amortized sweep.

The batch function runs in a worker thread so the device call never blocks
the event loop.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Sequence

from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.batcher")


class MicroBatcher:
    def __init__(
        self,
        batch_fn: Callable[[list[Any]], Sequence[Any]],
        window_ms: float = 2.0,
        max_size: int = 64,
    ):
        self.batch_fn = batch_fn
        self.window_s = max(0.0, window_ms) / 1000.0
        self.max_size = max(1, max_size)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None

    def _ensure_worker(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._worker())

    async def submit(self, item: Any) -> Any:
        """Enqueue one item; resolves to its positional result from
        ``batch_fn``."""
        self._ensure_worker()
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((item, future))
        return await future

    async def _collect(self) -> list[tuple[Any, asyncio.Future]]:
        first = await self._queue.get()
        batch = [first]
        if self.window_s > 0:
            loop = asyncio.get_running_loop()
            deadline = loop.time() + self.window_s
            while len(batch) < self.max_size:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self._queue.get(), timeout)
                    )
                except asyncio.TimeoutError:
                    break
        else:
            while len(batch) < self.max_size and not self._queue.empty():
                batch.append(self._queue.get_nowait())
        return batch

    async def _worker(self) -> None:
        while True:
            batch = await self._collect()
            items = [item for item, _ in batch]
            futures = [future for _, future in batch]
            try:
                results = await asyncio.to_thread(self.batch_fn, items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(items)} items"
                    )
                for future, result in zip(futures, results):
                    if not future.done():
                        future.set_result(result)
            except Exception as exc:  # noqa: BLE001 — propagate per-request
                for future in futures:
                    if not future.done():
                        future.set_exception(exc)

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
