"""Host-side background prefetch: a thread pool builds samples ahead of the
device step so host IO overlaps the card's compute (the reference trains
with 8 dataloader workers).  Threads, not processes: the work is decode and
numpy, which release the GIL, and device tensors stay in one process.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def prefetch_iter(
    fetch: Callable[[T], R],
    items: Iterable[T],
    num_workers: int = 4,
    depth: int = 8,
) -> Iterator[R]:
    """Yield fetch(item) for each item, in order, computed ahead by a
    background thread pool.  depth bounds in-flight work (and therefore
    host memory holding decoded frames).  num_workers <= 0 degrades to a
    synchronous map (deterministic debugging path)."""
    if num_workers <= 0:
        for item in items:
            yield fetch(item)
        return
    depth = max(depth, num_workers)
    it = iter(items)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: collections.deque = collections.deque()
        exhausted = False
        while not exhausted and len(pending) < depth:
            try:
                pending.append(pool.submit(fetch, next(it)))
            except StopIteration:
                exhausted = True
        while pending:
            fut = pending.popleft()
            # refill before blocking on the result to keep the pipe full
            if not exhausted:
                try:
                    pending.append(pool.submit(fetch, next(it)))
                except StopIteration:
                    exhausted = True
            yield fut.result()
