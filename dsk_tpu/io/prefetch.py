"""Background batch prefetching: overlap host parse/encode with device work.

The reference overlaps disk writes with parsing via its thread Dispatcher
(SURVEY.md P5).  Here a reader thread runs the batch iterator (the native
C++ parser releases the GIL during its scan) and fills a bounded queue;
the device loop pops ready batches.  Double buffering ⇒ host IO time is
hidden whenever parse throughput exceeds device throughput.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

_DONE = object()


def parallel_map(
    fn: Callable, items: Iterable, workers: int, inflight: int | None = None
) -> Iterator:
    """Ordered map of `fn` over `items` on a thread pool, with a bounded
    number of calls in flight.

    Built for parallel host->device transfers: the put stage of the
    count pipeline fans each flush group's device_put over `workers`
    threads while results are still consumed in order (whether parallel
    puts help over PCIe is ROADMAP S3f).
    """
    if workers <= 1:
        for item in items:
            yield fn(item)
        return
    bound = inflight or workers + 1
    with ThreadPoolExecutor(workers) as ex:
        futs: deque = deque()
        for item in items:
            futs.append(ex.submit(fn, item))
            if len(futs) >= bound:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()


def prefetch(batches: Iterable, depth: int = 3) -> Iterator:
    """Iterate `batches` on a background thread with a bounded queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker():
        try:
            for b in batches:
                q.put(b)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _DONE:
            break
        yield item
    t.join()
    if err:
        raise err[0]
