"""Host -> device prefetching (``graphical_gan_tpu/data/prefetch.py``).

For the host-fed input path (``--data-pipeline host``): a background
thread runs the batch iterator, and for each numpy batch (an array, or a
tuple / dict of arrays) copies it to the device, ``size`` batches ahead of
the consumer. On a CUDA device the copy goes from pinned host memory with
``non_blocking=True`` on a side stream, which records an event; the
consumer's stream waits on that event before the batch is handed out, so
the copy overlaps the consumer's work. On the CPU it is a plain
``.to("cpu")``. An exception in the iterator reaches the consumer, and
closing the generator releases the worker and drops the queued batches.

``side_stream_batches`` counts the batches copied on a side stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Union

import numpy as np
import torch

_SENTINEL = object()

#: batches copied on a CUDA side stream, for checks that the host path went
#: through it (reset by assigning 0)
side_stream_batches = 0


def _map(fn, item):
    if isinstance(item, dict):
        return {k: fn(v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(fn(v) for v in item)
    return fn(item)


def prefetch_to_device(iterator: Iterator, size: int = 2,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Iterator:
    """Wrap a host batch iterator: batches are copied to ``device`` on a
    background thread, ``size`` deep."""
    global side_stream_batches
    dev = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def put(item):
        """(the batch on the device, the copy's event or None)."""
        def host(x):
            return torch.from_numpy(np.ascontiguousarray(x))

        if side is None:
            return _map(lambda x: host(x).to(dev), item), None
        with torch.cuda.stream(side):
            out = _map(lambda x: host(x).pin_memory().to(
                dev, non_blocking=True), item)
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def offer(x) -> bool:
        """A bounded put that gives up once the consumer is gone, so an
        abandoned iterator pins no device memory and no thread."""
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                # a put can land while the closing consumer drains the
                # queue: stop before pulling another item all the same
                if not offer(put(item)) or stop.is_set():
                    return
        except Exception as e:  # raised again on the consuming side
            offer(e)
        finally:
            # the sentinel must arrive or the consumer waits forever at the
            # end of the stream
            offer(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, Exception):
                raise item
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                # memory the side stream allocated is in use on this one
                _map(lambda x: x.record_stream(stream), batch)
                side_stream_batches += 1
            yield batch
    finally:
        # the consumer closed or abandoned the generator: release the worker
        # and drop the queued batches
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)
