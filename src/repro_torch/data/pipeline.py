"""Streaming data plane: double-buffered async host->device prefetch
(DESIGN.md §11), for one card.

The population train loop is device-bound arithmetic wrapped in host-bound
glue: every chunk waits while the driver builds its ``(scan_steps, B,
...)`` batch slab and copies it to the card, and every per-chunk metric
fetch (per-member losses, grad norms) drains the device queue before the
next chunk can launch.  This module takes both off the critical path:

  * :class:`Prefetcher` — a background producer thread that builds the
    NEXT chunk's slab into one of two alternating host staging buffers
    and hands its device copy over while the current chunk executes.  A
    bounded queue (default depth 2 — double buffering) gives
    backpressure; ``seek`` re-synchronises after a crash replay;
    ``retarget`` flushes and re-aims the producer at a rung boundary
    (keeping the staging buffers when their signature matches);
    ``close`` shuts the thread down even when it is blocked mid-``put``.
    Producer exceptions are re-raised on the consumer thread (``get``) as
    :class:`PrefetchError` — a dead producer can never hang the train
    loop.  The JAX package's class, line for line
    (``repro/data/pipeline.py``).

  * :class:`DeferredMetrics` — a chunk's metrics as a lazy mapping: the
    host transfer is awaited on FIRST ACCESS, so the driver resolves chunk
    N's metrics after chunk N+1 is already launched.

  * :class:`SlabStager` — the torch counterpart of ``jax.device_put`` and
    the §11 aliasing rule.  On the card the staging buffers are pinned host
    memory, the copy of a staged slab runs ``non_blocking`` on a side
    stream of its own, and a CUDA event marks its end (:class:`DeviceSlab`);
    before a staging buffer is written again, the producer waits on the
    event of the copy that last read it, and the consumer's stream waits
    on the slab's event (and records its use of the slab's memory) before
    the chunk's first launch.  On the CPU ``.to("cpu")`` would hand over
    the staging buffer itself, which the producer writes again two chunks
    later, so the slab is a snapshot (``clone``).  Nothing falls back:
    a failed pin or copy raises, on the producer thread as a
    :class:`PrefetchError` at ``get``.

Bit-exactness contract: the prefetcher changes WHEN a batch is built and
copied, never WHAT is built — ``produce(chunk_idx, staging)`` is required
to be a pure function of the chunk index (the repo's step-indexed data
rule), so a pipelined run's trajectory is bit-identical to the synchronous
driver's (tests/test_torch_pipeline.py)."""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Mapping, Optional

import numpy as np
import torch


class PrefetchError(RuntimeError):
    """Producer-thread failure, re-raised on the consumer thread with the
    original exception chained (``raise ... from err``)."""


def staging_signature(staging):
    """Shape/dtype signature of a staging buffer — nested tuples mirroring
    the buffer's structure with each array (numpy, or a torch tensor)
    replaced by ``(shape, dtype.str)``, a torch tensor by the ``dtype.str``
    of the numpy dtype of its element type, so that a signature built by
    hand from shapes compares equal.  This is the equality key
    :meth:`Prefetcher.retarget` uses to decide whether the existing
    staging buffers can be REUSED across a rung boundary."""
    if staging is None:
        return None
    if isinstance(staging, (tuple, list)):
        return tuple(staging_signature(s) for s in staging)
    if isinstance(staging, torch.Tensor):
        return (tuple(staging.shape), _numpy_dtype(staging.dtype).str)
    if not (hasattr(staging, "shape") and hasattr(staging, "dtype")):
        # non-array leaf (e.g. a test double): opaque by type — never
        # claims shape equality, so retarget falls back to a rebuild
        return ("opaque", type(staging).__name__)
    return (tuple(staging.shape), np.dtype(staging.dtype).str)


class DeferredMetrics(Mapping):
    """A metrics dict whose values are fetched on first access.

    ``resolve()`` is called once, lazily; its result (a plain dict) is
    cached.  Everything mapping-like (``metrics["loss"]``, ``dict(m)``,
    iteration, ``len``) forces resolution — so code that stores the object
    (``TrainRunner.metrics_log``) costs nothing, and code that reads it
    pays one host sync at read time, ideally after the NEXT chunk is in
    flight."""

    __slots__ = ("_resolve", "_value")

    def __init__(self, resolve: Callable[[], dict]):
        self._resolve = resolve
        self._value: Optional[dict] = None

    @property
    def resolved(self) -> bool:
        return self._value is not None

    def force(self) -> dict:
        if self._value is None:
            self._value = dict(self._resolve())
        return self._value

    def __getitem__(self, key):
        return self.force()[key]

    def __iter__(self) -> Iterator:
        return iter(self.force())

    def __len__(self) -> int:
        return len(self.force())

    def __repr__(self) -> str:
        if self._value is None:
            return "DeferredMetrics(<unresolved>)"
        return f"DeferredMetrics({self._value!r})"


class Prefetcher:
    """Bounded async producer of per-chunk device slabs.

    Parameters
    ----------
    produce : ``(chunk_idx, staging) -> slab``
        Runs ON THE PRODUCER THREAD.  Builds chunk ``chunk_idx``'s batches
        into ``staging`` (one of two alternating host buffers from
        ``make_staging``, or ``None``) and returns the device slab —
        typically :meth:`SlabStager.stage`'s.  Must be a pure function of
        ``chunk_idx`` (step-indexed data) so replays and the synchronous
        path agree bit-for-bit.
    n_chunks : total chunks in the current target (exclusive end).
    make_staging : optional zero-arg factory for ONE host staging buffer;
        called twice so consecutive chunks alternate buffers — chunk k+1
        stages while chunk k's slab is still in flight.  ALIASING RULE:
        ``produce`` must never hand a staging buffer itself to the
        consumer — the device copy (or, on the CPU, a snapshot) is what
        the consumer owns, and nothing ever writes it again (DESIGN.md
        §11).
    depth : queue bound (default 2 = double buffering): the producer runs
        at most ``depth`` chunks ahead, then blocks (backpressure) until
        the consumer drains one.
    """

    _END = object()

    def __init__(self, produce: Callable[[int, Any], Any], n_chunks: int,
                 *, make_staging: Optional[Callable[[], Any]] = None,
                 depth: int = 2, start: int = 0, name: str = "prefetch"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._depth = depth
        self._name = name
        self._produce = produce
        self._make_staging = make_staging
        self._staging = ([make_staging(), make_staging()]
                         if make_staging else [None, None])
        self._signature = staging_signature(self._staging[0])
        self._n_chunks = int(n_chunks)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._next = int(start)          # next chunk the consumer expects
        self._start_thread(int(start))

    # ----------------------------------------------------------------- #
    # producer                                                          #
    # ----------------------------------------------------------------- #

    def _start_thread(self, start: int):
        self._stop.clear()
        self._error = None
        self._q = queue.Queue(maxsize=self._depth)
        self._thread = threading.Thread(
            target=self._run, args=(start,), daemon=True, name=self._name)
        self._thread.start()

    def _run(self, start: int):
        flip = 0
        try:
            for c in range(start, self._n_chunks):
                if self._stop.is_set():
                    return
                slab = self._produce(c, self._staging[flip])
                flip ^= 1
                if not self._put((c, slab)):
                    return
            self._put(self._END)
        except BaseException as e:       # noqa: BLE001 — surface on get()
            self._error = e
            self._put(self._END)

    def _put(self, item) -> bool:
        """Bounded put with condition-variable backpressure: a blocked
        producer parks on the queue's internal ``not_full`` condition and
        wakes IMMEDIATELY when the consumer ``get``s a slab (no polling
        interval).  ``close``/``retarget`` unblock a full-queue put the
        same way: ``_halt`` sets the stop flag and then drains the queue,
        each drained item notifying ``not_full``; the post-wake stop check
        discards the stale hand-off (the queue object is rebuilt on
        restart, so a raced-in item can never leak into the next target's
        stream)."""
        if self._stop.is_set():
            return False
        self._q.put(item)
        return not self._stop.is_set()

    # ----------------------------------------------------------------- #
    # consumer                                                          #
    # ----------------------------------------------------------------- #

    def get(self, chunk_idx: int, timeout: float = 600.0):
        """The device slab for ``chunk_idx``.  Consecutive calls must walk
        the chunk range in order; an out-of-order index (a crash replay
        restarting mid-segment, or a resume skipping ahead) triggers an
        implicit :meth:`seek` — queued slabs for the abandoned position are
        discarded and the producer restarts at ``chunk_idx``."""
        if chunk_idx != self._next:
            self.seek(chunk_idx)
        deadline = timeout
        while True:
            try:
                item = self._q.get(timeout=min(deadline, 0.5))
            except queue.Empty:
                deadline -= 0.5
                if self._error is not None:
                    self._raise()
                if not self._thread.is_alive():
                    raise PrefetchError(
                        f"{self._name}: producer thread died without "
                        f"delivering chunk {chunk_idx}")
                if deadline <= 0:
                    raise TimeoutError(
                        f"{self._name}: chunk {chunk_idx} not produced "
                        f"within {timeout}s")
                continue
            if item is self._END:
                if self._error is not None:
                    self._raise()
                raise PrefetchError(
                    f"{self._name}: chunk {chunk_idx} requested past the "
                    f"end of the target ({self._n_chunks} chunks)")
            c, slab = item
            if c != chunk_idx:           # stale slab from before a seek
                continue
            self._next = chunk_idx + 1
            return slab

    def _raise(self):
        err = self._error
        raise PrefetchError(
            f"{self._name}: producer thread failed while building a "
            f"batch slab: {err!r}") from err

    def seek(self, chunk_idx: int):
        """Flush and restart the producer at ``chunk_idx`` (crash-replay
        re-synchronisation: ``TrainRunner`` restores a checkpoint and the
        loop re-enters at an earlier chunk)."""
        self._halt()
        self._next = int(chunk_idx)
        self._start_thread(int(chunk_idx))

    def retarget(self, produce: Callable[[int, Any], Any], n_chunks: int,
                 *, make_staging: Optional[Callable[[], Any]] = None,
                 signature=None, start: int = 0):
        """Flush the pipeline and aim it at a NEW chunk source — the rung-
        boundary protocol: in-flight slabs for the old segment are always
        dropped and the producer restarts against the next segment's
        ``produce`` (chunk indices re-base on the new segment, so a stale
        slab can never be served), but the STAGING buffers are reused when
        ``signature`` (:func:`staging_signature` of the next segment's
        buffers, buildable from shapes alone) matches the current one —
        the constant-population refill keeps every slab shape identical
        across the rung, so no host buffer is discarded or reallocated
        there.  A changed signature takes the full rebuild path; omitting
        ``signature`` while passing ``make_staging`` also forces the
        rebuild."""
        self._halt()
        self._produce = produce
        self._n_chunks = int(n_chunks)
        if make_staging is not None:
            self._make_staging = make_staging
            if signature is None or signature != self._signature:
                self._staging = [make_staging(), make_staging()]
                self._signature = staging_signature(self._staging[0])
        self._next = int(start)
        self._start_thread(int(start))

    def _halt(self):
        """Stop the producer thread and drain the queue (dropping slabs)."""
        self._stop.set()
        while True:                      # unblock a producer stuck in put()
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():  # pragma: no cover — defensive
                raise RuntimeError(
                    f"{self._name}: producer thread failed to stop")
        self._thread = None

    def close(self):
        """Shut the producer down; idempotent, never hangs (``_halt``'s
        queue drain wakes a producer blocked in ``put`` via the queue's
        ``not_full`` condition, and the producer re-checks the stop flag
        after every wake)."""
        if self._thread is not None:
            self._halt()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# --------------------------------------------------------------------- #
# torch: pinned staging, side-stream copies                             #
# --------------------------------------------------------------------- #

class DeviceSlab:
    """A staged slab's device tensors and the CUDA event that ends their
    copy (None on the CPU, where the tensors are a snapshot).  ``take()``
    makes the caller's current stream wait on that event and records the
    stream's use of each tensor (the caching allocator must not hand the
    memory to the side stream's next copy while the chunk still reads it),
    then returns the tensors."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: tuple, event=None):
        self.tensors = tuple(tensors)
        self.event = event

    def take(self) -> tuple:
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
        return self.tensors


class SlabStager:
    """Host staging and host→device copies of batch slabs for one device.

    ``staging(specs)`` allocates one staging buffer, a tuple of host
    tensors of the ``(shape, dtype)`` specs: pinned on the card
    (``pin_memory=True``; a failure raises), pageable on the CPU.
    ``stage(staging, rows, fill)`` waits until the last copy out of
    ``staging`` has finished, has ``fill`` write the first ``rows`` rows of
    each tensor through numpy views, and returns the :class:`DeviceSlab` of
    those rows: on the card a ``non_blocking`` copy on the stager's side
    stream (the device set explicitly, whatever thread calls), its end
    marked by an event; on the CPU a ``clone``.  Callable from the
    producer thread and the training thread alike; ``made`` counts the
    staging buffers allocated and ``pinned`` holds each one's
    ``is_pinned()``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.on_card else None)
        self._last_copy = {}             # staging's first data_ptr → event
        self._lock = threading.Lock()
        self.made = 0
        self.pinned: list[bool] = []

    def staging(self, specs) -> tuple:
        bufs = tuple(torch.empty(tuple(shape), dtype=_torch_dtype(dtype),
                                 pin_memory=self.on_card)
                     for shape, dtype in specs)
        if self.on_card and not all(t.is_pinned() for t in bufs):
            raise RuntimeError("staging buffers were not pinned")
        with self._lock:
            self.made += 1
            self.pinned.extend(t.is_pinned() for t in bufs)
        return bufs

    def stage(self, staging: tuple, rows: int, fill) -> DeviceSlab:
        key = staging[0].data_ptr()
        with self._lock:
            last = self._last_copy.get(key)
        if last is not None:
            last.synchronize()           # its copy has read the buffer
        views = tuple(t[:rows] for t in staging)
        fill(*(v.numpy() for v in views))
        if not self.on_card:
            return DeviceSlab(tuple(v.clone() for v in views))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = tuple(v.to(self.device, non_blocking=True) for v in views)
            event = torch.cuda.Event()
            event.record(self.stream)
        with self._lock:
            self._last_copy[key] = event
        return DeviceSlab(out, event)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
