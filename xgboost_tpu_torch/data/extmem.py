"""External-memory data (port of xgboost_tpu/data/extmem.py): DataIter,
ExtMemQuantileDMatrix, SparsePageDMatrix, and the scheduler that streams
their pages to the device.

Reference: python-package/xgboost/core.py:265 (the DataIter protocol),
src/data/extmem_quantile_dmatrix.{h,cc} (binned pages kept on the host,
streamed to the device at every histogram pass).

Ingestion takes two passes over the user's batches: pass 1 folds each batch
into ``StreamingSketch`` (data/quantile.py), pass 2 bins each batch on the
matrix's device against the merged cuts into a page of whole 1024-row
blocks (``PAGE_ALIGN``) and parks it on the host: a pinned tensor when the
device is a GPU, zstd-compressed (``CompressedPage``) where zstandard is
installed and ``compress`` is asked for, or spilled to disk
(``on_host=False``: ``CompressedPage`` or ``DiskPage``).  Every decode of a
compressed or spilled page checks a CRC-32, reads the page again once, then
raises ``PageCorruptError``.

``PageScheduler`` streams a list of pages to the device in order.  On a
GPU, each page is copied from pinned memory on a copy stream of its own
into one of ``lookahead + 1`` device slots (``DevicePageRing``); the compute
stream waits on the copy's event, and a slot is refilled only after an
event recorded behind the last kernel that read it.  Compressed and spilled
pages are decoded on a pool of two threads into pinned staging buffers
first.  On the CPU the pages are host tensors already and are used in
place.  ``lookahead=0`` puts copy and compute in series.
"""
from __future__ import annotations

import tempfile
import threading
import time
import weakref
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .dmatrix import DMatrix
from .ellpack import build_ellpack
from .quantile import HistogramCuts, StreamingSketch

PAGE_ALIGN = 1024  # rows; every page is a whole number of 1024-row blocks


class PageCorruptError(RuntimeError):
    """A page failed its CRC check after a decode and again after one
    re-read from its backing store: training never sees corrupted bins."""


def _page_crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr))


def _verify_decoded(out, crc: int, *, what: str, attempt: int):
    """The CRC gate of one decode attempt: ``out`` (bytes or an array)
    when its CRC matches, None after a first mismatch (the caller reads
    the page again), else raise."""
    buf = out if isinstance(out, (bytes, bytearray)) \
        else np.ascontiguousarray(out)
    if zlib.crc32(buf) == crc:
        return out
    if attempt == 0:
        return None
    raise PageCorruptError(
        f"{what}: page CRC mismatch after decode and after one re-read "
        "from the backing store; refusing to train on corrupted bins")


# ---------------------------------------------------------------------------
# Counters of the page pipeline (the reference's xtb_extmem_* family, kept
# as plain module counters): decode seconds spent hidden under compute
# (overlap) or blocking the consumer (wait), pages and bytes staged, and
# page touches served from the host page cache or paying a decode.
# ---------------------------------------------------------------------------
class Counter:
    """A float that only grows, by ``inc``."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def get(self) -> float:
        return self.value


_INSTRUMENTS = tuple(Counter(n) for n in (
    "xtb_extmem_decode_seconds_total", "xtb_extmem_wait_seconds_total",
    "xtb_extmem_overlap_seconds_total", "xtb_extmem_pages_loaded_total",
    "xtb_extmem_page_bytes_total", "xtb_extmem_cache_hits_total",
    "xtb_extmem_cache_misses_total"))


def instruments():
    """(decode_s, wait_s, overlap_s, pages, bytes, hits, misses)."""
    return _INSTRUMENTS


def counters() -> Dict[str, float]:
    """The seven counters by name, and the device's page bytes now and
    at their high-water mark."""
    out = {c.name: c.get() for c in _INSTRUMENTS}
    out["device_page_bytes"] = _DEVICE_PAGES["bytes"]
    out["device_page_bytes_hwm"] = _DEVICE_PAGES["hwm"]
    return out


def reset_counters() -> None:
    """Zero the seven counters and restart the high-water mark from the
    page bytes resident now."""
    for c in _INSTRUMENTS:
        c.value = 0.0
    _DEVICE_PAGES["hwm"] = _DEVICE_PAGES["bytes"]


# page bytes held in device slots, now and at most
_DEVICE_PAGES = {"bytes": 0, "hwm": 0}
_DEVICE_LOCK = threading.Lock()


def _device_pages(delta: int) -> None:
    with _DEVICE_LOCK:
        _DEVICE_PAGES["bytes"] += delta
        _DEVICE_PAGES["hwm"] = max(_DEVICE_PAGES["hwm"],
                                   _DEVICE_PAGES["bytes"])


class CompressedPage:
    """A zstd-compressed page, in host memory or spilled to a file
    (reference extmem.py:132).  ``shape``, ``dtype`` and ``__array__``
    are its whole interface; the CRC covers the uncompressed bytes and is
    checked after every decompression."""

    __slots__ = ("shape", "dtype", "_blob", "_path", "nbytes_compressed",
                 "crc", "__weakref__")

    def __init__(self, arr: np.ndarray, path: Optional[str] = None):
        import zstandard as zstd

        raw = np.ascontiguousarray(arr)
        blob = zstd.ZstdCompressor(level=3).compress(raw.tobytes())
        self.shape = raw.shape
        self.dtype = raw.dtype
        self.nbytes_compressed = len(blob)
        self.crc = _page_crc(raw)
        if path is not None:
            with open(path, "wb") as fh:
                fh.write(blob)
            self._blob, self._path = None, path
        else:
            self._blob, self._path = blob, None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def _decompress(self) -> bytes:
        import zstandard as zstd

        blob = self._blob
        if blob is None:
            with open(self._path, "rb") as fh:
                blob = fh.read()
        try:
            return zstd.ZstdDecompressor().decompress(blob)
        except zstd.ZstdError as e:
            raise PageCorruptError(
                f"page blob undecodable ({e}); truncated or bit-flipped "
                "compressed stream") from e

    def __array__(self, dtype=None, copy=None):
        hits, misses = _INSTRUMENTS[5:7]
        cached = _page_cache_get(self)
        if cached is not None:
            hits.inc()
            return cached if dtype is None else cached.astype(dtype)
        misses.inc()
        raw = None
        for attempt in (0, 1):
            try:
                decoded = self._decompress()
            except PageCorruptError:
                if attempt == 0:  # a rejected blob gets the same re-read
                    continue
                raise
            raw = _verify_decoded(decoded, self.crc,
                                  what=f"compressed page {self._path or ''}",
                                  attempt=attempt)
            if raw is not None:
                break
        # a writable array (one copy a decode), so that a CPU tensor can
        # wrap it without one
        out = np.frombuffer(bytearray(raw), dtype=self.dtype).reshape(
            self.shape)
        _page_cache_put(self, out)
        return out if dtype is None else out.astype(dtype)


class DiskPage:
    """An uncompressed page spilled to a ``.npy`` file (reference
    extmem.py:216), read back through the same CRC gate."""

    __slots__ = ("shape", "dtype", "_path", "crc", "__weakref__")

    def __init__(self, arr: np.ndarray, path: str):
        raw = np.ascontiguousarray(arr)
        self.shape = raw.shape
        self.dtype = raw.dtype
        self.crc = _page_crc(raw)
        np.save(path, raw)
        self._path = path

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def __array__(self, dtype=None, copy=None):
        hits, misses = _INSTRUMENTS[5:7]
        cached = _page_cache_get(self)
        if cached is not None:
            hits.inc()
            return cached if dtype is None else cached.astype(dtype)
        misses.inc()
        raw = None
        for attempt in (0, 1):
            try:
                arr = np.load(self._path)
            except (ValueError, OSError) as e:
                if attempt == 0:
                    continue
                raise PageCorruptError(
                    f"disk page {self._path} unreadable ({e}); damaged npy "
                    "header or truncated file") from e
            raw = _verify_decoded(arr, self.crc, what=f"disk page "
                                  f"{self._path}", attempt=attempt)
            if raw is not None:
                break
        _page_cache_put(self, raw)
        return raw if dtype is None else raw.astype(dtype)


# ---------------------------------------------------------------------------
# Host page cache: decoded pages under one byte budget
# (XTB_EXTMEM_HOST_CACHE_MB, default 1024; 0 disables), least recently used
# out first, evicted when their page dies.  Streaming touches every page
# once a level, so without it each level would pay every decode again.
# ---------------------------------------------------------------------------
_PAGE_CACHE: "OrderedDict" = OrderedDict()  # id(page) -> array
_PAGE_CACHE_BYTES = 0
_CACHE_LOCK = threading.Lock()


def _host_cache_budget() -> int:
    import os

    try:
        mb = float(os.environ.get("XTB_EXTMEM_HOST_CACHE_MB", "1024"))
    except ValueError:
        mb = 1024.0
    return int(mb * 2**20)


def _page_cache_evict(pid: int) -> None:
    global _PAGE_CACHE_BYTES
    with _CACHE_LOCK:
        arr = _PAGE_CACHE.pop(pid, None)
        if arr is not None:
            _PAGE_CACHE_BYTES -= arr.nbytes


def _page_cache_get(page):
    with _CACHE_LOCK:
        hit = _PAGE_CACHE.get(id(page))
        if hit is not None:
            _PAGE_CACHE.move_to_end(id(page))
        return hit


def _page_cache_put(page, arr: np.ndarray) -> None:
    global _PAGE_CACHE_BYTES
    budget = _host_cache_budget()
    finalizer = weakref.finalize(page, _page_cache_evict, id(page))
    with _CACHE_LOCK:
        if arr.nbytes > budget or id(page) in _PAGE_CACHE:
            finalizer.detach()
            return
        _PAGE_CACHE[id(page)] = arr
        _PAGE_CACHE_BYTES += arr.nbytes
        while _PAGE_CACHE_BYTES > budget and _PAGE_CACHE:
            _, old = _PAGE_CACHE.popitem(last=False)
            _PAGE_CACHE_BYTES -= old.nbytes


def _zstd_available() -> bool:
    try:
        import zstandard  # noqa: F401

        return True
    except ImportError:
        return False


_POOL = None
_POOL_LOCK = threading.Lock()


def _prefetch_pool():
    """The two decode threads every scheduler shares (page streaming is
    level after level, so two windows never compete)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            import concurrent.futures

            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="xtb-extmem-prefetch")
        return _POOL


_SKETCH_POOL = None
SKETCH_THREADS = 8  # at most; numpy's sort releases the GIL


def _sketch_pool():
    """The threads of the pages' sketch summaries in pass 1."""
    global _SKETCH_POOL
    with _POOL_LOCK:
        if _SKETCH_POOL is None:
            import concurrent.futures
            import os

            _SKETCH_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, min(SKETCH_THREADS, os.cpu_count() or 1)),
                thread_name_prefix="xtb-extmem-sketch")
        return _SKETCH_POOL


def prefetch_lookahead(default: int = 2) -> int:
    """Pages in flight beyond the one being consumed:
    XTB_EXTMEM_PREFETCH_PAGES, else ``default``; 0 is the serial
    pipeline."""
    import os

    try:
        n = int(os.environ.get("XTB_EXTMEM_PREFETCH_PAGES", str(default)))
    except ValueError:
        n = default
    return max(n, 0)


def page_rows(page) -> int:
    return int(page.shape[0])


class DevicePageRing:
    """``n_slots`` page buffers on a GPU, filled on a copy stream of their
    own.  ``ready[s]``: recorded on the copy stream behind slot s's last
    copy; ``free[s]``: recorded on the compute stream behind the last
    kernel that read slot s (None before its first use).  ``staging``:
    one pinned host buffer a slot, the target of decoded pages; ``copied``
    the event behind the last copy out of each."""

    def __init__(self, device: torch.device, n_slots: int, rows: int,
                 n_features: int, dtype: torch.dtype, staged: bool) -> None:
        self.device = device
        self.n_slots = n_slots
        self.shape = (rows, n_features)
        self.dtype = dtype
        self.staged = staged
        self.slots = [torch.empty(self.shape, dtype=dtype, device=device)
                      for _ in range(n_slots)]
        self.bytes = sum(s.numel() * s.element_size() for s in self.slots)
        _device_pages(self.bytes)
        # the count goes back down when the ring is closed or collected
        self._uncount = weakref.finalize(self, _device_pages, -self.bytes)
        self.copy_stream = torch.cuda.Stream(device)
        self.ready = [torch.cuda.Event() for _ in range(n_slots)]
        self.free: List[Optional[torch.cuda.Event]] = [None] * n_slots
        self.staging = ([torch.empty(self.shape, dtype=dtype, pin_memory=True)
                         for _ in range(n_slots)] if staged else None)
        self.copied = [torch.cuda.Event() for _ in range(n_slots)]
        self.copied_any = [False] * n_slots
        self.next = 0  # slots are taken round robin across schedulers

    def fits(self, rows: int, n_features: int, dtype, staged: bool) -> bool:
        return (rows <= self.shape[0] and n_features == self.shape[1]
                and dtype == self.dtype and (self.staged or not staged))

    def close(self) -> None:
        """Wait for the copy stream, then give the slots back."""
        if self._uncount.alive:
            self.copy_stream.synchronize()
            self.slots = []
            self.staging = None
            self._uncount()


def _host_array(page) -> np.ndarray:
    """A page's bins as numpy (decoding a compressed or spilled page)."""
    if isinstance(page, torch.Tensor):
        return page.numpy()
    return np.asarray(page)


class PageScheduler:
    """Stream ``pages`` to ``device``, ``get(j)`` with strictly increasing
    j, ``lookahead`` pages ahead (reference extmem.py:485, redesigned for
    the card).

    On a GPU ``get(j)`` returns a view of a ``ring`` slot holding page j
    and makes the current (compute) stream wait on the page's copy; the
    consumer calls ``release(j)`` after it has enqueued every kernel that
    reads the page.  A pinned page's copy is enqueued on the ring's copy
    stream as soon as the page enters the window; a compressed or spilled
    one is decoded on the pool into the slot's pinned staging buffer and
    copied from there by the same worker.  On the CPU ``get(j)`` returns
    the page itself as a tensor (decoded on the pool when it must be).

    Counters: a page's staging seconds (decode plus enqueueing its copy)
    count as ``decode``; the seconds the consumer blocked on it as
    ``wait``; their excess as ``overlap``; pages and bytes staged."""

    def __init__(self, pages: List[Any], device: torch.device, *,
                 lookahead: Optional[int] = None,
                 ring: Optional[DevicePageRing] = None,
                 events: Optional[List[tuple]] = None) -> None:
        self._pages = pages
        self._device = torch.device(device)
        self._lookahead = (prefetch_lookahead() if lookahead is None
                           else max(int(lookahead), 0))
        self._cuda = self._device.type == "cuda"
        if self._cuda and ring is None:
            raise ValueError("a GPU page scheduler needs a DevicePageRing")
        if self._cuda and ring.n_slots != self._lookahead + 1:
            raise ValueError(f"ring has {ring.n_slots} slots for lookahead "
                             f"{self._lookahead}")
        self._ring = ring
        self._events = events
        self._futures: Dict[int, Any] = {}
        self._slot: Dict[int, int] = {}
        self._next = 0
        self._compute = (torch.cuda.current_stream(self._device)
                         if self._cuda else None)

    @property
    def lookahead(self) -> int:
        return self._lookahead

    def _record(self, name: str, j: int) -> None:
        if self._events is not None:
            self._events.append((name, j))

    def _load(self, j: int):
        """Stage page j: on the CPU its tensor; on a GPU its slot, with the
        copy enqueued.  Returns (result, seconds)."""
        t0 = time.perf_counter()
        page = self._pages[j]
        if not self._cuda:
            out = (page if isinstance(page, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(
                       _host_array(page))))
        else:
            out = self._copy(j, page)
        dt = time.perf_counter() - t0
        ins = _INSTRUMENTS
        ins[0].inc(dt)
        ins[3].inc()
        ins[4].inc(float(page_rows(page) * int(np.prod(page.shape[1:]))
                         * _itemsize(page)))
        return out, dt

    def _copy(self, j: int, page):
        ring = self._ring
        s = self._slot[j]
        rows = page_rows(page)
        if isinstance(page, torch.Tensor):
            if not page.is_pinned():
                raise ValueError("a page streamed to the card must be in "
                                 "pinned host memory")
            src = page
        else:
            arr = _host_array(page)
            src = ring.staging[s][:rows]
            if ring.copied_any[s]:
                # the last copy out of this staging buffer must be done
                ring.copied[s].synchronize()
            src.numpy()[...] = arr
        with torch.cuda.device(self._device), \
                torch.cuda.stream(ring.copy_stream):
            if ring.free[s] is not None:
                ring.copy_stream.wait_event(ring.free[s])
            ring.slots[s][:rows].copy_(src, non_blocking=True)
            ring.ready[s].record(ring.copy_stream)
            if not isinstance(page, torch.Tensor):
                ring.copied[s].record(ring.copy_stream)
                ring.copied_any[s] = True
        return ring.slots[s][:rows]

    def _take_slot(self, j: int) -> None:
        if self._cuda:
            ring = self._ring
            self._slot[j] = ring.next % ring.n_slots
            ring.next += 1

    def _submit_through(self, j: int) -> None:
        stop = min(j, len(self._pages) - 1)
        while self._next <= stop:
            k = self._next
            self._record("submit", k)
            self._take_slot(k)
            page = self._pages[k]
            if isinstance(page, torch.Tensor):
                # nothing to decode: enqueue the copy (or take the page)
                # here, without a thread hop
                self._futures[k] = self._load(k)
            else:
                self._futures[k] = _prefetch_pool().submit(self._load, k)
            self._next += 1

    def get(self, j: int) -> torch.Tensor:
        ins = _INSTRUMENTS
        if self._lookahead <= 0:
            self._record("load_sync", j)
            self._take_slot(j)
            self._next = j + 1
            out, dt = self._load(j)
            ins[1].inc(dt)  # serial: the consumer waited all of it
        else:
            self._submit_through(j + self._lookahead)
            self._record("wait", j)
            t0 = time.perf_counter()
            fut = self._futures.pop(j)
            out, decode_s = fut if isinstance(fut, tuple) else fut.result()
            wait_s = time.perf_counter() - t0
            ins[1].inc(wait_s)
            ins[2].inc(max(0.0, decode_s - wait_s))
        if self._cuda:
            self._compute.wait_event(self._ring.ready[self._slot[j]])
        return out

    def release(self, j: int) -> None:
        """Every kernel that reads page j is enqueued: its slot may be
        refilled behind them."""
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(self._compute)
            self._ring.free[self._slot.pop(j)] = ev

    def close(self) -> None:
        for fut in self._futures.values():
            if not isinstance(fut, tuple):
                fut.cancel()
        for fut in self._futures.values():
            if not isinstance(fut, tuple) and not fut.cancelled():
                try:
                    fut.result()
                except Exception:
                    pass
        self._futures.clear()


def _itemsize(page) -> int:
    if isinstance(page, torch.Tensor):
        return page.element_size()
    return int(np.dtype(page.dtype).itemsize)


class DataIter:
    """A user's batch iterator (reference core.py:265): ``next(input_data)``
    calls ``input_data(data=..., label=..., weight=..., ...)`` and returns
    1, or returns 0 at the end; ``reset()`` starts again."""

    def __init__(self, cache_prefix: Optional[str] = None,
                 release_data: bool = True) -> None:
        self.cache_prefix = cache_prefix
        self.release_data = release_data

    def next(self, input_data: Callable) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


def _iterate(it: DataIter):
    """Drive a DataIter: the keyword arguments of each batch's
    ``input_data`` call."""
    it.reset()
    while True:
        got: List[dict] = []

        def input_data(**kwargs):
            got.append(kwargs)
            return 1

        if not it.next(input_data):
            break
        if not got:
            raise RuntimeError(
                "DataIter.next returned 1 without calling input_data")
        yield got[0]


class ExtMemQuantileDMatrix(DMatrix):
    """Binned external-memory DMatrix (reference extmem.py:636,
    extmem_quantile_dmatrix.h:29): the pages stay on the host (or on
    disk with ``on_host=False``); the device only ever holds the pages of
    one streaming window beside the training state.

    ``device``: where pass 2 bins the batches and where training streams
    the pages (``None`` means ``cuda``); on a GPU the pages are pinned.
    ``ref``: a matrix whose cuts bin these pages (GetCutsFromRef).
    ``compress`` (the reference's default): zstd pages where zstandard is
    installed, else a warning and uncompressed pages.  A batch's
    ``feature_types`` mark its categorical columns (``'c'``)."""

    def __init__(self, data: DataIter, *, max_bin: int = 256,
                 ref: Optional[DMatrix] = None, missing: float = np.nan,
                 on_host: bool = True, enable_categorical: bool = False,
                 compress: bool = True, device=None, **kwargs: Any) -> None:
        if not isinstance(data, DataIter):
            raise TypeError("ExtMemQuantileDMatrix requires a DataIter")
        self.device = resolve_device(device)
        self.max_bin = max_bin
        self.on_host = on_host
        if compress and not _zstd_available():
            import warnings

            warnings.warn("zstandard not installed; external-memory pages "
                          "will be stored uncompressed")
            compress = False
        self.compress = compress
        self._pages: List[Any] = []
        self._page_rows: List[int] = []  # real rows a page
        self._spill_dir = (None if on_host
                           else tempfile.mkdtemp(prefix="xtb_pages_"))
        self._rings: Dict[Any, DevicePageRing] = {}
        self.ingest_seconds = {"sketch": 0.0, "bin": 0.0}

        # pass 1: the streaming sketch, a summary a batch
        t0 = time.perf_counter()
        sketch = None
        labels, weights, margins, n_col = [], [], [], None
        cat_mask = None
        num_row = 0
        for batch in _iterate(data):
            X = np.asarray(batch["data"], dtype=np.float32)
            num_row += X.shape[0]
            if n_col is None:
                n_col = X.shape[1]
                ft = batch.get("feature_types")
                if ft is not None:
                    cat_mask = np.asarray([t == "c" for t in ft], bool)
                if ref is None:
                    sketch = StreamingSketch(n_col, max_bin,
                                             cat_mask=cat_mask)
            if batch.get("label") is not None:
                lab = np.asarray(batch["label"], np.float32)
                if lab.ndim > 1 and lab.reshape(len(lab), -1).shape[1] > 1:
                    raise ValueError(
                        "ExtMemQuantileDMatrix takes one label a row; "
                        "multi-column labels need an in-memory DMatrix")
                labels.append(lab.reshape(-1))
            w_b = (np.asarray(batch["weight"], np.float32)
                   if batch.get("weight") is not None else None)
            if w_b is not None:
                weights.append(w_b)
            if batch.get("base_margin") is not None:
                margins.append(np.asarray(batch["base_margin"], np.float32))
            if ref is None:
                # the page summaries' sorts run on the sketch threads,
                # at most twice their number in flight
                sketch.wait(2 * SKETCH_THREADS - 1)
                sketch.push(X, weights=w_b, executor=_sketch_pool())
        if ref is not None:
            # the ref's cuts, in every rank alike: no collective
            cuts = getattr(ref, "_cuts", None)
            if cuts is None:
                cuts = ref.ensure_ellpack(max_bin=max_bin).cuts
        else:
            if sketch is None:
                # the column count comes with the first batch: a rank
                # without one cannot join the sketch's gather
                raise ValueError("DataIter produced no batches")
            from .. import collective

            # across ranks, one merge of every rank's page summaries: the
            # page is the sketch's unit, so the cuts do not depend on how
            # the pages are spread over the ranks (reference
            # extmem.py:712-721)
            cuts = sketch.finalize(distributed=collective.is_distributed())
        self._cuts: HistogramCuts = cuts
        self.ingest_seconds["sketch"] = time.perf_counter() - t0

        self.label = np.concatenate(labels) if labels else None
        self.weight = np.concatenate(weights) if weights else None
        self.base_margin = np.concatenate(margins) if margins else None
        self.feature_types = (["c" if c else "q" for c in cat_mask]
                              if cat_mask is not None else None)
        self.feature_names = None
        self.feature_weights = None
        self.label_lower_bound = self.label_upper_bound = None
        self.group_ptr = None
        self.group_version = 0
        self.cat_categories = None
        self.X = None
        self._csr = None
        self._host = None
        self._ellpack = None
        self._max_bin_built = max_bin
        self._weighted_sketch = None
        self._shape = (num_row, n_col or 0)

        # pass 2: bin each batch on the device, park its page on the host
        t0 = time.perf_counter()
        pin = self.device.type == "cuda"
        for bi, batch in enumerate(_iterate(data)):
            X = np.asarray(batch["data"], dtype=np.float32)
            page = build_ellpack(torch.from_numpy(X).to(self.device), cuts,
                                 row_align=PAGE_ALIGN)
            host = torch.empty(page.bins.shape, dtype=page.bins.dtype,
                               pin_memory=pin)
            host.copy_(page.bins)
            del page
            if compress:
                path = (f"{self._spill_dir}/page{bi}.zst"
                        if not on_host else None)
                host = CompressedPage(host.numpy(), path=path)
            elif not on_host:
                host = DiskPage(host.numpy(),
                                f"{self._spill_dir}/page{bi}.npy")
            self._pages.append(host)
            self._page_rows.append(X.shape[0])
        self.ingest_seconds["bin"] = time.perf_counter() - t0
        self.cuts_pad = torch.from_numpy(cuts.padded())
        self.n_bins = torch.from_numpy(cuts.n_bins_array())
        self.info.validate()

    # geometry
    @property
    def n_padded_total(self) -> int:
        return sum(page_rows(p) for p in self._pages)

    def page_offsets(self) -> List[int]:
        offs = [0]
        for p in self._pages:
            offs.append(offs[-1] + page_rows(p))
        return offs

    def page_bytes(self) -> int:
        """Bytes of the binned pages, uncompressed."""
        return sum(page_rows(p) * int(np.prod(p.shape[1:])) * _itemsize(p)
                   for p in self._pages)

    def num_row(self) -> int:
        return self._shape[0]

    def num_col(self) -> int:
        return self._shape[1]

    def valid_mask(self) -> np.ndarray:
        out = np.zeros(self.n_padded_total, bool)
        off = 0
        for p, r in zip(self._pages, self._page_rows):
            out[off: off + r] = True
            off += page_rows(p)
        return out

    def padded_labels(self) -> Optional[np.ndarray]:
        return self._pad_rows(self.label)

    def padded_weights(self) -> Optional[np.ndarray]:
        return self._pad_rows(self.weight)

    def padded_base_margin(self) -> Optional[np.ndarray]:
        return self._pad_rows(self.base_margin)

    def _pad_rows(self, arr: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """(R, ...) rows -> the page-padded layout, zeros on the pads."""
        if arr is None:
            return None
        out = np.zeros((self.n_padded_total,) + arr.shape[1:], np.float32)
        off = src = 0
        for p, r in zip(self._pages, self._page_rows):
            out[off: off + r] = arr[src: src + r]
            off += page_rows(p)
            src += r
        return out

    def host_dense(self) -> np.ndarray:
        raise NotImplementedError(
            "ExtMemQuantileDMatrix does not materialize raw data; "
            "prediction streams the binned pages instead")

    def ensure_ellpack(self, max_bin: int = 256, **kw):
        raise NotImplementedError("external-memory pages are pre-binned")

    def weighted_sketch(self):
        raise NotImplementedError(
            "ExtMemQuantileDMatrix does not materialize raw data")

    # streaming
    def scheduler(self, pages: List[Any], device, lookahead: int,
                  events=None) -> PageScheduler:
        """A scheduler of ``pages`` (of this matrix) to ``device``; on a GPU
        it fills this matrix's ring of ``lookahead + 1`` slots, made on
        first use (a ring of another size is closed first, so the matrix
        never holds more page slots on the device than one window)."""
        device = torch.device(device)
        ring = None
        if device.type == "cuda":
            staged = any(not isinstance(p, torch.Tensor) for p in pages)
            rows = max(page_rows(p) for p in self._pages)
            F = self.num_col()
            first = self._pages[0]
            dtype = (first.dtype if isinstance(first, torch.Tensor)
                     else torch.from_numpy(np.zeros(0, first.dtype)).dtype)
            key = str(device)
            ring = self._rings.get(key)
            if ring is None or ring.n_slots != lookahead + 1 or \
                    not ring.fits(rows, F, dtype, staged):
                self.release_device()
                ring = DevicePageRing(device, lookahead + 1, rows, F, dtype,
                                      staged)
                self._rings[key] = ring
        return PageScheduler(pages, device, lookahead=lookahead, ring=ring,
                             events=events)

    def release_device(self) -> None:
        """Give back the device's page slots."""
        for ring in self._rings.values():
            ring.close()
        self._rings.clear()


class _RawPageReplayIter(DataIter):
    """Replays a SparsePageDMatrix's raw pages (dense, missing as NaN)
    through the binned two-pass ingestion."""

    def __init__(self, owner: "SparsePageDMatrix") -> None:
        super().__init__()
        self._owner = owner
        self._i = 0

    def reset(self) -> None:
        self._i = 0

    def next(self, input_data) -> int:
        if self._i >= len(self._owner._raw_pages):
            return 0
        X = self._owner._raw_page_dense(self._i)
        input_data(data=X, **self._owner._raw_meta[self._i])
        self._i += 1
        return 1


class SparsePageDMatrix(ExtMemQuantileDMatrix):
    """Raw-CSR external-memory DMatrix (reference extmem.py:860,
    src/data/sparse_page_dmatrix.h:64): the batches are kept as raw CSR
    pages (zstd, host memory or disk), so prediction walks the raw values
    a page at a time with any model's float thresholds; training replays
    the raw pages through the two binned passes."""

    def __init__(self, data: DataIter, *, missing: float = np.nan,
                 max_bin: int = 256, ref: Optional[DMatrix] = None,
                 on_host: bool = True, compress: bool = True,
                 **kwargs: Any) -> None:
        import scipy.sparse as sp

        if not isinstance(data, DataIter):
            raise TypeError("SparsePageDMatrix requires a DataIter")
        use_zstd = compress and _zstd_available()
        raw_pages: List[Any] = []
        raw_meta: List[dict] = []
        spill = None if on_host else tempfile.mkdtemp(prefix="xtb_raw_")
        n_col = None
        for batch in _iterate(data):
            X = batch["data"]
            if sp.issparse(X):
                csr = sp.csr_matrix(X).astype(np.float32)
                vals = csr.data
                keep = np.isfinite(vals)
                if missing is not None and not np.isnan(missing):
                    keep &= vals != np.float32(missing)
                if not keep.all():
                    coo = csr.tocoo()
                    csr = sp.csr_matrix(
                        (coo.data[keep], (coo.row[keep], coo.col[keep])),
                        shape=csr.shape)
            else:
                Xd = np.asarray(X, np.float32)
                mask = np.isfinite(Xd)
                if missing is not None and not np.isnan(missing):
                    mask &= Xd != np.float32(missing)
                rows, cols = np.nonzero(mask)  # keeps explicit valid zeros
                csr = sp.csr_matrix((Xd[rows, cols], (rows, cols)),
                                    shape=Xd.shape)
            if n_col is None:
                n_col = csr.shape[1]
            elif csr.shape[1] != n_col:
                raise ValueError("batches disagree on feature count")

            def _store(arr, tag, i=len(raw_pages)):
                arr = np.ascontiguousarray(arr)
                if use_zstd:
                    path = None if spill is None else f"{spill}/p{i}_{tag}.zst"
                    return CompressedPage(arr, path)
                if spill is not None:
                    return DiskPage(arr, f"{spill}/p{i}_{tag}.npy")
                return arr

            raw_pages.append((_store(csr.indptr.astype(np.int64), "ip"),
                              _store(csr.indices.astype(np.int32), "ix"),
                              _store(csr.data.astype(np.float32), "va"),
                              csr.shape))
            raw_meta.append({k: np.asarray(v) for k, v in batch.items()
                             if k != "data" and v is not None})
        if not raw_pages:
            raise ValueError("iterator produced no batches")
        self._raw_pages = raw_pages
        self._raw_meta = raw_meta
        self.has_raw_pages = True
        # missing is structural NaN in the replayed pages
        super().__init__(_RawPageReplayIter(self), max_bin=max_bin, ref=ref,
                         missing=np.nan, on_host=on_host, compress=compress,
                         **kwargs)

    def _raw_page_dense(self, i: int) -> np.ndarray:
        """Raw page i as a dense (rows, F) f32 matrix, absent entries
        NaN."""
        ip, ix, va, shape = self._raw_pages[i]
        ip, ix, va = np.asarray(ip), np.asarray(ix), np.asarray(va)
        X = np.full(shape, np.nan, np.float32)
        rows = np.repeat(np.arange(shape[0]), np.diff(ip))
        X[rows, ix] = va
        return X

    def raw_dense_pages(self):
        """Each raw page made dense, one at a time."""
        for i in range(len(self._raw_pages)):
            yield self._raw_page_dense(i)


class ExtMemConfig:
    """Out-of-core training across ranks, ``train(params, ExtMemConfig(
    ...))`` (reference extmem.py:956): each rank builds an
    ExtMemQuantileDMatrix over the page shards a ``ShardMap`` gives it.

    ``data_fn(shard_map, rank, world)`` returns the rank's ``DataIter``
    (one ``input_data`` batch a page it owns), or ``(DataIter, evals)``
    to bring evaluation sets too.  ``num_shards`` defaults to the world
    size; ``max_bin``, ``on_host``, ``compress`` and
    ``enable_categorical`` go to the matrix.  The pages' sketch merges
    every rank's page summaries once, and the trees sum each level's
    histograms over the ranks; one process (world 1) trains the same
    way on all the shards."""

    def __init__(self, data_fn: Callable[..., Any], *,
                 num_shards: Optional[int] = None, max_bin: int = 256,
                 on_host: bool = True, compress: bool = True,
                 enable_categorical: bool = False) -> None:
        if not callable(data_fn):
            raise TypeError("ExtMemConfig.data_fn must be callable")
        self.data_fn = data_fn
        self.num_shards = int(num_shards) if num_shards is not None else None
        self.max_bin = int(max_bin)
        self.on_host = bool(on_host)
        self.compress = bool(compress)
        self.enable_categorical = bool(enable_categorical)

    def build(self, device=None):
        """This rank's (matrix on ``device``, evals), in the collective
        that is current (reference extmem.py:994-1012)."""
        from .. import collective
        from ..elastic import ShardMap

        rank, world = collective.get_rank(), collective.get_world_size()
        smap = ShardMap.create(self.num_shards or world, world)
        built = self.data_fn(smap, rank, world)
        evals: List[Any] = []
        if isinstance(built, tuple):
            built, ev = built
            evals = list(ev) if ev else []
        if not isinstance(built, DataIter):
            raise TypeError(
                "ExtMemConfig.data_fn must return a DataIter (or a "
                f"(DataIter, evals) pair); got {type(built).__name__}")
        dtrain = ExtMemQuantileDMatrix(
            built, max_bin=self.max_bin, on_host=self.on_host,
            compress=self.compress,
            enable_categorical=self.enable_categorical, device=device)
        return dtrain, evals
