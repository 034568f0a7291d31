"""Host input pipeline (`skyhdr.data.pipeline`): TFRecord panoramas ->
shuffled, batched numpy batches -> tensors on the card.

Parsing semantics are the reference's (train.py:96-117): raw float32 bytes
-> [h, w, 3], BGR->RGB flip (the records store OpenCV order), DrTMO mean
normalisation 0.5*hdr/(mean+1e-6). The vMF ground truth and the LDR
degradation are built on the device by the train step, so the host only
decodes, shuffles and stacks. `prefetch_to_device` overlaps that host work,
and the copy to the card, with the device's compute.

The datasets yield the same batches in the same order as the JAX
package's for the same seed (`tests/test_torch_loop.py`). One process
reads every file: the process index and count default to 0 and 1.
"""

from __future__ import annotations

import glob
import itertools
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

import torch

from skyhdr_torch.data.records import (decode_example, iter_tfrecord,
                                       read_tfrecord_examples)


def default_decode_workers() -> int:
    """Host decode parallelism (reference train.py:125-131 reads and parses
    at AUTOTUNE parallelism; this is the equivalent knob)."""
    return min(8, os.cpu_count() or 1)


def _decode_file(path: str, imshape) -> List[Tuple[np.ndarray, float]]:
    return [prepare_sample(decode_example(r), imshape)
            for r in iter_tfrecord(path)]


def _iter_samples(files: List[str], imshape,
                  workers: int) -> Iterator[Tuple[np.ndarray, float]]:
    """Decode files on a thread pool, yielding samples in EXACT `files`
    order (a bounded in-flight window keeps memory constant).

    File-granularity parallelism is record-granularity here — the reference
    dataset layout is one Example per .tfrecord (makeTFRecord.py:58-62) —
    and it parallelizes the whole per-record cost: file read, gzip inflate
    and the numpy decode all release the GIL; only the small pure-Python
    protobuf walk serializes. Order preservation keeps every seeded shuffle
    byte-identical to the serial path."""
    if workers <= 1 or len(files) <= 1:
        for p in files:
            yield from _decode_file(p, imshape)
        return
    ex = ThreadPoolExecutor(workers)
    try:
        files_it = iter(files)
        pending = deque(
            ex.submit(_decode_file, p, imshape)
            for p in itertools.islice(files_it, workers * 2))
        while pending:
            samples = pending.popleft().result()
            nxt = next(files_it, None)
            if nxt is not None:
                pending.append(ex.submit(_decode_file, nxt, imshape))
            yield from samples
    finally:
        # An abandoned iteration (evaluate --max-batches, zip with a shorter
        # iterable) finalizes the generator here; cancel the in-flight
        # window instead of draining up to workers*2 decodes, and never
        # block generator finalization on pool teardown.
        ex.shutdown(wait=False, cancel_futures=True)


def prepare_sample(example: Dict, imshape: Tuple[int, int, int]):
    """Decode one Example -> (hdr [h,w,3] RGB mean-normalized, elevation).

    Mirrors reference _parse_function (train.py:96-117) minus the vMF
    expansion (done on device).
    """
    h, w, c = imshape
    raw = example["image"]
    hdr = np.frombuffer(raw, np.float32).reshape(h, w, c)
    hdr = hdr[:, :, ::-1]  # BGR -> RGB (train.py:107)
    hdr = 0.5 * hdr / (hdr.mean() + 1e-6)
    elevation = float(np.asarray(example["elevation"]).reshape(-1)[0])
    return hdr.astype(np.float32), elevation


class PanoramaDataset:
    """In-memory dataset of sky-dome panoramas with epoch shuffling.

    The 32x128 Laval training set is ~1.5 GB decoded; it is cached in one
    contiguous array so every epoch is pure slicing. Set cache=False to
    re-decode lazily per epoch for larger configs.
    """

    def __init__(self, tfrecord_dir: str, imshape=(32, 128, 3), batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0, drop_remainder: bool = True,
                 cache: bool = True, decode_workers: Optional[int] = None):
        self.dir = tfrecord_dir
        self.imshape = tuple(imshape)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        self._cache = cache
        self.decode_workers = (default_decode_workers()
                               if decode_workers is None else decode_workers)
        self._hdr: Optional[np.ndarray] = None
        self._elev: Optional[np.ndarray] = None
        if cache:
            self._load_all()

    def _samples(self) -> Iterator[Tuple[np.ndarray, float]]:
        files = _resolve_files(self.dir)
        if not files:
            raise FileNotFoundError(f"no .tfrecord files under {self.dir}")
        return _iter_samples(files, self.imshape, self.decode_workers)

    def _load_all(self):
        hdrs: List[np.ndarray] = []
        elevs: List[float] = []
        for hdr, elev in self._samples():
            hdrs.append(hdr)
            elevs.append(elev)
        self._hdr = np.stack(hdrs)
        self._elev = np.asarray(elevs, np.float32)

    def __len__(self) -> int:
        n = len(self._hdr) if self._hdr is not None else sum(
            1 for _ in read_tfrecord_examples(self.dir)
        )
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._cache:
            n = len(self._hdr)
            order = self._rng.permutation(n) if self.shuffle else np.arange(n)
            stop = n - n % self.batch_size if self.drop_remainder else n
            for i in range(0, stop, self.batch_size):
                idx = order[i:i + self.batch_size]
                yield {"hdr": self._hdr[idx], "elevation": self._elev[idx]}
        else:
            batch_h, batch_e = [], []
            for hdr, elev in self._samples():
                batch_h.append(hdr)
                batch_e.append(elev)
                if len(batch_h) == self.batch_size:
                    yield {"hdr": np.stack(batch_h),
                           "elevation": np.asarray(batch_e, np.float32)}
                    batch_h, batch_e = [], []
            if batch_h and not self.drop_remainder:
                yield {"hdr": np.stack(batch_h),
                       "elevation": np.asarray(batch_e, np.float32)}


def _resolve_files(path_or_dir: str) -> List[str]:
    if os.path.isdir(path_or_dir):
        return sorted(glob.glob(os.path.join(path_or_dir, "*.tfrecord")))
    if any(ch in path_or_dir for ch in "*?["):
        return sorted(glob.glob(path_or_dir))
    return [path_or_dir]


class StreamingPanoramaDataset:
    """Constant-memory TFRecord streamer with a windowed shuffle buffer.

    Reference semantics (train.py:119-131): TFRecordDataset over the file
    glob, shuffle(10000), batch(drop_remainder=True). Memory stays at
    `shuffle_buffer` decoded samples regardless of split size — the 30k-image
    Laval training split (~6 GB decoded at 64x256) never lives in host RAM
    at once, unlike the cached PanoramaDataset.

    Sharded reading: pass process_index/process_count (default 0 and 1)
    and each process reads the files[i::n] subset — disjoint per-process
    sample streams for data-parallel training.

    The shuffle algorithm is tf.data's: keep a buffer of `shuffle_buffer`
    samples, emit a uniformly random element and refill from the stream;
    file order is also reshuffled each epoch.
    """

    def __init__(self, tfrecord_dir: str, imshape=(32, 128, 3),
                 batch_size: int = 32, shuffle: bool = True,
                 shuffle_buffer: int = 10000, seed: int = 0,
                 drop_remainder: bool = True,
                 process_index: int = 0,
                 process_count: int = 1,
                 decode_workers: Optional[int] = None):
        self.imshape = tuple(imshape)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shuffle_buffer = max(1, shuffle_buffer)
        self.drop_remainder = drop_remainder
        self.decode_workers = (default_decode_workers()
                               if decode_workers is None else decode_workers)
        self._rng = np.random.default_rng(seed)
        all_files = _resolve_files(tfrecord_dir)
        if not all_files:
            raise FileNotFoundError(f"no .tfrecord files under {tfrecord_dir}")
        self.files = all_files[process_index::process_count]
        self._n_samples: Optional[int] = None

    def _count(self) -> int:
        if self._n_samples is None:
            self._n_samples = sum(
                1 for p in self.files for _ in iter_tfrecord(p)
            )
        return self._n_samples

    def __len__(self) -> int:
        n = self._count()
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _sample_stream(self, rng) -> Iterator[Tuple[np.ndarray, float]]:
        files = list(self.files)
        if self.shuffle:
            rng.shuffle(files)
        # Parallel ordered decode: same sample order as the serial loop, so
        # the seeded windowed shuffle below stays byte-identical.
        yield from _iter_samples(files, self.imshape, self.decode_workers)

    def _shuffled_stream(self, rng) -> Iterator[Tuple[np.ndarray, float]]:
        if not self.shuffle:
            yield from self._sample_stream(rng)
            return
        buf: List[Tuple[np.ndarray, float]] = []
        for sample in self._sample_stream(rng):
            if len(buf) < self.shuffle_buffer:
                buf.append(sample)
                continue
            j = int(rng.integers(len(buf)))
            out, buf[j] = buf[j], sample
            yield out
        order = rng.permutation(len(buf))
        for j in order:
            yield buf[j]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # Child generator draws from self._rng so each epoch reshuffles.
        rng = self._rng
        batch_h: List[np.ndarray] = []
        batch_e: List[float] = []
        for hdr, elev in self._shuffled_stream(rng):
            batch_h.append(hdr)
            batch_e.append(elev)
            if len(batch_h) == self.batch_size:
                yield {"hdr": np.stack(batch_h),
                       "elevation": np.asarray(batch_e, np.float32)}
                batch_h, batch_e = [], []
        if batch_h and not self.drop_remainder:
            yield {"hdr": np.stack(batch_h),
                   "elevation": np.asarray(batch_e, np.float32)}


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the host iterator's batches (dicts of numpy arrays) as tensors
    on `device`, with up to `size` batches prepared ahead by a worker
    thread.

    On a CUDA device the worker pins each array and copies it with
    `non_blocking=True` on a side stream, then records an event; the
    consumer's stream waits on that event before the batch is handed over,
    so no step reads a half-copied batch, and each tensor is marked as used
    on the consumer's stream so its memory is not recycled early. An error
    in the host iterator is raised here, in the consumer."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        try:
            for item in iterator:
                if stream is None:
                    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                           for k, v in item.items()}
                    event = None
                else:
                    with torch.cuda.stream(stream):
                        out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                               .to(device, non_blocking=True) for k, v in item.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                if not put((out, event)):
                    return
        except Exception as e:  # handed to the consumer, raised there
            put(e)
            return
        put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            out, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in out.values():
                    v.record_stream(consumer)
            yield out
    finally:
        stop.set()
        t.join(timeout=10)


def synthetic_dataset(n: int, imshape=(32, 128, 3), seed: int = 0,
                      batch_size: int = 32):
    """Deterministic synthetic panoramas (bright sun blob on a sky gradient)
    for hermetic tests and benchmarks."""
    h, w, c = imshape
    rng = np.random.default_rng(seed)
    ys = rng.uniform(2, h - 2, size=n)
    hdrs = np.empty((n, h, w, c), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        sun_y = ys[i]
        sun_x = w * 0.5 - 1
        d2 = (yy - sun_y) ** 2 + (xx - sun_x) ** 2
        sky = 0.3 + 0.4 * (1 - yy / h)[..., None] * np.ones((1, 1, 3), np.float32)
        sun = 50.0 * np.exp(-d2 / 4.0)[..., None]
        img = sky + sun + rng.uniform(0, 0.05, size=(h, w, c))
        img = 0.5 * img / (img.mean() + 1e-6)
        hdrs[i] = img
    ds = {"hdr": hdrs, "elevation": ys.astype(np.float32)}

    class _Synth:
        def __len__(self):
            return n // batch_size

        def __iter__(self):
            for i in range(0, n - n % batch_size, batch_size):
                yield {"hdr": ds["hdr"][i:i + batch_size],
                       "elevation": ds["elevation"][i:i + batch_size]}

    return _Synth()
