"""Host-side input pipeline: native batch assembly + CPU elastic deformation
with a double-buffered host->device feed.

This is the JAX-side rebuild of the reference's extras/deformer.py (a
multiprocessing.Process pool + mp.Queue deforming batches of a shared-memory
array in place). Here the heavy lifting is a C++ thread pool
(native/deformer.cc, loaded via ctypes), and the prefetcher overlaps batch
assembly + host augmentation + device upload with device compute — the
producer/consumer pattern of the reference, double-buffered.

Use this for corpora too large to keep resident in device memory; for
resident datasets the in-graph augmentation path is faster (no host round
trip) and remains the default.

The C++ library is built on demand with make/g++; every entry point has a
pure-numpy fallback so the pipeline works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtheanet_native.so")

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def native_lib():
    """Load (building if necessary) the native library; None if unavailable.

    Thread-safe: concurrent first calls (e.g. two HostPipeline producer
    threads) serialize on a lock — a check-then-set race would let one
    caller observe a half-built .so (or a not-yet-set _lib) and silently
    cache the numpy fallback for the whole process, making augmentation
    RNG streams race-dependent. make is invoked whenever the source dir is
    present (a fast no-op when the .so is fresh), so editing deformer.cc
    never leaves a stale library behind."""
    global _lib, _lib_tried
    if _lib_tried:  # benign racy fast path: set only AFTER _lib is final
        return _lib
    with _lib_lock:
        if _lib_tried:
            return _lib
        try:
            if os.path.isdir(_NATIVE_DIR):
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s"],
                    check=True, capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(_LIB_PATH)
            lib.theanet_make_warp.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_float, ctypes.c_uint64,
            ]
            lib.theanet_deform_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_float, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.theanet_deform_batch.restype = ctypes.c_int
            lib.theanet_gather_rows.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int,
            ]
            _lib = lib
        except Exception as e:  # no toolchain / build failure
            print("theanet_tpu.io: native library unavailable ({}); using "
                  "numpy fallbacks".format(e))
            _lib = None
        _lib_tried = True
    return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def make_warp_host(h, w, translation=0, zoom=1, magnitude=0, sigma=1,
                   angle=0, seed=0):
    """Host-side warp grid (2, h, w), native when available."""
    lib = native_lib()
    target = np.empty((2, h, w), dtype=np.float32)
    if lib is not None:
        lib.theanet_make_warp(
            _fptr(target), h, w, float(translation), float(zoom),
            float(magnitude), int(sigma), float(angle), np.uint64(seed),
        )
        return target
    # numpy fallback via the in-graph oracle
    import jax

    from ..ops.elastic import ElasticConfig, sample_warp

    cfg = ElasticConfig(img_sz=h, translation=translation, zoom=zoom,
                        magnitude=magnitude, sigma=sigma, angle=angle)
    t, _ = sample_warp(jax.random.PRNGKey(seed), cfg, h, w)
    return np.asarray(t)


def deform_batch_host(x, target, nearest=False, pflip=0.0, seed=0,
                      n_threads=0):
    """Deform batch x (B, C, H, W) in place at the shared warp ``target``."""
    lib = native_lib()
    b, c, h, w = x.shape
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    if lib is not None:
        if x.dtype != np.float32 or not x.flags["C_CONTIGUOUS"]:
            # the in-place contract forbids a silent copy, and the ctypes
            # kernel would reinterpret the buffer as C-order float32 — a
            # real error (asserts vanish under python -O)
            raise ValueError(
                "deform_batch_host mutates x in place: pass a C-contiguous "
                f"float32 array (got {x.dtype}, "
                f"contiguous={x.flags['C_CONTIGUOUS']})"
            )
        target = np.ascontiguousarray(target, dtype=np.float32)
        rc = lib.theanet_deform_batch(
            _fptr(x), b, c, h, w, _fptr(target), int(nearest), float(pflip),
            np.uint64(seed), n_threads,
        )
        if rc != 0:
            raise RuntimeError(
                "native deform worker failed (likely allocation failure "
                "under memory pressure)"
            )
        return x
    # numpy fallback
    ty = np.clip(target[0], 0, h - 1 - 0.001)
    tx = np.clip(target[1], 0, w - 1 - 0.001)
    if nearest:
        out = x[:, :, np.floor(ty + 0.5).astype(np.int32),
                np.floor(tx + 0.5).astype(np.int32)]
    else:
        t0, l0 = ty.astype(np.int32), tx.astype(np.int32)
        fy, fx = ty - t0, tx - l0
        out = (x[:, :, t0, l0] * (1 - fy) * (1 - fx)
               + x[:, :, t0, l0 + 1] * (1 - fy) * fx
               + x[:, :, t0 + 1, l0] * fy * (1 - fx)
               + x[:, :, t0 + 1, l0 + 1] * fy * fx)
    if pflip:
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        mask = rng.rand(*out.shape) < pflip
        out = np.where(mask, 1 - out, out)
    x[:] = out
    return x


def gather_rows_host(src, idx, n_threads=0):
    """dst[i] = src[idx[i]] — threaded shuffled batch assembly."""
    lib = native_lib()
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    if lib is not None:
        out = np.empty((len(idx),) + src.shape[1:], dtype=np.float32)
        row = int(np.prod(src.shape[1:]))
        lib.theanet_gather_rows(
            _fptr(src), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _fptr(out), len(idx), row, n_threads,
        )
        return out
    return src[idx]


def _put(q, item, stop, poll_s=0.1):
    """queue.put that aborts when the consumer is gone (stop set) — keeps an
    abandoned producer thread from blocking forever on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except queue.Full:
            continue
    return False


class HostPipeline:
    """Double-buffered producer of (x, y) or (x, y, aux) device batches.

    Background threads assemble shuffled batches (native gather), optionally
    deform them on the host (native thread-pool deformer), and push device
    arrays through a bounded queue so upload overlaps device compute —
    extras/deformer.py's producer/consumer design, rebuilt. When ``data_aux``
    is given, aux rows ride along with the same shuffled gather (the
    reference plumbs aux beside x/y the same way, train.py:131-135) and the
    pipeline yields (x, y, aux) triples for aux-head nets.
    """

    def __init__(self, data_x, data_y, batch_sz, *, data_aux=None,
                 deform: Optional[dict] = None,
                 shuffle=True, seed=0, depth=2, to_device=True):
        self.data_x = np.ascontiguousarray(data_x, dtype=np.float32)
        self.data_y = np.asarray(data_y, dtype=np.int32)
        self.data_aux = (
            np.ascontiguousarray(data_aux, dtype=np.float32)
            if data_aux is not None else None
        )
        self.batch_sz = batch_sz
        self.deform = deform
        self.shuffle = shuffle
        self.seed = seed
        self.depth = depth
        self.to_device = to_device
        self.n_batches = len(data_x) // batch_sz
        self._epoch = 0  # bumps per __iter__ so every epoch gets a fresh
        #                  shuffle order and fresh deformations
        self._epoch_lock = threading.Lock()
        self._producers = []  # live (stop_event, thread) pairs

    def close(self):
        """Stop and join any producer threads still alive (iterators that
        were abandoned mid-epoch without being garbage-collected). Idempotent;
        exhausted iterators clean up after themselves."""
        with self._epoch_lock:
            producers, self._producers = self._producers, []
        for stop, t in producers:
            stop.set()
            t.join(timeout=5.0)

    def __iter__(self):
        # atomic read-then-increment: concurrent iterators must not share an
        # epoch number (same shuffle order + same warp/flip seeds would
        # replay byte-identical augmentation streams)
        with self._epoch_lock:
            epoch = self._epoch
            self._epoch += 1
        return self._iter_epoch(epoch)

    def _iter_epoch(self, epoch):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        failure = []

        def producer_guarded():
            try:
                producer()
            except BaseException as e:  # surface in the consumer, don't hang it
                failure.append(e)
                _put(q, None, stop)

        def producer():
            rng = np.random.RandomState((self.seed + 77003 * epoch) % (2**31))
            if self.shuffle:
                # permute ALL samples and keep the first n_batches*batch_sz:
                # the partial-batch tail is dropped (whole batches only, like
                # the reference), but WHICH samples land in the tail rotates
                # per epoch instead of excluding the same ones forever
                order = rng.permutation(len(self.data_x))[
                    : self.n_batches * self.batch_sz]
            else:
                order = np.arange(self.n_batches * self.batch_sz)
            for b in range(self.n_batches):
                if stop.is_set():
                    break
                idx = order[b * self.batch_sz : (b + 1) * self.batch_sz]
                x = gather_rows_host(self.data_x, idx)
                y = self.data_y[idx]
                aux = (
                    gather_rows_host(self.data_aux, idx)
                    if self.data_aux is not None else None
                )
                if self.deform:
                    d = self.deform
                    h, w = x.shape[2], x.shape[3]
                    step = epoch * self.n_batches + b
                    warp = make_warp_host(
                        h, w,
                        translation=d.get("translation", 0),
                        zoom=d.get("zoom", 1),
                        magnitude=d.get("magnitude", 0),
                        sigma=d.get("sigma", 1),
                        angle=d.get("angle", 0),
                        seed=self.seed * 1000003 + step,
                    )
                    if d.get("invert_image"):
                        np.subtract(1.0, x, out=x)
                    deform_batch_host(
                        x, warp,
                        nearest=d.get("nearest", False),
                        pflip=d.get("pflip", 0.0),
                        # multiplier must exceed any realistic step count,
                        # like the warp stream's: seed*7+step collides
                        # across the fresh-pipeline-per-epoch usage
                        # (seed=epoch), replaying identical flip masks
                        seed=self.seed * 1000003 + 2 * step + 1,
                    )
                if self.to_device:
                    import jax

                    x, y = jax.device_put(x), jax.device_put(y)
                    if aux is not None:
                        aux = jax.device_put(aux)
                item = (x, y) if aux is None else (x, y, aux)
                if not _put(q, item, stop):
                    return
            _put(q, None, stop)

        t = threading.Thread(target=producer_guarded, daemon=True)
        with self._epoch_lock:
            self._producers.append((stop, t))
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if failure:
                        raise RuntimeError(
                            "HostPipeline producer failed"
                        ) from failure[0]
                    break
                yield item
        finally:
            # stop + join here covers generator close/GC; pipeline.close()
            # covers iterators whose suspended frames are pinned alive
            # (e.g. by a held traceback) and never collected
            stop.set()
            t.join(timeout=5.0)
            with self._epoch_lock:
                try:
                    self._producers.remove((stop, t))
                except ValueError:
                    pass  # already reaped by close()
