"""ctypes binding for the native C++ frame pump (native/frame_pump.cpp), a
verbatim copy of raw_image_pipeline_tpu/runtime/native.py, whose package
imports jax; tests/test_torch_runtime.py holds the copy to the original.

The shared library is built on first use with the repo Makefile (g++ is
part of the baked toolchain); if compilation is impossible the runtime
falls back to Python-side reading transparently.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libframe_pump.so")

_lib = None
# tri-state loader caches: None = not attempted, _LOAD_FAILED = attempted and
# failed (so a missing toolchain pays the build subprocess at most once per
# process), else the loaded CDLL
_LOAD_FAILED = object()


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return None if _lib is _LOAD_FAILED else _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            _lib = _LOAD_FAILED
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _lib = _LOAD_FAILED
        return None
    lib.fp_create.restype = ctypes.c_void_p
    lib.fp_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.fp_next_batch.restype = ctypes.c_int
    lib.fp_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fp_release_batch.argtypes = [ctypes.c_void_p]
    lib.fp_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class FramePump:
    """Iterate raw frame files as ready-assembled uint8 batches.

    Frames must share one shape/dtype (8-bit raw Bayer or interleaved
    color); `header_skip` skips a fixed per-file header (e.g. a PGM one).
    Yields arrays of shape (n, *frame_shape) — copies, safe to hold.
    """

    def __init__(
        self,
        paths: List[str],
        frame_shape: Tuple[int, ...],
        batch: int = 8,
        header_skip: int = 0,
        slots: int = 4,
        readers: int = 4,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native frame pump unavailable (g++/make failed)")
        self._lib = lib
        self.frame_shape = tuple(frame_shape)
        self.batch = batch
        frame_bytes = int(np.prod(frame_shape))
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._h = lib.fp_create(
            arr, len(paths), frame_bytes, header_skip, batch, slots, readers
        )
        if not self._h:
            raise RuntimeError("fp_create failed")
        self._frame_bytes = frame_bytes

    def __iter__(self) -> Iterator[np.ndarray]:
        data = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int()
        while True:
            rc = self._lib.fp_next_batch(self._h, ctypes.byref(data), ctypes.byref(n))
            if rc != 0:
                return
            nf = n.value
            buf = np.ctypeslib.as_array(data, shape=(nf * self._frame_bytes,))
            out = buf.copy().reshape((nf,) + self.frame_shape)
            self._lib.fp_release_batch(self._h)
            yield out

    def close(self):
        if self._h:
            self._lib.fp_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Native writer pool (native/frame_sink.cpp)
# ---------------------------------------------------------------------------

_SINK_LIB_PATH = os.path.join(_NATIVE_DIR, "libframe_sink.so")
_sink_lib = None


def _load_sink() -> Optional[ctypes.CDLL]:
    global _sink_lib
    if _sink_lib is not None:
        return None if _sink_lib is _LOAD_FAILED else _sink_lib
    if not os.path.exists(_SINK_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            _sink_lib = _LOAD_FAILED
            return None
    try:
        lib = ctypes.CDLL(_SINK_LIB_PATH)
    except OSError:
        _sink_lib = _LOAD_FAILED
        return None
    lib.fs_create.restype = ctypes.c_void_p
    lib.fs_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fs_submit.restype = ctypes.c_int
    lib.fs_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.fs_flush.restype = ctypes.c_long
    lib.fs_flush.argtypes = [ctypes.c_void_p]
    lib.fs_destroy.argtypes = [ctypes.c_void_p]
    _sink_lib = lib
    return lib


def native_sink_available() -> bool:
    return _load_sink() is not None


class FrameSink:
    """Threaded native writer pool: PNG/JPEG encoding is CPU-bound and
    cv2.imwrite holds the GIL, so a Python-side file sink caps the stream
    far below chain throughput; this pool encodes/writes on worker threads
    behind a bounded queue (submit blocks when full — backpressure).

    write(path, img) copies the array and returns immediately; flush()
    waits for the queue to drain and returns the failed-write count."""

    def __init__(self, threads: int = 8, queue_cap: int = 64):
        lib = _load_sink()
        if lib is None:
            raise RuntimeError("native frame sink unavailable (build failed)")
        self._lib = lib
        self._h = lib.fs_create(threads, queue_cap)
        if not self._h:
            raise RuntimeError("fs_create failed")

    def write(self, path: str, img: np.ndarray) -> None:
        img = np.ascontiguousarray(img)
        if img.dtype != np.uint8 or img.ndim not in (2, 3):
            raise ValueError("FrameSink writes uint8 HxW or HxWx3 images")
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        rc = self._lib.fs_submit(
            self._h, path.encode(),
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        )
        if rc != 0:
            raise RuntimeError(f"fs_submit failed ({rc})")

    def flush(self) -> int:
        return int(self._lib.fs_flush(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.fs_flush(self._h)
            self._lib.fs_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
