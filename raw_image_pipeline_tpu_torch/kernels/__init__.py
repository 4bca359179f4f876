"""The port's hand-written CUDA kernels: build, ctypes bindings, launch
counts.

The sources live in `raw_image_pipeline_tpu_torch/csrc/*.cu`. At first use
they are compiled by nvcc for sm_90a (Hopper), one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, `build/kernels/libisp_kernels_<hash>.so` at the root of the
checkout, which is loaded with ctypes. The hash covers the sources, their
headers and the flags, so an edited source is rebuilt. Nothing is built or
loaded when this module is imported: the CPU tests import every module and never reach a
kernel.

Each kernel is a `Kernel` object: its C entry, the TPU kernel it replaces,
the grids one call of its entry puts on the device, and `launches`, a count
that its wrapper (in ops/) raises by one where it launches the kernel and
nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("debayer.cu", "ccc_histogram.cu", "ccc_response.cu", "debayer_mht.cu",
           "remap_float.cu")
HEADERS = ("debayer_strip.cuh",)  # included by the sources; in the hash too
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry -> argtypes (every pointer and the stream as c_void_p, so ctypes
# never narrows a 64-bit address)
_SIGNATURES = {
    "isp_debayer_bilinear": (_P, _P, _I, _I, _I, _I, _I, _P),
    "isp_ccc_histogram": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P),
    "isp_ccc_response": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "isp_debayer_mht": (_P, _P, _I, _I, _I, _I, _I, _P),
    "isp_remap_float": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}


class _Library:
    """The built library, loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None  # None: not built here

    def path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES + HEADERS:
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"libisp_kernels_{h.hexdigest()[:16]}.so")

    def _build(self, out: str) -> None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        tmp = f"{out}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [(src, p.communicate()[0], p.returncode) for src, p in zip(SOURCES, procs)]
        failed = [f"{src} ({rc}):\n{log}" for src, log, rc in logs if rc != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        self.build_seconds = time.perf_counter() - t0

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self.path()
                if not os.path.exists(path):
                    self._build(path)
                lib = ctypes.CDLL(path)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.isp_error_string.argtypes = (ctypes.c_int,)
                lib.isp_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


LIBRARY = _Library()


class Kernel:
    """One hand-written kernel and its launch count."""

    def __init__(self, name: str, entry: str, source: str, replaces: str, grids: int = 1):
        self.name = name
        self.entry = entry
        self.source = source  # path in the repository
        self.replaces = replaces  # file:line of the TPU kernel
        self.grids = grids  # device launches (grids) of one call of the entry
        self.launches = 0

    def launch(self, *args) -> None:
        """Call the C entry (which launches on the given stream and returns
        cudaGetLastError()); raise if the launch failed."""
        lib = LIBRARY.get()
        err = getattr(lib, self.entry)(*args)
        if err != 0:
            msg = lib.isp_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


DEBAYER_BILINEAR = Kernel(
    "debayer_bilinear", "isp_debayer_bilinear",
    "raw_image_pipeline_tpu_torch/csrc/debayer.cu",
    "raw_image_pipeline_tpu/ops/debayer_pallas.py:51",
)
CCC_HISTOGRAM = Kernel(
    "ccc_histogram", "isp_ccc_histogram",
    "raw_image_pipeline_tpu_torch/csrc/ccc_histogram.cu",
    "raw_image_pipeline_tpu/ops/ccc.py:96",
)
CCC_RESPONSE = Kernel(
    "ccc_response", "isp_ccc_response",
    "raw_image_pipeline_tpu_torch/csrc/ccc_response.cu",
    "raw_image_pipeline_tpu/ops/ccc.py:280", grids=4,  # its four DFT stages
)
DEBAYER_MHT = Kernel(
    "debayer_mht", "isp_debayer_mht",
    "raw_image_pipeline_tpu_torch/csrc/debayer_mht.cu",
    "raw_image_pipeline_tpu/ops/debayer_pallas.py:229",
)
REMAP_FLOAT = Kernel(
    "remap_float", "isp_remap_float",
    "raw_image_pipeline_tpu_torch/csrc/remap_float.cu",
    "raw_image_pipeline_tpu/ops/remap_blend_pallas.py:42",
)
ALL = (DEBAYER_BILINEAR, CCC_HISTOGRAM, CCC_RESPONSE, DEBAYER_MHT, REMAP_FLOAT)


def reset_launch_counts() -> None:
    for k in ALL:
        k.launches = 0


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the int ctypes passes."""
    return torch.cuda.current_stream(t.device).cuda_stream


MAX_BATCH = 65535  # the kernels put the frame index in a grid's y or z


def check_batch(n: int, name: str) -> None:
    if n > MAX_BATCH:
        raise ValueError(f"{name}: batch {n} exceeds {MAX_BATCH} frames per launch")


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
