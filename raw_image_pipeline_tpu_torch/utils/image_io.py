"""Image files for the port's tools: `imread` and `imwrite` with cv2's
meaning, and a pool of writer threads.

PNGs are always written by this module's encoder, so that the files are
the same with and without cv2. It filters every row Sub (one whole-image
subtraction) and codes the bytes with zlib's Huffman-only strategy at
level 1: of the five filters under four deflate settings,
tools/png_writer_bench.py found that the fastest on the card's host for
run_pipeline's frames of real content, with files no larger than Up with
run-length coding writes, and about as fast as cv2 (libpng choosing each
row's filter). Other extensions are written by cv2, where it imports.

Reading calls cv2 where it imports. Where it does not (the card's machine
may have no OpenCV), a PNG decoder built on zlib, struct and numpy reads
8- and 16-bit grey, RGB and RGBA files (held as grey, BGR and BGRA
arrays, as cv2 holds them), non-interlaced; anything else raises
ValueError. It undoes the five row filters. None, Sub and Up rows run row
by row as whole-row numpy operations. Average and Paeth depend on the pixel
to the left, so an image that has such rows is decoded as a wavefront: the
pixels with x + y = t depend only on those with x + y = t - 1 and t - 2,
so each of the W + H - 1 steps is one vector operation over the rows.
"""

from __future__ import annotations

import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

# cv2's flag values
IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels of an array -> colour type written
WRITE_FILTER = 1  # Sub, on every row written
WRITE_LEVEL = 1  # zlib level and strategy of every PNG written
WRITE_STRATEGY = zlib.Z_HUFFMAN_ONLY


def cv2_module():
    """cv2 where it imports as the real library, else None (a module
    without a file, such as a test harness's stand-in, counts as absent)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2 if getattr(cv2, "__file__", None) else None


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    i = 8
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        i += 12 + n
    raise ValueError("PNG without IEND")


def _unfilter_rows(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """None, Sub and Up rows, one row at a time: [H, row_bytes] u8."""
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for y in range(rows.shape[0]):
        f = ftype[y]
        if f == 0:
            out[y] = rows[y]
        elif f == 1:  # Sub: a running sum of each byte of the pixel
            out[y] = np.cumsum(rows[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            np.add(rows[y], prev, out=out[y])
        prev = out[y]
    return out


def _unfilter_wavefront(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Every filter type, the pixels of one anti-diagonal x + y = t at a
    time. The rows are skewed so that pixel (y, x) sits at column t = x + y:
    its left neighbour and the one above sit at column t - 1, the one above
    and to the left at t - 2. The decoded array `d` has a zero row above
    the image and two zero columns before it (d[y + 1, t + 2] is pixel
    (y, t - y)), so neighbours outside the image read 0."""
    h, rb = rows.shape
    w = rb // bpp
    f = rows.reshape(h, w, bpp).astype(np.int16)
    skew = np.zeros((h, w + h - 1, bpp), np.int16)
    for y in range(h):
        skew[y, y:y + w] = f[y]
    d = np.zeros((h + 1, w + h + 1, bpp), np.int16)
    ft = ftype.astype(np.int16)[:, None]
    is_sub, is_up, is_avg, is_paeth = (ft == k for k in (1, 2, 3, 4))
    for t in range(w + h - 1):
        y0, y1 = max(0, t - w + 1), min(h - 1, t) + 1
        a = d[y0 + 1:y1 + 1, t + 1]  # left
        b = d[y0:y1, t + 1]  # up
        c = d[y0:y1, t]  # up-left
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(is_paeth[y0:y1], paeth,
                        np.where(is_avg[y0:y1], (a + b) >> 1,
                                 np.where(is_up[y0:y1], b,
                                          np.where(is_sub[y0:y1], a, 0))))
        d[y0 + 1:y1 + 1, t + 2] = (skew[y0:y1, t] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = d[y + 1, y + 2:y + 2 + w]
    return out.reshape(h, rb)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG's pixels as stored: [H, W] grey, [H, W, 3] BGR or [H, W, 4]
    BGRA, uint8 or uint16."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or comp or filt or interlace:
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace} (8/16-bit grey, RGB, RGBA, non-interlaced "
                         f"only)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rb = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (rb + 1):
        raise ValueError("truncated PNG image data")
    buf = raw[:h * (rb + 1)].reshape(h, rb + 1)
    ftype, rows = buf[:, 0], buf[:, 1:]
    if ftype.size and ftype.max() > 4:
        raise ValueError(f"PNG row filter {ftype.max()} does not exist")
    if (ftype >= 3).any():
        px = _unfilter_wavefront(rows, ftype, bpp)
    else:
        px = _unfilter_rows(rows, ftype, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    img = px.reshape(h, w, ch)
    if ch >= 3:  # RGB(A) -> BGR(A)
        img = img[..., [2, 1, 0] + ([3] if ch == 4 else [])]
    return np.ascontiguousarray(img[..., 0] if ch == 1 else img)


def _as_flag(img: np.ndarray, flags: int) -> np.ndarray:
    """The stored pixels as cv2.imread(flags) returns them: UNCHANGED as
    stored; COLOR 8-bit BGR (16 bits cut to their high byte, alpha dropped,
    grey replicated); GRAYSCALE 8-bit grey, for grey files only."""
    if flags == IMREAD_UNCHANGED or flags < 0:
        return img
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if flags == IMREAD_GRAYSCALE:
        if img.ndim != 2:
            raise ValueError("imread: IMREAD_GRAYSCALE of a colour PNG needs cv2")
        return img
    if flags == IMREAD_COLOR:
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    raise ValueError(f"imread: flags {flags} not supported without cv2")


def imread(path: str, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """cv2.imread(path, flags): None where the file cannot be opened."""
    cv2 = cv2_module()
    if cv2 is not None:
        return cv2.imread(path, flags)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return _as_flag(decode_png(data), flags)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W] or [H, W, 1] grey, [H, W, 3] BGR or [H, W, 4] BGRA, uint8 or
    uint16 -> PNG bytes, every row Sub-filtered."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"imwrite: uint8 or uint16 images only, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"imwrite: [H, W], [H, W, 1], [H, W, 3] or [H, W, 4], got {img.shape}")
    h, w, ch = img.shape
    if not h or not w:
        raise ValueError(f"imwrite: empty image {img.shape}")
    if ch == 3:
        img = img[..., ::-1]  # BGR -> RGB
    elif ch == 4:
        img = img[..., [2, 1, 0, 3]]  # BGRA -> RGBA
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // w
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = WRITE_FILTER  # the bytes left of each row's first pixel are 0
    filtered[:, 1:bpp + 1] = rows[:, :bpp]
    np.subtract(rows[:, bpp:], rows[:, :-bpp], out=filtered[:, bpp + 1:])
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    z = zlib.compressobj(WRITE_LEVEL, zlib.DEFLATED, 15, 8, WRITE_STRATEGY)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", z.compress(filtered) + z.flush())
            + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> bool:
    """cv2.imwrite(path, img): a .png path by encode_png, any other by cv2
    (ValueError without it)."""
    if not path.lower().endswith(".png"):
        cv2 = cv2_module()
        if cv2 is None:
            raise ValueError(f"imwrite: only PNG files can be written without cv2: {path}")
        return bool(cv2.imwrite(path, img))
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
    return True


class WriterPool:
    """Image writes on worker threads behind a bounded queue: zlib and
    numpy's whole-image operations release the GIL while they encode.

    write(path, img) copies the array and returns once a slot is free;
    flush() waits for every queued write and returns how many failed;
    close() flushes and stops the threads."""

    def __init__(self, threads: int = 4, queue_cap: int = 16):
        self._pool = ThreadPoolExecutor(max_workers=threads,
                                        thread_name_prefix="image_io_writer")
        self._slots = threading.BoundedSemaphore(queue_cap)
        self._pending = []
        self._lock = threading.Lock()

    def _write(self, path: str, img: np.ndarray) -> None:
        try:
            if not imwrite(path, img):
                raise OSError(f"could not write {path}")
        finally:
            self._slots.release()

    def write(self, path: str, img: np.ndarray) -> None:
        img = np.array(img, copy=True)
        self._slots.acquire()
        fut = self._pool.submit(self._write, path, img)
        with self._lock:
            self._pending.append(fut)

    def flush(self) -> int:
        with self._lock:
            pending, self._pending = self._pending, []
        return sum(1 for f in pending if f.exception() is not None)

    def close(self) -> None:
        self.flush()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
