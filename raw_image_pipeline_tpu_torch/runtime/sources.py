"""Frame sources for the streaming runtime (a verbatim copy of
raw_image_pipeline_tpu/runtime/sources.py, whose package imports jax;
tests/test_torch_runtime.py holds the copy to the original).

The reference node subscribes with queue size 1 — "We always process the
most updated frame" (raw_image_pipeline_ros.cpp:185-197): when processing
is slower than capture, intermediate frames are DROPPED and only the
newest is handled. These sources reproduce that live-ingest contract
without a ROS transport:

  * LatestFrameSource — wraps any producer thread; `put()` overwrites the
    single slot (the queue-size-1 drop), iteration yields the newest frame
    and blocks when none is pending;
  * DirectoryWatchSource — polls a directory for new frame files (the
    moral equivalent of a live topic for file-based pipelines), reading
    each new file at most once and skipping ahead to the newest when
    multiple arrived since the last poll.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np


class LatestFrameSource:
    """Single-slot mailbox with overwrite: the reference's queue-size-1
    subscription semantics. Producers call put(frame); the consumer
    iterates. close() ends the iteration once the slot is drained."""

    def __init__(self):
        self._cond = threading.Condition()
        self._slot: Optional[np.ndarray] = None
        self._dropped = 0
        self._closed = False

    @property
    def dropped(self) -> int:
        """Frames overwritten before the consumer took them."""
        return self._dropped

    def put(self, frame: np.ndarray) -> None:
        with self._cond:
            if self._slot is not None:
                self._dropped += 1  # overwritten, like ROS queue_size=1
            self._slot = np.asarray(frame)
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            with self._cond:
                while self._slot is None and not self._closed:
                    self._cond.wait()
                if self._slot is None and self._closed:
                    return
                frame, self._slot = self._slot, None
            yield frame


class DirectoryWatchSource:
    """Live file ingest: yields frames for files appearing in a directory.

    With latest_only=True (default) it skips to the newest (lexicographically
    largest) unseen file at each poll, dropping the others — the
    queue-size-1 behavior; with latest_only=False every new file is yielded
    in name order. Iteration ends when `stop` (a callable) returns True and
    no new file is pending.

    Producers should write frames ATOMICALLY (write to a temp name, then
    rename into the watched directory) — a file is loaded as soon as it is
    listed; `min_age_s` > 0 additionally ignores files modified within the
    last `min_age_s` seconds as a settle window for non-atomic writers.
    Frame names need not be monotone: every file is tracked individually
    (a `seen` set), so `frame_9` followed by `frame_10` works even though
    the names sort the other way.
    """

    def __init__(
        self,
        directory: str,
        loader: Callable[[str], np.ndarray],
        pattern: str = "",
        latest_only: bool = True,
        poll_s: float = 0.01,
        min_age_s: float = 0.0,
        stop: Optional[Callable[[], bool]] = None,
    ):
        self.directory = directory
        self.loader = loader
        self.pattern = pattern
        self.latest_only = latest_only
        self.poll_s = poll_s
        self.min_age_s = min_age_s
        self._stop = stop or (lambda: False)
        self.dropped = 0

    def _listing(self):
        names = sorted(
            f for f in os.listdir(self.directory)
            if self.pattern in f
        )
        if self.min_age_s > 0:
            cutoff = time.time() - self.min_age_s
            settled = []
            for f in names:
                try:
                    if os.path.getmtime(os.path.join(self.directory, f)) <= cutoff:
                        settled.append(f)
                except OSError:
                    pass  # vanished between listdir and stat
            names = settled
        return names

    def __iter__(self) -> Iterator[np.ndarray]:
        seen = set()
        while True:
            fresh = [f for f in self._listing() if f not in seen]
            if not fresh:
                if self._stop():
                    return
                time.sleep(self.poll_s)
                continue
            seen.update(fresh)
            if self.latest_only:
                self.dropped += len(fresh) - 1
                fresh = fresh[-1:]
            for f in fresh:
                yield self.loader(os.path.join(self.directory, f))


# ---------------------------------------------------------------------------
# Network ingest
# ---------------------------------------------------------------------------

_WIRE_MAGIC = b"RIP1"
_WIRE_DTYPES = {0: np.uint8, 1: np.uint16}
_WIRE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1}


def send_frame(sock, frame: np.ndarray) -> None:
    """Send one frame over a connected socket in the SocketFrameSource wire
    format: 4-byte magic, u8 dtype code, u8 ndim, ndim x u32 little-endian
    dims, then the C-contiguous payload."""
    frame = np.ascontiguousarray(frame)
    code = _WIRE_CODES[frame.dtype]
    header = (
        _WIRE_MAGIC
        + bytes([code, frame.ndim])
        + b"".join(int(d).to_bytes(4, "little") for d in frame.shape)
    )
    sock.sendall(header + frame.tobytes())


def _recv_exact(conn, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise EOFError
        buf += chunk
    return bytes(buf)


class SocketFrameSource:
    """Live TCP ingest with the reference node's queue-size-1 contract.

    The reference subscribes to an image transport and always processes the
    newest frame (raw_image_pipeline_ros.cpp:185-197); this is the
    transport-agnostic equivalent for a GPU host: a listening socket whose
    producer(s) stream length-prefixed frames (see send_frame), landing in
    a single overwrite slot (LatestFrameSource) — when the pipeline is
    slower than the producer, intermediate frames are dropped and `dropped`
    counts them.

    Iteration yields np arrays; it ends after close() once the slot drains.
    Multiple sequential producer connections are accepted (one at a time).
    close() is the owner-side shutdown: frames already received drain, but
    a connection still sitting in the TCP listen backlog (connected,
    never accepted) is dropped with it — the same drop-on-shutdown
    contract a ROS node's queue has.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import socket

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.address = self._srv.getsockname()  # (host, actual_port)
        self._mailbox = LatestFrameSource()
        self._closing = False
        self._conn = None  # active producer connection (for close())
        self._conn_lock = threading.Lock()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def dropped(self) -> int:
        return self._mailbox.dropped

    def _serve(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break  # listener closed
            with self._conn_lock:
                self._conn = conn
            with conn:
                try:
                    # drain to EOF even during close() (frames already
                    # received must reach the slot); a producer that keeps
                    # streaming past close() is cut off by the connection
                    # shutdown in close() after its grace period
                    while True:
                        head = _recv_exact(conn, 6)
                        if head[:4] != _WIRE_MAGIC:
                            break  # corrupt stream: drop this producer
                        dtype = _WIRE_DTYPES.get(head[4])
                        ndim = head[5]
                        if dtype is None or not 1 <= ndim <= 4:
                            break
                        dims = _recv_exact(conn, 4 * ndim)
                        shape = tuple(
                            int.from_bytes(dims[4 * i: 4 * i + 4], "little")
                            for i in range(ndim)
                        )
                        count = int(np.prod(shape))
                        payload = _recv_exact(conn, count * dtype().nbytes)
                        self._mailbox.put(
                            np.frombuffer(payload, dtype).reshape(shape)
                        )
                except (EOFError, OSError):
                    pass  # producer hung up (or close() shut the socket)
            with self._conn_lock:
                self._conn = None
        self._mailbox.close()

    def close(self) -> None:
        import socket as _socket
        import warnings

        self._closing = True
        # wake a serve thread parked in accept(): on Linux, closing the
        # listener fd does not reliably unblock accept, so connect-and-close
        # first (the serve loop sees _closing and exits immediately)
        try:
            with _socket.create_connection(self.address, timeout=1.0):
                pass
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        # grace period: an EOF already in flight drains on its own, keeping
        # the "frames already received drain" contract; a producer still
        # streaming (or idle) past it is cut off by the shutdown below
        self._thread.join(timeout=1.0)
        if self._thread.is_alive():
            # serve thread is parked in conn.recv() on an idle-but-connected
            # producer: shut the connection down under it
            with self._conn_lock:
                conn = self._conn
            if conn is not None:
                try:
                    conn.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            self._thread.join(timeout=4.0)
        if self._thread.is_alive():
            warnings.warn("SocketFrameSource serve thread did not exit in 5s")
        self._mailbox.close()

    def __iter__(self):
        return iter(self._mailbox)
