"""Runtime control channel for the live runner (a verbatim copy of
raw_image_pipeline_tpu/runtime/control.py, whose package imports jax;
tests/test_torch_runtime.py holds the copy to the original).

The reference node exposes runtime services while streaming — most
importantly ``~reset_white_balance``, which re-arms the CCC temporal
track (raw_image_pipeline_ros.cpp:290-295 advertising the service,
raw_image_pipeline.cpp resetWbTemporalConsistency). This is the
transport-agnostic equivalent for a GPU host: a TCP line protocol.

Protocol (utf-8, newline-terminated):

    client:  <command> [args...]\n
    server:  ok [detail]\n      on success
             err <message>\n    on failure / unknown command

Commands are dispatched to caller-supplied handlers; the stock live
runner (tools/run_pipeline.py --control) registers

    reset_white_balance     -> RawImagePipeline.reset_white_balance_temporal_consistency
    reload_params [path]    -> RawImagePipeline.load_params (dynamic-reconfigure analogue)

Handlers run on the control thread; the pipeline API's mutators are
single-attribute swaps (GIL-atomic), so they are safe to call while the
ingest loop is processing.
"""

from __future__ import annotations

import socket
import threading
import warnings
from typing import Callable, Dict, Optional, Sequence


class ControlServer:
    """Line-protocol TCP control endpoint.

    handlers maps a command name to a callable taking the remaining
    whitespace-split tokens (``lambda *args: ...``); its return value, if
    not None, is appended to the ``ok`` reply. Exceptions become
    ``err <msg>`` replies — they never kill the server thread.
    """

    def __init__(
        self,
        handlers: Dict[str, Callable[..., Optional[str]]],
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self._handlers = dict(handlers)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.address = self._srv.getsockname()
        self._closing = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _dispatch(self, line: str) -> str:
        tokens = line.split()
        if not tokens:
            return "err empty command"
        name, args = tokens[0], tokens[1:]
        handler = self._handlers.get(name)
        if handler is None:
            known = " ".join(sorted(self._handlers))
            return f"err unknown command {name!r} (known: {known})"
        try:
            detail = handler(*args)
        except Exception as e:  # handler errors surface to the client
            return f"err {e}"
        return "ok" if detail is None else f"ok {detail}"

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            buf = b""
            while True:
                try:
                    chunk = conn.recv(4096)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    reply = self._dispatch(line.decode("utf-8", "replace"))
                    try:
                        conn.sendall(reply.encode() + b"\n")
                    except OSError:
                        return

    def _serve(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break  # listener closed
            # one thread per client: a parked controller must not block
            # the next one from connecting
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def close(self) -> None:
        self._closing = True
        # wake the accept() (closing the listener fd alone does not
        # reliably unblock accept on Linux)
        try:
            with socket.create_connection(self.address, timeout=1.0):
                pass
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
        if self._thread.is_alive():
            warnings.warn("ControlServer accept thread did not exit in 2s")


def send_command(address: Sequence, command: str, timeout: float = 5.0) -> str:
    """Client helper: send one command line, return the reply line."""
    with socket.create_connection(tuple(address), timeout=timeout) as s:
        s.sendall(command.encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
    return buf.decode().rstrip("\n")
