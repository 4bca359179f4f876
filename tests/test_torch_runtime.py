"""The port's copies of the JAX package's host runtime modules
(runtime/sources.py, control.py, native.py) against their originals: the
source of each copy equals its original's apart from docstrings, and every
case of the JAX package's tests/test_sources.py (but those that run
tools/run_pipeline.py), test_control.py (the same) and test_native.py runs
on both, on the same inputs. Every socket, thread and watch wait has a
timeout of its own."""

import ast
import os
import socket
import threading
import time

import numpy as np
import pytest

import raw_image_pipeline_tpu.runtime.control as jax_control
import raw_image_pipeline_tpu.runtime.native as jax_native
import raw_image_pipeline_tpu.runtime.sources as jax_sources
import raw_image_pipeline_tpu_torch.runtime.control as port_control
import raw_image_pipeline_tpu_torch.runtime.native as port_native
import raw_image_pipeline_tpu_torch.runtime.sources as port_sources

MODULES = {"sources": (port_sources, jax_sources), "control": (port_control, jax_control),
           "native": (port_native, jax_native)}
IMPLS = ("port", "reference")
WAIT_S = 10.0  # the longest any wait of these tests may take


def _mod(name, impl):
    return MODULES[name][IMPLS.index(impl)]


def _within(fn, seconds=WAIT_S):
    """fn() on a daemon thread; its result, or a failure if it has not
    returned within `seconds` (a hung source cannot hang the run)."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # handed to the test's thread below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no result within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _without_docstrings(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_copy_equals_original(name):
    port, ref = MODULES[name]
    assert _without_docstrings(port.__file__) == _without_docstrings(ref.__file__)
    # native.py resolves the repository's native/ from either package
    if name == "native":
        assert port._NATIVE_DIR == ref._NATIVE_DIR


# --- sources (tests/test_sources.py) ----------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_latest_frame_source_drops_to_newest(impl):
    src = _mod("sources", impl).LatestFrameSource()
    out = []

    def consume():
        for f in src:
            out.append(int(f[0, 0]))
            time.sleep(0.03)  # slow consumer

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for i in range(20):
        src.put(np.full((2, 2), i, np.uint8))
        time.sleep(0.005)  # fast producer
    time.sleep(0.1)
    src.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert out[-1] == 19  # newest always processed
    assert len(out) < 20  # intermediate frames dropped
    assert src.dropped == 20 - len(out)
    assert out == sorted(out)  # monotone


def _watch(impl, d, latest_only, stop_flag, poll_s=0.002):
    deadline = time.time() + WAIT_S  # the watch stops by itself past this
    return _mod("sources", impl).DirectoryWatchSource(
        d, loader=lambda p: np.fromfile(p, np.uint8), latest_only=latest_only, poll_s=poll_s,
        stop=lambda: stop_flag["stop"] or time.time() > deadline)


@pytest.mark.parametrize("impl", IMPLS)
def test_directory_watch_source_latest_only(impl, tmp_path):
    d = str(tmp_path)
    stop_flag = {"stop": False}
    src = _watch(impl, d, True, stop_flag)
    for i in range(5):
        np.full(4, i, np.uint8).tofile(os.path.join(d, f"f_{i:03d}.raw"))
    it = iter(src)
    first = next(it)
    assert first[0] == 4  # skipped straight to the newest
    assert src.dropped == 4
    np.full(4, 9, np.uint8).tofile(os.path.join(d, "f_009.raw"))
    second = next(it)
    assert second[0] == 9
    stop_flag["stop"] = True
    assert list(it) == []


@pytest.mark.parametrize("impl", IMPLS)
def test_directory_watch_source_ordered(impl, tmp_path):
    d = str(tmp_path)
    for i in range(4):
        np.full(2, i, np.uint8).tofile(os.path.join(d, f"g_{i:03d}.raw"))
    src = _watch(impl, d, False, {"stop": True})
    vals = [int(f[0]) for f in src]
    assert vals == [0, 1, 2, 3]


@pytest.mark.parametrize("impl", IMPLS)
def test_directory_watch_source_non_monotone_names(impl, tmp_path):
    """frame_9 then frame_10: lexicographically decreasing names must not
    be dropped (per-file seen tracking, not a high-water mark)."""
    d = str(tmp_path)
    stop = {"stop": False}
    src = _watch(impl, d, False, stop)
    np.full(2, 9, np.uint8).tofile(os.path.join(d, "frame_9.raw"))
    it = iter(src)
    assert int(next(it)[0]) == 9
    np.full(2, 10, np.uint8).tofile(os.path.join(d, "frame_10.raw"))
    assert int(next(it)[0]) == 10
    stop["stop"] = True
    assert list(it) == []


@pytest.mark.parametrize("impl", IMPLS)
def test_socket_frame_source_roundtrip(impl):
    """Frames stream over TCP in the wire format and arrive intact; slow
    consumption drops to the newest like the reference's queue-size-1
    subscription."""
    mod = _mod("sources", impl)
    src = mod.SocketFrameSource()
    host, port = src.address
    frames = [(np.arange(12, dtype=np.uint8).reshape(3, 4) + i) for i in range(5)]
    took_first = threading.Event()

    def produce():
        with socket.create_connection((host, port), timeout=WAIT_S) as s:
            mod.send_frame(s, frames[0])
            assert took_first.wait(WAIT_S)
            for f in frames[1:]:
                mod.send_frame(s, f)  # burst: all but the last may be dropped
        src.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        it = iter(src)
        first = _within(lambda: next(it))
        took_first.set()
        rest = _within(lambda: list(it))
    finally:
        took_first.set()
        t.join(timeout=WAIT_S)
        src.close()
    assert not t.is_alive()
    got = [first] + rest
    assert len(got) >= 2
    np.testing.assert_array_equal(got[0], frames[0])
    np.testing.assert_array_equal(got[-1], frames[-1])
    assert got[-1].dtype == np.uint8 and got[-1].shape == (3, 4)


@pytest.mark.parametrize("impl", IMPLS)
def test_socket_frame_source_u16_and_reconnect(impl):
    mod = _mod("sources", impl)
    src = mod.SocketFrameSource()
    host, port = src.address
    a = np.arange(6, dtype=np.uint16).reshape(2, 3) * 300
    took_first = threading.Event()

    def produce():
        with socket.create_connection((host, port), timeout=WAIT_S) as s:
            mod.send_frame(s, a)
        assert took_first.wait(WAIT_S)  # don't overwrite before the consumer
        with socket.create_connection((host, port), timeout=WAIT_S) as s:
            mod.send_frame(s, a + 1)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        it = iter(src)
        first = _within(lambda: next(it))
        took_first.set()
        second = _within(lambda: next(it))  # the reconnected producer's frame
    finally:
        took_first.set()
        t.join(timeout=WAIT_S)
        src.close()
    assert not t.is_alive()
    assert _within(lambda: list(it)) == []
    np.testing.assert_array_equal(first, a)
    np.testing.assert_array_equal(second, a + 1)


@pytest.mark.parametrize("impl", IMPLS)
def test_socket_source_close_unblocks_active_producer(impl):
    """close() shuts down the active producer connection, so that the serve
    thread blocked in recv() exits and iteration terminates."""
    mod = _mod("sources", impl)
    src = mod.SocketFrameSource()
    prod = socket.create_connection(src.address, timeout=5)
    try:
        mod.send_frame(prod, np.full((2, 3), 7, np.uint8))
        deadline = time.time() + 5
        while src._conn is None and time.time() < deadline:
            time.sleep(0.01)
        assert src._conn is not None
        t0 = time.time()
        src.close()  # must not hang on the join
        assert time.time() - t0 < 4.0
        assert not src._thread.is_alive()
        got = _within(lambda: list(src))  # frames already received drain first
        assert len(got) <= 1
    finally:
        prod.close()


# --- control (tests/test_control.py) ----------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_control_server_dispatch(impl):
    mod = _mod("control", impl)
    calls = []
    srv = mod.ControlServer({
        "reset_white_balance": lambda: calls.append("reset"),
        "reload_params": lambda *a: calls.append(("reload",) + a) or "params reloaded",
        "boom": lambda: (_ for _ in ()).throw(RuntimeError("kaput")),
    })
    try:
        assert mod.send_command(srv.address, "reset_white_balance") == "ok"
        assert mod.send_command(srv.address, "reload_params /tmp/x.yaml") == \
            "ok params reloaded"
        assert mod.send_command(srv.address, "boom") == "err kaput"
        reply = mod.send_command(srv.address, "nope")
        assert reply.startswith("err unknown command 'nope'")
        assert "reset_white_balance" in reply
        assert mod.send_command(srv.address, "   ") == "err empty command"
    finally:
        srv.close()
    assert calls == ["reset", ("reload", "/tmp/x.yaml")]


@pytest.mark.parametrize("impl", IMPLS)
def test_control_server_multiple_clients(impl):
    """A parked controller must not block another client's command."""
    mod = _mod("control", impl)
    srv = mod.ControlServer({"ping": lambda: "pong"})
    parked = socket.create_connection(srv.address, timeout=WAIT_S)  # sends nothing
    try:
        assert mod.send_command(srv.address, "ping", timeout=WAIT_S) == "ok pong"
    finally:
        parked.close()
        srv.close()
    assert not srv._thread.is_alive()


# --- native (tests/test_native.py) ------------------------------------------


def _native(impl):
    mod = _mod("native", impl)
    if not mod.native_available():
        pytest.skip("native toolchain unavailable")
    return mod


@pytest.fixture()
def raw_frames(tmp_path):
    rng = np.random.default_rng(0)
    paths, frames = [], []
    for i in range(11):
        f = rng.integers(0, 256, (16, 24), np.uint8)
        p = tmp_path / f"frame_{i:03d}.raw"
        p.write_bytes(f.tobytes())
        paths.append(str(p))
        frames.append(f)
    return paths, frames


@pytest.mark.parametrize("impl", IMPLS)
def test_frame_pump_batches_in_order(impl, raw_frames):
    paths, frames = raw_frames
    pump = _native(impl).FramePump(paths, (16, 24), batch=4, slots=2, readers=3)
    got = _within(lambda: list(pump))
    pump.close()
    assert [b.shape[0] for b in got] == [4, 4, 3]  # last batch is partial
    flat = np.concatenate(got)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(flat[i], f)


@pytest.mark.parametrize("impl", IMPLS)
def test_frame_pump_header_skip(impl, tmp_path):
    f = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = tmp_path / "x.pgm"
    p.write_bytes(b"P5\n4 3\n255\n" + f.tobytes())
    skip = len(b"P5\n4 3\n255\n")
    pump = _native(impl).FramePump([str(p)], (3, 4), batch=1, header_skip=skip, slots=2,
                                   readers=1)
    (batch,) = _within(lambda: list(pump))
    pump.close()
    np.testing.assert_array_equal(batch[0], f)


@pytest.mark.parametrize("impl", IMPLS)
def test_frame_pump_short_file_zero_filled(impl, tmp_path):
    p = tmp_path / "short.raw"
    p.write_bytes(b"\x07" * 5)
    pump = _native(impl).FramePump([str(p)], (4, 4), batch=1, slots=2, readers=1)
    (batch,) = _within(lambda: list(pump))
    pump.close()
    assert batch[0].ravel()[:5].tolist() == [7] * 5
    assert batch[0].ravel()[5:].sum() == 0


def _sink(impl):
    mod = _native(impl)
    if not mod.native_sink_available():
        pytest.skip("native sink build unavailable")
    return mod


@pytest.mark.parametrize("impl", IMPLS)
def test_frame_sink_roundtrip(impl, tmp_path):
    import cv2

    mod = _sink(impl)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (32, 48, 3), np.uint8) for _ in range(10)]
    mono = rng.integers(0, 256, (16, 24), np.uint8)
    with mod.FrameSink(threads=4, queue_cap=4) as sink:
        for i, im in enumerate(imgs):
            sink.write(str(tmp_path / f"f{i:03d}.png"), im)
        sink.write(str(tmp_path / "mono.png"), mono)
        sink.write(str(tmp_path / "blob.raw"), imgs[0])
        assert _within(sink.flush) == 0
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / f"f{i:03d}.png")), im)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "mono.png"), cv2.IMREAD_UNCHANGED),
                                  mono)
    raw = np.fromfile(tmp_path / "blob.raw", np.uint8).reshape(32, 48, 3)
    np.testing.assert_array_equal(raw, imgs[0])


@pytest.mark.parametrize("impl", IMPLS)
def test_frame_sink_failure_counted(impl):
    mod = _sink(impl)
    with mod.FrameSink(threads=2) as sink:
        sink.write("/nonexistent-dir/x.png", np.zeros((8, 8, 3), np.uint8))
        assert _within(sink.flush) == 1
