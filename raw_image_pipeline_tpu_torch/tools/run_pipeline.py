"""Batch/stream CLI — the production entry point replacing the reference
ROS node (raw_image_pipeline_ros); the port of
raw_image_pipeline_tpu/tools/run_pipeline.py, every flag kept, plus
`--device`. It reads frames from a directory (or, with --listen, a TCP
socket), processes them through the ISP on the card in batches, and writes
the output streams as PNGs plus a camera_info YAML sidecar with the
dist/rect calibrations.

`--device` (default cuda) places both the StreamRunner of directory mode
and the RawImagePipeline of live mode; "cpu" runs the plain versions, and
without a card "cuda" raises. Images are read and written through
utils/image_io, so the tool runs where cv2 is not installed. The outputs
are encoded on image_io.WriterPool's threads by image_io's PNG encoder,
with or without OpenCV (the JAX tool writes through the native FrameSink,
that is OpenCV's encoder; the two are about as fast: PERF.md). The JAX
tool's persistent compilation cache has no counterpart: the port compiles
nothing per call, and its kernels are built once into build/kernels/.

Example:
    python -m raw_image_pipeline_tpu_torch.tools.run_pipeline \
        -i frames/ -o out/ -e bayer_gbrg8 \
        -p configs/pipeline_params_example.yaml \
        -c configs/alphasense_calib_example.yaml --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import socket
import threading
import time

import numpy as np
import yaml

from raw_image_pipeline_tpu_torch import RawImagePipeline
from raw_image_pipeline_tpu_torch.config import (
    DEFAULT_CALIBRATION_PATH,
    DEFAULT_COLOR_CALIBRATION_PATH,
    DEFAULT_PARAMS_PATH,
    load_camera_calibration,
    load_color_calibration,
    load_pipeline_params,
)
from raw_image_pipeline_tpu_torch.runtime.stream import StreamRunner, make_camera_infos
from raw_image_pipeline_tpu_torch.utils import image_io


def pipeline_config(params: str, calibration: str, color_calibration: str,
                    interpolation=None):
    """The configuration directory mode runs: the three YAML files, and the
    remap arithmetic where `interpolation` is given."""
    config = load_pipeline_params(params)
    config = config.replace(
        calibration=load_camera_calibration(calibration),
        color_calibration=load_color_calibration(color_calibration, config.color_calibration),
    )
    if interpolation:
        config = config.replace(undistortion=dataclasses.replace(
            config.undistortion, interpolation=interpolation))
    return config


def main(argv=None, *, on_listen=None):
    """The tool; with --listen, `on_listen(source, control server or None)`
    is called once both listen, before the first frame is read."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input-dir",
                    help="directory of frames (required unless --listen)")
    ap.add_argument("-o", "--output-dir", required=True)
    ap.add_argument("-e", "--encoding", default="bayer_gbrg8",
                    help="input encoding (the ROS input topic encoding)")
    ap.add_argument("-p", "--params", default=DEFAULT_PARAMS_PATH)
    ap.add_argument("-c", "--calibration", default=DEFAULT_CALIBRATION_PATH)
    ap.add_argument("-cc", "--color-calibration", default=DEFAULT_COLOR_CALIBRATION_PATH)
    ap.add_argument("-b", "--batch", type=int, default=8)
    ap.add_argument("--output-encoding", default="BGR", choices=["BGR", "RGB"])
    ap.add_argument("--skip-slow", type=int, default=0,
                    help="emit a color/slow stream every N frames (ROS /slow topics)")
    ap.add_argument("--output-frame", default="passthrough",
                    help="frame_id recorded in camera_info.yaml "
                         "(ROS output_frame; 'passthrough' keeps the source)")
    ap.add_argument("--raw-shape", default=None,
                    help="treat *.raw inputs as headerless HxW (e.g. 540x720) "
                         "8-bit frames, streamed by the native C++ frame pump")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="live mode: ingest frames over TCP "
                         "(runtime.sources.SocketFrameSource wire format; "
                         "queue-size-1 drop-to-newest like the reference "
                         "node's subscription) instead of reading files; "
                         "requires --raw-shape for the frame geometry")
    ap.add_argument("--remap-interpolation", default=None,
                    choices=["lerp", "fixed32", "float"],
                    help="which OpenCV-build remap arithmetic to replicate "
                         "(default from config: lerp = x86/IPP; fixed32 = "
                         "ARM/Jetson — the reference's deployment; see "
                         "ops/undistortion.remap_precompute)")
    ap.add_argument("--control", default=None, metavar="HOST:PORT",
                    help="with --listen: TCP line-protocol control channel "
                         "(runtime.control.ControlServer) exposing the "
                         "reference node's runtime services — "
                         "reset_white_balance (~reset_white_balance) and "
                         "reload_params [path] (dynamic reconfigure)")
    ap.add_argument("--device", default="cuda",
                    help="where the chain runs: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.listen:
        return _run_live(args, on_listen)
    if not args.input_dir:
        raise SystemExit("--input-dir is required unless --listen is given")

    raw_mode = args.raw_shape is not None
    exts = ("raw",) if raw_mode else ("png", "jpg", "jpeg", "tiff")
    paths = sorted(
        p for ext in exts
        for p in glob.glob(os.path.join(args.input_dir, f"*.{ext}"))
    )
    if not paths:
        raise SystemExit(f"no frames found in {args.input_dir}")

    api = RawImagePipeline(False, args.params, args.calibration, args.color_calibration,
                           device=args.device)
    if args.remap_interpolation:
        api.set_undistortion_interpolation(args.remap_interpolation)
    if raw_mode:
        h, w = (int(x) for x in args.raw_shape.lower().split("x"))
        first = np.zeros((h, w), np.uint8)
    else:
        first = image_io.imread(paths[0], image_io.IMREAD_UNCHANGED)

    config = pipeline_config(args.params, args.calibration, args.color_calibration,
                             args.remap_interpolation)
    runner = StreamRunner(
        config, args.encoding, first.shape[:2], batch_size=args.batch,
        output_encoding=args.output_encoding, slow_skip=args.skip_slow,
        device=args.device,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    infos = make_camera_infos(api, output_frame=args.output_frame)
    with open(os.path.join(args.output_dir, "camera_info.yaml"), "w") as f:
        yaml.safe_dump({k: v.to_dict() for k, v in infos.items()}, f)

    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]

    # PNG encoding is CPU-bound: the pool encodes on worker threads and
    # backpressures through a bounded queue
    threads = min(8, os.cpu_count() or 1)
    pool = image_io.WriterPool(threads=threads)
    writer = f"image_io.WriterPool, {threads} threads"
    made_dirs = set()

    def sink(stream, idx, img):
        d = os.path.join(args.output_dir, stream.replace("/", "_"))
        if d not in made_dirs:
            os.makedirs(d, exist_ok=True)
            made_dirs.add(d)
        pool.write(os.path.join(d, names[idx] + ".png"), img)

    def frames():
        if raw_mode:
            # native C++ threaded reader overlapping IO with compute
            from raw_image_pipeline_tpu_torch.runtime.native import (
                FramePump,
                native_available,
            )

            if native_available():
                pump = FramePump(paths, first.shape, batch=args.batch)
                for batch in pump:
                    yield from batch
                return
            for p in paths:
                yield np.fromfile(p, np.uint8, count=first.size).reshape(first.shape)
        else:
            for p in paths:
                yield image_io.imread(p, image_io.IMREAD_UNCHANGED)

    failures = 0
    t0 = time.perf_counter()
    try:
        n = runner.run(frames(), sink)
    finally:
        # flush/close even when the run or a sink raised: queued frames are
        # written (not abandoned) and encode failures surface
        failures = pool.flush()
        pool.close()
    seconds = time.perf_counter() - t0
    if failures:
        raise SystemExit(f"{failures} output writes failed")
    print(f"processed {n} frames -> {args.output_dir} in {seconds:.3f} s "
          f"({n / seconds:.2f} frames/s, the writes included; writer: {writer})")
    return n


def _run_live(args, on_listen=None):
    """--listen mode: one frame per dispatch from a live TCP source (the
    reference node's operating mode — process the newest frame, drop the
    rest), writing numbered outputs until the source is closed (producer
    side) or Ctrl-C."""
    from raw_image_pipeline_tpu_torch.runtime.sources import SocketFrameSource

    if args.raw_shape is None:
        raise SystemExit("--listen requires --raw-shape HxW")
    h, w = (int(x) for x in args.raw_shape.lower().split("x"))

    api = RawImagePipeline(False, args.params, args.calibration,
                           args.color_calibration, device=args.device)
    if args.remap_interpolation:
        api.set_undistortion_interpolation(args.remap_interpolation)
    os.makedirs(args.output_dir, exist_ok=True)
    infos = make_camera_infos(api, output_frame=args.output_frame)
    with open(os.path.join(args.output_dir, "camera_info.yaml"), "w") as f:
        yaml.safe_dump({k: v.to_dict() for k, v in infos.items()}, f)

    host, _, port = args.listen.partition(":")
    src = SocketFrameSource(host or "127.0.0.1", int(port or 0))
    print(f"listening on {src.address[0]}:{src.address[1]}", flush=True)

    ctrl = None
    if args.control:
        from raw_image_pipeline_tpu_torch.runtime.control import ControlServer

        def _reload(path=None):
            api.load_params(path or args.params)
            return "params reloaded"

        chost, _, cport = args.control.partition(":")
        ctrl = ControlServer(
            {
                "reset_white_balance":
                    api.reset_white_balance_temporal_consistency,
                "reload_params": _reload,
            },
            chost or "127.0.0.1", int(cport or 0),
        )
        print(f"control on {ctrl.address[0]}:{ctrl.address[1]}", flush=True)
    if on_listen is not None:
        on_listen(src, ctrl)

    n = 0
    try:
        for frame in src:
            if frame.shape[:2] != (h, w):
                print(f"skipping frame with shape {frame.shape} != {h}x{w}")
                continue
            out = api.process(frame, args.encoding)
            if args.output_encoding == "RGB" and out.ndim == 3:
                out = out[..., ::-1]
            image_io.imwrite(os.path.join(args.output_dir, f"{n:06d}.png"), out)
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        if ctrl is not None:
            ctrl.close()
        src.close()
    print(f"processed {n} live frames ({src.dropped} dropped) "
          f"-> {args.output_dir}")
    return n


def drive_live(frames, out_dir, argv, commands=(), command_frame=1, timeout=60.0):
    """Run live mode (`argv` plus --listen, -o out_dir, and --control when
    there are `commands`) fed over its socket by a producer that sends frame
    k + 1 only once output k exists (live mode keeps the newest frame only,
    so output k is frame k's) and sends `commands` on the control channel
    before frame `command_frame`; it closes the source after the last
    output. Returns (frames processed, the control channel's replies)."""
    from raw_image_pipeline_tpu_torch.runtime.control import send_command
    from raw_image_pipeline_tpu_torch.runtime.sources import send_frame

    servers, replies, errors = [], [], []
    listening = threading.Event()

    def on_listen(src, ctrl):
        servers.extend((src, ctrl))
        listening.set()

    def wait_for(cond, what):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise TimeoutError(f"live mode: no {what} within {timeout} s")
            time.sleep(0.01)

    def produce():
        try:
            wait_for(listening.is_set, "listening socket")
            src, ctrl = servers
            with socket.create_connection(src.address, timeout=timeout) as s:
                for k, f in enumerate(frames):
                    if k == command_frame:
                        replies.extend(send_command(ctrl.address, c) for c in commands)
                    send_frame(s, f)
                    path = os.path.join(out_dir, f"{k:06d}.png")
                    wait_for(lambda: os.path.exists(path), f"output {k}")
        except BaseException as e:  # raised in the caller's thread below
            errors.append(e)
        finally:
            if servers:
                servers[0].close()  # ends the tool's loop

    argv = list(argv) + ["--listen", "127.0.0.1:0", "-o", out_dir]
    if commands:
        argv += ["--control", "127.0.0.1:0"]
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        n = main(argv, on_listen=on_listen)
    finally:
        listening.set()  # a tool that failed before listening frees the producer
        producer.join(timeout)
    if errors:
        raise errors[0]
    return n, replies


if __name__ == "__main__":
    main()
