"""Streaming runner — the role the ROS node plays in the reference
(raw_image_pipeline_ros.cpp:219-368); the PyTorch port of
raw_image_pipeline_tpu/runtime/stream.py.

Frames are drained from a source in batches, processed by the pipeline on
its device, and handed to a sink together with the camera_info-equivalent
calibration metadata. Cross-frame CCC state is carried explicitly.

Publishes the same three streams as the reference node:
  * "color"     — the processed image before undistortion (the reference's
    <output>/color topic publishes the pre-undistort snapshot when
    undistortion is on — quirk §8.7 — replicated);
  * "color_rect" — the rectified image (when undistortion runs);
  * "debayered" — the post-flip debayer snapshot (when input is Bayer).
A `slow_skip` count gates a decimated variant of each stream, mirroring the
reference's /slow topics (raw_image_pipeline_ros.cpp:337-360).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.config import PipelineConfig
from raw_image_pipeline_tpu_torch.ops.common import resolve_device
from raw_image_pipeline_tpu_torch.parallel.mesh import shard_batch
from raw_image_pipeline_tpu_torch.pipeline import BuiltPipeline, build_pipeline, init_state


@dataclasses.dataclass
class CameraInfo:
    """camera_info-equivalent metadata (raw_image_pipeline_ros.cpp:297-336).

    frame_id mirrors the node's `output_frame` option: "passthrough" keeps
    the source frame id (raw_image_pipeline_ros.cpp:307-311)."""

    width: int
    height: int
    distortion_model: str
    D: List[float]
    K: List[float]
    R: List[float]
    P: List[float]
    frame_id: str = "passthrough"

    def to_dict(self):
        return dataclasses.asdict(self)


def make_camera_infos(api_pipeline, output_frame: str = "passthrough") -> Dict[str, CameraInfo]:
    """Build dist and rect CameraInfo from a RawImagePipeline, fixing the
    model string to plumb_bob when "none" like the reference
    (raw_image_pipeline_ros.cpp:318-320)."""

    def fix(model):
        return "plumb_bob" if model == "none" else model

    def fl(a):
        return [float(x) for x in np.asarray(a).ravel()]

    dist = CameraInfo(
        width=api_pipeline.get_dist_image_width(),
        height=api_pipeline.get_dist_image_height(),
        distortion_model=fix(api_pipeline.get_dist_distortion_model()),
        D=fl(api_pipeline.get_dist_distortion_coefficients()),
        K=fl(api_pipeline.get_dist_camera_matrix()),
        R=fl(api_pipeline.get_dist_rectification_matrix()),
        P=fl(api_pipeline.get_dist_projection_matrix()),
        frame_id=output_frame,
    )
    rect = CameraInfo(
        width=api_pipeline.get_rect_image_width(),
        height=api_pipeline.get_rect_image_height(),
        distortion_model=fix(api_pipeline.get_rect_distortion_model()),
        D=fl(api_pipeline.get_rect_distortion_coefficients()),
        K=fl(api_pipeline.get_rect_camera_matrix()),
        R=fl(api_pipeline.get_rect_rectification_matrix()),
        P=fl(api_pipeline.get_rect_projection_matrix()),
        frame_id=output_frame,
    )
    return {"dist": dist, "rect": rect}


class StreamRunner:
    """Batched streaming executor with carried CCC state, on `device`
    ("cuda", the default, runs the hand-written kernels; "cpu" the plain
    versions). mesh (parallel.mesh.make_mesh): each batch is split over
    the mesh (frames over "data", rows over "space"), run there, and
    gathered on the mesh's first device for the sink, in order; `device`
    is then not used. A mesh over several processes (every process runs
    the runner on the same frames) needs batch_size, and a stateful run's
    tail, to be multiples of the process count: ValueError otherwise."""

    def __init__(
        self,
        config: PipelineConfig,
        encoding: str,
        frame_hw,
        batch_size: int = 8,
        output_encoding: str = "BGR",
        slow_skip: int = 0,
        mesh=None,
        microbatch=None,
        *,
        device="cuda",
    ):
        self.config = config
        self.encoding = encoding
        self.batch_size = batch_size
        self.output_encoding = output_encoding
        self.slow_skip = slow_skip
        self.mesh = mesh
        self._processes = mesh.process_count if mesh is not None else 1
        if batch_size % self._processes:
            raise ValueError(f"batch_size {batch_size} does not split evenly over the mesh's "
                             f"{self._processes} processes")
        self.device = mesh.devices[0, 0] if mesh is not None else resolve_device(device)
        self._cards = sorted({d for d in (mesh.local_devices() if mesh is not None
                                          else [self.device]) if d.type == "cuda"}, key=str)
        wb = config.white_balance
        self.with_state = wb.enabled and wb.method == "ccc" and wb.temporal_consistency
        self.pipe: BuiltPipeline = build_pipeline(
            config, encoding, frame_hw=frame_hw,
            with_state=self.with_state, keep_intermediates=True,
            temporal_mode="sequence", device=self.device,
            # bound peak device memory for very large batch_size (see
            # build_pipeline)
            microbatch=microbatch, mesh=mesh,
        )
        # one shared illuminant track, like the reference's single camera
        # stream; batch entries advance it sequentially via scan semantics
        self.state = init_state((), device=self.device) if self.with_state else None
        self._slow_counter = 0

    def reset_white_balance(self):
        """The ~reset_white_balance service (raw_image_pipeline_ros.cpp:290-295)."""
        if self.with_state:
            self.state = init_state((), device=self.device)

    def run(
        self,
        frames: Iterable[np.ndarray],
        sink: Callable[[str, int, np.ndarray], None],
    ) -> int:
        """Drain `frames`, calling sink(stream_name, frame_index, image).
        Returns the number of frames processed.

        Execution is double-buffered: frames are gathered into a host
        staging slot (pinned memory on the card, two slots used in turn),
        copied to the device without blocking, and the batch's chain is
        dispatched, its outputs' copies back to the host queued behind it;
        only then are the previous batch's outputs waited for and handed
        to the sink. So reading the next frames, the copies in and out and
        the card's compute of consecutive batches overlap.
        """
        count = 0
        cuda = self.device.type == "cuda"
        # staging slots, [batch_size, *frame] each, and the event after the
        # last copy out of each (a slot is refilled only once it has run)
        slots: List[Optional[torch.Tensor]] = [None, None]
        copied: List[Optional[List[torch.cuda.Event]]] = [None, None]
        turn = 0  # the slot being filled
        n = 0  # frames in it
        # the dispatched batch: its frame count, its outputs on the host
        # (filled by copies that may still run) and the event recorded after
        # those copies (None on the CPU)
        in_flight = None

        def emit(size, host, done):
            nonlocal count
            if done is not None:
                done.synchronize()
            outputs = {k: v.numpy() for k, v in host.items()}
            for i in range(size):
                idx = count + i
                # reference publishes: color (pre-undistort snapshot when
                # rectifying, else the processed image), color_rect,
                # debayered (raw_image_pipeline_ros.cpp:240-288)
                color = outputs.get("dist_color", outputs["processed"])[i]
                sink("color", idx, self._encode(color))
                if self.config.undistortion.enabled:
                    sink("color_rect", idx, self._encode(outputs["processed"][i]))
                if "debayered" in outputs:
                    sink("debayered", idx, self._encode(outputs["debayered"][i]))
                if self.slow_skip > 0:
                    self._slow_counter += 1
                    if self._slow_counter > self.slow_skip:
                        self._slow_counter = 0
                        sink("color/slow", idx, self._encode(color))
            count += size

        def dispatch():
            nonlocal in_flight, turn, n
            slot, size = slots[turn], n
            if size < self.batch_size and not self.with_state:
                # pad the tail batch up to the batch size (copies of its
                # last frame, as the reference package does to reuse its
                # compiled program); emit() reads only the first `size`.
                # Stateful runs cannot pad — the Kalman scan would advance
                # the illuminant track over the pad frames — so their tail
                # runs at its own size.
                slot[size:] = slot[size - 1]
                size = self.batch_size
            if size % self._processes:
                raise ValueError(f"the stateful tail batch of {size} frames does not split "
                                 f"evenly over the mesh's {self._processes} processes; feed "
                                 f"a multiple of {self._processes} frames")
            if self.mesh is not None:
                dev = shard_batch(slot[:size] if cuda else slot[:size].clone(), self.mesh,
                                  spatial=self.mesh.shape["space"] > 1)
            elif cuda:
                dev = slot[:size].to(self.device, non_blocking=True)
            else:
                dev = slot[:size].clone()  # the slot is refilled while the sink holds outputs
            if cuda:
                # the copies out of the slot run on every card they go to
                copied[turn] = []
                for d in self._cards:
                    with torch.cuda.device(d):
                        copied[turn].append(torch.cuda.Event())
                        copied[turn][-1].record()
            outputs, state = self.pipe(dev, self.state if self.with_state else None)
            if self.mesh is not None:
                outputs = {k: v.gather(self.device) for k, v in outputs.items()}
            if self.with_state:
                self.state = state
            host = {}
            for k, v in outputs.items():
                if cuda:
                    # a pinned buffer of its own for every batch (PyTorch's
                    # caching host allocator reuses a buffer once nothing
                    # holds it): the sink may keep the arrays it is given,
                    # so no buffer is handed out twice
                    host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host[k].copy_(v, non_blocking=True)
                else:
                    host[k] = v
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            prev, in_flight = in_flight, (n, host, done)
            turn, n = 1 - turn, 0
            if prev is not None:
                emit(*prev)  # the previous batch, while this one computes

        for frame in frames:
            frame = np.asarray(frame)
            if n == 0:
                if slots[turn] is None:
                    dtype = torch.from_numpy(np.zeros(0, frame.dtype)).dtype
                    slots[turn] = torch.empty((self.batch_size,) + frame.shape, dtype=dtype,
                                              pin_memory=cuda)
                for event in copied[turn] or ():
                    event.synchronize()  # its last copies to the cards have run
            slots[turn].numpy()[n] = frame
            n += 1
            if n == self.batch_size:
                dispatch()
        if n:
            dispatch()
        if in_flight is not None:
            emit(*in_flight)
        return count

    def _encode(self, img: np.ndarray) -> np.ndarray:
        if self.output_encoding.upper() == "RGB" and img.ndim == 3 and img.shape[-1] == 3:
            return img[..., ::-1]
        return img
