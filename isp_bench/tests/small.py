"""A cell cut to a size the CPU runs in seconds, for the tests: the frame
and the calibration scaled alike (intrinsics by the same factors), the
pool and the warm-up shortened."""

import copy

from isp_bench import spec


def small_cell(workload: str, h: int = 48, w: int = 64, batch: int = 4,
               benchmark=None, root: str = spec.HERE) -> spec.Cell:
    cell = spec.load_cell(workload, benchmark, root)
    cfg = copy.deepcopy(cell.config)
    oh, ow = cfg["frame_hw"]
    cfg["frame_hw"] = [h, w]
    cal = cfg["pipeline"]["calibration"]
    k = list(cal["camera_matrix"])
    sx, sy = w / ow, h / oh
    k[0], k[2], k[4], k[5] = k[0] * sx, k[2] * sx, k[4] * sy, k[5] * sy
    cal.update(image_width=w, image_height=h, camera_matrix=k)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=batch, pool_batches=2, warmup_batches=2,
                        trace_frames=2 * batch, shift_px=4)
    return cell
