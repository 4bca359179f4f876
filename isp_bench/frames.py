"""The benchmark's input frames, made on the device from the seed.

The Alphasense fixture (a 540x720 BGR frame of the reference project's
camera) is resized to the configuration's frame size plus a margin, and
every frame of the pool gets its own shift inside the margin, exposure
gain, illuminant cast on red and blue and Gaussian sensor noise, drawn
from the seed with the traffic file's ranges, then is mosaicked to the
configuration's 8-bit Bayer pattern. So no two frames are equal, and the
content is a camera's, so the CCC histogram sees real colour.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# the fixture's [540, 720, 3] BGR u8 pixels, under the key "bgr"
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "alphasense.npz")

# (row & 1, col & 1) of the B, G, G, R samples of each 8-bit Bayer pattern
# as the reference reads ROS encodings
_SITES = {
    "bayer_gbrg8": {"b": (0, 1), "r": (1, 0), "g": ((0, 0), (1, 1))},
    "bayer_grbg8": {"b": (1, 0), "r": (0, 1), "g": ((0, 0), (1, 1))},
    "bayer_bggr8": {"b": (0, 0), "r": (1, 1), "g": ((0, 1), (1, 0))},
    "bayer_rggb8": {"b": (1, 1), "r": (0, 0), "g": ((0, 1), (1, 0))},
}


def make_pool(traffic: dict, encoding: str, frame_hw, seed: int, device) -> torch.Tensor:
    """[pool_batches, batch, H, W] u8 Bayer mosaics, the same for the same
    seed and device."""
    if encoding not in _SITES:
        raise ValueError(f"frames: no mosaic for encoding [{encoding}]")
    h, w = frame_hw
    n_b, batch = traffic["pool_batches"], traffic["batch"]
    margin = traffic["shift_px"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fixture = torch.as_tensor(np.load(FIXTURE)["bgr"], device=device).permute(2, 0, 1)
    big = F.interpolate(fixture[None].float(), size=(h + margin, w + margin),
                        mode="bilinear", align_corners=False)[0]  # [3, H+m, W+m] BGR
    n = n_b * batch
    u = torch.rand((n, 5), generator=gen, device=device)
    dy = (u[:, 0] * (margin + 1)).long().clamp(max=margin)
    dx = (u[:, 1] * (margin + 1)).long().clamp(max=margin)
    lo, hi = traffic["exposure"]
    exposure = lo + (hi - lo) * u[:, 2]
    clo, chi = traffic["cast"]
    cast_b, cast_r = clo + (chi - clo) * u[:, 3], clo + (chi - clo) * u[:, 4]
    sites = _SITES[encoding]
    pool = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for i in range(n):
        frame = big[:, dy[i]:dy[i] + h, dx[i]:dx[i] + w]
        scale = exposure[i] * torch.stack([cast_b[i], torch.ones_like(cast_b[i]), cast_r[i]])
        noise = torch.randn((3, h, w), generator=gen, device=device) * traffic["noise_sigma"]
        frame = torch.clamp(torch.round(frame * scale[:, None, None] + noise), 0, 255)
        frame = frame.to(torch.uint8)
        m = pool[i]
        for plane, key in ((0, "b"), (2, "r")):
            y, x = sites[key]
            m[y::2, x::2] = frame[plane, y::2, x::2]
        for y, x in sites["g"]:
            m[y::2, x::2] = frame[1, y::2, x::2]
    return pool.view(n_b, batch, h, w)
