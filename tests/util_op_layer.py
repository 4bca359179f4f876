"""Shared inputs and comparisons of the op-layer tests
(tests/test_torch_op_layer*.py): seeded frames at the leading dims and
sizes every NHWC entry point is held at, and exact equality (0
mismatching bytes, or equal f32 bits)."""

import numpy as np
import torch

F32 = np.float32
LEADS = [(), (2,), (2, 3)]
LEAD_IDS = ["none", "2", "2x3"]
SIZES = [(45, 61), (48, 64)]
CASES = [(lead, hw) for lead in LEADS for hw in SIZES]
CASE_IDS = [f"{'x'.join(map(str, lead)) or 'none'}-{h}x{w}" for lead, (h, w) in CASES]


def to_np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def image(seed, lead, h, w, c=3):
    """Seeded frames with a colour cast per frame, smooth content plus noise,
    a few saturated and zero samples (the statistics' corner cases)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead)) if lead else 1
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        base = 40 + 180 * (0.5 + 0.5 * np.sin(6 * xx + rng.uniform(0, 6) + 4 * yy))
        img = base[..., None] * rng.uniform(0.5, 1.6, c) + rng.normal(0, 6, (h, w, c))
        img[rng.random((h, w)) < 0.01] = 255
        img[rng.random((h, w)) < 0.01, rng.integers(0, c)] = 0
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out).reshape(tuple(lead) + (h, w, c))


def assert_equal(got, want):
    """Same shape and dtype, 0 mismatching values (f32 compared as bits)."""
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        assert int((got != want).sum()) == 0
