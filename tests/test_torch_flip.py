"""Kernel N, the flips (ops/flip.py): the port's row-range flip, plain, against
the JAX package's flip followed by the same row slice on the CPU, exactly,
over the four angles, u8, u16 and f32, one and three channels, odd and even
sizes, whole frames and slabs; the host's route rule; what the kernel's
wrapper refuses. The cuda-marked tests hold kernel N to its plain version on
the card (tools/card_tests.py runs them there)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw_image_pipeline_tpu.ops import flip as jflip
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops import flip as pflip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}
SIZES = [(7, 10), (24, 32), (31, 45)]


def frame(dtype, channels, hw, seed=0):
    """[2, h, w] (one channel: the chain's planes) or [2, h, w, 3] frames."""
    rng = np.random.default_rng(seed)
    shape = (2,) + tuple(hw) + ((3,) if channels == 3 else ())
    if dtype == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype, endpoint=True)


def slabs(n):
    """The whole flipped frame and two slabs of its n rows."""
    return [None, (0, n // 3), (n // 3, n - 1)]


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("angle", [0, 90, 180, 270])
def test_flip_rows_plain_equals_jax_flip_then_rows(angle, dtype, channels, hw):
    x = frame(DTYPES[dtype], channels, hw, seed=hw[0] * channels + angle)
    axes = (1, 2) if channels == 1 else (-3, -2)
    want = np.asarray(jflip.flip(jnp.asarray(x), angle, spatial_axes=axes))
    t = torch.as_tensor(x)
    assert pflip.flip(t, angle, axes).numpy().tobytes() == want.tobytes()
    for rows in slabs(want.shape[1]):
        ref = want if rows is None else want[:, rows[0]:rows[1]]
        for got in (pflip.flip_rows_plain(t, angle, rows, axes),
                    pflip.flip_rows((t, t), angle, rows, spatial_axes=axes)[1]):
            assert got.shape == ref.shape and got.dtype == t.dtype, (rows, got.shape)
            assert got.numpy().tobytes() == ref.tobytes(), rows


def test_flip_route_rule():
    # 1-byte pixels: 180 over 16-byte chunks where rows are whole chunks and
    # everything is 16-byte aligned; 90 / 270 over tiles on the output's
    # sectors where the input is 4-byte aligned, whatever the output's
    # alignment, with loads of 16 bytes where the input is 16-byte aligned,
    # else of 4; else words of what divides the pixel and both sides
    assert pflip.flip_route(1, 1920, 180, 16, 16) == (1, 1)
    assert pflip.flip_route(1, 1921, 180, 16, 16) == (0, 1)
    assert pflip.flip_route(1, 1920, 180, 16, 8) == (0, 1)
    assert pflip.flip_route(1, 1080, 90, 4, 8) == (2, 4)
    assert pflip.flip_route(1, 1080, 270, 16, 1) == (2, 16)
    # the wb_* chains' call: 1920-byte mosaic rows in, 1080-byte rows out
    # (every other row 8 bytes off a 16-byte boundary, out_align 8)
    assert pflip.flip_route(1, 1920, 90, 16, 8) == (2, 16)
    assert pflip.flip_route(1, 1920, 270, 16, 8) == (2, 16)
    assert pflip.flip_route(1, 1920, 90, 8, 8) == (2, 4)  # input 8-byte aligned
    assert pflip.flip_route(1, 1439, 90, 4, 16) == (2, 4)  # input aligned to 4
    assert pflip.flip_route(1, 1439, 270, 1, 16) == (0, 1)  # to 1: route 0, bytes
    assert pflip.flip_route(1, 1080, 90, 2, 16) == (0, 1)
    assert pflip.flip_route(3, 1920, 180, 16, 16) == (0, 1)
    assert pflip.flip_route(12, 45, 90, 16, 16) == (0, 4)
    assert pflip.flip_route(16, 45, 180, 16, 16) == (0, 16)
    assert pflip.flip_route(16, 45, 180, 16, 4) == (0, 4)
    assert pflip.flip_route(2, 45, 270, 16, 16) == (0, 2)
    assert pflip._alignment(1080, 1920 * 1080, 256) == 8
    assert pflip._alignment(1920, 0) == 16 and pflip._alignment(45) == 1


def test_flip_wrapper_refuses_what_kernel_n_does_not_take():
    x = torch.zeros((2, 5, 7), dtype=torch.uint8)
    with pytest.raises(ValueError, match="at most 16 bytes"):
        pflip.flip_cuda((torch.zeros((2, 5, 7, 3), dtype=torch.float64),), 90,
                        spatial_axes=(-3, -2))
    with pytest.raises(ValueError, match="at most 16 bytes"):
        pflip.flip_cuda((torch.zeros((2, 5, 7, 5), dtype=torch.float32),), 180,
                        spatial_axes=(1, 2))
    with pytest.raises(ValueError, match="not adjacent"):
        pflip.flip_cuda((x,), 90, spatial_axes=(0, 2))
    with pytest.raises(ValueError, match="not adjacent"):
        pflip.flip_cuda((x,), 90, spatial_axes=(2, 1))
    with pytest.raises(ValueError, match="one shape, dtype and device"):
        pflip.flip_cuda((x, x.to(torch.int16)), 180)
    with pytest.raises(ValueError, match="1 to 3 tensors"):
        pflip.flip_cuda((x,) * 4, 180)
    with pytest.raises(ValueError, match="strided"):
        pflip.flip_cuda((torch.zeros((2, 5, 7)).to_sparse(),), 180)
    with pytest.raises(ValueError, match="out of range"):
        pflip.flip_cuda((x,), 180, spatial_axes=(3, 4))
    with pytest.raises(ValueError, match="rows"):
        pflip.flip_cuda((x,), 90, (0, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pflip.flip_cuda((x,), 90)
    # what it takes: a view whose pixels are not contiguous is copied first,
    # planes of unequal strides are made contiguous together, views of one
    # set of strides stay views; leading axes fold into one frame axis
    x = torch.zeros((2, 3, 5, 7), dtype=torch.uint8).transpose(2, 3)
    v, layout, lead, trail, elem = pflip._pixel_views((x,), (1, 2))
    assert v[0].is_contiguous() and layout == (2, 3, 7, 5, 105, 35)
    assert tuple(lead) == (2,) and tuple(trail) == (5,) and elem == 5
    planes = torch.zeros((2, 3, 5, 7), dtype=torch.uint8)
    v, layout, _, trail, elem = pflip._pixel_views((planes[:, 0], planes[:, 1].contiguous()),
                                                   (1, 2))
    assert all(p.is_contiguous() for p in v) and elem == 1 and tuple(trail) == ()
    assert layout == (2, 5, 7, 1, 35, 7)
    v, layout, _, _, _ = pflip._pixel_views((planes[:, 0], planes[:, 2]), (1, 2))
    assert v[0].data_ptr() == planes.data_ptr() and layout == (2, 5, 7, 1, 105, 7)
    frames = torch.zeros((2, 3, 5, 7, 3), dtype=torch.float32)
    _, layout, lead, _, elem = pflip._pixel_views((frames,), (-3, -2))
    assert layout == (6, 5, 7, 3, 105, 21) and tuple(lead) == (2, 3) and elem == 12
    v, layout, _, _, _ = pflip._pixel_views((frames[:, 1:],), (-3, -2))
    assert layout == (4, 5, 7, 3, 105, 21)  # [2, 2] frames 315 and 105 apart: copied
    assert v[0].data_ptr() != frames[:, 1:].data_ptr()


def test_kernel_n_is_registered():
    k = kernels.FLIP
    assert k in kernels.ALL and len(kernels._SIGNATURES[k.entry]) == 20
    assert "flip.cu" in kernels.SOURCES and os.path.exists(os.path.join(REPO, k.source))
    path, rest = k.replaces.split(":")
    line, fn = rest.split(" ")
    with open(os.path.join(REPO, path)) as f:
        assert f.readlines()[int(line) - 1].startswith(f"def {fn}(")
    assert pflip.MAX_PIXEL_BYTES == 16


# --- kernel N on the card ------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _held(tensors, angle, rows, axes, **kw):
    before = kernels.FLIP.launches
    got = pflip.flip_cuda(tensors, angle, rows, spatial_axes=axes, **kw)
    launched = kernels.FLIP.launches - before
    for g, t in zip(got, tensors):
        want = pflip.flip_rows_plain(t, angle, rows, axes)
        assert g.shape == want.shape and g.dtype == want.dtype
        assert torch.equal(g.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8))
    return launched


@pytest.mark.cuda
@pytest.mark.parametrize("angle", [90, 180, 270])
def test_kernel_n_equals_plain_on_card(card, angle):
    g = torch.Generator(device=card)
    g.manual_seed(angle)
    for dtype, channels in ((torch.uint8, ()), (torch.uint8, (3,)), (torch.int16, ()),
                            (torch.int16, (3,)), (torch.float32, (3,)), (torch.float64, (2,)),
                            (torch.int32, (1,))):
        for hw in ((7, 10), (24, 32), (31, 45), (64, 128), (130, 67), (1, 1)):
            x = torch.randint(-100, 100, (3,) + hw + channels, generator=g, device=card)
            x = x.to(dtype)
            axes = (1, 2)
            n = hw[1] if angle in (90, 270) else hw[0]
            for rows in slabs(n) + [(n - 1, n)]:
                assert _held((x,), angle, rows, axes) == (rows is None or rows[1] > rows[0])
    # three planes of one set of strides in one launch; 1 byte off a 16-byte
    # boundary; a lowered batch limit
    planes = torch.randint(0, 256, (5, 3, 1080, 1920), dtype=torch.uint8, device=card)
    assert _held(tuple(planes[:, c] for c in range(3)), angle, None, (1, 2)) == 1
    assert _held(tuple(planes[:, c] for c in range(3)), angle, (100, 612), (1, 2)) == 1
    off = planes.reshape(-1)[1:1 + 5 * 1079 * 1919].view(5, 1079, 1919)
    assert _held((off,), angle, None, (1, 2)) == 1
    off4 = planes.reshape(-1)[4:4 + 5 * 1080 * 1920].view(5, 1080, 1920)  # 4-byte loads
    assert _held((off4,), angle, None, (1, 2)) == 1
    assert _held((off4,), angle, (36, 1000), (1, 2)) == 1
    assert _held((planes[:, 0],), angle, None, (1, 2), batch_limit=2) == 3
