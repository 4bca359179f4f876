"""The spatial split's rules (raw_image_pipeline_tpu_torch/parallel/
spatial.py, which has no JAX counterpart: GSPMD does that work there) on
the CPU: uneven slabs, the flips that are not hoisted onto the mosaic and
the float and fixed32 remaps over space, each held byte for byte against
the JAX package's unsharded chain (and its state as
test_torch_parallel._assert_against_reference holds it), and the rules'
host tables."""

import dataclasses

import pytest
from test_torch_parallel import _assert_against_reference, one_torch_thread  # noqa: F401
from test_torch_pipeline import _frames

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu_torch.parallel import make_mesh, spatial
from raw_image_pipeline_tpu_torch.parallel.mesh import split_rows


def test_uneven_slabs_equal_reference():
    """90x62 over space 4: slabs of 24, 22, 22 and 22 rows, the last ending
    on the frame's last row (replication, clamps)."""
    hw = (90, 62)
    assert [b - a for a, b in split_rows(90, 4)] == [24, 22, 22, 22]
    _assert_against_reference(tp.flagship_config(*hw), hw, _frames(3, 4, *hw), "sequence",
                               make_mesh(["cpu"] * 4, space=4))


@pytest.mark.parametrize("angle,hw", [(90, (64, 96)), (180, (45, 61))])
def test_unhoisted_flips_equal_reference(angle, hw):
    """flip 90 (the gather rule, hoisted onto the mosaic) and flip 180 on
    odd sizes (not hoisted: the three planes' rows, reversed)."""
    c = tp.flagship_config(*hw)
    config = c.replace(flip=dataclasses.replace(c.flip, angle=angle))
    _assert_against_reference(config, hw, _frames(angle, 4, *hw), "cameras",
                              make_mesh(["cpu"] * 4, space=4))


@pytest.mark.parametrize("mode", ["float", "fixed32"])
def test_remap_modes_over_space_equal_reference(mode):
    """The float (kernel E's plain version on the CPU) and fixed32 remaps,
    each slab through its window (five uneven slabs of 20, 20, 20, 18 and
    18 rows), against the JAX package's chain."""
    hw = (96, 128)
    c = tp.flagship_config(*hw)
    config = c.replace(undistortion=dataclasses.replace(c.undistortion, interpolation=mode))
    _assert_against_reference(config, hw, _frames(len(mode), 4, *hw), "sequence",
                              make_mesh(["cpu"] * 5, space=5))


def test_rule_tables():
    """The split rules' host tables: the resize rows of each slab cover
    the resize once, and a remap window holds every tap its slab reads."""
    for src_h, dst_h in ((1080, 270), (112, 270), (91, 270)):
        got = []
        for r0, r1 in split_rows(src_h, 4):
            y0, y1, a, b = spatial.resize_slab(src_h, dst_h, r0, r1)
            got.extend(range(y0, y1))
            assert r0 <= a and b <= min(src_h, r1 + 1)
        assert got == list(range(dst_h))
    hw = (112, 96)
    for mode in ("lerp", "float", "fixed32"):
        c = tp.flagship_config(*hw)
        config = c.replace(undistortion=dataclasses.replace(c.undistortion, interpolation=mode))
        base, weights = tp.pipeline.remap_fields(config, hw)
        for rows in split_rows(hw[0], 4):
            rebased, wt, (wa, wb) = spatial.remap_window(base, weights, mode, hw, hw[1], rows)
            taps = spatial.remap_taps(rebased, mode, (wb - wa, hw[1]))
            live = spatial.remap_live(wt, mode)
            assert 0 <= wa < wb <= hw[0]
            assert ((taps >= 0) & (taps < (wb - wa) * hw[1]))[:, live].all()
            assert (rebased[~live] == 0).all()
