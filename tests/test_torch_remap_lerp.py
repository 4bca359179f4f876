"""Kernel F (csrc/remap_lerp.cu), the lerp and fixed32 remaps, on the CPU.

(a) The arithmetic that makes F and the plain version one function: the
plain lerp's x-lerps (ops/undistortion.lerp_x) and its y-lerp
(ops/common.fma_f32) against one f32 rounding of the exact value
(fractions.Fraction) on hostile operands, and F's rule (the card's fma
where it gives the plain bytes, the plain emulation elsewhere) modelled
with exact fmas against the plain version, operand by operand and over
whole maps; (b) F's grid rows and launches (remap_blocks, remap_launches)
for 6 and 4 weight rows, driven over the plain versions; (c) the wrapper
refuses CPU tensors; (d) F's registration; (e) the plain lerp and fixed32
remaps against the JAX package on the lerp-hostile maps. F itself runs only
on a card: tests/test_torch_gpu_path.py holds it there (cuda marker).
"""

import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw_image_pipeline_tpu.ops import undistortion as jund
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops import common as pcommon
from raw_image_pipeline_tpu_torch.ops import undistortion as pund
from raw_image_pipeline_tpu_torch.tools import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
f32 = np.float32
NATIVE_FX_MIN = f32(2.0**-17)  # F's fma domain for fx: 0 or [2^-17, 1)


def _round_f32(q: Fraction) -> f32:
    """q rounded once to the nearest f32, ties to even, subnormals kept."""
    if q == 0:
        return f32(0.0)
    sign, q = (-1, -q) if q < 0 else (1, q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    m = q / ulp
    k = m.numerator // m.denominator
    r = m - k
    if r > Fraction(1, 2) or (r == Fraction(1, 2) and k % 2):
        k += 1
    return f32(sign * float(k * ulp))


def _fma(a, b, c) -> f32:
    """The card's __fmaf_rn(a, b, c): a*b + c rounded once."""
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=f32))


def _lerp_x_plain(fx, v0, v1) -> np.ndarray:
    fx = _t(fx)
    return pund.lerp_x(fx, *pund.lerp_split(fx), _t(v0), _t(v1)).numpy()


def _fma_plain(a, b, c) -> np.ndarray:
    return pcommon.fma_f32(_t(a), _t(b), _t(c)).numpy()


def _byte(y) -> int:
    return int(pcommon.round_u8(_t([y]))[0])


def _f_byte(fx, fy, taps, masks) -> int:
    """Kernel F's lerp byte (remap_lerp_kernel's rule, lerp_native and
    lerp_emulated), with each fma rounded once: in its domain, the fmas
    and, within 2^-14 of a half-integer, the plain y-lerp; outside it, the
    plain lerp throughout."""
    fx, fy = f32(fx), f32(fy)
    v = [f32(f32(t) * f32(m)) for t, m in zip(taps, masks)]
    native = ((fx == 0 or NATIVE_FX_MIN <= fx < 1) and 0 <= fy < 1
              and all(m in (0.0, 1.0) for m in masks))
    if native:
        t = _fma(fx, f32(v[1] - v[0]), v[0])
        b = _fma(fx, f32(v[3] - v[2]), v[2])
        d = f32(b - t)
        y = _fma(fy, d, t)
        r = f32(f32(y + f32(2.0**23)) - f32(2.0**23))  # rint(y), y in [0, 255]
        if abs(f32(y - r)) >= f32(0.5 - 2.0**-14):
            y = _fma_plain([fy], [d], [t])[0]
    else:
        t = _lerp_x_plain([fx], [v[0]], [v[1]])[0]
        b = _lerp_x_plain([fx], [v[2]], [v[3]])[0]
        y = _fma_plain([fy], [f32(b - t)], [t])[0]
    return _byte(y)


def _plain_byte(fx, fy, taps, masks) -> int:
    """remap_lerp_planes's byte for one pixel of a 2x2 source."""
    planes = (torch.as_tensor(np.array(taps, np.uint8).reshape(1, 2, 2)),)
    base = torch.tensor([3], dtype=torch.int32)  # tap 0 at 3 - (2 + 1) = 0
    weights = _t(np.array([fx, fy, *masks], f32).reshape(6, 1))
    return int(pund.remap_lerp_planes(planes, base, weights, (1, 1))[0, 0, 0, 0])


FX_HOSTILE = [0.0, 2.0**-149, 2.0**-140, 2.0**-126, 2.0**-24 / 3, 2.0**-18, 2.0**-17,
              2.0**-17 + 2.0**-40, 2.0**-12, 1 / 3, 0.25, 0.5, 0.75, 1 - 2.0**-24]
TAPS_HOSTILE = [0, 1, 2, 127, 128, 254, 255]


# --- (a) the arithmetic -------------------------------------------------------


def test_plain_x_lerp_is_one_rounding_in_f_domain():
    # fx in {0} u [2^-17, 1): the emulation's two error terms are multiples
    # of ulp(fx) >= 2^-40 below 2^-16, so their sum is exact and the x-lerp
    # is one rounding, the card's fma; d = v1 - v0 reaches +-255, and fx =
    # 1/2 gives exact .5 results
    rng = np.random.default_rng(11)
    fxs = [f32(x) for x in FX_HOSTILE if x == 0 or f32(x) >= NATIVE_FX_MIN]
    fxs += list(rng.integers(0x37000000, 0x3F800000, 300, dtype=np.uint32).view(f32))
    fx, v0, v1 = (np.array(a, f32).ravel() for a in
                  np.meshgrid(fxs, TAPS_HOSTILE, TAPS_HOSTILE, indexing="ij"))
    got = _lerp_x_plain(fx, v0, v1)
    for i in range(fx.size):
        assert got[i] == _fma(fx[i], f32(v1[i] - v0[i]), v0[i]), (fx[i], v0[i], v1[i])


def test_plain_x_lerp_below_f_domain():
    # below 2^-17 the emulation is one rounding on most operands (subnormal
    # fx included) but not on all: x = 2^-24 / 3 over taps 1 and 4 leaves
    # the sum of its error terms inexact, and it rounds a tie the other way
    # (ROADMAP Queue 3); F computes the emulation there
    for fx in (f32(x) for x in FX_HOSTILE if 0 < f32(x) < NATIVE_FX_MIN):
        for v0 in TAPS_HOSTILE:
            for v1 in (0, 255, v0):
                got = _lerp_x_plain([fx], [v0], [v1])[0]
                assert got == _fma(fx, f32(v1 - v0), f32(v0)), (fx, v0, v1)
    fx = f32(2.0**-24 / 3)
    got = _lerp_x_plain([fx], [1.0], [4.0])[0]
    assert got == f32(1.0) and _fma(fx, f32(3.0), f32(1.0)) == np.nextafter(f32(1), f32(2))


def _y_operands():
    """(fy, t, b) for the y-lerp: fy at 0, subnormal, 2^-17, 1/6, 1/2 and
    1 - 2^-24; t and b at 0 and 255, at exact .5 results and a few ulps
    apart; then seeded draws over [0, 1) and [0, 255]."""
    fys = [0.0, 2.0**-149, 2.0**-126, 2.0**-17, 1 / 6, 0.5, 1 - 2.0**-24, 6.6496973e-12]
    ts = [0.0, 2.0**-24, 0.5, 1.0, 127.5, 254.5, 255.0]
    out = [(f32(fy), f32(t), f32(b)) for fy in fys for t in ts for b in ts]
    for t in (f32(1), f32(2), f32(3.5), f32(100), f32(127.5)):
        for k in (1, 3, 5, 7):
            out += [(f32(fy), t, f32(t + k * np.spacing(t))) for fy in fys]
    out.append((f32(6.6496973e-12), f32(3.9818293e-26), f32(24.0)))
    # the emulation's tie at t = 1.5 goes up where the exact value lies just
    # below 1.5 - 2^-24: the fma's byte is 1, the emulation's 2
    out.append((f32(1 / 6), f32(1.5), f32(1.5 - 3 * 2.0**-23)))
    rng = np.random.default_rng(12)
    fy = rng.integers(0, 0x3F800000, 1500, dtype=np.uint32).view(f32)
    tb = (rng.random((2, 1500)) * 255).astype(f32)
    out += list(zip(fy, tb[0], tb[1]))
    return out


def test_plain_y_lerp_within_one_ulp_and_f_takes_its_byte():
    # fma_f32 is one rounding of fy*(b - t) + t on almost every operand; where
    # it is not (a tiny t beside the product, or the product half an ulp of
    # t with an error below the sum's window: fy = 1/6, b = t + 3 ulps), it
    # is the neighbouring f32, so the byte can move only within an ulp of a
    # half-integer, and there F's guard takes the emulation's result
    ops = _y_operands()
    fy, t, b = (np.array(c, f32) for c in zip(*ops))
    d = (b - t).astype(f32)
    got = _fma_plain(fy, d, t)
    differ, bytes_differ = 0, 0
    for i in range(len(ops)):
        exact = _fma(fy[i], d[i], t[i])
        if got[i] == exact:
            continue
        differ += 1
        assert got[i] in (np.nextafter(exact, f32(-1)), np.nextafter(exact, f32(256))), ops[i]
        near_half = abs(f32(exact - f32(np.floor(exact) + f32(0.5)))) <= f32(exact * f32(2.0**-21))
        bytes_differ += _byte(got[i]) != _byte(exact)
        assert near_half or _byte(got[i]) == _byte(exact), ops[i]
    # the recorded cases (ROADMAP Queue 3), one of which moves the byte
    assert differ >= 3 and bytes_differ >= 1


def test_f_byte_equals_plain_on_hostile_pixels():
    # one pixel of a 2x2 source at a time: F's rule, modelled with exact
    # fmas, gives remap_lerp_planes's byte on hostile fractions, on taps at
    # the u8 ends and on exact .5 results, in and outside F's fma domain
    # (masks other than 0 and 1, fy >= 1)
    rng = np.random.default_rng(13)
    fys = [0.0, 2.0**-140, 2.0**-17, 1 / 6, 0.5, 1 - 2.0**-24]
    taps_sets = [(0, 255, 255, 0), (1, 2, 3, 4), (254, 255, 255, 254), (0, 0, 0, 1),
                 (128, 127, 0, 255)]
    cases = [(f32(fx), f32(fy), taps, (1.0, 1.0, 1.0, 1.0))
             for fx in FX_HOSTILE for fy in fys for taps in taps_sets]
    cases += [(f32(0.5), f32(0.5), (0, 1, 0, 1), masks)
              for masks in ((1.0, 0.0, 1.0, 1.0), (0.0, 0.0, 1.0, 1.0), (0.5, 1.0, 1.0, 1.0))]
    cases += [(f32(0.25), f32(1.0), (10, 20, 30, 40), (1.0,) * 4),
              (f32(1.0), f32(0.5), (10, 20, 30, 41), (0.0, 1.0, 0.0, 1.0))]
    for _ in range(400):
        fx, fy = rng.integers(0x36000000, 0x3F800000, 2, dtype=np.uint32).view(f32)
        cases.append((fx, fy, tuple(int(v) for v in rng.integers(0, 256, 4)), (1.0,) * 4))
    for fx, fy, taps, masks in cases:
        assert _f_byte(fx, fy, taps, masks) == _plain_byte(fx, fy, taps, masks), (fx, fy, taps)


@pytest.mark.parametrize("kind", ["lerp_hostile", "fisheye"])
def test_f_rule_equals_plain_over_a_map(kind):
    # F's rule over every live pixel of a 24x32 map (remap_precompute of a
    # lerp-hostile map or of the flagship's fisheye map, cropped) and three
    # seeded channels against remap_lerp_planes, byte for byte
    hw = (24, 32)
    if kind == "fisheye":
        import raw_image_pipeline_tpu_torch as tp

        p = tp.make_params(tp.flagship_config(240, 320), (240, 320), device="cpu")
        base = p.remap_base.numpy().reshape(240, 320)[100:124, 140:172]
        weights = p.remap_weights.numpy().reshape(6, 240, 320)[:, 100:124, 140:172]
        base, weights, src = base.reshape(-1), weights.reshape(6, -1), (240, 320)
    else:
        src = hw
        base, weights = pund.remap_precompute(*workloads.lerp_hostile_maps(hw, hw, 5), hw,
                                              mode="lerp")
    planes = np.random.default_rng(14).integers(0, 256, (3, 1) + src, dtype=np.uint8)
    want = pund.remap_lerp_planes(tuple(torch.as_tensor(p) for p in planes),
                                  torch.as_tensor(base), torch.as_tensor(weights), hw).numpy()
    flat = planes.reshape(3, -1)
    h, w = src
    for q in np.nonzero((weights[2:] != 0).any(0))[0]:
        a = int(base[q]) - (w + 1)
        idx = [min(max(a + off, 0), h * w - 1) for off in (0, 1, w, w + 1)]
        for c in range(3):
            got = _f_byte(weights[0, q], weights[1, q], flat[c, idx], tuple(weights[2:, q]))
            assert got == want[0].reshape(-1, 3)[q, c], (q, c)


# --- (b) grid rows and launches over the plain versions ------------------------


def _camera_maps(mode, cameras, hw):
    maps = [pund.remap_precompute(*workloads.lerp_hostile_maps(hw, hw, 20 + c), hw, mode=mode)
            for c in range(cameras)]
    return (torch.as_tensor(np.stack([m[0] for m in maps])),
            torch.as_tensor(np.stack([m[1] for m in maps])))


PLAIN = {"lerp": pund.remap_lerp_planes, "fixed32": pund.remap_fixed32_planes}


@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
@pytest.mark.parametrize("batch,cameras,chunk", [(12, 3, 2), (8, 4, 3), (5, 1, 2)])
def test_remap_blocks_drive_the_plain_versions(mode, batch, cameras, chunk):
    # each grid row through the map at its base and weights offsets into
    # the stacked maps (rows = 6 for lerp, 4 for fixed32) equals
    # remap_planes's per-camera loop
    hw = (6, 8)
    n = hw[0] * hw[1]
    rows = pund.REMAP_WEIGHT_ROWS[mode]
    base, weights = _camera_maps(mode, cameras, hw)
    planes = tuple(torch.as_tensor(p) for p in np.random.default_rng(batch).integers(
        0, 256, (3, batch) + hw, dtype=np.uint8))
    flat_b, flat_w = base.reshape(-1), weights.reshape(-1)
    got = torch.zeros((batch,) + hw + (3,), dtype=torch.uint8)
    seen = []
    for z, y, f0, f1, boff, woff in pund.remap_blocks(batch, cameras, chunk, n, rows):
        assert (boff, woff) == (z * n, z * rows * n)
        got[f0:f1] = PLAIN[mode](tuple(p[f0:f1] for p in planes), flat_b[boff:boff + n],
                                 flat_w[woff:woff + rows * n].view(rows, n), hw)
        seen += range(f0, f1)
    assert sorted(seen) == list(range(batch))
    stacked = (base, weights) if cameras > 1 else (base[0], weights[0])
    assert torch.equal(got, pund.remap_planes(planes, *stacked, hw, mode))


@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
@pytest.mark.parametrize("batch,cameras,limit", [(12, 3, 3), (12, 4, 2), (9, 1, 4)])
def test_remap_launches_drive_the_plain_versions(mode, batch, cameras, limit):
    # the launches past a lowered batch limit, each through its camera's
    # map (or every camera's, grid z), cover the batch as remap_planes does
    hw = (5, 7)
    base, weights = _camera_maps(mode, cameras, hw)
    if cameras == 1:
        base, weights = base[0], weights[0]
    planes = tuple(torch.as_tensor(p) for p in np.random.default_rng(batch + 1).integers(
        0, 256, (3, batch) + hw, dtype=np.uint8))
    got = torch.zeros((batch,) + hw + (3,), dtype=torch.uint8)
    for f0, nf, cams, z in pund.remap_launches(batch, cameras, limit):
        zb, zw = (base, weights) if z is None else (base[z], weights[z])
        got[f0:f0 + nf] = pund.remap_planes(tuple(p[f0:f0 + nf] for p in planes), zb, zw, hw,
                                            mode)
    assert torch.equal(got, pund.remap_planes(planes, base, weights, hw, mode))


# --- (c), (d) the wrapper and the registration ---------------------------------


@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
def test_remap_lerp_cuda_refuses_cpu_tensors(mode):
    rows = pund.REMAP_WEIGHT_ROWS[mode]
    planes = tuple(torch.zeros((2, 4, 6), dtype=torch.uint8) for _ in range(3))
    base, weights = torch.zeros(24, dtype=torch.int32), torch.zeros((rows, 24))
    with pytest.raises(ValueError, match="CUDA"):
        pund.remap_lerp_cuda(planes, base, weights, (4, 6), mode=mode)
    with pytest.raises(ValueError):
        pund.remap_lerp_cuda(planes, base, weights, (4, 6), mode="float")
    # on CPU tensors remap_planes takes the plain version, never the kernel
    before = kernels.REMAP_LERP.launches
    assert torch.equal(pund.remap_planes(planes, base, weights, (4, 6), mode),
                       PLAIN[mode](planes, base, weights, (4, 6)))
    assert kernels.REMAP_LERP.launches == before


def _native(fx, fy):
    """remap_lerp_kernel's fma domain for fx and fy (the rest of its
    native rule is the masks being 0 or 1)."""
    return ((fx == 0) | ((fx >= NATIVE_FX_MIN) & (fx < 1))) & (fy >= 0) & (fy < 1)


def _lerp_maps(kind, hw):
    if kind == "lerp_hostile":
        return pund.remap_precompute(*workloads.lerp_hostile_maps(hw, hw, 9), hw, mode="lerp")
    if kind == "border":
        return pund.remap_precompute(*workloads.border_maps(hw, hw, 9), hw, mode="lerp")
    import dataclasses

    import raw_image_pipeline_tpu_torch as tp

    config = workloads.chains(tp)[kind].config(*hw)
    config = config.replace(undistortion=dataclasses.replace(config.undistortion,
                                                             interpolation="lerp"))
    p = tp.make_params(config, hw, device="cpu")
    return p.remap_base.numpy(), p.remap_weights.numpy()


@pytest.mark.parametrize("kind", ["flagship", "float", "fixed32", "lerp_hostile", "border"])
def test_lerp_masks_are_zero_or_one_where_f_holds_mask_bits(kind):
    # F keeps a pixel's four masks as bits and selects a tap or 0 by them,
    # which is the plain tap * mask only for masks 0 and 1: on the chains'
    # maps (their calibration's, in lerp mode) and the lerp-hostile and
    # border maps, every pixel in F's fma domain, and every pixel at all,
    # has masks of exactly 0.0 or 1.0, and a mask-1 tap lies in the frame
    hw = (60, 80)
    base, weights = _lerp_maps(kind, hw)
    masks = weights[2:]
    assert np.isin(masks[:, _native(weights[0], weights[1])], (0.0, 1.0)).all()
    assert np.isin(masks, (0.0, 1.0)).all()
    h, w = hw
    for k, off in enumerate((0, 1, w, w + 1)):
        at = base.astype(np.int64) - (w + 1) + off
        assert ((at >= 0) & (at < h * w))[masks[k] == 1].all()


@pytest.mark.parametrize("kind", ["flagship", "border"])
def test_f_stages_the_border_tiles(kind):
    # workloads.remap_tile_census, a host model of the kernels' staging
    # rule: the flagship's and the border map hold live pixels with a tap
    # past the source's border (a mask of 0), and under F's lerp rule no
    # tile of either gathers from global memory
    hw = (240, 320)
    base, weights = _lerp_maps(kind, hw)
    masks = weights[2:]
    assert ((masks != 0).any(0) & (masks == 0).any(0)).sum() > 0
    c = workloads.remap_tile_census(base, weights, hw, hw, "lerp")
    assert c["tiles"] == 30 * 5 and c["global"] == 0
    assert c["staged"] + c["empty"] == c["tiles"]
    # hostile maps scatter a tile's taps past the buffer: those gather
    mx, my = workloads.hostile_maps(hw, hw, 3)
    hb, hwts = pund.remap_precompute(mx, my, hw, mode="lerp")
    assert workloads.remap_tile_census(hb, hwts, hw, hw, "lerp")["global"] > 0


def test_remap_tile_census_counts_the_template_modes():
    # float and fixed32 keep the template's rule: the flagship's map in
    # those modes stages every live tile but those with a tap on the
    # source's last column or row; the model's tile and box sizes are the
    # kernels'
    hw = (240, 320)
    import raw_image_pipeline_tpu_torch as tp

    with open(os.path.join(REPO, "raw_image_pipeline_tpu_torch", "csrc", "remap_tile.cuh")) as f:
        header = f.read()
    assert f"kStage = {workloads.REMAP_STAGE_BYTES};" in header
    assert f"kTileH = {workloads.REMAP_TILE[0]}, kTileW = {workloads.REMAP_TILE[1]};" in header
    assert workloads.REMAP_TILE == pund.REMAP_TILE
    for mode in ("float", "fixed32"):
        p = tp.make_params(workloads.chains(tp)[mode].config(*hw), hw, device="cpu")
        c = workloads.remap_tile_census(p.remap_base, p.remap_weights, hw, hw, mode)
        assert c["tiles"] == 150 and c["staged"] + c["empty"] + c["global"] == 150
        assert c["staged"] > 100, c


def test_kernel_f_is_registered():
    assert kernels.REMAP_LERP in kernels.ALL
    assert kernels.REMAP_LERP.entry in kernels._SIGNATURES
    assert "remap_lerp.cu" in kernels.SOURCES and "remap_tile.cuh" in kernels.HEADERS
    assert os.path.exists(os.path.join(REPO, kernels.REMAP_LERP.source))
    path, line = kernels.REMAP_LERP.replaces.split(":")
    with open(os.path.join(REPO, path)) as f:
        assert f.readlines()[int(line) - 1].startswith("def _remap_rows(")
    assert len({k.name for k in kernels.ALL}) == len(kernels.ALL) == 16  # A-P


# --- (e) the plain versions against the JAX package ---------------------------


@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
def test_plain_remaps_equal_reference_on_lerp_hostile_maps(mode):
    # coordinates on integers and halves, within 2^-20 of integers, just
    # above and below 0 and past each border: the port's remap_precompute
    # and plain remap against the JAX package's, 0 mismatching bytes
    hw = (37, 45)
    mx, my = workloads.lerp_hostile_maps(hw, hw, 31)
    base, weights = jund.remap_precompute(mx, my, hw, mode=mode)
    pbase, pweights = pund.remap_precompute(mx, my, hw, mode=mode)
    np.testing.assert_array_equal(pbase, base)
    np.testing.assert_array_equal(pweights, weights)
    planes = np.random.default_rng(32).integers(0, 256, (3, 2) + hw, dtype=np.uint8)
    want = np.asarray(jund.remap_bilinear_u8_planes(
        tuple(jnp.asarray(np.moveaxis(p, 0, -1)) for p in planes), base, weights, hw, hw,
        mode=mode))
    got = pund.remap_planes(tuple(torch.as_tensor(p) for p in planes), torch.as_tensor(base),
                            torch.as_tensor(weights), hw, mode)
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(want, -1, 0))


# --- (f) fixed32's compact map and integer blend (remap_fixed32_kernel) ------


def _fixed32_shipped(name, out_hw):
    """remap_precompute(..., "fixed32") of a shipped calibration's fisheye
    map, rendered at a small output size over the calibration's source."""
    from raw_image_pipeline_tpu_torch.config import load_camera_calibration

    calib = load_camera_calibration(os.path.join(REPO, "configs", name))
    size = (calib.image_width, calib.image_height)
    new_k = pund.estimate_new_camera_matrix(calib.K(), calib.D(), size, calib.R(), 0.0,
                                            (out_hw[1], out_hw[0]), 1.0)
    mx, my = pund.init_undistort_rectify_map(calib.K(), calib.D(), calib.R(), new_k,
                                             (out_hw[1], out_hw[0]))
    return pund.remap_precompute(mx, my, (calib.image_height, calib.image_width),
                                 mode="fixed32")


def _fixed32_rows_at_borders(hw):
    """A map through every row (ay, ax) of the weight table at anchors
    inside the source and one pixel past and on each border and corner
    (every slot pattern remap_precompute's clipping makes), and a few pixels
    far outside: [len, 1] maps of a source of hw."""
    h, w = hw
    ys, xs = (-1, 0, 1, h - 2, h - 1, h + 3), (-1, 0, 1, w - 2, w - 1, w + 3)
    ay, ax, iy, ix = (a.reshape(-1) for a in np.meshgrid(np.arange(32), np.arange(32), ys, xs,
                                                         indexing="ij"))
    mx = (ix + ax / 32).astype(np.float32)[:, None]
    my = (iy + ay / 32).astype(np.float32)[:, None]
    return mx, my


def _fixed32_maps(kind):
    """(base, weights, source hw, out hw) in fixed32 mode for `kind`."""
    if kind.startswith("shipped"):
        name = {"shipped": "alphasense_calib_example.yaml",
                "shipped_1.6mp": "alphasense_calib_1.6mp_example.yaml"}[kind]
        base, weights = _fixed32_shipped(name, (24, 32))
        from raw_image_pipeline_tpu_torch.config import load_camera_calibration

        calib = load_camera_calibration(os.path.join(REPO, "configs", name))
        return base, weights, (calib.image_height, calib.image_width), (24, 32)
    hw = (23, 29)
    if kind == "rows_at_borders":
        mx, my = _fixed32_rows_at_borders(hw)
    else:
        fn = {"hostile": workloads.hostile_maps, "border": workloads.border_maps}[kind]
        mx, my = fn(hw, hw, 41)
    base, weights = pund.remap_precompute(mx, my, hw, mode="fixed32")
    return base, weights, hw, mx.shape


def _fixed32_model(planes, base, code, weights, hw):
    """remap_fixed32_kernel in numpy: the map decoded from the code (or read
    from the weights without one), each pixel's weights taken by the
    integer blend where they are integers in [0, 2^15] summing to at most
    2^15 (two __dp2a_lo over u16 pairs and the taps' byte pairs, then
    (acc + 2^14) >> 15, at most 255 there), else the plain f32 blend; taps
    outside the source read 0. planes [C, B, H, W] u8 -> [B, N, C] u8."""
    h, w = hw
    wt = weights if code is None else pund.remap_fixed32_decode(code, weights)
    wt = np.asarray(wt, np.float32)
    flat = planes.reshape(planes.shape[0], planes.shape[1], h * w).astype(np.int64)
    taps = []
    for off in (0, 1, w, w + 1):
        i = base.astype(np.int64) + off
        inside = (i >= 0) & (i < h * w)
        taps.append(np.where(inside, flat[..., np.clip(i, 0, h * w - 1)], 0))  # [C, B, N]
    whole = ((wt >= 0) & (wt <= 32768) & (wt == np.trunc(wt))).all(0)
    whole &= np.where(whole, wt, 0).sum(0) <= 32768
    wi = np.where(whole, wt, 0).astype(np.int64)
    lo, hi = wi[0] | wi[1] << 16, wi[2] | wi[3] << 16

    def dp2a_lo(a, b, c):  # a's u16 halves times b's bytes 0 and 1, plus c
        return c + (a & 0xFFFF) * (b & 0xFF) + (a >> 16) * ((b >> 8) & 0xFF)

    acc = dp2a_lo(lo, taps[0] | taps[1] << 8, dp2a_lo(hi, taps[2] | taps[3] << 8, 16384))
    integer = acc >> 15
    assert (np.where(whole, integer, 0) <= 255).all()
    t = [x.astype(np.float32) for x in taps]
    with np.errstate(invalid="ignore", over="ignore"):
        f = (t[0] * wt[0] + t[1] * wt[1]) + t[2] * wt[2]
        f = f + t[3] * wt[3]
        f = np.floor((f + np.float32(16384)) * np.float32(2.0**-15))
        f32 = np.clip(np.nan_to_num(f, nan=0.0), 0, 255).astype(np.int64)
    out = np.where(whole, integer, f32)
    return np.moveaxis(out, 0, -1).astype(np.uint8)


def test_fixed32_table_rows_are_the_weight_table():
    # the kernel computes a row from its code: every entry of cv::remap's
    # 32 x 32 table is the exact product the closed form gives
    np.testing.assert_array_equal(pund.fixed32_table_rows(),
                                  pund._bilinear_fixed_wtab().reshape(1024, 4))
    np.testing.assert_array_equal(pund.fixed32_table_rows(),
                                  jund._bilinear_fixed_wtab().reshape(1024, 4))
    with open(os.path.join(REPO, "raw_image_pipeline_tpu_torch", "csrc", "remap_lerp.cu")) as f:
        assert (f"constexpr int kCodeDead = {pund.FIXED32_DEAD}, "
                f"kCodeExplicit = {pund.FIXED32_EXPLICIT};") in f.read()


@pytest.mark.parametrize("kind", ["shipped", "shipped_1.6mp", "hostile", "border",
                                  "rows_at_borders"])
def test_fixed32_code_decodes_to_the_weights(kind):
    # the compact map gives back remap_precompute's fixed32 weights exactly,
    # every pixel: a table row, dead or explicit
    base, weights, _, _ = _fixed32_maps(kind)
    code = pund.remap_fixed32_code(weights)
    assert code.dtype == np.int16 and code.shape == base.shape
    np.testing.assert_array_equal(pund.remap_fixed32_decode(code, weights), weights)
    rows = code < pund.FIXED32_ROWS
    assert (code[~rows] >= pund.FIXED32_DEAD).all() and (code <= pund.FIXED32_EXPLICIT).all()
    np.testing.assert_array_equal(code == pund.FIXED32_DEAD, (weights == 0).all(0))
    if kind.startswith("shipped"):  # a fisheye map: almost every pixel a table row
        assert rows.mean() > 0.8 and (code == pund.FIXED32_EXPLICIT).mean() < 0.01


def test_fixed32_code_of_a_random_map_against_the_reference():
    # a seeded random map: the JAX package's remap_precompute, coded and
    # decoded, and the per-camera stack of two such maps
    hw = (19, 27)
    rng = np.random.default_rng(43)
    maps = [((rng.random(hw) * (hw[1] + 4) - 2).astype(np.float32),
             (rng.random(hw) * (hw[0] + 4) - 2).astype(np.float32)) for _ in range(2)]
    ref = [np.asarray(jund.remap_precompute(mx, my, hw, mode="fixed32")[1]) for mx, my in maps]
    for wt in ref:
        np.testing.assert_array_equal(pund.remap_fixed32_decode(pund.remap_fixed32_code(wt), wt),
                                      wt)
    stacked = np.stack(ref)
    code = pund.remap_fixed32_code(stacked)
    assert code.shape == (2, hw[0] * hw[1])
    np.testing.assert_array_equal(code[1], pund.remap_fixed32_code(ref[1]))
    np.testing.assert_array_equal(pund.remap_fixed32_decode(code, stacked), stacked)


@pytest.mark.parametrize("kind", ["rows_at_borders", "hostile", "border", "shipped"])
@pytest.mark.parametrize("coded", [True, False])
def test_fixed32_integer_blend_model_equals_plain(kind, coded):
    # all 1024 table rows at every border-slot pattern, and hostile and
    # border maps: the kernel's integer blend (the __dp2a sums and the
    # shift), from the compact code or from the weights, equals
    # remap_fixed32_planes on seeded taps
    base, weights, src_hw, out_hw = _fixed32_maps(kind)
    planes = np.random.default_rng(44).integers(0, 256, (3, 2) + tuple(src_hw), dtype=np.uint8)
    if kind == "shipped":
        planes[:, 1] = 255  # the largest products and sums
    code = pund.remap_fixed32_code(weights) if coded else None
    got = _fixed32_model(planes, base, code, weights, src_hw)
    want = pund.remap_fixed32_planes(tuple(torch.as_tensor(p) for p in planes),
                                     torch.as_tensor(base), torch.as_tensor(weights),
                                     (int(np.prod(out_hw)), 1))
    np.testing.assert_array_equal(got, want.numpy().reshape(got.shape))


def test_fixed32_blend_rule_on_op_layer_weights():
    # weights no map of remap_precompute's gives: integers up to 2^15 whose
    # sums reach 2^15 and pass it (to 2^16 and past), negative, fractional,
    # NaN: the kernel's rule (integer blend where exact, the plain f32 blend
    # elsewhere) equals the plain version on every pixel
    hw = (9, 11)
    n = 4000
    rng = np.random.default_rng(45)
    base = rng.integers(-3, hw[0] * hw[1] + 3, n).astype(np.int32)
    weights = rng.integers(0, 32769, (4, n)).astype(np.float32)
    weights[:, :250] = 8192  # sums of 2^15 exactly: the integer blend
    weights[:, 250:500] = 16384  # 2^16: the f32 blend
    weights[:, 500:700] = 32768  # past 2^16: the f32 blend, sums past 2^24
    weights[0, 700:800] = -1.0
    weights[1, 800:900] += 0.5
    weights[2, 900:950] = np.nan
    weights[:, 950:1000] = 0.0
    planes = rng.integers(0, 256, (3, 2) + hw, dtype=np.uint8)
    planes[:, 1] = 255
    got = _fixed32_model(planes, base, None, weights, hw)
    want = pund.remap_fixed32_planes(tuple(torch.as_tensor(p) for p in planes),
                                     torch.as_tensor(base), torch.as_tensor(weights), (n, 1))
    want = want.numpy().reshape(got.shape)
    ok = ~np.isnan(weights).any(0)  # a NaN's cast to u8 is the platform's
    np.testing.assert_array_equal(got[:, ok], want[:, ok])


def test_fixed32_chain_params_carry_the_code():
    # the fixed32 chain's params hold the compact map of their weights, the
    # other modes none; the multicamera stack holds one a camera
    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch.parallel import build_multicamera_pipeline

    hw = (48, 64)
    config = workloads.chains(tp)["fixed32"].config(*hw)
    p = tp.make_params(config, hw, device="cpu")
    assert p.remap_code.dtype == torch.int16
    np.testing.assert_array_equal(p.remap_code.numpy(),
                                  pund.remap_fixed32_code(p.remap_weights.numpy()))
    assert tp.make_params(workloads.chains(tp)["float"].config(*hw), hw,
                          device="cpu").remap_code is None
    cams = workloads.multicam_calibrations(config.calibration)
    mp = build_multicamera_pipeline(config, cams, "bayer_gbrg8", hw, device="cpu").params
    assert tuple(mp.remap_code.shape) == tuple(mp.remap_base.shape)
    np.testing.assert_array_equal(mp.remap_code.numpy(),
                                  pund.remap_fixed32_code(mp.remap_weights.numpy()))


def test_remap_lerp_cuda_takes_a_code_in_fixed32_mode_only():
    planes = tuple(torch.zeros((2, 4, 6), dtype=torch.uint8) for _ in range(3))
    base, code = torch.zeros(24, dtype=torch.int32), torch.zeros(24, dtype=torch.int16)
    with pytest.raises(ValueError, match="fixed32"):
        pund.remap_lerp_cuda(planes, base, torch.zeros((6, 24)), (4, 6), mode="lerp", code=code)
    with pytest.raises(ValueError, match="CUDA"):
        pund.remap_lerp_cuda(planes, base, torch.zeros((4, 24)), (4, 6), mode="fixed32",
                             code=code)
    # the code is the weights' shorthand: the plain version reads the weights
    wt = torch.full((4, 24), 8192.0)
    assert torch.equal(pund.remap_planes(planes, base, wt, (4, 6), "fixed32", code=code),
                       pund.remap_fixed32_planes(planes, base, wt, (4, 6)))


@pytest.mark.parametrize("offset", [0, 2, 4, 8])
def test_remap_run_width_needs_an_8_byte_aligned_code(offset):
    # the fixed32 kernel loads a run's four codes as one 8-byte word
    want = 4 if offset % 8 == 0 else 1
    assert pund.remap_run_width(1920, 4096, 8192, 8192, 16384 + offset) == want
    assert pund.remap_run_width(1920, 4096, 8192, 8192) == 4  # no code


def test_remap_variants_apply_to_the_sources():
    # tools/remap_variants.py builds its variants of kernel F's fixed32 mode
    # (and of its first form) from the sources by text replacements, each of
    # which must still apply once
    from raw_image_pipeline_tpu_torch.tools import remap_variants as rv

    assert rv.ENTRY in kernels._SIGNATURES and set(rv.FILES) <= set(kernels.SOURCES
                                                                      + kernels.HEADERS)
    for name, (repl, _) in rv.VARIANTS.items():
        texts = rv.variant_files(name, kernels.CSRC_DIR)
        assert f'extern "C" int {rv.ENTRY}(' in texts["remap_lerp.cu"], name
        for f, _, new in repl:
            assert new in texts[f], name
    first = rv.variant_files("F32_first", kernels.CSRC_DIR)["remap_lerp.cu"]
    assert "dispatch<isp_remap::Tiles<Fixed32Mode>>" in first
