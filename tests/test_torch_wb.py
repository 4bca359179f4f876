"""The PyTorch port's statistical white-balance methods (simple, grey_world,
pca, learned) against the JAX package and the native-oracle goldens on the
CPU, and the BASELINE config 2 chain (debayer + flip 90 + each method)
against the JAX package's build_pipeline. Tolerance everywhere: 0
mismatching bytes."""

import math
import os
from fractions import Fraction

import cv2
import jax
import numpy as np
import pytest
import torch

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.ops import learned_wb as jlearned
from raw_image_pipeline_tpu.ops import white_balance as jwb
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline
from raw_image_pipeline_tpu_torch.ops import learned_wb as plearned
from raw_image_pipeline_tpu_torch.ops import white_balance as pwb

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "wb_oracle")
ORACLE_INPUTS = {
    "alphasense": os.path.join(HERE, "fixtures", "alphasense.png"),
    "gehler": os.path.join(HERE, "fixtures", "gehler_shi.png"),
    "noise": os.path.join(FIX, "noise.png"),
    "gauss": os.path.join(FIX, "gauss.png"),
}


def cast_frames(seed, n, h, w):
    """[n, h, w, 3] u8 BGR frames, each with its own colour cast (so that
    the methods' gains differ from frame to frame) and bright, saturated
    spots."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        base = 40 + 200 * (0.5 + 0.5 * np.sin(7 * xx + rng.uniform(0, 6) + 5 * yy))
        img = base[..., None] * rng.uniform(0.4, 1.7, 3) * rng.uniform(0.8, 1.2, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def planes_of(bgr):
    t = torch.as_tensor(np.ascontiguousarray(bgr))
    return t[..., 0], t[..., 1], t[..., 2]


def packed(planes):
    return torch.stack(planes, dim=-1).numpy()


def mismatches(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return int((a != b).sum())


# --- each method against the JAX function ------------------------------------


@pytest.mark.parametrize("p", [2.0, 20.0, 35.0])
def test_simple_equals_reference(p):
    x = cast_frames(1, 3, 45, 61)
    want = np.asarray(jwb.balance_white_simple(x, p))
    assert mismatches(packed(pwb.balance_white_simple_planes(planes_of(x), p)), want) == 0


@pytest.mark.parametrize("thr", [0.5, 0.8, 1.2])
def test_grey_world_equals_reference(thr):
    # 45x61 = 2745 px: not a multiple of 16, so at 1.2 (the u16-wrap rule)
    # the frame has a scalar tail
    x = cast_frames(2, 3, 45, 61)
    want = np.asarray(jwb.balance_white_grey_world(x, thr))
    got = packed(pwb.balance_white_grey_world_planes(planes_of(x), thr))
    assert mismatches(got, want) == 0
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("hw", [(3, 3), (9, 7), (48, 64)])
def test_pca_equals_reference(hw):
    x = cast_frames(3, 3, *hw)
    x[1, ..., 0] = 77  # a constant channel: det == 0, the NaN pattern
    x[2, ..., 2] = 0
    want = np.asarray(jwb.balance_white_pca(x))
    got = packed(pwb.balance_white_pca_planes(planes_of(x)))
    assert mismatches(got, want) == 0
    if hw[0] * hw[1] % 4:
        assert got[1, -1, -1, 0] == 0 and got[1, 0, 0, 0] == 255


@pytest.mark.parametrize("hw", [(13, 17), (48, 64)])
def test_learned_equals_reference(hw):
    # 13x17 = 221 px: fewer bins than the 300-entry palette
    x = cast_frames(4, 3, *hw)
    want = np.asarray(jlearned.balance_white_learned_model(x, 0.8))
    got = packed(plearned.balance_white_learned_planes(planes_of(x), 0.8))
    assert mismatches(got, want) == 0
    feats = plearned.extract_features(planes_of(x), 204)
    want_f = np.stack([np.asarray(jlearned._extract_features(f, 204)) for f in x])
    np.testing.assert_array_equal(feats.numpy(), want_f)


def test_pca_lut_equals_reference():
    """The port's LUT (TwoSum in f64, round to odd, narrow) against the JAX
    package's exact limb arithmetic, over seeded and adversarial (x0, x1):
    sign mixes, zeros, ties and exponent gaps of 54 to 79 bits (the limb
    window; wider gaps: the next test)."""
    rng = np.random.default_rng(7)
    x0 = list((rng.random(40) - 0.5) * 0.02) + list(
        (rng.random(40) - 0.5) * 10.0 ** rng.integers(-12, 3, 40))
    x1 = list(rng.random(40) * 2 + 0.5) + list(
        (rng.random(40) - 0.5) * 10.0 ** rng.integers(-12, 3, 40))
    special = [(2.0 ** -10, 1.0), (-(2.0 ** -10), 255.0), (2.0 ** -20, 1.0 + 2.0 ** -23),
               (0.0, 1.5), (1.0, 0.0), (0.0, 0.0), (-1e-3, 1.25), (1e-3, -0.75),
               (1.0 / 512, 0.5), (-1.0 / 65025, 1.0 + 2.0 ** -20), (2.0 ** -24, 0.5 + 2.0 ** -24),
               (2.0 ** -60, 1.0), (1.0, 2.0 ** -60), (-(2.0 ** -70), 1.0), (1.0, -(2.0 ** -70)),
               (2.0 ** 20, -(2.0 ** -40)), (-(2.0 ** -78), 1.5), (3.0 * 2.0 ** -56, -1.0)]
    x0 = np.float32(x0 + [a for a, _ in special])
    x1 = np.float32(x1 + [b for _, b in special])
    want = np.asarray(jwb._pca_exact_lut(x0, x1))
    got = pwb.pca_exact_lut(torch.as_tensor(x0), torch.as_tensor(x1)).numpy()
    assert mismatches(got, want) == 0


def _rn_f32_lut_exact(x0, x1):
    """cvRound(min(rn_f32(x0*c^2 + x1*c), 255)) for c in 0..255, from the
    exact rational value."""
    out = []
    for c in range(256):
        v = Fraction(float(x0)) * c * c + Fraction(float(x1)) * c
        f = np.float32(0.0)
        if v:
            a = abs(v)
            e = a.numerator.bit_length() - a.denominator.bit_length()
            e += 1 if Fraction(2) ** e <= a else 0
            e -= 1 if Fraction(2) ** e > a else 0  # 2^e <= a < 2^(e+1)
            q, r = divmod(a / Fraction(2) ** (e - 23), 1)
            q += 1 if r > Fraction(1, 2) or (r == Fraction(1, 2) and q % 2) else 0
            f = np.float32(math.copysign(math.ldexp(q, e - 23), v))
        out.append(np.uint8(np.clip(np.rint(min(f, np.float32(255.0))), 0, 255)))
    return np.array(out)


def test_pca_lut_wide_exponent_gaps_equal_exact_value():
    """Exponent gaps beyond the JAX package's limb window (79 bits): the
    port's LUT is the correct rounding of the exact value; the JAX
    package's drifts there (ROADMAP Queue 3). Unreachable from a u8 frame,
    whose solve gives coefficients a few bits apart."""
    pairs = [(4.039168e-30, 31.522179), (3e-38, 1.0), (1e30, 1e-30), (-1e25, 3e-10),
             (2.0 ** -100, -(1.0 + 2.0 ** -23))]
    x0 = np.float32([a for a, _ in pairs])
    x1 = np.float32([b for _, b in pairs])
    got = pwb.pca_exact_lut(torch.as_tensor(x0), torch.as_tensor(x1)).numpy()
    for i in range(len(pairs)):
        np.testing.assert_array_equal(got[i], _rn_f32_lut_exact(x0[i], x1[i]), err_msg=str(i))


# --- each method against the native-oracle goldens ---------------------------


def _oracle_cases():
    cases = []
    for name in ORACLE_INPUTS:
        cases += [(name, "simple", p) for p in (2.0, 10.0, 20.0, 35.0)]
        cases += [(name, "grey", t) for t in (0.5, 0.8, 0.95)]
        cases += [(name, "pca", None)]
        if name != "noise":  # its learned golden is held to an envelope only
            cases += [(name, "learned", 0.8)]
    return cases


@pytest.mark.parametrize("name,method,param", _oracle_cases())
def test_method_equals_oracle_golden(name, method, param):
    img = cv2.imread(ORACLE_INPUTS[name])
    planes = planes_of(img[None])
    if method == "simple":
        got, ref = pwb.balance_white_simple_planes(planes, param), f"{name}_simple_{param}.png"
    elif method == "grey":
        got, ref = pwb.balance_white_grey_world_planes(planes, param), f"{name}_grey_{param}.png"
    elif method == "pca":
        got, ref = pwb.balance_white_pca_planes(planes), f"{name}_pca.png"
    else:
        got = plearned.balance_white_learned_planes(planes, param)
        ref = f"{name}_learned_{param}.png"
    assert mismatches(packed(got)[0], cv2.imread(os.path.join(FIX, ref))) == 0


def test_learned_tie_break_crop_equals_oracle_golden():
    """A 49x550 crop with two brightest pixels: the 8-lane first-wins rank."""
    img = np.ascontiguousarray(cv2.imread(ORACLE_INPUTS["alphasense"])[:49, :550])
    got = packed(plearned.balance_white_learned_planes(planes_of(img[None]), 0.9))[0]
    ref = cv2.imread(os.path.join(FIX, "alphasense_crop49x550_learned_0.9.png"))
    assert mismatches(got, ref) == 0


def test_learned_density_near_tie_crop_equals_reference():
    """A 64x96 crop whose near-gray palette densities tie within an ulp: the
    mode depends on the f32 summation order. The JAX package and the native
    library (learned_probe: f3 = 0.333333164, 0.444444209) agree here; a
    sum in palette order picked another bin and moved 16 971 bytes."""
    img = np.ascontiguousarray(cv2.imread(ORACLE_INPUTS["alphasense"])[349:413, 572:668])
    x = img[None]
    want = np.asarray(jlearned.balance_white_learned_model(x, 0.8))
    assert mismatches(packed(plearned.balance_white_learned_planes(planes_of(x), 0.8)), want) == 0
    f3 = plearned.extract_features(planes_of(x), 204)[0, 3].numpy()
    np.testing.assert_array_equal(f3, np.float32([0.333333164, 0.444444209]))


# --- BASELINE config 2: debayer + flip 90 + each statistical method ----------


def config2(method):
    """tests/test_baseline_configs.py's config 2 with `method`."""
    import dataclasses

    c = tp.PipelineConfig()
    return c.replace(
        flip=dataclasses.replace(c.flip, enabled=True, angle=90),
        white_balance=dataclasses.replace(c.white_balance, enabled=True, method=method,
                                          clipping_percentile=20.0,
                                          saturation_bright_thr=0.8),
    )


def mosaic_gbrg(bgr):
    out = bgr[..., 1].copy()
    out[..., 0::2, 1::2] = bgr[..., 0::2, 1::2, 0]
    out[..., 1::2, 0::2] = bgr[..., 1::2, 0::2, 2]
    return out


@pytest.mark.parametrize("method", ["simple", "grey_world", "pca", "learned"])
@pytest.mark.parametrize("hw", [(48, 64), (45, 61)])
def test_config2_chain_equals_reference(method, hw):
    config = config2(method)
    frames = mosaic_gbrg(cast_frames(sum(map(ord, method)), 3, *hw))
    jp = jax_build_pipeline(config, "bayer_gbrg8", frame_hw=hw, keep_intermediates=True)
    params = tp.params_from_numpy(jax.tree.map(np.asarray, jp.params), config, device="cpu")
    fn = tp.make_isp_fn(config, "bayer_gbrg8", False, True)
    jo, _ = jp(frames, None)
    po, _ = fn(params, torch.as_tensor(frames), None)
    assert set(po) == set(jo)
    for key in po:
        assert mismatches(po[key].numpy(), np.asarray(jo[key])) == 0, key
    assert po["processed"].shape == (3, hw[1], hw[0], 3)
    # the white balance moved the pixels
    assert not torch.equal(po["debayered"], po["processed"])


def test_unknown_method_raises_reference_message():
    config = config2("bogus")
    pipe = tp.build_pipeline(config, "bayer_gbrg8", (24, 32), device="cpu")
    with pytest.raises(ValueError, match=r"White Balance method \[bogus\] not supported"):
        pipe(torch.zeros((1, 24, 32), dtype=torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["simple", "grey_world", "pca", "learned"])
def test_config2_on_card_equals_cpu(method):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hw = (96, 128)
    frames = mosaic_gbrg(cast_frames(5, 4, *hw))
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = tp.build_pipeline(config2(method), "bayer_gbrg8", hw, device=dev)
        res[dev] = pipe(torch.as_tensor(frames, device=dev))[0]["processed"].cpu()
    assert torch.equal(res["cuda"], res["cpu"])
