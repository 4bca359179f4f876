"""Kernel G's CPU side (raw_image_pipeline_tpu_torch/ops/pointwise.py): its
plain version against the JAX package's stage functions on the same seeded
planes, the HSV2BGR fma domain that lets G use the card's fma, the chain's
choice of G's steps, and the wrapper's and binding's bookkeeping. G itself
runs only on a card (tests/test_torch_gpu_path.py, chip_smoke.py)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.ops import color_calibration as jcc
from raw_image_pipeline_tpu.ops import color_enhancer as jce
from raw_image_pipeline_tpu.ops import gamma as jgamma
from raw_image_pipeline_tpu.ops import vignetting as jvig
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch import pipeline as ppipe
from raw_image_pipeline_tpu_torch.ops import color_enhancer as pce
from raw_image_pipeline_tpu_torch.ops import colorspace as pcs
from raw_image_pipeline_tpu_torch.ops import common as pcommon
from raw_image_pipeline_tpu_torch.ops import gamma as pgamma
from raw_image_pipeline_tpu_torch.ops import pointwise as ppw
from raw_image_pipeline_tpu_torch.ops import vignetting as pvig
from raw_image_pipeline_tpu_torch.tools import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((2, 17, 31), (2, 24, 45))  # W < 32 (all scalar columns); W % 32 != 0
K = 0.9  # the flagship's gamma
ENHANCER_GAINS = (1.1, 1.2, 0.9)


def _inputs(shape, seed):
    """Seeded planes and every step's arguments, numpy."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    planes = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    return planes, dict(
        gains=rng.uniform(0.6, 2.4, (b, 3)).astype(np.float32),
        matrix=rng.uniform(-0.6, 1.6, (3, 3)).astype(np.float32),
        bias=rng.uniform(-20, 20, 3).astype(np.float32),
        mask=jvig.build_vignetting_mask(h, w, 1.5, 1e-3, 1e-6),
    )


def _jax_steps(planes, steps, a):
    """The JAX package's stage functions for `steps`, as its pipeline runs
    them: the k gamma by its poly formula and corrections, the BT.709 table
    by its formula and corrections, the folded gamma by
    composed_gamma_lab_fn, the enhancer's f32 gains with gain_corrections."""
    coeffs, root = jgamma.gamma_poly_coeffs(K)
    for step in steps:
        if step == "gains":
            planes = jccc.apply_gains_planes(planes, a["gains"])
        elif step == "calibration":
            planes = jcc.color_correct_planes(*planes, a["matrix"], a["bias"])
        elif step == "lut_k":
            idx, val = jgamma.gamma_corrections_poly(K, coeffs, root)
            planes = [jgamma.gamma_apply_poly(p, coeffs, idx, val, root=root) for p in planes]
        elif step == "lut_bt709":
            idx, val = jgamma.bt709_corrections(True)
            planes = [jgamma.gamma_apply_bt709(p, True, idx, val) for p in planes]
        elif step == "vignetting":
            planes = jvig.correct_planes(*planes, a["mask"])
        elif step == "gamma_vignetting":
            idx, val = jvig.composed_gamma_corrections(K, coeffs, root, jgamma.GAMMA_MAX_CORR)
            fn = jvig.composed_gamma_lab_fn(jnp.asarray(coeffs), idx, val, root)
            planes = jvig.correct_planes(*planes, a["mask"], gamma_fn=fn)
        elif step == "enhancer":
            planes = jce.enhance_planes(*planes, jnp.asarray(ENHANCER_GAINS, jnp.float32),
                                        corr=jce.gain_corrections(ENHANCER_GAINS))
    return [np.asarray(p) for p in planes]


def _port_args(steps, a):
    t = torch.as_tensor
    args = {}
    for step in steps:
        if step == "gains":
            args["gains"] = t(a["gains"])
        elif step == "calibration":
            args.update(matrix=t(a["matrix"]), bias=t(a["bias"]))
        elif step == "lut_k":
            args["lut"] = t(pgamma.build_gamma_lut(K))
        elif step == "lut_bt709":
            args["lut"] = t(pgamma.build_bt709_lut(True))
        elif step == "vignetting":
            args["mask"] = t(a["mask"])
        elif step == "gamma_vignetting":
            args.update(mask=t(a["mask"]), lab_tab=t(pvig.composed_gamma_lab_table(K)))
        elif step == "enhancer":
            args["enhancer_tables"] = t(pce.gain_tables(ENHANCER_GAINS))
    return args


STEP_SETS = {
    "flagship": ("gains", "calibration", "gamma_vignetting", "enhancer"),
    "gpu_parity": ("gains", "calibration", "lut_bt709", "vignetting", "enhancer"),
    "config4": ("calibration", "vignetting", "enhancer"),
    **{s: (s,) for s in ("gains", "calibration", "lut_k", "lut_bt709", "vignetting",
                         "gamma_vignetting", "enhancer")},
}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(STEP_SETS))
def test_plain_equals_reference(name, shape):
    steps = STEP_SETS[name]
    planes, a = _inputs(shape, seed=sum(shape) + len(name))
    want = _jax_steps(planes, steps, a)
    got = ppw.pointwise_planes(*map(torch.as_tensor, planes), plain=True,
                               **_port_args(steps, a))
    for x, y in zip(got, want):
        assert x.dtype == torch.uint8
        np.testing.assert_array_equal(x.numpy(), y)
    # on CPU planes the wrapper is the plain version and launches nothing
    before = kernels.POINTWISE.launches
    again = ppw.pointwise_planes(*map(torch.as_tensor, planes), **_port_args(steps, a))
    assert kernels.POINTWISE.launches == before
    for x, y in zip(again, got):
        assert torch.equal(x, y)


def _hsv_operands():
    """HSV2BGR's s and ff, f32, over their whole domains: s = f32(u8 * f32(1/255))
    and ff = hf - floor(hf), hf = f32(u8 * f32(6/180)), as ops/colorspace forms
    them from the gain tables' u8 outputs."""
    u = np.arange(256, dtype=np.float32)
    s = (u * np.float32(1.0 / 255.0)).astype(np.float32)
    hf = (u * np.float32(6.0 / 180.0)).astype(np.float32)
    ff = (hf - np.floor(hf)).astype(np.float32)
    return s, ff


@pytest.mark.parametrize("second", ["ff", "one_minus_ff"])
def test_hsv_fma_emulation_is_a_true_fma_on_its_domain(second):
    """fma_f32(-s, f, 1) (Dekker's emulation) against the exact rational
    1 - s*f rounded once to f32, over all 65 536 (s, f) pairs, f = ff or
    rn(1 - ff): 0 differences, so kernel G's __fmaf_rn gives the plain
    version's bytes. The exact value is formed in numpy's long double: s
    and f are multiples of 2^-32 in [0, 1], so 1 - s*f is a multiple of
    2^-64 in [0, 1], held exactly by its 64-bit (x86) or 113-bit
    significand."""
    assert np.finfo(np.longdouble).nmant >= 63
    s, ff = _hsv_operands()
    f = ff if second == "ff" else (np.float32(1.0) - ff).astype(np.float32)
    assert np.all(s * np.float64(2.0**32) == np.round(s * np.float64(2.0**32)))
    assert np.all(f * np.float64(2.0**32) == np.round(f * np.float64(2.0**32)))
    ss, fs = (x.ravel() for x in np.meshgrid(s, f, indexing="ij"))
    exact = np.longdouble(1) - ss.astype(np.longdouble) * fs.astype(np.longdouble)
    want = exact.astype(np.float32)
    got = pcommon.fma_f32(-torch.as_tensor(ss), torch.as_tensor(fs), 1.0).numpy()
    assert got.shape == (65536,)
    assert int((got.view(np.uint32) != want.view(np.uint32)).sum()) == 0


# --- the chain's choice of G's steps -----------------------------------------

CHAINS = workloads.chains(tp)
STAGE_OF = {  # the plain stage function each step ran as before kernel G
    "gains": "apply_gains_planes", "calibration": "color_correct_planes",
    "lut": "apply_lut", "vignetting": "correct_planes",
    "gamma_vignetting": "correct_planes(composed)", "enhancer": "enhance_planes",
}
# the stages the chain ran before G, per configuration (the former chain's
# conditions: CCC gains in the white balance, the k gamma folded into
# vignetting unless BT.709 or debug, nothing of it on mono frames but the
# gamma table)
BEFORE = {
    "flagship": ("apply_gains_planes", "color_correct_planes", "correct_planes(composed)",
                 "enhance_planes"),
    "gpu_parity": ("apply_gains_planes", "color_correct_planes", "apply_lut", "correct_planes",
                   "enhance_planes"),
    "pointwise_bgr8": ("color_correct_planes", "correct_planes", "enhance_planes"),
    "wb_grey_world": (),
    "wb_pca": (),
    "mono8_float": (),
    "flagship_debug": ("apply_gains_planes", "color_correct_planes", "apply_lut",
                       "correct_planes", "enhance_planes"),
}


def _case(name):
    chain = CHAINS[name.replace("_debug", "")]
    return chain, chain.config(48, 64), chain.kind != "mono", name.endswith("_debug")


@pytest.mark.parametrize("name", list(BEFORE))
def test_pointwise_steps_are_the_stages_the_chain_ran(name, monkeypatch):
    chain, config, is_color, debug = _case(name)
    steps = ppipe.pointwise_steps(config, is_color, debug)
    assert tuple(STAGE_OF[s] for s in steps) == BEFORE[name]
    on_card = ppipe.pointwise_launches(config, is_color, debug)
    assert on_card == ((tuple(steps),) if steps and not debug else tuple((s,) for s in steps))
    assert ppipe.pointwise_launches(config, is_color, debug, on_card=False) == tuple(
        (s,) for s in steps)
    # the plain chain on the CPU calls those stage functions, in that order
    ran = []

    def record(label, fn):
        def wrapped(*args, **kw):
            ran.append(label(*args, **kw) if callable(label) else label)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ppw, "apply_gains_planes",
                        record("apply_gains_planes", ppw.apply_gains_planes))
    monkeypatch.setattr(ppw, "color_correct_planes",
                        record("color_correct_planes", ppw.color_correct_planes))
    monkeypatch.setattr(ppw, "enhance_planes", record("enhance_planes", ppw.enhance_planes))
    monkeypatch.setattr(ppw, "correct_planes", record(
        lambda *a, gamma_tab=None: "correct_planes" + ("(composed)" if gamma_tab is not None
                                                       else ""), ppw.correct_planes))
    monkeypatch.setattr(ppw, "apply_lut", record("apply_lut", ppw.apply_lut))
    pipe = tp.build_pipeline(config, chain.encoding, frame_hw=(48, 64), with_state=True,
                             temporal_mode="sequence", device="cpu", debug=debug)
    frames = workloads.card_frames(torch, "color" if chain.kind == "color" else "bayer", 1, 48,
                                   64, 5, device="cpu")
    if chain.kind == "mono":
        frames = frames[..., 0] if frames.dim() == 4 else frames
    pipe(frames, tp.init_state((), device="cpu"))
    # apply_lut runs three times a LUT step, once a plane
    got = [r for i, r in enumerate(ran) if r != "apply_lut" or ran[i - 1:i] != ["apply_lut"]]
    assert tuple(got) == BEFORE[name]


# --- the wrapper and the binding ---------------------------------------------


def test_wrapper_bookkeeping():
    planes = tuple(torch.zeros((1, 2, 3), dtype=torch.uint8) for _ in range(3))
    assert ppw.pointwise_planes(*planes) == planes  # no step: the planes as they are
    with pytest.raises(ValueError, match="matrix and bias"):
        ppw.pointwise_planes(*planes, matrix=torch.eye(3))
    with pytest.raises(ValueError, match="needs a mask"):
        ppw.pointwise_planes(*planes, lab_tab=torch.zeros(256, dtype=torch.int32))
    # on CPU tensors the kernel's wrapper refuses: the card or nothing
    with pytest.raises(ValueError, match="CUDA"):
        ppw.pointwise_cuda(planes, lut=torch.arange(256, dtype=torch.uint8))


def _kernel_source() -> str:
    with open(os.path.join(REPO, kernels.POINTWISE.source)) as f:
        return f.read()


def _const_parts(t):
    """const_tables' bytes back to each table, by CONST_LAYOUT."""
    return {name: t[at:at + n * np.dtype(dtype).itemsize].view(np.dtype(dtype).newbyteorder("<"))
            for name, (at, n, dtype) in ppw.CONST_LAYOUT.items()}


def test_const_tables_match_the_kernels_layout():
    src = _kernel_source()
    offsets = {k: int(v) for k, v in re.findall(r"\b(k[A-Z]\w*) = (\d+)", src)}
    names = {"yify": "kYIfy", "cbrt": "kCbrt", "inv_gamma": "kInvGamma", "hdiv": "kHdiv",
             "sdiv": "kSdiv"}
    at = 0
    for name, (off, n, dtype) in ppw.CONST_LAYOUT.items():
        assert offsets[names[name]] == off == at, name
        at += n * np.dtype(dtype).itemsize
    assert offsets["kConstBytes"] == at == ppw.CONST_BYTES == ppw.const_tables().size
    assert offsets["kPx"] == ppw.PIXELS_PER_THREAD
    assert int(re.search(r"kSimdPx = (\d+)", src).group(1)) == pce.CV_SIMD_PX
    # W - W % 32 falls on a group boundary, so a group lies on one side of it
    assert pce.CV_SIMD_PX % ppw.PIXELS_PER_THREAD == 0


def test_const_tables_hold_the_old_tables_entry_for_entry():
    t = ppw.const_tables()
    assert t.dtype == np.uint8
    parts = _const_parts(t)
    np.testing.assert_array_equal(parts["yify"] & 0xFFFF, pcs._LAB2_Y_TAB)
    np.testing.assert_array_equal(parts["yify"] >> 16, pcs._LAB2_IFY_TAB)
    np.testing.assert_array_equal(parts["cbrt"], pcs._CBRT_TAB)
    np.testing.assert_array_equal(parts["inv_gamma"], pcs._LAB2_INV_GAMMA_TAB)
    np.testing.assert_array_equal(parts["hdiv"], pcs._HDIV_TAB)
    np.testing.assert_array_equal(parts["sdiv"], pcs._SDIV_TAB)
    # each old table's values fit the narrower type (and sdiv the bits below
    # the V gain the kernel packs above it)
    for name, tab, dtype in (("y", pcs._LAB2_Y_TAB, np.uint16), ("ify", pcs._LAB2_IFY_TAB, np.uint16),
                             ("cbrt", pcs._CBRT_TAB, np.uint16),
                             ("inv_gamma", pcs._LAB2_INV_GAMMA_TAB, np.uint8)):
        info = np.iinfo(dtype)
        assert info.min <= np.min(tab) and np.max(tab) <= info.max, name
    assert 0 <= np.min(pcs._SDIV_TAB) and np.max(pcs._SDIV_TAB) < 1 << ppw.SDIV_BITS


@pytest.mark.parametrize("table,value", [("_CBRT_TAB", 1 << 16), ("_LAB2_INV_GAMMA_TAB", 256),
                                         ("_LAB2_Y_TAB", -1), ("_SDIV_TAB", 1 << 24)])
def test_const_tables_refuse_values_that_do_not_fit(table, value, monkeypatch):
    tab = np.array(getattr(pcs, table))
    tab[7] = value
    monkeypatch.setattr(pcs, table, tab)
    with pytest.raises(ValueError, match="do not fit"):
        ppw.const_tables()


def test_kernel_constants_are_colorspaces():
    # the Lab coefficients G holds as immediates, and its sector selectors
    src = _kernel_source()

    def array(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return [int(v, 0) for v in body.replace("\n", " ").split(",")]

    assert array("kLabCoef") == [int(v) for v in np.ravel(pcs._LAB_COEF)]
    assert array("kLab2Coef") == [int(v) for v in np.ravel(pcs._LAB2_COEF)]
    sel = array("kSectorSel")
    assert len(sel) == 9  # floor(h * 6/180) for h <= 255
    for k, s in enumerate(sel):
        assert [(s >> (4 * c)) & 15 for c in range(3)] == list(pcs._SECTOR_DATA[k % 6]), k
    assert int(np.floor(np.float32(255) * np.float32(float.fromhex("0x1.111112p-5")))) <= 8


def test_hsv_indices_stay_in_the_gain_tables():
    # G reads the enhancer's H and S gain tables at BGR2HSV's hue and sat
    # with no mask: over all 2^24 triples (r a chunk at a time) hue lies in
    # [0, 180) and sat in [0, 255], by the kernel's integer formulas
    sdiv = np.asarray(pcs._SDIV_TAB, np.int64)
    hdiv = np.asarray(pcs._HDIV_TAB, np.int64)
    bg = np.arange(1 << 16, dtype=np.int64)
    b, g = bg & 255, bg >> 8
    lo, hi = [1 << 30] * 2, [-1] * 2
    for r in range(256):
        v = np.maximum(np.maximum(b, g), r)
        diff = v - np.minimum(np.minimum(b, g), r)
        sat = (diff * sdiv[v] + (1 << 11)) >> 12
        hnum = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
        hue = (hnum * hdiv[diff] + (1 << 11)) >> 12
        hue = hue + np.where(hue < 0, 180, 0)
        for k, a in enumerate((hue, sat)):
            lo[k], hi[k] = min(lo[k], int(a.min())), max(hi[k], int(a.max()))
    assert lo[0] >= 0 and hi[0] < 180 and lo[1] >= 0 and hi[1] <= 255, (lo, hi)


def _f32_add_down(x, c):
    """f32(x + c) rounded toward minus infinity (__fadd_rd), x and c f32."""
    exact = x.astype(np.float64) + np.float64(c)  # exact: both within 2^24 ulps of c
    r = exact.astype(np.float32)
    return np.where(r.astype(np.float64) > exact, np.nextafter(r, np.float32(-np.inf)), r)


def test_byte_tricks_equal_rounding_and_floor():
    # kernel G's u8f, to_u8 and floor_u8, on the values its steps reach:
    # every byte; products below 0 and above 255, halves and their
    # neighbouring f32s, NaN and the infinities for the rounding; every
    # HSV2BGR product (the four candidates over all table bytes) and a
    # spread of floats in (-2^22, 2^22) for the floor
    f32 = np.float32
    v = np.arange(256, dtype=np.uint32)
    np.testing.assert_array_equal(
        ((v | np.uint32(0x4B000000)).view(f32) - f32(2.0**23)), v.astype(f32))
    rng = np.random.default_rng(4)
    halves = np.arange(-4, 520, dtype=np.float64) / 2
    x = np.concatenate([
        halves, np.nextafter(halves.astype(f32), f32(np.inf)),
        np.nextafter(halves.astype(f32), f32(-np.inf)), rng.uniform(-300, 600, 20000),
        [np.nan, np.inf, -np.inf, 1e30, -1e30, -0.0],
    ]).astype(f32)
    with np.errstate(invalid="ignore"):
        clamped = np.minimum(np.maximum(np.nan_to_num(x, nan=0.0), f32(0)), f32(255))
        to_u8 = (clamped + f32(2.0**23)).view(np.uint32) & 255
        want = np.clip(np.rint(np.nan_to_num(x, nan=0.0, posinf=255, neginf=0)), 0, 255)
    np.testing.assert_array_equal(to_u8, want.astype(np.uint32))
    inv255 = f32(float.fromhex("0x1.010102p-8"))
    vv = (np.arange(256, dtype=f32) * inv255).astype(f32)
    ff = rng.uniform(0, 1, 4000).astype(f32)
    cand = np.concatenate([(vv * f32(255)).astype(f32),
                           (vv[:, None] * ff[None, :100]).astype(f32).ravel() * f32(255),
                           rng.uniform(-2.0**22 + 1, 2.0**22 - 1, 20000).astype(f32),
                           np.arange(-600, 600, dtype=f32) / f32(4)]).astype(f32)
    got = _f32_add_down(cand, f32(1.5 * 2.0**23)).view(np.uint32) & 255
    want = (np.floor(cand).astype(np.int64) & 255).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_kernel_g_is_bound():
    k = kernels.POINTWISE
    assert k in kernels.ALL and k.entry in kernels._SIGNATURES
    assert len(kernels._SIGNATURES[k.entry]) == 27
    assert "pointwise.cu" in kernels.SOURCES
    assert os.path.exists(os.path.join(REPO, k.source))
    for site in k.replaces.split("; "):
        path, rest = site.split(":")
        line, fn = rest.split(" ")
        with open(os.path.join(REPO, path)) as f:
            assert f.readlines()[int(line) - 1].startswith(f"def {fn}("), site


def test_op_layer_keeps_the_reference_positions():
    img = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 9, 40, 3),
                                                            dtype=np.uint8))
    m, bias = np.eye(3, dtype=np.float32) * 1.1, np.zeros(3, np.float32)
    mask = pvig.build_vignetting_mask(9, 40, 1.5, 1e-3, 1e-6)
    from raw_image_pipeline_tpu_torch.ops import color_calibration as pcc

    for fn, args in ((pcc.color_correct, (m, bias)), (pvig.correct, (mask,)),
                     (pce.enhance, (ENHANCER_GAINS,))):
        assert torch.equal(fn(img, *args), fn(img, *args, plain=True))
        with pytest.raises(TypeError):
            fn(img, *args, True)  # plain is keyword-only


def test_pointwise_bgr8_chain_config_is_config4():
    c = CHAINS["pointwise_bgr8"].config(48, 64)
    assert c.color_calibration.enabled and c.vignetting_correction.enabled
    assert ppipe.pointwise_steps(c, True, False) == ("calibration", "vignetting", "enhancer")


# --- the chain that ends on the stretch ----------------------------------------


@pytest.mark.parametrize("debug", [False, True], ids=["direct", "debug"])
def test_chain_without_remap_writes_its_output_and_equals_jax(debug):
    # config 4 (calibration, vignetting, enhancer on bgr8, no remap): the
    # stretch's last call writes straight into the [B, H, W, 3] output
    # (pointwise_planes(out=...); G on the card), except with debug dumps,
    # which stack the planes; both equal the JAX package's chain byte for
    # byte, keep_intermediates on
    import jax

    from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline

    hw = (24, 45)
    config = CHAINS["pointwise_bgr8"].config(*hw)
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    jp = jax_build_pipeline(config, "bgr8", frame_hw=hw, keep_intermediates=True, debug=debug)
    pp = tp.build_pipeline(config, "bgr8", hw, keep_intermediates=True, device="cpu",
                           debug=debug)
    pp.params = tp.params_from_numpy(jax.tree.map(np.asarray, jp.params), config, device="cpu")
    written = []
    real = ppw.pointwise_planes

    def spy(*planes, out=None, **kw):
        written.append(out is not None)
        return real(*planes, out=out, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ppipe, "pointwise_planes", spy)
        po, _ = pp(torch.as_tensor(frames), None)
    jo, _ = jp(frames, None)
    assert written[-1] is not debug and not any(written[:-1])
    assert set(po) == set(jo)
    for k in po:
        assert po[k].shape == np.asarray(jo[k]).shape, k
        assert int((po[k].numpy() != np.asarray(jo[k])).sum()) == 0, k
    assert po["processed"].is_contiguous() and po["processed"].shape == (2, *hw, 3)
