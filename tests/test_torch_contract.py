"""The JAX package's call contract in the port, beyond ops/ (which
test_torch_op_layer.py covers): every public def and class method takes a
JAX-style call by position with the same meaning (util_contract's rule),
and the calls the port once refused or read otherwise now equal the JAX
package on the CPU: histograms of frames over kernel B's pixel limit
(through the run split on the plain version), float remaps of any channel
count (through the channel groups on the plain version), the batch-minor
remap, JAX-style positional calls of make_isp_fn, build_pipeline,
global_data_mesh and distribute_batch, and the batch runs that let every
kernel take batches past the grid's limit."""

import glob
import importlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _frames, assert_states_match
from util_contract import JAX_PKG, contract_problems, port_object, public_defs
from util_op_layer import assert_equal, image, to_np

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.ops import undistortion as jund
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state
from raw_image_pipeline_tpu.pipeline import make_isp_fn as jax_make_isp_fn
from raw_image_pipeline_tpu.pipeline import make_params as jax_make_params
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.ops import undistortion as pund
from raw_image_pipeline_tpu_torch.ops.common import image_planes
from raw_image_pipeline_tpu_torch.parallel.mesh import ShardedBatch
from raw_image_pipeline_tpu_torch.parallel.multihost import distribute_batch, global_data_mesh

# --- (a) the signatures -------------------------------------------------------

# modules of the JAX package (outside ops/) with no port, and why
NOT_PORTED_MODULES = {
    "tools/op_profile.py": "TPU op profiling; tools/profile_chains.py profiles the card",
    "tools/tpu_parity_check.py": "TPU parity; its card counterpart is "
                                 "tools/gpu_parity_check.py",
    "utils/compile_cache.py": "XLA's persistent compilation cache; eager PyTorch compiles "
                              "nothing",
}
# the port's own positional parameters that a reason allows
PORT_POSITIONAL = {
    ("tools/stream_bench.py", "main"): {
        "argv": "the command line, as every tool's main of the port takes it (the JAX "
                "tool reads sys.argv); main() still means the same"},
}
MODULES = sorted(
    os.path.relpath(p, JAX_PKG)
    for p in glob.glob(os.path.join(JAX_PKG, "**", "*.py"), recursive=True)
    if not p.endswith("__init__.py") and os.sep + "ops" + os.sep not in p)


@pytest.mark.parametrize("module", MODULES)
def test_every_public_def_takes_a_jax_call(module):
    defs = public_defs(os.path.join(JAX_PKG, module))
    if module in NOT_PORTED_MODULES:
        port = os.path.join(os.path.dirname(JAX_PKG), "raw_image_pipeline_tpu_torch", module)
        assert NOT_PORTED_MODULES[module] and not os.path.exists(port), module
        return
    pmod = importlib.import_module("raw_image_pipeline_tpu_torch."
                                   + module[:-3].replace(os.sep, "."))
    for name, jsig in defs.items():
        fn = port_object(pmod, name)
        assert fn is not None, f"{module}: no counterpart of {name}"
        allowed = PORT_POSITIONAL.get((module, name), {})
        problems = contract_problems(jsig, fn, port_positional=allowed)
        assert not problems, f"{module}:{name}: {problems}"


def test_recorded_reasons_name_real_parameters():
    for (module, name), params in PORT_POSITIONAL.items():
        fn = port_object(importlib.import_module(
            "raw_image_pipeline_tpu_torch." + module[:-3].replace(os.sep, ".")), name)
        assert set(params) <= set(fn.__code__.co_varnames), (module, name)
        assert name in public_defs(os.path.join(JAX_PKG, module))


# --- (b) histograms of frames over kernel B's limit ---------------------------

# (frame size, pixels a run may hold): runs tiling the frame as views
# (600 = 3 x 200, 629 = 17 x 37), a tail run (667 = 2 x 300 + 67), one run
HIST_CASES = [((20, 30), 250), ((17, 37), 100), ((23, 29), 300), ((10, 12), 300)]


@pytest.mark.parametrize("lead", [(3,), (2, 2)], ids=["3", "2x2"])
@pytest.mark.parametrize("hw,limit", HIST_CASES, ids=[f"{h}x{w}-{n}" for (h, w), n in HIST_CASES])
def test_histogram_runs_equal_reference(hw, limit, lead):
    h, w = hw
    x = image(h * w + limit, lead, h, w)
    want = np.asarray(jccc.log_chroma_histogram(x))
    _, planes = image_planes(torch.as_tensor(x))
    planes = [p.contiguous() for p in planes]  # as log_chroma_histogram_planes passes them
    calls = []

    def hist_fn(b, g, r, *args):
        assert b.shape[-2] * b.shape[-1] <= limit and b.is_contiguous()
        calls.append(tuple(b.shape))
        return pccc.log_chroma_histogram_plain(b, g, r, *args)

    cuts = (float(np.float32(255.0 * t)) for t in (0.9, 0.1))
    got = pccc.log_chroma_histogram_runs(*planes, *cuts, pccc.UV0, None, hist_fn, limit)
    assert_equal(got.reshape(tuple(lead) + got.shape[-2:]), want)
    run, k = pccc.pixel_runs(h * w, limit) if h * w > limit else (h * w, 1)
    n = int(np.prod(lead))
    assert calls[0] == ((n * k, 1, run) if k > 1 else (n, h, w))
    assert len(calls) == (2 if run * k < h * w else 1)


def test_pixel_runs():
    assert pccc.pixel_runs(1080 * 1920, pccc.HIST_KERNEL_MAX_PIXELS) == (518400, 4)
    assert pccc.pixel_runs(727 * 1001, pccc.HIST_KERNEL_MAX_PIXELS) == (103961, 7)
    assert pccc.pixel_runs(600011, pccc.HIST_KERNEL_MAX_PIXELS) == (524160, 1)  # a prime
    for n, limit in ((667, 300), (629, 100), (600, 250), (10007, 16)):
        run, k = pccc.pixel_runs(n, limit)
        assert run <= limit and 0 <= n - run * k < run


# --- (c) float remaps of any channel count, batch-minor --------------------

def _maps(seed, h, w, ho, wo):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ho, 0:wo].astype(np.float64)
    mx = (xx + 0.5) * (w + 3) / wo - 2.0 + 1.5 * np.sin(yy / 7) + rng.normal(0, 0.3, (ho, wo))
    my = (yy + 0.5) * (h + 3) / ho - 2.0 + 1.5 * np.cos(xx / 9) + rng.normal(0, 0.3, (ho, wo))
    return mx.astype(np.float32), my.astype(np.float32)


H, W, OUT_HW = 29, 37, (27, 41)


def _camera_maps(cameras, mode="float", precompute=jund.remap_precompute):
    maps = [precompute(*_maps(11 + z, H, W, *OUT_HW), (H, W), mode=mode)
            for z in range(cameras)]
    if cameras == 1:
        return maps[0]
    return np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])


@pytest.mark.parametrize("cameras", [1, 2])
@pytest.mark.parametrize("c", [2, 4, 5])
def test_float_remap_channel_groups_equal_reference(c, cameras):
    base, weights = _camera_maps(cameras)
    x = image(c * 10 + cameras, (4,), H, W, c)
    want = jund.remap_bilinear_u8(x, jnp.asarray(base), jnp.asarray(weights), OUT_HW,
                                  n_cameras=cameras, mode="float")
    planes = tuple(torch.as_tensor(x[..., k]) for k in range(c))
    groups = []

    def remap_fn(group):  # kernel E's contract: one or three planes
        assert len(group) in (1, 3)
        groups.append(len(group))
        return pund.remap_planes(group, torch.as_tensor(base), torch.as_tensor(weights),
                                 OUT_HW, "float", plain=True)

    assert_equal(pund.remap_channel_groups(planes, remap_fn), want)
    assert groups == {2: [1, 1], 4: [3, 1], 5: [3, 1, 1]}[c]


@pytest.mark.parametrize("cameras", [1, 2])
def test_batch_minor_remap_equals_reference(cameras):
    base, weights = _camera_maps(cameras)
    lead = (4,) if cameras > 1 else (2, 3)
    x = np.ascontiguousarray(np.moveaxis(image(40 + cameras, lead, H, W), (-3, -2), (0, 1)))
    # the JAX positions: src_hw, batch_minor, tuning, n_cameras, blend_impl, mode
    args = ((H, W), True, (4, 300), cameras, "pallas", "float")
    want = jund.remap_bilinear_u8(x, jnp.asarray(base), jnp.asarray(weights), OUT_HW, *args)
    got = pund.remap_bilinear_u8(torch.as_tensor(x), base, weights, OUT_HW, *args)
    assert_equal(got, want)
    assert got.shape == ((cameras, *OUT_HW, 2, 3) if cameras > 1 else (*OUT_HW, 2, 3, 3))


def test_remap_planes_takes_the_jax_positions():
    base, weights = _camera_maps(1, "lerp")
    x = image(5, (2,), H, W)
    planes = tuple(np.ascontiguousarray(np.moveaxis(x[..., k], 0, -1)) for k in range(3))
    args = ((H, W), (2, 100), 1, "xla", "lerp")  # src_hw, tuning, n_cameras, blend_impl, mode
    want = jund.remap_bilinear_u8_planes(planes, jnp.asarray(base), jnp.asarray(weights),
                                         OUT_HW, *args)
    got = pund.remap_bilinear_u8_planes(tuple(map(torch.as_tensor, planes)), base, weights,
                                        OUT_HW, *args)
    assert_equal(got, want)


# --- (d) the chain's entry points at the JAX positions ----------------------

HW = (24, 32)


@pytest.fixture(scope="module")
def chain_case():
    config = tp.flagship_config(*HW)
    return config, _frames(71, 4, *HW)


def _run_port(fn, frames, state):
    """fn(frames, state) with the port's Kalman scan watched: outputs as
    numpy (sharded ones gathered), the state and the first scan's peaks."""
    with mock.patch.object(pccc, "kalman_scan", wraps=pccc.kalman_scan) as scan:
        out, st = fn(frames, state)
    out = {k: to_np(v.gather("cpu") if isinstance(v, ShardedBatch) else v)
           for k, v in out.items()}
    return out, st, to_np(scan.call_args_list[0].args[1])


def _assert_chain_equal(jo, js, po, ps, meas):
    assert set(po) == set(jo)
    for key in jo:
        assert_equal(po[key], np.asarray(jo[key]))
    assert_states_match([js], [ps], "sequence", meas)


def test_make_isp_fn_takes_the_jax_positions(chain_case):
    """planar_internals=False, a remap_tuning of four slots in chunks of 300
    and mesh_devices=2 change the JAX program, not its bytes; the port takes
    the same positional call."""
    config, frames = chain_case
    args = (config, "bayer_gbrg8", True, True, False, "sequence", HW, False, (4, 300), 1, 2)
    jparams = jax_make_params(config, HW)
    jo, js = jax.jit(jax_make_isp_fn(*args))(jparams, jnp.asarray(frames), jax_init_state(()))
    params = tp.params_from_numpy(jax.tree.map(np.asarray, jparams), config, device="cpu")
    fn = tp.make_isp_fn(*args)
    po, ps, meas = _run_port(lambda f, s: fn(params, f, s), torch.as_tensor(frames),
                             tp.init_state((), device="cpu"))
    _assert_chain_equal(jo, js, po, ps, meas)


def test_build_pipeline_and_data_mesh_take_the_jax_positions(chain_case):
    """build_pipeline by position up to temporal_mode (donate in its JAX
    place), and over a two-shard data mesh from global_data_mesh("data")
    fed by distribute_batch(frames, mesh, "data"): the JAX chain's bytes and
    Kalman state."""
    config, frames = chain_case
    args = (config, "bayer_gbrg8", HW, True, True, None, False, False, "sequence")
    jo, js = jax_build_pipeline(*args)(frames, jax_init_state(()))
    pipe = tp.build_pipeline(*args, None, None, None, device="cpu")
    po, ps, meas = _run_port(pipe, torch.as_tensor(frames), tp.init_state((), device="cpu"))
    _assert_chain_equal(jo, js, po, ps, meas)

    mesh = global_data_mesh("data", devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "space": 1}
    sharded = tp.build_pipeline(config, "bayer_gbrg8", HW, True, True, None, True, False,
                                "sequence", None, mesh)
    batch = distribute_batch(frames, mesh, "data")
    assert batch.local_frames() == (0, 4)
    po, ps, meas = _run_port(sharded, batch, tp.init_state((), device="cpu"))
    _assert_chain_equal(jo, js, po, ps, meas)


def test_data_mesh_refuses_another_axis_name():
    with pytest.raises(ValueError, match="axis='batch'"):
        global_data_mesh("batch", devices=["cpu"])
    mesh = global_data_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="axis='space'"):
        distribute_batch(np.zeros((2, 4, 4), np.uint8), mesh, "space")


# --- (e) batches past the grid's limit --------------------------------------

@pytest.mark.parametrize("n", [0, 1, 6, 7, 8, 20])
@pytest.mark.parametrize("limit", [1, 7, None], ids=["1", "7", "n"])
def test_batch_runs_cover_the_batch(n, limit):
    limit = limit or max(n, 1)
    runs = list(kernels.batch_runs(n, limit))
    assert [s for s, _ in runs] == list(range(0, n, limit))
    assert sum(k for _, k in runs) == n and all(0 < k <= limit for _, k in runs)
    assert list(kernels.batch_runs(n)) == ([(0, n)] if n else [])  # MAX_BATCH
    with pytest.raises(ValueError):
        list(kernels.batch_runs(n, 0))


@pytest.mark.parametrize("batch,cameras,limit", [
    (12, 1, 5), (12, 3, 3), (12, 4, 3), (12, 4, 4), (kernels.MAX_BATCH + 2, 1, kernels.MAX_BATCH),
    (0, 2, 3)])
def test_remap_launches_stay_inside_a_camera(batch, cameras, limit):
    launches = pund.remap_launches(batch, cameras, limit)
    per = batch // cameras
    frames = []
    for f0, nf, cams, z in launches:
        if cams > 1:  # one launch of every camera's block
            assert launches == [(0, batch, cameras, None)] and per <= limit
        else:
            assert nf <= limit and (z is None) == (cameras == 1)
            assert (z or 0) * per <= f0 and f0 + nf <= ((z or 0) + 1) * per
        frames += range(f0, f0 + nf)
    assert frames == list(range(batch))


# --- (f) on the card: the runs and the groups launch the kernels ---------------

@pytest.mark.cuda
def test_runs_and_groups_equal_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from raw_image_pipeline_tpu_torch.ops import debayer as pdeb

    dev, phase = "cuda", pdeb.phase_for_encoding("bayer_gbrg8")
    rng = np.random.default_rng(3)
    bayer = torch.as_tensor(rng.integers(0, 256, (20, 6, 8), dtype=np.uint8), device=dev)
    for cuda_fn, plain_fn in ((pdeb.debayer_bilinear_cuda, pdeb.debayer_bilinear_planar),
                              (pdeb.debayer_mht_cuda, pdeb.debayer_mht_planar)):
        assert torch.equal(cuda_fn(bayer, phase, batch_limit=7), plain_fn(bayer, phase))
    planes = [torch.as_tensor(rng.integers(0, 256, (20, 13, 17), dtype=np.uint8), device=dev)
              for _ in range(3)]
    cuts = (229.5, 25.5, pccc.UV0)
    hist = pccc.log_chroma_histogram_cuda(*planes, *cuts, batch_limit=7)
    assert torch.equal(hist, pccc.log_chroma_histogram_plain(*planes, *cuts))
    runs = pccc.log_chroma_histogram_runs(*planes, *cuts, None, pccc.log_chroma_histogram_cuda,
                                          limit=50)
    assert torch.equal(runs, hist)
    x = torch.as_tensor(image(8, (4,), H, W, 5), device=dev)
    base, weights = _camera_maps(2, precompute=pund.remap_precompute)  # the card has no jax
    got = pund.remap_bilinear_u8(x, base, weights, OUT_HW, n_cameras=2, mode="float")
    assert torch.equal(got, pund.remap_bilinear_u8(x, base, weights, OUT_HW, n_cameras=2,
                                                   mode="float", plain=True))
