"""The port's mesh on the CPU against the JAX package (the counterparts of
tests/test_parallel.py): sharded calls over data, space and data x space
meshes of logical CPU shards (["cpu"] * n), held byte for byte against the
JAX package's unsharded chain on the same seeded frames, and their Kalman
state against the port's unsharded call (equal) and the JAX package's (as
test_torch_pipeline.assert_states_match holds it). Also the mesh's shapes
and errors, selected_impls and the dry run. The split's own rules (slab
boundaries, flips, the remap's windows) are tests/test_torch_spatial.py."""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
from test_torch_pipeline import _frames, _np, _run_both, _track_x, assert_states_match

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.config import PipelineConfig as JaxPipelineConfig
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state
from raw_image_pipeline_tpu_torch.parallel import (
    ShardedBatch,
    batch_sharding,
    make_mesh,
    shard_batch,
    spatial_sharding,
)
from raw_image_pipeline_tpu_torch.parallel import multihost
from raw_image_pipeline_tpu_torch.parallel.dryrun import dryrun_multichip
from raw_image_pipeline_tpu_torch.parallel.mesh import split_frames, split_rows

ENC = "bayer_gbrg8"
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread in this module, then as before: the
    suite's workers share the cores, and many small ops a shard on every
    core's thread each run several times slower than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grey_world(config_cls):
    """tests/test_parallel.py's configuration, in either package."""
    cfg = config_cls()
    return config_cls(
        debayer=cfg.debayer,
        white_balance=dataclasses.replace(cfg.white_balance, enabled=True, method="grey_world"),
        gamma_correction=dataclasses.replace(cfg.gamma_correction, enabled=True),
        color_enhancer=dataclasses.replace(cfg.color_enhancer, enabled=True,
                                           saturation_gain=1.3),
    )


def _sharded_run(config, hw, frames, mode, mesh, calls=2, **kw):
    """The frames in `calls` calls of the port's mesh build, the state
    carried: outputs gathered and concatenated, the states after each
    call."""
    pipe = tp.build_pipeline(config, ENC, hw, with_state=True, keep_intermediates=True,
                             temporal_mode=mode, mesh=mesh, **kw)
    n = frames.shape[0]
    state = tp.init_state(() if mode == "sequence" else (n // calls,), device="cpu")
    outs, states = [], []
    for chunk in np.split(frames, calls):
        out, state = pipe(torch.as_tensor(chunk), state)
        assert all(isinstance(v, ShardedBatch) for v in out.values())
        outs.append({k: _np(v.gather("cpu")) for k, v in out.items()})
        states.append(state)
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}, states


def _assert_against_reference(config, hw, frames, mode, mesh, **kw):
    """The mesh build equals the JAX package's unsharded chain byte for
    byte, and its state the port's unsharded state exactly (which
    assert_states_match holds to the JAX package's)."""
    jo, jstates, po, pstates, meas = _run_both(config, hw, frames, mode, with_state=True)
    so, sstates = _sharded_run(config, hw, frames, mode, mesh, **kw)
    assert set(so) == set(jo)
    for key in jo:
        assert so[key].shape == jo[key].shape, key
        assert int((so[key] != jo[key]).sum()) == 0, key  # 0 mismatching bytes
    for got, want in zip(sstates, pstates):
        for f in ("x", "p", "initialized"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert_states_match(jstates, sstates, mode, meas)


@pytest.fixture(scope="module")
def grey_frames():
    return np.random.default_rng(0).integers(0, 256, (8, 32, 48), np.uint8)


@pytest.fixture(scope="module")
def grey_reference(grey_frames):
    """The JAX package's unsharded grey-world chain on grey_frames."""
    jpipe = jax_build_pipeline(_grey_world(JaxPipelineConfig), ENC, frame_hw=(32, 48))
    return np.asarray(jpipe(grey_frames)[0]["processed"])


@pytest.mark.parametrize("layout", ["data", "space", "data_space"])
def test_grey_world_mesh_equals_reference(grey_frames, grey_reference, layout):
    """tests/test_parallel.py's data- and space-parallel cases: 32x48,
    B=8, over eight logical CPU shards."""
    space = {"data": 1, "space": 4, "data_space": 2}[layout]
    ref = grey_reference
    mesh = make_mesh(CPU8, space=space)
    pipe = tp.build_pipeline(_grey_world(tp.PipelineConfig), ENC, (32, 48), mesh=mesh)
    batch = shard_batch(grey_frames, mesh, spatial=space > 1)
    out, _ = pipe(batch)
    np.testing.assert_array_equal(_np(out["processed"].gather("cpu")), ref)
    # a batch split over data only, replicated over space: each shard
    # takes its slab of its replica
    out2, _ = pipe(shard_batch(grey_frames, mesh))
    np.testing.assert_array_equal(_np(out2["processed"].gather("cpu")), ref)


@pytest.mark.parametrize("temporal_mode", ["cameras", "sequence"])
def test_flagship_data_space_equals_reference(temporal_mode):
    """The full chain (flip 180 hoisted, CCC with its histogram summed over
    slabs, the Kalman track, the lerp remap's windows) at 112x96 over data
    2 x space 4, in two calls of B=2 with the state carried."""
    hw = (112, 96)
    frames = _frames(sum(hw), 4, *hw)
    _assert_against_reference(tp.flagship_config(*hw), hw, frames, temporal_mode,
                              make_mesh(CPU8, space=4))


def _variant(name, hw):
    c = tp.flagship_config(*hw)
    rep = dataclasses.replace
    if name.startswith("wb_"):
        return c.replace(white_balance=rep(c.white_balance, method=name[3:]),
                         flip=rep(c.flip, angle=270))
    if name == "gpu_parity":
        return c.replace(debayer=rep(c.debayer, algorithm="mht"),
                         gamma_correction=rep(c.gamma_correction, gpu=True, method="default"))
    return c


@pytest.mark.parametrize("name,kw", [
    ("wb_simple", {}), ("wb_grey_world", {}), ("wb_pca", {}), ("wb_learned", {}),
    ("gpu_parity", {}), ("flagship", {"debug": True}),
    ("flagship", {"microbatch": 3}),
])
def test_sharded_variants_equal_unsharded(name, kw):
    """The port's own unsharded build against its mesh build: the
    statistical white balances (the gather rule) behind a flip 270, the
    MHT demosaic (D's plain version, a 2-row halo), debug dumps, and a
    microbatch in "sequence" mode over two data shards (a first pass of
    every chunk's CCC measurement)."""
    hw = (48, 64)
    config = _variant(name, hw)
    frames = torch.as_tensor(_frames(len(name), 16, *hw))
    mesh = make_mesh(["cpu"] * 4, space=2)
    ref = tp.build_pipeline(config, ENC, hw, with_state=True, keep_intermediates=True,
                            temporal_mode="sequence", device="cpu", **kw)
    pipe = tp.build_pipeline(config, ENC, hw, with_state=True, keep_intermediates=True,
                             temporal_mode="sequence", mesh=mesh, **kw)
    rs = ss = tp.init_state((), device="cpu")
    for chunk in torch.split(frames, 8):
        ro, rs = ref(chunk, rs)
        so, ss = pipe(chunk, ss)
        assert set(so) == set(ro)
        for k in ro:
            assert torch.equal(so[k].gather("cpu"), ro[k]), k
        for f in ("x", "p", "initialized"):
            assert torch.equal(getattr(ss, f), getattr(rs, f)), f


@pytest.mark.parametrize("encoding,shape", [
    ("bgr8", (4, 48, 64, 3)), ("mono8", (4, 48, 64, 1)), ("bayer_gbrg16", (4, 48, 64)),
])
def test_sharded_encodings_equal_unsharded(encoding, shape):
    config = tp.flagship_config(48, 64)
    if encoding.endswith("16"):
        config = config.replace(debayer=dataclasses.replace(config.debayer, bayer16="scale8"))
    rng = np.random.default_rng(len(encoding))
    dtype = np.uint16 if encoding.endswith("16") else np.uint8
    frames = torch.as_tensor(rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype))
    ref = tp.build_pipeline(config, encoding, (48, 64), device="cpu")
    pipe = tp.build_pipeline(config, encoding, (48, 64), mesh=make_mesh(["cpu"] * 4, space=4))
    assert torch.equal(pipe(frames)[0]["processed"].gather("cpu"), ref(frames)[0]["processed"])


def test_mesh_shapes_and_errors():
    mesh = make_mesh(CPU8, space=2)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "space")
    assert mesh.shape == {"data": 4, "space": 2} and mesh.size == 8
    with pytest.raises(ValueError):
        make_mesh(CPU8, space=3)
    assert batch_sharding(mesh, 3).spec == ("data", None, None)
    assert spatial_sharding(mesh, 4).spec == ("data", "space", None, None)
    if not torch.cuda.is_available():
        # a CUDA mesh without a card raises; nothing falls back to the CPU
        for devices in (None, ["cuda:0"] * 2):
            with pytest.raises(RuntimeError, match="no CUDA device is available"):
                make_mesh(devices)
    # frames split as tensor_split splits them; slabs on even rows
    assert split_frames(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert [len(t) for t in torch.tensor_split(torch.zeros(5), 3)] == [2, 2, 1]
    assert split_rows(91, 4) == [(0, 24), (24, 48), (48, 70), (70, 91)]
    batch = shard_batch(np.arange(2 * 6 * 3).reshape(2, 6, 3), make_mesh(["cpu"] * 6, space=3),
                        spatial=True)
    assert batch.shape == (2, 6, 3) and set(batch.shards) == {(0, 0), (0, 1), (0, 2),
                                                             (1, 0), (1, 1), (1, 2)}
    assert batch.index[(1, 2)] == ((1, 2), (4, 6))
    # B=2 over data 4: two shards without frames launch nothing
    sparse = shard_batch(np.zeros((2, 4, 4), np.uint8), make_mesh(["cpu"] * 4))
    assert sorted(sparse.shards) == [(0, 0), (1, 0)]
    # too many slabs for the rows, and a space axis that disagrees
    with pytest.raises(ValueError, match="slabs"):
        tp.build_pipeline(tp.flagship_config(6, 8), ENC, (6, 8),
                          mesh=make_mesh(["cpu"] * 4, space=4))
    with pytest.raises(ValueError, match="spatial_shards"):
        tp.build_pipeline(tp.flagship_config(32, 48), ENC, (32, 48), mesh=mesh,
                          spatial_shards=4)


def test_selected_impls_and_spatial_shards():
    """selected_impls records what each shard runs: the plain versions on
    CPU shards (the kernels on card shards; the JAX package instead pins
    XLA formulations on any multi-device mesh). spatial_shards alone makes
    logical space shards on the build's device and changes no number."""
    hw = (112, 96)
    config = tp.flagship_config(*hw)
    mesh = make_mesh(["cpu"] * 2, space=2)
    pipe = tp.build_pipeline(config, ENC, hw, mesh=mesh)
    assert pipe.mesh is mesh
    assert pipe.selected_impls == {op: ("plain", "plain") for op in
                                   ("demosaic", "histogram", "response", "remap_blend")}
    pipe2 = tp.build_pipeline(config, ENC, hw, spatial_shards=4, device="cpu")
    assert pipe2.mesh.shape == {"data": 1, "space": 4}
    assert pipe2.selected_impls["demosaic"] == ("plain",) * 4
    pipe3 = tp.build_pipeline(config, ENC, hw, device="cpu")
    assert pipe3.mesh is None and pipe3.selected_impls["histogram"] == ("plain",)
    frames = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (4,) + hw, np.uint8))
    ref = pipe3(frames)[0]["processed"]
    for p in (pipe, pipe2):
        assert torch.equal(p(frames)[0]["processed"].gather("cpu"), ref)


def test_gloo_with_cuda_shards_only_when_asked():
    """A gloo group carries CUDA tensors only when initialize_multihost was
    asked for gloo; NCCL puts them on the rank's card."""
    cuda_like = mock.Mock(is_cuda=True)
    with mock.patch.object(multihost.dist, "get_backend", return_value="gloo"), \
            mock.patch.object(multihost, "_GLOO_ASKED", False):
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            multihost._backend_device(cuda_like)
    with mock.patch.object(multihost.dist, "get_backend", return_value="gloo"), \
            mock.patch.object(multihost, "_GLOO_ASKED", True):
        assert multihost._backend_device(cuda_like) == torch.device("cpu")
    # one process or none: a no-op, as in the JAX package
    assert multihost.initialize_multihost(None, 1, 0) is None


def test_dryrun_multichip_equals_reference():
    """dryrun_multichip(8) over eight logical CPU shards (data 4 x space 2,
    B=8 at 272x368) asserts sharded == unsharded itself; its outputs are
    also the JAX package's unsharded chain's, in both temporal modes."""
    import __graft_entry__ as ge

    results = dryrun_multichip(8, devices=CPU8)
    h, w = 272, 368
    pixels = np.random.default_rng(0).integers(0, 256, (8, h, w), np.uint8)
    jax_x = {}
    for mode, (processed, _) in results.items():
        jp = jax_build_pipeline(ge._full_config((h, w)), ENC, frame_hw=(h, w), with_state=True,
                                temporal_mode=mode)
        out, state = jp(pixels, jax_init_state((8,) if mode == "cameras" else ()))
        np.testing.assert_array_equal(_np(processed), np.asarray(out["processed"]))
        jax_x[mode] = np.asarray(state.x)
    # "cameras": a fresh track per frame, x = the frame's CCC peak; the
    # "sequence" track through those peaks as each package writes it
    meas = _np(results["cameras"][1])
    np.testing.assert_array_equal(meas, jax_x["cameras"])
    np.testing.assert_array_equal(_np(results["sequence"][1]), _track_x(meas, fused=False))
    assert any(np.array_equal(jax_x["sequence"], _track_x(meas, fused=f)) for f in (False, True))
    with pytest.raises(ValueError):
        dryrun_multichip(8, devices=["cpu"] * 4)
