"""The chain's CCC range around kernels B and C: the working resize (kernel
H's plain version, ops/resize.py), the response's argmax (kernel I's,
ops/ccc.response_argmax_plain) and the Kalman track with the gains (kernel
J's, ops/ccc.track_plain), held to the JAX package on the CPU, and each
kernel held to its plain version on a CUDA card (the cuda-marked tests,
skipped without one).

On the CPU, at small sizes and on seeded numpy inputs:
  * the resize at the flagship's ratios scaled down (4 and 16/3: 108x192 ->
    27x36; 4 and 4: 108x144 -> 27x36), at an odd size and at an upsample,
    0 mismatching bytes against JAX resize_linear_u8_plane, and every slab
    (y0, y1, row0) of a 2- and a 4-way row split equal to those rows of the
    whole frame; kernel H's table (resize_table) equal to the plain
    version's; its rows path's bands (resize_bands: every output row's sy
    and sy2 staged, for the chain's shapes and the mesh's slabs), a numpy
    model of the rows path (its staging byte for byte, its arithmetic from
    there) equal to the plain version, and its choice of path
    (resize_path);
  * the argmax on planted ties, +0.0/-0.0, frames of equal values, -inf,
    +inf and NaNs against JAX response_argmax (jnp.argmax's rule), and a
    numpy model of kernel I's reduction (a cluster's blocks each scanning a
    slice of the frame, a thread's strided scan, the warps' shuffle trees,
    then rank 0's tree over the blocks) equal to it at every cluster size,
    also on traps planted across the slices' boundaries; the cluster size
    kernel I picks (argmax_cluster); kernel I's dtype codes equal to its C
    entry's;
  * the track walked as kernel J walks it (row t * steps + s is step s of
    track t) in the "cameras", "sequence", camera-blocked and gathered
    layouts and without the filter: the gains and the state equal to
    kalman_scan / kalman_update + gains_from_uv_table as the chain called
    them before, to a numpy model of J's arithmetic
    (every operation rounded to f32, none fused), and to JAX kalman_scan /
    kalman_update within the recorded 1-ulp rule (test_torch_pipeline.
    assert_states_match).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.ops import resize as jres
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.ops import resize as pres
from raw_image_pipeline_tpu_torch.parallel.mesh import split_rows
from raw_image_pipeline_tpu_torch.parallel.spatial import resize_slab
from test_torch_pipeline import _p_after, _track_x, assert_states_match

F32 = np.float32
DST = (27, 36)  # the working resize's 270x360 scaled down by 10
# (B, H, W): the flagship's ratios (1080x1920 and 1080x1440 -> 270x360)
# scaled down, an odd size, an upsample
RESIZE_SHAPES = [(3, 108, 192), (2, 108, 144), (2, 97, 131), (2, 13, 17)]
UV0 = F32(-1.421875)
EXP_TAB = pccc.exp_table(float(UV0))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --- the working resize (kernel H's plain version) -------------------------


@pytest.mark.parametrize("b,h,w", RESIZE_SHAPES)
def test_resize_planes_equal_jax(b, h, w):
    x = _u8(h * w, (b, 3, h, w))
    want = [np.asarray(jres.resize_linear_u8_plane(x[:, c], *DST)) for c in range(3)]
    # the chain's views of a [B, 3, H, W] tensor, three planes in one call
    got = pres.resize_planes([torch.as_tensor(x)[:, c] for c in range(3)], h, *DST)
    for g, wnt in zip(got, want):
        assert g.shape == (b,) + DST and g.dtype == torch.uint8
        assert int((g.numpy() != wnt).sum()) == 0
    # the op layer: a plane, and [..., H, W, 3] frames (strided planes)
    plane = pres.resize_linear_u8_plane(torch.as_tensor(x[:, 1]), *DST)
    assert np.array_equal(plane.numpy(), want[1])
    nhwc = pres.resize_linear_u8(torch.as_tensor(np.ascontiguousarray(x.transpose(0, 2, 3, 1))),
                                 *DST)
    assert np.array_equal(nhwc.numpy(), np.stack(want, -1))


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("b,h,w", RESIZE_SHAPES[:1] + RESIZE_SHAPES[2:3])
def test_resize_slabs_equal_the_whole_frame(b, h, w, space):
    x = torch.as_tensor(_u8(space + h, (b, h, w)))
    whole = pres.resize_planes([x], h, *DST)[0]
    for r0, r1 in split_rows(h, space):
        y0, y1, a, e = resize_slab(h, DST[0], r0, r1)
        got = pres.resize_planes([x[:, a:e]], h, *DST, y0, y1, a)[0]
        assert torch.equal(got, whole[:, y0:y1]), (r0, r1)


@pytest.mark.parametrize("src,slab", [((108, 192), (0, 27, 0)), ((108, 192), (7, 19, 26)),
                                      ((13, 17), (3, 11, 0)), ((97, 131), (0, 0, 0))])
def test_resize_table_is_the_plain_tables_narrowed(src, slab):
    (h, w), (y0, y1, row0) = src, slab
    table = pres.resize_table(h, w, *DST, y0, y1, row0)
    (sx, sx2, a0, a1), (sy, sy2, b0, b1) = pres._rows_on(h, w, *DST, "cpu", y0, y1, row0)
    assert table.dtype == np.int32 and table.shape == (4 * DST[1] + 4 * (y1 - y0),)
    want = np.concatenate([t.numpy() for t in (sx, sx2, a0, a1, sy, sy2, b0, b1)])
    assert np.array_equal(table, want.astype(np.int64))
    on, lo, hi = pres._resize_table_on(h, w, *DST, "cpu", y0, y1, row0)
    assert np.array_equal(on.numpy(), table)
    if y1 > y0:
        assert (lo, hi) == (int(min(sy.min(), sy2.min())), int(max(sy.max(), sy2.max())))


# the chain's shapes (1080x1920, 1080x1440), an odd crop and an upsample at
# the working resize's full 270x360, as kernel H's rows path sees them
BAND_SHAPES = [(1080, 1920), (1080, 1440), (1079, 1439), (91, 117)]


def _slabs(h, space):
    """(y0, y1, row0) of the whole frame and of each slab of a space-way
    row split (the mesh's)."""
    return [(0, 270, 0)] + [resize_slab(h, 270, r0, r1)[:3] for r0, r1 in split_rows(h, space)]


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("h,w", BAND_SHAPES)
def test_resize_bands_cover_the_tables_rows(h, w, space):
    """Kernel H's bands (resize_bands): for every output row of the frame
    and of each mesh slab, the band's staged rows hold the table's sy and
    sy2 (the clamped vertical border included) at the slots the band gives,
    each staged row is distinct and tapped by the band, and the rows fit the
    rows path's shared memory for three planes."""
    for y0, y1, row0 in _slabs(h, space):
        table = pres.resize_table(h, w, 270, 360, y0, y1, row0)
        n = y1 - y0
        sy, sy2 = table[4 * 360:4 * 360 + n], table[4 * 360 + n:4 * 360 + 2 * n]
        slots, bands = pres.resize_bands(table, 360)
        br = pres.BAND_ROWS
        assert bands.dtype == np.int32 and bands.shape == (-(-n // br), slots + 2 * br)
        assert slots <= 2 * br
        assert pres.resize_path(1, 1, w, 3, slots) == "rows"
        for y in range(n):
            band = bands[y // br]
            staged = band[:slots]
            q0, q1 = band[slots + 2 * (y % br)], band[slots + 2 * (y % br) + 1]
            assert staged[q0] == sy[y] and staged[q1] == sy2[y], (y0, y1, row0, y)
        for k, band in enumerate(bands):
            staged = band[:slots][band[:slots] >= 0]
            tapped = set(sy[k * br:(k + 1) * br]) | set(sy2[k * br:(k + 1) * br])
            assert len(set(staged)) == len(staged) and set(staged) == tapped
            assert np.all(band[slots + 2 * min(br, n - k * br):] == -1)
        if y0 == 0 and y1 == 270 and h < 270:  # an upsample: the border rows clamp
            assert sy[0] == 0 and sy2[-1] == h - 1


def _rows_path_model(x, src_h, y0, y1, row0, shift):
    """Kernel H's rows path in numpy on planes x [N, h, W] u8 whose rows
    start `shift` + row * W bytes past a 16-byte boundary: each band's
    staged rows copied in the kernel's 16-byte chunks (whole chunks inside
    the row, byte copies at its head and tail) into a buffer of row_pitch
    bytes a row, byte i of a row at its address % 16 + i, then each output
    pixel from that buffer with the table's integer arithmetic."""
    nb, h, w = x.shape
    table = pres.resize_table(src_h, w, 270, 360, y0, y1, row0)
    rows = y1 - y0
    sx, sx2, a0, a1 = (table[k * 360:(k + 1) * 360].astype(np.int64) for k in range(4))
    b0 = table[4 * 360 + 2 * rows:4 * 360 + 3 * rows].astype(np.int64)
    b1 = table[4 * 360 + 3 * rows:4 * 360 + 4 * rows].astype(np.int64)
    slots, bands = pres.resize_bands(table, 360)
    pitch, br = pres.row_pitch(w), pres.BAND_ROWS
    out = np.zeros((nb, rows, 360), np.uint8)
    for f in range(nb):
        for k, band in enumerate(bands):
            buf = np.full((slots, pitch), 0xEE, np.uint8)  # bytes no row fills
            off = {}
            for q, row in enumerate(band[:slots]):
                if row < 0:
                    continue
                lo = shift + (f * h + row) * w  # the row's address, the planes at 0
                first = lo - lo % 16
                off[q] = lo - first
                for c0 in range(first, lo + w, 16):
                    d = c0 - first
                    if c0 >= lo and c0 + 16 <= lo + w:  # a 16-byte copy
                        buf[q, d:d + 16] = x[f, row, c0 - lo:c0 - lo + 16]
                    else:
                        for b in range(max(c0, lo), min(c0 + 16, lo + w)):
                            buf[q, b - first] = x[f, row, b - lo]
            for yy in range(min(br, rows - k * br)):
                y = k * br + yy
                q0, q1 = band[slots + 2 * yy], band[slots + 2 * yy + 1]
                r0 = buf[q0, off[q0]:].astype(np.int64)
                r1 = buf[q1, off[q1]:].astype(np.int64)
                s0 = (r0[sx] * a0 + r0[sx2] * a1) >> 4
                s1 = (r1[sx] * a0 + r1[sx2] * a1) >> 4
                v = (((b0[y] * s0) >> 16) + ((b1[y] * s1) >> 16) + 2) >> 2
                out[f, y] = np.clip(v, 0, 255)
    return out


@pytest.mark.parametrize("h,w,shift", [(108, 192, 0), (97, 131, 5), (13, 17, 15), (3, 5, 9),
                                       (121, 1439, 1)])
def test_rows_path_model_equals_plain(h, w, shift):
    """A numpy model of kernel H's rows path (its staging into shared
    memory, byte for byte, and its arithmetic from there) equal to the plain
    version on the whole frame and on each slab of a 2-way split: rows off
    a 16-byte boundary, odd widths, upsamples and clamped border rows."""
    x = _u8(h * w + shift, (2, h, w))
    for y0, y1, row0 in [(0, 270, 0)] + [resize_slab(h, 270, r0, r1)[:3]
                                         for r0, r1 in split_rows(h, 2)]:
        lo, hi = pres._resize_table_on(h, w, 270, 360, "cpu", y0, y1, row0)[1:]
        slab = x[:, row0:row0 + hi + 1]
        want = pres.resize_linear_u8_rows(torch.as_tensor(slab), h, 270, 360, y0, y1, row0)
        got = _rows_path_model(slab, h, y0, y1, row0, shift)
        assert np.array_equal(got, want.numpy()), (y0, y1, row0)


def _strides(t):
    return t.reshape((-1,) + tuple(t.shape[-2:])).stride()


def test_resize_path_choice():
    """Kernel H's path (resize_path) for the planes resize_rows_cuda is
    given: the chain's planes, a mesh slab and odd widths take the rows
    path from ROWS_MIN_BATCH frames on and the gather path below (faster
    there); the op layer's [..., H, W, 3] frames (read as planes of column
    stride 3, or written interleaved) and rows too wide for the shared
    memory take the gather path at any batch."""
    def path(planes, out_col=1):
        h, w = planes[0].shape[-2:]
        slots = pres.resize_bands(pres.resize_table(h, w, 270, 360, 0, 270, 0), 360)[0]
        return pres.resize_path(_strides(planes[0])[-1], out_col, w, min(3, len(planes)), slots,
                                planes[0].shape[0])

    chain = torch.zeros((pres.ROWS_MIN_BATCH, 3, 1080, 1920), dtype=torch.uint8)
    assert path([chain[:, c] for c in (2, 1, 0)]) == "rows"
    assert path([chain[:4, c] for c in (2, 1, 0)]) == "gather"  # the flagship's B=4
    slab = chain[:, :, 268:542]
    assert path([slab[:, c] for c in range(3)]) == "rows"
    odd = torch.zeros((pres.ROWS_MIN_BATCH, 3, 1079, 1439), dtype=torch.uint8)
    assert path([odd[:, c] for c in range(3)]) == "rows"
    assert path([odd[:pres.ROWS_MIN_BATCH - 1, c] for c in range(3)]) == "gather"
    nhwc = torch.zeros((64, 1080, 1920, 3), dtype=torch.uint8)
    assert path(nhwc.unbind(-1)) == "gather"  # column stride 3 in
    assert path([chain[:, c] for c in range(3)], out_col=3) == "gather"  # interleaved out
    wide = torch.zeros((64, 1080, 1 << 12), dtype=torch.uint8)
    assert path([wide] * 3) == "gather"  # too wide
    assert path([wide]) == "rows"  # one plane fits
    assert pres.row_pitch(1920) == 1952 and pres.row_pitch(1) == 32
    assert pres.ROWS_MIN_BATCH == 9  # the crossover chip_smoke.py times on an H100


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        pres.resize_rows_cuda([x], 8, 4, 4, 0, 4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        pccc.response_argmax_cuda(torch.zeros((1, 256, 256)))
    with pytest.raises(ValueError, match="CUDA"):
        pccc.track_cuda(torch.zeros((1, 2), dtype=torch.int32),
                        torch.as_tensor(EXP_TAB), None, track_shape=(1,))


# --- the argmax (kernel I's plain version) ---------------------------------


N2 = 256 * 256


def _planted(seed):
    """Frames that test the first-occurrence rule: ties, +0.0/-0.0, equal
    values, -inf, +inf, NaNs, a peak at the last index, and ties across a
    warp's and a block's reduction boundaries."""
    r = np.random.default_rng(seed).normal(0, 1, (12, N2)).astype(F32)
    r[0, [1234, 40000]] = 50.0
    r[1] = 5.0
    r[2] = -np.inf
    r[3] = -1.0
    r[3, 9000], r[3, 700] = 0.0, -0.0
    r[4] = -1.0
    r[4, 700], r[4, 9000] = 0.0, -0.0
    r[5, [30000, 60000]] = np.nan
    r[6, 0], r[6, N2 - 1] = 1e38, np.nan
    r[7, 0] = np.nan
    r[8, [100, 200]] = np.inf
    r[9, N2 - 1] = 100.0
    r[10] = -0.0
    r[10, 5] = 0.0
    r[11, [31, 32, 1023, 1024, 4095]] = 20.0
    return r.reshape(12, 256, 256)


def _better(v, i, w, j):
    """Kernel I's order: NaN above every number, then the larger value,
    then the lower index."""
    vn, wn = np.isnan(v), np.isnan(w)
    num = ~vn & ~wn
    return np.where(vn | wn, vn & (~wn | (i < j)), num & ((v > w) | ((v == w) & (i < j))))


def _warp_tree(best, at):
    """A shuffle-down tree over the last axis's 32 lanes: lane 0's result."""
    for d in (16, 8, 4, 2, 1):
        v = np.concatenate([best[..., d:], best[..., -d:]], -1)  # lanes past 31 keep theirs
        i = np.concatenate([at[..., d:], at[..., -d:]], -1)
        lanes = np.arange(32) + d < 32
        take = lanes & _better(v, i, best, at)
        best, at = np.where(take, v, best), np.where(take, i, at)
    return best[..., 0], at[..., 0]


def _kernel_i_model(frame, cluster=1, per_load=4):
    """Kernel I's reduction in numpy: block r of the frame's `cluster`
    blocks takes the r-th 1/cluster slice; each of its 1024 threads scans
    its 16-byte groups (`per_load` values) in index order keeping the first
    best, from the sentinel (-inf, index N) where it has none; then a
    shuffle-down tree in each warp and one over the 32 warps' results; then
    rank 0's first warp over the blocks' pairs (the sentinel past the
    last rank)."""
    flat = frame.reshape(-1)
    slice_ = N2 // cluster
    loads = slice_ // per_load  # 16-byte loads a block
    passes = -(-loads // 1024)
    k = np.arange(passes * 1024).reshape(passes, 1024)  # [pass, thread]: load index
    idx = (np.arange(cluster)[:, None, None, None] * slice_ + per_load * k[None, :, :, None]
           + np.arange(per_load))  # [rank, pass, thread, lane of the group]
    live = np.broadcast_to(k[None, :, :, None] < loads, idx.shape)
    best = np.full((cluster, 1024), -np.inf, F32)
    at = np.full((cluster, 1024), N2)
    for p in range(passes):
        for q in range(per_load):
            i = idx[:, p, :, q]
            v = flat[np.where(live[:, p, :, q], i, 0)]
            take = live[:, p, :, q] & _better(v, i, best, at)
            best, at = np.where(take, v, best), np.where(take, i, at)
    best, at = _warp_tree(best.reshape(cluster, 32, 32), at.reshape(cluster, 32, 32))
    best, at = _warp_tree(best, at)  # [rank]: each block's pair
    lanes = np.full(32, -np.inf, F32), np.full(32, N2)
    lanes[0][:cluster], lanes[1][:cluster] = best, at
    _, at = _warp_tree(*lanes)
    return np.array([at % 256, at // 256], np.int32)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_argmax_rule_equals_jax_and_the_kernels_reduction(cluster):
    frames = np.concatenate([_planted(1), np.random.default_rng(2).normal(
        0, 1, (2, 256, 256)).astype(F32)])
    want = np.asarray(jccc.response_argmax(jnp.asarray(frames)))
    got = pccc.response_argmax(torch.as_tensor(frames))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(pccc.response_argmax_plain(torch.as_tensor(frames)).numpy(), want)
    flat = np.argmax(frames.reshape(len(frames), -1), axis=-1)  # numpy's rule, the same
    assert np.array_equal(want, np.stack([flat % 256, flat // 256], -1))
    assert want[:11].tolist() == [[1234 % 256, 1234 // 256], [0, 0], [0, 0], [700 % 256, 2],
                                  [700 % 256, 2], [30000 % 256, 30000 // 256], [255, 255],
                                  [0, 0], [100, 0], [255, 255], [0, 0]]
    for f, w in zip(frames, want):
        assert np.array_equal(_kernel_i_model(f, cluster), w)
    # leading dims
    lead = pccc.response_argmax(torch.as_tensor(frames[:12].reshape(3, 4, 256, 256)))
    assert np.array_equal(lead.numpy().reshape(12, 2), want[:12])


def _jax_peaks(frames):
    return np.asarray(jccc.response_argmax(jnp.asarray(frames)))


# each trap of workloads.argmax_across_slices at the first slice boundary s
# of a cluster (N2 / cluster): the index jnp.argmax must give
def _traps_at(cluster):
    s = N2 // cluster if cluster > 1 else N2 // 2
    return [("equal maxima in two slices", {s - 5: 50.0, s + 5: 50.0}, s - 5),
            ("-0.0 then +0.0 across the boundary", {"fill": -1.0, s - 1: -0.0, s: 0.0}, s - 1),
            ("+0.0 then -0.0 across the boundary", {"fill": -1.0, s - 1: 0.0, s: -0.0}, s - 1),
            ("NaNs in two slices", {s - 9: np.nan, s + 7: np.nan}, s - 9),
            ("a NaN after a huge number", {0: 1e38, s: np.nan}, s),
            ("an all-equal frame", {"fill": 5.0}, 0),
            ("the maximum in the last slice only", {N2 - 1 - N2 // (2 * cluster): 100.0},
             N2 - 1 - N2 // (2 * cluster))]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_kernel_i_model_holds_to_jax_on_traps_across_its_slices(cluster):
    rng = np.random.default_rng(cluster)
    traps = _traps_at(cluster)
    frames = rng.normal(0, 1, (len(traps), N2)).astype(F32)
    for f, (_, trap, _) in zip(frames, traps):
        trap = dict(trap)
        if "fill" in trap:
            f[:] = trap.pop("fill")
        for i, v in trap.items():
            f[i] = v
    frames = frames.reshape(-1, 256, 256)
    want = _jax_peaks(frames)
    for f, w, (name, _, at) in zip(frames, want, traps):
        assert w.tolist() == [at % 256, at // 256], name
        assert np.array_equal(_kernel_i_model(f, cluster), w), name
        # the 16-byte loads of f64 and i64 (2 values) and the scalar path (1)
        assert np.array_equal(_kernel_i_model(f, cluster, per_load=2), w), name
        assert np.array_equal(_kernel_i_model(f, cluster, per_load=1), w), name


@pytest.mark.parametrize("batch", [1, 4, 16, 64, 140])
def test_argmax_trap_frames_hold_every_trap(batch):
    """workloads.argmax_across_slices, which chip_smoke.py runs through
    kernel I at every cluster size: the port's plain version equal to
    jnp.argmax, and at a batch of 25 or more every trap at every slice
    boundary present."""
    from raw_image_pipeline_tpu_torch.tools import workloads

    frames = workloads.argmax_across_slices(batch, batch)
    assert frames.shape == (batch, 256, 256) and frames.dtype == F32
    want = _jax_peaks(frames)
    assert np.array_equal(pccc.response_argmax(torch.as_tensor(frames)).numpy(), want)
    got = want[:, 0] + 256 * want[:, 1]
    if batch >= 25:
        boundaries = workloads.ARGMAX_SLICES
        assert {s - 5 for s in boundaries} <= set(got.tolist())  # equal maxima: the first
        assert {s - 1 for s in boundaries} <= set(got.tolist())  # +0.0 / -0.0: the first
        assert {s - 9 for s in boundaries} <= set(got.tolist())  # two NaNs: the first
        assert 0 in got.tolist()  # the all-equal frame


@pytest.mark.parametrize("sms,largest", [(132, 16), (132, 8), (114, 16), (16, 16), (1, 16)])
def test_argmax_cluster_choice(sms, largest):
    sizes = [pccc.argmax_cluster(b, sms, largest) for b in range(1, 257)]
    for b, c in zip(range(1, 257), sizes):
        assert c in (1, 2, 4, 8, 16) and c <= largest and N2 % c == 0  # divides the frame
        assert c == 1 or b * c <= sms  # within the SMs
        half = b * c <= sms // 2 and (2 * c > largest or b * 2 * c > sms // 2)
        assert half or (c == 2 and b * 2 > sms // 2) or (c == 1 and b * 2 > sms)
        if b >= sms:
            assert c == 1  # the batch alone fills the card
    assert sizes == sorted(sizes, reverse=True)  # halves as the batch grows
    if (sms, largest) == (132, 16):  # an H100: the fastest sizes chip_smoke.py times
        assert [sizes[b - 1] for b in (1, 4, 8, 9, 16, 32, 64, 66, 67, 140)] == \
            [16, 16, 8, 4, 4, 2, 2, 2, 1, 1]


def test_argmax_dtype_codes_are_the_c_entrys():
    """ARGMAX_DTYPES names each dtype by the code under which
    isp_ccc_argmax launches the kernel for its C type."""
    import re

    c_types = {"float": torch.float32, "double": torch.float64, "__half": torch.float16,
               "__nv_bfloat16": torch.bfloat16, "uint8_t": torch.uint8, "int8_t": torch.int8,
               "int16_t": torch.int16, "int32_t": torch.int32, "long long": torch.int64}
    src = _csrc("ccc_argmax.cu")
    cases = re.findall(r"case (\d+): return launch<([\w ]+)>", src)
    assert {c_types[t]: int(code) for code, t in cases} == pccc.ARGMAX_DTYPES


def _csrc(name):
    import os

    return open(os.path.join(os.path.dirname(pccc.__file__), os.pardir, "csrc", name)).read()


def test_host_constants_are_the_c_sources():
    """The host side's copies of kernels H's and I's constants: the rows
    path's band, stages, shared-memory limit and row pitch (ops/resize),
    and I's largest cluster (ops/ccc), as csrc/ccc_resize.cu and
    csrc/ccc_argmax.cu define them."""
    import re

    resize_src, argmax_src = _csrc("ccc_resize.cu"), _csrc("ccc_argmax.cu")

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))

    assert const(resize_src, "BAND_ROWS") == pres.BAND_ROWS
    assert const(resize_src, "STAGES") == pres.ROWS_STAGES
    assert re.search(r"constexpr int ROWS_SMEM_LIMIT = (\d+) \* 1024", resize_src).group(1) == \
        str(pres.ROWS_SMEM_LIMIT // 1024)
    assert "return 16 * (src_w / 16 + 2);" in resize_src
    assert const(argmax_src, "MAX_CLUSTER") == pccc.MAX_ARGMAX_CLUSTER


# --- the track and the gains (kernel J's plain version) ---------------------


def _peaks(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 2)).astype(np.int32)


def _state(x, p, init):
    return pccc.KalmanState(x=torch.as_tensor(np.asarray(x, F32)),
                            p=torch.as_tensor(np.asarray(p, F32)),
                            initialized=torch.as_tensor(np.asarray(init, bool)))


def _seeded_state(seed, shape):
    """A state of `shape`, or for ("x", n) x a pair for each of n tracks with
    one p and one initialized for all (the plain form's state after a
    "cameras" call from a fresh state of shape ())."""
    rng = np.random.default_rng(seed)
    xs, ps = ((shape[1],), ()) if shape[:1] == ("x",) else (shape, shape)
    return _state(rng.uniform(0, 255, xs + (2,)), rng.uniform(0, 9, ps),
                  rng.integers(0, 2, ps).astype(bool))


def _fresh(shape):
    if shape[:1] == ("x",):
        return pccc.KalmanState(**{**vars(pccc.kalman_init((), device="cpu")),
                                   "x": pccc.kalman_init((shape[1],), device="cpu").x})
    return pccc.kalman_init(shape, device="cpu")


def _j_model(uv, state, track_shape, steps):
    """Kernel J's arithmetic in numpy, one track at a time, every
    operation rounded to f32 (none fused): (new x, p, initialized, gains)."""
    tracks = int(np.prod(track_shape))
    gains = np.empty((len(uv), 3), F32)
    x = p = init = None
    if state is not None:
        bx, bp, bi = (np.broadcast_to(getattr(state, f).numpy(), tuple(track_shape) + s)
                      .reshape((tracks,) + s) for f, s in (("x", (2,)), ("p", ()),
                                                            ("initialized", ())))
        x, p, init = bx.astype(F32).copy(), bp.astype(F32).copy(), bi.copy()
    for t in range(tracks):
        for s in range(steps):
            row = t * steps + s
            u = uv[row].copy()
            if state is not None:
                z = u.astype(F32)
                if init[t]:
                    pp = F32(p[t] + F32(1))
                    k = F32(pp / F32(pp + F32(10)))
                    x[t] = (x[t] + (k * (z - x[t]).astype(F32)).astype(F32)).astype(F32)
                    p[t] = F32(F32(F32(1) - k) * pp)
                else:
                    x[t] = z
                init[t] = True
                u = np.trunc(x[t]).astype(np.int32)
            g_r, g_b = EXP_TAB[u[0]], EXP_TAB[u[1]]
            m = min(g_b, F32(1), g_r)
            gains[row] = [F32(g_b / m), F32(F32(1) / m), F32(g_r / m)]
    return x, p, init, gains


# (name, rows, track_shape, steps, state shape)
LAYOUTS = [
    ("cameras", 6, (6,), 1, ()),
    ("cameras, a state a frame", 6, (6,), 1, (6,)),
    ("cameras, x a frame, one p", 6, (6,), 1, ("x", 6)),
    ("sequence", 9, (), 9, ()),
    ("blocked 3 cameras x 4", 12, (3,), 4, (3,)),
    ("gathered 2 shards x 5", 10, (), 10, ()),
    ("no Kalman", 7, (7,), 1, None),
]


@pytest.mark.parametrize("name,rows,track_shape,steps,shape", LAYOUTS)
@pytest.mark.parametrize("start", ["fresh", "seeded"])
def test_track_plain_walks_the_chains_layouts(name, rows, track_shape, steps, shape, start):
    uv = _peaks(rows, rows)
    exp_tab = torch.as_tensor(EXP_TAB)
    state = None if shape is None else (
        _fresh(shape) if start == "fresh" else _seeded_state(rows, shape))
    new, gains = pccc.track_gains(torch.as_tensor(uv), exp_tab, state,
                                  track_shape=track_shape, steps=steps)
    # the chain's former calls: kalman_update ("cameras"), kalman_scan over
    # the frames ("sequence", gathered) or over [cam_b, cameras] (blocked)
    t = torch.as_tensor(uv)
    if shape is None:
        old, filtered = None, t
    elif name.startswith("cameras"):
        old, filtered = pccc.kalman_update(state, t)
    elif name.startswith("blocked"):
        old, f = pccc.kalman_scan(state, t.reshape(track_shape[0], steps, 2).transpose(0, 1))
        filtered = f.transpose(0, 1).reshape(-1, 2)
    else:
        old, filtered = pccc.kalman_scan(state, t)
    assert torch.equal(gains.view(torch.int32),
                       pccc.gains_from_uv_table(filtered, exp_tab).view(torch.int32))
    mx, mp, mi, mgains = _j_model(uv, state, track_shape, steps)
    assert np.array_equal(gains.numpy().view(np.int32), mgains.view(np.int32))
    if shape is None:
        assert new is None
        return
    for f in ("x", "p", "initialized"):
        assert getattr(new, f).shape == getattr(old, f).shape
        assert torch.equal(getattr(new, f), getattr(old, f)), f
    tracks = int(np.prod(track_shape))
    assert np.array_equal(new.x.numpy().reshape(-1, 2).view(np.int32), mx.view(np.int32))
    assert np.array_equal(np.broadcast_to(new.p.numpy(), track_shape).reshape(tracks)
                          .view(np.int32), mp.view(np.int32))
    assert new.initialized.all()


@pytest.mark.parametrize("temporal_mode", ["sequence", "cameras"])
def test_track_holds_to_jax_within_the_recorded_rule(temporal_mode):
    # two calls with the state carried, as test_torch_pipeline's chains
    n = 8
    calls = [_peaks(40 + c, n) for c in range(2)]
    shape = () if temporal_mode == "sequence" else (n,)
    js, ps = jccc.kalman_init(shape), pccc.kalman_init(shape, device="cpu")
    jstates, pstates = [], []
    kw = (dict(track_shape=(), steps=n) if temporal_mode == "sequence"
          else dict(track_shape=(n,)))
    for uv in calls:
        js, _ = (jccc.kalman_scan if temporal_mode == "sequence" else jccc.kalman_update)(
            js, jnp.asarray(uv))
        ps, _ = pccc.track_gains(torch.as_tensor(uv), torch.as_tensor(EXP_TAB), ps, **kw)
        jstates.append(js)
        pstates.append(ps)
    meas = np.concatenate(calls)
    if temporal_mode == "cameras":
        assert_states_match(jstates, pstates, temporal_mode, meas)
        return
    # the recorded rule for one track: the port's x and p keep every
    # rounding; the JAX package's, here outside a chain's program, are one
    # of the two formulas (assert_states_match pins the fused p that
    # XLA:CPU compiles into the chains)
    js, ps = jstates[-1], pstates[-1]
    assert bool(ps.initialized) and bool(js.initialized)
    assert np.array_equal(ps.x.numpy(), _track_x(meas, fused=False))
    assert any(np.array_equal(np.asarray(js.x), _track_x(meas, fused=f)) for f in (False, True))
    assert ps.p.numpy() == _p_after(len(meas) - 1, fused=False)
    assert np.asarray(js.p) in (_p_after(len(meas) - 1, fused=False),
                                _p_after(len(meas) - 1, fused=True))


@pytest.mark.parametrize("bad", [dict(track_shape=(3,), steps=2),  # 6 frames for 5 rows
                                 dict(track_shape=(4,), steps=1),  # 4 frames for 5 rows
                                 dict(track_shape=(), steps=6)])
def test_track_refuses_a_layout_that_misses_its_rows(bad):
    with pytest.raises(ValueError, match="do not walk"):
        pccc.track_gains(torch.as_tensor(_peaks(1, 5)), torch.as_tensor(EXP_TAB), None, **bad)


# --- kernels H, I and J on the card -----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("path", [None, "rows", "gather"])
@pytest.mark.parametrize("hw", [(1080, 1920), (1080, 1440), (1079, 1439), (91, 117)])
def test_kernel_h_equals_plain_on_card(hw, path):
    dev = _cuda()
    h, w = hw
    x = torch.as_tensor(_u8(h, (4, 3, h, w)), device=dev)
    planes = [x[:, c] for c in (2, 1, 0)]
    got = pres.resize_rows_cuda(planes, h, 270, 360, 0, 270, 0, path=path)
    want = pres.resize_planes(planes, h, 270, 360, plain=True)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    for r0, r1 in split_rows(h, 4):
        y0, y1, a, e = resize_slab(h, 270, r0, r1)
        slab = pres.resize_rows_cuda([p[:, a:e] for p in planes], h, 270, 360, y0, y1, a,
                                     path=path)
        for g, wnt in zip(slab, want):
            assert torch.equal(g, wnt[:, y0:y1])
    buf = torch.empty(x.numel() + 3, dtype=torch.uint8, device=dev)
    off = buf[3:].view(x.shape)  # every row 3 bytes off a 16-byte boundary
    off.copy_(x)
    got = pres.resize_rows_cuda([off[:, c] for c in (2, 1, 0)], h, 270, 360, 0, 270, 0,
                                path=path)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    assert torch.equal(pres.resize_linear_u8(nhwc, 270, 360),
                       pres.resize_linear_u8(nhwc, 270, 360, plain=True))
    if path != "gather":  # the op layer's interleaved planes cannot take the rows path
        with pytest.raises(ValueError, match="rows path"):
            pres.resize_rows_cuda(nhwc.unbind(-1), h, 270, 360, 0, 270, 0, path="rows")
    with pytest.raises(ValueError, match="one set of strides"):
        pres.resize_rows_cuda([planes[0], planes[1].contiguous()], h, 270, 360, 0, 270, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8, 16])
def test_kernel_i_equals_plain_on_card(cluster):
    dev = _cuda()
    frames = torch.as_tensor(_planted(3), device=dev)
    got = pccc.response_argmax_cuda(frames, cluster=cluster)
    assert torch.equal(got, pccc.response_argmax_plain(frames))
    buf = torch.empty(frames.numel() + 1, device=dev)
    off = buf[1:].view(frames.shape)  # 4 bytes off: the scalar loads
    off.copy_(frames)
    assert torch.equal(pccc.response_argmax_cuda(off, cluster=cluster),
                       pccc.response_argmax_plain(frames))
    from raw_image_pipeline_tpu_torch.tools import workloads

    for b in (1, 4, 16, 64, 140):  # the traps across the slices' boundaries
        traps = torch.as_tensor(workloads.argmax_across_slices(b, b), device=dev)
        assert torch.equal(pccc.response_argmax_cuda(traps, cluster=cluster),
                           pccc.response_argmax_plain(traps))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16, torch.uint8,
                                   torch.int8, torch.int16, torch.int32, torch.int64])
def test_kernel_i_takes_every_argmax_dtype_on_card(dtype):
    dev = _cuda()
    frames = torch.as_tensor(_planted(4))
    if not dtype.is_floating_point:  # ties and the last index as integers
        frames = torch.nan_to_num(frames * 8, posinf=100, neginf=-100)
    frames = frames.to(device=dev, dtype=dtype)
    got = pccc.response_argmax(frames)
    assert torch.equal(got, pccc.response_argmax_plain(frames))
    off = torch.empty(frames.numel() + 1, dtype=dtype, device=dev)[1:].view(frames.shape)
    off.copy_(frames)  # off a 16-byte boundary: the scalar loads
    for cluster in (0, 1, 2, 4, 8, 16):
        assert torch.equal(pccc.response_argmax_cuda(frames, cluster=cluster), got)
        assert torch.equal(pccc.response_argmax_cuda(off, cluster=cluster), got)
    with pytest.raises(ValueError, match="cluster"):
        pccc.response_argmax_cuda(frames, cluster=3)


def _held_on_card(uv, exp_tab, state, **kw):
    """Kernel J against track_plain on the card: the gains and the state
    bit for bit, one launch, the given state untouched."""
    from raw_image_pipeline_tpu_torch import kernels

    kept = None if state is None else [getattr(state, f).clone() for f in ("x", "p",
                                                                           "initialized")]
    before = kernels.CCC_TRACK.launches
    got = pccc.track_cuda(uv, exp_tab, state, **kw)
    assert kernels.CCC_TRACK.launches - before == 1
    want = pccc.track_plain(uv, exp_tab, state, **kw)
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    if state is None:
        assert got[0] is None
        return
    bits = (lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t)  # noqa: E731
    for f, k in zip(("x", "p", "initialized"), kept):
        a, b = getattr(got[0], f), getattr(want[0], f)
        assert a.shape == b.shape and torch.equal(bits(a), bits(b)), f
        assert torch.equal(bits(k), bits(getattr(state, f))), f  # untouched


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,track_shape,steps,shape", LAYOUTS)
def test_kernel_j_equals_plain_on_card(name, rows, track_shape, steps, shape):
    dev = _cuda()
    uv = torch.as_tensor(_peaks(rows, rows), device=dev)
    exp_tab = torch.as_tensor(EXP_TAB, device=dev)
    kw = dict(track_shape=track_shape, steps=steps)
    for start in ("fresh", "seeded", "NaN p"):
        state = None
        if shape is not None:
            s = _fresh(shape) if start == "fresh" else _seeded_state(rows, shape)
            if start == "NaN p":  # carried from a call that went NaN
                s = pccc.KalmanState(s.x, torch.full_like(s.p, float("nan")),
                                     torch.ones_like(s.initialized))
            state = pccc.KalmanState(s.x.to(dev), s.p.to(dev), s.initialized.to(dev))
        _held_on_card(uv, exp_tab, state, **kw)
    if name == "sequence":  # tracks ending before, on and after a stage's end, past two
        c = pccc.TRACK_CHUNK
        for n in (c - 1, c, c + 1, 2 * c + 3):
            fresh = pccc.kalman_init((), device=dev)
            _held_on_card(torch.as_tensor(_peaks(n, n), device=dev), exp_tab, fresh,
                          track_shape=(), steps=n)
        # p = -3.701562: 55 dividing steps, past the gains J makes before it
        # walks (its k is negative: the peaks are x's own, in the table)
        far = _state([100.0, 50.0], -3.701562, True)
        _held_on_card(torch.tensor([[100, 50]] * 80, dtype=torch.int32, device=dev), exp_tab,
                      pccc.KalmanState(far.x.to(dev), far.p.to(dev), far.initialized.to(dev)),
                      track_shape=(), steps=80)
    if shape is not None and name in ("sequence", "cameras"):
        # J straight behind kernel I on the same stream: its programmatic
        # launch must read the peaks only after I has written them
        resp = torch.as_tensor(_planted(5)[:4], device=dev)
        n = resp.shape[0]
        for _ in range(3):
            uv = pccc.response_argmax_cuda(resp)
            _held_on_card(uv, exp_tab, pccc.kalman_init(() if name == "sequence" else (n,),
                                                         device=dev),
                          track_shape=() if name == "sequence" else (n,),
                          steps=n if name == "sequence" else 1)
