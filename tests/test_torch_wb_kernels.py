"""The statistical white balances as three steps (ops/white_balance.py,
ops/learned_wb.py): the statistics record (kernel K's plain version,
wb_stats_plain; learned's 64^3 histogram, kernel L's, hist64_plain), the
per-frame tables (kernel M's, wb_tables_plain) and the table apply (kernel
G's table step, apply_tables_plain), composed, against the JAX functions on
the CPU at 0 mismatching bytes, learned's features bit for bit; the record
against numpy; the table step on a slab of rows; the kernels' bindings.
The cuda-marked tests hold kernels K, L, M and G's table step to their
plain versions on the card (tools/card_tests.py runs them there)."""

import os

import numpy as np
import pytest
import torch

from raw_image_pipeline_tpu.ops import learned_wb as jlearned
from raw_image_pipeline_tpu.ops import white_balance as jwb
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops import gamma as pgamma
from raw_image_pipeline_tpu_torch.ops import learned_wb as plearned
from raw_image_pipeline_tpu_torch.ops import pointwise as ppw
from raw_image_pipeline_tpu_torch.ops import white_balance as pwb
from raw_image_pipeline_tpu_torch.tools import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(17, 31), (45, 61), (48, 64), (3, 3)]


def frames(seed, hw, n=3):
    """[n, h, w, 3] u8 BGR frames, each with its own colour cast, noise and
    a few saturated pixels."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w, 2)
    out = []
    for _ in range(n):
        base = 40 + 200 * (0.5 + 0.5 * np.sin(7 * xx + rng.uniform(0, 6) + 5 * yy))
        img = base[..., None] * rng.uniform(0.4, 1.7, 3) * rng.uniform(0.8, 1.2, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def planes_of(bgr):
    t = torch.as_tensor(np.ascontiguousarray(bgr))
    return t[..., 0], t[..., 1], t[..., 2]


def three_steps(x, method, param):
    """record -> tables -> apply on the CPU, as [n, h, w, 3]."""
    planes = planes_of(x)
    h, w = x.shape[1:3]
    record = pwb.wb_stats_plain(planes, method, param)
    hist = None
    if method == "learned":
        hist = plearned.hist64_plain(planes, record, plearned.learned_t255(param))
    t = pwb.wb_tables_plain(record, method, param, h * w, hist)
    assert t.tables.dtype == torch.uint8 and t.tables.shape == (x.shape[0], 3, 256)
    out = pwb.apply_tables_plain(planes, t.tables, t.nan)
    return torch.stack(out, dim=-1).numpy()


def mismatches(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return int((a != b).sum())


# --- the three steps against the JAX functions --------------------------------


@pytest.mark.parametrize("hw", SHAPES)
def test_simple_three_steps_equal_reference(hw):
    x = frames(11, hw)
    for p in (2.0, 20.0, 35.0):
        assert mismatches(three_steps(x, "simple", p), jwb.balance_white_simple(x, p)) == 0, p


@pytest.mark.parametrize("hw", SHAPES)
def test_grey_world_three_steps_equal_reference(hw):
    # 17x31, 45x61 and 3x3 are no multiple of 16: at 1.2 (the u16 wrap
    # rule) their frames have a scalar tail
    x = frames(12, hw)
    for thr in (0.8, 1.2):
        assert mismatches(three_steps(x, "grey_world", thr),
                          jwb.balance_white_grey_world(x, thr)) == 0, thr


def test_pca_three_steps_equal_reference():
    # 17x31 = 527 px, 527 % 4 = 3: a constant channel's NaN pattern has a
    # tail of 3 zeros; frame 2 is constant in two channels
    x = frames(13, (17, 31))
    x[1, ..., 0] = 77
    x[2, ..., 0] = 0
    x[2, ..., 2] = 255
    got = three_steps(x, "pca", None)
    assert mismatches(got, jwb.balance_white_pca(x)) == 0
    assert (got[1, ..., 0].reshape(-1) == [255] * 524 + [0] * 3).all()


def _learned_edge_frames(hw):
    """Fully saturated, all black, and two frames with planted equal
    brightest kept sums: at two body positions (the 8-lane rank picks the
    lower lane) and at a body and a tail position."""
    h, w = hw
    x = frames(14, hw, n=4)
    x[0] = 255
    x[1] = 0
    n = h * w
    body = n // 8 * 8
    # frame 2: flat 9 (lane 1) before flat 2 (lane 2) where a lane holds
    # more than one pixel; frame 3: the last pixel (the tail, if any) and a
    # body pixel
    for f, sites in ((2, (9, 2) if n >= 16 else (1, 2)), (3, (n - 1, min(16, body - 1)))):
        flat = x[f].reshape(n, 3)
        flat[:] = np.minimum(flat, 60)  # below the planted sum
        for i in sites:
            flat[i] = (120, 60, 10)  # sum 190, all kept at 0.8
    return x


@pytest.mark.parametrize("hw", [(17, 31), (45, 61)])
def test_learned_three_steps_and_features_equal_reference(hw):
    x = np.concatenate([frames(15, hw), _learned_edge_frames(hw)])
    assert mismatches(three_steps(x, "learned", 0.8),
                      jlearned.balance_white_learned_model(x, 0.8)) == 0
    planes = planes_of(x)
    record = pwb.wb_stats_plain(planes, "learned", 0.8)
    hist = plearned.hist64_plain(planes, record, 204)
    got = plearned.features_plain(record, hist).numpy()
    want = np.stack([np.asarray(jlearned._extract_features(f, 204)) for f in x])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    occupied = (hist > 0).sum(dim=-1)
    assert occupied[3] == 0 and occupied[4] == 1  # saturated: nothing kept; black: one bin
    # below 300 occupied bins (the palette's zero padding) and above
    assert (int(occupied[:3].max()) < 300) == (hw == (17, 31)), occupied


@pytest.mark.parametrize("hw", [(48, 64), (3, 3)])
def test_learned_three_steps_equal_reference(hw):
    x = frames(16, hw)
    assert mismatches(three_steps(x, "learned", 0.8),
                      jlearned.balance_white_learned_model(x, 0.8)) == 0


# --- the record against numpy -------------------------------------------------


def _np_rank(n):
    pos = np.arange(n)
    body = n // 8 * 8
    return np.where(pos < body, (pos % 8) * (body // 8) + pos // 8, pos)


@pytest.mark.parametrize("hw", SHAPES)
def test_record_equals_numpy(hw):
    x = np.concatenate([frames(17, hw), _learned_edge_frames(hw)])
    planes = planes_of(x)
    v = x.reshape(len(x), -1, 3).astype(np.int64)  # [B, N, (b, g, r)]
    n = v.shape[1]
    counts = pwb.wb_stats_plain(planes, "simple", 20.0)
    assert counts.dtype == torch.int32
    for i in range(len(x)):
        for c in range(3):
            np.testing.assert_array_equal(counts[i, c].numpy(),
                                          np.bincount(v[i, :, c], minlength=256))
    mx, mn = v.max(-1), v.min(-1)
    for thr in (0.8, 1.2):
        t255 = pwb.grey_world_t255(thr)
        rhs = t255 * mx
        if t255 > 257:
            rhs = np.where(np.arange(n) < n // 16 * 16, rhs & 0xFFFF, rhs)
        m = (mx - mn) * 255 <= rhs
        want = (v * m[..., None]).sum(1)
        np.testing.assert_array_equal(pwb.wb_stats_plain(planes, "grey_world", thr).numpy(), want)
    pca = pwb.wb_stats_plain(planes, "pca").numpy()
    np.testing.assert_array_equal(pca[..., 0], v.sum(1))
    np.testing.assert_array_equal(pca[..., 1], (v * v).sum(1))
    np.testing.assert_array_equal(pca[..., 2], v.max(1))
    rec = pwb.wb_stats_plain(planes, "learned", 0.8).numpy()
    keep = mx < 204
    rank = _np_rank(n)
    for i in range(len(x)):
        k = keep[i]
        assert rec[i, plearned.KEPT] == k.sum()
        np.testing.assert_array_equal(rec[i, plearned.SUM_B:plearned.SUM_R + 1],
                                      v[i][k].sum(0))
        assert rec[i, plearned.HI] == mx[i].max()
        if not k.any():
            assert rec[i, plearned.KEY] == 0 and rec[i, plearned.PIXEL] == 0
            continue
        s = np.where(k, v[i].sum(-1), -1)
        best = s.max()
        at = np.flatnonzero(s == best)
        pos = at[np.argmin(rank[at])]
        assert rec[i, plearned.KEY] == ((int(best) + 1) << 32) | ((1 << 32) - 1 - int(rank[pos]))
        b, g, r = v[i, pos]
        assert rec[i, plearned.PIXEL] == b | (g << 8) | (r << 16)


# --- the frame families of kernels K's and L's hard cases ----------------------
# (tools/workloads.wb_frames, made from a numpy seed): each against the JAX
# functions at a tolerance of 0 (bit for bit), its record and histogram
# against numpy. 260x256 holds big_bin's 65 600 pixels of one colour;
# all_bins needs 64^3 + 1 pixels.
FAMILY_HW = {"all_bins": (513, 512)}
_FIXTURE = None


def family(kind, n=2):
    global _FIXTURE
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.utils import image_io

    if kind == "fixture" and _FIXTURE is None:
        _FIXTURE = image_io.imread(os.path.join(REPO, "tests", "fixtures", "alphasense.png"))
    h, w = FAMILY_HW.get(kind, (260, 256))
    return workloads.wb_frames(torch, kind, n, h, w, 30, bgr=_FIXTURE, device="cpu").numpy()


FAMILIES = ("constant", "all_bins", "ramp", "noise", "fixture", "big_bin")


@pytest.mark.parametrize("kind", FAMILIES)
def test_family_simple_and_grey_world_equal_reference(kind):
    x = family(kind)
    counts = pwb.wb_stats_plain(planes_of(x), "simple", 20.0)
    assert mismatches(counts.numpy(), np.asarray(jwb._channel_hists(x))) == 0
    v = x.reshape(len(x), -1, 3)
    for i in range(len(x)):
        for c in range(3):
            np.testing.assert_array_equal(counts[i, c].numpy(),
                                          np.bincount(v[i, :, c], minlength=256))
    if kind in ("constant", "big_bin"):  # one value of a channel past 65 535 pixels
        assert int(counts.max()) > 65_535
    for p in (2.0, 35.0):
        assert mismatches(three_steps(x, "simple", p), jwb.balance_white_simple(x, p)) == 0, p
    for thr in (0.8, 1.2):
        assert mismatches(three_steps(x, "grey_world", thr),
                          jwb.balance_white_grey_world(x, thr)) == 0, thr


@pytest.mark.parametrize("kind", FAMILIES)
def test_family_pca_equals_reference(kind):
    x = family(kind)
    stats = pwb.wb_stats_plain(planes_of(x), "pca").numpy()
    v = x.reshape(len(x), -1, 3).astype(np.int64)
    np.testing.assert_array_equal(stats[..., 0], v.sum(1))
    np.testing.assert_array_equal(stats[..., 1], (v * v).sum(1))
    np.testing.assert_array_equal(stats[..., 2], v.max(1))
    assert mismatches(three_steps(x, "pca", None), jwb.balance_white_pca(x)) == 0


@pytest.mark.parametrize("kind", FAMILIES)
def test_family_learned_histogram_and_features_equal_reference(kind):
    # all_bins keeps every bin at a threshold of 1.0 (t255 = 255)
    thr = 1.0 if kind == "all_bins" else 0.8
    t255 = plearned.learned_t255(thr)
    x = family(kind)
    planes = planes_of(x)
    record = pwb.wb_stats_plain(planes, "learned", thr)
    hist = plearned.hist64_plain(planes, record, t255)
    v = x.reshape(len(x), -1, 3).astype(np.int64)
    for i in range(len(x)):
        keep = v[i].max(-1) < t255
        hi = np.float32(max(int(v[i].max()), 64))
        idx = np.floor(v[i].astype(np.float32) * np.float32(64) / hi)
        idx = np.clip(idx, 0, 63).astype(np.int64)
        bins = (idx[:, 0] * 64 + idx[:, 1]) * 64 + idx[:, 2]
        np.testing.assert_array_equal(hist[i].numpy(),
                                      np.bincount(bins[keep], minlength=plearned.N_BINS))
        assert record[i, plearned.KEPT] == keep.sum()
    if kind == "all_bins":
        assert bool((hist > 0).all())
    if kind in ("constant", "big_bin"):
        assert int(hist.max()) > 65_535
    got = plearned.features_plain(record, hist).numpy()
    want = np.stack([np.asarray(jlearned._extract_features(f, t255)) for f in x])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert mismatches(three_steps(x, "learned", thr),
                      jlearned.balance_white_learned_model(x, thr)) == 0


# --- kernel K's grid and kernel L's bin ownership, as the kernels compute them --


def _source_constant(name, source):
    import re

    with open(os.path.join(REPO, "raw_image_pipeline_tpu_torch", "csrc", source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


def test_host_constants_equal_the_kernels():
    assert pwb.WB_STATS_THREADS == _source_constant("THREADS", "wb_stats.cu")
    assert pwb.MAX_WB_CLUSTER == _source_constant("MAX_CLUSTER", "wb_stats.cu")
    assert pwb.MAX_WB_CLUSTER == _source_constant("MAX_CLUSTER", "wb_tables.cu")
    assert pwb.WB_CHUNK == _source_constant("kChunk", "wb_planes.cuh")
    for method, (size, dtype) in pwb.WB_PARTIAL.items():
        # a cluster's partial: the counts of the record (simple), else the
        # values a thread carries (learned's pixel is found at the end)
        shape, rec_dtype = pwb.RECORD[method]
        assert dtype == rec_dtype
        assert size == int(np.prod(shape)) - (method == "learned")


@pytest.mark.parametrize("sms,resident", [(132, 2), (114, 2), (132, 1)])
def test_wb_stats_grid_fills_the_card_twice(sms, resident):
    for pixels in (1920 * 1080, 1439 * 1079, 17 * 31, 15):
        # no block with fewer than 4 chunks a thread (but one a frame)
        cap = -(-(-(-pixels // pwb.WB_CHUNK)) // (4 * pwb.WB_STATS_THREADS))
        for largest in (16, 8):
            for b in range(1, 65536):
                cluster, groups = pwb.wb_stats_grid(b, pixels, sms, resident, largest)
                want = max(1, min(2 * sms * resident // b, cap))
                blocks = cluster * groups
                assert cluster & (cluster - 1) == 0 and 1 <= cluster <= largest, (b, cluster)
                assert groups >= 1 and blocks <= want, (b, blocks, want)
                assert 2 * blocks > want, (b, blocks, want)  # at least half the wave
                assert groups == 1 or cluster == largest, (b, cluster, groups)
    # an H100's 132 SMs, two blocks each: a 1920x1080 frame over 64 blocks
    # at B = 1 and 4, over 32 at B=16, 8 blocks a frame at B=64
    grid = {b: pwb.wb_stats_grid(b, 1920 * 1080, 132, 2) for b in (1, 4, 16, 64, 265)}
    assert grid == {1: (16, 4), 4: (16, 4), 16: (16, 2), 64: (8, 1), 265: (1, 1)}


@pytest.mark.parametrize("sms", [132, 114])
def test_wb_tables_cluster_takes_a_block_an_sm(sms):
    # kernel M's learned blocks a frame: a power of two of at most the
    # largest resident cluster, batch x cluster within one block an SM but
    # above half of it (else 1), fewer as the batch grows
    for largest in (16, 8, 1):
        last = largest
        for b in range(1, 65536):
            c = pwb.wb_tables_cluster(b, sms, largest)
            assert c & (c - 1) == 0 and 1 <= c <= largest and c <= last, (b, c)
            assert c == 1 or b * c <= sms, (b, c)
            assert c == largest or b * 2 * c > sms, (b, c)  # the next size would pass them
            last = c
    # an H100's 132 SMs: 16 blocks a frame up to B=8, 8 at B=16, 2 at the
    # wb_* chains' B=64
    rule = {b: pwb.wb_tables_cluster(b, 132) for b in (1, 4, 8, 9, 16, 33, 64, 66, 67)}
    assert rule == {1: 16, 4: 16, 8: 16, 9: 8, 16: 8, 33: 4, 64: 2, 66: 2, 67: 1}


def chunk_runs(chunks, blocks):
    """The [c0, c1) run of a frame's chunks that each of kernel K's blocks
    takes, as the kernel splits them: ceil(chunks / blocks) each in order,
    the last ones shorter or empty."""
    per = -(-chunks // blocks)
    return [(min(chunks, q * per), min(chunks, (q + 1) * per)) for q in range(blocks)]


def test_chunk_runs_read_every_chunk_once():
    for h, w in ((1080, 1920), (1079, 1439), (17, 31), (3, 5), (1, 1)):
        for head in (0, 1, 7, 15):  # a frame's first byte's address modulo 16
            chunks = (head + h * w + pwb.WB_CHUNK - 1) // pwb.WB_CHUNK
            for b in (1, 3, 4, 16, 64, 200):
                cluster, groups = pwb.wb_stats_grid(b, h * w, 132, 2)
                read = np.zeros(chunks, np.int64)
                for c0, c1 in chunk_runs(chunks, cluster * groups):
                    read[c0:c1] += 1
                assert (read == 1).all(), (h, w, head, b)


def test_wb_variants_apply_to_the_sources():
    # tools/wb_variants.py builds its limiter variants from the kernels'
    # sources by text replacements: each must still find its text
    from raw_image_pipeline_tpu_torch.tools import wb_variants

    for name, (kern, src, repl, _) in wb_variants.VARIANTS.items():
        text = wb_variants.variant_source(name, kernels.CSRC_DIR)
        assert wb_variants.ENTRIES[kern][0] + "(" in text, name
        if repl:
            with open(os.path.join(REPO, "raw_image_pipeline_tpu_torch", "csrc", src)) as f:
                assert text != f.read(), name


# --- the table step: a slab of rows, the plain pointwise path -----------------


def test_table_step_on_a_slab_equals_the_frame_rows():
    x = frames(18, (17, 31))
    x[0, ..., 2] = 9  # a constant channel: the NaN pattern
    planes = planes_of(x)
    t = pwb.wb_tables(planes, "pca", plain=True)
    assert int(t.nan[0, 2]) == 1 and t.tables[0, 2].eq(0).all()
    whole = ppw.pointwise_planes(*planes, wb_tables=t.tables, wb_nan=t.nan)
    h, w = 17, 31
    for r0, r1 in ((0, 9), (9, 17), (16, 17)):
        slab = ppw.pointwise_planes(*(p[:, r0:r1] for p in planes), wb_tables=t.tables,
                                    wb_nan=t.nan, nan_limit=pwb.pca_nan_limit(h, w) - r0 * w)
        for a, b in zip(slab, whole):
            assert torch.equal(a, b[:, r0:r1]), (r0, r1)


def test_pca_nan_pattern_over_a_mesh_equals_unsharded():
    """The chain over two space shards: each shard applies the frame's
    tables to its own rows, PCA's NaN pattern by the whole frame's flat
    position (17x31: a tail of 3 zeros in the last shard)."""
    import dataclasses

    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch.parallel import make_mesh

    c = tp.PipelineConfig()
    config = c.replace(white_balance=dataclasses.replace(c.white_balance, enabled=True,
                                                         method="pca"))
    x = frames(22, (17, 31), n=4)
    x[1, ..., 0] = 77
    x[2, ..., 2] = 0
    ref = tp.build_pipeline(config, "bgr8", (17, 31), device="cpu")(torch.as_tensor(x))
    pipe = tp.build_pipeline(config, "bgr8", (17, 31), mesh=make_mesh(["cpu"] * 2, space=2))
    got = pipe(torch.as_tensor(x))[0]["processed"].gather("cpu")
    want = ref[0]["processed"]
    assert torch.equal(got, want)
    assert (want[1, ..., 0].reshape(-1) == torch.tensor([255] * 524 + [0] * 3,
                                                       dtype=torch.uint8)).all()


def test_planes_entry_points_take_plain():
    x = frames(19, (17, 31))
    planes = planes_of(x)
    for fn, args in ((pwb.balance_white_simple_planes, (20.0,)),
                     (pwb.balance_white_grey_world_planes, (0.8,)),
                     (pwb.balance_white_pca_planes, ()),
                     (plearned.balance_white_learned_planes, (0.8,))):
        a, b = fn(planes, *args), fn(planes, *args, plain=True)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    img = torch.as_tensor(x)
    got = pwb.balance_white_pca(img)
    assert got.shape == img.shape and got.dtype == torch.uint8


def test_wrappers_refuse_what_the_kernels_do_not_take():
    planes = tuple(torch.zeros((1, 2, 3), dtype=torch.uint8) for _ in range(3))
    with pytest.raises(ValueError, match="White Balance method"):
        pwb.wb_tables(planes, "bogus", plain=True)
    with pytest.raises(ValueError, match="CUDA"):
        pwb.wb_stats_cuda(planes, "pca")
    with pytest.raises(ValueError, match="needs wb_tables"):
        ppw.pointwise_planes(*planes, wb_nan=torch.zeros((1, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        pgamma.lut_cuda(planes[0], torch.zeros(256, dtype=torch.uint8))
    with pytest.raises(ValueError, match="histogram"):
        pwb.wb_tables_plain(torch.zeros((1, 7), dtype=torch.int64), "learned", 0.8, 6)


def test_simple_alpha_beta_as_the_card_computes_them_equal_the_host_tables():
    # kernel M's simple mode computes alpha = f32(255 / span) and beta =
    # f32(-p1 * (255 / span)) in f64 (__ddiv_rn, __dmul_rn,
    # __double2float_rn) in place of reading the host's tables: the same
    # operations in torch f64 give the tables' bits over all 256 x 257
    # (p1, span) pairs, span 0 taken as 1
    span = torch.arange(257, dtype=torch.float64).clamp(min=1)
    p1 = torch.arange(256, dtype=torch.float64)
    alpha64 = torch.full_like(span, 255.0) / span
    alpha = alpha64.to(torch.float32)
    beta = (-p1[:, None] * alpha64[None, :]).to(torch.float32)
    assert torch.equal(alpha.view(torch.int32),
                       torch.as_tensor(pwb._SIMPLE_ALPHA32).view(torch.int32))
    assert torch.equal(beta.view(torch.int32),
                       torch.as_tensor(pwb._SIMPLE_BETA32).view(torch.int32))


def test_small_modes_thread_counts_and_floor():
    # the block sizes of simple (a warp a channel), grey-world and PCA in
    # wb_tables.cu, and the C entry of their floor (an empty launch)
    assert _source_constant("SIMPLE_THREADS", "wb_tables.cu") == 96
    assert _source_constant("GREY_THREADS", "wb_tables.cu") % 32 == 0
    assert _source_constant("THREADS", "wb_tables.cu") == 512  # PCA's: a thread a table entry
    assert len(kernels._SIGNATURES["isp_wb_tables_empty"]) == 3  # mode, batch, stream


def test_kernels_are_bound():
    for k, n_args in ((kernels.WB_STATS, 18), (kernels.WB_HIST64, 13), (kernels.WB_TABLES, 14)):
        assert k in kernels.ALL and len(kernels._SIGNATURES[k.entry]) == n_args
        assert os.path.basename(k.source) in kernels.SOURCES
        assert os.path.exists(os.path.join(REPO, k.source))
        for site in k.replaces.split("; "):
            path, rest = site.split(":")
            line, fn = rest.split(" ")
            with open(os.path.join(REPO, path)) as f:
                assert f.readlines()[int(line) - 1].startswith(f"def {fn}("), site
    assert "wb_planes.cuh" in kernels.HEADERS
    assert pwb.METHODS == ("simple", "grey_world", "pca", "learned")  # the kernels' mode codes


# --- the kernels on the card ---------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_cases(dev):
    """(label, planes) on the card: the shapes above, noise, a view 1 byte
    off a 16-byte boundary, interleaved planes (column stride 3), the
    edge frames and the frame families."""
    cases = []
    for hw in SHAPES + [(270, 361)]:
        x = torch.as_tensor(frames(20, hw), device=dev)
        cases.append((f"{hw}", tuple(x[..., c].contiguous() for c in range(3))))
    x = torch.as_tensor(np.concatenate([frames(21, (45, 61)), _learned_edge_frames((45, 61))]),
                        device=dev)
    cases.append(("edge", tuple(x[..., c].contiguous() for c in range(3))))
    cases.append(("interleaved", (x[..., 0], x[..., 1], x[..., 2])))
    buf = torch.zeros(x.numel() + 17, dtype=torch.uint8, device=dev)
    off = buf[1:1 + x.numel()].view(x.shape)
    off.copy_(x)
    cases.append(("off1", (off[..., 0], off[..., 1], off[..., 2])))
    noise = torch.randint(0, 256, (3, 3, 64, 96), dtype=torch.uint8, device=dev)
    cases.append(("noise", tuple(noise[:, c] for c in range(3))))
    for kind in FAMILIES:  # at 260x256 (all_bins 513x512), as on the CPU
        x = torch.as_tensor(family(kind), device=dev)
        cases.append((kind, tuple(x[..., c].contiguous() for c in range(3))))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("method,param", [("simple", 20.0), ("grey_world", 0.8),
                                          ("grey_world", 1.2), ("pca", None),
                                          ("learned", 0.8), ("learned", 1.0)])
def test_kernels_k_l_m_equal_plain_on_card(card, method, param):
    for label, planes in _card_cases(card):
        h, w = planes[0].shape[-2:]
        want = pwb.wb_stats_plain(planes, method, param)
        got = pwb.wb_stats_cuda(planes, method, param)
        hist = want_hist = None
        if method == "learned":
            got, hist = got
            want_hist = plearned.hist64_plain(planes, want, plearned.learned_t255(param))
            plearned.hist64_cuda(pwb._check_planes(planes, "L"), got, plearned.learned_t255(param),
                                 hist)
            assert torch.equal(hist, want_hist), label
        assert torch.equal(got, want), label
        feats = (torch.empty((got.shape[0], 4, 2), dtype=torch.float32, device=card)
                 if method == "learned" else None)
        t = pwb.wb_tables_cuda(got, method, param, h * w, hist, features=feats)
        p = pwb.wb_tables_plain(want, method, param, h * w, want_hist)
        assert torch.equal(t.tables, p.tables), label
        assert (t.nan is None) == (p.nan is None) and (t.nan is None or torch.equal(t.nan, p.nan))
        if feats is not None:
            pf = plearned.features_plain(want, want_hist)
            assert torch.equal(feats.view(torch.int32), pf.view(torch.int32)), label
        a = pwb.balance_white_planes(planes, method, param)
        b = pwb.balance_white_planes(planes, method, param, plain=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), label


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
def test_kernel_m_learned_equals_plain_on_synthetic_histograms_on_card(card, cluster):
    # ties at T across block boundaries, 299-301 occupied bins, one bin, all
    # counts equal, one and two digit passes, an empty histogram
    labels, record, hist = workloads.learned_histograms(torch, device=card)
    want = plearned.learned_tables_plain(record, hist)
    want_f = plearned.features_plain(record, hist)
    feats = torch.empty((len(labels), 4, 2), dtype=torch.float32, device=card)
    before = kernels.WB_TABLES.launches
    got = pwb.wb_tables_cuda(record, "learned", 0.8, 1, hist, features=feats, cluster=cluster)
    assert kernels.WB_TABLES.launches == before + 1
    for i, label in enumerate(labels):
        assert torch.equal(got.tables[i], want[i]), (label, cluster)
        assert torch.equal(feats[i].view(torch.int32), want_f[i].view(torch.int32)), (label,
                                                                                       cluster)


@pytest.mark.cuda
def test_kernel_g_table_step_equals_plain_on_card(card):
    for label, planes in _card_cases(card):
        bsz, h, w = planes[0].shape
        tabs = torch.randint(0, 256, (bsz, 3, 256), dtype=torch.uint8, device=card)
        nan = torch.zeros((bsz, 3), dtype=torch.uint8, device=card)
        nan[0, 1] = 1
        for limit in (None, pwb.pca_nan_limit(h, w) - w):
            got = ppw.pointwise_cuda(planes, wb_tables=tabs, wb_nan=nan, nan_limit=limit)
            want = ppw.pointwise_plain(*planes, wb_tables=tabs, wb_nan=nan, nan_limit=limit)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), (label, limit)
        got = ppw.pointwise_cuda(planes, wb_tables=tabs, batch_limit=2)
        want = pwb.apply_tables_plain(planes, tabs)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), label


@pytest.mark.cuda
def test_mono_lut_on_card_equals_plain(card):
    lut = torch.as_tensor(pgamma.build_gamma_lut(0.7), device=card)
    for shape in ((3, 17, 31), (2, 45, 61), (5,), (2, 3, 64, 96)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=card)
        before = kernels.LUT.launches
        got = pgamma.apply_lut(x, lut)
        assert kernels.LUT.launches == before + 1
        assert torch.equal(got, pgamma.apply_lut(x, lut, plain=True)), shape
    x = torch.randint(0, 256, (4, 45, 64), dtype=torch.uint8, device=card)
    assert torch.equal(pgamma.apply_lut(x[:, :, 1:], lut), lut[x[:, :, 1:].long()])
