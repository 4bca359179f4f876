"""Kernel J's redesigned walk (csrc/ccc_track.cu) on the CPU: a numpy model
of what the kernel does, held bit for bit to its plain version.

The model (_walk_model) follows the kernel's two launches: the chain
kernel where the filter walks more than one step a track (a block a
track: the dividing steps' gains made first from p alone, at most
PRECOMPUTED of them, until p repeats bit for bit; the peaks staged
TRACK_CHUNK steps a stage; the walker taking those gains, then dividing as
it goes if p has not repeated, then keeping the last gain, the bits of
each filtered x written back over its z in the stage; then the stage's
gains from the truncated x and the table) and the flat kernel otherwise (a
row a thread).
It is held to ops/ccc.track_plain and to tests/test_torch_ccc_range.
_j_model (the arithmetic of the first kernel, every step divided) in every
layout of the chain, fresh and seeded; on tracks of TRACK_CHUNK - 1,
TRACK_CHUNK, TRACK_CHUNK + 1 and 2 TRACK_CHUNK + 3 steps; with the dividing
steps split anywhere between the precomputed gains and the walk; and on
states with p = 0, p past the fixed point, NaN, +inf and -0.0 (a NaN x has no
peak on the CPU, where the plain version cannot index the table with it:
there the state and the rows with a number are held, and the card holds
the rest, tests/test_torch_ccc_range.test_kernel_j_equals_plain_on_card).
Also: p repeats within DIVIDING_STEPS steps from the starts the kernel's
comment names; tools/measure's latency floor; TRACK_CHUNK is the C
source's.
"""

import os
import re

import numpy as np
import pytest
import torch

from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.tools import measure
from test_torch_ccc_range import EXP_TAB, LAYOUTS, _fresh, _j_model, _peaks, _seeded_state, _state

F32 = np.float32
CHUNK = pccc.TRACK_CHUNK
DIVIDING_STEPS = 28  # the most dividing steps before p repeats, from the starts below


def _csrc_constant(name):
    src = open(os.path.join(os.path.dirname(pccc.__file__), os.pardir, "csrc",
                            "ccc_track.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


PRECOMPUTED = _csrc_constant("PRECOMPUTED")  # gains the walker makes before it walks


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


def _f2i_rz(v):
    """__float2int_rz: truncation toward 0, NaN to 0, saturating."""
    v = np.asarray(v, F32).astype(np.float64)
    out = np.where(np.isnan(v), 0.0, np.clip(np.trunc(np.nan_to_num(v)), -2.0 ** 31,
                                             2.0 ** 31 - 1))
    return out.astype(np.int32)


def _gains(u, tab):
    """The gain words of filtered peaks u [n, 2] as the kernel makes them:
    the bins clamped to [0, 255], min(min(g_b, 1), g_r), three divisions."""
    u = np.clip(u, 0, 255)
    g_r, g_b = tab[u[:, 0]], tab[u[:, 1]]
    m = np.minimum(np.minimum(g_b, F32(1)), g_r)
    return np.stack([g_b / m, F32(1) / m, g_r / m], axis=-1).astype(F32)


class _Walk:
    """One track's filter as the walker holds it in registers."""

    def __init__(self, x, p, init):
        self.x, self.p, self.init = np.array(x, F32), F32(p), bool(init)
        self.k, self.fixed, self.divided = F32(0), False, 0

    def divide(self, z):
        if not self.init:  # the first measurement: x = z, p as it was
            self.x, self.init = z.astype(F32), True
            return
        pp = F32(self.p + F32(1))
        self.k = F32(pp / F32(pp + F32(10)))
        self.keep(z)
        pn = F32(F32(F32(1) - self.k) * pp)
        self.fixed = _bits(pn) == _bits(self.p)
        self.p = pn
        self.divided += 1

    def keep(self, z):
        self.x = (self.x + (self.k * (z.astype(F32) - self.x).astype(F32)).astype(F32)
                  ).astype(F32)

    def peak(self):
        return _f2i_rz(self.x)


def _dividing_gains(p, need, precomputed):
    """The walker's gains of the dividing steps from p alone (at most
    `precomputed` and `need`): (ks, p after them, whether the last one gave
    p the bits it came in with)."""
    ks, p, rep = [], F32(p), False
    while len(ks) < min(need, precomputed) and not rep:
        pp = F32(p + F32(1))
        k = F32(pp / F32(pp + F32(10)))
        pn = F32(F32(F32(1) - k) * pp)
        ks.append(k)
        rep, p = bool(_bits(pn) == _bits(p)), pn
    return ks, p, rep


def _walk_model(uv, state, track_shape, steps, chunk=CHUNK, precomputed=PRECOMPUTED):
    """Kernel J's launch in numpy: (x [tracks, 2], p [tracks], initialized
    [tracks], gains [rows, 3], dividing steps a track)."""
    tracks = int(np.prod(track_shape))
    tab = np.asarray(EXP_TAB, F32)
    gains = np.empty((len(uv), 3), F32)
    if state is None:  # the flat kernel, no filter
        return None, None, None, _gains(uv, tab), None
    bx, bp, bi = (np.broadcast_to(getattr(state, f).numpy(), tuple(track_shape) + s)
                  .reshape((tracks,) + s) for f, s in (("x", (2,)), ("p", ()),
                                                        ("initialized", ())))
    walks = [_Walk(bx[t], bp[t], bi[t]) for t in range(tracks)]
    with np.errstate(invalid="ignore", over="ignore"):
        if steps == 1:  # the flat kernel: a row a thread, row t is track t
            for t, w in enumerate(walks):
                w.divide(uv[t])
                gains[t] = _gains(w.peak()[None], tab)[0]
        else:  # the chain kernel: a block a track, its peaks a stage at a time
            for t, w in enumerate(walks):
                # the dividing steps' gains first, from p alone
                ks, w.p, w.fixed = _dividing_gains(w.p, steps - (0 if w.init else 1),
                                                   precomputed)
                w.k, w.divided, j = (ks[-1] if ks else F32(0)), len(ks), 0
                for c0 in range(0, steps, chunk):
                    first = t * steps + c0
                    stage = uv[first:first + min(chunk, steps - c0)].astype(F32)
                    walked = np.empty(stage.shape, np.int32)  # x's bits over its z
                    for s in range(len(stage)):
                        if not w.init:  # the first measurement
                            w.divide(stage[s])
                        elif j < len(ks):  # a precomputed gain
                            w.k, j = ks[j], j + 1
                            w.keep(stage[s])
                        elif w.fixed:
                            w.keep(stage[s])
                        else:  # past the precomputed gains with no repeat
                            w.divide(stage[s])
                        walked[s] = w.x.view(np.int32)
                    # the helpers truncate the walked x into the gains' bins
                    gains[first:first + len(stage)] = _gains(_f2i_rz(walked.view(F32)), tab)
    return (np.stack([w.x for w in walks]), np.array([w.p for w in walks], F32),
            np.array([w.init for w in walks]), gains, [w.divided for w in walks])


def _held(uv, state, track_shape, steps, want_state, want_gains, rows=None):
    """The model against the plain version's state and gains (bit for bit;
    `rows`: only those rows' gains)."""
    x, p, init, gains, divided = _walk_model(uv, state, track_shape, steps)
    rows = slice(None) if rows is None else rows
    assert np.array_equal(gains[rows].view(np.int32), want_gains[rows].view(np.int32))
    if state is None:
        assert want_state is None
        return divided
    tracks = int(np.prod(track_shape))
    assert np.array_equal(_bits(x), _bits(want_state.x.numpy().reshape(-1, 2)))
    assert np.array_equal(_bits(p), _bits(np.broadcast_to(want_state.p.numpy(), track_shape)
                                         .reshape(tracks)))
    assert np.array_equal(init, np.broadcast_to(want_state.initialized.numpy(), track_shape)
                          .reshape(tracks))
    return divided


@pytest.mark.parametrize("name,rows,track_shape,steps,shape", LAYOUTS)
@pytest.mark.parametrize("start", ["fresh", "seeded"])
def test_walk_model_equals_plain_and_the_first_kernels_model(name, rows, track_shape, steps,
                                                             shape, start):
    uv = _peaks(rows, rows)
    state = None if shape is None else (
        _fresh(shape) if start == "fresh" else _seeded_state(rows, shape))
    new, gains = pccc.track_plain(torch.as_tensor(uv), torch.as_tensor(EXP_TAB), state,
                                  track_shape=track_shape, steps=steps)
    _held(uv, state, track_shape, steps, new, gains.numpy())
    mx, mp, mi, mgains = _j_model(uv, state, track_shape, steps)
    x, p, init, got, _ = _walk_model(uv, state, track_shape, steps)
    assert np.array_equal(got.view(np.int32), mgains.view(np.int32))
    if state is not None:
        assert np.array_equal(_bits(x), _bits(mx)) and np.array_equal(_bits(p), _bits(mp))
        assert np.array_equal(init, mi)


@pytest.mark.parametrize("steps", [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 3])
@pytest.mark.parametrize("layout", ["sequence, fresh", "sequence, seeded",
                                    "blocked 2 tracks, seeded"])
def test_walk_model_across_stages(steps, layout):
    """Tracks ending just before, on and after a stage's end, and past two:
    each stage starts where the last one's walk stopped (the kept gain
    carries over), and the gains of every stage land on their rows."""
    tracks = 2 if layout.startswith("blocked") else 1
    track_shape = (tracks,) if tracks > 1 else ()
    uv = _peaks(steps + tracks, tracks * steps)
    state = (_fresh(()) if layout.endswith("fresh") else
             _seeded_state(steps, track_shape))
    new, gains = pccc.track_plain(torch.as_tensor(uv), torch.as_tensor(EXP_TAB), state,
                                  track_shape=track_shape, steps=steps)
    divided = _held(uv, state, track_shape, steps, new, gains.numpy())
    assert max(divided) <= DIVIDING_STEPS  # the rest of the track kept the gain


# p near the map's other fixed point (-3.7016): 55 dividing steps, past
# the gains the walker makes before it walks. Its k is negative, so x runs
# away from any z it is not equal to: the peaks are x's own, which keeps
# every peak in the table
FAR_P = -3.701562


@pytest.mark.parametrize("precomputed", [0, 1, 4, PRECOMPUTED])
@pytest.mark.parametrize("p", [0.0, 7.5, FAR_P])
def test_walk_model_past_the_precomputed_gains(precomputed, p):
    """The walker's dividing steps split anywhere between the precomputed
    gains and the ones it makes as it walks: the same state and gains as
    the plain version, and as many dividing steps as kalman_chain counts."""
    n = 80
    uv = _peaks(3, n) if p != FAR_P else np.tile(np.int32([[100, 50]]), (n, 1))
    state = _state([100.0, 50.0], p, True)
    new, gains = pccc.track_plain(torch.as_tensor(uv), torch.as_tensor(EXP_TAB), state,
                                  track_shape=(), steps=n)
    x, pm, init, got, divided = _walk_model(uv, state, (), n, precomputed=precomputed)
    assert np.array_equal(got.view(np.int32), gains.numpy().view(np.int32))
    assert np.array_equal(_bits(x[0]), _bits(new.x.numpy())) and _bits(pm[0]) == _bits(new.p)
    assert divided == [measure.kalman_chain(p, True, n)[0]]
    assert divided[0] == (55 if p == FAR_P else 27 if p == 0.0 else divided[0])


# (label, p, initialized): p at 0, past the fixed point, NaN, +inf and -0.0
EDGE_STATES = [("p 0", 0.0, True), ("p past the fixed point", 7.5, True),
               ("p 1e6", 1e6, True), ("p NaN", np.nan, True), ("p NaN, fresh", np.nan, False),
               ("p +inf", np.inf, True), ("p -0.0", -0.0, True)]


@pytest.mark.parametrize("label,p,init", EDGE_STATES)
@pytest.mark.parametrize("mode", ["sequence", "cameras"])
def test_walk_model_on_edge_states(label, p, init, mode):
    n = 40
    uv = _peaks(n + 7, n)
    track_shape, steps = ((), n) if mode == "sequence" else ((n,), 1)
    state = _state(np.full(track_shape + (2,), 100.25, F32), np.full(track_shape, p, F32),
                   np.full(track_shape, init))
    with np.errstate(invalid="ignore"):  # track_plain's filter, whose gains follow
        want, filtered = (pccc.kalman_scan(state, torch.as_tensor(uv)) if mode == "sequence"
                          else pccc.kalman_update(state, torch.as_tensor(uv)))
    # a NaN x has no peak on the CPU (its int32 is out of the table): the
    # gains of the rows whose peak is in the table
    rows = ((filtered >= 0) & (filtered < pccc.HIST_N)).all(-1)
    want_gains = np.zeros((n, 3), F32)
    want_gains[rows.numpy()] = pccc.gains_from_uv_table(filtered[rows],
                                                        torch.as_tensor(EXP_TAB)).numpy()
    divided = _held(uv, state, track_shape, steps, want, want_gains, rows=rows.numpy())
    assert max(divided) <= DIVIDING_STEPS
    if np.isfinite(p) and p >= 0:
        assert rows.all()


@pytest.mark.parametrize("start", ["0", "seeded in [0, 9]", "1e-30", "1e6", "3e38", "-0.0",
                                   "the fixed point"])
def test_p_repeats_bit_for_bit_within_the_stated_steps(start):
    """From each start, a dividing step gives p the bits it came in with
    within DIVIDING_STEPS steps, and the next step gives them again (a
    cycle of one): the kernel's shortcut is exact from there."""
    starts = {"0": [0.0], "1e-30": [1e-30], "1e6": [1e6], "3e38": [3e38], "-0.0": [-0.0],
              "the fixed point": [2.701562],
              "seeded in [0, 9]": np.random.default_rng(9).uniform(0, 9, 2000)}[start]
    for p0 in np.asarray(starts, F32):
        dividing, keeping = measure.kalman_chain(float(p0), True, 200)
        assert 1 <= dividing <= DIVIDING_STEPS and dividing + keeping == 200
        w = _Walk((0, 0), p0, True)
        for _ in range(dividing):
            w.divide(np.zeros(2, np.int32))
        assert w.fixed
        p, k = w.p, w.k
        w.divide(np.zeros(2, np.int32))  # one more full step: the same bits
        assert _bits(w.p) == _bits(p) and _bits(w.k) == _bits(k)


def test_kalman_chain_counts_and_the_latency_floor():
    # a fresh track: x = z, then 27 dividing steps, then the kept gain
    assert measure.kalman_chain(0.0, False, 1) == (0, 0)  # "cameras", fresh
    assert measure.kalman_chain(0.0, False, 4) == (3, 0)  # the flagship's sequence call
    assert measure.kalman_chain(0.0, False, 64) == (27, 36)  # config 3's
    assert measure.kalman_chain(0.0, True, 64) == (27, 37)
    assert measure.kalman_chain(2.701562, True, 512) == (1, 511)  # at the fixed point
    assert measure.kalman_chain(float("nan"), True, 8) == (1, 7)
    assert measure.kalman_chain(0.0, False, 0) == (0, 0)
    f = measure.ccc_track_floor(0.002, 27, 36)
    chain = (27 * measure.CCC_TRACK_DIVIDE_NS + 36 * measure.CCC_TRACK_KEEP_NS) * 1e-6
    assert f["floor_ms"] == pytest.approx(0.002 + chain)
    assert f["chain_ms"] == pytest.approx(chain) and f["empty_ms"] == 0.002
    longer = measure.ccc_track_floor(0.002, *measure.kalman_chain(0.0, False, 512))
    shorter = measure.ccc_track_floor(0.002, *measure.kalman_chain(0.0, False, 64))
    assert longer["floor_ms"] > shorter["floor_ms"] > 0.002
    assert measure.CCC_TRACK_DIVIDE_NS > measure.CCC_TRACK_KEEP_NS > 0


def test_track_chunk_is_the_c_sources():
    assert _csrc_constant("TRACK_CHUNK") == CHUNK
    src = open(os.path.join(os.path.dirname(pccc.__file__), os.pardir, "csrc",
                            "ccc_track.cu")).read()
    # one launch a call (the chain or the flat kernel), as a programmatic
    # dependent; the empty block of the floor's launch term launched alike
    assert src.count("cudaLaunchKernelEx(") == 3
    assert src.count("cudaLaunchAttributeProgrammaticStreamSerialization") == 2
    assert 'extern "C" int isp_ccc_track_empty(void* stream)' in src


@pytest.mark.parametrize("p,initialized,steps,dividing", [
    (0.0, False, 4, 3), (0.0, False, 5000, 27), (float("nan"), True, 70000, 1),
    (FAR_P, True, 64, 55)])
def test_latency_floor_sums_its_terms(p, initialized, steps, dividing):
    """The floor of a track is the empty launch, its dividing steps at
    CCC_TRACK_DIVIDE_NS and its kept-gain steps at CCC_TRACK_KEEP_NS: every
    step but a fresh track's first (x = z) is one or the other, and p
    repeats after 27 dividing steps from a fresh state, 55 from FAR_P, one
    from a NaN."""
    keeping = steps - (0 if initialized else 1) - dividing
    assert measure.kalman_chain(p, initialized, steps) == (dividing, keeping)
    f = measure.ccc_track_floor(0.0015, dividing, keeping)
    assert f["empty_ms"] == 0.0015
    assert f["floor_ms"] == pytest.approx(
        0.0015 + 1e-6 * (dividing * measure.CCC_TRACK_DIVIDE_NS
                         + keeping * measure.CCC_TRACK_KEEP_NS))
