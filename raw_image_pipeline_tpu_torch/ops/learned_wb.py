"""cv::xphoto::LearningBasedWB with the library's default model (PyTorch
port of raw_image_pipeline_tpu/ops/learned_wb.py; reference:
modules/white_balance.cpp:66-71).

The model (160 depth-4 regression trees: 20 tree-sets x 4 features x 2
chromaticity components) is read with numpy from the reference package's
models/data/learned_wb_default.npz. Per frame:

  f0: chromaticity of the average unsaturated colour: channel means in f64,
      divided by the max mean in f64, narrowed to f32 (native f64 here);
  f1: chromaticity of the brightest unsaturated pixel (max B+G+R). Ties
      follow the library's 8-lane SIMD scan over the flattened frame, all
      first-wins: minimal (flat % 8, flat // 8) among the body pixels,
      then the scalar tail by position;
  f2: chromaticity of the first (lowest bin id) maximal bin of a 64^3
      histogram over [0, max(64, max pixel)) of the unsaturated pixels;
  f3: mode of the top-300 palette, ordered (count desc, bin asc) and
      zero-padded below 300 bins, under an Epanechnikov KDE of bandwidth
      0.1, the f32 density summed in the JAX package's CPU order (windows
      of 32, then the window sums); first maximum wins;

with every chromaticity (r, g) = (R, G) / (((R + G) + B) + 1e-5) in f32.
Inference: a tree-set reaches consensus when more than 2 of the 6 pairwise
distances among its 4 predictions are below 0.025; the illuminant is the
per-component upper median over the consensus sets' predictions (over all
80 when no set agrees). Gains min(illum)/illum are applied in 8.8 fixed
point with a truncating descale.

The method runs as ops/white_balance's three steps: the statistics
record (learned_stats_plain; kernel K), the 64^3 histogram of the kept
pixels (hist64_plain; kernel L, hist64_cuda), and the per-frame tables of
the features (features_plain), the trees and the gains
(learned_tables_plain; kernel M), applied by kernel G's table step. The
plain versions run batched over the frames as eager ops; every tie-break
is an explicit first-occurrence selection over unique keys, and every f32
formula rounds op by op, so the CPU and CUDA compute the same numbers.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops.common import gains_tables_8p8

_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "raw_image_pipeline_tpu", "models", "data", "learned_wb_default.npz",
)

_HIST_BINS = 64
N_BINS = _HIST_BINS ** 3
_PALETTE = 300
# XLA:CPU's tree reduction of a 300-wide row: 10 windows of 32 over the row
# padded by 10 zeros at each end
_SUM_WIN = 32
_SUM_PAD = 10
_BW2 = float(np.float32(0.1 ** 2))  # f32 of the bandwidth squared
_PRED_THRESH = 0.025
_EPS = float(np.float32(1e-5))
_N_SETS = 20
_DEPTH = 4
_BIG = torch.iinfo(torch.int64).max
# the statistics record's slots (learned_stats_plain)
KEPT, SUM_B, SUM_G, SUM_R, HI, KEY, PIXEL = range(7)
SLOTS = 7


@functools.lru_cache(maxsize=1)
def _load_model():
    """(feature index [160, 15] int64, thresholds [160, 15] f32, leaves
    [160, 16] f32) as numpy arrays."""
    d = np.load(_MODEL_PATH)
    fi = d["feature_idx"].reshape(160, 15).astype(np.int64)
    tv = d["thresh_vals"].reshape(160, 15).astype(np.float32)
    lv = d["leaf_vals"].reshape(160, 16).astype(np.float32)
    return fi, tv, lv


@functools.lru_cache(maxsize=None)
def _model_tensors(device: torch.device):
    """_load_model's arrays on `device`, copied there once."""
    return tuple(torch.as_tensor(a, device=device) for a in _load_model())


@functools.lru_cache(maxsize=None)
def model_tensors_card(device: torch.device):
    """The model as kernel M reads it, on `device`, copied there once: the
    feature index as int32 [2400], thresholds f32 [2400], leaves f32
    [2560]."""
    fi, tv, lv = _load_model()
    return tuple(torch.as_tensor(np.ascontiguousarray(a.reshape(-1)), device=device)
                 for a in (fi.astype(np.int32), tv, lv))


def _first_index(cond: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (the axis length if
    none)."""
    n = cond.shape[-1]
    ar = torch.arange(n, device=cond.device)
    return torch.where(cond, ar, n).amin(dim=-1)


def _chroma(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 2] f32 (r, g) / (((r + g) + b) + eps)."""
    s = ((r + g) + b) + _EPS
    return torch.stack([r / s, g / s], dim=-1)


def _bin_channels(bins: torch.Tensor):
    """64^3 bin ids -> their (b, g, r) bin indices as f32."""
    return ((bins // (_HIST_BINS * _HIST_BINS)).to(torch.float32),
            ((bins // _HIST_BINS) % _HIST_BINS).to(torch.float32),
            (bins % _HIST_BINS).to(torch.float32))


def learned_t255(saturation_thresh: float) -> int:
    """The saturation threshold, trunc(f32(thresh) * 255): a pixel is kept
    while max(b, g, r) is below it."""
    return int(np.trunc(np.float32(saturation_thresh) * 255))


def _rank(npx: int, device) -> torch.Tensor:
    """[npx] int64: a flat position's rank in the library's 8-lane SIMD
    scan (lane-major over the body of whole groups of 8, then the scalar
    tail by position)."""
    body_n = (npx // 8) * 8
    pos = torch.arange(npx, device=device)
    return torch.where(pos < body_n, (pos % 8) * (body_n // 8) + pos // 8, pos)


def learned_stats_plain(planes, thresh255: int) -> torch.Tensor:
    """Kernel K's plain version in learned's mode: planes (b, g, r)
    [B, H, W] u8 -> [B, SLOTS] int64, per frame
      KEPT       the pixels kept (max(b, g, r) < thresh255);
      SUM_B..R   their channel sums;
      HI         max(b, g, r) over all pixels (the histogram's range);
      KEY        (s + 1) << 32 | (2^32 - 1 - rank) of the brightest kept
                 pixel, s = b + g + r, ties to the lowest rank (_rank);
                 0 where no pixel is kept;
      PIXEL      that pixel's b | g << 8 | r << 16 (0 where none)."""
    B, G, R = (p.to(torch.int32) for p in planes)
    nb = B.shape[0]
    mx = torch.maximum(torch.maximum(B, G), R)
    keep = mx < thresh255
    kept = keep.sum(dim=(-2, -1))
    sums = [torch.where(keep, C, 0).to(torch.int64).sum(dim=(-2, -1)) for C in (B, G, R)]
    hi = mx.amax(dim=(-2, -1)).to(torch.int64)
    flat_sum = torch.where(keep, B + G + R, -1).reshape(nb, -1)
    rank = _rank(flat_sum.shape[1], B.device)
    best = flat_sum.amax(dim=-1, keepdim=True)
    at_max = flat_sum == best
    best = best.to(torch.int64)
    rmin = torch.where(at_max, rank, _BIG).amin(dim=-1, keepdim=True)
    bi = _first_index(at_max & (rank == rmin))[:, None]  # [B, 1]
    found = best[:, 0] >= 0
    key = torch.where(found, ((best[:, 0] + 1) << 32) | ((1 << 32) - 1 - rmin[:, 0]), 0)
    px = [C.reshape(nb, -1).gather(1, bi)[:, 0].to(torch.int64) for C in (B, G, R)]
    pixel = torch.where(found, px[0] | (px[1] << 8) | (px[2] << 16), 0)
    return torch.stack([kept, *sums, hi, key, pixel], dim=-1)


def hist64_plain(planes, record: torch.Tensor, thresh255: int) -> torch.Tensor:
    """Kernel L's plain version: the [B, N_BINS] int32 64^3 histogram of
    the kept pixels, bin index floor(f32(v) * 64 / hi) clamped to [0, 63]
    a channel, hi = max(64, the record's HI) in f32."""
    B, G, R = (p.to(torch.int32) for p in planes)
    nb = B.shape[0]
    keep = torch.maximum(torch.maximum(B, G), R) < thresh255
    hi = torch.clamp(record[:, HI], min=_HIST_BINS).to(torch.float32)[:, None, None]

    def bidx(v):
        i = torch.floor(v.to(torch.float32) * float(_HIST_BINS) / hi).to(torch.int64)
        return torch.clamp(i, 0, _HIST_BINS - 1)

    bid = (bidx(B) * _HIST_BINS + bidx(G)) * _HIST_BINS + bidx(R)
    frame_off = (torch.arange(nb, device=B.device) * N_BINS)[:, None, None]
    # masked pixels go to one extra bin past the last frame's
    slot = torch.where(keep, bid + frame_off, nb * N_BINS)
    counts = torch.bincount(slot.reshape(-1), minlength=nb * N_BINS + 1)
    return counts[:-1].reshape(nb, N_BINS).to(torch.int32)


def features_plain(record: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Kernel M's features, plain: the record (learned_stats_plain) and the
    64^3 histogram (hist64_plain) -> [B, 4, 2] f32 features f0..f3."""
    nb = record.shape[0]
    dev = record.device
    n = record[:, KEPT].clamp(min=1)  # [B]

    # f0: means in f64 over the kept pixels, normalised by the max mean
    sums = record[:, SUM_B:SUM_R + 1]  # [B, 3] exact
    means = sums.to(torch.float64) / n.to(torch.float64)[:, None]
    mm = means.amax(dim=-1, keepdim=True)
    mm = torch.where(mm <= 0, 1.0, mm)  # all-black kept set: no normalisation
    nrm = (means / mm).to(torch.float32)
    f0 = _chroma(nrm[:, 2], nrm[:, 1], nrm[:, 0])

    # f1: the brightest kept pixel (a fully saturated frame keeps none: f1
    # stays at its zero init)
    px = record[:, PIXEL]
    f1 = _chroma(((px >> 16) & 255).to(torch.float32), ((px >> 8) & 255).to(torch.float32),
                 (px & 255).to(torch.float32))

    # f2: the first maximal bin of the 64^3 histogram of kept pixels
    counts = hist.to(torch.int64)
    dom = _first_index(counts == counts.amax(dim=-1, keepdim=True))
    db, dg, dr = _bin_channels(dom)
    f2 = _chroma(dr, dg, db)

    # f3: top-300 palette by (count desc, bin asc) — unique keys, so the
    # order is total — and the mode of its KDE
    bins = torch.arange(N_BINS, device=dev)
    key = -counts * N_BINS + bins  # ascending = count desc, then bin asc
    pkey = torch.topk(key, _PALETTE, dim=-1, largest=False, sorted=True).values
    pbin = torch.remainder(pkey, N_BINS)
    valid = counts.gather(1, pbin) > 0  # below 300 bins: zero-count padding
    pb, pg, pr = _bin_channels(pbin)
    ps = ((pb + pg) + pr) + _EPS
    pu = pr / ps
    pv = pg / ps
    du = pu[:, :, None] - pu[:, None, :]
    dv = pv[:, :, None] - pv[:, None, :]
    # a divisor on the record's device: CUDA divides by a CPU scalar as a
    # product by its reciprocal, which is not the division
    bw2 = torch.full((), _BW2, dtype=torch.float32, device=dev)
    ker = torch.clamp(1.0 - (du * du + dv * dv) / bw2, min=0.0)
    ker = ker * (valid[:, :, None] & valid[:, None, :])
    # the f32 density in the JAX package's order on the CPU: the row,
    # padded with _SUM_PAD zeros at each end, summed in windows of _SUM_WIN
    # in order, then the window sums in order (densities of near-gray bins
    # tie within an ulp, so the order picks the mode)
    kp = torch.nn.functional.pad(ker, (_SUM_PAD, _SUM_PAD)).reshape(nb, _PALETTE, -1, _SUM_WIN)
    part = kp[..., 0]
    for j in range(1, _SUM_WIN):
        part = part + kp[..., j]
    dens = part[..., 0]
    for j in range(1, part.shape[-1]):
        dens = dens + part[..., j]
    dens = torch.where(valid, dens, -torch.inf)
    mi = _first_index(dens == dens.amax(dim=-1, keepdim=True))[:, None]
    f3 = torch.stack([pu.gather(1, mi)[:, 0], pv.gather(1, mi)[:, 0]], dim=-1)
    return torch.stack([f0, f1, f2, f3], dim=1)


def extract_features(planes, thresh255: int) -> torch.Tensor:
    """Planes (b, g, r) [B, H, W] u8 -> [B, 4, 2] f32 features f0..f3
    (the plain statistics, histogram and features composed)."""
    record = learned_stats_plain(planes, thresh255)
    return features_plain(record, hist64_plain(planes, record, thresh255))


def predict_illuminant(features: torch.Tensor) -> torch.Tensor:
    """[B, 4, 2] features -> [B, 2] illuminant (u, v): tree descent,
    consensus per set, upper median."""
    fi, tv, lv = _model_tensors(features.device)
    nb = features.shape[0]
    ar = torch.arange(160, device=features.device)
    # tree t = s*8 + i*2 + k predicts component k of feature i in set s
    x = features[:, (ar % 8) // 2]  # [B, 160, 2]
    node = torch.zeros((nb, 160), dtype=torch.int64, device=features.device)
    for _ in range(_DEPTH):
        f = fi.reshape(-1)[ar * 15 + node]
        th = tv.reshape(-1)[ar * 15 + node]
        val = torch.where(f == 0, x[..., 0], x[..., 1])
        node = torch.where(val <= th, 2 * node + 1, 2 * node + 2)
    preds = lv.reshape(-1)[ar * 16 + node - 15].reshape(nb, _N_SETS, 4, 2)

    d = preds[:, :, :, None, :] - preds[:, :, None, :, :]  # [B, 20, 4, 4, 2]
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    iu = torch.triu_indices(4, 4, 1, device=features.device)
    agree = (dist[:, :, iu[0], iu[1]] < _PRED_THRESH).sum(dim=-1)  # [B, 20]
    consensus = agree > 2
    flat = preds.reshape(nb, 80, 2)
    w = consensus.repeat_interleave(4, dim=-1)  # [B, 80]
    n_cons = w.sum(dim=-1, keepdim=True)

    def upper_median(vals, mask, count):
        s = torch.sort(torch.where(mask, vals, torch.inf), dim=-1).values
        return s.gather(1, count // 2)[:, 0]

    all_80 = torch.ones_like(w)
    cons = torch.stack([upper_median(flat[..., k], w, n_cons) for k in (0, 1)], dim=-1)
    every = torch.stack([upper_median(flat[..., k], all_80, torch.full_like(n_cons, 80))
                         for k in (0, 1)], dim=-1)
    return torch.where(consensus.any(dim=-1, keepdim=True), cons, every)


def learned_gains(uv: torch.Tensor) -> torch.Tensor:
    """[B, 2] illuminant (u, v) -> [B, 3] int32 8.8 gains (B, G, R),
    min(illum) / illum rounded."""
    u, v = uv[:, 0], uv[:, 1]
    illum = torch.stack([(1.0 - u) - v, v, u], dim=-1)  # B, G, R
    illum = torch.clamp(illum, min=float(np.float32(1e-6)))
    gains = illum.amin(dim=-1, keepdim=True) / illum
    return torch.round(gains * 256.0).to(torch.int32)


def learned_tables_plain(record: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Kernel M's plain version in learned's mode: [B, 3, 256] u8 tables
    of the gains the model predicts from the record's and the histogram's
    features."""
    return gains_tables_8p8(learned_gains(predict_illuminant(features_plain(record, hist))))


def hist64_cuda(planes, record: torch.Tensor, thresh255: int, hist: torch.Tensor, *,
                batch_limit: int = kernels.MAX_BATCH) -> torch.Tensor:
    """Kernel L: hist64_plain for three [B, H, W] u8 CUDA planes of equal
    strides, added into `hist`, a zeroed [B, N_BINS] int32 CUDA tensor
    (kernel K's workspace), which comes back; one launch per run of
    kernels.batch_runs(B, batch_limit)."""
    bsz, h, w = planes[0].shape
    for i, p in enumerate(planes):
        if (p.device.type != "cuda" or p.dtype != torch.uint8 or p.stride() != planes[0].stride()
                or tuple(p.shape) != (bsz, h, w) or p.device != planes[0].device):
            raise ValueError(f"kernel L: planes[{i}] is not a [B, H, W] uint8 CUDA plane of "
                             f"planes[0]'s shape and strides")
    kernels.check_cuda(record, "record", torch.int64, (bsz, SLOTS))
    kernels.check_cuda(hist, "hist", torch.int32, (bsz, N_BINS))
    with torch.cuda.device(planes[0].device):
        for f0, n in kernels.batch_runs(bsz, batch_limit):
            kernels.WB_HIST64.launch(
                *(p[f0].data_ptr() for p in planes), *planes[0].stride(), n, h, w, thresh255,
                record[f0].data_ptr(), hist[f0].data_ptr(), kernels.stream_handle(hist))
    return hist


def balance_white_learned_planes(planes, saturation_thresh: float = 0.98, *,
                                 plain: bool = False):
    """Planes (b, g, r) -> balanced planes, by the default LearningBasedWB
    model (statistics, histogram, tables, apply: ops/white_balance). The
    saturation threshold is trunc(f32(thresh) * 255)."""
    from raw_image_pipeline_tpu_torch.ops.white_balance import balance_white_planes

    return balance_white_planes(planes, "learned", saturation_thresh, plain=plain)


def balance_white_learned_model(image: torch.Tensor, saturation_thresh: float = 0.98, *,
                                plain: bool = False) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR frames -> balanced, by the default
    LearningBasedWB model."""
    from raw_image_pipeline_tpu_torch.ops.white_balance import balance_white_learned

    return balance_white_learned(image, saturation_thresh, plain=plain)
