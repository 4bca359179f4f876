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

All per-frame steps run batched over the frames as plain eager ops; every
tie-break is an explicit first-occurrence selection over unique keys, and
every f32 formula rounds op by op, so the CPU and CUDA compute the same
numbers.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.common import image_planes, planes_image
from raw_image_pipeline_tpu_torch.ops.white_balance import Planes, apply_gains_8p8

_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "raw_image_pipeline_tpu", "models", "data", "learned_wb_default.npz",
)

_HIST_BINS = 64
_N_BINS = _HIST_BINS ** 3
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


def extract_features(planes: Planes, thresh255: int) -> torch.Tensor:
    """Planes (b, g, r) [B, H, W] u8 -> [B, 4, 2] f32 features f0..f3."""
    B, G, R = (p.to(torch.int32) for p in planes)
    nb = B.shape[0]
    dev = B.device
    mx = torch.maximum(torch.maximum(B, G), R)
    keep = mx < thresh255
    n = keep.sum(dim=(-2, -1)).clamp(min=1)  # [B]

    # f0: means in f64 over the kept pixels, normalised by the max mean
    sums = torch.stack([torch.where(keep, C, 0).to(torch.int64).sum(dim=(-2, -1))
                        for C in (B, G, R)], dim=-1)  # [B, 3] exact
    means = sums.to(torch.float64) / n.to(torch.float64)[:, None]
    mm = means.amax(dim=-1, keepdim=True)
    mm = torch.where(mm <= 0, 1.0, mm)  # all-black kept set: no normalisation
    nrm = (means / mm).to(torch.float32)
    f0 = _chroma(nrm[:, 2], nrm[:, 1], nrm[:, 0])

    # f1: brightest kept pixel, the library's 8-lane first-wins rank
    flat_sum = torch.where(keep, B + G + R, -1).reshape(nb, -1)
    npx = flat_sum.shape[1]
    body_n = (npx // 8) * 8
    pos = torch.arange(npx, device=dev)
    rank = torch.where(pos < body_n, (pos % 8) * (body_n // 8) + pos // 8, pos)
    at_max = flat_sum == flat_sum.amax(dim=-1, keepdim=True)
    rmin = torch.where(at_max, rank, _BIG).amin(dim=-1, keepdim=True)
    bi = _first_index(at_max & (rank == rmin))[:, None]  # [B, 1]
    # a fully saturated frame keeps no pixel: f1 stays at its zero init
    any_kept = flat_sum.gather(1, bi) >= 0

    def at_bi(C):
        v = C.reshape(nb, -1).gather(1, bi)
        return torch.where(any_kept, v, 0).to(torch.float32)[:, 0]

    f1 = _chroma(at_bi(R), at_bi(G), at_bi(B))

    # f2: the first maximal bin of the 64^3 histogram of kept pixels
    hi = torch.clamp(mx.amax(dim=(-2, -1)), min=_HIST_BINS).to(torch.float32)[:, None, None]

    def bidx(v):
        i = torch.floor(v.to(torch.float32) * float(_HIST_BINS) / hi).to(torch.int64)
        return torch.clamp(i, 0, _HIST_BINS - 1)

    bid = (bidx(B) * _HIST_BINS + bidx(G)) * _HIST_BINS + bidx(R)
    frame_off = (torch.arange(nb, device=dev) * _N_BINS)[:, None, None]
    # masked pixels go to one extra bin past the last frame's
    slot = torch.where(keep, bid + frame_off, nb * _N_BINS)
    counts = torch.bincount(slot.reshape(-1), minlength=nb * _N_BINS + 1)
    counts = counts[:-1].reshape(nb, _N_BINS)
    dom = _first_index(counts == counts.amax(dim=-1, keepdim=True))
    db, dg, dr = _bin_channels(dom)
    f2 = _chroma(dr, dg, db)

    # f3: top-300 palette by (count desc, bin asc) — unique keys, so the
    # order is total — and the mode of its KDE
    bins = torch.arange(_N_BINS, device=dev)
    key = -counts * _N_BINS + bins  # ascending = count desc, then bin asc
    pkey = torch.topk(key, _PALETTE, dim=-1, largest=False, sorted=True).values
    pbin = torch.remainder(pkey, _N_BINS)
    valid = counts.gather(1, pbin) > 0  # below 300 bins: zero-count padding
    pb, pg, pr = _bin_channels(pbin)
    ps = ((pb + pg) + pr) + _EPS
    pu = pr / ps
    pv = pg / ps
    du = pu[:, :, None] - pu[:, None, :]
    dv = pv[:, :, None] - pv[:, None, :]
    ker = torch.clamp(1.0 - (du * du + dv * dv) / _BW2, min=0.0)
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


def balance_white_learned_planes(planes: Planes, saturation_thresh: float = 0.98) -> Planes:
    """Planes (b, g, r) -> balanced planes, by the default LearningBasedWB
    model. The saturation threshold is trunc(f32(thresh) * 255)."""
    thresh255 = int(np.trunc(np.float32(saturation_thresh) * 255))
    uv = predict_illuminant(extract_features(planes, thresh255))
    u, v = uv[:, 0], uv[:, 1]
    illum = torch.stack([(1.0 - u) - v, v, u], dim=-1)  # B, G, R
    illum = torch.clamp(illum, min=float(np.float32(1e-6)))
    gains = illum.amin(dim=-1, keepdim=True) / illum
    gi = torch.round(gains * 256.0).to(torch.int32)
    return apply_gains_8p8(planes, gi)


def balance_white_learned_model(image: torch.Tensor,
                                saturation_thresh: float = 0.98) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR frames -> balanced, by the default
    LearningBasedWB model (balance_white_learned_planes per frame of the
    flattened batch)."""
    lead, planes = image_planes(image)
    return planes_image(balance_white_learned_planes(planes, saturation_thresh), lead)
