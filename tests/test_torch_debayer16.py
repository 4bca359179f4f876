"""The 16-bit Bayer debayer of the PyTorch port against the JAX package on
the CPU: kernel P's plain versions (u16, and u8 as each value >> 8) against
the JAX package's debayer_bilinear16 bit for bit, the op layer's 16-bit
debayer, and the 16-bit chain at flip 0, 90, 180 and 270, 0 mismatching
bytes; the wrapper's dispatch and strip widths on the CPU, and kernel P
against its plain versions on a CUDA card (skipped without one)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_api import assert_equal_outputs, bayer16_case, run_both

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.ops import debayer as jdeb
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.config import FlipConfig
from raw_image_pipeline_tpu_torch.ops import debayer as pdeb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("rggb", "grbg", "gbrg", "bggr")
ENCODINGS = pdeb.BAYER16_ENCODINGS
MODES = (torch.uint8, torch.uint16)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def frames16(hw, seed, b=3):
    """[b, H, W] u16 mosaics: seeded noise, then 0 and 65535 only (the
    averages' extremes), then values near the top, each frame with 0 and
    65535 at its first and last sample."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, 65536, hw), rng.choice([0, 65535], hw),
                  rng.integers(65500, 65536, hw)])[:b].astype(np.uint16)
    x[:, 0, 0], x[:, -1, -1] = 0, 65535
    return x


def _bits(t):
    """A u16 or u8 tensor as numpy (u16 through an int16 view)."""
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.uint16 else t.numpy()


# --- the plain versions against the JAX package -----------------------------


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("hw", [(2, 2), (2, 9), (9, 2), (3, 5), (45, 61), (46, 62)])
def test_plain_equals_reference(hw, phase):
    x = frames16(hw, sum(hw))
    want = np.moveaxis(np.asarray(jdeb.debayer_bilinear16(x, phase)), -1, 1)  # [B, 3, H, W]
    assert want.dtype == np.uint16
    u16 = pdeb.debayer_bilinear16_plain(torch.as_tensor(x), phase, out_dtype=torch.uint16)
    u8 = pdeb.debayer_bilinear16_plain(torch.as_tensor(x), phase, out_dtype=torch.uint8)
    assert u16.dtype == torch.uint16 and u8.dtype == torch.uint8
    np.testing.assert_array_equal(_bits(u16), want)
    np.testing.assert_array_equal(_bits(u8), (want >> 8).astype(np.uint8))


@pytest.mark.parametrize("enc", ENCODINGS)
def test_op_layer_debayer16_equals_plain(enc):
    # the reference package's entry point, its bilinear16 and the chain's
    # planes, on [2, 3, H, W] frames
    x = torch.as_tensor(np.stack([frames16((17, 24), 5), frames16((17, 24), 6)]))
    phase = pdeb.phase_for_encoding(enc)
    got = pdeb.debayer(x, enc)
    assert got.shape == (2, 3, 17, 24, 3) and got.dtype == torch.uint16
    np.testing.assert_array_equal(_bits(got), _bits(pdeb.debayer_bilinear16(x, phase, plain=True)))
    np.testing.assert_array_equal(_bits(got), _bits(pdeb.debayer(x, enc, "mht", plain=True)))
    np.testing.assert_array_equal(_bits(got), np.asarray(jdeb.debayer(x.view(torch.int16).numpy()
                                                                      .view(np.uint16), enc)))
    planes = pdeb.debayer16_planes(x.reshape(6, 17, 24), enc)
    want = (_bits(got).reshape(6, 17, 24, 3) >> 8).astype(np.uint8)
    for c in range(3):
        np.testing.assert_array_equal(planes[c].numpy(), want[..., c])


# --- the chain ----------------------------------------------------------------


@pytest.mark.parametrize("angle", [0, 90, 180, 270])
def test_bayer16_chain_at_each_flip_equals_reference(angle):
    # the flagship (the CCC white balance, the lerp remap) on bayer_gbrg16
    # frames: the planes' flip follows the debayer
    hw = (24, 32)
    c, frames = bayer16_case(hw, seed=15 + angle, flip=FlipConfig(
        enabled=angle != 0, angle=angle))
    jo, po, _, _ = run_both(c, "bayer_gbrg16", frames)
    assert_equal_outputs(jo, po)


# --- the wrapper on the CPU ----------------------------------------------------


def test_kernel_p_is_registered():
    k = kernels.DEBAYER_BILINEAR16
    assert k in kernels.ALL and len(kernels._SIGNATURES[k.entry]) == 9
    assert "debayer16.cu" in kernels.SOURCES and os.path.exists(os.path.join(REPO, k.source))
    path, line = k.replaces.split(" ")[0].split(":")
    with open(os.path.join(REPO, path)) as f:
        assert f.readlines()[int(line) - 1].startswith("def debayer_bilinear16(")


@pytest.mark.parametrize("out_bytes", [1, 2])
def test_strip_width_16(out_bytes):
    # V in columns, at most 8 (one 16-byte word of u16 samples a row): the
    # mosaic's rows need 2V-byte alignment, the output's min(V * out_bytes, 16)
    sw = pdeb.strip_width
    for w, want in ((1920, 8), (1440, 8), (1080, 8), (1444, 4), (1439, 1), (2, 1)):
        assert sw(w, 4096, 8192, 2, out_bytes) == want, w
    assert sw(1920, 4096 + 8, 8192, 2, out_bytes) == 4  # 8 bytes off: 8-byte words
    assert sw(1920, 4096 + 2, 8192, 2, out_bytes) == 1
    assert sw(1920, 4096 + 16, 8192, 2, out_bytes) == 8
    assert sw(1920, 4096, 8192 + 8, 2, out_bytes) == (8 if out_bytes == 1 else 4)
    assert sw(1920, 4096, 8192 + 4, 2, out_bytes) == (4 if out_bytes == 1 else 1)


def test_debayer16_dispatch(monkeypatch):
    # a tensor off the CPU (here on the meta device, where a CUDA tensor
    # would be) takes kernel P's wrapper, once a call, in u8 mode for the
    # chain's planes and u16 mode for the op layer; a CPU tensor or
    # plain=True the plain version
    calls = []

    def fake(bayer, phase, *, out_dtype):
        calls.append((tuple(bayer.shape), phase, out_dtype))
        return torch.empty((bayer.shape[0], 3) + tuple(bayer.shape[1:]), dtype=out_dtype,
                           device=bayer.device)

    monkeypatch.setattr(pdeb, "debayer_bilinear16_cuda", fake)
    meta = torch.empty((2, 3, 8, 10), dtype=torch.uint16, device="meta")
    planes = pdeb.debayer16_planes(meta[0], "bayer_rggb16")
    assert [tuple(p.shape) for p in planes] == [(3, 8, 10)] * 3
    assert planes[0].dtype == torch.uint8
    out = pdeb.debayer(meta, "bayer_bggr16")
    assert tuple(out.shape) == (2, 3, 8, 10, 3) and out.dtype == torch.uint16
    assert calls == [((3, 8, 10), "bggr", torch.uint8), ((6, 8, 10), "rggb", torch.uint16)]
    cpu = torch.as_tensor(frames16((8, 10), 1))
    pdeb.debayer16_planes(cpu, "bayer_rggb16")
    pdeb.debayer(cpu, "bayer_rggb16")
    pdeb.debayer(cpu, "bayer_rggb16", plain=True)
    assert len(calls) == 2
    with pytest.raises(NotImplementedError):
        pdeb.debayer16_planes(cpu, "bayer_rggb8")


def test_wrapper_refuses_cpu_and_bad_modes():
    x = torch.zeros((1, 4, 4), dtype=torch.uint16)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pdeb.debayer_bilinear16_cuda(x, "rggb", out_dtype=torch.uint8)
    for fn in (pdeb.debayer_bilinear16_cuda, pdeb.debayer_bilinear16_plain):
        with pytest.raises(ValueError, match="out_dtype"):
            fn(x, "rggb", out_dtype=torch.int32)


def test_chain_plain_and_cpu_keep_the_plain_version(monkeypatch):
    # plain=True chains and CPU chains never reach the wrapper
    monkeypatch.setattr(pdeb, "debayer_bilinear16_cuda", None)
    hw = (16, 20)
    c, frames = bayer16_case(hw, white_balance=dataclasses.replace(
        tp.flagship_config(*hw).white_balance, enabled=False))
    pipe = tp.build_pipeline(c, "bayer_gbrg16", hw, device="cpu")
    out, _ = pipe(torch.as_tensor(frames))
    assert out["processed"].dtype == torch.uint8


# --- kernel P on the card -------------------------------------------------------


def card_cases16(hw, dev):
    """Kernel P's inputs on the card at hw: B=2, B=1 and frames[1:]; at
    1080x1920 also views 2 and 8 bytes past a 16-byte boundary."""
    x = torch.as_tensor(frames16(hw, 3).astype(np.int32), device=dev).to(torch.int16)
    x = x.view(torch.uint16)
    cases = [x[:2], x[:1], x[1:]]
    if hw == (1080, 1920):
        flat = torch.zeros(8 + 2 * 1080 * 1920, dtype=torch.int16, device=dev)
        flat[4:4 + x[:2].numel()] = x[:2].reshape(-1).view(torch.int16)
        cases += [flat[off:off + 2 * 1080 * 1920].view(torch.uint16).view(2, 1080, 1920)
                  for off in (1, 4)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1080, 1920), (1920, 1080), (1080, 1444), (1079, 1439), (3, 5),
                                (2, 1920), (1080, 2), (2, 2)])
def test_kernel_p_equals_plain_on_card(hw):
    dev = _cuda()
    for bayer in card_cases16(hw, dev):
        for phase in PHASES:
            for mode in MODES:
                got = pdeb.debayer_bilinear16_cuda(bayer, phase, out_dtype=mode)
                want = pdeb.debayer_bilinear16_plain(bayer, phase, out_dtype=mode)
                assert got.dtype == want.dtype == mode
                assert torch.equal(got.view(torch.int8), want.view(torch.int8))


@pytest.mark.cuda
def test_kernel_p_reached_by_chain_and_op_layer_on_card():
    dev = _cuda()
    x = torch.as_tensor(frames16((48, 64), 4).astype(np.int32), device=dev).to(torch.int16)
    x = x.view(torch.uint16)
    kernels.reset_launch_counts()
    got = pdeb.debayer(x, "bayer_gbrg16")
    assert kernels.DEBAYER_BILINEAR16.launches == 1
    want = pdeb.debayer(x, "bayer_gbrg16", plain=True)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    hw = (48, 64)
    c, frames = bayer16_case(hw)
    card = tp.build_pipeline(c, "bayer_gbrg16", hw, device="cuda")
    kernels.reset_launch_counts()
    out, _ = card(torch.as_tensor(frames.astype(np.int32), device=dev).to(torch.int16)
                  .view(torch.uint16))
    assert kernels.DEBAYER_BILINEAR16.launches == 1
    cpu = tp.build_pipeline(c, "bayer_gbrg16", hw, device="cpu")
    ref, _ = cpu(torch.as_tensor(frames))
    assert torch.equal(out["processed"].cpu(), ref["processed"])
