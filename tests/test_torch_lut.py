"""Kernel O, the u8 lookup table (ops/gamma.py, csrc/lut.cu): the port's
plain apply_lut against the JAX package's apply_lut on the CPU, exactly
(0 mismatching bytes), over every byte value, the gamma, BT.709 and a
seeded table, and frames, planes, a strided slab view, 1-d and empty
tensors; the host's rules (a row's split into head, 16-byte body and tail;
the rows a tensor is read as, or a copy); a model of the kernel's walk over
those rows; its registration. The cuda-marked test holds kernel O to the
plain version on the card (tools/card_tests.py runs it there)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw_image_pipeline_tpu.ops import gamma as jgamma
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops import gamma as pgamma

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = {
    "gamma_0.9": lambda: pgamma.build_gamma_lut(0.9),
    "bt709_forward": lambda: pgamma.build_bt709_lut(True),
    "bt709_inverse": lambda: pgamma.build_bt709_lut(False),
    "seeded": lambda: np.random.default_rng(22).integers(0, 256, 256, dtype=np.uint8),
}
_JAX_LUT = jax.jit(jgamma.apply_lut)


def _inputs():
    """(label, torch tensor) pairs: every byte value, planes, frames, a
    strided slab view of rows, 1-d and empty."""
    rng = np.random.default_rng(5)
    planes = torch.as_tensor(rng.integers(0, 256, (3, 17, 31), dtype=np.uint8))
    frames = torch.as_tensor(rng.integers(0, 256, (2, 45, 61, 3), dtype=np.uint8))
    big = torch.as_tensor(rng.integers(0, 256, (3, 40, 48), dtype=np.uint8))
    return [("every value", torch.arange(256, dtype=torch.uint8).reshape(16, 16)),
            ("[3, 17, 31]", planes), ("[2, 45, 61, 3]", frames),
            ("slab rows 7-29 of [3, 40, 48]", big[:, 7:29]),
            ("1-d", planes.reshape(-1)[3:300]), ("empty", planes[:, :0])]


def test_tables_match_the_jax_package():
    assert np.array_equal(pgamma.build_gamma_lut(0.9), jgamma.build_gamma_lut(0.9))
    for forward in (True, False):
        assert np.array_equal(pgamma.build_bt709_lut(forward), jgamma.build_bt709_lut(forward))


@pytest.mark.parametrize("table", list(TABLES))
def test_plain_apply_lut_equals_jax_apply_lut(table):
    lut = TABLES[table]()
    for label, x in _inputs():
        got = pgamma.apply_lut(x, torch.as_tensor(lut), plain=True)
        want = np.asarray(_JAX_LUT(jnp.asarray(x.contiguous().numpy()), jnp.asarray(lut)))
        assert got.shape == x.shape and got.dtype == torch.uint8, label
        assert int((got.numpy() != want).sum()) == 0, label
        if label == "every value":  # each of the 256 values, exactly the table
            assert np.array_equal(got.numpy().reshape(-1), lut)


def test_lut_split_rule():
    # head bytes up to the first 16-byte boundary, whole chunks, the rest
    assert pgamma.lut_split(0, 1920) == (0, 120, 0)
    assert pgamma.lut_split(1, 1920) == (15, 119, 1)
    assert pgamma.lut_split(8, 1080) == (8, 67, 0)
    assert pgamma.lut_split(16 * 7 + 3, 20) == (13, 0, 7)
    assert pgamma.lut_split(5, 4) == (4, 0, 0)
    assert pgamma.lut_split(32, 15) == (0, 0, 15)
    assert pgamma.lut_split(12, 0) == (0, 0, 0)
    for addr in range(16):
        for n in (0, 1, 15, 16, 17, 33, 1081):
            head, body, tail = pgamma.lut_split(addr, n)
            assert head + 16 * body + tail == n and 0 <= tail < 16 and 0 <= head < 16
            assert body == 0 or (addr + head) % 16 == 0


def test_lut_layout_rule():
    # a contiguous tensor is one row (the flat path), whatever its shape
    for shape in ((4, 1080, 1920), (2, 45, 61, 3), (7,), (), (1, 1, 5)):
        t = torch.zeros(shape, dtype=torch.uint8)
        assert pgamma.lut_layout(t.shape, t.stride()) == (1, t.numel(), 1, 0, 0)
    frames = torch.zeros((4, 45, 64), dtype=torch.uint8)
    # the mesh's row slabs: whole rows, a row a frame at the frame stride
    assert pgamma.lut_layout(frames[:, 5:30].shape, frames[:, 5:30].stride()) == (
        4, 25 * 64, 1, 45 * 64, 0)
    # a crop of columns: a row a frame's row, at the row stride
    v = frames[:, :, 1:]
    assert pgamma.lut_layout(v.shape, v.stride()) == (4 * 45, 63, 1, 64, 0)
    v = frames[::2]  # every other frame
    assert pgamma.lut_layout(v.shape, v.stride()) == (2, 45 * 64, 1, 2 * 45 * 64, 0)
    v = frames[:1].expand(3, 45, 64)  # frames that repeat one: stride 0
    assert pgamma.lut_layout(v.shape, v.stride()) == (3, 45 * 64, 1, 0, 0)
    # leading axes that fold into one, then two axes: frames and rows
    x = torch.zeros((2, 3, 10, 16), dtype=torch.uint8)[:, :, 2:8]
    assert pgamma.lut_layout(x.shape, x.stride()) == (6, 96, 1, 160, 0)
    x = torch.zeros((2, 3, 5, 7), dtype=torch.uint8)[:, 1:, :, 2:]
    assert pgamma.lut_layout(x.shape, x.stride()) == (20, 5, 10, 105, 7)
    x = frames[1:, 3:, 8:]
    assert pgamma.lut_layout(x.shape, x.stride()) == (3 * 42, 56, 42, 45 * 64, 64)
    # what it copies first: pixels not contiguous, three axes of rows
    colours = torch.zeros((2, 5, 7, 3), dtype=torch.uint8)
    assert pgamma.lut_layout(colours[..., 0].shape, colours[..., 0].stride()) is None
    assert pgamma.lut_layout(frames.transpose(1, 2).shape, frames.transpose(1, 2).stride()) is None
    x = torch.zeros((2, 3, 5, 7), dtype=torch.uint8)[:, 1:, 1:, 2:]
    assert pgamma.lut_layout(x.shape, x.stride()) is None


def _kernel_walk(mem: np.ndarray, base: int, layout, lut: np.ndarray) -> np.ndarray:
    """csrc/lut.cu's walk in numpy: each row's body chunks (16-byte aligned
    loads), then its head and tail bytes by the edge slots; returns the
    output, asserting that each output byte is written once."""
    rows, width, h, sb, sy = layout
    out = np.zeros(rows * width, np.int64) - 1
    for r in range(rows):
        a = base + (r // h) * sb + (r % h) * sy
        head, body, tail = pgamma.lut_split(a, width)
        o = r * width
        for j in range(body):
            src = a + head + 16 * j
            assert src % 16 == 0
            assert (out[o + head + 16 * j:o + head + 16 * j + 16] == -1).all()
            out[o + head + 16 * j:o + head + 16 * j + 16] = lut[mem[src:src + 16]]
        for s in range(32):  # the edge slots
            x = (s if s < head else -1) if s < 16 else (
                width - tail + s - 16 if s - 16 < tail else -1)
            if x >= 0:
                assert out[o + x] == -1
                out[o + x] = lut[mem[a + x]]
    assert (out >= 0).all()
    return out.astype(np.uint8)


def test_kernel_walk_covers_every_byte_once():
    rng = np.random.default_rng(9)
    lut = rng.integers(0, 256, 256, dtype=np.uint8)
    store = torch.as_tensor(rng.integers(0, 256, 4 * 45 * 64 + 16, dtype=np.uint8))
    for off in (0, 1, 8, 13):
        frames = store[off:off + 4 * 45 * 64].view(4, 45, 64)
        for view in (frames, frames[:, 5:30], frames[:, :, 1:], frames[::2, 3:],
                     frames[2, 1:9, 3:60], frames.reshape(-1)[:37]):
            layout = pgamma.lut_layout(view.shape, view.stride())
            got = _kernel_walk(store.numpy(), view.storage_offset(), layout, lut)
            assert np.array_equal(got, lut[view.numpy().reshape(-1)]), (off, view.shape)


def test_kernel_o_is_registered():
    k = kernels.LUT
    assert k in kernels.ALL and len(kernels._SIGNATURES[k.entry]) == 9
    assert "lut.cu" in kernels.SOURCES and os.path.exists(os.path.join(REPO, k.source))
    path, rest = k.replaces.split(":")
    line, fn = rest.split(" ")
    with open(os.path.join(REPO, path)) as f:
        assert f.readlines()[int(line) - 1].startswith(f"def {fn}(")


def test_lut_flip_variants_apply_to_the_sources():
    # tools/lut_flip_variants.py builds its variants of kernels O and N from
    # their sources by text replacements, each of which must still apply
    from raw_image_pipeline_tpu_torch.tools import lut_flip_variants as lv

    assert {v[0] for v in lv.VARIANTS.values()} == set(lv.ENTRIES) == {"O", "N"}
    for name, (kern, src, repl, _) in lv.VARIANTS.items():
        text = lv.variant_source(name, kernels.CSRC_DIR)
        assert f'extern "C" int {lv.ENTRIES[kern]}(' in text, name
        for _, new in repl:
            assert new in text, name
        assert lv.ENTRIES[kern] in kernels._SIGNATURES


def test_lut_cuda_refuses_what_kernel_o_does_not_take():
    x = torch.zeros((2, 5, 7), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        pgamma.lut_cuda(x, torch.zeros(256, dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        pgamma.lut_cuda(x.to(torch.int16), torch.zeros(256, dtype=torch.uint8))
    # on a CPU tensor apply_lut is the gather and launches nothing
    before = kernels.LUT.launches
    lut = pgamma.build_gamma_lut(0.9)
    assert torch.equal(pgamma.apply_lut(x, lut), torch.as_tensor(lut)[x.long()])
    assert kernels.LUT.launches == before


# --- kernel O on the card -------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_o_equals_plain_on_card(card):
    g = torch.Generator(device=card)
    g.manual_seed(7)
    lut = torch.randint(0, 256, (256,), generator=g, dtype=torch.uint8, device=card)
    store = torch.randint(0, 256, (4 * 1080 * 1920 + 64,), generator=g, dtype=torch.uint8,
                          device=card)
    for off in (0, 1, 8):
        frames = store[off:off + 4 * 1080 * 1920].view(4, 1080, 1920)
        for view in (frames, frames[:, 270:540], frames[:, :, 1:1440], frames[1:, 3:, 8:],
                     frames.reshape(-1)[:4097], frames[:, :0], frames[0, 0, :5]):
            before = kernels.LUT.launches
            got = pgamma.apply_lut(view, lut)
            assert kernels.LUT.launches == before + (1 if view.numel() else 0)
            assert torch.equal(got, pgamma.apply_lut(view, lut, plain=True)), (off, view.shape)
            assert got.is_contiguous()
