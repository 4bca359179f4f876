"""The port's user programs (raw_image_pipeline_tpu_torch/tools:
run_pipeline, apply_pipeline, ccc_tune, color_calibration, stream_bench,
gpu_parity_check) and its utils (image_io, logging, profiling) on the CPU.

Each tool runs with --device cpu beside the JAX package's tool on the same
inputs (the JAX side on the CPU, as its own tests run it): 0 mismatching
decoded bytes in every PNG written, equal camera_info.yaml and printed
text, f32 gains equal bit for bit. The image-level CCC functions of
ops/ccc.py are held to the JAX package's on seeded images, the PNG codec
of utils/image_io (cv2 hidden from it) to cv2, and every entry point's
default device to the card (it raises where there is none)."""

import contextlib
import dataclasses
import io
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.models.ccc_model import load_ccc_model as jax_load_ccc_model
from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.tools import apply_pipeline as jax_apply_pipeline
from raw_image_pipeline_tpu.tools import ccc_tune as jax_ccc_tune
from raw_image_pipeline_tpu.tools import color_calibration as jax_color_calibration
from raw_image_pipeline_tpu.tools import run_pipeline as jax_run_pipeline
from raw_image_pipeline_tpu_torch.config import DEFAULT_CCC_MODEL_PATH
from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.tools import (
    apply_pipeline,
    ccc_tune,
    color_calibration,
    gpu_parity_check,
    png_writer_bench,
    run_pipeline,
    stream_bench,
)
from raw_image_pipeline_tpu_torch.utils import get_logger, image_io, stage_timings, trace_profile

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "alphasense.png")
WAIT_S = 60.0  # the longest any wait for a live output may take


def _run(main, argv):
    """(main(argv), what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def _pngs(root):
    """{path relative to root: decoded array} of every PNG under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    return out


def _assert_same_pngs(a_root, b_root, count):
    a, b = _pngs(a_root), _pngs(b_root)
    assert sorted(a) == sorted(b) and len(a) == count
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert int((a[k] != b[k]).sum()) == 0, k


# --- run_pipeline, directory mode ------------------------------------------


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """The 5 seeded 64x96 frames of the JAX package's directory-mode test,
    as PNGs and as headerless raw files."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(1)
    for kind in ("png", "raw"):
        (root / kind).mkdir()
    for i in range(5):
        f = rng.integers(0, 256, (64, 96), np.uint8)
        cv2.imwrite(str(root / "png" / f"f{i}.png"), f)
        f.tofile(str(root / "raw" / f"f{i}.raw"))
    return root


# png: the JAX test's arguments; raw: the native pump, the float remap and
# the output flags
RUN_CASES = {
    "png": ([], 15),
    "raw": (["--raw-shape", "64x96", "--remap-interpolation", "float", "--skip-slow", "1",
             "--output-encoding", "RGB", "--output-frame", "cam0"], 17),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_pipeline_directory_equals_reference(tmp_path, frame_dirs, case):
    extra, count = RUN_CASES[case]
    argv = ["-i", str(frame_dirs / case), "-e", "bayer_gbrg8", "-b", "2"] + extra
    jax_run_pipeline.main(argv + ["-o", str(tmp_path / "jax")])
    n, text = _run(run_pipeline.main, argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert n == 5 and "processed 5 frames" in text
    # color, color_rect and debayered for each frame (+ color/slow)
    _assert_same_pngs(tmp_path / "jax", tmp_path / "port", count)
    jax_info = (tmp_path / "jax" / "camera_info.yaml").read_text()
    assert (tmp_path / "port" / "camera_info.yaml").read_text() == jax_info
    if case == "raw":
        assert yaml.safe_load(jax_info)["rect"]["frame_id"] == "cam0"


# --- run_pipeline, live mode -------------------------------------------------


@pytest.mark.parametrize("control", [False, True], ids=["listen", "listen_control"])
def test_run_pipeline_live_equals_api(tmp_path, control):
    """The port's counterparts of the JAX package's
    test_run_pipeline_listen_mode and test_run_pipeline_listen_with_control:
    live mode writes one numbered output a frame and a camera_info.yaml;
    the control channel resets the white balance and reloads the params.
    Each output equals the port's API on the CPU processing the same frame
    after the same commands."""
    frames = np.random.default_rng(0).integers(0, 256, (3, 64, 96), np.uint8)
    out = tmp_path / "out"
    argv = ["--raw-shape", "64x96", "-e", "bayer_gbrg8", "--device", "cpu"]
    commands = ("reset_white_balance", "reload_params") if control else ()
    with contextlib.redirect_stdout(io.StringIO()):
        n, replies = run_pipeline.drive_live(frames, str(out), argv, commands, timeout=WAIT_S)
    assert n == 3
    assert sorted(p.name for p in out.glob("*.png")) == [f"{k:06d}.png" for k in range(3)]
    assert (out / "camera_info.yaml").exists()
    assert replies == (["ok", "ok params reloaded"] if control else [])
    cfg = tp.config  # the tool's default files
    api = tp.RawImagePipeline(False, cfg.DEFAULT_PARAMS_PATH, cfg.DEFAULT_CALIBRATION_PATH,
                              cfg.DEFAULT_COLOR_CALIBRATION_PATH, device="cpu")
    for k, f in enumerate(frames):
        if control and k == 1:
            api.reset_white_balance_temporal_consistency()
            api.load_params(cfg.DEFAULT_PARAMS_PATH)
        got = cv2.imread(str(out / f"{k:06d}.png"), cv2.IMREAD_UNCHANGED)
        assert int((got != api.process(f, "bayer_gbrg8")).sum()) == 0


# --- apply_pipeline, ccc_tune ------------------------------------------------


def test_apply_pipeline_equals_reference(tmp_path):
    argv = ["-i", FIXTURE]
    _, want = _run(jax_apply_pipeline.main, argv + ["-o", str(tmp_path / "jax")])
    _, got = _run(apply_pipeline.main, argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert got.replace("port", "jax") == want  # the printed matrices
    _assert_same_pngs(tmp_path / "jax", tmp_path / "port", 2)


CCC_TUNE_CASES = {"argmax": [], "offsets": ["--lu-offset", "0.3", "--lv-offset", "-0.2"]}


@pytest.mark.parametrize("case", sorted(CCC_TUNE_CASES))
def test_ccc_tune_equals_reference(tmp_path, case):
    """Output PNG and printed text equal to the JAX tool's; the gains equal
    the JAX functions' bit for bit. The fixture's peak (111, 139) is not
    one of the bins where XLA:CPU's exp is 1 ulp off libm, so the port's
    libm table and the JAX package's jnp.exp give the same gains."""
    extra = CCC_TUNE_CASES[case]
    jax_out, port_out = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    _, want = _run(jax_ccc_tune.main, ["-i", FIXTURE, "-o", jax_out] + extra)
    gains, got = _run(ccc_tune.main, ["-i", FIXTURE, "-o", port_out, "--device", "cpu"] + extra)
    assert got.replace(port_out, jax_out) == want
    a, b = cv2.imread(jax_out), cv2.imread(port_out)
    assert a.shape == (540, 1440, 3) and int((a != b).sum()) == 0
    if case == "offsets":
        ref = np.asarray(jccc.gains_from_offsets(0.3, -0.2))
    else:
        import jax.numpy as jnp

        img = cv2.imread(FIXTURE)
        model = jax_load_ccc_model(DEFAULT_CCC_MODEL_PATH)
        small = jccc.resize_linear_u8(img[None], jccc.SMALL_H, jccc.SMALL_W)
        hist = jccc.log_chroma_histogram(small, 0.9, 0.1, jccc.UV0)
        uv = jccc.response_argmax(jccc.ccc_response(
            hist, jnp.asarray(model.filt_dft_re), jnp.asarray(model.filt_dft_im),
            jnp.asarray(model.bias)))
        assert np.asarray(uv).tolist() == [[111, 139]]
        ref = np.asarray(jccc.gains_from_uv(uv, jccc.UV0))[0]
    np.testing.assert_array_equal(gains.view(np.uint32), ref.view(np.uint32))


# --- the image-level CCC functions --------------------------------------------


def _cast_images(seed, n, h, w):
    """[n, h, w, 3] u8 BGR frames with a colour cast each, saturated and
    black pixels included."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (n, h, w, 1)) * rng.uniform(0.3, 1.6, (n, 1, 1, 3))
    img = np.clip(base * 300 - 20, 0, 255).astype(np.uint8)
    img[:, :2, :2] = 0
    img[:, -2:, -2:] = 255
    return img


@pytest.mark.parametrize("thr", [(0.9, 0.1, jccc.UV0), (0.8, 0.2, jccc.UV0), (0.95, 0.05, -1.3)])
def test_log_chroma_histogram_image_equals_reference(thr):
    img = _cast_images(3, 2, 270, 360)
    want = np.asarray(jccc.log_chroma_histogram(img, *thr))
    got = pccc.log_chroma_histogram(torch.as_tensor(img), *thr).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lu,lv,uv0", [(0.3, -0.2, jccc.UV0), (-1.0, 1.5, jccc.UV0),
                                       (0.0, 0.0, -1.3)])
def test_gains_from_offsets_and_apply_gains_equal_reference(lu, lv, uv0):
    want = np.asarray(jccc.gains_from_offsets(lu, lv, uv0))
    got = pccc.gains_from_offsets(lu, lv, uv0, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    img = _cast_images(4, 2, 30, 40)
    np.testing.assert_array_equal(
        pccc.apply_gains(torch.as_tensor(img), torch.as_tensor(got)[None]).numpy(),
        np.asarray(jccc.apply_gains(img, want[None])))


@pytest.mark.parametrize("kalman", [False, True], ids=["per_frame", "kalman"])
def test_ccc_balance_white_equals_reference(kalman):
    """Two calls on seeded [3, 90, 120, 3] batches; with the Kalman state
    carried, the second call's update runs (x = z on the first)."""
    jmodel = jax_load_ccc_model(DEFAULT_CCC_MODEL_PATH)
    pmodel = load_ccc_model(DEFAULT_CCC_MODEL_PATH)
    jstate = jccc.kalman_init(()) if kalman else None
    pstate = pccc.kalman_init((), device="cpu") if kalman else None
    for seed in (5, 6):
        img = _cast_images(seed, 3, 90, 120)
        want, jstate = jccc.ccc_balance_white(img, jmodel, 0.9, 0.1, jstate)
        got, pstate = pccc.ccc_balance_white(torch.as_tensor(img), pmodel, 0.9, 0.1, pstate)
        assert int((got.numpy() != np.asarray(want)).sum()) == 0
        assert not np.array_equal(got.numpy(), img)
    if kalman:
        np.testing.assert_array_equal(pstate.x.numpy(), np.asarray(jstate.x))
        np.testing.assert_array_equal(pstate.p.numpy(), np.asarray(jstate.p))
    else:
        assert pstate is None


# --- color_calibration ---------------------------------------------------------


def test_color_calibration_centroids_and_solver():
    """tests/test_color_calibration_tool.py's centroid and solver cases on
    the port's copy."""
    from test_color_calibration_tool import synth_board

    img, colors = synth_board()
    cents = color_calibration.get_color_centroids(img)
    assert cents is not None and cents.shape == (24, 3)
    np.testing.assert_allclose(cents, colors, atol=2)
    M_true = np.array([[1.2, 0.1, -0.05], [0.05, 0.9, 0.02], [-0.1, 0.05, 1.1]])
    distorted = np.clip(colors @ np.linalg.inv(M_true).T, 0, 255)
    M, bias = color_calibration.find_color_calibration(distorted, colors.astype(float), "linear")
    np.testing.assert_allclose(distorted @ M.T, colors, atol=1.0)


def test_color_calibration_cli_equals_reference(tmp_path):
    """The end-to-end CLI case: the port's YAML recovers the chart and
    equals the JAX tool's, byte for byte, as does the check PNG."""
    from test_color_calibration_tool import synth_board

    ref_img, colors = synth_board()
    M_true = np.array([[0.8, 0.1, 0.0], [0.0, 1.1, 0.05], [0.05, 0.0, 1.2]])
    dist_colors = np.clip(colors @ M_true.T, 0, 255).astype(int)
    dist_img, _ = synth_board(colors=dist_colors)
    cv2.imwrite(str(tmp_path / "ref.png"), ref_img)
    cv2.imwrite(str(tmp_path / "shot.png"), dist_img)
    argv = ["-i", str(tmp_path / "shot.png"), "-r", str(tmp_path / "ref.png"), "-l", "soft_l1"]
    _run(jax_color_calibration.main, argv + ["-o", str(tmp_path / "jax")])
    _run(color_calibration.main, argv + ["-o", str(tmp_path / "port")])
    out_yaml = tmp_path / "port" / "color_calibration.yaml"
    assert out_yaml.read_text() == (tmp_path / "jax" / "color_calibration.yaml").read_text()
    _assert_same_pngs(tmp_path / "jax", tmp_path / "port", 1)
    cc = tp.load_color_calibration(str(out_yaml))
    rec = dist_colors @ cc.matrix_np().T + cc.bias_np()
    assert np.abs(rec - colors).mean() < 4


# --- utils/image_io's PNG codec, cv2 hidden from it ----------------------------


@pytest.fixture()
def no_cv2(monkeypatch):
    monkeypatch.setattr(image_io, "cv2_module", lambda: None)


def _image(kind):
    rng = np.random.default_rng(len(kind))
    shape, dtype = {"grey8": ((37, 53), np.uint8), "grey16": ((37, 53), np.uint16),
                    "bgr8": ((37, 53, 3), np.uint8), "bgr16": ((37, 53, 3), np.uint16),
                    "bgra8": ((37, 53, 4), np.uint8), "grey8_c1": ((37, 53, 1), np.uint8),
                    "bgr8_1px": ((1, 1, 3), np.uint8)}[kind]
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


# (image, cv2's PNG compression level): libpng picks each row's filter, and
# every kind here gets all five (Average and Paeth: the decoder's wavefront)
READ_CASES = [(k, lvl) for k in ("grey8", "grey16", "bgr8", "bgr16", "bgra8") for lvl in (1, 9)]


@pytest.mark.parametrize("kind,level", READ_CASES)
def test_image_io_reads_cv2_written_pngs_like_cv2(tmp_path, no_cv2, kind, level):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, _image(kind), [cv2.IMWRITE_PNG_COMPRESSION, level])
    flags = [cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR]
    if kind.startswith("grey"):
        flags.append(cv2.IMREAD_GRAYSCALE)
    for f in flags:
        want = cv2.imread(path, f)
        got = image_io.imread(path, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want)


def test_image_io_reads_fixtures_like_cv2(no_cv2):
    """alphasense.png (720x540 RGB, every row filter) and the 16-bit
    gehler_shi.png."""
    raw = open(FIXTURE, "rb").read()
    assert raw[24:26] == b"\x08\x02"  # 8-bit RGB
    for path in (FIXTURE, os.path.join(HERE, "fixtures", "gehler_shi.png")):
        for f in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
            np.testing.assert_array_equal(image_io.imread(path, f), cv2.imread(path, f))


@pytest.mark.parametrize("kind", ["grey8", "grey16", "grey8_c1", "bgr8", "bgr16", "bgra8",
                                  "bgr8_1px"])
def test_image_io_writes_what_cv2_reads(tmp_path, no_cv2, kind):
    img = _image(kind)
    path = str(tmp_path / "x.png")
    assert image_io.imwrite(path, img)
    want = img[..., 0] if img.shape[-1:] == (1,) and img.ndim == 3 else img
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(image_io.imread(path, cv2.IMREAD_UNCHANGED), want)


def test_image_io_writes_png_by_its_encoder_and_the_rest_by_cv2(tmp_path):
    """With cv2 importable, a .png path still gets encode_png's bytes; a
    .jpg path is written by cv2."""
    img = _image("bgr8")
    assert image_io.imwrite(str(tmp_path / "x.png"), img)
    assert (tmp_path / "x.png").read_bytes() == image_io.encode_png(img)
    assert image_io.imwrite(str(tmp_path / "x.jpg"), img)
    assert cv2.imread(str(tmp_path / "x.jpg")).shape == img.shape


def test_png_writer_bench_on_cpu(capsys):
    """Every writer of the bench on both contents (each checked by decoding
    a crop inside the bench); the bench's Sub, level 1, Huffman-only
    variant writes encode_png's very bytes."""
    res = png_writer_bench.main(["--device", "cpu", "--height", "48", "--width", "64",
                                 "--reps", "1"])
    assert sorted(res) == ["fixture", "synthetic"]
    for content, rows in res.items():
        assert "image_io.encode_png" in rows and len(rows) >= 1 + 5 * 4
        assert rows["image_io.encode_png"]["bytes"] == rows["sub, level 1, huffman"]["bytes"]
        assert all(r["bytes"] > 0 and r["ms"] > 0 for r in rows.values())
    img = _image("bgr8")
    assert png_writer_bench.encode(img, "sub", 1, "huffman") == image_io.encode_png(img)
    assert "png_writer_bench fixture 64x48" in capsys.readouterr().out


def test_image_io_reads_none_sub_up_rows_row_by_row(tmp_path, no_cv2):
    """A file whose rows use only the None, Sub and Up filters (the
    decoder's row-by-row path), 8- and 16-bit: decoded like cv2 decodes it."""
    import struct
    import zlib

    for kind, bpp in (("bgr8", 3), ("bgr16", 6)):
        img = _image(kind)
        h = img.shape[0]
        rows = np.ascontiguousarray(img[..., ::-1], ">u2" if bpp == 6 else np.uint8)
        rows = rows.view(np.uint8).reshape(h, -1)
        filtered = np.zeros((h, rows.shape[1] + 1), np.uint8)
        prev = np.zeros(rows.shape[1], np.uint8)
        for y in range(h):
            f = y % 3
            filtered[y, 0] = f
            left = np.concatenate([np.zeros(bpp, np.uint8), rows[y, :-bpp]])
            filtered[y, 1:] = rows[y] - (0, left, prev)[f] if f else rows[y]
            prev = rows[y]
        good = image_io.encode_png(img)
        idat = zlib.compress(filtered.tobytes())
        data = (good[:33] + struct.pack(">I", len(idat)) + b"IDAT" + idat
                + struct.pack(">I", zlib.crc32(b"IDAT" + idat) & 0xFFFFFFFF)
                + good[-12:])
        (tmp_path / "x.png").write_bytes(data)
        path = str(tmp_path / "x.png")
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(image_io.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_image_io_refuses_what_it_cannot_read_or_write(tmp_path, no_cv2):
    import struct
    import zlib

    assert image_io.imread(str(tmp_path / "missing.png")) is None
    with pytest.raises(ValueError):
        image_io.imwrite(str(tmp_path / "x.jpg"), _image("bgr8"))
    with pytest.raises(ValueError):
        image_io.imwrite(str(tmp_path / "x.png"), _image("bgr8").astype(np.float32))
    good = image_io.encode_png(_image("bgr8"))
    # palette, grey+alpha, 4-bit, Adam7
    for ctype, depth, interlace in ((3, 8, 0), (4, 8, 0), (2, 4, 0), (2, 8, 1)):
        body = struct.pack(">IIBBBBB", 53, 37, depth, ctype, 0, 0, interlace)
        ihdr = (struct.pack(">I", 13) + b"IHDR" + body
                + struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF))
        (tmp_path / "bad.png").write_bytes(good[:8] + ihdr + good[33:])
        with pytest.raises(ValueError):
            image_io.imread(str(tmp_path / "bad.png"))


def test_writer_pool_writes_and_counts_failures(tmp_path, no_cv2):
    imgs = [_image("bgr8") + k for k in range(6)]
    pool = image_io.WriterPool(threads=3, queue_cap=2)
    for k, img in enumerate(imgs):
        pool.write(str(tmp_path / f"{k}.png"), img)
        img[...] = 0  # the pool copied it
    pool.write(str(tmp_path / "missing_dir" / "x.png"), imgs[0])
    assert pool.flush() == 1
    pool.close()
    for k in range(6):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / f"{k}.png")), _image("bgr8") + k)


# --- stream_bench, gpu_parity_check, profiling, logging ------------------------


def test_stream_bench_on_cpu(tmp_path, capsys):
    fps = stream_bench.main(["--device", "cpu", "--frames", "5", "--height", "16", "--width",
                             "24", "--batch", "2", "--frames-dir", str(tmp_path)])
    assert sorted(fps) == ["counting sink", "sink reads 1 px/frame"]
    assert all(v > 0 for v in fps.values())
    assert "sink calls: {'color': 5, 'color_rect': 5, 'debayered': 5}" in capsys.readouterr().err


def test_gpu_parity_chunk_digest_on_cpu():
    """The tool's per-chunk function on the CPU lands on its shipped digest
    (tests/test_torch_ops.py asserts every digest beside the JAX outputs)."""
    assert gpu_parity_check.chunk_digest("hsv_to_bgr_scalar_any_h", 2, "cpu") == \
        gpu_parity_check.DIGESTS["hsv_to_bgr_scalar_any_h"][2]
    assert set(gpu_parity_check.DIGESTS) == set(gpu_parity_check.CONVERSIONS)
    assert all(len(v) == gpu_parity_check.N_CHUNKS for v in gpu_parity_check.DIGESTS.values())


def test_gpu_parity_white_balance_and_chain_on_cpu(monkeypatch, no_cv2):
    """The tool's golden and chain checks through its own code on the CPU,
    every image read by image_io's codec. Its golden cases are those
    tests/test_torch_wb.py holds the plain versions to; the small inputs'
    cases run here (test_torch_wb.py runs them all)."""
    from test_torch_wb import _oracle_cases

    cases = gpu_parity_check.oracle_cases()
    want = {f"{n}_{m}_{p}.png" if p is not None else f"{n}_{m}.png"
            for n, m, p in _oracle_cases()} | {"alphasense_crop49x550_learned_0.9.png"}
    assert {os.path.basename(c[3]) for c in cases} == want
    small = [c for c in cases if os.path.basename(c[3]).startswith(("gauss", "noise"))]
    assert len(small) == 17
    monkeypatch.setattr(gpu_parity_check, "oracle_cases", lambda: small)
    log = []
    assert gpu_parity_check.check_white_balance(log.append, "cpu") == 0
    assert gpu_parity_check.check_chain(log.append, "cpu") == 0
    assert len(log) == 2


def test_gpu_parity_check_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        gpu_parity_check.main()


def _defaults_argv(tmp_path):
    raw = tmp_path / "in"
    raw.mkdir()
    np.zeros((16, 24), np.uint8).tofile(str(raw / "f.raw"))
    return {
        "run_pipeline": (run_pipeline.main, ["-i", str(raw), "-o", str(tmp_path / "o"),
                                             "--raw-shape", "16x24"]),
        "apply_pipeline": (apply_pipeline.main, ["-i", FIXTURE, "-o", str(tmp_path / "o")]),
        "ccc_tune": (ccc_tune.main, ["-i", FIXTURE, "-o", str(tmp_path / "o.png")]),
        "stream_bench": (stream_bench.main, ["--frames", "1", "--height", "16", "--width",
                                             "24", "--frames-dir", str(tmp_path / "f")]),
    }


@pytest.mark.parametrize("tool", ["run_pipeline", "apply_pipeline", "ccc_tune", "stream_bench"])
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, tool):
    """Without --device each tool runs on the card; with none it raises
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = _defaults_argv(tmp_path)[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"), contextlib.redirect_stderr(
            io.StringIO()):
        main(argv)


def test_stage_timings_keys_equal_reference():
    """The JAX function's keys on a subset of stages (the JAX chain
    compiles once a stage), the full order on the port; every value a
    non-negative number of seconds."""
    from raw_image_pipeline_tpu_torch.utils import profiling

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.utils.profiling import stage_timings as jax_stage_timings

    h, w = 16, 24
    px = np.random.default_rng(7).integers(0, 256, (2, h, w), np.uint8)
    stages = ["color_calibration"]
    want = jax_stage_timings(ge._full_config((h, w)), "bayer_gbrg8", px, stages, repeats=1)
    got = stage_timings(tp.flagship_config(h, w), "bayer_gbrg8", px, stages, 1, device="cpu")
    assert list(got) == list(want) == ["overhead"] + stages
    # every stage off: each truncated chain builds at once, the keys are the same
    off = tp.flagship_config(h, w)
    off = off.replace(**{k: dataclasses.replace(getattr(off, k), enabled=False)
                         for k in profiling.ORDER})
    full = stage_timings(off, "bayer_gbrg8", px, repeats=1, device="cpu")
    assert list(full) == ["overhead", "debayer", "flip", "white_balance", "color_calibration",
                          "gamma_correction", "vignetting_correction", "color_enhancer",
                          "undistortion"]
    assert all(isinstance(v, float) and v >= 0 for v in {**got, **full}.values())


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    x = torch.arange(12.0)
    out = trace_profile(lambda a: a * 2, x, log_dir=str(tmp_path))
    assert torch.equal(out, x * 2)
    assert "traceEvents" in (tmp_path / "trace.json").read_text()


def test_get_logger_namespace():
    root = get_logger()
    assert root.name == "raw_image_pipeline_tpu_torch" and not root.propagate
    assert len(root.handlers) == 1
    assert get_logger("raw_image_pipeline_tpu_torch.tools").name == \
        "raw_image_pipeline_tpu_torch.tools"
    # a JAX package name (the port's prefix without "_torch") is a child
    assert get_logger("raw_image_pipeline_tpu.ops").name == \
        "raw_image_pipeline_tpu_torch.raw_image_pipeline_tpu.ops"
    assert len(get_logger().handlers) == 1
