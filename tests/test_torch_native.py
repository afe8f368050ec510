"""The port's native C++ image loader (mqslam_tpu_torch.native, its own
copy of the source, built into mqslam_tpu_torch/_build/) against PIL: the
JAX package's tests/test_native.py cases."""

import os

import numpy as np
import pytest
from PIL import Image

from mqslam_tpu_torch import native
from mqslam_tpu_torch.io import images


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("native toolchain unavailable (g++, libpng, libjpeg)")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i in range(6):
        arr = rng.randint(0, 255, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"frame-{i}.png")
    gray = rng.randint(0, 255, (32, 40), dtype=np.uint8)
    Image.fromarray(gray, mode="L").save(d / "gray.png")
    Image.fromarray(arr).save(d / "color.jpg", quality=95)
    return d


def test_png_matches_pil(built, image_dir):
    path = str(image_dir / "frame-0.png")
    got = native.decode_gray(path)
    want = images.load_image_gray(path)
    assert got.shape == want.shape and got.dtype == np.float32
    # PIL uses the same BT.601 luma; integer rounding differs by <1 level
    assert np.abs(got - want).max() <= 1.0


def test_gray_png_exact(built, image_dir):
    path = str(image_dir / "gray.png")
    np.testing.assert_array_equal(native.decode_gray(path),
                                  images.load_image_gray(path))


def test_jpeg_decodes(built, image_dir):
    path = str(image_dir / "color.jpg")
    got = native.decode_gray(path)
    want = images.load_image_gray(path)
    assert got.shape == want.shape
    assert np.abs(got - want).mean() < 4.0  # JPEG luma path differences


def test_sequence_prefetch_order(built, image_dir):
    paths = [str(image_dir / f"frame-{i}.png") for i in range(6)]
    seq = native.ImageSequence(paths, queue_depth=2)
    frames = list(seq)
    assert len(frames) == 6
    for p, f in zip(paths, frames):
        np.testing.assert_array_equal(f, native.decode_gray(p))
    seq.close()


def test_missing_file_raises(built, tmp_path):
    with pytest.raises(IOError):
        native.decode_gray(str(tmp_path / "none.png"))


def test_library_in_the_build_dir_named_by_digest(built, monkeypatch,
                                                   tmp_path):
    """The library lives under ``_build/`` beside the kernels, named by a
    digest of the source: nothing is written beside the source, and a
    changed source builds a new library."""
    lib = native.build()
    assert os.path.dirname(lib) == native.BUILD_DIR
    assert os.path.basename(lib).startswith("libmqslam_io_")
    beside = os.listdir(os.path.dirname(native._SRC))
    assert not [f for f in beside if f.endswith((".so", ".tmp"))]
    src = tmp_path / "imageio.cpp"
    src.write_text(open(native._SRC).read() + "\n// changed\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native._target() != lib


def test_build_failure_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    """No fallback: a source that does not compile raises with g++'s
    message, leaves no temporary file, and ``available()`` is then false
    (for a fresh process state)."""
    src = tmp_path / "imageio.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    assert os.listdir(tmp_path / "_build") == []
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_gray(str(tmp_path / "x.png"))
