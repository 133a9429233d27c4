"""The port's grid writer and scatter plots (graphical_gan_tpu_torch/
report/{save_images,visualization}.py) against the JAX package's: the
port writes its PNGs without PIL, and PIL decodes each to the JAX
``large_image`` array, gray and RGB, for flat, BCHW and BHWC input, float
and uint8, on the square-ish grid and on an explicit ``size``. The IHDR
reader gives the grid's size and refuses a file that is no PNG. ``scatter``
writes a file and ``tsne_2d`` is sklearn's TSNE as in JAX."""

import importlib
import os

import numpy as np
import pytest
from PIL import Image

from graphical_gan_tpu.report import visualization as jax_vis
from graphical_gan_tpu_torch.report import save_images as si
from graphical_gan_tpu_torch.report import visualization as vis

# the JAX report package exports the function save_images under the module's
# name
jax_si = importlib.import_module("graphical_gan_tpu.report.save_images")
RNG = np.random.default_rng(0)
CASES = {
    "mnist flat float": RNG.random((12, 784)),
    "gray BCHW float": RNG.random((6, 1, 8, 8)),
    "rgb BCHW float": RNG.random((128, 3, 4, 4)),
    "rgb BHWC uint8": RNG.integers(0, 256, (10, 5, 5, 3), dtype=np.uint8),
    "gray BHW uint8": RNG.integers(0, 256, (7, 6, 6), dtype=np.uint8),
}
SIZES = {"mnist flat float": (2, 6), "gray BCHW float": (3, 2),
         "rgb BCHW float": (4, 32), "rgb BHWC uint8": (1, 10),
         "gray BHW uint8": (7, 1)}


@pytest.mark.parametrize("size", [False, True], ids=["square", "size"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_png_decodes_to_the_jax_montage(tmp_path, name, size):
    x = CASES[name]
    sz = SIZES[name] if size else None
    path = str(tmp_path / "grid.png")
    si.save_images(x, path, size=sz)
    want = jax_si.large_image(x, size=sz)
    with Image.open(path) as im:
        got = np.asarray(im)
        assert im.mode == ("L" if want.ndim == 2 else "RGB")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(si.large_image(x, size=sz), want)
    w, h, color = si.png_size(path)
    assert (h, w) == want.shape[:2] and color == (0 if want.ndim == 2 else 2)


def test_the_grid_refuses_a_size_that_does_not_hold_the_images(tmp_path):
    with pytest.raises(ValueError, match="does not hold"):
        si.save_images(CASES["gray BHW uint8"], str(tmp_path / "x.png"),
                       size=(2, 3))


def test_png_size_refuses_a_file_that_is_no_png(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="not a PNG"):
        si.png_size(str(path))


def test_scatter_writes_the_plot_and_the_means(tmp_path):
    data = RNG.normal(size=(50, 2))
    labels = np.eye(5)[RNG.integers(0, 5, 50)]  # one-hot labels
    path = vis.scatter(data, labels, str(tmp_path), "m.png",
                       mus=RNG.normal(size=(5, 2)))
    assert path == os.path.join(str(tmp_path), "m.png")
    for name in ("m.png", "mus_m.png"):
        assert os.path.getsize(tmp_path / name) > 0


def test_tsne_2d_is_the_jax_tsne():
    x = RNG.normal(size=(40, 6))
    np.testing.assert_allclose(vis.tsne_2d(x), jax_vis.tsne_2d(x),
                               rtol=0, atol=0)
