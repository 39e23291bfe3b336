"""The zlib PNG decoder against PIL on every vendored image."""
import os
import sys
from unittest import mock

import numpy as np
import pytest

from semiblind_tv.utils import images

IMAGE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "images")
VENDORED = ["barbara", "boat", "bridge", "cman", "goldhill", "lake", "man",
            "mandrill", "wheel"]


def test_vendored_list_is_complete():
    assert images.available_images(IMAGE_DIR) == VENDORED


@pytest.mark.parametrize("name", VENDORED)
def test_png_decoder_matches_pil(name):
    from PIL import Image

    path = os.path.join(IMAGE_DIR, name + ".png")
    got = images.read_png_gray8(path)
    want = np.asarray(Image.open(path).convert("L"))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "I;16", "LA"])
def test_png_decoder_rejects_other_kinds(tmp_path, mode):
    from PIL import Image

    path = str(tmp_path / "x.png")
    Image.new(mode, (8, 5)).save(path)
    with pytest.raises(ValueError):
        images.read_png_gray8(path)


def test_load_image_needs_no_pil():
    with mock.patch.dict(sys.modules, {"PIL": None, "PIL.Image": None}):
        x = images.load_image("wheel")
    assert x.shape == (512, 512) and x.dtype == np.float64
    assert 0.0 <= x.min() and x.max() <= 255.0
