"""The port's PNG codec (``mdu_tpu_torch/utils/image.py``) against PIL, which
the JAX CLI reads and writes every image with (``mdu_tpu/cli.py:219, 293,
305, 446, 476``): the writer's files read back by PIL (pixels and the
``parameters`` text), the reader against ``PIL.Image.open(...).convert(
"RGB")`` and ``convert("L")`` on PNGs that PIL writes in modes L, LA, RGB,
RGBA and P with ``optimize`` off and on, a hand-filtered file with every
row filter, every text chunk kind, and the clear error for another format
when PIL is missing. All comparisons exact (uint8)."""
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, PngImagePlugin

from mdu_tpu_torch.utils import image as pimage


def _texture(h, w, seed):
    """Smooth gradients with noise: PIL's adaptive filtering picks every
    filter type on such rows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 3 + xx) % 256, (xx * 5) % 256, (yy * 7 + xx * 2) % 256], -1)
    return (base + rng.integers(0, 12, (h, w, 3))).astype(np.uint8)


@pytest.mark.parametrize("gray", [False, True])
def test_writer_round_trips_through_pil(tmp_path, gray):
    img = _texture(33, 47, 0)
    if gray:
        img = img[..., 0]
    info = '{"Prompt": "a cat", "Seed": 7, "Tiled Diffusion": {"Method": "MultiDiffusion"}}'
    path = str(tmp_path / "out.png")
    pimage.save_png(path, img, {"parameters": info})
    got = Image.open(path)
    assert got.mode == ("L" if gray else "RGB")
    np.testing.assert_array_equal(np.asarray(got), img)
    assert got.text["parameters"] == info
    # and through the port's own reader
    np.testing.assert_array_equal(pimage.load_image(path, "L" if gray else "RGB"), img)
    assert pimage.image_text(path) == {"parameters": info}


def test_writer_non_latin1_text(tmp_path):
    path = str(tmp_path / "u.png")
    pimage.save_png(path, _texture(8, 8, 1), {"parameters": "snow ☃", "k": "é"})
    assert Image.open(path).text == {"parameters": "snow ☃", "k": "é"}


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_reader_matches_pil(tmp_path, mode, optimize):
    rgb = _texture(41, 67, 2)
    if mode == "P":
        src = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=200)
    else:
        alpha = np.random.default_rng(3).integers(0, 256, (41, 67), dtype=np.uint8)
        src = Image.fromarray(np.concatenate([rgb, alpha[..., None]], -1), "RGBA").convert(mode)
    path = str(tmp_path / f"{mode}.png")
    src.save(path, optimize=optimize)
    ref = Image.open(path)
    assert ref.mode == mode
    for conv in ("RGB", "L"):
        got = pimage.load_image(path, conv)
        want = np.asarray(ref.convert(conv))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} -> {conv}")


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filter_row(t, row, prev, bpp):
    """PNG filter ``t`` of one scanline (uint8 rows as int arrays)."""
    out = []
    for i in range(row.size):
        a = int(row[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        if t == 0:
            p = 0
        elif t == 1:
            p = a
        elif t == 2:
            p = b
        elif t == 3:
            p = (a + b) // 2
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((int(row[i]) - p) % 256)
    return bytes([t] + out)


@pytest.mark.parametrize("color,bpp", [(2, 3), (6, 4), (0, 1)])
def test_every_row_filter(tmp_path, color, bpp):
    """A file whose rows cycle through filters 0-4 (written here by the
    PNG specification's definitions), decoded as PIL decodes it."""
    H, W = 15, 19
    rng = np.random.default_rng(color)
    pix = rng.integers(0, 256, (H, W * bpp)).astype(np.int64)
    pix[::2] = np.cumsum(pix[::2] % 7, axis=1) % 256       # some smooth rows too
    raw, prev = b"", np.zeros(W * bpp, np.int64)
    for r in range(H):
        raw += _filter_row(r % 5, pix[r], prev, bpp)
        prev = pix[r]
    blob = (pimage.PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(blob)
    got = pimage.read_png(path)
    np.testing.assert_array_equal(got.pixels.reshape(H, -1), pix.astype(np.uint8))
    ref = Image.open(path)
    for conv in ("RGB", "L"):
        np.testing.assert_array_equal(got.convert(conv), np.asarray(ref.convert(conv)))


def test_text_chunks_as_pil_reads_them(tmp_path):
    """tEXt, zTXt and iTXt (plain and compressed) as in PIL's ``Image.text``."""
    meta = PngImagePlugin.PngInfo()
    meta.add_text("plain", "a b c")
    meta.add_text("zipped", "x" * 300, zip=True)
    meta.add_itxt("intl", "snow ☃", lang="en", tkey="Schnee")
    meta.add_itxt("intl_zip", "é" * 200, zip=True)
    path = str(tmp_path / "text.png")
    Image.fromarray(_texture(8, 8, 4)).save(path, pnginfo=meta)
    assert pimage.image_text(path) == Image.open(path).text


def test_png_never_goes_through_pil(tmp_path, monkeypatch):
    """With PIL hidden, PNG still reads: the path the card takes."""
    path = str(tmp_path / "a.png")
    img = _texture(9, 11, 5)
    Image.fromarray(img).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    np.testing.assert_array_equal(pimage.load_image(path), img)


def test_other_formats_through_pil_or_a_clear_error(tmp_path, monkeypatch):
    path = str(tmp_path / "a.jpg")
    Image.fromarray(_texture(16, 16, 6)).save(path, quality=90)
    np.testing.assert_array_equal(pimage.load_image(path), np.asarray(Image.open(path)
                                                                      .convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="a JPEG image.*convert it to PNG"):
        pimage.load_image(path)
    with pytest.raises(ValueError, match="JPEG"):
        pimage.image_text(path)


def test_unsupported_png_is_named(tmp_path):
    path = str(tmp_path / "deep.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    with pytest.raises(ValueError, match="bit depth 16"):
        pimage.read_png(path)
