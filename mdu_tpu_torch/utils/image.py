"""Image <-> tensor conversions and the latent RGB preview (the port's copy
of ``mdu_tpu/utils/image.py``), and PNG files read and written without PIL
(``save_png``, ``read_png``, ``load_image``, ``image_text``)."""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import numpy as np
import torch

# SD-1.x latent -> RGB linear approximation (A1111 cheap_approximation coefs)
_LATENT_RGB = np.array([
    [0.298, 0.207, 0.208],
    [0.187, 0.286, 0.173],
    [-0.158, 0.189, 0.264],
    [-0.184, -0.271, -0.473],
], dtype=np.float32)


def image_to_tensor(img_u8: np.ndarray) -> torch.Tensor:
    """uint8 [H, W, 3] (or [H, W, 4], alpha flattened on white, or [H, W]
    grey) -> fp32 [1, 3, H, W] in [-1, 1] on the CPU."""
    img = np.asarray(img_u8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        alpha = img[..., 3:4].astype(np.float32) / 255.0
        rgb = img[..., :3].astype(np.float32)
        img = rgb * alpha + 255.0 * (1 - alpha)
    x = img.astype(np.float32) / 255.0 * 2.0 - 1.0
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))


def tensor_to_image(x) -> np.ndarray:
    """[B, 3, H, W] in [-1, 1] (tensor or array) -> uint8 [B, H, W, 3]."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    arr = np.asarray(x, dtype=np.float32)
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return (arr.transpose(0, 2, 3, 1) * 255.0 + 0.5).astype(np.uint8)


def cheap_latent_preview(z: torch.Tensor) -> torch.Tensor:
    """[B, 4, h, w] latents -> [B, 3, h, w] rough RGB in [-1, 1] (no VAE)."""
    coefs = torch.as_tensor(_LATENT_RGB, device=z.device)
    return torch.einsum("bchw,cd->bdhw", z.float(), coefs)


def grayscale_u8(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [H, W] luma (PIL 'L' convention)."""
    img = np.asarray(img_u8)
    if img.ndim == 2:
        return img
    f = img[..., :3].astype(np.float32)
    return (f @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)


def hint_to_tensor(img_u8: np.ndarray) -> torch.Tensor:
    """uint8 [H, W, 3] (or [H, W] grey) -> fp32 [1, 3, H, W] in [0, 1] on the
    CPU: the ControlNet hint range."""
    img = np.asarray(img_u8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    x = img[..., :3].astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))


# ---------------------------------------------------------------- PNG files
#
# The card's machine has no PIL, so the port reads and writes PNG itself, on
# ``zlib`` and ``struct`` (as ``models/safetensors.py`` reads its format).
# PNG never goes through PIL, on any machine, so the path the tests hold is
# the card's; other formats go through PIL where it can be imported.

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # PNG color type -> samples a pixel
_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img_u8: np.ndarray, text: Optional[Dict[str, str]] = None) -> None:
    """Write uint8 [H, W, 3] (or [H, W] grey) as an 8-bit non-interlaced PNG,
    each row unfiltered, with one text chunk per ``text`` entry (``tEXt``, or
    ``iTXt`` where the value is not Latin-1, as PIL's ``PngInfo.add_text``
    chooses)."""
    img = np.ascontiguousarray(np.asarray(img_u8, dtype=np.uint8))
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"save_png: needs [H, W, 3] or [H, W] uint8, got {img.shape}")
    H, W = img.shape[:2]
    rows = img.reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()
    out = [PNG_MAGIC, _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))]
    for key, value in (text or {}).items():
        try:
            out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                              + value.encode("latin-1")))
        except UnicodeEncodeError:
            out.append(_chunk(b"iTXt", key.encode("latin-1") + b"\0\0\0\0\0"
                              + value.encode("utf-8")))
    out.append(_chunk(b"IDAT", zlib.compress(raw, 6)))
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _unfilter(data: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters of 8-bit scanlines ``data`` [H, 1 + W *
    bpp] (each row's first byte its filter type) -> uint8 [H, W, bpp].

    A pixel's Sub, Average and Paeth predictors read its left neighbour in
    the same row, Up, Average and Paeth the row above, so no row nor column
    can be decoded at once. Pixels on one anti-diagonal (row + column fixed)
    depend only on the diagonal before: the loop runs H + W - 1 diagonals,
    each vectorised over its pixels and the bytes of a pixel, every row's
    own filter chosen per pixel."""
    ftype = data[:, 0].astype(np.int64)
    if ftype.size and ftype.max() > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    filt = data[:, 1:].reshape(H, W, bpp).astype(np.int64)
    if not (ftype != 0).any():
        return filt.astype(np.uint8)
    R = np.zeros((H + 1, W + 1, bpp), np.int64)     # a zero row above, a zero column left
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - r
        a, b, c = R[r + 1, x], R[r, x + 1], R[r, x]
        t = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        R[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return R[1:, 1:].astype(np.uint8)


class PNGImage:
    """A decoded 8-bit PNG: ``pixels`` uint8 [H, W, C] in the file's mode
    (``L``, ``LA``, ``RGB``, ``RGBA``, or ``P``: palette indices [H, W, 1]
    with ``palette`` [N, 3]), and ``text``, the ``tEXt`` / ``zTXt`` /
    ``iTXt`` entries, as PIL's ``Image.text`` has them."""

    def __init__(self, pixels: np.ndarray, mode: str, palette: Optional[np.ndarray],
                 text: Dict[str, str]):
        self.pixels, self.mode, self.palette, self.text = pixels, mode, palette, text

    @property
    def size(self):
        return self.pixels.shape[1], self.pixels.shape[0]

    def _rgb(self) -> np.ndarray:
        p = self.pixels
        if self.mode == "P":
            return self.palette[p[..., 0]]
        if self.mode in ("L", "LA"):
            return np.repeat(p[..., :1], 3, axis=2)
        return p[..., :3]

    def convert(self, mode: str) -> np.ndarray:
        """uint8 pixels in ``mode`` as PIL converts them: ``RGB`` drops alpha
        and looks palettes up; ``L`` is ``L`` itself, else PIL's integer luma
        (R 19595 + G 38470 + B 7471 + 2^15) >> 16 of the RGB pixels."""
        if mode == "RGB":
            return np.ascontiguousarray(self._rgb())
        if mode == "L":
            if self.mode in ("L", "LA"):
                return np.ascontiguousarray(self.pixels[..., 0])
            rgb = self._rgb().astype(np.uint32)
            luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000
            return (luma >> 16).astype(np.uint8)
        raise ValueError(f"PNGImage.convert: mode {mode!r} (RGB or L)")


def read_png(path: str) -> PNGImage:
    """Decode an 8-bit, non-interlaced PNG of color type 0, 2, 3, 4 or 6."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, text, palette, hdr = 8, [], {}, None, None
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"tEXt":
            key, _, value = data.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"zTXt":
            key, _, rest = data.partition(b"\0")
            text[key.decode("latin-1")] = zlib.decompress(rest[1:]).decode("latin-1")
        elif kind == b"iTXt":
            key, _, rest = data.partition(b"\0")
            compressed, rest = rest[0], rest[2:]
            _, _, rest = rest.partition(b"\0")                 # language tag
            _, _, value = rest.partition(b"\0")                # translated keyword
            text[key.decode("latin-1")] = (zlib.decompress(value) if compressed
                                           else value).decode("utf-8")
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG of bit depth {depth}, color type {color}, interlace "
                         f"{interlace}; the reader takes 8-bit non-interlaced color types "
                         "0, 2, 3, 4 and 6")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines, expected {H * (1 + W * bpp)}")
    pixels = _unfilter(raw.reshape(H, 1 + W * bpp), H, W, bpp)
    return PNGImage(pixels, _MODES[color], palette, text)


def _format_of(head: bytes) -> str:
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[:4] in (b"GIF8",):
        return "GIF"
    if head[:2] == b"BM":
        return "BMP"
    if head[:4] in (b"II*\0", b"MM\0*"):
        return "TIFF"
    return "non-PNG"


def _pil_or_raise(path: str):
    with open(path, "rb") as f:
        head = f.read(16)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: a {_format_of(head)} image, and PIL is not installed here, "
                         "so only PNG can be read: convert it to PNG") from None
    return Image.open(path)


def load_image(path: str, mode: str = "RGB") -> np.ndarray:
    """uint8 pixels of an image file in ``mode`` (``RGB`` [H, W, 3] or ``L``
    [H, W]): PNG through ``read_png``, any other format through PIL."""
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_MAGIC
    if is_png:
        return read_png(path).convert(mode)
    return np.asarray(_pil_or_raise(path).convert(mode))


def image_text(path: str) -> Dict[str, str]:
    """The text entries of an image file (a PNG's text chunks, as PIL's
    ``Image.text``)."""
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_MAGIC
    if is_png:
        return read_png(path).text
    return dict(getattr(_pil_or_raise(path), "text", {}) or {})
