"""The errors the image readers raise for a file they do not read.

Every file ends in one of three ways, as in the JAX package, which opens
every image through Pillow's ``Image.open(...).convert("RGB")``:

(a) it is read, byte-equal to Pillow;
(b) Pillow reads it and this package does not: ``UnsupportedImageError``
    names Pillow's format (JPEG 2000, AVIF, ICNS, ...), and the dataset
    sources stop on it, since the JAX package would have trained on it;
(c) Pillow cannot open or load it (corrupt or truncated bytes, bytes that
    are no image, an EPS without Ghostscript, a WMF off Windows): any other
    ``ValueError``, which the dataset sources skip and count, as the JAX
    package skips the file.

``NotThisFormat`` is raised where a plugin's header check refuses the
file while ``Image.open`` opens it (a ``SyntaxError``, an ``IndexError``
and the like in Pillow): ``utils/image_formats.py`` then goes on to the
next format, as ``Image.open`` goes on to its next plugin.  Both are
``ValueError``s.  :func:`check_pixels` is Pillow's decompression-bomb
check, which ``Image.open`` makes for every plugin once its header is
read: every reader, and every header check of a format the port names,
calls it right after the header's own checks, before it allocates the
image, so that a few bytes that claim a huge image end in (c) and not in a
``MemoryError``.
"""


class UnsupportedImageError(ValueError):
    pass


class NotThisFormat(ValueError):
    pass


# Pillow's Image.open raises DecompressionBombError above twice
# Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * 89_478_485


def check_pixels(w: int, h: int) -> None:
    """Raise as Pillow's decompression-bomb check does for a w x h image."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"an image of {w} x {h} pixels: Pillow refuses it as a "
                         "decompression bomb")
