"""The error the image readers raise for a file they do not read.

``UnsupportedImageError`` names a format, or a variant of one, that Pillow
reads and this package does not (ICO, PSD, arithmetic-coded, lossless,
hierarchical and 12-bit JPEG, ...).  It is a ``ValueError``, as every other
reader error is; the dataset sources tell the two apart: bytes of a format
the package reads that fail to decode are skipped and counted, as the JAX
package skips what Pillow cannot open, while an ``UnsupportedImageError``
stops the run, since the JAX package would have read that image.
"""


class UnsupportedImageError(ValueError):
    pass
