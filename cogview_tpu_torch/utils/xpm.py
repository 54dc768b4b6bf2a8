"""X11 pixmap (XPM) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``XpmImagePlugin``: after ``/* XPM */`` the first line
with ``"w h colours chars`` gives the layout; each of the next lines maps
a key of ``chars`` characters to its first ``c`` colour, which Pillow
reads as ``#rrggbb`` (``None``, transparency, maps no colour); then each
line's text between its first and last quote, cut into keys, is a row of
pixels (a ``/* pixels */`` line is skipped once).  A key with no colour
fails, and another colour name fails, as in Pillow: ``ValueError``; so
does a header Pillow cannot parse.
"""

from __future__ import annotations

import re

import numpy as np

from .image_errors import NotThisFormat, check_pixels

_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def decode_xpm(data: bytes) -> np.ndarray:
    """The bytes of an XPM file -> [h, w, 3] uint8."""
    lines = data[9:].splitlines(keepends=True)
    at = 0
    while True:
        if at >= len(lines):
            raise NotThisFormat("broken XPM file")
        m = _HEAD.match(lines[at])
        at += 1
        if m:
            break
    try:
        w, h, ncolors, bpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError("XPM: a header Pillow cannot parse") from None
    palette = {}
    for _ in range(ncolors):
        line = lines[at].rstrip() if at < len(lines) else b""
        at += 1
        key, words = line[1:bpp + 1], line[bpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                rgb = words[i + 1] if i + 1 < len(words) else b""
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    rgb = ncolors > 256  # Pillow's RGB mode; else P, whose palette is the colours in order
    keys = list(palette)
    colors = np.array(list(palette.values()) or [(0, 0, 0)], np.uint8)
    need = w * h
    px, header = [], False
    for line in lines[at:]:
        if len(px) >= need:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(text), bpp):
            k = text[i:i + bpp]
            if k not in palette:
                raise ValueError(f"XPM: pixel key {k!r} has no colour")
            px.append(keys.index(k) if not rgb else k)
    if len(px) < need:
        raise ValueError("corrupt XPM: not enough image data")
    if rgb:
        return np.array([palette[k] for k in px[:need]], np.uint8).reshape(h, w, 3)
    idx = np.asarray(px[:need], np.int64)
    if idx.max() >= 256:
        raise ValueError("XPM: a palette index past 255")
    table = np.zeros((256, 3), np.uint8)
    table[:len(colors)] = colors[:256]
    return table[idx].reshape(h, w, 3)
