"""Pillow 12.1's ``convert("RGB")`` of an image in mode LAB, which it does
through LittleCMS 2 (``ImageCms``): a transform from ``createProfile("LAB")``
(the Lab identity profile, D50) to ``createProfile("sRGB")`` at perceptual
intent, 8-bit in and out.

LittleCMS drops the Lab profile's identity stages, and samples what is
left (Lab V4 to XYZ against D50, the inverse of sRGB's colorant matrix
adapted to D50 by Bradford, the inverse of sRGB's parametric curve) at
33 x 33 x 33 nodes of 16-bit input, in C floats where it stores floats and
doubles where it computes in doubles, each node's output saturated to 16
bits; a pixel's 8-bit L, a, b (a and b offset by 128, as Pillow holds
them) become 16 bits (x 257) and are interpolated in the node table's
tetrahedra in 16.16 fixed point, and the 16-bit result rounds to 8 bits.
It equals Pillow's conversion on every one of the 2**24 inputs.
"""

from __future__ import annotations

import numpy as np

_N = 33  # nodes a side
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # XYZ's 1.15 encoding: the stages' scale
_TABLE = None


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5 floored (at 2**-16 precision, as its
    magic-number floor), clipped to 0..65535."""
    d = np.asarray(d, np.float64) + 0.5
    floor = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.int64)


def _xyz_of_xy(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1 - x - y) / y])


def _srgb_to_xyz_d50() -> np.ndarray:
    """_cmsBuildRGB2XYZtransferMatrix of sRGB's primaries and D65, adapted
    to D50 by Bradford (cmsCreate_sRGBProfile's colorants)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = np.array([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]])
    m = prim * (np.linalg.inv(prim) @ np.array([xn / yn, 1.0, (1.0 - xn - yn) / yn]))
    bradford = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                         [0.0389, -0.0685, 1.0296]])
    cone = np.diag((bradford @ np.array(_D50)) / (bradford @ _xyz_of_xy(xn, yn)))
    return np.linalg.inv(bradford) @ (cone @ bradford) @ m


def _pipeline(w: np.ndarray) -> np.ndarray:
    """The transform's float pipeline on 16-bit Lab [..., 3] -> 16-bit RGB."""
    f32 = np.float32
    x = (w / 65535.0).astype(f32)
    lab = (x[..., 0].astype(np.float64) * 100.0, x[..., 1].astype(np.float64) * 255.0 - 128.0,
           x[..., 2].astype(np.float64) * 255.0 - 128.0)
    fy = (lab[0] + 16.0) / 116.0

    def f_1(t):  # cmsLab2XYZ's inverse of f
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    xyz = [(f_1(t) * white / _MAX_XYZ).astype(f32)
           for t, white in zip((fy + 0.002 * lab[1], fy, fy - 0.005 * lab[2]), _D50)]
    inv = np.linalg.inv(_srgb_to_xyz_d50()) * _MAX_XYZ
    gamma, a, b, c, d = 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045
    out = []
    for i in range(3):
        lin = sum(xyz[j].astype(np.float64) * inv[i, j] for j in range(3)).astype(f32)
        r = lin.astype(np.float64)
        with np.errstate(invalid="ignore"):  # parametric curve -4: sRGB's inverse
            v = np.where(r >= (a * d + b) ** gamma,
                         (np.power(np.maximum(r, 0), 1.0 / gamma) - b) / a, r / c)
        out.append(_saturate_word(v.astype(f32).astype(np.float64) * 65535.0))
    return np.stack(out, -1)


def _table() -> np.ndarray:
    """The 33 x 33 x 33 x 3 node table, made at first use."""
    global _TABLE
    if _TABLE is None:
        nodes = _saturate_word(np.arange(_N) * 65535.0 / (_N - 1))
        _TABLE = _pipeline(np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"), -1))
    return _TABLE


# TetrahedralInterp16's six tetrahedra: the axes in the order the path from
# the lower corner takes them (largest fraction first, ties as it breaks
# them), and the test of the fractions that picks each
_TETRA = (((0, 1, 2), lambda rx, ry, rz: (rx >= ry) & (ry >= rz)),
          ((2, 0, 1), lambda rx, ry, rz: (rx >= ry) & (ry < rz) & (rz >= rx)),
          ((0, 2, 1), lambda rx, ry, rz: (rx >= ry) & (ry < rz) & (rz < rx)),
          ((1, 0, 2), lambda rx, ry, rz: (rx < ry) & (rx >= rz)),
          ((1, 2, 0), lambda rx, ry, rz: (rx < ry) & (rx < rz) & (ry >= rz)),
          ((2, 1, 0), lambda rx, ry, rz: (rx < ry) & (rx < rz) & (ry < rz)))


def _interp(w: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16 of 16-bit inputs [n, 3] -> [n, 3] 16-bit: each
    axis's step along the tetrahedron's path times its 16-bit fraction,
    summed with its rounding (``Rest + 0x8001``)."""
    table = _table()
    fixed = [w[:, k] * (_N - 1) for k in range(3)]
    fixed = [f + (f + 0x7FFF) // 0xFFFF for f in fixed]  # _cmsToFixedDomain
    lo = [f >> 16 for f in fixed]
    rest = [f & 0xFFFF for f in fixed]
    step = [np.where(w[:, k] == 0xFFFF, 0, 1) for k in range(3)]  # the last node has no next
    c0 = table[lo[0], lo[1], lo[2]]
    out = np.empty_like(c0)
    for order, case in _TETRA:
        sel = case(*rest)
        if not sel.any():
            continue
        at = [v[sel] for v in lo]
        prev = c0[sel]
        total = np.full(prev.shape, 0x8001, np.int64)
        for axis in order:
            at[axis] = at[axis] + step[axis][sel]
            corner = table[at[0], at[1], at[2]]
            total += (corner - prev) * rest[axis][sel][:, None]
            prev = corner
        out[sel] = (c0[sel] + ((total + (total >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """Pillow's LAB pixels [..., 3] uint8 (a and b offset by 128) -> RGB
    [..., 3] uint8, a band of rows at a time."""
    flat = lab.reshape(-1, 3)
    out = np.empty(flat.shape, np.uint8)
    for k in range(0, len(flat), 1 << 16):
        w = flat[k:k + (1 << 16)].astype(np.int64) * 257
        out[k:k + (1 << 16)] = (_interp(w) * 65281 + 8388608) >> 24
    return out.reshape(lab.shape)
