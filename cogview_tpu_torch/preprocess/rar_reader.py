"""RAR archive reading through the system libarchive, by ctypes (twin of
cogview_tpu/preprocess/rar_reader.py).

libarchive has RAR4 and RAR5 readers, compressed methods included, so no
unrar binding is needed:

- ``iter_rar_entries(source)`` yields ``(name, bytes)`` for every regular
  file, in one sequential pass in constant memory; ``source`` is a path or
  a binary file object, read through libarchive's client read callbacks
  (no random access, no whole-archive buffer).
- ``write_stored_rar4(path, files)`` writes a RAR 4.x archive of stored
  (method 0x30) entries from scratch, since libarchive cannot write RAR:
  the tests round-trip it through libarchive's reader, which checks both
  header CRC16s and each file's CRC32.  The format follows the public RAR
  4.x technote: a 7-byte signature, CRC16-prefixed block headers, a
  32-byte file header, the name and the raw data.

Without ``libarchive.so.13`` (or ``libarchive.so``) every reader raises the
``RuntimeError`` that :func:`has_rar_support` tests for.
"""

from __future__ import annotations

import ctypes
import io
import os
import struct
import zlib
from typing import BinaryIO, Iterator, Tuple, Union

_ARCHIVE_OK = 0
_ARCHIVE_EOF = 1
_ARCHIVE_WARN = -20
_AE_IFREG = 0o100000
_BLOCK = 1 << 16

_la = None


def _libarchive():
    global _la
    if _la is not None:
        return _la
    try:
        la = ctypes.CDLL("libarchive.so.13")
    except OSError:
        try:
            la = ctypes.CDLL("libarchive.so")
        except OSError as e:  # pragma: no cover - env-dependent
            raise RuntimeError(
                "RAR support needs the system libarchive (libarchive.so); "
                "not found — repack the archive as zip/tar instead"
            ) from e
    c = ctypes
    la.archive_read_new.restype = c.c_void_p
    for fn in (
        "archive_read_support_format_rar",
        "archive_read_support_format_rar5",
        "archive_read_support_filter_all",
        "archive_read_free",
        "archive_errno",
    ):
        getattr(la, fn).argtypes = [c.c_void_p]
    la.archive_error_string.argtypes = [c.c_void_p]
    la.archive_error_string.restype = c.c_char_p
    # callbacks passed as pre-cast c_void_p (keeps one argtype row)
    la.archive_read_open.argtypes = [c.c_void_p] * 5
    la.archive_read_open_filename.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    la.archive_read_next_header.argtypes = [c.c_void_p, c.POINTER(c.c_void_p)]
    la.archive_read_data.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    la.archive_read_data.restype = c.c_ssize_t
    la.archive_read_data_skip.argtypes = [c.c_void_p]
    la.archive_entry_pathname.argtypes = [c.c_void_p]
    la.archive_entry_pathname.restype = c.c_char_p
    la.archive_entry_size.argtypes = [c.c_void_p]
    la.archive_entry_size.restype = c.c_int64
    la.archive_entry_filetype.argtypes = [c.c_void_p]
    la.archive_entry_filetype.restype = c.c_uint
    _la = la
    return la


def has_rar_support() -> bool:
    """True when the system libarchive is loadable (tests gate on this)."""
    try:
        _libarchive()
        return True
    except RuntimeError:
        return False


def _err(la, a, what: str) -> RuntimeError:
    msg = la.archive_error_string(a)
    return RuntimeError(f"{what}: {(msg or b'?').decode(errors='replace')}")


_READ_CB = ctypes.CFUNCTYPE(
    ctypes.c_ssize_t, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_void_p),
)
_GENERIC_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


def iter_rar_entries(
    source: Union[str, os.PathLike, BinaryIO],
) -> Iterator[Tuple[str, bytes]]:
    """Yield (pathname, content) for each regular file, archive order.

    Sequential single pass (constant memory modulo one entry) whether
    ``source`` is a filename or a non-seekable binary stream.
    """
    la = _libarchive()
    a = la.archive_read_new()
    if not a:
        raise RuntimeError("archive_read_new failed")
    keepalive = []  # callbacks + chunk buffer must outlive the archive
    try:
        la.archive_read_support_format_rar(a)
        la.archive_read_support_format_rar5(a)
        la.archive_read_support_filter_all(a)
        if isinstance(source, (str, os.PathLike)):
            rc = la.archive_read_open_filename(
                a, os.fspath(source).encode(), _BLOCK)
        else:
            stream = source
            state = {"chunk": b""}

            def _read(_a, _client, buf_pp):
                try:
                    state["chunk"] = stream.read(_BLOCK) or b""
                except Exception:
                    return -1
                # hold a reference: libarchive reads the pointer after return
                state["buf"] = ctypes.create_string_buffer(
                    state["chunk"], len(state["chunk"]))
                buf_pp[0] = ctypes.cast(state["buf"], ctypes.c_void_p)
                return len(state["chunk"])

            read_cb = _READ_CB(_read)
            ok_cb = _GENERIC_CB(lambda _a, _c: _ARCHIVE_OK)
            keepalive += [read_cb, ok_cb, state]
            rc = la.archive_read_open(
                a, None,
                ctypes.cast(ok_cb, ctypes.c_void_p),
                ctypes.cast(read_cb, ctypes.c_void_p),
                ctypes.cast(ok_cb, ctypes.c_void_p))
        if rc != _ARCHIVE_OK:
            raise _err(la, a, "opening rar archive")

        entry = ctypes.c_void_p()
        while True:
            rc = la.archive_read_next_header(a, ctypes.byref(entry))
            if rc == _ARCHIVE_EOF:
                return
            if rc < _ARCHIVE_WARN:
                raise _err(la, a, "reading rar header")
            if la.archive_entry_filetype(entry) != _AE_IFREG:
                la.archive_read_data_skip(a)
                continue
            raw_name = la.archive_entry_pathname(entry) or b""
            name = raw_name.decode("utf-8", errors="replace")
            size = la.archive_entry_size(entry)
            out = io.BytesIO()
            buf = ctypes.create_string_buffer(_BLOCK)
            remaining = size if size > 0 else None
            while remaining is None or remaining > 0:
                n = la.archive_read_data(a, buf, _BLOCK)
                if n == 0:
                    break
                if n < 0:
                    raise _err(la, a, f"extracting {name!r}")
                out.write(buf.raw[:n])
                if remaining is not None:
                    remaining -= n
            yield name, out.getvalue()
    finally:
        la.archive_read_free(a)
        del keepalive


# ---------------------------------------------------------------------------
# RAR4 stored-mode writer (from scratch; for tests and corpus packing)

_RAR4_SIG = b"Rar!\x1a\x07\x00"
_HOST_UNIX = 3
_METHOD_STORE = 0x30
_LONG_BLOCK = 0x8000


def _crc16(header_after_crc: bytes) -> int:
    return zlib.crc32(header_after_crc) & 0xFFFF


def write_stored_rar4(path: str, files: "dict[str, bytes]") -> str:
    """Write a minimal RAR 4.x archive with stored (uncompressed) entries.

    Readable by any RAR4 decoder; the tests round-trip it through the
    real libarchive reader (which verifies both header CRC16s and the
    per-file data CRC32), so the writer cannot drift from the format.
    """
    out = io.BytesIO()
    out.write(_RAR4_SIG)
    # archive (MAIN) header: type 0x73, 13 bytes, reserved fields zero
    main = struct.pack("<BHH", 0x73, 0, 13) + b"\x00" * 6
    out.write(struct.pack("<H", _crc16(main)) + main)
    for name, data in files.items():
        nm = name.encode("utf-8")
        head_size = 32 + len(nm)
        body = struct.pack(
            "<IIBIIBBHI",
            len(data),            # PACK_SIZE (== UNP_SIZE when stored)
            len(data),            # UNP_SIZE
            _HOST_UNIX,           # HOST_OS
            zlib.crc32(data) & 0xFFFFFFFF,  # FILE_CRC
            0,                    # FTIME (DOS, epoch)
            20,                   # UNP_VER
            _METHOD_STORE,        # METHOD
            len(nm),              # NAME_SIZE
            0o100644,             # ATTR (HOST_UNIX: raw st_mode, regular file)
        )
        hdr = struct.pack("<BHH", 0x74, _LONG_BLOCK, head_size) + body + nm
        out.write(struct.pack("<H", _crc16(hdr)) + hdr + data)
    end = struct.pack("<BHH", 0x7B, 0, 7)
    out.write(struct.pack("<H", _crc16(end)) + end)
    with open(path, "wb") as f:
        f.write(out.getvalue())
    return path
