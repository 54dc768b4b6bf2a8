"""ctypes binding of the port's native SentencePiece runtime
(csrc/spm/spm.cc; twin of cogview_tpu/tokenization/sp_cpp.py).

``CppTextTokenizer`` has the encode / decode / piece-lookup surface of the
pure-Python ``TextTokenizer`` and gives the same ids.  The library is
built with ``g++`` at first use into the port's build directory
(``ops/_kernels.build_host``); a failed build or load raises.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List

from ..ops import _kernels

_LIB = None


def available() -> bool:
    """True where the library is built or can be built (a C++ compiler is
    on the PATH)."""
    return _kernels.host_available("spm")


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_kernels.build_host(["spm"])[0]))
        lib.spm_load.restype = ctypes.c_void_p
        lib.spm_load.argtypes = [ctypes.c_char_p]
        lib.spm_vocab_size.restype = ctypes.c_int
        lib.spm_vocab_size.argtypes = [ctypes.c_void_p]
        lib.spm_encode.restype = ctypes.c_int
        lib.spm_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.spm_decode.restype = ctypes.c_int
        lib.spm_decode.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                                   ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.spm_piece_to_id.restype = ctypes.c_int
        lib.spm_piece_to_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.spm_free.restype = None
        lib.spm_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class CppTextTokenizer:
    def __init__(self, model_path: str):
        self._lib = get_lib()
        self._m = self._lib.spm_load(str(model_path).encode())
        if not self._m:
            raise IOError(f"cannot load {model_path}")
        self.num_tokens = self._lib.spm_vocab_size(self._m)

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        cap = max(64, 2 * len(data) + 8)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.spm_encode(self._m, data, buf, cap)
        if n > cap:  # the count it needs: encode again at that size
            buf = (ctypes.c_int32 * n)()
            n = self._lib.spm_encode(self._m, data, buf, n)
        return list(buf[:n])

    def decode(self, ids: Iterable[int]) -> str:
        arr = [int(t) for t in ids]
        carr = (ctypes.c_int32 * len(arr))(*arr)
        cap = 16 * len(arr) + 16
        out = ctypes.create_string_buffer(cap)
        n = self._lib.spm_decode(self._m, carr, len(arr), out, cap)
        if n >= cap:
            out = ctypes.create_string_buffer(n + 1)
            self._lib.spm_decode(self._m, carr, len(arr), out, n + 1)
        return out.value.decode("utf-8", errors="replace")

    def convert_token_to_id(self, piece: str) -> int:
        i = self._lib.spm_piece_to_id(self._m, piece.encode())
        return i if i >= 0 else 0

    def tokenize(self, text: str) -> List[str]:
        raise NotImplementedError("use the Python tokenizer for piece strings")

    def __len__(self) -> int:
        return self.num_tokens

    def __del__(self):
        m = getattr(self, "_m", None)
        if m:
            self._lib.spm_free(m)
            self._m = None
