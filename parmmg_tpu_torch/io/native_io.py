"""ctypes bridge to the native Medit tokenizer (`native/medit_tok.cpp`
of this package).

Counterpart of `parmmg_tpu/io/native_io.py`: only the tokenization loop
is native, parsing and assembly stay in numpy. The library is built at
first use with `g++` into `_build/` (`native.tokenizer_library`); where
it cannot be built or loaded, `available()` is False and `io/medit.py`
takes the Python tokenizer.
"""

from __future__ import annotations

import ctypes
from typing import List

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from .. import native

    try:
        lib = ctypes.CDLL(native.tokenizer_library())
    except (OSError, native.BuildError):
        return None
    lib.medit_tokenize.restype = ctypes.c_void_p
    lib.medit_tokenize.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_long)]
    lib.medit_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def tokenize(path: str) -> List[str]:
    """The whitespace-separated tokens of the file at `path`, `#`
    comments stripped to the end of their line."""
    lib = _load()
    n = ctypes.c_long(0)
    buf = lib.medit_tokenize(path.encode(), ctypes.byref(n))
    if not buf:
        raise IOError(f"native tokenizer failed on {path}")
    try:
        raw = ctypes.string_at(buf, n.value)
    finally:
        lib.medit_free(buf)
    return raw.decode().split("\x00") if n.value else []
