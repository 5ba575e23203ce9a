"""Host-side native libraries of the port, built at first use.

- `medit_tok.cpp`: the Medit tokenizer behind `io/native_io.py`, built
  with `g++`;
- `parmmg_capi.c`: the C ABI, an embedded-CPython shim that C and
  Fortran programs link to drive `parmmg_tpu_torch.api` (the exported
  functions and signatures of the JAX package's `native/parmmg_capi.c`),
  built with `gcc` against this interpreter's headers.

Each is built into `_build/` under the kernels' lock
(`kernels.build.build_lock`), named by a hash of its source and command
line, written under a name of this process and renamed into place, as
the kernel library is.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig

from ..kernels.build import BUILD_DIR, build_lock

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))


class BuildError(RuntimeError):
    """A host library failed to build."""


def host_library(source: str, compiler: str, flags=(), libs=()) -> str:
    """Path of the shared library built from `NATIVE_DIR/source` by
    `compiler flags -shared -fPIC -o out source libs`, building it if
    it is not built."""
    path = os.path.join(NATIVE_DIR, source)
    cmd = [compiler, *flags, "-shared", "-fPIC"]
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(source.encode() + f.read())
    h.update(" ".join(cmd + list(libs)).encode())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    exe = shutil.which(compiler)
    if exe is None:
        raise BuildError(f"{compiler} not found: {source} is built at "
                         "first use")
    with build_lock():
        if os.path.exists(out):
            return out
        tmp = f"{out[:-3]}.tmp{os.getpid()}.so"
        try:
            r = subprocess.run([exe, *cmd[1:], "-o", tmp, path, *libs],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise BuildError(f"{compiler} failed on {source}:\n"
                                 f"{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def tokenizer_library() -> str:
    """The native Medit tokenizer, built if needed."""
    return host_library("medit_tok.cpp", "g++", ["-O2"])


def python_links() -> list:
    """What the shim links for this interpreter: its libpython where
    the interpreter is built shared (`Py_ENABLE_SHARED`), with an rpath
    to it; nothing otherwise, since a statically linked interpreter
    that loads the shim already holds those symbols and a second
    libpython would start a second interpreter."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return []
    libdir = sysconfig.get_config_var("LIBDIR")
    return [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{sysconfig.get_config_var('LDVERSION')}"]


def capi_library() -> str:
    """The C ABI shim for this interpreter, built if needed. A C or
    Fortran program links it (`-L<dir> -l:<name>`, or by its path) and
    needs the repository root on `PYTHONPATH` at run time."""
    inc = sysconfig.get_paths()["include"]
    return host_library("parmmg_capi.c", "gcc", ["-O2", f"-I{inc}"],
                        python_links())
