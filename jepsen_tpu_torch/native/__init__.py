"""The native history scanner, built at first use.

`histscan.c` (with `scancommon.h`) is a CPython extension that the host
C compiler builds on the machine that runs it: `cc -O2 -shared -fPIC`
with Python's include directory, into
`jepsen_tpu_torch/_build/_histscan_<hash>.so` (git-ignored), keyed by a
hash of the source, the header and the flags, as `ops/cuda_build.py`
keys the CUDA libraries.  A failed build or load raises with the
compiler's output: there is no other scanner to fall back on."""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "histscan.c"
HEADER = HERE / "scancommon.h"
BUILD = HERE.parent / "_build"
FLAGS = ("-O2", "-shared", "-fPIC")
_lock = threading.Lock()
_mod = None


def compiler() -> str:
    """The host C compiler, cc on the PATH."""
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("no host C compiler (cc) to build the native "
                           "history scanner")
    return cc


def lib_path() -> Path:
    """Where the extension of the current source, header and flags
    lives once built."""
    h = hashlib.sha256()
    for part in (SOURCE.read_bytes(), HEADER.read_bytes(),
                 " ".join(FLAGS).encode(),
                 (sysconfig.get_config_var("EXT_SUFFIX") or "").encode()):
        h.update(part)
        h.update(b"\0")
    return BUILD / f"_histscan_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The extension's path, compiling it first when it is missing.
    Raises RuntimeError with the compiler's output on a failed build."""
    lib = lib_path()
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *FLAGS, f"-I{sysconfig.get_paths()['include']}",
           f"-I{HEADER.parent}", str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


#: The extension's module name: qualified, so that it is not the bare
#: `_histscan` of another package's scanner.  A single-phase extension
#: loaded a second time from the same file is rebuilt into whatever
#: module sys.modules holds under its name, so under a shared bare name
#: the other package's reload would overwrite this module's functions.
#: The init function is still the last component's, PyInit__histscan.
MODULE = "jepsen_tpu_torch.native._histscan"


def histscan():
    """The `_histscan` extension module, built and loaded at first use."""
    global _mod
    with _lock:
        if _mod is None:
            path = build()
            spec = importlib.util.spec_from_file_location(MODULE, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mod = mod
    return _mod
