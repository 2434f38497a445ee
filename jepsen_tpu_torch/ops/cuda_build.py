"""Builds the package's CUDA sources at first use.

Each `csrc/<name>.cu` compiles with its own `nvcc` for sm_90a into a
shared library with a plain C interface, `_build/lib<name>_<hash>.so`
(git-ignored, keyed by a hash of the source), which the kernel's module
loads with ctypes.  `build` starts one `nvcc` per source that is not
built yet, all at once, and waits for every one; a failed compile
raises with nvcc's output.  `-Xptxas -v`'s report is kept beside each
library (`<lib stem>.ptxas.txt`)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin); the "
                       "CUDA kernels are built from csrc/ at first use")


def lib_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu lives once built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD / f"lib{name}_{digest}.so"


def ptxas_report(lib: Path) -> Path:
    return lib.parent / (lib.stem + ".ptxas.txt")


def build(*names: str) -> dict:
    """{name: library path} for csrc/<name>.cu of each name, compiling
    the missing ones in parallel.  Raises RuntimeError on a failed
    compile."""
    libs = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n"
                          f"{out}\n{err}")
            continue
        ptxas_report(todo[n]).write_text(err)
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use;
    `declare(lib)` sets its functions' argtypes and restypes once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            declare(lib)
            _libs[name] = lib
    return lib
