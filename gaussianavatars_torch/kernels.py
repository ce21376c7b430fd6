"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled with
`nvcc` for Hopper (`sm_90a`) into a shared library under `_build/` (listed
in `.gitignore`) the first time it is used, and loaded with ctypes. A
library's file name carries a hash of its source, of every header under
the source directory that it includes, and of the `-D` defines it was
built with, so an edited kernel or header is rebuilt. A missing `nvcc` or a
failed build raises: there is no fallback.

`defines` (`["GA_COUNT=1"]`, the counting build) and `csrc` (another source
directory with the same file names, for instance an earlier commit's) build
measurement libraries beside the default one; the render and training
paths use neither.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# kernel name -> source file under csrc/
SOURCES = {"blend_fwd": "blend_fwd.cu", "blend_bwd": "blend_bwd.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def source_files(name: str, csrc=None) -> list[Path]:
    """The kernel's source and, after it, every file it includes with
    `#include "..."` (followed through the headers), in first-seen order."""
    csrc = Path(csrc) if csrc is not None else CSRC_DIR
    files = [csrc / SOURCES[name]]
    for path in files:                      # grows while it is walked
        for inc in _INCLUDE.findall(path.read_text()):
            header = (path.parent / inc).resolve()
            if header.exists() and header not in files:
                files.append(header)
    return files


def library_path(name: str, defines=(), csrc=None) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name, csrc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    for define in defines:
        digest.update(define.encode() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None, defines=(), csrc=None) -> dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one `nvcc` per source, all started together.

    Returns {name: compiler output} (the `-Xptxas -v` register and spill
    report) for every kernel named, read from the build log when the
    library was already there.
    """
    names = list(SOURCES) if names is None else list(names)
    src_dir = Path(csrc) if csrc is not None else CSRC_DIR
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, defines, csrc)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src_dir),
               *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(src_dir / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} {list(defines)}:\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = {}
    for name in names:
        log_path = library_path(name, defines, csrc).with_suffix(".log")
        logs[name] = log_path.read_text() if log_path.exists() else ""
    return logs


def load(name: str, defines=(), csrc=None) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    key = (name, tuple(defines), None if csrc is None else str(csrc))
    lib = _loaded.get(key)
    if lib is None:                 # the sources are hashed once a process
        build([name], defines, csrc)
        lib = ctypes.CDLL(str(library_path(name, defines, csrc)))
        _loaded[key] = lib
    return lib
