"""Build the port's native sources into shared libraries with a plain C
interface, loaded with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a``, each ``csrc/<name>.c`` (host code) with the
toolchain's ``cc -O2 -fPIC -shared``, each ``csrc/<name>.cpp`` (host C++)
with ``c++ -O2 -std=c++17 -fPIC -shared``, into
``_build/lib<name>-<hash>.so``, at first use. The hash covers the source
and the flags, so an edited source rebuilds and an unchanged one is
reused. Sources build in parallel, one
compiler process each. Nothing here runs at import time; a machine without
the compiler a source needs raises (nvcc for the kernels, cc for the host
packer, c++ for the native conflict engine), and nothing falls back to a
Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O2", "-fPIC", "-shared")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
#: host C compilers tried in order
C_COMPILERS = ("cc", "gcc", "clang")
#: host C++ compilers tried in order
CXX_COMPILERS = ("c++", "g++", "clang++")

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """{name: path} of every native source the package ships: CUDA (.cu),
    host C (.c) and host C++ (.cpp)."""
    return {p.stem: p for p in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.c"),
                                       *CSRC_DIR.glob("*.cpp")])}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME, else where
    torch.utils.cpp_extension finds the CUDA toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of foundationdb_tpu_torch are built "
        "from csrc/ at first use and need the CUDA toolkit (set CUDA_HOME)")


def c_compiler() -> str:
    """Path of the host C compiler: the first of C_COMPILERS on PATH."""
    for cc in C_COMPILERS:
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError(
        f"no C compiler found (tried {', '.join(C_COMPILERS)} on PATH): the host "
        "packer of foundationdb_tpu_torch (csrc/fastpack.c) is built at first use "
        "and needs one")


def cxx_compiler() -> str:
    """Path of the host C++ compiler: the first of CXX_COMPILERS on PATH."""
    for cxx in CXX_COMPILERS:
        found = shutil.which(cxx)
        if found:
            return found
    raise RuntimeError(
        f"no C++ compiler found (tried {', '.join(CXX_COMPILERS)} on PATH): the native "
        "conflict engine of foundationdb_tpu_torch (csrc/conflict_engine.cpp) is built at "
        "first use and needs one")


def _flags(src: Path):
    return {".cu": NVCC_FLAGS, ".cpp": CXX_FLAGS}.get(src.suffix, CC_FLAGS)


def _command(src: Path, out: Path):
    compiler = {".cu": nvcc, ".cpp": cxx_compiler}.get(src.suffix, c_compiler)()
    return [compiler, *_flags(src), "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named source (default: all) that has no library for its
    current hash, all nvcc processes started together. Returns {name:
    seconds spent building} (0.0 for a reused library). The ptxas report of
    each CUDA build lands in ``_build/<name>.log``."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    todo = {}
    took = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(sources()[name], tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        todo[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in todo.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: {Path(proc.args[0]).name} exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)       # atomic: a concurrent build sees old or new
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text(errors="replace") if path.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.{cu,c,cpp}, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
