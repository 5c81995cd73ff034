"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C launch function and compiles on
its own into ``build/kernels/<name>-<hash>.so`` at the repository root. The
hash covers the source, every header in ``csrc/`` and the compiler flags,
so an edited source rebuilds at its next use. Nothing is compiled while a
module is imported: the first launch (or :func:`build`) compiles.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("cascade_exact", "cascade_matmul", "cascade_matmul_grouped", "decode_attention",
           "fake_quant", "flash_attention", "norm", "ssd_scan")

_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc runs started and libraries loaded in this process (the retrace
#: check reads them: serving a trace again must add neither)
COUNTS = {"compiles": 0, "loads": 0}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns name -> library path. The
    compiler's register/shared-memory report lands beside each library as
    ``<name>-<hash>.log``."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
        COUNTS["compiles"] += 1
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[n])       # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        COUNTS["loads"] += 1
        _loaded[name] = lib
    return lib
