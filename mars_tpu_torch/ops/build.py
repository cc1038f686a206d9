"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface (loaded through ``ctypes``), for ``sm_90a``.  The
library name carries a hash of the source and flags, so an edited source is
rebuilt.  Builds land in ``mars_tpu_torch/_build/`` (listed in
``.gitignore``); ``build_all`` starts one ``nvcc`` per source, all at once.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("attention_tap",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source in parallel.
    Returns {name: seconds} for what was built; raises on a failed build
    with the compiler's output.  The ptxas report is kept beside each
    library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                      tmp, path)
    took, failed = {}, []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        with open(path[:-3] + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        build_all([name])
        _LOADED[name] = ctypes.CDLL(library_path(name))
    return _LOADED[name]
