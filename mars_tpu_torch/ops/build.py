"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each library is compiled at first use with ``nvcc`` into a shared library
with a plain C interface (loaded through ``ctypes``), for ``sm_90a``: from
``csrc/<name>.cu``, or from the translation units ``UNITS`` names for it,
compiled apart and linked.  The library name carries a hash of its sources,
their flags and the shared headers (``*.cuh``), so an edited source or
header is rebuilt.  Builds land in ``mars_tpu_torch/_build/`` (listed in
``.gitignore``); ``build_all`` starts one ``nvcc`` per translation unit, all
at once.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Mapping, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("attention_tap", "attention_notap", "sam_grid_attention", "sam_windowed_attention",
           "auction", "int4_matmul")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")
# libraries built from several translation units: (source, extra flags) each,
# compiled in parallel (-c) and linked.  The 4-bit prefill GEMM's kernels take
# longer to compile than the rest of its library, so each format is a unit.
UNITS = {"int4_matmul": (("int4_matmul", ()), ("int4_prefill", ("-DPF_FMT=0",)),
                         ("int4_prefill", ("-DPF_FMT=1",)))}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def units(name: str) -> Sequence:
    """The (source, extra flags) translation units of library ``name``."""
    return UNITS.get(name, ((name, ()),))


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source, flags in units(name):
        h.update(" ".join(flags).encode())
        with open(os.path.join(CSRC_DIR, source + ".cu"), "rb") as f:
            h.update(f.read())
    for fname in headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def start_units(sources: Sequence, out: str) -> list:
    """Start compiling the translation units ``sources`` ((path, extra
    flags) each) of the shared library ``out``: one ``nvcc`` for a single
    unit, else one ``nvcc -c`` each; ``finish_units`` links them."""
    if len(sources) == 1:
        (src, flags), = sources
        cmd = [nvcc_path(), *FLAGS, *flags, f"-I{CSRC_DIR}", "-o", out, src]
        return [(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), None)]
    compile_flags = [f for f in FLAGS if f != "-shared"]
    jobs = []
    for i, (src, flags) in enumerate(sources):
        obj = f"{out}.{i}.o"
        cmd = [nvcc_path(), *compile_flags, *flags, f"-I{CSRC_DIR}", "-c", "-o", obj, src]
        jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), obj))
    return jobs


def finish_units(jobs: list, out: str) -> tuple:
    """Wait for ``start_units``' compiles and link their objects into
    ``out``: (exit code, the compilers' and linker's output)."""
    logs, rc = [], 0
    for proc, _ in jobs:
        log, _ = proc.communicate()
        logs.append(log)
        rc = rc or proc.returncode
    objs = [obj for _, obj in jobs if obj]
    if objs and rc == 0:
        link = subprocess.run([nvcc_path(), *FLAGS[:2], "-shared", "-o", out, *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        logs.append(link.stdout)
        rc = link.returncode
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    return rc, b"".join(logs)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per translation unit, all
    in parallel.  Returns {name: seconds} for what was built; raises on a
    failed build with the compiler's output.  The ptxas report is kept
    beside each library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        sources = [(os.path.join(CSRC_DIR, src + ".cu"), flags) for src, flags in units(name)]
        jobs[name] = (start_units(sources, tmp), tmp, path)
    took, failed = {}, []
    for name, (units_jobs, tmp, path) in jobs.items():
        rc, log = finish_units(units_jobs, tmp)
        took[name] = time.perf_counter() - t0
        with open(path[:-3] + ".log", "wb") as f:
            f.write(log)
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str, argtypes: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.  At
    the first load each function named in ``argtypes`` gets those argument
    types and an ``int`` (cudaError_t) result; later calls reuse them."""
    if name not in _LOADED:
        build_all([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = list(types)
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return _LOADED[name]
