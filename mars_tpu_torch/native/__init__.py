"""Host code in C++: the exact solvers that are the oracles for the card's
Sinkhorn EMD and auction (port of ``mars_tpu/native``'s two solvers; its
RLE codec is ``core/rle.py`` here), and the image codecs of the data path
(``image_codecs.cpp``: JPEG decoding, PNG unfiltering, resampling,
polygon fill),
which ``data/image_io.py`` calls for every image a benchmark loader reads.

Each source is compiled with ``g++`` at first use into
``mars_tpu_torch/_build/`` (the name carries a hash of the source and the
flags) and bound through ctypes.  Host code only: it stands in for no
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Callable, Dict

import numpy as np

from mars_tpu_torch.ops.build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
# no fused multiply-add: the polygon fill repeats Pillow's float arithmetic
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(source: str = "exact_solvers") -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(os.path.join(_DIR, source + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{source}_{h.hexdigest()[:12]}.so")


def _build(source: str, path: str) -> None:
    # compile to a private name, then rename: a concurrent importer never
    # loads a half-written library, an interrupted build leaves none
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(_DIR, source + ".cpp")
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["g++", *FLAGS, src, "-o", tmp], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        path = library_path(source)
        if not os.path.exists(path):
            _build(source, path)
        lib = ctypes.CDLL(path)
        bind(lib)
        _LIBS[source] = lib
    return lib


def _bind_solvers(lib: ctypes.CDLL) -> None:
    lib.emd_uniform.restype = ctypes.c_double
    lib.emd_uniform.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int]
    lib.lsa_maximize.restype = None
    lib.lsa_maximize.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]


def _bind_codecs(lib: ctypes.CDLL) -> None:
    u8, i32, i64, err = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p)
    for name, args in (("jpeg_header", [u8, i64, u8, err, ctypes.c_int]),
                       ("jpeg_decode", [u8, i64, u8, i64, err, ctypes.c_int]),
                       ("png_unfilter", [u8, i64, i64, i32, u8, err, ctypes.c_int]),
                       ("resample_8bpc", [u8, i64, i64, i64, u8, u8, i32, i64, u8, err,
                                          ctypes.c_int]),
                       ("polygon_fill", [u8, i32, u8, i32, i32, i32, err, ctypes.c_int])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args


def get_lib() -> ctypes.CDLL:
    """The exact solvers' library."""
    return _load("exact_solvers", _bind_solvers)


def codecs_lib() -> ctypes.CDLL:
    """The image codecs' library."""
    return _load("image_codecs", _bind_codecs)


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on the card or not
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float64)


def emd_exact(cost) -> float:
    """Exact EMD between uniform marginals over a (t, c) cost matrix (the
    reference's ``ot.emd2(1/t, 1/c, M)``).  A matrix with no row or no
    column gives 0.0, the device path's convention for an empty footprint
    (``ot.emd2`` raises there)."""
    c = _host(cost)
    t, n = c.shape
    if t == 0 or n == 0:
        return 0.0
    r = float(get_lib().emd_uniform(c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), t, n))
    if r < 0.0:  # the solver's infeasibility sentinel; unreachable for finite costs
        raise RuntimeError("emd_uniform reported an infeasible flow")
    return r


def assignment_exact(score) -> np.ndarray:
    """Exact maximising assignment of a (t, n) score matrix, t <= n → the
    column of each row (int32), at ``scipy.optimize.linear_sum_assignment``'s
    optimum."""
    s = _host(score)
    t, n = s.shape
    if t > n:
        # a tall matrix would drive the augmenting loop out of bounds
        raise ValueError(f"assignment_exact needs t <= n, got {t}x{n}")
    out = np.empty(t, np.int32)
    get_lib().lsa_maximize(s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), t, n,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out
