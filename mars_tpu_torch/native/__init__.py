"""Exact host solvers: the oracles for the card's Sinkhorn EMD and auction
(port of ``mars_tpu/native``'s two solvers; its RLE codec is
``core/rle.py`` here).

``exact_solvers.cpp`` is compiled with ``g++`` at first use into
``mars_tpu_torch/_build/`` (the name carries a hash of the source) and
bound through ctypes.  Host code only: nothing on the card's path calls it,
and it stands in for no kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from mars_tpu_torch.ops.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "exact_solvers.cpp")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libexact_solvers_{h.hexdigest()[:12]}.so")


def _build(path: str) -> None:
    # compile to a private name, then rename: a concurrent importer never
    # loads a half-written library, an interrupted build leaves none
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC}:\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.emd_uniform.restype = ctypes.c_double
        lib.emd_uniform.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int]
        lib.lsa_maximize.restype = None
        lib.lsa_maximize.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


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
