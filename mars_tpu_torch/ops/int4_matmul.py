"""Weight-only 4-bit matmuls: packed nibbles streamed from device memory and
unpacked in the kernel (port of ``mars_tpu/ops/int4_matmul.py``).

Two formats, both two nibbles per byte along the INPUT dimension of an
(IN, OUT) kernel, stored (IN/2, OUT) as int8 bit patterns:

  - hybrid int4 (``pack_int4``): ``byte = (q[2i+1] << 4) | ((q[2i] + 8) & 0xF)``,
    so the low nibble minus 8 is the even row and an arithmetic shift of
    the signed byte is the odd row; per-output-column float32 scales
    multiply AFTER the float32 accumulation;
  - NF4 (``models.quantization.quantize_kernel_nf4``): unsigned indices into
    the 16-entry NormalFloat codebook, float32 absmax scales per 64-row
    block, folded in BEFORE the product, the weight rounded to x's type.

On a CUDA tensor ``matmul_int4`` / ``matmul_nf4`` launch the hand-written
Hopper kernels of ``csrc/int4_matmul.cu`` or raise, one launch per call
(``route`` names the kernel): for M ≤ 8 rows (decode) with bfloat16 x a
split-K GEMV on the tensor cores (``gemv_split`` picks the K slices; the
last CTA of a column tile sums the slices' float32 partials in slice order
from a workspace this module keeps per device and stream); with float32 x a
GEMV on the CUDA cores; for 8 < M ≤ ``SKINNY_MAX_ROWS`` (a speculative
verify forward's rows) with bfloat16 x the skinny GEMM, the GEMV widened to
wgmma m64nNk16 with the weights dequantized into its register operand and
x as its shared-memory operand (``skinny_split`` picks the K slices and row
groups; the same workspace and in-order reduction); above it (prefill,
the 512-row suffix forwards) with bfloat16 x the prefill GEMM, the same
operands on tiles of 128 columns x 128-256 rows (the weights dequantized
into registers once per tile and 64-row block; a producer warpgroup feeds
a ring by TMA, or by cp.async where a tensor map cannot describe x or the
codes; persistent CTAs; no K split, no workspace); for M > 8 with float32 x
the SIMT GEMM on the CUDA cores.  On a CPU tensor they
take ``matmul_int4_plain`` / ``matmul_nf4_plain``, which follow the JAX
package's non-TPU branch of ``quantized_dense``: the weight unpacked to x's
type, products and sums in float32, the result cast to x's type.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from mars_tpu_torch.ops import build

_FMT_INT4, _FMT_NF4 = 0, 1
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 3)
_PLAN_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
_CODE: Dict[torch.device, torch.Tensor] = {}
# (device, stream) -> (float32 partials, int32 arrival counters of the column tiles)
_WORKSPACE: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}

GEMV_MAX_ROWS = 8     # x rows the GEMV takes: the n8 of its mma
GEMV_COLS = 128       # output columns a CTA of the GEMV owns
GEMV_BLOCK = 64       # input rows of a K block (one NF4 scale row)
GEMV_MAX_SPLIT = 16
GEMV_MIN_CTAS = 2 * 132  # two CTAs on each SM of an H100 SXM
# The skinny GEMM takes 8 < M <= SKINNY_MAX_ROWS bfloat16 rows: every row of a
# speculative verify forward (B x 9 at 8 draft tokens: 9, 18, 36, 72).  On an
# H100 it beat the prefill GEMM over a LLaMA-7B layer's seven projections at
# 73 and 96 rows and lost from 112 on, in both formats
# (tools/prefill_probe.py; PERF.md, the prefill GEMM's findings); the
# pipelined text stage's 128-row suffix forwards, the block's 512-row ones and
# prefill take the prefill GEMM.
SKINNY_MAX_ROWS = 96
SKINNY_GROUP_ROWS = 72   # x rows of one row group (one CTA's N), at most 72
SKINNY_COLS = 128        # output columns a CTA of the skinny GEMM owns
SKINNY_MAX_SPLIT = 8     # K slices: the last CTA holds each slice's partial of a batch


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(IN, OUT) int8 values in [-7, 7] → (IN/2, OUT) hybrid-packed int8."""
    if q.shape[0] % 2:
        raise ValueError("input dim must be even to pack nibbles")
    lo, hi = q[0::2].to(torch.int16), q[1::2].to(torch.int16)
    return (((lo + 8) & 0xF) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(IN/2, OUT) hybrid-packed int8 → (IN, OUT) int8 in [-8, 7]."""
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 8
    hi = p >> 4  # arithmetic: sign-preserving
    n, out = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(n * 2, out).to(torch.int8)


def _nf4_code():
    # one source of truth for the codebook, imported late to keep the
    # ops → models import one-directional at load time
    from mars_tpu_torch.models.quantization import NF4_CODE

    return NF4_CODE


def matmul_int4_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: x (M, IN) @ unpack(packed)
    in float32, times scale (OUT,), cast to x's type."""
    w = unpack_int4(packed).to(x.dtype)
    y = torch.matmul(x.float(), w.float())
    return (y * scale.float()).to(x.dtype)


def matmul_nf4_plain(x: torch.Tensor, packed: torch.Tensor, bscale: torch.Tensor) -> torch.Tensor:
    """x (M, IN) @ nf4_dequant(packed, bscale) with the weight rounded to
    x's type first, products and sums in float32, cast to x's type."""
    from mars_tpu_torch.models.quantization import dequantize_nf4

    w = dequantize_nf4({"nf4": packed, "bscale": bscale}, x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def gemv_split(d_in: int, d_out: int) -> int:
    """K slices S of the bf16 GEMV at (IN, OUT): the smallest power of two
    for which the 128-column tiles × S make ``GEMV_MIN_CTAS`` CTAs, at most
    16 and at most the 64-row blocks of IN.  A constant of the shape (not
    of the card), so the summation order, and the result, is one on every
    card: 4096→4096 and 11008→4096 take 16, 4096→11008 takes 4."""
    tiles = -(-d_out // GEMV_COLS)
    blocks = -(-d_in // GEMV_BLOCK)
    s = 1
    while tiles * s < GEMV_MIN_CTAS and 2 * s <= min(GEMV_MAX_SPLIT, blocks):
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def skinny_split(d_in: int, d_out: int, m: int) -> Tuple[int, int]:
    """(S, G) of the skinny GEMM at (IN, OUT) and M rows: G row groups of at
    most ``SKINNY_GROUP_ROWS`` rows, then the most K slices S for which the
    128-column tiles × G × S fit one wave of ``GEMV_MIN_CTAS`` CTAs (two an
    SM), at most 8 and at most the 64-row blocks of IN.  One wave: 9 slices
    of 32 tiles made 288 CTAs, a second wave of 24 behind 264.  A constant of
    the shape (not of the card): the summation order, and the result, is one
    on every card.  At the 7B's shapes up to 72 rows: 4096→4096 and
    11008→4096 take S = 8 (32 tiles, 256 CTAs), 4096→11008 S = 3 (86 tiles,
    258 CTAs)."""
    groups = -(-m // SKINNY_GROUP_ROWS)
    ctas = -(-d_out // SKINNY_COLS) * groups
    blocks = -(-d_in // GEMV_BLOCK)
    return max(1, min(GEMV_MIN_CTAS // ctas, SKINNY_MAX_SPLIT, blocks)), groups


def route(m: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call of M rows in ``dtype`` launches: ``gemv``
    (M ≤ 8), ``skinny`` (bfloat16, 8 < M ≤ ``SKINNY_MAX_ROWS``) or ``gemm``."""
    if m <= GEMV_MAX_ROWS:
        return "gemv"
    return "skinny" if dtype == torch.bfloat16 and m <= SKINNY_MAX_ROWS else "gemm"


def _workspace(device: torch.device, stream: int, floats: int,
               tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GEMV's and the skinny GEMM's split-K workspace on (device, stream)
    (one launch at a time a stream), grown to hold
    ``floats`` partials and ``tiles`` counters; zeroed once when allocated
    (the last CTA of each tile resets its counter), nothing allocated per
    call once warm."""
    key = (device, stream)
    ws, counters = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.zeros(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)
    _WORKSPACE[key] = ws, counters
    return ws, counters


def _current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it, without
    building a Stream object each call (a few host µs of every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _library() -> ctypes.CDLL:
    return build.load("int4_matmul", {"mars_matmul_4bit": _ARGTYPES,
                                      "mars_prefill_plan": _PLAN_ARGTYPES})


def _code_on(device: torch.device) -> torch.Tensor:
    if device not in _CODE:
        _CODE[device] = torch.from_numpy(_nf4_code()).to(device)
    return _CODE[device]


def _launch(fmt: int, x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"x must be (M, IN) and packed (IN/2, OUT): {x.shape} {packed.shape}")
    m, d_in = x.shape
    d_out = packed.shape[1]
    if packed.shape[0] * 2 != d_in:
        raise ValueError(f"packed rows {packed.shape[0]} != IN/2 = {d_in / 2}")
    want = (d_out,) if fmt == _FMT_INT4 else (d_in // 64, d_out)
    if fmt == _FMT_NF4 and d_in % 64:
        raise ValueError(f"NF4 needs IN divisible by 64, got {d_in}")
    if tuple(scale.shape) != want:
        raise ValueError(f"scale shape {tuple(scale.shape)} != {want}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if packed.dtype not in (torch.int8, torch.uint8) or scale.dtype != torch.float32:
        raise TypeError(f"packed must be int8/uint8 and scale float32: {packed.dtype} "
                        f"{scale.dtype}")
    dev = x.device
    if packed.device != dev or scale.device != dev:
        raise ValueError("inputs must lie on one device")
    if not (x.is_contiguous() and packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((m, d_out), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    code = _code_on(dev) if fmt == _FMT_NF4 else None
    stream = _current_stream(dev)
    bf16 = x.dtype == torch.bfloat16
    split, groups, ws, counters = 1, 0, None, None
    kernel = route(m, x.dtype)
    if bf16 and kernel != "gemm":
        # partial rows a slice: the GEMV's 8, the skinny GEMM's M
        split, groups, rows = ((gemv_split(d_in, d_out), 0, GEMV_MAX_ROWS) if kernel == "gemv"
                               else skinny_split(d_in, d_out, m) + (m,))
        if split > 1:
            tiles = -(-d_out // GEMV_COLS)
            ws, counters = _workspace(dev, stream, split * rows * tiles * GEMV_COLS, tiles)
    err = _library().mars_matmul_4bit(
        fmt, int(bf16), x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        None if code is None else code.data_ptr(), out.data_ptr(), m, d_in, d_out, split, groups,
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed with CUDA error {err} "
                           f"(x {tuple(x.shape)}, packed {tuple(packed.shape)})")
    return out


def prefill_plan(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> Tuple[int, str]:
    """(x rows a tile, ``"tma"`` or ``"cp.async"``): the prefill GEMM the
    library launches for these bfloat16 CUDA operands (NF4 when ``scale`` is
    the (IN/64, OUT) block scale), from the same decision its launch takes."""
    fmt = _FMT_NF4 if scale.dim() == 2 else _FMT_INT4
    code = _library().mars_prefill_plan(fmt, x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                                        x.shape[0], x.shape[1], packed.shape[1])
    if code < 0:
        raise RuntimeError("no CUDA device for the prefill GEMM's plan")
    return code // 2, "tma" if code % 2 else "cp.async"


def matmul_int4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, IN) @ (unpack_int4(packed (IN/2, OUT)) * scale (OUT,)) → (M, OUT)
    in x's type.  ``matmul_int4.launches`` counts the kernel's launches."""
    if not x.is_cuda:
        return matmul_int4_plain(x, packed, scale)
    out = _launch(_FMT_INT4, x, packed, scale)
    matmul_int4.launches += 1
    return out


def matmul_nf4(x: torch.Tensor, packed: torch.Tensor, bscale: torch.Tensor) -> torch.Tensor:
    """x (M, IN) @ nf4_dequant(packed (IN/2, OUT), bscale (IN/64, OUT)) →
    (M, OUT) in x's type.  ``matmul_nf4.launches`` counts the launches."""
    if not x.is_cuda:
        return matmul_nf4_plain(x, packed, bscale)
    out = _launch(_FMT_NF4, x, packed, bscale)
    matmul_nf4.launches += 1
    return out


matmul_int4.launches = 0
matmul_nf4.launches = 0
