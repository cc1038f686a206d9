#!/usr/bin/env python3
"""Where the auction kernel's round time goes, on one card.

    python3 tools/auction_probe.py [PARENT_ROOT]

Builds variants of ``mars_tpu_torch/csrc/auction.cu`` (exact-line edits of
the source: the cluster at 8, 4, 2 and 1 CTAs, each also with clock64
ticks; one ``nvcc`` each, all started together, into
``mars_tpu_torch/_build/probe/``) and launches each through the kernel's C
interface on the same instances: tests/test_ops.py's 96 x 96 instance (rows
of 384 bytes: what a round costs besides its rows), ``chip_smoke.py``'s
dense contested one and the forward and reverse matching instances of
synthetic episode 0.  Per variant and instance it prints one JSON line:
``ms`` (CUDA events around 5 runs of every ε-phase), the rounds,
``us_per_round``, a digest of the assignment and prices (bit-exact
variants share it) and, for the ``+tick`` builds, thread 0's clock64
cycles a round in CTA 0: in a small round (``cycles_small``) its row
slice's loads, chain and warp merge (``row``), the wait for every CTA's
partial (``exchange``), the slices' merge and the bid (``merge_bid``), the
columns' winners (``winner``), the winners' writes and the next list
(``resolve``) and the block barrier (``barrier``); in a dense round
(``cycles_dense``) the relaxed cluster barrier, the bids, the wait for
every CTA's bids, the column keys and the winners' pass; ``path_rounds``
counts the rounds of each.  With PARENT_ROOT its ``auction.cu`` is timed
too.  The ptxas line of each build (registers, spills) comes first.
Timing only: the kernel's contract is held by tests/test_torch_cuda.py and
``chip_smoke.py``.  Imports nothing of JAX.
"""
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "mars_tpu_torch", "csrc", "auction.cu")
OUT = os.path.join(REPO, "mars_tpu_torch", "_build", "probe")
TICK = [
    ("  int rounds = 0, dense = 0, small = 0, dense_rows = 0, small_rows = 0;\n",
     "  int rounds = 0, dense = 0, small = 0, dense_rows = 0, small_rows = 0;\n"
     "  __shared__ unsigned long long seg[14];\n  if (tid < 14) seg[tid] = 0;\n  __syncthreads();\n"
     "  long long t0 = 0, ta = 0, tx = 0, tb = 0, t1 = 0, t2 = 0;\n"),
    ("    const int nb = count[par];\n", "    t0 = clock64();\n    const int nb = count[par];\n"),
    ("          st_async(round_part + rank * WARPS + warp, bar + par, lane, m1, m2, j);\n      }\n",
     "          st_async(round_part + rank * WARPS + warp, bar + par, lane, m1, m2, j);\n"
     "        ta = clock64();\n      }\n"),
    ("        mbar_wait(bar + par, (phases >> par) & 1);\n",
     "        mbar_wait(bar + par, (phases >> par) & 1);\n        tx = clock64();\n"),
    ("        unsigned long long best = key;",
     "        tb = clock64();\n        unsigned long long best = key;"),
    ("        int add = r;\n", "        t1 = clock64();\n        int add = r;\n"),
    ("        if (lane == 0) count[par ^ 1] = __popc(m);\n      }\n",
     "        if (lane == 0) count[par ^ 1] = __popc(m);\n        t2 = clock64();\n      }\n"),
    ("      if (tid == 0) mbar_expect(bar + par, 8 * nb);\n",
     "      ta = clock64();\n      if (tid == 0) mbar_expect(bar + par, 8 * nb);\n"),
    ("      mbar_wait(bar + par, (phases >> par) & 1);\n      phases ^= 1 << par;\n",
     "      tx = clock64();\n      mbar_wait(bar + par, (phases >> par) & 1);\n"
     "      tb = clock64();\n      phases ^= 1 << par;\n"),
    ("      int next = 0;\n", "      t1 = clock64();\n      int next = 0;\n"),
    ("      if (tid == 0) count[par ^ 1] = next;\n",
     "      if (tid == 0) count[par ^ 1] = next;\n      t2 = clock64();\n"),
    ("    __syncthreads();\n    ++rounds;\n",
     "    __syncthreads();\n    {\n      const long long t3 = clock64();\n"
     "      if (nb <= WARPS && tid == 0) {\n"
     "        seg[0] += ta - t0;\n        seg[1] += tx - ta;\n        seg[2] += tb - tx;\n"
     "        seg[3] += t1 - tb;\n        seg[4] += t2 - t1;\n        seg[5] += t3 - t2;\n"
     "        seg[7] += 1;\n      }\n"
     "      if (nb > WARPS && tid == 0) {\n"
     "        seg[6] += t3 - t0;\n        seg[8] += 1;\n        seg[9] += ta - t0;\n"
     "        seg[10] += tx - ta;\n        seg[11] += tb - tx;\n        seg[12] += t1 - tb;\n"
     "        seg[13] += t2 - t1;\n      }\n    }\n"
     "    ++rounds;\n"),
    ("      stats[3] = small_rows;\n",
     "      stats[3] = small_rows;\n      for (int k = 0; k < 14; ++k) stats[4 + k] = (int)seg[k];\n"),
]
VARIANTS = {
    "change": [],
    "cluster4": [("constexpr int CLUSTER = 8;", "constexpr int CLUSTER = 4;")],
    "cluster2": [("constexpr int CLUSTER = 8;", "constexpr int CLUSTER = 2;")],
    "cluster1": [("constexpr int CLUSTER = 8;", "constexpr int CLUSTER = 1;")],
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _edit(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"probe edit does not match exactly once: {old!r}")
        text = text.replace(old, new)
    return text


def build(sources):
    """{name: source text} → {name: (library path, ptxas lines)}."""
    from mars_tpu_torch.ops import build as kbuild

    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"lib{name}.so")
        jobs[name] = (subprocess.Popen([kbuild.nvcc_path(), *kbuild.FLAGS, "-o", lib, src],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    built = {}
    for name, (proc, lib) in jobs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln])
    return built


def main(argv):
    import torch

    sys.path.insert(0, REPO)
    smoke = _chip_smoke()
    from mars_tpu_torch import device as device_lib
    from mars_tpu_torch.ops import assignment as asg

    device_lib.resolve("cuda")
    with open(SOURCE) as f:
        text = f.read()
    sources = {}
    for name, edits in VARIANTS.items():
        sources[name] = _edit(text, edits)
        sources[name + "+tick"] = _edit(sources[name], TICK)
    if argv:
        with open(os.path.join(argv[0], "mars_tpu_torch", "csrc", "auction.cu")) as f:
            sources["parent"] = f.read()
    built = build(sources)
    for name, (_, ptxas) in built.items():
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)

    cases = []
    for name, seed, t, n, phases in smoke.AUCTION_CASES:
        if name.startswith(("test_ops_seed2", "dense_contested")):
            s, v = smoke.auction_case(seed, t, n)
            cases.append((name, torch.from_numpy(s).cuda(), torch.from_numpy(v).cuda(), phases,
                          None))
    cases += [(name, s, v, 1, 128) for name, s, v in smoke._matching_instances()]
    stream = torch.cuda.current_stream().cuda_stream
    for case, s, v, phases, chunk in cases:
        scores, valid, _, eps = asg.phase_inputs(s, v, phases, chunk)
        valid = valid.to(torch.uint8).contiguous()
        t, n = scores.shape
        for name, (lib, _) in built.items():
            fn = ctypes.CDLL(lib).mars_auction_phase
            fn.argtypes = asg._ARGTYPES

            def run():
                prices = torch.zeros((n,), dtype=torch.float32, device="cuda")
                col, stats = None, []
                for e in eps:
                    col = torch.empty((t,), dtype=torch.int32, device="cuda")
                    out = torch.empty_like(prices)
                    st = torch.zeros((24,), dtype=torch.int32, device="cuda")
                    err = fn(scores.data_ptr(), valid.data_ptr(), prices.data_ptr(), float(e), t,
                             n, 20000, asg.SMALL_K, col.data_ptr(), out.data_ptr(),
                             st.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                    prices = out
                    stats.append(st)
                return col, prices, stats

            col, prices, stats = run()
            st = torch.stack(stats).sum(0).tolist()
            rounds = st[0] + st[1]
            ms = smoke.cuda_ms(run, iters=5, warmup=1)
            row = {"variant": name, "instance": case, "ms": ms,
                   "rounds": {"dense": st[0], "small": st[1]},
                   "us_per_round": ms * 1e3 / max(rounds, 1),
                   "digest": hashlib.sha256(col.cpu().numpy().tobytes()
                                            + prices.cpu().numpy().tobytes()).hexdigest()[:16]}
            if name.endswith("+tick"):
                row["cycles_small"] = {k: st[4 + i] / max(st[11], 1) for i, k in enumerate(
                    ("row", "exchange", "merge_bid", "winner", "resolve", "barrier"))}
                row["cycles_dense"] = {k: st[i] / max(st[12], 1) for i, k in (
                    (10, "total"), (13, "entry_sync"), (14, "bids"), (15, "bids_wait"),
                    (16, "keys"), (17, "winners"))}
                row["path_rounds"] = {"small": st[11], "dense": st[12]}
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
