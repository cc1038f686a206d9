"""A data x model mesh over ``torch.distributed`` and the tensor-parallel
parameter slicer (port of ``mars_tpu/parallel/mesh.py``).

  - **data axis**: episode parallelism.  Each data rank runs whole
    episodes; the only collectives on it gather the merged masks (the
    meter) or reduce across a proposal-sharded bucket.
  - **model axis**: tensor parallelism for the frozen towers and SAM's
    trained decoder.  ``qkv``/``fc1`` (and LLaMA's and SAM's decoder's
    ``q``/``k``/``v``, LLaMA's ``gate``/``up``) keep their output features
    for the rank's heads, ``proj``/``fc2`` (``o``/``out``/``down``) their
    input features, so each block does one all-reduce after its attention
    and one after its MLP (``models.layers``), the partition GSPMD derives
    from the JAX package's parameter shardings.

Rank r has data index ``r // n_model`` and model index ``r % n_model``; its
**data group** is the ranks with its model index, its **model group** the
ranks with its data index.  Under ``torchrun`` the group starts from
``env://`` on the card of ``LOCAL_RANK`` over NCCL; without that
environment a one-rank group on a ``FileStore`` in a temporary directory:
NCCL on the card, gloo on the CPU, never one in place of the other.  A
caller that wants another backend (two ranks sharing one card, a test)
starts the group itself; the mesh then uses that group.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.models import layers

# parameter-name suffixes whose kernels shard over the model axis (the JAX
# package's lists): output features for the expanding matmuls, input
# features for the contracting ones
_OUT_SHARDED = ("qkv", "fc1", "q", "k", "v", "gate", "up")
_IN_SHARDED = ("proj", "fc2", "out", "o", "down")
# leaves that keep a block whole: 4-bit weights are never partitioned (the
# JAX package replicates them), and W8A8's per-row activation scale would
# change on a slice of the row
_WHOLE_LEAVES = ("q4", "nf4", "act8")


@dataclass
class Mesh:
    """The rank's place in the (data, model) grid and its two groups."""
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    backend: str
    data_group: object = None
    model_group: object = None
    _owned: bool = field(default=False, repr=False)  # make_mesh started the group
    _tmpdir: Optional[str] = field(default=None, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def tensor_parallel(self):
        """The context in which sliced blocks reduce over the model group."""
        if self.n_model == 1:
            return contextlib.nullcontext()
        return layers.tensor_parallel(self.model_group)

    def close(self) -> None:
        """Ends the process group if ``make_mesh`` started it."""
        if self._owned:
            _end_group(self._tmpdir)
            self._owned, self._tmpdir = False, None


def _start_group(backend: str) -> Optional[str]:
    """Starts the default group: ``env://`` under torchrun, else one rank on
    a FileStore (returns its temporary directory, to remove at the end)."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return None
    tmp = tempfile.mkdtemp(prefix="mars_mesh_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return tmp


def _end_group(tmpdir: Optional[str]) -> None:
    dist.destroy_process_group()
    if tmpdir is not None:
        shutil.rmtree(tmpdir, ignore_errors=True)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The (n_data, n_model) mesh over the process group, started here when
    none is (see the module note).  ``n_data`` defaults to world // n_model;
    raises where n_data · n_model is not the world size.  ``device``: None
    is the card (``cuda:LOCAL_RANK``), ``"cpu"`` the CPU."""
    dev = device_lib.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owned = not dist.is_initialized()
    tmpdir = _start_group("nccl" if dev.type == "cuda" else "gloo") if owned else None
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        if owned:
            _end_group(tmpdir)
        raise ValueError(f"mesh {n_data} x {n_model} does not cover the world of {world} ranks")
    mesh = Mesh(n_data, n_model, rank, dev, dist.get_backend(), _owned=owned, _tmpdir=tmpdir)
    # every rank creates every group, in one order (torch.distributed's rule)
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == mesh.model_index:
            mesh.data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == mesh.data_index:
            mesh.model_group = g
    return mesh


def spec_for(path: Tuple[str, ...], tensor, n_model: int,
             q4_paths: frozenset = frozenset()) -> tuple:
    """The JAX package's ``_spec_for`` on a parameter's name path, as a
    tuple: (None, "model") output features, ("model", None) input
    features, ("model",) a vector over the model axis, () replicated."""
    if n_model <= 1 or tensor.dim() == 0:
        return ()
    names = list(path)
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "q" and parent == "kernel" and tensor.dim() == 2 and len(names) >= 3:
        owner = names[-3]  # a weight-only int8 leaf shards like its kernel
        if owner in _OUT_SHARDED and tensor.shape[1] % n_model == 0:
            return (None, "model")
        if owner in _IN_SHARDED and tensor.shape[0] % n_model == 0:
            return ("model", None)
        return ()
    if (leaf == "scale" and parent == "kernel" and len(names) >= 3
            and names[-3] in _OUT_SHARDED and tensor.shape[-1] % n_model == 0
            and tuple(names[:-1]) not in q4_paths):
        return ("model",)
    if leaf == "kernel" and tensor.dim() == 2:
        if parent in _OUT_SHARDED and tensor.shape[1] % n_model == 0:
            return (None, "model")
        if parent in _IN_SHARDED and tensor.shape[0] % n_model == 0:
            return ("model", None)
    if leaf == "bias" and parent in _OUT_SHARDED and tensor.shape[-1] % n_model == 0:
        return ("model",)
    return ()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def q4_kernel_paths(params) -> frozenset:
    """Name paths of the quantized kernel dicts that hold a packed-int4 leaf."""
    return frozenset(path[:-1] for path, _ in _leaves(params) if path and path[-1] == "q4")


def _slice(t: torch.Tensor, axis: int, r: int, n: int, thirds: bool) -> torch.Tensor:
    """Rank r's part of ``axis``; ``thirds``: a packed [q | k | v] axis, each
    third cut alike so the rank holds whole heads of all three."""
    if thirds:
        return torch.cat([_slice(part, axis, r, n, False) for part in t.chunk(3, dim=axis)],
                         dim=axis)
    size = t.shape[axis] // n
    return t.narrow(axis, r * size, size).contiguous()


def _shard_block(block, prefix, n: int, r: int, q4: frozenset):
    """A block's slices, or the block as it is where any of its sharded
    layers would not split (all or nothing: the block reads which one it
    got from its attention's width)."""
    leaves = list(_leaves(block, prefix))
    if any(path[-1] in _WHOLE_LEAVES for path, _ in leaves):
        return block
    specs = {path: spec_for(path, t, n, q4) for path, t in leaves if isinstance(t, torch.Tensor)}
    for path, spec in specs.items():
        # a float kernel's owner is its parent, an int8 code leaf's the one above
        owner = (path[-2] if path[-1] == "kernel"
                 else path[-3] if path[-2:] == ("kernel", "q") else None)
        if owner in _OUT_SHARDED + _IN_SHARDED and spec == ():
            return block

    def cut(tree, path):
        if isinstance(tree, dict):
            return {k: cut(v, path + (k,)) for k, v in tree.items()}
        spec = specs.get(path, ())
        if not spec:
            return tree
        thirds = "qkv" in path
        if spec == ("model",):
            return _slice(tree, 0, r, n, thirds)
        return _slice(tree, 1 if spec == (None, "model") else 0, r, n,
                      thirds and spec == (None, "model"))

    return cut(block, prefix)


def _is_block(tree: dict) -> bool:
    """A unit that ``shard_params`` cuts all or nothing: a transformer
    block ("attn" and "mlp"), SAM's two-way decoder layer (its attentions
    and "mlp"), or a lone projection attention (SAM's ``final_attn``)."""
    return (("attn" in tree and "mlp" in tree)
            or ("self_attn" in tree and "cross_attn_t2i" in tree and "mlp" in tree)
            or {"q", "k", "v", "out"} <= tree.keys())


def shard_params(params, mesh: Mesh):
    """The rank's part of a full parameter tree: in each block
    (``_is_block``) the sharded kernels, their biases and int8 scales cut
    to the rank's model index, whole heads at a time; everything else, and
    every block with a 4-bit or W8A8 kernel, whole."""
    n, r = mesh.n_model, mesh.model_index
    if n == 1:
        return params
    q4 = q4_kernel_paths(params)

    def walk(tree, path):
        if not isinstance(tree, dict):
            return tree
        if _is_block(tree):
            return _shard_block(tree, path, n, r, q4)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(params, ())


def gather_params(part, mesh: Mesh, like):
    """The full tree back from the ranks' ``shard_params`` parts: each leaf
    narrower than its twin in ``like`` (the full tree) is gathered over the
    model group along the axis it was cut on (a packed [q | k | v] axis
    third by third).  Called on every rank of the group."""

    def walk(t, full, path):
        if isinstance(t, dict):
            return {k: walk(v, full[k], path + (k,)) for k, v in t.items()}
        if t.shape == full.shape:
            return t
        axis = next(i for i, (a, b) in enumerate(zip(t.shape, full.shape)) if a != b)
        parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
        dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
        if "qkv" in path:
            thirds = [p.chunk(3, dim=axis) for p in parts]
            return torch.cat([torch.cat([p[i] for p in thirds], dim=axis) for i in range(3)],
                             dim=axis)
        return torch.cat(parts, dim=axis)

    return walk(part, like, ())
