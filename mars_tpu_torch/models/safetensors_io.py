"""Reader of safetensors checkpoints, the format transformers saves weights
in, without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"``), then the tensors' raw little-endian bytes,
each at its offsets past the header.

  - ``SafetensorsFile``: one file, mapped; ``tensor(name)`` builds one
    tensor from its offsets when asked.
  - ``Checkpoint``: a directory's weights, its shard index
    (``model.safetensors.index.json``) or its single ``model.safetensors``.
  - ``Deferred``: one tensor of a checkpoint, read only by ``load``; the
    converters permute it without reading it (``convert._t``, ``_conv``),
    so a checkpoint is converted one tensor at a time.
"""
from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np
import torch

# safetensors dtype → (numpy type of the stored bits, torch type to view them as)
DTYPES = {"F32": (np.float32, None), "F16": (np.float16, None),
          "BF16": (np.uint16, torch.bfloat16), "I64": (np.int64, None),
          "I32": (np.int32, None), "I8": (np.int8, None), "U8": (np.uint8, None),
          "BOOL": (np.bool_, None)}
INDEX = "model.safetensors.index.json"
SINGLE = "model.safetensors"


class SafetensorsFile:
    """One ``.safetensors`` file, mapped read-only."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self._map) < 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        n = struct.unpack("<Q", self._map[:8])[0]
        if 8 + n > len(self._map):
            raise ValueError(f"{path}: header of {n} bytes runs past the file")
        header = json.loads(bytes(self._map[8:8 + n]))
        header.pop("__metadata__", None)
        self.entries = header
        self._data = 8 + n

    def keys(self):
        return self.entries.keys()

    def close(self) -> None:
        self._map.close()

    def shape(self, name: str) -> tuple:
        return tuple(self.entries[name]["shape"])

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the host, in its stored type (BF16 as
        ``torch.bfloat16``); raises on a type this reader does not read."""
        e = self.entries[name]
        code = e["dtype"]
        if code not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name} is {code}; this reader reads "
                             f"{', '.join(DTYPES)}")
        bits, view = DTYPES[code]
        dt = np.dtype(bits).newbyteorder("<")
        begin, end = e["data_offsets"]
        count = int(np.prod(e["shape"], dtype=np.int64))
        if end - begin != count * dt.itemsize or self._data + end > len(self._map):
            raise ValueError(f"{self.path}: tensor {name}'s offsets {begin}..{end} do not "
                             f"hold {e['shape']} of {code}")
        arr = np.frombuffer(self._map, dtype=dt, count=count, offset=self._data + begin)
        t = torch.from_numpy(arr.reshape(e["shape"]).astype(dt.newbyteorder("="), copy=True))
        return t.view(view) if view is not None else t


def load_file(path: str) -> dict:
    """Every tensor of one file → {name: tensor}."""
    f = SafetensorsFile(path)
    try:
        return {name: f.tensor(name) for name in f.keys()}
    finally:
        f.close()


class Deferred:
    """One tensor of a checkpoint with the axis order the converters asked
    for; ``load`` reads it, onto ``device``, permuted and contiguous."""
    deferred = True

    def __init__(self, file: SafetensorsFile, name: str, axes=None):
        self.file, self.name, self.axes = file, name, axes
        base = file.shape(name)
        self.shape = base if axes is None else tuple(base[a] for a in axes)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def permuted(self, axes) -> "Deferred":
        inner = self.axes if self.axes is not None else tuple(range(self.ndim))
        return Deferred(self.file, self.name, tuple(inner[a] for a in axes))

    def load(self, device="cpu") -> torch.Tensor:
        t = self.file.tensor(self.name).to(device)
        return t if self.axes is None else t.permute(self.axes).contiguous()

    def __array__(self, *args, **kwargs):
        raise TypeError(f"{self.name} is deferred: read it with load()")


class Checkpoint:
    """A directory's safetensors weights: the shards its index names (every
    indexed name must be in its shard, and every shard's name in the index),
    or its single ``model.safetensors``."""

    def __init__(self, path: str):
        index = os.path.join(path, INDEX)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = {s: SafetensorsFile(os.path.join(path, s))
                     for s in sorted(set(weight_map.values()))}
            self._files = list(files.values())
            self._where = {}
            for name, shard in weight_map.items():
                if name not in files[shard].entries:
                    raise ValueError(f"{INDEX} puts {name} in {shard}, which does not hold it")
                self._where[name] = files[shard]
            for shard, f in files.items():
                extra = sorted(set(f.keys()) - set(self._where))
                if extra:
                    raise ValueError(f"{shard} holds tensors {INDEX} does not name: {extra[:5]}")
        elif os.path.exists(os.path.join(path, SINGLE)):
            f = SafetensorsFile(os.path.join(path, SINGLE))
            self._files = [f]
            self._where = {name: f for name in f.keys()}
        else:
            raise FileNotFoundError(f"neither {INDEX} nor {SINGLE} is in {path}")

    def keys(self):
        return self._where.keys()

    def close(self) -> None:
        for f in self._files:
            f.close()

    def __enter__(self) -> "Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def tensor(self, name: str) -> torch.Tensor:
        return self._where[name].tensor(name)

    def deferred(self, name: str) -> Deferred:
        return Deferred(self._where[name], name)
