"""Dataset registry (port of ``mars_tpu/data/registry.py``; reference:
matcher/data/dataset.py:14-49 FSSDataset)."""
from __future__ import annotations


def build_dataset(benchmark: str, datapath: str = "", fold: int = 0,
                  split: str = "val", shot: int = 1, seed: int = 0, **kwargs):
    if benchmark == "coco":
        from mars_tpu_torch.data.coco import DatasetCOCO20i

        return DatasetCOCO20i(datapath, fold, split, shot, seed, **kwargs)
    if benchmark == "pascal5i":
        from mars_tpu_torch.data.pascal5i import DatasetPascal5i

        return DatasetPascal5i(datapath, fold, split, shot, seed)
    if benchmark == "pascal":
        from mars_tpu_torch.data.pascal import DatasetPascal

        return DatasetPascal(datapath, fold, split, shot, seed)
    if benchmark == "paco_part":
        from mars_tpu_torch.data.parts import DatasetPacoPart

        return DatasetPacoPart(datapath, fold, split, shot, seed, **kwargs)
    if benchmark == "pascal_part":
        from mars_tpu_torch.data.parts import DatasetPascalPart

        return DatasetPascalPart(datapath, fold, split, shot, seed, **kwargs)
    if benchmark == "fss":
        from mars_tpu_torch.data.fss import DatasetFSS

        return DatasetFSS(datapath, fold, split, shot, seed)
    if benchmark == "lvis":
        from mars_tpu_torch.data.lvis import DatasetLVIS

        return DatasetLVIS(datapath, fold, split, shot, seed)
    if benchmark == "synthetic":
        from mars_tpu_torch.data.synthetic import SyntheticFSS

        return SyntheticFSS(fold=fold, split=split, shot=shot, seed=seed, **kwargs)
    raise ValueError(f"unknown benchmark: {benchmark}")
