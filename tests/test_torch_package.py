"""Package rules of the port: imports, device policy, host copies."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mars_tpu_torch
from mars_tpu import cli as jcli
from mars_tpu.data.synthetic import SyntheticFSS as JSynthetic
from mars_tpu.text import tokenizer as jtok
from mars_tpu.utils import evaluation as jeval
from mars_tpu_torch import cli as tcli, device as device_lib
from mars_tpu_torch.data.synthetic import SyntheticFSS as TSynthetic
from mars_tpu_torch.models import zoo
from mars_tpu_torch.text import tokenizer as ttok
from mars_tpu_torch.utils import evaluation as teval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import pkgutil, sys
BLOCKED = ("jax", "mars_tpu", "triton", "transformers", "PIL", "cv2", "nltk", "matplotlib",
           "tensorboard", "tokenizers", "safetensors", "sentencepiece")
for b in BLOCKED:
    sys.modules[b] = None  # importing any of them now raises
import mars_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mars_tpu_torch.__path__, "mars_tpu_torch.")]
for n in names:
    __import__(n)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in BLOCKED + ("jaxlib",))
print(len(names), bad)
print(" ".join(names))
"""
# the text path's modules, which JAX's twins build on cv2 and nltk
TEXT_MODULES = ("mars_tpu_torch.text.visual_prompts", "mars_tpu_torch.text.wordnet",
                "mars_tpu_torch.text.retriever", "mars_tpu_torch.models.vip_llava")
# Semantic-SAM's modules, whose JAX twins are checked against transformers
SEMANTIC_SAM_MODULES = ("mars_tpu_torch.models.swin", "mars_tpu_torch.models.semantic_sam",
                        "mars_tpu_torch.ops.deformable_attention",
                        "mars_tpu_torch.pipeline.matcher_oss")


# the multi-device drivers and the serving runtime
PARALLEL_MODULES = ("mars_tpu_torch.parallel.mesh", "mars_tpu_torch.parallel.runner",
                    "mars_tpu_torch.cli_parallel", "mars_tpu_torch.serving",
                    "mars_tpu_torch.utils.profiling")
# the SAM decoder's train step and the exact host solvers
TRAIN_MODULES = ("mars_tpu_torch.parallel.train", "mars_tpu_torch.native")
# the readers of a ViP-LLaVA directory, whose JAX side is transformers,
# tokenizers, safetensors and PIL
VLM_FILE_MODULES = ("mars_tpu_torch.models.safetensors_io", "mars_tpu_torch.text.llama_tokenizer",
                    "mars_tpu_torch.text.image_processor", "mars_tpu_torch.text.processor")


def test_imports_without_jax_or_mars_tpu():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    counts, names = r.stdout.splitlines()
    n, bad = counts.split(maxsplit=1)
    assert int(n) >= 20 and bad.strip() == "[]", r.stdout
    wanted = (TEXT_MODULES + SEMANTIC_SAM_MODULES + PARALLEL_MODULES + TRAIN_MODULES
              + VLM_FILE_MODULES)
    assert set(wanted) <= set(names.split()), names
    for mod in pkgutil.walk_packages(mars_tpu_torch.__path__, "mars_tpu_torch."):
        path = __import__(mod.name, fromlist=["_"]).__file__
        with open(path) as f:
            src = f.read()
        assert "import mars_tpu." not in src and "from mars_tpu." not in src, path
        assert "import mars_tpu\n" not in src and "import jax" not in src, path


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_lib.resolve(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.build_dinov2()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--episodes", "1", "--gt-class-names"])
    assert device_lib.resolve("cpu") == torch.device("cpu")


def test_synthetic_episodes_and_proposals_match_jax_cli():
    jds, tds = JSynthetic(seed=3, size=96), TSynthetic(seed=3, size=96)
    jrng, trng = np.random.RandomState(3), np.random.RandomState(3)
    for idx in range(2):
        jr, tr = jds[idx], tds[idx]
        np.testing.assert_array_equal(tr.query_img, jr.query_img)
        np.testing.assert_array_equal(tr.support_masks[0], jr.support_masks[0])
        assert tr.class_name == jr.class_name
        want = jcli.synthetic_proposals(jr, 96, 16, jrng)
        got = tcli.synthetic_proposals(tr, 96, 16, trng, "cpu")
        np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_tokenizer_and_meter_copies_match():
    texts = ["a photo of red square.", "a dog, a domesticated carnivorous mammal."]
    np.testing.assert_array_equal(ttok.tokenize(texts), jtok.tokenize(texts))
    rng = np.random.RandomState(0)
    jm, tm = jeval.AverageMeter("synthetic", range(16)), teval.AverageMeter("synthetic", range(16))
    for cls in (1, 5, 1):
        pred, gt = rng.rand(2, 20, 20) > 0.5
        for m, ev in ((jm, jeval), (tm, teval)):
            m.update(*ev.classify_prediction(pred, gt), cls)
    assert tm.compute_iou()[:2] == jm.compute_iou()[:2]


def test_parallel_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from mars_tpu_torch import cli_parallel
    from mars_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_parallel.main(["--episodes", "1", "--gt-class-names",
                           "--log-path", str(tmp_path)])
    assert not torch.distributed.is_initialized() and not os.listdir(tmp_path)


def test_cli_proposals_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from mars_tpu_torch import cli_proposals

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_proposals.main(["--episodes", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_train_path_defaults_to_the_card(monkeypatch):
    """The train step's inputs come from ``zoo.build_sam``, which raises
    without a card unless asked for the CPU; the step itself follows its
    tensors."""
    from mars_tpu_torch.models import sam
    from mars_tpu_torch.parallel import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.build_sam()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.build_sam(variant="vit_b")
    opt, _ = train.make_train_step(sam.SAM_VARIANTS["vit_b"])
    state = opt.init({"w": torch.zeros(3)})
    assert state["count"].device.type == "cpu" and int(state["count"]) == 0
