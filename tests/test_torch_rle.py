"""The port's numpy RLE (``core.rle``) against ``mars_tpu.native``'s C++
codec, bit for bit, and ``cli_proposals --coco-rle``'s side file against
the JAX CLI's on the tiny fixture towers."""
import json
import os

import numpy as np
import pytest

from mars_tpu import cli_proposals as jcli_proposals, native
from mars_tpu.models import dinov2 as jdino, sam as jsam, zoo as jzoo
from mars_tpu.pipeline import amg as jamg
from mars_tpu_torch import cli_proposals as tcli_proposals
from mars_tpu_torch.core import rle
from mars_tpu_torch.utils import visualize
from test_torch_cli_proposals import AMG, DINO, SAM, SIZE, tiny_port, trees  # noqa: F401

_rng = np.random.RandomState(0)
MASKS = {
    "random_37x53": (_rng.rand(37, 53) > 0.6).astype(np.uint8),
    "col_major_4x3": np.eye(4, 3, k=1, dtype=np.uint8),
    "empty_5x5": np.zeros((5, 5), np.uint8),
    "full_5x5": np.ones((5, 5), np.uint8),
    "sparse_64x64": (_rng.rand(64, 64) > 0.97).astype(np.uint8),
    "long_runs_1100x1000": np.pad(np.ones((1000, 900), np.uint8), ((50, 50), (60, 40))),
    "float_mask": _rng.rand(9, 11).astype(np.float32) * 2,  # the uint8 cast decides
    "bool_mask": _rng.rand(41, 29) > 0.55,
}


@pytest.mark.parametrize("name", list(MASKS))
def test_encode_and_compress_equal_native(name):
    m = MASKS[name]
    want = native.rle_encode(m)
    got = rle.rle_encode(m)
    assert got == want
    assert rle.rle_encode_compressed(m) == native.rle_encode_compressed(m)
    back = rle.rle_decode(got)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, native.rle_decode(want))
    np.testing.assert_array_equal(back, m.astype(np.uint8) != 0)
    comp = rle.rle_encode_compressed(m)
    np.testing.assert_array_equal(rle.rle_decode_compressed(comp), back)
    np.testing.assert_array_equal(
        rle.rle_decode({"size": comp["size"], "counts": comp["counts"].decode("ascii")}), back)


@pytest.mark.parametrize("counts", [[0, 3, 1048576, 2, 5, 1, 700000, 1], [25], [0, 25],
                                    [0, 1, 0, 1, 0, 23], [7, 2 ** 31 - 1, 3, 2 ** 31, 1]])
def test_counts_string_codec_equals_native(counts):
    """Negative deltas (sign extension) and multi-chunk varints."""
    s = rle.counts_to_string(counts)
    assert s == native._counts_to_string(np.asarray(counts, np.uint32))
    assert rle.string_to_counts(s) == list(native._string_to_counts(s)) == counts


@pytest.mark.parametrize("size,counts", [((4, 4), [3, 20]), ((4, 4), [2, 3]), ((3, 2), [])])
def test_decode_of_overlong_and_short_counts_equals_native(size, counts):
    r = {"size": list(size), "counts": counts}
    np.testing.assert_array_equal(rle.rle_decode(r), native.rle_decode(r))


def _jax_dump(trees, monkeypatch, out):
    monkeypatch.setattr(jzoo, "build_dinov2", lambda *a, **k: (trees["dino"],
                                                               jdino.DinoV2Config(**DINO)))
    monkeypatch.setattr(jzoo, "build_sam", lambda *a, **k: (trees["sam"], jsam.SamConfig(**SAM)))
    real = jamg.AmgConfig
    monkeypatch.setattr(jamg, "AmgConfig", lambda **k: real(**{**AMG, **k}))
    jcli_proposals.main(["--episodes", "1", "--input-size", str(SIZE), "--out", str(out),
                         "--coco-rle", "--visualize", "1"])


def test_coco_rle_side_file_equals_jax(tiny_port, trees, monkeypatch, tmp_path):
    """Each CLI's side file decodes to its own dump's live masks with its
    IoUs; and the port's records for the JAX dump's masks and scores,
    dumped as the CLI dumps them, are the JAX CLI's file byte for byte.
    With --visualize 1 both write the figure under the same name; the
    port prompts with k-means++ centres (--use-centers), which changes its
    masks, not the side file's contract."""
    res = tcli_proposals.main(["--episodes", "1", "--input-size", str(SIZE), "--sam-size",
                               "vit_b", "--out", str(tmp_path / "port"), "--device", "cpu",
                               "--coco-rle", "--visualize", "1", "--use-centers"])
    _jax_dump(trees, monkeypatch, tmp_path / "jax")
    for side in ("port", "jax"):
        with np.load(tmp_path / side / "0_0.npz") as dump:
            masks, iou, cid = dump["masks"], dump["iou"], int(dump["class_id"])
        with open(tmp_path / side / "0_0.json") as f:
            anns = json.load(f)
        assert len(anns) == len(masks) > 0
        for a, m, s in zip(anns, masks, iou):
            assert a["size"] == [SIZE, SIZE] and a["category_id"] == cid
            assert a["score"] == float(s)
            np.testing.assert_array_equal(rle.rle_decode(a), m)
        if side == "jax":
            mine = tmp_path / "port_of_jax.json"
            with open(mine, "w") as f:
                json.dump(tcli_proposals.coco_rle_records(masks, iou, cid), f)
            assert mine.read_bytes() == (tmp_path / "jax" / "0_0.json").read_bytes()
    assert res["live_proposals"] == [len(np.load(tmp_path / "port" / "0_0.npz")["masks"])]
    assert os.listdir(tmp_path / "port" / "viz") == os.listdir(tmp_path / "jax" / "viz") \
        == ["ep00000.png"]
    rgb, text = visualize.read_png(str(tmp_path / "port" / "viz" / "ep00000.png"))
    assert text["Title"].startswith("episode 0") and rgb.shape[2] == 3
