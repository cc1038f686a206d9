"""The two-program evaluation on the CPU: the port's ``cli_proposals``
writes proposal dumps with the JAX CLI's keys and types, both packages'
``load_proposals`` read them (and hand-made ``.npy``/``.npz``/``.pt``
stacks) into equal buckets, and ``cli --mask-proposals-path`` ranks them.

Tiny towers stand in for the full-width ones on both sides (a full-width
SAM encode at 1024 is far too slow for the CPU suite): the golden
episode's DINOv2 (patch 14, input size 112) and CLIP towers, and the
golden Matcher fixture's SAM; the AMG's selection thresholds are set to 0
so the dumps hold live masks.
"""
import functools
import os
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from mars_tpu import cli as jcli, cli_proposals as jcli_proposals
from mars_tpu.models import convert as jconvert, dinov2 as jdino, sam as jsam, zoo as jzoo
from mars_tpu.pipeline import amg as jamg
from mars_tpu_torch import cli as tcli, cli_proposals as tcli_proposals
from mars_tpu_torch.models import clip as tclip, convert as tconvert, dinov2 as tdino
from mars_tpu_torch.models import sam as tsam, zoo
from mars_tpu_torch.pipeline import amg as tamg

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SIZE = 112
DINO = dict(patch_size=14, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
            pos_embed_grid=8)
SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
           global_attn_indexes=(1,), window_size=2, out_chans=32, decoder_mlp_dim=64,
           decoder_heads=2)
AMG = dict(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0, box_nms_thresh=0.5,
           sel_multimask_output=True, sel_output_layer=3, decode_batch=16)
# what mars_tpu/cli_proposals.py writes, key by key
DUMP_DTYPES = {"masks": np.uint8, "iou": np.float32, "stability": np.float32,
               "emd": np.float32, "merged": np.uint8}


def _sd(name):
    data = np.load(os.path.join(FIXTURES, name))
    return {k[3:]: data[k] for k in data.files if k.startswith("sd.")}


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def trees():
    """The tiny towers as JAX trees (float32); the port gets the same arrays."""
    ep, mt = _sd("golden_episode_tiny.npz"), _sd("golden_matcher_tiny.npz")
    sam_sd = _sub(mt, "sam.")
    return {"dino": jconvert.dinov2_to_flax(_sub(ep, "dino."), depth=3, num_register_tokens=4),
            "sam": {"encoder": jconvert.sam_encoder_to_flax(sam_sd, depth=3),
                    "prompt_encoder": jconvert.sam_prompt_encoder_to_flax(sam_sd),
                    "decoder": jconvert.sam_decoder_to_flax(sam_sd)},
            "episode_sd": ep}


def _port(tree):
    return tconvert.from_jax_params(jax.tree.map(np.asarray, tree))


@pytest.fixture
def tiny_port(monkeypatch, trees):
    tcfg = tclip.ClipTextConfig(width=16, depth=2, num_heads=2, output_dim=16)
    ep = trees["episode_sd"]

    def clip_pair(prefix, depth, alpha):
        sub = _sub(ep, prefix)
        return (tconvert.from_reference_state_dict(
                    sub, "alpha_clip_visual" if alpha else "clip_visual", depth),
                tconvert.from_reference_state_dict(sub, "clip_text", 2),
                tconvert.logit_scale(sub),
                tclip.ClipVisualConfig(width=64, depth=depth, num_heads=1, output_dim=16,
                                       pos_embed_grid=7, alpha_channel=alpha), tcfg)

    monkeypatch.setattr(zoo, "build_dinov2", lambda seed=0, device=None: (
        _port(trees["dino"]), tdino.DinoV2Config(**DINO)))
    monkeypatch.setattr(zoo, "build_clip", lambda seed=1, device=None: clip_pair("clip.", 3,
                                                                                 False))
    monkeypatch.setattr(zoo, "build_alpha_clip", lambda seed=2, device=None: clip_pair(
        "aclip.", 2, True))
    monkeypatch.setattr(zoo, "build_sam", lambda variant="vit_h", seed=3, device=None: (
        _port(trees["sam"]), tsam.SamConfig(**SAM)))
    monkeypatch.setattr(tamg, "AmgConfig", functools.partial(tamg.AmgConfig, **AMG))


@pytest.fixture
def port_dump(tiny_port, tmp_path):
    out = tmp_path / "port"
    res = tcli_proposals.main(["--episodes", "2", "--input-size", str(SIZE), "--sam-size",
                               "vit_b", "--out", str(out), "--device", "cpu"])
    return out, res


def test_dump_has_jax_keys_and_types(port_dump, trees, monkeypatch, tmp_path):
    """The port's dumps against the JAX CLI's own, written from the same
    tiny towers: the same files, keys, types and per-episode proposal
    counts, and the same class ids."""
    out, res = port_dump
    monkeypatch.setattr(jzoo, "build_dinov2", lambda *a, **k: (trees["dino"],
                                                               jdino.DinoV2Config(**DINO)))
    monkeypatch.setattr(jzoo, "build_sam", lambda *a, **k: (trees["sam"], jsam.SamConfig(**SAM)))
    monkeypatch.setattr(jamg, "AmgConfig", functools.partial(jamg.AmgConfig, **AMG))
    jout = tmp_path / "jax"
    jcli_proposals.main(["--episodes", "2", "--input-size", str(SIZE), "--out", str(jout)])
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == ["0_0.npz", "0_1.npz"]
    assert res["files"] == [str(out / "0_0.npz"), str(out / "0_1.npz")]
    assert res["launches"] == {name: 0 for name in tcli.KERNELS}  # CPU: plain versions
    assert res["episode_launches"] == [res["launches"]] * 2
    for name in ("0_0.npz", "0_1.npz"):
        with np.load(out / name) as got, np.load(jout / name) as want:
            assert sorted(got.files) == sorted(want.files) == sorted([*DUMP_DTYPES, "class_id"])
            for key, dtype in DUMP_DTYPES.items():
                assert got[key].dtype == want[key].dtype == dtype, key
            assert got["class_id"].dtype == want["class_id"].dtype
            assert int(got["class_id"]) == int(want["class_id"])
            n = len(got["masks"])
            assert n > 0 and got["masks"].shape == (n, SIZE, SIZE)
            assert got["merged"].shape == (SIZE, SIZE)
            assert all(got[k].shape == (n,) for k in ("iou", "stability", "emd"))
            assert set(np.unique(got["masks"])) <= {0, 1}
    assert res["live_proposals"] == [len(np.load(out / f"0_{i}.npz")["masks"]) for i in range(2)]


def _args(path, fold=0, bucket=16):
    return Namespace(mask_proposals_path=str(path), fold=fold, proposal_bucket=bucket)


def _same_bucket(path, idx, fold=0, bucket=16):
    want = jcli.load_proposals(_args(path, fold, bucket), idx, SIZE)
    got = tcli.load_proposals(_args(path, fold, bucket), idx, "cpu")
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.masks.dtype == torch.float32 and got.masks.shape == (bucket, SIZE, SIZE)
    return got


def test_load_proposals_matches_jax(port_dump):
    out, res = port_dump
    for idx in range(2):
        got = _same_bucket(out, idx)
        assert int(got.valid.sum()) == min(res["live_proposals"][idx], 16)


@pytest.mark.parametrize("fmt", ["npy", "npz", "pt"])
@pytest.mark.parametrize("n", [0, 5, 20])
def test_load_hand_made_stacks_matches_jax(tmp_path, fmt, n):
    """A stack of n masks as the reference's ``torch.load`` of ``.pt`` or
    as ``.npy``/``.npz``, padded (n < 16) or cut (n > 16) to the bucket."""
    masks = (np.random.RandomState(n).rand(n, SIZE, SIZE) > 0.7).astype(np.uint8)
    base = tmp_path / "2_3"
    if fmt == "npy":
        np.save(str(base) + ".npy", masks)
    elif fmt == "npz":
        np.savez_compressed(str(base) + ".npz", masks=masks)
    else:
        torch.save(torch.from_numpy(masks), str(base) + ".pt")
    got = _same_bucket(tmp_path, 3, fold=2)
    assert int(got.valid.sum()) == min(n, 16)


def test_load_proposals_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tcli.load_proposals(_args(tmp_path), 0, "cpu")


def test_cli_ranks_the_dumps(port_dump, capsys):
    """``cli.main --mask-proposals-path`` over the port's dumps, in float32
    and with bf16 towers: every dumped proposal live in the bucket, binary
    masks, no kernel launch on the CPU."""
    out, res = port_dump
    for extra in ([], ["--bf16"]):
        got = tcli.main(["--episodes", "2", "--gt-class-names", "--mask-proposals-path",
                         str(out), "--input-size", str(SIZE), "--proposal-bucket", "16",
                         "--device", "cpu", *extra], keep_masks=True)
        assert got["live_proposals"] == [min(n, 16) for n in res["live_proposals"]]
        assert got["masks_binary"] and len(got["episode_ms"]) == 2
        assert got["proposal_ms"] == []
        assert got["launches"] == {name: 0 for name in tcli.KERNELS}
        assert got["episode_launches"] == [got["launches"]] * 2
        assert [p.shape for p in got["masks"]] == [(SIZE, SIZE)] * 2
        assert got["episode_peak_gib"] == [None, None]  # measured on the card only
    assert "live proposals" in capsys.readouterr().out


def test_cli_missing_proposal_dir_raises(tmp_path):
    with pytest.raises(SystemExit, match="does not exist"):
        tcli.main(["--episodes", "1", "--gt-class-names", "--mask-proposals-path",
                   str(tmp_path / "absent"), "--device", "cpu"])


def test_cli_inline_proposals_bf16(tiny_port, monkeypatch):
    """``cli.main --bf16 --generate-proposals`` with both kernel switches on
    (their plain versions on the CPU): the Matcher's bucket ranked in the
    same run."""
    monkeypatch.setenv("MARS_ATTENTION_NOTAP_IMPL", "pallas")
    monkeypatch.setenv("MARS_SAM_WINDOWED_IMPL", "pallas")
    got = tcli.main(["--episodes", "1", "--gt-class-names", "--generate-proposals", "--bf16",
                     "--input-size", str(SIZE), "--proposal-bucket", "16", "--device", "cpu"])
    assert got["masks_binary"] and len(got["proposal_ms"]) == 1
    assert 0 < got["live_proposals"][0] <= 16
