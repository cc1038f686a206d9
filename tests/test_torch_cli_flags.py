"""The port's evaluation flags against mars_tpu.cli: spellings, defaults,
choices, and how they reach the stage configs and the towers."""
import argparse

import pytest

from mars_tpu import cli as jcli
from mars_tpu.models import dinov2 as jdino
from mars_tpu_torch import cli as tcli
from mars_tpu_torch import cli_proposals as tcli_proposals

# the flags this port gives meaning to (mars_tpu/cli.py:385-535)
PORTED = ["benchmark", "datapath", "annotations_datapath", "models_path", "nshot", "fold",
          "input_size", "episodes", "proposal_bucket", "gt_class_names", "generate_proposals",
          "sam_size", "mask_proposals_path", "bf16", "seed", "vta_backbone",
          "vta_refinement_box_threshold", "last_n_attn_for_vta_refinement", "vva_backbone",
          "dino_backbone", "num_regs", "vva_refinement_box_threshold",
          "last_n_attn_for_vva_refinement", "static_threshold", "dynamic_threshold",
          "alpha_coverage"]
# the flags cli_proposals shares with it (mars_tpu/cli_proposals.py:30-57)
PROPOSAL_FLAGS = ["benchmark", "datapath", "models_path", "fold", "nshot", "input_size",
                  "episodes", "sam_size", "dino_backbone", "num_regs", "bf16", "seed"]


def _jax_parser():
    p = argparse.ArgumentParser()
    jcli.add_eval_args(p)
    return p


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def _port_parser(fn, argv):
    """The parser ``fn`` builds, caught at its parse_args call."""
    caught = {}

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        return real(self, args, namespace)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        fn(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["parser"]


@pytest.mark.parametrize("dest", PORTED)
def test_flag_has_jax_spelling_default_and_choices(dest):
    want = _actions(_jax_parser())[dest]
    got = _actions(_port_parser(tcli.parse_args, []))[dest]
    assert got.option_strings == want.option_strings
    assert got.default == want.default and got.type == want.type
    if want.choices is not None:
        assert list(got.choices) == list(want.choices)
    elif dest == "dino_backbone":  # JAX's cli_proposals spells out its variants; cli does not
        assert list(got.choices) == list(jdino.DINOV2_VARIANTS)
    else:
        assert got.choices is None


@pytest.mark.parametrize("dest", PROPOSAL_FLAGS)
def test_cli_proposals_flag_defaults(dest):
    want = _jax_parser().parse_args([])
    got = tcli_proposals.parse_args(["--out", "x"])
    assert getattr(got, dest) == getattr(want, dest)
    assert _actions(_port_parser(tcli_proposals.parse_args, ["--out", "x"]))[dest] \
        .option_strings == _actions(_jax_parser())[dest].option_strings


def _both(argv):
    return tcli.parse_args(argv), _jax_parser().parse_args(argv)


def test_tuning_flags_reach_configs():
    argv = ["--vva-refinement-box-threshold", "0.7", "--last-n-attn-for-vva-refinement", "12",
            "--vta-refinement-box-threshold", "0.3", "--last-n-attn-for-vta-refinement", "4",
            "--static-threshold", "0.6", "--dynamic-threshold", "0.9", "--alpha-coverage", "0.8"]
    targs, jargs = _both(argv)
    cfg, jcfg = tcli.build_mars_config(targs), jcli.build_mars_config(jargs)
    assert cfg.vva.refinement_box_threshold == 0.7 and cfg.vva.attn_tap_last_n == 12
    assert cfg.vta.refinement_box_threshold == 0.3 and cfg.vta.attn_tap_last_n == 4
    assert cfg.filter_merge.static_threshold == 0.6
    assert cfg.filter_merge.dynamic_threshold == 0.9 and cfg.filter_merge.alpha == 0.8
    for stage in ("vva", "vta", "filter_merge"):
        got, want = getattr(cfg, stage).__dict__, getattr(jcfg, stage).__dict__
        assert got == {k: want[k] for k in got}, stage


@pytest.mark.parametrize("backbone,size,in_size,grid,g", [
    ("ViT-B/16", 518, 528, 33, 37),   # ceil(518/16)*16 (VisualTextAlignmentModule:86-87)
    ("ViT-L/14", 518, 518, 37, 37),
    ("ViT-B/16", 1190, 1200, 75, 85),
    ("ViT-L/14", 112, 112, 8, 8),
])
def test_vta_backbone_geometry(backbone, size, in_size, grid, g):
    targs, jargs = _both(["--vta-backbone", backbone, "--input-size", str(size)])
    cfg, jcfg = tcli.build_mars_config(targs), jcli.build_mars_config(jargs)
    assert (cfg.vta.input_size, cfg.vta.grid) == (in_size, grid)
    assert (jcfg.vta.input_size, jcfg.vta.grid) == (in_size, grid)
    assert cfg.vva.grid == cfg.filter_merge.grid == g == jcfg.vva.grid


@pytest.mark.parametrize("backbone", ["ViT-B/16", "ViT-L/14"])
def test_vva_backbone_other_than_dino_raises(backbone):
    with pytest.raises(SystemExit, match="only 'dino'"):
        tcli.build_model(tcli.parse_args(["--vva-backbone", backbone]), "cpu")


def test_annotations_datapath_is_coco_only():
    args = tcli.parse_args(["--benchmark", "fss", "--annotations-datapath", "/x"])
    with pytest.raises(SystemExit, match="only applies to --benchmark coco"):
        tcli.dataset(args)


@pytest.mark.parametrize("argv", [["--nshot", "3"], ["--dino-backbone", "vit_huge"],
                                  ["--benchmark", "imagenet"], ["--vta-backbone", "RN50"]])
def test_unknown_choice_is_refused(argv):
    with pytest.raises(SystemExit):
        tcli.parse_args(argv)


def test_backbone_flags_reach_the_zoo(monkeypatch):
    """--models-path, --dino-backbone, --num-regs and --vta-backbone are
    what the zoo's build functions receive."""
    seen = {}

    def record(name):
        def fn(*a, **k):
            seen[name] = (a, {key: v for key, v in k.items() if key != "device"})
            raise StopIteration  # enough: the arguments are recorded
        return fn

    monkeypatch.setattr(tcli.zoo, "build_dinov2", record("dinov2"))
    with pytest.raises(StopIteration):
        tcli.build_model(tcli.parse_args(["--models-path", "/m", "--dino-backbone",
                                          "vit_giant2", "--num-regs", "0"]), "cpu")
    assert seen["dinov2"][0] == ("/m", "vit_giant2", 0)
    monkeypatch.setattr(tcli.zoo, "build_dinov2", lambda *a, **k: None)
    monkeypatch.setattr(tcli.zoo, "build_clip", record("clip"))
    with pytest.raises(StopIteration):
        tcli.build_model(tcli.parse_args(["--models-path", "/m", "--vta-backbone", "ViT-L/14"]),
                         "cpu")
    assert seen["clip"][0] == ("/m", "ViT-L/14")
