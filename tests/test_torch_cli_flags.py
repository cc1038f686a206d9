"""The port's evaluation flags against mars_tpu.cli: spellings, defaults,
choices, and how they reach the stage configs and the towers."""
import argparse
import os
import re
import shlex

import numpy as np
import pytest

from mars_tpu import cli as jcli, cli_proposals as jcli_proposals
from mars_tpu.models import dinov2 as jdino
from mars_tpu_torch import cli as tcli
from mars_tpu_torch import cli_proposals as tcli_proposals
from mars_tpu_torch.pipeline import matcher as tmatcher
from test_torch_cli_proposals import SIZE, tiny_port, trees  # noqa: F401  (fixtures)

# the flags this port gives meaning to (mars_tpu/cli.py:385-535)
PORTED = ["benchmark", "datapath", "annotations_datapath", "models_path", "nshot", "fold",
          "input_size", "episodes", "proposal_bucket", "gt_class_names", "generate_proposals",
          "sam_size", "mask_proposals_path", "bf16", "seed", "vta_backbone",
          "vta_refinement_box_threshold", "last_n_attn_for_vta_refinement", "vva_backbone",
          "dino_backbone", "num_regs", "vva_refinement_box_threshold",
          "last_n_attn_for_vva_refinement", "static_threshold", "dynamic_threshold",
          "alpha_coverage",
          # the text path (mars_tpu/cli.py:398-499)
          "nltk_path", "prompt_type", "zoom_percentage", "color", "alpha_blending", "thickness",
          "ensemble_prompts", "ensemble_prompts_list", "ensemble_zoom", "ensemble_zoom_list",
          "ensemble_colors", "ensemble_colors_list", "vlm4bit", "vlm4bit_nf4", "vlm8bit",
          "vlm_kv8", "vlm_draft_tokens", "pipelined_text", "text_block", "vlm_path", "jax_vlm",
          # the fold's bookkeeping (mars_tpu/cli.py:464-525)
          "overlap_ranking", "log_path", "exp_name", "visualize", "bad_preds_path", "resume",
          "resume_every",
          # the Matcher's flow (parsed, no effect: the port runs one flow) and the
          # tower quantization (mars_tpu/cli.py:405-410,527-534)
          "fused_proposals", "int8_towers", "w8a8_alphaclip",
          # the Matcher's backend (mars_tpu/cli.py:500-504)
          "proposal_model"]
# the JAX CLI's flags the port does not take yet (ROADMAP Queue 1)
NOT_PORTED = []
# the flags cli_proposals shares with it (mars_tpu/cli_proposals.py:30-57)
PROPOSAL_FLAGS = ["benchmark", "datapath", "models_path", "fold", "nshot", "input_size",
                  "episodes", "sam_size", "dino_backbone", "num_regs", "bf16", "seed"]
# and its own (mars_tpu/cli_proposals.py:41-55)
PROPOSAL_ONLY = ["use_centers", "out", "coco_rle", "visualize"]
EVAL_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "scripts", "_eval_common.sh")


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


def test_every_jax_flag_is_ported_or_listed():
    jax_dests = {a.dest for a in _jax_parser()._actions} - {"help"}
    port_dests = {a.dest for a in _port_parser(tcli.parse_args, [])._actions} - {"help"}
    assert jax_dests - set(NOT_PORTED) <= set(PORTED) <= port_dests
    assert not set(NOT_PORTED) & port_dests


class _Caught(Exception):
    pass


def _jax_proposals_parser():
    """The parser ``mars_tpu.cli_proposals.main`` builds, caught before it
    runs anything."""
    caught = {}

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Caught

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        jcli_proposals.main(["--out", "x"])
    except _Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["parser"]


@pytest.mark.parametrize("dest", PROPOSAL_ONLY)
def test_cli_proposals_own_flags(dest):
    want = _actions(_jax_proposals_parser())[dest]
    got = _actions(_port_parser(tcli_proposals.parse_args, ["--out", "x"]))[dest]
    assert got.option_strings == want.option_strings and got.required == want.required
    assert got.default == want.default and got.type == want.type
    assert type(got) is type(want)  # store_true stays store_true
    assert {a.dest for a in _jax_proposals_parser()._actions} - {"help"} \
        <= set(PROPOSAL_FLAGS + PROPOSAL_ONLY)


def _eval_common_argv(proposal_args):
    """The ``python -m mars_tpu.cli`` command of scripts/_eval_common.sh,
    its variables filled with values a caller sets."""
    with open(EVAL_SCRIPT) as f:
        text = f.read()
    cmd = text.split("python -m mars_tpu.cli \\\n", 1)[1].split("${EXTRA_ARGS}", 1)[0]
    cmd = cmd.replace("\\\n", " ")
    cmd = cmd.replace('${NLTK_PATH:+--nltk-path "${NLTK_PATH}"}', '--nltk-path "/nltk"')
    cmd = cmd.replace('"${PROPOSAL_ARGS[@]}"', proposal_args)
    values = {"DATAPATH": "/data", "BENCHMARK": "coco", "NSHOT": "1", "fold": "0",
              "MODELS_PATH": "/models", "LOG_ROOT": "output/mars/coco"}
    cmd = re.sub(r"\$\{(\w+)\}", lambda m: values[m.group(1)], cmd)
    assert "$" not in cmd, cmd
    return shlex.split(cmd)


@pytest.mark.parametrize("proposal_args", ["--mask-proposals-path /props",
                                           "--generate-proposals"])
def test_eval_script_flags_parse(proposal_args):
    """Every flag the shipped evaluation passes (read from the script, so
    the test follows it) parses, to the values the JAX CLI parses them to."""
    argv = _eval_common_argv(proposal_args)
    assert "--log-path" in argv and "--exp-name" in argv and "--bf16" in argv
    targs, jargs = tcli.parse_args(argv), _jax_parser().parse_args(argv)
    flags = {a.split("=")[0] for a in argv if a.startswith("--")}
    dests = {a.dest: a for a in _port_parser(tcli.parse_args, [])._actions}
    for flag in flags:
        dest = next(d for d, a in dests.items() if flag in a.option_strings)
        assert getattr(targs, dest) == getattr(jargs, dest), flag
    assert (targs.log_path, targs.exp_name) == ("output/mars/coco/fold0", "1shot")


def test_cli_proposals_two_program_dumps_equal_union_flow(tiny_port, tmp_path, monkeypatch):
    """The two-program evaluation's first program (cli_proposals) runs the
    Matcher's one flow over the union of both prompt families (the JAX CLI
    runs its two-program flow there, whose live rows are the same); every
    array of its dumps equals that flow's output, live rows in order."""
    outs = []
    real = tmatcher.generate_proposals

    def record(*a, **k):
        outs.append(real(*a, **k))
        return outs[-1]

    monkeypatch.setattr(tcli_proposals.matcher, "generate_proposals", record)
    res = tcli_proposals.main(["--episodes", "2", "--input-size", str(SIZE), "--sam-size",
                               "vit_b", "--device", "cpu", "--out", str(tmp_path / "p")])
    assert len(outs) == 2 and sum(res["live_proposals"]) > 0
    rows = len(tmatcher.union_family_rows(tmatcher.MatcherConfig()))
    for path, out in zip(res["files"], outs):
        valid = out["proposal_valid"].numpy()
        assert valid.shape == (3 * rows,)  # sel_output_layer 3: three mask slots a set
        want = {"masks": out["proposal_masks"].numpy()[valid].astype(np.uint8),
                "iou": out["iou"].numpy()[valid], "stability": out["stability"].numpy()[valid],
                "emd": out["emd_score"].numpy()[valid],
                "merged": out["merged"].numpy().astype(np.uint8)}
        with np.load(path) as got:
            for key, value in want.items():
                np.testing.assert_array_equal(got[key], value, err_msg=key)

