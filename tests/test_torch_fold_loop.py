"""The port's fold loop (``mars_tpu_torch.cli.main``) against
``mars_tpu.cli.main``: the same synthetic episodes through a stand-in model
of the same contract on each side (a keyed stub VLM behind each package's
TextRetriever; a merged mask that hashes the episode's class name and
definition, so a text or episode mix-up shows in the meter).  Both run in
this one process, so the string hash agrees.

Held equal: the per-episode (name, definition) calls, ``scalars.csv``'s
mIoU rows, ``ranking_time.csv``'s idx and n_proposals, the final mIoU; and
within the port, ``--overlap-ranking`` N against 0, and an interrupted run
plus ``--resume`` against an uninterrupted one.
"""
import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu import cli as jcli
from mars_tpu.text.retriever import TextRetriever as JTextRetriever
from mars_tpu_torch import cli as tcli
from mars_tpu_torch.text.retriever import TextRetriever as TTextRetriever
from mars_tpu_torch.utils import tboard, visualize
from nltk_minicorpus import ensure_minicorpus

SIZE = 96
EPISODES = 5
ARGV = ["--benchmark", "synthetic", "--episodes", str(EPISODES), "--input-size", str(SIZE),
        "--seed", "3", "--resume-every", "2", "--resume"]


class _LoopVLM:
    """Deterministic keyed VLM: the same answer for the same query in any
    batch (tests/test_cli.py's)."""

    NAMES = ["dog", "plant", "sheep"]

    def _answer(self, image, prompt):
        if "definition" in prompt:
            name = next((n for n in self.NAMES if n in prompt), "thing")
            return f"a {name} is a kind of thing"
        return self.NAMES[int(image.sum()) % len(self.NAMES)]

    def generate(self, image, prompt, max_new_tokens=20, min_new_tokens=0):
        return self._answer(image, prompt)

    def generate_batch(self, images, prompts, max_new_tokens=20, min_new_tokens=0):
        return [self._answer(im, pr) for im, pr in zip(images, prompts)]


class _Interrupted(RuntimeError):
    pass


class _LoopModelBase:
    """The merged mask: a square sized by hash((name, definition)) and a
    band placed by the support mask's area; ``fail_at``: raise inside the
    Nth ranking (1-based)."""

    def __init__(self, fail_at=None):
        self.timings = {}
        self.calls = []
        self.fail_at = fail_at

    def _mask(self, ep, name, desc):
        self.calls.append((name, desc))
        if self.fail_at is not None and len(self.calls) >= self.fail_at:
            raise _Interrupted("interrupted")
        self.timings = {"total": 0.01, "after_text_extraction": 0.005}
        h = (hash((name, desc)) % 7) + 1
        pred = np.zeros((SIZE, SIZE), np.float32)
        pred[: 8 * h, : 8 * h] = 1.0
        s = int(np.asarray(self._host(ep.support_masks)).sum()) % SIZE
        pred[s: s + 4] = 1.0
        return pred

    def predict_debug(self, ep, props, class_name, class_description=""):
        merged = self._mask(ep, class_name, class_description)
        self.calls.pop()  # the figure's run is not an episode
        p = props.masks.shape[0]
        g = SIZE // 8
        rng = np.random.RandomState(0)
        return {"merged": merged, "scores": rng.rand(p).astype(np.float32),
                "vva_prior": rng.rand(g, g), "vta_prior": rng.rand(g, g),
                "ac_scores": rng.rand(p).astype(np.float32)}


class _JaxLoopModel(_LoopModelBase):
    def __init__(self, fail_at=None):
        super().__init__(fail_at)
        self.retriever = JTextRetriever(_LoopVLM())

    _host = staticmethod(np.asarray)

    def support_host_arrays(self, ep):
        imgs = np.asarray(jnp.clip(ep.support_images * 255, 0, 255).astype(jnp.uint8))
        masks = np.asarray(ep.support_masks)
        n = int(np.asarray(ep.support_valid).sum())
        return [imgs[i] for i in range(n)], [masks[i] for i in range(n)]

    def predict(self, ep, props, class_name=None, class_description=""):
        if class_name is None:
            class_name, class_description = self.retriever.get_conceptual_information(
                *self.support_host_arrays(ep))
        return self._mask(ep, class_name, class_description)

    def predict_launch(self, ep, props, class_name, class_description=""):
        return self._mask(ep, class_name, class_description)


class _TorchLoopModel(_LoopModelBase):
    def __init__(self, fail_at=None):
        super().__init__(fail_at)
        self.retriever = TTextRetriever(_LoopVLM())
        self.launched = 0

    @staticmethod
    def _host(t):
        return t.numpy()

    def support_host_arrays(self, ep):
        imgs = (ep.support_images * 255).clamp(0, 255).to(torch.uint8).numpy()
        masks = ep.support_masks.numpy()
        n = int(ep.support_valid.sum())
        return [imgs[i] for i in range(n)], [masks[i] for i in range(n)]

    def conceptual_information(self, ep):
        return self.retriever.get_conceptual_information(*self.support_host_arrays(ep))

    def predict(self, ep, props, class_name=None, class_description=""):
        if class_name is None:
            class_name, class_description = self.conceptual_information(ep)
        return torch.from_numpy(self._mask(ep, class_name, class_description))

    def predict_launch(self, ep, props, class_name, class_description=""):
        self.launched += 1
        return torch.from_numpy(self._mask(ep, class_name, class_description))


@pytest.fixture(scope="module")
def nltk_root(tmp_path_factory):
    return ensure_minicorpus(str(tmp_path_factory.mktemp("nltk")))


def run_jax(monkeypatch, log, extra, fail_at=None):
    model = _JaxLoopModel(fail_at)
    monkeypatch.setattr(jcli, "build_model", lambda args: model)
    return jcli.main(ARGV + ["--log-path", str(log)] + extra), model


def run_port(monkeypatch, log, extra, nltk_root, fail_at=None):
    model = _TorchLoopModel(fail_at)
    monkeypatch.setattr(tcli, "build_model", lambda args, device: model)
    res = tcli.main(ARGV + ["--log-path", str(log), "--device", "cpu", "--nltk-path", nltk_root]
                    + extra)
    return res, model


def scalar_rows(log, tag="test_mIoU"):
    """scalars.csv's rows of ``tag``: {step: value}, a resumed run's
    repeated steps taking the later value, as a TensorBoard reader does."""
    with open(os.path.join(log, "scalars.csv")) as f:
        return {int(r[0]): float(r[2]) for r in csv.reader(f) if r[1] == tag}


def timing_rows(log):
    with open(os.path.join(log, "ranking_time.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["idx", "total_s", "after_text_s", "n_proposals"]
    return [(int(r[0]), int(r[3])) for r in rows[1:]]


TEXT_MODES = {"gt_names": ["--gt-class-names"], "text_block_1": ["--text-block", "1"],
              "text_block_2": ["--text-block", "2"], "pipelined": ["--pipelined-text"]}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """mars_tpu.cli.main at each text mode, synchronous."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for mode, extra in TEXT_MODES.items():
            log = tmp_path_factory.mktemp(f"jax_{mode}")
            (miou, fb), model = run_jax(mp, log, extra + ["--overlap-ranking", "0"])
            out[mode] = {"miou": miou, "fb": fb, "calls": model.calls, "log": str(log)}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("mode", list(TEXT_MODES))
def test_loop_equals_jax(mode, jax_runs, monkeypatch, tmp_path, nltk_root):
    want = jax_runs[mode]
    res, model = run_port(monkeypatch, tmp_path, TEXT_MODES[mode] + ["--overlap-ranking", "0"],
                          nltk_root)
    assert model.calls == want["calls"]
    assert res["miou"] == want["miou"] and res["fb_iou"] == want["fb"]
    assert scalar_rows(tmp_path) == scalar_rows(want["log"])
    assert scalar_rows(tmp_path, "test_FB-IoU") == scalar_rows(want["log"], "test_FB-IoU")
    assert timing_rows(tmp_path) == timing_rows(want["log"])
    assert [i for i, _ in timing_rows(tmp_path)] == list(range(EPISODES))
    assert not os.path.exists(tmp_path / "resume.pkl")  # removed once the fold completes
    assert os.path.exists(tmp_path / "log.txt") and model.launched == 0


@pytest.mark.parametrize("mode", ["gt_names", "text_block_2"])
def test_overlap_ranking_equals_synchronous(mode, jax_runs, monkeypatch, tmp_path, nltk_root):
    res, model = run_port(monkeypatch, tmp_path, TEXT_MODES[mode] + ["--overlap-ranking", "3"],
                          nltk_root)
    want = jax_runs[mode]
    assert model.launched == EPISODES and model.calls == want["calls"]
    assert res["miou"] == want["miou"]
    assert scalar_rows(tmp_path) == scalar_rows(want["log"])
    assert timing_rows(tmp_path) == timing_rows(want["log"])


@pytest.mark.parametrize("mode", ["text_block_1", "text_block_2", "pipelined"])
def test_interrupt_then_resume_equals_uninterrupted(mode, jax_runs, monkeypatch, tmp_path,
                                                    nltk_root):
    """A crash inside the 3rd ranking of a synchronous run; the snapshot
    of the episode-2 boundary (--resume-every 2) replays the rest exactly,
    here with the default ranking window."""
    with pytest.raises(_Interrupted):
        run_port(monkeypatch, tmp_path, TEXT_MODES[mode] + ["--overlap-ranking", "0"],
                 nltk_root, fail_at=3)
    assert os.path.exists(tmp_path / "resume.pkl")
    res, model = run_port(monkeypatch, tmp_path, TEXT_MODES[mode], nltk_root)
    want = jax_runs[mode]
    assert res["first_idx"] == 2 and model.calls == want["calls"][2:]
    assert res["miou"] == want["miou"] and res["fb_iou"] == want["fb"]
    assert scalar_rows(tmp_path) == scalar_rows(want["log"])
    assert timing_rows(tmp_path) == timing_rows(want["log"])
    assert not os.path.exists(tmp_path / "resume.pkl")


def _event_payloads(log):
    runs = os.path.join(log, "tbd", "runs")
    (name,) = os.listdir(runs)
    return tboard.read_records(os.path.join(runs, name))  # every record passes its CRCs


def test_known_bad_subset_and_exp_name(monkeypatch, tmp_path, nltk_root):
    bad = tmp_path / "bad.txt"
    bad.write_text("1\n3\n")
    extra = ["--gt-class-names", "--bad-preds-path", str(bad), "--exp-name", "fold0"]
    (jm, _), _ = run_jax(monkeypatch, tmp_path / "jax", extra)
    res, _ = run_port(monkeypatch, tmp_path / "port", extra, nltk_root)
    assert res["log_path"] == str(tmp_path / "port" / "fold0") and res["miou"] == jm
    logs = [(tmp_path / side / "fold0" / "log.txt").read_text() for side in ("jax", "port")]
    lines = [[ln.split(" ", 2)[2] for ln in log.splitlines() if "known-bad subset" in ln]
             for log in logs]
    assert len(lines[0]) == 1 and lines[0] == lines[1], lines
    jrec, trec = (_event_payloads(tmp_path / side / "fold0") for side in ("jax", "port"))
    assert len(jrec) == len(trec)
    assert sum(b"bad_preds_mIoU" in r for r in trec) == 1
    # the known-bad subset's classes, each with its own record
    assert sum(b"_mIoU" in r and b"class" in r for r in trec) == \
        sum(b"_mIoU" in r and b"class" in r for r in jrec) > 0


class _Empty:
    benchmark = "synthetic"
    class_ids = list(range(16))

    def __len__(self):
        return 0


def test_zero_episode_run(monkeypatch, tmp_path, nltk_root):
    """An empty fold: no episode, an empty ranking_time.csv, mIoU 0, as JAX."""
    monkeypatch.setattr(jcli, "build_dataset", lambda *a, **k: _Empty())
    monkeypatch.setattr(tcli, "dataset", lambda args: _Empty())
    extra = ["--gt-class-names", "--episodes", "0"]
    want, _ = run_jax(monkeypatch, tmp_path / "jax", extra)
    res, model = run_port(monkeypatch, tmp_path / "port", extra, nltk_root)
    assert want == (0.0, 0.0) and (res["miou"], res["fb_iou"]) == want and model.calls == []
    assert timing_rows(tmp_path / "port") == timing_rows(tmp_path / "jax") == []
    assert "no episodes to run" in (tmp_path / "port" / "log.txt").read_text()


def test_visualize_writes_decodable_figures(jax_runs, monkeypatch, tmp_path, nltk_root):
    """--visualize 2: ep00000.png and ep00001.png under <log-path>/viz, as
    JAX names them; the meter trace unchanged."""
    res, model = run_port(monkeypatch, tmp_path, ["--text-block", "1", "--visualize", "2"],
                          nltk_root)
    want = jax_runs["text_block_1"]
    assert model.calls == want["calls"] and res["miou"] == want["miou"]
    assert scalar_rows(tmp_path) == scalar_rows(want["log"])
    files = sorted(os.listdir(tmp_path / "viz"))
    assert files == ["ep00000.png", "ep00001.png"]
    for f in files:
        rgb, text = visualize.read_png(str(tmp_path / "viz" / f))
        assert rgb.ndim == 3 and rgb.shape[2] == 3 and text["Title"].startswith("episode")
        names = __import__("json").loads(text["Panels"])
        assert names[:4] == ["support", "query + points", "VVA prior", "VTA prior"]
        assert names[-2:] == ["merged", "gt"]


@pytest.mark.parametrize("shots,size,grid", [(1, 518, 37), (5, 518, 37), (2, 112, 8),
                                             (1, 100, 7), (3, 96, 37)])
def test_host_footprint_count_equals_the_device_one(shots, size, grid):
    """The ranking reads EMD's live support rows from the host masks
    (``Mars._support_rows``): the same count as the device footprint, on
    torch's adaptive windows whether or not they divide the size."""
    from mars_tpu_torch.core import imaging
    from mars_tpu_torch.ops import emd

    rng = np.random.RandomState(size + shots)
    masks = np.zeros((shots, size, size), np.uint8)
    for s in range(shots):
        y, x = rng.randint(0, size // 2, 2)
        masks[s, y:y + rng.randint(1, size // 2), x:x + rng.randint(1, size // 2)] = 1
    masks[0, -1, -1] = 1  # a lone pixel in the last window
    valid = np.arange(shots) < max(1, shots - 1)
    host = imaging.pooled_footprint_host(masks, grid) & valid[:, None, None]
    dev = (imaging.pool_mask_to_grid(torch.from_numpy(masks).float(), grid) > 0) \
        & torch.from_numpy(valid)[:, None, None]
    np.testing.assert_array_equal(host, dev.numpy())
    fg = dev.reshape(-1)
    cost = torch.from_numpy(rng.rand(fg.numel(), grid * grid).astype(np.float32))
    cols = torch.from_numpy(rng.rand(16, grid * grid) > 0.7)
    col_valid = torch.arange(16) < 5
    want = emd.batched_emd(cost, fg, cols, 256, 64, col_valid=col_valid,
                           iters_schedule=(2, 2, 2, 2))
    got = emd.batched_emd(cost, fg, cols, 256, 64, col_valid=col_valid, n_valid=5,
                          n_rows=int(host.sum()), iters_schedule=(2, 2, 2, 2))
    assert torch.equal(got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_snapshot_keys_and_streams(writer, tmp_path):
    """A snapshot (the port's, or the JAX CLI's: the same keys) restores the
    meter, the timing rows and both host RNG streams exactly."""
    from mars_tpu.utils import evaluation as jeval
    from mars_tpu_torch.utils import evaluation as teval

    class _DS:
        def __init__(self, seed):
            self.rng = np.random.RandomState(seed)

    path = str(tmp_path / "resume.pkl")
    meter = (teval if writer == "port" else jeval).AverageMeter("synthetic", [0, 1, 2])
    meter.update(np.array([1.0, 2.0]), np.array([3.0, 4.0]), 1)
    meter.update_bad_preds(np.array([1.0, 1.0]), np.array([2.0, 2.0]), 2)
    rng, ds = np.random.RandomState(0), _DS(7)
    rng.rand(5), ds.rng.rand(3)
    snap = (tcli if writer == "port" else jcli).capture_rng_states(rng, ds)
    want_next, want_ds_next = rng.rand(4), ds.rng.rand(4)
    (tcli if writer == "port" else jcli).save_resume_state(path, 41, meter, [[0, 1.0, 0.9, 7]],
                                                           snap)
    assert not os.path.exists(path + ".tmp")
    meter2 = teval.AverageMeter("synthetic", [0, 1, 2])
    rng2, ds2 = np.random.RandomState(99), _DS(99)
    st = tcli.load_resume_state(path, meter2, rng2, ds2)
    assert st["next_idx"] == 41 and st["timing_rows"] == [[0, 1.0, 0.9, 7]]
    for k in ("inter", "union", "inter_bad", "union_bad"):
        np.testing.assert_array_equal(getattr(meter2, k), getattr(meter, k))
    assert meter2.bad_class_ids == [2]
    np.testing.assert_array_equal(rng2.rand(4), want_next)
    np.testing.assert_array_equal(ds2.rng.rand(4), want_ds_next)
