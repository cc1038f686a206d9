"""The port's episode-parallel driver (``cli_parallel``) against the port's
serial loop: the meter, the masks, resume, the text stage, and ``main``
against ``cli.main``."""
import csv
import os

import numpy as np
import pytest
import torch

import torch_tiny
from torch_tiny import one_torch_thread  # noqa: F401  (autouse fixture)
from nltk_minicorpus import ensure_minicorpus
from mars_tpu_torch import cli as tcli, cli_parallel
from mars_tpu_torch.data.base import episode_from_host, episode_host_u8, resized_gt
from mars_tpu_torch.parallel import mesh as mesh_lib
from mars_tpu_torch.text import wordnet
from mars_tpu_torch.text.retriever import BlockTextStage, TextRetriever
from mars_tpu_torch.utils import evaluation
from test_torch_cli_proposals import SIZE as CLI_SIZE, tiny_port, trees  # noqa: F401 (fixtures)

N, BUCKET = 10, 4


class _StubVLM:
    """A VLM stand-in: the name follows the image's content, the definition
    restates the name (``tests/test_cli_parallel.py``'s)."""

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


@pytest.fixture(scope="module")
def towers():
    trees = torch_tiny.jax_trees(0)
    return trees, torch_tiny.port_mars(trees)


@pytest.fixture(scope="module")
def serial(towers, tmp_path_factory):
    """The serial loop (``cli.main``'s episode path) over N episodes:
    meter, masks, and with a stub VLM the (name, definition) stream
    (WordNet on tests/nltk_minicorpus.py's tree)."""
    wordnet.add_path(ensure_minicorpus(str(tmp_path_factory.mktemp("nltk"))))
    model = towers[1]
    retriever = TextRetriever(_StubVLM())
    ds, fn = torch_tiny.dataset(N), torch_tiny.props_fn(torch_tiny.SIZE, BUCKET,
                                                        np.random.RandomState(0))
    meter, masks, pairs = tcli.fold_meter(ds), [], []
    for idx in range(N):
        rec = ds[idx]
        ep = episode_from_host(episode_host_u8(rec, torch_tiny.SIZE, 1), rec.class_id, "cpu")
        pred = model.predict(ep, fn(idx, rec), class_name=rec.class_name).numpy()
        masks.append(pred > 0.5)
        gt, ig = resized_gt(rec, torch_tiny.SIZE)
        meter.update(*evaluation.classify_prediction(pred, gt, ig), rec.class_id)
        pairs.append(retriever.get_conceptual_information(*model.support_host_arrays(ep)))
    return meter, np.stack(masks), pairs


@pytest.fixture
def one_rank(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    mesh = mesh_lib.make_mesh(device="cpu")
    yield mesh
    mesh.close()


def _same_meter(meter, want):
    np.testing.assert_array_equal(meter.inter, want.inter)
    np.testing.assert_array_equal(meter.union, want.union)


def test_meter_trace_matches_serial_at_one_rank(towers, serial, one_rank):
    """Ten episodes at local batch 4: batches of 4, 4 and 2 (+ 2 pad rows)."""
    meter, masks, times = torch_tiny.evaluate(one_rank, towers[1], N, 4)
    _same_meter(meter, serial[0])
    np.testing.assert_array_equal(masks, serial[1])
    assert len(times) == 3 and meter.compute_iou()[:2] == serial[0].compute_iou()[:2]


@pytest.fixture(scope="module")
def two_ranks(towers, tmp_path_factory):
    """Each rank's (inter, union, masks, batches) at mesh 2 x 1 and 1 x 2
    (``torch_tiny.cli_parallel_worker``), from one spawn."""
    return torch_tiny.run_ranks(torch_tiny.cli_parallel_worker, 2,
                                tmp_path_factory.mktemp("ranks"), {"trees": towers[0], "n": N})


def test_meter_trace_matches_serial_at_two_ranks(serial, two_ranks):
    """Mesh 2 x 1 and 1 x 2 (tensor-parallel towers) on two gloo ranks:
    every rank's meter and masks equal the serial loop's."""
    for out in two_ranks:
        for shape, (inter, union, masks, n_batches) in out.items():
            np.testing.assert_array_equal(inter, serial[0].inter, err_msg=str(shape))
            np.testing.assert_array_equal(union, serial[0].union, err_msg=str(shape))
            np.testing.assert_array_equal(masks, serial[1], err_msg=str(shape))
            assert n_batches == 3


def test_meter_trace_matches_jax_evaluate_parallel(towers, two_ranks, monkeypatch):
    """The JAX package's ``evaluate_parallel`` on a (2, 1) and a (1, 2) JAX
    mesh (its towers sharded by ``shard_params`` on the second) over the
    same trees, episodes and stand-in proposals: meter and merged masks
    equal to every port rank's at the same mesh and local batch."""
    import jax.numpy as jnp

    from mars_tpu import cli_parallel as jcli_parallel
    from mars_tpu.core.episode import pad_proposals as jpad
    from mars_tpu.data import build_dataset as jbuild
    from mars_tpu.parallel import mesh as jmesh
    from mars_tpu.utils import evaluation as jevaluation

    size = torch_tiny.SIZE
    preds = []
    real = jevaluation.classify_prediction
    monkeypatch.setattr(jevaluation, "classify_prediction",
                        lambda pred, gt, ig: (preds.append(np.asarray(pred) > 0.5),
                                              real(pred, gt, ig))[1])

    def props_fn(rng):
        fn = torch_tiny.props_fn(size, BUCKET, rng)

        def jfn(idx, rec):
            p = fn(idx, rec)
            return jpad(jnp.asarray(p.masks.numpy()), BUCKET, valid=jnp.asarray(p.valid.numpy()))

        return jfn

    for shape, lb in (((2, 1), 2), ((1, 2), 4)):
        mesh = jmesh.make_mesh(*shape)
        model = torch_tiny.jax_mars(towers[0])
        if shape[1] > 1:
            for name in ("dino_params", "clip_v", "ac_v"):
                setattr(model, name, jmesh.shard_params(getattr(model, name), mesh))
        preds.clear()
        _, _, meter, times = jcli_parallel.evaluate_parallel(
            model, jbuild("synthetic", shot=1, size=size, num_episodes=N), mesh,
            input_size=size, episodes=N, proposal_bucket=BUCKET,
            props_fn=props_fn(np.random.RandomState(0)), local_batch=lb, log=lambda *a: None)
        assert len(times) == 3 and len(preds) == N
        for out in two_ranks:
            inter, union, masks, _ = out[shape]
            np.testing.assert_array_equal(inter, meter.inter, err_msg=str(shape))
            np.testing.assert_array_equal(union, meter.union, err_msg=str(shape))
            np.testing.assert_array_equal(masks, np.stack(preds), err_msg=str(shape))


def test_interrupt_and_resume_bitexact(towers, serial, one_rank, tmp_path):
    """Stopped after two batches with a snapshot, resumed from it with fresh
    dataset and RNG objects: the meter equals the uninterrupted run's."""
    model = towers[1]
    path = str(tmp_path / "resume.pkl")
    ds1, rng1 = torch_tiny.dataset(N), np.random.RandomState(0)
    cli_parallel.evaluate_parallel(
        model, ds1, one_rank, input_size=torch_tiny.SIZE, episodes=8, proposal_bucket=BUCKET,
        props_fn=torch_tiny.props_fn(torch_tiny.SIZE, BUCKET, rng1), local_batch=4,
        log=lambda *a: None, snapshot=lambda nxt, m: tcli.save_resume_state(
            path, nxt, m, [], tcli.capture_rng_states(rng1, ds1)))
    ds2, rng2 = torch_tiny.dataset(N), np.random.RandomState(7)
    meter = tcli.fold_meter(ds2)
    assert int(tcli.load_resume_state(path, meter, rng2, ds2)["next_idx"]) == 8
    masks = []
    _, _, meter, _ = cli_parallel.evaluate_parallel(
        model, ds2, one_rank, input_size=torch_tiny.SIZE, episodes=N, proposal_bucket=BUCKET,
        props_fn=torch_tiny.props_fn(torch_tiny.SIZE, BUCKET, rng2), local_batch=4,
        log=lambda *a: None, meter=meter, start_idx=8, masks=masks)
    _same_meter(meter, serial[0])
    np.testing.assert_array_equal(np.stack(masks), serial[1][8:])
    with pytest.raises(ValueError, match="not aligned"):
        cli_parallel.evaluate_parallel(model, ds2, one_rank, input_size=torch_tiny.SIZE,
                                       episodes=N, local_batch=4, start_idx=6)


def test_text_stage_matches_serial(towers, serial, one_rank):
    """The batch as the text block (a stub VLM): the (name, definition)
    stream equals the serial retriever's, and the meter the serial
    predict loop's with those names."""
    model = towers[1]

    class _Recording(BlockTextStage):
        pairs = []

        def step(self, *a):
            r = super().step(*a)
            self.pairs += r
            return r

        def flush(self):
            r = super().flush()
            self.pairs += r
            return r

    stage = _Recording(TextRetriever(_StubVLM()), depth=4)
    names = {}
    real = model._vta_text_feats
    model._vta_text_feats = lambda name: (names.setdefault(name, 0), real(name))[1]
    try:
        torch_tiny.evaluate(one_rank, model, N, 4, text_stage=stage)
    finally:
        del model._vta_text_feats
    assert stage.pairs == serial[2] and len({p[0] for p in serial[2]}) > 1
    assert set(names) == {p[0] for p in serial[2]}


ARGS = ["--episodes", "5", "--gt-class-names", "--input-size", str(CLI_SIZE),
        "--proposal-bucket", "16", "--device", "cpu"]


def test_main_matches_cli_main(tiny_port, tmp_path, monkeypatch):
    """``cli_parallel.main`` at one rank and local batch 2 against
    ``cli.main``: synthetic proposals over five episodes, then the
    Matcher's over two; masks equal; batch_time.csv; with --resume-every 3
    a snapshot at the first batch boundary after every third episode;
    semantic-sam with --generate-proposals refused."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    snapshots = []
    real_save = tcli.save_resume_state
    monkeypatch.setattr(tcli, "save_resume_state",
                        lambda path, nxt, *a: (snapshots.append(nxt), real_save(path, nxt, *a)))
    for extra, n_batches, snaps in (([], 3, [4]),
                                    (["--generate-proposals", "--episodes", "2"], 1, [])):
        want = tcli.main(ARGS + extra + ["--log-path", str(tmp_path / "serial")],
                         keep_masks=True)
        log = tmp_path / "parallel"
        snapshots.clear()
        got = cli_parallel.main(ARGS + extra + ["--log-path", str(log), "--local-batch", "2",
                                                "--resume-every", "3"], keep_masks=True)
        assert snapshots == snaps
        assert not torch.distributed.is_initialized()
        assert got["mesh"] == {"data": 1, "model": 1} and len(got["masks"]) == len(want["masks"])
        for g, w in zip(got["masks"], want["masks"]):
            np.testing.assert_array_equal(g, w)
        assert (got["miou"], got["fb_iou"]) == (want["miou"], want["fb_iou"])
        with open(log / "batch_time.csv") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["batch", "seconds"] and len(rows) == 1 + n_batches
        assert os.path.exists(log / "log.txt") and not os.path.exists(log / "resume.pkl")
    with pytest.raises(SystemExit, match="semantic-sam"):
        cli_parallel.main(ARGS + ["--generate-proposals", "--proposal-model", "semantic-sam"])
