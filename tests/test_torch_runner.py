"""The port's episode-batched ranker, proposal-sharded ranker and batched
proposal generator (``parallel.runner``) against the JAX package's
``make_batched_ranker`` and the port's serial paths."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tiny
from torch_tiny import one_torch_thread  # noqa: F401  (autouse fixture)
from mars_tpu.parallel import runner as jrunner
from mars_tpu_torch import cli as tcli
from mars_tpu_torch.core.episode import Episode, Proposals
from mars_tpu_torch.ops import flash_attention
from mars_tpu_torch.parallel import runner
from mars_tpu_torch.pipeline import amg as tamg, matcher as tmatcher
from test_torch_matcher import AMG, FIXTURES, MATCHER, _sub, _tiny_dino, _tiny_sam

TOL = 1e-5  # float32: the same formulas over stacked batches, sums in other orders


@pytest.fixture(scope="module")
def towers():
    trees = torch_tiny.jax_trees(0)
    return trees, torch_tiny.jax_mars(trees), torch_tiny.port_mars(trees)


def test_batched_ranker_matches_jax_and_serial(towers, monkeypatch):
    """Three episodes (dead rows in two) at local batch 3: merged masks
    equal to JAX's vmapped ranker and to the port's serial ``Mars`` path,
    scores within TOL; the tap runs on the three queries only."""
    _, jm, tm = towers
    ep = torch_tiny.episodes(3, dead=[(1, 5), (2, 0), (2, 7)])
    jb = {"dino": jm.dino_params, "clip_v": jm.clip_v, "ac_v": jm.ac_v,
          "logit_scale": jm.clip_scale}
    want_m, want_s = jrunner.make_batched_ranker(*torch_tiny.configs(jm))(
        jb, *map(jnp.asarray, ep))
    taps = []
    real = flash_attention.attention_with_tap
    monkeypatch.setattr(flash_attention, "attention_with_tap",
                        lambda *a: (taps.append(a[0].shape), real(*a))[1])
    got_m, got_s = runner.make_batched_ranker(*torch_tiny.configs(tm))(
        torch_tiny.bundle(tm), *map(torch.from_numpy, ep))
    assert len(taps) == torch_tiny.TAPS * 3
    valid = ep[5]
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_s.numpy()[valid], np.asarray(want_s)[valid], atol=TOL, rtol=0)
    assert np.all(np.isneginf(got_s.numpy()[~valid]))
    monkeypatch.undo()
    for i in range(3):
        e = Episode(*(torch.from_numpy(x[i]) for x in ep[:4]), class_id=0)
        props = Proposals(torch.from_numpy(ep[4][i]), torch.from_numpy(ep[5][i]))
        # the serial path with these text features: Mars._run's stages
        monkeypatch.setattr(tm, "_vta_text_feats", lambda name, i=i: torch.from_numpy(ep[6][i]))
        monkeypatch.setattr(tm, "_alpha_clip_text_feats",
                            lambda text, i=i: torch.from_numpy(ep[7][i]))
        out = tm._run(e, props, "x", "")
        np.testing.assert_array_equal(got_m[i].numpy(), out["merged"].numpy())
        np.testing.assert_allclose(got_s[i].numpy()[valid[i]], out["scores"].numpy()[valid[i]],
                                   atol=TOL, rtol=0)


def test_shard_batch_takes_the_data_index_slice():
    class _Mesh:
        n_data, data_index, device = 2, 1, torch.device("cpu")

    x = torch.arange(8).reshape(4, 2)
    (got,) = runner.shard_batch((x,), _Mesh())
    np.testing.assert_array_equal(got.numpy(), [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="not divisible"):
        runner.shard_batch((x[:3],), _Mesh())


def test_proposal_parallel_ranker_equals_single(towers, tmp_path):
    """Two gloo ranks, four rows each (dead rows on both shards): merged
    mask equal and final scores within TOL of the one-device ranking; a
    bucket that does not divide raises."""
    trees = towers[0]
    payload = {"trees": trees, "episodes": torch_tiny.episodes(1, dead=[(0, 1), (0, 6)], seed=5)}
    valid = payload["episodes"][5][0]
    for out in torch_tiny.run_ranks(torch_tiny.proposal_parallel_worker, 2, tmp_path, payload):
        np.testing.assert_array_equal(out["merged"], out["want_merged"])
        np.testing.assert_allclose(out["final"][valid], out["want_final"][valid], atol=TOL,
                                   rtol=0)
        assert "not divisible" in out["raised"]


def test_batched_generator_equals_serial_matcher():
    """The golden Matcher episode and two variants (another query, a
    larger footprint) through the batched generator at local batch 3 over
    the serial flow: buckets bitwise equal to the serial Matcher's on the
    same ``episode_generator`` streams (the generator loops that flow; the
    flow itself is held against the JAX package in test_torch_matcher)."""
    data = np.load(os.path.join(FIXTURES, "golden_matcher_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    sup = np.ascontiguousarray(data["support_images"][0].transpose(0, 2, 3, 1))
    supm = data["support_masks"][0]
    qry = np.ascontiguousarray(data["query_image"][0].transpose(1, 2, 0))
    big = supm.copy()
    big[:, 8:56, 8:56] = 1
    sup_i = np.stack([sup, sup, sup])
    sup_m = np.stack([supm, supm, big])
    qrys = np.stack([qry, qry[::-1].copy(), qry])
    sup_v = np.ones((3, 1), bool)
    sam_params, sam_cfg = _tiny_sam(_sub(sd, "sam."))
    dino_params, dino_cfg = _tiny_dino(_sub(sd, "dino."))
    mcfg, acfg = tmatcher.MatcherConfig(**MATCHER), tamg.AmgConfig(**AMG)

    def generate(ep, generator):
        out = tmatcher.generate_proposals(
            dino_params, dino_cfg, sam_params, sam_cfg, acfg, mcfg, ep.support_images,
            ep.support_masks, ep.support_valid, ep.query_image, generator=generator, bucket=8)
        return tcli.bucket_generated_proposals(out)

    eps = [Episode(*map(torch.from_numpy, (sup_i[i], sup_m[i], sup_v[i], qrys[i])), class_id=0)
           for i in range(3)]
    masks, valid = runner.make_batched_proposal_generator(generate)(
        eps, [tcli.episode_generator(7, idx, "cpu") for idx in range(3)])
    assert masks.shape == (3, 8) + qry.shape[:2] and valid.shape == (3, 8)
    live = 0
    for i in range(3):
        want = tmatcher.generate_proposals(
            dino_params, dino_cfg, sam_params, sam_cfg, acfg, mcfg,
            *map(torch.from_numpy, (sup_i[i], sup_m[i], sup_v[i], qrys[i])),
            generator=tcli.episode_generator(7, i, "cpu"), bucket=8)
        np.testing.assert_array_equal(masks[i].numpy(), want["bucket_masks"].numpy(),
                                      err_msg=f"bucket_masks {i}")
        np.testing.assert_array_equal(valid[i].numpy(), want["bucket_valid"].numpy(),
                                      err_msg=f"bucket_valid {i}")
        live += int(want["bucket_valid"].sum())
    assert live > 0
