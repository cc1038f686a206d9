"""The port's Matcher with a point predictor (``pipeline/matcher_oss.py``)
against ``mars_tpu.pipeline.matcher_oss`` on one set of tiny weights: the
golden Matcher fixture's DINOv2 (and SAM, for ``SamPointBackend``) and
seeded Semantic-SAM weights at ``SEMANTIC_SAM_TINY`` fed to both packages.
The port takes JAX's own noise (``_jax_noise``): ``generate_proposals_oss``
splits its key into (k1, k2), k-means++ draws one Gumbel row per centre from
splits of k1 (``test_torch_kmeans.jax_noise``) and the prompt sampler
``gumbel(k2, (D, L))``.  Three prompt regimes: the combinations family (the fixture's ≤ 8
matched points), the draw family (a full support mask, > 8 points) and
k-means++ centres.

Tolerances: the set logits at 3e-5 absolute / 1e-4 relative; in the three
regimes no pixel thresholds otherwise than JAX's, so the binary masks, the
validity, the chosen masks, the merged mask and the bucket's order are
equal and the scores within 1e-4 (the backend contract test, on prompts of
its own, allows ``MAX_FLIPS`` of the pixels).  Then
``cli.main --generate-proposals --proposal-model semantic-sam`` against
``mars_tpu.cli.main`` with tiny towers in both zoos."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_matcher as tm
from mars_tpu import cli as jcli
from mars_tpu.core import imaging as jimaging
from mars_tpu.models import convert as jconvert, dinov2 as jdino, sam as jsam
from mars_tpu.models import semantic_sam as jss, zoo as jzoo
from mars_tpu.pipeline import mars as jmars, matcher as jmatcher, matcher_oss as jmoss
from mars_tpu_torch import cli as tcli
from mars_tpu_torch.models import semantic_sam as tss, zoo
from mars_tpu_torch.pipeline import matcher as tmatcher, matcher_oss as tmoss
from test_torch_kmeans import jax_noise
from test_torch_semantic_sam import both, random_tree

ATOL, RTOL = 3e-5, 1e-4
MAX_FLIPS = 1e-3  # of a call's mask pixels
TINY = tss.SEMANTIC_SAM_TINY
CENTRES = 4
BUCKET = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side while this file runs.  Under
    pytest-xdist's parallel workers, torch's thread pool contending with
    XLA's and the other workers' made these tests 10-50 times slower than
    alone; one thread gives the same results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers():
    data = np.load(tm.os.path.join(tm.FIXTURES, "golden_matcher_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}
    sam_sd = tm._sub(sd, "sam.")
    jsam_params = {"encoder": jconvert.sam_encoder_to_flax(sam_sd, depth=3),
                   "prompt_encoder": jconvert.sam_prompt_encoder_to_flax(sam_sd),
                   "decoder": jconvert.sam_decoder_to_flax(sam_sd)}
    ss_j, ss_t = both(random_tree(tss.param_shapes(TINY), np.random.RandomState(3)))
    return {"jdino": jconvert.dinov2_to_flax(tm._sub(sd, "dino."), depth=3,
                                             num_register_tokens=4),
            "dino": tm._tiny_dino(tm._sub(sd, "dino.")), "jsam": jsam_params,
            "sam": tm._tiny_sam(sam_sd), "ss_j": ss_j, "ss_t": ss_t,
            "sup": np.ascontiguousarray(d["support_images"][0].transpose(0, 2, 3, 1)),
            "supm": d["support_masks"][0].astype(np.float32),
            "qry": np.ascontiguousarray(d["query_image"][0].transpose(1, 2, 0))}


def _configs(regime):
    kw = dict(tm.MATCHER)
    if regime == "centres":
        kw.update(use_points_or_centers=False, num_centers=CENTRES)
    return jmatcher.MatcherConfig(**kw), tmatcher.MatcherConfig(**kw)


def _inputs(towers, regime):
    supm = np.ones_like(towers["supm"]) if regime == "draws" else towers["supm"]
    return towers["sup"], supm, towers["qry"]


def _draws(cfg):
    """Rows of the prompt sampler's draw family (its Gumbel noise's rows)."""
    lo, hi = cfg.sample_range
    return (hi - lo + 1) * cfg.max_sample_iterations


def _jax_noise(jcfg, key):
    """The noise JAX's generate_proposals_oss draws from ``key``, in the
    port's form: its prompt sampler's ``gumbel(k2, (D, L))`` and, with
    centres, k-means++'s rows from splits of k1."""
    _, k1, k2 = jax.random.split(key, 3)
    l = jcfg.grid ** 2
    noise = {"gumbel": torch.from_numpy(np.asarray(jax.random.gumbel(k2, (_draws(jcfg), l))))}
    if not jcfg.use_points_or_centers:
        noise["kmeans_gumbel"] = jax_noise(k1, jcfg.num_centers, l)
    return noise


def _jax_set_logits(towers, coords01, labels, set_valid, size):
    """JAX's Semantic-SAM backend up to its threshold: (B·G, H/4, W/4) and
    the upsampled (B·G, H, W) logits."""
    s = TINY.input_size
    img = jimaging.normalize(jimaging.resize(jnp.asarray(towers["qry"]), (s, s), "bicubic"),
                             jimaging.IMAGENET_MEAN, jimaging.IMAGENET_STD)
    mem, feats = jss.encode_image(towers["ss_j"], img, jss.SEMANTIC_SAM_TINY)
    b, k, _ = coords01.shape
    emb, _ = jss.predict_points(towers["ss_j"], mem, feats, jnp.asarray(coords01).reshape(b * k, 2),
                                jss.SEMANTIC_SAM_TINY, shapes=tss.feature_shapes(TINY, s, s),
                                return_embeddings=True)
    emb = emb.reshape(b, k, TINY.num_granularities, -1)
    live = ((jnp.asarray(labels) == 1) & jnp.asarray(set_valid)[:, None]).astype(emb.dtype)
    emb = jnp.einsum("bkgc,bk->bgc", emb, live) / jnp.maximum(live.sum(1), 1.0)[:, None, None]
    low = jnp.einsum("bgc,zhwc->bghw", emb, feats).reshape(b * TINY.num_granularities,
                                                           s // 4, s // 4)
    return np.asarray(low), np.asarray(jimaging.interpolate_2d(low, size, "bilinear"))


def _run(towers, regime, backend_name, seed=0):
    jcfg, tcfg = _configs(regime)
    sup, supm, qry = _inputs(towers, regime)
    key = jax.random.PRNGKey(seed)
    if backend_name == "semantic-sam":
        jb = jmoss.SemanticSamBackend(towers["ss_j"], jss.SEMANTIC_SAM_TINY)
        tb = tmoss.SemanticSamBackend(towers["ss_t"], TINY)
    else:
        jb = jmoss.SamPointBackend(towers["jsam"], jsam.SamConfig(**tm.SAM), decode_batch=8)
        tb = tmoss.SamPointBackend(*towers["sam"], decode_batch=8)
    jout = jmoss.generate_proposals_oss(
        key, towers["jdino"], jdino.DinoV2Config(**tm.DINO), jb, jcfg, jnp.asarray(sup),
        jnp.asarray(supm), jnp.ones((1,), bool), jnp.asarray(qry))
    jbucket = jcli.bucket_generated_proposals(jout, BUCKET)
    out = tmoss.generate_proposals_oss(
        *towers["dino"], tb, tcfg, torch.from_numpy(sup), torch.from_numpy(supm),
        torch.ones((1,), dtype=torch.bool), torch.from_numpy(qry), bucket=BUCKET,
        **_jax_noise(jcfg, key))
    n_points = int(jout["telemetry"]["n_matched_points"])
    jout = {k: np.asarray(v) for k, v in jout.items() if k != "telemetry"}
    return n_points, out, jout, jbucket, tb


@pytest.mark.parametrize("regime", ["points", "draws", "centres"])
def test_semantic_sam_flow_equals_jax(towers, regime):
    n_points, out, jout, jbucket, tb = _run(towers, regime, "semantic-sam")
    assert int(out["telemetry"]["n_matched_points"]) == n_points
    assert (n_points > 8) == (regime == "draws")
    g = TINY.num_granularities
    assert out["proposal_masks"].shape == jout["proposal_masks"].shape
    assert out["proposal_masks"].shape[0] == g * len(out["set_valid"])
    np.testing.assert_array_equal(out["proposal_valid"].numpy(), jout["proposal_valid"])
    assert out["proposal_valid"].any()
    # the set logits against JAX's backend on the port's prompt sets, and
    # the masks' threshold flips only where JAX's logit is near 0
    size = tuple(out["proposal_masks"].shape[1:])
    jlow, jfull = _jax_set_logits(towers, out["coords01"].numpy(), out["labels"].numpy(),
                                  out["set_valid"].numpy(), size)
    low = tb.set_logits(torch.from_numpy(towers["qry"]), out["coords01"], out["labels"],
                        out["set_valid"])
    np.testing.assert_allclose(low.numpy(), jlow, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(jfull > 0, jout["proposal_masks"])  # JAX's own threshold
    # no pixel flips in these fixtures, so everything scored from the
    # masks is compared
    flips = out["proposal_masks"].numpy() != jout["proposal_masks"]
    assert not flips.any(), (int(flips.sum()), float(np.abs(jfull[flips]).max()))
    live = jout["proposal_valid"]
    for key in ("emd_score", "purity", "coverage"):
        np.testing.assert_allclose(out[key].numpy()[live], jout[key][live], atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(out["chosen"].numpy(), jout["chosen"])
    np.testing.assert_array_equal(out["merged"].numpy(), jout["merged"])
    np.testing.assert_array_equal(out["bucket_valid"].numpy(), np.asarray(jbucket.valid))
    np.testing.assert_array_equal(out["bucket_masks"].numpy(), np.asarray(jbucket.masks))
    assert out["bucket_valid"].any()


def test_sam_point_backend_flow_equals_jax(towers):
    """SAM in the predictor's place: its 3 multimask layers a set, no AMG
    filter; the masks row by row at IoU >= 0.999 (test_torch_matcher's
    limit for SAM's masks), the same validity, chosen rows and merged
    mask."""
    _, out, jout, jbucket, _ = _run(towers, "draws", "sam")
    valid = jout["proposal_valid"]
    assert out["proposal_masks"].shape[0] == 3 * len(out["set_valid"])
    np.testing.assert_array_equal(out["proposal_valid"].numpy(), valid)
    ours, theirs = out["proposal_masks"].numpy()[valid], jout["proposal_masks"][valid]
    assert len(ours) > 0
    for a, b in zip(ours, theirs):
        union = (a | b).sum()
        assert union == 0 or (a & b).sum() / union >= 0.999
    np.testing.assert_array_equal(out["chosen"].numpy(), jout["chosen"])
    merged, jmerged = out["merged"].numpy() > 0, jout["merged"] > 0
    assert (merged & jmerged).sum() >= 0.999 * max((merged | jmerged).sum(), 1)
    np.testing.assert_array_equal(out["bucket_valid"].numpy(), np.asarray(jbucket.valid))


def test_backend_contract_and_encode_cache(towers, monkeypatch):
    """(B·G, H, W) bool masks, validity repeated a set, one encode a query
    tensor; the upsample's chunking does not change the masks."""
    tb = tmoss.SemanticSamBackend(towers["ss_t"], TINY)
    qry = torch.from_numpy(towers["qry"])
    coords = torch.tensor([[[0.3, 0.4], [0.6, 0.6]], [[0.1, 0.9], [0.5, 0.5]]])
    labels = torch.tensor([[1, 1], [1, -1]])
    sv = torch.tensor([True, False])
    masks, valid = tb.predict_batch(qry, coords, labels, sv, (56, 56))
    g = TINY.num_granularities
    assert masks.shape == (2 * g, 56, 56) and masks.dtype == torch.bool
    assert valid.tolist() == [True] * g + [False] * g
    cached = tb._embed_cache[1]
    monkeypatch.setattr(tmoss, "UPSAMPLE_CHUNK", 5)
    again, _ = tb.predict_batch(qry, coords, labels, sv, (56, 56))
    assert tb._embed_cache[1] is cached and torch.equal(again, masks)
    tb.predict_batch(qry.clone(), coords, labels, sv, (56, 56))
    assert tb._embed_cache[1] is not cached
    jb = jmoss.SemanticSamBackend(towers["ss_j"], jss.SEMANTIC_SAM_TINY)
    jmasks, jvalid = jb.predict_batch(jnp.asarray(towers["qry"]), jnp.asarray(coords.numpy()),
                                      jnp.asarray(labels.numpy()), jnp.asarray(sv.numpy()),
                                      (56, 56))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert (masks.numpy() != np.asarray(jmasks)).sum() <= MAX_FLIPS * masks.numel()


# --------------------------------------------------------------------------
# cli.main --generate-proposals --proposal-model semantic-sam
# --------------------------------------------------------------------------

CLI_ARGV = ["--benchmark", "synthetic", "--episodes", "2", "--input-size", "112",
            "--proposal-bucket", str(BUCKET), "--seed", "3", "--gt-class-names",
            "--generate-proposals", "--proposal-model", "semantic-sam"]


@pytest.fixture
def cli_towers(towers, monkeypatch):
    """The golden episode's towers in both zoos (test_torch_cli_text), tiny
    Semantic-SAM weights in both, and the port's prompt noise drawn from
    JAX's episode key: the port's per-episode generator is replaced by the
    episode's index, which a wrapper of generate_proposals_oss turns into
    JAX's Gumbel rows."""
    import test_torch_cli_text as ct

    ct._patch_towers(monkeypatch)
    monkeypatch.setattr(jzoo, "build_semantic_sam", lambda *a, **k: (
        towers["ss_j"], jss.SEMANTIC_SAM_TINY))
    monkeypatch.setattr(zoo, "build_semantic_sam", lambda *a, **k: (towers["ss_t"], TINY))
    monkeypatch.setattr(tcli, "episode_generator", lambda seed, idx, dev: (seed, idx))
    real = tmoss.generate_proposals_oss

    def with_jax_noise(dino_params, dino_cfg, backend, cfg, *arrays, generator, bucket):
        return real(dino_params, dino_cfg, backend, cfg, *arrays, bucket=bucket,
                    **_jax_noise(cfg, jcli.episode_key(*generator)))

    monkeypatch.setattr(tmoss, "generate_proposals_oss", with_jax_noise)


def _recording(monkeypatch, module, seen):
    real = module.bucket_generated_proposals

    def record(*a, **k):
        props = real(*a, **k)
        seen.append((np.asarray(props.masks), np.asarray(props.valid)))
        return props

    monkeypatch.setattr(module, "bucket_generated_proposals", record)


def test_cli_semantic_sam_equals_jax_cli(cli_towers, monkeypatch, tmp_path):
    """Two synthetic episodes at input 112 (Semantic-SAM encodes at its
    tiny config's 64): each bucket and merged mask equal to the JAX CLI's,
    no kernel launch on the CPU."""
    jbuckets, tbuckets, jmasks = [], [], []
    _recording(monkeypatch, jcli, jbuckets)
    _recording(monkeypatch, tcli, tbuckets)
    real = jmars.Mars.predict

    def predict(self, ep, props, class_name=None, class_description=""):
        merged = real(self, ep, props, class_name=class_name,
                      class_description=class_description)
        jmasks.append(np.asarray(merged) > 0.5)
        return merged

    monkeypatch.setattr(jmars.Mars, "predict", predict)
    jcli.main(CLI_ARGV + ["--log-path", str(tmp_path / "jax"), "--overlap-ranking", "0"])
    res = tcli.main(CLI_ARGV + ["--log-path", str(tmp_path / "port"), "--device", "cpu"],
                    keep_masks=True)
    assert len(jbuckets) == len(tbuckets) == len(jmasks) == 2
    for (tm_, tv), (jm, jv) in zip(tbuckets, jbuckets):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tm_, jm)
    assert sum(int(v.sum()) for _, v in tbuckets) > 0
    assert res["live_proposals"] == [int(v.sum()) for _, v in jbuckets]
    for got, want in zip(res["masks"], jmasks):
        np.testing.assert_array_equal(got, want)
    assert res["launches"] == {name: 0 for name in tcli.KERNELS}


def test_cli_semantic_sam_refuses_explicit_fused_proposals(cli_towers):
    with pytest.raises(SystemExit, match="SAM backend only"):
        tcli.main(CLI_ARGV + ["--fused-proposals", "--device", "cpu"])
    with pytest.raises(SystemExit, match="SAM backend only"):
        jcli.main(CLI_ARGV + ["--fused-proposals"])


def test_cli_semantic_sam_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(CLI_ARGV)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.build_semantic_sam()
