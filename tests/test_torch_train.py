"""The port's SAM decoder train step (``mars_tpu_torch.parallel.train``)
against the JAX package's (``mars_tpu.parallel.train``) at
tests/test_parallel.py's tiny SamConfig: the loss and its gradients, the
optimiser, a short run, accumulation and remat, and the data- and
tensor-parallel steps on two gloo ranks."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_tiny
from torch_tiny import one_torch_thread  # noqa: F401  (autouse fixture)
from mars_tpu.models import sam as jsam
from mars_tpu.parallel import train as jtrain
from mars_tpu_torch.models import convert, sam as tsam
from mars_tpu_torch.parallel import train as ttrain

B, K, LR, STEPS = 4, 3, 1e-3, 3
LOSS_REL = 1e-5  # float32 sums in another order
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
UPDATE_ATOL = 1e-7  # one AdamW update fed the same gradients
RUN_REL = 1e-4  # the losses of a 3-step run
ACCUM_LOSS, ACCUM_PARAMS = 1e-5, 1e-6  # tests/test_parallel.py's limits
MESH_LOSS, MESH_PARAMS = 1e-5, 1e-6


def _jcfg():
    return jsam.SamConfig(**torch_tiny.SAM)


def _tcfg():
    return tsam.SamConfig(**torch_tiny.SAM)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return convert.from_jax_params(_to_np(tree))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_tree_close(got, want, atol, rtol=0.0):
    n = 0
    for path, w in _leaves(want):
        g = _get(got, path)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol, err_msg=str(path))
        n += 1
    assert n > 0


def _fill(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    x = rng.randn(*tree.shape)
    if path[-1] == "scale":
        x = 1.0 + 0.1 * x
    elif path[-1] != "pe_gaussian":
        x = x * (0.05 if path[0].startswith("upscale") else 0.02)
    return jnp.asarray(x.astype(np.float32))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's trainable, a seeded batch, and what the JAX package
    computes on them: the loss, its gradients and one optax update fed them
    (one jit), and a 3-step run (one jit of its step).  The trainable has the
    JAX initialisers' tree (``jax.eval_shape``: running them costs ~10 s
    of compiles here) filled with seeded numpy values at their scales,
    biases and LayerNorm parameters away from 0 and 1 so that their
    gradients count too."""
    cfg = _jcfg()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: {"prompt_encoder": jsam.init_prompt_encoder_params(key, cfg),
                                     "decoder": jsam.init_decoder_params(key, cfg)})
    rng = np.random.RandomState(0)
    trainable = {part: _fill(tree, rng) for part, tree in shapes.items()}
    g = cfg.img_size // cfg.patch_size
    batch = (rng.randn(B, g, g, cfg.out_chans).astype(np.float32),
             (rng.rand(B, K, 2) * cfg.img_size).astype(np.float32),
             np.ones((B, K), np.int32),
             (rng.rand(B, 4 * g, 4 * g) > 0.7).astype(np.float32))
    tcfg = jtrain.TrainConfig(learning_rate=LR)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    opt, step = jtrain.make_train_step(cfg, tcfg)
    state = opt.init(trainable)

    def grads_and_update(t, *b):
        (loss, aux), grads = jax.value_and_grad(
            lambda t: jtrain.segmentation_loss(t, *b, cfg, tcfg), has_aux=True)(t)
        updates, new_state = opt.update(grads, state, t)
        return loss, aux, grads, optax.apply_updates(t, updates), new_state

    loss, aux, grads, stepped, new_state = jax.jit(grads_and_update)(trainable, *jbatch)
    step = jax.jit(step)
    tr, st, losses = trainable, state, []
    for _ in range(STEPS):
        tr, st, metrics = step(tr, st, *jbatch)
        losses.append(float(metrics["loss"]))
    return {"trainable": _to_np(trainable), "batch": batch, "loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()}, "grads": _to_np(grads),
            "stepped": _to_np(stepped), "mu": _to_np(new_state[0].mu),
            "nu": _to_np(new_state[0].nu), "losses": losses}


def _batch(ref):
    e, c, l, g = ref["batch"]
    return (torch.from_numpy(e), torch.from_numpy(c), torch.from_numpy(l).long(),
            torch.from_numpy(g))


def test_segmentation_loss_matches_jax(ref):
    loss, aux = ttrain.segmentation_loss(_port(ref["trainable"]), *_batch(ref), _tcfg(),
                                         ttrain.TrainConfig(learning_rate=LR))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_REL)
    assert set(aux) == {"focal", "dice", "iou"}
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), ref["aux"][k], rtol=LOSS_REL, err_msg=k)


@pytest.mark.parametrize("part", ["prompt_encoder", "decoder"])
def test_gradients_match_jax(ref, part):
    params = ttrain.tree_map(lambda t: t.requires_grad_(True), _port(ref["trainable"]))
    loss, _ = ttrain.segmentation_loss(params, *_batch(ref), _tcfg(), ttrain.TrainConfig())
    leaves = ttrain.tree_leaves(params[part])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = ttrain._unflatten(params[part], [torch.zeros_like(p) if g is None else g
                                           for p, g in zip(leaves, grads)])
    _assert_tree_close(got, ref["grads"][part], GRAD_ATOL, GRAD_RTOL)


def test_batched_decode_matches_per_example_loop(ref):
    cfg = _tcfg()
    tr = _port(ref["trainable"])
    emb, coords, labels, _ = _batch(ref)
    pe, dec = tr["prompt_encoder"], tr["decoder"]
    g = emb.shape[1]
    image_pe = tsam.dense_pe(pe, (g, g))
    sparse = tsam.embed_points(pe, coords, labels, (cfg.img_size,) * 2, pad=True)
    dense = tsam.no_mask_dense(pe, (g, g))[None].expand(B, g, g, emb.shape[-1])
    with torch.no_grad():
        masks, iou = tsam.decode_masks(dec, emb, image_pe, sparse, dense, cfg)
        for i in range(B):
            m, u = tsam.decode_masks(dec, emb[i], image_pe, sparse[i:i + 1], dense[i:i + 1], cfg)
            np.testing.assert_allclose(masks[i].numpy(), m[0].numpy(), atol=1e-6)
            np.testing.assert_allclose(iou[i].numpy(), u[0].numpy(), atol=1e-6)


def test_adamw_update_matches_optax(ref):
    """Fed JAX's own gradients, so that Adam's normalisation of near-zero
    gradients (their sign) stays out of the comparison."""
    opt = ttrain.AdamW(LR)
    tr = _port(ref["trainable"])
    state = opt.init(tr)
    updates, state = opt.update(_port(ref["grads"]), state, tr)
    assert int(state["count"]) == 1
    _assert_tree_close(ttrain.apply_updates(tr, updates), ref["stepped"], UPDATE_ATOL)
    _assert_tree_close(state["mu"], ref["mu"], UPDATE_ATOL)
    _assert_tree_close(state["nu"], ref["nu"], UPDATE_ATOL)


def test_three_steps_match_jax(ref):
    opt, step = ttrain.make_train_step(_tcfg(), ttrain.TrainConfig(learning_rate=LR))
    tr = _port(ref["trainable"])
    st, losses = opt.init(tr), []
    for _ in range(STEPS):
        tr, st, metrics = step(tr, st, *_batch(ref))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=RUN_REL)
    assert losses[-1] < losses[0] and int(st["count"]) == STEPS


def _cast(tree_or_batch, dtype):
    if isinstance(tree_or_batch, dict):
        return ttrain.tree_map(lambda t: t.to(dtype), tree_or_batch)
    return tuple(x.to(dtype) if x.is_floating_point() else x for x in tree_or_batch)


@pytest.fixture(scope="module")
def full_step(ref):
    """The port's one-process step on the full batch, no accumulation, in
    float32 and in float64 (the train path's LayerNorms, Fourier features
    and IoU target follow a float64 input)."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        opt, step = ttrain.make_train_step(_tcfg(), ttrain.TrainConfig(learning_rate=LR))
        tr = _cast(_port(ref["trainable"]), dtype)
        new, _, metrics = step(tr, opt.init(tr), *_cast(_batch(ref), dtype))
        assert all(t.dtype == dtype for t in ttrain.tree_leaves(new))
        out[dtype] = new, {k: float(v) for k, v in metrics.items()}
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kw", [{"accum_steps": 2}, {"remat": True},
                                {"accum_steps": 2, "remat": True}],
                         ids=["accum", "remat", "both"])
def test_accum_and_remat_match_full_batch(ref, full_step, kw, dtype):
    opt, step = ttrain.make_train_step(_tcfg(), ttrain.TrainConfig(learning_rate=LR), **kw)
    tr = _cast(_port(ref["trainable"]), dtype)
    new, _, metrics = step(tr, opt.init(tr), *_cast(_batch(ref), dtype))
    want_tr, want = full_step[dtype]
    for k, v in metrics.items():
        assert abs(float(v) - want[k]) < ACCUM_LOSS, (k, float(v), want[k])
    _assert_tree_close(new, ttrain.tree_map(lambda t: t.numpy(), want_tr), ACCUM_PARAMS)


def test_accum_not_divisible_raises(ref):
    opt, step = ttrain.make_train_step(_tcfg(), accum_steps=3)
    tr = _port(ref["trainable"])
    with pytest.raises(ValueError, match="not divisible"):
        step(tr, opt.init(tr), *_batch(ref))


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    payload = {"trainable": ref["trainable"], "batch": ref["batch"][:2]
               + (ref["batch"][2].astype(np.int64),) + ref["batch"][3:], "lr": LR}
    return torch_tiny.run_ranks(torch_tiny.train_worker, 2, tmp_path_factory.mktemp("train"),
                                payload)


@pytest.mark.parametrize("key", [(2, 1), (1, 2), (1, 2, "accum_steps", "remat")],
                         ids=["2x1", "1x2", "1x2_accum_remat"])
def test_sharded_step_matches_single_process(ranks, full_step, key):
    want_tr, want = full_step[torch.float32]
    want_np = ttrain.tree_map(lambda t: t.numpy(), want_tr)
    for r, res in enumerate(ranks):
        got = res[key]
        for k, v in got["metrics"].items():
            assert abs(v - want[k]) < MESH_LOSS * max(1.0, abs(want[k])), (r, k, v, want[k])
        _assert_tree_close(got["params"], want_np, MESH_PARAMS)
        if key[1] == 2:  # one head of the two, and its rows of fc2 and its Adam state
            assert got["q_width"] == 4 and got["fc2_rows"] == 16
            assert got["mu_shape"] == (16, 8)
        else:
            assert got["q_width"] == 8 and got["mu_shape"] == (16, 16)


def test_unequal_data_shards_raise(ranks):
    for res in ranks:
        assert res["unequal"] is not None and "unequal" in res["unequal"]
