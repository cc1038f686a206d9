"""Tiny ranking towers and a multi-rank launcher shared by the parallel
driver tests, and the split-TF32 arithmetic shared by the float32
tensor-core kernels' emulations.

``jax_trees`` draws the JAX package's tower parameters from a seed;
``port_mars`` builds the port's ``Mars`` on the same arrays (numpy trees,
``convert.from_jax_params``), two heads a tower so that a 2-way model axis
holds whole heads.  ``run_ranks`` starts ``world`` processes on a gloo
group over a ``FileStore`` (``torch.multiprocessing.spawn``) and returns
each rank's result; its workers live here, in a module that imports no
JAX, so that a spawned rank starts quickly.

``tf32_split``, ``tf32_product`` and ``PV_ORDER`` are the split-TF32
arithmetic of ``csrc/sm90.cuh`` and ``csrc/attention_tf32.cuh``;
``tf32_sweep`` is ``tf32::unbiased_sweep`` (``notap_f32``, ``tap_out_f32``).
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while a test file that imports this fixture
    runs: under pytest-xdist's workers, torch's thread pool contending with
    the other workers' makes the many small operations of EMD's Sinkhorn
    and the Matcher 10-50 times slower than alone
    (``tests/test_torch_matcher_oss.py`` measured it first)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE, GRID = 56, 4
DINO = dict(patch_size=14, embed_dim=32, depth=2, num_heads=2, num_register_tokens=4,
            pos_embed_grid=4)
CLIP_V = dict(patch_size=16, width=64, depth=3, num_heads=2, output_dim=16, pos_embed_grid=2)
ALPHA_V = dict(patch_size=16, width=64, depth=2, num_heads=2, output_dim=16, pos_embed_grid=2,
               alpha_channel=True)
TEXT = dict(width=16, depth=2, num_heads=2, output_dim=16)
VVA = dict(grid=GRID, attn_tap_last_n=2)
VTA = dict(input_size=64, grid=4, attn_tap_last_n=2)
FM = dict(grid=GRID, alpha_clip_size=32, alpha_clip_batch=4, emd_row_bucket=16,
          emd_col_bucket=16)
# taps an episode at these configs: DINOv2's last 2 blocks, CLIP's prefinal block 1
TAPS = 2 + 1


def _fill(shapes, rng):
    """Seeded values for a tree of shapes: norm scales 1, biases 0,
    LayerScale 0.1, matrices N(0, 1/fan_in), other arrays N(0, 0.02²)."""
    if isinstance(shapes, dict):
        return {k: (_fill(v, rng) if isinstance(v, dict) else _leaf(k, v.shape, rng))
                for k, v in shapes.items()}
    return _leaf("", shapes.shape, rng)


def _leaf(name, shape, rng):
    if name == "scale":
        return np.ones(shape, np.float32)
    if name == "bias":
        return np.zeros(shape, np.float32)
    if name == "gamma":
        return np.full(shape, 0.1, np.float32)
    if len(shape) in (2, 4) and name not in ("pos_embed",):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    return (rng.randn(*shape) * 0.02).astype(np.float32)


def jax_trees(seed: int = 0) -> dict:
    """The towers' parameter trees with the JAX package's names and shapes
    (``jax.eval_shape`` of its initialisers: no compile), as seeded numpy."""
    import jax

    from mars_tpu.models import clip as jclip, dinov2 as jdino

    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: {
        "dino": jdino.init_params(key, jdino.DinoV2Config(**DINO)),
        "clip_v": jclip.init_visual_params(key, jclip.ClipVisualConfig(**CLIP_V)),
        "clip_t": jclip.init_text_params(key, jclip.ClipTextConfig(**TEXT)),
        "ac_v": jclip.init_visual_params(key, jclip.ClipVisualConfig(**ALPHA_V)),
        "ac_t": jclip.init_text_params(key, jclip.ClipTextConfig(**TEXT))})
    return _fill(shapes, np.random.RandomState(seed))


def jax_mars(trees):
    import jax.numpy as jnp

    from mars_tpu.models import clip as jclip, dinov2 as jdino
    from mars_tpu.pipeline import filtering as jfilt, mars as jmars, vta as jvta, vva as jvva

    scale = jnp.float32(np.log(1 / 0.07))
    tcfg = jclip.ClipTextConfig(**TEXT)
    return jmars.Mars(
        dino=(trees["dino"], jdino.DinoV2Config(**DINO)),
        clip=(trees["clip_v"], trees["clip_t"], scale, jclip.ClipVisualConfig(**CLIP_V), tcfg),
        alpha_clip=(trees["ac_v"], trees["ac_t"], scale, jclip.ClipVisualConfig(**ALPHA_V),
                    tcfg),
        retriever=None,
        cfg=jmars.MarsConfig(vva=jvva.VVAConfig(**VVA), vta=jvta.VTAConfig(**VTA),
                             filter_merge=jfilt.FilterMergeConfig(**FM)))


def port_mars(trees, device="cpu", retriever=None):
    from mars_tpu_torch.models import clip as tclip, convert, dinov2 as tdino
    from mars_tpu_torch.pipeline import (filtering as tfilt, mars as tmars, vta as tvta,
                                         vva as tvva)

    def port(name):
        return convert.from_jax_params(trees[name], device)

    scale = torch.tensor(np.log(1 / 0.07), dtype=torch.float32, device=device)
    tcfg = tclip.ClipTextConfig(**TEXT)
    return tmars.Mars(
        dino=(port("dino"), tdino.DinoV2Config(**DINO)),
        clip=(port("clip_v"), port("clip_t"), scale, tclip.ClipVisualConfig(**CLIP_V), tcfg),
        alpha_clip=(port("ac_v"), port("ac_t"), scale, tclip.ClipVisualConfig(**ALPHA_V), tcfg),
        cfg=tmars.MarsConfig(vva=tvva.VVAConfig(**VVA), vta=tvta.VTAConfig(**VTA),
                             filter_merge=tfilt.FilterMergeConfig(**FM)),
        device=device, retriever=retriever)


def episodes(b: int, p: int = 8, seed: int = 3, dead=()):
    """B random episodes as numpy: support images (B, 1, H, W, 3), masks,
    validity, queries, proposals (B, P, H, W), proposal validity (the
    (episode, row) pairs of ``dead`` off), VTA text pairs (B, 2, 16) and
    AlphaCLIP text (B, 1, 16)."""
    rng = np.random.RandomState(seed)
    sup_i = rng.rand(b, 1, SIZE, SIZE, 3).astype(np.float32)
    sup_m = np.zeros((b, 1, SIZE, SIZE), np.float32)
    for i in range(b):
        y, x = rng.randint(0, 20, 2)
        sup_m[i, :, y:y + 12 + 4 * i, x:x + 16] = 1
    sup_v = np.ones((b, 1), bool)
    qry = rng.rand(b, SIZE, SIZE, 3).astype(np.float32)
    prop_m = (rng.rand(b, p, SIZE, SIZE) > 0.7).astype(np.float32)
    prop_v = np.ones((b, p), bool)
    for i, j in dead:
        prop_v[i, j] = False
        prop_m[i, j] = 0
    vta_text = rng.randn(b, 2, 16).astype(np.float32)
    ac_text = rng.randn(b, 1, 16).astype(np.float32)
    ac_text /= np.linalg.norm(ac_text, axis=-1, keepdims=True)
    return sup_i, sup_m, sup_v, qry, prop_m, prop_v, vta_text, ac_text


def bundle(model) -> dict:
    return {"dino": model.dino_params, "clip_v": model.clip_v, "ac_v": model.ac_v,
            "logit_scale": model.clip_scale}


def configs(model):
    return (model.dino_cfg, model.clip_vcfg, model.ac_vcfg, model.cfg.vva, model.cfg.vta,
            model.cfg.filter_merge)


def props_fn(size: int, bucket: int, rng: np.random.RandomState):
    """A tiny-size stand-in for ``cli.synthetic_proposals``: the ground truth
    and bucket - 1 boxes drawn from ``rng`` (draw order checks the host
    RNG's parity), padded on the host."""
    from mars_tpu_torch.core.episode import pad_proposals
    from mars_tpu_torch.data.base import resized_gt

    def fn(idx, rec):
        gt, _ = resized_gt(rec, size)
        props = [gt]
        for _ in range(bucket - 1):
            y, x = rng.randint(0, size - 16, 2)
            m = np.zeros_like(gt)
            m[y:y + 12, x:x + 12] = 1
            props.append(m)
        return pad_proposals(torch.from_numpy(np.stack(props).astype(np.float32)), bucket)

    return fn


def _entry(rank, worker, world, store, payload, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = worker(rank, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(worker, world: int, tmp_path, payload):
    """``worker(rank, payload)`` on ``world`` spawned ranks of one gloo
    group → the ranks' results, in rank order."""
    out = str(tmp_path)
    torch.multiprocessing.spawn(_entry, args=(worker, world, os.path.join(out, "store"),
                                              payload, out), nprocs=world, join=True)
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tp_worker(rank, payload):
    """The towers and the VLM at mesh 1 x 2 against the same full trees
    run whole on this rank: tower outputs and taps, the Grad-CAM prior,
    AlphaCLIP, the batched ranker, and greedy tokens (float32, int8, int4).
    The sliced towers' outputs come back too (``tp_outputs``), for the
    JAX package's sharded towers."""
    from mars_tpu_torch.models import clip as tclip, dinov2 as tdino, vip_llava as tvl
    from mars_tpu_torch.models.quantization import quantize_params
    from mars_tpu_torch.parallel import mesh as mesh_lib, runner
    from mars_tpu_torch.pipeline import vta as tvta

    mesh = mesh_lib.make_mesh(1, 2, device="cpu")
    model = port_mars(payload["trees"])
    full = bundle(model)
    part = {k: mesh_lib.shard_params(v, mesh) for k, v in full.items()}
    ep = [torch.from_numpy(x) for x in payload["episodes"]]
    imgs = ep[3]
    out = {"qkv_width": part["dino"]["block0"]["attn"]["qkv"]["kernel"].shape[1]}
    with torch.no_grad():
        want = tdino.forward_features(full["dino"], imgs, model.dino_cfg, attn_tap_last_n=2)
        with mesh.tensor_parallel():
            got = tdino.forward_features(part["dino"], imgs, model.dino_cfg, attn_tap_last_n=2)
        out["dino"] = _max_diff(got["x_prenorm"], want["x_prenorm"])
        out["dino_tap"] = _max_diff(got["attn_mean"], want["attn_mean"])
        tp = {"dino": got["x_prenorm"].numpy(), "dino_tap": got["attn_mean"].numpy()}
        want = tvta.compute_batch(full["clip_v"], imgs, ep[6], full["logit_scale"],
                                  model.clip_vcfg, model.cfg.vta)
        with mesh.tensor_parallel():
            got = tvta.compute_batch(part["clip_v"], imgs, ep[6], full["logit_scale"],
                                     model.clip_vcfg, model.cfg.vta)
        out["vta"] = max(_max_diff(g, w) for g, w in zip(got, want))
        tp["vta"] = torch.stack(got).numpy()
        alpha = ep[4][:, 0, :32, :32]
        img32 = torch.nn.functional.interpolate(imgs.permute(0, 3, 1, 2), size=32).permute(
            0, 2, 3, 1)
        want = tclip.visual_cls(full["ac_v"], img32, model.ac_vcfg, alpha=alpha)
        with mesh.tensor_parallel():
            got = tclip.visual_cls(part["ac_v"], img32, model.ac_vcfg, alpha=alpha)
        out["alphaclip"] = _max_diff(got, want)
        tp.update(alphaclip=got.numpy(), alphaclip_in=(img32.numpy(), alpha.numpy()))
    out["tp_outputs"] = tp
    merged_w, scores_w = runner.make_batched_ranker(*configs(model))(full, *ep)
    merged_g, scores_g = runner.make_batched_ranker(*configs(model), mesh=mesh)(part, *ep)
    valid = ep[5]
    out["ranker_masks_equal"] = bool(torch.equal(merged_g, merged_w))
    out["ranker_scores"] = _max_diff(scores_g[valid], scores_w[valid])
    vp = tvl.init_random_params(11, tvl.TINY, dtype=torch.float32, device="cpu")
    ids, pix = torch.from_numpy(payload["ids"]), torch.from_numpy(payload["pix"])
    for name, tree in (("float32", vp), ("int8", quantize_params(vp, bits=8, min_size=64)),
                       ("int4", quantize_params(vp, bits=4, min_size=64))):
        want = tvl.generate_greedy(tree, ids, pix, tvl.TINY, max_new_tokens=6)
        with mesh.tensor_parallel():
            got = tvl.generate_greedy(mesh_lib.shard_params(tree, mesh), ids, pix, tvl.TINY,
                                      max_new_tokens=6)
        out[f"tokens_{name}"] = (got.numpy(), want.numpy())
    sliced = mesh_lib.shard_params(quantize_params(vp, bits=4, min_size=64), mesh)
    out["int4_whole"] = sliced["language"]["layer0"]["attn"]["q"]["kernel"]["q4"].shape[1]
    out["float_q_width"] = mesh_lib.shard_params(vp, mesh)["language"]["layer0"]["attn"]["q"][
        "kernel"].shape[1]
    return out


def proposal_parallel_worker(rank, payload):
    """``make_proposal_parallel_ranker`` at mesh 2 x 1 on one episode's
    bucket, against the single-device formulas on this rank alone."""
    from mars_tpu_torch.parallel import mesh as mesh_lib, runner

    mesh = mesh_lib.make_mesh(2, 1, device="cpu")
    model = port_mars(payload["trees"])
    ep = [torch.from_numpy(x[0]) for x in payload["episodes"]]
    rank_fn = runner.make_proposal_parallel_ranker(*configs(model), mesh=mesh)
    merged, final = rank_fn(bundle(model), *ep)
    single = runner.make_batched_ranker(*configs(model))(
        bundle(model), *[torch.from_numpy(x) for x in payload["episodes"]])
    try:
        rank_fn(bundle(model), *ep[:4], ep[4][:7], ep[5][:7], *ep[6:])
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"merged": merged.numpy(), "final": final.numpy(), "want_merged": single[0][0].numpy(),
            "want_final": single[1][0].numpy(), "raised": raised}


def dataset(n: int):
    from mars_tpu_torch.data.registry import build_dataset

    return build_dataset("synthetic", shot=1, size=SIZE, num_episodes=n)


def evaluate(mesh, model, n: int, local_batch: int, bucket: int = 4, **kw):
    """``evaluate_parallel`` over ``n`` tiny synthetic episodes with the
    stand-in proposals of ``props_fn`` (seed 0) → (meter, masks, batch
    times)."""
    from mars_tpu_torch import cli_parallel

    masks = []
    _, _, meter, times = cli_parallel.evaluate_parallel(
        model, dataset(n), mesh, input_size=SIZE, episodes=n, proposal_bucket=bucket,
        props_fn=props_fn(SIZE, bucket, np.random.RandomState(0)), local_batch=local_batch,
        log=lambda *a: None, masks=masks, **kw)
    return meter, np.stack(masks), times


def cli_parallel_worker(rank, payload):
    """``evaluate_parallel`` at mesh 2 x 1 (local batch 2) and at 1 x 2
    (tensor-parallel towers, local batch 4), on one gloo group."""
    from mars_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for shape, lb in (((2, 1), 2), ((1, 2), 4)):
        mesh = mesh_lib.make_mesh(*shape, device="cpu")
        model = port_mars(payload["trees"])
        if mesh.n_model > 1:
            for name in ("dino_params", "clip_v", "ac_v"):
                setattr(model, name, mesh_lib.shard_params(getattr(model, name), mesh))
        meter, masks, times = evaluate(mesh, model, payload["n"], lb)
        out[shape] = (meter.inter.copy(), meter.union.copy(), masks, len(times))
    return out


# SAM at tests/test_parallel.py's tiny size: two decoder heads, so that a
# 2-way model axis holds one whole head of each attention a rank
SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
           global_attn_indexes=(1,), window_size=2, out_chans=16, decoder_mlp_dim=32,
           decoder_heads=2)
TRAIN_MESHES = ((2, 1), (1, 2))


def train_worker(rank, payload):
    """One train step at each mesh of ``TRAIN_MESHES`` on the same full
    trainable and batch: the rank's slices (``shard_params``) and data
    shard (``shard_batch``), the step's metrics and the full tree gathered
    back (``gather_params``); at 1 x 2 also with ``accum_steps=2`` and
    ``remat``; at 2 x 1 also shards of unequal sizes (each rank's
    ValueError)."""
    from mars_tpu_torch.models import sam as tsam
    from mars_tpu_torch.parallel import mesh as mesh_lib, runner, train

    cfg = tsam.SamConfig(**SAM)
    tcfg = train.TrainConfig(learning_rate=payload["lr"])
    full = train.tree_map(torch.from_numpy, payload["trainable"])
    batch = tuple(torch.from_numpy(x) for x in payload["batch"])
    out = {}
    for shape in TRAIN_MESHES:
        mesh = mesh_lib.make_mesh(*shape, device="cpu")
        part = mesh_lib.shard_params(full, mesh)
        local = runner.shard_batch(batch, mesh)
        kws = [{}] + ([{"accum_steps": 2, "remat": True}] if shape == (1, 2) else [])
        for kw in kws:
            opt, step = train.make_train_step(cfg, tcfg, mesh=mesh, **kw)
            new, state, metrics = step(part, opt.init(part), *local)
            key = shape + tuple(sorted(kw))
            out[key] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": train.tree_map(torch.Tensor.numpy,
                                         mesh_lib.gather_params(new, mesh, full)),
                "mu_shape": tuple(state["mu"]["decoder"]["transformer"]["layer0"]["self_attn"]
                                  ["q"]["kernel"].shape),
                "q_width": part["decoder"]["transformer"]["final_attn"]["q"]["kernel"].shape[1],
                "fc2_rows": part["decoder"]["transformer"]["layer0"]["mlp"]["fc2"]["kernel"]
                .shape[0]}
        if shape == (2, 1):
            opt, step = train.make_train_step(cfg, tcfg, mesh=mesh)
            rows = 2 if rank == 0 else 1
            try:
                step(full, opt.init(full), *(x[:rows] for x in batch))
                out["unequal"] = None
            except ValueError as e:
                out["unequal"] = str(e)
    return out


# the keys inside each group of 8 in the split-TF32 kernels' P.V
PV_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32_bits(x, add):
    """float32 ``x`` plus ``add`` on its bits, the low 13 bits cleared."""
    u = x.contiguous().numpy().view(np.uint32).astype(np.uint64)
    return torch.from_numpy(((u + add) & 0xFFFFE000).astype(np.uint32).view(np.float32))


def tf32_split(x):
    """``sm90::split_tf32``: hi = x rounded to TF32 (11 significant bits),
    to nearest with ties away from zero; lo = x - hi truncated to TF32."""
    hi = _tf32_bits(x, 0x1000)
    return hi, _tf32_bits(x - hi, 0)


def tf32_product(a, b, mode):
    """``a @ b`` as the kernels' TF32 wgmma passes, summed from zero in one
    float32 accumulator: "tf32x3" a_lo b_hi, a_hi b_lo, a_hi b_hi (the small
    terms first), "tf32" only a_hi b_hi."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    if mode == "tf32":
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def tf32_sweep(q, k, v, mode="tf32x3", skip_tile=None):
    """``tf32::unbiased_sweep``'s arithmetic on (..., L, D) float32 inputs →
    (out, lse): key tiles of 64 (32 past head dim 80), logits scaled after
    the product, a running max and sum per row, each tile's P·V (keys in
    the kernel's order) summed from zero, then added to the rescaled output
    sum; lse = max + log(sum).  ``mode`` "tf32" is one TF32 pass a product
    and ``skip_tile`` drops one key tile: the faults the card's limits have
    to catch."""
    d, l = q.shape[-1], k.shape[-2]
    tile = 32 if d > 80 else 64
    order = torch.tensor([8 * (i // 8) + PV_ORDER[i % 8] for i in range(tile)])
    m = torch.full(q.shape[:-1], -torch.inf)
    total = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t, k0 in enumerate(range(0, l, tile)):
        keys = torch.arange(k0, min(k0 + tile, l))  # keys past L are not attended
        if t == skip_tile:
            continue
        s = tf32_product(q, k[..., keys, :].transpose(-1, -2), mode) * d ** -0.5
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        total = total * corr + p.sum(-1)
        live = order[order < len(keys)]
        acc = torch.addcmul(tf32_product(p[..., live], v[..., keys[live], :], mode), acc,
                            corr[..., None])
        m = m_new
    return acc * (1 / total)[..., None], m + torch.log(total)
