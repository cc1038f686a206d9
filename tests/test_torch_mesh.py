"""The port's mesh and tensor parallelism (``parallel.mesh``,
``models.layers``' sliced blocks) against the JAX package's partition
(``mars_tpu.parallel.mesh.param_shardings``) and against whole towers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tiny
from torch_tiny import one_torch_thread  # noqa: F401  (autouse fixture)
from mars_tpu.models import clip as jclip, dinov2 as jdino
from mars_tpu.models import sam as jsam, vip_llava as jvl
from mars_tpu.parallel import mesh as jmesh
from mars_tpu_torch.models import convert
from mars_tpu_torch.models.quantization import quantize_params
from mars_tpu_torch.parallel import mesh as mesh_lib

TOL = 1e-5  # float32 sums split over two ranks and added in another order


@pytest.fixture(scope="module")
def trees():
    """The JAX package's parameter trees by shape (``jax.eval_shape`` of
    its initialisers), filled with seeded numpy values."""
    key = jax.random.PRNGKey(0)
    shapes = {
        "dinov2": jax.eval_shape(lambda: jdino.init_params(
            key, jdino.DinoV2Config(**torch_tiny.DINO))),
        "clip": jax.eval_shape(lambda: jclip.init_visual_params(
            key, jclip.ClipVisualConfig(**torch_tiny.ALPHA_V))),
        "vip_llava": jax.eval_shape(lambda: jvl.init_random_params(0, jvl.TINY,
                                                                   dtype=jnp.float32)),
        # SAM ViT-H's trained decoder at full width (8 heads of 32 and of 16)
        "sam_decoder": jax.eval_shape(lambda: jsam.init_decoder_params(
            key, jsam.SAM_VARIANTS["vit_h"]))}
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("name", ["dinov2", "clip", "vip_llava", "sam_decoder"])
def test_spec_for_matches_jax_partition(trees, name, bits):
    port = convert.from_jax_params(trees[name])
    if bits:  # the port's quantized leaves have the JAX package's names and layouts
        port = quantize_params(port, bits=bits, min_size=64)
    want = jmesh.param_shardings(jax.tree.map(lambda t: t.numpy(), port),
                                 jmesh.make_mesh(n_data=4, n_model=2))
    q4 = mesh_lib.q4_kernel_paths(port)
    n_sharded = 0
    for path, t in _leaves(port):
        spec = want
        for k in path:
            spec = spec[k]
        assert mesh_lib.spec_for(path, t, 2, q4) == tuple(spec.spec), path
        n_sharded += bool(tuple(spec.spec))
    assert n_sharded > 0 if bits != 4 or name != "vip_llava" else True


def test_shard_params_cuts_whole_heads_and_keeps_4bit_blocks():
    class _Mesh:
        n_model, model_index = 2, 1

    w = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)  # qkv of 2 heads of 2
    block = {"attn": {"qkv": {"kernel": w, "bias": torch.arange(12.0)},
                      "proj": {"kernel": torch.ones(4, 4), "bias": torch.zeros(4)}},
             "mlp": {"fc1": {"kernel": torch.ones(4, 8)}, "fc2": {"kernel": torch.ones(8, 4)}}}
    got = mesh_lib.shard_params({"block0": block}, _Mesh())["block0"]
    np.testing.assert_array_equal(got["attn"]["qkv"]["kernel"].numpy(),
                                  w[:, [2, 3, 6, 7, 10, 11]].numpy())
    np.testing.assert_array_equal(got["attn"]["qkv"]["bias"].numpy(), [2, 3, 6, 7, 10, 11])
    assert got["attn"]["proj"]["kernel"].shape == (2, 4) and got["attn"]["proj"]["bias"].shape == (4,)
    assert got["mlp"]["fc1"]["kernel"].shape == (4, 4) and got["mlp"]["fc2"]["kernel"].shape == (4, 4)
    block["mlp"]["fc2"]["kernel"] = {"q4": torch.zeros(4, 4, dtype=torch.int8),
                                     "scale": torch.ones(4)}
    assert mesh_lib.shard_params({"block0": block}, _Mesh())["block0"] is block


# (internal width, head dim) of each SAM decoder attention at ViT-H
SAM_ATTENTIONS = {"self_attn": (256, 32), "cross_attn_t2i": (128, 16),
                  "cross_attn_i2t": (128, 16), "final_attn": (128, 16)}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_params_cuts_sam_decoder_as_jax_whole_heads(trees, n):
    """SAM's decoder (the train step's tensor-parallel model): each
    attention's q/k/v keep the rank's output features, ``out`` its input
    features (bias whole), each two-way layer's fc1/fc2 likewise, as
    JAX's ``_spec_for`` partitions them; every rank holds whole heads, and
    the rest of the tree (hypernetworks, IoU head, upscale) stays whole."""
    full = convert.from_jax_params(trees["sam_decoder"])
    want = jmesh.param_shardings(trees["sam_decoder"], jmesh.make_mesh(n_data=1, n_model=2))
    for r in range(n):
        class _Mesh:
            n_model, model_index = n, r

        part = mesh_lib.shard_params(full, _Mesh())
        cut = 0
        for path, t in _leaves(full):
            got, spec = part, want
            for k in path:
                got, spec = got[k], spec[k]
            spec = tuple(spec.spec)
            if not spec:
                assert got is t, path
                continue
            axis = 1 if spec == (None, "model") else 0
            size = t.shape[axis] // n
            np.testing.assert_array_equal(got.numpy(), t.narrow(axis, r * size, size).numpy(),
                                          err_msg=str(path))
            cut += 1
        t = part["transformer"]
        for name, (width, hd) in SAM_ATTENTIONS.items():
            for layer in ([t["final_attn"]] if name == "final_attn"
                          else [t["layer0"][name], t["layer1"][name]]):
                for proj in ("q", "k", "v"):
                    assert layer[proj]["kernel"].shape == (256, width // n)
                    assert (width // n) % hd == 0
                assert layer["out"]["kernel"].shape == (width // n, 256)
                assert layer["out"]["bias"].shape == (256,)
        assert t["layer0"]["mlp"]["fc1"]["kernel"].shape == (256, 2048 // n)
        # an attention: q/k/v kernels and biases, out's kernel; a layer's MLP:
        # fc1's kernel and bias, fc2's kernel
        assert cut == 2 * (3 * 7 + 3) + 7


def test_one_rank_mesh_and_its_errors(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    mesh = mesh_lib.make_mesh(device="cpu")
    try:
        assert mesh.shape == {"data": 1, "model": 1} and mesh.backend == "gloo"
        assert (mesh.rank, mesh.data_index, mesh.model_index) == (0, 0, 0)
        assert torch.distributed.get_world_size(mesh.data_group) == 1
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.make_mesh(2, 1, device="cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.make_mesh()


def test_tensor_parallel_towers_and_tokens_equal_whole(tmp_path):
    """Mesh 1 x 2 on two gloo ranks: DINOv2, the Grad-CAM prior (the
    gradient through sliced blocks), AlphaCLIP and the batched ranker
    within TOL of the whole towers, the taps too, and the sliced towers
    within TOL of the JAX package's sharded ones; ViP-LLaVA's greedy
    tokens equal, float32 and int8 sliced, int4 whole."""
    g = (jvl.TINY.image_size // jvl.TINY.patch_size) ** 2
    ids = np.full((2, 9 + g), 5, np.int64)
    ids[:, 3:3 + g] = jvl.TINY.image_token_index
    ids[1, -4:] = [40, 41, 42, 43]
    payload = {"trees": torch_tiny.jax_trees(0),
               "episodes": torch_tiny.episodes(2, dead=[(1, 3)]),
               "ids": ids, "pix": np.random.RandomState(3).rand(2, 56, 56, 3).astype(np.float32)}
    results = torch_tiny.run_ranks(torch_tiny.tp_worker, 2, tmp_path, payload)
    for out in results:
        assert out["qkv_width"] == 3 * 32 // 2
        for key in ("dino", "dino_tap", "vta", "alphaclip", "ranker_scores"):
            assert out[key] < TOL, (key, out[key])
        assert out["ranker_masks_equal"]
        for name in ("float32", "int8", "int4"):
            got, want = out[f"tokens_{name}"]
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert out["float_q_width"] == jvl.TINY.hidden // 2
        assert out["int4_whole"] == jvl.TINY.hidden
    for name in ("float32", "int8"):
        np.testing.assert_array_equal(results[0][f"tokens_{name}"][0],
                                      results[1][f"tokens_{name}"][0])
    want = _jax_tp_towers(payload, *results[0]["tp_outputs"]["alphaclip_in"])
    for out in results:
        for key, w in want.items():
            np.testing.assert_allclose(out["tp_outputs"][key], w, atol=TOL, rtol=0, err_msg=key)


def _jax_tp_towers(payload, img32, alpha) -> dict:
    """The JAX package's towers with their parameters under
    ``param_shardings`` on a 1 x 2 mesh (``shard_params``; GSPMD partitions
    them, the XLA attention as its runner traces them there) on the
    worker's inputs (AlphaCLIP's resized images and alphas as the worker
    made them): DINOv2's prenorm tokens and tap, the refined Grad-CAM
    priors, AlphaCLIP's embeddings."""
    from mars_tpu.models import layers as jlayers
    from mars_tpu.pipeline import vta as jvta

    trees, ep = payload["trees"], payload["episodes"]
    mesh = jmesh.make_mesh(n_data=1, n_model=2)
    dcfg = jdino.DinoV2Config(**torch_tiny.DINO)
    cvcfg = jclip.ClipVisualConfig(**torch_tiny.CLIP_V)
    acfg = jclip.ClipVisualConfig(**torch_tiny.ALPHA_V)
    vcfg = jvta.VTAConfig(**torch_tiny.VTA)
    scale = jnp.float32(np.log(1 / 0.07))
    with mesh, jlayers.attention_impl("xla"):
        dino = jmesh.shard_params(trees["dino"], mesh)
        out = jax.jit(lambda p, x: jdino.forward_features(p, x, dcfg, attn_tap_last_n=2))(
            dino, jnp.asarray(ep[3]))
        clip_v = jmesh.shard_params(trees["clip_v"], mesh)
        vta = jax.jit(jax.vmap(lambda p, q, t: jvta.compute(p, q, t, scale, cvcfg, vcfg),
                               in_axes=(None, 0, 0)))(clip_v, jnp.asarray(ep[3]),
                                                      jnp.asarray(ep[6]))
        ac = jax.jit(lambda p, x, a: jclip.visual_cls(p, x, acfg, alpha=a))(
            jmesh.shard_params(trees["ac_v"], mesh), jnp.asarray(img32), jnp.asarray(alpha))
    assert "model" in str(dino["block0"]["attn"]["qkv"]["kernel"].sharding.spec)
    return {"dino": np.asarray(out["x_prenorm"]), "dino_tap": np.asarray(out["attn_mean"]),
            "vta": np.asarray(vta), "alphaclip": np.asarray(ac)}

