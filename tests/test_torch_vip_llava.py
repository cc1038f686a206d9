"""The port's ViP-LLaVA (``mars_tpu_torch.models.vip_llava``) and its
retriever backend against the transformers fixture and the JAX package:
logits, greedy tokens, the quantized VLMs, EOS and min-token rules, per-row
lengths, prefix resume, in-place chaining, and the batched shared-prefix
path, all on the CPU at tiny sizes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import quantization as JQ
from mars_tpu.models import vip_llava as jvl
from mars_tpu_torch.models import convert, vip_llava as tvl
from mars_tpu_torch.text import retriever as tret

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# dims that are multiples of 64, so every quantized kernel takes NF4
SMALL = tvl.VipLlavaConfig(
    v_hidden=64, v_intermediate=128, v_layers=2, v_heads=2, image_size=56, patch_size=14,
    vision_feature_layers=(-1, -2), hidden=128, intermediate=256, layers=2, heads=4,
    kv_heads=2, vocab=160, image_token_index=150)
JSMALL = jvl.VipLlavaConfig(**{f: getattr(SMALL, f) for f in SMALL.__dataclass_fields__})


def _fixture():
    data = np.load(os.path.join(FIXTURES, "vip_llava_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd.")}


def _jax_tree(tree):
    """A tensor tree as JAX arrays (float32 random weights drawn by the
    port's seeded init, so the JAX side pays for no per-shape draws)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _random_pair(seed, cfg, jcfg):
    tp = tvl.init_random_params(seed, cfg, dtype=torch.float32, device="cpu")
    return _jax_tree(tp), tp


_jax_logits = jax.jit(jvl.forward_logits, static_argnums=3)


def _tok(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


@pytest.fixture(scope="module")
def fixture_model():
    sd, d = _fixture()
    pix = np.ascontiguousarray(np.transpose(d["pixels"], (0, 2, 3, 1)))
    return (jvl.convert_hf(sd, jvl.TINY), tvl.convert_hf(sd, tvl.TINY), d,
            d["input_ids"], pix)


def test_forward_logits_match_fixture_and_jax(fixture_model):
    jp, tp, d, ids, pix = fixture_model
    got = tvl.forward_logits(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY)
    np.testing.assert_allclose(got.numpy(), d["logits"], atol=2e-4, rtol=1e-3)
    want = np.asarray(_jax_logits(jp, jnp.asarray(ids), jnp.asarray(pix), jvl.TINY))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_greedy_tokens_match_fixture_and_jax(fixture_model):
    jp, tp, d, ids, pix = fixture_model
    got = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY,
                              max_new_tokens=6)
    np.testing.assert_array_equal(_tok(got)[0], d["generated"][0])
    want = jvl.generate_greedy(jp, jnp.asarray(ids), jnp.asarray(pix), jvl.TINY,
                               max_new_tokens=6)
    np.testing.assert_array_equal(_tok(got), np.asarray(want))


def _small_inputs(b=1, seed=0):
    g = (SMALL.image_size // SMALL.patch_size) ** 2
    ids = np.full((b, 9 + g), 5, np.int64)
    ids[:, 3:3 + g] = SMALL.image_token_index
    ids[:, 3 + g:] = np.arange(20, 26) + 7 * np.arange(b)[:, None]
    pix = np.random.RandomState(seed).rand(b, 56, 56, 3).astype(np.float32)
    return ids, pix


@pytest.mark.parametrize("bits,fmt", [(8, "affine"), (4, "affine"), (4, "nf4")])
def test_quantized_vlm_greedy_tokens_equal_jax(bits, fmt):
    jp = JQ.quantize_params(_random_pair(3, SMALL, JSMALL)[0], bits=bits, min_size=64,
                            int4_format=fmt)
    tp = convert.from_jax_params(jp)
    kinds = {tuple(sorted(v["kernel"])) for v in _dense_leaves(tp)}
    assert kinds == {{8: ("q", "scale"), 4: ("q4", "scale")}[bits] if fmt == "affine"
                     else ("bscale", "nf4")}
    ids, pix = _small_inputs()
    got = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), SMALL,
                              max_new_tokens=5)
    want = jvl.generate_greedy(jp, jnp.asarray(ids), jnp.asarray(pix), JSMALL, max_new_tokens=5)
    np.testing.assert_array_equal(_tok(got), np.asarray(want))


def _dense_leaves(tree):
    if isinstance(tree, dict):
        if "kernel" in tree and isinstance(tree["kernel"], dict):
            yield tree
        else:
            for v in tree.values():
                yield from _dense_leaves(v)


@pytest.fixture(scope="module")
def tiny_random():
    """One float32 random TINY model in both packages."""
    jp, tp = _random_pair(11, tvl.TINY, jvl.TINY)
    g = (jvl.TINY.image_size // jvl.TINY.patch_size) ** 2
    lp = 2 + g
    ids = np.full((2, lp + 7), 5, np.int64)
    ids[:, 1:1 + g] = jvl.TINY.image_token_index
    ids[0, lp:] = np.arange(40, 47)
    ids[1, lp:] = np.arange(60, 67)
    pix = np.random.RandomState(5).rand(2, 56, 56, 3).astype(np.float32)
    return jp, tp, ids, pix, lp


def _both(tiny_random, rows=1, **kw):
    """(port tokens, JAX tokens) of one generate_greedy call; ``true_length``
    given as a numpy array is per row."""
    jp, tp, ids, pix, _ = tiny_random
    ids, pix = ids[:rows], pix[:rows]
    tl = kw.pop("true_length", None)
    if tl is not None:
        pad = np.pad(ids, ((0, 0), (0, 5)), constant_values=9)
        ids = pad
    got = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY,
                              true_length=tl, **kw)
    want = jvl.generate_greedy(jp, jnp.asarray(ids), jnp.asarray(pix), jvl.TINY,
                               true_length=None if tl is None else jnp.asarray(tl, jnp.int32),
                               **kw)
    return _tok(got), np.asarray(want)


def test_eos_freeze_and_min_new_tokens_match_jax(tiny_random):
    ref, want = _both(tiny_random, max_new_tokens=6)
    np.testing.assert_array_equal(ref, want)
    eos = int(ref[0, 2])
    j = list(ref[0]).index(eos)
    got, want = _both(tiny_random, max_new_tokens=6, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], list(ref[0, :j + 1]) + [eos] * (5 - j))
    got, want = _both(tiny_random, max_new_tokens=6, eos_id=int(ref[0, 0]), min_new_tokens=3)
    np.testing.assert_array_equal(got, want)
    assert not (got[0, :3] == ref[0, 0]).any()


def test_per_row_true_length_and_min_new_tokens_match_jax(tiny_random):
    l0 = tiny_random[2].shape[1]
    _, tp, ids, pix, _ = tiny_random
    ref = _tok(tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY,
                                   max_new_tokens=6))
    eos = int(ref[0, 0])
    for kw in (dict(eos_id=eos, min_new_tokens=(0, 3)),
               dict(eos_id=int(ref[1, 2]), min_new_tokens=2)):
        got, want = _both(tiny_random, rows=2, max_new_tokens=6,
                          true_length=np.asarray([l0, l0 - 2]), **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    got, want = _both(tiny_random, rows=1, max_new_tokens=6, true_length=l0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref[:1])


def test_prefix_resume_and_inplace_chaining_match_jax(tiny_random):
    """prefill_prefix + suffix decode (copy path) and the in-place chained
    name → definition flow equal the full-prompt decode and JAX's; the copy
    path leaves the prefix buffer as it was."""
    jp, tp, ids, pix, lp = tiny_random
    ref = _tok(tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY,
                                   max_new_tokens=6))
    eos = int(ref[0, 2])
    prefix, suffix = torch.from_numpy(ids[:, :lp]), torch.from_numpy(ids[:, lp:])
    kv = tvl.prefill_prefix(tp, prefix, torch.from_numpy(pix), tvl.TINY)
    snapshot = [tuple(b.clone() for b in c) for c in kv]
    jkv = jvl.prefill_prefix(jp, jnp.asarray(ids[:, :lp]), jnp.asarray(pix), jvl.TINY)
    for kw in (dict(max_new_tokens=6), dict(max_new_tokens=6, eos_id=eos),
               dict(max_new_tokens=6, eos_id=eos, min_new_tokens=4)):
        full = _tok(tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix),
                                        tvl.TINY, **kw))
        split = _tok(tvl.generate_greedy(tp, suffix, None, tvl.TINY, prefix_kv=kv,
                                         prefix_len=lp, **kw))
        jsplit = np.asarray(jvl.generate_greedy(jp, jnp.asarray(ids[:, lp:]), None, jvl.TINY,
                                                prefix_kv=jkv, prefix_len=lp, **kw))
        np.testing.assert_array_equal(split, full, err_msg=str(kw))
        np.testing.assert_array_equal(split, jsplit, err_msg=str(kw))
    for c, s in zip(kv, snapshot):
        assert all(torch.equal(b, sb) for b, sb in zip(c, s))

    n_name, n_def = 4, 8
    for kw in (dict(), dict(eos_id=eos), dict(eos_id=eos, min_new_tokens=3)):
        name_ref = _tok(tvl.generate_greedy(tp, suffix, None, tvl.TINY, max_new_tokens=n_name,
                                            prefix_kv=kv, prefix_len=lp, **kw))
        def_ref = _tok(tvl.generate_greedy(tp, suffix, None, tvl.TINY, max_new_tokens=n_def,
                                           prefix_kv=kv, prefix_len=lp, **kw))
        buf = tvl.prefill_prefix(tp, prefix, torch.from_numpy(pix), tvl.TINY,
                                 max_len=lp + suffix.shape[1] + n_def)
        name, buf2 = tvl.generate_greedy(tp, suffix, None, tvl.TINY, max_new_tokens=n_name,
                                         prefix_kv=buf, prefix_len=lp, inplace_prefix=True,
                                         return_caches=True, **kw)
        assert buf2 is buf and buf2[0][0] is buf[0][0]  # written in place, handed back
        dfn = tvl.generate_greedy(tp, suffix, None, tvl.TINY, max_new_tokens=n_def,
                                  prefix_kv=buf2, prefix_len=lp, inplace_prefix=True, **kw)
        np.testing.assert_array_equal(_tok(name), name_ref, err_msg=str(kw))
        np.testing.assert_array_equal(_tok(dfn), def_ref, err_msg=str(kw))
        if kw:
            continue  # JAX's chained tokens equal its copy-path tokens (its own tests)
        jname = jvl.generate_greedy(jp, jnp.asarray(ids[:, lp:]), None, jvl.TINY,
                                    max_new_tokens=n_name, prefix_kv=jkv, prefix_len=lp, **kw)
        np.testing.assert_array_equal(_tok(name), np.asarray(jname), err_msg=str(kw))


def test_argmax_takes_the_first_of_tied_maxima():
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 5.0, 5.0, 5.0], [0.0, -1.0, 2.0, 2.0],
                          [float("-inf"), 1.0, float("-inf"), 1.0]], dtype=dtype)
        assert tvl._argmax_first(x).tolist() == [1, 0, 2, 1]
        # the tie survives the bf16 rounding of nearby logits
        y = torch.tensor([[0.1, 1.00390625, 1.0, 0.2]]).to(dtype)
        assert tvl._argmax_first(y).item() == int(np.argmax(y.float().numpy()))


def test_unported_options_raise(tiny_random):
    """Speculation and the int8 KV cache are ported (test_torch_speculative*);
    what still raises: a ViP-LLaVA without its checkpoint and processor
    files (not in the repository), and a KV width other than 8 or 16."""
    _, tp, ids, pix, _ = tiny_random
    with pytest.raises(ValueError, match="kv_bits"):
        tvl.prefill_prefix(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY,
                           kv_bits=4)
    with pytest.raises(ValueError, match="inplace_prefix needs prefix_kv"):
        tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY,
                            draft_tokens=3, inplace_prefix=True)
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        tret.TorchVipLlava()


class _StubTok:
    eos_token_id = None

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in toks)


class _StubProcessor:
    """tests/test_text.py's stand-in processor: numpy images, no PIL."""
    tokenizer = _StubTok()

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, text, images, return_tensors="np"):
        g = (self.cfg.image_size // self.cfg.patch_size) ** 2
        left, _, right = text.partition("<image>")
        ids = ([1] + [ord(c) % 50 + 10 for c in left] + [self.cfg.image_token_index] * g
               + [ord(c) % 50 + 10 for c in right])
        arr = np.asarray(images, np.float32)[None] / 255.0
        return {"input_ids": np.asarray([ids], np.int64),
                "pixel_values": np.transpose(arr, (0, 3, 1, 2))}


def test_generate_batch_shared_prefix_matches_plain_and_prefills_once(monkeypatch):
    cfg = tvl.TINY
    params = tvl.init_random_params(21, cfg, dtype=torch.float32, device="cpu")
    vlm = tret.TorchVipLlava(params=params, cfg=cfg, processor=_StubProcessor(cfg))
    rs = np.random.RandomState(11)
    imgs = [(rs.rand(56, 56, 3) * 255).astype(np.uint8) for _ in range(3)]
    pfx = "Human: <image>\n"
    names = [pfx + "name it\nAssistant:", pfx + "what is in the red box here?\nAssistant:",
             pfx + "define\nAssistant:"]
    defs = [pfx + "give the definition of the thing\nAssistant:"] * 3
    plain_names = vlm.generate_batch(imgs, names, max_new_tokens=8)
    plain_defs = vlm.generate_batch(imgs, defs, max_new_tokens=8, min_new_tokens=3)
    assert not vlm._batch_prefix_cache

    calls = []
    real = tvl.prefill_prefix
    monkeypatch.setattr(tvl, "prefill_prefix",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    assert vlm.generate_batch(imgs, names, max_new_tokens=8, shared_prefix=pfx) == plain_names
    assert calls == [1]
    assert vlm.generate_batch(imgs, defs, max_new_tokens=8, min_new_tokens=3,
                              shared_prefix=pfx) == plain_defs
    assert calls == [1]  # the definitions chain off the names' buffer
    odd = ["Different: <image>\nwhatever\nAssistant:"] + names[1:]
    assert vlm.generate_batch(imgs, odd, max_new_tokens=8, shared_prefix=pfx) == \
        vlm.generate_batch(imgs, odd, max_new_tokens=8)
    assert calls == [1]  # no prefill on a prefix mismatch
    # single queries: the shared prefix is prefilled once per image
    one = [vlm.generate(imgs[0], q, max_new_tokens=6) for q in (names[0], defs[0])]
    assert [vlm.generate(imgs[0], q, max_new_tokens=6, shared_prefix=pfx)
            for q in (names[0], defs[0])] == one
    assert calls == [1, 1]


def test_torch_vlm_casts_then_quantizes():
    """TorchVipLlava(dtype=, quantize_bits=) casts the floating leaves and
    then quantizes, as JaxVipLlava does: NF4 codes int8, block scales
    float32, everything else bfloat16; the decode runs on that tree."""
    from mars_tpu.models.precision import cast_floating as jcast
    from mars_tpu_torch.models.precision import cast_floating

    params = tvl.init_random_params(5, SMALL, dtype=torch.float32, device="cpu")
    cast = cast_floating(params, torch.bfloat16)
    want = jcast(_jax_tree(params), jnp.bfloat16)
    np.testing.assert_array_equal(
        cast["language"]["layer0"]["mlp"]["up"]["kernel"].float().numpy(),
        np.asarray(want["language"]["layer0"]["mlp"]["up"]["kernel"].astype(jnp.float32)))
    vlm = tret.TorchVipLlava(params=params, cfg=SMALL, dtype=torch.bfloat16, quantize_bits=4,
                             int4_format="nf4", processor=_StubProcessor(SMALL))
    leaf = vlm.params["language"]["layer0"]["mlp"]["up"]["kernel"]
    assert leaf["nf4"].dtype == torch.int8 and leaf["bscale"].dtype == torch.float32
    assert vlm.params["language"]["lm_head"].dtype == torch.bfloat16
    small = vlm.params["language"]["layer0"]["attn"]["k"]["kernel"]  # 128 x 64 < 2^14
    assert isinstance(small, torch.Tensor) and small.dtype == torch.bfloat16
    img = (np.random.RandomState(2).rand(56, 56, 3) * 255).astype(np.uint8)
    out = vlm.generate_batch([img, img], ["Human: <image>\nname\nAssistant:"] * 2,
                             max_new_tokens=3)
    assert len(out) == 2 and out[0] == out[1] and len(out[0].split()) == 3
