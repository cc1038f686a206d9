"""Prompt-lookup speculative decoding in the port
(``mars_tpu_torch.models.vip_llava.generate_greedy(draft_tokens=8,
ngram=3)``) against the JAX package's ``generate_greedy`` on the
transformers fixture ``vip_llava_tiny.npz`` in float32, the weights carried
across by the converter: B = 1 and batched, the acceptance gate off (0) and
on (2), fixed-trip and EOS with EOS floors, per-row prompt lengths, a
shared-prefix resume (copied and in place); the int4, NF4 and int8-KV
variants are in test_torch_speculative_variants.py.  The fixture's greedy
output falls into a repeated token after six steps, so drafts are accepted
and verify rounds run.  Token streams must be equal (exact greedy), to
JAX's and to the port's own ``draft_tokens=0`` streams."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import vip_llava as jvl
from mars_tpu_torch.models import vip_llava as tvl

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
N = 24  # new tokens: the six-token head, then the repeated tail
SPEC = dict(draft_tokens=8, ngram=3)


@pytest.fixture(scope="module")
def model():
    data = np.load(os.path.join(FIXTURES, "vip_llava_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    ids = data["input_ids"]
    pix = np.ascontiguousarray(np.transpose(data["pixels"], (0, 2, 3, 1)))
    # a second row: the same image, other text, two tokens shorter (padded)
    ids2 = np.concatenate([ids, ids])
    ids2[1, -4:] = [9, 7, 9, 0]
    pix2 = np.concatenate([pix, pix])
    return jvl.convert_hf(sd, jvl.TINY), tvl.convert_hf(sd, tvl.TINY), ids, pix, ids2, pix2


def _port(tp, ids, pix, **kw):
    tl = kw.get("true_length")
    if tl is not None and np.ndim(tl):
        kw["true_length"] = np.asarray(tl)
    out = tvl.generate_greedy(tp, torch.from_numpy(ids),
                              None if pix is None else torch.from_numpy(pix), tvl.TINY, **kw)
    return (out[0] if isinstance(out, tuple) else out).numpy()


def _jax(jp, ids, pix, cfg=jvl.TINY, **kw):
    tl = kw.get("true_length")
    if tl is not None:
        kw["true_length"] = jnp.asarray(tl, jnp.int32)
    return np.asarray(jvl.generate_greedy(jp, jnp.asarray(ids),
                                          None if pix is None else jnp.asarray(pix), cfg, **kw))


def _stats():
    tvl.STATS.update(rounds=0, verify_rounds=0, accepted=0)
    return tvl.STATS


@pytest.mark.parametrize("gate", [0, 2])
@pytest.mark.parametrize("eos", [False, True])
def test_one_row_equals_jax_and_plain(model, gate, eos):
    jp, tp, ids, pix, _, _ = model
    kw = dict(max_new_tokens=N)
    if eos:  # no EOS in the first 8 tokens (the stream then cycles through others)
        kw.update(eos_id=4, min_new_tokens=8)
    plain = _port(tp, ids, pix, **kw)
    stats = _stats()
    got = _port(tp, ids, pix, draft_gate=gate, **SPEC, **kw)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _jax(jp, ids, pix, draft_gate=gate, **SPEC, **kw))
    assert stats["verify_rounds"] > 0 and stats["accepted"] > 0
    assert stats["rounds"] < N  # accepted drafts save rounds


@pytest.mark.parametrize("gate,eos", [(0, False), (2, True)])
def test_batched_rows_equal_jax_and_plain(model, gate, eos):
    """Two rows of different lengths (fixed trip; EOS with per-row floors):
    the laggard gate decides each round's verify."""
    jp, tp, _, _, ids2, pix2 = model
    l0 = ids2.shape[1]
    kw = dict(max_new_tokens=N, true_length=[l0, l0 - 2])
    if eos:
        kw.update(eos_id=4, min_new_tokens=(3, 10))
    for kw in (kw,):
        plain = _port(tp, ids2, pix2, **kw)
        stats = _stats()
        got = _port(tp, ids2, pix2, draft_gate=gate, **SPEC, **kw)
        np.testing.assert_array_equal(got, plain, err_msg=str(kw))
        np.testing.assert_array_equal(got, _jax(jp, ids2, pix2, draft_gate=gate, **SPEC, **kw),
                                      err_msg=str(kw))
        assert stats["accepted"] > 0


def test_prefix_resume_copy_and_in_place_equal_jax(model):
    """Suffix decodes resumed from a shared-prefix prefill: copied into
    fresh caches (B = 2) and chained in place (B = 1), speculation on."""
    jp, tp, ids, pix, ids2, pix2 = model
    lp = 19  # BOS, 2 text tokens, 16 image slots
    kw = dict(max_new_tokens=N, eos_id=4, min_new_tokens=8, draft_gate=2, **SPEC)
    kv = tvl.prefill_prefix(tp, torch.from_numpy(ids2[:, :lp]), torch.from_numpy(pix2), tvl.TINY)
    jkv = jvl.prefill_prefix(jp, jnp.asarray(ids2[:, :lp]), jnp.asarray(pix2), jvl.TINY)
    got = _port(tp, ids2[:, lp:], None, prefix_kv=kv, prefix_len=lp, **kw)
    np.testing.assert_array_equal(got, _port(tp, ids2, pix2, **kw))
    np.testing.assert_array_equal(got, _jax(jp, ids2[:, lp:], None, prefix_kv=jkv,
                                            prefix_len=lp, **kw))
    suffix = ids[:, lp:]
    need = lp + suffix.shape[1] + N + SPEC["draft_tokens"] + 1
    buf = tvl.prefill_prefix(tp, torch.from_numpy(ids[:, :lp]), torch.from_numpy(pix), tvl.TINY,
                             max_len=need)
    first, buf = tvl.generate_greedy(tp, torch.from_numpy(suffix), None, tvl.TINY,
                                     prefix_kv=buf, prefix_len=lp, inplace_prefix=True,
                                     return_caches=True, **kw)
    again = tvl.generate_greedy(tp, torch.from_numpy(suffix), None, tvl.TINY, prefix_kv=buf,
                                prefix_len=lp, inplace_prefix=True, **kw)
    want = _port(tp, ids, pix, **kw)
    np.testing.assert_array_equal(first.numpy(), want)
    np.testing.assert_array_equal(again.numpy(), want)  # chained off the first's buffer
    with pytest.raises(ValueError, match="inplace prefix_kv length"):
        small = tvl.prefill_prefix(tp, torch.from_numpy(ids[:, :lp]), torch.from_numpy(pix),
                                   tvl.TINY, max_len=need - 1)
        tvl.generate_greedy(tp, torch.from_numpy(suffix), None, tvl.TINY, prefix_kv=small,
                            prefix_len=lp, inplace_prefix=True, **kw)


def test_lookup_draft_matches_jax():
    """The n-gram lookup, including no match (the buffer's head), a match
    whose continuation runs into unwritten slots, and a clamped slice."""
    from mars_tpu.models.vip_llava import _prompt_lookup_draft as jdraft

    seq = np.asarray([5, 1, 2, 3, 9, 9, 1, 2, 3, 7, 1, 2, 3, -1, -1, -1], np.int64)
    for end in (2, 3, 8, 12, 13, 15):
        for n, k in ((3, 4), (2, 8), (1, 3)):
            want = np.asarray(jdraft(jnp.asarray(seq, jnp.int32), end, n, k))
            np.testing.assert_array_equal(tvl._prompt_lookup_draft(seq, end, n, k), want,
                                          err_msg=f"end={end} n={n} k={k}")
