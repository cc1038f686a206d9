"""The port's retriever (``TextRetriever``, ``PipelinedTextStage``,
``BlockTextStage``) against the JAX package's, both driving the same
scripted VLM that records every request and answers from a table: the
drawn images (bitwise), the prompts (equal strings), the budgets and batch
shapes, the votes and the (name, definition) results, at 1 and 5 shots,
with and without an ensemble (prompt types, colours and zooms), at block
depths 1, 2, 3 and 4, for VLMs with and without batching and shared
prefixes.  WordNet runs on tests/nltk_minicorpus.py's tree."""
import numpy as np
import pytest

from mars_tpu.text import retriever as J
from mars_tpu_torch.text import retriever as T, wordnet
from nltk_minicorpus import ensure_minicorpus

ANSWERS = ("dog", "plant", "sheep", "potted plant", "dog", "person")


class Single:
    """Records (method, image shapes, prompts, max, min, kwargs) per call and
    the images; the answer is keyed by the image's sum and the prompt."""

    def __init__(self, prefix=True):
        self.calls, self.images = [], []
        self.supports_shared_prefix = prefix

    def _answer(self, image, prompt):
        name = ANSWERS[(int(image.astype(np.int64).sum()) + len(prompt)) % len(ANSWERS)]
        if "definition" in prompt:
            return ("a living organism that grows in soil or a pot" if "plant" in prompt
                    else "a domesticated canid mammal kept as a pet")
        return name

    def generate(self, image, prompt, max_new_tokens=20, min_new_tokens=0, **kw):
        self.calls.append(("generate", [image.shape], [prompt], max_new_tokens, min_new_tokens,
                           kw))
        self.images.append([image])
        return self._answer(image, prompt)


class Scripted(Single):
    """Single's answers, with batched requests too."""

    def generate_batch(self, images, prompts, max_new_tokens=20, min_new_tokens=0, **kw):
        self.calls.append(("generate_batch", [im.shape for im in images], list(prompts),
                           max_new_tokens, min_new_tokens, kw))
        self.images.append(list(images))
        return [self._answer(im, pr) for im, pr in zip(images, prompts)]


@pytest.fixture(scope="module", autouse=True)
def port_wordnet(tmp_path_factory):
    wordnet.add_path(ensure_minicorpus(str(tmp_path_factory.mktemp("nltk"))))


def _episodes(n, shots, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        imgs, masks = [], []
        for _ in range(shots):
            imgs.append(rng.randint(0, 256, (48, 56, 3)).astype(np.uint8))
            m = np.zeros((48, 56), np.float32)
            y, x = rng.randint(0, 30, 2)
            m[y:y + rng.randint(4, 18), x:x + rng.randint(4, 24)] = 1
            masks.append(m)
        out.append((imgs, masks))
    return out


def _pair(ensemble, gen=None, batch=True, prefix=True):
    cls = Scripted if batch else Single
    jv, tv = cls(prefix), cls(prefix)
    gen = gen or {}
    jr = J.TextRetriever(jv, gen_cfg=J.PromptGenConfig(**gen),
                         ensemble=J.EnsembleConfig(**ensemble))
    tr = T.TextRetriever(tv, gen_cfg=T.PromptGenConfig(**gen),
                         ensemble=T.EnsembleConfig(**ensemble))
    return (jr, jv), (tr, tv)


def _same_requests(jv, tv):
    assert tv.calls == jv.calls
    assert len(tv.images) == len(jv.images)
    for got, want in zip(tv.images, jv.images):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


ENSEMBLES = [dict(), dict(prompt_types=("bb", "contour", "ellipse")),
             dict(colors=("red", "green", "blue"), zooms=(0, 30, 50)),
             dict(prompt_types=("mask", "ellipse"), colors=("blue",), zooms=(0, 50))]


@pytest.mark.parametrize("ensemble", ENSEMBLES)
@pytest.mark.parametrize("shots", [1, 5])
def test_retriever_equals_jax(ensemble, shots):
    for vlm_kw in (dict(), dict(batch=False), dict(prefix=False)):
        (jr, jv), (tr, tv) = _pair(ensemble, **vlm_kw)
        for imgs, masks in _episodes(2, shots, seed=shots):
            assert tr.get_conceptual_information(imgs, masks) == \
                jr.get_conceptual_information(imgs, masks)
        _same_requests(jv, tv)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("ensemble", ENSEMBLES[:2])
def test_block_stage_equals_jax(depth, ensemble):
    episodes = _episodes(5, 2, seed=depth)
    (jr, jv), (tr, tv) = _pair(ensemble)
    js, ts = J.BlockTextStage(jr, depth=depth), T.BlockTextStage(tr, depth=depth)
    got, want = [], []
    for imgs, masks in episodes:
        got += ts.step(imgs, masks)
        want += js.step(imgs, masks)
        assert len(got) == len(want)
    got += ts.flush()
    want += js.flush()
    assert got == want and len(got) == len(episodes)
    _same_requests(jv, tv)
    # the serial retriever's results, episode by episode
    (_, _), (serial, _) = _pair(ensemble)
    assert got == [serial.get_conceptual_information(i, m) for i, m in episodes]


@pytest.mark.parametrize("ensemble", ENSEMBLES[:3:2])
@pytest.mark.parametrize("batch", [True, False])
def test_pipelined_stage_equals_jax(ensemble, batch):
    episodes = _episodes(4, 1, seed=7)
    (jr, jv), (tr, tv) = _pair(ensemble, batch=batch)
    js, ts = J.PipelinedTextStage(jr), T.PipelinedTextStage(tr)
    got = [ts.step(i, m) for i, m in episodes] + [ts.flush()]
    want = [js.step(i, m) for i, m in episodes] + [js.flush()]
    assert got == want and got[0] is None and ts.flush() is None
    _same_requests(jv, tv)


def test_prompt_config_and_votes():
    """Non-default prompt settings reach the drawn images and prompts; the
    votes break ties by first appearance, as JAX's Counter does."""
    gen = dict(prompt_type="ellipse", color="green", alpha=0.3, thickness=1, zoom_percent=30)
    (jr, jv), (tr, tv) = _pair(dict(), gen=gen)
    for imgs, masks in _episodes(2, 3, seed=9):
        assert tr.get_conceptual_information(imgs, masks) == \
            jr.get_conceptual_information(imgs, masks)
    _same_requests(jv, tv)
    reqs = [(0, None, ""), (0, None, ""), (1, None, ""), (1, None, ""), (2, None, "")]
    for answers in (["a", "b", "b", "a", "c"], ["x", "x", "y", "z", "y"]):
        assert T.TextRetriever._vote(reqs, answers, 3) == jr._vote(reqs, answers, 3)
    assert list(T.EnsembleConfig(colors=("red", "blue"), zooms=(0, 50)).variants(
        T.PromptGenConfig())) == [T.PromptGenConfig(**v.__dict__) for v in J.EnsembleConfig(
            colors=("red", "blue"), zooms=(0, 50)).variants(J.PromptGenConfig())]


def test_oracle_vlm_and_block_depth():
    imgs, masks = _episodes(1, 1)[0]
    assert T.TextRetriever(T.OracleVLM("dog")).get_conceptual_information(imgs, masks) == \
        J.TextRetriever(J.OracleVLM("dog")).get_conceptual_information(imgs, masks)
    with pytest.raises(ValueError):
        T.BlockTextStage(T.TextRetriever(T.OracleVLM("dog")), depth=0)
