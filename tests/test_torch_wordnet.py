"""The port's WordNet, stopwords and ``word_tokenize`` (``text/wordnet.py``,
no nltk) against nltk itself, on ``tests/nltk_minicorpus.py``'s tree and on
a larger tree this file writes: plural and irregular nouns (a
``noun.exc``), multi-word lemmas, glosses with quoted examples, several
senses, and a ``punkt_tab`` with abbreviations, collocations, sentence
starters and orthographic context.  Both trees are read as directories and
as zips.  ``get_synset`` is held equal to the JAX package's on a fixed list
of names and descriptions.  Exact equality throughout (strings, lists)."""
import os
import shutil
import tempfile
import zipfile

import pytest
from nltk.corpus.reader import WordListCorpusReader, WordNetCorpusReader
from nltk.data import FileSystemPathPointer
from nltk.tokenize.destructive import NLTKWordTokenizer
from nltk.tokenize.punkt import PunktSentenceTokenizer, load_punkt_params

from mars_tpu.text.retriever import get_synset as jget_synset
from mars_tpu_torch.text import retriever as tret, wordnet as W
from nltk_minicorpus import _STOPWORDS, ensure_minicorpus

# (lemmas, gloss) in data.noun order
SYNSETS = [
    (["dog", "domestic_dog", "Canis_familiaris"],
     'a member of the genus Canis; "the dog barked all night"'),
    (["frank", "hot_dog", "hotdog", "dog"], "a smooth-textured sausage; served on a bun"),
    (["mouse"], "any of numerous small rodents"),
    (["mouse", "computer_mouse"], 'a hand-operated electronic device; "a wireless mouse"'),
    (["goose"], "web-footed long-necked typically gregarious migratory aquatic birds"),
    (["person", "individual", "someone"], "a human being"),
    (["box"], "a (usually rectangular) container; may have a lid"),
    (["leaf", "leafage"], "the main organ of photosynthesis in higher plants"),
    (["church", "church_building"], "a place for public (especially Christian) worship"),
    (["woman", "adult_female"], "an adult female person (as opposed to a man)"),
    (["berry"], "any of numerous small and pulpy edible fruits"),
    (["potted_plant"], "a plant that grows in a pot"),
    (["plant", "flora"], "a living organism lacking the power of locomotion"),
    (["plant", "works"], "buildings for carrying on industrial labor"),
    (["Washington", "George_Washington"], "1st President of the United States"),
    (["dish"], "a piece of dishware normally used as a container for holding food"),
]
EXCEPTIONS = {"mice": ["mouse"], "geese": ["goose"], "people": ["person"],
              "dice": ["die", "dice"], "women": ["woman"]}
ABBREVS = ["e.g", "i.e", "mr", "dr", "u.s", "etc", "vs", "inc", "st"]
COLLOCATIONS = [("##number##", "president"), ("st", "louis")]
STARTERS = ["however", "it", "the", "this"]
ORTHO = {"the": 0b1110010, "washington": 0b0000100, "it": 0b0010010, "pet": 0b0100000,
         "however": 0b0000010, "dog": 0b0100000}
LEMMAS = ["dog", "dogs", "Dogs", "mice", "mouse", "geese", "people", "boxes", "leaves",
          "churches", "women", "berries", "dishes", "hot_dog", "hot dog", "potted_plant",
          "plants", "works", "washington", "canis_familiaris", "dice", "zzz", "glasses", "mans"]
TEXTS = [
    "A dog is a domesticated mammal. It barks at night.",
    "Mr. Smith lives in Washington D.C. and keeps a dog.",
    "The U.S. economy, e.g. its farms, grew 3.5% in 2020... Really? Yes!",
    "It is a small rodent, i.e. a mouse. However, it may be a device.",
    "He met Dr. Jones vs. the 1st president at 5 p.m. It rained.",
    "A plant (a living thing) grows in a pot -- usually indoors.",
    "\"A potted plant,\" she said, 'is green.' It's fine; it isn't dying: no.",
    "J. K. Rowling wrote it. St. Louis is a city. The dog's bowl is empty.",
    "a piece of dishware normally used as a container for holding food",
    "",
]


def _wndb(root):
    """WNDB files for SYNSETS (true byte offsets) beside empty others."""
    d = os.path.join(root, "corpora", "wordnet")
    os.makedirs(d, exist_ok=True)
    lines, offsets, cursor = [], [], 0
    for lemmas, gloss in SYNSETS:
        words = " ".join(f"{w} 0" for w in lemmas)
        line = "%08d 03 n %02x %s 000 | %s  \n" % (cursor, len(lemmas), words, gloss)
        offsets.append(cursor)
        lines.append(line)
        cursor += len(line.encode())
    index = {}
    for (lemmas, _), off in zip(SYNSETS, offsets):
        for w in lemmas:
            index.setdefault(w.lower(), []).append(off)
    files = {"data.noun": "".join(lines),
             "index.noun": "".join("%s n %d 0 %d 0 %s  \n" % (k, len(v), len(v),
                                                             " ".join("%08d" % o for o in v))
                                   for k, v in sorted(index.items())),
             "noun.exc": "".join(f"{k} {' '.join(v)}\n" for k, v in sorted(EXCEPTIONS.items())),
             "lexnames": "".join("%02d\t%s\t%d\n" % (i, n, 1 + (i > 2)) for i, n in
                                 enumerate(("adj.all", "adj.pert", "adv.all", "noun.animal")))}
    for empty in ("index.verb", "index.adj", "index.adv", "data.verb", "data.adj", "data.adv",
                  "verb.exc", "adj.exc", "adv.exc", "cntlist.rev", "index.sense"):
        files[empty] = ""
    for name, text in files.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    sw = os.path.join(root, "corpora", "stopwords")
    os.makedirs(sw, exist_ok=True)
    with open(os.path.join(sw, "english"), "w") as f:
        f.write("\n".join(_STOPWORDS + ["its", "it's"]) + "\n\n")
    pk = os.path.join(root, "tokenizers", "punkt_tab", "english")
    os.makedirs(pk, exist_ok=True)
    for name, rows in (("abbrev_types.txt", ABBREVS), ("sent_starters.txt", STARTERS),
                       ("collocations.tab", ["\t".join(c) for c in COLLOCATIONS]),
                       ("ortho_context.tab", [f"{k}\t{v}" for k, v in ORTHO.items()])):
        with open(os.path.join(pk, name), "w") as f:
            f.write("\n".join(rows))
    return root


def _zipped(root, out):
    """The tree's three resources as nltk's zips."""
    for res, base in (("corpora/wordnet", "corpora"), ("corpora/stopwords", "corpora"),
                      ("tokenizers/punkt_tab", "tokenizers")):
        os.makedirs(os.path.join(out, base), exist_ok=True)
        src = os.path.join(root, res)
        name = os.path.basename(res)
        with zipfile.ZipFile(os.path.join(out, base, name + ".zip"), "w") as z:
            for dirpath, _, files in os.walk(src):
                for fn in files:
                    full = os.path.join(dirpath, fn)
                    z.write(full, os.path.join(name, os.path.relpath(full, src)))
    return out


@pytest.fixture(scope="module")
def trees():
    tmp = tempfile.mkdtemp(prefix="wn_trees_")
    mini = ensure_minicorpus(os.path.join(tmp, "mini"))
    big = _wndb(os.path.join(tmp, "big"))
    yield {"mini": mini, "big": big, "big_zip": _zipped(big, os.path.join(tmp, "big_zip"))}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture
def port_on(monkeypatch):
    def use(root):
        monkeypatch.setattr(W, "_PATHS", [root])
        return W
    return use


def _nltk(root):
    """nltk's own readers over ``root`` (the directory form)."""
    wn = WordNetCorpusReader(os.path.join(root, "corpora", "wordnet"), None)
    sw = WordListCorpusReader(os.path.join(root, "corpora", "stopwords"), ["english"])
    punkt = PunktSentenceTokenizer()
    punkt._params = load_punkt_params(
        FileSystemPathPointer(os.path.join(root, "tokenizers", "punkt_tab", "english")))
    words = NLTKWordTokenizer()
    return wn, sw, (lambda t: punkt.tokenize(t)), (lambda t: [w for s in punkt.tokenize(t)
                                                              for w in words.tokenize(s)])


@pytest.mark.parametrize("tree,form", [("mini", "mini"), ("big", "big"), ("big", "big_zip")])
def test_synsets_names_definitions_equal_nltk(trees, port_on, tree, form):
    wn, _, _, _ = _nltk(trees[tree])
    port = port_on(trees[form]).wordnet()
    for lemma in LEMMAS + ["plant", "sheep", "frank", "domestic_dog"]:
        want = wn.synsets(lemma, pos=wn.NOUN)
        got = port.synsets(lemma)
        assert [s.name() for s in got] == [s.name() for s in want], lemma
        assert [s.definition() for s in got] == [s.definition() for s in want], lemma
        for s in want:
            assert port.synset(s.name()).definition() == wn.synset(s.name()).definition()


@pytest.mark.parametrize("tree,form", [("mini", "mini"), ("big", "big"), ("big", "big_zip")])
def test_stopwords_and_tokenizers_equal_nltk(trees, port_on, tree, form):
    _, sw, sents, words = _nltk(trees[tree])
    port = port_on(trees[form])
    assert port.stopwords_english() == sw.words("english")
    for text in TEXTS + [t.lower() for t in TEXTS]:
        assert port.sent_tokenize(text) == sents(text), text
        assert port.word_tokenize(text) == words(text), text


def test_big_tree_exercises_punkt(trees, port_on):
    """The abbreviation, collocation and starter rules decide splits here:
    'Mr.' and 'e.g.' keep their periods, a period ends only sentences."""
    port = port_on(trees["big"])
    toks = port.word_tokenize("Mr. Smith keeps a dog, e.g. a pet. It barks.")
    assert toks[:2] == ["Mr.", "Smith"] and "e.g." in toks and toks.count(".") == 2
    assert len(port.sent_tokenize(TEXTS[3])) == 2


NAMES = [("dog", "a domesticated canid kept as a pet"), ("dogs", "a sausage on a bun"),
         ("potted plant", "a plant in a pot"), ("potted plant", "a manufacturing building"),
         ("Sheep", "woolly"), ("hot dog", "food"), ("frank", "a sausage"), ("person", "x"),
         ("zzzqqqxx", "nothing"), ("plant", "industrial labor in buildings"),
         ("plant", "a living organism that grows in soil"), ("", "")]


def test_get_synset_and_finish_equal_jax(trees, port_on):
    """On the mini tree (nltk's data path in this suite): the port's
    get_synset and the retriever's WordNet resolution equal JAX's."""
    port_on(trees["mini"])
    from mars_tpu.text.retriever import TextRetriever as JRetriever

    for name, desc in NAMES:
        assert tret.get_synset(name, desc) == jget_synset(name, desc), (name, desc)
        assert tret.TextRetriever._finish(name, desc) == JRetriever._finish(name, desc)


def test_missing_tree_raises_lookup_error(tmp_path, monkeypatch):
    monkeypatch.setattr(W, "_PATHS", [str(tmp_path)])
    monkeypatch.setattr(W, "search_paths", lambda: [str(tmp_path)])
    with pytest.raises(LookupError, match=str(tmp_path)):
        W.wordnet()
    with pytest.raises(LookupError, match="punkt_tab"):
        W.word_tokenize("a dog.")
    with pytest.raises(LookupError, match="stopwords"):
        tret.get_synset("dog", "a dog")
