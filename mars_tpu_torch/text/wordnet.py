"""WordNet noun lookups, the English stopword list and ``word_tokenize``
without nltk, reading nltk's data tree by path (the port's counterpart of
the nltk calls in ``mars_tpu/text/retriever.py:756-781``).

The data tree is nltk's layout, searched in order: the directories given
to ``add_path`` (``--nltk-path``), then ``$NLTK_DATA`` and the directories
nltk itself searches.  Each resource is a directory or a zip beside it
(``corpora/wordnet/`` or ``corpora/wordnet.zip``), as nltk reads them:

  - ``corpora/wordnet``: the WNDB files ``index.noun``, ``data.noun`` and
    ``noun.exc``: ``synsets(lemma, pos="n")`` with nltk's noun morphy (the
    exception list, else one pass of the detachment rules, and the form
    itself), a synset's ``name()`` (first lemma, pos, sense number of that
    lemma) and ``definition()``, and ``synset(name)``;
  - ``corpora/stopwords/english``: ``stopwords_english()``;
  - ``tokenizers/punkt_tab/english/``: the Punkt parameters
    (abbreviations, collocations, sentence starters, orthographic context)
    of ``sent_tokenize``, both annotation passes; ``word_tokenize`` then
    runs nltk's ``NLTKWordTokenizer`` regexes on each sentence, so a
    period splits from its word only at a sentence's end.

A missing resource raises ``LookupError`` naming the paths searched, as
nltk does.
"""
from __future__ import annotations

import functools
import os
import re
import string
import sys
import zipfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

NOUN = "n"
_PATHS: List[str] = []


def add_path(path: str) -> None:
    """Search ``path`` before the default data directories."""
    if path and path not in _PATHS:
        _PATHS.insert(0, path)
        _load.cache_clear()


def search_paths() -> List[str]:
    """``add_path``'s directories, ``$NLTK_DATA``, then nltk's defaults."""
    paths = list(_PATHS)
    paths += [p for p in os.environ.get("NLTK_DATA", "").split(os.pathsep) if p]
    home = os.path.expanduser("~/")
    if home != "~/":
        paths.append(os.path.join(home, "nltk_data"))
    for base in (sys.prefix, getattr(sys, "base_prefix", sys.prefix)):
        paths += [os.path.join(base, "nltk_data"), os.path.join(base, "share", "nltk_data"),
                  os.path.join(base, "lib", "nltk_data")]
    paths += ["/usr/share/nltk_data", "/usr/local/share/nltk_data", "/usr/lib/nltk_data",
              "/usr/local/lib/nltk_data"]
    return list(dict.fromkeys(paths))


class _Resource:
    """A data directory, or a zip's member directory, by file name."""

    def __init__(self, root: str, zip_path: Optional[str] = None):
        self.root, self.zip_path = root, zip_path

    def read(self, name: str) -> bytes:
        if self.zip_path is None:
            with open(os.path.join(self.root, name), "rb") as f:
                return f.read()
        with zipfile.ZipFile(self.zip_path) as z:
            return z.read(self.root + name)


def find(resource: str) -> _Resource:
    """``resource`` ("corpora/wordnet", "tokenizers/punkt_tab/english") as a
    directory or as a member of ``<first component>/<name>.zip``."""
    searched = search_paths()
    head, _, rest = resource.partition("/")
    name, _, sub = rest.partition("/")
    for base in searched:
        d = os.path.join(base, resource)
        if os.path.isdir(d):
            return _Resource(d)
        z = os.path.join(base, head, name + ".zip")
        if os.path.isfile(z):
            member = name + "/" + (sub + "/" if sub else "")
            with zipfile.ZipFile(z) as f:
                if any(n.startswith(member) for n in f.namelist()):
                    return _Resource(member, z)
    raise LookupError(f"Resource {resource!r} not found.  Searched in:\n"
                      + "\n".join(f"  - {p!r}" for p in searched))


# --------------------------------------------------------------------------
# WordNet (nouns)
# --------------------------------------------------------------------------

_NOUN_RULES = (("s", ""), ("ses", "s"), ("ves", "f"), ("xes", "x"), ("zes", "z"),
               ("ches", "ch"), ("shes", "sh"), ("men", "man"), ("ies", "y"))


class Synset:
    __slots__ = ("_name", "_definition")

    def __init__(self, name: str, definition: str):
        self._name, self._definition = name, definition

    def name(self) -> str:
        return self._name

    def definition(self) -> str:
        return self._definition

    def __repr__(self):
        return f"Synset({self._name!r})"


class WordNet:
    """The noun side of a WNDB database."""

    def __init__(self, res: _Resource):
        self._data = res.read("data.noun")
        self._index: Dict[str, List[int]] = {}
        for line in res.read("index.noun").decode("utf-8").splitlines():
            if not line or line.startswith(" "):
                continue
            tok = line.split()
            n_synsets, n_pointers = int(tok[2]), int(tok[3])
            offsets = tok[6 + n_pointers:6 + n_pointers + n_synsets]
            self._index[tok[0]] = [int(o) for o in offsets]
        self._exc: Dict[str, List[str]] = {}
        for line in res.read("noun.exc").decode("utf-8").splitlines():
            terms = line.split()
            if terms:
                self._exc[terms[0]] = terms[1:]
        self._cache: Dict[int, Synset] = {}

    def _morphy(self, form: str) -> List[str]:
        forms = self._exc[form] if form in self._exc else [
            form[:-len(old)] + new for old, new in _NOUN_RULES if form.endswith(old)]
        out: List[str] = []
        for f in [form] + forms:
            if f in self._index and f not in out:
                out.append(f)
        return out

    def _synset_at(self, offset: int) -> Synset:
        if offset in self._cache:
            return self._cache[offset]
        end = self._data.index(b"\n", offset)
        line = self._data[offset:end].decode("utf-8")
        columns, gloss = line.strip().split("|")
        definition = re.sub(r"[\"].*?[\"]", "", gloss).strip().strip("; ")
        # the name is the first lemma's (its syntactic marker dropped)
        first = re.match(r"(.*?)(\(.*\))?$", columns.split()[4]).group(1).lower()
        sense = self._index[first].index(offset) + 1
        syn = Synset(f"{first}.n.{sense:02d}", definition)
        self._cache[offset] = syn
        return syn

    def synsets(self, lemma: str, pos: str = NOUN) -> List[Synset]:
        if pos != NOUN:
            raise ValueError("only nouns are read")
        return [self._synset_at(off) for form in self._morphy(lemma.lower())
                for off in self._index[form]]

    def synset(self, name: str) -> Synset:
        lemma, pos, num = name.lower().rsplit(".", 2)
        if pos != NOUN or lemma not in self._index:
            raise LookupError(f"no lemma {lemma!r} with part of speech {pos!r}")
        return self._synset_at(self._index[lemma][int(num) - 1])


# --------------------------------------------------------------------------
# Punkt sentence splitting and the word tokenizer
# --------------------------------------------------------------------------

_ORTHO_BEG_UC, _ORTHO_MID_UC, _ORTHO_UNK_UC = 1 << 1, 1 << 2, 1 << 3
_ORTHO_BEG_LC, _ORTHO_MID_LC, _ORTHO_UNK_LC = 1 << 4, 1 << 5, 1 << 6
_ORTHO_UC = _ORTHO_BEG_UC | _ORTHO_MID_UC | _ORTHO_UNK_UC
_ORTHO_LC = _ORTHO_BEG_LC | _ORTHO_MID_LC | _ORTHO_UNK_LC

_NON_WORD = r"(?:[)\";}\]\*:@\'\({\[?!])"
_MULTI_CHAR = r"(?:\-{2,}|\.{2,}|(?:\.\s){2,}\.)"
_WORD_START = r"[^\(\"\`{\[:;&\#\*@\)}\]\-,]"
_PUNKT_WORD = re.compile(r"""(
        %(MultiChar)s
        |
        (?=%(WordStart)s)\S+?
        (?=
            \s|
            $|
            %(NonWord)s|%(MultiChar)s|
            ,(?=$|\s|%(NonWord)s|%(MultiChar)s)
        )
        |
        \S
    )""" % {"NonWord": _NON_WORD, "MultiChar": _MULTI_CHAR, "WordStart": _WORD_START},
    re.UNICODE | re.VERBOSE)
_PERIOD_CONTEXT = re.compile(r"""
        [\.\?!]
        (?=(?P<after_tok>
            %(NonWord)s
            |
            \s+(?P<next_tok>\S+)
        ))""" % {"NonWord": _NON_WORD}, re.UNICODE | re.VERBOSE)
_REALIGN = re.compile(r'["\')\]}]+?(?:\s+|(?=--)|$)', re.MULTILINE)
_RE_ELLIPSIS = re.compile(r"\.\.+$")
_RE_NUMERIC = re.compile(r"^-?[\.,]?\d[\d,\.-]*\.?$")
_RE_INITIAL = re.compile(r"[^\W\d]\.$", re.UNICODE)
_PUNCTUATION = tuple(";:,.!?")
_SENT_END = (".", "?", "!")


class _Token:
    __slots__ = ("tok", "type", "period_final", "sentbreak", "abbr", "ellipsis")

    def __init__(self, tok: str):
        self.tok = tok
        self.type = _RE_NUMERIC.sub("##number##", tok.lower())
        self.period_final = tok.endswith(".")
        self.sentbreak = self.abbr = self.ellipsis = False

    @property
    def type_no_period(self):
        return self.type[:-1] if len(self.type) > 1 and self.type[-1] == "." else self.type

    @property
    def type_no_sentperiod(self):
        return self.type_no_period if self.sentbreak else self.type


class Punkt:
    """nltk's PunktSentenceTokenizer with parameters read from a
    ``punkt_tab`` language directory."""

    def __init__(self, res: _Resource):
        def lines(name):
            text = res.read(name).decode("utf-8")
            return [x[:-1] if x.endswith("\n") else x for x in text.splitlines(True)]

        self.collocations = {tuple(x.split("\t")) for x in lines("collocations.tab")}
        self.sent_starters = set(lines("sent_starters.txt"))
        self.abbrev_types = set(lines("abbrev_types.txt"))
        self.ortho_context = defaultdict(int)
        for x in lines("ortho_context.tab"):
            typ, flag = x.split("\t")
            self.ortho_context[typ] = int(flag)

    def _tokens(self, text: str):
        for line in text.split("\n"):
            if line.strip():
                for tok in _PUNKT_WORD.findall(line):
                    yield _Token(tok)

    def _first_pass(self, t: _Token):
        tok = t.tok
        if tok in _SENT_END:
            t.sentbreak = True
        elif _RE_ELLIPSIS.match(tok):
            t.ellipsis = True
        elif t.period_final and not tok.endswith(".."):
            low = tok[:-1].lower()
            if low in self.abbrev_types or low.split("-")[-1] in self.abbrev_types:
                t.abbr = True
            else:
                t.sentbreak = True

    def _ortho_heuristic(self, t: _Token):
        if t.tok in _PUNCTUATION:
            return False
        ctx = self.ortho_context[t.type_no_sentperiod]
        if t.tok[0].isupper() and (ctx & _ORTHO_LC) and not (ctx & _ORTHO_MID_UC):
            return True
        if t.tok[0].islower() and ((ctx & _ORTHO_UC) or not (ctx & _ORTHO_BEG_LC)):
            return False
        return "unknown"

    def _second_pass(self, t1: _Token, t2: Optional[_Token]):
        if t2 is None or not t1.period_final:
            return
        typ, next_typ = t1.type_no_period, t2.type_no_sentperiod
        initial = _RE_INITIAL.match(t1.tok)
        if (typ, next_typ) in self.collocations:
            t1.sentbreak, t1.abbr = False, True
            return
        if (t1.abbr or t1.ellipsis) and not initial:
            starter = self._ortho_heuristic(t2)
            if starter is True:
                t1.sentbreak = True
                return
            if t2.tok[0].isupper() and next_typ in self.sent_starters:
                t1.sentbreak = True
                return
        if initial or typ == "##number##":
            starter = self._ortho_heuristic(t2)
            if starter is False:
                t1.sentbreak, t1.abbr = False, True
                return
            if (starter == "unknown" and initial and t2.tok[0].isupper()
                    and not (self.ortho_context[next_typ] & _ORTHO_LC)):
                t1.sentbreak, t1.abbr = False, True

    def _contains_sentbreak(self, text: str) -> bool:
        toks = list(self._tokens(text))
        for t in toks:
            self._first_pass(t)
        found = False
        for i, t in enumerate(toks):
            self._second_pass(t, toks[i + 1] if i + 1 < len(toks) else None)
            if found:
                return True
            if t.sentbreak:
                found = True
        return False

    def _end_contexts(self, text: str):
        prev_slice, prev_match = slice(0, 0), None
        for match in _PERIOD_CONTEXT.finditer(text):
            before = text[prev_slice.stop:match.start()]
            last_ws = next((i for i in range(len(before) - 1, -1, -1)
                            if before[i] in string.whitespace), 0)
            start = last_ws + prev_slice.stop + 1 if last_ws else prev_slice.start
            word = slice(start, match.start())
            if prev_match and prev_slice.stop <= word.start:
                yield prev_match, (text[prev_slice] + prev_match.group()
                                   + prev_match.group("after_tok"))
            prev_match, prev_slice = match, word
        if prev_match:
            yield prev_match, text[prev_slice] + prev_match.group() + prev_match.group("after_tok")

    def _slices(self, text: str):
        last = 0
        for match, context in self._end_contexts(text):
            if self._contains_sentbreak(context):
                yield slice(last, match.end())
                last = match.start("next_tok") if match.group("next_tok") else match.end()
        yield slice(last, len(text.rstrip()))

    def tokenize(self, text: str) -> List[str]:
        slices = list(self._slices(text))
        out, realign = [], 0
        for i, s1 in enumerate(slices):
            s1 = slice(s1.start + realign, s1.stop)
            s2 = slices[i + 1] if i + 1 < len(slices) else None
            if s2 is None:
                if text[s1]:
                    out.append(text[s1])
                continue
            m = _REALIGN.match(text[s2])
            if m:
                out.append(text[s1.start:s2.start + len(m.group(0).rstrip())])
                realign = m.end()
            else:
                realign = 0
                if text[s1]:
                    out.append(text[s1])
        return out


_STARTING_QUOTES = [
    (re.compile("([«“‘„]|[`]+)", re.U), r" \1 "),
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
    (re.compile(r"(?i)(\')(?!re|ve|ll|m|t|s|d|n)(\w)\b", re.U), r"\1 \2"),
]
_ENDING_QUOTES = [
    (re.compile("([»”’])", re.U), r" \1 "),
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"\s+"), " "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_WORD_PUNCTUATION = [
    (re.compile(r'([^\.])(\.)([\]\)}>"\'' "»”’ " r"]*)\s*$", re.U), r"\1 \2 \3 "),
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.{2,}", re.U), r" \g<0> "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile("[\u2012-\u2015]", re.U), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"[*]", re.U), r" \g<0> "),
]
_PARENS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_CONTRACTIONS = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b", r"(?i)\b(d)(?#X)('ye)\b", r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b", r"(?i)\b(got)(?#X)(ta)\b", r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b", r"(?i)\b(wan)(?#X)(na)(?=\s)",
    r"(?i) ('t)(?#X)(is)\b", r"(?i) ('t)(?#X)(was)\b")]


def _treebank_words(text: str) -> List[str]:
    """nltk's NLTKWordTokenizer.tokenize on one sentence."""
    for regexp, sub in _STARTING_QUOTES + _WORD_PUNCTUATION + [_PARENS, _DOUBLE_DASHES]:
        text = regexp.sub(sub, text)
    text = " " + text + " "
    for regexp, sub in _ENDING_QUOTES:
        text = regexp.sub(sub, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


# --------------------------------------------------------------------------
# the data tree's readers, cached per search path
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _load(kind: str, paths: Tuple[str, ...]):
    if kind == "wordnet":
        return WordNet(find("corpora/wordnet"))
    if kind == "stopwords":
        text = find("corpora/stopwords").read("english").decode("utf-8")
        return [line for line in text.splitlines() if line.rstrip() and not line.startswith("\n")]
    return Punkt(find("tokenizers/punkt_tab/english"))


def wordnet() -> WordNet:
    return _load("wordnet", tuple(search_paths()))


def stopwords_english() -> List[str]:
    return list(_load("stopwords", tuple(search_paths())))


def sent_tokenize(text: str) -> List[str]:
    return _load("punkt", tuple(search_paths())).tokenize(text)


def word_tokenize(text: str) -> List[str]:
    """nltk.word_tokenize(text) for English."""
    return [tok for sent in sent_tokenize(text) for tok in _treebank_words(sent)]
