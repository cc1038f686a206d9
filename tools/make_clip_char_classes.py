"""Write ``mars_tpu_torch/text/clip_char_classes.py``: how CLIP's
pre-tokenising pattern, as the ``regex`` package matches it, classes every
code point.

OpenAI's CLIP splits lower-cased text with ``regex`` and the pattern

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

under IGNORECASE, after collapsing ``\\s+`` to one space.  The port's
tokenizer runs where ``regex`` is not installed, so it reads the classes
from the table this script writes (from ``regex``'s own Unicode tables,
which are newer than Python's ``unicodedata``): L (letter), N (number),
S (``\\s``), O (the pattern's last class) or X (no class: the character is
skipped), as runs of code points; and the characters IGNORECASE lets stand
for each letter of the special tokens and contractions.

Run where ``regex`` is installed:  python tools/make_clip_char_classes.py
"""
import os

import regex

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "mars_tpu_torch",
                   "text", "clip_char_classes.py")
LETTERS = sorted(set("startoftext" "endoftext" "strevmld"))


def klass(ch: str) -> str:
    hits = [name for name, pat in (("L", r"(?i)[\p{L}]"), ("N", r"(?i)[\p{N}]"),
                                   ("O", r"(?i)[^\s\p{L}\p{N}]"), ("S", r"\s"))
            if regex.fullmatch(pat, ch)]
    if len(hits) > 1:
        raise SystemExit(f"U+{ord(ch):04X} is in more than one class: {hits}")
    return hits[0] if hits else "X"


def main():
    starts, classes = [], []
    for cp in range(0x110000):
        k = klass(chr(cp))
        if not classes or classes[-1] != k:
            starts.append(cp)
            classes.append(k)
    folds = {c: "".join(chr(cp) for cp in range(0x110000) if regex.fullmatch("(?i)" + c, chr(cp)))
             for c in LETTERS}
    lines = [f'"""Generated by tools/make_clip_char_classes.py from regex {regex.__version__}:',
             "CLIP's pre-tokenising classes of every code point, as runs (see the",
             'tool\'s docstring).  Do not edit."""', "",
             f"REGEX_VERSION = {regex.__version__!r}",
             f"CLASSES = {''.join(classes)!r}", "STARTS = ("]
    for i in range(0, len(starts), 12):
        lines.append("    " + ", ".join(str(s) for s in starts[i:i + 12]) + ",")
    lines += [")", f"FOLDS = {folds!r}", ""]
    with open(OUT, "w") as f:
        f.write("\n".join(lines))
    print(f"{len(starts)} runs -> {OUT}")


if __name__ == "__main__":
    main()
