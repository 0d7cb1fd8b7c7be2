"""A reader of byte-level BPE ``tokenizer.json`` files: the ids of
``tokenizers.Tokenizer.from_file(path).encode(text).ids`` without the
``tokenizers`` package (Chameleon's ``text_tokenizer.json``).

    tok = TextTokenizer.from_file("tokenizer/text_tokenizer.json")
    ids = tok.encode("a red fox")

``encode`` runs the library's pipeline: the added tokens are cut out first
(the ones with ``normalized: false`` from the raw text, then the others from
each normalized piece; leftmost-longest, with their ``single_word``,
``lstrip`` and ``rstrip`` rules), the normalizer, the pre-tokenizer, the BPE
model on every piece, then the post-processor's template (``encode`` adds
special tokens by default). Supported components:

* model ``BPE``: merges as ``"a b"`` strings or ``[a, b]`` pairs,
  ``ignore_merges``, ``unk_token``, ``fuse_unk``, ``byte_fallback``,
  ``continuing_subword_prefix``, ``end_of_word_suffix``; ``dropout`` must be
  null (a random merge is refused);
* normalizers: none, ``NFC``, ``NFKC``, ``Replace``, ``Sequence``;
* pre-tokenizers: none, ``ByteLevel`` (``add_prefix_space``, ``use_regex``
  with GPT-2's pattern), ``Split`` (a ``String`` or ``Regex`` pattern, every
  ``behavior``, ``invert``), ``Digits``, ``Sequence``;
* post-processors: none, ``ByteLevel`` (ids unchanged),
  ``TemplateProcessing`` (the ``single`` template).

Any other component type, a truncation or a padding raises ``ValueError``
naming its place in the JSON, so a file that needs more fails at load
instead of tokenizing differently.

The library's regex engine (Oniguruma) is not Python's ``re``: a pattern is
translated, with ``\\p{..}``, ``\\s`` and ``\\d`` as the library's classes
(``\\s`` is Unicode White_Space: not ``\\x1c-\\x1f``, which ``re``'s ``\\s``
takes; ``\\p{N}`` takes ``²`` and ``٣``, ``re``'s ``\\d`` misses ``²``), built
once from ``unicodedata`` plus the letters and digits of Unicode 16.0 that
Python 3.12's tables lack. ``^`` and ``$`` are line anchors, as in Ruby
syntax. ``\\w``, ``\\b`` and other escapes whose meaning differs raise.
Normalization uses Python's Unicode tables.
"""

from __future__ import annotations

import functools
import json
import re
import sys
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Unicode White_Space: the library's \s and Rust's char::is_whitespace
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680), (0x2000, 0x200A),
                (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
# Unicode 16.0 letters, marks and decimal digits that Python 3.12's unicodedata (15.0) does not know
_L_16 = ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3), (0x10D4A, 0x10D65),
         (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
         (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0),
         (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
         (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_M_16 = ((0x897, 0x897), (0x10D69, 0x10D6D), (0x10EFC, 0x10EFC), (0x113B8, 0x113C0), (0x113C2, 0x113C2),
         (0x113C5, 0x113C5), (0x113C7, 0x113CA), (0x113CC, 0x113D0), (0x113D2, 0x113D2), (0x113E1, 0x113E2),
         (0x11F5A, 0x11F5A), (0x1611E, 0x1612F), (0x1E5EE, 0x1E5EF))
_ND_16 = ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139), (0x16D70, 0x16D79),
          (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA))
# Other_Alphabetic characters outside the marks (circled and squared letters)
_OTHER_ALPHA = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))
_JOIN_CONTROL = ((0x200C, 0x200D),)
_MAX = sys.maxunicode

# GPT-2's pre-tokenizer pattern (the library's ByteLevel with use_regex)
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


@functools.lru_cache(maxsize=None)
def _categories() -> Dict[str, Tuple[Tuple[int, int], ...]]:
    """Code-point ranges of every general category (Python's tables)."""
    out: Dict[str, List[List[int]]] = {}
    last = None
    for c in range(_MAX + 1):
        cat = unicodedata.category(chr(c))
        if cat == last:
            out[cat][-1][1] = c
        else:
            out.setdefault(cat, []).append([c, c])
            last = cat
    return {k: tuple((a, b) for a, b in v) for k, v in out.items()}


def _merge(ranges) -> Tuple[Tuple[int, int], ...]:
    out: List[List[int]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return tuple((a, b) for a, b in out)


def _complement(ranges) -> Tuple[Tuple[int, int], ...]:
    out, nxt = [], 0
    for a, b in _merge(ranges):
        if a > nxt:
            out.append((nxt, a - 1))
        nxt = b + 1
    if nxt <= _MAX:
        out.append((nxt, _MAX))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def char_class(name: str) -> Tuple[Tuple[int, int], ...]:
    """The code-point ranges of the library's ``\\p{name}`` (a general
    category or its one-letter group), ``s`` (White_Space), ``d`` (decimal
    digits) or ``word`` (Alphabetic, marks, decimal digits, connector
    punctuation and join controls: the added tokens' ``single_word``
    boundary)."""
    cats = _categories()
    if name == "s":
        return _merge(_WHITE_SPACE)
    if name == "word":
        return _merge(char_class("L") + char_class("M") + char_class("d") + cats["Nl"] + cats["Pc"] + _OTHER_ALPHA
                      + _JOIN_CONTROL)
    extra = {"L": _L_16, "M": _M_16, "N": _ND_16, "Nd": _ND_16, "d": _ND_16}.get(name, ())
    if name == "d":
        name = "Nd"
    picked = [r for cat, rs in cats.items() if cat == name or (len(name) == 1 and cat[0] == name) for r in rs]
    if not picked:
        raise ValueError(f"unknown character property {name!r}")
    return _merge(picked + list(extra))


def _in(ranges, c: str) -> bool:
    o = ord(c)
    lo, hi = 0, len(ranges)
    while lo < hi:
        mid = (lo + hi) // 2
        if ranges[mid][1] < o:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(ranges) and ranges[lo][0] <= o


def _is_space(c: str) -> bool:
    return _in(char_class("s"), c)


def _is_word(c: str) -> bool:
    return _in(char_class("word"), c)


def _is_numeric(c: str) -> bool:  # Rust's char::is_numeric: Nd, Nl and No
    return _in(char_class("N"), c)


def _class_body(ranges) -> str:
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges)


_ESCAPE_CLASSES = {"s": ("s", False), "S": ("s", True), "d": ("d", False), "D": ("d", True)}
_REFUSED_ESCAPES = set("wWbBhHRXKGzZAyYk")


def translate_regex(pattern: str, where: str = "regex") -> "re.Pattern":
    """An Oniguruma pattern (the library's engine, Ruby syntax) as a
    compiled Python pattern with the library's character classes."""
    out, i, depth = [], 0, 0  # depth: inside a [...] class
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    end = pattern.index("}", i + 2)
                    name, i = pattern[i + 3:end], end + 1
                else:
                    name, i = pattern[i + 2], i + 3
                neg = e == "P"
                if name.startswith("^"):
                    name, neg = name[1:], not neg
                try:
                    ranges = char_class(name)
                except ValueError as err:
                    raise ValueError(f"{where}: {err} in {pattern!r}") from None
            elif e in _ESCAPE_CLASSES:
                name, neg = _ESCAPE_CLASSES[e]
                ranges, i = char_class(name), i + 2
            elif e in _REFUSED_ESCAPES:
                raise ValueError(f"{where}: the escape \\{e} of {pattern!r} is not supported")
            elif e == "x" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i + 2)
                out.append(f"\\U{int(pattern[i + 3:end], 16):08x}")
                i = end + 1
                continue
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            ranges = _complement(ranges) if neg else ranges
            out.append(_class_body(ranges) if depth else f"[{_class_body(ranges)}]")
            continue
        if depth:
            if c == "[" and pattern.startswith("[:", i):
                raise ValueError(f"{where}: POSIX bracket classes of {pattern!r} are not supported")
            if c == "[":
                raise ValueError(f"{where}: nested classes of {pattern!r} are not supported")
            if c == "]":
                depth = 0
            out.append(c)
            i += 1
            continue
        if c == "[":
            depth = 1
            if pattern.startswith("[^", i):
                out.append("[^")
                i += 2
            else:
                out.append("[")
                i += 1
            if i < n and pattern[i] == "]":  # a leading ] is a literal
                out.append("\\]")
                i += 1
            continue
        if c == "(" and pattern.startswith("(?<", i) and not pattern.startswith(("(?<=", "(?<!"), i):
            out.append("(?P<")
            i += 3
            continue
        if c in "^$":
            out.append(f"(?m:{c})")
            i += 1
            continue
        out.append(c)
        i += 1
    try:
        return re.compile("".join(out))
    except re.error as err:
        raise ValueError(f"{where}: cannot translate {pattern!r}: {err}") from None


@functools.lru_cache(maxsize=None)
def _gpt2_regex() -> "re.Pattern":
    return translate_regex(GPT2_PATTERN, "ByteLevel")


def _byte_level_alphabet() -> Tuple[str, ...]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    table = dict(zip(bs, bs))
    for n, b in enumerate(b for b in range(256) if b not in table):
        table[b] = 256 + n
    return tuple(chr(table[b]) for b in range(256))


# GPT-2's byte -> printable character table (the ByteLevel alphabet), indexed by byte
BYTE_CHARS = _byte_level_alphabet()


def _byte_chars(s: str) -> str:
    return "".join(BYTE_CHARS[b] for b in s.encode("utf-8"))


# ---------------------------------------------------------------------------
# Splitting (the library's NormalizedString::split)
# ---------------------------------------------------------------------------


def _regex_matches(rx: "re.Pattern", s: str) -> List[Tuple[int, int, bool]]:
    if not s:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in rx.finditer(s):
        if prev != m.start():
            out.append((prev, m.start(), False))
        out.append((m.start(), m.end(), True))
        prev = m.end()
    if prev != len(s):
        out.append((prev, len(s), False))
    return out


def _char_matches(pred: Callable[[str], bool], s: str) -> List[Tuple[int, int, bool]]:
    if not s:
        return [(0, 0, False)]
    out, last = [], 0
    for i, c in enumerate(s):
        if pred(c):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if len(s) > last:
        out.append((last, len(s), False))
    return out


def _split(s: str, matches: List[Tuple[int, int, bool]], behavior: str, invert: bool = False) -> List[str]:
    """The pieces of ``s`` under one of the library's split behaviors."""
    if invert:
        matches = [(a, b, not m) for a, b, m in matches]
    if behavior == "Isolated":
        spans = [(a, b, False) for a, b, _ in matches]
    elif behavior == "Removed":
        spans = matches
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        spans, prev = [], False
        for a, b, m in matches:
            join = (m == prev) if behavior == "Contiguous" else (m and not prev)
            if join and spans:
                spans[-1] = (spans[-1][0], b, False)
            else:
                spans.append((a, b, False))
            prev = m
    elif behavior == "MergedWithNext":
        spans, prev = [], False
        for a, b, m in reversed(matches):
            if m and not prev and spans:
                spans[-1] = (a, spans[-1][1], False)
            else:
                spans.append((a, b, False))
            prev = m
        spans.reverse()
    else:
        raise ValueError(f"unknown split behavior {behavior!r}")
    return [s[a:b] for a, b, removed in spans if not removed and b > a]


def _pattern(spec: dict, where: str) -> "re.Pattern":
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ValueError(f"{where}: a pattern is {{'String': ...}} or {{'Regex': ...}}, not {spec!r}")
    (kind, value), = spec.items()
    if kind == "String":
        return re.compile(re.escape(value))
    if kind == "Regex":
        return translate_regex(value, where)
    raise ValueError(f"{where}: unknown pattern type {kind!r}")


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------


def _normalizer(spec: Optional[dict], where: str) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind in ("NFC", "NFKC"):
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"], f"{where}.pattern"), spec["content"]
        return lambda s: rx.sub(lambda _: content, s)
    if kind == "Sequence":
        parts = [_normalizer(p, f"{where}.normalizers[{i}]") for i, p in enumerate(spec["normalizers"])]

        def run(s):
            for p in parts:
                s = p(s)
            return s

        return run
    raise ValueError(f"{where}: normalizer type {kind!r} is not supported")


def _pre_tokenizer(spec: Optional[dict], where: str) -> Optional[Callable[[str], List[str]]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", True), spec.get("use_regex", True)

        def byte_level(s):
            if prefix and not s.startswith(" "):
                s = " " + s
            parts = _split(s, _regex_matches(_gpt2_regex(), s), "Isolated") if use_regex else [s]
            return [_byte_chars(p) for p in parts]

        return byte_level
    if kind == "Split":
        rx = _pattern(spec["pattern"], f"{where}.pattern")
        behavior, invert = spec["behavior"], spec.get("invert", False)
        return lambda s: _split(s, _regex_matches(rx, s), behavior, invert)
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits", False) else "Contiguous"
        return lambda s: _split(s, _char_matches(_is_numeric, s), behavior)
    if kind == "Sequence":
        parts = [_pre_tokenizer(p, f"{where}.pretokenizers[{i}]") for i, p in enumerate(spec["pretokenizers"])]

        def run(s):
            pieces = [s]
            for p in parts:
                pieces = [q for piece in pieces for q in p(piece)]
            return pieces

        return run
    raise ValueError(f"{where}: pre-tokenizer type {kind!r} is not supported")


def _post_processor(spec: Optional[dict], where: str) -> Callable[[List[int]], List[int]]:
    if spec is None or spec.get("type") == "ByteLevel":  # ByteLevel only trims offsets
        return lambda ids: ids
    if spec.get("type") == "TemplateProcessing":
        special = {name: list(v["ids"]) for name, v in spec.get("special_tokens", {}).items()}
        template = []
        for i, piece in enumerate(spec["single"]):
            if "SpecialToken" in piece:
                name = piece["SpecialToken"]["id"]
                if name not in special:
                    raise ValueError(f"{where}.single[{i}]: special token {name!r} has no ids")
                template.append(special[name])
            elif piece.get("Sequence", {}).get("id") == "A":
                template.append(None)
            else:
                raise ValueError(f"{where}.single[{i}]: {piece!r} is not supported in a single template")
        return lambda ids: [t for part in template for t in (ids if part is None else part)]
    raise ValueError(f"{where}: post-processor type {spec.get('type')!r} is not supported")


class _BPE:
    def __init__(self, spec: dict, where: str = "model"):
        if spec.get("type", "BPE") != "BPE":
            raise ValueError(f"{where}: model type {spec.get('type')!r} is not supported")
        if spec.get("dropout") not in (None, 0.0):
            raise ValueError(f"{where}: dropout {spec['dropout']} draws random merges and is refused")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            parts = m.split(" ") if isinstance(m, str) else list(m)
            if len(parts) != 2:
                raise ValueError(f"{where}.merges[{rank}]: {m!r} is not a pair")
            a, b = parts
            new = a + b[len(self.prefix):]
            for tok in (a, b, new):
                if tok not in self.vocab:
                    raise ValueError(f"{where}.merges[{rank}]: {tok!r} is not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])
        self._cache: Dict[str, List[int]] = {}

    def _unk_id(self) -> int:
        if self.unk not in self.vocab:
            raise ValueError(f"unk_token {self.unk!r} is not in the vocabulary")
        return self.vocab[self.unk]

    def _symbols(self, word: str) -> List[int]:
        syms: List[int] = []
        unk = None
        last = len(word) - 1
        for i, ch in enumerate(word):
            s = (self.prefix if i else "") + ch + (self.suffix if i == last else "")
            if s in self.vocab:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(self.vocab[s])
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if all(t is not None for t in ids):
                    syms.extend(ids)  # a pending unknown stays pending, as in the library
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self._unk_id()
        if unk is not None:
            syms.append(unk)
        return syms

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        syms = self._symbols(word)
        merges = self.merges
        while len(syms) > 1:
            best, at = None, -1
            for j in range(len(syms) - 1):
                m = merges.get((syms[j], syms[j + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best, at = m, j
            if best is None:
                break
            syms[at:at + 2] = [best[1]]
        if len(self._cache) < 100_000:
            self._cache[word] = syms
        return syms


class _AddedToken:
    def __init__(self, spec: dict):
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.single_word = bool(spec.get("single_word", False))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))
        self.normalized = bool(spec.get("normalized", True))


def _added_matches(s: str, tokens: Dict[str, "_AddedToken"], by_first: Dict[str, List[str]]):
    """(token or None, start, stop) pieces of ``s``: the library's
    leftmost-longest matching of the added tokens and their rules."""
    if not s:
        return [(None, 0, 0)]
    out, start_offset, i, n = [], 0, 0, len(s)
    while i < n:
        content = next((c for c in by_first.get(s[i], ()) if s.startswith(c, i)), None)
        if content is None:
            i += 1
            continue
        tok, start, stop = tokens[content], i, i + len(content)
        i = stop
        if tok.single_word:
            start_space = start == 0 or not _is_word(s[start - 1])
            stop_space = stop == n or not _is_word(s[stop])
            if not (start_space and stop_space):
                continue
        if tok.lstrip:
            j = start
            while j > 0 and _is_space(s[j - 1]):
                j -= 1
            start = max(j, start_offset)
        if tok.rstrip:  # the search goes on from the match's end, not from the stripped spaces
            while stop < n and _is_space(s[stop]):
                stop += 1
        if start_offset < start:
            out.append((None, start_offset, start))
        out.append((tok, start, stop))
        start_offset = stop
    if start_offset != n:
        out.append((None, start_offset, n))
    return out


class TextTokenizer:
    """The encoder of one ``tokenizer.json`` (see the module docstring)."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"{key}: {spec[key]!r} is not supported")
        self.model = _BPE(spec["model"])
        self.normalizer = _normalizer(spec.get("normalizer"), "normalizer")
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"), "pre_tokenizer")
        self.post = _post_processor(spec.get("post_processor"), "post_processor")
        added = [_AddedToken(t) for t in spec.get("added_tokens", [])]
        self._raw = self._index([t for t in added if not t.normalized], lambda c: c)
        self._norm = self._index([t for t in added if t.normalized], self.normalizer or (lambda c: c))

    @staticmethod
    def _index(tokens, norm) -> Tuple[Dict[str, _AddedToken], Dict[str, List[str]]]:
        table = {}
        for t in tokens:
            key = norm(t.content)
            if key:
                table.setdefault(key, t)
        by_first: Dict[str, List[str]] = {}
        for key in sorted(table, key=len, reverse=True):
            by_first.setdefault(key[0], []).append(key)
        return table, by_first

    @staticmethod
    def from_file(path: str) -> "TextTokenizer":
        with open(path, encoding="utf-8") as f:
            return TextTokenizer(json.load(f))

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok, a, b in _added_matches(text, *self._raw):
            if tok is not None:
                ids.append(tok.id)
                continue
            piece = text[a:b]
            if not piece:
                continue
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            for tok2, c, d in _added_matches(piece, *self._norm):
                if tok2 is not None:
                    ids.append(tok2.id)
                elif d > c:
                    ids.extend(self._tokenize(piece[c:d]))
        return self.post(ids)

    __call__ = encode

    def _tokenize(self, piece: str) -> List[int]:
        pieces: Sequence[str] = self.pre_tokenizer(piece) if self.pre_tokenizer is not None else [piece]
        return [t for p in pieces if p for t in self.model.tokenize(p)]
