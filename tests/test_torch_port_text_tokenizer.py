"""The port's BPE reader of ``tokenizer.json`` against the ``tokenizers``
package: ``TextTokenizer(spec).encode(s)`` must give
``Tokenizer.from_str(spec).encode(s).ids``.

The JSON files are built here with ``tokenizers`` (a ``BpeTrainer`` on a
small inline corpus, nothing downloaded), one for each supported component
and flag: ByteLevel with and without its prefix space and regex, Split
with a ``String`` and a ``Regex`` pattern under every behavior and
``invert``, Digits, pre-tokenizer and normalizer sequences, NFC, NFKC,
Replace, TemplateProcessing and the ByteLevel post-processor, byte
fallback, the unknown token fused and not, the subword prefix and word
suffix, ``ignore_merges``, merges written as strings and as pairs, and
added tokens with every flag. The ids must be equal on fixed strings (runs
of spaces and newlines, ``\\x1c-\\x1f``, which Python's ``\\s`` takes and
the library's does not, ``\\x85`` and ``\\xa0``, which both take, ``²٣``,
CJK, emoji, added tokens inside text, the empty string) and on
hypothesis-drawn text.
Any other component type raises and names itself.
"""

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers, processors  # noqa: E402
from tokenizers.trainers import BpeTrainer  # noqa: E402

from wmar_tpu_torch.models.text_tokenizer import TextTokenizer, translate_regex  # noqa: E402

CORPUS = ["hello world this is a test of the tokenizer", "the quick brown fox jumps over the lazy dog 12345",
          "naïve café 東京 タワー 😀 ²٣ x\x85y a\x1cb", "  spaces   and\n\nnewlines\t tabs", "I'm you're we've they'll",
          "ﬁne ① Ⅻ 123 4567 89", "<img> xyz QQ fox"] * 4
LLAMA3 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
          r"|\s+(?!\S)|\s+")
BEHAVIORS = ["removed", "isolated", "merged_with_previous", "merged_with_next", "contiguous"]


def _build(pre, norm=None, post=None, added=True, vocab=400, **model_kw):
    tok = Tokenizer(models.BPE(**model_kw))
    if norm is not None:
        tok.normalizer = norm
    if pre is not None:
        tok.pre_tokenizer = pre
    trainer = BpeTrainer(vocab_size=vocab, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False,
                         special_tokens=["<s>", "</s>", "<unk>"] + [f"<0x{b:02X}>" for b in range(256)])
    tok.train_from_iterator(CORPUS, trainer)
    if added:
        tok.add_special_tokens([AddedToken("<img>", special=True)])
        tok.add_tokens([AddedToken("xyz", single_word=True), AddedToken("QQ", lstrip=True, rstrip=True),
                        AddedToken("fox", normalized=True), AddedToken("ﬁ", normalized=True)])
    if post is not None:
        tok.post_processor = post
    return json.loads(tok.to_str())


def _bytes_after(pre):
    return pre_tokenizers.Sequence([pre, pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])


def _specs():
    template = processors.TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 1)])
    specs = {
        "byte_level": _build(pre_tokenizers.ByteLevel(add_prefix_space=True)),
        "byte_level_no_prefix": _build(pre_tokenizers.ByteLevel(add_prefix_space=False), post=processors.ByteLevel()),
        "byte_level_no_regex": _build(pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)),
        "llama3_split_digits_nfkc_template": _build(
            pre_tokenizers.Sequence([pre_tokenizers.Split(Regex(LLAMA3), behavior="isolated"),
                                     pre_tokenizers.Digits(individual_digits=True),
                                     pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
            norm=normalizers.NFKC(), post=template),
        "digits_contiguous": _build(pre_tokenizers.Sequence([pre_tokenizers.Digits(individual_digits=False),
                                                             pre_tokenizers.ByteLevel()])),
        "replace_regex": _build(pre_tokenizers.ByteLevel(), norm=normalizers.Replace(Regex(r"\s{2,}"), " ")),
        "byte_fallback_fused_unk": _build(None, byte_fallback=True, unk_token="<unk>", fuse_unk=True, added=False),
        "byte_fallback": _build(None, byte_fallback=True, added=False),
        "unk": _build(pre_tokenizers.Split(Regex(r"\s+"), behavior="removed"), unk_token="<unk>", fuse_unk=False),
        "unk_fused": _build(pre_tokenizers.Split(Regex(r"\s+"), behavior="removed"), unk_token="<unk>", fuse_unk=True),
        "prefix_suffix": _build(pre_tokenizers.Split(Regex(r"\s+"), behavior="removed"), unk_token="<unk>",
                                continuing_subword_prefix="##", end_of_word_suffix="</w>"),
        "ignore_merges": _build(pre_tokenizers.ByteLevel(), ignore_merges=True),
    }
    for beh in BEHAVIORS:
        for invert in (False, True):
            specs[f"split_string_{beh}_{invert}"] = _build(
                _bytes_after(pre_tokenizers.Split(" ", behavior=beh, invert=invert)),
                norm=normalizers.Sequence([normalizers.NFC(), normalizers.Replace("\t", "  ")]))
            specs[f"split_regex_{beh}_{invert}"] = _build(
                _bytes_after(pre_tokenizers.Split(Regex(r"\s+|\p{N}"), behavior=beh, invert=invert)))
    legacy = json.loads(json.dumps(specs["byte_level"]))
    legacy["model"]["merges"] = [" ".join(m) for m in legacy["model"]["merges"]]
    specs["string_merges"] = legacy
    return specs


SPECS = _specs()
PAIRS = {name: (Tokenizer.from_str(json.dumps(spec)), TextTokenizer(spec)) for name, spec in SPECS.items()}
FIXED = ["", "hello world", "  a  b   ", "x\n\n  y\n", "\n\n\n", "a\x1cb c", "\x1c\x1d\x1e\x1f z", "x\x85y", "\xa0z",
         "1²٣ z", "東京タワーへ", "😀😀 ok 👍🏽", "a<img>b", "<img>", "the fox xyz_ xyz,QQ  xyz", "fox's I'M",
         "\t\ttabs", "1234567 89", "ﬁ ﬀ ① ﬁne", "é é", "  QQQQ  ", "xyzxyz xyz", "<img><img> <img>"]


@pytest.mark.parametrize("name", list(SPECS))
def test_fixed_strings(name):
    lib, port = PAIRS[name]
    for s in FIXED:
        assert port.encode(s) == lib.encode(s).ids, repr(s)


PIECES = st.sampled_from(["<img>", "xyz", "QQ", " ", "  ", "\n", "fox", "'s", "12345", "²٣", "\x1c", "\x85", "\xa0",
                          "_", "ﬁ", "é", "東", "😀", "\t"])
TEXT = st.lists(st.one_of(PIECES, st.text(max_size=8), st.text(alphabet="ab c\n1'", max_size=8)),
                max_size=12).map("".join)


@settings(max_examples=250, deadline=None, derandomize=True, database=None)
@given(TEXT)
def test_hypothesis_text(s):
    for name, (lib, port) in PAIRS.items():
        assert port.encode(s) == lib.encode(s).ids, (name, s)


def test_the_library_split_that_python_re_does_not_give():
    """GPT-2's pattern: ``\\x1c`` is no whitespace to the library (it is to
    ``re``), ``\\x85`` is; ``\\p{N}`` takes ``²`` and ``٣``."""
    port = PAIRS["byte_level_no_prefix"][1]
    assert port.pre_tokenizer("a\x1cb c") == ["a", "Ĝ", "b", "Ġc"]
    assert port.pre_tokenizer("x\x85y") == ["x", "Âħ", "y"]
    assert port.pre_tokenizer("1²٣ z") == ["1Â²Ù£", "Ġz"]


@pytest.mark.parametrize("patch, what", [
    (lambda s: s.update(normalizer={"type": "Lowercase"}), "normalizer: normalizer type 'Lowercase'"),
    (lambda s: s.update(normalizer={"type": "Sequence", "normalizers": [{"type": "NFC"}, {"type": "Strip"}]}),
     "normalizer.normalizers[1]: normalizer type 'Strip'"),
    (lambda s: s.update(pre_tokenizer={"type": "Whitespace"}), "pre_tokenizer: pre-tokenizer type 'Whitespace'"),
    (lambda s: s.update(pre_tokenizer={"type": "Sequence", "pretokenizers": [{"type": "Metaspace"}]}),
     "pre_tokenizer.pretokenizers[0]: pre-tokenizer type 'Metaspace'"),
    (lambda s: s.update(post_processor={"type": "BertProcessing"}), "post_processor: post-processor type "
                                                                     "'BertProcessing'"),
    (lambda s: s["model"].update(type="WordPiece"), "model: model type 'WordPiece'"),
    (lambda s: s["model"].update(dropout=0.1), "model: dropout 0.1"),
    (lambda s: s.update(truncation={"max_length": 8}), "truncation"),
    (lambda s: s.update(padding={"length": 8}), "padding"),
    (lambda s: s.update(pre_tokenizer={"type": "Split", "pattern": {"Regex": r"\w+"}, "behavior": "Isolated",
                                       "invert": False}), r"pre_tokenizer.pattern: the escape \w"),
])
def test_unsupported_components_raise_and_name_themselves(patch, what):
    spec = json.loads(json.dumps(SPECS["byte_level"]))
    patch(spec)
    with pytest.raises(ValueError) as err:
        TextTokenizer(spec)
    assert what in str(err.value)


def test_regex_translation_classes():
    assert translate_regex(r"\s+").fullmatch(" \t\x85\xa0　") and not translate_regex(r"\s").match("\x1c")
    assert translate_regex(r"\p{N}+").fullmatch("1²٣Ⅻ") and not translate_regex(r"\d").match("²")
    assert translate_regex(r"[^\s\p{L}]+").fullmatch("1²!\x1c") and translate_regex(r"\P{L}").match("1")
    assert translate_regex(r"^a$").findall("a\na") == ["a", "a"]  # line anchors, as in Ruby syntax


def test_from_file(tmp_path):
    path = tmp_path / "text_tokenizer.json"
    path.write_text(json.dumps(SPECS["byte_level"]))
    lib = Tokenizer.from_file(str(path))
    assert TextTokenizer.from_file(str(path)).encode("the fox <img>") == lib.encode("the fox <img>").ids
