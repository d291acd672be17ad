"""Self-contained BERT WordPiece tokenizer.

A copy of ``meme_challenge_tpu/data/tokenizer.py``.

The reference tokenizes with HuggingFace ``BertTokenizer('bert-base-cased')``
(train_uniter.py:124-126, padding='max_length', truncation=True). This build
runs with zero network egress, so the tokenizer is implemented here and loads
any BERT ``vocab.txt``; it produces identical ids to HF's slow BertTokenizer
(verified in tests/test_data.py: hand-picked cases plus a multi-thousand-
string unicode/punctuation/CJK/long-word fuzz against HF's in-process
implementation on a generated vocab).

Cased-model settings: no lowercasing, no accent stripping.
"""
from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = idx
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation by BERT even when not Unicode-P
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting (cased: no lowercase/accent strip)."""

    def __init__(self, do_lower_case: bool = False):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_chinese(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_chinese(text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(g) for g in out]


class WordPieceTokenizer:
    """Greedy longest-match-first subword splitting with '##' continuations."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces


class BertTokenizer:
    """Full BERT tokenizer: basic split → wordpiece → [CLS] ... [SEP] framing.

    Call signature mirrors how the reference uses HF
    (``tokenizer(texts, max_length=..., padding='max_length', truncation=True,
    return_length=True)`` → dict of arrays).
    """

    def __init__(self, vocab_file: str, do_lower_case: bool = False,
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", unk_token: str = "[UNK]",
                 mask_token: str = "[MASK]"):
        self.vocab = load_vocab(vocab_file)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(self.vocab, unk_token)
        self.cls_token, self.sep_token = cls_token, sep_token
        self.pad_token, self.unk_token = pad_token, unk_token
        self.mask_token = mask_token
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_id = self.vocab[unk_token]
        self.mask_id = self.vocab.get(mask_token, self.unk_id)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def mlm_vocab_range(self):
        """Random-replacement id range for MLM masking, excluding the
        special-token and [unused##] blocks at the vocab start (BERT
        convention; for real bert-base-cased this yields (104, vocab_size),
        since [unused1..99] sit at ids 1-99 and specials at 100-103)."""
        special = {self.cls_id, self.sep_id, self.pad_id, self.unk_id,
                   self.mask_id}
        max_reserved = max(
            [i for t, i in self.vocab.items()
             if i in special or t.startswith("[unused")],
            default=-1)
        return (max_reserved + 1, self.vocab_size)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.inv_vocab.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str, max_length: int) -> Dict[str, np.ndarray]:
        tokens = self.tokenize(text)
        tokens = tokens[: max_length - 2]  # truncation incl. [CLS]/[SEP]
        ids = [self.cls_id] + self.convert_tokens_to_ids(tokens) + [self.sep_id]
        length = len(ids)
        input_ids = np.full(max_length, self.pad_id, dtype=np.int32)
        input_ids[:length] = ids
        attention_mask = np.zeros(max_length, dtype=np.int32)
        attention_mask[:length] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": np.zeros(max_length, dtype=np.int32),
            "length": np.int32(length),
        }

    def __call__(self, texts: Union[str, Iterable[str]], max_length: int,
                 padding: str = "max_length", truncation: bool = True,
                 return_length: bool = True, **_kw) -> Dict[str, np.ndarray]:
        del padding, truncation, return_length  # always max_length/True/True
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t, max_length) for t in texts]
        return {
            "input_ids": np.stack([e["input_ids"] for e in encoded]),
            "attention_mask": np.stack([e["attention_mask"] for e in encoded]),
            "token_type_ids": np.stack([e["token_type_ids"] for e in encoded]),
            "length": np.array([e["length"] for e in encoded], dtype=np.int32),
        }


BERT_SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def write_vocab(vocab_file: str, tokens: Sequence[str]) -> None:
    """Write a vocab.txt (used by tests/fixtures)."""
    with open(vocab_file, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
