"""Tokenizers (the port of ``nlp/tokenization.py``; reference `deeplearning4j-nlp/.../text/tokenization/
tokenizerfactory/DefaultTokenizerFactory.java`,
`tokenizer/preprocessor/CommonPreprocessor.java`,
`deeplearning4j-nlp/.../BertWordPieceTokenizer.java`)."""
from __future__ import annotations

import re
import string
from typing import Dict, List, Optional, Sequence


class CommonPreprocessor:
    """Lowercase + strip punctuation (reference `CommonPreprocessor`)."""

    _PUNCT = re.compile(r"[" + re.escape(string.punctuation) + "]")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class DefaultTokenizerFactory:
    """Whitespace tokenizer with optional per-token preprocessor
    (reference `DefaultTokenizerFactory`)."""

    def __init__(self, preprocessor: Optional[CommonPreprocessor] = None):
        self.preprocessor = preprocessor

    def tokenize(self, text: str) -> List[str]:
        toks = text.split()
        if self.preprocessor:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return [t for t in toks if t]

    create = tokenize


class BertWordPieceTokenizer:
    """Greedy longest-match-first WordPiece (reference
    `BertWordPieceTokenizer` — same algorithm as BERT's reference impl:
    whitespace + punctuation split, then vocab longest-prefix with '##'
    continuations; unknown pieces -> [UNK])."""

    def __init__(self, vocab: Sequence[str] | Dict[str, int],
                 lower_case: bool = True, unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        if isinstance(vocab, dict):
            self.vocab = dict(vocab)
        else:
            self.vocab = {w: i for i, w in enumerate(vocab)}
        self.inv_vocab = {i: w for w, i in self.vocab.items()}
        if unk_token not in self.vocab:
            raise ValueError(
                f"Vocab lacks the unknown-token '{unk_token}' — encode() "
                "would fail on any out-of-vocab word")
        self.lower_case = lower_case
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word

    def _basic_split(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
        out, cur = [], []
        for ch in text:
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif ch in string.punctuation:
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._basic_split(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab[t] for t in self.tokenize(text)]

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(i, self.unk_token) for i in ids]
        s = ""
        for t in toks:
            s += t[2:] if t.startswith("##") else (" " + t if s else t)
        return s

    @staticmethod
    def from_vocab_file(path: str, **kw) -> "BertWordPieceTokenizer":
        with open(path) as f:
            vocab = [line.rstrip("\n") for line in f]
        return BertWordPieceTokenizer(vocab, **kw)
