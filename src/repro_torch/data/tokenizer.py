"""Byte-level tokenizer with an optional learned BPE-style merge table,
ported from ``repro.data.tokenizer``.

No external vocabulary: the byte fallback keeps any text valid.  Vocab
layout: [0..255] bytes, 256 = BOS, 257 = EOS, 258 = PAD, then merges.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

BOS, EOS, PAD = 256, 257, 258
BASE = 259


class ByteTokenizer:
    def __init__(self, merges: Sequence[Tuple[int, int]] = ()):
        self.merges: List[Tuple[int, int]] = list(merges)
        self._ranks: Dict[Tuple[int, int], int] = {
            m: i for i, m in enumerate(self.merges)}

    @property
    def vocab_size(self) -> int:
        return BASE + len(self.merges)

    @classmethod
    def train(cls, texts: Iterable[str], num_merges: int = 256
              ) -> "ByteTokenizer":
        corpus = [list(t.encode("utf-8")) for t in texts]
        merges: List[Tuple[int, int]] = []
        for step in range(num_merges):
            pairs = Counter()
            for seq in corpus:
                pairs.update(zip(seq, seq[1:]))
            if not pairs:
                break
            (a, b), cnt = pairs.most_common(1)[0]
            if cnt < 2:
                break
            tok = BASE + len(merges)
            merges.append((a, b))
            corpus = [cls._merge_seq(s, a, b, tok) for s in corpus]
        return cls(merges)

    @staticmethod
    def _merge_seq(seq, a, b, tok):
        out, i = [], 0
        while i < len(seq):
            if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                out.append(tok)
                i += 2
            else:
                out.append(seq[i])
                i += 1
        return out

    def encode(self, text: str, bos: bool = True, eos: bool = False
               ) -> List[int]:
        seq = list(text.encode("utf-8"))
        for i, (a, b) in enumerate(self.merges):
            seq = self._merge_seq(seq, a, b, BASE + i)
        return ([BOS] if bos else []) + seq + ([EOS] if eos else [])

    def decode(self, ids: Sequence[int]) -> str:
        rev: Dict[int, Tuple[int, int]] = {
            BASE + i: m for i, m in enumerate(self.merges)}

        def expand(t):
            if t < 256:
                return [t]
            if t in rev:
                a, b = rev[t]
                return expand(a) + expand(b)
            return []
        out: List[int] = []
        for t in ids:
            out.extend(expand(int(t)))
        return bytes(out).decode("utf-8", errors="replace")
