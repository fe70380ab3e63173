"""RWKV "World" byte-level tokenizer (greedy longest match). The port's own
copy of ``visualrwkv_tpu/data/tokenizer.py`` (pure Python, without its
optional native trie).

Own implementation over the public ``rwkv_vocab_v20230424.txt`` vocabulary
(65536 entries).  Behaviorally equivalent to the reference TRIE tokenizer
(VisualRWKV-v7/v7.00/tokenizer/rwkv_tokenizer.py:5-103): encode is greedy
longest-prefix match over token byte strings; decode concatenates token bytes
and UTF-8 decodes.

Implementation note: instead of a node-per-byte trie (slow in Python), tokens
are bucketed by first byte with a per-bucket length bound; longest match tries
descending lengths against one dict — fewer Python-level operations per token
for the same greedy-longest semantics.
"""

from __future__ import annotations

import ast
import gzip
from pathlib import Path
from typing import Dict, List

# the vocabulary is kept gzip-compressed (1.1 MB of text -> 0.3 MB)
DEFAULT_VOCAB = Path(__file__).parent / "assets" / "rwkv_vocab_v20230424.txt.gz"


class WorldTokenizer:
    def __init__(self, vocab_path: str | Path = DEFAULT_VOCAB):
        self.idx2token: Dict[int, bytes] = {}
        opener = gzip.open if str(vocab_path).endswith(".gz") else open
        with opener(vocab_path, "rt", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                idx = int(line[: line.index(" ")])
                rest = line[line.index(" ") + 1 : line.rindex(" ")]
                length = int(line[line.rindex(" ") + 1 :])
                tok = ast.literal_eval(rest)
                tok = tok.encode("utf-8") if isinstance(tok, str) else tok
                assert isinstance(tok, bytes) and len(tok) == length, line
                self.idx2token[idx] = tok

        self.token2idx: Dict[bytes, int] = {v: k for k, v in self.idx2token.items()}
        # prefix set: enables a forward walk (extend while a prefix exists,
        # remember the last full match) — O(len) dict probes per position
        self.prefixes = set()
        for tok in self.token2idx:
            for i in range(1, len(tok) + 1):
                self.prefixes.add(tok[:i])

    @property
    def n_tokens(self) -> int:
        """Actual vocabulary entries (65529 for the World vocab)."""
        return len(self.idx2token)

    @property
    def vocab_size(self) -> int:
        """Model vocab size: ids 0 (end-of-doc) and 65530..65535 are reserved;
        the LM head is padded to 65536 (reference train.py vocab_size)."""
        return 65536

    def encode_bytes(self, src: bytes) -> List[int]:
        out: List[int] = []
        i, n = 0, len(src)
        t2i = self.token2idx
        prefixes = self.prefixes
        while i < n:
            best_idx, best_end = None, i
            j = i
            while j < n:
                piece = src[i : j + 1]
                if piece not in prefixes:
                    break
                j += 1
                idx = t2i.get(piece)
                if idx is not None:
                    best_idx, best_end = idx, j
            if best_idx is None:  # unknown byte (every single byte IS in the vocab)
                raise ValueError(f"byte {src[i]!r} not in vocab")
            out.append(best_idx)
            i = best_end
        return out

    def encode(self, text: str) -> List[int]:
        return self.encode_bytes(text.encode("utf-8"))

    def decode_bytes(self, ids) -> bytes:
        return b"".join(self.idx2token[int(i)] for i in ids)

    def decode(self, ids) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")


_default: WorldTokenizer | None = None


def get_tokenizer() -> WorldTokenizer:
    """Process-wide default tokenizer (vocab parse is ~100ms; do it once)."""
    global _default
    if _default is None:
        _default = WorldTokenizer()
    return _default
