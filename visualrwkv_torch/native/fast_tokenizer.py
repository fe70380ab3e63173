"""ctypes binding for the native C++ trie tokenizer. Counterpart of
``visualrwkv_tpu/native/fast_tokenizer.py``.

Compiles ``tokenizer.cpp`` with g++ on first use (cached under ``build/``
beside the package, which git ignores; an atomic rename, so that concurrent
processes never load half a file) and exposes encode/decode with the same
semantics as the pure-Python :class:`~visualrwkv_torch.data.tokenizer.WorldTokenizer`.
:class:`FastWorldTokenizer` raises if the library cannot be built; the
tokenizer's ``use_native="auto"`` then falls back to the pure-Python walk.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

log = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "tokenizer.cpp"
_CACHE = Path(__file__).resolve().parents[2] / "build" / "native"


def _atomic_write(path: Path, write) -> None:
    """``write(tmp)`` into a temporary file beside ``path``, then rename it
    onto ``path``."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=path.suffix)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _build_library() -> Optional[Path]:
    _CACHE.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    lib = _CACHE / f"libworldtok_{tag}.so"
    if lib.exists():
        return lib
    try:
        _atomic_write(lib, lambda tmp: subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", tmp],
            check=True, capture_output=True, timeout=120,
        ))
        return lib
    except Exception as e:  # compiler missing / failed
        log.warning("native tokenizer build failed (%s); using pure python", e)
        return None


def _write_binary_vocab(idx2token: dict, path: str) -> None:
    with open(path, "wb") as f:
        for idx, tok in idx2token.items():
            f.write(struct.pack("<ii", idx, len(tok)))
            f.write(tok)


class FastWorldTokenizer:
    """Native-accelerated tokenizer; same greedy-longest-match semantics."""

    def __init__(self, idx2token: dict):
        lib_path = _build_library()
        if lib_path is None:
            raise RuntimeError("native tokenizer unavailable")
        vocab_tag = hashlib.sha256(
            b"".join(tok for _, tok in sorted(idx2token.items()))
        ).hexdigest()[:12]
        bin_vocab = _CACHE / f"vocab_{vocab_tag}.bin"
        if not bin_vocab.exists():
            _atomic_write(bin_vocab, lambda tmp: _write_binary_vocab(idx2token, tmp))

        self._lib = ctypes.CDLL(str(lib_path))
        self._lib.tok_create.restype = ctypes.c_void_p
        self._lib.tok_create.argtypes = [ctypes.c_char_p]
        self._lib.tok_encode.restype = ctypes.c_int32
        self._lib.tok_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        self._lib.tok_decode.restype = ctypes.c_int32
        self._lib.tok_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
        ]
        self._lib.tok_destroy.argtypes = [ctypes.c_void_p]
        self._handle = self._lib.tok_create(str(bin_vocab).encode())
        if not self._handle:
            raise RuntimeError("tok_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tok_destroy(handle)

    def encode_bytes(self, src: bytes) -> List[int]:
        cap = max(16, len(src) + 8)
        out = (ctypes.c_int32 * cap)()
        n = self._lib.tok_encode(self._handle, src, len(src), out, cap)
        if n == -2:
            raise ValueError("unencodable byte")
        assert n >= 0
        return list(out[:n])

    def encode(self, text: str) -> List[int]:
        return self.encode_bytes(text.encode("utf-8"))

    def decode_bytes(self, ids) -> bytes:
        ids = list(int(i) for i in ids)
        cap = max(16, 32 * len(ids) + 16)
        arr = (ctypes.c_int32 * len(ids))(*ids)
        out = ctypes.create_string_buffer(cap)
        n = self._lib.tok_decode(self._handle, arr, len(ids), out, cap)
        while n == -1:  # rare: very long tokens
            cap *= 4
            out = ctypes.create_string_buffer(cap)
            n = self._lib.tok_decode(self._handle, arr, len(ids), out, cap)
        if n == -2:
            raise ValueError("unknown token id")
        return out.raw[:n]

    def decode(self, ids) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")
