"""A vocabulary under which a segment's text gives back its token ids.

The repository holds no large-v3 ranks file, and under the port's partial
vocabulary most ids of random weights decode to U+FFFD. Here ids 0-255 are
the 256 single bytes at their byte-level BPE ids (the port's tokenizer
encodes " " and the non-speech symbols with them, so the blank and the
suppression lists come out as under the real vocabulary's bytes), and every
other base id i decodes to the private-use character U+F0000 + i. A
configuration that suppresses the byte tokens (``suppress_byte_tokens``)
has each served segment's text be exactly its text tokens, one character
each, with nothing that decodes to white space. The file is in the port's
partial-vocabulary format (a JSON object of id → bytes as latin-1). The
model is handed the file's path, and ``WHISPERX_TPU_VOCAB`` names it too
while a run lasts: the port decodes a window's text without timestamps with
the tokenizer that variable names, not the model's.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator, List, Optional

BASE = 0xF0000
N_BASE = 50257
N_BYTES = 256


def byte_order() -> List[int]:
    """The byte of each of the ids 0-255 (GPT-2's byte-to-unicode order:
    the printable bytes first, then the rest ascending)."""
    first = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1))
    return first + [b for b in range(N_BYTES) if b not in first]


def write(path: str) -> str:
    table = {str(i): bytes([b]).decode("latin-1") for i, b in enumerate(byte_order())}
    table.update({str(i): chr(BASE + i).encode("utf-8").decode("latin-1") for i in range(N_BYTES, N_BASE)})
    with open(path, "w") as f:
        json.dump(table, f)
    return path


@contextlib.contextmanager
def installed(directory: str) -> Iterator[str]:
    """The vocabulary written into ``directory`` and named by
    ``WHISPERX_TPU_VOCAB`` until the block ends; yields its path."""
    path = write(os.path.join(directory, "vocab.json"))
    old = os.environ.get("WHISPERX_TPU_VOCAB")
    os.environ["WHISPERX_TPU_VOCAB"] = path
    try:
        yield path
    finally:
        if old is None:
            os.environ.pop("WHISPERX_TPU_VOCAB", None)
        else:
            os.environ["WHISPERX_TPU_VOCAB"] = old


def token_ids(text: str) -> Optional[List[int]]:
    """The text tokens of a segment's text, or None if a character is not
    one of the private-use ones."""
    out = [ord(c) - BASE for c in text]
    return out if all(N_BYTES <= i < N_BASE for i in out) else None
