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

A configuration that aligns (an ``align`` section) has text its aligner can
time instead: every base id i from 256 up decodes to a space and a word of
the aligner's letters (``alphabet``), i - 255 written in bijective base n
over them (at most four letters of a to z for the 50001 ids), so that no two
ids share a word and the text, leading space stripped or not, splits on its
spaces into the ids one to one. The ids 0-255 stay the single bytes, and no
word holds a byte that the tokenizer's suppression lists encode, so those
lists are the same under both vocabularies.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterator, List, Optional

BASE = 0xF0000
N_BASE = 50257
N_BYTES = 256


def byte_order() -> List[int]:
    """The byte of each of the ids 0-255 (GPT-2's byte-to-unicode order:
    the printable bytes first, then the rest ascending)."""
    first = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1))
    return first + [b for b in range(N_BYTES) if b not in first]


def alphabet(config: dict) -> Optional[str]:
    """The letters of a configuration's aligner (its dictionary's
    one-letter entries, lower-cased as the port's loader reads them, in id
    order), or None for a configuration that does not align."""
    if "align" not in config:
        return None
    d = {k.lower(): v for k, v in config["align"]["dictionary"].items()}
    return "".join(sorted((c for c in d if len(c) == 1 and c.isalpha()), key=d.get))


def word(i: int, letters: str) -> str:
    """Base id ``i`` (from 256) as a word: i - 255 in bijective base n."""
    n, k, out = len(letters), i - N_BYTES + 1, []
    while k:
        k, r = divmod(k - 1, n)
        out.append(letters[r])
    return "".join(reversed(out))


def write(path: str, letters: Optional[str] = None) -> str:
    table = {str(i): bytes([b]).decode("latin-1") for i, b in enumerate(byte_order())}
    if letters is None:
        table.update({str(i): chr(BASE + i).encode("utf-8").decode("latin-1") for i in range(N_BYTES, N_BASE)})
    else:
        table.update({str(i): (" " + word(i, letters)).encode("utf-8").decode("latin-1")
                      for i in range(N_BYTES, N_BASE)})
    with open(path, "w") as f:
        json.dump(table, f)
    return path


@contextlib.contextmanager
def installed(directory: str, letters: Optional[str] = None) -> Iterator[str]:
    """The vocabulary (of ``letters``' words where given) written into
    ``directory`` and named by ``WHISPERX_TPU_VOCAB`` until the block ends;
    yields its path."""
    path = write(os.path.join(directory, "vocab.json"), letters)
    old = os.environ.get("WHISPERX_TPU_VOCAB")
    os.environ["WHISPERX_TPU_VOCAB"] = path
    try:
        yield path
    finally:
        if old is None:
            os.environ.pop("WHISPERX_TPU_VOCAB", None)
        else:
            os.environ["WHISPERX_TPU_VOCAB"] = old


def token_ids(text: str, letters: Optional[str] = None) -> Optional[List[int]]:
    """The text tokens of a segment's text, or None if a character is not
    one of the private-use ones (with ``letters``: if a space-separated
    piece is not one of their words)."""
    if letters is not None:
        ids = _word_ids(letters)
        out = [ids.get(w) for w in text.lstrip(" ").split(" ")]
        return out if text.strip() and None not in out else None
    out = [ord(c) - BASE for c in text]
    return out if all(N_BYTES <= i < N_BASE for i in out) else None


_WORD_IDS: Dict[str, Dict[str, int]] = {}


def _word_ids(letters: str) -> Dict[str, int]:
    if letters not in _WORD_IDS:
        _WORD_IDS[letters] = {word(i, letters): i for i in range(N_BYTES, N_BASE)}
    return _WORD_IDS[letters]
