"""Whisper tokenizer: byte-level BPE + the special-token layout.

A copy of ``whisperx_tpu/decoding/tokenizer.py`` (the port imports nothing
of the JAX package). The BPE rank table is pluggable:

  - ``TikTokenVocab`` builds a real tokenizer from a local ranks file
    (``gpt2.tiktoken`` / ``multilingual.tiktoken`` — base64 token + rank per
    line) using the installed ``tiktoken`` wheel entirely offline;
  - ``ByteFallbackVocab`` is a hermetic stand-in (ids = UTF-8 bytes) that
    preserves the exact special-token id layout, so every piece of decoding
    logic (language ids, timestamp rules, suppression) is testable without
    any downloaded asset.

Special-token ids are derived from the base-vocab size, reproducing the
published layout: multilingual eot=50257, sot=50258, languages 50259…,
timestamp_begin=50364 (+1 for large-v3's 100-language table); English-only
eot=50256 etc.
"""

from __future__ import annotations

import functools
import os
import string
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from whisperx_tpu_torch.utils.languages import LANGUAGE_CODES, normalize_language


class ByteFallbackVocab:
    """UTF-8 byte 'BPE' with a padded base-vocab size matching Whisper's."""

    def __init__(self, n_base: int = 50257):
        self.n_base = n_base

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens: Sequence[int]) -> str:
        data = bytes(t for t in tokens if 0 <= t < 256)
        return data.decode("utf-8", errors="replace")


class PartialVocab:
    """Exact partial BPE vocabulary recovered from the reference's gold
    transcription artifacts (tools/gold_vocab_solver.py): every entry is
    the TRUE large-v3 vocab value for that id, proven unique against all
    743 gold (tokens, text) equations. Covers the byte alphabet plus ~1.1k
    frequent English tokens. Unknown ids decode to U+FFFD; encoding is
    greedy longest-match (always succeeds — all 256 byte tokens exist)."""

    def __init__(self, path: str, n_base: int = 50257):
        import json

        with open(path) as f:
            raw = json.load(f)
        self.n_base = n_base
        # latin-1 round-trips arbitrary bytes through JSON strings
        self.id_to_bytes = {int(k): v.encode("latin-1") for k, v in raw.items()}
        self.bytes_to_id = {v: k for k, v in self.id_to_bytes.items()}
        self._maxlen = max(len(v) for v in self.id_to_bytes.values())

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        out, i = [], 0
        while i < len(data):
            for ln in range(min(self._maxlen, len(data) - i), 0, -1):
                tid = self.bytes_to_id.get(data[i : i + ln])
                if tid is not None:
                    out.append(tid)
                    i += ln
                    break
            else:  # no token matched — a vocab missing byte coverage must
                # error, not spin forever (the shipped gold vocab covers
                # all 256 single bytes; arbitrary user JSON may not)
                raise ValueError(
                    f"vocab has no token for byte 0x{data[i]:02x} at "
                    f"position {i}; partial vocabularies must cover all "
                    "single bytes"
                )
        return out

    def decode(self, tokens: Sequence[int]) -> str:
        parts = [
            self.id_to_bytes.get(t, b"\xef\xbf\xbd")
            for t in tokens
            if 0 <= t < self.n_base
        ]
        return b"".join(parts).decode("utf-8", errors="replace")


def default_partial_vocab_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets",
        "gold_vocab_en.json",
    )


class TikTokenVocab:
    """Real GPT-2-style BPE built from a local ranks file (no network)."""

    def __init__(self, ranks_path: str):
        import base64

        import tiktoken  # imported here: only a ranks file needs it

        ranks = {}
        with open(ranks_path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                token_b64, rank = line.split()
                ranks[base64.b64decode(token_b64)] = int(rank)
        self.n_base = len(ranks)
        self._enc = tiktoken.Encoding(
            name=os.path.basename(ranks_path),
            explicit_n_vocab=None,
            pat_str=(
                r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
            ),
            mergeable_ranks=ranks,
            special_tokens={},
        )

    def encode(self, text: str) -> List[int]:
        return self._enc.encode(text)

    def decode(self, tokens: Sequence[int]) -> str:
        return self._enc.decode([t for t in tokens if t < self.n_base])


@dataclass
class Tokenizer:
    """Whisper tokenizer facade: BPE + task/language specials + timestamps."""

    vocab: object
    multilingual: bool
    num_languages: int = 99
    language: Optional[str] = None
    task: Optional[str] = None
    sot_sequence: Tuple[int, ...] = field(default_factory=tuple)

    def __post_init__(self):
        n = self.vocab.n_base
        self.eot = n
        self.sot = n + 1
        self._lang_base = self.sot + 1
        self.translate = self._lang_base + self.num_languages
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1

        # store the NORMALIZED code ("japanese" → "ja"): every consumer
        # compares against codes
        if self.language is not None:
            self.language = normalize_language(self.language)
        seq = [self.sot]
        if self.multilingual:
            lang = self.language or "en"
            seq.append(self.to_language_token(lang))
            seq.append(self.transcribe if self.task != "translate" else self.translate)
        self.sot_sequence = tuple(seq)

    # -- encode / decode ---------------------------------------------------

    def encode(self, text: str) -> List[int]:
        return self.vocab.encode(text)

    def decode(self, tokens: Sequence[int]) -> str:
        return self.vocab.decode([t for t in tokens if t < self.eot])

    def decode_with_timestamps(self, tokens: Sequence[int]) -> str:
        parts, run = [], []
        for t in tokens:
            if t >= self.timestamp_begin:
                parts.append(self.decode(run))
                run = []
                parts.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                run.append(t)
        parts.append(self.decode(run))
        return "".join(parts)

    # -- specials ----------------------------------------------------------

    @property
    def all_language_tokens(self) -> List[int]:
        return [self._lang_base + i for i in range(self.num_languages)]

    def to_language_token(self, language: str) -> int:
        code = normalize_language(language)
        try:
            idx = LANGUAGE_CODES.index(code)
        except ValueError:
            raise KeyError(f"Language {language!r} not in Whisper inventory")
        if idx >= self.num_languages:
            raise KeyError(f"Language {language!r} unsupported by this model")
        return self._lang_base + idx

    def language_code_of(self, token: int) -> str:
        return LANGUAGE_CODES[token - self._lang_base]

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return self.sot_sequence + (self.no_timestamps,)

    @functools.cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids to suppress so decoding skips non-speech annotations
        (♪♪, parenthesized noises, …) — the Whisper `suppress_tokens=-1` set.
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")

        result = set()
        # upstream adds " -"/" '" only when they encode to a SINGLE token;
        # with a partial vocab they greedy-split to [space, ...] and adding
        # t[0] would wrongly suppress the bare space token
        for t in [self.encode(" -"), self.encode(" '")]:
            if len(t) == 1:
                result.add(t[0])
        space = self.encode(" ")
        space_id = space[0] if len(space) == 1 else None
        for symbol in symbols + list(miscellaneous):
            for tokens in [self.encode(symbol), self.encode(" " + symbol)]:
                if tokens and (len(tokens) == 1 or symbol in miscellaneous):
                    if tokens[0] != space_id:  # never ban the space token
                        result.add(tokens[0])
        return tuple(sorted(result))

    # -- word splitting (used by timing.add_word_timestamps) ---------------

    def split_to_word_tokens(self, tokens: Sequence[int]):
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            return self._split_tokens_on_unicode(tokens)
        return self._split_tokens_on_spaces(tokens)

    def _split_tokens_on_unicode(self, tokens: Sequence[int]):
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = "\ufffd"
        words, word_tokens = [], []
        current: List[int] = []
        unicode_offset = 0
        for token in tokens:
            current.append(token)
            decoded = self.decode_with_timestamps(current)
            ok = (
                replacement not in decoded
                or decoded_full[unicode_offset + decoded.index(replacement)]
                == replacement
            )
            if ok:
                words.append(decoded)
                word_tokens.append(current)
                current = []
                unicode_offset += len(decoded)
        return words, word_tokens

    def _split_tokens_on_spaces(self, tokens: Sequence[int]):
        subwords, subword_tokens = self._split_tokens_on_unicode(tokens)
        words, word_tokens = [], []
        for sw, swt in zip(subwords, subword_tokens):
            special = swt[0] >= self.eot
            with_space = sw.startswith(" ")
            punctuation = sw.strip() in string.punctuation
            if special or with_space or punctuation or not words:
                words.append(sw)
                word_tokens.append(swt)
            else:
                words[-1] += sw
                word_tokens[-1].extend(swt)
        return words, word_tokens


def get_tokenizer(
    multilingual: bool,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
    vocab_path: Optional[str] = None,
) -> Tokenizer:
    """Build a tokenizer. ``vocab_path`` may point at a tiktoken ranks file
    (preferred; converters place one next to model weights); otherwise the
    byte-fallback vocab keeps the layout exact for weightless operation.

    Memoized: vocab construction reads/parses the ranks file, and the
    serving/dispatch paths request a tokenizer per batch group — the same
    (read-only) instance is shared. Callers needing a different language
    use ``dataclasses.replace`` (a fresh copy) as ``decode`` does.
    """
    if vocab_path is None:
        vocab_path = os.environ.get("WHISPERX_TPU_VOCAB")
    return _cached_tokenizer(
        multilingual,
        num_languages,
        language,
        task,
        vocab_path,
    )


@functools.lru_cache(maxsize=64)
def _cached_tokenizer(
    multilingual: bool,
    num_languages: int,
    language: Optional[str],
    task: Optional[str],
    vocab_path: Optional[str],
) -> Tokenizer:
    n_base = 50257 if multilingual else 50256
    if vocab_path == "gold-partial":
        vocab_path = default_partial_vocab_path()
    if vocab_path == "byte-fallback":
        # explicit hermetic opt-out (tests / debugging): ids = UTF-8 bytes
        return Tokenizer(
            vocab=ByteFallbackVocab(n_base),
            multilingual=multilingual,
            num_languages=num_languages,
            language=language,
            task=task,
        )
    if vocab_path and not os.path.exists(vocab_path):
        # a configured-but-missing path must fail loudly, not silently
        # decode byte soup for the whole session
        raise FileNotFoundError(
            f"vocab file {vocab_path!r} (from WHISPERX_TPU_VOCAB or the "
            "model checkpoint) does not exist"
        )
    if vocab_path:
        if vocab_path.endswith(".json"):
            vocab = PartialVocab(vocab_path, n_base)
        else:
            vocab = TikTokenVocab(vocab_path)
    elif multilingual and os.path.exists(default_partial_vocab_path()):
        # Weightless multilingual default: the recovered partial vocabulary
        # is EXACT where covered (byte alphabet + ~1.1k frequent tokens,
        # proven against the gold artifacts) and U+FFFD elsewhere — strictly
        # better than byte soup. A full ranks file (converted next to model
        # weights) still upgrades to the complete vocabulary.
        import warnings

        warnings.warn(
            "No vocab.tiktoken ranks file; using the recovered partial "
            "multilingual vocabulary (exact where covered, � "
            "elsewhere). Convert a checkpoint or set WHISPERX_TPU_VOCAB "
            "for full text fidelity.",
            stacklevel=2,
        )
        vocab = PartialVocab(default_partial_vocab_path(), n_base)
    else:
        vocab = ByteFallbackVocab(n_base)
    return Tokenizer(
        vocab=vocab,
        multilingual=multilingual,
        num_languages=num_languages,
        language=language,
        task=task,
    )
