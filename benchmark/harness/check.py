"""The check that decides ``correct``: what the timed path served, held
against the plain reference, once the window has closed and the program's
state is freed.

A sample of the requests that finished (drawn from the seed, the longest
always in it) is read back into tokens. The reference cuts each request's
audio into windows again (energy VAD, merge). Without timestamps (the
configurations' ``without_timestamps``, WhisperX's own setting) each window
serves one segment spanning it, whose text is every token decoded, so every
position of the decode is compared; a window that served fewer than
``sample_len`` tokens stopped because it chose EOT, and EOT is compared at
the next position. With timestamps, every served segment must sit on its
window's 20 ms timestamp grid (to the millisecond the result is rounded to,
twice over on the serving path): its start and end are timestamp tokens,
its text the text tokens (``vocab.py``), and a window's tokens are its
segments' in order, up to the first end the pipeline clamped to the
window's audio (that timestamp is not in the result, nor anything after
it). The reference then runs each window's log-mel, encoder, int8 cross-KV
and teacher-forced decoder in float32, and each served token's gap under
the decoding rules is compared (``reference/rules.py``).

Numbers compared, each beside its limit (the cell's ``limits``):
``max_gap``, the widest gap in logit units; ``off_grid``, served segments
that fit no reference window (its span, or with timestamps its grid);
``empty_windows``, reference windows with no served segment (with
timestamps, of those longer than the first timestamp's bound): a window
left out of its batch; ``failed``, requests of the window that failed or
never came. Beside them: ``tokens``, the positions compared, ``deepest``,
the most in one window, and ``mean_gap``, the mean gap over them.

A configuration that aligns (``align``) is checked on its aligned words too
(``compare_alignment``): each sampled request's transcript segments, and
the segments ``alignment.align`` returned for them with their characters
(``traffic/offline_words.py`` always asks for them), are held against
``reference/wav2vec2.py``'s float32 emissions of the same slice of audio
in the same bucket and ``reference/ctc.py``'s path through them. A served character's frames are
read back from its times (each is ``start + frame × ratio`` rounded to the
millisecond, which keeps the frame). Numbers compared: ``align_score_gap``,
the widest gap between a served character's score and the reference's
probability over the same frames, beyond the 5e-4 that ``align``'s
rounding to 3 decimals makes (a word's score is the rounded mean of its
letters' rounded scores, held exactly below); ``align_path_gap``, the
widest margin, in nats of the reference's trellis over its emissions, by
which WhisperX's beam backtrack would have to be swayed to take a served
path (``ctc.path_margin``): 0 where it takes the reference's own path, the
size of the emissions' rounding where a near-tie in the beams' ranking
went the other way, and the size of the trellis's steps for a wrong path
(+inf where a segment's characters' times do not tile its frames, or where
the reference finds no path and the program timed one). The gap of the
path's log-probability to the reference's path, which the backtrack does
not maximise (it ranks its beams by the trellis alone), moves by whole
nats at a near-tie, so it cannot tell a near-tie from a wrong path;
``align_missing``, transcript words with alignable letters that came back
without times, or with times or a score that are not their letters' (their
span, the rounded mean of their scores), in segments the reference aligns
(exact). Beside them: ``align_chars`` and ``align_words``, the characters
and words compared, and ``align_unaligned``, the segments whose characters
outnumber their frames, which neither side can align.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from harness import vocab
from reference import ctc, frontend, rules
from reference import wav2vec2 as w2v
from reference.params import align_dims, dims_of, make_align_weights, make_weights
from reference.whisper import Model

SR = 16000
TOL_S = 0.0011  # a time rounded to the millisecond, twice
SCORE_ROUNDING = 5e-4  # ``align`` rounds its scores to 3 decimals


def sample(requests: List[dict], seed: int, max_requests: int, max_audio_s: float) -> List[dict]:
    """Finished requests: the longest, then others in an order drawn from
    the seed, while the count and the audio stay within the caps."""
    done = [r for r in requests if "result" in r and not r.get("error")]
    if not done:
        return []
    longest = max(done, key=lambda r: r["n"])
    out, total = [longest], longest["n"] / SR
    for i in np.random.default_rng([seed, 4]).permutation(len(done)):
        r = done[i]
        if r is longest or len(out) >= max_requests:
            continue
        if total + r["n"] / SR <= max_audio_s:
            out.append(r)
            total += r["n"] / SR
    return out


def _on_grid(t: float, start: float) -> Optional[int]:
    p = round((t - start) / 0.02)
    return p if abs(t - (start + p * 0.02)) <= TOL_S else None


def served_tokens(segments: List[dict], chunks: List[Tuple[float, float]],
                  sp: rules.Specials, letters: Optional[str] = None) -> Tuple[Dict[int, List[int]], int]:
    """Each window's served tokens (window index → ids) and the count of
    segments off every window's grid. An end off the grid at the window's
    end was clamped: its timestamp is unknown and no segment may follow. An
    end on the grid there is either; a segment after it shows it was not
    clamped, and its timestamp is then taken."""
    per: Dict[int, List[int]] = {}
    state: Dict[int, object] = {}  # window → "clamped", or the pending end's position
    off = 0
    for seg in segments:
        c = max((i for i, (s, _) in enumerate(chunks) if s - TOL_S <= seg["start"]), default=None)
        if c is None or state.get(c) == "clamped":
            off += 1
            continue
        s, e = chunks[c]
        ps = _on_grid(seg["start"], s)
        ids = vocab.token_ids(seg["text"], letters)
        if ps is None or ids is None or seg["start"] >= e + TOL_S:
            off += 1
            continue
        toks = per.setdefault(c, [])
        if isinstance(state.get(c), int):
            toks.append(sp.timestamp_begin + state.pop(c))
        toks += [sp.timestamp_begin + ps] + ids
        pe = _on_grid(seg["end"], s)
        at_end = abs(seg["end"] - e) <= TOL_S
        if pe is None:
            off += 0 if at_end else 1
            state[c] = "clamped"
        elif at_end:
            state[c] = pe
        else:
            toks.append(sp.timestamp_begin + pe)
    return per, off


def served_text(segments: List[dict], chunks: List[Tuple[float, float]],
                letters: Optional[str] = None) -> Tuple[Dict[int, List[int]], int]:
    """Without timestamps: each window's served tokens (window index → ids)
    and the count of segments that span no window, or a window twice."""
    per: Dict[int, List[int]] = {}
    off = 0
    for seg in segments:
        c = next((i for i, (s, e) in enumerate(chunks)
                  if abs(seg["start"] - s) <= TOL_S and abs(seg["end"] - e) <= TOL_S), None)
        ids = vocab.token_ids(seg["text"], letters)
        if c is None or c in per or ids is None:
            off += 1
            continue
        per[c] = ids
    return per, off


def compare(sampled: List[dict], audio_of: Callable[[dict], np.ndarray], config: dict, seed: int,
            device, sample_len: int, control: bool = False, block: int = 8) -> Dict[str, float]:
    """The numbers ``correct`` is decided on. With ``control``, the fp8
    control takes the program's place: at each position of the served
    tokens its own choice is judged (``max_gap``), and the program's widest
    gap over the same positions is kept beside it (``program_gap``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp = rules.Specials.of(config)
    dims = dims_of(config)
    letters = vocab.alphabet(config)
    first_ts_s = config["asr_options"]["max_initial_timestamp"] + 0.02 if sp.timestamps else 0.0
    work = []  # (audio, window, tokens)
    off = empty = 0
    for r in sampled:
        audio = audio_of(r)
        chunks = frontend.chunks_of(audio)
        if sp.timestamps:
            per, o = served_tokens(r["result"]["segments"], chunks, sp, letters)
        else:
            per, o = served_text(r["result"]["segments"], chunks, letters)
            per = {i: t + [sp.eot] if len(t) < sample_len else t for i, t in per.items()}
        off += o
        empty += sum(1 for i, (s, e) in enumerate(chunks) if e - s > first_ts_s and not per.get(i))
        work += [(audio, chunks[i], toks) for i, toks in sorted(per.items()) if toks]
    out = {"off_grid": float(off), "empty_windows": float(empty), "max_gap": 0.0, "tokens": 0.0,
           "deepest": 0.0, "mean_gap": 0.0}
    if control:
        out.update(program_gap=0.0, program_mean_gap=0.0)
    weights = {k: v.float() for k, v in make_weights(config, seed, device).items()}
    models = [Model(weights, dims)] + ([Model(weights, dims, lowp=True)] if control else [])
    with torch.no_grad():
        for b in range(0, len(work), block):
            part = work[b:b + block]
            rows = np.concatenate([frontend.window_rows(a, [ch]) for a, ch, _ in part])
            mel = frontend.log_mel(torch.from_numpy(rows).to(device), dims["n_mels"])
            cross = [m.cross_kv(m.encode(mel)) for m in models]
            for i, (_, _, toks) in enumerate(part):
                seq = list(sp.initial) + toks
                n_init, n = len(sp.initial), len(toks)
                x = torch.as_tensor([seq[:-1]], device=device)
                ref = models[0].logits(x, [(k[i:i + 1], v[i:i + 1]) for k, v in cross[0]])[0, n_init - 1:]
                g = rules.gaps(ref, seq, n_init, sp)
                out["tokens"] += n
                out["deepest"] = max(out["deepest"], float(n))
                if control:
                    out["program_gap"] = max(out["program_gap"], float(g.max()))
                    out["program_mean_gap"] += float(g.sum())
                    low = models[1].logits(x, [(k[i:i + 1], v[i:i + 1]) for k, v in cross[1]])[0, n_init - 1:]
                    g = rules.gaps(ref, seq, n_init, sp, choose=rules.choices(low, seq, n_init, sp))
                out["max_gap"] = max(out["max_gap"], float(g.max()))
                out["mean_gap"] += float(g.sum())
            del cross, mel
    for k in ("mean_gap", "program_mean_gap"):
        if k in out and out["tokens"]:
            out[k] /= out["tokens"]
    return out


class _Served:
    """One segment as aligned: its path ``js`` (None where it came back
    unaligned), its characters' scores, and for each word its letters'
    positions and whether its times and score are its letters'."""

    def __init__(self, js, char_scores, words):
        self.js, self.char_scores, self.words = js, char_scores, words

    @classmethod
    def unaligned(cls, words) -> "_Served":
        return cls(None, None, [(letters, False) for _, letters in words])


def _words(text: str, kept: List[int], language: str) -> List[Tuple[str, List[int]]]:
    """The words ``align`` reports, in order: (text, its letters' positions
    among the kept characters). A character starts a new word after a
    space, or every character where the language has no spaces."""
    pos = {i: p for p, i in enumerate(kept)}
    groups: List[List[int]] = [[]]
    for i, ch in enumerate(text):
        groups[-1].append(i)
        if language in ctc.LANGUAGES_WITHOUT_SPACES or i == len(text) - 1 or text[i + 1] == " ":
            groups.append([])
    out = []
    for g in groups:
        w = "".join(text[i] for i in g).strip()
        if w:
            out.append((w, [pos[i] for i in g if text[i] != " " and i in pos]))
    return out


def _read_served(seg: dict, aligned: dict, kept: List[int], n_frames: int, words) -> Optional[_Served]:
    """The program's aligned segment as a path and scores; None where its
    characters' times do not tile the frames."""
    t1 = seg["start"]
    ratio = (seg["end"] - t1) / max(n_frames - 1, 1)
    chars = [c for c in aligned.get("chars") or [] if "start" in c]
    if not chars:
        return _Served.unaligned(words)
    if len(chars) != len(kept):
        return None
    frames = []
    for c in chars:
        s, e = round((c["start"] - t1) / ratio), round((c["end"] - t1) / ratio)
        if round(s * ratio + t1, 3) != c["start"] or round(e * ratio + t1, 3) != c["end"] or s >= e:
            return None
        frames.append((s, e))
    starts, ends = [s for s, _ in frames], [e for _, e in frames]
    if starts[0] != 0 or ends[-1] != n_frames or starts[1:] != ends[:-1]:
        return None
    js = np.zeros(n_frames, np.int64)
    for k, (s, e) in enumerate(frames):
        js[s:e] = k
    out_words = []
    got = list(aligned.get("words") or [])
    for n, (w, letters) in enumerate(words):
        sw = got[n] if n < len(got) and got[n].get("word") == w else None
        sound = (sw is not None and bool(letters) and all("score" in chars[p] for p in letters)
                 and sw.get("start") == min(chars[p]["start"] for p in letters)
                 and sw.get("end") == max(chars[p]["end"] for p in letters)
                 and sw.get("score") == round(float(np.mean([chars[p]["score"] for p in letters])), 3))
        out_words.append((letters, sound))
    return _Served(js, np.asarray([c.get("score", np.inf) for c in chars], np.float64), out_words)


def _control_served(em: np.ndarray, tokens: List[int], blank: int, words) -> _Served:
    """The control in the program's place: WhisperX's path through its own
    emissions, scores rounded as ``align`` rounds them."""
    js = ctc.align(em, tokens, blank)
    if js is None:
        return _Served.unaligned(words)
    cs = np.round(ctc.char_scores(em, tokens, blank, js), 3)
    return _Served(js, cs, [(letters, bool(letters)) for _, letters in words])


def _judge(em: np.ndarray, tokens: List[int], blank: int, served: Optional[_Served],
           words, out: Dict[str, float], prefix: str = "") -> None:
    """Adds one segment's readings to ``out`` (``prefix`` names the
    program's own beside the control's)."""
    tr = ctc.trellis(em, tokens, blank)
    ref_js = ctc.backtrack(tr)
    if ref_js is None:
        if not prefix:
            out["align_unaligned"] += 1
        if served is None or served.js is not None:
            out[prefix + "align_path_gap"] = float("inf")
        return
    if served is None:
        out[prefix + "align_path_gap"] = float("inf")
        return
    alignable = [letters for _, letters in words if letters]
    if served.js is None:
        out[prefix + "align_missing"] += len(alignable)
        return
    key = prefix + "align_path_gap"
    out[key] = max(out[key], ctc.path_margin(tr, served.js))
    out[prefix + "align_missing"] += sum(1 for letters, sound in served.words if letters and not sound)
    gap = float(np.abs(served.char_scores - ctc.char_scores(em, tokens, blank, served.js)).max())
    key = prefix + "align_score_gap"
    out[key] = max(out[key], gap - SCORE_ROUNDING)
    if not prefix:
        out["align_chars"] += len(tokens)
        out["align_words"] += len(alignable)


def compare_alignment(sampled: List[dict], audio_of: Callable[[dict], np.ndarray], config: dict, seed: int,
                      device, control: bool = False) -> Dict[str, float]:
    """The aligned words' numbers (the module's docstring). With
    ``control``, the bfloat16 control (``reference/wav2vec2.py``,
    ``lowp``) takes the aligner's place, the Whisper half as the program
    served it, and the program's own readings are kept beside it
    (``program_align_score_gap``, ``program_align_path_gap``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a = config["align"]
    language = config["language"]
    dictionary = {k.lower(): v for k, v in a["dictionary"].items()}
    blank = ctc.blank_of(dictionary)
    dims = align_dims(config)
    out = {"align_score_gap": 0.0, "align_path_gap": 0.0, "align_missing": 0.0, "align_chars": 0.0,
           "align_words": 0.0, "align_unaligned": 0.0}
    if control:
        out.update(program_align_score_gap=0.0, program_align_path_gap=0.0, program_align_missing=0.0)
    work = []  # (audio slice, tokens, words, the program's segment as served)
    for r in sampled:
        audio = audio_of(r)
        transcript = r["result"]["segments"]
        aligned = list((r["result"].get("aligned") or {}).get("segments") or [])
        k = 0
        for seg in transcript:
            kept, tokens = ctc.clean(seg["text"], dictionary, language)
            words = _words(seg["text"], kept, language)
            match = aligned[k] if k < len(aligned) and aligned[k].get("text") == seg["text"] else None
            k += match is not None
            if not tokens or seg["start"] >= len(audio) / SR:
                continue
            w = audio[int(seg["start"] * SR):int(seg["end"] * SR)]
            w = np.pad(w, (0, max(0, w2v.MIN_SAMPLES - len(w))))
            n_frames = w2v.frames_of(dims, len(w))
            served = _read_served(seg, match, kept, n_frames, words) if match is not None else _Served.unaligned(words)
            work.append((w, tokens, words, served))
        for extra in aligned[k:]:  # aligned segments no transcript segment gave
            out["align_missing"] += len(extra.get("words") or [1])
    weights = make_align_weights(config, seed, device)
    ems = w2v.Model(weights, dims).emissions([w for w, *_ in work], device)
    lows = w2v.Model(weights, dims, lowp=True).emissions([w for w, *_ in work], device) if control else None
    del weights
    for i, (_, tokens, words, served) in enumerate(work):
        if control:
            _judge(ems[i], tokens, blank, served, words, out, prefix="program_")
            served = _control_served(lows[i], tokens, blank, words)
        _judge(ems[i], tokens, blank, served, words, out)
    return out
