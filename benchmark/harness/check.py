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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from harness import vocab
from reference import frontend, rules
from reference.params import dims_of, make_weights
from reference.whisper import Model

SR = 16000
TOL_S = 0.0011  # a time rounded to the millisecond, twice


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
                  sp: rules.Specials) -> Tuple[Dict[int, List[int]], int]:
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
        ids = vocab.token_ids(seg["text"])
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


def served_text(segments: List[dict], chunks: List[Tuple[float, float]]) -> Tuple[Dict[int, List[int]], int]:
    """Without timestamps: each window's served tokens (window index → ids)
    and the count of segments that span no window, or a window twice."""
    per: Dict[int, List[int]] = {}
    off = 0
    for seg in segments:
        c = next((i for i, (s, e) in enumerate(chunks)
                  if abs(seg["start"] - s) <= TOL_S and abs(seg["end"] - e) <= TOL_S), None)
        ids = vocab.token_ids(seg["text"])
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
    first_ts_s = config["asr_options"]["max_initial_timestamp"] + 0.02 if sp.timestamps else 0.0
    work = []  # (audio, window, tokens)
    off = empty = 0
    for r in sampled:
        audio = audio_of(r)
        chunks = frontend.chunks_of(audio)
        if sp.timestamps:
            per, o = served_tokens(r["result"]["segments"], chunks, sp)
        else:
            per, o = served_text(r["result"]["segments"], chunks)
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
