"""A1111-compatible prompt syntax: attention emphasis, scheduling, AND (the
port's copy of ``mdu_tpu/text/prompt.py``, which is pure Python).

The reference leans on A1111's prompt_parser for all of this
(ref tile_utils/utils.py:116-148); here the grammar is owned:

  (text)        weight x1.1         [text]      weight /1.1
  (text:1.5)    explicit weight     \\( \\) \\[ \\]  literals
  [from:to:N]   switch at step N (fraction of steps when N < 1)
  [to:N]        add 'to' after N    [from::N]   drop 'from' after N
  a AND b:0.6   composable-diffusion branches with weights
  BREAK         force a new 75-token chunk
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

_ATTN_RE = re.compile(r"""
\\\(|\\\)|\\\[|\\\]|\\\\|\\:|
\(|\[|:\s*([+-]?[\d.]+)\s*\)|\)|\]|
[^\\()\[\]:]+|:
""", re.X)


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    """-> [(fragment, weight)] with nesting multiplied; merges equal-weight
    neighbors.  'BREAK' fragments are kept verbatim with weight -1."""
    res: List[Tuple[str, float]] = []
    round_stack: List[int] = []
    square_stack: List[int] = []

    def multiply_range(start: int, mult: float):
        for i in range(start, len(res)):
            res[i] = (res[i][0], res[i][1] * mult)

    for m in _ATTN_RE.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append((tok[1:], 1.0))
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif weight is not None and round_stack:
            multiply_range(round_stack.pop(), float(weight))
        elif tok == ")" and round_stack:
            multiply_range(round_stack.pop(), 1.1)
        elif tok == "]" and square_stack:
            multiply_range(square_stack.pop(), 1.0 / 1.1)
        else:
            parts = re.split(r"\bBREAK\b", tok)
            for i, p in enumerate(parts):
                if i > 0:
                    res.append(("BREAK", -1.0))
                if p:
                    res.append((p, 1.0))
    for pos in round_stack:
        multiply_range(pos, 1.1)
    for pos in square_stack:
        multiply_range(pos, 1.0 / 1.1)

    if not res:
        return [("", 1.0)]
    # merge runs with identical weight
    merged: List[Tuple[str, float]] = [res[0]]
    for frag, w in res[1:]:
        if frag == "BREAK" or merged[-1][0] == "BREAK":
            merged.append((frag, w))
        elif w == merged[-1][1]:
            merged[-1] = (merged[-1][0] + frag, w)
        else:
            merged.append((frag, w))
    return merged


_SCHED_RE = re.compile(r"\[([^\[\]]*?)\]")


def _resolve_schedule_step(when: str, steps: int) -> int:
    v = float(when)
    return int(round(v * steps)) if v < 1 else int(v)


def parse_prompt_schedule(text: str, steps: int) -> List[Tuple[int, str]]:
    """-> [(end_step, prompt)] ascending; the last entry ends at ``steps``.

    Supports nested-free '[from:to:when]' / '[to:when]' / '[from::when]'.
    """
    boundaries = {steps}

    def scan(t: str):
        for m in _SCHED_RE.finditer(t):
            parts = m.group(1).split(":")
            if len(parts) in (2, 3):
                try:
                    boundaries.add(_resolve_schedule_step(parts[-1], steps))
                except ValueError:
                    pass

    scan(text)
    sched: List[Tuple[int, str]] = []
    for end in sorted(b for b in boundaries if 0 < b <= steps):
        sched.append((end, _prompt_at_step(text, end - 1, steps)))
    # deduplicate consecutive identical prompts
    out: List[Tuple[int, str]] = []
    for end, p in sched:
        if out and out[-1][1] == p:
            out[-1] = (end, p)
        else:
            out.append((end, p))
    if not out or out[-1][0] != steps:
        out.append((steps, _prompt_at_step(text, steps - 1, steps)))
    return out


def _prompt_at_step(text: str, step: int, steps: int) -> str:
    def repl(m: re.Match) -> str:
        parts = m.group(1).split(":")
        if len(parts) == 3:
            frm, to, when = parts
        elif len(parts) == 2:
            frm, to, when = "", parts[0], parts[1]
        else:
            return m.group(0)
        try:
            boundary = _resolve_schedule_step(when, steps)
        except ValueError:
            return m.group(0)
        return to if step >= boundary else frm

    prev = None
    while prev != text:
        prev = text
        text = _SCHED_RE.sub(repl, text)
    return text


_ALT_RE = re.compile(r"\[([^\[\]:]+\|[^\[\]:]+)\]")


def has_alternation(text: str) -> bool:
    return _ALT_RE.search(text) is not None


def prompt_at_step_with_alternation(text: str, step: int, steps: int) -> str:
    """Resolve `[a|b|c]` alternating-words syntax (A1111: option step % n)
    plus the regular [from:to:N] scheduling for one step."""

    def repl(m: re.Match) -> str:
        options = m.group(1).split("|")
        return options[step % len(options)]

    prev = None
    while prev != text:
        prev = text
        text = _ALT_RE.sub(repl, text)
    return _prompt_at_step(text, step, steps)


@dataclass(frozen=True)
class ComposablePrompt:
    text: str
    weight: float = 1.0


_NETWORK_RE = re.compile(r"<(\w+):([^:>]+)(?::([^>]*))?>")


def extract_networks(text: str):
    """Strip `<lora:name:weight>`-style extra-network tags (A1111 syntax;
    the reference consumes them via extra_networks.parse_prompts, ref
    tile_utils/utils.py:123-131).  -> (clean_text, [(kind, name, weight)])."""
    found = []

    def repl(m: re.Match) -> str:
        kind, name, w = m.group(1), m.group(2), m.group(3)
        try:
            weight = float(w) if w not in (None, "") else 1.0
        except ValueError:
            weight = 1.0
        found.append((kind, name, weight))
        return ""

    clean = _NETWORK_RE.sub(repl, text)
    return re.sub(r"\s{2,}", " ", clean).strip(), found


_AND_RE = re.compile(r"\bAND\b")
_AND_W_RE = re.compile(r"^(.*?)(?::\s*([+-]?[\d.]+)\s*)?$", re.S)


def split_composable(text: str) -> List[ComposablePrompt]:
    """'a AND b:0.5' -> [('a',1.0), ('b',0.5)] (composable diffusion)."""
    out = []
    for part in _AND_RE.split(text):
        m = _AND_W_RE.match(part.strip())
        body = m.group(1).strip()
        w = float(m.group(2)) if m.group(2) is not None else 1.0
        out.append(ComposablePrompt(body, w))
    return out


# ----------------------------------------------------------------- styles


def load_styles(csv_path: str) -> dict:
    """A1111 styles.csv -> {name: (prompt, negative_prompt)}.

    The reference applies styles via shared.prompt_styles
    (ref tile_utils/utils.py:106-109 Prompt.apply_styles)."""
    import csv

    out = {}
    with open(csv_path, encoding="utf-8-sig", newline="") as f:
        for row in csv.DictReader(f):
            name = (row.get("name") or "").strip()
            if not name or name == "None":
                continue
            out[name] = (row.get("prompt") or "", row.get("negative_prompt") or "")
    return out


def apply_styles(prompt: str, negative: str, styles, table: dict):
    """A1111 apply_styles_to_prompt semantics: a style prompt containing
    '{prompt}' substitutes the user prompt into the placeholder; otherwise
    it appends ', style'.  Negatives always append."""
    for name in styles or ():
        sp, sn = table.get(name, ("", ""))
        if sp:
            prompt = sp.replace("{prompt}", prompt) if "{prompt}" in sp \
                else (f"{prompt}, {sp}" if prompt else sp)
        if sn:
            negative = f"{negative}, {sn}" if negative else sn
    return prompt, negative
