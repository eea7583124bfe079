"""Prompt -> cond conditioning (counterpart of ``mdu_tpu/text/conditioning.py``).

Emphasis-weighted CLIP embeddings (weights multiply the token embeddings,
then the chunk's overall mean is restored, as A1111 does), 75-token chunks
with BREAK, scheduled prompts and alternating words as per-step banks,
AND composition, and region conds (the region prompt appended to the base
prompt, ref Prompt.append_prompt utils.py:112-114).

``cond`` returns one of the forms ``DiffusionPipeline`` takes:

  {"crossattn": [1, n*77, D], **extra}                       a plain cond
  {"__bank__": {"crossattn": [S, n*77, D]},
   "__index__": int32 [steps], **extra}                      bank[index[step]]
  {"__and__": [cond, ...], "__weights__": (w, ...)}          AND branches
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device
from ..models.clip import CLIPTextModel
from .prompt import (extract_networks, has_alternation, parse_prompt_attention,
                     parse_prompt_schedule, prompt_at_step_with_alternation, split_composable)
from .tokenizer import HashTokenizer

Cond = Dict[str, Any]
CondOrFn = Union[Cond, Callable]


class TextConditioner:
    """``model`` (holding its weights) and a tokenizer (``HashTokenizer`` when
    none is given) on ``device``: the card unless the caller names another."""

    def __init__(self, model: CLIPTextModel, tokenizer=None, chunk_size: int = 75,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer or HashTokenizer(model.cfg.vocab_size, model.cfg.max_length)
        self.chunk = min(chunk_size, model.cfg.max_length - 2)
        self.last_networks: List[Tuple[str, str, float]] = []

    # ------------------------------------------------------------- encoding

    def _weighted_ids(self, text: str) -> List[Tuple[List[int], List[float]]]:
        """-> per-chunk (ids, weights), bos, eot and padding included."""
        tok = self.tokenizer
        pieces: List[Tuple[int, float]] = []
        chunks: List[Tuple[List[int], List[float]]] = []

        def flush():
            full = [tok.bos] + [p[0] for p in pieces] + [tok.eot]
            full += [tok.pad_token] * (tok.max_length - len(full))
            wfull = [1.0] + [p[1] for p in pieces] + [1.0]
            wfull += [1.0] * (tok.max_length - len(wfull))
            chunks.append((full, wfull))
            pieces.clear()

        for frag, w in parse_prompt_attention(text):
            if frag == "BREAK":
                if pieces:
                    flush()
                continue
            for tid in tok.tokenize(frag):
                pieces.append((tid, w))
                if len(pieces) == self.chunk:
                    flush()
        # the last chunk only if it has tokens or nothing was emitted (A1111)
        if pieces or not chunks:
            flush()
        return chunks

    @torch.inference_mode()
    def encode(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (crossattn [B, n_chunks * 77, D] fp32, pooled [B, D']), every
        prompt padded with empty chunks to the batch's chunk count; the
        pooled state is each prompt's first chunk's. All chunks of all
        prompts go through the model in one call."""
        per_text = [self._weighted_ids(t) for t in texts]
        n_chunks = max(len(c) for c in per_text)
        tok = self.tokenizer
        empty = ([tok.bos, tok.eot] + [tok.pad_token] * (tok.max_length - 2),
                 [1.0] * tok.max_length)
        chunks = [c for cs in per_text for c in cs + [empty] * (n_chunks - len(cs))]
        ids = torch.tensor([c[0] for c in chunks], dtype=torch.long, device=self.device)
        w = torch.tensor([c[1] for c in chunks], dtype=torch.float32,
                         device=self.device)[:, :, None]
        z, pooled = self.model(ids)
        z = z.float()
        mean0 = z.mean(dim=(1, 2), keepdim=True)
        z = z * w
        new_mean = z.mean(dim=(1, 2), keepdim=True)
        # A1111's mean restoration, guarded against means of about 0
        ratio = torch.where(new_mean.abs() > 1e-7, mean0 / new_mean, torch.ones_like(mean0))
        z = (z * ratio).reshape(len(texts), n_chunks * z.shape[1], z.shape[2])
        return z, pooled[::n_chunks]

    # ----------------------------------------------------------- cond trees

    def cond(self, prompt: str, steps: Optional[int] = None,
             extra: Optional[Cond] = None) -> CondOrFn:
        """The cond of ``prompt``: a bank when it schedules ([a:b:N]) or
        alternates ([a|b]) and ``steps`` is given, an AND cond when it has AND
        branches (each encoded on its own; their chunk counts must agree),
        else a plain cond. ``<lora:...>`` tags are stripped and left in
        ``last_networks``."""
        extra = extra or {}
        prompt, networks = extract_networks(prompt)
        self.last_networks = networks
        parts = split_composable(prompt)
        if len(parts) > 1:
            return {"__and__": [self.cond(p.text, steps, extra) for p in parts],
                    "__weights__": tuple(p.weight for p in parts)}
        if steps is not None and has_alternation(prompt):
            per_step = [prompt_at_step_with_alternation(prompt, i, steps) for i in range(steps)]
            uniq = list(dict.fromkeys(per_step))
            bank, _ = self.encode(uniq)
            idx = torch.tensor([uniq.index(p) for p in per_step], dtype=torch.int32)
            return {"__bank__": {"crossattn": bank}, "__index__": idx, **extra}
        if steps is not None:
            sched = parse_prompt_schedule(prompt, steps)
            if len(sched) > 1:
                bank, _ = self.encode([p for _, p in sched])      # [S, L, D]
                idx = torch.zeros(steps, dtype=torch.int32)
                start = 0
                for v, (end, _) in enumerate(sched):
                    idx[start:end] = v
                    start = end
                return {"__bank__": {"crossattn": bank}, "__index__": idx, **extra}
            # a one-entry schedule ([a:b:N] with N >= steps): the resolved text
            prompt = sched[0][1]
        z, _ = self.encode([prompt])
        return {"crossattn": z, **extra}

    def pair(self, prompt: str, neg_prompt: str = "",
             steps: Optional[int] = None) -> Tuple[CondOrFn, CondOrFn]:
        return self.cond(prompt, steps), self.cond(neg_prompt, steps)

    def region_pair(self, base_prompt: str, region_prompt: str, region_neg: str = "",
                    base_neg: str = "", steps: Optional[int] = None
                    ) -> Tuple[CondOrFn, CondOrFn]:
        """A region's cond: the base prompt with ', region prompt' appended
        (ref Condition.get_custom_cond, utils.py:121-127); the region's
        negative appended to the base negative likewise."""
        p = f"{base_prompt}, {region_prompt}" if region_prompt else base_prompt
        n = f"{base_neg}, {region_neg}" if region_neg else base_neg
        return self.cond(p, steps), self.cond(n, steps)
