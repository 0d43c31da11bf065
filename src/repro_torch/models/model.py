"""The language model on the fused paged path, counterpart of
``repro.models.model.LM``.

Parameter tree, the JAX layout:
  {"embed": (V, d), "final_norm": (d,), "groups": (g0, g1, ...),
   ["lm_head": (d, V) when embeddings are not tied]}
Each group gi = {"scan": {"b<j>": params stacked over n_periods}}. A
Python loop over the periods takes the place of ``lax.scan``; each
layer's pool is a contiguous slice of its group's stacked pool tensor and
is updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.attention import init_pool
from repro_torch.models.common import embed_init, rms_norm, softcap
from repro_torch.utils.tree import tree_map


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.n_codebooks or any(b.kind == "shared_attn"
                                  for b in cfg.blocks):
            raise NotImplementedError("multi-codebook heads and shared "
                                      "blocks are not ported yet")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype: torch.dtype,
             device) -> dict:
        """Random weights from ``generator`` in the JAX init's
        distributions (the numbers differ: weights cross from JAX only
        through ``models.bridge.from_jax_params``)."""
        cfg = self.cfg
        kw = dict(dtype=dtype, device=device)
        params = {"embed": embed_init(generator,
                                      (cfg.vocab_size, cfg.d_model), **kw),
                  "final_norm": torch.zeros((cfg.d_model,), **kw)}
        groups = []
        for g in cfg.groups:
            periods = [{f"b{j}": B.init_block(generator, cfg, blk, **kw)
                        for j, blk in enumerate(g.period)}
                       for _ in range(g.n_periods)]
            groups.append({"scan": tree_map(lambda *xs: torch.stack(xs),
                                            *periods)})
        params["groups"] = tuple(groups)
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(
                generator, (cfg.d_model, cfg.vocab_size), **kw)
        return params

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, tokens):
        """tokens: (N,) int -> (N, d)."""
        return params["embed"][tokens.long()]

    def logits(self, params, hidden):
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        return softcap(hidden @ w, self.cfg.final_logit_softcap)

    # ------------------------------------------------------------------
    # Paged pools and the fused iteration
    # ------------------------------------------------------------------
    def init_cache(self, n_pages: int, page_size: int, *,
                   dtype: torch.dtype, device):
        """Zeroed page pools: per group {"b<j>": {"k","v"}}, each leaf
        (n_periods, n_pages, page, Hkv, hd) — the JAX layout."""
        return tuple(
            {f"b{j}": init_pool(blk.attn, n_pages, page_size, dtype=dtype,
                                device=device, periods=g.n_periods)
             for j, blk in enumerate(g.period)}
            for g in self.cfg.groups)

    def forward_mixed_paged(self, params, tokens, tok_seq, tok_pos, q_last,
                            pools, block_tables, sampling=None, *,
                            window_override="cfg"):
        """One scheduler iteration's every prefill-chunk token and decode
        token as one ragged batch (DESIGN.md §10): per layer one
        kv_append into the pools and one ragged paged-attention pass,
        then greedy argmax on the device, so only int32 ids need to cross
        to the host.

        tokens (N,) int32 flat token ids; tok_seq (N,) int32 block-table
        row of each token; tok_pos (N,) int32 absolute position (-1 marks
        a padded row); q_last (B,) int32 flat index of each sequence's
        last real token; pools as from init_cache, written in place;
        block_tables (B, max_pages) int32. ``sampling`` other than None
        (greedy) is not ported yet.

        Returns (sampled (B,) int32, logits (B, V), pools).
        """
        if sampling is not None:
            raise NotImplementedError("stochastic sampling is not ported "
                                      "yet; only greedy (sampling=None)")
        cfg = self.cfg
        x = self.embed(params, tokens)
        ctx = {"block_tables": block_tables, "tok_seq": tok_seq,
               "tok_pos": tok_pos, "window_override": window_override}
        for gi, g in enumerate(cfg.groups):
            scan = params["groups"][gi]["scan"]
            for layer in range(g.n_periods):
                for j, blk in enumerate(g.period):
                    pj = tree_map(lambda t: t[layer], scan[f"b{j}"])
                    pool = {k: v[layer]
                            for k, v in pools[gi][f"b{j}"].items()}
                    x = B.block_mixed_paged(pj, cfg, blk, x, pool, ctx)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self.logits(params, x[q_last.long()])
        sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        return sampled, logits, pools
