"""The language model: the full-sequence forward and its loss
(training), the prefill's decode-ready caches, single-token decode and
chunked prefill over them (the gather path), and the paged paths — the
fused mixed-batch iteration and the per-call decode and chunked prefill —
counterpart of ``repro.models.model.LM``.

Parameter tree, the JAX layout:
  {"embed": (V, d), "final_norm": (d,), "groups": (g0, g1, ...),
   ["lm_head": (d, V) when embeddings are not tied]}
Each group gi = {"scan": {"b<j>": params stacked over n_periods}}. A
Python loop over the periods takes the place of ``lax.scan``; each
layer's pool is a contiguous slice of its group's stacked pool tensor and
is updated in place. Decode caches (``init_cache``, ``forward``'s
``return_cache_len``, ``decode_step``, ``extend_step``) are stacked over
the periods the same way: an attention block's slotted K/V (n_periods,
B, S, Hkv, hd), an SSM block's state; ``decode_step`` and
``extend_step`` return new ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.common import (chunked_cross_entropy,
                                       cross_entropy_logits, embed_init,
                                       rms_norm, softcap)
from repro_torch.utils import threefry
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass
class ForwardOut:
    hidden: Any            # (B, T, d) final hidden states (pre-head)
    aux_loss: Any          # scalar (MoE load balance summed over layers)
    cache: Any             # decode cache (SSM states) or None


def sample_tokens(flat_logits, temps, top_ks, top_ps, seeds, positions):
    """Per-row token sampling, shared by the fused on-device path and the
    per-call paths (DESIGN.md §11); the reference's op order.

    flat_logits (B, V); temps (B,) float32, <= 0 means greedy argmax;
    top_ks (B,) int, <= 0 means the full vocabulary; top_ps (B,) float32,
    values outside (0, 1) disable the nucleus; seeds (B,) int32;
    positions (B,) int32, the context index the sampled token will take.

    A stochastic row keeps the top k logits (ties at the k-th kept), then
    the smallest prefix of the temperature-scaled distribution, sorted
    descending, whose mass reaches top_p (ties at its last logit kept),
    and takes the argmax of ``perturbed_scores``. Its Gumbel noise is
    keyed only by (seed, position), so a request's stream is a function
    of its context, seed and positions alone, the same under every
    policy, batch and path.
    """
    scores, greedy = perturbed_scores(flat_logits, temps, top_ks, top_ps,
                                      seeds, positions)
    stoch = torch.argmax(scores, dim=-1).to(torch.int32)
    return torch.where(temps > 0, stoch, greedy)


def perturbed_scores(flat_logits, temps, top_ks, top_ps, seeds, positions):
    """``sample_tokens``' scores and greedy ids: (B, V) float32, the
    logits kept by top-k and the nucleus over the temperature (-inf
    elsewhere) plus Gumbel noise from threefry, bit for bit the
    reference's ``fold_in(PRNGKey(seed), position)`` draw; and the
    argmax of the logits, (B,) int32."""
    flat = flat_logits.float()
    V = flat.shape[1]
    greedy = torch.argmax(flat, dim=-1).to(torch.int32)
    k = torch.where(top_ks > 0, top_ks, V).long()
    srt = torch.sort(flat, dim=-1, descending=True).values
    kth = srt.gather(1, (k - 1).clamp(0, V - 1)[:, None])
    masked = torch.where(flat >= kth, flat, -torch.inf)     # ties kept
    # the nucleus over softmax(srt / t) as jax.nn.softmax computes it;
    # disabled rows get p = 2.0, above any cumulative mass, so every token
    # survives
    t = torch.clamp(temps.float(), min=1e-6)[:, None]
    p = torch.where((top_ps > 0) & (top_ps < 1), top_ps.float(), 2.0)[:, None]
    z = srt / t
    unnorm = torch.exp(z - z.amax(dim=-1, keepdim=True))
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    pth = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
    masked = torch.where(flat >= pth, masked, -torch.inf)
    key = threefry.fold_in(threefry.prng_key(seeds), positions)
    return masked / t + threefry.gumbel(key, V), greedy


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
            # each group's stacked leaves are allocated once and each
            # period's leaves written into them as they are made, so the
            # init holds one period beside the weights
            stacked = None
            for layer in range(g.n_periods):
                period = {f"b{j}": B.init_block(generator, cfg, blk, **kw)
                          for j, blk in enumerate(g.period)}
                if stacked is None:
                    stacked = tree_map(
                        lambda t: t.new_empty((g.n_periods, *t.shape)),
                        period)
                tree_map(lambda dst, t: dst[layer].copy_(t), stacked, period)
                del period
            groups.append({"scan": stacked})
        params["groups"] = tuple(groups)
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(
                generator, (cfg.d_model, cfg.vocab_size), **kw)
        return params

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, tokens):
        """tokens: (...) int -> (..., d)."""
        return params["embed"][tokens.long()]

    def head_matrix(self, params):
        """(d, V): the tied embedding's transpose, or the lm_head."""
        return params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]

    def logits(self, params, hidden):
        return softcap(hidden @ self.head_matrix(params),
                       self.cfg.final_logit_softcap)

    # ------------------------------------------------------------------
    # Full-sequence forward and loss (training)
    # ------------------------------------------------------------------
    def forward(self, params, tokens=None, embeds=None, *, x=None,
                positions=None, remat=False, window_override="cfg",
                return_cache_len: Optional[int] = None) -> ForwardOut:
        """Every layer over the whole sequence, tokens (B, T) (or hidden
        x (B, T, d)) at positions 0..T-1; a Python loop over each group's
        periods takes the place of ``lax.scan``. ``remat`` recomputes
        each period in the backward (``torch.utils.checkpoint``,
        non-reentrant), as ``jax.checkpoint`` on the scan body does, so
        only the periods' inputs are kept. ``return_cache_len`` returns
        the decode cache in ``out.cache``: each attention block's K/V in
        slotted caches of that length, each SSM block's final state,
        stacked over the periods. Embedding prefixes and other positions
        are not ported yet."""
        if embeds is not None:
            raise NotImplementedError(
                "embeds: embedding prefixes come with the other "
                "architectures (ROADMAP)")
        if positions is not None:
            raise NotImplementedError(
                "positions: the forward runs at positions 0..T-1")
        cfg = self.cfg
        if x is None:
            x = self.embed(params, tokens)
        ctx = {"positions": torch.arange(x.shape[1], dtype=torch.int32,
                                         device=x.device),
               "window_override": window_override}
        caches = []
        aux = torch.zeros((), device=x.device)
        for gi, g in enumerate(cfg.groups):
            scan = params["groups"][gi]["scan"]

            def period(xx, pp, g=g):
                entries, aa = {}, torch.zeros((), device=xx.device)
                for j, blk in enumerate(g.period):
                    xx, entries[f"b{j}"], a = B.block_forward(
                        pp[f"b{j}"], cfg, blk, xx, ctx)
                    aa = aa + a
                return xx, entries, aa

            per = []
            for layer in range(g.n_periods):
                pp = tree_map(lambda t: t[layer], scan)
                if remat:
                    x, entries, a = torch.utils.checkpoint.checkpoint(
                        period, x, pp, use_reentrant=False)
                else:
                    x, entries, a = period(x, pp)
                aux = aux + a
                if return_cache_len is not None:
                    per.append(entries)
            caches.append(per)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache = None
        if return_cache_len is not None:
            cache = self._materialize_cache(caches, x.shape[0], x.shape[1],
                                            return_cache_len,
                                            window_override)
        return ForwardOut(hidden=x, aux_loss=aux, cache=cache)

    def _materialize_cache(self, raw_caches, batch, T, cache_len,
                           window_override):
        """Per-block forward outputs, a list over the periods per group,
        into the decode cache. An attention block's K/V (B, T, Hkv, hd)
        are copied into zeroed slotted caches of ``cache_len`` slots (no
        more than its window): the last min(T, S) positions, position t in
        slot t % S. An SSM block's final state is ready as it is. Both are
        stacked over the periods."""
        cfg = self.cfg
        out = []
        for g, per in zip(cfg.groups, raw_caches):
            entry = {}
            for j, blk in enumerate(g.period):
                key = f"b{j}"
                if blk.kind in B.SSM_KINDS:
                    entry[key] = _stack_periods(per, key)
                    continue
                first = per[0][key]["k"]
                tmpl = B.init_block_cache(cfg, blk, batch, cache_len,
                                          dtype=first.dtype,
                                          device=first.device,
                                          window_override=window_override)
                stacked = {name: z.new_zeros((g.n_periods, *z.shape))
                           for name, z in tmpl.items()}
                for name, z in stacked.items():
                    S = z.shape[2]
                    n = min(T, S)
                    slots = torch.arange(T - n, T, device=z.device) % S
                    for layer, e in enumerate(per):
                        z[layer, :, slots] = e[key][name][:, T - n:].to(
                            z.dtype)
                entry[key] = stacked
            out.append(entry)
        return tuple(out)

    def loss(self, params, tokens=None, labels=None, embeds=None,
             label_mask=None, *, remat=True, window_override="cfg"):
        """Next-token CE (labels already shifted by the data pipeline):
        the streaming vocab-chunked CE for large vocabularies, so the
        (B, T, V) logits are never materialized. Returns (loss,
        {"ce", "aux"})."""
        cfg = self.cfg
        out = self.forward(params, tokens, embeds, remat=remat,
                           window_override=window_override)
        h = out.hidden
        w = self.head_matrix(params)
        if cfg.vocab_size >= 65536 and cfg.final_logit_softcap is None:
            ce = chunked_cross_entropy(h, w, labels, label_mask=label_mask)
        else:
            ce = cross_entropy_logits(softcap(h @ w, cfg.final_logit_softcap),
                                      labels, label_mask)
        return ce + out.aux_loss, {"ce": ce, "aux": out.aux_loss}

    # ------------------------------------------------------------------
    # Paged pools and the fused iteration
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, *,
                   dtype: torch.dtype, device, window_override="cfg",
                   kv_dtype=None):
        """Zeroed decode cache, per group {"b<j>": leaves stacked over the
        n_periods}, the JAX layout. An attention block's entry is
        {"k","v"} (n_periods, batch, cache_len, Hkv, hd): the slotted
        caches of ``batch`` sequences, or the page pool of ``batch``
        pages of ``cache_len`` slots, as the engine calls it; ``kv_dtype``
        stores a pool low-bit with (n_periods, n_pages, Hkv) float32
        ``k_scale``/``v_scale`` leaves beside it (DESIGN.md §17). An SSM
        block's entry is its zero state for ``batch`` sequences
        (``cache_len`` does not apply)."""
        def entry(g, blk):
            tmpl = B.init_block_cache(self.cfg, blk, batch, cache_len,
                                      dtype=dtype, device=device,
                                      window_override=window_override,
                                      kv_dtype=kv_dtype)
            return tree_map(lambda z: torch.stack([z] * g.n_periods), tmpl)
        return tuple({f"b{j}": entry(g, blk) for j, blk in enumerate(g.period)}
                     for g in self.cfg.groups)

    def _steps(self, params, cache, block_fn, x, ctx):
        """Run ``block_fn`` (x, cache entry -> x, new entry, ...) over every
        layer in order, each layer's cache entry a view of its group's
        stacked cache; then the final norm. Returns (x, the new caches
        stacked over the periods)."""
        cfg = self.cfg
        new_caches = []
        for gi, g in enumerate(cfg.groups):
            scan = params["groups"][gi]["scan"]
            per = []
            for layer in range(g.n_periods):
                entries = {}
                for j, blk in enumerate(g.period):
                    pj = tree_map(lambda t: t[layer], scan[f"b{j}"])
                    cj = tree_map(lambda t: t[layer], cache[gi][f"b{j}"])
                    x, entries[f"b{j}"] = block_fn(pj, cfg, blk, x, cj,
                                                   ctx)[:2]
                per.append(entries)
            new_caches.append({k: _stack_periods(per, k) for k in per[0]})
        return rms_norm(x, params["final_norm"], cfg.norm_eps), \
            tuple(new_caches)

    def decode_step(self, params, tokens, pos, cache, *,
                    window_override="cfg"):
        """One token per sequence through every layer. tokens (B,) int32;
        pos (B,) absolute position of the new token (SSM blocks do not
        read it); cache as from init_cache or a prefill's ``out.cache``.
        Returns (logits (B, V), the new cache; the input is left as it
        was)."""
        x, new = self._steps(params, cache, B.block_decode,
                             self.embed(params, tokens),
                             {"pos": pos, "window_override": window_override})
        return self.logits(params, x), new

    def extend_step(self, params, tokens, start, cache, *,
                    window_override="cfg", logits_index=None):
        """Chunked prefill or recompute: tokens (B, T) int32 appended at
        absolute positions start[b] + t, attending to the cached prefix
        (an SSM block continues from its state). Attention caches need
        S >= start + T (no ring wrap). Returns (logits (B, V) at
        logits_index (B,) — default the last position — and the new
        cache; the input is left as it was)."""
        x, new = self._steps(params, cache, B.block_extend,
                             self.embed(params, tokens),
                             {"start": start,
                              "window_override": window_override})
        return self.logits(params, _last(x, logits_index)), new

    def forward_mixed_paged(self, params, tokens, tok_seq, tok_pos, q_last,
                            pools, block_tables, sampling=None, *,
                            window_override="cfg"):
        """One scheduler iteration's every prefill-chunk token and decode
        token as one ragged batch (DESIGN.md §10): per layer one
        kv_append into the pools and one ragged paged-attention pass,
        then sampling on the device, so only int32 ids need to cross to
        the host.

        tokens (N,) int32 flat token ids; tok_seq (N,) int32 block-table
        row of each token; tok_pos (N,) int32 absolute position (-1 marks
        a padded row); q_last (B,) int32 flat index of each sequence's
        last real token; pools as from init_cache, written in place;
        block_tables (B, max_pages) int32. ``sampling`` is None for
        all-greedy batches (argmax alone), or a (temps, top_ks, top_ps,
        seeds) tuple of (B,) tensors for ``sample_tokens``, each row's
        token sampled at position tok_pos[q_last] + 1.

        Returns (sampled (B,) int32, logits (B, V), pools).
        """
        x = self.embed(params, tokens)
        ctx = {"block_tables": block_tables, "tok_seq": tok_seq,
               "tok_pos": tok_pos, "window_override": window_override}
        x = self._layers(params, pools, B.block_mixed_paged, x, ctx)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = self.logits(params, x[q_last.long()])
        if sampling is None:
            sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            sampled = sample_tokens(logits, *sampling,
                                    tok_pos[q_last.long()] + 1)
        return sampled, logits, pools

    def decode_step_paged(self, params, tokens, ctx_lens, pools,
                          block_tables, *, window_override="cfg"):
        """In-place paged decode (DESIGN.md §9): one new token per
        sequence, written into the pools and attended through the block
        tables with the ``paged_attention`` kernel.

        tokens (B,) int32; ctx_lens (B,) int32 context length including
        the new token (0 marks a padded row: nothing is written, its
        logits are garbage); pools as from init_cache, written in place;
        block_tables (B, max_pages) int32. Returns (logits (B, V),
        pools)."""
        x = self.embed(params, tokens)
        ctx = {"block_tables": block_tables, "ctx_lens": ctx_lens,
               "window_override": window_override}
        x = self._layers(params, pools, B.block_decode_paged, x, ctx)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.logits(params, x), pools

    def extend_step_paged(self, params, tokens, start, n_new, pools,
                          block_tables, *, window_override="cfg",
                          logits_index=None):
        """In-place paged chunked prefill: the chunk's K/V pages are
        written as they are computed; tokens past n_new[b] are bucket
        padding whose writes are dropped. tokens (B, T) int32 at
        positions start[b] + t; all written positions must fit the block
        table (start + T <= max_pages * page). Returns (logits (B, V) at
        logits_index (B,) — default the last position — and the
        pools)."""
        x = self.embed(params, tokens)
        ctx = {"block_tables": block_tables, "start": start, "n_new": n_new,
               "window_override": window_override}
        x = self._layers(params, pools, B.block_extend_paged, x, ctx)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.logits(params, _last(x, logits_index)), pools

    def _layers(self, params, pools, block_fn, x, ctx):
        """Run ``block_fn`` over every layer in order: a Python loop over
        each group's periods takes the place of ``lax.scan``, and each
        layer's pool is a view of its group's stacked pool tensor."""
        cfg = self.cfg
        for gi, g in enumerate(cfg.groups):
            scan = params["groups"][gi]["scan"]
            for layer in range(g.n_periods):
                for j, blk in enumerate(g.period):
                    pj = tree_map(lambda t: t[layer], scan[f"b{j}"])
                    pool = {k: v[layer]
                            for k, v in pools[gi][f"b{j}"].items()}
                    x = block_fn(pj, cfg, blk, x, pool, ctx)
        return x


def _last(x, logits_index):
    """x (B, T, d) at each row's logits_index (B,), default the last."""
    if logits_index is None:
        return x[:, -1]
    return x[torch.arange(x.shape[0], device=x.device), logits_index.long()]


def _stack_periods(per, key):
    """[{"b<j>": tree} for each period] -> the ``key`` tree stacked over
    the periods."""
    return tree_map(lambda *xs: torch.stack(xs), *[e[key] for e in per])
