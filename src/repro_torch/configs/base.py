"""Config system: model architecture descriptions and benchmark input shapes.

A model is a stack of *layer groups*; each group is a repeated *period* of
blocks and is executed with ``jax.lax.scan`` over the periods, so compile
time is independent of depth. This representation covers all assigned
architectures:

  * plain dense stacks        -> one group, period = (attn_block,)
  * gemma2 local/global       -> one group, period = (local, global)
  * xLSTM [7:1]               -> one group, period = (7 x mLSTM, sLSTM)
  * zamba2 shared attention   -> groups [(5 x mamba2 + shared_attn) x 6,
                                          (mamba2 x 2) x 1]
  * deepseek-moe dense first  -> groups [(dense,) x 1, (moe,) x 27]
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# --------------------------------------------------------------------------
# Block-level configs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionCfg:
    kind: str = "gqa"                 # "gqa" | "mla"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # None = global attention
    # MLA (deepseek-v3) only:
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    def kv_token_bytes(self, dtype_bytes: int = 2) -> int:
        """Per-token, per-layer KV cache footprint (the paper's ``M`` factor
        contribution from one layer)."""
        if self.kind == "mla":
            return (self.kv_lora_rank + self.qk_rope_head_dim) * dtype_bytes
        return 2 * self.n_kv_heads * self.head_dim * dtype_bytes


@dataclasses.dataclass(frozen=True)
class FFNCfg:
    kind: str = "dense"               # "dense" | "moe" | "none"
    d_ff: int = 0
    activation: str = "silu"          # "silu" | "gelu"
    gated: bool = True                # SwiGLU/GeGLU vs plain 2-matmul MLP
    # MoE:
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    kind: str = "mamba2"              # "mamba2" | "mlstm" | "slstm"
    d_state: int = 64
    n_heads: int = 4
    expand: int = 2
    d_conv: int = 4                   # mamba2 short conv width
    chunk_size: int = 256             # chunkwise-parallel scan chunk
    ff_mult: float = 0.0              # post-cell FFN multiplier (sLSTM block)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One block within a period.

    kind:
      "attn"        attention + FFN residual block (params scanned)
      "shared_attn" attention + FFN block whose params are SHARED across all
                    its occurrences in the model (zamba2); params stored once
      "mamba2" / "mlstm" / "slstm"  SSM residual block
    """
    kind: str
    attn: Optional[AttentionCfg] = None
    ffn: Optional[FFNCfg] = None
    ssm: Optional[SSMCfg] = None
    post_norms: bool = False          # gemma2-style post-sublayer RMSNorms


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    period: Tuple[BlockCfg, ...]
    n_periods: int

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.n_periods


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    source: str                        # citation
    d_model: int
    vocab_size: int
    groups: Tuple[LayerGroup, ...]
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    final_logit_softcap: Optional[float] = None
    dtype: str = "bfloat16"
    # Modality stubs (the one allowed carve-out):
    n_codebooks: int = 0               # audio (musicgen): EnCodec streams
    vision_prefix_len: int = 0         # vlm (pixtral): # patch embeddings
    # Long-context decode policy: window applied to *global* attention layers
    # for the long_500k shape (sub-quadratic requirement). SSM archs ignore.
    long_context_window: int = 8192

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    @property
    def blocks(self) -> Tuple[BlockCfg, ...]:
        out = []
        for g in self.groups:
            out.extend(g.period * g.n_periods)
        return tuple(out)

    def kv_token_bytes(self, dtype_bytes: int = 2) -> int:
        """Total per-token KV/state-equivalent bytes across layers — the
        paper's ``M``. SSM blocks contribute 0 here (their state is
        per-request, not per-token; see state_bytes)."""
        total = 0
        for b in self.blocks:
            if b.kind in ("attn", "shared_attn") and b.attn is not None:
                total += b.attn.kv_token_bytes(dtype_bytes)
        return total

    def state_bytes(self, dtype_bytes: int = 2) -> int:
        """Fixed per-request recurrent state bytes (SSM/hybrid archs)."""
        total = 0
        for b in self.blocks:
            if b.ssm is None:
                continue
            s = b.ssm
            d_inner = s.expand * self.d_model
            if s.kind == "mamba2":
                head_dim = d_inner // s.n_heads
                total += (s.n_heads * head_dim * s.d_state + s.d_conv * d_inner) * dtype_bytes
            elif s.kind == "mlstm":
                head_dim = d_inner // s.n_heads
                # matrix memory C (hd x hd) + normalizer n (hd) + m scalar
                total += s.n_heads * (head_dim * head_dim + head_dim + 1) * dtype_bytes
            elif s.kind == "slstm":
                total += 4 * d_inner * dtype_bytes  # c, n, h, m
        return total

    def approx_n_params(self) -> int:
        """Cheap analytic parameter count (embedding + blocks)."""
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            total += (self.n_codebooks - 1) * self.vocab_size * d * 2
        seen_shared = set()
        for b in self.blocks:
            if b.kind == "shared_attn":
                if "shared" in seen_shared:
                    continue
                seen_shared.add("shared")
            total += _block_params(self, b)
        return total

    def active_params_per_token(self) -> int:
        """MoE-aware active parameter count (for MODEL_FLOPS = 6*N_active*D)."""
        d = self.d_model
        total = self.vocab_size * d  # output projection matmul is active
        for b in self.blocks:
            total += _block_params(self, b, active_only=True)
        return total


def _ffn_params(d: int, f: FFNCfg, active_only: bool = False) -> int:
    if f.kind == "none":
        return 0
    if f.kind == "dense":
        return d * f.d_ff * (3 if f.gated else 2)
    # moe
    per_expert = d * f.d_ff_expert * (3 if f.gated else 2)
    shared = f.n_shared_experts * per_expert
    router = d * f.n_routed_experts
    n_e = f.top_k if active_only else f.n_routed_experts
    return shared + router + n_e * per_expert


def _attn_params(d: int, a: AttentionCfg) -> int:
    if a.kind == "mla":
        q = d * a.q_lora_rank + a.q_lora_rank * a.n_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim)
        kv = d * (a.kv_lora_rank + a.qk_rope_head_dim) + a.kv_lora_rank * a.n_heads * (a.qk_nope_head_dim + a.v_head_dim)
        o = a.n_heads * a.v_head_dim * d
        return q + kv + o
    return d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim + a.n_heads * a.head_dim * d


def _block_params(cfg: ModelConfig, b: BlockCfg, active_only: bool = False) -> int:
    d = cfg.d_model
    total = 0
    if b.kind in ("attn", "shared_attn") and b.attn is not None:
        total += _attn_params(d, b.attn)
    if b.ffn is not None:
        total += _ffn_params(d, b.ffn, active_only)
    if b.ssm is not None:
        s = b.ssm
        d_inner = s.expand * d
        if s.kind == "mamba2":
            total += d * (2 * d_inner + 2 * s.n_heads * s.d_state + s.n_heads) + d_inner * d
        elif s.kind == "mlstm":
            total += d * 2 * d_inner + d_inner * d + 3 * d * s.n_heads + d_inner * d_inner // s.n_heads
        elif s.kind == "slstm":
            total += 4 * d * d_inner + 4 * d_inner * (d_inner // s.n_heads) + d_inner * d
            if s.ff_mult:
                total += int(2 * d_inner * d_inner * s.ff_mult)
    return total


# --------------------------------------------------------------------------
# Benchmark input shapes (assigned)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


# --------------------------------------------------------------------------
# Convenience constructors
# --------------------------------------------------------------------------

def dense_block(n_heads, n_kv_heads, head_dim, d_ff, *, qkv_bias=False,
                rope_theta=10000.0, logit_softcap=None, sliding_window=None,
                activation="silu", gated=True) -> BlockCfg:
    return BlockCfg(
        kind="attn",
        attn=AttentionCfg(kind="gqa", n_heads=n_heads, n_kv_heads=n_kv_heads,
                          head_dim=head_dim, qkv_bias=qkv_bias,
                          rope_theta=rope_theta, logit_softcap=logit_softcap,
                          sliding_window=sliding_window),
        ffn=FFNCfg(kind="dense", d_ff=d_ff, activation=activation, gated=gated),
    )


def simple_dense(name, source, *, n_layers, d_model, n_heads, n_kv_heads,
                 head_dim, d_ff, vocab_size, **kw) -> ModelConfig:
    blk_kw = {}
    for k in ("qkv_bias", "rope_theta", "logit_softcap", "sliding_window",
              "activation", "gated"):
        if k in kw:
            blk_kw[k] = kw.pop(k)
    blk = dense_block(n_heads, n_kv_heads, head_dim, d_ff, **blk_kw)
    return ModelConfig(
        name=name, family=kw.pop("family", "dense"), source=source,
        d_model=d_model, vocab_size=vocab_size,
        groups=(LayerGroup(period=(blk,), n_periods=n_layers),), **kw)
