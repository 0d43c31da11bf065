"""Device dispatch for the kernels, counterpart of ``repro.kernels.ops``.

For a tensor on the CPU each op runs its kernel's plain PyTorch version;
for a CUDA tensor it launches the hand-written kernel, which raises on
anything it does not take. There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gla_scan import chunked_gla_ref, gla_scan
from repro_torch.kernels.kv_append import kv_append, kv_append_ref
from repro_torch.kernels.kv_quant import kv_append_quant, kv_append_quant_ref
from repro_torch.kernels.moe_experts import MoEExperts, moe_experts_ref
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_quant_ref,
                                                 paged_attention_ref)
from repro_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_quant_ref,
    ragged_paged_attention_ref)
from repro_torch.kernels.swap_pack import (swap_pack, swap_pack_ref,
                                           swap_pack_tree,
                                           swap_pack_tree_ref, swap_unpack,
                                           swap_unpack_ref, swap_unpack_tree,
                                           swap_unpack_tree_ref)


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def flash_attention_op(q, k, v, *, causal=True, window=None, softcap=None):
    """Dense GQA attention over full sequences, differentiable: q
    (B, Hkv, G, Tq, hd), k and v (B, Hkv, Tk, hd). The autograd Function
    runs the plain versions, forward and backward, for CPU tensors and
    launches the kernels for CUDA tensors."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def gla_scan_op(q, k, v, log_a, *, chunk=128, initial_state=None):
    """Chunked gated linear attention, the SSM blocks' core: q, k
    (B, H, T, dk), v (B, H, T, dv), log_a (B, H, T), optional initial
    state (B, H, dk, dv). Returns (y like v, final state float32). The
    plain version (differentiable by autograd) for CPU tensors; the
    kernel for CUDA tensors, whose backward raises: there is no gradient
    kernel yet."""
    if _on_cpu(q):
        return chunked_gla_ref(q, k, v, log_a, chunk, initial_state)
    return gla_scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state)


def moe_experts_op(x, we_gate, we_up, we_down, gate_w, pair, valid,
                   offsets, *, activation="silu"):
    """The routed experts of an MoE FFN over the sorted (token, expert)
    pairs (``models.moe.route``): x (N, d) -> (N, d). The plain version
    (differentiable by autograd) for CPU tensors; the kernels for CUDA
    tensors, whose backward raises: there is no gradient kernel yet."""
    if _on_cpu(x):
        return moe_experts_ref(x, we_gate, we_up, we_down, gate_w, pair,
                               valid, offsets, activation=activation)
    return MoEExperts.apply(x, we_gate, we_up, we_down, gate_w, pair, valid,
                            offsets, activation)


def paged_attention_op(q, k_pool, v_pool, block_tables, ctx_lens, *,
                       k_scale=None, v_scale=None, softcap=None,
                       window=None):
    """Decode attention, one query token per sequence, over paged pools;
    quantized pools come with their (n_pages, Hkv) scales."""
    if not _on_cpu(q):
        return paged_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                               k_scale=k_scale, v_scale=v_scale,
                               softcap=softcap, window=window)
    if k_scale is not None:
        return paged_attention_quant_ref(q, k_pool, v_pool, k_scale,
                                         v_scale, block_tables, ctx_lens,
                                         softcap=softcap, window=window)
    return paged_attention_ref(q, k_pool, v_pool, block_tables, ctx_lens,
                               softcap=softcap, window=window)


def ragged_paged_attention_op(q, k_pool, v_pool, block_tables, tok_seq,
                              tok_pos, *, k_scale=None, v_scale=None,
                              softcap=None, window=None):
    """Mixed-batch ragged-query attention over paged pools; quantized
    pools come with their (n_pages, Hkv) scales."""
    if not _on_cpu(q):
        return ragged_paged_attention(q, k_pool, v_pool, block_tables,
                                      tok_seq, tok_pos, k_scale=k_scale,
                                      v_scale=v_scale, softcap=softcap,
                                      window=window)
    if k_scale is not None:
        return ragged_paged_attention_quant_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, tok_seq,
            tok_pos, softcap=softcap, window=window)
    return ragged_paged_attention_ref(q, k_pool, v_pool, block_tables,
                                      tok_seq, tok_pos, softcap=softcap,
                                      window=window)


def kv_append_op(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
    """In-place scatter of new token K/V rows into pool page slots."""
    fn = kv_append_ref if _on_cpu(k_pool) else kv_append
    return fn(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid)


def kv_append_quant_op(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                       page_ids, offsets, valid, *, discard_pid=None):
    """Quantized in-place scatter of new K/V rows with the per-page scale
    update (requantize-on-append, DESIGN.md §17). ``discard_pid`` is
    kept for the reference's signature; no path here writes to it."""
    fn = kv_append_quant_ref if _on_cpu(k_pool) else kv_append_quant
    return fn(k_pool, v_pool, k_scale, v_scale, k_new, v_new, page_ids,
              offsets, valid, discard_pid)


def swap_pack_op(pool, page_ids):
    fn = swap_pack_ref if _on_cpu(pool) else swap_pack
    return fn(pool, page_ids)


def swap_unpack_op(pool, staging, page_ids):
    fn = swap_unpack_ref if _on_cpu(pool) else swap_unpack
    return fn(pool, staging, page_ids)


def swap_pack_tree_op(leaves, page_ids, slab):
    fn = swap_pack_tree_ref if _on_cpu(leaves[0]) else swap_pack_tree
    return fn(leaves, page_ids, slab)


def swap_unpack_tree_op(leaves, slab, page_ids):
    fn = swap_unpack_tree_ref if _on_cpu(leaves[0]) else swap_unpack_tree
    return fn(leaves, slab, page_ids)
