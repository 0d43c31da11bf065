"""Device dispatch for the kernels, counterpart of ``repro.kernels.ops``.

For a tensor on the CPU each op runs its kernel's plain PyTorch version;
for a CUDA tensor it launches the hand-written kernel, which raises on
anything it does not take. There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.kv_append import kv_append, kv_append_ref
from repro_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_ref)
from repro_torch.kernels.swap_pack import (swap_pack, swap_pack_ref,
                                           swap_unpack, swap_unpack_ref)


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def ragged_paged_attention_op(q, k_pool, v_pool, block_tables, tok_seq,
                              tok_pos, *, k_scale=None, v_scale=None,
                              softcap=None, window=None):
    """Mixed-batch ragged-query attention over paged pools."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("quantized pools (k/v scales) are not "
                                  "ported yet")
    fn = ragged_paged_attention_ref if _on_cpu(q) else ragged_paged_attention
    return fn(q, k_pool, v_pool, block_tables, tok_seq, tok_pos,
              softcap=softcap, window=window)


def kv_append_op(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
    """In-place scatter of new token K/V rows into pool page slots."""
    fn = kv_append_ref if _on_cpu(k_pool) else kv_append
    return fn(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid)


def swap_pack_op(pool, page_ids):
    fn = swap_pack_ref if _on_cpu(pool) else swap_pack
    return fn(pool, page_ids)


def swap_unpack_op(pool, staging, page_ids):
    fn = swap_unpack_ref if _on_cpu(pool) else swap_unpack
    return fn(pool, staging, page_ids)
