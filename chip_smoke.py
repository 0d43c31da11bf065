#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, agrees with its plain
versions, and serves.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --split-tiles   # the float32 flash tiles' sweep

Phases; any failure ends the run with a non-zero exit and no result line:
  1. card          — name and power limit from nvidia-smi; no CUDA card:
                     exit 2
  2. build         — nvcc every csrc/*.cu for sm_90a, load the library
  3. kernels       — each kernel against its plain version on the card, at
                     llama3.2-1b's widths (Hkv 8, G 4, hd 64, page 16) in
                     bf16 and f32, plus edge cases (kv_append at its 8-row
                     blocks' edges, swap_unpack with repeated ids); the
                     quantized pools' kernels (page_requant, the fused
                     kv_append_quant over Hkv {1, 8} x hd {32, 64, 128} x
                     N {1, 7, 16, 17, 512},
                     the scaled attention kernels) for int8, float8_e4m3
                     and float8_e5m2; the bf16 attention sweep's tile and
                     split edges (chunks of tq - 1, tq, tq + 1 tokens at
                     G {1, 4, 8} and hd {32, 64, 128}, two sequences in a
                     tile, unsorted tok_seq, decode-only buckets and B = 1
                     decodes at split edges and the full table), a
                     SwapStager round trip of a quantized pool tree (one
                     launch each way for its 4 leaves) and the swap tree
                     pack and unpack byte for byte over a ragged grid
                     (trees of 1-4 leaves, rows of 4 B to 24 KB on the
                     bulk copies and the word path, P {1, 3}, n {0, 1, 7,
                     34, 100}, aligned and shifted slabs); the flash
                     attention forward and
                     backward at T {1, 63, 64, 1000, 2048}, at B 8 x
                     T 1024 (dense_serve's prefill), Tq < Tk,
                     G {1, 4}, window, softcap and no causal mask;
                     gla_scan over the reference grid, the tiny and the
                     full-width mLSTM shapes (also as mlstm_forward lays
                     them out, read in place, with log_a at the clamp
                     over whole chunks, and with an initial state), a
                     Mamba2 call (stride-0 q and k), a carried initial
                     state and dk 8 with chunks of 5, and on every one of
                     those calls the backward (gla_scan_bwd) against the
                     plain backward (chunked_gla_bwd_ref), with a
                     final-state gradient beside an initial state, and
                     at the train phases' mLSTM and Mamba2 widths with
                     one alone; and head_dim 256
                     (GPT-J's 16 kv heads x G 1, gemma2's 8 x G 2),
                     through the same case functions: the ragged and
                     paged kernels in bf16 and float32 over float, int8,
                     float8_e4m3 and float8_e5m2 pools (split and tile
                     edges, windows 7 and 40, softcap 50), kv_append and
                     kv_append_quant at Hkv {8, 16}, the tree swap over
                     gemma2's and GPT-J's own bf16 and int8 pool trees,
                     the flash forward and backward (causal, windows
                     33, 100 and gemma2's 4096 at T 4097, softcap 50,
                     Tq < Tk, no causal mask, G 1, 2 and 16); the MoE
                     experts (moe_experts) at
                     deepseek-moe-16b's tiny and full widths in bf16
                     and float32: a decode (8 groups of one token), a
                     fused prefill (512 groups of one) and an extend
                     call (4 x 128 at cf 1.25, dropped pairs, route's
                     validity equal to the plain capacity step's), then
                     moe_forward once under set_sync_debug_mode("error");
                     the MLA slice: the ragged latent-attention kernel
                     (row 10) at deepseek-v3's full (H 128, L 512, R 64)
                     widths, at H 24 and at the tiny widths over bf16
                     and float32 pools (an N 512 call of a chunk,
                     decodes at the table's end and on either side of a
                     page boundary, padded rows; a decode-only call;
                     decodes up to 8192 keys at H 128; rows alone, N 1,
                     bit for bit as in the N 512 call; bf16 pools at the
                     full widths on the tensor-core form, the rest on
                     the CUDA-core form), kv_append at the latent widths,
                     the flash forward at head_dim 192 (B 2 x 128 heads x
                     T 1024 causal, T 65 and 129 among others) and its
                     backward on the same calls (v zero-padded past 128,
                     scale 1/sqrt(192)), and the tree swap over
                     deepseek-v3's latent pool tree
  4. tiny          — tiny-config f32 forward_mixed_paged, decode_step_paged
                     and extend_step_paged, kernels on the card against
                     plain versions on the CPU, same weights and pools,
                     over float pools and over int8 pools; two sampled
                     sessions (top-k, top-p) through the engine, fused
                     and unfused: the card's streams equal the CPU's
  5. tiny_train    — one f32 make_train_step of tiny llama3.2-1b,
                     xlstm-350m and zamba2-1.2b, kernels on the card
                     (flash, gla_scan and their backwards) against plain
                     versions on the CPU: loss, gradients, grad_norm
  6. tiny_ssm      — tiny xlstm-350m in f32: prefill_step and 8 greedy
                     serve_step calls, the kernel on the card against the
                     plain version on the CPU: logits, cache, tokens
  7. decode_parity — full width on the card: the fused and per-call paths
                     against each other, prefill (forward_mixed_paged vs
                     extend_step_paged) and one decode step on equal pools
                     (the ragged kernel vs the paged decode kernel), and
                     the gather path (extend_step then decode_step on a
                     slotted cache, per sequence) against both; held in
                     f32, the prefill and the gather leg on weights
                     conditioned for soft attention; reported with the
                     reference's init; layer 0's K/V of both prefill legs
                     held against each other and against a float64
                     witness (layer0_exact) on both inits
  8. train_parity  — full width in f32, B 1 x T 512: loss and gradients
                     with the flash kernels against the plain attention on
                     the card; held on conditioned weights, reported with
                     the reference's init
  8b. ssm_train_parity
                   — full width in f32, B 1 x T 512, remat: xlstm-350m
                     cut to one period (7 mLSTM + 1 sLSTM) and
                     zamba2-1.2b cut to one period (5 mamba2 + the shared
                     block) and its 2-layer tail: loss and gradients with
                     gla_scan, gla_scan_bwd (and flash) against the plain
                     GLA and attention under autograd on the card, held
                     as train_parity (zamba2 by a float64 witness where
                     a leaf misses 1e-3)
  8c. wide_train_parity
                   — full width in f32, B 1, on conditioned weights:
                     loss and gradients with the flash kernels (the
                     backward at head_dim 256 and 192) against the plain
                     attention under autograd on the card, held as
                     train_parity: gemma2-9b at 2 local/global pairs and
                     T 4608 (past its window), GPT-J-6B at 2 layers and T
                     512, deepseek-v3's first dense layer at T 512
                     (mla_forward's padded 192); the reference's init
                     reported
  9. ssm_parity    — full-width xlstm-350m in f32, B 2 x T 520: prefill
                     logits and final states with gla_scan against the
                     plain chunked_gla_ref on the card, and serve_step at
                     T against a T+1 prefill
  9e. zamba2_parity — the same on zamba2-1.2b at full width cut to 2 x (5
                     mamba2 + the shared block) + 1 mamba2 (two
                     occurrences of one shared attention block): logits,
                     SSM states and each occurrence's K/V with gla_scan
                     and flash against the plain GLA and attention
  9f. pixtral_parity
                   — the same on pixtral-12b at full width cut to 4
                     layers, after a (2, 1024, 5120) vision prefix at the
                     embeddings' scale: 64 tokens, flash against the plain
                     attention, serve_step at P + T against a P + T + 1
                     prefill with the same prefix
  9g. musicgen_parity
                   — decode_parity's legs on musicgen-large at full
                     width cut to 4 layers, in f32 on conditioned
                     weights, each id broadcast over the 4 codebooks as
                     the engine feeds them ((K, V) logits, sampled from
                     the last codebook's row), held at decode_parity's
                     conditioned tolerances; then the same legs with the
                     plain versions in the kernels' places on the card
                     (plain_paged): the prefills' and decodes' logits
                     within 1e-3 of the kernels', ids equal
  9b. wide_parity  — decode_parity on gemma2-9b and GPT-J-6B at full
                     width cut to 4 layers each (2 local/global pairs
                     of gemma2), contexts 37, 160, 4700 and 16 (one past
                     gemma2's 4096-token window: the local layers' window
                     bites on every leg; the tables that long hold only
                     the pages a sequence fills), the same holds, and
                     layer 0's K/V of both prefill legs against a
                     float64 witness
  9c. moe_parity   — decode_parity on deepseek-moe-16b at full width,
                     cut to the dense layer and 3 MoE layers: the
                     prefill legs at capacity factor E / k (nothing
                     drops), the decode steps at the config's 1.25
  9d. mla_parity   — decode_parity on deepseek-v3 at full width cut to
                     its dense group (3 MLA layers), with a fourth leg:
                     LM.forward per sequence (flash at head_dim 192)
                     against the fused prefill, held as the prefill is;
                     its float32 legs launch row 10's CUDA-core form, its
                     bf16 leg the tensor-core form
 10. serve         — full-width llama3.2-1b in bf16, random weights from a
                     seed, agent sessions through ScriptedClient under
                     InferCept
 11. swap          — the same under the swap policy, so pages cross to the
                     host; then the SwapStager's host ms per pack +
                     collect and per unpack (the slab's assembly
                     included), with --parent the parent's stager in
                     turns. In every serve run one swap_pack and one
                     swap_unpack launch per stager pack and unpack; in
                     serve, swap, quant, gather, sanitize and
                     sanitize_quant every swapped page comes back
 12. unfused       — the same under InferCept with Engine(fused=False): the
                     per-call extend and paged decode paths; cut to 4
                     layers
 13. spec          — the same under InferCept with speculative resume and
                     the oracle tool-result predictor, driven by Engine.run:
                     a session's segments are open and a fork past an open
                     segment emits only its seed token, so only the closed
                     loop's scripted segments give forks decode steps;
                     cut to 4 layers
 14. quant         — the serve run with int8 KV pools
                     (Engine(kv_dtype="int8")): the fused kv_append_quant
                     kernel (and neither kv_append nor page_requant) and
                     the scaled ragged kernel
 15. quant_unfused — the same with fused=False: the scaled paged decode
                     kernel; cut to 4 layers
 16. gather        — the serve run (cut to 4 layers, as spec and the
                     sanitized runs are) with Engine(paged=False), the gather
                     oracle: no paged attention or append launch, swaps
                     through the stager, every page back
 17. sanitize      — the serve run with Engine(sanitize=True), cut to 4
     sanitize_quant  layers: no findings, and the streams and counters of
                     an unsanitized serve (quant) run of that depth in
                     the same phase
 18. sample        — the serve run with every request sampled
                     (temperature 0.7, top-k 50, top-p 0.9, seed 1000 + i)
                     on the card by models.model.sample_tokens: every
                     request finishes and every page comes back, at least
                     10 of 13 streams differ from serve's; the sampler's
                     host and stream ms per fused step, its device ms by
                     graph replay, tok/s beside serve's; the first two
                     sampled calls and the largest batch's against the
                     CPU (threefry words equal, Gumbel noise within 1e-6,
                     ids equal but at reported near-ties below 1e-5, two
                     card calls equal) and a chi-square of 65536 draws
 18b. gemma2_serve, gemma2_unfused, gemma2_quant, gptj_serve
                   — the serve run's workload and checks on full-width
                     gemma2-9b cut to 12 of its 42 layers (fused) and
                     to 6 (fused=False; int8 pools) and
                     GPT-J-6B cut to 7 of its 28 layers (fused) in bf16,
                     random weights from seed 0:
                     every request finishes and every page comes back;
                     launches by kernel (logged apart), tok/s,
                     max_memory_allocated and the pools' bytes; over the
                     four runs rows 1, 2, 3-4, 5, 1q and 2q launch at
                     head_dim 256
 18c. moe_serve, moe_unfused
                   — the serve run's workload and checks on full-width
                     deepseek-moe-16b cut to its dense layer and 6 of
                     its 27 MoE layers, in bf16 (fused), and to the
                     dense layer and 2 MoE layers (fused=False):
                     every request finishes and every page comes back;
                     tok/s, construction and run peaks, launches by
                     kernel (logged apart); over the two runs rows 1, 2,
                     3-4, 5 and the MoE kernels launch
 18d. mla_serve, mla_unfused
                   — the same on full-width deepseek-v3 cut to its dense
                     group and one MoE layer (3 + 1 layers; mla_unfused
                     1 + 1), bf16: tok/s,
                     step ms, construction and run peaks; over the two
                     runs rows 10, 2 and 9 launch and rows 1 and 5 never,
                     row 10 always in its tensor-core form
 18e. musicgen_serve, musicgen_unfused
                   — the serve run's workload and checks on full-width
                     musicgen-large (K 4 codebooks; MHA, 32 kv heads x
                     64: 393,216 KV bytes a token), bf16, cut to 24 of
                     its 48 layers (fused) and to 4 (fused=False):
                     tok/s, step ms, construction and run peaks, the
                     pools' bytes, swapped tokens, InferCept's choices
                     and the waste ledger's causes beside llama's serve
                     run, and the SwapStager's host ms per pack + collect
                     and per unpack at its largest swap; over the two
                     runs rows 1, 2, 3-4 and 5 launch at Hkv 32, G 1
 19. train         — full-width llama3.2-1b training through
                     make_train_step: bf16 params, f32 AdamW, remat,
                     SyntheticLM batches of 4 x 2048, 2 warm-up and 8
                     timed steps; finite, falling loss
 19a. train_f32    — the same in float32 (the train launcher's default
                     dtype: the float32 flash kernels, which split each
                     operand into three bf16 terms), 2 warm-up and 4
                     timed steps and one profiled (flash's share); every
                     flash launch float32; then python -m
                     repro_torch.launch.train once with its defaults
                     (llama3.2-1b, float32, 8 x 64, 3 steps)
 19b. xlstm_train, zamba2_train
                   — the train run on full-width, full-depth xlstm-350m
                     (24 layers; B 8 x T 512, 2 warm-up and 4 timed
                     steps: its sLSTM loop runs a step at a time under
                     autograd; its profiled step 8 x 64) and zamba2-1.2b
                     (38 layers; B 4 x T 2048, 2 + 6 steps): finite,
                     falling loss; gla_scan twice
                     and gla_scan_bwd once a GLA layer a step (zamba2:
                     flash and its backward likewise a shared-block
                     occurrence); step ms, tokens/s, peak memory
 19c. gemma2_train, gptj_train
                   — the train run on full-width gemma2-9b cut to 2 of
                     its 21 local/global pairs (4 layers) at B 1 x T
                     8192 (the 4096-token window bites) and GPT-J-6B cut
                     to 8 of its 28 layers at B 4 x T 2048, 2 warm-up
                     and 6 timed steps each: finite, falling loss; flash
                     twice and its backward (head_dim 256) once a layer
                     a step; step ms, tokens/s, peak memory; gemma2's
                     profiled step prints flash's share
 20. ssm_serve     — full-width xlstm-350m in bf16 (seed-0 port init)
                     through prefill_step of 8 x 2000 random tokens and 16
                     greedy serve_step calls (64 before the cuts of
                     PR 29): tok/s of each, peak memory,
                     21 gla_scan launches, finite logits; its profiled
                     prefill is one of 8 x 256 (the sLSTM loop's ~50
                     launches a step make the profiler's parse most of the
                     phase at 8 x 2000); the seconds of construction,
                     warm-up, prefill, steps and profiled windows are
                     logged as stamps (every serve-step run's are)
 21. dense_serve   — full-width llama3.2-1b in bf16 (seed-0 port init)
                     through prefill_step of 8 x 1024 random tokens (the
                     flash kernel, 16 launches) and 32 greedy serve_step
                     calls over slotted caches: tok/s of each, peak
                     memory, finite logits (one function serves both
                     models, MODEL_SERVES)
 21b. wide_dense   — the same for gemma2-9b: prefill_step of 8 x 1024
                     (flash with window 4096 and softcap 50, 42 launches),
                     8 greedy serve_step calls
 21c. zamba2_serve — the same for zamba2-1.2b, uncut (38 layers):
                     prefill_step of 8 x 2000 (32 gla_scan and 6 flash
                     launches, one per occurrence of the shared block) and
                     32 greedy serve_step calls
 21d. pixtral_serve
                   — the same for pixtral-12b, uncut (40 layers, ~24.5 GB
                     of bf16 weights): prefill_step of an (8, 1024, 5120)
                     vision prefix and 8 x 512 tokens (40 flash launches)
                     and 32 greedy serve_step calls from position P + T
 22. timing        — each kernel, its plain version and the one-call PyTorch
                     yardstick, timed with CUDA events on the inputs the
                     serve, train and ssm_serve runs gave it, launched
                     from the host (ms); the paged attention and append
                     kernels (rows 2, 2q, 6) also as device time by CUDA
                     graph replays (device_ms) and the wrapper's host
                     time (host_ms, the difference);
                     bound from those inputs; the ragged kernel also at
                     its largest decode-only call; the ragged kernel and
                     both appends (rows 2, 2q) also at the last call of
                     every N the serve runs gave them (launches x
                     (time - bound) summed over the sizes, by both
                     measures); gla_scan also as device time, its bound
                     the split's bf16 tensor-core operations; the swap
                     rows (3, 4 over the bf16 pool tree, 3q, 4q over the
                     int8 one, one launch per tree) also with a cold L2
                     (after a 64 MB write) by both measures, the library
                     calls' device time and the slab's pinned host copy;
                     with --parent DIR, another checkout's attention,
                     append, gla_scan, flash forward, tree swap and
                     latent-attention wrappers in turns with these (rows
                     10 and 10d by both measures), and rows 1, 1d, 5 and
                     7's calls again at head_dim 128 in turns; rows 1w,
                     1wd, 1wq and 5w (the attention
                     kernels at gemma2_serve's largest and largest
                     decode-only calls, at gemma2_quant's largest and at
                     gemma2_unfused's largest)
                     and 7w (flash at wide_dense's first prefill call),
                     their launches those runs' own; rows 9 and 9d (the
                     MoE kernels at moe_serve's largest call and its
                     largest decode-only call, the grouped product of
                     the installed torch as the library column); rows 10,
                     10d and 2m (the latent-attention kernel at
                     mla_serve's largest and largest decode-only calls,
                     kv_append at its largest latent call) and 7m (flash
                     at head_dim 192 on mla_parity's largest bf16
                     forward call, SDPA as the library column); rows 8z
                     (gla_scan on zamba2_serve's first mamba2 call: q and
                     k broadcast over the heads, read once; device time)
                     and 7p (flash on pixtral_serve's first prefill call,
                     SDPA as the library column), their launches those
                     runs' own; row 1g (the ragged kernel at
                     musicgen_serve's largest call: 32 kv heads x G 1 x
                     64, device time, bound, its launches that run's);
                     rows 8b and 8zb (the gla backward on the first GLA
                     call of xlstm_train and of zamba2_train, with the
                     gradient that reached it: against the plain
                     backward, device time, the split's bf16 products as
                     the bound, no library call; their launches those
                     runs'); rows 7wb, 7jb and 7mb (the flash backward on
                     the first attention call of gemma2_train and of
                     gptj_train, and on wide_train_parity's deepseek-v3
                     call, with the gradient that reached it: against the
                     plain backward, device time, 10 hd operations a
                     visible pair as the bound, SDPA's backward as the
                     library column; their launches those runs'); rows
                     7f and 7bf (the float32 forward and backward on
                     train_f32's first attention call) and 7mf (the
                     float32 forward on row 7m's call in float32): their
                     bound the split's bf16 products, the float32-rate
                     figure beside it, SDPA's float32 call as the
                     library column, with --parent the parent's kernels
                     in turns; their launches train_f32's and
                     mla_parity's float32 legs' (7mb's float32 bound is
                     the split's too)
 23. profile       — torch.profiler over 10 serve steps after 10 (bf16 and
                     int8 pools, deepseek-moe-16b's with the MoE kernels'
                     share, and deepseek-v3's with row 10's), over one
                     train step of each train run but gptj_train (the
                     flash and gla kernels' shares), and over one
                     prefill and one window of serve steps of each of
                     xlstm (its prefill 8 x 256), llama, gemma2 and zamba2
                     (8 steps): device busy share, device time by kernel
                     (gla_scan's and flash's shares), the append's share
                     of the serve's device time, and the serve steps'
                     host ops

Launch counts are read from the kernel wrappers: set to 0 just before
each serve run, the train run and the timed xlstm and llama prefills, and
read just after each. The kernels line's launches are those of the timed
serve phases (serve, swap, unfused, spec, quant, quant_unfused), train
and ssm_serve, and the head_dim-256 rows' from their own runs; those
of gather, the sanitized runs, sample, dense_serve, the other
head_dim-256 runs, the MoE, MLA and musicgen runs are logged apart (rows
9 and 9d take moe_serve's, rows 10, 10d and 2m mla_serve's, row 7m
mla_parity's flash launches, 8z zamba2_serve's gla_scan and 7p
pixtral_serve's flash launches, 1g musicgen_serve's ragged launches, 8b
and 8zb xlstm_train's and zamba2_train's gla_scan_bwd launches, 7wb and
7jb gemma2_train's and gptj_train's flash_attention_bwd launches, 7mb
wide_train_parity's deepseek-v3 ones, 7f and 7bf train_f32's float32
flash launches, 7mf mla_parity's float32 flash launches at 192).
The last three lines are the kernels JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
PHASES = ("kernels", "tiny", "tiny_train", "tiny_ssm", "decode_parity",
          "train_parity", "ssm_train_parity", "wide_train_parity",
          "ssm_parity", "wide_parity",
          "moe_parity",
          "mla_parity", "zamba2_parity", "pixtral_parity", "musicgen_parity",
          "serve", "swap", "unfused", "spec", "quant", "quant_unfused",
          "gather", "sanitize", "sanitize_quant", "sample", "gemma2_serve",
          "gemma2_unfused", "gemma2_quant", "gptj_serve", "moe_serve",
          "moe_unfused", "mla_serve", "mla_unfused", "musicgen_serve",
          "musicgen_unfused", "train", "train_f32", "xlstm_train",
          "zamba2_train",
          "gemma2_train", "gptj_train", "ssm_serve", "dense_serve",
          "wide_dense", "zamba2_serve", "pixtral_serve", "timing",
          "profile")
SERVE_PHASES = {"serve": ("infercept", {}), "swap": ("swap", {}),
                "unfused": ("infercept", {"fused": False}),
                "spec": ("infercept", {"speculate": True,
                                       "closed_loop": True}),
                "quant": ("infercept", {"kv_dtype": "int8"}),
                "quant_unfused": ("infercept", {"kv_dtype": "int8",
                                                "fused": False}),
                "gather": ("infercept", {"paged": False}),
                "sanitize": ("infercept", {"sanitize": True}),
                "sanitize_quant": ("infercept", {"kv_dtype": "int8",
                                                 "sanitize": True}),
                "sample": ("infercept", {"sampled": True})}
# the serve phases whose recorded calls the timing phase's rows 1-6 (and
# 3q, 4q) take their inputs from
TIMED_SERVE_PHASES = ("serve", "swap", "unfused", "spec", "quant",
                      "quant_unfused")
# the head_dim-256 serve phases: (model, policy, engine options), each the
# serve run's workload and checks at that model's full width; their
# launches are logged apart from the kernels line's sums, and the gemma2
# runs' recorded calls give the timing phase's head_dim-256 rows
WIDE_SERVE_PHASES = {
    "gemma2_serve": ("gemma2-9b", "infercept", {}),
    "gemma2_unfused": ("gemma2-9b", "infercept", {"fused": False}),
    "gemma2_quant": ("gemma2-9b", "infercept", {"kv_dtype": "int8"}),
    "gptj_serve": ("gpt-j-6b", "infercept", {})}
# their depth, cut for the 1200 s limit: gemma2 to 6 of its 21
# local/global pairs (12 of 42 layers), GPT-J to 7 of its 28 layers;
# rows 1w, 1wd, 1wq and 5w are per-layer calls, whose shapes the cuts keep
WIDE_SERVE_PERIODS = {"gemma2-9b": (6,), "gpt-j-6b": (7,)}
# gemma2's per-call and int8 runs cut further for the 1200 s limit (PR
# 29): 3 pairs, 6 layers (rows 5w and 1wq are per-layer calls)
WIDE_CUT_PERIODS = {"gemma2_unfused": (3,), "gemma2_quant": (3,)}
# wide_parity's models and sequence lengths: one past gemma2's 4096-token
# local window, so the window bites on the fused, per-call and gather legs
WIDE_PARITY_MODELS = ("gemma2-9b", "gpt-j-6b")
WIDE_PARITY_LENS = [37, 160, 4700, 16]
# their depth, cut to 4 layers each (gemma2: 2 local/global pairs; 8
# before PR 29) so that the run stays inside its time limit
WIDE_PARITY_PERIODS = {"gemma2-9b": (2,), "gpt-j-6b": (4,)}
# the MoE model's serve phases (policy, engine options): the serve run's
# workload and checks; launches logged apart, and moe_serve's MoE calls
# give the timing phase's rows 9 and 9d
MOE_MODEL = "deepseek-moe-16b"
MOE_SERVE_PHASES = {"moe_serve": ("infercept", {}),
                    "moe_unfused": ("infercept", {"fused": False})}
# their depth (and the MoE profile's), cut for the 1200 s limit: the
# dense layer and 6 of the 27 MoE layers; rows 9 and 9d are per-layer
# calls, whose shapes the cut keeps
MOE_SERVE_PERIODS = (1, 6)
# moe_unfused's depth, cut further for the 1200 s limit: the dense layer
# and 2 MoE layers (rows 1, 2, 3-4, 5 and the MoE kernels still launch)
MOE_UNFUSED_PERIODS = (1, 2)
# moe_parity's depth: the dense layer and 3 MoE layers
MOE_PARITY_PERIODS = (1, 3)
# deepseek-v3 (MLA attention, 256 routed experts top-8): its serve phases
# (policy, engine options) at the depth that fits one card, the dense
# group's 3 layers and one MoE layer; launches logged apart, and
# mla_serve's calls give the timing phase's rows 10, 10d and 2m
MLA_MODEL = "deepseek-v3-671b"
MLA_SERVE_PHASES = {"mla_serve": ("infercept", {}),
                    "mla_unfused": ("infercept", {"fused": False})}
MLA_SERVE_PERIODS = (3, 1)
# mla_unfused's depth, cut for the 1200 s limit: one dense and the MoE
# layer (rows 10, 2 and 9 still launch, rows 1 and 5 never)
MLA_UNFUSED_PERIODS = (1, 1)
# mla_parity's depth: the dense group alone (the MoE layer at full width
# is moe_parity's)
MLA_PARITY_PERIODS = (3, 0)
# musicgen-large (K 4 codebooks, 48 layers of MHA 32 x 64, GELU FFN): its
# serve phases (policy, engine options) and depths, cut for the 1200 s
# limit: musicgen_serve to 24 layers, musicgen_unfused to 4 (row 5 at Hkv
# 32 without a second deep run); musicgen_serve's ragged calls (per-layer:
# the cut keeps their shapes) give the timing phase's row 1g and its
# largest swap the stager's host times at these widths
MUSICGEN_MODEL = "musicgen-large"
MUSICGEN_SERVE_PHASES = {"musicgen_serve": ("infercept", {}),
                         "musicgen_unfused": ("infercept", {"fused": False})}
MUSICGEN_SERVE_PERIODS = {"musicgen_serve": (24,),
                          "musicgen_unfused": (4,)}
# musicgen_parity's depth
MUSICGEN_PARITY_PERIODS = (4,)
# a sanitized phase and the phase whose streams and counters it repeats
SANITIZED_OF = {"sanitize": "serve", "sanitize_quant": "quant"}
# llama serve runs cut to 4 of the 16 layers for the 1200 s limit (PR
# 29): the per-call runs, spec, gather and the sanitized runs. Their
# checks hold at any depth: a sanitized run is held against an
# unsanitized twin of its own depth run in the same phase; the calls
# that the timing phase takes from the timed ones among them are
# per-layer, with the uncut runs' shapes, and their swaps are smaller
# than the uncut serve, swap and quant runs' (rows 3-4 take the largest)
CUT_SERVE_PERIODS = {"unfused": (4,), "spec": (4,), "quant_unfused": (4,),
                     "gather": (4,), "sanitize": (4,),
                     "sanitize_quant": (4,)}
# the rows of the kernels line: an attention kernel over int8 pools is a
# row of its own beside its wrapper's, and so are the swap kernels over an
# int8 pool tree (payload and scale leaves in one launch, rows 3q/4q),
# and so is the ragged kernel's
# largest decode-only call (its launches: the decode-only calls, no more
# q rows than block-table rows, counted by the serve runs' recorder); the
# quantized append (row 2q) is the whole of kv_append_quant
KERNELS = ("ragged_paged_attention", "paged_attention", "kv_append",
           "kv_append_quant", "swap_pack", "swap_unpack", "swap_pack_int8",
           "swap_unpack_int8", "page_requant",
           "ragged_paged_attention_int8", "paged_attention_int8",
           "ragged_paged_attention_decode",
           "flash_attention", "flash_attention_bwd", "gla_scan")
# the head_dim-256 rows (gemma2-9b's widths): the ragged kernel at
# gemma2_serve's largest call, at its largest decode-only call and at
# gemma2_quant's largest call (int8 pools), the paged kernel at
# gemma2_unfused's largest call, and the flash forward at wide_dense's
# prefill; their launches are those phases' own
WIDE_KERNELS = ("ragged_paged_attention_hd256",
                "ragged_paged_attention_hd256_decode",
                "ragged_paged_attention_hd256_int8",
                "paged_attention_hd256", "flash_attention_hd256")
# the MoE kernels (one launch: the three kernels of one call) at
# moe_serve's largest call and at its largest decode-only call (row 9d;
# its launches: the calls of decode-only fused steps)
MOE_KERNELS = ("moe_experts", "moe_experts_decode")
# the MLA rows: the ragged latent-attention kernel at mla_serve's largest
# call (row 10) and its largest decode-only call (10d), the flash forward
# at head_dim 192 on mla_parity's forward (7m), and kv_append at the latent
# widths, mla_serve's largest call (2m)
MLA_KERNELS = ("mla_attention", "mla_attention_decode",
               "flash_attention_hd192", "kv_append_latent")
# the prefix and shared-block rows: gla_scan on zamba2_serve's first
# mamba2 call (8z) and the flash forward on pixtral_serve's first prefill
# call (7p); their launches are those phases' own
PREFIX_SHARED_KERNELS = ("gla_scan_zamba2", "flash_attention_pixtral")
# the codebook model's row: the ragged kernel at musicgen_serve's largest
# call (1g: MHA, 32 kv heads x G 1 x 64); its launches are that run's
MUSICGEN_KERNELS = ("ragged_paged_attention_musicgen",)
# the gla backward's rows: its kernels at xlstm_train's first mLSTM call
# (8b) and at zamba2_train's first mamba2 call (8zb); their launches are
# those runs' own
GLA_BWD_KERNELS = ("gla_scan_bwd", "gla_scan_bwd_zamba2")
# the flash backward at head_dim 256 and 192: its kernels at
# gemma2_train's first call (7wb), at gptj_train's first call (7jb) and at
# wide_train_parity's deepseek-v3 call (7mb); their launches are those
# runs' own
WIDE_BWD_KERNELS = ("flash_attention_bwd_hd256", "flash_attention_bwd_gptj",
                    "flash_attention_bwd_hd192")
# the float32 flash rows (the split kernels): the forward (7f) and the
# backward (7bf) at train_f32's first call, their launches that run's; the
# forward at 192 (7mf) at row 7m's call in float32, its launches
# mla_parity's float32 legs'
F32_FLASH_KERNELS = ("flash_attention_f32", "flash_attention_bwd_f32",
                     "flash_attention_hd192_f32")
# every row of the kernels line
ROWS = (KERNELS + WIDE_KERNELS + MOE_KERNELS + MLA_KERNELS
        + PREFIX_SHARED_KERNELS + MUSICGEN_KERNELS + GLA_BWD_KERNELS
        + WIDE_BWD_KERNELS + F32_FLASH_KERNELS)
# the TPU kernel of each flash row; the backward has none: the reference
# differentiates its XLA blocked_attention
FLASH_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:97",
    "flash_attention_bwd": "src/repro/models/attention.py:54 (no TPU "
                           "kernel: XLA's autodiff of blocked_attention)"}

# the SSM models' train phases: (model, batch, seq, warm-up steps, timed
# steps), each at full width and depth (xlstm's sLSTM loop runs under
# autograd, a step at a time, so its sequence is the shorter: 8 x 512,
# two chunks of 256 a row, at half the loop's host time of 4 x 1024; its
# timed steps cut to 4 for the 1200 s limit)
SSM_TRAIN = {"xlstm_train": ("xlstm-350m", 8, 512, 2, 4),
             "zamba2_train": ("zamba2-1.2b", 4, 2048, 2, 6)}
# the sequence of the one profiled train step, where it is not the run's:
# xlstm's sLSTM loop makes ~300k host ops a step at 8 x 512, whose parse
# by the profiler would take minutes (as ssm_serve's profiled prefill)
PROFILE_SEQ = {"xlstm_train": 64}
# ssm_train_parity's depth per group: one xlstm period (7 mLSTM + 1
# sLSTM), one zamba2 period (5 mamba2 + the shared block) and its 2-layer
# tail
SSM_TRAIN_PARITY = {"xlstm-350m": (1,), "zamba2-1.2b": (1, 2)}
# the head_dim-256 models' train phases: (model, periods, batch, seq,
# warm-up steps, timed steps), at full width, cut in depth to fit one
# card: gemma2-9b to 2 of its 21 local/global pairs (4 of 42 layers) at 1
# x 8192, Gemma 2's pretraining context (arXiv:2408.00118), so that the
# 4096-token window bites; GPT-J-6B to 8 of its 28 layers at 4 x 2048.
# A step holds the bf16 params and gradients, the float32 AdamW moments
# and, while AdamW runs, the new params and moments beside the old (~22 B
# a param); gemma2's loss keeps its (8192, 256000) logits unchunked, as
# the reference does under a final softcap (7.8 GiB each in float32). On
# the H100's 80 GB gemma2 ran out of memory at 8 and at 4 pairs.
WIDE_TRAIN = {"gemma2_train": ("gemma2-9b", (2,), 1, 8192, 2, 6),
              "gptj_train": ("gpt-j-6b", (8,), 4, 2048, 2, 6)}
# the kernels-line row of each one's flash backward
WIDE_TRAIN_ROWS = {"gemma2_train": "flash_attention_bwd_hd256",
                   "gptj_train": "flash_attention_bwd_gptj"}
# wide_train_parity's models: (periods, sequence length), float32, B 1:
# gemma2-9b at 2 local/global pairs past its 4096-token window, GPT-J-6B
# at 2 layers, deepseek-v3's first dense layer alone (MLA: the backward at
# head_dim 192 through mla_forward)
WIDE_TRAIN_PARITY = {"gemma2-9b": ((2,), 4608), "gpt-j-6b": ((2,), 512),
                     "deepseek-v3-671b": ((1, 0), 512)}

# NVIDIA H100 SXM data sheet peaks (dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def row_key(kernel: str, kv_dtype) -> str:
    """The kernels-line row of a wrapper's launches: the attention and swap
    kernels over int8 pools count apart."""
    if kv_dtype is not None and kernel in ("ragged_paged_attention",
                                           "paged_attention", "swap_pack",
                                           "swap_unpack"):
        return f"{kernel}_int8"
    return kernel


def log(msg: str) -> None:
    """Print a line; a phase's header line ("[...") gets the seconds since
    the run started."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - T_START:.1f} s)"
    print(msg, flush=True)


def card() -> str:
    import torch
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        line = smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        line = "nvidia-smi unavailable"
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one card",
              file=sys.stderr)
        sys.exit(2)
    return line


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def ptxas_report(text: str) -> list:
    """One line per kernel from nvcc's ``ptxas -v`` report (its mangled
    name, registers and spills), and every error line."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        if "error" in line:
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device ms of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    the graph replayed between two events (the faster of two replays), so
    no host time per call is in it (a kernel of ~10-50 us launched from
    Python in a loop is timed by its host, not the card)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def in_turns(plain, kernel, iters: int):
    """plain, kernel, kernel, plain; the faster of each pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return min(k1, k2), min(p1, p2)


def ragged_inputs(gen, *, N, B, Hkv, G, hd, page, max_pages, n_pages,
                  dtype, device, tok_seq=None, tok_pos=None):
    import torch
    q = torch.randn((N, Hkv, G, hd), generator=gen, device=device).to(dtype)
    kp = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                     device=device).to(dtype)
    vp = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                     device=device).to(dtype)
    bt = torch.randint(0, n_pages, (B, max_pages), generator=gen,
                       device=device, dtype=torch.int32)
    if tok_seq is None:
        tok_seq = torch.randint(0, B, (N,), generator=gen, device=device,
                                dtype=torch.int32)
    if tok_pos is None:
        tok_pos = torch.randint(0, page * max_pages, (N,), generator=gen,
                                device=device, dtype=torch.int32)
    return q, kp, vp, bt, tok_seq.to(device), tok_pos.to(device)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def attention_tol() -> dict:
    """The paged attention kernels' tolerance against their plain
    versions: 1e-4 for float32 (sums in another order), 3e-2 for bf16
    (both round one float32 result once, and the kernel rounds P to bf16
    before P.V)."""
    import torch
    return {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def attention_cases(gen, worst, suffix: str = ""):
    """(ragged_case, paged_case): each draws random inputs (``ragged_inputs``)
    of the given widths, runs the kernel and its plain version on the card,
    holds them to ``attention_tol`` with padded rows zero, and keeps the
    largest error in ``worst[kernel + suffix]``."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)
    dev = torch.device("cuda")
    tol = attention_tol()

    def ragged_case(label, dtype, **kw):
        window, softcap = kw.pop("window", None), kw.pop("softcap", None)
        args = ragged_inputs(gen, dtype=dtype, device=dev, **kw)
        got = ragged_paged_attention(*args, window=window, softcap=softcap)
        want = ragged_paged_attention_ref(*args, window=window,
                                          softcap=softcap)
        torch.cuda.synchronize()
        err = max_err(got, want)
        zero_ok = bool((got[args[5] < 0] == 0).all())
        log(f"  ragged_paged_attention {label} {str(dtype)[6:]}: "
            f"max_abs_err {err:.3g} (tol {tol[dtype]:g})"
            f"{'' if zero_ok else ' PADDED ROWS NOT ZERO'}")
        assert err <= tol[dtype] and zero_ok, label
        key = "ragged_paged_attention" + suffix
        worst[key] = max(worst[key], err)

    def paged_case(label, dtype, *, B, ctx_lens=None, window=None,
                   softcap=None, **kw):
        q, kp, vp, bt, _, _ = ragged_inputs(gen, N=B, B=B, dtype=dtype,
                                            device=dev, **kw)
        if ctx_lens is None:
            ctx_lens = torch.randint(1, kw["page"] * kw["max_pages"] + 1,
                                     (B,), generator=gen, device=dev,
                                     dtype=torch.int32)
        args = (q, kp, vp, bt, ctx_lens.to(device=dev, dtype=torch.int32))
        got = paged_attention(*args, window=window, softcap=softcap)
        want = paged_attention_ref(*args, window=window, softcap=softcap)
        torch.cuda.synchronize()
        err = max_err(got, want)
        zero_ok = bool((got[args[4] == 0] == 0).all())
        log(f"  paged_attention {label} {str(dtype)[6:]}: max_abs_err "
            f"{err:.3g} (tol {tol[dtype]:g})"
            f"{'' if zero_ok else ' PADDED ROWS NOT ZERO'}")
        assert err <= tol[dtype] and zero_ok, label
        key = "paged_attention" + suffix
        worst[key] = max(worst[key], err)
    return ragged_case, paged_case


def check_kernels() -> dict:
    import torch
    from repro_torch.kernels.swap_pack import (swap_pack, swap_pack_ref,
                                               swap_unpack, swap_unpack_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {k: 0.0 for k in ROWS}
    ragged_case, paged_case = attention_cases(gen, worst)

    full = dict(Hkv=8, G=4, hd=64, page=16, max_pages=64, n_pages=2048)
    for dtype in (torch.bfloat16, torch.float32):
        # a decode batch at llama3.2-1b widths, then the edges: context
        # 1, a page boundary, one past it and the full table x G {1, 4},
        # each bucket ending in a padded row (ctx_lens 0, output 0)
        paged_case("B=8", dtype, B=8, **full)
        for ctx in (1, 16, 17, 64 * 16):
            for G in (1, 4):
                paged_case(f"ctx={ctx} G={G}", dtype, B=3,
                           ctx_lens=torch.tensor([ctx, max(1, ctx - 1), 0]),
                           **dict(full, G=G))
        for window, softcap in ((7, None), (40, None), (None, 30.0),
                                (9, 25.0)):
            paged_case(f"window={window} softcap={softcap}", dtype, B=5,
                       window=window, softcap=softcap, **full)
        for hd, G in ((32, 4), (128, 8)):
            paged_case(f"hd={hd} G={G}", dtype, B=4,
                       **dict(full, hd=hd, G=G))

        # a mixed iteration at llama3.2-1b widths: 8 decodes and a chunk
        ragged_case("mixed N=264", dtype, N=264, B=9, **full)
        for ctx in (1, 16, 17, 64 * 16):           # page edges, full table
            for G in (1, 4):
                kw = dict(full, G=G)
                pos = torch.tensor([ctx - 1, max(0, ctx - 2), -1],
                                   dtype=torch.int32)
                ragged_case(f"ctx={ctx} G={G}", dtype, N=3, B=1,
                            tok_seq=torch.zeros(3, dtype=torch.int32),
                            tok_pos=pos, **kw)
        ragged_case("all padded", dtype, N=8, B=2,
                    tok_pos=torch.full((8,), -1, dtype=torch.int32), **full)
        for window, softcap in ((7, None), (40, None), (None, 30.0),
                                (9, 25.0)):
            ragged_case(f"window={window} softcap={softcap}", dtype, N=32,
                        B=3, window=window, softcap=softcap, **full)
        for hd, G in ((32, 4), (128, 8)):
            ragged_case(f"hd={hd} G={G}", dtype, N=16, B=2,
                        **dict(full, hd=hd, G=G))
        tile_edge_cases(ragged_case, paged_case, dtype, full)

        check_append(gen, worst, dtype, Hkv=8, hd=64)

        # swap pack/unpack over a stacked (16 periods) payload and a
        # scale-shaped leaf, round trip exact
        for shape in ((16, 128, 16, 8, 64), (16, 128, 8)):
            pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
            ids = torch.randperm(shape[1], generator=gen,
                                 device=dev)[:23].to(torch.int32)
            slab = swap_pack(pool, ids)
            err_p = max_err(slab, swap_pack_ref(pool, ids))
            clobbered = swap_unpack(pool.clone(), torch.zeros_like(slab), ids)
            err_u = max_err(clobbered,
                            swap_unpack_ref(pool.clone(),
                                            torch.zeros_like(slab), ids))
            restored = swap_unpack(clobbered, slab, ids)
            torch.cuda.synchronize()
            err_r = max_err(restored, pool)
            log(f"  swap_pack/unpack {shape} {str(dtype)[6:]}: pack "
                f"{err_p:.3g}, unpack {err_u:.3g}, round trip {err_r:.3g} "
                "(tol 0, copies)")
            assert err_p == err_u == err_r == 0.0, shape
            worst["swap_pack"] = max(worst["swap_pack"], err_p)
            worst["swap_unpack"] = max(worst["swap_unpack"], err_u, err_r)
    check_quant_kernels(gen, worst)
    check_swap_kernels(gen)
    check_wide_kernels(gen, worst)
    return worst


def check_append(gen, worst, dtype, *, Hkv, hd, hd_v=None,
                 key="kv_append") -> None:
    """kv_append at (Hkv, hd) in ``dtype`` (the V pool's rows ``hd_v``
    wide where given: MLA's latent c and rope key kr, row 2m under
    ``key``), exact against its plain version: distinct slots, random
    validity, the 8-row blocks' edges, then all invalid; one launch a
    call."""
    import torch
    from repro_torch.kernels.kv_append import kv_append, kv_append_ref
    dev = torch.device("cuda")
    n_pages, page = 64, 16
    for label, n, all_invalid in (("N=37", 37, False), ("N=1", 1, False),
                                  ("N=7", 7, False), ("N=8", 8, False),
                                  ("N=9", 9, False), ("N=512", 512, False),
                                  ("all invalid", 16, True)):
        kp, vp = (torch.randn((n_pages, page, Hkv, w), generator=gen,
                              device=dev).to(dtype) for w in (hd, hd_v or hd))
        kn, vn = (torch.randn((n, Hkv, w), generator=gen,
                              device=dev).to(dtype) for w in (hd, hd_v or hd))
        slots = torch.randperm(n_pages * page, generator=gen,
                               device=dev)[:n]
        ids = (slots // page).to(torch.int32)
        offs = (slots % page).to(torch.int32)
        valid = torch.zeros(n, dtype=torch.int32, device=dev) \
            if all_invalid else torch.randint(
                0, 2, (n,), generator=gen, device=dev, dtype=torch.int32)
        want_k, want_v = kv_append_ref(kp.clone(), vp.clone(), kn, vn, ids,
                                       offs, valid)
        before = kv_append.launches
        got_k, got_v = kv_append(kp, vp, kn, vn, ids, offs, valid)
        torch.cuda.synchronize()
        assert kv_append.launches == before + 1
        err = max(max_err(got_k, want_k), max_err(got_v, want_v))
        log(f"  kv_append Hkv={Hkv} hd={hd}"
            f"{f' hd_v={hd_v}' if hd_v else ''} {label} {str(dtype)[6:]}: "
            f"max_abs_err {err:.3g} (tol 0, a copy)")
        assert err == 0.0, (Hkv, hd, hd_v, label)
        worst[key] = max(worst[key], err)


def layout(lens, starts, pad=0, order=None):
    """The engine's ragged layout: sequence b's lens[b] tokens at positions
    starts[b], starts[b] + 1, ... on consecutive rows, then ``pad`` padded
    rows (tok_seq 0, tok_pos -1); ``order`` permutes the rows."""
    import torch
    seq = [b for b, n in enumerate(lens) for _ in range(n)] + [0] * pad
    pos = [s + i for n, s in zip(lens, starts) for i in range(n)] + [-1] * pad
    if order is not None:
        seq, pos = [seq[i] for i in order], [pos[i] for i in order]
    return (torch.tensor(seq, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32))


def tile_edge_cases(ragged_case, paged_case, dtype, full, Gs=(1, 4, 8),
                    hds=(32, 64, 128)) -> None:
    """The bf16 sweep's edges (csrc/paged_tc.cuh), held like every other
    case, at ``full``'s widths and over G in ``Gs`` x hd in ``hds``:
    chunks of one sequence of tq - 1, tq and tq + 1 tokens (tq = 64 / G);
    two sequences inside one tile; unsorted tok_seq; decode-only buckets
    whose contexts end at a split's edge, one past it and at the full
    64-page table; the paged kernel at B = 1 (a split a 64-key stage) and
    B = 3 over the same edges; a G past a tile's rows (the CUDA-core
    kernel); and the split-KV arrival counters zero after all of them."""
    import torch
    from repro_torch.kernels.ragged_paged_attention import (_COUNTERS,
                                                            TILE_ROWS,
                                                            tile_tokens)
    for G in Gs:
        for hd in hds:
            kw = dict(full, G=G, hd=hd)
            tq = tile_tokens(G)
            for n in (tq - 1, tq, tq + 1):
                for start in (100, 1024 - n):
                    ts, tp = layout([n], [start], pad=1)
                    ragged_case(f"chunk {n} at {start} G={G} hd={hd}",
                                dtype, N=n + 1, B=1, tok_seq=ts, tok_pos=tp,
                                **kw)
    tag = f"Hkv={full['Hkv']} G={full['G']} hd={full['hd']}"
    ts, tp = layout([3, 5, 20], [30, 700, 0], pad=4)
    ragged_case(f"two sequences in one tile {tag}", dtype, N=32, B=3,
                tok_seq=ts, tok_pos=tp, **full)
    order = torch.randperm(40, generator=torch.Generator().manual_seed(0))
    ts, tp = layout([1, 17, 9, 1, 12], [63, 0, 250, 1023, 500],
                    order=order.tolist())
    ragged_case(f"unsorted tok_seq {tag}", dtype, N=40, B=5, tok_seq=ts,
                tok_pos=tp, **full)
    edges = [64, 65, 256, 257, 768, 769, 1024, 1]
    ts, tp = layout([1] * 8, [c - 1 for c in edges])
    ragged_case(f"decode-only ctx {edges} {tag}", dtype, N=8, B=8,
                tok_seq=ts, tok_pos=tp, **full)
    for G in Gs:
        ts, tp = layout([1] * 8, [c - 1 for c in edges])
        ragged_case(f"decode-only G={G} {tag}", dtype, N=8, B=8, tok_seq=ts,
                    tok_pos=tp, **dict(full, G=G))
    for ctx in (1, 64, 65, 128, 129, 687, 1024):
        paged_case(f"B=1 ctx={ctx} {tag}", dtype, B=1,
                   ctx_lens=torch.tensor([ctx]), **full)
    for G in Gs:
        for hd in hds:
            paged_case(f"B=3 ctx 65/1024/0 G={G} hd={hd}", dtype, B=3,
                       ctx_lens=torch.tensor([65, 1024, 0]),
                       **dict(full, G=G, hd=hd))
    # more heads a row than a tile holds: the CUDA-core kernel
    wide = dict(full, G=TILE_ROWS + 8, hd=32)
    ts, tp = layout([5, 1], [100, 687], pad=1)
    ragged_case(f"G={wide['G']} hd=32", dtype, N=7, B=2, tok_seq=ts,
                tok_pos=tp, **wide)
    paged_case(f"G={wide['G']} hd=32", dtype, B=2,
               ctx_lens=torch.tensor([687, 0]), **wide)
    # every split launch leaves its arrival counters zero
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in _COUNTERS.values()), \
        "split counters left nonzero"


def check_wide_kernels(gen, worst) -> None:
    """Head dim 256, the widths of GPT-J-6B (16 kv heads, G 1) and
    gemma2-9b (8 kv heads, G 2), through the narrower widths' case
    functions: the ragged and paged kernels in bf16 (the tensor-core
    sweep) and float32 (the CUDA-core kernels) over float pools — a
    decode batch, windows 7 and 40, softcap 50 (gemma2's) alone and with
    window 40, a mixed iteration, a decode-only bucket with window and
    softcap, and ``tile_edge_cases`` at these widths — then over int8,
    float8_e4m3 and float8_e5m2 pools (``scaled_attention_cases``);
    kv_append (``check_append``) and kv_append_quant
    (``check_append_quant``) at Hkv {8, 16} x hd 256; the tree swap
    (``swap_tree_case``) over gemma2's and GPT-J's own pool trees, bf16
    and int8 (payload rows of 64 and 128 KB, float32 scale leaves), n {1,
    7, 34}; the flash forward (out and lse) and backward (dq, dk, dv,
    ``check_flash_bwd``) causal, with windows 33 and 100, softcap 50, Tq <
    Tk, no causal mask, G 1, 2 and 16, T 1 and 129, and gemma2's window
    4096 at T 4097. Tolerances as the narrower cases': ``attention_tol``,
    lse 1e-4, gradients ``check_flash_bwd``'s; appends and swaps bit for
    bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    from repro_torch.kernels.kv_quant import KV_QUANT_DTYPES
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_leaves
    dev = torch.device("cuda")
    tol = attention_tol()
    ragged_case, paged_case = attention_cases(gen, worst, "_hd256")
    edges = [64, 65, 256, 257, 768, 769, 1024, 1]
    widths = ((16, 1), (8, 2))                 # (Hkv, G): GPT-J, gemma2
    for dtype in (torch.bfloat16, torch.float32):
        for Hkv, G in widths:
            full = dict(Hkv=Hkv, G=G, hd=256, page=16, max_pages=64,
                        n_pages=2048)
            tag = f"hd=256 Hkv={Hkv} G={G}"
            paged_case(f"B=8 {tag}", dtype, B=8, **full)
            for window, softcap in ((7, None), (40, None), (None, 50.0),
                                    (40, 50.0)):
                paged_case(f"window={window} softcap={softcap} {tag}",
                           dtype, B=5, window=window, softcap=softcap,
                           **full)
                ragged_case(f"window={window} softcap={softcap} {tag}",
                            dtype, N=32, B=3, window=window,
                            softcap=softcap, **full)
            ragged_case(f"mixed N=264 {tag}", dtype, N=264, B=9, **full)
            ts, tp = layout([1] * 8, [c - 1 for c in edges])
            ragged_case(f"decode-only window=40 softcap=50 {tag}", dtype,
                        N=8, B=8, tok_seq=ts, tok_pos=tp, window=40,
                        softcap=50.0, **full)
            tile_edge_cases(ragged_case, paged_case, dtype, full, Gs=(G,),
                            hds=(256,))
        check_append(gen, worst, dtype, Hkv=8, hd=256)
        check_append(gen, worst, dtype, Hkv=16, hd=256)

    # quantized pools at head_dim 256: attention and the fused append
    for name in sorted(KV_QUANT_DTYPES):
        for Hkv, G in widths:
            pools = quant_pools(gen, name, n_pages=2048, page=16, Hkv=Hkv,
                                hd=256, device=dev)
            scaled_attention_cases(gen, worst, name, pools, Gs=(G,),
                                   capped=((7, None), (None, 50.0),
                                           (40, 50.0)), suffix="_hd256")
            del pools
        check_append_quant(gen, name, heads=(8, 16), head_dims=(256,))

    # the tree swap over the models' own pool trees
    for model in ("gemma2-9b", "gpt-j-6b"):
        lm = LM(get_config(model))
        for kv_dtype in (None, "int8"):
            leaves = tree_leaves(lm.init_cache(40, 16, dtype=torch.bfloat16,
                                               device=dev, kv_dtype=kv_dtype))
            for leaf in leaves:
                leaf.view(torch.uint8).copy_(torch.randint(
                    0, 256, leaf.view(torch.uint8).shape, generator=gen,
                    device=dev, dtype=torch.uint8))
            for n in (1, 7, 34):
                for shift in (0, 8):
                    swap_tree_case(gen, leaves, n, shift)
            log(f"  swap_pack/swap_unpack over {model}'s "
                f"{kv_dtype or 'bf16'} pool tree "
                f"{[tuple(t.shape) for t in leaves]}: n {{1, 7, 34}}, "
                "aligned and shifted slabs, distinct and repeated ids, "
                "byte for byte against the plain versions")
            del leaves

    # the flash forward and backward at head_dim 256
    cases = [
        ("gemma2 T=1", dict(B=2, Hkv=8, G=2, Tq=1, Tk=1), {}),
        ("gemma2 T=129", dict(B=2, Hkv=8, G=2, Tq=129, Tk=129), {}),
        ("gemma2 B=2 T=1024 softcap=50", dict(B=2, Hkv=8, G=2, Tq=1024,
                                              Tk=1024), dict(softcap=50.0)),
        ("gemma2 window=100 softcap=50", dict(B=1, Hkv=8, G=2, Tq=300,
                                              Tk=300),
         dict(window=100, softcap=50.0)),
        ("gemma2 window=33 Tq<Tk", dict(B=1, Hkv=8, G=2, Tq=150, Tk=500),
         dict(window=33)),
        ("gptj G=1 T=200", dict(B=2, Hkv=16, G=1, Tq=200, Tk=200), {}),
        ("gptj G=1 non-causal", dict(B=1, Hkv=16, G=1, Tq=90, Tk=130),
         dict(causal=False)),
        ("G=16 T=100", dict(B=1, Hkv=1, G=16, Tq=100, Tk=100), {}),
        # gemma2's local layers: the 4096-token window bites at T 4097
        ("gemma2 window=4096 softcap=50 T=4097",
         dict(B=1, Hkv=8, G=2, Tq=4097, Tk=4097),
         dict(window=4096, softcap=50.0))]
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape, kw in cases:
            B, Hkv, G, Tq, Tk = (shape[k] for k in ("B", "Hkv", "G", "Tq",
                                                    "Tk"))
            q = torch.randn((B, Hkv, G, Tq, 256), generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn((B, Hkv, Tk, 256), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            out, lse = flash_attention_fwd(q, k, v, **kw)
            want, want_lse = flash_attention_fwd_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err, lse_err = max_err(out, want), max_err(lse, want_lse)
            log(f"  flash_attention hd=256 {label} {str(dtype)[6:]}: out "
                f"max_abs_err {err:.3g} (tol {tol[dtype]:g}), lse "
                f"{lse_err:.3g} (tol 1e-4)")
            assert err <= tol[dtype] and lse_err <= 1e-4, label
            worst["flash_attention_hd256"] = max(
                worst["flash_attention_hd256"], err)
            del want, want_lse
            g_err = check_flash_bwd(gen, f"hd=256 {label}", q, k, v, out,
                                    lse, kw)
            for row in ("flash_attention_bwd_hd256",
                        "flash_attention_bwd_gptj"):
                worst[row] = max(worst[row], g_err)
            del q, k, v, out, lse
    torch.cuda.empty_cache()


def check_flash_bwd(gen, label, q, k, v, out, lse, kw, v_width=None
                    ) -> float:
    """The flash backward kernels (one launch: dQ, then dK/dV) against
    ``flash_attention_bwd_ref`` on the forward's ``out`` and ``lse`` and
    a random gradient at the output (zero past ``v_width`` columns, as it
    reaches a zero-padded v): dq, dk and dv within 1e-4 (float32) or 2^-6
    (bf16, two units in the last place) of the largest magnitude among
    them, as ``check_flash_kernels``; dv exactly zero past ``v_width``.
    Returns the largest absolute error."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref)
    rel = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}[q.dtype]
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    if v_width is not None:
        do[..., v_width:] = 0
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1, label
    g_abs = [max_err(g, w) for g, w in zip(grads, want)]
    g_rel = max(g_abs) / max(float(w.float().abs().max()) for w in want)
    log(f"  flash_attention_bwd {label} {str(q.dtype)[6:]}: dq/dk/dv "
        f"max_abs_err {g_rel:.3g} of their max (tol {rel:.3g})"
        f"{f'; dv zero past {v_width}' if v_width is not None else ''}")
    assert g_rel <= rel, label
    if v_width is not None:
        assert bool((grads[2][..., v_width:] == 0).all()), label
    return max(g_abs)


def same_bytes(a, b) -> bool:
    """Bit-for-bit equality, a 1-byte payload through a uint8 view."""
    import torch
    view = (lambda t: t.view(torch.uint8) if t.element_size() == 1  # noqa
            else t)
    return a.shape == b.shape and bool(torch.equal(view(a), view(b)))


def differing(got, want, names=("k_pool", "v_pool", "k_scale", "v_scale")
              ) -> str:
    """Which of the outputs differ and by how many elements: the line an
    exactness failure logs."""
    import torch
    out = []
    for name, a, b in zip(names, got, want):
        if not same_bytes(a, b):
            view = (lambda t: t.view(torch.uint8)  # noqa: E731
                    if t.element_size() == 1 else t)
            out.append(f"{name}: {int((view(a) != view(b)).sum())} of "
                       f"{a.numel()} differ")
    return "; ".join(out) or "none differ"


def quant_pools(gen, name, *, n_pages, page, Hkv, hd, device):
    """Random K and V quantized at one scale per (page, kv head): payload
    and scales as kv_append_quant would leave them."""
    import torch
    from repro_torch.kernels.kv_quant import (kv_quant_dtype, kv_quant_qmax,
                                              quantize_rows)
    qd = kv_quant_dtype(name)
    out = []
    for _ in range(2):
        f = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                        device=device)
        scale = f.abs().amax(dim=(1, 3)) / kv_quant_qmax(qd)
        out += [quantize_rows(f, scale[:, None], qd), scale]
    kq, ks, vq, vs = out
    return kq, vq, ks, vs


def append_quant_case(gen, name, rdtype, *, N, Hkv, hd, device,
                      n_pages=64, page=16):
    """A quantized append on the card: pools quantized at random
    per-(page, head) scales, four of them zero (over leftover payload),
    then N rows on distinct slots (so pages repeat in any order), ~1/8 of
    them invalid, ~1/20 with an id out of range, the middle row all zero,
    at 8x a page's span for odd N, half of it for even N. Returns
    ([k_pool, v_pool, k_scale, v_scale], (k_new, v_new, page_ids,
    offsets, valid))."""
    import torch
    from repro_torch.kernels.kv_quant import (kv_quant_dtype, kv_quant_qmax,
                                              quantize_rows)
    qd = kv_quant_dtype(name)
    qmax = kv_quant_qmax(qd)
    state = []
    for _ in range(2):
        s = torch.rand((n_pages, Hkv), generator=gen, device=device) * 0.09 \
            + 0.01
        f = (torch.rand((n_pages, page, Hkv, hd), generator=gen,
                        device=device) * 2 - 1) * s[:, None, :, None] * qmax
        q = quantize_rows(f, s[:, None].expand(n_pages, page, Hkv), qd)
        s[:4] = 0.0
        state += [q, s]
    kq, ks, vq, vs = state
    slots = torch.randperm(n_pages * page, generator=gen, device=device)[:N]
    far = torch.rand(N, generator=gen, device=device) < 0.05
    ids = torch.where(far, n_pages + 2, slots // page).to(torch.int32)
    valid = (torch.rand(N, generator=gen, device=device) > 0.125).to(
        torch.int32)
    mag = 8.0 if N % 2 else 0.5
    rows = [(torch.randn((N, Hkv, hd), generator=gen, device=device) * mag
             * 0.05 * qmax).to(rdtype) for _ in range(2)]
    for r in rows:
        r[N // 2] = 0
    return [kq, vq, ks, vs], (*rows, ids, (slots % page).to(torch.int32),
                              valid)


def check_append_quant(gen, name, *, heads, head_dims) -> None:
    """kv_append_quant over ``name`` pools, Hkv in ``heads`` x hd in
    ``head_dims`` x N {1, 7, 16, 17, 512} with bf16 and f32 rows
    (``append_quant_case``: pages named by several rows in any order,
    invalid rows on valid rows' pages, ids out of range, zero-scale pages,
    an all-zero row, rows that grow the scales and rows that mostly do
    not), payload and scales bit for bit against the plain version on the
    card and on the CPU."""
    import torch
    from repro_torch.kernels.kv_quant import (kv_append_quant,
                                              kv_append_quant_ref)
    dev = torch.device("cuda")
    for rdtype in (torch.bfloat16, torch.float32):
        for kv_heads in heads:
            for head_dim in head_dims:
                for n in (1, 7, 16, 17, 512):
                    state, args = append_quant_case(
                        gen, name, rdtype, N=n, Hkv=kv_heads, hd=head_dim,
                        device=dev)
                    want = kv_append_quant_ref(*(t.clone() for t in state),
                                               *args)
                    # the plain version on the CPU, which the tests hold
                    # against the JAX reference: a witness that the card's
                    # plain version is not the kernel's twin
                    on_cpu = kv_append_quant_ref(
                        *(t.cpu() for t in (*state, *args)))
                    got = kv_append_quant(*state, *args)
                    torch.cuda.synchronize()
                    ok = all(same_bytes(a, b) for a, b in zip(got, want))
                    assert ok, (name, rdtype, kv_heads, head_dim, n,
                                differing(got, want))
                    got = [t.cpu() for t in got]
                    ok = all(same_bytes(a, b) for a, b in zip(got, on_cpu))
                    assert ok, (name, rdtype, kv_heads, head_dim, n,
                                "against the CPU", differing(got, on_cpu))
        log(f"  kv_append_quant {name}, rows {str(rdtype)[6:]}: Hkv "
            f"{set(heads)} x hd {set(head_dims)} x N {{1, 7, 16, 17, 512}}, "
            "payload and scales bit-exact against the plain version on the "
            "card and on the CPU")


def scaled_attention_cases(gen, worst, name, pools, *, Gs,
                           capped=((7, None), (None, 30.0), (9, 25.0)),
                           suffix="") -> None:
    """The paged and ragged kernels over ``name`` pools (kq, vq, ks, vs),
    bf16 and float32 q, within ``attention_tol`` (the same sums, the
    dequantizing multiply exact in both), padded rows zero: contexts {1,
    16, 17, 65, 1024} x G in ``Gs``, each batch ending in a padded row;
    at the last G, the (window, softcap) pairs of ``capped`` and the bf16
    sweep's edges over the payload (a chunk one past a tile, two
    sequences in one tile, a decode-only bucket at split edges). int8
    pools' errors go to ``worst[kernel + suffix + "_int8"]`` where the
    kernels line has that row."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_quant_ref)
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_quant_ref,
        tile_tokens)
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    tol = attention_tol()
    kq, vq, ks, vs = pools
    n_pages, _, Hkv, hd = kq.shape
    G = Gs[-1]

    def keep(kernel, err):
        key = f"{kernel}{suffix}_int8"
        if name == "int8" and key in worst:
            worst[key] = max(worst[key], err)

    for qdtype in (torch.bfloat16, torch.float32):
        label = f"{name} pools, Hkv={Hkv} hd={hd} q {str(qdtype)[6:]}"
        cases = [(torch.tensor([ctx, max(1, ctx - 1), 0], **i32), g, {})
                 for ctx in (1, 16, 17, 65, 1024) for g in Gs]
        cases += [(torch.randint(1, 1025, (5,), generator=gen, **i32), G,
                   dict(window=window, softcap=softcap))
                  for window, softcap in capped]
        for ctx_lens, g, kw in cases:
            B = ctx_lens.numel()
            q = torch.randn((B, Hkv, g, hd), generator=gen,
                            device=dev).to(qdtype)
            bt = torch.randint(0, n_pages, (B, 64), generator=gen, **i32)
            for kernel, plain, extra, key in (
                    (paged_attention, paged_attention_quant_ref,
                     (ctx_lens,), "paged_attention"),
                    (ragged_paged_attention,
                     ragged_paged_attention_quant_ref,
                     (torch.arange(B, **i32), ctx_lens - 1),
                     "ragged_paged_attention")):
                got = kernel(q, kq, vq, bt, *extra, k_scale=ks, v_scale=vs,
                             **kw)
                want = plain(q, kq, vq, ks, vs, bt, *extra, **kw)
                torch.cuda.synchronize()
                err = max_err(got, want)
                zero = bool((got[ctx_lens == 0] == 0).all())
                assert err <= tol[qdtype] and zero, (label, g, kw, key, err)
                keep(key, err)
        # the bf16 sweep's edges over the payload
        for lens, starts, pad in (([tile_tokens(G) + 1], [100], 1),
                                  ([3, 5, 20], [30, 700, 0], 4),
                                  ([1] * 8, [63, 64, 255, 256, 767, 768,
                                             1023, 0], 0)):
            ts, tp = (t.to(dev) for t in layout(lens, starts, pad))
            n = ts.numel()
            q = torch.randn((n, Hkv, G, hd), generator=gen,
                            device=dev).to(qdtype)
            bt = torch.randint(0, n_pages, (len(lens), 64), generator=gen,
                               **i32)
            got = ragged_paged_attention(q, kq, vq, bt, ts, tp, k_scale=ks,
                                         v_scale=vs)
            want = ragged_paged_attention_quant_ref(q, kq, vq, ks, vs, bt,
                                                    ts, tp)
            err = max_err(got, want)
            assert err <= tol[qdtype] and bool((got[tp < 0] == 0).all()), \
                (label, lens, err)
            keep("ragged_paged_attention", err)
        log(f"  scaled paged/ragged attention, {label}: ctx {{1, 16, 17, "
            f"65, 1024}} x G {set(Gs)}, (window, softcap) {list(capped)}, "
            f"a chunk past a tile, two sequences in a tile, decode at split "
            f"edges within {tol[qdtype]:g}, padded rows zero")


def check_quant_kernels(gen, worst) -> None:
    """The quantized pools' kernels on the card: page_requant and the
    fused kv_append_quant bit for bit against their plain versions
    (the same float32 multiply, round-half-to-even and clip, and a
    round-to-nearest-even float8 cast), kv_append_quant also against its
    plain version run on the CPU (``check_append_quant``); the attention
    kernels over int8, float8_e4m3 and float8_e5m2 pools within the float
    pools' tolerances (``scaled_attention_cases``); a SwapStager round
    trip of a quantized pool tree, exact."""
    import torch
    from repro_torch.kernels.kv_quant import (KV_QUANT_DTYPES, page_requant,
                                              page_requant_ref)
    from repro_torch.kernels.swap_pack import (SwapStager, slab_pages,
                                               swap_pack, swap_unpack)
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    n_pages, page, Hkv, hd = 256, 16, 8, 64
    for name in sorted(KV_QUANT_DTYPES):
        # page_requant: 512 rows over 256 pages, so most pages are named
        # more than once, some ids out of range (invalid rows)
        kq, vq, ks, vs = quant_pools(gen, name, n_pages=n_pages, page=page,
                                     Hkv=Hkv, hd=hd, device=dev)
        N = 512
        pids = torch.randint(0, n_pages + 16, (N,), generator=gen, **i32)
        kr = torch.rand((N, Hkv), generator=gen, device=dev)
        vr = torch.rand((N, Hkv), generator=gen, device=dev)
        kr[:8] = 1.0                                  # the identity
        want = page_requant_ref(kq.clone(), vq.clone(), kr, vr, pids)
        got = page_requant(kq.clone(), vq.clone(), kr, vr, pids)
        torch.cuda.synchronize()
        ok = all(same_bytes(a, b) for a, b in zip(got, want))
        log(f"  page_requant {name} N={N}: bit-exact {ok}")
        assert ok, name
        # kv_append_quant, the fused kernel, over Hkv {1, 8} x hd {32, 64,
        # 128}
        check_append_quant(gen, name, heads=(1, 8), head_dims=(32, 64, 128))
        # the scaled attention kernels
        pools = quant_pools(gen, name, n_pages=2048, page=page, Hkv=Hkv,
                            hd=hd, device=dev)
        scaled_attention_cases(gen, worst, name, pools, Gs=(1, 4))
    # the stager moves a quantized pool tree's scale leaves with its
    # payload: pack, collect, clobber, unpack, compare
    kq, vq, ks, vs = quant_pools(gen, "int8", n_pages=128, page=page,
                                 Hkv=Hkv, hd=hd, device=dev)
    pools = ({"b0": {"k": kq.expand(4, *kq.shape).contiguous(),
                     "k_scale": ks.expand(4, *ks.shape).contiguous(),
                     "v": vq.expand(4, *vq.shape).contiguous(),
                     "v_scale": vs.expand(4, *vs.shape).contiguous()}},)
    want = {k: v.clone() for k, v in pools[0]["b0"].items()}
    st = SwapStager()
    ids = [5, 77, 3, 120]
    before = (swap_pack.launches, swap_unpack.launches)
    slab = st.collect(st.pack(pools, ids))
    for leaf in pools[0]["b0"].values():
        leaf[:, ids] = 0
    st.unpack(pools, ids, slab_pages(slab, len(ids)))
    torch.cuda.synchronize()
    ok = all(same_bytes(pools[0]["b0"][k], want[k]) for k in want)
    launched = (swap_pack.launches - before[0],
                swap_unpack.launches - before[1])
    log(f"  SwapStager round trip of int8 pools and their scale leaves "
        f"(slab leaves {[tuple(t.shape) for t in slab[0]['b0'].values()]}): "
        f"exact {ok}, launches {launched} (one each for the 4 leaves)")
    assert ok and launched == (1, 1), launched


def byte_equal(a, b) -> bool:
    """Bit-for-bit equality of two tensors of one shape and dtype."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


# (trailing shape, dtype) of the swap grid's leaves: rows of 16 KB (one
# stage), 8 KB, 20 KB and 24 KB (pieces of stages), 512 and 1040 bytes
# (many rows a chunk) on the bulk copies; 48 and 32 bytes (16-byte words),
# 4, 8, 18 and 5 bytes on the word path
SWAP_LEAVES = (((16, 8, 64), "bfloat16"), ((16, 8, 64), "int8"),
               ((20, 8, 64), "bfloat16"), ((3, 16, 8, 16), "float32"),
               ((48,), "float8_e4m3fn"), ((8,), "float32"),
               ((1,), "float32"), ((2,), "float32"), ((9,), "bfloat16"),
               ((5,), "int8"), ((256,), "bfloat16"), ((260,), "float32"))


def swap_leaf(gen, P, n_pages, trailing, dtype, device):
    """A random pool leaf (P, n_pages, *trailing) of ``dtype``."""
    import torch
    dtype = getattr(torch, dtype)
    raw = torch.randint(0, 256, (P, n_pages, *trailing[:-1],
                                 trailing[-1] * dtype.itemsize),
                        generator=gen, device=device, dtype=torch.uint8)
    return raw.view(dtype)


def swap_tree_case(gen, leaves, n: int, shift: int) -> None:
    """One tree pack and two unpacks of ``leaves`` (P, n_pages, ...) byte
    for byte against the plain versions: a pack of n random ids, some out
    of range, into a slab that starts ``shift`` bytes into its buffer; an
    unpack of distinct ids, some out of range; an unpack of repeated ids
    (pages 0-9), where the last row naming a page wins. One launch per
    call, none at n 0. Skipped rows keep the slab's bytes."""
    import torch
    from repro_torch.kernels.swap_pack import (slab_layout, swap_pack,
                                               swap_pack_tree,
                                               swap_pack_tree_ref,
                                               swap_unpack, swap_unpack_tree,
                                               swap_unpack_tree_ref)
    dev = leaves[0].device
    i32 = dict(device=dev, dtype=torch.int32)
    n_pages = leaves[0].shape[1]
    what = ([tuple(t.shape) for t in leaves], n, shift)
    _, size = slab_layout(leaves, n)
    buf = torch.randint(0, 256, (size + shift,), generator=gen, device=dev,
                        dtype=torch.uint8)
    ids = torch.randint(-3, n_pages + 4, (n,), generator=gen, **i32)
    before = (swap_pack.launches, swap_unpack.launches)
    got = buf.clone()
    want = buf.clone()
    swap_pack_tree(leaves, ids, got[shift:])
    swap_pack_tree_ref(leaves, ids, want[shift:])
    torch.cuda.synchronize()
    assert byte_equal(got, want), ("pack", what)
    # unpack: distinct ids, some out of range
    uids = torch.randperm(n_pages + 8, generator=gen, device=dev)[:n].to(
        torch.int32)
    mine = [leaf.clone() for leaf in leaves]
    swap_unpack_tree(mine, buf[shift:], uids)
    swap_unpack_tree_ref(leaves, buf[shift:], uids)
    torch.cuda.synchronize()
    assert all(byte_equal(a, b) for a, b in zip(mine, leaves)), \
        ("unpack", what)
    # unpack: ids repeated (pages 0-9 only) and out of range
    rids = torch.randint(0, 10, (n,), generator=gen, **i32)
    rids[::5] = -1
    rids[1::7] = n_pages
    swap_unpack_tree(mine, buf[shift:], rids)
    swap_unpack_tree_ref(leaves, buf[shift:], rids)
    torch.cuda.synchronize()
    assert all(byte_equal(a, b) for a, b in zip(mine, leaves)), \
        ("repeated", what)
    launched = (swap_pack.launches - before[0],
                swap_unpack.launches - before[1])
    assert launched == ((0, 0) if n == 0 else (1, 2)), (what, launched)


def check_swap_kernels(gen) -> None:
    """The tree pack and unpack (rows 3, 4, 3q, 4q) byte for byte against
    their plain versions on the card (``swap_tree_case``) over a ragged
    grid: trees of 1-4 leaves from SWAP_LEAVES (bulk and word-path rows,
    rows larger than a stage, the int8 pools' tree of payload and scale
    leaves), P {1, 3}, n {0, 1, 7, 34, 100}, slabs with 128-byte aligned
    sections and slabs that start 8 bytes into their buffer."""
    import torch
    dev = torch.device("cuda")
    n_pages = 128
    trees = [[0], [1, 4], [0, 5, 1, 5], [2, 3], [6, 7, 8, 9], [0, 6, 1, 9],
             [4, 5, 8, 2], [10, 11, 7]]
    cases = 0
    for picks in trees:
        for P in (1, 3):
            for n in (0, 1, 7, 34, 100):
                for shift in (0, 8):
                    leaves = [swap_leaf(gen, P, n_pages, *SWAP_LEAVES[i],
                                        dev) for i in picks]
                    swap_tree_case(gen, leaves, n, shift)
                    cases += 1
    log(f"  swap_pack/swap_unpack trees: {cases} cases ({len(trees)} trees "
        "of 1-4 leaves, rows 4 B to 24 KB, P {1, 3}, n {0, 1, 7, 34, 100}, "
        "aligned and shifted slabs; unpacks of distinct and of repeated "
        "ids) byte for byte against the plain versions, one launch per "
        "call and none at n 0")


# ---------------------------------------------------------------------------
# phase 4: tiny config, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------
def check_close(label, card_out, cpu_out, card_pools, cpu_pools) -> None:
    """Card logits within 1e-3 of the CPU plain path's; float pools within
    1e-4 of the pools' largest magnitude (the appended K/V come from
    float32 products summed in another order on the card). int8 pools:
    scales within 1e-4 relative (the amax of those K/V rows), the
    payload within one quantization step (a value on a rounding edge may
    land on either side)."""
    import torch
    from repro_torch.utils.tree import tree_leaves
    err = max_err(card_out.cpu(), cpu_out)
    pool_err, pool_tol, steps, scale_rel = 0.0, 0.0, 0.0, 0.0
    for g, c in zip(tree_leaves(card_pools), tree_leaves(cpu_pools)):
        g = g.cpu()
        if c.dtype == torch.int8:
            steps = max(steps, max_err(g, c))
        elif c.dim() == 3:               # (periods, n_pages, Hkv) scales
            scale_rel = max(scale_rel, float(((g - c).abs()
                                              / c.abs().clamp(min=1e-30))
                                             .max()))
        else:
            pool_err = max(pool_err, max_err(g, c))
            pool_tol = max(pool_tol, 1e-4 * float(c.abs().max()))
    log(f"  tiny {label}: logits max_abs_err {err:.3g} (tol 1e-3), pools "
        f"{pool_err:.3g} (tol {pool_tol:.3g}), quantized payload "
        f"{steps:.3g} steps (tol 1), scales {scale_rel:.3g} relative (tol "
        "1e-4)")
    assert err <= 1e-3 and pool_err <= pool_tol, label
    assert steps <= 1 and scale_rel <= 1e-4, label
    assert bool(torch.isfinite(card_out).all()), label


def check_tiny() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_map
    cfg = get_config("llama3.2-1b", tiny=True)
    lm = LM(cfg)
    gen = torch.Generator().manual_seed(0)
    params = lm.init(gen, dtype=torch.float32, device="cpu")
    n_pages, page, max_pages = 32, 16, 8
    pools = tree_map(lambda z: torch.randn(z.shape, generator=gen),
                     lm.init_cache(n_pages, page, dtype=torch.float32,
                                   device="cpu"))
    bt = torch.randperm(n_pages, generator=gen)[:4 * max_pages].reshape(
        4, max_pages).to(torch.int32)
    tok_seq = torch.tensor([0] * 6 + [1] * 5 + [2] + [0] * 4,
                           dtype=torch.int32)
    tok_pos = torch.tensor(list(range(20, 26)) + list(range(5)) + [77]
                           + [-1] * 4, dtype=torch.int32)
    tokens16 = torch.randint(0, cfg.vocab_size, (16,), generator=gen,
                             dtype=torch.int32)
    q_last = torch.tensor([5, 10, 11, 0], dtype=torch.int32)
    cuda = lambda t: t.cuda()                                   # noqa: E731
    ids_c, logits_c, pools_c = lm.forward_mixed_paged(
        params, tokens16, tok_seq, tok_pos, q_last, tree_map(torch.clone,
                                                             pools), bt)
    ids_g, logits_g, pools_g = lm.forward_mixed_paged(
        tree_map(cuda, params), cuda(tokens16), cuda(tok_seq),
        cuda(tok_pos), cuda(q_last), tree_map(cuda, pools), cuda(bt))
    torch.cuda.synchronize()
    err = max_err(logits_g.cpu(), logits_c)
    pool_err = max(max_err(pools_g[0]["b0"][k].cpu(), pools_c[0]["b0"][k])
                   for k in ("k", "v"))
    # the appended K/V come from float32 products summed in another order
    # on the card: held to 1e-4 of the pools' largest magnitude
    pool_tol = 1e-4 * max(float(pools_c[0]["b0"][k].abs().max())
                          for k in ("k", "v"))
    log(f"  tiny logits max_abs_err {err:.3g} (tol 1e-3), pools "
        f"{pool_err:.3g} (tol {pool_tol:.3g}); sampled card "
        f"{ids_g.tolist()} cpu {ids_c.tolist()}")
    assert err <= 1e-3 and pool_err <= pool_tol
    assert logits_g.shape == (4, cfg.vocab_size)
    assert bool(torch.isfinite(logits_g).all())

    # the per-call paths: a decode bucket with a padded row (ctx_lens 0),
    # then two chunks bucketed to 8 tokens, one of them 5 real tokens
    # across a page edge
    tokens = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                           dtype=torch.int32)
    ctx_lens = torch.tensor([77, 16, 1, 0], dtype=torch.int32)
    logits_c, pools_c = lm.decode_step_paged(
        params, tokens, ctx_lens, tree_map(torch.clone, pools), bt)
    logits_g, pools_g = lm.decode_step_paged(
        tree_map(cuda, params), cuda(tokens), cuda(ctx_lens),
        tree_map(cuda, pools), cuda(bt))
    torch.cuda.synchronize()
    check_close("decode_step_paged", logits_g[:3], logits_c[:3], pools_g,
                pools_c)
    chunk = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                          dtype=torch.int32)
    start = torch.tensor([29, 0], dtype=torch.int32)
    n_new = torch.tensor([5, 8], dtype=torch.int32)
    index = torch.tensor([4, 7], dtype=torch.int32)
    logits_c, pools_c = lm.extend_step_paged(
        params, chunk, start, n_new, tree_map(torch.clone, pools), bt[:2],
        logits_index=index)
    logits_g, pools_g = lm.extend_step_paged(
        tree_map(cuda, params), cuda(chunk), cuda(start), cuda(n_new),
        tree_map(cuda, pools), cuda(bt[:2]), logits_index=cuda(index))
    torch.cuda.synchronize()
    check_close("extend_step_paged", logits_g, logits_c, pools_g, pools_c)

    # the three calls again over int8 pools: random payload and per-page
    # scales below the new rows' amax / 127, so the appends requantize
    def fill(z):
        if z.dtype == torch.int8:
            return torch.randint(-127, 128, z.shape, generator=gen,
                                 dtype=torch.int8)
        return torch.rand(z.shape, generator=gen) * 0.08 + 0.02
    pools = tree_map(fill, lm.init_cache(n_pages, page, dtype=torch.float32,
                                         device="cpu", kv_dtype="int8"))
    calls = (
        ("forward_mixed_paged int8", lambda f, P: lm.forward_mixed_paged(
            f(params), *map(f, (tokens16, tok_seq, tok_pos, q_last)), P,
            f(bt))[1:]),
        ("decode_step_paged int8", lambda f, P: lm.decode_step_paged(
            f(params), f(tokens), f(ctx_lens), P, f(bt))),
        ("extend_step_paged int8", lambda f, P: lm.extend_step_paged(
            f(params), f(chunk), f(start), f(n_new), P, f(bt[:2]),
            logits_index=f(index))))
    rows = {"decode_step_paged int8": slice(0, 3)}
    for label, call in calls:
        logits_c, pools_c = call(lambda t: t, tree_map(torch.clone, pools))
        logits_g, pools_g = call(lambda t: tree_map(cuda, t),
                                 tree_map(cuda, pools))
        torch.cuda.synchronize()
        keep = rows.get(label, slice(None))
        check_close(label, logits_g[keep], logits_c[keep], pools_g, pools_c)


# ---------------------------------------------------------------------------
# phase 6: the two attention kernels against each other, full width, f32
# ---------------------------------------------------------------------------
def condition_attention(params) -> None:
    """Rescale the attention projections, in place, to a fan-in over
    d_model (the reference's init takes it over the heads, which at full
    width gives attention logits of standard deviation ~128 and a softmax
    that is a hard max). MLA's up-projections take it over their rank
    (``w_uq`` over q_lora, ``w_uk`` and ``w_uv`` over kv_lora), ``wo``
    over the heads' values. Blocks without attention are left as they
    are; zamba2's shared block (``params["shared"]``, not stacked) is
    conditioned once."""
    blocks = [blk for group in params["groups"]
              for blk in group["scan"].values()]   # leaves stacked by layer
    for blk in blocks + ([params["shared"]] if "shared" in params else []):
        attn = blk.get("attn")
        if attn is None:
            continue
        if "w_uq" in attn:
            q_lora, H = attn["w_uq"].shape[-3:-1]
            L = attn["w_uk"].shape[-3]
            attn["w_uq"] *= math.sqrt(H / q_lora)
            attn["w_uk"] *= math.sqrt(H / L)
            attn["w_uv"] *= math.sqrt(H / L)
            attn["wo"] *= 1.0 / math.sqrt(attn["wo"].shape[-2])
            continue
        d, H, hd = attn["wq"].shape[-3:]
        for name in ("wq", "wk", "wv"):
            attn[name] *= math.sqrt(attn[name].shape[-2] / d)
        attn["wo"] *= 1.0 / math.sqrt(hd)


def layer0_exact(lm, params, tokens, positions):
    """Layer 0's K and V, (n, Hkv, hd) each, of ``tokens`` at
    ``positions``, in float64 from the embeddings: RMSNorm, the K and V
    projections (and biases) and the rotation, at the float32 rotation
    angles that every path of the port computes alike; for MLA its latent
    c (n, kv_lora) (the joint projection, then ``kv_norm`` at eps 1e-5)
    and rope key kr (n, rope). A witness for the pools' float32 entries:
    each path's distance from it is its own rounding."""
    import torch
    from repro_torch.models.common import rope_freqs
    cfg = lm.cfg
    a = cfg.groups[0].period[0].attn
    p = params["groups"][0]["scan"]["b0"]
    f64 = torch.float64
    x = lm.embed(params, tokens).to(f64)
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg.norm_eps) \
        * (1.0 + p["norm1"][0].to(f64))

    def rotate(k, hd):
        angles = (positions.float()[:, None] * rope_freqs(
            hd, a.rope_theta, device=x.device)).to(f64)
        cos, sin = angles.cos(), angles.sin()
        if k.dim() == 3:
            cos, sin = cos[:, None], sin[:, None]
        k1, k2 = k.chunk(2, dim=-1)
        return torch.cat([k1 * cos - k2 * sin, k1 * sin + k2 * cos], dim=-1)
    if a.kind == "mla":
        ckr = x @ p["attn"]["w_dkv"][0].to(f64)
        c = ckr[:, :a.kv_lora_rank]
        c = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + 1e-5) \
            * (1.0 + p["attn"]["kv_norm"][0].to(f64))
        return c, rotate(ckr[:, a.kv_lora_rank:], a.qk_rope_head_dim)
    k, v = (torch.einsum("nd,dhe->nhe", x, p["attn"][w][0].to(f64))
            for w in ("wk", "wv"))
    if a.qkv_bias:
        k = k + p["attn"]["bk"][0].to(f64)
        v = v + p["attn"]["bv"][0].to(f64)
    return rotate(k, a.head_dim), v


def paths_parity(dtype, *, conditioned: bool, tiny: bool = False,
                 device: str = "cuda", model: str = "llama3.2-1b",
                 lens=None, periods=None, prefill_cf=None,
                 forward_leg: bool = False, recorder=None) -> dict:
    """The fused and the per-call paths against each other, from the same
    weights of ``model`` (random, seed 0), on four sequences of ``lens``
    tokens (by default 37, 160, 513 and 16):
      prefill — one ragged batch through forward_mixed_paged, and one
                extend_step_paged call per sequence (padded to a bucket,
                as the engine pads a chunk) on a second, zeroed pool;
      decode  — one step on equal copies of the fused prefill's pools, as
                a decode-only ragged batch (ragged_paged_attention) and
                through decode_step_paged (paged_attention), each with a
                padded row;
      gather  — per sequence, extend_step over its prompt on a zeroed
                slotted cache, then one decode_step (plain PyTorch
                attention), against the fused prefill's logits and the
                ragged decode's logits and pools.
    ``conditioned`` rescales the attention projections to a fan-in over
    d_model: the reference's init takes it over the heads, which at full
    width gives attention logits of standard deviation ~128, a softmax
    that is a hard max, and paths that part wherever float32 rounding of
    differently shaped products flips one. Returns each comparison's
    logits error, greedy ids and pool error (all layers, and layer 0,
    whose K/V no attention has touched yet; and layer 0's K/V of each
    prefill leg against ``layer0_exact``), and a control: the fused
    prefill's logits against the same prefill padded to twice the
    rows. Tables longer than 64 pages (a prompt past 1024 tokens) give
    each sequence only the pages its tokens and its decode token fill,
    the rest of its row page 0 (never read), so that the pools stay at
    512 pages; the gather leg's slotted caches hold every position (a
    local layer's window masks, as the engine's gather path has it).
    ``periods`` cuts each group's depth (``cut_config``); ``prefill_cf``
    runs the prefill legs and the gather leg's extend_step with every MoE
    capacity factor at that value, the decode steps at the config's own
    (a decode token is a group of one, which never drops).
    ``forward_leg`` adds a fourth comparison, forward: per sequence,
    ``LM.forward`` over its prompt (the flash kernels), its last
    position's logits against the fused prefill's; ``recorder`` (a
    FlashRecorder) is entered around that leg. A model with codebooks
    (musicgen) takes each id broadcast over its K codebooks, as the
    engine feeds it, and its logits are (.., K, V). The result also
    holds the fused and per-call prefills' and both decodes' logits on
    the host (``outputs``), for holding the kernels against their plain
    versions (``plain_paged``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = torch.device(device)
    cfg = cut_config(get_config(model, tiny=tiny), periods=periods)
    lm = LM(cfg)
    lm_p = lm if prefill_cf is None else LM(
        cut_config(cfg, capacity_factor=prefill_cf))

    def ids(t):
        """Token ids as the model takes them: broadcast over the
        codebooks where it has them."""
        K = cfg.n_codebooks
        return t[..., None].expand(*t.shape, K) if K else t
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(gen, dtype=dtype, device=dev)
    if conditioned:
        condition_attention(params)
    lens = [37, 160, 513, 16] if lens is None else list(lens)
    B = len(lens)
    page, n_pages = 16, 512
    # the per-call leg pads each prompt to a power of two, all of whose
    # positions must lie inside the table
    max_pages = max(64, (1 << (max(lens) - 1).bit_length()) // page)
    pools = lm.init_cache(n_pages, page, dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    if (B + 1) * max_pages <= n_pages - 1:
        bt = perm[:(B + 1) * max_pages].reshape(B + 1, max_pages).to(
            torch.int32)
    else:
        bt = torch.zeros((B + 1, max_pages), **i32)
        used = 0
        for b, n in enumerate(lens):
            need = -(-(n + 1) // page)
            bt[b, :need] = perm[used:used + need].to(torch.int32)
            used += need
    # prefill: every prompt token as one ragged batch, padded to a power
    # of two (1024 by default)
    N = 1 << (sum(lens) - 1).bit_length()
    tok_seq = torch.zeros(N, **i32)
    tok_pos = torch.full((N,), -1, **i32)
    off, q_last = 0, []
    for b, n in enumerate(lens):
        tok_seq[off:off + n] = b
        tok_pos[off:off + n] = torch.arange(n, **i32)
        off += n
        q_last.append(off - 1)
    tokens = torch.randint(0, cfg.vocab_size, (N,), generator=gen, **i32)
    first, logits_f, _ = lm_p.forward_mixed_paged(
        params, ids(tokens), tok_seq, tok_pos,
        torch.tensor(q_last + [0], **i32), pools, bt)
    # control: the fused prefill again, padded to twice the rows — the
    # same path with products of another shape
    pad = dict(dtype=torch.int32, device=dev)
    _, logits_c, _ = lm_p.forward_mixed_paged(
        params, ids(torch.cat([tokens, torch.zeros(N, **pad)])),
        torch.cat([tok_seq, torch.zeros(N, **pad)]),
        torch.cat([tok_pos, torch.full((N,), -1, **pad)]),
        torch.tensor(q_last + [0], **i32),
        lm.init_cache(n_pages, page, dtype=dtype, device=dev), bt)
    pools_u = lm.init_cache(n_pages, page, dtype=dtype, device=dev)
    logits_u = []
    for b, n in enumerate(lens):
        chunk = torch.zeros((1, 1 << (n - 1).bit_length()), **i32)
        chunk[0, :n] = tokens[q_last[b] + 1 - n:q_last[b] + 1]
        lu, _ = lm_p.extend_step_paged(
            params, ids(chunk), torch.zeros(1, **i32),
            torch.tensor([n], **i32),
            pools_u, bt[b:b + 1], logits_index=torch.tensor([n - 1], **i32))
        logits_u.append(lu[0])
    logits_u = torch.stack(logits_u)

    def pool_err(a, b, layers=slice(None)):
        pairs = list(zip(tree_leaves(a), tree_leaves(b)))
        return (max(max_err(x[layers], y[layers]) for x, y in pairs),
                max(float(y[layers].abs().max()) for _, y in pairs))
    prefill_pools = pool_err(pools_u, pools)
    # layer 0's K/V, which no attention has touched yet: the legs against
    # each other and each against a float64 witness, at every prompt token
    def layer0(tree):
        return {k: v[0] for k, v in tree[0]["b0"].items()}
    layer0_pools = pool_err(layer0(pools_u), layer0(pools))
    real = tok_pos >= 0
    pos = tok_pos[real]
    slots = (bt[tok_seq[real].long(), (pos // page).long()].long(),
             (pos % page).long())
    exact = layer0_exact(lm, params, ids(tokens[real]), pos)

    def witness_err(tree):
        return max(float((leaf[slots].double() - want).abs().max())
                   for leaf, want in zip(layer0(tree).values(), exact))
    layer0_witness = (witness_err(pools), witness_err(pools_u),
                      max(float(w.abs().max()) for w in exact))
    del pools_u, exact
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # one decode step, row B padded, on two copies of the pools
    ctx = torch.tensor(lens + [0], **i32)
    feed = torch.cat([first[:B], torch.zeros(1, **i32)])
    pools_r = tree_map(torch.clone, pools)
    _, logits_r, _ = lm.forward_mixed_paged(
        params, ids(feed), torch.arange(B + 1, **i32),
        torch.cat([ctx[:B], torch.full((1,), -1, **i32)]),
        torch.arange(B + 1, **i32), pools_r, bt)
    logits_p, pools_p = lm.decode_step_paged(params, ids(feed),
                                             ctx + (ctx > 0), pools, bt)
    # the gather leg: per sequence, extend_step then one decode_step on a
    # slotted cache of the block table's width
    S = max_pages * page
    gather_logits, gather_cache = [], (0.0, 0.0)
    for b, n in enumerate(lens):
        cache = lm.init_cache(1, S, dtype=dtype, device=dev,
                              window_override=None)
        lg, cache = lm_p.extend_step(
            params, ids(tokens[None, q_last[b] + 1 - n:q_last[b] + 1]),
            torch.zeros(1, **i32), cache)
        gather_logits.append(lg[0])
        lg, cache = lm.decode_step(params, ids(feed[b:b + 1]),
                                   torch.tensor([n], **i32), cache)
        gather_logits.append(lg[0])
        for got, pool in zip(tree_leaves(cache), tree_leaves(pools_r)):
            want = pool[:, bt[b].long()].reshape(got.shape)
            gather_cache = (max(gather_cache[0], max_err(
                got[:, :, :n + 1], want[:, :, :n + 1])), max(
                gather_cache[1], float(want[:, :, :n + 1].abs().max())))
    gather_logits = torch.stack(gather_logits)
    forward_logits = None
    if forward_leg:
        with recorder or contextlib.nullcontext():
            forward_logits = torch.stack([lm.logits(params, lm_p.forward(
                params, ids(tokens[None, q_last[b] + 1 - n:q_last[b] + 1])
            ).hidden[0, -1]) for b, n in enumerate(lens)])
    paired = torch.stack([x for b in range(B)
                          for x in (logits_f[b], logits_r[b])])
    top2 = torch.topk(logits_f[:B].float(), 2).values
    res = {"model": cfg.name, "lens": lens,
           "prefill_err": max_err(logits_u, logits_f[:B]),
           "control_err": max_err(logits_c[:B], logits_f[:B]),
           "prefill_ids": (logits_u.argmax(-1).tolist(),
                           logits_f[:B].argmax(-1).tolist()),
           "prefill_pools": prefill_pools, "layer0_pools": layer0_pools,
           "layer0_witness": layer0_witness,
           "top2_gap": (top2[..., 0] - top2[..., 1]).reshape(-1).tolist(),
           "decode_err": max_err(logits_p[:B], logits_r[:B]),
           "decode_ids": (logits_p[:B].argmax(-1).tolist(),
                          logits_r[:B].argmax(-1).tolist()),
           "decode_pools": pool_err(pools_p, pools_r),
           "gather_err": max_err(gather_logits, paired),
           "gather_ids": (gather_logits.argmax(-1).tolist(),
                          paired.argmax(-1).tolist()),
           "gather_cache": gather_cache,
           "finite": bool(torch.isfinite(logits_p[:B]).all()
                          and torch.isfinite(logits_u).all()
                          and torch.isfinite(gather_logits).all()),
           "outputs": {"fused": logits_f[:B].cpu(), "per_call":
                       logits_u.cpu(), "ragged_decode": logits_r[:B].cpu(),
                       "paged_decode": logits_p[:B].cpu()}}
    if forward_logits is not None:
        res["forward_err"] = max_err(forward_logits, logits_f[:B])
        res["forward_ids"] = (forward_logits.argmax(-1).tolist(),
                              logits_f[:B].argmax(-1).tolist())
        res["finite"] &= bool(torch.isfinite(forward_logits).all())
    del params, pools, pools_r, pools_p, cache
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def check_decode_parity(*, tiny: bool = False, device: str = "cuda",
                        model: str = "llama3.2-1b", lens=None, periods=None,
                        prefill_cf=None, forward_leg: bool = False,
                        recorder=None) -> None:
    """paths_parity three times, on ``model`` (llama3.2-1b by default; the
    wide_parity phase runs gemma2-9b and GPT-J-6B) over ``lens``. Held, in
    float32 with conditioned weights: logits within 1e-3 (the paths sum in
    other orders), greedy ids equal on every real row, pools within 1e-4
    (prefill: products of other shapes) and 1e-5 (decode: the two
    kernels) of their largest magnitude. With the reference's init, in
    float32 and in bf16, the prefill comparison is reported, not held: it
    shows how far rounding alone parts the paths at a hard-max softmax,
    which the serve runs' shares of identical streams reflect; layer 0's
    K/V and the decode kernels (as above) are held in float32 there too.
    Layer 0's K/V are held two ways, each within 1e-5 of their largest
    magnitude: the legs against each other, and each leg against the
    float64 witness (``layer0_exact``), which shows that what parts them
    is their own float32 rounding. The smoke run uses the defaults;
    ``tiny`` and ``device="cpu"`` rehearse it on the plain versions;
    ``periods`` and ``prefill_cf`` go to paths_parity (the moe_parity
    phase), and so do ``forward_leg`` (the mla_parity phase: LM.forward
    held as the prefill is) and ``recorder``, which records the bf16
    run's forward leg."""
    import torch
    for dtype, conditioned in ((torch.float32, True),
                               (torch.float32, False),
                               (torch.bfloat16, False)):
        r = paths_parity(dtype, conditioned=conditioned, tiny=tiny,
                         device=device, model=model, lens=lens,
                         periods=periods, prefill_cf=prefill_cf,
                         forward_leg=forward_leg,
                         recorder=recorder if dtype == torch.bfloat16
                         else None)
        name = (f"{r['model']} {str(dtype)[6:]}, "
                f"{'conditioned' if conditioned else 'reference'} init")
        (pe, pt), (le, lt), (de, dt) = (r["prefill_pools"], r["layer0_pools"],
                                        r["decode_pools"])
        log(f"  {name}, contexts {r['lens']}: prefill extend vs mixed "
            f"logits max_abs_err {r['prefill_err']:.3g}, greedy ids "
            f"{r['prefill_ids'][0]} vs {r['prefill_ids'][1]}, pools "
            f"{pe:.3g} of max {pt:.3g} (layer 0: {le:.3g} of {lt:.3g}); "
            f"control, mixed padded to 2x rows vs mixed: logits "
            f"{r['control_err']:.3g}; top-2 logit gaps "
            f"{[round(g, 4) for g in r['top2_gap']]}")
        log(f"  {name}: decode paged vs ragged logits max_abs_err "
            f"{r['decode_err']:.3g}, greedy ids {r['decode_ids'][0]} vs "
            f"{r['decode_ids'][1]}, pools {de:.3g} of max {dt:.3g}")
        (ge, gt) = r["gather_cache"]
        log(f"  {name}: gather extend + decode vs fused prefill + ragged "
            f"decode logits max_abs_err {r['gather_err']:.3g}, greedy ids "
            f"{r['gather_ids'][0]} vs {r['gather_ids'][1]}, cache {ge:.3g} "
            f"of max {gt:.3g}")
        if forward_leg:
            log(f"  {name}: LM.forward (flash) vs fused prefill logits "
                f"max_abs_err {r['forward_err']:.3g}, greedy ids "
                f"{r['forward_ids'][0]} vs {r['forward_ids'][1]}")
        wf, wu, wt = r["layer0_witness"]
        log(f"  {name}: layer 0's K/V against the float64 witness: fused "
            f"{wf:.3g}, per-call {wu:.3g} of max {wt:.3g} (relative "
            f"{wf / wt:.3g}, {wu / wt:.3g}; the legs' gap {le / lt:.3g})")
        assert r["finite"], name
        if dtype != torch.float32:
            continue
        assert le <= 1e-5 * lt, (name, le / lt)
        assert max(wf, wu) <= 1e-5 * wt, (name, wf / wt, wu / wt)
        assert r["decode_err"] <= 1e-3 and de <= 1e-5 * dt, name
        assert r["decode_ids"][0] == r["decode_ids"][1], name
        if conditioned:
            assert r["prefill_err"] <= 1e-3 and pe <= 1e-4 * pt, name
            assert r["prefill_ids"][0] == r["prefill_ids"][1], name
            assert r["gather_err"] <= 1e-3 and ge <= 1e-4 * gt, name
            assert r["gather_ids"][0] == r["gather_ids"][1], name
            if forward_leg:
                assert r["forward_err"] <= 1e-3, name
                assert r["forward_ids"][0] == r["forward_ids"][1], name
        log(f"  {name}: held (logits 1e-3 and equal ids"
            f"{', prefill and gather too' if conditioned else ' for decode'}"
            "; layer-0 pools 1e-5 apart and of the witness, decode pools "
            "1e-5"
            f"{', prefill pools and gather cache 1e-4' if conditioned else ''}"
            " of max)")


# ---------------------------------------------------------------------------
# phases 8-13: full-width serve through the session API
# ---------------------------------------------------------------------------
class Recorder:
    """Keeps the inputs of each kernel's largest call on the main path,
    for the timing phase: wraps the ops that the model and the stager
    call, and adds nothing to the launch counts. Small inputs (routing,
    rows, q, scales) are copied on the device at the call; the pools,
    which the run keeps alive anyway, are kept by reference, so they
    carry their contents at the end of the run. On leaving, the run's
    records move to host memory, outside the run's timed region, so the
    records add no device memory to a serve run's
    ``max_memory_allocated``. An attention or swap call over quantized
    pools is kept under its own key (``..._int8``); a swap's call is the
    stager's tree call (leaves, ids, byte slab); the quantized append's
    inputs are kept as ``kv_append_quant``, from which the timing phase
    rebuilds the page_requant call."""

    COPY_BYTES = 8 << 20       # inputs up to this size are copied at once
    RAGGED = ("ragged_paged_attention", "ragged_paged_attention_int8")
    # the ops whose calls are also kept by size (their first argument's
    # rows for the ragged op, the rows appended for the appends)
    SIZED = RAGGED + ("kv_append", "kv_append_quant")

    def __init__(self):
        import repro_torch.kernels.ops as ops
        import repro_torch.models.attention as attention
        self.calls = {}
        # the ragged op's and the appends' calls by N (q's rows or the
        # rows appended, known without a sync): {key: {N: calls}} and the
        # last call of each N; and the bf16 decode-only ragged calls (no
        # more rows than block-table rows): their count and the last of
        # the largest, the timing phase's "ragged_paged_attention_decode".
        # The last call of a size is the latest in the run, so its
        # contexts are among the run's longest; it is kept by reference
        # (the engine uploads fresh routing and rows every step and writes
        # no q after the call; the pools it holds are the run's), so
        # keeping it costs the serve no copy
        self.by_size = {k: {} for k in self.SIZED}
        self.size_calls = {k: {} for k in self.SIZED}
        self.decode_launches = 0
        self.decode_call = (-1, None, None)
        # (module, op name, kernel, index of the argument whose leading
        # size ranks the calls, whether a later call of the same
        # size; paged_attention keeps the last of its largest-batch calls,
        # the deepest contexts at that batch, ranked without a host sync)
        self._ops = [
            (attention, "ragged_paged_attention_op",
             "ragged_paged_attention", 0, False),
            (attention, "paged_attention_op", "paged_attention", 0, True),
            (attention, "kv_append_op", "kv_append", 2, False),
            (attention, "kv_append_quant_op", "kv_append_quant", 4, False),
            (ops, "swap_pack_tree_op", "swap_pack", 1, False),
            (ops, "swap_unpack_tree_op", "swap_unpack", 2, False)]
        self._orig = {}

    def __enter__(self):
        for mod, name, key, size_arg, later in self._ops:
            orig = self._orig[(mod, name)] = getattr(mod, name)

            def wrapped(*args, _orig=orig, _key=key, _size=size_arg,
                        _later=later, **kw):
                if kw.get("k_scale") is not None or (
                        _key.startswith("swap") and any(
                            leaf.element_size() == 1 for leaf in args[0])):
                    _key += "_int8"
                size = args[_size].shape[0]
                if _key in self.SIZED:
                    self._sized(_key, size, args, kw)
                best = self.calls.get(_key, (-1,))[0]
                if size > best or (_later and size == best):
                    self.calls[_key] = (size, self._keep(args),
                                        self._keep(kw))
                return _orig(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def _sized(self, key, n, args, kw):
        counts = self.by_size[key]
        counts[n] = counts.get(n, 0) + 1
        self.size_calls[key][n] = (args, dict(kw))
        if key == "ragged_paged_attention" and n <= args[3].shape[0]:
            self.decode_launches += 1
            if n >= self.decode_call[0]:
                self.decode_call = (n, args, dict(kw))

    def _keep(self, tree):
        from repro_torch.utils.tree import tree_map
        return tree_map(
            lambda t: t.clone() if hasattr(t, "clone") and t.numel()
            * t.element_size() <= self.COPY_BYTES else t, tree)

    def __exit__(self, *exc):
        from repro_torch.utils.tree import tree_map
        for (mod, name), orig in self._orig.items():
            setattr(mod, name, orig)
        # one host copy of each tensor however many records hold it: the
        # last call of every size is mostly the last layer's, so its pools
        # are one pair (at head_dim 256 a layer's pool is 134 MB)
        copies = {}

        def host(t):
            key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
            if key not in copies:
                copies[key] = t.to("cpu")
            return copies[key]

        def to_host(tree):
            return tree_map(lambda t: host(t) if hasattr(t, "to") and
                            t.is_cuda else t, tree)
        for key, (size, args, kw) in self.calls.items():
            self.calls[key] = (size, *to_host((args, kw)))
        self.decode_call = (self.decode_call[0],
                            *to_host(self.decode_call[1:]))
        for calls in self.size_calls.values():
            for n, rec in calls.items():
                calls[n] = to_host(rec)

    def call(self, key: str, device="cuda", size=None):
        """The recorded (args, kw) of ``key``'s largest call (or, for a
        key in ``SIZED``, of its last call of ``size`` rows), on
        ``device``."""
        from repro_torch.utils.tree import tree_map
        if key == "ragged_paged_attention_decode":
            rec = self.decode_call[1:]
        elif size is None:
            rec = self.calls[key][1:]
        else:
            rec = self.size_calls[key][size]
        return tree_map(lambda t: t.to(device) if hasattr(t, "to") else t,
                        rec)


def kernel_wrappers() -> dict:
    """Each kernel's launching wrapper, which carries its launch count."""
    from repro_torch.kernels import (kv_append, kv_quant, paged_attention,
                                     ragged_paged_attention)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gla_scan as gs
    from repro_torch.kernels import mla_attention as ma
    from repro_torch.kernels import moe_experts as me
    from repro_torch.kernels import swap_pack as sp
    return {"flash_attention": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "gla_scan": gs.gla_scan_fwd, "gla_scan_bwd": gs.gla_scan_bwd,
            "ragged_paged_attention":
            ragged_paged_attention.ragged_paged_attention,
            "paged_attention": paged_attention.paged_attention,
            "kv_append": kv_append.kv_append,
            "kv_append_quant": kv_quant.kv_append_quant,
            "swap_pack": sp.swap_pack, "swap_unpack": sp.swap_unpack,
            "page_requant": kv_quant.page_requant,
            "moe_experts": me.moe_experts,
            "mla_attention": ma.ragged_latent_attention}


def kernel_counters() -> dict:
    """Each launch count: a wrapper and the attribute that carries it (the
    latent-attention wrapper counts all its launches and, apart, its
    tensor-core form's; the flash wrappers all theirs and, apart, their
    float32 ones)."""
    counters = {k: (fn, "launches") for k, fn in kernel_wrappers().items()}
    counters["mla_attention_tc"] = (counters["mla_attention"][0],
                                    "tc_launches")
    for k in ("flash_attention", "flash_attention_bwd"):
        counters[f"{k}_f32"] = (counters[k][0], "f32_launches")
    return counters


def launch_counts() -> dict:
    return {k: getattr(fn, a) for k, (fn, a) in kernel_counters().items()}


def reset_counts() -> None:
    for fn, a in kernel_counters().values():
        setattr(fn, a, 0)


def agent_engine(policy: str, *, tiny: bool, device: str,
                 closed_loop: bool = False, sampled: bool = False,
                 model: str = "llama3.2-1b", periods=None, **engine_kw):
    """A fresh engine (``model``, llama3.2-1b by default, each group cut to
    ``periods`` where given, random weights from seed 0) with the
    agent workload submitted through a ScriptedClient, or straight to the
    engine with ``closed_loop``. ``engine_kw`` selects the path
    (``fused=False``, ``kv_dtype="int8"``, or ``speculate=True``, which
    gets the oracle tool-result predictor); ``sampled`` samples request i
    at temperature 0.7, top-k 50, top-p 0.9 with seed 1000 + i, else
    every request is greedy. Returns (engine, client or None, handles or
    requests)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import POLICIES
    from repro_torch.serving.api_executor import OracleToolResultPredictor
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.session import ScriptedClient
    from repro_torch.serving.workloads import make_agent_workload
    cfg = cut_config(get_config(model, tiny=tiny), periods=periods)
    if engine_kw.get("speculate"):
        engine_kw["predictor"] = OracleToolResultPredictor(cfg.vocab_size)
    on_card = device == "cuda"
    reqs = make_agent_workload(
        seed=0, n_sessions=8, rate_rps=4.0, vocab=cfg.vocab_size,
        n_templates=2, system_prompt_len=160, turns=(1, 2), turn_gap_s=5.0,
        hist_per_turn=96, gen_tokens=(24, 8), final_gen=(32, 8),
        max_tool_calls=2, max_ctx=1024)
    if sampled:
        from repro_torch.core.request import SamplingParams
        for i, r in enumerate(reqs):
            r.sampling = SamplingParams(temperature=0.7, top_k=50, top_p=0.9,
                                        seed=1000 + i)
    gc.collect()                  # the previous run's engine, if any
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, POLICIES[policy], page_size=16, n_pages=2048,
                 max_model_len=1024, seed=0, device=device,
                 dtype=torch.bfloat16 if on_card else torch.float32,
                 **engine_kw)
    if closed_loop:
        for r in reqs:
            eng.add_request(r)
        return eng, None, reqs
    client = ScriptedClient(eng)
    handles = client.submit(reqs)
    return eng, client.client, handles


def serve(policy: str, recorder: Recorder = None, *, tiny: bool = False,
          device: str = "cuda", model: str = "llama3.2-1b",
          **engine_kw) -> dict:
    """Serve agent sessions through ScriptedClient (or the closed loop,
    ``closed_loop=True`` among ``engine_kw``) and check the run. The
    smoke run uses the defaults; ``tiny`` and ``device="cpu"`` rehearse
    the same control flow without a card. ``recorder`` keeps the kernels'
    calls for the timing phase (None: a run that nothing times)."""
    import torch
    from repro_torch.utils.tree import tree_leaves
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    eng, client, handles = agent_engine(policy, tiny=tiny, device=device,
                                        model=model, **engine_kw)
    cfg = eng.cfg
    sync()
    # the engine's construction (weights made in float32, then cast) sets
    # its own peak; the run's peak is taken apart from it
    init_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        if client is None:
            done = eng.run(strict=True)
            drained, finished = done.drained, len(done)
        else:
            batch = client.poll(strict=True)
            drained, finished = batch.drained, sum(h.finished
                                                   for h in handles)
        sync()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    st = eng.sched.stats
    reqs = [getattr(h, "request", h) for h in handles]
    out_tokens = sum(r.output_tokens for r in reqs)
    streams = [eng.generated_text(r) for r in reqs]
    res = {"model": cfg.name, "policy": policy, "finished": finished,
           "requests": len(handles), "steps": eng.counters[
               "mixed_iterations"], "output_tokens": out_tokens,
           "wall_s": wall, "tokens_per_s": out_tokens / wall,
           "step_ms": 1e3 * wall / max(1, eng.counters[
               "mixed_iterations"]),
           "max_memory_allocated": max(
               init_peak, torch.cuda.max_memory_allocated())
           if on_card else None,
           "run_peak_bytes":
               torch.cuda.max_memory_allocated() if on_card else None,
           "init_peak_bytes": init_peak if on_card else None,
           "swapped_out_tokens": st.swapped_out_tokens,
           "swapped_in_tokens": st.swapped_in_tokens,
           "decisions": {k: getattr(st, k) for k in (
               "preserves", "discards", "swaps", "recompute_tokens")},
           "ledger_causes": dict(eng.ledger.causes),
           "free_pages": eng.blocks.num_free, "n_pages": eng.blocks.n_pages,
           "fused": eng.fused, "paged": eng.paged,
           "speculate": eng.speculate, "sanitize": eng.sanitize,
           "findings": [str(f) for f in eng.sanitizer.findings]
           if eng.sanitizer is not None else None,
           "kv_dtype": eng.kv_dtype, "kv_token_bytes": eng.kv_token_bytes,
           "kv_pool_bytes": sum(t.numel() * t.element_size()
                                for t in tree_leaves(eng.pools)),
           "stale_scale_pages": eng._stale_scale_pages(),
           "stager": {k: getattr(eng.stager, k) for k in (
               "packs", "unpacks", "packed_pages", "collected_pages",
               "unpacked_pages")},
           "spec": {k: eng.counters[k] for k in (
               "spec_forks", "spec_accepted", "spec_rejected",
               "spec_killed", "spec_grafted_tokens")},
           "launches": counts}
    log(f"  {json.dumps(res)}")
    res["streams"] = streams
    res["counters"] = dict(eng.counters)
    assert drained and res["finished"] == res["requests"], res
    assert all(0 <= t < cfg.vocab_size for s in streams for t in s)
    assert res["findings"] in (None, []), res["findings"]
    if on_card:
        # an MLA model's attention runs the latent kernel on every paged
        # path, and never the GQA attention kernels
        mla = any(b.attn is not None and b.attn.kind == "mla"
                  for b in cfg.blocks)
        if not eng.paged:
            # the gather oracle: slotted caches in plain PyTorch, no paged
            # attention and no append kernel
            assert counts["ragged_paged_attention"] == counts[
                "paged_attention"] == counts["kv_append"] == counts[
                "kv_append_quant"] == counts["mla_attention"] == 0, counts
        elif mla:
            assert counts["mla_attention"] > 0 and counts[
                "ragged_paged_attention"] == counts["paged_attention"] == 0, \
                counts
            # bf16 latent pools at deepseek-v3's widths: the tensor-core
            # form alone
            a = next(b.attn for b in cfg.blocks if b.attn is not None)
            tc = (a.kv_lora_rank, a.qk_rope_head_dim) == (512, 64) \
                and tree_leaves(eng.pools)[0].dtype == torch.bfloat16
            assert counts["mla_attention_tc"] == (
                counts["mla_attention"] if tc else 0), counts
        elif eng.fused:
            assert counts["ragged_paged_attention"] > 0
        else:
            assert counts["ragged_paged_attention"] == 0 \
                and counts["paged_attention"] > 0, counts
        if eng.speculate and not mla:
            assert counts["paged_attention"] > 0, counts
        # float pools launch kv_append and never the fused quantized
        # append; quantized pools launch the fused kernel on every append
        # and neither kv_append nor page_requant
        if eng.paged and eng.kv_dtype is None:
            assert counts["kv_append"] > 0 \
                and counts["kv_append_quant"] == 0, counts
        elif eng.paged:
            assert counts["kv_append_quant"] > 0 and counts["kv_append"] \
                == counts["page_requant"] == 0, counts
        # an MoE model's FFNs launch the MoE kernels, others never
        assert (counts["moe_experts"] > 0) == any(
            b.ffn is not None and b.ffn.kind == "moe"
            for b in cfg.blocks), counts
        # one pack and one unpack launch per swap, whatever the leaf count
        assert (counts["swap_pack"], counts["swap_unpack"]) == (
            res["stager"]["packs"], res["stager"]["unpacks"]), res["stager"]
    assert res["stager"]["packed_pages"] == res["stager"][
        "collected_pages"], res["stager"]
    assert eng.blocks.num_free == eng.blocks.n_pages - 1, "leaked pages"
    assert res["stale_scale_pages"] == [], "freed pages kept their scales"
    eng.close()
    return res


# ---------------------------------------------------------------------------
# phase 18: the sampled serve (threefry-exact Gumbel-max, top-k, nucleus)
# ---------------------------------------------------------------------------
class SamplerProbe:
    """Brackets every ``sample_tokens`` call of the fused dispatch (the
    module global that ``LM.forward_mixed_paged`` calls) with the host
    clock and, on the card, CUDA events; keeps the inputs and the ids of
    the first two calls and of the first call of each larger batch as
    device clones (no sync). On leaving, reads the events and moves the
    kept calls to the host, the first two and the largest batch's."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.host_ms, self.device_ms, self.kept = [], [], []
        self._events, self._largest, self._rows = [], None, 0

    def __enter__(self):
        import torch
        import repro_torch.models.model as model
        self._model, self._orig = model, model.sample_tokens

        def wrapped(*args):
            t0 = time.perf_counter()
            if self.on_card:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = self._orig(*args)
            if self.on_card:
                ev[1].record()
                self._events.append(ev)
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
            rows = args[0].shape[0]
            if len(self.kept) < 2 or rows > self._rows:
                call = tuple(t.clone() for t in (*args, out))
                if len(self.kept) < 2:
                    self.kept.append(call)
                else:
                    self._largest = call
                self._rows = max(self._rows, rows)
            return out
        model.sample_tokens = wrapped
        return self

    def __exit__(self, *exc):
        import torch
        self._model.sample_tokens = self._orig
        if self.on_card:
            torch.cuda.synchronize()
        self.device_ms = [a.elapsed_time(b) for a, b in self._events]
        if self._largest is not None:
            self.kept.append(self._largest)
        self.kept = [tuple(t.cpu() for t in call) for call in self.kept]


def chi_square_p(counts, probs) -> float:
    """The chi-square test's p-value of ``counts`` against ``probs``."""
    import torch
    want = probs.double() * counts.sum()
    stat = ((counts.double() - want) ** 2 / want).sum()
    df = torch.tensor(float(len(counts) - 1), dtype=torch.float64)
    return float(torch.special.gammaincc(df / 2, stat / 2))


def check_sampler(kept, device: str = "cuda") -> list:
    """The kept ``sample_tokens`` calls of a run on ``device``, against the
    plain ops on the CPU over the same logits: threefry words equal on
    every (row, vocab) entry, Gumbel noise within 1e-6 + 1e-6 relative,
    ids equal but where the top-two margin of the perturbed scores on
    ``device`` is below 1e-5 (every such row is reported), and two calls
    on ``device`` give the same ids. Returns the near-tie rows."""
    import torch
    from repro_torch.models.model import perturbed_scores, sample_tokens
    from repro_torch.utils import threefry
    ties = []
    for i, (*args, ids) in enumerate(kept):
        flat, temps, _, _, seeds, pos = args
        V = flat.shape[1]
        dev_args = [t.to(device) for t in args]
        key_c = threefry.fold_in(threefry.prng_key(seeds), pos)
        key_d = threefry.fold_in(threefry.prng_key(dev_args[4]),
                                 dev_args[5])
        bits_c = threefry.random_bits(key_c, V)
        assert torch.equal(threefry.random_bits(key_d, V).cpu(), bits_c), i
        g_c = threefry.gumbel(key_c, V)
        g_diff = (threefry.gumbel(key_d, V).cpu() - g_c).abs()
        g_err = float(g_diff.max())
        assert bool((g_diff <= 1e-6 + 1e-6 * g_c.abs()).all()), (i, g_err)
        want = sample_tokens(*args)
        again = sample_tokens(*dev_args).cpu()
        assert torch.equal(again, ids) and torch.equal(
            sample_tokens(*dev_args).cpu(), again), i
        scores = perturbed_scores(*dev_args)[0].cpu()
        for b in torch.nonzero(ids != want).flatten().tolist():
            top2 = torch.topk(scores[b], 2).values
            margin = float(top2[0] - top2[1])
            ties.append({"call": i, "row": b, "card": int(ids[b]),
                         "cpu": int(want[b]), "margin": margin})
            assert temps[b] > 0 and margin < 1e-5, ties[-1]
        log(f"  sampler call {i}: B {flat.shape[0]} V {V}, threefry words "
            f"equal on {bits_c.numel()} entries, gumbel max_abs_err {g_err}"
            f" (tol 1e-6 + 1e-6 rel), ids equal to the CPU's on "
            f"{int((ids == want).sum())} of {len(ids)} rows")
    log(f"  near-ties (ids parted, margin < 1e-5): {json.dumps(ties)}")
    return ties


def check_sample_draws(device: str = "cuda", n: int = 65536,
                       V: int = 32) -> float:
    """One sample_tokens call of n rows over one fixed V row (temperature
    1, no filter, positions 0..n-1): the draws' chi-square against the
    softmax must pass at p > 1e-3. Returns p."""
    import torch
    from repro_torch.models.model import sample_tokens
    row = torch.randn(V, generator=torch.Generator().manual_seed(3))
    ids = sample_tokens(
        row.to(device).expand(n, V), torch.ones(n, device=device),
        torch.zeros(n, dtype=torch.int32, device=device),
        torch.ones(n, device=device),
        torch.full((n,), 5, dtype=torch.int32, device=device),
        torch.arange(n, dtype=torch.int32, device=device))
    p = chi_square_p(torch.bincount(ids.long().cpu(), minlength=V),
                     torch.softmax(row, 0))
    log(f"  chi-square of {n} draws over V {V} against softmax: p {p:.4g} "
        "(must exceed 1e-3)")
    assert p > 1e-3, p
    return p


def check_sample_phase(res: dict, probe: SamplerProbe, greedy,
                       device: str = "cuda") -> None:
    """The sample phase's checks beyond serve()'s: the sampler's cost per
    fused step, tok/s beside serve's, streams apart from the greedy ones,
    the kept calls against the CPU and the draws' distribution."""
    import statistics
    n = len(probe.host_ms)
    assert n == res["steps"], (n, res["steps"])
    # host: the call's issue time; stream: CUDA events recorded around the
    # call, so it includes any wait of the stream for the host's launches
    for clock, ms in (("host", probe.host_ms), ("stream", probe.device_ms)):
        if ms:
            log(f"  sampler {clock} ms per fused step over {len(ms)} steps: "
                f"median {statistics.median(ms)}, mean "
                f"{statistics.fmean(ms)}, max {max(ms)}")
    launches = res["launches"]
    if device == "cuda":
        assert launches["ragged_paged_attention"] > 0 and \
            launches["kv_append"] > 0, launches
    if greedy is not None:
        apart = sum(a != b for a, b in zip(res["streams"],
                                           greedy["streams"]))
        log(f"  {res['tokens_per_s']} tok/s, "
            f"{res['tokens_per_s'] / greedy['tokens_per_s']}x serve's "
            f"{greedy['tokens_per_s']}; {apart} of {len(res['streams'])} "
            f"streams differ from serve's greedy ones")
        assert apart >= 10, apart
    check_sampler(probe.kept, device)
    check_sample_draws(device)
    if device == "cuda":
        # the sampler alone at the run's largest call: launched from the
        # host in a loop, and its device time by CUDA graph replays
        from repro_torch.models.model import sample_tokens
        args = [t.cuda() for t in probe.kept[-1][:-1]]
        log(f"  sampler at B {args[0].shape[0]} V {args[0].shape[1]}: "
            f"host-launched {cuda_ms(lambda: sample_tokens(*args), 50)} "
            f"ms, device {graph_ms(lambda: sample_tokens(*args), 20)} ms")


def tiny_sampled_streams(params, device: str, fused: bool) -> tuple:
    """Two sampled sessions on the tiny config in float32 (top-k 6 and
    top-p 0.3, a detector intercepts each at its 5th token and a
    virtual-time tool returns 5 ids): (streams, launch counts)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import POLICIES
    from repro_torch.core.request import InterceptDirective, SamplingParams
    from repro_torch.serving.api_executor import VirtualTimeToolExecutor
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.session import InferCeptClient
    cfg = get_config("llama3.2-1b", tiny=True)
    eng = Engine(cfg, POLICIES["infercept"], page_size=16, n_pages=96,
                 max_model_len=256, params=params, device=device,
                 dtype=torch.float32, fused=fused)
    cl = InferCeptClient(eng)
    tool = VirtualTimeToolExecutor(cfg.vocab_size, n_tokens=5, duration=0.3)

    def det(req, tid, now):
        if req.output_tokens == 5 and req.seg_idx == 0:
            return InterceptDirective("qa", 0.3, reason="detector")
        return None

    reset_counts()
    hs = [cl.submit(list(range(r, r + 20)), sp, detector=det,
                    max_new_tokens=14, tools=tool)
          for r, sp in enumerate((
              SamplingParams(temperature=0.8, top_k=6, seed=11),
              SamplingParams(temperature=0.8, top_p=0.3, seed=12)))]
    cl.poll()
    assert all(h.finished for h in hs)
    assert eng.blocks.num_free == eng.blocks.n_pages - 1
    counts = launch_counts()
    eng.close()
    return [cl.token_ids(h) for h in hs], counts


def check_tiny_sampled(device: str = "cuda") -> None:
    """The tiny config's sampled sessions, fused and unfused: the card's
    kernels give the CPU's plain versions' streams, and fused equals
    unfused on each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    params = LM(get_config("llama3.2-1b", tiny=True)).init(
        torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    runs = {}
    for fused in (True, False):
        for dev in ("cpu", device):
            runs[(dev, fused)] = tiny_sampled_streams(params, dev, fused)
    for fused in (True, False):
        streams, counts = runs[(device, fused)]
        assert streams == runs[("cpu", fused)][0], fused
        assert streams == runs[(device, True)][0], fused
        if device == "cuda":
            kernel = "ragged_paged_attention" if fused else "paged_attention"
            assert counts[kernel] > 0, counts
    log(f"  tiny sampled streams equal, card and CPU, fused and unfused: "
        f"{sum(len(s) for s in runs[(device, True)][0])} ids")


# ---------------------------------------------------------------------------
# phase 15: timing on the main path's inputs
# ---------------------------------------------------------------------------
def parent_kernels(parent: Path):
    """The kernel wrappers of another checkout of the port at ``parent``
    (the parent commit's, for timing both versions in one run): ragged and
    paged attention, kv_append, page_requant, the whole quantized append,
    gla_scan's launcher, the flash forward and backward, the tree swap_pack /
    swap_unpack, the SwapStager and the ragged latent attention. Its
    ``repro_torch`` modules are imported from its own
    source tree, so its kernels build there by its own ``_build.py`` and
    are called through its own wrappers, whatever their C signatures
    (``build`` builds them). This tree's modules are put back afterwards;
    the parent's launch counts are its own. Its stager imports its ops
    module when called: run it inside ``with parent.own_ops():``."""
    import contextlib
    import importlib
    import types

    def ours():
        return {k: m for k, m in sys.modules.items()
                if k == "repro_torch" or k.startswith("repro_torch.")}
    saved = ours()
    for k in saved:
        del sys.modules[k]
    src = str(parent / "src")
    sys.path.insert(0, src)
    try:
        rpa = importlib.import_module(
            "repro_torch.kernels.ragged_paged_attention")
        pa = importlib.import_module("repro_torch.kernels.paged_attention")
        ka = importlib.import_module("repro_torch.kernels.kv_append")
        kq = importlib.import_module("repro_torch.kernels.kv_quant")
        gs = importlib.import_module("repro_torch.kernels.gla_scan")
        fa = importlib.import_module("repro_torch.kernels.flash_attention")
        sp = importlib.import_module("repro_torch.kernels.swap_pack")
        ma = importlib.import_module("repro_torch.kernels.mla_attention")
        ops = importlib.import_module("repro_torch.kernels.ops")
    finally:
        sys.path.remove(src)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)

    @contextlib.contextmanager
    def own_ops():
        key = "repro_torch.kernels.ops"
        mine = sys.modules.get(key)
        sys.modules[key] = ops
        try:
            yield
        finally:
            if mine is None:
                del sys.modules[key]
            else:
                sys.modules[key] = mine
    return types.SimpleNamespace(ragged=rpa.ragged_paged_attention,
                                 paged=pa.paged_attention,
                                 kv_append=ka.kv_append,
                                 page_requant=kq.page_requant,
                                 kv_append_quant=kq.kv_append_quant,
                                 gla_scan=gs.gla_scan_fwd,
                                 flash=fa.flash_attention_fwd,
                                 flash_bwd=fa.flash_attention_bwd,
                                 swap_pack_tree=sp.swap_pack_tree,
                                 swap_unpack_tree=sp.swap_unpack_tree,
                                 SwapStager=sp.SwapStager,
                                 mla=ma.ragged_latent_attention,
                                 own_ops=own_ops,
                                 build=rpa._build.lib)


def append_quant_work(kp, ks, kn, page_ids, offs, valid):
    """(bytes, operations) of a quantized append from its data: the
    live rows (valid, id in range) read in their dtype; in both pools
    each touched page's payload written once and read where no row
    overwrites it (the new rows land inside the written pages), its
    scales read and written; the int32 routing read once. Operations:
    a multiply per requantized element, an amax and a divide per row
    element."""
    n_pages, page = kp.shape[:2]
    live = (valid != 0) & (page_ids >= 0) & (page_ids < n_pages)
    n_live = int(live.sum())
    touched = len(set(page_ids[live].tolist()))
    lands = live & (offs >= 0) & (offs < page)
    written = len(set(zip(page_ids[lands].tolist(),
                          offs[lands].tolist())))
    slot_elems = kn[0].numel()                  # Hkv * hd
    page_elems = kp[0].numel()                  # page * Hkv * hd
    nbytes = 2 * (n_live * slot_elems * kn.element_size()
                  + (touched * page - written) * slot_elems
                  * kp.element_size()
                  + touched * page_elems * kp.element_size()
                  + 2 * touched * ks.shape[1] * 4) + 3 * 4 * kn.shape[0]
    ops = 2 * (touched * page_elems + 2 * n_live * slot_elems)
    return nbytes, ops, touched


SWAP_FLUSH_BYTES = 64 << 20      # written between calls: more than 50 MB L2


def swap_work(leaves, n: int) -> int:
    """Bytes a tree pack or unpack of ``n`` pages must move: each leaf's
    (P, n) rows read once and written once, the int32 ids read once."""
    return sum(2 * leaf.shape[0] * n * leaf[0, 0].numel()
               * leaf.element_size() for leaf in leaves) + 4 * n


def time_swap(recorder: Recorder, launches: dict, parent, suffix: str,
              row) -> None:
    """Rows 3 and 4 (``suffix`` "") or 3q and 4q ("_int8"): the tree pack
    and unpack at their largest main-path call, one launch for every
    leaf, bit-exact against the plain tree versions and, leaf by leaf,
    against swap_pack_ref / swap_unpack_ref. Timed launched from the host
    (``ms``) and as device time (``device_ms``, CUDA graphs), with a warm
    L2 and after a 64 MB write (``cold_ms``, ``cold_device_ms``: the
    write's own time taken off), the parent's tree launch in turns on
    every measure; the library yardstick over the same leaves
    (``library_ms``, and ``library_device_ms``); and the copy of the slab
    between the card and one pinned host buffer (``host_copy_ms``: device
    to host beside the pack, host to device beside the unpack)."""
    import torch
    from repro_torch.kernels.swap_pack import (
        slab_views, swap_pack_ref, swap_pack_tree, swap_pack_tree_ref,
        swap_unpack_ref, swap_unpack_tree, swap_unpack_tree_ref)
    flush = torch.empty(SWAP_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed(fn):
        def call():
            flush.fill_(1)
            fn()
        return call

    def cold(row_, kernel_fn, old_fn, iters):
        order = (old_fn, kernel_fn, kernel_fn, old_fn) if old_fn else \
            (kernel_fn, kernel_fn)
        base = [(cuda_ms(flushed(lambda: None), iters),
                 graph_ms(flushed(lambda: None), iters))]
        times = [(cuda_ms(flushed(f), iters), graph_ms(flushed(f), iters))
                 for f in order]
        base.append((cuda_ms(flushed(lambda: None), iters),
                     graph_ms(flushed(lambda: None), iters)))
        b_loop, b_dev = (min(b[i] for b in base) for i in (0, 1))
        mine = times[1:3] if old_fn else times
        row_["cold_ms"] = min(t[0] for t in mine) - b_loop
        row_["cold_device_ms"] = min(t[1] for t in mine) - b_dev
        msg = (f"    cold L2 (after a {SWAP_FLUSH_BYTES >> 20} MB write, "
               f"its {b_loop:.4f} / {b_dev:.4f} ms taken off): launched "
               f"from the host {row_['cold_ms']:.4f} ms, device "
               f"{row_['cold_device_ms']:.4f} ms")
        if old_fn:
            row_["parent_cold_ms"] = min(times[0][0], times[3][0]) - b_loop
            row_["parent_cold_device_ms"] = min(times[0][1],
                                                times[3][1]) - b_dev
            msg += (f" (the parent's tree launch "
                    f"{row_['parent_cold_ms']:.4f} / "
                    f"{row_['parent_cold_device_ms']:.4f} ms)")
        log(msg)

    def finish(row_, kernel_fn, old_fn, lib_fn, copy_fn, leaves):
        device_time(row_, kernel_fn, old_fn, 20)
        cold(row_, kernel_fn, old_fn, 20)
        row_["library_device_ms"] = graph_ms(lib_fn, 20)
        row_["host_copy_ms"] = cuda_ms(copy_fn, 10)
        row_["leaves"] = len(leaves)
        log(f"    library device time {row_['library_device_ms']:.4f} ms; "
            f"the slab's pinned host copy {row_['host_copy_ms']:.4f} ms")

    # the pack: a slab of random bytes, so the rows it writes are seen
    leaves, ids, slab = recorder.call("swap_pack" + suffix)[0]
    n = ids.numel()
    ids64 = ids.long()
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randint(0, 256, slab.shape, generator=gen, device="cuda",
                         dtype=torch.uint8)
    got, want = base.clone(), base.clone()
    swap_pack_tree(leaves, ids, got)
    swap_pack_tree_ref(leaves, ids, want)
    torch.cuda.synchronize()
    exact = byte_equal(got, want) and all(
        byte_equal(v, swap_pack_ref(leaf, ids))
        for leaf, v in zip(leaves, slab_views(got, leaves, n)))
    shape = [[leaf.shape[0], n, *leaf.shape[2:], str(leaf.dtype)[6:]]
             for leaf in leaves]
    log(f"  swap_pack{suffix} main-path call {shape}: bit-exact against the "
        f"plain tree version and swap_pack_ref leaf by leaf: {exact}")
    assert exact, f"swap_pack{suffix} disagrees on the main path's inputs"

    def lib_fn():
        return [torch.index_select(leaf, 1, ids64) for leaf in leaves]
    ms, plain_ms = in_turns(lambda: swap_pack_tree_ref(leaves, ids, want),
                            lambda: swap_pack_tree(leaves, ids, got), 20)
    r = row("swap_pack" + suffix, ms, plain_ms, cuda_ms(lib_fn, 20),
            swap_work(leaves, n), 0, "bfloat16", 0.0, shape)
    host = torch.empty(got.numel(), dtype=torch.uint8, pin_memory=True)
    finish(r, lambda: swap_pack_tree(leaves, ids, got),
           (lambda: parent.swap_pack_tree(leaves, ids, got))
           if parent else None, lib_fn,
           lambda: host.copy_(got, non_blocking=True), leaves)
    del base, got, want, leaves, slab

    # the unpack: each version on its own copy of the recorded pools
    leaves, slab, ids = recorder.call("swap_unpack" + suffix)[0]
    n = ids.numel()
    ids64 = ids.long()
    views = slab_views(slab, leaves, n)
    got = [leaf.clone() for leaf in leaves]
    want = [leaf.clone() for leaf in leaves]
    swap_unpack_tree(got, slab, ids)
    swap_unpack_tree_ref(want, slab, ids)
    per_leaf = [swap_unpack_ref(leaf.clone(), v, ids)
                for leaf, v in zip(leaves, views)]
    torch.cuda.synchronize()
    exact = all(byte_equal(a, b) and byte_equal(a, c)
                for a, b, c in zip(got, want, per_leaf))
    shape = [[leaf.shape[0], n, *leaf.shape[2:], str(leaf.dtype)[6:]]
             for leaf in leaves]
    log(f"  swap_unpack{suffix} main-path call {shape}: bit-exact against "
        f"the plain tree version and swap_unpack_ref leaf by leaf: {exact}")
    assert exact, f"swap_unpack{suffix} disagrees on the main path's inputs"
    del want, per_leaf, leaves

    def lib_fn():
        return [leaf.index_copy_(1, ids64, v) for leaf, v in zip(got, views)]
    ms, plain_ms = in_turns(lambda: swap_unpack_tree_ref(got, slab, ids),
                            lambda: swap_unpack_tree(got, slab, ids), 20)
    r = row("swap_unpack" + suffix, ms, plain_ms, cuda_ms(lib_fn, 20),
            swap_work(got, n), 0, "bfloat16", 0.0, shape)
    host = slab.cpu().pin_memory()
    dst = torch.empty_like(slab)
    finish(r, lambda: swap_unpack_tree(got, slab, ids),
           (lambda: parent.swap_unpack_tree(got, slab, ids))
           if parent else None,
           lib_fn, lambda: dst.copy_(host, non_blocking=True), got)
    del got, views, slab, dst, flush
    torch.cuda.synchronize()


def time_stager(recorder: Recorder, parent) -> dict:
    """Host ms of one SwapStager pack + collect and of one unpack (the
    pinned slab's assembly from the page payloads included, ended by a
    synchronize), the median of 10 each, at the bf16 tree's largest
    recorded pack: its leaves' shapes and page ids over fresh random
    pools. With ``parent``, the parent's stager in turns, parent, this,
    this, parent, on the same page payloads."""
    import torch
    from repro_torch.kernels.swap_pack import SwapStager, slab_pages
    leaves, ids, _ = recorder.calls["swap_pack"][1]
    ids = ids.tolist()
    gen = torch.Generator(device="cuda").manual_seed(4)
    pools = [torch.randn(leaf.shape, generator=gen, device="cuda")
             .to(leaf.dtype) for leaf in leaves]

    def wall_ms(fn, iters=10):
        fn()
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return sorted(times)[iters // 2] * 1e3

    def pack():
        st = SwapStager()
        return st.collect(st.pack(pools, ids))
    pages = slab_pages(pack(), len(ids))

    def unpack():
        SwapStager().unpack(pools, ids, pages)
        torch.cuda.synchronize()

    def old_pack():
        with parent.own_ops():
            st = parent.SwapStager()
            return st.collect(st.pack(pools, ids))

    def old_unpack():
        with parent.own_ops():
            parent.SwapStager().unpack(pools, ids, pages)
        torch.cuda.synchronize()
    out = {"pages": len(ids), "leaves": len(pools)}
    for name, fn, old in (("pack_collect_ms", pack, old_pack),
                          ("unpack_ms", unpack, old_unpack)):
        if parent is None:
            out[name] = min(wall_ms(fn), wall_ms(fn))
            continue
        times = [wall_ms(f) for f in (old, fn, fn, old)]
        out[name] = min(times[1:3])
        out["parent_" + name] = min(times[0], times[3])
    log(f"  SwapStager host ms, {len(ids)} pages of {len(pools)} leaves "
        f"{[tuple(leaf.shape) for leaf in pools]}: {json.dumps(out)}")
    del pools, pages
    torch.cuda.empty_cache()
    return out


def attention_bytes(q, kp, n_pages_read, n_idx):
    """Each live page of K and V read once (and its two scales for a
    quantized pool), q read and out written once, the int32 routing
    read once."""
    page, Hkv, hd = kp.shape[1:]
    scales = 2 * n_pages_read * Hkv * 4 if kp.element_size() == 1 else 0
    return (2 * n_pages_read * page * Hkv * hd * kp.element_size()
            + scales + 2 * q.numel() * q.element_size() + 4 * n_idx)


def ragged_work(q, kp, bt, tok_seq, tok_pos, window):
    """(bytes, operations) of a ragged call from its data: the pages
    its live rows see, 4 hd operations per visible (query, key)
    pair and G head."""
    N, Hkv, G, hd = q.shape
    page = kp.shape[1]
    pos, seqs, table = tok_pos.tolist(), tok_seq.tolist(), bt.tolist()
    pages, visible = set(), 0
    for p, sq in zip(pos, seqs):
        if p < 0:
            continue
        lo = 0 if window is None else max(0, p + 1 - window)
        visible += p + 1 - lo
        pages.update(table[sq][i] for i in range(lo // page,
                                                 p // page + 1))
    return (attention_bytes(q, kp, len(pages), bt.numel() + 2 * N),
            4 * visible * Hkv * G * hd)


def kernel_row(name, src, replaces, launches, err, ms, plain_ms, lib_ms,
             nbytes, ops, dtype, shape) -> dict:
    """A row of the kernels line, its bound by PERF.md §6's rule (bytes at
    the HBM rate against operations at the type's peak)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[dtype] * 1e3
    bound = max(by_bytes, by_ops)
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "library_ms": lib_ms, "shape": shape}
    log(f"  {name} {shape}: kernel {ms:.4f} ms ({ms / bound:.1f}x bound), "
        f"plain {plain_ms:.4f} ms, library {lib_ms} ms, bound {bound:.5f} "
        f"ms ({row['bound_by']}), {launches} launches, main-path "
        f"max_abs_err {err:.3g}")
    return row


def ulp_err(name, got, want) -> float:
    """Both round one float32 result to the working type once: within one
    unit in the last place at the output's largest magnitude (2^-7 of it
    in bf16, 2^-16 in float32)."""
    import torch
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -16}[want.dtype]
    err = max_err(got, want)
    tol = ulp * float(want.float().abs().max())
    log(f"  {name} main-path call: max_abs_err {err:.3g} (tol {tol:.3g})")
    assert err <= tol, name
    return err


def device_time(row_, kernel_fn, old_fn, iters):
    """The row's device time, ``device_ms`` (graph_ms: no host time per
    call), beside its ``ms`` (cuda_ms over calls launched from Python,
    as every row is timed), and the wrapper's host time, ``host_ms``,
    the difference. With the parent's kernel, both measures of both
    kernels in turns, parent, change, change, parent: ``parent_ms``,
    ``parent_device_ms`` and ``parent_host_ms``."""
    if old_fn is None:
        row_["device_ms"] = graph_ms(kernel_fn, iters)
        row_["host_ms"] = row_["ms"] - row_["device_ms"]
        log(f"    device time {row_['device_ms']:.4f} ms (launched "
            f"from the host {row_['ms']:.4f} ms, host time "
            f"{row_['host_ms']:.4f} ms)")
        return
    order = (old_fn, kernel_fn, kernel_fn, old_fn)
    loop = [cuda_ms(f, iters) for f in order]
    dev = [graph_ms(f, iters) for f in order]
    row_["device_ms"] = min(dev[1:3])
    row_["parent_ms"] = min(loop[0], loop[3])
    row_["parent_device_ms"] = min(dev[0], dev[3])
    row_["host_ms"] = row_["ms"] - row_["device_ms"]
    row_["parent_host_ms"] = row_["parent_ms"] - row_["parent_device_ms"]
    log(f"    in turns with the parent's kernel: launched from the "
        f"host {row_['parent_ms']:.4f} -> {min(loop[1:3]):.4f} ms, "
        f"device time {row_['parent_device_ms']:.4f} -> "
        f"{row_['device_ms']:.4f} ms")


def time_kernels(recorder: Recorder, worst: dict, launches: dict,
                 parent=None) -> list:
    """Rows 1-6 (and 1d, 2q), each ``ms`` launched from the host as
    earlier rows were; the attention and append rows also as device
    time. With ``parent`` (``parent_kernels``), the parent's attention and
    append wrappers timed in turns with these on the same inputs."""
    import torch
    from repro_torch.kernels.kv_append import kv_append, kv_append_ref
    from repro_torch.kernels.kv_quant import (kv_append_quant,
                                              kv_append_quant_ref,
                                              kv_quant_qmax, page_requant,
                                              page_requant_ref,
                                              updated_page_scales)
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_quant_ref, paged_attention_ref)
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_quant_ref,
        ragged_paged_attention_ref, sm_count, split_count, tile_grid)
    rows = []
    ragged_src = ("src/repro_torch/kernels/csrc/ragged_paged_attention.cu",
                  "src/repro/kernels/ragged_paged_attention.py:105")
    paged_src = ("src/repro_torch/kernels/csrc/paged_attention.cu",
                 "src/repro/kernels/paged_attention.py:93")
    meta = {
        "ragged_paged_attention": ragged_src,
        "ragged_paged_attention_int8": ragged_src,
        "ragged_paged_attention_decode": ragged_src,
        "paged_attention": paged_src,
        "paged_attention_int8": paged_src,
        "kv_append": ("src/repro_torch/kernels/csrc/kv_append.cu",
                      "src/repro/kernels/kv_append.py:60"),
        "kv_append_quant": (
            "src/repro_torch/kernels/csrc/kv_append_quant.cu",
            "src/repro/kernels/kv_quant.py:182 (kv_append_quant: XLA phases "
            "A and C around page_requant, :140, and kv_append, "
            "kv_append.py:60)"),
        "swap_pack": ("src/repro_torch/kernels/csrc/swap_pack.cu",
                      "src/repro/kernels/swap_pack.py:35"),
        "swap_unpack": ("src/repro_torch/kernels/csrc/swap_pack.cu",
                        "src/repro/kernels/swap_pack.py:74"),
        "swap_pack_int8": ("src/repro_torch/kernels/csrc/swap_pack.cu",
                           "src/repro/kernels/swap_pack.py:35"),
        "swap_unpack_int8": ("src/repro_torch/kernels/csrc/swap_pack.cu",
                             "src/repro/kernels/swap_pack.py:74"),
        "page_requant": ("src/repro_torch/kernels/csrc/page_requant.cu",
                         "src/repro/kernels/kv_quant.py:140"),
    }

    def row(name, ms, plain_ms, lib_ms, nbytes, ops, dtype, err, shape):
        src, rep = meta[name]
        rows.append(kernel_row(name, src, rep, launches[name], err, ms,
                               plain_ms, lib_ms, nbytes, ops, dtype, shape))
        return rows[-1]

    def main_path_err(name, got, want):
        return max(worst[name], ulp_err(name, got, want))

    def bound_ms(nbytes, ops, dtype):
        return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]) * 1e3

    def size_gaps(name, key, prepare):
        """launches x (time - bound) at every N the serve runs gave
        ``key``, each N timed at its last call by both measures (with the
        parent's wrapper too): ``prepare(args, kw)`` gives ({"ms": this
        tree's call[, "parent_ms": the parent's]}, bytes, operations,
        dtype, notes). Kept on the row as ``by_size``,
        ``launches_x_gap_s`` and ``launches_x_device_gap_s``."""
        by_size = []
        gap = {m: 0.0 for m in ("ms", "device_ms", "parent_ms",
                                "parent_device_ms")}
        counts = recorder.by_size[key]
        assert sum(counts.values()) == launches[name], (counts, name)
        for n in sorted(counts):
            fns, nbytes, ops, dtype, notes = prepare(*recorder.call(
                key, size=n))
            b_ms = bound_ms(nbytes, ops, dtype)
            entry = {"N": n, "launches": counts[n], "bound_ms": b_ms,
                     **notes}
            for m, fn in fns.items():
                entry[m] = cuda_ms(fn, 10)
                entry[m.replace("ms", "device_ms")] = graph_ms(fn, 10)
            for m in gap:
                if m in entry:
                    gap[m] += counts[n] * (entry[m] - b_ms)
            by_size.append(entry)
            log(f"    N={n} {notes}: {counts[n]} launches, " + ", ".join(
                f"{m} {entry[m]:.4f}" for m in gap if m in entry)
                + f", bound {b_ms:.5f} ms")
        rows[-1]["by_size"] = by_size
        rows[-1]["launches_x_gap_s"] = gap["ms"] / 1e3
        rows[-1]["launches_x_device_gap_s"] = gap["device_ms"] / 1e3
        log("    launches x (time - bound) over the sizes: " + ", ".join(
            f"{m} {gap[m] / 1e3:.3f} s" for m in gap
            if parent or "parent" not in m))

    def ragged_at_size(a, k):
        sc = {x: k.pop(x) for x in ("k_scale", "v_scale") if x in k}
        fns = {"ms": lambda: ragged_paged_attention(*a, **sc, **k)}
        if parent:
            fns["parent_ms"] = lambda: parent.ragged(*a, **sc, **k)
        return (fns, *ragged_work(a[0], a[1], a[3], a[4], a[5],
                                  k.get("window")),
                str(a[0].dtype)[6:], {"ctx": int(a[5].max()) + 1})

    # ragged paged attention: no single PyTorch call computes it. Rows 1
    # and 1q at the largest call, 1d at the largest decode-only call
    for name, plain, key in (
            ("ragged_paged_attention", ragged_paged_attention_ref,
             "ragged_paged_attention"),
            ("ragged_paged_attention_int8", ragged_paged_attention_quant_ref,
             "ragged_paged_attention_int8"),
            ("ragged_paged_attention_decode", ragged_paged_attention_ref,
             "ragged_paged_attention_decode")):
        args, kw = recorder.call(key)
        q, kp, vp, bt, tok_seq, tok_pos = args
        scales = {k: kw.pop(k) for k in ("k_scale", "v_scale") if k in kw}
        plain_args = (q, kp, vp, *scales.values(), bt, tok_seq, tok_pos)

        def kernel_fn():
            return ragged_paged_attention(*args, **scales, **kw)

        def plain_fn():
            return plain(*plain_args, **kw)

        def old_fn():
            return parent.ragged(*args, **scales, **kw)
        err = main_path_err(name, kernel_fn(), plain_fn())
        ms, plain_ms = in_turns(plain_fn, kernel_fn, 5)
        N, Hkv, G, hd = q.shape
        nbytes, ops = ragged_work(q, kp, bt, tok_seq, tok_pos,
                                  kw.get("window"))
        tiles = tile_grid(N, G, bt.shape[0])
        splits = split_count(tiles * Hkv, bt.shape[1] * kp.shape[1],
                             sm_count(0))
        row(name, ms, plain_ms, None, nbytes, ops, str(q.dtype)[6:], err,
            list(q.shape) + [f"ctx up to {int(tok_pos.max()) + 1}",
                             f"{tiles} tiles x {Hkv} heads x {splits} "
                             "splits"])
        device_time(rows[-1], kernel_fn, old_fn if parent else None, 20)
        if key in recorder.by_size:
            # launches x (ms - bound) at every bucketed N the serve runs
            # gave, each N timed at its last call, by both measures
            size_gaps(name, key, ragged_at_size)

    # paged decode attention: no single PyTorch call computes it either
    for name, plain in (("paged_attention", paged_attention_ref),
                        ("paged_attention_int8", paged_attention_quant_ref)):
        args, kw = recorder.call(name)
        q, kp, vp, bt, ctx_lens = args
        scales = {k: kw.pop(k) for k in ("k_scale", "v_scale") if k in kw}
        plain_args = (q, kp, vp, *scales.values(), bt, ctx_lens)

        def kernel_fn():
            return paged_attention(*args, **scales, **kw)

        def plain_fn():
            return plain(*plain_args, **kw)

        def old_fn():
            return parent.paged(*args, **scales, **kw)
        err = main_path_err(name, kernel_fn(), plain_fn())
        ms, plain_ms = in_turns(plain_fn, kernel_fn, 20)
        B, Hkv, G, hd = q.shape
        nbytes, ops = ragged_work(q, kp, bt, torch.arange(B),
                                  ctx_lens - 1, kw.get("window"))
        splits = split_count(B * Hkv, bt.shape[1] * kp.shape[1],
                             sm_count(0))
        row(name, ms, plain_ms, None, nbytes, ops, str(q.dtype)[6:], err,
            list(q.shape) + [f"ctx {ctx_lens.tolist()}",
                             f"{splits} splits"])
        device_time(rows[-1], kernel_fn, old_fn if parent else None, 20)

    def append_bytes(kn, valid):
        """Each valid row read and written once in both pools, the int32
        routing read once."""
        row_bytes = kn[0].numel() * kn.element_size()
        return 4 * int((valid != 0).sum()) * row_bytes + 3 * 4 * kn.shape[0]

    def append_at_size(a, _):
        fns = {"ms": lambda: kv_append(*a)}
        if parent:
            fns["parent_ms"] = lambda: parent.kv_append(*a)
        return fns, append_bytes(a[2], a[6]), 0, str(a[2].dtype)[6:], {}

    def append_quant_at_size(a, _):
        mine, olds = ([t.clone() for t in a[:4]] for _ in range(2))
        fns = {"ms": lambda: kv_append_quant(*mine, *a[4:])}
        if parent:
            fns["parent_ms"] = lambda: parent.kv_append_quant(*olds, *a[4:])
        nbytes, ops, touched = append_quant_work(a[0], a[2], a[4], *a[6:])
        return fns, nbytes, ops, "float32", {"pages": touched}

    # kv_append: two pools and a validity mask, no single PyTorch call
    args, _ = recorder.call("kv_append")
    kp, vp, kn, vn, ids, offs, valid = args
    want_k, want_v = kv_append_ref(kp.clone(), vp.clone(), kn, vn, ids, offs,
                                   valid)
    got_k, got_v = kv_append(kp, vp, kn, vn, ids, offs, valid)
    err = max(worst["kv_append"], max_err(got_k, want_k),
              max_err(got_v, want_v))
    assert err == 0.0, "kv_append disagrees on the main path's inputs"
    ms, plain_ms = in_turns(
        lambda: kv_append_ref(kp, vp, kn, vn, ids, offs, valid),
        lambda: kv_append(kp, vp, kn, vn, ids, offs, valid), 20)
    row("kv_append", ms, plain_ms, None, append_bytes(kn, valid), 0,
        str(kn.dtype)[6:], err, list(kn.shape))
    device_time(rows[-1], lambda: kv_append(kp, vp, kn, vn, ids, offs, valid),
                (lambda: parent.kv_append(kp, vp, kn, vn, ids, offs, valid))
                if parent else None, 20)
    size_gaps("kv_append", "kv_append", append_at_size)

    # the quantized append, row 2q: the whole of kv_append_quant at its
    # largest call. Each version runs on its own copy of the recorded pools
    # and scales, cloned before the timed region: its first call grows the
    # scales as the serve's call did, every later one finds them grown
    # (ratio 1), the same work. No single PyTorch call computes it
    args, _ = recorder.call("kv_append_quant")
    kp, vp, ks, vs, kn, vn, page_ids, offs, valid = args
    routing = args[4:]
    want = kv_append_quant_ref(*(t.clone() for t in args[:4]), *routing)
    on_cpu = kv_append_quant_ref(*(t.cpu() for t in args))
    got = kv_append_quant(*(t.clone() for t in args[:4]), *routing)
    torch.cuda.synchronize()
    assert all(same_bytes(a, b) for a, b in zip(got, want)), \
        f"kv_append_quant disagrees on the main path's inputs: " \
        f"{differing(got, want)}"
    got = [t.cpu() for t in got]
    assert all(same_bytes(a, b) for a, b in zip(got, on_cpu)), \
        f"kv_append_quant disagrees with the plain version on the CPU on " \
        f"the main path's inputs: {differing(got, on_cpu)}"
    log("  kv_append_quant main-path call: bit-exact against the plain "
        "version on the card and on the CPU")
    mine, plains, olds = ([t.clone() for t in args[:4]] for _ in range(3))
    ms, plain_ms = in_turns(lambda: kv_append_quant_ref(*plains, *routing),
                            lambda: kv_append_quant(*mine, *routing), 20)
    nbytes, ops, touched = append_quant_work(kp, ks, kn, page_ids, offs,
                                             valid)
    row("kv_append_quant", ms, plain_ms, None, nbytes, ops, "float32",
        worst["kv_append_quant"],
        list(kn.shape) + [f"{touched} pages", str(kp.dtype)[6:],
                          f"rows {str(kn.dtype)[6:]}"])
    device_time(rows[-1], lambda: kv_append_quant(*mine, *routing),
                (lambda: parent.kv_append_quant(*olds, *routing))
                if parent else None, 20)
    size_gaps("kv_append_quant", "kv_append_quant", append_quant_at_size)

    # swap pack / unpack: rows 3 and 4 at the bf16 pool tree's largest
    # call, 3q and 4q at the int8 tree's (payload and scale leaves), one
    # launch each; the yardstick is index_select / index_copy_ over the
    # same leaves, the parent's tree launch in turns
    for suffix in ("", "_int8"):
        time_swap(recorder, launches, parent, suffix, row)

    # page_requant: its call inside the largest quantized append, rebuilt
    # from that append's inputs (phase A on copies gives the ratios); no
    # single PyTorch call requantizes pages by per-head ratios. The main
    # path no longer launches it: it is the reference's standalone op
    n_pages = kp.shape[0]
    pids = torch.where(valid != 0, page_ids, n_pages).to(torch.int32)
    gidx = pids.clamp(max=n_pages - 1).long()
    ks, vs = ks.clone(), vs.clone()
    old = ks[gidx], vs[gidx]
    updated_page_scales(ks, vs, kn, vn, pids, kv_quant_qmax(kp.dtype))
    k_ratio, v_ratio = (torch.where(s[gidx] > 0, o / torch.where(
        s[gidx] > 0, s[gidx], 1.0), 0.0) for o, s in zip(old, (ks, vs)))
    rq = (k_ratio, v_ratio, pids)
    want = page_requant_ref(kp.clone(), vp.clone(), *rq)
    got = page_requant(kp.clone(), vp.clone(), *rq)
    torch.cuda.synchronize()
    assert all(same_bytes(a, b) for a, b in zip(got, want)), \
        "page_requant disagrees on the main path's inputs"
    kc, vc = kp.clone(), vp.clone()
    ms, plain_ms = in_turns(lambda: page_requant_ref(kc, vc, *rq),
                            lambda: page_requant(kc, vc, *rq), 20)
    touched = len(set(pids[pids < n_pages].tolist()))
    page_bytes = kp[0].numel() * kp.element_size()
    nbytes = 2 * 2 * touched * page_bytes + 2 * k_ratio.numel() * 4 \
        + 4 * pids.numel()
    row("page_requant", ms, plain_ms, None, nbytes,
        2 * touched * kp[0].numel(), "float32", 0.0,
        [pids.numel(), f"{touched} pages"] + list(kp.shape[1:]))
    device_time(rows[-1], lambda: page_requant(kc, vc, *rq),
                (lambda: parent.page_requant(kc, vc, *rq)) if parent
                else None, 20)
    torch.cuda.synchronize()
    return rows


APPEND_RANGE = "kv_append (the attention layer's append)"


class AppendRange:
    """Puts each call of the attention layer's two append ops (float pools'
    kv_append, quantized pools' kv_append_quant) under one profiler range,
    so the device time of the kernels they launch adds up under it."""

    def __enter__(self):
        import torch
        import repro_torch.models.attention as attention
        self._orig = {}
        for name in ("kv_append_op", "kv_append_quant_op"):
            orig = self._orig[name] = getattr(attention, name)

            def wrapped(*args, _orig=orig, **kw):
                with torch.profiler.record_function(APPEND_RANGE):
                    return _orig(*args, **kw)
            setattr(attention, name, wrapped)
        return self

    def __exit__(self, *exc):
        import repro_torch.models.attention as attention
        for name, orig in self._orig.items():
            setattr(attention, name, orig)


def profile_serve(warm_steps: int = 10, steps: int = 10,
                  **engine_kw) -> None:
    """torch.profiler over ``steps`` engine steps of the InferCept serve
    run (``engine_kw``: e.g. ``kv_dtype="int8"``), after ``warm_steps``:
    the device's busy share of the window, device time by kernel, and the
    append's share of it (``AppendRange``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng, client, _ = agent_engine("infercept", tiny=False, device="cuda",
                                  **engine_kw)
    client.poll(warm_steps)
    torch.cuda.synchronize()
    with AppendRange(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.poll(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    label = f"{steps} serve steps" + "".join(
        f", {k}={v}" for k, v in engine_kw.items())
    dev_us, total = log_device_time(prof, wall, label)
    moe_us = sum(us for k, (us, _) in dev_us.items() if "moe_" in k)
    if moe_us:
        log(f"  the MoE kernels: {moe_us / 1e3:.2f} ms = "
            f"{moe_us / max(total, 1e-9):.3f} of device time")
    # both forms: mla_attention_kernel<T> and mla_attention_tc_kernel
    mla_us = sum(us for k, (us, _) in dev_us.items()
                 if "mla_attention" in k)
    if mla_us:
        log(f"  the latent-attention kernel (row 10): {mla_us / 1e3:.2f} ms "
            f"= {mla_us / max(total, 1e-9):.3f} of device time")
    # the PyTorch ops' kernels add up under the range's host-side events
    # (its device-side twin spans idle gaps too); kernels launched through
    # ctypes are not attributed to it, so the append's own CUDA kernels
    # are added by name unless the range already holds them
    ranges = [e for e in prof.events() if e.name == APPEND_RANGE
              and not str(e.device_type).endswith("CUDA")]
    attributed, todo = set(), list(ranges)
    while todo:
        e = todo.pop()
        attributed.update(k.name for k in e.kernels)
        todo.extend(e.cpu_children)
    range_us = sum(e.device_time_total for e in ranges)
    own = {k: v for k, v in dev_us.items() if any(
        n in k for n in ("kv_append_kernel", "append_quant_kernel",
                         "requant_kernel"))}
    for key, (us, n) in own.items():
        log(f"    {us / 1e3:9.3f} ms {n:7d}x  {key[:80]}")
    own_us = sum(us for k, (us, _) in own.items() if k not in attributed)
    append_us = range_us + own_us
    log(f"  the append ({len(ranges)} calls): {append_us / 1e3:.2f} ms = "
        f"{append_us / max(total, 1e-9):.3f} of device time (PyTorch ops "
        f"{range_us / 1e3:.2f} ms, CUDA kernels {own_us / 1e3:.2f} ms)")
    eng.close()


# ---------------------------------------------------------------------------
# phase 3 (continued): the flash attention kernels
# ---------------------------------------------------------------------------
def check_flash_kernels(gen, worst) -> None:
    """The flash forward (out and lse) and backward (dq, dk, dv) kernels
    against their plain versions on the card: llama3.2-1b's widths (Hkv 8,
    G 4, hd 64) at T {1, 63, 64, 65, 127, 129, 1000, 2048}, Tq < Tk (an
    offset that is not a multiple of the bf16 kernels' 64-row tiles too),
    G {1, 4, 16} with a window (ending on and one past a tile boundary), a
    softcap and no causal mask, hd 32 and 128, in float32 and bf16; at hd
    192 and 256 (the bf16 backward's TMA-fed kernels) B x Hkv up to 6 with
    distinct heads and T past a 64-row tile (rows past T read as zeros),
    Tq < Tk, G 2 and 16 (``max_heads``), a window of 70 with softcap 50, and
    a second backward bit for bit equal to the first (no atomics) in every
    float32 case and in bf16 at 192 and 256.
    Tolerances: out 1e-4 (float32) and 3e-2 (bf16: both round one
    float32 result once); lse 1e-4 (float32 sums in another order);
    gradients 1e-4 (float32) and 2^-6 (bf16, two units in the last place)
    of the largest magnitude among dq, dk and dv (not each one's own: at
    T = 1 one key takes the whole softmax, and dq and dk cancel to
    rounding noise around 0)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref)
    dev = torch.device("cuda")
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    rel = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
    cases = [(f"T={t}", dict(B=2 if t < 1000 else 1, Hkv=8, G=4, Tq=t, Tk=t,
                            hd=64), {})
             for t in (1, 63, 64, 65, 127, 129, 1000, 2048)]
    cases += [
        ("Tq=100 Tk=300", dict(B=2, Hkv=8, G=4, Tq=100, Tk=300, hd=64), {}),
        ("G=1 window=33", dict(B=2, Hkv=8, G=1, Tq=200, Tk=200, hd=64),
         dict(window=33)),
        ("G=4 window=100 Tq<Tk", dict(B=1, Hkv=8, G=4, Tq=150, Tk=500,
                                      hd=64), dict(window=100)),
        ("G=4 softcap=30", dict(B=2, Hkv=8, G=4, Tq=130, Tk=130, hd=64),
         dict(softcap=30.0)),
        ("G=1 non-causal", dict(B=2, Hkv=8, G=1, Tq=90, Tk=130, hd=64),
         dict(causal=False)),
        ("G=4 window=17 softcap=20", dict(B=1, Hkv=8, G=4, Tq=257, Tk=257,
                                          hd=64),
         dict(window=17, softcap=20.0)),
        ("hd=32 G=4", dict(B=2, Hkv=2, G=4, Tq=100, Tk=100, hd=32), {}),
        ("hd=128 G=8", dict(B=1, Hkv=2, G=8, Tq=100, Tk=100, hd=128), {}),
        ("Tq=100 Tk=163", dict(B=2, Hkv=8, G=4, Tq=100, Tk=163, hd=64), {}),
        ("G=4 window=64", dict(B=1, Hkv=8, G=4, Tq=200, Tk=200, hd=64),
         dict(window=64)),
        ("G=4 window=65", dict(B=1, Hkv=8, G=4, Tq=200, Tk=200, hd=64),
         dict(window=65)),
        ("G=1 T=129", dict(B=2, Hkv=8, G=1, Tq=129, Tk=129, hd=64), {}),
        ("G=16 T=130", dict(B=1, Hkv=2, G=16, Tq=130, Tk=130, hd=64), {}),
        ("hd=32 T=129", dict(B=2, Hkv=2, G=4, Tq=129, Tk=129, hd=32), {}),
        ("hd=32 Tq=100 Tk=163 window=65", dict(B=1, Hkv=2, G=4, Tq=100,
                                               Tk=163, hd=32),
         dict(window=65)),
        ("hd=128 T=129", dict(B=1, Hkv=2, G=4, Tq=129, Tk=129, hd=128), {}),
        ("hd=128 Tq=100 Tk=163 softcap=20", dict(B=1, Hkv=2, G=2, Tq=100,
                                                 Tk=163, hd=128),
         dict(softcap=20.0)),
        # dense_serve's prefill: llama's every layer at B 8 x T 1024
        ("B=8 T=1024", dict(B=8, Hkv=8, G=4, Tq=1024, Tk=1024, hd=64), {})]
    for hd in (192, 256):
        cases += [
            (f"hd={hd} B=2 Hkv=3 T=200", dict(B=2, Hkv=3, G=2, Tq=200,
                                              Tk=200, hd=hd), {}),
            (f"hd={hd} B=3 T=129", dict(B=3, Hkv=1, G=1, Tq=129, Tk=129,
                                        hd=hd), {}),
            (f"hd={hd} Tq=100 Tk=300", dict(B=1, Hkv=3, G=2, Tq=100, Tk=300,
                                            hd=hd), {}),
            (f"hd={hd} G=16 Tq=77 Tk=200", dict(B=1, Hkv=3, G=16, Tq=77,
                                                Tk=200, hd=hd), {}),
            (f"hd={hd} window=70 softcap=50", dict(B=2, Hkv=2, G=2, Tq=300,
                                                   Tk=300, hd=hd),
             dict(window=70, softcap=50.0))]
    # the wide rows' worst errors (row 7m's forward at 192)
    fwd_row = {192: "flash_attention_hd192", 256: "flash_attention_hd256"}
    bwd_rows = {192: ("flash_attention_bwd_hd192",),
                256: ("flash_attention_bwd_hd256", "flash_attention_bwd_gptj")}
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape, kw in cases:
            B, Hkv, G, Tq, Tk, hd = (shape[k] for k in ("B", "Hkv", "G",
                                                        "Tq", "Tk", "hd"))
            q, do = (torch.randn((B, Hkv, G, Tq, hd), generator=gen,
                                 device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn((B, Hkv, Tk, hd), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            out, lse = flash_attention_fwd(q, k, v, **kw)
            want, want_lse = flash_attention_fwd_ref(q, k, v, **kw)
            grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            want_grads = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            err, lse_err = max_err(out, want), max_err(lse, want_lse)
            g_abs = [max_err(g, w) for g, w in zip(grads, want_grads)]
            g_rel = max(g_abs) / max(float(w.float().abs().max())
                                     for w in want_grads)
            log(f"  flash_attention {label} {str(dtype)[6:]}: out "
                f"max_abs_err {err:.3g} (tol {tol[dtype]:g}), lse "
                f"{lse_err:.3g} (tol 1e-4); backward dq/dk/dv max_abs_err "
                f"{g_rel:.3g} of their max (tol {rel[dtype]:.3g})")
            assert err <= tol[dtype] and lse_err <= 1e-4, label
            assert g_rel <= rel[dtype], label
            if hd > 128 or dtype == torch.float32:
                again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
                assert all(torch.equal(a, b) for a, b in zip(grads, again)), \
                    label
                log("    the backward again: dq, dk, dv bit for bit equal")
            if dtype == torch.float32:
                # the float32 rows: 7mf and 7mb at 192, 7f and 7bf else
                f_row = ("flash_attention_hd192_f32" if hd == 192
                         else "flash_attention_f32")
                b_rows = (("flash_attention_bwd_hd192",) if hd == 192
                          else ("flash_attention_bwd_f32",))
            else:
                f_row = fwd_row.get(hd, "flash_attention")
                b_rows = bwd_rows.get(hd, ("flash_attention_bwd",))
            worst[f_row] = max(worst[f_row], err)
            for b_row in b_rows:
                worst[b_row] = max(worst[b_row], *g_abs)
            del q, k, v, do, out, lse, want, want_lse, grads, want_grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: one train step at the tiny config, card against CPU
# ---------------------------------------------------------------------------
def check_tiny_train(device: str = "cuda") -> None:
    """One make_train_step of each tiny config, llama3.2-1b, xlstm-350m
    and zamba2-1.2b, in float32, remat on, on ``device`` (the kernels:
    flash and its backward, gla_scan and gla_scan_bwd) and on the CPU (the
    plain versions), from the same weights and batch. Held on weights
    conditioned for soft attention (as decode_parity; xlstm has no
    attention and is held on its init): loss within 1e-4, every gradient
    within 1e-4 of its leaf's largest magnitude (float32 products summed
    in another order), grad_norm within 1e-4 relative and lr equal. With
    the reference's init, whose attention is close to a hard max even at
    the tiny widths (float32 rounding alone moves its gradients ~5e-4 of a
    leaf's magnitude, tests/test_torch_training.py), the same comparison
    is reported, not held. On the card each model's steps launch each
    kernel of its layers (``prefill_launches``) four times a forward
    (two calls, remat) and twice a backward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)
    from repro_torch.utils.tree import tree_leaves, tree_map
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    for model in ("llama3.2-1b", "xlstm-350m", "zamba2-1.2b"):
        cfg = get_config(model, tiny=True)
        lm = LM(cfg)
        batch = [torch.as_tensor(a) for a in next(SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=100, global_batch=4,
            seed=0)).batches())]
        expected = prefill_launches(cfg)
        attention = "flash_attention" in expected
        for conditioned in (True, False) if attention else (False,):
            params = lm.init(torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
            if conditioned:
                condition_attention(params)
            res = {}
            for where in ("cpu", device):
                p = tree_map(lambda t: t.to(where), params)
                b = [t.to(where) for t in batch]
                reset_counts()
                loss, _, grads = loss_and_grads(lm, p, *b)
                _, _, met = make_train_step(lm, opt_cfg)(p, adamw_init(p),
                                                         *b)
                res[where] = (loss, tree_leaves(grads), met, launch_counts())
            (lc, gc_, mc, _), (lg, gg, mg, counts) = res["cpu"], res[device]
            loss_err = abs(float(lg) - float(lc))
            g_rel = max(max_err(a.cpu(), b) / max(float(b.abs().max()),
                                                  1e-30)
                        for a, b in zip(gg, gc_))
            norm_rel = abs(float(mg["grad_norm"]) / float(mc["grad_norm"])
                           - 1)
            held = conditioned or not attention
            name = ("conditioned" if conditioned else "reference") + " init"
            log(f"  {model} tiny, {name}, train step on {device} vs cpu: "
                f"loss {float(lg):.6f} vs {float(lc):.6f} (err "
                f"{loss_err:.3g}), gradients {g_rel:.3g} of each leaf's "
                f"max, grad_norm {float(mg['grad_norm']):.6f} vs "
                f"{float(mc['grad_norm']):.6f} ({norm_rel:.3g} relative), "
                f"lr {float(mg['lr']):.3g}"
                f"{' (held: 1e-4 each)' if held else ' (reported)'}")
            assert math.isfinite(float(lg)) and \
                float(mg["lr"]) == float(mc["lr"])
            if held:
                assert loss_err <= 1e-4 and g_rel <= 1e-4 and \
                    norm_rel <= 1e-4, model
            if device == "cuda":
                for kernel, n in expected.items():
                    assert counts[kernel] == 4 * n, (model, counts)
                    assert counts[f"{kernel}_bwd"] == 2 * n, (model, counts)


# ---------------------------------------------------------------------------
# phase 7: full-width loss and gradients, kernels against plain versions
# ---------------------------------------------------------------------------
def plain_attention():
    """A stand-in for ``flash_attention_op`` that runs the plain forward
    under autograd on any device: the oracle of the train path."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    def op(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    return op


def plain_gla():
    """A stand-in for ``ops.gla_scan_op`` that runs the plain chunked GLA
    under autograd on any device (in float64 where log_a is float64): the
    oracle of the SSM train path."""
    from repro_torch.kernels.gla_scan import chunked_gla_ref

    def op(q, k, v, log_a, *, chunk=128, initial_state=None):
        return chunked_gla_ref(q, k, v, log_a, chunk, initial_state)
    return op


def train_grads(lm, params, batch, *, plain: bool):
    """loss_and_grads with the kernels, or with the plain attention and the
    plain GLA put in their places for the call."""
    import repro_torch.kernels.ops as ops
    import repro_torch.models.attention as attention
    from repro_torch.training.train_loop import loss_and_grads
    orig = attention.flash_attention_op, ops.gla_scan_op
    if plain:
        attention.flash_attention_op = plain_attention()
        ops.gla_scan_op = plain_gla()
    try:
        return loss_and_grads(lm, params, *batch)
    finally:
        attention.flash_attention_op, ops.gla_scan_op = orig


def check_train_parity(*, tiny: bool = False, device: str = "cuda") -> None:
    """Full-width llama3.2-1b in float32, B 1 x T 512, remat on: the loss
    and every gradient of the kernel path against the plain path on the
    same device. Held on weights conditioned for soft attention (as
    decode_parity): loss within 1e-4, each gradient within 1e-3 of its
    leaf's largest magnitude (16 layers of float32 sums in other orders).
    With the reference's init, whose attention is a hard max that
    rounding alone can flip, the same comparison is reported, not held.
    ``tiny`` and ``device="cpu"`` rehearse it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import global_norm
    from repro_torch.utils.tree import tree_leaves
    dev = torch.device(device)
    cfg = get_config("llama3.2-1b", tiny=tiny)
    lm = LM(cfg)
    batch = [torch.as_tensor(a, device=dev) for a in next(SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=1,
                   seed=1)).batches())]
    for conditioned in (True, False):
        params = lm.init(torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
        if conditioned:
            condition_attention(params)
        lk, _, gk = train_grads(lm, params, batch, plain=False)
        lp, _, gp = train_grads(lm, params, batch, plain=True)
        loss_err = abs(float(lk) - float(lp))
        g_rel = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
        finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(gk))
        name = "conditioned" if conditioned else "reference"
        log(f"  {name} init: loss kernel {float(lk):.6f} vs plain "
            f"{float(lp):.6f} (err {loss_err:.3g}), gradients "
            f"{g_rel:.3g} of each leaf's max"
            f"{' (held: 1e-4, 1e-3)' if conditioned else ' (reported)'}; "
            f"global gradient norm kernel {float(global_norm(gk)):.4g}, "
            f"plain {float(global_norm(gp)):.4g}")
        assert finite and math.isfinite(float(lk)), name
        if conditioned:
            assert loss_err <= 1e-4 and g_rel <= 1e-3, name
        del params, gk, gp
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def check_ssm_train_parity(*, tiny: bool = False,
                           device: str = "cuda") -> None:
    """Full-width xlstm-350m cut to one period (7 mLSTM + 1 sLSTM) and
    zamba2-1.2b cut to one period (5 mamba2 + the shared block) and its
    2-layer tail (SSM_TRAIN_PARITY), in float32 (seed-0 port init), B 1 x
    T 512, remat on: the loss and every gradient with the kernels
    (gla_scan and gla_scan_bwd; zamba2's flash forward and backward)
    against the plain path (chunked_gla_ref and the plain attention under
    autograd, ``train_grads``) on the same device. Held as train_parity
    holds llama: loss within 1e-4, each gradient within 1e-3 of its leaf's
    largest magnitude. For zamba2 alone, where a leaf misses 1e-3, the
    plain path on float64 params (its GLA and attention in float64)
    decides, as in zamba2_parity: the kernel path's gradient must lie
    within max(1e-3, twice the float32 plain path's distance) of it, each
    over the leaf's largest magnitude (mamba2's chunk decays reach ~-1e4,
    where a float32 unit in the last place of the cumulative log decay is
    ~1e-3: the two float32 paths' sums in other orders part by that much
    before any kernel rounds). On the card the kernel path launches
    ``prefill_launches`` of each model twice (remat) and each backward
    once. ``tiny`` and ``device="cpu"`` rehearse it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = torch.device(device)
    for model, periods in SSM_TRAIN_PARITY.items():
        cfg = cut_config(get_config(model, tiny=tiny), periods=periods)
        lm = LM(cfg)
        batch = [torch.as_tensor(a, device=dev) for a in next(SyntheticLM(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                       global_batch=1, seed=1)).batches())]
        params = lm.init(torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
        reset_counts()
        lk, _, gk = train_grads(lm, params, batch, plain=False)
        counts = launch_counts()
        lp, _, gp = train_grads(lm, params, batch, plain=True)
        gk, gp = tree_leaves(gk), tree_leaves(gp)
        loss_err = abs(float(lk) - float(lp))
        scales = [max(float(b.abs().max()), 1e-30) for b in gp]
        errs = [max_err(a, b) / sc for a, b, sc in zip(gk, gp, scales)]
        finite = all(bool(torch.isfinite(g).all()) for g in gk)
        worst, held = max(errs), "kernels vs plain, tol 1e-3"
        if model == "zamba2-1.2b" and worst > 1e-3:
            p64 = tree_map(lambda t: t.double(), params)
            _, _, g64 = train_grads(lm, p64, batch, plain=True)
            g64 = tree_leaves(g64)
            del p64
            errs = [max_err(a, w) / sc / max(1e-3, 2 * max_err(b, w) / sc)
                    for a, b, w, sc in zip(gk, gp, g64, scales)]
            log(f"  {cfg.name}: kernels vs plain misses 1e-3 ({worst:.3g}); "
                "against the float64 plain path, the kernels' distance over "
                "max(1e-3, twice the float32 plain path's), leaves past 0.1:"
                " " + ", ".join(f"{i} {e:.3g}" for i, e in enumerate(errs)
                                if e > 0.1))
            worst, held = max(errs), "the float64 witness, over its allowance"
            del g64
        log(f"  {cfg.name} f32 B 1 x T 512: loss kernel {float(lk):.6f} vs "
            f"plain {float(lp):.6f} (err {loss_err:.3g}, tol 1e-4); "
            f"gradients: the worst of {len(gk)} leaves {worst:.3g} ({held})"
            f"; launches {({k: v for k, v in counts.items() if v})}")
        assert finite and math.isfinite(float(lk)), model
        assert loss_err <= 1e-4 and worst <= (1e-3 if held.startswith(
            "kernels") else 1), model
        if dev.type == "cuda":
            for kernel, n in prefill_launches(cfg).items():
                assert counts[kernel] == 2 * n, (model, counts)
                assert counts[f"{kernel}_bwd"] == n, (model, counts)
        del params, gk, gp
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def check_wide_train_parity(*, tiny: bool = False, device: str = "cuda",
                            recorder=None, seq: int = None) -> int:
    """The flash backward at head_dim 256 and 192 on the train path:
    gemma2-9b at 2 local/global pairs (T 4608, past its 4096-token
    window), GPT-J-6B at 2 layers (T 512) and deepseek-v3's first dense
    layer alone (T 512: ``mla_forward`` pads qk and v to 192)
    (WIDE_TRAIN_PARITY), full width in float32, B 1, remat on: the loss
    and every gradient with the flash kernels against the plain attention
    under autograd on the same device (``train_grads``). Held on weights
    conditioned for soft attention (``condition_attention``), as
    train_parity: loss within 1e-4, each gradient within 1e-3 of its
    leaf's largest magnitude; reported, not held, with the reference's
    init. On the card the kernel path launches the flash forward twice a
    layer (remat) and its backward once. ``recorder`` (a FlashRecorder)
    keeps deepseek-v3's conditioned kernel call and the gradient at its
    output (the timing phase's row 7mb). Returns deepseek-v3's kernel-path
    backward launches. ``tiny`` and ``device="cpu"`` rehearse it, with
    every sequence ``seq`` long where given."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.utils.tree import tree_leaves
    dev = torch.device(device)
    mla_launches = 0
    for model, (periods, length) in WIDE_TRAIN_PARITY.items():
        length = seq or length
        cfg = cut_config(get_config(model, tiny=tiny), periods=periods)
        lm = LM(cfg)
        batch = [torch.as_tensor(a, device=dev) for a in next(SyntheticLM(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=length,
                       global_batch=1, seed=1)).batches())]
        n = prefill_launches(cfg)["flash_attention"]
        for conditioned in (True, False):
            params = lm.init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.float32, device=dev)
            if conditioned:
                condition_attention(params)
            keep = recorder if conditioned and model == MLA_MODEL \
                and recorder is not None else contextlib.nullcontext()
            reset_counts()
            with keep:
                lk, _, gk = train_grads(lm, params, batch, plain=False)
            counts = launch_counts()
            lp, _, gp = train_grads(lm, params, batch, plain=True)
            gk, gp = tree_leaves(gk), tree_leaves(gp)
            loss_err = abs(float(lk) - float(lp))
            g_rel = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(gk, gp))
            finite = all(bool(torch.isfinite(g).all()) for g in gk)
            name = "conditioned" if conditioned else "reference"
            log(f"  {cfg.name} f32 B 1 x T {length}, {name} init: loss kernel "
                f"{float(lk):.6f} vs plain {float(lp):.6f} (err "
                f"{loss_err:.3g}), gradients: the worst of {len(gk)} leaves "
                f"{g_rel:.3g} of its max"
                f"{' (held: 1e-4, 1e-3)' if conditioned else ' (reported)'}"
                f"; launches {({k: v for k, v in counts.items() if v})}")
            assert finite and math.isfinite(float(lk)), (model, name)
            if conditioned:
                assert loss_err <= 1e-4 and g_rel <= 1e-3, model
            if dev.type == "cuda":
                assert counts["flash_attention"] == 2 * n, (model, counts)
                assert counts["flash_attention_bwd"] == n, (model, counts)
                if model == MLA_MODEL:
                    mla_launches += counts["flash_attention_bwd"]
            del params, gk, gp
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return mla_launches


# ---------------------------------------------------------------------------
# phase 14: full-width training steps
# ---------------------------------------------------------------------------
class FlashRecorder:
    """Keeps, for the timing phase, the q, k and v of a run's flash call
    with the most query rows (the first of equal ones: a train step's
    first call, a prefill's longest sequence) and, where its output takes
    part in a backward, the gradient that reaches it; and counts the
    flash kernel's launches inside its ``with`` blocks (``launches``).
    Wraps the op the model calls and adds nothing to the launch counts."""

    def __init__(self):
        self.args, self.dout = None, None
        self.launches = 0

    def __enter__(self):
        import repro_torch.models.attention as attention
        self._orig = orig = attention.flash_attention_op
        self._start = launch_counts()["flash_attention"]
        rec = self

        def wrapped(q, k, v, **kw):
            out = orig(q, k, v, **kw)
            if rec.args is None or q.shape[3] > rec.args[0].shape[3]:
                kept = rec.args = (q.detach().clone(), k.detach().clone(),
                                   v.detach().clone(), kw)
                rec.dout = None
                if out.requires_grad:
                    def keep(g):
                        if rec.args is kept and rec.dout is None:
                            rec.dout = g.detach().contiguous().clone()
                    out.register_hook(keep)
            return out
        attention.flash_attention_op = wrapped
        return self

    def __exit__(self, *exc):
        import repro_torch.models.attention as attention
        attention.flash_attention_op = self._orig
        self.launches += launch_counts()["flash_attention"] - self._start


def train(recorder, *, model: str = "llama3.2-1b", tiny: bool = False,
          device: str = "cuda", warm: int = 2, timed: int = 8,
          batch: int = 4, seq: int = 2048, lr: float = 3e-3,
          profile: bool = False, profile_seq: int = None,
          periods=None, dtype=None) -> dict:
    """Full-width ``model`` (llama3.2-1b; xlstm_train and zamba2_train: the
    SSM models, SSM_TRAIN; gemma2_train and gptj_train: WIDE_TRAIN), each
    group cut to ``periods`` where given (``cut_config``), through
    make_train_step: params of ``dtype`` (bf16 on the card unless given:
    train_f32 gives float32) from
    seed 0 (the reference's init), float32 AdamW state (peak lr 3e-3 after
    2 warm-up steps, cosine over the run: on the H100, 1e-3 moved the loss
    by ~0.1 in 8 steps, within the batch-to-batch spread, 3e-3 by ~2.7
    and 1e-2 unsteadily), remat on, SyntheticLM(seed=0) batches of
    ``batch`` x ``seq``; ``warm``
    warm-up steps, then ``timed`` timed ones, each ending in a
    synchronize. Fails unless every loss is finite and the last timed
    loss is below the first. Launch counts are set to 0 before the first
    step and read after the last: on the card every kernel of the model's
    layers (``prefill_launches``: flash, gla_scan) launches twice a layer
    a step (remat) and its backward once. ``recorder`` (a FlashRecorder,
    or a GLARecorder keeping gradients) keeps the first call's inputs and
    the gradient at its output for the timing phase. ``profile`` adds one
    more step under torch.profiler (not counted), on a batch of
    ``profile_seq`` tokens a row where given. ``tiny`` and
    ``device="cpu"`` rehearse it in float32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import make_train_step
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = cut_config(get_config(model, tiny=tiny), periods=periods)
    lm = LM(cfg)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if dtype is None:
        dtype = torch.bfloat16 if on_card else torch.float32
    params = lm.init(torch.Generator(device=dev).manual_seed(0),
                     dtype=dtype, device=dev)
    opt = adamw_init(params)
    steps = warm + timed
    step_fn = make_train_step(lm, AdamWConfig(lr=lr, warmup_steps=2,
                                              total_steps=steps))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0)).batches()
    batches = [[torch.as_tensor(a, device=dev) for a in next(data)]
               for _ in range(steps + int(profile))]
    if profile and profile_seq:
        batches[-1] = [t[:, :profile_seq] for t in batches[-1]]
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    log_rows = []
    with recorder:
        for i in range(steps):
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, *batches[i])
            sync()
            dt = time.perf_counter() - t0
            row = {"step": i, "timed": i >= warm, "loss": float(met["loss"]),
                   "grad_norm": float(met["grad_norm"]),
                   "lr": float(met["lr"]), "step_ms": dt * 1e3,
                   "tokens_per_s": batch * seq / dt}
            log_rows.append(row)
            log(f"  {json.dumps(row)}")
    counts = launch_counts()
    timed_rows = [r for r in log_rows if r["timed"]]
    ms = sum(r["step_ms"] for r in timed_rows) / len(timed_rows)
    res = {"model": cfg.name, "dtype": str(dtype)[6:], "steps": steps,
           "batch": batch, "seq": seq,
           "losses": [r["loss"] for r in log_rows],
           "step_ms_mean": ms, "tokens_per_s": batch * seq / ms * 1e3,
           "max_memory_allocated":
               torch.cuda.max_memory_allocated() if on_card else None,
           "launches": counts}
    log(f"  {json.dumps(res)}")
    assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
    assert timed_rows[-1]["loss"] < timed_rows[0]["loss"], res["losses"]
    if on_card:
        # remat: every layer's forward runs twice a step, its backward once
        for kernel, n in prefill_launches(cfg).items():
            assert counts[kernel] == 2 * n * steps, counts
            assert counts[f"{kernel}_bwd"] == n * steps, counts
        assert recorder.args is not None and recorder.dout is not None
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, *batches[steps])
            sync()
            wall = time.perf_counter() - t0
        dev_us, total = log_device_time(
            prof, wall, f"1 train step of {model}, {batch} x "
            f"{batches[steps][0].shape[1]}")
        for kind in ("flash_", "gla_"):
            us = sum(t for key, (t, _) in dev_us.items() if kind in key)
            log(f"  {kind}* kernels: {us / 1e3:.2f} ms = "
                f"{us / max(total, 1e-9):.3f} of device time")
    del params, opt, batches
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return res


def train_f32(recorder, *, tiny: bool = False, device: str = "cuda",
              seq: int = 2048) -> dict:
    """The float32 train path, the train launcher's default dtype:
    llama3.2-1b at full width in float32 through ``train`` (4 x ``seq``,
    remat, lr 3e-3, 2 warm-up and 4 timed steps, one more profiled on the
    card), its checks (finite, falling losses; flash twice a layer a step,
    its backward once), every flash launch a float32 one (the split
    kernels); then ``repro_torch.launch.train.main`` once with its own
    defaults (llama3.2-1b, float32, 8 x 64) for 3 steps, its flash
    launches float32 too. ``recorder`` keeps the first call for rows 7f
    and 7bf. ``tiny`` and ``device="cpu"`` rehearse both (the launcher
    with ``--tiny --device cpu``). Returns train's result, with the
    launcher's launches and seconds."""
    import torch
    from repro_torch.launch import train as launcher
    on_card = device == "cuda"
    res = train(recorder, tiny=tiny, device=device, warm=2, timed=4,
                seq=seq, dtype=torch.float32, profile=on_card)
    counts = res["launches"]
    log(f"  {res['model']} float32: {res['step_ms_mean']:.1f} ms a step, "
        f"{res['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
        f"{res['max_memory_allocated']} B; flash launches "
        f"{counts['flash_attention']} (float32 {counts['flash_attention_f32']}"
        f"), backward {counts['flash_attention_bwd']} (float32 "
        f"{counts['flash_attention_bwd_f32']})")
    if on_card:
        assert counts["flash_attention_f32"] == counts["flash_attention"] > 0
        assert counts["flash_attention_bwd_f32"] == \
            counts["flash_attention_bwd"] > 0
    argv = ["--steps", "3"] + (["--tiny", "--device", "cpu"]
                               if not on_card else [])
    before = launch_counts()
    t0 = time.perf_counter()
    launcher.main(argv)
    if on_card:
        torch.cuda.synchronize()
    res["launcher_s"] = time.perf_counter() - t0
    res["launcher_launches"] = {k: v - before[k] for k, v in
                                launch_counts().items() if v != before[k]}
    log(f"  python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{res['launcher_s']:.1f} s, launches "
        f"{json.dumps(res['launcher_launches'])}")
    if on_card:
        got = res["launcher_launches"]
        assert got.get("flash_attention_f32", 0) == got.get(
            "flash_attention", 0) > 0, got
        assert got.get("flash_attention_bwd_f32", 0) == got.get(
            "flash_attention_bwd", 0) > 0, got
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def expandable_segments():
    """PyTorch's caching allocator with segments that grow in place
    (``expandable_segments``) inside the block, its usual segments again
    after it, the cache emptied on either side. The wide train runs need
    it: gemma2's (8192, 256000) float32 logits (7.8 GiB a tensor) beside
    AdamW's leaves split the usual segments so that at 4 layers a step
    found no room for one of them with 29 GiB cached and free in pieces
    (on an H100 80GB)."""
    import torch
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    gc.collect()
    torch.cuda.empty_cache()
    setting("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        setting("expandable_segments:False")


def log_device_time(prof, wall: float, window: str) -> tuple:
    """Device busy share of a profiled window and device time by kernel;
    returns ({kernel: (us, launches)}, total us)."""
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]
    dev_us = {e.key: (e.self_device_time_total, e.count) for e in rows}
    total = sum(us for us, _ in dev_us.values())
    log(f"  window: {window}, wall {wall * 1e3:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms = {total / 1e6 / wall:.3f} of the window "
        f"(sum of kernel times; streams may overlap)")
    for name, (us, n) in sorted(dev_us.items(), key=lambda kv: -kv[1][0]
                                )[:12]:
        log(f"  {us / 1e3:9.2f} ms {n:7d}x  {us / max(total, 1e-9):.3f}  "
            f"{name[:90]}")
    if total == 0:
        log("  the profiler saw no device time: not measured")
    return dev_us, total


FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"


def flash_row(name, replaces, launches, err, ms, plain_ms, lib_ms, nbytes,
              ops, dtype, shape) -> dict:
    """kernel_row of a flash row. A float32 call's bound counts the split
    kernels' bf16 products (``F32_TERMS`` terms an operand:
    ``split_products`` of each float32 product) at the bf16 peak, with the
    float32-rate figure beside it (``float32_bound_ms``), as row 8's."""
    from repro_torch.kernels.flash_attention import F32_TERMS
    if dtype != "float32":
        return kernel_row(name, FLASH_SRC, replaces, launches, err, ms,
                          plain_ms, lib_ms, nbytes, ops, dtype, shape)
    split = split_products(F32_TERMS, F32_TERMS, F32_TERMS) * ops
    row = kernel_row(name, FLASH_SRC, replaces, launches, err, ms, plain_ms,
                     lib_ms, nbytes, split, "bfloat16", shape)
    row["float32_bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                  ops / PEAK_OPS["float32"]) * 1e3
    log(f"    the split's {split} bf16 products; float32-rate figure "
        f"{row['float32_bound_ms']:.5f} ms ({ops} float32 operations)")
    return row


def flash_fwd_err(name, out, want) -> float:
    """A flash forward's main-path error against its plain version: held
    to one unit in the last place in bf16 (``ulp_err``); in float32
    logged, and held against float64 by ``f64_witness``."""
    import torch
    if out.dtype != torch.float32:
        return ulp_err(name, out, want)
    err = max_err(out, want)
    log(f"  {name} main-path call: max_abs_err {err:.3g} against the plain "
        f"version (max |out| {float(want.abs().max()):.4g})")
    return err


def flash_bwd_err(name, grads, want) -> float:
    """A flash backward's main-path error, the largest of dq, dk and dv:
    held by ``ulp_err`` each in bf16; in float32 logged, and held against
    float64 by ``f64_witness``."""
    import torch
    if grads[0].dtype != torch.float32:
        return max(ulp_err(name, g, w) for g, w in zip(grads, want))
    err = max(max_err(g, w) for g, w in zip(grads, want))
    scale = max(float(w.abs().max()) for w in want)
    log(f"  {name} main-path call: dq/dk/dv max_abs_err {err / scale:.3g} "
        "of their max against the plain version")
    return err


def f64_witness(name, q, k, v, kw, out, lse, do=None, grads=None) -> None:
    """A float32 flash row's main-path call (a bf16 one returns at once:
    ``ulp_err`` holds it) held against a float64 evaluation of the plain
    version on a slice of it (the first batch row and at most two kv
    heads, for memory), as zamba2's parity phases hold theirs: the
    kernels' distance from it (out and lse; or dq, dk and dv over their
    largest magnitude, where ``grads`` are given) within twice the plain
    float32 version's, or within ``check_flash_kernels``' float32
    tolerance, 1e-4, where that is larger. On the reference init's
    hard-max scores (|s| in the hundreds) the plain float32 version lies
    farther from float64 than 1e-4, and the kernels may lie no farther
    than twice that: three bf16 terms an operand, not two."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    if q.dtype != torch.float32:
        return
    cut = (slice(0, 1), slice(0, 2))
    qs, ks, vs = (t[cut].contiguous() for t in (q, k, v))
    o64, l64 = flash_attention_fwd_ref(*(t.double() for t in (qs, ks, vs)),
                                       **kw)

    def dist(a, b):
        return float((a.double() - b).abs().max())
    o32, l32 = flash_attention_fwd_ref(qs, ks, vs, **kw)
    if grads is None:
        got = (dist(out[cut], o64), dist(lse[cut], l64))
        plain = (dist(o32, o64), dist(l32, l64))
        what = "out, lse"
    else:
        dos = do[cut].contiguous()
        g64 = flash_attention_bwd_ref(*(t.double() for t in (
            qs, ks, vs, o64, l64, dos)), **kw)
        sc = max(float(w.abs().max()) for w in g64)
        g32 = flash_attention_bwd_ref(qs, ks, vs, o32, l32, dos, **kw)
        got = (max(dist(g[cut], w) for g, w in zip(grads, g64)) / sc,)
        plain = (max(dist(g, w) for g, w in zip(g32, g64)) / sc,)
        what = "dq/dk/dv over their max"
    allowed = tuple(max(2 * e, 1e-4) for e in plain)
    log(f"  {name} against float64 on batch row 0, kv heads 0-1 ({what}): "
        f"kernel {', '.join(f'{x:.3g}' for x in got)}, plain float32 "
        f"{', '.join(f'{x:.3g}' for x in plain)}; held within "
        f"{', '.join(f'{x:.3g}' for x in allowed)} (twice plain float32's,"
        " at least 1e-4): "
        f"{', '.join(f'{g / a:.3g}' for g, a in zip(got, allowed))} of it")
    assert all(g <= a for g, a in zip(got, allowed)), (name, got, allowed)
    torch.cuda.empty_cache()


def time_flash(recorder: FlashRecorder, worst: dict, launches: dict,
               parent=None, names=("flash_attention", "flash_attention_bwd")
               ) -> list:
    """The flash rows ``names`` (7 and 7b: train's bf16 call; 7f and 7bf:
    train_f32's float32 one): forward and backward kernels, their plain
    versions and the library yardstick (scaled_dot_product_attention with
    is_causal and enable_gqa, forward, and its backward; timed here and
    never on the path), on the inputs of the train step's first attention
    call and the gradient that reached its output. Bound: the visible
    (query, key) pairs' operations (4 hd per pair forward, 10 hd
    backward: five products) at the bf16 tensor-core peak (float32:
    ``flash_row``), against each operand read and each result written
    once. Device time by CUDA graph replays (``device_time``), with
    ``parent`` its forward and backward in turns with these."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref)
    q, k, v, kw = recorder.args
    do = recorder.dout
    B, Hkv, G, T, hd = q.shape
    dtype = str(q.dtype)[6:]
    Tk = k.shape[2]
    mask = torch.ones((T, Tk), dtype=torch.bool, device=q.device).tril(
        Tk - T)
    window = kw.get("window")
    if window is not None:
        mask &= ~torch.ones_like(mask).tril(Tk - T - window)
    pairs = int(mask.sum()) * B * Hkv * G
    esz = q.element_size()
    shape = [B, Hkv, G, T, hd] + ([dtype] if dtype == "float32" else [])
    rows = []

    def row(name, replaces, ms, plain_ms, lib_ms, nbytes, ops, err):
        rows.append(flash_row(name, FLASH_REPLACES[replaces],
                              launches[name], err, ms, plain_ms, lib_ms,
                              nbytes, ops, dtype, shape))
        log(f"    kernel / library {ms / lib_ms:.2f}x")

    fwd = lambda: flash_attention_fwd(q, k, v, **kw)          # noqa: E731
    fwd_plain = lambda: flash_attention_fwd_ref(q, k, v, **kw)  # noqa: E731
    out, lse = fwd()
    err = max(worst[names[0]], flash_fwd_err(names[0], out, fwd_plain()[0]))
    f64_witness(names[0], q, k, v, kw, out, lse)
    ms, plain_ms = in_turns(fwd_plain, fwd, 3)
    q4 = q.reshape(B, Hkv * G, T, hd)
    assert kw.get("window") is None and kw.get("softcap") is None
    lib = lambda: F.scaled_dot_product_attention(              # noqa: E731
        q4, k, v, is_causal=True, enable_gqa=True)
    lib_ms = cuda_ms(lib, 3)
    row(names[0], "flash_attention", ms, plain_ms, lib_ms,
        (2 * q.numel() + 2 * k.numel()) * esz + lse.numel() * 4,
        4 * hd * pairs, err)
    device_time(rows[-1], fwd, parent and (
        lambda: parent.flash(q, k, v, **kw)), 20)

    bwd = lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw)  # noqa
    bwd_plain = lambda: flash_attention_bwd_ref(                 # noqa: E731
        q, k, v, out, lse, do, **kw)
    grads = bwd()
    err = max(worst[names[1]], flash_bwd_err(names[1], grads, bwd_plain()))
    f64_witness(names[1], q, k, v, kw, out, lse, do, grads)
    del grads
    ms, plain_ms = in_turns(bwd_plain, bwd, 3)
    q4r, kr, vr = (t.detach().clone().requires_grad_(True)
                   for t in (q4, k, v))
    out4 = F.scaled_dot_product_attention(q4r, kr, vr, is_causal=True,
                                          enable_gqa=True)
    do4 = do.reshape(out4.shape)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        out4, (q4r, kr, vr), do4, retain_graph=True), 3)
    row(names[1], "flash_attention_bwd", ms, plain_ms, lib_ms,
        (4 * q.numel() + 4 * k.numel()) * esz + lse.numel() * 4,
        10 * hd * pairs, err)
    device_time(rows[-1], bwd, parent and (
        lambda: parent.flash_bwd(q, k, v, out, lse, do, **kw)), 3)
    del out4, q4r, kr, vr
    torch.cuda.empty_cache()
    return rows


def time_hd128_twins(recorder: Recorder, flash_rec: FlashRecorder,
                     parent) -> None:
    """With ``--parent``: the calls of rows 1, 1d, 5 and 7 again at head_dim
    128, a width no model of this run has — the recorded routing,
    contexts and options, with random q and pools (or q, k and v) of the
    same heads and G at head_dim 128 — this tree's kernel and the
    parent's in turns by both measures (``device_time``), logged."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def twin(t):
        return torch.randn((*t.shape[:-1], 128), generator=gen,
                           device="cuda").to(t.dtype)

    def compare(label, fn, old_fn):
        row = {"ms": cuda_ms(fn, 20)}
        log(f"  {label} at head_dim 128:")
        device_time(row, fn, old_fn, 20)

    for label, key, kernel, old in (
            ("row 1", "ragged_paged_attention", ragged_paged_attention,
             parent.ragged),
            ("row 1d", "ragged_paged_attention_decode",
             ragged_paged_attention, parent.ragged),
            ("row 5", "paged_attention", paged_attention, parent.paged)):
        args, kw = recorder.call(key)
        wide = (*(twin(t) for t in args[:3]), *args[3:])
        compare(f"{label} {list(wide[0].shape)}",
                lambda: kernel(*wide, **kw), lambda: old(*wide, **kw))
    q, k, v, kw = flash_rec.args
    q, k, v = (twin(t.cuda()) for t in (q, k, v))
    compare(f"row 7 {list(q.shape)}", lambda: flash_attention_fwd(
        q, k, v, **kw), lambda: parent.flash(q, k, v, **kw))
    del q, k, v
    torch.cuda.empty_cache()


RAGGED_ROW = ("src/repro_torch/kernels/csrc/ragged_paged_attention.cu",
              "src/repro/kernels/ragged_paged_attention.py:105")
PAGED_ROW = ("src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:93")


def time_attention_row(recorder: Recorder, worst: dict, launches: dict,
                       name: str, key: str, paged: bool = False,
                       head_dim: int = None) -> dict:
    """Row ``name``: the ragged kernel (the paged kernel with ``paged``)
    on the call that ``recorder`` kept under ``key``, against its plain
    version (one unit in the last place), launched from the host in turns
    with the plain version (``ms``) and as device time by CUDA graph
    replays (``device_ms``); the bound from the call's data (the pages
    its rows see, 4 hd operations per visible pair); no library call
    computes it. ``head_dim``, where given, is the call's, asserted."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_quant_ref,
        ragged_paged_attention_ref, sm_count, split_count, tile_grid)
    args, kw = recorder.call(key)
    q, kp, bt = args[0], args[1], args[3]
    assert head_dim in (None, q.shape[-1]), (name, q.shape)
    scales = {k: kw.pop(k) for k in ("k_scale", "v_scale") if k in kw}
    if paged:
        kernel, plain, (src, rep) = paged_attention, paged_attention_ref, \
            PAGED_ROW
    else:
        kernel, (src, rep) = ragged_paged_attention, RAGGED_ROW
        plain = ragged_paged_attention_quant_ref if scales \
            else ragged_paged_attention_ref
    plain_args = (*args[:3], *scales.values(), *args[3:])

    def kernel_fn():
        return kernel(*args, **scales, **kw)

    def plain_fn():
        return plain(*plain_args, **kw)
    err = max(worst[name], ulp_err(name, kernel_fn(), plain_fn()))
    ms, plain_ms = in_turns(plain_fn, kernel_fn, 10)
    N, Hkv, G, hd = q.shape
    if paged:
        ctx_lens = args[4]
        tok_seq, tok_pos = torch.arange(N), ctx_lens - 1
        tiles = N
        where = f"ctx {ctx_lens.tolist()}"
    else:
        tok_seq, tok_pos = args[4], args[5]
        tiles = tile_grid(N, G, bt.shape[0])
        where = f"ctx up to {int(tok_pos.max()) + 1}"
    splits = split_count(tiles * Hkv, bt.shape[1] * kp.shape[1],
                         sm_count(0))
    nbytes, ops = ragged_work(q, kp, bt, tok_seq, tok_pos, kw.get("window"))
    row = kernel_row(name, src, rep, launches[name], err, ms, plain_ms,
                     None, nbytes, ops, str(q.dtype)[6:],
                     list(q.shape) + [f"pools {list(kp.shape)} "
                                      f"{str(kp.dtype)[6:]}", where,
                                      f"window {kw.get('window')}",
                                      f"softcap {kw.get('softcap')}",
                                      f"{tiles} tiles x {Hkv} heads x "
                                      f"{splits} splits"])
    row["device_ms"] = graph_ms(kernel_fn, 20)
    row["host_ms"] = ms - row["device_ms"]
    log(f"    device time {row['device_ms']:.4f} ms "
        f"({row['device_ms'] / row['bound_ms']:.1f}x bound), host time "
        f"{row['host_ms']:.4f} ms")
    torch.cuda.synchronize()
    return row


def time_wide(recorder: Recorder, worst: dict, launches: dict) -> list:
    """Rows 1w, 1wd, 1wq and 5w (``time_attention_row``): the ragged
    kernel at gemma2_serve's largest call, at its largest decode-only call
    and at gemma2_quant's largest call (int8 pools), the paged kernel at
    gemma2_unfused's largest call (head_dim 256, gemma2's window 4096 or
    none, softcap 50)."""
    rows = []
    for name, key in (
            ("ragged_paged_attention_hd256", "ragged_paged_attention"),
            ("ragged_paged_attention_hd256_decode",
             "ragged_paged_attention_decode"),
            ("ragged_paged_attention_hd256_int8",
             "ragged_paged_attention_int8"),
            ("paged_attention_hd256", "paged_attention")):
        rows.append(time_attention_row(recorder, worst, launches, name, key,
                                       paged=key == "paged_attention",
                                       head_dim=256))
    return rows


def time_prefill_flash(recorder: FlashRecorder, worst: dict,
                       launches: dict, name: str, iters: int = 3,
                       dtype=None, parent=None) -> list:
    """A flash forward row, ``name``, on the call the recorder kept: 7w
    wide_dense's first gemma2 prefill call (8 x 1024, 8 kv heads x G 2 x
    256, window 4096, softcap 50), 7m the largest call of mla_parity's
    bf16 forward leg (128 heads, G 1, x 192, scale 1 / sqrt(192)), 7p
    pixtral_serve's first prefill call (8 x 1536 rows after the vision
    prefix, 8 kv heads x G 4 x 128). Against its plain version (one unit
    in the last place), and the library yardstick,
    scaled_dot_product_attention with is_causal (and enable_gqa where G >
    1, the call's scale), timed here and never on the path; it has no
    softcap, so on a softcapped call it computes the uncapped function on
    the same inputs. ``ms`` launched from the host, ``device_ms`` by CUDA
    graph replays (``device_time``: with ``parent``, its forward in turns
    with this one). Bound: 4 hd operations per visible pair at the bf16
    peak (float32: ``flash_row``), against each operand read and the
    output and lse written once. ``dtype`` casts the kept call's inputs:
    7mf is row 7m's call in float32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    q, k, v, kw = recorder.args
    q, k, v = (t.to("cuda", dtype) for t in (q, k, v))
    B, Hkv, G, T, hd = q.shape
    Tk = k.shape[2]
    mask = torch.ones((T, Tk), dtype=torch.bool, device=q.device).tril(
        Tk - T)
    if kw.get("window") is not None:
        mask &= ~torch.ones_like(mask).tril(Tk - T - kw["window"])
    pairs = int(mask.sum()) * B * Hkv * G

    def fwd():
        return flash_attention_fwd(q, k, v, **kw)

    def fwd_plain():
        return flash_attention_fwd_ref(q, k, v, **kw)
    out, lse = fwd()
    err = max(worst[name], flash_fwd_err(name, out, fwd_plain()[0]))
    f64_witness(name, q, k, v, kw, out, lse)
    ms, plain_ms = in_turns(fwd_plain, fwd, iters)
    q4 = q.reshape(B, Hkv * G, T, hd)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, is_causal=True, enable_gqa=G > 1, scale=kw.get("scale")),
        iters)
    extra = [f"window {kw['window']}"] if kw.get("window") else []
    extra += [f"softcap {kw['softcap']}"] if kw.get("softcap") else []
    tname = str(q.dtype)[6:]
    extra += [tname] if tname == "float32" else []
    row = flash_row(name, FLASH_REPLACES["flash_attention"], launches[name],
                    err, ms, plain_ms, lib_ms, (2 * q.numel() + 2 * k.numel())
                    * q.element_size() + lse.numel() * 4, 4 * hd * pairs,
                    tname, [B, Hkv, G, T, hd, "causal", *extra])
    device_time(row, fwd, parent and (
        lambda: parent.flash(q, k, v, **kw)), iters)
    log(f"    kernel / library{' (no softcap)' if kw.get('softcap') else ''}"
        f" {ms / lib_ms:.2f}x")
    del q4, out, lse
    torch.cuda.empty_cache()
    return [row]


def time_flash_bwd(recorder: FlashRecorder, worst: dict, launches: dict,
                   name: str, iters: int = 3, parent=None) -> list:
    """A flash backward row, ``name``, on the call the recorder kept and
    the gradient that reached its output: 7wb gemma2_train's first call (1
    x 8192, 8 kv heads x G 2 x 256, window 4096, softcap 50), 7jb
    gptj_train's first call (4 x 2048, 16 kv heads x G 1 x 256), 7mb
    wide_train_parity's deepseek-v3 call (1 x 512, 128 heads x G 1 x 192,
    v zero-padded past 128, scale 1 / sqrt(192), float32). Against its
    plain version (``check_flash_bwd``'s tolerance); ``ms`` launched from
    the host in turns with the plain version, ``device_ms`` by CUDA graph
    replays; the library yardstick, scaled_dot_product_attention's
    backward with is_causal (and enable_gqa where G > 1, the call's
    scale), timed here and never on the path: it has no window and no
    softcap, so on such a call it computes the causal, uncapped function
    on the same inputs. Bound: 10 hd operations a visible pair (five
    products; at 192 the padded width the kernel runs) at the bf16 peak
    (a float32 call: the split's bf16 products, ``flash_row``), against
    each operand read and each gradient written once. A float32 call is
    also timed cast to bf16 (the bf16 kernels), logged with
    SDPA's bf16 backward on the same inputs as its library time. With
    ``parent`` (``parent_kernels``), its ``flash_attention_bwd`` in turns
    with this tree's by both measures (``device_time``), the bf16 cast
    too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd)
    q, k, v, kw = recorder.args
    q, k, v, do = (t.cuda() for t in (q, k, v, recorder.dout))
    B, Hkv, G, T, hd = q.shape
    Tk = k.shape[2]
    mask = torch.ones((T, Tk), dtype=torch.bool, device=q.device).tril(
        Tk - T)
    if kw.get("window") is not None:
        mask &= ~torch.ones_like(mask).tril(Tk - T - kw["window"])
    pairs = int(mask.sum()) * B * Hkv * G
    extra = [f"window {kw['window']}"] if kw.get("window") else []
    extra += [f"softcap {kw['softcap']}"] if kw.get("softcap") else []
    extra += [f"scale {kw['scale']:.6g}"] if kw.get("scale") else []

    def times(q, k, v, do):
        out, lse = flash_attention_fwd(q, k, v, **kw)

        def bwd():
            return flash_attention_bwd(q, k, v, out, lse, do, **kw)

        def old():
            return parent.flash_bwd(q, k, v, out, lse, do, **kw)

        def bwd_plain():
            return flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        rel = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}[q.dtype]
        want = bwd_plain()
        g_abs = [max_err(g, w) for g, w in zip(bwd(), want)]
        scale = max(float(w.float().abs().max()) for w in want)
        del want
        log(f"  {name} {str(q.dtype)[6:]} main-path call: dq/dk/dv "
            f"max_abs_err {max(g_abs) / scale:.3g} of their max (tol "
            f"{rel:.3g})")
        assert max(g_abs) <= rel * scale, name
        ms, plain_ms = in_turns(bwd_plain, bwd, iters)
        return bwd, old if parent else None, max(g_abs), ms, plain_ms, lse

    def sdpa_ms(q, k, v, do):
        q4r, kr, vr = (t.detach().clone().requires_grad_(True)
                       for t in (q.reshape(B, Hkv * G, T, hd), k, v))
        out4 = F.scaled_dot_product_attention(q4r, kr, vr, is_causal=True,
                                              enable_gqa=G > 1,
                                              scale=kw.get("scale"))
        return cuda_ms(lambda: torch.autograd.grad(
            out4, (q4r, kr, vr), do.reshape(out4.shape), retain_graph=True),
            iters)

    bwd, old, err, ms, plain_ms, lse = times(q, k, v, do)
    lib_ms = sdpa_ms(q, k, v, do)
    dtype = str(q.dtype)[6:]
    row = flash_row(name, FLASH_REPLACES["flash_attention_bwd"],
                    launches[name], max(worst[name], err), ms, plain_ms,
                    lib_ms, (4 * q.numel() + 4 * k.numel())
                    * q.element_size() + lse.numel() * 4, 10 * hd * pairs,
                    dtype, [B, Hkv, G, T, hd, "causal", *extra]
                    + ([dtype] if dtype == "float32" else []))
    device_time(row, bwd, old, iters)
    uncapped = kw.get("window") or kw.get("softcap")
    log(f"    device time {row['device_ms']:.4f} ms "
        f"({row['device_ms'] / row['bound_ms']:.1f}x bound); kernel / "
        f"library{' (no window or softcap)' if uncapped else ''} "
        f"{ms / lib_ms:.2f}x")
    if q.dtype == torch.float32:
        # the same call on the tensor-core kernels
        b16 = [t.to(torch.bfloat16) for t in (q, k, v, do)]
        bwd16, old16, _, ms16, plain16, _ = times(*b16)
        row16 = {"ms": ms16}
        device_time(row16, bwd16, old16, iters)
        lib16 = sdpa_ms(*b16)
        bound16 = 10 * hd * pairs / PEAK_OPS["bfloat16"] * 1e3
        dev16 = row16["device_ms"]
        log(f"    the same call cast to bf16: kernel {ms16:.4f} ms, device "
            f"{dev16:.4f} ms ({dev16 / bound16:.1f}x its bf16 bound "
            f"{bound16:.5f} ms), plain {plain16:.4f} ms, library (SDPA's "
            f"bf16 backward) {lib16:.4f} ms, kernel / library "
            f"{ms16 / lib16:.2f}x")
        row.update({f"bf16_{k}": v for k, v in row16.items()})
        row["bf16_library_ms"] = lib16
        del b16, bwd16, old16
    del q, k, v, do, lse, bwd, old
    torch.cuda.empty_cache()
    return [row]


# ---------------------------------------------------------------------------
# the SSM slice: gla_scan, and xlstm-350m through prefill_step/serve_step
# ---------------------------------------------------------------------------
GLA_REPLACES = "src/repro/kernels/gla_scan.py:69"
# the backward has no TPU kernel: the reference differentiates chunked_gla
GLA_BWD_REPLACES = ("src/repro/models/ssm.py:32 (no TPU kernel: XLA's "
                    "autodiff of chunked_gla)")


def gla_inputs(gen, *, B, H, T, dk, dv, dtype, mixed=False,
               broadcast=False, strided=False, strong=0, state=False,
               device="cuda"):
    """q, k, v, log_a (and an initial state) for gla_scan: q, v normal,
    k normal / sqrt(dk), log_a = -|normal| * 0.2 (tests/test_kernels.py's
    decay). ``mixed``: k float32 beside q and v in ``dtype``, as an mLSTM
    call (k times the float32 input gate); ``broadcast``: q and k shared
    by the H heads with stride 0 and v float32, as a Mamba2 call;
    ``strided``: laid out as ``mlstm_forward`` passes them, q and k
    (B, H, T, dk) views of (B, T, H, dk) tensors and v the first dv
    columns of an ``aligned_empty`` buffer, its last column ones;
    ``strong``: log_a = -30 (mLSTM's clamp) over every other chunk of
    ``strong`` steps, from the first."""
    import torch
    from repro_torch.kernels.gla_scan import aligned_empty

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    if broadcast:
        q = randn(B, 1, T, dk).to(dtype).expand(B, H, T, dk)
        k = (randn(B, 1, T, dk) / math.sqrt(dk)).to(dtype).expand(
            B, H, T, dk)
        v = randn(B, H, T, dv)
    elif strided:
        q = randn(B, T, H, dk).to(dtype).transpose(1, 2)
        k = (randn(B, T, H, dk) / math.sqrt(dk)).to(
            torch.float32 if mixed else dtype).transpose(1, 2)
        v = aligned_empty((B, H, T, dv), dtype, device)
        v[..., :-1] = randn(B, T, H, dv - 1).to(dtype).transpose(1, 2)
        v[..., -1] = 1
    else:
        q = randn(B, H, T, dk).to(dtype)
        k = (randn(B, H, T, dk) / math.sqrt(dk)).to(
            torch.float32 if mixed else dtype)
        v = randn(B, H, T, dv).to(dtype)
    la = -randn(B, H, T).abs() * 0.2
    for t0 in range(0, T, 2 * strong) if strong else ():
        la[..., t0:t0 + strong] = -30.0
    s0 = randn(B, H, dk, dv) if state else None
    return q, k, v, la, s0


def gla_rel_err(y, s, want_y, want_s):
    """The largest error of y and of the state, each over its reference's
    largest magnitude."""
    return (max_err(y, want_y) / max(float(want_y.float().abs().max()),
                                     1e-30),
            max_err(s, want_s) / max(float(want_s.abs().max()), 1e-30))


def gla_bwd_errors(label, got, want, dtypes) -> float:
    """The gla backward's gradients (dq, dk, dv, d log_a, the initial
    state's) against the plain backward's, that rounded as the kernel's
    output is, each over its largest magnitude: a bf16 gradient within
    one bf16 unit in the last place (2^-7: each side rounds a float32
    result once), a float32 one within 1e-4 (float32 sums in another
    order); d log_a, float32 always, within 1e-4 with three terms (a
    float32 v) and 5e-4 with two (a bf16 v: the reverse sum over T of
    q . dq - k . dk from products ~1e-5 off); the initial state's within
    1e-4. Logs them, fails past a tolerance or on a non-finite value, and
    returns the largest absolute error. ``dtypes``: q's, k's and v's
    names."""
    import torch
    two_terms = dtypes[2] == "bfloat16"
    worst, parts = 0.0, []
    for i, (name, g, w) in enumerate(zip(
            ("dq", "dk", "dv", "dlog_a", "dinitial_state"), got, want)):
        if w is None:
            assert g is None, (label, name)
            continue
        w = w.to(g.dtype)
        tol = (2.0 ** -7 if i < 3 and dtypes[i] == "bfloat16"
               else 5e-4 if i == 3 and two_terms else 1e-4)
        err = max_err(g, w)
        rel = err / max(float(w.float().abs().max()), 1e-30)
        parts.append(f"{name} {rel:.3g} (tol {tol:.3g})")
        assert bool(torch.isfinite(g).all()) and rel <= tol, (label, name,
                                                               rel)
        worst = max(worst, err)
    log(f"  {label}: " + ", ".join(parts))
    return worst


def check_gla_kernels(gen, worst) -> None:
    """gla_scan against chunked_gla_ref on the card: the reference grid
    (tests/test_kernels.py's shapes and chunks) in float32 and bf16, the
    tiny xLSTM's mLSTM shape (dk 256, dv 257, chunk 64) and the full-width
    one (B 2, H 4, T 2000, dk 512, dv 513, chunk 256) with float32 k
    beside bf16 q and v, also laid out as ``mlstm_forward`` passes them
    (read in place: no copy), with log_a at mLSTM's clamp over whole
    chunks and with an initial state; a Mamba2 call (zamba2's widths: H 8,
    dk 64, dv 512, stride-0 q and k, float32 v), a carried initial state
    and dk 8 with chunks of 5. Held relative to the largest |y| and |S|:
    1e-4 for float32 results (float32 sums in another order), 2^-7 for a
    bf16 y (both round one float32 result once: a unit in the last
    place). Then the backward, gla_scan_bwd against chunked_gla_bwd_ref on
    every case, with a final-state gradient where the case has an initial
    state (and on mLSTM and Mamba2 cases at the train phases' widths with
    one alone), at ``gla_bwd_errors``' tolerances: the operands as the
    cases lay them out (mLSTM's strided q and k and padded v, Mamba2's
    stride-0 q and k), bf16 and float32, T off the chunk, strong decay."""
    import torch
    from repro_torch.kernels.gla_scan import (aligned, chunked_gla_bwd_ref,
                                              chunked_gla_ref, gla_scan_bwd,
                                              gla_scan_fwd)
    grid = [(2, 2, 64, 16, 16, 16), (1, 4, 128, 32, 64, 32),
            (2, 1, 256, 64, 64, 128), (1, 2, 96, 16, 16, 32)]
    cases = [(f"grid B{b} H{h} T{t} dk{dk} dv{dv} c{c}", dtype,
              dict(B=b, H=h, T=t, dk=dk, dv=dv), c, {})
             for dtype in (torch.bfloat16, torch.float32)
             for b, h, t, dk, dv, c in grid]
    bf16 = torch.bfloat16
    cases += [
        ("tiny mLSTM", bf16, dict(B=2, H=2, T=130, dk=256, dv=257), 64,
         dict(mixed=True)),
        ("mLSTM full width", bf16, dict(B=2, H=4, T=2000, dk=512, dv=513),
         256, dict(mixed=True)),
        ("mLSTM full width, initial state", bf16,
         dict(B=2, H=4, T=700, dk=512, dv=513), 256,
         dict(mixed=True, state=True)),
        ("Mamba2 zamba2 widths", bf16, dict(B=2, H=8, T=1000, dk=64,
                                            dv=512), 256,
         dict(broadcast=True)),
        ("float32 T off the chunk, initial state", torch.float32,
         dict(B=2, H=2, T=333, dk=64, dv=40), 128, dict(state=True)),
        ("mLSTM operands as mlstm_forward passes them", bf16,
         dict(B=2, H=4, T=2000, dk=512, dv=513), 256,
         dict(mixed=True, strided=True)),
        ("strong decay: log_a -30 over whole chunks", bf16,
         dict(B=2, H=4, T=1300, dk=512, dv=513), 256,
         dict(mixed=True, strided=True, strong=256)),
        ("mLSTM full width T 2000, initial state", bf16,
         dict(B=2, H=4, T=2000, dk=512, dv=513), 256,
         dict(mixed=True, strided=True, state=True)),
        ("mLSTM as xlstm_train lays it out, final-state gradient", bf16,
         dict(B=4, H=4, T=1024, dk=512, dv=513), 256,
         dict(mixed=True, strided=True, dstate=True)),
        ("Mamba2 zamba2 widths, T off the chunk, final-state gradient",
         bf16, dict(B=2, H=8, T=2000, dk=64, dv=512), 256,
         dict(broadcast=True, dstate=True)),
        ("Mamba2 initial state", bf16, dict(B=2, H=8, T=700, dk=64,
                                            dv=512), 256,
         dict(broadcast=True, state=True))]
    cases += [("dk 8, chunk 5", dtype, dict(B=2, H=3, T=37, dk=8, dv=12), 5,
               {}) for dtype in (torch.float32, bf16)]
    for label, dtype, shape, c, kw in cases:
        kw = dict(kw)
        dstate = kw.pop("dstate", kw.get("state", False))
        q, k, v, la, s0 = gla_inputs(gen, dtype=dtype, **shape, **kw)
        if kw.get("strided"):
            assert all(aligned(t) for t in (q, k, v)), label
        y, s = gla_scan_fwd(q, k, v, la, chunk=c, initial_state=s0)
        want_y, want_s = chunked_gla_ref(q, k, v, la, c, s0)
        torch.cuda.synchronize()
        ey, es = gla_rel_err(y, s, want_y, want_s)
        tol_y = 2.0 ** -7 if y.dtype == bf16 else 1e-4
        log(f"  gla_scan {label} ({str(dtype)[6:]}): y max_abs_err "
            f"{ey:.3g} of its max (tol {tol_y:.3g}), state {es:.3g} (tol "
            f"1e-4)")
        assert y.dtype == v.dtype and s.dtype == torch.float32, label
        assert ey <= tol_y and es <= 1e-4, label
        worst["gla_scan"] = max(worst["gla_scan"], max_err(y, want_y),
                                max_err(s, want_s))
        del y, s, want_y, want_s
        dy = torch.randn(v.shape, generator=gen, device=v.device).to(
            v.dtype)
        ds = torch.randn((*q.shape[:2], q.shape[-1], v.shape[-1]),
                         generator=gen, device=v.device) if dstate else None
        before = gla_scan_bwd.launches
        got = gla_scan_bwd(q, k, v, la, dy, chunk=c, initial_state=s0,
                           dstate=ds)
        want = chunked_gla_bwd_ref(q, k, v, la, c, s0, dy, ds)
        torch.cuda.synchronize()
        assert gla_scan_bwd.launches == before + 1, label
        assert [g.dtype for g in got[:3]] == [q.dtype, k.dtype, v.dtype]
        row = "gla_scan_bwd_zamba2" if kw.get("broadcast") else \
            "gla_scan_bwd"
        worst[row] = max(worst[row], gla_bwd_errors(
            f"gla_scan_bwd {label} ({str(dtype)[6:]}"
            f"{', final-state gradient' if dstate else ''})", got, want,
            [str(t.dtype)[6:] for t in (q, k, v)]))
        del q, k, v, la, s0, dy, ds, got, want
    torch.cuda.empty_cache()


def ssm_steps(cfg, params, tokens, n_steps: int):
    """prefill_step over tokens (B, T), then ``n_steps`` greedy serve_step
    calls, the first fed the prefill's argmax at position T. Returns
    (prefill logits, its cache, [each step's logits], the fed tokens
    (B, n_steps + 1), the last cache)."""
    import torch
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    T = tokens.shape[1]
    _, prefill = build_prefill_step(cfg, T)
    _, serve_step = build_serve_step(cfg)
    logits, cache = prefill(params, tokens)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    fed, step_logits, last = [tok], [], cache
    for i in range(n_steps):
        pos = torch.full_like(tok, T + i)
        lg, tok, last = serve_step(params, last, tok, pos)
        step_logits.append(lg)
        fed.append(tok)
    return logits, cache, step_logits, torch.stack(fed, dim=1), last


def cache_rel_err(got, want) -> float:
    """The largest error of any cache leaf over that leaf's largest
    magnitude."""
    from repro_torch.utils.tree import tree_leaves
    return max(max_err(a.cpu(), b.cpu()) / max(float(b.float().abs().max()),
                                                1e-30)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def check_tiny_ssm(device: str = "cuda") -> None:
    """Tiny xlstm-350m in float32, seed-0 port init: prefill_step over
    B 2 x T 100 (the chunk of 64 padded) and 8 greedy serve_step calls on
    ``device`` (the kernel) and on the CPU (the plain version), from the
    same weights and tokens. Held: logits within 1e-4 of the largest
    |logit| and every cache leaf within 1e-4 of its largest magnitude
    (float32 sums in another order), greedy tokens equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_map
    cfg = get_config("xlstm-350m", tiny=True)
    gen = torch.Generator().manual_seed(0)
    params = LM(cfg).init(gen, dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen,
                           dtype=torch.int32)
    to_dev = lambda t: t.to(device)                            # noqa: E731
    reset_counts()
    dev_out = ssm_steps(cfg, tree_map(to_dev, params), to_dev(tokens), 8)
    launches = launch_counts()["gla_scan"]
    cpu_out = ssm_steps(cfg, params, tokens, 8)
    scale = float(cpu_out[0].abs().max())
    err = max(max_err(a.cpu(), b) for a, b in zip(
        [dev_out[0]] + dev_out[2], [cpu_out[0]] + cpu_out[2])) / scale
    c_err = max(cache_rel_err(dev_out[1], cpu_out[1]),
                cache_rel_err(dev_out[4], cpu_out[4]))
    same = bool(torch.equal(dev_out[3].cpu(), cpu_out[3]))
    log(f"  tiny xlstm prefill + 8 serve steps on {device}: logits "
        f"max_abs_err {err:.3g} of their max (tol 1e-4), cache leaves "
        f"{c_err:.3g} (tol 1e-4), greedy tokens equal: {same}; gla_scan "
        f"launches {launches}")
    assert err <= 1e-4 and c_err <= 1e-4 and same
    if device == "cuda":
        assert launches == 1, launches


def plain_prefill(cfg, params, tokens, prefix=None, *, plain,
                  cache_len: int = None):
    """prefill_step (``cache_len`` slots, by default the sequence's
    length) with the kernels, or with the plain GLA and the plain attention
    (the oracles of the prefill, on any device) in their places for the
    call (on float64 params the plain GLA works in float64)."""
    import repro_torch.models.attention as attention
    import repro_torch.models.ssm as ssm
    from repro_torch.kernels.gla_scan import chunked_gla_ref
    from repro_torch.launch.steps import build_prefill_step
    P = 0 if prefix is None else prefix.shape[1]
    _, prefill = build_prefill_step(cfg, cache_len or P + tokens.shape[1])
    orig = ssm.chunked_gla, attention.flash_attention_op
    if plain:
        ssm.chunked_gla = chunked_gla_ref
        attention.flash_attention_op = plain_attention()
    try:
        return prefill(params, tokens, prefix)
    finally:
        ssm.chunked_gla, attention.flash_attention_op = orig


# the models of the prefill parity phases: (model, depth per group, None
# uncut; whether the attention weights are conditioned for soft attention,
# condition_attention; whether a float64 witness may decide a leaf that
# misses 1e-3) at full width in float32
PREFILL_PARITY = {"ssm_parity": ("xlstm-350m", None, False, False),
                  # 2 x (5 mamba2 + the shared block) + 1 mamba2: two
                  # occurrences of one shared attention block; mamba2's
                  # chunk decays reach ~-1e4, where a float32 ulp is ~1e-3
                  "zamba2_parity": ("zamba2-1.2b", (2, 1), False, True),
                  # pixtral's 32 heads over 1088 positions: on the init's
                  # hard-max attention float32 rounding flips near-ties (on
                  # an H100 the raw init's kernel and plain logits part by
                  # 9.5e-3, the decode continuation by 4.7e-2), as on
                  # decode_parity's legs
                  "pixtral_parity": ("pixtral-12b", (4,), True, False)}


def parity_errors(got, want, witness=None) -> list:
    """(name, error) of a prefill's logits and of every cache leaf, each
    over the leaf's largest magnitude in ``want``: ``got``'s distance from
    ``want``; with ``witness``, ``got``'s distance from the witness over
    its allowance, max(1e-3, twice ``want``'s own distance from it)."""
    from repro_torch.utils.tree import tree_leaves

    def leaves(out):
        return [out[0]] + tree_leaves(out[1])
    ws = leaves(witness) if witness is not None else [None] * len(
        leaves(got))
    out = []
    for i, (a, b, w) in enumerate(zip(leaves(got), leaves(want), ws)):
        name = "logits" if i == 0 else f"cache leaf {i - 1}"
        a, b = a.cpu(), b.cpu()
        scale = max(float(b.float().abs().max()), 1e-30)
        if w is None:
            out.append((name, max_err(a, b) / scale))
        else:
            w = w.cpu()
            allowance = max(1e-3, 2 * max_err(b, w) / scale)
            out.append((name, max_err(a, w) / scale / allowance))
    return out


def check_prefill_parity(phase: str = "ssm_parity", *, tiny: bool = False,
                         device: str = "cuda", batch: int = 2,
                         seq: int = None) -> None:
    """A PREFILL_PARITY model in float32 (seed-0 port init; pixtral after
    its vision prefix, ``model_prefix``), B 2 x T (520 tokens; pixtral 64
    after 1024 prefix rows), on the card: the prefill's logits and every
    cache leaf (SSM final states, attention K/V) with the kernels
    (gla_scan, flash) against the same with the plain chunked_gla_ref and
    the plain attention in their places, held within 1e-3 of the largest
    |logit| and of each leaf's largest magnitude (float32 sums in other
    orders through every layer; pixtral on weights conditioned for soft
    attention, as decode_parity). For zamba2 alone, where a leaf misses
    that, the plain path on float64 params (its GLA and attention in
    float64) decides: the kernels' value must lie within 1e-3 of it, or no
    farther from it than twice the plain float32 path's (the float32
    chunked form's own rounding: mamba2's decays take the cumulative log
    decay of a 256-step chunk to ~-1e4, where a unit in the last place is
    ~1e-3, so the two float32 paths' differently ordered sums part by that
    much). Then decode continuation:
    serve_step at position P + T after that prefill against the last
    logits of a P + T + 1 prefill, held within 1e-3 of the largest |logit|
    (a step recurrence and the gather attention against the chunked form
    and flash). On the card the kernel prefill launches
    ``prefill_launches`` of the model and nothing else. ``tiny`` and
    ``device="cpu"`` rehearse it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_map
    model, periods, conditioned, witness = PREFILL_PARITY[phase]
    dev = torch.device(device)
    cfg = cut_config(get_config(model, tiny=tiny), periods=periods)
    if seq is None:
        seq = 64 if cfg.vision_prefix_len else 520
    gen = torch.Generator(device=dev).manual_seed(0)
    params = LM(cfg).init(gen, dtype=torch.float32, device=dev)
    if conditioned:
        condition_attention(params)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    prefix = model_prefix(cfg, params, batch, gen)
    P = 0 if prefix is None else prefix.shape[1]
    n = P + seq + 1
    reset_counts()
    kern = plain_prefill(cfg, params, tokens[:, :seq], prefix, plain=False,
                         cache_len=n)
    launches = {k: v for k, v in launch_counts().items() if v}
    plain = plain_prefill(cfg, params, tokens[:, :seq], prefix, plain=True,
                          cache_len=n)
    errs = parity_errors(kern, plain)
    worst = max(errs, key=lambda e: e[1])
    held, limit = "kernels vs plain", 1e-3
    if witness and worst[1] > limit:
        # the float64 witness of the plain path
        p64 = tree_map(lambda t: t.double(), params)
        w64 = plain_prefill(cfg, p64, tokens[:, :seq],
                            None if prefix is None else prefix.double(),
                            plain=True, cache_len=n)
        del p64
        w_errs = parity_errors(kern, plain, w64)
        log(f"  kernels vs plain misses 1e-3 at {worst[0]} ({worst[1]:.3g}): "
            "against the float64 plain path, the kernels' distance over "
            "max(1e-3, twice the float32 plain path's): " + ", ".join(
                f"{name} {e:.3g}" for name, e in w_errs if e > 0.1))
        worst = max(w_errs, key=lambda e: e[1])
        held, limit = "kernels vs the float64 witness, over its allowance", 1
        del w64
    lk, ck = kern
    scale = float(plain[0].abs().max())
    _, serve_step = build_serve_step(cfg)
    step_logits, _, _ = serve_step(params, ck, tokens[:, seq],
                                   torch.full((batch,), P + seq, device=dev,
                                              dtype=torch.int32))
    l_next, _ = plain_prefill(cfg, params, tokens, prefix, plain=False,
                              cache_len=n)
    c_gap = max_err(step_logits, l_next) / float(l_next.abs().max())
    finite = bool(torch.isfinite(lk).all() and torch.isfinite(plain[0]).all())
    log(f"  {cfg.name}{' (conditioned)' if conditioned else ''}: prefill "
        f"B {batch} x "
        f"{f'(prefix {P} + ' if P else '('}{seq} tokens): kernels vs plain, "
        f"over each one's max: logits {errs[0][1]:.3g} (max {scale:.4g}), "
        f"cache leaves {max(e for _, e in errs[1:]):.3g}; held "
        f"({held}, tol {limit:g}): worst {worst[0]} {worst[1]:.3g}; decode "
        f"at {P + seq} vs a {P + seq + 1}-row prefill {c_gap:.3g} of the "
        f"max logit (tol 1e-3); launches {launches} (expected "
        f"{prefill_launches(cfg)})")
    assert finite and c_gap <= 1e-3 and worst[1] <= limit, worst
    if dev.type == "cuda":
        # a float32 prefill: every flash launch a float32 one
        f32 = launches.pop("flash_attention_f32", 0)
        assert f32 == launches.get("flash_attention", 0), (f32, launches)
        assert launches == prefill_launches(cfg), launches
    del params, kern, plain, ck, prefix
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class GLARecorder:
    """Keeps, for the timing phase, the inputs of the first gla_scan call
    of a run (the first mLSTM or mamba2 layer's) and, with ``grad`` (a
    train run), the gradients that reach its y and final state in the
    backward (``dout``: (dy, dstate), None where none reached it): wraps
    the op the model calls and adds nothing to the launch counts. The
    tensors are kept by reference during the run (nothing writes them
    after the call) and move to host memory on leaving, so later phases'
    peaks do not carry them; a dimension of stride 0 (mamba2's q and k,
    views over the heads) moves as one slice. ``operands()`` brings the
    inputs back to their device with those dimensions broadcast again,
    ``grads()`` the gradients."""

    def __init__(self, grad: bool = False):
        self.grad = grad
        self.args = self.dout = None

    def __enter__(self):
        import repro_torch.kernels.ops as ops
        self.args = self.dout = None
        self._seen = {}
        self._orig = orig = ops.gla_scan_op

        def wrapped(q, k, v, log_a, **kw):
            out = orig(q, k, v, log_a, **kw)
            if self.args is None:
                self.args = (q, k, v, log_a, kw)
                if self.grad and out[0].requires_grad:
                    self._hook(out)
            return out
        ops.gla_scan_op = wrapped
        return self

    def _hook(self, out):
        """Keep the gradients that reach ``out`` (y, state) in the backward
        through them (one: the hooks sit on the first step's graph); an
        output that no gradient reached gets None."""
        def keep(i):
            def hook(g):
                if g is not None and i not in self._seen:
                    self._seen[i] = g.detach().clone()
            return hook
        for i, t in enumerate(out):
            if t.requires_grad:
                t.register_hook(keep(i))

    def __exit__(self, *exc):
        import repro_torch.kernels.ops as ops
        from repro_torch.utils.tree import tree_map
        ops.gla_scan_op = self._orig
        if 0 in self._seen:
            self.dout = (self._seen[0], self._seen.get(1))
        self._seen = {}

        def to_host(t):
            if not hasattr(t, "stride"):
                return t
            slice_ = t
            for dim, st in enumerate(t.stride()):
                if st == 0:
                    slice_ = slice_.narrow(dim, 0, 1)
            return slice_.detach().cpu(), tuple(t.shape), t.device
        self.args = tree_map(to_host, self.args)
        self.dout = tree_map(to_host, self.dout)

    @staticmethod
    def _back(t):
        if isinstance(t, tuple):
            slice_, shape, device = t
            return slice_.to(device).expand(shape)
        return t

    def operands(self):
        """(q, k, v, log_a, kw) as recorded, on their device."""
        *ts, kw = self.args
        return (*map(self._back, ts),
                {k: self._back(v) for k, v in kw.items()})

    def grads(self):
        """(dy, dstate or None) as recorded, on their device."""
        return tuple(None if g is None else self._back(g)
                     for g in self.dout)


# the kernel that each block kind launches once a prefill (sLSTM's loop
# and every decode step launch none)
PREFILL_KERNEL = {"mlstm": "gla_scan", "mamba2": "gla_scan",
                  "attn": "flash_attention", "shared_attn": "flash_attention"}


def prefill_launches(cfg) -> dict:
    """{kernel: launches} of one prefill of ``cfg``: a launch for every
    layer of a block kind in PREFILL_KERNEL, and no other launch."""
    out = {}
    for g in cfg.groups:
        for blk in g.period:
            kernel = PREFILL_KERNEL.get(blk.kind)
            if kernel is not None:
                out[kernel] = out.get(kernel, 0) + g.n_periods
    return out


def model_prefix(cfg, params, batch: int, gen):
    """pixtral's stand-in for its vision encoder: (batch,
    cfg.vision_prefix_len, d) patch embeddings from ``gen``, normal at the
    token embeddings' standard deviation, in their dtype; None for a
    model without a prefix."""
    import torch
    if not cfg.vision_prefix_len:
        return None
    emb = params["embed"]
    scale = float(emb[:4096].float().std())
    return (torch.randn((batch, cfg.vision_prefix_len, cfg.d_model),
                        generator=gen, device=emb.device) * scale).to(
        emb.dtype)


# the serve-step phases: the model served at full width, the prompt
# length, the greedy steps, whether the decode cache has slots (attention
# blocks; an SSM state has none), the serve steps profiled after the
# prefill in the profile phase (the profiler's own parse takes ~1 s for
# each llama step), and the profiled prefill's length where it is cut
# (the xlstm prefill's sLSTM loop launches ~50 kernels a step, which the
# profiler's parse pays for). Every layer of PREFILL_KERNEL's block kinds
# launches its kernel once a prefill (``prefill_launches``); pixtral's
# prompts follow its vision prefix (``model_prefix``)
MODEL_SERVES = {
    "ssm_serve": dict(model="xlstm-350m", seq=2000, steps=16, slots=False,
                      profile_steps=0, profile_seq=256),
    "dense_serve": dict(model="llama3.2-1b", seq=1024, steps=32, slots=True,
                        profile_steps=8),
    # gemma2's 42 layers alternate a local (window 4096) and a global
    # layer, both with softcap 50: one flash launch a layer a prefill
    "wide_dense": dict(model="gemma2-9b", seq=1024, steps=8, slots=True,
                       profile_steps=8),
    # zamba2: 32 mamba2 layers (gla_scan) and 6 occurrences of its one
    # shared attention block (flash), each with its own slotted cache
    "zamba2_serve": dict(model="zamba2-1.2b", seq=2000, steps=32,
                         slots=True, profile_steps=8),
    # pixtral: a (8, 1024, 5120) vision prefix, then the prompt's tokens;
    # not profiled
    "pixtral_serve": dict(model="pixtral-12b", seq=512, steps=32,
                          slots=True, profile_steps=0, profile_seq=0)}


def model_serve(phase: str, recorder=None, *, tiny: bool = False,
                device: str = "cuda", batch: int = 8, seq: int = None,
                steps: int = None, profile: bool = False) -> dict:
    """A model of MODEL_SERVES served through prefill_step and greedy
    serve_step: bf16 weights from the port's seed-0 init, ``batch``
    prompts of ``seq`` random tokens (seed 0), after the model's vision
    prefix where it has one. A warm-up prefill (which ``recorder``, if
    any, watches) and serve step, then the timed prefill and ``steps``
    serve steps, each timed to a synchronize. Launch counts are set to 0
    before the timed prefill and read after the last step: they must be
    ``prefill_launches`` of the model, and nothing else. Fails unless
    every logit is finite. ``profile`` adds one more prefill (of the
    phase's ``profile_seq`` tokens where given; 0: none), and the phase's
    ``profile_steps`` more serve steps, under torch.profiler. The seconds
    of each part are logged as ``stamps``. ``tiny`` and ``device="cpu"``
    rehearse it in float32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.model import LM
    spec = MODEL_SERVES[phase]
    seq = spec["seq"] if seq is None else seq
    steps = spec["steps"] if steps is None else steps
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config(spec["model"], tiny=tiny)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    stamps, t_last = {}, [time.perf_counter()]

    def stamp(name):
        sync()
        now = time.perf_counter()
        stamps[name] = now - t_last[0]
        t_last[0] = now
    gen = torch.Generator(device=dev).manual_seed(0)
    params = LM(cfg).init(gen, dtype=torch.bfloat16 if on_card
                          else torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    prefix = model_prefix(cfg, params, batch, gen)
    P = 0 if prefix is None else prefix.shape[1]
    expected = prefill_launches(cfg)
    n_prof = spec["profile_steps"] if profile else 0
    n_slots = P + seq + steps + n_prof if spec["slots"] else seq
    _, prefill = build_prefill_step(cfg, n_slots)
    _, serve_step = build_serve_step(cfg)
    pos = torch.full((batch,), P + seq, device=dev, dtype=torch.int32)
    stamp("construction")
    with recorder if recorder is not None else contextlib.nullcontext():
        logits, cache = prefill(params, tokens, prefix)
    serve_step(params, cache, torch.argmax(logits, dim=-1).to(torch.int32),
               pos)
    del logits, cache
    stamp("warm_up")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, prefix)
    sync()
    t1 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    fed, step_logits = [tok], []
    for i in range(steps):
        lg, tok, cache = serve_step(params, cache, tok, pos + i)
        step_logits.append(lg)
        fed.append(tok)
    sync()
    t2 = time.perf_counter()
    counts = launch_counts()
    stamps["prefill"], stamps["steps"] = t1 - t0, t2 - t1
    t_last[0] = t2
    fed = torch.stack(fed, dim=1)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in step_logits)
    prefill_s, decode_s = t1 - t0, t2 - t1
    res = {"model": cfg.name, "batch": batch, "prefix": P, "seq": seq,
           "steps": steps, "prefill_s": prefill_s,
           "prefill_tokens_per_s": batch * (P + seq) / prefill_s,
           "decode_s": decode_s,
           "decode_ms_per_step": decode_s / max(steps, 1) * 1e3,
           "decode_tokens_per_s": batch * steps / max(decode_s, 1e-9),
           "max_memory_allocated":
               torch.cuda.max_memory_allocated() if on_card else None,
           "finite": finite, "first_tokens": fed[0, :8].tolist(),
           "launches": counts, "expected_launches": expected}
    log(f"  {json.dumps(res)}")
    assert finite, "non-finite logits"
    assert fed.shape == (batch, steps + 1)
    assert 0 <= int(fed.min()) and int(fed.max()) < cfg.vocab_size
    assert recorder is None or recorder.args is not None
    if on_card:
        assert {k: v for k, v in counts.items() if v} == expected, counts
    n_prof_seq = min(spec.get("profile_seq", seq), seq) if profile else 0
    if n_prof_seq:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with prof_ctx(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill(params, tokens[:, :n_prof_seq], prefix)
            sync()
            wall = time.perf_counter() - t0
        dev_us, total = log_device_time(
            prof, wall, f"1 prefill of {batch} x {n_prof_seq}"
            + (f" after a prefix of {P}" if P else ""))
        for kernel in expected:
            mine = [v for k, v in dev_us.items()
                    if kernel.split("_")[0] + "_" in k]
            log(f"  {kernel}'s kernels: "
                f"{sum(us for us, _ in mine) / 1e3:.2f} ms over "
                f"{sum(n for _, n in mine)} launches = "
                f"{sum(us for us, _ in mine) / max(total, 1e-9):.3f} of "
                f"device time")
        stamp("profiled_prefill")
    if n_prof:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with prof_ctx(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(n_prof):
                _, tok, cache = serve_step(params, cache, tok,
                                           pos + steps + i)
            sync()
            wall = time.perf_counter() - t0
        log_device_time(prof, wall, f"{n_prof} serve steps of {batch}")
        # the host side of the decode window: the ops that took the most
        # CPU time of their own
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        for e in ops[:8]:
            log(f"  host {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x"
                f"  {e.key[:80]}")
        stamp("profiled_steps")
    del params, cache, logits, step_logits, prefix
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    stamp("teardown")
    res["stamps"] = stamps
    log(f"  stamps (s): " + ", ".join(f"{k} {v:.2f}"
                                      for k, v in stamps.items()))
    return res


def gla_ops(shape, dv: int, chunk: int, with_state: bool) -> int:
    """The operations the chunked GLA must do on inputs of ``shape``
    (B, H, T, dk): per (b, h) and chunk of r real steps, the causal half
    of the intra-chunk scores, r (r + 1) / 2 pairs at dk multiply-adds
    each and as many at dv for the scores times v, then r dk dv each for
    q S (none on the first chunk when the state starts at zero) and for
    the state update; two operations per multiply-add."""
    B, H, T, dk = shape
    ops = 0
    for t0 in range(0, T, chunk):
        r = min(chunk, T - t0)
        inter = 0 if (t0 == 0 and not with_state) else r * dk * dv
        ops += 2 * B * H * (r * (r + 1) // 2 * (dk + dv) + inter
                            + r * dk * dv)
    return ops


def split_products(a, b, terms) -> int:
    """The bf16 tensor-core products gla_scan takes for one product of two
    operands held as ``a`` and ``b`` terms (1 for a bf16 operand,
    ``terms`` for a float32 one): the term pairs whose indexes sum below
    ``terms``."""
    return sum(i + j < terms for i in range(a) for j in range(b))


def gla_tc_ops(shape, dv: int, chunk: int, with_state: bool,
               dtypes: tuple) -> int:
    """gla_ops' work as the kernel's bf16 tensor-core products: each of the
    four products (q k^T, P v, q S, the decayed k^T v) times
    ``split_products`` of its operands. ``dtypes``: q's, k's and v's; a
    float32 operand (the scores P, the state S and the decayed k always)
    is held as the kernel's terms for v's dtype (``TERMS``)."""
    import torch
    from repro_torch.kernels.gla_scan import TERMS
    B, H, T, dk = shape
    nt = TERMS[dtypes[2]]
    tq, tk, tv = (1 if d == torch.bfloat16 else nt for d in dtypes)
    ops = 0
    for t0 in range(0, T, chunk):
        r = min(chunk, T - t0)
        inter = 0 if (t0 == 0 and not with_state) else r * dk * dv
        pairs = r * (r + 1) // 2
        ops += 2 * B * H * (
            pairs * dk * split_products(tq, tk, nt)
            + pairs * dv * split_products(nt, tv, nt)
            + inter * split_products(tq, nt, nt)
            + r * dk * dv * split_products(nt, tv, nt))
    return ops


def stored_bytes(t) -> int:
    """The bytes a kernel must read of ``t``: a dimension of stride 0 (a
    broadcast view) adds none."""
    return t.element_size() * math.prod(
        n for n, st in zip(t.shape, t.stride()) if st != 0)


def time_gla(recorder: GLARecorder, worst: dict, launches: dict,
             parent=None, name: str = "gla_scan") -> list:
    """A gla_scan row, ``name``: the kernel's launcher and the plain
    version, timed on the inputs the recorder kept (row 8: the first
    mLSTM call of ssm_serve's prefill; 8z: the first mamba2 call of
    zamba2_serve's), in turns (plain, kernel, kernel, plain; with
    ``parent``, the parent's launcher between them); ``ms`` launched from
    the host, ``device_ms`` by CUDA graph replays (both for the parent's
    too). The bound: the split's bf16 tensor-core operations at the bf16
    peak or each operand read and each result written once, whichever is
    longer; the float32 figure (the same work on the float32 CUDA cores,
    the bound of the kernel this one replaced) is logged beside it. No
    single PyTorch call computes chunked gated linear attention, so there
    is no library yardstick."""
    import torch
    from repro_torch.kernels.gla_scan import chunked_gla_ref, gla_scan_fwd
    q, k, v, la, kw = recorder.operands()
    chunk, s0 = kw["chunk"], kw.get("initial_state")

    def kernel():
        return gla_scan_fwd(q, k, v, la, chunk=chunk, initial_state=s0)

    def plain():
        return chunked_gla_ref(q, k, v, la, chunk, s0)
    y, s = kernel()
    want_y, want_s = plain()
    ey, es = gla_rel_err(y, s, want_y, want_s)
    tol_y = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-4
    log(f"  {name} main-path call: y max_abs_err {ey:.3g} of its max "
        f"(tol {tol_y:.3g}), state {es:.3g} (tol 1e-4)")
    assert ey <= tol_y and es <= 1e-4
    err = max(worst[name], max_err(y, want_y), max_err(s, want_s))
    del y, s, want_y, want_s
    fns = {"plain": plain, "ms": kernel}
    if parent is not None:
        fns["parent_ms"] = lambda: parent.gla_scan(
            q, k, v, la, chunk=chunk, initial_state=s0)
    order = ["plain"] + [m for m in fns if m != "plain"]
    order += order[::-1]
    loop = {m: [] for m in fns}
    for m in order:
        loop[m].append(cuda_ms(fns[m], 3))
    row_ = {m: min(t) for m, t in loop.items()}
    dev = {m: [] for m in fns if m != "plain"}
    for m in order:
        if m != "plain":
            dev[m].append(graph_ms(fns[m], 3))
    for m, t in dev.items():
        row_[m.replace("ms", "device_ms")] = min(t)
    ms, plain_ms = row_.pop("ms"), row_.pop("plain")
    dv = v.shape[-1]
    c = min(chunk, q.shape[2])
    # each input read once in its dtype (a broadcast view's storage once),
    # y written in v's, the state in float32
    nbytes = sum(stored_bytes(t) for t in (q, k, v, la)) \
        + q.shape[0] * q.shape[1] * q.shape[2] * dv * v.element_size() \
        + q.shape[0] * q.shape[1] * q.shape[-1] * dv * 4 \
        + (0 if s0 is None else s0.numel() * 4)
    ops = gla_tc_ops(tuple(q.shape), dv, c, s0 is not None,
                     tuple(t.dtype for t in (q, k, v)))
    f32_ops = gla_ops(tuple(q.shape), dv, c, s0 is not None)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS["bfloat16"] * 1e3
    f32_bound = max(by_bytes, f32_ops / PEAK_OPS["float32"] * 1e3)
    shape = list(q.shape) + [dv, f"chunk {chunk}",
                             " ".join(str(t.dtype)[6:] for t in (q, k, v))]
    log(f"  {name} {shape}: kernel {ms:.4f} ms (device "
        f"{row_['device_ms']:.4f}), plain {plain_ms:.4f} ms, library none, "
        f"bound {max(by_bytes, by_ops):.4f} ms ({nbytes} B, {ops} bf16 "
        f"tensor-core operations; float32 figure {f32_bound:.4f} ms, "
        f"{f32_ops} float32 operations), main-path max_abs_err {err:.3g}")
    if parent is not None:
        log(f"    in turns with the parent's kernel: launched from the host "
            f"{row_['parent_ms']:.4f} -> {ms:.4f} ms, device time "
            f"{row_['parent_device_ms']:.4f} -> {row_['device_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/gla_scan.cu",
             "replaces": GLA_REPLACES, "launches": launches[name],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "library_ms": None, "shape": shape, **row_,
             "host_ms": ms - row_["device_ms"],
             "float32_bound_ms": f32_bound}]


def gla_bwd_tc_ops(shape, dv: int, chunk: int, with_state: bool,
                   with_dstate: bool, dtypes: tuple) -> int:
    """The gla backward's work as the kernels' bf16 tensor-core products,
    per chunk of r real steps (pairs = r (r + 1) / 2): the chunk-entry
    states again and the dS sweep (r dk dv each), P and dA (pairs dk and
    pairs dv), dq's dA k (pairs dk) and dy S_n^T (r dk dv; none on the
    first chunk from the zero state), dk's dA^T q (pairs dk) and v dS^T,
    dv's P^T dy (pairs dv) and k dS (r dk dv each; none on the last chunk
    without a final-state gradient), each times ``split_products`` of its
    operands: dy in v's dtype, and P, dA, S_n, dS and the decayed q and k
    held as the kernel's terms for v's dtype (``TERMS``); two operations
    a multiply-add. ``dtypes``: q's, k's and v's."""
    import torch
    from repro_torch.kernels.gla_scan import TERMS
    B, H, T, dk = shape
    nt = TERMS[dtypes[2]]
    tq, tk, tv = (1 if d == torch.bfloat16 else nt for d in dtypes)
    sp = split_products
    ops = 0
    for t0 in range(0, T, chunk):
        r = min(chunk, T - t0)
        pairs = r * (r + 1) // 2
        first = t0 == 0 and not with_state
        last = t0 + chunk >= T and not with_dstate
        ops += 2 * B * H * (
            r * dk * dv * (sp(nt, tv, nt) + sp(nt, tv, nt))
            + pairs * dk * (sp(tq, tk, nt) + sp(nt, tk, nt) + sp(nt, tq, nt))
            + pairs * dv * (sp(tv, tv, nt) + sp(nt, tv, nt))
            + (0 if first else r * dk * dv * sp(tv, nt, nt))
            + (0 if last else r * dk * dv * (sp(tv, nt, nt)
                                             + sp(tk, nt, nt))))
    return ops


def time_gla_bwd(recorder: GLARecorder, worst: dict, launches: dict,
                 name: str = "gla_scan_bwd") -> list:
    """A gla backward row, ``name``: gla_scan_bwd and the plain backward
    (chunked_gla_bwd_ref) on the inputs and output gradients the train
    run's recorder kept (row 8b: the first mLSTM call of xlstm_train's
    first step; 8zb: the first mamba2 call of zamba2_train's), held at
    check_gla_kernels' tolerances, then timed in turns (plain, kernel,
    kernel, plain; ``ms`` launched from the host) and as device time by
    CUDA graph replays. The bound: the split's bf16 tensor-core
    operations (``gla_bwd_tc_ops``) at the bf16 peak or each input read
    and each gradient written once, whichever is longer. No single
    PyTorch call computes this gradient, so there is no library
    yardstick."""
    import torch
    from repro_torch.kernels.gla_scan import (chunked_gla_bwd_ref,
                                              gla_scan_bwd)
    q, k, v, la, kw = recorder.operands()
    dy, ds = recorder.grads()
    chunk, s0 = kw["chunk"], kw.get("initial_state")

    def kernel():
        return gla_scan_bwd(q, k, v, la, dy, chunk=chunk, initial_state=s0,
                            dstate=ds)

    def plain():
        return chunked_gla_bwd_ref(q, k, v, la, chunk, s0, dy, ds)
    err = gla_bwd_errors(f"{name} main-path call", kernel(), plain(),
                         [str(t.dtype)[6:] for t in (q, k, v)])
    err = max(worst[name], err)
    ms, plain_ms = in_turns(plain, kernel, 3)
    device_ms = graph_ms(kernel, 3)
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, T)
    # each input read once in its dtype (a broadcast view's storage once),
    # the gradients written densely per head in their operands' dtypes
    nbytes = sum(stored_bytes(t) for t in (q, k, v, la, dy)) \
        + B * H * T * (dk * (q.element_size() + k.element_size())
                       + dv * v.element_size() + 4) \
        + sum(2 * t.numel() * 4 for t in (s0,) if t is not None) \
        + (0 if ds is None else ds.numel() * 4)
    ops = gla_bwd_tc_ops(tuple(q.shape), dv, c, s0 is not None,
                         ds is not None, tuple(t.dtype for t in (q, k, v)))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS["bfloat16"] * 1e3
    bound = max(by_bytes, by_ops)
    shape = list(q.shape) + [dv, f"chunk {chunk}",
                             " ".join(str(t.dtype)[6:] for t in (q, k, v))]
    log(f"  {name} {shape}: kernel {ms:.4f} ms (device {device_ms:.4f}, "
        f"{device_ms / bound:.1f}x bound), plain {plain_ms:.4f} ms, library "
        f"none, bound {bound:.4f} ms ({nbytes} B, {ops} bf16 tensor-core "
        f"operations), {launches[name]} launches, main-path max_abs_err "
        f"{err:.3g}")
    torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/gla_scan.cu",
             "replaces": GLA_BWD_REPLACES, "launches": launches[name],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound,
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "library_ms": None, "shape": shape, "device_ms": device_ms,
             "host_ms": ms - device_ms}]


# ---------------------------------------------------------------------------
# the MoE FFN: deepseek-moe-16b's routed experts (rows 9 and 9d)
# ---------------------------------------------------------------------------
MOE_SRC = "src/repro_torch/kernels/csrc/moe_experts.cu"
MOE_REPLACES = ("none of its own: the reference's dense einsum dispatch, "
                "src/repro/models/moe.py:85-94")


def layers(model: str, periods=None) -> int:
    """The layers of ``model`` at full width, each group cut to
    ``periods``."""
    from repro_torch.configs import get_config
    return cut_config(get_config(model), periods=periods).n_layers


def cut_config(cfg, periods=None, capacity_factor=None):
    """``cfg`` with each group cut to ``periods[i]`` periods (a group cut
    to 0 is dropped) and every MoE FFN's capacity factor set to
    ``capacity_factor`` (None: as it is); the name says so."""
    import dataclasses
    groups = []
    for i, g in enumerate(cfg.groups):
        if periods is not None and periods[i] == 0:
            continue
        period = tuple(
            dataclasses.replace(b, ffn=dataclasses.replace(
                b.ffn, capacity_factor=capacity_factor))
            if capacity_factor is not None and b.ffn is not None
            and b.ffn.kind == "moe" else b for b in g.period)
        groups.append(dataclasses.replace(
            g, period=period,
            n_periods=g.n_periods if periods is None else periods[i]))
    name = cfg.name
    if periods is not None:
        name += f"-periods{'x'.join(map(str, periods))}"
    if capacity_factor is not None:
        name += f"-cf{capacity_factor:.3g}"
    return dataclasses.replace(cfg, groups=tuple(groups), name=name)


def moe_ffn(model: str = MOE_MODEL, tiny: bool = False):
    """The MoE FFN config of ``model``."""
    from repro_torch.configs import get_config
    return next(b.ffn for b in get_config(model, tiny=tiny).blocks
                if b.ffn is not None and b.ffn.kind == "moe")


def moe_case(gen, f, *, G, T, d, dtype, device):
    """Random rows (G groups of T tokens at width d) through a random
    router and ``route`` at f's capacity: (the kernel's operands, gate
    ids, capacity)."""
    import torch
    from repro_torch.models import moe
    E, fe = f.n_routed_experts, f.d_ff_expert
    x = torch.randn((G, T, d), generator=gen, device=device).to(dtype)
    router = torch.randn((d, E), generator=gen, device=device) / math.sqrt(d)
    gate_w, gate_idx, _ = moe.router({"router": router}, f, x)
    C = moe._capacity(T, f)
    w = [(torch.randn(shape, generator=gen, device=device)
          / math.sqrt(shape[1])).to(dtype)
         for shape in ((E, d, fe), (E, d, fe), (E, fe, d))]
    args = (x.reshape(G * T, d), *w, gate_w.reshape(G * T, f.top_k),
            *moe.route(gate_idx, C, E))
    return args, gate_idx, C


def check_moe_kernels(gen, worst) -> None:
    """The MoE kernels against moe_experts_ref on the card, bf16 (3e-2 of
    the largest entry, the other kernels' tolerance) and float32 (1e-4),
    at the tiny and full widths of deepseek-moe-16b: a decode (8 groups
    of one token), a fused prefill (512 groups of one) and an extend call
    (4 rows of 128 tokens at cf 1.25, 0.5 at the tiny width, which drops
    pairs: route's ``valid`` equals the plain capacity step's, route_ref,
    on the CPU); then
    moe_forward once under torch.cuda.set_sync_debug_mode("error"): the
    routing and the launches never sync with the host."""
    import dataclasses
    import torch
    from repro_torch.kernels.moe_experts import moe_experts, moe_experts_ref
    from repro_torch.models import moe
    dev = torch.device("cuda")
    for tiny in (True, False):
        f = moe_ffn(tiny=tiny)
        d = 256 if tiny else 2048
        for dtype in (torch.bfloat16, torch.float32):
            # the extend call drops pairs at the full width's cf 1.25;
            # the tiny width's 4 experts need cf 0.5 for it
            for label, G, T, cf in (("decode", 8, 1, f.capacity_factor),
                                    ("fused prefill", 512, 1,
                                     f.capacity_factor),
                                    ("extend", 4, 128, 0.5 if tiny
                                     else 1.25)):
                fc = dataclasses.replace(f, capacity_factor=cf)
                args, idx, C = moe_case(gen, fc, G=G, T=T, d=d, dtype=dtype,
                                        device=dev)
                valid = args[6]
                dropped = int((~valid).sum())
                assert torch.equal(valid.cpu(), moe.route_ref(
                    idx.cpu(), C, fc.n_routed_experts)), label
                if label == "extend":
                    assert dropped > 0, "the extend case drops no pair"
                got = moe_experts(*args, activation=f.activation)
                want = moe_experts_ref(*args, activation=f.activation)
                torch.cuda.synchronize()
                err = max_err(got, want)
                tol = (3e-2 if dtype == torch.bfloat16 else 1e-4) * float(
                    want.float().abs().max())
                log(f"  moe_experts {'tiny' if tiny else 'full'} {label} "
                    f"{G} x {T} x d {d}, E {fc.n_routed_experts} k "
                    f"{fc.top_k} fe {fc.d_ff_expert}, capacity {C}, "
                    f"{dropped} of {valid.numel()} pairs dropped, "
                    f"{str(dtype)[6:]}: max_abs_err {err:.3g} (tol "
                    f"{tol:.3g})")
                assert err <= tol, (label, err, tol)
                if dtype == torch.bfloat16 and not tiny:
                    key = "moe_experts_decode" if label == "decode" \
                        else "moe_experts"
                    worst[key] = max(worst[key], err)
    # the routing and the launches under the sync debugger
    f = moe_ffn()
    p = moe.init_moe(gen, 2048, f, dtype=torch.bfloat16, device=dev)
    x = torch.randn((4, 128, 2048), generator=gen, device=dev).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.moe_forward(p, f, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))
    log("  moe_forward (4 x 128, full width, bf16) under "
        "set_sync_debug_mode('error'): no sync")
    del p


class LargestCalls:
    """Keeps the inputs of the largest call (by ``size``; the last of
    equal ones, whose pools and contexts are the run's deepest at that
    size) of each op in ``OPS`` on the main path, and of its largest call
    in a decode-only fused step (no more tokens than block-table rows),
    and counts the decode-only calls: the timing phase's inputs. Wraps
    those ops in ``MODULE`` and ``LM.forward_mixed_paged``; adds nothing
    to the launch counts. Each op's arguments at ``by_ref`` (weights and
    pools, views of the engine's stacked leaves: they carry the run's
    last contents) are kept by reference, the rest copied at the call; on
    leaving, the records move to host memory.

    ``OPS`` maps an op's attribute name to (key, by_ref, size of a call
    from its arguments, key of its decode-only record or None)."""
    MODULE: str
    OPS: dict

    def __init__(self):
        self.calls = {}
        self.decode_launches = 0
        self._decode = False

    def __enter__(self):
        import importlib
        from repro_torch.models.model import LM
        self._module = module = importlib.import_module(self.MODULE)
        self._lm, self._mixed = LM, LM.forward_mixed_paged
        self._ops = {name: getattr(module, name) for name in self.OPS}
        rec = self

        def mixed(lm, params, tokens, tok_seq, tok_pos, q_last, pools,
                  block_tables, *args, **kw):
            rec._decode = tokens.shape[0] <= block_tables.shape[0]
            try:
                return rec._mixed(lm, params, tokens, tok_seq, tok_pos,
                                  q_last, pools, block_tables, *args, **kw)
            finally:
                rec._decode = False

        def wrap(name):
            key, by_ref, size, decode_key = self.OPS[name]
            orig = self._ops[name]

            def op(*args, **kw):
                keys = [key]
                if rec._decode and decode_key is not None:
                    rec.decode_launches += 1
                    keys.append(decode_key)
                n = size(args)
                for k in keys:
                    if n >= rec.calls.get(k, (-1,))[0]:
                        rec.calls[k] = (n, tuple(
                            a if i in by_ref or not hasattr(a, "clone")
                            else a.clone() for i, a in enumerate(args)),
                            dict(kw))
                return orig(*args, **kw)
            return op
        for name in self.OPS:
            setattr(module, name, wrap(name))
        LM.forward_mixed_paged = mixed
        return self

    def __exit__(self, *exc):
        for name, orig in self._ops.items():
            setattr(self._module, name, orig)
        self._lm.forward_mixed_paged = self._mixed
        self.calls = {k: (n, tuple(a.to("cpu") if hasattr(a, "to") else a
                                   for a in args), kw)
                      for k, (n, args, kw) in self.calls.items()}

    def call(self, key: str, device="cuda"):
        _, args, kw = self.calls[key]
        return tuple(a.to(device) if hasattr(a, "to") else a
                     for a in args), kw


class MoERecorder(LargestCalls):
    """The MoE kernels' largest call by pairs and their largest decode-only
    call: rows 9 and 9d. The experts' weights are kept by reference."""
    MODULE = "repro_torch.models.moe"
    OPS = {"moe_experts_op": ("moe_experts", (1, 2, 3),
                              lambda args: args[5].shape[0],
                              "moe_experts_decode")}


def moe_work(args) -> tuple:
    """(bytes, operations, experts touched, pairs kept) of one moe_experts
    call from its data: the weights of each expert with a kept pair, read
    once, the token rows read and the output rows written, the gates and
    the routing; 2 d fe operations a kept pair for each of the three
    products."""
    import torch
    x, wg, wu, wd, gw, pair, valid, offsets = (a.cpu() for a in args)
    N, d = x.shape
    E, _, fe = wg.shape
    keep = valid[pair.long()]
    expert = torch.repeat_interleave(torch.arange(E), offsets.diff().long())
    touched = int(torch.unique(expert[keep]).numel())
    kept = int(keep.sum())
    es = x.element_size()
    nbytes = (touched * 3 * d * fe * es + 2 * N * d * es + gw.numel() * es
              + pair.numel() * 5 + offsets.numel() * 4)
    return nbytes, 2 * kept * d * fe * 3, touched, kept


def grouped_mm_fn(args, activation: str):
    """The same function as moe_experts through the installed torch's
    grouped product (``torch._grouped_mm`` or
    ``torch.nn.functional.grouped_mm``) over the same sorted rows: the
    gather, the three grouped products, the activation and the combine;
    the timing phase's library column, which the port never calls.
    Returns (that function, the three products alone) or None where torch
    has none or refuses these operands (logged)."""
    import torch
    from repro_torch.models.common import activation_fn
    gmm = getattr(torch, "_grouped_mm", None) or getattr(
        torch.nn.functional, "grouped_mm", None)
    if gmm is None:
        log("  no grouped product in this torch: library_ms null")
        return None
    x, wg, wu, wd, gw, pair, valid, offsets = args
    N, d = x.shape
    k = gw.shape[1]
    pid = pair.long()
    ends = offsets[1:].contiguous()
    keep = valid[pid][:, None]
    act = activation_fn(activation)

    def fn():
        xs = x[pid // k]
        h = act(gmm(xs, wg, offs=ends)) * gmm(xs, wu, offs=ends)
        ys = gmm(h, wd, offs=ends) * keep
        y = torch.empty_like(ys).index_copy_(0, pid, ys)
        return (y.view(N, k, d).float() * gw.float()[..., None]).sum(
            1).to(x.dtype)
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        log(f"  {gmm.__name__} refuses these operands ({e}): library_ms "
            "null")
        return None
    xs = x[pid // k]
    h = act(gmm(xs, wg, offs=ends)) * gmm(xs, wu, offs=ends)

    def products():
        gmm(xs, wg, offs=ends)
        gmm(xs, wu, offs=ends)
        return gmm(h, wd, offs=ends)
    return fn, products


def time_moe(recorder: MoERecorder, worst: dict, launches: dict) -> list:
    """Rows 9 and 9d: the MoE kernels at moe_serve's largest call and at
    its largest decode-only call, against moe_experts_ref (3e-2 of the
    largest entry), launched from the host in turns with the plain version
    (``ms``) and as device time by CUDA graph replays (``device_ms``); the
    bound from the call's data (``moe_work``); the grouped product of
    ``grouped_mm_fn`` as the library column."""
    import torch
    from repro_torch.kernels.moe_experts import moe_experts, moe_experts_ref
    f = moe_ffn()
    rows = []
    for name in MOE_KERNELS:
        args, kw = recorder.call(name)

        def kernel_fn():
            return moe_experts(*args, **kw)

        def plain_fn():
            return moe_experts_ref(*args, **kw)
        got, want = kernel_fn(), plain_fn()
        err = max_err(got, want)
        assert err <= 3e-2 * float(want.float().abs().max()), (name, err)
        err = max(worst[name], err)
        ms, plain_ms = in_turns(plain_fn, kernel_fn, 10)
        lib = grouped_mm_fn(args, f.activation)
        lib_ms = products_ms = None
        if lib is not None:
            log(f"    the grouped product's max_abs_err against the "
                f"kernel: {max_err(lib[0](), got):.3g}")
            lib_ms = cuda_ms(lib[0], 10)
            products_ms = cuda_ms(lib[1], 10)
        nbytes, ops, touched, kept = moe_work(args)
        N, d = args[0].shape
        row = kernel_row(name, MOE_SRC, MOE_REPLACES, launches[name], err,
                         ms, plain_ms, lib_ms, nbytes, ops, "bfloat16",
                         [N, d, f.d_ff_expert, f"E {f.n_routed_experts}",
                          f"k {f.top_k}", f"{kept} pairs kept",
                          f"{touched} experts touched"])
        row["device_ms"] = graph_ms(kernel_fn, 10)
        row["host_ms"] = ms - row["device_ms"]
        row["library_products_ms"] = products_ms
        log(f"    device time {row['device_ms']:.4f} ms "
            f"({row['device_ms'] / row['bound_ms']:.1f}x bound), host time "
            f"{row['host_ms']:.4f} ms; the library's three grouped "
            f"products alone {products_ms} ms")
        rows.append(row)
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# the MLA slice: the ragged latent-attention kernel, and deepseek-v3
# ---------------------------------------------------------------------------
MLA_SRC = "src/repro_torch/kernels/csrc/mla_attention.cu"
MLA_REPLACES = ("none of its own: the reference's XLA gather and einsums, "
                "src/repro/models/attention.py:562-784")


def latent_case(gen, *, H, L, R, dtype, device, page=16, max_pages=64,
                decode_only=False, long_context=False):
    """A ragged latent-attention call over random pools of ``dtype``: a
    480-token chunk at positions 300-779, decodes at 1023 (the table's
    last key), 15 (ending on a page boundary), 16 (the first key of a
    page) and 0, then padded rows to N 512; ``decode_only``: 8 decodes at
    contexts up to the table's end, one padded; ``long_context``: 7
    decodes over tables of 512 pages, up to 8192 keys, one padded.
    Returns the kernel's arguments (q_lat, q_rope, c_pool, kr_pool,
    block_tables, tok_seq, tok_pos, scale)."""
    import torch
    if long_context:
        max_pages = 512
        seq = list(range(7))
        pos = [8191, 6000, 4096, 4095, 16, 0, -1]
    elif decode_only:
        seq = list(range(8))
        pos = [1023, 700, 511, 512, 15, 16, 0, -1]
    else:
        seq = [0] * 480 + [1, 2, 3, 4] + [0] * 28
        pos = list(range(300, 780)) + [1023, 15, 16, 0] + [-1] * 28
    B = max(seq) + 1
    n_pages = B * max_pages + 1
    f32 = dict(device=device, dtype=torch.float32)
    c = torch.randn((n_pages, page, L), generator=gen, **f32).to(dtype)
    kr = torch.randn((n_pages, page, R), generator=gen, **f32).to(dtype)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=device)[
        :B * max_pages] + 1).reshape(B, max_pages).to(torch.int32)
    i32 = dict(device=device, dtype=torch.int32)
    N = len(seq)
    return (torch.randn((N, H, L), generator=gen, **f32),
            torch.randn((N, H, R), generator=gen, **f32), c, kr, bt,
            torch.tensor(seq, **i32), torch.tensor(pos, **i32),
            1.0 / math.sqrt(192))


def check_mla_kernels(gen, worst) -> None:
    """The MLA slice's kernels against their plain versions on the card:
    the ragged latent-attention kernel (row 10) at deepseek-v3's full
    widths (H 128, L 512, R 64), at H 24 (a head tile of the tensor-core
    form padded) and at the tiny config's widths (H 4, L 32, R 16), over
    bf16 and float32 pools, on ``latent_case``'s ragged call (N 512: a
    chunk, decodes at the table's end and on either side of a page
    boundary, padded rows: zeros), its decode-only call and, at H 128,
    decodes up to 8192 keys, within 1e-4 (the plain version reads the same
    latents; sums in other orders, exp2 for exp, and in the tensor-core
    form the float32 queries and weights as two bf16 terms); the form
    each call takes (bf16 pools at L 512, R 64: the tensor-core form,
    ``tc_launches``; the rest the CUDA-core form); a row's bits in a call
    of N 1 equal to its bits in the call of N 512 (H 128 and 24);
    kv_append at the latent widths (``check_append``: c
    512 and kr 64 wide, and the tiny config's 32 and 16);
    the flash forward at head_dim 192 (out and lse) at B 1-2 x 128 heads x
    G 1 x T 1024 causal, T 65, 77 and 129, Tq < Tk and G 16 (the float32
    kernel's most heads at 192), ``attention_tol``, and its backward
    (``check_flash_bwd``) on the same calls with v zero-padded past 128
    columns and scale 1 / sqrt(192), as ``mla_forward`` runs it; the tree
    swap over deepseek-v3's latent pool tree
    (its int8 engine's is the same: latent pools stay in the model
    dtype), byte for byte (``swap_tree_case``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    from repro_torch.kernels.mla_attention import (
        ragged_latent_attention, ragged_latent_attention_ref)
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_leaves
    dev = torch.device("cuda")
    for H, L, R in ((128, 512, 64), (24, 512, 64), (4, 32, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            tc = dtype == torch.bfloat16 and (L, R) == (512, 64)
            for call in ("N 512", "decode-only N 8", "8192 keys N 7"):
                if call.startswith("8192") and H != 128:
                    continue
                args = latent_case(gen, H=H, L=L, R=R, dtype=dtype,
                                   device=dev,
                                   decode_only=call.startswith("decode"),
                                   long_context=call.startswith("8192"))
                before = (ragged_latent_attention.launches,
                          ragged_latent_attention.tc_launches)
                got = ragged_latent_attention(*args)
                want = ragged_latent_attention_ref(*args)
                torch.cuda.synchronize()
                assert (ragged_latent_attention.launches,
                        ragged_latent_attention.tc_launches) == (
                    before[0] + 1, before[1] + tc)
                err = max_err(got, want)
                pad = args[6] < 0
                label = (f"H {H} L {L} R {R} {str(dtype)[6:]} pools, {call}"
                         f" ({'tensor-core' if tc else 'CUDA-core'} form)")
                log(f"  ragged_latent_attention {label}: max_abs_err "
                    f"{err:.3g} (tol 1e-4), padded rows zero")
                assert err <= 1e-4, label
                assert bool((got[pad] == 0).all()), label
                if H == 128 and tc:
                    key = "mla_attention" if call == "N 512" \
                        else "mla_attention_decode"
                    worst[key] = max(worst[key], err)
                if call == "N 512" and H in (128, 24):
                    # a row computes alone what it computes beside 511
                    for i in (0, 479, 480, 481, 482, 483, 511):
                        one = ragged_latent_attention(
                            args[0][i:i + 1], args[1][i:i + 1], *args[2:5],
                            args[5][i:i + 1], args[6][i:i + 1], args[7])
                        assert torch.equal(one[0], got[i]), (label, i)
                    log(f"  ragged_latent_attention {label}: rows 0, 479-483 "
                        "and 511 alone (N 1) bit for bit as in the call of "
                        "N 512")
                del args, got, want
    for dtype in (torch.bfloat16, torch.float32):
        for L, R in ((512, 64), (32, 16)):
            check_append(gen, worst, dtype, Hkv=1, hd=L, hd_v=R,
                         key="kv_append_latent")
    tol = attention_tol()
    cases = [("B=2 H=128 T=1024", dict(B=2, Hkv=128, G=1, Tq=1024, Tk=1024),
              {}),
             ("B=1 H=128 T=77", dict(B=1, Hkv=128, G=1, Tq=77, Tk=77), {}),
             # one past a 64-row tile, and one past two
             ("B=1 H=128 T=65", dict(B=1, Hkv=128, G=1, Tq=65, Tk=65), {}),
             ("B=1 H=128 T=129", dict(B=1, Hkv=128, G=1, Tq=129, Tk=129),
              {}),
             ("Tq<Tk", dict(B=1, Hkv=8, G=1, Tq=100, Tk=300), {}),
             ("G=16", dict(B=1, Hkv=2, G=16, Tq=130, Tk=130), {})]
    scale = 1.0 / math.sqrt(192)
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape, kw in cases:
            B, Hkv, G, Tq, Tk = (shape[k] for k in ("B", "Hkv", "G", "Tq",
                                                    "Tk"))
            q = torch.randn((B, Hkv, G, Tq, 192), generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn((B, Hkv, Tk, 192), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            out, lse = flash_attention_fwd(q, k, v, scale=scale, **kw)
            want, want_lse = flash_attention_fwd_ref(q, k, v, scale=scale,
                                                     **kw)
            torch.cuda.synchronize()
            err, lse_err = max_err(out, want), max_err(lse, want_lse)
            log(f"  flash_attention hd=192 {label} {str(dtype)[6:]}: out "
                f"max_abs_err {err:.3g} (tol {tol[dtype]:g}), lse "
                f"{lse_err:.3g} (tol 1e-4)")
            assert err <= tol[dtype] and lse_err <= 1e-4, label
            worst["flash_attention_hd192"] = max(
                worst["flash_attention_hd192"], err)
            del want, want_lse, out, lse
            # the backward as mla_forward runs it: v zero-padded past its
            # 128 columns (so is the gradient reaching the output)
            v[..., 128:] = 0
            out, lse = flash_attention_fwd(q, k, v, scale=scale, **kw)
            worst["flash_attention_bwd_hd192"] = max(
                worst["flash_attention_bwd_hd192"],
                check_flash_bwd(gen, f"hd=192 {label}", q, k, v, out, lse,
                                dict(kw, scale=scale), v_width=128))
            del q, k, v, out, lse
    torch.cuda.empty_cache()
    lm = LM(cut_config(get_config(MLA_MODEL), periods=MLA_SERVE_PERIODS))
    for kv_dtype in (None, "int8"):
        leaves = tree_leaves(lm.init_cache(40, 16, dtype=torch.bfloat16,
                                           device=dev, kv_dtype=kv_dtype))
        assert all(t.dtype == torch.bfloat16 for t in leaves)
        for leaf in leaves:
            leaf.view(torch.uint8).copy_(torch.randint(
                0, 256, leaf.view(torch.uint8).shape, generator=gen,
                device=dev, dtype=torch.uint8))
        for n in (1, 7, 34):
            for shift in (0, 8):
                swap_tree_case(gen, leaves, n, shift)
        log(f"  swap_pack/swap_unpack over {MLA_MODEL}'s "
            f"{kv_dtype or 'bf16'} engine's latent pool tree "
            f"{[tuple(t.shape) for t in leaves]}: n {{1, 7, 34}}, aligned "
            "and shifted slabs, distinct and repeated ids, byte for byte, "
            "one launch a call")
        del leaves


class MLARecorder(LargestCalls):
    """The latent-attention kernel's largest call by rows and its largest
    decode-only call (rows 10 and 10d), and kv_append's largest call at
    the latent widths (row 2m). The latent pools are kept by reference."""
    MODULE = "repro_torch.models.attention"
    OPS = {"ragged_latent_attention_op": ("mla_attention", (2, 3),
                                          lambda args: args[0].shape[0],
                                          "mla_attention_decode"),
           "kv_append_op": ("kv_append_latent", (0, 1),
                            lambda args: args[2].shape[0], None)}


def latent_work(args) -> tuple:
    """(bytes, operations) of one ragged latent-attention call from its
    data: the latent pages its live rows reach, read once (c and kr), the
    live rows' queries read (a padded row's block writes zeros and reads
    none), every row's output written, the routing and the table rows;
    2 (2 L + R) operations per (live row, head, visible key)."""
    q_lat, q_rope, c, kr, bt, seq, pos, _ = (
        a.cpu() if hasattr(a, "cpu") else a for a in args)
    N, H, L = q_lat.shape
    R = q_rope.shape[2]
    page = c.shape[1]
    live = pos >= 0
    n_live = int(live.sum())
    keys = (pos[live].long() + 1).clamp(max=bt.shape[1] * page)
    pages = set()
    for s, k in zip(seq[live].tolist(), keys.tolist()):
        pages.update(bt[s, :-(-k // page)].tolist())
    es = c.element_size()
    nbytes = (len(pages) * page * (L + R) * es + n_live * H * (L + R) * 4
              + N * H * L * 4
              + (seq.numel() + pos.numel() + bt.numel()) * 4)
    return nbytes, int(keys.sum()) * H * 2 * (2 * L + R)


def latent_f64(args):
    """The ragged latent attention in float64, row by row over each row's
    live keys: the yardstick for the kernel's and the plain version's
    float32 rounding."""
    import torch
    q_lat, q_rope, c, kr, bt, seq, pos, scale = args
    out = torch.zeros(q_lat.shape, dtype=torch.float64, device=q_lat.device)
    page = c.shape[1]
    for i, (s, p) in enumerate(zip(seq.tolist(), pos.tolist())):
        n = min(p + 1, bt.shape[1] * page)
        if n <= 0:
            continue
        keys = torch.arange(n, device=q_lat.device)
        pid = bt[s].long()[keys // page]
        ci = c[pid, keys % page].double()
        sc = (q_lat[i].double() @ ci.T
              + q_rope[i].double() @ kr[pid, keys % page].double().T) * scale
        out[i] = torch.softmax(sc, dim=-1) @ ci
    return out


def time_mla(recorder: MLARecorder, worst: dict, launches: dict,
             parent=None) -> list:
    """Rows 10, 10d and 2m: the latent-attention kernel (its tensor-core
    form: bf16 pools) at mla_serve's largest call and its largest
    decode-only call, against ragged_latent_attention_ref (1e-4), and
    kv_append at its largest latent call (bit for bit); launched from the
    host in turns with the plain version (``ms``) and as device time by
    CUDA graph replays (``device_ms``); with ``parent``, the parent's
    latent kernel in turns by both measures (``device_time``). Bound
    (``latent_work``): bytes at the HBM rate against operations at the
    bf16 tensor-core peak, with the float32 CUDA-core figure beside it
    (``bound_f32_ms``: the CUDA-core form's arithmetic). No single PyTorch
    call computes either function: library_ms null."""
    import torch
    from repro_torch.kernels.kv_append import kv_append, kv_append_ref
    from repro_torch.kernels.mla_attention import (
        ragged_latent_attention, ragged_latent_attention_ref)
    rows = []
    for name in ("mla_attention", "mla_attention_decode"):
        args, _ = recorder.call(name)

        def kernel_fn():
            return ragged_latent_attention(*args)

        def plain_fn():
            return ragged_latent_attention_ref(*args)

        def parent_fn():
            return parent.mla(*args)
        tc = ragged_latent_attention.tc_launches
        got = kernel_fn()
        assert ragged_latent_attention.tc_launches == tc + 1, name
        want = plain_fn()
        err = max_err(got, want)
        assert err <= 1e-4, (name, err)
        exact = latent_f64(args)
        log(f"  {name}: against a float64 evaluation, the kernel "
            f"{max_err(got, exact):.3g}, the plain version "
            f"{max_err(want, exact):.3g} (output max "
            f"{float(exact.abs().max()):.3g})")
        del want, exact
        err = max(worst[name], err)
        ms, plain_ms = in_turns(plain_fn, kernel_fn, 5)
        nbytes, ops = latent_work(args)
        N, H, L = args[0].shape
        pos = args[6]
        live = pos[pos >= 0]
        row = kernel_row(name, MLA_SRC, MLA_REPLACES, launches[name], err,
                         ms, plain_ms, None, nbytes, ops, "bfloat16",
                         [N, H, L, args[1].shape[2], f"pools "
                          f"{tuple(args[2].shape)} {str(args[2].dtype)[6:]}",
                          f"{int(live.numel())} live rows, context "
                          f"{int(live.min()) + 1}-{int(live.max()) + 1}"])
        row["form"] = "tensor cores (mla_attention_tc_kernel)"
        device_time(row, kernel_fn, parent_fn if parent else None, 10)
        if parent:
            ratio = row["device_ms"] / row["parent_device_ms"]
            log(f"    device time {ratio:.3f}x the parent kernel's")
        row["bound_f32_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                  ops / PEAK_OPS["float32"]) * 1e3
        log(f"    device time {row['device_ms']:.4f} ms "
            f"({row['device_ms'] / row['bound_ms']:.1f}x the bf16 bound, "
            f"{row['device_ms'] / row['bound_f32_ms']:.2f}x the float32 "
            f"CUDA-core bound {row['bound_f32_ms']:.4f} ms), host time "
            f"{row['host_ms']:.4f} ms")
        rows.append(row)
    args, _ = recorder.call("kv_append_latent")

    def append_fn():
        return kv_append(*args)

    def append_plain():
        return kv_append_ref(*args)
    want = tuple(t.clone() for t in append_plain())
    got = append_fn()
    assert byte_equal(got[0], want[0]) and byte_equal(got[1], want[1])
    ms, plain_ms = in_turns(append_plain, append_fn, 20)
    cp, kp, cn, kn, ids, offs, valid = args
    n_valid = int((valid != 0).sum())
    es = cp.element_size()
    nbytes = 2 * n_valid * (cp.shape[-1] + kp.shape[-1]) * es \
        + 3 * ids.numel() * 4
    row = kernel_row("kv_append_latent",
                     "src/repro_torch/kernels/csrc/kv_append.cu",
                     "src/repro/kernels/kv_append.py:60",
                     launches["kv_append_latent"], 0.0, ms, plain_ms, None,
                     nbytes, 0, "bfloat16",
                     [cn.shape[0], f"c {cp.shape[-1]}", f"kr {kp.shape[-1]}",
                      f"{n_valid} valid", str(cp.dtype)[6:]])
    row["device_ms"] = graph_ms(append_fn, 20)
    row["host_ms"] = ms - row["device_ms"]
    log(f"    device time {row['device_ms']:.4f} ms "
        f"({row['device_ms'] / row['bound_ms']:.1f}x bound)")
    rows.append(row)
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# musicgen-large: K summed codebook embeddings and K logit heads
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_paged():
    """The plain versions of the paged attention kernels and of the append
    in the wrappers' places for the block, on any device (float pools):
    the oracles of the paged paths on the card."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels.kv_append import kv_append_ref
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention_ref)
    plain = {"ragged_paged_attention_op": ragged_paged_attention_ref,
             "paged_attention_op": paged_attention_ref,
             "kv_append_op": kv_append_ref}
    orig = {name: getattr(attention, name) for name in plain}
    for name, fn in plain.items():
        setattr(attention, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(attention, name, fn)


def check_musicgen_parity(*, tiny: bool = False, device: str = "cuda",
                          lens=None) -> dict:
    """musicgen-large at full width in float32 cut to
    MUSICGEN_PARITY_PERIODS, on weights conditioned for soft attention,
    each id broadcast over the codebooks: paths_parity with the kernels,
    held as decode_parity holds its conditioned float32 run (logits 1e-3
    and equal ids on the prefill, decode and gather legs; prefill pools
    and the gather cache 1e-4, decode pools and layer 0's K/V against
    each other and the float64 witness 1e-5 of their largest magnitude);
    then paths_parity again with the plain versions in the kernels'
    places (``plain_paged``) on the same device and weights: the fused
    and per-call prefills' and both decodes' (K, V) logits within 1e-3
    of the kernels', ids equal. ``tiny`` and ``device="cpu"`` rehearse it
    (the plain versions on both runs). Returns the kernels' run."""
    import torch
    kw = dict(conditioned=True, tiny=tiny, device=device,
              model=MUSICGEN_MODEL, lens=lens,
              periods=None if tiny else MUSICGEN_PARITY_PERIODS)
    before = launch_counts()
    r = paths_parity(torch.float32, **kw)
    launched = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    with plain_paged():
        p = paths_parity(torch.float32, **kw)
    name = f"{r['model']} float32, conditioned init"
    (pe, pt), (le, lt), (de, dt) = (r["prefill_pools"], r["layer0_pools"],
                                    r["decode_pools"])
    ge, gt = r["gather_cache"]
    wf, wu, wt = r["layer0_witness"]
    log(f"  {name}, contexts {r['lens']}: prefill extend vs mixed logits "
        f"max_abs_err {r['prefill_err']:.3g}, pools {pe:.3g} of max "
        f"{pt:.3g}; decode paged vs ragged {r['decode_err']:.3g}, pools "
        f"{de:.3g} of max {dt:.3g}; gather vs fused {r['gather_err']:.3g}, "
        f"cache {ge:.3g} of max {gt:.3g}; layer 0's K/V {le:.3g} of "
        f"{lt:.3g}, from the float64 witness fused {wf:.3g}, per-call "
        f"{wu:.3g} of max {wt:.3g}")
    kernel_err = {leg: max_err(r["outputs"][leg], p["outputs"][leg])
                  for leg in r["outputs"]}
    log(f"  {name}: kernels vs plain versions on the {device}, (K, V) "
        f"logits max_abs_err {json.dumps(kernel_err)}; kernel launches "
        f"{json.dumps(launched)}")
    assert r["finite"] and p["finite"], name
    assert r["prefill_err"] <= 1e-3 and pe <= 1e-4 * pt, name
    assert r["decode_err"] <= 1e-3 and de <= 1e-5 * dt, name
    assert r["gather_err"] <= 1e-3 and ge <= 1e-4 * gt, name
    for leg in ("prefill", "decode", "gather"):
        assert r[f"{leg}_ids"][0] == r[f"{leg}_ids"][1], (name, leg)
    assert le <= 1e-5 * lt and max(wf, wu) <= 1e-5 * wt, name
    assert all(e <= 1e-3 for e in kernel_err.values()), kernel_err
    for leg in ("prefill_ids", "decode_ids"):
        assert r[leg] == p[leg], (name, leg)
    if device == "cuda":
        assert all(launched.get(k, 0) > 0 for k in (
            "ragged_paged_attention", "paged_attention", "kv_append")), \
            launched
    log(f"  {name}: held (legs: logits 1e-3 and equal ids, prefill pools "
        "and gather cache 1e-4, decode pools and layer 0's K/V 1e-5 of "
        "max; kernels vs plain versions: logits 1e-3, equal ids)")
    return r


class MusicgenRecorder(Recorder):
    """musicgen_serve's Recorder: the ragged kernel's calls (row 1g) and
    the stager's largest pack, whose two pool leaves (24 layers, 3.2 GB
    each in bf16) it keeps as shapes on the meta device, which is all
    ``time_stager`` reads of them beside the page ids."""

    KEEP = ("ragged_paged_attention", "swap_pack")

    def __init__(self):
        super().__init__()
        self._ops = [op for op in self._ops if op[2] in self.KEEP]

    def __exit__(self, *exc):
        import torch
        if "swap_pack" in self.calls:
            size, args, kw = self.calls["swap_pack"]
            leaves = [torch.empty(leaf.shape, dtype=leaf.dtype,
                                  device="meta") for leaf in args[0]]
            self.calls["swap_pack"] = (size, (leaves, *args[1:]), kw)
        super().__exit__(*exc)


def musicgen_serve(phase: str, recorder=None, *, tiny: bool = False,
                   device: str = "cuda") -> dict:
    """A MUSICGEN_SERVE_PHASES run: the serve run's workload and checks on
    musicgen-large at its phase's depth (tiny: the tiny config, uncut),
    bf16 on the card."""
    policy, engine_kw = MUSICGEN_SERVE_PHASES[phase]
    return serve(policy, recorder, tiny=tiny, device=device,
                 model=MUSICGEN_MODEL,
                 periods=None if tiny else MUSICGEN_SERVE_PERIODS[phase],
                 **engine_kw)


def log_scheduler(res: dict, beside: dict = None) -> None:
    """A serve run's swapped tokens, InferCept's choices (Eq. 5: preserve,
    discard, swap) and the waste ledger's causes, beside another run's
    (llama's serve) where given."""
    def line(r):
        causes = {k: round(v, 6) for k, v in r["ledger_causes"].items() if v}
        return (f"swapped {r['swapped_out_tokens']} tokens out and "
                f"{r['swapped_in_tokens']} in; decisions "
                f"{json.dumps(r['decisions'])}; ledger causes (byte-s) "
                f"{json.dumps(causes)}; {r['kv_token_bytes']} KV bytes a "
                "token")
    log(f"  {res['model']}: {line(res)}")
    if beside is not None:
        log(f"  beside {beside['model']}'s serve run: {line(beside)}")


# the float32 flash kernels by the occupancy exports' kernel code (2 is
# the forward), as their names appear in the build's ptxas report
FLASH_F32_KERNELS = {2: "flash_fwd_split_kernel",
                     0: "flash_bwd_dq_split_kernel",
                     1: "flash_bwd_dkv_split_kernel"}


def log_flash_occupancy(lib, ptxas: list) -> None:
    """Each flash kernel's dynamic shared memory, block size and blocks
    per SM from the library's occupancy exports, and for the float32
    (split) kernels their registers and spills from the ptxas report."""
    import ctypes
    for dtype, tname in ((0, "float32"), (1, "bf16")):
        for hd in (32, 64, 128, 192, 256):
            for kernel, label in ((2, "forward"), (0, "dQ"), (1, "dK/dV")):
                smem, threads = ctypes.c_int(0), ctypes.c_int(0)
                if kernel == 2:
                    n = lib.flash_attention_fwd_occupancy(
                        hd, dtype, ctypes.byref(smem), ctypes.byref(threads))
                else:
                    n = lib.flash_attention_bwd_occupancy(
                        hd, dtype, kernel, ctypes.byref(smem),
                        ctypes.byref(threads))
                assert n > 0, (tname, hd, label)
                regs = ""
                if dtype == 0:
                    mangled = f"{FLASH_F32_KERNELS[kernel]}ILi{hd}E"
                    found = [x.split(": ", 1)[1] for x in ptxas
                             if mangled in x.split(": ", 1)[0]]
                    regs = f"; ptxas: {found[0] if found else 'not found'}"
                log(f"  flash {tname} {label} hd {hd}: {smem.value} B of "
                    f"dynamic shared memory, {n} blocks of {threads.value} "
                    f"threads per SM{regs}")


# --split-tiles: variants of the float32 flash kernels' tiles, each the
# SplitTiles lines of csrc/flash_attention.cu that it names rewritten (an
# expression in HD each; "tree" is the source as it stands), and the
# calls they are timed on: rows 7f / 7bf, 7mf / 7mb and one call at each
# other head dim
SPLIT_TILE_VARIANTS = {
    "tree": {},
    "fwd16": {"kFwdBK": "16"},
    "fwd32": {"kFwdBK": "HD == 256 ? 16 : 32"},
    "dq16": {"kDqBK": "16"},
    "dq32": {"kDqBK": "HD <= 128 ? 32 : 16"},
    "dkv16": {"kDkvBQ": "HD == 32 ? 32 : 16"},
    "dkv32": {"kDkvBQ": "HD <= 128 ? 32 : 16"},
    "own_f32": {"kOwnF32": "true"},
}
SPLIT_TILE_CASES = (
    ("hd32", (4, 8, 4, 2048, 32), {}),
    ("7f/7bf hd64", (4, 8, 4, 2048, 64), {}),
    ("hd128", (2, 8, 4, 2048, 128), {}),
    ("7mf/7mb hd192", (1, 128, 1, 512, 192), {"scale": 192 ** -0.5}),
    ("hd256 window 1024 softcap 50", (1, 8, 2, 4096, 256),
     {"window": 1024, "softcap": 50.0}),
)


def split_tiles_sweep() -> None:
    """``--split-tiles``: build csrc/flash_attention.cu once for each of
    SPLIT_TILE_VARIANTS (one nvcc each, all started together, into
    build/kernels/split_tiles/), log each variant's float32 kernels'
    ptxas registers and spills, shared memory and blocks per SM, check
    each against the plain versions (out 1e-4, gradients 1e-4 of their
    largest magnitude) and time each variant's float32 forward and
    backward at SPLIT_TILE_CASES in turns by CUDA graph replays
    (``graph_ms``, the least of two turns), through this tree's wrappers
    with the variant's library in place of the tree's."""
    import contextlib
    import ctypes
    import re
    import subprocess
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    src = (ROOT / FLASH_SRC).read_text()
    out_dir = _build.BUILD_DIR / "split_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lines in SPLIT_TILE_VARIANTS.items():
        text = src
        for key, expr in lines.items():
            text, n = re.subn(rf"({key} = )[^;]*;", rf"\g<1>{expr};", text)
            assert n == 1, (name, key)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), str(cu), "-o", str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            log(f"  {name}: does not build: {text[-600:]}")
            continue
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn_name, argtypes in _build.SIGNATURES.items():
            if fn_name.startswith("flash_attention"):
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[name] = lib
        ptxas = [x for x in ptxas_report(text) if "split_kernel" in x]
        for kernel, kname in FLASH_F32_KERNELS.items():
            for hd in (32, 64, 128, 192, 256):
                smem, threads = ctypes.c_int(0), ctypes.c_int(0)
                n = (lib.flash_attention_fwd_occupancy(
                    hd, 0, ctypes.byref(smem), ctypes.byref(threads))
                    if kernel == 2 else lib.flash_attention_bwd_occupancy(
                        hd, 0, kernel, ctypes.byref(smem),
                        ctypes.byref(threads)))
                found = [x.split(": ", 1)[1] for x in ptxas
                         if f"{kname}ILi{hd}E" in x.split(": ", 1)[0]]
                log(f"  {name} {kname} hd {hd}: {smem.value} B, {n} blocks "
                    f"of {threads.value} an SM; "
                    f"{found[0] if found else 'no ptxas line'}")

    @contextlib.contextmanager
    def using(lib):
        saved = fa._lib
        fa._lib = lambda: lib
        try:
            yield
        finally:
            fa._lib = saved

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (B, Hkv, G, T, hd), kw in SPLIT_TILE_CASES:
        q = torch.randn((B, Hkv, G, T, hd), generator=gen, device="cuda")
        k, v = (torch.randn((B, Hkv, T, hd), generator=gen, device="cuda")
                for _ in range(2))
        do = torch.randn(q.shape, generator=gen, device="cuda")
        want, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
        want_g = fa.flash_attention_bwd_ref(q, k, v, want, lse, do, **kw)
        scale = max(float(w.abs().max()) for w in want_g)
        names = list(libs)
        for name in names:
            with using(libs[name]):
                out, _ = fa.flash_attention_fwd(q, k, v, **kw)
                grads = fa.flash_attention_bwd(q, k, v, want, lse, do, **kw)
            e_out = max_err(out, want)
            e_g = max(max_err(g, w) for g, w in zip(grads, want_g)) / scale
            ok = e_out <= 1e-4 and e_g <= 1e-4
            log(f"  {label} {name}: out {e_out:.3g}, gradients {e_g:.3g} of "
                f"their max{'' if ok else ' -- misses 1e-4, not timed'}")
            if not ok:
                names.remove(name)
            del out, grads
        del want_g
        ms = {name: [math.inf, math.inf] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                with using(libs[name]):
                    f = graph_ms(lambda: fa.flash_attention_fwd(
                        q, k, v, **kw), 5)
                    b = graph_ms(lambda: fa.flash_attention_bwd(
                        q, k, v, want, lse, do, **kw), 3)
                ms[name] = [min(ms[name][0], f), min(ms[name][1], b)]
        log(f"  {label}: " + "; ".join(
            f"{name} fwd {f:.4f} bwd {b:.4f} ms" for name, (f, b)
            in ms.items()))
        del q, k, v, do, want, lse
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES} (card and build always "
                         "run; timing needs every serve phase for rows "
                         "1-6 (and 3q, 4q), the train phase for the flash "
                         "rows, ssm_serve for the gla_scan row, "
                         "xlstm_train and zamba2_train for the gla "
                         "backward's rows, gemma2_train, gptj_train and "
                         "wide_train_parity for rows 7wb, 7jb and 7mb)")
    ap.add_argument("--parent", default=None,
                    help="another checkout of the port (the parent "
                         "commit's): its attention, append, gla_scan, "
                         "flash (forward and backward), swap and "
                         "latent-attention wrappers and its "
                         "SwapStager are imported "
                         "from there, build their kernels there and are "
                         "timed in turns with these in the swap and "
                         "timing phases")
    ap.add_argument("--split-tiles", action="store_true",
                    help="instead of the phases: build and time the "
                         "float32 flash kernels' tile variants "
                         "(SPLIT_TILE_VARIANTS)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    smi = card()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    name = torch.cuda.get_device_name(0)
    log(f"[card] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if args.split_tiles:
        log("[split_tiles] the float32 flash kernels' tile variants")
        split_tiles_sweep()
        log(f"[done] in {time.perf_counter() - t_start:.1f} s")
        return 0

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    build_log = _build.BUILD_DIR / "build.log"
    ptxas = ptxas_report(build_log.read_text() if build_log.exists() else "")
    for line in ptxas:
        log(f"  {line}")
    import ctypes
    for hd in (32, 64, 128, 256):
        for code, pool in enumerate(("bf16", "int8", "float8_e4m3",
                                     "float8_e5m2")):
            smem = ctypes.c_int(0)
            n = _build.lib().ragged_paged_attention_tc_occupancy(
                hd, code, ctypes.byref(smem))
            log(f"  paged_tc_kernel hd {hd} {pool} pools: {smem.value} B "
                f"of shared memory, {n} blocks of 128 threads per SM")
    # the latent kernel's forms: (pool dtype code, L, R); the launcher
    # picks the form from them
    for code, L, R in ((1, 512, 64), (0, 512, 64), (1, 32, 16)):
        smem = ctypes.c_int(0)
        n = _build.lib().mla_attention_occupancy(code, L, R,
                                                 ctypes.byref(smem))
        form = code == 1 and (L, R) == (512, 64)
        log(f"  mla_attention {'tensor-core' if form else 'CUDA-core'} "
            f"form, {('float32', 'bf16')[code]} pools, L {L} R {R}: "
            f"{smem.value} B of dynamic shared memory, {n} blocks of 256 "
            "threads per SM")
    log_flash_occupancy(_build.lib(), ptxas)

    worst = {k: 0.0 for k in ROWS}
    if "kernels" in phases:
        log("[kernels] each kernel against its plain version on the card")
        worst = check_kernels()
        check_flash_kernels(torch.Generator(device="cuda").manual_seed(0),
                            worst)
        check_gla_kernels(torch.Generator(device="cuda").manual_seed(0),
                          worst)
        check_moe_kernels(torch.Generator(device="cuda").manual_seed(0),
                          worst)
        check_mla_kernels(torch.Generator(device="cuda").manual_seed(0),
                          worst)
    if "tiny" in phases:
        log("[tiny] forward_mixed_paged, decode_step_paged and "
            "extend_step_paged, card kernels vs CPU plain versions; sampled "
            "sessions, fused and unfused")
        check_tiny()
        check_tiny_sampled()
    if "tiny_train" in phases:
        log("[tiny_train] one train step of the tiny config in f32, card "
            "kernels vs CPU plain versions")
        check_tiny_train()
    if "tiny_ssm" in phases:
        log("[tiny_ssm] tiny xlstm in f32: prefill_step and 8 serve_step "
            "calls, card kernel vs CPU plain version")
        check_tiny_ssm()
    if "decode_parity" in phases:
        log("[decode_parity] full width: fused vs per-call prefill, and "
            "ragged_paged_attention vs paged_attention on one decode step")
        check_decode_parity()
    if "train_parity" in phases:
        log("[train_parity] full width f32, B 1 x T 512: loss and gradients "
            "of the flash kernels vs the plain attention on the card")
        check_train_parity()
    if "ssm_train_parity" in phases:
        log("[ssm_train_parity] xlstm-350m (one period, 8 layers) and "
            "zamba2-1.2b (one period and its 2-layer tail) full width f32, "
            "B 1 x T 512: loss and gradients of the gla (and flash) kernels "
            "vs the plain GLA and attention on the card")
        check_ssm_train_parity()
    # the flash backward at head_dim 192 on wide_train_parity's deepseek-v3
    # layer: the timing phase's row 7mb, its launches that model's
    mla_bwd = FlashRecorder()
    if "wide_train_parity" in phases:
        log("[wide_train_parity] gemma2-9b (2 local/global pairs, T 4608), "
            "GPT-J-6B (2 layers, T 512) and deepseek-v3's first dense layer "
            "(T 512) full width f32, B 1: loss and gradients of the flash "
            "kernels (backward at head_dim 256 and 192) vs the plain "
            "attention on the card")
        total_mla_bwd = check_wide_train_parity(recorder=mla_bwd)
    if "ssm_parity" in phases:
        log("[ssm_parity] xlstm-350m full width f32, B 2 x T 520: prefill "
            "with gla_scan vs the plain chunked_gla_ref on the card, and "
            "decode continuation")
        check_prefill_parity("ssm_parity")
    if "wide_parity" in phases:
        log(f"[wide_parity] {' and '.join(WIDE_PARITY_MODELS)} full width, "
            f"8 layers each: fused vs per-call vs gather, contexts "
            f"{WIDE_PARITY_LENS}")
        for model in WIDE_PARITY_MODELS:
            check_decode_parity(model=model, lens=WIDE_PARITY_LENS,
                                periods=WIDE_PARITY_PERIODS[model])
    if "moe_parity" in phases:
        f = moe_ffn()
        cf = f.n_routed_experts / f.top_k
        log(f"[moe_parity] {MOE_MODEL} full width f32, the dense layer and "
            f"{MOE_PARITY_PERIODS[1]} MoE layers: fused vs per-call vs "
            f"gather, prefill at capacity factor {cf:.4g} (a group's "
            f"capacity above the pairs an expert can take from it), "
            f"decode at {f.capacity_factor}")
        check_decode_parity(model=MOE_MODEL, periods=MOE_PARITY_PERIODS,
                            prefill_cf=cf)
    # the flash forward at head_dim 192 on mla_parity's bf16 forward leg:
    # the timing phase's row 7m, its launches that leg's
    mla_flash = FlashRecorder()
    if "mla_parity" in phases:
        log(f"[mla_parity] {MLA_MODEL} full width f32, its dense group "
            f"({MLA_PARITY_PERIODS[0]} layers): LM.forward (flash at "
            "head_dim 192) vs fused vs per-call vs gather")
        before = launch_counts()
        check_decode_parity(model=MLA_MODEL, periods=MLA_PARITY_PERIODS,
                            forward_leg=True, recorder=mla_flash)
        after = launch_counts()
        # the float32 legs' latent pools take the CUDA-core form, the bf16
        # leg's the tensor-core form
        tc = after["mla_attention_tc"] - before["mla_attention_tc"]
        cc = after["mla_attention"] - before["mla_attention"] - tc
        assert tc > 0 and cc > 0, after
        log(f"  the latent kernel launched {cc} times in its CUDA-core form "
            f"(float32 pools), {tc} in its tensor-core form (bf16)")
        # the float32 legs' flash forwards at 192: row 7mf's launches
        mla_f32 = after["flash_attention_f32"] - before["flash_attention_f32"]
        assert mla_f32 > 0, after
        log(f"  the flash forward at 192 launched {mla_f32} times in float32 "
            f"(the split kernel), {mla_flash.launches} in bf16 (row 7m's)")
    if "zamba2_parity" in phases:
        log("[zamba2_parity] zamba2-1.2b full width f32, 2 x (5 mamba2 + "
            "the shared block) + 1 mamba2, B 2 x T 520: prefill with "
            "gla_scan and flash vs the plain GLA and attention on the card, "
            "and decode continuation")
        check_prefill_parity("zamba2_parity")
    if "pixtral_parity" in phases:
        log("[pixtral_parity] pixtral-12b full width f32, 4 layers, B 2 x "
            "(a 1024-row vision prefix + 64 tokens): prefill with flash vs "
            "the plain attention on the card, and decode continuation")
        check_prefill_parity("pixtral_parity")
    if "musicgen_parity" in phases:
        log(f"[musicgen_parity] {MUSICGEN_MODEL} full width f32, "
            f"{MUSICGEN_PARITY_PERIODS[0]} layers, each id broadcast over "
            "the codebooks: fused vs per-call vs gather, and the kernels vs "
            "their plain versions on the card")
        check_musicgen_parity()
    parent = None
    if args.parent:
        t0 = time.perf_counter()
        parent = parent_kernels(Path(args.parent).resolve())
        parent.build()
        log(f"[parent] its kernels built from {args.parent} in "
            f"{time.perf_counter() - t0:.1f} s")
    recorder = Recorder()
    # the kernels line's rows, and the latent kernel's tensor-core count
    # beside them (launch_counts' keys)
    total = {k: 0 for k in ROWS + ("mla_attention_tc",)}
    results = {}
    for phase, (policy, engine_kw) in SERVE_PHASES.items():
        if phase not in phases:
            continue
        log(f"[{phase}] llama3.2-1b full width, bf16, policy {policy}"
            f"{''.join(f', {k}={v}' for k, v in engine_kw.items())}")
        # the timing phase's records and per-size launch counts are the
        # timed phases' own, as the kernels line's totals are
        probe = SamplerProbe(on_card=True) if phase == "sample" \
            else contextlib.nullcontext()
        periods = CUT_SERVE_PERIODS.get(phase)
        if periods is not None:
            log(f"  cut to {layers('llama3.2-1b', periods)} layers")
        with probe:
            res = results[phase] = serve(
                policy,
                recorder if phase in TIMED_SERVE_PHASES else Recorder(),
                periods=periods, **engine_kw)
        if phase in TIMED_SERVE_PHASES:
            for k, v in res["launches"].items():
                total[row_key(k, res["kv_dtype"])] += v
        else:
            # the kernels line's launches stay those of the timed serve
            # phases and train, as they were before these phases came
            log(f"  launches (not in the kernels line): "
                f"{json.dumps(res['launches'])}")
        if phase in ("serve", "swap", "quant", "gather", "sample",
                     *SANITIZED_OF):
            # every swapped page came back, one launch per pack and unpack
            # (serve() holds the launches to the stager's counts)
            assert res["swapped_out_tokens"] > 0, "nothing was swapped"
            assert res["swapped_in_tokens"] == res["swapped_out_tokens"]
            assert res["stager"]["packs"] > 0 and \
                res["stager"]["unpacks"] > 0, res["stager"]
            assert res["stager"]["unpacked_pages"] == \
                res["stager"]["packed_pages"], res["stager"]
        if phase == "swap":
            res["stager_ms"] = time_stager(recorder, parent)
        if phase == "sample":
            check_sample_phase(res, probe, results.get("serve"))
        if phase == "spec":
            assert res["spec"]["spec_accepted"] > 0, res["spec"]
            assert res["launches"]["ragged_paged_attention"] > 0
        if phase == "quant":
            if "serve" in results:
                bf16 = results["serve"]
                log(f"  kv_token_bytes {res['kv_token_bytes']} (bf16 serve "
                    f"{bf16['kv_token_bytes']}), run peak "
                    f"{res['run_peak_bytes']} B (bf16 serve "
                    f"{bf16['run_peak_bytes']}), max_memory_allocated "
                    f"{res['max_memory_allocated']} (bf16 serve "
                    f"{bf16['max_memory_allocated']})")
        if phase in SANITIZED_OF:
            # the sanitizer only observes: the same streams and counters
            # as an unsanitized run of the same depth in this process
            twin_kw = {k: v for k, v in engine_kw.items() if k != "sanitize"}
            plain = serve(policy, Recorder(), periods=periods, **twin_kw)
            assert res["streams"] == plain["streams"], phase
            assert res["counters"] == plain["counters"], phase
            log(f"  no findings; streams and counters equal to an "
                f"unsanitized {SANITIZED_OF[phase]} run's at "
                f"{plain['model']}")
        if phase in ("unfused", "spec", "gather") and "serve" in results \
                and periods is None:
            # bf16 at full width with random weights: the paths can part
            # at a near-tie of the argmax, so the share is reported, and
            # correctness rests on decode_parity and the kernel checks
            same = sum(a == b for a, b in zip(res["streams"],
                                              results["serve"]["streams"]))
            log(f"  streams identical to the serve run: {same} of "
                f"{len(res['streams'])}")
    # the head_dim-256 serve runs; the gemma2 runs' attention calls give the
    # timing phase's rows 1w, 1wd, 1wq and 5w
    wide_rec = Recorder()
    wide = {}
    for phase, (model, policy, engine_kw) in WIDE_SERVE_PHASES.items():
        if phase not in phases:
            continue
        periods = WIDE_CUT_PERIODS.get(phase, WIDE_SERVE_PERIODS.get(model))
        log(f"[{phase}] {model} full width, "
            f"{layers(model, periods)} layers, bf16, policy {policy}"
            f"{''.join(f', {k}={v}' for k, v in engine_kw.items())}")
        res = wide[phase] = serve(
            policy, wide_rec if model == "gemma2-9b" else None, model=model,
            periods=periods, **engine_kw)
        log(f"  launches (not in the kernels line): "
            f"{json.dumps(res['launches'])}")
        log(f"  {smi}: {res['tokens_per_s']:.2f} tok/s over "
            f"{res['steps']} steps, max_memory_allocated "
            f"{res['max_memory_allocated']} B, KV pools "
            f"{res['kv_pool_bytes']} B, swapped "
            f"{res['swapped_out_tokens']} tokens out and "
            f"{res['swapped_in_tokens']} in")
        # every swapped page came back (serve() holds one launch per pack
        # and unpack, and every page back in the pool)
        assert res["swapped_in_tokens"] == res["swapped_out_tokens"]
        assert res["stager"]["unpacked_pages"] == \
            res["stager"]["packed_pages"], res["stager"]
    if set(WIDE_SERVE_PHASES) <= phases:
        # rows 1, 2, 3-4, 5, 1q and 2q all launched at head_dim 256
        summed = {k: sum(r["launches"][k] for r in wide.values())
                  for k in ("ragged_paged_attention", "kv_append",
                            "swap_pack", "swap_unpack", "paged_attention",
                            "kv_append_quant")}
        assert all(v > 0 for v in summed.values()), summed
        assert wide["gemma2_quant"]["launches"][
            "ragged_paged_attention"] > 0, wide["gemma2_quant"]
        log(f"  head_dim-256 launches over the four runs: "
            f"{json.dumps(summed)}")
    # deepseek-moe-16b; moe_serve's MoE calls give the timing phase's rows
    # 9 and 9d
    moe_rec = MoERecorder()
    moe_runs = {}
    for phase, (policy, engine_kw) in MOE_SERVE_PHASES.items():
        if phase not in phases:
            continue
        periods = MOE_SERVE_PERIODS if phase == "moe_serve" \
            else MOE_UNFUSED_PERIODS
        log(f"[{phase}] {MOE_MODEL} full width, "
            f"{layers(MOE_MODEL, periods)} layers, bf16, policy "
            f"{policy}"
            f"{''.join(f', {k}={v}' for k, v in engine_kw.items())}")
        with moe_rec if phase == "moe_serve" else contextlib.nullcontext():
            res = moe_runs[phase] = serve(policy, model=MOE_MODEL,
                                          periods=periods, **engine_kw)
        log(f"  launches (not in the kernels line): "
            f"{json.dumps(res['launches'])}")
        log(f"  {smi}: {res['tokens_per_s']:.2f} tok/s over "
            f"{res['steps']} steps, construction peak "
            f"{res['init_peak_bytes']} B, run peak {res['run_peak_bytes']} "
            f"B, KV pools {res['kv_pool_bytes']} B, swapped "
            f"{res['swapped_out_tokens']} tokens out and "
            f"{res['swapped_in_tokens']} in")
        assert res["swapped_in_tokens"] == res["swapped_out_tokens"]
        assert res["stager"]["unpacked_pages"] == \
            res["stager"]["packed_pages"], res["stager"]
    if set(MOE_SERVE_PHASES) <= phases:
        # rows 1, 2, 3-4, 5 and the MoE kernels all launched
        summed = {k: sum(r["launches"][k] for r in moe_runs.values())
                  for k in ("ragged_paged_attention", "kv_append",
                            "swap_pack", "swap_unpack", "paged_attention",
                            "moe_experts")}
        assert all(v > 0 for v in summed.values()), summed
        log(f"  {MOE_MODEL} launches over the two runs: "
            f"{json.dumps(summed)}")
    # deepseek-v3 at full width, cut to its dense group and one MoE layer;
    # mla_serve's calls give the timing phase's rows 10, 10d and 2m
    mla_rec = MLARecorder()
    mla_runs = {}
    for phase, (policy, engine_kw) in MLA_SERVE_PHASES.items():
        if phase not in phases:
            continue
        periods = MLA_SERVE_PERIODS if phase == "mla_serve" \
            else MLA_UNFUSED_PERIODS
        log(f"[{phase}] {MLA_MODEL} full width, {periods[0]} dense"
            f" + {periods[1]} MoE layers, bf16, policy {policy}"
            f"{''.join(f', {k}={v}' for k, v in engine_kw.items())}")
        with mla_rec if phase == "mla_serve" else contextlib.nullcontext():
            res = mla_runs[phase] = serve(policy, model=MLA_MODEL,
                                          periods=periods, **engine_kw)
        log(f"  launches (not in the kernels line): "
            f"{json.dumps(res['launches'])}")
        log(f"  {smi}: {res['tokens_per_s']:.2f} tok/s over "
            f"{res['steps']} steps ({res['step_ms']:.1f} ms a step), "
            f"construction peak {res['init_peak_bytes']} B, run peak "
            f"{res['run_peak_bytes']} B, KV pools {res['kv_pool_bytes']} B, "
            f"swapped {res['swapped_out_tokens']} tokens out and "
            f"{res['swapped_in_tokens']} in")
        assert res["swapped_in_tokens"] == res["swapped_out_tokens"]
        assert res["stager"]["unpacked_pages"] == \
            res["stager"]["packed_pages"], res["stager"]
    if set(MLA_SERVE_PHASES) <= phases:
        # rows 10, 2 and 9 (and the swaps) launched, rows 1 and 5 never
        summed = {k: sum(r["launches"][k] for r in mla_runs.values())
                  for k in ("mla_attention", "mla_attention_tc",
                            "kv_append", "moe_experts",
                            "swap_pack", "swap_unpack",
                            "ragged_paged_attention", "paged_attention")}
        assert all(summed[k] > 0 for k in ("mla_attention", "kv_append",
                                           "moe_experts")), summed
        assert summed["ragged_paged_attention"] == summed[
            "paged_attention"] == 0, summed
        # bf16 latent pools: row 10's tensor-core form, never the CUDA-core
        assert summed["mla_attention_tc"] == summed["mla_attention"], summed
        log(f"  {MLA_MODEL} launches over the two runs: "
            f"{json.dumps(summed)}")
    # musicgen-large: musicgen_serve's ragged calls give the timing phase's
    # row 1g, its largest swap the stager's host times at its widths
    musicgen_rec = MusicgenRecorder()
    musicgen = {}
    for phase, (policy, engine_kw) in MUSICGEN_SERVE_PHASES.items():
        if phase not in phases:
            continue
        periods = MUSICGEN_SERVE_PERIODS[phase]
        log(f"[{phase}] {MUSICGEN_MODEL} full width, "
            f"{layers(MUSICGEN_MODEL, periods)} layers, bf16, policy "
            f"{policy}"
            f"{''.join(f', {k}={v}' for k, v in engine_kw.items())}")
        res = musicgen[phase] = musicgen_serve(
            phase, musicgen_rec if phase == "musicgen_serve" else None)
        log(f"  launches (not in the kernels line): "
            f"{json.dumps(res['launches'])}")
        log(f"  {smi}: {res['tokens_per_s']:.2f} tok/s over "
            f"{res['steps']} steps ({res['step_ms']:.1f} ms a step), "
            f"construction peak {res['init_peak_bytes']} B, run peak "
            f"{res['run_peak_bytes']} B, KV pools {res['kv_pool_bytes']} B "
            f"({res['kv_token_bytes']} B a token)")
        log_scheduler(res, results.get("serve"))
        assert res["swapped_in_tokens"] == res["swapped_out_tokens"]
        assert res["stager"]["unpacked_pages"] == \
            res["stager"]["packed_pages"], res["stager"]
        if phase == "musicgen_serve" and res["stager"]["packs"]:
            res["stager_ms"] = time_stager(musicgen_rec, None)
    if set(MUSICGEN_SERVE_PHASES) <= phases:
        # rows 1, 2, 3-4 and 5 all launched at 32 kv heads x G 1
        summed = {k: sum(r["launches"][k] for r in musicgen.values())
                  for k in ("ragged_paged_attention", "kv_append",
                            "swap_pack", "swap_unpack", "paged_attention")}
        assert all(v > 0 for v in summed.values()), summed
        log(f"  {MUSICGEN_MODEL} launches over the two runs: "
            f"{json.dumps(summed)}")
    flash_rec = FlashRecorder()
    if "train" in phases:
        log("[train] llama3.2-1b full width, bf16 params, f32 AdamW, remat, "
            "SyntheticLM B 4 x T 2048")
        res = train(flash_rec, profile="profile" in phases)
        for k in ("flash_attention", "flash_attention_bwd"):
            total[k] += res["launches"][k]
    # the float32 train path: its first attention call gives rows 7f, 7bf
    flash_f32 = FlashRecorder()
    if "train_f32" in phases:
        log("[train_f32] llama3.2-1b full width in float32 (the train "
            "launcher's default dtype), f32 AdamW, remat, SyntheticLM B 4 x "
            "T 2048, 2 warm-up and 4 timed steps, one profiled; then "
            "python -m repro_torch.launch.train with its defaults")
        res = train_f32(flash_f32)
        for k in ("flash_attention_f32", "flash_attention_bwd_f32"):
            total[k] += res["launches"][k]
    # the SSM models' train runs: the first GLA call of each, with the
    # gradients that reached it, gives the timing phase's rows 8b and 8zb
    ssm_train_recs = {phase: GLARecorder(grad=True) for phase in SSM_TRAIN}
    ssm_train_rows = {"xlstm_train": "gla_scan_bwd",
                      "zamba2_train": "gla_scan_bwd_zamba2"}
    for phase, (model, batch, seq, warm, timed) in SSM_TRAIN.items():
        if phase not in phases:
            continue
        log(f"[{phase}] {model} full width and depth "
            f"({layers(model)} layers), bf16 params, f32 AdamW, remat, "
            f"SyntheticLM B {batch} x T {seq}, {warm} warm-up and {timed} "
            "timed steps")
        res = train(ssm_train_recs[phase], model=model, batch=batch,
                    seq=seq, warm=warm, timed=timed,
                    profile="profile" in phases,
                    profile_seq=PROFILE_SEQ.get(phase))
        total[ssm_train_rows[phase]] = res["launches"]["gla_scan_bwd"]
        log(f"  (its gla_scan_bwd launches are row {ssm_train_rows[phase]}"
            f"'s in the kernels line; the rest are logged apart: "
            f"{json.dumps({k: v for k, v in res['launches'].items() if v})})")
        log(f"  {smi}: {res['step_ms_mean']:.1f} ms a step, "
            f"{res['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
            f"{res['max_memory_allocated']} B")
    # the head_dim-256 models' train runs: the first attention call of
    # each, with the gradient that reached it, gives the timing phase's rows
    # 7wb and 7jb
    wide_train_recs = {phase: FlashRecorder() for phase in WIDE_TRAIN}
    for phase, (model, periods, batch, seq, warm, timed) in \
            WIDE_TRAIN.items():
        if phase not in phases:
            continue
        log(f"[{phase}] {model} full width, {layers(model, periods)} layers, "
            f"bf16 params, f32 AdamW, remat, SyntheticLM B {batch} x T {seq}"
            f", {warm} warm-up and {timed} timed steps")
        with expandable_segments():
            res = train(wide_train_recs[phase], model=model,
                        periods=periods, batch=batch, seq=seq, warm=warm,
                        timed=timed, profile="profile" in phases
                        and phase == "gemma2_train")
        total[WIDE_TRAIN_ROWS[phase]] = res["launches"]["flash_attention_bwd"]
        log(f"  (its flash_attention_bwd launches are row "
            f"{WIDE_TRAIN_ROWS[phase]}'s in the kernels line; the rest are "
            f"logged apart: "
            f"{json.dumps({k: v for k, v in res['launches'].items() if v})})")
        log(f"  {smi}: {res['step_ms_mean']:.1f} ms a step, "
            f"{res['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
            f"{res['max_memory_allocated']} B")
    # the first call of each serve-step run that a timing row takes
    serve_recs = {"ssm_serve": GLARecorder(), "wide_dense": FlashRecorder(),
                  "zamba2_serve": GLARecorder(),
                  "pixtral_serve": FlashRecorder()}
    # the timing rows whose launches a serve-step run's are: (row, kernel)
    serve_rows = {"ssm_serve": ("gla_scan", "gla_scan"),
                  "wide_dense": ("flash_attention_hd256", "flash_attention"),
                  "zamba2_serve": ("gla_scan_zamba2", "gla_scan"),
                  "pixtral_serve": ("flash_attention_pixtral",
                                    "flash_attention")}
    for phase, spec in MODEL_SERVES.items():
        if phase not in phases:
            continue
        log(f"[{phase}] {spec['model']} full width, bf16, seed-0 port init: "
            f"prefill_step of 8 x {spec['seq']}"
            f"{' after its vision prefix' if phase == 'pixtral_serve' else ''}"
            f", then {spec['steps']} greedy serve_step calls")
        res = model_serve(phase, serve_recs.get(phase),
                          profile="profile" in phases)
        if phase in serve_rows:
            row_name, kernel = serve_rows[phase]
            total[row_name] = res["launches"][kernel]
            log(f"  (its {kernel} launches are row {row_name}'s in the "
                "kernels line)")
        else:
            log("  (its launches are not in the kernels line, whose flash "
                "row is the train step's)")
        log(f"  {smi}: prefill {res['prefill_tokens_per_s']:.1f} tok/s, "
            f"decode {res['decode_tokens_per_s']:.1f} tok/s, "
            f"max_memory_allocated {res['max_memory_allocated']} B")
    rows = []
    if "timing" in phases and set(TIMED_SERVE_PHASES) <= phases:
        log("[timing] CUDA events on the inputs of each kernel's largest "
            "main-path call")
        total["ragged_paged_attention_decode"] = recorder.decode_launches
        rows = time_kernels(recorder, worst, total, parent)
    if "timing" in phases and "train" in phases:
        log("[timing] flash attention on the train step's first attention "
            "call")
        rows += time_flash(flash_rec, worst, total, parent)
    if "timing" in phases and "train_f32" in phases:
        log("[timing] the float32 flash (the split kernels) on train_f32's "
            "first attention call (rows 7f, 7bf)")
        rows += time_flash(flash_f32, worst, total, parent,
                           names=("flash_attention_f32",
                                  "flash_attention_bwd_f32"))
    if parent and "timing" in phases and "train" in phases and \
            set(TIMED_SERVE_PHASES) <= phases:
        log("[timing] rows 1, 1d, 5 and 7 at head_dim 128, in turns with "
            "the parent's kernels")
        time_hd128_twins(recorder, flash_rec, parent)
    if "timing" in phases and "ssm_serve" in phases:
        log("[timing] gla_scan on the first mLSTM call of the xlstm "
            "prefill")
        rows += time_gla(serve_recs["ssm_serve"], worst, total, parent)
    if "timing" in phases and {"gemma2_serve", "gemma2_unfused",
                               "gemma2_quant"} <= phases:
        log("[timing] head_dim 256: the attention kernels on gemma2's "
            "largest calls")
        total["ragged_paged_attention_hd256"] = wide["gemma2_serve"][
            "launches"]["ragged_paged_attention"]
        total["ragged_paged_attention_hd256_decode"] = \
            wide_rec.decode_launches
        total["ragged_paged_attention_hd256_int8"] = wide.get(
            "gemma2_quant", {"launches": {"ragged_paged_attention": 0}})[
            "launches"]["ragged_paged_attention"]
        total["paged_attention_hd256"] = wide["gemma2_unfused"][
            "launches"]["paged_attention"]
        rows += time_wide(wide_rec, worst, total)
    if "timing" in phases and "wide_dense" in phases:
        log("[timing] head_dim 256: flash attention on the first attention "
            "call of the gemma2 prefill")
        rows += time_prefill_flash(serve_recs["wide_dense"], worst, total,
                                   "flash_attention_hd256")
    if "timing" in phases and "moe_serve" in phases:
        log("[timing] the MoE kernels on moe_serve's largest call and its "
            "largest decode-only call")
        total["moe_experts"] = moe_runs["moe_serve"]["launches"][
            "moe_experts"]
        total["moe_experts_decode"] = moe_rec.decode_launches
        rows += time_moe(moe_rec, worst, total)
    if "timing" in phases and "mla_serve" in phases:
        log("[timing] the latent-attention kernel on mla_serve's largest "
            "call and its largest decode-only call, and kv_append at the "
            "latent widths")
        total["mla_attention"] = mla_runs["mla_serve"]["launches"][
            "mla_attention_tc"]
        total["mla_attention_decode"] = mla_rec.decode_launches
        total["kv_append_latent"] = mla_runs["mla_serve"]["launches"][
            "kv_append"]
        rows += time_mla(mla_rec, worst, total, parent)
    if "timing" in phases and "mla_parity" in phases:
        log("[timing] flash attention at head_dim 192 on mla_parity's "
            "largest forward call")
        total["flash_attention_hd192"] = mla_flash.launches
        rows += time_prefill_flash(mla_flash, worst, total,
                                   "flash_attention_hd192", iters=5)
        log("[timing] the float32 flash forward at head_dim 192 on the same "
            "call in float32 (row 7mf)")
        total["flash_attention_hd192_f32"] = mla_f32
        rows += time_prefill_flash(mla_flash, worst, total,
                                   "flash_attention_hd192_f32", iters=5,
                                   dtype=torch.float32, parent=parent)
    if "timing" in phases and "zamba2_serve" in phases:
        log("[timing] gla_scan on the first mamba2 call of the zamba2 "
            "prefill (row 8z)")
        rows += time_gla(serve_recs["zamba2_serve"], worst, total,
                         name="gla_scan_zamba2")
    for phase, row_name in ssm_train_rows.items():
        if "timing" in phases and phase in phases:
            log(f"[timing] the gla backward on the first GLA call of "
                f"{phase} (row {row_name})")
            rows += time_gla_bwd(ssm_train_recs[phase], worst, total,
                                 row_name)
    for phase, row_name in WIDE_TRAIN_ROWS.items():
        if "timing" in phases and phase in phases:
            log(f"[timing] the flash backward on the first attention call of "
                f"{phase} (row {row_name})")
            rows += time_flash_bwd(wide_train_recs[phase], worst, total,
                                   row_name, parent=parent)
    if "timing" in phases and "wide_train_parity" in phases:
        log("[timing] the flash backward at head_dim 192 on "
            "wide_train_parity's deepseek-v3 call (row flash_attention_bwd_"
            "hd192)")
        total["flash_attention_bwd_hd192"] = total_mla_bwd
        rows += time_flash_bwd(mla_bwd, worst, total,
                               "flash_attention_bwd_hd192", iters=5,
                               parent=parent)
    if "timing" in phases and "pixtral_serve" in phases:
        log("[timing] flash attention on the first attention call of the "
            "pixtral prefill (row 7p)")
        rows += time_prefill_flash(serve_recs["pixtral_serve"], worst,
                                   total, "flash_attention_pixtral")
    if "timing" in phases and "musicgen_serve" in phases:
        log("[timing] the ragged kernel on musicgen_serve's largest call "
            "(row 1g)")
        total["ragged_paged_attention_musicgen"] = musicgen[
            "musicgen_serve"]["launches"]["ragged_paged_attention"]
        rows.append(time_attention_row(
            musicgen_rec, worst, total, "ragged_paged_attention_musicgen",
            "ragged_paged_attention", head_dim=64))
    if "timing" in phases and set(TIMED_SERVE_PHASES) | {
            "train", "train_f32", "ssm_serve", "gemma2_serve",
            "gemma2_unfused", "gemma2_quant", "wide_dense", "moe_serve",
            "mla_serve", "mla_parity", "zamba2_serve", "pixtral_serve",
            "musicgen_serve", *SSM_TRAIN, *WIDE_TRAIN,
            "wide_train_parity"} <= phases:
        assert sorted(r["name"] for r in rows) == sorted(ROWS), rows
        # every kernel of the main path launched; page_requant is the
        # reference's standalone op, which the fused append replaced there
        assert all(r["launches"] > 0 for r in rows
                   if r["name"] != "page_requant"), rows
    if "profile" in phases:
        # 10 serve steps after 10 each: the profiler's own processing of
        # longer windows was most of the phase's time
        log("[profile] torch.profiler over 10 serve steps after 10, "
            "InferCept policy")
        profile_serve()
        log("[profile] the same over int8 pools")
        profile_serve(kv_dtype="int8")
        log(f"[profile] the same on {MOE_MODEL} "
            f"({layers(MOE_MODEL, MOE_SERVE_PERIODS)} layers)")
        profile_serve(model=MOE_MODEL, periods=MOE_SERVE_PERIODS)
        log(f"[profile] the same on {MLA_MODEL} "
            f"({MLA_SERVE_PERIODS[0]} dense + {MLA_SERVE_PERIODS[1]} MoE "
            "layers)")
        profile_serve(model=MLA_MODEL, periods=MLA_SERVE_PERIODS)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
