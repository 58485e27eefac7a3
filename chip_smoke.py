#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (llamago_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DETAIL.json] [--only PHASE,...]

Every phase runs at the JAX package's prefill floor (1024 GiB: windows of
t > 32 over the dense cache on the einsum math) unless
LLAMAGO_ATTN_PREFILL_FLOOR is set, so that "the default routes" below are
the JAX package's and "the opt-in routes" put K7 (and K10) in their place.
The card's own default sends those windows to K7 (ops/attention.py
can_fuse_attention): the opt-in routes' K7 without K10, which `k2_pair.py
--kernel k7cells` and the benchmark's cells run.

Phases, each of which fails the run (exit code 1, no result line):

  1. print the card (nvidia-smi name and power limit) and build every
     CUDA kernel from csrc/ with nvcc (one process per source, together);
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it (K3 and K5's activation quantization
     bit for bit), and time the kernel, the plain version, one PyTorch
     library call computing the same function where there is one (a
     yardstick the port never calls) and the bound (the larger of bytes
     over 3.35 TB/s and operations over the peak rate of their type: 989
     TFLOP/s bf16, 1,979 TOPS int8, 67 TFLOP/s f32, 495 / 3 TFLOP/s for
     three TF32 products a product; H100 SXM data sheet).
     K1 (Q8_0 and Q4_0, each of its four forms: up to 8 rows the
     tensor-core decode form, for bf16 x and for f32 x as its three exact
     bf16 parts split in the kernel (f32_decode_tc), checked at m = 1 to 8
     into NaN-filled memory and timed at 4 and 8; above that the
     tensor-core tile for bf16 x and for f32 x as its three exact bf16
     parts, f32_tc, checked at m = 9 to 256 and at 512 (a perplexity
     window) into NaN-filled memory and timed at 64, 256 and 512 against
     three bf16 passes), K2 (its
     tensor-core form for a bf16 cache, checked and timed at t = 1 for
     fills 1 to 1024 with the serving fill 101 and the split's edges, at
     t = 8 (the speculative verify window, fills 101 and 1024) and at
     t = 32; GQA at hd = 64 checked; its f32 form, 3xTF32 on the
     tensor cores, checked at t = 1, 8, 16 and 32, fills 101 and 1024, within
     1e-4, into NaN-filled memory, and timed beside SDPA on the same f32
     tensors), K3 (on
     contiguous rows with int32 positions and on the serving path's own
     inputs, v a strided view of the fused projection and int64
     positions, where one call must be one device kernel), K4 (its
     tensor-core form at S = 1024, checked and timed at t = 1 for fills 1
     to 1024 with the serving fill 101 and the S-block's edges, at t = 8
     (the verify window), 16 and 32; its CUDA-core form at S = 520
     checked), K8 (its tensor-core
     form with bf16 q, timed at t = 1 and 32 and checked on its splits'
     edges; its CUDA-core form with f32 q, and at S = 520); K3, K4 and K8
     with f32 and with bf16 scale planes; K4 and K8 repeat their bits into
     NaN-filled memory),
     K5 (W4A8 decode matmul: its int8 tensor-core decode form for f32 and
     bf16 x, checked at m = 1 to 16 at the five 7B int4 shapes into
     NaN-filled memory, and at 20 and 33 with its switch raised, timed at 4
     and 16, every call counted as that form), K6 (w4x8 stream
     matmul: the tensor-core tile for bf16 x and for f32 x as its three
     bf16 parts, checked at m = 17 to 256 into NaN-filled memory, timed at
     64 and 256), K9
     (scale-on-output matmul, each of its forms: the tensor-core decode
     form for bf16 x and for f32 x as three bf16 parts at m <= 8, checked
     at m = 1 to 8 into NaN-filled memory, bf16 x timed at 4 and f32 x at 4
     and 8; above 8 rows the tensor-core tile on the raw integers, so_tc,
     for bf16 x and for f32 x as three bf16 parts, checked at m = 9, 16,
     17, 32, 64 and 256 into NaN-filled memory and timed at 16 and 64 for
     Q8_0 and Q4_0 beside x @ W), K7 (flash
     prefill attention, bf16 and f32, at the 7B prefill windows and the
     512-token perplexity window; its 3xTF32 f32 form checked within 1e-4 into
     NaN-filled memory and timed beside SDPA on f32 tensors) and
     K10 (fused RMSNorm, into NaN-filled memory);
     K3 and K10 are timed beside the card's floor for one small launch (a
     `fill_` of one element); then (`llama3`) the shapes LLaMA-3-8B gives
     them: K1 (Q8_0) at its projections (wqkv 4096 x 6144, wo 4096 x 4096,
     w13 4096 x 28672, w2 14336 x 4096, the head padded to 131,072 columns)
     checked at m = 1, 4, 8, 9 and 64 with bf16 and f32 x and timed at m = 4
     and 64 in each x dtype, every call counted as its form; K2 at b = 4,
     KV = 8, 4 query rows a kv head, hd = 128, S = 1024, bf16 and f32; K3
     at b = 8, KV = 8 on the serving path's GQA rows, bit for bit, fills 101
     and 1024; K4 at b = 8, KV = 8, g = 4 in its tensor-core form; the
     attention kernels timed at fills 101 and 1024 beside SDPA with
     enable_gqa;
  3. check the port end to end on a small model: logits and greedy tokens
     on the card (through the kernels) against the CPU (plain versions),
     with the dense cache, then the int8 cache under K4 and under K8, then
     the dense cache with the opt-in routes on (prefill floor 0: K7;
     USE_FUSED_NORM: K10) and the int8 cache with bf16 scale planes, then
     int4 weights in the w4x8 format (K5, K6 and, for the leaf whose K is
     no multiple of 128, K1 bits=4), in the Q4_0 format (K1 bits=4) and in
     the Q4_0 format with the scale-on-output switch at 8 (K9's decode
     form) and at 256 (its tile on x's three bf16 parts in the prefill
     windows, no K1 call); then the
     dense cache, the int8 cache under K8, the w4x8 model and the Q4_0
     model with the switch on at 8 and at 256 (K9's tile in the prefill
     windows) in bf16 on the card against the CPU's f32
     (K1's and K6's tensor-core tiles, K1's decode form and the
     tensor-core forms of K2, K8 and K9 must launch; with f32 x K1, K2, K8
     and K9 take only their f32 forms: K1 and K6 their tile on x's three
     bf16 parts in the prefill windows, K1 and K9 their decode form on
     x's three bf16 parts in the decode steps, K2 and K7 their 3xTF32
     forms);
  4. serve full-width LLaMA-7B with random Q8_0 weights (widths and
     weights as MODEL_PRESETS["7B"], random from seed 0; 16 of its 32 layers
     since phase 8 joined and 8 since phase 8b joined, for the time limit,
     in phases 4 to 4d, 4f and 4g) over the REST job API:
     8 sampled jobs over HTTP on 4 slots with decode chunks of 32, then a
     greedy job twice. The launch counts of K1, its tensor-core decode
     form (`launches_decode_tc`: every decode step), its tensor-core tile
     (`launches_tc`: every prompt's prefill) and K2 (its tensor-core form,
     `launches_decode_tc`) must rise while serving, those of the int8
     cache's kernels stay 0. Then one 64-token prefill chunk is timed and
     traced (device busy time, K1's share of it, the attention kernels'
     time) and one decode chunk of the 4 slots for where a decode step's
     time goes (device busy share, the matmul and attention kernels, top
     kernels and host ops);
  4b. the same with the int8 KV cache (`kv_dtype="int8"`) on 8 slots and
     16 jobs, after phase 4's engine is freed: K1 (its tensor-core decode
     form and tile), K3 and K4 (every call in its tensor-core form) must
     launch, K2 and K8 not; then 8 jobs with K8 and K9 on
     (LLAMAGO_ATTN_I8DOT=0, LLAMAGO_KERNEL_SO_MAX_M=256): K8 and K9 must
     launch, every call in its tensor-core form (K9's decode form in the
     decode steps, its tile in the prefill chunks), K1 not at all, and
     the decode step's `attention_ms` and `matmul_ms` are logged beside the
     default routes';
  4c. the same with random int4 weights in the w4x8 format and the bf16
     cache on 4 slots and 8 jobs, after the int8 weights are freed: K5 (its
     form in the decode step's `matmul_ms`), K6 (its tensor-core tile: every
     prompt's prefill) and K2 must launch,
     every other kernel (K1's forms too) stay at 0; K6's tensor-core tile
     stays at 0 in every other serving phase;
  4d. Q8_0 weights and the bf16 cache on 4 slots again, now with 8 jobs of
     which four bring prompts of about 600 tokens (prefill chunks of 256,
     256 and 128 tokens), run twice: with the default routes (the einsum
     attention materializes the scores; K1 (its decode form and tile) and
     K2 launch, as in phase 4;
     a 256-token prefill chunk is profiled beside the 64-token one),
     then with the opt-in routes on (LLAMAGO_ATTN_PREFILL_FLOOR=0 and
     ops.kernels.USE_FUSED_NORM, switched as module attributes): K1, K2, K7
     and K10 must launch, every other kernel stay at 0. In every other
     serving phase K7 and K10 stay at 0;
  5. run the kernel lab (`python -m llamago_tpu_torch.kernel_lab`, all 32
     variants of the small-m int4/int8 matmul) at its full shape, K = 8192,
     N = 7168, m = 8, 24 layers of distinct weights: each of its nine
     kernels (rows L2, L3, L6 to L12 of its table) against its plain version
     for every variant name of its row (activation quantization and the
     byte-sum probes bit for bit; the float rows' bf16 and the integer rows'
     int8 tensor-core decode forms, and L11's probe modes of the former,
     counted and repeated into NaN-filled memory, bit for bit); the lab's
     own check of every name
     against x @ dequantize(w) (19 pass, 12 are not checked, `decode_bitcast`
     is dropped, as in the JAX lab); every name timed on the device side of
     a trace beside its bound, no reading above 100% of it; the plain
     versions' times and `x @ W` on a bf16 copy as the library yardstick.
     The launch counts of the nine kernels and of K1 (both formats) and K9,
     which carry the lab's other rows, must rise in the lab's run;
  4e. the --dtype float32 route at full width: 7B (8 of its 32 layers
     since phase 8 joined, for the time limit) with random Q8_0 and then
     w4x8 weights (seed 0) and f32 compute, the f32 cache, 4 slots, 4
     jobs of which one brings a 600-token prompt: 0 failed jobs,
     in-vocabulary tokens, the repeated greedy job; every K1 call over 8
     rows and every K6 call takes its tile on x's three bf16 parts, every
     K1 call of at most 8 rows its decode form on them, each counted as
     its form; one forward over a 64-token prompt through the kernels
     against the same forward with the plain matmuls swapped in on the
     card, within 1e-3 of max|logit|; a 64- and a 256-token prefill chunk
     profiled (host ms, device busy, `matmul_ms`) and a decode step; every
     K2 call in its 3xTF32 form; then Q8_0 again
     with the opt-in routes on: every K7 call (the 600-token prompt's
     chunks among them) in its 3xTF32 form, the 64-token forward against
     the plain matmuls and plain attention within 1e-3 of max|logit|, the
     256-token chunk's `attention_ms` profiled;
  4f. speculative decoding (--spec --draft 7) over phase 4's weights,
     decode chunks of 32, greedy jobs of 64 tokens whose prompts repeat
     their bytes: 8 jobs on 4 slots with the bf16 cache (K1's tile takes
     the 32-row verify windows, K2 the t = 8 windows) and 8 with the int8
     cache (K4 the t = 8 windows, K3 the restore forwards' rows), then one
     job on 1 slot (K1's decode form takes the 8-row windows) with --spec
     and without it: 0 failed jobs, 64 in-vocabulary tokens a job, verify
     steps and accepted drafts counted (some verify step must run), the
     launch counts of the path's kernels rise and every other one stays 0;
     then one verify window of 4 slots against the same 8 tokens decoded
     one at a time on a copy of the same cache, in bf16 within 5e-2 of
     max|logit| and within 5e-2 of the same window through the plain
     versions, argmaxes equal wherever the steps' top-two gap is above the
     plain pair's own difference; in f32 within 1e-3, argmaxes equal
     wherever the gap is above that;
  4g. the perplexity subcommand's path over phase 4's weights: 2 windows
     of 512 token ids (numpy, seed 0) in bf16 and in f32 compute, on the
     default routes and with K7 and K10 on: each mean NLL within 1e-2
     (bf16) or 1e-4 (f32) of the same run's with the plain matmuls,
     attention and norm, relative, and the first window's logits position
     by position within 6e-2 (bf16) or 1e-2 (f32) of max|logit| of the
     plain window's, or within twice the plain versions' own difference
     there over two chunks of 256 (at most 5 such positions); K1's tile (f32_tc in f32) takes every
     512-row matmul, K7 launches with the opt-in routes and only then;
  6. (`gguf`) the checkpoint tools and LLaMA-3-8B from a GGUF file: a
     dim-512 GQA model written as an f32 ggjt by write_ggjt, quantized by
     the port's `quantize` to q8_0, q4_0, q4_1 and a q8_0 GGUF, and a Meta
     directory made here (dim 4096, 8 kv heads, 2 layers; torch.save,
     write_sp_model) converted by `convert` and quantized, each read back
     and held card (kernels) against CPU (plain versions) in f32: logits
     within 1e-3 of max|logit| and equal greedy tokens; the ggjt and GGUF
     copies of one model give bit-identical logits on the card. Then
     MODEL_PRESETS["llama3-8B"] at full width (8 kv heads, FFN 14,336,
     vocab 128,256, rope theta 500,000; 8 of its 32 layers since phase 8
     joined, for the time limit) as a random Q8_0 GGUF of about 2.8 GB
     written by write_gguf into a temporary directory,
     its byte-level BPE vocab built here (the 256 byte tokens, merges
     learned from README.md and SURVEY.md, reserved specials,
     <|begin_of_text|> = 128000, <|end_of_text|> = 128001, llama-bpe), read
     by read_checkpoint, loaded to the card and served over the REST job
     API as phases 4 and 4b serve 7B (bf16 cache, 4 slots, 8 jobs; int8
     cache, 8 slots, 16 jobs; 49-token prompts, 64 tokens a job): K1, K2
     (and K3, K4) launch and nothing else; then the file with f32 compute,
     a 64-token forward through the kernels against the plain matmuls
     within 1e-3 of max|logit|; the file's bytes, its write, read and load
     times, the decode step beside phase 4's, tok/s, TTFT and peak memory
     logged; the file deleted;
  7. (`train`, run before phase 3) training, LoRA and the quality gate:
     K1's tile at the 7B
     training step's 2,048 rows (bf16 x, and f32 x on its three bf16 parts)
     against its plain version, timed over one forward's matmuls; 7a: one
     lora_train_step (rank 8, B random) of a small GQA model (dim 256, head
     dim 64) for each base (dense, Q8_0, Q4_0, w4x8), f32 and bf16 compute,
     a window of 8 rows at t = 8 (K1's and K5's decode forms, K2) and one of
     128 rows at t = 64 with K7 on (K1's and K6's tiles, K7), and one
     full-weight train_step of the dense model: loss and every gradient
     through the kernels (forward; the backward is plain PyTorch, as JAX's
     custom VJPs) against the plain matmuls and attention on the card and,
     in f32, the CPU, within 1e-4 of max|grad| in f32 and within twice the
     plain pair's bf16-against-f32 difference in bf16; layer 0's wqkv
     gradient non-zero; the window's forms launch, the plain step launches
     nothing; 7b: the 7B QLoRA step of scripts/train_bench.py (random Q8_0
     base from seed 0, bf16, batch 4 x 512, rank 8, remat): a warm step and
     five timed (ms, train tokens/s, peak memory, each loss finite and
     falling on the repeated batch), one profiled (device busy, K1's time,
     the backward's dequantize + matmul), one in f32 (K1's f32_tc), and the
     first 4 layers against the plain matmuls; 7c: `finetune --file
     README.md --steps 20 --seq 64` on a small Q8_0 file on the card, then
     `--lora` in f32: greedy tokens on the card equal to the CPU's, a
     window's logits within 1e-3 of max|logit|; 7d: the
     quality gate at its defaults (400 steps, d256, L6, ctx 256) with its
     bf16 rows on the kernels: every ppl finite, the exported f32 file's
     ppl on the card within 1e-4 relative of the CPU's, K5 taking every
     w4x8 matmul of the w4x8_a8 row and K1 bits=4 launching in the bf16
     q4_0 row (the 0.1-ppl thresholds reported, not enforced), then the
     dense and Q8_0 files in bf16 with K10 on and the int8 cache with bf16
     scale planes;
  8. (`parallel`, run after phase 7, before phase 3) the parallel path,
     as two rank processes sharing the one
     card over gloo (NCCL refuses two ranks on one GPU; these are numbers
     of a bring-up, not of two cards): 8.1 the CLI's `--server --pods 2
     --tp 2` as two processes (`--coordinator 127.0.0.1:P --nprocs 2
     --procid 0|1`) on a small Q8_0 file in f32 at temp 0: the outputs of 3
     jobs posted to rank 0 equal a one-process server's, /v1/embeddings
     (through embed_routed) within 1e-4 of max|e|, each rank's K1 and K2
     launch counts (logged by the rank when SIGTERM stops both through
     rank 0's broadcast) above 0; 8.2 LLaMA-7B Q8_0 at full width, 16 of
     its 32 layers since phase 8b joined (seed 0, drawn as world size 1 draws it and cut per rank), tp = 2 over
     the bf16 and the int8 cache, dp = 2 and sp = 2 on 4 slots, each in bf16
     and f32: the last position's logits of a 16-token prefill against
     world size 1 on the card within 5e-2 (bf16) and 1e-4 (f32) of
     max|logit|, 4 greedy jobs of 8 tokens equal on both ranks and, in f32,
     equal to world size 1's, and each rank's K1, K2, K3 and K4 launches
     above 0 where the setup reaches them; 8.3 LLaMA-2-70B (dim 8192, 64 /
     8 heads, FFN 28672, vocab 32000, 80 layers) with random w4x8 weights at
     tp = 2, each rank drawing and cutting its blocks layer by layer (its
     memory logged): 4 sampled jobs served over REST on rank 0 through
     serve_lockstep, both ranks running the same jobs to the same tokens,
     K5, K6 and K2 (g = 8) launched on both ranks; then K5 (m = 1, 4, 16),
     K6 (m = 17, 64) and K2 (4 slots, 4 kv heads, g = 8, hd = 128, S = 512)
     at a rank's shard shapes against their plain versions, timed beside
     x @ W / SDPA and their bounds; 8.4 one decode step of the 70B ranks
     profiled (host ms, device busy, kernels and host op calls a step, the
     collectives' count, host time and host copies);
 8b. sharded training (`par_train`), two rank processes sharing the card
     over gloo as in phase 8: K1's tile (bf16 and f32 x) and K7 (bf16 and
     f32) at a 7B tp = 2 rank's training shapes against their plain
     versions, timed beside x @ W / SDPA and their bounds; 8b.1 the 7B
     QLoRA step at full width (4 of its 32 layers, random Q8_0 base of
     seed 0 with O(1) activations, 2 x 256 tokens, rank 8 on wq / wk / wv /
     wo with B from a seed, remat, K7 on) at tp = 2, dp = 2 and sp = 2
     against world size 1: f32 loss within 1e-5 and every adapter's
     gradient within 1e-4 of max|g|, bf16 within twice the plain pair's own
     difference; K1 launched on each rank, K7 under tp and dp; ms a step,
     collectives a step (host ms, host copies), peak GiB a rank and device
     busy share; 8b.2 phase 7a's small model, one full-weight f32 step at
     tp = 2 and dp = 2 against world size 1; 8b.3 `finetune --tp 2`, then
     `--lora` of its adapters at --tp 2 against one card (the same text)
     and `perplexity` at --tp 2 and --sp 2 against one process (the NLL
     within 1e-4), as --coordinator processes; 8b.4 `python -m
     llamago_tpu_torch.dryrun --n 2` exits 0;

then print the serving line (tokens/s, TTFT, peak memory, the prefill
chunks' device time and matmul share and the decode step's device time,
matmul and attention kernels of phases 4, 4d, 4b, 4c, 4e and 6 side by
side, with phase 4f's tokens/s, TTFT and accepted drafts a verify step,
JSON), the perplexity line (phase 4g, JSON), the GGUF line (phase 6: the
file, its times, the small models' card-vs-CPU errors; JSON), the training
line (phase 7: the 7B step's numbers, the small steps' errors, the gate's
rows; JSON), the parallel line (phase 8; JSON), the parallel training line
(phase 8b; JSON), the card line, the kernels line
(JSON) and, last, the device line (JSON). `--out` names a file for the
detail (per-shape kernel times, the serving numbers, the decode-step
profile) as JSON. `--only` runs the
named phases alone (after the build) for work on one of them, and prints no
result lines: k1, k2, k3, k4k8, k1q4, k5, k6, k9, k7, k10, lab, small,
small_int4, serve, serve_prefill, serve_int8, serve_int4, serve_f32,
serve_spec, ppl, llama3 (phase 2 at LLaMA-3-8B's shapes), gguf (phase 6),
train (phase 7), parallel (phase 8), par_train (phase 8b).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import urllib.request
import uuid

from llamago_tpu_torch.utils.timing import (
    BF16_OPS_PER_S,
    F32_OPS_PER_S,
    INT8_OPS_PER_S,
    bound_ms,
    device_busy_us,
    device_us_by_name,
    timed,
)

# the 7B projections of one decode step: (name, K, N, launches per step)
K1_SHAPES = (("wqkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
             ("w13", 4096, 22016, 32), ("w2", 11008, 4096, 32),
             ("lm_head", 4096, 32768, 1))
# the same with int4 weights: the head is not padded
INT4_SHAPES = K1_SHAPES[:4] + (("lm_head", 4096, 32000, 1),)
# LLaMA-3-8B's projections of one decode step (GQA: 32 query heads, 8 kv
# heads of 128), the head padded from 128,256 to 131,072 columns
LLAMA3_SHAPES = (("wqkv", 4096, 6144, 32), ("wo", 4096, 4096, 32),
                 ("w13", 4096, 28672, 32), ("w2", 14336, 4096, 32),
                 ("lm_head", 4096, 131072, 1))
# LLaMA-3-8B's attention in phase 6: 4 query rows folded per kv head, hd 128
L3_K2_SHAPE = dict(b=4, kv=8, g=4, hd=128, s=1024)  # the bf16 cache, 4 slots
L3_K4_SHAPE = dict(b=8, kv=8, g=4, hd=128, s=1024)  # the int8 cache, 8 slots
# x max|ref|, for every quantized matmul (K1, K5, K6, K9): the kernel's f32
# sums run in another order than the plain version's (split K, warps, FMA);
# a bf16 output adds one rounding
K1_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
K2_TOL = 1e-2  # absolute, bf16 outputs of size ~1
K2_SHAPE = dict(b=4, kv=32, g=1, hd=128, s=1024)
K2_COPIES = 3  # 3 x 67 MB of K and V at K2_SHAPE
K3_SHAPE = dict(b=8, kv=32, hd=128, s=1024)  # the int8 serving phase's decode step
# absolute, bf16 outputs of size ~1: one bf16 rounding of the output, and the
# kernel's per-S-block statistics (exp, f32 sums in another order) against the
# plain version's running ones
K4_TOL = 1e-2
K4_SHAPE = dict(b=8, kv=32, g=1, hd=128, s=1024)
K4_COPIES = 3  # 3 x 68 MB of int8 K and V and their scales at K4_SHAPE
# K7 at the 7B prefill shapes: (t, pos0) of the buckets and chunks phase 4d
# runs, and the 512-token window phase 4g's perplexity runs. As K2's, but |d| / max(1, |ref|): one bf16 rounding of the output,
# and the kernel rounds p to bf16 against a running maximum where the plain
# version rounds the normalized p against the final one; a row near
# position 0 sees a few slots only and returns values of V's own size (up to
# 4 here, where one bf16 step is 0.016), so the error scales with the output
K7_TOL = K2_TOL
K7_SHAPE = dict(b=1, kv=32, g=1, hd=128, s=1024)
K7_WINDOWS = ((64, 0), (256, 0), (256, 512), (128, 640), (512, 0))
K7_COPIES = 4  # 4 x 17 MB of K and V at K7_SHAPE
# K10, f32: the order of the f32 sum of squares, and 1 / sqrt against rsqrt
K10_RTOL_F32 = 1e-5
K10_D = 4096
# the tensor-core forms of the lab's float and integer rows, of K5 and of
# K7, with K7's merge, K1's, K6's and K9's tiles (bf16 x, and f32 x as three
# bf16 parts), and K1's and K9's decode forms (bf16 x, and f32 x as three
# bf16 parts): none may spill
TC_FORMS = {"lab_decode_tc": "lab_matmul", "lab_decode_i8tc": "lab_matmul",
            "w4x8_a8_tc": "w4x8_matmul", "attn_prefill_tc": "attn_prefill",
            "attn_prefill_merge": "attn_prefill", "dq_tc": "dequant_matmul",
            "w4x8_tc": "w4x8_matmul", "attn_prefill_f32tc": "attn_prefill",
            "attn_decode_f32tc": "attn_decode", "dq_decode_tc": "dequant_matmul",
            "dq_decode_f32tc": "dequant_matmul", "so_decode_tc": "dequant_matmul_so",
            "so_decode_f32tc": "dequant_matmul_so", "so_tc": "dequant_matmul_so"}
# the rate that bounds the tile with f32 x (K1's and K6's "f32_tc"): three
# bf16 passes, one a part of x
F32_TC_OPS_PER_S = BF16_OPS_PER_S / 3
# the rate that bounds K2's and K7's f32 tensor-core forms: three TF32
# products a product (495 TFLOP/s dense TF32, H100 SXM data sheet)
TF32X3_OPS_PER_S = 495e12 / 3
# K2's and K7's f32 forms against their plain versions: f32 outputs, 3xTF32
# products (under 2^-20 of a product off) and f32 sums in another order
F32_ATTN_TOL = 1e-4
# K2's f32 windows (t, fill) at K2_SHAPE: the decode step, the speculative
# verify window (draft 7 + 1 rows) and the prefill buckets of 16 and 32 rows
K2_F32_WINDOWS = ((1, 101), (1, 1024), (8, 101), (8, 1024), (16, 101), (16, 1024),
                  (32, 101), (32, 1024))


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def _kernel_name(symbol: str) -> str:
    """A kernel's name and the start of its template arguments from its
    mangled symbol in a source's anonymous namespace (else the symbol)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", symbol)
    if m is None:
        return symbol[:60]
    n = int(m.group(1))
    return symbol[m.end():m.end() + n] + " " + symbol[m.end() + n:m.end() + n + 16]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2

def _random_leaf(gen, dev, fmt: str, k: int, n: int, scale_dtype: str = "bfloat16") -> dict:
    """A random quantized leaf with scales in (0, 0.02), bf16 unless
    `scale_dtype` names f32 (Q8_0 and Q4_0 only): "q8" (Q8_0), "q4" (Q4_0)
    or "q4x" (w4x8, its group scales stored as duplicated rows)."""
    import torch

    def scales(rows):
        return (torch.rand((rows, n), generator=gen, device=dev) * 0.02).to(
            getattr(torch, scale_dtype))

    if fmt == "q8":
        return {"q8": torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8,
                                    device=dev), "s": scales(k // 32)}
    packed = torch.randint(0, 256, (k // 2, n), generator=gen, dtype=torch.uint8, device=dev)
    if fmt == "q4":
        return {"q4": packed, "s": scales(k // 32)}
    return {"q4x": packed, "s": torch.repeat_interleave(scales(k // 128), 2, dim=0)}


def _leaf_bytes(w: dict) -> int:
    """Bytes the kernels read of a leaf: of a w4x8 leaf's duplicated scale
    rows only every other one."""
    s = w["s"].numel() * w["s"].element_size()
    if "q4x" in w:
        return w["q4x"].numel() + s // 2
    return (w["q8"] if "q8" in w else w["q4"]).numel() + s


def check_matmul(dev, detail: dict, tag: str, fmt: str, kernel, plain, timed_m: tuple,
                 other_m: tuple, ops_per_s, seed: int, other_shapes: tuple = ("wqkv",),
                 timed_dtype: str = "bfloat16", checked=None,
                 scale_dtype: str = "bfloat16", shapes: tuple | None = None,
                 copies: int | None = None) -> tuple[dict, dict]:
    """One quantized matmul kernel at the five 7B projection shapes (the
    head at its width in that format): kernel against plain version for f32
    and bf16 x (and, at the wqkv shape, f32 scales as a file brings them,
    with both x dtypes, where the kernel takes them) at the row counts
    `timed_m`, which are also timed with x in `timed_dtype` (the library
    call on a copy of the weights in that dtype), and at the shapes
    `other_shapes` names at `other_m`. `ops_per_s(m)` is the peak rate of
    the kernel's operations at m rows. Returns the largest error by (m, x
    dtype) and, for each timed m, the kernels line's numbers over one pass
    of the five shapes (one decode step at decode rows, one prefill pass at
    prefill rows). `checked`, where given, takes the kernel's place in the
    checks (not in the timing). The leaves' scales are `scale_dtype` (bf16,
    or f32 for Q8_0 and Q4_0). `shapes` replaces the 7B shapes, as (name,
    K, N, launches per pass). `copies` replaces the copies of each leaf
    that stream past the L2 (compute-bound row counts need none)."""
    import torch

    from llamago_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(seed)
    steps = {m: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
             for m in timed_m}
    errs: dict = {}
    rows = []
    for name, k, n, per_step in shapes or (K1_SHAPES if fmt == "q8" else INT4_SHAPES):
        ws = [_random_leaf(gen, dev, fmt, k, n, scale_dtype)]
        # copies enough that a cycle of calls streams past the 50 MB L2,
        # as the decode step's weight stream does
        n_copies = copies or max(1, -(-200_000_000 // _leaf_bytes(ws[0])))
        ws += [_random_leaf(gen, dev, fmt, k, n, scale_dtype) for _ in range(n_copies - 1)]
        cases = [("float32", ws[0]), ("bfloat16", ws[0])]
        if name == "wqkv" and fmt != "q4x":
            f32_scales = {**ws[0], "s": ws[0]["s"].float()}
            cases += [("float32", f32_scales), ("bfloat16", f32_scales)]

        def check(m):
            for xdt, w in cases:
                x = torch.randn((m, k), generator=gen, device=dev).to(getattr(torch, xdt))
                got = (checked or kernel)(x, w).float()
                ref = plain(x, w).float()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item() / ref.abs().max().item()
                if not err <= K1_TOL[xdt]:
                    raise AssertionError(f"{tag} {name} m={m} x={xdt}: max|d|/max|ref| "
                                         f"{err:.3g} > {K1_TOL[xdt]}")
                errs[(m, xdt)] = max(errs.get((m, xdt), 0.0), err)

        if name in other_shapes:
            for m in other_m:
                check(m)
        for m in timed_m:
            check(m)
            x = torch.randn((m, k), generator=gen, device=dev).to(getattr(torch, timed_dtype))
            deqs = [quant.dequantize(w, x.dtype) for w in ws]
            kern = timed([lambda w=w: kernel(x, w) for w in ws], 20 * n_copies)
            plain_ms = timed([lambda w=w: plain(x, w) for w in ws], max(3, n_copies))
            lib = timed([lambda d=d: x @ d for d in deqs], 20 * n_copies)
            del deqs
            bnd, by = bound_ms(_leaf_bytes(ws[0]) + (m * k + m * n) * x.element_size(),
                               2.0 * m * k * n, ops_per_s(m))
            rows.append(dict(name=name, m=m, k=k, n=n, ms=kern, plain_ms=plain_ms,
                             library_ms=lib, bound_ms=bnd, bound_by=by))
            log(f"{tag} {name:8s} m={m:3d} K={k} N={n}: kernel {kern:.4f} ms, plain "
                f"{plain_ms:.4f} ms, x@W {timed_dtype} {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
            for key, v in (("ms", kern), ("plain_ms", plain_ms), ("library_ms", lib),
                           ("bound_ms", bnd)):
                steps[m][key] += per_step * v
            steps[m]["bound_by"] = by
        del ws
        torch.cuda.empty_cache()
    for m, step in steps.items():
        log(f"{tag} one pass at m={m}: kernel {step['ms']:.3f} ms, plain "
            f"{step['plain_ms']:.3f} ms, x@W {timed_dtype} {step['library_ms']:.3f} ms, bound "
            f"{step['bound_ms']:.3f} ms ({step['bound_by']})")
    detail[tag.lower().replace(" ", "_")] = rows
    return errs, steps


def _line(errs: dict, steps: dict, m: int, keep=lambda m, xdt: True) -> dict:
    """A kernels-line entry: the largest error over the (m, x dtype) cases
    `keep` names, and the pass at m rows."""
    return {"max_abs_err": max(e for key, e in errs.items() if keep(*key)), **steps[m]}


def _nan_first(x, n: int, ws_elems: int) -> None:
    """Fill with NaN the memory that a call's f32 workspace (ws_elems) and
    its output [m, n] in x's dtype will take (the caching allocator hands
    the blocks just freed to the next requests of their sizes), so that a
    partial or an output the kernels leave unwritten shows."""
    import torch

    poison = [torch.full((max(1, ws_elems),), float("nan"), device=x.device),
              torch.full((x.shape[0], n), float("nan"), dtype=x.dtype, device=x.device)]
    del poison


def _counted(fn, counts, form_of):
    """fn(x, w), which must add one to exactly the launch count of
    `counts()` (a dict by form) that `form_of(m, x dtype)` names, if any."""
    def call(x, w):
        before = counts()
        out = fn(x, w)
        after = counts()
        form = form_of(x.shape[0], x.dtype)
        if {f: after[f] - before[f] for f in after} != {f: int(f == form) for f in after}:
            raise AssertionError(f"m={x.shape[0]} x={x.dtype}: form {form}, but the counts "
                                 f"went from {before} to {after}")
        return out
    return call


def _f32_fma_pass_ms(m: int, fmt: str) -> float:
    """One pass of the five shapes (a 7B prefill pass) at m rows on f32 FMA
    at 67 TFLOP/s: context for the tile with f32 x, which runs on bf16
    tensor cores."""
    shapes = K1_SHAPES if fmt == "q8" else INT4_SHAPES
    return sum(per * 2.0 * m * k * n for _, k, n, per in shapes) / F32_OPS_PER_S * 1e3


def _k1_checked():
    """K1 as the checks call it: each call must take the form `k1_form`
    names (counted by form), and the checked one writes into NaN-filled
    memory."""
    from llamago_tpu_torch.ops import kernels

    fn = kernels.dequant_matmul
    k1 = _counted(fn, lambda: {"tensor_core": fn.launches_tc, "f32_tc": fn.launches_f32_tc,
                               "decode_tc": fn.launches_decode_tc,
                               "f32_decode_tc": fn.launches_f32_decode_tc}, kernels.k1_form)

    def k1_nan(x, w):
        n = w["s"].shape[1]
        _nan_first(x, n, kernels.k1_plan(x.shape[0], x.shape[1], n, x.dtype)[2])
        return k1(x, w)

    return k1, k1_nan


def check_k1(dev, detail: dict, fmt: str = "q8") -> tuple[dict, dict, dict, dict]:
    """K1 (Q8_0, or Q4_0 with fmt "q4") in each of its forms, at the five
    7B shapes, against the plain version with f32 and bf16 x: at m = 1 to 8
    (decode: the tensor-core decode form, for f32 x on x's three bf16
    parts, "f32_decode_tc"), and 9, 16, 17, 32, 64, 100, 256 and 512 (every
    row tiling of the tensor-core tile, ragged ones, and a perplexity
    window: bf16 x, and f32 x as its three bf16 parts, "f32_tc"). Timed
    with bf16 x at m=4 and 8 (the decode form at 4 and 8 slots), 64 (the
    prefill bucket of the smoke's prompts), 256 (the long prompts'
    chunks) and 512 (a perplexity window), all against the bf16 rate; and
    with f32 x at m=4 and 8 (the decode form on three parts) and 64, 256
    and 512 (the tile on three parts), against three bf16 passes
    (F32_TC_OPS_PER_S: the bytes bound every decode row count; f32 FMA's
    bound logged beside the tile's). Every call must take the form
    `k1_form` names (`launches_tc` counts the tensor-core tile,
    `launches_f32_tc` it with f32 x, `launches_decode_tc` the decode form,
    `launches_f32_decode_tc` it with f32 x); every checked call writes into
    NaN-filled memory. Returns the kernels line's numbers of the decode
    form with f32 x (one decode step at m=4), of the tensor-core tile (one
    prefill pass at m=64), of the decode form (one decode step at m=4) and
    of the tile with f32 x (one prefill pass at m=64)."""
    from llamago_tpu_torch.ops import kernels

    k1, k1_nan = _k1_checked()
    tag = "K1" if fmt == "q8" else "K1 q4"
    shapes = tuple(name for name, *_ in K1_SHAPES)
    errs, steps = check_matmul(
        dev, detail, tag, fmt, k1, kernels.dequant_matmul_plain, timed_m=(4, 8, 64, 256, 512),
        other_m=(1, 2, 3, 5, 6, 7, 9, 16, 17, 32, 100), ops_per_s=lambda m: BF16_OPS_PER_S,
        seed=1 if fmt == "q8" else 7, other_shapes=shapes, checked=k1_nan)
    errs32, steps32 = check_matmul(
        dev, detail, f"{tag} f32", fmt, k1, kernels.dequant_matmul_plain,
        timed_m=(4, 8, 64, 256, 512), other_m=(), ops_per_s=lambda m: F32_TC_OPS_PER_S,
        seed=2 if fmt == "q8" else 8, timed_dtype="float32", checked=k1_nan)
    f32_decode = lambda m, xdt: m <= 8 and xdt == "float32"  # noqa: E731
    if sorted(m for m, xdt in errs if f32_decode(m, xdt)) != list(range(1, 9)):
        raise AssertionError("K1: the decode form with f32 x was not checked at m = 1 to 8")
    if not any(m > 8 and xdt == "float32" for m, xdt in errs) or \
            not {(512, "float32"), (512, "bfloat16")} <= set(errs):
        raise AssertionError("K1: the tile with f32 x, or a window of 512 rows, was not checked")
    for m in (4, 8):
        log(f"{tag} at m={m}: the decode form {steps[m]['ms']:.3f} ms per step (bf16 x), "
            f"x@W {steps[m]['library_ms']:.3f} ms, bound {steps[m]['bound_ms']:.3f} ms")
    both = {key: max(errs.get(key, 0.0), errs32.get(key, 0.0)) for key in {*errs, *errs32}}
    for m in (4, 8):
        log(f"{tag} at m={m}, f32 x: the f32_decode_tc form {steps32[m]['ms']:.3f} ms per "
            f"step, x@W f32 {steps32[m]['library_ms']:.3f} ms, bound "
            f"{steps32[m]['bound_ms']:.3f} ms ({steps32[m]['bound_by']}); largest error over "
            f"m <= 8 {max(e for key, e in both.items() if f32_decode(*key)):.2e}")
    f32_tc = lambda m, xdt: m > 8 and xdt == "float32"  # noqa: E731
    for m in (64, 256, 512):
        log(f"{tag} at m={m}, f32 x: the f32_tc form {steps32[m]['ms']:.3f} ms per pass, "
            f"x@W f32 {steps32[m]['library_ms']:.3f} ms, bound {steps32[m]['bound_ms']:.3f} ms "
            f"(three bf16 passes or bytes), f32 FMA's {_f32_fma_pass_ms(m, fmt):.3f} ms; "
            f"largest error over m > 8 "
            f"{max(e for key, e in both.items() if f32_tc(*key)):.2e}")
    return (_line(both, steps32, 4, f32_decode),
            _line(errs, steps, 64, lambda m, xdt: m > 8 and xdt == "bfloat16"),
            _line(errs, steps, 4, lambda m, xdt: m <= 8 and xdt == "bfloat16"),
            _line(both, steps32, 64, f32_tc))


def _k5_call(x, w):
    """One checked K5 call: the memory its scratch (sx, the split's
    partials, xq) and its output will take is filled with NaN first, so a
    partial or an output the kernel leaves unwritten shows, and the call
    must be counted as K5's (its int8 tensor-core decode form)."""
    from llamago_tpu_torch.ops import kernels

    m, k = x.shape
    n = w["q4x"].shape[1]
    ws = kernels.w4x8_plan(m, k, n, x.dtype)[2]
    scratch = 4 * kernels.a8_slots(m)[1] * (k // 128) + 4 * ws + m * k
    _nan_first(x, n, -(-scratch // 4))
    before = kernels.w4x8_matmul.launches_a8
    got = kernels.w4x8_matmul(x, w)
    if kernels.w4x8_matmul.launches_a8 != before + 1:
        raise AssertionError(f"K5 m={m}: the call was not counted as K5's")
    return got


def check_k5(dev, detail: dict) -> dict:
    """K5 at m=4 (decode) and m=16 (the warm-up prefill bucket), checked and
    timed, every other row count from 1 to 16 (one and two n8 tiles of
    slots) checked, at the five 7B int4 shapes; first its activation
    quantization alone, bit for bit against
    the plain version. Both compute the same int8 activations and exact
    integer dots, so they differ by the order of the f32 sums only. Every
    checked call writes into NaN-filled memory; every call of at most 16
    rows, f32 or bf16 x, is counted as the int8 tensor-core decode form's.
    Its operations are int8."""
    import torch

    from llamago_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((16, 11008), generator=gen, device=dev) * 3).to(dt)
        x[2, 128:256] = 0  # a zero group: sx = 1
        x[3, :5] = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0], device=dev).to(dt)  # ties
        x[3, 5:128] *= 0.01
        xq, sx = kernels.w4x8_quantize_x(x)
        pq, ps = kernels.quantize_activations_a8(x)
        torch.cuda.synchronize()
        if not (torch.equal(xq, pq) and torch.equal(sx, ps)):
            raise AssertionError(f"K5 {dt}: xq / sx differ from the plain version: "
                                 f"{(xq != pq).sum().item()} xq, {(sx != ps).sum().item()} sx")
        if xq[3, :5].tolist() != [0, 2, 2, 0, 127] or sx[2, 1].item() != 1.0:
            raise AssertionError(f"K5 {dt}: ties or the zero group went wrong: "
                                 f"{xq[3, :5].tolist()}, {sx[2, 1].item()}")
        log(f"K5 {str(dt).split('.')[-1]}: xq and sx bit-exact against the plain version")
    calls = [0]

    def counted(fn):
        def call(x, w):
            calls[0] += 1
            return fn(x, w)
        return call

    before = (kernels.w4x8_matmul.launches_a8, kernels.w4x8_matmul.launches_stream)
    errs, steps = check_matmul(dev, detail, "K5", "q4x", counted(kernels.w4x8_matmul),
                               kernels.w4x8_matmul_a8_plain, timed_m=(4, 16),
                               other_m=(1, 2, 3, *range(5, 16)),
                               ops_per_s=lambda m: INT8_OPS_PER_S, seed=9,
                               other_shapes=tuple(name for name, *_ in INT4_SHAPES),
                               checked=counted(_k5_call))
    a8 = kernels.w4x8_matmul.launches_a8 - before[0]
    if kernels.w4x8_matmul.launches_stream != before[1] or a8 != calls[0]:
        raise AssertionError(f"K5: {a8} launches of its form for {calls[0]} calls of at "
                             "most 16 rows, or one took the stream kernel")
    log(f"K5: every one of {a8} calls took the int8 tensor-core decode form")
    # LLAMAGO_W4X8_A8_MAX_M raised above 16: blocks of 16 rows along grid z
    default_max_m, kernels._W4X8_A8_MAX_M = kernels._W4X8_A8_MAX_M, 48
    try:
        w = _random_leaf(gen, dev, "q4x", 4096, 12288)
        for m in (20, 33):
            x = torch.randn((m, 4096), generator=gen, device=dev)
            got, ref = _k5_call(x, w), kernels.w4x8_matmul_a8_plain(x, w)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item() / ref.abs().max().item()
            if not err <= K1_TOL["float32"]:
                raise AssertionError(f"K5 wqkv m={m} (switch at 48): max|d|/max|ref| "
                                     f"{err:.3g} > {K1_TOL['float32']}")
            log(f"K5 wqkv m={m} with the switch at 48: max|d|/max|ref| {err:.2e}")
    finally:
        kernels._W4X8_A8_MAX_M = default_max_m
    return _line(errs, steps, 4)


def check_k6(dev, detail: dict) -> tuple[dict, dict]:
    """K6's tensor-core tile at the five 7B int4 shapes, for bf16 x and for
    f32 x as its three bf16 parts ("f32_tc"), checked at m=17, 32, 64, 100
    and 256 (every row tiling of the tile, and ragged ones) into NaN-filled
    memory; timed at m=64 (the prefill bucket of the smoke's prompts) and
    m=256 (a long prompt's chunk), bf16 x against bf16 operations and f32 x
    against three bf16 passes (F32_TC_OPS_PER_S; f32 FMA's bound logged
    beside it). Every call must take the form `w4x8_form` names
    (`launches_tc` counts the tile with bf16 x, `launches_f32_tc` with f32
    x). Returns the kernels line's numbers of the tile with f32 x and with
    bf16 x, each over one prefill pass at m=64 (a prefill chunk's 129
    launches)."""
    from llamago_tpu_torch.ops import kernels

    fn = kernels.w4x8_matmul
    k6 = _counted(fn, lambda: {"tensor_core": fn.launches_tc, "f32_tc": fn.launches_f32_tc},
                  kernels.w4x8_form)

    def k6_nan(x, w):
        n = w["q4x"].shape[1]
        _nan_first(x, n, kernels.w4x8_plan(x.shape[0], x.shape[1], n, x.dtype)[2])
        return k6(x, w)

    before = kernels.w4x8_matmul.launches_a8
    errs, steps = check_matmul(dev, detail, "K6", "q4x", k6, kernels.w4x8_matmul_stream_plain,
                               timed_m=(64, 256), other_m=(17, 32, 100),
                               ops_per_s=lambda m: BF16_OPS_PER_S, seed=10,
                               other_shapes=tuple(name for name, *_ in INT4_SHAPES),
                               checked=k6_nan)
    errs32, steps32 = check_matmul(dev, detail, "K6 f32", "q4x", k6,
                                   kernels.w4x8_matmul_stream_plain, timed_m=(64, 256),
                                   other_m=(), ops_per_s=lambda m: F32_TC_OPS_PER_S, seed=19,
                                   timed_dtype="float32", checked=k6_nan)
    if kernels.w4x8_matmul.launches_a8 != before:
        raise AssertionError("K6: a call of more than 16 rows took the W4A8 kernel")
    f32 = lambda m, xdt: xdt == "float32"  # noqa: E731
    both = {key: max(errs.get(key, 0.0), errs32.get(key, 0.0)) for key in {*errs, *errs32}}
    for m in (64, 256):
        log(f"K6 at m={m}: the tile {steps[m]['ms']:.3f} ms per pass (bf16 x), the f32_tc "
            f"form {steps32[m]['ms']:.3f} ms (f32 x; x@W f32 {steps32[m]['library_ms']:.3f} "
            f"ms, bound {steps32[m]['bound_ms']:.3f} ms, f32 FMA's "
            f"{_f32_fma_pass_ms(m, 'q4x'):.3f} ms); largest error, f32 x "
            f"{max(e for key, e in both.items() if f32(*key)):.2e}")
    return (_line(both, steps32, 64, f32),
            _line(errs, steps, 64, lambda m, xdt: not f32(m, xdt)))


def check_k9(dev, detail: dict) -> tuple[dict, dict, dict, dict]:
    """K9 in each of its four forms, for Q8_0 and Q4_0 leaves at the five
    7B shapes. bf16 x: m = 4 (the tensor-core decode form), 16 and 64 (the
    tensor-core tile `so_tc`: one and four row tiles of 16) checked and
    timed, and 1, 2, 3, 5, 6, 7, 8 (the decode form), 9, 17, 32 and 256 (the
    tile at every row tiling, ragged ones; reached when the switch is set
    above 8) at the wqkv shape, f32 x at each of those m too (up to 8 rows
    the decode form on x's three bf16 parts, above the tile on them); f32 x
    timed at m = 16 and 64 (the tile on x's three planes, against three
    bf16 passes) for both formats, and at m = 4 and 8 for Q4_0 (the decode
    form, against the bytes). Every call must take the form `k9_form` names
    (`launches_decode_tc`, `launches_f32_decode_tc`, `launches_tc`,
    `launches_f32_tc`) and every checked call writes into NaN-filled memory.
    Returns the kernels line's numbers of the decode form (Q8_0, the format
    of its run in phase 4b) and of it with f32 x (Q4_0, its run in phase 3),
    each one decode step at m = 4, and of the tile (Q8_0, bf16 x: phase
    4b's prefill) and of it with f32 x (Q4_0: phase 3's run with the switch
    at 256), each one prefill pass at m = 64."""
    from llamago_tpu_torch.ops import kernels

    fn = kernels.dequant_matmul_so
    counted = _counted(fn, lambda: {"decode_tc": fn.launches_decode_tc,
                                    "f32_decode_tc": fn.launches_f32_decode_tc,
                                    "tensor_core": fn.launches_tc,
                                    "f32_tc": fn.launches_f32_tc}, kernels.k9_form)

    def k9_nan(x, w):
        n = w["s"].shape[1]
        _nan_first(x, n, kernels.k9_plan(x.shape[0], x.shape[1], n, x.dtype)[2])
        return counted(x, w)

    f32_decode = lambda m, xdt: m <= 8 and xdt == "float32"  # noqa: E731
    bf16_decode = lambda m, xdt: m <= 8 and xdt == "bfloat16"  # noqa: E731
    f32_tile = lambda m, xdt: m > 8 and xdt == "float32"  # noqa: E731
    bf16_tile = lambda m, xdt: m > 8 and xdt == "bfloat16"  # noqa: E731
    out, errs_all = {}, []
    for fmt in ("q8", "q4"):
        errs, steps = check_matmul(dev, detail, f"K9 {fmt}", fmt, counted,
                                   kernels.dequant_matmul_so_plain, timed_m=(4, 16, 64),
                                   other_m=(1, 2, 3, 5, 6, 7, 8, 9, 17, 32, 256),
                                   ops_per_s=lambda m: BF16_OPS_PER_S,
                                   seed=11 if fmt == "q8" else 12, checked=k9_nan)
        timed32 = (4, 8, 16, 64) if fmt == "q4" else (16, 64)
        errs32, steps32 = check_matmul(dev, detail, f"K9 {fmt} f32", fmt, counted,
                                       kernels.dequant_matmul_so_plain, timed_m=timed32,
                                       other_m=(), ops_per_s=lambda m: F32_TC_OPS_PER_S,
                                       seed=14 if fmt == "q4" else 15, timed_dtype="float32",
                                       checked=k9_nan)
        both = {key: max(errs.get(key, 0.0), errs32.get(key, 0.0)) for key in {*errs, *errs32}}
        errs_all.append(both)
        if sorted(m for m, xdt in errs if f32_decode(m, xdt)) != list(range(1, 9)) or \
                sorted(m for m, xdt in both if f32_tile(m, xdt)) != [9, 16, 17, 32, 64, 256]:
            raise AssertionError(f"K9 {fmt}: the decode form with f32 x was not checked at "
                                 "m = 1 to 8, or the tile at m = 9, 16, 17, 32, 64 and 256")
        log(f"K9 {fmt} at m=4: the decode form {steps[4]['ms']:.3f} ms per step (bf16 x), "
            f"x@W {steps[4]['library_ms']:.3f} ms, bound {steps[4]['bound_ms']:.3f} ms")
        for m in (16, 64):
            log(f"K9 {fmt} at m={m}: the tile {steps[m]['ms']:.3f} ms per pass (bf16 x; x@W "
                f"{steps[m]['library_ms']:.3f} ms, bound {steps[m]['bound_ms']:.3f} ms), "
                f"{steps32[m]['ms']:.3f} ms (f32 x; x@W f32 {steps32[m]['library_ms']:.3f} ms, "
                f"bound {steps32[m]['bound_ms']:.3f} ms)")
        log(f"K9 {fmt}: largest error, the tile: bf16 x "
            f"{max(e for key, e in both.items() if bf16_tile(*key)):.2e}, f32 x "
            f"{max(e for key, e in both.items() if f32_tile(*key)):.2e}")
        out[fmt] = _line(errs, steps, 4, bf16_decode)
        if fmt == "q8":
            out["tile"] = _line(errs, steps, 64, bf16_tile)
        else:
            out["f32_decode"] = _line(both, steps32, 4, f32_decode)
            out["f32_tile"] = _line(both, steps32, 64, f32_tile)
            for m in (4, 8):
                log(f"K9 q4 at m={m}: the f32_decode_tc form {steps32[m]['ms']:.3f} ms per "
                    f"step (f32 x), x@W f32 {steps32[m]['library_ms']:.3f} ms, bound "
                    f"{steps32[m]['bound_ms']:.3f} ms")
    worst = {key: max(e.get(key, 0.0) for e in errs_all) for e in errs_all for key in e}
    out["f32_decode"]["max_abs_err"] = max(e for key, e in worst.items() if f32_decode(*key))
    return out["q8"], out["f32_decode"], out["tile"], out["f32_tile"]


def _k2_inputs(dev, gen, t, fill, c=K2_SHAPE, dtype="bfloat16"):
    import torch

    dt = getattr(torch, dtype)
    h = c["kv"] * c["g"]
    q = torch.randn((c["b"], t, h, c["hd"]), generator=gen, device=dev).to(dt)
    cache_shape = (c["b"], c["kv"], c["s"], c["hd"])
    kc = torch.randn(cache_shape, generator=gen, device=dev).to(dt)
    vc = torch.randn(cache_shape, generator=gen, device=dev).to(dt)
    pos0 = max(fill - t, 0)
    positions = (torch.full((c["b"], 1), pos0, device=dev)
                 + torch.arange(t, device=dev)[None, :])
    return q, kc, vc, positions


def _k2_call(q, kc, vc, positions):
    """One K2 call, which must take the form `k2_form` names for the
    cache's dtype and the window. The memory its workspace and its output
    will take is filled with NaN first (the caching allocator hands the
    blocks just freed to the next requests of their sizes), so a partial or
    a row the kernels leave unwritten shows."""
    import torch

    from llamago_tpu_torch.ops import attention

    fn = attention.flash_attention
    b, t, h, hd = q.shape
    kv = kc.shape[1]
    form, _, _, ws = attention.k2_plan(kc.dtype, b, kv, t, h // kv, hd, kc.shape[2])
    poison = [torch.full((max(1, ws),), float("nan"), device=q.device),
              torch.full_like(q, float("nan"))]
    del poison
    counts = lambda: (fn.launches, fn.launches_decode_tc, fn.launches_decode_f32tc)  # noqa: E731
    before = counts()
    got = fn(q, kc, vc, positions)
    if counts() != (before[0] + 1, before[1] + (form == "decode_tc"),
                    before[2] + (form == "decode_f32tc")):
        raise AssertionError(f"K2: a {kc.dtype} cache at t={t} did not take the {form} form")
    return got


def _k2_error(q, kc, vc, positions, c, got=None) -> float:
    """max |kernel - plain| over one call (or over `got`, its output)."""
    import torch

    from llamago_tpu_torch.ops import attention

    if got is None:
        got = _k2_call(q, kc, vc, positions)
    q5 = q.reshape(c["b"], q.shape[1], c["kv"], c["g"], c["hd"])
    ref = attention.flash_attention_plain(q5, kc, vc, positions[:, 0].to(torch.int32))
    torch.cuda.synchronize()
    return (got.float() - ref.reshape(got.shape).float()).abs().max().item()


def check_k2(dev, detail: dict) -> tuple[dict, dict]:
    """K2 at b=4, KV=32, hd=128, S=1024, in bf16 (the tensor-core form),
    checked and timed: window t=1 (decode) at fills 1, 101 (the serving
    fill), the split's edges (its slots - 1, + 0, + 1), 300 and 1024, t=8
    (the speculative verify window) at fills 101 and 1024, and t=32
    (prefill bucket) at fills 1, 300 and 1024; in f32 (its 3xTF32
    tensor-core form, within F32_ATTN_TOL) at K2_F32_WINDOWS, timed beside
    SDPA on the same f32 tensors; other geometries checked only: GQA g=8 at
    hd=64 in bf16, and in f32 at g=2 and g=8 (t = 1, 7, 16, 32). Each timed
    row is called once more after its timing, into NaN-filled memory, which
    must give the first call's bits (the merge runs in split order).
    Returns the kernels line's numbers of the bf16 and the f32 form (a
    decode step at full fill; the f32 error over every f32 row)."""
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(2)
    c = K2_SHAPE
    rows, max_err, record = [], 0.0, None
    # other geometries the kernel takes: GQA g=8 at hd=64, and f32
    for shape, dtype, tol in ((dict(b=2, kv=2, g=8, hd=64, s=512), "bfloat16", K2_TOL),
                              (dict(b=2, kv=4, g=2, hd=128, s=512), "float32", F32_ATTN_TOL),
                              (dict(b=2, kv=2, g=8, hd=64, s=320), "float32", F32_ATTN_TOL)):
        for t in (1, 7, 16, 32):
            err = _k2_error(*_k2_inputs(dev, gen, t, 200, shape, dtype), shape)
            if not err <= tol:
                raise AssertionError(f"K2 {shape} {dtype} t={t}: max|d| {err:.3g} > {tol}")
            max_err = max(max_err, err)
            log(f"K2 {shape} {dtype} t={t}: max|d| {err:.2e}")
    sps = attention.decode_attn_plan(c["b"], c["kv"], 1, c["g"], c["hd"], c["s"])[0]
    windows = [(1, f) for f in sorted({1, 101, sps - 1, sps, sps + 1, 300, c["s"]})]
    windows += [(8, f) for f in (101, c["s"])]  # the speculative verify window
    windows += [(32, f) for f in (1, 300, c["s"])]
    for t, fill in windows:
        q, kc, vc, positions = _k2_inputs(dev, gen, t, fill)
        q5 = q.reshape(c["b"], t, c["kv"], c["g"], c["hd"])
        pos0 = positions[:, 0].to(torch.int32)
        first = _k2_call(q, kc, vc, positions)
        err = _k2_error(q, kc, vc, positions, c, first)
        if not err <= K2_TOL:
            raise AssertionError(f"K2 t={t} fill={fill}: max|d| {err:.3g} > {K2_TOL}")
        max_err = max(max_err, err)
        # caches enough that a cycle of calls streams past the 50 MB L2,
        # as a decode step's 32 layers do
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(K2_COPIES - 1)]
        visible = min(max(fill, t), c["s"])  # slots seen by the last query row
        kern = timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                      for kv in caches], 50 * K2_COPIES)
        plain = timed([lambda kv=kv: attention.flash_attention_plain(q5, *kv, pos0)
                       for kv in caches], 2 * K2_COPIES)
        # yardstick: SDPA over the visible prefix (causal within the window)
        qh = q.transpose(1, 2)
        mask = None
        if t > 1:
            qpos = positions[0][:, None]
            mask = torch.arange(visible, device=dev)[None, :] <= qpos
        lib = timed([lambda kv=kv: F.scaled_dot_product_attention(
            qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
            for kv in caches], 50 * K2_COPIES)
        del caches
        if not torch.equal(_k2_call(q, kc, vc, positions), first):
            raise AssertionError(f"K2 t={t} fill={fill}: a second call gave other bits")
        h = c["kv"] * c["g"]
        nbytes = (2 * c["b"] * c["kv"] * visible * c["hd"] * 2
                  + 2 * c["b"] * t * h * c["hd"] * 2 + c["b"] * 4)
        bnd, by = bound_ms(nbytes, 4.0 * c["b"] * h * t * visible * c["hd"])
        form = attention.k2_form(kc.dtype)
        row = dict(t=t, fill=fill, visible=visible, form=form, ms=kern, plain_ms=plain,
                   library_ms=lib, bound_ms=bnd, bound_by=by, max_abs_err=err)
        rows.append(row)
        log(f"K2 t={t:2d} fill={fill:4d} ({form}): kernel {kern:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms, max|d| {err:.2e}")
        if t == 1 and fill == c["s"]:
            record = row
    detail["k2"] = rows
    # the f32 form (3xTF32 on the tensor cores) at the same geometry beside
    # SDPA on the same f32 tensors: the --dtype float32 route's decode step
    # and prefill buckets; each row is called again into NaN-filled memory
    # and must give the same bits
    f32_rows = []
    for t, fill in K2_F32_WINDOWS:
        q, kc, vc, positions = _k2_inputs(dev, gen, t, fill, c, "float32")
        first = _k2_call(q, kc, vc, positions)
        err = _k2_error(q, kc, vc, positions, c, first)
        if not err <= F32_ATTN_TOL:
            raise AssertionError(f"K2 f32 t={t} fill={fill}: max|d| {err:.3g} > {F32_ATTN_TOL}")
        q5 = q.reshape(c["b"], t, c["kv"], c["g"], c["hd"])
        pos0 = positions[:, 0].to(torch.int32)
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(K2_COPIES - 1)]
        visible = min(max(fill, t), c["s"])
        kern = timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                      for kv in caches], 50 * K2_COPIES)
        plain = timed([lambda kv=kv: attention.flash_attention_plain(q5, *kv, pos0)
                       for kv in caches], 2 * K2_COPIES)
        qh = q.transpose(1, 2)
        mask = (None if t == 1 else
                torch.arange(visible, device=dev)[None, :] <= positions[0][:, None])
        lib = timed([lambda kv=kv: F.scaled_dot_product_attention(
            qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
            for kv in caches], 50 * K2_COPIES)
        del caches
        if not torch.equal(_k2_call(q, kc, vc, positions), first):
            raise AssertionError(f"K2 f32 t={t} fill={fill}: a second call into NaN-filled "
                                 "memory gave other bits")
        h = c["kv"] * c["g"]
        form = attention.k2_form(kc.dtype)
        nbytes = (2 * c["b"] * c["kv"] * visible * c["hd"] * 4
                  + 2 * c["b"] * t * h * c["hd"] * 4 + c["b"] * 4)
        ops = 4.0 * c["b"] * h * t * visible * c["hd"]
        bnd, by = bound_ms(nbytes, ops, TF32X3_OPS_PER_S)
        fma_bnd, _ = bound_ms(nbytes, ops, F32_OPS_PER_S)
        names = sdpa_kernels(lambda: F.scaled_dot_product_attention(
            qh, kc[:, :, :visible], vc[:, :, :visible], attn_mask=mask))
        f32_rows.append(dict(t=t, fill=fill, form=form, ms=kern, plain_ms=plain,
                             library_ms=lib, bound_ms=bnd, bound_by=by,
                             fma_bound_ms=fma_bnd, max_abs_err=err, sdpa_kernels=names))
        log(f"K2 f32 t={t:2d} fill={fill:4d} ({form}): kernel {kern:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa f32 {lib:.4f} ms, bound {bnd:.4f} ms ({by}; at the FMA "
            f"rate {fma_bnd:.4f}), max|d| {err:.2e}; SDPA ran {names}")
    detail["k2_f32"] = f32_rows
    # one decode step at full fill: one call per layer (32), in bf16 and f32
    step = lambda r: {"max_abs_err": r["max_abs_err"], "bound_by": r["bound_by"],  # noqa: E731
                      **{k: 32 * r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    f32_step = next(r for r in f32_rows if (r["t"], r["fill"]) == (1, c["s"]))
    return step({**record, "max_abs_err": max_err}), step(
        {**f32_step, "max_abs_err": max(r["max_abs_err"] for r in f32_rows)})


def launch_floor_ms() -> float:
    """The card's floor for one small launch: a `fill_` of a one-element
    tensor, timed as the kernels are (`timed`). Context for the
    launch-bound rows (K3, K10), not a bound."""
    import torch

    one = torch.zeros((1,), device="cuda")
    return timed([lambda: one.fill_(1.0)], 200)


def k3_serving_rows(dev, gen, c, dtype):
    """New K and V rows as the serving path hands them to K3: k contiguous
    (the rope's output), v a view of the fused [b, 1, q_dim + 2 kv_dim]
    projection (7B: q_dim = kv_dim), its batch stride the projection's
    width."""
    import torch

    b, kv, hd = c["b"], c["kv"], c["hd"]
    qkv = torch.randn((b, 1, 3 * kv * hd), generator=gen, device=dev).to(dtype)
    k = qkv[..., kv * hd:2 * kv * hd].reshape(b, 1, kv, hd).contiguous()
    v = qkv[..., 2 * kv * hd:].reshape(b, 1, kv, hd)
    if v.is_contiguous() or v.data_ptr() != qkv.data_ptr() + 2 * kv * hd * qkv.element_size():
        raise AssertionError("K3: the serving path's v is not a view of the projection")
    return [k, v]


def device_ops_per_call(fn, launched, calls: int = 50) -> tuple[float, list[str]]:
    """The device-side operations (kernels, and any copy or fill) that one
    call of fn runs: those of a torch.profiler trace of `calls` calls, over
    `calls`, and their names. `launched()` reads the launch count of the
    kernel that fn must run. A trace can lose events (seen on the card: none
    at all in eight traces of a single K3 call, and 4 of 50 in one trace of
    50), so a trace that holds fewer device events than the kernel counted
    launches in it is taken again (`profiled`), and the count is taken over
    many calls."""
    import torch

    from llamago_tpu_torch.utils.timing import profiled

    def run():
        for _ in range(calls):
            fn()

    fn()  # warm: libraries loaded, memory cached
    before = launched()
    run()
    torch.cuda.synchronize()
    counted = launched() - before
    if counted != calls:
        raise AssertionError(f"{calls} calls counted {counted} launches")
    events = [e for e in profiled(run, min_events=counted)
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events) / calls, sorted({e.name for e in events})


def check_k3(dev, detail: dict) -> dict:
    """K3 at b=8, KV=32, hd=128, S=1024 (the int8 serving phase's decode
    step), bf16 and f32 new rows, f32 and bf16 scale planes, write positions
    0, S-1, overrunning and negative starts among them, on two kinds of
    input: contiguous rows with int32 positions, and the serving path's
    own (`k3_serving_rows`: v a strided view of the fused projection, int64
    positions). Each bit-exact against the plain version, every other row
    untouched. A call on the serving path's inputs must be one device
    kernel (`device_ops_per_call`). Timed with bf16 new rows on both inputs
    beside the card's floor for one small launch; no one PyTorch call
    computes it. The kernels line takes the serving path's inputs with f32
    planes, the default."""
    import torch

    from llamago_tpu_torch.ops import cache_write

    gen = torch.Generator(device=dev).manual_seed(5)
    c = K3_SHAPE
    b, kv, hd, s = c["b"], c["kv"], c["hd"], c["s"]
    shape = (b, kv, s, hd)
    rows8 = [torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=dev)
             for _ in range(2)]
    scales = [torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
    pos = torch.tensor([0, s - 1, s + 500, -5, 1, 512, 700, 2 * s - 1], dtype=torch.int32,
                       device=dev)
    slot = torch.tensor([0, s - 1, s - 1, s - 5, 1, 512, 700, s - 1], device=dev)
    written = torch.zeros((b, s), dtype=torch.bool, device=dev)
    written[torch.arange(b, device=dev), slot] = True
    timed_inputs = {
        "contiguous, int32": ([torch.randn((b, 1, kv, hd), generator=gen, device=dev)
                               .to(torch.bfloat16) for _ in range(2)],
                              torch.full((b,), 700, dtype=torch.int32, device=dev)),
        "serving, int64": (k3_serving_rows(dev, gen, c, torch.bfloat16),
                           torch.full((b,), 700, dtype=torch.int64, device=dev))}
    n = b * kv * hd  # values per new K (or V) tensor
    floor = launch_floor_ms()
    log(f"K3: the card's floor for one small launch (fill_ of one element) {floor:.5f} ms")
    out = {}
    for sdt in (torch.float32, torch.bfloat16):
        sname = str(sdt).split(".")[-1]
        cache = rows8 + [a.to(sdt) for a in scales]
        for dtype in (torch.bfloat16, torch.float32):
            for inputs in ("contiguous, int32", "serving, int64"):
                if inputs == "serving, int64":
                    new, p = k3_serving_rows(dev, gen, c, dtype), pos.long()
                else:
                    new = [torch.randn((b, 1, kv, hd), generator=gen, device=dev).to(dtype)
                           for _ in range(2)]
                    p = pos
                new[1][0, 0, 3] = 0  # a zero row: scale 1, row 0
                got = [a.clone() for a in cache]
                want = [a.clone() for a in cache]
                launches = cache_write.cache_append_quant.launches
                cache_write.cache_append_quant(*got, *new, p)
                cache_write.cache_append_quant_plain(*want, *new, p)
                torch.cuda.synchronize()
                if cache_write.cache_append_quant.launches != launches + 1:
                    raise AssertionError("K3: the call counted no launch")
                for name, g, w, orig in zip(("k", "v", "ks", "vs"), got, want, cache):
                    if g.dtype != orig.dtype or not torch.equal(g, w):
                        raise AssertionError(f"K3 {dtype}, {sname} scales, {inputs}: {name} "
                                             "differs from the plain version")
                    keep = ~written[:, None, :].expand(b, kv, s)
                    if not torch.equal(g[keep], orig[keep]):
                        raise AssertionError(f"K3 {dtype}, {sname} scales, {inputs}: {name} "
                                             "changed a row it must not write")
                log(f"K3 {str(dtype).split('.')[-1]}, {sname} scales, {inputs}: bit-exact "
                    "against the plain version, other rows untouched")
        per_call, names = device_ops_per_call(
            lambda: cache_write.cache_append_quant(
                *cache, *timed_inputs["serving, int64"][0], timed_inputs["serving, int64"][1]),
            lambda: cache_write.cache_append_quant.launches)
        if round(per_call) != 1 or len(names) != 1:
            raise AssertionError(f"K3 on the serving path's inputs: {per_call} device "
                                 f"operations a call, not 1: {names}")
        log(f"K3 on the serving path's inputs: {per_call} device operations a call ({names})")
        out[sname] = {"launch_floor_ms": floor}
        for inputs, (new_t, pos_t) in timed_inputs.items():
            kern = timed([lambda: cache_write.cache_append_quant(*cache, *new_t, pos_t)], 200)
            plain = timed([lambda: cache_write.cache_append_quant_plain(*cache, *new_t, pos_t)],
                          20)
            # read the bf16 rows and the positions, write the int8 rows and the
            # scales; abs, max, divide and round per value in f32
            bnd, by = bound_ms(2 * n * 2 + pos_t.element_size() * b + 2 * n
                               + 2 * b * kv * cache[2].element_size(), 4.0 * 2 * n,
                               F32_OPS_PER_S)
            row = dict(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by)
            out[sname]["serving" if inputs.startswith("serving") else "contiguous"] = row
            log(f"K3 b={b}, {sname} scales, {inputs}: kernel {kern:.5f} ms, plain "
                f"{plain:.4f} ms, bound {bnd:.6f} ms, launch floor {floor:.5f} ms (one layer)")
    detail["k3"], detail["k3_bf16_scales"] = out["float32"], out["bfloat16"]
    row = out["float32"]["serving"]
    # one decode step: one launch per layer (32)
    return {"max_abs_err": 0.0, "bound_by": row["bound_by"], "library_ms": None,
            **{k: 32 * row[k] for k in ("ms", "plain_ms", "bound_ms")}}


def _quant_cache(dev, gen, b, kv, s, hd):
    """int8 rows and f32 row scales of a normal cache."""
    import torch

    from llamago_tpu_torch.runtime.kv_cache import quantize_kv_rows

    return quantize_kv_rows(torch.randn((b, kv, s, hd), generator=gen, device=dev))


def _k4_call(q, k8, v8, positions, ks, vs):
    """One K4 or K8 call (as `attention._I8DOT` says), which must take the
    form `quant_plan` names for the cache's S. The memory its workspace and
    its output will take is filled with NaN first (the caching allocator
    hands the blocks just freed to the next requests of their sizes), so a
    partial or a row the kernels leave unwritten shows."""
    import torch

    from llamago_tpu_torch.ops import attention

    fn = attention.flash_attention_quant
    b, t, h, hd = q.shape
    kv = k8.shape[1]
    form, _, _, ws = attention.quant_plan(attention._I8DOT, b, kv, t, h // kv, hd, k8.shape[2],
                                          q.dtype)
    poison = [torch.full((ws,), float("nan"), device=q.device), torch.full_like(q, float("nan"))]
    del poison
    counters = ("launches_i8dot", "launches_i8dot_tc", "launches_widening",
                "launches_widening_tc")
    before = [getattr(fn, c) for c in counters]
    got = fn(q, k8, v8, positions, ks, vs)
    widening = form.startswith("widening")
    rise = (not widening, form == "i8dot_tc", widening, form == "widening_tc")
    if [getattr(fn, c) for c in counters] != [n + r for n, r in zip(before, rise)]:
        raise AssertionError(f"K4/K8: S={k8.shape[2]} q={q.dtype} did not take the {form} form")
    return got


def _k4_error(q, k8, v8, positions, ks, vs, plain, got=None) -> float:
    """max |kernel - plain| over one call (or over `got`, its output)."""
    import torch

    if got is None:
        got = _k4_call(q, k8, v8, positions, ks, vs)
    b, t, h, hd = q.shape
    q5 = q.reshape(b, t, k8.shape[1], h // k8.shape[1], hd)
    ref = plain(q5, k8, v8, positions[:, 0].to(torch.int32), ks, vs)
    torch.cuda.synchronize()
    return (got.float() - ref.reshape(got.shape).float()).abs().max().item()


# K4's timed windows (t, fill) at K4_SHAPE: decode at the serving fill
# (101), on an S-block's edges (255, 256, 257) and up to full; the
# speculative verify window (t = 8) at fills 101 and 1024; prefill buckets
# 16 and 32. K8 keeps its six, timed with bf16 q (its
# tensor-core form), and checks its splits' edges (64 slots a split at t =
# 1, 128 at t = 16, 256 at t = 32) and the serving fill; with f32 q (its
# CUDA-core form) two windows are checked and t = 1 at full fill timed.
K4_WINDOWS = ([(1, f) for f in (1, 101, 255, 256, 257, 300, 1024)]
              + [(8, f) for f in (101, 1024)] + [(16, f) for f in (101, 1024)]
              + [(32, f) for f in (1, 300, 1024)])
K8_WINDOWS = [(t, f) for t in (1, 32) for f in (1, 300, 1024)]
K8_CHECKED = [(1, 63), (1, 64), (1, 65), (1, 101), (16, 101), (16, 1024), (32, 255),
              (32, 257)]
K8_F32_WINDOWS = [(1, 300), (32, 1024), (1, 1024)]  # the last one timed


def check_k4_k8(dev, detail: dict) -> tuple[dict, dict, dict]:
    """K4 (i8dot) and K8 (widening) at b=8, KV=32, hd=128, S=1024, with f32
    and then with bf16 scale planes: K4 and K8 with q in bf16 checked and
    timed at K4_WINDOWS and K8_WINDOWS (K4 takes its tensor-core form there,
    S-blocks of 256, and K8 its tensor-core form, `k8_split` slots a
    split), K8 also checked at K8_CHECKED; K8 with f32 q (its CUDA-core
    form) at K8_F32_WINDOWS; a GQA geometry (g=8, hd=64, S=512; K8 also at
    t = 32: four blocks of 64 rows a head) and S=520 (K4: S-blocks of 8, the
    CUDA-core form; K8 with bf16 q: no whole tiles, the CUDA-core form)
    checked only. Each call must take the form `quant_plan` names, and each
    timed row is called once more after its timing, into NaN-filled memory,
    which must give the first call's bits. The yardstick is SDPA over a
    dequantized copy of the visible cache in q's dtype: the same function,
    reading two (bf16) or four (f32) times the cache bytes. The kernels line
    takes the f32 planes, the default: K4's and K8's tensor-core forms (bf16
    q) and K8's CUDA-core form (f32 q), each one decode step at full fill."""
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(6)
    c = K4_SHAPE
    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    h = kv * g
    caches32 = [(*_quant_cache(dev, gen, b, kv, s, hd), *_quant_cache(dev, gen, b, kv, s, hd))
                for _ in range(K4_COPIES)]  # (k8, ks, v8, vs)
    # checked only: ((b, kv, g, hd, S), t, row 0's positions, the kernels)
    checked = [((2, 2, 8, 64, 512), t, (190, 480), ("K4", "K8")) for t in (1, 16)]
    checked += [((2, 2, 8, 64, 512), 32, (100, 480), ("K8",))]
    checked += [((2, 4, 2, 128, 520), t, (299 - t + 1, 519 - t + 1), ("K4", "K8"))
                for t in (1, 32)]
    cache_of = {(gb, gkv, gg, ghd, gs): (*_quant_cache(dev, gen, gb, gkv, gs, ghd),
                                         *_quant_cache(dev, gen, gb, gkv, gs, ghd))
                for (gb, gkv, gg, ghd, gs), *_ in checked}
    out, default = {}, attention._I8DOT

    def row(name, plain, rate, caches, deq, t, fill, qdt, sname, timed_row=True):
        """One window at K4_SHAPE: checked (and its form asserted), and,
        when timed, timed beside plain, SDPA on `deq` and the bound, and
        called again for its bits."""
        q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(qdt)
        positions = (torch.full((b, 1), max(fill - t, 0), device=dev)
                     + torch.arange(t, device=dev)[None, :])
        k8, ks, v8, vs = caches[0]
        first = _k4_call(q, k8, v8, positions, ks, vs)
        err = _k4_error(q, k8, v8, positions, ks, vs, plain, first)
        form = attention.quant_plan(attention._I8DOT, b, kv, t, g, hd, s, qdt)[0]
        qname = str(qdt).split(".")[-1]
        if not err <= K4_TOL:
            raise AssertionError(f"{name} t={t} fill={fill} q={qname}, {sname} scales: "
                                 f"max|d| {err:.3g} > {K4_TOL}")
        if not timed_row:
            log(f"{name} t={t:2d} fill={fill:4d} q={qname} ({form}), {sname} scales: "
                f"max|d| {err:.2e}")
            return dict(t=t, fill=fill, form=form, max_abs_err=err)
        visible = min(max(fill, t), s)  # slots seen by the last query row
        q5 = q.reshape(b, t, kv, g, hd)
        pos0 = positions[:, 0].to(torch.int32)
        kern = timed([lambda c_=c_: attention.flash_attention_quant(
            q, c_[0], c_[2], positions, c_[1], c_[3]) for c_ in caches], 50 * K4_COPIES)
        plain_ms = timed([lambda c_=c_: plain(q5, c_[0], c_[2], pos0, c_[1], c_[3])
                          for c_ in caches], 2 * K4_COPIES)
        qh = q.transpose(1, 2)
        mask = None
        if t > 1:
            mask = (torch.arange(visible, device=dev)[None, :] <= positions[0][:, None])
        lib = timed([lambda d=d: F.scaled_dot_product_attention(
            qh, d[0][:, :, :visible], d[1][:, :, :visible], attn_mask=mask)
            for d in deq], 50 * K4_COPIES)
        if not torch.equal(_k4_call(q, k8, v8, positions, ks, vs), first):
            raise AssertionError(f"{name} t={t} fill={fill} q={qname}, {sname} scales: a "
                                 "second call gave other bits")
        nbytes = (2 * b * kv * visible * (hd + ks.element_size())
                  + 2 * b * t * h * hd * q.element_size() + b * 4)
        bnd, by = bound_ms(nbytes, 4.0 * b * h * t * visible * hd, rate)
        log(f"{name} t={t:2d} fill={fill:4d} q={qname} ({form}), {sname} scales: kernel "
            f"{kern:.4f} ms, plain {plain_ms:.4f} ms, sdpa on a {qname} copy {lib:.4f} ms, "
            f"bound {bnd:.4f} ms, max|d| {err:.2e}")
        return dict(t=t, fill=fill, visible=visible, form=form, ms=kern, plain_ms=plain_ms,
                    library_ms=lib, bound_ms=bnd, bound_by=by, max_abs_err=err)

    def step(rows):
        """The kernels line's numbers: one decode step at full fill, one
        launch per layer (32), and the largest error of the rows."""
        rec = next(r for r in rows if r["t"] == 1 and r.get("fill") == s and "ms" in r)
        return {"max_abs_err": max(r["max_abs_err"] for r in rows), "bound_by": rec["bound_by"],
                **{k: 32 * rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}

    for sdt in (torch.float32, torch.bfloat16):
        sname = str(sdt).split(".")[-1]
        caches = [(k8, ks.to(sdt), v8, vs.to(sdt)) for k8, ks, v8, vs in caches32]

        def dequantized(dt):
            return [((k8.float() * ks.float()[..., None]).to(dt),
                     (v8.float() * vs.float()[..., None]).to(dt)) for k8, ks, v8, vs in caches]

        deq = dequantized(torch.bfloat16)
        for i8dot, name, plain, rate, windows in (
                (True, "K4", attention.flash_attention_quant_i8dot_plain, INT8_OPS_PER_S,
                 K4_WINDOWS),
                (False, "K8", attention.flash_attention_quant_plain, BF16_OPS_PER_S,
                 K8_WINDOWS)):
            attention._I8DOT = i8dot
            rows = []
            for geo, t, starts, who in checked:
                if name not in who:
                    continue
                gb, gkv, gg, ghd, gs = geo
                gk8, gks, gv8, gvs = (a if a.dtype == torch.int8 else a.to(sdt)
                                      for a in cache_of[geo])
                gq = torch.randn((gb, t, gkv * gg, ghd), generator=gen, device=dev).bfloat16()
                gpos = torch.tensor(starts, device=dev)[:, None] + torch.arange(t, device=dev)
                form = attention.quant_plan(i8dot, gb, gkv, t, gg, ghd, gs, gq.dtype)[0]
                err = _k4_error(gq, gk8, gv8, gpos, gks, gvs, plain)
                if not err <= K4_TOL:
                    raise AssertionError(f"{name} {geo} t={t}, {sname} scales: max|d| "
                                         f"{err:.3g} > {K4_TOL}")
                rows.append(dict(geometry=geo, t=t, form=form, max_abs_err=err))
                log(f"{name} b={gb} KV={gkv} g={gg} hd={ghd} S={gs} t={t} ({form}), {sname} "
                    f"scales: max|d| {err:.2e}")
            for t, fill in windows:
                rows.append(row(name, plain, rate, caches, deq, t, fill, torch.bfloat16, sname))
                if name == "K8" and rows[-1]["form"] != "widening_tc":
                    raise AssertionError(f"K8 t={t} fill={fill}: bf16 q took {rows[-1]['form']}")
            if name == "K8":
                for t, fill in K8_CHECKED:
                    rows.append(row(name, plain, rate, caches, deq, t, fill, torch.bfloat16,
                                    sname, timed_row=False))
                deq32 = dequantized(torch.float32)
                f32_rows = [row(name, plain, F32_OPS_PER_S, caches, deq32, t, fill,
                                torch.float32, sname, timed_row=(t, fill) == K8_F32_WINDOWS[-1])
                            for t, fill in K8_F32_WINDOWS]
                del deq32
                if any(r["form"] != "widening" for r in f32_rows):
                    raise AssertionError(f"K8: f32 q took {[r['form'] for r in f32_rows]}")
                detail[f"k8_f32_q_{sname}_scales"] = f32_rows
                if sdt == torch.float32:
                    out["K8 cuda cores"] = step(f32_rows)
            detail[name.lower() if sdt == torch.float32 else f"{name.lower()}_bf16_scales"] = rows
            if sdt == torch.float32:
                out[name] = step(rows)
        del caches, deq
    attention._I8DOT = default
    del caches32, cache_of
    torch.cuda.empty_cache()
    return out["K4"], out["K8"], out["K8 cuda cores"]


def sdpa_kernels(fn) -> list[str]:
    """The device kernels one SDPA call `fn()` launches, by name as the trace
    shows them (which backend PyTorch chose)."""
    from llamago_tpu_torch.utils.timing import profiled

    return sorted(k[:120] for k in device_us_by_name(profiled(fn)))


def _k7_inputs(dev, gen, t, pos0, c, dtype):
    """q [B, t, H, hd], K and V caches [B, KV, S, hd] and positions [B, t];
    `pos0` is one start or one per batch row."""
    import torch

    dt = getattr(torch, dtype)
    q = torch.randn((c["b"], t, c["kv"] * c["g"], c["hd"]), generator=gen, device=dev).to(dt)
    cache_shape = (c["b"], c["kv"], c["s"], c["hd"])
    kc = torch.randn(cache_shape, generator=gen, device=dev).to(dt)
    vc = torch.randn(cache_shape, generator=gen, device=dev).to(dt)
    starts = torch.tensor(pos0 if isinstance(pos0, (list, tuple)) else [pos0] * c["b"],
                          device=dev)
    return q, kc, vc, starts[:, None] + torch.arange(t, device=dev)[None, :]


def _k7_call(q, kc, vc, positions):
    """One call that must take K7 in the form `k7_form` names for the
    cache's dtype. The memory its workspace and its output will take is
    filled with NaN first (the caching allocator hands the blocks just freed
    to the next requests of their sizes), so a partial or a row the kernels
    leave unwritten shows."""
    import torch

    from llamago_tpu_torch.ops import attention

    fn = attention.flash_attention
    b, t, h, hd = q.shape
    kv = kc.shape[1]
    form, _, _, ws = attention.prefill_plan(kc.dtype, b, kv, t, h // kv, hd, kc.shape[2])
    poison = [torch.full((ws,), float("nan"), device=q.device), torch.full_like(q, float("nan"))]
    del poison
    counts = lambda: (fn.launches_prefill, fn.launches_prefill_tc,  # noqa: E731
                      fn.launches_prefill_f32tc)
    before = counts()
    got = fn(q, kc, vc, positions)
    if counts() != (before[0] + 1, before[1] + (form == "prefill_tc"),
                    before[2] + (form == "prefill_f32tc")):
        raise AssertionError(f"K7: a {kc.dtype} cache did not take the {form} form")
    return got


def _k7_error(q, kc, vc, positions, c, got=None) -> float:
    """max |kernel - plain| / max(1, |plain|) over one call that must take K7
    (or over `got`, its output)."""
    import torch

    from llamago_tpu_torch.ops import attention

    if got is None:
        got = _k7_call(q, kc, vc, positions)
    got = got.float()
    q5 = q.reshape(c["b"], q.shape[1], c["kv"], c["g"], c["hd"])
    ref = attention.flash_attention_prefill_plain(q5, kc, vc, positions[:, 0].to(torch.int32))
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("K7: non-finite output")
    ref = ref.reshape(got.shape).float()
    return ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()


def check_k7(dev, detail: dict) -> tuple[dict, dict]:
    """K7 at b=1, KV=32, hd=128, S=1024 in bf16 (its tensor-core form,
    chunks of `k7_chunk` slots) and in f32 (its 3xTF32 tensor-core form,
    the same chunks, within F32_ATTN_TOL) for the windows (t, pos0) of the
    7B prefill (buckets 64, 128, 256; chunks at positions 0, 512, 640)
    and the 512-token perplexity window at position 0,
    checked and timed beside its plain version, SDPA with a boolean mask
    over the visible prefix (on the same f32 tensors for f32) and, in bf16,
    the port's einsum math (the default route of these windows); GQA
    geometries in f32 and bf16 (ragged t, ragged S, hd 64) and a t=16
    window with LLAMAGO_ATTN_LENAWARE off checked only. Each call must take
    the form `k7_form` names, and each timed window is called once more
    after its timing, into NaN-filled memory, which must give the first
    call's bits. The kernels line takes one prefill pass of 256 tokens at
    position 512 (32 launches) of each form."""
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(15)
    rows, max_err, max_f32_err, record = [], 0.0, 0.0, None
    for shape, dtype, t, pos0, tol in (
            (dict(b=2, kv=2, g=4, hd=64, s=512), "float32", 40, [100, 300], F32_ATTN_TOL),
            (dict(b=2, kv=2, g=2, hd=128, s=200), "float32", 70, [0, 130], F32_ATTN_TOL),
            (dict(b=1, kv=4, g=1, hd=128, s=1024), "float32", 256, [700], F32_ATTN_TOL),
            (dict(b=2, kv=2, g=2, hd=64, s=500), "bfloat16", 70, [0, 430], K7_TOL),
            (dict(b=2, kv=4, g=8, hd=128, s=512), "bfloat16", 33, [7, 479], K7_TOL)):
        err = _k7_error(*_k7_inputs(dev, gen, t, pos0, shape, dtype), shape)
        if not err <= tol:
            raise AssertionError(f"K7 {shape} {dtype} t={t}: max|d| {err:.3g} > {tol}")
        if dtype == "bfloat16":
            max_err = max(max_err, err)
        else:
            max_f32_err = max(max_f32_err, err)
        log(f"K7 {shape} {dtype} t={t} pos0={pos0}: max|d| {err:.2e}")
    c = K7_SHAPE
    lenaware = attention._LENAWARE
    attention._LENAWARE = False  # windows of t <= 32 take K7 too
    try:
        err = _k7_error(*_k7_inputs(dev, gen, 16, 100, c, "bfloat16"), c)
    finally:
        attention._LENAWARE = lenaware
    if not err <= K7_TOL:
        raise AssertionError(f"K7 t=16 with LENAWARE off: max|d| {err:.3g} > {K7_TOL}")
    max_err = max(max_err, err)
    log(f"K7 t=16 pos0=100 with LLAMAGO_ATTN_LENAWARE off: max|d| {err:.2e}")
    h = c["kv"] * c["g"]
    for t, pos0 in K7_WINDOWS:
        q, kc, vc, positions = _k7_inputs(dev, gen, t, pos0, c, "bfloat16")
        first = _k7_call(q, kc, vc, positions)
        err = _k7_error(q, kc, vc, positions, c, got=first)
        if not err <= K7_TOL:
            raise AssertionError(f"K7 t={t} pos0={pos0}: max|d| {err:.3g} > {K7_TOL}")
        max_err = max(max_err, err)
        q5 = q.reshape(c["b"], t, c["kv"], c["g"], c["hd"])
        p0 = positions[:, 0].to(torch.int32)
        # caches enough that a cycle of calls streams past the 50 MB L2, as a
        # prefill pass's 32 layers do
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(K7_COPIES - 1)]
        visible = pos0 + t
        kern = timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                      for kv in caches], 25 * K7_COPIES)
        plain = timed([lambda kv=kv: attention.flash_attention_prefill_plain(q5, *kv, p0)
                       for kv in caches], 2 * K7_COPIES)
        math = timed([lambda kv=kv: attention.attention_math(q, *kv, positions)
                      for kv in caches], 2 * K7_COPIES)
        qh = q.transpose(1, 2)
        mask = torch.arange(visible, device=dev)[None, :] <= positions[0][:, None]
        lib = timed([lambda kv=kv: F.scaled_dot_product_attention(
            qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
            for kv in caches], 25 * K7_COPIES)
        del caches
        if not torch.equal(_k7_call(q, kc, vc, positions), first):
            raise AssertionError(f"K7 t={t} pos0={pos0}: a second call into NaN-filled "
                                 "memory gave other bits")
        nbytes = (2 * c["b"] * c["kv"] * visible * c["hd"] * 2
                  + 2 * c["b"] * t * h * c["hd"] * 2 + c["b"] * 4)
        ops = 4.0 * c["b"] * h * c["hd"] * (t * pos0 + t * (t + 1) / 2)
        bnd, by = bound_ms(nbytes, ops)
        row = dict(t=t, pos0=pos0, visible=visible, ms=kern, plain_ms=plain, math_ms=math,
                   library_ms=lib, bound_ms=bnd, bound_by=by, max_abs_err=err)
        rows.append(row)
        log(f"K7 t={t:3d} pos0={pos0:3d}: kernel {kern:.4f} ms, plain {plain:.4f} ms, einsum "
            f"math {math:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}), max|d| "
            f"{err:.2e}")
        if (t, pos0) == (256, 512):
            record = row
    detail["k7"] = rows
    # the f32 form (3xTF32 on the tensor cores) at the same windows beside
    # SDPA on the same f32 tensors: the --dtype float32 route's prefill
    # attention; each window called again into NaN-filled memory
    f32_rows, f32_record = [], None
    for t, pos0 in K7_WINDOWS:
        q, kc, vc, positions = _k7_inputs(dev, gen, t, pos0, c, "float32")
        first = _k7_call(q, kc, vc, positions)
        err = _k7_error(q, kc, vc, positions, c, got=first)
        if not err <= F32_ATTN_TOL:
            raise AssertionError(f"K7 f32 t={t} pos0={pos0}: max|d| {err:.3g} > {F32_ATTN_TOL}")
        q5 = q.reshape(c["b"], t, c["kv"], c["g"], c["hd"])
        p0 = positions[:, 0].to(torch.int32)
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(K7_COPIES - 1)]
        visible = pos0 + t
        kern = timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                      for kv in caches], 25 * K7_COPIES)
        plain = timed([lambda kv=kv: attention.flash_attention_prefill_plain(q5, *kv, p0)
                       for kv in caches], 2 * K7_COPIES)
        qh = q.transpose(1, 2)
        mask = torch.arange(visible, device=dev)[None, :] <= positions[0][:, None]
        lib = timed([lambda kv=kv: F.scaled_dot_product_attention(
            qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
            for kv in caches], 25 * K7_COPIES)
        del caches
        if not torch.equal(_k7_call(q, kc, vc, positions), first):
            raise AssertionError(f"K7 f32 t={t} pos0={pos0}: a second call into NaN-filled "
                                 "memory gave other bits")
        nbytes = (2 * c["b"] * c["kv"] * visible * c["hd"] * 4
                  + 2 * c["b"] * t * h * c["hd"] * 4 + c["b"] * 4)
        ops = 4.0 * c["b"] * h * c["hd"] * (t * pos0 + t * (t + 1) / 2)
        bnd, by = bound_ms(nbytes, ops, TF32X3_OPS_PER_S)
        fma_bnd, _ = bound_ms(nbytes, ops, F32_OPS_PER_S)
        names = sdpa_kernels(lambda: F.scaled_dot_product_attention(
            qh, kc[:, :, :visible], vc[:, :, :visible], attn_mask=mask))
        row = dict(t=t, pos0=pos0, ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                   bound_by=by, fma_bound_ms=fma_bnd, max_abs_err=err, sdpa_kernels=names)
        f32_rows.append(row)
        log(f"K7 f32 t={t:3d} pos0={pos0:3d} ({attention.k7_form(kc.dtype)}): kernel "
            f"{kern:.4f} ms, plain {plain:.4f} ms, sdpa f32 {lib:.4f} ms, bound {bnd:.4f} ms "
            f"({by}; at the FMA rate {fma_bnd:.4f}), max|d| {err:.2e}; SDPA ran {names}")
        if (t, pos0) == (256, 512):
            f32_record = row
    detail["k7_f32"] = f32_rows
    torch.cuda.empty_cache()
    f32_err = max(max_f32_err, *(r["max_abs_err"] for r in f32_rows))
    return ({"max_abs_err": max_err, "bound_by": record["bound_by"],
             **{k: 32 * record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}},
            {"max_abs_err": f32_err, "bound_by": f32_record["bound_by"],
             **{k: 32 * f32_record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}})


def check_k10(dev, detail: dict) -> dict:
    """K10 at d=4096 for 4 rows (a decode step of 4 slots) and 64 and 256
    rows (prefill), bf16 x (within one bf16 ulp of the plain version) and
    f32 x, weights in bf16 and f32, each call into NaN-filled memory; checked
    only: a ragged d=1000, a d=5000, an odd d=1001 (one value a load), a
    d=20000 longer than a row's registers hold (read again), and x starting
    one element past an aligned address (narrower loads). Timed in bf16 beside
    its plain version, the unfused rms_norm (what the port runs by default),
    F.rms_norm where PyTorch has it (else the library time is the unfused
    one's) and the card's floor for one small launch. The kernels line takes
    the 65 launches of one decode forward at 4 rows."""
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import basic, kernels

    gen = torch.Generator(device=dev).manual_seed(16)
    eps = 1e-5
    rows, max_err, record = [], 0.0, None

    def error(x, w):
        before = kernels.fused_rms_norm.launches
        # the caching allocator hands this block to the output next, so a
        # value the kernel leaves unwritten shows as NaN
        poison = torch.full_like(x, float("nan"))
        poisoned = poison.data_ptr()
        del poison
        got = kernels.fused_rms_norm(x, w, eps)
        if kernels.fused_rms_norm.launches != before + 1 or got.dtype != x.dtype \
                or got.shape != x.shape:
            raise AssertionError("K10: no launch counted, or a wrong dtype or shape")
        if got.data_ptr() != poisoned:
            raise AssertionError("K10: the output did not land on the NaN-filled block")
        ref = kernels.fused_rms_norm_plain(x, w, eps).float()
        torch.cuda.synchronize()
        d = (got.float() - ref).abs()
        # bf16 spaces its values by at most 2^-7 of their size
        lim = ref.abs() * (2.0 ** -7 if x.dtype == torch.bfloat16 else K10_RTOL_F32)
        if not (d <= lim + 1e-30).all():
            raise AssertionError(f"K10 x {tuple(x.shape)} {x.dtype} w {w.dtype}: "
                                 f"{(d > lim + 1e-30).sum().item()} values off by more than "
                                 "one bf16 ulp (bf16) or 1e-5 (f32), or not written")
        return (d.max() / ref.abs().max()).item()

    for n_rows, d, offset in ((4, K10_D, 0), (64, K10_D, 0), (256, K10_D, 0), (3, 1000, 0),
                              (5, 5000, 0), (3, 1001, 0), (2, 20000, 0), (4, K10_D, 1)):
        for xdt in (torch.bfloat16, torch.float32):
            for wdt in (torch.bfloat16, torch.float32):
                flat = (torch.randn((offset + n_rows * d,), generator=gen, device=dev) * 2)
                x = flat.to(xdt)[offset:].view(1, n_rows, d)
                w = (torch.rand((d,), generator=gen, device=dev) + 0.5).to(wdt)
                err = error(x, w)
                if xdt == torch.bfloat16:
                    max_err = max(max_err, err)
        # a bf16 x one element past an aligned start is 2-byte aligned
        plan = kernels.norm_plan(n_rows, d, torch.bfloat16, torch.bfloat16, 2 if offset else 16)
        log(f"K10 rows={n_rows} d={d} offset={offset} (bf16 plan {plan}): bf16 and f32 x, "
            f"bf16 and f32 w: within one bf16 ulp and {K10_RTOL_F32} of the plain version")
    has_lib = hasattr(F, "rms_norm")
    floor = launch_floor_ms()
    for n_rows in (4, 64, 256):
        # activations enough that a cycle of calls does not find them in L1
        xs = [(torch.randn((1, n_rows, K10_D), generator=gen, device=dev)).bfloat16()
              for _ in range(4)]
        w = (torch.rand((K10_D,), generator=gen, device=dev) + 0.5).bfloat16()
        kern = timed([lambda x=x: kernels.fused_rms_norm(x, w, eps) for x in xs], 200)
        plain = timed([lambda x=x: kernels.fused_rms_norm_plain(x, w, eps) for x in xs], 40)
        unfused = timed([lambda x=x: basic.rms_norm(x, w, eps) for x in xs], 40)
        lib = (timed([lambda x=x: F.rms_norm(x, (K10_D,), w, eps) for x in xs], 200)
               if has_lib else unfused)
        bnd, by = bound_ms((2 * n_rows + 1) * K10_D * 2, 4.0 * n_rows * K10_D, F32_OPS_PER_S)
        row = dict(rows=n_rows, d=K10_D, ms=kern, plain_ms=plain, unfused_ms=unfused,
                   library_ms=lib, library="F.rms_norm" if has_lib else "unfused rms_norm",
                   bound_ms=bnd, bound_by=by, launch_floor_ms=floor,
                   plan=kernels.norm_plan(n_rows, K10_D, torch.bfloat16, torch.bfloat16))
        rows.append(row)
        log(f"K10 rows={n_rows:3d}: kernel {kern:.5f} ms, plain {plain:.5f} ms, unfused "
            f"rms_norm {unfused:.5f} ms, {row['library']} {lib:.5f} ms, bound {bnd:.6f} ms, "
            f"launch floor {floor:.5f} ms")
        if n_rows == 4:
            record = row
    detail["k10"] = rows
    return {"max_abs_err": max_err, "bound_by": record["bound_by"],
            **{k: 65 * record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}


# ---------------------------------------------------------------- phase 5

LAB_SHAPE = dict(k=8192, n=7168, m=8, layers=24)
LAB_STEPS, LAB_REPS = 2, 2  # 96 timed launches of every variant
# The lab's nine kernels: (row, wrapper's name in the kernels line, the variant
# whose numbers the line takes, the TPU kernel it replaces).
LAB_KERNELS = (
    ("L2", "lab_i4_matmul", "i4native", "scripts/kernel_lab.py:762"),
    ("L3", "lab_bf16_dequant_matmul", "bf16dot", "scripts/kernel_lab.py:137"),
    ("L6", "lab_w4a8_matmul", "w4a8", "scripts/kernel_lab.py:497"),
    ("L7", "lab_w8a8_matmul", "w8a8", "scripts/kernel_lab.py:582"),
    ("L8", "lab_fulltk_matmul", "w8a8_fulltk", "scripts/kernel_lab.py:609"),
    ("L9", "lab_bitcast_i4_matmul", "bitcast_i4", "scripts/kernel_lab.py:278"),
    ("L10", "lab_bitcast_i4_i8dot", "bitcast_i4_i8dot", "scripts/kernel_lab.py:321"),
    ("L11", "lab_probe", "dma_only", "scripts/kernel_lab.py:245"),
    ("L12", "lab_w16_matmul", "w16dot", "scripts/kernel_lab.py:209"),
)
# x max|ref|, kernel against plain version at the lab's full shape. Both
# decode a weight to the same bits (the bf16 roundings of L3, L9 and L12
# included) and both take exact integer dots of the same xq, so they differ
# by the order of their f32 sums alone (split K, warps, FMA).
LAB_TOL = {"L2": K1_TOL["float32"], "L3": K1_TOL["float32"], "L9": K1_TOL["float32"],
           "L12": K1_TOL["float32"], "L6": 1e-5, "L7": 1e-5, "L8": 1e-5, "L10": 1e-5}
# The float rows' variants (L2, L3, L9, L12), which run the tensor-core
# decode form, by their mode (`lab_kernels._F_*`)
LAB_TC_MODES = {"i4native": "_F_I4", "bf16dot": "_F_Q4_BF16", "split_bf16_h": "_F_Q4_BF16_FMA",
                "bitcast_i4": "_F_I4", "bitcast_i4_bf16": "_F_I4_BF16", "w16dot": "_F_W16"}
# L11's probes that run probe modes of the float rows' tensor-core decode
# form (`lab_kernels.probe_plan`)
LAB_PROBE_TC = ("decode_only", "decode_bitcast", "dma_only")
# The integer rows (L6, L7, L8, L10), which run the int8 tensor-core decode
# form; the 32-row blocks of a scale group by the variant's hoist
LAB_I8_ROWS = ("L6", "L7", "L8", "L10")
LAB_I8_GROUP = {None: lambda tk: 1, "a8": lambda tk: 1, "a8full": lambda tk: tk // 32,
                "splitfull": lambda tk: tk // 32, "a8g128": lambda tk: 4}
# L11's column sums, x K * 8 * max|s| (the most a column's terms can add up
# to): the order of the f32 sums; the two byte-sum probes are exact
LAB_PROBE_TOL = {"decode_only": 1e-5, "decode_bitcast": 1e-5, "dma_only": 0.0,
                 "dma_pure": 0.0}


def _lab_tc_call(name: str, ops, leaf, tk: int, tm: int, k: int, n: int):
    """One call of a float or integer row's variant, whose wrapper runs the
    bf16 tensor-core decode form (`lab_plan`) or the int8 one
    (`lab_i8_plan`) and must count it. The memory its workspace and its
    output will take is filled with NaN first, so a partial or a column the
    kernel leaves unwritten shows."""
    import torch

    from llamago_tpu_torch import kernel_lab
    from llamago_tpu_torch.ops import lab_kernels as lk

    v = kernel_lab.VARIANTS[name]
    if v.row in LAB_I8_ROWS:
        ws = lk.lab_i8_plan(tm, k, n, LAB_I8_GROUP[v.hoist](tk))[2]
    elif name in LAB_PROBE_TC:
        ws = lk.probe_plan(k, n)[0] * n
    else:
        ws = lk.lab_plan(tm, k, n, getattr(lk, LAB_TC_MODES[name]))[1]
    dev = leaf["s"].device
    poison = [torch.full((ws,), float("nan"), device=dev),
              torch.full((tm, n), float("nan"), device=dev)]
    del poison
    fn = v.counter[0]
    before = fn.launches
    got = v.fn(ops, leaf, tk)
    if fn.launches != before + 1:
        raise AssertionError(f"lab {name}: its tensor-core decode form was not counted")
    return got


def check_lab(dev, detail: dict) -> dict:
    """Phase 5 (module docstring). Returns the kernels-line numbers of the
    lab's nine kernels by wrapper name; the launch counts are set to 0 just
    before the lab's run and read just after it."""
    import torch

    from llamago_tpu_torch import kernel_lab
    from llamago_tpu_torch.ops import lab_kernels as lk

    k, n, m, layers = (LAB_SHAPE[key] for key in ("k", "n", "m", "layers"))
    tk = lk.default_tk(k)
    new_rows = {row for row, *_ in LAB_KERNELS}
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((max(8, m), k), generator=gen, device=dev).to(torch.bfloat16)
    x[1, 64:96] = 0  # a zero block: sx = 1
    leaves = {fmt: kernel_lab.make_layers(fmt, k, n, 1, dev, seed=18)[0]
              for fmt in ("q4", "q8", "w16")}
    leaves["i4"] = lk.to_i4(leaves["q4"])

    # (a) the activation quantization, then every name of the nine rows
    xq, sx = lk.quantize_x_blocks_cuda(x)
    pq, ps = lk.hoist_a8(x)
    torch.cuda.synchronize()
    if not (torch.equal(sx, ps) and torch.equal(xq, pq.transpose(0, 1).reshape(xq.shape))):
        raise AssertionError("lab: xq / sx of the quantization kernel differ from hoist_a8")
    if sx[2, 1].item() != 1.0:
        raise AssertionError(f"lab: the zero block's scale is {sx[2, 1].item()}")
    log("lab: xq and sx of the quantization kernel bit-exact against the plain version")
    errs: dict[str, float] = {}
    for name, v in kernel_lab.VARIANTS.items():
        if v.row not in new_rows or v.counter is None:
            continue
        leaf = leaves[v.fmt]
        ops = kernel_lab.HOISTS[v.hoist](x, tk)
        before = getattr(*v.counter)
        tc = name in LAB_TC_MODES or name in LAB_PROBE_TC or v.row in LAB_I8_ROWS
        if tc:
            got = _lab_tc_call(name, ops, leaf, tk, max(8, m), k, n)
        else:
            got = v.fn(ops, leaf, tk)
        ref = v.plain(ops, leaf, tk)
        torch.cuda.synchronize()
        if getattr(*v.counter) != before + 1 or got.shape != (max(8, m), n) \
                or got.dtype != torch.float32 or not torch.isfinite(got).all():
            raise AssertionError(f"lab {name}: no launch counted, or a wrong or non-finite "
                                 "output")
        if v.row == "L11":
            scale = k * 8 * leaf["s"].float().abs().max().item()
            tol = LAB_PROBE_TOL[name]
        else:
            scale, tol = ref.abs().max().item(), LAB_TOL[v.row]
        err = (got - ref).abs().max().item() / scale
        if not err <= tol:
            raise AssertionError(f"lab {name} ({v.row}): max|d| / {scale:.3g} = {err:.3g} > "
                                 f"{tol}")
        errs[name] = err
        if tc and not torch.equal(_lab_tc_call(name, ops, leaf, tk, max(8, m), k, n), got):
            raise AssertionError(f"lab {name}: a second call into NaN-filled memory gave "
                                 "other bits")
        log(f"lab {name:28s} ({v.row}): kernel vs plain max|d|/scale {err:.2e} (tol {tol})")
    del leaves
    torch.cuda.empty_cache()

    # (b), (c) the lab itself, through its entry point's sweep; decode_bitcast
    # fails the lab's check by design and is timed all the same
    reset_launch_counts()
    result = kernel_lab.run(list(kernel_lab.VARIANTS), dev, k=k, n=n, m=m, layers=layers,
                            steps=LAB_STEPS, reps=LAB_REPS, time_dropped=True)
    if len(result["checked"]) != 19 or sorted(result["skipped"]) != sorted(
            kernel_lab.SKIP_CHECK) or list(result["dropped"]) != ["decode_bitcast"]:
        raise AssertionError(f"lab: the check passed {sorted(result['checked'])}, skipped "
                             f"{result['skipped']}, dropped {result['dropped']}; expected 19 "
                             "passes, the 12 of the skip list, and decode_bitcast dropped")
    timed_rows = {r["name"]: r for r in result["timed"]}
    by_fmt = result.pop("layers")  # the 24 layers of each weight format
    launches = launch_counts()
    over = {nm: r["bound_share"] for nm, r in timed_rows.items() if r["bound_share"] > 1.0}
    if len(timed_rows) != 32 or over:
        raise AssertionError(f"lab: {len(timed_rows)} names timed; readings above 100% of "
                             f"the bound: {over}")
    idle = [key for key in ("dequant_matmul", "dequant_matmul_q4", "dequant_matmul_so",
                            *(nm for _, nm, *_ in LAB_KERNELS)) if launches[key] == 0]
    if idle:
        raise AssertionError(f"lab: {idle} never launched in the lab's run: {launches}")

    # plain versions and the library yardstick at the same shape: x @ W on the
    # bf16 layers is one number for every product row; the byte probes are one
    # column sum each (of all the packed rows, of the corner of every span);
    # the two decode probes are no single call
    # its bound: the bf16 weights, x and the bf16 output once each. A
    # reading below it is no device time of the call (one run read 7.3 us
    # against 35.2): it is taken again, and a second one below fails the phase
    lib_bound = bound_ms(2 * k * n + 2 * x.shape[0] * (k + n), 2.0 * x.shape[0] * k * n)[0]
    lib_ms = timed([lambda w=w: x @ w["w16"] for w in by_fmt["w16"]], 4 * layers)
    if lib_ms < lib_bound:
        log(f"lab: x @ W read {lib_ms:.4f} ms, below its bound {lib_bound:.4f} ms: taken again")
        lib_ms = timed([lambda w=w: x @ w["w16"] for w in by_fmt["w16"]], 4 * layers)
        if lib_ms < lib_bound:
            raise AssertionError(f"lab: x @ W read {lib_ms:.4f} ms twice below its bound "
                                 f"{lib_bound:.4f} ms")
    detail["lab_library"] = {"ms": lib_ms, "bound_ms": lib_bound}
    lib_probe = {
        "decode_only": None, "decode_bitcast": None,
        "dma_only": timed([lambda w=w: w["q4"].sum(0, dtype=torch.float32)
                           for w in by_fmt["q4"]], 4 * layers),
        "dma_pure": timed([lambda w=w: w["q4"].view(k // tk, tk // 2, n)[:, :8].sum(
            (0, 1), dtype=torch.float32) for w in by_fmt["q4"]], 4 * layers)}
    for name, v in kernel_lab.VARIANTS.items():
        ops = kernel_lab.HOISTS[v.hoist](x, tk)
        row = timed_rows[name]
        row["plain_ms"] = timed([lambda w=w: v.plain(ops, w, tk) for w in by_fmt[v.fmt][:4]], 4)
        row["library_ms"] = lib_probe[name] if v.row == "L11" else lib_ms
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        log(f"lab {name:28s} ({v.row}): kernel {row['kernel_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library ({'x@W bf16' if v.row != 'L11' else 'sum'}) "
            f"{lib}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) = "
            f"{row['bound_share']:.1%}, other device {row['other_device_ms']:.4f} ms")
    del by_fmt
    torch.cuda.empty_cache()
    detail["lab"] = {"shape": {**LAB_SHAPE, "tk": tk, "steps": LAB_STEPS, "reps": LAB_REPS},
                     "checked": result["checked"], "skipped": result["skipped"],
                     "dropped": result["dropped"], "kernel_vs_plain": errs,
                     "launches": launches, "variants": list(timed_rows.values())}
    out = {}
    for row, wrapper, variant, replaces in LAB_KERNELS:
        r = timed_rows[variant]
        out[wrapper] = {
            "name": wrapper, "route": "cuda",
            "source": "llamago_tpu_torch/csrc/lab_matmul.cu", "replaces": replaces,
            "launches": launches[wrapper],
            "max_abs_err": max(e for nm, e in errs.items()
                               if kernel_lab.VARIANTS[nm].row == row),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
    return out


# ---------------------------------------------------------------- phase 3

def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_to_cpu(v) for v in tree)
    return tree.cpu()


# card (bf16 compute) against CPU (f32), x max|logit|: bf16 activations,
# norms and attention round at every layer. On an H100 this phase logs
# 9.7e-3 (t=1), 4.6e-2 (t=16) and 2.9e-2 (t=40); about twice the largest.
SMALL_BF16_LOGIT_TOL = 0.1


def check_small_model(dev) -> int:
    """A small Q8_0 GQA model with head_dim 128: logits through the kernels
    on the card against the plain versions on the CPU (f32 compute), and
    greedy tokens of a short engine run on both; with the dense cache, then
    the int8 cache under K4 and under K8 (LLAMAGO_ATTN_I8DOT off), then the
    dense cache with the prefill floor at 0 and USE_FUSED_NORM on (K7 and
    K10 must launch; the prompt fills a 64-token bucket), then the int8
    cache with bf16 scale planes (card and CPU under the same scale dtype);
    last, logits with bf16 compute on the card against the CPU's f32 ones,
    of the dense cache (K1's tensor-core tile takes the prefill windows,
    its decode form the decode step) and of the int8 cache under K8 (its
    tensor-core form, every call); and greedy speculative decoding in f32
    on the dense cache, whose stream must equal the card's plain greedy
    stream and the CPU's speculative one, and a speculative chunk whose
    history is planted with the greedy stream (`_planted_spec`: drafts land)
    on the card and the CPU. With f32 x every K1 call takes a form on x's
    three bf16 parts, in every f32 run: its decode form (f32_decode_tc)
    in decode steps and its tile (f32_tc) in the prefill windows; over the
    dense cache K2 and K7 (opt-in) take their f32 tensor-core forms.
    Returns the launches of K8 in its f32 run (its CUDA-core form: f32 q),
    of K1's f32_decode_tc and f32_tc forms in the dense cache's, and of K2
    and its and K7's f32 tensor-core forms over the dense cache's runs."""
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import GenerateConfig, ModelConfig
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.ops import attention, kernels
    from llamago_tpu_torch.runtime import kv_cache
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    dense = ModelConfig(vocab_size=4000, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                        multiple_of=256, max_seq_len=256, dtype="float32",
                        weight_dtype="int8")
    gpu = fuse_layer_weights(random_quantized_parameters(dense, seed=3, device=dev))
    # int8 weights with 0.01 scales give O(1) activations only with small scales
    for lp in gpu["layers"]:
        for leaf in ("wqkv", "wo", "w13", "w2"):
            lp[leaf]["s"] = torch.full_like(lp[leaf]["s"], 0.002)
    cpu = _to_cpu(gpu)
    toks = torch.randint(3, 4000, (2, 40), generator=torch.Generator().manual_seed(4))
    vocab = _byte_vocab(dense.vocab_size)
    gen = GenerateConfig(max_tokens=12, ctx_size=256, temp=0.0)
    int8 = dense.replace(kv_dtype="int8")
    default, k8_launches, k1_f32_decode_launches, k1_f32_tc_launches = (attention._I8DOT, 0,
                                                                        0, 0)
    # K2's and K7's f32 forms over the dense cache's runs
    f32_attn = dict.fromkeys(("flash_attention", "flash_attention_decode_f32tc",
                              "flash_attention_prefill_f32tc"), 0)
    floor, fused, scale_name = (attention._MIN_PREFILL_SCORES, kernels.USE_FUSED_NORM,
                                kv_cache._SCALE_DTYPE_NAME)
    # t=40: einsum-math prefill, or K7; t=16: K2/K4/K8 prefill bucket; t=1:
    # decode (K2, or K3 and K4/K8)
    for name, cfg, i8dot, opt_in, scales in (
            ("dense cache", dense, default, False, "float32"),
            ("int8 cache, K4", int8, True, False, "float32"),
            ("int8 cache, K8", int8, False, False, "float32"),
            ("dense cache, K7 and K10", dense, default, True, "float32"),
            ("int8 cache, K4, bf16 scales", int8, True, False, "bfloat16")):
        attention._I8DOT = i8dot
        attention._MIN_PREFILL_SCORES = 0 if opt_in else floor
        kernels.USE_FUSED_NORM = opt_in
        kv_cache._SCALE_DTYPE_NAME = scales
        reset_launch_counts()
        for t in (40, 16, 1):
            x = toks[:, :t]
            wp = torch.tensor([0, 7])
            lg, _ = forward_impl(gpu, x.to(dev), KVCache.create(cfg, batch=2, device=dev),
                                 wp.to(dev), cfg)
            lc, _ = forward_impl(cpu, x, KVCache.create(cfg, batch=2, device="cpu"), wp, cfg)
            lg = lg.cpu()
            if not torch.isfinite(lg).all():
                raise AssertionError(f"small model, {name}: non-finite logits on the card")
            err = (lg - lc).abs().max().item() / lc.abs().max().item()
            log(f"small model, {name}, t={t}: card vs CPU logits max|d|/max|ref| {err:.2e}")
            if not err <= 1e-3:
                raise AssertionError(f"small model, {name}, t={t}: logits differ, "
                                     f"{err:.3g} > 1e-3")
        outs = []
        prompt = "smoke test prompt" + (", long enough for a 64-token bucket" if opt_in
                                        else "")
        for params, d in ((gpu, dev), (cpu, "cpu")):
            eng = Engine(cfg, params, vocab, slots=2, decode_chunk_size=4, device=d)
            if scales == "bfloat16" and eng.cache.ks[0].dtype != torch.bfloat16:
                raise AssertionError(f"small model, {name}: the scale planes are "
                                     f"{eng.cache.ks[0].dtype}")
            outs.append(eng.generate(prompt, gen).output_tokens)
        log(f"small model, {name}, greedy tokens: card {outs[0]}, CPU {outs[1]}")
        if outs[0] != outs[1]:
            raise AssertionError(f"small model, {name}: greedy tokens differ between "
                                 "card and CPU")
        counts = launch_counts()
        log(f"small model, {name}: launches {counts}")
        if not i8dot:
            k8_launches = counts["flash_attention_quant_widening"]
            if k8_launches == 0 or counts["flash_attention_quant_widening_tc"] > 0:
                raise AssertionError(f"small model, {name}: f32 q must take K8's CUDA-core "
                                     f"form only: {counts}")
        if name == "dense cache":
            k1_f32_tc_launches = counts["dequant_matmul_f32_tc"]
            k1_f32_decode_launches = counts["dequant_matmul_f32_decode_tc"]
        if counts["dequant_matmul_f32_tc"] == 0 or counts["dequant_matmul_f32_decode_tc"] == 0 \
                or counts["dequant_matmul"] != counts["dequant_matmul_f32_tc"] \
                + counts["dequant_matmul_f32_decode_tc"]:
            raise AssertionError(f"small model, {name}: with f32 x every K1 call must take its "
                                 f"f32_decode_tc form (decode) or its f32_tc form (prefill), "
                                 f"no other: {counts}")
        if counts["flash_attention_decode_tc"] > 0 or (
                cfg.kv_dtype != "int8" and (
                    counts["flash_attention_decode_f32tc"] == 0
                    or counts["flash_attention"] != counts["flash_attention_decode_f32tc"])):
            raise AssertionError(f"small model, {name}: every K2 call over an f32 cache must "
                                 f"take its f32 tensor-core form: {counts}")
        if any((counts[k] > 0) != opt_in
               for k in ("flash_attention_prefill", "fused_rms_norm")) or \
                counts["flash_attention_prefill_tc"] > 0 or \
                counts["flash_attention_prefill_f32tc"] != counts["flash_attention_prefill"]:
            raise AssertionError(f"small model, {name}: K7 (its f32 tensor-core form) and K10 "
                                 f"must launch with the opt-in routes on and only then: "
                                 f"{counts}")
        if cfg.kv_dtype != "int8":
            for key in ("flash_attention", "flash_attention_decode_f32tc",
                        "flash_attention_prefill_f32tc"):
                f32_attn[key] += counts[key]
        if cfg.kv_dtype == "int8" and i8dot and (
                counts["cache_append_quant"] == 0
                or counts["flash_attention_quant_i8dot"] == 0):
            raise AssertionError(f"small model, {name}: K3 or K4 never launched: {counts}")
    attention._I8DOT = default
    attention._MIN_PREFILL_SCORES, kernels.USE_FUSED_NORM = floor, fused
    kv_cache._SCALE_DTYPE_NAME = scale_name
    # greedy speculative decoding in f32 (dense cache): the card's stream
    # equals the card's plain greedy stream and the CPU's speculative one
    reset_launch_counts()
    prompt = "spec check: abcabcabcabcabcabc"
    streams = {}
    for key, params, d, speculative in (("card, spec", gpu, dev, True),
                                        ("card, plain", gpu, dev, False),
                                        ("CPU, spec", cpu, "cpu", True)):
        eng = Engine(dense, params, vocab, slots=2, decode_chunk_size=4, device=d,
                     speculative=speculative, draft_len=SPEC_DRAFT)
        with spec_tally() as tally:
            streams[key] = eng.generate(prompt, GenerateConfig(max_tokens=24, ctx_size=256,
                                                               temp=0.0)).output_tokens
        if speculative and not tally["verify_steps"]:
            raise AssertionError(f"small model, {key}: no speculative step ran")
    log(f"small model, greedy speculative decoding in f32: {streams}")
    if not streams["card, spec"] == streams["card, plain"] == streams["CPU, spec"] \
            or len(streams["card, spec"]) != 24:
        raise AssertionError(f"small model: the speculative streams differ: {streams}")
    counts = launch_counts()
    if counts["flash_attention_decode_f32tc"] == 0 or counts["dequant_matmul_f32_tc"] == 0:
        raise AssertionError(f"small model, spec: K2's f32 form or K1's f32 tile never "
                             f"launched: {counts}")
    planted = {d: _planted_spec(params, dense, d, toks[:, :12])
               for d, params in ((dev, gpu), ("cpu", cpu))}
    log(f"small model, speculative chunk with a planted history, f32: card {planted[dev]}, "
        f"CPU {planted['cpu']}")
    if planted[dev] != planted["cpu"]:
        raise AssertionError("small model: the planted speculative chunks differ between "
                             "card and CPU")
    # bf16 compute on the card (dense cache) against the CPU's f32 logits:
    # the prefill windows (80 and 32 rows) take K1's tensor-core tile
    counts = _small_bf16_logits(dev, dense, gpu, cpu, toks, "small model")
    if counts["dequant_matmul_tc"] == 0 or counts["dequant_matmul_decode_tc"] == 0 \
            or counts["flash_attention_decode_tc"] == 0:
        raise AssertionError(f"small model, bf16: K1's tensor-core tile or decode form, or "
                             f"K2's tensor-core form never launched: {counts}")
    # the int8 cache under K8 in bf16 (its 16-row window and decode step;
    # the 40-row window takes the einsum math): the tensor-core form only
    attention._I8DOT = False
    try:
        counts = _small_bf16_logits(dev, int8, gpu, cpu, toks, "small model, int8 cache, K8")
    finally:
        attention._I8DOT = default
    if counts["flash_attention_quant_widening_tc"] == 0 or \
            counts["flash_attention_quant_widening"] != counts["flash_attention_quant_widening_tc"]:
        raise AssertionError(f"small model, int8 cache, K8, bf16: every K8 call must take its "
                             f"tensor-core form: {counts}")
    if k8_launches == 0:
        raise AssertionError("small model: K8 was never launched in its run")
    return k8_launches, k1_f32_decode_launches, k1_f32_tc_launches, f32_attn


def _planted_spec(params, cfg, dev, prompt) -> dict:
    """Drafts that land, on a random model: greedy decode of 2 slots from
    `prompt` [2, P] gives each slot's stream t_0..t_40; a speculative chunk
    of 4 steps (draft 7) from the same prefill then proposes from a
    history that holds [p_last, t_0..t_40] ahead of the prompt, so each
    step's drafts are the stream's next tokens. The emitted tokens must be
    the stream's, with drafts accepted (the acceptance path: several
    tokens a step, the history written at its length, positions advanced
    by the counts). Returns the counts and the emitted tokens of each
    slot."""
    import torch

    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.decode_loop import decode_chunk
    from llamago_tpu_torch.runtime.kv_cache import KVCache
    from llamago_tpu_torch.runtime.speculative import assemble_tokens, speculative_decode_chunk

    prompt = prompt.to(dev)
    b, p = prompt.shape
    zeros = torch.zeros(b, dtype=torch.long, device=dev)

    def prefilled():
        cache = KVCache.create(cfg, batch=b, device=dev)
        logits, cache = forward_impl(params, prompt, cache, zeros, cfg)
        return torch.argmax(logits, dim=-1), cache

    t0, cache = prefilled()
    rest, *_ = decode_chunk(params, t0, cache, zeros + p, cfg, 40)
    stream = torch.cat([t0[:, None], rest], dim=1)  # [2, 41]
    t0, cache = prefilled()
    seg = torch.cat([prompt[:, -1:], stream], dim=1)
    hist = torch.zeros((b, cfg.max_seq_len), dtype=torch.long, device=dev)
    n = seg.shape[1]
    hist[:, :n], hist[:, n:n + p], hist[:, n + p] = seg, prompt, t0
    toks, counts, _, pos, _, hlen = speculative_decode_chunk(
        params, t0, cache, zeros + p, hist, torch.full((b,), n + p + 1, device=dev), cfg,
        n_steps=4, draft_len=SPEC_DRAFT)
    out = {"counts": counts.tolist(), "emitted": []}
    for i in range(b):
        emitted = [int(t0[i])] + assemble_tokens(toks[i], counts[i])
        if emitted != stream[i, :len(emitted)].tolist() or int(counts[i].max()) < 2 \
                or int(pos[i]) != p + int(counts[i].sum()) \
                or int(hlen[i]) != n + p + 1 + int(counts[i].sum()):
            raise AssertionError(f"small model, planted speculative chunk on {dev}, slot {i}: "
                                 f"emitted {emitted}, stream {stream[i].tolist()}, counts "
                                 f"{counts[i].tolist()}, position {int(pos[i])}, history "
                                 f"length {int(hlen[i])}")
        out["emitted"].append(emitted)
    return out


def _small_bf16_logits(dev, cfg, gpu, cpu, toks, what: str) -> dict:
    """Logits of a 40-token window, a 16-token window and a decode step of
    a small model (dense cache) with bf16 compute on the card against f32
    compute on the CPU, within SMALL_BF16_LOGIT_TOL. Returns the launch
    counts of the card's runs."""
    import torch

    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    bf16, f32 = cfg.replace(dtype="bfloat16"), cfg.replace(dtype="float32")
    reset_launch_counts()
    for t in (40, 16, 1):
        x = toks[:, :t]
        wp = torch.tensor([0, 7])
        lg, _ = forward_impl(gpu, x.to(dev), KVCache.create(bf16, batch=2, device=dev),
                             wp.to(dev), bf16)
        lc, _ = forward_impl(cpu, x, KVCache.create(f32, batch=2, device="cpu"), wp, f32)
        lg = lg.float().cpu()
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{what}, bf16: non-finite logits on the card")
        err = (lg - lc).abs().max().item() / lc.abs().max().item()
        log(f"{what}, bf16 on the card, t={t}: vs CPU f32 logits max|d|/max|ref| {err:.2e}")
        if not err <= SMALL_BF16_LOGIT_TOL:
            raise AssertionError(f"{what}, bf16, t={t}: logits differ, "
                                 f"{err:.3g} > {SMALL_BF16_LOGIT_TOL}")
    counts = launch_counts()
    log(f"{what}, bf16: launches {counts}")
    if counts["dequant_matmul_f32_tc"] or counts["w4x8_matmul_f32_tc"] \
            or counts["dequant_matmul_so_f32_tc"]:
        raise AssertionError(f"{what}, bf16: the f32 x form ran on bf16 x: {counts}")
    return counts


INT4_LOGIT_TOL = {
    # card vs CPU, x max|logit|. K5 rounds activations to int8: where the
    # card's and the CPU's f32 sums leave an activation on either side of a
    # rounding boundary, one int8 step moves an output by sx * |w|, about
    # 1e-3 of a typical output at K=512, and later layers carry it on
    "w4x8": 5e-3,
    # f32 throughout: the order of the sums only, as for the Q8_0 model
    "q4_0": 1e-3,
    "q4_0, scale on output": 1e-3,
    "q4_0, scale on output at 256": 1e-3,
}


def check_small_model_int4(dev) -> dict:
    """A small GQA model with random int4 weights, card (kernels) against
    CPU (plain versions), f32 compute: logits for a 40-token window, a
    16-token window and a decode step, and greedy tokens of a short engine
    run; in the w4x8 format (K5 at decode, K6's tile on x's three bf16
    parts in prefill; w2, whose K = 1376 is no multiple of 128, stays Q4_0
    and takes K1 bits=4, its f32_tc form in prefill and its f32_decode_tc
    form at decode: the mixed tree), in the Q4_0 format (K1 bits=4:
    f32_decode_tc at decode, f32_tc in prefill), and in the Q4_0 format
    with the scale-on-output switch at 8 rows (K9 at decode: its decode
    form on f32 x's three bf16 parts) and at 256 (K9 in the prefill windows
    too: its tile on f32 x's three bf16 parts; K1 launches nothing). Every
    K1 call takes one of its two forms on x's parts, every K9 call one of
    its f32 forms. Then the w4x8 model's logits and those of the Q4_0 model
    with the switch at 8 and at 256 with bf16 compute on the card against
    the CPU's f32 ones,
    their layers' scales set to 0.002 as the dense model's are (the prefill
    windows, 80 and 32 rows, take K6's tensor-core tile, or K1's, or with
    the switch at 256 K9's; the decode step of the Q4_0 model K9's
    tensor-core decode form).
    Returns the launch counts of each run."""
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import GenerateConfig, ModelConfig
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    cfg = ModelConfig(vocab_size=4000, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=1376, max_seq_len=256, dtype="float32", weight_dtype="int4")
    toks = torch.randint(3, 4000, (2, 40), generator=torch.Generator().manual_seed(14))
    vocab = _byte_vocab(cfg.vocab_size)
    gen = GenerateConfig(max_tokens=12, ctx_size=256, temp=0.0)
    env, so_default = os.environ.get("LLAMAGO_INT4_EXEC"), kernels.SCALE_ON_OUTPUT_MAX_M
    counts = {}
    try:
        for name, fmt, so_max_m, must in (
                ("w4x8", "w4x8", 0, ("w4x8_matmul_a8", "w4x8_matmul_stream",
                                     "w4x8_matmul_f32_tc", "dequant_matmul_q4",
                                     "dequant_matmul_f32_tc", "dequant_matmul_f32_decode_tc")),
                ("q4_0", "q4_0", 0, ("dequant_matmul_q4", "dequant_matmul_f32_tc",
                                     "dequant_matmul_f32_decode_tc")),
                ("q4_0, scale on output", "q4_0", 8, ("dequant_matmul_so",
                                                      "dequant_matmul_so_f32_decode_tc",
                                                      "dequant_matmul_q4",
                                                      "dequant_matmul_f32_tc")),
                ("q4_0, scale on output at 256", "q4_0", 256,
                 ("dequant_matmul_so", "dequant_matmul_so_f32_decode_tc",
                  "dequant_matmul_so_f32_tc"))):
            os.environ["LLAMAGO_INT4_EXEC"] = fmt
            kernels.SCALE_ON_OUTPUT_MAX_M = so_max_m
            gpu = fuse_layer_weights(random_quantized_parameters(cfg, seed=13, device=dev))
            if ("q4x" in gpu["layers"][0]["wqkv"]) != (fmt == "w4x8") \
                    or "q4" not in gpu["layers"][0]["w2"]:
                raise AssertionError(f"small int4 model, {name}: unexpected leaf formats")
            cpu = _to_cpu(gpu)
            reset_launch_counts()
            for t in (40, 16, 1):
                x = toks[:, :t]
                wp = torch.tensor([0, 7])
                lg, _ = forward_impl(gpu, x.to(dev), KVCache.create(cfg, batch=2, device=dev),
                                     wp.to(dev), cfg)
                lc, _ = forward_impl(cpu, x, KVCache.create(cfg, batch=2, device="cpu"), wp,
                                     cfg)
                lg = lg.cpu()
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"small int4 model, {name}: non-finite logits")
                err = (lg - lc).abs().max().item() / lc.abs().max().item()
                log(f"small int4 model, {name}, t={t}: card vs CPU logits max|d|/max|ref| "
                    f"{err:.2e}")
                if not err <= INT4_LOGIT_TOL[name]:
                    raise AssertionError(f"small int4 model, {name}, t={t}: logits differ, "
                                         f"{err:.3g} > {INT4_LOGIT_TOL[name]}")
            outs = []
            for tree, d in ((gpu, dev), (cpu, "cpu")):
                eng = Engine(cfg, tree, vocab, slots=2, decode_chunk_size=4, device=d)
                outs.append(eng.generate("smoke test prompt", gen).output_tokens)
            log(f"small int4 model, {name}, greedy tokens: card {outs[0]}, CPU {outs[1]}")
            if outs[0] != outs[1]:
                raise AssertionError(f"small int4 model, {name}: greedy tokens differ "
                                     "between card and CPU")
            counts[name] = launch_counts()
            log(f"small int4 model, {name}: launches {counts[name]}")
            idle = [k for k in must if counts[name][k] == 0]
            c = counts[name]
            if idle or c["dequant_matmul"] > 0 or c["w4x8_matmul_tc"] > 0 \
                    or c["dequant_matmul_so_decode_tc"] > 0 or c["dequant_matmul_so_tc"] > 0 \
                    or c["w4x8_matmul_f32_tc"] != c["w4x8_matmul_stream"] \
                    or c["dequant_matmul_q4"] != c["dequant_matmul_f32_tc"] \
                    + c["dequant_matmul_f32_decode_tc"] \
                    or c["dequant_matmul_so"] != c["dequant_matmul_so_f32_decode_tc"] \
                    + c["dequant_matmul_so_f32_tc"] \
                    or (so_max_m > 8) != (c["dequant_matmul_so_f32_tc"] > 0) \
                    or (so_max_m > 8 and c["dequant_matmul_q4"] > 0):
                raise AssertionError(f"small int4 model, {name}: {idle} never launched, or "
                                     f"the Q8_0 kernel, K6's tile for bf16 x or K9's bf16 "
                                     f"forms did, or a K6 call took another form than "
                                     f"f32_tc, a K1 call another than f32_tc or "
                                     f"f32_decode_tc, a K9 call another than its f32 forms "
                                     f"(the tile only with the switch above 8, and then "
                                     f"no K1 call): {c}")
            if fmt == "w4x8" or so_max_m:
                # small scales, as for the dense model: with 0.01 bf16 rounding
                # alone moved this model's logits by 0.29 of max|logit| at
                # t=40 on an H100, its kernels within one rounding of their
                # plain versions
                for tree in (gpu, cpu):
                    for lp in tree["layers"]:
                        for leaf in ("wqkv", "wo", "w13", "w2"):
                            lp[leaf]["s"] = torch.full_like(lp[leaf]["s"], 0.002)
                bf = counts[f"{name}, bf16"] = _small_bf16_logits(
                    dev, cfg, gpu, cpu, toks, f"small int4 model, {name}")
                if fmt == "w4x8" and bf["w4x8_matmul_tc"] == 0:
                    raise AssertionError("small int4 model, w4x8, bf16: K6's tensor-core tile "
                                         f"never launched: {bf}")
                if so_max_m and (bf["dequant_matmul_so_decode_tc"] == 0 or
                                 bf["dequant_matmul_so"] != bf["dequant_matmul_so_decode_tc"]
                                 + bf["dequant_matmul_so_tc"] or
                                 (so_max_m > 8) != (bf["dequant_matmul_so_tc"] > 0)):
                    raise AssertionError(f"small int4 model, {name}, bf16: every K9 call must "
                                         f"take its tensor-core decode form, or above 8 rows "
                                         f"with the switch at 256 its tile: {bf}")
    finally:
        kernels.SCALE_ON_OUTPUT_MAX_M = so_default
        if env is None:
            os.environ.pop("LLAMAGO_INT4_EXEC", None)
        else:
            os.environ["LLAMAGO_INT4_EXEC"] = env
    return counts


# ---------------------------------------------------------------- phase 4

def _byte_vocab(vocab_size: int):
    """unk/bos/eos + 256 byte pieces + filler: byte fallback makes prompt
    length controllable and detokenization exact."""
    from llamago_tpu_torch.tokenizer import Vocab

    tokens = [(" ⁇ ".encode(), 0.0), (b"", 0.0), (b"", 0.0)]
    tokens += [(bytes([b]), -1000.0) for b in range(256)]
    tokens += [(f"<pad{i}>".encode(), -2000.0) for i in range(vocab_size - len(tokens))]
    return Vocab(tokens)


def _launch_counters():
    """(wrapper, attribute) holding each kernel's launch count, by name."""
    from llamago_tpu_torch.ops import launches

    return launches.counters()


def reset_launch_counts() -> None:
    from llamago_tpu_torch.ops import launches

    launches.reset()


def launch_counts() -> dict:
    from llamago_tpu_torch.ops import launches

    return launches.counts()


def make_7b_params(dev, weight_dtype: str = "int8", dtype: str = "bfloat16",
                   n_layers: int = 32):
    """Full-width, full-depth LLaMA-7B with random Q8_0 weights, or int4
    weights in the w4x8 format (seed 0), fused wqkv/w13, bf16 compute (or
    `dtype`'s: float32 is the --dtype float32 route)."""
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import MODEL_PRESETS

    cfg = MODEL_PRESETS["7B"].replace(weight_dtype=weight_dtype, dtype=dtype, n_layers=n_layers)
    env = os.environ.get("LLAMAGO_INT4_EXEC")
    os.environ["LLAMAGO_INT4_EXEC"] = "w4x8"
    t0 = time.time()
    try:
        params = fuse_layer_weights(random_quantized_parameters(cfg, seed=0, device=dev))
    finally:
        if env is None:
            del os.environ["LLAMAGO_INT4_EXEC"]
        else:
            os.environ["LLAMAGO_INT4_EXEC"] = env
    torch.cuda.synchronize()
    log(f"7B {weight_dtype} params ({dtype} compute) in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return cfg, params


@contextlib.contextmanager
def k8_k9_routes():
    """K8 and K9 on, as LLAMAGO_ATTN_I8DOT=0 and LLAMAGO_KERNEL_SO_MAX_M=256
    in the environment set them (switched as module attributes): the int8
    cache's attention takes K8, every matmul of at most 256 rows of a Q8_0 /
    Q4_0 leaf K9 (the decode steps its decode form, the prefill chunks its
    tile)."""
    from llamago_tpu_torch.ops import attention, kernels

    i8dot, so_max_m = attention._I8DOT, kernels.SCALE_ON_OUTPUT_MAX_M
    attention._I8DOT, kernels.SCALE_ON_OUTPUT_MAX_M = False, 256
    try:
        yield
    finally:
        attention._I8DOT, kernels.SCALE_ON_OUTPUT_MAX_M = i8dot, so_max_m


@contextlib.contextmanager
def opt_in_routes():
    """The port's two opt-in kernel routes on, as LLAMAGO_ATTN_PREFILL_FLOOR=0
    in the environment and ops.kernels.USE_FUSED_NORM = True set them: every
    prefill window of t > 32 takes K7, every RMSNorm K10."""
    from llamago_tpu_torch.ops import attention, kernels

    floor, fused = attention._MIN_PREFILL_SCORES, kernels.USE_FUSED_NORM
    attention._MIN_PREFILL_SCORES, kernels.USE_FUSED_NORM = 0, True
    try:
        yield
    finally:
        attention._MIN_PREFILL_SCORES, kernels.USE_FUSED_NORM = floor, fused


def _http_get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _http_jobs(port: int, bodies: list[dict], timeout_s: float = 600) -> list[dict]:
    """POST each job body to the job server on `port`, poll until every job
    has finished or failed, and return their records in `bodies`' order."""
    for body in bodies:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/jobs/",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            r.read()
    done, deadline = {}, time.time() + timeout_s
    while len(done) < len(bodies) and time.time() < deadline:
        time.sleep(0.05)
        for b in bodies:
            if b["id"] not in done and \
                    _http_get(port, f"/jobs/status/{b['id']}")["status"] in ("finished",
                                                                             "failed"):
                done[b["id"]] = _http_get(port, f"/jobs/{b['id']}")
    if len(done) < len(bodies):
        raise AssertionError(f"serve: {len(bodies) - len(done)} jobs did not finish")
    return [done[b["id"]] for b in bodies]


def serve(dev, cfg, params, slots: int, n_jobs: int, rise: tuple,
          long_jobs: int = 0, vocab=None, prompts: list[str] | None = None,
          model: str = "7B") -> dict:
    """Serve n_jobs sampled HTTP jobs on `slots` decode slots, then the
    repeated greedy job, then profile one decode chunk. Every launch count
    is set to 0 before the engine warms up; those named in `rise` must have
    risen by the end of the sampled jobs, every other one must still be 0.
    The first `long_jobs` odd-numbered jobs bring a prompt of 600 tokens
    (prefill chunks of 256, 256 and 88 tokens, the last in a 128 bucket);
    with any, a 256-token prefill chunk is profiled beside the 64-token
    one. `vocab` (default: the byte vocab) and `prompts` (default: 49
    tokens each under the byte vocab) serve a file's own tokenizer; the
    prompts' token counts are then those the vocab gives them."""
    import torch

    from llamago_tpu_torch.config import GenerateConfig, ServerConfig
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.server.api import JobServer
    from llamago_tpu_torch.tokenizer import tokenize

    predict, prompt_tokens, long_tokens, chunk = 64, 48, 600, 32
    vocab = vocab or _byte_vocab(cfg.vocab_size)
    engine = Engine(cfg, params, vocab, slots=slots,
                    decode_chunk_size=chunk, prefill_chunk=256, device=dev)
    gen = GenerateConfig(max_tokens=predict, ctx_size=cfg.max_seq_len, temp=0.8, seed=11)
    server = JobServer(engine, ServerConfig(host="127.0.0.1", port=0), gen,
                       model_name=f"{model}-{cfg.weight_dtype}")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    longest = min(long_tokens, engine.prefill_chunk) if long_jobs else prompt_tokens + 2
    warm_s = engine.warmup(max_bucket=engine._bucket(longest), include_embed=False)
    server.start_background()
    port = server.port
    try:
        if prompts is None:
            # one token per byte, plus BOS and the leading space
            lengths = [long_tokens if i % 2 and i // 2 < long_jobs else prompt_tokens + 1
                       for i in range(n_jobs)]
            prompts = [(f"request {i:03d}: " + "abcdefgh" * 80)[: n - 2]
                       for i, n in enumerate(lengths)]
        else:
            prefix = " " if getattr(vocab, "space_prefix", True) else ""
            lengths = [len(tokenize(vocab, prefix + p, bos=True)) for p in prompts]
        bodies = [{"id": str(uuid.uuid4()), "prompt": p, "seed": 11 + i}
                  for i, p in enumerate(prompts)]
        t_start = time.time()
        jobs = _http_jobs(port, bodies)
        t_total = time.time() - t_start
        metrics = _http_get(port, "/metrics")
        launches = launch_counts()
        failed = [j for j in jobs if j["status"] != "finished"]
        if failed:
            raise AssertionError(f"serve: {len(failed)} jobs failed: {failed[0].get('error')}")
        toks = [server.jobs[b["id"]].output_tokens for b in bodies]
        if [server.jobs[b["id"]].prompt_tokens for b in bodies] != lengths:
            raise AssertionError("serve: prompt token counts "
                                 f"{[server.jobs[b['id']].prompt_tokens for b in bodies]}")
        ttft = {n: statistics.median(server.jobs[b["id"]].ttft_ms
                                     for b, m in zip(bodies, lengths) if m == n)
                for n in sorted(set(lengths))}
        if any(len(t) != predict for t in toks):
            raise AssertionError(f"serve: token counts {[len(t) for t in toks]}")
        if any(not 0 <= x < cfg.vocab_size for t in toks for x in t):
            raise AssertionError("serve: a token id out of the vocabulary")
        if any((launches[k] > 0) != (k in rise) for k in launches):
            raise AssertionError(f"serve: launches {launches}; each of {rise} must rise "
                                 "and every other count stay 0")
        generated = metrics["generated_tokens"]

        # The greedy job runs twice into slot 0 with the same cache layout:
        # each run finds a slot whose history shares only BOS and the
        # leading space with it (the job F in between replaces the first
        # run's history), so both prefill the same rows in the same bucket.
        # A run that reused the first run's rows would prefill in other
        # chunks, and bf16 sums taken over other shapes may round apart.
        def greedy_job(prompt):
            body = {"id": str(uuid.uuid4()), "prompt": prompt, "temp": 0,
                    "max_tokens": 32}
            out = _http_jobs(port, [body])[0]
            return out["output"], server.jobs[body["id"]].output_tokens

        g_prompt = ("greedy check: " + "ijklmnop" * 40)[: prompt_tokens - 1]
        first = greedy_job(g_prompt)
        greedy_job(("flush: " + "qrstuvwx" * 40)[: prompt_tokens - 1])
        second = greedy_job(g_prompt)
        if first != second or len(first[1]) != 32:
            raise AssertionError(f"serve: the repeated greedy job gave different tokens: "
                                 f"{first[1]} vs {second[1]}")
    finally:
        server.shutdown()
    prefill = {t: profile_prefill(engine, t) for t in ((64, 256) if long_jobs else (64,))}
    step = profile_decode(engine, chunk)
    result = {
        "model": f"{model} {cfg.weight_dtype} (random, seed 0)", "kv_dtype": cfg.kv_dtype,
        "slots": slots, "jobs": n_jobs,
        "predict": predict, "prompt_tokens": lengths, "decode_chunk": chunk,
        "ttft_ms_p50_by_prompt_tokens": ttft,
        "warmup_s": warm_s, "served_tokens": generated, "seconds": t_total,
        "served_tokens_per_s": generated / t_total,
        "ttft_ms_p50": metrics["ttft_ms"]["p50"], "ttft_ms_p95": metrics["ttft_ms"]["p95"],
        "launches": launches, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "prefill_chunk": prefill, "decode_step": step,
    }
    log(f"{cfg.weight_dtype} weights, {cfg.kv_dtype} cache, {slots} slots: served "
        f"{generated} tokens in {t_total:.2f} s = "
        f"{result['served_tokens_per_s']:.1f} tok/s, TTFT p50 {result['ttft_ms_p50']} ms "
        f"p95 {result['ttft_ms_p95']} ms (p50 by prompt tokens {ttft}), peak {result['peak_gib']:.2f} GiB on the card, "
        f"launches {launches}")
    return result


@contextlib.contextmanager
def plans_seen():
    """Record every launch plan while open: (rows, form) of K1's and the
    w4x8 matmuls' ("k1", "w4x8"), (query rows t, form) of K2's and of K4's
    or K8's ("k2", "quant")."""
    from llamago_tpu_torch.ops import attention, kernels

    seen = {"k1": [], "w4x8": [], "k2": [], "quant": []}
    # (module, plan, key, the position of the rows among its arguments)
    plans = ((kernels, "k1_plan", "k1", 0), (kernels, "w4x8_plan", "w4x8", 0),
             (attention, "k2_plan", "k2", 3), (attention, "quant_plan", "quant", 3))
    originals = [getattr(mod, name) for mod, name, _, _ in plans]

    def recorded(plan, key, at):
        def call(*args):
            out = plan(*args)
            seen[key].append((args[at], out[0]))
            return out
        return call

    for (mod, name, key, at), plan in zip(plans, originals):
        setattr(mod, name, recorded(plan, key, at))
    try:
        yield seen
    finally:
        for (mod, name, _, _), plan in zip(plans, originals):
            setattr(mod, name, plan)


@contextlib.contextmanager
def plain_matmuls():
    """Every quantized matmul of the forward on its plain version (on the
    card's tensors), in the form the kernels' routing names: K5's for a
    w4x8 leaf up to `_W4X8_A8_MAX_M` rows, else K6's or K1's."""
    from llamago_tpu_torch.ops import kernels

    kernel = kernels.dequant_matmul

    def plain(x, w):
        if "q4x" in w:
            a8 = kernels.w4x8_form(x.numel() // x.shape[-1], x.dtype) == "a8"
            return (kernels.w4x8_matmul_a8_plain if a8 else kernels.w4x8_matmul_stream_plain)(x, w)
        return kernels.dequant_matmul_plain(x, w)

    kernels.dequant_matmul = plain
    try:
        yield
    finally:
        kernels.dequant_matmul = kernel


# f32 compute on the card, the kernels against the plain matmuls, x
# max|logit|: the same exact products with the f32 sums in another order
F32_LOGIT_TOL = 1e-3


@contextlib.contextmanager
def plain_attention():
    """Every K2 and K7 call of the forward on its plain version (on the
    card's tensors): the model's windows keep their routes."""
    import torch

    from llamago_tpu_torch.models import llama
    from llamago_tpu_torch.ops import attention

    kernel = llama.flash_attention

    def plain(q, k_cache, v_cache, positions):
        b, t, h, hd = q.shape
        q5 = q.reshape(b, t, k_cache.shape[1], h // k_cache.shape[1], hd)
        fn = (attention.flash_attention_plain if attention._LENAWARE and t <= attention.MAX_T
              else attention.flash_attention_prefill_plain)
        return fn(q5, k_cache, v_cache, positions[:, 0].to(torch.int32)).reshape(b, t, h * hd)

    llama.flash_attention = plain
    try:
        yield
    finally:
        llama.flash_attention = kernel


def _forward_vs_plain(dev, cfg, params, what: str, swaps) -> float:
    """One forward over a 64-token prompt through the kernels against the
    same forward with `swaps` (context managers of plain versions) on the
    card: max|d| / max|logit|, within F32_LOGIT_TOL."""
    import torch

    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    gen = torch.Generator().manual_seed(16)
    toks = torch.randint(3, 259, (1, 64), generator=gen).to(dev)
    logits = []
    for plain in (False, True):
        with contextlib.ExitStack() as stack:
            for swap in (swaps if plain else ()):
                stack.enter_context(swap())
            lg, _ = forward_impl(params, toks, KVCache.create(cfg, batch=1, device=dev),
                                 torch.zeros(1, dtype=torch.long, device=dev), cfg)
        logits.append(lg.float())
        torch.cuda.synchronize()
    if not torch.isfinite(logits[0]).all():
        raise AssertionError(f"serve, f32, {what}: non-finite logits")
    err = (logits[0] - logits[1]).abs().max().item() / logits[1].abs().max().item()
    log(f"serve, f32, {what}: 64-token forward, kernels vs "
        f"{' and '.join(s.__name__ for s in swaps)} on the card, max|d|/max|logit| {err:.2e}")
    if not err <= F32_LOGIT_TOL:
        raise AssertionError(f"serve, f32, {what}: logits differ, {err:.3g} > {F32_LOGIT_TOL}")
    return err


def serve_f32(dev, weight_dtype: str) -> dict:
    """Phase 4e: the --dtype float32 route end to end at full width. 7B
    (F32_ROUTE_LAYERS of its layers) with random weights (seed 0; Q8_0, or int4 as w4x8) and f32 compute,
    the f32 cache, 4 slots, 4 jobs of which one brings a 600-token prompt
    (256-token chunks): 0 failed jobs, in-vocabulary tokens, a repeated
    greedy job (`serve`); every K1 launch plan over 8 rows and every K6 one
    names f32_tc, every K1 plan of at most 8 rows (Q8_0) f32_decode_tc, and
    every such call is counted as its form; every K2 call takes
    its f32 tensor-core form; then one forward over a 64-token
    prompt with the kernels against the same forward with the plain
    matmuls swapped in on the card, within F32_LOGIT_TOL. `serve` profiles
    a 64- and a 256-token prefill chunk and a decode step. With Q8_0 the
    same runs again with the opt-in routes on (K7 and K10): every K7 call
    takes its f32 tensor-core form, the 600-token prompt's chunks among
    them, and the 64-token forward is held against the plain matmuls and
    plain attention; that run is under the "k7" key."""
    import torch

    from llamago_tpu_torch.ops import kernels

    cfg, params = make_7b_params(dev, weight_dtype, dtype="float32", n_layers=F32_ROUTE_LAYERS)
    int8 = weight_dtype == "int8"
    rise = (("dequant_matmul", "dequant_matmul_f32_tc", "dequant_matmul_f32_decode_tc")
            if int8 else
            ("w4x8_matmul_a8", "w4x8_matmul_stream", "w4x8_matmul_f32_tc")) + (
        "flash_attention", "flash_attention_decode_f32tc")
    with plans_seen() as seen:
        served = serve(dev, cfg, params, slots=4, n_jobs=4, rise=rise, long_jobs=1)
        counts = launch_counts()
    key, above, counter = (("k1", 8, "dequant_matmul_f32_tc") if int8 else
                           ("w4x8", max(8, kernels._W4X8_A8_MAX_M), "w4x8_matmul_f32_tc"))
    big = [form for m, form in seen[key] if m > above]
    if not big or any(form != "f32_tc" for form in big) or len(big) != counts[counter]:
        raise AssertionError(f"serve, f32, {weight_dtype}: {len(big)} plans over {above} rows, "
                             f"forms {sorted(set(big))}, {counts[counter]} counted as f32_tc")
    log(f"serve, f32, {weight_dtype}: every one of {len(big)} calls over {above} rows took "
        f"f32_tc")
    if int8:
        small = [form for m, form in seen["k1"] if m <= 8]
        if not small or any(form != "f32_decode_tc" for form in small) \
                or len(small) != counts["dequant_matmul_f32_decode_tc"] \
                or counts["dequant_matmul"] != len(big) + len(small):
            raise AssertionError(f"serve, f32, int8: {len(small)} K1 plans of at most 8 rows, "
                                 f"forms {sorted(set(small))}, "
                                 f"{counts['dequant_matmul_f32_decode_tc']} counted as "
                                 f"f32_decode_tc, {counts['dequant_matmul']} K1 calls")
        log(f"serve, f32, int8: every one of {len(small)} K1 calls of at most 8 rows took "
            f"f32_decode_tc")
        served["f32_decode_tc_calls"] = len(small)
    if counts["flash_attention_decode_f32tc"] != counts["flash_attention"]:
        raise AssertionError(f"serve, f32, {weight_dtype}: a K2 call over the f32 cache did not "
                             f"take its tensor-core form: {counts}")
    served["forward_64_vs_plain"] = _forward_vs_plain(dev, cfg, params, weight_dtype,
                                                      (plain_matmuls,))
    served["f32_tc_calls"] = len(big)
    if int8:
        gc.collect()
        torch.cuda.empty_cache()
        with opt_in_routes():
            k7 = serve(dev, cfg, params, slots=4, n_jobs=4, long_jobs=1,
                       rise=rise + ("flash_attention_prefill", "flash_attention_prefill_f32tc",
                                    "fused_rms_norm"))
            if k7["launches"]["flash_attention_prefill_f32tc"] != \
                    k7["launches"]["flash_attention_prefill"]:
                raise AssertionError(f"serve, f32, K7 on: a K7 call over the f32 cache did not "
                                     f"take its tensor-core form: {k7['launches']}")
            k7["forward_64_vs_plain"] = _forward_vs_plain(
                dev, cfg, params, f"{weight_dtype}, K7 and K10 on",
                (plain_matmuls, plain_attention))
        served["k7"] = k7
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return served


@contextlib.contextmanager
def plain_norm():
    """Every K10 call of the forward on its plain version (on the card's
    tensors)."""
    from llamago_tpu_torch.ops import kernels

    kernel = kernels.fused_rms_norm
    kernels.fused_rms_norm = kernels.fused_rms_norm_plain
    try:
        yield
    finally:
        kernels.fused_rms_norm = kernel


# speculative serving (phase 4f) at the CLI's default draft length
SPEC_DRAFT = 7
# a verify window's logits against the same positions decoded one token at
# a time on the same cache in bf16, x max|logit|: the window takes K1's tile
# (32 rows) and K2 at t = 8 where a step takes K1's decode form (4 rows) and
# K2 at t = 1, so the f32 sums run in another order and a layer's bf16
# roundings may land a step apart, which 32 layers of random weights carry
# on. On an H100 this pair differs by 3.3e-2, the same pair through the
# plain matmuls and attention (cuBLAS at 32 rows against 4) by 3.7e-2, and
# the window against the plain window by 4.3e-2, in every run: the floor
# of bf16 arithmetic lies above 1e-2. The bound sits just above those
# readings and holds both the window against the steps and the window
# against the plain window. The f32 pair is held to F32_LOGIT_TOL.
SPEC_WINDOW_TOL = 5e-2


@contextlib.contextmanager
def spec_tally():
    """Count the engines' speculative path while open: dispatches, verify
    steps (one a step for each active slot) and accepted drafts (the
    emitted tokens of a step less its bonus token). Warmup's chunks, which
    no dispatch makes, are not counted."""
    import torch

    from llamago_tpu_torch.runtime import speculative
    from llamago_tpu_torch.runtime.engine import Engine

    tally = {"dispatches": 0, "verify_steps": 0, "accepted_drafts": 0}
    chunk, decode = speculative.speculative_decode_chunk, Engine._decode_speculative
    active_rows: list = []

    def counted_decode(self, active, n_steps):
        active_rows.append(torch.as_tensor(active.nonzero()[0]))
        try:
            decode(self, active, n_steps)
        finally:
            active_rows.clear()

    def counted_chunk(*args, **kw):
        out = chunk(*args, **kw)
        if active_rows:
            counts = out[1].cpu()[active_rows[0]]  # [active slots, n_steps]
            tally["dispatches"] += 1
            tally["verify_steps"] += counts.numel()
            tally["accepted_drafts"] += int((counts - 1).sum())
        return out

    speculative.speculative_decode_chunk, Engine._decode_speculative = (counted_chunk,
                                                                        counted_decode)
    try:
        yield tally
    finally:
        speculative.speculative_decode_chunk, Engine._decode_speculative = chunk, decode


def _serve_greedy(dev, cfg, params, slots: int, prompts: list[str], speculative: bool,
                  rise: tuple, card: str) -> dict:
    """Serve one greedy HTTP job (temp 0, 64 tokens) a prompt on `slots`
    decode slots with decode chunks of 32, speculative or not. Every launch
    count is set to 0 before the engine warms up; those named in `rise` must
    have risen by the end, every other one must still be 0. Fails on a
    failed job, a job of another length than 64 tokens or a token outside
    the vocabulary, and with `speculative` when no verify step ran."""
    import torch

    from llamago_tpu_torch.config import GenerateConfig, ServerConfig
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.server.api import JobServer

    predict = 64
    engine = Engine(cfg, params, _byte_vocab(cfg.vocab_size), slots=slots,
                    decode_chunk_size=32, prefill_chunk=256, speculative=speculative,
                    draft_len=SPEC_DRAFT, device=dev)
    gen = GenerateConfig(max_tokens=predict, ctx_size=cfg.max_seq_len, temp=0.0)
    server = JobServer(engine, ServerConfig(host="127.0.0.1", port=0), gen,
                       model_name=f"7B-{cfg.weight_dtype}")
    reset_launch_counts()
    warm_s = engine.warmup(max_bucket=engine._bucket(max(len(p) for p in prompts) + 2),
                           include_embed=False)
    server.start_background()
    try:
        bodies = [{"id": str(uuid.uuid4()), "prompt": p, "temp": 0, "max_tokens": predict}
                  for p in prompts]
        with spec_tally() as tally, plans_seen() as seen:
            t0 = time.time()
            jobs = _http_jobs(server.port, bodies)
            secs = time.time() - t0
        metrics = _http_get(server.port, "/metrics")
        launches = launch_counts()
    finally:
        server.shutdown()
    what = (f"serve, spec: {cfg.kv_dtype} cache, {slots} slot(s), "
            f"{'--spec' if speculative else 'no --spec'}")
    failed = [j for j in jobs if j["status"] != "finished"]
    if failed:
        raise AssertionError(f"{what}: {len(failed)} jobs failed: {failed[0].get('error')}")
    toks = [server.jobs[b["id"]].output_tokens for b in bodies]
    # where a verify step's time goes (32 steps of 4 slots x 8 rows)
    step = profile_decode(engine, 32, speculative=True) if speculative and slots > 1 else {}
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    if any(len(t) != predict for t in toks) or \
            any(not 0 <= x < cfg.vocab_size for t in toks for x in t):
        raise AssertionError(f"{what}: token counts {[len(t) for t in toks]}, or a token "
                             "outside the vocabulary")
    if speculative and tally["verify_steps"] == 0:
        raise AssertionError(f"{what}: no verify step ran")
    if any((launches[k] > 0) != (k in rise) for k in launches):
        raise AssertionError(f"{what}: launches {launches}; each of {rise} must rise and "
                             "every other count stay 0")
    generated = metrics["generated_tokens"]
    out = {"slots": slots, "kv_dtype": cfg.kv_dtype, "speculative": speculative,
           "jobs": len(bodies), "predict": predict, "warmup_s": warm_s,
           "served_tokens": generated, "seconds": secs,
           "served_tokens_per_s": generated / secs,
           "ttft_ms_p50": metrics["ttft_ms"]["p50"], "ttft_ms_p95": metrics["ttft_ms"]["p95"],
           **tally, "accepted_drafts_per_verify_step":
               tally["accepted_drafts"] / max(tally["verify_steps"], 1),
           "launches": launches, "tokens": toks, "verify_step": step,
           "k1_rows_forms": sorted(set(seen["k1"]), key=str),
           "k2_windows": sorted(set(seen["k2"]), key=str),
           "quant_windows": sorted(set(seen["quant"]), key=str)}
    log(f"{what}: served {generated} tokens in {secs:.2f} s = "
        f"{out['served_tokens_per_s']:.1f} tok/s, TTFT p50 {out['ttft_ms_p50']} ms p95 "
        f"{out['ttft_ms_p95']} ms, {tally['verify_steps']} verify steps, "
        f"{tally['accepted_drafts']} accepted drafts "
        f"({out['accepted_drafts_per_verify_step']:.2f} a step) on {card}; launches {launches}")
    return out


def _window_and_steps(dev, cfg, params, feed=None) -> tuple:
    """After a 40-token prompt in each of 4 slots (the bf16 or f32 cache),
    8 greedy single steps from the prompt's greedy token t_last, then the
    verify window [t_last, g_1..g_7] of those steps' own tokens (drafts a
    verify step accepts in full where its argmaxes agree) in one forward
    over a copy of the same cache: the same inputs at the same positions.
    `feed` [4, 8], where given, replaces t_last, g_1..g_7 (another run's
    tokens). Returns the window's and the steps' logits [4, 8, V] in f32,
    the tokens fed [4, 8] and the launch plans of each (`plans_seen`)."""
    import torch

    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    b, plen, s = 4, 40, 256
    toks = torch.tensor([list((f"window {i}: " + "abcdefgh" * 8)[:plen].encode())
                         for i in range(b)], device=dev) + 3  # byte pieces start at 3
    cache = KVCache.create(cfg, batch=b, max_seq=s, device=dev)
    logits, cache = forward_impl(params, toks, cache, torch.zeros(b, dtype=torch.long,
                                                                  device=dev), cfg)
    copy = KVCache(k=[a.clone() for a in cache.k], v=[a.clone() for a in cache.v])
    pos = torch.full((b,), plen, dtype=torch.long, device=dev)
    fed, steps = [torch.argmax(logits, dim=-1) if feed is None else feed[:, 0]], []
    with plans_seen() as step_plans:
        for j in range(SPEC_DRAFT + 1):
            lg, _ = forward_impl(params, fed[-1][:, None], copy, pos + j, cfg)
            steps.append(lg.float())
            fed.append(torch.argmax(lg, dim=-1) if feed is None or j == SPEC_DRAFT
                       else feed[:, j + 1])
    seq = torch.stack(fed[:-1], dim=1)
    with plans_seen() as window_plans:
        window, _ = forward_impl(params, seq, cache, pos, cfg, return_all_logits=True)
    return window.float(), torch.stack(steps, dim=1), seq, window_plans, step_plans


def _logit_diff(a, b) -> float:
    return (a - b).abs().max().item() / b.abs().max().item()


def spec_window_vs_steps(dev, cfg, params) -> dict:
    """One verify window of 4 slots at 7B width against the same 8 tokens
    decoded one at a time on the same cache (`_window_and_steps`), in bf16
    and in f32 compute. The logits must agree within SPEC_WINDOW_TOL (bf16)
    or F32_LOGIT_TOL (f32) of max|logit|; in bf16 the same pair runs once
    more with the plain matmuls and attention on the card, the window must
    lie within SPEC_WINDOW_TOL of the plain window too, and the plain pair's
    difference is the noise floor of bf16 arithmetic over other shapes. The
    argmaxes must agree wherever the single steps' top-two gap is above the
    noise: the plain pair's difference in bf16, F32_LOGIT_TOL in f32 (a
    difference d moves the argmax only where the gap is under 2 d). The
    window must take K1's tile (32 rows; f32_tc in f32) and K2 at t = 8,
    the single steps K1's decode form and K2 at t = 1."""
    out = {}
    for dtype, tol in (("bfloat16", SPEC_WINDOW_TOL), ("float32", F32_LOGIT_TOL)):
        c = cfg.replace(dtype=dtype)
        f32 = dtype == "float32"
        window, steps, seq, window_plans, step_plans = _window_and_steps(dev, c, params)
        if not (window.isfinite().all() and steps.isfinite().all()):
            raise AssertionError(f"serve, spec, {dtype}: non-finite logits in the "
                                 "verify-window check")
        scale = steps.abs().max().item()
        err = _logit_diff(window, steps)
        row = {"max_abs_err_over_max_logit": err, "tolerance": tol}
        gap_tol, errs = tol, [err]
        if not f32:
            # the same tokens through the plain matmuls and attention
            with plain_matmuls(), plain_attention():
                p_window, p_steps, *_ = _window_and_steps(dev, c, params, feed=seq)
            gap_tol = _logit_diff(p_window, p_steps)
            row.update(plain_window_vs_plain_steps=gap_tol,
                       window_vs_plain_window=_logit_diff(window, p_window),
                       steps_vs_plain_steps=_logit_diff(steps, p_steps))
            errs.append(row["window_vs_plain_window"])
        top2 = steps.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]) / scale
        clear = gap > gap_tol
        agree = window.argmax(dim=-1) == steps.argmax(dim=-1)
        # drafts the window accepts: g_1..g_7 while its argmaxes agree
        accepted = agree[:, :-1].long().cumprod(dim=1).sum(dim=1)
        row.update(gap_tolerance=gap_tol, positions=agree.numel(),
                   clear_positions=int(clear.sum()), argmax_agree=int(agree.sum()),
                   argmax_disagree_where_clear=int((clear & ~agree).sum()),
                   gaps_where_argmax_differs=gap[~agree].tolist(),
                   accepted_drafts=accepted.tolist())
        log(f"serve, spec, {dtype}: verify window of 4 slots x 8 vs single steps on the "
            f"same cache: {row}")
        out[dtype] = row
        if not max(errs) <= tol or row["argmax_disagree_where_clear"]:
            raise AssertionError(f"serve, spec, {dtype}: the verify window's logits differ "
                                 f"from the single steps' or the plain window's: {row}")
        tile, dec = ("f32_tc", "f32_decode_tc") if f32 else ("tensor_core", "decode_tc")
        attn = "decode_f32tc" if f32 else "decode_tc"
        for plans, key, want in ((window_plans, "k1", (32, tile)),
                                 (window_plans, "k2", (8, attn)),
                                 (step_plans, "k1", (4, dec)),
                                 (step_plans, "k2", (1, attn))):
            if want not in plans[key]:
                raise AssertionError(f"serve, spec, {dtype}: {key} never planned {want}: "
                                     f"{plans[key]}")
    return out


def serve_spec(dev, cfg, params, card: str) -> dict:
    """Phase 4f: the REST server over 7B Q8_0 (the caller's parameters, bf16
    compute) with --spec --draft 7 and decode chunks of 32, greedy jobs of
    64 tokens whose prompts repeat their bytes: 8 jobs on 4 slots with the
    bf16 cache (K1's tile takes the 32-row verify windows and its decode
    form the restore forwards; K2 its t = 8 windows), 8 on 4 slots with
    the int8 cache (K4 its t = 8 windows, K3 the restore forwards' rows;
    the verify windows' rows are written by the plain quantize-and-write),
    then one job on 1 slot with --spec (K1's decode form takes the 8-row
    windows) and without it on the same prompt; last the verify-window
    check (`spec_window_vs_steps`)."""
    prompts = [(f"spec {i:03d}: " + "abcdefgh" * 8)[:46] for i in range(8)]  # 48 tokens
    k1 = ("dequant_matmul", "dequant_matmul_tc", "dequant_matmul_decode_tc")
    k2 = ("flash_attention", "flash_attention_decode_tc")
    k3k4 = ("cache_append_quant", "flash_attention_quant_i8dot",
            "flash_attention_quant_i8dot_tc")
    runs = {"4 slots, bf16 cache": _serve_greedy(dev, cfg, params, 4, prompts, True,
                                                 k1 + k2, card),
            "4 slots, int8 cache": _serve_greedy(dev, cfg.replace(kv_dtype="int8"), params,
                                                 4, prompts, True, k1 + k3k4, card)}
    one = ["one slot: " + "ijklmnop" * 5]
    runs["1 slot, --spec"] = _serve_greedy(dev, cfg, params, 1, one, True, k1 + k2, card)
    runs["1 slot, no --spec"] = _serve_greedy(dev, cfg, params, 1, one, False, k1 + k2, card)
    for name, run, key, want in (
            ("4 slots, bf16 cache", runs["4 slots, bf16 cache"], "k1_rows_forms",
             (32, "tensor_core")),
            ("4 slots, bf16 cache", runs["4 slots, bf16 cache"], "k2_windows",
             (8, "decode_tc")),
            ("4 slots, int8 cache", runs["4 slots, int8 cache"], "quant_windows",
             (8, "i8dot_tc")),
            ("1 slot, --spec", runs["1 slot, --spec"], "k1_rows_forms", (8, "decode_tc"))):
        if want not in run[key]:
            raise AssertionError(f"serve, spec, {name}: {key} {run[key]} lacks {want}")
    pair = (runs["1 slot, --spec"], runs["1 slot, no --spec"])
    log(f"serve, spec, 1 slot on {card}: {pair[0]['served_tokens_per_s']:.1f} tok/s with "
        f"--spec, {pair[1]['served_tokens_per_s']:.1f} without; the same tokens: "
        f"{pair[0]['tokens'] == pair[1]['tokens']}")
    runs["window"] = spec_window_vs_steps(dev, cfg, params)
    return runs


# perplexity (phase 4g): the mean NLL against the same run with every kernel
# on its plain version, relative to it. f32 compute: the kernels' products
# are exact (x as three bf16 parts; 3xTF32 in K7) and only the order of the
# f32 sums differs; bf16: a layer's bf16 roundings may land a step apart
PPL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The mean NLL hides a kernel that errs at the logits' own scale (random
# 7B weights give logits of hundreds and an NLL near 197 at every
# position), so the first window's logits are held position by position
# too, x max|logit|, against the same window through the plain versions.
# Random weights make a few positions ill-conditioned: on an H100 the plain
# versions over two chunks of 256 against one window of 512 (the same
# function in another order of sums) differ by up to 0.46 in bf16, by more
# than 6e-2 at two positions, and by up to 8.5e-3 in f32; the kernels
# against the plain window by up to 0.47 in bf16, and by at most 4.8e-2
# (bf16) or 7.7e-3 (f32) where the plain pair stays within the limit. So
# every position must lie within PPL_LOGIT_TOL, or within twice the plain
# pair's own difference there, and at most PPL_ILL_MAX positions may have
# a plain pair wider than PPL_LOGIT_TOL
PPL_LOGIT_TOL = {"float32": 1e-2, "bfloat16": 6e-2}
PPL_ILL_MAX = 5
PPL_CTX = 512


def _ppl_logits(params, cfg, ids, chunks: tuple):
    """The first window of `ids` through `forward_impl` as `perplexity`
    runs it (a fresh batch-1 cache of PPL_CTX slots), fed in `chunks` of
    tokens one after another on that cache: its logits [PPL_CTX, V] in
    f32."""
    import torch

    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    dev = params["tok_embeddings"].device
    win = torch.from_numpy(ids[:PPL_CTX][None, :]).to(dev)
    cache = KVCache.create(cfg, batch=1, max_seq=PPL_CTX, device=dev)
    out, pos = [], 0
    for n in chunks:
        logits, cache = forward_impl(params, win[:, pos:pos + n], cache,
                                     torch.full((1,), pos, dtype=torch.long, device=dev),
                                     cfg, return_all_logits=True)
        out.append(logits[0].float())
        pos += n
    return torch.cat(out)


def ppl_phase(dev, cfg, params, card: str) -> dict:
    """Phase 4g: `perplexity` over 2 windows of 512 token ids (numpy, seed
    0) at 7B Q8_0 (the caller's parameters) in bf16 and in f32 compute, on
    the default routes (K1's tile at m = 512, the einsum attention) and
    with the opt-in routes (K7 and K10 as well): each run's mean NLL within
    PPL_TOL of the same run with the plain matmuls, attention and norm on
    the card, and the first window's logits position by position within
    PPL_LOGIT_TOL of the same window through the plain versions, or within
    twice the plain versions' own difference there over two chunks of 256
    (at most PPL_ILL_MAX such positions); K1's tile (its f32_tc form in f32) must take the
    512-row windows, and K7 (its f32 form in f32) launch with the opt-in
    routes on and only then. Each run is made once to warm the card, then
    timed. Every run's readings are logged before a failed one raises."""
    import numpy as np
    import torch

    from llamago_tpu_torch.eval.perplexity import perplexity

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 2 * PPL_CTX)
    out, failed = {}, []
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dtype)
        f32 = dtype == "float32"
        tile = "f32_tc" if f32 else "tensor_core"
        for routes, opt_in in (("default routes", False), ("K7 and K10 on", True)):
            name = f"{dtype}, {routes}"
            rise = ("dequant_matmul", "dequant_matmul_f32_tc" if f32 else "dequant_matmul_tc")
            if opt_in:
                rise += ("flash_attention_prefill", "fused_rms_norm",
                         "flash_attention_prefill_f32tc" if f32
                         else "flash_attention_prefill_tc")
            with opt_in_routes() if opt_in else contextlib.nullcontext():
                perplexity(params, c, ids, ctx=PPL_CTX)  # warm
                reset_launch_counts()
                with plans_seen() as seen:
                    t0 = time.perf_counter()
                    got = perplexity(params, c, ids, ctx=PPL_CTX)
                    secs = time.perf_counter() - t0
                launches = launch_counts()
                kern = _ppl_logits(params, c, ids, (PPL_CTX,))
                with plain_matmuls(), plain_attention(), plain_norm():
                    plain = perplexity(params, c, ids, ctx=PPL_CTX)
                    ref = _ppl_logits(params, c, ids, (PPL_CTX,))
                    ref2 = _ppl_logits(params, c, ids, (PPL_CTX // 2,) * 2)
            rel = abs(got["nll"] - plain["nll"]) / abs(plain["nll"])
            scale, tol = ref.abs().max(), PPL_LOGIT_TOL[dtype]
            err = (kern - ref).abs().amax(dim=-1) / scale  # per position
            noise = (ref2 - ref).abs().amax(dim=-1) / scale
            over = err > torch.clamp(2 * noise, min=tol)
            ill = noise > tol
            finite = bool(np.isfinite(got["nll"]) and kern.isfinite().all().item())
            logits = {"max": err.max().item(), "max_where_plain_pair_within": (
                          err[~ill].max().item() if (~ill).any() else None),
                      "median": err.median().item(), "plain_pair_max": noise.max().item(),
                      "plain_pair_wider_positions": ill.nonzero()[:, 0].tolist(),
                      "over_positions": over.nonzero()[:, 0].tolist()}
            del kern, ref, ref2
            run = {**got, "plain_nll": plain["nll"], "rel_diff": rel, "logit_diff": logits,
                   "seconds_per_window": secs / got["n_windows"],
                   "tokens_per_s": got["n_windows"] * PPL_CTX / secs, "launches": launches}
            log(f"ppl, {name}: nll {got['nll']:.6f} (plain {plain['nll']:.6f}, relative "
                f"difference {rel:.2e}), window 0's logits x max|logit| against the plain "
                f"window {logits}, ppl {got['ppl']:.6g}, "
                f"{run['seconds_per_window'] * 1e3:.1f} ms a {PPL_CTX}-token window, "
                f"{run['tokens_per_s']:.0f} tokens/s on {card}; launches {launches}")
            if not (finite and rel <= PPL_TOL[dtype] and not logits["over_positions"]
                    and len(logits["plain_pair_wider_positions"]) <= PPL_ILL_MAX):
                failed.append(f"ppl, {name}: against the plain versions the mean nll "
                              f"{rel:.3g} (limit {PPL_TOL[dtype]}), window 0's logits "
                              f"{logits} (limit {tol}, or twice the plain pair; at most "
                              f"{PPL_ILL_MAX} positions with a plain pair wider than "
                              f"{tol}); finite: {finite}")
            if (PPL_CTX, tile) not in seen["k1"] or \
                    any(form != tile for m, form in seen["k1"] if m == PPL_CTX):
                raise AssertionError(f"ppl, {name}: K1's {PPL_CTX}-row plans {seen['k1']}")
            if any((launches[k] > 0) != (k in rise) for k in launches):
                raise AssertionError(f"ppl, {name}: launches {launches}; each of {rise} must "
                                     "rise and every other count stay 0")
            out[name] = run
    if failed:
        raise AssertionError("; ".join(failed))
    return out


# the attention kernels of a trace: attn_* (K2, K7) and the int8 cache's
# quant_partial / quant_partial_tc / widening_tc and their merge
# quant_merge (K4, K8; quant_combine in checkouts before the one merge)
ATTENTION_KERNELS = re.compile(
    r"(?:attn_|quant_partial|widening_tc|quant_merge|quant_combine)\w*")
# the matmul kernels of a trace: K1's dq_* (its forms, reduce and GEMV),
# K9's so_* (its decode forms, GEMV and reduce), K5's and K6's w4x8_*
MATMUL_KERNELS = re.compile(r"(?:dq_|so_(?:decode_tc|decode_f32tc|tc|reduce)|w4x8_)\w*")
# K10's and K3's kernels (rms_norm_onepass, append_warp; rms_norm_rows and
# append_quant in checkouts before them)
NORM_KERNELS = re.compile(r"rms_norm_\w+")
APPEND_KERNELS = re.compile(r"append_(?:warp|quant)\w*")


def _matmul_us(by_name: dict, prefill: bool = False) -> float:
    """Device time of the matmul kernels in a trace; in a prefill chunk
    without K5's activation quantization and W4A8 kernel (w4x8_quant_x,
    w4x8_a8), which run its decode steps."""
    return sum(v for k, v in by_name.items() if MATMUL_KERNELS.search(k) and not (
        prefill and ("w4x8_quant_x" in k or "w4x8_a8" in k)))


def _attention_us(by_name: dict) -> float:
    """Device time of the attention kernels in a trace."""
    return sum(v for k, v in by_name.items() if ATTENTION_KERNELS.search(k))


def _attention_names(by_name: dict) -> list[str]:
    """The attention kernels of a trace, by name (no namespace or template)."""
    return sorted({m.group(0) for k in by_name if (m := ATTENTION_KERNELS.search(k))})


def profile_prefill(engine, t: int, traced: int = 3) -> dict:
    """Where a prefill chunk's time goes, apart from the host noise of
    TTFT: one t-token prefill into slot 0 (bucket t), timed by the host
    clock (synchronized), then `traced` more under torch.profiler for the
    device busy time per chunk and the share of it that the route's matmul
    kernels take (MATMUL_KERNELS): K1's (named dq_*: the tensor-core tile,
    its reduce, the head's GEMV), K9's (so_*) or K6's (w4x8_*: the
    tensor-core tile and its reduce; K5's w4x8_quant_x and w4x8_a8 do not
    count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ids = [5] * t

    def run():
        engine._prefill(0, ids, write_pos=0)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            run()
    busy = device_busy_us(prof.events())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device activity")
    by_name = device_us_by_name(prof.events())
    mm = _matmul_us(by_name, prefill=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"tokens": t, "host_ms": host_ms, "device_busy_ms": busy / 1e3 / traced,
           "matmul_ms": mm / 1e3 / traced, "matmul_share_of_busy": mm / busy,
           "attention_ms": _attention_us(by_name) / 1e3 / traced,
           "top_kernels_ms": {k: v / 1e3 / traced for k, v in top}}
    log(f"prefill chunk of {t} tokens: {host_ms:.2f} ms host-timed, device busy "
        f"{out['device_busy_ms']:.3f} ms, matmul kernels {out['matmul_ms']:.3f} ms "
        f"({out['matmul_share_of_busy']:.1%} of busy), attention kernels "
        f"{out['attention_ms']:.3f} ms")
    for k, v in out["top_kernels_ms"].items():
        log(f"  device {v:8.3f} ms/chunk  {k[:100]}")
    return out


def profile_decode(engine, chunk: int, traced: int = 4, speculative: bool = False) -> dict:
    """Where a decode step's time goes: one greedy decode chunk of all
    slots, timed by the host clock (synchronized), then `traced` steps
    under torch.profiler for the device time per step, the kernels and
    host ops that take it, and the device-side operations (kernels, copies)
    and host op calls a step. The profiler's own host cost lengthens the
    traced window, so the device's busy share is taken against the
    untraced step time. With `speculative`, the steps are the engine's
    verify steps (`speculative_decode_chunk`: a forward over draft + 1
    tokens a slot, the proposals and the acceptance)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llamago_tpu_torch.runtime.decode_loop import decode_chunk
    from llamago_tpu_torch.runtime.speculative import speculative_decode_chunk

    n = engine.n_slots
    dev = engine.device
    tok = torch.full((n,), 7, dtype=torch.long, device=dev)
    pos = torch.full((n,), 100, dtype=torch.long, device=dev)
    hist = torch.zeros((n, engine.config.max_seq_len), dtype=torch.long, device=dev)
    hlen = torch.full((n,), 101, dtype=torch.long, device=dev)

    def run(steps):
        if speculative:
            speculative_decode_chunk(engine.params, tok, engine.cache, pos, hist, hlen,
                                     engine.config, n_steps=steps,
                                     draft_len=engine.draft_len)
        else:
            decode_chunk(engine.params, tok, engine.cache, pos, engine.config, steps)
        torch.cuda.synchronize()

    run(chunk)
    t0 = time.perf_counter()
    run(chunk)
    step_ms = (time.perf_counter() - t0) * 1e3 / chunk
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(traced)
        traced_ms = (time.perf_counter() - t0) * 1e3 / traced
    by_name: dict[str, float] = {}
    device_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            device_ops += 1
    busy = device_busy_us(prof.events())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device activity")
    device_ms = busy / 1e3 / traced
    # the decode matmuls: K1's dq_* (the decode form and its reduce), K9's
    # so_* or K5's w4x8_*
    mm_ms = _matmul_us(by_name) / 1e3 / traced
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:10]
    out = {"slots": n, "step_ms": step_ms, "traced_step_ms": traced_ms,
           "device_busy_ms": device_ms,
           "device_busy_share": device_ms / step_ms, "matmul_ms": mm_ms,
           "attention_ms": _attention_us(by_name) / 1e3 / traced,
           "attention_kernels": _attention_names(by_name),
           "matmul_kernels": sorted({m.group(0) for k in by_name
                                     if (m := MATMUL_KERNELS.search(k))}),
           "top_kernels_ms_per_step": {k: v / 1e3 / traced for k, v in top},
           "top_host_ops_ms_per_step": {a.key: a.self_cpu_time_total / 1e3 / traced
                                        for a in host},
           "host_op_calls_per_step": sum(a.count for a in prof.key_averages()) / traced,
           "device_kernels_per_step": device_ops / traced,
           "norm_ms": sum(v for k, v in by_name.items() if NORM_KERNELS.search(k)) / 1e3 / traced,
           "append_ms": sum(v for k, v in by_name.items()
                            if APPEND_KERNELS.search(k)) / 1e3 / traced}
    log(f"{'verify' if speculative else 'decode'} step ({n} slots): {step_ms:.2f} ms "
        f"host-timed, {traced_ms:.2f} ms traced, "
        f"device busy {device_ms:.3f} ms/step, matmul kernels {mm_ms:.3f} ms/step, "
        f"attention kernels {out['attention_ms']:.3f} ms/step, "
        f"{out['device_kernels_per_step']:.1f} device kernels and "
        f"{out['host_op_calls_per_step']:.1f} host op calls a step")
    for k, v in out["top_kernels_ms_per_step"].items():
        log(f"  device {v:8.3f} ms/step  {k[:100]}")
    for k, v in out["top_host_ops_ms_per_step"].items():
        log(f"  host   {v:8.3f} ms/step  {k[:100]}")
    return out


# ------------------------------------------------ phase 2 at LLaMA-3-8B


def _sdpa_gqa(qh, k, v, mask):
    """SDPA over a GQA cache: k and v [b, kv, s, hd] serve q [b, h, t, hd]."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, enable_gqa=True)


def _l3_attn_rows(dev, gen, name: str, c: dict, windows, timed_at, dtype: str, tol: float,
                  call, error, plain, make_cache, cache_bytes, deq, rate) -> list[dict]:
    """One attention kernel at a GQA geometry `c`: every (t, fill) of
    `windows` checked within `tol` (and its form asserted by `call`), those
    in `timed_at` timed beside the plain version, SDPA on `deq(cache)` with
    enable_gqa and the bound, then called again into NaN-filled memory for
    its first call's bits."""
    import torch

    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    h = kv * g
    dt = getattr(torch, dtype)
    copies = max(2, -(-150_000_000 // cache_bytes))
    caches = [make_cache() for _ in range(copies)]
    rows = []
    for t, fill in windows:
        q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(dt)
        positions = (torch.full((b, 1), max(fill - t, 0), device=dev)
                     + torch.arange(t, device=dev)[None, :])
        first = call(q, caches[0], positions)
        err = error(q, caches[0], positions, first)
        if not err <= tol:
            raise AssertionError(f"{name} t={t} fill={fill}: max|d| {err:.3g} > {tol}")
        row = dict(t=t, fill=fill, max_abs_err=err)
        if (t, fill) in timed_at:
            visible = min(max(fill, t), s)
            pos0 = positions[:, 0].to(torch.int32)
            q5 = q.reshape(b, t, kv, g, hd)
            kern = timed([lambda c_=c_: call(q, c_, positions, counted=False)
                          for c_ in caches], 50 * copies)
            plain_ms = timed([lambda c_=c_: plain(q5, c_, pos0) for c_ in caches], 2 * copies)
            qh = q.transpose(1, 2)
            mask = (None if t == 1 else
                    torch.arange(visible, device=dev)[None, :] <= positions[0][:, None])
            deqs = [deq(c_, visible) for c_ in caches]
            lib = timed([lambda d=d: _sdpa_gqa(qh, d[0], d[1], mask) for d in deqs],
                        50 * copies)
            del deqs
            if not torch.equal(call(q, caches[0], positions), first):
                raise AssertionError(f"{name} t={t} fill={fill}: a second call into NaN-filled "
                                     "memory gave other bits")
            per_slot = cache_bytes / (b * s)  # K and V bytes of one slot (scales included)
            nbytes = b * visible * per_slot + 2 * b * t * h * hd * q.element_size() + b * 4
            bnd, by = bound_ms(nbytes, 4.0 * b * h * t * visible * hd, rate)
            row.update(visible=visible, ms=kern, plain_ms=plain_ms, library_ms=lib,
                       bound_ms=bnd, bound_by=by)
            log(f"{name} t={t:2d} fill={fill:4d}: kernel {kern:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa (enable_gqa) {lib:.4f} ms, bound {bnd:.4f} ms ({by}), max|d| {err:.2e}")
        else:
            log(f"{name} t={t:2d} fill={fill:4d}: max|d| {err:.2e}")
        rows.append(row)
    del caches
    torch.cuda.empty_cache()
    return rows


def _step(rows: list[dict], s: int, layers: int = 32) -> dict:
    """The kernels line's numbers of an attention row set: one decode step
    at full fill (a call per layer) and the largest error."""
    rec = next(r for r in rows if r["t"] == 1 and r["fill"] == s and "ms" in r)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "bound_by": rec["bound_by"],
            **{k: layers * rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}


def check_llama3(dev, detail: dict) -> dict:
    """Phase 2 at LLaMA-3-8B's shapes, the ones phase 6 serves: K1 (Q8_0)
    at LLAMA3_SHAPES with bf16 x and f32 x, each checked within K1_TOL at m =
    1, 4, 8 (its decode form) and 9, 64 (its tile) and timed at m = 4 and
    64 (bf16 x against bf16 operations, f32 x against three bf16 passes),
    every call counted as the form `k1_form` names, into NaN-filled memory;
    K2 at L3_K2_SHAPE (g = 4, hd = 128) in bf16 (its tensor-core form)
    within K2_TOL and in f32 (its 3xTF32 form) within F32_ATTN_TOL; K3 at
    b = 8, KV = 8 on the serving path's GQA rows (v a strided view of the
    fused [q | k | v] projection, int64 positions), bit for bit, at fills
    101 and 1024; K4 at L3_K4_SHAPE in its tensor-core form within K4_TOL.
    The attention kernels are checked at t = 1 for fills 1, 101 and 1024
    (K2 also at its split's edges) and t = 8 and 32, timed at t = 1 for
    fills 101 and 1024 beside SDPA with enable_gqa. Returns the kernels
    line's numbers: K1's decode form and tile (bf16 x) and its tile with f32
    x, each one pass; K2 (bf16), K3 and K4, each one decode step at full
    fill."""
    import torch

    out = _k1_at(dev, detail, "llama3", LLAMA3_SHAPES, (41, 42), other_m=(1, 8, 9))
    gen = torch.Generator(device=dev).manual_seed(43)
    out.update(_gqa_k2(dev, gen, detail, "llama3", L3_K2_SHAPE))
    out["k4"] = _gqa_k4(dev, gen, detail, "llama3", L3_K4_SHAPE)
    out["k3"] = _gqa_k3(dev, gen, detail, "llama3", L3_K4_SHAPE, fused=True)
    return out


def _k1_at(dev, detail: dict, name: str, shapes: tuple, seeds: tuple, other_m: tuple) -> dict:
    """K1 (Q8_0) at `shapes` with bf16 x and f32 x, each checked within
    K1_TOL at `other_m` and at m = 4 (its decode form) and 64 (its tile),
    timed at m = 4 and 64 (bf16 x against bf16 operations, f32 x against
    three bf16 passes), every call counted as the form `k1_form` names,
    into NaN-filled memory. Returns the kernels line's numbers, each one
    pass of `shapes`: the decode form and the tile with bf16 x
    ("k1_decode", "k1_tile") and with f32 x ("k1_f32_decode",
    "k1_f32_tile")."""
    from llamago_tpu_torch.ops import kernels

    k1, k1_nan = _k1_checked()
    tag = f"K1 {name}"
    errs, steps = check_matmul(dev, detail, tag, "q8", k1, kernels.dequant_matmul_plain,
                               timed_m=(4, 64), other_m=other_m, shapes=shapes,
                               ops_per_s=lambda m: BF16_OPS_PER_S, seed=seeds[0],
                               other_shapes=tuple(n for n, *_ in shapes), checked=k1_nan)
    errs32, steps32 = check_matmul(dev, detail, f"{tag} f32", "q8", k1,
                                   kernels.dequant_matmul_plain, timed_m=(4, 64), other_m=(),
                                   shapes=shapes, ops_per_s=lambda m: F32_TC_OPS_PER_S,
                                   seed=seeds[1], timed_dtype="float32", checked=k1_nan)
    both = {key: max(errs.get(key, 0.0), errs32.get(key, 0.0)) for key in {*errs, *errs32}}
    for m, form in ((4, "the decode form"), (64, "the tile")):
        log(f"{tag} at m={m}: {form} {steps[m]['ms']:.3f} ms per pass (bf16 x; x@W "
            f"{steps[m]['library_ms']:.3f} ms, bound {steps[m]['bound_ms']:.3f} ms), "
            f"{steps32[m]['ms']:.3f} ms (f32 x; x@W f32 {steps32[m]['library_ms']:.3f} ms, "
            f"bound {steps32[m]['bound_ms']:.3f} ms)")
    return {"k1_decode": _line(errs, steps, 4, lambda m, xdt: m <= 8 and xdt == "bfloat16"),
            "k1_tile": _line(errs, steps, 64, lambda m, xdt: m > 8 and xdt == "bfloat16"),
            "k1_f32_decode": _line(both, steps32, 4, lambda m, xdt: m <= 8 and xdt == "float32"),
            "k1_f32_tile": _line(both, steps32, 64, lambda m, xdt: m > 8 and xdt == "float32")}


def _gqa_k2(dev, gen, detail: dict, name: str, c: dict, layers: int = 32) -> dict:
    """K2 at the geometry `c` in bf16 (its tensor-core form) within K2_TOL
    and in f32 (its 3xTF32 form) within F32_ATTN_TOL: checked at t = 1 for
    fills 1, 101, its split's edges and S, and at t = 8 and 32, timed at
    t = 1 for fills 101 and S beside SDPA with enable_gqa. Returns the
    kernels line's numbers of one decode step at full fill, "k2" (bf16)
    and "k2_f32"."""
    import torch

    from llamago_tpu_torch.ops import attention

    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    out = {}
    for dtype, tol, rate in (("bfloat16", K2_TOL, BF16_OPS_PER_S),
                             ("float32", F32_ATTN_TOL, TF32X3_OPS_PER_S)):
        dt = getattr(torch, dtype)
        sps = attention.decode_attn_plan(b, kv, 1, g, hd, s, dt)[0]
        windows = [(1, f) for f in sorted({1, 101, sps - 1, sps, sps + 1, s})]
        windows += [(8, 101), (8, s), (32, min(300, s)), (32, s)]

        def k2(q, cache, positions, counted=True):
            return (_k2_call if counted else attention.flash_attention)(q, *cache, positions)

        def k2_error(q, cache, positions, got):
            return _k2_error(q, *cache, positions, c, got)

        def k2_plain(q5, cache, pos0):
            return attention.flash_attention_plain(q5, *cache, pos0)

        rows = _l3_attn_rows(
            dev, gen, f"K2 {name} {dtype}", c, windows, {(1, 101), (1, s)}, dtype, tol, k2,
            k2_error, k2_plain,
            lambda: tuple(torch.randn((b, kv, s, hd), generator=gen, device=dev).to(dt)
                          for _ in range(2)),
            2 * b * kv * s * hd * dt.itemsize, lambda cache, vis: (cache[0][:, :, :vis],
                                                                   cache[1][:, :, :vis]), rate)
        detail[f"k2_{name.replace(' ', '_')}_{dtype}"] = rows
        out["k2" if dtype == "bfloat16" else "k2_f32"] = _step(rows, s, layers)
    return out


def _gqa_k4(dev, gen, detail: dict, name: str, c: dict, layers: int = 32) -> dict:
    """K4 at the geometry `c` in its tensor-core form within K4_TOL,
    checked at t = 1 for fills 1, 101 and S and at t = 8 and 32, timed at
    t = 1 for fills 101 and S beside SDPA on the dequantized cache. Returns
    the kernels line's numbers of one decode step at full fill."""
    import torch

    from llamago_tpu_torch.ops import attention

    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    plain4 = attention.flash_attention_quant_i8dot_plain

    def k4(q, cache, positions, counted=True):
        k8, ks, v8, vs = cache
        if counted:
            return _k4_call(q, k8, v8, positions, ks, vs)
        return attention.flash_attention_quant(q, k8, v8, positions, ks, vs)

    def k4_error(q, cache, positions, got):
        k8, ks, v8, vs = cache
        return _k4_error(q, k8, v8, positions, ks, vs, plain4, got)

    def k4_deq(cache, vis):
        k8, ks, v8, vs = cache
        return ((k8[:, :, :vis].float() * ks[:, :, :vis, None]).bfloat16(),
                (v8[:, :, :vis].float() * vs[:, :, :vis, None]).bfloat16())

    if attention.quant_plan(attention._I8DOT, b, kv, 1, g, hd, s, torch.bfloat16)[0] != "i8dot_tc":
        raise AssertionError(f"K4 {name}: the serving geometry does not take the tensor-core "
                             "form")
    rows = _l3_attn_rows(
        dev, gen, f"K4 {name}", c, [(1, 1), (1, 101), (1, s), (8, 101), (8, s), (32, s)],
        {(1, 101), (1, s)}, "bfloat16", K4_TOL, k4, k4_error,
        lambda q5, cache, pos0: plain4(q5, cache[0], cache[2], pos0, cache[1], cache[3]),
        lambda: (*_quant_cache(dev, gen, b, kv, s, hd), *_quant_cache(dev, gen, b, kv, s, hd)),
        2 * b * kv * s * (hd + 4), k4_deq, INT8_OPS_PER_S)
    detail[f"k4_{name.replace(' ', '_')}"] = rows
    return _step(rows, s, layers)


def _gqa_k3(dev, gen, detail: dict, name: str, c: dict, fused: bool,
            layers: int = 32) -> dict:
    """K3 at the geometry `c` (b slots, kv heads of hd, S positions), bit
    for bit against its plain version with bf16 and f32 rows at fills 101
    and S (int64 positions), then timed beside its bound and the launch
    floor. The new rows are laid out as the serving path makes them: v a
    strided view of the fused [q | k | v] projection (`fused`), or k and v
    each their own projection's output (unfused leaves, as under tp).
    Returns the kernels line's numbers of one decode step at full fill."""
    import torch

    from llamago_tpu_torch.ops import cache_write

    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    h = kv * g
    floor = launch_floor_ms()
    cache = [torch.randint(-127, 128, (b, kv, s, hd), generator=gen, dtype=torch.int8,
                           device=dev) for _ in range(2)]
    cache += [torch.rand((b, kv, s), generator=gen, device=dev) for _ in range(2)]

    def new_rows(dtype):
        if not fused:
            return [torch.randn((b, 1, kv * hd), generator=gen, device=dev).to(dtype)
                    .reshape(b, 1, kv, hd) for _ in range(2)]
        qkv = torch.randn((b, 1, (h + 2 * kv) * hd), generator=gen, device=dev).to(dtype)
        k = qkv[..., h * hd:(h + kv) * hd].reshape(b, 1, kv, hd).contiguous()
        return [k, qkv[..., (h + kv) * hd:].reshape(b, 1, kv, hd)]

    k3_rows = []
    for fill in (101, s):
        pos = torch.full((b,), fill - 1, dtype=torch.int64, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            new = new_rows(dtype)
            got, want = [a.clone() for a in cache], [a.clone() for a in cache]
            launches = cache_write.cache_append_quant.launches
            cache_write.cache_append_quant(*got, *new, pos)
            cache_write.cache_append_quant_plain(*want, *new, pos)
            torch.cuda.synchronize()
            if cache_write.cache_append_quant.launches != launches + 1 or \
                    not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"K3 {name} fill={fill} {dtype}: not bit-exact against "
                                     "the plain version, or no launch counted")
        new = new_rows(torch.bfloat16)
        kern = timed([lambda: cache_write.cache_append_quant(*cache, *new, pos)], 200)
        plain = timed([lambda: cache_write.cache_append_quant_plain(*cache, *new, pos)], 20)
        n = b * kv * hd
        bnd, by = bound_ms(2 * n * 2 + 8 * b + 2 * n + 2 * b * kv * 4, 4.0 * 2 * n,
                           F32_OPS_PER_S)
        k3_rows.append(dict(fill=fill, ms=kern, plain_ms=plain, library_ms=None, bound_ms=bnd,
                            bound_by=by, launch_floor_ms=floor))
        log(f"K3 {name} b={b} KV={kv} fill={fill}: bit-exact (bf16 and f32 rows), kernel "
            f"{kern:.5f} ms, plain {plain:.4f} ms, bound {bnd:.6f} ms, launch floor "
            f"{floor:.5f} ms")
    detail[f"k3_{name.replace(' ', '_')}"] = k3_rows
    row = k3_rows[-1]
    del cache
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "bound_by": row["bound_by"], "library_ms": None,
            **{k: layers * row[k] for k in ("ms", "plain_ms", "bound_ms")}}


# ---------------------------------------------------------------- phase 6

# random Q8_0 blocks of the full-width file: q uniform in [-127, 127],
# scales uniform in [0.005, 0.015) (the 7B phases' 0.01 on average)
GGUF_SCALE = (0.005, 0.01)


def learn_merges(text: str, n_merges: int) -> list[tuple[str, str]]:
    """Byte-level BPE merges learned from `text` (LLaMA-3's pre-tokenizer,
    GPT-2's byte alphabet): the most frequent adjacent pair first (ties by
    the pair's text), until `n_merges` or no pair occurs twice."""
    import collections

    from llamago_tpu_torch.tokenizer_bpe import bytes_to_unicode, split_llama3

    b2u = bytes_to_unicode()
    words = collections.Counter("".join(b2u[c] for c in w.encode()) for w in split_llama3(text))
    seqs, freq = [list(w) for w in words], list(words.values())
    pairs: collections.Counter = collections.Counter()
    where = collections.defaultdict(set)
    for i, sym in enumerate(seqs):
        for pair in zip(sym, sym[1:]):
            pairs[pair] += freq[i]
            where[pair].add(i)
    merges = []
    while len(merges) < n_merges and pairs:
        (a, b), count = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if count < 2:
            break
        merges.append((a, b))
        for i in where.pop((a, b), ()):
            sym, f = seqs[i], freq[i]
            for pair in zip(sym, sym[1:]):
                pairs[pair] -= f
                if pairs[pair] <= 0:
                    del pairs[pair]
            merged, j = [], 0
            while j < len(sym):
                if sym[j:j + 2] == [a, b]:
                    merged.append(a + b)
                    j += 2
                else:
                    merged.append(sym[j])
                    j += 1
            seqs[i] = merged
            for pair in zip(merged, merged[1:]):
                pairs[pair] += f
                where[pair].add(i)
        pairs.pop((a, b), None)
    return merges


def llama3_vocab(vocab_size: int = 128256):
    """LLaMA-3's vocabulary layout, built here: the 256 byte tokens, merges
    learned from the repository's README.md and SURVEY.md, reserved special
    tokens for the rest, <|begin_of_text|> = 128000 and <|end_of_text|> =
    128001 (bos and eos), the llama-bpe pre-tokenizer."""
    from llamago_tpu_torch.tokenizer_bpe import BPEVocab, bytes_to_unicode

    root = os.path.dirname(os.path.abspath(__file__))
    text = "".join(open(os.path.join(root, f), encoding="utf-8").read()
                   for f in ("README.md", "SURVEY.md"))
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    merges = {}
    for a, b in learn_merges(text, 4000):
        merges[(a, b)] = len(merges)
        if a + b not in tokens:
            tokens.append(a + b)
    regular = len(tokens)
    names = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>"}
    reserved = iter(range(vocab_size))
    tokens += [names.get(i) or f"<|reserved_special_token_{next(reserved)}|>"
               for i in range(regular, vocab_size)]
    return BPEVocab(tokens=tokens, merges=merges, bos_id=128000, eos_id=128001,
                    pattern="llama-bpe", special_ids=frozenset(range(regular, vocab_size)))


def bpe_prompt(vocab, i: int, n: int) -> str:
    """A prompt of README text that the vocab encodes (with bos) to n tokens."""
    from llamago_tpu_torch.tokenizer import tokenize

    root = os.path.dirname(os.path.abspath(__file__))
    text = open(os.path.join(root, "README.md"), encoding="utf-8").read()
    head = f"request {i:03d}: "
    for start in range(200 * i, len(text)):
        for end in range(start, len(text)):
            count = len(tokenize(vocab, head + text[start:end], bos=True))
            if count == n:
                return head + text[start:end]
            if count > n:
                break
    raise AssertionError(f"no slice of README.md encodes to {n} tokens")


def write_random_q8_gguf(dev, path: str, cfg, vocab, seed: int = 0) -> int:
    """A full-size Q8_0 GGUF of `cfg` written by write_gguf: every 2-D
    tensor random Q8_0 blocks (GGUF_SCALE) made on the card from one
    generator and copied to the host as blocks, never as floats; norm gains
    ones. Returns the file's bytes."""
    import numpy as np
    import torch

    from llamago_tpu_torch.checkpoint.gguf import write_gguf
    from llamago_tpu_torch.checkpoint.quant_file import QuantTensor

    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, width = GGUF_SCALE

    def blocks(out, k):
        nb = k // 32
        q = torch.randint(-127, 128, (out, nb, 32), generator=gen, dtype=torch.int8,
                          device=dev).view(torch.uint8)
        d = (torch.rand((out, nb, 1), generator=gen, device=dev) * width + lo).half()
        raw = torch.cat([d.view(torch.uint8), q], dim=2).reshape(out, nb * 34)
        return QuantTensor("q8_0", raw.cpu().numpy(), (out, k))

    d, f, v = cfg.dim, cfg.ffn_hidden, cfg.vocab_size
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    ones = np.ones(d, np.float32)
    tensors = {"tok_embeddings.weight": blocks(v, d), "norm.weight": ones,
               "output.weight": blocks(v, d)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        tensors |= {p + "attention_norm.weight": ones, p + "ffn_norm.weight": ones,
                    p + "attention.wq.weight": blocks(qd, d),
                    p + "attention.wk.weight": blocks(kvd, d),
                    p + "attention.wv.weight": blocks(kvd, d),
                    p + "attention.wo.weight": blocks(d, qd),
                    p + "feed_forward.w1.weight": blocks(f, d),
                    p + "feed_forward.w2.weight": blocks(d, f),
                    p + "feed_forward.w3.weight": blocks(f, d)}
    write_gguf(path, cfg, vocab, tensors)
    return os.path.getsize(path)


def _load(ckpt, cfg, dev):
    """A checkpoint's tensors as the CLI loads them: the device tree,
    unstacked and fused."""
    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        load_parameters,
        unstack_layer_params,
    )

    return fuse_layer_weights(unstack_layer_params(load_parameters(cfg, ckpt.tensors, device=dev),
                                                   cfg.n_layers))


@contextlib.contextmanager
def int4_exec(fmt: str):
    """LLAMAGO_INT4_EXEC=fmt while open (both devices read it at load)."""
    env = os.environ.get("LLAMAGO_INT4_EXEC")
    os.environ["LLAMAGO_INT4_EXEC"] = fmt
    try:
        yield
    finally:
        if env is None:
            del os.environ["LLAMAGO_INT4_EXEC"]
        else:
            os.environ["LLAMAGO_INT4_EXEC"] = env


def _file_card_vs_cpu(dev, path: str, what: str, tol: float) -> dict:
    """A model file read with read_checkpoint and loaded as the CLI loads
    it (f32 compute; a quantized file in its own weight format, a dense one
    in f32) on the card and on the CPU: logits of a 40-token window, a
    16-token window and a decode step within `tol` of max|logit|, greedy
    tokens of a short engine run equal. Returns the error, the tokens, the
    card's logits and the card's launch counts."""
    import torch

    from llamago_tpu_torch.checkpoint.gguf import read_checkpoint
    from llamago_tpu_torch.config import GenerateConfig
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    ckpt = read_checkpoint(path, max_seq_len=256)
    quantized = ckpt.ftype in (2, 3, 7)
    cfg = ckpt.config.replace(dtype="float32", max_seq_len=256,
                              weight_dtype=ckpt.config.weight_dtype if quantized else "float32")
    gpu, cpu = _load(ckpt, cfg, dev), _load(ckpt, cfg, "cpu")
    toks = torch.randint(3, min(cfg.vocab_size, 259), (2, 40),
                         generator=torch.Generator().manual_seed(44))
    reset_launch_counts()
    worst, card_logits = 0.0, []
    for t in (40, 16, 1):
        x, wp = toks[:, :t], torch.tensor([0, 7])
        lg, _ = forward_impl(gpu, x.to(dev), KVCache.create(cfg, batch=2, device=dev),
                             wp.to(dev), cfg)
        lc, _ = forward_impl(cpu, x, KVCache.create(cfg, batch=2, device="cpu"), wp, cfg)
        lg = lg.cpu()
        if not torch.isfinite(lg).all():
            raise AssertionError(f"gguf, {what}, t={t}: non-finite logits on the card")
        err = (lg - lc).abs().max().item() / lc.abs().max().item()
        log(f"gguf, {what}, t={t}: card vs CPU logits max|d|/max|ref| {err:.2e}")
        if not err <= tol:
            raise AssertionError(f"gguf, {what}, t={t}: logits differ, {err:.3g} > {tol}")
        worst = max(worst, err)
        card_logits.append(lg)
    gen = GenerateConfig(max_tokens=12, ctx_size=256, temp=0.0)
    outs = [Engine(cfg, params, ckpt.vocab, slots=2, decode_chunk_size=4, device=d)
            .generate("smoke test prompt", gen).output_tokens
            for params, d in ((gpu, dev), (cpu, "cpu"))]
    log(f"gguf, {what}, greedy tokens: card {outs[0]}, CPU {outs[1]}")
    if outs[0] != outs[1] or len(outs[0]) != 12:
        raise AssertionError(f"gguf, {what}: greedy tokens differ between card and CPU")
    counts = launch_counts()
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"logit_err": worst, "tokens": outs[0], "logits": card_logits, "launches": counts,
            "ftype": ckpt.ftype, "config": {k: getattr(ckpt.config, k) for k in (
                "vocab_size", "dim", "n_layers", "n_heads", "kv_heads", "ffn_hidden",
                "rope_theta", "weight_dtype")}}


def _cli(argv: list[str]) -> None:
    """The port's CLI in this process, its report on stderr."""
    from llamago_tpu_torch import cli

    with contextlib.redirect_stdout(sys.stderr):
        code = cli.main(argv + ["--silent"])
    if code != 0:
        raise AssertionError(f"llamago_tpu_torch.cli {' '.join(argv)} exited {code}")


def gguf_small_models(dev, tmp: str) -> dict:
    """Phase 6, step 1: the checkpoint tools on a small GQA model and a
    converted Meta directory. A dim-512 GQA model (4 heads, 2 kv heads of
    128, 2 layers, rope theta 500,000, a sentencepiece vocab) is written
    as an f32 ggjt by write_ggjt with its sidecar, then quantized by the
    port's `quantize` to q8_0, q4_0, q4_1 ggjt and a q8_0 .gguf. A Meta
    directory made here (params.json at dim 4096, 32 heads, 8 kv heads, 2
    layers, FFN 1024; consolidated.00.pth by torch.save; tokenizer.model
    by write_sp_model) is converted by `convert` to an f16 ggjt, which
    `quantize` takes to q8_0. Each output is read back and held card
    (kernels) against CPU (plain versions): logits within 1e-3 of
    max|logit| and equal greedy tokens, int4 files in their Q4_0 / Q4_1
    format (LLAMAGO_INT4_EXEC=q4_0). The q8_0 ggjt and the q8_0 GGUF must
    give bit-identical logits on the card."""
    import numpy as np
    import torch

    from llamago_tpu_torch.checkpoint.convert import vocab_from_sp_model
    from llamago_tpu_torch.checkpoint.ggjt import write_ggjt, write_meta_sidecar
    from llamago_tpu_torch.checkpoint.sp_model import (
        BYTE,
        CONTROL,
        NORMAL,
        UNKNOWN,
        SentencePiece,
        write_sp_model,
    )
    from llamago_tpu_torch.config import ModelConfig

    pieces = [SentencePiece("<unk>", 0.0, UNKNOWN), SentencePiece("<s>", 0.0, CONTROL),
              SentencePiece("</s>", 0.0, CONTROL)]
    pieces += [SentencePiece(f"<0x{b:02X}>", -1000.0, BYTE) for b in range(256)]
    pieces += [SentencePiece(w, -float(i), NORMAL)
               for i, w in enumerate(("▁smoke", "▁test", "▁prompt", "▁the", "st", "te"))]
    sp_path = os.path.join(tmp, "tokenizer.model")
    write_sp_model(sp_path, pieces)
    vocab = vocab_from_sp_model(sp_path)
    rng = np.random.default_rng(45)

    def tensors_of(d, h, kv, f, n_layers, scale):
        hd = d // h

        def mat(o, i):
            return (rng.standard_normal((o, i)) * scale).astype(np.float32)

        def gain():
            return (1 + rng.standard_normal(d) * 0.01).astype(np.float32)

        t = {"tok_embeddings.weight": mat(len(vocab), d), "norm.weight": gain(),
             "output.weight": mat(len(vocab), d)}
        for i in range(n_layers):
            p = f"layers.{i}."
            t |= {p + "attention_norm.weight": gain(), p + "ffn_norm.weight": gain(),
                  p + "attention.wq.weight": mat(h * hd, d),
                  p + "attention.wk.weight": mat(kv * hd, d),
                  p + "attention.wv.weight": mat(kv * hd, d),
                  p + "attention.wo.weight": mat(d, h * hd),
                  p + "feed_forward.w1.weight": mat(f, d), p + "feed_forward.w2.weight": mat(d, f),
                  p + "feed_forward.w3.weight": mat(f, d)}
        return t

    cfg = ModelConfig(vocab_size=len(vocab), dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=1024, max_seq_len=256, rope_theta=500000.0)
    f32 = os.path.join(tmp, "small-f32.bin")
    write_ggjt(f32, cfg, vocab, tensors_of(512, 4, 2, 1024, 2, 0.05))
    write_meta_sidecar(f32, cfg)
    files = {"f32 ggjt": f32}
    for kind, ext in (("q8_0", ".bin"), ("q4_0", ".bin"), ("q4_1", ".bin"), ("q8_0", ".gguf")):
        out = os.path.join(tmp, f"small-{kind}{ext}")
        _cli(["quantize", "--model", f32, "--out", out, "--qkind", kind])
        files[f"{kind} {'gguf' if ext == '.gguf' else 'ggjt'}"] = out
    meta = os.path.join(tmp, "meta", "8B")
    os.makedirs(meta)
    with open(os.path.join(meta, "params.json"), "w") as f:
        json.dump({"dim": 4096, "n_heads": 32, "n_kv_heads": 8, "n_layers": 2,
                   "multiple_of": 1024, "rope_theta": 500000.0, "norm_eps": 1e-5,
                   "vocab_size": -1}, f)
    write_sp_model(os.path.join(tmp, "meta", "tokenizer.model"), pieces)
    state = {k: torch.from_numpy(v) for k, v in tensors_of(4096, 32, 8, 1024, 2, 0.02).items()}
    state["rope.freqs"] = torch.ones(64)
    torch.save(state, os.path.join(meta, "consolidated.00.pth"))
    del state
    files["meta f16 ggjt"] = os.path.join(tmp, "meta-f16.bin")
    _cli(["convert", "--model", meta, "--out", files["meta f16 ggjt"]])
    files["meta q8_0 ggjt"] = os.path.join(tmp, "meta-q8_0.bin")
    _cli(["quantize", "--model", files["meta f16 ggjt"], "--out", files["meta q8_0 ggjt"],
          "--qkind", "q8_0"])
    out = {}
    with int4_exec("q4_0"):
        for what, path in files.items():
            out[what] = _file_card_vs_cpu(dev, path, what, 1e-3)
    want_ftype = {"f32 ggjt": 0, "q8_0 ggjt": 7, "q4_0 ggjt": 2, "q4_1 ggjt": 3,
                  "q8_0 gguf": 7, "meta f16 ggjt": 1, "meta q8_0 ggjt": 7}
    for what, run in out.items():
        if run["ftype"] != want_ftype[what]:
            raise AssertionError(f"gguf, {what}: ftype {run['ftype']}")
        n = run["launches"]
        k1 = n["dequant_matmul"] + n["dequant_matmul_q4"]
        if (k1 > 0) != (what.startswith(("q8_0", "q4_0", "meta q8_0"))) or \
                k1 != n["dequant_matmul_f32_tc"] + n["dequant_matmul_f32_decode_tc"] or \
                n["flash_attention_decode_f32tc"] == 0:
            raise AssertionError(f"gguf, {what}: K1 ({k1} launches) must run the Q8_0 / Q4_0 "
                                 f"files' matmuls only, each call in a form on f32 x's three "
                                 f"bf16 parts, and K2's f32 form every decode step: {n}")
        if what.startswith("meta") and run["config"]["kv_heads"] != 8:
            raise AssertionError(f"gguf, {what}: config {run['config']}")
    if out["q4_0 ggjt"]["launches"]["dequant_matmul_q4"] == 0:
        raise AssertionError("gguf, q4_0 ggjt: K1 bits=4 never launched")
    same = all(torch.equal(a, b) for a, b in zip(out["q8_0 ggjt"]["logits"],
                                                 out["q8_0 gguf"]["logits"]))
    log(f"gguf: the q8_0 ggjt and the q8_0 GGUF give bit-identical logits on the card: {same}")
    if not same or out["q8_0 ggjt"]["tokens"] != out["q8_0 gguf"]["tokens"]:
        raise AssertionError("gguf: the ggjt and GGUF copies of one model differ on the card")
    return {what: {k: v for k, v in run.items() if k != "logits"} for what, run in out.items()}


def gguf_phase(dev, card: str, phase4: dict | None = None) -> dict:
    """Phase 6: the checkpoint tools (gguf_small_models), then LLaMA-3-8B
    at full width (MODEL_PRESETS["llama3-8B"], GGUF_8B_LAYERS of its
    layers) from a Q8_0 GGUF:
    written by write_gguf (write_random_q8_gguf) with a byte-level BPE vocab
    of 128,256 entries built here (llama3_vocab) into a temporary
    directory, read by read_checkpoint and loaded to the card as the CLI
    loads it, served over the REST job API with the bf16 cache (4 slots, 8
    jobs) and the int8 cache (8 slots, 16 jobs), 49-token prompts that the
    vocab encodes, 64 tokens a job at temp 0.8, as phases 4 and 4b: 0 failed
    jobs, a repeated greedy job, K1's decode form and tile and K2 (K3 and K4
    on the int8 cache) launch and no other kernel; then the same file loaded
    with f32 compute, one 64-token forward through the kernels against the
    plain matmuls on the card within F32_LOGIT_TOL. The file is deleted at
    the end."""
    import tempfile

    import torch

    from llamago_tpu_torch.checkpoint.gguf import read_checkpoint
    from llamago_tpu_torch.config import MODEL_PRESETS

    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gguf_") as tmp:
        t0 = time.time()
        out["small"] = gguf_small_models(dev, tmp)
        log(f"gguf: the small models in {time.time() - t0:.1f} s")
        cfg = MODEL_PRESETS["llama3-8B"].replace(n_layers=GGUF_8B_LAYERS)
        t0 = time.time()
        vocab = llama3_vocab(cfg.vocab_size)
        out["vocab"] = {"entries": len(vocab), "merges": len(vocab.merges),
                        "specials": len(vocab.special_ids), "seconds": time.time() - t0}
        path = os.path.join(tmp, "llama3-8B-q8_0.gguf")
        t0 = time.time()
        out["file_bytes"] = write_random_q8_gguf(dev, path, cfg, vocab)
        out["write_s"] = time.time() - t0
        t0 = time.time()
        ckpt = read_checkpoint(path, max_seq_len=1024)
        out["read_s"] = time.time() - t0
        log(f"gguf: LLaMA-3-8B Q8_0 GGUF of {out['file_bytes']} bytes written in "
            f"{out['write_s']:.1f} s, read in {out['read_s']:.2f} s; vocab {out['vocab']}")
        c = ckpt.config
        if (c.vocab_size, c.dim, c.n_layers, c.n_heads, c.kv_heads, c.ffn_hidden, c.rope_theta,
                ckpt.ftype, type(ckpt.vocab).__name__, ckpt.vocab.pattern) != (
                128256, 4096, GGUF_8B_LAYERS, 32, 8, 14336, 500000.0, 7, "BPEVocab",
                "llama-bpe"):
            raise AssertionError(f"gguf: read back {c}, ftype {ckpt.ftype}")
        prompts = [bpe_prompt(ckpt.vocab, i, 49) for i in range(16)]
        cfg = c.replace(dtype="bfloat16", max_seq_len=1024)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = _load(ckpt, cfg, dev)
        torch.cuda.synchronize()
        out["load_s"] = time.time() - t0
        out["load_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"gguf: loaded to the card in {out['load_s']:.1f} s, peak "
            f"{out['load_peak_gib']:.2f} GiB")
        k1 = ("dequant_matmul", "dequant_matmul_tc", "dequant_matmul_decode_tc")
        out["bf16"] = serve(dev, cfg, params, slots=4, n_jobs=8, vocab=ckpt.vocab,
                            prompts=prompts[:8], model="llama3-8B",
                            rise=k1 + ("flash_attention", "flash_attention_decode_tc"))
        gc.collect()
        torch.cuda.empty_cache()
        out["int8"] = serve(dev, cfg.replace(kv_dtype="int8"), params, slots=8, n_jobs=16,
                            vocab=ckpt.vocab, prompts=prompts, model="llama3-8B",
                            rise=k1 + ("cache_append_quant", "flash_attention_quant_i8dot",
                                       "flash_attention_quant_i8dot_tc"))
        q = out["int8"]["launches"]
        if q["flash_attention_quant_i8dot_tc"] != q["flash_attention_quant_i8dot"]:
            raise AssertionError(f"gguf, int8 cache: a K4 call did not take its tensor-core "
                                 f"form: {q}")
        for key, run in (("bf16", out["bf16"]), ("int8", out["int8"])):
            step = run["decode_step"]
            ref = (phase4 or {}).get("decode_step", {})
            log(f"gguf, {key} cache: {run['served_tokens_per_s']:.1f} tok/s, TTFT p50 "
                f"{run['ttft_ms_p50']} ms p95 {run['ttft_ms_p95']} ms, peak "
                f"{run['peak_gib']:.2f} GiB; decode step: host {step['step_ms']:.2f} ms, "
                f"device busy {step['device_busy_ms']:.3f} ms, matmul {step['matmul_ms']:.3f} "
                f"ms, attention {step['attention_ms']:.3f} ms (phase 4, 7B: host "
                f"{ref.get('step_ms', float('nan')):.2f}, busy "
                f"{ref.get('device_busy_ms', float('nan')):.3f}, matmul "
                f"{ref.get('matmul_ms', float('nan')):.3f}, attention "
                f"{ref.get('attention_ms', float('nan')):.3f})")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # the same file with f32 compute: K1's f32 forms at LLaMA-3's shapes
        cfg32 = cfg.replace(dtype="float32")
        params = _load(ckpt, cfg32, dev)
        reset_launch_counts()
        out["f32_forward_64_vs_plain"] = _forward_vs_plain(dev, cfg32, params, "llama3-8B GGUF",
                                                           (plain_matmuls,))
        out["f32_launches"] = launch_counts()
        if out["f32_launches"]["dequant_matmul_f32_tc"] == 0:
            raise AssertionError(f"gguf, f32: K1's tile on f32 x never launched: "
                                 f"{out['f32_launches']}")
        del params, ckpt
        gc.collect()
        torch.cuda.empty_cache()
    if os.path.exists(path):
        raise AssertionError(f"gguf: {path} was not deleted")
    return out


# ------------------------------------------------------------------ main

# ---------------------------------------------------------------- phase 7: train

# the small model of phase 7a: GQA with head_dim 64 (K2 and K7 take it),
# every width a multiple of 128 (w4x8 takes every leaf)
TRAIN_SMALL = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                   ffn_dim=512, max_seq_len=128)
TRAIN_BASES = ("dense", "q8_0", "q4_0", "w4x8")
# (name, batch, tokens, K7 on): 8 rows of x at t = 8 take K1's decode form,
# K5 and K2; 128 rows at t = 64 with the prefill floor at 0 K1's tile, K6
# and K7
TRAIN_WINDOWS = (("K2", 1, 8, False), ("K7", 2, 64, True))
# f32 losses and gradients on the card against the plain versions on the
# card and on the CPU, x max|ref| of each tensor: exact products (three
# bf16 parts, 3xTF32) with the f32 sums in another order
TRAIN_F32_TOL = 1e-4
# bf16: gradients within twice the plain pair's own difference (plain bf16
# against plain f32); the loss, one mean whose pair difference may cancel
# to nothing, within that or PPL_TOL's bf16 limit on a mean NLL
TRAIN_BF16_LOSS_TOL = 1e-2
# the forms each base and dtype launch at 8 rows and at 128 rows of x
TRAIN_FORMS = {
    ("q8_0", "bfloat16"): ("dequant_matmul_decode_tc", "dequant_matmul_tc"),
    ("q8_0", "float32"): ("dequant_matmul_f32_decode_tc", "dequant_matmul_f32_tc"),
    ("q4_0", "bfloat16"): ("dequant_matmul_decode_tc", "dequant_matmul_tc"),
    ("q4_0", "float32"): ("dequant_matmul_f32_decode_tc", "dequant_matmul_f32_tc"),
    ("w4x8", "bfloat16"): ("w4x8_matmul_a8", "w4x8_matmul_tc"),
    ("w4x8", "float32"): ("w4x8_matmul_a8", "w4x8_matmul_f32_tc"),
}
TRAIN_ATTN_FORMS = {"bfloat16": ("flash_attention_decode_tc", "flash_attention_prefill_tc"),
                    "float32": ("flash_attention_decode_f32tc", "flash_attention_prefill_f32tc")}
# phase 7b: scripts/train_bench.py's 7B QLoRA step (batch 4, seq 512, rank
# 8, Q8_0 base from seed 0, bf16 compute, remat), one warm step and five
# timed on one batch; the plain comparison on the first 4 layers
TRAIN_7B = dict(batch=4, seq=512, rank=8, timed_steps=5, check_layers=4)


@contextlib.contextmanager
def k7_route():
    """Every window of t > 32 over the dense cache on K7, as
    LLAMAGO_ATTN_PREFILL_FLOOR=0 sets it (switched as a module attribute).
    K10 stays off: it has no backward."""
    from llamago_tpu_torch.ops import attention

    floor = attention._MIN_PREFILL_SCORES
    attention._MIN_PREFILL_SCORES = 0
    try:
        yield
    finally:
        attention._MIN_PREFILL_SCORES = floor


def _train_tensors(cfg, seed: int) -> dict:
    """Random checkpoint tensors of a small model ([out, in], numpy):
    matmuls normal * 0.05, norm gains near 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, f, hd = cfg.dim, cfg.ffn_hidden, cfg.head_dim

    def mat(o, i):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    def gain():
        return (1 + rng.standard_normal(d) * 0.01).astype(np.float32)

    t = {"tok_embeddings.weight": mat(cfg.vocab_size, d), "norm.weight": gain(),
         "output.weight": mat(cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        t |= {p + "attention_norm.weight": gain(), p + "ffn_norm.weight": gain(),
              p + "attention.wq.weight": mat(cfg.n_heads * hd, d),
              p + "attention.wk.weight": mat(cfg.kv_heads * hd, d),
              p + "attention.wv.weight": mat(cfg.kv_heads * hd, d),
              p + "attention.wo.weight": mat(d, cfg.n_heads * hd),
              p + "feed_forward.w1.weight": mat(f, d), p + "feed_forward.w2.weight": mat(d, f),
              p + "feed_forward.w3.weight": mat(f, d)}
    return t


def _train_small_params(dev, base: str, dtype: str):
    """(config, fused per-layer params) of phase 7a's model on `dev`:
    `base` weights (dense in the compute dtype, Q8_0, Q4_0 or w4x8) and
    `dtype` compute."""
    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        load_parameters,
        unstack_layer_params,
    )
    from llamago_tpu_torch.config import ModelConfig

    wdt = {"dense": dtype, "q8_0": "int8", "q4_0": "int4", "w4x8": "int4"}[base]
    cfg = ModelConfig(**TRAIN_SMALL, dtype=dtype, weight_dtype=wdt)
    with int4_exec("w4x8" if base == "w4x8" else "q4_0"):
        p = load_parameters(cfg, _train_tensors(cfg, 70), device=dev)
    return cfg, fuse_layer_weights(unstack_layer_params(p, cfg.n_layers))


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


def _lora_tree(params, rank: int = 8, b_seed: int = 71):
    """init_lora (seed 0) over `params`, each B drawn normal * 0.05 from a
    CPU generator seeded `b_seed`, the same on every device (B = 0 would
    leave A without a gradient)."""
    import torch

    from llamago_tpu_torch.models import lora

    tree = lora.init_lora(params, rank=rank, alpha=16.0, seed=0)
    gen = torch.Generator().manual_seed(b_seed)
    for lp in tree["layers"]:
        for leaf in lp.values():
            if lora.is_lora(leaf):
                leaf["lora_b"].copy_(torch.randn(leaf["lora_b"].shape, generator=gen) * 0.05)
    return tree


def _step_grads(tree, cfg, tokens, full: bool = False, first: str = "wqkv"):
    """One lora_train_step on a wrapped tree (with `full`, one full-weight
    train_step on a dense one): (its loss, every trained tensor's gradient
    in f32 on the CPU in tree order, the launch counts of the step, the
    largest |gradient| of layer 0's `first` leaf: its A, or with `full`
    the weight)."""
    import torch

    from llamago_tpu_torch.models import lora, training

    reset_launch_counts()
    if full:
        opt = training.make_optimizer(tree)
        tree, opt, loss = training.train_step(tree, opt, tokens, cfg)
        ts = training.trainable(tree)
    else:
        opt = lora.init_lora_opt_state(tree)
        tree, opt, loss = lora.lora_train_step(tree, opt, tokens, cfg)
        ts = lora.adapter_tensors(tree)
    if tokens.device.type == "cuda":
        torch.cuda.synchronize()
    leaf = tree["layers"][0][first]
    a0 = (leaf if full else leaf["lora_a"]).grad.abs().max().item()
    return float(loss), [t.grad.float().cpu() for t in ts], launch_counts(), a0


def _grad_err(got, ref) -> float:
    """The largest max|d| / max|ref| over the tensors of two gradient lists."""
    return max((g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
               for g, r in zip(got, ref, strict=True))


def train_small(dev) -> dict:
    """Phase 7a: one lora_train_step (rank 8, B random) of a small GQA model
    for each base (dense, Q8_0, Q4_0, w4x8), compute dtype (f32, bf16) and
    window (TRAIN_WINDOWS), and one full-weight train_step of the dense
    model: the loss and every A / B gradient (every parameter's for the
    full step) through the kernels on the card against the same step with
    the plain matmuls and plain attention on the card, and in f32 against
    the CPU: f32 within TRAIN_F32_TOL, bf16 within twice the plain pair's
    own difference (plain bf16 against plain f32). Layer 0's A on wqkv must
    get a non-zero gradient (the edge back through attention and the frozen
    matmuls); the window's forms must launch in the kernels' steps, and
    nothing in the plain steps. Returns the errors and launches by step."""
    import numpy as np
    import torch

    out, failed = {}, []
    for base in TRAIN_BASES:
        fulls = (False, True) if base == "dense" else (False,)
        for wname, b, t, k7 in TRAIN_WINDOWS:
            toks = torch.from_numpy(np.random.default_rng(72 + t).integers(
                3, TRAIN_SMALL["vocab_size"], (b, t)))
            runs = {}
            with k7_route() if k7 else contextlib.nullcontext():
                for dtype in ("float32", "bfloat16"):
                    cfg, params = _train_small_params(dev, base, dtype)
                    cpu = _to_cpu(params)
                    for full in fulls:
                        def tree(p, full=full):
                            return _clone_tree(p) if full else _lora_tree(p)
                        runs[dtype, full, "kernels"] = _step_grads(tree(params), cfg,
                                                                   toks.to(dev), full)
                        with plain_matmuls(), plain_attention():
                            runs[dtype, full, "plain"] = _step_grads(tree(params), cfg,
                                                                     toks.to(dev), full)
                        if dtype == "float32":
                            runs[dtype, full, "cpu"] = _step_grads(tree(cpu), cfg, toks, full)
                    del params, cpu
            for full in fulls:
                what = f"train, {base}, {wname} window, {'full-weight' if full else 'LoRA'} step"
                k32, p32, c32 = (runs["float32", full, w] for w in ("kernels", "plain", "cpu"))
                k16, p16 = (runs["bfloat16", full, w] for w in ("kernels", "plain"))
                errs = {"f32_vs_plain": _grad_err(k32[1], p32[1]),
                        "f32_vs_cpu": _grad_err(k32[1], c32[1]),
                        "f32_loss_vs_plain": abs(k32[0] - p32[0]) / abs(p32[0]),
                        "f32_loss_vs_cpu": abs(k32[0] - c32[0]) / abs(c32[0]),
                        "bf16_vs_plain": _grad_err(k16[1], p16[1]),
                        "bf16_plain_pair": _grad_err(p16[1], p32[1]),
                        "bf16_loss_vs_plain": abs(k16[0] - p16[0]) / abs(p16[0]),
                        "bf16_loss_plain_pair": abs(p16[0] - p32[0]) / abs(p32[0])}
                a0 = {dt: runs[dt, full, "kernels"][3] for dt in ("float32", "bfloat16")}
                launches = {dt: {k: v for k, v in runs[dt, full, "kernels"][2].items() if v}
                            for dt in ("float32", "bfloat16")}
                plain_launched = {dt: sum(runs[dt, full, "plain"][2].values())
                                  for dt in ("float32", "bfloat16")}
                log(f"{what}: loss f32 {k32[0]:.6f} (plain {p32[0]:.6f}, CPU {c32[0]:.6f}), "
                    f"bf16 {k16[0]:.6f} (plain {p16[0]:.6f}); x max|ref| {errs}; layer 0's "
                    f"wqkv {'A ' if not full else ''}gradient max {a0}; launches {launches}")
                if not (errs["f32_vs_plain"] <= TRAIN_F32_TOL
                        and errs["f32_vs_cpu"] <= TRAIN_F32_TOL
                        and errs["f32_loss_vs_plain"] <= TRAIN_F32_TOL
                        and errs["f32_loss_vs_cpu"] <= TRAIN_F32_TOL
                        and errs["bf16_vs_plain"] <= 2 * errs["bf16_plain_pair"]
                        and errs["bf16_loss_vs_plain"] <= max(2 * errs["bf16_loss_plain_pair"],
                                                              TRAIN_BF16_LOSS_TOL)
                        and np.isfinite([k32[0], k16[0]]).all()
                        and all(v > 0 for v in a0.values())):
                    failed.append(f"{what}: {errs}, layer 0's wqkv gradient max {a0}")
                for dt in ("float32", "bfloat16"):
                    want = (TRAIN_ATTN_FORMS[dt][int(k7)],)
                    if base != "dense":
                        want += (TRAIN_FORMS[base, dt][int(k7)],)
                    if base == "q4_0":
                        want += ("dequant_matmul_q4",)
                    if any(not launches[dt].get(k) for k in want) or plain_launched[dt]:
                        failed.append(f"{what}, {dt}: {want} must launch in the kernels' step "
                                      f"and nothing in the plain step: {launches[dt]}, "
                                      f"plain {plain_launched[dt]}")
                out[what] = {"errors": errs, "loss_f32": k32[0], "loss_bf16": k16[0],
                             "layer0_wqkv_grad_max": a0, "launches": launches}
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def train_7b(dev, card: str) -> dict:
    """Phase 7b: the 7B QLoRA step at full width and depth
    (MODEL_PRESETS["7B"], random Q8_0 base from seed 0, unfused as
    scripts/train_bench.py builds it, bf16 compute, adapters of rank 8 on
    wq, wk, wv and wo, remat on) on one batch of 4 x 512 tokens (numpy,
    seed 0): one warm step, five timed (ms per step, train tokens/s, the
    loss of each step: finite and falling on the repeated batch, peak
    device memory), one step under torch.profiler (device busy, K1's
    kernels (`matmul_ms`: its tile at m = 2048), the backward's dequantize
    + matmul (the device time under FrozenQuantMatmul's span)); then one
    step with f32 compute (K1's f32_tc at m = 2048). Then the first 4
    layers, their block scales set to keep the activations O(1): one step
    (B random) through the kernels against the plain matmuls on the card,
    bf16 within twice the plain pair's own difference and f32 within
    TRAIN_F32_TOL, loss and layer-0 gradients."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llamago_tpu_torch.checkpoint.params import random_quantized_parameters
    from llamago_tpu_torch.config import MODEL_PRESETS
    from llamago_tpu_torch.models import lora
    from llamago_tpu_torch.ops import kernels

    c = TRAIN_7B
    cfg = MODEL_PRESETS["7B"].replace(weight_dtype="int8", dtype="bfloat16",
                                      max_seq_len=c["seq"])
    t0 = time.time()
    params = random_quantized_parameters(cfg, seed=0, layered=True, device=dev)
    torch.cuda.synchronize()
    log(f"train, 7B: Q8_0 base in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (c["batch"], c["seq"]))).to(dev)
    tree = lora.init_lora(params, rank=c["rank"], alpha=16.0, seed=0)
    opt = lora.init_lora_opt_state(tree)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = []

    def step():
        nonlocal tree, opt
        tree, opt, loss = lora.lora_train_step(tree, opt, tokens, cfg)
        losses.append(loss)

    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(c["timed_steps"]):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / c["timed_steps"]
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a trace can lose events (utils/timing.profiled): take the step again
    # until the trace holds every K1 launch the counters saw
    for attempt in range(4):
        before = kernels.dequant_matmul.launches_tc
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.events()
        held = sum(e.device_type == torch.autograd.DeviceType.CUDA and "dq_tc" in e.name
                   for e in events)
        if held == kernels.dequant_matmul.launches_tc - before:
            break
        log(f"train, 7B: the trace holds {held} of the step's "
            f"{kernels.dequant_matmul.launches_tc - before} K1 launches (attempt {attempt + 1})")
    else:
        raise AssertionError("train, 7B: the profiler lost events of every traced step")
    device = [e for e in events if e.name != kernels.BACKWARD_SPAN]
    busy = device_busy_us(device) / 1e3
    by_name = device_us_by_name(device)
    bwd = sum(e.device_time_total for e in events if e.name == kernels.BACKWARD_SPAN
              and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    losses = [float(x) for x in losses]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"config": "7B Q8_0 (random, seed 0), bf16, LoRA rank 8 on wq/wk/wv/wo, remat",
           "batch": c["batch"], "seq": c["seq"], "warm_step_s": warm_s, "ms_per_step": ms,
           "train_tokens_per_s": c["batch"] * c["seq"] / ms * 1e3, "peak_gib": peak,
           "losses": losses, "device_busy_ms": busy, "device_busy_share": busy / ms,
           "matmul_ms": _matmul_us(by_name, prefill=True) / 1e3,
           "backward_dequant_matmul_ms": bwd, "launches": launches,
           "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}}
    log(f"train, 7B QLoRA step on {card}: {ms:.1f} ms a step "
        f"({out['train_tokens_per_s']:.0f} train tokens/s), warm step {warm_s:.1f} s, peak "
        f"{peak:.2f} GiB, losses {losses}; profiled step: device busy {busy:.1f} ms "
        f"({out['device_busy_share']:.1%} of the step), K1 {out['matmul_ms']:.1f} ms, the "
        f"backward's dequantize + matmul {bwd:.1f} ms; launches {launches}")
    for k, v in out["top_kernels_ms"].items():
        log(f"  device {v:8.3f} ms/step  {k}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train, 7B: the losses on the repeated batch {losses} must be "
                             "finite and fall")
    if not launches["dequant_matmul_tc"] or launches["dequant_matmul_f32_tc"] or \
            not bwd > 0:
        raise AssertionError(f"train, 7B: K1's tile must take the step's matmuls and the "
                             f"backward's span hold device time ({bwd} ms): {launches}")

    # one step with f32 compute: K1's tile on x's three bf16 parts
    f32 = cfg.replace(dtype="float32")
    tree32 = lora.init_lora(params, rank=c["rank"], alpha=16.0, seed=0)
    opt32 = lora.init_lora_opt_state(tree32)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree32, opt32, loss32 = lora.lora_train_step(tree32, opt32, tokens, f32)
    torch.cuda.synchronize()
    out["f32_step"] = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss32),
                       "launches": launch_counts()}
    log(f"train, 7B QLoRA step, f32 compute: {out['f32_step']['ms']:.1f} ms, loss "
        f"{float(loss32):.6f}, launches {out['f32_step']['launches']}")
    if not (np.isfinite(float(loss32)) and out["f32_step"]["launches"]["dequant_matmul_f32_tc"]):
        raise AssertionError(f"train, 7B, f32: {out['f32_step']}")
    del tree32, opt32, tree, opt
    gc.collect()
    torch.cuda.empty_cache()

    # the first layers: kernels against the plain matmuls at full width.
    # The random blocks' scales of 0.01 give logits in the hundreds (a loss
    # near 196), where the softmax is one-hot and a gradient turns on the
    # last bits of the forward; scales of 1 / (74 sqrt(K)) (uniform int8 has
    # a spread of 74) keep the activations O(1) and the gradients well
    # conditioned, the bytes and shapes unchanged
    n = c["check_layers"]

    def rescaled(leaf):
        k = leaf["q8"].shape[0]
        return {**leaf, "s": torch.full_like(leaf["s"], 1.0 / (74.0 * k ** 0.5))}

    cut = {**params, "output": rescaled(params["output"]),
           "layers": tuple({k: rescaled(v) if isinstance(v, dict) else v for k, v in lp.items()}
                           for lp in params["layers"][:n])}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cc = cfg.replace(n_layers=n, dtype=dtype)
        runs[dtype, "kernels"] = _step_grads(_lora_tree(cut, rank=c["rank"]), cc, tokens,
                                             first="wq")
        with plain_matmuls(), plain_attention():
            runs[dtype, "plain"] = _step_grads(_lora_tree(cut, rank=c["rank"]), cc, tokens,
                                               first="wq")
    # layer 0's adapters: A and B of wq, wk, wv and wo
    layer0 = slice(0, 8)
    k32, p32 = runs["float32", "kernels"], runs["float32", "plain"]
    k16, p16 = runs["bfloat16", "kernels"], runs["bfloat16", "plain"]
    errs = {"f32_vs_plain": _grad_err(k32[1][layer0], p32[1][layer0]),
            "f32_loss_vs_plain": abs(k32[0] - p32[0]) / abs(p32[0]),
            "bf16_vs_plain": _grad_err(k16[1][layer0], p16[1][layer0]),
            "bf16_plain_pair": _grad_err(p16[1][layer0], p32[1][layer0]),
            "bf16_loss_vs_plain": abs(k16[0] - p16[0]) / abs(p16[0]),
            "bf16_loss_plain_pair": abs(p16[0] - p32[0]) / abs(p32[0])}
    out["check_4_layers"] = errs
    log(f"train, 7B, the first {n} layers: losses f32 {k32[0]:.6f} (plain {p32[0]:.6f}), "
        f"bf16 {k16[0]:.6f} (plain {p16[0]:.6f}); layer 0's gradients x max|ref| {errs}")
    if not (errs["f32_vs_plain"] <= TRAIN_F32_TOL and errs["f32_loss_vs_plain"] <= TRAIN_F32_TOL
            and errs["bf16_vs_plain"] <= 2 * errs["bf16_plain_pair"]
            and errs["bf16_loss_vs_plain"] <= max(2 * errs["bf16_loss_plain_pair"],
                                                  TRAIN_BF16_LOSS_TOL)
            and k16[3] > 0 and k32[3] > 0):
        raise AssertionError(f"train, 7B, the first {n} layers against the plain matmuls: "
                             f"{errs}")
    del params, cut
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_cli(dev, tmp: str) -> dict:
    """Phase 7c: `finetune` then `--lora` through the CLI. A small model
    (phase 7a's shapes, byte vocab) written by write_ggjt and quantized to
    Q8_0 by the port's `quantize`; `finetune --file README.md --steps 20
    --seq 64` on the card (bf16, K1 under grad); then `--lora` one-shot
    greedy generation in f32 on the card, and the same load's greedy tokens
    on the card and on the CPU (equal) and logits of a 40-token window
    (within F32_LOGIT_TOL of max|logit|)."""
    import io

    import torch

    from llamago_tpu_torch import cli
    from llamago_tpu_torch.checkpoint.ggjt import write_ggjt
    from llamago_tpu_torch.config import GenerateConfig, ModelConfig
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    cfg = ModelConfig(**TRAIN_SMALL)
    f32 = os.path.join(tmp, "train-f32.bin")
    write_ggjt(f32, cfg, _byte_vocab(cfg.vocab_size), _train_tensors(cfg, 73))
    q8 = os.path.join(tmp, "train-q8_0.bin")
    _cli(["quantize", "--model", f32, "--out", q8, "--qkind", "q8_0"])
    adapters = os.path.join(tmp, "train.lora.npz")
    readme = os.path.join(os.path.dirname(os.path.abspath(__file__)), "README.md")
    reset_launch_counts()
    t0 = time.time()
    _cli(["finetune", "--model", q8, "--file", readme, "--steps", "20", "--seq", "64",
          "--out", adapters])
    secs = time.time() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    if not launches.get("dequant_matmul_tc"):
        raise AssertionError(f"train, finetune: K1's tile did not launch: {launches}")
    argv = ["--model", q8, "--lora", adapters, "--prompt", "The port", "--temp", "0",
            "--predict", "24", "--context", "128", "--dtype", "float32", "--silent"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    if code != 0:
        raise AssertionError(f"train, --lora on the card exited {code}")
    # the same load (adapters merged as --lora merges them), greedy tokens
    # on the card and on the CPU
    gen = GenerateConfig(max_tokens=24, ctx_size=128, temp=0.0)
    window = torch.randint(3, 259, (2, 40), generator=torch.Generator().manual_seed(74))
    tokens, logits = {}, {}
    for device in ("cuda", "cpu"):
        engine, _, cfg = cli._load_engine(cli.build_parser().parse_args(argv + ["--device",
                                                                              device]))
        tokens[device] = engine.generate("The port", gen).output_tokens
        lg, _ = forward_impl(engine.params, window.to(engine.device),
                             KVCache.create(cfg, batch=2, device=engine.device),
                             torch.zeros(2, dtype=torch.long, device=engine.device), cfg,
                             return_all_logits=True)
        logits[device] = lg.float().cpu()
        del engine
    err = ((logits["cuda"] - logits["cpu"]).abs().max() / logits["cpu"].abs().max()).item()
    log(f"train, finetune (20 steps of 2 x 64 tokens on the card) in {secs:.1f} s, launches "
        f"{launches}; --lora on the card printed {buf.getvalue()!r}; greedy tokens: card "
        f"{tokens['cuda']}, CPU {tokens['cpu']}; a 40-token window's logits card vs CPU "
        f"max|d|/max|ref| {err:.2e}")
    if tokens["cuda"] != tokens["cpu"] or len(tokens["cuda"]) != 24 or \
            not err <= F32_LOGIT_TOL:
        raise AssertionError(f"train, --lora: the card's greedy tokens or logits ({err:.3g}, "
                             f"limit {F32_LOGIT_TOL}) differ from the CPU's")
    return {"finetune_s": secs, "launches": launches, "text": buf.getvalue(),
            "tokens": tokens["cuda"], "logit_err": err}


# the gate's rows, in the order run_gate measures them
GATE_ROWS = ("fp32", "q8_0", "q4_0", "q4_1", "kv_int8", "dense_bf16", "q8_0 bf16",
             "q4_0 bf16", "q4_1 bf16", "w4x8", "w4x8_a8", "w4x8_direct")
GATE_CPU_RTOL = 1e-4


def train_gate(dev, tmp: str, card: str) -> dict:
    """Phase 7d: the quality gate (eval/quality_gate.py run_gate at its
    defaults: 400 steps, d256, L6, ctx 256, batch 8) on the card, with the
    bf16 rows on the kernels. Fails on a perplexity that is not finite, on
    the exported f32 file's perplexity on the card differing from the CPU's
    by more than GATE_CPU_RTOL (relative), on a w4x8 matmul of the
    `w4x8_a8` row that K5 did not take (K6 must not launch there), and on
    K1 bits=4 not launching in the bf16 `q4_0` row. The gate's 0.1-ppl
    thresholds are reported, not enforced. Then three more rows on the same
    files, beside the gate's: the dense file and the Q8_0 file in bf16
    with K10 on (a candidate default; it must launch; K7 does not take the
    model's head dim of 32), and the dense file over the int8 cache with
    bf16 scale planes (f32 compute)."""
    import numpy as np

    from llamago_tpu_torch.eval import quality_gate

    rows = []
    measure = quality_gate.ppl_of_file

    def counted(*args, **kw):
        reset_launch_counts()
        ppl = measure(*args, **kw)
        rows.append({"ppl": ppl, "launches": {k: v for k, v in launch_counts().items() if v}})
        return ppl

    t0 = time.time()
    quality_gate.ppl_of_file = counted
    try:
        result = quality_gate.run_gate(tmp_dir=tmp, device=dev)
    finally:
        quality_gate.ppl_of_file = measure
    secs = time.time() - t0
    if len(rows) != len(GATE_ROWS):
        raise AssertionError(f"train, gate: {len(rows)} perplexity runs, want {len(GATE_ROWS)}")
    by_row = dict(zip(GATE_ROWS, rows))
    eval_ids = quality_gate._byte_ids(quality_gate._corpus()[1])
    cpu_fp32 = measure(os.path.join(tmp, "model-f32.bin"), eval_ids, result["ctx"], "cpu")
    card_fp32 = by_row["fp32"]["ppl"]
    rel = abs(card_fp32 - cpu_fp32) / cpu_fp32
    out = {"seconds": secs, "result": result, "cpu_fp32_ppl": cpu_fp32,
           "card_fp32_ppl": card_fp32, "fp32_card_vs_cpu": rel,
           "launches": {k: r["launches"] for k, r in by_row.items()}}
    log(f"train, gate on {card} in {secs:.1f} s: ppl {result['ppl']}, deltas "
        f"{result['ppl_delta_vs_fp32']}, bf16 rows {result['fused']['ppl']}, deltas "
        f"{result['fused']['ppl_delta_vs_dense_bf16']}; passes: int4 "
        f"{result['gate_int4_pass']}, kv_int8 {result['gate_kv_int8_pass']}, bf16 q4_0 "
        f"{result['fused']['gate_int4_pass']}, w4x8_a8 {result['fused']['gate_w4x8_pass']}; "
        f"fp32 card {card_fp32!r} vs CPU {cpu_fp32!r} ({rel:.2e} relative)")
    for k, r in by_row.items():
        log(f"  gate row {k}: ppl {r['ppl']!r}, launches {r['launches']}")
    a8 = by_row["w4x8_a8"]["launches"]
    windows = len(eval_ids) // result["ctx"]
    if not np.isfinite([r["ppl"] for r in rows]).all():
        raise AssertionError(f"train, gate: a perplexity is not finite: {out['launches']}")
    if not rel <= GATE_CPU_RTOL:
        raise AssertionError(f"train, gate: the fp32 file's perplexity on the card {card_fp32} "
                             f"and on the CPU {cpu_fp32} differ by {rel:.3g}")
    if not a8.get("w4x8_matmul_a8") or a8.get("w4x8_matmul_stream") or \
            a8["w4x8_matmul_a8"] % windows:
        raise AssertionError(f"train, gate: K5 must take every w4x8 matmul of the w4x8_a8 row "
                             f"({windows} windows): {a8}")
    if not by_row["q4_0 bf16"]["launches"].get("dequant_matmul_q4"):
        raise AssertionError(f"train, gate: K1 bits=4 did not launch in the bf16 q4_0 row: "
                             f"{by_row['q4_0 bf16']['launches']}")
    # a candidate default and the int8 cache's bf16 scale planes on the
    # same files: K10 in bf16 (K7 takes head dims 64 and 128; the gate's
    # model has 32, so its windows stay on the einsum math), and bf16
    # scales in f32 compute
    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.runtime import kv_cache

    extra = {}
    with int4_exec("q4_0"):
        for name, path in (("dense_bf16", "model-f32.bin"), ("q8_0 bf16", "model-q8_0.bin")):
            fused, kernels.USE_FUSED_NORM = kernels.USE_FUSED_NORM, True
            try:
                extra[f"{name}, K10"] = counted(os.path.join(tmp, path), eval_ids,
                                                result["ctx"], dev, "bfloat16")
            finally:
                kernels.USE_FUSED_NORM = fused
            if not rows[-1]["launches"].get("fused_rms_norm"):
                raise AssertionError(f"train, gate, {name} with K10: {rows[-1]}")
        saved, kv_cache._SCALE_DTYPE_NAME = kv_cache._SCALE_DTYPE_NAME, "bfloat16"
        try:
            extra["kv_int8, bf16 scales"] = counted(os.path.join(tmp, "model-f32.bin"), eval_ids,
                                                    result["ctx"], dev, kv="int8")
        finally:
            kv_cache._SCALE_DTYPE_NAME = saved
    default = {"dense_bf16, K10": by_row["dense_bf16"]["ppl"],
               "q8_0 bf16, K10": by_row["q8_0 bf16"]["ppl"],
               "kv_int8, bf16 scales": by_row["kv_int8"]["ppl"]}
    out["candidate_defaults"] = {name: {"ppl": ppl, "default_ppl": default[name],
                                        "delta": ppl - default[name]}
                                 for name, ppl in extra.items()}
    log(f"train, gate, candidate defaults on {card}: {out['candidate_defaults']}")
    if not np.isfinite(list(extra.values())).all():
        raise AssertionError(f"train, gate: a perplexity is not finite: {extra}")
    return out


# the matmuls of one forward of the 7B training step, unfused as
# scripts/train_bench.py builds it: (names, K, N, calls a forward)
TRAIN_SHAPES = (("wq, wk, wv, wo", 4096, 4096, 128), ("w1, w3", 4096, 11008, 64),
                ("w2", 11008, 4096, 32), ("lm_head", 4096, 32768, 1))


def train_phase(dev, detail: dict, card: str) -> dict:
    """Phase 7 (`train`): K1's tile at the 7B step's 2,048 rows (bf16 x and
    f32 x, against its plain version, timed over one forward's matmuls),
    then 7a to 7d, each a function above. `launches` sums the kernels'
    launches over the training steps of 7a, 7b and 7c."""
    import tempfile

    import torch

    from llamago_tpu_torch.ops import kernels

    k1, _ = _k1_checked()
    rows = {}
    for tag, dtype, rate in (("K1 train", "bfloat16", BF16_OPS_PER_S),
                             ("K1 train f32", "float32", F32_TC_OPS_PER_S)):
        errs, steps = check_matmul(dev, detail, tag, "q8", k1, kernels.dequant_matmul_plain,
                                   timed_m=(2048,), other_m=(), ops_per_s=lambda m, r=rate: r,
                                   seed=9, other_shapes=(), timed_dtype=dtype,
                                   shapes=TRAIN_SHAPES, copies=2)
        rows[dtype] = _line(errs, steps, 2048, lambda m, xdt, d=dtype: xdt == d)
    out = {"k1_rows": rows, "small": train_small(dev)}
    total = dict.fromkeys(launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    for run in out["small"].values():
        for counts in run["launches"].values():
            add(counts)
    gc.collect()
    torch.cuda.empty_cache()
    out["7B"] = train_7b(dev, card)
    add(out["7B"]["launches"])
    add(out["7B"]["f32_step"]["launches"])
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = train_cli(dev, tmp)
    add(out["cli"]["launches"])
    out["launches"] = total
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["gate"] = train_gate(dev, tmp, card)
    return out


# ------------------------------------------------ phase 8: the parallel path

# LLaMA-2-70B's projections at tp = 2, one rank's blocks: (name, K, N,
# launches in a decode step); the head is split on the vocab (32,000 / 2)
PAR_70B_SHAPES = (("wq", 8192, 4096, 80), ("wk", 8192, 512, 80), ("wv", 8192, 512, 80),
                  ("wo", 4096, 8192, 80), ("w1", 8192, 14336, 80), ("w3", 8192, 14336, 80),
                  ("w2", 14336, 8192, 80), ("lm_head", 8192, 16000, 1))
PAR_CTX = 512  # the context (cache positions) of phase 8's engines
PAR_SLOTS = 4
# LLaMA-2-7B's Q8_0 projections at tp = 2, one rank's blocks, unfused as
# the ranks hold them: (name, K, N, launches in a decode step); the head
# is split on the vocab (32,000 / 2, a multiple of 16: not padded)
PAR_7B_SHAPES = (("wq", 4096, 2048, 32), ("wk", 4096, 2048, 32), ("wv", 4096, 2048, 32),
                 ("wo", 2048, 4096, 32), ("w1", 4096, 5504, 32), ("w3", 4096, 5504, 32),
                 ("w2", 5504, 4096, 32), ("lm_head", 4096, 16000, 1))
# K2, K3 and K4 at a 7B tp = 2 rank's attention: PAR_SLOTS slots, 16 of the
# 32 heads (no GQA), hd = 128, S = PAR_CTX
PAR_7B_ATTN = dict(b=PAR_SLOTS, kv=16, g=1, hd=128, s=PAR_CTX)
# K2 at a 70B rank's attention: 4 slots, 4 of the 8 kv heads, g = 8, hd = 128
PAR_70B_K2 = dict(b=4, kv=4, g=8, hd=128, s=PAR_CTX)
# 7B at world size 1 against tp / dp / sp of two ranks sharing the card,
# x max|logit| by (compute dtype, KV cache): in bf16 the gate phase 4 uses;
# in f32 over the f32 cache the ranks differ from world size 1 only in the
# order of the tp partial sums and of the sp combine. In f32 the greedy
# tokens must equal world size 1's over either cache
PAR_TOL = {("bfloat16", "auto"): 5e-2, ("bfloat16", "int8"): 5e-2, ("float32", "auto"): 1e-4}
# f32 over the int8 cache: K3 rounds each new K / V row to int8 and K4
# rounds q and p to int8, step functions that turn a 1-ulp difference
# upstream into a whole int8 step, so no fixed 1e-4 holds. The limit is
# this many times a witness whose difference is only the sums' order:
# world size 1 against itself with its matmuls on their plain versions
# (the same products, summed in another order; tp = 2 changes that order
# too, with its split sums), and no less than PAR_TOL's f32 1e-4. Read on
# an H100 80GB HBM3 at 700 W: the witness 5.94e-3 of max|logit|, tp = 2
# 2.07e-3, so tp = 2 may differ no more than the witness does
PAR_INT8_WITNESS_X = 1
# (setup, mesh, KV cache, the kernels each rank must launch in it)
PAR_7B_SETUPS = (
    ("tp2", {"tp": 2}, "auto", ("dequant_matmul", "flash_attention")),
    ("tp2 int8 cache", {"tp": 2}, "int8",
     ("dequant_matmul", "cache_append_quant", "flash_attention_quant_i8dot")),
    ("dp2", {"dp": 2}, "auto", ("dequant_matmul", "flash_attention")),
    ("sp2", {"sp": 2}, "auto", ("dequant_matmul",)))
# The depth of the earlier paths, cut (at full width) so that the whole
# script, build included, aims at half of the 1200 s it must finish in:
# the other half is headroom for a card capped below 700 W, which is
# slower under load, for the spread between runs and for later phases. On
# an H100 80GB HBM3 at 700 W the script with phase 8 ran 780 s and 926 s
# (77 % of the limit) at every path's full depth, and 665 s with these
# cuts; with check_7b_shards and the int8 witness added, 881 s in a run
# whose every phase was slower (the 7B QLoRA step 767.9 ms against 665.0),
# where full depth would have neared the limit. Phase 8b (sharded
# training) adds some 150 s to that run's 881 s, so the 7B of the serving
# phases went from 16 layers to 8 and phase 8's 7B setups from 32 to 16.
# Phase 4e's 7B and phase 6's LLaMA-3-8B run this many of their 32 layers
F32_ROUTE_LAYERS = 8
GGUF_8B_LAYERS = 8
# the 7B of phases 4, 4b, 4c, 4d, 4f and 4g: 8 of its 32 layers
SERVE_7B_LAYERS = 8
# the 7B of phase 8's setups (ranks and world size 1): 16 of its 32 layers
PAR_7B_LAYERS = 16
PAR_RANK_TIMEOUT_S = 420  # a rank process of phase 8 is joined within this
PAR_70B_LAYERS = 80  # full depth


def _par_prompts(n: int, length: int) -> list[str]:
    return [("The quick brown fox %d jumps over the lazy dog. " % i * 8)[:length]
            for i in range(n)]


def _par_run(params, cfg, dev) -> tuple:
    """The library path on a mesh or at world size 1: the last position's
    logits of a 16-token prefill of PAR_SLOTS rows at position 0, then
    PAR_SLOTS greedy jobs of 8 tokens through the Engine."""
    import numpy as np
    import torch

    from llamago_tpu_torch.config import GenerateConfig
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.engine import Engine, JobStatus

    engine = Engine(cfg, params, _byte_vocab(cfg.vocab_size), slots=PAR_SLOTS,
                    decode_chunk_size=1, device=dev)
    toks = np.random.default_rng(7).integers(3, cfg.vocab_size, (PAR_SLOTS, 16))
    logits, _ = forward_impl(params, torch.from_numpy(toks).to(dev), engine.cache,
                             torch.zeros(PAR_SLOTS, dtype=torch.long, device=dev), cfg)
    logits = logits.float().cpu().numpy()
    engine.cache = engine._make_cache()
    gen = GenerateConfig(max_tokens=8, ctx_size=PAR_CTX, temp=0.0)
    jobs = [engine.submit(p, gen) for p in _par_prompts(PAR_SLOTS, 24)]
    while any(j.status in (JobStatus.QUEUED, JobStatus.PROCESSING) for j in jobs):
        engine.step()
    if any(j.status != JobStatus.FINISHED for j in jobs):
        raise AssertionError(f"parallel: jobs failed: {[j.error for j in jobs]}")
    shape = list(engine.cache.k[0].shape)
    del engine
    return logits, [j.output_tokens for j in jobs], shape


def _par_7b_rank(rank: int, out: str, dev) -> dict:
    """A rank's side of phase 8's 7B setups: for each, the mesh (both ranks
    on the one card), Q8_0 weights drawn as world size 1 draws them and cut
    to this rank's blocks, and _par_run in bf16 and in f32, its kernels'
    launches counted."""
    import gc

    import numpy as np
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import MODEL_PRESETS
    from llamago_tpu_torch.ops import launches
    from llamago_tpu_torch.parallel import make_mesh
    from llamago_tpu_torch.parallel.tp_kernels import activate_mesh

    cfg7 = MODEL_PRESETS["7B"].replace(weight_dtype="int8", max_seq_len=PAR_CTX,
                                       n_layers=PAR_7B_LAYERS)
    results, params, params_tp = {}, None, None
    for name, grid, kv, _ in PAR_7B_SETUPS:
        mesh = make_mesh(**grid, devices=[dev] * 2)
        activate_mesh(mesh)
        if params_tp != mesh.tp:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            params = random_quantized_parameters(cfg7, seed=0, device=dev, mesh=mesh)
            if mesh.tp == 1:
                params = fuse_layer_weights(params)
            params_tp = mesh.tp
            results[f"memory tp={mesh.tp}"] = torch.cuda.memory_allocated(dev) / 2**30
        for dtype in ("bfloat16", "float32"):
            launches.reset()
            logits, tokens, shape = _par_run(params, cfg7.replace(dtype=dtype, kv_dtype=kv), dev)
            np.save(os.path.join(out, f"{name}-{dtype}.rank{rank}.npy"), logits)
            results[f"{name} {dtype}"] = {"tokens": tokens, "launches": launches.counts(),
                                          "cache": shape}
        activate_mesh(None)
    return results


def _par_70b_rank(rank: int, out: str, dev) -> dict:
    """A rank's side of LLaMA-2-70B (w4x8) at tp = 2: its random int4
    blocks drawn layer by layer, an Engine of PAR_SLOTS slots serving 4
    jobs over REST through serve_lockstep (rank 0 owns HTTP and its client
    thread sets the stop flag), then one profiled decode step on both
    ranks (the collectives need both)."""
    import threading

    import torch

    from llamago_tpu_torch.checkpoint.params import random_quantized_parameters
    from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig, ServerConfig
    from llamago_tpu_torch.ops import launches
    from llamago_tpu_torch.parallel import make_mesh
    from llamago_tpu_torch.parallel import mesh as mesh_mod
    from llamago_tpu_torch.parallel.multihost import serve_lockstep
    from llamago_tpu_torch.parallel.tp_kernels import activate_mesh
    from llamago_tpu_torch.runtime.decode_loop import decode_chunk
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.server.api import JobServer

    cfg = MODEL_PRESETS["llama2-70B"].replace(weight_dtype="int4", dtype="bfloat16",
                                              max_seq_len=PAR_CTX, n_layers=PAR_70B_LAYERS)
    mesh = make_mesh(tp=2, devices=[dev] * 2)
    activate_mesh(mesh)
    t0 = time.time()
    params = random_quantized_parameters(cfg, seed=0, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    res = {"load_s": time.time() - t0, "weights_gib": torch.cuda.memory_allocated(dev) / 2**30,
           "wq_block": list(params["layers"][0]["wq"]["q4x"].shape),
           "head_block": list(params["output"]["s"].shape)}
    engine = Engine(cfg, params, _byte_vocab(cfg.vocab_size), slots=PAR_SLOTS,
                    decode_chunk_size=1, device=dev)
    res["gib_with_cache"] = torch.cuda.memory_allocated(dev) / 2**30
    records: dict = {}
    submit = engine.submit

    def recorded(prompt, gen, job_id=None):
        job = submit(prompt, gen, job_id=job_id)
        records[job.id] = job
        return job

    engine.submit = recorded
    launches.reset()
    mesh_mod.host_copies = mesh_mod.collective_calls = 0
    mesh_mod.collective_s = 0.0
    t0 = time.time()
    if rank == 0:
        port = int(open(os.path.join(out, "http_port")).read())
        server = JobServer(engine, ServerConfig(host="127.0.0.1", port=port, max_pods=PAR_SLOTS),
                           GenerateConfig(max_tokens=16, ctx_size=PAR_CTX, temp=0.7),
                           model_name="llama2-70B")
        done, box = threading.Event(), {}

        def client():
            try:
                while True:
                    try:
                        _http_get(port, "/health")
                        break
                    except OSError:
                        time.sleep(0.2)
                bodies = [{"id": str(uuid.uuid4()), "prompt": p}
                          for p in _par_prompts(4, 40)]
                box["jobs"] = _http_jobs(port, bodies, timeout_s=300)
            except Exception as e:  # noqa: BLE001 — reported by the rank
                box["error"] = repr(e)
            finally:
                done.set()

        threading.Thread(target=client, daemon=True).start()
        serve_lockstep(engine, server, stop_when=done.is_set)
        if "error" in box:
            raise AssertionError(f"70B client: {box['error']}")
        res["served"] = [{"status": j["status"], "output": j["output"]} for j in box["jobs"]]
    else:
        serve_lockstep(engine, None)
    res["serve_s"] = time.time() - t0
    res["launches"] = launches.counts()
    res["jobs"] = {jid: {"tokens": j.output_tokens, "status": j.status.value}
                   for jid, j in records.items()}
    res["serve_collectives"] = {"calls": mesh_mod.collective_calls,
                                "host_s": mesh_mod.collective_s,
                                "host_copies": mesh_mod.host_copies}
    # one decode step of the 4 slots, host-timed, its collectives counted,
    # then traced (profile_decode); every rank runs the same steps
    tok = torch.full((PAR_SLOTS,), 7, dtype=torch.long, device=dev)
    pos = torch.full((PAR_SLOTS,), 100, dtype=torch.long, device=dev)
    decode_chunk(engine.params, tok, engine.cache, pos, cfg, 1)
    torch.cuda.synchronize()
    calls0, s0, copies0 = mesh_mod.collective_calls, mesh_mod.collective_s, mesh_mod.host_copies
    t0 = time.perf_counter()
    decode_chunk(engine.params, tok, engine.cache, pos, cfg, 1)
    torch.cuda.synchronize()
    res["step_host_ms"] = (time.perf_counter() - t0) * 1e3
    res["step_collectives"] = {"calls": mesh_mod.collective_calls - calls0,
                               "host_ms": (mesh_mod.collective_s - s0) * 1e3,
                               "host_copies": mesh_mod.host_copies - copies0}
    res["profile"] = profile_decode(engine, chunk=1, traced=2)
    activate_mesh(None)
    return res


def _par_rank(rank: int, port: int, out: str, job: str) -> None:
    """A rank process of phase 8: joins the 2-rank world on `port` (gloo:
    the ranks share the one card), runs `job` and writes its result."""
    import torch
    import torch.distributed as dist

    from llamago_tpu_torch.parallel.mesh import initialize_distributed

    dev = initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cuda")
    try:
        res = {"7b": _par_7b_rank, "70b": _par_70b_rank, "train": _par_train_rank}[job](
            rank, out, dev)
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        with open(os.path.join(out, f"{job}.rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _par_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _par_spawn(job: str, out: str) -> list[dict]:
    """Run `job` on two rank processes (spawned, sharing the card), joined
    with a timeout: a rank that fails, dies or outlasts it fails phase 8."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _par_free_port()
    procs = [ctx.Process(target=_par_rank, args=(r, port, out, job)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + PAR_RANK_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"parallel {job}: rank exit codes {codes} (a rank failed, died "
                             f"or outlasted {PAR_RANK_TIMEOUT_S} s)")
    out_ = []
    for r in range(2):
        with open(os.path.join(out, f"{job}.rank{r}.json")) as f:
            out_.append(json.load(f))
    return out_


def _par_small_model(tmp: str) -> str:
    """The small Q8_0 ggjt file of 8.1 and 8b.3 (dim 512, 4 heads, FFN
    1536, 2 layers, byte vocab of 265) in `tmp`: its path."""
    import numpy as np

    from llamago_tpu_torch.checkpoint.ggjt import write_ggjt
    from llamago_tpu_torch.checkpoint.quant_file import quantize_ggjt
    from llamago_tpu_torch.config import ModelConfig

    cfg = ModelConfig(vocab_size=265, dim=512, n_layers=2, n_heads=4, ffn_dim=1536,
                      max_seq_len=256)
    rng = np.random.default_rng(3)

    def mat(o, i):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    tensors = {"tok_embeddings.weight": mat(265, 512), "norm.weight": np.ones(512, np.float32),
               "output.weight": mat(265, 512)}
    for i in range(2):
        p = f"layers.{i}."
        tensors.update({p + "attention_norm.weight": np.ones(512, np.float32),
                        p + "ffn_norm.weight": np.ones(512, np.float32),
                        p + "attention.wq.weight": mat(512, 512),
                        p + "attention.wk.weight": mat(512, 512),
                        p + "attention.wv.weight": mat(512, 512),
                        p + "attention.wo.weight": mat(512, 512),
                        p + "feed_forward.w1.weight": mat(1536, 512),
                        p + "feed_forward.w2.weight": mat(512, 1536),
                        p + "feed_forward.w3.weight": mat(1536, 512)})
    f32 = os.path.join(tmp, "par-f32.bin")
    write_ggjt(f32, cfg, _byte_vocab(265), tensors)
    q8 = quantize_ggjt(f32, os.path.join(tmp, "par-q8_0.bin"), "q8_0")
    return q8


def _par_cli(dev, tmp: str) -> dict:
    """8.1: the CLI's --tp 2 server as two processes on the one card
    (--coordinator, gloo) against a one-process server on a small Q8_0
    file, both in f32 at temp 0: the same job outputs; /v1/embeddings
    through embed_routed within 1e-4 of max|e|; each rank's K1 and K2
    launch counts (logged by the rank at the end) above 0."""
    import signal

    import numpy as np

    q8 = _par_small_model(tmp)
    flags = ["--model", q8, "--server", "--host", "127.0.0.1", "--pods", "2", "--dtype",
             "float32", "--context", "256", "--temp", "0", "--predict", "12", "--chunk", "1",
             "--silent"]
    prompts = _par_prompts(3, 30)

    def serve(extra: list[list[str]]) -> tuple:
        port = _par_free_port()
        procs = [subprocess.Popen([sys.executable, "-m", "llamago_tpu_torch.cli", *flags,
                                   "--port", str(port), *e], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for e in extra]
        try:
            deadline = time.time() + 240
            while True:
                try:
                    _http_get(port, "/health")
                    break
                except OSError:
                    if time.time() > deadline or any(p.poll() is not None for p in procs):
                        raise AssertionError("parallel CLI: the server did not come up: "
                                             + " | ".join(p.stderr.read()[-2000:] for p in procs
                                                          if p.poll() is not None))
                    time.sleep(0.5)
            jobs = _http_jobs(port, [{"id": str(uuid.uuid4()), "prompt": p} for p in prompts],
                              timeout_s=120)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/embeddings",
                                         data=json.dumps({"input": prompts[0]}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                emb = np.asarray(json.loads(r.read())["data"][0]["embedding"], np.float32)
        finally:
            for p in procs:
                p.send_signal(signal.SIGTERM)
        errs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                raise AssertionError("parallel CLI: a server did not stop on SIGTERM") from None
            errs.append(err)
        return [j["output"] for j in jobs], [j["status"] for j in jobs], emb, errs, procs

    one, st1, emb1, _, _ = serve([[]])
    coord = f"127.0.0.1:{_par_free_port()}"
    two, st2, emb2, errs, procs = serve(
        [["--tp", "2", "--coordinator", coord, "--nprocs", "2", "--procid", str(i)]
         for i in range(2)])
    if st1 != ["finished"] * 3 or st2 != ["finished"] * 3:
        raise AssertionError(f"parallel CLI: job statuses {st1}, {st2}")
    if one != two:
        raise AssertionError(f"parallel CLI: the --tp 2 outputs {two} differ from the "
                             f"one-process server's {one}")
    emb_err = float(np.abs(emb1 - emb2).max() / np.abs(emb1).max())
    if not emb_err <= 1e-4:
        raise AssertionError(f"parallel CLI: embeddings differ by {emb_err:.2e} of max|e|")
    ranks = []
    for err, p in zip(errs, procs):
        lines = [json.loads(ln) for ln in err.splitlines() if ln.startswith('{"rank"')]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"parallel CLI: a rank exited {p.returncode} or logged no "
                                 f"launch counts: {err[-2000:]}")
        ranks.append(lines[0])
    for r in ranks:
        if not (r["launches"]["dequant_matmul"] and r["launches"]["flash_attention"]):
            raise AssertionError(f"parallel CLI: rank {r['rank']} launched K1 "
                                 f"{r['launches']['dequant_matmul']} and K2 "
                                 f"{r['launches']['flash_attention']} times")
    log(f"parallel CLI: --tp 2 (two processes, gloo) outputs equal the one-process server's, "
        f"embedding max|d| {emb_err:.2e}; launches by rank: "
        + "; ".join(f"rank {r['rank']} K1 {r['launches']['dequant_matmul']} K2 "
                    f"{r['launches']['flash_attention']}, host copies {r['host_copies']}"
                    for r in ranks))
    return {"outputs_equal": True, "embedding_err": emb_err, "ranks": ranks}


def check_70b_shards(dev, detail: dict) -> dict:
    """Phase 8's kernel rows (run with phase 2, where the timing traces of
    one process hold every event): K5 (m = 1, 4, 16), K6 (m = 17, 64) and K2
    (4 slots, 4 kv heads, g = 8, hd = 128, S = 512) at a LLaMA-2-70B tp = 2
    rank's shapes against their plain versions, timed beside x @ W / SDPA
    and their bounds. Returns the kernels line's numbers: K5 one decode step
    at m = 4, K6 one prefill pass at m = 64, K2 one decode step at full
    fill (80 layers)."""
    import torch

    from llamago_tpu_torch.ops import attention, kernels

    calls = [0]

    def counted(fn):
        def call(x, w):
            calls[0] += 1
            return fn(x, w)
        return call

    before = kernels.w4x8_matmul.launches_a8
    k5_errs, k5_steps = check_matmul(dev, detail, "K5 70B tp2", "q4x",
                                     counted(kernels.w4x8_matmul), kernels.w4x8_matmul_a8_plain,
                                     timed_m=(4,), other_m=(1, 16), shapes=PAR_70B_SHAPES,
                                     ops_per_s=lambda m: INT8_OPS_PER_S, seed=81,
                                     other_shapes=tuple(n for n, *_ in PAR_70B_SHAPES),
                                     checked=counted(_k5_call))
    if kernels.w4x8_matmul.launches_a8 - before != calls[0]:
        raise AssertionError(f"K5 70B tp2: {calls[0]} calls of at most 16 rows, "
                             f"{kernels.w4x8_matmul.launches_a8 - before} of K5's form")
    k6 = _counted(kernels.w4x8_matmul, lambda: {"tensor_core": kernels.w4x8_matmul.launches_tc,
                                                "f32_tc": kernels.w4x8_matmul.launches_f32_tc},
                  kernels.w4x8_form)
    k6_errs, k6_steps = check_matmul(dev, detail, "K6 70B tp2", "q4x", k6,
                                     kernels.w4x8_matmul_stream_plain, timed_m=(64,),
                                     other_m=(17,), shapes=PAR_70B_SHAPES,
                                     ops_per_s=lambda m: BF16_OPS_PER_S, seed=82,
                                     other_shapes=tuple(n for n, *_ in PAR_70B_SHAPES))
    gen = torch.Generator(device=dev).manual_seed(83)
    c = PAR_70B_K2
    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    rows = _l3_attn_rows(
        dev, gen, "K2 70B tp2", c, [(1, 1), (1, 101), (1, s), (8, 101), (32, s)],
        {(1, s)}, "bfloat16", K2_TOL,
        lambda q, cache, positions, counted=True: (
            _k2_call if counted else attention.flash_attention)(q, *cache, positions),
        lambda q, cache, positions, got: _k2_error(q, *cache, positions, c, got),
        lambda q5, cache, pos0: attention.flash_attention_plain(q5, *cache, pos0),
        lambda: tuple(torch.randn((b, kv, s, hd), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(2)),
        2 * b * kv * s * hd * 2, lambda cache, vis: (cache[0][:, :, :vis], cache[1][:, :, :vis]),
        BF16_OPS_PER_S)
    detail["k2_70b_tp2"] = rows
    return {"k5": _line(k5_errs, k5_steps, 4), "k6": _line(k6_errs, k6_steps, 64),
            "k2": _step(rows, s, layers=80)}


def check_7b_shards(dev, detail: dict) -> dict:
    """Phase 8's 7B kernel rows (run with phase 2, as check_70b_shards):
    K1 at a LLaMA-2-7B tp = 2 rank's blocks (PAR_7B_SHAPES) with bf16 and
    f32 x, checked at m = 1, 2 (a dp = 2 rank's decode rows), 4, 8, 9, 16,
    32 (a prefill bucket) and 64, timed at m = 4 and 64; K2 (bf16 and f32),
    K4 and K3 at the rank's 16 heads (PAR_7B_ATTN), each against its plain
    version and timed beside its bound and SDPA. Returns the kernels line's
    numbers: K1's four forms, each one pass of the rank's blocks, and K2,
    K2 f32, K3 and K4, each one decode step at full fill (32 layers)."""
    import torch

    out = _k1_at(dev, detail, "7b tp2", PAR_7B_SHAPES, (91, 92),
                 other_m=(1, 2, 8, 9, 16, 32))
    gen = torch.Generator(device=dev).manual_seed(93)
    out.update(_gqa_k2(dev, gen, detail, "7b tp2", PAR_7B_ATTN))
    out["k4"] = _gqa_k4(dev, gen, detail, "7b tp2", PAR_7B_ATTN)
    out["k3"] = _gqa_k3(dev, gen, detail, "7b tp2", PAR_7B_ATTN, fused=False)
    return out


def parallel_phase(dev, detail: dict, card: str, shards: dict) -> dict:
    """Phase 8 (`parallel`): 8.1 the CLI (_par_cli); 8.2 7B Q8_0 at full
    width (PAR_7B_LAYERS of its layers) on two ranks sharing the card (tp = 2 over the bf16 and
    the int8 cache, dp = 2, sp = 2) against world size 1, in bf16 and f32
    (`shards["shards_7b"]`: K1-K4 at a tp = 2 rank's shapes,
    check_7b_shards); 8.3 LLaMA-2-70B w4x8 at tp = 2 served over REST
    (`shards`: K5, K6 and K2 (g = 8) at the ranks' shapes,
    check_70b_shards); 8.4 a rank's decode step profiled. The ranks share
    one card and talk over gloo: these are numbers of a bring-up, not of
    two cards."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import MODEL_PRESETS

    out: dict = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        out["cli"] = _par_cli(dev, tmp)
        log(f"parallel CLI took {time.time() - t0:.1f} s")

        # 8.2: the ranks first, then world size 1 in this process
        t0 = time.time()
        ranks = _par_spawn("7b", tmp)
        out["7b_ranks_s"] = time.time() - t0
        log(f"parallel 7B: the ranks' setups took {out['7b_ranks_s']:.1f} s")
        cfg7 = MODEL_PRESETS["7B"].replace(weight_dtype="int8", max_seq_len=PAR_CTX,
                                           n_layers=PAR_7B_LAYERS)
        params = fuse_layer_weights(random_quantized_parameters(cfg7, seed=0, device=dev))
        ref = {}
        for kv in ("auto", "int8"):
            for dtype in ("bfloat16", "float32"):
                ref[kv, dtype] = _par_run(params, cfg7.replace(dtype=dtype, kv_dtype=kv), dev)
        with plain_matmuls():
            witness = _par_run(params, cfg7.replace(dtype="float32", kv_dtype="int8"), dev)[0]
        want = ref["int8", "float32"][0]
        out["7b_int8_f32_witness"] = float(np.abs(witness - want).max() / np.abs(want).max())
        tols = {**PAR_TOL, ("float32", "int8"): max(PAR_TOL["float32", "auto"],
                                                    PAR_INT8_WITNESS_X
                                                    * out["7b_int8_f32_witness"])}
        log(f"parallel 7B: f32 over the int8 cache, world size 1 with the plain matmuls "
            f"{out['7b_int8_f32_witness']:.2e} of max|logit| off its kernels (the witness): "
            f"limit {tols['float32', 'int8']:.2e}")
        del params, witness
        gc.collect()
        torch.cuda.empty_cache()
        setups = {}
        for name, grid, kv, must in PAR_7B_SETUPS:
            for dtype in ("bfloat16", "float32"):
                want, want_toks, _ = ref[kv, dtype]
                row = {"launches": [r[f"{name} {dtype}"]["launches"] for r in ranks],
                       "cache": ranks[0][f"{name} {dtype}"]["cache"]}
                toks = [r[f"{name} {dtype}"]["tokens"] for r in ranks]
                if toks[0] != toks[1]:
                    raise AssertionError(f"parallel 7B {name} {dtype}: the ranks emitted "
                                         f"other tokens: {toks}")
                errs = [float(np.abs(np.load(os.path.join(tmp, f"{name}-{dtype}.rank{r}.npy"))
                                     - want).max() / np.abs(want).max()) for r in range(2)]
                row["logit_err"] = max(errs)
                row["tokens_equal_world_1"] = toks[0] == want_toks
                if not row["logit_err"] <= tols[dtype, kv]:
                    raise AssertionError(f"parallel 7B {name} {dtype}: logits {row['logit_err']:.2e} "
                                         f"of max|logit| off world size 1 (> {tols[dtype, kv]:.2e})")
                if dtype == "float32" and not row["tokens_equal_world_1"]:
                    raise AssertionError(f"parallel 7B {name} f32: greedy tokens {toks[0]} "
                                         f"differ from world size 1's {want_toks}")
                for r, counts in enumerate(row["launches"]):
                    if any(counts[k] == 0 for k in must):
                        raise AssertionError(f"parallel 7B {name} {dtype}: rank {r} launched "
                                             f"{ {k: counts[k] for k in must} }")
                log(f"parallel 7B {name} {dtype}: logits {row['logit_err']:.2e} of max|logit| "
                    f"off world size 1, tokens equal world 1: {row['tokens_equal_world_1']}, "
                    f"cache block {row['cache']}, launches rank 0 "
                    f"{ {k: row['launches'][0][k] for k in must} } rank 1 "
                    f"{ {k: row['launches'][1][k] for k in must} }")
                setups[f"{name} {dtype}"] = row
        out["7b"] = setups
        out["7b_memory_gib"] = {k: [r[k] for r in ranks] for k in ranks[0] if k.startswith("memory")}

        # 8.3: LLaMA-2-70B w4x8 at tp = 2
        env = os.environ.get("LLAMAGO_INT4_EXEC")
        os.environ["LLAMAGO_INT4_EXEC"] = "w4x8"
        try:
            with open(os.path.join(tmp, "http_port"), "w") as f:
                f.write(str(_par_free_port()))
            t0 = time.time()
            big = _par_spawn("70b", tmp)
            out["70b_s"] = time.time() - t0
            log(f"parallel 70B: the ranks took {out['70b_s']:.1f} s")
        finally:
            if env is None:
                del os.environ["LLAMAGO_INT4_EXEC"]
            else:
                os.environ["LLAMAGO_INT4_EXEC"] = env
    served = big[0]["served"]
    if [j["status"] for j in served] != ["finished"] * 4:
        raise AssertionError(f"parallel 70B: served {served}")
    if big[0]["jobs"] != big[1]["jobs"]:
        raise AssertionError("parallel 70B: the ranks ran other jobs or tokens")
    for r, res in enumerate(big):
        c = res["launches"]
        if not (c["w4x8_matmul_a8"] and c["w4x8_matmul_tc"] and c["flash_attention_decode_tc"]):
            raise AssertionError(f"parallel 70B: rank {r} launched K5 {c['w4x8_matmul_a8']}, "
                                 f"K6 {c['w4x8_matmul_tc']}, K2 {c['flash_attention_decode_tc']}")
        log(f"parallel 70B rank {r}: weights {res['weights_gib']:.2f} GiB, with the cache "
            f"{res['gib_with_cache']:.2f} GiB, peak {res['peak_gib']:.2f} GiB, drawn in "
            f"{res['load_s']:.1f} s; 4 jobs served in {res['serve_s']:.1f} s; K5 "
            f"{c['w4x8_matmul_a8']}, K6 {c['w4x8_matmul_tc']}, K2 "
            f"{c['flash_attention_decode_tc']} launches; serving collectives "
            f"{res['serve_collectives']}; decode step host {res['step_host_ms']:.1f} ms, "
            f"collectives {res['step_collectives']}, device busy "
            f"{res['profile']['device_busy_ms']:.3f} ms")
    out["70b"] = [{k: v for k, v in r.items() if k not in ("jobs",)} for r in big]

    out.update(shards)
    out["launches_70b"] = {k: sum(r["launches"][k] for r in big) for k in big[0]["launches"]}
    total = dict.fromkeys(big[0]["launches"], 0)
    for row in setups.values():
        for counts in row["launches"]:
            for k, v in counts.items():
                total[k] += v
    for r in out["cli"]["ranks"]:
        for k, v in r["launches"].items():
            total[k] += v
    out["launches_7b_cli"] = total
    sh7 = out["shards_7b"]
    log(f"parallel 7B tp2 shard shapes: K1 one decode step {sh7['k1_decode']['ms']:.3f} ms "
        f"(bound {sh7['k1_decode']['bound_ms']:.3f}), one prefill pass at m=64 "
        f"{sh7['k1_tile']['ms']:.3f} ms (bound {sh7['k1_tile']['bound_ms']:.3f}); K2 a decode "
        f"step {sh7['k2']['ms']:.3f} ms (bound {sh7['k2']['bound_ms']:.3f}), K4 "
        f"{sh7['k4']['ms']:.3f} ms (bound {sh7['k4']['bound_ms']:.3f}), K3 {sh7['k3']['ms']:.4f} "
        f"ms (bound {sh7['k3']['bound_ms']:.4f})")
    log(f"parallel 70B tp2 shard shapes: K5 one decode step {out['k5']['ms']:.3f} ms (bound "
        f"{out['k5']['bound_ms']:.3f}), K6 one prefill pass at m=64 {out['k6']['ms']:.3f} ms "
        f"(bound {out['k6']['bound_ms']:.3f}), K2 g=8 a decode step {out['k2']['ms']:.3f} ms "
        f"(bound {out['k2']['bound_ms']:.3f})")
    return out


# ------------------------------------------------ phase 8b: sharded training

# 8b's 7B QLoRA setups at full width (dim 4096, 32 heads, FFN 11008, vocab
# 32000) on PAR_TRAIN["layers"] of the 32 layers (the depth is cut to fit
# the script's time, the widths are not), a batch of 2 x 256 tokens (dp = 2
# trains one row a rank, sp = 2 128 positions a rank), adapters of rank 8
# on wq / wk / wv / wo with B drawn from a seed, remat on, K7 on every
# window (the prefill floor at 0); one check step in each dtype, then one
# warm and `timed_steps` timed bf16 steps and one traced
PAR_TRAIN = dict(layers=4, batch=2, seq=256, rank=8, timed_steps=3)
# (setup, mesh, the kernels each rank must launch in its steps)
PAR_TRAIN_SETUPS = (("tp2", {"tp": 2}, ("dequant_matmul", "flash_attention_prefill")),
                    ("dp2", {"dp": 2}, ("dequant_matmul", "flash_attention_prefill")),
                    ("sp2", {"sp": 2}, ("dequant_matmul",)))
# K7 at a 7B tp = 2 rank's training window: the batch, 16 of the 32 heads,
# the whole window of PAR_TRAIN["seq"] positions
PAR_TRAIN_K7 = dict(b=PAR_TRAIN["batch"], kv=16, g=1, hd=128, s=PAR_TRAIN["seq"])
# 8b.2's full-weight train_step: phase 7a's small model, f32, 2 x 64 tokens
PAR_DENSE_SETUPS = (("tp2", {"tp": 2}), ("dp2", {"dp": 2}))


def _par_train_params(cfg, dev, mesh):
    """The 7B Q8_0 base of seed 0 on this rank (drawn whole as world size 1
    draws it, then cut), every block's scales set to 1 / (74 sqrt(K)) of
    its leaf's whole K, as phase 7b's check sets them to keep the
    activations O(1) (uniform int8 has a spread of 74)."""
    import torch

    from llamago_tpu_torch.checkpoint.params import random_quantized_parameters
    from llamago_tpu_torch.parallel.sharding import global_dims

    params = random_quantized_parameters(cfg, seed=0, device=dev, mesh=mesh)
    dims = global_dims(cfg)

    def rescaled(key, leaf):
        return {**leaf, "s": torch.full_like(leaf["s"], 1.0 / (74.0 * dims[key][0] ** 0.5))}

    return {**params, "output": rescaled("output", params["output"]),
            "layers": tuple({k: rescaled(k, v) if isinstance(v, dict) else v
                             for k, v in lp.items()} for lp in params["layers"])}


def _par_train_tree(params, cfg, mesh):
    """init_lora (rank 8, seed 0) over the rank's blocks, each B drawn whole
    (normal x 0.05 from a CPU generator seeded 71, in tree order) and cut
    as its base is: world size 1's adapters, cut."""
    import torch

    from llamago_tpu_torch.models import lora
    from llamago_tpu_torch.parallel.sharding import block_kind, global_dims

    r = PAR_TRAIN["rank"]
    tree = lora.init_lora(params, rank=r, alpha=16.0, seed=0, config=cfg)
    gen = torch.Generator().manual_seed(71)
    for lp in tree["layers"]:
        for key, leaf in lp.items():
            if lora.is_lora(leaf):
                b = torch.randn((r, global_dims(cfg)[key][1]), generator=gen) * 0.05
                if block_kind(key, leaf, cfg, mesh) == "col":
                    n = b.shape[1] // mesh.tp
                    b = b[:, mesh.coord("tp") * n:(mesh.coord("tp") + 1) * n]
                leaf["lora_b"] = b.contiguous().to(leaf["lora_a"].device)
    return tree


def _adapter_grads(tree) -> dict:
    """Every adapter's gradient ("layer/key/lora_a") as f32 numpy."""
    from llamago_tpu_torch.models import lora

    return {f"{i}/{key}/{half}": leaf[half].grad.float().cpu().numpy()
            for i, lp in enumerate(tree["layers"]) for key, leaf in lp.items()
            if lora.is_lora(leaf) for half in ("lora_a", "lora_b")}


def _par_train_grads(params, cfg, tokens, mesh) -> tuple:
    """One lora_train_step from a fresh tree: (loss, this rank's gradients)."""
    import torch

    from llamago_tpu_torch.models import lora

    tree = _par_train_tree(params, cfg, mesh)
    opt = lora.init_lora_opt_state(tree)
    tree, opt, loss = lora.lora_train_step(tree, opt, tokens, cfg)
    torch.cuda.synchronize()
    return float(loss), _adapter_grads(tree)


def _par_train_timed(params, cfg, tokens, mesh, dev) -> dict:
    """One warm and PAR_TRAIN["timed_steps"] timed bf16 steps (ms a step, the
    collectives a step with their host ms and host copies, the peak device
    memory of this rank), then one traced step (device busy). Every rank
    runs the same steps: the trace is taken once, never retaken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llamago_tpu_torch.models import lora
    from llamago_tpu_torch.parallel import mesh as mesh_mod

    tree = _par_train_tree(params, cfg, mesh)
    opt = lora.init_lora_opt_state(tree)
    losses = []

    def step():
        nonlocal tree, opt
        tree, opt, loss = lora.lora_train_step(tree, opt, tokens, cfg)
        losses.append(loss)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    n = PAR_TRAIN["timed_steps"]
    calls0, s0, copies0 = mesh_mod.collective_calls, mesh_mod.collective_s, mesh_mod.host_copies
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    coll = {"calls": (mesh_mod.collective_calls - calls0) / n,
            "host_ms": (mesh_mod.collective_s - s0) * 1e3 / n,
            "host_copies": (mesh_mod.host_copies - copies0) / n}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy = device_busy_us(prof.events()) / 1e3
    return {"ms_per_step": ms, "collectives_per_step": coll, "peak_gib": peak,
            "device_busy_ms": busy, "device_busy_share": busy / ms,
            "collective_host_share": coll["host_ms"] / ms,
            "losses": [float(x) for x in losses]}


def _par_dense_tensors():
    from llamago_tpu_torch.config import ModelConfig

    cfg = ModelConfig(**TRAIN_SMALL, dtype="float32", weight_dtype="float32")
    return cfg, _train_tensors(cfg, 70)


def _par_dense_step(dev, mesh) -> tuple:
    """8b.2: one full-weight train_step of phase 7a's small model in f32
    on this rank (or at world size 1): (loss, every parameter's gradient by
    path, as f32 numpy)."""
    import numpy as np
    import torch

    from llamago_tpu_torch.checkpoint.params import load_parameters, unstack_layer_params
    from llamago_tpu_torch.models import training

    cfg, tensors = _par_dense_tensors()
    params = unstack_layer_params(load_parameters(cfg, tensors, device=dev, mesh=mesh),
                                  cfg.n_layers)
    toks = torch.from_numpy(np.random.default_rng(75).integers(
        3, cfg.vocab_size, (2, 64))).to(dev)
    opt = training.make_optimizer(params)
    with k7_route():
        params, opt, loss = training.train_step(params, opt, toks, cfg)
    torch.cuda.synchronize()
    grads = {"tok_embeddings": params["tok_embeddings"].grad, "norm": params["norm"].grad,
             "output": params["output"].grad}
    for i, lp in enumerate(params["layers"]):
        grads.update({f"{i}/{k}": v.grad for k, v in lp.items()})
    return float(loss), {k: v.float().cpu().numpy() for k, v in grads.items()}


def _par_train_rank(rank: int, out: str, dev) -> dict:
    """A rank's side of phase 8b: for each 7B setup the mesh (both ranks on
    the one card), the base cut to this rank's blocks, a check step in f32
    and in bf16 (gradients written to `out`), the timed steps, each
    setup's launches counted; then 8b.2's dense step at tp 2 and dp 2."""
    import gc

    import numpy as np
    import torch

    from llamago_tpu_torch.config import MODEL_PRESETS
    from llamago_tpu_torch.ops import launches
    from llamago_tpu_torch.parallel import make_mesh
    from llamago_tpu_torch.parallel.tp_kernels import activate_mesh

    c = PAR_TRAIN
    cfg = MODEL_PRESETS["7B"].replace(weight_dtype="int8", n_layers=c["layers"],
                                      max_seq_len=c["seq"])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (c["batch"], c["seq"]))).to(dev)
    res = {}
    for name, grid, _ in PAR_TRAIN_SETUPS:
        mesh = make_mesh(**grid, devices=[dev] * 2)
        activate_mesh(mesh)
        params = _par_train_params(cfg, dev, mesh)
        row = {}
        with k7_route():
            launches.reset()
            for dtype in ("float32", "bfloat16"):
                loss, grads = _par_train_grads(params, cfg.replace(dtype=dtype), tokens, mesh)
                np.savez(os.path.join(out, f"train-{name}-{dtype}.rank{rank}.npz"), **grads)
                row[dtype] = {"loss": loss}
            row["check_launches"] = launches.counts()
            launches.reset()
            row["timed"] = _par_train_timed(params, cfg.replace(dtype="bfloat16"), tokens,
                                            mesh, dev)
            row["timed"]["launches"] = launches.counts()
        res[name] = row
        activate_mesh(None)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for name, grid in PAR_DENSE_SETUPS:
        mesh = make_mesh(**grid, devices=[dev] * 2)
        activate_mesh(mesh)
        launches.reset()
        loss, grads = _par_dense_step(dev, mesh)
        np.savez(os.path.join(out, f"dense-{name}.rank{rank}.npz"), **grads)
        res[f"dense {name}"] = {"loss": loss, "launches": launches.counts()}
        activate_mesh(None)
    return res


def _whole(parts: list, shape) -> "np.ndarray":
    """A tensor whole from two ranks' copies: rank 0's where it is whole,
    else the two blocks put together along the dim that differs."""
    import numpy as np

    a = parts[0]
    if a.shape == tuple(shape):
        return a
    ax = next(d for d in range(a.ndim) if a.shape[d] != shape[d])
    return np.concatenate(parts, axis=ax)


def _grads_err(ranks: list, ref: dict) -> float:
    """The largest max|d| / max|ref| over every tensor, the ranks' blocks
    put together."""
    import numpy as np

    return max(float(np.abs(_whole([r[k] for r in ranks], w.shape) - w).max()
                     / max(np.abs(w).max(), 1e-30)) for k, w in ref.items())


def check_train_shards(dev, detail: dict) -> dict:
    """Phase 8b's kernel rows (run with phase 2, as check_7b_shards): K1's
    tile at a 7B tp = 2 rank's blocks (PAR_7B_SHAPES) at the training
    step's PAR_TRAIN batch x seq rows, bf16 x and f32 x (its f32_tc form),
    against its plain version and timed over one forward of the 32 layers'
    blocks; K7 at the rank's training window (PAR_TRAIN_K7) in bf16 and f32,
    timed beside SDPA and the bound, one call a layer. Returns the kernels
    line's numbers."""
    import torch

    from llamago_tpu_torch.ops import attention, kernels

    k1, _ = _k1_checked()
    m = PAR_TRAIN["batch"] * PAR_TRAIN["seq"]
    out = {}
    for tag, dtype, rate in (("K1 train tp2", "bfloat16", BF16_OPS_PER_S),
                             ("K1 train tp2 f32", "float32", F32_TC_OPS_PER_S)):
        errs, steps = check_matmul(dev, detail, tag, "q8", k1, kernels.dequant_matmul_plain,
                                   timed_m=(m,), other_m=(), ops_per_s=lambda m_, r=rate: r,
                                   seed=95, other_shapes=(), timed_dtype=dtype,
                                   shapes=PAR_7B_SHAPES, copies=2)
        out[f"k1_{dtype}"] = _line(errs, steps, m, lambda m_, xdt, d=dtype: xdt == d)
    c = PAR_TRAIN_K7
    gen = torch.Generator(device=dev).manual_seed(96)
    b, kv, hd, s = c["b"], c["kv"], c["hd"], c["s"]
    for dtype, tol, rate in (("bfloat16", K7_TOL, BF16_OPS_PER_S),
                             ("float32", F32_ATTN_TOL, TF32X3_OPS_PER_S)):
        dt = getattr(torch, dtype)
        rows = _l3_attn_rows(
            dev, gen, f"K7 train tp2 {dtype}", c, [(s, s)], {(s, s)}, dtype, tol,
            lambda q, cache, positions, counted=True: (
                _k7_call if counted else attention.flash_attention)(q, *cache, positions),
            lambda q, cache, positions, got: _k7_error(q, *cache, positions, c, got),
            lambda q5, cache, pos0: attention.flash_attention_prefill_plain(q5, *cache, pos0),
            lambda dt=dt: tuple(torch.randn((b, kv, s, hd), generator=gen, device=dev).to(dt)
                                for _ in range(2)),
            2 * b * kv * s * hd * dt.itemsize,
            lambda cache, vis: (cache[0][:, :, :vis], cache[1][:, :, :vis]), rate)
        rec = rows[0]
        out[f"k7_{dtype}"] = {"max_abs_err": rec["max_abs_err"], "bound_by": rec["bound_by"],
                              **{k: 32 * rec[k] for k in ("ms", "plain_ms", "library_ms",
                                                          "bound_ms")}}
        detail[f"k7_train_tp2_{dtype}"] = rows
    return out


def _cli_start(argv: list[str], nprocs: int) -> tuple:
    """Start `python -m llamago_tpu_torch.cli argv` as nprocs ranks of one
    --coordinator world on the one card (gloo), or `argv` as it is (another
    module's command line) with nprocs 0: (argv, the processes)."""
    if nprocs == 0:
        cmds = [[sys.executable, "-m", *argv]]
    else:
        coord = f"127.0.0.1:{_par_free_port()}"
        cmds = [[sys.executable, "-m", "llamago_tpu_torch.cli", *argv, "--coordinator", coord,
                 "--nprocs", str(nprocs), "--procid", str(i)] for i in range(nprocs)]
    return argv, [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                  for c in cmds]


def _cli_wait(started: tuple, timeout: float = 300) -> list[tuple]:
    """Each process's (exit code, stdout, stderr) of a _cli_start, every
    process stopped; a process that fails fails the phase."""
    argv, procs = started
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for code, _, err in outs:
        if code != 0:
            raise AssertionError(f"{' '.join(argv)} on {len(procs)} process(es) exited {code}: "
                                 f"{err[-2000:]}")
    return outs


def _cli_here(argv: list[str]) -> str:
    """The port's CLI in this process (one card): its standard output."""
    import io

    from llamago_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    if code != 0:
        raise AssertionError(f"llamago_tpu_torch.cli {' '.join(argv)} exited {code}")
    return buf.getvalue()


def _rank_launches(err: str) -> dict:
    lines = [json.loads(ln) for ln in err.splitlines() if ln.startswith('{"rank"')]
    if len(lines) != 1:
        raise AssertionError(f"a rank logged {len(lines)} launch lines: {err[-2000:]}")
    return lines[0]


def _ppl_line(text: str) -> tuple[float, float]:
    m = re.search(r"\[PPL\] perplexity ([0-9.]+) \| nll ([0-9.]+)", text)
    if m is None:
        raise AssertionError(f"no [PPL] line in {text!r}")
    return float(m.group(1)), float(m.group(2))


def _par_train_cli(tmp: str) -> dict:
    """8b.3: the CLI on the small Q8_0 file of 8.1, ranks as --coordinator
    processes on the one card: `finetune --tp 2` (bf16, K1 under grad on
    both ranks); then, side by side, `--lora` of its adapters at --tp 2,
    `perplexity` at --tp 2 and at --sp 2, and `python -m
    llamago_tpu_torch.dryrun --n 2` (8b.4), each held against this process
    on one card in f32 (the same greedy text; the NLL within PPL_TOL)."""
    q8 = _par_small_model(tmp)
    # the first 6,000 characters of README.md: 46 windows of 128 tokens
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "README.md"),
              encoding="utf-8") as f:
        text = f.read()[:6000]
    readme = os.path.join(tmp, "par-text.txt")
    with open(readme, "w", encoding="utf-8") as f:
        f.write(text)
    adapters = os.path.join(tmp, "par.lora.npz")
    t0 = time.time()
    runs = _cli_wait(_cli_start(["finetune", "--model", q8, "--file", readme, "--steps", "5",
                                 "--seq", "64", "--context", "128", "--train-batch", "2",
                                 "--out", adapters, "--silent", "--tp", "2"], 2))
    out = {"finetune_s": time.time() - t0,
           "finetune_ranks": [_rank_launches(e) for _, _, e in runs]}
    if not runs[0][1].startswith("[FINETUNE] 5 steps") or runs[1][1]:
        raise AssertionError(f"finetune --tp 2 printed {runs[0][1]!r} and {runs[1][1]!r}")
    for r in out["finetune_ranks"]:
        if not r["launches"]["dequant_matmul"]:
            raise AssertionError(f"finetune --tp 2: rank {r['rank']} launched no K1")
    gen = ["--model", q8, "--lora", adapters, "--prompt", "The port", "--temp", "0",
           "--predict", "16", "--context", "128", "--dtype", "float32", "--silent"]
    ppl = ["perplexity", "--model", q8, "--file", readme, "--context", "128", "--dtype",
           "float32", "--silent"]
    t0 = time.time()
    started = {"lora": _cli_start(gen + ["--tp", "2"], 2),
               "ppl_tp2": _cli_start(ppl + ["--tp", "2"], 2),
               "ppl_sp2": _cli_start(ppl + ["--sp", "2"], 2),
               "dryrun": _cli_start(["llamago_tpu_torch.dryrun", "--n", "2"], 0)}
    one = _cli_here(gen)
    want = _ppl_line(_cli_here(ppl))
    done = {k: _cli_wait(v, timeout=PAR_RANK_TIMEOUT_S) for k, v in started.items()}
    out["side_by_side_s"] = time.time() - t0
    if done["lora"][0][1] != one or not one.startswith("The port"):
        raise AssertionError(f"--lora at --tp 2 printed {done['lora'][0][1]!r}, one card {one!r}")
    out["lora_text"] = one
    out["ppl_one"] = want
    for key in ("ppl_tp2", "ppl_sp2"):
        got = out[key] = _ppl_line(done[key][0][1])
        if not abs(got[1] - want[1]) <= PPL_TOL["float32"] * abs(want[1]):
            raise AssertionError(f"perplexity {key}: nll {got[1]}, one process {want[1]}")
    out["dryrun"] = done["dryrun"][0][1].strip()
    if "dryrun_multichip OK: mesh dp=1 sp=1 tp=2" not in out["dryrun"]:
        raise AssertionError(f"the dry run printed {out['dryrun']!r}")
    log(f"parallel training CLI: finetune --tp 2 in {out['finetune_s']:.1f} s (K1 launches "
        f"by rank {[r['launches']['dequant_matmul'] for r in out['finetune_ranks']]}), then in "
        f"{out['side_by_side_s']:.1f} s side by side: --lora at --tp 2 printed one card's "
        f"text, perplexity one process {want}, --tp 2 {out['ppl_tp2']}, --sp 2 "
        f"{out['ppl_sp2']}; the dry run: {out['dryrun']!r}")
    return out


def par_train_phase(dev, detail: dict, card: str, shards: dict) -> dict:
    """Phase 8b (`par_train`): 8b.1 the 7B QLoRA step at full width
    (PAR_TRAIN) on two ranks sharing the card at tp 2, dp 2 and sp 2 against
    world size 1 on the same batch and adapters: f32 loss within 1e-5 and
    every adapter's gradient within TRAIN_F32_TOL of max|g|, bf16 within
    twice the plain pair's own difference (world size 1, plain bf16 against
    plain f32), as phase 7b; K1 must launch on each rank, K7 too under tp
    and dp; ms a step, collectives a step (host ms, host copies), peak GiB
    a rank and device busy share recorded. 8b.2 phase 7a's small model,
    one full-weight f32 step at tp 2 and dp 2 against world size 1 within
    TRAIN_F32_TOL. 8b.3 the CLI and 8b.4 `python -m
    llamago_tpu_torch.dryrun --n 2` (_par_train_cli). The ranks share one
    card and talk over gloo: numbers of a bring-up, not of two cards."""
    import tempfile

    import numpy as np
    import torch

    from llamago_tpu_torch.config import MODEL_PRESETS
    from llamago_tpu_torch.ops import launches

    c = PAR_TRAIN
    out: dict = {"card": card, **shards}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ranks = _par_spawn("train", tmp)
        out["ranks_s"] = time.time() - t0
        log(f"parallel training: the ranks took {out['ranks_s']:.1f} s")
        cfg = MODEL_PRESETS["7B"].replace(weight_dtype="int8", n_layers=c["layers"],
                                          max_seq_len=c["seq"])
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (c["batch"], c["seq"]))).to(dev)
        t0 = time.time()
        params = _par_train_params(cfg, dev, None)
        ref = {}
        with k7_route():
            for dtype in ("float32", "bfloat16"):
                ref[dtype, "kernels"] = _par_train_grads(params, cfg.replace(dtype=dtype),
                                                         tokens, None)
                with plain_matmuls(), plain_attention():
                    ref[dtype, "plain"] = _par_train_grads(params, cfg.replace(dtype=dtype),
                                                           tokens, None)
            launches.reset()
            out["world1"] = _par_train_timed(params, cfg.replace(dtype="bfloat16"), tokens,
                                             None, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["world1_s"] = time.time() - t0
        pair = _grads_err([ref["bfloat16", "plain"][1]], ref["float32", "plain"][1])
        loss_pair = abs(ref["bfloat16", "plain"][0] - ref["float32", "plain"][0]) / abs(
            ref["float32", "plain"][0])
        out["bf16_plain_pair"] = {"grads": pair, "loss": loss_pair}
        log(f"parallel training, world size 1: losses f32 {ref['float32', 'kernels'][0]:.6f} "
            f"bf16 {ref['bfloat16', 'kernels'][0]:.6f}; the plain pair (bf16 against f32) "
            f"{pair:.3e} of max|g|, loss {loss_pair:.3e}; a bf16 step "
            f"{out['world1']['ms_per_step']:.1f} ms, peak {out['world1']['peak_gib']:.2f} GiB, "
            f"device busy {out['world1']['device_busy_share']:.1%}")
        for name, _, must in PAR_TRAIN_SETUPS:
            row = {"timed": [r[name]["timed"] for r in ranks]}
            for dtype in ("float32", "bfloat16"):
                got = []
                for r in range(2):
                    with np.load(os.path.join(tmp, f"train-{name}-{dtype}.rank{r}.npz")) as z:
                        got.append({k: z[k] for k in z.files})
                loss_w, grads_w = ref[dtype, "kernels"]
                err = _grads_err(got, grads_w)
                losses = [r[name][dtype]["loss"] for r in ranks]
                lerr = max(abs(x - loss_w) / abs(loss_w) for x in losses)
                row[dtype] = {"grads_err": err, "loss_err": lerr, "losses": losses}
                ok = (err <= TRAIN_F32_TOL and lerr <= 1e-5) if dtype == "float32" else (
                    err <= 2 * pair and lerr <= max(2 * loss_pair, TRAIN_BF16_LOSS_TOL))
                if not ok:
                    failed.append(f"parallel training {name} {dtype}: gradients {err:.3e} "
                                  f"of max|g|, loss {lerr:.3e} off world size 1")
            for r, res in enumerate(ranks):
                counts = res[name]["check_launches"]
                timed_counts = res[name]["timed"]["launches"]
                if any(not counts[k] or not timed_counts[k] for k in must):
                    failed.append(f"parallel training {name}: rank {r} launched "
                                  f"{ {k: (counts[k], timed_counts[k]) for k in must} }")
            t = row["timed"]
            log(f"parallel training {name} on {card}: f32 gradients {row['float32']['grads_err']:.2e}"
                f", loss {row['float32']['loss_err']:.2e}; bf16 gradients "
                f"{row['bfloat16']['grads_err']:.2e}, loss {row['bfloat16']['loss_err']:.2e} off "
                f"world size 1; a bf16 step {[round(x['ms_per_step'], 1) for x in t]} ms by rank, "
                f"collectives a step {[x['collectives_per_step'] for x in t]}, peak "
                f"{[round(x['peak_gib'], 2) for x in t]} GiB, device busy "
                f"{[round(x['device_busy_share'], 3) for x in t]}; K1 launches "
                f"{[x['launches']['dequant_matmul'] for x in t]}, K7 "
                f"{[x['launches']['flash_attention_prefill'] for x in t]}")
            out[name] = row
        # 8b.2: the dense step against world size 1
        launches.reset()
        loss1, grads1 = _par_dense_step(dev, None)
        for name, _ in PAR_DENSE_SETUPS:
            got = []
            for r in range(2):
                with np.load(os.path.join(tmp, f"dense-{name}.rank{r}.npz")) as z:
                    got.append({k: z[k] for k in z.files})
            err = _grads_err(got, grads1)
            lerr = max(abs(r[f"dense {name}"]["loss"] - loss1) / abs(loss1) for r in ranks)
            counts = [r[f"dense {name}"]["launches"] for r in ranks]
            out[f"dense {name}"] = {"grads_err": err, "loss_err": lerr, "launches": counts}
            log(f"parallel training, dense {name}: gradients {err:.2e} of max|g|, loss "
                f"{lerr:.2e} off world size 1; K7 launches "
                f"{[x['flash_attention_prefill'] for x in counts]}")
            if not (err <= TRAIN_F32_TOL and lerr <= 1e-5) or not all(
                    x["flash_attention_prefill"] for x in counts):
                failed.append(f"parallel training, dense {name}: gradients {err:.3e}, loss "
                              f"{lerr:.3e}, K7 launches "
                              f"{[x['flash_attention_prefill'] for x in counts]}")
        t0 = time.time()
        out["cli"] = _par_train_cli(tmp)
        out["cli_s"] = time.time() - t0
    if failed:
        raise AssertionError("; ".join(failed))
    total = dict.fromkeys(ranks[0]["tp2"]["check_launches"], 0)
    for res in ranks:
        for name, _, _ in PAR_TRAIN_SETUPS:
            for counts in (res[name]["check_launches"], res[name]["timed"]["launches"]):
                for k, v in counts.items():
                    total[k] += v
    out["launches"] = total
    return out


def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--out", default="", help="write the run's detail here as JSON")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run alone (prints no result lines)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        log("CUDA is not available: this smoke test needs a GPU")
        return 1
    from llamago_tpu_torch.ops import _build, attention

    if attention._MIN_PREFILL_SCORES is None:  # the JAX package's routes (docstring)
        attention._MIN_PREFILL_SCORES = attention._JAX_PREFILL_SCORES
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(f"card: {card}")
    t0 = time.time()
    ptxas = _build.build_all(verbose=True)
    log(f"kernels built in {time.time() - t0:.1f} s")
    spills: dict[str, int] = {}  # spill bytes (stores + loads) of the forms in TC_FORMS
    ptxas_lines = []  # every kernel's registers and spills, for the detail file
    for name, text in ptxas.items():
        fn = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = _kernel_name(line.split("Function properties for")[-1].strip())
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name} {fn}: {line.strip()}")
                ptxas_lines.append(f"{name} {fn}: {line.strip()}")
                sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if sp and fn.split(" ")[0] in TC_FORMS:
                    # names are cut short, so instances may share one: keep the most
                    spills[fn] = max(spills.get(fn, 0), int(sp.group(1)) + int(sp.group(2)))
    log(f"ptxas spill bytes of {', '.join(TC_FORMS)}: {spills}")
    unseen = [f for f, source in TC_FORMS.items()
              if ptxas[source] and not any(k.split(" ")[0] == f for k in spills)]
    if unseen or any(spills.values()):
        raise AssertionError(f"ptxas: {', '.join(TC_FORMS)} must build without spills: "
                             f"{spills}; not in the build's output: {unseen}")
    # float32 products in the references run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")

    detail: dict = {"card": card, "ptxas_spills": spills, "ptxas": ptxas_lines}
    only = set(args.only.split(",")) if args.only else None

    def want(phase: str) -> bool:
        if only is None or phase in only:
            log(f"{time.time() - t0:.0f} s since the build began: {phase}")
            return True
        return False

    k1, k1tc, k1dt, k1f32 = check_k1(dev, detail) if want("k1") else ({}, {}, {}, {})
    k2, k2f32 = check_k2(dev, detail) if want("k2") else ({}, {})
    k3 = check_k3(dev, detail) if want("k3") else {}
    k4, k8tc, k8 = check_k4_k8(dev, detail) if want("k4k8") else ({}, {}, {})
    k1q4, _, _, _ = check_k1(dev, detail, "q4") if want("k1q4") else ({}, {}, {}, {})
    k5 = check_k5(dev, detail) if want("k5") else {}
    k6, k6tc = check_k6(dev, detail) if want("k6") else ({}, {})
    k9tc, k9, k9tile, k9tile32 = check_k9(dev, detail) if want("k9") else ({}, {}, {}, {})
    k7, k7f32 = check_k7(dev, detail) if want("k7") else ({}, {})
    k10 = check_k10(dev, detail) if want("k10") else {}
    lab = check_lab(dev, detail) if want("lab") else {}
    l3 = check_llama3(dev, detail) if want("llama3") else {}
    shards = ({**check_70b_shards(dev, detail), "shards_7b": check_7b_shards(dev, detail)}
              if want("parallel") else {})
    train_shards = {}
    if want("par_train"):
        t0 = time.time()
        train_shards = {**check_train_shards(dev, detail), "shards_s": time.time() - t0}
    # phase 7: training, LoRA, finetune / --lora and the quality gate. It
    # runs before phase 3: after phase 3's runs its first `timed` trace was
    # seen on an H100 to hold one device event fewer than launched in forty,
    # in every retake, which `timed` refuses
    train = train_phase(dev, detail, card) if want("train") else {}
    detail["train"] = train
    trained = train.get("launches", {})
    # phase 8: the parallel path (ranks sharing the card over gloo), before
    # phase 3 too, for its kernels' timing traces
    par = parallel_phase(dev, detail, card, shards) if shards else {}
    detail["parallel"] = par
    # phase 8b: sharded training (ranks sharing the card over gloo)
    par_train = par_train_phase(dev, detail, card, train_shards) if train_shards else {}
    detail["par_train"] = par_train
    k8_launches, k1_f32_decode_launches, k1_f32_tc_launches, small_f32_attn = (
        check_small_model(dev) if want("small") else (0, 0, 0, {}))
    small4 = check_small_model_int4(dev) if want("small_int4") else {}
    detail["small_int4_launches"] = small4
    none = {"launches": launch_counts()}  # all 0: a phase that --only left out
    served = served_d = served_p = served_q = served_k89 = served_4 = none
    served_f8 = served_f4 = none
    served_spec: dict = {}
    ppl: dict = {}
    if want("serve") or want("serve_prefill") or want("serve_int8") or want("serve_spec") \
            or want("ppl"):
        cfg, params = make_7b_params(dev, n_layers=SERVE_7B_LAYERS)
        # phase 4: the bf16 cache on 4 slots; phase 4b: the int8 cache on 8
        if want("serve"):
            served = serve(dev, cfg, params, slots=4, n_jobs=8,
                           rise=("dequant_matmul", "dequant_matmul_tc",
                                 "dequant_matmul_decode_tc", "flash_attention",
                                 "flash_attention_decode_tc"))
            gc.collect()  # the phase 4 engine and its cache
            torch.cuda.empty_cache()
        if want("serve_prefill"):
            # phase 4d: long prompts, the default routes and then the opt-in ones
            served_d = serve(dev, cfg, params, slots=4, n_jobs=8, long_jobs=4,
                             rise=("dequant_matmul", "dequant_matmul_tc",
                                 "dequant_matmul_decode_tc", "flash_attention",
                                 "flash_attention_decode_tc"))
            gc.collect()
            torch.cuda.empty_cache()
            with opt_in_routes():
                served_p = serve(dev, cfg, params, slots=4, n_jobs=8, long_jobs=4,
                                 rise=("dequant_matmul", "dequant_matmul_tc",
                                       "dequant_matmul_decode_tc", "flash_attention",
                                       "flash_attention_decode_tc", "flash_attention_prefill",
                                       "flash_attention_prefill_tc", "fused_rms_norm"))
            p_launches = served_p["launches"]
            if p_launches["flash_attention_prefill_tc"] != p_launches["flash_attention_prefill"]:
                raise AssertionError(f"serve, K7 on: a K7 call over the bf16 cache did not take "
                                     f"its tensor-core form: {p_launches}")
            gc.collect()
            torch.cuda.empty_cache()
        if want("serve_int8"):
            served_q = serve(dev, cfg.replace(kv_dtype="int8"), params, slots=8, n_jobs=16,
                             rise=("dequant_matmul", "dequant_matmul_tc",
                                   "dequant_matmul_decode_tc", "cache_append_quant",
                                   "flash_attention_quant_i8dot",
                                   "flash_attention_quant_i8dot_tc"))
            q_launches = served_q["launches"]
            if q_launches["flash_attention_quant_i8dot_tc"] != \
                    q_launches["flash_attention_quant_i8dot"]:
                raise AssertionError(f"serve, int8 cache: a K4 call did not take its "
                                     f"tensor-core form: {q_launches}")
            # attention_ms of a decode step holds both of K4's launches
            names = " ".join(served_q["decode_step"]["attention_kernels"])
            if "quant_partial_tc" not in names or "quant_merge" not in names:
                raise AssertionError(f"serve, int8 cache: the decode step's attention "
                                     f"kernels are {names}")
            gc.collect()
            torch.cuda.empty_cache()
            # phase 4b with K8 and K9 on: K8 takes every int8-cache attention
            # call of t <= 32, K9 every matmul of at most 256 rows (the decode
            # steps its decode form, the prefill chunks its tile), each in its
            # tensor-core form only; K1 launches nothing
            with k8_k9_routes():
                served_k89 = serve(dev, cfg.replace(kv_dtype="int8"), params, slots=8,
                                   n_jobs=8, rise=("dequant_matmul_so",
                                                   "dequant_matmul_so_decode_tc",
                                                   "dequant_matmul_so_tc",
                                                   "cache_append_quant",
                                                   "flash_attention_quant_widening",
                                                   "flash_attention_quant_widening_tc"))
            k89 = served_k89["launches"]
            if k89["flash_attention_quant_widening_tc"] != k89["flash_attention_quant_widening"] \
                    or k89["dequant_matmul_so_decode_tc"] + k89["dequant_matmul_so_tc"] \
                    != k89["dequant_matmul_so"]:
                raise AssertionError(f"serve, int8 cache, K8 and K9: a call did not take its "
                                     f"tensor-core form: {k89}")
            step = served_k89["decode_step"]
            if not {"widening_tc", "quant_merge"} <= set(step["attention_kernels"]) or \
                    not {"so_decode_tc", "so_reduce"} <= set(step["matmul_kernels"]):
                raise AssertionError(f"serve, int8 cache, K8 and K9: the decode step counted "
                                     f"{step['attention_kernels']} and {step['matmul_kernels']}")
            for key in ("attention_ms", "matmul_ms", "device_busy_ms"):
                log(f"phase 4b decode step {key}: default routes "
                    f"{served_q['decode_step'][key]:.4f} ms, K8 and K9 on {step[key]:.4f} ms")
            gc.collect()
            torch.cuda.empty_cache()
        if want("ppl"):
            # phase 4g: the perplexity subcommand's path, bf16 and f32 compute
            ppl = ppl_phase(dev, cfg, params, card)
            gc.collect()
            torch.cuda.empty_cache()
        if want("serve_spec"):
            # phase 4f: --spec over the bf16 and the int8 cache, and 1 slot
            served_spec = serve_spec(dev, cfg, params, card)
        del params
        gc.collect()  # the int8 weights, the phase 4b engine and its cache
        torch.cuda.empty_cache()
    if want("serve_int4"):
        # phase 4c: int4 weights (w4x8), the bf16 cache on 4 slots
        cfg, params = make_7b_params(dev, "int4", n_layers=SERVE_7B_LAYERS)
        served_4 = serve(dev, cfg, params, slots=4, n_jobs=8,
                         rise=("w4x8_matmul_a8", "w4x8_matmul_stream", "w4x8_matmul_tc",
                               "flash_attention", "flash_attention_decode_tc"))
        del params
        step4 = served_4["decode_step"]
        if not any(k.startswith("w4x8_a8_tc") for k in step4["matmul_kernels"]):
            raise AssertionError(f"serve, int4: the decode step's matmul_ms counted "
                                 f"{step4['matmul_kernels']}, not K5's form")
        gc.collect()
        torch.cuda.empty_cache()
    if want("serve_f32"):
        # phase 4e: the --dtype float32 route, Q8_0 and then w4x8
        served_f8 = serve_f32(dev, "int8")
        served_f4 = serve_f32(dev, "int4")
    # phase 6: the checkpoint tools, then LLaMA-3-8B from a Q8_0 GGUF
    gguf = gguf_phase(dev, card, served) if want("gguf") else {}
    detail["gguf"] = gguf
    par7 = par.get("launches_7b_cli", {})
    par70 = par.get("launches_70b", {})
    sh7 = par.get("shards_7b", {})  # K1-K4 at a 7B tp = 2 rank's shapes

    def g6(run: str, key: str) -> int:
        """A kernel's launches in one of phase 6's runs."""
        return gguf.get(run, {}).get("launches", {}).get(key, 0)
    detail["serve"], detail["serve_int8"], detail["serve_int4"] = served, served_q, served_4
    detail["serve_int8_k8_k9"] = served_k89
    detail["serve_prefill_default"], detail["serve_prefill"] = served_d, served_p
    detail["serve_f32_q8_0"], detail["serve_f32_w4x8"] = served_f8, served_f4
    detail["serve_spec"], detail["ppl"] = served_spec, ppl

    def new_paths(key, runs):
        """A kernel's launches in phase 4f's or 4g's runs."""
        return sum(r["launches"][key] for r in runs.values() if "launches" in r)
    served_f8k7 = served_f8.get("k7", none)
    # K2's and K7's f32 forms: phases 4e (Q8_0, w4x8, Q8_0 with K7 on) and 3
    k2_f32tc_launches = small_f32_attn.get("flash_attention_decode_f32tc", 0) + sum(
        r["launches"]["flash_attention_decode_f32tc"] for r in (served_f8, served_f4, served_f8k7))
    k7_f32tc_launches = (small_f32_attn.get("flash_attention_prefill_f32tc", 0)
                         + served_f8k7["launches"]["flash_attention_prefill_f32tc"])
    q4_run, so_run = small4.get("q4_0", {}), small4.get("q4_0, scale on output", {})
    so256_run = small4.get("q4_0, scale on output at 256", {})
    kernels_line = {"kernels": [
        # K1's tensor-core decode form: its launches in phases 4 and 4f, one
        # decode step at m=4
        {"name": "dequant_matmul_decode_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": served["launches"]["dequant_matmul_decode_tc"]
         + new_paths("dequant_matmul_decode_tc", served_spec), **k1dt},
        # K1's tensor-core tile: its launches in phases 4, 4f and 4g (bf16),
        # one prefill pass at m=64
        {"name": "dequant_matmul_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": served["launches"]["dequant_matmul_tc"]
         + new_paths("dequant_matmul_tc", served_spec) + new_paths("dequant_matmul_tc", ppl),
         **k1tc},
        # K1's decode form on f32 x's three bf16 parts runs f32 x up to 8
        # rows, which phases 3 and 4e (Q8_0) drive; one decode step at m=4
        {"name": "dq_decode_f32tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": k1_f32_decode_launches
         + served_f8["launches"]["dequant_matmul_f32_decode_tc"], **k1},
        # K1's tile on f32 x's three bf16 parts: its launches in phases 3
        # (the dense cache's f32 run), 4e (Q8_0) and 4g (f32), one prefill
        # pass at m=64
        {"name": "dequant_matmul_f32_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": k1_f32_tc_launches + served_f8["launches"]["dequant_matmul_f32_tc"]
         + new_paths("dequant_matmul_f32_tc", ppl), **k1f32},
        # K2's tensor-core form (bf16 cache): its launches in phases 4 and
        # 4f, one decode step at b=4, full fill
        {"name": "flash_attention", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode.cu",
         "replaces": "llamago_tpu/ops/attention.py:230",
         "launches": served["launches"]["flash_attention_decode_tc"]
         + new_paths("flash_attention_decode_tc", served_spec), **k2},
        # K2's f32 form (3xTF32): its launches in phases 4e and 3, one
        # decode step at b=4, full fill
        {"name": "flash_attention_decode_f32tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode.cu",
         "replaces": "llamago_tpu/ops/attention.py:230",
         "launches": k2_f32tc_launches, **k2f32},
        {"name": "cache_append_quant", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/cache_append.cu",
         "replaces": "llamago_tpu/ops/cache_write.py:63",
         "launches": served_q["launches"]["cache_append_quant"]
         + new_paths("cache_append_quant", served_spec), **k3},
        # K4's tensor-core form: its launches in phases 4b (every K4 call
        # there) and 4f (the int8 cache), one decode step at b=8, full fill
        {"name": "flash_attention_quant_i8dot", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode_quant.cu",
         "replaces": "llamago_tpu/ops/attention.py:406",
         "launches": served_q["launches"]["flash_attention_quant_i8dot_tc"]
         + new_paths("flash_attention_quant_i8dot_tc", served_spec), **k4},
        # K8's tensor-core form (bf16 q): its launches in phase 4b with K8
        # and K9 on, one decode step at b=8, full fill
        {"name": "flash_attention_quant_widening_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode_quant.cu",
         "replaces": "llamago_tpu/ops/attention.py:342",
         "launches": served_k89["launches"]["flash_attention_quant_widening_tc"], **k8tc},
        # K8's CUDA-core form runs f32 q, which phase 3 drives; one decode
        # step at b=8, full fill, f32 q
        {"name": "flash_attention_quant_widening", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode_quant.cu",
         "replaces": "llamago_tpu/ops/attention.py:342",
         "launches": k8_launches, **k8},
        # K5's int8 tensor-core decode form: every call in phase 4c of at most
        # 16 rows, one decode step at m=4
        {"name": "w4x8_matmul_a8_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/w4x8_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:308",
         "launches": served_4["launches"]["w4x8_matmul_a8"], **k5},
        # K6's tile on f32 x's three bf16 parts: its launches in phases 3 (the
        # w4x8 model) and 4e (w4x8), one prefill pass at m=64
        {"name": "w4x8_matmul_f32_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/w4x8_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:334",
         "launches": small4.get("w4x8", {}).get("w4x8_matmul_f32_tc", 0)
         + served_f4["launches"]["w4x8_matmul_f32_tc"], **k6},
        # K6's tensor-core tile: its launches in phase 4c, one prefill pass at m=64
        {"name": "w4x8_matmul_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/w4x8_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:334",
         "launches": served_4["launches"]["w4x8_matmul_tc"], **k6tc},
        # K9's tensor-core decode form (bf16 x): its launches in phase 4b with
        # K8 and K9 on, one decode step at m=4, Q8_0
        {"name": "dequant_matmul_so_decode_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul_so.cu",
         "replaces": "llamago_tpu/ops/kernels.py:183",
         "launches": served_k89["launches"]["dequant_matmul_so_decode_tc"], **k9tc},
        # K1 bits=4 and K9's decode form on f32 x's parts run in the Q4_0
        # format, which phase 3 drives; their numbers one decode step at
        # m=4, f32 x (K1's: its f32_decode_tc form)
        {"name": "dequant_matmul_q4", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": q4_run.get("dequant_matmul_q4", 0), **k1q4},
        {"name": "so_decode_f32tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul_so.cu",
         "replaces": "llamago_tpu/ops/kernels.py:183",
         "launches": so_run.get("dequant_matmul_so_f32_decode_tc", 0), **k9},
        # K9's tensor-core tile (bf16 x): its launches in phase 4b's prefill
        # with K8 and K9 on (the switch at 256), one prefill pass at m=64, Q8_0
        {"name": "dequant_matmul_so_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul_so.cu",
         "replaces": "llamago_tpu/ops/kernels.py:183",
         "launches": served_k89["launches"]["dequant_matmul_so_tc"], **k9tile},
        # K9's tile on f32 x's three bf16 parts: its launches in phase 3's Q4_0
        # run with the switch at 256, one prefill pass at m=64, Q4_0
        {"name": "dequant_matmul_so_f32_tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul_so.cu",
         "replaces": "llamago_tpu/ops/kernels.py:183",
         "launches": so256_run.get("dequant_matmul_so_f32_tc", 0), **k9tile32},
        {"name": "flash_attention_prefill", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_prefill.cu",
         "replaces": "llamago_tpu/ops/attention.py:577",
         "launches": served_p["launches"]["flash_attention_prefill_tc"]
         + new_paths("flash_attention_prefill_tc", ppl), **k7},
        # K7's f32 tensor-core form: its launches in phases 4e (Q8_0, K7 and
        # K10 on), 4g (f32, K7 and K10 on) and 3, one 256-token pass at 512
        {"name": "flash_attention_prefill_f32tc", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_prefill.cu",
         "replaces": "llamago_tpu/ops/attention.py:577",
         "launches": k7_f32tc_launches + new_paths("flash_attention_prefill_f32tc", ppl),
         **k7f32},
        {"name": "fused_rms_norm", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/rms_norm.cu",
         "replaces": "llamago_tpu/ops/kernels.py:599",
         "launches": served_p["launches"]["fused_rms_norm"]
         + new_paths("fused_rms_norm", ppl), **k10},
        # LLaMA-3-8B from a GGUF (phase 6): K1's decode form and tile, K2
        # (g = 4), K3 (KV = 8) and K4 (g = 4), each with phase 2's numbers at
        # LLaMA-3's shapes (a decode step at m=4 or full fill, a prefill
        # pass at m=64) and its launches in phase 6's serving; K1's tile on
        # f32 x with its launches in phase 6's f32 forward
        {"name": "dequant_matmul_decode_tc@llama3-8B", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": g6("bf16", "dequant_matmul_decode_tc")
         + g6("int8", "dequant_matmul_decode_tc"), **l3.get("k1_decode", {})},
        {"name": "dequant_matmul_tc@llama3-8B", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": g6("bf16", "dequant_matmul_tc") + g6("int8", "dequant_matmul_tc"),
         **l3.get("k1_tile", {})},
        {"name": "dequant_matmul_f32_tc@llama3-8B", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": gguf.get("f32_launches", {}).get("dequant_matmul_f32_tc", 0),
         **l3.get("k1_f32_tile", {})},
        {"name": "flash_attention@llama3-8B", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode.cu",
         "replaces": "llamago_tpu/ops/attention.py:230",
         "launches": g6("bf16", "flash_attention_decode_tc"), **l3.get("k2", {})},
        {"name": "cache_append_quant@llama3-8B", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/cache_append.cu",
         "replaces": "llamago_tpu/ops/cache_write.py:63",
         "launches": g6("int8", "cache_append_quant"), **l3.get("k3", {})},
        {"name": "flash_attention_quant_i8dot@llama3-8B", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode_quant.cu",
         "replaces": "llamago_tpu/ops/attention.py:406",
         "launches": g6("int8", "flash_attention_quant_i8dot_tc"), **l3.get("k4", {})},
        # the parallel path (phase 8): each form's launches summed over both
        # ranks of the CLI's --tp 2 server and of the 7B setups (K1, K2, K3,
        # K4 with their numbers at a 7B tp = 2 rank's shapes), and of
        # LLaMA-2-70B at tp = 2 (K5, K6 and K2 at g = 8, with their numbers
        # at a rank's shapes)
        *({"name": name if "@" in name else f"{name}@parallel", "route": "cuda",
           "source": f"llamago_tpu_torch/csrc/{source}.cu", "replaces": replaces,
           "launches": counts.get(counter, 0), **numbers}
          for name, source, replaces, counts, counter, numbers in (
              ("dequant_matmul_decode_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               par7, "dequant_matmul_decode_tc", sh7.get("k1_decode", {})),
              ("dequant_matmul_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               par7, "dequant_matmul_tc", sh7.get("k1_tile", {})),
              ("dq_decode_f32tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               par7, "dequant_matmul_f32_decode_tc", sh7.get("k1_f32_decode", {})),
              ("dequant_matmul_f32_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               par7, "dequant_matmul_f32_tc", sh7.get("k1_f32_tile", {})),
              ("flash_attention", "attn_decode", "llamago_tpu/ops/attention.py:230",
               par7, "flash_attention_decode_tc", sh7.get("k2", {})),
              ("flash_attention_decode_f32tc", "attn_decode", "llamago_tpu/ops/attention.py:230",
               par7, "flash_attention_decode_f32tc", sh7.get("k2_f32", {})),
              ("cache_append_quant", "cache_append", "llamago_tpu/ops/cache_write.py:63",
               par7, "cache_append_quant", sh7.get("k3", {})),
              ("flash_attention_quant_i8dot", "attn_decode_quant",
               "llamago_tpu/ops/attention.py:406", par7, "flash_attention_quant_i8dot_tc",
               sh7.get("k4", {})),
              ("w4x8_matmul_a8_tc@parallel-70B", "w4x8_matmul", "llamago_tpu/ops/kernels.py:308",
               par70, "w4x8_matmul_a8", par.get("k5", {})),
              ("w4x8_matmul_tc@parallel-70B", "w4x8_matmul", "llamago_tpu/ops/kernels.py:334",
               par70, "w4x8_matmul_tc", par.get("k6", {})),
              ("flash_attention@parallel-70B", "attn_decode", "llamago_tpu/ops/attention.py:230",
               par70, "flash_attention_decode_tc", par.get("k2", {})))),
        # the sharded training path (phase 8b): each form's launches summed
        # over both ranks' check and timed steps of the three 7B setups, with
        # the numbers at a 7B tp = 2 rank's training shapes (K1's tile over
        # one forward of the rank's blocks at 512 rows, K7 one call a layer
        # over the rank's 16 heads and the 256-token window)
        *({"name": f"{name}@train-parallel", "route": "cuda",
           "source": f"llamago_tpu_torch/csrc/{source}.cu", "replaces": replaces,
           "launches": par_train.get("launches", {}).get(counter, 0),
           **par_train.get(key, {})}
          for name, source, replaces, counter, key in (
              ("dequant_matmul_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               "dequant_matmul_tc", "k1_bfloat16"),
              ("dequant_matmul_f32_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               "dequant_matmul_f32_tc", "k1_float32"),
              ("flash_attention_prefill", "attn_prefill", "llamago_tpu/ops/attention.py:577",
               "flash_attention_prefill_tc", "k7_bfloat16"),
              ("flash_attention_prefill_f32tc", "attn_prefill",
               "llamago_tpu/ops/attention.py:577", "flash_attention_prefill_f32tc",
               "k7_float32"))),
        # the lab's nine kernels, launches counted in the lab's run (phase 5)
        *(lab.get(wrapper, {"name": wrapper, "launches": 0})
          for _, wrapper, *_ in LAB_KERNELS),
        # the training path (phase 7): each form's launches over the training
        # steps of 7a, 7b and 7c (forward and remat recomputation; the
        # backward is plain PyTorch); K1's tile with its numbers over one
        # forward of the 7B step at m = 2048 (bf16 x, and f32 x on its three
        # bf16 parts), the other forms with phase 2's numbers
        *({"name": f"{name}@train", "route": "cuda",
           "source": f"llamago_tpu_torch/csrc/{source}.cu", "replaces": replaces,
           "launches": trained.get(counter, 0), **numbers}
          for name, source, replaces, counter, numbers in (
              ("dequant_matmul_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               "dequant_matmul_tc", train.get("k1_rows", {}).get("bfloat16", {})),
              ("dequant_matmul_f32_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               "dequant_matmul_f32_tc", train.get("k1_rows", {}).get("float32", {})),
              ("dequant_matmul_decode_tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               "dequant_matmul_decode_tc", k1dt),
              ("dq_decode_f32tc", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               "dequant_matmul_f32_decode_tc", k1),
              ("dequant_matmul_q4", "dequant_matmul", "llamago_tpu/ops/kernels.py:237",
               "dequant_matmul_q4", k1q4),
              ("w4x8_matmul_a8_tc", "w4x8_matmul", "llamago_tpu/ops/kernels.py:308",
               "w4x8_matmul_a8", k5),
              ("w4x8_matmul_tc", "w4x8_matmul", "llamago_tpu/ops/kernels.py:334",
               "w4x8_matmul_tc", k6tc),
              ("w4x8_matmul_f32_tc", "w4x8_matmul", "llamago_tpu/ops/kernels.py:334",
               "w4x8_matmul_f32_tc", k6),
              ("flash_attention", "attn_decode", "llamago_tpu/ops/attention.py:230",
               "flash_attention_decode_tc", k2),
              ("flash_attention_decode_f32tc", "attn_decode", "llamago_tpu/ops/attention.py:230",
               "flash_attention_decode_f32tc", k2f32),
              ("flash_attention_prefill", "attn_prefill", "llamago_tpu/ops/attention.py:577",
               "flash_attention_prefill_tc", k7),
              ("flash_attention_prefill_f32tc", "attn_prefill",
               "llamago_tpu/ops/attention.py:577", "flash_attention_prefill_f32tc", k7f32))),
    ]}
    keys = ("served_tokens_per_s", "ttft_ms_p50", "ttft_ms_p95",
            "ttft_ms_p50_by_prompt_tokens", "peak_gib")
    prefill_keys = ("host_ms", "device_busy_ms", "matmul_ms", "matmul_share_of_busy",
                    "attention_ms")
    step_keys = ("device_busy_ms", "matmul_ms", "attention_ms", "device_kernels_per_step",
                 "host_op_calls_per_step")
    serving_line = {"serving": {
        name: {**{k: run.get(k) for k in keys},
               "prefill_chunk": {t: {k: p[k] for k in prefill_keys}
                                 for t, p in run.get("prefill_chunk", {}).items()},
               "decode_step": {k: run.get("decode_step", {}).get(k) for k in step_keys}}
        for name, run in (("4: 48-token prompts, default routes", served),
                          ("4d: half 600-token prompts, default routes", served_d),
                          ("4d: half 600-token prompts, K7 and K10 on", served_p),
                          ("4b: int8 cache, 8 slots, default routes", served_q),
                          ("4b: int8 cache, 8 slots, K8 and K9 on", served_k89),
                          ("4c: int4 (w4x8), 48-token prompts", served_4),
                          ("4e: f32 compute, Q8_0, one 600-token prompt", served_f8),
                          ("4e: f32 compute, Q8_0, K7 and K10 on", served_f8k7),
                          ("4e: f32 compute, w4x8, one 600-token prompt", served_f4),
                          ("6: LLaMA-3-8B Q8_0 GGUF, bf16 cache, 4 slots", gguf.get("bf16", {})),
                          ("6: LLaMA-3-8B Q8_0 GGUF, int8 cache, 8 slots",
                           gguf.get("int8", {})))}}
    spec_keys = ("served_tokens_per_s", "ttft_ms_p50", "ttft_ms_p95", "verify_steps",
                 "accepted_drafts_per_verify_step")
    serving_line["serving"].update({
        f"4f: greedy, {name}": {**{k: run[k] for k in spec_keys},
                                "verify_step": {k: run["verify_step"].get(k)
                                                for k in ("step_ms", *step_keys)}}
        for name, run in served_spec.items() if name != "window"})
    if served_spec:
        serving_line["serving"]["4f: verify window vs single steps"] = served_spec["window"]
    ppl_line = {"perplexity": {name: {k: run[k] for k in (
        "nll", "plain_nll", "rel_diff", "logit_diff", "ppl",
        "seconds_per_window", "tokens_per_s")}
        for name, run in ppl.items()}}
    gguf_line = {"gguf": {
        **{k: gguf.get(k) for k in ("card", "vocab", "file_bytes", "write_s", "read_s", "load_s",
                                    "load_peak_gib", "f32_forward_64_vs_plain")},
        "small_models_card_vs_cpu": {what: run["logit_err"]
                                     for what, run in gguf.get("small", {}).items()}}}
    t7 = train.get("7B", {})
    gate = train.get("gate", {})
    train_line = {"train": {
        "7B QLoRA step": {k: t7.get(k) for k in (
            "config", "batch", "seq", "ms_per_step", "train_tokens_per_s", "peak_gib", "losses",
            "device_busy_ms", "device_busy_share", "matmul_ms", "backward_dequant_matmul_ms")},
        "7B f32 step": {k: t7.get("f32_step", {}).get(k) for k in ("ms", "loss")},
        "7B first 4 layers vs plain": t7.get("check_4_layers"),
        "small steps vs plain and CPU": {what: run["errors"]
                                         for what, run in train.get("small", {}).items()},
        "finetune": {k: train.get("cli", {}).get(k) for k in ("finetune_s", "tokens",
                                                              "logit_err")},
        "quality gate": {**{k: gate.get("result", {}).get(k) for k in (
            "ppl", "ppl_delta_vs_fp32", "gate_int4_pass", "gate_kv_int8_pass", "fused",
            "eval_tokens", "train_steps")},
            **{k: gate.get(k) for k in ("seconds", "cpu_fp32_ppl", "fp32_card_vs_cpu",
                                        "candidate_defaults")}},
        "card": card}}
    detail["kernels"] = kernels_line
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)
    if only is not None:
        log(f"ran only {sorted(only)}: no result lines")
        return 0
    if any(k["launches"] == 0 for k in kernels_line["kernels"]):
        raise AssertionError(f"a kernel was never launched on its path: {kernels_line}")
    print(json.dumps({"ptxas_spills": spills}))
    print(json.dumps(serving_line))
    print(json.dumps(ppl_line))
    print(json.dumps(gguf_line))
    print(json.dumps(train_line))
    print(json.dumps({"parallel": {
        "note": "ranks share one card and talk over gloo: a bring-up, not two cards",
        "card": card, "cli": {k: par["cli"][k] for k in ("outputs_equal", "embedding_err")},
        "7B vs world size 1": {k: {"logit_err": v["logit_err"],
                                   "tokens_equal_world_1": v["tokens_equal_world_1"]}
                               for k, v in par["7b"].items()},
        "7B f32 int8 cache witness": par["7b_int8_f32_witness"],
        "70B tp2": [{k: r.get(k) for k in ("weights_gib", "gib_with_cache", "peak_gib",
                                           "load_s", "serve_s", "step_host_ms",
                                           "step_collectives", "serve_collectives")}
                    | {"device_busy_ms": r["profile"]["device_busy_ms"],
                       "device_kernels_per_step": r["profile"]["device_kernels_per_step"],
                       "host_op_calls_per_step": r["profile"]["host_op_calls_per_step"]}
                    for r in par["70b"]]}}))
    print(json.dumps({"parallel_training": {
        "note": "ranks share one card and talk over gloo: a bring-up, not two cards",
        "card": card, "config": (f"7B Q8_0 at full width, {PAR_TRAIN['layers']} of 32 "
                                 f"layers, LoRA rank 8, {PAR_TRAIN['batch']} x "
                                 f"{PAR_TRAIN['seq']} tokens, remat, K7 on"),
        "world size 1": {k: par_train["world1"][k] for k in (
            "ms_per_step", "peak_gib", "device_busy_share")},
        **{name: {"f32": par_train[name]["float32"], "bf16": par_train[name]["bfloat16"],
                  "by_rank": [{k: t[k] for k in ("ms_per_step", "collectives_per_step",
                                                 "collective_host_share", "peak_gib",
                                                 "device_busy_share")}
                              for t in par_train[name]["timed"]]}
           for name, _, _ in PAR_TRAIN_SETUPS},
        **{f"dense {name}": {k: par_train[f"dense {name}"][k] for k in ("grads_err", "loss_err")}
           for name, _ in PAR_DENSE_SETUPS},
        "cli": {k: par_train["cli"][k] for k in ("ppl_one", "ppl_tp2", "ppl_sp2", "finetune_s",
                                                 "side_by_side_s", "dryrun")},
        "seconds": {k: par_train[k] for k in ("shards_s", "ranks_s", "world1_s", "cli_s")}}}))
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
