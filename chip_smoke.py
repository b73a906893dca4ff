#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed). They run
in the order 1-5, 7, 13, 16a, 19, 10a, 8, 6, 10b, 11, 12, 14, 15, 16b-c, 17,
18, 20, 21:
phases 7, 13, 16a, 10a and 8 run while phase 6's GGUF, phase 11's inputs,
phase 12's, phase 14's, phase 15's, phase 16b's, phase 17's and phase 18's
GGUFs build in nine child processes. Phase 9 runs inside each of phases 4,
6, 7, 12, 14, 15 and 18, on that path's engine; phase 10b inside phase 6,
on its quant weights.
Every step of the runner on its own cache replays a CUDA graph
(engine/runner.py); a step on a cache it did not make runs eagerly, the
plain version the graphs are held against.

1. Device: requires CUDA; prints the card's name and power limit; builds the
   CUDA kernels from llama_gguf_tpu_torch/csrc/ (qgemm.cu: kernels 1-3,
   kernel 4's split-K path, and the tensor-core path of kernels 5 and 6;
   moe_qmatmul.cu: kernels 5 and 6 for other layouts; qmatmul_variants.cu)
   with nvcc
   (sm_90a), one nvcc process per source, all at once, while the main
   process builds phase 2's GGUF and nine child processes phase 6's,
   phase 11's, phase 12's, phase 14's, phase 15's, phase 16b's, phase
   17's and phase 18's two.
2. Dense model: builds the synthetic TinyLlama-1.1B at the Q4_K_M mix (full
   width and depth: 22 layers, hidden 2048, ffn 5632, vocab 32000; random
   weights from a seed), cached under .cache/chip_smoke/, and loads it with
   Engine.load on CUDA in "quant" mode (kernels) and in "dequant" mode
   (dense f32 torch.matmul), the two loads at once on two threads (every
   path since PR 14, load_both).
3. Dense kernels: each of the q4, q8 and GLU kernels' wrappers on the card,
   on the loaded model's own weights (the main path's shapes) at 1, 8, 128
   (the prompt's bucket) and 512 rows, each on the path
   ops/qmatmul.qmatmul_plan picks (split-K or tensor cores; the GLU's plan
   with glu=True), against its
   plain PyTorch version (limit: max |y - y_plain| <= 2e-4
   * max |y_plain|; f32 with another order of summation); and again with the
   same weights' panels rounded to bf16, in "default" precision (bf16
   outputs; limit: |y - y_plain| <= one bf16 ulp of |y_plain| + 2e-4 * max
   |y_plain|, since both round the same f32 sums, taken in another order,
   once). Times, L2 flushed before every launch: the kernel, its plain
   version, and torch.matmul on the pre-dequantized f32 weight (a yardstick
   the port never calls); plus the least time the card could take for the
   same work: bytes over the memory rate, or the operations over the peak of
   the units that run them (bf16 passes on the tensor cores for the
   tensor-core path, three for f32 outputs and two for bf16 ones; f32 on
   the CUDA cores otherwise; the f32 bound is kept
   beside it for every case of kernels 1-3), its share of the kernel's
   time, and the path and split of K. The timer flushes L2 by a read and
   sleeps on the device before its first event (utils/timing.py).
4. Dense main path: launch counters and the runner's count of eager steps
   set to 0, then Engine.generate (about 100 prompt tokens, 32 new tokens,
   greedy); no step may have run eagerly (every one replayed a graph, whose
   launches the runner credits per replay), and each kernel must have
   launched exactly its per-step count (q4 44, GLU 22, q8 23) times the
   steps run. Tokens and text must equal the dequant-mode engine's (its
   steps graphed too) and the prefill logits must agree within 1e-3.
5. Where the dense decode step's time goes: torch.profiler over 16 decode
   steps (wall and device time per step, the device's idle share, kernels
   and host launch calls per step, device time by kernel: kernels 1-2 by
   format and path, the GLU by path), in three modes: the engine's loop on
   graphs ("graphed"), the same loop eager ("eager"), and greedy_decode
   ("greedy": replays chained on the device).
6. Sparse MoE: builds Mixtral-8x7B at full width cut to 2 of 32 layers
   ("mixtral-8x7b-l2": hidden 4096, 32/8 heads, 8 experts of ffn 14336,
   top-2; Q4_K attention and gate/up experts, Q6_K down experts, embedding
   and LM head), loads it in both modes, and holds the q4 and q8 kernels
   against their plain versions on this path's own projections (layer 0's
   fused QKV and o_proj, the LM head) at 1 and 128 rows, and the three MoE
   kernels on layer 0's own expert stacks: slot-major (kernel 4, split-K,
   ops/qmatmul.moe_slot_plan) at 2 slots (two experts, and one expert
   twice) on the gate and the down stack, grouped (kernel 5, down) and
   grouped GLU (kernel 6, gate|up; moe_glu_grouped_plan) at the 256 slots
   of the prompt's own routing and at an imbalanced routing (one expert
   takes half of the slots, one none), in "highest" and in "default"
   precision (bf16 outputs, limits as in phase 3); each on the path its
   plan picks, which must be split-K for kernel 4 and the tensor cores for
   kernels 5 and 6. Times as in phase 3 (the bound on the path's units,
   the f32 CUDA-core bound beside it; a grouped wrapper's time includes
   the dispatch plan's torch ops, and the launch alone on that plan is
   kept beside it as launch_ms); the MoE yardstick is torch.bmm over each
   routed expert's pre-dequantized f32 weight once, its own slots' rows
   padded to the busiest expert's count. Then the MoE main path: counters
   set to 0, Engine.generate as in phase 4, exact launch counts
   (MOE_PER_LAYER), every launch of kernels 4-6 on the path named in
   MOE_PATHS (the wrappers count launches by path), no eager step, tokens,
   text and prefill logits against the dequant-mode engine, and decode
   profiles as in phase 5.
7. The serving configuration: the same TinyLlama-1.1B GGUF through
   load_model(scale_dtype="bfloat16") (bf16 scale and min panels) and
   ModelRunner(matmul_precision="default", kv_format="bf16") into an Engine;
   its weight bytes per decode step and their bound. Counters set to 0, then
   Engine.generate as in phase 4 with exact launch counts and no eager
   step. Oracle: the same
   loaded weights with their panels upcast to f32 (exact) in "highest" with
   an f32 KV cache. The logits of the prefill and of 31 decode steps, the
   serving path fed the oracle's greedy tokens, each within the tolerance
   of SERVING_ROUNDINGS_PER_LAYER (below); the serving path's own greedy
   tokens equal the oracle's up to its first step whose top-2 margin is
   under that tolerance. Prefill and decode rates and decode profiles as
   in phase 5.
8. Kernel 7, the dequant-matmul variant probe
   (llama_gguf_tpu_torch.scripts.bench_kernel_variants) for q4 and q8 at
   its two Llama-3-8B FFN shapes: counters set to 0, the probe's own run
   (its gates and its interleaved times), counts read; then every variant's
   kernel against its plain version on the same inputs (v7, v9, v10 exactly:
   integers written as f32; the others within 2e-4 * max |y_plain|, and v0,
   v1 as phase 3's bf16 limit) with kernel, plain and library times, each
   beside its kernel path and its split of K. The probe's launches are exact
   (136 / 92 / 176 / 46 for variant_f32 / _bf16 / _int8 / _w4a8).
9. Graphs against eager, on each of the three paths (phases 4, 6, 7): the
   prefill and 32 decode steps replayed as graphs against the same steps
   eager, greedy on each side's own logits (tokens equal, logits within
   REL_LIMIT * max |logit|; the largest difference is printed); greedy_decode
   of GREEDY_STEPS from the prompt, across the 256 read bucket, graphed
   against eager (tokens equal); each runner's graph keys, capture seconds
   and pool memory; and the CLI's bench (prefill and greedy-decode tok/s,
   llama_gguf_tpu_torch.cli.bench). On TinyLlama-1.1B also a ragged batch:
   B = 8, seven rows of the prompt and one of LONG_ROW tokens, 32 greedy
   steps on the two-tier bound (256, 1024, 1) graphed against the same
   batch eager at the single bound 1024; each row's tokens equal up to its
   first step whose top-2 margin is under 1e-3 * max |logit|.

10. The server and continuous batching (engine/batched.py, server/app.py,
   client.py). 10a, TinyLlama-1.1B at full width: run_server on the
   ServerConfig of `serve MODEL --max-batch SERVE_BATCH --prefill-chunk
   SERVE_CHUNK` (its warm-up capturing two graph keys at load) on a free
   port in a thread;
   launch counters and eager steps set to 0; then 12 client threads, each
   one request through RemoteChatClient: 8 greedy /v1/completions of
   SERVE_TOKENS tokens from prompts of 16-96 token ids, 2 streamed
   /v1/chat/completions, 1 completion from a SERVE_LONG-token prompt (its
   chunks ride in mixed steps) and 1 /v1/embeddings. Gates: every request
   finishes "stop" or "length"; each greedy answer's tokens equal the
   single-stream steps' (Engine's prefill and decode_one on the unowned
   one-row cache) up to that prompt's first near tie (top-2 margin under
   1e-3 * max |logit|); each streamed chat's deltas join to its request's
   text, and its tokens equal the same chat's non-streamed tokens up to
   the first near tie; the embedding is within 1e-4 (relative) of
   extract_embedding run alone; mixed_steps > 0; no eager step; every
   launch of kernels 1-3 came from a B = 8 graph's replay (or the
   embedding's forward) and took the tensor-core path. Prints whether
   jinja2 imports, the graph keys captured while serving with their
   seconds, the pool's bytes, the burst's decode tok/s (steps that
   captured a key left out), time to first token, requests per second,
   the phase's wall time; then two steady passes (steady_passes) of 8
   greedy completions of STEADY_TOKENS tokens, the second's pure decode
   steps being the steady aggregate decode tok/s; and the device time of
   the B = 8 decode step (torch.profiler over 16 replays of each of its
   graphs, one per read bound).
   10b, Mixtral-8x7B-l2: a BatchedEngine directly on a max_batch 4 runner
   over phase 6's quant weights, 4 greedy requests, one of them from a
   200-token prompt, prefill_chunk 64. Gates: tokens equal single-stream up
   to the first near tie (logits, or routing: a top-2 vs third router
   probability margin under 1e-4); kernel 4 launched by the B = 4 decode
   graphs (8 slots); kernels 5 and 6 launched in mixed steps; no eager
   step. Then two steady passes of the 4 prompts at STEADY_MOE_TOKENS
   tokens each, as in 10a.

11. Formats (every GGUF weight format the loader keeps quantized), in three
   parts. 11a: tinyllama-1.1b-l2 (TinyLlama-1.1B's widths, 2 of 22
   layers: every kernel shape is local to a layer, and the full depth's
   loads cost the script 40 s of its time limit) at the Q2_K mix (Q2_K
   attention and gate/up, which repack to q4 with scale groups of 16;
   Q6_K ffn_down, embedding and LM head), loaded in both modes; kernels 1-3
   on its own weights as in phase 3 (1, 8, 128 and 512 rows, f32 and bf16
   panels), each q4 group-16 case on split-K below TC_MIN_ROWS rows and on
   the tensor cores from there; its weight bytes per decode step and
   their bound; the main path as in phase 4 (exact launch counts derived
   from the loaded model, no eager step, tokens and prefill logits against
   dequant mode); a greedy decode profile and the CLI's bench. 11b: tinyllama-1.1b-l2 (TinyLlama's widths,
   2 of 22 layers) at each of FORMATS_11B, loaded in both modes:
   ops/parity.kernel_parity_check with f32 and with bf16 panels (each in
   "highest" and "default" precision), then the main path as in phase 4
   with each format's exact launch counts, the prefill's launches on the
   tensor cores (Q8_K: q8 with groups of 256), quant tokens equal dequant
   tokens, prefill logits within 1e-3; Q8_K's
   qkv and gate|up also timed as in phase 3. 11c: Q2_K expert stacks at
   Mixtral-8x7B's expert shapes (Q2K_EXPERTS experts each, from seeded
   weights): kernel 4 at 2 slots, kernels 5 and 6 at 256 slots on the
   tensor cores, as in phase 6 (moe_kernel_checks), then
   ops/parity.moe_kernel_parity_check on Q2_K and Q4_K stacks.

12. The Qwen3Next hybrid path. 12a: qwen3-next-80b-a3b-l4 (Qwen3-Next-80B-
   A3B's published widths: hidden 2048, 16/2 heads of 256 with an output
   gate, partial RoPE 64 of 256; DeltaNet 16 key / 32 value heads of 128,
   conv 4; top-10 experts of ffn 512 and a gated shared expert of 512;
   cut to 4 of 48 layers, one period of 3 DeltaNet layers and 1 attention
   layer, and to 64 of 512 experts), Q4_K_M mix, loaded in both modes
   (its layer kinds printed); its weight bytes per decode step (10 routed
   experts per layer) and recurrent state, and their bound; kernels 1-3 on
   its own projections (ssm_in, the z gate, ssm_out, the fused QKV, the
   attention gate, o_proj, the shared expert's gate|up and down, the LM
   head) at 1, 8, 128 and 512 rows, and kernels 4-6 on layer 0's stacks
   at the prompt's own routing (a decode step's 10 slots, the prompt's
   960), as in phases 3 and 6; the main path as in phase 4 with exact
   launch counts derived from the loaded model (hybrid_launches_per_step),
   no eager step, quant tokens equal dequant tokens up to the first near
   tie (a logit top-2 margin under NEAR_TIE or a routing margin under
   ROUTE_TIE), prefill logits within 1e-3 of max |logit|; phase 9 on this
   path; the state gates (a second greedy run of the prompt after another
   prompt repeats the first; a decode key captured after the prompt's
   prefill replays 4 steps within REL_LIMIT of the eager steps, logits and
   state); a greedy decode profile with the delta rule's own time per
   step (CUDA events) beside kernels 1-6's; the CLI's bench. 12b: a
   BatchedEngine at max_batch 4 over 12a's quant weights, the
   HYBRID_REQUESTS prompts (8 requests, so rows are reused; two longer
   than a chunk), greedy, prefill_chunk SERVE_CHUNK: every request's
   tokens equal the single-stream steps' up to its first near tie, no
   eager step, kernels 4-6 launched, then two steady passes of 4 requests
   (the steady decode tok/s).

13. Perplexity, the prompt cache and the context shift (ROADMAP queue 1
   item 6) on phase 2's engines (quant and dequant) and phase 7's, while
   they are loaded. 13a: engine/perplexity.perplexity of PPL_TOKENS tokens
   of SURVEY.md (the model's tokenizer; 4 windows of 512 and a trailing one
   of 252 on its padded bucket) in each mode and the serving
   configuration, each after one warm-up pass (the captures, their seconds
   printed): no eager step, kernels 1-3 launched exactly their per-step
   counts once per window, mean NLL of quant within 2e-3 * max |logit| of
   dequant (log-softmax moves by at most twice the largest logit change,
   which phase 4 holds within 1e-3 of max |logit|); prints ppl, delta ppl,
   the serving ppl (not gated) and the 512-token window rate without
   captures. 13b: an Engine with the prompt cache on the quant runner,
   prompt A (~290 tokens) then A + B, greedy, 16 tokens each (a first pass
   captures): one hit, the second prefill runs only B's tokens, its logits
   within 1e-3 * max |logit| of an uncached prefill, its tokens equal the
   uncached steps' up to the first near tie, no eager step; session files
   of f32 (this runner) and bf16 KV (phase 7's runner) saved and loaded
   with equal bytes; a BatchedEngine at B = 4 with a PromptCache, 4
   requests sharing a BATCH_PREFIX-token prefix: >= 3 hits, tokens equal
   the single-stream steps' up to each near tie, no eager step; prints a
   hit's and a miss's prefill ms. 13c: each mode's weights in a runner of
   SHIFT_SEQ positions and an Engine with the context shift, SHIFT_TOKENS
   greedy tokens from the prompt (the window passed at least twice): no
   eager step, quant tokens equal dequant's up to the first near tie, and
   after the first shift layer 0's keys at [0, 255 - n) within REL_LIMIT *
   max |k| of a fresh prefill of the kept tokens; prints ms per shift.
   13d: the CLI's sysinfo names the card. Prints the phase's wall time and
   launches (kernels 1-3, counted from its start to its end).

14. The Mamba family (models/mamba.py) through the runner's graphs and the
   batched engine. 14a: granite-4.0-h-micro-l10 (ibm-granite/granite-4.0-
   h-micro's published widths: hidden 2048, vocab 100352, 32/8 NoPE heads
   of 64, SwiGLU 8192 in every block, Mamba-2 64 heads of 64, d_state 128,
   1 group, conv 4; the four Granite multipliers; tied embeddings; cut to
   10 of 40 layers, one period of 9 Mamba-2 blocks and 1 attention block),
   Q4_K_M mix (Q4_K ssm_in, ssm_out, q/k/v/o, gate/up; Q6_K down and the
   table, which is the tied head), loaded in both modes (load seconds
   printed); its weight bytes per decode step and recurrent state, and
   their bound; kernels 1-3 on its own projections (ssm_in 2048 -> 8512,
   ssm_out, the fused QKV, o_proj, gate|up 2048 -> 2 x 8192, Q6_K down, the
   tied Q6_K head 2048 -> 100352) at 1, 8, 128 and 512 rows as in phase 3;
   the main path as in phase 4 with exact launch counts derived from the
   loaded model, no eager step, quant tokens equal dequant tokens up to
   the first near tie, prefill logits within 1e-3 of max |logit|; phase 9
   on this path; phase 12a's state gates; the decode and 128-token prefill
   keys' capture seconds and nodes (kernels one replay launches); a
   greedy decode profile, against the byte bound, beside the scan's time
   (CUDA events) launched alone at a step's shapes, so its share of the
   profiled step is an estimate from a separate timing; the CLI's bench;
   kernel 8 (the short conv) at its convs against its plain version, bit
   for bit with the windows (shortconv_checks: a decode step's identity
   map, the prefill bucket, a launch plan's row map with a spare place).
   14b: a BatchedEngine at max_batch 4 over 14a's quant weights, the
   HYBRID_REQUESTS prompts, prefill_chunk SERVE_CHUNK: every admission
   clears its row's state (recorded with no host sync; that the clear
   zeroes one row and only it is checked after the timed passes), tokens
   equal single-stream up to each near tie, no eager step, then two steady
   passes. 14c: tiny-mamba (Mamba-1), tiny-mamba2, tiny-falconh1,
   tiny-lfm2 and tiny-jamba (its MoE half on kernels 4-6) at the Q4_K_M
   mix: the main path as in 14a; every kernel it launched against its
   plain version on the preset's own weights, as in phases 3 and 6, at
   TINY_ROWS rows (kernels 1-3, each distinct projection shape), at the
   prompt's routing (kernels 4-6) and at each distinct conv (kernel 8, as
   in 14a); phase 9 with TINY_GREEDY_STEPS greedy steps; then kernel 8 at
   LFM2-24B-A2B's width over 48 cache rows (LFM2MOE_CONV: decode 48x1, a
   512-token row, plans of 4x128 and 2x512 with a spare place).

15. The DeepSeek family (multi-head latent attention over a one-head
   latent cache, DeepSeek-V3's sigmoid routing with its bias, leading
   dense layers). 15a: moonlight-16b-a3b-l2 (moonshotai/Moonlight-16B-
   A3B's published widths: vocab 163840, hidden 2048, 16 heads, a dense
   wq, kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128, rope theta 50000;
   a leading SwiGLU layer of 11264, then 64 routed experts of 1408, top-6,
   2 shared, sigmoid scoring with the correction bias, routed scale 2.446,
   renormalised; cut to 2 of 27 layers), Q4_K_M mix (Q4_K wq, kv_a, kv_b,
   o_proj, gate/up and the experts' gate/up; Q6_K dense and shared down,
   table and head; the experts' down Q5_1, its K 1408 being no multiple of
   256), loaded in both modes (load seconds printed); its weight bytes per
   decode step (6 routed experts, and the dense up-projections W_uk and
   W_uv) and their bound; the main path as in phase 4 with exact launch
   counts derived from the loaded model, no eager step, quant tokens equal
   dequant tokens up to the first near tie (a logit margin, or a 6th vs
   7th routing choice margin under ROUTE_TIE), prefill logits within 1e-3
   of max |logit|; kernels 1-3 on its own projections (wq 2048 -> 3072,
   kv_a 2048 -> 576, o_proj, gate|up 2048 -> 2 x 11264, Q6_K down, the
   shared experts' gate|up 2048 -> 2 x 2816 and down, the Q6_K head 2048
   -> 163840) at 1, 8, 128 and 512 rows as in phase 3, and kernels 4-6 on
   layer 1's stacks at its own routing (a decode step's 6 slots, the
   128-token prefill bucket's 768), as in phase 6, each on a path the main
   path took (kernel_paths records which); phase 9 on this path; a second
   greedy run repeats the first; the decode and 128-token prefill keys'
   capture seconds and nodes; a greedy decode profile against the byte
   bound; the CLI's bench; 13c's context shift on this model (4 shifts,
   quant against dequant, the shifted latents against a fresh prefill's,
   ms per shift); the CLI's `run` on its GGUF. 15b: phase 14b's
   BatchedEngine on 15a's quant weights. 15c: tiny-deepseek-v3 (low-rank
   q, a group limit), tiny-deepseek-v2-lite (softmax routing, scale 16)
   and tiny-moonlight as in 14c.
16. The KV-cache formats and the sliding-window ring (models/kv.py, plain
   torch ops beside kernels 1-3; no kernel of their own). 16a, on phase
   4's TinyLlama-1.1B weights, a new runner per format (i8, f8_e4m3,
   f8_e5m2, tq2, tq3, tq4, qjl): KV_EAGER_STEPS graphed steps against
   eager ones (tokens equal, logits within REL_LIMIT of max |logit|),
   Engine.generate with exact launch counts (44/22/23 a step) and no
   eager step, quant tokens equal dequant tokens in the format up to the
   first near tie; printed per format: the first token that parts from
   the f32 cache's, the prefill's max |dlogit| against the f32 cache's, a
   greedy profile's device ms per step against the step's byte bound
   (weights plus the cache bytes of the profiled steps' live keys; the
   bytes the step reads printed beside),
   memory_bytes and its ratio to f32. Then 13c's context shift on an i8
   cache (the requantized keys within 2 i8 steps of a fresh prefill's),
   a prompt-cache hit on an f8_e4m3 cache (logits within 1e-3 of max
   |logit| of uncached, the session file byte-equal), and phase 14b's
   batched engine on an i8 cache. 16b: gemma-3-4b-l6
   (google/gemma-3-4b-it's text_config widths: vocab 262208, hidden 2560,
   8 heads and 4 KV heads of 256, FFN 10240, window 1024 with pattern 6,
   tied embeddings; 6 of 34 layers), Q4_K_M mix, both modes at a window
   of 8192 (a ring of 2048 slots on the 5 local layers): kernels 1-3
   against their plain versions at layer 0's projections (1, 8, 128, 512
   and the ring's 1024-row chunk) and the tied Q6_K head (1-512 rows);
   the main path as in phase 4 with exact launches; the ring against the same model with
   swa_ring=False on a GEMMA_PROMPT-token prompt (three prefill chunks,
   wrapping the ring) and 64 greedy steps past the window, tokens equal,
   logits within 1e-5 of max |logit|; memory_bytes ring against full at
   32768; a greedy profile against its bound (a ring's live keys at most
   its window); the CLI's bench; phase
   14b's batched engine on the ring (chunk 512, a 1500-token prompt among
   them); the context shift's runner takes the full cache. 16c: the paged
   pool's appends, a copy-on-write fork and gathers on the card equal the
   CPU's bit for bit. Prints phase 16's seconds.
17. The encoders (models/bert.py, models/t5.py, onnx/; their GGUFs built
   in a seventh child process). 17a: bge-base-en-v1.5 (BertModel at full
   size: vocab 30522, hidden 768, 12 layers of 12 heads, FFN 3072, 512
   positions), Q4_K_M, both modes: kernels 1-2 against their plain
   versions at its qkv, o, up and down (1, 8, 512 and 4,096 rows); 32
   sequences of 8-512 tokens through BertEncoder.encode, 8 at a time, with
   exact launches derived from the loaded model; quant hidden states within
   1e-3 of max |h| of dequant's, a sequence in its batch within 1e-5 of it
   alone, Engine.embed at unit norm, /v1/embeddings over HTTP within 1e-5
   of Engine.embed and /v1/completions's 400 body; printed: sequences/s,
   tokens/s, an 8 x 512 batch's device ms against its bound. 17b:
   flan-t5-base (12 + 12 layers, d_model 768, 12 heads of 64, gated-GELU
   FFN 2048, 32 buckets, untied head), Q4_K_M, both modes: kernels 1-3 at
   its projections (1, 8, 512 rows); Engine.generate of a 512-token
   encoder input and 64 greedy steps with exact launches (the encoder,
   the cross K/V, each step) and no eager step; graphed steps against
   eager ones (tokens, 2e-4 of max |logit|), quant against dequant up to
   the first near tie (logits within 1e-3), a 16-token input after the
   512-token one equal to a fresh runner's, seeded sampling repeated, a
   stop string withheld; printed: encode and cross-K/V ms, the step's
   device ms against its byte bound, decode tok/s, capture seconds, idle
   share; the t5encoder variant's unit-norm embedding and refused
   generation; the CLI's run. 17c: the tiny preset's F32 GGUF as an ONNX
   export (onnx/export.py): Engine.load's greedy tokens equal the GGUF's,
   and its tokenizer.json round-trips. Prints phase 17's seconds.
18. The load path (native/, quant/repack_cache.py) and MoE routing beyond
   softmax-top-k (models/transformer.route, moe_layer; their GGUFs built in
   an eighth and a ninth child process). 18a: tinyllama-1.1b-l2 Q4_K_M,
   each mode loaded alone, first in a child process with
   LLAMA_GGUF_NO_NATIVE=1 and LLAMA_GGUF_NO_REPACK_CACHE=1 (the parent
   commit's load path), then cold (the native library; the quant load
   writes the sidecar), then quant from the sidecar: each load's seconds;
   the child's bulk calls all numpy, this process's all native, the
   sidecar load repacks nothing and its params equal the cold load's bit
   for bit. 18b: gpt-oss-20b-l2 (openai/gpt-oss-20b's widths: vocab
   201088, hidden 2880, 64 query and 8 KV heads of 64, 32 experts of 2880,
   top-4, window 128 on even layers, sinks, biases on q/k/v/o, the router
   and the experts, clamped SwiGLU, untied head; 2 of 24 layers; every
   2880-row tensor Q5_1, attn_output Q4_K), both modes: kernel 1 at
   o_proj and kernel 2 at qkv and the head (1-512 rows), kernels 4 and 5
   on layer 1's stacks at a decode step's 4 slots and the prompt's
   prefill bucket; Engine.generate of a ~385-token prompt with exact
   launches and no grouped GLU (the biases), quant against dequant up to
   the first near tie, phase 9, a greedy profile against the byte bound
   (4 routed experts, the biases, the head), bench, the CLI's run (a load
   from the sidecar, its seconds) and phase 14b's B = 4 batched engine.
   18c: tiny-gpt-oss, tiny-phimoe (sparsemixer) and tiny-llama4 (input-
   scaled experts, chunked and NoPE layers, a shared expert) as in 14c.
   18d: every path's quant load again, from its sidecar (those whose cold
   quant load took 0.5 s or more), each alone, beside its cold seconds;
   none repacks a tensor. Gate: no bulk call of the run went to numpy.
   Prints every load_both's seconds, phase 18's and the script's.

19. Speculative decoding (engine/speculative.py), LoRA adapters
   (models/lora.py) and LLAMA_DEBUG (utils/debug.py), on phase 4's
   TinyLlama-1.1B engines right after 16a, with tinyllama-1.1b-l2 (18a's
   GGUF) as the draft. 19a: a 230-token prompt with a repeated span,
   SPEC_TOKENS tokens in each mode: the draft model, the self-draft at the
   default exit (5 of 22 layers; its own runner over the same tensors),
   the target as its own draft, prompt lookup (8 drafts, n-grams up to 3),
   and generate_sampled at temperature 0.8 with the draft model and with
   the target as its own draft; each mode run twice, the first capturing
   its graph keys (printed with their seconds), the second timed with the
   launch counters at 0 and repeating the first's tokens. Gates: greedy
   tokens equal generate_plain_greedy's up to the first near tie; the
   same-model runs accept every draft; no eager step; every launch of
   kernels 1-3 accounted to the replays of the target's and the draft's
   graphs; the CLI's run with --draft, --self-speculative 5 and
   --prompt-lookup 8 exits 0. Printed per mode: tok/s (host clock,
   synchronized, prefills included, no capture), acceptance, tokens per
   round, ms per round split into draft, verification and host; beside
   them plain greedy_decode tok/s. 19b: a seeded adapter GGUF (rank 16,
   alpha 32, F32, llama.cpp's layout) on q, k, v, o, gate, up and down of
   all 22 layers, and its zero-B twin, built into .cache/. Gates: quant
   logits with the adapter within 1e-3 of max |logit| of dequant's with
   it, tokens equal up to the first near tie; graphed equal to eager
   (tokens, 2e-4 of max |logit|); exact launches derived from the adapted
   params, none of kernel 3 (every gate|up split); the zero-B adapter's
   tokens equal the base's up to the first near tie; after remove_lora
   the runner holds no graph, captures anew, and its replayed logits equal
   a fresh runner's over the same params bit for bit (and differ from the
   adapter's); serve --lora answers a greedy chat completion whose tokens
   equal Engine.generate's up to the first near tie; the CLI's run --lora
   exits 0. Printed: a greedy step's device ms and kernels, and bench
   tok/s, with and without the adapter. 19c, on tinyllama-1.1b-l2:
   greedy tokens with LLAMA_DEBUG on (every step eager, an embed line and
   one out line per layer and step on stdout), then off (graphs replay),
   and bench --profile's chrome trace (utils/debug.profile) holding
   kernels. Prints phase 19's seconds and the script's.

20. The parallel plans (parallel/, engine/runner.MeshRunner), last: ranks
   sharing the one card, each a process, over gloo (NCCL refuses two ranks
   on one GPU), every step eager (a CUDA graph cannot hold a gloo
   collective); the kernels were built by phase 1, before any rank spawns.
   20a: TinyLlama-1.1B (phase 2's GGUF, loaded from its repack sidecar)
   through Engine.load(mesh_model=2): kernels 1-3 on rank 0's shards
   (q|k|v by heads 1280 wide, o_proj's 1024 rows, gate|up 2 x 2816, down's
   2816 rows, the LM head's 16000 vocab columns) at 1 and 128 rows against
   their plain versions (phase 3's limits); the single-stream path's greedy
   tokens equal one rank's (tp=1) up to the first near tie, its prefill
   logits within 1e-3 of max |logit|; each rank's launches exactly phase
   4's per-step counts times the steps; the CLI's run --tp 2 exits 0.
   20b: mixtral-8x7b-l2 at tp=2 (expert parallel: 4 experts a rank):
   kernels 4-6 on rank 0's local stacks at decode (2 slots) and prefill
   (256 slots, renumbered onto the 4 local experts), q4 and q8 at their
   shard shapes; tokens equal one rank's up to the first near tie, prefill
   logits within 1e-3; each rank's launches exact (kernels 4-6 by the
   local slots of rank 0's recorded routing, which every rank shares). 20c: dp=2 x tp=2 (four ranks) on
   tinyllama-1.1b-l2: a ragged B = 4 batch through BatchedEngine (one
   prompt past bucket 512) takes a tier grouped per data shard, its greedy
   tokens equal single-stream's up to the first near tie, each rank's
   launches exact per step. 20d: ``shard`` as two processes serving a
   prompt through serve_spmd; ``cluster``'s JSON; one HealthMonitor
   check_once on the card; a world-size-1 NCCL group through the same
   code (Engine.load inside the group: graphs captured with the NCCL
   collectives, equal to eager steps, tokens equal one device's).
   Prints per rank: device, backend, wall ms per step and the collectives'
   wall ms (host clock: under gloo the host waits for each collective; a
   shared card's gloo is no figure of NCCL over NVLink), phase 20's
   seconds and the script's.
21. RAG (rag/: chunkers, HNSW, the sqlite store, the knowledge base), last,
   on phase 17's bge-base-en-v1.5 and phase 2's TinyLlama-1.1B. 21a: the
   CLI's ``rag ingest --model BGE`` over a corpus that never changes (the
   JAX package's .py files, VERDICT.md, docs/*.md), then ``rag search`` in
   each mode and ``rag ask``, in this process through cli.main: the chunk
   count equals the port's chunkers' on the same files; each stored blob
   768 float32 values of unit norm (1e-5); 32 sampled blobs equal
   Engine.embed of their text on a fresh quant engine (1e-5) and a dequant
   one (1e-3 of max |value|); kernels 1-2 launch exactly the embed forwards
   times the per-forward counts derived from the loaded model; each
   semantic hit's score is the cosine of the query with its stored vector
   (1e-5); the ann_index blob read back gives the live index's hits.
   Printed: ingest chunks/s, the embed forward's device ms (CUDA events,
   median) and host ms, the index build's seconds, HNSW recall@5 against
   brute force over 64 queries (random weights: a fact, not a gate), p50
   ms per query by mode, whether sqlite has FTS5, the embedder model's
   bytes. 21b: ``serve TINYLLAMA --rag-db FILE`` (the feature-hashing
   embedder, as JAX's server): SURVEY.md ingested over HTTP, /search and
   /query (32 tokens) in each mode (citations = /search's hits), JAX's 400
   and 503 bodies, a greedy KnowledgeBase answer equal to Engine.generate
   over the template filled from the same hits, its launches all graph
   replays (exact per step, no eager step, no capture), a chat completion
   beside a query, a hot reload after which the knowledge base generates
   with the new engine. 21c: ``download`` of a cached file prints its path
   and makes no request; ``models`` lists it. Prints phase 21's seconds and
   the script's.

Prints, on lines before the last: the card's name and power limit, each
path's prefill and decode rates, the decode profiles, phase 9's results,
phase 10's and 13's, the bench lines and one JSON object {"kernels":
[...]}. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
T_START = time.perf_counter()
# 96 tokens with the synthetic byte-fallback tokenizer (a space costs 3)
PROMPT = "The quick brown fox jumps over the lazy dog while five wizards jump."
NEW_TOKENS = 32
PER_STEP = {"qmatmul_q4": 44, "qmatmul_glu": 22, "qmatmul_q8": 23}
# Launches per MoE layer, from models/transformer.moe_layer and the dispatch
# rule of ops/qmatmul.moe_dims. A decode step routes S = 2 slots (top-2):
# below 32, so moe_qmatmul_glu declines and gate, up and down each run the
# slot-major kernel. The prefill pads the prompt to bucket 128, S = 256
# slots, C = 256, G = 1 + 8 = 9 < S: the grouped GLU (gate|up) and the
# grouped kernel (down). Fused QKV and o_proj (Q4_K) run the q4 kernel in
# either; the LM head (Q6_K) runs the q8 kernel once per step.
MOE_PER_LAYER = {
    "decode": {"moe_slot": 3, "qmatmul_q4": 2},
    "prefill": {"moe_glu_grouped": 1, "moe_grouped": 1, "qmatmul_q4": 2},
}
# The path every main-path launch of the MoE kernels takes (their plans:
# ops/qmatmul.moe_slot_plan, moe_grouped_plan, moe_glu_grouped_plan)
MOE_PATHS = {"moe_slot": "splitk", "moe_grouped": "tc",
             "moe_glu_grouped": "tc"}
MOE_SHAPE = dict(num_layers=2, hidden_size=4096, expert_ffn=14336,
                 num_experts=8, num_experts_per_token=2)
REL_LIMIT = 2e-4
MOE_PRESET, MOE_LABEL = "mixtral-8x7b-l2", "Mixtral-8x7B-l2"  # phases 6, 10b
GREEDY_STEPS = 200  # phase 9: from the 96-token prompt, across bucket 256
LONG_ROW = 700  # phase 9: the long row of the B = 8 batch (bucket 1024)
ROWS = (1, 8, 128, 512)  # 128: the main path's own prefill bucket
SERVE_BATCH = 8  # phase 10a: the server's rows
SERVE_CHUNK = 64  # phase 10: prompt tokens per batched step
SERVE_TOKENS = 48  # phase 10a: tokens per greedy completion
SERVE_LONG = 400  # phase 10a: the long completion's prompt tokens
STEADY_TOKENS = 192  # phase 10a: tokens per request of the steady passes
STEADY_MOE_TOKENS = 128  # phase 10b: the same
NEAR_TIE = 1e-3  # phases 9, 10: top-2 margin over max |logit|
ROUTE_TIE = 1e-4  # phase 10b: top-2 vs third router probability margin
MOE_ROWS = (1, 128)  # Mixtral: a decode step, the prompt's prefill bucket
# Phase 7's logit tolerance, relative to max |oracle logits|. The serving
# configuration rounds to bf16 (relative error <= 2^-9 each) every kernel
# output (4 per layer: QKV, o_proj, GLU, down), the k and v written to the
# cache (2 per layer) and the logits (1): R = 6 * layers + 1 roundings per
# forward. Taken as independent errors that reach the logits at the logits'
# own scale, they add up like a random walk: 2^-9 * sqrt(R).
SERVING_ROUNDINGS_PER_LAYER = 6
# Phase 11: the formats of tinyllama-1.1b-l2 (11b; Q2_K is 11a's),
# the q4 ones among them, and the experts of each Q2_K stack of 11c (of
# Mixtral's 8: the stacks are built and quantized on the host in a child
# process, beside the Mixtral GGUF)
FORMATS_11B = ("Q4_0", "Q4_1", "Q5_0", "Q3_K", "Q5_K", "Q8_K", "IQ4_NL",
               "IQ4_XS")
Q4_FORMATS = ("Q4_0", "Q4_1", "Q2_K", "Q4_K")
Q2K_EXPERTS = 4

# Phase 12: Qwen3-Next-80B-A3B at its published widths, 4 of 48 layers and
# 64 of 512 experts (utils/synthetic.HYBRID_MOE_PRESETS); 12b's prompt
# lengths (8 requests at B = 4, so rows are reused; two are longer than a
# chunk)
HYBRID_PRESET = "qwen3-next-80b-a3b-l4"
HYBRID_LABEL = "Qwen3-Next-80B-A3B-l4"
HYBRID_SHAPE = dict(layer_kinds=("deltanet",) * 3 + ("attn",),
                    hidden_size=2048, vocab_size=151936, heads=(16, 2, 256),
                    deltanet=(16, 32, 128, 4), experts=(64, 10, 512, 512))
HYBRID_REQUESTS = (16, 40, 96, 150, 24, 8, 200, 64)

VARIANTS_SOURCE = "llama_gguf_tpu_torch/csrc/qmatmul_variants.cu"
VARIANTS_HELPER = "scripts/bench_kernel_variants.py:124-131 (the pallas() helper"
KERNELS = {
    "qmatmul_q4": dict(
        source="llama_gguf_tpu_torch/csrc/qgemm.cu",
        replaces="llama_gguf_tpu/ops/qmatmul.py:309 (_qmatmul_call with "
                 "_q4_kernel:138)"),
    "qmatmul_q8": dict(
        source="llama_gguf_tpu_torch/csrc/qgemm.cu",
        replaces="llama_gguf_tpu/ops/qmatmul.py:309 (_qmatmul_call with "
                 "_q8_kernel:164)"),
    "qmatmul_glu": dict(
        source="llama_gguf_tpu_torch/csrc/qgemm.cu",
        replaces="llama_gguf_tpu/ops/qmatmul.py:500 (_qmatmul_glu_call with "
                 "_glu_kernel:198)"),
    "moe_slot": dict(
        source="llama_gguf_tpu_torch/csrc/qgemm.cu",
        replaces="llama_gguf_tpu/ops/qmatmul.py:564 (_moe_qmatmul_call, "
                 "pallas_call :642)"),
    "moe_grouped": dict(
        source="llama_gguf_tpu_torch/csrc/qgemm.cu",
        replaces="llama_gguf_tpu/ops/qmatmul.py:671 "
                 "(_moe_qmatmul_grouped_call, pallas_call :736)"),
    "moe_glu_grouped": dict(
        source="llama_gguf_tpu_torch/csrc/qgemm.cu",
        replaces="llama_gguf_tpu/ops/qmatmul.py:804 (_moe_glu_grouped_call, "
                 "pallas_call :861)"),
    "variant_f32": dict(
        source=VARIANTS_SOURCE,
        replaces=VARIANTS_HELPER + " with the bodies v2_noscale :282-289 and "
                 "v5_minfold :159-188)"),
    "variant_bf16": dict(
        source=VARIANTS_SOURCE,
        replaces=VARIANTS_HELPER + " with the body v6_bf16 :190-218)"),
    "variant_int8": dict(
        source=VARIANTS_SOURCE,
        replaces=VARIANTS_HELPER + " with the bodies v7_int8 :220-247, "
                 "v9_mulcost :397-410 and v10_4dot :412-427)"),
    "variant_w4a8": dict(
        source=VARIANTS_SOURCE,
        replaces=VARIANTS_HELPER + " with the body v8_w4a8 :311-387)"),
    "short_conv": dict(
        source="llama_gguf_tpu_torch/csrc/shortconv.cu",
        replaces="none: the JAX package's conv is XLA ops "
                 "(llama_gguf_tpu/models/mamba.py:84-97, shortconv_layer "
                 ":380)"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# csrc/qgemm.cu's kinds (the last template argument): bit flags GLU 1,
# GATHERED 2, SLOT 4
QGEMM_KINDS = {"1": "qmatmul_glu", "2": "moe_grouped", "3": "moe_glu_grouped",
               "4": "moe_slot"}


def kernel_key(name: str) -> str:
    """A profiler kernel name -> its kernel and path. csrc/qgemm.cu's
    qgemm_tc / qgemm_splitk: the first template argument is the format (0 =
    q4), the last the kind (QGEMM_KINDS; 0: kernels 1-2). The CUDA-core MoE
    kernels by name."""
    for kern, path in (("qgemm_tc<", "tensor cores"), ("qgemm_splitk<", "split-K")):
        if kern in name:
            args = name.split(kern, 1)[1].split(">", 1)[0].split(",")
            fmt, kind = args[0].strip(), args[-1].strip()
            if kind in QGEMM_KINDS:
                return f"{QGEMM_KINDS[kind]} {path}"
            return f"{'qmatmul_q4' if fmt == '0' else 'qmatmul_q8'} {path}"
    if "moe_grouped_kernel" in name:
        return "moe_grouped_kernel"
    return name[:60]


def profile_decode(engine, ids, steps: int = 16, mode: str = "graphed"
                   ) -> dict:
    """torch.profiler over ``steps`` single-token decode steps after a
    prefill (``summarize``). ``mode``: "graphed" (the engine's loop:
    decode_one on the runner's cache, so each step replays a graph, and the
    argmax comes back to the host), "eager" (the same loop on a cache the
    runner did not make: every step eager), "greedy" (greedy_decode: graph
    replays chained on the device)."""
    import torch

    r = engine.runner
    kv = r._make_kv(1) if mode == "eager" else r.init_kv()
    logits, kv, pos = r.prefill(ids, kv)
    tok = int(torch.argmax(logits))
    logits, kv = r.decode_one(tok, pos, kv)  # warm-up step
    pos += 1
    if mode == "greedy":  # warm-up: the graph of this bound
        r.greedy_decode([tok], [pos], kv, 1)

    def run():
        nonlocal logits, kv, pos
        if mode == "greedy":
            r.greedy_decode([tok], [pos], kv, steps)
            return
        for _ in range(steps):
            logits, kv = r.decode_one(int(torch.argmax(logits)), pos, kv)
            pos += 1

    return dict(mode=mode, **summarize(run, steps))


def profile_prefill(engine, ids, reps: int = 4, eager: bool = False) -> dict:
    """torch.profiler over ``reps`` prefills of the prompt (``summarize``),
    graphed on the runner's cache or eager on a cache it did not make."""
    r = engine.runner
    kv = r._make_kv(1) if eager else r.init_kv()
    r.prefill(ids, kv)  # warm-up (a capture on the runner's cache)
    return dict(mode="prefill eager" if eager else "prefill graphed",
                **summarize(lambda: [r.prefill(ids, kv)
                                     for _ in range(reps)], reps))


def summarize(run, steps: int) -> dict:
    """Run ``run()`` (``steps`` steps) under torch.profiler: wall time per
    step (the host clock, ended by a synchronize), device time per step (the
    sum of kernel times), the device's idle share, kernels and host launch
    calls (kernels and graphs) per step, the host's time per step in its
    costliest calls (self CPU time: what fills the device's idle time when
    the host is behind), and device time by kernel. The profiler's own
    tracing adds host time to every call, so the wall time under it is
    longer than in an unprofiled run (the bench and main-path lines)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        key = kernel_key(e.key)
        by_kernel[key] = by_kernel.get(key, 0.0) + us / 1e3 / steps
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:12]
    k12 = sum(v for key, v in by_kernel.items()
              if key.startswith(("qmatmul_q4", "qmatmul_q8")))
    k3 = {key: v for key, v in by_kernel.items()
          if key.startswith("qmatmul_glu")}
    k46 = sum(v for key, v in by_kernel.items() if key.startswith("moe_"))
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    host_top = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]
    return dict(
        steps=steps, wall_ms_per_step=wall_ms / steps,
        host_launches_per_step=sum(
            e.count for e in cpu
            if "LaunchKernel" in e.key or "GraphLaunch" in e.key) / steps,
        host_ms_per_step_by_call={
            e.key: e.self_cpu_time_total / 1e3 / steps for e in host_top},
        device_ms_per_step=device_ms if device_ms > 0 else "not measured",
        device_idle_share=(1.0 - device_ms * steps / wall_ms
                           if device_ms > 0 else "not measured"),
        kernels_launched_per_step=sum(
            e.count for e in events
            if e.device_type == DeviceType.CUDA) / steps,
        kernels_1_2_ms_per_step=k12,
        kernel_3_ms_per_step=sum(k3.values()), kernel_3_by_path=k3,
        kernels_4_6_ms_per_step=k46,
        device_ms_per_step_by_kernel=dict(top))


def build_model(preset: str, quant: str = "Q4_K", **kw) -> str:
    """The synthetic GGUF at ``quant``'s mix (Q4_K: Q4_K_M), built once into
    .cache/."""
    from llama_gguf_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    tag = "q4k" if quant == "Q4_K" else quant.lower()
    path = os.path.join(ROOT, ".cache", "chip_smoke",
                        f"{preset}-{tag}-s{SEED}.gguf")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        tmp = path + f".{os.getpid()}.tmp"
        build_synthetic_gguf(tmp, preset=preset, quant=GGMLType[quant],
                             seed=SEED, **kw)
        os.replace(tmp, path)
        log(f"built {path} in {time.perf_counter() - t0:.1f}s")
    return path


def build_formats() -> dict:
    """Phase 11's inputs, built in a child process: tinyllama-1.1b-l2 at
    the Q2_K mix and at each of FORMATS_11B, and the Q2_K expert stacks
    (``build_q2k_experts``). Returns their paths."""
    out = {}
    for fmt in ("Q2_K",) + FORMATS_11B:
        out[fmt] = build_model("tinyllama-1.1b-l2", fmt)
    out["experts"] = build_q2k_experts()
    return out


def build_q2k_experts() -> str:
    """Phase 11c's expert stacks: Q2K_EXPERTS experts of Mixtral-8x7B's
    gate, up (14336 x 4096) and down (4096 x 14336) weights, from seeded
    weights, quantized to Q2_K and repacked as the loader repacks an expert
    stack (ops/parity.expert_arrays), saved as .npz."""
    import numpy as np

    from llama_gguf_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_tpu_torch.ops.parity import expert_arrays

    path = os.path.join(ROOT, ".cache", "chip_smoke",
                        f"q2k-experts-{Q2K_EXPERTS}-s{SEED}.npz")
    if os.path.exists(path):
        return path
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    hidden, ffn = MOE_SHAPE["hidden_size"], MOE_SHAPE["expert_ffn"]
    arrays = {}
    for key, (n, k) in (("gate", (ffn, hidden)), ("up", (ffn, hidden)),
                        ("down", (hidden, ffn))):
        a = expert_arrays(rng, GGMLType.Q2_K, Q2K_EXPERTS, k, n, scale=0.02)
        for field in ("packed", "scales", "mins"):
            arrays[f"{key}.{field}"] = a[field]
    tmp = path + f".{os.getpid()}.tmp.npz"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    log(f"built {path} in {time.perf_counter() - t0:.1f}s")
    return path


def load_both(path: str, seconds: dict | None = None, **config):
    """The quant and dequant engines of ``path`` on the card (``config``:
    more EngineConfig fields), loaded at once on two threads (each load is
    host work and copies, and makes no device-wide synchronize; since PR
    14, to keep the script within its limit); each load's seconds, and the
    two's wall time under "both", go into ``seconds`` when it is given, and
    into LOADS, which the script prints at its end."""
    from concurrent.futures import ThreadPoolExecutor

    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig

    took = {}

    def load(mode):
        t0 = time.perf_counter()
        engine = Engine.load(path, EngineConfig(weight_mode=mode, **config),
                             device="cuda")
        took[mode] = time.perf_counter() - t0
        log(f"{os.path.basename(path)}: {mode} engine loaded in "
            f"{took[mode]:.1f}s")
        return engine

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        dequant = pool.submit(load, "dequant")
        engines = [load("quant"), dequant.result()]
    took["both"] = time.perf_counter() - t0
    LOADS.append(dict(gguf=os.path.basename(path), path=path, **took))
    if seconds is not None:
        seconds.update(took)
    return engines


def run_main_path(quant, deq, card: str, label: str, on_differ=None,
                  near_tie=None, logit_rel: bool = False, prompt=PROMPT,
                  prompt_tokens=(90, 128)):
    """Engine.generate of ``prompt`` (of ``prompt_tokens`` tokens) with the
    launch counters and the runner's count of
    eager steps set to 0 just before and read just after (every step must
    have replayed a CUDA graph); then quant against dequant: text, greedy
    tokens and prefill logits (within 1e-3; of max |logit| with
    ``logit_rel``). ``near_tie(ids, toks, want)``: the first step of a near
    tie; when given, the tokens need only be equal up to it (and the texts
    are then not compared). Returns (launches, decode steps, the prompt's
    ids)."""
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    greedy = SamplerConfig(temperature=0.0)
    ids = quant.tokenizer.encode(prompt)
    check(prompt_tokens[0] <= len(ids) <= prompt_tokens[1],
          f"prompt is {len(ids)} tokens")
    quant.generate(prompt, max_tokens=2, sampler=greedy)  # warm-up, uncounted
    torch.cuda.synchronize()
    Q.reset_launches()
    quant.runner.eager_steps = 0
    text = quant.generate(prompt, max_tokens=NEW_TOKENS, sampler=greedy)
    torch.cuda.synchronize()
    launches = dict(Q.LAUNCHES)
    by_path = dict(Q.LAUNCHES_BY_PATH)
    stats = quant.stats
    check(stats.generated_tokens >= 1, f"{label}: nothing generated")
    check(quant.runner.eager_steps == 0,
          f"{label}: {quant.runner.eager_steps} steps of Engine.generate ran "
          "eagerly")
    print(f"{label} main path: prefill {stats.prompt_tokens} tok @ "
          f"{stats.prefill_tps:.1f} tok/s, decode {stats.generated_tokens} "
          f"tok @ {stats.decode_tps:.1f} tok/s, launches {launches} over "
          f"1 prefill + {stats.generated_tokens} decode steps (by path: "
          f"{by_path}) | {card}", flush=True)

    want_text = deq.generate(prompt, max_tokens=NEW_TOKENS, sampler=greedy)
    toks = quant.greedy_tokens(ids, NEW_TOKENS)
    want_toks = deq.greedy_tokens(ids, NEW_TOKENS)
    check(quant.runner.eager_steps == deq.runner.eager_steps == 0,
          f"{label}: eager steps on the engines' own caches")
    if toks != want_toks and on_differ is not None:
        on_differ(ids, toks, want_toks)
    if toks != want_toks and near_tie is not None:
        tie = near_tie(ids, toks, want_toks)
        first = next(i for i, (a, b) in enumerate(zip(toks, want_toks))
                     if a != b)
        check(tie is not None and first >= tie,
              f"{label}: quant and dequant tokens differ at step {first}, "
              f"before the first near tie ({tie})")
        log(f"{label}: quant and dequant tokens first differ at step "
            f"{first}, at or after the first near tie ({tie})")
    else:
        check(text == want_text,
              f"{label}: quant text {text!r} != dequant {want_text!r}")
        check(toks == want_toks,
              f"{label}: greedy tokens differ between quant and dequant "
              "modes")
    logits = [e.runner.prefill(ids, e.runner.init_kv())[0]
              for e in (quant, deq)]
    check(tuple(logits[0].shape) == (quant.runner.cfg.vocab_size,),
          f"{label}: logits shape")
    check(bool(torch.isfinite(logits[0]).all()), f"{label}: non-finite logits")
    diff = (logits[0] - logits[1]).abs().max().item()
    limit = 1e-3 * (logits[1].abs().max().item() if logit_rel else 1.0)
    check(diff <= limit, f"{label}: prefill logits differ by {diff}")
    log(f"{label}: quant == dequant: {len(toks)} tokens, logits max diff "
        f"{diff:.2e}")
    return launches, by_path, stats.generated_tokens, ids


def decode_profiles(engine, ids) -> dict:
    """Phases 5-7's decode profile in the three modes of profile_decode
    (the graphed step beside the eager one, and greedy_decode), and the
    prompt's prefill graphed and eager."""
    out = {mode: profile_decode(engine, ids, mode=mode)
           for mode in ("graphed", "eager", "greedy")}
    for eager in (False, True):
        p = profile_prefill(engine, ids, eager=eager)
        out[p["mode"]] = p
    return out


def graph_against_eager(label: str, engine, ids, card: str,
                        greedy_steps: int = GREEDY_STEPS) -> None:
    """Phase 9 on one path: the prefill and NEW_TOKENS decode steps replayed
    as graphs against the same steps run eagerly (a cache the runner did
    not make), greedy on each side's own logits: tokens equal, logits
    within REL_LIMIT * max |logit| (expected: equal); then greedy_decode of
    ``greedy_steps`` from the prompt (GREEDY_STEPS: across the 256 read
    bucket), graphed against eager, tokens equal. Also prints the graphs'
    capture cost."""
    import torch

    r = engine.runner
    want_toks, want = step_logits(r, ids, NEW_TOKENS + 1, eager=True)
    eager0 = r.eager_steps
    toks, got = step_logits(r, ids, NEW_TOKENS + 1)
    check(r.eager_steps == eager0, f"{label}: a graphed step ran eagerly")
    check(toks == want_toks, f"{label}: graphed tokens {toks} != eager "
                             f"{want_toks}")
    rel = [((g - w).abs().max() / w.abs().max()).item()
           for g, w in zip(got, want)]
    check(max(rel) <= REL_LIMIT, f"{label}: graphed logits differ from "
                                 f"eager by {max(rel):.3g} of max |logit|")
    logits, kv, pos = r.prefill(ids, r._make_kv(1))
    first = torch.argmax(logits)[None].to(torch.int32)
    want_g, _ = r.greedy_decode(first, [pos], kv, greedy_steps)
    _, kv, _ = r.prefill(ids, r.init_kv())
    got_g, _ = r.greedy_decode(first, [pos], kv, greedy_steps)
    segments = r.plan_segments(pos, greedy_steps, r.max_seq)
    check(r.eager_steps == eager0 + greedy_steps + 1,
          f"{label}: greedy_decode on the runner's cache ran eagerly")
    check(torch.equal(got_g, want_g),
          f"{label}: graphed greedy_decode differs from eager at steps "
          f"{torch.nonzero(got_g[0] != want_g[0])[:, 0].tolist()}")
    # the host's time in one replay of the decode step's graph (its launch),
    # from an empty queue: what the engine's loop pays per token
    from llama_gguf_tpu_torch.engine.runner import read_bucket

    decode = r._graphs[(1, 1, read_bucket(len(ids) + 1, r.max_seq), False)]
    host_ms = []
    for _ in range(16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r._replay(decode)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(json.dumps({"graph_against_eager": dict(
        path=label, steps=1 + NEW_TOKENS, tokens_equal=True,
        max_logit_diff_rel=max(rel), max_logit_diff_abs=max(
            (g - w).abs().max().item() for g, w in zip(got, want)),
        greedy_steps=greedy_steps, greedy_segments=segments,
        greedy_tokens_equal=True,
        replay_host_ms_median=sorted(host_ms)[len(host_ms) // 2],
        card=card)}), flush=True)
    print(json.dumps({"graphs": dict(
        path=label, keys=len(r._graphs), pool_bytes=r.pool_bytes,
        capture_seconds=capture_times(r),
        card=card)}), flush=True)


def tiered_batch(quant, ids, card: str) -> None:
    """Phase 9, the two-tier bound: TinyLlama-1.1B at B = 8, seven rows of
    the prompt and one of LONG_ROW random tokens, prefilled in one step;
    then NEW_TOKENS greedy steps tiered (256, 1024, 1) and graphed
    (greedy_decode on a B = 8 runner over the same weights) against the same
    batch eager at the single bound hi. Each row's tokens equal up to its
    first step whose eager top-2 margin is under 1e-3 * max |logit|."""
    import numpy as np
    import torch
    from llama_gguf_tpu_torch.engine.runner import (ModelRunner, bucket_len,
                                                    pick_read_bound,
                                                    read_bucket)

    q = quant.runner
    r = ModelRunner(q.params, q.cfg, max_batch=8, max_seq=q.max_seq,
                    matmul_precision=q.matmul_precision,
                    kv_format=q.kv_format, device=q.device)
    rng = np.random.default_rng(SEED)
    rows = [ids] * 7 + [rng.integers(3, q.cfg.vocab_size,
                                     size=LONG_ROW).tolist()]
    lens = np.asarray([len(x) for x in rows], np.int32)
    t = bucket_len(int(lens.max()))
    toks = np.zeros((8, t), np.int32)
    pos = np.full((8, t), r.max_seq, np.int32)
    for i, x in enumerate(rows):
        toks[i, :len(x)] = x
        pos[i, :len(x)] = np.arange(len(x))

    def prefill(kv):
        logits, kv = r.step(toks, pos, lens, kv,
                            read_bound=read_bucket(int(lens.max()),
                                                   r.max_seq),
                            logit_positions=lens - 1)
        return torch.argmax(logits[:, 0], -1).to(torch.int32), kv

    bound = pick_read_bound(lens + NEW_TOKENS, r.max_seq)
    check(bound == (256, 1024, 1), f"tier: pick_read_bound gave {bound}")
    tok, kv = prefill(r._make_kv(8))
    tok0 = tok.clone()
    p = torch.from_numpy(lens).to(q.device)
    want, margins = [], []
    for _ in range(NEW_TOKENS):  # eager, every row at the single bound hi
        logits, kv = r.step(tok[:, None], p[:, None], p + 1, kv,
                            read_bound=bound[1])
        top2 = logits[:, 0].topk(2, -1).values
        margins.append((top2[:, 0] - top2[:, 1])
                       / logits[:, 0].abs().amax(-1))
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)
        want.append(tok)
        p = p + 1
    want = torch.stack(want, 1).cpu()
    margins = torch.stack(margins, 1).cpu()
    tok_g, kv = prefill(r.init_kv())
    check(torch.equal(tok_g, tok0), "tier: the graphed prefill's tokens")
    eager0 = r.eager_steps
    got, _ = r.greedy_decode(tok_g, lens, kv, NEW_TOKENS)
    got = got.cpu()
    check(r.eager_steps == eager0, "tier: greedy_decode ran eagerly")
    check(("greedy", 8, (256, 1024, 1, 1)) in r._graphs,
          f"tier: no tiered graph among {list(r._graphs)}")
    report = []
    for row in range(8):
        near = next((i for i in range(NEW_TOKENS)
                     if margins[row, i] < 1e-3), None)
        diff = next((i for i in range(NEW_TOKENS)
                     if got[row, i] != want[row, i]), None)
        check(diff is None or (near is not None and diff >= near),
              f"tier: row {row} differs at step {diff}, before its first "
              f"near tie ({near})")
        report.append(dict(row=row, length=int(lens[row]),
                           first_diff=diff, first_near_tie=near))
    print(json.dumps({"tiered_batch": dict(
        path="TinyLlama-1.1B", batch=8, bound=list(bound),
        steps=NEW_TOKENS, rows=report,
        capture_seconds=capture_times(r),
        card=card)}), flush=True)
    del r, kv


def bench_json(label: str, engine, card: str) -> None:
    """The CLI's bench (llama_gguf_tpu_torch.cli.bench) on a loaded engine:
    prefill and graphed greedy decode tok/s at its defaults."""
    from llama_gguf_tpu_torch.cli import bench

    print(json.dumps({"bench": dict(path=label, **bench(engine), card=card)}),
          flush=True)


def compare(name, case, y, y_plain, timer, kern, plain, library, nbytes, ops,
            peaks, op_type="f32", exact=False, **extra) -> dict:
    """Hold a kernel's result against its plain version and time all three
    (``library`` may be None). Limits: ``exact``: equal; a bf16 output: one
    bf16 ulp of |y_plain| plus REL_LIMIT * max |y_plain|; else REL_LIMIT *
    max |y_plain|."""
    import torch
    from llama_gguf_tpu_torch.ops.qmatmul import bf16_ulp
    from llama_gguf_tpu_torch.utils.timing import bound_ms

    torch.cuda.synchronize()
    check(y.shape == y_plain.shape and y.dtype == y_plain.dtype,
          f"{name} {case}: {y.dtype} {tuple(y.shape)} against the plain "
          f"{y_plain.dtype} {tuple(y_plain.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name} {case}: non-finite")
    yf, pf = y.float(), y_plain.float()
    abs_err = (yf - pf).abs().max().item()
    scale = pf.abs().max().item()
    rel_err = abs_err / scale
    if exact:
        check(torch.equal(yf, pf), f"{name} {case}: not equal, abs err "
                                   f"{abs_err:.3g}")
    elif y.dtype == torch.bfloat16:
        excess = ((yf - pf).abs() - bf16_ulp(pf)).max().item()
        check(excess <= REL_LIMIT * scale,
              f"{name} {case}: {excess:.3g} beyond one bf16 ulp")
    else:
        check(rel_err <= REL_LIMIT, f"{name} {case}: rel err {rel_err:.3g}")
    bound, bound_by = bound_ms(nbytes, ops, op_type, peaks)
    m = dict(name=name, case=case, **extra, dtype=str(y.dtype)[6:],
             max_abs_err=abs_err, max_rel_err=rel_err, ms=timer.ms(kern),
             plain_ms=timer.ms(plain),
             library_ms=timer.ms(library) if library is not None else None,
             bound_ms=bound, bound_by=bound_by, bytes=nbytes, ops=ops)
    m["bound_share"] = bound / m["ms"]
    lib = (f"{m['library_ms']:.4f}" if m["library_ms"] is not None
           else "null")
    path = extra.get("kernel_path", "")
    if "splits" in extra:
        path += f" x{extra['splits']}"
    log(f"{name:15s} {case:44s} {path:16s} "
        f"rel_err={rel_err:.2e} ms={m['ms']:.4f} "
        f"bound_ms={bound:.4f} ({bound_by}, {m['bound_share']:.1%}) "
        f"plain_ms={m['plain_ms']:.4f} library_ms={lib}")
    return m


def bf16_panels(lin):
    """The same weight with its scale and min panels rounded to bf16, as
    load_model(scale_dtype="bfloat16") stores them."""
    import dataclasses

    import torch

    return dataclasses.replace(
        lin, scales=lin.scales.to(torch.bfloat16),
        mins=lin.mins.to(torch.bfloat16) if lin.mins is not None else None)


def projection_checks(projections, rows_list, timer, peaks, path: str,
                      serving: bool = False, act: str = "silu") -> list[dict]:
    """Kernels 1-3 on a path's own projections (kernel, projection name,
    QuantLinear) at each row count of ``rows_list``, through compare(); with
    ``serving`` also with bf16 panels in "default" precision. ``act``: the
    path's GLU activation."""
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops.linear import dequantize_weight
    from llama_gguf_tpu_torch.utils.timing import bound_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    measurements = []
    modes = [("highest", False)] + ([("default", True)] if serving else [])
    for name, proj, lin32 in projections:
        glu = name == "qmatmul_glu"  # of either format
        check(glu or lin32.fmt == ("q8" if name == "qmatmul_q8" else "q4"),
              f"{proj}: unexpected layout {lin32.fmt}")
        n_out = lin32.splits[0] if glu else lin32.n
        for precision, bf16 in modes:
            lin = bf16_panels(lin32) if bf16 else lin32
            w_deq = dequantize_weight(lin)  # library yardstick's f32 weight
            w_bytes = sum(t.numel() * t.element_size()
                          for t in (lin.packed, lin.scales, lin.mins)
                          if t is not None)
            y_bytes = Q.out_dtype(precision).itemsize
            label = " bf16 panels, default" if bf16 else ""
            for rows in rows_list:
                x = torch.randn(rows, lin.k, device="cuda", generator=gen)
                nbytes = w_bytes + rows * (4 * lin.k + y_bytes * n_out)
                ops = 2 * rows * lin.k * lin.n
                # the wrapper's plan (its shapes and alignment); its bound
                # (tensor cores: three bf16 passes, two for bf16 outputs)
                # beside the f32 CUDA-core bound
                plan = Q.qmatmul_plan(rows, lin.k, n_out, lin.group, lin.fmt,
                                      sms, Q._aligned(x, lin), glu=glu)
                kpath = dict(kernel_path=plan.path, splits=plan.splits,
                             tile_rows=plan.rows,
                             bound_f32_ms=bound_ms(nbytes, ops, "f32", peaks)[0])
                if glu:
                    def kern(): return Q.qmatmul_glu(x, lin, act, precision)
                    def plain(): return Q.qmatmul_glu_plain(x, lin, act,
                                                            precision)
                else:
                    def kern(): return Q.qmatmul(x, lin, precision)
                    def plain(): return Q.qmatmul_plain(x, lin, precision)
                measurements.append(compare(
                    name, f"{path} {proj}{label} rows={rows}", kern(),
                    plain(), timer, kern, plain,
                    lambda: torch.matmul(x, w_deq), nbytes, ops, peaks,
                    op_type=plan.op_type(precision),
                    path=path,
                    projection=proj, rows=rows, k=lin.k, n=lin.n,
                    precision=precision,
                    panels="bf16" if bf16 else "f32", **kpath))
            del w_deq
    return measurements


def dense_path(card: str, timer, peaks: dict, gguf: str):
    """Phases 2-5 on TinyLlama-1.1B (``gguf``). Returns (measurements,
    launches, the quant engine, the dequant engine)."""
    quant, deq = load_both(gguf)
    cfg = quant.runner.cfg
    check((cfg.num_layers, cfg.hidden_size, cfg.vocab_size) ==
          (22, 2048, 32000), f"unexpected model shape {cfg}")

    layer = quant.runner.params["layers"][0]
    measurements = projection_checks([  # (kernel, projection, weight)
        ("qmatmul_q4", "qkv", layer["attn"]["wqkv"]),
        ("qmatmul_q4", "o_proj", layer["attn"]["wo"]),
        ("qmatmul_glu", "gate|up", layer["ffn"]["gate_up"]),
        ("qmatmul_q8", "ffn_down", layer["ffn"]["down"]),
        ("qmatmul_q8", "lm_head", quant.runner.params["output"]),
    ], ROWS, timer, peaks, "TinyLlama-1.1B", serving=True)

    launches, _, decoded, ids = run_main_path(quant, deq, card,
                                              "TinyLlama-1.1B")
    steps = 1 + decoded  # the prefill + one decode per token
    for name, per in PER_STEP.items():
        check(launches[name] == per * steps,
              f"{name}: {launches[name]} launches, expected {per} x {steps}")
    print(json.dumps({"decode_profile": decode_profiles(quant, ids)}),
          flush=True)
    graph_against_eager("TinyLlama-1.1B", quant, ids, card)
    tiered_batch(quant, ids, card)
    bench_json("TinyLlama-1.1B", quant, card)
    return measurements, launches, quant, deq


def expert_bytes(stack, experts: int) -> int:
    """Bytes of ``experts`` experts of a stack (packed, scales, mins)."""
    return experts * sum(t[0].numel() * t.element_size()
                         for t in (stack.packed, stack.scales, stack.mins)
                         if t is not None)


def choice_margin(ffn, cfg, xf) -> float:
    """The smallest margin, over the rows of ``xf``, between the k-th and
    the (k+1)-th router choice (models/transformer.route_choice: the
    softmax probabilities, DeepSeek-V3's biased sigmoid scores, or the
    logits), and under a group limit between the tg-th and (tg+1)-th group
    score. PhiMoE's sparsemixer (its top-2 picked one at a time): the
    1st-2nd and 2nd-3rd logit gaps, and each pick's distance of a score's
    relative gap from the mask threshold 2 * router_jitter_eps."""
    import dataclasses

    import torch
    from llama_gguf_tpu_torch.models import transformer as T

    k = cfg.num_experts_per_token
    choice = T.route_choice(ffn, cfg, xf)[1]
    if cfg.expert_gating_func == 3:
        top = torch.topk(choice, 3, dim=-1)
        margin = (top.values[:, :2] - top.values[:, 1:]).min().item()
        sel = choice
        for j in range(2):  # each pick masks by the gap to its own max
            m = sel.max(dim=-1, keepdim=True).values
            gap = (m - sel) / torch.maximum(choice.abs(), m)
            near = (gap - 2.0 * cfg.router_jitter_eps).abs()
            margin = min(margin, near[torch.isfinite(gap)].min().item())
            sel = sel.scatter(1, top.indices[:, j:j + 1], -torch.inf)
        return margin
    top = torch.topk(choice, k + 1, dim=-1).values
    margin = (top[:, k - 1] - top[:, k]).min().item()
    ng, tg = cfg.expert_group_count, cfg.expert_group_used_count
    if cfg.expert_gating_func == 2 and 1 < ng and 0 < tg < ng:
        free = T.route_choice(ffn, dataclasses.replace(
            cfg, expert_group_count=0), xf)[1]
        gs = torch.topk(free.reshape(len(xf), ng, -1), 2,
                        dim=-1).values.sum(-1)
        g = torch.topk(gs, tg + 1, dim=-1).values
        margin = min(margin, (g[:, tg - 1] - g[:, tg]).min().item())
    return margin


def routing_margins(engine, ids, steps: int) -> list[float]:
    """The smallest routing margin (``choice_margin``) over the layers,
    for each of ``steps`` greedy steps (step 0: the prefill's prompt
    rows)."""
    import torch
    from llama_gguf_tpu_torch.models import transformer as T

    rows = []
    route = T.route

    def record(ffn, cfg, xf):
        rows.append(choice_margin(ffn, cfg, xf[:len(ids)]))
        return route(ffn, cfg, xf)

    # eagerly, on a cache the runner did not make: a graph replay would
    # not call route
    r = engine.runner
    T.route = record
    try:
        logits, kv, pos = r.prefill(ids, r._make_kv(1))
        for _ in range(steps - 1):
            logits, kv = r.decode_one(int(torch.argmax(logits)), pos, kv)
            pos += 1
    finally:
        T.route = route
    n_moe = sum("router" in layer.get("ffn", {})
                for layer in r.params["layers"])
    return [min(rows[j:j + n_moe]) for j in range(0, len(rows), n_moe)]


def moe_path(card: str, timer, peaks: dict, gguf: str):
    """Phase 6 on mixtral-8x7b-l2 (``gguf``). Returns (measurements,
    launches)."""
    import torch
    from llama_gguf_tpu_torch.models import transformer as T
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    quant, deq = load_both(gguf)
    cfg = quant.runner.cfg
    layer0 = quant.runner.params["layers"][0]
    ex = layer0["ffn"]["experts"]
    shape = dict(num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
                 expert_ffn=ex["gate"].n, num_experts=cfg.num_experts,
                 num_experts_per_token=cfg.num_experts_per_token)
    check(shape == MOE_SHAPE, f"unexpected MoE model shape {shape}")
    check((ex["gate"].fmt, ex["up"].fmt, ex["down"].fmt, ex["down"].group)
          == ("q4", "q4", "q8", 16), "unexpected expert layouts")

    # the q4 and q8 kernels at this path's own shapes: decode (1 row) and
    # the prefill bucket (128 rows)
    measurements = projection_checks([
        ("qmatmul_q4", "qkv", layer0["attn"]["wqkv"]),
        ("qmatmul_q4", "o_proj", layer0["attn"]["wo"]),
        ("qmatmul_q8", "lm_head", quant.runner.params["output"]),
    ], MOE_ROWS, timer, peaks, MOE_LABEL)

    # layer 0's router on the prompt: the main path's inputs and routing
    ffn0 = quant.runner.params["layers"][0]["ffn"]
    seen = []
    route = T.route

    def record(ffn, cfg_, xf):
        topv, topi = route(ffn, cfg_, xf)
        if ffn is ffn0:
            seen.append((xf, topi))
        return topv, topi

    T.route = record
    ids = quant.tokenizer.encode(PROMPT)
    # eager (a cache the runner did not make), so route sees the prompt
    quant.runner.prefill(ids, quant.runner._make_kv(1))
    T.route = route
    xf, topi = seen[0]
    k = cfg.num_experts_per_token
    idx = topi.reshape(-1).to(torch.int32)                   # [256]
    xr = xf.float().repeat_interleave(k, dim=0)              # [256, 4096]
    imbalanced = idx.clone()
    imbalanced[0::2] = 0                 # expert 0 takes half of the slots
    imbalanced[imbalanced == 1] = 2      # expert 1 none
    last = len(ids) - 1
    cases = {  # case: (slot ids, input rows)
        "decode, 2 experts": (idx[k * last: k * last + 2], xr[k * last:
                                                              k * last + 2]),
        "decode, 1 expert twice": (idx[k * last].repeat(2),
                                   xr[k * last: k * last + 2]),
        "prefill, router's routing": (idx, xr),
        "prefill, imbalanced": (imbalanced, xr),
    }
    measurements += moe_kernel_checks(ex, cases, timer, peaks,
                                      MOE_LABEL)

    def on_differ(ids_, toks, want):
        i = next(j for j, (a, b) in enumerate(zip(toks, want)) if a != b)
        margin = routing_margins(quant, ids_, len(toks))[i]
        log(f"Mixtral: quant and dequant tokens first differ at step {i}; "
            f"smallest top-2 vs third router margin there: {margin:.3g}")

    launches, by_path, decoded, ids = run_main_path(
        quant, deq, card, MOE_LABEL, on_differ)
    n_layers = cfg.num_layers
    for name in Q.LAUNCHES:
        want = n_layers * (decoded * MOE_PER_LAYER["decode"].get(name, 0)
                           + MOE_PER_LAYER["prefill"].get(name, 0))
        if name == "qmatmul_q8":
            want = 1 + decoded  # the LM head
        check(launches[name] == want,
              f"Mixtral {name}: {launches[name]} launches, expected {want}")
    for name, path in MOE_PATHS.items():  # counted where they launched
        on_path = by_path.get(f"{name} {path}", 0)
        check(on_path == launches[name] > 0,
              f"Mixtral {name}: {on_path} of {launches[name]} launches on "
              f"{path} ({by_path})")
    print(json.dumps({"moe_decode_profile": decode_profiles(quant, ids)}),
          flush=True)
    graph_against_eager(MOE_LABEL, quant, ids, card)
    bench_json(MOE_LABEL, quant, card)
    batched_launches = moe_batched(quant, card)
    return measurements, launches, batched_launches


def moe_kernel_checks(ex: dict, cases: dict, timer, peaks: dict,
                      label: str, paths: dict | None = None,
                      act_fn: str = "silu") -> list[dict]:
    """Kernels 4-6 on the expert stacks ``ex`` ("gate", "up", "down") for
    each case (slot ids, input rows) of ``cases``: the slot-major kernel on
    the gate and down stacks below the grouped rule, the grouped GLU
    (gate|up) and the grouped kernel (down) from it, each in "highest" and
    "default", against the plain versions and timed with the torch.bmm
    yardstick (phase 6). Stacks with expert biases (gpt-oss; the GLU
    ``act_fn``) run as moe_layer runs them: gate, up and down each on the
    slot-major kernel, or on the grouped kernel. The path each takes must
    be MOE_PATHS's, or one of ``paths[name]`` when given (the paths the
    main path took)."""
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops.linear import dequantize_expert
    from llama_gguf_tpu_torch.utils.timing import bound_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    e_num = ex["gate"].packed.shape[0]
    measurements = []
    biased = "gate_bias" in ex or "up_bias" in ex
    w_all = {key: torch.stack([dequantize_expert(ex[key], e)
                               for e in range(e_num)])
             for key in ("gate", "up", "down")}
    for case, (sid, x) in cases.items():
        s_slots = sid.shape[0]
        act = Q.moe_qmatmul_glu_plain(x, ex["gate"], ex["up"], sid, act_fn)
        _, _, grouped = Q.moe_dims(s_slots, e_num)
        # the yardstick's batch: each routed expert once, its own slots'
        # rows padded with zero rows to the busiest expert's count
        used = torch.unique(sid.long())
        members = [torch.nonzero(sid == e)[:, 0] for e in used.tolist()]
        depth = max(len(m) for m in members)
        n_exp = len(members)

        def batch(rows_in):  # [S, K] -> [experts used, depth, K]
            out = rows_in.new_zeros(n_exp, depth, rows_in.shape[1])
            for j, m in enumerate(members):
                out[j, :len(m)] = rows_in[m]
            return out

        # (kernel, projection, input rows, the yardstick's batched input
        # and its experts' f32 weights)
        single = "moe_grouped" if grouped else "moe_slot"
        if grouped and not biased:
            products = [
                ("moe_glu_grouped", "gate|up", x, batch(x),
                 torch.cat([w_all["gate"][used], w_all["up"][used]], dim=2))]
        else:
            products = [(single, key, x, batch(x), w_all[key][used])
                        for key in (("gate", "up") if biased else ("gate",))]
        products.append((single, "down", act, batch(act),
                         w_all["down"][used]))
        for (name, proj, xin, xin_g, w_g), precision in (
                (pr, prec) for pr in products
                for prec in ("highest", "default")):
            if name == "moe_glu_grouped":
                def kern(): return Q.moe_qmatmul_glu(
                    xin, ex["gate"], ex["up"], sid, act_fn, precision)
                def plain(): return Q.moe_qmatmul_glu_plain(
                    xin, ex["gate"], ex["up"], sid, act_fn, precision)
                stacks = (ex["gate"], ex["up"])
            else:
                st = ex[proj]
                def kern(): return Q.moe_qmatmul(xin, st, sid, precision)
                def plain(): return Q.moe_qmatmul_plain(xin, st, sid,
                                                        precision)
                stacks = (st,)
            kdim, n = stacks[0].k, stacks[0].n
            nbytes = (sum(expert_bytes(st_, n_exp) for st_ in stacks)
                      + 4 * s_slots * (kdim + 1)
                      + Q.out_dtype(precision).itemsize * s_slots * n)
            ops = 2 * s_slots * kdim * n * len(stacks)
            tag = ", default" if precision == "default" else ""
            # the wrapper's plan (its shapes and alignment), which must be
            # the main path's: split-K for kernel 4, tensor cores for 5, 6
            aligned = all(Q._aligned(xin.float().contiguous(), st_)
                          for st_ in stacks)
            if name == "moe_slot":
                plan = Q.moe_slot_plan(s_slots, e_num, kdim, n, st.group,
                                       st.fmt, sms, aligned)
            else:
                plan = Q.moe_grouped_plan(s_slots, e_num, kdim, n,
                                          stacks[0].group, stacks[0].fmt, sms,
                                          aligned, glu=len(stacks) == 2)
            allowed = paths[name] if paths else {MOE_PATHS[name]}
            check(plan.path in allowed, f"{name} {proj}: the plan's path is "
                                        f"{plan.path!r}, not of {allowed}")
            kpath = dict(kernel_path=plan.path, splits=plan.splits,
                         tile_rows=plan.rows,
                         bound_f32_ms=bound_ms(nbytes, ops, "f32", peaks)[0])
            op_type = plan.op_type(precision)
            if name != "moe_slot":  # the launch alone, on the wrapper's plan
                c_rows, g_blocks, _ = Q.moe_dims(s_slots, e_num)
                eg, rows, _ = Q.moe_group_plan(sid, e_num, c_rows, g_blocks)
                glu = (dict(up=ex["up"], act=act_fn) if len(stacks) == 2
                       else {})
                kpath["launch_ms"] = timer.ms(
                    lambda: Q.moe_grouped_blocked(xin, stacks[0], eg, rows,
                                                  precision, **glu))
                log(f"{name} {proj} S={s_slots} {case}{tag}: the launch "
                    f"alone {kpath['launch_ms']:.4f} ms")
            measurements.append(compare(
                name, f"{proj} S={s_slots} {case}{tag}", kern(), plain(),
                timer, kern, plain, lambda: torch.bmm(xin_g, w_g), nbytes,
                ops, peaks, op_type=op_type, path=label,
                projection=proj, slots=s_slots, experts_read=n_exp,
                library_rows=n_exp * depth, k=kdim, n=n,
                precision=precision, **kpath))
    return measurements


def panels_as(params, dtype):
    """A copy of a params tree whose QuantLinear and QuantEmbedding panels
    are ``dtype`` (float32 is exact from bf16); every other leaf is
    shared."""
    import dataclasses

    from llama_gguf_tpu_torch.ops.linear import QuantEmbedding, QuantLinear

    if isinstance(params, dict):
        return {k: panels_as(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [panels_as(v, dtype) for v in params]
    if isinstance(params, (QuantLinear, QuantEmbedding)):
        return dataclasses.replace(
            params, scales=params.scales.to(dtype),
            mins=params.mins.to(dtype) if params.mins is not None else None)
    return params


def step_bytes(params, topk: int = 0) -> int:
    """Weight bytes a decode step reads: every QuantLinear's packed data and
    panels, every DenseLinear's weight, and ``topk`` experts of each expert
    stack (the embedding table's one row per token is left out)."""
    from llama_gguf_tpu_torch.ops.linear import (DenseLinear,
                                                 QuantExpertStack,
                                                 QuantLinear)

    if isinstance(params, dict):
        return sum(step_bytes(v, topk) for v in params.values())
    if isinstance(params, list):
        return sum(step_bytes(v, topk) for v in params)
    if isinstance(params, QuantExpertStack):
        return expert_bytes(params, topk)
    if isinstance(params, DenseLinear):
        return params.weight.numel() * params.weight.element_size()
    if isinstance(params, QuantLinear):
        return sum(t.numel() * t.element_size()
                   for t in (params.packed, params.scales, params.mins)
                   if t is not None)
    return 0


def step_logits(runner, ids, steps: int, tokens=None, eager=False):
    """The logits of a prefill and ``steps`` - 1 decode steps, and the tokens
    fed: greedy from these logits, or ``tokens`` when given (the same
    history for two runners). The steps replay the runner's graphs, or with
    ``eager`` run eagerly on a cache the runner did not make."""
    import torch

    kv = runner._make_kv(1) if eager else runner.init_kv()
    logits, kv, pos = runner.prefill(ids, kv)
    toks, rows = [], []
    for i in range(steps):
        rows.append(logits.float())
        toks.append(int(torch.argmax(logits)) if tokens is None
                    else tokens[i])
        if i + 1 < steps:
            logits, kv = runner.decode_one(toks[-1], pos, kv)
            pos += 1
    return toks, rows


def serving_path(card: str, gguf: str, peaks: dict):
    """Phase 7: TinyLlama-1.1B in the serving configuration. Returns the
    launches of its counted generate, and the engine."""
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.models.loader import load_model
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
    from llama_gguf_tpu_torch.tokenizer.gguf_tokenizer import Tokenizer

    t0 = time.perf_counter()
    params, cfg, gg = load_model(gguf, device="cuda", scale_dtype="bfloat16")
    layer = params["layers"][0]
    check(all(t.dtype == torch.bfloat16 for t in (
        layer["attn"]["wqkv"].scales, layer["attn"]["wqkv"].mins,
        layer["ffn"]["down"].scales, params["output"].scales,
        params["embed"].scales)), "serving: panels are not bf16")
    config = EngineConfig(matmul_precision="default", kv_format="bf16")
    engine = Engine(ModelRunner(params, cfg, matmul_precision="default",
                                kv_format="bf16", device="cuda"),
                    Tokenizer.from_gguf(gg.metadata), config, gg)
    oracle = ModelRunner(panels_as(params, torch.float32), cfg,
                         matmul_precision="highest", kv_format="f32",
                         device="cuda")
    log(f"serving: loaded in {time.perf_counter() - t0:.1f}s")
    nbytes = step_bytes(params)
    print(f"TinyLlama-1.1B serving (bf16 panels, default, bf16 KV): "
          f"{nbytes} weight bytes per decode step, bound "
          f"{nbytes / peaks['bytes'] * 1e3:.4f} ms | {card}", flush=True)

    greedy = SamplerConfig(temperature=0.0)
    ids = engine.tokenizer.encode(PROMPT)
    engine.generate(PROMPT, max_tokens=2, sampler=greedy)  # warm-up
    torch.cuda.synchronize()
    Q.reset_launches()
    engine.runner.eager_steps = 0
    engine.generate(PROMPT, max_tokens=NEW_TOKENS, sampler=greedy)
    torch.cuda.synchronize()
    launches = dict(Q.LAUNCHES)
    stats = engine.stats
    steps = 1 + stats.generated_tokens
    check(engine.runner.eager_steps == 0,
          f"serving: {engine.runner.eager_steps} steps of Engine.generate ran "
          "eagerly")
    print(f"TinyLlama-1.1B serving main path: prefill {stats.prompt_tokens} "
          f"tok @ {stats.prefill_tps:.1f} tok/s, decode "
          f"{stats.generated_tokens} tok @ {stats.decode_tps:.1f} tok/s, "
          f"launches {launches} over 1 prefill + {stats.generated_tokens} "
          f"decode steps | {card}", flush=True)
    for name, per in PER_STEP.items():
        check(launches[name] == per * steps,
              f"serving {name}: {launches[name]} launches, expected {per} x "
              f"{steps}")

    # the logits of every step, the serving runner fed the oracle's greedy
    # tokens (one history for both), each within the tolerance
    roundings = SERVING_ROUNDINGS_PER_LAYER * cfg.num_layers + 1
    want_toks, want = step_logits(oracle, ids, NEW_TOKENS)
    _, got = step_logits(engine.runner, ids, NEW_TOKENS, want_toks)
    check(got[0].shape == want[0].shape == (cfg.vocab_size,)
          and all(bool(torch.isfinite(g).all()) for g in got),
          "serving: logits")
    tols = [2.0 ** -9 * roundings ** 0.5 * w.abs().max().item() for w in want]
    diffs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    worst = max(range(NEW_TOKENS), key=lambda i: diffs[i] / tols[i])
    log(f"serving: prefill logits max diff {diffs[0]:.4g} (tolerance "
        f"{tols[0]:.4g} = 2^-9 * sqrt({roundings}) * max |logit|); over the "
        f"{NEW_TOKENS} steps the largest share of the tolerance is "
        f"{diffs[worst] / tols[worst]:.3f}, at step {worst}")
    for i, (d, t) in enumerate(zip(diffs, tols)):
        check(d <= t, f"serving: step {i} logits differ by {d:.4g} > {t:.4g}")
    # the serving path's own greedy tokens, against the oracle's up to its
    # first near tie (a top-2 margin under the tolerance)
    toks, _ = step_logits(engine.runner, ids, NEW_TOKENS)
    margins = [float(w.topk(2).values[0] - w.topk(2).values[1]) for w in want]
    near = next((i for i, (m, t) in enumerate(zip(margins, tols)) if m < t),
                None)
    first_diff = next((i for i, (a, b) in enumerate(zip(toks, want_toks))
                       if a != b), None)
    print(f"serving: greedy tokens equal to the oracle's through step "
          f"{first_diff - 1 if first_diff is not None else NEW_TOKENS - 1} "
          f"of {NEW_TOKENS}; first step with an oracle top-2 margin under the "
          f"tolerance: {near}; prefill logits max diff {diffs[0]:.4g} "
          f"(tolerance {tols[0]:.4g}); largest share of the tolerance over "
          f"{NEW_TOKENS} same-history steps {diffs[worst] / tols[worst]:.3f}",
          flush=True)
    check(first_diff is None or (near is not None and first_diff >= near),
          f"serving: tokens differ at step {first_diff}, before the first "
          f"near tie ({near})")
    print(json.dumps({"serving_decode_profile": decode_profiles(engine,
                                                                ids)}),
          flush=True)
    graph_against_eager("TinyLlama-1.1B serving", engine, ids, card)
    bench_json("TinyLlama-1.1B serving", engine, card)
    return launches, engine


def single_stream(runner, ids, steps: int):
    """The single-stream path's greedy tokens (Engine's prefill and
    decode_one on the runner's unowned one-row cache, graphed) and each
    step's top-2 margin over max |logit|."""
    import numpy as np

    toks, margins = [], []
    logits, kv, pos = runner.prefill(ids, runner.init_kv(1), host=True)
    for i in range(steps):
        top2 = np.partition(logits, -2)[-2:]
        margins.append(float((top2[1] - top2[0]) / np.abs(logits).max()))
        toks.append(int(np.argmax(logits)))
        if i + 1 < steps:
            logits, kv = runner.decode_one(toks[-1], pos, kv, host=True)
            pos += 1
    return toks, margins


def same_until_tie(label: str, got, want, margins, near=None) -> dict:
    """``got`` equals ``want`` up to the first near tie: the first step
    whose margin is under NEAR_TIE, or ``near`` when that comes first."""
    ties = [i for i, m in enumerate(margins) if m < NEAR_TIE]
    ties += [near] if near is not None else []
    tie = min(ties) if ties else None
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    check(diff is None or (tie is not None and diff >= tie),
          f"{label}: tokens differ at step {diff}, before the first near "
          f"tie ({tie})")
    return dict(tokens=len(got), first_diff=diff, first_near_tie=tie)


def graph_launches(r, replays0: dict, batch: int, t: int | None = None
                   ) -> dict:
    """The kernel launches the replays of ``r``'s graphs of ``batch`` rows
    (and ``t`` tokens, when given) made since ``replays0``."""
    out: dict[str, int] = {}
    for key, n in r.replays.items():
        n -= replays0.get(key, 0)
        if not n or key[0] != batch or (t is not None and key[1] != t):
            continue
        for name, per in r._graphs[key].launches[0].items():
            out[name] = out.get(name, 0) + n * per
    return out


def capture_times(r, keys0=()) -> dict:
    """Seconds of warm-up and capture of each of ``r``'s graphs, by key,
    leaving out the keys in ``keys0``."""
    return {str(k): g.capture_s for k, g in r._graphs.items()
            if k not in keys0}


def capture_launches(r, keys0, batch: int, t: int | None = None) -> dict:
    """The kernel launches of the eager run each capture of ``r``'s graphs
    of ``batch`` rows (and ``t`` tokens) after ``keys0`` made before it."""
    out: dict[str, int] = {}
    for key in r._graphs:
        if key in keys0 or key[0] != batch or (t is not None
                                               and key[1] != t):
            continue
        for name, n in r._graphs[key].launches[0].items():
            out[name] = out.get(name, 0) + n
    return out


def profile_decode_graphs(r, batch: int) -> dict:
    """torch.profiler over 16 replays of each of ``r``'s decode graphs of
    ``batch`` rows (``summarize``; one per read bound), taken while its
    scheduler is idle, with the replays each had while serving."""
    out = {}
    for key in [k for k in r._graphs if k[0] == batch and k[1] == 1]:
        g = r._graphs[key]
        out[str(key)] = dict(served_replays=r.replays.get(key, 0),
                             **summarize(lambda: [r._replay(g) for _
                                                  in range(16)], 16))
    return out


def steady_passes(batched, requests) -> list[dict]:
    """Two passes of ``requests`` (callables, each sending one greedy
    request that ends in ``batched.submit``), each pass all at once from
    one thread per request; the second replays the graph keys the first
    captured, and its pure decode steps are the steady rate. Each pass: its
    wall seconds, pure decode tokens and seconds, decode_tps over them, the
    captures it made (their steps left out of decode_tps) and time to first
    token. Fails if a request does not finish "stop" or "length"."""
    import dataclasses
    import threading

    r = batched.runner
    submit = batched.submit
    out = []
    for _ in range(2):
        s0, c0 = dataclasses.replace(batched.stats), r.captures
        handles: list = []

        def record(*a, **kw):
            handles.append(submit(*a, **kw))
            return handles[-1]

        batched.submit = record
        threads = [threading.Thread(target=f) for f in requests]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        batched.submit = submit
        s = batched.stats
        reasons = [h.finish_reason for h in handles]
        check(len(handles) == len(requests) and all(
            x in ("stop", "length") for x in reasons),
            f"steady pass: finish reasons {reasons}")
        tokens = s.decode_tokens_pure - s0.decode_tokens_pure
        secs = s.decode_time - s0.decode_time
        ttft = sorted(h.first_token_at - h.created for h in handles
                      if h.first_token_at is not None)
        out.append(dict(
            wall_s=wall, decode_tokens_pure=tokens, decode_time_s=secs,
            decode_tps=tokens / secs if secs else None,
            completion_tokens=sum(len(h.token_ids) for h in handles),
            captures=r.captures - c0,
            capture_steps=s.capture_steps - s0.capture_steps,
            capture_time_s=s.capture_time - s0.capture_time,
            ttft_s_median=ttft[len(ttft) // 2] if ttft else None,
            ttft_s_max=ttft[-1] if ttft else None))
    return out


def server_path(card: str, gguf: str) -> dict:
    """Phase 10a: TinyLlama-1.1B behind run_server at max_batch SERVE_BATCH,
    12 concurrent client requests. Returns the served window's launches."""
    import dataclasses
    import socket
    import threading

    import numpy as np
    import torch
    from llama_gguf_tpu_torch.client import RemoteChatClient
    from llama_gguf_tpu_torch.engine.chat import _jinja_available
    from llama_gguf_tpu_torch.models.embeddings import extract_embedding
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.cli import build_parser, serve_config
    from llama_gguf_tpu_torch.server.app import ServerState, run_server

    t_phase = time.perf_counter()
    jinja = _jinja_available()
    print(f"jinja2 imports: {jinja} | {card}", flush=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # the deployment `serve` starts from these flags
    config = serve_config(build_parser().parse_args([
        "serve", gguf, "--port", str(port), "--max-batch", str(SERVE_BATCH),
        "--prefill-chunk", str(SERVE_CHUNK)]))
    t0 = time.perf_counter()
    state = ServerState(config)  # load, then the warm-up's captures
    load_s = time.perf_counter() - t0
    engine, batched = state.current()
    r = engine.runner
    warm = capture_times(r)
    check(len(warm) == 2, f"server: the warm-up captured {list(warm)}")
    server = threading.Thread(target=run_server, args=(config, state),
                              daemon=True, name="server")
    server.start()
    client = RemoteChatClient(f"http://127.0.0.1:{port}", timeout=600)
    for _ in range(100):
        try:
            check(client.health()["status"] == "ok", "server: not healthy")
            break
        except OSError:
            time.sleep(0.1)
    seen: dict = {}  # prompt -> its handles, in order
    submit = batched.submit

    def record(prompt, **kw):
        h = submit(prompt, **kw)
        key = tuple(prompt) if isinstance(prompt, list) else prompt
        seen.setdefault(key, []).append(h)
        return h

    batched.submit = record
    rng = np.random.default_rng(SEED)
    vocab = r.cfg.vocab_size
    prompts = [rng.integers(3, vocab, size=int(n)).tolist()
               for n in np.linspace(16, 96, 8)]
    prompts.append(rng.integers(3, vocab, size=SERVE_LONG).tolist())
    chats = [[{"role": "user", "content": f"Count from {i} to {i + 9}."}]
             for i in (7, 42)]
    embed_text = PROMPT
    opts = dict(max_tokens=SERVE_TOKENS, temperature=0.0,
                repetition_penalty=1.0)
    results: dict = {}

    def job(kind, i, arg):
        t = time.perf_counter()
        try:
            if kind == "complete":
                out = client.complete(arg, **opts)
            elif kind == "chat":
                out = list(client.chat_streaming(arg, **opts))
            else:
                out = client.embed(arg)[0]
        except Exception as e:  # gated below: every request must answer
            out = e
        results[(kind, i)] = (out, time.perf_counter() - t)

    jobs = ([("complete", i, p) for i, p in enumerate(prompts)]
            + [("chat", i, m) for i, m in enumerate(chats)]
            + [("embed", 0, embed_text)])
    torch.cuda.synchronize()
    Q.reset_launches()
    r.eager_steps = 0
    replays0 = dict(r.replays)
    keys0 = set(r._graphs)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=job, args=j) for j in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, by_path = Q.launch_counts()
    eager = r.eager_steps
    b8 = graph_launches(r, replays0, SERVE_BATCH)
    served = capture_times(r, keys0)
    warm_runs = capture_launches(r, keys0, SERVE_BATCH)
    stats = dataclasses.asdict(batched.stats)
    decode_tps = batched.stats.decode_tps
    check(len(results) == len(jobs) and not any(
        isinstance(out, Exception) for out, _ in results.values()),
        f"server: failed requests {[(k, v[0]) for k, v in results.items()]}")
    handles = [h for hs in seen.values() for h in hs]
    check(len(handles) == len(prompts) + len(chats),
          f"server: {len(handles)} requests reached the scheduler")
    reasons = [h.finish_reason for h in handles]
    check(all(x in ("stop", "length") for x in reasons),
          f"server: finish reasons {reasons}")
    check(eager == 0, f"server: {eager} steps ran eagerly")
    check(batched.stats.mixed_steps > 0, f"server: no mixed step {stats}")

    steady = steady_passes(batched, [
        lambda p=p: client.complete(p, **dict(opts, max_tokens=STEADY_TOKENS))
        for p in prompts[:SERVE_BATCH]])
    b8_profile = profile_decode_graphs(r, SERVE_BATCH)

    # the embedding alone (its launches: the rest of the window's)
    ids = engine.tokenizer.encode(embed_text)
    before = Q.launch_counts()
    want = extract_embedding(r, ids)
    emb_launches = Q.launch_counts(since=before)[0]
    got = np.asarray(results[("embed", 0)][0], np.float32)
    emb_rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(got.shape == want.shape and emb_rel <= 1e-4,
          f"server: embedding differs by {emb_rel:.3g} (relative)")
    for name in PER_STEP:
        check(launches.get(name, 0) == b8.get(name, 0)
              + warm_runs.get(name, 0) + emb_launches.get(name, 0)
              and b8.get(name, 0) > 0,
              f"server {name}: {launches.get(name, 0)} launches, "
              f"{b8.get(name, 0)} from B = {SERVE_BATCH} graph replays, "
              f"{warm_runs.get(name, 0)} from the eager run before each "
              f"capture and {emb_launches.get(name, 0)} from the embedding")
        check(by_path.get(f"{name} tc", 0) == launches[name],
              f"server {name}: not every launch on the tensor cores "
              f"({by_path})")

    report = []
    for i, p in enumerate(prompts):  # greedy completions
        h = seen[tuple(p)][0]
        check(results[("complete", i)][0] == "".join(h._text_parts),
              f"server: completion {i}'s text")
        want_t, margins = single_stream(r, p, max(len(h.token_ids), 1))
        report.append(dict(prompt_tokens=len(p), **same_until_tie(
            f"server completion {i}", h.token_ids, want_t, margins)))
    for i, m in enumerate(chats):  # streamed, then the same non-streamed
        prompt = engine.chat_template.render(m)
        streamed = seen[prompt][0]
        check("".join(results[("chat", i)][0]) == "".join(streamed._text_parts),
              f"server: chat {i}'s deltas do not join to its text")
        client.chat(m, **opts)
        plain = seen[prompt][1]
        _, margins = single_stream(r, engine.tokenizer.encode(prompt),
                                   max(len(streamed.token_ids), 1))
        report.append(dict(chat=i, **same_until_tie(
            f"server chat {i} streamed/non-streamed", streamed.token_ids,
            plain.token_ids, margins)))
    ttft = sorted(h.first_token_at - h.created for h in handles
                  if h.first_token_at is not None)
    state.shutdown()
    server.join(timeout=30)
    check(not server.is_alive(), "server: run_server did not return")
    completion_tokens = sum(len(h.token_ids) for h in handles)
    print(json.dumps({"server": dict(
        path="TinyLlama-1.1B", max_batch=SERVE_BATCH,
        prefill_chunk=SERVE_CHUNK, requests=len(jobs), wall_s=wall,
        requests_per_s=len(jobs) / wall,
        completion_tokens_per_s=completion_tokens / wall,
        decode_tps_burst=decode_tps, stats=stats, steady=steady,
        ttft_s_median=ttft[len(ttft) // 2] if ttft else None,
        ttft_s_max=ttft[-1] if ttft else None,
        load_s=load_s, warmup_keys=warm, served_keys=served,
        served_capture_s=sum(served.values()), pool_bytes=r.pool_bytes,
        b8_decode_profiles=b8_profile,
        embedding_rel_err=emb_rel, launches=launches,
        launches_by_path=by_path, b8_graph_launches=b8,
        capture_warm_launches=warm_runs, jinja2=jinja,
        rows=report, phase_s=time.perf_counter() - t_phase, card=card)}),
        flush=True)
    return launches


def moe_batched(quant, card: str) -> dict:
    """Phase 10b: Mixtral-8x7B-l2 in a BatchedEngine at max_batch 4 over
    phase 6's quant weights. Returns the batched run's launches."""
    import dataclasses

    import numpy as np
    import torch
    from llama_gguf_tpu_torch.engine.batched import BatchedEngine
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    t_phase = time.perf_counter()
    q = quant.runner
    r = ModelRunner(q.params, q.cfg, max_batch=4, max_seq=q.max_seq,
                    matmul_precision=q.matmul_precision,
                    kv_format=q.kv_format, device=q.device)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(3, q.cfg.vocab_size, size=n).tolist()
               for n in (16, 32, 48, 200)]
    steps = 24
    be = BatchedEngine(r, quant.tokenizer, max_queue=8,
                       prefill_chunk=SERVE_CHUNK)
    mixed: dict[str, int] = {}
    step = be._mixed_step

    def counted():  # the launches of the steps that were mixed
        before, m0 = Q.launch_counts(), be.stats.mixed_steps
        did = step()
        if be.stats.mixed_steps > m0:
            for name, n in Q.launch_counts(since=before)[0].items():
                mixed[name] = mixed.get(name, 0) + n
        return did

    be._mixed_step = counted
    greedy = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    torch.cuda.synchronize()
    Q.reset_launches()
    t0 = time.perf_counter()
    handles = [be.submit(p, max_tokens=steps, sampler=greedy)
               for p in prompts]
    for h in handles:
        h.text(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, by_path = Q.launch_counts()
    dec = graph_launches(r, {}, 4, t=1)
    dec_warm = capture_launches(r, set(), 4, t=1)
    stats = dataclasses.asdict(be.stats)
    keys = capture_times(r)
    mixed_run = dict(mixed)
    steady = steady_passes(be, [
        lambda p=p: be.submit(p, max_tokens=STEADY_MOE_TOKENS,
                              sampler=greedy).text(timeout=600)
        for p in prompts])
    be.shutdown()
    reasons = [h.finish_reason for h in handles]
    check(all(x in ("stop", "length") for x in reasons),
          f"Mixtral batched: finish reasons {reasons}")
    check(r.eager_steps == 0, f"Mixtral batched: {r.eager_steps} eager steps")
    check(stats["mixed_steps"] > 0, f"Mixtral batched: no mixed step {stats}")
    check(0 < dec.get("moe_slot", 0) == launches["moe_slot"]
          - dec_warm.get("moe_slot", 0),
          f"Mixtral batched: kernel 4 launched {launches['moe_slot']} times, "
          f"{dec.get('moe_slot', 0)} by the B = 4 decode graphs' replays and "
          f"{dec_warm.get('moe_slot', 0)} before their captures")
    for name in ("moe_grouped", "moe_glu_grouped"):
        check(mixed_run.get(name, 0) > 0,
              f"Mixtral batched: {name} not launched in a mixed step "
              f"({mixed_run})")
    report = []
    for i, (p, h) in enumerate(zip(prompts, handles)):
        want, margins = single_stream(q, p, max(len(h.token_ids), 1))
        near = None
        if h.token_ids != want[:len(h.token_ids)]:  # routing ties too
            route = routing_margins(quant, p, len(want))
            near = next((j for j, m in enumerate(route) if m < ROUTE_TIE),
                        None)
        report.append(dict(prompt_tokens=len(p), **same_until_tie(
            f"Mixtral batched request {i}", h.token_ids, want, margins,
            near)))
    print(json.dumps({"batched_moe": dict(
        path=MOE_LABEL, max_batch=4, prefill_chunk=SERVE_CHUNK,
        wall_s=wall, stats=stats, decode_tps_run=stats["decode_tokens_pure"]
        / stats["decode_time"] if stats["decode_time"] else None,
        steady=steady,
        launches=launches, launches_by_path=by_path,
        decode_graph_launches=dec, decode_capture_launches=dec_warm,
        mixed_step_launches=mixed_run,
        capture_seconds=keys, rows=report,
        phase_s=time.perf_counter() - t_phase, card=card)}), flush=True)
    del r
    return launches


def variant_path(card: str, timer, peaks: dict):
    """Phase 8: the probe (counted), then each variant's kernel against its
    plain version with times. Returns (measurements, launches)."""
    import numpy as np
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops import qmatmul_variants as V
    from llama_gguf_tpu_torch.scripts import bench_kernel_variants as P

    V.reset_launches()
    for fmt in ("q4", "q8"):
        P.main([fmt])
    torch.cuda.synchronize()
    launches = dict(V.LAUNCHES)
    log(f"probe launches: {launches}")
    # each variant runs 2 warm-ups and ROUNDS x PER_ROUND timed launches a
    # shape, v5, v6 and v8 one more for the gates: q4 has v5, v6, v7, v8,
    # v9, v10, q8 v2, v5, v6, v7, each at the 2 shapes
    per = 2 + P.ROUNDS * P.PER_ROUND
    want = {"variant_f32": 2 * ((per + 1) * 2 + per),
            "variant_bf16": 2 * 2 * (per + 1),
            "variant_int8": 2 * (3 * per + per),
            "variant_w4a8": 2 * (per + 1)}
    check(launches == want, f"probe launches {launches}, not {want}")
    measurements = []
    for fmt in ("q4", "q8"):
        rng = np.random.default_rng(0)  # the probe's inputs, in its order
        for k, n in P.SHAPES:
            variants = P.build_variants(P.make_inputs(fmt, k, n, rng, "cuda"))
            for tag, v in variants.items():
                plan = (Q.qmatmul_plan(P.B, k, n, P.GROUP, fmt)
                        if v.kernel.startswith("qmatmul") else
                        V.variant_plan(P.B, k, n, P.GROUP, fmt))
                measurements.append(compare(
                    v.kernel, f"{tag} {fmt} {k}x{n}", v.call(), v.plain(),
                    timer, v.call, v.plain, v.library, v.nbytes, v.ops, peaks,
                    op_type=v.op_type, exact=v.exact, path="probe",
                    variant=tag, fmt=fmt, rows=P.B, k=k, n=n,
                    kernel_path=plan.path,
                    splits=plan.splits))
            del variants
            torch.cuda.empty_cache()
    return measurements, launches


def formats_path(card: str, timer, peaks: dict, builds):
    """Phase 11 (``builds``: the future of build_formats). Returns
    (measurements, launches by path)."""
    import torch
    from llama_gguf_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_tpu_torch.ops import parity
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    t0 = time.perf_counter()
    paths = builds.result()
    log(f"waited {time.perf_counter() - t0:.1f}s for phase 11's inputs")
    launches = {}

    # -- 11a: tinyllama-1.1b-l2 at the Q2_K mix, full width -----------------
    t0 = time.perf_counter()
    label = "tinyllama-1.1b-l2 Q2_K"
    quant, deq = load_both(paths["Q2_K"])
    cfg, params = quant.runner.cfg, quant.runner.params
    check((cfg.num_layers, cfg.hidden_size, cfg.vocab_size) ==
          (2, 2048, 32000), f"{label}: unexpected model shape {cfg}")
    layer = params["layers"][0]
    q4 = [("qmatmul_q4", "qkv", layer["attn"]["wqkv"]),
          ("qmatmul_q4", "o_proj", layer["attn"]["wo"]),
          ("qmatmul_glu", "gate|up", layer["ffn"]["gate_up"])]
    for _, proj, lin in q4:
        check((lin.fmt, lin.group, lin.source_type) == ("q4", 16, "Q2_K"),
              f"{label} {proj}: {lin.fmt} group {lin.group} from "
              f"{lin.source_type}")
    measurements = projection_checks(q4 + [
        ("qmatmul_q8", "ffn_down", layer["ffn"]["down"]),
        ("qmatmul_q8", "lm_head", params["output"])],
        ROWS, timer, peaks, label, serving=True)
    for m in measurements:  # q4 group 16: split-K below 5 rows, tc from 5
        if m["projection"] in ("qkv", "o_proj", "gate|up"):
            want = "tc" if m["rows"] >= Q.TC_MIN_ROWS else "splitk"
            check(m["kernel_path"] == want,
                  f"{label} {m['case']}: on {m['kernel_path']}, not {want}")
    nbytes = step_bytes(params)
    print(f"{label}: {nbytes} weight bytes per decode step, bound "
          f"{nbytes / peaks['bytes'] * 1e3:.4f} ms | {card}", flush=True)
    run, _, decoded, ids = run_main_path(quant, deq, card, label)
    exact_launches(label, run, decoded, hybrid_launches_per_step(params, cfg))
    launches[label] = run
    print(json.dumps({"q2k_decode_profile": profile_decode(
        quant, ids, mode="greedy")}), flush=True)
    bench_json(label, quant, card)
    del quant, deq, params, layer, q4
    torch.cuda.empty_cache()
    log(f"11a done in {time.perf_counter() - t0:.1f}s")

    # -- 11b: tinyllama-1.1b-l2 at each other format -------------------------
    t0 = time.perf_counter()
    total: dict[str, int] = {}
    for fmt in FORMATS_11B:
        label = f"tinyllama-1.1b-l2 {fmt}"
        quant, deq = load_both(paths[fmt])
        params, n_layers = quant.runner.params, quant.runner.cfg.num_layers
        kind = "q4" if fmt in Q4_FORMATS else "q8"
        wqkv = params["layers"][0]["attn"]["wqkv"]
        gate_up = params["layers"][0]["ffn"]["gate_up"]
        check(wqkv.source_type == gate_up.source_type == fmt
              and wqkv.fmt == gate_up.fmt == kind,
              f"{label}: {wqkv.fmt} from {wqkv.source_type}")
        gated = [parity.kernel_parity_check(panels_as(params, dtype), rtol=0,
                                            atol=REL_LIMIT)
                 for dtype in (torch.float32, torch.bfloat16)]
        if fmt == "Q8_K":  # q8 group 256, the other new layout
            measurements += projection_checks([
                ("qmatmul_q8", "qkv", wqkv),
                ("qmatmul_glu", "gate|up", gate_up)], ROWS, timer, peaks,
                label)
        run, by_path, decoded, _ = run_main_path(quant, deq, card, label)
        steps = 1 + decoded
        # per step: qkv and o_proj of each layer, the GLU, the Q6_K down
        # projections and the LM head
        want = {"qmatmul_glu": n_layers,
                "qmatmul_q4": 2 * n_layers if kind == "q4" else 0,
                "qmatmul_q8": n_layers + 1 + (2 * n_layers if kind == "q8"
                                              else 0)}
        for name in Q.LAUNCHES:
            check(run[name] == want.get(name, 0) * steps,
                  f"{label} {name}: {run[name]} launches, expected "
                  f"{want.get(name, 0)} x {steps}")
        # the prefill's 128 rows on the tensor cores: the format's qkv and
        # o_proj, the down projections and the GLU of every layer
        tc = {"qmatmul_glu": n_layers,
              "qmatmul_q4": 2 * n_layers if kind == "q4" else 0,
              "qmatmul_q8": n_layers * (3 if kind == "q8" else 1)}
        for name, least in tc.items():
            check(by_path.get(f"{name} tc", 0) >= least,
                  f"{label}: {by_path.get(f'{name} tc', 0)} launches of "
                  f"{name} on the tensor cores, {least} at least ({by_path})")
        log(f"{label}: parity gate passed on {gated} layouts (f32, bf16 "
            f"panels; highest, default); launches by path {by_path}")
        for name, n in run.items():
            total[name] = total.get(name, 0) + n
        del quant, deq, params, wqkv, gate_up
        torch.cuda.empty_cache()
    launches["tinyllama-1.1b-l2 formats"] = total
    log(f"11b done in {time.perf_counter() - t0:.1f}s")

    # -- 11c: kernels 4-6 on Q2_K expert stacks at Mixtral's shapes ----------
    t0 = time.perf_counter()
    measurements += q2k_moe_checks(paths["experts"], timer, peaks)
    for t in ("Q2_K", "Q4_K"):
        n = parity.moe_kernel_parity_check(GGMLType[t], rtol=0,
                                           atol=REL_LIMIT)
        log(f"moe_kernel_parity_check({t}): {n} products passed")
    log(f"11c done in {time.perf_counter() - t0:.1f}s")
    return measurements, launches


def q2k_moe_checks(npz: str, timer, peaks: dict) -> list[dict]:
    """Phase 11c: the Q2_K expert stacks of build_q2k_experts on the card,
    kernel 4 at 2 slots (two experts) and kernels 5 and 6 at 256 slots (128
    tokens, each routed to 2 of the stacks' experts, from a seed), through
    moe_kernel_checks."""
    import numpy as np
    import torch
    from llama_gguf_tpu_torch.ops.linear import QuantExpertStack

    data = np.load(npz)
    ex = {}
    for key in ("gate", "up", "down"):
        packed = torch.from_numpy(data[f"{key}.packed"]).cuda()
        ex[key] = QuantExpertStack(
            packed, torch.from_numpy(data[f"{key}.scales"]).cuda(),
            torch.from_numpy(data[f"{key}.mins"]).cuda(), fmt="q4", group=16,
            k=2 * packed.shape[1], n=packed.shape[2])
    check((ex["gate"].k, ex["gate"].n, ex["down"].k) == (
        MOE_SHAPE["hidden_size"], MOE_SHAPE["expert_ffn"],
        MOE_SHAPE["expert_ffn"]), "Q2_K expert stacks: unexpected shapes")
    rng = np.random.default_rng(SEED)
    tokens, k = 128, MOE_SHAPE["num_experts_per_token"]
    idx = np.concatenate([rng.choice(Q2K_EXPERTS, k, replace=False)
                          for _ in range(tokens)]).astype(np.int32)
    x = rng.standard_normal((tokens * k, MOE_SHAPE["hidden_size"]),
                            dtype=np.float32)
    idx_t, x_t = torch.from_numpy(idx).cuda(), torch.from_numpy(x).cuda()
    cases = {"decode, 2 experts": (idx_t[:2], x_t[:2]),
             "prefill, 2 of 4 experts per token": (idx_t, x_t)}
    out = moe_kernel_checks(ex, cases, timer, peaks,
                            f"Q2_K experts ({Q2K_EXPERTS} of 8)")
    del ex, data
    torch.cuda.empty_cache()
    return out


def biased_moe(params) -> bool:
    """Whether the model's expert stacks carry gate or up biases (gpt-oss):
    then models/transformer.moe_layer runs gate and up on kernels 4-5 and
    never the grouped GLU (kernel 6)."""
    return any(key in layer["ffn"]["experts"] for layer in params["layers"]
               if "router" in layer.get("ffn", {})
               for key in ("gate_bias", "up_bias"))


def moe_kernels(params) -> tuple[str, ...]:
    """The MoE kernels a model's layers launch (none without MoE layers)."""
    if not any("router" in layer.get("ffn", {})
               for layer in params["layers"]):
        return ()
    return (("moe_slot", "moe_grouped") if biased_moe(params)
            else ("moe_slot", "moe_glu_grouped", "moe_grouped"))


def hybrid_launches_per_step(params, cfg, prefill_rows: int = 128
                             ) -> dict[str, dict[str, int]]:
    """Phases 12, 14, 15 and 18's launches per step, derived from the
    loaded model: every QuantLinear runs once per step (a fused gate|up on
    the GLU kernel, the others on the q4 or q8 kernel by format), and so
    does every layer's conv (the short-conv kernel); each MoE
    layer's routed experts run kernel 4 three times (gate, up, down) at a
    decode step's num_experts_per_token slots, below the grouped rule, and
    at the prefill bucket's ``prefill_rows`` x num_experts_per_token slots
    the grouped GLU and grouped kernels once each, or, with expert biases,
    the grouped kernel three times (ops/qmatmul.moe_dims). A LoRA-wrapped
    linear counts as its base."""
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops.linear import LoraLinear, QuantLinear

    per: dict[str, int] = {}

    def walk(tree, key=None):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, list):
            for v in tree:
                walk(v)
        elif isinstance(tree, LoraLinear):  # the base keeps its kernel
            walk(tree.base, key)
        elif isinstance(tree, LoraLinear):
            walk(tree.base, where)
        elif isinstance(tree, QuantLinear):
            name = ("qmatmul_glu" if key == "gate_up"
                    else f"qmatmul_{tree.fmt}")
            per[name] = per.get(name, 0) + 1

    walk(params)
    # every conv of a Mamba-family or short-conv layer: one kernel launch
    # (ops/shortconv.py) a step
    conv = sum("conv_w" in layer or "conv_w" in layer.get("mamba", {})
               for layer in params["layers"])
    if conv:
        per["short_conv"] = conv
    moe = sum("router" in layer.get("ffn", {}) for layer in params["layers"])
    k, e = cfg.num_experts_per_token, cfg.num_experts
    s = prefill_rows * k
    check(not moe or (not Q.moe_dims(k, e)[2] and Q.moe_dims(s, e)[2]),
          f"the dispatch rule at {k} / {s} slots")
    prefill = (dict(per, moe_grouped=3 * moe) if biased_moe(params)
               else dict(per, moe_glu_grouped=moe, moe_grouped=moe))
    return {"decode": dict(per, moe_slot=3 * moe), "prefill": prefill}


def exact_launches(label: str, launches: dict, decoded: int, per: dict):
    """Each kernel launched exactly its per-step count (``per``, from
    hybrid_launches_per_step) over one prefill and ``decoded`` steps."""
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    for name in set(Q.LAUNCHES) | set(per["decode"]) | set(per["prefill"]):
        want = (decoded * per["decode"].get(name, 0)
                + per["prefill"].get(name, 0))
        check(launches.get(name, 0) == want,
              f"{label} {name}: {launches.get(name, 0)} launches, expected "
              f"{want} ({per})")


def hybrid_near_tie(deq, label: str = HYBRID_LABEL):
    """run_main_path's near_tie for phases 12 and 14: the first step at
    which the dequant engine's greedy logits have a top-2 margin under
    NEAR_TIE of max |logit|, or (a model with MoE layers) its routing a
    k-th vs (k+1)-th probability margin under ROUTE_TIE."""
    moe = any("router" in layer.get("ffn", {})
              for layer in deq.runner.params["layers"])

    def near(ids, toks, want):
        _, margins = single_stream(deq.runner, ids, len(want))
        route = routing_margins(deq, ids, len(want)) if moe else [1.0]
        ties = ([i for i, m in enumerate(margins) if m < NEAR_TIE]
                + [i for i, m in enumerate(route) if m < ROUTE_TIE])
        log(f"{label}: smallest logit margin {min(margins):.3g}, "
            f"routing margin {min(route):.3g}; near ties at {sorted(ties)}")
        return min(ties) if ties else None
    return near


def delta_rule_ms(cfg, timer) -> float:
    """One DeltaNet layer's delta rule (models/deltanet.delta_rule_scan) at
    a decode step's shapes (B = 1, T = 1), CUDA events, L2 flushed."""
    import torch
    from llama_gguf_tpu_torch.models import deltanet as D

    hv, dk, dv, _, _ = D.state_dims(cfg)
    hk = cfg.ssm_n_group
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, k = randn(1, 1, hk, dk), randn(1, 1, hk, dk)
    q, k = q / q.norm(dim=-1, keepdim=True), k / k.norm(dim=-1, keepdim=True)
    v, beta = randn(1, 1, hv, dv), torch.sigmoid(randn(1, 1, hv))
    gate, state = -torch.rand(1, 1, hv, device="cuda"), randn(1, hv, dk, dv)
    return timer.ms(lambda: D.delta_rule_scan(q, k, v, beta, gate, state))


def recurrent_state(runner, kv) -> list:
    """The live recurrent-state tensors of ``kv``: each DeltaNet layer's S
    and conv, each Mamba-family layer's conv window and ssm state (not the
    placeholders of the other layers)."""
    from llama_gguf_tpu_torch.models.mamba import KINDS

    out = []
    for i, kind in enumerate(runner.cfg.layer_kinds or ()):
        if kind == "deltanet":
            out += [kv["deltanet"][i]["S"], kv["deltanet"][i]["conv"]]
        elif kind in KINDS:
            out += [t for t in (kv["mamba"]["conv"][i], kv["mamba"]["ssm"][i])
                    if t.numel()]
    return out


def hybrid_state_checks(quant, ids, card: str,
                        label: str = HYBRID_LABEL) -> dict:
    """Phases 12a and 14a's state gates: greedy_tokens of the prompt before
    and after another prompt's (init_kv clears the recurrent state); then
    a decode key captured after the prompt's prefill (its warm-up runs on
    the live cache) replayed for 4 steps against the same steps eager,
    logits and state within REL_LIMIT of max |value|."""
    import torch

    r = quant.runner
    first = quant.greedy_tokens(ids, 16)
    quant.greedy_tokens(quant.tokenizer.encode("Another prompt entirely."),
                        8)
    again = quant.greedy_tokens(ids, 16)
    check(first == again, f"{label}: a second greedy run of the "
                          f"prompt gave {again}, the first {first}")
    key, bound = (1, 1, 512, False), 512
    check(key not in r._graphs, f"{label}: {key} captured already")
    _, kv, pos = r.prefill(ids, r.init_kv())
    logits, ekv, _ = r.prefill(ids, r._make_kv(1))
    tok, rel = int(torch.argmax(logits)), []
    for _ in range(4):
        args = ([[tok]], [[pos]], [pos + 1])
        got, kv = r.step(*args, kv, read_bound=bound)
        want, ekv = r.step(*args, ekv, read_bound=bound)
        rel.append(((got - want).abs().max() / want.abs().max()).item())
        tok, pos = int(torch.argmax(want)), pos + 1
    check(r.replays.get(key) == 4, f"{label}: {key} replayed "
                                   f"{r.replays.get(key)} times, not 4")
    state_rel = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(recurrent_state(r, kv),
                                    recurrent_state(r, ekv)))
    check(max(rel) <= REL_LIMIT and state_rel <= REL_LIMIT,
          f"{label}: the step captured after traffic differs from "
          f"eager by {max(rel):.3g} (logits), {state_rel:.3g} (state)")
    out = dict(path=label, greedy_repeats=True,
               captured_after_traffic=str(key),
               max_logit_diff_rel=max(rel), max_state_diff_rel=state_rel,
               card=card)
    print(json.dumps({"hybrid_state": out}), flush=True)
    return out


def hybrid_path(card: str, timer, peaks: dict, gguf: str):
    """Phase 12a on qwen3-next-80b-a3b-l4 (``gguf``), then 12b. Returns
    (measurements, launches, batched launches)."""
    import torch
    from llama_gguf_tpu_torch.models import transformer as T

    quant, deq = load_both(gguf)
    cfg, params = quant.runner.cfg, quant.runner.params
    print(f"{HYBRID_LABEL}: layer kinds {list(cfg.layer_kinds)} | {card}",
          flush=True)
    layers = params["layers"]
    dn0, at3, ffn0 = layers[0]["deltanet"], layers[3]["attn"], layers[0]["ffn"]
    ex = ffn0["experts"]
    shape = dict(layer_kinds=cfg.layer_kinds, hidden_size=cfg.hidden_size,
                 vocab_size=cfg.vocab_size, heads=(cfg.num_heads,
                                                   cfg.num_kv_heads,
                                                   cfg.head_dim),
                 deltanet=(cfg.ssm_n_group, cfg.ssm_dt_rank,
                           cfg.ssm_d_state, cfg.ssm_conv_kernel),
                 experts=(cfg.num_experts, cfg.num_experts_per_token,
                          ex["gate"].n, ffn0["shared"]["down"].k))
    check(shape == HYBRID_SHAPE, f"unexpected hybrid model shape {shape}")
    check((ex["gate"].fmt, ex["up"].fmt, ex["down"].fmt, ex["down"].group)
          == ("q4", "q4", "q8", 16), "unexpected expert layouts")

    # the weight bytes of one decode step, and the state it reads and writes
    nbytes = step_bytes(params, cfg.num_experts_per_token)
    state = sum(t.numel() * t.element_size() for t in recurrent_state(
        quant.runner, quant.runner.init_kv()))
    bound = (nbytes + 2 * state) / peaks["bytes"] * 1e3
    print(f"{HYBRID_LABEL}: {nbytes} weight bytes per decode step, "
          f"recurrent state {state} bytes (read and written), bound "
          f"{bound:.4f} ms | {card}", flush=True)

    # kernels 1-3 at the model's own projections
    measurements = projection_checks([
        ("qmatmul_q4", "ssm_in", dn0["in_proj"]),
        ("qmatmul_q4", "attn_gate z", dn0["z_proj"]),
        ("qmatmul_q4", "ssm_out", dn0["out_proj"]),
        ("qmatmul_q4", "qkv", at3["wqkv"]),
        ("qmatmul_q4", "attn gate", at3["gate"]),
        ("qmatmul_q4", "o_proj", at3["wo"]),
        ("qmatmul_glu", "shared gate|up", ffn0["shared"]["gate_up"]),
        ("qmatmul_q8", "shared down", ffn0["shared"]["down"]),
        ("qmatmul_q8", "lm_head", params["output"]),
    ], ROWS, timer, peaks, HYBRID_LABEL)

    # kernels 4-6 on layer 0's stacks at the prompt's own routing: a decode
    # step's 10 slots, the 96 prompt tokens' 960
    seen = []
    route = T.route

    def record(ffn, cfg_, xf):
        topv, topi = route(ffn, cfg_, xf)
        if ffn is ffn0:
            seen.append((xf, topi))
        return topv, topi

    ids = quant.tokenizer.encode(PROMPT)
    T.route = record
    try:  # eager (a cache the runner did not make), so route sees it
        quant.runner.prefill(ids, quant.runner._make_kv(1))
    finally:
        T.route = route
    xf, topi = seen[0]
    k = cfg.num_experts_per_token
    idx = topi[:len(ids)].reshape(-1).to(torch.int32)
    xr = xf[:len(ids)].float().repeat_interleave(k, dim=0)
    last = k * (len(ids) - 1)
    measurements += moe_kernel_checks(ex, {
        f"decode, {k} experts": (idx[last:last + k], xr[last:last + k]),
        f"prefill of {len(ids)} tokens": (idx, xr)}, timer, peaks,
        HYBRID_LABEL)

    # the main path: exact launch counts, quant against dequant
    per = hybrid_launches_per_step(params, cfg)
    launches, by_path, decoded, ids = run_main_path(
        quant, deq, card, HYBRID_LABEL, near_tie=hybrid_near_tie(deq),
        logit_rel=True)
    exact_launches(HYBRID_LABEL, launches, decoded, per)
    for name, path in MOE_PATHS.items():
        on_path = by_path.get(f"{name} {path}", 0)
        check(on_path == launches[name] > 0,
              f"{HYBRID_LABEL} {name}: {on_path} of {launches[name]} "
              f"launches on {path} ({by_path})")
    print(json.dumps({"hybrid_launches_per_step": per}), flush=True)

    # phase 9 on this path, the state gates, a greedy profile, bench
    graph_against_eager(HYBRID_LABEL, quant, ids, card)
    hybrid_state_checks(quant, ids, card)
    profile = profile_decode(quant, ids, mode="greedy")
    n_dn = sum(kind == "deltanet" for kind in cfg.layer_kinds)
    dr = delta_rule_ms(cfg, timer)
    print(json.dumps({"hybrid_decode_profile": dict(
        profile, delta_rule_ms_per_layer=dr,
        delta_rule_ms_per_step=n_dn * dr,
        kernels_1_6_ms_per_step=(profile["kernels_1_2_ms_per_step"]
                                 + profile["kernel_3_ms_per_step"]
                                 + profile["kernels_4_6_ms_per_step"]),
        card=card)}), flush=True)
    bench_json(HYBRID_LABEL, quant, card)
    del deq
    torch.cuda.empty_cache()
    batched_launches = hybrid_batched(quant, card)
    return measurements, launches, batched_launches


def hybrid_batched(quant, card: str, label: str = HYBRID_LABEL,
                   chunk: int = SERVE_CHUNK,
                   requests: tuple = HYBRID_REQUESTS) -> dict:
    """Phases 12b, 14b, 15b and 16: the path's model in a BatchedEngine at
    max_batch 4 over its quant weights and in its runner's KV format (and
    ring), greedy requests of ``requests`` prompt tokens (rows reused),
    prefill_chunk ``chunk``; every admission clears its
    row's recurrent state (runner.clear_state, its calls recorded as the
    engine runs, with no host sync in the timed passes; after them, with
    recurrent state, that it zeroes each row of the engine's cache and
    only that row). With MoE layers, kernels 4-6 must launch. Returns the
    run's launches."""
    import dataclasses

    import numpy as np
    import torch
    from llama_gguf_tpu_torch.engine.batched import BatchedEngine
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    t_phase = time.perf_counter()
    q = quant.runner
    r = ModelRunner(q.params, q.cfg, max_batch=4, max_seq=q.max_seq,
                    matmul_precision=q.matmul_precision,
                    kv_format=q.kv_format, device=q.device)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(3, min(q.cfg.vocab_size, 4096), size=n).tolist()
               for n in requests]
    steps = 24
    cleared = []  # the rows admissions cleared, in order
    clear = r.clear_state

    def record_clear(kv, row):
        cleared.append(row)
        clear(kv, row)

    r.clear_state = record_clear
    be = BatchedEngine(r, quant.tokenizer, max_queue=16,
                       prefill_chunk=chunk)
    greedy = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    moe = any("router" in layer.get("ffn", {})
              for layer in q.params["layers"])
    torch.cuda.synchronize()
    Q.reset_launches()
    t0 = time.perf_counter()
    handles = [be.submit(p, max_tokens=steps, sampler=greedy)
               for p in prompts]
    for h in handles:
        h.text(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, by_path = Q.launch_counts()
    stats = dataclasses.asdict(be.stats)
    steady = steady_passes(be, [
        lambda p=p: be.submit(p, max_tokens=STEADY_MOE_TOKENS,
                              sampler=greedy).text(timeout=600)
        for p in prompts[:4]])
    be.shutdown()
    state = recurrent_state(r, be._kv)  # none in an attention-only model
    for row in range(4) if state else ():  # each row holds its last state
        before = [t.clone() for t in state]
        check(any(bool(t[row].any()) for t in before),
              f"{label} batched: row {row}'s state is already zero")
        clear(be._kv, row)
        for t, b in zip(state, before):
            rest = [i for i in range(4) if i != row]
            check(not bool(t[row].any()) and torch.equal(t[rest], b[rest]),
                  f"{label} batched: clear_state of row {row}")
    reasons = [h.finish_reason for h in handles]
    check(all(x in ("stop", "length") for x in reasons),
          f"{label} batched: finish reasons {reasons}")
    check(r.eager_steps == 0,
          f"{label} batched: {r.eager_steps} eager steps")
    check(stats["mixed_steps"] > 0,
          f"{label} batched: no mixed step {stats}")
    check(len(cleared) >= len(prompts) + 8
          and set(cleared) == set(range(4)),
          f"{label} batched: admissions' cleared rows {cleared}")
    for name in moe_kernels(q.params):
        check(launches.get(name, 0) > 0,
              f"{label} batched: {name} not launched ({launches})")
    if biased_moe(q.params):
        check(launches.get("moe_glu_grouped", 0) == 0,
              f"{label} batched: the grouped GLU ran on biased experts")
    report = []
    for i, (p, h) in enumerate(zip(prompts, handles)):
        want, margins = single_stream(q, p, max(len(h.token_ids), 1))
        near = None
        if moe and h.token_ids != want[:len(h.token_ids)]:  # routing ties
            route = routing_margins(quant, p, len(want))
            near = next((j for j, m in enumerate(route) if m < ROUTE_TIE),
                        None)
        report.append(dict(prompt_tokens=len(p), row_reused=i >= 4,
                           **same_until_tie(
                               f"{label} batched request {i}",
                               h.token_ids, want, margins, near)))
    print(json.dumps({"batched_hybrid": dict(
        path=label, max_batch=4, prefill_chunk=chunk, kv_format=r.kv_format,
        ring_slots=r.ring_slots,
        admissions_zeroed=len(cleared),
        requests=len(prompts), wall_s=wall, stats=stats,
        decode_tps_run=stats["decode_tokens_pure"] / stats["decode_time"]
        if stats["decode_time"] else None, steady=steady,
        launches=launches, launches_by_path=by_path,
        capture_seconds=capture_times(r),
        rows=report, phase_s=time.perf_counter() - t_phase, card=card)}),
        flush=True)
    del r
    return launches


# Phase 13: perplexity, the prompt cache and the context shift on
# TinyLlama-1.1B (ROADMAP queue 1 item 6), on engines phases 2 and 7 loaded
PPL_TOKENS = 2300  # 4 windows of 512 and a trailing one of 252
PPL_CHUNK = 512
SHIFT_SEQ = 256  # 13c's window
SHIFT_TOKENS = 400  # from the 96-token prompt: the window is passed 4 times
CACHE_TOKENS = 16  # 13b: greedy tokens per request
BATCH_PREFIX = 192  # 13b: the batched requests' shared prefix (tokens)


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def repo_text_ids(tokenizer, n: int) -> list[int]:
    """The first ``n`` tokens of SURVEY.md under ``tokenizer``."""
    with open(os.path.join(ROOT, "SURVEY.md"), encoding="utf-8") as f:
        ids = tokenizer.encode(f.read())
    check(len(ids) >= n, f"SURVEY.md gives {len(ids)} < {n} tokens")
    return ids[:n]


def recording_sampler(margins: list | None = None):
    """A greedy Sampler whose picks (and, with ``margins``, each step's
    top-2 margin over max |logit|) are recorded: (sampler, picks)."""
    import numpy as np
    from llama_gguf_tpu_torch.sampling.sampler import Sampler, SamplerConfig

    sampler = Sampler(SamplerConfig(temperature=0.0, repetition_penalty=1.0))
    picks: list[int] = []
    sample = sampler.sample

    def record(logits, *a, **kw):
        if margins is not None:
            top2 = np.partition(logits, -2)[-2:]
            margins.append(float((top2[1] - top2[0]) / np.abs(logits).max()))
        picks.append(sample(logits, *a, **kw))
        return picks[-1]

    sampler.sample = record
    return sampler, picks


def ppl_checks(quant, deq, serving, card: str) -> dict:
    """13a: perplexity of PPL_TOKENS tokens of the repo's text in both
    modes, each after a warm-up pass (its captures); the quant pass counted
    (exact launches per window, no eager step) and timed per window; the
    serving configuration's ppl reported."""
    import math

    from llama_gguf_tpu_torch.engine.perplexity import PPL_OWNER, perplexity
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    ids = repo_text_ids(quant.tokenizer, PPL_TOKENS)
    windows = -(-PPL_TOKENS // PPL_CHUNK)
    out = {}
    for label, engine in (("quant", quant), ("dequant", deq),
                          ("serving", serving)):
        r = engine.runner
        keys0 = set(r._graphs)
        perplexity(r, ids, chunk=PPL_CHUNK)  # warm-up: the captures
        captured = capture_times(r, keys0)
        sync()
        before = Q.launch_counts()
        r.eager_steps = 0
        stamps = [time.perf_counter()]
        res = perplexity(r, ids, chunk=PPL_CHUNK,
                         progress=lambda *a: stamps.append(
                             time.perf_counter()))
        sync()
        launches = Q.launch_counts(since=before)[0]
        check(r.eager_steps == 0,
              f"13a {label}: {r.eager_steps} perplexity steps ran eagerly")
        check(res.count == PPL_TOKENS - windows and len(stamps) == windows + 1,
              f"13a {label}: {res.count} tokens scored in "
              f"{len(stamps) - 1} windows")
        check(all(map(math.isfinite, res.per_chunk_ppl + [res.nll])),
              f"13a {label}: non-finite perplexity")
        full = sorted(b - a for a, b in zip(stamps[:4], stamps[1:5]))
        if label != "dequant":
            for name, per in PER_STEP.items():
                check(launches.get(name, 0) == per * windows,
                      f"13a {label} {name}: {launches.get(name, 0)} "
                      f"launches, expected {per} x {windows} windows")
        out[label] = dict(
            ppl=res.ppl, nll=res.nll, tokens=res.count,
            per_chunk_ppl=res.per_chunk_ppl,
            chunk_512_s_median=(full[1] + full[2]) / 2,
            chunk_512_tps=PPL_CHUNK / ((full[1] + full[2]) / 2),
            trailing_s=stamps[-1] - stamps[-2], launches=launches,
            capture_seconds=captured)
    # the gate's scale: max |logit| of the first window, dequant mode
    r = deq.runner
    t = PPL_CHUNK
    logits, _ = r.step([ids[:t]], [list(range(t))], [t],
                       r.init_kv(1, owner=PPL_OWNER), read_bound=t)
    max_logit = logits.abs().max().item()
    d_nll = abs(out["quant"]["nll"] - out["dequant"]["nll"])
    limit = 2 * 1e-3 * max_logit
    check(d_nll <= limit, f"13a: mean NLL quant {out['quant']['nll']} vs "
                          f"dequant {out['dequant']['nll']}: {d_nll:.3g} > "
                          f"{limit:.3g}")
    summary = dict(
        ppl_quant=out["quant"]["ppl"], ppl_dequant=out["dequant"]["ppl"],
        delta_ppl=out["quant"]["ppl"] - out["dequant"]["ppl"],
        delta_nll=d_nll, nll_limit=limit, max_logit=max_logit,
        ppl_serving=out["serving"]["ppl"],
        delta_ppl_serving=out["serving"]["ppl"] - out["dequant"]["ppl"],
        chunk_512_tps_quant=out["quant"]["chunk_512_tps"],
        chunk_512_tps_dequant=out["dequant"]["chunk_512_tps"],
        chunk_512_tps_serving=out["serving"]["chunk_512_tps"])
    print(json.dumps({"perplexity": dict(summary=summary, runs=out,
                                         card=card)}), flush=True)


def cache_checks(quant, serving, card: str) -> None:
    """13b: the prompt cache on the quant runner (Engine, session files,
    BatchedEngine) and a session file of the serving runner's bf16 KV."""
    import tempfile

    import numpy as np
    from llama_gguf_tpu_torch.engine.batched import BatchedEngine
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    greedy = SamplerConfig(temperature=0.0, repetition_penalty=1.0)

    r = quant.runner
    tok = quant.tokenizer
    a_text = " ".join([PROMPT] * 3)
    b_text = a_text + " Five more wizards jump."
    a_ids, ab_ids = tok.encode(a_text), tok.encode(b_text)
    check(250 <= len(a_ids) <= 350 and ab_ids[:len(a_ids)] == a_ids
          and 20 <= len(ab_ids) - len(a_ids) <= 80,
          f"13b: prompts of {len(a_ids)} and {len(ab_ids)} tokens")
    prefilled: list[int] = []
    hit_logits: list = []
    prefill = r.prefill

    def spy(ids, *a, **kw):
        prefilled.append(len(ids))
        out = prefill(ids, *a, **kw)
        hit_logits[:] = [out[0]]  # the last prefill's logits (host)
        return out

    r.prefill = spy
    try:
        eng = None
        for _ in range(2):  # the first pass captures the keys
            eng = Engine(r, tok, EngineConfig(prompt_cache=True), quant.gguf)
            r.eager_steps = 0
            prefilled.clear()
            margins: list = []
            sampler, picks = recording_sampler(margins)
            eng.generate(a_text, max_tokens=CACHE_TOKENS, sampler=greedy)
            miss_s = eng.stats.prefill_time
            eng.generate(b_text, max_tokens=CACHE_TOKENS, sampler=sampler)
            hit_s = eng.stats.prefill_time
    finally:
        del r.prefill
    s = eng.prompt_cache.stats
    check((s.hits, s.misses) == (1, 1), f"13b: hits {s.hits}, misses "
                                        f"{s.misses}")
    check(prefilled == [len(a_ids), len(ab_ids) - len(a_ids)],
          f"13b: prefills of {prefilled} tokens")
    check(r.eager_steps == 0, "13b: a cached step ran eagerly")
    # the hit's last logits against an uncached prefill of A + B
    want = r.prefill(ab_ids, r.init_kv(1), host=True)[0]
    diff = float(np.abs(hit_logits[0] - want).max())
    check(diff <= 1e-3 * float(np.abs(want).max()),
          f"13b: a hit's logits differ from uncached by {diff:.4g}")
    want_toks, want_margins = single_stream(r, ab_ids, CACHE_TOKENS)
    tie = same_until_tie("13b Engine", picks, want_toks, want_margins)
    # session files: f32 (this runner) and bf16 KV (the serving runner)
    files = {}
    with tempfile.TemporaryDirectory() as d:
        for label, engine in (("f32", eng), ("bf16", None)):
            if engine is None:
                engine = Engine(serving.runner, serving.tokenizer,
                                EngineConfig(prompt_cache=True),
                                serving.gguf)
                engine.generate(a_text, max_tokens=2, sampler=greedy)
            path = os.path.join(d, f"{label}.bin")
            n = engine.save_prompt_cache(path)
            loaded = PromptCache()
            check(loaded.load(path) == n >= 1, f"13b {label}: file entries")
            for key, e in engine.prompt_cache._entries.items():
                f = loaded._entries[key]
                check(e.dtypes == f.dtypes and all(
                    np.array_equal(e.arrays[k].view(np.uint8),
                                   f.arrays[k].view(np.uint8))
                    for k in e.arrays), f"13b {label}: file bytes differ")
            files[label] = dict(entries=n, bytes=os.path.getsize(path),
                                dtype=sorted(set(
                                    next(iter(loaded._entries.values()))
                                    .dtypes.values())))
    # batched: four requests sharing a BATCH_PREFIX-token prefix, B = 4
    br = ModelRunner(r.params, r.cfg, max_batch=4, max_seq=r.max_seq,
                     device=r.device)
    prefix = " ".join([PROMPT] * 2)
    check(abs(len(tok.encode(prefix)) - BATCH_PREFIX) <= 16,
          f"13b batched: a prefix of {len(tok.encode(prefix))} tokens")
    prompts = [prefix] + [f"{prefix} {w}" for w in
                          ("Why?", "And then the wizards jumped.", "No.")]
    runs = {}
    for label, cache in (("uncached", None), ("cached", PromptCache())):
        br.eager_steps = 0
        be = BatchedEngine(br, tok, prompt_cache=cache)
        try:
            first = be.submit(prompts[0], max_tokens=CACHE_TOKENS,
                              sampler=greedy)
            first.text(timeout=600)
            rest = [be.submit(p, max_tokens=CACHE_TOKENS, sampler=greedy)
                    for p in prompts[1:]]
            for h in rest:
                h.text(timeout=600)
        finally:
            be.shutdown()
        check(br.eager_steps == 0, f"13b batched {label}: eager steps")
        runs[label] = [list(h.token_ids) for h in [first] + rest]
        if cache is not None:
            check(cache.stats.hits >= 3, f"13b batched: {cache.stats.hits} "
                                         "hits")
            hits = cache.stats.hits
    rows = []
    for p, got_t, want_t in zip(prompts, runs["cached"], runs["uncached"]):
        ids = tok.encode(p)
        ref, margins = single_stream(r, ids, CACHE_TOKENS)
        rows.append(same_until_tie("13b batched cached", got_t, ref,
                                   margins))
        same_until_tie("13b batched uncached", want_t, ref, margins)
    print(json.dumps({"prompt_cache": dict(
        prompt_tokens=[len(a_ids), len(ab_ids)], prefilled=prefilled,
        hit_prefill_ms=hit_s * 1e3, miss_prefill_ms=miss_s * 1e3,
        hit_logits_max_diff=diff, engine_tokens=tie, session_files=files,
        batched_hits=hits, batched_rows=rows, card=card)}), flush=True)


def shift_checks(quant, deq, card: str, path: str = "13c",
                 kv_format: str = "f32") -> None:
    """13c (and 15a, 16a: ``path``): both modes' weights in a
    SHIFT_SEQ-token runner with the context shift on (its cache in
    ``kv_format``), SHIFT_TOKENS greedy tokens from the prompt: quant
    tokens equal dequant up to the first near tie (with MoE layers also a
    routing near tie of the steps before the first shift), no eager step,
    and after the first shift layer 0's keys (an MLA model's latents; an
    i8 cache's dequantized) equal a fresh prefill's of the kept tokens
    within REL_LIMIT of their largest magnitude (i8: within 2 steps of
    max |k| / 127, the shift having requantized them)."""
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.models import kv as KV

    got = {}
    for label, base in (("quant", quant), ("dequant", deq)):
        r = ModelRunner(base.runner.params, base.runner.cfg,
                        max_seq=SHIFT_SEQ, device=base.runner.device,
                        kv_format=kv_format)
        eng = Engine(r, base.tokenizer, EngineConfig(context_shift=True),
                     base.gguf)
        shift = r.shift_left
        shifts: list[float] = []
        first: dict = {}

        def timed(kv, n, batch_idx=None):
            if not first:
                first["n"] = n
            sync()
            t0 = time.perf_counter()
            shift(kv, n, batch_idx)
            sync()
            shifts.append(time.perf_counter() - t0)
            if "k0" not in first:
                keys = KV.read(kv, 0)[0]
                first["k0"] = keys[0, :SHIFT_SEQ - 1 - n].clone()

        r.shift_left = timed
        margins: list = []
        sampler, picks = recording_sampler(margins)
        eng.generate(PROMPT, max_tokens=SHIFT_TOKENS, sampler=sampler)
        check(r.eager_steps == 0, f"{path} {label}: {r.eager_steps} eager "
                                  "steps")
        check(eng.stats.prompt_tokens == len(base.tokenizer.encode(PROMPT))
              and len(shifts) >= 2,
              f"{path} {label}: {eng.stats.generated_tokens} tokens, "
              f"{len(shifts)} shifts")
        # the kept tokens: positions n .. SHIFT_SEQ - 2 of the history
        history = base.tokenizer.encode(PROMPT) + picks
        kept = history[first["n"]:SHIFT_SEQ - 1]
        _, kv, _ = r.prefill(kept, r._make_kv(1))  # eager, a cache of its own
        fresh = KV.read(kv, 0)[0][0, :len(kept)]
        err = (first["k0"] - fresh).abs().max().item()
        scale = fresh.abs().max().item()
        limit = (2 / 127 if kv_format == "i8" else REL_LIMIT) * scale
        check(err <= limit, f"{path} {label}: shifted keys differ from a "
                            f"fresh prefill by {err:.4g} > {limit:.4g}")
        got[label] = dict(picks=picks, margins=margins, shifts=shifts,
                          key_err=err, key_scale=scale,
                          captures=capture_times(r))
        del r.shift_left
    near = None
    picks = got["quant"]["picks"], got["dequant"]["picks"]
    moe = any("router" in layer.get("ffn", {})
              for layer in deq.runner.params["layers"])
    if moe and picks[0] != picks[1]:  # routing ties before the first shift
        ids = deq.tokenizer.encode(PROMPT)
        route = routing_margins(deq, ids, min(len(picks[1]),
                                              SHIFT_SEQ - 1 - len(ids)))
        near = next((i for i, m in enumerate(route) if m < ROUTE_TIE), None)
    tie = same_until_tie(f"{path} quant vs dequant", *picks,
                         got["dequant"]["margins"], near)
    print(json.dumps({"context_shift": dict(
        path=path, kv_format=kv_format, window=SHIFT_SEQ,
        tokens=SHIFT_TOKENS,
        quant_vs_dequant=tie,
        **{label: dict(shifts=len(g["shifts"]),
                       ms_per_shift_median=sorted(g["shifts"])[
                           len(g["shifts"]) // 2] * 1e3,
                       ms_per_shift=[s * 1e3 for s in g["shifts"]],
                       first_shift_key_err=g["key_err"],
                       key_scale=g["key_scale"], captures=g["captures"])
           for label, g in got.items()}, card=card)}), flush=True)


def item6_path(quant, deq, serving, card: str) -> dict:
    """Phase 13 (13a-d) on phase 2's engines and phase 7's. Returns the
    kernel launches of the whole phase (every one on the main path)."""
    import contextlib
    import io

    import torch
    from llama_gguf_tpu_torch import cli
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    t0 = time.perf_counter()
    sync()
    Q.reset_launches()
    ppl_checks(quant, deq, serving, card)
    cache_checks(quant, serving, card)
    shift_checks(quant, deq, card)
    sync()
    counted = {k: v for k, v in Q.LAUNCHES.items() if v}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli.main(["sysinfo"]) == 0, "13d: sysinfo failed")
    name = torch.cuda.get_device_name(0)
    check(f"cuda {name}" in out.getvalue(),
          f"13d: sysinfo does not name {name}: {out.getvalue()!r}")
    print(json.dumps({"phase_13": dict(
        wall_s=time.perf_counter() - t0, launches=counted,
        sysinfo=out.getvalue().splitlines(), card=card)}), flush=True)
    return counted


# Phase 14: the Mamba family. 14a-b: granite-4.0-h-micro-l10
# (ibm-granite/granite-4.0-h-micro's widths, 10 of 40 layers: one period of
# 9 Mamba-2 blocks and 1 NoPE attention block; utils/synthetic.SSM_PRESETS);
# 14c: the tiny Mamba-1, Mamba-2, Falcon-H1, LFM2 and Jamba presets
GRANITE_PRESET = "granite-4.0-h-micro-l10"
GRANITE_LABEL = "Granite-4.0-H-Micro-l10"
GRANITE_SHAPE = dict(layer_kinds=("mamba2",) * 5 + ("attn",) + ("mamba2",) * 4,
                     hidden_size=2048, vocab_size=100352, heads=(32, 8, 64),
                     mamba2=(4096, 128, 1, 64, 4), ffn=8192,
                     multipliers=(12.0, 0.125, 0.22, 0.015625))
MAMBA_TINY = ("tiny-mamba", "tiny-mamba2", "tiny-falconh1", "tiny-lfm2",
              "tiny-jamba")
TINY_GREEDY_STEPS = 64  # phase 14c: from the 96-token prompt, within 256
TINY_ROWS = (1, 128)  # phase 14c: a decode step, the prompt's prefill bucket


def ssd_scan_ms(cfg, timer, tokens: int) -> dict[str, float]:
    """One Mamba-2 layer's scan (models/mamba.ssd_scan) over ``tokens``
    tokens of one row at cfg's widths, CUDA events, L2 flushed: launched
    eagerly, and replayed from a CUDA graph of it, as the runner's steps
    run it (the device's time without the host's launch gaps)."""
    import torch
    from llama_gguf_tpu_torch.models import mamba as M

    nh, ds = cfg.ssm_dt_rank, cfg.ssm_d_state
    hd = cfg.ssm_d_inner // nh
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    decay = torch.rand(1, tokens, nh, device="cuda", generator=gen)
    dtx, state = randn(1, tokens, nh, hd), randn(1, nh, hd, ds)
    b_h, c_h = randn(1, tokens, nh, ds), randn(1, tokens, nh, ds)

    def scan():
        return M.ssd_scan(decay, dtx, b_h, c_h, state)

    eager = timer.ms(scan)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        scan()
    return dict(eager=eager, graphed=timer.ms(graph.replay))


def graph_cost(r, key) -> dict:
    """A captured key's capture seconds, its nodes (the kernels one replay
    launches) and one replay's device ms (torch.profiler over one
    replay)."""
    g = r._graphs[key]
    prof = summarize(lambda: r._replay(g), 1)
    return dict(capture_s=g.capture_s,
                kernels_per_replay=prof["kernels_launched_per_step"],
                device_ms_per_replay=prof["device_ms_per_step"])


def mamba_path(card: str, timer, peaks: dict, gguf: str):
    """Phase 14a on granite-4.0-h-micro-l10 (``gguf``), then 14b. Returns
    (measurements, launches, batched launches)."""
    import contextlib
    import io

    import torch
    from llama_gguf_tpu_torch import cli

    t_phase = time.perf_counter()
    load_s: dict[str, float] = {}
    quant, deq = load_both(gguf, load_s)
    cfg, params = quant.runner.cfg, quant.runner.params
    print(f"{GRANITE_LABEL}: layer kinds {list(cfg.layer_kinds)} | {card}",
          flush=True)
    layers = params["layers"]
    shape = dict(layer_kinds=cfg.layer_kinds, hidden_size=cfg.hidden_size,
                 vocab_size=cfg.vocab_size,
                 heads=(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                 mamba2=(cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_group,
                         cfg.ssm_dt_rank, cfg.ssm_conv_kernel),
                 ffn=cfg.intermediate_size, multipliers=(
                     cfg.embedding_scale, cfg.logit_scale,
                     round(cfg.residual_scale, 6), cfg.attention_scale))
    check(shape == GRANITE_SHAPE, f"unexpected Granite shape {shape}")
    check(cfg.rope.n_dims == 0 and cfg.tie_word_embeddings,
          f"{GRANITE_LABEL}: NoPE and tied embeddings expected")

    # the weight bytes of one decode step, and the state it reads and writes
    nbytes = step_bytes(params)
    state = sum(t.numel() * t.element_size() for t in recurrent_state(
        quant.runner, quant.runner.init_kv()))
    bound = (nbytes + 2 * state) / peaks["bytes"] * 1e3
    print(f"{GRANITE_LABEL}: {nbytes} weight bytes per decode step, "
          f"recurrent state {state} bytes (read and written), bound "
          f"{bound:.4f} ms | {card}", flush=True)

    # kernels 1-3 at the model's own projections
    m0, at5 = layers[0], layers[5]["attn"]
    measurements = projection_checks([
        ("qmatmul_q4", "ssm_in", m0["ssm_in"]),
        ("qmatmul_q4", "ssm_out", m0["ssm_out"]),
        ("qmatmul_q4", "qkv", at5["wqkv"]),
        ("qmatmul_q4", "o_proj", at5["wo"]),
        ("qmatmul_glu", "gate|up", m0["ffn"]["gate_up"]),
        ("qmatmul_q8", "ffn_down", m0["ffn"]["down"]),
        ("qmatmul_q8", "lm_head (tied)", params["output"]),
    ], ROWS, timer, peaks, GRANITE_LABEL)
    # kernel 8 at its convs (conv_cases over 8 cache rows, bucket 128)
    measurements += shortconv_checks(
        [case for w, b in conv_layers(params)
         for case in conv_cases(w, b, 8, ROWS[2], GRANITE_LABEL)],
        timer, peaks, GRANITE_LABEL)

    # the main path: exact launch counts, quant against dequant
    per = hybrid_launches_per_step(params, cfg)
    launches, by_path, decoded, ids = run_main_path(
        quant, deq, card, GRANITE_LABEL,
        near_tie=hybrid_near_tie(deq, GRANITE_LABEL), logit_rel=True)
    exact_launches(GRANITE_LABEL, launches, decoded, per)
    print(json.dumps({"mamba_launches_per_step": dict(
        path=GRANITE_LABEL, **per)}), flush=True)

    # phase 9 on this path, the state gates, a greedy profile, bench
    graph_against_eager(GRANITE_LABEL, quant, ids, card)
    hybrid_state_checks(quant, ids, card, GRANITE_LABEL)
    r = quant.runner
    graphs = {name: graph_cost(r, key) for name, key in (
        ("decode", (1, 1, 256, False)), ("prefill 128", (1, 128, 256, True)))}
    profile = profile_decode(quant, ids, mode="greedy")
    n_m2 = sum(kind == "mamba2" for kind in cfg.layer_kinds)
    scan = ssd_scan_ms(cfg, timer, 1)
    device = profile["device_ms_per_step"]
    print(json.dumps({"mamba_decode_profile": dict(
        profile, path=GRANITE_LABEL, byte_bound_ms=bound,
        # the scan timed alone (ssd_scan_ms, random inputs, L2 flushed),
        # not inside the profiled step: its share is an estimate
        scan_ms_per_layer=scan, scan_ms_per_step=n_m2 * scan["graphed"],
        scan_share_estimate=(n_m2 * scan["graphed"] / device
                    if isinstance(device, float) else "not measured"),
        scan_ms_per_layer_prefill_128=ssd_scan_ms(cfg, timer, 128),
        kernels_1_3_ms_per_step=(profile["kernels_1_2_ms_per_step"]
                                 + profile["kernel_3_ms_per_step"]),
        graphs=graphs, load_s=load_s,
        card=card)}), flush=True)
    bench_json(GRANITE_LABEL, quant, card)
    del deq
    torch.cuda.empty_cache()
    # the CLI's run on the GGUF (its own load, on the card by default)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["run", gguf, "-p", PROMPT, "-n", "8",
                       "--temperature", "0", "--no-stream"])
    check(rc == 0 and out.getvalue().strip() != "",
          f"{GRANITE_LABEL}: the CLI's run gave {rc}, {out.getvalue()!r}")
    log(f"{GRANITE_LABEL}: the CLI's run (load and 8 tokens) took "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    batched_launches = hybrid_batched(quant, card, GRANITE_LABEL)
    log(f"phase 14a-b done in {time.perf_counter() - t_phase:.1f}s")
    return measurements, launches, batched_launches


def distinct_projections(params) -> list[tuple[str, str, object]]:
    """Each QuantLinear of ``params`` whose kernel and shape (K, N, format,
    group, GLU split) no earlier one has, as projection_checks takes them:
    (kernel, its place in the tree, QuantLinear), the kernel picked as
    hybrid_launches_per_step picks it. A LoraLinear stands for its base,
    which its kernel runs on."""
    from llama_gguf_tpu_torch.ops.linear import LoraLinear, QuantLinear

    seen: dict[tuple, tuple[str, str, object]] = {}

    def walk(tree, where):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{where}.{k}" if where else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{where}.{i}")
        elif isinstance(tree, LoraLinear):
            walk(tree.base, where)
        elif isinstance(tree, QuantLinear):
            name = ("qmatmul_glu" if where.endswith("gate_up")
                    else f"qmatmul_{tree.fmt}")
            key = (name, tree.k, tree.n, tree.fmt, tree.group, tree.splits)
            seen.setdefault(key, (name, where, tree))

    walk(params, "")
    return list(seen.values())


# Phase 14c's short conv at LFM2-24B-A2B's width (2,048 channels, 3 taps)
# over the multiturn cell's 48 cache rows: a decode step and a launch plan
# of 512-token rows with a spare place
LFM2MOE_CONV = dict(channels=2048, taps=3, batch=48, bucket=512)


def conv_layers(params) -> list[tuple[object, object]]:
    """(taps [K, C], bias or None) of each layer's conv (LFM2's short conv,
    a Mamba-family mixer's, Falcon-H1's under "mamba"), one per distinct
    (K, C, bias)."""
    seen = {}
    for layer in params["layers"]:
        for d in (layer, layer.get("mamba", {})):
            if "conv_w" in d:
                w, b = d["conv_w"], d.get("conv_b")
                seen.setdefault((tuple(w.shape), b is None), (w, b))
    return list(seen.values())


def conv_cases(w, bias, batch: int, bucket: int, label: str) -> list[tuple]:
    """shortconv_checks' cases of one conv: a decode step's identity map
    over ``batch`` rows, the prefill bucket's row, and a launch plan's four
    rows of bucket / 4 tokens by a row map over ``batch`` cache rows, the
    last a spare place repeating the first's cache row."""
    return [(f"{label} decode {batch}x1", w, bias, batch, batch, 1, None),
            (f"{label} prefill 1x{bucket}", w, bias, 1, 1, bucket, None),
            (f"{label} plan 4x{bucket // 4} of {batch} rows, 1 spare", w,
             bias, batch, 4, bucket // 4, 3)]


def shortconv_checks(cases, timer, peaks: dict, path: str) -> list[dict]:
    """Kernel 8 (ops/shortconv.causal_conv) against its plain version on
    random windows and inputs, each case (label, taps, bias, cache rows B,
    input rows G, tokens T, real rows): with real None the identity map (G
    = B; with G > 1 a third of the rows empty), else a row map whose first
    ``real`` rows take distinct cache rows and the rest repeat the first's
    with no valid token. The outputs of the real rows and every window bit
    for bit; the cache rows no real row maps to keep their windows; one
    launch. Timed against the plain version and PyTorch's depthwise conv1d
    over the same windows and inputs; the bound: the float32 bytes it moves
    (x in, y out, each real row's window read and written, the taps)."""
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops import shortconv as SC

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    out = []
    for case, w, bias, b, g, t, real in cases:
        k, c = w.shape
        state = torch.randn(b, k - 1, c, device=dev, generator=gen)
        x = torch.randn(g, t, c, device=dev, generator=gen)
        n_valid = torch.randint(1, t + 1, (g,), device=dev, generator=gen,
                                dtype=torch.int32)
        if real is None:
            rows, live = None, g
            if g > 1:
                n_valid[::3] = 0
        else:
            rows = torch.randperm(b, device=dev, generator=gen)[:real]
            rows = torch.cat([rows, rows[:1].expand(g - real)]).int()
            n_valid[real:] = 0
            live = real
        x[torch.arange(t, device=dev)[None] >= n_valid[:, None]] = 0.0
        want_state = state.clone()
        want = SC.causal_conv_plain(x, want_state, w, bias, n_valid, rows)
        got_state = state.clone()
        before = Q.LAUNCHES["short_conv"]
        got = SC.causal_conv(x, got_state, w, bias, n_valid, rows)
        torch.cuda.synchronize()
        check(Q.LAUNCHES["short_conv"] == before + 1,
              f"short_conv {case}: not one launch")
        check(torch.equal(got_state, want_state),
              f"short_conv {case}: the windows differ from the plain "
              "version's")
        wrote = (set(rows[:real].tolist()) if rows is not None else
                 {i for i in range(g) if n_valid[i] > 0})
        kept = [i for i in range(b) if i not in wrote]
        check(torch.equal(got_state[kept], state[kept]),
              f"short_conv {case}: a row with no valid token wrote")
        work = state.clone()
        seq = torch.cat([SC.read_windows(state, rows), x], 1)
        seq = seq.transpose(1, 2).contiguous()
        taps = w.float().t().contiguous()[:, None, :]  # [C, 1, K]
        real_rows = int((n_valid > 0).sum())
        nbytes = 4 * (2 * g * t * c + 2 * real_rows * (k - 1) * c + k * c
                      + (c if bias is not None else 0))
        out.append(compare(
            "short_conv", case, got[:live], want[:live], timer,
            lambda: SC.causal_conv(x, work, w, bias, n_valid, rows),
            lambda: SC.causal_conv_plain(x, work, w, bias, n_valid, rows),
            lambda: torch.nn.functional.conv1d(seq, taps, groups=c), nbytes,
            2 * k * g * t * c, peaks, exact=True, path=path,
            kernel_path="cuda cores", taps=k, channels=c, cache_rows=b,
            rows=g, tokens=t, spare=g - live))
    return out


def tiny_kernel_checks(quant, label: str, by_path: dict, timer,
                       peaks: dict) -> list[dict]:
    """Phase 14c's kernel checks on a tiny preset's own weights: kernels
    1-3 on each distinct projection (distinct_projections) at a decode
    step's row and the prefill bucket's TINY_ROWS[-1]; with MoE layers,
    kernels 4-6 on the first MoE layer's stacks at the prompt's own
    routing (a decode step's slots and the prompt's), each on a path the
    main path took (``by_path``, run_main_path's); with conv layers, kernel
    8 on each distinct conv's taps (conv_cases over 8 cache rows and the
    prefill bucket)."""
    import torch
    from llama_gguf_tpu_torch.models import transformer as T

    r = quant.runner
    out = projection_checks(distinct_projections(r.params), TINY_ROWS, timer,
                            peaks, label)
    out += shortconv_checks([case for w, b in conv_layers(r.params)
                             for case in conv_cases(w, b, 8, TINY_ROWS[-1],
                                                    label)],
                            timer, peaks, label)
    ffn0 = next((layer["ffn"] for layer in r.params["layers"]
                 if "router" in layer.get("ffn", {})), None)
    if ffn0 is None:
        return out
    seen = []
    route = T.route

    def record(ffn, cfg_, xf):
        topv, topi = route(ffn, cfg_, xf)
        if ffn is ffn0:
            seen.append((xf, topi))
        return topv, topi

    ids = quant.tokenizer.encode(PROMPT)
    T.route = record
    try:  # eager (a cache the runner did not make), so route sees it
        r.prefill(ids, r._make_kv(1))
    finally:
        T.route = route
    xf, topi = seen[0]
    k = r.cfg.num_experts_per_token
    idx = topi[:len(ids)].reshape(-1).to(torch.int32)
    xr = xf[:len(ids)].float().repeat_interleave(k, dim=0)
    last = k * (len(ids) - 1)
    paths: dict[str, set] = {}
    for key, n in by_path.items():
        name, _, path = key.partition(" ")
        if n and name in MOE_PATHS:
            paths.setdefault(name, set()).add(path)
    return out + moe_kernel_checks(ffn0["experts"], {
        f"decode, {k} experts": (idx[last:last + k], xr[last:last + k]),
        f"prefill of {len(ids)} tokens": (idx, xr)}, timer, peaks, label,
        paths, act_fn=r.cfg.hidden_act.value)


def mamba_tiny_path(card: str, timer, peaks: dict,
                    presets: tuple = MAMBA_TINY, phase: str = "14c"):
    """Phase 14c (15c with MLA_TINY, 18c with ROUTING_TINY): each of
    ``presets`` at the Q4_K_M mix, both modes: the main path as in phase 4
    with exact launch counts derived from the loaded model, no eager step,
    quant tokens equal dequant tokens up to the first near tie, prefill
    logits within 1e-3 of max |logit|; the kernels it launched against
    their plain versions on the preset's own weights (tiny_kernel_checks);
    graphed steps against eager ones (phase 9, TINY_GREEDY_STEPS greedy
    steps). With tiny-lfm2 among them, kernel 8 also at LFM2-24B-A2B's
    width (LFM2MOE_CONV). Returns (measurements, the launches of the
    counted runs)."""
    import torch

    t0 = time.perf_counter()
    total: dict[str, int] = {}
    measurements = []
    for preset in presets:
        quant, deq = load_both(build_model(preset))
        label = f"{preset} (phase {phase})"
        log(f"{label}: layer kinds {quant.runner.cfg.layer_kinds}")
        per = hybrid_launches_per_step(quant.runner.params, quant.runner.cfg)
        launches, by_path, decoded, ids = run_main_path(
            quant, deq, card, label, near_tie=hybrid_near_tie(deq, label),
            logit_rel=True)
        exact_launches(label, launches, decoded, per)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        mine = tiny_kernel_checks(quant, label, by_path, timer, peaks)
        checked = {m["name"] for m in mine}
        check(checked == {name for name, n in launches.items() if n},
              f"{label}: kernels checked {sorted(checked)}, launched "
              f"{launches}")
        measurements += mine
        graph_against_eager(label, quant, ids, card,
                            greedy_steps=TINY_GREEDY_STEPS)
        del quant, deq
        torch.cuda.empty_cache()
    if "tiny-lfm2" in presets:  # the short conv at LFM2-24B-A2B's width
        c, b, t = (LFM2MOE_CONV[key] for key in ("channels", "batch",
                                                 "bucket"))
        w = torch.randn(LFM2MOE_CONV["taps"], c, device="cuda",
                        generator=torch.Generator(device="cuda"
                                                  ).manual_seed(SEED))
        label = "LFM2-24B-A2B conv"
        measurements += shortconv_checks(
            conv_cases(w, None, b, t, label)
            + [(f"{label} plan 2x{t} of {b} rows, 1 spare", w, None, b, 2, t,
                1)], timer, peaks, f"LFM2-24B-A2B (phase {phase})")
    print(json.dumps({f"phase_{phase}": dict(
        presets=presets, launches=total,
        kernel_cases=len(measurements),
        wall_s=time.perf_counter() - t0, card=card)}), flush=True)
    return measurements, total


# Phase 15: the DeepSeek family. 15a-b: moonlight-16b-a3b-l2
# (moonshotai/Moonlight-16B-A3B's widths, 2 of 27 layers: the leading dense
# layer and one MoE layer; utils/synthetic.MLA_PRESETS); 15c: the tiny
# DeepSeek-V3, DeepSeek-V2-Lite and Moonlight presets
MLA_PRESET = "moonlight-16b-a3b-l2"
MLA_LABEL = "Moonlight-16B-A3B-l2"
# (q_lora, kv_lora, nope, rope, v), (experts, top-k, expert ffn, shared ffn),
# (gating, routed scale, norm, groups, groups used)
MLA_SHAPE = dict(hidden_size=2048, vocab_size=163840, heads=16,
                 mla=(0, 512, 128, 64, 128), ffn=11264,
                 experts=(64, 6, 1408, 2816), routing=(2, 2.446, True, 1, 1),
                 rope_base=50000.0)
MLA_TINY = ("tiny-deepseek-v3", "tiny-deepseek-v2-lite", "tiny-moonlight")


def mla_path(card: str, timer, peaks: dict, gguf: str):
    """Phase 15a on moonlight-16b-a3b-l2 (``gguf``), then 15b. Returns
    (measurements, launches, batched launches)."""
    import contextlib
    import io

    import torch
    from llama_gguf_tpu_torch import cli
    from llama_gguf_tpu_torch.models import transformer as T

    t_phase = time.perf_counter()
    load_s: dict[str, float] = {}
    quant, deq = load_both(gguf, load_s)
    cfg, params = quant.runner.cfg, quant.runner.params
    layers = params["layers"]
    at0, ffn0, ffn1 = layers[0]["attn"], layers[0]["ffn"], layers[1]["ffn"]
    ex = ffn1["experts"]
    shape = dict(hidden_size=cfg.hidden_size, vocab_size=cfg.vocab_size,
                 heads=cfg.num_heads,
                 mla=(cfg.q_lora_rank, cfg.kv_lora_rank,
                      cfg.head_dim - cfg.rope.n_dims, cfg.rope.n_dims,
                      cfg.value_length),
                 ffn=cfg.intermediate_size,
                 experts=(cfg.num_experts, cfg.num_experts_per_token,
                          ex["gate"].n, ffn1["shared"]["down"].k),
                 routing=(cfg.expert_gating_func,
                          round(cfg.expert_weights_scale, 6),
                          cfg.expert_weights_norm, cfg.expert_group_count,
                          cfg.expert_group_used_count),
                 rope_base=cfg.rope.freq_base)
    check(shape == MLA_SHAPE, f"unexpected {MLA_LABEL} shape {shape}")
    check("router" not in ffn0 and "router_bias" in ffn1
          and cfg.layer_kinds == ("attn", "attn"),
          f"{MLA_LABEL}: a leading dense layer, then a biased router")
    layouts = {key: (st.fmt, st.group) for key, st in ex.items()}
    print(f"{MLA_LABEL}: expert layouts {layouts}, latent cache K "
          f"{cfg.cache_k_dim} V {cfg.cache_v_dim} on {cfg.cache_kv_heads} "
          f"head | {card}", flush=True)
    check(layouts["gate"][0] == layouts["up"][0] == "q4"
          and layouts["down"][0] == "q8", f"expert layouts {layouts}")

    # the weight bytes of one decode step (6 routed experts, the dense
    # up-projections W_uk and W_uv beside the quantized products)
    up_proj = sum(layer["attn"][key].numel() * 4 for layer in layers
                  for key in ("w_uk", "w_uv"))
    nbytes = step_bytes(params, cfg.num_experts_per_token) + up_proj
    bound = nbytes / peaks["bytes"] * 1e3
    print(f"{MLA_LABEL}: {nbytes} weight bytes per decode step ({up_proj} "
          f"of them the dense W_uk, W_uv), bound {bound:.4f} ms | {card}",
          flush=True)

    # the main path: exact launch counts, quant against dequant
    per = hybrid_launches_per_step(params, cfg)
    launches, by_path, decoded, ids = run_main_path(
        quant, deq, card, MLA_LABEL,
        near_tie=hybrid_near_tie(deq, MLA_LABEL), logit_rel=True)
    exact_launches(MLA_LABEL, launches, decoded, per)
    print(json.dumps({"mla_launches_per_step": dict(
        path=MLA_LABEL, **per, launches_by_path=by_path)}), flush=True)

    # kernels 1-3 at the model's own projections, 4-6 on layer 1's stacks
    # at its own routing: a decode step's 6 slots, the 128-token prefill
    # bucket's 768 (padding rows routed too, as the main path routes them)
    measurements = projection_checks([
        ("qmatmul_q4", "wq", at0["wq"]),
        ("qmatmul_q4", "kv_a", at0["kv_a"]),
        ("qmatmul_q4", "o_proj", at0["wo"]),
        ("qmatmul_glu", "gate|up", ffn0["gate_up"]),
        ("qmatmul_q8", "ffn_down", ffn0["down"]),
        ("qmatmul_glu", "shared gate|up", ffn1["shared"]["gate_up"]),
        ("qmatmul_q8", "shared down", ffn1["shared"]["down"]),
        ("qmatmul_q8", "lm_head", params["output"]),
    ], ROWS, timer, peaks, MLA_LABEL)
    seen = []
    route = T.route

    def record(ffn, cfg_, xf):
        topv, topi = route(ffn, cfg_, xf)
        if ffn is ffn1:
            seen.append((xf, topi))
        return topv, topi

    T.route = record
    try:  # eager (a cache the runner did not make), so route sees it
        quant.runner.prefill(ids, quant.runner._make_kv(1))
    finally:
        T.route = route
    xf, topi = seen[0]
    k = cfg.num_experts_per_token
    idx = topi.reshape(-1).to(torch.int32)
    xr = xf.float().repeat_interleave(k, dim=0)
    last = k * (len(ids) - 1)
    paths: dict[str, set] = {}
    for key, n in by_path.items():
        name, _, kpath = key.partition(" ")
        if n and name in MOE_PATHS:
            paths.setdefault(name, set()).add(kpath)
    measurements += moe_kernel_checks(ex, {
        f"decode, {k} experts": (idx[last:last + k], xr[last:last + k]),
        f"prefill bucket of {len(xf)} tokens": (idx, xr)}, timer, peaks,
        MLA_LABEL, paths)

    # phase 9 on this path; a second greedy run repeats the first; the
    # graphs' cost, a greedy profile against the byte bound, bench
    graph_against_eager(MLA_LABEL, quant, ids, card)
    first = quant.greedy_tokens(ids, 16)
    quant.greedy_tokens(quant.tokenizer.encode("Another prompt entirely."), 8)
    again = quant.greedy_tokens(ids, 16)
    check(first == again, f"{MLA_LABEL}: a second greedy run of the prompt "
                          f"gave {again}, the first {first}")
    r = quant.runner
    graphs = {name: graph_cost(r, key) for name, key in (
        ("decode", (1, 1, 256, False)), ("prefill 128", (1, 128, 256, True)))}
    profile = profile_decode(quant, ids, mode="greedy")
    device = profile["device_ms_per_step"]
    print(json.dumps({"mla_decode_profile": dict(
        profile, path=MLA_LABEL, byte_bound_ms=bound,
        bound_share=(bound / device if isinstance(device, float)
                     else "not measured"),
        kernels_1_6_ms_per_step=(profile["kernels_1_2_ms_per_step"]
                                 + profile["kernel_3_ms_per_step"]
                                 + profile["kernels_4_6_ms_per_step"]),
        graphs=graphs, load_s=load_s, card=card)}), flush=True)
    bench_json(MLA_LABEL, quant, card)

    # 4 context shifts over the latent cache, quant against dequant
    t0 = time.perf_counter()
    shift_checks(quant, deq, card, path=MLA_LABEL)
    log(f"{MLA_LABEL}: context shifts checked in "
        f"{time.perf_counter() - t0:.1f}s")
    del deq
    torch.cuda.empty_cache()
    # the CLI's run on the GGUF (its own load, on the card by default); the
    # synthetic tokenizer spells 4096 of the 163840 ids, so the text may be
    # empty: its stats line must count the tokens decoded
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["run", gguf, "-p", PROMPT, "-n", "8",
                       "--temperature", "0", "--no-stream"])
    decoded = re.search(r"decode (\d+) tok @", err.getvalue())
    check(rc == 0 and decoded is not None and int(decoded.group(1)) > 0,
          f"{MLA_LABEL}: the CLI's run gave {rc}, {out.getvalue()!r}, "
          f"{err.getvalue()[-300:]!r}")
    log(f"{MLA_LABEL}: the CLI's run (load and 8 tokens) took "
        f"{time.perf_counter() - t0:.1f}s: {err.getvalue().strip()[-80:]}")
    torch.cuda.empty_cache()
    batched_launches = hybrid_batched(quant, card, MLA_LABEL)
    log(f"phase 15a-b done in {time.perf_counter() - t_phase:.1f}s")
    return measurements, launches, batched_launches


# Phase 16: the KV-cache formats and the sliding-window ring (ROADMAP queue
# 1 item 10). 16a: every quantized format on TinyLlama-1.1B, over phase 4's
# weights; 16b: gemma-3-4b-l6 (google/gemma-3-4b-it's text_config widths,
# 6 of 34 layers: one period of 5 local layers and 1 global;
# utils/synthetic.GEMMA3_PRESETS), its ring against the full cache; 16c:
# the paged pool on the card against the CPU
KV_FORMATS_16 = ("i8", "f8_e4m3", "f8_e5m2", "tq2", "tq3", "tq4", "qjl")
KV_EAGER_STEPS = 9  # 16a: the prefill and 8 decode steps, graphed vs eager
GEMMA_PRESET = "gemma-3-4b-l6"
GEMMA_LABEL = "Gemma-3-4B-l6"
GEMMA_SHAPE = dict(hidden_size=2560, vocab_size=262208, heads=(8, 4, 256),
                   ffn=10240, window=1024, swa_pattern=6, layers=6)
GEMMA_SEQ = 8192  # 16b's context: a ring of 2,048 slots beside it
GEMMA_RING = 2048  # the window, plus the runner's 1,024 slots of headroom
GEMMA_PROMPT = 2500  # three prefill chunks (1024, 1024, 452): wraps the ring
GEMMA_STEPS = 64  # greedy steps past the prompt, past the window
GEMMA_MEMORY_SEQ = 32768  # the context memory_bytes compares ring and full at
GEMMA_REQUESTS = (1500, 40, 300, 700, 24, 1100)  # 16b's batched prompts


def kv_step_bytes(kv: dict, keys: float, bound: int,
                  window: int = 0) -> tuple[float, int]:
    """(The cache bytes one decode step of one row needs, the bytes it
    reads.) It needs each layer's K/V (and scales) at its ``keys`` live
    positions, a ring layer's at min(keys, window); it reads each full
    layer's up to the read bound ``bound``, and each ring whole with its
    slot positions."""
    need, read = 0.0, 0
    for key in ("k", "v", "k_scale", "v_scale", "k_swa", "v_swa"):
        ring = key.endswith("_swa")
        for t in kv.get(key, ()):
            per = t[0, 0].numel() * t.element_size()
            need += per * (min(keys, window) if ring else keys)
            read += per * (t.shape[1] - 1 if ring else bound)
    read += sum(t[0, :-1].numel() * t.element_size()
                for t in kv.get("swa_pos", ()))
    return need, read


def profiled_keys(ids) -> float:
    """The mean number of keys a step of profile_decode(mode="greedy")
    attends to: its steps run at positions len(ids) + 1 .. + 16."""
    return len(ids) + 9.5


def kv_formats_path(quant, deq, card: str, peaks: dict):
    """Phase 16a on phase 4's TinyLlama-1.1B weights: a new runner per
    format over them (no load), each through Engine.generate. Returns the
    launches counted on its main paths, by path."""
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.engine.runner import ModelRunner, read_bucket
    from llama_gguf_tpu_torch.models import kv as KV
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    t_phase = time.perf_counter()
    greedy = SamplerConfig(temperature=0.0)
    tok = quant.tokenizer
    ids = tok.encode(PROMPT)
    q0 = quant.runner
    base_toks, _ = single_stream(q0, ids, NEW_TOKENS)
    base_logits = q0.prefill(ids, q0.init_kv(1))[0].float()
    f32_bytes = KV.memory_bytes(q0.init_kv(1))
    weight_bytes = step_bytes(q0.params)
    # the profiled greedy steps run at positions len(ids) + 1 .. + 16
    bound_pos = read_bucket(len(ids) + 17, q0.max_seq)
    keys = profiled_keys(ids)
    rows, counted = {}, {}
    engines = {}
    for fmt in KV_FORMATS_16:
        t0 = time.perf_counter()
        runners = {label: ModelRunner(
            e.runner.params, e.runner.cfg, max_seq=e.runner.max_seq,
            kv_format=fmt, device=e.runner.device)
            for label, e in (("quant", quant), ("dequant", deq))}
        r = runners["quant"]
        eq = Engine(r, tok, EngineConfig(kv_format=fmt), quant.gguf)
        # phase 9's gate in this format: graphed steps against eager ones
        want_toks, want = step_logits(r, ids, KV_EAGER_STEPS, eager=True)
        eager0 = r.eager_steps
        toks, got = step_logits(r, ids, KV_EAGER_STEPS)
        rel = max(((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, want))
        check(r.eager_steps == eager0 and toks == want_toks
              and rel <= REL_LIMIT,
              f"16a {fmt}: graphed tokens {toks} vs eager {want_toks}, "
              f"logits {rel:.3g} of max |logit|")
        # the counted main path: Engine.generate, every step a replay
        eq.generate(PROMPT, max_tokens=2, sampler=greedy)  # warm-up
        torch.cuda.synchronize()
        Q.reset_launches()
        r.eager_steps = 0
        eq.generate(PROMPT, max_tokens=NEW_TOKENS, sampler=greedy)
        torch.cuda.synchronize()
        launches = {k: v for k, v in Q.LAUNCHES.items() if v}
        steps = 1 + eq.stats.generated_tokens
        check(r.eager_steps == 0, f"16a {fmt}: {r.eager_steps} eager steps")
        for name, per in PER_STEP.items():
            check(launches.get(name, 0) == per * steps,
                  f"16a {fmt} {name}: {launches.get(name, 0)} launches, "
                  f"expected {per} x {steps}")
        counted[f"TinyLlama-1.1B {fmt} KV"] = launches
        decode_tps = eq.stats.decode_tps
        # quant against dequant in this format, and against the f32 cache
        q_toks, _ = single_stream(r, ids, NEW_TOKENS)
        d_toks, d_margins = single_stream(runners["dequant"], ids,
                                          NEW_TOKENS)
        tie = same_until_tie(f"16a {fmt} quant vs dequant", q_toks, d_toks,
                             d_margins)
        parts = next((i for i, (a, b) in enumerate(zip(q_toks, base_toks))
                      if a != b), None)
        logits = r.prefill(ids, r.init_kv(1))[0].float()
        check(bool(torch.isfinite(logits).all()), f"16a {fmt}: logits")
        d_f32 = (logits - base_logits).abs().max().item()
        prof = profile_decode(eq, ids, mode="greedy")
        kv = r.init_kv(1)
        mem = KV.memory_bytes(kv)
        cache_b, cache_read = kv_step_bytes(kv, keys, bound_pos)
        bound = (weight_bytes + cache_b) / peaks["bytes"] * 1e3
        rows[fmt] = dict(
            first_token_off_f32=parts, prefill_max_dlogit_vs_f32=d_f32,
            max_abs_logit=base_logits.abs().max().item(),
            quant_vs_dequant=tie, graphed_vs_eager_rel=rel,
            launches=launches, decode_tps=decode_tps,
            device_ms_per_greedy_step=prof["device_ms_per_step"],
            device_idle_share=prof["device_idle_share"],
            kernels_per_step=prof["kernels_launched_per_step"],
            top_kernels_ms=dict(list(
                prof["device_ms_per_step_by_kernel"].items())[:6]),
            weight_bytes=weight_bytes, cache_bytes_needed=cache_b,
            cache_bytes_read=cache_read, mean_keys=keys,
            read_bound_positions=bound_pos, step_bound_ms=bound,
            memory_bytes=mem, memory_ratio_to_f32=mem / f32_bytes,
            capture_s=r.capture_seconds,
            seconds=time.perf_counter() - t0)
        log(f"16a {fmt}: parts from f32 at {parts}, prefill dlogit "
            f"{d_f32:.3g}, {prof['device_ms_per_step']} device ms a step "
            f"(bound {bound:.4f}), memory {mem / f32_bytes:.4f} of f32, "
            f"{rows[fmt]['seconds']:.1f}s")
        if fmt == "i8":
            engines[fmt] = eq  # 16a's batched engine runs on it
        del runners, r, eq, kv
        torch.cuda.empty_cache()
    shift_checks(quant, deq, card, path="16a i8", kv_format="i8")
    f8_prompt_cache(quant, card)
    counted["TinyLlama-1.1B i8 KV batched"] = hybrid_batched(
        engines.pop("i8"), card, "TinyLlama-1.1B i8 KV")
    print(json.dumps({"kv_formats": dict(
        path="TinyLlama-1.1B", f32_memory_bytes=f32_bytes, formats=rows,
        phase_s=time.perf_counter() - t_phase, card=card)}), flush=True)
    return counted


def f8_prompt_cache(quant, card: str) -> None:
    """16a: a prompt-cache hit on an f8_e4m3 cache: only the new tokens
    prefilled, the hit's logits within 1e-3 of max |logit| of an uncached
    prefill, no eager step; the session file saved and loaded, its entries
    byte-equal under the ml_dtypes name."""
    import tempfile

    import numpy as np
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    greedy = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    q = quant.runner
    r = ModelRunner(q.params, q.cfg, max_seq=q.max_seq, kv_format="f8_e4m3",
                    device=q.device)
    tok = quant.tokenizer
    a_text = " ".join([PROMPT] * 3)
    b_text = a_text + " Five more wizards jump."
    a_ids, ab_ids = tok.encode(a_text), tok.encode(b_text)
    prefilled, hit = [], []
    prefill = r.prefill

    def spy(ids, *a, **kw):
        prefilled.append(len(ids))
        out = prefill(ids, *a, **kw)
        hit[:] = [out[0]]
        return out

    r.prefill = spy
    eng = Engine(r, tok, EngineConfig(kv_format="f8_e4m3", prompt_cache=True),
                 quant.gguf)
    eng.generate(a_text, max_tokens=4, sampler=greedy)
    eng.generate(b_text, max_tokens=4, sampler=greedy)
    del r.prefill
    s = eng.prompt_cache.stats
    check((s.hits, s.misses) == (1, 1)
          and prefilled == [len(a_ids), len(ab_ids) - len(a_ids)]
          and r.eager_steps == 0,
          f"16a f8 prompt cache: hits {s.hits}, misses {s.misses}, "
          f"prefills {prefilled}, eager steps {r.eager_steps}")
    want = r.prefill(ab_ids, r.init_kv(1), host=True)[0]
    diff = float(np.abs(hit[0] - want).max())
    check(diff <= 1e-3 * float(np.abs(want).max()),
          f"16a f8 prompt cache: a hit's logits differ by {diff:.4g}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "f8.bin")
        n = eng.save_prompt_cache(path)
        loaded = PromptCache()
        check(loaded.load(path) == n >= 1, "16a f8 prompt cache: entries")
        for key, e in eng.prompt_cache._entries.items():
            f = loaded._entries[key]
            check(e.dtypes == f.dtypes and set(e.dtypes.values()) == {
                "float8_e4m3fn"} and all(
                np.array_equal(e.arrays[k].view(np.uint8),
                               f.arrays[k].view(np.uint8))
                for k in e.arrays), "16a f8 prompt cache: file bytes")
        size = os.path.getsize(path)
    print(json.dumps({"f8_prompt_cache": dict(
        prompt_tokens=[len(a_ids), len(ab_ids)], prefilled=prefilled,
        hit_logits_max_diff=diff, max_abs_logit=float(np.abs(want).max()),
        session_file_bytes=size, card=card)}), flush=True)


def ring_path(card: str, timer, peaks: dict, gguf: str):
    """Phase 16b on gemma-3-4b-l6 (``gguf``). Returns (measurements,
    launches, batched launches)."""
    import torch
    from llama_gguf_tpu_torch.engine.engine import EngineConfig, make_runner
    from llama_gguf_tpu_torch.engine.runner import ModelRunner, read_bucket
    from llama_gguf_tpu_torch.models import kv as KV

    t_phase = time.perf_counter()
    load_s = {}
    quant, deq = load_both(gguf, load_s, max_context_len=GEMMA_SEQ)
    r, cfg, params = quant.runner, quant.runner.cfg, quant.runner.params
    shape = dict(hidden_size=cfg.hidden_size, vocab_size=cfg.vocab_size,
                 heads=(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                 ffn=cfg.intermediate_size, window=cfg.sliding_window,
                 swa_pattern=cfg.swa_pattern, layers=cfg.num_layers)
    check(shape == GEMMA_SHAPE, f"unexpected {GEMMA_LABEL} shape {shape}")
    check(r.ring_slots == deq.runner.ring_slots == GEMMA_RING
          and r.ring_chunk == 1024 and "k_swa" in r.init_kv(1),
          f"{GEMMA_LABEL}: ring {r.ring_slots}, chunk {r.ring_chunk}")
    nbytes = step_bytes(params)
    log(f"{GEMMA_LABEL}: loaded in {load_s}; {nbytes} weight bytes a step")

    # kernels 1-3 at the path's own projections (every FFN down is Q6_K,
    # the tied head Q6_K too) and row counts: a decode step, the batched
    # engine's rows, the prompt's bucket, 512, and the ring's 1,024-token
    # prefill chunk (the head sees one row a sequence)
    layer = params["layers"][0]
    check(layer["ffn"]["down"].fmt == params["output"].fmt == "q8",
          f"{GEMMA_LABEL}: down {layer['ffn']['down'].fmt}, head "
          f"{params['output'].fmt}")
    measurements = projection_checks([
        ("qmatmul_q4", "qkv", layer["attn"]["wqkv"]),
        ("qmatmul_q4", "o_proj", layer["attn"]["wo"]),
        ("qmatmul_glu", "gate|up", layer["ffn"]["gate_up"]),
        ("qmatmul_q8", "ffn_down", layer["ffn"]["down"]),
    ], ROWS + (r.ring_chunk,), timer, peaks, GEMMA_LABEL,
        act=cfg.hidden_act.value)
    measurements += projection_checks([
        ("qmatmul_q8", "tied lm_head", params["output"])],
        ROWS, timer, peaks, GEMMA_LABEL)

    # the main path as in phase 4: exact launches, quant against dequant
    per = hybrid_launches_per_step(params, cfg)
    launches, by_path, decoded, ids = run_main_path(
        quant, deq, card, GEMMA_LABEL,
        near_tie=hybrid_near_tie(deq, GEMMA_LABEL), logit_rel=True)
    exact_launches(GEMMA_LABEL, launches, decoded, per)

    # the ring against the full cache on a prompt that wraps it
    long_ids = repo_text_ids(quant.tokenizer, GEMMA_PROMPT)
    full = ModelRunner(params, cfg, max_seq=GEMMA_SEQ, swa_ring=False,
                       device=r.device)
    steps_t = []
    step = r.step
    r.step = lambda toks, *a, **kw: (steps_t.append(len(toks[0])),
                                     step(toks, *a, **kw))[1]
    t0 = time.perf_counter()
    ring_toks, ring_rows = step_logits(r, long_ids, GEMMA_STEPS + 1)
    sync()
    ring_s = time.perf_counter() - t0
    del r.step
    check(steps_t[:3] == [1024, 1024, 512],
          f"{GEMMA_LABEL}: the long prefill's steps {steps_t[:3]}")
    full_toks, full_rows = step_logits(full, long_ids, GEMMA_STEPS + 1)
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(ring_rows, full_rows)]
    check(ring_toks == full_toks and max(rel) <= 1e-5,
          f"{GEMMA_LABEL}: ring tokens {ring_toks} vs full {full_toks}, "
          f"logits {max(rel):.3g} of max |logit|")
    # the ring's slots after the run: every slot written, the newest
    # positions kept
    kv = r.init_kv(1)
    _, kv, pos = r.prefill(long_ids, kv)
    slots = kv["swa_pos"][0][0, :GEMMA_RING]
    check(int(slots.min()) == GEMMA_PROMPT - GEMMA_RING
          and int(slots.max()) == GEMMA_PROMPT - 1,
          f"{GEMMA_LABEL}: ring slots hold {int(slots.min())}.."
          f"{int(slots.max())}")
    del full
    torch.cuda.empty_cache()

    # memory: ring against full at GEMMA_MEMORY_SEQ (shapes only)
    mem = {}
    for label, ring in (("ring", GEMMA_RING), ("full", 0)):
        mem[label] = KV.memory_bytes(KV.init_cache(
            cfg.num_layers, 1, GEMMA_MEMORY_SEQ, cfg.cache_kv_heads,
            cfg.cache_k_dim, v_head_dim=cfg.cache_v_dim, device="meta",
            swa_layers=r.swa_layers, ring_slots=ring))
    # a greedy profile against the bound (weights + the cache it needs:
    # the live keys, which the rings' whole reads exceed)
    prof = profile_decode(quant, ids, mode="greedy")
    keys = profiled_keys(ids)
    bound_pos = read_bucket(len(ids) + 17, r.max_seq)
    cache_b, cache_read = kv_step_bytes(r.init_kv(1), keys, bound_pos,
                                        cfg.sliding_window)
    bound = (nbytes + cache_b) / peaks["bytes"] * 1e3
    bench_json(GEMMA_LABEL, quant, card)
    # the context shift takes the full cache
    shift_runner = make_runner(params, cfg, EngineConfig(
        context_shift=True, max_context_len=GEMMA_SEQ), r.device)
    check(shift_runner.ring_slots == 0
          and "k_swa" not in shift_runner.init_kv(1),
          f"{GEMMA_LABEL}: the context shift's runner keeps a ring")
    del shift_runner
    torch.cuda.empty_cache()
    print(json.dumps({"ring": dict(
        path=GEMMA_LABEL, load_s=load_s, ring_slots=r.ring_slots,
        ring_chunk=r.ring_chunk, prompt_tokens=GEMMA_PROMPT,
        prefill_steps=steps_t[:3], greedy_steps=GEMMA_STEPS,
        ring_vs_full_max_rel=max(rel), ring_vs_full_prefill_rel=rel[0],
        ring_run_s=ring_s, launches=launches, launches_by_path=by_path,
        memory_bytes_at=GEMMA_MEMORY_SEQ, memory_ring=mem["ring"],
        memory_full=mem["full"], memory_ratio=mem["ring"] / mem["full"],
        weight_bytes=nbytes, cache_bytes_needed=cache_b,
        cache_bytes_read=cache_read, mean_keys=keys,
        read_bound_positions=bound_pos, step_bound_ms=bound,
        read_bound_ms=(nbytes + cache_read) / peaks["bytes"] * 1e3,
        device_ms_per_greedy_step=prof["device_ms_per_step"],
        device_idle_share=prof["device_idle_share"],
        kernels_per_step=prof["kernels_launched_per_step"],
        top_kernels_ms=dict(list(
            prof["device_ms_per_step_by_kernel"].items())[:8]),
        card=card)}), flush=True)
    del deq
    torch.cuda.empty_cache()
    batched = hybrid_batched(quant, card, GEMMA_LABEL, chunk=512,
                             requests=GEMMA_REQUESTS)
    log(f"phase 16b done in {time.perf_counter() - t_phase:.1f}s")
    return measurements, launches, batched


def paged_check(card: str) -> None:
    """Phase 16c: the paged pool (models/paged.py) on the card: appends
    across blocks, a copy-on-write fork, both sequences diverging; the
    gathers equal the same calls' on the CPU bit for bit."""
    import numpy as np
    import torch
    from llama_gguf_tpu_torch.models.paged import PagedKVPool

    rng = np.random.default_rng(SEED + 16)
    toks = [torch.from_numpy(rng.normal(size=(2, 4, 64)).astype(np.float32))
            for _ in range(9)]
    out = {}
    for dev in ("cpu", "cuda"):
        pool = PagedKVPool(2, 8, 4, 64, block_size=4, device=dev)
        pool.create("a")
        for t in toks[:6]:
            pool.append("a", t, t * 2)
        pool.fork("a", "b")
        pool.append("a", toks[6], toks[6])
        pool.append("b", toks[7], toks[7])
        pool.append("b", toks[8], toks[8])
        out[dev] = [x.cpu() for seq in ("a", "b")
                    for x in pool.gather(seq, max_blocks=4)[:2]] + [
            pool.tables["a"].blocks, pool.tables["b"].blocks,
            pool.allocator.free_blocks]
    same = all(torch.equal(a, b) for a, b in zip(out["cpu"][:4],
                                                 out["cuda"][:4]))
    check(same and out["cpu"][4:] == out["cuda"][4:],
          f"16c: the card's pool differs from the CPU's ({out['cuda'][4:]} "
          f"vs {out['cpu'][4:]})")
    print(json.dumps({"paged_pool": dict(
        bit_equal=True, tables=out["cuda"][4:6], free_blocks=out["cuda"][6],
        card=card)}), flush=True)


# Phase 17: the encoder models (ROADMAP queue 1 item 11). 17a:
# bge-base-en-v1.5 (BertModel, full depth and width) through
# BertEncoder.encode, Engine.embed and /v1/embeddings; 17b: flan-t5-base
# (12 + 12 layers, full width) through Engine.generate, greedy_tokens and
# the CLI's run, its decoder step a CUDA graph, and its t5encoder variant;
# 17c: an ONNX export of the tiny preset through Engine.load. Their GGUFs
# build in a seventh child process (utils/synthetic.ENCODER_PRESETS)
BGE_PRESET = "bge-base-en-v1.5"
T5_PRESET = "flan-t5-base"
T5ENC_PRESET = "flan-t5-base-encoder"
BGE_SHAPE = dict(layers=12, hidden=768, heads=12, ffn=3072, vocab=30522,
                 positions=512, types=2)
T5_SHAPE = dict(enc=12, dec=12, hidden=768, heads=12, head_dim=64, ffn=2048,
                vocab=32128, buckets=32, max_distance=128, untied=True)
ENCODER_ROWS = (1, 8, 512)  # 17a-b: a decoder step, a short input, 512
BERT_SEQS = 32  # 17a: sequences of 8-512 tokens ...
BERT_BATCH = 8  # ... encoded 8 at a time (8 x 512 = 4,096 rows at most)
T5_INPUT = 512  # 17b: encoder tokens, the trailing EOS included
T5_STEPS = 64  # 17b: greedy decoder steps
T5_SHORT = 16  # 17b: the short input after the long one
GRAPH_REL = 2e-4  # 17b: graphed against eager steps, of max |logit|
QUANT_REL = 1e-3  # 17a-b: quant against dequant, of max |value|
BATCH_REL = 1e-5  # 17a: a sequence in its batch against it alone


def linear_launches(items) -> dict[str, int]:
    """Kernel launches of one pass over ``items``, (linear, glu) pairs: a
    QuantLinear runs kernel 1 or 2 by its layout, a fused gate|up kernel 3
    (glu); a dense weight none."""
    from llama_gguf_tpu_torch.ops.linear import QuantLinear

    out: dict[str, int] = {}
    for lin, glu in items:
        if isinstance(lin, QuantLinear):
            key = "qmatmul_glu" if glu else f"qmatmul_{lin.fmt}"
            out[key] = out.get(key, 0) + 1
    return out


def _block_items(layer: dict, attn_keys=("wqkv", "wq", "wk", "wv", "wo")):
    items = [(layer["attn"][k], False) for k in attn_keys
             if k in layer["attn"]]
    ffn = layer["ffn"]
    if "gate_up" in ffn:
        items.append((ffn["gate_up"], True))
    items += [(ffn[k], False) for k in ("gate", "up") if k in ffn]
    return items + [(ffn["down"], False)]


def encoder_launches(params: dict, t5: bool) -> dict[str, dict[str, int]]:
    """The launches derived from a loaded encoder model: BERT's forward
    ("encode"); T5's encoder forward, the cross K/V projection of a
    request ("cross") and one decoder step ("step")."""
    if not t5:
        return {"encode": linear_launches(
            [it for layer in params["layers"] for it in _block_items(layer)])}
    dec = params["dec"]["layers"]
    step = [it for layer in dec for it in _block_items(layer)]
    step += [(layer["cross"][k], False) for layer in dec
             for k in ("wq", "wo")]
    step.append((params.get("output"), False))
    return {
        "encode": linear_launches([it for layer in params["enc"]["layers"]
                                   for it in _block_items(layer)]),
        "cross": linear_launches([(layer["cross"][k], False) for layer in dec
                                  for k in ("wk", "wv")]),
        "step": linear_launches(step)}


def exact_kernels(label: str, got: dict, want: dict) -> None:
    for name in ("qmatmul_q4", "qmatmul_q8", "qmatmul_glu", "moe_slot",
                 "moe_grouped", "moe_glu_grouped"):
        check(got.get(name, 0) == want.get(name, 0),
              f"{label}: {name} launched {got.get(name, 0)} times, derived "
              f"{want.get(name, 0)}")


def scaled(counts: dict, times: int) -> dict:
    return {k: v * times for k, v in counts.items()}


def added(*counts: dict) -> dict:
    out: dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def quant_bytes(lins) -> int:
    """Device bytes of the QuantLinear weights among ``lins``."""
    from llama_gguf_tpu_torch.ops.linear import QuantLinear

    return sum(t.numel() * t.element_size() for lin in lins
               if isinstance(lin, QuantLinear)
               for t in (lin.packed, lin.scales, lin.mins, lin.bias)
               if t is not None)


def rel_diff(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def bert_path(card: str, timer, peaks: dict, gguf: str):
    """Phase 17a on bge-base-en-v1.5 (``gguf``). Returns (measurements,
    launches)."""
    import socket
    import threading

    import numpy as np
    import torch
    from llama_gguf_tpu_torch.client import RemoteChatClient, RemoteError
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.server.app import (ServerConfig, ServerState,
                                                 run_server)
    from llama_gguf_tpu_torch.utils.timing import bound_ms

    t_phase = time.perf_counter()
    load_s: dict[str, float] = {}
    quant, deq = load_both(gguf, load_s)
    enc, cfg = quant.encoder, quant.encoder.cfg
    params = enc.params
    layer = params["layers"][0]
    shape = dict(layers=len(params["layers"]), hidden=cfg.hidden_size,
                 heads=cfg.num_heads, ffn=layer["ffn"]["up"].n,
                 vocab=params["embed"].shape[0],
                 positions=params["position_embed"].shape[0],
                 types=params["type_embed"].shape[0])
    check(shape == BGE_SHAPE and quant.runner is None
          and "wqkv" in layer["attn"], f"unexpected {BGE_PRESET} {shape}")
    measurements = projection_checks([
        ("qmatmul_q4", "qkv", layer["attn"]["wqkv"]),
        ("qmatmul_q4", "o_proj", layer["attn"]["wo"]),
        ("qmatmul_q4", "ffn_up", layer["ffn"]["up"]),
        ("qmatmul_q8", "ffn_down", layer["ffn"]["down"]),
    ], ENCODER_ROWS + (BERT_BATCH * 512,), timer, peaks, BGE_PRESET)

    # the traffic: 32 sequences of 8-512 tokens, 8 at a time
    rng = np.random.default_rng(SEED)
    lens = rng.integers(8, 513, size=BERT_SEQS)
    lens[:2] = (512, 8)
    seqs = [rng.integers(5, cfg.vocab_size, size=int(n)).tolist()
            for n in lens]
    batches = [seqs[i:i + BERT_BATCH] for i in range(0, BERT_SEQS,
                                                      BERT_BATCH)]
    per = encoder_launches(params, t5=False)["encode"]
    enc.encode(batches[0])  # warm-up: cuBLAS handles, kernel workspaces
    torch.cuda.synchronize()
    Q.reset_launches()
    t0 = time.perf_counter()
    outs = [enc.encode(b) for b in batches]  # each ends in a host copy
    wall = time.perf_counter() - t0
    launches = dict(Q.LAUNCHES)
    exact_kernels(BGE_PRESET, launches, scaled(per, len(batches)))
    padded = sum(len(b) * o.shape[1] for b, o in zip(batches, outs))
    # quant against dequant, each sequence's real rows
    worst = 0.0
    for b, o in zip(batches, outs):
        d = deq.encoder.encode(b)
        for i, ids in enumerate(b):
            worst = max(worst, rel_diff(o[i, :len(ids)], d[i, :len(ids)]))
    check(worst <= QUANT_REL, f"{BGE_PRESET}: quant hidden states differ "
                              f"from dequant by {worst:.3g} of max |h|")
    # a sequence in its ragged batch against it alone
    alone = 0.0
    for j in (0, 1, BERT_BATCH - 1):
        ids = batches[0][j]
        alone = max(alone, rel_diff(outs[0][j, :len(ids)],
                                    enc.encode([ids])[0, :len(ids)]))
    check(alone <= BATCH_REL, f"{BGE_PRESET}: a sequence in its batch "
                              f"differs from it alone by {alone:.3g}")
    # Engine.embed (CLS pooling, normalized)
    texts = ["the quick brown fox jumps over the lazy dog",
             "embedding search query: a passage about a model",
             ("the lazy dog " * 30).strip()]
    vecs = [quant.embed(t, pooling="first") for t in texts]
    norms = [float(np.linalg.norm(v)) for v in vecs]
    check(all(abs(n - 1) < 1e-5 for n in norms), f"{BGE_PRESET}: norms "
                                                 f"{norms}")
    # device time of one full batch (8 x 512) against its bound
    full = [rng.integers(5, cfg.vocab_size, size=512).tolist()
            for _ in range(BERT_BATCH)]
    prof = summarize(lambda: enc.encode(full), 1)
    rows = BERT_BATCH * 512
    lins = [lin for lay in params["layers"] for lin, _ in _block_items(lay)]
    weights = quant_bytes(lins)
    nbytes = weights + 2 * rows * cfg.hidden_size * 4
    ops = sum(2 * rows * lin.k * lin.n for lin in lins) + \
        len(params["layers"]) * 4 * BERT_BATCH * 512 * 512 * cfg.hidden_size
    bound, by = bound_ms(nbytes, ops, "bf16x3", peaks)
    device = prof["device_ms_per_step"]

    # /v1/embeddings over HTTP on the same engine, and the 400 body
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    config = ServerConfig(port=port, device="cuda")
    state = ServerState(config)
    state.serve_engine(quant, gguf)
    check(state.batched is None, f"{BGE_PRESET}: a scheduler for an encoder")
    server = threading.Thread(target=run_server, args=(config, state),
                              daemon=True)
    server.start()
    client = RemoteChatClient(f"http://127.0.0.1:{port}", timeout=600)
    try:
        for _ in range(100):
            try:
                if client.health()["status"] == "ok":
                    break
            except OSError:
                time.sleep(0.1)
        http = client.embed(texts)
        refused = None
        try:
            client.complete("hello")
        except RemoteError as e:
            refused = str(e)
    finally:
        state.shutdown()
        server.join(timeout=30)
    check(not server.is_alive(), f"{BGE_PRESET}: the server did not stop")
    want = [quant.embed(t) for t in texts]
    http_err = max(float(np.abs(np.asarray(h) - w).max())
                   for h, w in zip(http, want))
    check(http_err <= 1e-5, f"{BGE_PRESET}: /v1/embeddings differs from "
                            f"Engine.embed by {http_err:.3g}")
    check(refused == "HTTP 400: this model does not support text "
                     "generation; use /v1/embeddings",
          f"{BGE_PRESET}: /v1/completions answered {refused!r}")
    print(json.dumps({"bert": dict(
        path=BGE_PRESET, sequences=BERT_SEQS, real_tokens=int(lens.sum()),
        padded_tokens=padded, seconds=wall, sequences_per_s=BERT_SEQS / wall,
        tokens_per_s=float(lens.sum()) / wall,
        batch_8x512_device_ms=device, batch_8x512_bound_ms=bound,
        bound_by=by, bound_bytes=nbytes, bound_ops=ops,
        bound_share=(bound / device if isinstance(device, float)
                     else "not measured"),
        batch_8x512_wall_ms=prof["wall_ms_per_step"],
        batch_8x512_idle_share=prof["device_idle_share"],
        kernels_per_batch=prof["kernels_launched_per_step"],
        device_ms_by_kernel=prof["device_ms_per_step_by_kernel"],
        launches=launches, launches_per_forward=per,
        quant_vs_dequant=worst, batch_vs_alone=alone, embed_norms=norms,
        http_vs_engine=http_err, load_s=load_s, card=card)}), flush=True)
    del deq
    log(f"phase 17a done in {time.perf_counter() - t_phase:.1f}s")
    return measurements, launches


def t5_input_text(tokenizer, n: int) -> str:
    """A text the tokenizer spells in exactly ``n`` tokens: PROMPT repeated,
    then single letters (each one byte-fallback token)."""
    text = PROMPT
    while len(tokenizer.encode(text + " " + PROMPT)) <= n:
        text += " " + PROMPT
    for _ in range(8):
        short = n - len(tokenizer.encode(text))
        if short <= 0:
            break
        text += "a" * short
    check(len(tokenizer.encode(text)) == n, f"no text of {n} tokens")
    return text


def t5_path(card: str, timer, peaks: dict, gguf: str, enc_gguf: str):
    """Phase 17b on flan-t5-base (``gguf``) and its t5encoder variant
    (``enc_gguf``). Returns (measurements, launches)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from llama_gguf_tpu_torch import cli
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.models import t5 as T5
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops.linear import QuantLinear
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    t_phase = time.perf_counter()
    load_s: dict[str, float] = {}
    quant, deq = load_both(gguf, load_s)
    t5, cfg, params = quant.t5, quant.t5.cfg, quant.t5.params
    dl = params["dec"]["layers"][0]
    shape = dict(enc=len(params["enc"]["layers"]),
                 dec=len(params["dec"]["layers"]), hidden=cfg.hidden_size,
                 heads=cfg.num_heads, head_dim=cfg.head_dim,
                 ffn=dl["ffn"]["gate_up"].splits[0],
                 vocab=params["embed"].shape[0], buckets=cfg.rel_buckets,
                 max_distance=cfg.rel_max_distance,
                 untied=isinstance(params.get("output"), QuantLinear))
    check(shape == T5_SHAPE and "wqkv" in dl["attn"]
          and isinstance(dl["ffn"]["gate_up"], QuantLinear),
          f"unexpected {T5_PRESET} {shape}")
    measurements = projection_checks([
        ("qmatmul_q4", "self qkv", dl["attn"]["wqkv"]),
        ("qmatmul_q4", "o_proj (cross q, k, v, o)", dl["attn"]["wo"]),
        ("qmatmul_glu", "gate|up", dl["ffn"]["gate_up"]),
        ("qmatmul_q8", "ffn_down", dl["ffn"]["down"]),
        ("qmatmul_q8", "lm_head", params["output"]),
    ], ENCODER_ROWS, timer, peaks, T5_PRESET, act="gelu")

    greedy = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    eos = quant.tokenizer.eos_id
    text = t5_input_text(quant.tokenizer, T5_INPUT - 1)  # + the EOS
    ids = quant._t5_encoder_ids(text)
    check(len(ids) == T5_INPUT and T5_INPUT <= t5.enc_capacity,
          f"{len(ids)} encoder tokens, capacity {t5.enc_capacity}")
    per = encoder_launches(params, t5=True)
    quant.generate(text, max_tokens=2, sampler=greedy)  # capture, uncounted
    torch.cuda.synchronize()
    Q.reset_launches()
    t5.eager_steps = 0
    replays0 = sum(t5.replays.values())
    out = quant.generate(text, max_tokens=T5_STEPS, sampler=greedy)
    launches = dict(Q.LAUNCHES)
    stats = quant.stats
    steps = sum(t5.replays.values()) - replays0
    check(t5.eager_steps == 0 and steps >= 1,
          f"{T5_PRESET}: {t5.eager_steps} eager steps, {steps} replays")
    exact_kernels(T5_PRESET, launches, added(
        per["encode"], per["cross"], scaled(per["step"], steps)))
    print(f"{T5_PRESET} main path: {stats.prompt_tokens} encoder tokens in "
          f"{stats.prefill_time * 1e3:.1f} ms (encode + cross K/V), decode "
          f"{stats.generated_tokens} tok @ {stats.decode_tps:.1f} tok/s over "
          f"{steps} graphed steps, launches {launches} | {card}", flush=True)

    # graphed against eager; quant against dequant; greedy_tokens
    g_l, e_l, d_l = [], [], []
    toks = t5.generate_ids(ids, T5_STEPS, eos, record=g_l)
    eager = t5.generate_ids(ids, T5_STEPS, eos, eager=True, record=e_l)
    check(toks == eager, f"{T5_PRESET}: graphed tokens {toks[:8]} != eager "
                         f"{eager[:8]}")
    graph_err = max(rel_diff(a, b) for a, b in zip(g_l, e_l))
    check(graph_err <= GRAPH_REL, f"{T5_PRESET}: graphed logits differ from "
                                  f"eager by {graph_err:.3g}")
    check(quant.greedy_tokens(text, T5_STEPS) == toks,
          f"{T5_PRESET}: greedy_tokens != the runner's tokens")
    want = deq.t5.generate_ids(ids, T5_STEPS, eos, record=d_l)
    margins = []
    for row in d_l:
        top2 = np.sort(row)[-2:]
        margins.append(float((top2[1] - top2[0]) / np.abs(row).max()))
    tie = same_until_tie(T5_PRESET, toks, want, margins)
    upto = len(g_l) if tie["first_diff"] is None else tie["first_diff"] + 1
    deq_err = max(rel_diff(a, b) for a, b in zip(g_l[:upto], d_l[:upto]))
    check(deq_err <= QUANT_REL, f"{T5_PRESET}: quant logits differ from "
                                f"dequant by {deq_err:.3g}")
    # the short input after the long one, against a new runner (a fresh
    # engine's) on the same weights
    short = ids[:T5_SHORT - 1] + [ids[-1]]
    s_l, f_l = [], []
    got = t5.generate_ids(short, T5_STEPS, eos, record=s_l)
    fresh = T5.T5Runner(params, cfg, max_seq=t5.max_seq, device="cuda")
    ref = fresh.generate_ids(short, T5_STEPS, eos, record=f_l)
    reuse_err = max(rel_diff(a, b) for a, b in zip(s_l, f_l))
    check(got == ref and reuse_err <= 1e-6,
          f"{T5_PRESET}: the short input after the long one gave {got[:8]} "
          f"(logits {reuse_err:.3g} off) where a fresh runner gave {ref[:8]}")
    del fresh
    # seeded sampling repeats itself; a stop string does not leak
    sampled = [quant.generate(text, max_tokens=32, sampler=SamplerConfig(
        temperature=0.8, seed=7)) for _ in range(2)]
    check(sampled[0] == sampled[1], f"{T5_PRESET}: seeded runs differ")
    stop = sampled[0][len(sampled[0]) // 2:][:3]
    stopped = quant.generate(text, max_tokens=32, sampler=SamplerConfig(
        temperature=0.8, seed=7), stop=[stop]) if stop else ""
    check(not stop or (stopped == sampled[0][:sampled[0].index(stop)]
                       and stop not in stopped),
          f"{T5_PRESET}: stop {stop!r} gave {stopped!r} of {sampled[0]!r}")

    # where the time goes: encode and cross K/V (CUDA events), graphed
    # steps (torch.profiler) against the step's byte bound
    def events_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    with torch.no_grad():
        enc_out, _ = t5.encode_ids(ids)
        encode_ms = events_ms(lambda: t5.encode_ids(ids))
        cross_ms = events_ms(lambda: T5.t5_cross_kv(params, cfg, enc_out))
    sess = t5.begin(ids)
    t5.step_host(sess, cfg.decoder_start_token_id, 0)
    prof = summarize(lambda: [t5.step_host(sess, 5, t)
                              for t in range(1, 17)], 16)
    dec = params["dec"]["layers"]
    lins = [lin for layer in dec for lin, _ in _block_items(layer)]
    lins += [layer["cross"][k] for layer in dec for k in ("wq", "wo")]
    lins.append(params["output"])
    caches = 2 * len(dec) * (t5.max_seq + t5.enc_capacity) * \
        cfg.num_heads * cfg.head_dim * 4
    nbytes = quant_bytes(lins) + caches
    bound = nbytes / peaks["bytes"] * 1e3
    device = prof["device_ms_per_step"]
    key = ("t5", t5.enc_capacity)
    print(json.dumps({"t5": dict(
        path=T5_PRESET, encoder_tokens=len(ids), decode_tps=stats.decode_tps,
        prefill_ms=stats.prefill_time * 1e3, encode_ms=encode_ms,
        cross_kv_ms=cross_ms, step_device_ms=device,
        step_wall_ms=prof["wall_ms_per_step"],
        step_idle_share=prof["device_idle_share"],
        kernels_per_step=prof["kernels_launched_per_step"],
        device_ms_by_kernel=prof["device_ms_per_step_by_kernel"],
        kernels_1_3_ms_per_step=(prof["kernels_1_2_ms_per_step"]
                                 + prof["kernel_3_ms_per_step"]),
        step_byte_bound_ms=bound, step_bytes=nbytes, cache_bytes=caches,
        bound_share=(bound / device if isinstance(device, float)
                     else "not measured"),
        capture_s=t5._graphs[key].capture_s if key in t5._graphs else None,
        graphs=len(t5._graphs),
        pool_bytes=t5.pool_bytes, launches=launches,
        launches_per_step=per["step"], launches_per_request=added(
            per["encode"], per["cross"]), graph_vs_eager=graph_err,
        quant_vs_dequant=deq_err, near_tie=tie, short_after_long=reuse_err,
        generated=out[:40], load_s=load_s, card=card)}), flush=True)
    del deq, sess
    torch.cuda.empty_cache()

    # the t5encoder variant: embeddings, and generation refused
    t0 = time.perf_counter()
    encoder = Engine.load(enc_gguf, EngineConfig(weight_mode="quant"),
                          device="cuda")
    vec = encoder.embed("the quick brown fox")
    check(abs(float(np.linalg.norm(vec)) - 1) < 1e-5 and
          vec.shape == (cfg.hidden_size,), f"{T5ENC_PRESET}: embedding")
    try:
        encoder.generate("hello", max_tokens=4)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, f"{T5ENC_PRESET}: generate did not raise")
    log(f"{T5ENC_PRESET}: loaded and checked in "
        f"{time.perf_counter() - t0:.1f}s")
    del encoder
    # the CLI's run on the GGUF (its own load, on the card by default)
    out_io, err_io = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_io), \
            contextlib.redirect_stderr(err_io):
        rc = cli.main(["run", gguf, "-p", PROMPT, "-n", "8",
                       "--temperature", "0", "--no-stream"])
    decoded = re.search(r"decode (\d+) tok @", err_io.getvalue())
    check(rc == 0 and decoded is not None,
          f"{T5_PRESET}: the CLI's run gave {rc}, {out_io.getvalue()!r}, "
          f"{err_io.getvalue()[-300:]!r}")
    log(f"{T5_PRESET}: the CLI's run took {time.perf_counter() - t0:.1f}s: "
        f"{err_io.getvalue().strip()[-80:]}")
    log(f"phase 17b done in {time.perf_counter() - t_phase:.1f}s")
    return measurements, launches


def onnx_path(card: str) -> None:
    """Phase 17c: the tiny preset's F32 GGUF exported as an HF-Optimum-style
    ONNX directory (onnx/export.py: model.onnx, config.json, a Unigram
    tokenizer.json) and loaded by Engine.load on the card: its greedy tokens
    equal the GGUF's, and the tokenizer round-trips its texts."""
    import tempfile

    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.onnx.export import export_gguf

    t0 = time.perf_counter()
    gguf = build_model("tiny", "F32")
    with tempfile.TemporaryDirectory() as d:
        path = export_gguf(gguf, d)
        onnx = Engine.load(path, EngineConfig(), device="cuda")
        ref = Engine.load(gguf, EngineConfig(weight_mode="dequant"),
                          device="cuda")
        ids = [5, 77, 300, 12, 9, 401, 33, 250]
        got, want = onnx.greedy_tokens(ids, 16), ref.greedy_tokens(ids, 16)
        check(got == want, f"ONNX greedy tokens {got} != the GGUF's {want}")
        texts = ["hello world", "the quick brown fox jumps over the lazy dog",
                 "onnx model export 42!"]
        back = [onnx.tokenizer.decode(onnx.tokenizer.encode(t))
                for t in texts]
        check(back == texts, f"tokenizer.json round trip {back}")
    seconds = time.perf_counter() - t0
    print(json.dumps({"onnx": dict(tokens=got, round_trip=texts,
                                   seconds=seconds, card=card)}), flush=True)
    log(f"phase 17c done in {seconds:.1f}s")


def build_encoders() -> dict:
    """Phase 17's GGUFs, built in a child process."""
    return {p: build_model(p) for p in (BGE_PRESET, T5_PRESET, T5ENC_PRESET)}


def encoder_path(card: str, timer, peaks: dict, builds: dict):
    """Phase 17 (a, b, c). Returns (measurements, launches by path)."""
    import torch

    t0 = time.perf_counter()
    bert, bert_launches = bert_path(card, timer, peaks, builds[BGE_PRESET])
    torch.cuda.empty_cache()
    t5m, t5_launches = t5_path(card, timer, peaks, builds[T5_PRESET],
                               builds[T5ENC_PRESET])
    torch.cuda.empty_cache()
    onnx_path(card)
    seconds = time.perf_counter() - t0
    print(json.dumps({"phase_17": dict(seconds=seconds, card=card)}),
          flush=True)
    log(f"phase 17 took {seconds:.1f}s")
    return bert + t5m, {BGE_PRESET: bert_launches, T5_PRESET: t5_launches}


# Phase 18: the load path (ROADMAP queue 1 item 7) and MoE routing beyond
# softmax-top-k (item 9). 18a: tinyllama-1.1b-l2 loaded as the parent commit
# loaded it (a child process with LLAMA_GGUF_NO_NATIVE=1 and
# LLAMA_GGUF_NO_REPACK_CACHE=1), cold with the native library, and from the
# repack sidecar; 18b: gpt-oss-20b-l2 (openai/gpt-oss-20b's widths, 2 of 24
# layers; utils/synthetic.ROUTING_PRESETS); 18c: the tiny gpt-oss, PhiMoE
# and llama4 presets
LOAD_PRESET = "tinyllama-1.1b-l2"
OSS_PRESET = "gpt-oss-20b-l2"
OSS_LABEL = "gpt-oss-20b-l2"
# heads (query, KV, head_dim), experts (count, top-k, expert ffn), the
# window and its pattern, RoPE (base, scaling)
OSS_SHAPE = dict(hidden_size=2880, vocab_size=201088, heads=(64, 8, 64),
                 experts=(32, 4, 2880), window=(128, 2),
                 rope=(150000.0, "yarn"), act="swiglu_oai")
OSS_PROMPT = " ".join([PROMPT] * 4)  # past the 128-token window
ROUTING_TINY = ("tiny-gpt-oss", "tiny-phimoe", "tiny-llama4")
LOADS: list[dict] = []  # every load_both's seconds, in order
SIDECAR_MIN_S = 0.5  # 18d: the paths whose cold quant load took this long

CHILD_LOADS = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from llama_gguf_tpu_torch import native
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
torch.zeros(1, device="cuda")  # the CUDA context, outside the timed loads
out = {{}}
for mode in ("quant", "dequant"):
    t0 = time.perf_counter()
    Engine.load({path!r}, EngineConfig(weight_mode=mode), device="cuda")
    out[mode] = time.perf_counter() - t0
out["counts"] = {{k: dict(v) for k, v in native.COUNTS.items()}}
print(json.dumps(out))
"""


def native_counts() -> dict:
    """The native library's counters (native.COUNTS) as plain dicts."""
    from llama_gguf_tpu_torch import native

    return {k: dict(v) for k, v in native.COUNTS.items()}


def same_params(a, b, where: str = "params") -> int:
    """Check two params trees equal, bit for bit (tensors torch.equal, the
    leaves' dataclass fields alike); returns the number of tensors."""
    import dataclasses

    import torch

    if isinstance(a, dict):
        check(isinstance(b, dict) and a.keys() == b.keys(),
              f"{where}: keys differ")
        return sum(same_params(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        check(type(a) is type(b) and len(a) == len(b), f"{where}: lengths")
        return sum(same_params(x, y, f"{where}.{i}")
                   for i, (x, y) in enumerate(zip(a, b)))
    if dataclasses.is_dataclass(a):
        check(type(a) is type(b), f"{where}: leaf types differ")
        return sum(same_params(getattr(a, f.name), getattr(b, f.name),
                               f"{where}.{f.name}")
                   for f in dataclasses.fields(a))
    if torch.is_tensor(a):
        check(torch.is_tensor(b) and a.dtype == b.dtype
              and a.shape == b.shape and torch.equal(a, b),
              f"{where}: tensors differ")
        return 1
    check(a == b, f"{where}: {a!r} != {b!r}")
    return 0


def load_path(card: str, gguf: str) -> dict:
    """Phase 18a on tinyllama-1.1b-l2 Q4_K_M (``gguf``): each mode's load
    seconds (Engine.load, one mode at a time) before (a child process on
    the parent commit's load path: numpy dequant and repack, no sidecar),
    cold (the native library; the quant load writes the sidecar) and from
    the sidecar. Gates: the child's bulk calls all went to numpy and this
    process's all native; the sidecar load repacked nothing and its params
    equal the cold load's, bit for bit. Returns the seconds."""
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig

    t_phase = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", CHILD_LOADS.format(root=ROOT, path=gguf)],
        env=dict(os.environ, LLAMA_GGUF_NO_NATIVE="1",
                 LLAMA_GGUF_NO_REPACK_CACHE="1"),
        capture_output=True, text=True, timeout=900)
    check(res.returncode == 0, f"18a: the child's loads failed: "
                               f"{res.stderr[-2000:]}")
    before = json.loads(res.stdout.strip().splitlines()[-1])
    child = before.pop("counts")
    check(not child["native"] and sum(child["numpy"].values()) > 0,
          f"18a: LLAMA_GGUF_NO_NATIVE=1 did not select numpy: {child}")
    sidecar = gguf + ".repack"
    if os.path.exists(sidecar):  # a cold load starts without one
        os.remove(sidecar)
    seconds = {}

    def load(mode):
        t0 = time.perf_counter()
        engine = Engine.load(gguf, EngineConfig(weight_mode=mode),
                             device="cuda")
        torch.cuda.synchronize()
        return engine, time.perf_counter() - t0

    counts0 = native_counts()
    cold, seconds["cold quant"] = load("quant")
    check(os.path.exists(sidecar), f"18a: no sidecar written at {sidecar}")
    deq, seconds["cold dequant"] = load("dequant")
    del deq
    extracts = dict(native_counts()["native"])
    side, seconds["sidecar quant"] = load("quant")
    check(native_counts()["native"] == extracts,
          "18a: the sidecar load repacked a tensor")
    counts = native_counts()
    check(not counts["numpy"], f"18a: bulk calls served by numpy: {counts}")
    tensors = same_params(cold.runner.params, side.runner.params)
    got = {k: v - counts0["native"].get(k, 0)
           for k, v in counts["native"].items()
           if v != counts0["native"].get(k, 0)}
    print(json.dumps({"phase_18a": dict(
        path=LOAD_PRESET, gguf_bytes=os.path.getsize(gguf),
        sidecar_bytes=os.path.getsize(sidecar),
        before_s=before, after_s=seconds, tensors_equal=tensors,
        native_calls=got, child_counts=child,
        wall_s=time.perf_counter() - t_phase, card=card)}), flush=True)
    del cold, side
    torch.cuda.empty_cache()
    return dict(before=before, after=seconds)


def sidecar_loads(card: str) -> list[dict]:
    """Phase 18d: each path's quant load again, from the sidecar its cold
    load wrote (every `load_both` GGUF whose cold quant load took at least
    SIDECAR_MIN_S), one at a time: seconds beside the cold load's. Gate:
    no repack ran (the native extraction counts stand still; tensors the
    loader keeps dense, such as MLA's attn_kv_b, still dequantize)."""
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig

    def extractions():
        return {k: n for k, n in native_counts()["native"].items()
                if k.startswith("extract")}

    out = []
    for cold in LOADS:
        if cold["quant"] < SIDECAR_MIN_S:
            continue
        check(os.path.exists(cold["path"] + ".repack"),
              f"18d: {cold['gguf']} has no sidecar")
        before = extractions()
        t0 = time.perf_counter()
        engine = Engine.load(cold["path"], EngineConfig(weight_mode="quant"),
                             device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(extractions() == before,
              f"18d: {cold['gguf']}'s sidecar load repacked a tensor")
        out.append(dict(gguf=cold["gguf"], cold_quant=cold["quant"],
                        cold_dequant=cold["dequant"], sidecar_quant=seconds))
        del engine
        torch.cuda.empty_cache()
    print(json.dumps({"phase_18d": dict(loads=out, card=card)}), flush=True)
    return out


def bias_bytes(params, topk: int) -> int:
    """Bytes of the biases and sinks a decode step reads: every linear's
    bias, ``topk`` rows of each expert bias, the attention sinks."""
    import torch
    from llama_gguf_tpu_torch.ops.linear import DenseLinear, QuantLinear

    if isinstance(params, dict):
        total = 0
        for k, v in params.items():
            if k.endswith("_bias") and torch.is_tensor(v) and v.dim() == 2:
                total += topk * v[0].numel() * v.element_size()
            elif k == "sinks" and torch.is_tensor(v):
                total += v.numel() * v.element_size()
            else:
                total += bias_bytes(v, topk)
        return total
    if isinstance(params, list):
        return sum(bias_bytes(v, topk) for v in params)
    if isinstance(params, (DenseLinear, QuantLinear)) and \
            params.bias is not None:
        return params.bias.numel() * params.bias.element_size()
    return 0


def oss_path(card: str, timer, peaks: dict, gguf: str):
    """Phase 18b on gpt-oss-20b-l2 (``gguf``): the main path with exact
    launch counts (no grouped GLU: the experts carry biases), quant
    against dequant up to the first near tie, kernels 1, 2, 4 and 5 at the
    model's own shapes, phase 9's graphed-vs-eager gates, a greedy profile
    against the byte bound, bench, the CLI's run (a load from the sidecar
    the cold load wrote) and a B = 4 BatchedEngine. Returns (measurements,
    launches, batched launches)."""
    import contextlib
    import io

    import torch
    from llama_gguf_tpu_torch import cli
    from llama_gguf_tpu_torch.models import transformer as T

    t_phase = time.perf_counter()
    load_s: dict[str, float] = {}
    quant, deq = load_both(gguf, load_s)
    cfg, params = quant.runner.cfg, quant.runner.params
    layers = params["layers"]
    at0, ffn1 = layers[0]["attn"], layers[1]["ffn"]
    ex = ffn1["experts"]
    shape = dict(hidden_size=cfg.hidden_size, vocab_size=cfg.vocab_size,
                 heads=(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                 experts=(cfg.num_experts, cfg.num_experts_per_token,
                          ex["gate"].n),
                 window=(cfg.sliding_window, cfg.swa_pattern),
                 rope=(cfg.rope.freq_base, cfg.rope.scaling_type.value),
                 act=cfg.hidden_act.value)
    check(shape == OSS_SHAPE, f"unexpected {OSS_LABEL} shape {shape}")
    check(all(f"{key}_bias" in layer["ffn"]["experts"] for layer in layers
              for key in ("gate", "up", "down"))
          and all("sinks" in layer["attn"] for layer in layers)
          and all(layer["ffn"]["router"].bias is not None
                  for layer in layers),
          f"{OSS_LABEL}: expert biases, sinks and router biases")
    check(quant.runner.swa_layers == (True, False),
          f"{OSS_LABEL}: sliding layers {quant.runner.swa_layers}")
    layouts = {key: (ex[key].fmt, ex[key].group)
               for key in ("gate", "up", "down")}
    layouts.update(wqkv=(at0["wqkv"].fmt, at0["wqkv"].group),
                   wo=(at0["wo"].fmt, at0["wo"].group),
                   head=(params["output"].fmt, params["output"].group))
    print(f"{OSS_LABEL}: layouts {layouts}, ring slots "
          f"{quant.runner.ring_slots} | {card}", flush=True)
    check(layouts["wo"][0] == "q4" and all(
        layouts[key][0] == "q8" for key in layouts if key != "wo"),
        f"{OSS_LABEL}: layouts {layouts}")

    # the bytes of one decode step: the quantized products, 4 routed
    # experts, the biases and sinks, the router and the head
    biases = bias_bytes(params, cfg.num_experts_per_token)
    nbytes = step_bytes(params, cfg.num_experts_per_token) + biases
    bound = nbytes / peaks["bytes"] * 1e3
    print(f"{OSS_LABEL}: {nbytes} bytes per decode step ({biases} of them "
          f"biases and sinks), bound {bound:.4f} ms | {card}", flush=True)

    # the main path: exact launch counts, no grouped GLU, quant against
    # dequant up to the first near tie
    ids = quant.tokenizer.encode(OSS_PROMPT)
    bucket = next(b for b in (128, 256, 512, 1024) if b >= len(ids))
    per = hybrid_launches_per_step(params, cfg, prefill_rows=bucket)
    launches, by_path, decoded, ids = run_main_path(
        quant, deq, card, OSS_LABEL,
        near_tie=hybrid_near_tie(deq, OSS_LABEL), logit_rel=True,
        prompt=OSS_PROMPT, prompt_tokens=(300, 512))
    exact_launches(OSS_LABEL, launches, decoded, per)
    check(launches.get("moe_glu_grouped", 0) == 0,
          f"{OSS_LABEL}: the grouped GLU ran on biased experts")
    print(json.dumps({"oss_launches_per_step": dict(
        path=OSS_LABEL, prompt_tokens=len(ids), **per,
        launches_by_path=by_path)}), flush=True)

    # kernels 1-2 at the model's projections and head; 4-5 on layer 1's
    # stacks at its own routing: a decode step's 4 slots, the prompt's
    # prefill bucket (padding rows routed too, as the main path routes them)
    measurements = projection_checks([
        ("qmatmul_q8", "qkv", at0["wqkv"]),
        ("qmatmul_q4", "o_proj", at0["wo"]),
        ("qmatmul_q8", "lm_head", params["output"]),
    ], ROWS, timer, peaks, OSS_LABEL, act=cfg.hidden_act.value)
    seen = []
    route = T.route

    def record(ffn, cfg_, xf):
        topv, topi = route(ffn, cfg_, xf)
        if ffn is ffn1:
            seen.append((xf, topi))
        return topv, topi

    T.route = record
    try:  # eager (a cache the runner did not make), so route sees it
        quant.runner.prefill(ids, quant.runner._make_kv(1))
    finally:
        T.route = route
    xf, topi = seen[0]
    k = cfg.num_experts_per_token
    idx = topi.reshape(-1).to(torch.int32)
    xr = xf.float().repeat_interleave(k, dim=0)
    last = k * (len(ids) - 1)
    paths: dict[str, set] = {}
    for key, n in by_path.items():
        name, _, kpath = key.partition(" ")
        if n and name in MOE_PATHS:
            paths.setdefault(name, set()).add(kpath)
    measurements += moe_kernel_checks(ex, {
        f"decode, {k} experts": (idx[last:last + k], xr[last:last + k]),
        f"prefill bucket of {len(xf)} tokens": (idx, xr)}, timer, peaks,
        OSS_LABEL, paths, act_fn=cfg.hidden_act.value)
    sources = {"tc": "csrc/qgemm.cu", "splitk": "csrc/qgemm.cu",
               "cuda cores": "csrc/moe_qmatmul.cu"}
    print(json.dumps({"oss_kernel_paths": {
        name: {p: sources.get(p, p) for p in sorted(ps)}
        for name, ps in paths.items()}, "card": card}), flush=True)

    # phase 9 on this path; the graphs' cost, a greedy profile against the
    # byte bound, bench
    graph_against_eager(OSS_LABEL, quant, ids, card)
    r = quant.runner
    graphs = {name: graph_cost(r, key) for name, key in (
        ("decode", (1, 1, 512, False)),
        (f"prefill {bucket}", (1, bucket, 512, True)))
        if key in r._graphs}
    profile = profile_decode(quant, ids, mode="greedy")
    device = profile["device_ms_per_step"]
    print(json.dumps({"oss_decode_profile": dict(
        profile, path=OSS_LABEL, byte_bound_ms=bound, step_bytes=nbytes,
        bound_share=(bound / device if isinstance(device, float)
                     else "not measured"),
        kernels_1_6_ms_per_step=(profile["kernels_1_2_ms_per_step"]
                                 + profile["kernel_3_ms_per_step"]
                                 + profile["kernels_4_6_ms_per_step"]),
        graphs=graphs, load_s=load_s, card=card)}), flush=True)
    bench_json(OSS_LABEL, quant, card)
    del deq
    torch.cuda.empty_cache()

    # the CLI's run on the GGUF: its own load, from the sidecar the cold
    # quant load wrote
    check(os.path.exists(gguf + ".repack"), f"{OSS_LABEL}: no sidecar")
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["run", gguf, "-p", PROMPT, "-n", "8",
                       "--temperature", "0", "--no-stream"])
    cli_s = time.perf_counter() - t0
    decoded = re.search(r"decode (\d+) tok @", err.getvalue())
    check(rc == 0 and decoded is not None and int(decoded.group(1)) > 0,
          f"{OSS_LABEL}: the CLI's run gave {rc}, {out.getvalue()!r}, "
          f"{err.getvalue()[-300:]!r}")
    print(json.dumps({"oss_cli_run": dict(
        path=OSS_LABEL, seconds=cli_s, from_sidecar=True,
        stats=err.getvalue().strip()[-120:], card=card)}), flush=True)
    torch.cuda.empty_cache()
    batched_launches = hybrid_batched(quant, card, OSS_LABEL)
    log(f"phase 18b done in {time.perf_counter() - t_phase:.1f}s")
    return measurements, launches, batched_launches


# -- phase 19: speculative decoding, LoRA, LLAMA_DEBUG ----------------------

SPEC_TOKENS = 128  # 19a: tokens per mode
SPEC_DRAFT = 4  # 19a: num_draft of the draft model, self-draft and same model
LOOKUP_DRAFT, LOOKUP_NGRAM = 8, 3  # 19a (iv)
SPEC_TEMPERATURE = 0.8  # 19a (v)
LORA_RANK, LORA_ALPHA, LORA_STD = 16, 32.0, 0.01  # 19b: A and B ~ N(0, std)
LORA_TARGETS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                "ffn_up", "ffn_down")
DEBUG_TOKENS = 3  # 19c: greedy tokens traced


def spec_prompt(tokenizer) -> list[int]:
    """19a's prompt: SURVEY.md's first 130 tokens, then its tokens 1-100
    again (230 tokens; the repeated span gives prompt lookup its n-grams)."""
    ids = repo_text_ids(tokenizer, 130)
    return ids + ids[1:101]


@contextlib.contextmanager
def timed_rounds(dec):
    """Host seconds of a speculative decoder's draft and verification,
    each synchronized at its end (both end in a fetch from the device
    anyway): engine/speculative's _draft_greedy_on_device, its _window_dev
    on the draft's cache and the draft's decode_one (the sampled path)
    count as "draft", _window_dev on the target's cache as "verify" (all a
    prompt-lookup decoder's). Yields the dict of seconds; the wrappers go
    after."""
    import torch
    from llama_gguf_tpu_torch.engine import speculative as S

    times = {"draft": 0.0, "verify": 0.0}
    window, draft_fn = S._window_dev, S._draft_greedy_on_device
    target_kv = dec.target._kv[(dec.target.max_batch, None)]
    draft = getattr(dec, "draft", None)
    inner = [0]

    def timed_window(runner, tokens, start, kv):
        t0 = time.perf_counter()
        out = window(runner, tokens, start, kv)
        if not inner[0]:
            torch.cuda.synchronize()
            key = "verify" if kv is target_kv else "draft"
            times[key] += time.perf_counter() - t0
        return out

    def timed_draft(*a):
        t0 = time.perf_counter()
        inner[0] += 1
        try:
            return draft_fn(*a)
        finally:
            inner[0] -= 1
            times["draft"] += time.perf_counter() - t0

    S._window_dev, S._draft_greedy_on_device = timed_window, timed_draft
    if draft is not None:
        decode_one = draft.decode_one

        def timed_decode_one(*a, **kw):
            t0 = time.perf_counter()
            out = decode_one(*a, **kw)
            times["draft"] += time.perf_counter() - t0
            return out

        draft.decode_one = timed_decode_one
    try:
        yield times
    finally:
        S._window_dev, S._draft_greedy_on_device = window, draft_fn
        if draft is not None:
            del draft.decode_one


def replay_launches(runners, replays0) -> dict:
    """The kernel launches the graph replays of ``runners`` made since
    ``replays0`` (each runner's replays dict before)."""
    out: dict[str, int] = {}
    for r, before in zip(runners, replays0):
        for key, n in r.replays.items():
            n -= before.get(key, 0)
            if n and key in r._graphs:
                for name, per in r._graphs[key].launches[0].items():
                    out[name] = out.get(name, 0) + n * per
    return out


def spec_mode(label: str, dec, ids, plain, margins, sampler=None) -> dict:
    """One mode of 19a: a first run (it captures the mode's graph keys:
    printed with their seconds), then a timed run with the launch counters
    set to 0 that captures nothing and repeats the first's tokens. Gates:
    the greedy tokens equal plain greedy's up to the first near tie; no
    eager step; every launch of kernels 1-3 accounted to the replays of the
    target's and the draft's graphs."""
    import torch
    from llama_gguf_tpu_torch.engine import speculative as S
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    runners = [dec.target] + ([dec.draft] if getattr(dec, "draft", None)
                              not in (None, dec.target) else [])

    def go():
        dec.stats = S.SpeculativeStats()
        if sampler is None:
            return dec.generate_greedy(ids, SPEC_TOKENS)
        return dec.generate_sampled(ids, SPEC_TOKENS, sampler, seed=SEED)

    keys0 = [set(r._graphs) for r in runners]
    eager0 = [r.eager_steps for r in runners]
    first = go()
    captured = {f"{'draft ' if i else ''}{key}": sec
                for i, (r, k0) in enumerate(zip(runners, keys0))
                for key, sec in capture_times(r, k0).items()}
    caps = [r.captures for r in runners]
    replays0 = [dict(r.replays) for r in runners]
    sync()
    Q.reset_launches()
    t0 = time.perf_counter()
    with timed_rounds(dec) as times:
        toks = go()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(Q.LAUNCHES)
    check([r.captures for r in runners] == caps,
          f"19a {label}: the timed run captured a graph")
    check(toks == first, f"19a {label}: a second run's tokens differ")
    check([r.eager_steps for r in runners] == eager0,
          f"19a {label}: a step ran eagerly")
    accounted = replay_launches(runners, replays0)
    for name in PER_STEP:
        check(launches.get(name, 0) == accounted.get(name, 0) > 0,
              f"19a {label} {name}: {launches.get(name, 0)} launches, "
              f"{accounted.get(name, 0)} from the graphs' replays")
    st = dec.stats
    rounds = max(st.rounds, 1)
    out = dict(mode=label, tokens=len(toks), tok_s=len(toks) / wall,
               acceptance=st.acceptance_rate,
               tokens_per_round=st.tokens_per_round, rounds=st.rounds,
               drafted=st.drafted, accepted=st.accepted, bonus=st.bonus,
               ms_per_round=wall * 1e3 / rounds,
               draft_ms_per_round=times["draft"] * 1e3 / rounds,
               verify_ms_per_round=times["verify"] * 1e3 / rounds,
               host_ms_per_round=(wall - times["draft"] - times["verify"])
               * 1e3 / rounds,
               captured_keys=captured, capture_s=sum(captured.values()),
               launches=launches)
    if sampler is None:
        out.update(same_until_tie(f"19a {label}", toks, plain, margins))
    return out


def greedy_rate(runner, ids, steps: int) -> float:
    """Plain greedy_decode tok/s from the prompt: a first run captures, the
    second is timed on the host clock from the prefill's start to the
    tokens' fetch, as spec_mode times a mode (whose run holds the target's
    prefill, and the draft's)."""
    import torch

    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        logits, kv, pos = runner.prefill(ids, runner.init_kv())
        first = torch.argmax(logits)[None].to(torch.int32)
        # the prefill's token and steps - 1 more, as a mode's steps tokens
        toks, kv = runner.greedy_decode(first, [pos], kv, steps=steps - 1)
        toks.cpu()
        wall = time.perf_counter() - t0
    return steps / wall


def speculative_path(quant, gguf: str, draft_gguf: str, card: str) -> dict:
    """Phase 19a on TinyLlama-1.1B (phase 4's quant engine) with the
    tinyllama-1.1b-l2 draft. Returns the launches of the timed runs."""
    from llama_gguf_tpu_torch.cli import main as cli_main
    from llama_gguf_tpu_torch.engine import speculative as S
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    t_phase = time.perf_counter()
    target = quant.runner
    draft = Engine.load(draft_gguf, EngineConfig(weight_mode="quant"),
                        device="cuda")
    check(draft.runner.cfg.vocab_size == target.cfg.vocab_size,
          "19a: the draft's vocabulary differs")
    ids = spec_prompt(quant.tokenizer)
    plain, margins = single_stream(target, ids, SPEC_TOKENS)
    check(S.SpeculativeDecoder(target, target).generate_plain_greedy(
        ids, SPEC_TOKENS) == plain,
        "19a: generate_plain_greedy differs from the single-stream steps")
    plain_tps = greedy_rate(target, ids, SPEC_TOKENS)
    self_dec = S.SpeculativeDecoder.self_speculative(target,
                                                     num_draft=SPEC_DRAFT)
    check(self_dec.draft.cfg.num_layers == 5,
          f"19a: the self-draft exits at {self_dec.draft.cfg.num_layers}")
    sampled = SamplerConfig(temperature=SPEC_TEMPERATURE, top_k=0, top_p=1.0,
                            repetition_penalty=1.0)
    modes = [
        ("draft model", S.SpeculativeDecoder(target, draft.runner,
                                             num_draft=SPEC_DRAFT), None),
        ("self-draft exit 5", self_dec, None),
        ("same model", S.SpeculativeDecoder(target, target,
                                            num_draft=SPEC_DRAFT), None),
        ("prompt lookup", S.PromptLookupDecoder(
            target, num_draft=LOOKUP_DRAFT, max_ngram=LOOKUP_NGRAM), None),
        ("sampled, draft model", S.SpeculativeDecoder(
            target, draft.runner, num_draft=SPEC_DRAFT), sampled),
        ("sampled, same model", S.SpeculativeDecoder(
            target, target, num_draft=SPEC_DRAFT), sampled),
    ]
    rows, launches = [], {}
    for label, dec, smp in modes:
        rows.append(spec_mode(label, dec, ids, plain, margins, smp))
        launches = added(launches, rows[-1].pop("launches"))
    for row in rows:
        if row["mode"] in ("same model", "sampled, same model"):
            check(row["acceptance"] == 1.0,
                  f"19a {row['mode']}: acceptance {row['acceptance']}")
    check(target.eager_steps == 0 and draft.runner.eager_steps == 0
          and self_dec.draft.eager_steps == 0, "19a: eager steps")
    cli_runs = {}
    for flags in (["--draft", draft_gguf], ["--self-speculative", "5"],
                  ["--prompt-lookup", str(LOOKUP_DRAFT)]):
        t0 = time.perf_counter()
        rc = cli_main(["run", gguf, "-p", PROMPT, "-n", "16", "-t", "0"]
                      + flags)
        check(rc == 0, f"19a: the CLI's run {flags[0]} exited {rc}")
        cli_runs[flags[0]] = time.perf_counter() - t0
    print(json.dumps({"phase_19a": dict(
        path="TinyLlama-1.1B", draft="tinyllama-1.1b-l2",
        prompt_tokens=len(ids), plain_greedy_decode_tok_s=plain_tps,
        modes=rows, cli_run_s=cli_runs,
        phase_s=time.perf_counter() - t_phase, card=card)}), flush=True)
    del draft, self_dec, modes
    return launches


def write_adapter(layer: dict, num_layers: int, zero_b: bool) -> str:
    """19b's adapter GGUF in llama.cpp's layout (lora_a [r, K], lora_b
    [N, r], F32; A and B ~ N(0, LORA_STD) from SEED, B zeros for the
    zero-B twin) on LORA_TARGETS of every layer, at the widths of the
    loaded ``layer`` (its fused q|k|v and gate|up cut at their splits);
    built once into .cache/."""
    import numpy as np
    from llama_gguf_tpu_torch.gguf.writer import GGUFWriter

    path = os.path.join(ROOT, ".cache", "chip_smoke",
                        f"tinyllama-1.1b-lora-r{LORA_RANK}"
                        f"{'-zero' if zero_b else ''}-s{SEED}.gguf")
    if os.path.exists(path):
        return path
    attn, ffn = layer["attn"], layer["ffn"]
    k = attn["wqkv"].k
    nq, nk, nv = attn["wqkv"].splits
    f = ffn["gate_up"].splits[0]
    shapes = dict(attn_q=(k, nq), attn_k=(k, nk), attn_v=(k, nv),
                  attn_output=attn["wo"].shape, ffn_gate=(k, f),
                  ffn_up=(k, f), ffn_down=ffn["down"].shape)
    rng = np.random.default_rng(SEED)
    w = GGUFWriter()
    w.add_metadata("general.type", "adapter")
    w.add_metadata("adapter.type", "lora")
    w.add_metadata("adapter.lora.alpha", LORA_ALPHA)
    for i in range(num_layers):
        for t in LORA_TARGETS:
            kk, nn = shapes[t]
            a = rng.standard_normal((LORA_RANK, kk), np.float32) * LORA_STD
            b = (np.zeros((nn, LORA_RANK), np.float32) if zero_b else
                 rng.standard_normal((nn, LORA_RANK), np.float32) * LORA_STD)
            w.add_tensor_np(f"blk.{i}.{t}.weight.lora_a", a)
            w.add_tensor_np(f"blk.{i}.{t}.weight.lora_b", b)
    tmp = path + f".{os.getpid()}.tmp"
    w.write_to_path(tmp)
    os.replace(tmp, path)
    return path


def lora_path(quant, deq, gguf: str, card: str, timer,
              peaks: dict) -> tuple[list[dict], dict]:
    """Phase 19b on phase 4's TinyLlama-1.1B engines (quant and dequant;
    their params are rewritten in place, so this is their last use).
    Returns (the kernel checks at the adapted params' projections, the
    launches of the counted run)."""
    import socket
    import threading

    import torch
    from llama_gguf_tpu_torch.cli import bench, build_parser, serve_config
    from llama_gguf_tpu_torch.cli import main as cli_main
    from llama_gguf_tpu_torch.client import RemoteChatClient
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.models.lora import (LoraAdapter, apply_lora,
                                                  remove_lora)
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops.linear import LoraLinear
    from llama_gguf_tpu_torch.server.app import ServerState, run_server

    t_phase = time.perf_counter()
    r, dr = quant.runner, deq.runner
    layers = r.cfg.num_layers
    t0 = time.perf_counter()
    path = write_adapter(r.params["layers"][0], layers, zero_b=False)
    zero_path = write_adapter(r.params["layers"][0], layers, zero_b=True)
    build_s = time.perf_counter() - t0
    ad = LoraAdapter.load_gguf(path)
    check((ad.rank, ad.scale) == (LORA_RANK, LORA_ALPHA / LORA_RANK),
          f"19b: rank {ad.rank}, scale {ad.scale}")
    ids = quant.tokenizer.encode(PROMPT)
    base_toks, base_margins = single_stream(r, ids, NEW_TOKENS)
    base_profile = profile_decode(quant, ids, mode="greedy")
    base_bench = bench(quant)

    n = apply_lora(r.params, ad, runner=r)
    check(n == apply_lora(dr.params, ad, runner=dr)
          == len(LORA_TARGETS) * layers, f"19b: {n} tensors attached")
    check(all("wqkv" not in l["attn"] and "gate_up" not in l["ffn"]
              for l in r.params["layers"]), "19b: a fused projection left")
    # the split's projections (q, k, v, gate and up alone) and the rest,
    # each distinct shape on its kernel against its plain version, at a
    # greedy step's row, the 8-row verification bucket and the prefills
    measurements = projection_checks(distinct_projections(r.params), ROWS,
                                     timer, peaks, "TinyLlama-1.1B LoRA")
    # quant against dequant, both with the adapter
    dq_toks, dq_margins = single_stream(dr, ids, NEW_TOKENS)
    _, dq_rows = step_logits(dr, ids, NEW_TOKENS, tokens=dq_toks)
    _, q_rows = step_logits(r, ids, NEW_TOKENS, tokens=dq_toks)
    quant_rel = max(rel_diff(a.cpu(), b.cpu())
                    for a, b in zip(q_rows, dq_rows))
    check(quant_rel <= QUANT_REL,
          f"19b: quant logits differ from dequant by {quant_rel:.3g}")
    q_toks, _ = single_stream(r, ids, NEW_TOKENS)
    vs_dequant = same_until_tie("19b quant vs dequant", q_toks, dq_toks,
                                dq_margins)
    # graphed against eager
    e_toks, e_rows = step_logits(r, ids, NEW_TOKENS, eager=True)
    g_toks, g_rows = step_logits(r, ids, NEW_TOKENS)
    graph_rel = max(rel_diff(a.cpu(), b.cpu()) for a, b in zip(g_rows, e_rows))
    check(g_toks == e_toks and graph_rel <= GRAPH_REL,
          f"19b: graphed against eager: {graph_rel:.3g}")
    # launches derived from the adapted params: a prefill and the steps
    sync()
    Q.reset_launches()
    eager0 = r.eager_steps
    step_logits(r, ids, NEW_TOKENS)
    sync()
    launches = dict(Q.LAUNCHES)
    check(r.eager_steps == eager0, "19b: a counted step ran eagerly")
    exact_launches("19b", launches, NEW_TOKENS - 1,
                   hybrid_launches_per_step(r.params, r.cfg))
    check(not launches.get("qmatmul_glu"), "19b: the GLU kernel launched "
                                           "in an adapted layer")
    checked = {m["name"] for m in measurements}
    for name, n_launched in launches.items():
        check(not n_launched or name in checked,
              f"19b: {name} launched at shapes no check held")
    lora_profile = profile_decode(quant, ids, mode="greedy")
    lora_bench = bench(quant)
    # the zero-B twin: the base's tokens
    remove_lora(r.params, runner=r)
    apply_lora(r.params, LoraAdapter.load_gguf(zero_path), runner=r)
    z_toks, _ = single_stream(r, ids, NEW_TOKENS)
    zero = same_until_tie("19b zero-B", z_toks, base_toks, base_margins)
    # remove_lora: the graphs go, and the replayed logits are the unfused
    # base's, equal to a fresh runner's over the same params bit for bit
    remove_lora(r.params, runner=r)
    check(not r._graphs, "19b: graphs kept after remove_lora")
    caps = r.captures
    u_toks, u_rows = step_logits(r, ids, NEW_TOKENS)
    check(r.captures > caps, "19b: nothing captured after the reset")
    fresh = ModelRunner(r.params, r.cfg, max_batch=1, max_seq=r.max_seq,
                        matmul_precision=r.matmul_precision,
                        kv_format=r.kv_format, device=r.device)
    _, f_rows = step_logits(fresh, ids, NEW_TOKENS, tokens=u_toks)
    check(all(torch.equal(a, b) for a, b in zip(u_rows, f_rows)),
          "19b: the reset runner's logits differ from a fresh runner's")
    adapter_effect = rel_diff(q_rows[0].cpu(), u_rows[0].cpu())
    check(adapter_effect > QUANT_REL,
          f"19b: the adapter moved the logits by {adapter_effect:.3g} only")
    del fresh
    torch.cuda.empty_cache()

    # serve with the adapter
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    config = serve_config(build_parser().parse_args([
        "serve", gguf, "--port", str(port), "--max-batch", "2", "--lora",
        path]))
    state = ServerState(config)
    engine, batched = state.current()
    check(isinstance(engine.runner.params["layers"][0]["attn"]["wq"],
                     LoraLinear), "19b: the server loaded no adapter")
    seen = []
    submit = batched.submit

    def record(*a, **kw):
        seen.append(submit(*a, **kw))
        return seen[-1]

    batched.submit = record
    server = threading.Thread(target=run_server, args=(config, state),
                              daemon=True, name="server-19b")
    server.start()
    client = RemoteChatClient(f"http://127.0.0.1:{port}", timeout=600)
    for _ in range(100):
        try:
            check(client.health()["status"] == "ok", "19b: not healthy")
            break
        except OSError:
            time.sleep(0.1)
    messages = [{"role": "user", "content": PROMPT}]
    client.chat(messages, max_tokens=16, temperature=0.0,
                repetition_penalty=1.0)
    margins: list = []
    sampler, picks = recording_sampler(margins)
    engine.generate(engine.chat_template.render(messages), max_tokens=16,
                    sampler=sampler)
    served = same_until_tie("19b served", seen[0].token_ids, picks, margins)
    check(len(seen[0].token_ids) > 0, "19b: the server generated nothing")
    state.shutdown()
    server.join(timeout=30)
    check(not server.is_alive(), "19b: run_server did not return")
    del state, engine, batched
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = cli_main(["run", gguf, "--lora", path, "-p", PROMPT, "-n", "8",
                   "-t", "0"])
    check(rc == 0, f"19b: the CLI's run --lora exited {rc}")
    print(json.dumps({"phase_19b": dict(
        path="TinyLlama-1.1B", rank=LORA_RANK, alpha=LORA_ALPHA,
        tensors=n, adapter_bytes=os.path.getsize(path), build_s=build_s,
        kernel_checks=len(measurements),
        quant_vs_dequant_rel=quant_rel, quant_vs_dequant=vs_dequant,
        graph_vs_eager_rel=graph_rel, zero_b=zero, served=served,
        adapter_effect_rel=adapter_effect, launches=launches,
        kernels_per_step_base=base_profile["kernels_launched_per_step"],
        kernels_per_step_lora=lora_profile["kernels_launched_per_step"],
        device_ms_per_step_base=base_profile["device_ms_per_step"],
        device_ms_per_step_lora=lora_profile["device_ms_per_step"],
        greedy_profile_base=base_profile, greedy_profile_lora=lora_profile,
        bench_base=base_bench, bench_lora=lora_bench,
        cli_run_s=time.perf_counter() - t0,
        phase_s=time.perf_counter() - t_phase, card=card)}), flush=True)
    return measurements, launches


def debug_path(draft_gguf: str, card: str) -> None:
    """Phase 19c on tinyllama-1.1b-l2: greedy tokens with LLAMA_DEBUG on
    (every step eager, an embed line and one out line per layer a step on
    stdout), then off again (graphs replay), and bench --profile's trace
    through utils/debug.profile."""
    import io
    import tempfile

    from llama_gguf_tpu_torch.cli import bench
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.utils import debug

    t_phase = time.perf_counter()
    engine = Engine.load(draft_gguf, EngineConfig(weight_mode="quant"),
                         device="cuda")
    r = engine.runner
    ids = engine.tokenizer.encode(PROMPT)
    engine.greedy_tokens(ids, DEBUG_TOKENS)  # the graphs, switch off
    eager0, replays0 = r.eager_steps, sum(r.replays.values())
    buf = io.StringIO()
    debug.set_debug_activations(True)
    try:
        with contextlib.redirect_stdout(buf):
            traced = engine.greedy_tokens(ids, DEBUG_TOKENS)
    finally:
        debug.set_debug_activations(False)
    lines = [l for l in buf.getvalue().splitlines()
             if l.startswith("[LLAMA_DEBUG]")]
    steps = r.eager_steps - eager0
    pattern = ["layer  -1 embed"] + [f"layer {i:>3} out"
                                     for i in range(r.cfg.num_layers)]
    check(sum(r.replays.values()) == replays0 and steps > DEBUG_TOKENS - 1,
          f"19c: {steps} eager steps, replays moved")
    check([l.split(": rms=")[0][len("[LLAMA_DEBUG] "):] for l in lines]
          == pattern * steps, f"19c: {len(lines)} lines for {steps} steps")
    engine.greedy_tokens(ids, DEBUG_TOKENS)
    check(r.eager_steps == eager0 + steps
          and sum(r.replays.values()) > replays0,
          "19c: the switch off did not replay the graphs")
    debug.set_debug_activations(None)
    with tempfile.TemporaryDirectory() as d:
        result = bench(engine, profile_dir=d)
        trace = os.path.join(d, "trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        check(kernels > 0, "19c: the profile trace holds no kernel")
        trace_bytes = os.path.getsize(trace)
    print(json.dumps({"phase_19c": dict(
        path=LOAD_PRESET, steps=steps, lines=len(lines),
        first_lines=lines[:3], tokens=traced, bench=result,
        trace_bytes=trace_bytes, trace_kernels=kernels,
        phase_s=time.perf_counter() - t_phase, card=card)}), flush=True)


PARALLEL_TOKENS = 24  # 20a, 20b: greedy tokens from the prompt
# 20c: prompt tokens; the long one passes bucket 512, so that a tier over
# the B = 4 rows, grouped in two data shards, reads less than one bound
PARALLEL_REQUESTS = (20, 600, 40, 10)
PARALLEL_NEW = 16  # 20c, 20d: tokens per request
# launches a step of tinyllama-1.1b-l2 makes (2 layers: q|k|v and o_proj,
# the GLU, down; the LM head)
PER_STEP_L2 = {"qmatmul_q4": 4, "qmatmul_glu": 2, "qmatmul_q8": 3}


def rank_lines(label: str, stats: list[dict]) -> list[dict]:
    """Each rank's placement, backend, wall ms per step and collectives'
    wall ms per step (host clock), logged and returned."""
    out = []
    for st in stats:
        steps = max(st["steps"], 1)
        coll = {a: dict(calls=c["calls"], ms_per_step=1e3 * c["seconds"]
                        / steps)
                for a, c in st["collectives"].items()}
        out.append(dict(rank=st["rank"], device=st["device"],
                        backend=st["backend"], data_index=st["data_index"],
                        model_index=st["model_index"], steps=st["steps"],
                        eager_steps=st["eager_steps"],
                        wall_ms_per_step=1e3 * st["step_seconds"] / steps,
                        collectives=coll, launches={
                            k: v for k, v in st["launches"].items() if v}))
        log(f"{label} rank {st['rank']} on {st['device']} over "
            f"{st['backend']}: {out[-1]['wall_ms_per_step']:.2f} wall ms a "
            f"step over {st['steps']} steps, collectives "
            + ", ".join(f"{a} {c['ms_per_step']:.2f} ms ({c['calls']} calls)"
                        for a, c in coll.items()))
    return out


def mesh_tokens(label: str, runner, one_runner, ids, steps: int,
                watch=contextlib.nullcontext) -> dict:
    """Single-stream greedy tokens of the mesh's ``runner`` against one
    rank's (``one_runner``), equal up to the first near tie, and the
    prefill logits within 1e-3 of max |logit|. The mesh's run, between
    its ranks' counters set to 0 and read, runs inside ``watch()``."""
    import numpy as np

    want, margins = single_stream(one_runner, ids, steps)
    lw = one_runner.prefill(ids, one_runner.init_kv(1), host=True)[0]
    runner.reset_rank_stats()
    with watch():
        got, _ = single_stream(runner, ids, steps)
    stats = runner.rank_stats()
    lg = runner.prefill(ids, runner.init_kv(1), host=True)[0]
    err = float(np.abs(lg - lw).max() / np.abs(lw).max())
    check(err <= 1e-3, f"{label}: prefill logits differ by {err:.3g} of "
                       "max |logit|")
    tie = same_until_tie(label, got, want, margins)
    log(f"{label}: {tie}, prefill logits rel err {err:.2e}")
    return dict(stats=stats, prefill_rel_err=err, **tie)


def parallel_dense(card: str, timer, peaks: dict, gguf: str):
    """20a: TinyLlama-1.1B at tp=2. Returns (measurements, launches)."""
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig

    label = "TinyLlama-1.1B tp=2 (20a)"
    one = Engine.load(gguf, EngineConfig(), device="cuda")
    t0 = time.perf_counter()
    eng = Engine.load(gguf, EngineConfig(mesh_model=2), device="cuda")
    load_s = time.perf_counter() - t0
    try:
        r = eng.runner
        check(r.mesh.backend == "gloo" and not r.graphs_ok,
              f"{label}: backend {r.mesh.backend}")
        params = r.params
        layer = params["layers"][0]
        shapes = (layer["attn"]["wqkv"].splits, layer["attn"]["wo"].base.k,
                  layer["ffn"]["gate_up"].splits, layer["ffn"]["down"].base.k,
                  params["output"].base.n)
        check(shapes == ((1024, 128, 128), 1024, (2816, 2816), 2816, 16000),
              f"{label}: rank 0's shard shapes {shapes}")
        measurements = projection_checks([
            ("qmatmul_q4", "qkv rank 0 of 2", layer["attn"]["wqkv"]),
            ("qmatmul_q4", "o_proj rows, rank 0 of 2",
             layer["attn"]["wo"].base),
            ("qmatmul_glu", "gate|up rank 0 of 2", layer["ffn"]["gate_up"]),
            ("qmatmul_q8", "ffn_down rows, rank 0 of 2",
             layer["ffn"]["down"].base),
            ("qmatmul_q8", "lm_head vocab, rank 0 of 2",
             params["output"].base),
        ], MOE_ROWS, timer, peaks, label)
        ids = eng.tokenizer.encode(PROMPT)
        res = mesh_tokens(label, r, one.runner, ids, PARALLEL_TOKENS)
        for st in res["stats"]:
            for name, per in PER_STEP.items():
                check(st["launches"][name] == per * PARALLEL_TOKENS,
                      f"{label} rank {st['rank']} {name}: "
                      f"{st['launches'][name]} launches, expected {per} x "
                      f"{PARALLEL_TOKENS}")
        ranks = rank_lines(label, res.pop("stats"))
    finally:
        eng.close()
    del one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "llama_gguf_tpu_torch", "run", gguf, "--tp",
         "2", "-p", PROMPT, "-n", "8", "-t", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"run --tp 2 exited {run.returncode}: "
                               f"{run.stderr[-2000:]}")
    print(json.dumps({"phase_20a": dict(
        load_s=load_s, cli_run_s=time.perf_counter() - t0, ranks=ranks,
        card=card, **res)}), flush=True)
    return measurements, summed_launches(ranks)


def summed_launches(ranks: list[dict]) -> dict:
    """The ranks' launch counts added up."""
    out: dict[str, int] = {}
    for rk in ranks:
        for k, v in rk["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def ep_launches(routes, rank: int, e_local: int) -> dict:
    """The MoE kernels' launches of expert-parallel ``rank`` (experts
    [rank * e_local, (rank + 1) * e_local)) over ``routes``, each MoE
    layer call's expert ids: none where no slot is local; else, by
    ops/qmatmul.moe_dims on the local slots, the grouped GLU and the
    grouped kernel, or kernel 4 for gate, up and down."""
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    want = {"moe_slot": 0, "moe_grouped": 0, "moe_glu_grouped": 0}
    for idx in routes:
        n = int(((idx >= rank * e_local)
                 & (idx < (rank + 1) * e_local)).sum())
        if n and Q.moe_dims(n, e_local)[2]:
            want["moe_glu_grouped"] += 1
            want["moe_grouped"] += 1
        elif n:
            want["moe_slot"] += 3
    return want


def parallel_moe(card: str, timer, peaks: dict, gguf: str):
    """20b: mixtral-8x7b-l2 at tp=2, expert parallel. Returns
    (measurements, launches)."""
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.models import transformer as T

    label = f"{MOE_LABEL} tp=2 (20b)"
    one = Engine.load(gguf, EngineConfig(), device="cuda")
    t0 = time.perf_counter()
    eng = Engine.load(gguf, EngineConfig(mesh_model=2), device="cuda")
    load_s = time.perf_counter() - t0
    try:
        r = eng.runner
        layer = r.params["layers"][0]
        ffn = layer["ffn"]
        ex = ffn["experts"]
        check(ffn["expert_range"] == (0, 4) and ex["gate"].packed.shape[0]
              == 4, f"{label}: rank 0 keeps experts {ffn['expert_range']}")
        check(not r.graphs_ok, f"{label}: expert-parallel steps must run "
                               "eagerly")
        measurements = projection_checks([
            ("qmatmul_q4", "qkv rank 0 of 2", layer["attn"]["wqkv"]),
            ("qmatmul_q4", "o_proj rows, rank 0 of 2",
             layer["attn"]["wo"].base),
            ("qmatmul_q8", "lm_head vocab, rank 0 of 2",
             r.params["output"].base),
        ], MOE_ROWS, timer, peaks, label)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        xr = torch.randn(256, MOE_SHAPE["hidden_size"], device="cuda",
                         generator=gen)
        idx = torch.randint(0, 4, (256,), device="cuda", generator=gen,
                            dtype=torch.int32)
        measurements += moe_kernel_checks(ex, {
            "decode, rank 0's 2 slots": (idx[:2].contiguous(), xr[:2]),
            "prefill, rank 0's 256 slots": (idx, xr),
        }, timer, peaks, label)
        ids = eng.tokenizer.encode(PROMPT)
        # rank 0's routing of the mesh's run (the router and its input are
        # the same on every rank): each rank's MoE launches follow from it
        routes = []
        route = T.route

        @contextlib.contextmanager
        def watch():
            def record(ffn_, cfg_, xf):
                topv, topi = route(ffn_, cfg_, xf)
                routes.append(topi.reshape(-1).cpu())
                return topv, topi

            T.route = record
            try:
                yield
            finally:
                T.route = route

        res = mesh_tokens(label, r, one.runner, ids, PARALLEL_TOKENS, watch)
        n_layers = MOE_SHAPE["num_layers"]
        check(len(routes) == n_layers * PARALLEL_TOKENS,
              f"{label}: {len(routes)} routings recorded")
        for st in res["stats"]:
            got = st["launches"]
            want = dict(ep_launches(routes, st["model_index"], 4),
                        qmatmul_q4=2 * n_layers * PARALLEL_TOKENS,
                        qmatmul_q8=PARALLEL_TOKENS)
            check({k: got[k] for k in want} == want,
                  f"{label} rank {st['rank']}: launches {got}, expected "
                  f"{want}")
        ranks = rank_lines(label, res.pop("stats"))
    finally:
        eng.close()
    del one
    torch.cuda.empty_cache()
    print(json.dumps({"phase_20b": dict(load_s=load_s, ranks=ranks,
                                        card=card, **res)}), flush=True)
    return measurements, summed_launches(ranks)


def parallel_dp_tp(card: str, gguf: str) -> dict:
    """20c: a ragged B = 4 batch through BatchedEngine over dp=2 x tp=2 on
    tinyllama-1.1b-l2. Returns the launches."""
    import numpy as np
    import torch
    from llama_gguf_tpu_torch.engine.batched import BatchedEngine
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    label = "tinyllama-1.1b-l2 dp=2 x tp=2 (20c)"
    greedy = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    rng = np.random.default_rng(SEED)
    one = Engine.load(gguf, EngineConfig(), device="cuda")
    prompts = [rng.integers(3, one.runner.cfg.vocab_size, n).tolist()
               for n in PARALLEL_REQUESTS]
    singles = [single_stream(one.runner, p, PARALLEL_NEW) for p in prompts]
    t0 = time.perf_counter()
    eng = Engine.load(gguf, EngineConfig(max_batch=4, mesh_data=2,
                                         mesh_model=2), device="cuda")
    load_s = time.perf_counter() - t0
    r = eng.runner
    bounds = []
    step = r.step

    def recording(*a, **kw):
        bounds.append(kw.get("read_bound"))
        return step(*a, **kw)

    r.step = recording
    be = BatchedEngine(r, eng.tokenizer, max_queue=8)
    try:
        check(r.tier_shards == 2, f"{label}: tier shards {r.tier_shards}")
        r.reset_rank_stats()
        bounds.clear()
        handles = [be.submit(p, max_tokens=PARALLEL_NEW, sampler=greedy)
                   for p in prompts]
        for h in handles:
            h.text(timeout=600)
        stats = r.rank_stats()
        ties = [same_until_tie(f"{label} request {i}", h.token_ids, want,
                               margins)
                for i, (h, (want, margins)) in enumerate(zip(handles,
                                                             singles))]
        tiers = [b for b in bounds if isinstance(b, tuple)]
        check(bool(tiers), f"{label}: no step took a tier ({bounds})")
        for st in stats:
            for name, per in PER_STEP_L2.items():
                check(st["launches"][name] == per * len(bounds),
                      f"{label} rank {st['rank']} {name}: "
                      f"{st['launches'][name]} launches, expected {per} x "
                      f"{len(bounds)} steps")
        ranks = rank_lines(label, stats)
    finally:
        be.shutdown()
        eng.close()
    del one
    torch.cuda.empty_cache()
    print(json.dumps({"phase_20c": dict(
        load_s=load_s, steps=len(bounds), tiers=sorted(set(tiers)),
        requests=ties, ranks=ranks, card=card)}), flush=True)
    return summed_launches(ranks)


def parallel_cluster(card: str, gguf: str, l2: str) -> dict:
    """20d: the CLI's shard (two processes) and cluster, the health probe,
    a world-size-1 NCCL group. Returns its results."""
    import io
    import tempfile

    import torch
    import torch.distributed as dist
    from llama_gguf_tpu_torch import cli
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.parallel.multihost import (HealthMonitor,
                                                         HealthState)

    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(["cluster", "--model-bytes",
                        str(os.path.getsize(gguf))]) == 0, "cluster failed")
    topo = json.loads(buf.getvalue())
    check(topo["platform"] == "gpu" and topo["local_devices"] ==
          torch.cuda.device_count() and topo["auto_mesh"] == {
              "data": torch.cuda.device_count(), "model": 1},
          f"cluster: {topo}")
    out["cluster"] = topo
    state = HealthMonitor().check_once()
    check(state is HealthState.HEALTHY, f"health probe: {state}")
    out["health"] = state.value

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    store = "file://" + os.path.join(tmp, "store")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "llama_gguf_tpu_torch", "shard", l2,
         "--coordinator", store, "--num-processes", "2", "--process-id",
         str(pid), "--tp", "2", "--prompt", PROMPT, "-n",
         str(PARALLEL_NEW)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    texts = []
    for p in procs:
        try:
            texts.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            check(False, "shard: timed out")
    for pid, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0 and "served 1 request(s)" in text,
              f"shard {pid} exited {p.returncode}: {text[-2000:]}")
    out["shard_s"] = time.perf_counter() - t0

    # a world-size-1 NCCL group: Engine.load inside it loads this rank's
    # (whole) shard onto a MeshRunner whose steps capture the collectives
    one = Engine.load(l2, EngineConfig(), device="cuda")
    ids = one.tokenizer.encode(PROMPT)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "nccl"), world_size=1, rank=0)
    try:
        eng = Engine.load(l2, EngineConfig(), device="cuda")
        r = eng.runner
        check(r.mesh is not None and r.mesh.backend == "nccl" and
              r.graphs_ok, "NCCL world 1: not a graphed mesh runner")
        res = mesh_tokens("NCCL world size 1 (20d)", r, one.runner, ids,
                          PARALLEL_NEW)
        st = res.pop("stats")[0]
        check(r.captures > 0 and st["eager_steps"] == 0,
              f"NCCL world 1: {r.captures} captures, {st['eager_steps']} "
              "eager steps")
        toks, graphed = step_logits(r, ids, 8)
        _, eager = step_logits(r, ids, 8, tokens=toks, eager=True)
        err = max(float((g - e).abs().max() / e.abs().max())
                  for g, e in zip(graphed, eager))
        check(err <= REL_LIMIT, f"NCCL world 1: graphed steps differ from "
                                f"eager by {err:.3g}")
        out["nccl"] = dict(captures=r.captures,
                           replays=sum(r.replays.values()),
                           graphed_vs_eager_rel=err,
                           collective_calls=st["collectives"], **res)
        log(f"NCCL world size 1: {out['nccl']}")
    finally:
        dist.destroy_process_group()
    del one
    torch.cuda.empty_cache()
    print(json.dumps({"phase_20d": dict(card=card, **out)}), flush=True)
    return out


def parallel_path(card: str, timer, peaks: dict, tinyllama: str,
                  moe_gguf: str, l2: str):
    """Phase 20. Returns (measurements, {path label: launches})."""
    t20 = time.perf_counter()
    secs = {}
    t0 = time.perf_counter()
    dense, dense_l = parallel_dense(card, timer, peaks, tinyllama)
    secs["20a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe, moe_l = parallel_moe(card, timer, peaks, moe_gguf)
    secs["20b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp_l = parallel_dp_tp(card, l2)
    secs["20c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parallel_cluster(card, tinyllama, l2)
    secs["20d"] = time.perf_counter() - t0
    print(json.dumps({"phase_20": dict(
        seconds=time.perf_counter() - t20, parts_s=secs,
        script_s=time.perf_counter() - T_START, card=card)}), flush=True)
    log(f"phase 20 done in {time.perf_counter() - t20:.1f}s")
    return dense + moe, {"TinyLlama-1.1B tp=2 (20a)": dense_l,
                         f"{MOE_LABEL} tp=2 (20b)": moe_l,
                         "tinyllama-1.1b-l2 dp=2 x tp=2 (20c)": dp_l}


# Phase 21: RAG (rag/) through the CLI's `rag` on bge-base-en-v1.5 (21a),
# the server's /v1/rag/* beside TinyLlama-1.1B (21b), and the Hub client's
# cached `download` (21c)
RAG_QUERY = "how does the quantized matmul kernel read its scales"
RAG_SAMPLES = 32  # 21a: stored embeddings held against Engine.embed
RAG_RECALL_QUERIES = 64  # 21a: HNSW against brute force, recall@5
RAG_MODE_QUERIES = 16  # 21a: queries timed per search mode
RAG_SERVER_K = 2  # 21b: k of /search and /query (SURVEY.md's chunks are up
# to ~600 characters, one TinyLlama token each: the prompt stays in 2,048)
RAG_TOKENS = 32  # 21b: max_tokens of /v1/rag/query
RAG_MODES = ("semantic", "keyword", "hybrid")
RAG_EMBED_REL = 1e-5  # 21a: a stored vector against Engine.embed of its text


def rag_corpus() -> list[str]:
    """21a's corpus, files that never change: the JAX package's sources (its
    .py files, no byte code), VERDICT.md and docs/*.md. SURVEY.md is 21b's:
    19 of its markdown chunks (headers prefixed) spell more than bge's 512
    positions under the synthetic WordPiece vocabulary (each punctuation
    mark a token), and both packages' BERT then raise."""
    files = []
    for top, dirs, names in os.walk(os.path.join(ROOT, "llama_gguf_tpu")):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        files += [os.path.join(top, n) for n in sorted(names)
                  if n.endswith(".py")]
    docs = os.path.join(ROOT, "docs")
    files.append(os.path.join(ROOT, "VERDICT.md"))
    files += [os.path.join(docs, n) for n in sorted(os.listdir(docs))
              if n.endswith(".md")]
    return files


def cli_out(argv: list[str]) -> tuple[str, float]:
    """The port's CLI run in this process (so its launches count here): its
    standard output and seconds; a non-zero exit fails the phase."""
    import io

    from llama_gguf_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv[:2])}: exit {rc}: {buf.getvalue()}")
    return buf.getvalue(), seconds


def post(base: str, path: str, body: dict) -> tuple[int, dict]:
    """(status, JSON body) of one POST (the card's machine has no
    requests)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def rag_cli_path(card: str, gguf: str, tmp: str) -> dict:
    """21a: `rag ingest` of the corpus with bge-base-en-v1.5 on the card, then
    `rag search` in each mode and `rag ask`, each through cli.main; then the
    knowledge base's file read back in this process. Returns its launches."""
    import sqlite3

    import numpy as np
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.engine.runner import bucket_len
    from llama_gguf_tpu_torch.models.bert import bert_forward
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.rag import (EngineEmbedder, HNSWIndex,
                                          KnowledgeBase, SqliteVectorStore,
                                          chunk_text, get_chunker)
    from llama_gguf_tpu_torch.rag.knowledge_base import ContentKind
    from llama_gguf_tpu_torch.utils.timing import Timer, median

    t_part = time.perf_counter()
    files = rag_corpus()
    want = {}
    for f in files:
        md = ContentKind.from_path(f) == ContentKind.MARKDOWN
        with open(f, errors="replace") as fh:
            want[f] = len(chunk_text(fh.read(), get_chunker(
                "markdown" if md else "recursive", 512, 64)))
    total = sum(want.values())
    # the embedder's model as the CLI loads it (EngineEmbedder:
    # EngineConfig()), and the dequant oracle
    mem0 = torch.cuda.memory_allocated()
    fresh = Engine.load(gguf, EngineConfig(), device="cuda")
    embedder_bytes = torch.cuda.memory_allocated() - mem0
    deq = Engine.load(gguf, EngineConfig(weight_mode="dequant"),
                      device="cuda")
    per = encoder_launches(fresh.encoder.params, t5=False)["encode"]
    db = os.path.join(tmp, "kb.db")
    model = ["--db", db, "--model", gguf]

    launches: dict[str, int] = {}
    Q.reset_launches()
    out, ingest_s = cli_out(["rag", "ingest"] + model + files)
    got = dict(Q.LAUNCHES)
    exact_kernels("21a rag ingest", got, scaled(per, total))
    launches = added(launches, got)
    check(out.splitlines() == [f"{f}: {want[f]} chunks" for f in files]
          + [f"ingested {total} chunks into {db}"],
          f"21a: rag ingest printed {out[-400:]!r}")
    searched = {}
    for argv, forwards in (
            *((["search", RAG_QUERY, "-k", "5", "--search", mode],
              int(mode != "keyword")) for mode in RAG_MODES),
            (["ask", RAG_QUERY], 1)):
        Q.reset_launches()
        out, secs = cli_out(["rag"] + argv + model)
        got = dict(Q.LAUNCHES)
        exact_kernels(f"21a rag {argv[0]}", got, scaled(per, forwards))
        launches = added(launches, got)
        lines = out.splitlines()
        name = argv[0] if argv[0] == "ask" else f"search {argv[-1]}"
        if argv[0] == "search":
            check(len(lines) == 5 and all(ln.startswith("[") for ln in lines),
                  f"21a: rag {name} printed {out!r}")
        else:
            check(sum(ln.startswith("  [") for ln in lines) == 5,
                  f"21a: rag ask printed {out[-400:]!r}")
        searched[name] = dict(seconds=secs, lines=len(lines))

    # the file: every row a unit vector of 768 float32
    con = sqlite3.connect(db)
    rows = con.execute("SELECT id, text, embedding FROM chunks ORDER BY id"
                       ).fetchall()
    fts = bool(con.execute("SELECT count(*) FROM sqlite_master WHERE "
                           "name='chunks_fts'").fetchone()[0])
    blob, row_count = con.execute("SELECT data, row_count FROM ann_index "
                                  "WHERE name='hnsw'").fetchone()
    con.close()
    check(len(rows) == total == row_count,
          f"21a: {len(rows)} rows, {row_count} indexed, {total} chunks")
    check(all(len(r[2]) == 768 * 4 for r in rows), "21a: a blob is not 768 "
                                                   "float32 values")
    ids = [r[0] for r in rows]
    vecs = np.stack([np.frombuffer(r[2], np.float32) for r in rows])
    norms = np.linalg.norm(vecs, axis=1)
    check(float(np.abs(norms - 1).max()) <= 1e-5,
          f"21a: stored norms {norms.min()}..{norms.max()}")
    # sampled rows against Engine.embed of their text: a fresh quant engine
    # (the same kernels) and the dequant one. Timed: Engine.embed's wall ms
    # and its forward's device ms, bert_forward on the padded inputs
    # already on the card (encode's pageable copies would wait for the
    # timer's sleep, and the host's launches would fall in the window)
    rng = np.random.default_rng(SEED)
    pick = rng.choice(len(rows), RAG_SAMPLES, replace=False)
    timer = Timer(sleep_cycles=40_000_000)  # ~20 ms at 1.98 GHz: longer
    # than the host takes to enqueue one eager forward
    enc = fresh.encoder
    worst_quant = worst_deq = 0.0
    device_ms, wall_ms, tokens = [], [], []
    for i in pick:
        text, stored = rows[i][1], vecs[i]
        t0 = time.perf_counter()
        v = fresh.embed(text)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        worst_quant = max(worst_quant, float(np.abs(v - stored).max()))
        worst_deq = max(worst_deq, rel_diff(deq.embed(text), stored))
        ids_ = fresh.tokenizer.encode(text)
        tokens.append(len(ids_))
        toks = torch.zeros((1, bucket_len(len(ids_))), dtype=torch.int32,
                           device="cuda")
        toks[0, :len(ids_)] = torch.tensor(ids_, device="cuda")
        mask = torch.zeros(toks.shape, dtype=torch.bool, device="cuda")
        mask[0, :len(ids_)] = True
        with torch.no_grad():
            device_ms.append(timer.once(lambda: bert_forward(
                enc.params, enc.cfg, toks, mask,
                precision=enc.matmul_precision)))
    check(worst_quant <= RAG_EMBED_REL, f"21a: stored vectors differ from "
                                        f"Engine.embed by {worst_quant:.3g}")
    check(worst_deq <= QUANT_REL, f"21a: stored vectors differ from the "
                                  f"dequant engine's by {worst_deq:.3g}")
    del timer

    # the index: built from the file's rows, its blob read back, the
    # semantic scores, recall against brute force, each mode's query time
    store = SqliteVectorStore(db)
    t0 = time.perf_counter()
    live = store._ensure_index()
    build_s = time.perf_counter() - t0
    check(live.to_bytes() == blob, "21a: the rebuilt index differs from "
                                   "the stored ann_index blob")
    read = HNSWIndex.from_bytes(blob)
    kb = KnowledgeBase(store, embedder=EngineEmbedder(engine=fresh))
    queries = [rows[i][1][:200] for i in rng.choice(len(rows),
                                                    RAG_RECALL_QUERIES,
                                                    replace=False)]
    found = score_err = 0.0
    search_ms = []
    for q in queries:
        qv = fresh.embed(q)
        t0 = time.perf_counter()
        hits = live.search(qv, 5)
        search_ms.append((time.perf_counter() - t0) * 1e3)
        check(read.search(qv, 5) == hits, "21a: the ann_index blob's hits "
                                          "differ from the live index's")
        truth = {ids[j] for j in np.argsort(-(vecs @ qv))[:5]}
        found += len(truth & {cid for cid, _ in hits})
        for h in store.semantic_search(qv, 5):
            score_err = max(score_err, abs(h.score - float(
                vecs[ids.index(h.chunk_id)] @ qv)))
    check(score_err <= 1e-5, f"21a: semantic scores differ from the cosine "
                             f"by {score_err:.3g}")
    mode_ms = {}
    for mode in RAG_MODES:
        ms = []
        for q in queries[:RAG_MODE_QUERIES]:
            t0 = time.perf_counter()
            check(len(kb.retrieve(q, 5, mode)) == 5, f"21a: {mode} search")
            ms.append((time.perf_counter() - t0) * 1e3)
        mode_ms[mode] = median(ms)
    store.close()
    print(json.dumps({"rag_21a": dict(
        model=BGE_PRESET, files=len(files), chunks=total,
        db_bytes=os.path.getsize(db), ingest_s=ingest_s,
        ingest_chunks_per_s=total / ingest_s,
        embed_device_ms_median=median(device_ms),
        embed_wall_ms_median=median(wall_ms),
        embed_host_ms_median=median(wall_ms) - median(device_ms),
        embed_tokens_median=median(tokens), cli=searched,
        index_build_s=build_s, hnsw_search_ms_median=median(search_ms),
        query_ms_p50=mode_ms, recall_at_5=found / (5 * len(queries)),
        stored_vs_quant_embed=worst_quant, stored_vs_dequant_rel=worst_deq,
        semantic_score_vs_cosine=score_err, fts5=fts,
        embedder_model_bytes=embedder_bytes, launches=launches,
        launches_per_forward=per, seconds=time.perf_counter() - t_part,
        card=card)}), flush=True)
    del fresh, deq, kb
    return launches


def rag_server_path(card: str, gguf: str, l2: str, tmp: str) -> dict:
    """21b: `serve MODEL --rag-db FILE` on TinyLlama-1.1B: SURVEY.md ingested
    over HTTP, /search and /query in each mode, JAX's 400 and 503 bodies,
    the greedy answer against Engine.generate (its launches all replays),
    a chat completion beside a query, a hot reload. Returns the greedy
    query's launches."""
    import socket
    import threading
    import urllib.request

    import torch
    from llama_gguf_tpu_torch.cli import build_parser, serve_config
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.rag import KnowledgeBase, chunk_text, get_chunker
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
    from llama_gguf_tpu_torch.server.app import (ServerConfig, ServerState,
                                                 run_server)

    def serve(config, state):
        thread = threading.Thread(target=run_server, args=(config, state),
                                  daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{config.port}"
        for _ in range(100):
            try:
                with urllib.request.urlopen(base + "/health", timeout=5):
                    break
            except OSError:
                time.sleep(0.1)
        return thread, base

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    t_part = time.perf_counter()
    db = os.path.join(tmp, "server_kb.db")
    config = serve_config(build_parser().parse_args([
        "serve", gguf, "--port", str(free_port()), "--max-batch", "4",
        "--rag-db", db]))
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = ServerState(config)
    load_s = time.perf_counter() - t0
    server_bytes = torch.cuda.memory_allocated() - mem0
    check(state.kb is not None and state.kb.engine is state.engine,
          "21b: the knowledge base does not generate with the served engine")
    thread, base = serve(config, state)
    out: dict = dict(load_s=load_s, server_model_bytes=server_bytes)
    try:
        with open(os.path.join(ROOT, "SURVEY.md"), encoding="utf-8") as f:
            survey = f.read()
        want = len(chunk_text(survey, get_chunker("markdown", 512, 64)))
        t0 = time.perf_counter()
        status, body = post(base, "/v1/rag/ingest", {
            "text": survey, "source": "SURVEY.md", "chunker": "markdown"})
        out["ingest_s"] = time.perf_counter() - t0
        check((status, body) == (200, {"chunks": want, "skipped": False}),
              f"21b: ingest answered {status} {body}")
        hits = {}
        for mode in RAG_MODES:
            status, body = post(base, "/v1/rag/search", {
                "query": RAG_QUERY, "k": RAG_SERVER_K, "search": mode})
            check(status == 200 and len(body["results"]) == RAG_SERVER_K,
                  f"21b: search {mode} answered {status} {body}")
            hits[mode] = [(h["source"], h["doc_id"], h["score"])
                          for h in body["results"]]
        queried = {}
        for mode in RAG_MODES:
            captures = state.engine.runner.captures
            t0 = time.perf_counter()
            status, body = post(base, "/v1/rag/query", {
                "query": RAG_QUERY, "k": RAG_SERVER_K, "search": mode,
                "max_tokens": RAG_TOKENS})
            wall = time.perf_counter() - t0
            check(status == 200 and [(c["source"], c["doc_id"], c["score"])
                                     for c in body["citations"]]
                  == hits[mode], f"21b: query {mode} answered {status} "
                                 f"{body}, /search's hits {hits[mode]}")
            stats = state.engine.stats
            queried[mode] = dict(
                wall_ms=wall * 1e3,
                captures=state.engine.runner.captures - captures,
                prompt_tokens=stats.prompt_tokens,
                generated_tokens=stats.generated_tokens,
                tok_per_s=stats.generated_tokens / wall,
                decode_tps=stats.decode_tps)
        out["query"] = queried
        for path, field_name, body in (
                ("/v1/rag/ingest", "text", {"source": "x"}),
                ("/v1/rag/search", "query", {}),
                ("/v1/rag/query", "query", {"k": 2})):
            got = post(base, path, body)
            check(got == (400, {"error": {
                "message": f"missing '{field_name}'",
                "type": "invalid_request_error"}}),
                f"21b: {path} without {field_name} answered {got}")
        bare = ServerConfig(port=free_port(), device="cuda")
        bare_state = ServerState(bare)
        bare_thread, bare_base = serve(bare, bare_state)
        try:
            got = post(bare_base, "/v1/rag/query", {"query": "x"})
        finally:
            bare_state.shutdown()
            bare_thread.join(timeout=30)
        check(got == (503, {"error": {"message": "RAG not enabled (set "
                                                 "rag_db)",
                                      "type": "service_unavailable"}}),
              f"21b: a server without rag_db answered {got}")

        # greedy: the knowledge base's answer is Engine.generate's over the
        # template filled from the same hits; the second run replays graphs
        engine = state.engine
        r = engine.runner
        kb = KnowledgeBase(state.kb.store, engine=engine)
        greedy = SamplerConfig(temperature=0.0)
        kb.retrieve_and_generate(RAG_QUERY, RAG_SERVER_K, "hybrid",
                                 max_tokens=RAG_TOKENS, sampler=greedy)
        replays0, keys0 = dict(r.replays), set(r._graphs)
        eager0 = r.eager_steps
        Q.reset_launches()
        t0 = time.perf_counter()
        res = kb.retrieve_and_generate(RAG_QUERY, RAG_SERVER_K, "hybrid",
                                       max_tokens=RAG_TOKENS, sampler=greedy)
        greedy_s = time.perf_counter() - t0
        launches = dict(Q.LAUNCHES)
        steps = sum(r.replays.values()) - sum(replays0.values())
        replayed: dict[str, int] = {}
        for key, n in r.replays.items():
            for name, k in r._graphs[key].launches[0].items():
                replayed[name] = replayed.get(name, 0) + (
                    n - replays0.get(key, 0)) * k
        check(r.eager_steps == eager0 and set(r._graphs) == keys0,
              f"21b: {r.eager_steps - eager0} eager steps, captures "
              f"{set(r._graphs) - keys0}")
        exact_kernels("21b greedy query", launches, replayed)
        exact_kernels("21b greedy query", launches, scaled(PER_STEP, steps))
        context = "".join(f"[{i + 1}] {h.text}\n"
                          for i, h in enumerate(res.hits))
        prompt = kb.PROMPT_TEMPLATE.format(context=context,
                                           question=RAG_QUERY)
        text = engine.generate(prompt, max_tokens=RAG_TOKENS, sampler=greedy)
        check(res.answer == text, f"21b: the greedy answer {res.answer!r} "
                                  f"is not Engine.generate's {text!r}")
        out["greedy"] = dict(seconds=greedy_s, steps=steps,
                             prompt_tokens=engine.stats.prompt_tokens,
                             generated_tokens=engine.stats.generated_tokens,
                             decode_tps=engine.stats.decode_tps,
                             launches=launches)

        # a chat completion sent while a query runs: both finish
        done = {}

        def send(name, path, body):
            t0 = time.perf_counter()
            done[name] = post(base, path, body)[0], t0, time.perf_counter()

        threads = [threading.Thread(target=send, args=(
            "query", "/v1/rag/query", {"query": RAG_QUERY, "k": RAG_SERVER_K,
                                       "max_tokens": RAG_TOKENS}))]
        threads.append(threading.Thread(target=send, args=(
            "chat", "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 16, "temperature": 0.0})))
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=600)
        check(done.get("query", (0,))[0] == 200
              and done.get("chat", (0,))[0] == 200,
              f"21b: a query beside a chat completion: {done}")
        out["beside_chat"] = dict(
            overlapped=done["chat"][1] < done["query"][2],
            query_ms=(done["query"][2] - done["query"][1]) * 1e3,
            chat_ms=(done["chat"][2] - done["chat"][1]) * 1e3)

        # a hot reload: the knowledge base follows the served engine
        t0 = time.perf_counter()
        got = post(base, "/v1/internal/load_model", {"model_path": l2})
        check(got[0] == 200 and state.engine is not engine
              and state.kb.engine is state.engine,
              f"21b: reload {got}; the knowledge base kept the old engine")
        calls = []
        served = state.engine.generate

        def generate(prompt, **kw):
            calls.append(len(prompt))
            return served(prompt, **kw)

        state.engine.generate = generate
        status, _ = post(base, "/v1/rag/query", {
            "query": RAG_QUERY, "k": RAG_SERVER_K, "max_tokens": 8})
        check(status == 200 and len(calls) == 1,
              f"21b: after the reload the query answered {status} with "
              f"{len(calls)} calls of the new engine")
        out["reload"] = dict(seconds=time.perf_counter() - t0,
                             kb_follows_engine=True,
                             model_bytes=torch.cuda.memory_allocated() - mem0)
        del engine, r, kb
    finally:
        state.shutdown()
        thread.join(timeout=30)
    check(not thread.is_alive(), "21b: the server did not stop")
    out.update(seconds=time.perf_counter() - t_part, card=card)
    print(json.dumps({"rag_21b": out}), flush=True)
    return launches


def hub_cached_path(card: str, gguf: str, tmp: str) -> None:
    """21c: `download` of a file already in the cache prints its path and
    makes no request; `models` lists it."""
    import urllib.request

    cache = os.path.join(tmp, "hub")
    target = os.path.join(cache, "org--repo", "model.gguf")
    os.makedirs(os.path.dirname(target))
    os.symlink(gguf, target)
    requests = []

    def refuse(req, *args, **kwargs):
        requests.append(getattr(req, "full_url", req))
        raise OSError("21c: no request may be made")

    real, hub_mod = urllib.request.urlopen, sys.modules.get("huggingface_hub")
    urllib.request.urlopen = refuse
    sys.modules["huggingface_hub"] = None
    try:
        got, _ = cli_out(["download", "org/repo", "model.gguf", "--dir",
                          cache])
        listed, _ = cli_out(["models", "--dir", cache])
    finally:
        urllib.request.urlopen = real
        if hub_mod is None:
            sys.modules.pop("huggingface_hub", None)
        else:
            sys.modules["huggingface_hub"] = hub_mod
    check(got == f"{target}\n" and not requests,
          f"21c: download printed {got!r}, requests {requests}")
    check(listed.split() == [f"{os.path.getsize(gguf) / 1e6:.1f}", "MB",
                             target], f"21c: models printed {listed!r}")
    print(json.dumps({"rag_21c": dict(download=got.strip(),
                                      models=listed.strip(), card=card)}),
          flush=True)


def rag_path(card: str, bge: str, tinyllama: str, l2: str) -> dict:
    """Phase 21. Returns {path label: launches}."""
    import tempfile

    import torch

    t21 = time.perf_counter()
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli_l = rag_cli_path(card, bge, tmp)
        secs["21a"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        server_l = rag_server_path(card, tinyllama, l2, tmp)
        secs["21b"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        hub_cached_path(card, l2, tmp)
        secs["21c"] = time.perf_counter() - t0
    print(json.dumps({"phase_21": dict(
        seconds=time.perf_counter() - t21, parts_s=secs,
        script_s=time.perf_counter() - T_START, card=card)}), flush=True)
    log(f"phase 21 done in {time.perf_counter() - t21:.1f}s")
    return {f"{BGE_PRESET} rag CLI (21a)": cli_l,
            "TinyLlama-1.1B rag server greedy query (21b)": server_l}


def main() -> int:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    sys.path.insert(0, ROOT)
    # the Mixtral GGUF, phase 11's inputs, phase 12's, 14's, 15's, 16b's,
    # 17's and 18's GGUFs (host numpy work, minutes) build in nine child
    # processes while the dense path runs; leaving the block waits for the
    # children
    with ProcessPoolExecutor(
            max_workers=9,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        moe_gguf = pool.submit(build_model, MOE_PRESET, max_ctx=2048)
        formats = pool.submit(build_formats)
        hybrid_gguf = pool.submit(build_model, HYBRID_PRESET, max_ctx=2048)
        granite_gguf = pool.submit(build_model, GRANITE_PRESET, max_ctx=2048)
        mla_gguf = pool.submit(build_model, MLA_PRESET, max_ctx=2048)
        gemma_gguf = pool.submit(build_model, GEMMA_PRESET)
        encoders = pool.submit(build_encoders)
        load_gguf = pool.submit(build_model, LOAD_PRESET)
        oss_gguf = pool.submit(build_model, OSS_PRESET, max_ctx=2048)
        return run(moe_gguf, formats, hybrid_gguf, granite_gguf, mla_gguf,
                   gemma_gguf, encoders, load_gguf, oss_gguf)


def run(moe_gguf, formats, hybrid_gguf, granite_gguf, mla_gguf,
        gemma_gguf, encoders, load_gguf, oss_gguf) -> int:
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from llama_gguf_tpu_torch.utils import cuda_build
    from llama_gguf_tpu_torch.utils.timing import Timer, card_peaks

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    # nvcc runs in its own processes: the dense path's GGUF (host numpy
    # work) builds meanwhile
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        built = pool.submit(cuda_build.build_all,
                            ["qgemm", "moe_qmatmul", "qmatmul_variants",
                             "shortconv"])
        tinyllama = build_model("tinyllama-1.1b")
        built.result()
    log(f"kernels and the TinyLlama GGUF built in "
        f"{time.perf_counter() - t0:.1f}s (nvcc: {cuda_build.BUILD_SECONDS})")
    timer = Timer()

    # -- 2-5. the dense path, 7. serving, 13. item 6 on their engines, 10a.
    # the server, 8. the probe, then 6. MoE (and 10b) -------------------------
    t0 = time.perf_counter()
    dense, dense_launches, quant, deq = dense_path(card, timer, peaks,
                                                   tinyllama)
    log(f"dense path done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving_launches, serving = serving_path(card, tinyllama, peaks)
    log(f"serving path done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    item6_launches = item6_path(quant, deq, serving, card)
    log(f"phase 13 done in {time.perf_counter() - t0:.1f}s")
    t16 = time.perf_counter()
    kv_launches = kv_formats_path(quant, deq, card, peaks)
    phase_16a_s = time.perf_counter() - t16
    log(f"phase 16a done in {phase_16a_s:.1f}s")

    # -- 19. speculative decoding, LoRA (the last use of phase 4's engines:
    # it rewrites their params) and LLAMA_DEBUG ------------------------------
    t19 = time.perf_counter()
    draft_gguf = load_gguf.result()
    spec_launches = speculative_path(quant, tinyllama, draft_gguf, card)
    lora, lora_launches = lora_path(quant, deq, tinyllama, card, timer,
                                    peaks)
    debug_path(draft_gguf, card)
    print(json.dumps({"phase_19": dict(
        seconds=time.perf_counter() - t19,
        script_s=time.perf_counter() - T_START, card=card)}), flush=True)
    log(f"phase 19 done in {time.perf_counter() - t19:.1f}s")
    del quant, deq, serving
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    server_launches = server_path(card, tinyllama)
    log(f"server path done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    probe, probe_launches = variant_path(card, timer, peaks)
    log(f"probe done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gguf = moe_gguf.result()
    log(f"waited {time.perf_counter() - t0:.1f}s for the Mixtral GGUF")
    t0 = time.perf_counter()
    moe, moe_launches, moe_batched_launches = moe_path(card, timer, peaks,
                                                       gguf)
    log(f"MoE path done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fmts, fmt_launches = formats_path(card, timer, peaks, formats)
    log(f"formats path done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gguf = hybrid_gguf.result()
    log(f"waited {time.perf_counter() - t0:.1f}s for the {HYBRID_LABEL} "
        "GGUF")
    t0 = time.perf_counter()
    hybrid, hybrid_launches, hybrid_batched_launches = hybrid_path(
        card, timer, peaks, gguf)
    log(f"hybrid path (phase 12) done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gguf = granite_gguf.result()
    log(f"waited {time.perf_counter() - t0:.1f}s for the {GRANITE_LABEL} "
        "GGUF")
    t0 = time.perf_counter()
    mamba, mamba_launches, mamba_batched_launches = mamba_path(
        card, timer, peaks, gguf)
    torch.cuda.empty_cache()
    tiny, tiny_launches = mamba_tiny_path(card, timer, peaks)
    log(f"Mamba path (phase 14) done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gguf = mla_gguf.result()
    log(f"waited {time.perf_counter() - t0:.1f}s for the {MLA_LABEL} GGUF")
    t0 = time.perf_counter()
    mla, mla_launches, mla_batched_launches = mla_path(card, timer, peaks,
                                                       gguf)
    torch.cuda.empty_cache()
    mla_tiny, mla_tiny_launches = mamba_tiny_path(card, timer, peaks,
                                                  MLA_TINY, "15c")
    log(f"DeepSeek path (phase 15) done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gguf = gemma_gguf.result()
    log(f"waited {time.perf_counter() - t0:.1f}s for the {GEMMA_LABEL} GGUF")
    t16 = time.perf_counter()
    gemma, ring_launches, ring_batched_launches = ring_path(card, timer,
                                                           peaks, gguf)
    paged_check(card)
    phase_16_s = phase_16a_s + time.perf_counter() - t16
    print(json.dumps({"phase_16": dict(
        seconds=phase_16_s, seconds_16a=phase_16a_s,
        seconds_16bc=phase_16_s - phase_16a_s, card=card)}), flush=True)
    log(f"phase 16 took {phase_16_s:.1f}s in all")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    builds = encoders.result()
    log(f"waited {time.perf_counter() - t0:.1f}s for phase 17's GGUFs")
    enc, enc_launches = encoder_path(card, timer, peaks, builds)
    torch.cuda.empty_cache()

    # -- 18. the load path, gpt-oss, the tiny routing presets -----------------
    t18 = time.perf_counter()
    load_path(card, load_gguf.result())
    gguf = oss_gguf.result()
    log(f"waited {time.perf_counter() - t18:.1f}s for phase 18's GGUFs "
        "(18a included)")
    oss, oss_launches, oss_batched_launches = oss_path(card, timer, peaks,
                                                       gguf)
    torch.cuda.empty_cache()
    routing_tiny, routing_tiny_launches = mamba_tiny_path(
        card, timer, peaks, ROUTING_TINY, "18c")
    torch.cuda.empty_cache()
    sidecar_loads(card)
    counts = native_counts()
    check(not counts["numpy"], f"bulk calls served by numpy: {counts}")
    print(json.dumps({"phase_18": dict(
        seconds=time.perf_counter() - t18, native_calls=counts["native"],
        loads=LOADS, script_s=time.perf_counter() - T_START, card=card)}),
        flush=True)
    torch.cuda.empty_cache()

    # -- 20. the parallel plans: ranks sharing the card -----------------------
    par, par_launches = parallel_path(card, timer, peaks, tinyllama,
                                      moe_gguf.result(), load_gguf.result())
    torch.cuda.empty_cache()

    # -- 21. RAG: the CLI on bge-base, the server on TinyLlama, download ------
    rag_launches = rag_path(card, builds[BGE_PRESET], tinyllama,
                            load_gguf.result())

    kernels = []
    for name, meta in KERNELS.items():
        mine = [m for m in (dense + lora + moe + probe + fmts + hybrid
                            + mamba + tiny + mla + mla_tiny + gemma + enc
                            + oss + routing_tiny + par)
                if m["name"] == name]
        head = mine[0]  # the first path's first shape (decode, or prefill)
        by_path = {path: launched.get(name, 0) for path, launched in (
            ("TinyLlama-1.1B", dense_launches),
            ("TinyLlama-1.1B serving", serving_launches),
            ("TinyLlama-1.1B phase 13", item6_launches),
            ("TinyLlama-1.1B server", server_launches),
            ("TinyLlama-1.1B speculative (19a)", spec_launches),
            ("TinyLlama-1.1B LoRA (19b)", lora_launches),
            (MOE_LABEL, moe_launches),
            (f"{MOE_LABEL} batched", moe_batched_launches),
            ("probe", probe_launches), *fmt_launches.items(),
            (HYBRID_LABEL, hybrid_launches),
            (f"{HYBRID_LABEL} batched", hybrid_batched_launches),
            (GRANITE_LABEL, mamba_launches),
            (f"{GRANITE_LABEL} batched", mamba_batched_launches),
            ("Mamba tiny presets (14c)", tiny_launches),
            (MLA_LABEL, mla_launches),
            (f"{MLA_LABEL} batched", mla_batched_launches),
            ("DeepSeek tiny presets (15c)", mla_tiny_launches),
            *kv_launches.items(), (GEMMA_LABEL, ring_launches),
            (f"{GEMMA_LABEL} batched", ring_batched_launches),
            *enc_launches.items(), (OSS_LABEL, oss_launches),
            (f"{OSS_LABEL} batched", oss_batched_launches),
            ("routing tiny presets (18c)", routing_tiny_launches),
            *par_launches.items(), *rag_launches.items())
            if launched.get(name, 0)}
        check(bool(by_path), f"{name}: launched on no path")
        kpaths: dict[str, int] = {}  # the kernel's own paths, by case count
        for m in mine:
            kp = m.get("kernel_path", "cuda cores")
            kpaths[kp] = kpaths.get(kp, 0) + 1
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(by_path.values()), launches_by_path=by_path,
            path=head["path"], kernel_paths=kpaths,
            kernel_path=head.get("kernel_path", "cuda cores"),
            max_abs_err=max(m["max_abs_err"] for m in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], at=head["case"],
            measurements=mine))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
