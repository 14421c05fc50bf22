#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
     source, all started together, sm_90a) and print each kernel's
     registers, spills and stack from ptxas;
  3. hold each kernel to its plain PyTorch version on the card: the
     serving kernels at the serving shapes of Yi-6B and at edge cases
     (ragged per-slot pos, pos 0, a fully masked row, pos0 in {0, 512}, a
     sliding window, a ring layout, ragged tiles), with f32/bf16 and with
     int8 caches (per-row f32 scales); the append kernel's bf16
     (tensor-core) arm and its f32 (SIMT) arm each over every edge case,
     and its int8 arms (bf16 q on the tensor cores, f32 q on the SIMT
     body) over the int8 cases, each case checked to launch its own arm;
     the append kernel at the speculative verify shape (B = 4, K in
     {4, 6}, 32 q over 4 kv heads, D = 128, a 1024-row cache at ragged
     pos {17, 300, 640, 1019}, re-based to shift 1024, kpos_linear=False)
     through ``dispatch.flash_attention_verify`` in each of its four arms
     (bf16, f32, int8 under a bf16 q and under an f32 q), and the paged
     verify over a permuted table; the decode kernel with its
     key range forced into 1 and 2 splits and split_plan's, against the
     plain decode and against the plain model of its split-and-skip
     algorithm (``ref.decode_split_ref``), including a case whose last
     splits lie wholly past pos; the partials kernel over 1, 2 and 4
     slices of the serving cache (B = 4, L = 1024, 32 q over 4 kv heads,
     D = 128; bf16, f32 and int8; a fully masked slice, an all-masked
     row, and a ragged L = 300), each slice at the same three splits
     against the plain partials and the slices combined
     (``ref.combine_partials``) against the decode kernel and the plain
     decode; the training kernels at the train shape (B = 4,
     S = 1024, 32 q heads over 4 kv heads, D = 128, x (4096, 4096), a
     45M-element leaf) and at edge cases (f32, a window, causal=False, a
     ragged S, G = 1, ragged row and element counts; the flash kernels'
     bf16 tensor-core arms also at a ragged S with D = 64, at a window
     of 16 keys and at Granite-MoE's train shape, B = 4, S = 1024, 16 q
     over 8 kv heads, D = 64; both arms of the flash forward and backward
     at Whisper's encoder, B = 4, S = 1500 (ragged), 8 / 8 heads, D = 64,
     bidirectional, and zamba2's train shape, B = 4, S = 1024, 32 / 32
     heads, D = 64, causal); the decode kernel also at zamba2's shared
     block (32 / 32 heads, D = 64, G = 1; B = 4 and the token loop's
     single row) and Whisper's decoder (8 / 8, D = 64, a 448-row cache),
     and the rmsnorm at width 2048 (zamba2's and xlstm's d_model, with
     and without rstd); the append and decode kernels also at
     Granite-MoE's serving shapes (16 q over 8 kv heads, G = 2, D = 64)
     and Llama-4-Scout's (40 q over 8 kv heads, G = 5, D = 128; its
     sliding-window layers a 1024-row ring under an 8192-key window), bf16
     and f32; the RMSProp kernel's one-leaf update, and its multi-leaf
     update and apply modes over the paper net's 13 leaves and a 148-leaf
     table of the train step's leaves, against the plain version and bit
     for bit against the one-leaf kernel followed by p.sub_(update).
     f32 within rtol = atol = 1e-5; bf16 within two bf16 ulps (rtol = 2**-6)
     and atol = 1e-5; sums over rows or keys (dscale, dq, dk, dv, the
     partials' acc) with an added atol of 2**-14 times the same sum taken
     over absolute values
     (the f32 summation-order bound, see SUM_ABS_TOL); the bf16 flash arms,
     which round p and ds to bf16 as the TPU kernels do, with a further
     ref.ROUND_TOL (2**-8) times the sum over absolute terms of what they
     round (ref.flash_round_scale; the append arm's ref.append_round_scale;
     not the int8 arms, which keep p in f32 as the reference does),
     lse held to 1e-5; the rmsnorm wrapper
     must refuse rows it cannot move in 16-byte chunks;
  3b. jax.random's threefry (``core/prng.py``) on the card against the
     CPU: bits, uniform, randint and categorical identical at (4, 64000),
     at 4096 x 4096 and at (16, 3), whose hash replays a CUDA graph
     (categorical where its top-2 margin exceeds 1e-5),
     truncated_normal within 4 f32 ulps; the card's time of a 4096 x 4096
     truncated normal draw and of one sampling call;
  4. time each kernel and arm, its plain version and the nearest single
     PyTorch call (none for rmsprop, the partials kernel and the int8 arms:
     no PyTorch call computes them) with CUDA events (median, L2 flushed
     before each call) beside the least time the card could take for the
     work, and the ratios of the kernel's time to both (x_bound,
     x_library); the rmsnorm forward at the prefill, train and decode
     shapes; the decode and partials kernels' f32 arms beside their bf16
     ones; rmsprop's apply mode over the paper net's 13 leaves (one
     worker update) and the train step's 148 leaves at full size, its
     one-leaf update at the MLP matrix (beside the apply mode and the
     update followed by p.sub_ there) and at the RL path's leaves (the
     paper net's FC, 2592 x 256, and a 256 x 3 policy matrix); the append
     kernel's four arms at the verify shape (K = 4; the bf16 arm also at
     K = 6) beside masked SDPA with ``enable_gqa``; the append and decode
     kernels' bf16 arms at Granite-MoE's and Llama-4-Scout's serving
     shapes and the flash forward and backward at Granite-MoE's train
     shape; the flash forward and backward, each arm, at Whisper's encoder
     and zamba2's train shape; the decode kernel at zamba2's and Whisper's
     decode shapes; the rmsnorm forward with rstd at 4096 x 2048;
  5. the port's reduced model in f32 on the card against the same model
     on the CPU (a counted path: the append kernel's f32 SIMT arm), then
     the engine on Yi-6B at full width and depth (bf16 weights from a
     seed, bf16 KV, 4 slots, cache 1024, chunk 128, 8 greedy requests) on
     its default paged layout (page 128, 33 pages, 264 MiB of pool): the
     report says paged, every request completes, all logits are finite,
     and the run launched the rmsnorm, the append kernel's tensor-core arm
     (736 times: 23 chunks x 32 layers) and the decode kernel's float arm
     and no other attention arm; the same run on the contiguous layout,
     held to the same gates, emits the same tokens exactly; then the paged
     run sampled (seed 0's threefry streams);
  5p. prefix sharing: Yi-6B, 8 slots, 65 pages, 16 greedy requests on one
     512-token prefix with distinct tails of 16-100 tokens (two pairs of
     identical prompts), generations 32-64, with the prefix cache on and
     off: the same tokens, chunks skipped, copy-on-write forks and fewer
     pages with it on; TTFT and admission wall of both;
  5o. overload: phase 5's trace on an 11-page pool (two of its largest
     requests' worst case): under reservation admission every request
     completes with phase 5's tokens, none is preempted and requests queue
     while a slot stands free; under optimistic admission decode runs out
     of pages and preempts; both end with balanced books (no reservation,
     every refcount 0); then reduced Yi-6B in f32 on a 5-page pool of 64
     rows, optimistic, and again under ``FaultPlan.random(0)`` on a
     virtual clock: the card's engine emits the CPU engine's tokens
     (margin >= 1e-3) with its preemption, requeue, shed, retry, COW and
     page counters and virtual clock;
  5s. speculative decoding: (a) phase 5's trace with n-gram drafts
     (spec_k 4) on the paged layout: every request completes, logits are
     finite, only the append kernel's tensor-core arm runs (exactly 32
     launches a prefill chunk and a verify round, every round through the
     verify routes) and kernel 6 never; a request that leaves phase 5's
     tokens must do so at a near tie (the two tokens' logits, from one
     prefill of the shared prefix, within NEAR_TIE_ULPS bf16 ulps);
     (b) a probed high-acceptance trace (``bench_serve.spec_trace``'s
     method: 24 candidate prompts on a 16-token prefix, fold 8, 4
     requests on the chosen prompt, max_new 48, spec_k 6) off and n-gram
     in turns (off, ngram, ngram, off): tokens/s, TTFT, accept rate,
     rounds, tokens held to the first off run's; (c) that trace with the
     draft model (its f32 decode through kernel 6's float arm, its
     admissions through the append kernel's SIMT arm); (d) reduced Yi-6B
     in f32, card against CPU: n-gram paged, int8 contiguous, the draft
     model, sampled, and always-wrong drafts under optimistic admission
     (pages rewound): tokens and speculative counters identical (margin
     >= 1e-3), books balanced; (e) a profile of 8 verify rounds beside
     phase 6's 8 decode steps, with the device time of the verify's
     cache concatenation and page gathers a round;
  6. torch.profiler traces of one admission and of eight decode steps,
     paged and contiguous in turns (paged, contiguous, contiguous, paged):
     wall time, device busy share, kernels a step, the top kernels, and
     the kernels whose launches a step differ between the layouts (the
     gathers among them);
  6a. phase 5's run with int8 KV (paged): the int8 arms of the append (on
     the tensor cores, 736 launches) and decode kernels, and no other
     attention arm;
  6b. the context-parallel path: the same trace through ``run_engine``
     with int8 KV and ``decode_cp[1]`` over a one-rank NCCL group (a
     ``file://`` store): its report says ``decode_cp[1]``, and it launched
     the int8 append arm and the partials kernel's int8 arm and no other
     attention arm (kernel 6 in neither arm); then its profile as in
     phase 6;
  6c. reduced Yi-6B on the card, greedy: the engine under ``decode_cp[1]``
     emits the tokens of the engine without it, with int8 and bf16 KV;
     each of the four runs checked for its layout and kernels as above
     (its f32 activations take the append kernel's SIMT arms: the float
     arm over a bf16 cache, the int8 arm counted as
     ``flash_append_int8_f32`` over an int8 one);
  6d. reduced Yi-6B in f32, sampled: the engine on the card emits the
     engine on the CPU's tokens, margin-qualified (the smallest top-2 gap
     of logits plus Gumbel noise along the streams at least 1e-3);
  7. three train steps of reduced Yi-6B in f32 on the card against the
     same steps on the CPU (losses to rtol 1e-4, parameters to 1e-5),
     through the flash kernels' f32 (SIMT) arms and never their bf16 arms;
  8. Yi-6B at full width cut to 16 of 32 layers (f32 masters, bf16
     compute, remat, shared RMSProp, TokenPipeline batch 4 x 1024): one
     warm-up step, three timed steps and one profiled step; every loss and
     gradient finite, every parameter leaf changed and every training
     kernel launched, the flash kernels through their bf16 (tensor-core)
     arms only: 2 forward launches (the forward and its remat) and one
     backward a layer and step; the optimizer's apply mode 3 times a step
     (148 leaves, 64 a launch) and its other entries never;
  9. the paper's asynchronous RL loop (``core/async_runner.py`` and its
     environments, networks and algorithms), each run on the card against
     the same run on the CPU: actions identical where every decision
     margin exceeds 1e-5 (continuous actions within 1e-5), losses within
     rtol 1e-4, parameters within rtol = atol = 1e-5, and Shared RMSProp
     (``rmsprop_apply_multi``, one launch an update over all its leaves,
     the subtraction fused) launched exactly rounds x workers times on a
     Hogwild path and once a round on a sync path, the one-leaf and
     update-mode entries never, and no other kernel:
     9a. the train CLI's ``--mode rl`` runs (8 workers, the MLP agent at
     hidden 64, 3 rounds): the four algorithms in Hogwild with shared
     statistics, A3C in sync mode, with per-worker statistics, on
     Pendulum and on GridMaze; DQN with replay (40 frames: 17 updates)
     and replay-async (8 rounds of 4 workers) at the sizes of their JAX
     tests; then ``train.main`` itself, its records and checkpointed
     parameters;
     9b. the paper's conv + LSTM network at full width (1,199,412
     parameters in 13 leaves) on 84 x 84 Catch frames, 16 workers, t_max 5,
     Hogwild with Shared RMSProp: 3 rounds against the CPU, then 20 timed
     rounds (round wall, frames/s, peak memory, 16 rmsprop launches a
     round) and one profiled round; and one A3C segment loss with its
     gradients at 84 x 84 x 4 on 16 workers' random frames (losses rtol
     1e-4, gradients within 1e-4 of each leaf's largest);
     9c. ``examples.quickstart``'s run (4001 rounds) on the card: its final
     average return must beat 0.5; then one profiled round;
     9d. T3 delayed sync, 2 groups merged every 3 steps, 3 steps of reduced
     Yi-6B in f32 against the CPU: the groups drift, then agree at the
     merge; one rmsprop launch a group and step;
  10. MoE blocks and M-RoPE (``models/moe.py``, ``common.mrope_cos_sin``):
     10a. reduced models in f32, card against CPU: Granite-MoE at its
     reduced capacity factor (8.0, nothing drops) and at 1.25 (forward
     logits, value and aux_loss within rtol = atol = 1e-5, prefill then
     decode, three train steps as phase 7, aux included); the engines of
     Granite-MoE and Llama-4-Scout at 1.25, greedy, 4 slots on 6 requests
     (idle slots and padding rows compete for expert capacity): tokens
     identical where every choice wins by >= 1e-3 and every routing
     choice by >= 1e-5; Qwen2-VL's forward on embeds with distinct
     temporal / height / width positions;
     10b. Granite-MoE at full width and depth (24 layers, d 1024, 16 / 8
     heads, D = 64, 32 experts, top-8, bf16 weights from seed 0) through
     phase 5's engine and trace, paged then contiguous, each run held to
     phase 5's gates (the append kernel's tensor-core arm once a prefill
     chunk and layer); paged tokens equal contiguous ones, or where they
     differ both runs are repeated watching the MoE calls and every
     difference must come with a padding row or an idle slot holding an
     expert slot a real token lost (the reference's semantics: those rows
     hold other contents in the two layouts); then both layouts at
     capacity factor n_experts / top_k, where nothing drops, must emit
     the same tokens outright; the paged engine's profile (one admission,
     8 decode steps) and the device time of the decode step's MoE halves
     against its attention calls;
     10c. Granite-MoE training at full width and depth (f32 masters, bf16
     compute, remat, shared RMSProp, batches of 4 x 1024): phase 8's gates
     (aux > 0 among them), the flash kernels' bf16 arms 2 forward and 1
     backward launches a layer and step, the RMSProp apply mode
     ceil(243 / 64) = 4 times a step;
     10d. Llama-4-Scout at full width cut to 4 of 48 layers (one block
     cycle: three sliding-window layers and a global one; top-1 of 16
     experts, so two decode slots on one expert drop one) served as 10b;
     10e. Qwen2-VL-72B at full width cut to 2 of 80 layers: one bf16
     forward on embeds (B 2, S 1024) with distinct positions, finite, the
     flash forward's bf16 arm once a layer;
  11. mamba2 with zamba2's shared block, mLSTM/sLSTM and Whisper
     (``models/ssm.py``, ``xlstm.py``, ``encdec.py``; the engine's token
     loop, ``ServeEngine._prefill_loop``):
     11a. reduced zamba2, xlstm, xlstm with the ("mlstm", "slstm") cycle
     and Whisper in f32, card against CPU: forward logits and values and
     16 decode steps (Whisper after ``prefill_cross``) within rtol = atol
     = 1e-4, three train steps as phase 7, and (but for Whisper, which
     the engine does not serve) the token-loop engine's greedy tokens, 4
     requests on 2 slots, identical (margin >= 1e-3); each path launching
     kernel 1 (not Whisper's LayerNorms), the flash kernels' f32 arms and
     kernel 6's float arm where the model has attention, and no other
     attention arm;
     11b. zamba2-1.2b at full width and depth (f32 masters from seed 0,
     served cast to bf16): phase 5's 8 requests with prompts cut to 16-64
     tokens (the token loop runs a decode step a prompt token), 4 slots,
     cache 1024, bf16 KV: every request completes, logits finite,
     contiguous, kernel 1 and kernel 6's float arm and no other attention
     arm; one decode step launches kernel 1 2 x 38 + 2 x 6 + 1 = 89 times
     and kernel 6 6 times; the profile of 8 decode steps; then three
     train steps (4 x 1024, remat) with phase 8's gates, the flash
     kernels 2 x 6 forward and 6 backward launches a step (the shared
     block's applications);
     11c. xlstm-1.3b at full width cut to 8 of 48 layers (one 7:1
     cycle, as 12h cuts it): the same engine run (kernel 1, 17 launches
     a decode step, and no attention kernel at all) and three train
     steps (no flash launch), without a profiled step;
     11d. Whisper-base at full size: stub frames (4, 1500, 512),
     ``prefill_cross`` (kernel 3's bidirectional arm once an encoder
     layer) and 32 greedy decode steps on 4 rows (kernel 6 once a layer
     and step), a teacher-forced forward at S = 448 (kernel 3 twelve
     times: six bidirectional, then six causal), three train steps at B
     4, S 448 (12 forward and 12 backward flash launches a step, no
     remat; kernel 8);
  12. the multi-rank train step (``distributed/fsdp.py``,
     ``models/moe_ep.py``, ``core/llm_a3c.loss_grads``): one rank a card
     (n = torch.cuda.device_count()), spawned after the build, over NCCL;
     with n = 1 every collective is a copy over a group of one, with more
     the same checks run across cards:
     12a. reduced yi-6b on (n, 1), FSDP and held whole, and at n = 1
     reduced granite-moe (no load-balance loss) under ``moe_ep`` on
     (1, 1), f32, 3 steps against the CPU's single-process step
     (parameters rtol = atol = 1e-5, losses rtol 1e-4); each run (12a-12f)
     launches kernels 1, 2,
     3 and 5 exactly as ``_train_launches`` counts from the layer count
     (which the unsharded step on the card, where one runs beside it,
     must match too) and ``rmsprop_apply_multi`` once an update, issues
     exactly ``_step_collectives`` a step and routes every MoE layer
     expert-parallel;
     12b. Yi-6B at full width through the FSDP step at phase 8's shape
     (4 x 1024, remat), 3 steps, the runs sharing one draw of the
     weights: with n = 1 16 of 32 layers, between two unsharded runs, and
     bitwise equal to them where they are to each other (else within
     twice their spread); with n >= 2 dividing 4 all 32 layers; step
     wall, tokens/s and each run's own peak memory a rank;
     12c. Granite-MoE with nothing cut on (1, n), tensor-parallel
     attention and the experts expert-parallel over the model axis, 2
     steps: every MoE layer expert-parallel, and with n = 1 the dense-MoE
     step's losses and parameters within 1e-5 relative;
     12d. delayed sync on (pod n, 1, 1), merging every 2 steps: each
     group's parameters against the CPU's list form with n groups;
     12e. tensor and sequence parallelism on (1, n), asked for at n = 1
     too: reduced yi-6b (the whole-kv arm at n >= 2), stablelm and
     granite-moe (TP attention, expert-parallel experts on the sequence
     rows), and at n = 4 yi and granite-moe on (2, 2) with FSDP over data,
     held to the CPU as 12a; every layer attends on local heads and
     normalises the sequence rows (the routes, exact);
     12f. Yi-6B at full width through the tensor-parallel step with
     remat: at n = 1 16 layers on 12b's draw, 2 steps, against its
     unsharded runs; at n = 4 all 32 layers on (1, 4) and on (2, 2);
     12g. tensor and sequence parallelism of the recurrent and
     encoder-decoder blocks on (1, n), asked for at n = 1 too: reduced
     zamba2 (mamba2's blocked ``in_proj`` and conv, the shared block),
     xlstm on the ("mlstm", "slstm") cycle (the sLSTM's ``r`` over its
     heads) and Whisper (vocab split), and at n = 4 each on (2, 2), held
     to the CPU as 12a, with every recurrent layer on local heads and its
     inner norm on feature-gathered rows, every Whisper decoder layer's
     cross attention on local heads (the routes, exact);
     12h. at full width with remat (bf16 compute) from one draw: at n =
     1 zamba2-1.2b with nothing cut (4 x 1024) and Whisper-base with
     nothing cut (4 x 1500 stub frames, 448 tokens), 2 steps each, and
     xlstm-1.3b cut to 8 of 48 layers (one 7:1 cycle, its sLSTM
     included), 1 step, each on a
     (1, 1) mesh against its unsharded step (bitwise, or within 1e-5
     relative, or twice the spread of a second unsharded run); at n = 4
     zamba2-1.2b and xlstm-1.3b at all 48 layers on (1, 4); step wall,
     tokens/s, peak memory a rank, busy share (not for xlstm, whose
     sLSTM loop's launches the profiler would take minutes over), and the
     collectives and launches a step, exact.

Every kernel and arm must have been launched on one of the main paths
(phase 5's reduced model and engines, each run of 5p, 5o and 5s, 6a, 6b, each
of the four runs of 6c, 6d, 7, 8, each run of 9, of 10a-10e, of
11a-11d and of 12a-12h (rank 0's counts, which every rank must equal),
each with
the counters set to 0 just before it and read just after); the kernels line
gives each one's launches by path.
The last three lines are the card's name and power limit (nvidia-smi), a
JSON object with one record per kernel and {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# (rtol, atol).  Kernel and plain version both compute in f32 and round
# once to the output dtype, so a bf16 output may sit one ulp off its plain
# version where the two f32 values straddle a rounding boundary; rtol =
# 2**-6 allows two ulps (a bf16 ulp is at most 2**-7 of the value), and the
# small atol keeps near-zero attention outputs held as tightly.
F32_TOL = (1e-5, 1e-5)
BF16_TOL = (2.0 ** -6, 1e-5)
# An output that is a long f32 sum (dscale over 4096 rows; dq, dk, dv over
# up to 1024 keys or 8 heads x 1024 queries, each term itself a product of
# sums over D = 128) is summed in another order by the kernel than by its
# plain version.  The rounding error of such a nested sum is bounded by
# about (depth of the sums) * u * (the same sums over absolute values),
# u = 2**-24 the f32 unit roundoff; 2**-14 = 1024 u covers the depth with
# room to spare and is still 100x below a bf16 ulp of that magnitude.
SUM_ABS_TOL = 2.0 ** -14
# The bf16 arms of the flash kernels round p and ds to bf16 before their
# products, as the TPU kernels do, while the plain versions keep them in
# f32: each such output may move by ref.ROUND_TOL (2**-8, twice the bf16
# unit roundoff 2**-9) times the same sum over absolute terms
# (ref.flash_round_scale), added to its tolerance.  lse is never rounded.
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
TRIALS = 25
RL_LEAF_SIZES = (2592 * 256, 1024, 256 * 3, 3)


def _tol(dtype):
    import torch
    return F32_TOL if dtype == torch.float32 else BF16_TOL


def _compare(what, got, want, sum_abs=None, round_abs=None, echo=True):
    """Max abs error of got vs want; raises where any element is beyond
    atol + rtol * |want| for the output's dtype.  ``sum_abs``, for an
    output that is a sum (over rows, keys or heads), is the same sum taken
    over the absolute values of its terms: SUM_ABS_TOL * sum_abs is added
    to each element's tolerance (see SUM_ABS_TOL).  ``round_abs``, for an
    output of a bf16 flash arm, is the sum over absolute terms whose
    factors that arm rounds to bf16: ROUND_TOL * round_abs is added too.
    ``echo=False`` prints a line only where the check fails."""
    import torch

    from repro_torch.kernels.ref import ROUND_TOL
    rtol, atol = _tol(want.dtype)
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    diff = (got - want).abs()
    err = float(diff.max())
    tol = atol + rtol * want.abs()
    if sum_abs is not None:
        tol = tol + SUM_ABS_TOL * sum_abs.float()
    if round_abs is not None:
        tol = tol + ROUND_TOL * round_abs.float()
    # worst element's share of its own tolerance (<= 1 passes)
    use = float((diff / tol).max())
    ok = use <= 1.0
    if echo or not ok:
        rms = float(want.square().mean().sqrt())
        extra = f" +{SUM_ABS_TOL:g}*sum|terms|" if sum_abs is not None else ""
        if round_abs is not None:
            extra += f" +{ROUND_TOL:g}*sum|rounded terms|"
        print(f"check {what}: max_abs_err={err:.3e} rtol={rtol:g} "
              f"atol={atol:g}{extra} worst_err/tol={use:.3f} "
              f"rms_want={rms:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: error {use:.3f}x its tolerance "
                             f"(max abs error {err})")
    return err


def _time_ms(fn, flush):
    """Median device time of one call, L2 flushed before each call (the
    flush also keeps the card busy while the host enqueues the call)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(TRIALS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _randn(shape, gen, dtype, scale=1.0):
    import torch
    t = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (t * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 3 + 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_rmsnorm(gen, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, rmsnorm_cuda
    errs = []
    for rows, d, dt in ((512, 4096, torch.bfloat16), (4, 4096, torch.bfloat16),
                        (512, 4096, torch.float32), (7, 104, torch.bfloat16),
                        (3, 100, torch.float32),
                        # zamba2's and xlstm's d_model (their gated norms
                        # are 4096 wide, as above); the token loop's
                        # single row at both widths
                        (4, 2048, torch.bfloat16), (1, 2048, torch.float32),
                        (1, 2048, torch.bfloat16), (1, 4096, torch.bfloat16)):
        x = _randn((rows, d), gen, dt)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        errs.append(_compare(f"rmsnorm rows={rows} d={d} {dt}",
                             rmsnorm_cuda.rmsnorm_fwd(x, scale),
                             ref.rmsnorm_ref(x, scale)))
    # the rstd output of the training forward: train shape, f32, ragged
    # and Yi-6B's sequence-parallel rows at tp 2 and 4 (4 x 1024 / tp)
    for rows, d, dt in ((4096, 4096, torch.bfloat16),
                        (4096, 4096, torch.float32),
                        (4099, 4096, torch.bfloat16), (7, 104, torch.float32),
                        (4096, 2048, torch.bfloat16),
                        *((r, 4096, torch.bfloat16) for r in SP_ROWS),
                        # zamba2's and xlstm's sequence-parallel rows at
                        # tp 2 (their split-feature norms take whole rows
                        # of 4096, the train shape above)
                        (ZAMBA2_SP_ROWS, 2048, torch.bfloat16)):
        x = _randn((rows, d), gen, dt)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        y, rstd = rmsnorm_cuda.rmsnorm_fwd(x, scale, save_residuals=True)
        want_y, want_rstd = ref.rmsnorm_ref(x, scale, save_residuals=True)
        errs.append(_compare(f"rmsnorm+rstd rows={rows} d={d} {dt} y", y,
                             want_y))
        errs.append(_compare(f"rmsnorm+rstd rows={rows} d={d} {dt} rstd",
                             rstd, want_rstd))
    # rows that are not whole 16-byte chunks on 16-byte boundaries are
    # refused, never launched
    base = _randn((3 * 104 + 1,), gen, torch.bfloat16)
    for label, x in (("d=100 bf16", _randn((3, 100), gen, torch.bfloat16)),
                     ("misaligned bf16", base[1:].view(3, 104))):
        before = rmsnorm_cuda.launches
        try:
            rmsnorm_cuda.rmsnorm_fwd(x, torch.ones(x.shape[1], device="cuda"))
        except ValueError as e:
            print(f"check rmsnorm refuses {label}: {e}")
        else:
            raise AssertionError(f"rmsnorm accepted {label}")
        if rmsnorm_cuda.launches != before:
            raise AssertionError(f"rmsnorm counted a launch for {label}")
    def record(rows, rstd, what, d=4096):
        """Times at one shape, bf16, d 4096 unless ``d`` (rstd: the
        training forward)."""
        x = _randn((rows, d), gen, torch.bfloat16)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        w16 = scale.to(torch.bfloat16)
        nbytes = rows * d * 2 * 2 + d * 4 + (rows * 4 if rstd else 0)
        return {
            "ms": _time_ms(lambda: rmsnorm_cuda.rmsnorm_fwd(
                x, scale, save_residuals=rstd), flush),
            "plain_ms": _time_ms(lambda: ref.rmsnorm_ref(
                x, scale, save_residuals=rstd), flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": _time_ms(lambda: F.rms_norm(x, (d,), w16, 1e-6),
                                   flush),
            "shape": f"x ({rows}, {d}) bf16{', with rstd' if rstd else ''}"
                     f" ({what})"}

    # the prefill shape of Yi-6B (4 slots x 128-token chunk) heads the
    # record; the training forward (4 x 1024 tokens, with rstd) and the
    # decode step (4 slots) beside it
    return {
        "name": "rmsnorm_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:43",
        "max_abs_err": max(errs),
        **record(512, False, "prefill"),
        "train_shape": record(4096, True, "train"),
        "decode_shape": record(4, False, "decode"),
        "width_2048_shape": record(4096, True, "zamba2 / xlstm train", 2048),
        **{f"tp{tp}_shape": record(rows, True, f"train, sequence-parallel "
                                               f"rows at tp {tp}")
           for tp, rows in zip(TP_DEGREES, SP_ROWS)},
        "width_2048_tp2_shape": record(
            ZAMBA2_SP_ROWS, True, "zamba2 / xlstm train, sequence-parallel "
            "rows at tp 2", 2048),
        "decode32k_shape": record(YI_DECODE["batch"], False,
                                  "phase 13b: Yi-6B decode_32k step, batch "
                                  f"{YI_DECODE['batch']}"),
        "long500k_shape": record(ZAMBA2_LONG["batch"], False,
                                 "phase 13c: zamba2-1.2b long_500k step, "
                                 "batch 1", 2048),
    }


# the decode kernel's splits forced through the wrapper: one split (every
# tile in one block), two, and split_plan's (None)
DECODE_SPLITS = (1, 2, None)


def _check_decode_splits(label, q, k, v, kpos, pos, ks=None, vs=None):
    """Kernel 6 (normalised) at each of DECODE_SPLITS against the plain
    decode and against the plain model of its split-and-skip algorithm
    (ref.decode_split_ref) at the same split.  Returns the errors."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention_cuda as dec
    from repro_torch.kernels import ref
    b, length, hkv = k.shape[0], k.shape[1], k.shape[2]
    plain = (ref.decode_attention_quant_ref(q, k, v, ks, vs, kpos, pos)
             if ks is not None else ref.decode_attention_ref(q, k, v, kpos,
                                                             pos))
    errs = []
    for n in DECODE_SPLITS:
        n_used, per = (dec.split_plan(b, hkv, length, build.sm_count(0))
                       if n is None else dec.split_tiles(length, n))
        got = dec.decode_attention_fwd(q, k, v, kpos, pos, ks, vs, n_split=n)
        tag = f"{label} n_split={n_used}{' (plan)' if n is None else ''}"
        errs.append(_compare(f"{tag} vs plain", got, plain))
        errs.append(_compare(f"{tag} vs split model", got, ref.decode_split_ref(
            q, k, v, kpos, pos, ks, vs, tiles_per_split=per)))
    return errs


def check_decode(gen, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build, decode_attention_cuda, ref
    from repro_torch.models.attention import _cache_positions
    errs = []
    cases = [
        # Yi-6B: B=4 slots, 32 q heads over 4 kv heads, D=128, cache 1024
        (4, 32, 4, 128, 1024, torch.bfloat16, torch.bfloat16),
        (4, 32, 4, 128, 1024, torch.bfloat16, torch.float32),
        (4, 32, 4, 128, 1024, torch.float32, torch.float32),
        (4, 32, 4, 128, 1024, torch.float32, torch.bfloat16),
        (2, 8, 8, 64, 300, torch.float32, torch.float32),     # ragged tile
        (3, 16, 1, 64, 77, torch.bfloat16, torch.bfloat16),  # G=16
        # Granite-MoE's serving shape: 16 q over 8 kv heads (G = 2), D = 64
        (4, 16, 8, 64, 1024, torch.bfloat16, torch.bfloat16),
        (4, 16, 8, 64, 1024, torch.float32, torch.float32),
        # Llama-4-Scout's: 40 q over 8 kv heads (G = 5, no power of two)
        (4, 40, 8, 128, 1024, torch.bfloat16, torch.bfloat16),
        (4, 40, 8, 128, 1024, torch.float32, torch.float32),
        # zamba2's shared block: 32 q over 32 kv heads (G = 1), D = 64;
        # the token loop's single row; whisper's decoder (8 / 8, D = 64)
        # over a 448-row cache
        (4, 32, 32, 64, 1024, torch.bfloat16, torch.bfloat16),
        (4, 32, 32, 64, 1024, torch.float32, torch.float32),
        (1, 32, 32, 64, 1024, torch.bfloat16, torch.bfloat16),
        (4, 8, 8, 64, 448, torch.bfloat16, torch.bfloat16),
        (4, 8, 8, 64, 448, torch.float32, torch.float32),
    ]
    for b, hq, hkv, d, length, qdt, kvdt in cases:
        q = _randn((b, hq, d), gen, qdt)
        k = _randn((b, length, hkv, d), gen, kvdt)
        v = _randn((b, length, hkv, d), gen, kvdt)
        # ragged per-slot depths: pos 0, mid, last slot, and a fully masked
        # row (an idle slot whose kpos is all -1)
        pos = torch.tensor([0, length // 3, length - 1, length // 2][:b],
                           device="cuda", dtype=torch.int32)
        kpos = _cache_positions(length, pos, None).to(torch.int32)
        if b >= 2:
            kpos[1] = -1
        kpos = kpos.contiguous()
        errs += _check_decode_splits(
            f"decode B={b} Hq={hq} Hkv={hkv} D={d} L={length} q={qdt} "
            f"kv={kvdt}", q, k, v, kpos, pos)
    # ring cache (sliding window): rotated slot order
    b, hq, hkv, d, length = 4, 32, 4, 128, 256
    q = _randn((b, hq, d), gen, torch.bfloat16)
    k = _randn((b, length, hkv, d), gen, torch.bfloat16)
    v = _randn((b, length, hkv, d), gen, torch.bfloat16)
    pos = torch.tensor([5, 300, 511, 1000], device="cuda", dtype=torch.int32)
    kpos = _cache_positions(length, pos, 256).to(torch.int32).contiguous()
    errs += _check_decode_splits("decode ring window=256", q, k, v, kpos, pos)
    # every slot's keys in the first 4 of 16 tiles: the plan's last splits
    # lie wholly past pos and visit no tile
    length = 1024
    k = _randn((b, length, hkv, d), gen, torch.bfloat16)
    v = _randn((b, length, hkv, d), gen, torch.bfloat16)
    pos = torch.tensor([5, 60, 130, 200], device="cuda", dtype=torch.int32)
    kpos = _cache_positions(length, pos, None).to(torch.int32).contiguous()
    errs += _check_decode_splits("decode splits past pos", q, k, v, kpos,
                                 pos)

    # timed at the serving shape: bf16 cache, ragged depths
    b, hq, hkv, d, length = 4, 32, 4, 128, 1024
    q = _randn((b, hq, d), gen, torch.bfloat16)
    k = _randn((b, length, hkv, d), gen, torch.bfloat16)
    v = _randn((b, length, hkv, d), gen, torch.bfloat16)
    pos = torch.tensor([100, 400, 700, 1000], device="cuda",
                       dtype=torch.int32)
    kpos = _cache_positions(length, pos, None).to(torch.int32).contiguous()
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    qt = q[:, :, None]                                   # (B, Hq, 1, D)
    kt = k.transpose(1, 2).contiguous()                  # (B, Hkv, L, D)
    vt = v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    # least bytes: K and V of the valid cache rows only (a slot reads
    # nothing from rows its kpos marks invalid), q in, out, kpos and pos
    valid_rows = int(valid.sum())
    nbytes = (2 * valid_rows * hkv * d * 2 + 2 * q.numel() * 2
              + kpos.numel() * 4 + b * 4)
    n_split = decode_attention_cuda.split_plan(
        b, hkv, length, build.sm_count(0))
    # the same call with its key range forced into 1 to 16 splits, beside
    # the plan's: what the split buys
    split_ms = {n: _time_ms(lambda: decode_attention_cuda.decode_attention_fwd(
        q, k, v, kpos, pos, n_split=n), flush) for n in (1, 2, 4, 8, 16)}
    # the f32 arm (f32 q over an f32 cache: the reduced f32 model's path)
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_bytes = (2 * valid_rows * hkv * d * 4 + 2 * qf.numel() * 4
                 + kpos.numel() * 4 + b * 4)
    f32_shape = {
        "ms": _time_ms(lambda: decode_attention_cuda.decode_attention_fwd(
            qf, kf, vf, kpos, pos), flush),
        "plain_ms": _time_ms(lambda: ref.decode_attention_ref(
            qf, kf, vf, kpos, pos), flush),
        "bound_ms": f32_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt.float(), kt.float(), vt.float(), attn_mask=mask,
            enable_gqa=True), flush),
        "shape": f"q ({b}, {hq}, {d}) f32, cache ({b}, {length}, {hkv}, "
                 f"{d}) f32, pos {pos.tolist()}, valid rows {valid_rows}"}
    return {
        "name": "decode_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:171",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: decode_attention_cuda.decode_attention_fwd(
            q, k, v, kpos, pos), flush),
        "plain_ms": _time_ms(lambda: ref.decode_attention_ref(
            q, k, v, kpos, pos), flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
        "shape": f"q ({b}, {hq}, {d}) bf16, cache ({b}, {length}, {hkv}, "
                 f"{d}) bf16, pos {pos.tolist()}, valid rows {valid_rows}, "
                 f"(n_split, tiles a split) {n_split}",
        "split_ms": split_ms, "f32_shape": f32_shape,
        "granite_shape": _decode_shape_record(gen, flush, "Granite-MoE",
                                              16, 8, 64),
        "scout_shape": _decode_shape_record(gen, flush, "Llama-4-Scout",
                                            40, 8, 128),
        "zamba2_shape": _decode_shape_record(gen, flush, "Zamba2 shared",
                                             32, 32, 64),
        "whisper_shape": _decode_shape_record(gen, flush, "Whisper decoder",
                                              8, 8, 64, length=448,
                                              pos=(40, 100, 250, 440)),
        **{key: _decode_shape_record(gen, flush, model, hq, hkv, d, b=b,
                                     length=length, pos=pos, check=True)
           for key, model, hq, hkv, d, b, length, pos in LONG_DECODES},
    }


# phase 13's unsharded decodes (kernel 6 over a whole cache): Yi-6B at
# decode_32k (batch 8, ragged depths) and zamba2's shared block at
# long_500k (batch 1, 524288 rows: 2^30 elements a leaf)
LONG_DECODES = (
    ("decode32k_shape", "phase 13b: Yi-6B decode_32k", 32, 4, 128, 8, 32768,
     tuple(32768 - 17 - 37 * i for i in range(8))),
    ("long500k_shape", "phase 13c: zamba2 shared block, long_500k", 32, 32,
     64, 1, 524288, (524283,)))


def _decode_shape_record(gen, flush, model, hq, hkv, d, b=4, length=1024,
                         pos=(100, 400, 700, 1000), check=False):
    """Kernel 6's bf16 arm timed at a model's serving shape (4 slots, a
    bf16 cache of ``length`` rows, ragged depths ``pos``), beside its plain
    version, its least bytes and masked SDPA with ``enable_gqa``; with
    ``check`` first held to the plain version (the split plan's count of
    splits printed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention_cuda, ref
    from repro_torch.models.attention import _cache_positions
    q = _randn((b, hq, d), gen, torch.bfloat16)
    k = _randn((b, length, hkv, d), gen, torch.bfloat16)
    v = _randn((b, length, hkv, d), gen, torch.bfloat16)
    pos = torch.tensor(pos[:b], device="cuda", dtype=torch.int32)
    kpos = _cache_positions(length, pos, None).to(torch.int32).contiguous()
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    valid_rows = int(valid.sum())
    nbytes = (2 * valid_rows * hkv * d * 2 + 2 * q.numel() * 2
              + kpos.numel() * 4 + b * 4)
    if check:
        plan = decode_attention_cuda.split_plan(
            b, hkv, length, _sm_count())
        _compare(f"decode {model} L={length} (n_split, tiles a split) "
                 f"{plan}", decode_attention_cuda.decode_attention_fwd(
                     q, k, v, kpos, pos),
                 ref.decode_attention_ref(q, k, v, kpos, pos))
    qt = q[:, :, None]
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    return {
        "ms": _time_ms(lambda: decode_attention_cuda.decode_attention_fwd(
            q, k, v, kpos, pos), flush),
        "plain_ms": _time_ms(lambda: ref.decode_attention_ref(
            q, k, v, kpos, pos), flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=valid[:, None, None, :], enable_gqa=True),
            flush),
        "shape": f"{model}: q ({b}, {hq}, {d}) bf16, cache ({b}, {length}, "
                 f"{hkv}, {d}) bf16, G {hq // hkv}, pos {pos.tolist()}, "
                 f"valid rows {valid_rows}"}


def _sm_count():
    from repro_torch.kernels import build
    return build.sm_count(0)


def _append_inputs(gen, b, c, hq, hkv, d, pos0, dt, *, ring=None):
    """q/k/v/kpos as attend_prefill builds them: a linear prefix
    [0, pos0) + the chunk, or (ring=L) a rotated ring of L rows + chunk."""
    import torch

    from repro_torch.models.attention import _cache_positions
    pre = ring if ring is not None else pos0
    sk = pre + c
    q = _randn((b, c, hq, d), gen, dt)
    k = _randn((b, sk, hkv, d), gen, dt)
    v = _randn((b, sk, hkv, d), gen, dt)
    chunk_pos = pos0 + torch.arange(c, device="cuda")
    if ring is None:
        kpos = torch.arange(sk, device="cuda")
    else:
        kpos_pre = _cache_positions(
            ring, torch.tensor(pos0 - 1, device="cuda"), ring)
        kpos = torch.cat([kpos_pre, chunk_pos])
    kpos = kpos.to(torch.int32).expand(b, sk).contiguous()
    return q, k, v, kpos


def _append_arm(q, k):
    """The counter of the append arm these inputs take."""
    import torch
    bf = torch.bfloat16
    if k.dtype == torch.int8:
        return "int8_launches" if q.dtype == bf else "int8_f32_launches"
    return "launches" if q.dtype == bf and k.dtype == bf else "f32_launches"


def _append_record(gen, flush, dt, errs, model="Yi-6B", hq=32, hkv=4,
                   d=128):
    """Kernel 4's bf16 (tensor-core) or f32 (SIMT) arm timed at a model's
    serving shape (Yi-6B's unless given): the second prompt chunk of 4
    slots at pos0 = 512."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_append_cuda, ref
    b, c, pos0 = 4, 128, 512
    q, k, v, kpos = _append_inputs(gen, b, c, hq, hkv, d, pos0, dt)
    sk = k.shape[1]
    qpos = pos0 + torch.arange(c, device="cuda")
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[None, :, None])
    live_pairs = int(valid.sum())                    # over the batch
    width = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * width + kpos.numel() * 4
    flops = 4 * hq * d * live_pairs
    qt = q.transpose(1, 2).contiguous()              # (B, Hq, C, D)
    kt = k.transpose(1, 2).contiguous()              # (B, Hkv, Sk, D)
    vt = v.transpose(1, 2).contiguous()
    mask = valid[:, None]
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / (BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS) * 1e3
    bf16 = dt == torch.bfloat16
    return {
        "name": "flash_attention_append" + ("" if bf16 else "_f32"),
        "route": "cuda", "source": "src/repro_torch/csrc/flash_append.cu"
        + (" + src/repro_torch/csrc/flash_mma_fwd.cuh" if bf16 else ""),
        "replaces": "src/repro/kernels/flash_attention.py:264",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: flash_append_cuda.flash_attention_append(
            q, k, v, kpos, pos0=pos0, kpos_linear=True), flush),
        "plain_ms": _time_ms(lambda: ref.flash_attention_append_ref(
            q, k, v, kpos, pos0=pos0), flush),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
        "shape": f"{model}: q ({b}, {c}, {hq}, {d}) {dt}, k/v ({b}, {sk}, "
                 f"{hkv}, {d}) {dt}, pos0={pos0}, live pairs {live_pairs}, "
                 + ("tensor cores" if bf16 else "SIMT"),
    }


def check_append(gen, flush):
    """Both float arms of kernel 4: bf16 q over a bf16 stream on the tensor
    cores, held with the added ROUND_TOL * ref.append_round_scale (p is
    rounded to bf16 before P V, as the TPU kernel does), and f32 on the
    SIMT body at the f32 tolerance; each case must launch its own arm.
    Returns the records of the bf16 and the f32 arm."""
    import torch

    from repro_torch.kernels import flash_append_cuda, ref
    bf, f32 = torch.bfloat16, torch.float32
    errs = {bf: [], f32: []}
    # (label, b, c, hq, hkv, d, pos0, dtype, window, ring, linear, mask_row)
    cases = [
        ("Yi pos0=0", 4, 128, 32, 4, 128, 0, bf, None, None, True, False),
        ("Yi pos0=512", 4, 128, 32, 4, 128, 512, bf, None, None, True, False),
        ("Yi pos0=512 f32", 4, 128, 32, 4, 128, 512, f32, None, None, True,
         False),
        ("window=200 linear skip", 2, 128, 32, 4, 128, 512, bf, 200, None,
         True, False),
        ("window=200 linear skip f32", 2, 128, 32, 4, 128, 512, f32, 200,
         None, True, False),
        ("ring L=256 window=256", 2, 128, 32, 4, 128, 384, bf, 256, 256,
         False, False),
        ("ring L=256 window=256 f32", 2, 128, 32, 4, 128, 384, f32, 256, 256,
         False, False),
        ("fully masked row", 2, 128, 8, 4, 128, 128, f32, None, None, False,
         True),
        ("fully masked row bf16", 2, 128, 8, 4, 128, 128, bf, None, None,
         False, True),
        ("ragged C=100 pos0=37 D=64", 3, 100, 8, 2, 64, 37, f32, None, None,
         True, False),
        ("ragged C=100 pos0=37 D=64 bf16", 3, 100, 8, 2, 64, 37, bf, None,
         None, True, False),
        # at most 16 keys a query: a key dropped or added moves an output
        # far beyond ROUND_TOL of its sum over |terms|
        ("window=16", 2, 128, 32, 4, 128, 512, bf, 16, None, True, False),
        # Granite-MoE's prefill chunks: 16 q over 8 kv heads (G = 2), D = 64
        ("Granite pos0=0", 4, 128, 16, 8, 64, 0, bf, None, None, True,
         False),
        ("Granite pos0=512", 4, 128, 16, 8, 64, 512, bf, None, None, True,
         False),
        ("Granite pos0=512 f32", 4, 128, 16, 8, 64, 512, f32, None, None,
         True, False),
        # Llama-4-Scout's: 40 q over 8 kv heads (G = 5), D = 128; its
        # attn_local layers a ring of 1024 rows under the 8192-key window
        ("Scout pos0=512", 4, 128, 40, 8, 128, 512, bf, None, None, True,
         False),
        ("Scout pos0=512 f32", 4, 128, 40, 8, 128, 512, f32, None, None,
         True, False),
        ("Scout ring L=1024 window=8192", 4, 128, 40, 8, 128, 896, bf,
         8192, 1024, False, False),
        ("Scout ring L=1024 window=8192 f32", 4, 128, 40, 8, 128, 896, f32,
         8192, 1024, False, False),
    ]
    for label, b, c, hq, hkv, d, pos0, dt, window, ring, linear, mrow in cases:
        q, k, v, kpos = _append_inputs(gen, b, c, hq, hkv, d, pos0, dt,
                                       ring=ring)
        if mrow:
            kpos[1] = -1
        arm = _append_arm(q, k)
        before = getattr(flash_append_cuda, arm)
        got = flash_append_cuda.flash_attention_append(
            q, k, v, kpos, pos0=pos0, window=window, kpos_linear=linear)
        if getattr(flash_append_cuda, arm) != before + 1:
            raise AssertionError(f"append {label}: arm {arm} not launched")
        round_abs = None
        if dt == bf:
            round_abs = ref.append_round_scale(q, k, v, kpos, pos0=pos0,
                                               window=window)
        errs[dt].append(_compare(
            f"append {label} B={b} C={c} Sk={k.shape[1]} Hq={hq} Hkv={hkv} "
            f"D={d} {dt} ({arm})", got,
            ref.flash_attention_append_ref(q, k, v, kpos, pos0=pos0,
                                           window=window),
            round_abs=round_abs))
    bf16_rec = _append_record(gen, flush, bf, errs[bf])
    bf16_rec["granite_shape"] = _append_record(
        gen, flush, bf, errs[bf], "Granite-MoE", 16, 8, 64)
    bf16_rec["scout_shape"] = _append_record(
        gen, flush, bf, errs[bf], "Llama-4-Scout", 40, 8, 128)
    return [bf16_rec, _append_record(gen, flush, f32, errs[f32])]


# int8 arms and kernel 7: no single PyTorch call attends over an int8 cache
# with per-row scales, and none returns the unnormalised (acc, m, l)
NO_INT8_LIBRARY = ("none: no PyTorch call attends over int8 K/V with "
                   "per-(row, kv head) scales")
NO_PARTIALS_LIBRARY = ("none: no PyTorch call returns the unnormalised "
                       "flash-decoding state (acc, m, l)")
# kernel 7 held to its plain version at phase 13's slice lengths: Yi-6B's
# decode_32k cache on one rank (batch 8) and zamba2's long_500k cache over
# 4 sequence shards (batch 1, 131072 rows); one row fully masked
LONG_SLICES = ((8, 32, 4, 128, 32768,
                [32767 - 37 * i if i != 3 else -1 for i in range(8)]),
               (1, 32, 32, 64, 131072, [131071]))
# and timed there, and at zamba2's whole long_500k cache on one rank
LONG_PARTIALS = (
    ("decode32k_shape", 8, 32, 4, 128, 32768,
     [32767 - 37 * i for i in range(8)]),
    ("long131k_shape", 1, 32, 32, 64, 131072, [131071]),
    ("long500k_shape", 1, 32, 32, 64, 524288, [524287]))


def _decode_cache(gen, b, hq, hkv, d, length, qdt, kvdt, pos, *, ring=None,
                  masked_row=None):
    """q, caches and per-slot kpos/pos as attend_decode builds them; kvdt
    int8 gives quantised caches with their scales (else scales None)."""
    import torch

    from repro_torch.kernels import kv_quant
    from repro_torch.models.attention import _cache_positions
    q = _randn((b, hq, d), gen, qdt)
    k = _randn((b, length, hkv, d), gen, torch.float32)
    v = _randn((b, length, hkv, d), gen, torch.float32)
    if kvdt == torch.int8:
        (k, ks), (v, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
    else:
        k, v, ks, vs = k.to(kvdt), v.to(kvdt), None, None
    pos = torch.tensor(pos[:b], device="cuda", dtype=torch.int32)
    kpos = _cache_positions(length, pos, ring).to(torch.int32)
    if masked_row is not None and b > masked_row:
        kpos[masked_row] = -1
    return q, k, v, ks, vs, kpos.contiguous(), pos


def _decode_bytes(q, k, ks, kpos, valid_rows, out_bytes):
    """Least bytes of one decode call: K and V (and their scales) of the
    valid cache rows only, q in, the outputs, kpos and pos."""
    hkv, d = k.shape[2], k.shape[3]
    nbytes = 2 * valid_rows * hkv * d * k.element_size()
    if ks is not None:
        nbytes += 2 * valid_rows * hkv * 4
    return (nbytes + q.numel() * q.element_size() + out_bytes
            + kpos.numel() * 4 + q.shape[0] * 4)


def check_decode_int8(gen, flush):
    """Kernel 6's int8 arm: caches int8 with (B, L, Hkv, 1) f32 scales."""
    import torch

    from repro_torch.kernels import decode_attention_cuda, ref
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    errs = []
    # (b, hq, hkv, d, length, q dtype, ring window)
    for b, hq, hkv, d, length, qdt, ring in (
            (4, 32, 4, 128, 1024, bf, None), (4, 32, 4, 128, 1024, f32, None),
            (2, 8, 8, 64, 300, f32, None),      # ragged tile
            (3, 16, 1, 64, 77, bf, None),       # G = 16
            (4, 32, 4, 128, 256, bf, 256)):     # ring
        pos = ([5, 300, 511, 1000] if ring else
               [0, length // 3, length - 1, length // 2])
        q, k, v, ks, vs, kpos, pos = _decode_cache(
            gen, b, hq, hkv, d, length, qdt, i8, pos, ring=ring,
            masked_row=None if ring else 1)
        errs += _check_decode_splits(
            f"decode int8 B={b} Hq={hq} Hkv={hkv} D={d} L={length} q={qdt}"
            f"{' ring' if ring else ''}", q, k, v, kpos, pos, ks, vs)

    b, hq, hkv, d, length = 4, 32, 4, 128, 1024
    q, k, v, ks, vs, kpos, pos = _decode_cache(
        gen, b, hq, hkv, d, length, bf, i8, [100, 400, 700, 1000])
    valid_rows = int(((kpos >= 0) & (kpos <= pos[:, None])).sum())
    nbytes = _decode_bytes(q, k, ks, kpos, valid_rows, q.numel() * 2)
    return {
        "name": "decode_attention_fwd_int8", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:171",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: decode_attention_cuda.decode_attention_fwd(
            q, k, v, kpos, pos, ks, vs), flush),
        "plain_ms": _time_ms(lambda: ref.decode_attention_quant_ref(
            q, k, v, ks, vs, kpos, pos), flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "library_note": NO_INT8_LIBRARY,
        "shape": f"q ({b}, {hq}, {d}) bf16, cache ({b}, {length}, {hkv}, "
                 f"{d}) int8 + scales, pos {pos.tolist()}, valid rows "
                 f"{valid_rows}",
    }


def check_append_int8(gen, flush):
    """Kernel 4's two int8 arms, the key stream int8 with (B, Sk, Hkv, 1)
    f32 scales as attend_prefill passes an int8 cache prefix + chunk: a
    bf16 q on the tensor cores (p times the v scales as bf16 hi + lo) and
    an f32 q on the SIMT body, both at the int8 tolerance (the output
    dtype's, no rounding term); each case must launch its own arm.
    Returns the records of the tensor-core and the SIMT arm."""
    import torch

    from repro_torch.kernels import flash_append_cuda, kv_quant, ref
    bf, f32 = torch.bfloat16, torch.float32
    errs = {bf: [], f32: []}
    cases = [
        ("Yi pos0=0", 4, 128, 32, 4, 128, 0, bf, None, None, True, False),
        ("Yi pos0=512", 4, 128, 32, 4, 128, 512, bf, None, None, True, False),
        ("Yi pos0=512 f32", 4, 128, 32, 4, 128, 512, f32, None, None, True,
         False),
        ("window=200 linear skip", 2, 128, 32, 4, 128, 512, bf, 200, None,
         True, False),
        ("ring L=256 window=256", 2, 128, 32, 4, 128, 384, bf, 256, 256,
         False, False),
        ("fully masked row", 2, 128, 8, 4, 128, 128, f32, None, None, False,
         True),
        ("ragged C=100 pos0=37 D=64", 3, 100, 8, 2, 64, 37, f32, None, None,
         True, False),
        ("fully masked row bf16", 2, 128, 8, 4, 128, 128, bf, None, None,
         False, True),
        ("ragged C=100 pos0=37 D=64 bf16", 3, 100, 8, 2, 64, 37, bf, None,
         None, True, False),
        # at most 16 keys a query: a key dropped or added, or p times the v
        # scale rounded once to bf16, moves outputs beyond the tolerance
        ("window=16", 2, 128, 32, 4, 128, 512, bf, 16, None, True, False),
    ]

    def inputs(b, c, hq, hkv, d, pos0, dt, ring):
        q, k, v, kpos = _append_inputs(gen, b, c, hq, hkv, d, pos0, dt,
                                       ring=ring)
        (k, ks), (v, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
        return q, k, v, ks, vs, kpos

    for label, b, c, hq, hkv, d, pos0, dt, window, ring, linear, mrow in cases:
        q, k, v, ks, vs, kpos = inputs(b, c, hq, hkv, d, pos0, dt, ring)
        if mrow:
            kpos[1] = -1
        arm = _append_arm(q, k)
        before = getattr(flash_append_cuda, arm)
        got = flash_append_cuda.flash_attention_append(
            q, k, v, kpos, pos0=pos0, window=window, kpos_linear=linear,
            k_scale=ks, v_scale=vs)
        if getattr(flash_append_cuda, arm) != before + 1:
            raise AssertionError(f"append int8 {label}: arm {arm} not "
                                 "launched")
        errs[dt].append(_compare(
            f"append int8 {label} B={b} C={c} Sk={k.shape[1]} Hq={hq} "
            f"Hkv={hkv} D={d} {dt} ({arm})", got,
            ref.flash_attention_append_quant_ref(q, k, v, ks, vs, kpos,
                                                 pos0=pos0, window=window)))

    def record(dt):
        b, c, hq, hkv, d, pos0 = 4, 128, 32, 4, 128, 512
        q, k, v, ks, vs, kpos = inputs(b, c, hq, hkv, d, pos0, dt, None)
        sk = k.shape[1]
        qpos = pos0 + torch.arange(c, device="cuda")
        valid = (kpos[:, None, :] >= 0) & \
            (kpos[:, None, :] <= qpos[None, :, None])
        live_pairs = int(valid.sum())
        # q in and out, K and V one byte an element, a scale per row
        nbytes = (2 * q.numel() * q.element_size() + 2 * k.numel()
                  + 2 * ks.numel() * 4 + kpos.numel() * 4)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = 4 * hq * d * live_pairs / (
            BF16_FLOPS if dt == bf else F32_FLOPS) * 1e3
        return {
            "name": "flash_attention_append_int8" + (
                "" if dt == bf else "_f32"), "route": "cuda",
            "source": "src/repro_torch/csrc/flash_append.cu" + (
                " + src/repro_torch/csrc/flash_mma_fwd.cuh" if dt == bf
                else ""),
            "replaces": "src/repro/kernels/flash_attention.py:264",
            "max_abs_err": max(errs[dt]),
            "ms": _time_ms(lambda: flash_append_cuda.flash_attention_append(
                q, k, v, kpos, pos0=pos0, kpos_linear=True, k_scale=ks,
                v_scale=vs), flush),
            "plain_ms": _time_ms(
                lambda: ref.flash_attention_append_quant_ref(
                    q, k, v, ks, vs, kpos, pos0=pos0), flush),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": None, "library_note": NO_INT8_LIBRARY,
            "shape": f"q ({b}, {c}, {hq}, {d}) {dt}, k/v ({b}, {sk}, {hkv}, "
                     f"{d}) int8 + scales, pos0={pos0}, live pairs "
                     f"{live_pairs}, "
                     + ("tensor cores" if dt == bf else "SIMT"),
        }

    return [record(bf), record(f32)]


# the verify shape: 4 slots of Yi-6B at ragged depths in a 1024-row cache,
# each scoring a draft chunk of K rows at re-based positions (shift 1024)
VERIFY_POS = (17, 300, 640, 1019)
VERIFY_LEN = 1024


def _verify_inputs(gen, kq, qdt, kvdt):
    """q, the key stream (the cache, rows at or past each slot's pos masked,
    then the chunk's own K/V; int8 with its scales) and the absolute kpos,
    as ``attend_verify`` builds them; pos (B,) on the card."""
    import torch

    from repro_torch.kernels import kv_quant
    b, hq, hkv, d, length = 4, 32, 4, 128, VERIFY_LEN
    pos = torch.tensor(VERIFY_POS, dtype=torch.int32, device="cuda")
    q = _randn((b, kq, hq, d), gen, qdt)
    k = _randn((b, length + kq, hkv, d), gen, torch.float32)
    v = _randn((b, length + kq, hkv, d), gen, torch.float32)
    ks = vs = None
    if kvdt == torch.int8:
        (k, ks), (v, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
    else:
        k, v = k.to(kvdt), v.to(kvdt)
    idx = torch.arange(length, device="cuda", dtype=torch.int32)
    kpos = torch.cat([torch.where(idx[None] < pos[:, None], idx, -1),
                      pos[:, None] + torch.arange(kq, device="cuda",
                                                  dtype=torch.int32)], 1)
    return q, k, v, ks, vs, kpos, pos


def _rebased(kpos, pos):
    """The kpos the verify arm hands kernel 4: row j shifted by
    VERIFY_LEN - pos[j], -1 kept."""
    import torch
    return torch.where(kpos >= 0, kpos - pos[:, None] + VERIFY_LEN,
                       -1).to(torch.int32).contiguous()


def _verify_plain(q, k, v, ks, vs, kpos):
    from repro_torch.kernels import ref
    if ks is not None:
        return ref.flash_attention_append_quant_ref(q, k, v, ks, vs, kpos,
                                                    pos0=VERIFY_LEN)
    return ref.flash_attention_append_ref(q, k, v, kpos, pos0=VERIFY_LEN)


def _verify_record(gen, flush, kq, qdt, kvdt, errs):
    """Kernel 4 timed at the verify shape (kpos_linear=False: every tile of
    the 1024 + K keys visited) beside its bound (the valid key rows read
    once, q in and out; the live pairs' products) and masked SDPA with
    ``enable_gqa`` (none for an int8 stream)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_append_cuda
    q, k, v, ks, vs, kpos, pos = _verify_inputs(gen, kq, qdt, kvdt)
    kp = _rebased(kpos, pos)
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    qpos = VERIFY_LEN + torch.arange(kq, device="cuda")
    valid = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qpos[None, :, None])
    live_pairs = int(valid.sum())
    valid_rows = int((kp >= 0).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * valid_rows * hkv * d * k.element_size()
              + (2 * valid_rows * hkv * 4 if ks is not None else 0)
              + kp.numel() * 4)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * hq * d * live_pairs / (
        BF16_FLOPS if qdt == torch.bfloat16 else F32_FLOPS) * 1e3
    rec = {
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: flash_append_cuda.flash_attention_append(
            q, k, v, kp, pos0=VERIFY_LEN, kpos_linear=False, k_scale=ks,
            v_scale=vs), flush),
        "plain_ms": _time_ms(lambda: _verify_plain(q, k, v, ks, vs, kp),
                             flush),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": None,
        "shape": f"verify q ({b}, {kq}, {hq}, {d}) {qdt}, stream ({b}, "
                 f"{k.shape[1]}, {hkv}, {d}) {kvdt}, pos {list(VERIFY_POS)}"
                 f", shift {VERIFY_LEN}, kpos_linear=False, live pairs "
                 f"{live_pairs}",
    }
    if ks is None:
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).contiguous()
        vt = v.transpose(1, 2).contiguous()
        rec["library_ms"] = _time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=valid[:, None], enable_gqa=True),
            flush)
    else:
        rec["library_note"] = NO_INT8_LIBRARY
    return rec


def check_verify(gen, flush):
    """Kernel 4 at the speculative verify shape (B = 4, K in {4, 6}, 32 q
    over 4 kv heads, D = 128, a 1024-row cache at ragged pos
    {17, 300, 640, 1019}, re-based to shift 1024): each of its four arms
    (bf16, f32, int8 under a bf16 q, int8 under an f32 q) through
    ``dispatch.flash_attention_verify``, each call checked to launch its
    own arm, against the plain append at the re-based positions; then the
    paged verify (a bf16 pool of 128-row pages behind a permuted table,
    pages past each slot's pos mapped and holding garbage) against the
    plain gather-and-append.  Tolerances as ``check_append``'s.  Returns
    kernel 4's timings at the verify shape, {record name: {key: sub}}."""
    import torch

    from repro_torch.kernels import dispatch, flash_append_cuda, ref
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    arms = (("bf16", bf, bf), ("f32", f32, f32), ("int8 bf16 q", bf, i8),
            ("int8 f32 q", f32, i8))
    errs = {}
    for kq in (4, 6):
        for label, qdt, kvdt in arms:
            q, k, v, ks, vs, kpos, pos = _verify_inputs(gen, kq, qdt, kvdt)
            arm = _append_arm(q, k)
            before = getattr(flash_append_cuda, arm)
            got = dispatch.flash_attention_verify(
                q, k, v, kpos, pos=pos, shift=VERIFY_LEN, k_scale=ks,
                v_scale=vs)
            if getattr(flash_append_cuda, arm) != before + 1:
                raise AssertionError(f"verify {label} K={kq}: arm {arm} not "
                                     "launched")
            kp = _rebased(kpos, pos)
            round_abs = None
            if qdt == bf and kvdt == bf:
                round_abs = ref.append_round_scale(q, k, v, kp,
                                                   pos0=VERIFY_LEN)
            errs.setdefault((kq, label), []).append(_compare(
                f"verify {label} B=4 K={kq} Sk={k.shape[1]} pos "
                f"{list(VERIFY_POS)} shift={VERIFY_LEN} ({arm})", got,
                _verify_plain(q, k, v, ks, vs, kp), round_abs=round_abs))
    # the paged arm: a bf16 pool, 8 pages a slot, every page mapped
    b, hq, hkv, d, ps, m = 4, 32, 4, 128, 128, VERIFY_LEN // 128
    kq = 4
    pos = torch.tensor(VERIFY_POS, dtype=torch.int32, device="cuda")
    kp_pool = _randn((b * m + 1, ps, hkv, d), gen, bf)
    vp_pool = _randn((b * m + 1, ps, hkv, d), gen, bf)
    pt = (1 + torch.randperm(b * m, generator=gen, device="cuda")).reshape(
        b, m).to(torch.int32)
    q = _randn((b, kq, hq, d), gen, bf)
    kc = _randn((b, kq, hkv, d), gen, bf)
    vc = _randn((b, kq, hkv, d), gen, bf)
    before = flash_append_cuda.launches
    got = dispatch.flash_attention_verify_paged(q, kp_pool, vp_pool, pt, kc,
                                                vc, pos=pos,
                                                length=VERIFY_LEN)
    if flash_append_cuda.launches != before + 1:
        raise AssertionError("verify paged: flash_append not launched")
    stream_k = torch.cat([ref.paged_view(kp_pool, pt, VERIFY_LEN), kc], 1)
    stream_v = torch.cat([ref.paged_view(vp_pool, pt, VERIFY_LEN), vc], 1)
    kp = _rebased(ref.verify_paged_kpos(pt, ps, pos, VERIFY_LEN, kq), pos)
    errs[(kq, "bf16")].append(_compare(
        f"verify paged B=4 K={kq} pages {m} x {ps} pos {list(VERIFY_POS)} "
        "bf16 (launches)", got,
        ref.flash_attention_append_ref(q, stream_k, stream_v, kp,
                                       pos0=VERIFY_LEN),
        round_abs=ref.append_round_scale(q, stream_k, stream_v, kp,
                                         pos0=VERIFY_LEN)))
    return {
        "flash_attention_append": {
            "verify_shape": _verify_record(gen, flush, 4, bf, bf,
                                           errs[(4, "bf16")]),
            "verify_k6_shape": _verify_record(gen, flush, 6, bf, bf,
                                              errs[(6, "bf16")])},
        "flash_attention_append_f32": {
            "verify_shape": _verify_record(gen, flush, 4, f32, f32,
                                           errs[(4, "f32")])},
        "flash_attention_append_int8": {
            "verify_shape": _verify_record(gen, flush, 4, bf, i8,
                                           errs[(4, "int8 bf16 q")])},
        "flash_attention_append_int8_f32": {
            "verify_shape": _verify_record(gen, flush, 4, f32, i8,
                                           errs[(4, "int8 f32 q")])},
    }


def check_partials(gen, flush):
    """Kernel 7 over 1, 2 and 4 slices of the cache, each slice against the
    plain partials (acc, m, l in f32), the slices combined with
    ref.combine_partials against kernel 6 on the whole cache and against
    the plain decode; bf16 and int8 caches.  Rows: pos 100 (slices past it
    fully masked), an all-masked row, the last slot, 700; and a ragged
    shape (L = 300, slices of 150 and 75 rows, ragged key tiles).  Each
    slice at each of DECODE_SPLITS (one split, two, the plan).  The
    acc check carries the long-sum slack (SUM_ABS_TOL), loose enough to
    pass a sum kept in lower precision; the combined outputs do not: an
    f32 q over an f32 cache at L = 1024 holds the combine of 1, 2 and 4
    slices to 1e-5, which such a sum would miss.  Returns the records of
    the float arm (bf16 and f32 caches) and the int8 arm."""
    import torch

    from repro_torch.kernels import decode_attention_cuda, ref
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    errs = {bf: [], f32: [], i8: []}
    for kvdt in (bf, f32, i8):
        for b, hq, hkv, d, length, qdt, rows in (
                (4, 32, 4, 128, 1024, f32 if kvdt == f32 else bf,
                 [100, 400, 1023, 700]),
                (2, 8, 2, 64, 300, f32, [100, 250])):
            q, k, v, ks, vs, kpos, pos = _decode_cache(
                gen, b, hq, hkv, d, length, qdt, kvdt, rows, masked_row=1)
            whole = decode_attention_cuda.decode_attention_fwd(
                q, k, v, kpos, pos, ks, vs)
            plain = (ref.decode_attention_quant_ref(q, k, v, ks, vs, kpos,
                                                    pos) if ks is not None
                     else ref.decode_attention_ref(q, k, v, kpos, pos))
            for n in (1, 2, 4):
                step = length // n
                parts = []
                for i in range(n):
                    s = slice(i * step, (i + 1) * step)
                    sl = [None if t is None else t[:, s].contiguous()
                          for t in (k, v, ks, vs, kpos)]
                    want = ref.decode_attention_partials_ref(
                        q, sl[0], sl[1], sl[4], pos, sl[2], sl[3])
                    # acc is a sum over up to L keys (all of them, at
                    # weight 1, in a fully masked slice): its terms' sum
                    # over |v| scales its f32 summation-order error
                    acc_abs = ref.decode_attention_partials_ref(
                        q, sl[0], sl[1].abs(), sl[4], pos, sl[2], sl[3])[0]
                    for ns in DECODE_SPLITS:    # the plan (None) last
                        got = decode_attention_cuda.decode_attention_partials(
                            q, sl[0], sl[1], sl[4], pos, sl[2], sl[3],
                            n_split=ns)
                        for name, g_, w_, a_ in zip(
                                ("acc", "m", "l"), got, want,
                                (acc_abs, None, None)):
                            errs[kvdt].append(_compare(
                                f"partials {kvdt} B={b} L={length} slice "
                                f"{i}/{n} n_split={ns or 'plan'} {name}", g_,
                                w_, sum_abs=a_))
                    parts.append(got)
                o = ref.combine_partials(parts).to(q.dtype)
                label = f"partials {kvdt} B={b} L={length} {n} slices combined"
                errs[kvdt].append(_compare(label + " vs decode kernel", o,
                                           whole))
                errs[kvdt].append(_compare(label + " vs plain", o, plain))

    # phase 13's slices: Yi-6B's decode_32k cache whole on one rank
    # (32768 rows, batch 8) and zamba2's long_500k cache over 4 sequence
    # shards (131072 rows, batch 1), each at the three splits
    for b, hq, hkv, d, length, rows in LONG_SLICES:
        q, k, v, ks, vs, kpos, pos = _decode_cache(
            gen, b, hq, hkv, d, length, bf, bf, rows)
        want = ref.decode_attention_partials_ref(q, k, v, kpos, pos)
        acc_abs = ref.decode_attention_partials_ref(q, k, v.abs(), kpos,
                                                    pos)[0]
        plan = decode_attention_cuda.split_plan(b, hkv, length,
                                                _sm_count())
        for ns in DECODE_SPLITS:
            got = decode_attention_cuda.decode_attention_partials(
                q, k, v, kpos, pos, n_split=ns)
            # l is a sum of positive terms: its own sum over |terms|
            for name, g_, w_, a_ in zip(("acc", "m", "l"), got, want,
                                        (acc_abs, None, want[2])):
                errs[bf].append(_compare(
                    f"partials long slice B={b} L={length} "
                    f"n_split={ns or f'plan {plan}'} {name}", g_, w_,
                    sum_abs=a_))
        del q, k, v, want, acc_abs

    records = []
    b, hq, hkv, d, length = 4, 32, 4, 128, 1024
    for kvdt, suffix in ((bf, ""), (i8, "_int8")):
        q, k, v, ks, vs, kpos, pos = _decode_cache(
            gen, b, hq, hkv, d, length, bf, kvdt, [100, 400, 700, 1000])
        valid_rows = int(((kpos >= 0) & (kpos <= pos[:, None])).sum())
        # outputs: acc (B, Hkv, G, D), m and l (B, Hkv, G), f32
        nbytes = _decode_bytes(q, k, ks, kpos, valid_rows,
                               b * hq * (d + 2) * 4)
        records.append({
            "name": "decode_attention_partials" + suffix, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:188",
            "max_abs_err": max(errs[kvdt] + (errs[f32] if kvdt == bf
                                             else [])),
            "ms": _time_ms(lambda: decode_attention_cuda
                           .decode_attention_partials(q, k, v, kpos, pos, ks,
                                                      vs), flush),
            "plain_ms": _time_ms(lambda: ref.decode_attention_partials_ref(
                q, k, v, kpos, pos, ks, vs), flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "library_note": NO_PARTIALS_LIBRARY + (
                "; " + NO_INT8_LIBRARY if ks is not None else ""),
            "shape": f"q ({b}, {hq}, {d}) bf16, one slice: cache ({b}, "
                     f"{length}, {hkv}, {d}) "
                     f"{'int8 + scales' if ks is not None else 'bf16'}, "
                     f"pos {pos.tolist()}, valid rows {valid_rows}",
        })
    # the float record's f32 arm (f32 q over an f32 cache)
    q, k, v, _, _, kpos, pos = _decode_cache(
        gen, b, hq, hkv, d, length, f32, f32, [100, 400, 700, 1000])
    valid_rows = int(((kpos >= 0) & (kpos <= pos[:, None])).sum())
    nbytes = _decode_bytes(q, k, None, kpos, valid_rows, b * hq * (d + 2) * 4)
    records[0]["f32_shape"] = {
        "ms": _time_ms(lambda: decode_attention_cuda
                       .decode_attention_partials(q, k, v, kpos, pos), flush),
        "plain_ms": _time_ms(lambda: ref.decode_attention_partials_ref(
            q, k, v, kpos, pos), flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "library_note": NO_PARTIALS_LIBRARY,
        "shape": f"q ({b}, {hq}, {d}) f32, one slice: cache ({b}, {length}, "
                 f"{hkv}, {d}) f32, pos {pos.tolist()}, valid rows "
                 f"{valid_rows}"}
    for key, b, hq, hkv, d, length, rows in LONG_PARTIALS:
        q, k, v, _, _, kpos, pos = _decode_cache(
            gen, b, hq, hkv, d, length, bf, bf, rows)
        valid_rows = int(((kpos >= 0) & (kpos <= pos[:, None])).sum())
        nbytes = _decode_bytes(q, k, None, kpos, valid_rows,
                               b * hq * (d + 2) * 4)
        plan = decode_attention_cuda.split_plan(b, hkv, length, _sm_count())
        records[0][key] = {
            "ms": _time_ms(lambda: decode_attention_cuda
                           .decode_attention_partials(q, k, v, kpos, pos),
                           flush),
            "plain_ms": _time_ms(lambda: ref.decode_attention_partials_ref(
                q, k, v, kpos, pos), flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "library_note": NO_PARTIALS_LIBRARY,
            "shape": f"phase 13 slice: q ({b}, {hq}, {d}) bf16, cache ({b}, "
                     f"{length}, {hkv}, {d}) bf16, valid rows {valid_rows}, "
                     f"(n_split, tiles a split) {plan}"}
        del q, k, v
    return records


def check_rmsnorm_bwd(gen, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, rmsnorm_cuda
    errs = []
    for rows, d, dt in ((4096, 4096, torch.bfloat16),
                        (4096, 4096, torch.float32),
                        (4099, 4096, torch.bfloat16), (7, 104, torch.float32),
                        (1, 256, torch.bfloat16),
                        # zamba2's and xlstm's d_model (ln1, the shared
                        # block's norms, the sLSTM norm) at their train
                        # shape, and a single row
                        (4096, 2048, torch.bfloat16),
                        (1, 2048, torch.bfloat16),
                        # Yi-6B's sequence-parallel rows at tp 2 and 4,
                        # zamba2's and xlstm's at tp 2
                        *((r, 4096, torch.bfloat16) for r in SP_ROWS),
                        (ZAMBA2_SP_ROWS, 2048, torch.bfloat16)):
        x = _randn((rows, d), gen, dt)
        dy = _randn((rows, d), gen, dt)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        _, rstd = ref.rmsnorm_ref(x, scale, save_residuals=True)
        dx, dscale = rmsnorm_cuda.rmsnorm_bwd(x, scale, rstd, dy)
        want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, rstd, dy)
        label = f"rmsnorm_bwd rows={rows} d={d} {dt}"
        errs.append(_compare(label + " dx", dx, want_dx))
        terms = (dy.float() * x.float() * rstd[:, None]).abs().sum(0)
        errs.append(_compare(label + " dscale", dscale, want_ds,
                             sum_abs=terms))

    def record(rows, what, d=4096):
        """Times at one shape, bf16."""
        x = _randn((rows, d), gen, torch.bfloat16)
        dy = _randn((rows, d), gen, torch.bfloat16)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        _, rstd = ref.rmsnorm_ref(x, scale, save_residuals=True)
        xl = x.clone().requires_grad_(True)
        wl = scale.to(torch.bfloat16).requires_grad_(True)
        yl = F.rms_norm(xl, (d,), wl, 1e-6)
        # least bytes: x, dy and rstd in, dx and dscale out
        nbytes = 3 * rows * d * 2 + rows * 4 + 2 * d * 4
        return {
            "ms": _time_ms(lambda: rmsnorm_cuda.rmsnorm_bwd(
                x, scale, rstd, dy), flush),
            "plain_ms": _time_ms(lambda: ref.rmsnorm_bwd_ref(
                x, scale, rstd, dy), flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": _time_ms(lambda: torch.autograd.grad(
                yl, (xl, wl), dy, retain_graph=True), flush),
            "shape": f"x, dy ({rows}, {d}) bf16{what}"}

    # timed at the train shape, and at the sequence-parallel rows
    return {
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm_bwd.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:92",
        "max_abs_err": max(errs),
        **record(4096, ""),
        **{f"tp{tp}_shape": record(rows, f" (sequence-parallel rows at tp "
                                         f"{tp})")
           for tp, rows in zip(TP_DEGREES, SP_ROWS)},
        "width_2048_tp2_shape": record(
            ZAMBA2_SP_ROWS, " (zamba2 / xlstm sequence-parallel rows at tp "
            "2)", 2048),
    }


# (label, B, S, Hq, Hkv, D, dtype, causal, window)
_TRAIN_SHAPE = ("train shape", 4, 1024, 32, 4, 128, "bf16", True, None)
_F32_TRAIN_SHAPE = ("train shape f32", 4, 1024, 32, 4, 128, "f32", True,
                    None)
_FLASH_CASES = [
    _TRAIN_SHAPE,
    ("f32", 2, 1024, 32, 4, 128, "f32", True, None),
    ("window=256", 2, 1024, 32, 4, 128, "bf16", True, 256),
    ("causal=False", 2, 512, 32, 4, 128, "bf16", False, None),
    ("ragged S=1000 D=64", 2, 1000, 8, 2, 64, "f32", True, None),
    ("G=1", 2, 512, 8, 8, 128, "bf16", True, None),
    # the bf16 arm's ragged edge and D = 64
    ("ragged S=1000 D=64 bf16", 2, 1000, 8, 2, 64, "bf16", True, None),
    # at most 16 keys a query: one key dropped or added moves an output by
    # far more than ROUND_TOL of its sum over |terms|
    ("window=16", 2, 1024, 32, 4, 128, "bf16", True, 16),
    # Granite-MoE's train shape: 16 q over 8 kv heads (G = 2), D = 64
    ("Granite train shape", 4, 1024, 16, 8, 64, "bf16", True, None),
]
_GRANITE_TRAIN_SHAPE = _FLASH_CASES[-1]
# Whisper's encoder (1500 frames: ragged tiles, bidirectional, 8 / 8
# heads, D = 64), its decoder (448 tokens: ragged tiles, causal) and
# zamba2's shared block in training (32 / 32, D = 64, causal), each in both
# arms
_WHISPER_ENC = {dt: (f"Whisper encoder {dt}", 4, 1500, 8, 8, 64, dt, False,
                     None) for dt in ("bf16", "f32")}
_WHISPER_DEC = {dt: (f"Whisper decoder {dt}", 4, 448, 8, 8, 64, dt, True,
                     None) for dt in ("bf16", "f32")}
_ZAMBA2_TRAIN = {dt: (f"Zamba2 train shape {dt}", 4, 1024, 32, 32, 64, dt,
                      True, None) for dt in ("bf16", "f32")}
# Yi-6B's train shape on one model rank's local heads under tensor
# parallelism: tp 2 (16 q / 2 kv heads) and tp 4 (8 q / 1 kv head)
TP_DEGREES = (2, 4)
_TP_TRAIN = {tp: (f"Yi-6B train shape, tp {tp} local heads", 4, 1024,
                  32 // tp, 4 // tp, 128, "bf16", True, None)
             for tp in TP_DEGREES}
# and its sequence-parallel rows (4 x 1024 tokens over tp ranks)
SP_ROWS = tuple(4 * 1024 // tp for tp in TP_DEGREES)
# zamba2's shared block on one model rank's heads at tp 2 (16 / 16) and
# Whisper's encoder at tp 2 and 4 (4 / 4 and 2 / 2 heads over the 1500
# gathered frames), in the bf16 arm the full-width steps take
_REC_TP_TRAIN = {
    "zamba2_tp2_shape": ("Zamba2 train shape, tp 2 local heads", 4, 1024,
                         16, 16, 64, "bf16", True, None),
    "whisper_encoder_tp2_shape": ("Whisper encoder, tp 2 local heads", 4,
                                  1500, 4, 4, 64, "bf16", False, None),
    "whisper_encoder_tp4_shape": ("Whisper encoder, tp 4 local heads", 4,
                                  1500, 2, 2, 64, "bf16", False, None)}
# zamba2's and xlstm's sequence-parallel rows at tp 2 (4 x 1024 / 2)
ZAMBA2_SP_ROWS = 4 * 1024 // 2
_FLASH_CASES += [*_WHISPER_ENC.values(), *_WHISPER_DEC.values(),
                 *_ZAMBA2_TRAIN.values(), *_TP_TRAIN.values(),
                 *_REC_TP_TRAIN.values()]


def _new_shape_records(timing, gen, flush, dt):
    """A flash kernel's timings at Whisper's encoder and decoder shapes
    and zamba2's train shape in the arm of ``dt``."""
    return {"whisper_encoder_shape": timing(gen, flush, _WHISPER_ENC[dt]),
            "whisper_decoder_shape": timing(gen, flush, _WHISPER_DEC[dt]),
            "zamba2_train_shape": timing(gen, flush, _ZAMBA2_TRAIN[dt])}


def _flash_inputs(gen, case):
    import torch
    _, b, s, hq, hkv, d, dt, causal, window = case
    dt = torch.bfloat16 if dt == "bf16" else torch.float32
    q = _randn((b, s, hq, d), gen, dt)
    k = _randn((b, s, hkv, d), gen, dt)
    v = _randn((b, s, hkv, d), gen, dt)
    do = _randn((b, s, hq, d), gen, dt)
    return q, k, v, do, causal, window


def _live_pairs(b, s, hq, causal, window):
    """(query, key) pairs the mask keeps, over batch and q heads."""
    import torch
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    return int(keep.sum()) * b * hq


def _flash_bound(q, k, live, ops_per_pair, n_q_like, n_kv_like):
    """(bound_ms, bound_by) of a flash kernel: its operations over the peak
    for its dtype (bf16 tensor cores; f32 outside them) against the bytes
    of n_q_like (B, S, Hq, D) and n_kv_like (B, S, Hkv, D) tensors plus lse
    moved once."""
    import torch
    b, s, hq, d = q.shape
    width = q.element_size()
    nbytes = (n_q_like * q.numel() + n_kv_like * k.numel()) * width + \
        b * hq * s * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    by_ops = ops_per_pair * d * live / peak * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def check_flash_fwd(gen, flush):
    """Both arms of the forward against the plain version; records for the
    bf16 (tensor-core) arm and the f32 (SIMT) arm, each timed at the train
    shape in its dtype."""
    import torch

    from repro_torch.kernels import flash_attention_cuda, ref
    errs = {torch.bfloat16: [], torch.float32: []}
    for case in _FLASH_CASES:
        q, k, v, _, causal, window = _flash_inputs(gen, case)
        o, lse = flash_attention_cuda.flash_attention_fwd(
            q, k, v, causal=causal, window=window)
        want_o, want_lse = ref.flash_attention_ref(
            q, k, v, causal=causal, window=window)
        # the bf16 arm rounds p to bf16 before p @ V, as the TPU kernel
        round_abs = None
        if q.dtype == torch.bfloat16:
            round_abs = ref.flash_round_scale(q, k, v, want_o, want_lse,
                                              None, causal, window)[0]
        label = f"flash_fwd {case[0]} {tuple(q.shape)}/{k.shape[2]} {q.dtype}"
        errs[q.dtype].append(_compare(label + " o", o, want_o,
                                      round_abs=round_abs))
        errs[q.dtype].append(_compare(label + " lse", lse, want_lse))
        del round_abs

    records = []
    for case, name in ((_TRAIN_SHAPE, "flash_attention_fwd"),
                       (_F32_TRAIN_SHAPE, "flash_attention_fwd_f32")):
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:129",
            "max_abs_err": max(errs[_flash_dtype(case)]),
            **_flash_fwd_timing(gen, flush, case)})
    records[0]["granite_train_shape"] = _flash_fwd_timing(
        gen, flush, _GRANITE_TRAIN_SHAPE)
    for tp, case in _TP_TRAIN.items():
        records[0][f"tp{tp}_shape"] = _flash_fwd_timing(gen, flush, case)
    for key, case in _REC_TP_TRAIN.items():
        records[0][key] = _flash_fwd_timing(gen, flush, case)
    for r, dt in zip(records, ("bf16", "f32")):
        r.update(_new_shape_records(_flash_fwd_timing, gen, flush, dt))
    return records


def _flash_dtype(case):
    import torch
    return torch.bfloat16 if case[6] == "bf16" else torch.float32


def _flash_fwd_timing(gen, flush, case):
    """The flash forward timed at a train shape (causal or not, as the
    case), beside its plain version, its bound and SDPA with
    ``enable_gqa``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_cuda, ref
    q, k, v, _, causal, window = _flash_inputs(gen, case)
    b, s, hq, d = q.shape
    live = _live_pairs(b, s, hq, causal, window)
    bound, bound_by = _flash_bound(q, k, live, 4, 2, 2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    arm = "tensor cores" if q.dtype == torch.bfloat16 else "SIMT"
    return {
        "ms": _time_ms(lambda: flash_attention_cuda.flash_attention_fwd(
            q, k, v, causal=causal), flush),
        "plain_ms": _time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), flush),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush),
        "shape": f"{case[0]}: q ({b}, {s}, {hq}, {d}) {q.dtype}, k/v "
                 f"{k.shape[2]} heads, {'causal' if causal else 'bidirectional'}"
                 f", live pairs {live}, {arm}"}


def _bwd_sum_abs(q, k, v, o, lse, do, causal, window):
    """dq, dk, dv recomputed over absolute values (|ds| from |dp| and
    |delta| taken as sums of |terms|): the scale of each output's f32
    summation-order error (SUM_ABS_TOL)."""
    import torch

    from repro_torch.kernels import ref
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    p = torch.exp(ref._train_logits(q, k, causal, window)
                  - lse.transpose(1, 2).reshape(b, s, hkv, g, 1))
    dog = do.reshape(b, s, hkv, g, d).float().abs()
    delta = (dog * o.reshape(b, s, hkv, g, d).float().abs()).sum(-1, True)
    dp = torch.einsum("bshgd,bthd->bshgt", dog, v.float().abs())
    ds = p * (dp + delta) * d ** -0.5
    qg = q.reshape(b, s, hkv, g, d).float().abs()
    return (torch.einsum("bshgt,bthd->bshgd", ds,
                         k.float().abs()).reshape(b, s, hq, d),
            torch.einsum("bshgt,bshgd->bthd", ds, qg),
            torch.einsum("bshgt,bshgd->bthd", p, dog))


def check_flash_bwd(gen, flush):
    """Both arms of the backward against the plain version; records for the
    bf16 and the f32 arm, each timed at the train shape in its dtype."""
    import torch

    from repro_torch.kernels import flash_attention_bwd_cuda, ref
    errs = {torch.bfloat16: [], torch.float32: []}
    for case in _FLASH_CASES:
        q, k, v, do, causal, window = _flash_inputs(gen, case)
        o, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        got = flash_attention_bwd_cuda.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, window=window)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window)
        scale = _bwd_sum_abs(q, k, v, o, lse, do, causal, window)
        # the bf16 arm rounds ds (dq, dk) and p (dv) to bf16, as the TPU
        # kernel
        rounding = (None, None, None)
        if q.dtype == torch.bfloat16:
            rounding = ref.flash_round_scale(q, k, v, o, lse, do, causal,
                                             window)[1:]
        label = f"flash_bwd {case[0]} {tuple(q.shape)}/{k.shape[2]} {q.dtype}"
        for name, g_, w_, m_, r_ in zip(("dq", "dk", "dv"), got, want, scale,
                                        rounding):
            errs[q.dtype].append(_compare(f"{label} {name}", g_, w_,
                                          sum_abs=m_, round_abs=r_))
        del scale, got, want, rounding

    records = []
    for case, name in ((_TRAIN_SHAPE, "flash_attention_bwd"),
                       (_F32_TRAIN_SHAPE, "flash_attention_bwd_f32")):
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention_bwd.py:142",
            "max_abs_err": max(errs[_flash_dtype(case)]),
            **_flash_bwd_timing(gen, flush, case)})
    records[0]["granite_train_shape"] = _flash_bwd_timing(
        gen, flush, _GRANITE_TRAIN_SHAPE)
    for tp, case in _TP_TRAIN.items():
        records[0][f"tp{tp}_shape"] = _flash_bwd_timing(gen, flush, case)
    for key, case in _REC_TP_TRAIN.items():
        records[0][key] = _flash_bwd_timing(gen, flush, case)
    for r, dt in zip(records, ("bf16", "f32")):
        r.update(_new_shape_records(_flash_bwd_timing, gen, flush, dt))
    return records


def _flash_bwd_timing(gen, flush, case):
    """The flash backward timed at a train shape (causal or not, as the
    case), beside its plain version, its bound and the SDPA backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd_cuda, ref
    q, k, v, do, causal, window = _flash_inputs(gen, case)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal)
    b, s, hq, d = q.shape
    live = _live_pairs(b, s, hq, causal, window)
    # s, dp, dq, dk, dv: five products of D; least bytes: q, o, do, k, v
    # and lse in, dq, dk, dv out
    bound, bound_by = _flash_bound(q, k, live, 10, 4, 4)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                        enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    arm = "tensor cores" if q.dtype == torch.bfloat16 else "SIMT"
    return {
        "ms": _time_ms(lambda: flash_attention_bwd_cuda.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), flush),
        "plain_ms": _time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=causal), flush),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": _time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), flush),
        "shape": f"{case[0]}: q, o, do ({b}, {s}, {hq}, {d}) {q.dtype}, "
                 f"k/v {k.shape[2]} heads, "
                 f"{'causal' if causal else 'bidirectional'}, live pairs "
                 f"{live}, {arm}"}


def _train_table_sizes(cut=1):
    """The 148 leaves of phase 8's train step (Yi-6B at full width x 16
    layers, 3,292,667,904 parameters), each cut to n // cut elements plus a
    ragged 0..6."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=16)
    return [math.prod(shape) // cut + (i % 7 if cut > 1 else 0)
            for i, shape in enumerate(M.flatten(M._shape_tree(cfg)).values())]


def _rl_table_sizes():
    """The 13 leaves of the paper's conv + LSTM net at 84 x 84 (phase 9b)."""
    from repro_torch.core import prng
    from repro_torch.models import atari as nets
    from repro_torch.models import model as M
    params = nets.init_atari_params(prng.key(0), 3, input_hw=84,
                                    in_channels=1, lstm=True, device="cpu")
    return [t.numel() for t in M.flatten(params).values()]


def _rmsprop_apply_plain(ps, gs, grads, lr):
    """The plain version of the apply mode: Eq. 8-9 and p - update, leaf by
    leaf, in place."""
    from repro_torch.kernels import ref
    for p, g, d in zip(ps, gs, grads):
        new_g, upd = ref.rmsprop_update_ref(g, d, lr=lr)
        g.copy_(new_g)
        p.sub_(upd)


def check_rmsprop(gen, flush):
    """Kernel 8 in its two modes.  One leaf (update mode) against the plain
    version at the train shape's MLP matrix, ragged counts and the RL
    leaves; the multi-leaf update and apply modes against the plain
    version over the paper net's 13 leaves and a 148-leaf table of the
    train step's leaves (each cut 256-fold, plus 0..6), and bit for bit
    (torch.equal) against the one-leaf kernel followed by a separate
    p.sub_(update); the launches each call counts.  Then the apply mode
    at the MLP matrix, over the paper net's leaves (the RL path's update)
    and over the train step's 148 leaves at full size: one call each held
    leaf by leaf against the plain version and its launches counted, then
    timed; the one-leaf update timed at the MLP matrix and the RL leaves,
    and the update and its subtraction at the MLP matrix."""
    import torch

    from repro_torch.kernels import ref, rmsprop_cuda
    lr = 7e-3
    errs = []
    # one MLP matrix of Yi-6B (4096 x 11008), one element, a ragged count;
    # the RL path's leaves: the paper net's FC (2592 x 256), its LSTM
    # input bias (1024), a policy matrix (256 x 3) and bias (3)
    for n in (4096 * 11008, 1, 4099) + RL_LEAF_SIZES:
        g = _randn((n,), gen, torch.float32).abs()
        grad = _randn((n,), gen, torch.float32, 3.0)
        want_g, want_u = ref.rmsprop_update_ref(g, grad, lr=lr)
        got_g, got_u = rmsprop_cuda.rmsprop_update(g.clone(), grad, lr=lr)
        errs.append(_compare(f"rmsprop n={n} g'", got_g, want_g))
        errs.append(_compare(f"rmsprop n={n} update", got_u, want_u))

    def table(sizes):
        g = [_randn((n,), gen, torch.float32).abs() for n in sizes]
        grad = [_randn((n,), gen, torch.float32, 3.0) for n in sizes]
        p = [_randn((n,), gen, torch.float32) for n in sizes]
        return g, grad, p

    def clone(ts):
        return [t.clone() for t in ts]

    for label, sizes in (("paper net 13 leaves", _rl_table_sizes()),
                         ("train table 148 leaves cut 256x",
                          _train_table_sizes(256))):
        g, grad, p = table(sizes)
        want = [ref.rmsprop_update_ref(a, d, lr=lr) for a, d in zip(g, grad)]
        launches = -(-len(sizes) // rmsprop_cuda.MAX_LEAVES)
        # update mode, many leaves
        got_g = clone(g)
        before = rmsprop_cuda.multi_launches
        got_u = rmsprop_cuda.rmsprop_update_multi(got_g, grad, lr=lr)
        if rmsprop_cuda.multi_launches - before != launches:
            raise AssertionError(f"rmsprop update multi {label}: "
                                 f"{rmsprop_cuda.multi_launches - before} "
                                 f"launches (want {launches})")
        errs.append(_compare(f"rmsprop update multi {label} g'",
                             torch.cat(got_g),
                             torch.cat([w[0] for w in want])))
        errs.append(_compare(f"rmsprop update multi {label} update",
                             torch.cat(got_u),
                             torch.cat([w[1] for w in want])))
        # apply mode, many leaves
        app_g, app_p = clone(g), clone(p)
        before = rmsprop_cuda.apply_launches
        rmsprop_cuda.rmsprop_apply_multi(app_p, app_g, grad, lr=lr)
        if rmsprop_cuda.apply_launches - before != launches:
            raise AssertionError(f"rmsprop apply multi {label}: "
                                 f"{rmsprop_cuda.apply_launches - before} "
                                 f"launches (want {launches})")
        plain_g, plain_p = clone(g), clone(p)
        _rmsprop_apply_plain(plain_p, plain_g, grad, lr)
        errs.append(_compare(f"rmsprop apply multi {label} g'",
                             torch.cat(app_g), torch.cat(plain_g)))
        errs.append(_compare(f"rmsprop apply multi {label} p",
                             torch.cat(app_p), torch.cat(plain_p)))
        # bit for bit: the one-leaf kernel and a separate subtraction
        one_g, one_p, one_u = clone(g), clone(p), []
        for a, d, q in zip(one_g, grad, one_p):
            one_u.append(rmsprop_cuda.rmsprop_update(a, d, lr=lr)[1])
            q.sub_(one_u[-1])
        same = all(torch.equal(x, y) for x, y in zip(
            app_g + app_p + got_g + got_u, one_g + one_p + one_g + one_u))
        if not same:
            raise AssertionError(f"rmsprop multi {label}: not the bits of "
                                 "the one-leaf kernel and p.sub_(update)")
        print(f"check rmsprop multi {label}: update and apply modes in "
              f"{launches} launch(es) each equal the one-leaf kernel + "
              "p.sub_ bit for bit ok")
        del g, grad, p, got_g, got_u, app_g, app_p, one_g, one_p, one_u

    def apply_timed(sizes, label):
        """One apply-mode call over ``sizes`` held leaf by leaf against the
        plain version on copies of g and p (each copy freed once held), its
        launches counted, then both timed."""
        g, grad, p = table(sizes)
        plain_g, plain_p = clone(g), clone(p)
        before = rmsprop_cuda.apply_launches
        rmsprop_cuda.rmsprop_apply_multi(p, g, grad, lr=lr)
        launches = rmsprop_cuda.apply_launches - before
        if launches != -(-len(sizes) // rmsprop_cuda.MAX_LEAVES):
            raise AssertionError(f"rmsprop apply multi {label}: {launches} "
                                 "launches")
        leaf_errs = []
        for i in range(len(sizes)):
            _rmsprop_apply_plain(plain_p[i:i + 1], plain_g[i:i + 1],
                                 grad[i:i + 1], lr)
            leaf_errs += [
                _compare(f"rmsprop apply multi {label} leaf {i} g'", g[i],
                         plain_g[i], echo=False),
                _compare(f"rmsprop apply multi {label} leaf {i} p", p[i],
                         plain_p[i], echo=False)]
            plain_g[i] = plain_p[i] = None
        del plain_g, plain_p
        errs.extend(leaf_errs)
        print(f"check rmsprop apply multi {label}: {len(sizes)} leaves of "
              f"{sum(sizes)} elements in {launches} launch(es), g' and p "
              f"leaf by leaf max_abs_err={max(leaf_errs):.3e} "
              f"rtol, atol={F32_TOL} ok")
        out = {
            "ms": _time_ms(lambda: rmsprop_cuda.rmsprop_apply_multi(
                p, g, grad, lr=lr), flush),
            "plain_ms": _time_ms(lambda: _rmsprop_apply_plain(
                p, g, grad, lr), flush),
            # g, grad and p read, g' and p written, 4 bytes each
            "bound_ms": 20 * sum(sizes) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            # torch.optim.RMSprop puts eps outside the square root: no
            # single PyTorch call computes Eq. 8-9
            "library_ms": None,
            "launches_per_call": launches,
            "shape": f"apply mode, {len(sizes)} f32 leaves of {sum(sizes)} "
                     f"elements ({label})"}
        del g, grad, p
        torch.cuda.empty_cache()
        return out

    def update_timed(shape, label):
        n = math.prod(shape)
        g = _randn(shape, gen, torch.float32).abs()
        grad = _randn(shape, gen, torch.float32, 3.0)
        return {
            "ms": _time_ms(lambda: rmsprop_cuda.rmsprop_update(
                g, grad, lr=lr), flush),
            "plain_ms": _time_ms(lambda: ref.rmsprop_update_ref(
                g, grad, lr=lr), flush),
            # g and grad read, g' and the update written, 4 bytes each
            "bound_ms": 16 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "shape": f"update mode, one f32 leaf of {n} elements ({label})"}

    # the 40 GB train table last, after the leaves of a few MB
    shapes = {
        "llm_leaf_shape": update_timed((4096, 11008), "4096 x 11008"),
        "rl_fc_shape": update_timed((2592, 256),
                                    "the paper net's FC, 2592 x 256"),
        "rl_small_shape": update_timed((256, 3), "a policy matrix, 256 x 3")}
    # the apply mode at the MLP matrix, and the step it replaces there:
    # the one-leaf update, then p.sub_
    leaf = apply_timed([4096 * 11008], "4096 x 11008")
    g, grad, p = table([4096 * 11008])
    leaf["unfused_ms"] = _time_ms(lambda: p[0].sub_(
        rmsprop_cuda.rmsprop_update(g[0], grad[0], lr=lr)[1]), flush)
    del g, grad, p
    shapes["llm_leaf_apply_shape"] = leaf
    rl_table = apply_timed(_rl_table_sizes(), "the paper net's 13 leaves, "
                           "one worker update")
    # 60 GB: the table and the plain version's copies of g and p
    shapes["train_table_shape"] = apply_timed(
        _train_table_sizes(), "Yi-6B x 16 layers, one train step")
    return {
        "name": "rmsprop_update", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsprop.cu",
        "replaces": "src/repro/kernels/shared_rmsprop.py:34",
        "max_abs_err": max(errs), **rl_table, **shapes}


# ---------------------------------------------------------------------------
# phase 3b: jax.random's threefry (core/prng.py) on the card
# ---------------------------------------------------------------------------

def check_prng(flush):
    """``prng`` on the card against ``prng`` on the CPU: bits, uniform,
    randint and categorical bit for bit at the sampling shape (4 rows of
    Yi-6B's 64,000 logits), at a leaf of 4096 x 4096 and at a draw of the
    RL loop (16 x 3, hashed by a CUDA graph); categorical where
    its top-2 margin of gumbel + logits exceeds 1e-5 (the rows below it
    are counted: log rounds per device).  truncated_normal, whose log1p
    also rounds per device, within 4 f32 ulps.  Prints the card's times of
    a 4096 x 4096 truncated normal draw and of the engine's sampling call
    (host-bound: its time is the host's enqueue)."""
    import torch

    from repro_torch.core import llm_a3c, prng
    key_c, key_g = prng.key(7), prng.key(7, device="cuda")
    cpu_gen = torch.Generator().manual_seed(0)
    # (16, 3): a draw of the RL loop, whose hash replays a CUDA graph
    for shape in ((4, 64000), (4096, 4096), (16, 3)):
        label = f"prng {shape[0]}x{shape[1]}"
        for name, fn in (
                ("bits", lambda k: prng.bits(k, shape)),
                ("uniform", lambda k: prng.uniform(k, shape).view(
                    torch.int32)),
                ("randint", lambda k: prng.randint(k, shape, 0, 64000))):
            if not torch.equal(fn(key_g).cpu(), fn(key_c)):
                raise AssertionError(f"{label} {name}: card != CPU")
        logits = torch.randn(shape, generator=cpu_gen) * 3.0
        keys = prng.fold_in(key_c, torch.arange(shape[0]))
        got = prng.categorical(keys.cuda(), logits.cuda()).cpu()
        want = prng.categorical(keys, logits)
        top2 = torch.topk(prng.gumbel(keys, shape[1:]) + logits, 2).values
        decided = (top2[:, 0] - top2[:, 1]) > 1e-5
        if not torch.equal(got[decided], want[decided]):
            raise AssertionError(f"{label} categorical: card != CPU")
        print(f"check {label} bits uniform randint: card == CPU bit for "
              f"bit; categorical: {int(decided.sum())} rows above the 1e-5 "
              f"margin identical, {int((~decided).sum())} below ok")
    shape = (4096, 4096)
    tn_g = prng.truncated_normal(key_g, -2.0, 2.0, shape).cpu().double()
    tn_c = prng.truncated_normal(key_c, -2.0, 2.0, shape).double()
    spacing = (torch.nextafter(tn_c.float().abs(), torch.tensor(9.0))
               - tn_c.float().abs()).double()
    ulps = float(((tn_g - tn_c).abs() / spacing).max())
    exact = float((tn_g == tn_c).double().mean())
    if ulps > 4:
        raise AssertionError(f"prng truncated_normal: card vs CPU {ulps} "
                             "ulps")
    print(f"check prng truncated_normal 4096x4096: card vs CPU max {ulps:g} "
          f"f32 ulps (tol 4), {exact:.4f} of values identical ok")
    # the engine's sampling call: 4 slots of Yi-6B's logits on the card,
    # the key, stream ids and positions on the host
    logits = torch.randn((4, 64000), device="cuda")
    sids, pos = torch.tensor([3, 1, 7, 0]), torch.tensor([100, 400, 700, 900])
    times = {"truncated_normal_4096x4096_ms": _time_ms(
                 lambda: prng.truncated_normal(key_g, -2.0, 2.0, shape),
                 flush),
             "sample_slot_tokens_4x64000_ms": _time_ms(
                 lambda: llm_a3c.sample_slot_tokens(logits, key_c, sids=sids,
                                                    pos=pos), flush)}
    print("prng on the card: " + json.dumps(times))


# ---------------------------------------------------------------------------
# phase 5: the model and the engine
# ---------------------------------------------------------------------------

def check_model_small(cfg=None, label="model reduced yi-6b f32"):
    """A reduced model in f32 (Yi-6B's unless ``cfg``): prefill + per-slot
    decode logits on the card (kernels) against the CPU (plain versions).
    The card's run is a path of its own: f32 activations over an f32 cache
    take the append kernel's SIMT arm (flash_append_f32) and kernel 6's
    float arm, no other attention arm.  Returns its launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    cfg = cfg or get_config("yi-6b").reduced()
    outs = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(cfg, 0, "cpu")
        params = M.tree_map(lambda t: t.to(dev), params)
        cache = M.init_cache(cfg, 2, 64, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)),
                               device=dev)
        dispatch.reset_launch_counts()
        seq = []
        for p0 in (0, 32):
            out, cache = M.prefill_step(cfg, params, cache,
                                        {"tokens": toks[:, p0:p0 + 32]}, p0)
            seq.append(out["logits"])
        pos = torch.tensor([40, 37], device=dev)
        for _ in range(3):
            nxt = seq[-1][:, -1:].argmax(-1)
            out, cache = M.decode_step(cfg, params, cache, {"tokens": nxt},
                                       pos)
            seq.append(out["logits"])
            pos = pos + 1
        counts = dispatch.launch_counts()
        outs[dev] = [t.float().cpu() for t in seq]
    err = 0.0
    for a, b in zip(outs["cuda"], outs["cpu"]):
        if not torch.isfinite(a).all():
            raise AssertionError("model: non-finite logits on the card")
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{label}: card vs CPU logits differ by "
                                 f"{err}")
    _check_attention_arms(label, counts,
                          ("flash_append_f32", "decode_attention"))
    print(f"check {label} prefill + decode cuda vs cpu: max_abs_err="
          f"{err:.3e} tol=1e-4 ok")
    return counts


# the attention kernels and arms of the serving path; each serving run
# launches exactly two of them (_serving_arms) and none of the others
SERVING_ARMS = ("flash_append", "flash_append_f32", "flash_append_int8",
                "flash_append_int8_f32", "decode_attention",
                "decode_attention_int8",
                "decode_attention_partials", "decode_attention_partials_int8")
# phase 5's trace on Yi-6B: 23 prompt chunks of 128 rows, one append
# launch each in each of the 32 layers
PHASE5_APPENDS = 23 * 32


def _serving_arms(kv, cp, bf16_q=True):
    """The append arm and the decode kernel and arm that a serving run
    with KV dtype ``kv`` launches: the partials kernel under decode_cp,
    kernel 6 otherwise; the append kernel's tensor-core arms (bf16 or int8
    stream) under bf16 activations (a float stream is cast to q's dtype),
    its SIMT arms under f32 ones."""
    sfx = "_int8" if kv == "int8" else ""
    decode = "decode_attention_partials" if cp else "decode_attention"
    append = "flash_append" + sfx + ("" if bf16_q else "_f32")
    return append, decode + sfx


def _check_attention_arms(label, counts, want):
    """The run launched the rmsnorm and each arm of ``want``, and no other
    serving arm."""
    _check_launched(label, counts, ("rmsnorm",) + tuple(want), SERVING_ARMS)


def _check_launched(label, counts, want, never):
    """Every counter of ``want`` launched, none of ``never``."""
    missing = [k for k in want if counts[k] <= 0]
    stray = {k: counts[k] for k in never if k not in want and counts[k]}
    if missing or stray:
        raise AssertionError(f"{label}: kernels never launched {missing}, "
                             f"launched off its path {stray}")


def _check_serving_run(label, rep, counts, kv, cp, bf16_q=True,
                       paged=False):
    """The run took the layout and the kernels its flags ask for: the
    report's decode_layout, paged flag and kv dtype, the rmsnorm and its
    two arms launched, every other serving arm not launched."""
    layout = "decode_cp[1]" if cp else "replicated"
    if rep["decode_layout"] != layout or rep["kv_dtype"] != kv \
            or rep["paged"] != paged:
        raise AssertionError(f"{label}: layout {rep['decode_layout']} kv "
                             f"{rep['kv_dtype']} paged {rep['paged']}, "
                             f"expected {layout} {kv} paged {paged}")
    _check_attention_arms(label, counts, _serving_arms(kv, cp, bf16_q))


def _check_books(label, eng):
    """A drained paged engine's books balance: no reservation left, every
    page back on the free list once but those a fault plan holds, every
    other refcount 0."""
    al, held = eng.alloc, set(eng._fault_held)
    ok = (al.reserved == 0 and int(eng.resv_of.sum()) == 0
          and al.used_pages == len(held)
          and len(set(al.free)) == len(al.free) and 0 not in al.free
          and not set(al.free) & held
          and all(int(al.ref[p]) == (p in held)
                  for p in range(1, al.n_pages)))
    if not ok:
        raise AssertionError(f"{label}: books do not balance (reserved "
                             f"{al.reserved}, used {al.used_pages}, held "
                             f"{sorted(held)})")


def build_yi6b():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    print(f"yi-6b params {cfg.param_count()} built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def _phase5_trace(cfg):
    from repro_torch.launch import serve
    return serve.gen_trace(8, vocab=cfg.vocab_size, prompt_range=(64, 600),
                           gen_range=(16, 48), arrival_rate=0.0, seed=0)


def _serve(label, cfg, params, trace, kv, cp=False, device="cuda",
           **engine_kw):
    """``trace`` through ``serve.serve_trace`` on a new engine (4 slots,
    cache 1024, chunk 128, greedy unless ``engine_kw`` says otherwise),
    counters set to 0 just before and read just after.  Every request
    completes with finite logits.  Returns (report, launch counts, engine,
    {rid: tokens}); ``engine.step_calls`` counts its prefill-chunk and
    verify calls, warm-up included."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve, traffic
    kw = dict(n_slots=4, cache_len=1024, chunk=128, sample=False, seed=0,
              kv_dtype=kv, device=device, decode_cp=cp)
    kw.update(engine_kw)
    eng = serve.ServeEngine(cfg, params, **kw)
    _count_steps(eng)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    rep = serve.serve_trace(eng, trace)
    counts = {**dispatch.launch_counts(), **dispatch.route_counts()}
    if eng.paged:
        rep["pool_mib"] = traffic.page_pool_bytes(
            cfg, eng.n_pages, eng.page_size, kv_dtype=kv) / 2**20
    unfinished = [r.rid for r in trace if len(r.tokens) != r.max_new]
    if rep["requests"] != len(trace) or unfinished:
        raise AssertionError(f"{label}: requests {unfinished} did not finish")
    if not rep["logits_finite"]:
        raise AssertionError(f"{label}: non-finite logits")
    return rep, counts, eng, {r.rid: list(r.tokens) for r in trace}


def _count_steps(eng):
    """Wrap the engine's prefill and verify steps to count their calls in
    ``eng.step_calls``."""
    eng.step_calls = {"prefill": 0, "verify": 0}

    def counted(name, fn):
        def call(*args, **kw):
            eng.step_calls[name] += 1
            return fn(*args, **kw)
        return call
    if eng.prefill_step is not None:
        eng.prefill_step = counted("prefill", eng.prefill_step)
    if eng.spec != "off":
        eng.verify_step = counted("verify", eng.verify_step)


def _print_run(label, rep, counts, keys=()):
    import torch
    print(f"{label}: " + json.dumps({k: rep[k] for k in (
        "requests", "generated_tokens", "prefill_tokens", "wall_s",
        "tokens_per_s", "decode_tokens_per_s", "prefill_wall_s", "ttft_s",
        "latency_s", "warmup_s", "logits_finite", "paged", "decode_layout",
        "cp_combine_bytes_per_token") + tuple(keys)}))
    print(f"{label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    shown = {k: counts[k] for k in ("rmsnorm",) + SERVING_ARMS}
    print(f"{label}: kernel launches {json.dumps(shown)}")


PAGE_KEYS = ("page_size", "n_pages", "pool_mib", "usable_pages",
             "pages_requested", "pages_alloced", "dedup_ratio", "cow_events",
             "prefill_chunks_skipped", "pool_high_water", "robustness")


def run_yi6b_engine(cfg, params, kv, cp, sample=False, paged=None):
    """Phase 5's trace (8 requests, greedy unless ``sample``: then the
    threefry streams of seed 0) through the engine on Yi-6B at full
    width and depth with KV dtype ``kv``, under decode_cp[1] over the
    one-rank NCCL group installed by the caller when ``cp``; the paged
    layout by default (page 128: 33 pages), ``paged=False`` contiguous.
    Returns (the launch counts of that run alone, its tokens)."""
    trace = _phase5_trace(cfg)
    want_paged = not cp and paged is not False
    label = (f"engine yi-6b full width x 32 layers "
             f"{'paged' if want_paged else 'contiguous'} "
             f"{'decode_cp[1] ' if cp else ''}{kv}"
             f"{' sampled' if sample else ''}")
    rep, counts, _, tokens = _serve(label, cfg, params, trace, kv, cp,
                                    sample=sample, paged=paged)
    _check_serving_run(label, rep, counts, kv, cp, paged=want_paged)
    append = _serving_arms(kv, cp)[0]
    if counts[append] != PHASE5_APPENDS:
        raise AssertionError(f"{label}: {append} launched {counts[append]} "
                             f"times, want {PHASE5_APPENDS}")
    _print_run(label, rep, counts, PAGE_KEYS if want_paged else ())
    return counts, tokens


def _prefix_trace(vocab):
    """Phase 5p's trace: 16 requests on one 512-token prefix (4 pages of
    128) with distinct tails of 16-100 tokens, except two pairs (rids 3, 4
    and 10, 11) whose whole prompts are identical; generations 32-64."""
    import numpy as np

    from repro_torch.launch import serve
    rng = np.random.default_rng(19)
    shared = rng.integers(0, vocab, 512).astype(np.int32)
    tails = [rng.integers(0, vocab, int(rng.integers(16, 101)))
             .astype(np.int32) for _ in range(16)]
    tails[4], tails[11] = tails[3], tails[10]
    return [serve.Request(rid=i, prompt=np.concatenate([shared, tails[i]]),
                          max_new=int(rng.integers(32, 65)), arrival=0.0)
            for i in range(16)]


def check_prefix_sharing(cfg, params, device="cuda"):
    """Phase 5p: Yi-6B, 8 slots, cache 1024 (65 pages), bf16, greedy, the
    prefix trace with the prefix cache on and off: the same tokens, chunks
    skipped, copy-on-write forks, fewer pages.  Each run is its own path;
    returns {path: counts}."""
    out, recs, toks = {}, {}, {}
    for share in (True, False):
        path = "prefix_shared" if share else "prefix_private"
        rep, out[path], _, toks[share] = _serve(
            f"engine yi-6b {path}", cfg, params, _prefix_trace(cfg.vocab_size),
            "bf16", device=device, n_slots=8, prefix_cache=share)
        _check_serving_run(path, rep, out[path], "bf16", False, paged=True)
        recs[share] = rep
        if device == "cuda":
            _print_run(f"engine yi-6b {path}", rep, out[path], PAGE_KEYS)
    on, off = recs[True], recs[False]
    if toks[True] != toks[False]:
        raise AssertionError("prefix sharing changed the tokens")
    if not (on["prefill_chunks_skipped"] > 0 and on["cow_events"] > 0
            and on["pages_alloced"] < off["pages_alloced"]):
        raise AssertionError(
            f"prefix sharing: skipped {on['prefill_chunks_skipped']}, cow "
            f"{on['cow_events']}, pages {on['pages_alloced']} vs "
            f"{off['pages_alloced']}")
    print(f"check prefix sharing yi-6b 16 requests: tokens identical, "
          f"skipped chunks {on['prefill_chunks_skipped']}, cow "
          f"{on['cow_events']}, pages {on['pages_alloced']} vs "
          f"{off['pages_alloced']}, dedup {on['dedup_ratio']}; ttft p50/p90 "
          f"{on['ttft_s'].get('p50')}/{on['ttft_s'].get('p90')} vs "
          f"{off['ttft_s'].get('p50')}/{off['ttft_s'].get('p90')} s, "
          f"admission wall {on['prefill_wall_s']} vs "
          f"{off['prefill_wall_s']} s ok")
    return out


# phase 5o's cut of phase 5's pool: 10 usable pages, two of its largest
# requests' worst case (5 pages each)
OVERLOAD_PAGES = 11


def check_overload(cfg, params, want_tokens, device="cuda"):
    """Phase 5o at full width, bf16: phase 5's trace on an 11-page pool.
    ``reserve``: every request completes with phase 5's tokens and no
    preemption while requests queued behind a free slot; ``optimistic``:
    decode runs into pages that are gone and preempts.  Both end with
    balanced books.  Returns {path: counts}."""
    out = {}
    for adm in ("reserve", "optimistic"):
        path = f"overload_{adm}"
        rep, out[path], eng, toks = _serve(
            f"engine yi-6b {path}", cfg, params, _phase5_trace(cfg), "bf16",
            device=device, n_pages=OVERLOAD_PAGES, admission=adm)
        _check_serving_run(path, rep, out[path], "bf16", False, paged=True)
        _check_books(path, eng)
        same = sum(toks[r] == want_tokens[r] for r in toks)
        if adm == "reserve":
            if not (eng.preemptions == 0 and max(eng.queue_depths) > 0
                    and max(eng.occupancy) < 1.0 and toks == want_tokens):
                raise AssertionError(
                    f"{path}: preemptions {eng.preemptions}, queue "
                    f"{max(eng.queue_depths)}, occupancy "
                    f"{max(eng.occupancy)}, tokens as phase 5 {same}/8")
        elif eng.preemptions <= 0:
            raise AssertionError(f"{path}: no preemption")
        if device == "cuda":
            _print_run(f"engine yi-6b {path}", rep, out[path], PAGE_KEYS)
        print(f"check overload {adm} yi-6b {OVERLOAD_PAGES} pages: "
              f"preemptions {eng.preemptions}, largest queue "
              f"{max(eng.queue_depths)}, most slots busy "
              f"{max(eng.occupancy)}, requests with phase 5's tokens "
              f"{same}/8, books balanced ok")
    return out


def check_overload_reduced(devices=("cpu", "cuda")):
    """Phase 5o, reduced Yi-6B in f32: the JAX package's pressure trace
    (a shared 64-token prefix, identical prompts for rids 1 and 2,
    generations into a third page of 64) on 2 slots and a 5-page pool
    under optimistic admission, and again under ``FaultPlan.random(0)``,
    on a virtual clock: the card's engine emits the CPU engine's tokens
    (margin-qualified) with its counters.  Returns the card runs' counts
    by path."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("yi-6b").reduced()
    params = M.init_params(cfg, 0, "cpu")
    ps = 64
    # trace seed 3: every greedy choice wins by >= 1e-3 on these weights
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, ps).astype(np.int32)
    dup = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    tails = [dup if i in (1, 2) else rng.integers(
        0, cfg.vocab_size, 5 + (i % 3) * 6).astype(np.int32)
        for i in range(4)]
    keys = ("preemptions", "requeues", "sheds_admission", "sheds_decode",
            "retries", "injected_alloc_failures", "forced_preemptions",
            "cow_events", "pages_requested", "pages_alloced",
            "prefill_chunks_skipped", "step_count")
    out = {}
    for path, plan in (("overload_reduced_f32", None),
                       ("fault_plan_reduced_f32", serve.FaultPlan.random(0))):
        runs = {}
        for dev in devices:
            trace = [serve.Request(rid=i, prompt=np.concatenate(
                [shared, tails[i]]), max_new=ps, arrival=0.0)
                for i in range(4)]
            eng = serve.ServeEngine(
                cfg, M.tree_map(lambda t: t.to(dev), params), n_slots=2,
                cache_len=3 * ps, chunk=ps, sample=False, seed=0,
                page_size=ps, n_pages=5, admission="optimistic",
                fault_plan=plan, clock=lambda: 0.0, device=dev)
            dispatch.reset_launch_counts()
            rep = serve.serve_trace(eng, trace)
            counts = dispatch.launch_counts()
            _check_books(f"{path} {dev}", eng)
            runs[dev] = ({r.rid: list(r.tokens) for r in trace},
                         {k: int(getattr(eng, k)) for k in keys}, eng.now())
            if dev == devices[0]:
                margin = serve.min_accept_margin(cfg, params, trace, 3 * ps,
                                                 device="cpu")
        _check_serving_run(path, rep, counts, "f32", False, bf16_q=False,
                           paged=True)
        if margin < 1e-3:
            raise AssertionError(f"{path}: near tie (margin {margin})")
        card, cpu = (runs[d] for d in devices[::-1])
        if card != cpu or cpu[1]["preemptions"] <= 0:
            raise AssertionError(f"{path}: card {card} != CPU {cpu}")
        out[path] = counts
        print(f"check {path} cuda vs cpu: tokens, counters "
              f"{json.dumps(cpu[1])} and virtual clock {cpu[2]:.6f} s "
              f"identical, margin {margin:.4g} (>= 1e-3), books balanced ok")
    return out


# ---------------------------------------------------------------------------
# phase 5s: speculative decoding
# ---------------------------------------------------------------------------

# a token that a speculative run chooses apart from plain decode is a near
# tie when a third computation (one prefill of the shared prefix) puts the
# two tokens' bf16 logits within this many bf16 ulps of the larger: the
# verify's K-row append and (B*K)-row GEMMs round apart from the decode
# step's one-row kernel and B-row GEMMs through 32 layers
NEAR_TIE_ULPS = 4
SPEC_KEYS = ("spec_rounds", "spec_drafted", "spec_drafts_accepted",
             "spec_wasted_tokens", "spec_pages_rewound", "accepted_k")


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _near_tie_check(label, cfg, params, trace, got, want):
    """``got`` against ``want`` ({rid: tokens}, both greedy bf16 runs of
    ``trace``): each request identical, or its first divergent token a near
    tie (``NEAR_TIE_ULPS``), read from one prefill of the prompt and the
    tokens both runs share.  Returns (identical requests, the divergences
    as (rid, index, gap, bound))."""
    import numpy as np
    import torch

    from repro_torch.core import llm_a3c
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    prefill = llm_a3c.make_prefill_step(cfg)
    cast = M.cast_params(cfg, params)
    same, ties = 0, []
    for r in trace:
        a, b = want[r.rid], got[r.rid]
        if a == b:
            same += 1
            continue
        t = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
        seq = np.concatenate([np.asarray(r.prompt, np.int32),
                              np.asarray(a[:t], np.int32)])
        toks, plens, grid = serve._pad_group([seq], 1, 128, 1024)
        cache = M.init_cache(cfg, 1, 1024, dtype=torch.bfloat16,
                             device="cuda")
        last, _ = serve._chunked_prefill(prefill, cast, cache, toks, plens,
                                         grid, torch.device("cuda"))
        la, lb = float(last[0, a[t]]), float(last[0, b[t]])
        gap = abs(la - lb)
        bound = NEAR_TIE_ULPS * _bf16_ulp(max(abs(la), abs(lb)))
        ties.append((r.rid, t, gap, bound))
        if gap > bound:
            raise AssertionError(
                f"{label}: request {r.rid} left plain decode at token {t} "
                f"({a[t]} -> {b[t]}) with a logit gap {gap:.4g} above the "
                f"near-tie bound {bound:.4g}")
    print(f"check {label}: {same}/{len(trace)} requests with plain "
          f"decode's tokens exactly; divergences (rid, token, gap, bound) "
          f"{[(i, t, round(g, 5), round(bd, 5)) for i, t, g, bd in ties]}, "
          f"each a near tie (<= {NEAR_TIE_ULPS} bf16 ulps) ok")
    return same, ties


def _check_spec_launches(label, eng, counts, arms):
    """A speculative run launched ``arms`` and no other serving arm, the
    target's append exactly 32 times each prefill chunk and verify round
    (warm-up included), and every verify through the verify routes."""
    _check_attention_arms(label, counts, arms)
    calls = eng.step_calls
    n = eng.cfg.n_layers
    want = n * (calls["prefill"] + calls["verify"])
    route = counts["verify_paged" if eng.paged else "flash_verify"]
    if counts["flash_append"] != want or counts["flash_verify"] != \
            n * calls["verify"] or route != n * calls["verify"]:
        raise AssertionError(
            f"{label}: flash_append {counts['flash_append']} (want {n} x "
            f"({calls['prefill']} chunks + {calls['verify']} rounds) = "
            f"{want}), flash_verify {counts['flash_verify']}, "
            f"verify_paged {counts['verify_paged']}")
    print(f"check {label}: flash_append {counts['flash_append']} = {n} x "
          f"({calls['prefill']} prefill chunks + {calls['verify']} verify "
          f"rounds), flash_verify {counts['flash_verify']}, verify_paged "
          f"{counts['verify_paged']}, decode_attention "
          f"{counts['decode_attention']} ok")


def _sim_ngram_rounds(prompt, stream, kmax):
    """The engine's accept rule replayed on a recorded greedy stream with
    ``NgramDraft`` (no model calls): (accept rate, rounds, tokens a
    round)."""
    from repro_torch.launch import serve
    d = serve.NgramDraft()
    hist = list(prompt) + [int(stream[0])]
    i, acc, drafted, rounds = 1, 0, 0, 0
    while i < len(stream):
        props = d.propose_one(hist, kmax)
        ke = min(kmax, 1 + len(props))
        a = 0
        while a < ke - 1 and i + a < len(stream) \
                and props[a] == stream[i + a]:
            a += 1
        na = min(a + 1, len(stream) - i)
        drafted += ke - 1
        acc += na - 1
        hist.extend(stream[i:i + na])
        i += na
        rounds += 1
    return (acc / max(drafted, 1), rounds,
            (len(stream) - 1) / max(rounds, 1))


def _spec_probe_trace(cfg, params, *, shared_len=16, n_cand=24,
                      n_requests=4, max_new=48, fold=8, spec_k=6, seed=7):
    """Phase 5s (b)'s trace, by the method of ``bench_serve.spec_trace``:
    ``n_cand`` prompts on one shared prefix run ``fold + max_new`` greedy
    tokens through the plain engine; the one whose stream the n-gram
    replay covers in the fewest rounds wins, its first ``fold`` tokens
    folded into the prompt, which ``n_requests`` requests share with
    generations ``max_new - 4 * (i % 3)``.  Returns (make_trace, info)."""
    import numpy as np

    from repro_torch.launch import serve
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, shared_len).astype(np.int32)
    cands = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, 8 + i % 7).astype(np.int32)])
        for i in range(n_cand)]
    probe = [serve.Request(rid=i, prompt=c, max_new=fold + max_new,
                           arrival=0.0) for i, c in enumerate(cands)]
    serve.run_engine(cfg, params, probe, n_slots=8, cache_len=1024,
                     chunk=128, sample=False, seed=0, kv_dtype="bf16",
                     device="cuda")
    best, best_sim = 0, (0.0, 10 ** 9, 0.0)
    for r in probe:
        t = [int(x) for x in r.tokens]
        sim = _sim_ngram_rounds([int(x) for x in cands[r.rid]] + t[:fold],
                                t[fold:fold + max_new], spec_k)
        if sim[2] > best_sim[2]:
            best, best_sim = r.rid, sim
    base = np.concatenate([cands[best],
                           np.asarray(probe[best].tokens[:fold], np.int32)])

    def make_trace():
        return [serve.Request(rid=i, prompt=base.copy(),
                              max_new=max_new - 4 * (i % 3), arrival=0.0)
                for i in range(n_requests)]
    info = {"n_candidates": n_cand, "fold": fold, "best": best,
            "sim_accept": round(best_sim[0], 3),
            "sim_tokens_per_round": round(best_sim[2], 2),
            "prompt_len": len(base), "max_new": max_new, "spec_k": spec_k}
    return make_trace, info


SPEC_REPORT_KEYS = ("requests", "generated_tokens", "wall_s",
                    "tokens_per_s", "decode_tokens_per_s", "prefill_wall_s",
                    "ttft_s", "latency_s", "warmup_s", "cow_events",
                    "pages_alloced", "speculative")


def check_spec(cfg, params, want_tokens):
    """Phase 5s at full width (Yi-6B, bf16 weights from seed 0, bf16 KV, 4
    slots, cache 1024, chunk 128, the default paged layout): (a) phase 5's
    trace with n-gram drafts, spec_k 4; (b) the probed high-acceptance
    trace, off and n-gram in turns (off, ngram, ngram, off), spec_k 6;
    (c) that trace with the draft model.  Each run is its own path, held
    to its launch gates and, margin-qualified, to plain decode's tokens.
    Returns {path: counts}."""
    out = {}
    label = "spec yi-6b ngram (phase 5 trace)"
    rep, out["spec_ngram"], eng, toks = _serve(
        label, cfg, params, _phase5_trace(cfg), "bf16", spec="ngram",
        spec_k=4)
    if not rep["paged"]:
        raise AssertionError(f"{label}: not paged")
    _check_spec_launches(label, eng, out["spec_ngram"], ("flash_append",))
    _print_run(label, rep, out["spec_ngram"], ("speculative",))
    _near_tie_check(label, cfg, params, _phase5_trace(cfg), toks,
                    want_tokens)

    t0 = time.perf_counter()
    make_trace, info = _spec_probe_trace(cfg, params)
    print(f"spec probe: {json.dumps(info)} "
          f"({time.perf_counter() - t0:.1f} s)")
    recs, toks = {}, {}
    for turn, spec in enumerate(("off", "ngram", "ngram", "off")):
        label = f"spec yi-6b probed trace {spec} turn {turn}"
        kw = {} if spec == "off" else dict(spec=spec, spec_k=6)
        rep, counts, eng, toks[turn] = _serve(label, cfg, params,
                                              make_trace(), "bf16", **kw)
        if spec == "off":
            _check_serving_run(label, rep, counts, "bf16", False,
                               paged=True)
        else:
            _check_spec_launches(label, eng, counts, ("flash_append",))
            out[f"spec_probe_ngram_{turn}"] = counts
        recs[turn] = rep
        print(f"{label}: " + json.dumps(
            {k: rep[k] for k in SPEC_REPORT_KEYS if k in rep}))
    for turn in (1, 2, 3):
        _near_tie_check(f"spec probed trace turn {turn} vs turn 0", cfg,
                        params, make_trace(), toks[turn], toks[0])
    ratios = [recs[t]["decode_tokens_per_s"] /
              recs[o]["decode_tokens_per_s"] for t, o in ((1, 0), (2, 3))]
    print(f"spec probed trace: decode tokens/s ngram / off "
          f"{ratios[0]:.3f} (turns 1/0), {ratios[1]:.3f} (turns 2/3); "
          f"mean accepted k {recs[1]['speculative']['mean_accepted_k']}, "
          f"{recs[2]['speculative']['mean_accepted_k']}")

    label = "spec yi-6b probed trace draft"
    rep, out["spec_draft"], eng, toks_d = _serve(
        label, cfg, params, make_trace(), "bf16", spec="draft", spec_k=6)
    _check_spec_launches(label, eng, out["spec_draft"],
                         ("flash_append", "flash_append_f32",
                          "decode_attention"))
    print(f"{label}: " + json.dumps(
        {k: rep[k] for k in SPEC_REPORT_KEYS if k in rep}))
    _near_tie_check(label, cfg, params, make_trace(), toks_d, toks[0])
    return out


class _WrongDraft:
    """Drafts that are always wrong: every round rejects its whole tail."""

    kind = "wrong"

    def __init__(self, vocab):
        self.vocab = vocab

    def propose_one(self, history, k):
        last = int(history[-1])
        return [(last + 7 * (i + 1)) % self.vocab for i in range(k - 1)]

    def admit(self, req, j):
        pass

    def reset(self):
        pass


def check_spec_reduced(devices=("cpu", "cuda")):
    """Phase 5s (d): reduced Yi-6B in f32 on the card against the CPU, each
    a path of its own: n-gram drafts on the paged layout (a shared
    prefix), on an int8 contiguous cache, the draft model, sampled n-gram,
    and always-wrong drafts under optimistic admission on 16-row pages
    (rejected pages rewound).  Tokens, speculative and page counters
    identical, margin-qualified (>= 1e-3 along the CPU's tokens), and a
    paged run's books balanced.  Returns the card runs' counts by path."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("yi-6b").reduced()
    params = M.init_params(cfg, 0, "cpu")

    def trace(seed, shared=0):
        rng = np.random.default_rng(seed)
        pre = rng.integers(0, cfg.vocab_size, shared).astype(np.int32)
        return [serve.Request(rid=i, prompt=np.concatenate([pre, rng.integers(
            0, cfg.vocab_size, int(rng.integers(8, 20))).astype(np.int32)]),
            max_new=16 - 2 * (i % 3), arrival=0.0) for i in range(4)]
    # (path, trace seed, shared prefix, engine, the card run's arms)
    cases = (
        ("spec_reduced_ngram_paged", 3, 32,
         dict(spec="ngram", cache_len=128, chunk=32, page_size=32),
         ("flash_append_f32",)),
        ("spec_reduced_ngram_int8", 3, 0,
         dict(spec="ngram", cache_len=64, chunk=16, kv_dtype="int8"),
         ("flash_append_int8_f32",)),
        ("spec_reduced_draft", 3, 0,
         dict(spec="draft", spec_k=3, cache_len=64, chunk=16),
         ("flash_append_f32", "decode_attention")),
        ("spec_reduced_sampled", 3, 0,
         dict(spec="ngram", cache_len=64, chunk=16, sample=True),
         ("flash_append_f32",)),
        ("spec_reduced_wrong_optimistic", 3, 0,
         dict(spec="ngram", spec_k=6, cache_len=64, chunk=16, page_size=16,
              admission="optimistic"), ("flash_append_f32",)),
    )
    keys = SPEC_KEYS + ("pages_requested", "pages_alloced", "cow_events",
                        "preemptions", "step_count")
    out = {}
    for path, seed, shared, kw, arms in cases:
        runs = {}
        for dev in devices:
            tr = trace(seed, shared)
            eng = serve.ServeEngine(
                cfg, M.tree_map(lambda t: t.to(dev), params), n_slots=2,
                seed=0, device=dev, **{"sample": False, **kw})
            if path.endswith("wrong_optimistic"):
                eng.draft_src = _WrongDraft(cfg.vocab_size)
            dispatch.reset_launch_counts()
            rep = serve.serve_trace(eng, tr)
            counts = dispatch.launch_counts()
            if not rep["logits_finite"] or rep["requests"] != len(tr):
                raise AssertionError(f"{path} {dev}: unfinished or "
                                     "non-finite")
            if eng.paged:
                _check_books(f"{path} {dev}", eng)
            runs[dev] = ({r.rid: list(r.tokens) for r in tr},
                         {k: getattr(eng, k) for k in keys})
            if dev == devices[0]:
                key = prng.key(0) if kw.get("sample") else None
                margin = serve.min_accept_margin(cfg, params, tr,
                                                 kw["cache_len"], key=key,
                                                 device="cpu")
        if margin < 1e-3:
            raise AssertionError(f"{path}: near tie (margin {margin})")
        card, cpu = (runs[d] for d in devices[::-1])
        if card != cpu:
            raise AssertionError(f"{path}: card {card} != CPU {cpu}")
        if path.endswith("wrong_optimistic") and \
                cpu[1]["spec_pages_rewound"] <= 0:
            raise AssertionError(f"{path}: no page rewound")
        _check_attention_arms(path, counts, arms)
        out[path] = counts
        c = cpu[1]
        print(f"check {path} cuda vs cpu: tokens and counters identical "
              f"(rounds {c['spec_rounds']}, drafted {c['spec_drafted']}, "
              f"accepted {c['spec_drafts_accepted']}, pages rewound "
              f"{c['spec_pages_rewound']}), margin {margin:.4g} (>= 1e-3)"
              f"{', paged, books balanced' if eng.paged else ''} ok")
    return out


def _profile(label, fn, wall_ms=None, watch=(), steps=None, gather=(),
             host=True):
    """Device busy share of ``fn`` from a torch.profiler trace: the summed
    time of the kernels it ran (one stream, so they do not overlap) over
    its wall time without the profiler (``wall_ms``, or one more run of
    ``fn``), the kernels that took the most device time, the kernels whose
    names hold one of ``watch`` wherever they rank, and (with ``host``) the
    host ops that took the most host time; ``host=False`` traces the device
    only, which a step of tens of thousands of host ops makes far cheaper
    to collect.  With ``steps``, the kernels launched a step and the
    device time of those whose names hold one of ``gather``.  Returns
    {kernel name: (launches, device ms)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    plain_wall = wall_ms
    if plain_wall is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t_trace = time.perf_counter()
    kernels, ops = _trace_tables(prof)
    if not host:
        ops = {}
    busy = sum(ms for _, ms in kernels.values())
    print(f"profile {label}: wall_ms={plain_wall:.2f} (profiled "
          f"{wall:.2f}) device_busy_ms={busy:.2f} busy_share="
          f"{busy / plain_wall:.3f} (of the profiled wall "
          f"{busy / wall:.3f})")
    if steps:
        n = sum(c for c, _ in kernels.values())
        g = [v for k, v in kernels.items() if any(w in k for w in gather)]
        print(f"profile {label}: kernels_per_step={n / steps:.1f} "
              f"gather_ms={sum(ms for _, ms in g):.3f}"
              f" ({sum(c for c, _ in g)} launches)")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    for rank, (key, (count, ms)) in enumerate(ranked):
        if rank < 8 or any(w in key for w in watch + tuple(gather)):
            print(f"profile {label}: #{rank + 1:<3d}{ms:8.2f} ms "
                  f"x{count:<5d} {key[:90]}")
    # where the host spends a host-bound window (profiled: inflated by the
    # profiler's own cost, so read the shares, not the times)
    total = sum(ms for _, ms in ops.values())
    for key, (count, ms) in sorted(ops.items(),
                                   key=lambda kv: -kv[1][1])[:6]:
        print(f"profile {label}:   host {ms:8.2f} ms of {total:.2f} "
              f"x{count:<6d} {key[:60]}")
    print(f"profile {label}: trace read in "
          f"{time.perf_counter() - t_trace:.2f} s")
    return kernels


def _trace_tables(prof):
    """The trace's device kernels and host ops, read from the profiler's
    raw events (``key_averages`` builds a Python object an event and
    their tree, which holds the host for seconds on a window of a few
    decode steps): {kernel name:
    (launches, device ms)} (each kernel's own span: no kernel has
    children) and {host op name: (calls, self ms)}, an op's self time
    being its span less its direct children's on its thread, as
    ``key_averages``' ``self_cpu_time_total`` counts it."""
    import torch
    from torch.autograd.profiler import _filter_name
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels, ops, spans = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        kind = e.device_type()
        if kind == cuda:
            c, ms = kernels.get(name, (0, 0.0))
            kernels[name] = (c + 1, ms + e.duration_ns() / 1e6)
        elif kind == cpu and not e.is_async() and \
                e.start_thread_id() == e.end_thread_id():
            spans.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), name))
    for rows in spans.values():
        rows.sort()
        # [end, name, span, children's ns, children, last child's name]
        stack = []
        for start, neg_end, name in rows:
            end = -neg_end
            while stack and stack[-1][0] <= start:
                _close(stack.pop(), ops)
            if stack:
                stack[-1][3] += end - start
                stack[-1][4] += 1
                stack[-1][5] = name
            stack.append([end, name, end - start, 0, 0, None])
        while stack:
            _close(stack.pop(), ops)
    return kernels, ops


def _close(span, ops):
    """Count a closed span in ``ops``; an op whose one child has its own
    name (``aten::sum`` calling its overload) counts once, as
    ``key_averages`` folds the two."""
    _, name, ns, children_ns, children, child = span
    c, ms = ops.get(name, (0, 0.0))
    ops[name] = (c + 1 - (children == 1 and child == name),
                 ms + (ns - children_ns) / 1e6)


def _profile_diff(label, a, b, steps):
    """The kernels whose launches differ between two profiles of
    ``steps`` steps (what one layout adds to the other's step): launches
    and device ms a step of each."""
    for key in sorted(set(a) | set(b),
                      key=lambda k: -abs(a.get(k, (0, 0))[1]
                                         - b.get(k, (0, 0))[1])):
        (na, ta), (nb, tb) = a.get(key, (0, 0.0)), b.get(key, (0, 0.0))
        if na != nb:
            print(f"profile {label}: x{na / steps:<6.1f} {ta / steps:.4f} "
                  f"ms vs x{nb / steps:<6.1f} {tb / steps:.4f} ms a step "
                  f"{key[:80]}")


def profile_engine(cfg, params, label, **engine_kw):
    """Where a full-width engine step spends its time: one admission of
    four prompts (chunked prefill) and eight decode steps of four slots,
    on an engine built with ``engine_kw`` (kv dtype, decode_cp, paged).
    Returns the decode window's kernels (``_profile``)."""
    from repro_torch.launch import serve
    eng = serve.ServeEngine(cfg, params, n_slots=4, cache_len=1024,
                            chunk=128, sample=False, device="cuda",
                            **engine_kw)
    reqs = iter(serve.gen_trace(8, vocab=cfg.vocab_size,
                                prompt_range=(64, 600), gen_range=(64, 64),
                                arrival_rate=0.0, seed=1))
    # each call admits four fresh requests into the four slots, emptied
    # first, through the scheduler (which reserves a paged engine's pages)
    watch = ("append_", "decode_split", "decode_combine")
    # the paged arms' page gathers (index_select's CUDA kernels)
    gather = ("vectorized_gather_kernel", "indexSelect")

    def admit():
        for j in range(4):
            if eng.req_of[j] is not None:
                eng._vacate(j)
            eng.enqueue(next(reqs))
        eng.admit(eng.schedule_admissions(0.0), 0.0)
    _profile(f"{label} admission of 4 prompts", admit, watch=watch)
    for _ in range(2):
        eng.decode_step_all()

    def decode():
        for _ in range(8):
            eng.decode_step_all()
    return _profile(f"{label} 8 decode steps x 4 slots", decode,
                    watch=watch, steps=8, gather=gather)


def check_cp_reduced():
    """Phase 6c: reduced Yi-6B on the card, greedy, 6 requests: the engine
    under decode_cp[1] emits the tokens of the engine without it, with an
    int8 and with a bf16 cache (one rank: the partials kernel and the
    combine compute kernel 6's arithmetic).  Each of the four runs is its
    own path, with the counters set to 0 just before it and read just
    after; returns {path: counts}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("yi-6b").reduced()
    params = M.init_params(cfg, 0, "cuda")
    counts = {}
    for kv in ("int8", "bf16"):
        tokens = {}
        for cp in (False, True):
            path = f"reduced_{kv}" + ("_cp" if cp else "")
            trace = serve.gen_trace(6, vocab=cfg.vocab_size,
                                    prompt_range=(3, 20), gen_range=(1, 8),
                                    arrival_rate=0.0, seed=5)
            dispatch.reset_launch_counts()
            rep = serve.run_engine(cfg, params, trace, n_slots=2,
                                   cache_len=32, chunk=8, sample=False,
                                   seed=0, kv_dtype=kv, device="cuda",
                                   decode_cp=cp)
            counts[path] = dispatch.launch_counts()
            if not rep["logits_finite"]:
                raise AssertionError(f"{path}: non-finite logits")
            _check_serving_run(path, rep, counts[path], kv, cp,
                               bf16_q=False)
            tokens[cp] = {r.rid: list(r.tokens) for r in trace}
        if tokens[True] != tokens[False]:
            raise AssertionError(f"reduced yi-6b {kv}: decode_cp[1] tokens "
                                 f"{tokens[True]} != {tokens[False]}")
        print(f"check reduced yi-6b {kv} KV decode_cp[1] vs replicated: "
              f"{sum(len(t) for t in tokens[True].values())} greedy tokens "
              "identical, each run through its own kernels ok")
    return counts


def check_sampled_reduced():
    """Phase 6d: reduced Yi-6B in f32, sampled (the threefry streams of
    seed 0), the same trace as 6c: the engine on the card emits the tokens
    of the engine on the CPU.  Identity is margin-qualified: the smallest
    top-2 gap of logits plus Gumbel noise along the CPU run's streams
    (``serve.min_accept_margin``) must be at least 1e-3, far above the
    card's and the CPU's logit difference.  The card's run is its own path
    (the f32 append arm and kernel 6's float arm); returns its counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("yi-6b").reduced()
    params = M.init_params(cfg, 0, "cpu")
    engine = dict(n_slots=2, cache_len=32, chunk=8, sample=True, seed=0)
    tokens = {}
    for dev in ("cpu", "cuda"):
        trace = serve.gen_trace(6, vocab=cfg.vocab_size, prompt_range=(3, 20),
                                gen_range=(1, 8), arrival_rate=0.0, seed=5)
        dispatch.reset_launch_counts()
        rep = serve.run_engine(cfg, M.tree_map(lambda t: t.to(dev), params),
                               trace, device=dev, **engine)
        counts = dispatch.launch_counts()
        if not rep["logits_finite"]:
            raise AssertionError(f"sampled reduced {dev}: non-finite logits")
        tokens[dev] = {r.rid: list(r.tokens) for r in trace}
        if dev == "cpu":
            margin = serve.min_accept_margin(
                cfg, params, trace, engine["cache_len"], key=prng.key(0),
                device="cpu")
    _check_serving_run("sampled reduced yi-6b f32 cuda", rep, counts, "f32",
                       False, bf16_q=False)
    if margin < 1e-3:
        raise AssertionError(f"sampled reduced: the trace has a near tie "
                             f"(margin {margin}); identity is undecided")
    if tokens["cuda"] != tokens["cpu"]:
        raise AssertionError(f"sampled reduced: card tokens {tokens['cuda']}"
                             f" != CPU tokens {tokens['cpu']}")
    print(f"check sampled reduced yi-6b f32 engine cuda vs cpu: "
          f"{sum(len(t) for t in tokens['cuda'].values())} sampled tokens "
          f"identical, margin {margin:.4g} (>= 1e-3) ok")
    return counts


# ---------------------------------------------------------------------------
# phases 7 and 8: the learner
# ---------------------------------------------------------------------------

def check_train_small(cfg=None, label="train reduced yi-6b f32"):
    """A reduced model in f32 (Yi-6B's unless ``cfg``): three train steps
    on the card (kernels) against the same steps on the CPU (plain
    versions), from the same parameters and batches (an encoder-decoder's
    with ``enc_frames`` from a seed).  The card's steps are a path of
    their own: they launch the flash kernels' f32 arms and not their bf16
    arms (a model without attention, neither).  Returns their launch
    counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import llm_a3c, prng
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    cfg = cfg or get_config("yi-6b").reduced()
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=128, global_batch=2,
                         device="cpu")
    batches = [pipe.batch(prng.key(0), i) for i in range(3)]
    if cfg.is_encdec:
        gen = torch.Generator().manual_seed(0)
        for b in batches:
            b["enc_frames"] = 0.5 * torch.randn(
                (2, cfg.encoder_seq, cfg.d_model), generator=gen)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = M.tree_map(lambda t: t.to(dev),
                            M.init_params(cfg, 0, "cpu"))
        opt = opt_mod.shared_rmsprop()
        state = opt.init(params)
        step = llm_a3c.make_train_step(cfg, opt)     # lr0 7e-4
        losses, auxes = [], []
        dispatch.reset_launch_counts()
        for i, b in enumerate(batches):
            b = {k: v.to(dev) for k, v in b.items()}
            params, state, met = step(params, state, b, i)
            losses.append(float(met["loss"]))
            auxes.append(float(met["aux"]))
        counts = dispatch.launch_counts()
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              M.flatten(params).items()}, auxes)
    (loss_c, par_c, aux_c), (loss_g, par_g, aux_g) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c))
    par_err = 0.0
    for k, want in par_c.items():
        got = par_g[k]
        par_err = max(par_err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{label}: {k} differs on the card by "
                                 f"{float((got - want).abs().max())}")
    if loss_err > 1e-4:
        raise AssertionError(f"{label}: losses {loss_g} on the card vs "
                             f"{loss_c} on the CPU")
    aux_err = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(aux_g, aux_c))
    if aux_err > 1e-4:
        raise AssertionError(f"{label}: aux {aux_g} on the card vs {aux_c} "
                             "on the CPU")
    if _has_attention(cfg):
        _check_flash_arms(label, counts, "f32")
    else:
        _check_launched(label, counts, ("rmsnorm", "rmsnorm_bwd"),
                        ATTENTION_ARMS)
    print(f"check {label} 3 steps cuda vs cpu: losses "
          f"{[round(x, 4) for x in loss_g]} rel_err={loss_err:.2e} (tol "
          f"1e-4) aux {[round(x, 6) for x in aux_g]} rel_err="
          f"{aux_err:.2e} params max_abs_err={par_err:.2e} "
          f"(rtol=atol=1e-5) ok")
    return counts


FLASH_ARMS = {"bf16": ("flash_attention", "flash_attention_bwd"),
              "f32": ("flash_attention_f32", "flash_attention_bwd_f32")}


def _check_flash_arms(label, counts, arm, per_step=None):
    """A train path launched the flash kernels' ``arm`` (forward and
    backward; exactly ``per_step`` = (forward, backward) launches when
    given) and never the other arm."""
    other = "f32" if arm == "bf16" else "bf16"
    fwd, bwd = FLASH_ARMS[arm]
    got = (counts[fwd], counts[bwd])
    stray = {k: counts[k] for k in FLASH_ARMS[other] if counts[k] != 0}
    if min(got) <= 0 or stray or (per_step is not None and got != per_step):
        raise AssertionError(f"{label}: flash launches {arm} {got} (want "
                             f"{per_step or 'some of each'}), {other} "
                             f"{stray}")
    print(f"check {label}: flash launches {arm} arms {fwd}={got[0]} "
          f"{bwd}={got[1]}, {other} arms none ok")


TRAIN_COUNTERS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                  "flash_attention_bwd", "rmsprop_apply_multi")


TRAIN_ROWS, TRAIN_SEQ = 4, 1024


def _train_loop(cfg, params, rows=TRAIN_ROWS, seq=TRAIN_SEQ, extra=None):
    """A full-width train step on the card: Shared RMSProp over
    ``params`` (f32 masters), ``make_train_step`` at lr0 7e-3 over 100
    steps, TokenPipeline batches of rows x seq tokens from the train CLI's
    key at seed 0, each with ``extra``'s entries (an encoder-decoder's
    frames).  Returns (run, one_step): ``run`` holds the current "params"
    and "state" and each step's "metrics"; ``one_step()`` takes the next
    step."""
    from repro_torch.core import llm_a3c, prng
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim import optimizers as opt_mod
    opt = opt_mod.shared_rmsprop()
    run = {"params": params, "state": opt.init(params), "metrics": []}
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=seq,
                         global_batch=rows, device="cuda")
    data_key = prng.key(2)                    # the train CLI's at seed 0
    step_fn = llm_a3c.make_train_step(cfg, opt, lr0=7e-3, total_steps=100)

    def one_step():
        step = len(run["metrics"])
        batch = dict(pipe.batch(data_key, step), **(extra or {}))
        run["params"], run["state"], met = step_fn(
            run["params"], run["state"], batch, step)
        run["metrics"].append(met)
    return run, one_step


def _train_make():
    """Phase 8's train step: Yi-6B at full width x 16 layers (bf16
    compute, remat), f32 parameters and Shared RMSProp accumulator made on
    the card from seed 0 (``_train_loop``).  Returns (cfg, run, one_step).
    Also what chip_rl_rounds.py times."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=16,
                              dtype="bfloat16", remat=True)
    return (cfg, *_train_loop(cfg, M.init_params(cfg, 0, "cuda")))


def run_yi6b_train():
    """Yi-6B at full width, 16 of 32 layers (f32 masters, f32 gradients
    and the f32 RMSProp accumulator of all 32 would take 14 B x 6.06e9 =
    84.9 GB): one warm-up, three timed and one profiled train step on
    TokenPipeline batches of 4 x 1024 tokens."""
    import torch
    t0 = time.perf_counter()
    cfg, run, one_step = _train_make()
    torch.cuda.synchronize()
    print(f"train yi-6b x16 layers: {cfg.param_count()} f32 parameters and "
          f"their accumulator built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return _run_train("train yi-6b x16 layers 3 steps",
                      "train yi-6b full width x 16 layers", cfg, run,
                      one_step)


def _run_train(label, title, cfg, run, one_step, *,
               counters=TRAIN_COUNTERS, flash_per_step=None,
               tokens=TRAIN_ROWS * TRAIN_SEQ, profile=True):
    """One warm-up, three timed steps (their launches counted) and one
    profiled step (unless ``profile`` is False) of a full-width train step
    of ``tokens`` tokens.  Gates: every loss and the experts' aux finite
    (aux > 0 where the model has experts), every gradient finite, every
    leaf changed, every kernel of ``counters`` launched, the flash kernels
    through their bf16 arms only, ``flash_per_step`` = (forward, backward)
    launches a step (by default a forward and its remat, one backward a
    layer; (0, 0): none at all), the optimizer's apply mode
    ceil(leaves / 64) times a step and its other entries never.  Returns
    the three steps' counts."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M

    @torch.no_grad()
    def fingerprint():
        return [(float(t.double().sum()), float(t.double().square().sum()))
                for t in M.flatten(run["params"]).values()]

    torch.cuda.reset_peak_memory_stats()
    one_step()                                  # warm-up
    torch.cuda.synchronize()
    before = fingerprint()
    dispatch.reset_launch_counts()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = dispatch.launch_counts()
    after = fingerprint()
    peak = torch.cuda.max_memory_allocated() / 2**30

    loss_vals = [float(m["loss"]) for m in run["metrics"]]
    aux_vals = [float(m["aux"]) for m in run["metrics"]]
    if not all(math.isfinite(x) for x in loss_vals + aux_vals):
        raise AssertionError(f"{label}: non-finite loss {loss_vals} or aux "
                             f"{aux_vals}")
    if cfg.n_experts and min(aux_vals) <= 0:
        raise AssertionError(f"{label}: aux {aux_vals}, want > 0")
    # a non-finite gradient would leave a non-finite accumulator
    bad = [k for k, g in M.flatten(run["state"]["g"]).items()
           if not bool(torch.isfinite(g).all())]
    bad += [k for k, p in M.flatten(run["params"]).items()
            if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite gradients in {bad[:5]}")
    same = [k for k, a, b in zip(M.flatten(run["params"]), before, after)
            if a == b]
    if same:
        raise AssertionError(f"{label}: leaves unchanged by 3 steps: "
                             f"{same}")
    _check_launched(label, counts, counters, ())
    fwd, bwd = flash_per_step or (2 * cfg.n_layers, cfg.n_layers)
    if fwd:
        _check_flash_arms(label, counts, "bf16", (3 * fwd, 3 * bwd))
    else:
        _check_launched(label, counts, (), FLASH_ARMS["bf16"]
                        + FLASH_ARMS["f32"])
    # the optimizer: ceil(leaves / 64) apply launches a step
    _check_rmsprop_launches(
        label, counts, 3 * _per_update(len(M.flatten(run["params"]))),
        others=tuple(counters) + FLASH_ARMS["bf16"] * bool(fwd))
    shown = tuple(counters) + FLASH_ARMS["bf16"] * bool(fwd)
    per_step = {k: counts[k] / 3 for k in dict.fromkeys(shown)}
    wall = statistics.median(walls)
    print(f"{title}: " + json.dumps({
        "losses": loss_vals, "aux": aux_vals, "step_wall_s": walls,
        "step_wall_median_s": wall,
        "tokens_per_s": tokens / wall,
        "peak_device_memory_gib": peak,
        "launches_per_step": per_step}))
    if profile:
        _profile(f"{title} train step", one_step, wall_ms=wall * 1e3,
                 watch=("flash_fwd", "dq_mma", "dkv_mma", "dkv_sum"))
    return counts


# ---------------------------------------------------------------------------
# phase 9: the paper's asynchronous RL loop
# ---------------------------------------------------------------------------

# a discrete draw (an action, a maze cell) repeats across devices where its
# decision margin (prng.margins) is far above the ~1e-6 by which the Gumbel
# noise of the two devices differs
RL_MARGIN = 1e-5
RL_ROUNDS = 3
# the paper's net at full width: conv 16x8x8/4, conv 32x4x4/2, FC 256,
# LSTM 256, on 84 x 84 frames; 16 workers (the paper's thread count)
PAPER_WORKERS = 16
PAPER_TIMED_ROUNDS = 20


def _recording(algo, actions):
    """``algo`` whose act also keeps each step's actions (on the host)."""
    import dataclasses

    def act(params, obs, net_state, keys, eps):
        a, net_state = algo.act(params, obs, net_state, keys, eps)
        actions.append(a.detach().cpu())
        return a, net_state
    return dataclasses.replace(algo, act=act)


def _rl_leaves(params):
    from repro_torch.models import model as M
    return len(M.flatten(params))


def _rl_run(make, dev, steps):
    """Builds a run on ``dev`` with ``make(dev, actions) -> (state, advance,
    leaves)`` and takes ``steps`` calls of ``advance(state) -> (state,
    loss or None)``; on the card the launch counters are set to 0 just
    before the steps and read just after.  Returns the losses, the final
    parameters on the host, the actions, the smallest decision margin, the
    counts and the leaf count."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    actions = []
    with prng.margins() as log:
        state, advance, leaves = make(dev, actions)
        losses = []
        dispatch.reset_launch_counts()
        for _ in range(steps):
            state, loss = advance(state)
            if loss is not None:
                losses.append(loss)
        if dev == "cuda":
            torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        margin = log.smallest()
    losses = [float(x) for x in losses]
    params = {k: v.detach().cpu() for k, v in
              M.flatten(state["params"]).items()}
    return losses, params, actions, margin, counts, leaves


def _per_update(leaves):
    """Launches of the RMSProp kernel an update of ``leaves`` leaves."""
    from repro_torch.kernels import rmsprop_cuda
    return -(-leaves // rmsprop_cuda.MAX_LEAVES)


def _check_rmsprop_launches(label, counts, want, others=()):
    """The run launched the RMSProp kernel's apply mode exactly ``want``
    times, its one-leaf and multi-leaf update entries never, and no kernel
    but those and ``others``."""
    stray = {k: n for k, n in counts.items()
             if k not in ("rmsprop_apply_multi",) + tuple(others) and n}
    if counts["rmsprop_apply_multi"] != want or stray:
        raise AssertionError(f"{label}: rmsprop_apply_multi launched "
                             f"{counts['rmsprop_apply_multi']} times (want "
                             f"{want}), other kernels and entries {stray}")


def _rl_check(label, make, steps, updates, continuous=False):
    """A path of the RL loop on the card against the same path on the
    CPU: actions identical (within 1e-5 for continuous actions) where
    every decision margin of both runs exceeds RL_MARGIN, losses within
    rtol 1e-4 (atol 1e-6), parameters within rtol = atol = 1e-5, and the
    card's run launched the RMSProp kernel's apply mode exactly
    ``updates * _per_update(leaves)`` times and no other kernel or entry
    (no one-leaf launch).  Returns the card's launch counts."""
    import torch
    cpu = _rl_run(make, "cpu", steps)
    gpu = _rl_run(make, "cuda", steps)
    margin = min(cpu[3], gpu[3])
    if not margin > RL_MARGIN:
        raise AssertionError(f"rl {label}: an undecided draw (margin "
                             f"{margin} <= {RL_MARGIN})")
    if len(cpu[2]) != len(gpu[2]) or not cpu[2]:
        raise AssertionError(f"rl {label}: {len(gpu[2])} action steps on "
                             f"the card, {len(cpu[2])} on the CPU")
    for t, (a, b) in enumerate(zip(gpu[2], cpu[2])):
        same = torch.allclose(a, b, rtol=1e-5, atol=1e-5) if continuous \
            else torch.equal(a, b)
        if not same:
            raise AssertionError(f"rl {label}: actions differ at step {t}: "
                                 f"{a.tolist()} vs {b.tolist()}")
    loss_err = 0.0
    for a, b in zip(gpu[0], cpu[0]):
        if abs(a - b) > 1e-6 + 1e-4 * abs(b):
            raise AssertionError(f"rl {label}: losses {gpu[0]} on the card "
                                 f"vs {cpu[0]} on the CPU")
        loss_err = max(loss_err, abs(a - b) / max(abs(b), 1e-12))
    par_err = 0.0
    for k, want in cpu[1].items():
        got = gpu[1][k]
        par_err = max(par_err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"rl {label}: {k} differs on the card by "
                                 f"{float((got - want).abs().max())}")
    counts, leaves = gpu[4], gpu[5]
    _check_rmsprop_launches(f"rl {label}", counts, updates * _per_update(
        leaves))
    print(f"check rl {label} cuda vs cpu: {len(gpu[2])} action steps "
          f"identical (margin {margin:.2e} > {RL_MARGIN:g}), losses "
          f"rel_err={loss_err:.2e} (tol 1e-4), params max_abs_err="
          f"{par_err:.2e} (rtol=atol=1e-5), rmsprop_apply_multi launches "
          f"{counts['rmsprop_apply_multi']} = {updates} updates of {leaves} "
          "leaves ok")
    return counts


def _cli_make(argv):
    """A path through the train CLI's ``build_rl`` and the runner, its
    actions recorded."""
    def make(dev, actions):
        from repro_torch.core import async_runner, prng
        from repro_torch.launch import train
        args = train.parse_args(argv + ["--device", dev])
        algo, env, params, cfg = train.build_rl(args)
        init_state, round_fn = async_runner.make_runner(
            _recording(algo, actions), env, params, cfg)

        def advance(st):
            st, m = round_fn(st)
            return st, m["loss"]
        return init_state(prng.key(args.seed + 1)), advance, \
            _rl_leaves(params)
    return make


# 3 rounds of the CLI's 8 workers x t_max 5
_RL_FRAMES = ["--frames", str(RL_ROUNDS * 8 * 5)]
RL_CLI_PATHS = {
    # label: (CLI arguments, updates a round)
    "a3c": (["--algo", "a3c"], 8),
    "one_step_q": (["--algo", "one_step_q"], 8),
    "one_step_sarsa": (["--algo", "one_step_sarsa"], 8),
    "n_step_q": (["--algo", "n_step_q"], 8),
    "a3c_sync": (["--algo", "a3c", "--runner-mode", "sync"], 1),
    "a3c_per_worker": (["--algo", "a3c", "--per-worker-stats",
                        "--optimizer", "rmsprop"], 8),
    "a3c_pendulum": (["--algo", "a3c", "--env", "pendulum"], 8),
    "a3c_gridmaze": (["--algo", "a3c", "--env", "gridmaze"], 8),
}


def _dqn_make(dev, actions):
    """DQN with replay at the sizes of its JAX test; each frame's action
    read back from the buffer slot it was written to."""
    from repro_torch.core import dqn_replay, prng
    from repro_torch.envs import make
    from repro_torch.envs.api import flatten_obs
    from repro_torch.models import atari as nets
    env = flatten_obs(make("catch"))
    params = nets.init_mlp_agent_params(prng.key(0), env.obs_shape[0],
                                        env.n_actions, hidden=16, device=dev)
    cfg = dqn_replay.DQNConfig(buffer_size=64, batch_size=8, warmup=8,
                               train_every=2, target_interval=16)
    init_state, step_fn = dqn_replay.make_dqn(env, params, cfg)

    def advance(st):
        st = step_fn(st)
        slot = (st["ptr"] - 1) % cfg.buffer_size
        actions.append(st["buffer"]["actions"][slot].cpu())
        return st, None
    return init_state(prng.key(1)), advance, _rl_leaves(params)


def _replay_async_make(dev, actions):
    """Replay inside the Hogwild runner at the sizes of its JAX test."""
    from repro_torch.core import agents, prng, replay_async
    from repro_torch.envs import make
    from repro_torch.envs.api import flatten_obs
    from repro_torch.models import atari as nets
    env = flatten_obs(make("catch"))
    params = nets.init_mlp_agent_params(prng.key(0), env.obs_shape[0],
                                        env.n_actions, hidden=32, device=dev)
    cfg = replay_async.ReplayAsyncConfig(n_workers=4, t_max=5,
                                         buffer_size=64, replay_batch=8,
                                         warmup=16)
    init_state, round_fn = replay_async.make_replay_runner(
        _recording(agents.make_n_step_q(), actions), env, params, cfg)

    def advance(st):
        st, m = round_fn(st)
        return st, m["loss"]
    return init_state(prng.key(1)), advance, _rl_leaves(params)


def check_rl_paths():
    """9a: the CLI's configurations and the two replay modules, 3 rounds
    (DQN 40 frames, replay-async 8 rounds) on the card against the CPU;
    then the CLI itself (``train.main``) on the card, its records and
    parameters against the CLI on the CPU.  Returns each path's counts."""
    import tempfile

    import torch

    from repro_torch import checkpoint
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.models import model as M
    paths = {}
    for label, (argv, per_round) in RL_CLI_PATHS.items():
        paths[f"rl_{label}"] = _rl_check(
            label, _cli_make(["--mode", "rl"] + argv + _RL_FRAMES),
            RL_ROUNDS, RL_ROUNDS * per_round,
            continuous=label == "a3c_pendulum")
    # DQN trains on frames 8, 10, ..., 40: 17 updates
    paths["rl_dqn"] = _rl_check("dqn_replay 40 frames", _dqn_make, 40, 17)
    paths["rl_replay_async"] = _rl_check(
        "replay_async 8 rounds", _replay_async_make, 8, 8 * 4)

    argv = ["--mode", "rl"] + _RL_FRAMES
    runs = {}
    out_dir = os.path.join(ROOT, "build")       # gitignored
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        for dev in ("cpu", "cuda"):
            path = os.path.join(tmp, f"{dev}.npz")
            dispatch.reset_launch_counts()
            out = train.main(argv + ["--device", dev, "--checkpoint", path])
            counts = dispatch.launch_counts()
            like = train.build_rl(train.parse_args(argv + ["--device",
                                                            "cpu"]))[2]
            runs[dev] = (out["history"], M.flatten(
                checkpoint.restore(path, like)), counts)
    (hc, pc, _), (hg, pg, counts) = runs["cpu"], runs["cuda"]
    for a, b in zip(hg, hc):
        if (a["round"], a["frames"], a["ep_ret"]) != \
                (b["round"], b["frames"], b["ep_ret"]) or \
                abs(a["loss"] - b["loss"]) > 1e-6 + 1e-4 * abs(b["loss"]):
            raise AssertionError(f"rl cli: record {a} on the card vs {b}")
    for k, want in pc.items():
        if not torch.allclose(pg[k], want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"rl cli: {k} differs on the card")
    _check_rmsprop_launches("rl cli", counts,
                            RL_ROUNDS * 8 * _per_update(len(pc)))
    print(f"check rl cli (train.main --mode rl, 3 rounds) cuda vs cpu: "
          f"{len(hg)} records identical (loss rtol 1e-4), params rtol=atol="
          f"1e-5, rmsprop_apply_multi launches "
          f"{counts['rmsprop_apply_multi']} ok")
    paths["rl_cli"] = counts
    return paths


def _paper_make(workers):
    """The paper's conv + LSTM net (84 x 84 x 1 Catch frames), A3C, Hogwild
    with Shared RMSProp, t_max 5."""
    def make(dev, acts):
        from repro_torch.core import agents, async_runner, prng
        from repro_torch.envs import catch
        from repro_torch.models import atari as nets
        env = catch.make(84, 84)
        params = nets.init_atari_params(prng.key(0), env.n_actions,
                                        input_hw=84, in_channels=1,
                                        lstm=True, device=dev)
        cfg = async_runner.RunnerConfig(n_workers=workers, t_max=5,
                                        lr0=7e-4, total_frames=10**9)
        algo = agents.make_a3c()
        init_state, round_fn = async_runner.make_runner(
            _recording(algo, acts) if acts is not None else algo, env,
            params, cfg, net_state0=nets.init_lstm_state(1, 256, dev))

        def advance(st):
            st, m = round_fn(st)
            return st, m["loss"]
        return init_state(prng.key(1)), advance, _rl_leaves(params)
    return make


def check_paper_loss():
    """One A3C segment loss and its gradients at the paper's input, 84 x 84
    x 4 frames (conv + LSTM), over 16 workers' trajectories of random
    frames from a seed (one vmap of grad), card against CPU: each worker's
    loss within rtol 1e-4 and each leaf's gradient within 1e-4 of its
    largest |g| on the CPU (the card sums in another order)."""
    import numpy as np
    import torch

    from repro_torch.core import agents, async_runner, prng
    from repro_torch.models import atari as nets
    from repro_torch.models import model as M
    rng = np.random.default_rng(0)
    w, t = PAPER_WORKERS, 5
    traj = {"obs": rng.random((w, t + 1, 84, 84, 4), dtype=np.float32),
            "actions": rng.integers(0, 6, (w, t)),
            "rewards": rng.standard_normal((w, t)).astype(np.float32),
            "dones": rng.random((w, t)) < 0.1,
            "net_state": tuple(0.1 * rng.standard_normal((w, 1, 256))
                               .astype(np.float32) for _ in range(2))}
    algo = agents.make_a3c()
    out = {}
    for dev in ("cpu", "cuda"):
        params = nets.init_atari_params(prng.key(0), 6, input_hw=84,
                                        in_channels=4, lstm=True, device=dev)
        tr = {k: tuple(torch.from_numpy(x).to(dev) for x in v)
              if isinstance(v, tuple) else torch.from_numpy(v).to(dev)
              for k, v in traj.items()}
        grads, metrics = async_runner.worker_grads(
            lambda p, x: algo.segment_loss(p, None, x), params, tr)
        out[dev] = (metrics["loss"].cpu(),
                    {k: g.cpu() for k, g in M.flatten(grads).items()})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    if not torch.allclose(lg, lc, rtol=1e-4, atol=1e-6):
        raise AssertionError(f"rl paper loss: {lg} on the card vs {lc}")
    worst = 0.0
    for k, want in gc.items():
        err = float((gg[k] - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if err > 1e-4 * scale:
            raise AssertionError(f"rl paper loss: grad {k} off by {err} "
                                 f"(largest |g| {scale})")
    print(f"check rl a3c segment loss 16 workers x 84x84x4 conv+lstm cuda vs "
          f"cpu: losses rel_err {float(((lg - lc) / lc).abs().max()):.2e} "
          f"(tol 1e-4), grads worst err/max|g| {worst:.2e} (tol 1e-4) ok")


def run_paper_net():
    """9b: the paper's net at full width on 16 workers: 3 rounds on the
    card against the CPU, then 20 timed rounds and one profiled round."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    counts = _rl_check("paper conv+lstm 84x84 16 workers", _paper_make(
        PAPER_WORKERS), RL_ROUNDS, RL_ROUNDS * PAPER_WORKERS)
    check_paper_loss()
    state, advance, leaves = _paper_make(PAPER_WORKERS)("cuda", None)
    n = sum(t.numel() for t in M.flatten(state["params"]).values())
    for _ in range(2):
        state, _ = advance(state)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    dispatch.reset_launch_counts()
    for _ in range(PAPER_TIMED_ROUNDS):
        t0 = time.perf_counter()
        state, loss = advance(state)
        float(loss)
        walls.append(time.perf_counter() - t0)
    timed = dispatch.launch_counts()
    _check_rmsprop_launches("rl paper net timed rounds", timed,
                            PAPER_TIMED_ROUNDS * PAPER_WORKERS
                            * _per_update(leaves))
    wall = statistics.median(walls)
    frames = PAPER_WORKERS * 5
    print("rl paper net (conv+lstm, 84x84x1 catch, 16 workers, t_max 5, "
          "hogwild, shared rmsprop): " + json.dumps({
              "parameters": n, "leaves": leaves,
              "round_wall_s": walls, "round_wall_median_s": wall,
              "round_wall_min_s": min(walls), "round_wall_max_s": max(walls),
              "frames_per_s": frames / wall,
              "peak_device_memory_gib":
                  torch.cuda.max_memory_allocated() / 2**30,
              "rmsprop_launches_per_round": timed["rmsprop_apply_multi"]
              / PAPER_TIMED_ROUNDS}))

    def one_round():
        nonlocal state
        state, loss = advance(state)
        float(loss)
    _profile("rl paper net round", one_round, wall_ms=wall * 1e3,
             watch=("rmsprop",))
    return counts


def run_quickstart():
    """9c: ``repro_torch.examples.quickstart``'s configuration (A3C, 8
    workers, MLP hidden 64, lr 1e-2, 4001 rounds, Catch) on the card; its
    final average return must beat 0.5, the bar of the example.  Then one
    profiled round (its busy share against the mean round wall)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.examples import quickstart
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    final, _, state = quickstart.train("cuda", log_every=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    leaves = _rl_leaves(state["params"])
    _check_rmsprop_launches("rl quickstart", counts,
                            quickstart.ROUNDS * 8 * _per_update(leaves))
    print("rl quickstart on the card: " + json.dumps({
        "rounds": quickstart.ROUNDS, "frames": state["frames"],
        "wall_s": wall, "frames_per_s": state["frames"] / wall,
        "round_ms": wall / quickstart.ROUNDS * 1e3,
        "final_avg_return": final,
        "rmsprop_launches": counts["rmsprop_apply_multi"]}))
    if not final > quickstart.PASS:
        raise AssertionError(f"rl quickstart: final average return {final} "
                             f"(must beat {quickstart.PASS})")
    print(f"check rl quickstart learns: final average return {final:+.2f} > "
          f"{quickstart.PASS} ok")
    # where a round of the configuration goes: one profiled round of a
    # fresh run, after two
    from repro_torch.core import prng
    init_state, round_fn = quickstart.build("cuda")
    st = init_state(prng.key(1))

    def one_round():
        nonlocal st
        st, m = round_fn(st)
        float(m["loss"])
    for _ in range(2):
        one_round()
    _profile("rl quickstart round", one_round,
             wall_ms=wall / quickstart.ROUNDS * 1e3, watch=("rmsprop",))
    return counts


def check_delayed_sync():
    """9d: T3 delayed sync, 2 groups, merge interval 3, 3 steps of reduced
    Yi-6B in f32 on the card against the CPU (losses rtol 1e-4,
    parameters rtol = atol = 1e-5); on the card the groups drift apart
    before the merge and are identical at it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import delayed_sync, prng
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    cfg = get_config("yi-6b").reduced()
    groups, h = 2, 3
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=128, global_batch=2,
                         device="cpu")
    batches = [[pipe.batch(k, i) for k in prng.split(prng.key(i), groups)]
               for i in range(h)]
    runs = {}
    for dev in ("cpu", "cuda"):
        params = M.tree_map(lambda t: t.to(dev),
                            M.init_params(cfg, 0, "cpu"))
        opt = opt_mod.shared_rmsprop()
        params_g = delayed_sync.replicate(params, groups)
        state_g = [opt.init(p) for p in params_g]
        step = delayed_sync.make_delayed_train_step(
            cfg, opt, n_groups=groups, merge_interval=h, lr=1e-3)
        losses, spreads = [], []
        dispatch.reset_launch_counts()
        for i in range(h):
            b = [{k: v.to(dev) for k, v in bb.items()} for bb in batches[i]]
            params_g, state_g, met = step(params_g, state_g, b, i)
            losses.append(float(met["loss"]))
            spreads.append(max(float((a - c).detach().abs().max())
                               for a, c in zip(
                                   M.flatten(params_g[0]).values(),
                                   M.flatten(params_g[1]).values())))
        counts = dispatch.launch_counts()
        runs[dev] = (losses, spreads, [{k: v.detach().cpu() for k, v in
                                        M.flatten(p).items()}
                                       for p in params_g])
    (lc, _, pc), (lg, sg, pg) = runs["cpu"], runs["cuda"]
    if not (sg[0] > 0 and sg[1] > 0 and sg[2] == 0):
        raise AssertionError(f"rl delayed_sync: group spreads {sg} (want > 0"
                             ", > 0, == 0)")
    for a, b in zip(lg, lc):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"rl delayed_sync: losses {lg} vs {lc}")
    for g in range(groups):
        for k, want in pc[g].items():
            if not torch.allclose(pg[g][k], want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"rl delayed_sync: group {g} {k} "
                                     "differs on the card")
    # one apply launch a group and step; the flash and RMSNorm kernels of
    # the f32 model besides
    _check_rmsprop_launches(
        "rl delayed_sync", counts,
        h * groups * _per_update(len(M.flatten(params_g[0]))),
        others=("rmsnorm", "rmsnorm_bwd", "flash_attention_f32",
                "flash_attention_bwd_f32"))
    print(f"check rl delayed_sync reduced yi-6b f32 2 groups merge every 3, "
          f"cuda vs cpu: losses {[round(x, 4) for x in lg]} (rtol 1e-4), "
          f"params rtol=atol=1e-5, group spreads {sg} ok")
    return counts


# ---------------------------------------------------------------------------
# phase 10: MoE blocks and M-RoPE (Granite-MoE, Llama-4-Scout, Qwen2-VL)
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-1b-a400m"
SCOUT = "llama4-scout-17b-a16e"
QWEN2VL = "qwen2-vl-72b"
# the reduced engines' trace: 6 requests on 4 slots, so slots stand idle
# while others decode; at seed 3 every greedy choice of the CPU run wins by
# >= 1e-3 and every routing choice by >= 1e-5 (at seed 2 Llama-4-Scout's
# routing gap falls to 3.2e-6)
MOE_TRACE = dict(prompt_range=(3, 20), gen_range=(2, 9), arrival_rate=0.0,
                 seed=3)
MOE_ENGINE = dict(n_slots=4, cache_len=32, chunk=8, sample=False, seed=0)


def _reduced(arch, cf=None, **changes):
    """``get_config(arch).reduced()`` with ``changes``, at capacity factor
    ``cf`` when given."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


class _Margins:
    """While an engine serves: the smallest top-2 gap of the logits rows
    its tokens came from (each row's last prompt position in a prefill
    chunk, each occupied slot's row of a decode step) and the smallest gap
    between the k-th and (k+1)-th router probability over every row of
    every MoE call (a routing choice, and so every capacity drop, depends
    on it).  Token identity across devices holds where both are far above
    the ~1e-6 by which the card's and the CPU's values differ."""

    def __init__(self, eng):
        self.eng, self.logit, self.route = eng, math.inf, math.inf

    def __enter__(self):
        import torch

        from repro_torch.models import model as M
        from repro_torch.models import moe
        self.saved = M.prefill_step, M.decode_step, moe.route
        prefill, decode, route = self.saved

        def gap(row):
            top = torch.topk(row.float(), 2).values.double()
            self.logit = min(self.logit, float(top[0] - top[1]))

        def prefill_w(cfg, params, cache, batch, pos0=0, true_len=None):
            out, cache = prefill(cfg, params, cache, batch, pos0, true_len)
            c = batch["tokens"].shape[1]
            for r, n in enumerate(true_len.tolist()):
                if pos0 <= n - 1 < pos0 + c:
                    gap(out["logits"][r, n - 1 - pos0])
            return out, cache

        def decode_w(cfg, params, cache, batch, pos):
            out, cache = decode(cfg, params, cache, batch, pos)
            for j, r in enumerate(self.eng.req_of):
                if r is not None:
                    gap(out["logits"][j, -1])
            return out, cache

        def route_w(probs, k):
            srt = torch.sort(probs, dim=-1, descending=True).values
            if k < probs.shape[1]:
                self.route = min(self.route,
                                 float((srt[:, k - 1] - srt[:, k]).min()))
            return route(probs, k)

        M.prefill_step, M.decode_step, moe.route = prefill_w, decode_w, \
            route_w
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        from repro_torch.models import moe
        M.prefill_step, M.decode_step, moe.route = self.saved


def check_moe_engine_reduced(arch, cf=1.25):
    """Phase 10a's engines: a reduced MoE model in f32 at capacity factor
    ``cf``, greedy, 4 slots on MOE_TRACE (idle slots, padding rows and
    drops compete for expert capacity), on the CPU and on the card: the
    card's tokens are the CPU's, qualified by the CPU run's margins (top-2
    logit gap >= 1e-3, routing gap >= 1e-5).  Returns the card run's
    counts."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = _reduced(arch, cf)
    params = M.init_params(cfg, 0, "cpu")
    tokens = {}
    for dev in ("cpu", "cuda"):
        trace = serve.gen_trace(6, vocab=cfg.vocab_size, **MOE_TRACE)
        eng = serve.ServeEngine(cfg, M.tree_map(lambda t: t.to(dev), params),
                                device=dev, **MOE_ENGINE)
        serve._prepare(eng, trace)
        dispatch.reset_launch_counts()
        done = []
        eng.start_clock()
        if dev == "cpu":
            with _Margins(eng) as margins:
                serve._drain(eng, sorted(trace, key=lambda r: r.arrival), 0,
                             done)
        else:
            serve._drain(eng, sorted(trace, key=lambda r: r.arrival), 0,
                         done)
        counts = dispatch.launch_counts()
        if len(done) != len(trace) or not eng.logits_finite:
            raise AssertionError(f"engine reduced {arch} {dev}: requests "
                                 "unfinished or logits non-finite")
        if min(eng.occupancy) >= 1.0:
            raise AssertionError(f"engine reduced {arch}: no slot was idle")
        tokens[dev] = {r.rid: list(r.tokens) for r in trace}
    label = f"engine reduced {arch} f32 capacity {cf}"
    _check_attention_arms(label, counts,
                          ("flash_append_f32", "decode_attention"))
    if margins.logit < 1e-3 or margins.route < 1e-5:
        raise AssertionError(f"{label}: a near tie along the tokens (logit "
                             f"margin {margins.logit}, routing margin "
                             f"{margins.route}); identity is undecided")
    card, cpu = tokens["cuda"], tokens["cpu"]
    if card != cpu:
        raise AssertionError(f"{label}: card tokens {card} != CPU tokens "
                             f"{cpu}")
    print(f"check {label} cuda vs cpu: "
          f"{sum(len(t) for t in card.values())} greedy tokens "
          f"identical (4 slots, idle ones among them), logit margin "
          f"{margins.logit:.4g} (>= 1e-3), routing margin "
          f"{margins.route:.4g} (>= 1e-5) ok")
    return counts


def check_moe_forward_reduced(arch, cf=None, positions=False):
    """Phase 10a's forward: a reduced model in f32 (tokens, or embeds with
    distinct temporal / height / width positions for M-RoPE), the card's
    logits, value and aux_loss against the CPU's (rtol = atol = 1e-5).
    Returns the card's counts (the flash forward's f32 arm)."""
    import numpy as np
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    cfg = _reduced(arch, cf)
    params = M.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(3)
    b, s = 2, 64
    if positions:
        pos = rng.integers(0, 64, (3, b, s))
        pos[1] = (pos[0] + 1 + rng.integers(0, 32, (b, s))) % 64
        pos[2] = (pos[1] + 1 + rng.integers(0, 16, (b, s))) % 64
        batch = {"embeds": torch.from_numpy((0.02 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)),
            "positions": torch.from_numpy(pos)}
    else:
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, s)))}
    outs = {}
    for dev in ("cpu", "cuda"):
        p = M.tree_map(lambda t: t.to(dev), params)
        dispatch.reset_launch_counts()
        with torch.no_grad():
            out = M.forward(cfg, p, {k: v.to(dev) for k, v in batch.items()})
        counts = dispatch.launch_counts()
        outs[dev] = {k: v.float().cpu() for k, v in out.items()}
    label = f"forward reduced {arch} f32" + \
        (f" capacity {cfg.capacity_factor}" if cfg.n_experts else "") + \
        (" M-RoPE positions" if positions else "")
    errs = {}
    for k in ("logits", "value", "aux_loss"):
        got, want = outs["cuda"][k], outs["cpu"][k]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: non-finite {k} on the card")
        errs[k] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{label}: {k} differs on the card by "
                                 f"{errs[k]}")
    aux = float(outs["cuda"]["aux_loss"])
    if cfg.n_experts and aux < cfg.n_layers:
        raise AssertionError(f"{label}: aux_loss {aux}, want >= 1 a layer")
    _check_flash_fwd_only(label, counts, cfg.n_layers, "f32")
    print(f"check {label} cuda vs cpu: max_abs_err " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()) + " (rtol=atol=1e-5), "
        f"aux_loss {aux:.6f} ok")
    return counts


def check_moe_reduced():
    """Phase 10a: reduced models in f32, card against CPU.  Granite-MoE at
    its reduced capacity factor (8.0, nothing drops) and at 1.25: forward,
    prefill then decode, three train steps; the engines of Granite-MoE and
    Llama-4-Scout at 1.25; Qwen2-VL's forward with M-RoPE positions.
    Returns {path: counts}."""
    counts = {}
    for cf in (None, 1.25):
        tag = "reduced_cf" if cf is None else f"cf{cf}"
        cfg = _reduced(GRANITE, cf)
        counts[f"moe_forward_{tag}"] = check_moe_forward_reduced(GRANITE, cf)
        counts[f"moe_model_{tag}"] = check_model_small(
            cfg, f"model reduced {GRANITE} f32 capacity "
            f"{cfg.capacity_factor}")
        counts[f"moe_train_{tag}"] = check_train_small(
            cfg, f"train reduced {GRANITE} f32 capacity "
            f"{cfg.capacity_factor}")
    for arch in (GRANITE, SCOUT):
        counts[f"moe_engine_{arch.split('-')[0]}"] = \
            check_moe_engine_reduced(arch)
    counts["mrope_forward"] = check_moe_forward_reduced(QWEN2VL,
                                                        positions=True)
    return counts


class _Interference:
    """While an engine serves: counts MoE calls in which a real token lost
    an assignment to capacity while a padding row or an idle slot held a
    slot of the same expert (the only way those rows, whose contents
    differ between the paged and the contiguous layout, reach a real
    token), and the drops of real assignments.  Recomputes each call's
    routing; for diagnosis only (it syncs the host every layer)."""

    def __init__(self, eng):
        self.eng, self.events, self.real_drops, self.calls = eng, 0, 0, 0
        self.mask = None

    def __enter__(self):
        import torch

        from repro_torch.models import model as M
        from repro_torch.models import moe
        self.saved = M.prefill_step, M.decode_step, M.moe_mod.moe_apply
        prefill, decode, apply = self.saved

        def prefill_w(cfg, params, cache, batch, pos0=0, true_len=None):
            c = batch["tokens"].shape[1]
            posn = pos0 + torch.arange(c, device=true_len.device)
            self.mask = posn[None, :] < true_len[:, None]
            return prefill(cfg, params, cache, batch, pos0, true_len)

        def decode_w(cfg, params, cache, batch, pos):
            self.mask = torch.tensor([[r is not None]
                                      for r in self.eng.req_of],
                                     device=batch["tokens"].device)
            return decode(cfg, params, cache, batch, pos)

        def apply_w(p, x, *, top_k, capacity_factor=1.25, act="silu"):
            if self.mask is not None:
                self._watch(p, x, top_k, capacity_factor)
            return apply(p, x, top_k=top_k, capacity_factor=capacity_factor,
                         act=act)

        M.prefill_step, M.decode_step = prefill_w, decode_w
        M.moe_mod.moe_apply = apply_w
        self.moe = moe
        return self

    def _watch(self, p, x, top_k, cf):
        import torch
        t, e = x.shape[0] * x.shape[1], p["router"].shape[1]
        probs = torch.softmax(x.reshape(t, -1).float()
                              @ p["router"].float(), -1)
        _, eidx = self.moe.route(probs, top_k)
        cap = self.moe.capacity(t, top_k, e, cf)
        e_flat = eidx.reshape(-1)
        pos = self.moe.slot_positions(e_flat, e)
        real = self.mask.reshape(-1).repeat_interleave(top_k)
        keep = pos < cap
        lost = torch.zeros(e, dtype=torch.bool, device=x.device)
        lost[e_flat[real & ~keep]] = True
        held = torch.zeros(e, dtype=torch.bool, device=x.device)
        held[e_flat[~real & keep]] = True
        self.calls += 1
        self.real_drops += int((real & ~keep).sum())
        self.events += int((lost & held).any())

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        M.prefill_step, M.decode_step, M.moe_mod.moe_apply = self.saved


def _serve_watched(label, cfg, params, trace, **engine_kw):
    """``trace`` through a new engine with ``_Interference`` on; returns
    (tokens, the watch)."""
    from repro_torch.launch import serve
    eng = serve.ServeEngine(cfg, params, n_slots=4, cache_len=1024,
                            chunk=128, sample=False, seed=0, kv_dtype="bf16",
                            device="cuda", **engine_kw)
    serve._prepare(eng, trace)
    done = []
    eng.start_clock()
    with _Interference(eng) as watch:
        serve._drain(eng, sorted(trace, key=lambda r: r.arrival), 0, done)
    if len(done) != len(trace):
        raise AssertionError(f"{label}: requests unfinished")
    return {r.rid: list(r.tokens) for r in trace}, watch


def run_moe_engine(name, cfg, params, repeat=False):
    """Phases 10b and 10d: phase 5's trace (8 greedy requests; 4 slots,
    cache 1024, chunk 128, bf16 KV) through the engine at full width, on
    the default paged layout and then contiguous, each run held to its
    gates (requests complete, logits finite, the rmsnorm, the append
    kernel's tensor-core arm once a prefill chunk and layer, kernel 6's
    float arm, no other attention arm).  Paged tokens must equal
    contiguous ones wherever the reference's semantics make them equal:
    at the config's capacity factor, a padding row or an idle slot (whose
    contents differ between the layouts) takes expert capacity ahead of
    later rows, so where the tokens differ both runs are repeated under
    ``_Interference`` and a difference must come with such an event.
    Then both layouts again at capacity factor n_experts / top_k, where no
    assignment drops: the tokens must be equal outright.  With
    ``repeat`` the paged run runs twice and must give the same tokens:
    its idle slots and padding rows write the page-0 sink, which idle
    rows read, in a defined order (``attention._write_pool``).  Returns
    ({path: counts}, paged run's report)."""
    import dataclasses

    import torch
    counts, tokens = {}, {}
    for paged in (None, False):
        lay = "paged" if paged is None else "contiguous"
        label = f"engine {name} {lay} bf16"
        trace = _phase5_trace(cfg)
        rep, c, eng, tokens[lay] = _serve(label, cfg, params, trace, "bf16",
                                          paged=paged)
        _check_serving_run(label, rep, c, "bf16", False,
                           paged=paged is None)
        _check_appends(label, c, eng, cfg)
        _print_run(label, rep, c, PAGE_KEYS if paged is None else ())
        counts[f"engine_{name}_{lay}"] = c
        if paged is None:
            report = rep
        torch.cuda.empty_cache()
        if paged is None and repeat:
            again = _serve(label + " again", cfg, params, _phase5_trace(cfg),
                           "bf16", paged=paged)[3]
            if again != tokens[lay]:
                raise AssertionError(f"{name}: two paged runs of one trace "
                                     f"gave different tokens: {again} vs "
                                     f"{tokens[lay]}")
            print(f"check {name} paged, run twice: greedy tokens identical "
                  "(the sink's writes in a defined order) ok")
    same = tokens["paged"] == tokens["contiguous"]
    if same:
        print(f"check {name} paged vs contiguous at capacity "
              f"{cfg.capacity_factor}: greedy tokens identical ok")
    else:
        diff = [rid for rid in tokens["paged"]
                if tokens["paged"][rid] != tokens["contiguous"][rid]]
        watches = {}
        for paged in (None, False):
            lay = "paged" if paged is None else "contiguous"
            _, watches[lay] = _serve_watched(f"{name} {lay} watched", cfg,
                                             params, _phase5_trace(cfg),
                                             paged=paged)
        events = {k: (w.events, w.real_drops, w.calls)
                  for k, w in watches.items()}
        if not any(w.events for w in watches.values()):
            raise AssertionError(f"{name}: paged tokens differ from "
                                 f"contiguous in requests {diff} with no "
                                 f"padding or idle row taking capacity "
                                 f"from a real one: {events}")
        print(f"check {name} paged vs contiguous at capacity "
              f"{cfg.capacity_factor}: requests {diff} differ, each run "
              f"with padding or idle rows holding expert slots that real "
              f"tokens lost (events, real drops, MoE calls: {events}), as "
              f"in the reference ok")
    free = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)
    nodrop = {}
    for paged in (None, False):
        lay = "paged" if paged is None else "contiguous"
        label = f"engine {name} {lay} bf16 capacity {free.capacity_factor}"
        rep, c, _, nodrop[lay] = _serve(label, free, params,
                                        _phase5_trace(cfg), "bf16",
                                        paged=paged)
        _check_serving_run(label, rep, c, "bf16", False,
                           paged=paged is None)
        counts[f"engine_{name}_{lay}_nodrop"] = c
    if nodrop["paged"] != nodrop["contiguous"]:
        raise AssertionError(f"{name}: with no capacity drop paged tokens "
                             f"{nodrop['paged']} != contiguous "
                             f"{nodrop['contiguous']}")
    print(f"check {name} paged vs contiguous at capacity "
          f"{free.capacity_factor} (no drops): greedy tokens identical ok")
    return counts, report


def _check_appends(label, counts, eng, cfg):
    """The append kernel's tensor-core arm ran once a prefill chunk (the
    warm-up's included) and layer."""
    chunks = eng.step_calls["prefill"]
    if counts["flash_append"] != chunks * cfg.n_layers:
        raise AssertionError(f"{label}: flash_append launched "
                             f"{counts['flash_append']} times, want {chunks} "
                             f"chunks x {cfg.n_layers} layers")
    print(f"check {label}: flash_append {chunks} prefill chunks x "
          f"{cfg.n_layers} layers = {counts['flash_append']} launches ok")


def profile_moe_split(cfg, params, label):
    """Device time of a decode step's MoE halves (router, top-k, dispatch,
    the three expert products, combine) against its attention calls
    (projections, RoPE, cache writes, kernel 6), over 8 decode steps of 4
    slots: the kernels under each call, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import serve
    from repro_torch.models import model as M
    eng = serve.ServeEngine(cfg, params, n_slots=4, cache_len=1024,
                            chunk=128, sample=False, device="cuda",
                            kv_dtype="bf16")
    for r in serve.gen_trace(4, vocab=cfg.vocab_size, prompt_range=(64, 600),
                             gen_range=(64, 64), arrival_rate=0.0, seed=1):
        eng.enqueue(r)
    eng.admit(eng.schedule_admissions(0.0), 0.0)
    for _ in range(2):
        eng.decode_step_all()
    apply, attend = M.moe_mod.moe_apply, M.attn.attend_decode

    def moe_w(*a, **k):
        with record_function("moe_half"):
            return apply(*a, **k)

    def attn_w(*a, **k):
        with record_function("attention"):
            return attend(*a, **k)
    M.moe_mod.moe_apply, M.attn.attend_decode = moe_w, attn_w
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                eng.decode_step_all()
            torch.cuda.synchronize()
    finally:
        M.moe_mod.moe_apply, M.attn.attend_decode = apply, attend
    ev = {e.key: e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CPU}
    # the kernels, without the two ranges' own spans on the device
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ("moe_half", "attention")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    moe_ms = ev["moe_half"].device_time_total / 1e3
    attn_ms = ev["attention"].device_time_total / 1e3
    print(f"profile {label} 8 decode steps: moe_half {moe_ms / 8:.4f} device "
          f"ms a step ({ev['moe_half'].count} calls), attention "
          f"{attn_ms / 8:.4f} device ms a step ({ev['attention'].count} "
          f"calls), all kernels {busy / 8:.4f} ms a step; moe share of busy "
          f"{moe_ms / busy:.3f}, attention share {attn_ms / busy:.3f}")
    return moe_ms / 8, attn_ms / 8


def build_full(arch, dtype="bfloat16", **cut):
    """A config at full width (depth cut by ``cut``) and its weights from
    seed 0 made on the card, bf16 (f32 masters with ``dtype="float32"``,
    which serving casts: ``cast_params`` gives the values of bf16 weights
    drawn from the same seed)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), **cut)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, "cuda", getattr(torch, dtype))
    torch.cuda.synchronize()
    print(f"{cfg.name} x{cfg.n_layers} layers: {cfg.param_count()} {dtype} "
          f"params built on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def _granite_train_make():
    """Phase 10c's train step: Granite-MoE at full width and depth (bf16
    compute, remat), f32 parameters and Shared RMSProp accumulator made on
    the card from seed 0 (``_train_loop``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(GRANITE)
    assert cfg.dtype == "bfloat16" and cfg.remat
    return (cfg, *_train_loop(cfg, M.init_params(cfg, 0, "cuda")))


def run_granite_train():
    """Phase 10c: Granite-MoE at full width and depth (1,334,629,376
    parameters: f32 masters, gradients and accumulator about 16 GB), one
    warm-up, three timed and one profiled step."""
    import torch
    t0 = time.perf_counter()
    cfg, run, one_step = _granite_train_make()
    torch.cuda.synchronize()
    print(f"train {GRANITE}: {cfg.param_count()} f32 parameters and their "
          f"accumulator built on the card in {time.perf_counter() - t0:.1f} "
          "s")
    return _run_train(f"train {GRANITE} 3 steps",
                      f"train {GRANITE} full width x 24 layers", cfg, run,
                      one_step)


def run_qwen2vl_forward():
    """Phase 10e: Qwen2-VL-72B at full width cut to 2 of 80 layers, bf16
    weights from seed 0: one forward on embeds (B 2, S 1024) with distinct
    temporal / height / width positions.  Gates: finite logits and value,
    the flash forward's bf16 arm once a layer and no other flash arm.
    Returns its counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    cfg, params = build_full(QWEN2VL, n_layers=2)
    b, s = 2, 1024
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (3, b, s))
    pos[1] = (pos[0] + 1 + rng.integers(0, 2048, (b, s))) % 4096
    pos[2] = (pos[1] + 1 + rng.integers(0, 1024, (b, s))) % 4096
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    batch = {"embeds": _randn((b, s, cfg.d_model), gen, torch.bfloat16,
                              0.02),
             "positions": torch.from_numpy(pos).to("cuda")}
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = M.forward(cfg, params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    label = f"forward {cfg.name} x2 layers M-RoPE"
    for k in ("logits", "value"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{label}: non-finite {k}")
    if out["logits"].shape != (b, s, cfg.vocab_size):
        raise AssertionError(f"{label}: logits {tuple(out['logits'].shape)}")
    _check_flash_fwd_only(label, counts, cfg.n_layers)
    print(f"{label}: " + json.dumps({
        "batch": [b, s], "wall_s": wall,
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "flash_attention": counts["flash_attention"]}))
    del params, out
    return counts


def _check_flash_fwd_only(label, counts, n, arm="bf16"):
    """A forward without gradients: the flash forward's ``arm`` (bf16: the
    tensor cores, f32: SIMT) exactly ``n`` times, one a layer, and no
    other flash arm, forward or backward."""
    want = {k: 0 for k in ("flash_attention", "flash_attention_f32",
                           "flash_attention_bwd", "flash_attention_bwd_f32")}
    name = FLASH_ARMS[arm][0]
    want[name] = n
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: flash launches {got}, want {name} "
                             f"{n} only")
    print(f"check {label}: {name} ({arm} arm) {n} launches, one a layer, no "
          "other flash arm ok")


def run_phase10():
    """Phase 10 (10a-10e); returns {path: counts}."""
    import gc

    import torch
    counts = check_moe_reduced()
    cfg, params = build_full(GRANITE)
    c, _ = run_moe_engine("granite-moe", cfg, params, repeat=True)
    counts.update(c)
    profile_engine(cfg, params, "granite-moe bf16 paged", kv_dtype="bf16")
    profile_moe_split(cfg, params, "granite-moe bf16 paged")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    counts["train_granite_3_steps"] = run_granite_train()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = build_full(SCOUT, n_layers=4)
    c, _ = run_moe_engine("llama4-scout x4", cfg, params)
    counts.update(c)
    profile_moe_split(cfg, params, "llama4-scout x4 bf16 paged")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    counts["forward_qwen2vl_x2"] = run_qwen2vl_forward()
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 11: mamba2 with zamba2's shared block, mLSTM/sLSTM, Whisper
# ---------------------------------------------------------------------------

ZAMBA2, XLSTM, WHISPER = "zamba2-1.2b", "xlstm-1.3b", "whisper-base"
# every attention arm, serving and training
ATTENTION_ARMS = SERVING_ARMS + FLASH_ARMS["bf16"] + FLASH_ARMS["f32"]
# the reduced token-loop engines' trace: 4 requests on 2 slots; at trace
# seed 7 every greedy choice of the CPU runs wins by >= 1e-3
TOKEN_LOOP_TRACE = dict(prompt_range=(3, 6), gen_range=(2, 4),
                        arrival_rate=0.0, seed=7)
TOKEN_LOOP_ENGINE = dict(n_slots=2, cache_len=16, chunk=8, sample=False,
                         seed=0)


def _has_attention(cfg):
    return (cfg.is_encdec or cfg.shared_attn_every
            or any(k in ("attn", "attn_local") for k in cfg.layer_kinds()))


def _check_exact(label, counts, want):
    """The counters of ``want`` launched exactly as many times."""
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def _frames(cfg, b, gen, dtype, device):
    """Stub encoder frames (B, encoder_seq, d_model) from a generator."""
    import torch
    x = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                    device=gen.device)
    return (0.5 * x).to(device=device, dtype=dtype)


def check_recurrent_model_small(cfg, label):
    """Phase 11a's model check: a reduced model in f32, the card's forward
    logits and values and 16 decode steps' logits (per-slot positions; an
    encoder-decoder after ``prefill_cross``) against the CPU's (rtol = atol
    = 1e-4).  The card's run launches kernel 1 (but for Whisper, whose
    norms are LayerNorms), the flash forward's f32 arm where the model has
    attention (zamba2's shared block, Whisper's encoder and decoder) and
    kernel 6's float arm where it decodes against a KV cache, and no other
    attention arm.  Returns its counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    params = M.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    frames = _frames(cfg, 2, torch.Generator().manual_seed(0),
                     torch.float32, "cpu") if cfg.is_encdec else None
    outs = {}
    for dev in ("cpu", "cuda"):
        p = M.tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": toks.to(dev)}
        if frames is not None:
            batch["enc_frames"] = frames.to(dev)
        dispatch.reset_launch_counts()
        with torch.no_grad():
            out = M.forward(cfg, p, batch)
            seq = [out["logits"], out["value"]]
            cache = M.init_cache(cfg, 2, 48, dtype=torch.float32, device=dev)
            if frames is not None:
                encdec.prefill_cross(cfg, p, cache, batch["enc_frames"])
            for i in range(16):
                pos = torch.tensor([i, i], device=dev)
                out, cache = M.decode_step(
                    cfg, p, cache, {"tokens": batch["tokens"][:, i:i + 1]},
                    pos)
                seq.append(out["logits"])
        counts = dispatch.launch_counts()
        outs[dev] = [t.float().cpu() for t in seq]
    err = 0.0
    for a, b in zip(outs["cuda"], outs["cpu"]):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite logits on the card")
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{label}: card vs CPU logits differ by "
                                 f"{err}")
    want = () if cfg.is_encdec else ("rmsnorm",)
    if _has_attention(cfg):
        want += ("flash_attention_f32", "decode_attention")
    _check_launched(label, counts, want, ATTENTION_ARMS)
    print(f"check {label} forward + 16 decode steps cuda vs cpu: "
          f"max_abs_err={err:.3e} tol=1e-4, launches "
          f"{ {k: counts[k] for k in want} } ok")
    return counts


def check_recurrent_engine_reduced(cfg, label):
    """Phase 11a's engines: a reduced recurrent model in f32, greedy, 4
    requests on 2 slots admitted through the token loop, on the CPU and on
    the card: the card's tokens are the CPU's, qualified by the CPU run's
    top-2 margin (>= 1e-3).  Returns the card run's counts."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    params = M.init_params(cfg, 0, "cpu")
    tokens = {}
    for dev in ("cpu", "cuda"):
        trace = serve.gen_trace(4, vocab=cfg.vocab_size, **TOKEN_LOOP_TRACE)
        p = M.tree_map(lambda t: t.to(dev), params)
        eng = serve.ServeEngine(cfg, p, device=dev, **TOKEN_LOOP_ENGINE)
        serve._prepare(eng, trace)
        dispatch.reset_launch_counts()
        done = []
        eng.start_clock()
        serve._drain(eng, sorted(trace, key=lambda r: r.arrival), 0, done)
        counts = dispatch.launch_counts()
        if len(done) != len(trace) or not eng.logits_finite or eng.paged \
                or eng.prefill_step is not None:
            raise AssertionError(f"{label} {dev}: requests unfinished, "
                                 "logits non-finite, or not the token loop")
        tokens[dev] = {r.rid: list(r.tokens) for r in trace}
        if dev == "cpu":
            margin = serve.min_accept_margin(
                cfg, params, trace, TOKEN_LOOP_ENGINE["cache_len"],
                device="cpu")
    if margin < 1e-3:
        raise AssertionError(f"{label}: a near tie along the tokens (margin "
                             f"{margin}); identity is undecided")
    if tokens["cuda"] != tokens["cpu"]:
        raise AssertionError(f"{label}: card tokens {tokens['cuda']} != CPU "
                             f"tokens {tokens['cpu']}")
    want = ("rmsnorm",) + (("decode_attention",) if _has_attention(cfg)
                           else ())
    _check_launched(label, counts, want, ATTENTION_ARMS)
    print(f"check {label} cuda vs cpu: "
          f"{sum(len(t) for t in tokens['cuda'].values())} greedy tokens "
          f"identical through the token loop, margin {margin:.4g} (>= 1e-3)"
          f", launches { {k: counts[k] for k in want} } ok")
    return counts


def check_recurrent_reduced():
    """Phase 11a: reduced zamba2, xlstm, xlstm with the ("mlstm",
    "slstm") cycle and Whisper in f32, card against CPU: forward and
    decode, three train steps, and the token-loop engine (not Whisper, which
    the engine does not serve).  Returns {path: counts}."""
    counts = {}
    for tag, cfg, cyc in (("zamba2", _reduced(ZAMBA2), ""),
                          ("xlstm", _reduced(XLSTM), ""),
                          ("xlstm_mixed", _reduced(
                              XLSTM, block_cycle=("mlstm", "slstm")),
                           " (mlstm, slstm) cycle"),
                          ("whisper", _reduced(WHISPER), "")):
        label = f"reduced {cfg.name}{cyc} f32"
        counts[f"rec_model_{tag}"] = check_recurrent_model_small(
            cfg, f"model {label}")
        counts[f"rec_train_{tag}"] = check_train_small(cfg, f"train {label}")
        if not cfg.is_encdec:
            counts[f"rec_engine_{tag}"] = check_recurrent_engine_reduced(
                cfg, f"engine {label}")
    return counts


def _recurrent_trace(cfg):
    """Phase 5's 8 requests and generations (16-48 tokens) with prompts cut
    from 64-600 to 16-64 tokens: the token loop runs a decode step a prompt
    token."""
    from repro_torch.launch import serve
    return serve.gen_trace(8, vocab=cfg.vocab_size, prompt_range=(16, 64),
                           gen_range=(16, 48), arrival_rate=0.0, seed=0)


def run_recurrent_engine(name, cfg, masters):
    """Phases 11b and 11c's serving: ``_recurrent_trace`` through the
    engine at full width (4 slots, cache 1024, bf16 weights and KV), every
    request admitted through the token loop.  Gates: every request
    completes, logits finite, contiguous, kernel 1 launched, kernel 6's
    float arm where the model has attention (zamba2's shared block) and no
    other attention arm.  Then one decode step's launches and the profile
    of 8 decode steps (``_profile_decode_step``).  Returns the run's
    counts."""
    import torch

    from repro_torch.models import model as M
    params = M.cast_params(cfg, masters)
    label = f"engine {name} bf16 token loop"
    rep, counts, eng, _ = _serve(label, cfg, params, _recurrent_trace(cfg),
                                 "bf16")
    if rep["paged"] or rep["chunked_prefill"] or \
            rep["decode_layout"] != "replicated" or rep["kv_dtype"] != "bf16":
        raise AssertionError(f"{label}: paged {rep['paged']}, chunked "
                             f"{rep['chunked_prefill']}, layout "
                             f"{rep['decode_layout']}, kv {rep['kv_dtype']}")
    want = ("rmsnorm",) + (("decode_attention",) if _has_attention(cfg)
                           else ())
    _check_launched(label, counts, want, ATTENTION_ARMS)
    _print_run(label, rep, counts)
    print(f"{label}: prompts 16-64 tokens (phase 5's 64-600 cut: the token "
          f"loop runs one decode step a prompt token)")
    del eng
    torch.cuda.empty_cache()
    _profile_decode_step(name, cfg, params)
    return counts


def _profile_decode_step(name, cfg, params):
    """One decode step of 4 slots (2-token prompts admitted through the
    token loop): kernel 1's launches, two a recurrent block (its ln1 and
    its gated norm), two a shared-block application (ln1, ln2) and the
    final norm, and kernel 6's, one a shared application; then the
    profile of 8 decode steps (``_profile``)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    eng = serve.ServeEngine(cfg, params, n_slots=4, cache_len=1024,
                            sample=False, device="cuda", kv_dtype="bf16")
    for r in serve.gen_trace(4, vocab=cfg.vocab_size, prompt_range=(2, 2),
                             gen_range=(64, 64), arrival_rate=0.0, seed=1):
        eng.enqueue(r)
    eng.admit(eng.schedule_admissions(0.0), 0.0)
    dispatch.reset_launch_counts()
    eng.decode_step_all()
    got = dispatch.launch_counts()
    apps = cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every \
        else 0
    want = {"rmsnorm": 2 * cfg.n_layers + 2 * apps + 1,
            "decode_attention": apps}
    _check_exact(f"engine {name} one decode step", got, want)
    print(f"check engine {name} one decode step: rmsnorm {want['rmsnorm']} "
          f"launches (2 x {cfg.n_layers} blocks + 2 x {apps} shared + 1), "
          f"decode_attention {apps} ok")

    def decode():
        for _ in range(8):
            eng.decode_step_all()
    _profile(f"{name} bf16 8 decode steps x 4 slots", decode,
             watch=("decode_split", "rmsnorm"), steps=8)


def run_recurrent_train(name, cfg, params, profile=True):
    """Phases 11b and 11c's training: f32 masters, bf16 compute, remat,
    Shared RMSProp, TokenPipeline batches of 4 x 1024 from the train CLI's
    key; one warm-up, three timed steps (and one profiled); phase 8's
    gates with the model's attention count: zamba2's shared block 2 x 6
    forward (a forward and its remat) and 6 backward launches a step,
    xlstm none."""
    run, one_step = _train_loop(cfg, params)
    apps = cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every \
        else 0
    counters = ("rmsnorm", "rmsnorm_bwd", "rmsprop_apply_multi")
    return _run_train(f"train {name} 3 steps",
                      f"train {name} full width x {cfg.n_layers} layers",
                      cfg, run, one_step, counters=counters,
                      flash_per_step=(2 * apps, apps), profile=profile)


def run_whisper():
    """Phase 11d: Whisper-base at full size (f32 masters from seed 0,
    bf16 compute), stub frames (4, 1500, 512) from a seed.
    ``prefill_cross`` (the encoder: kernel 3's bidirectional arm at
    S = 1500, once a layer) and 32 greedy decode steps on 4 rows against a
    448-row cache (kernel 6, once a layer and step); one teacher-forced
    forward at S = 448 (kernel 3 12 times: 6 bidirectional in the encoder,
    6 causal in the decoder); three train steps at B 4, S 448 with the
    frames (kernels 3 and 5, no remat: 12 forward and 12 backward launches
    a step; kernel 8).  Returns {path: counts}."""
    import gc

    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    cfg, masters = build_full(WHISPER, "float32")
    params = M.cast_params(cfg, masters)
    b, s_dec = 4, 448
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = _frames(cfg, b, gen, torch.bfloat16, "cuda")
    counts = {}
    causal_flags = []
    flash = dispatch.flash_attention

    def watched(*a, **k):
        causal_flags.append(k.get("causal", True))
        return flash(*a, **k)
    label = "whisper-base prefill_cross + 32 decode steps"
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    dispatch.flash_attention = watched
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            cache = M.init_cache(cfg, b, s_dec, dtype=torch.bfloat16,
                                 device="cuda")
            encdec.prefill_cross(cfg, params, cache, frames)
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            tok = torch.zeros((b, 1), dtype=torch.long, device="cuda")
            finite = torch.ones((), dtype=torch.bool, device="cuda")
            for i in range(32):
                out, cache = M.decode_step(cfg, params, cache,
                                           {"tokens": tok},
                                           torch.full((b,), i, device="cuda"))
                finite &= torch.isfinite(out["logits"]).all()
                tok = out["logits"][:, -1:].argmax(-1)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = dispatch.launch_counts()
        enc_flags = list(causal_flags)
        causal_flags.clear()
        with torch.no_grad():
            batch = {"tokens": torch.zeros((b, s_dec), dtype=torch.long,
                                           device="cuda"),
                     "enc_frames": frames}
            out = M.forward(cfg, params, batch)
            torch.cuda.synchronize()
        fwd_flags = list(causal_flags)
    finally:
        dispatch.flash_attention = flash
    n = cfg.n_layers
    if not bool(finite) or not bool(torch.isfinite(out["logits"]).all()):
        raise AssertionError(f"{label}: non-finite logits")
    if enc_flags != [False] * cfg.encoder_layers:
        raise AssertionError(f"{label}: flash calls {enc_flags}, want "
                             f"{cfg.encoder_layers} bidirectional")
    _check_exact(label, c, {"flash_attention": cfg.encoder_layers,
                            "decode_attention": 32 * n})
    if fwd_flags != [False] * cfg.encoder_layers + [True] * n:
        raise AssertionError(f"whisper-base forward: flash calls "
                             f"{fwd_flags}, want {cfg.encoder_layers} "
                             f"bidirectional then {n} causal")
    _check_launched(label, c, ("flash_attention", "decode_attention"),
                    ATTENTION_ARMS)
    print(f"{label}: " + json.dumps({
        "prefill_cross_s": t_enc, "decode_steps": 32, "wall_s": wall,
        "decode_tokens_per_s": 32 * b / (wall - t_enc),
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "flash_attention": c["flash_attention"],
        "decode_attention": c["decode_attention"]}))
    print(f"check whisper-base forward ({b} x {s_dec} tokens, "
          f"{cfg.encoder_seq} frames): flash forward {len(fwd_flags)} calls, "
          f"{cfg.encoder_layers} bidirectional (encoder) then {n} causal "
          f"(decoder), logits finite ok")
    counts["whisper_decode"] = c
    del cache, out, params
    gc.collect()
    run, one_step = _train_loop(cfg, masters, b, s_dec,
                                {"enc_frames": frames})
    apps = cfg.encoder_layers + n
    counts["train_whisper_3_steps"] = _run_train(
        "train whisper-base 3 steps", "train whisper-base full size",
        cfg, run, one_step,
        counters=("flash_attention", "flash_attention_bwd",
                  "rmsprop_apply_multi"),
        flash_per_step=(apps, apps), tokens=b * s_dec)
    return counts


def run_phase11():
    """Phase 11 (11a-11d); returns {path: counts}."""
    import gc

    import torch
    t0 = time.perf_counter()
    counts = check_recurrent_reduced()
    print(f"phase rec_reduced_s {time.perf_counter() - t0:.1f}")
    # xlstm-1.3b cut to one 7:1 cycle of its 48 layers, as 12h cuts it:
    # its sLSTM recurrence runs a step a token (about 23 s a train step
    # at all 48 on an H100)
    for name, arch, profile, cut in (
            ("zamba2-1.2b", ZAMBA2, True, {}),
            ("xlstm-1.3b x8", XLSTM, False, {"n_layers": 8})):
        t0 = time.perf_counter()
        cfg, masters = build_full(arch, "float32", **cut)
        counts[f"engine_{name}"] = run_recurrent_engine(name, cfg, masters)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase {name}_serve_s {time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        counts[f"train_{name}_3_steps"] = run_recurrent_train(
            name, cfg, masters, profile=profile)
        del masters
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase {name}_train_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    counts.update(run_whisper())
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase whisper_s {time.perf_counter() - t0:.1f}")
    return counts



# ---------------------------------------------------------------------------
# phase 12: the multi-rank train step
# ---------------------------------------------------------------------------

MR_STEPS = 3
MR_SEQ = 64
MR_TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                    "flash_attention_bwd", "flash_attention_f32",
                    "flash_attention_bwd_f32", "rmsprop_apply_multi")


def _mr_configs():
    """Phase 12's reduced f32 models: yi-6b, stablelm, granite-moe without
    the load-balance loss (the expert-parallel loss averages each shard's,
    the single-process one takes all tokens: ``test_torch_moe_ep.py`` holds
    it to the reference's), and 12g's zamba2, xlstm on the ("mlstm",
    "slstm") cycle (reduced depth drops the sLSTM otherwise) and
    Whisper."""
    import dataclasses

    from repro_torch.configs import get_config
    return {"yi": get_config("yi-6b").reduced(),
            "stablelm": get_config("stablelm-1.6b").reduced(),
            "granite": dataclasses.replace(get_config(GRANITE).reduced(),
                                           aux_loss_weight=0.0),
            "zamba2": get_config(ZAMBA2).reduced(),
            "xlstm": dataclasses.replace(get_config(XLSTM).reduced(),
                                         block_cycle=("mlstm", "slstm")),
            "whisper": get_config(WHISPER).reduced()}


def _mr_cases(n):
    """12a: (path, config, mesh shape, layout) on ``n`` ranks ("fsdp": the
    plan's shards; "whole"); granite-moe's expert-parallel step without
    tensor parallelism only at n = 1 (on a model axis of n > 1 ranks its
    layout is tensor-parallel, which 12e runs)."""
    cases = [("multirank_yi_fsdp", "yi", (n, 1), "fsdp"),
             ("multirank_yi_replicated", "yi", (n, 1), "whole")]
    if n == 1:
        cases.append(("multirank_granite_ep", "granite", (1, 1), "fsdp"))
    return cases


def _mr_tp_cases(n):
    """12e: tensor and sequence parallelism on (1, n) ("tp": asked for even
    at n = 1, a model group of one): reduced yi-6b (one kv head: the
    whole-kv arm at n >= 2), stablelm (layernorm, partial rotary) and
    granite-moe (experts expert-parallel on the sequence rows); at n = 4
    yi and granite again on (2, 2), tensor parallelism with FSDP over
    data."""
    cases = [("multirank_yi_tp", "yi", (1, n), "tp"),
             ("multirank_stablelm_tp", "stablelm", (1, n), "tp"),
             ("multirank_granite_tp", "granite", (1, n), "tp")]
    if n == 4:
        cases += [("multirank_yi_tp_2x2", "yi", (2, 2), "tp"),
                  ("multirank_granite_tp_2x2", "granite", (2, 2), "tp")]
    return cases


def _mr_rec_cases(n):
    """12g: tensor and sequence parallelism of the recurrent and
    encoder-decoder blocks on (1, n), asked for at n = 1: reduced zamba2,
    xlstm on the ("mlstm", "slstm") cycle and Whisper; at n = 4 each
    again on (2, 2), with FSDP over data."""
    archs = ("zamba2", "xlstm", "whisper")
    cases = [(f"multirank_{a}_tp", a, (1, n), "tp") for a in archs]
    if n == 4:
        cases += [(f"multirank_{a}_tp_2x2", a, (2, 2), "tp") for a in archs]
    return cases


def _mr_extra(cfg, rows, dtype=None, device="cpu"):
    """A global batch's entries beside the tokens: an encoder-decoder's
    stub frames (rows, encoder_seq, d_model) from seed 0 (``_frames``),
    in ``dtype`` (f32 by default) on ``device``; none otherwise."""
    import torch
    if not cfg.is_encdec:
        return {}
    gen = torch.Generator(device=device).manual_seed(0)
    return {"enc_frames": _frames(cfg, rows, gen, dtype or torch.float32,
                                  device)}


def _mr_batches(cfg, rows, steps=MR_STEPS, seq=MR_SEQ, key=0):
    """Global TokenPipeline batches on the host."""
    from repro_torch.core import prng
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=seq,
                         global_batch=rows, device="cpu")
    return [pipe.batch(prng.key(key), i) for i in range(steps)]


def _mr_cpu_refs(n):
    """The CPU's single-process references of 12a, 12e and 12g (each
    case's unsharded step on the global batch of 2n rows) and 12d (the list form
    with n groups): {path: (losses, flat parameters)}."""
    from repro_torch.core import delayed_sync, llm_a3c
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    cfgs = _mr_configs()
    refs = {}
    for path, arch, _, _ in _mr_cases(n) + _mr_tp_cases(n) + \
            _mr_rec_cases(n):
        cfg = cfgs[arch]
        params = M.init_params(cfg, 0, "cpu")
        opt = opt_mod.shared_rmsprop()
        state = opt.init(params)
        step = llm_a3c.make_train_step(cfg, opt)
        losses = []
        extra = _mr_extra(cfg, 2 * n)
        for i, b in enumerate(_mr_batches(cfg, 2 * n)):
            params, state, met = step(params, state, dict(b, **extra), i)
            losses.append(float(met["loss"]))
        refs[path] = (losses, {k: v.detach().clone() for k, v in
                               M.flatten(params).items()})
    cfg = cfgs["yi"]
    params_g = delayed_sync.replicate(M.init_params(cfg, 0, "cpu"), n)
    opt = opt_mod.shared_rmsprop()
    state_g = [opt.init(p) for p in params_g]
    step = delayed_sync.make_delayed_train_step(cfg, opt, n_groups=n,
                                                merge_interval=2, lr=1e-3)
    losses = []
    for i, batches in enumerate(_mr_delayed_batches(cfg, n)):
        params_g, state_g, met = step(params_g, state_g, batches, i)
        losses.append(float(met["loss"]))
    refs["multirank_delayed"] = (losses, [
        {k: v.detach().clone() for k, v in M.flatten(p).items()}
        for p in params_g])
    return refs


def _mr_delayed_batches(cfg, n):
    """12d: each step, one batch of 2 rows a group."""
    from repro_torch.core import prng
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=MR_SEQ,
                         global_batch=2, device="cpu")
    return [[pipe.batch(k, i) for k in prng.split(prng.key(i), n)]
            for i in range(MR_STEPS)]


def _shared_apps(cfg):
    """Applications of zamba2's shared block a forward."""
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every \
        else 0


def _remat(cfg):
    """Whether a step recomputes its blocks (the encoder-decoder has no
    remat, as in the reference)."""
    return int(bool(cfg.remat) and not cfg.is_encdec)


def _step_collectives(cfg, lay, mesh):
    """The collectives one train step issues on each rank
    (``llm_a3c.loss_grads`` under ``lay``, None: every leaf whole):
    a gather of each data-sharded leaf (zamba2's shared block's once an
    application), again in the remat recompute for the blocks' leaves;
    its backward's reduce-scatter; an all-reduce of each other leaf's
    gradient and one of the metrics; and for each MoE layer under the
    ``moe_ep`` rule two all-to-alls each way (again in the recompute), the
    router's gradient all-reduce and the load-balance mean's all-reduce
    each way (not recomputed), and where the residual is whole the
    output's all-gather and the input slice's backward all-gather (the
    recompute stops before the former).  Under tensor and sequence
    parallelism (``_tp_collectives``) more."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    paths = list(M.param_shapes(cfg))
    axes = sharding.data_axes(mesh)
    sharded = [p for p in paths if lay is not None
               and any(lay.sharded(p, a) for a in axes)]
    apps = _shared_apps(cfg)

    def uses(p):
        return apps if p.startswith("shared_attn.") else 1
    gathers = sum(uses(p) for p in sharded)
    blocks = sum(uses(p) for p in sharded
                 if p.startswith(("layers.", "shared_attn.")))
    remat = _remat(cfg)
    moe = sum(1 for k in cfg.layer_kinds() if k in ("attn", "attn_local")) \
        if cfg.n_experts else 0
    tp = lay is not None and lay.tp
    out = {"all_gather": gathers + remat * blocks + (0 if tp else 2 * moe),
           "reduce_scatter": gathers,
           "all_reduce": len(paths) - len(sharded) + 1 + 3 * moe,
           "all_to_all": (4 + 2 * remat) * moe}
    if tp:
        for k, v in _tp_collectives(cfg, lay).items():
            out[k] += v
    return out


def _kv_whole(lay):
    """Whether ``lay`` holds the attention's kv leaves whole over the
    model axis (the whole-kv arm)."""
    import re
    path = next((p for p in lay.held if re.search(r"(^|\.)attn\.wk\.w$",
                                                  p)), None)
    return path is not None and not lay.sharded(path, "model")


# a recurrent block's collectives under tensor parallelism, beside its
# ln1 and the gather and scatter around it: (all-gathers of the forward
# (again in the recompute), reduce-scatters, gradient all-reduces)
_REC_TP = {"mamba2": (3, 2, 0),   # B and C, the gated rows, the scale
           "mlstm": (3, 2, 4),    # xc and xi, the normed rows, the scale;
                                  # w_i and w_f's w and b
           "slstm": (1, 1, 2)}    # y; w_in's b and the norm's scale


def _tp_collectives(cfg, lay):
    """What tensor and sequence parallelism adds to a step's collectives:
    the embedding's reduce-scatter to the sequence rows and its backward's
    all-gather (the vocab-parallel lookup; a whole table's slice only the
    latter); an attention block's gather before attention (again in the
    recompute) and its backward's reduce-scatter, the output projection's
    reduce-scatter (again in the recompute) and its backward's all-gather;
    the same pair around a gated MLP, whose reduce-scatter the recompute
    stops before; a recurrent block's gather and scatter as the MLP's,
    and inside it the gathers along the features (``_REC_TP``); the
    encoder-decoder's (no remat) the same around each attention, cross
    attention and MLP (its ``fc2`` bias's gradient all-reduce), and the
    encoder output's gather; the gradient all-reduce of each whole leaf
    used on the rows or on this rank's heads (the norms' leaves, whole kv
    weights and biases, the value head); the values' all-gather; the final
    rows' gather for the LM head, with its backward's reduce-scatter where
    the vocab is split; and for the vocab-parallel loss the max and the
    sums' all-reduce."""
    r = _remat(cfg)
    vocab = lay.sharded("embed.table", "model")
    norm = 2 if cfg.norm == "layernorm" else 1
    value = int(bool(cfg.value_head))
    ag, rs, ar = 1 + value + 1, 2 * vocab, norm + value + 2 * vocab
    if cfg.is_encdec:
        enc, dec = cfg.encoder_layers, cfg.n_layers
        return {"all_gather": ag + 4 * enc + 1 + 6 * dec,
                "reduce_scatter": rs + 4 * enc + 1 + 6 * dec,
                "all_reduce": ar + enc * (2 * norm + 1) + norm
                + dec * (3 * norm + 1)}
    kinds = cfg.layer_kinds()
    attn = sum(1 for k in kinds if k in ("attn", "attn_local")) + \
        _shared_apps(cfg)
    kv = (2 + 2 * bool(cfg.qkv_bias)) if _kv_whole(lay) else 0
    mlp = 0 if cfg.n_experts else 1
    ag += attn * (2 + r + mlp * (2 + r))
    rs += attn * (2 + r + 2 * mlp)
    ar += attn * (2 * norm + kv)
    for kind in kinds:
        if kind in _REC_TP:
            g, s_, a = _REC_TP[kind]
            ag += 2 + r + g * (1 + r)
            rs += 2 + s_
            ar += norm + a
    return {"all_gather": ag, "reduce_scatter": rs, "all_reduce": ar}


def _train_launches(cfg):
    """Launches of kernels 1-5 one train step makes, from its layer
    kinds: two RMSNorms a block (an attention block's two; a recurrent
    block's ln1 and the one inside it; two an application of zamba2's
    shared block) and the final one, forward (again in the remat
    recompute) and backward; one attention an attention block or shared
    application (an encoder-decoder's encoder and decoder layers),
    forward (again in the recompute) and backward; through the arms of
    the compute dtype, the other arms never.  A LayerNorm launches no
    kernel.  It holds the unsharded run's counts where the script has
    one, and stands alone for a mesh run that has none beside it."""
    kinds = cfg.layer_kinds()
    r = 1 + _remat(cfg)
    if cfg.is_encdec:
        attn = cfg.encoder_layers + cfg.n_layers
        blocks = 2 * attn + 1
    else:
        attn = sum(1 for k in kinds if k in ("attn", "attn_local")) + \
            _shared_apps(cfg)
        blocks = len(kinds) + _shared_apps(cfg)
    arm = "bf16" if cfg.dtype == "bfloat16" else "f32"
    other = "f32" if arm == "bf16" else "bf16"
    fwd, bwd = FLASH_ARMS[arm]
    rms = cfg.norm == "rmsnorm"          # a layernorm launches no kernel
    return {"rmsnorm": rms * (2 * blocks * r + 1),
            "rmsnorm_bwd": rms * (2 * blocks + 1),
            fwd: attn * r, bwd: attn, **dict.fromkeys(FLASH_ARMS[other], 0)}


def _fingerprint(params):
    """Per leaf: (sum, sum of squares) in f64 and the sum of its f32 bits as
    int64: equal fingerprints for bit-equal leaves."""
    import torch

    from repro_torch.models import model as M
    out = {}
    with torch.no_grad():
        for k, t in M.flatten(params).items():
            t = t.detach().float()
            out[k] = (float(t.double().sum()),
                      float(t.double().square().sum()),
                      int(t.view(torch.int32).sum(dtype=torch.int64)))
    return out


def _one_rank_params(params, lay):
    """The flat parameters of a run, unsharded or on a one-rank mesh
    (whose shards are the whole leaves: no collective is issued)."""
    from repro_torch.distributed import ctx
    from repro_torch.models import model as M
    if lay is not None and ctx.mesh_devices(lay.mesh) != 1:
        raise ValueError("parameters are compared on one rank only")
    return {k: t.detach() for k, t in M.flatten(params).items()}


def _rel_l2(a, b):
    """The largest relative L2 distance of two parameter trees, leaf by
    leaf: ||a - b|| / ||b||."""
    return max(float((a[k] - b[k]).norm()) / max(float(b[k].norm()), 1e-30)
               for k in b)


def _mr_train(cfg, mesh, held, dev, rows, steps, *, masters=None,
              seq=MR_SEQ, key=0, lr0=7e-4, total=100_000, keep="params",
              profile=None, snapshot=None, against=None, extra=None,
              profile_host=True):
    """``steps`` Shared RMSProp train steps of ``cfg`` on ``dev`` and
    TokenPipeline batches of ``rows`` x ``seq`` from ``prng.key(key)``:
    under ``mesh`` with the parameters held as ``held`` ("fsdp": the plan's
    shards, tensor-parallel where the model axis has more than one rank;
    "tp": tensor-parallel on any model axis; "whole"), or the unsharded
    step without a mesh.  The
    parameters are a copy of ``masters`` (whole, on ``dev``: several runs
    share one draw), or without it seed 0's drawn on the CPU.  Launch,
    collective and route counts are set to 0 just before the steps and
    read just after.  Returns the losses, the walls, the run's own peak
    memory (less what was allocated before it), the counts and the whole
    parameters (``keep`` "params", on the host) or their fingerprint.
    With ``profile`` (a label), one more step follows, profiled on rank 0
    (``_profile``; the other ranks take it plainly, the collectives of a
    mesh run with it).  On one rank, outside the timed walls: with
    ``snapshot`` (k) a copy of the parameters after k steps
    (``out["snapshot"]``, on the card); with ``against`` (k, such a copy)
    their largest leaf's relative L2 distance from it after k steps
    (``out["rel_l2"]``).  ``extra``: global batch entries beside the
    tokens (``_mr_extra``), each step given this rank's rows of them;
    ``profile_host``: ``_profile``'s ``host``."""
    import contextlib
    import gc

    import torch

    from repro_torch.core import llm_a3c, prng
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    shared = masters is not None
    if not shared:
        masters = M.tree_map(lambda t: t.to(dev), M.init_params(cfg, 0,
                                                                "cpu"))
    lay = None
    if held in ("fsdp", "tp"):
        lay = fsdp.layout(cfg, mesh, force_tp=held == "tp")
    if lay is not None:
        params = fsdp.shard(lay, masters)
    else:
        params = M.tree_map(torch.clone, masters) if shared else masters
    del masters
    opt = opt_mod.shared_rmsprop()
    state = opt.init(params)
    step = llm_a3c.make_train_step(cfg, opt, lr0=lr0, total_steps=total,
                                   layout=lay)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=seq,
                         global_batch=rows, device=str(dev), mesh=mesh)
    extra = extra or {}
    if extra and mesh is not None:
        extra = sharding.shard_batch(mesh, extra)
    extra = {k: v.to(dev) for k, v in extra.items()}

    def batch(i):
        return dict(pipe.batch(prng.key(key), i), **extra)
    scope = contextlib.ExitStack()
    if mesh is not None:
        scope.enter_context(ctx.use_mesh(mesh))
        scope.enter_context(ctx.sharding_rules(sharding.activation_rules(
            mesh, batch_size=rows, cfg=cfg)))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    dispatch.reset_launch_counts()
    collectives.reset_counts()
    with scope:
        for i in range(steps):
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch(i), i)
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            if snapshot == i + 1:
                # the run's peak without the copy
                peak = torch.cuda.max_memory_allocated(dev)
                snap = {k: t.clone() for k, t in
                        _one_rank_params(params, lay).items()}
            if against is not None and against[0] == i + 1:
                rel_l2 = _rel_l2(_one_rank_params(params, lay), against[1])
        if snapshot is None:
            peak = torch.cuda.max_memory_allocated(dev)
        out = {"losses": losses, "walls": walls,
               "peak_gib": (peak - base) / 2**30,
               "kernels": dispatch.launch_counts(),
               "collectives": collectives.counts(),
               "routes": dispatch.route_counts(),
               "leaves": len(M.flatten(params)), "layout": lay}
        if snapshot is not None:
            out["snapshot"] = snap
        if against is not None:
            out["rel_l2"] = rel_l2
        bad = [k for k, t in M.flatten(params).items()
               if not bool(torch.isfinite(t).all())]
        if bad or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 12: losses {losses}, non-finite "
                                 f"parameters {bad[:5]}")
        if keep == "params":
            whole = fsdp.full(lay, params) if lay is not None else params
            out["params"] = {k: v.detach().cpu() for k, v in
                             M.flatten(whole).items()}
        else:
            out["fingerprint"] = _fingerprint(params) if lay is None else \
                _fingerprint(fsdp.full(lay, params))
        if profile is not None:
            def one_step():
                step(params, state, batch(steps), steps)
            if torch.distributed.get_rank() == 0:
                _profile(profile, one_step,
                         wall_ms=statistics.median(walls[1:] or walls) * 1e3,
                         watch=("nccl",), host=profile_host)
            else:
                one_step()
                torch.cuda.synchronize(dev)
    del params, state
    return out


def _mr_check_counts(label, run, mesh, cfg, steps, lead, plain=None):
    """Exact counts of a mesh run: each training kernel launched as
    ``_train_launches`` says (and as the unsharded run ``plain`` did,
    where there is one), the optimizer's apply mode once an update, the
    collectives ``_step_collectives`` a step, and the routes
    ``_mr_routes`` a step: the expert-parallel MoE on every MoE layer, and
    under tensor parallelism local-head attention on every layer and the
    norms on the sequence rows (each again in the remat)."""
    want = {k: steps * v for k, v in _train_launches(cfg).items()}
    want["rmsprop_apply_multi"] = steps * _per_update(run["leaves"])
    for name, r in (("the mesh run", run), ("the unsharded run", plain)):
        if r is None:
            continue
        got = {k: r["kernels"][k] for k in MR_TRAIN_KERNELS}
        if got != want:
            raise AssertionError(f"{label}: {name}'s kernel launches {got}, "
                                 f"want {want}")
    per_step = _step_collectives(cfg, run["layout"], mesh)
    want_c = {k: steps * v for k, v in per_step.items()}
    if run["collectives"] != want_c:
        raise AssertionError(f"{label}: collectives {run['collectives']}, "
                             f"want {want_c}")
    want_r = {k: steps * v for k, v in _mr_routes(cfg, run["layout"]).items()}
    routes = {k: run["routes"][k] for k in want_r}
    if routes != want_r:
        raise AssertionError(f"{label}: routes {routes}, want {want_r}")
    if lead:
        held = "mesh and unsharded runs" if plain is not None else \
            "mesh run"
        print(f"check {label}: launches a step " + json.dumps(
            {k: v / steps for k, v in want.items() if v}) + f" ({held}, "
            "from the layer count), collectives a step " + json.dumps(
                per_step) + ", routes a step " + json.dumps(
                {k: v / steps for k, v in routes.items()}) + " exact ok",
            flush=True)


def _mr_routes(cfg, lay):
    """The model layer's routes one train step takes under ``lay``: the
    expert-parallel MoE on every MoE layer and, under tensor parallelism,
    local-head attention on every attention block or application (from
    whole kv leaves where the kv heads do not divide the model axis), the
    residual's norms on the sequence rows (two an attention block, one a
    recurrent block, three a decoder layer of an encoder-decoder, and the
    final one), mamba2 and the xLSTM blocks on local heads with a norm on
    feature-gathered rows each, and cross attention on local heads, the
    blocks' again in the remat recompute."""
    kinds = cfg.layer_kinds()
    r = 1 + _remat(cfg)
    tp = lay is not None and lay.tp
    kv_whole = tp and _kv_whole(lay)
    ssm = sum(1 for k in kinds if k == "mamba2")
    lstm = sum(1 for k in kinds if k in ("mlstm", "slstm"))
    cross = 0
    if cfg.is_encdec:
        enc, dec = cfg.encoder_layers, cfg.n_layers
        attn, cross, ssm = enc + dec, dec, 0
        rows = 2 * enc + 1 + 3 * dec + 1
    else:
        layers = sum(1 for k in kinds if k in ("attn", "attn_local"))
        attn = layers + _shared_apps(cfg)
        rows = (2 * attn + ssm + lstm) * r + 1
    moe = sum(1 for k in kinds if k in ("attn", "attn_local")) \
        if cfg.n_experts else 0
    return {"moe_ep": moe * r, "moe_dense": 0,
            "tp_heads": attn * r * tp, "tp_kv_whole": attn * r * kv_whole,
            "sp_rows": rows * tp, "tp_ssm_heads": ssm * r * tp,
            "tp_lstm_heads": lstm * r * tp,
            "tp_feature_rows": (ssm + lstm) * r * tp,
            "tp_cross": cross * tp}


def _mr_reduced(n, dev, refs, lead, cases):
    """12a: ``_mr_cases``, reduced yi-6b (FSDP and whole) on (n, 1) and,
    at n = 1, reduced granite-moe under ``moe_ep``; 12e: ``_mr_tp_cases``;
    12g: ``_mr_rec_cases``; 3 steps each in f32 on the card against
    the CPU's single-process steps; exact counts against the unsharded
    step on the card."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    cfgs = _mr_configs()
    counts = {}
    for path, arch, shape, held in cases:
        cfg = cfgs[arch]
        mesh = mesh_mod.make_mesh(shape, dev)
        extra = _mr_extra(cfg, 2 * n)
        plain = _mr_train(cfg, None, None, dev, 2 * n, MR_STEPS, extra=extra)
        run = _mr_train(cfg, mesh, held, dev, 2 * n, MR_STEPS, extra=extra)
        ref_losses, ref_params = refs[path]
        err = 0.0
        for k, want in ref_params.items():
            got = run["params"][k]
            err = max(err, float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{path}: {k} differs from the CPU by "
                                     f"{float((got - want).abs().max())}")
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(run["losses"], ref_losses))
        if loss_err > 1e-4:
            raise AssertionError(f"{path}: losses {run['losses']} vs "
                                 f"{ref_losses} on the CPU")
        _mr_check_counts(path, run, mesh, cfg, MR_STEPS, lead, plain)
        if lead:
            print(f"check {path} mesh {shape} {held}, {MR_STEPS} steps "
                  f"card ranks vs the CPU's single-process step: losses "
                  f"{[round(x, 4) for x in run['losses']]} rel_err="
                  f"{loss_err:.2e} (tol 1e-4) params max_abs_err={err:.2e} "
                  "(rtol=atol=1e-5) ok", flush=True)
        counts[path] = run["kernels"]
    return counts


def _fp_spread(a, b):
    """The largest relative difference of two fingerprints' float parts,
    and whether they are equal outright."""
    worst = 0.0
    for k in a:
        for x, y in zip(a[k][:2], b[k][:2]):
            worst = max(worst, abs(x - y) / max(abs(y), 1e-30))
    return worst, a == b


def _mr_yi6b(n, dev, lead):
    """12b: Yi-6B at full width through the FSDP step at phase 8's shape
    (4 x 1024 tokens, remat, bf16 compute), 3 steps: 16 of 32 layers on
    one rank, held to two unsharded runs (bitwise where those two are,
    else within their spread); all 32 on n >= 2 ranks where n divides 4.
    The runs share one draw of the weights on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    layers = 32 if n > 1 and 4 % n == 0 else 16
    rows = 4 if 4 % n == 0 else n
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=layers,
                              dtype="bfloat16", remat=True)
    label = f"multirank yi-6b x{layers} fsdp"
    mesh = mesh_mod.make_mesh((n, 1), dev)
    kw = dict(masters=M.init_params(cfg, 0, dev), seq=TRAIN_SEQ, key=2,
              lr0=7e-3, total=100, keep="fingerprint")
    runs = {}
    # 12f holds its step to the unsharded runs' parameters after 2 steps
    snap = TP_SNAPSHOT if n == 1 else None
    if n == 1:
        runs["plain_a"] = _mr_train(cfg, None, None, dev, rows, MR_STEPS,
                                    snapshot=snap, **kw)
    runs["fsdp"] = _mr_train(cfg, mesh, "fsdp", dev, rows, MR_STEPS,
                             profile=f"{label} train step", **kw)
    run = runs["fsdp"]
    if n == 1:
        runs["plain_b"] = _mr_train(
            cfg, None, None, dev, rows, MR_STEPS,
            against=(snap, runs["plain_a"]["snapshot"]), **kw)
    if n == 1:
        a, b = runs["plain_a"], runs["plain_b"]
        spread, bitwise = _fp_spread(a["fingerprint"], b["fingerprint"])
        loss_spread = max(abs(x - y) for x, y in zip(a["losses"],
                                                     b["losses"]))
        got, same = _fp_spread(run["fingerprint"], a["fingerprint"])
        loss_err = max(abs(x - y) for x, y in zip(run["losses"],
                                                  a["losses"]))
        if bitwise and a["losses"] == b["losses"]:
            if not same or run["losses"] != a["losses"]:
                raise AssertionError(
                    f"{label}: the unsharded runs are bitwise equal, the "
                    f"FSDP run is not: losses {run['losses']} vs "
                    f"{a['losses']}, params rel {got:.3e}")
            verdict = "bitwise equal to the unsharded step"
        else:
            if got > 2 * spread or loss_err > 2 * loss_spread:
                raise AssertionError(
                    f"{label}: params rel {got:.3e} and losses "
                    f"{loss_err:.3e} off the unsharded step, whose two "
                    f"runs spread {spread:.3e} and {loss_spread:.3e}")
            verdict = (f"within twice the unsharded runs' spread (params "
                       f"rel {got:.3e} vs {spread:.3e}, losses {loss_err:.3e}"
                       f" vs {loss_spread:.3e})")
    else:
        verdict = "finite"
    _mr_check_counts(label, run, mesh, cfg, MR_STEPS, lead,
                     runs.get("plain_a"))
    if lead:
        report = _train_report(runs, rows * TRAIN_SEQ)
        print(f"train yi-6b full width x {layers} layers, fsdp over {n} "
              f"rank(s), batch {rows} x {TRAIN_SEQ}: " + json.dumps(report),
              flush=True)
        print(f"check {label}: {verdict} ok", flush=True)
    out = {"multirank_yi6b_fsdp": run["kernels"]}
    t0 = time.perf_counter()
    out.update(_mr_yi6b_tp(n, dev, lead, cfg, rows, kw, runs))
    if lead:
        print(f"phase 12f_s {time.perf_counter() - t0:.1f}", flush=True)
    return out


# the steps after which 12f holds the tensor-parallel step to the
# unsharded one (``_mr_yi6b_tp``)
TP_SNAPSHOT = 2


def _train_report(runs, tokens):
    """Per run: losses, step walls, the median step wall past the first
    (the first, in a run of one step), tokens/s at it, the run's peak
    device memory a rank."""
    report = {}
    for name, r in runs.items():
        wall = statistics.median(r["walls"][1:] or r["walls"])
        report[name] = {"losses": r["losses"], "step_wall_s": r["walls"],
                        "step_wall_median_s": wall,
                        "tokens_per_s": tokens / wall,
                        "peak_device_memory_gib_per_rank": r["peak_gib"]}
    return report


def _near_unsharded(label, run, ref, others=(), k=TP_SNAPSHOT):
    """Hold a run on one rank to the unsharded run ``ref`` after ``k``
    steps: its losses and its parameters' largest leaf distance
    (``rel_l2``) within 1e-5 relative, or twice the largest distance of
    the other unsharded ``others`` from ``ref``.  Returns the verdict
    ("bitwise equal" where it is)."""

    def loss_rel(r):
        return max(abs(x - y) / abs(y) for x, y in zip(r["losses"][:k],
                                                       ref["losses"][:k]))
    spread = max([o["rel_l2"] for o in others], default=0.0)
    loss_spread = max([loss_rel(o) for o in others], default=0.0)
    rel, loss = run["rel_l2"], loss_rel(run)
    if rel > max(1e-5, 2 * spread) or loss > max(1e-5, 2 * loss_spread):
        raise AssertionError(
            f"{label}: after {k} step(s) params rel {rel:.3e} and losses rel "
            f"{loss:.3e} off the unsharded step (tol 1e-5, or twice the "
            f"unsharded runs' spread {spread:.3e} and {loss_spread:.3e}); "
            f"losses {run['losses']} against {ref['losses']}")
    steps = f"{k} step{'s' * (k > 1)}"
    if rel == 0.0 and loss == 0.0:
        return f"bitwise equal to the unsharded step after {steps}"
    return (f"after {steps} params rel {rel:.3e} (largest leaf's L2), "
            f"losses rel {loss:.3e} of the unsharded step (tol 1e-5 or twice "
            f"the unsharded runs' spread {spread:.3e} / {loss_spread:.3e})")


def _mr_yi6b_tp(n, dev, lead, cfg, rows, kw, plain):
    """12f: Yi-6B at full width through the tensor- and sequence-parallel
    step (remat, bf16 compute) from 12b's draw and batches, 3 steps: on
    one rank a (1, 1) mesh (the collectives over groups of one, the vocab
    split over one rank), its 16 layers held to 12b's unsharded run after
    ``TP_SNAPSHOT`` steps (``_near_unsharded``, with 12b's second run as
    the spread): the loss takes one form split or not
    (``llm_a3c.logp_entropy``), so equal bit for bit is expected.  Not
    past 2 steps: 12b's learning rate drives the loss from 190 to about
    19,000 at the third step, where in bf16 any difference would grow.
    On n ranks dividing 4, all 32 layers on (1, n), and on (2, 2) with
    FSDP over data where n is 4.  Exact launches, collectives and routes
    a step; the busy share from a profiled fourth step."""
    from repro_torch.launch import mesh as mesh_mod
    if n > 1 and 4 % n:
        return {}
    shapes = [(1, n)] + ([(2, 2)] if n == 4 else [])
    out, runs = {}, {}
    a = plain.get("plain_a")
    for shape in shapes:
        name = f"tp_{shape[0]}x{shape[1]}"
        label = f"multirank yi-6b x{cfg.n_layers} {name}"
        mesh = mesh_mod.make_mesh(shape, dev)
        against = (TP_SNAPSHOT, a["snapshot"]) if n == 1 else None
        run = _mr_train(cfg, mesh, "tp", dev, rows, MR_STEPS,
                        profile=f"{label} train step", against=against,
                        **kw)
        runs[name] = run
        _mr_check_counts(label, run, mesh, cfg, MR_STEPS, lead,
                         plain.get("plain_a"))
        out[f"multirank_yi6b_{name}"] = run["kernels"]
        verdict = "finite" if n > 1 else _near_unsharded(
            label, run, a, (plain["plain_b"],))
        if lead:
            print(f"check {label}: {verdict} ok", flush=True)
    del a
    if lead:
        print(f"train yi-6b full width x {cfg.n_layers} layers, tensor and "
              f"sequence parallel over {n} rank(s), batch {rows} x "
              f"{TRAIN_SEQ}: " + json.dumps(_train_report(
                  runs, rows * TRAIN_SEQ)), flush=True)
    return out


def _mr_granite(n, dev, lead):
    """12c: Granite-MoE with nothing cut on (1, n), tensor and sequence
    parallel (attention on local heads; its vocab, 49155, divides over
    one rank but not over more, where the table and the logits stay
    whole) with the experts expert-parallel on the sequence rows, 2 train
    steps at 4 x 1024 (remat): the expert-parallel MoE on every MoE layer,
    finite losses, and on one rank the dense-MoE step's (from the same
    draw) within 1e-5 relative after 2 steps (``_near_unsharded``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    cfg = get_config(GRANITE)
    steps = TP_SNAPSHOT
    kw = dict(masters=M.init_params(cfg, 0, dev), seq=TRAIN_SEQ, key=2,
              lr0=7e-3, total=100, keep="fingerprint")
    label = f"multirank {GRANITE} tp+moe_ep"
    mesh = mesh_mod.make_mesh((1, n), dev)
    plain = None
    verdict = "finite"
    against = None
    if n == 1:
        plain = _mr_train(cfg, None, None, dev, TRAIN_ROWS, steps,
                          snapshot=steps, **kw)
        if plain["routes"]["moe_dense"] <= 0:
            raise AssertionError(f"{label}: the unsharded step took no "
                                 "dense MoE")
        against = (steps, plain["snapshot"])
    run = _mr_train(cfg, mesh, "tp", dev, TRAIN_ROWS, steps,
                    profile=f"{label} train step", against=against, **kw)
    del kw, against
    if n == 1:
        verdict = _near_unsharded(label, run, plain)
        del plain["snapshot"]
    _mr_check_counts(label, run, mesh, cfg, steps, lead, plain)
    if lead:
        report = {"losses": run["losses"], "step_wall_s": run["walls"],
                  "peak_device_memory_gib_per_rank": run["peak_gib"]}
        if plain is not None:
            report.update(dense_losses=plain["losses"],
                          dense_step_wall_s=plain["walls"])
        print(f"train {GRANITE} tp+moe_ep over (1, {n}): "
              + json.dumps(report),
              flush=True)
        print(f"check {label}: {verdict} ok", flush=True)
    return run["kernels"]


# 12h's full-width configs: (label, arch, depth cut, rows, seq, steps,
# profiled) at n = 1 against the unsharded step, and at n = 4 on (1, 4).
# xlstm takes one step: its sLSTM loop makes a step 4-7 s on one card, and
# one step already holds the forward, the backward and the update to the
# unsharded ones
REC_FULL = {1: (("zamba2-1.2b", ZAMBA2, {}, 4, TRAIN_SEQ, TP_SNAPSHOT, True),
                ("whisper-base", WHISPER, {}, 4, 448, TP_SNAPSHOT, True),
                ("xlstm-1.3b x8", XLSTM, {"n_layers": 8}, 4, TRAIN_SEQ, 1,
                 False)),
            4: (("zamba2-1.2b", ZAMBA2, {}, 4, TRAIN_SEQ, TP_SNAPSHOT, True),
                ("xlstm-1.3b", XLSTM, {}, 4, TRAIN_SEQ, TP_SNAPSHOT, False))}


def _mr_rec_full(n, dev, lead):
    """12h: the recurrent and encoder-decoder models at full width through
    the tensor- and sequence-parallel step (remat, bf16 compute), the
    steps ``REC_FULL[n]`` gives from one draw of the weights (and of
    Whisper's stub frames).  At n = 1 each on a (1, 1) mesh, held to the
    unsharded step after those steps (``_near_unsharded``: bitwise
    expected, as 12f; where it is not, a second unsharded run gives the
    spread); at n = 4 on (1, 4).  Exact launches, collectives and routes a
    step; the busy share from one more step, profiled on the device only
    (its host ops would hold the profiler for tens of seconds), where
    ``REC_FULL`` says (not xlstm: its sLSTM loop's launches would hold it
    for minutes).  Returns {path: counts}."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    out = {}
    for name, arch, cut, rows, seq, steps, profiled in REC_FULL.get(n, ()):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                                  remat=True, **cut)
        label = f"multirank {name} tp (1, {n})"
        kw = dict(masters=M.init_params(cfg, 0, dev), seq=seq, key=2,
                  lr0=7e-3, total=100, keep="fingerprint",
                  extra=_mr_extra(cfg, rows, torch.bfloat16, dev))
        mesh = mesh_mod.make_mesh((1, n), dev)
        runs, plain = {}, None
        if n == 1:
            plain = runs["plain_a"] = _mr_train(
                cfg, None, None, dev, rows, steps, snapshot=steps, **kw)
        run = runs["tp"] = _mr_train(
            cfg, mesh, "tp", dev, rows, steps,
            profile=f"{label} train step" if profiled else None,
            profile_host=False,
            against=(steps, plain["snapshot"]) if plain else None, **kw)
        verdict = "finite"
        if plain is not None:
            try:
                verdict = _near_unsharded(label, run, plain, k=steps)
            except AssertionError:
                runs["plain_b"] = _mr_train(
                    cfg, None, None, dev, rows, steps,
                    against=(steps, plain["snapshot"]), **kw)
                verdict = _near_unsharded(label, run, plain,
                                          (runs["plain_b"],), k=steps)
            del plain["snapshot"]
        del kw
        _mr_check_counts(label, run, mesh, cfg, steps, lead, plain)
        if lead:
            print(f"train {name} full width x {cfg.n_layers} layers, tensor "
                  f"and sequence parallel over (1, {n}), batch {rows} x "
                  f"{seq}: " + json.dumps(_train_report(runs, rows * seq)),
                  flush=True)
            print(f"check {label}: {verdict} ok", flush=True)
        out[f"multirank_{name.replace(' ', '_')}_tp"] = run["kernels"]
        del runs, run, plain
        gc.collect()
        torch.cuda.empty_cache()
        if lead:
            print(f"phase 12h_{name.replace(' ', '_')}_s "
                  f"{time.perf_counter() - t0:.1f}", flush=True)
    return out


def _mr_delayed(n, dev, refs, lead):
    """12d: delayed sync on (pod n, 1, 1), each pod one group, merging
    every 2 steps: 3 steps of reduced yi-6b in f32, each group's
    parameters against the CPU's list form with n groups."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import delayed_sync
    from repro_torch.distributed import ctx, fsdp
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    cfg = _mr_configs()["yi"]
    mesh = mesh_mod.make_mesh((n, 1, 1), dev)
    lay = fsdp.layout(cfg, mesh, pod_groups=True)
    params = fsdp.shard(lay, M.tree_map(lambda t: t.to(dev),
                                        M.init_params(cfg, 0, "cpu")))
    opt = opt_mod.shared_rmsprop()
    state = opt.init(params)
    step = delayed_sync.make_delayed_train_step(
        cfg, opt, n_groups=n, merge_interval=2, lr=1e-3, layout=lay)
    g = dist.get_rank()
    losses = []
    dispatch.reset_launch_counts()
    with ctx.use_mesh(mesh):
        for i, batches in enumerate(_mr_delayed_batches(cfg, n)):
            batch = {k: v.to(dev) for k, v in batches[g].items()}
            params, state, met = step(params, state, batch, i)
            losses.append(float(met["loss"]))
    counts = dispatch.launch_counts()
    ref_losses, ref_groups = refs["multirank_delayed"]
    whole = M.flatten(fsdp.full(lay, params))
    err = max(float((whole[k].detach().cpu() - want).abs().max())
              for k, want in ref_groups[g].items())
    if err > 1e-5 or any(abs(a - b) > 1e-4 * abs(b)
                         for a, b in zip(losses, ref_losses)):
        raise AssertionError(f"multirank delayed sync: group {g} params off "
                             f"the CPU's by {err:.2e}, losses {losses} vs "
                             f"{ref_losses}")
    _check_rmsprop_launches(
        "multirank delayed sync", counts, MR_STEPS * _per_update(
            len(M.flatten(params))),
        others=("rmsnorm", "rmsnorm_bwd", "flash_attention_f32",
                "flash_attention_bwd_f32"))
    if lead:
        print(f"check multirank delayed sync (pod {n}, 1, 1), merge every "
              f"2, reduced yi-6b f32, cards vs the CPU's {n} groups: losses "
              f"{[round(x, 4) for x in losses]}, group {g} params "
              f"max_abs_err={err:.2e} (tol 1e-5) ok", flush=True)
    return counts


def _phase12_rank(rank, n, port, tmp):
    """One rank of phase 12 on card ``rank``: 12a, 12e, 12g, 12b with 12f,
    12c, 12d and 12h, its launch counts by path written to ``tmp``."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        build.library()
        refs = torch.load(os.path.join(tmp, "refs.pt"))
        lead = rank == 0

        def lap(name, t0):
            if lead:
                print(f"phase {name}_s {time.perf_counter() - t0:.1f}",
                      flush=True)
            return time.perf_counter()
        t = time.perf_counter()
        counts = _mr_reduced(n, dev, refs, lead, _mr_cases(n))
        t = lap("12a", t)
        counts.update(_mr_reduced(n, dev, refs, lead, _mr_tp_cases(n)))
        t = lap("12e", t)
        counts.update(_mr_reduced(n, dev, refs, lead, _mr_rec_cases(n)))
        t = lap("12g", t)
        counts.update(_mr_yi6b(n, dev, lead))
        t = lap("12b", t)
        counts["multirank_granite_full_ep"] = _mr_granite(n, dev, lead)
        t = lap("12c", t)
        counts["multirank_delayed"] = _mr_delayed(n, dev, refs, lead)
        t = lap("12d", t)
        counts.update(_mr_rec_full(n, dev, lead))
        lap("12h", t)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(counts, f)
    finally:
        dist.destroy_process_group()


def run_phase12():
    """Phase 12 (12a-12h): one rank a card over NCCL, started from the
    parent, which has built the kernels and computed the CPU's
    references; returns rank 0's {path: counts}, the ranks' counts
    required equal."""
    import gc
    import pickle
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp
    n = torch.cuda.device_count()
    print(f"phase 12 world {n}", flush=True)
    refs = _mr_cpu_refs(n)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mr_") as tmp:
        torch.save(refs, os.path.join(tmp, "refs.pt"))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(_phase12_rank, args=(n, port, tmp), nprocs=n,
                           start_method="spawn")
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    if any(c != ranks[0] for c in ranks[1:]):
        raise AssertionError("phase 12: the ranks' launch counts differ")
    return ranks[0]


# ---------------------------------------------------------------------------
# phase 13: decode across cards under the serving layout
# ---------------------------------------------------------------------------

def _decode_attention_layers(cfg):
    """``attention.attend_decode`` calls of one decode step: the attention
    layers, zamba2's shared-block applications and Whisper's decoder
    self-attention layers."""
    if cfg.is_encdec:
        return cfg.n_layers
    n = sum(k in ("attn", "attn_local") for k in cfg.layer_kinds())
    return n + _shared_apps(cfg)


# collectives a recurrent layer issues at decode under the serving layout:
# (all-gathers, all-reduces): mamba2's B and C, its norm's rows and scale,
# the out_proj sum; the mLSTM's conv output and xi, its norm's rows and
# scale, the down sum; the sLSTM's gathered heads and the ff_down sum
_REC_DECODE = {"mamba2": (3, 1), "mlstm": (3, 1), "slstm": (1, 1)}


def _decode_collectives(cfg, lay, owned=True):
    """Collectives of one decode step under the serving layout
    (``collectives.counts()``): the vocab-parallel embedding's sum and the
    logits' gather where the vocab is split; for each attention call the
    gather of its heads, the combine's two all-reduces where the rule owns
    the cache (``owned``) and the sum of ``wo``; each MLP or MoE half one
    sum; the recurrent layers' ``_REC_DECODE``; Whisper's cross attention
    as a self attention whose memory the rule splits."""
    gather = reduce = 0
    if lay.sharded("embed.table", "model"):
        gather += 1
        reduce += 1
    attn_calls = _decode_attention_layers(cfg)
    if cfg.is_encdec:
        attn_calls += cfg.n_layers
    gather += attn_calls
    reduce += attn_calls * (1 + 2 * bool(owned))
    ffn = cfg.n_layers if cfg.is_encdec else _decode_attention_layers(cfg)
    reduce += ffn
    for kind in cfg.layer_kinds():
        g, r = _REC_DECODE.get(kind, (0, 0))
        gather += g
        reduce += r
    return {"all_gather": gather, "reduce_scatter": 0,
            "all_reduce": reduce, "all_to_all": 0}


def _decode_launches(cfg, kv, owned=True):
    """Kernel launches of one decode step under the serving layout (or of
    the unsharded step, ``owned=False``): kernel 1 on every RMSNorm (two
    a block or shared-block application: ln1 and ln2, mamba2's gated norm
    or the xLSTM blocks' inner one; and the final norm); kernel 7 on every
    attention call whose cache the rule owns, kernel 6 otherwise (its int8
    arm over an int8 cache); Whisper's cross attention is plain
    products."""
    out = {}
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = 2 * (cfg.n_layers + _shared_apps(cfg)) + 1
    arm = "decode_attention_partials" if owned else "decode_attention"
    out[arm + ("_int8" if kv == "int8" else "")] = \
        _decode_attention_layers(cfg)
    return out


DL_STEPS = 4
DL_LEN = 16
DL_POS = {4: (2, 5, 8, 11), 1: (9,)}
# 13a's reduced configs (the parity tests' set): attention with kv heads
# held whole (yi, qwen2-72b with its qkv biases) and split (stablelm),
# experts (granite-moe), mamba2 with the shared block (zamba2), mLSTM and
# sLSTM, and Whisper (its cross memory split over the sequence shards)
DL_ARCHS = ("yi-6b", "stablelm-1.6b", "qwen2-72b", "granite-moe-1b-a400m",
            "zamba2-1.2b", "xlstm-1.3b", "whisper-base")
# card vs CPU for the reduced f32 models: over an f32 state DL_TOL in
# every logit; over bf16 or int8 KV a written bf16 element or int8 code of
# a step's new row may round the other way where the card's and the CPU's
# f32 projections straddle its rounding boundary (about 1 in 20000
# elements), one quantum (~4e-3 of a bf16 row, ~1e-2 of an int8 one)
# that moves the step's logits by up to ~2e-3 (probe 26b: 1.68e-3), so
# there the logits are held to DL_REL_KV relative L2, which a sparse flip
# barely moves and an error in every logit would not pass, and to
# DL_FLIP_ABS in every logit
DL_TOL = 1e-4
DL_REL_KV = 1e-3
DL_FLIP_ABS = 1e-2
YI_DECODE = dict(batch=8, seq=32768, steps=16)     # decode_32k, batch cut
ZAMBA2_LONG = dict(batch=1, seq=524288, steps=4)   # long_500k, native
DL_TOKEN_SEED = 13


def _dl_config(arch):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if arch == "xlstm-1.3b":
        cfg = dataclasses.replace(cfg, block_cycle=("mlstm", "slstm"))
    return cfg


def _dl_kvs(cfg):
    """The KV dtypes a config's decode cache takes (none but its
    recurrent states for xlstm; the encoder-decoder's no int8)."""
    if cfg.is_encdec:
        return ("bf16",)
    if not _decode_attention_layers(cfg):
        return ("f32",)
    return ("bf16", "int8")


def _dl_fill(cache, gen, scale=0.5):
    """Every tensor of a whole decode cache drawn from ``gen``: K/V rows
    and recurrent states normal times ``scale`` (int8 rows quantised, with
    their scales; the sLSTM's n positive); page tables left alone."""
    import torch

    from repro_torch.kernels import kv_quant
    from repro_torch.models import model as M
    for layer in M.slot_layers(cache):
        quant = "ks" in layer
        for name, t in list(layer.items()):
            if not torch.is_tensor(t) or name in ("ks", "vs", "pt"):
                continue
            if quant and name in ("k", "v"):
                x = torch.randn(t.shape, generator=gen, device=t.device)
                q, sc = kv_quant.quantize(x * scale)
                t.copy_(q)
                layer[name + "s"].copy_(sc)
                continue
            t.normal_(generator=gen).mul_(scale)
            if name == "n" and t.dim() == 3 and "C" not in layer:
                t.abs_().add_(1.0)
    return cache


def _dl_steps(cfg, steps, b, seed=DL_TOKEN_SEED):
    """The teacher-forced token stream (steps, b, 1) int64, from a seed."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (steps, b, 1), generator=g)


def _dl_decode(cfg, params, cache, tokens, pos0, *, layout=None, mesh=None,
               rules=None, rows=slice(None), sample=False):
    """``make_serve_step`` over the token stream, each step's logits
    captured from the model layer: (tokens (steps, rows), logits (steps,
    rows, V) f32 on the CPU, wall seconds, launches, collectives)."""
    import contextlib

    import torch

    from repro_torch.core import llm_a3c, prng
    from repro_torch.distributed import collectives, ctx
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    dev = _cache_device(cache)
    step = llm_a3c.make_serve_step(cfg, sample=sample, layout=layout)
    orig = M.decode_step
    logits, toks = [], []

    def watched(*a, **k):
        out, c = orig(*a, **k)
        logits.append(out["logits"][:, -1].float().clone())
        return out, c
    scope = contextlib.ExitStack()
    if mesh is not None:
        scope.enter_context(ctx.use_mesh(mesh))
    scope.enter_context(ctx.sharding_rules(rules))
    pos = torch.as_tensor(pos0, dtype=torch.int32)[rows]
    M.decode_step = watched
    try:
        with scope, torch.no_grad():
            torch.cuda.synchronize(dev)
            dispatch.reset_launch_counts()
            collectives.reset_counts()
            t0 = time.perf_counter()
            for i in range(tokens.shape[0]):
                tok, _, cache = step(params, cache, {
                    "tokens": tokens[i][rows].to(dev)}, pos,
                    prng.fold_in(prng.key(0), i))
                toks.append(tok)
                pos = pos + 1
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    finally:
        M.decode_step = orig
    return (torch.stack(toks).cpu(), torch.stack(logits).cpu(), wall,
            dispatch.launch_counts(), collectives.counts())


def _cache_device(cache):
    import torch

    from repro_torch.models import model as M
    return next(t.device for t in M.flatten(cache).values()
                if torch.is_tensor(t))


def _dl_check_counts(label, cfg, lay, kv, steps, launches, colls, lead,
                     owned=True):
    """The run's kernel launches exactly ``_decode_launches`` and its
    collectives exactly ``_decode_collectives`` a step."""
    want = {k: steps * v for k, v in _decode_launches(cfg, kv, owned)
            .items()}
    got = {k: launches[k] for k in ATTENTION_ARMS + ("rmsnorm",)
           if launches[k] or k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    if lay is not None:
        per = _decode_collectives(cfg, lay, owned)
        want_c = {k: steps * v for k, v in per.items()}
        if colls != want_c:
            raise AssertionError(f"{label}: collectives {colls}, want "
                                 f"{want_c}")
    if lead:
        print(f"check {label}: launches a step " + json.dumps(
            {k: v // steps for k, v in want.items()}) + (
            ", collectives a step " + json.dumps(per) if lay is not None
            else "") + " exact ok", flush=True)


def _dl_rows(rules, mesh, b):
    from repro_torch.distributed import sharding
    axes = tuple(rules["decode_cp"]["dp_axes"])
    n = sharding.axes_size(mesh, axes)
    r = sharding.axes_rank(mesh, axes) if axes else 0
    return slice(r * (b // n), (r + 1) * (b // n))


def _dl_reduced(n, dev, lead, shapes):
    """13a: the reduced configs' decode under the serving layout on the
    card against the unsharded decode on this rank's CPU, on each mesh of
    ``shapes``: a batch of 4 over the data axes and of 1 (its sequence
    over data and model), each KV dtype the config takes; logits within
    DL_TOL (over bf16 or int8 KV: DL_FLIP_ABS and DL_REL_KV), greedy
    tokens equal where the CPU's margin is at least 1e-3, launches and
    collectives exact.  Returns {path: launches}."""
    import torch

    from repro_torch.distributed import fsdp, sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    dts = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
    totals = {}
    for shape in shapes:
        mesh = mesh_mod.make_mesh(shape, dev)
        worst, worst_rel = {True: 0.0, False: 0.0}, 0.0
        for arch in DL_ARCHS:
            cfg = _dl_config(arch)
            params = M.cast_params(cfg, M.init_params(cfg, 0, "cpu"))
            lay = fsdp.serve_layout(cfg, mesh, force_tp=True)
            shards = M.tree_map(lambda t: t.to(dev), fsdp.shard(lay, params))
            for b in (4, 1):
                rules = sharding.decode_rules(cfg, mesh, batch_size=b)
                rows = _dl_rows(rules, mesh, b)
                tokens = _dl_steps(cfg, DL_STEPS, b)
                for kv in _dl_kvs(cfg):
                    gen = torch.Generator().manual_seed(b * 31 + len(kv))
                    whole = _dl_fill(M.init_cache(
                        cfg, b, DL_LEN, dtype=dts[kv], device="cpu"), gen)
                    ref_cache = M.tree_map(lambda t: t.clone(), whole)
                    cache = fsdp.shard_cache(
                        cfg, mesh, M.tree_map(lambda t: t.to(dev), whole),
                        batch_size=b)
                    label = (f"decode layout {'x'.join(map(str, shape))} "
                             f"{arch} reduced b={b} kv={kv}")
                    toks, logits, _, launches, colls = _dl_decode(
                        cfg, shards, cache, tokens, DL_POS[b], layout=lay,
                        mesh=mesh, rules=rules, rows=rows)
                    _, ref_logits = _dl_cpu_decode(cfg, params, ref_cache,
                                                   tokens, DL_POS[b])
                    ref_logits = ref_logits[:, rows]
                    err = float((logits - ref_logits).abs().max())
                    rel = float((logits - ref_logits).norm()
                                / ref_logits.norm())
                    ok_err = err <= DL_TOL if kv == "f32" else \
                        err <= DL_FLIP_ABS and rel <= DL_REL_KV
                    if not ok_err:
                        raise AssertionError(
                            f"{label}: logits off the CPU's by {err:.3e} "
                            f"(rel L2 {rel:.3e}; tol {DL_TOL} over f32, "
                            f"{DL_FLIP_ABS} and rel {DL_REL_KV} over "
                            "bf16 / int8 KV)")
                    top2 = ref_logits.topk(2, dim=-1).values
                    ok = (top2[..., 0] - top2[..., 1]) >= 1e-3
                    if not torch.equal(toks[ok], ref_logits.argmax(-1)[ok]):
                        raise AssertionError(f"{label}: greedy tokens differ "
                                             "at a healthy margin")
                    _dl_check_counts(label, cfg, lay, kv, DL_STEPS,
                                     launches, colls, False)
                    for k, v in launches.items():
                        totals[k] = totals.get(k, 0) + v
                    worst[kv == "f32"] = max(worst[kv == "f32"], err)
                    worst_rel = max(worst_rel, rel)
        if lead:
            print(f"check decode layout {'x'.join(map(str, shape))}: "
                  f"{len(DL_ARCHS)} reduced configs x batch 4, 1 x their KV "
                  f"dtypes, {DL_STEPS} steps each, card vs CPU logits "
                  f"max_abs_err={worst[True]:.3e} over f32 states (tol "
                  f"{DL_TOL}), {worst[False]:.3e} over bf16 / int8 KV (tol "
                  f"{DL_FLIP_ABS}), rel L2 {worst_rel:.3e} (tol "
                  f"{DL_REL_KV}), greedy tokens where the margin >= 1e-3, "
                  "launches and collectives exact ok", flush=True)
    return {"decode_layout_reduced": totals}


def _dl_cpu_decode(cfg, params, cache, tokens, pos0):
    """The unsharded decode on the CPU: (tokens, logits (steps, B, V))."""
    import torch

    from repro_torch.models import model as M
    pos = torch.as_tensor(pos0, dtype=torch.int32)
    toks, logits = [], []
    with torch.no_grad():
        for i in range(tokens.shape[0]):
            out, cache = M.decode_step(cfg, params, cache,
                                       {"tokens": tokens[i]}, pos)
            lg = out["logits"][:, -1].float()
            logits.append(lg)
            toks.append(lg.argmax(-1))
            pos = pos + 1
    return torch.stack(toks), torch.stack(logits)


def _dl_full(n, dev, lead, name, arch, spec, shapes, pos0):
    """13b / 13c: ``arch`` at full width and depth, bf16, decoding
    ``spec["steps"]`` tokens a row against a ``spec["seq"]``-row context
    filled from a seed, under the serving layout on each mesh of
    ``shapes``; held to the unsharded serve step on rank 0's card (logits
    within BF16_LOGITS_REL relative L2; the greedy tokens the argmax of
    the step's logits, and the unsharded step's wherever its margin
    clears twice the row's largest logit difference); the ranks of a
    batch row agree; kernel 7's launches and the collectives exact.  Prints decode
    tokens/s and each rank's peak memory.  Returns {path: launches}."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    cfg = get_config(arch)
    b, seq, steps = spec["batch"], spec["seq"], spec["steps"]
    tokens = _dl_steps(cfg, steps, b)
    out = {}
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, dev, torch.bfloat16)
    for shape in shapes:
        tag = "x".join(map(str, shape))
        label = f"decode layout {tag} {arch} {name}"
        mesh = mesh_mod.make_mesh(shape, dev)
        lay = fsdp.serve_layout(cfg, mesh, force_tp=True)
        shards = fsdp.shard(lay, params)
        rules = sharding.decode_rules(cfg, mesh, batch_size=b)
        rows = _dl_rows(rules, mesh, b)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        whole = _dl_fill(M.init_cache(cfg, b, seq, dtype=torch.bfloat16,
                                      device=dev), gen)
        ref_cache = M.tree_map(lambda t: t.clone(), whole) if lead else None
        cache = fsdp.shard_cache(cfg, mesh, whole, batch_size=b)
        del whole
        gc.collect()
        # what the rank holds under the layout: its weights and its cache
        held = sum(t.numel() * t.element_size() for tree in (shards, cache)
                   for t in M.flatten(tree).values() if torch.is_tensor(t))
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        toks, logits, wall, launches, colls = _dl_decode(
            cfg, shards, cache, tokens, pos0, layout=lay, mesh=mesh,
            rules=rules, rows=rows)
        peak = (held, torch.cuda.max_memory_allocated(dev))
        del cache, shards
        gc.collect()
        _dl_check_counts(label, cfg, lay, "bf16", steps, launches, colls,
                         lead)
        out[f"decode_layout_{name}_{tag}"] = launches
        # the ranks holding the same rows drew the same tokens
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (rows.start, toks.tolist(), peak))
        by_rows = {}
        for start, t, _ in every:
            if by_rows.setdefault(start, t) != t:
                raise AssertionError(f"{label}: ranks of rows {start} drew "
                                     "different tokens")
        if lead:
            rtoks, rlogits, rwall, rlaunch, _ = _dl_decode(
                cfg, params, ref_cache, tokens, pos0, rows=slice(None))
            del ref_cache
            gc.collect()
            _dl_check_counts(f"{label} unsharded", cfg, None, "bf16", steps,
                             rlaunch, None, True, owned=False)
            out[f"decode_unsharded_{name}"] = rlaunch
            ref = rlogits[:, rows]
            rel = float((logits - ref).norm() / ref.norm())
            # a row's argmax can move only where its margin is within
            # twice the row's largest logit difference
            top2 = ref.topk(2, dim=-1).values
            ok = (top2[..., 0] - top2[..., 1]) > \
                2 * (logits - ref).abs().amax(dim=-1)
            print(f"decode layout {tag} {arch} {name}: logits rel L2 "
                  f"{rel:.3e}, max abs {float((logits - ref).abs().max()):.3e}"
                  f" off the unsharded step's, {int(ok.sum())}/{ok.numel()} "
                  "choices clear of it", flush=True)
            if not rel <= BF16_LOGITS_REL:
                raise AssertionError(f"{label}: logits rel L2 {rel:.3e} off "
                                     f"the unsharded step's (gate "
                                     f"{BF16_LOGITS_REL})")
            if not torch.equal(toks, logits.argmax(-1)):
                raise AssertionError(f"{label}: the greedy tokens are not "
                                     "the argmax of the step's logits")
            if not torch.equal(toks[ok], ref.argmax(-1)[ok]):
                raise AssertionError(f"{label}: greedy tokens differ from "
                                     "the unsharded step's where the margin "
                                     "clears the logits' difference")
            tps = b * steps / wall
            print(f"decode layout {tag} {arch} {name}: batch {b}, context "
                  f"{seq}, {steps} steps: {tps:.1f} decode tokens/s "
                  f"(unsharded on one card {b * steps / rwall:.1f}), "
                  f"ranks' weights and cache GB "
                  f"{[round(p[0] / 1e9, 2) for _, _, p in every]}, peak "
                  f"memory during the decode GB (the whole weights kept "
                  f"for the next mesh, and rank 0's reference cache, "
                  f"included) {[round(p[1] / 1e9, 2) for _, _, p in every]}"
                  f", cache built and sharded in {build_s:.1f} s",
                  flush=True)
            print(f"check {label}: logits rel L2 {rel:.3e} of the unsharded "
                  f"serve step's (gate {BF16_LOGITS_REL}), greedy tokens the "
                  f"argmax of the logits and equal to the unsharded step's "
                  f"at {int(ok.sum())}/{ok.numel()} choices whose margin "
                  "clears twice the row's largest logit difference, ranks "
                  "agree ok", flush=True)
            ref_cache = None
        dist.barrier()
        t0 = time.perf_counter()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the relative L2 distance allowed between a bf16 decode's logits under the
# layout and the unsharded step's.  The layout rounds other sums in bf16
# (each rank's partial product before the f32 sum over the model group,
# the combine of the sequence shards), and a bf16 model's rounding grows
# with depth: reduced yi in bf16 on the CPU is 1.0e-2 / 1.8e-2 / 5.0e-2
# (2 / 8 / 32 layers) from the same weights computed in f32, and its
# layout on (1, 4) 1.2e-2 / 2.0e-2 / 5.7e-2 from its unsharded bf16 step.
# So the gate is 2^-3, about twice a 32-layer model's own bf16 noise; the
# layout's arithmetic is held tight by 13a (f32) and the CPU tests
BF16_LOGITS_REL = 2.0 ** -3


def _phase13_rank(rank, n, port, tmp):
    """One rank of phase 13 on card ``rank``: 13a, 13b and 13c, its launch
    counts by path written to ``tmp``."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    torch.cuda.set_device(rank)
    torch.set_num_threads(max(1, 8 // n))
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        build.library()
        lead = rank == 0
        shapes = [(1, n)] + ([(2, 2)] if n == 4 else [])
        t = time.perf_counter()
        counts = _dl_reduced(n, dev, lead, shapes)
        if lead:
            print(f"phase 13a_s {time.perf_counter() - t:.1f}", flush=True)
        t = time.perf_counter()
        yb = YI_DECODE["batch"]
        counts.update(_dl_full(
            n, dev, lead, "32k", "yi-6b", YI_DECODE, shapes,
            [YI_DECODE["seq"] - YI_DECODE["steps"] - 1 - 37 * i
             for i in range(yb)]))
        if lead:
            print(f"phase 13b_s {time.perf_counter() - t:.1f}", flush=True)
        t = time.perf_counter()
        counts.update(_dl_full(
            n, dev, lead, "500k", "zamba2-1.2b", ZAMBA2_LONG, shapes,
            [ZAMBA2_LONG["seq"] - ZAMBA2_LONG["steps"] - 1]))
        if lead:
            print(f"phase 13c_s {time.perf_counter() - t:.1f}", flush=True)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(counts, f)
    except BaseException:
        # a rank that fails leaves its peers inside a collective, where
        # destroying the process group would wait for them: report and
        # leave at once, and the parent stops the others
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def run_phase13():
    """Phase 13 (13a-13c): one rank a card over NCCL; returns rank 0's
    {path: counts}, the ranks' counts of the layout runs required
    equal."""
    import pickle
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp
    n = torch.cuda.device_count()
    print(f"phase 13 world {n}", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dl_") as tmp:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(_phase13_rank, args=(n, port, tmp), nprocs=n,
                           start_method="spawn")
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for c in ranks[1:]:
        for path, v in c.items():
            if v != ranks[0][path]:
                raise AssertionError(f"phase 13: the ranks' launch counts "
                                     f"differ on {path}")
    return ranks[0]


def _shapes(record):
    """A kernel record and its timings at other shapes."""
    return [record] + [record[k] for k in (
        "train_shape", "decode_shape", "f32_shape", "train_table_shape",
        "llm_leaf_shape", "llm_leaf_apply_shape", "rl_fc_shape",
        "rl_small_shape", "verify_shape", "verify_k6_shape",
        "granite_shape", "scout_shape", "granite_train_shape",
        "width_2048_shape", "zamba2_shape", "whisper_shape",
        "whisper_encoder_shape", "whisper_decoder_shape",
        "zamba2_train_shape", "tp2_shape", "tp4_shape",
        "width_2048_tp2_shape", *_REC_TP_TRAIN, "decode32k_shape",
        "long131k_shape", "long500k_shape")
        if k in record]


def main():
    import gc

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); nothing was run")
    from repro_torch.distributed import sharding
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"cc {torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    build.library()
    print(f"build_s {time.perf_counter() - t0:.1f} (nvcc "
          f"{build.build_seconds:.1f} s)")
    for r in build.kernel_resources(build.build_log):
        print(f"ptxas {r['name']}: registers={r.get('registers')} "
              f"spill_stores={r.get('spill_stores')} "
              f"spill_loads={r.get('spill_loads')} stack={r.get('stack')}")

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # 512 MiB: larger than the 50 MB L2, and about 0.16 ms of writes, which
    # keeps the card busy while the host enqueues a call (a decode call
    # spends up to about 0.1 ms on the host)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device="cuda")
    records = [check_rmsnorm(gen, flush), *check_append(gen, flush),
               *check_append_int8(gen, flush), check_decode(gen, flush),
               check_decode_int8(gen, flush), *check_partials(gen, flush),
               check_rmsnorm_bwd(gen, flush), *check_flash_fwd(gen, flush),
               *check_flash_bwd(gen, flush), check_rmsprop(gen, flush)]
    for name, subs in check_verify(gen, flush).items():
        next(r for r in records if r["name"] == name).update(subs)
    t_prng = time.perf_counter()
    check_prng(flush)
    print(f"phase prng_s {time.perf_counter() - t_prng:.1f}")
    del flush
    for r in records:
        for sub in _shapes(r):
            lib = sub["library_ms"]
            sub["x_bound"] = sub["ms"] / sub["bound_ms"]
            sub["x_library"] = None if lib is None else sub["ms"] / lib
    for r in records:
        for sub in _shapes(r):
            lib = sub["library_ms"]
            lib = sub.get("library_note", "none") if lib is None else \
                f"{lib:.4f}"
            xlib = "none" if sub["x_library"] is None else \
                f"{sub['x_library']:.2f}"
            print(f"kernel {r['name']} [{sub['shape']}]: kernel_ms="
                  f"{sub['ms']:.4f} bound_ms={sub['bound_ms']:.4f} "
                  f"({sub['bound_by']}) plain_ms={sub['plain_ms']:.4f} "
                  f"library_ms={lib} x_bound={sub['x_bound']:.2f} "
                  f"x_library={xlib}")
            if "split_ms" in sub:
                print(f"kernel {r['name']} forced n_split: " + " ".join(
                    f"{n}={t:.4f}" for n, t in sub["split_ms"].items()))
    print(f"phase kernels_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    path_counts = {"model_small_f32": check_model_small()}
    cfg, params = build_yi6b()
    path_counts["engine"], tokens = run_yi6b_engine(cfg, params, "bf16",
                                                    False)
    path_counts["engine_contiguous"], tokens_c = run_yi6b_engine(
        cfg, params, "bf16", False, paged=False)
    if tokens != tokens_c:
        raise AssertionError("phase 5: paged tokens differ from contiguous")
    print("check phase 5 paged vs contiguous: greedy tokens identical ok")
    path_counts["engine_sampled"] = run_yi6b_engine(cfg, params, "bf16",
                                                    False, sample=True)[0]
    # paged and contiguous in turns: paged, contiguous, contiguous, paged
    steps = {}
    for paged in (True, False, False, True):
        name = "paged" if paged else "contiguous"
        steps[name] = profile_engine(cfg, params, f"bf16 {name}",
                                     kv_dtype="bf16", paged=paged)
    _profile_diff("bf16 decode step, paged vs contiguous", steps["paged"],
                  steps["contiguous"], 8)
    path_counts["engine_int8"] = run_yi6b_engine(cfg, params, "int8",
                                                 False)[0]
    print(f"phase engine_s {time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    path_counts.update(check_prefix_sharing(cfg, params))
    print(f"phase prefix_sharing_s {time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    path_counts.update(check_overload(cfg, params, tokens))
    path_counts.update(check_overload_reduced())
    print(f"phase overload_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    path_counts.update(check_spec(cfg, params, tokens))
    path_counts.update(check_spec_reduced())
    spec_steps = profile_engine(cfg, params, "bf16 paged ngram",
                                kv_dtype="bf16", spec="ngram", spec_k=4)
    _profile_diff("8 verify rounds (ngram) vs 8 decode steps, paged",
                  spec_steps, steps["paged"], 8)
    for what, names in (("cache concatenation", ("CatArrayBatchedCopy",)),
                        ("page gathers", ("vectorized_gather_kernel",
                                          "indexSelect"))):
        ms = sum(t for k, (_, t) in spec_steps.items()
                 if any(n in k for n in names))
        print(f"profile verify round's {what}: {ms / 8:.4f} device ms a "
              f"round (8 rounds, {ms:.4f} ms)")
    print(f"phase spec_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    with sharding.process_group(torch.device("cuda")):
        path_counts["engine_cp_int8"] = run_yi6b_engine(cfg, params, "int8",
                                                        True)[0]
        profile_engine(cfg, params, "decode_cp[1] int8", kv_dtype="int8",
                       decode_cp=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        path_counts.update(check_cp_reduced())
    path_counts["sampled_reduced_f32"] = check_sampled_reduced()
    print(f"phase engine_cp_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    path_counts["train_small_f32"] = check_train_small()
    path_counts["train_3_steps"] = run_yi6b_train()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase train_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    path_counts.update(check_rl_paths())
    print(f"phase rl_paths_s {time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    path_counts["rl_paper_net"] = run_paper_net()
    print(f"phase rl_paper_net_s {time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    path_counts["rl_quickstart"] = run_quickstart()
    print(f"phase rl_quickstart_s {time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    path_counts["rl_delayed_sync"] = check_delayed_sync()
    print(f"phase rl_delayed_sync_s {time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    path_counts.update(run_phase10())
    print(f"phase moe_mrope_s {time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    path_counts.update(run_phase11())
    print(f"phase recurrent_encdec_s {time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    path_counts.update(run_phase12())
    print(f"phase multirank_s {time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    path_counts.update(run_phase13())
    print(f"phase decode_layout_s {time.perf_counter() - t_phase:.1f}")

    by_op = {"rmsnorm_fwd": "rmsnorm",
             "flash_attention_append": "flash_append",
             "flash_attention_append_f32": "flash_append_f32",
             "flash_attention_append_int8": "flash_append_int8",
             "flash_attention_append_int8_f32": "flash_append_int8_f32",
             "decode_attention_fwd": "decode_attention",
             "decode_attention_fwd_int8": "decode_attention_int8",
             "decode_attention_partials": "decode_attention_partials",
             "decode_attention_partials_int8":
                 "decode_attention_partials_int8",
             "rmsnorm_bwd": "rmsnorm_bwd",
             "flash_attention_fwd": "flash_attention",
             "flash_attention_fwd_f32": "flash_attention_f32",
             "flash_attention_bwd": "flash_attention_bwd",
             "flash_attention_bwd_f32": "flash_attention_bwd_f32",
             # kernel 8 through its three entries (the main paths take
             # the apply mode only)
             "rmsprop_update": ("rmsprop", "rmsprop_update_multi",
                                "rmsprop_apply_multi")}
    for r in records:
        ops = by_op[r["name"]]
        ops = (ops,) if isinstance(ops, str) else ops
        paths = {path: sum(c[op] for op in ops)
                 for path, c in path_counts.items()}
        r["launches_by_path"] = {k: n for k, n in paths.items() if n}
        r["launches"] = sum(paths.values())
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never launched on a main path")
        for sub in _shapes(r):
            del sub["shape"]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
