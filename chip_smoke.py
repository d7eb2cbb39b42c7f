#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout (it imports ``repro_torch`` from ``src/`` beside
this file; never JAX, never ``repro``).  Phases, any failure exits
non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at
   the two paths' shapes and at ragged ones: int32 and int8 outputs
   equal, fp32 outputs bitwise equal, V-ACT's softmax within
   rtol=1e-6 (its row sum runs in another order); the split-K Q-MAC
   over the edges of its slices, its counters and two streams, and the
   band-staged Q-Conv over channel counts, strides, kernels, paddings,
   a band past 48 KB of shared memory and a row past 227 KB (refused);
   V-ACT's elementwise kernel at 1, 6, 13 and 24 iterations, sizes
   around its float4 items, and strided views read in place (the LSTM's
   gate slices at each offset, a view off 16-byte alignment, a row
   stride not a multiple of 4), one launch and no copy on a gate slice;
   the Q-LSTM cell over batch and hidden edges of its grid, Din = 37,
   a stripe off 4-byte alignment and a footprint past 227 KB (refused);
   the LSTM cell's xla and pallas branches on the card against the CPU;
   V-ACT's softmax in each of its three kernels at their bounds (rows
   of 1-65,536 elements, -inf and +-3e38 entries, row-strided views in
   one launch and no copy) and its int8 table kernel over every code,
   four scales, sizes to 2^26 + 3 and views off 16-byte alignment;
   Q-MAC's int32 product at the fxp8 actor's four shapes ([M, 4] x
   [4, 64], [M, 64] x [64, 64], [M, 64] x [64, 2], [M, 64] x [64, 1]) at
   M = 32 and ragged M; V-ACT at the pinned CORDIC input x = 4.2331 and
   its neighbours (tanh at x, sigmoid at 2x, n 6, 7, 13), tanh at n = 6
   equal to the JAX reference's eager value; Q-Conv and Q-MAC at the
   pixel runs' convs and products, and Q-MAC at the value runs' other
   two ([M, 3] x [3, 64], [M, 128] x [128, 96]); both Q-MAC products at
   TinyLlama's (K, N) = (2048, 2048), (2048, 256), (2048, 5632), (5632,
   2048) at M = 4, 128 and 4096 and its head (2048, 32000) at M = 4 and
   8, with w8 and w4 codes; the fused Q-MAC at whisper's (1280, 1280),
   (1280, 5120), (5120, 1280) at M = 4, 128 and 3584 and its head (1280,
   51968) at M = 4 and 8, and at mamba2's (2560, 10576), (5120, 2560)
   and recurrentgemma's (4096, 4096), (4096, 256), (4096, 12288),
   (12288, 4096) at M = 4, 128 and 4096 and their heads (2560, 50304)
   and (4096, 256000) at M = 4 and 8, with w8 and w4 codes; the fused
   Q-MAC batched over experts (``qmac_i8_deq_bmm``) at qwen3-moe's
   expert products, E = 128 and (K, N) = (2048, 768) and (768, 2048)
   at C = 4, 10 and 320, at ragged C, K and N, over a split K's slice
   edges and at one expert against ``qmac_i8_deq``, and both Q-MAC
   products at qwen3-moe's attention and head, with w8 and w4 codes;
   both Q-MAC products at the shards of TinyLlama's laid-out step on
   rank 0 of the (16, 16) mesh (``LAID_OUT_KN``: (2048, 128), (128,
   2048), (2048, 352), (352, 2048), (2048, 2000)) at M = 1,024;
4. time each kernel beside its plain version and, where one exists, a
   single PyTorch call computing the same function (CUDA events, median
   of 60 launches queued behind a device sleep so host overhead does not
   enter; ``torch.tanh`` and ``torch.softmax`` as approximate yardsticks
   of the CORDIC kernels), with each call's launch plan, and compute
   each kernel's bound on an H100; V-ACT also on a gate slice as the
   LSTM's xla branch passes it, softmax at LSTM-HRL's [128, 4], at
   [4096, 8192] and [256, 65536], int8 at 2^26 elements, and a
   1-element V-ACT call as the launch floor under this timing; Q-MAC
   also at the fxp8 actor's [32, 64] x [64, 64] and [32, 4] x [4, 64];
   the fused Q-MAC at TinyLlama's products at M = 4 (a decode step at
   batch 4) and M = 4096 (an 8 x 512 prefill), and its head, each with
   its launch plan, its bound and, as a yardstick, ``torch._int_mm``
   followed by the two scale multiplies (cuBLASLt's int8 tensor cores;
   at M <= 16, which it refuses, on the rows padded with zeros to 32),
   summed over a decode step's and a prefill's 155 products; the same
   for whisper's products, summed over a decode step at batch 4 (257) and
   an 8 x 448 prefill (513), and for mamba2's (129) and recurrentgemma's
   (293), summed over a decode step at batch 4 and an 8 x 512 prefill;
   the batched Q-MAC at qwen3-moe's expert shapes at C = 4 and 320,
   beside a yardstick of ``torch._int_mm`` and the scale multiplies
   once an expert (128 calls timed as one host loop, not a single
   call; rows padded to 32 at C = 4), summed over a forward's 12;
   ``qmac_i8`` at each shard of the laid-out step (``LAID_OUT_KN``) at
   M = 1,024 beside ``torch._int_mm``, as TinyLlama's training rows;
5. the serving path: build a conv DQN for keydoor at full width (seed
   0), save it as a checkpoint, and serve it through
   ``repro_torch.launch.serve_policy`` at w8 and at w4 with parity
   checks, counting kernel launches; then hold the served Q-values on
   the card against the plain path on the CPU;
6. profile served forwards of a full bucket (device time by kernel,
   host wall time, idle share);
7. the HRL path: the paper's E2HRL agent at its published width
   (32x32x3 keydoor frames, conv channels (16, 32, 32), seed 0), FC-HRL
   on 512 frames and LSTM-HRL on 128 windows of 4 frames, under
   ``FXP8`` with CORDIC activations at ``pallas`` (fused Q-LSTM) and
   ``xla`` (Q-MAC gates + V-ACT), and FC-HRL with packed w8 weights;
   logits and values on the card bitwise equal to the plain path on
   the CPU, probabilities within rtol=1e-6; 64 greedy keydoor steps;
   frames/s per variant; counting kernel launches;
8. profile LSTM-HRL forwards at pallas and at xla (device time by
   kernel, idle share, launches per forward: the port's from its
   wrappers' counters, PyTorch's from a trace whose every kernel row is
   a whole multiple of the forwards, traced again up to three times,
   else "not measured");
9. the training path: ``rl_train``'s default run (ppo on cartpole, the
   mlp agent at hidden 64, fxp8 actors on Q-MAC, an fp32 learner, an
   8-bit weight sync, 40 iterations of 32 envs x 128 steps, the fleet
   sharded over ``--mesh host``'s one rank, as phase 18 sets out) at seeds 0,
   1 and 2, each seed a job of its own among phases 10 and 11's (see
   there): greedy return (the median must reach half the JAX
   reference's median at seeds 0-4), env steps/s, the wall split between
   weight sync, rollout and learner, and Q-MAC's launches, exactly
   4 x 129 in every iteration; then one default iteration on the card
   against the CPU with the same params, states and draws (every action
   equal; log-probs and values within rtol 1e-5 at every (step, env)
   whose actor forward has the same int8 codes on both devices, the rows
   whose codes differ, where an ulp of the devices' libm flipped a code
   at a rounding tie, exempt and counted; params within atol 1e-5 + rtol
   1e-4), and a profile of the iteration's rollout and learner phases;
10. training from pixels: the paper's E2HRL agent with two-stage PPO on
   keydoor (``--env keydoor --agent hrl --two-stage``, 40 iterations a
   stage) and the conv actor-critic over the pixel pipeline on catch
   (``--env catch --net conv --frame-stack 4``, 40 iterations), both at
   32 envs x 128 steps with fxp8 actors on Q-Conv and Q-MAC, at seeds 0,
   1 and 2, and one iteration of each on the card against the CPU
   (E2HRL: one of each stage), each job in a process of its own, with
   phase 9's and 11's jobs, as many at once as the host has cores and
   the longest first: greedy return (the median must reach half the way
   from the untrained policy's to the JAX reference's median at seeds
   0-2), env
   steps/s, the wall split, Q-Conv and Q-MAC launches exactly 3 + 5 and
   2 + 3 per actor forward in every iteration; the card-vs-CPU bars of
   phase 9, with both learners run from the CPU's rollout, Adam's moments
   held as the params and, in stage "action", the sub-goal subtree
   bitwise unchanged on both; then a profile of each run's iteration;
11. the value family: ``rl_train``'s value runs at their defaults (32
   envs x 8 steps, 300 iterations, replay capacity 50,000, n-step 3, 4
   updates an iteration, fxp8 behaviour actors on Q-MAC and Q-Conv, an
   fp32 learner), each through ``--mesh host --sync lockstep`` at one
   rank: ``--algo dqn`` on cartpole, ``--algo qrdqn --env
   catch --net conv --frame-stack 4`` and ``--algo ddpg --env
   pendulum``, at seeds 0, 1 and 2, in processes of their own among
   phase 10's: greedy return (the median must reach half the way from
   the untrained reference's median to the trained reference's at
   seeds 0-2), env steps/s, the wall split, Q-MAC and Q-Conv launches
   exactly 3, 2 + 2 and 3 per behaviour forward in every iteration;
   one iteration of each run, and of dqn ``--replay per`` and ddpg
   ``--tqc-drop 2`` without the mesh, on the card against the CPU
   (actions equal, and
   observations within rtol 1e-5, in every env up to its first row
   whose int8 codes differ, such rows counted; the learners from the
   CPU's rollout, each update held from the CPU's state as phase 10
   holds them); the sum tree at 50,000 slots bitwise on both devices
   after updates with duplicate slots, ``find`` equal; then a profile
   of each run's iteration;
12. observability and serving the value checkpoints: phase 11's seed-0
   job of each value run also writes ``--metrics-dir`` telemetry and its
   last iteration's checkpoint; the ``train.jsonl`` of each read back
   (step windows tiling [0, 300), 76,800 env steps, ``steps_per_s`` in
   every window); each checkpoint served through ``serve_policy`` on the
   card at w8 with ``--check-parity`` (no mismatching row) and at w4,
   with ``--metrics-dir`` (actions/s, p50/p99, the served mean return),
   its served forward's launches held exactly (Q-MAC's fused product 3,
   Q-Conv 2 + 2, 3) and profiled as phase 6 profiles; PPO and DQN on cartpole, 6 iterations each with and
   without ``--metrics-dir``, history and params bitwise equal; a
   ``--profile-dir`` window of 2 PPO steps whose trace holds a ``qmac``
   kernel row;
13. serving TinyLlama-1.1B at its published widths (22 layers, d_model
   2048, 32 heads, 4 KV heads, d_ff 5632, vocab 32,000; random weights
   from seed 0, drawn once, PTQ'd once a policy) through
   ``repro_torch.launch.serve.generate`` (the loop ``serve`` runs):
   w8a8kv8 at batch 4, prompt 32, gen 16 and at batch 8, prompt 512,
   gen 32, and w4a8 at batch 4, prompt 32, gen 16, each after a warm-up
   call at its batch and prompt: PTQ MiB, prefill and
   decode tok/s, the first ids; exactly 155 ``qmac_i8_deq`` a forward
   (22 x 7 + the head) and 155 x gen a call, no ``qmac_i8``, every id in
   [0, 32000); then the same model at 2 layers on the card and on the
   CPU from the same PTQ'd params (the card's PTQ of the same fp32
   params bitwise the CPU's): a 4 x 32 prefill and 8 greedy steps,
   every int8 activation code compared by row and forward, tokens equal
   but in rows after a differing code (counted), logits within 1e-5 of
   their largest magnitude in the other rows; and a profile of a decode
   step and an 8 x 512 prefill (device time by kernel, idle share, the
   port's launches and PyTorch's);
14. serving whisper-large-v3 at its published widths (d_model 1280, 20
   heads, d_ff 5120, vocab 51,866) and 16 + 16 of its 32 + 32 layers
   (random weights from seed 0, drawn once; stub frame embeddings as
   long as the prompt)
   through ``generate``: w8a8kv8 at batch 4, prompt 32, gen 16 and
   at batch 8, prompt 448, gen 16, and w4a8 at batch 4, prompt 32, gen
   16, each after a warm-up call at its batch and prompt: PTQ MiB,
   prefill and decode tok/s, the first ids; exactly 257 + 129 x (gen -
   1) ``qmac_i8_deq`` a call, no ``qmac_i8``, every id in [0, 51866);
   then the model at 2 + 2 layers on the card and on the CPU from the
   same PTQ'd params, frames and prompts: a 4 x 32 prefill and 8 greedy
   steps, every int8 activation code, every logit and all 36 tokens
   equal; and a profile of a decode step and an 8 x 448 prefill, with
   Q-MAC's share of the busy time;
15. serving mamba2-2.7b (64 layers, d_model 2560, d_inner 5120, 80 SSD
   heads, state 128, vocab 50,280) and recurrentgemma-9b (12 (R, R, A)
   super-blocks and an R, R tail, d_model 4096, 16 heads over 1 KV head,
   window 2048, d_ff 12288, vocab 256,000) at their published widths
   (mamba2 at 16 of its 64 layers; recurrentgemma at 5 of its 38: one
   super-block and the tail),
   each fp32 tree drawn once on the card (the host's peak RSS and the
   card's peak allocation printed), through ``generate``: w8a8kv8 decode
   at batch 4 (prompt 128, one SSD chunk, and 32), an 8 x 512 prefill,
   and w4a8 decode, each after a warm-up call: PTQ MiB, tok/s, exactly
   33 and 40 ``qmac_i8_deq`` a forward, no ``qmac_i8``; a profile of a
   decode step and an 8 x 512 prefill (launches, idle share, Q-MAC's
   share of the busy time); card against CPU at full width (mamba2 at 2
   layers, a 4 x 128 prompt, 8 greedy steps; recurrentgemma's first
   super-block, 4 x 32, 2 greedy steps) and at the reduced
   recurrentgemma (window 8, 4 x 32, 8 greedy steps): every int8 code,
   every logit and every token equal;
16. serving qwen3-moe-30b-a3b (d_model 2048, 32 heads over 4 KV heads
   of 128, 128 experts, top 8, d_ff 768, vocab 151,936) at its
   published widths and 4 of its 48 layers (the fp32 tree the
   reference's MoE serving keeps is 122 GB at 48), drawn once on the
   card and served with ``weight_ptq=False``, as the reference serves
   MoE: w8a8kv8 decode at batch 4 x 32, an 8 x 512 prefill and w4a8
   decode, each after a warm-up call: tok/s, exactly 3
   ``qmac_i8_deq_bmm`` and 4 ``qmac_i8`` launches a layer and 1 for
   the head each forward; the assignments dropped over capacity by
   layer at the 8 x 512 prefill; a profile of a decode step and an
   8 x 512 prefill (Q-MAC's share of the busy time); card against CPU
   on the first 2 layers cut from the same tree (a 4 x 32 prefill and
   4 greedy steps) and on reduced mixtral-8x22b (window 8, a ring
   cache) at w8a8kv8 and w4a8: every int8 code, every logit, every
   expert each layer chose and every token equal;
17. training TinyLlama-1.1B at its published widths, all 22 layers,
   through ``repro_torch.launch.train.train(..., smoke=False)`` on the
   one-rank NCCL host mesh at the reference CLI's defaults (8 x 128
   tokens a step, w8a8, AdamW, warmup-cosine; random weights from seed
   0), 6 steps, each rematerialised as the config asks: exactly 309
   ``qmac_i8`` (155 in the forward, the 22 layers' 154 again in the
   backward) and no fused launch a step, every loss finite and the
   last at most the first + 1, the step-0 loss beside ln 32000, tok/s
   after the warm-up step, the card's peak allocation; a profile of one
   step, its forward, forward and backward, and AdamW; then one
   training step card against CPU at full width and 2 layers (batch
   2 x 128) and at every config of the registry reduced (batch 2 x 32,
   the MoE experts on the batched kernel): every int8 code of the
   forward equal, the loss at rtol 1e-6, each gradient leaf within 1e-5
   of its largest magnitude, AdamW given the CPU's gradient within
   atol 1e-5 + rtol 1e-4; phases 3-4 hold ``qmac_i8`` at the five
   training products at M = 1,024 and time them beside
   ``torch._int_mm``;
18. the sharded actor-learner fleet (``repro_torch.launch.mesh``,
   ``rl/actor_learner.collect_sharded``, the sharded value iteration,
   ``optim/compression``) on a NCCL group of one rank, the world the
   one card allows (NCCL takes one rank a device): the mesh's banner;
   PPO on cartpole at phase 9's widths, 4 iterations, through the mesh
   and through the plain collect in turns (plain, mesh, mesh, plain),
   params and history bitwise, exactly 4 x 129 ``qmac_i8`` each
   iteration; each value algorithm ``--sync lockstep`` against its
   unsharded run, 6 iterations (DQN in turns; QR-DQN on catch with the
   conv torso, 4 stacked frames and PER; DDPG on pendulum), params,
   target, optimizer, replay, envs and history bitwise; QR-DQN with PER
   ``--sync doublebuf`` twice, bitwise and finite;
   ``compressed_psum_mean`` on 4 M fp32 elements over NCCL at 8 and 32
   bits, both strategies, bitwise the same call over gloo on the CPU,
   timed; the path's launches, summed over the runs through the mesh
   alone, each counted from 0;
19. the LM layout on the one-rank NCCL mesh: 2 full-width TinyLlama
   training steps of ``make_train_step(cfg, make_host_mesh(), ...)``
   from phase 17's params bitwise 2 unsharded ones (params, ``mu``,
   ``nu``, ``count``, losses, grad norms), 309 ``qmac_i8`` a step in
   each; one qwen3-moe layer at its published widths on 8 x 512 tokens
   through ``moe_shard_map`` bitwise the CPU's plain path and the global
   ``moe_apply`` on the card, 3 ``qmac_i8_deq_bmm``;
20. the static analysis on the card (``repro_torch.analysis``, within
   ``ANALYSIS_LIMIT_S``): the lint over ``src/repro_torch`` with 0 kept
   findings and 0 stale allowlist entries (the suppressed count per
   rule printed), then the full trace audit on the card — one real
   iteration of each of the 54 accepted combos and the 5 sharded value
   combos at one NCCL rank under the op recorder, and the 2 serving
   ladders — with 0 findings after the allowlist and every fxp8 combo
   raising its kernel's launch counter; the combos checked, the leaves
   QF904 held and the phase's seconds printed;
21. the dry run against the card (``repro_torch.launch.{steps,
   hlo_analysis,roofline,dryrun}``, within ``DRY_RUN_LIMIT_S``): at
   TinyLlama-1.1B's full width, the steps phases 13 and 17 run (an
   8 x 512 prefill and a decode step at batch 4 with a cache of 48 at
   w8a8kv8, a training step of 8 x 128 at w8a8) on the one-rank NCCL
   mesh, each traced on the meta device (``lower_cell``) and run once
   on the card under the same recorder, from inputs drawn on the card:
   the two traces equal call by call (so the histograms, flops, integer
   ops, bytes and collective bytes), the Q-MAC records equal the
   wrappers' launch counters (155 a forward, 309 a rematerialised
   training step), the device busy time
   (``_profiled``) at least the roofline's ``t_step``, and the card's
   peak allocation over the step against the forecast (arguments +
   temps) within ``DRY_RUN_MEMORY_BAR``; meanwhile, beside phases 21
   to 23, one production cell, ``python -m repro_torch.launch.dryrun
   --arch qwen2-72b --shape train_4k``, in a process of its own with no
   card: exit 0 and its roofline line within ``DRY_RUN_CELL_LIMIT_S``;
22. rematerialisation (``repro_torch.nn.remat``, within
   ``REMAT_LIMIT_S``): (a) from phase 17's trained TinyLlama params, a
   fresh AdamW state and the run's first batch (8 x 128, w8a8), one
   ``make_train_step`` step with ``cfg.remat`` on and one with it off:
   params, ``mu``, ``nu``, ``count``, loss and grad norm bitwise equal,
   309 and 155 ``qmac_i8`` launches, each step's card peak allocation
   and device busy ms beside each other; (b) one full-width TinyLlama
   step at train_4k's sequence length (4,096) on the one-rank NCCL
   mesh, remat on as the config asks, at the largest batch of
   ``REMAT_BATCHES`` whose dry-run forecast (arguments + temps, traced
   on the meta device in a process of its own beside phases 21 and 22
   (a)) leaves ``REMAT_FREE`` of the card's memory free: the forecast
   with remat and without it, the card's peak, the step's wall and busy
   time, a finite loss, 316 ``qmac_i8`` launches (the head twice a CE
   chunk) and the card's peak against the forecast within
   ``DRY_RUN_MEMORY_BAR``;
23. the laid-out training step (``make_train_step(...,
   shardings=p_shard)``: the dense family on params laid out by
   ``make_shardings``, FSDP over "data", products split over "model",
   gradients reduce-scattered in slot order; within
   ``LAYOUT_LIMIT_S``): (a) from phase 17's trained TinyLlama params, 2
   steps on the one NCCL rank's blocks bitwise 2 unsharded steps
   (params, ``mu``, ``nu``, ``count``, losses, grad norms), 309
   ``qmac_i8`` a step; (b) rank 0 of the (16, 16) production mesh (a
   ``MeshShape``) at train_4k, 16 rows of 4,096 tokens, remat on:
   ``lower_cell``'s meta trace and the same step run once on the card
   under the same recorder equal call by call, the Q-MAC records equal
   the counters, busy >= the roofline's ``t_step``, a finite loss, the
   card's peak within ``DRY_RUN_MEMORY_BAR`` of arguments + temps; the
   arguments a rank, the temps, wall and busy time printed;
24. print the kernels' JSON line (the batched launches in
   ``qmac_i8_deq``'s row, by path), then the device line last.

Every trace (``_profiled``) records the device's activity alone.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8
# tensor-core ops/s, fp32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12

N_TIMED = 60
N_WARM = 10
FLT_MIN = 1.1754944e-38      # smallest normal fp32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, int8_ops: float = 0.0,
             fp32_ops: float = 0.0):
    """(least time in ms, what bounds it) on the published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + fp32_ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(torch, fn) -> float:
    """Median device time of one call of ``fn`` in ms: every timed call
    is bracketed by its own CUDA events, and all of them are queued
    behind a device-side sleep so they run back to back on the card."""
    for _ in range(N_WARM):
        fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(200_000_000)
    for _ in range(N_TIMED):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bits_equal(torch, a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_kernels(torch, dev):
    """Phase 3: every kernel against its plain version, bitwise."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(1234)

    def i8(shape, qmax=127):
        return torch.randint(-qmax, qmax + 1, shape, generator=g,
                             device=dev, dtype=torch.int32).to(torch.int8)

    def pos(shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02 + 1e-4

    worst = {"qmac_i8": 0.0, "qmac_i8_deq": 0.0, "qconv_i8_taps": 0.0,
             "vact_ew": 0.0, "vact_ew_q8": 0.0, "vact_softmax": 0.0,
             "qlstm_cell": 0.0}
    qmac_shapes = []
    for b in (1, 7, 32):
        qmac_shapes += [(b, 2048, 128), (b, 128, 4)]
    qmac_shapes += [(5, 12, 1), (33, 67, 40), (64, 300, 33), (1, 1, 1)]
    for (m, k, n) in qmac_shapes:
        for qmax in (127, 7):
            qx, qw = i8((m, k)), i8((k, n), qmax)
            sx, sw = pos((m, 1)), pos((1, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at M,K,N={m},{k},{n}")
            for s in (sw, sw[:, :1].contiguous()):
                got = qmac_ops.qmac_i8_deq(qx, sx, qw, s)
                want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, s)
                err = (got - want).abs().max().item()
                worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
                if not bits_equal(torch, got, want):
                    raise AssertionError(
                        f"qmac_i8_deq != plain at M,K,N={m},{k},{n} "
                        f"(max abs err {err})")
    print(f"Q-MAC: {len(qmac_shapes) * 2} shapes, int32 equal and fused "
          "fp32 bitwise equal to the plain version")

    conv_cases = []
    for b in (1, 7, 32):
        conv_cases += [((b, 32, 32, 12), (3, 3, 12, 16), 2, "SAME", True),
                       ((b, 16, 16, 16), (3, 3, 16, 32), 2, "SAME", True)]
    conv_cases += [((3, 15, 13, 5), (3, 3, 5, 7), 1, "SAME", False),
                   ((2, 17, 9, 20), (2, 2, 20, 33), 2, "VALID", True),
                   ((2, 11, 11, 40), (3, 3, 40, 16), 1, "SAME", False),
                   ((1, 7, 7, 12), (5, 5, 12, 3), 3, "VALID", False),
                   ((2, 9, 8, 12), (3, 3, 12, 48), 2, "SAME", True)]
    for xs, ws, stride, padding, relu in conv_cases:
        qx, qw = i8(xs), i8(ws)
        sx = pos(xs[:3] + (1,))
        sw = pos((ws[3],))
        bias = torch.randn(ws[3], generator=g, device=dev) * 0.1
        kw = dict(stride=stride, padding=padding, fuse_relu=relu)
        got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
        want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias, **kw)
        err = (got - want).abs().max().item()
        worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"], err)
        if not bits_equal(torch, got, want):
            raise AssertionError(f"qconv != plain at {xs} x {ws} stride "
                                 f"{stride} {padding} (max abs err {err})")
    print(f"Q-Conv: {len(conv_cases)} cases, fp32 bitwise equal to the "
          "plain version")
    torch.cuda.synchronize()
    return worst


def check_hrl_kernels(torch, dev, worst):
    """Phase 3, the HRL path's kernels: Q-Conv at the stem's three
    shapes (C_in = 3 first), Q-MAC at the agent's dense shapes, V-ACT
    (every kind, 6 and 13 iterations, fp32 and int8) and the fused
    Q-LSTM cell, each against its plain version on the card."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    from repro_torch.kernels.qmac import ops as qmac_ops
    from repro_torch.kernels.vact import ops as vact_ops

    g = torch.Generator(device=dev).manual_seed(4321)

    def i8(shape):
        return _i8(torch, g, dev, shape)

    def pos(shape, scale=0.02):
        return torch.rand(shape, generator=g, device=dev) * scale + 1e-4

    n_conv = 0
    for b in (1, 7, 64):
        for h, c, nc in ((32, 3, 16), (16, 16, 32), (8, 32, 32)):
            qx, qw = i8((b, h, h, c)), i8((3, 3, c, nc))
            sx, sw = pos((b, h, h, 1)), pos((nc,))
            bias = torch.randn(nc, generator=g, device=dev) * 0.1
            kw = dict(stride=2, padding="SAME", fuse_relu=True)
            got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
            want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias, **kw)
            err = (got - want).abs().max().item()
            worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qconv != plain at HRL stem "
                                     f"x[{b},{h},{h},{c}] (max abs err "
                                     f"{err})")
            n_conv += 1
    n_mm = 0
    for m in (1, 7, 128, 512):
        for k, n in ((512, 32), (32, 32), (32, 8), (40, 4), (40, 1)):
            qx, qw = i8((m, k)), i8((k, n))
            sx, sw = pos((m, 1)), pos((1, n))
            if not bits_equal(torch, qmac_ops.qmac_i8(qx, qw),
                              qmac_ops.qmac_i8_plain(qx, qw)):
                raise AssertionError(f"qmac_i8 != plain at {m},{k},{n}")
            got = qmac_ops.qmac_i8_deq(qx, sx, qw, sw)
            want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, sw)
            worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"],
                                       (got - want).abs().max().item())
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8_deq != plain at "
                                     f"{m},{k},{n}")
            n_mm += 1
    print(f"HRL shapes: Q-Conv {n_conv} cases (C_in 3, 16, 32) and Q-MAC "
          f"{n_mm} cases bitwise equal to the plain versions")

    edge = torch.tensor([0.0, 1e-8, -1e-8, 1.0, -1.0, 30.0, -30.0, 100.0,
                         -100.0, 88.5, -88.5], device=dev)

    def fp(shape):
        x = torch.randn(shape, generator=g, device=dev) * 4
        flat = x.view(-1)
        k = min(edge.numel(), flat.numel())
        flat[:k] = edge[:k]
        return x

    n_ew = 0
    for shape in ((512, 8), (128, 32), (1, 1), (7, 33), (300, 301),
                  (3, 5, 11)):
        x = fp(shape)
        qx = i8(shape)
        sx = pos((), 0.05)
        for n in (6, 13):
            for kind in ("relu", "sigmoid", "tanh"):
                got = vact_ops.vact(x, kind, n)
                want = vact_ops.vact_ew_plain(x, kind, n)
                err = (got - want).abs().max().item()
                worst["vact_ew"] = max(worst["vact_ew"], err)
                if not bits_equal(torch, got, want):
                    raise AssertionError(f"vact_ew {kind} n={n} != plain "
                                         f"at {shape} (max abs err {err})")
                got = vact_ops.vact_q8(qx, sx, kind, n)
                want = vact_ops.vact_q8_plain(qx, sx, kind, n)
                err = (got.int() - want.int()).abs().max().item()
                worst["vact_ew_q8"] = max(worst["vact_ew_q8"], err)
                if not bits_equal(torch, got, want):
                    raise AssertionError(f"vact_q8 {kind} n={n} != plain "
                                         f"at {shape} (max code err {err})")
                n_ew += 1
    print(f"V-ACT elementwise and q8: {n_ew} cases each bitwise equal to "
          "the plain versions")
    rel = 0.0
    for rows in (1, 512, 1000):
        for n_col in (1, 4, 6, 33):
            x = fp((rows, n_col))
            for n in (6, 13):
                got = vact_ops.vact(x, "softmax", n)
                want = vact_ops.vact_softmax_plain(x, n)
                err = (got - want).abs().max().item()
                worst["vact_softmax"] = max(worst["vact_softmax"], err)
                r = ((got - want).abs() / want.abs().clamp_min(
                    FLT_MIN)).max().item()
                rel = max(rel, r)
                # atol: a subnormal quotient keeps fewer significant bits
                if not torch.allclose(got, want, rtol=1e-6, atol=FLT_MIN):
                    raise AssertionError(
                        f"vact_softmax n={n} at [{rows}, {n_col}] off its "
                        f"plain version by {err} (rel {r}) > rtol 1e-6")
    print(f"V-ACT softmax: 24 cases within rtol=1e-6 of the plain version "
          f"(max abs err {worst['vact_softmax']}, max rel err {rel})")

    n_cell = 0
    for b in (1, 7, 128):
        for d_in, hid in ((32, 32), (8, 8), (40, 24)):
            args = (i8((b, d_in)), pos((), 0.02), i8((b, hid)),
                    pos((), 0.02), i8((d_in, 4 * hid)),
                    pos((1, 4 * hid), 0.004), i8((hid, 4 * hid)),
                    pos((1, 4 * hid), 0.004),
                    torch.randn(4 * hid, generator=g, device=dev) * 0.1,
                    torch.randn((b, hid), generator=g, device=dev))
            for n in (6, 13):
                got = qlstm_ops.qlstm_cell(*args, n_iters=n)
                want = qlstm_ops.qlstm_cell_plain(*args, n)
                for gt, wt, what in zip(got, want, ("h'", "c'")):
                    err = (gt - wt).abs().max().item()
                    worst["qlstm_cell"] = max(worst["qlstm_cell"], err)
                    if not bits_equal(torch, gt, wt):
                        raise AssertionError(
                            f"qlstm {what} != plain at B={b} Din={d_in} "
                            f"H={hid} n={n} (max abs err {err})")
                n_cell += 1
    print(f"Q-LSTM: {n_cell} cases, h' and c' bitwise equal to the plain "
          "version")
    torch.cuda.synchronize()
    return worst


def check_split_and_band_edges(torch, dev, worst):
    """Phase 3, the redesigned kernels at their edges: Q-MAC over every
    K x M x N of the split's edges with per-channel and per-tensor sw,
    its counters and workspaces (the same call twice, other shapes in
    between, two streams at once); Q-Conv over C in {3, 5, 12, 16, 40,
    130}, strides 1-3, SAME and VALID, 2x2/3x3/5x5 kernels, N in {3, 16,
    33, 48}, a band in more than 48 KB of shared memory, and a row past
    227 KB, which must raise."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(2468)

    def i8(shape):
        return _i8(torch, g, dev, shape)

    def pos(shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02 + 1e-4

    def mm_case(m, k, n):
        return i8((m, k)), i8((k, n)), pos((m, 1)), pos((1, n))

    def mm_check(qx, qw, sx, sw, what):
        got = qmac_ops.qmac_i8(qx, qw)
        want = qmac_ops.qmac_i8_plain(qx, qw)
        worst["qmac_i8"] = max(worst["qmac_i8"], float(
            (got.long() - want.long()).abs().max().item()))
        if not bits_equal(torch, got, want):
            raise AssertionError(f"qmac_i8 != plain at {what}")
        for s in (sw, sw[:, :1].contiguous()):
            got = qmac_ops.qmac_i8_deq(qx, sx, qw, s)
            want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, s)
            err = (got - want).abs().max().item()
            worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8_deq != plain at {what} "
                                     f"(max abs err {err})")

    n_mm = 0
    for k in (1, 15, 16, 17, 40, 2047, 2048, 2049, 131072):
        for m in (1, 2, 31, 32, 33, 512):
            for n in (1, 4, 33, 128):
                mm_check(*mm_case(m, k, n), f"M,K,N={m},{k},{n} "
                         f"({qmac_ops.split_plan(m, k, n)})")
                n_mm += 1
    # counters: the same split call twice, other shapes in between
    fc, other = mm_case(32, 2048, 128), mm_case(512, 512, 32)
    qx, qw, sx, sw = fc
    want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, sw)
    runs = [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(2)]
    for _ in range(3):
        for case in (other, fc, mm_case(8, 4096, 4)):
            mm_check(*case, "interleaved shapes")
    # two streams at once, each with its own workspace and counters
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    runs += [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(8)]
    with torch.cuda.stream(side):
        runs += [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(8)]
    main.wait_stream(side)
    torch.cuda.synchronize()
    for got in runs:
        if not bits_equal(torch, got, want):
            raise AssertionError("qmac_i8_deq: a repeated split call or a "
                                 "call on a second stream changed bits")
    print(f"Q-MAC split-K edges: {n_mm} shapes x (int32, per-channel, "
          f"per-tensor) equal to the plain version; {len(runs)} repeated "
          "and two-stream calls bitwise equal")

    n_conv = 0
    for c in (3, 5, 12, 16, 40, 130):
        i = 0
        for stride in (1, 2, 3):
            for kk in (2, 3, 5):
                for padding in ("SAME", "VALID"):
                    n = (3, 16, 33, 48)[i % 4]
                    b, h, w = 1 + i % 3, 13 + i % 4, 11 + 2 * (i % 3)
                    i += 1
                    qx, qw = i8((b, h, w, c)), i8((kk, kk, c, n))
                    sx, sw = pos((b, h, w, 1)), pos((n,))
                    bias = torch.randn(n, generator=g, device=dev) * 0.1
                    kw = dict(stride=stride, padding=padding,
                              fuse_relu=bool(i % 2))
                    got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
                    want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias,
                                                      **kw)
                    err = (got - want).abs().max().item()
                    worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"],
                                                 err)
                    if not bits_equal(torch, got, want):
                        raise AssertionError(
                            f"qconv != plain at x[{b},{h},{w},{c}] "
                            f"w[{kk},{kk},{c},{n}] stride {stride} "
                            f"{padding} (max abs err {err})")
                    n_conv += 1
    b, h, w, c, n = 1, 8, 512, 40, 16
    plan = qconv_ops.band_plan(b, h, w, c, 3, 3, n, 1, "SAME")
    if plan.smem <= 48 * 1024:
        raise AssertionError(f"the wide case takes only {plan.smem} bytes")
    qx, qw = i8((b, h, w, c)), i8((3, 3, c, n))
    sx, sw = pos((b, h, w, 1)), pos((n,))
    bias = torch.randn(n, generator=g, device=dev) * 0.1
    if not bits_equal(torch, qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias),
                      qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias)):
        raise AssertionError(f"qconv != plain with a {plan.smem}-byte band")
    before = qconv_ops.qconv2d_i8.launches
    try:
        qconv_ops.qconv2d_i8(
            torch.zeros((1, 4, 2048, 40), dtype=torch.int8, device=dev),
            torch.ones((1, 4, 2048, 1), device=dev),
            torch.zeros((3, 3, 40, 16), dtype=torch.int8, device=dev),
            torch.ones(16, device=dev), torch.zeros(16, device=dev))
    except ValueError as e:
        print(f"Q-Conv refused a row past 227 KB: {e}")
    else:
        raise AssertionError("Q-Conv ran a row past 227 KB of shared "
                             "memory")
    if qconv_ops.qconv2d_i8.launches != before:
        raise AssertionError("the refused Q-Conv launched")
    torch.cuda.synchronize()
    print(f"Q-Conv band edges: {n_conv} cases and a {plan.smem}-byte band "
          "bitwise equal to the plain version")
    return worst


def check_ew_and_cell_edges(torch, dev, worst):
    """Phase 3, the redesigned V-ACT elementwise kernel and Q-LSTM cell
    at their edges, bitwise against the plain versions: every kind at
    n in {1, 6, 13, 24} and 1, 3, 4095, 4096, 4097 elements; strided
    views read in place (gate slices of [B, 4H] at each offset, views
    off 16-byte alignment, a row stride of 130, a 3-D view, and views
    past one wave and past the grid's cap, where threads stride), with one
    device launch and no copy on a gate slice (profiler); the cell at B
    in {1, 7, 128, 129, 512} x H in {1, 3, 32, 33, 64}, Din = H and Din
    = 37, a stripe off 4-byte alignment, and a footprint past 227 KB
    refused with no launch; the LSTM cell's two branches against the
    CPU."""
    from repro_torch import kernels
    from repro_torch.core.policy import FXP8
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    from repro_torch.kernels.vact import ops as vact_ops
    from repro_torch.nn import lstm

    g = torch.Generator(device=dev).manual_seed(1357)
    edge = torch.tensor([0.0, 1e-8, -1e-8, 1.0, -1.0, 30.0, -30.0, 100.0,
                         -100.0, 88.5, -88.5], device=dev)

    def fp(shape):
        x = torch.randn(shape, generator=g, device=dev) * 4
        flat = x.view(-1)
        k = min(edge.numel(), flat.numel())
        flat[:k] = edge[:k]
        return x

    def ew_check(x, kind, n, what):
        before = vact_ops.vact_ew.launches
        got = vact_ops.vact_ew(x, kind, n)
        if vact_ops.vact_ew.launches != before + 1:
            raise AssertionError(f"vact_ew at {what}: not one launch")
        want = vact_ops.vact_ew_plain(x.contiguous(), kind, n)
        err = (got - want).abs().max().item()
        worst["vact_ew"] = max(worst["vact_ew"], err)
        if not (got.is_contiguous() and bits_equal(torch, got, want)):
            raise AssertionError(f"vact_ew {kind} n={n} != plain at {what} "
                                 f"(max abs err {err})")

    n_ew = 0
    for numel in (1, 3, 4095, 4096, 4097):
        x = fp((numel,))
        for n in (1, 6, 13, 24):
            for kind in ("relu", "sigmoid", "tanh"):
                ew_check(x, kind, n, f"{numel} elements")
                n_ew += 1
    views = []
    for b, h in ((128, 32), (7, 3), (129, 33)):
        gates = fp((b, 4 * h))
        views += [(f"gate {k} of [{b}, {4 * h}]",
                   gates[:, k * h:(k + 1) * h]) for k in range(4)]
    flat = fp((4099,))
    views += [("a contiguous view 4 B off alignment", flat[1:4098]),
              ("rows of 40, 4 B off alignment",
               flat[1:4001].view(100, 40)[:, :32]),
              ("row stride 130", fp((128, 130))[:, 2:34]),
              ("3-D, leading axes folded", fp((4, 32, 12))[:, :, 4:12])]
    # past one wave of one-element threads (132 x 256) and past the
    # grid's cap, where a thread strides over rows
    wave = vact_ops.SMS * vact_ops.EW_MAX_THREADS
    rows = -(-vact_ops.EW_MAX_BLOCKS * vact_ops.EW_MAX_THREADS // 32) + 100
    wide = fp((rows * 40 + 1,))
    views += [(f"[{wave + 3}] contiguous", fp((wave + 3,))),
              (f"[{rows}, 32] slice of [{rows}, 128]",
               fp((rows, 128))[:, 32:64]),
              (f"[{rows}, 32] at row stride 130", fp((rows, 130))[:, 2:34]),
              (f"[{rows}, 32] at row stride 40, 4 B off alignment",
               wide[1:].view(rows, 40)[:, :32])]
    for what, x in views:
        op = vact_ops.ew_operand(tuple(x.shape), x.stride())
        if op is None:
            raise AssertionError(f"vact_ew would copy {what}")
        for n in (6, 13):
            for kind in ("relu", "sigmoid", "tanh"):
                ew_check(x, kind, n, what)
                n_ew += 1
    # a gate slice is one device launch: the kernel, no copy before it
    gates = fp((128, 128))
    _, rows, per_call, why = _profiled(torch, lambda: (
        vact_ops.vact_ew(gates[:, 32:64], "sigmoid", 6),
        torch.cuda.synchronize()), 5)
    names = [name for _, _, name in rows]
    if per_call != 1 or not all("vact_ew" in name for name in names):
        raise AssertionError(f"vact_ew on a gate slice ran {per_call} "
                             f"device launches a call ({why}): {names}")
    print(f"V-ACT elementwise edges: {n_ew} cases bitwise equal to the "
          f"plain version ({len(views)} views read in place); a "
          f"gate slice is {per_call:g} device launch a call ({names[0]})")

    n_cell = 0
    for b in (1, 7, 128, 129, 512):
        for h in (1, 3, 32, 33, 64):
            for d_in, n, offset in ((h, 6, 0), (37, 13, 0), (37, 24, 1)):
                def i8_at(shape):
                    q = _i8(torch, g, dev, (offset + shape[0] * shape[1],))
                    return q[offset:].view(shape)
                args = (_i8(torch, g, dev, (b, d_in)),
                        torch.rand((), generator=g, device=dev) * 0.02,
                        _i8(torch, g, dev, (b, h)),
                        torch.rand((), generator=g, device=dev) * 0.02,
                        i8_at((d_in, 4 * h)),
                        torch.rand((1, 4 * h), generator=g,
                                   device=dev) * 0.004,
                        i8_at((h, 4 * h)),
                        torch.rand((1, 4 * h), generator=g,
                                   device=dev) * 0.004,
                        torch.randn(4 * h, generator=g, device=dev) * 0.1,
                        torch.randn((b, h), generator=g, device=dev))
                got = qlstm_ops.qlstm_cell(*args, n_iters=n)
                want = qlstm_ops.qlstm_cell_plain(*args, n)
                for gt, wt, what in zip(got, want, ("h'", "c'")):
                    err = (gt - wt).abs().max().item()
                    worst["qlstm_cell"] = max(worst["qlstm_cell"], err)
                    if not bits_equal(torch, gt, wt):
                        plan = qlstm_ops.cell_plan(b, d_in, h)
                        raise AssertionError(
                            f"qlstm {what} != plain at B={b} Din={d_in} "
                            f"H={h} n={n} offset {offset} ({plan}; max "
                            f"abs err {err})")
                n_cell += 1
    big = (torch.zeros((4, 8192), dtype=torch.int8, device=dev),
           torch.ones((), device=dev),
           torch.zeros((4, 8), dtype=torch.int8, device=dev),
           torch.ones((), device=dev),
           torch.zeros((8192, 32), dtype=torch.int8, device=dev),
           torch.ones(32, device=dev),
           torch.zeros((8, 32), dtype=torch.int8, device=dev),
           torch.ones(32, device=dev), torch.zeros(32, device=dev),
           torch.zeros((4, 8), device=dev))
    before = qlstm_ops.qlstm_cell.launches
    try:
        qlstm_ops.qlstm_cell(*big, n_iters=6)
    except ValueError as e:
        print(f"Q-LSTM refused a block past 227 KB: {e}")
    else:
        raise AssertionError("Q-LSTM ran a block past 227 KB of shared "
                             "memory")
    if qlstm_ops.qlstm_cell.launches != before:
        raise AssertionError("the refused Q-LSTM cell launched")
    print(f"Q-LSTM edges: {n_cell} cases, h' and c' bitwise equal to the "
          "plain version")

    p_cpu = lstm.lstm_init(torch.Generator().manual_seed(0), 32, 32)
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    xs = torch.randn((128, 4, 32), generator=torch.Generator().manual_seed(1))
    for backend in ("xla", "pallas"):
        pol = FXP8.replace(backend=backend, act_backend="cordic")
        kernels.reset_launch_counts()
        hs, (h, c) = lstm.lstm_apply(p_dev, xs.to(dev), pol)
        counts = kernels.launch_counts()
        want_hs, (want_h, want_c) = lstm.lstm_apply(p_cpu, xs, pol)
        for got, want in ((hs, want_hs), (h, want_h), (c, want_c)):
            if not bits_equal(torch, got.cpu(), want):
                raise AssertionError(f"LSTM {backend}: card and CPU differ")
        # xla: four gates and tanh(c') a step; pallas: one fused cell
        if (counts["vact_ew"], counts["qlstm_cell"]) != (
                (20, 0) if backend == "xla" else (0, 4)):
            raise AssertionError(f"LSTM {backend}: launches {counts}")
        print(f"LSTM cell, {backend}, 4 steps of B=128 Din=H=32: card "
              f"bitwise equal to the CPU; vact_ew {counts['vact_ew']}, "
              f"qlstm_cell {counts['qlstm_cell']} launches")
    torch.cuda.synchronize()
    return worst


SOFTMAX_COLS = (1, 2, 3, 4, 5, 31, 32, 33, 1023, 1024, 1025, 58079, 58080,
                58081, 65536)
# past each softmax kernel's grid cap, where its rows stride over the
# grid: the rows kernel at 1, 4 and 32 lanes, the block kernel at one
# warp, staging a whole row and past shared memory
SOFTMAX_STRIDED = ((600000, 1), (200000, 4), (20000, 32), (20000, 100),
                   (4096, 1025), (4096, 8192), (2113, 58081))


def check_softmax_and_q8_edges(torch, dev, worst):
    """Phase 3, V-ACT's redesigned softmax and int8 kernels at their
    edges.  Softmax within rtol=1e-6 of the plain version (NaN where it
    gives NaN): each kernel at its bounds (cols 1-5, 31-33, the block
    kernel's one-warp bound +-1, shared memory's limit +-1, a
    65,536-float row past it) over 1, 7, 512 and 1000 rows at n in {1, 6,
    13, 24}; rows past each kernel's grid cap (``SOFTMAX_STRIDED``) at n
    in {6, 13}; rows with -inf entries and entries near +-3e38; row-strided views
    read in place, one device launch and no copy.  The int8 kernel
    bitwise: every code (-128 included) at scales 1e-30, 0.003, 0.05 and
    3.0 for each kind, sizes 1-2^26 + 3 around its 16-byte chunks, and
    views off 16-byte alignment."""
    from repro_torch.kernels.vact import ops as vact_ops

    g = torch.Generator(device=dev).manual_seed(9753)
    edge = torch.tensor([0.0, 1e-8, -1e-8, 30.0, -30.0, 100.0, -100.0],
                        device=dev)

    def fp(shape):
        x = torch.randn(shape, generator=g, device=dev) * 4
        flat = x.view(-1)
        k = min(edge.numel(), flat.numel())
        flat[:k] = edge[:k]
        return x

    rel = 0.0

    def sm_check(x, n, what):
        nonlocal rel
        before = vact_ops.vact_softmax.launches
        got = vact_ops.vact_softmax(x, n)
        if vact_ops.vact_softmax.launches != before + 1:
            raise AssertionError(f"vact_softmax at {what}: not one launch")
        want = vact_ops.vact_softmax_plain(x.contiguous(), n)
        fin = torch.isfinite(want)
        err = (got - want)[fin].abs().max().item() if fin.any() else 0.0
        worst["vact_softmax"] = max(worst["vact_softmax"], err)
        if fin.any():
            rel = max(rel, ((got - want).abs() / want.abs().clamp_min(
                FLT_MIN))[fin].max().item())
        if not (got.is_contiguous() and torch.allclose(
                got, want, rtol=1e-6, atol=FLT_MIN, equal_nan=True)):
            raise AssertionError(f"vact_softmax n={n} at {what} off its "
                                 f"plain version by {err} > rtol 1e-6")

    n_sm = 0
    for cols in SOFTMAX_COLS:
        for rows in (1, 7, 512, 1000):
            x = fp((rows, cols))
            for n in (1, 6, 13, 24):
                sm_check(x, n, f"[{rows}, {cols}] "
                         f"({vact_ops.softmax_plan(rows, cols)})")
                n_sm += 1
    for rows, cols in SOFTMAX_STRIDED:
        plan = vact_ops.softmax_plan(rows, cols)
        lanes = max(plan.lanes, 1)
        if rows <= (plan.blocks * plan.threads // 32 * (32 // lanes)
                    if plan.regime == "rows" else plan.blocks):
            raise AssertionError(f"[{rows}, {cols}] fits one grid ({plan})")
        x = fp((rows, cols))
        for n in (6, 13):
            sm_check(x, n, f"[{rows}, {cols}] past the grid cap ({plan})")
            n_sm += 1
        del x
    for cols in (4, 33, 1000, 2048, 65536):
        x = fp((64, cols))
        x[0::4, 0] = -float("inf")
        x[1::4, -1] = -float("inf")
        x[2::4, 0] = 3e38
        x[2::4, -1] = -3e38
        x[3::4] = torch.where(torch.rand((16, cols), generator=g,
                                         device=dev) < 0.5, 3.3e38, -3.3e38)
        x[3::4, 0] = 3.4e38
        for n in (6, 13):
            sm_check(x, n, f"[64, {cols}] with -inf and +-3e38 entries")
            n_sm += 1
    views = [("[128, 32] at row stride 130", fp((128, 130))[:, 2:34]),
             ("3-D, leading axes folded", fp((4, 32, 12))[:, :, 4:8]),
             ("[64, 100] at row stride 257, 4 B off alignment",
              fp((64, 257))[:, 1:101]),
             ("[64, 1000] at row stride 1024", fp((64, 1024))[:, 8:1008]),
             ("[16, 4096] at row stride 8192", fp((16, 8192))[:, 4096:]),
             ("[4, 65536] at row stride 65540", fp((4, 65540))[:, 4:])]
    for what, x in views:
        op = vact_ops.softmax_operand(tuple(x.shape), x.stride())
        if op is None or op[2] != x.stride(-2):
            raise AssertionError(f"vact_softmax would copy {what}")
        for n in (6, 13):
            sm_check(x, n, what)
            n_sm += 1
        _, rows, per_call, why = _profiled(torch, lambda: (
            vact_ops.vact_softmax(x, 6), torch.cuda.synchronize()), 5)
        names = [name for _, _, name in rows]
        if per_call != 1 or "vact_softmax" not in names[0]:
            raise AssertionError(
                f"vact_softmax on {what} ran {per_call} device launches a "
                f"call ({why}): {names}; {torch.cuda.memory_reserved()} B "
                "reserved")
    print(f"V-ACT softmax edges: {n_sm} cases within rtol=1e-6 of the plain "
          f"version (max abs err {worst['vact_softmax']}, max rel err "
          f"{rel}); {len(views)} row-strided views one device launch a "
          "call, no copy")

    n_q8 = 0
    codes = torch.arange(-128, 128, device=dev,
                         dtype=torch.int32).to(torch.int8).repeat(3)

    def q8_check(qx, sx, kind, n, what):
        got = vact_ops.vact_q8(qx, sx, kind, n)
        want = vact_ops.vact_q8_plain(qx, sx, kind, n)
        err = (got.int() - want.int()).abs().max().item()
        worst["vact_ew_q8"] = max(worst["vact_ew_q8"], err)
        if not (got.is_contiguous() and bits_equal(torch, got, want)):
            raise AssertionError(f"vact_q8 {kind} n={n} != plain at {what} "
                                 f"(max code err {err})")

    for scale in (1e-30, 0.003, 0.05, 3.0):
        sx = torch.tensor(scale, device=dev)
        for kind in ("relu", "sigmoid", "tanh"):
            for n in (1, 6, 13, 24):
                q8_check(codes, sx, kind, n, f"every code, scale {scale}")
                n_q8 += 1
    sx = torch.tensor(0.05, device=dev)
    for numel in (1, 15, 16, 17, 4095, 4096, (1 << 26) + 3):
        flat = _i8(torch, g, dev, (numel + 1,))
        for what, qx in (("aligned", flat[:numel]), ("offset 1", flat[1:])):
            for kind in ("relu", "sigmoid", "tanh"):
                q8_check(qx, sx, kind, 6, f"{numel} elements, {what}")
                n_q8 += 1
    torch.cuda.synchronize()
    print(f"V-ACT int8 edges: {n_q8} cases bitwise equal to the plain "
          "version (every code at four scales, sizes around the 16-byte "
          "chunks, views off alignment)")
    return worst


# the fxp8 actor's four products at M = n_envs (torso.fc1, torso.fc2, pi,
# v of the mlp actor-critic on cartpole, hidden 64): (K, N)
ACTOR_KN = ((4, 64), (64, 64), (64, 2), (64, 1))
# x = 4.2331 (fp32 bits 0x4087758e) and its neighbours, where the JAX
# reference's eager and compiled CORDIC differ (the port follows eager)
PINNED_BITS = (0x4087758C, 0x4087758D, 0x4087758E, 0x4087758F, 0x40877590)


def check_training_kernels(torch, dev, worst):
    """Phase 3, the training path's kernel: Q-MAC's int32 product at the
    fxp8 actor's four shapes, at M = 32 (the default run's envs) and at
    ragged M, bitwise against its plain version; and V-ACT's
    elementwise kernel at the pinned CORDIC input, tanh at x and sigmoid
    at 2x, n 6, 7 and 13, bitwise against its plain version (which the
    CPU tests hold bitwise to the eager reference)."""
    from repro_torch.kernels.qmac import ops as qmac_ops
    from repro_torch.kernels.vact import ops as vact_ops

    g = torch.Generator(device=dev).manual_seed(1357)
    cases = 0
    for m in (32, 1, 4, 7, 33, 100):
        for k, n in ACTOR_KN:
            qx, qw = _i8(torch, g, dev, (m, k)), _i8(torch, g, dev, (k, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at the actor's "
                                     f"M,K,N={m},{k},{n}")
            cases += 1
    print(f"Q-MAC at the fxp8 actor's shapes: {cases} cases, int32 equal "
          "to the plain version")
    x = torch.tensor(PINNED_BITS, dtype=torch.int64).to(torch.int32).view(
        torch.float32).to(dev)
    x = torch.cat([x, -x])
    for n_it in (6, 7, 13):
        for kind, arg in (("tanh", x), ("sigmoid", 2.0 * x)):
            got = vact_ops.vact_ew(arg, kind, n_it)
            want = vact_ops.vact_ew_plain(arg, kind, n_it)
            err = (got - want).abs().max().item()
            worst["vact_ew"] = max(worst["vact_ew"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"vact_ew {kind} != plain at the "
                                     f"pinned input, n={n_it} (max abs err "
                                     f"{err})")
    # the JAX reference's eager cordic_tanh at x, n = 6 (its compiled
    # one gives 0.9995922): the shortest decimal of the fp32 value
    tanh6 = vact_ops.vact_ew(x[2:3], "tanh", 6)
    if not bits_equal(torch, tanh6, torch.tensor([0.9995657], device=dev)):
        raise AssertionError(f"vact_ew tanh at the pinned input, n=6: "
                             f"{tanh6.item()!r}, not the eager reference's "
                             "0.9995657")
    print("V-ACT at the pinned input x = 4.2331 and its neighbours: 6 "
          "cases bitwise equal to the plain version; tanh(x) at n=6 is "
          "0.9995657, the eager reference's value")
    torch.cuda.synchronize()
    return worst


# the pixel runs' actor convs (phase 10), stride 2 SAME 3x3: (H, W, C,
# C_out) of E2HRL's stem on keydoor's 32x32x3 frames and of the conv
# actor-critic on catch's 10x5 frames stacked 4 deep
PIXEL_CONVS = ((32, 32, 3, 16), (16, 16, 16, 32), (8, 8, 32, 32),
               (10, 5, 4, 16), (5, 3, 16, 32))
# and their actor products (K, N): E2HRL's stem fc, sub-goal fc1, fc2,
# action and value heads; the conv actor-critic's fc, pi and v
PIXEL_KN = ((512, 32), (32, 32), (32, 8), (40, 4), (40, 1),
            (192, 128), (128, 3), (128, 1))


def check_pixel_kernels(torch, dev, worst):
    """Phase 3, the pixel training paths' kernels: Q-Conv at every actor
    conv of both runs and Q-MAC at every actor product, at the rollout's
    batch of 32 and at ragged batches, against their plain versions
    (fp32 bitwise, int32 equal)."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(2468)
    n_conv = n_mm = 0
    for b in (32, 1, 5, 33):
        for h, w, c, nc in PIXEL_CONVS:
            qx, qw = _i8(torch, g, dev, (b, h, w, c)), _i8(torch, g, dev,
                                                         (3, 3, c, nc))
            sx = torch.rand((b, h, w, 1), generator=g, device=dev) * 0.02
            sw = torch.rand((nc,), generator=g, device=dev) * 0.02 + 1e-4
            bias = torch.randn(nc, generator=g, device=dev) * 0.1
            kw = dict(stride=2, padding="SAME", fuse_relu=True)
            got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
            want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias, **kw)
            err = (got - want).abs().max().item()
            worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qconv != plain at the pixel runs' "
                                     f"x[{b},{h},{w},{c}] -> {nc} (max abs "
                                     f"err {err})")
            n_conv += 1
        for k, n in PIXEL_KN:
            qx, qw = _i8(torch, g, dev, (b, k)), _i8(torch, g, dev, (k, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at the pixel runs' "
                                     f"M,K,N={b},{k},{n}")
            n_mm += 1
    torch.cuda.synchronize()
    print(f"Q-Conv at the pixel runs' {len(PIXEL_CONVS)} actor convs and "
          f"Q-MAC at their {len(PIXEL_KN)} products, batches 32, 1, 5 and "
          f"33: {n_conv} and {n_mm} cases equal to the plain versions")
    return worst


def _i8(torch, g, dev, shape):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int32).to(torch.int8)


def _yardstick(torch, fn, what):
    """Time one PyTorch call beside a kernel; None where the library
    refuses the shape (``torch._int_mm`` wants M > 16 and K, N multiples
    of 8)."""
    try:
        return device_ms(torch, fn)
    except RuntimeError as e:
        print(f"{what} refused this shape: {str(e).splitlines()[0]}")
        return None


def _time_qmac(torch, g, dev, m, k, n):
    """Q-MAC at one shape: (int32 row, fused row)."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    qx, qw = _i8(torch, g, dev, (m, k)), _i8(torch, g, dev, (k, n))
    sx = torch.rand((m, 1), generator=g, device=dev) * 0.01
    sw = torch.rand((1, n), generator=g, device=dev) * 0.01
    shape = f"M={m} K={k} N={n}"
    p = qmac_ops.split_plan(m, k, n)
    plan = f"{p.splits} slices of {p.slice} B, {p.blocks} blocks"
    b_ms, b_by = bound_ms(m * k + k * n + 4 * m * n, 2.0 * m * n * k)
    i32 = dict(
        shape=shape, plan=plan,
        ms=device_ms(torch, lambda: qmac_ops.qmac_i8(qx, qw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_plain(qx, qw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=_yardstick(torch, lambda: torch._int_mm(qx, qw),
                              "torch._int_mm"))
    b_ms, b_by = bound_ms(m * k + k * n + 4 * m + 4 * n + 4 * m * n,
                          2.0 * m * n * k, 2.0 * m * n)
    deq = dict(
        shape=shape, plan=plan,
        ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq(qx, sx, qw, sw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq_plain(
            qx, sx, qw, sw)),
        bound_ms=b_ms, bound_by=b_by,
        # the LM rows' yardstick: the int8 product, then the two scales
        library_ms=_yardstick(torch, lambda: (torch._int_mm(qx, qw).to(
            torch.float32) * sx) * sw, "torch._int_mm + 2 scale multiplies"))
    return i32, deq


def _time_qconv(torch, g, dev, bsz, h, c, nc, w=None):
    """Q-Conv at one stride-2 SAME 3x3 layer (an h x w frame, square
    unless ``w`` is given)."""
    import torch.nn.functional as F
    from repro_torch.kernels.qconv import ops as qconv_ops

    w = h if w is None else w
    cx = _i8(torch, g, dev, (bsz, h, w, c))
    cw = _i8(torch, g, dev, (3, 3, c, nc))
    csx = torch.rand((bsz, h, w, 1), generator=g, device=dev) * 0.01
    csw = torch.rand((nc,), generator=g, device=dev) * 0.01
    cb = torch.rand((nc,), generator=g, device=dev) * 0.1
    kw = dict(stride=2, padding="SAME", fuse_relu=True)
    p = qconv_ops.band_plan(bsz, h, w, c, 3, 3, nc, 2, "SAME")
    ho, wo, pt, pb, plf, prt = qconv_ops.out_geometry(h, w, 3, 3, 2, "SAME")
    mo = bsz * ho * wo
    b_ms, b_by = bound_ms(bsz * h * w * c + 4 * bsz * h * w + 9 * c * nc
                          + 8 * nc + 4 * mo * nc,
                          2.0 * mo * nc * 9 * c, mo * nc * (2 * 9 + 3))
    # the yardstick: one fp32 cuDNN convolution (TF32 off) of the
    # dequantized input with the dequantized filters, operands laid out
    # and padded (SAME at stride 2: (0, 1) at an even size, (1, 1) at an
    # odd one) beforehand
    xd = F.pad((cx.float() * csx).permute(0, 3, 1, 2), (plf, prt, pt, pb))
    wd = (cw.float() * csw).permute(3, 2, 0, 1).contiguous()
    return dict(
        shape=f"x[{bsz},{h},{w},{c}] w[3,3,{c},{nc}] stride 2 SAME",
        plan=(f"bands of {p.rows} rows, N tile {p.n_tile}, {p.threads} "
              f"threads, {p.smem} B shared, {p.blocks} blocks"),
        ms=device_ms(torch, lambda: qconv_ops.qconv2d_i8(
            cx, csx, cw, csw, cb, **kw)),
        plain_ms=device_ms(torch, lambda: qconv_ops.qconv2d_i8_plain(
            cx, csx, cw, csw, cb, **kw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=_yardstick(
            torch, lambda: F.conv2d(xd, wd, cb, stride=2), "F.conv2d"))


def cordic_exp_flops(n: int) -> int:
    """fp32 operations of one CORDIC e^x as the kernels run it: divide,
    floor, multiply, subtract; 5 per iteration (two scalings, two adds,
    one angle update); the final add, clamp, 2^m and scaling."""
    return 4 + 5 * n + 5


def vact_flops(kind: str, n: int) -> int:
    """fp32 operations of one V-ACT element: sigmoid adds |x|, negate,
    add, divide and select to e^x; tanh two multiplies and a subtract
    to sigmoid; relu one compare."""
    sig = cordic_exp_flops(n) + 5
    return {"relu": 1, "sigmoid": sig, "tanh": sig + 3}[kind]


def ew_plan_text(x) -> str:
    """How ``vact_ew`` launches on ``x``."""
    from repro_torch.kernels.vact import ops as vact_ops
    op = vact_ops.ew_operand(tuple(x.shape), x.stride())
    rows, cols, ld = op if op is not None else (1, x.numel(), x.numel())
    p = vact_ops.ew_plan(rows * cols)
    return (f"{'in place' if op is not None else 'contiguous copy first'}"
            f" as [{rows}, {cols}] at row stride {ld}, one element a "
            f"thread, {p.threads} threads x {p.blocks} blocks")


def softmax_plan_text(x) -> str:
    """How ``vact_softmax`` launches on ``x``."""
    from repro_torch.kernels.vact import ops as vact_ops
    op = vact_ops.softmax_operand(tuple(x.shape), x.stride())
    cols = x.shape[-1]
    rows, cols, ld = op if op is not None else (x.numel() // cols, cols,
                                                cols)
    p = vact_ops.softmax_plan(rows, cols)
    how = {"rows": f"{p.lanes} lanes a row, {32 // max(p.lanes, 1)} rows "
                   "a warp",
           "block": f"one block a row, {p.staged} of {cols} staged in "
                    f"{p.smem} B shared"}[p.regime]
    return (f"{'in place' if op is not None else 'contiguous copy first'}"
            f" at row stride {ld}; {p.regime} kernel, {how}, {p.threads} "
            f"threads x {p.blocks} blocks")


def q8_plan_text(n: int) -> str:
    from repro_torch.kernels.vact import ops as vact_ops
    p = vact_ops.q8_plan(n)
    return (f"256-code table a block, {p.threads} threads x {p.blocks} "
            f"blocks, {p.items} 16-byte chunks a thread")


def cell_plan_text(b, d_in, hid) -> str:
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    p = qlstm_ops.cell_plan(b, d_in, hid)
    return (f"{p.row_groups} x {p.unit_groups} blocks of {p.rows} rows x "
            f"{p.units} units, {p.threads} threads, {p.smem} B shared")


APPROX = "approximate: not CORDIC"


def time_ew(torch, x, n_iters, what):
    """``vact_ew`` tanh on ``x`` (contiguous or a view) beside its plain
    version, ``torch.tanh`` and its bound."""
    from repro_torch.kernels.vact import ops as vact_ops

    el = x.numel()
    b_ms, b_by = bound_ms(8 * el, fp32_ops=el * vact_flops("tanh", n_iters))
    return dict(shape=f"{what} n={n_iters} tanh", plan=ew_plan_text(x),
                ms=device_ms(torch, lambda: vact_ops.vact_ew(x, "tanh",
                                                             n_iters)),
                plain_ms=device_ms(torch, lambda: vact_ops.vact_ew_plain(
                    x, "tanh", n_iters)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(torch, lambda: torch.tanh(x)),
                library=f"torch.tanh, {APPROX}")


def time_softmax(torch, x, n_iters, what):
    """``vact_softmax`` on ``x`` beside its plain version,
    ``torch.softmax`` and its bound."""
    from repro_torch.kernels.vact import ops as vact_ops

    el = x.numel()
    # per element: subtract the max, e^x, add to the sum, divide
    b_ms, b_by = bound_ms(8 * el, fp32_ops=el * (
        cordic_exp_flops(n_iters) + 4))
    return dict(shape=f"{what} n={n_iters} softmax",
                plan=softmax_plan_text(x),
                ms=device_ms(torch, lambda: vact_ops.vact_softmax(x,
                                                                  n_iters)),
                plain_ms=device_ms(torch, lambda: vact_ops.vact_softmax_plain(
                    x, n_iters)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(torch, lambda: torch.softmax(x, -1)),
                library=f"torch.softmax, {APPROX}")


def time_q8(torch, qx, n_iters, what):
    """``vact_ew_q8`` tanh on ``qx`` beside its plain version and its
    bound: the bytes (n in, n out, the scale), since a call's output is
    a function of at most 256 codes and the least work is 256
    evaluations and a gather."""
    from repro_torch.kernels.vact import ops as vact_ops

    sx = torch.full((), 0.02, device=qx.device)
    b_ms, b_by = bound_ms(2 * qx.numel() + 4)
    return dict(shape=f"{what} n={n_iters} tanh, int8",
                plan=q8_plan_text(qx.numel()),
                ms=device_ms(torch, lambda: vact_ops.vact_q8(
                    qx, sx, "tanh", n_iters)),
                plain_ms=device_ms(torch, lambda: vact_ops.vact_q8_plain(
                    qx, sx, "tanh", n_iters)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _time_vact(torch, g, dev, m, n_col, n_iters):
    """V-ACT at one shape: (elementwise tanh, q8 tanh) rows."""
    x = torch.randn((m, n_col), generator=g, device=dev) * 2
    qx = _i8(torch, g, dev, (m, n_col))
    return (time_ew(torch, x, n_iters, f"[{m}, {n_col}]"),
            time_q8(torch, qx, n_iters, f"[{m}, {n_col}]"))


def time_vact_large(torch, g, dev, n_iters=6):
    """Softmax and int8 rows past the path's sizes, each larger than the
    50 MB L2 so the timed launches read device memory: softmax at
    [4096, 8192] (block kernel, rows staged) and [256, 65536] (rows past
    shared memory), int8 at 2^26 elements."""
    sm = [time_softmax(torch, torch.randn((r, c), generator=g, device=dev)
                       * 2, n_iters, f"[{r}, {c}]")
          for r, c in ((4096, 8192), (256, 65536))]
    q8 = time_q8(torch, _i8(torch, g, dev, (1 << 26,)), n_iters,
                 "[67108864]")
    return sm, q8


def time_gate_slice_and_floor(torch, g, dev, n_iters=6):
    """``vact_ew`` on the [128, 32] column slice of a [128, 128] gate
    tensor, as the LSTM's xla branch passes it, and on one element: the
    launch floor under ``device_ms``'s timing."""
    from repro_torch.kernels.vact import ops as vact_ops

    gates = torch.randn((128, 128), generator=g, device=dev) * 2
    row = time_ew(torch, gates[:, 32:64], n_iters,
                  "[128, 32] gate slice of [128, 128]")
    one = torch.randn((1,), generator=g, device=dev)
    floor = device_ms(torch, lambda: vact_ops.vact_ew(one, "tanh", n_iters))
    return row, floor


def _time_qlstm(torch, g, dev, b, d_in, hid, n_iters):
    """The fused Q-LSTM cell at one shape."""
    from repro_torch.kernels.qlstm import ops as qlstm_ops

    g4 = 4 * hid
    args = (_i8(torch, g, dev, (b, d_in)), torch.full((), 0.01, device=dev),
            _i8(torch, g, dev, (b, hid)), torch.full((), 0.01, device=dev),
            _i8(torch, g, dev, (d_in, g4)),
            torch.rand((1, g4), generator=g, device=dev) * 0.004,
            _i8(torch, g, dev, (hid, g4)),
            torch.rand((1, g4), generator=g, device=dev) * 0.004,
            torch.randn(g4, generator=g, device=dev) * 0.1,
            torch.randn((b, hid), generator=g, device=dev))
    nbytes = (b * d_in + b * hid + (d_in + hid) * g4 + 4 * (2 + 3 * g4)
              + 4 * b * hid + 8 * b * hid)
    # per hidden unit: 4 gates x (4 multiplies, 2 adds), 3 sigmoids and
    # 2 tanhs, the cell update (2 multiplies, 1 add) and h's multiply
    per_unit = (4 * 6 + 3 * vact_flops("sigmoid", n_iters)
                + 2 * vact_flops("tanh", n_iters) + 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * b * (d_in + hid) * g4,
                          b * hid * per_unit)
    return dict(
        shape=f"B={b} Din={d_in} H={hid} n={n_iters}",
        plan=cell_plan_text(b, d_in, hid),
        ms=device_ms(torch, lambda: qlstm_ops.qlstm_cell(*args,
                                                         n_iters=n_iters)),
        plain_ms=device_ms(torch, lambda: qlstm_ops.qlstm_cell_plain(
            *args, n_iters)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def time_kernels(torch, dev):
    """Phase 4: every kernel beside its plain version and a library call,
    at each shape the paths give it: the serving path at its largest
    bucket (32), the HRL path at its largest call (512 frames; the
    LSTM's 128 rows per step), the training paths' actors at 32 envs
    (cartpole's mlp, E2HRL on keydoor, the conv actor-critic on catch),
    and V-ACT's softmax and int8 kernels also past the path's sizes.  No single PyTorch call computes a CORDIC
    activation bit for bit: ``torch.tanh`` and ``torch.softmax`` are the
    approximate yardsticks of ``vact_ew`` and ``vact_softmax``; no single
    PyTorch call computes the CORDIC int8 map or the fused LSTM cell, so
    those have none.  The fused Q-MAC's yardstick is ``torch._int_mm``
    then the two scale multiplies, where it takes the shape.  Each
    kernel's first row is the one the JSON line reports."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {"qmac_i8": [], "qmac_i8_deq": [], "qconv_i8_taps": [],
            "vact_ew": [], "vact_ew_q8": [], "vact_softmax": [],
            "qlstm_cell": []}
    for m, k, n in ((32, 2048, 128), (32, 128, 4),      # DQN fc, Q head
                    (512, 512, 32), (512, 40, 4),       # HRL stem fc, head
                    (1, 2048, 128), (8, 2048, 128)):    # fc, buckets 1, 8
        i32, deq = _time_qmac(torch, g, dev, m, k, n)
        rows["qmac_i8"].append(i32)
        rows["qmac_i8_deq"].append(deq)
    for k, n in ((64, 64), (4, 64)):      # the fxp8 actor's fc2, fc1
        rows["qmac_i8"].append(_time_qmac(torch, g, dev, 32, k, n)[0])
    for bsz, h, c, nc in ((32, 32, 12, 16), (32, 16, 16, 32),  # DQN
                          (512, 32, 3, 16), (512, 16, 16, 32)):  # HRL
        rows["qconv_i8_taps"].append(_time_qconv(torch, g, dev, bsz, h, c,
                                                 nc))
    # the pixel runs' actor convs and products at the rollout's 32 envs
    for h, w, c, nc in PIXEL_CONVS:
        rows["qconv_i8_taps"].append(_time_qconv(torch, g, dev, 32, h, c,
                                                 nc, w))
    for k, n in PIXEL_KN:
        rows["qmac_i8"].append(_time_qmac(torch, g, dev, 32, k, n)[0])
    # the HRL path: sub-goal tanh [512, 8], LSTM gates [128, 32], the
    # action softmax of FC-HRL [512, 4] and of LSTM-HRL [128, 4], all at
    # FxP8's 6 iterations; then softmax and int8 past the path's sizes
    for m, n_col in ((512, 8), (128, 32)):
        ew, q8 = _time_vact(torch, g, dev, m, n_col, 6)
        rows["vact_ew"].append(ew)
        rows["vact_ew_q8"].append(q8)
    gate_slice, floor = time_gate_slice_and_floor(torch, g, dev)
    rows["vact_ew"].append(gate_slice)
    for m in (512, 128):
        rows["vact_softmax"].append(time_softmax(torch, torch.randn(
            (m, 4), generator=g, device=dev) * 2, 6, f"[{m}, 4]"))
    sm, q8 = time_vact_large(torch, g, dev)
    rows["vact_softmax"] += sm
    rows["vact_ew_q8"].append(q8)
    rows["qlstm_cell"].append(_time_qlstm(torch, g, dev, 128, 32, 32, 6))
    print(BOUND_TEXT)
    for name, shapes in rows.items():
        for r in shapes:
            print_row(name, r)
    print(f"launch floor under this timing: vact_ew on 1 element "
          f"{floor:.5f} ms")
    return rows


BOUND_TEXT = (
    "bound_ms = max(bytes / 3.35e12 B/s, int8 ops / 1.979e15 + fp32 ops / "
    "6.7e13) in ms; bytes = inputs read once + outputs written once; V-ACT "
    "fp32 ops per element: relu 1, sigmoid 14 + 5n, tanh 17 + 5n, softmax "
    "13 + 5n (n CORDIC iterations); vact_ew_q8: bytes only (n in, n out, "
    "the scale), since its output is a function of at most 256 codes a "
    "call and the least work is 256 evaluations and a gather, so a per-"
    "element operation count would let a table kernel read above its "
    "bound; Q-LSTM: int8 ops 2 B (Din + H) 4H, fp32 ops per hidden unit "
    "24 + 3 sigmoids + 2 tanhs + 4; library_ms marked approximate "
    "computes the same function in fp32 (torch.tanh, torch.softmax), "
    "not CORDIC bit for bit, and the port never calls it")


def print_row(name, r):
    lib = r["library_ms"]
    lib = "n/a" if lib is None else f"{lib:.5f}"
    if "library" in r:
        lib += f" ({r['library']})"
    print(f"{name:14s} {r['shape']}: kernel_ms {r['ms']:.5f}  plain_ms "
          f"{r['plain_ms']:.5f}  library_ms {lib}  bound_ms "
          f"{r['bound_ms']:.6f} ({r['bound_by']})"
          + (f"  [{r['plan']}]" if "plan" in r else ""))


SERVING_KERNELS = ("qmac_i8", "qmac_i8_deq", "qconv_i8_taps")
HRL_KERNELS = ("qmac_i8", "qconv_i8_taps", "vact_ew", "vact_softmax",
               "qlstm_cell")


def main_path(torch, dev, work):
    """Phase 5: serve a full-width conv DQN on keydoor at w8 and w4."""
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.serve_policy import serve_policy
    from repro_torch.rl.inference import build_env, make_value_agent
    from repro_torch.rl.rollout import init_envs
    from repro_torch.serve import load_policy

    env = build_env("keydoor", "conv", 4)
    agent = make_value_agent("dqn", env.spec,
                             gen=torch.Generator().manual_seed(0),
                             net="conv", device=dev)
    n_envs = 16
    est, obs = init_envs(env, 0, n_envs, dev)
    act_gen = torch.Generator().manual_seed(1)
    for _ in range(32):       # non-trivial Welford stats for the carry
        est, obs, *_ = env.step(est, env.action_space.sample(
            act_gen, n_envs, dev))
    ckpt = os.path.join(work, "ckpt")
    CheckpointManager(ckpt).save(
        1, (agent.params, None, None, None, est, obs),
        metadata={"algo": "dqn", "env": "keydoor", "net": "conv",
                  "frame_stack": 4, "n_envs": n_envs,
                  "schema": "trainstate/v1"})

    kernels.reset_launch_counts()
    served = {}
    for precision in ("w8", "w4"):
        st = serve_policy(ckpt, precision=precision, episodes=200,
                          n_slots=64, max_bucket=32, do_check_parity=True,
                          device=dev)
        if st.episodes < 200:
            raise AssertionError(f"{precision}: served only "
                                 f"{st.episodes} episodes")
        served[precision] = st
    launches = kernels.launch_counts()
    print(f"kernel launches on the serving path: {launches}")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the serving "
                                 "path")

    # the served forward on the card against the plain path on the CPU,
    # same weights, same observations
    from repro_torch.core.fxp import QTensor
    from repro_torch.tree import tree_map
    policy = load_policy(ckpt, device=dev)
    _, obs = init_envs(policy.env, 3, 32, dev)
    for precision in ("w8", "w4"):
        packed, pol = policy.pack(precision)
        q_dev = policy.agent.qvals(packed, obs, pol)
        cpu = tree_map(lambda t: t.to("cpu"), packed,
                       is_leaf=lambda x: isinstance(x, QTensor))
        q_cpu = policy.agent.qvals(cpu, obs.cpu(), pol)
        if q_dev.shape != (32, 4) or not torch.isfinite(q_dev).all():
            raise AssertionError(f"{precision}: bad Q-values {q_dev.shape}")
        err = (q_dev.cpu() - q_cpu).abs().max().item()
        print(f"{precision}: served Q-values on the card vs the plain "
              f"path on the CPU: max abs err {err}")
        if not torch.equal(q_dev.cpu().view(torch.int32),
                           q_cpu.view(torch.int32)):
            raise AssertionError(f"{precision}: card and CPU Q-values "
                                 "differ")
    return launches, served


# the port's kernels in a trace, by name, and the wrappers that launch them
PORT_KERNELS = (("qmac_kernel", ("qmac_i8", "qmac_i8_deq",
                                 "qmac_i8_deq_bmm")),
                ("qconv_kernel", ("qconv_i8_taps",)),
                ("vact_ew_kernel", ("vact_ew",)),
                ("vact_ew_q8_kernel", ("vact_ew_q8",)),
                (r"vact_softmax_\w*kernel", ("vact_softmax",)),
                ("qlstm_cell_kernel", ("qlstm_cell",)))
TRACE_TRIES = 3


def _port_kernel(name: str):
    """The index in PORT_KERNELS of the kernel a trace row names, or
    None for PyTorch's own kernels."""
    import re
    for i, (pattern, _) in enumerate(PORT_KERNELS):
        if re.search(rf"\b{pattern}\b", name):
            return i
    return None


def _profiled(torch, fn, n):
    """``n`` calls of ``fn`` (each ending in a synchronize) under
    ``torch.profiler``, after three calls the profiler traces and drops:
    (host wall ms per call, [(device ms per call, launches per call,
    kernel name)] sorted by time, device launches per call, and why that
    count is None; then each row holds the launches read in all ``n``
    calls).

    CUPTI can drop kernel records from a trace.  The port's launches are
    the wrappers' counters over the ``n`` traced calls; a trace is taken
    only when every kernel row counts a whole multiple of ``n`` launches
    and the port's rows count what the counters do.  Otherwise it traces
    again, up to ``TRACE_TRIES`` times, and then gives no launch count,
    only the rows as read and the port's launches by counter and by
    trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import kernels

    for _ in range(TRACE_TRIES):
        # the device's activity alone: the rows read are its kernels and
        # copies, and the host's operator events, many times as many, are
        # neither recorded nor read back
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=2, active=n)) as prof:
            for i in range(3 + n):
                if i == 3:
                    kernels.reset_launch_counts()
                    t0 = time.perf_counter()
                fn()
                if i == 2 + n:
                    wall_ms = (time.perf_counter() - t0) * 1e3 / n
                    counts = kernels.launch_counts()
                prof.step()
        rows, traced = [], [0] * len(PORT_KERNELS)
        for ev in prof.key_averages():
            # the kernels themselves (operators' rows would count them
            # twice; the schedule's step annotation spans the whole call)
            if (ev.device_type != DeviceType.CUDA
                    or ev.key.startswith("ProfilerStep")):
                continue
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = ev.cuda_time_total
            rows.append((dev_us / n / 1e3, ev.count, ev.key))
            k = _port_kernel(ev.key)
            if k is not None:
                traced[k] += ev.count
        rows.sort(reverse=True)
        want = [sum(counts[w] for w in wrappers)
                for _, wrappers in PORT_KERNELS]
        if all(c % n == 0 for _, c, _ in rows) and traced == want:
            return (wall_ms, [(ms, c // n, name) for ms, c, name in rows],
                    sum(c for _, c, _ in rows) // n, None)
    return (wall_ms, rows, None,
            f"trace not whole after {TRACE_TRIES} tries; the port's "
            f"kernels: {sum(want)} launches by the wrappers' counters, "
            f"{sum(traced)} in the trace; rows below: launches read in "
            f"{n} calls")


def _print_profile(what, wall_ms, rows, launches, why, top, per="forward"):
    busy_ms = sum(r[0] for r in rows)
    count = (f"{launches} device launches per {per}" if why is None else
             f"launches per {per}: not measured ({why})")
    print(f"{what}: wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {count}")
    for ms, count, name in rows[:top if why is None else len(rows)]:
        print(f"  {ms:.5f} ms  x{count:g}  {name[:90]}")
    if not rows:
        print("  the profiler recorded no device time (not measured)")


def profile_forward(torch, dev, ckpt, n=50, what="served forward"):
    """Phase 6: where a served forward's time goes.  ``n`` w8 forwards of
    a full bucket (32) under ``torch.profiler``: device time per forward
    by kernel name, beside the host wall time per forward (each ``act``
    ends in a synchronize), so the device's idle share shows.  Phase 12
    profiles the value checkpoints' forwards the same way.  Returns the
    port's launches of one such forward, by the wrappers' counters."""
    from repro_torch import kernels
    from repro_torch.rl.rollout import init_envs
    from repro_torch.serve import PolicyServer, load_policy

    server = PolicyServer(load_policy(ckpt, device=dev), precision="w8",
                          max_bucket=32)
    _, obs = init_envs(server.policy.env, 4, 32, dev)
    server.warmup(32)
    kernels.reset_launch_counts()
    server.act(obs)
    per = {k: v for k, v in kernels.launch_counts().items() if v}
    wall, rows, launches, why = _profiled(torch, lambda: server.act(obs), n)
    _print_profile(f"{what}, bucket 32, w8", wall, rows, launches, why,
                   top=10)
    return per


def _keydoor_frames(torch, dev):
    """keydoor's own frames: 512 envs after a reset, and 128 envs'
    windows of their last 4 frames (random actions, seeded)."""
    from repro_torch.rl.envs import make
    from repro_torch.rl.rollout import init_envs

    env = make("keydoor")
    gen = torch.Generator().manual_seed(2)
    est, obs = init_envs(env, 0, 512, dev)
    west, wobs = init_envs(env, 1, 128, dev)
    frames = [wobs]
    for _ in range(3):
        west, wobs, *_ = env.step(west, env.action_space.sample(gen, 128,
                                                                dev))
        frames.append(wobs)
    return env, est, obs, torch.stack(frames, dim=1)


def hrl_path(torch, dev):
    """Phase 7: the E2HRL agent at its published width on keydoor."""
    from repro_torch import kernels
    from repro_torch.configs.e2hrl import HRLConfig
    from repro_torch.core.fxp import QTensor
    from repro_torch.core.policy import FXP8
    from repro_torch.core.quantizer import quantize_params
    from repro_torch.models import hrl
    from repro_torch.tree import tree_map

    env, est, obs, windows = _keydoor_frames(torch, dev)
    cfg_fc = HRLConfig(obs_shape=tuple(env.obs_shape),
                       n_actions=env.spec.n_actions)
    cfg_lstm = HRLConfig(obs_shape=tuple(env.obs_shape),
                         n_actions=env.spec.n_actions, subgoal_kind="lstm")
    pallas = FXP8.replace(backend="pallas", act_backend="cordic")
    xla = FXP8.replace(act_backend="cordic")
    p_fc = hrl.init(torch.Generator().manual_seed(0), cfg_fc, device="cpu")
    p_lstm = hrl.init(torch.Generator().manual_seed(0), cfg_lstm,
                      device="cpu")
    p_packed = quantize_params(p_fc, pallas)

    def to_dev(tree):
        return tree_map(lambda x: x.to(dev), tree,
                        is_leaf=lambda x: isinstance(x, QTensor))

    variants = [  # (name, cfg, cpu params, policy, observations)
        ("FC-HRL pallas", cfg_fc, p_fc, pallas, obs),
        ("LSTM-HRL pallas", cfg_lstm, p_lstm, pallas, windows),
        ("LSTM-HRL xla", cfg_lstm, p_lstm, xla, windows),
        ("FC-HRL packed w8", cfg_fc, p_packed, pallas, obs),
    ]
    dev_params = {name: to_dev(p) for name, _, p, _, _ in variants}

    kernels.reset_launch_counts()
    outs = {}
    for name, cfg, _, pol, o in variants:
        logits, value, _ = hrl.apply(dev_params[name], o, cfg, pol)
        outs[name] = (logits, value, hrl.action_probs(logits, pol))
    # act greedily on keydoor with FC-HRL
    returns = torch.zeros(obs.shape[0], device=dev)
    episodes = 0
    s, o = est, obs
    for _ in range(64):
        logits, _, _ = hrl.apply(dev_params["FC-HRL pallas"], o, cfg_fc,
                                 pallas)
        s, o, reward, done, trunc, _ = env.step(
            s, torch.argmax(logits, dim=-1).to(torch.int32))
        returns += reward
        episodes += int((done | trunc).sum().item())
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"kernel launches on the HRL path: {launches}")
    for k in HRL_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched on the HRL path")
    print(f"FC-HRL greedy on keydoor: 64 steps x 512 envs, {episodes} "
          f"episodes ended, mean return {returns.mean().item():.4f}")

    # the card against the plain path on the CPU, same weights and frames
    for name, cfg, p_cpu, pol, o in variants:
        logits, value, probs = outs[name]
        want_l, want_v, _ = hrl.apply(p_cpu, o.cpu(), cfg, pol)
        want_p = hrl.action_probs(want_l, pol)
        b = o.shape[0]
        if logits.shape != (b, cfg.n_actions) or value.shape != (b,) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: bad outputs {logits.shape} "
                                 f"{value.shape}")
        err_l = (logits.cpu() - want_l).abs().max().item()
        err_v = (value.cpu() - want_v).abs().max().item()
        err_p = (probs.cpu() - want_p).abs().max().item()
        print(f"{name}: card vs CPU plain path, logits max abs err {err_l}, "
              f"values {err_v}, probabilities {err_p}")
        if not (bits_equal(torch, logits.cpu(), want_l)
                and bits_equal(torch, value.cpu(), want_v)):
            raise AssertionError(f"{name}: card and CPU logits/values "
                                 "differ")
        if not torch.allclose(probs.cpu(), want_p, rtol=1e-6, atol=FLT_MIN):
            raise AssertionError(f"{name}: probabilities off by {err_p}")

    # frames/s per variant (the paper's Table V quantity): 512 frames a
    # call, 512 single frames for FC-HRL, 128 windows of 4 for LSTM-HRL
    fps = {}
    for name, cfg, _, pol, o in variants:
        def fwd():
            logits, _, _ = hrl.apply(dev_params[name], o, cfg, pol)
            return torch.argmax(logits, dim=-1)
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        n_calls = 20
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fwd()
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / n_calls
        fps[name] = o.shape[0] * (o.shape[1] if o.ndim == 5 else 1) / sec
        print(f"{name}: {fps[name]:.1f} frames/s ({sec * 1e3:.4f} ms per "
              f"call of {o.shape[0]} {'windows' if o.ndim == 5 else 'frames'})")
    return launches, fps, (dev_params["LSTM-HRL pallas"], cfg_lstm,
                           {"pallas": pallas, "xla": xla}, windows)


def profile_hrl(torch, lstm, n=20):
    """Phase 8: where an LSTM-HRL forward's time goes (128 windows of 4
    frames, CORDIC at FxP8) at pallas (fused Q-LSTM) and at xla (Q-MAC
    gates + V-ACT on the gate slices), as ``profile_forward`` reads it,
    with the port's kernel launches of one forward.  Returns the device
    launches per forward by branch: a whole count, or "not measured" and
    why (``_profiled``)."""
    from repro_torch import kernels
    from repro_torch.models import hrl

    params, cfg, policies, windows = lstm
    per_forward = {}
    for branch, pol in policies.items():
        def fwd():
            hrl.apply(params, windows, cfg, pol)
            torch.cuda.synchronize()

        kernels.reset_launch_counts()
        fwd()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        wall, rows, launches, why = _profiled(torch, fwd, n)
        _print_profile(f"LSTM-HRL forward, 128 windows x 4 frames, {branch}",
                       wall, rows, launches, why, top=12)
        print(f"  the port's kernels in one {branch} forward: {counts}")
        per_forward[branch] = (launches if why is None
                               else f"not measured ({why})")
    return per_forward


# the JAX reference's default run (``repro.rl.trainer.onpolicy.
# OnPolicyTrainer("cartpole", iters=40, seed=s)`` then its
# ``eval_policy``: 16 envs, 625 greedy steps) at seeds 0-4, by
# tools/ref_greedy_returns.py on a CPU with jax 0.9.0; the training phase
# fails if the port's median over its seeds falls under half the median
REF_GREEDY_RETURNS = (500.0, 156.43637084960938, 170.3541717529297, 500.0,
                      158.69387817382812)
REF_GREEDY_MEDIAN = statistics.median(REF_GREEDY_RETURNS)
TRAIN_SEEDS = (0, 1, 2)


def _counting_trainer(torch, kernels):
    """``OnPolicyTrainer`` (what ``rl_train`` runs) reading the port's
    launch counters around each iteration and timing its phases on the
    host clock: the weight sync (``pack``), the rollout and the learner,
    each ended by a wait for the card so the time is the phase's own.
    ``step`` runs the iteration's own two phases, as its body does, and
    keeps the params at the end of each stage."""
    from repro_torch.obs import SpanClock
    from repro_torch.rl.rollout import episode_returns
    from repro_torch.rl.trainer import OnPolicyTrainer
    from repro_torch.rl.trainer.state import onpolicy_state

    class Counted(OnPolicyTrainer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.per_iter, self.clock = [], SpanClock()
            self.stage_params = []

        def pack(self, state):
            with self.clock("sync"):
                packed = super().pack(state)
                torch.cuda.synchronize()
            return packed

        def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
            before = kernels.launch_counts()
            draws = self.draws(gen)
            with self.clock("rollout"):
                res = iteration.rollout_phase(packed, draws, state.est,
                                              state.obs)
                torch.cuda.synchronize()
            with self.clock("learn"):
                params, opt = iteration.learn_phase(
                    state.params, state.opt, res, draws, stage_ctx, alive)
                torch.cuda.synchronize()
            ret, n_ep = episode_returns(res.traj)
            after = kernels.launch_counts()
            self.per_iter.append({k: after[k] - before[k] for k in after})
            if (g + 1) % self.iters == 0:
                self.stage_params.append(params)
            return (onpolicy_state(params, opt, res.final_env,
                                   res.final_obs), ret, n_ep)

    return Counted


def train_ppo_seed(torch, dev, seed):
    """Phase 9 worker: one seed of the training main path,
    ``rl_train``'s default run (ppo on cartpole, the mlp agent at hidden
    64, fxp8 actors, an 8-bit sync, 40 iterations of 32 envs x 128
    steps) on the card: the Q-MAC launches of every iteration, which
    must be exactly 4 x (128 + 1) and no other kernel's, the wall split
    between sync, rollout and learner, and the greedy return."""
    from repro_torch import kernels

    tr = _counting_trainer(torch, kernels)(seed=seed, device=dev,
                                           verbose=False)
    t0 = time.perf_counter()
    state, history = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = 4 * (tr.rollout_len + 1)
    qmac = [c["qmac_i8"] for c in tr.per_iter]
    if len(qmac) != tr.iters or any(q != want for q in qmac):
        raise AssertionError(f"seed {seed}: qmac_i8 launches per "
                             f"iteration {sorted(set(qmac))}, not "
                             f"{want} in each of {tr.iters}")
    others = {k: sum(c[k] for c in tr.per_iter) for k in kernels.WRAPPERS
              if k != "qmac_i8" and any(c[k] for c in tr.per_iter)}
    if others:
        raise AssertionError(f"seed {seed}: kernels off the training "
                             f"path launched: {others}")
    t1 = time.perf_counter()
    ret, n_ep = tr.eval_policy(state.params)
    eval_s = time.perf_counter() - t1
    if not all(torch.isfinite(x).all() for x in _leaves(state.params)):
        raise AssertionError(f"seed {seed}: non-finite params")
    return dict(seed=seed, ret=ret, n_ep=n_ep, eval_s=eval_s, wall=wall,
                steps=tr.iters * tr.n_envs * tr.rollout_len,
                iters=tr.iters, spans=tr.clock.drain(), per_iter=want,
                totals={k: sum(c[k] for c in tr.per_iter)
                        for k in kernels.WRAPPERS},
                last_train_return=history[-1])


def training_path(card, results):
    """Phase 9: the training main path at three seeds, from the workers'
    results (``train_ppo_seed``): greedy return, env steps/s, the wall
    split and the Q-MAC launches of every iteration; the median greedy
    return against half the reference's."""
    totals, returns = None, []
    for seed in TRAIN_SEEDS:
        r = results[("ptrain", "default", str(seed))]
        totals = ({k: totals[k] + v for k, v in r["totals"].items()}
                  if totals else dict(r["totals"]))
        returns.append(r["ret"])
        split = ", ".join(f"{k} {v:.3f} s ({v / r['wall']:.3f})"
                          for k, v in r["spans"].items())
        print(f"training seed {seed} on {card}: greedy return {r['ret']} "
              f"over {r['n_ep']} episodes (eval {r['eval_s']:.2f} s); last "
              f"train return {r['last_train_return']:.2f}; {r['steps']} env "
              f"steps in {r['wall']:.3f} s = {r['steps'] / r['wall']:.1f} "
              f"env steps/s; wall split: {split}; qmac_i8 {r['per_iter']} "
              f"launches in each of {r['iters']} iterations")
    median = statistics.median(returns)
    bar = REF_GREEDY_MEDIAN / 2
    print(f"training: median greedy return {median} over seeds "
          f"{TRAIN_SEEDS} (bar {bar}: half the reference's median "
          f"{REF_GREEDY_MEDIAN} at seeds 0-4)")
    if median < bar:
        raise AssertionError(f"median greedy return {median} < {bar}")
    return totals


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _phases(torch, dev, device, g=0, **kw):
    """A trainer's first iteration on ``device`` (default: the default
    run's; ``kw`` the run's flags): the trainer, its state, the
    iteration and its inputs, with the draws of global step ``g`` made
    on the CPU (so every device gets the same ones)."""
    from repro_torch.rl.train_steps import IterationDraws, iteration_generator
    from repro_torch.rl.trainer import OnPolicyTrainer

    tr = OnPolicyTrainer(seed=0, device=device, verbose=False, **kw)
    cpu = OnPolicyTrainer(seed=0, device="cpu", verbose=False, **kw)
    draws = cpu.draws(iteration_generator(0, g, torch.device("cpu")))
    draws = IterationDraws(*(t.to(device) for t in draws))
    state = tr.init_state()
    return tr, state, tr.build_iteration(), tr.pack(state), draws


def _recorded_codes(torch, fn, experts=None, flat=False):
    """``fn()``'s output and the int8 codes of every activation the int8
    program quantized in it, by row: each product's and conv's
    row-quantized input (an MoE layer's expert buffers [E, C, K] among
    them), each KV payload the attention quantizes, and each
    activation's requantized output (on the tensor-wide grid
    ``activation`` puts it on), [B, n] (with ``flat``, one row of them
    all, for an output with no batch axis).  With a list ``experts``,
    each MoE layer's chosen experts ([T * k], token by token) are
    appended to it."""
    from repro_torch.core import fxp, qmatmul, vact
    from repro_torch.nn import attention, conv, moe

    rec = []
    rowwise, fake_quant = qmatmul.quantize_rowwise, vact.fake_quant
    quant_kv = attention._quant_kv
    dispatch = moe._dispatch_indices

    def record_experts(idx, n_experts, capacity):
        if experts is not None:
            experts.append(idx.to(torch.int32))
        return dispatch(idx, n_experts, capacity)

    def record_rowwise(x, bits, *split):
        q, scale = rowwise(x, bits, *split)
        rec.append(q)
        return q, scale

    def record_kv(x, bits):
        q, scale = quant_kv(x, bits)
        rec.append(q)
        return q, scale

    def record_requant(x, bits, channel_axis=None):
        rec.append(fxp.quantize(x, bits, channel_axis=channel_axis)[0])
        return fake_quant(x, bits, channel_axis)

    qmatmul.quantize_rowwise = conv.quantize_rowwise = record_rowwise
    vact.fake_quant = record_requant
    attention._quant_kv = record_kv
    moe._dispatch_indices = record_experts
    try:
        out = fn()
    finally:
        qmatmul.quantize_rowwise = conv.quantize_rowwise = rowwise
        vact.fake_quant = fake_quant
        attention._quant_kv = quant_kv
        moe._dispatch_indices = dispatch
    b = 1 if flat else (out if isinstance(out, torch.Tensor)
                        else out[0]).shape[0]
    return out, torch.cat([r.reshape(b, -1).to(torch.int32) for r in rec],
                          -1)


def _rollout_codes(torch, tr, packed, traj):
    """The actor's int8 codes at every step of ``traj`` on its own
    device, [T, B, n], after checking that re-running the forward on the
    step's observations gives the rollout's log-probs and values bit for
    bit (so the codes are the rollout's own)."""
    from repro_torch.rl.actor_learner import unpack_weights

    params = unpack_weights(packed)
    codes = []
    with torch.no_grad():
        for t in range(traj.obs.shape[0]):
            (logits, value), c = _recorded_codes(
                torch, lambda: tr.apply_fn(params, traj.obs[t], tr.a_policy))
            logp = tr.dist.log_prob(logits.to(torch.float32),
                                    traj.actions[t])
            if not (torch.equal(logp, traj.log_probs[t])
                    and torch.equal(value, traj.values[t])):
                raise AssertionError(f"{traj.obs.device}: the actor's "
                                     f"forward at step {t} is not the "
                                     "rollout's")
            codes.append(c)
    return torch.stack(codes)


def card_vs_cpu_iteration(torch, dev):
    """Phase 9: one default iteration on the card against the plain path
    on the CPU, the same params, env states and draws.  Every action
    equal; observations within rtol 1e-5; log-probs and values within
    rtol 1e-5 + atol 1e-6 at every (step, env) whose actor forward has
    the same int8 codes on both devices (each product's row-quantized
    input and each requantized tanh output); a row whose codes differ (a libm ulp
    between the devices' tanh, cos or sin that lands on a rounding tie)
    is exempt and counted; the updated params within atol 1e-5 + rtol
    1e-4 (the learner's fp32 sums run in each device's order)."""
    alive = torch.ones(1, dtype=torch.bool)
    runs = {}
    for where in (dev, torch.device("cpu")):
        tr, state, it, packed, draws = _phases(torch, dev, where)
        res = it.rollout_phase(packed, draws, state.est, state.obs)
        codes = _rollout_codes(torch, tr, packed, res.traj)
        out = it(state.params, state.opt, state.est, state.obs, packed,
                 draws, None, alive)
        runs[where.type] = (res, codes, out)
    (rd, cd, od), (rc, cc, oc) = runs["cuda"], runs["cpu"]
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    same = (cpu(rd.traj.actions) == rc.traj.actions).float().mean().item()
    differ = cpu(cd) != cc
    flipped = differ.any(-1)                     # [T, B]
    errs, off = {}, {}
    for f in ("log_probs", "values", "obs"):
        a, b = cpu(getattr(rd.traj, f)), getattr(rc.traj, f)
        errs[f] = (a - b).abs().max().item()
        bad = ~torch.isclose(a, b, rtol=1e-5, atol=1e-6)
        if f != "obs":
            errs[f + " where codes agree"] = (
                ((a - b).abs() * ~flipped).max().item())
            bad = bad & ~flipped
        off[f] = int(bad.sum())
    worst_p, ok = 0.0, True
    for a, b in zip(_leaves(od[0]), _leaves(oc[0]), strict=True):
        a = cpu(a)
        worst_p = max(worst_p, (a - b).abs().max().item())
        ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
    errs["params"] = worst_p
    errs["adam mu"] = max((cpu(a) - b).abs().max().item() for a, b in zip(
        _leaves(od[1]["mu"]), _leaves(oc[1]["mu"]), strict=True))
    print(f"training iteration, card vs CPU (same params, states, draws): "
          f"actions equal {same:.6f}; int8 codes that differ "
          f"{int(differ.sum())} of {differ.numel()}, in "
          f"{int(flipped.sum())} of "
          f"{flipped.numel()} actor rows; largest abs errors {errs}; "
          f"entries past rtol 1e-5 outside those rows {off}")
    if same != 1.0:
        raise AssertionError("card and CPU rollouts chose different actions")
    for f, n in off.items():
        if n:
            raise AssertionError(
                f"card and CPU {f}: {n} entries past rtol 1e-5 where the "
                "actor's int8 codes agree")
    if not ok:
        raise AssertionError("card and CPU params differ past atol 1e-5 + "
                             "rtol 1e-4 after one iteration")


# the rollout length of a profiled rollout phase: an eighth of the runs'
# 128 steps, so its trace stays small enough to read (a step's launches
# and device time are the same at any length); the learner is traced on
# a whole 128-step rollout, the batch the runs train on
PROFILE_STEPS = 16


def profile_training(torch, dev, n=2, run=None):
    """Phases 9 and 10: where a training iteration's time goes, its
    rollout (``PROFILE_STEPS`` steps of the fxp8 actor and the env) and
    its learner (GAE, 4 epochs x 4 minibatches of fp32 forward, backward
    and AdamW, on a whole rollout of the run's length collected
    untraced) each traced as ``profile_forward`` traces a forward, from
    the same inputs each call; the port's launches by the wrappers'
    counters.  The iteration's wall and idle share add the rollout
    scaled to the run's length to the learner.  ``run`` names a phase-10
    run (default: phase 9's default run); a two-stage run is traced in
    its first stage."""
    from repro_torch import kernels

    flags = PIXEL_RUNS[run]["kw"] if run else {}
    what = PIXEL_RUNS[run]["flags"] if run else "default run"
    short = _phases(torch, dev, dev, rollout_len=PROFILE_STEPS, **flags)
    tr, state, it, packed, draws = _phases(torch, dev, dev, **flags)
    alive = torch.ones(1, dtype=torch.bool)
    ctx = tr.stage_setup(state, tr.stage_list[0])
    res = it.rollout_phase(packed, draws, state.est, state.obs)

    def rollout():
        _, s_state, s_it, s_packed, s_draws = short
        s_it.rollout_phase(s_packed, s_draws, s_state.est, s_state.obs)
        torch.cuda.synchronize()

    def learn():
        it.learn_phase(state.params, state.opt, res, draws, ctx, alive)
        torch.cuda.synchronize()

    out = {}
    for name, fn, steps in (("rollout", rollout, PROFILE_STEPS),
                            ("learner", learn, tr.rollout_len)):
        kernels.reset_launch_counts()
        fn()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        wall, rows, launches, why = _profiled(torch, fn, n)
        _print_profile(f"training iteration ({what}), {name} phase "
                       f"({tr.n_envs} envs x {steps} steps)",
                       wall, rows, launches, why,
                       top=8, per="phase")
        print(f"  the port's kernels in one {name} phase: {counts}")
        out[name] = (wall, sum(r[0] for r in rows), launches, counts)
    scale = {"rollout": tr.rollout_len / PROFILE_STEPS, "learner": 1}
    wall = sum(v[0] * scale[k] for k, v in out.items())
    busy = sum(v[1] * scale[k] for k, v in out.items())
    print(f"training iteration ({what}), {tr.rollout_len} steps (the "
          f"rollout's times x {scale['rollout']:g}): wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
          "device launches " + ", ".join(f"{k} {v[2]}"
                                         for k, v in out.items()))
    per_forward = PIXEL_RUNS[run]["per_forward"] if run else {"qmac_i8": 4}
    want = {k: v * (PROFILE_STEPS + 1) for k, v in per_forward.items()}
    if out["rollout"][3] != want:
        raise AssertionError(f"rollout phase launched {out['rollout'][3]}, "
                             f"not {want}")
    if out["learner"][3]:
        raise AssertionError(f"learner launched {out['learner'][3]}")
    return out


# ---------------------------------------------------------------------------
# phase 10: training from pixels
# ---------------------------------------------------------------------------

# the two pixel runs at their defaults (32 envs x 128 steps, fxp8
# actors, an 8-bit sync, lr 3e-3, 40 iterations a stage): the flags,
# the JAX reference's greedy returns at seeds 0-2 after training and of
# its untrained initial params (``tools/ref_greedy_returns.py --seeds 0
# 1 2`` with the flags, and with ``--iters 0``, on a CPU with jax
# 0.9.0), and each actor forward's launches of the port's kernels
PIXEL_RUNS = {
    "hrl_training": dict(
        flags="--env keydoor --agent hrl --two-stage",
        kw=dict(env_name="keydoor", agent="hrl", two_stage=True),
        ref=(0.14136387407779694, 0.45800018310546875,
             -0.00611087353900075),
        untrained=(-0.6399996876716614, -0.5774997472763062,
                   -0.4864703416824341),
        per_forward={"qconv_i8_taps": 3, "qmac_i8": 5}),
    "pixel_training": dict(
        flags="--env catch --net conv --frame-stack 4",
        kw=dict(env_name="catch", net="conv", frame_stack_k=4),
        ref=(-0.25, 0.125, 0.625), untrained=(0.625, -0.5, -0.5),
        per_forward={"qconv_i8_taps": 2, "qmac_i8": 3}),
}
WORKER_TIMEOUT_S = 600


def pixel_bar(run):
    """(bar, reference median, untrained median): half the way from the
    untrained policy's median greedy return to the trained reference's
    (the reference beats its untrained policy in both runs)."""
    cfg = PIXEL_RUNS[run]
    ref = statistics.median(cfg["ref"])
    u = statistics.median(cfg["untrained"])
    return u + 0.5 * (ref - u), ref, u


def train_seed(torch, dev, run, seed):
    """Phase 10 worker: one seed of one pixel run through the trainer
    ``rl_train`` runs, on the card: the port's launch counters read in
    every iteration (exactly ``per_forward`` x 129 each, nothing else),
    the wall split, the greedy return of the untrained params, after
    each stage and at the end."""
    from repro_torch import kernels

    cfg = PIXEL_RUNS[run]
    tr = _counting_trainer(torch, kernels)(seed=seed, device=dev,
                                           verbose=False, **cfg["kw"])
    untrained, _ = tr.eval_policy(tr._init_params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = {k: v * (tr.rollout_len + 1)
            for k, v in cfg["per_forward"].items()}
    n_iters = tr.iters * len(tr.stage_list)
    got = [{k: v for k, v in c.items() if v} for c in tr.per_iter]
    if len(got) != n_iters or any(c != want for c in got):
        odd = sorted({json.dumps(c, sort_keys=True) for c in got})
        raise AssertionError(f"{run} seed {seed}: launches per iteration "
                             f"{odd} over {len(got)} iterations, not "
                             f"{want} in each of {n_iters}")
    if not all(torch.isfinite(x).all() for x in _leaves(state.params)):
        raise AssertionError(f"{run} seed {seed}: non-finite params")
    t1 = time.perf_counter()
    ret, n_ep = tr.eval_policy(state.params)
    stage_returns = [tr.eval_policy(p)[0] for p in tr.stage_params]
    return dict(seed=seed, ret=ret, n_ep=n_ep, untrained=untrained,
                stage_returns=stage_returns, eval_s=time.perf_counter() - t1,
                wall=wall, steps=n_iters * tr.n_envs * tr.rollout_len,
                iters=n_iters, spans=tr.clock.drain(), per_iter=want,
                totals={k: sum(c[k] for c in tr.per_iter)
                        for k in kernels.WRAPPERS},
                last_train_return=[history[(i + 1) * tr.iters - 1]
                                   for i in range(len(tr.stage_list))])


def _tree_to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _tree_copy(tree, device):
    """``tree`` on ``device``, every leaf a copy (the replay buffer is
    written in place)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device, copy=True), tree)


def _learner_updates_card_vs_cpu(torch, dev, cpu_run, rc, cpu_out):
    """The CPU learner's minibatch updates one at a time (the GAE batch,
    then per update the gradient with the stage mask, and AdamW with its
    clipping, as ``learn_phase`` runs them), each also run on the card
    from the CPU's state before it.  Per update: the card's gradient
    within rtol 1e-5 of each leaf's largest entry of the CPU's (the
    learners' fp32 sums, cuDNN's among them, run in another order),
    unless a ReLU of the forward passed on one device and not on the
    other (a pre-activation within those sums' error of zero: that
    sample's whole contribution through the unit switches), and such
    updates are exempt and counted; and AdamW on the card, given the
    CPU's gradient, within atol 1e-5 + rtol 1e-4 of the CPU's params and
    moments.  Adam divides each entry's
    step by its own gradient's scale, so where that scale is near
    ``eps`` a gradient's last bits move the step by a share of ``lr``:
    the params after the card's own gradient are reported, not held.
    The CPU's updates must end bitwise where its ``learn_phase`` did, so
    they are the learner's own.  Returns (largest abs errors, whether
    every update held)."""
    from repro_torch.core import vact
    from repro_torch.optim import adamw_update
    from repro_torch.rl.actor_learner import fleet_mask
    from repro_torch.rl.ppo import (apply_stage_mask, batch_from_traj,
                                    value_and_grad)

    where, tr, state, _, draws, ctx, _, _ = cpu_run

    def learner(p, o):
        return tr.apply_fn(p, o, None)

    pcfg = tr.pcfg
    params, opt = state.params, state.opt
    mask = fleet_mask(torch.ones(1, dtype=torch.bool),
                      rc.traj.rewards.shape[1])
    with torch.no_grad():
        batch = batch_from_traj(rc.traj, rc.last_value, pcfg,
                                actor_mask=mask,
                                value_fn=lambda o: learner(params, o)[1])

    def grad(p, idx, dv):
        """The masked gradient, and which ReLUs of the forward passed
        (each one's ``x > 0``, flattened)."""
        mb = {k: v[idx.to(dv)] for k, v in _tree_to(batch, dv).items()}
        gates = []

        def relu(x):
            gates.append((x > 0).reshape(-1).cpu())
            return torch.relu(x)

        vact._NATIVE["relu"] = relu
        try:
            (_, _), g = value_and_grad(tr.loss_fn, p, learner, mb, pcfg,
                                       tr.dist)
        finally:
            vact._NATIVE["relu"] = torch.relu
        g = g if ctx is None else apply_stage_mask(g, ctx)
        return g, torch.cat(gates)

    def adam(g, p, s):
        with torch.no_grad():
            p, s, _ = adamw_update(g, s, p, tr.sched, tr.ocfg)
        return p, s

    n = batch["obs"].shape[0]
    size = n // pcfg.minibatches
    worst = dict.fromkeys(("grads", "params", "mu", "nu",
                           "params from the card's gradient"), 0.0)
    ok, gated = True, []
    for e in range(pcfg.epochs):
        for i in range(pcfg.minibatches):
            idx = draws.perms[e, i * size:(i + 1) * size]
            p_dev, s_dev = _tree_to(params, dev), _tree_to(opt, dev)
            g_card, gates_card = grad(p_dev, idx, dev)
            g_cpu, gates_cpu = grad(params, idx, where)
            flips = int((gates_card != gates_cpu).sum())
            if flips:
                gated.append(flips)
            for a, b in zip(_leaves(g_card), _leaves(g_cpu), strict=True):
                a = a.cpu()
                if not flips:
                    worst["grads"] = max(worst["grads"],
                                         (a - b).abs().max().item())
                    ok &= bool(torch.allclose(
                        a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item()))
            p_card, s_card = adam(_tree_to(g_cpu, dev), p_dev, s_dev)
            p_own, _ = adam(g_card, p_dev, s_dev)
            params, opt = adam(g_cpu, params, opt)
            for name, a_tree, b_tree in (
                    ("params", p_card, params), ("mu", s_card["mu"],
                                                 opt["mu"]),
                    ("nu", s_card["nu"], opt["nu"])):
                for a, b in zip(_leaves(a_tree), _leaves(b_tree),
                                strict=True):
                    a = a.cpu()
                    worst[name] = max(worst[name],
                                      (a - b).abs().max().item())
                    ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
            key = "params from the card's gradient"
            worst[key] = max([worst[key]] + [
                (a.cpu() - b).abs().max().item() for a, b in zip(
                    _leaves(p_own), _leaves(params), strict=True)])
    for a, b in zip(_leaves((params, opt)), _leaves(cpu_out), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("the learner's updates one by one do not "
                                 "end where its learn_phase does")
    worst["updates whose ReLU gates differ (gates)"] = gated
    return worst, ok


def pixel_card_vs_cpu(torch, dev, run):
    """Phase 10 worker: one iteration of a pixel run on the card against
    the plain path on the CPU, the same params, env states and draws
    (E2HRL: an iteration of stage "action" from the initial state, then
    one of stage "subgoal" from the CPU's state after it, so the mask and
    the carried Adam moments are in play).  The rollouts: every action
    equal, observations within rtol 1e-5, log-probs and values within
    rtol 1e-5 + atol 1e-6 at every (step, env) whose actor forward has
    the same int8 codes on both devices, the rows whose codes differ
    exempt and counted.  The learners, both from the CPU's rollout, each
    update held as ``_learner_updates_card_vs_cpu`` says; in stage
    "action" the sub-goal subtree bitwise unchanged on both devices."""
    torch.set_num_threads(2)
    cfg = PIXEL_RUNS[run]
    cpu = torch.device("cpu")
    alive = torch.ones(1, dtype=torch.bool)
    start, report = None, []
    # E2HRL: the first step of each stage at 40 iterations a stage
    stages = [("action", 0), ("subgoal", 40)] \
        if cfg["kw"].get("two_stage") else [(None, 0)]
    for stage, g in stages:
        runs = []
        for where in (dev, cpu):
            tr, state, it, packed, draws = _phases(torch, dev, where, g=g,
                                                   **cfg["kw"])
            if start is not None:
                state = _tree_to(start, where)
                packed = tr.pack(state)
            ctx = tr.stage_setup(state, stage)
            res = it.rollout_phase(packed, draws, state.est, state.obs)
            codes = _rollout_codes(torch, tr, packed, res.traj)
            runs.append((where, tr, state, it, draws, ctx, res, codes))
        (_, _, sd, *_, rd, cd), (_, _, sc, *_, rc, cc) = runs
        host = lambda t: t.detach().cpu()  # noqa: E731
        same = (host(rd.traj.actions) == rc.traj.actions).float().mean()
        differ = host(cd) != cc
        flipped = differ.any(-1)
        errs, off = {}, {}
        for f in ("log_probs", "values", "obs"):
            a, b = host(getattr(rd.traj, f)), getattr(rc.traj, f)
            errs[f] = (a - b).abs().max().item()
            bad = ~torch.isclose(a, b, rtol=1e-5, atol=1e-6)
            if f != "obs":
                bad = bad & ~flipped
            else:
                bad = bad.reshape(bad.shape[0], bad.shape[1], -1).any(-1)
            off[f] = int(bad.sum())
        # both learners from the CPU's rollout: [card, CPU]
        outs = [it.learn_phase(state.params, state.opt, _tree_to(rc, where),
                               draws, ctx, alive)
                for where, _, state, it, draws, ctx, _, _ in runs]
        free = {name: max((host(a) - b).abs().max().item() for a, b in zip(
            _leaves(pick(outs[0])), _leaves(pick(outs[1])), strict=True))
            for name, pick in (("params", lambda o: o[0]),
                               ("mu", lambda o: o[1]["mu"]),
                               ("nu", lambda o: o[1]["nu"]))}
        worst, ok = _learner_updates_card_vs_cpu(torch, dev, runs[1], rc,
                                                 outs[1])
        frozen = None
        if stage == "action":
            frozen = all(torch.equal(host(a), host(b)) for o, st in (
                (outs[0][0], sd.params), (outs[1][0], sc.params))
                for a, b in zip(_leaves(o["subgoal"]),
                                _leaves(st["subgoal"]), strict=True))
        report.append(dict(
            stage=stage or "all", actions_equal=float(same),
            codes_differ=int(differ.sum()), codes=differ.numel(),
            rows_flipped=int(flipped.sum()), rows=flipped.numel(),
            errs=errs, learner_errs=worst, learner_free=free,
            past_rtol=off, subgoal_frozen=frozen))
        print(f"{run} card vs CPU, stage {stage or 'all'} (g={g}): actions "
              f"equal {float(same):.6f}; int8 codes that differ "
              f"{int(differ.sum())} of {differ.numel()}, in "
              f"{int(flipped.sum())} of {flipped.numel()} actor rows; "
              f"largest abs errors {errs}; entries past rtol 1e-5 outside "
              f"those rows {off}; learner from the CPU's rollout, each of "
              f"its updates on the card from the CPU's state before it "
              f"(AdamW given the CPU's gradient), largest abs errors "
              f"{worst}; the two learners run through, largest abs errors "
              f"{free}"
              + ("" if frozen is None else
                 f"; sub-goal subtree unchanged on both: {frozen}"),
              flush=True)
        if float(same) != 1.0:
            raise AssertionError(f"{run}: card and CPU chose different "
                                 "actions")
        if any(off.values()):
            raise AssertionError(f"{run}: card and CPU past rtol 1e-5 "
                                 f"where the actor's codes agree: {off}")
        if not ok:
            raise AssertionError(f"{run}: a learner update on the card "
                                 "differs from the CPU's: gradients past "
                                 "rtol 1e-5 of the leaf's largest entry, "
                                 "or AdamW past atol 1e-5 + rtol 1e-4")
        if frozen is False:
            raise AssertionError(f"{run}: stage action moved the sub-goal "
                                 "subtree")
        start = type(sc)(outs[1][0], None, outs[1][1], None, rc.final_env,
                         rc.final_obs)
    return report


def _worker(torch, argv):
    """``chip_smoke.py --worker ptrain default SEED OUT``, ``--worker
    train|vtrain RUN SEED OUT``, ``--worker parity RUN OUT`` or
    ``--worker vparity all OUT``: one job of phase 9, 10 or 11 in a
    process of its own, its result as JSON in OUT."""
    kind, run, out = argv[0], argv[1], argv[-1]
    dev = torch.device("cuda", 0)
    if kind in ("ptrain", "train", "vtrain"):
        torch.set_num_threads(1)
        if kind == "ptrain":
            result = train_ppo_seed(torch, dev, int(argv[2]))
        elif kind == "train":
            result = train_seed(torch, dev, run, int(argv[2]))
        else:
            result = train_value_seed(torch, dev, run, int(argv[2]),
                                      os.path.dirname(out))
    elif kind == "parity":
        result = pixel_card_vs_cpu(torch, dev, run)
    else:
        result = value_card_vs_cpu(torch, dev)
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


# each kind of worker job's folder under ``build/chip_smoke``
WORKER_DIRS = {"ptrain": "phase9", "train": "phase10", "parity": "phase10",
               "vtrain": "phase11", "vparity": "phase11"}


def worker_jobs():
    """Phases 9-11's worker jobs, the longest first (the order of their
    walls in the committed logs): three seeds of each pixel run (E2HRL
    first) and one card-vs-CPU iteration of each, three seeds of each
    value run and their card-vs-CPU iterations, three seeds of the
    default PPO run."""
    jobs = []
    for run in PIXEL_RUNS:
        jobs += [["train", run, str(s)] for s in TRAIN_SEEDS]
        jobs.append(["parity", run])
    jobs += [["vtrain", run, str(s)] for run in
             ("value_qrdqn", "value_ddpg", "value_dqn") for s in TRAIN_SEEDS]
    jobs.append(["vparity", "all"])
    jobs += [["ptrain", "default", str(s)] for s in TRAIN_SEEDS]
    return jobs


def _run_workers(torch, work, jobs, width=None):
    """Each job in a process of its own (``chip_smoke.py --worker ...``,
    its output in ``WORKER_DIRS``' folder under ``work``), started in the
    order given and at most ``width`` at once (default: the cores this
    process may run on), all within ``WORKER_TIMEOUT_S``: their results
    by job, each job's wall and the jobs' CPU seconds printed, the
    card-vs-CPU jobs' output printed.  Each run alone is host-bound; run
    together, the card's switching between their processes bounds them
    (``tools/pool_probe.py``: 6 and 8 at once take the same wall, with
    cores to spare)."""
    import resource

    width = width or len(os.sched_getaffinity(0))
    pending, running, done = list(jobs), [], []
    t0 = time.perf_counter()
    deadline = t0 + WORKER_TIMEOUT_S
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    try:
        while pending or running:
            while pending and len(running) < width:
                args = pending.pop(0)
                where = os.path.join(work, WORKER_DIRS[args[0]])
                os.makedirs(where, exist_ok=True)
                out = os.path.join(where, "_".join(args) + ".json")
                log = open(out + ".log", "w")
                running.append((args, out, log, time.perf_counter(),
                                subprocess.Popen(
                                    [sys.executable,
                                     os.path.abspath(__file__), "--worker",
                                     *args, out],
                                    stdout=log, stderr=subprocess.STDOUT)))
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"worker jobs still running after {WORKER_TIMEOUT_S} "
                    f"s: {[' '.join(j[0]) for j in running]}")
            time.sleep(0.1)
            for job in [j for j in running if j[-1].poll() is not None]:
                running.remove(job)
                job[2].close()
                done.append((job[0], job[1], time.perf_counter() - job[3],
                             job[-1].returncode))
    finally:
        for _, _, log, _, p in running:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = (cpu1.ru_utime - cpu0.ru_utime) + (cpu1.ru_stime - cpu0.ru_stime)
    wall = time.perf_counter() - t0
    print(f"worker jobs, {width} at once: {wall:.1f} s, "
          f"the jobs' CPU {cpu:.1f} s ({cpu / wall:.2f} cores busy); "
          + ", ".join(f"{' '.join(args)} {sec:.1f} s"
                      for args, _, sec, _ in done))
    results, failed = {}, []
    for args, out, _, rc in sorted(done, key=lambda d: jobs.index(d[0])):
        with open(out + ".log") as f:
            text = f.read()
        if rc != 0:
            failed.append(f"{' '.join(args)} exited {rc}:\n" + text[-4000:])
            continue
        if args[0] in ("parity", "vparity"):
            print(text.strip())
        with open(out) as f:
            results[tuple(args)] = json.load(f)
    if failed:
        raise AssertionError("worker jobs failed:\n" + "\n".join(failed))
    return results


def pixel_training(card, results):
    """Phase 10: the two pixel runs at their defaults, three seeds each,
    from the workers' results.  Per seed: greedy return, env steps/s,
    the wall split and the launches; per run the median greedy return
    against its bar."""
    totals = {}
    for run, cfg in PIXEL_RUNS.items():
        tot = dict.fromkeys(results[("train", run, "0")]["totals"], 0)
        returns = []
        for seed in TRAIN_SEEDS:
            r = results[("train", run, str(seed))]
            returns.append(r["ret"])
            for k, v in r["totals"].items():
                tot[k] += v
            split = ", ".join(f"{k} {v:.3f} s ({v / r['wall']:.3f})"
                              for k, v in r["spans"].items())
            stages = ""
            if len(r["stage_returns"]) > 1:
                stages = ("; greedy return after stage action "
                          f"{r['stage_returns'][0]}, after stage subgoal "
                          f"{r['stage_returns'][1]}; last train return by "
                          f"stage {r['last_train_return']}")
            print(f"{run} ({cfg['flags']}) seed {seed} on {card}: greedy "
                  f"return {r['ret']} over {r['n_ep']} episodes "
                  f"(untrained {r['untrained']}){stages}; {r['steps']} env "
                  f"steps in {r['wall']:.3f} s = {r['steps'] / r['wall']:.1f}"
                  f" env steps/s; wall split: {split}; launches "
                  f"{r['per_iter']} in each of {r['iters']} iterations")
        median = statistics.median(returns)
        bar, ref, u = pixel_bar(run)
        print(f"{run}: median greedy return {median} over seeds "
              f"{TRAIN_SEEDS}; the reference's median {ref}, untrained "
              f"{u}: bar {bar}")
        if median < bar:
            raise AssertionError(f"{run}: median greedy return {median} < "
                                 f"{bar}")
        totals[run] = tot
    return totals


# ---------------------------------------------------------------------------
# phase 11: the value family
# ---------------------------------------------------------------------------

# the value family's three runs at their defaults (32 envs x 8 steps,
# fxp8 behaviour actors, an 8-bit sync, lr 1e-3, 300 iterations, replay
# capacity 50,000, n-step 3, 4 updates an iteration): the flags, the
# JAX reference's greedy returns at seeds 0-2 after training and of its
# untrained initial params (``tools/ref_greedy_returns.py --seeds 0 1 2``
# with the flags, and with ``--iters 0``, on a CPU with jax 0.9.0;
# ``value_eval`` at 16 envs with fxp8 actors), and each behaviour
# forward's launches of the port's kernels
# the value runs go through the mesh at one rank, in lockstep (bitwise
# the unsharded runs for each algorithm, phase 18 holds)
FLEET = dict(mesh_kind="host", sync="lockstep")
VALUE_RUNS = {
    "value_dqn": dict(
        flags="--algo dqn --mesh host --sync lockstep",
        kw=dict(algo="dqn", env_name="cartpole", **FLEET),
        ref=(145.1290283203125, 259.625, 203.23529052734375),
        untrained=(13.48971176147461, 9.439696311950684,
                   10.620726585388184),
        per_forward={"qmac_i8": 3}),
    "value_qrdqn": dict(
        flags="--algo qrdqn --env catch --net conv --frame-stack 4 "
              "--mesh host --sync lockstep",
        kw=dict(algo="qrdqn", env_name="catch", net="conv",
                frame_stack_k=4, **FLEET),
        ref=(1.0, 1.0, 1.0), untrained=(-0.375, -0.375, -0.375),
        per_forward={"qconv_i8_taps": 2, "qmac_i8": 2}),
    "value_ddpg": dict(
        flags="--algo ddpg --env pendulum --mesh host --sync lockstep",
        kw=dict(algo="ddpg", env_name="pendulum", **FLEET),
        ref=(-1114.2596435546875, -1098.4505615234375, -1182.080322265625),
        untrained=(-1447.8057861328125, -1811.0133056640625,
                   -1514.0872802734375),
        per_forward={"qmac_i8": 3}),
}
# the value runs' iterations (their CLI default) and env steps (32 envs x
# 8 steps an iteration)
VALUE_ITERS = 300
VALUE_STEPS = VALUE_ITERS * 32 * 8
# the card-vs-CPU iterations: each run's (through the mesh), and, on the
# unsharded path (``rl_train``'s value default), dqn with prioritized
# replay and ddpg with TQC's truncated quantile critics
VALUE_PARITY = {
    "value_dqn": VALUE_RUNS["value_dqn"]["kw"],
    "value_dqn_per": dict(algo="dqn", env_name="cartpole", replay="per"),
    "value_qrdqn": VALUE_RUNS["value_qrdqn"]["kw"],
    "value_ddpg": VALUE_RUNS["value_ddpg"]["kw"],
    "value_ddpg_tqc": dict(algo="ddpg", env_name="pendulum", tqc_drop=2),
}
# Q-MAC's products of the value runs not among phase 3's other shapes:
# the ddpg actor's first layer and the QR-DQN quantile head
VALUE_KN = ((3, 64), (128, 96))
# the fused products the served value checkpoints run (phase 12): the
# DQN/QR-DQN mlp's [4, 64], [64, 64], [64, 2]; the ddpg actor's [3, 64],
# [64, 64], [64, 1]; the QR-DQN conv head's [192, 128], [128, 96]
SERVED_VALUE_KN = ((4, 64), (64, 64), (64, 2), (3, 64), (64, 1),
                   (192, 128), (128, 96))


def check_value_kernels(torch, dev, worst):
    """Phase 3, the value runs' products that no other check covers:
    Q-MAC at the ddpg actor's [M, 3] x [3, 64] and the QR-DQN head's
    [M, 128] x [128, 96], at the fleet's 32 rows and ragged rows,
    int32 equal to the plain version (the other products and Q-Conv's
    convs at catch's 10x5x4 frames are in the training and pixel
    checks); and the fused ``qmac_i8_deq`` at every product the served
    value checkpoints run, at serving's buckets, w8 and w4 weights
    (qmax 127 and 7) and per-channel and per-tensor weight scales,
    bitwise equal to the plain version."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(97531)
    deq_cases = 0
    for m in (32, 1, 7, 16):
        for k, n in SERVED_VALUE_KN:
            for qmax in (127, 7):
                qx = _i8(torch, g, dev, (m, k))
                qw = torch.randint(-qmax, qmax + 1, (k, n), generator=g,
                                   device=dev,
                                   dtype=torch.int32).to(torch.int8)
                sx = torch.rand((m, 1), generator=g, device=dev) * 0.02 \
                    + 1e-4
                sw = torch.rand((n,), generator=g, device=dev) * 0.02 \
                    + 1e-4
                for s in (sw, sw[:1].contiguous()):
                    got = qmac_ops.qmac_i8_deq(qx, sx, qw, s)
                    want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, s)
                    err = (got - want).abs().max().item()
                    worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
                    if not bits_equal(torch, got, want):
                        raise AssertionError(
                            f"qmac_i8_deq != plain at the served value "
                            f"products' M,K,N={m},{k},{n} qmax {qmax} "
                            f"sw {tuple(s.shape)} (max abs err {err})")
                    deq_cases += 1
    torch.cuda.synchronize()
    print(f"fused Q-MAC at the served value checkpoints' "
          f"{len(SERVED_VALUE_KN)} products: {deq_cases} cases, fp32 "
          "bitwise equal to the plain version")
    cases = 0
    for m in (32, 1, 7, 33, 64, 128):
        for k, n in VALUE_KN:
            qx, qw = _i8(torch, g, dev, (m, k)), _i8(torch, g, dev, (k, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at the value runs' "
                                     f"M,K,N={m},{k},{n}")
            cases += 1
    torch.cuda.synchronize()
    print(f"Q-MAC at the value runs' {len(VALUE_KN)} other products: "
          f"{cases} cases, int32 equal to the plain version")
    return worst


def value_bar(run):
    """(bar, reference median, untrained median): half the way from the
    untrained policy's median greedy return to the trained reference's."""
    cfg = VALUE_RUNS[run]
    ref = statistics.median(cfg["ref"])
    u = statistics.median(cfg["untrained"])
    return u + 0.5 * (ref - u), ref, u


def _counting_value_trainer(torch, kernels):
    """``ValueTrainer`` (what ``rl_train --algo dqn|qrdqn|ddpg`` runs)
    reading the port's launch counters around each iteration and timing
    its phases on the host clock: the weight sync, the rollout and the
    learner (n-step targets, the replay add and the updates), each ended
    by a wait for the card.  ``step`` runs the iteration's own two
    phases, as its body does."""
    from repro_torch.obs import SpanClock
    from repro_torch.rl.rollout import episode_returns_from
    from repro_torch.rl.trainer import ValueTrainer
    from repro_torch.rl.trainer.state import value_state

    class Counted(ValueTrainer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.per_iter, self.clock = [], SpanClock()

        def pack(self, state):
            with self.clock("sync"):
                packed = super().pack(state)
                torch.cuda.synchronize()
            return packed

        def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
            before = kernels.launch_counts()
            draws = self.draws(gen, g)
            with self.clock("rollout"):
                (est, obs), traj = iteration.rollout_phase(
                    packed, draws, state.est, state.obs, g)
                torch.cuda.synchronize()
            with self.clock("learn"):
                p, t, o, b = iteration.learn_phase(
                    state.params, state.target, state.opt, state.replay,
                    traj, draws, g, alive)
                torch.cuda.synchronize()
            _, _, R, D, Tr, _ = traj
            ret, n_ep = episode_returns_from(R, D | Tr)
            after = kernels.launch_counts()
            self.per_iter.append({k: after[k] - before[k] for k in after})
            return value_state(p, t, o, b, est, obs), ret, n_ep

    return Counted


def _value_eval(tr, state, params):
    """The run's greedy return at fxp8 (``value_eval``; over the pixel
    pipeline with the state's merged normalizer)."""
    from repro_torch.rl.envs.wrappers import merge_norm_stats, norm_stats_of
    stats = (merge_norm_stats(norm_stats_of(state.est))
             if tr.net == "conv" else None)
    return tr.eval_policy(params, actor_policy="fxp8", norm_stats=stats)


def train_value_seed(torch, dev, run, seed, work):
    """Phase 11 worker: one seed of one value run through the trainer
    ``rl_train`` runs, on the card: the port's launch counters read in
    every iteration (exactly ``per_forward`` x 8 each, nothing else), the
    wall split, the greedy return of the untrained params and at the
    end.  Seed 0 also writes its telemetry (``--metrics-dir``) and its
    last iteration's checkpoint (``--ckpt-dir``) under ``work``, which
    phase 12 reads and serves."""
    from repro_torch import kernels

    cfg = VALUE_RUNS[run]
    obs_kw = {}
    if seed == 0:
        obs_kw = dict(metrics_dir=os.path.join(work, f"metrics_{run}"),
                      ckpt_dir=os.path.join(work, f"ckpt_{run}"),
                      save_every=VALUE_ITERS - 1)
    tr = _counting_value_trainer(torch, kernels)(seed=seed, device=dev,
                                                 verbose=False, **obs_kw,
                                                 **cfg["kw"])
    untrained, _ = _value_eval(tr, tr.init_state(), tr.agent.params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = {k: v * tr.rollout_len for k, v in cfg["per_forward"].items()}
    got = [{k: v for k, v in c.items() if v} for c in tr.per_iter]
    if len(got) != tr.iters or any(c != want for c in got):
        odd = sorted({json.dumps(c, sort_keys=True) for c in got})
        raise AssertionError(f"{run} seed {seed}: launches per iteration "
                             f"{odd} over {len(got)} iterations, not "
                             f"{want} in each of {tr.iters}")
    if not all(torch.isfinite(x).all() for x in _leaves(state.params)):
        raise AssertionError(f"{run} seed {seed}: non-finite params")
    t1 = time.perf_counter()
    ret, n_ep = _value_eval(tr, state, state.params)
    return dict(seed=seed, ret=ret, n_ep=n_ep, untrained=untrained,
                eval_s=time.perf_counter() - t1, wall=wall,
                steps=tr.iters * tr.n_envs * tr.rollout_len,
                iters=tr.iters, spans=tr.clock.drain(), per_iter=want,
                totals={k: sum(c[k] for c in tr.per_iter)
                        for k in kernels.WRAPPERS},
                last_train_return=history[-1])


def _value_phases(torch, device, **kw):
    """A value trainer's first iteration on ``device``: the trainer, its
    state, the iteration, the packed weights and the draws of step 0,
    made on the CPU (so every device gets the same ones)."""
    from repro_torch.rl.train_steps import ValueDraws, iteration_generator
    from repro_torch.rl.trainer import ValueTrainer

    tr = ValueTrainer(seed=0, device=device, verbose=False, **kw)
    cpu = ValueTrainer(seed=0, device="cpu", verbose=False, **kw)
    draws = cpu.draws(iteration_generator(0, 0, torch.device("cpu")), 0)
    draws = ValueDraws(*(None if t is None else t.to(device)
                         for t in draws))
    state = tr.init_state()
    return tr, state, tr.build_iteration(), tr.pack(state), draws


def _value_rollout_codes(torch, tr, packed, traj, draws, eps):
    """The behaviour actor's int8 codes at every step of ``traj`` on its
    own device, [T, B, n], after checking that re-running the behaviour
    policy on the step's observations and draws gives the rollout's
    actions bit for bit (so the codes are the rollout's own)."""
    from repro_torch.rl.actor_learner import unpack_weights

    agent = tr.agent
    params = unpack_weights(packed)
    fwd = agent.qvals if agent.discrete else agent.act
    codes = []
    with torch.no_grad():
        for t in range(traj[0].shape[0]):
            out, c = _recorded_codes(
                torch, lambda: fwd(params, traj[0][t], tr.a_policy))
            again = agent.behave(params, traj[0][t], draws.step(t), eps,
                                 tr.a_policy)
            if not torch.equal(again, traj[1][t]):
                raise AssertionError(f"{traj[0].device}: the behaviour "
                                     f"policy at step {t} is not the "
                                     "rollout's")
            codes.append(c)
    return torch.stack(codes)


def _value_grad(torch, tr, fn, p, args, where):
    """``fn``'s gradient with respect to ``p`` on ``where`` (args moved
    there), and which ReLUs of the forward passed."""
    from repro_torch.core import vact
    from repro_torch.rl.ppo import value_and_grad

    gates = []

    def relu(x):
        gates.append((x > 0).reshape(-1).cpu())
        return torch.relu(x)

    def moved(a):
        if isinstance(a, (torch.Tensor, dict, list, tuple)):
            return _tree_to(a, where)
        return a                      # the nets' applies and the config

    vact._NATIVE["relu"] = relu
    try:
        (_, aux), g = value_and_grad(fn, _tree_to(p, where),
                                     *(moved(a) for a in args))
    finally:
        vact._NATIVE["relu"] = torch.relu
    return g, aux, torch.cat(gates)


def _value_learner_card_vs_cpu(torch, dev, tr, it_fn, state, traj, draws,
                               it, cpu_out):
    """The CPU learner's updates one at a time (``it_fn.add_rollout``,
    then ``it_fn.update`` for each update, as ``learn_phase`` runs
    them), each gradient and AdamW also run on the card from the CPU's
    state before it.  Per gradient: within rtol 1e-5 of each leaf's
    largest entry of the CPU's, unless a ReLU of the forward passed on
    one device and not on the other (exempt and counted); AdamW on the
    card, given the CPU's gradient, within atol 1e-5 + rtol 1e-4 of the
    CPU's params and moments.  The CPU's updates must end bitwise where
    its ``learn_phase`` did.  Returns (largest abs errors, whether every
    update held)."""
    from repro_torch.optim import adamw_update
    from repro_torch.tree import tree_map

    def adam(g, p, s):
        with torch.no_grad():
            p, s, _ = adamw_update(g, s, p, tr.sched, tr.ocfg)
        return p, s

    worst = dict.fromkeys(("grads", "params", "mu", "nu"), 0.0)
    ok, gated = True, []

    def held(name, fn, p, s, args):
        """One gradient and AdamW step of subtree ``p`` held card vs CPU;
        returns the CPU's (params, state, aux)."""
        nonlocal ok
        g_card, _, gates_card = _value_grad(torch, tr, fn, p, args, dev)
        g_cpu, aux, gates_cpu = _value_grad(torch, tr, fn, p, args,
                                            torch.device("cpu"))
        flips = int((gates_card != gates_cpu).sum())
        if flips:
            gated.append((name, flips))
        for a, b in zip(_leaves(g_card), _leaves(g_cpu), strict=True):
            a = a.cpu()
            if not flips:
                worst["grads"] = max(worst["grads"],
                                     (a - b).abs().max().item())
                ok &= bool(torch.allclose(
                    a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item()))
        p_card, s_card = adam(_tree_to(g_cpu, dev), _tree_to(p, dev),
                              _tree_to(s, dev))
        p_new, s_new = adam(g_cpu, p, s)
        for key, a_tree, b_tree in (("params", p_card, p_new),
                                    ("mu", s_card["mu"], s_new["mu"]),
                                    ("nu", s_card["nu"], s_new["nu"])):
            for a, b in zip(_leaves(a_tree), _leaves(b_tree), strict=True):
                a = a.cpu()
                worst[key] = max(worst[key], (a - b).abs().max().item())
                ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
        return p_new, s_new, aux

    params, target, opt = state.params, state.target, state.opt
    buf = it_fn.add_rollout(tree_map(torch.clone, state.replay), traj)
    beta = it_fn.beta(it)
    view = it_fn.slot_view(buf, None) if tr.mesh is not None else None
    for u in range(tr.updates_per_iter):
        params, target, opt, buf = it_fn.update(params, target, opt, buf,
                                                draws, u, beta, step=held,
                                                view=view)
    for a, b in zip(_leaves((params, target, opt, buf)), _leaves(cpu_out),
                    strict=True):
        if not torch.equal(a, b):
            raise AssertionError("the value learner's updates one by one "
                                 "do not end where its learn_phase does")
    worst["updates whose ReLU gates differ (net, gates)"] = gated
    return worst, ok


def _sum_tree_card_vs_cpu(torch, dev):
    """The sum tree at the default capacity (50,000 slots, 65,536
    leaves) on both devices from the same inputs: updates of 256 slots
    (an add's) and of 64 and 128 (an update's) with duplicate slots of
    different values, and stratified ``find`` queries, interval
    boundaries among them.  Every node bitwise, every slot equal."""
    from repro_torch.rl.replay import sum_tree

    g = torch.Generator().manual_seed(4242)
    cap = 50_000
    trees = {d: sum_tree.init(cap, d) for d in (dev, torch.device("cpu"))}
    dups = 0
    for m in (256, 64, 128, 64, 128, 256, 64):
        idx = torch.randint(0, cap, (m,), generator=g)
        idx[m // 2:m // 2 + 8] = idx[:8]            # duplicate slots
        dups += m - len(set(idx.tolist()))
        vals = torch.rand(m, generator=g) * 3
        for d in trees:
            trees[d] = sum_tree.update(trees[d], idx.to(d), vals.to(d))
    a, b = trees[dev].cpu(), trees[torch.device("cpu")]
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("sum tree: card and CPU nodes differ after "
                             "the same updates")
    L = b.shape[0] // 2
    if not torch.equal(b[1:L], b[2:2 * L:2] + b[3:2 * L:2]):
        raise AssertionError("sum tree: an internal node is not the sum "
                             "of its children")
    u = torch.rand(4096, generator=g) * b[1]
    edges = torch.cumsum(b[L:L + cap].double(), 0).float()
    u = torch.cat([u, edges[edges < b[1]][:1024]])
    f_card = sum_tree.find(trees[dev], u.to(dev)).cpu()
    f_cpu = sum_tree.find(b, u)
    if not torch.equal(f_card, f_cpu):
        raise AssertionError("sum tree: card and CPU find different slots")
    print(f"sum tree card vs CPU: 7 updates ({dups} duplicate slots) at "
          f"capacity {cap}: all {b.numel()} nodes bitwise; find: "
          f"{u.numel()} queries, slots equal")
    return dict(duplicates=dups, nodes=b.numel(), queries=u.numel())


def value_card_vs_cpu(torch, dev):
    """Phase 11 worker: one iteration of each value run (and of dqn with
    PER and ddpg with TQC) on the card against the plain path on the
    CPU, the same params, env states and draws.  The rollouts: actions
    equal (ddpg: within rtol 1e-5) and observations, rewards and
    ``final_obs`` within rtol 1e-5 + atol 1e-6 in every env up to its
    first step whose behaviour forward has int8 codes that differ
    between the devices; such rows are counted and the env's later
    steps exempt.  The learners, both from the CPU's rollout: each
    update held as ``_value_learner_card_vs_cpu`` says.  Then the sum
    tree bitwise across the devices."""
    from repro_torch.rl.value import epsilon

    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    report = {}
    for name, kw in VALUE_PARITY.items():
        runs = []
        for where in (dev, cpu):
            tr, state, it, packed, draws = _value_phases(torch, where, **kw)
            eps = epsilon(0, tr.agent.cfg) if tr.agent.discrete else 0.0
            (est, obs), traj = it.rollout_phase(packed, draws, state.est,
                                                state.obs, 0)
            codes = _value_rollout_codes(torch, tr, packed, traj, draws,
                                         eps)
            runs.append((tr, state, it, draws, traj, codes))
        (_, _, _, _, td_, cd), (tr, sc, it, dc, tc, cc) = runs
        host = lambda t: t.detach().cpu()  # noqa: E731
        differ = host(cd) != cc
        flipped = differ.any(-1)                          # [T, B]
        diverged = torch.cumsum(flipped.int(), 0) > 0     # from there on
        before = torch.cat([torch.zeros_like(diverged[:1]),
                            diverged[:-1]])               # strictly before
        errs, off = {}, {}
        a_card, a_cpu = host(td_[1]), tc[1]
        if tr.agent.discrete:
            bad = (a_card != a_cpu) & ~diverged
        else:
            bad = (~torch.isclose(a_card, a_cpu, rtol=1e-5, atol=1e-6)
                   ).any(-1) & ~diverged
            errs["actions"] = (a_card - a_cpu).abs().max().item()
        off["actions"] = int(bad.sum())
        for i, f in ((0, "obs"), (2, "rewards"), (5, "final_obs")):
            a, b = host(td_[i]).float(), tc[i].float()
            errs[f] = (a - b).abs().max().item()
            close = torch.isclose(a, b, rtol=1e-5, atol=1e-6)
            close = close.reshape(close.shape[0], close.shape[1], -1).all(-1)
            mask = before if f == "obs" else diverged
            off[f] = int((~close & ~mask).sum())
        for i, f in ((3, "dones"), (4, "truncated")):
            off[f] = int(((host(td_[i]) != tc[i]) & ~diverged).sum())
        # both learners from the CPU's rollout: [card, CPU]
        outs = []
        for rtr, _, rit, dr, _, _ in runs:
            where = rtr.device
            outs.append(rit.learn_phase(
                *(_tree_copy(x, where) for x in (sc.params, sc.target,
                                                  sc.opt, sc.replay)),
                _tree_to(tc, where), dr, 0))
        free = max(((host(a) - b).abs().max().item() for a, b in zip(
            _leaves(outs[0][:3]), _leaves(outs[1][:3]), strict=True)),
            default=0.0)
        worst, ok = _value_learner_card_vs_cpu(
            torch, dev, tr, it, sc, tc, dc, 0, outs[1])
        report[name] = dict(codes_differ=int(differ.sum()),
                            codes=differ.numel(),
                            rows_flipped=int(flipped.sum()),
                            rows=flipped.numel(), errs=errs, past=off,
                            learner_errs=worst, learner_free=free)
        flags = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"{name} card vs CPU ({flags}): "
              f"int8 codes that differ {int(differ.sum())} of "
              f"{differ.numel()}, in {int(flipped.sum())} of "
              f"{flipped.numel()} behaviour rows; largest abs errors "
              f"{errs}; entries past the bars before those rows {off}; "
              f"learner from the CPU's rollout, each update on the card "
              f"from the CPU's state (AdamW given the CPU's gradient), "
              f"largest abs errors {worst}; the two learners run "
              f"through, largest abs error {free}", flush=True)
        if any(off.values()):
            raise AssertionError(f"{name}: card and CPU rollouts past the "
                                 f"bars where the codes agree: {off}")
        if not ok:
            raise AssertionError(f"{name}: a learner update on the card "
                                 "differs from the CPU's: gradients past "
                                 "rtol 1e-5 of the leaf's largest entry, "
                                 "or AdamW past atol 1e-5 + rtol 1e-4")
    report["sum_tree"] = _sum_tree_card_vs_cpu(torch, dev)
    return report


def profile_value(torch, dev, run, n=2):
    """Phase 11: where a value iteration's time goes, its rollout (8
    steps of the fxp8 behaviour actor and the env) and its learner
    (n-step targets, the replay add, 4 sampled updates of fp32 forward,
    backward, AdamW and polyak) each traced as ``profile_forward``
    traces a forward, from the same inputs each call; the port's
    launches by the wrappers' counters."""
    from repro_torch import kernels

    cfg = VALUE_RUNS[run]
    tr, state, it, packed, draws = _value_phases(torch, dev, **cfg["kw"])
    (est, obs), traj = it.rollout_phase(packed, draws, state.est, state.obs,
                                        0)

    def rollout():
        it.rollout_phase(packed, draws, state.est, state.obs, 0)
        torch.cuda.synchronize()

    def learn():
        it.learn_phase(state.params, state.target, state.opt, state.replay,
                       traj, draws, 0)
        torch.cuda.synchronize()

    out = {}
    for name, fn in (("rollout", rollout), ("learner", learn)):
        kernels.reset_launch_counts()
        fn()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        wall, rows, launches, why = _profiled(torch, fn, n)
        _print_profile(f"value iteration ({cfg['flags']}), {name} phase "
                       "(32 envs x 8 steps, 4 updates)", wall, rows,
                       launches, why, top=8, per="phase")
        print(f"  the port's kernels in one {name} phase: {counts}")
        out[name] = (wall, sum(r[0] for r in rows), launches, counts)
    wall = sum(v[0] for v in out.values())
    busy = sum(v[1] for v in out.values())
    print(f"value iteration ({cfg['flags']}): wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; device "
          "launches " + ", ".join(f"{k} {v[2]}" for k, v in out.items()))
    want = {k: v * tr.rollout_len for k, v in cfg["per_forward"].items()}
    if out["rollout"][3] != want:
        raise AssertionError(f"{run} rollout phase launched "
                             f"{out['rollout'][3]}, not {want}")
    if out["learner"][3]:
        raise AssertionError(f"{run} learner launched {out['learner'][3]}")
    return out


def value_training(card, results):
    """Phase 11: the three value runs at their defaults, three seeds
    each, from the workers' results.  Per seed: greedy return, env
    steps/s, the wall split and the launches; per run the median greedy
    return against its bar."""
    totals = {}
    for run, cfg in VALUE_RUNS.items():
        tot = dict.fromkeys(results[("vtrain", run, "0")]["totals"], 0)
        returns = []
        for seed in TRAIN_SEEDS:
            r = results[("vtrain", run, str(seed))]
            returns.append(r["ret"])
            for k, v in r["totals"].items():
                tot[k] += v
            split = ", ".join(f"{k} {v:.3f} s ({v / r['wall']:.3f})"
                              for k, v in r["spans"].items())
            print(f"{run} ({cfg['flags']}) seed {seed} on {card}: greedy "
                  f"return {r['ret']} over {r['n_ep']} episodes "
                  f"(untrained {r['untrained']}); last train return "
                  f"{r['last_train_return']}; {r['steps']} env steps in "
                  f"{r['wall']:.3f} s = {r['steps'] / r['wall']:.1f} env "
                  f"steps/s; wall split: {split}; launches {r['per_iter']} "
                  f"in each of {r['iters']} iterations")
        median = statistics.median(returns)
        bar, ref, u = value_bar(run)
        print(f"{run}: median greedy return {median} over seeds "
              f"{TRAIN_SEEDS}; the reference's median {ref}, untrained "
              f"{u}: bar {bar}")
        if median < bar:
            raise AssertionError(f"{run}: median greedy return {median} < "
                                 f"{bar}")
        totals[run] = tot
    return totals


# ---------------------------------------------------------------------------
# phase 12: telemetry, profiler windows and serving the value checkpoints
# ---------------------------------------------------------------------------

# the served forward's launches of the port's kernels: the behaviour
# forward's (``VALUE_RUNS``), with the packed weights' fused product
SERVED_PER_FORWARD = {
    run: {("qmac_i8_deq" if k == "qmac_i8" else k): v
          for k, v in cfg["per_forward"].items()}
    for run, cfg in VALUE_RUNS.items()}
SERVE_EPISODES = 64
# the profiled PPO window: two steps of the default run at an eighth of
# its rollout (a 128-step trace is slow to write and read)
PROFILE_WINDOW_ROLLOUT = 16


def value_telemetry(work):
    """Phase 12: the ``train.jsonl`` of each value run's seed-0 job (phase
    11), read with the port's reader: step windows tiling [0, 300), env
    steps summing to 76,800, ``steps_per_s`` in every window."""
    from repro_torch.obs import read_records, render, summarize
    for run in VALUE_RUNS:
        recs = read_records(os.path.join(work, f"metrics_{run}",
                                         "train.jsonl"))
        steps = [r for r in recs if r["kind"] == "step"]
        windows = [r["window"] for r in steps]
        tiled = (windows and windows[0][0] == 0
                 and windows[-1][1] == VALUE_ITERS
                 and all(a[1] == b[0] for a, b in zip(windows, windows[1:])))
        total = sum(r["metrics"]["env_steps"] for r in steps)
        if not tiled or total != VALUE_STEPS or not all(
                "steps_per_s" in r["metrics"] for r in steps):
            raise AssertionError(f"{run} telemetry: windows {windows}, "
                                 f"env steps {total}")
        print(f"{run} telemetry: {len(steps)} step windows tiling [0, "
              f"{VALUE_ITERS}), env steps {total}")
        print(render(summarize(recs)))


def serve_value_checkpoints(torch, dev, card, work):
    """Phase 12: each value run's checkpoint (phase 11, seed 0) served on
    the card through ``serve_policy`` at w8 with ``--check-parity``
    (which raises on any mismatching row) and at w4, each with
    ``--metrics-dir``: actions/s, p50/p99, the served mean return.
    Returns the port's launches on this path, and holds each served
    forward's launches (a full bucket, after the path's count is read)
    to ``SERVED_PER_FORWARD``."""
    from repro_torch import kernels
    from repro_torch.launch.serve_policy import serve_policy
    from repro_torch.obs import fmt_metrics, read_records

    ckpts = {run: os.path.join(work, "phase11", f"ckpt_{run}")
             for run in VALUE_RUNS}
    kernels.reset_launch_counts()
    served = {}
    for run, ck in ckpts.items():
        for precision in ("w8", "w4"):
            mdir = os.path.join(work, "phase12", f"serve_{run}_{precision}")
            st = serve_policy(ck, precision=precision,
                              episodes=SERVE_EPISODES, n_slots=64,
                              max_bucket=32,
                              do_check_parity=precision == "w8",
                              metrics_dir=mdir, verbose=False, device=dev)
            served[(run, precision)] = (st, mdir)
    launches = kernels.launch_counts()
    print(f"kernel launches serving the value checkpoints: {launches}")
    for (run, precision), (st, mdir) in served.items():
        s = st.server
        recs = read_records(os.path.join(mdir, "serve.jsonl"))
        n_serve = sum(r["kind"] == "serve" for r in recs)
        print(f"{run} served at {precision} on {card}: " + fmt_metrics(
            {"actions_per_s": s["actions_per_s"], "p50_ms": s["p50_ms"],
             "p99_ms": s["p99_ms"], "mean_return": st.mean_return,
             "episodes": st.episodes, "serve_records": n_serve},
            ("actions_per_s", "p50_ms", "p99_ms", "mean_return",
             "episodes", "serve_records"), precision=4))
        if st.episodes < SERVE_EPISODES or not n_serve:
            raise AssertionError(f"{run} {precision}: {st.episodes} "
                                 f"episodes, {n_serve} serve records")
    print("w8 parity on the card: 0 mismatching rows for each of "
          f"{list(ckpts)} (serve_policy's --check-parity raises on any)")
    for run, ck in ckpts.items():
        per = profile_forward(torch, dev, ck, n=20,
                              what=f"{run} served forward")
        print(f"{run}: the port's launches per served forward {per}")
        if per != SERVED_PER_FORWARD[run]:
            raise AssertionError(f"{run}: served forward launched {per}, "
                                 f"not {SERVED_PER_FORWARD[run]}")
    return launches


def _params_bitwise(torch, a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def telemetry_leaves_training_alone(torch, dev, card, work):
    """Phase 12: PPO cartpole and DQN cartpole, 6 iterations each on the
    card, with and without ``--metrics-dir``: history and params bitwise
    equal; then a ``--profile-dir`` window of 2 steps of PPO cartpole
    (at ``PROFILE_WINDOW_ROLLOUT`` steps a rollout), whose trace must
    hold a ``qmac`` kernel row."""
    from repro_torch.obs import read_records
    from repro_torch.rl.trainer import rl_train, value_train

    for name, fn in (("ppo", lambda **kw: rl_train("cartpole", **kw)),
                     ("dqn", lambda **kw: value_train("dqn", "cartpole",
                                                      **kw))):
        t0 = time.perf_counter()
        p0, h0 = fn(iters=6, verbose=False, device=dev)
        mdir = os.path.join(work, f"metrics_{name}")
        p1, h1 = fn(iters=6, verbose=False, device=dev, metrics_dir=mdir)
        same = h0 == h1 and _params_bitwise(torch, p0, p1)
        steps = [r for r in read_records(os.path.join(mdir, "train.jsonl"))
                 if r["kind"] == "step"]
        print(f"{name} cartpole, 6 iterations on {card} with and without "
              f"--metrics-dir: history and params bitwise "
              f"{'equal' if same else 'DIFFERENT'}; {len(steps)} step "
              f"windows, {sum(r['metrics']['env_steps'] for r in steps)} "
              f"env steps ({time.perf_counter() - t0:.1f} s)")
        if not same:
            raise AssertionError(f"{name}: telemetry changed training")
    pdir = os.path.join(work, "profile")
    mdir = os.path.join(work, "metrics_profile")
    rl_train("cartpole", iters=4, rollout_len=PROFILE_WINDOW_ROLLOUT,
             verbose=False, device=dev, metrics_dir=mdir, profile_dir=pdir,
             profile_start=1, profile_steps=2)
    rec = [r for r in read_records(os.path.join(mdir, "train.jsonl"))
           if r["kind"] == "profile"]
    with open(os.path.join(pdir, "trace_1_3.json")) as f:
        events = json.load(f)["traceEvents"]
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    qmac = [k for k in kern if "qmac" in k]
    print(f"profile window {rec[0]['window'] if rec else None} of PPO "
          f"cartpole ({PROFILE_WINDOW_ROLLOUT}-step rollouts) on {card}: "
          f"{len(kern)} kernel rows, {len(qmac)} of them qmac "
          f"({sorted(set(qmac))})")
    if not qmac or [r["window"] for r in rec] != [[1, 3]]:
        raise AssertionError("the profile window's trace holds no qmac "
                             "kernel row, or no [1, 3] profile record")


# ---------------------------------------------------------------------------
# phase 13: serving TinyLlama-1.1B (and its products in phases 3-4)
# ---------------------------------------------------------------------------

LM_ARCH = "tinyllama-1.1b"
# TinyLlama's products (K, N): wq and wo [2048, 2048], wk and wv [2048,
# 256], gate and up [2048, 5632], down [5632, 2048]; the head [2048,
# 32000] runs at M = batch (prefill projects only its last position)
LM_KN = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))
LM_HEAD_KN = (2048, 32000)
LM_ROWS = (4, 128, 4096)
LM_HEAD_ROWS = (4, 8)
# a forward launches the fused product at 7 products a layer + the head
LM_PER_FORWARD = 7 * 22 + 1
# (policy, batch, prompt, gen): the reference's defaults at w8a8kv8 and
# w4a8, and an 8 x 512 prefill with 32 generated tokens
LM_RUNS = (("w8a8kv8", 4, 32, 16), ("w8a8kv8", 8, 512, 32),
           ("w4a8", 4, 32, 16))
# card against CPU: full width at 2 layers, prefill + 8 greedy steps
LM_PARITY_LAYERS = 2
LM_PARITY_STEPS = 8


def _check_lm_products(torch, dev, worst, what, cases, seed, int32=True):
    """Phase 3: ``qmac_i8_deq`` (and with ``int32`` ``qmac_i8``) at
    each (M, K, N) of ``cases``, with w8 and w4 codes (qmax 127 and 7 in
    the int8 container), bitwise equal to the plain version."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    for m, k, n in cases:
        for qmax in (127, 7):
            qx = _i8(torch, g, dev, (m, k))
            qw = torch.randint(-qmax, qmax + 1, (k, n), generator=g,
                               device=dev, dtype=torch.int32).to(torch.int8)
            sx = torch.rand((m, 1), generator=g, device=dev) * 0.02 + 1e-4
            sw = torch.rand((n,), generator=g, device=dev) * 0.02 + 1e-4
            got = qmac_ops.qmac_i8_deq(qx, sx, qw, sw)
            want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, sw)
            err = (got - want).abs().max().item()
            worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8_deq != plain at {what}'s "
                                     f"M,K,N={m},{k},{n} qmax {qmax} (max "
                                     f"abs err {err})")
            if not int32:
                continue
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at {what}'s "
                                     f"M,K,N={m},{k},{n} qmax {qmax}")
    torch.cuda.synchronize()
    kinds = "fused fp32 and int32" if int32 else "fused fp32"
    print(f"Q-MAC at {what}'s products: {len(cases) * 2} cases (w8 and w4 "
          f"codes), {kinds} bitwise equal to the plain version "
          f"({time.perf_counter() - t0:.1f} s)")
    return worst


def check_lm_kernels(torch, dev, worst):
    """Phase 3, TinyLlama's products: ``qmac_i8_deq`` and ``qmac_i8``
    at every block product (``LM_KN``) at M = 4 (decode), 128 (a 4 x 32
    prefill) and 4096 (an 8 x 512 prefill), and the head at M = 4 and
    8, with w8 and w4 codes, bitwise equal to the plain version."""
    cases = [(m, k, n) for k, n in LM_KN for m in LM_ROWS]
    cases += [(m,) + LM_HEAD_KN for m in LM_HEAD_ROWS]
    return _check_lm_products(torch, dev, worst, "TinyLlama", cases, 20)


def _time_qmac_lm(torch, g, dev, m, k, n):
    """The fused product at one LM shape, with its launch plan, its plain
    version and the yardstick ``torch._int_mm`` followed by the two scale
    multiplies (cuBLASLt's int8 tensor cores; it takes M > 16, so at
    M <= 16 the yardstick runs on the rows padded with zeros to 32 and
    says so)."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    qx, qw = _i8(torch, g, dev, (m, k)), _i8(torch, g, dev, (k, n))
    sx = torch.rand((m, 1), generator=g, device=dev) * 0.01
    sw = torch.rand((1, n), generator=g, device=dev) * 0.01
    p = qmac_ops.split_plan(m, k, n)
    b_ms, b_by = bound_ms(m * k + k * n + 4 * m + 4 * n + 4 * m * n,
                          2.0 * m * n * k, 2.0 * m * n)
    pad = 32 if m <= 16 else m
    qx_y = torch.cat([qx, qx.new_zeros((pad - m, k))]) if pad > m else qx
    sx_y = torch.cat([sx, sx.new_zeros((pad - m, 1))]) if pad > m else sx
    lib = _yardstick(torch, lambda: (torch._int_mm(qx_y, qw).to(
        torch.float32) * sx_y) * sw, "torch._int_mm")
    return dict(
        shape=f"M={m} K={k} N={n}",
        plan=f"{p.splits} slices of {p.slice} B, {p.blocks} blocks",
        ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq(qx, sx, qw, sw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq_plain(
            qx, sx, qw, sw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        library=("torch._int_mm + 2 scale multiplies"
                 + (f", rows padded {m} -> 32" if pad > m else "")))


def _time_lm_forwards(torch, dev, what, seed, forwards):
    """Phase 4: the fused product at each shape of ``forwards`` (name ->
    [(M, K, N, products of that shape a forward)]), timed once a shape,
    and each forward's products summed.  Returns the rows."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    rows, timed = [], {}
    for name, products in forwards.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        for m, k, n, count in products:
            if (m, k, n) not in timed:
                timed[(m, k, n)] = _time_qmac_lm(torch, g, dev, m, k, n)
                rows.append(timed[(m, k, n)])
            for key in tot:
                tot[key] += count * (timed[(m, k, n)][key] or 0.0)
        n_products = sum(p[3] for p in products)
        print(f"qmac_i8_deq over {name}, {n_products} products: kernel "
              f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
              f"torch._int_mm yardstick {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms")
    print(f"{what}'s products timed in {time.perf_counter() - t0:.1f} s")
    return rows


def time_lm_kernels(torch, dev):
    """Phase 4, TinyLlama's fused products at M = 4 (a decode step at
    batch 4) and M = 4096 (an 8 x 512 prefill), and the head at M = 4
    and 8, summed over a forward (22 layers x 7 + the head)."""
    per_layer = {(2048, 2048): 2, (2048, 256): 2, (2048, 5632): 2,
                 (5632, 2048): 1}

    def forward(m, head_m):
        return [(m, k, n, 22 * c) for (k, n), c in per_layer.items()] \
            + [(head_m,) + LM_HEAD_KN + (1,)]

    return _time_lm_forwards(torch, dev, "TinyLlama", 21, {
        "a decode step (batch 4)": forward(4, 4),
        "an 8 x 512 prefill": forward(4096, 8)})


def _host_peak_gib() -> float:
    """This process's peak resident set in GiB (Linux reports KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _draw_tree(torch, dev, arch, n_layers=None):
    """``arch``'s fp32 weights at its published widths (at ``n_layers``
    layers where given), drawn once from seed 0 as ``serve`` draws them,
    on ``dev``: (cfg, model, params)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.registry import model_for
    from repro_torch.tree import tree_leaves

    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = model_for(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"{arch} at {cfg.n_layers} layers: {n / 1e9:.2f} B parameters "
          f"drawn (fp32, seed 0) in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


# the Q-MAC wrappers whose launches the serving phases hold exactly
QMAC_WRAPPERS = ("qmac_i8_deq", "qmac_i8", "qmac_i8_deq_bmm")


def _want(per):
    """Q-MAC launches by wrapper: ``per`` itself, or, for an int, that
    many fused products and no other."""
    if isinstance(per, dict):
        return per
    return {"qmac_i8_deq": per, "qmac_i8": 0, "qmac_i8_deq_bmm": 0}


def _serve_runs(torch, dev, card, cfg, model, fp, runs, per_call,
                weight_ptq=True):
    """``repro_torch.launch.serve.generate`` (the prefill and decode loop
    ``serve`` runs) on the fp32 tree ``fp`` of ``cfg`` at its published
    widths, PTQ'd once for each policy of ``runs`` ((policy, batch,
    prompt, gen), prompts from seed 1; with ``weight_ptq`` False the fp32
    tree itself, as ``serve(..., weight_ptq=False)`` serves it), each run
    after a warm-up call at its batch and prompt: PTQ MiB, prefill and
    decode tok/s, the first ids; exactly ``per_call(gen)`` Q-MAC
    launches a call (``_want``), every id in [0, vocab).  Returns the
    path's launches, warm-ups included."""
    from repro_torch import kernels
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.serve import generate, ptq

    kernels.reset_launch_counts()
    warmed = set()
    name, params = None, None
    for policy, batch, prompt, gen in runs:
        pol = get_policy(policy)
        print(f"{cfg.name} {policy} batch {batch} prompt {prompt} gen {gen} "
              f"on {card}:")
        if policy != name:
            params = None                   # one PTQ'd tree at a time
            params = ptq(fp, pol) if weight_ptq else fp
            name = policy
        kw = dict(batch=batch, prompt_len=prompt, seed=0, device=dev)
        if (batch, prompt) not in warmed:
            generate(model, params, cfg, pol, gen=2, verbose=False, **kw)
            warmed.add((batch, prompt))
        before = kernels.launch_counts()
        toks, t = generate(model, params, cfg, pol, gen=gen, **kw)
        after = kernels.launch_counts()
        got = {k: after[k] - before[k] for k in QMAC_WRAPPERS}
        want = _want(per_call(gen))
        print(f"  prefill {batch * prompt / t['t_prefill']:.1f} tok/s, "
              f"decode {batch * (gen - 1) / t['t_decode']:.1f} tok/s; "
              f"Q-MAC launches {got} (want {want}); "
              f"first ids {toks[:, :8].tolist()}")
        if got != want:
            raise AssertionError(f"{cfg.name} {policy}: Q-MAC launches "
                                 f"{got}, not {want}")
        if toks.shape != (batch, gen) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"{cfg.name} {policy}: bad tokens "
                                 f"{toks.shape} in [{int(toks.min())}, "
                                 f"{int(toks.max())}]")
    return kernels.launch_counts()


def _profile_serving(torch, cfg, model, params, small, big, per_decode,
                     per_prefill):
    """Where the time goes in one decode step (after a prefill of
    ``small``, its caches padded by 16 slots) and in one prefill of
    ``big``, on the w8a8kv8 ``params`` at full width: device time by
    kernel, wall time, idle share, launches split into the port's (the
    wrappers' counters, ``per_decode`` and ``per_prefill`` Q-MAC launches
    asserted, ``_want``) and PyTorch's (the trace's rest), Q-MAC's share
    of the busy time."""
    from repro_torch import kernels
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.serve import pad_caches

    pol = get_policy("w8a8kv8")

    def shape(b):
        return tuple((b["tokens"] if isinstance(b, dict) else b).shape)

    (sb, sp), (bb, bp) = shape(small), shape(big)
    with torch.no_grad():
        logits, caches = model.prefill(params, small, cfg, pol, 8)
        caches = pad_caches(caches, 16)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)

        def decode():
            model.decode_step(params, tok, caches, sp, cfg, pol, 8)
            torch.cuda.synchronize()

        def prefill():
            model.prefill(params, big, cfg, pol, 8)
            torch.cuda.synchronize()

        for what, fn, n, per in (
                (f"decode step, batch {sb}", decode, 5, per_decode),
                (f"prefill {bb} x {bp}", prefill, 1, per_prefill)):
            kernels.reset_launch_counts()
            fn()
            counts = kernels.launch_counts()
            port = sum(counts.values())
            if {k: counts[k] for k in QMAC_WRAPPERS} != _want(per):
                raise AssertionError(f"{what}: {counts} launches")
            wall, rows, launches, why = _profiled(torch, fn, n)
            _print_profile(f"{cfg.name} w8a8kv8 {what}", wall, rows,
                           launches, why, top=12)
            qmac_ms = sum(r[0] for r in rows if "qmac" in r[2])
            busy = sum(r[0] for r in rows)
            names = "+".join(k for k in QMAC_WRAPPERS if counts[k])
            print(f"  the port's launches {port} ({names}), PyTorch's "
                  f"{'not measured' if launches is None else launches - port}"
                  f"; qmac_kernel {qmac_ms:.4f} ms of {busy:.4f} ms busy "
                  f"({qmac_ms / max(busy, 1e-9):.3f})")


def _lm_path(torch, dev, card, arch, runs, per_call, prompts, per_decode,
             per_prefill, weight_ptq=True, n_layers=None):
    """One LM's serving path at full width (at ``n_layers`` layers where
    given): its fp32 tree drawn once, ``_serve_runs`` over ``runs``, then
    ``_profile_serving`` on its w8a8kv8 PTQ (or, with ``weight_ptq``
    False, the fp32 tree) with the two inputs ``prompts`` makes from a
    seed-1 generator (``small``, ``big``).  Returns the runs' launches and
    the fp32 tree."""
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.serve import ptq

    cfg, model, fp = _draw_tree(torch, dev, arch, n_layers)
    t0 = time.perf_counter()
    launches = _serve_runs(torch, dev, card, cfg, model, fp, runs, per_call,
                           weight_ptq)
    t1 = time.perf_counter()
    small, big = prompts(cfg, torch.Generator().manual_seed(1))
    _profile_serving(torch, cfg, model,
                     ptq(fp, get_policy("w8a8kv8"), verbose=False)
                     if weight_ptq else fp,
                     _to(small, dev), _to(big, dev), per_decode, per_prefill)
    print(f"{arch}: runs {t1 - t0:.1f} s, profiles "
          f"{time.perf_counter() - t1:.1f} s")
    return launches, fp


def _to(batch_in, dev):
    if isinstance(batch_in, dict):
        return {k: v.to(dev) for k, v in batch_in.items()}
    return batch_in.to(dev)


def _token_prompts(torch, cfg, g, small, big):
    """Prompts [batch, length] int32 of ``small`` and ``big`` drawn from
    ``g``."""
    return tuple(torch.randint(0, cfg.vocab, shape, generator=g).to(
        torch.int32) for shape in (small, big))


def lm_serving(torch, dev, card):
    """Phase 13: TinyLlama-1.1B at its published widths, drawn once, for
    each of ``LM_RUNS``: exactly ``LM_PER_FORWARD`` ``qmac_i8_deq``
    launches a forward (``gen`` forwards a call), no ``qmac_i8``, every id
    in [0, 32000); then a profile of a decode step (batch 4, a 48-slot
    cache) and an 8 x 512 prefill.  Returns the path's launches."""
    launches, _ = _lm_path(
        torch, dev, card, LM_ARCH, LM_RUNS, lambda gen: LM_PER_FORWARD * gen,
        lambda cfg, g: _token_prompts(torch, cfg, g, (4, 32), (8, 512)),
        LM_PER_FORWARD, LM_PER_FORWARD)
    return launches


def lm_card_vs_cpu(torch, dev):
    """Phase 13: TinyLlama at full width and ``LM_PARITY_LAYERS`` layers,
    w8a8kv8, the same PTQ'd params on the card and on the CPU (the PTQ on
    the card of the same fp32 params bitwise equal to the CPU's): a 4 x
    32 prefill and ``LM_PARITY_STEPS`` greedy decode steps on each
    device, each on its own tokens, exactly 7 x 2 + 1 fused products a
    forward on the card.  Every int8 activation code (row inputs, KV
    payloads, the SiLU requant) is compared by batch row and forward and
    the differing ones printed; greedy tokens must be equal, except in a
    row at or after a forward in which one of its codes differed; logits
    within 1e-5 of their largest magnitude in the rows with no differing
    code so far.  (With the LM's reductions and library functions through
    fp64, ``core.exact``, the devices agree bit for bit but for a rare
    fp64 double rounding on a rounding tie, which the rule exempts.)"""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.fxp import QTensor
    from repro_torch.core.policy import get_policy
    from repro_torch.core.quantizer import quantize_params
    from repro_torch.launch.serve import pad_caches, sample
    from repro_torch.models import transformer
    from repro_torch.tree import leaves_with_path, tree_map

    cfg = get_arch(LM_ARCH).replace(n_layers=LM_PARITY_LAYERS)
    pol = get_policy("w8a8kv8")
    fp = transformer.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    cpu_params = quantize_params(fp, pol)
    card_ptq = quantize_params(tree_map(lambda t: t.to(dev), fp), pol)
    is_q = lambda x: isinstance(x, QTensor)  # noqa: E731
    for (p, a), (_, b) in zip(leaves_with_path(cpu_params, is_q),
                              leaves_with_path(card_ptq, is_q), strict=True):
        pairs = ((a.qvalue, b.qvalue), (a.scale, b.scale)) if is_q(a) \
            else ((a, b),)
        for x, y in pairs:
            if not bits_equal(torch, x, y.cpu()):
                raise AssertionError(f"PTQ on the card != CPU at {p}")
    card_params = tree_map(lambda t: t.to(dev), cpu_params, is_leaf=is_q)
    per_forward = LM_PARITY_LAYERS * 7 + 1
    prompts = torch.randint(0, cfg.vocab, (4, 32),
                            generator=torch.Generator().manual_seed(1)
                            ).to(torch.int32)
    runs = []
    for where, params in ((dev, card_params), (torch.device("cpu"),
                                               cpu_params)):
        logits_all, toks, codes, launches = [], [], [], []
        with torch.no_grad():
            kernels.reset_launch_counts()
            (logits, caches), c = _recorded_codes(
                torch, lambda: transformer.prefill(
                    params, prompts.to(where), cfg, pol, pol.kv_bits))
            launches.append(kernels.launch_counts()["qmac_i8_deq"])
            caches = pad_caches(caches, LM_PARITY_STEPS)
            codes.append(c.cpu())
            logits_all.append(logits.cpu())
            for i in range(LM_PARITY_STEPS):
                tok = sample(logits, 0.0)
                toks.append(tok.cpu())
                kernels.reset_launch_counts()
                (logits, caches), c = _recorded_codes(
                    torch, lambda tok=tok, caches=caches, i=i:
                    transformer.decode_step(params, tok, caches, 32 + i, cfg,
                                            pol, pol.kv_bits))
                launches.append(kernels.launch_counts()["qmac_i8_deq"])
                codes.append(c.cpu())
                logits_all.append(logits.cpu())
            toks.append(sample(logits, 0.0).cpu())
        runs.append((torch.stack(logits_all), torch.cat(toks, 1), codes,
                     launches))
    (ld, td, cd, nd), (lc, tc, cc, _) = runs
    if nd != [per_forward] * (LM_PARITY_STEPS + 1):
        raise AssertionError(f"card forwards launched {nd} fused products, "
                             f"not {per_forward} each")
    # differ[f, b]: forward f of row b holds a code that differs
    differ = torch.stack([(a != b).sum(-1) for a, b in zip(cd, cc,
                                                          strict=True)])
    flipped = torch.cumsum(differ, 0) > 0          # at or before forward f
    scale = lc.abs().max().item()
    err = (ld - lc).abs().amax(-1)                 # [forwards, B]
    worst_ok = (err * ~flipped).max().item()
    # token f is chosen from forward f's logits
    tok_bad = (td != tc).T & ~flipped
    print(f"{LM_ARCH} at {LM_PARITY_LAYERS} layers, w8a8kv8, card vs CPU: "
          f"greedy tokens equal in {int((td == tc).sum())} of {td.numel()}; "
          f"int8 codes that differ by forward and row "
          f"{differ.T.tolist()} (of {cd[0].shape[1]} in the prefill, "
          f"{cd[1].shape[1]} a decode step, a row); largest logit abs err "
          f"{err.max().item():.3g} ({worst_ok:.3g} in rows with no code "
          f"differing yet; logits' largest magnitude {scale:.3g}); "
          f"{per_forward} fused products a forward")
    if bool(tok_bad.any()):
        raise AssertionError("card and CPU chose different tokens in a row "
                             "with no differing int8 code")
    if worst_ok > 1e-5 * scale:
        raise AssertionError(f"card and CPU logits {worst_ok} apart in rows "
                             "with no differing int8 code")


# ---------------------------------------------------------------------------
# phase 14: serving whisper-large-v3 (and its products in phases 3-4)
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-large-v3"
WHISPER_LAYERS = 32              # each of the encoder and the decoder
WHISPER_VOCAB = 51866
# whisper's products (K, N): q, k, v, o of both attentions [1280, 1280],
# w_in [1280, 5120], w_out [5120, 1280]; the head [1280, 51968] (the
# vocab padded by configs.base.pad_vocab) at M = batch
WHISPER_KN = ((1280, 1280), (1280, 5120), (5120, 1280))
WHISPER_HEAD_KN = (1280, 51968)
WHISPER_ROWS = (4, 128, 3584)
WHISPER_HEAD_ROWS = (4, 8)
# whisper's served depth in phase 14: 16 + 16 of its 32 + 32 layers at
# full width, since phase 17 (training) needs the time within the
# script's 1,200 s limit; phase 4 still sums the full depth's products.
# A prefill launches 16 fused products a layer pair (the encoder's q, k,
# v, o, w_in, w_out; the decoder's self q, k, v, o, cross q, k, v, o,
# w_in, w_out) and the head's, 257; a decode step 8 a decoder layer
# (self 4, cross q and o, w_in, w_out) and the head's, 129
WHISPER_SERVED = 16
# (policy, batch, prompt = frames, gen): the reference CLI's defaults,
# whisper's whole 448-token decoder context, and the w4 weights
WHISPER_RUNS = (("w8a8kv8", 4, 32, 16), ("w8a8kv8", 8, 448, 16),
                ("w4a8", 4, 32, 16))
WHISPER_PARITY_LAYERS = 2


def check_whisper_kernels(torch, dev, worst):
    """Phase 3, whisper's products: ``qmac_i8_deq`` at every block
    product (``WHISPER_KN``) at M = 4 (decode), 128 (a 4 x 32 prefill)
    and 3584 (an 8 x 448 prefill), and the head at M = 4 and 8, with w8
    and w4 codes, bitwise equal to the plain version."""
    cases = [(m, k, n) for k, n in WHISPER_KN for m in WHISPER_ROWS]
    cases += [(m,) + WHISPER_HEAD_KN for m in WHISPER_HEAD_ROWS]
    return _check_lm_products(torch, dev, worst, "whisper", cases, 23,
                              int32=False)


def time_whisper_kernels(torch, dev):
    """Phase 4, whisper's fused products summed over a decode step at
    batch 4 (M = 4: 32 x 8 products and the head) and an 8 x 448 prefill
    (M = 3584: 32 x 6 in the encoder, 32 x 10 in the decoder, the head at
    M = 8)."""
    L = WHISPER_LAYERS
    sq, up, down = WHISPER_KN
    return _time_lm_forwards(torch, dev, "whisper", 24, {
        "a whisper decode step (batch 4)": [
            (4,) + sq + (6 * L,), (4,) + up + (L,), (4,) + down + (L,),
            (4,) + WHISPER_HEAD_KN + (1,)],
        "a whisper 8 x 448 prefill": [
            (3584,) + sq + (12 * L,), (3584,) + up + (2 * L,),
            (3584,) + down + (2 * L,), (8,) + WHISPER_HEAD_KN + (1,)]})


def _whisper_inputs(torch, cfg, g, shape):
    """Stub frames [batch, length, d_model] then prompts drawn from
    ``g``."""
    return {"frames": torch.randn(shape + (cfg.d_model,), generator=g),
            "tokens": torch.randint(0, cfg.vocab, shape, generator=g).to(
                torch.int32)}


def whisper_serving(torch, dev, card):
    """Phase 14: whisper-large-v3 at its published widths (d_model 1280,
    20 heads, d_ff 5120, vocab 51,866) and ``WHISPER_SERVED`` of each of its
    32 + 32 layers, drawn once, for each of ``WHISPER_RUNS``: exactly 257
    + 129 x (gen - 1)
    ``qmac_i8_deq`` a call, no ``qmac_i8``, every id in [0, 51866); then
    a profile of a decode step (batch 4, a 48-slot self cache, the cross
    cache padded to 48) and an 8 x 448 prefill.  Returns the path's
    launches."""
    prefill, decode = 16 * WHISPER_SERVED + 1, 8 * WHISPER_SERVED + 1
    launches, _ = _lm_path(
        torch, dev, card, WHISPER_ARCH, WHISPER_RUNS,
        lambda gen: prefill + decode * (gen - 1),
        lambda cfg, g: (_whisper_inputs(torch, cfg, g, (4, 32)),
                        _whisper_inputs(torch, cfg, g, (8, 448))),
        decode, prefill, n_layers=WHISPER_SERVED)
    return launches


def _card_vs_cpu(torch, dev, what, cfg, model, fp, batch_in, prompt_len,
                 want, weight_ptq=True, steps=LM_PARITY_STEPS,
                 policy="w8a8kv8"):
    """``cfg``'s model at ``policy`` from the fp32 tree ``fp`` on the CPU:
    the same PTQ'd params on the card and on the CPU (the card's PTQ of
    the same fp32 params bitwise the CPU's; with ``weight_ptq`` False the
    fp32 params themselves, quantized by every product at each call) and
    the same inputs ``batch_in`` (prompts, or whisper's frames and
    prompts): a prefill and ``steps`` greedy decode steps on each device,
    each on its own tokens, ``want`` Q-MAC launches by forward on the
    card (``_want``).  Every int8 activation code (row inputs, the MoE
    expert buffers, KV payloads, the activations' requants), every
    logit, every greedy token and, for an MoE config, every expert each
    layer chose must be equal; what differs is printed before the check
    fails."""
    from repro_torch import kernels
    from repro_torch.core.fxp import QTensor
    from repro_torch.core.policy import get_policy
    from repro_torch.core.quantizer import quantize_params
    from repro_torch.launch.serve import pad_caches, sample
    from repro_torch.tree import leaves_with_path, tree_map

    pol = get_policy(policy)
    is_q = lambda x: isinstance(x, QTensor)  # noqa: E731
    cpu_params = fp
    if weight_ptq:
        cpu_params = quantize_params(fp, pol)
        card_ptq = quantize_params(tree_map(lambda t: t.to(dev), fp), pol)
        for (p, a), (_, b) in zip(leaves_with_path(cpu_params, is_q),
                                  leaves_with_path(card_ptq, is_q),
                                  strict=True):
            pairs = ((a.qvalue, b.qvalue), (a.scale, b.scale)) if is_q(a) \
                else ((a, b),)
            for x, y in pairs:
                if not bits_equal(torch, x, y.cpu()):
                    raise AssertionError(f"PTQ on the card != CPU at {p}")
        del card_ptq
    card_params = tree_map(lambda t: t.to(dev), cpu_params, is_leaf=is_q)
    want = [_want(w) for w in want]
    runs = []
    for where, params in ((dev, card_params), (torch.device("cpu"),
                                               cpu_params)):
        logits_all, toks, codes, launches, chosen = [], [], [], [], []

        def forward(fn):
            kernels.reset_launch_counts()
            experts = []
            out, c = _recorded_codes(torch, fn, experts)
            counts = kernels.launch_counts()
            launches.append({k: counts[k] for k in QMAC_WRAPPERS})
            codes.append(c.cpu())
            chosen.append(torch.cat(experts).cpu() if experts
                          else torch.zeros(0, dtype=torch.int32))
            return out

        inputs = _to(batch_in, where)
        with torch.no_grad():
            logits, caches = forward(lambda: model.prefill(
                params, inputs, cfg, pol, pol.kv_bits))
            caches = pad_caches(caches, steps)
            logits_all.append(logits.cpu())
            for i in range(steps):
                tok = sample(logits, 0.0)
                toks.append(tok.cpu())
                logits, caches = forward(
                    lambda tok=tok, caches=caches, i=i:
                    model.decode_step(params, tok, caches, prompt_len + i,
                                      cfg, pol, pol.kv_bits))
                logits_all.append(logits.cpu())
            toks.append(sample(logits, 0.0).cpu())
        runs.append((torch.stack(logits_all), torch.cat(toks, 1), codes,
                     launches, chosen))
    (ld, td, cd, nd, ed), (lc, tc, cc, _, ec) = runs
    differ = torch.stack([(a != b).sum(-1) for a, b in zip(cd, cc,
                                                          strict=True)])
    logits_apart = int((ld.view(torch.int32) != lc.view(torch.int32)).sum())
    err = (ld - lc).abs().max().item()
    same = int((td == tc).sum())
    experts_apart = sum(int((a != b).sum()) for a, b in zip(ed, ec,
                                                           strict=True))
    moe = (f"; experts chosen apart {experts_apart} of "
           f"{sum(e.numel() for e in ed)}" if cfg.is_moe else "")
    counted = (f"each of {len(nd)} forwards {nd[0]}"
               if all(c == nd[0] for c in nd) else f"by forward {nd}")
    print(f"{what}, {policy}, card vs CPU: greedy tokens equal in {same} "
          f"of {td.numel()}; int8 codes that differ by forward and row "
          f"{differ.T.tolist()} (of {cd[0].shape[1]} in the prefill, "
          f"{cd[1].shape[1]} a decode step, a row); logits apart "
          f"{logits_apart} of {ld.numel()}, largest abs err {err:.3g}"
          f"{moe}; Q-MAC launches {counted}")
    if nd != want:
        raise AssertionError(f"card forwards launched {nd}, not {want}")
    if cfg.is_moe and not all(e.numel() for e in ed):
        raise AssertionError(f"{what}: no experts recorded")
    if int(differ.sum()) or logits_apart or same != td.numel() \
            or experts_apart:
        raise AssertionError(f"{what}: card and CPU differ (codes, logits, "
                             "tokens or experts)")


def whisper_card_vs_cpu(torch, dev):
    """Phase 14: whisper at full width and ``WHISPER_PARITY_LAYERS`` +
    ``WHISPER_PARITY_LAYERS`` layers (``_card_vs_cpu``): a 4 x 32 prefill
    of stub frames and prompts and ``LM_PARITY_STEPS`` greedy steps, 33
    and 17 fused products a forward on the card, and all 36 tokens."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import encdec

    n = WHISPER_PARITY_LAYERS
    cfg = get_arch(WHISPER_ARCH).replace(n_layers=n)
    fp = encdec.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _whisper_inputs(torch, cfg, torch.Generator().manual_seed(1),
                            (4, 32))
    _card_vs_cpu(torch, dev, f"{WHISPER_ARCH} at {n} + {n} layers", cfg,
                 encdec, fp, batch, 32,
                 [16 * n + 1] + [8 * n + 1] * LM_PARITY_STEPS)


# ---------------------------------------------------------------------------
# phase 15: serving mamba2-2.7b (ssm) and recurrentgemma-9b (hybrid), and
# their products in phases 3-4
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "recurrentgemma-9b"
# mamba2's products (K, N): in_proj [2560, 10576] (z, xBC, dt: 2 x 5120 +
# 2 x 128 + 80), out_proj [5120, 2560]; the head [2560, 50304] (vocab
# 50,280 padded by configs.base.pad_vocab) at M = batch
MAMBA_KN = ((2560, 10576), (5120, 2560))
MAMBA_HEAD_KN = (2560, 50304)
# recurrentgemma's: lin_x, lin_y, w_r, w_i, lin_out, wq and wo [4096,
# 4096], wk and wv [4096, 256] (MQA, head_dim 256), gate and up [4096,
# 12288], down [12288, 4096]; the head [4096, 256000]
RG_KN = ((4096, 4096), (4096, 256), (4096, 12288), (12288, 4096))
RG_HEAD_KN = (4096, 256000)
SSM_ROWS = (4, 128, 4096)
SSM_HEAD_ROWS = (4, 8)


def lm_products(cfg) -> int:
    """Fused products a forward of an ssm or hybrid config launches (a
    prefill or a decode step alike): mamba 2 a layer (in_proj,
    out_proj), recurrentgemma 8 an R layer (lin_y, lin_x, w_r, w_i,
    lin_out, gate, up, down) and 7 an A layer (q, k, v, o, gate, up,
    down); the head once."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1
    pat = cfg.block_pattern
    n_r = sum(pat[i % len(pat)] == "R" for i in range(cfg.n_layers))
    return 8 * n_r + 7 * (cfg.n_layers - n_r) + 1


MAMBA_PER_FORWARD = 2 * 64 + 1                  # 129
# mamba2's served depth in phase 15: 16 of its 64 layers at full width,
# since the script must end well within its limit
MAMBA_LAYERS = 16
RG_PER_FORWARD = 8 * 26 + 7 * 12 + 1            # 293: 26 R, 12 A layers
# recurrentgemma's served depth in phase 15: one (R, R, A) super-block and
# the R, R tail, 5 of its 38 layers, at full width.  Drawing all 38 (10.44
# B parameters on the host's generator) leaves the script too close to
# its 1,200 s limit
RG_LAYERS = 5
# recurrentgemma's card against CPU at full width: a 4 x 32 prefill and 2
# greedy steps (the CPU's plain product widens the head's [4096, 256000]
# codes to fp64, 8 GB, every forward)
RG_PARITY_STEPS = 2
# (policy, batch, prompt, gen): decode at batch 4 (mamba's prompt one SSD
# chunk, 128; recurrentgemma's 32), an 8 x 512 prefill, and the w4
# weights drawn from the same fp32 tree
MAMBA_RUNS = (("w8a8kv8", 4, 128, 16), ("w8a8kv8", 8, 512, 4),
              ("w4a8", 4, 128, 16))
RG_RUNS = (("w8a8kv8", 4, 32, 16), ("w8a8kv8", 8, 512, 4),
           ("w4a8", 4, 32, 16))
# card against CPU at full width: mamba's (and qwen3-moe's) first layers,
# recurrentgemma's first (R, R, A) super-block
SSM_PARITY_LAYERS = 2


def check_ssm_hybrid_kernels(torch, dev, worst):
    """Phase 3, mamba2's and recurrentgemma's products: ``qmac_i8_deq``
    at every block product at M = 4 (decode), 128 (a 4 x 32 or one-chunk
    prefill) and 4096 (an 8 x 512 prefill), and each head at M = 4 and
    8, with w8 and w4 codes, bitwise equal to the plain version."""
    for what, kn, head, seed in (("mamba2", MAMBA_KN, MAMBA_HEAD_KN, 27),
                                 ("recurrentgemma", RG_KN, RG_HEAD_KN, 28)):
        cases = [(m, k, n) for k, n in kn for m in SSM_ROWS]
        cases += [(m,) + head for m in SSM_HEAD_ROWS]
        worst = _check_lm_products(torch, dev, worst, what, cases, seed,
                                   int32=False)
    return worst


def time_ssm_hybrid_kernels(torch, dev):
    """Phase 4, the fused products summed over a decode step at batch 4
    (M = 4) and an 8 x 512 prefill (M = 4096, the head at M = 8): mamba2's
    64 x 2 and the head, recurrentgemma's 26 R layers x 8 and 12 A layers
    x 7 and the head."""
    (m_in, m_out), L = MAMBA_KN, 64

    def mamba(m, hm):
        return [(m,) + m_in + (L,), (m,) + m_out + (L,),
                (hm,) + MAMBA_HEAD_KN + (1,)]

    (sq, kv, up, down), n_r, n_a = RG_KN, 26, 12

    def rg(m, hm):
        return [(m,) + sq + (5 * n_r + 2 * n_a,), (m,) + kv + (2 * n_a,),
                (m,) + up + (2 * (n_r + n_a),), (m,) + down + (n_r + n_a,),
                (hm,) + RG_HEAD_KN + (1,)]

    return (_time_lm_forwards(torch, dev, "mamba2", 25, {
        "a mamba2 decode step (batch 4)": mamba(4, 4),
        "a mamba2 8 x 512 prefill": mamba(4096, 8)})
        + _time_lm_forwards(torch, dev, "recurrentgemma", 26, {
            "a recurrentgemma decode step (batch 4)": rg(4, 4),
            "a recurrentgemma 8 x 512 prefill": rg(4096, 8)}))


def _first_block(torch, cfg, fp):
    """``cfg`` and its fp32 tree ``fp`` cut to mamba's (or an MoE
    model's) first ``SSM_PARITY_LAYERS`` layers or recurrentgemma's first
    super-block (no tail), copied to the CPU."""
    from repro_torch.tree import tree_map

    if cfg.family == "hybrid":
        n, stacked, layers = 1, "supers", len(cfg.block_pattern)
    else:
        n, stacked, layers = SSM_PARITY_LAYERS, "blocks", SSM_PARITY_LAYERS
    cut = {k: tree_map(lambda t: (t[:n] if k == stacked else t).cpu(), v)
           for k, v in fp.items() if k != "tail"}
    return cfg.replace(n_layers=layers), cut


def ssm_hybrid_serving(torch, dev, card):
    """Phase 15: mamba2-2.7b (64 layers, d_model 2560, d_inner 5120, 80
    SSD heads of 64, state 128, vocab 50,280) and recurrentgemma-9b (12
    (R, R, A) super-blocks and an R, R tail, d_model 4096, LRU width
    4096, 16 heads over 1 KV head of 256, window 2048, d_ff 12288, vocab
    256,000) at their published widths (mamba2 at ``MAMBA_LAYERS`` of its
    64 layers, recurrentgemma at ``RG_LAYERS`` of its 38), each fp32
    tree drawn once on the card: for each of ``MAMBA_RUNS`` /
    ``RG_RUNS`` exactly ``lm_products`` (65 / 63)
    ``qmac_i8_deq`` a forward, no ``qmac_i8``; a profile of a decode step
    and an 8 x 512 prefill; the host's peak RSS and the card's peak
    allocation; then card against CPU at full width, mamba at 2 layers
    (a 4 x 128 prompt) and recurrentgemma's first super-block (4 x 32),
    and recurrentgemma reduced (window 8, a 4 x 32 prompt: the window's
    mask on a padded, non-ring cache): 0 codes, 0 logits apart, every
    token equal.  Returns each arch's launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import recurrent
    from repro_torch.models.registry import model_for

    launches = {}
    for arch, runs, full, prompt, depth, steps in (
            (SSM_ARCH, MAMBA_RUNS, MAMBA_PER_FORWARD, 128, MAMBA_LAYERS,
             LM_PARITY_STEPS),
            (HYBRID_ARCH, RG_RUNS, RG_PER_FORWARD, 32, RG_LAYERS,
             RG_PARITY_STEPS)):
        if lm_products(get_arch(arch)) != full:
            raise AssertionError(f"{arch}: {lm_products(get_arch(arch))} "
                                 f"products a forward, not {full}")
        per = lm_products(get_arch(arch).replace(
            n_layers=depth or get_arch(arch).n_layers))
        torch.cuda.reset_peak_memory_stats()
        launches[arch], fp = _lm_path(
            torch, dev, card, arch, runs, lambda gen, per=per: per * gen,
            lambda cfg, g, prompt=prompt: _token_prompts(
                torch, cfg, g, (4, prompt), (8, 512)), per, per,
            n_layers=depth)
        t0 = time.perf_counter()
        cfg, cut = _first_block(torch, get_arch(arch), fp)
        del fp
        print(f"{arch}: host peak RSS {_host_peak_gib():.1f} GiB, card peak "
              f"allocated {torch.cuda.max_memory_allocated() / 2**30:.1f} "
              "GiB")
        torch.cuda.empty_cache()
        prompts = torch.randint(0, cfg.vocab, (4, prompt),
                                generator=torch.Generator().manual_seed(1)
                                ).to(torch.int32)
        _card_vs_cpu(torch, dev, f"{arch} at {cfg.n_layers} layers", cfg,
                     model_for(cfg), cut, prompts, prompt,
                     [lm_products(cfg)] * (1 + steps), steps=steps)
        del cut
        print(f"{arch}: cut and card vs CPU {time.perf_counter() - t0:.1f} s")
    cfg = get_arch(HYBRID_ARCH).reduced()
    fp = recurrent.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 32),
                            generator=torch.Generator().manual_seed(1)
                            ).to(torch.int32)
    _card_vs_cpu(torch, dev, f"{cfg.name} (window {cfg.local_window})", cfg,
                 recurrent, fp, prompts, 32,
                 [lm_products(cfg)] * (1 + LM_PARITY_STEPS))
    return launches


# ---------------------------------------------------------------------------
# phase 16: serving qwen3-moe-30b-a3b (the MoE family) and mixtral-8x22b
# reduced, and Q-MAC's batched product in phases 3-4
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MIXTRAL_ARCH = "mixtral-8x22b"
# depth cut from 48 to 4 layers: the reference serves MoE with its fp32
# tree (PTQ'd MoE raises there), 122 GB at 48 layers; at 4 it is 3.11 B
# parameters, 12.4 GB
MOE_LAYERS = 4
MOE_EXPERTS = 128
# an expert's products (K, N): gate and up [2048, 768], down [768, 2048]
MOE_KN = ((2048, 768), (768, 2048))
# expert capacity C = max(ceil(T * 8 / 128 * 1.25), 4) at a decode step of
# batch 4 (T = 4), a 4 x 32 prefill (128) and an 8 x 512 prefill (4096)
MOE_ROWS = (4, 10, 320)
# attention's int32 products (K, N): wq [2048, 4096], wk and wv [2048,
# 512], wo [4096, 2048]; the untied head [2048, 151936] at M = batch
MOE_ATTN_KN = ((2048, 4096), (2048, 512), (4096, 2048))
MOE_HEAD_KN = (2048, 151936)
MOE_RUNS = (("w8a8kv8", 4, 32, 16), ("w8a8kv8", 8, 512, 4),
            ("w4a8", 4, 32, 16))
# card against CPU: a 4 x 32 prefill and 2 greedy steps (the CPU
# quantizes 1.2 B expert weights a forward at 2 layers, 8-12 s)
MOE_PARITY_STEPS = 2


def moe_per_forward(n_layers):
    """Q-MAC launches a forward of an MoE model with fp weights under an
    int8 policy (``weight_ptq=False``): 3 batched products (the experts;
    the router is an fp64 einsum) and 4 int32 ones (attention) a layer,
    and the head's."""
    return {"qmac_i8_deq": 0, "qmac_i8": 4 * n_layers + 1,
            "qmac_i8_deq_bmm": 3 * n_layers}


MOE_PER_FORWARD = moe_per_forward(MOE_LAYERS)


def _bmm_case(torch, g, dev, e, c, k, n, qmax=127):
    qx = _i8(torch, g, dev, (e, c, k))
    qw = torch.randint(-qmax, qmax + 1, (e, k, n), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    sx = torch.rand((e, c, 1), generator=g, device=dev) * 0.02 + 1e-4
    sw = torch.rand((e, 1, n), generator=g, device=dev) * 0.02 + 1e-4
    return qx, sx, qw, sw


def check_moe_kernels(torch, dev, worst):
    """Phase 3, MoE's products: ``qmac_i8_deq_bmm`` at qwen3-moe's expert
    shapes (E = 128; gate/up and down at C = 4, 10 and 320), at ragged
    C, K and N, over a split K's slice edges (two experts, K = 4096) and
    at one expert against ``qmac_i8_deq``, with w8 and w4 codes, bitwise
    equal to the plain version; then ``qmac_i8`` (and the fused product)
    at qwen3-moe's attention products and head."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(29)
    cases = [(MOE_EXPERTS, c, k, n) for k, n in MOE_KN for c in MOE_ROWS]
    cases += [(3, 37, 2049, 40), (5, 33, 300, 17), (2, 5, 4096, 24),
              (2, 5, 4100, 33), (1, 7, 2048, 768)]
    if qmac_ops.split_plan(5, 4096, 24, 2).splits < 2:
        raise AssertionError("the split edge case does not split K")
    for e, c, k, n in cases:
        for qmax in (127, 7):
            qx, sx, qw, sw = _bmm_case(torch, g, dev, e, c, k, n, qmax)
            got = qmac_ops.qmac_i8_deq_bmm(qx, sx, qw, sw)
            want = qmac_ops.qmac_i8_deq_bmm_plain(qx, sx, qw, sw)
            err = (got - want).abs().max().item()
            worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8_deq_bmm != plain at E,C,K,N="
                                     f"{e},{c},{k},{n} qmax {qmax} (max abs "
                                     f"err {err})")
            if e == 1 and not bits_equal(torch, got[0], qmac_ops.qmac_i8_deq(
                    qx[0], sx[0], qw[0], sw[0])):
                raise AssertionError("qmac_i8_deq_bmm at one expert != "
                                     "qmac_i8_deq")
    torch.cuda.synchronize()
    print(f"Q-MAC batched over experts: {len(cases) * 2} cases (w8 and w4 "
          "codes), fused fp32 bitwise equal to the plain version "
          f"({time.perf_counter() - t0:.1f} s)")
    cases = [(m, k, n) for k, n in MOE_ATTN_KN for m in LM_ROWS]
    cases += [(m,) + MOE_HEAD_KN for m in LM_HEAD_ROWS]
    return _check_lm_products(torch, dev, worst, "qwen3-moe attention",
                              cases, 30)


def _loop_ms(torch, fn, reps=5):
    """Median device time of ``fn()`` (a host loop of many launches) in
    ms, each call between its own CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _time_bmm(torch, g, dev, e, c, k, n):
    """The batched fused product at one expert shape: the kernel, its
    plain version, its bound, and the yardstick of ``torch._int_mm`` and
    the two scale multiplies once an expert (``e`` calls, timed as one
    loop; rows padded with zeros to 32 where C <= 16, which ``_int_mm``
    refuses)."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    qx, sx, qw, sw = _bmm_case(torch, g, dev, e, c, k, n)
    p = qmac_ops.split_plan(c, k, n, e)
    b_ms, b_by = bound_ms(e * (c * k + k * n + 4 * c + 4 * n + 4 * c * n),
                          2.0 * e * c * n * k, 2.0 * e * c * n)
    pad = 32 if c <= 16 else c
    qx_y = torch.cat([qx, qx.new_zeros((e, pad - c, k))], 1) \
        if pad > c else qx
    sx_y = torch.cat([sx, sx.new_zeros((e, pad - c, 1))], 1) \
        if pad > c else sx

    def per_expert():
        for i in range(e):
            (torch._int_mm(qx_y[i], qw[i]).to(torch.float32) * sx_y[i]) \
                * sw[i]

    try:
        lib = _loop_ms(torch, per_expert)
    except RuntimeError as err:
        print(f"torch._int_mm refused this shape: "
              f"{str(err).splitlines()[0]}")
        lib = None
    return dict(
        shape=f"E={e} C={c} K={k} N={n} (batched)",
        plan=f"{p.splits} slices of {p.slice} B, {p.blocks} blocks",
        ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq_bmm(qx, sx, qw,
                                                             sw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq_bmm_plain(
            qx, sx, qw, sw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        library=(f"{e} x (torch._int_mm + 2 scale multiplies), one host "
                 "loop, not a single call"
                 + (f", rows padded {c} -> 32" if pad > c else "")))


def time_moe_kernels(torch, dev):
    """Phase 4, the batched fused product at qwen3-moe's expert shapes at
    C = 4 (a decode step at batch 4) and C = 320 (an 8 x 512 prefill),
    summed over a forward's 3 x 4 batched products."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(31)
    rows = []
    for c, what in ((4, "a decode step (batch 4)"),
                    (320, "an 8 x 512 prefill")):
        tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"),
                            0.0)
        for (k, n), count in zip(MOE_KN, (2, 1)):
            r = _time_bmm(torch, g, dev, MOE_EXPERTS, c, k, n)
            rows.append(r)
            for key in tot:
                tot[key] += count * MOE_LAYERS * (r[key] or 0.0)
        print(f"qmac_i8_deq_bmm over qwen3-moe's {what} at {MOE_LAYERS} "
              f"layers, {3 * MOE_LAYERS} products: kernel {tot['ms']:.4f} "
              f"ms, plain {tot['plain_ms']:.4f} ms, per-expert "
              f"torch._int_mm yardstick {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms")
    print(f"qwen3-moe's expert products timed in "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


def _moe_drops(torch, cfg, model, params, prompts):
    """Assignments each MoE layer dropped over capacity in one w8a8kv8
    prefill of ``prompts``."""
    from repro_torch.core.policy import get_policy
    from repro_torch.nn import moe

    drops = []
    dispatch = moe._dispatch_indices

    def count(idx, n_experts, capacity):
        pos, keep = dispatch(idx, n_experts, capacity)
        drops.append((~keep).sum())
        return pos, keep

    moe._dispatch_indices = count
    try:
        with torch.no_grad():
            model.prefill(params, prompts, cfg, get_policy("w8a8kv8"), 8)
    finally:
        moe._dispatch_indices = dispatch
    b, s = prompts.shape
    print(f"{cfg.name} prefill {b} x {s}: assignments dropped over "
          f"capacity by layer {[int(d) for d in drops]} of "
          f"{b * s * cfg.top_k} each")


def moe_serving(torch, dev, card):
    """Phase 16: qwen3-moe-30b-a3b at its published widths (d_model 2048,
    32 heads over 4 KV heads of 128, 128 experts, top 8, d_ff 768, vocab
    151,936) and ``MOE_LAYERS`` of its 48 layers, the fp32 tree drawn
    once on the card and served as the reference serves MoE, with
    ``weight_ptq=False``, for each of ``MOE_RUNS``: exactly 3 batched
    and 4 ``qmac_i8`` launches a layer and the head's each forward; a
    profile of a decode step and an 8 x 512 prefill; the assignments
    dropped over capacity at the 8 x 512 prefill; the host's peak RSS and
    the card's peak allocation; then card against CPU on the first
    ``SSM_PARITY_LAYERS`` (2) layers cut from the same tree (a 4 x 32
    prefill, ``MOE_PARITY_STEPS`` greedy steps) and on reduced mixtral-8x22b
    (window 8, a ring cache; w8a8kv8 and w4a8): 0 codes, 0 logits, every
    token and every expert chosen equal.  Returns the runs' launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer

    torch.cuda.reset_peak_memory_stats()
    launches, fp = _lm_path(
        torch, dev, card, MOE_ARCH, MOE_RUNS,
        lambda gen: {k: v * gen for k, v in MOE_PER_FORWARD.items()},
        lambda cfg, g: _token_prompts(torch, cfg, g, (4, 32), (8, 512)),
        MOE_PER_FORWARD, MOE_PER_FORWARD, weight_ptq=False,
        n_layers=MOE_LAYERS)
    cfg = get_arch(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    _, big = _token_prompts(torch, cfg, torch.Generator().manual_seed(1),
                            (4, 32), (8, 512))
    _moe_drops(torch, cfg, transformer, fp, big.to(dev))
    print(f"{MOE_ARCH}: host peak RSS {_host_peak_gib():.1f} GiB, card peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    t0 = time.perf_counter()
    cfg, cut = _first_block(torch, cfg, fp)
    del fp
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (4, 32),
                            generator=torch.Generator().manual_seed(1)
                            ).to(torch.int32)
    _card_vs_cpu(torch, dev, f"{MOE_ARCH} at {cfg.n_layers} layers", cfg,
                 transformer, cut, prompts, 32,
                 [moe_per_forward(cfg.n_layers)] * (1 + MOE_PARITY_STEPS),
                 weight_ptq=False, steps=MOE_PARITY_STEPS)
    del cut
    print(f"{MOE_ARCH}: cut and card vs CPU {time.perf_counter() - t0:.1f} s")
    cfg = get_arch(MIXTRAL_ARCH).reduced()
    fp = transformer.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 32),
                            generator=torch.Generator().manual_seed(1)
                            ).to(torch.int32)
    for policy in ("w8a8kv8", "w4a8"):
        _card_vs_cpu(torch, dev, f"{cfg.name} (window {cfg.window})", cfg,
                     transformer, fp, prompts, 32,
                     [moe_per_forward(cfg.n_layers)] * (1 + LM_PARITY_STEPS),
                     weight_ptq=False, policy=policy)
    return launches


# ---------------------------------------------------------------------------
# phase 17: training TinyLlama-1.1B at its published widths through
# repro_torch.launch.train (and its products in phases 3-4), and one
# training step of every family card against CPU
# ---------------------------------------------------------------------------

# the reference CLI's defaults: 8 x 128 tokens a step, w8a8, AdamW with no
# weight decay, warmup-cosine over the run's steps
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_STEPS = 6
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
# a training forward's products at M = 1,024: the blocks' and the head's
# (the backward's straight-through products are fp32 matmuls, as in the
# reference, where XLA lowers them outside any Pallas kernel)
TRAIN_KN = LM_KN + (LM_HEAD_KN,)
# card against CPU: full width at 2 layers and batch 2 x 128, then every
# family's reduced config at batch 2 x 32
TRAIN_PARITY_LAYERS = 2
TRAIN_PARITY_BATCH = (2, 128)
TRAIN_REDUCED_BATCH = (2, 32)


# the loss's CE chunk (``models.common.chunked_ce``): a longer sequence
# that is a whole number of chunks takes the head a chunk at a time
CE_CHUNK = 1024


def _ce_chunks(seq):
    return seq // CE_CHUNK if seq > CE_CHUNK and seq % CE_CHUNK == 0 else 1


def train_products(cfg, seq=None, backward=True):
    """Q-MAC launches of one training step of ``cfg`` at sequence ``seq``
    (default ``TRAIN_SEQ``) under w8a8 with fp weights: its forward's
    (every product ``qmac_i8``: 7 a dense layer, 16 an enc-dec layer
    pair, the ssm and hybrid counts of ``lm_products``, the head once a
    CE chunk; the MoE experts' on the batched kernel,
    ``moe_per_forward``), then, with ``backward``, what the backward
    recomputes: under ``cfg.remat`` every rematerialised layer's
    products again (all the layers; the hybrid's super-blocks, not its
    tail), and the head again a CE chunk when the loss takes more than
    one (``chunked_ce`` rematerialises its chunks whatever ``cfg.remat``
    says).  The backward's own straight-through products are fp32
    matmuls, as in the reference."""
    if cfg.is_moe:
        per = moe_per_forward(cfg.n_layers)
        per["qmac_i8"] -= 1
    elif cfg.is_encdec:
        per = {"qmac_i8_deq": 0, "qmac_i8": 16 * cfg.n_layers,
               "qmac_i8_deq_bmm": 0}
    elif cfg.family in ("ssm", "hybrid"):
        per = {"qmac_i8_deq": 0, "qmac_i8": lm_products(cfg) - 1,
               "qmac_i8_deq_bmm": 0}
    else:
        per = {"qmac_i8_deq": 0, "qmac_i8": 7 * cfg.n_layers,
               "qmac_i8_deq_bmm": 0}
    chunks = _ce_chunks(TRAIN_SEQ if seq is None else seq)
    out = dict(per, qmac_i8=per["qmac_i8"] + chunks)
    if not backward:
        return out
    if cfg.remat:
        again = dict(per)
        if cfg.family == "hybrid":
            pat = cfg.block_pattern
            n_super = cfg.n_layers // len(pat)
            tail = cfg.n_layers - n_super * len(pat)
            again["qmac_i8"] -= sum(8 if pat[i] == "R" else 7
                                    for i in range(tail))
        out = {k: out[k] + again[k] for k in out}
    if chunks > 1:
        out["qmac_i8"] += chunks
    return out


# the products of TinyLlama's laid-out step on rank 0 of the (16, 16)
# mesh (phase 23), (K, N) a shard: wq's 2 heads of 64, wo's
# contraction over them, w_gate / w_up's 352 d_ff columns, w_down's
# contraction over them, the head's 2,000 vocabulary columns (wk and wv
# stay whole, at LM_KN's (2048, 256): 4 kv heads against 16 ranks)
LAID_OUT_KN = ((2048, 128), (128, 2048), (2048, 352), (352, 2048),
               (2048, 2000))


def check_lm_train_kernels(torch, dev, worst):
    """Phase 3, TinyLlama's training products: ``qmac_i8`` (and the
    fused product) at every (K, N) of ``TRAIN_KN`` and of the laid-out
    step's shards (``LAID_OUT_KN``) at M = 1,024, with w8 and w4 codes,
    bitwise equal to the plain version."""
    cases = [(TRAIN_M, k, n) for k, n in TRAIN_KN + LAID_OUT_KN]
    return _check_lm_products(torch, dev, worst, "TinyLlama training",
                              cases, 24)


# the rows a rank's serving products take on the (16, 16) mesh (phase
# 24): a decode step's 8 and a prefill_32k's 2 x 32,768, at the same
# shards as the laid-out step (LAID_OUT_KN)
SERVE_LAYOUT_ROWS = (8, 65536)


def check_serving_layout_kernels(torch, dev, worst):
    """Phase 3, the laid-out serving steps' products: ``qmac_i8_deq``
    (column-parallel) and ``qmac_i8`` (row-parallel) at every shard of
    ``LAID_OUT_KN`` at ``SERVE_LAYOUT_ROWS``, with w8 and w4 codes,
    bitwise equal to the plain version."""
    cases = [(m, k, n) for k, n in LAID_OUT_KN for m in SERVE_LAYOUT_ROWS]
    return _check_lm_products(torch, dev, worst,
                              "the laid-out serving step", cases, 31)


def time_lm_train_kernels(torch, dev):
    """Phase 4: ``qmac_i8`` at each of TinyLlama's training products at
    M = 1,024 beside its bound, its plain version and ``torch._int_mm``,
    and summed over a rematerialised step's 309 products (the forward's
    155, then the 154 of the 22 layers the backward recomputes; the
    head is not, at one CE chunk), then at each shard of the laid-out
    step (``LAID_OUT_KN``).  Returns the rows, [1024, 2048] x [2048,
    5632] first."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(25)
    per_step = {(2048, 5632): 88, (2048, 2048): 88, (2048, 256): 88,
                (5632, 2048): 44, LM_HEAD_KN: 1}
    rows = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for (k, n), count in per_step.items():
        r = _time_qmac(torch, g, dev, TRAIN_M, k, n)[0]
        rows.append(r)
        for key in tot:
            tot[key] += count * (r[key] or 0.0)
    print(f"qmac_i8 over a TinyLlama training step, "
          f"{sum(per_step.values())} products at M = {TRAIN_M}: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
          f"torch._int_mm {tot['library_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms; timed in "
          f"{time.perf_counter() - t0:.1f} s")
    # the laid-out step's shards on rank 0 of the (16, 16) mesh, each a
    # row of its own at M = 1,024 (phase 23 runs them at 65,536 rows)
    for k, n in LAID_OUT_KN:
        rows.append(_time_qmac(torch, g, dev, TRAIN_M, k, n)[0])
    return rows


def _profile_lm_step(torch, dev, params):
    """Where one full-width training step's time and memory go, on
    ``params`` with a fresh AdamW state and the run's first batch: the
    whole step, then its forward (the graph built), its forward and
    backward, and AdamW alone, each's peak allocation on the card beside
    what was held before it, then each under ``torch.profiler``
    (``_profiled``): wall, busy, idle, the port's launches and
    PyTorch's, Q-MAC's ms of busy; the backward's busy ms is the forward
    and backward's less the forward's."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   warmup_cosine)
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg, pol = get_arch(LM_ARCH), get_policy("w8a8")
    ocfg = AdamWConfig(weight_decay=0.0)
    sched = warmup_cosine(3e-4, 1, TRAIN_STEPS)
    step = make_train_step(cfg, None, pol, ocfg, sched)
    opt = adamw_init(params)
    batch = {k: v.to(dev) for k, v in batch_at(
        DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, 0), 0).items()}

    def leaves():
        return [p.detach().requires_grad_(True) for p in tree_leaves(params)]

    def loss_of(xs):
        return transformer.loss_fn(tree_unflatten(params, xs), batch, cfg,
                                   pol)

    def forward():
        with torch.enable_grad():
            loss_of(leaves())
        torch.cuda.synchronize()

    def forward_backward():
        with torch.enable_grad():
            xs = leaves()
            torch.autograd.grad(loss_of(xs), xs)
        torch.cuda.synchronize()

    with torch.enable_grad():
        xs = leaves()
        grads = tree_unflatten(params, list(torch.autograd.grad(loss_of(xs),
                                                                xs)))
    del xs

    def adamw():
        with torch.no_grad():
            adamw_update(grads, opt, params, sched, ocfg)
        torch.cuda.synchronize()

    def whole():
        step(params, opt, batch)
        torch.cuda.synchronize()

    busy = {}
    for what, fn in (("step", whole), ("forward", forward),
                     ("forward and backward", forward_backward),
                     ("AdamW", adamw)):
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        fn()
        counts = kernels.launch_counts()
        print(f"{LM_ARCH} training {what}: card peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"{held / 2**30:.2f} GiB held before it")
        want = _want(0) if what == "AdamW" else train_products(
            cfg, backward=what != "forward")
        if {k: counts[k] for k in QMAC_WRAPPERS} != want:
            raise AssertionError(f"training {what}: {counts} launches")
        wall, rows, launches, why = _profiled(torch, fn, 1)
        _print_profile(f"{LM_ARCH} w8a8 training {what}, {TRAIN_BATCH} x "
                       f"{TRAIN_SEQ}", wall, rows, launches, why,
                       top=12 if what == "step" else 6, per="call")
        port = sum(counts.values())
        qmac_ms = sum(r[0] for r in rows if "qmac" in r[2])
        busy[what] = sum(r[0] for r in rows)
        print(f"  the port's launches {port}, PyTorch's "
              f"{'not measured' if launches is None else launches - port}"
              f"; qmac_kernel {qmac_ms:.4f} ms of {busy[what]:.4f} ms busy "
              f"({qmac_ms / max(busy[what], 1e-9):.3f})")
    print(f"{LM_ARCH} training step, device busy by part: forward "
          f"{busy['forward']:.4f} ms, backward "
          f"{busy['forward and backward'] - busy['forward']:.4f} ms, AdamW "
          f"{busy['AdamW']:.4f} ms (the whole step {busy['step']:.4f} ms)")


def lm_training(torch, dev, card):
    """Phase 17: ``repro_torch.launch.train.train("tinyllama-1.1b",
    smoke=False)`` on the card, all 22 layers at the published widths
    (random weights from seed 0), ``TRAIN_STEPS`` steps at the reference
    CLI's defaults (8 x 128 tokens, w8a8, AdamW, warmup-cosine), through
    the host mesh (``train`` always builds it: one NCCL rank here), each
    step timed on the host clock between two waits for the card and its
    Q-MAC launches counted: exactly 309 ``qmac_i8`` (``train_products``)
    and no fused launch a step, every loss finite and the last at most
    the first + 1 (the reference's bar of not diverging,
    ``tests/test_arch_smoke.py``);
    tok/s after the warm-up step, from the mean and from the median
    step (one slow step moves the mean), the card's peak allocation,
    then a profile of one step (``_profile_lm_step``).  Returns the
    path's launches and the trained params (phase 19 starts from
    them)."""
    import math

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    make = ltrain.make_train_step

    def counted(*a, **kw):
        step = make(*a, **kw)

        def run(params, opt_state, batch):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = kernels.launch_counts()
            steps.append(({k: after[k] - before[k] for k in QMAC_WRAPPERS},
                          t0, dt))
            return out

        return run

    ltrain.make_train_step = counted
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        params, losses = ltrain.train(
            LM_ARCH, steps=TRAIN_STEPS, smoke=False, policy_name="w8a8",
            seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, log_every=1, device=dev)
    finally:
        ltrain.make_train_step = make
    launches = kernels.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    from repro_torch.configs.registry import get_arch
    want = train_products(get_arch(LM_ARCH))
    dts = [dt for _, _, dt in steps]
    tok_s = (len(dts) - 1) * TRAIN_M / sum(dts[1:])
    tok_s_median = TRAIN_M / statistics.median(dts[1:])
    backend = dist.get_backend(make_host_mesh(device=dev).get_group("data"))
    print(f"{LM_ARCH} trained at full width through the host mesh "
          f"({backend}, world size {dist.get_world_size()}), {TRAIN_STEPS} "
          f"steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} at w8a8 on {card}: losses "
          f"{losses}; step 0 loss {losses[0]:.4f} beside ln 32000 = "
          f"{math.log(32000):.4f}; {tok_s:.1f} tok/s after the warm-up "
          f"step from the mean step, {tok_s_median:.1f} tok/s from the "
          f"median step (step seconds {[round(d, 4) for d in dts]}); draw and "
          f"optimizer init {steps[0][1] - t0:.1f} s, the run {wall:.1f} s; "
          f"card peak allocated {peak:.1f} GiB, host peak RSS "
          f"{_host_peak_gib():.1f} GiB; Q-MAC launches a step "
          f"{[c for c, _, _ in steps]} (want {want})")
    if len(steps) != TRAIN_STEPS or any(c != want for c, _, _ in steps):
        raise AssertionError(f"training steps launched "
                             f"{[c for c, _, _ in steps]}, not {want} each")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses {losses}")
    if losses[-1] > losses[0] + 1.0:
        raise AssertionError(f"training diverged: {losses}")
    if backend != "nccl":
        raise AssertionError(f"training ran on a {backend} mesh, not nccl")
    t1 = time.perf_counter()
    _profile_lm_step(torch, dev, params)
    print(f"{LM_ARCH} training profiles {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    return launches, params


def _train_step_card_vs_cpu(torch, dev, what, cfg, fp, batch):
    """One ``make_train_step`` step at w8a8 on the card and on the CPU,
    from the fp32 tree ``fp`` (on the CPU), a fresh AdamW state and
    ``batch``, held to PERF.md's training contract: every int8 activation
    code of the forward equal (``_recorded_codes``), the loss at rtol
    1e-6, each gradient leaf (``adamw_update``'s input) within 1e-5 of
    its largest magnitude on the CPU, and AdamW on the card given the
    CPU's gradient within atol 1e-5 + rtol 1e-4 of the CPU's step;
    exactly ``train_products(cfg)`` Q-MAC launches on the card."""
    from repro_torch import kernels
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import steps as lsteps
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   warmup_cosine)
    from repro_torch.tree import leaves_with_path, tree_map

    pol = get_policy("w8a8")
    ocfg = AdamWConfig(weight_decay=0.0)
    sched = warmup_cosine(3e-4, 1, TRAIN_STEPS)
    orig = lsteps.adamw_update
    runs = []
    for where in (dev, torch.device("cpu")):
        params = tree_map(lambda t: t.to(where), fp)
        opt = adamw_init(params)
        on = {k: v.to(where) for k, v in batch.items()}
        grads = []

        def record(g, *a, **kw):
            grads.append(g)
            return orig(g, *a, **kw)

        step = lsteps.make_train_step(cfg, None, pol, ocfg, sched)
        lsteps.adamw_update = record
        kernels.reset_launch_counts()
        try:
            (new_p, new_o, stats), codes = _recorded_codes(
                torch, lambda: step(params, opt, on), flat=True)
        finally:
            lsteps.adamw_update = orig
        counts = kernels.launch_counts()
        runs.append(dict(
            params=params, opt=opt, new_p=new_p, new_o=new_o,
            loss=float(stats["loss"]), grads=grads[0], codes=codes.cpu(),
            launches={k: counts[k] for k in QMAC_WRAPPERS}))
    card, cpu = runs
    same_shape = card["codes"].shape == cpu["codes"].shape
    n_diff = int((card["codes"] != cpu["codes"]).sum()) if same_shape \
        else -1
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_worst = 0.0
    for (_, a), (_, b) in zip(leaves_with_path(card["grads"]),
                              leaves_with_path(cpu["grads"]), strict=True):
        top = float(b.abs().max())
        err = float((a.cpu() - b).abs().max())
        grad_worst = max(grad_worst, err / top if top else err)
    with torch.no_grad():
        new_p, new_o, _ = adamw_update(
            tree_map(lambda t: t.to(dev), cpu["grads"]), card["opt"],
            card["params"], sched, ocfg)
    adam_worst = 0.0
    for got, want in ((new_p, cpu["new_p"]), (new_o, cpu["new_o"])):
        for (_, a), (_, b) in zip(leaves_with_path(got),
                                  leaves_with_path(want), strict=True):
            ratio = (a.cpu().double() - b.double()).abs() / (
                1e-5 + 1e-4 * b.double().abs())
            adam_worst = max(adam_worst, float(ratio.max()))
    want = train_products(cfg)
    print(f"{what}, w8a8 training step, card vs CPU: {n_diff} of "
          f"{cpu['codes'].numel()} int8 codes differ; loss {card['loss']:.7f}"
          f" / {cpu['loss']:.7f} (rel {loss_rel:.2e}); gradient leaves at "
          f"most {grad_worst:.2e} of their largest magnitude apart; AdamW "
          f"given the CPU's gradient at {adam_worst:.3f} of atol 1e-5 + "
          f"rtol 1e-4; Q-MAC launches {card['launches']} (want {want})")
    if card["launches"] != want:
        raise AssertionError(f"{what}: Q-MAC launches {card['launches']}, "
                             f"not {want}")
    if n_diff != 0:
        raise AssertionError(f"{what}: {n_diff} int8 codes differ")
    if loss_rel > 1e-6 or grad_worst > 1e-5 or adam_worst > 1.0:
        raise AssertionError(f"{what}: card and CPU training steps apart")


def lm_train_card_vs_cpu(torch, dev):
    """Phase 17: ``_train_step_card_vs_cpu`` on TinyLlama at full width
    and ``TRAIN_PARITY_LAYERS`` layers (batch 2 x 128), then on every
    config of ``configs.registry`` reduced (batch 2 x 32; whisper's stub
    frames drawn too): the dense, MoE (``qmac_i8_deq_bmm`` on the
    experts), enc-dec, ssm and hybrid families."""
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.models.registry import model_for

    def case(what, cfg, shape):
        g = torch.Generator().manual_seed(1)
        b, s = shape
        base = torch.randint(0, cfg.vocab, (b, s + 1), generator=g).to(
            torch.int32)
        batch = {"tokens": base[:, :-1], "labels": base[:, 1:]}
        if cfg.is_encdec:
            batch["frames"] = torch.randn((b, s, cfg.d_model), generator=g)
        fp = model_for(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        _train_step_card_vs_cpu(torch, dev, what, cfg, fp, batch)

    t0 = time.perf_counter()
    cfg = get_arch(LM_ARCH).replace(n_layers=TRAIN_PARITY_LAYERS)
    case(f"{LM_ARCH} at {TRAIN_PARITY_LAYERS} layers", cfg,
         TRAIN_PARITY_BATCH)
    t1 = time.perf_counter()
    for arch in sorted(ARCHS):
        cfg = get_arch(arch).reduced()
        case(cfg.name, cfg, TRAIN_REDUCED_BATCH)
    print(f"training card vs CPU: full width {t1 - t0:.1f} s, the reduced "
          f"configs {time.perf_counter() - t1:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: the sharded actor-learner fleet on the card
# ---------------------------------------------------------------------------

# phase 9's widths (32 envs x 128 steps, hidden 64, fxp8) for a few
# iterations; the value runs at phase 11's defaults; the compressed mean
# on a 4 M-element fp32 gradient
FLEET_PPO_ITERS = 4
FLEET_VALUE_ITERS = 6
FLEET_COMP_NUMEL = 4 * 2 ** 20


def _trees_bitwise(torch, a, b) -> bool:
    """``a`` and ``b`` bitwise equal, each leaf compared on ``a``'s
    device."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        bits_equal(torch, x, y.to(x.device)) for x, y in zip(la, lb))


def _plain_collect_trainer(torch, kernels, base):
    """``base`` (phase 9's counting trainer) whose rollout is the
    one-device ``collect``, not the mesh's sharded one."""
    from repro_torch.rl.actor_learner import collect
    from repro_torch.rl.rollout import episode_returns
    from repro_torch.rl.trainer.state import onpolicy_state

    class Plain(base):
        def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
            before = kernels.launch_counts()
            draws = self.draws(gen)
            with self.clock("rollout"):
                res = collect(packed, self.env, self.apply_fn,
                              self.a_policy, draws.noise, state.est,
                              state.obs, self.rollout_len, self.dist)
                torch.cuda.synchronize()
            with self.clock("learn"):
                params, opt = iteration.learn_phase(
                    state.params, state.opt, res, draws, stage_ctx, alive)
                torch.cuda.synchronize()
            ret, n_ep = episode_returns(res.traj)
            after = kernels.launch_counts()
            self.per_iter.append({k: after[k] - before[k] for k in after})
            return (onpolicy_state(params, opt, res.final_env,
                                   res.final_obs), ret, n_ep)

    return Plain


def sharded_fleet(torch, dev, card):
    """Phase 18: the sharded fleet through ``repro_torch.launch.mesh`` on
    a NCCL group of one rank on the card (one card: NCCL takes one rank
    a device, so two ranks cannot share it).  PPO on cartpole at phase
    9's widths through the mesh, params and history bitwise the plain
    collect's run and 4 x 129 ``qmac_i8`` launches an iteration; each
    value algorithm ``--sync lockstep`` bitwise its unsharded run
    (params, target, optimizer, replay, envs, history): DQN, QR-DQN on
    catch with the conv torso and PER, DDPG on pendulum; QR-DQN with PER
    ``--sync doublebuf`` twice, bitwise and finite;
    ``compressed_psum_mean`` on 4 M fp32 elements over NCCL bitwise the
    same call on a gloo group on the CPU, at 8 and 32 bits, both
    strategies, and timed.  Returns the path's launches by wrapper: the
    sum over the runs through the mesh alone, the counts zeroed just
    before each and read just after."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import describe, make_host_mesh
    from repro_torch.optim.compression import compressed_psum_mean
    from repro_torch.rl.trainer import ValueTrainer

    t0 = time.perf_counter()
    mesh = make_host_mesh(device=dev)
    backend = dist.get_backend(mesh.get_group("data"))
    print(f"sharded fleet: {describe(mesh)} on {card}, backend {backend}, "
          f"world size {dist.get_world_size()}")
    if backend != "nccl":
        raise AssertionError(f"the card's mesh runs on {backend}, not nccl")
    launches = dict.fromkeys(kernels.launch_counts(), 0)

    def on_path(run):
        """``run()``, one run through the mesh: the counts zeroed just
        before it, its launches added to the path's just after."""
        kernels.reset_launch_counts()
        out = run()
        for k, v in kernels.launch_counts().items():
            launches[k] += v
        return out

    counted = _counting_trainer(torch, kernels)
    plain = _plain_collect_trainer(torch, kernels, counted)
    want = 4 * (128 + 1)
    runs = []
    # in turns, plain, mesh, mesh, plain: the first run of a kind pays
    # for first launches (and the mesh's first for NCCL's communicator)
    for name, cls in (("plain", plain), ("mesh", counted),
                      ("mesh", counted), ("plain", plain)):
        tr = cls(iters=FLEET_PPO_ITERS, seed=0, device=dev, verbose=False)
        t1 = time.perf_counter()
        state, hist = on_path(tr.train) if name == "mesh" else tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        qmac = [c["qmac_i8"] for c in tr.per_iter]
        print(f"  ppo cartpole ({name} collect), {FLEET_PPO_ITERS} "
              f"iterations of 32 envs x 128 steps in {wall:.3f} s "
              f"(rollout {tr.clock.drain().get('rollout', 0.0):.3f} s): "
              f"history {hist}, qmac_i8 launches an iteration {qmac}")
        if qmac != [want] * FLEET_PPO_ITERS:
            raise AssertionError(f"ppo ({name}): qmac_i8 launches {qmac}, "
                                 f"not {want} in each iteration")
        runs.append((state.params, hist))
    same = all(h == runs[0][1] and _trees_bitwise(torch, p, runs[0][0])
               for p, h in runs[1:])
    print(f"  ppo through the mesh vs the plain collect: params and history "
          f"bitwise {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("ppo through the mesh differs from the plain "
                             "collect's run")

    def value(mesh_kind=None, **kw):
        tr = ValueTrainer(iters=FLEET_VALUE_ITERS, seed=0, device=dev,
                          verbose=False, mesh_kind=mesh_kind, **kw)
        t1 = time.perf_counter()
        state, hist = on_path(tr.train) if mesh_kind else tr.train()
        torch.cuda.synchronize()
        return state, hist, time.perf_counter() - t1

    # each algorithm's default run and its lockstep run through the mesh;
    # dqn in turns, as ppo
    for flags, kw, order in (
            ("--algo dqn", dict(algo="dqn"),
             ("unsharded", "mesh", "mesh", "unsharded")),
            ("--algo qrdqn --env catch --net conv --frame-stack 4 "
             "--replay per", dict(algo="qrdqn", env_name="catch", net="conv",
                                  frame_stack_k=4, replay="per"),
             ("unsharded", "mesh")),
            ("--algo ddpg --env pendulum",
             dict(algo="ddpg", env_name="pendulum"),
             ("unsharded", "mesh"))):
        pair = [value(**kw, **(FLEET if name == "mesh" else {}))
                for name in order]
        s0, h0, _ = pair[0]
        same = all(h == h0 and _trees_bitwise(torch, tuple(s), tuple(s0))
                   for s, h, _ in pair[1:])
        walls = ", ".join(f"{name} {w:.3f} s"
                          for name, (_, _, w) in zip(order, pair))
        print(f"  {flags} --mesh host --sync lockstep vs unsharded, "
              f"{FLEET_VALUE_ITERS} iterations ({walls}): params, target, "
              f"optimizer, replay, envs and history bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{flags} lockstep through the mesh "
                                 "differs from the unsharded run")
    qr = [value(algo="qrdqn", replay="per", mesh_kind="host",
                sync="doublebuf") for _ in range(2)]
    same = qr[0][1] == qr[1][1] and _trees_bitwise(
        torch, tuple(qr[0][0]), tuple(qr[1][0]))
    finite = all(torch.isfinite(x).all() for x in _leaves(qr[0][0].params))
    print(f"  qrdqn --replay per --mesh host --sync doublebuf, twice "
          f"({qr[0][2]:.3f} s, {qr[1][2]:.3f} s): bitwise "
          f"{'equal' if same else 'DIFFERENT'}, params "
          f"{'finite' if finite else 'NOT FINITE'}, history {qr[0][1]}")
    if not (same and finite and all(map(math.isfinite, qr[0][1]))):
        raise AssertionError("qrdqn doublebuf: two runs differ, or a value "
                             "is not finite")
    for name in ("qmac_i8", "qconv_i8_taps"):
        if not launches[name]:
            raise AssertionError(f"the sharded fleet launched no {name}")

    cpu_mesh = make_host_mesh(device="cpu")
    g = torch.Generator().manual_seed(18)
    grads = torch.randn(FLEET_COMP_NUMEL, generator=g)
    for bits in (8, 32):
        for strategy in ("gather", "psum"):
            want = compressed_psum_mean(grads, cpu_mesh, bits, None, strategy)
            x = grads.to(dev)
            got = compressed_psum_mean(x, mesh, bits, None, strategy)
            ms = device_ms(torch, lambda: compressed_psum_mean(
                x, mesh, bits, None, strategy))
            ok = all(bits_equal(torch, a.cpu(), b)
                     for a, b in zip(got, want, strict=True))
            print(f"  compressed_psum_mean bits {bits} {strategy} on "
                  f"{FLEET_COMP_NUMEL} fp32 elements: NCCL on the card "
                  f"{'bitwise' if ok else 'DIFFERENT from'} gloo on the CPU "
                  f"(mean and error), {ms:.4f} ms a call on {card}")
            if not ok:
                raise AssertionError(f"compressed_psum_mean bits {bits} "
                                     f"{strategy}: card differs from CPU")
    print(f"phase 18 launches: {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 19: the LM layout on the card: TinyLlama's training step through
# the host mesh against the unsharded step, and one qwen3-moe layer's
# dispatch over the mesh (moe_shard_map) at its published widths
# ---------------------------------------------------------------------------

LAYOUT_STEPS = 2
# one qwen3-moe layer's tokens: 8 sequences of 512
LAYOUT_MOE_TOKENS = (8, 512)


def _layout_steps(torch, dev, cfg, params, mesh, launches, shardings=None):
    """``LAYOUT_STEPS`` steps of ``make_train_step(cfg, mesh, ...,
    shardings=shardings)`` from ``params`` and a fresh AdamW state on the
    first batches at phase 17's settings, each step's Q-MAC launches
    counted (with a mesh, added to ``launches``): (params, state,
    [(loss, grad_norm)], launches a step, step seconds)."""
    from repro_torch import kernels
    from repro_torch.core.policy import get_policy
    from repro_torch.data import DataConfig, batch_at, place
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine

    step = make_train_step(cfg, mesh, get_policy("w8a8"),
                           AdamWConfig(weight_decay=0.0),
                           warmup_cosine(3e-4, 1, TRAIN_STEPS),
                           shardings=shardings)
    dcfg = DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, 0)
    p, o = params, adamw_init(params)
    stats, per_step, dts = [], [], []
    for s in range(LAYOUT_STEPS):
        batch = batch_at(dcfg, s)
        batch = place(batch, mesh) if mesh is not None else \
            {k: v.to(dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        p, o, st = step(p, o, batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        if mesh is not None:
            for k, v in counts.items():
                launches[k] += v
        per_step.append({k: counts[k] for k in QMAC_WRAPPERS})
        stats.append((st["loss"].cpu(), st["grad_norm"].cpu()))
    return p, o, stats, per_step, dts


def _recording_dispatch(torch):
    """Records, while on, each MoE dispatch's chosen experts and kept
    assignments (the mesh's ``_local_dispatch`` and the global path's
    ``_dispatch_indices``) and every row-quantized activation's int8
    codes.  Returns (record, on, off)."""
    from repro_torch.core import qmatmul
    from repro_torch.nn import moe, moe_shard

    rec = {"experts": [], "keep": [], "codes": []}
    orig = (moe_shard._local_dispatch, moe._dispatch_indices,
            qmatmul.quantize_rowwise)

    def local(x_rep, e_flat, n_experts, capacity):
        out = orig[0](x_rep, e_flat, n_experts, capacity)
        rec["experts"].append(e_flat.to(torch.int32).cpu())
        rec["keep"].append(out[2].cpu())
        return out

    def global_(e_flat, n_experts, capacity):
        pos, keep = orig[1](e_flat, n_experts, capacity)
        rec["experts"].append(e_flat.to(torch.int32).cpu())
        rec["keep"].append(keep.cpu())
        return pos, keep

    def rowwise(x, bits, *split):
        q, scale = orig[2](x, bits, *split)
        rec["codes"].append(q.cpu())
        return q, scale

    def on():
        for v in rec.values():
            v.clear()
        moe_shard._local_dispatch = local
        moe._dispatch_indices = global_
        qmatmul.quantize_rowwise = rowwise

    def off():
        (moe_shard._local_dispatch, moe._dispatch_indices,
         qmatmul.quantize_rowwise) = orig

    return rec, on, off


def lm_layout(torch, dev, card, params):
    """Phase 19: the LM layout on the card.

    (a) From phase 17's trained TinyLlama ``params`` (all 22 layers at
    full width) and the same two batches, ``LAYOUT_STEPS`` steps of
    ``make_train_step(cfg, make_host_mesh(), ...)`` (one NCCL rank, the
    batch ``place``'d) and as many of ``make_train_step(cfg, None,
    ...)``, one run after the other, the first run's trees waiting on
    the host: the params, ``mu``, ``nu``, ``count``, every loss and
    grad norm bitwise equal, 309 ``qmac_i8`` a step in each.

    (b) One qwen3-moe layer at its published widths (d_model 2048, 128
    experts, top-8, d_ff_expert 768; fp32 weights drawn from seed 19,
    w8a8) on 8 x 512 tokens: ``moe_shard_map`` on the one-rank mesh
    (``moe_apply`` takes it only above one rank, as the reference's
    does) bitwise the same call on the CPU's plain path and the global
    ``moe_apply`` on the card: the experts chosen, the assignments
    dropped, every int8 code and the output; 3 ``qmac_i8_deq_bmm``
    launches.  Returns the path's launches: the runs through the mesh
    alone, the counts zeroed just before each and read just after."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.mesh import describe, make_host_mesh
    from repro_torch.nn.moe import moe_apply, moe_init
    from repro_torch.nn.moe_shard import moe_shard_map
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    mesh = make_host_mesh(device=dev)
    backend = dist.get_backend(mesh.get_group("data"))
    if backend != "nccl":
        raise AssertionError(f"the card's mesh runs on {backend}, not nccl")
    launches = dict.fromkeys(kernels.launch_counts(), 0)
    cfg = get_arch(LM_ARCH)
    want = train_products(cfg)

    # (a) the mesh's step against the unsharded step
    runs = {}
    for name, m in (("mesh", mesh), ("unsharded", None)):
        torch.cuda.reset_peak_memory_stats()
        p, o, stats, per_step, dts = _layout_steps(torch, dev, cfg, params,
                                                   m, launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[name] = (tree_map(lambda t: t.cpu(), (p, o)), stats)
        del p, o
        torch.cuda.empty_cache()
        how = f"on {describe(m)}" if m is not None else "with no mesh"
        print(f"  {LM_ARCH} {LAYOUT_STEPS} training steps, make_train_step "
              f"{how}: losses {[float(s[0]) for s in stats]}, grad norms "
              f"{[float(s[1]) for s in stats]}, step seconds "
              f"{[round(d, 4) for d in dts]}, Q-MAC launches a step "
              f"{per_step}; card peak allocated {peak:.1f} GiB")
        if per_step != [want] * LAYOUT_STEPS:
            raise AssertionError(f"{name} steps launched {per_step}, not "
                                 f"{want} each")
    (ta, sa), (tb, sb) = runs["mesh"], runs["unsharded"]
    same = _trees_bitwise(torch, ta, tb) and all(
        bits_equal(torch, x, y) for a, b in zip(sa, sb) for x, y in zip(a, b))
    print(f"  the mesh's steps vs the unsharded steps: params, mu, nu, "
          f"count, losses and grad norms bitwise "
          f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the host mesh's training steps differ from "
                             "the unsharded steps")
    del runs, ta, tb

    # (b) one qwen3-moe layer's dispatch over the mesh
    mcfg = get_arch(MOE_ARCH)
    pol = get_policy("w8a8")
    t1 = time.perf_counter()
    g = torch.Generator().manual_seed(19)
    layer = moe_init(g, mcfg.d_model, mcfg.d_ff, mcfg.n_experts)
    x = torch.randn(LAYOUT_MOE_TOKENS + (mcfg.d_model,), generator=g)
    draw_s = time.perf_counter() - t1
    kw = dict(top_k=mcfg.top_k, capacity_factor=mcfg.capacity_factor,
              policy=pol, act=mcfg.act)
    on_card = tree_map(lambda t: t.to(dev), layer)
    xc = x.to(dev)
    rec, rec_on, rec_off = _recording_dispatch(torch)
    cpu_mesh = make_host_mesh(device="cpu")

    def recorded(fn):
        rec_on()
        try:
            out = fn()
        finally:
            rec_off()
        return out.cpu(), {k: list(v) for k, v in rec.items()}

    def shard_map_on(m, xs, w):
        return moe_shard_map(xs, w["router"]["w"], w["w_gate"], w["w_up"],
                             w["w_down"], m, **kw)

    with torch.no_grad():
        kernels.reset_launch_counts()
        card_out, card_rec = recorded(lambda: shard_map_on(mesh, xc,
                                                           on_card))
        counts = kernels.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        t1 = time.perf_counter()
        cpu_out, cpu_rec = recorded(lambda: shard_map_on(cpu_mesh, x, layer))
        cpu_s = time.perf_counter() - t1
        glob_out, glob_rec = recorded(lambda: moe_apply(on_card, xc, **kw))
        ms = device_ms(torch, lambda: shard_map_on(mesh, xc, on_card))
        glob_ms = device_ms(torch, lambda: moe_apply(on_card, xc, **kw))
    qcounts = {k: counts[k] for k in QMAC_WRAPPERS}
    tokens = LAYOUT_MOE_TOKENS[0] * LAYOUT_MOE_TOKENS[1]
    dropped = int((~card_rec["keep"][0]).sum())

    def same_as(other):
        return bits_equal(torch, card_out, other[0]) and all(
            len(card_rec[k]) == len(other[1][k]) and all(
                bits_equal(torch, a, b)
                for a, b in zip(card_rec[k], other[1][k]))
            for k in card_rec)

    vs_cpu, vs_glob = same_as((cpu_out, cpu_rec)), same_as((glob_out,
                                                            glob_rec))
    n_codes = sum(c.numel() for c in card_rec["codes"])
    print(f"  {MOE_ARCH} layer (d_model {mcfg.d_model}, {mcfg.n_experts} "
          f"experts, top-{mcfg.top_k}, d_ff_expert {mcfg.d_ff}, w8a8) on "
          f"{tokens} tokens through moe_shard_map on {describe(mesh)}: "
          f"{dropped} of {tokens * mcfg.top_k} assignments dropped over "
          f"capacity; {n_codes} int8 codes in {len(card_rec['codes'])} "
          f"activations; vs the CPU's plain path "
          f"{'bitwise' if vs_cpu else 'DIFFERENT'} (experts, drops, codes, "
          f"output; the CPU call {cpu_s:.1f} s), vs moe_apply on the card "
          f"{'bitwise' if vs_glob else 'DIFFERENT'}; Q-MAC launches "
          f"{qcounts}; {ms:.4f} ms a call, moe_apply {glob_ms:.4f} ms, on "
          f"{card}; the layer drawn in {draw_s:.1f} s")
    if qcounts != {"qmac_i8_deq": 0, "qmac_i8": 0, "qmac_i8_deq_bmm": 3}:
        raise AssertionError(f"moe_shard_map launched {qcounts}, not 3 "
                             "qmac_i8_deq_bmm")
    if not (vs_cpu and vs_glob):
        raise AssertionError("moe_shard_map on the card differs from the "
                             "CPU or from moe_apply")
    del on_card, xc, layer
    torch.cuda.empty_cache()
    print(f"phase 19 launches: {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 20: the static analysis — the lint and the trace audit on the card
# ---------------------------------------------------------------------------

# phase 20's own limit, seconds
ANALYSIS_LIMIT_S = 120
# the trace audit's sweep: 54 accepted combos, 5 sharded, 2 ladders
AUDITED = 54 + 5 + 2


def analysis_gate(card):
    """Phase 20: ``repro_torch.analysis``'s lint over the port's tree and
    its full trace audit on the card, each clean under the committed
    allowlist; returns the audit's kernel launches."""
    from collections import Counter

    from repro_torch.analysis import trace_audit
    from repro_torch.analysis.allowlist import (apply_allowlist,
                                                load_allowlist)
    from repro_torch.analysis.lint import run_lint
    from repro_torch.analysis.rules import RULES

    t0 = time.perf_counter()
    entries = load_allowlist()

    def gate(findings, rules, what):
        kept, stale, suppressed = apply_allowlist(
            findings, [e for e in entries if e.rule in rules])
        for f in kept:
            print(f"phase 20 {what}: {f.render()}")
        for e in stale:
            print(f"phase 20 {what}: stale allowlist entry {e.rule} "
                  f"{e.path} {e.match!r}")
        assert not kept and not stale, (
            f"phase 20 {what}: {len(kept)} finding(s), {len(stale)} stale "
            "allowlist entries")
        return dict(sorted(Counter(f.rule for f in suppressed).items()))

    lint = run_lint(ROOT)
    per_rule = gate(lint, RULES, "lint")
    print(f"phase 20 lint over src/repro_torch: {len(lint)} findings, 0 "
          f"kept, 0 stale; suppressed by rule {per_rule}")
    t1 = time.perf_counter()
    res = trace_audit.run_trace_audit(device="cuda")
    per_check = gate(res.findings, trace_audit.CHECKS, "trace audit")
    assert len(res.combos_checked) == AUDITED, res.combos_checked
    fxp8 = [c for c in res.combos_checked if "/fxp8" in c]
    secs = time.perf_counter() - t0
    print(f"phase 20 trace audit on {card}: {len(res.combos_checked)} "
          f"audits ({len(fxp8)} fxp8, each with a kernel launch), 0 "
          f"findings after the allowlist (suppressed {per_check}) in "
          f"{time.perf_counter() - t1:.1f} s; QF904 held {res.held}; "
          f"launches {res.launches}")
    print("phase 20 combos checked: " + " ".join(
        c.removeprefix("trace:") for c in res.combos_checked))
    print(f"phase 20 took {secs:.1f} s of its {ANALYSIS_LIMIT_S} s limit")
    assert secs <= ANALYSIS_LIMIT_S, (
        f"phase 20 took {secs:.1f} s, past its {ANALYSIS_LIMIT_S} s limit")
    return res.launches


# ---------------------------------------------------------------------------
# phase 21: the dry run's forecasts against the card
# ---------------------------------------------------------------------------

# phase 21's own limit, seconds: its three TinyLlama cells
DRY_RUN_LIMIT_S = 90
# the cells phases 13 and 17 run: (name, seq_len, batch, kind, policy)
DRY_RUN_CELLS = (("prefill_8x512", 512, 8, "prefill", "w8a8kv8"),
                 ("decode_4x48", 48, 4, "decode", "w8a8kv8"),
                 ("train_8x128", 128, 8, "train", "w8a8"))
# the card's peak allocation over a step (arguments + the step's own
# peak) over the forecast (arguments + temps): PERF.md section 6 gives
# the bar's reason
DRY_RUN_MEMORY_BAR = (0.999, 1.001)
# one production cell, traced on the card machine's CPU in a process of
# its own while phases 21 to 23 run on the card, and its limit from
# its start, seconds.  Rematerialised, its step records each layer's
# forward again in the backward (80 layers, 80% more records): 127.2 s
# on that CPU against 52.8 s without remat (PERF.md section 6)
DRY_RUN_CELL = ("qwen2-72b", "train_4k")
DRY_RUN_CELL_LIMIT_S = 180


def _first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x[:5] != y[:5]:
            return f"record {i}: meta {x[:4]} card {y[:4]}"
    return f"{len(a)} meta records, {len(b)} on the card"


def start_production_cell():
    """Start ``python -m repro_torch.launch.dryrun`` on ``DRY_RUN_CELL``
    in a process of its own with no card, its output in files under
    ``build/chip_smoke/phase21``.  Returns (the process, its start,
    the output directory); ``finish_production_cell`` collects it."""
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "phase21")
    os.makedirs(out_dir, exist_ok=True)
    arch, shape_name = DRY_RUN_CELL
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(os.path.join(out_dir, "production_cell.out"), "w") as out, \
            open(os.path.join(out_dir, "production_cell.err"), "w") as err:
        cell = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape_name, "--json",
             os.path.join(out_dir, "production_cell.json")],
            stdout=out, stderr=err, env=env, cwd=ROOT)
    return cell, time.perf_counter(), out_dir


def stop(cell):
    """Kill ``cell`` if it still runs, and wait for it."""
    if cell.poll() is None:
        cell.kill()
    cell.wait()


def finish_production_cell(cell, t0, out_dir):
    """Wait for the production cell up to ``DRY_RUN_CELL_LIMIT_S`` from
    its start ``t0``: exit 0 and its roofline line."""
    arch, shape_name = DRY_RUN_CELL
    try:
        cell.wait(timeout=max(1.0, DRY_RUN_CELL_LIMIT_S
                              - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop(cell)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "production_cell.out")) as f:
        lines = f.read().splitlines()
    with open(os.path.join(out_dir, "production_cell.err")) as f:
        err = f.read()
    print(f"phase 21 {arch} x {shape_name} on this machine's CPU, no card "
          f"(exit {cell.returncode}, {secs:.1f} s of its "
          f"{DRY_RUN_CELL_LIMIT_S} s limit, beside phases 21 to 23):")
    for line in lines:
        if line.strip():
            print(f"  {line}")
    if secs > DRY_RUN_CELL_LIMIT_S:
        raise AssertionError(f"the production cell took {secs:.1f} s, "
                             f"past its {DRY_RUN_CELL_LIMIT_S} s limit")
    if cell.returncode != 0 or not any("roofline:" in ln for ln in lines):
        raise AssertionError(f"the production cell failed: {err[-2000:]}")


def dry_run_gate(torch, dev, card):
    """Phase 21: each TinyLlama cell of ``DRY_RUN_CELLS`` traced on the
    meta device and on the card under one recorder, the traces equal,
    the busy time at least the roofline's floor, the memory forecast
    within its bar (``start_production_cell`` runs beside it).  Returns
    the phase's launches: each cell's warm-up and traced steps, counted
    from 0 (its profile resets the counters, as every ``_profiled``
    does)."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    mesh = make_host_mesh(device=dev)
    launches = dict.fromkeys(kernels.launch_counts(), 0)
    for name, seq, batch, kind, pol_name in DRY_RUN_CELLS:
        ran = _dry_run_cell(torch, dev, card, cfg, mesh,
                            ShapeConfig(name, seq, batch, kind),
                            get_policy(pol_name))
        for k, v in ran.items():
            launches[k] += v
    secs = time.perf_counter() - t0
    print(f"phase 21 took {secs:.1f} s of its {DRY_RUN_LIMIT_S} s limit")
    assert secs <= DRY_RUN_LIMIT_S, (
        f"phase 21 took {secs:.1f} s, past its {DRY_RUN_LIMIT_S} s limit")
    return launches


def _dry_run_cell(torch, dev, card, cfg, mesh, shape, policy):
    """One cell of phase 21 (``dry_run_gate``); returns the launches of
    its warm-up and traced steps."""
    from repro_torch import kernels
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps
    from repro_torch.launch.roofline import roofline_terms

    step = steps.cell_step(cfg, shape, mesh, policy)
    args, _ = steps.cell_inputs(cfg, shape, mesh, policy)
    args = steps.materialize(args, torch.Generator(device=dev).manual_seed(21),
                             cfg.vocab)
    kernels.reset_launch_counts()
    # a warm-up on each device (tables built once a device, the rope's)
    step(*args)
    steps.lower_cell(cfg, shape, mesh, policy)
    meta, info = steps.lower_cell(cfg, shape, mesh, policy)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()
    on_card = H.trace(step, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    after = kernels.launch_counts()
    what = f"{LM_ARCH} {info['step']} {shape.name} at {policy.name}"
    same = [r[:5] for r in meta.ops] == [r[:5] for r in on_card.ops]
    cost_m, cost_c = H.cost_terms(meta), H.cost_terms(on_card)
    hist = H.op_histogram(meta)
    qmac = {k: hist.get(k, 0) for k in QMAC_WRAPPERS}
    counted = {k: after[k] - before[k] for k in QMAC_WRAPPERS}
    print(f"phase 21 {what}: {len(meta.ops)} records on meta, "
          f"{len(on_card.ops)} on the card, equal {same}; Q-MAC records "
          f"{qmac}, launch counters {counted}; flops "
          f"{cost_m['flops']:.6e} {cost_m['flops_by_dtype']}, int_ops "
          f"{cost_m['int_ops']:.6e}, bytes {cost_m['bytes']:.6e}, "
          f"collective bytes {cost_m['collective_bytes']:.6e}")
    if not same:
        raise AssertionError(f"{what}: the traces differ, "
                             f"{_first_difference(meta.ops, on_card.ops)}")
    if cost_m != cost_c or hist != H.op_histogram(on_card):
        raise AssertionError(f"{what}: costs {cost_m} on meta, {cost_c} on "
                             "the card")
    want = sum(train_products(cfg, shape.seq_len).values()) \
        if shape.kind == "train" else LM_PER_FORWARD
    if qmac != counted or sum(qmac.values()) != want:
        raise AssertionError(f"{what}: Q-MAC records {qmac}, launches "
                             f"{counted}")
    roof = roofline_terms(cfg, shape, mesh, cost_m)

    def run():
        step(*args)
        torch.cuda.synchronize()

    wall, rows, _, _ = _profiled(torch, run, 1)
    busy_s = sum(r[0] for r in rows) / 1e3
    mem = H.memory_stats(meta)
    card_mem = H.memory_stats(on_card)
    forecast = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    measured = mem["argument_size_in_bytes"] + peak
    ratio = measured / forecast
    print(f"  roofline forecast at H100 data-sheet peaks: compute "
          f"{roof['t_compute']:.6e} s, memory {roof['t_memory']:.6e} s, "
          f"collective {roof['t_collective']:.6e} s, bound "
          f"{roof['bound']}, t_step {roof['t_step']:.6e} s; device busy "
          f"{busy_s:.6e} s on {card} (wall {wall / 1e3:.6e} s), busy / "
          f"t_step {busy_s / roof['t_step']:.4f}")
    print(f"  memory: arguments {mem['argument_size_in_bytes'] / 2**30:.4f} "
          f"GiB + temps forecast {mem['temp_size_in_bytes'] / 2**30:.4f} GiB "
          f"(the card's trace {card_mem['temp_size_in_bytes'] / 2**30:.4f} "
          f"GiB) = {forecast / 2**30:.4f} GiB; the card's peak over the step "
          f"{peak / 2**30:.4f} GiB beyond {held / 2**30:.4f} GiB held, "
          f"arguments + peak {measured / 2**30:.4f} GiB; measured / forecast "
          f"{ratio:.6f} (bar {DRY_RUN_MEMORY_BAR}); not in the trace: "
          f"Q-MAC's split-K workspace and cuBLAS's workspace, each made "
          f"once a stream and held before the step")
    if busy_s < roof["t_step"]:
        raise AssertionError(f"{what}: busy {busy_s} s under the floor "
                             f"{roof['t_step']} s: the count is wrong")
    lo, hi = DRY_RUN_MEMORY_BAR
    if not lo <= ratio <= hi:
        raise AssertionError(f"{what}: memory measured / forecast {ratio}")
    return after


# ---------------------------------------------------------------------------
# phase 22: rematerialisation — the rematerialised training step against
# the plain one, and a step at train_4k's sequence length
# ---------------------------------------------------------------------------

# phase 22's own limit, seconds
REMAT_LIMIT_S = 150
# train_4k's sequence and its batch a rank (256 over the 16 data slots
# of the (16, 16) mesh), then the smaller batches tried when its
# forecast does not fit
REMAT_SEQ = 4096
REMAT_BATCHES = (16, 8, 4, 2)
# the share of the card's memory the forecast (arguments + temps) must
# leave free
REMAT_FREE = 0.10


def _profiled_once(torch, fn):
    """One call of ``fn`` under ``torch.profiler`` (the device's activity
    alone): (its result, host wall s, device busy ms or None when the
    trace came back empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "device_time_total", None)
        busy_us += ev.cuda_time_total if dev_us is None else dev_us
    return out, wall, busy_us / 1e3 if busy_us else None


def remat_against_plain(torch, dev, card, params):
    """Phase 22 (a): from ``params`` (phase 17's trained TinyLlama, all 22
    layers at full width), a fresh AdamW state and the run's first
    batch (8 x 128, w8a8), one ``make_train_step`` step with
    ``cfg.remat`` on (the config's default) and one with it off: the new
    params, ``mu``, ``nu``, ``count``, the loss and the grad norm
    bitwise equal; ``train_products`` Q-MAC launches each (309 and 155
    ``qmac_i8``); each step's card peak allocation beyond what was held
    before it and its device busy ms (``_profiled``) printed beside the
    other's, and the peak of its forward and backward alone (the loss's
    gradient: the step's own peak comes later, in AdamW, which holds the
    gradient tree and the new params, ``mu`` and ``nu`` at once).
    Returns the launches of the rematerialised step, counted from 0."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg, pol = get_arch(LM_ARCH), get_policy("w8a8")
    if not cfg.remat:
        raise AssertionError(f"{LM_ARCH}'s config does not ask for remat")
    ocfg = AdamWConfig(weight_decay=0.0)
    sched = warmup_cosine(3e-4, 1, TRAIN_STEPS)
    batch = {k: v.to(dev) for k, v in batch_at(
        DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, 0), 0).items()}
    opt = adamw_init(params)
    launches = dict.fromkeys(kernels.launch_counts(), 0)
    runs = {}
    def peak_of(fn):
        """The card's peak allocation over ``fn()`` beyond what was held
        before it, and what was held."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before, before

    for remat in (True, False):
        c = cfg.replace(remat=remat)

        def forward_backward():
            xs = [p.detach().requires_grad_(True) for p in
                  tree_leaves(params)]
            with torch.enable_grad():
                torch.autograd.grad(transformer.loss_fn(
                    tree_unflatten(params, xs), batch, c, pol), xs)

        fb_peak, _ = peak_of(forward_backward)
        step = make_train_step(c, None, pol, ocfg, sched)
        kernels.reset_launch_counts()
        out = []
        peak, held = peak_of(lambda: out.append(step(params, opt, batch)))
        counts = kernels.launch_counts()
        out = out[0]
        if remat:
            for k, v in counts.items():
                launches[k] += v

        def run():
            step(params, opt, batch)
            torch.cuda.synchronize()

        wall, rows, _, _ = _profiled(torch, run, 1)
        runs[remat] = dict(out=out, peak=peak, held=held, wall=wall,
                           fb_peak=fb_peak,
                           busy=sum(r[0] for r in rows),
                           got={k: counts[k] for k in QMAC_WRAPPERS},
                           want=train_products(c))
    on, off = runs[True], runs[False]
    for name, r in (("on", on), ("off", off)):
        st = r["out"][2]
        print(f"phase 22 (a) {LM_ARCH} w8a8 training step, {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, remat {name}: loss {float(st['loss']):.6f}, "
              f"grad norm {float(st['grad_norm']):.6f}; card peak allocated "
              f"{r['peak'] / 2**30:.4f} GiB beyond "
              f"{r['held'] / 2**30:.4f} GiB held (its forward and "
              f"backward alone {r['fb_peak'] / 2**30:.4f} GiB); device busy "
              f"{r['busy']:.4f} ms, wall {r['wall']:.4f} ms; Q-MAC "
              f"launches {r['got']} (want {r['want']})")
    same = _trees_bitwise(torch, on["out"][:2], off["out"][:2])
    stats = all(bits_equal(torch, on["out"][2][k], off["out"][2][k])
                for k in ("loss", "grad_norm"))
    print(f"phase 22 (a) remat on vs off on {card}: params, mu, nu, count "
          f"{'bitwise equal' if same else 'DIFFERENT'}, loss and grad norm "
          f"{'bitwise equal' if stats else 'DIFFERENT'}; peak "
          f"{on['peak'] / 2**30:.4f} / {off['peak'] / 2**30:.4f} GiB "
          f"({on['peak'] / off['peak']:.4f}), forward and backward "
          f"{on['fb_peak'] / 2**30:.4f} / {off['fb_peak'] / 2**30:.4f} GiB "
          f"({on['fb_peak'] / off['fb_peak']:.4f}), busy {on['busy']:.4f} / "
          f"{off['busy']:.4f} ms ({on['busy'] / off['busy']:.4f})")
    for r in (on, off):
        if r["got"] != r["want"]:
            raise AssertionError(f"remat step launched {r['got']}, not "
                                 f"{r['want']}")
    if not (same and stats):
        raise AssertionError("the rematerialised step differs from the "
                             "plain step")
    del runs, on, off, opt
    torch.cuda.empty_cache()
    return launches


def remat_forecasts(total, out):
    """Phase 22 (b)'s forecasts, on the CPU with no card: TinyLlama's
    train step at ``REMAT_SEQ`` on a one-rank mesh (``lower_cell`` on the
    meta device, w8a8) with remat, at each batch of ``REMAT_BATCHES`` in
    turn until its arguments + temps leave ``REMAT_FREE`` of ``total``
    bytes free, then without remat at that batch.  Writes the rows
    (batch, remat, arguments, temps, seconds) as JSON to ``out``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.policy import get_policy
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps

    cfg, pol = get_arch(LM_ARCH), get_policy("w8a8")
    mesh = MeshShape(("data", "model"), (1, 1))
    rows = []

    def forecast(c, b):
        t0 = time.perf_counter()
        prog, _ = steps.lower_cell(
            c, ShapeConfig("train_4k", REMAT_SEQ, b, "train"), mesh, pol)
        mem = H.memory_stats(prog)
        rows.append(dict(batch=b, remat=c.remat,
                         args=mem["argument_size_in_bytes"],
                         temps=mem["temp_size_in_bytes"],
                         secs=time.perf_counter() - t0))
        return rows[-1]["args"] + rows[-1]["temps"]

    for b in REMAT_BATCHES:
        if forecast(cfg, b) <= (1 - REMAT_FREE) * total:
            forecast(cfg.replace(remat=False), b)
            break
    with open(out, "w") as f:
        json.dump(rows, f)


def start_remat_forecasts(torch, dev):
    """Start ``remat_forecasts`` for this card's memory in a process of
    its own with no card, beside phases 21 and 22 (a).  Returns (the
    process, its start, its JSON's path)."""
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "phase22")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "forecasts.json")
    total = torch.cuda.get_device_properties(dev).total_memory
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = (f"import sys; sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, "
            f"{ROOT!r}]; import chip_smoke; "
            f"chip_smoke.remat_forecasts({total}, {out!r})")
    with open(os.path.join(out_dir, "forecasts.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    return proc, time.perf_counter(), out


def train_4k_step(torch, dev, card, launches, t0, forecasts):
    """Phase 22 (b): one full-width TinyLlama step at train_4k's sequence
    length (``REMAT_SEQ``) on the one-rank NCCL mesh, with the remat
    its config asks for: the step of ``launch.steps.cell_step`` on
    ``cell_inputs`` drawn on the card, at the first batch of
    ``REMAT_BATCHES`` whose dry-run forecast (``forecasts``, from
    ``start_remat_forecasts``: arguments + temps) leaves ``REMAT_FREE``
    of the card's memory free; the forecast without remat at that batch
    printed beside it (the reason for the phase: it does not fit).  The
    step runs once under the profiler: its wall and busy time, the
    card's peak allocation beyond what was held (the arguments) against
    the forecast within ``DRY_RUN_MEMORY_BAR``, a finite loss,
    ``train_products`` Q-MAC launches (added to ``launches``, counted
    from 0), and phase 22 within ``REMAT_LIMIT_S`` of ``t0``."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    cfg, pol = get_arch(LM_ARCH), get_policy("w8a8")
    mesh = make_host_mesh(device=dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    room = (1 - REMAT_FREE) * total
    proc, started, path = forecasts
    try:
        proc.wait(timeout=max(1.0, REMAT_LIMIT_S
                              - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop(proc)
    if proc.returncode != 0:
        raise AssertionError(f"the forecasts failed (exit {proc.returncode}"
                             f"), {os.path.dirname(path)}/forecasts.log")
    with open(path) as f:
        rows = json.load(f)
    for r in rows:
        print(f"phase 22 (b) forecast, {LM_ARCH} train {r['batch']} x "
              f"{REMAT_SEQ} w8a8, remat {'on' if r['remat'] else 'off'}: "
              f"arguments {r['args'] / 2**30:.4f} GiB + temps "
              f"{r['temps'] / 2**30:.4f} GiB = "
              f"{(r['args'] + r['temps']) / 2**30:.4f} GiB of the card's "
              f"{total / 2**30:.4f} GiB (room {room / 2**30:.4f} GiB); "
              f"traced on meta in {r['secs']:.1f} s on this machine's CPU")
    fits = [r for r in rows if r["remat"] and r["args"] + r["temps"] <= room]
    plain = [r for r in rows if not r["remat"]]
    if not fits or not plain:
        raise AssertionError(f"no batch of {REMAT_BATCHES} fits at "
                             f"{REMAT_SEQ} with remat")
    batch, args_b, temps = (fits[0]["batch"], fits[0]["args"],
                            fits[0]["temps"])
    plain_args, plain_temps = plain[0]["args"], plain[0]["temps"]
    print(f"phase 22 (b) the forecasts took "
          f"{time.perf_counter() - started:.1f} s beside phases 21 and 22 "
          f"(a)")
    shape = ShapeConfig("train_4k", REMAT_SEQ, batch, "train")
    step = steps.cell_step(cfg, shape, mesh, pol)
    args, _ = steps.cell_inputs(cfg, shape, mesh, pol)
    args = steps.materialize(args, torch.Generator(device=dev).manual_seed(22),
                             cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, wall, busy = _profiled_once(torch, lambda: step(*args))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    for k, v in counts.items():
        launches[k] += v
    got = {k: counts[k] for k in QMAC_WRAPPERS}
    want = train_products(cfg, REMAT_SEQ)
    loss = float(out[2]["loss"])
    ratio = (args_b + peak) / (args_b + temps)
    tokens = batch * REMAT_SEQ
    busy_s = "not measured (the trace came back empty)" if busy is None \
        else f"{busy:.4f} ms"
    print(f"phase 22 (b) {LM_ARCH} w8a8 training step at {batch} x "
          f"{REMAT_SEQ} ({tokens} tokens), remat on, one NCCL rank, on "
          f"{card}: loss {loss:.6f}; wall {wall:.4f} s (under the "
          f"profiler), device busy {busy_s}; {tokens / wall:.1f} tok/s; "
          f"card peak {peak / 2**30:.4f} GiB beyond the {held / 2**30:.4f} "
          f"GiB held, arguments + peak {(args_b + peak) / 2**30:.4f} GiB "
          f"against the forecast {(args_b + temps) / 2**30:.4f} GiB: "
          f"{ratio:.6f} (bar {DRY_RUN_MEMORY_BAR}); without remat the "
          f"forecast is {(plain_args + plain_temps) / 2**30:.4f} GiB; Q-MAC "
          f"launches {got} (want {want})")
    del out, args
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 22 took {secs:.1f} s of its {REMAT_LIMIT_S} s limit")
    if got != want:
        raise AssertionError(f"the train_4k step launched {got}, not {want}")
    if not math.isfinite(loss):
        raise AssertionError(f"the train_4k step's loss is {loss}")
    lo, hi = DRY_RUN_MEMORY_BAR
    if not lo <= ratio <= hi:
        raise AssertionError(f"the train_4k step's memory measured / "
                             f"forecast {ratio}")
    if secs > REMAT_LIMIT_S:
        raise AssertionError(f"phase 22 took {secs:.1f} s, past its "
                             f"{REMAT_LIMIT_S} s limit")
    return launches


# ---------------------------------------------------------------------------
# phase 23: the laid-out training step (the dense family on params laid
# out by make_shardings)
# ---------------------------------------------------------------------------

# phase 23's own limit, seconds
LAYOUT_LIMIT_S = 120
# (b)'s cell: rank 0 of the (16, 16) production mesh at train_4k
LAID_OUT_MESH = (16, 16)
LAID_OUT_SHAPE = "train_4k"


def laid_out_gate(torch, dev, card, params):
    """Phase 23: the laid-out training step on the card.

    (a) From ``params`` (phase 17's trained TinyLlama, all 22 layers at
    full width, on the host), ``LAYOUT_STEPS`` steps of
    ``make_train_step(cfg, make_host_mesh(), ..., shardings=p_shard)``
    on the one NCCL rank's blocks (``local_shards``: the whole params at
    one rank) and as many of ``make_train_step(cfg, None, ...)``: the
    params, ``mu``, ``nu``, ``count``, every loss and grad norm bitwise
    equal, 309 ``qmac_i8`` a step in each.

    (b) Rank 0 of the (16, 16) production mesh (a ``MeshShape``: each
    peer's piece a copy of rank 0's, so the values are no training
    result) at train_4k (16 rows of 4,096 tokens a rank, remat on):
    ``lower_cell`` traces it on the meta device, then the same step runs
    once on the card from ``materialize``d inputs under the same
    recorder: the traces equal call by call, the Q-MAC records equal the
    counters, the device busy time at least the roofline's ``t_step``, a
    finite loss, and the card's peak within ``DRY_RUN_MEMORY_BAR`` of
    the forecast (arguments + temps).  The rotary table is built on
    both devices first (once a device), so neither trace holds it.
    Returns the path's launches: (a)'s laid-out steps and (b)'s traced
    step, each counted from 0."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES, ShapeConfig
    from repro_torch.core.policy import get_policy
    from repro_torch.distributed.sharding import MeshShape, local_shards
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import describe, make_host_mesh
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.nn.rotary import apply_rope
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg, pol = get_arch(LM_ARCH), get_policy("w8a8")
    launches = dict.fromkeys(kernels.launch_counts(), 0)

    # (a) one NCCL rank: the laid-out steps against today's
    mesh = make_host_mesh(device=dev)
    p_shard = steps.abstract_params(cfg, mesh)[1]
    want = train_products(cfg)
    on_card = tree_map(lambda t: t.to(dev), params)
    runs = {}
    for name, m, sh in (("laid out", mesh, p_shard),
                        ("unsharded", None, None)):
        p0 = local_shards(on_card, sh, m) if sh is not None else on_card
        p, o, stats, per_step, dts = _layout_steps(torch, dev, cfg, p0, m,
                                                   launches, shardings=sh)
        runs[name] = (tree_map(lambda t: t.cpu(), (p, o)), stats)
        del p, o, p0
        how = f"on {describe(m)}, laid out" if m is not None else \
            "with no mesh"
        print(f"phase 23 (a) {LM_ARCH} {LAYOUT_STEPS} training steps, "
              f"make_train_step {how}: losses "
              f"{[float(st[0]) for st in stats]}, grad norms "
              f"{[float(st[1]) for st in stats]}, step seconds "
              f"{[round(d, 4) for d in dts]}, Q-MAC launches a step "
              f"{per_step}")
        if per_step != [want] * LAYOUT_STEPS:
            raise AssertionError(f"{name} steps launched {per_step}, not "
                                 f"{want} each")
    del on_card
    torch.cuda.empty_cache()
    (ta, sa), (tb, sb) = runs["laid out"], runs["unsharded"]
    same = _trees_bitwise(torch, ta, tb) and all(
        bits_equal(torch, x, y) for a, b in zip(sa, sb) for x, y in zip(a, b))
    print(f"phase 23 (a) the laid-out steps vs the unsharded steps: params, "
          f"mu, nu, count, losses and grad norms bitwise "
          f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the laid-out training steps differ from the "
                             "unsharded steps")
    del runs, ta, tb

    # (b) rank 0 of the production mesh at train_4k
    for where in ("meta", dev):
        apply_rope(torch.zeros((1, 1, 1, cfg.hd), device=where),
                   torch.zeros((1, 1), dtype=torch.long, device=where),
                   cfg.rope_theta)
    ms = MeshShape(("data", "model"), LAID_OUT_MESH)
    total = torch.cuda.get_device_properties(dev).total_memory
    shape = SHAPES[LAID_OUT_SHAPE]
    t1 = time.perf_counter()
    meta, info = steps.lower_cell(cfg, shape, ms, pol)
    mem = H.memory_stats(meta)
    forecast = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    while forecast > (1 - REMAT_FREE) * total and shape.global_batch > 16:
        print(f"phase 23 (b) {shape.name} at {shape.global_batch} rows: "
              f"forecast {forecast / 2**30:.4f} GiB does not fit the card's "
              f"{total / 2**30:.4f} GiB; halving the batch")
        shape = ShapeConfig(shape.name, shape.seq_len,
                            shape.global_batch // 2, "train")
        meta, info = steps.lower_cell(cfg, shape, ms, pol)
        mem = H.memory_stats(meta)
        forecast = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    lower_s = time.perf_counter() - t1
    rows = shape.global_batch // LAID_OUT_MESH[0]
    step = steps.cell_step(cfg, shape, ms, pol)
    args, _ = steps.cell_inputs(cfg, shape, ms, pol)
    args = steps.materialize(args, torch.Generator(device=dev).manual_seed(23),
                             cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t2 = time.perf_counter()
    traced = H.trace(step, args)
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t2
    peak = torch.cuda.max_memory_allocated() - held
    counts = kernels.launch_counts()
    for k, v in counts.items():
        launches[k] += v
    what = (f"{LM_ARCH} train_step {shape.name} ({rows} x {shape.seq_len} "
            f"a rank) at w8a8 on rank 0 of {ms.shape}, laid out")
    same = [r[:5] for r in meta.ops] == [r[:5] for r in traced.ops]
    cost_m, cost_c = H.cost_terms(meta), H.cost_terms(traced)
    hist = H.op_histogram(meta)
    qmac = {k: hist.get(k, 0) for k in QMAC_WRAPPERS}
    counted = {k: counts[k] for k in QMAC_WRAPPERS}
    print(f"phase 23 (b) {what}: {len(meta.ops)} records on meta (traced "
          f"in {lower_s:.1f} s), {len(traced.ops)} on the card ({traced_s:.1f}"
          f" s under the recorder), equal {same}; Q-MAC records {qmac}, "
          f"launch counters {counted}; flops {cost_m['flops']:.6e}, int_ops "
          f"{cost_m['int_ops']:.6e}, bytes {cost_m['bytes']:.6e}, "
          f"collective bytes {cost_m['collective_bytes']:.6e} "
          f"{H.collective_bytes(meta)}")
    if not info["laid_out"]:
        raise AssertionError(f"{what}: lower_cell did not lay it out")
    if not same:
        raise AssertionError(f"{what}: the traces differ, "
                             f"{_first_difference(meta.ops, traced.ops)}")
    if cost_m != cost_c or hist != H.op_histogram(traced):
        raise AssertionError(f"{what}: costs {cost_m} on meta, {cost_c} on "
                             "the card")
    if qmac != counted or qmac != train_products(cfg, shape.seq_len):
        raise AssertionError(f"{what}: Q-MAC records {qmac}, launches "
                             f"{counted}")
    roof = roofline_terms(cfg, shape, ms, cost_m)
    out, wall, busy = _profiled_once(torch, lambda: step(*args))
    loss = float(out[2]["loss"])
    del out
    measured = mem["argument_size_in_bytes"] + peak
    ratio = measured / forecast
    busy_s = None if busy is None else busy / 1e3
    print(f"phase 23 (b) {what} on {card}: arguments a rank "
          f"{mem['argument_size_in_bytes'] / 2**30:.4f} GiB (the layout's "
          f"{mem['layout_argument_bytes'] / 2**30:.4f} GiB), temps forecast "
          f"{mem['temp_size_in_bytes'] / 2**30:.4f} GiB, the card's peak "
          f"{peak / 2**30:.4f} GiB beyond {held / 2**30:.4f} GiB held: "
          f"measured / forecast {ratio:.6f} (bar {DRY_RUN_MEMORY_BAR}); loss "
          f"{loss:.6f}; wall {wall:.4f} s (under the profiler), device busy "
          + ("not measured (the trace came back empty)" if busy_s is None
             else f"{busy_s:.4f} s") + f"; roofline at H100 data-sheet "
          f"peaks: compute {roof['t_compute']:.6e} s, memory "
          f"{roof['t_memory']:.6e} s, collective {roof['t_collective']:.6e} "
          f"s, t_step {roof['t_step']:.6e} s")
    del args, step
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 23 launches: {launches}; {secs:.1f} s of its "
          f"{LAYOUT_LIMIT_S} s limit")
    if mem["argument_size_in_bytes"] != mem["layout_argument_bytes"]:
        raise AssertionError(f"{what}: arguments {mem} are not the layout's")
    if not math.isfinite(loss):
        raise AssertionError(f"{what}: loss {loss}")
    if busy_s is None or busy_s < roof["t_step"]:
        raise AssertionError(f"{what}: busy {busy_s} s under the floor "
                             f"{roof['t_step']} s")
    lo, hi = DRY_RUN_MEMORY_BAR
    if not lo <= ratio <= hi:
        raise AssertionError(f"{what}: memory measured / forecast {ratio}")
    if secs > LAYOUT_LIMIT_S:
        raise AssertionError(f"phase 23 took {secs:.1f} s, past its "
                             f"{LAYOUT_LIMIT_S} s limit")
    return launches


# ---------------------------------------------------------------------------
# phase 24: the dense family's serving layout (a prefill on the FSDP+TP
# rules, decode steps on the serve rules and the cache shardings)
# ---------------------------------------------------------------------------

# phase 24's own limit, seconds
SERVE_LAYOUT_LIMIT_S = 150
# (a)'s prompt (rows, tokens) and its decode steps at one NCCL rank
SERVE_LAYOUT_PROMPT = (8, 512)
SERVE_LAYOUT_STEPS = 8
# (b)'s cells on rank 0 of the (16, 16) mesh, and the decode cell's
# indices: its last position (rank 15's) and one of rank 0's positions
SERVE_LAYOUT_CELLS = ("decode_32k", "prefill_32k")
SERVE_LAYOUT_INDICES = (32767, 1000)


def _serve_laid_out(torch, dev, cfg, packed, prompts, fed, mesh):
    """A prefill of ``prompts`` and ``len(fed)`` decode steps fed ``fed``
    through ``launch.steps``' serving steps: laid out on the one-rank
    ``mesh``'s blocks of ``packed`` (the caches grown by
    ``pad_cache_blocks``), or with no mesh (``pad_caches``).  Returns
    (every logit, the caches after the prefill and after the last step,
    every int8 code, each forward's Q-MAC launches)."""
    from repro_torch import kernels
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.policy import get_policy
    from repro_torch.distributed.checks import recorded_codes
    from repro_torch.distributed.sharding import local_shards
    from repro_torch.launch import steps
    from repro_torch.launch.serve import pad_caches

    pol = get_policy("w8a8kv8")
    B, S = prompts.shape
    G = len(fed)
    if mesh is None:
        pre_step = steps.make_prefill_step(cfg, None, pol, pol.kv_bits)
        dec_step = steps.make_decode_step(cfg, None, pol, pol.kv_bits)
        pre = dec = packed
    else:
        p_pre = steps.abstract_params(cfg, mesh, weight_ptq=pol)[1]
        p_dec = steps.abstract_params(cfg, mesh, weight_ptq=pol,
                                      serve=True)[1]
        c_shard = steps.abstract_caches(
            cfg, ShapeConfig("grown", S + G, B, "decode"), mesh,
            pol.kv_bits)[1]
        pre_step = steps.make_prefill_step(cfg, mesh, pol, pol.kv_bits,
                                           shardings=p_pre)
        dec_step = steps.make_decode_step(cfg, mesh, pol, pol.kv_bits,
                                          shardings=p_dec,
                                          cache_shardings=c_shard)
        pre = local_shards(packed, p_pre, mesh)
        dec = local_shards(packed, p_dec, mesh)
    launches = []

    def counted(fn, seq_len):
        """``fn()``, its Q-MAC launches and the int8 codes of its dense
        products' inputs of ``seq_len`` positions (kept on the card)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with recorded_codes(seq_len) as codes:
            out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        launches.append({k: counts[k] for k in QMAC_WRAPPERS})
        return out, list(codes)

    (logits, caches), codes = counted(
        lambda: pre_step(pre, {"tokens": prompts}), S)
    out_logits, out_codes = [logits], list(codes)
    after_prefill = {k: v.clone() for k, v in caches.items()}
    caches = pad_caches(caches, G) if mesh is None else \
        steps.pad_cache_blocks(caches, S, G, cfg, mesh)
    for i in range(G):
        (logits, caches), codes = counted(
            lambda i=i, c=caches: dec_step(dec, c, fed[i], S + i), 1)
        out_logits.append(logits)
        out_codes += codes
    return out_logits, (after_prefill, caches), out_codes, launches


def _warm_qmac(torch, dev, program):
    """Each Q-MAC product of ``program`` (its kernel records' operand
    shapes and dtypes) once on zeros on the card: the kernel's split-K
    workspace, made once a stream and grown on demand, then holds what
    the step will ask of it before the step's peak is read (it is not in
    the trace).  The caller resets the launch counters after."""
    from repro_torch import kernels

    seen = set()
    for r in program.ops:
        if r.kind != "kernel" or r.name not in ("qmac_i8", "qmac_i8_deq"):
            continue
        key = (r.name, tuple((s, dt) for s, dt, _ in r.ins))
        if key not in seen:
            seen.add(key)
            kernels.WRAPPERS[r.name](*(torch.zeros(s, dtype=dt, device=dev)
                                       for s, dt, _ in r.ins))
    torch.cuda.synchronize()


def _serving_cell(torch, dev, card, cfg, ms, shape, pol, index):
    """(b): one serving cell of rank 0 of ``ms`` (a ``MeshShape``)
    traced on meta and run on the card from ``materialize``d inputs
    under the same recorder (a decode cell at ``index``): the traces
    equal, the Q-MAC records equal to the counters, busy at least the
    roofline's ``t_step``, finite logits, the card's peak within
    ``DRY_RUN_MEMORY_BAR`` of arguments + temps.  Returns (the traced
    step's launches, a line of figures)."""
    from repro_torch import kernels
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps
    from repro_torch.launch.roofline import roofline_terms

    t0 = time.perf_counter()
    step = steps.cell_step(cfg, shape, ms, pol)
    args, layout = steps.cell_inputs(cfg, shape, ms, pol)
    if index is not None:
        args = args[:3] + (index,)
    meta = H.trace(step, args, layout)
    lower_s = time.perf_counter() - t0
    mem = H.memory_stats(meta)
    forecast = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    args = steps.materialize(args, torch.Generator(device=dev).manual_seed(
        24), cfg.vocab)
    _warm_qmac(torch, dev, meta)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    held_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    # one run on the card: traced by the recorder (a host-side record a
    # call) under the profiler (the device's activity alone)
    outs = []
    traced, wall, busy = _profiled_once(torch, lambda: H.trace(
        lambda *a: outs.append(step(*a)) or outs[-1], args))
    # the bytes the step's tensors asked for at the peak, as the trace
    # counts them; the allocator's own peak rounds each block up to 512
    # bytes, which thousands of small tensors of a decode step add up
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - held_req
    peak_alloc = torch.cuda.max_memory_allocated() - held
    counts = kernels.launch_counts()
    rows = args[1]["tokens"].shape[0] if shape.kind == "prefill" \
        else args[2].shape[0]
    what = (f"{LM_ARCH} {steps.STEP_NAMES[shape.kind]} {shape.name} "
            f"({rows} rows a rank"
            f"{'' if index is None else f', index {index}'}) at "
            f"{pol.name} on rank 0 of {ms.shape}, laid out")
    same = [r[:5] for r in meta.ops] == [r[:5] for r in traced.ops]
    cost_m, cost_c = H.cost_terms(meta), H.cost_terms(traced)
    hist = H.op_histogram(meta)
    qmac = {k: hist.get(k, 0) for k in QMAC_WRAPPERS}
    counted = {k: counts[k] for k in QMAC_WRAPPERS}
    roof = roofline_terms(cfg, shape, ms, cost_m)
    finite = bool(torch.isfinite(outs[0][0]).all())
    busy_s = None if busy is None else busy / 1e3
    ratio = (mem["argument_size_in_bytes"] + peak) / forecast
    ratio_alloc = (mem["argument_size_in_bytes"] + peak_alloc) / forecast
    del outs, args, step
    torch.cuda.empty_cache()
    line = (f"phase 24 (b) {what}: {len(meta.ops)} records on meta (traced "
            f"in {lower_s:.1f} s), {len(traced.ops)} on the card, equal "
            f"{same}; Q-MAC "
            f"records {qmac}, launch counters {counted}; arguments a rank "
            f"{mem['argument_size_in_bytes'] / 2**30:.4f} GiB (the layout's "
            f"{mem['layout_argument_bytes'] / 2**30:.4f} GiB), temps "
            f"forecast {mem['temp_size_in_bytes'] / 2**30:.4f} GiB, the "
            f"card's peak of requested bytes {peak / 2**30:.6f} GiB beyond "
            f"{held_req / 2**30:.4f} GiB held: measured / forecast "
            f"{ratio:.6f} (bar {DRY_RUN_MEMORY_BAR}); the allocator's peak "
            f"{peak_alloc / 2**30:.6f} GiB beyond {held / 2**30:.4f} GiB "
            f"({ratio_alloc:.6f}); logits finite {finite}; wall "
            f"{wall:.4f} s (under the recorder and the profiler), device "
            f"busy "
            + ("not measured (the trace came back empty)" if busy_s is None
               else f"{busy_s:.4f} s") + f" on {card}; roofline at H100 "
            f"data-sheet peaks: compute {roof['t_compute']:.6e} s, memory "
            f"{roof['t_memory']:.6e} s, collective "
            f"{roof['t_collective']:.6e} s, t_step {roof['t_step']:.6e} s"
            + ("" if busy_s is None else
               f", busy / t_step {busy_s / roof['t_step']:.4f}"))
    print(line, flush=True)
    if not same:
        raise AssertionError(f"{what}: the traces differ, "
                             f"{_first_difference(meta.ops, traced.ops)}")
    if cost_m != cost_c or hist != H.op_histogram(traced):
        raise AssertionError(f"{what}: costs {cost_m} on meta, {cost_c} on "
                             "the card")
    want = {"qmac_i8_deq": 5 * cfg.n_layers + 1, "qmac_i8": 2 * cfg.n_layers,
            "qmac_i8_deq_bmm": 0}
    if qmac != counted or qmac != want:
        raise AssertionError(f"{what}: Q-MAC records {qmac}, launches "
                             f"{counted}, want {want}")
    if mem["argument_size_in_bytes"] != mem["layout_argument_bytes"]:
        raise AssertionError(f"{what}: arguments {mem} are not the layout's")
    if not finite:
        raise AssertionError(f"{what}: logits not finite")
    if busy_s is None or busy_s < roof["t_step"]:
        raise AssertionError(f"{what}: busy {busy_s} s under the floor "
                             f"{roof['t_step']} s")
    lo, hi = DRY_RUN_MEMORY_BAR
    if not lo <= ratio <= hi:
        raise AssertionError(f"{what}: memory measured / forecast {ratio}")
    return counts


def serving_layout_gate(torch, dev, card, params):
    """Phase 24: the dense family's serving steps laid out, on the card.

    (a) From ``params`` (phase 17's trained TinyLlama, all 22 layers at
    full width, on the host), PTQ'd at w8a8kv8 on the card: a prefill of
    ``SERVE_LAYOUT_PROMPT`` and ``SERVE_LAYOUT_STEPS`` decode steps
    (fed tokens drawn from seed 24) through ``make_prefill_step`` /
    ``make_decode_step`` on the one NCCL rank's blocks
    (``shardings=...``, the caches grown by ``pad_cache_blocks``) and
    with no mesh (``pad_caches``): the last-position logits, every
    decode logit, every cache payload and scale (after the prefill and
    after the last step) and every int8 code bitwise equal, 155 Q-MAC
    launches a forward in each (by kernel: at one rank every product is
    whole, so every one is the fused ``qmac_i8_deq``).

    (b) Rank 0 of the (16, 16) production mesh (a ``MeshShape``, its
    peers' pieces copies of rank 0's) at decode_32k, at an index in
    rank 0's range of the 32,768-long cache and one outside it, and at
    prefill_32k (2 rows of 32,768 tokens a rank): each traced on meta
    and run on the card (``_serving_cell``), 44 ``qmac_i8`` (wo and
    w_down, row-parallel) and 111 ``qmac_i8_deq`` a forward.

    Returns the path's launches: (a)'s laid-out runs and (b)'s traced
    steps, each counted from 0."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core.policy import get_policy
    from repro_torch.core.quantizer import quantize_params
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch.mesh import describe, make_host_mesh
    from repro_torch.nn.rotary import apply_rope
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg, pol = get_arch(LM_ARCH), get_policy("w8a8kv8")
    launches = dict.fromkeys(kernels.launch_counts(), 0)

    # (a) one NCCL rank: the laid-out serving steps against today's
    mesh = make_host_mesh(device=dev)
    packed = quantize_params(tree_map(lambda t: t.to(dev), params), pol)
    g = torch.Generator().manual_seed(24)
    B, S = SERVE_LAYOUT_PROMPT
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=g).to(dev)
    fed = torch.randint(0, cfg.vocab, (SERVE_LAYOUT_STEPS, B, 1),
                        generator=g).to(dev)
    runs = {}
    for name, m in (("laid out", mesh), ("unsharded", None)):
        runs[name] = _serve_laid_out(torch, dev, cfg, packed, prompts, fed,
                                     m)
        per = runs[name][3]
        if m is not None:
            for c in per:
                for k, v in c.items():
                    launches[k] += v
        how = f"on {describe(m)}, laid out" if m is not None else \
            "with no mesh"
        print(f"phase 24 (a) {LM_ARCH} w8a8kv8 prefill {B} x {S} and "
              f"{SERVE_LAYOUT_STEPS} decode steps {how}: Q-MAC launches "
              f"the prefill {per[0]}, each decode step {per[1]}; "
              f"{len(runs[name][2])} int8 activations recorded")
        want = {"qmac_i8_deq": LM_PER_FORWARD, "qmac_i8": 0,
                "qmac_i8_deq_bmm": 0}
        if per != [want] * (1 + SERVE_LAYOUT_STEPS):
            raise AssertionError(f"{name}: launches {per}, not {want} a "
                                 "forward")
    (la, ca, qa, _), (lb, cb, qb, _) = runs["laid out"], runs["unsharded"]
    same = {
        "logits": len(la) == len(lb) and all(
            bits_equal(torch, x, y) for x, y in zip(la, lb)),
        "caches": all(bits_equal(torch, x[k], y[k])
                      for x, y in zip(ca, cb) for k in y),
        "codes": len(qa) == len(qb) > 0 and all(
            bits_equal(torch, x, y) for x, y in zip(qa, qb))}
    print(f"phase 24 (a) the laid-out serving steps vs the unsharded ones: "
          f"{same} (last-position logits and {SERVE_LAYOUT_STEPS} decode "
          f"logits, every cache payload and scale after the prefill and "
          f"after the last step, {len(qa)} int8 activations); "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(same.values()):
        raise AssertionError(f"the laid-out serving steps differ: {same}")
    del runs, la, lb, ca, cb, qa, qb, packed, prompts, fed
    torch.cuda.empty_cache()

    # (b) rank 0 of the production mesh
    for where in ("meta", dev):
        apply_rope(torch.zeros((1, 1, 1, cfg.hd), device=where),
                   torch.zeros((1, 1), dtype=torch.long, device=where),
                   cfg.rope_theta)
    ms = MeshShape(("data", "model"), LAID_OUT_MESH)
    for name in SERVE_LAYOUT_CELLS:
        shape = SHAPES[name]
        for index in (SERVE_LAYOUT_INDICES if shape.kind == "decode"
                      else (None,)):
            counts = _serving_cell(torch, dev, card, cfg, ms, shape, pol,
                                   index)
            for k, v in counts.items():
                launches[k] += v
    secs = time.perf_counter() - t0
    print(f"phase 24 launches: {launches}; {secs:.1f} s of its "
          f"{SERVE_LAYOUT_LIMIT_S} s limit")
    if secs > SERVE_LAYOUT_LIMIT_S:
        raise AssertionError(f"phase 24 took {secs:.1f} s, past its "
                             f"{SERVE_LAYOUT_LIMIT_S} s limit")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    if sys.argv[1:2] == ["--worker"]:
        return _worker(torch, sys.argv[2:])

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(what):
        """Print the seconds since the last phase ended."""
        laps.append(time.perf_counter())
        print(f"{what} took {laps[-1] - laps[-2]:.1f} s", flush=True)

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import _build
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {[os.path.basename(p) for p in libs]} in "
          f"{time.perf_counter() - t0:.1f}s")

    worst = check_kernels(torch, dev)
    for check in (check_hrl_kernels, check_split_and_band_edges,
                  check_ew_and_cell_edges, check_softmax_and_q8_edges,
                  check_training_kernels, check_pixel_kernels,
                  check_value_kernels, check_lm_kernels,
                  check_whisper_kernels, check_ssm_hybrid_kernels,
                  check_moe_kernels, check_lm_train_kernels,
                  check_serving_layout_kernels):
        worst = check(torch, dev, worst)
    lap("phases 1-3 (the build and the kernel checks)")
    rows = time_kernels(torch, dev)
    lm_rows = (time_lm_kernels(torch, dev) + time_whisper_kernels(torch, dev)
               + time_ssm_hybrid_kernels(torch, dev)
               + time_moe_kernels(torch, dev))
    for r in lm_rows:
        print_row("qmac_i8_deq", r)
    rows["qmac_i8_deq"] += lm_rows
    train_rows = time_lm_train_kernels(torch, dev)
    for r in train_rows:
        print_row("qmac_i8", r)
    rows["qmac_i8"] += train_rows
    lap("phase 4 (kernel timing)")

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    serve_launches, served = main_path(torch, dev, work)
    profile_forward(torch, dev, os.path.join(work, "ckpt"))
    for precision, st in served.items():
        s = st.server
        print(f"{precision} on {card}: {s['actions_per_s']:.1f} actions/s, "
              f"p50 {s['p50_ms']:.4f} ms, p99 {s['p99_ms']:.4f} ms, "
              f"{st.episodes} episodes")
    lap("phases 5-6 (serving)")
    hrl_launches, fps, lstm = hrl_path(torch, dev)
    per_forward = profile_hrl(torch, lstm)
    print("LSTM-HRL device launches per forward: " + ", ".join(
        f"{b} {v}" for b, v in per_forward.items()))
    for name, v in fps.items():
        print(f"{name} on {card}: {v:.1f} frames/s")
    lap("phases 7-8 (the HRL forward)")
    # phases 9-11's training jobs, each in a process of its own, as many
    # at once as the host has cores; then their checks and profiles on a
    # quiet host and card
    results = _run_workers(torch, work, worker_jobs())
    lap("phases 9-11's jobs")
    train_launches = training_path(card, results)
    card_vs_cpu_iteration(torch, dev)
    profile_training(torch, dev)
    lap("phase 9's card vs CPU and profile")
    pixel_launches = pixel_training(card, results)
    value_launches = value_training(card, results)
    for run in PIXEL_RUNS:
        profile_training(torch, dev, run=run)
    lap("phase 10's profiles")
    for run in VALUE_RUNS:
        profile_value(torch, dev, run)
    lap("phase 11's profiles")
    value_telemetry(os.path.join(work, "phase11"))
    vserve_launches = serve_value_checkpoints(torch, dev, card, work)
    telemetry_leaves_training_alone(torch, dev, card,
                                    os.path.join(work, "phase12"))
    lap("phase 12 (telemetry, profiler window, serving the value "
        "checkpoints)")
    lm_launches = lm_serving(torch, dev, card)
    lm_card_vs_cpu(torch, dev)
    lap("phase 13 (serving TinyLlama-1.1B)")
    whisper_launches = whisper_serving(torch, dev, card)
    whisper_card_vs_cpu(torch, dev)
    lap("phase 14 (serving whisper-large-v3)")
    ssm_launches = ssm_hybrid_serving(torch, dev, card)
    lap("phase 15 (serving mamba2-2.7b and recurrentgemma-9b)")
    moe_launches = moe_serving(torch, dev, card)
    lap("phase 16 (serving qwen3-moe-30b-a3b, and mixtral-8x22b reduced)")
    lm_train_launches, trained = lm_training(torch, dev, card)
    lm_train_card_vs_cpu(torch, dev)
    lap("phase 17 (training TinyLlama-1.1B, every family card vs CPU)")
    fleet_launches = sharded_fleet(torch, dev, card)
    lap("phase 18 (the sharded actor-learner fleet)")
    layout_launches = lm_layout(torch, dev, card, trained)
    lap("phase 19 (the LM layout: the mesh's training step, the MoE "
        "dispatch)")
    audit_launches = analysis_gate(card)
    lap("phase 20 (the static analysis: lint and trace audit)")
    cell = start_production_cell()
    forecasts = start_remat_forecasts(torch, dev)
    try:
        dry_run_launches = dry_run_gate(torch, dev, card)
        lap("phase 21 (the dry run against the card)")
        t22 = time.perf_counter()
        remat_launches = remat_against_plain(torch, dev, card, trained)
        # phase 23 starts from them again; the card is phase 22's
        trained = tree_map(lambda t: t.cpu(), trained)
        train_4k_step(torch, dev, card, remat_launches, t22, forecasts)
        lap("phase 22 (remat: on against off, a train_4k-length step)")
        stop(forecasts[0])
        laid_out_launches = laid_out_gate(torch, dev, card, trained)
        lap("phase 23 (the laid-out training step)")
        finish_production_cell(*cell)
        lap("phase 21's production cell, after phase 23")
        serving_launches = serving_layout_gate(torch, dev, card, trained)
        del trained
        lap("phase 24 (the dense family's serving layout)")
    finally:
        stop(cell[0])
        stop(forecasts[0])

    kdir = "src/repro_torch/kernels"
    source = {"qmac_i8": f"{kdir}/qmac/csrc/qmac.cu",
              "qmac_i8_deq": f"{kdir}/qmac/csrc/qmac.cu",
              "qconv_i8_taps": f"{kdir}/qconv/csrc/qconv.cu",
              "vact_ew": f"{kdir}/vact/csrc/vact.cu",
              "vact_ew_q8": f"{kdir}/vact/csrc/vact.cu",
              "vact_softmax": f"{kdir}/vact/csrc/vact.cu",
              "qlstm_cell": f"{kdir}/qlstm/csrc/qlstm.cu"}
    replaces = {"qmac_i8": "src/repro/kernels/qmac/qmac.py:62",
                "qmac_i8_deq": "src/repro/kernels/qmac/qmac.py:84",
                "qconv_i8_taps": "src/repro/kernels/qconv/qconv.py:66",
                "vact_ew": "src/repro/kernels/vact/vact.py:86",
                "vact_ew_q8": "src/repro/kernels/vact/vact.py:103",
                "vact_softmax": "src/repro/kernels/vact/vact.py:123",
                "qlstm_cell": "src/repro/kernels/qlstm/qlstm.py:52"}
    out = []
    for name, shapes in rows.items():
        r = shapes[0]                      # the largest call of the path
        by_path = {"serving": serve_launches[name],
                   "hrl": hrl_launches[name],
                   "training": train_launches[name],
                   "hrl_training": pixel_launches["hrl_training"][name],
                   "pixel_training": pixel_launches["pixel_training"][name],
                   **{run: value_launches[run][name] for run in VALUE_RUNS},
                   "value_serving": vserve_launches[name],
                   "lm_serving": lm_launches[name],
                   "whisper_serving": whisper_launches[name],
                   "mamba_serving": ssm_launches[SSM_ARCH][name],
                   "recurrentgemma_serving": ssm_launches[HYBRID_ARCH][name],
                   "moe_serving": moe_launches[name],
                   "lm_training": lm_train_launches[name],
                   "sharded_fleet": fleet_launches[name],
                   "lm_layout": layout_launches[name],
                   "trace_audit": audit_launches[name],
                   "dry_run": dry_run_launches[name],
                   "remat": remat_launches[name],
                   "lm_laid_out": laid_out_launches[name],
                   "lm_laid_out_serving": serving_launches[name]}
        extra = {}
        if name == "qmac_i8_deq":
            # the batched product is the same kernel with the experts in
            # its grid: its launches count in this row, by path
            paths = {"serving": serve_launches, "hrl": hrl_launches,
                     "training": train_launches,
                     **pixel_launches, **value_launches,
                     "value_serving": vserve_launches,
                     "lm_serving": lm_launches,
                     "whisper_serving": whisper_launches,
                     "mamba_serving": ssm_launches[SSM_ARCH],
                     "recurrentgemma_serving": ssm_launches[HYBRID_ARCH],
                     "moe_serving": moe_launches,
                     "lm_training": lm_train_launches,
                     "sharded_fleet": fleet_launches,
                     "lm_layout": layout_launches,
                     "trace_audit": audit_launches,
                     "dry_run": dry_run_launches,
                     "remat": remat_launches,
                     "lm_laid_out": laid_out_launches,
                     "lm_laid_out_serving": serving_launches}
            bmm = {path: c.get("qmac_i8_deq_bmm", 0)
                   for path, c in paths.items()}
            by_path = {path: v + bmm[path] for path, v in by_path.items()}
            extra["qmac_i8_deq_bmm_launches_by_path"] = bmm
        launches = sum(by_path.values())
        out.append({"name": name, "route": "cuda", "source": source[name],
                    "replaces": replaces[name], "launches": launches,
                    "launches_by_path": by_path, **extra,
                    "max_abs_err": worst[name], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "shape": r["shape"],
                    "shapes": shapes})
        print(f"{name}: launches {launches} {by_path}, kernel_ms "
              f"{r['ms']:.5f}, plain_ms {r['plain_ms']:.5f}, library_ms "
              f"{r['library_ms']} at {r['shape']} on {card}")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
