#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its results; any failure exits non-zero:

1. Device: the card's name, the device count, and nvidia-smi's name and
   power limit. No CUDA device is a failure.
2. Build: every kernel under ``src/repro_torch/kernels/csrc/`` with nvcc for
   sm_90a, one nvcc per source, all started together, then each loaded,
   with the nvcc and load times and the ``-Xptxas -v`` register and
   shared-memory report. Then the seeded draw: ``layers._dense_init``
   fills a stack of layers a part of at most one layer at a time, and
   must give one stacked f32 draw's numbers bit for bit, and its generator
   offset, at the served stacks' shapes, so every phase's seeded weights
   are a stacked draw's.
3. Kernel check of greedy_sample against its plain PyTorch version on the
   card, exactly, at the serving path's shapes, on adversarial rows and on
   ties and NaNs straddling the chunk boundaries of its cluster split, each
   call printing its cluster size; then its time at B = 1, 4 and 64, the
   plain version's, the PyTorch library call's, top_k(x, 1)'s and its
   bound, and its time at each cluster size the card places.
3b. decode_attention on the card at every head width and group count the
   port decodes with (and the reduced configurations' D 16, G 2), one
   shared position and one a row (0, T - 1 and past T among them), on
   caches of 300 rows (three slices and their merge) and 100 (one), at the
   engine's shape (qwen2-0.5b: B 4, Hkv 2, G 7, D 64, T 512, four slices)
   and at phi4-mini's served cells (B 128, T 1,152 at positions 575 and
   1,151; B 256, T 256 at 255): each call within
   test_torch_decode_attention.py's tolerance of the plain version and
   within ``ref.decode_attention_f64``'s limit of a float64 computation,
   both versions' distance from the latter printed; then timed by CUDA
   graph at the served cells beside the plain version and its bound (the
   attended K/V rows, q and the output, once). The record's ``launches``
   are the main path's (4).
4. Main path: full-width qwen2-0.5b with seeded weights, served by
   ``ServingEngine(sampling="fused")`` (8 requests), with the kernels' launch
   counts read just after; then the same requests with ``sampling="host"``,
   whose token streams must be bit-identical.
5. Full-width numerics: ``forward`` logits against teacher-forced
   ``decode_step`` logits (B = 2, S = 16), at test_decode_parity's
   tolerances with top-1 held.
6. Serve loop: ``repro_torch.launch.serve.serve`` at its command's
   defaults (batch 4, 64 steps, cache 256, fuse 8) in its three modes,
   and fused once more at fuse 1, each printing ms per step and tokens/s
   by wall clock, device ms per step by CUDA events around the timed loop,
   and its greedy_sample launches (fused: captured per graph times
   replays); fused also prints its graphs and their capture time.
   Sequential and concurrent ids must be bit-identical, and so must fused
   at fuse 1 (the sequential schedule); fused at fuse 8 must give the ids
   of the same schedule run eagerly; every mode must launch greedy_sample
   once per produced step, and fused must replay graphs.
6b. int8 KV: the same weights with ``cache_quant="int8"``:
   ``quantize_kv``/``dequantize_kv`` on the card bit for bit the CPU
   port's on seeded (4, 1, 2, 64) rows with a zero head, a head under the
   1e-8 scale floor and exact .5 ties; teacher-forced int8 decode against
   bf16 decode (B = 2, S = 16) at test_serving.py's bounds (top-1 >= 0.95,
   a flip where bf16's two logits lie within the position's largest
   int8-bf16 difference counting as agreeing; rtol 0.2, atol 0.5), the
   raw top-1 and each flip printed; one masked fused decode step under
   ``set_sync_debug_mode("error")``, after which the masked row's ``k``,
   ``v``, ``k_scale`` and ``v_scale`` must be bit-identical; the serving
   engine (4 slots, prefill chunk 8; 4 requests of 16-32 seeded tokens, 16
   new tokens) fused then host-sampled, bit-identical, with greedy_sample
   once per fused decode launch (counted from 0 just before the fused run
   and read just after); the serving loop's modes as in 6, the fused one
   profiled and printed beside the bf16 fused step; the
   cache's bytes under 0.65x bf16's. The record's ``launches_int8`` are
   this engine run's greedy_sample launches.
6c. Chunked attention: qwen2-0.5b's ``forward`` at B = 1, S = 4,096 with
   ``attn_chunk`` 512 against 0, each timed by CUDA events with its peak
   memory, held to each other at test_perf_features.py's tolerance (rtol
   0.05, atol 0.1).
7. Kernel check of matmul, configured_matmul, flash_attention and top_k,
   each against its plain version at its stated tolerance, at the
   calibration ladder's shapes, at qwen2-0.5b's widths and on adversarial
   inputs, then timed as in 3. matmul and flash_attention print the route
   each call took (wgmma, pipelined or simt, by the wrappers' per-route
   counters), are checked on every route, and must take wgmma for bf16 at
   qwen2-0.5b's widths; a position-coded bf16 product must come out
   exactly. Their SIMT kernels are timed beside the new routes. Each SIMT
   flash_attention call prints its plan (keys split across a cluster) and
   staging, and each f32 one its error and the plain version's against
   float64 (the kernel's may not pass twice the plain version's); every
   calibration-ladder shape is timed in f32 beside SDPA, and the served
   shape at every split.
   configured_matmul prints its route (wgmma for aligned int8, simt
   otherwise), must take wgmma for int8 at qwen2-0.5b's width, must give a
   position-coded int8 product exactly, and must equal the float64 answer
   exactly at K = 4096 with full-range zero points; it is timed beside
   torch.matmul on centred f32 operands and torch._int_mm. top_k prints the
   number of blocks each row is split into, is checked at B = 1, 4 and 64,
   on ties and NaNs across chunk boundaries and on a row off 16-byte
   alignment, and is timed at k = 1, 8 and 64, by device time alone at
   k = 2 to 32, and at B = 1 and 64 beside torch.topk.
8. Calibration path: ``repro_torch.engine.calibrate.run_calibration`` over
   the full shape ladder on the card, each fit and sample printed beside the
   sample's device time, with the matmul, flash_attention and greedy_sample
   launch counts read just after (f32 flash_attention all staged by
   cp.async, the ladder's sampling rows all whole).
9. Ops path: ``kernels.ops.configured_matmul_op`` on int8 operands at
   qwen2-0.5b's MLP width and ``kernels.ops.top_k_op`` on the served
   model's last-position logits, the only entry points of those two
   kernels, and ``matmul_op`` and ``attention_op`` in bf16 at qwen2-0.5b's
   widths (the wgmma routes, which the calibration's f32 does not run),
   with their launch counts read just after; the int8 product must take
   configured_matmul's wgmma route.
10. Closed-loop bridge: ``repro_torch.bridge`` at the serving-bridge
   benchmark's first cell (``benchmarks/serving_bridge.py``): 6 tenants of
   full-width qwen2-0.5b (one set of seeded weights, a KV cache of 4 slots
   × 64 each, three prompts, 10 new tokens, prefill chunk 8) on a cluster
   model of 2 hosts with one OpenGeMM each over a NoC, first run
   standalone and then bridged in four arms: sticky affinity, round-robin,
   host sampling under affinity, prefill chunk 1 under affinity. Each arm
   prints, measured on the card, its wall, tokens/s, ms a launch,
   decode-only step median and the host time outside the engines; and,
   labelled as the OpenGeMM cycle model's, tokens/kcycle, p99 decode
   cycles, makespan, cycles a launch and config bytes sent and elided.
   Every arm's tokens must equal the standalone engines', config parity
   must hold for every tenant of the sticky arms, and greedy_sample must
   launch once per fused decode launch (counted from 0 for each arm); the
   record's ``launches_bridge`` sums the fused arms.
10b. Doctor: the sticky affinity arm of 10 twice more, each under its own
   ``repro_torch.obs.Tracer``, with serialized and with overlapped config
   staging (``phase_doctor``). Each prints the card's wall, tokens/s
   against the untraced arm's, host ms a launch outside the engines and
   its greedy_sample launches, and the model's makespan, exposed config
   cycles, bytes, tokens/kcycle, attribution residual, trace events and
   live regime. Each arm's tokens must equal the standalone engines', its
   attribution be conserved and its trace valid, greedy_sample launch once
   per fused decode launch (counted from 0 just before each arm), and the
   serialized arm's makespan, bytes and tokens/kcycle equal the untraced
   affinity arm's. The traces go to ``doctor_traces/`` beside this script,
   where ``python -m repro_torch.obs.doctor SERIALIZED --against
   OVERLAPPED --json OUT`` runs in a subprocess (its transcript printed):
   it must exit 0, give the live serialized report's regime and a diff
   whose makespan delta is the two reports'. The directory is deleted at
   the end. The record's ``launches_doctor`` are this phase's
   greedy_sample launches.
10c. Compiler: ``evaluate_levels`` of the port's copy of the paper's
   compiler over the OpenGeMM tiled matmul at K = 16-256 and the Gemmini
   one at K = 16-512, each speedup and geomean printed (model cycles),
   held to the paper's bands (OpenGeMM 1.7-2.6 with a maximum of at least
   2.2, Gemmini 1.04-1.20).
11. MoE: phi3.5-moe-42b-a6.6b at its published widths cut to 16 of its 32
   layers (42.14 GB of bf16 weights, seeded on the card; all 32 would not
   fit), after the qwen2-0.5b model is freed. top_k exactly against its
   plain version at the router's shapes ((4, 16) and (16, 16) f32, k = 2,
   and exact ties, where the lowest expert index must win), timed at
   (4, 16) beside torch.topk; one masked fused decode step under
   ``torch.cuda.set_sync_debug_mode("error")``; ``forward`` against
   teacher-forced ``decode_step`` at drop-free capacity, every router call
   recorded (``_decode_parity``, 11a); the serving engine
   (4 requests of 16-32 seeded tokens, 16 new tokens, 4 slots × 512,
   prefill chunk 8) fused then host-sampled, with bit-identical streams,
   greedy_sample once per fused decode launch and top_k 16 times an eager
   step (prefill steps included), counted from 0 just before each run and
   read just after; its tokens/s, decode-only step and peak memory; then
   the serving loop's three modes as in 6 (batch 4, 32 steps, fuse 8),
   the fused mode profiled. The model is freed at the end. The record's
   top_k ``launches`` are this path's (``launches_ops``: the ops path's),
   and its ``router_*`` keys the router shape's times and bound.
11a. Forward against teacher-forced decode (``_decode_parity``, B = 8,
   S = 8, on the model's device), decided by evidence no weight draw
   decides: decode with its batch padded to the forward's 64 product rows
   equals the forward bit for bit (a hybrid's forward runs its Mamba
   layers in decode's formulation for this, and its first Mamba layer's
   associative scan is held to the steps in f32 within ``MAMBA_F32_TOL``
   of the output's scale); at 8 rows the decode's largest distance from
   an f32 forward (weights cast up a layer at a time, experts a few at a
   time) within ``F32_RATIO`` times the bf16 forward's, over the positions
   before each row's first routing divergence; each route the bf16 paths
   part first in its row at a near-tie (its k-th/(k+1)-th margin within
   twice the largest probability gap before any parting). Top-1 agreement
   and test_decode_parity's tolerance fractions are printed, not decided.
   ``parity_sweep.py`` runs it over 22 weight draws, and with ``--mutate``
   under each decode fault of ``fault`` it must catch.
12. SSM: rwkv6-7b whole (32 of 32 layers at its published widths, 15.04 GB
   of bf16 weights seeded on the card), after the MoE model is freed, with
   the parameter count read from the tree. greedy_sample exactly against
   its plain version at the head's shapes, (4, 65536) and (1, 65536) bf16,
   as in 13 (``_head_greedy_check``), then timed at both
   beside torch.argmax and its bound; ``forward`` against teacher-forced
   ``decode_step`` as in 11a; one
   masked fused decode step under ``set_sync_debug_mode("error")``, after
   which the masked row's ``s``, ``shift_tm`` and ``shift_cm`` must be
   bit-identical; the serving engine (4 requests of 16-32 seeded tokens, 16
   new tokens, 4 slots, prefill chunk 8) fused then host-sampled, with
   bit-identical streams and greedy_sample once per fused decode launch,
   counted from 0 just before the fused run and read just after; the
   serving loop's three modes as in 6 (batch 4, 64 steps, fuse 8), the
   fused mode profiled and its step set beside the bound of reading the
   weights once and the state twice; peak memory and the phase's seconds.
   The record's ``launches_ssm`` are this path's greedy_sample launches,
   its ``*_ssm`` keys the (4, 65536) times and bound.
12b. The configurations one card cannot hold whole, at their published
   widths cut in depth (``CUTS``), each after the last is freed:
   jamba-1.5-large-398b (``[hybrid]``) as one group of n_layers =
   attn_period = 4 (attention with its dense MLP, then Mamba+MoE,
   Mamba+MLP, Mamba+MoE; 22,970,204,160 parameters, 45.94 GB) and
   kimi-k2-1t-a32b (``[kimi-k2]``) as 1 of its 61 layers (384 experts top-8,
   head_dim 112; 19,378,616,320 parameters, 38.76 GB). Each prints the cut
   and the count, then: greedy_sample at the head's shapes as in 13
   ((4, 65536), (4, 163840)); top_k at kimi-k2's router, (4, 384) and
   (16, 384) f32 at k = 8 and on ties, timed at (4, 384) beside torch.topk
   (jamba's (4, 16) k = 2 is [moe]'s); the seeded draw on the card and its
   peak memory; 11a; one masked fused decode step under
   ``set_sync_debug_mode("error")``, after which the masked row's cache
   leaves (a hybrid's ``h``/``conv`` too) are bit-identical; the serving
   engine (4 requests of 16-32 seeded tokens, 16 new tokens) fused then
   host-sampled, with bit-identical streams, greedy_sample once per fused
   decode launch and top_k once per router an eager step, counted from 0
   just before the fused run and read just after; for the hybrid, at
   drop-free capacity, the same prompts twice over the 4 slots, each copy
   in a slot its original freed giving its original's stream (a fresh
   Mamba state); the serving loop's three modes as in 6 (batch 4, 32
   steps, fuse 8), the fused step beside the bound of reading the weights
   once (every expert: the reference computes every expert's buffer);
   one eager fused decode step profiled; peak memory and the phase's
   seconds. The record's ``launches_hybrid``/``launches_kimi`` are these
   paths' greedy_sample and top_k launches, ``*_kimi`` keys the
   (4, 163840) head's and ``router_kimi_*`` the (4, 384) router's times.
13. Encoder-decoder: whisper-medium whole (24 encoder and 24 decoder
   layers at its published widths, 758,002,688 parameters, 1.52 GB of bf16
   weights seeded on the card), after the kimi-k2 model is freed, with the
   parameter count read from the tree. greedy_sample exactly against its
   plain version at the head's shapes, (4, 51865) and (1, 51865) bf16, on
   random rows, on ties and NaNs straddling the chunk boundaries of the
   plan it takes there, and with the maximum in the scalar head and in the
   scalar tail of each row (a row is 103,730 B, so row r starts 2r bytes
   past a 16-byte boundary; the one row of B = 1 is laid 2 bytes past
   one), printing each row's chunk addresses, then timed at both beside
   torch.argmax and its bound; the encoder over 4 seeded 30 s windows
   (1,500 frames each) timed by CUDA events beside its operations bound,
   with its peak memory, and profiled (its six costliest device operations
   printed); the encoder with ``attn_chunk`` 512 (chunks of 500 frames)
   against 0, each timed with its peak memory, at test_decode_parity's
   tolerance; the cross K/V of each window (each decoder layer's
   ``cross_attn.wk``/``wv`` of the encoder output); ``forward`` against
   teacher-forced ``decode_step`` as in 5 (B = 2, S = 16, at
   test_decode_parity's tolerances), over the cross K/V of the same frames; one decode step over the 4 windows whose logits must follow
   each slot's window (two slots' windows swapped swap their rows bit for
   bit, zero windows give other rows); one masked fused decode step under
   ``set_sync_debug_mode("error")``, after which the masked row's
   ``k``/``v`` and every ``xk``/``xv`` byte must be bit-identical and
   every leaf at its address; the serving engine (4 requests of 4-32
   seeded tokens and a copy of each, 32 new tokens, 4 slots x 448,
   prefill chunk 8, each request carrying its window, which admission
   writes into its slot; each copy lands in a slot whose last window was
   another's) fused then host-sampled, with bit-identical streams,
   greedy_sample once per fused decode launch, counted from 0 just before
   the fused run and read just after, and each copy's decode logits equal
   to its original's bit for bit; one eager fused decode step profiled
   (device ops, busy ms, the six costliest kernels and the eight costliest
   operators by input shapes; no operator but ``bmm`` may read a
   window-sized tensor, so nothing copies ``xk``/``xv``) beside the bound
   of reading the decoder, the tied head, the cross K/V and the KV rows up
   to the step's position once; peak memory and the phase's seconds. The
   record's ``launches_encdec`` are this path's greedy_sample launches, its
   ``*_encdec`` keys the (4, 51865) times and bound.
14. Vision-language: phi-3-vision-4.2b whole (32 layers at its published
   widths, 3,821,079,552 parameters, 7.64 GB of bf16 weights seeded on the
   card), after the whisper model is freed. greedy_sample at the head's
   shapes, (4, 32064) and (1, 32064) bf16, as in 13; ``forward`` over a
   seeded (2, 576, 3072) image prefix and 8 tokens: (2, 8, 32064) finite
   logits, moved by a second prefix (printed by how much), and equal bit
   for bit to the dense trunk of the same weights over the prefix rows and
   the tokens with the prefix dropped before the head; the text backbone's
   ``forward`` (an empty prefix) against teacher-forced ``decode_step`` as
   in 5; the serving engine (4 requests of 16-32 seeded tokens, 16 new
   tokens, 4 slots x 512, prefill chunk 8, no image, as the reference
   serves a vlm) fused then host-sampled, with bit-identical streams and
   greedy_sample once per fused decode launch, counted from 0 just before
   the fused run and read just after; one eager fused decode step at B = 4,
   position 128, profiled (its six costliest device operations) beside the
   bound of reading the weights and the K/V rows up to its position once.
   The record's ``launches_vlm`` are this path's greedy_sample launches,
   its ``*_vlm`` keys the (4, 32064) times and bound.
15. Dense: phi4-mini-3.8b (tied head, vocab 200,064), minitron-4b (GELU
   MLP, vocab 256,000) and qwen2.5-32b (QKV bias, 65.53 GB), each whole and
   seeded, one after another, each freed before the next. For each,
   greedy_sample at the head's shapes as in 13 (a cluster of 16 at B = 4,
   chunks of 12,504, 16,000 and 9,504); the draw's seconds and peak
   memory (qwen2.5-32b's predicted peak printed beside the card's memory);
   ``launch.serve.serve`` at the command's defaults fused at fuse 8, with
   its ids equal to the same schedule run eagerly, and sequential at 16
   steps, each with greedy_sample once per produced step; the fused step
   set beside the bound of reading the weights and the K/V rows once. Then
   qwen2.5-32b over an int8 cache (``cache_quant="int8"``) of 24,576 rows
   at B = 4, whose bf16 cache (25.77 GB) would not fit beside the weights:
   the free memory and both caches' sizes printed, the serving loop fused
   at fuse 8 with its ids equal to the eager schedule's and greedy_sample
   once per produced step, its peak memory and fused step beside the
   function's bound (the weights and the int8 cache once) and the
   reference formulation's (the whole cache dequantized to bf16 besides),
   then one eager decode step profiled (the six costliest device
   operations).
   The record's ``launches_dense`` sum the three fused runs' greedy_sample
   launches (``launches_<model>`` each), its ``*_<model>`` keys each
   head's times and bound.
16. Training: paper-lm-100m whole (12 layers at its published widths,
   124,668,672 parameters read from the tree, seeded on the card), after
   the dense models are freed. Its loss and every gradient leaf on the
   card against the port on the CPU over the same weights and one seeded
   batch (B = 1, S = 64; loss within 2e-3 relative, each leaf within 5e-2
   relative L2, each printed); one train step at B = 8, S = 1,024 for each
   ``remat`` (none, dots, full) and ``attn_chunk`` (0, 512) after a
   warm-up, with its CUDA-event ms and peak memory, the losses equal
   across remat settings and the gradients bit for bit ``none``'s where two
   ``none`` steps are (else within twice their distance);
   ``repro_torch.launch.train`` at the
   reference driver's defaults (100 steps, batch 8, seq 256, lr 3e-4,
   warm-up 20), whose loss must fall, with ms a step by wall clock and by
   CUDA events, tokens/s, the bound of 6·N·tokens at the bf16 peak and
   peak memory; one train step profiled (device ops, busy ms, the six
   costliest kernels) and timed by CUDA events over 10 eager steps; 20
   steps run straight twice (bit for bit), then under
   ``TrainSupervisor(ckpt_every=8)`` with a fault before the first
   checkpoint and one after it, whose final parameters and optimizer
   state must equal the straight run's bit for bit (no process-wide
   determinism switch is set); the last checkpoint restored into a fresh
   tree (equal to the trained state bit for bit); greedy_sample at the
   head's shapes, (4, 32000) and (1, 32000) bf16, as in 13; the serving
   engine over the restored weights (4 requests of 16-32 seeded tokens,
   16 new tokens) fused then host-sampled, with bit-identical streams and
   greedy_sample once per fused decode launch, counted from 0 just before
   the fused run and read just after. The record's ``launches_train`` are
   this path's greedy_sample launches, its ``*_train`` keys the
   (4, 32000) times and bound.

17. Distribution (``phase_distributed``): a one-rank NCCL group and
   ``launch.mesh.make_host_mesh()``, a 1x1 ("data", "model") mesh, each
   model's arguments placed by ``repro_torch.distributed``'s rules as
   DTensors and run under ``distributed.sharded``, against the same model
   unsharded, bit for bit: paper-lm-100m whole, one train step at B = 8,
   S = 256 with gradient compression off and ``"bf16"`` (the loss and every
   parameter and optimizer-state leaf); qwen2-0.5b whole, 8 fused
   ``decode_and_sample`` steps and 8 teacher-forced decode steps (4
   slots, a 64-row cache; ids and logits), greedy_sample once a sharded
   step; phi-3.5-MoE at its published widths, 2 of 32 layers, a forward
   at (2, 16) tokens with ``moe_impl="shard_map"`` through the expert
   all-to-all over the NCCL group (two ``all_to_all_single`` a layer,
   counted by ``CommDebugMode``) against the one-device path (logits and
   aux loss), the router's top_k once a layer. Each pair's seconds, the
   phase's seconds and its peak memory are printed. The record's
   ``launches_distributed`` are these greedy_sample and top_k launches.

18. The one distribution plan (``phase_dryrun``): ``python -m
   repro_torch.launch.dryrun`` in processes of their own (its ``fake``
   process group must not meet the NCCL group of 17), under this
   machine's torch, on the ``DRYRUN_CELLS``: qwen2-0.5b prefill_32k on the
   2x16x16 mesh and whisper-medium decode_32k on the 16x16 one. Each must
   trace (``status: ok``) with the count of each collective and the FLOPs
   ratio that ``tests/test_torch_dryrun.py`` pins under the CPU tests'
   torch: the plan is one, whatever the torch.

Float32 products run in full float32 throughout: TF32 is switched off for
both matmul and cuDNN, so the plain versions are exact f32 references.

The last lines are the kernels' JSON record, nvidia-smi's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12  # f32 outside the tensor cores
BF16_FLOPS = 989e12  # dense, tensor cores
INT8_OPS = 1979e12  # dense, tensor cores
QWEN_M, QWEN_D, QWEN_FF, QWEN_V = 512, 896, 4864, 151_936  # 512 tokens through the MLP up-projection
SEED = 0
N_REQUESTS = 8
MAX_NEW = 32
PARITY_RTOL, PARITY_ATOL, PARITY_TOP1 = 0.05, 0.15, 0.9  # test_decode_parity's
# forward vs decode at B = 2 rows (_decode_parity): each bf16 path's largest distance from
# an f32 forward. Over 22 draws of each family, twice (PERF.md §6), correct decodes lay
# 0.56-1.55x as far as the forward (the hybrid's Mamba state the widest); a fault, 3-50x
F32_RATIO = 2.0
# the [dryrun] phase's cells and their plan, pinned by tests/test_torch_dryrun.py too:
# (arch, shape, multi-pod) -> each collective's count and hlo_flops / model_flops
DRYRUN_CELLS = {
    ("qwen2-0.5b", "prefill_32k", True): ({"all-gather": 72, "all-reduce": 49}, 46.64441800400476),
    ("whisper-medium", "decode_32k", False): ({"all-gather": 9289, "all-reduce": 73},
                                              36.59224064433404),
}
PARITY_ROWS = 8  # B of the forward-vs-decode check: 8 rows of 8 positions
MAMBA_F32_TOL = 1e-4  # mamba_apply against mamba_step in f32, of the output's largest |y|
FAULTS = ("kv_row", "state")  # the decode faults _decode_parity must catch
SERVE_BATCH, SERVE_STEPS, SERVE_CACHE, SERVE_FUSE = 4, 64, 256, 8  # python -m repro_torch.launch.serve's defaults
# the serving-bridge benchmark's first cell (benchmarks/serving_bridge.py)
BRIDGE_TENANTS, BRIDGE_HOSTS, BRIDGE_SLOTS, BRIDGE_MAX_LEN, BRIDGE_MAX_NEW = 6, 2, 4, 64, 10
# the [moe] phase: phi-3.5-MoE at its published widths, 16 of its 32 layers
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 16
MOE_REQUESTS, MOE_PROMPT, MOE_NEW = 4, (16, 33), 16  # prompts of 16-32 seeded tokens
MOE_STEPS, MOE_CACHE = 32, 64  # launch.serve: batch and fuse as the command's defaults
# the [ssm] phase: rwkv6-7b whole, at its published widths and depth
SSM_ARCH, SSM_V = "rwkv6-7b", 65_536
SSM_REQUESTS, SSM_PROMPT, SSM_NEW = 4, (16, 33), 16  # prompts of 16-32 seeded tokens
# the [hybrid] and [kimi-k2] phases: a configuration one card cannot hold whole, every width
# as published and its depth cut: jamba-1.5-large-398b to one group of n_layers =
# attn_period = 4 (attention with its dense MLP, then Mamba+MoE, Mamba+MLP, Mamba+MoE),
# kimi-k2-1t-a32b to 1 of its 61 layers; (arch, tag, cut, the record's key suffix)
CUTS = (("jamba-1.5-large-398b", "[hybrid]", {"n_layers": 4, "attn_period": 4}, "hybrid"),
        ("kimi-k2-1t-a32b", "[kimi-k2]", {"n_layers": 1}, "kimi"))
CUT_REQUESTS, CUT_PROMPT, CUT_NEW = 4, (16, 33), 16  # prompts of 16-32 seeded tokens
CUT_STEPS, CUT_CACHE = 32, 64  # launch.serve: batch and fuse as the command's defaults
# the [encdec] phase: whisper-medium whole, at its published widths and depth
ENCDEC_ARCH, ENCDEC_V = "whisper-medium", 51_865
ENCDEC_REQUESTS, ENCDEC_PROMPT, ENCDEC_NEW = 8, (4, 33), 32  # prompts of 4-32 seeded tokens
ENCDEC_SLOTS, ENCDEC_MAX_LEN = 4, 448  # whisper's max_target_positions
# the [vlm] phase: phi-3-vision-4.2b whole, at its published widths and depth
VLM_ARCH, VLM_V = "phi-3-vision-4.2b", 32_064
VLM_REQUESTS, VLM_PROMPT, VLM_NEW = 4, (16, 33), 16  # prompts of 16-32 seeded tokens
VLM_AT = 128  # the position of the profiled decode step
# the [dense] phase: the reference's other single-card dense configurations, whole,
# each with its tag (the record's key suffix) and its published (layers, d_model, d_ff, vocab)
DENSE_ARCHS = (("phi4-mini-3.8b", "[phi4-mini]", (32, 3072, 8192, 200_064)),
               ("minitron-4b", "[minitron]", (32, 3072, 9216, 256_000)),
               ("qwen2.5-32b", "[qwen2.5-32b]", (64, 5120, 27648, 152_064)))
DENSE_SEQUENTIAL_STEPS = 16
# the [train] phase: paper-lm-100m whole, at python -m repro_torch.launch.train's defaults
TRAIN_ARCH, TRAIN_V = "paper-lm-100m", 32_000
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 100, 8, 256
TRAIN_CHECK = (1, 64)  # (B, S) of the card-against-CPU loss and gradients
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 2e-3, 5e-2  # card against the CPU port
TRAIN_REPLAY = (20, 8, (3, 13))  # steps, checkpoint interval, the steps that fail
TRAIN_REQUESTS, TRAIN_PROMPT, TRAIN_NEW = 4, (16, 33), 16
FREED_SLACK = 1 << 30  # bytes a phase may leave allocated past what it found
# the [distributed] phase: a one-rank NCCL group on a 1x1 ("data", "model") mesh
DIST_TRAIN = (8, 256)  # (B, S) of the sharded train step: the train driver's batch
DIST_DECODE = (4, 64, 8)  # (B, cache rows, steps) of the sharded fused decode
DIST_MOE_LAYERS, DIST_MOE_TOKENS = 2, (2, 16)  # phi-3.5-MoE at published widths, 2 of 32 layers
# the [int8-kv] phase: tests/test_serving.py's int8-against-bf16 decode bounds and bytes ratio
INT8_TOP1, INT8_RTOL, INT8_ATOL, INT8_BYTES = 0.95, 0.2, 0.5, 0.65
INT8_REQUESTS, INT8_PROMPT, INT8_NEW = 4, (16, 33), 16  # prompts of 16-32 seeded tokens
TIES = (127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, -126.5)  # at a scale of 1
TIES_ROUNDED = [127, -127, 0, 2, 2, 0, -2, -2, 126, -126]  # half to even
# chunked attention: dryrun.optimized_policy's attn_chunk, the forward's length, and
# test_perf_features.py's chunked-against-plain tolerance
CHUNK, CHUNK_SEQ, CHUNK_RTOL, CHUNK_ATOL = 512, 4096, 0.05, 0.1
# qwen2.5-32b at an int8 cache of this many rows a slot (B = 4): its bf16 cache would not fit
QWEN32_INT8_ROWS = 24_576
# the [train] phase's remat table: B, S, and the settings
REMAT_BATCH, REMAT_SEQ, REMATS = 8, 1024, ("none", "dots", "full")
DOCTOR_ARMS = ("serialized", "overlapped")  # config staging of the traced affinity arms
BRIDGE_ARMS = (  # (arm, router policy, sticky, sampling, prefill chunk)
    ("affinity", "affinity", True, "fused", 8),
    ("round_robin", "round_robin", False, "fused", 8),
    ("host sampling", "affinity", True, "host", 8),
    ("prefill chunk 1", "affinity", True, "fused", 1),
)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _events_ms(run, reps: int) -> float:
    """Mean time of ``run`` over ``reps`` calls, by CUDA events around them."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, calls: int = 100, reps: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed, so the host's cost of issuing a call is off the
    clock (the small gap between two kernels of a graph stays on it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    _events_ms(graph.replay, 2)  # warm-up
    return _events_ms(graph.replay, reps) / calls


def _call_ms(fn, calls: int = 500) -> float:
    """Time per call of ``fn`` issued from Python one after another: the
    host's issue rate when it exceeds the device time."""
    _events_ms(fn, 50)  # warm-up
    return _events_ms(fn, calls)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[device] {name}; device_count={torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}")
    return name, smi


def _timed(label: str, runs: dict, bound_ms: float, bound_by: str, smi: str) -> dict:
    """Device time per call of each of ``runs`` (kernel ``ms``, ``plain_ms``,
    ``library_ms``) by CUDA graph, median of two rounds in alternating
    order; prints it beside the per-call issue time from Python."""
    times = {k: [] for k in runs}
    calls = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):  # in turns, both orders
        for k in order:
            times[k].append(_device_ms(runs[k]))
            calls[k].append(_call_ms(runs[k]))
    ms = {k: float(np.median(t)) for k, t in times.items()}
    call = {k: float(np.median(t)) for k, t in calls.items()}
    names = {"ms": "kernel_ms"}
    print(f"[kernel] {label}, device time per call (CUDA graph): "
          + " ".join(f"{names.get(k, k)}={v:.5f}" for k, v in ms.items())
          + f" bound_ms={bound_ms:.5f} ({bound_by}; {smi})")
    print(f"[kernel] {label}, per call issued from Python: "
          + " ".join(f"{names.get(k, k)}={v:.5f}" for k, v in call.items()) + f" ({smi})")
    return ms


def _bound_ms(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(name: str, source: str, replaces: str, err: float, ms: dict, bound: tuple,
            **extra) -> dict:
    """One kernel's entry in the JSON record; ``extra`` adds keys such as the
    wrapper's route (``path``) and the operands' type."""
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms["ms"],
            "plain_ms": ms["plain_ms"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": ms["library_ms"], **extra}


def _off_alignment(x: torch.Tensor) -> torch.Tensor:
    """The same values, contiguous, one element past a 16-byte boundary:
    the wrappers send such operands to their SIMT kernels."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _routed(wrapper, fn) -> tuple:
    """``fn()``'s result and the route its one launch took, by the wrapper's
    per-route counters."""
    before = dict(wrapper.launches_by_route)
    out = fn()
    moved = [r for r, n in wrapper.launches_by_route.items() if n != before[r]]
    if len(moved) != 1 or wrapper.launches_by_route[moved[0]] != before[moved[0]] + 1:
        raise SystemExit(f"one call launched {wrapper.launches_by_route} after {before}")
    return out, moved[0]


def phase_build() -> None:
    """Every kernel built (one ``nvcc`` each, all started together) and
    loaded: each ``[build]`` line gives the ``nvcc`` run's and the load's
    time from ``_build.builds()``."""
    from repro_torch.kernels import _build

    for b in _build.build_all(_build.kernel_names()):
        _build.load(b.name)
    for b in _build.builds():
        load_ms = (b.load_ns[1] - b.load_ns[0]) / 1e6
        print(f"[build] {b.name}: nvcc {b.seconds:.2f} s, load {load_ms:.1f} ms -> {b.path.name}")
        for line in b.log.splitlines():
            print(f"[build]   {line}")


def phase_seeded_draw() -> None:
    """``layers._dense_init`` draws a stack of layers a part at a time (no
    f32 scratch past one layer), with the numbers of one stacked f32 draw:
    checked bit for bit at shapes of the served models' stacks (two of
    them past 2**31 bytes of f32, which PyTorch draws in launches of
    halves), and the generator's offset after it, so every phase's seeded
    weights are those of a stacked draw."""
    import math

    from repro_torch.models import layers as L

    for shape, stack in (((4096, 4096), 16), ((4096, 14336), 16), ((13001, 13777), 3),
                         ((4096, 16), 16), ((1000, 999), 3), ((7, 5), 3)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        got, offset = L._dense_init(gen, shape, stack=stack), gen.get_offset()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        x = torch.randn((stack, *shape), generator=gen, device="cuda")
        same = torch.equal(got, (x * (1.0 / math.sqrt(shape[0]))).to(torch.bfloat16))
        print(f"[init] _dense_init stack={stack} of {shape}: equals one stacked f32 draw bit for "
              f"bit: {same}; generator offset {offset} (the stacked draw's {gen.get_offset()})")
        if not same or offset != gen.get_offset():
            raise SystemExit("a stacked draw made in parts is not the stacked f32 draw")
        del got, x
    torch.cuda.empty_cache()


def _adversarial(v: int, dtype: torch.dtype) -> torch.Tensor:
    rows = torch.full((6, v), -1.0, dtype=torch.float32)
    rows[0, [5, v // 2, v - 7]] = 3.0  # ties far apart: the lowest index wins
    rows[1, [v // 4, v // 4 + 1]] = 2.5  # adjacent tie
    rows[2, :] = 0.0  # all equal: index 0
    rows[3, v - 1] = 9.0  # winner in the last element
    rows[4, [3, v // 3]] = float("nan")  # first NaN wins over every number
    rows[4, 10] = float("inf")
    rows[5, :] = float("-inf")  # all -inf: index 0
    return rows.to(dtype).cuda()


def _across_cluster_chunks(b: int, v: int) -> torch.Tensor:
    """(b, v) rows of -1 whose ties and NaNs straddle every chunk boundary
    that ``plan_greedy_sample`` gives at that shape: row r takes pattern
    r % 4, a tie of 5 across each boundary, a NaN on each side, +inf on
    both sides, or zeros of both signs everywhere."""
    from repro_torch.kernels.sampling import plan_greedy_sample

    x = torch.full((b, v), -1.0, device="cuda")
    for start, _ in plan_greedy_sample(b, v).bounds(v)[1:]:
        x[0::4, start - 3:start + 3] = 5.0
        x[1::4, start - 1:start + 1] = float("nan")
        x[2::4, start - 2:start + 2] = float("inf")
    x[3::4] = 0.0
    x[3::4, ::7] = -0.0
    return x


def _cluster_of(fn) -> tuple:
    """``fn()``'s result and the cluster size its one greedy_sample launch
    took, by the wrapper's per-cluster counters."""
    from repro_torch.kernels.sampling import greedy_sample

    before = dict(greedy_sample.launches_by_cluster)
    out = fn()
    moved = [c for c, n in greedy_sample.launches_by_cluster.items() if n != before[c]]
    if len(moved) != 1:
        raise SystemExit(f"one call launched {greedy_sample.launches_by_cluster} after {before}")
    return out, moved[0]


def phase_kernel_check(smi: str) -> dict:
    """greedy_sample exactly against its plain version: random rows at B =
    1, 4, 8 and 64, adversarial rows, and ties and NaNs straddling the
    plan's chunk boundaries at B = 1, 4 and 64, in three types, each call
    printing its cluster size; then timed at B = 1, 4 and 64 beside
    torch.argmax and top_k(x, 1), and the cluster sizes 4, 8 and 16 probed
    at B = 1 and 4 where the card places them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import (GreedyPlan, greedy_sample, max_active_clusters,
                                              top_k)

    v = 151_936
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for b in (1, 4, 8, 64):
            cases.append((f"B={b} V={v} {dtype}", torch.randn(
                (b, v), generator=gen, device="cuda").to(dtype)))
        for vv in (v, v - 1, 1000, 151):  # v - 1 and 151: rows start unaligned
            cases.append((f"adversarial V={vv} {dtype}", _adversarial(vv, dtype)))
        for b in (1, 4, 64):
            cases.append((f"across cluster chunks B={b} V={v} {dtype}",
                          _across_cluster_chunks(b, v).to(dtype)))
    worst = 0
    for label, x in cases:
        got, cluster = _cluster_of(lambda: greedy_sample(x))
        want = ref.greedy_sample_ref(x)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        print(f"[kernel] greedy_sample {label}: cluster={cluster} max_abs_err={err}")
        if err:
            raise SystemExit(f"greedy_sample disagrees with its plain version on {label}: "
                             f"{got.tolist()[:8]} vs {want.tolist()[:8]}")

    timed, clusters = {}, {}
    for b in (4, 1, 64):
        x = torch.randn((b, v), generator=gen, device="cuda").to(torch.bfloat16)
        runs = {"ms": lambda: greedy_sample(x),
                "plain_ms": lambda: ref.greedy_sample_ref(x),
                "library_ms": lambda: torch.argmax(x, dim=-1),
                "top_k1_ms": lambda: top_k(x, 1)}
        bound = _bound_ms(x.numel() * x.element_size() + b * 4, 0.0, 1.0)
        _, cluster = _cluster_of(lambda: greedy_sample(x))
        clusters[b] = cluster
        timed[b] = (_timed(f"greedy_sample B={b} V={v} bf16, cluster of {cluster} (top_k1_ms: "
                           f"top_k(x, 1))", runs, *bound, smi), bound)
    places = {c: max_active_clusters(c) for c in (4, 8, 16)}
    print(f"[kernel] greedy_sample clusters the card holds at once, by size: {places}")
    for b in (1, 4):
        x = torch.randn((b, v), generator=gen, device="cuda").to(torch.bfloat16)
        probe = {}
        for c in (c for c, n in places.items() if n > 0):
            plan = GreedyPlan(c, -(-(-(-v // c)) // 8) * 8)
            if not torch.equal(greedy_sample(x, plan), ref.greedy_sample_ref(x)):
                raise SystemExit(f"greedy_sample with a cluster of {c} disagrees at B={b}")
            probe[c] = _device_ms(lambda: greedy_sample(x, plan))
        print(f"[kernel] greedy_sample B={b} V={v} bf16, device ms by cluster size: "
              + " ".join(f"{c}:{t:.5f}" for c, t in probe.items()) + f" ({smi})")
    ms, bound = timed[4]
    return _record("greedy_sample", "greedy_sample.cu", "src/repro/kernels/sampling.py:66",
                   worst, ms, bound, cluster=clusters[4], top_k1_ms=ms["top_k1_ms"],
                   ms_b1=timed[1][0]["ms"], library_ms_b1=timed[1][0]["library_ms"],
                   ms_b64=timed[64][0]["ms"], library_ms_b64=timed[64][0]["library_ms"])


DA_RTOL = DA_ATOL = 0.02  # test_torch_decode_attention.py's, and its reason


def _decode_attention_inputs(b: int, t: int, hkv: int, g: int, d: int, pos: torch.Tensor,
                             seed: int) -> tuple:
    """q, the K and V caches as layer views of a stacked cache, the new k and
    v, and the positions: a decode attention's arguments on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    stacked = {k: randn(2, b, t, hkv, d) for k in ("k", "v")}
    return (randn(b, 1, hkv * g, d), stacked["k"][1], stacked["v"][1], randn(b, 1, hkv, d),
            randn(b, 1, hkv, d), pos)


def check_decode_attention(smi: str) -> dict:
    """decode_attention against its plain version and within the float64
    computation's limit at every (D, G), at the engine's shape and at the
    served cells' shapes, then timed at the latter (3b)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attention import decode_attention, plan_decode_attention

    worst = {"err": 0.0, "share": 0.0}

    def gate(args, where: str) -> None:
        """One call held to the plain version within DA_RTOL, DA_ATOL and to
        float64 within ``ref.decode_attention_f64``'s limit."""
        got, want = decode_attention(*args), ref.decode_attention_ref(*args)
        exact, limit = ref.decode_attention_f64(*args)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        share, plain_share = (float(((x.double() - exact).abs() / limit).max())
                              for x in (got, want))
        b, t, hkv = args[1].shape[:3]
        print(f"[decode_attention] {where}, {plan_decode_attention(b, hkv, t, _build.sm_count(0))}"
              f": max_abs_err={err:.5f}; from float64: kernel {_max_err(got, exact):.5f} "
              f"({100 * share:.1f} % of the limit), plain {_max_err(want, exact):.5f} "
              f"({100 * plain_share:.1f} %)")
        if not torch.allclose(got.float(), want.float(), rtol=DA_RTOL, atol=DA_ATOL):
            raise SystemExit(f"decode_attention disagrees with its plain version at {where}")
        if share > 1:
            raise SystemExit(f"decode_attention lies past the float64 limit at {where}")
        worst["err"], worst["share"] = max(worst["err"], err), max(worst["share"], share)

    b = 5  # with 4 K/V heads: 3 slices of a cache of 300 rows, 1 of 100
    for d in (64, 96, 112, 128, 16):
        for g in (1, 3, 4, 5, 7, 8, 2):
            for t in (300, 100):
                for label, pos in (("shared", torch.full((b,), t // 2, device="cuda")),
                                   ("per row", torch.tensor([0, t - 1, t + 5, 31, 32],
                                                            dtype=torch.int32, device="cuda"))):
                    gate(_decode_attention_inputs(b, t, 4, g, d, pos, seed=d + g + t),
                         f"D={d} G={g} T={t} {label} positions")
    # the engine's (qwen2-0.5b's 4 slots of 512): 4 slices and their merge
    for label, pos in (("shared", torch.full((4,), 300, device="cuda")),
                       ("per row", torch.tensor([0, 511, 515, 200], device="cuda"))):
        gate(_decode_attention_inputs(4, 512, 2, 7, 64, pos, seed=7),
             f"B=4 Hkv=2 G=7 D=64 T=512 {label} positions")

    timed = {}
    for b, t, p in ((128, 1152, 575), (128, 1152, 1151), (256, 256, 255)):
        args = _decode_attention_inputs(b, t, 8, 3, 128, torch.full((b,), p, device="cuda"),
                                        seed=p)
        gate(args, f"B={b} Hkv=8 G=3 D=128 T={t} position {p}")
        nbytes = b * (p + 1) * 8 * 128 * 2 * 2 + 2 * b * 24 * 128 * 2 + b * 8
        bound = _bound_ms(nbytes, 4 * b * 24 * (p + 1) * 128, 989e12)
        ms, plain_ms = [], []
        for order in ("kernel", "plain"), ("plain", "kernel"):
            for which in order:
                if which == "kernel":
                    ms.append(_device_ms(lambda: decode_attention(*args), calls=50, reps=10))
                else:
                    plain_ms.append(_device_ms(lambda: ref.decode_attention_ref(*args),
                                               calls=5, reps=3))
        timed[(b, p)] = (float(np.median(ms)), float(np.median(plain_ms)), bound)
        print(f"[decode_attention] B={b} Hkv=8 G=3 D=128 T={t} position {p}, "
              f"{plan_decode_attention(b, 8, t)}, device time per call (CUDA graph): "
              f"kernel_ms={timed[(b, p)][0]:.5f} plain_ms={timed[(b, p)][1]:.5f} "
              f"bound_ms={bound[0]:.5f} ({bound[1]}: {nbytes} B at 3.35 TB/s) = "
              f"{100 * bound[0] / timed[(b, p)][0]:.1f} % of the bound ({smi})")
        del args
    torch.cuda.empty_cache()
    ms, plain_ms, bound = timed[(128, 1151)]
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "none: the JAX package leaves decode attention to XLA",
            "max_abs_err": worst["err"], "f64_limit_share": worst["share"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "ms_p575": timed[(128, 575)][0], "bound_ms_p575": timed[(128, 575)][2][0],
            "ms_b256": timed[(256, 255)][0], "plain_ms_b256": timed[(256, 255)][1],
            "bound_ms_b256": timed[(256, 255)][2][0]}


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    diff = (got.float() - want.float()).abs()
    both_nan = got.float().isnan() & want.float().isnan()
    return float(diff.masked_fill(both_nan, 0.0).max()) if diff.numel() else 0.0


def _issue_abba(label: str, wgmma, simt, smi: str) -> None:
    """Per-call issue time from Python of the two routes at a shape whose
    device time is well below it, so the difference is host time: the TMA
    maps the wgmma route encodes at each call. In turns (wgmma, simt, simt,
    wgmma), medians."""
    t = {"wgmma": [], "simt": []}
    for route, fn in (("wgmma", wgmma), ("simt", simt), ("simt", simt), ("wgmma", wgmma)):
        t[route].append(_call_ms(fn))
    print(f"[kernel] {label}, per call issued from Python: wgmma_ms="
          f"{np.median(t['wgmma']):.5f} simt_ms={np.median(t['simt']):.5f} ({smi})")


def _position_coded(m: int, k: int, n: int) -> tuple:
    """bf16 operands whose product is known exactly: A selects row
    sel(i) = (7 i + 3) mod K of B for row i of C (0/1 entries) and B holds
    the small integers 16 (k mod 16) + (n mod 16), exact in bf16. Every
    C[i, j] must equal B[sel(i), j], and a wrong value names the row and
    column of B it came from."""
    sel = (torch.arange(m, device="cuda") * 7 + 3) % k
    a = torch.zeros((m, k), device="cuda")
    a[torch.arange(m, device="cuda"), sel] = 1
    b = (torch.arange(k, device="cuda")[:, None] % 16 * 16
         + torch.arange(n, device="cuda")[None, :] % 16).float()
    return a.bfloat16(), b.bfloat16(), sel


def check_matmul(smi: str) -> list[dict]:
    """f32 at rtol 1e-4 (atol 1e-3: the rounding of <= 896-term f32 sums
    taken in another order), bf16 at test_matmul_matches_oracle's 2e-2, at
    the calibration ladder's shapes and at qwen2-0.5b's MLP width, each
    through the route the wrapper chooses, and once more off 16-byte
    alignment (the SIMT route); the position-coded bf16 product exactly.
    The qwen-width bf16 call must take the wgmma route."""
    from repro_torch.engine.calibrate import SHAPES
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for m, k, n in [*SHAPES["matmul"], (QWEN_M, QWEN_D, QWEN_FF), (130, 70, 33), (130, 72, 200)]:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-3)),
                           (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))):
            for off in (False, True):
                x, y = a.to(dtype), b.to(dtype)
                if off:
                    x = _off_alignment(x)
                got, route = _routed(matmul, lambda: matmul(x, y))
                want = ref.matmul_ref(x, y)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                print(f"[kernel] matmul ({m},{k})x({k},{n}) {dtype}{' off-aligned' if off else ''}:"
                      f" route={route} max_abs_err={err:.6g}")
                torch.testing.assert_close(got, want, **tol)
                if (m, k, n, dtype, off) == (QWEN_M, QWEN_D, QWEN_FF, torch.bfloat16, False) \
                        and route != "wgmma":
                    raise SystemExit(f"the qwen-width bf16 matmul took route {route}, not wgmma")
    for m, k, n in [(QWEN_M, QWEN_D, QWEN_FF), (128, 128, 128), (130, 72, 200), (5, 8, 8)]:
        a, b, sel = _position_coded(m, k, n)
        got, route = _routed(matmul, lambda: matmul(a, b))
        torch.cuda.synchronize()
        wrong = (got.float() != b[sel].float()).nonzero()
        for i, j in wrong[:8].tolist():
            v = int(got[i, j].float())
            print(f"[kernel]   C[{i},{j}] = {v}: from k % 16 = {v // 16}, n % 16 = {v % 16}; "
                  f"wanted k = {int(sel[i])} (k % 16 = {int(sel[i]) % 16}), n % 16 = {j % 16}")
        print(f"[kernel] matmul position-coded ({m},{k})x({k},{n}) bf16: route={route} "
              f"wrong={len(wrong)} of {m * n}")
        if len(wrong) or route != "wgmma":
            raise SystemExit("the position-coded bf16 product is not exact on the wgmma route")

    m, k, n = QWEN_M, QWEN_D, QWEN_FF
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    ab, bb = a.bfloat16(), b.bfloat16()
    ab_off, a_off = _off_alignment(ab), _off_alignment(a)
    bound16 = _bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n, BF16_FLOPS)
    ms16 = _timed(f"matmul ({m},{k})x({k},{n}) bf16 (route wgmma; simt_ms: the SIMT kernel)", {
        "ms": lambda: matmul(ab, bb), "plain_ms": lambda: ref.matmul_ref(ab, bb),
        "library_ms": lambda: torch.matmul(ab, bb), "simt_ms": lambda: matmul(ab_off, bb)},
        *bound16, smi)
    bound = _bound_ms(4 * (m * k + k * n + m * n), 2 * m * k * n, F32_FLOPS)
    ms = _timed(f"matmul ({m},{k})x({k},{n}) f32 (route pipelined; simt_ms: the SIMT kernel)", {
        "ms": lambda: matmul(a, b), "plain_ms": lambda: ref.matmul_ref(a, b),
        "library_ms": lambda: torch.matmul(a, b), "simt_ms": lambda: matmul(a_off, b)},
        *bound, smi)
    for mm_, kk, nn in SHAPES["matmul"]:
        x = torch.randn((mm_, kk), generator=gen, device="cuda")
        y = torch.randn((kk, nn), generator=gen, device="cuda")
        x_off = _off_alignment(x)
        print(f"[kernel] matmul ({mm_},{kk})x({kk},{nn}) f32 device ms: "
              f"pipelined={_device_ms(lambda: matmul(x, y)):.5f} "
              f"simt={_device_ms(lambda: matmul(x_off, y)):.5f} ({smi})")
    x = torch.randn((128, 128), generator=gen, device="cuda").bfloat16()
    x_off = _off_alignment(x)
    _issue_abba("matmul (128,128)x(128,128) bf16 (wgmma encodes 2 TMA maps a call)",
                lambda: matmul(x, x), lambda: matmul(x_off, x), smi)
    return [_record("matmul", "matmul.cu", "src/repro/kernels/matmul.py:46",
                    worst[torch.float32], ms, bound, dtype="float32", path="pipelined"),
            _record("matmul_bf16", "matmul_wgmma.cu", "src/repro/kernels/matmul.py:46",
                    worst[torch.bfloat16], ms16, bound16, dtype="bfloat16", path="wgmma")]


def _position_coded_int8(m: int, n: int) -> tuple:
    """int8 operands whose product is known exactly: A (m, 128) has one 1 a
    row, at column i % 128 (the identity, stacked), and B (128, n) holds
    16 (k mod 16) + (n mod 16) - 128. Every C[i, j] must equal
    B[i % 128, j], and a wrong value names the row and column of B it came
    from."""
    sel = torch.arange(m, device="cuda") % 128
    a = torch.zeros((m, 128), dtype=torch.int8, device="cuda")
    a[torch.arange(m, device="cuda"), sel] = 1
    b = (torch.arange(128, device="cuda")[:, None] % 16 * 16
         + torch.arange(n, device="cuda")[None, :] % 16 - 128).to(torch.int8)
    return a, b, sel


def check_configured_matmul(smi: str) -> dict:
    """Integer-valued operands with zero points in [-8, 8]: every sum is an
    integer below 2**24, so each route must equal the plain version exactly;
    int8 takes wgmma where aligned, simt one byte off (f32 and bf16 always
    simt). The position-coded int8 product must come out exactly on wgmma,
    and full-range int8 at K = 4096 with zero points (-128, 127), where the
    f32 plain version is no longer exact, must equal the float64 answer."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import configured_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0.0
    for m, k, n in [(128, 128, 128), (QWEN_M, QWEN_D, QWEN_FF), (70, 130, 33), (130, 144, 208)]:
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda")
        b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda")
        for dtype in (torch.int8, torch.float32, torch.bfloat16):
            for zp in ((-8, 8), (0, 0), (5, -3)):
                for off in (False, True) if dtype == torch.int8 else (False,):
                    x, y = a.to(dtype), b.to(dtype)
                    if off:
                        x = _off_alignment(x)
                    got, route = _routed(configured_matmul, lambda: configured_matmul(x, y, zp))
                    want = ref.configured_matmul_ref(x, y, *zp)
                    torch.cuda.synchronize()
                    err = _max_err(got, want)
                    worst = max(worst, err)
                    print(f"[kernel] configured_matmul ({m},{k})x({k},{n}) {dtype} zp={zp}"
                          f"{' off-aligned' if off else ''}: route={route} max_abs_err={err}")
                    torch.testing.assert_close(got, want, rtol=0, atol=0)
                    aligned_int8 = dtype == torch.int8 and not off and k % 16 == 0 \
                        and n % 16 == 0
                    if route != ("wgmma" if aligned_int8 else "simt"):
                        raise SystemExit(f"configured_matmul took route {route} for {dtype}"
                                         f"{' off-aligned' if off else ''} at ({m},{k},{n})")
    for m, n in [(128, 128), (128, QWEN_FF), (QWEN_M, QWEN_FF)]:
        a, b, sel = _position_coded_int8(m, n)
        got, route = _routed(configured_matmul, lambda: configured_matmul(a, b, (0, 0)))
        torch.cuda.synchronize()
        wrong = (got != b[sel].float()).nonzero()
        for i, j in wrong[:8].tolist():
            v = int(got[i, j]) + 128
            print(f"[kernel]   C[{i},{j}] = {int(got[i, j])}: from k % 16 = {v // 16}, "
                  f"n % 16 = {v % 16}; wanted k % 16 = {int(sel[i]) % 16}, n % 16 = {j % 16}")
        print(f"[kernel] configured_matmul position-coded ({m},128)x(128,{n}) int8: "
              f"route={route} wrong={len(wrong)} of {m * n}")
        if len(wrong) or route != "wgmma":
            raise SystemExit("the position-coded int8 product is not exact on the wgmma route")
    a = torch.randint(-128, 128, (128, 4096), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (4096, 128), generator=gen, device="cuda").to(torch.int8)
    zp = (-128, 127)
    got, route = _routed(configured_matmul, lambda: configured_matmul(a, b, zp))
    exact = ((a.double() - zp[0]) @ (b.double() - zp[1])).float()
    plain = ref.configured_matmul_ref(a, b, *zp)
    torch.cuda.synchronize()
    print(f"[kernel] configured_matmul (128,4096)x(4096,128) int8 zp={zp}: route={route} "
          f"max_abs_err against float64={_max_err(got, exact)}, the f32 plain version's "
          f"against float64={_max_err(plain, exact)}")
    torch.testing.assert_close(got, exact, rtol=0, atol=0)
    if route != "wgmma":
        raise SystemExit(f"the K = 4096 int8 product took route {route}, not wgmma")

    m, k, n = QWEN_M, QWEN_D, QWEN_FF
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    a_off = _off_alignment(a)
    zp = (-8, 8)
    a_c, b_c = a.float() - zp[0], b.float() - zp[1]  # centred before the timed call
    bound = _bound_ms(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS)
    ms = _timed(f"configured_matmul ({m},{k})x({k},{n}) int8 zp={zp} (route wgmma; library: "
                f"torch.matmul on f32 operands centred beforehand; int_mm_ms: torch._int_mm, "
                f"int8 to int32 without zero points; simt_ms: the SIMT kernel, A one byte off)", {
                    "ms": lambda: configured_matmul(a, b, zp),
                    "plain_ms": lambda: ref.configured_matmul_ref(a, b, *zp),
                    "library_ms": lambda: torch.matmul(a_c, b_c),
                    "int_mm_ms": lambda: torch._int_mm(a, b),
                    "simt_ms": lambda: configured_matmul(a_off, b, zp)}, *bound, smi)
    return _record("configured_matmul", "configured_matmul_wgmma.cu",
                   "src/repro/kernels/matmul.py:95", worst, ms, bound, dtype="int8",
                   path="wgmma", int_mm_ms=ms["int_mm_ms"], simt_ms=ms["simt_ms"])


def _attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Softmax attention in float64, the bottom-right causal mask."""
    sq, sk = q.shape[2], k.shape[2]
    s = q.double() @ k.double().transpose(-1, -2) / float(q.shape[-1]) ** 0.5
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v.double()


def _staged(fn) -> tuple:
    """``fn()``'s result and the staging its one SIMT launch took, by the
    wrapper's per-staging counters (None for another route)."""
    from repro_torch.kernels.flash_attention import flash_attention

    before = dict(flash_attention.launches_by_staging)
    out = fn()
    moved = [s for s, n in flash_attention.launches_by_staging.items() if n != before[s]]
    return out, moved[0] if moved else None


def _abba_ms(a, b) -> tuple[float, float]:
    """Device times of ``a`` and ``b`` by CUDA graph, in turns (a, b, b, a),
    medians."""
    t = {"a": [], "b": []}
    for key, fn in (("a", a), ("b", b), ("b", b), ("a", a)):
        t[key].append(_device_ms(fn))
    return float(np.median(t["a"])), float(np.median(t["b"]))


def check_flash_attention(smi: str) -> list[dict]:
    """3e-2 (test_flash_attention_matches_oracle's) at qwen2-0.5b's 14 heads
    of 64, causal and full, f32 and bf16; at the decode shape against 256
    keys; causal Sq < Sk; at the calibration ladder's shapes; at D = 40 and
    128; and on the SIMT route (D = 36, and off 16-byte alignment). The
    qwen-width bf16 call must take the wgmma route. Each SIMT call prints
    its plan (blocks of 64 query rows, keys split across a cluster) and its
    staging; each f32 call prints its error and the plain f32 version's
    against a float64 answer, and the kernel's may not pass twice the plain
    version's. Every ladder shape is timed in f32 beside SDPA, and the
    served shape at every split."""
    import torch.nn.functional as F

    from repro_torch.engine.calibrate import SHAPES
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import AttnPlan, flash_attention, plan_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [((1, 14, 512, 64),) * 2, ((2, 4, 1, 64), (2, 4, 256, 64)),
             ((1, 2, 128, 64), (1, 2, 256, 64)), ((1, 2, 100, 128), (1, 2, 300, 128)),
             ((1, 2, 33, 40), (1, 2, 65, 40)), ((1, 2, 200, 40),) * 2, ((1, 2, 33, 36),) * 2]
    cases += [((1, 1, s, d),) * 2 for s, d, _ in SHAPES["flash_attention"]]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for qs, ks in cases:
        q, k, v = (torch.randn(s, generator=gen, device="cuda") for s in (qs, ks, ks))
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for off in (False, True) if dtype == torch.bfloat16 else (False,):
                    args = (_off_alignment(q.to(dtype)) if off else q.to(dtype), k.to(dtype),
                            v.to(dtype))
                    (got, staging), route = _routed(
                        flash_attention,
                        lambda: _staged(lambda: flash_attention(*args, causal=causal)))
                    want = ref.flash_attention_ref(*args, causal=causal)
                    torch.cuda.synchronize()
                    err = _max_err(got, want)
                    worst[dtype] = max(worst[dtype], err)
                    plan = ""
                    if route == "simt":
                        p = plan_attention(qs[0] * qs[1], qs[2], ks[2], qs[3], causal)
                        plan = f" splits={p.splits} staging={staging}"
                    f64 = ""
                    if dtype == torch.float32:
                        exact = _attention_f64(*args, causal)
                        e_kernel = float((got.double() - exact).abs().max())
                        e_plain = float((want.double() - exact).abs().max())
                        f64 = f" err_f64={e_kernel:.3g} plain_err_f64={e_plain:.3g}"
                        if e_kernel > 2 * e_plain:
                            raise SystemExit(f"flash_attention f32 q{qs} k{ks} causal={causal}: "
                                             f"error {e_kernel} against float64 is more than "
                                             f"twice the plain version's {e_plain}")
                    print(f"[kernel] flash_attention q{qs} k{ks} {dtype} causal={causal}"
                          f"{' off-aligned' if off else ''}: route={route}{plan} "
                          f"max_abs_err={err:.6g}{f64}")
                    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
                    if (qs, dtype, off) == ((1, 14, 512, 64), torch.bfloat16, False) \
                            and route != "wgmma":
                        raise SystemExit(f"the qwen-width bf16 flash_attention took route "
                                         f"{route}, not wgmma")
    b, h, s, d = 1, 14, 512, 64
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda") for _ in range(3))
    pairs = b * h * s * (s + 1) // 2  # (query, key) pairs the causal mask keeps
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    qb_off = _off_alignment(qb)
    bound16 = _bound_ms(2 * 4 * b * h * s * d, 4 * d * pairs, BF16_FLOPS)
    ms16 = _timed(f"flash_attention ({b},{h},{s},{d}) bf16 causal (route wgmma; "
                  f"simt_ms: the SIMT kernel)", {
                      "ms": lambda: flash_attention(qb, kb, vb, causal=True),
                      "plain_ms": lambda: ref.flash_attention_ref(qb, kb, vb, causal=True),
                      "library_ms": lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                                           is_causal=True),
                      "simt_ms": lambda: flash_attention(qb_off, kb, vb, causal=True)},
                  *bound16, smi)
    plan = plan_attention(b * h, s, s, d, True)
    bound = _bound_ms(4 * 4 * b * h * s * d, 4 * d * pairs, F32_FLOPS)
    ms = _timed(f"flash_attention ({b},{h},{s},{d}) f32 causal (route simt, "
                f"splits={plan.splits})", {
                    "ms": lambda: flash_attention(q, k, v, causal=True),
                    "plain_ms": lambda: ref.flash_attention_ref(q, k, v, causal=True),
                    "library_ms": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)},
                *bound, smi)
    by_split = " ".join(
        f"{n}:{_device_ms(lambda: flash_attention(q, k, v, causal=True, plan=AttnPlan(64, n))):.5f}"
        for n in (1, 2, 4, 8))
    print(f"[kernel] flash_attention ({b},{h},{s},{d}) f32 causal, device ms by splits: "
          f"{by_split} ({smi})")
    ladder = {}
    for sl, dl, _ in SHAPES["flash_attention"]:
        x, y, z = (torch.randn((1, 1, sl, dl), generator=gen, device="cuda") for _ in range(3))
        p = plan_attention(1, sl, sl, dl, False)
        t_k, t_lib = _abba_ms(lambda: flash_attention(x, y, z, causal=False),
                              lambda: F.scaled_dot_product_attention(x, y, z))
        ladder[f"{sl}x{dl}"] = t_k
        print(f"[kernel] flash_attention (1,1,{sl},{dl}) f32 full, {p.splits} splits: device ms "
              f"kernel_ms={t_k:.5f} library_ms={t_lib:.5f} bound_ms="
              f"{_bound_ms(4 * 4 * sl * dl, 4 * dl * sl * sl, F32_FLOPS)[0]:.5f} ({smi})")
    q1 = torch.randn((1, 1, 128, 64), generator=gen, device="cuda").bfloat16()
    q1_off = _off_alignment(q1)
    _issue_abba("flash_attention (1,1,128,64) bf16 causal (wgmma encodes 3 TMA maps a call)",
                lambda: flash_attention(q1, q1, q1), lambda: flash_attention(q1_off, q1, q1), smi)
    return [_record("flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:69", worst[torch.float32], ms, bound,
                    dtype="float32", path="simt", splits=plan.splits, ladder_ms=ladder),
            _record("flash_attention_bf16", "flash_attention_wgmma.cu",
                    "src/repro/kernels/flash_attention.py:69", worst[torch.bfloat16], ms16,
                    bound16, dtype="bfloat16", path="wgmma", simt_ms=ms16["simt_ms"])]


def _across_chunks(b: int, v: int, k: int) -> torch.Tensor:
    """(b, v) rows of -1 whose ties and NaNs straddle every chunk boundary
    that ``plan_top_k`` gives at that shape: row r takes pattern r % 4, a
    tie of 6 across each boundary, a NaN on each side, +inf on both sides,
    or zeros of both signs everywhere."""
    from repro_torch.kernels.sampling import plan_top_k

    x = torch.full((b, v), -1.0, device="cuda")
    starts = [start for start, _ in plan_top_k(b, v, k).bounds(v)[1:]]
    for r in range(b):
        for start in starts:
            if r % 4 == 0:
                x[r, start - 3:start + 3] = 5.0
            elif r % 4 == 1:
                x[r, start - 1:start + 1] = float("nan")
            elif r % 4 == 2:
                x[r, start - 2:start + 2] = float("inf")
        if r % 4 == 3:
            x[r] = 0.0
            x[r, ::7] = -0.0
    return x


def check_top_k(smi: str) -> dict:
    """Exact ids and values with k in {1, 8, K_MAX}, in bf16, f32 and fp16:
    at (4, V=151,936) on random rows and rows with ties and NaN; at B = 1
    and 64 (the two ends of plan_top_k's split); on ties and NaNs on both
    sides of each chunk boundary; and on rows one element off 16-byte
    alignment. Each case prints the blocks per row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import K_MAX, plan_top_k, top_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = [torch.randn((4, QWEN_V), generator=gen, device="cuda"),
            torch.randint(-3, 3, (4, QWEN_V), generator=gen, device="cuda").float(),
            _adversarial(QWEN_V, torch.float32), _adversarial(151, torch.float32),
            torch.randn((1, QWEN_V), generator=gen, device="cuda"),
            torch.randn((64, QWEN_V), generator=gen, device="cuda"),
            _across_chunks(4, QWEN_V, 8), _across_chunks(1, QWEN_V, 8),
            _across_chunks(2, QWEN_V, K_MAX)]
    worst = 0
    for i, x in enumerate(rows):
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            for k in (1, 8, K_MAX):
                for off in (False, True) if i in (0, 6) else (False,):
                    y = _off_alignment(x.to(dtype)) if off else x.to(dtype)
                    got_v, got_i = top_k(y, k)
                    want_v, want_i = ref.top_k_ref(y, k)
                    torch.cuda.synchronize()
                    err = int((got_i.long() - want_i.long()).abs().max())
                    worst = max(worst, err)
                    print(f"[kernel] top_k rows#{i} {tuple(x.shape)} {dtype} k={k}"
                          f"{' off-aligned' if off else ''}: blocks per row="
                          f"{plan_top_k(*x.shape, k).splits} max_abs_err={err} (ids)")
                    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
                    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0, equal_nan=True)
    x = torch.randn((4, QWEN_V), generator=gen, device="cuda").to(torch.bfloat16)
    timed = {}
    for k in (1, 8, K_MAX):
        bound = _bound_ms(x.numel() * x.element_size() + x.shape[0] * k * 8, 0.0, 1.0)
        timed[k] = (_timed(f"top_k B=4 V={QWEN_V} bf16 k={k}, "
                           f"{plan_top_k(4, QWEN_V, k).splits} blocks per row", {
                               "ms": lambda: top_k(x, k), "plain_ms": lambda: ref.top_k_ref(x, k),
                               "library_ms": lambda: torch.topk(x, k)}, *bound, smi), bound)
    sweep = " ".join(f"k={k}:{_device_ms(lambda: top_k(x, k)):.5f}" for k in (2, 4, 16, 32))
    print(f"[kernel] top_k B=4 V={QWEN_V} bf16, device ms by k (k <= 8 register lists, "
          f"k > 8 radix select): {sweep} ({smi})")
    for b in (1, 64):
        y = torch.randn((b, QWEN_V), generator=gen, device="cuda").to(torch.bfloat16)
        for k in (8, K_MAX):
            print(f"[kernel] top_k B={b} V={QWEN_V} bf16 k={k}, {plan_top_k(b, QWEN_V, k).splits} "
                  f"blocks per row, device ms: kernel_ms={_device_ms(lambda: top_k(y, k)):.5f} "
                  f"library_ms={_device_ms(lambda: torch.topk(y, k)):.5f} ({smi})")
    ms, bound = timed[8]
    return _record("top_k", "top_k.cu", "src/repro/kernels/sampling.py:98", worst, ms, bound,
                   k=8, ms_k1=timed[1][0]["ms"], ms_k64=timed[K_MAX][0]["ms"])


def _requests(cfg, n: int = N_REQUESTS, lengths: tuple = (16, 97)) -> list[tuple[int, list[int]]]:
    rng = np.random.default_rng(SEED)
    return [(uid, rng.integers(0, cfg.vocab_size, int(rng.integers(*lengths))).tolist())
            for uid in range(n)]


def _serve(model, params, reqs, sampling: str, max_new: int = MAX_NEW,
           tag: str = "[serve]", max_len: int = 512, windows: dict | None = None,
           rows: dict | None = None) -> dict:
    """The requests through a ``ServingEngine`` of 4 slots, prefill chunk 8.
    ``windows[uid]``, where given, is request ``uid``'s ``cross_kv``;
    ``rows``, where given (host sampling), takes each decode launch's
    (slot, logit row) of every live slot under its request's uid (one
    device copy a row, no read-back)."""
    from repro_torch.serving import Request, ServingEngine

    def recording(p, cache, tokens, pos, live):
        logits, cache = model.decode_step(p, cache, tokens, pos, live)
        for slot, req in enumerate(engine.slot_req):
            if req is not None:
                rows.setdefault(req.uid, []).append((slot, logits[slot, 0].clone()))
        return logits, cache

    decode_launches = []
    engine = ServingEngine(
        model, params, max_slots=4, max_len=max_len, prefill_chunk=8, sampling=sampling,
        decode_fn=recording if rows is not None else None,
        on_launch=lambda d: decode_launches.append(d) if "prefill_tokens" not in d else None)
    for uid, prompt in reqs:
        engine.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=max_new,
                              cross_kv=(windows or {}).get(uid)))
    decode_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.queue or engine.live_slots:
        before = engine.executor.launches
        ts = time.perf_counter()
        engine.step()  # ends in the host's read of this step's ids or logits
        if engine.executor.launches == before + 1:  # a decode step, no admission
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    engine.executor.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {r.uid: r.generated for r in engine.finished}
    n_tok = sum(len(g) for g in done.values())
    print(f"{tag} sampling={sampling}: {len(done)} requests, {n_tok} tokens in "
          f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; {len(decode_launches)} decode "
          f"launches, {engine.executor.launches - len(decode_launches)} prefill launches; "
          f"decode-only step median {np.median(decode_ms):.3f} ms over "
          f"{len(decode_ms)} steps; config_traffic={engine.config_traffic()}")
    return {"streams": done, "decode_launches": len(decode_launches),
            "prefill_launches": engine.executor.launches - len(decode_launches)}


def phase_main_path(model, params) -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.sampling import greedy_sample

    reqs = _requests(model.cfg)
    _serve(model, params, reqs[:1], "fused", max_new=4)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    greedy_sample.launches = decode_attention.launches = 0
    fused = _serve(model, params, reqs, "fused")
    launches, attention = greedy_sample.launches, decode_attention.launches
    print(f"[serve] greedy_sample launches={launches}, fused decode "
          f"launches={fused['decode_launches']}; decode_attention launches={attention} "
          f"({model.cfg.n_layers} a decode step); max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} B")
    if launches == 0 or launches != fused["decode_launches"]:
        raise SystemExit("the main path did not launch greedy_sample once per decode launch")
    if attention < model.cfg.n_layers * launches or attention % model.cfg.n_layers:
        raise SystemExit("the main path did not launch decode_attention in every layer of "
                         "every decode step")
    for uid, prompt in reqs:
        if len(fused["streams"][uid]) != MAX_NEW:
            raise SystemExit(f"request {uid} finished with {len(fused['streams'][uid])} "
                             f"tokens, not {MAX_NEW}")
    host = _serve(model, params, reqs, "host")
    if host["streams"] != fused["streams"]:
        raise SystemExit("fused and host sampling gave different token streams")
    print("[serve] fused and host token streams are bit-identical")
    return {"greedy_sample": launches, "decode_attention": attention}


def phase_numerics(model, params, tag: str = "[numerics]", inputs: dict | None = None,
                   prepare=None) -> None:
    """``forward`` against teacher-forced ``decode_step`` at B = 2, S = 16,
    at test_decode_parity's tolerances. ``inputs`` adds to ``forward``'s
    batch (an encoder's frames), and ``prepare(cache)`` fills the decode
    cache to match (their cross K/V) before the first step."""
    b, s = 2, 16
    gen = torch.Generator(device=model.device).manual_seed(SEED + 1)
    tokens = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                           device=model.device)
    full, _ = model.forward(params, {**(inputs or {}), "tokens": tokens})
    cache = model.init_cache(b, s)
    if prepare is not None:
        prepare(cache)
    steps = []
    for i in range(s):
        lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        steps.append(lg[:, 0])
    a = full.float().cpu().numpy()
    d = torch.stack(steps, 1).float().cpu().numpy()
    top1 = float((a.argmax(-1) == d.argmax(-1)).mean())
    top2 = np.sort(a, -1)[..., -2:]
    finite = bool(np.isfinite(a).all() and np.isfinite(d).all())
    print(f"{tag} forward vs decode_step B={b} S={s}: max_abs_diff="
          f"{np.abs(a - d).max():.6f}, top1 agreement={top1:.4f}; smallest top-two margin of "
          f"the forward {float((top2[..., 1] - top2[..., 0]).min()):.6f}; finite={finite}")
    np.testing.assert_allclose(a, d, rtol=PARITY_RTOL, atol=PARITY_ATOL)
    if top1 < PARITY_TOP1 or not finite:
        raise SystemExit(f"top-1 agreement {top1} < {PARITY_TOP1}, or non-finite logits")


def _eager_fused_ids(model, params, fuse: int, steps: int = SERVE_STEPS,
                     cache_len: int = SERVE_CACHE) -> torch.Tensor:
    """The serve loop's fused schedule as a plain loop of ``decode_step``
    and ``sample_op`` calls with an int position: the warm-up's ``fuse``
    steps feed each other, then the tokens restart from ones at ``fuse``."""
    from repro_torch.kernels import ops

    cache = model.init_cache(SERVE_BATCH, cache_len)
    ones = torch.ones((SERVE_BATCH, 1), dtype=torch.int32, device=model.device)
    tokens, ids = ones, []
    for pos in range(max(steps, fuse)):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        tokens = ops.sample_op(logits[:, -1])[:, None]
        if pos >= fuse:
            ids.append(tokens.T)
        if pos == fuse - 1:
            tokens = ones
    return torch.cat(ids).cpu()


def _profiled(fn, steps_run: int, top: int = 0, shapes: bool = False) -> dict:
    """Device operations (kernels, copies, fills) a decode step and their
    summed device time, by torch.profiler over ``fn()``, which runs
    ``steps_run`` decode steps; with ``top``, also the ``top`` operations
    that took most device time, as (name, ms a step, calls a step); with
    ``shapes``, every PyTorch operator that launched device work, by its
    input shapes, as (name, input shapes, device ms a step, calls a step),
    most device time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        fn()
        torch.cuda.synchronize()
    device = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    out = {"ops": sum(r.count for r in device) / steps_run,
           "busy_ms": sum(r.self_device_time_total for r in device) / 1e3 / steps_run}
    if top:
        device.sort(key=lambda r: r.self_device_time_total, reverse=True)
        out["top"] = [(r.key[:60], r.self_device_time_total / 1e3 / steps_run,
                       r.count / steps_run) for r in device[:top]]
    if shapes:
        ops = [r for r in prof.key_averages(group_by_input_shape=True)
               if r.device_type == DeviceType.CPU and r.self_device_time_total > 0]
        ops.sort(key=lambda r: r.self_device_time_total, reverse=True)
        out["by_shape"] = [(r.key, r.input_shapes, r.self_device_time_total / 1e3 / steps_run,
                            r.count / steps_run) for r in ops]
    return out


def _top(prof: dict) -> str:
    return "; ".join(f"{name} {ms:.4f} ms x{calls:g}" for name, ms, calls in prof["top"])


def phase_serve_modes(model, params, smi: str, steps: int = SERVE_STEPS,
                      cache_len: int = SERVE_CACHE, tag: str = "[serve-modes]",
                      profiled: tuple = ("sequential", "fused", "fused fuse=1")) -> dict:
    """``python -m repro_torch.launch.serve``'s loop, through ``serve()``, in
    each mode at full width, with greedy_sample's count set to 0 just before
    each run and read just after; then the ``profiled`` modes' short runs
    under torch.profiler. Returns each mode's device ms a step and, for the
    profiled modes, the profile."""
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.launch.serve import serve

    runs = {}
    for label, mode, fuse in (("sequential", "sequential", SERVE_FUSE),
                              ("concurrent", "concurrent", SERVE_FUSE),
                              ("fused", "fused", SERVE_FUSE), ("fused fuse=1", "fused", 1)):
        greedy_sample.launches = 0
        run = serve(model, params, batch=SERVE_BATCH, steps=steps, cache_len=cache_len,
                    mode=mode, fuse=fuse)
        counted = greedy_sample.launches
        graphs = "".join(f"; graph k={g.k}: {g.launches} greedy_sample launches captured, "
                         f"{g.replays} replays" for g in run.graphs)
        print(f"{tag} mode={label} batch={SERVE_BATCH} steps={run.produced}: "
              f"{run.wall_s * 1e3:.3f} ms total, {run.tokens_per_s:.1f} tok/s "
              f"({run.ms_per_step:.4f} ms/step); device {run.device_ms / run.produced:.4f} "
              f"ms/step (CUDA events around the timed loop); host issue a launch, over "
              f"{run.launches}: first {run.issue_ms[0]:.4f} ms, median of the rest "
              f"{np.median(run.issue_ms[1:]):.4f}, mean {np.mean(run.issue_ms):.4f}; "
              f"greedy_sample launches in the "
              f"timed loop {run.sample_launches} (counter {counted}, warm-up and captures "
              f"included){graphs}" + (f"; {len(run.graphs)} graphs captured in "
                                      f"{run.capture_s:.3f} s" if mode == "fused" else "")
              + f" ({smi})")
        if counted == 0 or run.sample_launches != run.produced:
            raise SystemExit(f"serve {label} launched greedy_sample {run.sample_launches} times "
                             f"for {run.produced} steps")
        if tuple(run.ids.shape) != (steps - (fuse if mode == "fused" else 1), SERVE_BATCH) \
                or not bool(((run.ids >= 0) & (run.ids < model.cfg.vocab_size)).all()):
            raise SystemExit(f"serve {label} gave ids of shape {tuple(run.ids.shape)} outside "
                             f"the vocabulary")
        runs[label] = run
    if not runs["fused"].graphs or not all(g.replays for g in runs["fused"].graphs):
        raise SystemExit("fused serving did not replay its CUDA graphs")
    seq = runs["sequential"].ids
    for label in ("concurrent", "fused fuse=1"):
        if not torch.equal(runs[label].ids, seq):
            raise SystemExit(f"serve {label} ids differ from sequential's")
    if not torch.equal(runs["fused"].ids, _eager_fused_ids(model, params, SERVE_FUSE, steps,
                                                           cache_len)):
        raise SystemExit("fused serving's graph replays differ from the same schedule run eagerly")
    print(f"{tag} sequential, concurrent and fused fuse=1 ids bit-identical "
          f"({tuple(seq.shape)}); fused fuse={SERVE_FUSE} ids equal the eager schedule's "
          f"({tuple(runs['fused'].ids.shape)}); first steps {seq[:3].tolist()}")

    # short runs under torch.profiler: what a step costs the card, against
    # the timed runs' device ms a step (the rest is the card idle)
    short = {"batch": SERVE_BATCH, "cache_len": cache_len}
    out = {label: {"device_ms": run.device_ms / run.produced} for label, run in runs.items()}
    for label, run, kw, steps_run in (
            ("sequential", runs["sequential"], dict(mode="sequential", steps=9), 9),
            ("fused", runs["fused"], dict(mode="fused", steps=3 * SERVE_FUSE, fuse=SERVE_FUSE),
             3 * SERVE_FUSE),
            ("fused fuse=1", runs["fused fuse=1"], dict(mode="fused", steps=9, fuse=1), 9)):
        if label not in profiled:
            continue
        prof = _profiled(lambda: serve(model, params, **short, **kw), steps_run)
        step_ms = run.device_ms / run.produced
        print(f"{tag} profile, mode={label}, {steps_run} steps (warm-up included): "
              f"{prof['ops']:.1f} device ops a step, busy {prof['busy_ms']:.4f} ms a step; "
              f"against the timed run's {step_ms:.4f} device ms a step the card is idle "
              f"{1 - prof['busy_ms'] / step_ms:.3f} of it ({smi})")
        out[label].update(prof, idle=1 - prof["busy_ms"] / step_ms)
    return out


def _kv_rows_with_ties() -> torch.Tensor:
    """Seeded (4, 1, 2, 64) bf16 K/V rows: normal values, an all-zero head,
    a head far under the scale's 1e-8 floor, and a head of exact .5 ties at
    a scale of 1 (``TIES``, then zeros)."""
    gen = torch.Generator().manual_seed(SEED + 30)
    x = 3 * torch.randn((4, 1, 2, 64), generator=gen)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 1e-12 * torch.randn(64, generator=gen)
    x[1, 0, 1] = 0.0
    x[1, 0, 1, :len(TIES)] = torch.tensor(TIES)
    return x.to(torch.bfloat16)


def _cache_bytes(cache: dict) -> int:
    return sum(v.numel() * v.element_size() for v in cache.values())


def phase_int8_kv(model, params, smi: str, bf16_modes: dict) -> int:
    """The int8 KV cache (``cache_quant="int8"``) on full-width qwen2-0.5b,
    over the same weights: ``quantize_kv``/``dequantize_kv`` on the card
    bit for bit the CPU port's; teacher-forced int8 decode against bf16
    decode at test_serving.py's bounds; one masked fused step under
    ``set_sync_debug_mode("error")``, the masked row's four leaves
    bit-identical after it; the serving engine fused and host-sampled,
    bit-identical, with greedy_sample counted from 0 just before the fused
    run and read just after; the serving loop's modes as in 6, the fused
    one profiled beside the bf16 fused step (``bf16_modes``); the cache's
    bytes against bf16's. Returns the fused engine run's greedy_sample
    launches."""
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    x = _kv_rows_with_ties()
    q, scale = L.quantize_kv(x)
    cq, cscale = L.quantize_kv(x.cuda())
    exact = (torch.equal(cq.cpu(), q) and torch.equal(cscale.cpu(), scale)
             and torch.equal(L.dequantize_kv(cq, cscale).cpu(), L.dequantize_kv(q, scale)))
    ties = cq[1, 0, 1, :len(TIES)].tolist()
    print(f"[int8-kv] quantize_kv and dequantize_kv on the card against the CPU port, seeded "
          f"{tuple(x.shape)} rows with a zero head, a head under the 1e-8 floor and .5 ties: bit "
          f"for bit {exact}; ties {list(TIES)} -> {ties}")
    if not exact or ties != TIES_ROUNDED:
        raise SystemExit("quantize_kv on the card is not the CPU port's, or rounds ties otherwise")

    qmodel = Model(dataclasses.replace(model.cfg, cache_quant="int8"), device="cuda")
    b, s = 2, 16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen, device="cuda")

    def teacher_forced(m) -> np.ndarray:
        cache, steps = m.init_cache(b, s), []
        for i in range(s):
            logits, cache = m.decode_step(params, cache, tokens[:, i:i + 1], i)
            steps.append(logits[:, 0])
        return torch.stack(steps, 1).float().cpu().numpy()

    plain, quant = teacher_forced(model), teacher_forced(qmodel)
    want, got = plain.argmax(-1), quant.argmax(-1)
    top1 = float((want == got).mean())
    # a flip is a knife edge where bf16's logits at the two ids lie closer than
    # that position's largest int8-bf16 difference: test_serving.py's "legitimate"
    # flip, which the random full-width model's flat logits meet often
    flips = [(float(plain[i, j, want[i, j]] - plain[i, j, got[i, j]]),
              float(np.abs(plain[i, j] - quant[i, j]).max()))
             for i, j in zip(*np.nonzero(want != got))]
    held = top1 + sum(gap <= moved for gap, moved in flips) / want.size
    print(f"[int8-kv] teacher-forced decode B={b} S={s}, int8 against bf16: max_abs_diff="
          f"{np.abs(plain - quant).max():.6f}, top1 agreement={top1:.4f}; flips (bf16's gap "
          f"between the two ids, the position's largest difference): {flips}; top1 with "
          f"knife-edge flips agreeing={held:.4f} (bounds: top-1 >= {INT8_TOP1}, rtol "
          f"{INT8_RTOL}, atol {INT8_ATOL})")
    np.testing.assert_allclose(quant, plain, rtol=INT8_RTOL, atol=INT8_ATOL)
    if held < INT8_TOP1:
        raise SystemExit(f"int8 decode's top-1 agreement {held} < {INT8_TOP1}")

    # one masked fused step: slot 3 keeps all four leaves
    cache = qmodel.init_cache(SERVE_BATCH, 64)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    for key in ("k", "v"):
        cache[key].copy_(torch.randint(-127, 128, cache[key].shape, generator=gen, device="cuda"))
        cache[f"{key}_scale"].copy_(0.05 * torch.rand(cache[f"{key}_scale"].shape, generator=gen,
                                                      device="cuda") + 1e-3)
    before = {k: v.clone() for k, v in cache.items()}
    addresses = {k: v.data_ptr() for k, v in cache.items()}
    _masked_fused_step(qmodel, params, cache)
    for k, v in cache.items():
        if v.data_ptr() != addresses[k] or not torch.equal(v[:, 3], before[k][:, 3]):
            raise SystemExit(f"the masked int8 fused step moved {k!r} or changed its masked row")
        if torch.equal(v[:, 0], before[k][:, 0]):
            raise SystemExit(f"the masked int8 fused step left a live row's {k!r} unchanged")
    print(f"[int8-kv] one masked fused decode step under set_sync_debug_mode('error'): no "
          f"read-back; the masked row's {sorted(cache)} bit-identical, every leaf at its "
          f"address; the live rows' leaves changed")
    del cache, before

    reqs = _requests(model.cfg, INT8_REQUESTS, INT8_PROMPT)
    _serve(qmodel, params, reqs[:1], "fused", max_new=2, tag="[int8-kv]")  # warm-up
    greedy_sample.launches = 0
    fused = _serve(qmodel, params, reqs, "fused", max_new=INT8_NEW, tag="[int8-kv]")
    launches = greedy_sample.launches
    print(f"[int8-kv] greedy_sample launches={launches}, fused decode "
          f"launches={fused['decode_launches']}")
    if launches == 0 or launches != fused["decode_launches"]:
        raise SystemExit("the int8 engine did not launch greedy_sample once per fused decode "
                         "launch")
    host = _serve(qmodel, params, reqs, "host", max_new=INT8_NEW, tag="[int8-kv]")
    if host["streams"] != fused["streams"] or any(len(g) != INT8_NEW
                                                  for g in fused["streams"].values()):
        raise SystemExit("int8 fused and host sampling gave different or short token streams")
    print("[int8-kv] fused and host token streams are bit-identical")

    modes = phase_serve_modes(qmodel, params, smi, tag="[int8-kv]", profiled=("fused",))
    q8, bf = modes["fused"], bf16_modes["fused"]
    full = _cache_bytes(model.init_cache(SERVE_BATCH, SERVE_CACHE))
    small = _cache_bytes(qmodel.init_cache(SERVE_BATCH, SERVE_CACHE))
    print(f"[int8-kv] fused step, int8 against bf16 (batch {SERVE_BATCH}, cache {SERVE_CACHE}): "
          f"{q8['device_ms']:.4f} against {bf['device_ms']:.4f} device ms a step; busy "
          f"{q8['busy_ms']:.4f} against {bf['busy_ms']:.4f} ms, {q8['ops']:.1f} against "
          f"{bf['ops']:.1f} device ops a step; cache {small} B against {full} B = "
          f"{small / full:.4f} (bound {INT8_BYTES}) ({smi})")
    if small >= INT8_BYTES * full:
        raise SystemExit(f"the int8 cache is {small / full:.3f} of bf16's")
    print(f"[int8-kv] phase took {time.perf_counter() - t0:.1f} s")
    return launches


def _chunked_against_plain(tag: str, run_plain, run_chunked, rtol: float, atol: float,
                           smi: str) -> None:
    """Each pass warmed up, then timed by CUDA events (mean of 3) with its
    peak memory over what was allocated before it; the chunked output held
    to the plain one at (``rtol``, ``atol``) on the card."""
    out = {}
    for label, run in (("plain", run_plain), ("chunked", run_chunked)):
        run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = _events_ms(run, 3)
        out[label] = (ms, torch.cuda.max_memory_allocated() - base)
    plain, chunked = run_plain().float(), run_chunked().float()
    close = torch.isclose(chunked, plain, rtol=rtol, atol=atol)
    top1 = float((plain.argmax(-1) == chunked.argmax(-1)).float().mean())
    print(f"{tag} plain {out['plain'][0]:.4f} ms, peak {out['plain'][1]} B over what was "
          f"allocated; chunked {out['chunked'][0]:.4f} ms, peak {out['chunked'][1]} B (CUDA "
          f"events, mean of 3); chunked against plain: max_abs_diff "
          f"{float((chunked - plain).abs().max()):.6f}, {float(close.float().mean()):.8f} of "
          f"elements within rtol {rtol} atol {atol}, argmax agreement {top1:.4f} ({smi})")
    if not bool(close.all()) or not bool(torch.isfinite(chunked).all()):
        raise SystemExit(f"{tag} the chunked pass is not within tolerance of the plain one")


def phase_chunked(model, params, smi: str) -> None:
    """qwen2-0.5b's ``forward`` at B = 1, S = 4,096 with ``attn_chunk`` 512
    against 0, at test_perf_features.py's tolerance, each timed with its
    peak memory."""
    from repro_torch.models.model import Model

    chunked = Model(dataclasses.replace(model.cfg, attn_chunk=CHUNK), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (1, CHUNK_SEQ), generator=gen,
                                     device="cuda")}
    _chunked_against_plain(
        f"[chunked] qwen2-0.5b forward B=1 S={CHUNK_SEQ}, attn_chunk {CHUNK} against 0:",
        lambda: model.forward(params, batch)[0], lambda: chunked.forward(params, batch)[0],
        CHUNK_RTOL, CHUNK_ATOL, smi)


def phase_calibrate(smi: str) -> dict:
    """The calibration harness over the full ladder, as a user runs it; each
    sample's wall time beside that shape's device time by CUDA graph, so
    the wall time splits into device work and host issue."""
    from repro_torch.engine.calibrate import SHAPES, kernel_thunk, run_calibration
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.sampling import greedy_sample

    counted = {"flash_attention": flash_attention, "matmul": matmul, "sampling": greedy_sample}
    repeats = 3
    for wrapper in counted.values():
        wrapper.launches = 0
    matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    flash_attention.launches_by_staging = dict.fromkeys(flash_attention.launches_by_staging, 0)
    greedy_sample.launches_by_cluster = dict.fromkeys(greedy_sample.launches_by_cluster, 0)
    t0 = time.perf_counter()
    fits, samples = run_calibration(device="cuda", repeats=repeats)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counted.items()}
    print(f"[calibrate] full ladder in {wall:.2f} s; launches={launches}; by route: "
          f"matmul {matmul.launches_by_route}, flash_attention "
          f"{flash_attention.launches_by_route}, by staging "
          f"{flash_attention.launches_by_staging}; greedy_sample by cluster "
          f"{greedy_sample.launches_by_cluster}")
    for kernel, n in launches.items():
        want = (1 + repeats) * len(SHAPES[kernel])
        if n != want:
            raise SystemExit(f"calibration launched {kernel} {n} times, not {want}")
    if matmul.launches_by_route["pipelined"] != launches["matmul"]:
        raise SystemExit("the calibration's f32 matmul did not all take the pipelined route")
    if flash_attention.launches_by_staging["cp_async"] != launches["flash_attention"]:
        raise SystemExit("the calibration's f32 flash_attention did not all stage by cp.async")
    if greedy_sample.launches_by_cluster[1] != launches["sampling"]:
        raise SystemExit("the calibration ladder's rows did not all stay whole")
    for kernel in sorted(samples):
        fit = fits[kernel]
        print(f"[calibrate] {kernel}: overhead_factor={fit.overhead_factor!r} "
              f"seconds_per_cycle={fit.seconds_per_cycle!r} r2={fit.r2!r} "
              f"n={fit.n_samples} ({smi})")
        for sample in samples[kernel]:
            dims = tuple(sample["dims"])
            device_ms = _device_ms(kernel_thunk(kernel, dims, "cuda"))
            wall_ms = sample["seconds"] * 1e3
            print(f"[calibrate]   {kernel} dims={dims}: wall_ms={wall_ms:.5f} "
                  f"device_ms={device_ms:.5f} host_ms={wall_ms - device_ms:.5f} ({smi})")
    return {"matmul": launches["matmul"], "flash_attention": launches["flash_attention"],
            "greedy_sample": launches["sampling"]}


def phase_ops_path(model, params) -> dict:
    """``configured_matmul`` and ``top_k`` through ``kernels.ops``, their
    only entry point: an int8 product with zero points at qwen2-0.5b's MLP
    width, and the top 8 of the served model's last-position logits; and
    the two bf16 routes no other path runs, ``matmul_op`` at the MLP width
    and causal ``attention_op`` at (1, 14, 512, 64), on the wgmma route."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import configured_matmul, matmul
    from repro_torch.kernels.sampling import top_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    tokens = torch.randint(0, model.cfg.vocab_size, (4, 16), generator=gen, device="cuda")
    logits, _ = model.forward(params, {"tokens": tokens})
    last = logits[:, -1].contiguous()
    a = torch.randint(-128, 128, (QWEN_M, QWEN_D), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (QWEN_D, QWEN_FF), generator=gen, device="cuda").to(torch.int8)
    zero_points = torch.tensor([-8, 8], dtype=torch.int32)  # on the host: launch parameters
    x = torch.randn((QWEN_M, QWEN_D), generator=gen, device="cuda").bfloat16()
    w = torch.randn((QWEN_D, QWEN_FF), generator=gen, device="cuda").bfloat16()
    q, k, v = (torch.randn((1, 14, 512, 64), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    torch.cuda.synchronize()
    configured_matmul.launches = top_k.launches = 0
    configured_matmul.launches_by_route = dict.fromkeys(configured_matmul.launches_by_route, 0)
    matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    vals, ids = ops.top_k_op(last, 8)
    c = ops.configured_matmul_op(a, b, zero_points)
    y = ops.matmul_op(x, w)
    o = ops.attention_op(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = {"configured_matmul": configured_matmul.launches, "top_k": top_k.launches,
                "matmul_bf16": matmul.launches_by_route["wgmma"],
                "flash_attention_bf16": flash_attention.launches_by_route["wgmma"]}
    print(f"[ops] top_k_op on {tuple(last.shape)} {last.dtype} logits, k=8, "
          f"configured_matmul_op ({QWEN_M},{QWEN_D})x({QWEN_D},{QWEN_FF}) int8 zp=(-8, 8), "
          f"matmul_op bf16 at that width and attention_op bf16 (1,14,512,64) causal: "
          f"launches={launches}; by route: configured_matmul "
          f"{configured_matmul.launches_by_route}, matmul {matmul.launches_by_route}, "
          f"flash_attention {flash_attention.launches_by_route}")
    if set(launches.values()) != {1} or sum(matmul.launches_by_route.values()) != 1 \
            or sum(flash_attention.launches_by_route.values()) != 1:
        raise SystemExit("the ops path did not launch each kernel once, bf16 on the wgmma route")
    if configured_matmul.launches_by_route != {"wgmma": 1, "simt": 0}:
        raise SystemExit("the ops path's int8 configured_matmul did not take the wgmma route")
    want_v, want_i = ref.top_k_ref(last, 8)
    torch.testing.assert_close(ids, want_i, rtol=0, atol=0)
    torch.testing.assert_close(vals, want_v, rtol=0, atol=0)
    torch.testing.assert_close(ids[:, 0], ref.greedy_sample_ref(last), rtol=0, atol=0)
    torch.testing.assert_close(c, ref.configured_matmul_ref(a, b, -8, 8), rtol=0, atol=0)
    torch.testing.assert_close(y, ref.matmul_ref(x, w), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(o, ref.flash_attention_ref(q, k, v, causal=True), rtol=3e-2,
                               atol=3e-2)
    print(f"[ops] top-8 ids of row 0: {ids[0].tolist()}; configured_matmul output "
          f"{tuple(c.shape)} finite={bool(torch.isfinite(c).all())}, exact against its "
          f"plain version; matmul {tuple(y.shape)} and attention {tuple(o.shape)} outputs "
          f"within 2e-2 and 3e-2 of theirs")
    return launches


def _bridge_tenants(model, params, fns: dict, sampling: str, prefill_chunk: int) -> list:
    """The serving-bridge benchmark's tenants (``make_tenants``): one set of
    weights, an engine and KV cache each, three prompts of 3, 2 and 4
    tokens, distinct per tenant."""
    from repro_torch.bridge import TenantEngine
    from repro_torch.serving import Request, ServingEngine

    tenants = []
    for i in range(BRIDGE_TENANTS):
        engine = ServingEngine(model, params, max_slots=BRIDGE_SLOTS, max_len=BRIDGE_MAX_LEN,
                               decode_fn=fns[sampling], prefill_fn=fns["prefill"],
                               sampling=sampling, prefill_chunk=prefill_chunk)
        for uid, prompt in enumerate([[3 + i, 5, 2 + (i % 3)], [7, 1 + i], [11, 2, 4, 1 + i]]):
            engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=BRIDGE_MAX_NEW))
        tenants.append(TenantEngine(f"t{i}", engine, accel="opengemm", slo_cycles=2_000.0))
    return tenants


def _streams(tenants) -> dict:
    return {te.tenant: {r.uid: r.generated for r in te.engine.finished} for te in tenants}


def _timed_steps(tenants) -> list:
    """Wraps each tenant's engine step to record (seconds, launches, prefill
    launches) of every call; returns the list the calls append to."""
    step_s = []

    def timed(step):
        def run():
            ts = time.perf_counter()
            produced, descs = step()
            step_s.append((time.perf_counter() - ts, len(descs),
                           sum("prefill_tokens" in d for d in descs)))
            return produced, descs
        return run

    for te in tenants:
        te.step = timed(te.step)
    return step_s


def phase_bridge(model, params, smi: str) -> tuple[int, dict, dict]:
    """The closed-loop serving bridge at the serving-bridge benchmark's
    cell shape: 6 tenants of full-width qwen2-0.5b on a cluster model of 2
    hosts with one OpenGeMM each over a NoC, in four arms. The card computes
    every token; the cycle model prices the same launch stream in OpenGeMM
    cycles. Returns greedy_sample's launches over the fused arms, counted
    from 0 just before each arm and read just after; each arm's wall
    seconds and cycle-model numbers; and the standalone engines' streams."""
    from repro_torch.bridge import ClosedLoopDriver
    from repro_torch.cluster import Cluster
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.serving import ServingEngine

    fns = {"fused": ServingEngine.compile_decode(model, sampling="fused"),
           "host": ServingEngine.compile_decode(model, sampling="host"),
           "prefill": ServingEngine.compile_prefill(model)}
    standalone = _bridge_tenants(model, params, fns, "fused", 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for te in standalone:
        te.engine.run_until_done()
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    alone_launches = sum(te.engine.executor.launches for te in standalone)
    want = _streams(standalone)
    n_tok = sum(len(g) for s in want.values() for g in s.values())
    print(f"[bridge] standalone on the card: {BRIDGE_TENANTS} engines run one after another, "
          f"{n_tok} tokens, {alone_launches} launches in {alone_s:.3f} s = "
          f"{n_tok / alone_s:.2f} tokens/s, {alone_s * 1e3 / alone_launches:.2f} ms a launch ({smi})")
    if n_tok != BRIDGE_TENANTS * 3 * BRIDGE_MAX_NEW:
        raise SystemExit(f"standalone engines produced {n_tok} tokens")

    fused_launches, arms = 0, {}
    for arm, policy, sticky, sampling, chunk in BRIDGE_ARMS:
        tenants = _bridge_tenants(model, params, fns, sampling, chunk)
        step_s = _timed_steps(tenants)
        cluster = Cluster.uniform(BRIDGE_HOSTS, {"opengemm": 1}, policy=policy, sticky=sticky,
                                  link="noc", max_contexts=4)
        greedy_sample.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ClosedLoopDriver(tenants, cluster).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = greedy_sample.launches
        launches = rep.cluster.launches
        decodes = sum(s.launches - s.prefill_launches for s in rep.steps)
        engine_s = sum(s for s, _, _ in step_s)
        decode_only = [s * 1e3 for s, n, pre in step_s if n == 1 and pre == 0]
        print(f"[bridge] arm={arm} (policy={policy}, sticky={sticky}, sampling={sampling}, "
              f"prefill chunk {chunk}), measured on the card: wall {wall:.3f} s, "
              f"{rep.tokens / wall:.2f} tokens/s, {wall * 1e3 / launches:.2f} ms a launch over "
              f"{launches} launches ({launches - decodes} prefill), decode-only step median "
              f"{np.median(decode_only):.2f} ms over {len(decode_only)}; host outside the "
              f"engines (cycle model and bridge) {(wall - engine_s) * 1e3 / launches:.3f} ms a "
              f"launch; greedy_sample launches {counted} for {decodes if sampling == 'fused' else 0}"
              f" fused decode launches ({smi})")
        served = [r.end - r.arrival for r in rep.cluster.records]
        parity = rep.config_parity()
        print(f"[bridge] arm={arm}, OpenGeMM cycle model (model cycles, not the card): "
              f"tokens_per_kcycle={rep.tokens_per_kcycle:.6f}, p99 decode "
              f"{max(s.p99_decode for s in rep.serving.values()):.1f} cycles, makespan "
              f"{rep.cluster.makespan:.1f} cycles, {np.mean(served):.2f} cycles a launch "
              f"arrival to retire, config bytes sent {rep.cluster.bytes_sent} elided "
              f"{rep.cluster.bytes_elided}, parity matched for "
              f"{sum(p['matched'] for p in parity.values())} of {len(parity)} tenants")
        if _streams(tenants) != want:
            raise SystemExit(f"bridge arm {arm} gave other tokens than the standalone engines")
        if sticky and not all(p["matched"] for p in parity.values()):
            raise SystemExit(f"bridge arm {arm}: config bytes do not match the engines' "
                             f"accounting: {parity}")
        if counted != (decodes if sampling == "fused" else 0):
            raise SystemExit(f"bridge arm {arm} launched greedy_sample {counted} times for "
                             f"{decodes} decode launches")
        if sampling == "fused":
            fused_launches += counted
        arms[arm] = {"wall": wall, "makespan": rep.cluster.makespan,
                     "bytes_sent": rep.cluster.bytes_sent,
                     "bytes_elided": rep.cluster.bytes_elided,
                     "tokens_per_kcycle": rep.tokens_per_kcycle}
    print("[bridge] every arm's token streams equal the standalone engines'; config parity "
          "matched in the sticky arms; greedy_sample once per fused decode launch")
    return fused_launches, arms, want


def phase_doctor(model, params, smi: str, untraced: dict, want: dict) -> int:
    """The config-wall doctor over the closed loop: the bridge's sticky
    affinity arm (fused sampling, prefill chunk 8) twice more, each under
    its own ``obs.Tracer``, with serialized and with overlapped config
    staging. Each run's attribution must be conserved, its trace valid and
    its tokens the standalone engines'; greedy_sample must launch once per
    fused decode launch (counted from 0 just before each run), and the
    serialized run's makespan, config bytes and tokens/kcycle must equal
    the untraced affinity arm's (a tracer never moves the clock). The two
    traces go to ``doctor_traces/`` beside this script, and ``python -m
    repro_torch.obs.doctor SERIALIZED --against OVERLAPPED --json OUT``
    runs on them in a subprocess: it must exit 0, give the live serialized
    report's regime, and a diff whose makespan delta is the two reports'.
    The directory is deleted at the end. Returns greedy_sample's launches
    over both runs."""
    import shutil

    from repro_torch.bridge import ClosedLoopDriver
    from repro_torch.cluster import Cluster
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.obs import Tracer, attribute, diagnose_report, validate_trace, write_trace
    from repro_torch.serving import ServingEngine

    fns = {"fused": ServingEngine.compile_decode(model, sampling="fused"),
           "prefill": ServingEngine.compile_prefill(model)}
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "doctor_traces")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    base = untraced["affinity"]
    reports, paths, launches = {}, {}, 0
    try:
        for overlap in DOCTOR_ARMS:
            tenants = _bridge_tenants(model, params, fns, "fused", 8)
            step_s = _timed_steps(tenants)
            tracer = Tracer()
            cluster = Cluster.uniform(BRIDGE_HOSTS, {"opengemm": 1}, policy="affinity",
                                      sticky=True, link="noc", max_contexts=4, overlap=overlap,
                                      tracer=tracer)
            greedy_sample.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = ClosedLoopDriver(tenants, cluster).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counted = greedy_sample.launches
            decodes = sum(s.launches - s.prefill_launches for s in rep.steps)
            att = attribute(rep).check()
            paths[overlap] = os.path.join(out_dir, f"TRACE_{overlap}.json")
            doc = write_trace(tracer, paths[overlap], attribution=att, metrics=rep.metrics)
            problems = validate_trace(doc)
            live = diagnose_report(rep)
            engine_s = sum(t for t, _, _ in step_s)
            print(f"[doctor] arm={overlap} (traced; policy=affinity, sticky=True, sampling=fused, "
                  f"prefill chunk 8), measured on the card: wall {wall:.3f} s, "
                  f"{rep.tokens / wall:.2f} tokens/s, {wall / base['wall']:.3f}x the untraced "
                  f"affinity arm's {base['wall']:.3f} s; host outside the engines (cycle model, "
                  f"bridge and tracer) {(wall - engine_s) * 1e3 / rep.cluster.launches:.3f} ms a "
                  f"launch; greedy_sample launches {counted} for {decodes} fused decode launches "
                  f"({smi})")
            print(f"[doctor] arm={overlap}, OpenGeMM cycle model (model cycles, not the card): "
                  f"makespan {rep.cluster.makespan:.1f} cycles, exposed config "
                  f"{rep.cluster.exposed_config_cycles:.1f} of {rep.cluster.config_cycles:.1f} "
                  f"config cycles, config bytes sent {rep.cluster.bytes_sent} elided "
                  f"{rep.cluster.bytes_elided}, tokens_per_kcycle={rep.tokens_per_kcycle:.6f}; "
                  f"attribution conserved (max residual {att.max_residual:.3g} cycles over "
                  f"{len(att.lanes)} lanes); {len(doc['traceEvents'])} trace events on "
                  f"{len(tracer.lanes())} lanes, {len(problems)} schema problems; live regime "
                  f"{live.regime.label}")
            if _streams(tenants) != want:
                raise SystemExit(f"doctor arm {overlap} gave other tokens than the standalone "
                                 f"engines")
            if counted != decodes or decodes == 0:
                raise SystemExit(f"doctor arm {overlap} launched greedy_sample {counted} times "
                                 f"for {decodes} fused decode launches")
            if problems:
                raise SystemExit(f"doctor arm {overlap}: invalid trace: {problems[:5]}")
            reports[overlap] = (rep, live)
            launches += counted
        rep, live = reports["serialized"]
        got = {"makespan": rep.cluster.makespan, "bytes_sent": rep.cluster.bytes_sent,
               "bytes_elided": rep.cluster.bytes_elided,
               "tokens_per_kcycle": rep.tokens_per_kcycle}
        if got != {k: base[k] for k in got}:
            raise SystemExit(f"the tracer moved the cycle model: traced serialized {got}, "
                             f"untraced affinity {base}")
        out = os.path.join(out_dir, "DOCTOR_serialized.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.doctor", paths["serialized"], "--against",
             paths["overlapped"], "--json", out],
            env={**os.environ, "PYTHONPATH": os.path.join(here, "src")}, cwd=here,
            capture_output=True, text=True, timeout=300)
        doctor_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"[doctor] | {line}")
        if proc.returncode != 0:
            raise SystemExit(f"the doctor exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            payload = json.load(f)
        diagnosis, delta = payload["diagnosis"], payload["diff"]["makespan"]["delta"]
        top = diagnosis["recommendations"][0] if diagnosis["recommendations"] else None
        want_delta = rep.cluster.makespan - reports["overlapped"][0].cluster.makespan
        print(f"[doctor] python -m repro_torch.obs.doctor TRACE_serialized.json --against "
              f"TRACE_overlapped.json: exit 0 in {doctor_s:.2f} s; regime "
              f"{diagnosis['regime']['label']} (live serialized report: {live.regime.label}); "
              f"exposed config {diagnosis['stats']['exposed_config']:.1f} model cycles; top "
              f"recommendation "
              + (f"{top['action']}, predicted saving {top['predicted_savings']:.1f} model cycles "
                 f"({'an upper bound' if top['bound'] else 'a replay'})" if top else "none")
              + f"; diff makespan delta {delta:+.1f} model cycles (the reports' "
              f"{want_delta:+.1f})")
        if diagnosis["regime"]["label"] != live.regime.label:
            raise SystemExit(f"the doctor's regime {diagnosis['regime']['label']} is not the "
                             f"live report's {live.regime.label}")
        if delta != want_delta:
            raise SystemExit(f"the diff's makespan delta {delta} is not the reports' {want_delta}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print("[doctor] both traced arms' token streams equal the standalone engines'; attribution "
          "conserved; the serialized arm's model numbers equal the untraced arm's; the doctor "
          "agrees with the live diagnosis")
    return launches


def phase_compiler() -> None:
    """The paper's compiler through the port's copies: ``evaluate_levels``
    over the OpenGeMM tiled matmul at K = 16-256 (all four levels) and the
    Gemmini one at K = 16-512 (baseline and dedup), each geomean held to
    ``tests/test_paper_claims.py``'s bands. The cycle model's numbers, not
    the card's."""
    from repro_torch.core import accelerators, evaluate_levels, geomean, matmul_driver, speedup

    t0 = time.perf_counter()
    sweeps = {"opengemm": ((16, 32, 64, 128, 256), "both", ("baseline", "dedup", "overlap",
                                                            "both")),
              "gemmini": ((16, 32, 64, 128, 256, 512), "dedup", ("baseline", "dedup"))}
    means = {}
    for kind, (sizes, level, levels) in sweeps.items():
        models = {kind: getattr(accelerators, f"{kind}_like")()}
        build = getattr(matmul_driver, f"{kind}_tiled_matmul")
        sp = [speedup(evaluate_levels(lambda k=k: build(k), models, levels=levels), level)
              for k in sizes]
        means[kind] = (geomean(sp), max(sp))
        print(f"[compiler] {kind}: speedup of '{level}' over 'baseline' (model cycles) by K "
              + ", ".join(f"{k}: {x:.4f}" for k, x in zip(sizes, sp))
              + f"; geomean {means[kind][0]:.4f}, max {means[kind][1]:.4f}")
    print(f"[compiler] evaluated in {time.perf_counter() - t0:.2f} s on the host")
    og, gem = means["opengemm"], means["gemmini"]
    if not (1.7 <= og[0] <= 2.6 and og[1] >= 2.2):
        raise SystemExit(f"OpenGeMM geomean {og[0]} (max {og[1]}) outside the paper's band")
    if not 1.04 <= gem[0] <= 1.20:
        raise SystemExit(f"Gemmini geomean {gem[0]} outside the paper's band")


def _router_check(smi: str, tag: str, e: int, k: int, prefix: str = "router_") -> dict:
    """top_k against its plain version at a router's shapes, ids and values
    exactly: (4, e) and (16, e) f32 probabilities, and rows of exact ties
    (the pattern 1, 3, 2, 3 repeated), where the lowest expert indices of
    the maximum must win; then timed at the decode shape (4, e) beside
    torch.topk and its bound. The record's keys start with ``prefix``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import plan_top_k, top_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    pattern = [1.0, 3.0, 2.0, 3.0] * (e // 4)
    ties = torch.softmax(torch.tensor([pattern] * 4, device="cuda"), -1)
    cases = {f"({t}, {e})": torch.softmax(torch.randn((t, e), generator=gen, device="cuda"), -1)
             for t in (4, 16)}
    cases[f"(4, {e}) exact ties"] = ties
    for label, x in cases.items():
        got_v, got_i = top_k(x, k)
        want_v, want_i = ref.top_k_ref(x, k)
        torch.cuda.synchronize()
        print(f"{tag} top_k router {label} f32 k={k}: blocks per row="
              f"{plan_top_k(*x.shape, k).splits} ids {got_i[0].tolist()} "
              f"exact={torch.equal(got_i, want_i) and torch.equal(got_v, want_v)}")
        torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
        torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    lowest = [i for i, v in enumerate(pattern) if v == 3.0][:k]
    if got_i.tolist() != [lowest] * 4:
        raise SystemExit(f"top_k broke exact router ties as {got_i.tolist()}, not {lowest}")
    x = cases[f"(4, {e})"]
    bound = _bound_ms(x.numel() * 4 + x.shape[0] * k * 8, 0.0, 1.0)
    ms = _timed(f"top_k router (4, {e}) f32 k={k}", {
        "ms": lambda: top_k(x, k), "plain_ms": lambda: ref.top_k_ref(x, k),
        "library_ms": lambda: torch.topk(x, k)}, *bound, smi)
    return {f"{prefix}ms": ms["ms"], f"{prefix}plain_ms": ms["plain_ms"],
            f"{prefix}library_ms": ms["library_ms"], f"{prefix}bound_ms": bound[0]}


# ----------------------------------------------------------------------------
# forward against teacher-forced decode, by evidence no weight draw decides


@contextlib.contextmanager
def fault(name: str | None, most_rows: int | None = None):
    """A decode made wrong on purpose, for :func:`_decode_parity` to catch
    (``parity_sweep.py --mutate``, ``tests/test_torch_parity_checks.py``);
    the forward is untouched. ``"kv_row"``: every attention over a KV cache
    reads each cached row one position late (the rows rolled by one along
    the cache, the row's own new K/V with them). ``"state"``: the first recurrent layer (an ssm's layer 0, a
    hybrid's first Mamba layer) never writes its state. ``None``: no fault.
    With ``most_rows``, only decode steps of at most that many rows are
    wrong: the decode padded to B·S rows is right, so the B-row rules must
    catch the fault alone."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    def hit(rows: int) -> bool:
        return most_rows is None or rows <= most_rows

    if name is None:
        yield
        return
    if name == "kv_row":
        from repro_torch.kernels import ops

        cached, attend = L._cached_kv, ops.decode_attention_op

        def late(cache, k, *args):  # the int8 and sharded caches' route
            k_all, v_all = cached(cache, k, *args)
            return (k_all.roll(1, 1), v_all.roll(1, 1)) if hit(k.shape[0]) else (k_all, v_all)

        def late_op(q, k_cache, v_cache, k, v, pos):  # a bf16 cache's route
            if not hit(q.shape[0]):
                return attend(q, k_cache, v_cache, k, v, pos)
            t = k_cache.shape[1]
            own = (torch.arange(t, device=pos.device)[None, :] == pos[:, None])[..., None, None]
            k_all = torch.where(own, k, k_cache).roll(1, 1)  # the own row rolled with the rest,
            v_all = torch.where(own, v, v_cache).roll(1, 1)  # as over the other routes
            rows, at = torch.arange(q.shape[0], device=pos.device), pos.clamp(max=t - 1)
            return attend(q, k_all, v_all, k_all[rows, at][:, None], v_all[rows, at][:, None],
                          pos)

        L._cached_kv, ops.decode_attention_op = late, late_op
        try:
            yield
        finally:
            L._cached_kv, ops.decode_attention_op = cached, attend
        return
    if name != "state":
        raise ValueError(f"no fault {name!r}; the faults are {FAULTS}")
    masked = Model.__dict__["_masked_cache"]

    def forgetful(cache, new, update_mask, layer):
        if layer not in (0, (0, 0)) or not hit(next(iter(new.values())).shape[0]):
            masked.__func__(cache, new, update_mask, layer)

    Model._masked_cache = staticmethod(forgetful)
    try:
        yield
    finally:
        Model._masked_cache = masked


def faults_of(cfg) -> tuple:
    """The faults a family's decode has a place for: a KV cache, a state, or both."""
    return {"ssm": ("state",), "hybrid": FAULTS}.get(cfg.family, ("kv_row",))


def _f32(tree: dict) -> dict:
    """The tree in f32, but an MoE layer's experts, which :func:`_f32_forward`
    casts a few at a time."""
    out = {}
    for k, v in tree.items():
        if not isinstance(v, dict):
            out[k] = v.float()
        elif k in ("moe", "mamba_moe"):
            out[k] = {**v, "router": v["router"].float()}
        else:
            out[k] = _f32(v)
    return out


def _f32_forward(model, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``forward``'s logits with every operation in f32 (weights cast up a
    layer at a time, a hybrid's a group at a time; an MoE layer's experts
    a few at a time, at most 2**28 elements of f32 each; TF32 off on a
    card): the function both bf16 paths approximate. Returns f32 logits."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model, _norm

    cfg = model.cfg
    if model.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("the f32 forward needs TF32 off")
    key, per = ("groups", cfg.attn_period) if cfg.family == "hybrid" else ("layers", 1)
    one = Model(dataclasses.replace(cfg, n_layers=per), device=model.device)
    ffn = L._moe_ffn

    def in_parts(p: dict, buf: torch.Tensor) -> torch.Tensor:
        part = max(1, (1 << 28) // p["wi"][0].numel())
        return torch.cat([ffn({w: p[w][e:e + part].to(buf.dtype) for w in ("wi", "wg", "wo")},
                              buf[e:e + part]) for e in range(0, buf.shape[0], part)])

    def layer(tree: dict, i: int) -> dict:
        return {k: layer(v, i) if isinstance(v, dict) else v[i:i + 1] for k, v in tree.items()}

    L._moe_ffn = in_parts
    try:
        x = params["embed"][tokens].float()
        for i in range(cfg.n_layers // per):
            x = one.trunk({key: _f32(layer(params[key], i))}, x)[0]
    finally:
        L._moe_ffn = ffn
    x = _norm(_f32(params["final_norm"]), x, cfg.norm_eps)
    return x @ model._head(params).float()


@contextlib.contextmanager
def _plain_decode_attention():
    """``kernels.ops.decode_attention_op`` by its plain version, on a card
    too; a fault planted around the op stays around it."""
    from repro_torch.kernels import ops, ref

    kernel = ops.decode_attention
    ops.decode_attention = ref.decode_attention_ref
    try:
        yield
    finally:
        ops.decode_attention = kernel


def _teacher_forced(model, params: dict, tokens: torch.Tensor, rows: int) -> torch.Tensor:
    """``decode_step`` over ``tokens`` (B, S) from an empty cache, the batch
    padded to ``rows`` with copies of row 0: the B rows' (B, S, V) logits."""
    b, s = tokens.shape
    padded = torch.cat([tokens, tokens[:1].expand(rows - b, s)])
    cache, steps = model.init_cache(rows, s), []
    for i in range(s):
        logits, cache = model.decode_step(params, cache, padded[:, i:i + 1], i)
        steps.append(logits[:b, 0])
    return torch.stack(steps, 1)


@contextlib.contextmanager
def _routes(calls: list):
    """Every router call meanwhile: (probabilities, chosen experts) in numpy."""
    from repro_torch.models import layers as L

    route = L._moe_route

    def recorded(p, cfg, xt):
        out = route(p, cfg, xt)
        probs = torch.softmax((xt.double() @ p["router"].double()).float(), dim=-1)
        calls.append((probs.cpu().numpy(), out[1].cpu().numpy()))
        return out

    L._moe_route = recorded
    try:
        yield
    finally:
        L._moe_route = route


def _mamba_f32(model, params: dict, tag: str, b: int, s: int) -> None:
    """The hybrid's exact part: its first Mamba layer in f32 at the model's
    widths, ``mamba_apply`` (the associative scan) against ``mamba_step`` run
    over the same seeded (B, S, d) sequence from a zero state; the largest
    difference within ``MAMBA_F32_TOL`` of the output's largest magnitude."""
    from repro_torch.models import layers as L

    cfg, dev = model.cfg, model.device
    lp = _f32({k: v[0, 0] for k, v in params["groups"]["mamba"].items()})
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    d_in = cfg.ssm_expand * cfg.d_model
    state = {"h": torch.zeros((b, d_in, cfg.ssm_state_dim), device=dev),
             "conv": torch.zeros((b, cfg.ssm_conv_dim, d_in), device=dev)}
    steps = []
    for i in range(s):
        y, state = L.mamba_step(lp, cfg, x[:, i:i + 1], state)
        steps.append(y)
    full, stepped = L.mamba_apply(lp, cfg, x), torch.cat(steps, 1)
    err, scale = float((full - stepped).abs().max()), float(full.abs().max())
    print(f"{tag} one Mamba layer in f32, d_model {cfg.d_model}, d_in {d_in}, N "
          f"{cfg.ssm_state_dim}, B={b} S={s}: mamba_apply (associative scan) against "
          f"mamba_step: max_abs_diff={err:.3e} of max |y| {scale:.4f} = {err / scale:.3e} "
          f"(<= {MAMBA_F32_TOL})")
    if not err <= MAMBA_F32_TOL * scale:
        raise SystemExit(f"{tag} mamba_apply and mamba_step differ by {err} in f32, more than "
                         f"{MAMBA_F32_TOL} of {scale}")


@contextlib.contextmanager
def _boundaries(seen: list):
    """Meanwhile the residual stream at every layer boundary of the model's
    loops (``models.model``'s ``constrain`` calls) is appended to ``seen``
    as f32 numpy, in call order."""
    from repro_torch.models import model as M

    pin = M.constrain

    def recorded(x):
        seen.append(x.detach().float().cpu().numpy())
        return pin(x)

    M.constrain = recorded
    try:
        yield
    finally:
        M.constrain = pin


def _hybrid_kinds(cfg) -> list[str]:
    """The layer kind ending at each boundary of a hybrid group after the
    first (the trunk's entry): attention with its dense MLP, then each
    Mamba layer with its MLP, MoE at even in-group positions."""
    kinds = ["attention"]
    for i in range(cfg.attn_period - 1):
        kinds.append("Mamba+MoE" if i % 2 == 0 else "Mamba+MLP")
    return kinds * (cfg.n_layers // cfg.attn_period)


@contextlib.contextmanager
def _stepped_mamba():
    """Meanwhile every ``mamba_apply`` runs ``mamba_step``'s formulation over
    the sequence: the window's products summed in f32 oldest first and
    rounded once, the recurrence a position at a time; each product over
    all B·S rows at once and the state contraction over all positions at
    once, as the forward runs them. A decode padded to B·S rows then runs
    the same operations on the same shapes, so its logits are this
    forward's bit for bit; :func:`_mamba_f32` holds the formulation to
    the associative scan."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    scan = L.mamba_apply

    def stepped(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
        s, n, kc = x.shape[1], cfg.ssm_state_dim, cfg.ssm_conv_dim
        xi, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
        pad, w = F.pad(xi, (0, 0, kc - 1, 0)), params["conv_w"].float()
        acc = pad[:, :s].float() * w[0]
        for i in range(1, kc):
            acc = acc + pad[:, i:i + s].float() * w[i]
        xi = L._silu(acc.to(x.dtype))
        bc_dt = xi @ params["x_proj"]
        bvec, cvec, dt = bc_dt[..., :n], bc_dt[..., n:2 * n], bc_dt[..., 2 * n:]
        dt = L._softplus(dt.float() + params["dt_bias"])
        a_bar = torch.exp(dt[..., None] * -torch.exp(params["a_log"]))
        bx = (dt * xi.float())[..., None] * bvec.float()[:, :, None, :]
        h, states = torch.zeros_like(a_bar[:, 0]), []
        for t in range(s):
            h = a_bar[:, t] * h + bx[:, t]
            states.append(h)
        return L._mamba_gate(params, L._mamba_contract(torch.stack(states, 1), cvec), xi, z,
                             x.dtype)

    L.mamba_apply = stepped
    try:
        yield
    finally:
        L.mamba_apply = scan


def _decode_parity(model, params: dict, tag: str, b: int = PARITY_ROWS, s: int = 8) -> dict:
    """``forward`` against teacher-forced ``decode_step`` on the model's
    device (the card, or the CPU in the tests), an MoE model at drop-free
    capacity (``test_decode_parity``'s). The two paths run other product
    shapes (B·S rows against B), so on a card their bf16 roundings part,
    and through many layers of random weights that decides raw tolerances
    and top-1 agreement by the draw. What decides here holds a correct
    program on every draw and fails a wrong one (``parity_sweep.py``,
    ``--mutate``):

    1. Exact: decode with its batch padded to the forward's B·S rows, its
       attention over the cache by the plain version (the forward's
       einsums; the kernel sums in another order and is held to the plain
       version by ``check_decode_attention``), gives the forward's logits
       bit for bit. A hybrid's forward scans where
       decode steps the recurrence, so here its forward runs each Mamba
       layer in the step's formulation (:func:`_stepped_mamba`), and the
       two formulations are held to each other in f32
       (:func:`_mamba_f32`); the scan's bf16 forward is printed beside.
    2. Distance: against the forward in f32 (:func:`_f32_forward`), the
       B-row decode's largest distance within ``F32_RATIO`` times the bf16
       forward's: neither path approximates the model worse than the other
       by more than their rounding spread. Over the positions before a
       row's first routing divergence (any layer, between any two of the
       three paths): past it the paths compute different routes, and
       attention and a recurrent state carry that to every later position.
    3. Routes: where the bf16 forward and decode first route a row apart,
       at the first layer that does so, at a near-tie: the k-th/(k+1)-th
       probability margin within twice the largest probability gap between
       the paths where neither has yet routed that row apart.

    Top-1 agreement and ``test_decode_parity``'s tolerance fractions are
    printed and decide nothing. A failure raises ``SystemExit``. Returns the
    distance ratio, the positions compared and the routes parted."""
    from repro_torch.models.model import Model

    cfg, dev = model.cfg, model.device
    if cfg.n_experts:
        model = Model(dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    calls: list = []
    hybrid = cfg.family == "hybrid"
    stepped = _stepped_mamba() if hybrid else contextlib.nullcontext()
    seen = {"fwd": [], "dec": [], "wide": []}  # the hybrid's residual stream a boundary
    watch = _boundaries if hybrid else lambda _: contextlib.nullcontext()
    with _routes(calls):
        with stepped, watch(seen["fwd"]):
            fwd, aux = model.forward(params, {"tokens": tokens})
        n = len(calls)  # router calls a pass
        with watch(seen["dec"]):
            dec = _teacher_forced(model, params, tokens, b)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with watch(seen["wide"]):
            wide = _f32_forward(model, params, tokens).cpu().numpy()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    with _plain_decode_attention():
        padded = _teacher_forced(model, params, tokens, b * s)
    same = torch.equal(padded, fwd)
    print(f"{tag} decode padded to the forward's {b * s} product rows, its attention over the "
          f"cache by the plain version, equals the forward"
          f"{' with its Mamba layers stepped' if cfg.family == 'hybrid' else ''} bit for "
          f"bit: {same}")
    if not same:
        raise SystemExit(f"{tag} decode over {b * s} rows differs from the forward's logits")
    del padded
    if cfg.family == "hybrid":
        _mamba_f32(model, params, tag, b, s)
        scan = model.forward(params, {"tokens": tokens})[0].float().cpu().numpy()
        print(f"{tag} the forward with its Mamba layers scanned (its convolution summed in "
              f"bf16, the reference's): largest distance from the f32 forward "
              f"{np.abs(scan - wide).max():.4f}, from the stepped one "
              f"{np.abs(scan - fwd.float().cpu().numpy()).max():.4f} (printed, not decided)")

    a, d = fwd.float().cpu().numpy(), dec.float().cpu().numpy()
    finite = bool(np.isfinite(a).all() and np.isfinite(d).all() and np.isfinite(wide).all()
                  and np.isfinite(float(aux)))
    k = cfg.experts_per_token
    parted = {}  # (row, position) -> (first router call where forward and decode part, margin)
    f32_parted = set()  # (row, position) the f32 forward routes apart from the bf16 forward
    gaps = []  # (row, position, call, probability gap) where neither path has parted yet
    for call in range(n):
        fp = calls[call][0].reshape(b, s, -1)
        fe = np.sort(calls[call][1].reshape(b, s, k), -1)
        we = np.sort(calls[n + s * n + call][1].reshape(b, s, k), -1)
        for i in range(s):
            dp, de = calls[n + i * n + call]
            for r in range(b):
                if not np.array_equal(fe[r, i], we[r, i]):
                    f32_parted.add((r, i))
                if (r, i) in parted:
                    continue
                if not np.array_equal(fe[r, i], np.sort(de[r])):
                    top = np.sort(fp[r, i])[::-1]
                    parted[(r, i)] = (call, float(top[k - 1] - top[k]))
                else:
                    gaps.append((r, i, call, float(np.abs(fp[r, i] - dp[r]).max())))

    def upstream(r: int, i: int, call: int) -> bool:
        """No earlier position of row r parted before this router call."""
        return all(c >= call for (r2, j), (c, _) in parted.items() if r2 == r and j < i)

    first = {r: min([i for (r2, i) in (*parted, *f32_parted) if r2 == r], default=s)
             for r in range(b)}
    compared = [(r, i) for r in range(b) for i in range(first[r])]
    if not compared or not finite:
        raise SystemExit(f"{tag} every row's routes part at position 0 ({parted}, "
                         f"{sorted(f32_parted)}), or the logits are not finite")
    rows, cols = zip(*compared)
    to_fwd, to_dec = np.abs(a - wide)[rows, cols], np.abs(d - wide)[rows, cols]
    ratio = float(to_dec.max() / to_fwd.max()) if to_fwd.max() else float(to_dec.max() > 0) * np.inf
    top1 = float((a.argmax(-1) == d.argmax(-1)).mean())
    within = np.isclose(d, a, rtol=PARITY_RTOL, atol=PARITY_ATOL).mean(axis=(0, 2))
    by_pos = lambda x: [round(float(v), 4) for v in x.max(axis=(0, 2))]  # noqa: E731
    print(f"{tag} forward vs decode_step B={b} S={s}: max_abs_diff by position "
          f"{by_pos(np.abs(a - d))}, within rtol {PARITY_RTOL} atol {PARITY_ATOL} by position "
          f"{[round(float(x), 4) for x in within]}, top1 agreement {top1:.4f} (printed, not "
          f"decided); aux={float(aux):.6f}, finite={finite}")
    print(f"{tag} against the f32 forward (max_memory_allocated while it ran={peak} B) over "
          f"the {len(compared)} of {b * s} positions before each row's first routing "
          f"divergence: the bf16 forward's largest distance {to_fwd.max():.4f}, the {b}-row "
          f"decode's {to_dec.max():.4f} = {ratio:.4f}x (<= {F32_RATIO}); top1 with f32: forward "
          f"{(a.argmax(-1) == wide.argmax(-1)).mean():.4f}, decode "
          f"{(d.argmax(-1) == wide.argmax(-1)).mean():.4f}")
    by_kind = {}
    if hybrid:  # the same distance ratio after each layer, by its kind
        steps = len(seen["dec"]) // s
        dec_at = [np.concatenate([seen["dec"][i * steps + j] for i in range(s)], 1)
                  for j in range(steps)]
        per = cfg.attn_period + 1  # the f32 forward runs a group a trunk: its entry again
        seen["wide"] = seen["wide"][:1] + [w for g in range(0, len(seen["wide"]), per)
                                           for w in seen["wide"][g + 1:g + per]]
        for j, kind in enumerate(_hybrid_kinds(cfg), start=1):
            f_, w_, d_ = (x[rows, cols] for x in (seen["fwd"][j], seen["wide"][j], dec_at[j]))
            r_ = float(np.abs(d_ - w_).max() / max(float(np.abs(f_ - w_).max()), 1e-30))
            by_kind.setdefault(kind, []).append(round(r_, 4))
        print(f"{tag} the same ratio for the residual stream after each layer, by kind "
              f"(printed, not decided): {by_kind}; the logits' {ratio:.4f}")
    if ratio > F32_RATIO:
        raise SystemExit(f"{tag} the decode lies {ratio}x as far from the f32 forward as the "
                         f"forward does (> {F32_RATIO})")
    judged = {t: m for t, (call, m) in parted.items() if upstream(*t, call)}
    if n:
        gap = max((g for r, i, call, g in gaps if upstream(r, i, call)), default=0.0)
        wide_flips = {t: m for t, m in judged.items() if m > 2 * gap}
        print(f"{tag} routes over {n} router calls a pass, capacity factor "
              f"{model.cfg.capacity_factor}: forward and decode part {len(parted)} of {b * s} "
              f"tokens (first call, k-th/(k+1)-th margin: {parted}), {len(judged)} of them "
              f"before any earlier position of their row parted; the f32 forward parts "
              f"{len(f32_parted)}; largest probability gap before any parting {gap:.6f}")
        if wide_flips:
            raise SystemExit(f"{tag} forward and decode routed tokens apart at margins "
                             f"{wide_flips}, wider than twice the rounding gap {gap}")
    return {"ratio": ratio, "compared": len(compared), "parted": len(parted),
            "judged": len(judged), "f32_parted": len(f32_parted),
            **({"by_kind": by_kind} if by_kind else {})}


def _masked_fused_step(model, params, cache: dict) -> None:
    """One eager ``decode_and_sample`` step of 4 slots at their own
    positions, slot 3 masked out, under ``set_sync_debug_mode("error")``:
    nothing in a fused step may read the card back, or capture breaks. A
    first step on a copy of ``cache`` builds the kernel and warms the
    path."""
    b = SERVE_BATCH
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    overrides = torch.zeros((b,), dtype=torch.int32, device="cuda")
    pos = torch.tensor([0, 3, 5, 0], dtype=torch.int32, device="cuda")
    live = torch.tensor([True, True, True, False], device="cuda")
    model.decode_and_sample(params, {k: v.clone() for k, v in cache.items()}, ones, overrides,
                            live, pos, live)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_and_sample(params, cache, ones, overrides, live, pos, live)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _tree_bytes(params: dict) -> tuple[int, dict]:
    """The tree's parameter count and its bytes by top-level name."""
    from repro_torch.dispatch.executor import flatten_with_path

    n, nbytes = 0, {}
    for path, p in flatten_with_path(params):
        top = path.split("'")[1]
        n += p.numel()
        nbytes[top] = nbytes.get(top, 0) + p.numel() * p.element_size()
    return n, nbytes


def _free_model(tag: str, found: int) -> None:
    """Collects the phase's garbage (engines and executors hold the weights
    through reference cycles), empties the allocator's cache, and fails
    unless the memory allocated is back within ``FREED_SLACK`` of
    ``found``, what the phase found. The caller has dropped its names."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"{tag} memory_allocated after freeing the model={left} B (before building it: "
          f"{found} B)")
    if left > found + FREED_SLACK:
        raise SystemExit(f"{tag} the phase left {left - found} B allocated after freeing "
                         f"its model")


def phase_moe(smi: str) -> dict:
    """The MoE family at its published widths: phi-3.5-MoE cut to 16 of its
    32 layers (the first of two pipeline stages of a two-card deployment;
    all 32 would not fit one card), seeded weights. Forward against
    teacher-forced decode at drop-free capacity; the router's top_k at its
    shapes; one eager fused step under ``set_sync_debug_mode("error")``
    (nothing may read the card back, or capture breaks); the serving engine
    fused and host-sampled on the same requests, with greedy_sample and
    top_k counted from 0 just before the fused run and read just after;
    ``launch.serve``'s loop in its three modes. Frees the model at the end."""
    from repro_torch.configs import get
    from repro_torch.kernels.sampling import greedy_sample, top_k
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    full = get(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    n = cfg.param_count()
    print(f"[moe] {MOE_ARCH}: depth cut to {cfg.n_layers} of {full.n_layers} layers (the first "
          f"of two pipeline stages); widths as published: d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} KV heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"{cfg.n_experts} experts top-{cfg.experts_per_token}, vocab {cfg.vocab_size}, "
          f"capacity factor {cfg.capacity_factor}; {n} parameters, {2 * n / 1e9:.2f} GB in "
          f"bf16 (all {full.n_layers} layers: {2 * full.param_count() / 1e9:.2f} GB)")
    router = _router_check(smi, "[moe]", 16, 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    found = torch.cuda.memory_allocated()
    ti = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    print(f"[moe] seeded weights drawn on the card in {time.perf_counter() - ti:.2f} s; "
          f"memory_allocated={torch.cuda.memory_allocated()} B, max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} B")

    _masked_fused_step(model, params, model.init_cache(SERVE_BATCH, MOE_CACHE))
    print("[moe] one masked fused decode step under set_sync_debug_mode('error'): no read-back")

    _decode_parity(model, params, "[moe]")

    # the serving engine, fused then host-sampled
    reqs = _requests(cfg, MOE_REQUESTS, MOE_PROMPT)
    _serve(model, params, reqs[:1], "fused", max_new=2, tag="[moe]")  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    greedy_sample.launches = top_k.launches = 0
    fused = _serve(model, params, reqs, "fused", max_new=MOE_NEW, tag="[moe]")
    counted = {"greedy_sample": greedy_sample.launches, "top_k": top_k.launches}
    eager_steps = fused["decode_launches"] + 8 * fused["prefill_launches"]
    print(f"[moe] launches in the fused run: {counted}; {fused['decode_launches']} fused decode "
          f"launches, {fused['prefill_launches']} prefill launches of 8 steps, so "
          f"{eager_steps} eager steps of {cfg.n_layers} routers; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} B")
    if counted["greedy_sample"] != fused["decode_launches"] or counted["greedy_sample"] == 0:
        raise SystemExit("the MoE engine did not launch greedy_sample once per fused decode launch")
    if counted["top_k"] != cfg.n_layers * eager_steps:
        raise SystemExit(f"the MoE engine launched top_k {counted['top_k']} times for "
                         f"{eager_steps} eager steps of {cfg.n_layers} layers")
    for uid, _ in reqs:
        if len(fused["streams"][uid]) != MOE_NEW:
            raise SystemExit(f"MoE request {uid} finished with {len(fused['streams'][uid])} tokens")
    top_k.launches = 0
    host = _serve(model, params, reqs, "host", max_new=MOE_NEW, tag="[moe]")
    host_steps = host["decode_launches"] + 8 * host["prefill_launches"]
    if host["streams"] != fused["streams"]:
        raise SystemExit("MoE fused and host sampling gave different token streams")
    if top_k.launches != cfg.n_layers * host_steps:
        raise SystemExit(f"the host-sampled MoE engine launched top_k {top_k.launches} times "
                         f"for {host_steps} eager steps")
    print(f"[moe] fused and host token streams are bit-identical; top_k launched "
          f"{cfg.n_layers} times an eager step in both runs; first stream "
          f"{fused['streams'][0][:8]}")

    phase_serve_modes(model, params, smi, steps=MOE_STEPS, cache_len=MOE_CACHE, tag="[moe]",
                      profiled=("fused",))
    del model, params
    _free_model("[moe]", found)
    print(f"[moe] phase took {time.perf_counter() - t0:.1f} s")
    return {"top_k": counted["top_k"], "greedy_sample": counted["greedy_sample"], **router}


def _chunk_layout(x: torch.Tensor, plan) -> str:
    """Where each row's first and last chunk start, modulo 16 bytes, and how
    many elements the kernel takes one by one before the first 16-byte
    boundary (head) and after the last whole vector (tail)."""
    b, v = x.shape
    size, vec = x.element_size(), 16 // x.element_size()
    parts = []
    for r in range(b):
        for start, stop in (plan.bounds(v)[0], plan.bounds(v)[-1]):
            addr = x.data_ptr() + (r * v + start) * size
            head = min((16 - addr % 16) % 16 // size, stop - start)
            parts.append(f"row {r} chunk@{start}: +{addr % 16} mod 16, head {head}, "
                         f"tail {(stop - start - head) % vec}")
    return f"row stride {v * size} B; " + "; ".join(parts)


def _head_greedy_check(smi: str, tag: str, v: int, seed: int) -> dict:
    """greedy_sample exactly against its plain version at a served head's
    shapes, (4, v) and (1, v) bf16: random rows, ties and NaNs straddling
    every chunk boundary of the plan it takes there, and the maximum in the
    scalar head and in the scalar tail of each row (at an odd v a bf16 row
    starts 2r bytes past a 16-byte boundary; the one row of B = 1 is laid 2
    bytes past one), each call printing its cluster and the rows' chunk
    addresses; then timed at both beside torch.argmax and its bound. The
    record's keys take the phase's name as a suffix."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import greedy_sample, plan_greedy_sample

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst, out = 0, {}
    for b in (4, 1):
        plan, offset = plan_greedy_sample(b, v), 2 if b == 1 else 0

        def laid(rows: torch.Tensor) -> torch.Tensor:  # row 0 `offset` bytes past a boundary
            rows = rows.to(torch.bfloat16)
            return _off_alignment(rows) if offset else rows

        head = torch.full((b, v), -1.0, device="cuda")
        for r in range(b):  # the last element before the row's first 16-byte boundary
            head[r, max((16 - (offset + r * 2 * v) % 16) % 16 // 2 - 1, 0)] = 7.0
        tail = torch.full((b, v), -1.0, device="cuda")
        tail[:, v - 1] = 7.0
        x = torch.randn((b, v), generator=gen, device="cuda").to(torch.bfloat16)
        cases = {"random": (x, None),
                 "across cluster chunks": (_across_cluster_chunks(b, v).to(torch.bfloat16), None),
                 "max in the scalar head": (laid(head), head.argmax(-1).int()),
                 "max in the scalar tail": (laid(tail), tail.argmax(-1).int())}
        print(f"{tag} greedy_sample B={b} V={v} bf16, plan {plan}; rows: "
              f"{_chunk_layout(cases['max in the scalar head'][0], plan)}")
        for label, (case, at) in cases.items():
            got, cluster = _cluster_of(lambda: greedy_sample(case))
            want = ref.greedy_sample_ref(case)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            print(f"{tag} greedy_sample {label} B={b} V={v} bf16: cluster={cluster} "
                  f"ids {got.tolist()} max_abs_err={err}")
            if err or (at is not None and not torch.equal(got, at)):
                raise SystemExit(f"greedy_sample disagrees with its plain version on {label} "
                                 f"B={b} V={v}: {got.tolist()} vs {want.tolist()}")
        bound = _bound_ms(x.numel() * x.element_size() + b * 4, 0.0, 1.0)
        ms = _timed(f"greedy_sample B={b} V={v} bf16, cluster of {cluster}", {
            "ms": lambda: greedy_sample(x), "plain_ms": lambda: ref.greedy_sample_ref(x),
            "library_ms": lambda: torch.argmax(x, dim=-1)}, *bound, smi)
        out[b] = {"ms": ms, "bound": bound, "cluster": cluster}
    four, one, sfx = out[4], out[1], tag.strip("[]")
    return {"max_abs_err": worst, f"cluster_{sfx}": four["cluster"],
            f"ms_{sfx}": four["ms"]["ms"], f"plain_ms_{sfx}": four["ms"]["plain_ms"],
            f"library_ms_{sfx}": four["ms"]["library_ms"], f"bound_ms_{sfx}": four["bound"][0],
            f"ms_{sfx}_b1": one["ms"]["ms"], f"library_ms_{sfx}_b1": one["ms"]["library_ms"]}


def _random_cache(cache: dict, seed: int) -> dict:
    """Fills every leaf with seeded normal values, in place; returns a copy."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for v in cache.values():
        v.copy_(torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype))
    return {k: v.clone() for k, v in cache.items()}


def phase_ssm(smi: str) -> dict:
    """The ssm family: rwkv6-7b whole (32 of 32 layers at its published
    widths), seeded weights. greedy_sample at the head's shapes; forward
    against teacher-forced decode and an f32 forward; one masked eager
    fused step under ``set_sync_debug_mode("error")``, the masked row's
    state bit-identical after it; the serving engine fused and
    host-sampled on the same requests, with greedy_sample counted from 0
    just before the fused run and read just after, then fused over twice
    as many requests as slots; ``launch.serve``'s loop in its three modes
    beside the step's bound. Frees the model at the end, and checks that
    it is gone."""
    from repro_torch.configs import get
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = get(SSM_ARCH)
    greedy = _head_greedy_check(smi, "[ssm]", SSM_V, SEED + 9)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    found = torch.cuda.memory_allocated()
    ti = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    n, nbytes = _tree_bytes(params)  # by top-level name: embed, final_norm, head, layers
    print(f"[ssm] {SSM_ARCH} whole: {cfg.n_layers} of {cfg.n_layers} layers; widths as "
          f"published: d_model {cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n} parameters in the "
          f"tree, {sum(nbytes.values()) / 1e9:.2f} GB (trunk {nbytes['layers'] / 1e9:.2f}, head "
          f"{nbytes['head'] / 1e9:.2f}); ModelConfig.param_count() estimates "
          f"{cfg.param_count()}; seeded on the card in {time.perf_counter() - ti:.2f} s, "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    if (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) != (32, 4096, 14336, 65536):
        raise SystemExit(f"{SSM_ARCH} is not at its published widths and depth")

    # one masked fused step over a random state: no read-back, slot 3 frozen
    b = SERVE_BATCH
    cache = model.init_cache(b, SERVE_CACHE)
    before = _random_cache(cache, SEED + 10)
    _masked_fused_step(model, params, cache)
    for k, v in cache.items():
        if not torch.equal(v[:, 3], before[k][:, 3]) or torch.equal(v[:, 0], before[k][:, 0]):
            raise SystemExit(f"the masked fused step changed the masked row's {k!r}, or left "
                             f"a live row's unchanged")
    state_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    del cache, before
    print(f"[ssm] one masked fused decode step under set_sync_debug_mode('error'): no "
          f"read-back; the masked row's s, shift_tm and shift_cm bit-identical, the live rows' "
          f"changed")

    _decode_parity(model, params, "[ssm]")
    torch.cuda.reset_peak_memory_stats()  # from here on: serving

    # the serving engine, fused then host-sampled
    reqs = _requests(cfg, SSM_REQUESTS, SSM_PROMPT)
    _serve(model, params, reqs[:1], "fused", max_new=2, tag="[ssm]")  # warm-up, not counted
    torch.cuda.synchronize()
    greedy_sample.launches = 0
    fused = _serve(model, params, reqs, "fused", max_new=SSM_NEW, tag="[ssm]")
    launches = greedy_sample.launches
    print(f"[ssm] greedy_sample launches in the fused run: {launches}; "
          f"{fused['decode_launches']} fused decode launches, {fused['prefill_launches']} "
          f"prefill launches of 8 steps")
    if launches == 0 or launches != fused["decode_launches"]:
        raise SystemExit("the ssm engine did not launch greedy_sample once per fused decode "
                         "launch")
    for uid, _ in reqs:
        if len(fused["streams"][uid]) != SSM_NEW:
            raise SystemExit(f"ssm request {uid} finished with {len(fused['streams'][uid])} "
                             f"tokens")
    host = _serve(model, params, reqs, "host", max_new=SSM_NEW, tag="[ssm]")
    if host["streams"] != fused["streams"]:
        raise SystemExit("ssm fused and host sampling gave different token streams")
    print(f"[ssm] fused and host token streams are bit-identical; first stream "
          f"{fused['streams'][0][:8]}")
    # the same prompts twice over the 4 slots: each copy takes a slot its
    # original freed, and must start from a zero state, not from the state left there
    copies = [(uid + len(reqs), prompt) for uid, prompt in reqs]
    reused = _serve(model, params, reqs + copies, "fused", max_new=SSM_NEW, tag="[ssm]")
    for uid, _ in reqs:
        if not (reused["streams"][uid] == reused["streams"][uid + len(reqs)]
                == fused["streams"][uid]):
            raise SystemExit(f"ssm request {uid + len(reqs)} in a reused slot did not give the "
                             f"stream of request {uid} in a fresh one")
    print(f"[ssm] {len(copies)} copies of the requests, each in a slot its original freed, give "
          f"the originals' streams bit for bit")

    modes = phase_serve_modes(model, params, smi, tag="[ssm]", profiled=("fused",))
    step_bytes = nbytes["layers"] + nbytes["head"] + b * cfg.d_model * 2 + 2 * state_bytes
    bound = _bound_ms(step_bytes, 2.0 * n * b, BF16_FLOPS)
    fused_ms = modes["fused"]["device_ms"]
    print(f"[ssm] a decode step's bound at B={b}: {step_bytes} B (trunk and head read once, "
          f"{b} embedding rows, the {state_bytes} B state read and written) = {bound[0]:.4f} ms "
          f"({bound[1]}); fused {fused_ms:.4f} ms a step = {fused_ms / bound[0]:.2f}x it, busy "
          f"{modes['fused']['busy_ms']:.4f} ms, idle {modes['fused']['idle']:.3f}; "
          f"max_memory_allocated while serving={torch.cuda.max_memory_allocated()} B ({smi})")
    del model, params
    _free_model("[ssm]", found)
    print(f"[ssm] phase took {time.perf_counter() - t0:.1f} s")
    return {"greedy_sample": launches, **greedy}


def phase_cut(smi: str, arch: str, tag: str, cut: dict, sfx: str) -> dict:
    """A configuration one card cannot hold whole, at its published widths
    cut in depth (``CUTS``), seeded weights drawn on the card:
    greedy_sample at the head's shapes; the router's top_k at (4, E) where
    no earlier phase checked that shape; the forward-vs-decode check
    (:func:`_decode_parity`); one masked eager fused step under
    ``set_sync_debug_mode("error")``, the masked row's cache bit-identical
    after it; the serving engine fused and host-sampled on the same
    requests, with greedy_sample and top_k counted from 0 just before the
    fused run and read just after (a hybrid also serves each request's copy
    in a slot the original freed, which must start afresh);
    ``launch.serve``'s three modes, the fused step beside the bound of
    reading its weights once; one eager step profiled. Frees the model at
    the end. Returns the record's counts and times under ``sfx``."""
    from repro_torch.configs import get
    from repro_torch.kernels.sampling import greedy_sample, top_k
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    full = get(arch)
    cfg = dataclasses.replace(full, **cut)
    n = cfg.param_count()
    mamba = (f", Mamba d_in {cfg.ssm_expand * cfg.d_model} state {cfg.ssm_state_dim} conv "
             f"{cfg.ssm_conv_dim}" if cfg.family == "hybrid" else "")
    print(f"{tag} {arch} ({cfg.family}): depth cut from {full.n_layers} layers to "
          f"{', '.join(f'{k} = {v}' for k, v in cut.items())}; widths as published: d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor}, vocab "
          f"{cfg.vocab_size}{mamba}; {n} parameters by ModelConfig.param_count(), "
          f"{2 * n / 1e9:.2f} GB in bf16 (whole: {full.param_count()}, "
          f"{2 * full.param_count() / 1e9:.2f} GB)")
    greedy = _head_greedy_check(smi, tag, cfg.vocab_size, SEED + 30 + len(cut))
    greedy = {key.replace(tag.strip("[]"), sfx): v for key, v in greedy.items()}
    router = {}
    if (cfg.n_experts, cfg.experts_per_token) != (16, 2):  # [moe] checked (4, 16) at k = 2
        router = _router_check(smi, tag, cfg.n_experts, cfg.experts_per_token,
                               f"router_{sfx}_")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    found = torch.cuda.memory_allocated()
    ti = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_tree, nbytes = _tree_bytes(params)
    print(f"{tag} seeded weights drawn on the card in {time.perf_counter() - ti:.2f} s: "
          f"{n_tree} parameters in the tree, {sum(nbytes.values())} B "
          f"({sum(nbytes.values()) / 1e9:.2f} GB) by top-level name "
          f"{ {k: v for k, v in nbytes.items()} }; memory_allocated="
          f"{torch.cuda.memory_allocated()} B, max_memory_allocated while drawing="
          f"{torch.cuda.max_memory_allocated()} B of "
          f"{torch.cuda.get_device_properties(0).total_memory} B")

    _decode_parity(model, params, tag)

    # one masked fused step over a random cache: no read-back, slot 3 frozen
    b = SERVE_BATCH
    cache = model.init_cache(b, CUT_CACHE)
    before = _random_cache(cache, SEED + 10)
    _masked_fused_step(model, params, cache)
    for key, v in cache.items():
        ax = 2 if key in ("h", "conv") else 1  # the batch axis
        if not torch.equal(v.select(ax, 3), before[key].select(ax, 3)):
            raise SystemExit(f"{tag} the masked fused step changed the masked row's {key!r}")
    del cache, before
    print(f"{tag} one masked fused decode step under set_sync_debug_mode('error'): no "
          f"read-back; the masked row's {', '.join(model.init_cache(1, 1))} bit-identical")

    # the serving engine, fused then host-sampled
    g, _, n_moe = model._groups() if cfg.family == "hybrid" else (cfg.n_layers, 0, 1)
    routers = g * n_moe  # router calls a step
    reqs = _requests(cfg, CUT_REQUESTS, CUT_PROMPT)
    _serve(model, params, reqs[:1], "fused", max_new=2, tag=tag)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    greedy_sample.launches = top_k.launches = 0
    fused = _serve(model, params, reqs, "fused", max_new=CUT_NEW, tag=tag)
    counted = {"greedy_sample": greedy_sample.launches, "top_k": top_k.launches}
    eager_steps = fused["decode_launches"] + 8 * fused["prefill_launches"]
    print(f"{tag} launches in the fused run: {counted}; {fused['decode_launches']} fused decode "
          f"launches, {fused['prefill_launches']} prefill launches of 8 steps, so "
          f"{eager_steps} eager steps of {routers} routers; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} B ({smi})")
    if counted["greedy_sample"] != fused["decode_launches"] or counted["greedy_sample"] == 0:
        raise SystemExit(f"{tag} the engine did not launch greedy_sample once per fused decode "
                         f"launch")
    if counted["top_k"] != routers * eager_steps:
        raise SystemExit(f"{tag} the engine launched top_k {counted['top_k']} times for "
                         f"{eager_steps} eager steps of {routers} routers")
    for uid, _ in reqs:
        if len(fused["streams"][uid]) != CUT_NEW:
            raise SystemExit(f"{tag} request {uid} finished with {len(fused['streams'][uid])} "
                             f"tokens")
    host = _serve(model, params, reqs, "host", max_new=CUT_NEW, tag=tag)
    if host["streams"] != fused["streams"]:
        raise SystemExit(f"{tag} fused and host sampling gave different token streams")
    print(f"{tag} fused and host token streams are bit-identical; first stream "
          f"{fused['streams'][0][:8]}")
    if cfg.family == "hybrid":
        # each copy takes a slot its original freed: its Mamba state must start from zero.
        # At drop-free capacity, else a stream depends on which rows share its experts' slots
        copies = [(uid + len(reqs), prompt) for uid, prompt in reqs]
        free = Model(dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)),
                     device="cuda")
        reused = _serve(free, params, reqs + copies, "fused", max_new=CUT_NEW, tag=tag)
        for uid, _ in reqs:
            if reused["streams"][uid] != reused["streams"][uid + len(reqs)]:
                raise SystemExit(f"{tag} request {uid + len(reqs)} in a reused slot did not "
                                 f"give the stream of request {uid} in a fresh one")
        print(f"{tag} at drop-free capacity, {len(copies)} copies of the requests, each in a "
              f"slot its original freed, give the originals' streams bit for bit")

    modes = phase_serve_modes(model, params, smi, steps=CUT_STEPS, cache_len=CUT_CACHE,
                              tag=tag, profiled=())
    weights = _weight_bytes(model, nbytes, b)
    state = sum(v.numel() * v.element_size() for key, v in model.init_cache(b, 1).items()
                if key in ("h", "conv"))
    kv = _kv_bytes(cfg, b, (SERVE_FUSE + CUT_STEPS) // 2)
    bound = _bound_ms(weights + kv + 2 * state, 2.0 * b * weights / 2, BF16_FLOPS)
    fused_ms = modes["fused"]["device_ms"]
    print(f"{tag} a fused step's bound at B={b}: {weights + kv + 2 * state} B (weights "
          f"{weights} B, every expert's included; the K/V rows up to the timed loop's mean "
          f"position {kv} B; the Mamba state read and written {2 * state} B) = "
          f"{bound[0]:.4f} ms ({bound[1]}); fused {fused_ms:.4f} ms a step = "
          f"{fused_ms / bound[0]:.2f}x it ({smi})")

    # one eager decode step at position CUT_STEPS, profiled
    cache = model.init_cache(b, CUT_CACHE)
    live = torch.ones((b,), dtype=torch.bool, device="cuda")
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((b,), CUT_STEPS, dtype=torch.int32, device="cuda")

    def step() -> None:
        model.decode_and_sample(params, cache, ones, torch.zeros_like(pos), ~live, pos, live)

    step()
    step_ms = _events_ms(step, 3)
    prof = _profiled(lambda: [step() for _ in range(3)], 3, top=6)
    print(f"{tag} one eager fused decode step B={b} at position {CUT_STEPS}: "
          f"{prof['ops']:.1f} device ops, busy {prof['busy_ms']:.4f} ms (torch.profiler, mean of "
          f"3) = {prof['busy_ms'] / bound[0]:.2f}x the bound, {step_ms:.4f} ms by CUDA events "
          f"around 3 eagerly issued steps; most device time a step: {_top(prof)} ({smi})")
    del model, params, cache
    _free_model(tag, found)
    print(f"{tag} phase took {time.perf_counter() - t0:.1f} s")
    return {"greedy_sample": counted["greedy_sample"], "top_k": counted["top_k"],
            **greedy, **router}


def _flat_shapes(shapes: list) -> list:
    """The tensor shapes in a profiler record's input shapes, a tensor
    list's shapes one by one."""
    out = []
    for x in shapes:
        if x and all(isinstance(e, int) for e in x):
            out.append(list(x))
        elif x and all(isinstance(e, (list, tuple)) for e in x):
            out.extend(_flat_shapes(x))
    return out


def _own_windows(model, params, xk: torch.Tensor, xv: torch.Tensor) -> None:
    """One decode step of 4 slots on one token at position 0: over four
    windows each slot's logits are its own (pairwise different); with the
    windows of slots 0 and 1 swapped, rows 0 and 1 swap bit for bit and
    rows 2 and 3 stay; over zero windows the 4 rows are one row, which each
    windowed row differs from."""
    b = xk.shape[1]
    tok = torch.full((b, 1), 7, dtype=torch.int32, device="cuda")

    def logits(wk: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
        cache = model.init_cache(b, 4)
        cache["xk"].copy_(wk)
        cache["xv"].copy_(wv)
        return model.decode_step(params, cache, tok, 0)[0][:, 0].float()

    swap = [1, 0, *range(2, b)]
    own, swapped = logits(xk, xv), logits(xk[:, swap], xv[:, swap])
    zero = logits(torch.zeros_like(xk), torch.zeros_like(xv))
    moved = [float((own[i] - zero[0]).abs().max()) for i in range(b)]
    print(f"[encdec] one decode step over 4 windows against zero windows: max |logit change| a "
          f"slot {[round(x, 6) for x in moved]}; swapping two slots' windows swaps their logits")
    if not (torch.equal(swapped, own[swap]) and all(torch.equal(z, zero[0]) for z in zero)
            and min(moved) > 0 and all(not torch.equal(own[i], own[j])
                                       for i in range(b) for j in range(i + 1, b))):
        raise SystemExit("a slot's logits do not follow its own window")


def phase_encdec(smi: str) -> dict:
    """The encoder-decoder family: whisper-medium whole (24 encoder and 24
    decoder layers at its published widths), seeded weights. greedy_sample
    at the head's shapes; the encoder over 4 seeded 30 s windows, timed
    beside its bound; the cross K/V of each window; forward against
    teacher-forced decode; a step whose logits follow each slot's window;
    one masked eager fused step under ``set_sync_debug_mode("error")``, the
    masked row's K/V and every cross K/V byte bit-identical after it, at
    their addresses; the serving engine fused and host-sampled on 4
    requests and a copy of each, every request carrying its window, each
    copy in a slot whose last window was another's, with greedy_sample
    counted from 0 just before the fused run and read just after; one eager
    fused decode step profiled by operator and input shape beside its
    bound, with no copy of the cross K/V. Frees the model at the end, and
    checks that it is gone."""
    from repro_torch.configs import get
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.models.layers import attention_chunk
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = get(ENCDEC_ARCH)
    greedy = _head_greedy_check(smi, "[encdec]", ENCDEC_V, SEED + 11)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    found = torch.cuda.memory_allocated()
    ti = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    n, nbytes = _tree_bytes(params)  # embed, enc_layers, enc_final_norm, dec_layers, final_norm
    print(f"[encdec] {ENCDEC_ARCH} whole: {cfg.n_encoder_layers} encoder and {cfg.n_layers} "
          f"decoder layers; widths as published: d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim_} (MHA), d_ff {cfg.d_ff} (GELU), vocab {cfg.vocab_size} (tied), "
          f"{cfg.encoder_seq_len} frames; {n} parameters in the tree, "
          f"{sum(nbytes.values()) / 1e9:.3f} GB (encoder {nbytes['enc_layers'] / 1e9:.3f}, "
          f"decoder {nbytes['dec_layers'] / 1e9:.3f}, embedding {nbytes['embed'] / 1e9:.3f}); "
          f"seeded on the card in {time.perf_counter() - ti:.2f} s, max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} B")
    if n != 758_002_688 or (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.d_ff,
                            cfg.vocab_size) != (24, 24, 1024, 4096, ENCDEC_V):
        raise SystemExit(f"{ENCDEC_ARCH} is not at its published widths and depth")

    # the encoder over 4 seeded 30 s windows, one a slot
    b, t, d = ENCDEC_SLOTS, cfg.encoder_seq_len, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    frames = torch.randn((b, t, d), generator=gen, device="cuda").to(torch.bfloat16)
    model.encode(params, frames)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    enc_ms = _events_ms(lambda: model.encode(params, frames), 3)
    enc_peak = torch.cuda.max_memory_allocated()
    enc = model.encode(params, frames)
    enc_prof = _profiled(lambda: model.encode(params, frames), 1, top=6)
    enc_ops = cfg.n_encoder_layers * (8 * b * t * d * d + 4 * b * t * d * cfg.d_ff
                                      + 4 * b * t * t * d)
    enc_bound = _bound_ms(nbytes["enc_layers"] + nbytes["enc_final_norm"]
                          + 2 * frames.numel() * frames.element_size(), enc_ops, BF16_FLOPS)
    xk, xv = model.cross_kv(params, enc)
    finite = bool(torch.isfinite(enc).all() and torch.isfinite(xk).all()
                  and torch.isfinite(xv).all())
    print(f"[encdec] encoder B={b} T={t}: {enc_ms:.4f} ms a pass (CUDA events, mean of 3) against "
          f"a bound of {enc_bound[0]:.4f} ms ({enc_bound[1]}: {enc_ops / 1e12:.4f} TFLOP at "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s) = {enc_ms / enc_bound[0]:.2f}x; max_memory_allocated "
          f"{enc_peak} B; cross K/V {tuple(xk.shape)} x 2 = "
          f"{2 * xk.numel() * xk.element_size()} B; finite={finite} ({smi})")
    print(f"[encdec] encoder profile (torch.profiler, one pass): {enc_prof['ops']:.0f} device "
          f"ops, busy {enc_prof['busy_ms']:.4f} ms; most device time: {_top(enc_prof)}")
    if not finite or enc.shape != (b, t, d):
        raise SystemExit("the encoder or its cross K/V gave non-finite values or another shape")
    del enc
    chunked = Model(dataclasses.replace(cfg, attn_chunk=CHUNK), device="cuda")
    _chunked_against_plain(
        f"[encdec] encoder B={b} T={t}, attn_chunk {CHUNK} (a chunk of "
        f"{attention_chunk(t, CHUNK)} frames) against 0:", lambda: model.encode(params, frames),
        lambda: chunked.encode(params, frames), PARITY_RTOL, PARITY_ATOL, smi)
    del chunked

    def write_cross(cache: dict) -> None:
        cache["xk"].copy_(xk[:, :2])
        cache["xv"].copy_(xv[:, :2])

    phase_numerics(model, params, "[encdec]", {"frontend_embeds": frames[:2]}, write_cross)
    _own_windows(model, params, xk, xv)

    # one masked fused step: slot 3 keeps its K/V rows, every cross K/V byte stays
    cache = model.init_cache(b, ENCDEC_MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen, device="cuda"))
    cache["xk"].copy_(xk)
    cache["xv"].copy_(xv)
    before = {k: v.clone() for k, v in cache.items()}
    addresses = {k: v.data_ptr() for k, v in cache.items()}
    _masked_fused_step(model, params, cache)
    for k, v in cache.items():
        if v.data_ptr() != addresses[k] or not torch.equal(v[:, 3], before[k][:, 3]):
            raise SystemExit(f"the masked fused step moved {k!r} or changed its masked row")
    if not (torch.equal(cache["xk"], before["xk"]) and torch.equal(cache["xv"], before["xv"])):
        raise SystemExit("the masked fused step changed the cross K/V")
    if torch.equal(cache["k"][:, 0], before["k"][:, 0]):
        raise SystemExit("the masked fused step left a live row's K unchanged")
    del before
    print(f"[encdec] one masked fused decode step under set_sync_debug_mode('error'): no "
          f"read-back; the masked row's k and v and all {2 * xk.numel() * xk.element_size()} B "
          f"of xk and xv bit-identical, every leaf at its address; the live rows' k changed")

    # the serving engine, fused then host-sampled: 4 requests, then a copy of
    # each (same prompt, same window) in a slot whose last window was another's
    prompts = _requests(cfg, ENCDEC_REQUESTS // 2, ENCDEC_PROMPT)
    m = len(prompts)
    owner = {uid: uid for uid in range(m)} | {m + k: (k + 1) % m for k in range(m)}
    reqs = prompts + [(uid, prompts[owner[uid]][1]) for uid in range(m, 2 * m)]
    windows = {uid: (xk[:, o], xv[:, o]) for uid, o in owner.items()}
    run = dict(tag="[encdec]", max_len=ENCDEC_MAX_LEN, windows=windows)
    _serve(model, params, reqs[:1], "fused", max_new=2, **run)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    greedy_sample.launches = 0
    fused = _serve(model, params, reqs, "fused", max_new=ENCDEC_NEW, **run)
    launches = greedy_sample.launches
    print(f"[encdec] greedy_sample launches in the fused run: {launches}; "
          f"{fused['decode_launches']} fused decode launches, {fused['prefill_launches']} "
          f"prefill launches of 8 steps; {ENCDEC_SLOTS} slots x {ENCDEC_MAX_LEN}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    if launches == 0 or launches != fused["decode_launches"]:
        raise SystemExit("the encdec engine did not launch greedy_sample once per fused decode "
                         "launch")
    for uid, _ in reqs:
        if len(fused["streams"][uid]) != ENCDEC_NEW:
            raise SystemExit(f"encdec request {uid} finished with "
                             f"{len(fused['streams'][uid])} tokens")
    rows: dict = {}
    host = _serve(model, params, reqs, "host", max_new=ENCDEC_NEW, rows=rows, **run)
    if host["streams"] != fused["streams"]:
        raise SystemExit("encdec fused and host sampling gave different token streams")
    slot = {uid: r[0][0] for uid, r in rows.items()}
    for uid in range(m, 2 * m):
        o = owner[uid]
        if slot[uid] == slot[o] or not torch.equal(torch.stack([x for _, x in rows[uid]]),
                                                   torch.stack([x for _, x in rows[o]])):
            raise SystemExit(f"encdec request {uid} in slot {slot[uid]} did not give the logits "
                             f"of request {o}, whose window it carries, in slot {slot[o]}")
    print(f"[encdec] fused and host token streams are bit-identical; distinct ids a stream "
          f"{[len(set(fused['streams'][uid])) for uid, _ in reqs]}; first stream "
          f"{fused['streams'][0][:8]}; each copy's {ENCDEC_NEW} decode logit rows equal its "
          f"original's bit for bit, the copy in a slot whose last window was another's "
          f"(request: slot {slot}; the host run copies each live row a step to compare them)")

    # one eager fused decode step, profiled by operator and input shape, beside
    # the bytes it must read
    live = torch.ones((b,), dtype=torch.bool, device="cuda")
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    no_override = torch.zeros((b,), dtype=torch.int32, device="cuda")
    at = ENCDEC_MAX_LEN // 2
    pos = torch.full((b,), at, dtype=torch.int32, device="cuda")

    def step() -> None:
        model.decode_and_sample(params, cache, ones, no_override, ~live, pos, live)

    step()
    step_ms = _events_ms(step, 5)
    prof = _profiled(lambda: [step() for _ in range(3)], 3, top=6, shapes=True)
    window = t * cfg.n_kv_heads * cfg.head_dim_  # elements of one slot's window a layer
    readers = {key for key, shapes, _, _ in prof["by_shape"] for shape in _flat_shapes(shapes)
               if t in shape and int(np.prod(shape)) >= window}
    ca = params["dec_layers"]["cross_attn"]
    cross_w = sum(ca[k].numel() * ca[k].element_size() for k in ("wk", "wv"))
    kv_bytes = 2 * cfg.n_layers * b * (at + 1) * cfg.n_kv_heads * cfg.head_dim_ * 2
    x_bytes = sum(cache[k].numel() * cache[k].element_size() for k in ("xk", "xv"))
    weights = nbytes["dec_layers"] - cross_w + nbytes["embed"] + nbytes["final_norm"]
    step_bytes = weights + x_bytes + kv_bytes
    bound = _bound_ms(step_bytes, 2.0 * b * weights / 2, BF16_FLOPS)  # 2 ops a weight a row
    print(f"[encdec] one eager fused decode step B={b} at position {at} of "
          f"{ENCDEC_MAX_LEN}: {prof['ops']:.1f} device ops, busy {prof['busy_ms']:.4f} ms "
          f"(torch.profiler, mean of 3), {step_ms:.4f} ms by CUDA events around 5 eagerly "
          f"issued steps; bound {step_bytes} B (decoder without the cross wk/wv "
          f"{nbytes['dec_layers'] - cross_w} B, tied head {nbytes['embed']} B, xk/xv {x_bytes} "
          f"B, the k/v rows up to position {at} {kv_bytes} B) = {bound[0]:.4f} ms "
          f"({bound[1]}); busy = {prof['busy_ms'] / bound[0]:.2f}x it ({smi})")
    print(f"[encdec] decode step profile, most device time a step: {_top(prof)}")
    print("[encdec] decode step profile by operator and input shapes, most device time a step: "
          + "; ".join(f"{key} {shapes} {ms:.4f} ms x{calls:g}"
                      for key, shapes, ms, calls in prof["by_shape"][:8]))
    print(f"[encdec] operators that read a window-sized tensor in the step: {sorted(readers)}")
    if readers != {"aten::bmm"}:
        raise SystemExit(f"the decode step copies xk/xv, or reads them through {readers}, not "
                         f"aten::bmm alone")
    del model, params, cache, xk, xv, frames, ca, windows, run, rows
    _free_model("[encdec]", found)
    print(f"[encdec] phase took {time.perf_counter() - t0:.1f} s")
    return {"greedy_sample": launches, **greedy}


def _draw(tag: str, cfg, layers: tuple) -> tuple:
    """A model of ``cfg`` on the card with seeded weights, drawn after the
    allocator is emptied and its peak reset; prints the tree's count and
    bytes, the seconds taken and the peak, and fails unless the published
    ``layers`` (n_layers, d_model, d_ff, vocab) are what was built.
    Returns (model, params, parameters, bytes by top-level name, memory
    found before the draw)."""
    from repro_torch.models.model import Model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    found = torch.cuda.memory_allocated()
    ti = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - ti
    n, nbytes = _tree_bytes(params)
    print(f"{tag} {cfg.name} whole: {cfg.n_layers} of {cfg.n_layers} layers; widths as "
          f"published: d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads of {cfg.head_dim_}, d_ff {cfg.d_ff} ({cfg.mlp_kind}), vocab {cfg.vocab_size} "
          f"({'tied' if cfg.tie_embeddings else 'untied'}){', QKV bias' if cfg.qkv_bias else ''}"
          f"; {n} parameters in the tree, {sum(nbytes.values())} B "
          f"({sum(nbytes.values()) / 1e9:.2f} GB) in bf16; seeded on the card in "
          f"{seconds:.2f} s, max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    if (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) != layers:
        raise SystemExit(f"{cfg.name} is not at its published widths and depth")
    return model, params, n, nbytes, found


def _weight_bytes(model, nbytes: dict, b: int) -> int:
    """Bytes of weights a decode step of ``b`` rows must read: the trunk
    (``layers``, a hybrid's ``groups``; every MoE expert, whose buffer the
    reference's formulation computes whether routed to or not), the final
    norm and the head once, and ``b`` rows of the embedding (all of it
    where the head is the tied embedding)."""
    cfg = model.cfg
    head = nbytes["embed"] if cfg.tie_embeddings else nbytes["head"] + b * cfg.d_model * 2
    return nbytes.get("layers", 0) + nbytes.get("groups", 0) + nbytes["final_norm"] + head


def _kv_bytes(cfg, b: int, rows: int) -> int:
    """Bytes of the K/V rows ``b`` slots read at ``rows`` positions, over
    the attention layers (a hybrid's one a group)."""
    return 2 * cfg.n_attn_layers() * b * rows * cfg.n_kv_heads * cfg.head_dim_ * 2


def phase_vlm(smi: str) -> dict:
    """The vision-language family: phi-3-vision-4.2b whole (32 layers at its
    published widths), seeded weights. greedy_sample at the head's shapes;
    ``forward`` over a seeded 576-row image prefix and 8 tokens, against
    another prefix and against the dense trunk of the same weights over the
    prefix and the tokens; the text backbone's forward against
    teacher-forced decode; the serving engine fused and host-sampled on the
    same requests (no image, as the reference serves a vlm), with
    greedy_sample counted from 0 just before the fused run and read just
    after; one eager fused decode step profiled beside its bound. Frees the
    model at the end, and checks that it is gone."""
    from repro_torch.configs import get
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.models.model import Model, _norm

    t0 = time.perf_counter()
    cfg = get(VLM_ARCH)
    greedy = _head_greedy_check(smi, "[vlm]", VLM_V, SEED + 15)
    model, params, n, nbytes, found = _draw("[vlm]", cfg, (32, 3072, 8192, VLM_V))

    # forward over the image prefix: shape, finiteness, the prefix's effect,
    # and the dense trunk over the same embedding rows, bit for bit
    b, s, p, d = 2, 8, cfg.frontend_tokens, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    prefix, other = (torch.randn((b, p, d), generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    logits, _ = model.forward(params, {"tokens": tokens, "frontend_embeds": prefix})
    moved, _ = model.forward(params, {"tokens": tokens, "frontend_embeds": other})
    dense = Model(dataclasses.replace(cfg, family="dense"), device="cuda")
    x, _ = dense._uniform_trunk(params["layers"],
                                torch.cat([prefix, params["embed"][tokens]], dim=1))
    want = _norm(params["final_norm"], x, cfg.norm_eps)[:, p:] @ params["head"]
    change = float((moved.float() - logits.float()).abs().max())
    finite = bool(torch.isfinite(logits).all())
    print(f"[vlm] forward B={b} over a ({b}, {p}, {d}) image prefix and {s} tokens: logits "
          f"{tuple(logits.shape)} {logits.dtype}, finite={finite}; another prefix moves the text "
          f"logits by up to {change:.4f} (mean |change| "
          f"{float((moved.float() - logits.float()).abs().mean()):.4f}); the dense trunk over "
          f"the prefix rows and the tokens, the prefix dropped before the head, equal bit for "
          f"bit: {torch.equal(want, logits)}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    if tuple(logits.shape) != (b, s, VLM_V) or not finite or change == 0 \
            or not torch.equal(want, logits):
        raise SystemExit("the vlm forward gave another shape, non-finite logits, logits the "
                         "prefix does not move, or not the dense trunk's over the prefix")
    del logits, moved, x, want, dense, prefix, other

    phase_numerics(model, params, "[vlm] text backbone:",
                   {"frontend_embeds": torch.zeros((2, 0, d), device="cuda")})

    # the serving engine, fused then host-sampled, on the text alone
    reqs = _requests(cfg, VLM_REQUESTS, VLM_PROMPT)
    _serve(model, params, reqs[:1], "fused", max_new=2, tag="[vlm]")  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    greedy_sample.launches = 0
    fused = _serve(model, params, reqs, "fused", max_new=VLM_NEW, tag="[vlm]")
    launches = greedy_sample.launches
    print(f"[vlm] greedy_sample launches in the fused run: {launches}; "
          f"{fused['decode_launches']} fused decode launches, {fused['prefill_launches']} "
          f"prefill launches of 8 steps; 4 slots x 512; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} B ({smi})")
    if launches == 0 or launches != fused["decode_launches"]:
        raise SystemExit("the vlm engine did not launch greedy_sample once per fused decode "
                         "launch")
    for uid, _ in reqs:
        if len(fused["streams"][uid]) != VLM_NEW:
            raise SystemExit(f"vlm request {uid} finished with {len(fused['streams'][uid])} "
                             f"tokens")
    host = _serve(model, params, reqs, "host", max_new=VLM_NEW, tag="[vlm]")
    if host["streams"] != fused["streams"]:
        raise SystemExit("vlm fused and host sampling gave different token streams")
    print(f"[vlm] fused and host token streams are bit-identical; first stream "
          f"{fused['streams'][0][:8]}")

    # one eager fused decode step, profiled, beside the bytes it must read
    b = SERVE_BATCH
    cache = model.init_cache(b, 512)
    live = torch.ones((b,), dtype=torch.bool, device="cuda")
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    no_override = torch.zeros((b,), dtype=torch.int32, device="cuda")
    pos = torch.full((b,), VLM_AT, dtype=torch.int32, device="cuda")

    def step() -> None:
        model.decode_and_sample(params, cache, ones, no_override, ~live, pos, live)

    step()
    step_ms = _events_ms(step, 5)
    prof = _profiled(lambda: [step() for _ in range(3)], 3, top=6)
    weights, kv = _weight_bytes(model, nbytes, b), _kv_bytes(cfg, b, VLM_AT + 1)
    bound = _bound_ms(weights + kv, 2.0 * b * weights / 2, BF16_FLOPS)  # 2 ops a weight a row
    print(f"[vlm] one eager fused decode step B={b} at position {VLM_AT} of 512: "
          f"{prof['ops']:.1f} device ops, busy {prof['busy_ms']:.4f} ms (torch.profiler, mean "
          f"of 3), {step_ms:.4f} ms by CUDA events around 5 eagerly issued steps; bound "
          f"{weights + kv} B (weights {weights} B, the K/V rows up to position {VLM_AT} {kv} B, "
          f"{kv // (b * (VLM_AT + 1))} B a token) = {bound[0]:.4f} ms ({bound[1]}); busy = "
          f"{prof['busy_ms'] / bound[0]:.2f}x it ({smi})")
    print(f"[vlm] decode step profile, most device time a step: {_top(prof)}")
    del model, params, cache
    _free_model("[vlm]", found)
    print(f"[vlm] phase took {time.perf_counter() - t0:.1f} s")
    return {"greedy_sample": launches, **greedy}


def _serve_dense(model, params, smi: str, tag: str, bound: tuple) -> int:
    """``launch.serve.serve`` at the command's defaults (batch 4, 64 steps,
    cache 256) fused at fuse 8, its ids against the same schedule run
    eagerly, and sequential at 16 steps, each with greedy_sample counted
    from 0 just before and read just after; fused set beside ``bound``.
    Returns the fused run's greedy_sample launches."""
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.launch.serve import serve

    runs = {}
    for mode, steps in (("fused", SERVE_STEPS), ("sequential", DENSE_SEQUENTIAL_STEPS)):
        greedy_sample.launches = 0
        run = serve(model, params, batch=SERVE_BATCH, steps=steps, cache_len=SERVE_CACHE,
                    mode=mode, fuse=SERVE_FUSE)
        counted = greedy_sample.launches
        print(f"{tag} serve mode={mode} batch={SERVE_BATCH} steps={run.produced}: "
              f"{run.ms_per_step:.4f} ms/step, {run.tokens_per_s:.1f} tok/s by wall clock; "
              f"device {run.device_ms / run.produced:.4f} ms/step (CUDA events around the timed "
              f"loop); greedy_sample launches in the timed loop {run.sample_launches} (counter "
              f"{counted}, warm-up and captures included)"
              + (f"; {len(run.graphs)} graphs captured in {run.capture_s:.3f} s"
                 if mode == "fused" else "") + f" ({smi})")
        if counted == 0 or run.sample_launches != run.produced:
            raise SystemExit(f"{tag} serve {mode} launched greedy_sample {run.sample_launches} "
                             f"times for {run.produced} steps")
        if tuple(run.ids.shape) != (steps - (SERVE_FUSE if mode == "fused" else 1),
                                    SERVE_BATCH) \
                or not bool(((run.ids >= 0) & (run.ids < model.cfg.vocab_size)).all()):
            raise SystemExit(f"{tag} serve {mode} gave ids of shape {tuple(run.ids.shape)} "
                             f"outside the vocabulary")
        runs[mode] = (run, counted)
    fused = runs["fused"][0]
    if not fused.graphs or not all(g.replays for g in fused.graphs):
        raise SystemExit(f"{tag} fused serving did not replay its CUDA graphs")
    if not torch.equal(fused.ids, _eager_fused_ids(model, params, SERVE_FUSE)):
        raise SystemExit(f"{tag} fused serving's graph replays differ from the same schedule "
                         f"run eagerly")
    fused_ms = fused.device_ms / fused.produced
    print(f"{tag} fused fuse={SERVE_FUSE} ids equal the eager schedule's "
          f"({tuple(fused.ids.shape)}); first steps {fused.ids[:2].tolist()}; fused "
          f"{fused_ms:.4f} ms a step against its {bound[0]:.4f} ms bound ({bound[1]}) = "
          f"{fused_ms / bound[0]:.2f}x; max_memory_allocated while serving="
          f"{torch.cuda.max_memory_allocated()} B ({smi})")
    steps = 3 * SERVE_FUSE
    prof = _profiled(lambda: serve(model, params, batch=SERVE_BATCH, steps=steps,
                                   cache_len=SERVE_CACHE, mode="fused", fuse=SERVE_FUSE),
                     steps, top=6)
    print(f"{tag} profile, mode=fused, {steps} steps (warm-up included): {prof['ops']:.1f} device "
          f"ops a step, busy {prof['busy_ms']:.4f} ms a step, {prof['busy_ms'] / bound[0]:.2f}x "
          f"the bound; idle {1 - prof['busy_ms'] / fused_ms:.3f} of the timed run's step; most "
          f"device time a step: {_top(prof)}")
    return runs["fused"][1]


def _int8_long_cache(model, params, nbytes: dict, smi: str) -> int:
    """qwen2.5-32b over an int8 cache of ``QWEN32_INT8_ROWS`` rows a slot at
    B = 4, on the weights already on the card: the free memory and the two
    caches' sizes printed; ``launch.serve.serve`` fused at fuse 8 (the
    command's defaults but the cache), its ids equal to the same schedule
    run eagerly, greedy_sample once per produced step, counted from 0 just
    before; its peak memory and fused step beside the function's bound
    (the weights and the int8 cache read once) and the reference
    formulation's (besides, the whole cache dequantized to bf16, written
    and read, a step); one eager decode step profiled. Returns the fused
    run's greedy_sample launches."""
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    cfg, rows, tag = model.cfg, QWEN32_INT8_ROWS, "[qwen2.5-32b]"
    qmodel = Model(dataclasses.replace(cfg, cache_quant="int8"), device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    heads = SERVE_BATCH * rows * 2 * cfg.n_layers * cfg.n_kv_heads  # K and V heads cached
    bf16, int8 = heads * cfg.head_dim_ * 2, heads * (cfg.head_dim_ + 2)
    weights = sum(nbytes.values())
    print(f"{tag} int8 KV at B={SERVE_BATCH} x {rows} rows: mem_get_info free {free} B of "
          f"{total} B with the weights ({weights} B) on the card; a bf16 cache {bf16} B "
          f"({bf16 / 1e9:.2f} GB, {'fits' if bf16 < free else 'does not fit'}), the int8 cache "
          f"{int8} B ({int8 / 1e9:.2f} GB, {'fits' if int8 < free else 'does not fit'}); "
          f"weights + int8 cache {(weights + int8) / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    greedy_sample.launches = 0
    run = serve(qmodel, params, batch=SERVE_BATCH, steps=SERVE_STEPS, cache_len=rows,
                mode="fused", fuse=SERVE_FUSE)
    counted = greedy_sample.launches
    peak = torch.cuda.max_memory_allocated()
    if counted == 0 or run.sample_launches != run.produced or not run.graphs \
            or not all(g.replays for g in run.graphs):
        raise SystemExit(f"{tag} int8 fused serving launched greedy_sample "
                         f"{run.sample_launches} times for {run.produced} steps, or replayed "
                         f"no graph")
    gc.collect()
    torch.cuda.empty_cache()
    if not torch.equal(run.ids, _eager_fused_ids(qmodel, params, SERVE_FUSE, cache_len=rows)):
        raise SystemExit(f"{tag} int8 fused serving's graph replays differ from the same "
                         f"schedule run eagerly")
    step_ms = run.device_ms / run.produced
    fn_bytes = _weight_bytes(model, nbytes, SERVE_BATCH) + int8
    ops = 2.0 * SERVE_BATCH * weights / 2
    bound, ref = _bound_ms(fn_bytes, ops, BF16_FLOPS), _bound_ms(fn_bytes + 2 * bf16, ops,
                                                                 BF16_FLOPS)
    print(f"{tag} int8 serve mode=fused batch={SERVE_BATCH} cache {rows} steps={run.produced}: "
          f"ids equal the eager schedule's; {step_ms:.4f} device ms a fused step (CUDA events "
          f"around the timed loop), {run.ms_per_step:.4f} ms by wall clock; greedy_sample "
          f"launches {run.sample_launches} in the timed loop (counter {counted}); "
          f"max_memory_allocated {peak} B ({peak / 1e9:.2f} GB) of {total} B; against the "
          f"function's bound {bound[0]:.4f} ms ({fn_bytes} B: weights and the int8 cache once; "
          f"{bound[1]}) = {step_ms / bound[0]:.2f}x, the reference formulation's {ref[0]:.4f} "
          f"ms (besides, the whole cache in bf16 written and read, {2 * bf16} B) = "
          f"{step_ms / ref[0]:.2f}x ({smi})")
    # one eager decode step profiled: the fused step's kernels, a short trace
    cache = qmodel.init_cache(SERVE_BATCH, rows)
    ones = torch.ones((SERVE_BATCH, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SERVE_BATCH,), SERVE_STEPS, dtype=torch.int32, device="cuda")
    qmodel.decode_step(params, cache, ones, pos)
    prof = _profiled(lambda: qmodel.decode_step(params, cache, ones, pos), 1, top=6)
    print(f"{tag} int8 profile, one eager decode step at position {SERVE_STEPS}: "
          f"{prof['ops']:.1f} device ops, busy {prof['busy_ms']:.4f} ms; most device time: "
          f"{_top(prof)}")
    return counted


def phase_dense(smi: str) -> dict:
    """The reference's other single-card dense configurations, whole and
    seeded, one after another: phi4-mini-3.8b (tied head, vocab 200,064),
    minitron-4b (GELU MLP, vocab 256,000) and qwen2.5-32b (QKV bias,
    65.5 GB, vocab 152,064). For each, greedy_sample at the head's shapes,
    the draw's seconds and peak, the serve loop fused and sequential
    beside the bound of reading the weights once, and the model freed
    before the next. Returns each model's fused greedy_sample launches and
    its head's times under its tag."""
    from repro_torch.configs import get

    out, total, worst = {}, 0, 0
    for arch, tag, published in DENSE_ARCHS:
        t0 = time.perf_counter()
        cfg = get(arch)
        greedy = _head_greedy_check(smi, tag, published[3], SEED + 17 + len(out))
        worst = max(worst, greedy.pop("max_abs_err"))
        out.update(greedy)
        if arch == "qwen2.5-32b":  # one f32 draw of the head beside every bf16 weight
            peak = 2 * cfg.param_count() + 4 * cfg.d_model * cfg.vocab_size
            print(f"{tag} predicted peak while drawing: {peak} B ({peak / 1e9:.1f} GB: the bf16 "
                  f"weights and the head's f32 draw); the card has "
                  f"{torch.cuda.get_device_properties(0).total_memory} B")
        model, params, n, nbytes, found = _draw(tag, cfg, published)
        torch.cuda.reset_peak_memory_stats()
        weights = _weight_bytes(model, nbytes, SERVE_BATCH)
        kv = _kv_bytes(cfg, SERVE_BATCH, (SERVE_FUSE + SERVE_STEPS) // 2)
        bound = _bound_ms(weights + kv, 2.0 * SERVE_BATCH * weights / 2, BF16_FLOPS)
        print(f"{tag} a fused step's bound at B={SERVE_BATCH}: {weights + kv} B (weights "
              f"{weights} B, the K/V rows up to the timed loop's mean position {kv} B) = "
              f"{bound[0]:.4f} ms ({bound[1]})")
        launches = _serve_dense(model, params, smi, tag, bound)
        out[f"launches_{tag.strip('[]')}"] = launches
        total += launches
        if arch == "qwen2.5-32b":
            out["launches_int8_qwen2.5-32b"] = _int8_long_cache(model, params, nbytes, smi)
        del model, params
        _free_model(tag, found)
        print(f"{tag} phase took {time.perf_counter() - t0:.1f} s")
    return {"greedy_sample": total, "max_abs_err": worst, **out}


def _grads(model, params: dict, batch: dict) -> tuple:
    """The loss and every leaf's gradient, in ``tree.leaves`` order, by the
    autograd of ``launch.steps.build_train_step``."""
    from repro_torch.tree import leaves, unflatten

    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = model.loss(unflatten(params, flat), batch)
    return loss.detach(), torch.autograd.grad(loss, flat)


def _card_against_cpu(model, params: dict) -> None:
    """The loss and every gradient leaf on the card against the port on
    the CPU over the same weights and one seeded batch (B = 1, S = 64):
    the CPU side is the one the tests hold to JAX."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.dispatch.executor import flatten_with_path
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    b, s = TRAIN_CHECK
    batch = SyntheticLMDataset(model.cfg.vocab_size, s, b, seed=SEED + 21).batch(0)
    card = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    cpu = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _grads(model, params, card)
    ti = time.perf_counter()
    cpu_loss, cpu_grads = _grads(Model(model.cfg, device="cpu"),
                                 tree_map(lambda p: p.cpu(), params), cpu)
    seconds = time.perf_counter() - ti
    rel = {path: float(torch.linalg.vector_norm(g.float().cpu() - c.float())
                       / torch.linalg.vector_norm(c.float()))
           for (path, _), g, c in zip(flatten_with_path(params), grads, cpu_grads)}
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    print(f"[train] card against the CPU port, B={b} S={s} (CPU side {seconds:.1f} s): loss "
          f"{float(loss):.6f} vs {float(cpu_loss):.6f} (relative {loss_rel:.2e}, allowed "
          f"{TRAIN_LOSS_RTOL}); gradient relative L2 per leaf (allowed {TRAIN_GRAD_REL_L2}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    if loss_rel > TRAIN_LOSS_RTOL or max(rel.values()) > TRAIN_GRAD_REL_L2 \
            or not all(torch.isfinite(g).all() for g in grads):
        raise SystemExit("the card's loss or gradients disagree with the CPU port's")


def _remat_table(cfg, params: dict, smi: str) -> None:
    """One train step (``launch.steps.build_train_step``, AdamW) at B = 8,
    S = 1,024 for each ``remat`` and ``attn_chunk`` of 0 and 512, after a
    warm-up step of its own on an emptied allocator cache (so no timed step
    pays for ``cudaMalloc``): CUDA-event ms and peak memory over what was
    allocated before it. Within each ``attn_chunk`` the losses must be equal, and the
    gradients the update receives bit for bit ``"none"``'s where two
    ``"none"`` steps are bit for bit with each other, else within twice
    their distance."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    class Keep(AdamW):  # keeps the gradients the update receives
        def update(self, params, grads, state):
            self.grads = [g.detach() for g in leaves(grads)]
            return super().update(params, grads, state)

    batch = {k: torch.from_numpy(v).to("cuda") for k, v in SyntheticLMDataset(
        cfg.vocab_size, REMAT_SEQ, REMAT_BATCH, seed=SEED + 23).batch(0).items()}
    opt = Keep()
    state = opt.init(params)
    for chunk in (0, CHUNK):
        steps = {}
        for label in (*REMATS, "none again"):
            model = Model(dataclasses.replace(cfg, remat=label.split()[0], attn_chunk=chunk),
                          device="cuda")
            step = build_train_step(model, opt)
            torch.cuda.empty_cache()  # the warm-up then fills the allocator's cache
            step(params, state, batch)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(params, state, batch)[2]["loss"]
            end.record()
            end.synchronize()
            steps[label] = (float(loss), opt.grads, start.elapsed_time(end),
                            torch.cuda.max_memory_allocated() - base)

        def distance(label: str) -> float:
            return max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(steps[label][1], steps["none"][1]))

        repeat = distance("none again")
        print(f"[train] remat table, B={REMAT_BATCH} S={REMAT_SEQ} attn_chunk={chunk}, one train "
              f"step by CUDA events after a warm-up: "
              + "; ".join(f"{r} {steps[r][2]:.3f} ms, peak {steps[r][3]} B "
                          f"({steps[r][3] / 1e9:.3f} GB), loss {steps[r][0]:.6f}, gradients "
                          f"{distance(r)} max_abs_diff from none" for r in REMATS)
              + f"; two none steps {repeat} apart ({smi})")
        for remat in REMATS[1:]:
            if steps[remat][0] != steps["none"][0] or distance(remat) > 2 * repeat:
                raise SystemExit(f"remat={remat} at attn_chunk={chunk} changed the loss or the "
                                 f"gradients of remat=none")
        del steps


def _replay(model, params: dict, ckpt_dir: str) -> tuple:
    """20 train steps straight, twice (bit for bit), then under
    ``TrainSupervisor(ckpt_every=8)`` with a fault before the first
    checkpoint and one after it: the final parameters and optimizer state
    must equal the straight run's bit for bit. Returns the straight run's
    state."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW, CosineSchedule
    from repro_torch.runtime import TrainSupervisor
    from repro_torch.tree import leaves

    steps, every, faults = TRAIN_REPLAY
    opt = AdamW(schedule=CosineSchedule(warmup_steps=20, total_steps=TRAIN_STEPS))
    train_step = build_train_step(model, opt)
    ds = SyntheticLMDataset(model.cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)

    def step_fn(state, batch):
        return train_step(*state, batch)[:2]

    def batch_fn(i):
        return {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(i).items()}

    def straight():
        state = (params, opt.init(params))
        for i in range(steps):
            state = step_fn(state, batch_fn(i))
        return state

    def same(a, b) -> bool:
        return all(torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
                   for x, y in zip(leaves(a), leaves(b)))

    first, second = straight(), straight()
    twice = same(first, second)
    print(f"[train] {steps} steps straight, twice: bit for bit {twice} "
          f"({len(leaves(first))} leaves)")
    if not twice:
        raise SystemExit("two straight training runs on the card differ")
    del second
    armed = set(faults)

    def fault_hook(step: int) -> None:
        if step in armed:
            armed.discard(step)
            raise RuntimeError(f"simulated node failure at step {step}")

    store = CheckpointStore(ckpt_dir)
    sup = TrainSupervisor(step_fn, store, ckpt_every=every)
    ti = time.perf_counter()
    recovered = sup.run((params, opt.init(params)), batch_fn, steps, fault_hook=fault_hook)
    exact = same(recovered, first)
    print(f"[train] under TrainSupervisor(ckpt_every={every}) with faults at steps {faults} "
          f"(before and after the first checkpoint): restarts={sup.restarts}, checkpoints "
          f"{store.steps()}, {time.perf_counter() - ti:.1f} s; final parameters and optimizer "
          f"state equal the straight run's bit for bit: {exact}")
    if sup.restarts != len(faults) or not exact:
        raise SystemExit("the supervisor's replay did not reproduce the straight run")
    return first


def phase_train(smi: str) -> dict:
    """Training: paper-lm-100m whole and seeded on the card; its loss and
    gradients against the port on the CPU; ``repro_torch.launch.train`` at
    the reference driver's defaults (100 steps, batch 8, seq 256, lr 3e-4,
    warm-up 20), timed, with one step profiled, its loss falling; a 20-step
    replay under the supervisor with two faults, bit for bit the straight
    run's; the last checkpoint restored into a fresh tree and served
    through the engine, fused (greedy_sample counted from 0 just before)
    and host-sampled, with bit-identical streams. Frees the model at the
    end."""
    import shutil

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW, CosineSchedule
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(TRAIN_ARCH), remat="none")  # as the driver sets it
    model, params, n, nbytes, found = _draw("[train]", cfg, (12, 768, 2048, TRAIN_V))
    _card_against_cpu(model, params)
    _remat_table(cfg, params, smi)

    # the driver at the reference's defaults
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = train_driver.main(["--device", "cuda"])
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall_ms = run.wall_s / TRAIN_STEPS * 1e3
    event_ms = float(np.median(run.step_ms))
    state_bytes = 2 * n + 3 * 4 * n  # bf16 parameters, f32 master, m and v
    bound = _bound_ms(2 * state_bytes, 6.0 * n * tokens, BF16_FLOPS)
    print(f"[train] driver at its defaults ({TRAIN_STEPS} steps, batch {TRAIN_BATCH}, seq "
          f"{TRAIN_SEQ}): loss {run.losses[0]:.4f} -> {run.losses[-1]:.4f}; {wall_ms:.3f} ms a "
          f"step by wall clock ({tokens * TRAIN_STEPS / run.wall_s:.0f} tokens/s), "
          f"{event_ms:.3f} ms median by CUDA events (min {min(run.step_ms):.3f}); bound "
          f"{bound[0]:.4f} ms ({bound[1]}: 6 x {n} parameters x {tokens} tokens at "
          f"{BF16_FLOPS:.3g} FLOP/s; the state read and written once {2 * state_bytes} B); "
          f"wall = {wall_ms / bound[0]:.1f}x it; max_memory_allocated={peak} B ({smi})")
    if not run.losses[-1] < run.losses[0]:
        raise SystemExit("the driver's loss did not fall")

    # one step of the driver's, profiled and timed by events over eager steps
    opt = AdamW(schedule=CosineSchedule(warmup_steps=20, total_steps=TRAIN_STEPS))
    step = build_train_step(model, opt)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).batch(0).items()}
    state = (run.params, run.opt_state)
    step(*state, batch)
    steady_ms = _events_ms(lambda: step(*state, batch), 10)
    prof = _profiled(lambda: [step(*state, batch) for _ in range(3)], 3, top=6)
    print(f"[train] one train step at batch {TRAIN_BATCH}, seq {TRAIN_SEQ}: {prof['ops']:.1f} "
          f"device ops, busy {prof['busy_ms']:.4f} ms (torch.profiler, mean of 3; "
          f"{prof['busy_ms'] / bound[0]:.2f}x the bound), {steady_ms:.4f} ms by CUDA events "
          f"around 10 eagerly issued steps (idle {1 - prof['busy_ms'] / steady_ms:.3f}) ({smi})")
    print(f"[train] train step profile, most device time a step: {_top(prof)}")
    del run, state, step, batch

    # replay under the supervisor, then serve the last checkpoint
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        trained = _replay(model, params, ckpt_dir)
        store = CheckpointStore(ckpt_dir)
        last = store.latest_step()
        fresh = model.init(SEED + 22)
        restored = store.restore(last, (fresh, AdamW().init(fresh)))
        exact = all(torch.equal(a, b) for a, b in zip(leaves(restored), leaves(trained)))
        print(f"[train] checkpoint step {last} restored into a fresh tree: equal to the trained "
              f"state bit for bit: {exact}; leaves on {restored[0]['embed'].device}")
        if not exact or last != TRAIN_REPLAY[0]:
            raise SystemExit("the restored checkpoint is not the trained state")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    served = restored[0]
    del trained, restored, fresh, params
    greedy = _head_greedy_check(smi, "[train]", TRAIN_V, SEED + 20)
    reqs = _requests(cfg, TRAIN_REQUESTS, TRAIN_PROMPT)
    _serve(model, served, reqs[:1], "fused", max_new=2, tag="[train]")  # warm-up, not counted
    greedy_sample.launches = 0
    fused = _serve(model, served, reqs, "fused", max_new=TRAIN_NEW, tag="[train]")
    launches = greedy_sample.launches
    print(f"[train] greedy_sample launches serving the trained weights, fused: {launches}; "
          f"{fused['decode_launches']} fused decode launches")
    if launches == 0 or launches != fused["decode_launches"]:
        raise SystemExit("serving the trained model did not launch greedy_sample once per fused "
                         "decode launch")
    for uid, _ in reqs:
        if len(fused["streams"][uid]) != TRAIN_NEW:
            raise SystemExit(f"request {uid} finished with {len(fused['streams'][uid])} tokens")
    host = _serve(model, served, reqs, "host", max_new=TRAIN_NEW, tag="[train]")
    if host["streams"] != fused["streams"]:
        raise SystemExit("the trained model's fused and host token streams differ")
    print(f"[train] fused and host token streams of the trained weights are bit-identical; "
          f"first stream {fused['streams'][0][:8]}")
    del model, served
    _free_model("[train]", found)
    print(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    return {"greedy_sample": launches, **greedy}


def _sharded_against_plain(tag: str, plain, sharded) -> None:
    """Fails unless every leaf of ``sharded`` (DTensors) equals the matching
    leaf of ``plain`` bit for bit."""
    from repro_torch.tree import leaves

    got, want = leaves(sharded), leaves(plain)
    if len(got) != len(want) or not all(
            torch.equal(a, b.full_tensor() if hasattr(b, "full_tensor") else b)
            for a, b in zip(want, got)):
        raise SystemExit(f"{tag} the sharded result differs from the unsharded one")


def phase_dryrun(smi: str) -> None:
    """The one distribution plan under this machine's torch: each of
    ``DRYRUN_CELLS`` traced by ``python -m repro_torch.launch.dryrun`` in a
    process of its own, all at once, on the CPU (``fake`` process group,
    meta tensors; the card unused); each must trace with its pinned
    collective counts and FLOPs ratio (within 1e-6)."""
    import tempfile

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src"), "CUDA_VISIBLE_DEVICES": ""}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        runs = {}
        for arch, shape, pods in DRYRUN_CELLS:
            out = os.path.join(tmp, f"{arch}_{shape}_{pods}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--out", out] + (["--multi-pod"] if pods else [])
            runs[(arch, shape, pods)] = (subprocess.Popen(cmd, env=env, cwd=root,
                                                          stdout=subprocess.PIPE,
                                                          stderr=subprocess.PIPE, text=True), out)
        try:
            for cell, (proc, out) in runs.items():
                _, err = proc.communicate(timeout=300)
                if proc.returncode or not os.path.exists(out):
                    raise SystemExit(f"[dryrun] {cell} did not trace (exit {proc.returncode}): "
                                     f"{err.strip().splitlines()[-1:] if err else ''}")
                with open(out) as f:
                    rec = json.load(f)
                counts = {k: v["count"] for k, v in rec["collectives"].items()}
                ratio = rec["hlo_flops"] / rec["model_flops"]
                want, want_ratio = DRYRUN_CELLS[cell]
                print(f"[dryrun] {cell[0]} {cell[1]} {rec['mesh']} under torch {rec['torch']}: "
                      f"status {rec['status']}, traced in {rec['trace_s']:.1f} s, collectives "
                      f"{counts} (pinned {want}), FLOPs {ratio:.4f}x the model's (pinned "
                      f"{want_ratio:.4f}), collective term {rec['collective_s']:.4g} s, "
                      f"{rec['per_device_bytes']} bytes a device")
                if rec["status"] != "ok" or counts != want or abs(ratio - want_ratio) > 1e-6 * ratio:
                    raise SystemExit(f"[dryrun] {cell}: this torch plans the cell otherwise "
                                     f"than the pinned plan")
        finally:
            for proc, _ in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    print(f"[dryrun] {len(DRYRUN_CELLS)} cells, one plan, in {time.perf_counter() - t0:.1f} s "
          f"({smi})")


def phase_distributed(smi: str) -> dict:
    """Distribution on one card: a one-rank NCCL group (a ``FileStore``,
    ``world_size=1``) and ``launch.mesh.make_host_mesh()``, a 1x1 ("data",
    "model") mesh. Each model's arguments are placed by
    ``distributed``'s rules (``launch.steps.with_shardings``: DTensors) and
    run under ``distributed.sharded``, against the same model unsharded:

    * paper-lm-100m whole: one train step (``build_train_step``) at the
      train driver's batch, gradient compression off and ``"bf16"``; the
      loss, the new parameters and every optimizer-state leaf bit for bit;
    * qwen2-0.5b whole: 8 fused ``decode_and_sample`` steps (4 slots, a
      64-row cache) and 8 teacher-forced decode steps on the same
      tokens; ids and logits bit for bit, greedy_sample launched once a
      sharded step (counted from 0 just before). A sharded (DTensor)
      cache keeps the einsums of decode attention, so the unsharded run
      takes them too (``_plain_decode_attention``), not the kernel;
    * phi-3.5-MoE at its published widths, 2 of its 32 layers:
      ``moe_impl="shard_map"`` through the expert all-to-all over the NCCL
      group (``CommDebugMode`` counts each ``all_to_all_single``) against
      the one-device path, logits and aux loss bit for bit, the router's
      top_k launched once a layer (counted from 0 just before).

    Each check prints its unsharded and sharded seconds; the phase prints
    its seconds and peak memory."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import (cache_shardings, input_shardings, opt_state_shardings,
                                         param_shardings, sharded)
    from repro_torch.kernels.sampling import greedy_sample, top_k
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, with_shardings
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    device = "cuda"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    found = torch.cuda.memory_allocated()
    store = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))

    def timed(run):
        torch.cuda.synchronize()
        ti = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - ti

    try:
        mesh = make_host_mesh()
        print(f"[distributed] one-rank nccl group, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {device} ({smi})")

        # paper-lm-100m whole: one train step, compression off and bf16
        cfg = dataclasses.replace(get(TRAIN_ARCH), remat="none")
        model = Model(cfg, device=device)
        params, opt = model.init(SEED), AdamW()
        b, s = DIST_TRAIN
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 SyntheticLMDataset(cfg.vocab_size, s, b).batch(0).items()}
        for compress in ("none", "bf16"):
            m = Model(dataclasses.replace(cfg, grad_compression=compress), device=device)
            step, state = build_train_step(m, opt), opt.init(params)
            step(params, state, batch)  # warm-up
            (p1, s1, m1), plain_s = timed(lambda: step(params, state, batch))
            args = (with_shardings(params, param_shardings(mesh, params, cfg), mesh),
                    with_shardings(state, opt_state_shardings(mesh, state, cfg), mesh),
                    with_shardings(batch, input_shardings(mesh, batch, cfg), mesh))
            step(*args)
            (p2, s2, m2), sharded_s = timed(lambda: step(*args))
            if not torch.equal(m1["loss"], m2["loss"]):
                raise SystemExit(f"[distributed] the sharded train step's loss differs "
                                 f"({compress}): {float(m1['loss'])} vs {float(m2['loss'])}")
            _sharded_against_plain("[distributed] train step", (p1, s1), (p2, s2))
            print(f"[distributed] {cfg.name} train step (B={b}, S={s}, grad_compression="
                  f"{compress}): loss {float(m1['loss']):.6f}, the loss and all "
                  f"{len(leaves(p1)) + len(leaves(s1))} parameter and optimizer-state "
                  f"leaves bit for bit the unsharded step's; {plain_s * 1e3:.1f} ms unsharded, "
                  f"{sharded_s * 1e3:.1f} ms sharded (one step, host clock)")
        del model, params, batch, m, state, args, p1, s1, p2, s2

        # qwen2-0.5b whole: fused decode_and_sample and teacher-forced decode_step
        cfg = dataclasses.replace(get("qwen2-0.5b"), remat="none")
        model = Model(cfg, device=device)
        params = model.init(SEED)
        b, rows, steps = DIST_DECODE
        gen = torch.Generator().manual_seed(SEED + 26)
        prompt = torch.randint(0, cfg.vocab_size, (b,), generator=gen, dtype=torch.int32).to(device)
        first = torch.ones(b, dtype=torch.bool, device=device)

        def decode(p, cache, forced, placed: bool = False):
            ids = {"tokens": torch.zeros((b, 1), dtype=torch.int32, device=device)}
            if placed:
                ids = with_shardings(ids, input_shardings(mesh, ids, cfg), mesh)
            ids = ids["tokens"]
            out_ids, out_logits, tok = [], [], prompt[:, None]
            for i in range(steps):
                ids, _ = model.decode_and_sample(p, cache, ids, prompt, first & (i == 0), i)
                logits, _ = model.decode_step(p, forced, tok, i)
                tok = ids
                out_ids.append(ids)
                out_logits.append(logits)
            return out_ids, out_logits

        caches = [model.init_cache(b, rows) for _ in range(2)]
        with _plain_decode_attention():  # the einsums, which the sharded cache runs
            (want_ids, want_logits), plain_s = timed(lambda: decode(params, *caches))
        placed = with_shardings(params, param_shardings(mesh, params, cfg), mesh)
        caches = [model.init_cache(b, rows) for _ in range(2)]
        caches = [with_shardings(c, cache_shardings(mesh, cfg, c), mesh) for c in caches]
        greedy_sample.launches = 0
        with sharded(mesh):
            (got_ids, got_logits), sharded_s = timed(lambda: decode(placed, *caches, True))
        greedy = greedy_sample.launches
        _sharded_against_plain("[distributed] decode ids", want_ids, got_ids)
        _sharded_against_plain("[distributed] decode logits", want_logits, got_logits)
        if greedy != steps:
            raise SystemExit(f"[distributed] greedy_sample launched {greedy} times in "
                             f"{steps} sharded fused steps")
        print(f"[distributed] {cfg.name} {steps} fused decode_and_sample steps and {steps} "
              f"decode_steps (B={b}, cache {rows} rows): ids and logits bit for bit the "
              f"unsharded ones; greedy_sample launched {greedy} times; first row "
              f"{[int(x[0, 0]) for x in want_ids]}; {plain_s:.2f} s unsharded, {sharded_s:.2f} s "
              f"sharded (host clock)")
        del model, params, placed, caches, want_logits, got_logits

        # phi-3.5-MoE at published widths, 2 of 32 layers: the all-to-all
        full = get(MOE_ARCH)
        cfg = dataclasses.replace(full, n_layers=DIST_MOE_LAYERS, remat="none",
                                  moe_impl="shard_map")
        model = Model(cfg, device=device)
        params = model.init(SEED)
        tokens = torch.randint(0, cfg.vocab_size, DIST_MOE_TOKENS, generator=gen,
                               dtype=torch.int32).to(device)
        (want, want_aux), plain_s = timed(lambda: model.forward(params, {"tokens": tokens}))
        placed = with_shardings(params, param_shardings(mesh, params, cfg), mesh)
        batch = with_shardings({"tokens": tokens}, input_shardings(mesh, {"tokens": tokens}, cfg),
                               mesh)
        top_k.launches = 0
        with sharded(mesh), CommDebugMode() as comm:
            (got, got_aux), sharded_s = timed(lambda: model.forward(placed, batch))
        routers = top_k.launches
        counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
        _sharded_against_plain("[distributed] MoE logits", [want, want_aux], [got, got_aux])
        if counts.get("all_to_all_single", 0) != 2 * cfg.n_layers:
            raise SystemExit(f"[distributed] the MoE forward issued {counts} collectives, not "
                             f"two all-to-alls a layer")
        if routers != cfg.n_layers:
            raise SystemExit(f"[distributed] top_k launched {routers} times for "
                             f"{cfg.n_layers} routers")
        print(f"[distributed] {cfg.name} at published widths, {cfg.n_layers} of "
              f"{full.n_layers} layers, moe_impl=shard_map over the nccl group: logits "
              f"{tuple(want.shape)} and aux {float(want_aux):.6f} bit for bit the one-device "
              f"path's; collectives {counts}; top_k launched {routers} times; "
              f"{plain_s * 1e3:.1f} ms one-device, {sharded_s * 1e3:.1f} ms sharded (host clock)")
        del model, params, placed, want, got
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"[distributed] phase took {time.perf_counter() - t0:.1f} s; "
          f"max_memory_allocated={peak} B ({smi})")
    _free_model("[distributed]", found)
    return {"greedy_sample": greedy, "top_k": routers}


def main() -> None:
    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    phase_seeded_draw()
    records = [phase_kernel_check(smi), check_decode_attention(smi)]

    from repro_torch.configs import get
    from repro_torch.models.model import Model

    model = Model(get("qwen2-0.5b"), device="cuda")
    params = model.init(SEED)
    n_params = _tree_bytes(params)[0]
    print(f"[model] qwen2-0.5b full width, seeded: {n_params} parameters")
    launches = phase_main_path(model, params)
    phase_numerics(model, params)
    bf16_modes = phase_serve_modes(model, params, smi)
    int8_launches = phase_int8_kv(model, params, smi, bf16_modes)
    phase_chunked(model, params, smi)
    records += [*check_matmul(smi), check_configured_matmul(smi), *check_flash_attention(smi),
                check_top_k(smi)]
    calibration = phase_calibrate(smi)
    launches["matmul"] = calibration["matmul"]
    launches["flash_attention"] = calibration["flash_attention"]
    print(f"[calibrate] greedy_sample launches on the calibration path: "
          f"{calibration['greedy_sample']} (the record's count is the serving path's)")
    launches.update(phase_ops_path(model, params))
    bridge_launches, bridge_arms, bridge_streams = phase_bridge(model, params, smi)
    doctor_launches = phase_doctor(model, params, smi, bridge_arms, bridge_streams)
    phase_compiler()
    del model, params
    torch.cuda.empty_cache()
    moe = phase_moe(smi)
    ssm = phase_ssm(smi)
    cuts = {sfx: phase_cut(smi, arch, tag, cut, sfx) for arch, tag, cut, sfx in CUTS}
    encdec = phase_encdec(smi)
    vlm = phase_vlm(smi)
    dense = phase_dense(smi)
    train = phase_train(smi)
    distributed = phase_distributed(smi)
    phase_dryrun(smi)
    for record in records:
        record["launches"] = launches[record["name"]]
        if record["name"] == "greedy_sample":
            record["launches_int8"] = int8_launches
            record["launches_bridge"] = bridge_launches
            record["launches_doctor"] = doctor_launches
            record["launches_moe"] = moe.pop("greedy_sample")
            record["launches_ssm"] = ssm.pop("greedy_sample")
            record["max_abs_err"] = max(record["max_abs_err"], ssm.pop("max_abs_err"))
            record.update(ssm)  # the RWKV head's shape: times, bound and cluster
            for sfx, cut in cuts.items():  # jamba's and kimi-k2's heads
                record[f"launches_{sfx}"] = cut.pop("greedy_sample")
                record["max_abs_err"] = max(record["max_abs_err"], cut.pop("max_abs_err"))
                record.update({k: v for k, v in cut.items() if not k.startswith(("top_k",
                                                                                  "router"))})
            record["launches_encdec"] = encdec.pop("greedy_sample")
            record["max_abs_err"] = max(record["max_abs_err"], encdec.pop("max_abs_err"))
            record.update(encdec)  # the whisper head's shape: times, bound and cluster
            for path in (vlm, dense, train):  # phi-3-vision's head, the dense heads, training's
                record["max_abs_err"] = max(record["max_abs_err"], path.pop("max_abs_err"))
            record["launches_vlm"] = vlm.pop("greedy_sample")
            record["launches_dense"] = dense.pop("greedy_sample")
            record["launches_train"] = train.pop("greedy_sample")
            record["launches_distributed"] = distributed["greedy_sample"]
            record.update(vlm)
            record.update(dense)
            record.update(train)
        if record["name"] == "top_k":  # the MoE router's launches: this path's kernel now
            record["launches_ops"] = record["launches"]
            record["launches"] = moe.pop("top_k")
            record.update(moe)  # the router shape's times and bound
            record["launches_distributed"] = distributed["top_k"]
            for sfx, cut in cuts.items():  # jamba's routers and kimi-k2's, with its shape's times
                record[f"launches_{sfx}"] = cut.pop("top_k")
                record.update({k: v for k, v in cut.items() if k.startswith("router")})
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device check")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
