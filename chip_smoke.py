#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`tpukit_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each on its own lines; any failure raises, so the exit code is
not 0:
  1. device: `nvidia-smi` name and power limit, torch's device name;
  2. build: nvcc builds every kernel source of tpukit_torch/csrc, all at
     once (seconds and the ptxas register/shared-memory report);
  3. kernel vs plain: the paged-attention kernels (scores, values and
     the combine of the splits) against their plain PyTorch version,
     element by element, in five pool/compute dtype pairs, at five shapes:
     the one phase 4's serving config gives them (16 slots, 12 heads x 64,
     pages of 16, a 320-position window), GPT-2 small's full context (the
     same at 1024 positions), one slot at 1024 positions, a short window
     (3 slots, pages of 8, 32 positions: one split) and head dim
     12 in pages of 64 (bf16 and int8 rows of 24 and 12 bytes: the
     byte-load path); a second run must give the same bits; the split plan
     and units per SM; the kernels' device time (launches captured in a
     CUDA graph, timed by CUDA events) beside the plain version's time and
     the device-memory bound;
  4. serve: `ServeEngine` at GPT-2-small width (768 / 12 x 64 / 12 layers,
     vocab 50257, bf16) answers 64 requests with fused decoding; each paged
     kernel (once a call) must launch layers x decode ticks times;
  5. fused vs unfused: the same stream at f32 compute (4 layers) gives the
     same greedy tokens both ways, and int8 pages agree on >= 90% of them;
  6. training kernels vs plain: flash attention forward and backward at
     64 x 12 x 512 x 64 (and S = 511, 2048, and 8192 at 1 x 12 heads, the
     Ulysses shape of phase 34, timed; every bf16 head dim, 16 to 128,
     at S = 511, 512, 2048, with and without a pad mask), fused head + CE
     forward and backward at 32768 tokens x 768 x vocab 50257, bf16 and f32,
     with and without a pad mask, each against its plain version (the CE
     backward under O(1) cotangents, each of its two terms alone, with a
     negative control, and the same bits on a second run; bf16 CE also at
     20000 tokens, two backward chunks, and with W unpadded, 50257
     columns); shapes without a kernel instance of their own: flash at
     head dims 8 and 48 (zero-padded; [1, 1, 32, 8] among them) and at
     B * H = 65600, bf16 CE at dim 100; device times (CUDA graph), call,
     plain and SDPA times, the least time the card could take, TFLOP/s and
     the share of that bound; then the attention crossover: the eager "xla"
     path against the flash kernels at S = 16 ... 1024;
  7. train step at full width: the gpt-small-dim768 rung (batch 64, S 512,
     bf16), 8 steps; the loss falls on a repeated batch, and each step
     launches the flash kernels 12 + 12 + 12 + 12 times (forward, D, dK/dV,
     dQ), the CE forward and its combine once each and the CE backward's
     four kernels once per chunk of 8192 tokens;
  8. the train step through the kernels equals the step through the plain
     versions (f32, 2 layers, 2 steps);
  9. recipe 1 end to end at GPT-2-small width on the fixture corpus
     (`--sequence_length 512`, so S = 511 in front of the attention):
     trains, evaluates, samples (one batched decode on the ring, as
     tpukit's recipes sample), checkpoints;
 10. MoE kernels vs plain: the grouped-expert FFN forward and backward
     (768 -> 3072 -> 768, 8 experts), bf16 and f32, against their plain
     versions on these segment layouts: the recipe's equal capacity
     segments (20480 rows), the `sort_plan` layout of a real top-1 and
     top-2 routing at the e8 rung's shapes, an adversarial one (an
     empty expert, 1-row segments, segments across tiles, a padding
     tail; also at D 100, F 400, no multiple of 8), and one decode tick
     (16 rows, top-1), where the forward's
     decode policy must give every SM a unit in both products, and a
     rank's bank under expert parallelism at the e8 rung (E_local 2 x
     10240 rows at data 1 x expert 4, 4 x 5120 at 2 x 2); the
     backward under O(1) seeded cotangents, with negative controls; device
     times (CUDA graph), call and plain times, bounds, and
     `torch._grouped_mm`'s time for the same products where this torch has
     it (a yardstick: no bias, relu or rounding);
 11. MoE train step at full width: the gpt-small-dim768-e8 rung (batch 32,
     S 512, bf16, ExpertParallel 1 x 1 with the pallas dispatch), 8 steps;
     the loss falls on a repeated batch, and each step launches each
     grouped-expert kernel of training 12 times (up, down, dz2, dh, dx,
     dW), the flash kernels 12 + 12 + 12 + 12 and the CE kernels as in
     phase 7; the warm-up step runs under the comm audit's recorder (phase
     43);
 12. MoE train step through the kernels == through the plain versions (f32,
     2 layers, top-2, 2 steps), on the ExpertParallel 1 x 1 path and on the
     meshless dropless path;
 13. recipe 8 end to end (`--num_experts 8 --moe_dispatch pallas
     --checkpoint_format sharded`) at GPT-2-small width on the fixture
     corpus: trains, evaluates, samples (on the ring), checkpoints in
     tpukit's sharded layout, which restores bit for bit;
 14. MoE serving: `ServeEngine` at GPT-2-small width with 8 experts and the
     pallas dispatch answers phase 4's 64 requests with fused decoding; the
     grouped forward launches layers x (prefill dispatches + decode ticks)
     times, each decode tick under the decode policy (two combines), and
     the paged kernels as in phase 4;
 15. MoE fused vs unfused (f32, 4 layers): the same greedy tokens both ways,
     and the same as the engine's tokens through the plain versions (on
     the CPU) for the first 16 requests;
 16. DDP and FSDP at full width, in a world of one over NCCL: phase 7's
     rung and batches under `DataParallel`, `FSDP` (8 steps each) and
     `FSDP(cpu_offload=True)` (3 steps); the loss falls on a repeated
     batch, each step launches the flash and CE kernels as phase 7's do;
     step wall, tokens/s and peak device memory beside phase 7's; with
     offload the sharded parameters and the AdamW state are in host memory
     and the peak device memory is below plain FSDP's;
 17. the DP steps equal `SingleDevice`'s: phase 8's f32 2-layer setup, 4
     AdamW steps from the same parameters under `SingleDevice`,
     `DataParallel` and `FSDP`; losses within rtol 1e-4 and the parameters
     bit-equal to `SingleDevice`'s (whether the losses are too is printed);
 18. recipes 2 and 3 end to end (`python -m tpukit_torch.recipes.ddp` and
     `.fsdp`, world of one) as phase 9: train, evaluate, sample on the
     ring, checkpoint; each checkpoint restores into a `SingleDevice` state
     bit for bit; recipe 2 writes its `--metrics_log` JSONL (phase 43);
 19. threefry on the card: Random123's known answers; random bits,
     uniforms, split and fold_in keys and Bernoulli masks bit-equal to the
     CPU's at a serving tick's [16, 50304] (one key, and a key a row) and
     at odd shapes, Gumbel noise within 1e-6; the sampler (`_select_next`,
     t 0.8, top-k 40) gives the CPU's tokens; its time beside argmax's;
 20. sampled serving: phase 4's stream at temperature 0.8, top-k 40, fused:
     each paged kernel launches layers x decode ticks times; tokens/s
     beside phase 4's; at f32 with 4 layers the seeded stream (its first
     32 requests) gives the same tokens fused, unfused, on the ring and on
     a second run;
 21. ring serving (page_size 0, tpukit's default): phase 4's stream,
     tokens/s and the prefill/decode split beside phase 4's; f32 4-layer
     greedy ring tokens equal the paged ones (first 32 requests); MoE on
     the ring (8 experts,
     pallas): the grouped forward launches layers x (prefill dispatches +
     ticks) times;
 22. speculative serving (spec_k 4), 32 requests at full width: n-gram
     self-speculation on the repetitive stream beside vanilla ring decoding
     of it, and a fresh seeded draft model (64 / 4 x 16 / 2 layers) on the
     first half of phase 4's stream:
     acceptance, tokens appended per verify, tokens/s; at f32 with 4
     layers greedy speculation equals vanilla (first 16 requests) and
     sampled speculation equals the serial `reference_spec_decode` (first
     4);
 23. dropout training: phase 7's rung at dropout 0.1 (the loss falls, the
     kernels launch as in phase 7, the step wall beside phase 7's), and
     phase 8's kernel-vs-plain steps at dropout 0.1 with the same keys;
 24. the pipeline at full width, in a world of one over NCCL (one stage):
     phase 7's rung and batches under `Pipeline` (GPipe) and
     `Pipeline1F1B`, M = 4, 8 steps each; the loss falls on a repeated
     batch, each step launches the flash kernels 12 x M times each
     (forward, D, dK/dV, dQ) and the CE kernels not at all (the head is the
     vocab-parallel CE, tpukit's jnp head); step wall, tokens/s and peak
     device memory beside phase 7's;
 25. the pipeline steps equal `SingleDevice`'s: phase 8's f32 2-layer
     setup, 4 AdamW steps under `SingleDevice`, `Pipeline` and
     `Pipeline1F1B` (M = 4) on the card, the pipelines' losses within rtol
     1e-4 of the card's single-device losses and of the plain versions'
     on the CPU;
 26. recipes 4 and 5 end to end (`python -m tpukit_torch.recipes.pipe` and
     `.pipe_ddp`, world of one, M = "4x" = 4) as phase 9: train, evaluate,
     sample on the ring, checkpoint; each checkpoint restores into a
     `SingleDevice` state bit for bit;
 27. checkpoints in tpukit's formats: recipe 1 as phase 9, once with
     `--checkpoint_format consolidated` and once with `sharded`; each
     checkpoint verifies, `restore_params` gives the trained parameters bit
     for bit and a full restore the parameters, AdamW moments and step;
     the sharded params-only read skips 2x what it reads (the moments);
     bytes on disk, the I/O ledger and the restore walls;
 28. serving the recipe's checkpoint: `python -m tpukit_torch.serve
     --checkpoint latest --page_size 16 --fused_decode` at the recipe's
     width on phase 4's stream (the restore line; each paged kernel
     layers x decode ticks times); through the engine, the restored
     parameters of the `.pt`, consolidated and sharded checkpoints give the
     in-memory parameters' tokens; the trained weights' tokens/s beside
     phase 4's; at f32 the paged fused engine's greedy continuations of
     `GENERATION_PROMPTS` equal `generate_samples`';
 29. serving recipe 8's sharded checkpoint (`--num_experts 8
     --moe_dispatch pallas --page_size 16 --fused_decode`: the grouped and
     paged kernels launch; restored tokens == in-memory tokens), and phase
     22's seeded draft saved consolidated and restored: phase 22's draft
     run's tokens and acceptance, sampled speculation's tokens equal to the
     in-memory draft's, and the CLI's `--draft model --draft_checkpoint`;
 30. tensor parallelism at full width, in a world of one over NCCL:
     phase 7's rung and batches under `TensorParallel` (recipe 6's grid
     of one card: data 1 x model 1), 8 steps; the loss falls on a repeated
     batch, each step launches the flash kernels 12 times each (forward,
     D, dK/dV, dQ: 12 + 36) and the CE kernels not at all (the head is the
     vocab-parallel CE); step wall, tokens/s and peak beside phase 7's;
 31. the TP steps equal `SingleDevice`'s: phase 8's f32 2-layer setup, 4
     AdamW steps; in the world of one the losses within rtol 1e-4 of the
     default `SingleDevice` step's and the parameters bit-equal to its
     unfused step's (`TPUKIT_FUSED_HEAD=0`, three q/k/v products: the same
     kernels, since every Megatron operator is the identity at one rank);
     then model 2 over two gloo ranks on this card (`chip_smoke.py
     --tp-gloo-rank R`, 6 heads a rank through the flash kernels): each
     leaf of the first step's gradient within 1e-2 of its norm, losses
     within rtol 1e-4 of the single device's, parameters within 2 x lr x
     steps (AdamW's bound on an update whose sign flips);
 32. recipe 6 end to end (`python -m tpukit_torch.recipes.tp`, world of
     one) as phase 9: train, evaluate, sample on the ring, checkpoint; the
     checkpoint restores into a `SingleDevice` state bit for bit;
 33. dense serving through the serving grid (`serve.__main__.serving_grid`
     -> `pick_serve_grid` -> `TensorParallel` -> the engine's `mesh`, whose
     decode ticks call the TP wrapper of the paged kernels): phase 4's
     stream (each paged kernel layers x decode ticks times: 3072 for 64
     requests); at f32 with 4 layers the paged fused and the ring engines'
     greedy tokens equal phase 5's; the MoE model over a data grid of one
     gives phase 15's tokens, its grouped forward launching layers x
     forwards times; the warm-up run (4 requests) runs under the comm
     audit's recorder (phase 43);
 34. context parallelism at full width, in a world of one over NCCL: the
     rung under `ContextParallel` at 32768 tokens a step, the ring at
     batch 16 x S 2048 (one diagonal hop, plain PyTorch) and Ulysses at
     batch 4 x S 8192, 8 steps each; the loss falls on a repeated batch,
     the CE kernels launch as in phase 7, the flash kernels 12 + 36 a step
     under Ulysses and not at all under the ring; step wall, tokens/s and
     peak beside phase 7's;
 35. the CP steps equal `SingleDevice`'s: phase 8's f32 2-layer setup, 4
     AdamW steps; in the world of one Ulysses bit-equal (losses and
     parameters) and the ring's losses within rtol 1e-4; then Ulysses seq
     2 over two gloo ranks on this card (`chip_smoke.py --cp-gloo-rank R`;
     gloo carries the all-to-all and the all-gather of CUDA tensors, not
     the ring's point-to-point sends) at phase 31's bars;
 36. recipe 7 end to end (`python -m tpukit_torch.recipes.ring`, world of
     one), the ring and `--cp_attention ulysses`, as phase 9: train,
     evaluate, sample on the ring cache, checkpoint; each checkpoint
     restores into a `SingleDevice` state bit for bit;
 37. MoE under DataParallel and expert parallelism over ranks: one step of
     the e8 rung (dropless pallas) under `DataParallel` in a world of one
     over NCCL, bit-equal to `SingleDevice`'s; then `ExpertParallel` on
     (data 1, expert 2) over two gloo ranks on this card (`chip_smoke.py
     --ep-gloo-rank R`: each rank 2 of 4 experts through the grouped
     kernels after the token all-to-all) against the single device's
     `ExpertParallel` 1 x 1 step (f32, 2 layers, top-2, EP_STEPS steps) at
     phase 12's bars, each rank's grouped kernels launched layers x steps
     times;
 38. the quantized collectives and gradient buckets: phase 7's rung under
     `DataParallel` and `FSDP` in a world of one over NCCL at
     `--comm_dtype int8` (DataParallel's hand-placed wire quantizes at one
     rank too) and at f32 with `--grad_buckets 4` (8 steps each, checked
     as phase 7's, the step wall beside phase 7's); DataParallel int8 over
     two gloo ranks on this card (`chip_smoke.py --dp-gloo-rank R`, phase
     8's f32 2-layer setup) against the same step computed in this
     process, the loss within 1e-5 and each gradient within one
     quantization step of its block; phase 37's EP (data 1, expert 2) with
     an int8 and a bf16 exchange (the same spawn), each rank's grouped
     kernels counted and the losses within the EP band of the f32
     exchange's; DDP int8 and FSDP f32 with buckets take a ninth step
     under the comm audit's recorder, and rank 0's first gloo
     `value_and_grad` runs under it (phase 43);
 39. resilience on the card: recipe 1 at GPT-2-small width (batch 64, S
     512, 17 steps of the fixture corpus) through the recovery plane, each
     run through `recovery.run_recipe` as the recipe's `__main__` runs it:
     (a) a control run, saving with `--checkpoint_every 8
     --async_checkpoint --keep_checkpoints 2`, which leaves the two newest
     checkpoints; (b) `--chaos_spec sigterm@9` exits 75 with a
     checkpoint whose sidecar says preempted at epoch 0, batch 9 (kept for
     phase 40 (e)), and `--resume latest` finishes the epoch with the
     control's windows after step 9, bit for bit; (c) on 25 steps
     `--checkpoint_every 8 --chaos_spec nan_loss@12 --spike_threshold 6
     --on_anomaly rollback` rolls back once (the window ending at step 17
     to the step-8 checkpoint, step 16's quarantined) and exits 0, its
     windows after the rollback equal to a control restored from step 8
     with `skip@17`, every one of its 25 steps (the 8 replayed ones too)
     launching phase 7's flash and CE counts; (d) `--max_rollbacks 0` exits 77 and `--spike_action abort`
     76, each with the blown-up state checkpointed; the async writer's
     bytes equal the sync writer's on the control's final state; each
     run's wall, and a sync and an async save of the 1.03 GB state timed;
 40. training telemetry on the card: recipe 1 at phase 39's width for 17
     steps (1088 fixture rows) with `--metrics_log --metrics_dir
     --log_grad_norms --divergence_check_freq 8 --hang_timeout 60`, and
     again with telemetry off: the windows and every final parameter bit
     for bit, each of the 17 steps launching phase 7's flash and CE counts,
     the JSONL of tpukit's kinds (its `xla` records: the first train and
     eval step's, from the comm audit), every `train` record with MFU
     in (0, 1) and its `hbm` peak under the card's limit, `tools/report.py`
     exits 0 on it, the window wall with telemetry on and off; a
     `--chaos_spec hang@5:3 --hang_timeout 1 --trace_on_anomaly 2` run
     finishes, its step-5 bundle holds the training thread's stack in the
     hang and the card's memory gauges, `tools/flightview.py` renders it,
     and the anomaly trace's Chrome JSON names the flash and CE kernels; a
     bundle's write time; a 3-step `--profile_dir` run whose trace names
     them too; a `--debug_nans` run over one window, preempted at step 9,
     whose checkpoint's bytes (every parameter and the AdamW state) equal
     those of phase 39 (b)'s run without the flag;
 41. serving telemetry on the card: phase 4's engine and the first 16
     requests of its stream (a) with every serving plane on (request traces, the metrics plane,
     `--slo`, a JSONL logger, a metrics dir) against all off, three runs
     each, alternated: tokens/s of each run, the medians and their ratio,
     the summary's prefill / decode / sync / other / dispatch / device
     seconds, and the paged launches, which must equal phase 4's formula
     in both; (b) the on run's tokens equal the off run's bit for bit, with
     the same steps, prefill dispatches and launches, here and on 16
     requests sampled (t 0.8, top-k 40), with n-gram speculation on the
     repetitive stream on the ring (whose summary must show `decode_s` 0
     and `verify_s` > 0) and on the MoE model (8 experts, pallas, paged,
     fused: the grouped forward and the paged kernels launching as in
     phase 14); (c) every on run's records: tpukit's serving kinds, each
     window's seconds summing to its wall, every span tree closed and
     complete, none dropped; `build_trees`' time over a full ring; (d)
     `python -m tpukit_torch.serve` at the recipes' width (`--page_size 16
     --fused_decode --metrics_log --metrics_dir --slo`, 16 requests) in a
     process of its own, then `tools/report.py --min_trace_complete 1.0`
     and `tools/traceview.py` on its JSONL and its merged snapshot;
 42. serving fleet on the card (`serve.fleet.FleetRouter` over
     `ServeEngine` replicas on this card): (a) phase 4's engine and the
     first 16 requests of its stream through one engine and a fleet of two
     replicas, in turns, tokens/s of
     each, the paged kernels launching layers x the replicas' summed ticks;
     at f32 with 4 layers (phase 5's) the fleet's greedy tokens equal one
     engine's, each request once; (b) `replica_kill@8:1` mid-stream: the
     same tokens, each request once, the requeue count; (c)
     `disagg_prefill`, one prefill worker and two decode replicas: the
     same tokens, no prefill dispatch on a decode replica and no tick on
     the worker (so no paged launch), the pages claimed and copied and the
     copy's host wall; (d) autoscale: one replica grows to two and drains
     back to one (`scale_up`, `scale_down`, `scale_down_complete` of
     replica 1, in that order), the same tokens; (e) `stuck_request` with
     a 500 ms deadline: evicted with reason "deadline" and a
     `deadline_miss` row, its tokens a prefix of the run without it, the
     others' unchanged; (f) the MoE model (8 experts, pallas) on two
     replicas, 16 requests: the grouped forward launches layers x (prefill
     dispatches + ticks) and the paged kernels layers x ticks, summed over
     the replicas; (g) in processes of their own, `python -m
     tpukit_torch.serve --replicas 2 --fleet_kill replica_kill@8:1` with
     the JSONL and `--slo`, and `--fleet_procs --fleet_dir --fleet_kill
     replica_sigkill@6:1` with two worker processes on this card (a real
     SIGKILL, the worker's exit -9), 16 requests each: `tools/report.py
     --min_fleet_tps 1` exits 0 on each JSONL (and `--min_trace_complete
     1.0` on the router's; the process fleet's workers trace nothing),
     each request once;
 43. the comm audit and the native tokenizer on the card
     (`comm_audit_and_tokenizer`): the traces phases 11, 33 and 38
     recorded, each linted against its plan (`tpukit_torch.analysis`):
     the measured collectives equal the plan, no error (the overlap
     gate's included), the kernels launched as the phase's steps;
     recipe 2's `kind="xla"` records (phase 18) with tpukit's keys,
     `tools/report.py` exit 0 on them; the native tokenizer built and
     used, its ids and masks byte-equal to the Python encoder's on the
     fixture corpus, both walls;
 44. the bench twin (`bench_twin_on_card`): the headline step of `python
     -m tpukit_torch.bench` at tpukit's bench config, its `kind="xla"`
     record clean, the flash and CE kernels launching as its steps need;
     `comm_overlap` at 2 steps, every rung without error, with tpukit's
     row keys, FSDP's three rungs the same loss bit for bit;
 45. the bench twin's serving records (`bench_serving_on_card`): the
     eight records of `tpukit_torch/bench/serving.py` at the bench config
     (8 requests each; the spec target and draft trained 100 and 150
     steps, 24 new tokens a spec request; the fleet's rungs meshless on
     the one card), each with the
     twin's key lists and no error, both overhead records' tokens the same
     bits, `parity_ok` in `paged_kv`, `decode_fused` and `fleet_serving`,
     complete traces; the paged kernels launching layers x decode ticks in
     `decode_fused`'s fused rungs (each run twice: warm and measured), and
     the flash and CE kernels as the induction training's steps need;
 46. fleet replicas over a model-parallel grid (`grid_fleet_on_card`,
     ROADMAP item 19b): `FleetRouter` with 2 replicas x
     `devices_per_replica` 2 on this card, each replica a world of two
     gloo ranks (`serve/replica_world.py`; model 2, 6 heads a rank):
     first the paged kernels against their plain versions at a rank's
     shape (phase 4's slots and pages, 6 heads, every dtype pair); (a)
     phase 4's engine (bf16, 12 layers) on 16 requests through the grid
     fleet, its tokens/s over its router's wall beside phase 42 (a)'s one
     engine on the same requests (both fleets' worlds start together
     before anything runs, and that start is printed beside it), each rank
     of each replica
     launching each paged kernel layers x its replica's ticks; (b) phase
     5's f32 4 layers on the first 32 of its requests: the grid fleet's
     greedy tokens equal phase 5's engine's; after each run every rank
     process has exited;
then one JSON line of kernel results (the flash and CE rows with their
launches under CP, under the quantized wires and in phase 40's telemetry
step, the grouped rows with
theirs under EP, f32 and quantized exchanges, and their times at the EP
shapes, the paged and grouped decode rows with theirs in phases 41 and
42, the paged row with each grid rank's in phase 46 and its times at a
grid rank's shape) and, last, the
device JSON line.

Imports nothing of JAX or of the JAX package. Without CUDA it exits with
code 2 and prints no result. `--tp-gloo-rank R STORE OUT`,
`--cp-gloo-rank R STORE OUT`, `--ep-gloo-rank R STORE OUT` and
`--dp-gloo-rank R STORE OUT` are one rank of phase 31's, 35's, 37's and
38's two-rank worlds, which the script starts itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from tpukit_torch import mesh as mesh_lib
from tpukit_torch import native
from tpukit_torch import random as tk_random
from tpukit_torch import resolve_device
from tpukit_torch.data import get_tokenizer
from tpukit_torch.analysis import comm_ir, decode_comm_plan, lint_trace, train_comm_plan
from tpukit_torch.ops import _cuda
from tpukit_torch.ops.attention import FLASH_MIN_SEQ, causal_attention
from tpukit_torch.ops import flash_attention as fa
from tpukit_torch.ops import fused_head_ce as fce
from tpukit_torch.ops import moe_gemm
from tpukit_torch.ops import paged_attention as pa
from tpukit_torch.ops import quant_comm
from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch import recovery
from tpukit_torch import train as train_mod
from tpukit_torch.flags import parse_flags
from tpukit_torch.ops.moe_dispatch import ExpertGrid, _route_topk
from tpukit_torch.recipes import ddp as ddp_recipe
from tpukit_torch.recipes import fsdp as fsdp_recipe
from tpukit_torch.recipes import moe as moe_recipe
from tpukit_torch.recipes import pipe as pipe_recipe
from tpukit_torch.recipes import pipe_ddp as pipe_ddp_recipe
from tpukit_torch.recipes import ring as ring_recipe
from tpukit_torch.recipes import single
from tpukit_torch.recipes import tp as tp_recipe
from tpukit_torch.recipes.profile import (
    BATCH,
    GPT2_SMALL_TRAIN,
    PIPE_MICRO,
    RUNGS,
    SEQ,
    build_train,
    rung_strategy,
    synthetic_batch,
)
from tpukit_torch.serve import decode as serve_decode
from tpukit_torch.serve import spec as spec_lib
from tpukit_torch.serve import __main__ as serve_main
from tpukit_torch.serve.engine import (Request, ServeConfig, ServeEngine,
                                       synthetic_request_stream)
from tpukit_torch.serve.fleet import FleetConfig, FleetRouter
from tpukit_torch.serve.profile import REQUESTS, SERVE_SHAPE, build
from tpukit_torch.model import GPTConfig, init_params
from tpukit_torch.obs import (FlightRecorder, MetricRegistry, StepLogger, TraceRecorder,
                              parse_slo, publish_snapshot, write_bundle)
from tpukit_torch.obs import trace as trace_lib
from tpukit_torch.pipeline import Pipeline, Pipeline1F1B
from tpukit_torch.shardings import (
    FSDP,
    ContextParallel,
    DataParallel,
    ExpertParallel,
    SingleDevice,
    TensorParallel,
    gather_full,
    leaves,
    unflatten,
)
from tpukit_torch.train import (GENERATION_PROMPTS, create_train_state, generate_samples,
                                to_device, train_step)

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 non-tensor, bf16 dense
KERNEL = "paged_attention"  # the serving path's csrc source
SOURCES = ("paged_attention", "flash_attention", "fused_head_ce", "moe_gemm")  # every csrc source
F32_ATOL = 1e-5  # f32 compute: the kernel and the plain version sum in different orders
DIFF_SHARE = 0.01  # bf16 compute: most outputs must be bit-equal (see check_kernel)
# Training kernels against their plain versions (phase 6), as (atol, rtol,
# share of the row's largest |value|). f32: tpukit's CPU bars
# (tests/test_flash_attention.py:38,70; tests/test_fused_head_ce.py:41,61),
# except the CE gradients. tpukit's atol 2e-6 there is sized for the mean
# loss's cotangents (1/count); phase 6 holds them under O(1) cotangents, so
# gradients thousands of times larger, where f32 sums of 4096 (dW) or
# 50304 (dH) terms in another order differ by ~sqrt(K) 2^-24 of the row's
# scale. Their bar is 2^-12 of the row's largest |value|: ~4x over the
# worst element such a walk gives, and 7x (dW) to 800x (dH) tighter,
# relative to the gradient, than 2e-6 at the mean loss's scale. bf16: the
# online softmax rounds each tile's probabilities against the running
# maximum and the plain version against the row's maximum, and a rounded
# dS or d may land an ulp apart where the two f32 sums straddle a rounding
# boundary; each element within 2^-6 (two bf16 ulps at the top of the
# binade) of the largest |value| of its row.
FLASH_FWD_TOL = (2e-5, 1e-4, 0.0)
FLASH_GRAD_TOL = (5e-4, 1e-3, 0.0)
CE_LSE_TOL = (1e-5, 1e-5, 0.0)
CE_GRAD_TOL = (0.0, 1e-5, 2.0**-12)
BF16_ROW_SHARE = 2.0**-6
# The grouped-expert kernels against their plain versions (phase 10), both
# given the same inputs (the backward: the kernel's y and kept h). Outputs
# that are f32 sums of f32 or identical terms (every output in f32 compute;
# dWd, dbu, dbd in bf16 compute) differ only in summation order over 768 to
# 4096 terms (D, F, or an expert's rows), ~sqrt(K) 2^-24 of the row's scale:
# 2^-12 of the row's largest |value| + rtol 1e-5 (the CE gradients' bar);
# a dbu summed from the rounded dz1 fails it. Outputs that pass through a
# bf16 rounding of an f32 sum (bf16 y and dx, and dWu = x^T round(dz1)):
# where the kernel's and the plain f32 sums straddle a rounding boundary a
# rounded h or dz1 lands an ulp apart and moves what follows, so
# BF16_ROW_SHARE, as the flash and CE gradients in bf16.
MOE_TOL = (0.0, 1e-5, 2.0**-12)
MOE_ROUNDED = ("y", "dx", "dwu")  # bf16 compute: held at BF16_ROW_SHARE
MOE_ROUTED = dict(batch=32, seq=SEQ, experts=8)  # the e8 rung's routing (phase 10 b)
MOE_DECODE_ROWS = 16  # one MoE serving tick: 16 slots, top-1 (phase 10 d)
# the bf16 grouped kernels of a training step (128-row tiles: no combine)
MOE_TRAIN_KERNELS = ("forward_up", "forward_down", "backward_dz2", "backward_dh", "backward_dx",
                     "backward_dw")
# phase 10 c: an empty expert, 1-row segments, segments across row tiles;
# 9999 rows, so a 241-row padding tail
MOE_ADVERSARIAL = (3000, 0, 1, 129, 2047, 130, 1, 4691)
# phase 10 e: a rank's experts under expert parallelism at (data 1, expert
# 4) and (2, 2) of the e8 rung
EP_LOCAL_EXPERTS = (2, 4)


_PHASE_T0 = [time.perf_counter()]
_START = _PHASE_T0[0]


def phase(name: str) -> None:
    """Print the phase's name, after the wall the one before it took."""
    now = time.perf_counter()
    print(f"   ({now - _PHASE_T0[0]:.1f} s)", flush=True)
    _PHASE_T0[0] = now
    print(f"== {name}", flush=True)


def _events_ms(run, calls: int) -> float:
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per eager call over `iters` back-to-back calls, by
    CUDA events, after a warm-up. Host dispatch is in the span whenever
    it outlasts the device work. Each result is dropped before the next
    call, as on the main path, so its memory goes back to the allocator's
    cache: results kept alive would send every call's outputs to
    cudaMalloc and time that instead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    return _events_ms(run, iters)


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds per call: `iters` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events, so no host
    dispatch falls inside the span."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(lambda: [graph.replay() for _ in range(replays)], iters * replays)


def bf16_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per element of `ref [N, H, D]`: 2 bf16 ulp of the largest |ref| in
    its (slot, head) row, and no less than F32_ATOL. Not 2 ulp of the
    element itself: where the kernel's and the plain version's f32 score
    sums straddle a bf16 rounding boundary, that one probability moves by
    a bf16 ulp and every output of the row moves with it, by up to a few
    ulp of the row's scale, which is large beside an output near 0."""
    top = ref.float().abs().amax(-1, keepdim=True).expand(ref.shape)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)  # 0 where the row is 0
    return torch.clamp(2 * ulp, min=F32_ATOL)


def paged_bound_ms(starts, pool_dtype, cdt, n, h, d, p, mp) -> tuple[float, str]:
    """The least time for one call on these inputs: bytes it must move
    (window K/V minus the fresh token, the int8 scale blocks those
    positions touch, the block-table entries read, cursors, q/k/v in and
    the output out) over 3.35 TB/s, against its operations (q.k and p.v,
    2 flops per multiply-add) over the peak rate of the compute dtype."""
    lims = np.minimum(starts, mp * p - 1)
    pool_item = torch.tensor([], dtype=pool_dtype).element_size()
    c_item = torch.tensor([], dtype=cdt).element_size()
    nbytes = int(lims.sum()) * h * d * 2 * pool_item
    pages_read = sum(-(-int(l) // p) for l in lims)
    nbytes += 4 * pages_read + 4 * n + 4 * n * h * d * c_item
    if pool_dtype == torch.int8:
        blocks = 0
        for l in lims:
            for j in range(-(-int(l) // p)):
                blocks += -(-min(p, int(l) - j * p) * d // quant_comm.DEFAULT_BLOCK)
        nbytes += blocks * h * 2 * 4
    ops = 4 * int((lims + 1).sum()) * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[cdt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(dev, n, h, d, p, mp, seed=0):
    """Ragged block tables and cursors at 0, mid-page, a page boundary and
    W - 1 (plus seeded others; fewer than four slots take W - 1 first);
    pool values and vectors from a seed."""
    w = mp * p
    rng = np.random.RandomState(seed)
    special = [0, p // 2 - 1, p, w - 1] if n >= 4 else [w - 1, p, p // 2 - 1][:n]
    starts = np.concatenate([special, rng.randint(0, w, max(n - 4, 0))]).astype(np.int32)
    num_pages = n * mp + 1
    ids = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((n, mp), np.int32)
    k = 0
    for i, s in enumerate(starts):
        need = min(int(s) // p + 1 + int(rng.randint(3)), mp)
        bt[i, :need] = ids[np.arange(k, k + need) % len(ids)]
        k += need
    if n > 1:
        bt[1, 0] = bt[0, 0]  # a page two rows read, as a shared prefix page
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)
    return dict(pool_k=rand(num_pages, h, p, d) * 0.5, pool_v=rand(num_pages, h, p, d) * 0.5,
                bt=torch.from_numpy(bt).to(dev), start=torch.from_numpy(starts).to(dev),
                q=rand(n, h, d), k_new=rand(n, h, d), v_new=rand(n, h, d), starts=starts)


# phase 3's shapes: the serving run's (filled in by main from phase 4's
# config), GPT-2 small's full context at the same batch, one slot there,
# a short window (3 slots, pages of 8: one split; the shape of the
# recipes' samples before they moved to the ring), and rows that are no
# multiple of 16 bytes in bf16 and int8 pools (D 12, pages of 64 so that
# int8 rows tile into scale blocks)
PAGED_SHAPES = {"full_context": dict(n=16, mp=64), "one_slot": dict(n=1, mp=64),
                "sampling": dict(n=3, p=8, mp=4), "byte_loads": dict(d=12, p=64, mp=5)}
PAGED_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16), (torch.int8, torch.float32),
               (torch.int8, torch.bfloat16)]


def serving_shape(cfg, serve) -> dict:
    """The paged kernels' shape in a serving run: slots, heads, head dim,
    page size, pages a slot."""
    return dict(n=serve.slots, h=cfg.heads, d=cfg.head_dim, p=serve.page_size,
                mp=serve.pages_per_slot)


def paged_plan(pool_dtype, shape: dict) -> dict:
    lib = _cuda.load(KERNEL, pa._SIGNATURES)
    return pa.plan(lib, pool_dtype, shape["n"], shape["h"], shape["p"], shape["d"], shape["mp"])


def check_kernel(dev, shape: dict, label: str,
                 main_pair=(torch.float32, torch.bfloat16)) -> dict:
    """Kernels vs plain version in every dtype pair the engine can give
    them, at `shape` (n slots, h heads, head dim d, pages of p, mp pages
    per slot); returns the results of the pair the caller's path runs,
    `main_pair` (pool dtype, compute dtype): by default f32 pages, bf16
    compute.

    Held element by element: f32 compute within F32_ATOL; bf16 compute
    within 2 bf16 ulp of its (slot, head) row's scale (`bf16_tolerance`),
    and no more than DIFF_SHARE of the elements may differ at all. The kernels round where
    the plain version rounds, so the two differ only where their f32 sums
    straddle a bf16 rounding boundary; a missed rounding step moves many
    elements by an ulp and fails the share. A second run must give the
    same bits (no atomics)."""
    n, h, d, p, mp = (shape[k] for k in ("n", "h", "d", "p", "mp"))
    base = kernel_inputs(dev, n, h, d, p, mp)
    num_pages = n * mp + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main = None
    for pool_dtype, cdt in PAGED_PAIRS:
        pl = paged_plan(pool_dtype, shape)
        if pool_dtype == torch.int8:
            pools, scales = [], []
            for nm in ("pool_k", "pool_v"):
                qv, sv = quant_comm.quantize_blocks(base[nm].reshape(num_pages, h, p * d))
                pools.append(qv.reshape(num_pages, h, p, d))
                scales.append(sv)
        else:
            pools = [base["pool_k"].to(pool_dtype), base["pool_v"].to(pool_dtype)]
            scales = [None, None]
        args = (pools[0], pools[1], scales[0], scales[1], base["bt"], base["start"],
                base["q"].to(cdt), base["k_new"].to(cdt), base["v_new"].to(cdt))
        out = pa.paged_attend(*args)
        again = pa.paged_attend(*args)
        ref = pa.paged_attend_reference(*args)
        torch.cuda.synchronize()
        assert out.dtype == cdt and out.shape == (n, h, d)
        same_bits = torch.equal(out, again)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if cdt == torch.float32:
            tol = torch.full_like(diff, F32_ATOL)
            rule = f"atol {F32_ATOL:g} per element (f32 summation order)"
        else:
            tol = bf16_tolerance(ref)
            rule = (f"2 bf16 ulp of the largest output of each (slot, head), at "
                    f"least {F32_ATOL:g}; at most {DIFF_SHARE:g} of elements not "
                    f"bit-equal")
        worst = (diff / tol).max().item()
        share = (diff > 0).float().mean().item()
        ms = graph_ms(lambda: pa.paged_attend(*args), 200)
        call_ms = time_ms(lambda: pa.paged_attend(*args), 200)
        plain_ms = time_ms(lambda: pa.paged_attend_reference(*args), 100)
        bound, bound_by = paged_bound_ms(base["starts"], pool_dtype, cdt, n, h, d, p, mp)
        units = n * h * pl["splits"]
        print(f"paged_attend [{label}: N {n}, H {h}, D {d}, P {p}, MP {mp}] "
              f"pool={str(pool_dtype)[6:]} compute={str(cdt)[6:]}: plan {pl['pages_per_split']} "
              f"pages a split, {pl['splits']} splits, {units} units ({units / sms:.2f} an SM "
              f"of {sms}), {pl['stages']} stages, "
              f"{'bulk copies' if pl['bulk'] else 'byte loads'}, {pl['smem']} B shared; "
              f"max_abs_err {err:.3e}, worst err/tolerance {worst:.3e}, "
              f"{share:.5f} of elements not bit-equal ({rule}); second run "
              f"{'bit-equal' if same_bits else 'DIFFERS'}; kernels device "
              f"{ms:.5f} ms (CUDA graph), eager call {call_ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms (eager), bound {bound:.5f} ms ({bound_by}, "
              f"{HBM_BYTES_PER_S / 1e12} TB/s), {bound / ms:.3f} of the bound", flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"paged_attend disagrees with its plain version: "
                                 f"err/tolerance {worst} > 1 (pool {pool_dtype}, "
                                 f"compute {cdt}, max_abs_err {err}, {label})")
        if cdt == torch.bfloat16 and not share <= DIFF_SHARE:
            raise AssertionError(f"paged_attend differs from its plain version on "
                                 f"{share} of elements > {DIFF_SHARE} (pool "
                                 f"{pool_dtype}, compute {cdt}, {label})")
        if not same_bits:
            raise AssertionError(f"paged_attend gave other bits on a second run (pool "
                                 f"{pool_dtype}, compute {cdt}, {label})")
        if (pool_dtype, cdt) == tuple(main_pair):
            main = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=bound_by, splits=pl["splits"],
                        units_per_sm=units / sms)
    return main


def paged_want(calls: int) -> dict:
    """Each paged kernel's launches in `calls` calls: every kernel once a
    call."""
    return dict(paged_scores=calls, paged_values=calls, paged_combine=calls)


def build_all() -> None:
    """Build every csrc source at once, one nvcc each, and print each
    build's time and ptxas register/shared-memory report."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        reports = dict(zip(SOURCES, pool.map(_cuda.build, SOURCES)))
    for name, rep in reports.items():
        print(f"{name}: built in {rep['seconds']:.1f} s"
              f"{' (cached)' if rep['cached'] else ''} -> {rep['path']}")
        for line in rep["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  " + line.strip())
    print(f"all sources built in {time.perf_counter() - t0:.1f} s", flush=True)


def worst_ratio(got, ref, f32_tol, dtype) -> tuple[float, float]:
    """(max abs error, worst error/tolerance) of `got` against `ref`,
    element by element. f32: atol + rtol |ref| + share of the largest |ref|
    of the element's last-dim row (`f32_tol`). bf16: BF16_ROW_SHARE of
    that largest |ref|. Past a zero atol no absolute floor is left, so a
    row that is 0 in the plain version must be 0 in the kernel too."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    top = r.abs().amax(-1, keepdim=True)
    if dtype == torch.float32:
        atol, rtol, share = f32_tol
        tol = atol + rtol * r.abs() + share * top
    else:
        tol = BF16_ROW_SHARE * top
    ratio = torch.where(diff == 0, 0.0, diff / tol)
    return diff.max().item(), ratio.max().item()


def hold(what: str, got, ref, f32_tol, dtype) -> float:
    """`worst_ratio` within 1; returns the max abs error, raises past the
    bar."""
    err, worst = worst_ratio(got, ref, f32_tol, dtype)
    if not worst <= 1.0:
        g, r = got.float(), ref.float()
        at = np.unravel_index(int(((g - r).abs() / (r.abs().amax(-1, keepdim=True) + 1e-30))
                                  .argmax()), tuple(r.shape))
        raise AssertionError(f"{what}: kernel disagrees with its plain version, max_abs_err "
                             f"{err:.3e}, worst err/tolerance {worst:.3e}; worst relative to "
                             f"its row at {tuple(int(i) for i in at)}: kernel "
                             f"{g[at].item():.6e}, plain {r[at].item():.6e}, row's largest "
                             f"|plain| {r[at[:-1]].abs().max().item():.6e}")
    return err


def _bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bounds(b, h, s, d, dtype, masked) -> dict:
    """Least times of the forward and of the backward on these shapes: each
    input read once, each output written once (the backward's D = rowsum(dO
    O) is its input), against the products the causal half needs (forward
    QK^T and PV; backward QK^T, dO V^T, P^T dO, dS^T Q, dS K), 2 flops a
    multiply-add, over the dtype's peak."""
    it = torch.tensor([], dtype=dtype).element_size()
    t, rows = b * h * s * d * it, b * h * s * 4
    bias = b * s * 4 if masked else 0
    pairs = b * h * d * s * (s + 1) / 2
    return dict(forward=_bound(4 * t + rows + bias, 2 * 2 * pairs, dtype),
                backward=_bound(7 * t + 2 * rows + bias, 5 * 2 * pairs, dtype))


def flash_flops(b, h, s, d) -> dict:
    """The products the causal half needs, 2 flops a multiply-add: forward
    QK^T and PV, backward QK^T, dO V^T, P^T dO, dS^T Q, dS K (the kernels'
    second dV product, for P's low bf16 term, is not counted)."""
    pairs = b * h * d * s * (s + 1) / 2
    return dict(fwd=2 * 2 * pairs, bwd=5 * 2 * pairs)


def ce_bounds(n, dim, v_pad, dtype) -> dict:
    """Least times of the forward kernel (h, W in h's dtype and the targets
    in; lse, target logit and argmax out; the head product) and of the
    backward kernels (h, W, the targets, lse and both cotangents in; dH in
    h's dtype and dW f32 out; the head product again plus the dH and dW
    products)."""
    it = torch.tensor([], dtype=dtype).element_size()
    h_b, w_b, prod = n * dim * it, dim * v_pad * it, 2 * n * dim * v_pad
    return dict(forward=_bound(h_b + w_b + 4 * n + 12 * n, prod, dtype),
                backward=_bound(2 * h_b + w_b + dim * v_pad * 4 + 16 * n, 3 * prod, dtype))


def flash_inputs(dev, b, h, s, d, dtype, masked, seed):
    """q, k, v, dO from a seed; with `masked`, trailing padding of seeded
    length on every row and one row fully padded."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda: torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    mask = None
    if masked:
        lens = torch.randint(s // 4, s + 1, (b,), generator=g, device=dev)
        mask = torch.arange(s, device=dev)[None, :] >= lens[:, None]
        mask[-1] = True
    return q, k, v, do, mask


def bf16_ulps(got, ref) -> tuple[float, float]:
    """Largest |got - ref| in bf16 ulps (a binade's spacing,
    2^(floor(log2 |x|) - 7)) of the plain element, over elements where
    ref != 0, and of the largest |plain| of the element's row."""
    r = ref.float()
    ulp = lambda x: torch.exp2(torch.floor(torch.log2(x.clamp(min=1e-30))) - 7)
    diff = (got.float() - r).abs()
    own = (diff / ulp(r.abs()))[r != 0].max().item()
    return own, (diff / ulp(r.abs().amax(-1, keepdim=True))).max().item()


def check_flash(dev, b, h, s, d, dtype, masked, timed=False) -> dict:
    """Forward (out, lse) and backward (dq, dk, dv) kernels against the plain
    version on the same inputs; the backward gets the kernel's out and lse
    on both sides, and the plain backward sums in f64 (the same rounding
    points): where dP - D cancels exactly (query 0 sees key 0 alone, so
    its dQ row is 0) its f32 sums, taken in two orders, leave a residue that
    the bf16 bar, relative to the row, cannot hold; the kernels' D is
    formed as their dP is and cancels to 0. D = rowsum(dO O) from the
    preprocess kernel is held to the f32 rowsum (FLASH_FWD_TOL). With
    `timed`, device and call times too."""
    q, k, v, do, mask = flash_inputs(dev, b, h, s, d, dtype, masked, seed=s + b)
    scale = d**-0.5
    bias = fa.pad_bias(mask, b, s, dev)
    out, lse = fa._forward_cuda(q, k, v, bias, scale)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, bias, scale)
    grads = fa._backward_cuda(q, k, v, bias, out, lse, do, scale)
    ref_grads = fa.flash_backward_reference(q, k, v, bias, out, lse, do, scale,
                                            acc=torch.float64)
    lib = _cuda.load("flash_attention", fa._SIGNATURES)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dcap = torch.empty_like(lse)
    dq_b, dk_b, dv_b = (torch.empty_like(q) for _ in range(3))
    fa.launch_backward(lib, q, k, v, bias, do, out, lse, dcap, dq_b, dk_b, dv_b, scale,
                       stream())
    if d not in fa.HEAD_DIMS:  # through zero-padded copies: the public path must agree too
        pub = fa.flash_causal_attention(q, k, v, scale=scale, pad_mask=mask)
        via_auto = causal_attention(q, k, v, scale=scale, pad_mask=mask, impl="auto")
        if not (torch.equal(pub, out) and (s < FLASH_MIN_SEQ or torch.equal(via_auto, out))):
            raise AssertionError(f"flash at D {d}: the public paths give other outputs")
    torch.cuda.synchronize()
    tag = f"flash B{b} H{h} S{s} D{d} {str(dtype)[6:]}{' mask' if masked else ''}"
    err = hold(f"{tag} out", out, ref_out, FLASH_FWD_TOL, dtype)
    hold(f"{tag} lse", lse, ref_lse, FLASH_FWD_TOL, torch.float32)
    hold(f"{tag} D", dcap, (do.float() * out.float()).sum(-1), FLASH_FWD_TOL, torch.float32)
    g_err = max(hold(f"{tag} d{n}", gg, rr, FLASH_GRAD_TOL, dtype)
                for n, gg, rr in zip("qkv", grads, ref_grads))
    if not all(torch.equal(x, y) for x, y in zip(grads, (dq_b, dk_b, dv_b))):
        raise AssertionError(f"{tag}: two backward runs on the same inputs differ")
    res = dict(fwd_err=err, bwd_err=g_err)
    top = ", ".join(f"{n} {t.float().abs().max().item():.3e}"
                    for n, t in zip(("out", "dq", "dk", "dv"), (ref_out, *ref_grads)))
    ulps = bf16_ulps(grads[2], ref_grads[2])
    line = (f"{tag}: forward max_abs_err {err:.3e}, backward {g_err:.3e} (largest "
            f"|plain| {top}); dV largest error {ulps[0]:.3f} bf16 ulps of the element, "
            f"{ulps[1]:.3f} of its row's largest; backward bit-identical on a second run")
    if timed:
        o_b, l_b = torch.empty_like(q), torch.empty_like(lse)
        res.update(
            fwd_ms=graph_ms(lambda: fa.launch_forward(lib, q, k, v, bias, o_b, l_b, scale,
                                                      stream()), 20),
            fwd_call_ms=time_ms(lambda: fa._forward_cuda(q, k, v, bias, scale), 20),
            fwd_plain_ms=time_ms(lambda: fa.flash_forward_reference(q, k, v, bias, scale), 5),
            bwd_ms=graph_ms(lambda: fa.launch_backward(lib, q, k, v, bias, do, out, lse, dcap,
                                                       dq_b, dk_b, dv_b, scale, stream()), 10),
            bwd_call_ms=time_ms(lambda: fa._backward_cuda(q, k, v, bias, out, lse, do, scale),
                                10),
            bwd_plain_ms=time_ms(lambda: fa.flash_backward_reference(q, k, v, bias, out, lse,
                                                                     do, scale), 5),
        )
        # the library yardstick: SDPA causal, no pad mask (it takes is_causal
        # or a mask, not both); timed here only, never called by the port
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["fwd_library_ms"] = time_ms(lambda: sdpa(q, k, v, is_causal=True), 20)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o_g = sdpa(qg, kg, vg, is_causal=True)
        res["bwd_library_ms"] = time_ms(
            lambda: torch.autograd.grad(o_g, (qg, kg, vg), do, retain_graph=True), 10)
        bounds = flash_bounds(b, h, s, d, dtype, masked)
        res.update(fwd_bound=bounds["forward"], bwd_bound=bounds["backward"])
        flops = flash_flops(b, h, s, d)
        for way in ("fwd", "bwd"):
            res[f"{way}_tflops"] = flops[way] / res[f"{way}_ms"] / 1e9
            res[f"{way}_bound_share"] = res[f"{way}_bound"][0] / res[f"{way}_ms"]
        line += (f"; forward device {res['fwd_ms']:.4f} ms (CUDA graph), call "
                 f"{res['fwd_call_ms']:.4f}, plain {res['fwd_plain_ms']:.4f}, SDPA "
                 f"{res['fwd_library_ms']:.4f}, bound {bounds['forward'][0]:.4f} ms "
                 f"({bounds['forward'][1]}), {res['fwd_tflops']:.1f} TFLOP/s, "
                 f"{res['fwd_bound_share']:.3f} of the bound; backward (D, dK/dV, dQ) device "
                 f"{res['bwd_ms']:.4f} ms, call {res['bwd_call_ms']:.4f}, plain "
                 f"{res['bwd_plain_ms']:.4f}, SDPA {res['bwd_library_ms']:.4f}, bound "
                 f"{bounds['backward'][0]:.4f} ms ({bounds['backward'][1]}), "
                 f"{res['bwd_tflops']:.1f} TFLOP/s, {res['bwd_bound_share']:.3f} of the bound")
    print(line, flush=True)
    return res


def ce_inputs(dev, n, dim, vocab, dtype, seed, v_pad=None):
    """Post-LayerNorm-scale hidden states, a head kernel at tpukit's init
    scale (vocab padded to a multiple of 128 as the model pads it, or to
    `v_pad`), seeded targets with every 8th row ignored."""
    v_pad = v_pad or -(-vocab // 128) * 128
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, dim), generator=g, device=dev).to(dtype)
    bound = dim**-0.5
    w = (torch.rand((dim, v_pad), generator=g, device=dev) * 2 - 1) * bound
    tgt = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    tgt[::8] = -100
    return h, w, tgt


def ce_cotangents(dev, tgt, seed) -> dict:
    """Cotangents of (lse, target logit) for holding the CE backward, all
    O(1) and 0 on ignored rows. d = p * g_lse + onehot * g_tgt is linear in
    them, so each term is held alone as well as in the loss's mix: beside
    the target term, which is ~1e3 times larger at this vocab, a dH or dW
    without the softmax term would sit inside a row-relative bar.
      softmax: g_lse seeded randn, g_tgt 0;
      target:  g_lse 0, g_tgt seeded randn;
      loss:    the mean loss's cotangents times the count (g_lse 1,
               g_tgt -1)."""
    valid = (tgt != -100).float()
    g = torch.Generator(device=dev).manual_seed(seed)
    r1 = torch.randn(valid.shape, generator=g, device=dev) * valid
    r2 = torch.randn(valid.shape, generator=g, device=dev) * valid
    zero = torch.zeros_like(valid)
    return {"softmax": (r1, zero), "target": (zero, r2), "loss": (valid, -valid)}


def check_ce(dev, n, dim, vocab, dtype, timed=False, v_pad=None) -> dict:
    """Forward (lse, target logit, argmax) and backward (dH, dW) kernels
    against the plain version on the same inputs; the backward under each
    set of `ce_cotangents`, and once more under the loss's set, which must
    give the same bits. Negative control: under the softmax set, the
    kernel with g_lse zeroed, which is what a kernel that drops the
    p * g_lse term computes, must fail the same bar (and likewise the
    target term under the target set)."""
    h, w, tgt = ce_inputs(dev, n, dim, vocab, dtype, seed=n, v_pad=v_pad)
    terms = fce._forward_cuda(h, w, tgt, vocab, True)
    ref = fce.head_terms_reference(h, w, tgt, vocab, True)
    terms_no_argmax = fce._forward_cuda(h, w, tgt, vocab, False)
    torch.cuda.synchronize()
    tag = f"fused_head_ce N{n} dim{dim} vocab{vocab} V_pad{w.shape[1]} {str(dtype)[6:]}"
    err = hold(f"{tag} lse", terms[0], ref[0], CE_LSE_TOL, torch.float32)
    err = max(err, hold(f"{tag} target logit", terms[1], ref[1], CE_LSE_TOL, torch.float32))
    if not (torch.equal(terms_no_argmax[0], terms[0]) and torch.equal(terms_no_argmax[1],
                                                                      terms[1])):
        raise AssertionError(f"{tag}: the forward without argmax gives other lse/logits")
    # argmax: equal, or a near tie of the plain version's own logits
    logits = fce._logits(h, w, vocab)
    rows = torch.nonzero(terms[2] != ref[2])[:, 0]
    gap = (logits[rows, ref[2][rows].long()] - logits[rows, terms[2][rows].long()]).abs()
    if len(rows) and gap.max().item() > 1e-4:
        raise AssertionError(f"{tag}: argmax differs on {len(rows)} rows beyond near ties")
    del logits
    g_err, notes = 0.0, []
    cotangents = ce_cotangents(dev, tgt, seed=n + 1)
    for name, (g_lse, g_tgt) in cotangents.items():
        dh, dw = fce._backward_cuda(h, w, tgt, terms[0], g_lse, g_tgt, vocab)
        ref_dh, ref_dw = fce.head_terms_backward_reference(h, w, tgt, terms[0], g_lse, g_tgt,
                                                           vocab)
        torch.cuda.synchronize()
        e_dh = hold(f"{tag} dh ({name})", dh, ref_dh, CE_GRAD_TOL, dtype)
        e_dw = hold(f"{tag} dw ({name})", dw, ref_dw, CE_GRAD_TOL, dtype)
        g_err = max(g_err, e_dh, e_dw)
        note = (f"{name}: dh {e_dh:.3e} (largest |plain| {ref_dh.float().abs().max().item():.3e}"
                f"), dw {e_dw:.3e} ({ref_dw.abs().max().item():.3e})")
        if name in ("softmax", "target"):
            dropped = (torch.zeros_like(g_lse), g_tgt) if name == "softmax" else (
                g_lse, torch.zeros_like(g_tgt))
            bad_dh, bad_dw = fce._backward_cuda(h, w, tgt, terms[0], *dropped, vocab)
            seen = [worst_ratio(bad, good, CE_GRAD_TOL, dtype)[1]
                    for bad, good in ((bad_dh, ref_dh), (bad_dw, ref_dw))]
            if not min(seen) > 1.0:
                raise AssertionError(f"{tag}: the bar cannot see a CE backward without its "
                                     f"{name} term (err/tolerance dh {seen[0]}, dw {seen[1]})")
            note += f"; without the {name} term err/tolerance dh {seen[0]:.3e}, dw {seen[1]:.3e}"
        notes.append(note)
    g_lse, g_tgt = cotangents["loss"]  # the main path's mix, for the timings
    again = fce._backward_cuda(h, w, tgt, terms[0], g_lse, g_tgt, vocab)
    if not (torch.equal(again[0], dh) and torch.equal(again[1], dw)):
        raise AssertionError(f"{tag}: a second backward gave other bits")
    del again
    res = dict(fwd_err=err, bwd_err=g_err)
    line = (f"{tag}: forward max_abs_err {err:.3e} (argmax equal on {n - len(rows)}/{n} "
            f"rows, the rest near ties); backward max_abs_err, O(1) cotangents: "
            + "; ".join(notes))
    if timed:
        lib = _cuda.load("fused_head_ce", fce._SIGNATURES)
        stream = lambda: torch.cuda.current_stream().cuda_stream
        w_c = w.to(dtype)  # the kernels' W, rounded to h's dtype by the wrapper
        bufs = [torch.empty_like(terms[0]), torch.empty_like(terms[1]),
                torch.empty_like(terms[2])]
        dh_b, dw_b = torch.empty_like(dh), torch.empty_like(dw)
        res.update(
            fwd_ms=graph_ms(lambda: fce.launch_forward(lib, h, w_c, tgt, *bufs, vocab, False,
                                                       stream()), 5, replays=3),
            fwd_call_ms=time_ms(lambda: fce._forward_cuda(h, w, tgt, vocab, False), 5),
            fwd_argmax_ms=graph_ms(lambda: fce.launch_forward(lib, h, w_c, tgt, *bufs, vocab,
                                                              True, stream()), 5, replays=3),
            fwd_plain_ms=time_ms(lambda: fce.head_terms_reference(h, w, tgt, vocab, False), 3),
            bwd_ms=graph_ms(lambda: fce.launch_backward(lib, h, w_c, tgt, terms[0], g_lse, g_tgt,
                                                        dh_b, dw_b, vocab, stream()), 3,
                            replays=3),
            bwd_call_ms=time_ms(lambda: fce._backward_cuda(h, w, tgt, terms[0], g_lse, g_tgt,
                                                           vocab), 5),
            bwd_plain_ms=time_ms(lambda: fce.head_terms_backward_reference(
                h, w, tgt, terms[0], g_lse, g_tgt, vocab), 3),
        )
        # two PyTorch calls, not one: no single call does head + CE without
        # logits, so library_ms stays null; this is printed only
        ce = torch.nn.functional.cross_entropy
        two = time_ms(lambda: ce(torch.matmul(h, w.to(dtype)).float(), tgt.long(),
                                 ignore_index=-100), 3)
        # ... and forward + backward through autograd on the bf16 logits
        hg, wg = h.detach().requires_grad_(), w.to(dtype).detach().requires_grad_()
        unfused = time_ms(lambda: torch.autograd.grad(
            ce(torch.matmul(hg, wg), tgt.long(), ignore_index=-100, reduction="sum"),
            (hg, wg)), 3)
        res.update(unfused_ms=unfused)
        bounds = ce_bounds(n, dim, w.shape[1], dtype)
        res.update(fwd_bound=bounds["forward"], bwd_bound=bounds["backward"])
        line += (f"; forward device {res['fwd_ms']:.3f} ms (CUDA graph; "
                 f"{res['fwd_argmax_ms']:.3f} with argmax), call {res['fwd_call_ms']:.3f}, "
                 f"plain {res['fwd_plain_ms']:.3f}, bound {bounds['forward'][0]:.4f} ms "
                 f"({bounds['forward'][1]}); backward device {res['bwd_ms']:.3f} ms, call "
                 f"{res['bwd_call_ms']:.3f}, plain {res['bwd_plain_ms']:.3f}, bound "
                 f"{bounds['backward'][0]:.4f} ms ({bounds['backward'][1]}); matmul + "
                 f"F.cross_entropy (two calls, forward only) {two:.3f} ms; forward + backward "
                 f"through autograd, bf16 logits {unfused:.3f} ms")
    print(line, flush=True)
    return res


def check_training_kernels(dev) -> dict:
    """Phase 6: every training kernel against its plain version at the
    slice's shapes, bf16 and f32, with and without a pad mask, the flash
    kernels also at the recipe's S = 511 (a ragged last tile) and at S = 2048
    (several key tiles: the long-sequence gradients tpukit's split backward
    computes), at the gpt-small-dim768 rung's shapes
    (`recipes/profile.py`), and each bf16 flash instance (D = 16, 32, 64,
    128) at S = 511, 512 and 2048 with and without a pad mask. Returns the
    timed main-path runs."""
    g = GPT2_SMALL_TRAIN
    b, s, hh, d = BATCH, SEQ, g["heads"], g["head_dim"]
    main = {"flash": check_flash(dev, b, hh, s, d, torch.bfloat16, True, timed=True)}
    check_flash(dev, b, hh, s, d, torch.bfloat16, False)
    check_flash(dev, 8, hh, s, d, torch.float32, True)
    check_flash(dev, 8, hh, s, d, torch.float32, False)
    check_flash(dev, 8, hh, s - 1, d, torch.bfloat16, True)  # the recipe's S (phase 9)
    check_flash(dev, 2, hh, 2048, d, torch.bfloat16, True)
    check_flash(dev, 2, hh, 2048, d, torch.float32, True)
    # Ulysses at one rank (phase 34): S 8192 on every head; one row of its
    # batch of 4, which keeps the plain f64 backward's S x S tensors in memory
    flash_8192 = check_flash(dev, 1, hh, 8192, d, torch.bfloat16, True, timed=True)
    # every bf16 instance (head dim 16, 32, 64, 128) at S = 511, 512, 2048,
    # with and without a pad mask, at a small batch
    done = {(512, True), (512, False), (511, True), (2048, True)}  # D = 64, above
    for dd in fa.HEAD_DIMS:
        for ss in (511, 512, 2048):
            for masked in (True, False):
                if dd != d or (ss, masked) not in done:
                    check_flash(dev, 2, 6, ss, dd, torch.bfloat16, masked)
    # shapes tpukit trains that have no instance of their own (ROADMAP C1):
    # head dims 8 (the tests' tiny_config) and 48 run zero-padded to 16 and
    # 64, through the public wrapper and `auto` too; [1, 1, 32, 8] is the
    # smallest case that raised before; B * H past 65535 runs on grid x
    check_flash(dev, 1, 1, 32, 8, torch.bfloat16, False)
    for dd in (8, 48):
        for dtype in (torch.bfloat16, torch.float32):
            check_flash(dev, 2, 6, 511, dd, dtype, True)
    check_flash(dev, 4100, 16, 32, 16, torch.bfloat16, True)
    check_flash(dev, 4100, 16, 32, 16, torch.float32, False)
    main["flash_8192"] = {k: flash_8192[k] for k in ("fwd_ms", "bwd_ms", "fwd_plain_ms",
                                                      "bwd_plain_ms", "fwd_library_ms",
                                                      "bwd_library_ms", "fwd_bound",
                                                      "bwd_bound")}
    main["ce"] = check_ce(dev, b * s, g["dim"], g["vocab_size"], torch.bfloat16, timed=True)
    check_ce(dev, 4096, g["dim"], g["vocab_size"], torch.float32)
    check_ce(dev, 4000, g["dim"], g["vocab_size"], torch.bfloat16)
    # a ragged last row tile over two backward chunks; a vocab whose W is no
    # multiple of 8 columns (the wrapper pads it for TMA)
    check_ce(dev, 20000, g["dim"], g["vocab_size"], torch.bfloat16)
    check_ce(dev, 4000, g["dim"], g["vocab_size"], torch.bfloat16, v_pad=g["vocab_size"])
    # a dim that is no multiple of 8 (C1): h's columns and W's rows padded
    check_ce(dev, 4000, 100, g["vocab_size"], torch.bfloat16)
    return main


def attention_crossover(dev, seqs=(16, 32, 64, 128, 256, 384, 512, 1024),
                        tokens=BATCH * SEQ) -> dict:
    """Where `attention_impl="auto"` should switch: one attention call,
    forward and backward through autograd, by the eager "xla" path and by
    the flash kernels, at the rung's 32768 tokens per call (batch
    tokens // S), 12 heads x 64, bf16, with a pad mask of seeded trailing
    padding; mean eager-call time by CUDA events and the peak memory the
    call adds. Returns {S: {impl: (ms, peak bytes)}}."""
    g = GPT2_SMALL_TRAIN
    hh, d = g["heads"], g["head_dim"]
    table = {}
    for s in seqs:
        b = tokens // s
        q, k, v, do, mask = flash_inputs(dev, b, hh, s, d, torch.bfloat16, True, seed=s)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        row = {}
        for impl in ("xla", "flash"):
            def call():
                out = causal_attention(qg, kg, vg, scale=d**-0.5, pad_mask=mask, impl=impl)
                torch.autograd.grad(out, (qg, kg, vg), do)
            ms = time_ms(call, 10)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            row[impl] = (ms, torch.cuda.max_memory_allocated() - base)
        table[s] = row
        print(f"attention B{b} H{hh} S{s} D{d} bf16 mask, forward + backward: xla "
              f"{row['xla'][0]:.4f} ms (peak +{row['xla'][1]} B), flash {row['flash'][0]:.4f} "
              f"ms (peak +{row['flash'][1]} B), flash/xla time {row['flash'][0] / row['xla'][0]:.3f}",
              flush=True)
    faster = [s for s in seqs if all(table[t]["flash"][0] <= table[t]["xla"][0]
                                     for t in seqs if t >= s)]
    print(f"flash is at least as fast as xla from S = {faster[0]} up (of {list(seqs)}); "
          f"`auto` picks flash from FLASH_MIN_SEQ = {FLASH_MIN_SEQ}"
          if faster else f"flash is slower than xla at every S of {list(seqs)}", flush=True)
    return table


def reset_counts() -> None:
    for counts in (pa.launches, fa.launches, fce.launches, moe_gemm.launches):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return dict(**{f"paged_{k}": v for k, v in pa.launches.items()},
                **{f"flash_{k}": v for k, v in fa.launches.items()},
                **{f"ce_{k}": v for k, v in fce.launches.items()},
                **{f"moe_{k}": v for k, v in moe_gemm.launches.items()})


def ce_want(steps: int, tokens: int, cfg) -> dict:
    """The CE kernels' launches in `steps` bf16 train steps of `tokens`
    rows: the forward and its combine once a step, the backward's four
    kernels once a chunk."""
    lib = _cuda.load("fused_head_ce", fce._SIGNATURES)
    v_pad = -(-cfg.vocab_size // 128) * 128
    chunks = fce.backward_plan(lib, tokens, cfg.dim, -(-v_pad // 8) * 8)[1]
    want = {f"ce_{k}": 0 for k in fce.launches}
    want.update(ce_forward=steps, ce_forward_combine=steps,
                **{f"ce_{k}": steps * chunks for k in ("backward_d", "backward_dh",
                                                       "backward_dh_combine", "backward_dw")})
    return want


FULL_ORDER = (0, 1, 2, 3, 0, 1, 2, 3)  # batches a, b, c and the padded p, twice


def audited_step(step_fn, strategy, cfg, params, global_batch: int, seq: int) -> dict:
    """`step_fn()` under `comm_ir.record_comm` (phase 43's trace of a step a
    phase already runs): the trace, the strategy's plan, the launches."""
    before = read_counts()
    with comm_ir.record_comm() as trace:
        out = step_fn()
    after = read_counts()
    plan = train_comm_plan(strategy, cfg, params=params, global_batch=global_batch, seq=seq)
    return dict(trace=trace, plan=plan, out=out,
                counts={k: after[k] - before[k] for k in after})


def train_full_width(dev, strategy=None, order=FULL_ORDER, dropout: float = 0.0,
                     batch: int = BATCH, seq: int = SEQ, comm: dict | None = None,
                     audit: bool = False) -> dict:
    """Phase 7 (and 16, 23, 24, 30, 34): train steps of the gpt-small-dim768
    rung (batch 64, S 512, bf16; or `batch` rows of `seq` tokens, the
    position table `seq + 1` long) on synthetic batches, by default eight:
    three full batches and one with a quarter of its rows padded, each
    twice, under `strategy` (`SingleDevice` by default), with `dropout`
    after each attention and FFN block (phase 23) and the config's `comm`
    fields (`comm_dtype`, `grad_buckets`: phase 38). Checks the loss
    (finite; lower on the first batch's second visit) and the launch
    counts; returns them with the step walls, the peak device memory and
    the state; with `audit`, the comm audit (`audited_step`) of one more
    step after the timed ones, and its wall."""
    strategy = SingleDevice() if strategy is None else strategy
    shape = {} if seq == SEQ else dict(max_position_embeddings=seq + 1)
    cfg, state = build_train(dev, strategy=strategy, dropout=dropout, **shape, **(comm or {}))
    rng = np.random.RandomState(0)
    a, b, c = (to_device(*synthetic_batch(rng, cfg.vocab_size, batch, seq), dev)
               for _ in range(3))
    p = to_device(*synthetic_batch(rng, cfg.vocab_size, batch, seq, pad_rows=batch // 4), dev)
    float(train_step(state, cfg, strategy, *p))  # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for rows in ((a, b, c, p)[i] for i in order):
        t0 = time.perf_counter()
        losses.append(float(train_step(state, cfg, strategy, *rows)))  # syncs
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps, layers = len(losses), cfg.num_layers
    wall = float(np.mean(walls))
    label = strategy.name + "".join(f" {k} {v}" for k, v in (comm or {}).items())
    print(f"{label}: losses {[round(x, 4) for x in losses]}; step walls (s) "
          f"{[round(w, 4) for w in walls]}; mean {wall:.4f} s, {batch * seq / wall:.1f} "
          f"tokens/s; max_memory_allocated {peak} B")
    print(f"launches in {steps} steps: {counts}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    again = order.index(order[0], 1)
    if not losses[again] < losses[0]:
        raise AssertionError(f"the loss on a repeated batch did not fall: {losses[0]} -> "
                             f"{losses[again]}")
    # the pipeline runs each layer once a micro-batch, and its head is the
    # vocab-parallel CE (tpukit's jnp head), so no CE kernel; the ring's
    # hops are plain PyTorch, so no flash kernel
    calls = layers * steps * (strategy.num_microbatches if isinstance(strategy, Pipeline) else 1)
    if isinstance(strategy, ContextParallel) and strategy.attention == "ring":
        calls = 0
    ce = (ce_want(steps, batch * seq, cfg) if strategy.fused_head
          else {f"ce_{k}": 0 for k in fce.launches})
    want = dict(**{f"paged_{k}": 0 for k in pa.launches}, flash_forward=calls,
                flash_backward_dcap=calls, flash_backward_dkv=calls, flash_backward_dq=calls,
                **ce, **{f"moe_{k}": 0 for k in moe_gemm.launches})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    audited = None
    if audit:  # one more step on batch a, under the comm audit's recorder (phase 43)
        t0 = time.perf_counter()
        audited = audited_step(lambda: float(train_step(state, cfg, strategy, *a)), strategy,
                               cfg, state.params, batch, seq)
        audited["wall"] = time.perf_counter() - t0
        audited["timed_wall"] = wall
    return dict(counts=counts, wall=wall, losses=losses, peak=peak, state=state,
                audit=audited)


PLAIN_STEPS = 2  # phases 8, 12 and 23: steps through the kernels against the plain versions


def kernel_vs_plain_steps(dev, dropout: float = 0.0) -> None:
    """Phase 8 (and 23, with `dropout`): the train step through the kernels
    (CUDA) against the same step through the plain versions (the CPU), f32,
    2 layers at GPT-2-small width, flash attention forced, batch 4 with a
    padded row, PLAIN_STEPS steps from the same parameters on the same
    batches (and the same dropout keys: the masks are threefry bits, the
    same on both devices). Losses within rtol 1e-4: f32 on both sides,
    summation order only, carried through the AdamW steps."""
    cpu = torch.device("cpu")
    cfg, cpu_state = build_train(cpu, num_layers=2, compute_dtype=torch.float32,
                                 attention_impl="flash", seed=1, dropout=dropout)
    params = cpu_state.params
    dev_state = create_train_state(
        unflatten(params, [t.detach().to(dev, copy=True) for t in leaves(params)]), 1e-4)
    rng = np.random.RandomState(1)
    batches = [synthetic_batch(rng, cfg.vocab_size, 4, SEQ, pad_rows=1)
               for _ in range(PLAIN_STEPS)]
    strategy = SingleDevice()
    reset_counts()
    ours, plain = [], []
    for batch in batches:
        ours.append(float(train_step(dev_state, cfg, strategy, *to_device(*batch, dev))))
        plain.append(float(train_step(cpu_state, cfg, strategy, *to_device(*batch, cpu))))
    counts = read_counts()
    worst = max(abs(a - b) / abs(b) for a, b in zip(ours, plain))
    print(f"dropout {dropout}: kernels {ours} vs plain {plain}: worst relative difference "
          f"{worst:.3e} (bar 1e-4); launches {counts}", flush=True)
    if (counts["flash_forward"] != 2 * PLAIN_STEPS
            or counts["ce_backward_dh_f32"] != PLAIN_STEPS):
        raise AssertionError(f"the CUDA steps did not run the kernels: {counts}")
    if not worst <= 1e-4:
        raise AssertionError(f"kernel and plain train steps disagree: {ours} vs {plain}")


RECIPE_ARGV = ["--dim", "768", "--head_dim", "64", "--heads", "12", "--num_layers", "12",
               "--sequence_length", "512", "--batch_size", "64", "--epochs", "1",
               "--dataset_slice", "576", "--device", "cuda"]  # phase 9's recipe 1


def recipe_end_to_end(dev, recipe=single, label: str = "recipe",
                      kernels=("flash_", "ce_"), extra=(), metrics_log: str | None = None) -> dict:
    """Phase 9 (and 18, 26, 32, 36): `python -m tpukit_torch.recipes.single`
    (or the `recipe` module given, with the `extra` flags; `kernels` the
    launch counters that must have moved) at GPT-2-small width on 576
    fixture stories (9 steps of 64), 1 epoch, bf16, in build/chip_smoke/
    (another recipe in build/chip_smoke_<module>[_<extra flags' values>]/). `--sequence_length 512`: the recipe trains on
    S - 1 positions (prepare_batch's shift), so S = 511 (a ragged last key
    tile) is in front of the attention, where "auto" picks the flash
    kernels. Checks that the flash and CE kernels ran, the eval metrics
    are finite, three samples came back (decoded on the ring, as tpukit's
    recipes decode them), and the checkpoint restores."""
    name = "_".join([recipe.__name__.rsplit(".", 1)[1], *extra[1::2]])
    work = ROOT / "build" / ("chip_smoke" if recipe is single else f"chip_smoke_{name}")
    work.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_counts()
        t0 = time.perf_counter()
        log = ["--metrics_log", metrics_log] if metrics_log else []
        if metrics_log:
            Path(metrics_log).unlink(missing_ok=True)
        result = recipe.main(RECIPE_ARGV + list(extra) + log)
        wall = time.perf_counter() - t0
        counts = read_counts()
        restored = _restores_exactly(result, dev)
    finally:
        os.chdir(cwd)
    print(f"{label}: {wall:.1f} s, windows {result.metrics['train_windows']}, eval "
          f"{result.metrics['eval']}, {len(result.metrics['samples'])} "
          f"samples, {result.metrics['tokens_per_sec']:.1f} train tokens/s, checkpoint "
          f"{result.checkpoint_path}; launches {counts}", flush=True)
    # the samples decode on the ring (`sampling.generate_batch`), as
    # tpukit's do: the paged kernels run in phases 4 and 20
    if min(v for k, v in counts.items() if k.startswith(kernels) and
           not k.endswith("_f32")) == 0:
        raise AssertionError(f"a kernel of the recipe's path never ran: {counts}")
    if not np.isfinite(result.metrics["eval"]["loss"]) or len(result.metrics["samples"]) != 3:
        raise AssertionError(f"recipe output: {result.metrics}")
    if not restored:
        raise AssertionError(f"checkpoint {result.checkpoint_path} did not restore exactly")
    return counts


def _free() -> None:
    """Collect what the caller dropped and return the cached device memory,
    so that one strategy's state is gone before the next one's peak."""
    gc.collect()
    torch.cuda.empty_cache()


OFFLOAD_ORDER = (0, 3, 0)  # batch a, the padded p, a again


def dp_full_width(dev, single_run: dict) -> dict:
    """Phase 16: phase 7's steps under `DataParallel` and `FSDP` (8 steps
    each) and `FSDP(cpu_offload=True)` (3), in the world of one `main`
    brought up, each checked as phase 7 checks its own. Offload: every
    sharded parameter and both AdamW moments must be in host memory, and
    the peak device memory below plain FSDP's."""
    runs = {}
    for label, make, order in (("ddp", DataParallel, FULL_ORDER), ("fsdp", FSDP, FULL_ORDER),
                               ("fsdp-offload", lambda: FSDP(cpu_offload=True), OFFLOAD_ORDER)):
        strategy = make()
        run = train_full_width(dev, strategy, order)
        state = run.pop("state")
        if strategy.name == "fsdp-offload":
            local = lambda t: t.to_local() if isinstance(t, DTensor) else t
            where = {local(p).device.type for p in leaves(state.params)}
            where |= {local(st[k]).device.type for st in state.optimizer.state.values()
                      for k in ("exp_avg", "exp_avg_sq")}
            print(f"offload: parameters and AdamW moments on {sorted(where)}; "
                  f"{len(strategy.replicated)} leaves replicated", flush=True)
            if where != {"cpu"}:
                raise AssertionError(f"offloaded state is not all in host memory: {where}")
        runs[label] = run
        del state, strategy
        _free()
    for label, run in runs.items():
        print(f"{label}: {run['wall']:.4f} s a step ({single_run['wall']:.4f} single, "
              f"{run['wall'] / single_run['wall']:.4f}x), {BATCH * SEQ / run['wall']:.1f} "
              f"tokens/s, peak {run['peak']} B ({single_run['peak']} single)", flush=True)
    if not runs["fsdp-offload"]["peak"] < runs["fsdp"]["peak"]:
        raise AssertionError(f"offload's peak device memory {runs['fsdp-offload']['peak']} is "
                             f"not below plain FSDP's {runs['fsdp']['peak']}")
    return runs


def dp_equals_single(dev) -> None:
    """Phase 17: phase 8's setup (f32, 2 layers at GPT-2-small width,
    flash forced, batch 4 with a padded row, 4 AdamW steps) from the same
    parameters under `SingleDevice`, `DataParallel` and `FSDP` in a world
    of one: losses within phase 8's rtol 1e-4 of `SingleDevice`'s and the
    parameters after the last step bit-equal to its own (one rank reduces
    nothing, and the step is the same sequence of kernels); prints whether
    the losses are bit-equal too."""
    cfg, base = build_train(dev, num_layers=2, compute_dtype=torch.float32,
                            attention_impl="flash", seed=1)
    rng = np.random.RandomState(1)
    batches = [to_device(*synthetic_batch(rng, cfg.vocab_size, 4, SEQ, pad_rows=1), dev)
               for _ in range(4)]
    runs = {}
    for make in (SingleDevice, DataParallel, FSDP):
        strategy = make()
        params = unflatten(base.params, [t.detach().clone() for t in leaves(base.params)])
        state = create_train_state(params, 1e-4, strategy)
        losses = [float(train_step(state, cfg, strategy, *b)) for b in batches]
        runs[strategy.name] = (losses, [gather_full(p).detach() for p in leaves(state.params)])
        del params, state, strategy
        _free()
    ref, ref_params = runs.pop("single")
    for name, (losses, params) in runs.items():
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        equal = [torch.equal(a, b) for a, b in zip(params, ref_params)]
        print(f"{name}: losses {losses} vs single {ref}: worst relative difference "
              f"{worst:.3e} (bar 1e-4); bit-equal losses {losses == ref}, parameters "
              f"{sum(equal)} of {len(equal)} leaves", flush=True)
        if not worst <= 1e-4:
            raise AssertionError(f"{name} and single-device steps disagree: {losses} vs {ref}")
        if not all(equal):
            raise AssertionError(f"{name}: {len(equal) - sum(equal)} of {len(equal)} parameter "
                                 f"leaves differ from the single-device step's")


def pipeline_full_width(dev, single_run: dict) -> dict:
    """Phase 24: phase 7's steps under `Pipeline` (GPipe) and
    `Pipeline1F1B`, M = 4, in the world of one `main` brought up (one
    stage: the whole stack and vocab on this card, the head the
    vocab-parallel CE over a group of one), 8 steps each, each checked as
    phase 7 checks its own (the loss falls on a repeated batch; the flash
    kernels launch 12 x M times a step each, the CE kernels not at all);
    step wall, tokens/s and peak device memory beside phase 7's."""
    runs = {}
    for make in (Pipeline, Pipeline1F1B):
        strategy = make(num_microbatches=PIPE_MICRO)
        run = train_full_width(dev, strategy)
        del run["state"]
        runs[strategy.name] = run
        del strategy
        _free()
    for label, run in runs.items():
        steps = len(run["losses"])
        print(f"{label}: {run['wall']:.4f} s a step ({single_run['wall']:.4f} single, "
              f"{run['wall'] / single_run['wall']:.4f}x), {BATCH * SEQ / run['wall']:.1f} "
              f"tokens/s, peak {run['peak']} B ({single_run['peak']} single, "
              f"{run['peak'] / single_run['peak']:.4f}x); flash launches a step: forward "
              f"{run['counts']['flash_forward'] // steps}, dcap "
              f"{run['counts']['flash_backward_dcap'] // steps}, dkv "
              f"{run['counts']['flash_backward_dkv'] // steps}, dq "
              f"{run['counts']['flash_backward_dq'] // steps}", flush=True)
    return runs


def pipeline_equals_single(dev) -> None:
    """Phase 25: phase 8's setup (f32, 2 layers at GPT-2-small width,
    flash forced, batch 4 with a padded row, 4 AdamW steps) from the same
    parameters under `SingleDevice`, `Pipeline` and `Pipeline1F1B` (M = 4:
    one row a micro-batch) on the card, and under `SingleDevice` through
    the plain versions on the CPU (phase 8's plain step): each pipeline's
    losses within rtol 1e-4 of the card's `SingleDevice` losses and of the
    plain ones, and its steps through the flash kernels."""
    cpu = torch.device("cpu")
    cfg, plain_state = build_train(cpu, num_layers=2, compute_dtype=torch.float32,
                                   attention_impl="flash", seed=1)
    base = [t.detach().clone() for t in leaves(plain_state.params)]
    rng = np.random.RandomState(1)
    batches = [synthetic_batch(rng, cfg.vocab_size, 4, SEQ, pad_rows=1) for _ in range(4)]
    plain = [float(train_step(plain_state, cfg, SingleDevice(), *to_device(*b, cpu)))
             for b in batches]
    runs = {}
    for make in (SingleDevice, lambda: Pipeline(num_microbatches=PIPE_MICRO),
                 lambda: Pipeline1F1B(num_microbatches=PIPE_MICRO)):
        strategy = make()
        params = unflatten(plain_state.params, [t.to(dev, copy=True) for t in base])
        state = create_train_state(params, 1e-4, strategy, cfg)
        reset_counts()
        runs[strategy.name] = ([float(train_step(state, cfg, strategy, *to_device(*b, dev)))
                                for b in batches], read_counts()["flash_forward"])
        del params, state, strategy
        _free()
    ref, _ = runs.pop("single")
    for name, (losses, flash) in runs.items():
        worst = max(max(abs(a - b) / abs(b) for a, b in zip(losses, ref)),
                    max(abs(a - b) / abs(b) for a, b in zip(losses, plain)))
        print(f"{name}: losses {losses} vs single {ref} vs plain {plain}: worst relative "
              f"difference {worst:.3e} (bar 1e-4); bit-equal to single {losses == ref}; "
              f"flash forward launches {flash}", flush=True)
        if not worst <= 1e-4:
            raise AssertionError(f"{name} and single-device steps disagree: {losses} vs {ref}")
        if flash != 2 * PIPE_MICRO * len(batches):
            raise AssertionError(f"{name}: the flash forward launched {flash} times")


def serve_run(params, cfg, serve, reqs, dev, eos_id, **draft):
    engine = ServeEngine(params, cfg, serve, eos_id=eos_id, device=dev, **draft)
    comps = engine.run(list(reqs))
    torch.cuda.synchronize()
    return engine, {c.rid: np.asarray(c.ids) for c in comps}


def check_outputs(outs, reqs, cfg) -> None:
    assert sorted(outs) == [r.rid for r in reqs], "not every request completed"
    for r in reqs:
        ids = outs[r.rid]
        gen = len(ids) - len(r.ids)
        assert 0 <= gen <= r.max_new_tokens, (r.rid, gen)
        assert np.array_equal(ids[: len(r.ids)], r.ids), r.rid
        assert ((ids >= 0) & (ids < cfg.vocab_size)).all(), r.rid


def agreement(a: dict, b: dict) -> float:
    """tpukit's int8 gate (tests/test_paged.py): per request, the share of
    positions (prompt included) where the two token streams agree, over
    their common length; averaged over requests."""
    return float(np.mean([np.mean(a[r][: min(len(a[r]), len(b[r]))]
                                  == b[r][: min(len(a[r]), len(b[r]))]) for r in a]))


def moe_bank(dev, e, d, f, dtype, seed):
    """An expert bank (Wu, bu, Wd, bd) at tpukit's init scale, U(+-1 /
    sqrt(fan_in)), from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda shape, fan_in: ((torch.rand(shape, generator=g, device=dev) * 2 - 1)
                               * fan_in**-0.5).to(dtype)
    return u((e, d, f), d), u((e, f), d), u((e, f, d), f), u((e, d), f)


def moe_layouts(dev) -> dict:
    """name -> (rows f32 [M, 768] on the card, offsets [9] int32, real rows
    n), rows N(0, 1) from a seed:
      equal:       recipe 8's capacity buffer on one device: 8 experts x
                   batch 32 x capacity 80, 2560 rows each (M 20480);
      top1, top2:  `sort_plan` of the top-k routing of seeded [32, 512, 768]
                   tokens by a seeded router at init scale (M 16384, 32768);
      adversarial: segments of 3000, 0, 1, 129, 2047, 130, 1 and 4691 rows
                   (an empty expert, 1-row segments, segments across row
                   tiles) and a padding tail of 241 rows in the last one;
      decode:      `sort_plan` of the top-1 routing of the first 16 of
                   those tokens (M 16): one tick of MoE serving's 16 slots,
                   which the forward runs under its decode policy."""
    g = torch.Generator(device=dev).manual_seed(10)
    d, e = GPT2_SMALL_TRAIN["dim"], MOE_ROUTED["experts"]
    rows = lambda m: torch.randn((m, d), generator=g, device=dev)
    out = {}
    m = e * MOE_ROUTED["batch"] * 80
    offs = torch.arange(e + 1, dtype=torch.int32, device=dev) * (m // e)
    out["equal"] = (rows(m), offs, m)
    x = torch.randn((MOE_ROUTED["batch"], MOE_ROUTED["seq"], d), generator=g, device=dev)
    router = (torch.rand((d, e), generator=g, device=dev) * 2 - 1) * d**-0.5
    for k in (1, 2):
        cfg = GPTConfig(dim=d, head_dim=64, heads=12, num_layers=1, num_experts=e,
                        router_top_k=k, max_position_embeddings=MOE_ROUTED["seq"],
                        moe_dispatch="pallas")
        _, top_idx, _, _, _ = _route_topk(x, router, cfg)
        src, _, offs = moe_gemm.sort_plan(cfg, top_idx)
        out[f"top{k}"] = (x.reshape(-1, d).index_select(0, src), offs, top_idx.numel())
    sizes = MOE_ADVERSARIAL
    n = sum(sizes)
    m = moe_gemm.plan_rows(n)[1]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    offs[-1] = m
    out["adversarial"] = (rows(m), torch.from_numpy(offs).to(dev), n)
    cfg = GPTConfig(dim=d, head_dim=64, heads=12, num_layers=1, num_experts=e, router_top_k=1,
                    max_position_embeddings=MOE_ROUTED["seq"], moe_dispatch="pallas")
    tick = x[:1, :MOE_DECODE_ROWS]
    _, top_idx, _, _, _ = _route_topk(tick, router, cfg)
    src, _, offs = moe_gemm.sort_plan(cfg, top_idx)
    out["decode"] = (tick.reshape(-1, d).index_select(0, src), offs, top_idx.numel())
    return out


def moe_bounds(offsets, m, d, f, dtype) -> dict:
    """Least times of the forward (rows and the bank of every expert with
    rows in, y out; 2 products over the M rows) and of the backward (rows,
    g, y and the kept h in, the bank read; dx out in the compute dtype,
    dW and db of all E experts out in f32; 4 products)."""
    it = torch.tensor([], dtype=dtype).element_size()
    o = offsets.tolist()
    e = len(o) - 1
    used = sum(1 for i in range(e) if o[i + 1] > o[i])
    bank = used * (2 * d * f + f + d) * it
    prod = 2 * m * d * f
    fwd = _bound(2 * m * d * it + bank + 4 * (e + 1), 2 * prod, dtype)
    bwd = _bound(4 * m * d * it + m * f * it + bank + e * (2 * d * f + f + d) * 4 + 4 * (e + 1),
                 4 * prod, dtype)
    return dict(forward=fwd, backward=bwd)


def decode_units(lib, offsets, m, d, f) -> dict:
    """The work units of each forward product under the plan the wrapper
    picks for M rows: row tiles of the layout (64 rows under the decode
    policy, else 128) x 256-column tiles x k splits."""
    small, split_up, split_down, _ = moe_gemm.forward_plan(lib, torch.bfloat16, m, d, f,
                                                           len(offsets) - 1)
    bm = 64 if small else 128
    o = offsets.tolist()
    tiles = sum(-(-(o[i + 1] - o[i]) // bm) for i in range(len(o) - 1))
    return dict(policy="decode" if small else "training", row_tiles=tiles,
                up=tiles * -(-f // 256) * split_up, down=tiles * -(-d // 256) * split_down,
                split_up=split_up, split_down=split_down)


def grouped_mm_ms(xs, wu, wd, offsets, h, cot) -> dict:
    """The library yardstick, products only: `torch._grouped_mm` (where this
    torch has it) for the forward's 2 products (x Wu[e], h Wd[e]) and the
    backward's 4 (dz2 Wd[e]^T, dz1 Wu[e]^T, x^T dz1, h^T dz2) on the same
    segments, with no bias, relu, mask or rounding of ours; timed only,
    never on the port's path. None where the call is missing or refuses
    these operands."""
    gmm = getattr(torch, "_grouped_mm", None)
    if gmm is None:
        return dict(fwd=None, bwd=None, note="torch._grouped_mm is not in this torch")
    offs = offsets[1:].contiguous()
    dz = cot  # stands in for dz2 and (sliced) dz1: the products' time does not read values
    dz1 = torch.zeros_like(h)
    try:
        fwd = time_ms(lambda: (gmm(xs, wu, offs=offs), gmm(h, wd, offs=offs)), 20)
        bwd = time_ms(lambda: (gmm(dz, wd.transpose(-2, -1), offs=offs),
                               gmm(dz1, wu.transpose(-2, -1), offs=offs),
                               gmm(xs.t(), dz1, offs=offs), gmm(h.t(), dz, offs=offs)), 10)
    except (RuntimeError, TypeError, ValueError) as exc:
        return dict(fwd=None, bwd=None, note=f"torch._grouped_mm refused: {exc}"[:200])
    return dict(fwd=fwd, bwd=bwd, note="torch._grouped_mm, products only")


def check_moe(dev, name, rows, offsets, n, dtype, timed=False, dims=None,
              experts: int | None = None) -> dict:
    """Forward (y) and backward (dx, dWu, dbu, dWd, dbd) kernels against the
    plain versions on the same inputs: the backward under O(1) seeded
    cotangents (0 on the padding rows; the mean loss's would be ~1/count)
    and the kernel's y and kept h on both sides. Padding rows get exactly 0 dx, empty
    experts exactly 0 gradients. Negative controls: the plain backward
    without the relu mask on dz1 must fail the bar on dx, dWu and dbu, and
    (bf16) with dbu summed from the rounded dz1 on dbu. With `timed`, device,
    call and plain times and the bounds too. `dims`: (D, F) in place of the
    rung's (768, 3072); `experts`: a bank of that many experts in place of
    the rung's 8 (a rank's share under expert parallelism)."""
    e = experts or MOE_ROUTED["experts"]
    d, f = dims or (GPT2_SMALL_TRAIN["dim"], 4 * GPT2_SMALL_TRAIN["dim"])
    wu, bu, wd, bd = moe_bank(dev, e, d, f, dtype, seed=len(name))
    xs = rows.to(dtype)
    m = xs.shape[0]
    g = torch.Generator(device=dev).manual_seed(m + len(name))
    cot = torch.randn((m, d), generator=g, device=dev)
    cot[n:] = 0.0
    cot = cot.to(dtype)
    ys, h = moe_gemm._forward_cuda(xs, wu, bu, wd, bd, offsets)
    ref_y = moe_gemm.grouped_ffn_reference(xs, wu, bu, wd, bd, offsets)
    grads = moe_gemm._backward_cuda(xs, cot, ys, h, wu, wd, offsets)
    # the same inputs as the kernels: y and the kept h (a relu mask on an
    # f32 h recomputed within summation noise of 0 would flip one side only)
    refs = moe_gemm.grouped_ffn_backward_reference(xs, cot, ys, wu, bu, wd, offsets, h=h)
    torch.cuda.synchronize()
    tag = f"grouped_ffn {name} M{m} D{d} F{f} {str(dtype)[6:]}"
    bar = lambda nm: dtype if nm in MOE_ROUNDED else torch.float32  # noqa: E731
    err = hold(f"{tag} y", ys, ref_y, MOE_TOL, bar("y"))
    names = ("dx", "dwu", "dbu", "dwd", "dbd")
    g_err = max(hold(f"{tag} {nm}", got, ref, MOE_TOL, bar(nm))
                for nm, got, ref in zip(names, grads, refs))
    if not (grads[0][n:] == 0).all():
        raise AssertionError(f"{tag}: padding rows got a nonzero dx")
    o = offsets.tolist()
    empty = [i for i in range(e) if o[i + 1] == o[i]]
    if any((t[i] != 0).any() for t in grads[1:] for i in empty):
        raise AssertionError(f"{tag}: an empty expert got a nonzero gradient")
    # an h of ones: the plain backward with no relu mask on dz1 (its dWd,
    # from that h, is not compared)
    bad = moe_gemm.grouped_ffn_backward_reference(xs, cot, ys, wu, bu, wd, offsets,
                                                  h=torch.ones_like(h))[:3]
    seen = [worst_ratio(b, r, MOE_TOL, bar(nm))[1] for nm, b, r in zip(names, bad, refs)]
    if not min(seen) > 1.0:
        raise AssertionError(f"{tag}: the bar cannot see a backward without the relu mask on "
                             f"dz1 (err/tolerance dx, dwu, dbu {seen})")
    note = (f"without the dz1 relu mask err/tolerance dx {seen[0]:.3e}, dwu {seen[1]:.3e}, "
            f"dbu {seen[2]:.3e}")
    if dtype == torch.bfloat16:
        rounded = torch.zeros_like(refs[2])
        for i, s, t in moe_gemm._segments(offsets, e):
            dz2 = torch.where(ys[s:t] > 0, cot[s:t].float(), 0.0).to(dtype).float()
            dz1 = torch.where(h[s:t] > 0, dz2 @ wd[i].float().t(), 0.0)
            rounded[i] = dz1.to(dtype).float().sum(0)  # dbu from the rounded dz1
        seen_r = worst_ratio(rounded, refs[2], MOE_TOL, torch.float32)[1]
        if not seen_r > 1.0:
            raise AssertionError(f"{tag}: the bar cannot see a dbu summed from the rounded dz1 "
                                 f"(err/tolerance {seen_r})")
        note += f"; dbu from the rounded dz1 {seen_r:.3e}"
    counts = [o[i + 1] - o[i] for i in range(e)]
    top = ", ".join(f"{nm} {t.float().abs().max().item():.3e}"
                    for nm, t in zip(("y",) + names, (ref_y,) + tuple(refs)))
    line = (f"{tag} (segments {counts}, {m - n} padding rows): forward max_abs_err {err:.3e}, "
            f"backward {g_err:.3e} (largest |plain| {top}); {note}")
    res = dict(fwd_err=err, bwd_err=g_err)
    if timed:
        lib = _cuda.load("moe_gemm", moe_gemm._SIGNATURES)
        stream = lambda: torch.cuda.current_stream().cuda_stream
        y_b, h_b = torch.empty_like(ys), torch.empty_like(h)
        scratch = moe_gemm.backward_scratch(lib, xs, f, e)
        dx_b = torch.empty_like(xs)
        dw_b = [torch.empty_like(t) for t in grads[1:]]
        res.update(
            fwd_ms=graph_ms(lambda: moe_gemm.launch_forward(lib, xs, wu, bu, wd, bd, offsets, h_b,
                                                            y_b, stream()), 20),
            fwd_call_ms=time_ms(lambda: moe_gemm._forward_cuda(xs, wu, bu, wd, bd, offsets), 20),
            fwd_plain_ms=time_ms(lambda: moe_gemm.grouped_ffn_reference(xs, wu, bu, wd, bd,
                                                                        offsets), 5),
            bwd_ms=graph_ms(lambda: moe_gemm.launch_backward(lib, xs, cot, ys, h, wu, wd, offsets,
                                                             scratch, dx_b, *dw_b, stream()),
                            10),
            bwd_call_ms=time_ms(lambda: moe_gemm._backward_cuda(xs, cot, ys, h, wu, wd, offsets),
                                10),
            bwd_plain_ms=time_ms(lambda: moe_gemm.grouped_ffn_backward_reference(
                xs, cot, ys, wu, bu, wd, offsets, h=h), 3),
        )
        bounds = moe_bounds(offsets, m, d, f, dtype)
        res.update(fwd_bound=bounds["forward"], bwd_bound=bounds["backward"])
        units = decode_units(lib, offsets, m, d, f)
        lib_ms = grouped_mm_ms(xs, wu, wd, offsets, h, cot)
        res.update(units=units, fwd_library_products_ms=lib_ms["fwd"],
                   bwd_library_products_ms=lib_ms["bwd"])
        fmt = lambda t: "n/a" if t is None else f"{t:.4f}"  # noqa: E731
        line += (f"; forward ({units['policy']} policy: {units['row_tiles']} row tiles, "
                 f"{units['up']} up and {units['down']} down units, k splits "
                 f"{units['split_up']}/{units['split_down']}) device {res['fwd_ms']:.4f} ms "
                 f"(CUDA graph), call {res['fwd_call_ms']:.4f}, plain "
                 f"{res['fwd_plain_ms']:.4f}, bound {bounds['forward'][0]:.4f} ms "
                 f"({bounds['forward'][1]}); backward device {res['bwd_ms']:.4f} ms, call "
                 f"{res['bwd_call_ms']:.4f}, plain {res['bwd_plain_ms']:.4f}, bound "
                 f"{bounds['backward'][0]:.4f} ms ({bounds['backward'][1]}); library: none "
                 f"computes the grouped FFN; {lib_ms['note']}: forward "
                 f"{fmt(lib_ms['fwd'])} ms, backward {fmt(lib_ms['bwd'])} ms")
    print(line, flush=True)
    return res


def check_moe_kernels(dev) -> dict:
    """Phase 10: the grouped-expert kernels against their plain versions on
    every layout of `moe_layouts`, bf16 and f32; times on the recipe's
    equal segments in bf16 (the main path), on the top-1 routing's and on
    the decode tick's, where at least one unit an SM must stream the bank
    in each forward product; the adversarial layout also at D 100, F 400;
    a rank's bank under expert parallelism (`EP_LOCAL_EXPERTS`, 20480 rows),
    timed in bf16. Returns the timed runs."""
    timed_runs = {}
    for name, (rows, offsets, n) in moe_layouts(dev).items():
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16 and name in ("equal", "top1", "decode")
            res = check_moe(dev, name, rows, offsets, n, dtype, timed=timed)
            if timed:
                timed_runs[name] = res
    # D and F that are no multiple of 8: bf16 runs on zero-padded copies
    rows, offsets, n = moe_layouts(dev)["adversarial"]
    for dtype in (torch.bfloat16, torch.float32):
        check_moe(dev, "adversarial", rows[:, :100].contiguous(), offsets, n, dtype,
                  dims=(100, 400))
    # a rank's bank after the exchange under expert parallelism at the e8
    # rung (batch 32 a rank, capacity 80): E_local 2 experts x 10240 rows at
    # (data 1, expert 4), 4 x 5120 at (2, 2); 20480 rows either way
    g = torch.Generator(device=dev).manual_seed(14)
    m = MOE_ROUTED["experts"] * MOE_ROUTED["batch"] * 80
    for e_local in EP_LOCAL_EXPERTS:
        rows = torch.randn((m, GPT2_SMALL_TRAIN["dim"]), generator=g, device=dev)
        offsets = torch.arange(e_local + 1, dtype=torch.int32, device=dev) * (m // e_local)
        for dtype in (torch.bfloat16, torch.float32):
            res = check_moe(dev, f"ep_local{e_local}", rows, offsets, m, dtype,
                            timed=dtype == torch.bfloat16, experts=e_local)
            if dtype == torch.bfloat16:
                timed_runs[f"ep_local{e_local}"] = res
    units, sms = timed_runs["decode"]["units"], torch.cuda.get_device_properties(0).multi_processor_count
    if units["policy"] != "decode" or min(units["up"], units["down"]) < sms:
        raise AssertionError(f"the decode tick's forward does not stream the bank on {sms} SMs: "
                             f"{units}")
    return timed_runs


def moe_train_full_width(dev) -> dict:
    """Phase 11: eight train steps of the gpt-small-dim768-e8 rung (batch 32,
    S 512, bf16, 8 experts top-1, ExpertParallel 1 x 1, pallas dispatch) on
    synthetic batches: three full ones and one with 8 padded rows, each
    twice. Checks the loss (finite; lower on batch A's second visit) and the
    launch counts; returns them with the step walls and peak memory."""
    rows, moe, kind = RUNGS["gpt-small-dim768-e8"]
    cfg, state = build_train(dev, **moe)
    rng = np.random.RandomState(0)
    a, b, c = (to_device(*synthetic_batch(rng, cfg.vocab_size, rows, SEQ), dev)
               for _ in range(3))
    p = to_device(*synthetic_batch(rng, cfg.vocab_size, rows, SEQ, pad_rows=8), dev)
    strategy = rung_strategy(kind)
    # warm-up (cuBLAS, the allocator), phase 43's trace of the e8 step under EP
    audit = audited_step(lambda: float(train_step(state, cfg, strategy, *p)), strategy, cfg,
                         state.params, rows, SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for batch in (a, b, c, p, a, b, c, p):
        t0 = time.perf_counter()
        losses.append(float(train_step(state, cfg, strategy, *batch)))  # syncs
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    steps, layers = len(losses), cfg.num_layers
    wall = float(np.mean(walls))
    peak = torch.cuda.max_memory_allocated()
    print(f"losses {[round(x, 4) for x in losses]}; step walls (s) "
          f"{[round(w, 4) for w in walls]}; mean {wall:.4f} s, {rows * SEQ / wall:.1f} "
          f"tokens/s; max_memory_allocated {peak} B")
    print(f"launches in {steps} steps: {counts}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[4] < losses[0]:
        raise AssertionError(f"the loss on a repeated batch did not fall: {losses[0]} -> "
                             f"{losses[4]}")
    want = dict(**{f"paged_{k}": 0 for k in pa.launches}, flash_forward=layers * steps,
                flash_backward_dcap=layers * steps,
                flash_backward_dkv=layers * steps, flash_backward_dq=layers * steps,
                **ce_want(steps, rows * SEQ, cfg), **{f"moe_{k}": 0 for k in moe_gemm.launches})
    want.update({f"moe_{k}": layers * steps for k in MOE_TRAIN_KERNELS})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return dict(counts=counts, wall=wall, losses=losses, peak=peak, audit=audit)


def moe_kernel_vs_plain_steps(dev) -> None:
    """Phase 12: the MoE train step through the kernels (CUDA) against the
    same step through the plain versions (the CPU): f32, 2 layers at
    GPT-2-small width, 8 experts top-2, flash attention forced, batch 2 with
    a padded row, PLAIN_STEPS steps from the same parameters on the same batches; on
    ExpertParallel 1 x 1 with the pallas dispatch and on the meshless
    dropless path. First every gradient leaf of the first batch, router
    and experts included, at the starting parameters: |kernel - plain| /
    |plain| within 1e-3 over each leaf (Frobenius norms). The bar is on the
    leaf's norm, not per element: a relu input within f32 summation noise
    of 0 falls on opposite sides of the mask on the two sides and moves a
    whole dz1 element, so a few elements of the expert and norm gradients
    lie far apart, while a mis-wired gradient moves the norm by O(1). Held
    on the gradients, not on the parameters after the steps: AdamW's first
    steps move an element by about +-lr whatever the size of its gradient,
    so one near-zero gradient of another sign would leave 2 lr between the
    two. Then the losses of the steps within rtol 1e-4 (f32, summation
    order, through the AdamW steps)."""
    cpu = torch.device("cpu")
    for label, strategy, kw in (("ExpertParallel 1x1 pallas", ExpertParallel(dispatch="pallas"),
                                 {}),
                                ("dropless pallas", SingleDevice(), dict(moe_dispatch="pallas"))):
        cfg, cpu_state = build_train(cpu, num_layers=2, compute_dtype=torch.float32,
                                     attention_impl="flash", seed=2, num_experts=8,
                                     router_top_k=2, **kw)
        params = cpu_state.params
        dev_state = create_train_state(
            unflatten(params, [t.detach().to(dev, copy=True) for t in leaves(params)]), 1e-4)
        rng = np.random.RandomState(2)
        batches = [synthetic_batch(rng, cfg.vocab_size, 2, SEQ, pad_rows=1)
                   for _ in range(PLAIN_STEPS)]
        grads = [strategy.value_and_grad(state.params, cfg, *to_device(*batches[0], d))[1]
                 for state, d in ((dev_state, dev), (cpu_state, cpu))]
        rel = {}
        for path, got, ref in zip(ckpt_lib.paths(grads[1]), leaves(grads[0]), leaves(grads[1])):
            diff = (got.cpu() - ref).norm()
            rel[path] = float(diff / ref.norm()) if diff > 0 else 0.0
        worst_leaf = max(rel, key=rel.get)
        print(f"{label}: {len(rel)} gradient leaves at the starting parameters, |kernel - "
              f"plain| / |plain| at most {rel[worst_leaf]:.3e} ({worst_leaf}; bar 1e-3)",
              flush=True)
        if not rel[worst_leaf] <= 1e-3:
            raise AssertionError(f"{label}: kernel and plain gradients disagree: {rel}")
        reset_counts()
        ours, plain = [], []
        for batch in batches:
            ours.append(float(train_step(dev_state, cfg, strategy, *to_device(*batch, dev))))
            plain.append(float(train_step(cpu_state, cfg, strategy, *to_device(*batch, cpu))))
        counts = read_counts()
        worst = max(abs(a - b) / abs(b) for a, b in zip(ours, plain))
        print(f"{label}: kernels {ours} vs plain {plain}: worst relative difference "
              f"{worst:.3e} (bar 1e-4); launches {counts}", flush=True)
        if (counts["moe_forward_up_f32"] != 2 * PLAIN_STEPS
                or counts["moe_backward_dwd_f32"] != 2 * PLAIN_STEPS):
            raise AssertionError(f"{label}: the CUDA steps did not run the MoE kernels: {counts}")
        if not worst <= 1e-4:
            raise AssertionError(f"{label}: kernel and plain train steps disagree: {ours} vs "
                                 f"{plain}")


def _restores_exactly(result, dev) -> bool:
    """The recipe's final checkpoint restores into a fresh state, bit for bit."""
    other = create_train_state(init_params(result.config, seed=5, device=dev), 1e-4)
    ckpt_lib.restore_any(result.checkpoint_path, other)
    whole = (result.state.strategy or SingleDevice()).gather_leaf
    want = dict(zip(ckpt_lib.paths(result.state.params),
                    (whole(n, p) for n, p in zip(ckpt_lib.paths(result.state.params),
                                                  leaves(result.state.params)))))
    got = dict(zip(ckpt_lib.paths(other.params), leaves(other.params)))
    return other.step == result.state.step and all(torch.equal(got[n], want[n]) for n in want)


def moe_recipe_end_to_end(dev) -> dict:
    """Phase 13: `python -m tpukit_torch.recipes.moe --num_experts 8
    --moe_dispatch pallas --checkpoint_format sharded` at GPT-2-small width
    on 288 fixture stories (9 steps of 32), `--sequence_length 512`, 1
    epoch, bf16, in build/chip_smoke_moe/. Checks that the grouped-expert,
    flash and CE kernels ran, the eval metrics are finite, three samples
    came back (decoded on the ring), and the checkpoint (tpukit's sharded
    layout) restores. Returns the counts, the checkpoint, the config and
    the trained parameters on the host (phase 29 serves them)."""
    work = ROOT / "build" / "chip_smoke_moe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    argv = ["--dim", "768", "--head_dim", "64", "--heads", "12", "--num_layers", "12",
            "--sequence_length", "512", "--batch_size", "32", "--epochs", "1",
            "--dataset_slice", "288", "--device", "cuda", "--num_experts", "8",
            "--moe_dispatch", "pallas", "--checkpoint_format", "sharded"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_counts()
        t0 = time.perf_counter()
        result = moe_recipe.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        restored = _restores_exactly(result, dev)
    finally:
        os.chdir(cwd)
    print(f"recipe 8: {wall:.1f} s, {result.state.step} steps, windows "
          f"{result.metrics['train_windows']}, eval {result.metrics['eval']}, "
          f"{len(result.metrics['samples'])} samples {result.metrics['samples']}, "
          f"{result.metrics['tokens_per_sec']:.1f} train tokens/s, checkpoint "
          f"{result.checkpoint_path}; launches {counts}", flush=True)
    # the decode policy's combine runs only where a forward has few rows
    if min(v for k, v in counts.items()
           if not k.endswith("_f32") and k != "moe_forward_combine"
           and not k.startswith("paged_")) == 0:
        raise AssertionError(f"a kernel of recipe 8's path never ran: {counts}")
    if not np.isfinite(result.metrics["eval"]["loss"]) or len(result.metrics["samples"]) != 3:
        raise AssertionError(f"recipe 8 output: {result.metrics}")
    if not restored:
        raise AssertionError(f"checkpoint {result.checkpoint_path} did not restore exactly")
    host = unflatten(result.state.params, [p.detach().cpu() for p in leaves(result.state.params)])
    return dict(counts=counts, path=result.checkpoint_path, config=result.config, params=host)


def moe_serving(dev) -> dict:
    """Phase 14: the MoE model at GPT-2-small width (8 experts, top-1, the
    pallas dispatch, bf16) serves phase 4's 64-request stream with fused
    decoding. Every forward (one per prefill dispatch and per decode tick)
    runs each layer's grouped forward once, and each decode tick the paged
    kernel once per layer."""
    cfg, params, serve, reqs, eos = build(dev, fused=True, num_experts=8)
    serve_run(params, cfg, serve, reqs[:4], dev, eos)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engine, outs = serve_run(params, cfg, serve, reqs, dev, eos)
    wall = time.perf_counter() - t0
    counts = read_counts()
    s = engine.last_summary
    print(f"MoE served {s['requests']} requests / {s['generated_tokens']} tokens in "
          f"{wall:.3f} s ({s['generated_tokens'] / wall:.1f} tokens/s), decode ticks "
          f"{engine.steps}, prefill dispatches {s['prefill_dispatches']}, prefill "
          f"{s['prefill_s']:.3f} s / decode {s['decode_s']:.3f} s / sync {s['sync_s']:.3f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; launches {counts}",
          flush=True)
    check_outputs(outs, reqs, cfg)
    forwards = s["prefill_dispatches"] + engine.steps
    if counts["moe_forward_up"] != cfg.num_layers * forwards or forwards == 0:
        raise AssertionError(f"grouped forward launches {counts['moe_forward_up']} != "
                             f"{cfg.num_layers} x ({s['prefill_dispatches']} + {engine.steps})")
    paged = paged_want(cfg.num_layers * engine.steps)
    if any(counts[k] != v for k, v in paged.items()) or counts["moe_backward_dh"] != 0:
        raise AssertionError(f"serving launches {counts}, paged kernels want {paged}")
    # every decode tick (16 slots, top-1: 16 rows) runs the decode policy
    if counts["moe_forward_combine"] < 2 * cfg.num_layers * engine.steps:
        raise AssertionError(f"decode ticks did not run the decode policy: {counts}")
    return dict(counts=counts, tokens_per_s=s["generated_tokens"] / wall, wall=wall)


def moe_fused_vs_unfused(dev) -> dict:
    """Phase 15: the MoE model at f32 (4 layers, 8 experts, pallas): the
    64-request stream's greedy tokens equal fused and unfused on the card,
    and the first 16 requests' tokens equal those of the same engine
    through the plain versions on the CPU. Returns the fused tokens."""
    cfg, params, serve, reqs, eos = build(dev, fused=True, num_layers=4,
                                          compute_dtype=torch.float32, num_experts=8)
    runs = {}
    for label, kw in (("fused", {}), ("unfused", dict(fused_decode=False))):
        _, runs[label] = serve_run(params, cfg, dataclasses.replace(serve, **kw), reqs, dev, eos)
        check_outputs(runs[label], reqs, cfg)
    cpu = torch.device("cpu")
    cpu_params = unflatten(params, [t.to(cpu) for t in leaves(params)])
    _, runs["plain"] = serve_run(cpu_params, cfg, serve, reqs[:16], cpu, eos)
    for label, rids in (("unfused", [r.rid for r in reqs]), ("plain", [r.rid for r in reqs[:16]])):
        for rid in rids:
            if not np.array_equal(runs["fused"][rid], runs[label][rid]):
                raise AssertionError(f"MoE fused kernel tokens and {label} tokens diverge: rid "
                                     f"{rid}")
    print(f"MoE fused == unfused on all {len(reqs)} requests "
          f"({sum(len(v) for v in runs['fused'].values())} tokens incl. prompts); == the plain "
          f"versions on the CPU for the first 16", flush=True)
    return runs["fused"]


THREEFRY_KNOWN = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                  ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                   (0xC4923A9C, 0x483DF7A0))]
SAMPLE_ROWS, SAMPLE_VOCAB = 16, 50304  # one serving tick's logits (16 slots)
GUMBEL_ATOL = 1e-6  # torch.log on the card and on the CPU may round an ulp apart


def threefry_on_card(dev) -> dict:
    """Phase 19: the port's threefry on the card. Random123's known answers;
    random bits, uniforms, split and fold_in keys and Bernoulli masks
    bit-equal to the CPU's (integer arithmetic and an exact mantissa fill),
    Gumbel noise within 1e-6, at a serving tick's [16, 50304] (one key and
    a key per row) and at odd shapes; `_select_next` at temperature 0.8 and
    top-k 40 over [16, 50304] giving the CPU's tokens, and its time (CUDA
    events, eager) beside greedy argmax's."""
    cpu = torch.device("cpu")
    for key, ctr, want in THREEFRY_KNOWN:
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
        got = tuple(int(v) for v in tk_random.threefry2x32(t(key[0]), t(key[1]), t(ctr[0]),
                                                            t(ctr[1])))
        if got != want:
            raise AssertionError(f"threefry2x32{key, ctr} = {got} on the card, want {want}")
    key = tk_random.PRNGKey(1234)
    rows = tk_random.split(key, SAMPLE_ROWS)
    worst = 0.0
    for k, shape in ((key, (SAMPLE_ROWS, SAMPLE_VOCAB)), (rows, (SAMPLE_VOCAB,)),
                     (key, (7,)), (key, (3, 5, 11)), (rows, (1, 50257))):
        kd = k.to(dev)
        for name, fn in (("random_bits", tk_random.random_bits), ("uniform", tk_random.uniform),
                         ("bernoulli", lambda kk, sh: tk_random.bernoulli(kk, 0.9, sh))):
            if not torch.equal(fn(kd, shape).cpu(), fn(k, shape)):
                raise AssertionError(f"{name} {tuple(k.shape)} x {shape}: card != CPU")
        err = float((tk_random.gumbel(kd, shape).cpu() - tk_random.gumbel(k, shape)).abs().max())
        worst = max(worst, err)
        if not err <= GUMBEL_ATOL:
            raise AssertionError(f"gumbel {shape}: card vs CPU {err} > {GUMBEL_ATOL}")
    cursors = torch.arange(SAMPLE_ROWS, dtype=torch.int32) * 37 + 5
    for name, got, want in (
            ("split", tk_random.split(key.to(dev), 64).cpu(), tk_random.split(key, 64)),
            ("fold_in", tk_random.fold_in(rows.to(dev), cursors.to(dev)).cpu(),
             tk_random.fold_in(rows, cursors))):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: card != CPU")
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((SAMPLE_ROWS, SAMPLE_VOCAB), generator=gen) * 3
    ld, cd, kd = logits.to(dev), cursors.to(dev), rows.to(dev)
    sample = lambda: serve_decode._select_next(ld, cd, kd, 0.8, 40)
    tokens = sample().cpu()
    want = serve_decode._select_next(logits, cursors, rows, 0.8, 40)
    if not torch.equal(tokens, want):
        raise AssertionError(f"_select_next on the card {tokens} != CPU {want}")
    ms = time_ms(sample, 20)
    greedy_ms = time_ms(lambda: serve_decode._select_next(ld, cd, kd, 0.0, 0), 20)
    print(f"threefry: known answers, bits/uniform/bernoulli/split/fold_in bit-equal to the "
          f"CPU, gumbel within {worst:.3e}; _select_next [16, 50304] t 0.8 top-k 40: "
          f"{ms:.4f} ms a call (greedy argmax {greedy_ms:.4f} ms), tokens equal the CPU's",
          flush=True)
    return dict(select_ms=ms, greedy_ms=greedy_ms, gumbel_err=worst)


def _tokens_per_s(engine, wall) -> float:
    return engine.last_summary["generated_tokens"] / wall


def _timed_serve(params, cfg, serve, reqs, dev, eos, **kw):
    """A warm-up on 4 requests, then `reqs` with launch counts from zero;
    returns the engine, its tokens, the wall and the counts."""
    serve_run(params, cfg, serve, reqs[:4], dev, eos, **kw)
    reset_counts()
    t0 = time.perf_counter()
    engine, outs = serve_run(params, cfg, serve, reqs, dev, eos, **kw)
    wall = time.perf_counter() - t0
    return engine, outs, wall, read_counts()


def _split(engine, wall) -> str:
    s = engine.last_summary
    return (f"{s['requests']} requests / {s['generated_tokens']} tokens in {wall:.3f} s "
            f"({s['generated_tokens'] / wall:.1f} tokens/s), {engine.steps} decode steps, "
            f"prefill {s['prefill_s']:.3f} s / decode {s['decode_s']:.3f} s / sync "
            f"{s['sync_s']:.3f} s")


def _same_tokens(runs: dict, base: str, rids, what: str) -> None:
    for label, outs in runs.items():
        for rid in rids:
            if not np.array_equal(outs[rid], runs[base][rid]):
                raise AssertionError(f"{what}: {label} tokens != {base} tokens, rid {rid}")


SAMPLED = dict(temperature=0.8, top_k=40)
F32_HEAD = 32  # phases 20-21's f32 comparisons (all 64 until phase 41 came)


def sampled_serving(dev, greedy: dict) -> dict:
    """Phase 20: phase 4's config and 64-request stream, sampled
    (temperature 0.8, top-k 40, each request's key from its seed), fused
    decode: each paged kernel launches layers x decode ticks times; tokens/s
    beside phase 4's greedy run. Then at f32 with 4 layers the stream's
    first 32 requests give the same tokens fused, unfused, on the ring,
    and fused again (tpukit's same-seed guarantee)."""
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    engine, outs, wall, counts = _timed_serve(params, cfg,
                                              dataclasses.replace(serve, **SAMPLED), reqs,
                                              dev, eos)
    check_outputs(outs, reqs, cfg)
    paged = paged_want(cfg.num_layers * engine.steps)
    print(f"sampled (t 0.8, top-k 40) fused: {_split(engine, wall)}; greedy (phase 4) "
          f"{greedy['tokens_per_s']:.1f} tokens/s; paged launches "
          f"{ {k: counts[k] for k in paged} }", flush=True)
    if any(counts[k] != v for k, v in paged.items()) or engine.steps == 0:
        raise AssertionError(f"sampled serving: paged launches {counts} != {paged}")
    cfg32, params32, serve32, _, _ = build(dev, fused=True, num_layers=4,
                                            compute_dtype=torch.float32)
    serve32 = dataclasses.replace(serve32, **SAMPLED)
    ring = dataclasses.replace(serve32, page_size=0, prefill_chunk=0, fused_decode=False)
    runs, head = {}, reqs[:F32_HEAD]
    for label, sc in (("fused", serve32), ("unfused", dataclasses.replace(serve32,
                                                                          fused_decode=False)),
                      ("ring", ring), ("fused again", serve32)):
        _, runs[label] = serve_run(params32, cfg32, sc, head, dev, eos)
        check_outputs(runs[label], head, cfg32)
    _same_tokens(runs, "fused", [r.rid for r in head], "sampled f32")
    print(f"sampled f32: fused == unfused == ring == fused again on the first {len(head)} "
          f"requests ({sum(len(v) for v in runs['fused'].values())} tokens incl. prompts)",
          flush=True)
    return dict(tokens_per_s=_tokens_per_s(engine, wall), wall=wall, steps=engine.steps,
                counts={k: counts[k] for k in paged}, summary=engine.last_summary)


def ring_serving(dev, greedy: dict) -> dict:
    """Phase 21: tpukit's default ring cache (page_size 0, bf16, phase 4's
    64 requests): tokens/s and the prefill/decode split beside phase 4's;
    the paged kernels do not run. At f32 with 4 layers the ring's greedy
    tokens equal the paged (fused) engine's on the first 32 requests. MoE
    on the ring (8 experts,
    pallas): the grouped forward launches layers x (prefill dispatches +
    ticks) times."""
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    ring = dataclasses.replace(serve, page_size=0, prefill_chunk=0, fused_decode=False)
    engine, outs, wall, counts = _timed_serve(params, cfg, ring, reqs, dev, eos)
    check_outputs(outs, reqs, cfg)
    print(f"ring bf16: {_split(engine, wall)}; phase 4 (paged, fused) "
          f"{greedy['tokens_per_s']:.1f} tokens/s, prefill {greedy['prefill_s']:.3f} s / "
          f"decode {greedy['decode_s']:.3f} s / sync {greedy['sync_s']:.3f} s; kv_bytes "
          f"{engine.kv_bytes}", flush=True)
    if any(counts[k] for k in paged_want(0)):
        raise AssertionError(f"the ring ran the paged kernels: {counts}")
    cfg32, params32, serve32, _, _ = build(dev, fused=True, num_layers=4,
                                            compute_dtype=torch.float32)
    head = reqs[:F32_HEAD]
    runs = {"paged": serve_run(params32, cfg32, serve32, head, dev, eos)[1],
            "ring": serve_run(params32, cfg32, dataclasses.replace(
                serve32, page_size=0, prefill_chunk=0, fused_decode=False), head, dev, eos)[1]}
    _same_tokens(runs, "paged", [r.rid for r in head], "greedy f32")
    print(f"greedy f32: ring == paged (fused) on the first {len(head)} requests", flush=True)
    mcfg, mparams, mserve, _, _ = build(dev, fused=True, num_experts=8)
    mring = dataclasses.replace(mserve, page_size=0, prefill_chunk=0, fused_decode=False)
    meng, mouts, mwall, mcounts = _timed_serve(mparams, mcfg, mring, reqs, dev, eos)
    check_outputs(mouts, reqs, mcfg)
    s = meng.last_summary
    forwards = s["prefill_dispatches"] + meng.steps
    print(f"MoE ring (8 experts, pallas): {_split(meng, mwall)}; grouped forward launches "
          f"{mcounts['moe_forward_up']} = {mcfg.num_layers} x ({s['prefill_dispatches']} "
          f"prefill dispatches + {meng.steps} ticks)", flush=True)
    if mcounts["moe_forward_up"] != mcfg.num_layers * forwards or forwards == 0:
        raise AssertionError(f"MoE ring: grouped forward launches {mcounts['moe_forward_up']} "
                             f"!= {mcfg.num_layers} x {forwards}")
    return dict(tokens_per_s=_tokens_per_s(engine, wall), wall=wall, summary=engine.last_summary,
                moe_tokens_per_s=_tokens_per_s(meng, mwall), moe_counts=mcounts)


DRAFT_SHAPE = dict(dim=64, head_dim=16, heads=4, num_layers=2)  # main-serve.py's --draft_*


def _draft(cfg, dev, seed: int = 1):
    dcfg = GPTConfig(vocab_size=cfg.vocab_size, max_position_embeddings=cfg.max_position_embeddings,
                     compute_dtype=cfg.compute_dtype, **DRAFT_SHAPE)
    return dict(draft_params=init_params(dcfg, seed=seed, device=dev), draft_cfg=dcfg)


def _spec_line(engine) -> str:
    sp = engine.last_summary["spec"]
    hist = sp["accepted_hist"]
    mean = sum(i * h for i, h in enumerate(hist)) / max(sum(hist), 1)
    rate = sp["accept_rate"]
    return (f"accepted {sp['accepted']}/{sp['proposed']} draft tokens "
            f"({'n/a' if rate is None else f'{rate:.4f}'}), {mean:.3f} tokens appended per "
            f"verify, histogram {hist}")


# phase 22's f32 checks: greedy speculation on the first 16 requests, the
# serial reference on the first 4 (32 and 8 until phase 41 came)
SPEC_F32_HEAD, SPEC_REFERENCE = 16, 4
SPEC_FULL_WIDTH = 32  # phase 22's full-width runs: the first half of phase 4's stream


def speculative_serving(dev, ring: dict) -> dict:
    """Phase 22: speculation on the ring, spec_k 4, 32 requests at full
    width (bf16; the first half of phase 4's stream): `draft="ngram"` on the `repetitive` stream beside vanilla
    ring decoding of that stream, and `draft="model"` (tpukit's draft shape,
    fresh seeded) on the same requests of phase 4's stream beside phase
    21's ring run (all 64):
    acceptance, mean tokens appended per verify, tokens/s. At f32 with 4
    layers: greedy speculation (both proposers) gives vanilla's tokens on
    the first 16 requests, and sampled (t 0.8, top-k 40) the engine's
    tokens for the first 4 equal the serial `reference_spec_decode`'s (a
    request's tokens do not depend on its batch)."""
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    reqs = reqs[:SPEC_FULL_WIDTH]
    ring_cfg = dataclasses.replace(serve, page_size=0, prefill_chunk=0, fused_decode=False)
    spec = dataclasses.replace(ring_cfg, spec_k=4)
    rep = synthetic_request_stream(get_tokenizer(), len(reqs), seed=0,
                                   max_new_tokens=serve.max_new_tokens, buckets=serve.buckets,
                                   stream_profile="repetitive")
    veng, vouts, vwall, _ = _timed_serve(params, cfg, ring_cfg, rep, dev, eos)
    neng, nouts, nwall, _ = _timed_serve(params, cfg, dataclasses.replace(spec, draft="ngram"),
                                         rep, dev, eos)
    for outs in (vouts, nouts):
        check_outputs(outs, rep, cfg)
    print(f"repetitive stream, vanilla ring: {_split(veng, vwall)}", flush=True)
    print(f"repetitive stream, ngram spec_k 4: {_split(neng, nwall)}; {_spec_line(neng)}",
          flush=True)
    draft = _draft(cfg, dev)
    meng, mouts, mwall, _ = _timed_serve(params, cfg, dataclasses.replace(spec, draft="model"),
                                         reqs, dev, eos, **draft)
    check_outputs(mouts, reqs, cfg)
    print(f"phase 4 stream ({len(reqs)} requests), model draft (64 / 4 x 16 / 2 layers) "
          f"spec_k 4: "
          f"{_split(meng, mwall)}; {_spec_line(meng)}; vanilla ring (phase 21) "
          f"{ring['tokens_per_s']:.1f} tokens/s", flush=True)

    cfg32, params32, serve32, _, _ = build(dev, fused=True, num_layers=4,
                                            compute_dtype=torch.float32)
    ring32 = dataclasses.replace(serve32, page_size=0, prefill_chunk=0, fused_decode=False,
                                 spec_k=4)
    draft32 = _draft(cfg32, dev)
    head = reqs[:SPEC_F32_HEAD]
    runs = {"vanilla": serve_run(params32, cfg32, ring32, head, dev, eos)[1],
            "ngram": serve_run(params32, cfg32, dataclasses.replace(ring32, draft="ngram"),
                               head, dev, eos)[1],
            "model": serve_run(params32, cfg32, dataclasses.replace(ring32, draft="model"),
                               head, dev, eos, **draft32)[1]}
    _same_tokens(runs, "vanilla", [r.rid for r in head], "greedy speculation")
    sampled = dataclasses.replace(ring32, draft="model", **SAMPLED)
    _, souts = serve_run(params32, cfg32, sampled, reqs[:SPEC_REFERENCE], dev, eos, **draft32)
    check_outputs(souts, reqs[:SPEC_REFERENCE], cfg32)
    for r in reqs[:SPEC_REFERENCE]:
        ref = spec_lib.reference_spec_decode(
            params32, cfg32, r.ids, r.max_new_tokens, eos, k=4, draft="model",
            temperature=0.8, top_k=40, seed=r.seed, **draft32)
        if not np.array_equal(ref, souts[r.rid]):
            raise AssertionError(f"sampled speculation: engine tokens != reference_spec_decode, "
                                 f"rid {r.rid}")
    print(f"f32: greedy ngram == model == vanilla on the first {len(head)} requests; sampled "
          f"model speculation == reference_spec_decode on the first {SPEC_REFERENCE}",
          flush=True)
    return dict(ngram=neng.last_summary, model_outs=mouts, draft=draft, reqs=reqs,
                model=meng.last_summary, ngram_tokens_per_s=_tokens_per_s(neng, nwall),
                vanilla_rep_tokens_per_s=_tokens_per_s(veng, vwall),
                model_tokens_per_s=_tokens_per_s(meng, mwall))


def dropout_training(dev, plain_step: dict) -> dict:
    """Phase 23: phase 7's rung with dropout 0.1, 8 steps (the loss falls on
    a repeated batch, the flash and CE kernels launch as in phase 7), step
    wall beside phase 7's; then phase 8's kernel-vs-plain steps at dropout
    0.1 (f32, 2 layers, PLAIN_STEPS steps, the same keys), within rtol 1e-4."""
    run = train_full_width(dev, dropout=0.1)
    del run["state"]
    print(f"dropout 0.1: step wall {run['wall']:.4f} s against phase 7's "
          f"{plain_step['wall']:.4f} s ({run['wall'] / plain_step['wall']:.3f}x)", flush=True)
    _free()
    kernel_vs_plain_steps(dev, dropout=0.1)
    return run


def _named(tree) -> dict:
    return dict(zip(ckpt_lib.paths(tree), leaves(tree)))


def _same_tree(got: dict, want: dict, what: str) -> None:
    """`got` holds `want`'s tensors (gathered whole) bit for bit."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: leaves {sorted(got)} != {sorted(want)}")
    for n, t in want.items():
        if not torch.equal(got[n].to(t.device), gather_full(t).detach()):
            raise AssertionError(f"{what}: {n} differs")


def _disk_bytes(path: Path) -> int:
    if path.is_dir():
        return sum(f.stat().st_size for f in path.iterdir())
    side = ckpt_lib.checksum_sidecar(path)
    return path.stat().st_size + (side.stat().st_size if side.exists() else 0)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def checkpoint_formats(dev) -> dict:
    """Phase 27: recipe 1 as phase 9 runs it, once with `--checkpoint_format
    consolidated` and once with `sharded`, each in its own
    build/chip_smoke_ckpt_<format>/. Each final checkpoint passes
    `verify_checkpoint`; `restore_params` gives `FitResult.state`'s
    parameters bit for bit, and a full `restore_any` into a fresh state its
    parameters, AdamW moments and step; the sharded params-only read skips
    the optimizer's blocks (bytes skipped = 2 x bytes read, within 1e-3:
    the two moments, plus the count and step). Bytes on disk, the I/O
    ledger and the restore walls are printed; the consolidated run's state
    is also written as the port's `.pt`, the third format phase 28 serves."""
    runs = {}
    for fmt in ("consolidated", "sharded"):
        work = ROOT / "build" / f"chip_smoke_ckpt_{fmt}"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            result, wall = _timed(lambda: single.main(RECIPE_ARGV + ["--checkpoint_format",
                                                                     fmt]))
        finally:
            os.chdir(cwd)
        runs[fmt] = dict(result=result, path=result.checkpoint_path, work=work)
    runs["pt"] = dict(result=runs["consolidated"]["result"], work=runs["consolidated"]["work"],
                      path=ckpt_lib.save(runs["consolidated"]["result"].state,
                                         directory=runs["consolidated"]["work"] / "pt"))
    for fmt, run in runs.items():
        result, path = run["result"], run["path"]
        verdict = ckpt_lib.verify_checkpoint(path)
        if verdict[0] is not True or (fmt != "pt" and verdict[1] != "verified"):
            raise AssertionError(f"{fmt} checkpoint {path}: {verdict}")
        (params, info), params_s = _timed(lambda: ckpt_lib.restore_params(
            path, init_params(result.config, device="meta"), dev))
        _same_tree(_named(params), _named(result.state.params), f"{fmt} params-only restore")
        other = create_train_state(init_params(result.config, seed=5, device=dev), 1e-4)
        _, full_s = _timed(lambda: ckpt_lib.restore_any(path, other))
        _same_tree(_named(other.params), _named(result.state.params), f"{fmt} full restore")
        for key in ("exp_avg", "exp_avg_sq"):
            _same_tree({n: other.optimizer.state[p][key] for n, p in _named(other.params).items()},
                       {n: result.state.optimizer.state[p][key]
                        for n, p in _named(result.state.params).items()}, f"{fmt} {key}")
        if other.step != result.state.step:
            raise AssertionError(f"{fmt}: step {other.step} != {result.state.step}")
        ratio = info["bytes_skipped"] / info["bytes_read"]
        if fmt == "sharded" and not abs(ratio - 2.0) < 1e-3:
            raise AssertionError(f"sharded params-only read skipped {ratio} x what it read")
        del other
        _free()
        n_params = sum(p.numel() for p in leaves(result.state.params))
        run.update(params=params, info=info, params_s=params_s, full_s=full_s,
                   disk=_disk_bytes(path))
        print(f"{fmt}: {path.name}, {run['disk']} B on disk ({n_params} parameters, "
              f"{4 * n_params} B in f32); verify {verdict[1]}; params-only restore "
              f"{params_s:.3f} s, {info}, skipped/read {ratio:.6f}; full restore {full_s:.3f} "
              f"s; params, exp_avg, exp_avg_sq and step bit-equal; recipe train tokens/s "
              f"{result.metrics['tokens_per_sec']:.1f}", flush=True)
    return runs


COMPARED = 16  # requests run twice to compare restored and in-memory parameters
WIDTH_FLAGS = ["--device", "cuda", "--dim", "768", "--head_dim", "64", "--heads", "12",
               "--num_layers", "12", "--sequence_length", "512"]  # the recipes' width
STREAM_FLAGS = ["--slots", str(SERVE_SHAPE["slots"]),
                "--buckets", ",".join(map(str, SERVE_SHAPE["buckets"])),
                "--max_new_tokens", str(SERVE_SHAPE["max_new_tokens"]),
                "--requests", str(REQUESTS)]  # phase 4's stream
PAGED_FLAGS = ["--page_size", str(SERVE_SHAPE["page_size"]),
               "--prefill_chunk", str(SERVE_SHAPE["prefill_chunk"]), "--fused_decode"]


def serve_cli(argv, cwd: Path) -> tuple[str, dict, int]:
    """`python -m tpukit_torch.serve argv` in `cwd` (its `main`, in this
    process): the printed text (echoed), the launch counts of the run and
    its decode ticks."""
    text = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        reset_counts()
        with contextlib.redirect_stdout(text):
            code = serve_main.main(argv)
        counts = read_counts()
    finally:
        os.chdir(old)
    print(text.getvalue(), end="", flush=True)
    if code != 0:
        raise AssertionError(f"serve {argv} exited {code}")
    return text.getvalue(), counts, int(re.search(r"(\d+) decode ticks", text.getvalue())[1])


def _stream(tok):
    return synthetic_request_stream(tok, REQUESTS, seed=0,
                                    max_new_tokens=SERVE_SHAPE["max_new_tokens"],
                                    buckets=SERVE_SHAPE["buckets"])


def serve_checkpoints(dev, runs: dict, greedy: dict) -> None:
    """Phase 28: `python -m tpukit_torch.serve --checkpoint latest
    --page_size 16 --fused_decode` at the recipe's width, in phase 27's
    consolidated directory, on phase 4's stream: the restore line, and each
    paged kernel launching layers x decode ticks times. Through the engine
    on the same requests (the first 16), each format's restored parameters
    give the tokens of the in-memory `FitResult.state` parameters (bf16,
    paged, fused); the trained weights' tokens/s on all 64 beside phase 4's
    random weights (a baseline).
    At f32 compute the paged fused engine's greedy continuations of
    `GENERATION_PROMPTS` equal `generate_samples`' (the ring)."""
    out, counts, ticks = serve_cli(WIDTH_FLAGS + STREAM_FLAGS + PAGED_FLAGS +
                                   ["--checkpoint", "latest"], runs["consolidated"]["work"])
    layers = runs["consolidated"]["result"].config.num_layers
    paged = paged_want(layers * ticks)
    if "serving checkpoint " not in out or any(counts[k] != v for k, v in paged.items()):
        raise AssertionError(f"served checkpoint: launches {counts} != {paged}, or no restore "
                             f"line")
    tok = get_tokenizer()
    eos, reqs = int(tok.eos_token_id), _stream(tok)
    serve = ServeConfig(fused_decode=True, **SERVE_SHAPE)
    cfg = runs["consolidated"]["result"].config
    engine, _, wall, _ = _timed_serve(runs["consolidated"]["params"], cfg, serve, reqs, dev, eos)
    print(f"trained weights (restored, consolidated): {_split(engine, wall)}; phase 4 (random "
          f"weights, vocab 50257) {greedy['tokens_per_s']:.1f} tokens/s", flush=True)
    head, memory = reqs[:COMPARED], {}
    for fmt in ("pt", "consolidated", "sharded"):
        result = runs[fmt]["result"]
        if id(result) not in memory:
            live = result.state.params
            memory[id(result)] = serve_run(unflatten(live, [p.detach() for p in leaves(live)]),
                                           result.config, serve, head, dev, eos)[1]
        restored = serve_run(runs[fmt]["params"], result.config, serve, head, dev, eos)[1]
        check_outputs(restored, head, result.config)
        _same_tokens({"restored": restored, "in-memory": memory[id(result)]}, "in-memory",
                     [r.rid for r in head], f"{fmt} checkpoint")
    print(f"bf16 paged fused: restored == in-memory tokens on the first {len(head)} requests "
          f"for the .pt, consolidated and sharded checkpoints", flush=True)
    cfg32 = runs["consolidated"]["result"].config.replace(compute_dtype=torch.float32)
    params = runs["consolidated"]["params"]
    texts = generate_samples(params, cfg32, tok)
    prompts = [Request(rid=i, ids=tuple(tok([p])["input_ids"][0]), max_new_tokens=20)
               for i, p in enumerate(GENERATION_PROMPTS)]
    serve32 = ServeConfig(slots=4, buckets=(16,), max_new_tokens=20, page_size=16,
                          fused_decode=True)
    outs = serve_run(params, cfg32, serve32, prompts, dev, eos)[1]
    got = [tok.decode(outs[r.rid], skip_special_tokens=True) for r in prompts]
    if got != texts:
        raise AssertionError(f"f32 paged fused samples {got} != generate_samples' {texts}")
    print(f"f32: paged fused == generate_samples on {len(texts)} prompts: {texts}", flush=True)


def serve_moe_and_draft(dev, moe_run: dict, spec: dict, runs: dict) -> None:
    """Phase 29: recipe 8's sharded checkpoint (phase 13) served by `python
    -m tpukit_torch.serve --num_experts 8 --moe_dispatch pallas --page_size
    16 --fused_decode --checkpoint PATH`: the grouped forward and the paged
    kernels launch; through the engine the restored parameters give the
    in-memory ones' tokens (bf16, first 16 requests; the CLI serves 16).
    Then phase 22's seeded draft (64, 4 x 16, 2 layers) saved consolidated
    and restored: phase 22's draft run's tokens (bf16 greedy, ring, spec_k
    4) on its first 16 requests, and sampled (t 0.8, top-k 40, whose tokens
    and acceptance depend on the draft) the in-memory draft's tokens and
    acceptance histogram; and the CLI's `--draft model --draft_checkpoint
    PATH` on the ring (16 requests), a draft of that shape at the recipe's
    vocab beside phase 27's trained target."""
    path = moe_run["path"]
    few = ["--requests", str(COMPARED)]
    out, counts, ticks = serve_cli(WIDTH_FLAGS + STREAM_FLAGS + PAGED_FLAGS + few + [
        "--num_experts", "8", "--moe_dispatch", "pallas", "--checkpoint", str(path)], ROOT)
    cfg = moe_run["config"].replace(moe_dispatch="pallas")
    paged = paged_want(cfg.num_layers * ticks)
    if "serving checkpoint " not in out or counts["moe_forward_up"] == 0 or \
            any(counts[k] != v for k, v in paged.items()):
        raise AssertionError(f"served MoE checkpoint: launches {counts}, paged want {paged}")
    tok = get_tokenizer()
    eos, reqs = int(tok.eos_token_id), _stream(tok)[:COMPARED]
    serve = ServeConfig(fused_decode=True, **SERVE_SHAPE)
    restored, _ = ckpt_lib.restore_params(path, init_params(cfg, device="meta"), dev)
    memory = unflatten(moe_run["params"], [p.to(dev) for p in leaves(moe_run["params"])])
    _same_tree(_named(restored), _named(memory), "MoE params-only restore")
    _same_tokens({"restored": serve_run(restored, cfg, serve, reqs, dev, eos)[1],
                  "in-memory": serve_run(memory, cfg, serve, reqs, dev, eos)[1]},
                 "in-memory", [r.rid for r in reqs], "MoE checkpoint")
    print(f"MoE: {path.name} served, grouped forward launches {counts['moe_forward_up']}; "
          f"restored == in-memory tokens on {len(reqs)} requests", flush=True)
    del restored, memory
    _free()

    tcfg, tparams, tserve, _, _ = build(dev, fused=True)
    ring = dataclasses.replace(tserve, page_size=0, prefill_chunk=0, fused_decode=False,
                               spec_k=4, draft="model")
    dparams, dcfg = spec["draft"]["draft_params"], spec["draft"]["draft_cfg"]
    dstate = create_train_state(unflatten(dparams, [p.detach().clone() for p in leaves(dparams)]),
                                1e-4)
    dpath = ckpt_lib.save_consolidated(dstate, ROOT / "build" / "chip_smoke_draft")
    drestored, dinfo = ckpt_lib.restore_params(dpath, init_params(dcfg, device="meta"), dev)
    _same_tree(_named(drestored), _named(dparams), "draft params-only restore")
    head = spec["reqs"][:COMPARED]  # a request's tokens do not depend on its batch
    outs = serve_run(tparams, tcfg, ring, head, dev, eos, draft_params=drestored,
                     draft_cfg=dcfg)[1]
    _same_tokens({"restored": outs, "phase 22": spec["model_outs"]}, "phase 22",
                 [r.rid for r in head], "draft checkpoint")
    sampled, runs_ = dataclasses.replace(ring, **SAMPLED), {}
    for label, d in (("restored", drestored), ("in-memory", dparams)):
        engine, runs_[label] = serve_run(tparams, tcfg, sampled, head, dev, eos, draft_params=d,
                                         draft_cfg=dcfg)
        runs_[label + " acceptance"] = engine.last_summary["spec"]["accepted_hist"]
    _same_tokens({k: runs_[k] for k in ("restored", "in-memory")}, "in-memory",
                 [r.rid for r in head], "sampled speculation, draft checkpoint")
    if runs_["restored acceptance"] != runs_["in-memory acceptance"]:
        raise AssertionError(f"restored draft acceptance {runs_['restored acceptance']} != "
                             f"{runs_['in-memory acceptance']}")
    print(f"draft {dpath.name} ({dinfo['bytes_read']} B): phase 22's draft run's tokens on the "
          f"first {len(head)} requests; sampled t 0.8 top-k 40: restored == in-memory draft "
          f"tokens and acceptance histogram {runs_['restored acceptance']}", flush=True)
    del tparams
    _free()

    target = runs["consolidated"]["result"].config
    fcfg = GPTConfig(vocab_size=target.vocab_size,
                     max_position_embeddings=target.max_position_embeddings, **DRAFT_SHAPE)
    fstate = create_train_state(init_params(fcfg, seed=1, device=dev), 1e-4)
    fpath = ckpt_lib.save_consolidated(fstate, ROOT / "build" / "chip_smoke_draft" / "fixture")
    draft_flags = ["--draft", "model", "--draft_checkpoint", str(fpath), "--spec_k", "4"] + [
        a for k, v in DRAFT_SHAPE.items() for a in (f"--draft_{k}", str(v))]
    out, _, _ = serve_cli(WIDTH_FLAGS + STREAM_FLAGS + few + ["--checkpoint", "latest"] +
                          draft_flags, runs["consolidated"]["work"])
    if f"draft model {fpath} (params-only restore" not in out or "speculative decoding" not in out:
        raise AssertionError("the CLI did not serve the draft checkpoint")


def tp_full_width(dev, single_run: dict) -> dict:
    """Phase 30: phase 7's steps under `TensorParallel` on recipe 6's grid
    of one card (data 1 x model 1), in the world of one `main` brought up,
    checked as phase 7 checks its own (the flash kernels 12 times a step
    each, no CE kernel: the head is the vocab-parallel CE); step wall,
    tokens/s and peak device memory beside phase 7's."""
    strategy = TensorParallel(**tp_recipe.pick_grid(mesh_lib.world_size(),
                                                    GPT2_SMALL_TRAIN["heads"]))
    run = train_full_width(dev, strategy)
    del run["state"], strategy
    _free()
    steps = len(run["losses"])
    print(f"tp: {run['wall']:.4f} s a step ({single_run['wall']:.4f} single, "
          f"{run['wall'] / single_run['wall']:.4f}x), {BATCH * SEQ / run['wall']:.1f} tokens/s, "
          f"peak {run['peak']} B ({single_run['peak']} single, "
          f"{run['peak'] / single_run['peak']:.4f}x); flash launches a step: forward "
          f"{run['counts']['flash_forward'] // steps}, backward "
          f"{sum(run['counts'][f'flash_backward_{k}'] for k in ('dcap', 'dkv', 'dq')) // steps}",
          flush=True)
    return run


TP_GLOO_TIMEOUT = 240  # seconds phase 31's (or 35's) two ranks may take


def _tp_small(dev, **shape):
    """Phase 8's f32 2-layer setup: (cfg, base parameters, 4 batches)."""
    cfg, base = build_train(dev, num_layers=2, compute_dtype=torch.float32,
                            attention_impl="flash", seed=1, **shape)
    rng = np.random.RandomState(1)
    batches = [to_device(*synthetic_batch(rng, cfg.vocab_size, 4, SEQ, pad_rows=1), dev)
               for _ in range(4)]
    return cfg, base.params, batches


def _tp_steps(cfg, base, batches, strategy, lr=1e-4, audit: dict | None = None):
    """4 AdamW steps from a copy of `base` under `strategy`: (losses, the
    parameters whole, flash forward launches, the first batch's gradients
    whole, taken before the steps). `audit` (a dict) receives the comm
    audit of that first `value_and_grad` (`audited_step`)."""
    params = unflatten(base, [t.detach().clone() for t in leaves(base)])
    state = create_train_state(params, lr, strategy)
    names = ckpt_lib.paths(state.params)
    first = lambda: strategy.value_and_grad(state.params, cfg, *batches[0])  # noqa: E731
    if audit is None:
        _, grads = first()
    else:
        rows = batches[0][1].shape[0] * strategy.row_shards
        audit.update(audited_step(first, strategy, cfg, state.params, rows,
                                  batches[0][1].shape[1]))
        _, grads = audit.pop("out")
    grads = [strategy.gather_leaf(n, g).detach() for n, g in zip(names, leaves(grads))]
    reset_counts()
    losses = [float(train_step(state, cfg, strategy, *b)) for b in batches]
    flash = read_counts()["flash_forward"]
    whole = [strategy.gather_leaf(n, p).detach() for n, p in zip(names, leaves(state.params))]
    return losses, whole, flash, grads


def gloo_pair(flag: str, name: str) -> dict:
    """Run `chip_smoke.py <flag> R STORE OUT` as two gloo ranks on this
    card (NCCL cannot put two ranks on one card) in build/<name>/; returns
    what rank 0 wrote."""
    work = ROOT / "build" / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = work / "rank0.npz"
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, str(r),
                               str(work / "store"), str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TP_GLOO_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}:\n{log[-3000:]}")
    return dict(np.load(out))


def gloo_rank(flag: str, rank: int, store: str, out: str) -> int:
    """One rank of phase 31's model-2 world (`--tp-gloo-rank`), of phase
    35's Ulysses seq-2 world (`--cp-gloo-rank`), of phase 37's expert-2
    world (`--ep-gloo-rank`, each rank its half of the rows; then again
    with the int8 and the bf16 exchange of phase 38, their results under
    `int8/` and `bf16/`) or of phase 38's DataParallel int8 world
    (`--dp-gloo-rank`, each rank its half of the rows; then again at f32
    with one bucket and with 4, under `b1/` and `b4/`, with the deferred
    bucket steps taken under `b4/bucket_steps`): gloo on cuda:0; rank 0
    writes the losses, the flash, CE and grouped launches and the
    parameters and first gradients whole to `out`."""
    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", world_size=2,
                                         rank=rank)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        runs = [("", {})]  # (prefix, config fields) of each run of this world
        if flag == "--tp-gloo-rank":
            cfg, base, batches = _tp_small(dev)
            make = lambda: TensorParallel(model=2)  # noqa: E731
        elif flag == "--cp-gloo-rank":
            cfg, base, batches = _cp_small(dev)
            make = lambda: ContextParallel(attention="ulysses")  # noqa: E731
        elif flag == "--dp-gloo-rank":
            cfg, base, batches = _tp_small(dev)
            make = DataParallel
            runs = [("", dict(comm_dtype="int8")), ("b1/", dict(grad_buckets=1)),
                    ("b4/", dict(grad_buckets=4))]
            batches = [_rows_of(b, rank, 2) for b in batches]
        else:
            cfg, base, batches = _ep_small(dev)
            make = lambda: ExpertParallel(ExpertGrid(data=1, expert=2), dispatch="pallas")  # noqa: E731,E501
            batches = [_rows_of(b, rank, 2) for b in batches]
            runs += [(f"{c}/", dict(comm_dtype=c)) for c in QUANT_EXCHANGES]
        result = {}
        bucket_steps = []
        real_step = DataParallel._bucket_step

        def counted(self, *args):
            bucket_steps.append(1)
            return real_step(self, *args)

        DataParallel._bucket_step = counted
        for prefix, fields in runs:
            run_cfg = cfg.replace(**fields)
            audit = {} if flag == "--dp-gloo-rank" and not prefix else None
            bucket_steps.clear()
            losses, whole, flash, grads = _tp_steps(run_cfg, base, batches, make(),
                                                    audit=audit)
            result[f"{prefix}bucket_steps"] = np.int64(len(bucket_steps))
            if audit:  # phase 43: rank 0's trace of the hand-placed step, linted
                plan = audit["plan"]
                result["audit"] = json.dumps(dict(
                    measured=comm_ir.collective_summary(audit["trace"]),
                    plan=None if plan is None else plan.ops,
                    findings=[f.to_record() for f in lint_trace(audit["trace"], plan=plan)],
                    counts=audit["counts"], ops=audit["trace"].ops))
            counts = {k: v for k, v in read_counts().items()
                      if k.startswith(("moe_", "ce_", "flash_"))}
            result.update({f"{prefix}losses": np.array(losses), f"{prefix}flash": np.int64(flash),
                           **{f"{prefix}p{i}": t.cpu().numpy() for i, t in enumerate(whole)},
                           **{f"{prefix}g{i}": t.cpu().numpy() for i, t in enumerate(grads)},
                           **{f"{prefix}count/{k}": np.int64(v) for k, v in counts.items()}})
        if rank == 0:
            np.savez(out, **result)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0


def tp_equals_single(dev) -> None:
    """Phase 31: phase 8's setup under `TensorParallel` against
    `SingleDevice`. In the world of one: losses within rtol 1e-4 of the
    default single-device step's, and parameters bit-equal to the unfused
    single-device step's (`TPUKIT_FUSED_HEAD=0`, `fuse_qkv=False`: at one
    rank every Megatron operator is the identity, so the step is the same
    kernels). Then model 2 over two gloo ranks on this card (each rank 6
    heads through the flash kernels, the collectives through host memory):
    the first step's gradient against the unfused single-device step's,
    each leaf within 1e-2 of its norm, and the losses of 4 steps within
    rtol 1e-4 of the default single-device step's. The model group's sums
    add the shards' partial products in another order, so at this width
    an FFN relu input or two within that noise of 0 take the other side
    (ROADMAP.md §C, differences by construction): that token's cotangent
    then differs in one channel, which moves rows of the FFN's gradients
    by 1e-3 of their norm, where a cotangent summed over the group (x 2)
    or a missing all-reduce moves them by 0.5 or more. AdamW moves an
    element by about lr whatever its gradient's size, so where a gradient
    lies within the summation noise of 0 the element may step the other
    way: the parameters are held within 2 x lr x steps, and the share more
    than 1e-5 away is printed."""
    cfg, base, batches = _tp_small(dev)
    ref, _, _, _ = _tp_steps(cfg, base, batches, SingleDevice())
    with contextlib.ExitStack() as stack:
        os.environ["TPUKIT_FUSED_HEAD"] = "0"
        stack.callback(os.environ.pop, "TPUKIT_FUSED_HEAD")
        plain, plain_params, _, plain_grads = _tp_steps(cfg.replace(fuse_qkv=False), base,
                                                        batches, SingleDevice())
    losses, params, flash, _ = _tp_steps(cfg, base, batches, TensorParallel())
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    equal = [torch.equal(a, b) for a, b in zip(params, plain_params)]
    print(f"tp (world of one): losses {losses} vs single {ref}: worst relative difference "
          f"{worst:.3e} (bar 1e-4); bit-equal to the unfused single step: losses "
          f"{losses == plain}, parameters {sum(equal)} of {len(equal)} leaves; flash forward "
          f"launches {flash}", flush=True)
    if not worst <= 1e-4 or not all(equal) or flash != 2 * len(batches):
        raise AssertionError(f"tp and single-device steps disagree: {losses} vs {ref}; "
                             f"{len(equal) - sum(equal)} leaves differ; flash {flash}")
    t0 = time.perf_counter()
    got = gloo_pair("--tp-gloo-rank", "chip_smoke_tp_gloo")
    losses = got["losses"].tolist()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    gerr = max(float(np.linalg.norm(got[f"g{i}"] - g.cpu().numpy()) / g.norm())
               for i, g in enumerate(plain_grads) if g.norm() > 0)
    diffs = [np.abs(got[f"p{i}"] - t.cpu().numpy()) for i, t in enumerate(plain_params)]
    perr = max(float(d.max()) for d in diffs)
    far = sum(int((d > 1e-5).sum()) for d in diffs) / sum(d.size for d in diffs)
    bound = 2 * 1e-4 * len(batches)
    print(f"tp model 2 over two gloo ranks on this card ({time.perf_counter() - t0:.1f} s): "
          f"first step's gradients within {gerr:.3e} of each leaf's norm (bar 1e-2); "
          f"losses {losses} vs single {ref}: worst relative difference {worst:.3e} (bar "
          f"1e-4); parameters within {perr:.3e} (bar {bound:.0e}), share beyond 1e-5 "
          f"{far:.3e}; rank 0's flash forward launches {int(got['flash'])} (6 of 12 heads "
          f"each)", flush=True)
    if (not gerr <= 1e-2 or not worst <= 1e-4 or not perr <= bound
            or int(got["flash"]) != 2 * len(batches)):
        raise AssertionError(f"model-2 TP over gloo disagrees with the single device: "
                             f"gradients {gerr}, losses {losses} vs {ref}, parameters {perr}, "
                             f"flash {int(got['flash'])}")


def tp_serving(dev, fused32: dict, moe32: dict) -> dict:
    """Phase 33: dense serving through the serving grid, as
    `python -m tpukit_torch.serve` builds it: `serving_grid` (tpukit's
    `pick_serve_grid` for a dense model, the slots' largest data degree
    for MoE) -> `create_tp_mesh` -> `TensorParallel(mesh=...).setup` ->
    `ServeEngine(..., mesh=...)`, whose fused decode ticks call
    `fused_paged_attention`. Phase 4's stream (bf16, 12 layers): each
    paged kernel launches layers x decode ticks times; f32 4 layers: paged
    fused and ring greedy tokens equal phase 5's fused tokens; the MoE
    model (8 experts, pallas) over its data grid gives phase 15's."""
    tok_flags = lambda **kw: serve_main.parse_flags(
        ["--heads", str(GPT2_SMALL_TRAIN["heads"]), "--slots", str(SERVE_SHAPE["slots"]),
         "--page_size", str(SERVE_SHAPE["page_size"])]
        + [f"--{k}={v}" for k, v in kw.items()])

    def on_grid(params, cfg, serve, reqs, eos, flags):
        grid = serve_main.serving_grid(flags, mesh_lib.world_size())
        grid_mesh = mesh_lib.create_tp_mesh(grid["data"], grid["model"], "cuda")
        if cfg.num_experts == 0:
            params = TensorParallel(mesh=grid_mesh).setup(params)
        engine = ServeEngine(params, cfg, serve, eos_id=eos, device=dev, mesh=grid_mesh)
        t0 = time.perf_counter()
        outs = {c.rid: np.asarray(c.ids) for c in engine.run(list(reqs))}
        torch.cuda.synchronize()
        return engine, outs, time.perf_counter() - t0, grid

    cfg, params, serve, reqs, eos = build(dev, fused=True)
    # the warm-up run, phase 43's trace of the serving grid's decode
    reset_counts()
    with comm_ir.record_comm() as trace:
        warm_engine, _, _, warm_grid = on_grid(params, cfg, serve, reqs[:4], eos, tok_flags())
    audit = dict(trace=trace, ticks=warm_engine.steps,
                 plan=decode_comm_plan(warm_engine.cfg, warm_grid, serve.slots,
                                       paged=serve.paged),
                 counts={k: v for k, v in read_counts().items() if k.startswith("paged_")},
                 layers=cfg.num_layers)
    del warm_engine
    reset_counts()
    engine, outs, wall, grid = on_grid(params, cfg, serve, reqs, eos, tok_flags())
    counts = {k: v for k, v in read_counts().items() if k.startswith("paged_")}
    paged = paged_want(cfg.num_layers * engine.steps)
    check_outputs(outs, reqs, cfg)
    print(f"serving grid {grid} (TensorParallel): {_split(engine, wall)}; paged launches "
          f"{counts} (want {paged})", flush=True)
    if counts != paged or engine.steps == 0:
        raise AssertionError(f"TP serving's paged launches {counts} != {paged}")
    cfg32, params32, serve32, reqs32, _ = build(dev, fused=True, num_layers=4,
                                                compute_dtype=torch.float32)
    runs = {"fused": fused32}
    for label, kw, flags in (("tp paged fused", {}, tok_flags()),
                             ("tp ring", dict(page_size=0, prefill_chunk=0, fused_decode=False),
                              tok_flags(page_size=0))):
        runs[label] = on_grid(params32, cfg32, dataclasses.replace(serve32, **kw), reqs32, eos,
                              flags)[1]
        check_outputs(runs[label], reqs32, cfg32)
    _same_tokens(runs, "fused", [r.rid for r in reqs32], "f32 greedy (phase 5's fused engine)")
    mcfg, mparams, mserve, mreqs, _ = build(dev, fused=True, num_layers=4,
                                            compute_dtype=torch.float32, num_experts=8)
    reset_counts()
    moe = on_grid(mparams, mcfg, mserve, mreqs, eos, tok_flags(num_experts=8,
                                                                moe_dispatch="pallas"))
    moe_up = read_counts()["moe_forward_up_f32"]  # f32 compute: the f32 instance
    forwards = moe[0].last_summary["prefill_dispatches"] + moe[0].steps
    _same_tokens({"grid": moe[1], "phase 15": moe32}, "phase 15", [r.rid for r in mreqs],
                 "MoE f32 greedy")
    print(f"f32 greedy on the grid == phase 5's fused engine, paged fused and ring, on all "
          f"{len(reqs32)} requests; MoE over the data grid {moe[3]} == phase 15's, grouped "
          f"forward launches {moe_up} = {mcfg.num_layers} layers x {forwards} forwards",
          flush=True)
    if moe_up != mcfg.num_layers * forwards:
        raise AssertionError(f"MoE on the data grid: grouped forward launches {moe_up} != "
                             f"{mcfg.num_layers} x {forwards}")
    return dict(counts=counts, tokens_per_s=engine.last_summary["generated_tokens"] / wall,
                moe_forward_up=moe_up, audit=audit)

# phase 34's shapes, the rung's 32768 tokens a step: the ring at one rank
# attends one diagonal hop over the whole sequence, f32 scores [B, 12, S,
# S], so a long sequence at a small batch does not fit; S_l = 2048 is what
# four cards see at S 8192. Ulysses keeps no S x S: batch 4 x S 8192, the
# flash kernels at main-ring.py's own example's length.
CP_SHAPES = {"ring": (16, 2048), "ulysses": (4, 8192)}


def cp_full_width(dev, single_run: dict) -> dict:
    """Phase 34: the rung under `ContextParallel` in the world of one `main`
    brought up, the ring at batch 16 x S 2048 and Ulysses at batch 4 x S
    8192 (8 steps each), checked as phase 7 checks its own (the CE kernels
    as phase 7's, the flash kernels 12 times a step each under Ulysses and
    never under the ring, whose hops are plain PyTorch); step wall,
    tokens/s and peak beside phase 7's."""
    runs = {}
    for attention, (batch, seq) in CP_SHAPES.items():
        strategy = ContextParallel(attention=attention)
        run = train_full_width(dev, strategy, batch=batch, seq=seq)
        del run["state"], strategy
        _free()
        steps, c = len(run["losses"]), run["counts"]
        print(f"cp {attention} (batch {batch} x S {seq}): {run['wall']:.4f} s a step "
              f"({single_run['wall']:.4f} single, {run['wall'] / single_run['wall']:.4f}x), "
              f"{batch * seq / run['wall']:.1f} tokens/s, peak {run['peak']} B "
              f"({single_run['peak']} single, {run['peak'] / single_run['peak']:.4f}x); "
              f"launches a step: flash forward {c['flash_forward'] // steps}, backward "
              f"{sum(c[f'flash_backward_{k}'] for k in ('dcap', 'dkv', 'dq')) // steps}, CE "
              f"forward {c['ce_forward'] // steps} (+ {c['ce_forward_combine'] // steps} "
              f"combine), backward {c['ce_backward_dw'] // steps} chunks x 4", flush=True)
        runs[attention] = run
    return runs


def _cp_small(dev):
    """Phase 8's f32 2-layer setup with a position table of 513, so that
    its 512-token batches divide over two sequence ranks as tpukit's CP
    checks them (sequence_length - 1)."""
    return _tp_small(dev, max_position_embeddings=SEQ + 1)


def cp_equals_single(dev) -> None:
    """Phase 35: phase 8's setup (f32, 2 layers, 4 AdamW steps) under
    `ContextParallel` against `SingleDevice`. In the world of one: Ulysses
    bit-equal in losses and parameters (its all-to-alls are the identity,
    and its local attention the same flash kernels), the ring's losses
    within rtol 1e-4 (its hops are f32 plain PyTorch, the single step's
    attention the flash kernels). Then Ulysses seq 2 over two gloo ranks
    on this card (`chip_smoke.py --cp-gloo-rank R`: gloo carries the
    all-to-all and the all-gather of CUDA tensors, not their point-to-point
    sends, so the ring of two ranks runs on four cards only): each rank's
    6 heads through the flash kernels at the full sequence; the first
    step's gradient each leaf within 1e-2 of its norm, losses within rtol
    1e-4, parameters within 2 x lr x steps, as phase 31 holds TP (the
    CE's and the gradients' sums run over two ranks' tokens)."""
    cfg, base, batches = _cp_small(dev)
    ref, ref_params, _, ref_grads = _tp_steps(cfg, base, batches, SingleDevice())
    uly, uly_params, uly_flash, _ = _tp_steps(cfg, base, batches,
                                              ContextParallel(attention="ulysses"))
    ring, _, ring_flash, _ = _tp_steps(cfg, base, batches, ContextParallel())
    equal = [torch.equal(a, b) for a, b in zip(uly_params, ref_params)]
    worst = max(abs(a - b) / abs(b) for a, b in zip(ring, ref))
    print(f"cp (world of one): ulysses losses {uly} vs single {ref}: bit-equal losses "
          f"{uly == ref}, parameters {sum(equal)} of {len(equal)} leaves; flash forward "
          f"launches {uly_flash}; ring losses {ring}: worst relative difference {worst:.3e} "
          f"(bar 1e-4), flash launches {ring_flash}", flush=True)
    if uly != ref or not all(equal) or uly_flash != 2 * len(batches):
        raise AssertionError(f"Ulysses at one rank is not the single step: {uly} vs {ref}; "
                             f"{len(equal) - sum(equal)} leaves differ; flash {uly_flash}")
    if not worst <= 1e-4 or ring_flash != 0:
        raise AssertionError(f"the ring at one rank and the single step disagree: {ring} vs "
                             f"{ref}; flash {ring_flash}")
    t0 = time.perf_counter()
    got = gloo_pair("--cp-gloo-rank", "chip_smoke_cp_gloo")
    losses = got["losses"].tolist()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    gerr = max(float(np.linalg.norm(got[f"g{i}"] - g.cpu().numpy()) / g.norm())
               for i, g in enumerate(ref_grads) if g.norm() > 0)
    diffs = [np.abs(got[f"p{i}"] - t.cpu().numpy()) for i, t in enumerate(ref_params)]
    perr = max(float(d.max()) for d in diffs)
    bound = 2 * 1e-4 * len(batches)
    print(f"cp ulysses seq 2 over two gloo ranks on this card ({time.perf_counter() - t0:.1f} "
          f"s): first step's gradients within {gerr:.3e} of each leaf's norm (bar 1e-2); losses "
          f"{losses} vs single {ref}: worst relative difference {worst:.3e} (bar 1e-4); "
          f"parameters within {perr:.3e} (bar {bound:.0e}); rank 0's flash forward launches "
          f"{int(got['flash'])} (6 of 12 heads at S 512)", flush=True)
    if (not gerr <= 1e-2 or not worst <= 1e-4 or not perr <= bound
            or int(got["flash"]) != 2 * len(batches)):
        raise AssertionError(f"Ulysses seq 2 over gloo disagrees with the single device: "
                             f"gradients {gerr}, losses {losses} vs {ref}, parameters {perr}, "
                             f"flash {int(got['flash'])}")


GLOO_FLAGS = ("--tp-gloo-rank", "--cp-gloo-rank", "--ep-gloo-rank", "--dp-gloo-rank")
QUANT_EXCHANGES = ("int8", "bf16")  # phase 38's payloads of phase 37's exchange


EP_STEPS = 2  # phase 37's (and phase 38's exchanges') steps over two gloo ranks (4 until
#               the serving records of phase 45 came)


def _ep_small(dev):
    """Phase 12's f32 2-layer MoE setup at GPT-2-small width, with 4
    experts, top-2: (cfg, base parameters, EP_STEPS batches of 4 rows, one
    padded)."""
    cfg, base = build_train(dev, num_layers=2, compute_dtype=torch.float32,
                            attention_impl="flash", seed=2, num_experts=4, router_top_k=2)
    rng = np.random.RandomState(2)
    batches = [to_device(*synthetic_batch(rng, cfg.vocab_size, 4, SEQ, pad_rows=1), dev)
               for _ in range(EP_STEPS)]
    return cfg, base.params, batches


def _rows_of(batch, rank: int, ranks: int):
    """This rank's rows of a (model batch, targets) pair, as the grid splits
    them: `[rank B / ranks, (rank + 1) B / ranks)`."""
    model_batch, targets = batch
    n = targets.shape[0] // ranks
    take = slice(rank * n, (rank + 1) * n)
    return {k: v[take] for k, v in model_batch.items()}, targets[take]


def ep_equals_single(dev) -> dict:
    """Phase 37: one step of the gpt-small-dim768-e8 rung (bf16, the
    meshless dropless pallas dispatch, batch 32) under `DataParallel` in
    the world of one `main` brought up, bit-equal to `SingleDevice`'s from
    the same parameters on the same batch (one rank reduces nothing; its
    aux statistics are its own). Then `ExpertParallel` on (data 1, expert
    2) over two gloo ranks on this card (`chip_smoke.py --ep-gloo-rank R`:
    each rank 2 of 4 experts through the grouped kernels after the
    all-to-all, the trunk gathered by an all-gather and its gradients
    reduce-scattered) against the single device's `ExpertParallel` 1 x 1
    step with the same pallas dispatch, phase 12's f32 setup (2 layers,
    top-2, EP_STEPS AdamW steps, 4 rows a step): the first step's gradient each
    leaf within 1e-3 of its norm and the losses within rtol 1e-4 (phase
    12's bars), the parameters within 2 x lr x steps (AdamW's bound on an
    update whose sign flips), and each rank's grouped forward and backward
    kernels launched layers x steps times. Returns rank 0's launches."""
    rows, moe, _ = RUNGS["gpt-small-dim768-e8"]
    cfg, base = build_train(dev, moe_dispatch="pallas", **moe)
    batch = to_device(*synthetic_batch(np.random.RandomState(3), cfg.vocab_size, rows, SEQ,
                                       pad_rows=4), dev)
    stepped = {}
    for make in (SingleDevice, DataParallel):
        strategy = make()
        params = unflatten(base.params, [t.detach().clone() for t in leaves(base.params)])
        state = create_train_state(params, 1e-4, strategy)
        reset_counts()
        loss = float(train_step(state, cfg, strategy, *batch))
        up = read_counts()["moe_forward_up"]
        stepped[strategy.name] = (loss, [p.detach().clone() for p in leaves(state.params)], up)
        del params, state, strategy
        _free()
    del base
    _free()
    (loss, ref, up), (dloss, got, dup) = stepped["single"], stepped["ddp"]
    equal = [torch.equal(a, b) for a, b in zip(got, ref)]
    print(f"e8 step under DataParallel (world of one, NCCL): loss {dloss} vs single {loss}, "
          f"parameters bit-equal in {sum(equal)} of {len(equal)} leaves; grouped forward "
          f"launches {dup} (single {up})", flush=True)
    if dloss != loss or not all(equal) or dup != up or up != cfg.num_layers:
        raise AssertionError(f"the e8 step under DataParallel is not the single step: {dloss} "
                             f"vs {loss}, {len(equal) - sum(equal)} leaves differ, launches "
                             f"{dup} vs {up}")
    del stepped, ref, got
    _free()
    cfg, base, batches = _ep_small(dev)
    ref, ref_params, _, ref_grads = _tp_steps(cfg, base, batches,
                                              ExpertParallel(dispatch="pallas"))
    t0 = time.perf_counter()
    got = gloo_pair("--ep-gloo-rank", "chip_smoke_ep_gloo")
    losses = got["losses"].tolist()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    gerr = max(float(np.linalg.norm(got[f"g{i}"] - g.cpu().numpy()) / g.norm())
               for i, g in enumerate(ref_grads) if g.norm() > 0)
    diffs = [np.abs(got[f"p{i}"] - t.cpu().numpy()) for i, t in enumerate(ref_params)]
    perr = max(float(d.max()) for d in diffs)
    bound = 2 * 1e-4 * len(batches)
    counts = {k[len("count/moe_"):]: int(v) for k, v in got.items()
              if k.startswith("count/moe_")}
    want = cfg.num_layers * len(batches)
    grouped = ("forward_up_f32", "forward_down_f32", "backward_dh_f32", "backward_dx_f32",
               "backward_dwu_f32", "backward_dwd_f32")
    print(f"ep (data 1, expert 2) over two gloo ranks on this card ({time.perf_counter() - t0:.1f}"
          f" s): first step's gradients within {gerr:.3e} of each leaf's norm (bar 1e-3); losses "
          f"{losses} vs single {ref}: worst relative difference {worst:.3e} (bar 1e-4); "
          f"parameters within {perr:.3e} (bar {bound:.0e}); rank 0's grouped launches "
          f"{ {k: counts[k] for k in grouped} } (2 of 4 experts, want {want} each)", flush=True)
    if (not gerr <= 1e-3 or not worst <= 1e-4 or not perr <= bound
            or any(counts[k] != want for k in grouped)):
        raise AssertionError(f"EP over gloo disagrees with the single device: gradients {gerr}, "
                             f"losses {losses} vs {ref}, parameters {perr}, launches {counts}")
    return dict(counts=counts, got=got, ref=ref, steps=len(batches), layers=cfg.num_layers)


QUANT_FULL = {  # phase 38's full-width runs: label -> (strategy, config fields)
    "ddp int8": (DataParallel, dict(comm_dtype="int8")),
    "fsdp int8": (FSDP, dict(comm_dtype="int8")),
    "ddp f32 buckets 4": (DataParallel, dict(grad_buckets=4)),
    "fsdp f32 buckets 4": (FSDP, dict(grad_buckets=4)),
}
EP_FIRST_STEP_TOL, FINAL_LOSS_TOL = 1e-2, 2e-2  # tests/test_quant_comm.py's EP gate
BUCKET_TOL = (1e-7, 1e-5)  # (atol, rtol): GRAD_TOL of tests/test_torch_distributed.py
QUANT_AUDITED = ("ddp int8", "fsdp f32 buckets 4")  # phase 43's traces of phase 38's warm-ups


def quant_full_width(dev, single_run: dict) -> dict:
    """Phase 38 a: phase 7's steps (8, the rung, bf16) under `DataParallel`
    and `FSDP` in the world of one `main` brought up, at `--comm_dtype
    int8` (DataParallel's hand-placed wire quantizes at one rank too) and
    at f32 with `--grad_buckets 4`, each checked as phase 7 checks its own
    (the loss falls on a repeated batch; the flash and CE kernels launch as
    in phase 7); the step wall, tokens/s and peak beside phase 7's."""
    runs = {}
    for label, (make, comm) in QUANT_FULL.items():
        run = train_full_width(dev, make(), comm=comm, audit=label in QUANT_AUDITED)
        run.pop("state")
        runs[label] = run
        _free()
    for label, run in runs.items():
        print(f"{label}: {run['wall']:.4f} s a step ({single_run['wall']:.4f} single, "
              f"{run['wall'] / single_run['wall']:.4f}x), {BATCH * SEQ / run['wall']:.1f} "
              f"tokens/s, peak {run['peak']} B ({single_run['peak']} single)", flush=True)
    return runs


def _two_shot_in_process(cfg, base, batch, ranks: int = 2):
    """The first step of `DataParallel` at `--comm_dtype int8` over `ranks`
    ranks, computed in this process (the same step, rank by rank): each
    rank's local objective (its rows' CE sum over the whole batch's valid
    tokens) differentiated, the payloads flattened in tpukit's order and
    cut into `[ranks, chunk]` rows, each destination's rows packed,
    dequantized and summed in rank order, re-packed and unpacked. Returns
    (loss, gradients in `leaves` order, each element's bar: one
    quantization step of its block on each hop, every rank's wire row and
    the reduced one, plus `tests/test_torch_distributed.py`'s GRAD_TOL
    allowance (atol 1e-7, rtol 1e-5) for the ranks' local gradients)."""
    tree = unflatten(base, [t.detach().clone().requires_grad_(True) for t in leaves(base)])
    count = (batch[1] != -100).sum().float()
    flats, loss = [], 0.0
    for r in range(ranks):
        b, t = _rows_of(batch, r, ranks)
        loss_sum, _, _ = SingleDevice().loss_sums(tree, cfg, b, t)
        objective = loss_sum / count
        loss += float(objective.detach())
        grads = unflatten(tree, torch.autograd.grad(objective, leaves(tree)))
        flats.append(torch.cat([g.reshape(-1) for _, g in quant_comm.sorted_items(grads)]))
    parts = [quant_comm._rows_of(f, ranks) for f in flats]
    chunk = parts[0].shape[1]
    packed = [quant_comm.pack_quantized(p) for p in parts]
    rows = []
    for j in range(ranks):
        recv = torch.stack([packed[r][j] for r in range(ranks)])
        red = quant_comm._sum_rows(quant_comm.unpack_dequantized(recv, chunk))
        rows.append(quant_comm.pack_quantized(red[None])[0])
    res = quant_comm.unpack_dequantized(torch.stack(rows), chunk)

    def steps(rows):  # each element's `amax / 127` of its block in wire rows [ranks, chunk]
        blocks = torch.nn.functional.pad(rows.abs(), (0, -chunk % quant_comm.DEFAULT_BLOCK))
        blocks = blocks.reshape(ranks, -1, quant_comm.DEFAULT_BLOCK).amax(-1) / 127.0
        return blocks.repeat_interleave(quant_comm.DEFAULT_BLOCK, dim=1)[:, :chunk].reshape(-1)

    # one step of each hop: every rank's row and the reduced one; plus
    # GRAD_TOL's allowance for the ranks' local gradients
    step = steps(res) + sum(steps(p) for p in parts) + 1e-7 + 1e-5 * res.abs().reshape(-1)
    order = {"/".join(path): i for i, (path, _) in enumerate(quant_comm.sorted_items(base))}
    sizes = [leaf.numel() for _, leaf in quant_comm.sorted_items(base)]
    offs = np.cumsum([0] + sizes)
    names = ckpt_lib.paths(base)
    out_g, out_s = [], []
    flat, flat_step = res.reshape(-1), step
    for name, leaf in zip(names, leaves(base)):
        i = order[name]
        out_g.append(flat[offs[i]:offs[i + 1]].view(leaf.shape))
        out_s.append(flat_step[offs[i]:offs[i + 1]].view(leaf.shape))
    return loss, out_g, out_s


def quant_gloo_and_ep(dev, ep: dict) -> dict:
    """Phase 38 b and c. DataParallel at `--comm_dtype int8` over two gloo
    ranks on this card (`chip_smoke.py --dp-gloo-rank R`, phase 8's f32
    2-layer setup, 4 rows a step, 2 a rank) against the same step computed
    in this process (`_two_shot_in_process`), at the CPU tests' bars: the
    first step's loss within 1e-5, each gradient element within one
    quantization step of its block on each hop plus GRAD_TOL (the count
    of bit-equal elements is printed); each rank's flash and CE kernels
    launched as its steps ask.
    Then phase 37's `ExpertParallel` (data 1, expert 2) with an int8 and a
    bf16 exchange (the same spawn): each rank's grouped kernels launched
    layers x steps times, and the losses against the f32 exchange's within
    the EP band of `tests/test_quant_comm.py` (the first step 1e-2, every
    step 2e-2). Returns rank 0's launches of each.
    The same two ranks then run DataParallel at f32 with one bucket (the
    blocking step) and with 4 (the bucket wires issued from the backward,
    `ops/deferred.py`, which runs only on two ranks or more): the deferred
    step taken in the first gradient and in every step, the flash and CE
    launches as the int8 run's, the first gradients and the losses of the
    two within BUCKET_TOL and the parameters within AdamW's 2 x lr x steps
    (all bit-equal on the CPU, where `tests/test_torch_distributed.py`
    holds them; the count of bit-equal elements is printed)."""
    cfg, base, batches = _tp_small(dev)
    qcfg = cfg.replace(comm_dtype="int8")
    loss, ref_g, ref_step = _two_shot_in_process(qcfg, base, batches[0])
    t0 = time.perf_counter()
    got = gloo_pair("--dp-gloo-rank", "chip_smoke_dp_gloo")
    wall = time.perf_counter() - t0
    losses = got["losses"].tolist()
    worst, equal, total = 0.0, 0, 0
    for i, (g, st) in enumerate(zip(ref_g, ref_step)):
        mine = torch.from_numpy(got[f"g{i}"]).to(g.device)
        over = (mine - g).abs() - st
        worst = max(worst, float(over.max()))
        equal += int((mine == g).sum())
        total += g.numel()
    counts = {k[len("count/"):]: int(v) for k, v in got.items() if k.startswith("count/")}
    steps = len(batches)
    want = dict(flash_forward=cfg.num_layers * steps, ce_forward_f32=steps)
    print(f"ddp int8 over two gloo ranks on this card ({wall:.1f} s): first loss "
          f"{losses[0]} vs {loss} in one process (bar 1e-5); gradients bit-equal in {equal} "
          f"of {total} elements, the worst excess over the bar {worst:.3e} (must be <= 0); "
          f"losses of {steps} steps {losses}; rank 0's launches flash_forward "
          f"{counts['flash_forward']}, ce_forward_f32 {counts['ce_forward_f32']} (want {want})",
          flush=True)
    if (not abs(losses[0] - loss) <= 1e-5 or worst > 0
            or any(counts[k] != v for k, v in want.items())):
        raise AssertionError(f"DataParallel int8 over gloo disagrees with the step in one "
                             f"process: loss {losses[0]} vs {loss}, excess {worst}, "
                             f"launches {counts}")
    b1_losses, b4_losses = got["b1/losses"].tolist(), got["b4/losses"].tolist()
    worst, drift, equal, total = 0.0, 0.0, 0, 0
    for key in ["losses"] + [f"g{i}" for i in range(len(ref_g))]:
        a, b = got[f"b4/{key}"], got[f"b1/{key}"]
        worst = max(worst, float((np.abs(a - b) - BUCKET_TOL[1] * np.abs(b)).max()))
        equal += int((a == b).sum())
        total += a.size
    for key in [k[3:] for k in got if k.startswith("b1/p")]:
        a, b = got[f"b4/{key}"], got[f"b1/{key}"]
        drift = max(drift, float(np.abs(a - b).max()))
        equal += int((a == b).sum())
        total += a.size
    b4_counts = {k: int(got[f"b4/count/{k}"]) for k in want}
    print(f"ddp f32 over two gloo ranks, 4 buckets from the backward against one bucket: "
          f"{int(got['b4/bucket_steps'])} deferred bucket steps (want {steps + 1}); losses "
          f"{b4_losses} vs {b1_losses}; first gradients and parameters bit-equal in {equal} "
          f"of {total} elements, the worst excess of losses and gradients over rtol "
          f"{BUCKET_TOL[1]} {worst:.3e} (bar {BUCKET_TOL[0]}), parameters within {drift:.3e} "
          f"(AdamW's bar 2 x lr x steps {2e-4 * steps:.0e}); launches {b4_counts} (want "
          f"{want})", flush=True)
    if (int(got["b4/bucket_steps"]) != steps + 1 or int(got["b1/bucket_steps"]) != 0
            or not worst <= BUCKET_TOL[0] or not drift <= 2e-4 * steps or b4_counts != want):
        raise AssertionError(f"DataParallel's deferred bucket step disagrees with the blocking "
                             f"one: excess {worst}, launches {b4_counts}, bucket steps "
                             f"{got['b4/bucket_steps']} / {got['b1/bucket_steps']}")
    ref = ep["got"]["losses"].tolist()
    grouped = ("forward_up_f32", "forward_down_f32", "backward_dh_f32", "backward_dx_f32",
               "backward_dwu_f32", "backward_dwd_f32")
    ep_want = ep["layers"] * ep["steps"]
    out = {"ddp_int8_gloo": {k: counts[k] for k in want},
           "dp_gloo_audit": json.loads(str(got["audit"]))}
    for comm in QUANT_EXCHANGES:
        q = ep["got"][f"{comm}/losses"].tolist()
        c = {k[len(f"{comm}/count/moe_"):]: int(v) for k, v in ep["got"].items()
             if k.startswith(f"{comm}/count/moe_")}
        first, every = abs(q[0] - ref[0]), max(abs(a - b) for a, b in zip(q, ref))
        print(f"ep (data 1, expert 2) {comm} exchange over two gloo ranks: losses {q} vs the "
              f"f32 exchange's {ref}: first step {first:.3e} (bar {EP_FIRST_STEP_TOL}), every "
              f"step within {every:.3e} (bar {FINAL_LOSS_TOL}); rank 0's grouped launches "
              f"{ {k: c[k] for k in grouped} } (want {ep_want} each)", flush=True)
        if (not first < EP_FIRST_STEP_TOL or not every < FINAL_LOSS_TOL
                or any(c[k] != ep_want for k in grouped) or q == ref):
            raise AssertionError(f"EP with an {comm} exchange: losses {q} vs {ref}, launches {c}")
        out[f"ep_{comm}"] = {k: c[k] for k in grouped}
    return out


# phase 18's recipe 2 writes its JSONL here, with phase 43's `kind="xla"` records
XLA_LOG = ROOT / "build" / "chip_smoke_ddp" / "run.jsonl"
XLA_KEYS = {"kind", "fn", "strategy", "backend", "expected_comm_ops", "hlolint", "flops",
            "bytes_accessed", "transcendentals", "memory", "collectives"}  # tpukit's, :905


def _audit_verdict(name: str, measured: dict, plan_ops: dict | None, exhaustive: bool,
                   findings: list) -> list:
    """Phase 43's bars on one trace: the measured collectives equal the
    plan's (every kind, for an exhaustive plan) and lint finds no error,
    the overlap gate's included. Returns the gate's findings."""
    if plan_ops is not None:
        for op, want in plan_ops.items():
            got = measured.get(op, {"count": 0, "bytes": 0})
            if got != want:
                raise AssertionError(f"{name}: {op} measured {got} != planned {want}")
        if exhaustive and set(measured) - set(plan_ops):
            raise AssertionError(f"{name}: unplanned collectives {measured} (plan {plan_ops})")
    errors = [f for f in findings if f["severity"] == "error"]
    if errors:
        raise AssertionError(f"{name}: comm audit errors {errors}")
    return [f for f in findings if f["rule"] == "overlap" and "declared" in f.get("data", {})]


def comm_audit_and_tokenizer(dev, audits: dict, gloo: dict, smi: str) -> dict:
    """Phase 43: the comm audit and the native tokenizer on the card.

    (a) The traces phases 11, 33 and 38 recorded (no timed step is
    touched): a ninth step of phase 38's DDP at `--comm_dtype int8` and
    FSDP f32 at `--grad_buckets 4` (the rung, NCCL, a world of one), the
    warm-up of phase 11's e8 rung under EP 1 x 1 and of phase 33's serving
    grid decode (a whole warm-up run of 4 requests, against the per-tick
    plan, exhaustive); and rank 0 of phase 38's DDP int8 over two gloo
    ranks (its first `value_and_grad`). Each: the measured collectives
    equal the plan; `lint_trace` finds no error, the overlap gate's
    included; the kernels' launches those of the phase's
    steps (a dense step phase 7's share, the e8 step phase 11's, a decode
    tick's paged kernels phase 33's rate). What the audit costs: the
    recorded ninth step's wall beside the timed steps' mean, and the
    lint's own milliseconds.
    (b) Phase 18's recipe 2 (`train.fit`, NCCL world of one) wrote
    `kind="xla"` records with tpukit's keys for `train_step` and
    `eval_step`; `tools/report.py` exits 0 on its JSONL and renders them.
    (c) The native tokenizer builds (`native.is_available()`), and its ids
    and masks equal the Python encoder's on the fixture corpus byte for
    byte, through `WordTokenizer` (the native path taken: `native.encodes`
    moves); both encoders' walls."""
    rows = []
    for name, a in audits.items():
        t0 = time.perf_counter()
        findings = [f.to_record() for f in lint_trace(a["trace"], plan=a["plan"])]
        lint_ms = (time.perf_counter() - t0) * 1e3
        plan = a["plan"]
        measured = comm_ir.collective_summary(a["trace"])
        gate = _audit_verdict(name, measured, None if plan is None else plan.ops,
                              plan is not None and plan.exhaustive, findings)
        want = a["want"]
        if a["counts"] != want:
            raise AssertionError(f"{name}: launches {a['counts']} != {want}")
        cost = (f"; the recorded step {a['wall']:.4f} s against the timed steps' mean "
                f"{a['timed_wall']:.4f} s ({a['wall'] / a['timed_wall']:.4f}x)"
                if "timed_wall" in a else "")
        print(f"{name}: measured {measured}, planned {None if plan is None else plan.ops}; "
              f"{len(findings)} findings, {len(gate)} gate; {a['trace'].ops} ATen ops, "
              f"{a['trace'].backward_ops()} in the backward; lint {lint_ms:.2f} ms{cost}; "
              f"launches as the phase's ({sum(want.values())})", flush=True)
        rows.append(name)
    g = gloo
    gate = _audit_verdict("ddp int8, 2 gloo ranks (rank 0)", g["measured"], g["plan"], False,
                          g["findings"])
    want = {"flash_forward": 2, "ce_forward_f32": 1}
    if {k: g["counts"][k] for k in want} != want:
        raise AssertionError(f"gloo ddp int8: launches {g['counts']} != {want}")
    print(f"ddp int8 over two gloo ranks (rank 0): measured {g['measured']} == planned "
          f"{g['plan']}; {len(g['findings'])} findings; launches {want}", flush=True)

    records = [json.loads(line) for line in XLA_LOG.read_text().splitlines()]
    xla = [r for r in records if r["kind"] == "xla"]
    if [r["fn"] for r in xla] != ["train_step", "eval_step"] or any(
            set(r) - {"time", "a2a_expected", "quant_grad_expected", "comm_dtype"} != XLA_KEYS
            for r in xla):
        raise AssertionError(f"recipe 2's xla records: {xla}")
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "report.py"), str(XLA_LOG)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or "== xla static analysis: train_step [ddp] ==" not in proc.stdout:
        raise AssertionError(f"tools/report.py on recipe 2's JSONL: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    print(f"recipe 2's xla records: {[(r['fn'], r['collectives'], r['hlolint']) for r in xla]}; "
          f"tools/report.py exit 0", flush=True)

    if not native.is_available():
        raise AssertionError(f"the native tokenizer did not build: {native.build_error()}")
    tok, plain = get_tokenizer(), get_tokenizer()
    plain._native = None  # the Python encoder
    from tpukit_torch.data import _fixture_corpus

    texts = [t for part in _fixture_corpus() for t in part]
    before = native.encodes
    t0 = time.perf_counter()
    got = tok(texts, padding="max_length", max_length=SEQ, truncation=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = plain(texts, padding="max_length", max_length=SEQ, truncation=True)
    python_s = time.perf_counter() - t0
    same = all(got[k].tobytes() == ref[k].tobytes() for k in ("input_ids", "attention_mask"))
    print(f"native tokenizer ({native.library_path().parent.name}): {len(texts)} fixture "
          f"stories at max_length {SEQ}: native {native_s * 1e3:.2f} ms, Python "
          f"{python_s * 1e3:.2f} ms ({python_s / native_s:.1f}x); ids and masks byte-equal: "
          f"{same}; native batches {native.encodes - before} ({smi})", flush=True)
    if not same or native.encodes != before + 1:
        raise AssertionError(f"native tokenizer: equal {same}, batches "
                             f"{native.encodes - before}")
    return dict(audited=rows, native_ms=native_s * 1e3, python_ms=python_s * 1e3)


BENCH_STEPS = 2  # phase 44: the bench twin's windows, 2 steps each
OVERLAP_ROW_KEYS = ["strategy", "comm_dtype", "grad_buckets", "step_time_s",
                    "tokens_per_sec_per_chip", "bytes_match", "overlap",
                    "involuntary_remat_warnings", "final_loss"]  # tpukit bench.py :1577-1587


def bench_twin_on_card(dev, smi: str) -> dict:
    """Phase 44: the bench twin (`tpukit_torch.bench`) in a world of one
    over NCCL, at tpukit's bench config (dim 256, 8 layers, S 255, GPT-2
    vocab, bf16, batch 64): (a) the headline's step (one recorded step, two
    warm-up steps, one window of BENCH_STEPS), whose `kind="xla"` record has
    tpukit's keys and a clean lint, the flash and CE kernels launching as a
    step of it needs (the layers' flash launches and `ce_want` a step);
    (b) `comm_overlap` at BENCH_STEPS: nine rungs with tpukit's row keys and
    no error; FSDP's three rungs (f32, int8, int8 with 4 buckets: no wire
    at a world of one, where the bucket step defers nothing) the same
    final loss, bit for bit."""
    from tpukit_torch import bench
    from tpukit_torch.bench import __main__ as bench_main

    cfg = bench_main.bench_config()
    steps = 1 + 2 + BENCH_STEPS
    reset_counts()
    head = bench_main.headline(cfg, 64, steps=BENCH_STEPS, windows=1, device=dev)
    got = read_counts()
    xla = head["xla"]
    if set(xla) - {"time", "a2a_expected", "quant_grad_expected",
                   "comm_dtype"} != XLA_KEYS or not xla["hlolint"]["clean"]:
        raise AssertionError(f"(a) headline xla record: {xla}")
    want = dict(ce_want(steps, head["batch"] * (cfg.max_position_embeddings - 1), cfg),
                flash_forward=steps * cfg.num_layers)
    if {k: got[k] for k in want} != want or not math.isfinite(head["final_loss"]):
        raise AssertionError(f"(a) headline: launches {got} != {want}, loss "
                             f"{head['final_loss']}")
    print(f"  (a) headline: {head['tps_chip']:.1f} tokens/s a card, MFU {head['mfu']:.4f}, "
          f"final loss {head['final_loss']:.4f}, launches {want} ({smi})", flush=True)
    del head
    _free()
    rows = bench.bench_comm_overlap(cfg, 1, steps=BENCH_STEPS, device=dev)
    for r in rows:
        if "error" in r or list(r)[:len(OVERLAP_ROW_KEYS)] != OVERLAP_ROW_KEYS:
            raise AssertionError(f"(b) comm_overlap row: {r}")
        print(f"  (b) {r['strategy']} {r['comm_dtype']} b{r['grad_buckets']}: step "
              f"{r['step_time_s']:.6f} s, loss {r['final_loss']}", flush=True)
    fsdp = {r["final_loss"] for r in rows if r["strategy"] == "fsdp"}
    if len(fsdp) != 1:
        raise AssertionError(f"(b) FSDP's rungs differ at a world of one: {fsdp}")
    return {"headline_launches": want, "comm_overlap": rows}


SERVING_REQUESTS = 8  # phase 45: each serving record's requests
SPEC_STEPS = (100, 150)  # phase 45: the spec target's and draft's training steps
SPEC_MAX_NEW = 24  # phase 45: the spec record's new tokens (at tpukit's 48 the phase took 45 s)


def errors_in(rec, where: str) -> list:
    """Where in `rec` a failure landed as tpukit's records land one: the
    path of every dict, at any depth (a fleet rung, the disaggregated
    half, a spec rung), that holds `error`."""
    if isinstance(rec, dict):
        own = [where] if "error" in rec else []
        return own + [p for k, v in rec.items() for p in errors_in(v, f"{where}.{k}")]
    if isinstance(rec, list):
        return [p for i, v in enumerate(rec) for p in errors_in(v, f"{where}[{i}]")]
    return []


def bench_serving_on_card(dev, smi: str) -> dict:
    """Phase 45: the bench twin's eight serving records on the card, at the
    bench config (dim 256, 8 layers; the records' own dtypes) and
    SERVING_REQUESTS requests, the spec target and draft trained SPEC_STEPS
    steps and serving SPEC_MAX_NEW new tokens, the fleet's rungs meshless
    (a world of one), after the kernels at the shapes this path first gave
    them, held against their plain versions. Each record: the twin's key
    lists, no error at any depth (`errors_in`), the fleet's rungs of 1, 2
    and 4 replicas; the overhead records' tokens the same bits;
    `parity_ok` where the record has it; complete traces. The paged kernels
    launch layers x decode ticks in each of `decode_fused`'s fused rungs,
    whose warm and measured runs tick alike, and never in its unfused rung;
    the induction training launches the flash kernels once a layer a step
    and the f32 CE kernels once a step. Returns each record's launches."""
    from tpukit_torch.bench import serving
    from tpukit_torch.bench import __main__ as bench_main
    from tpukit_torch.data import get_tokenizer

    cfg = bench_main.bench_config()
    # (a) the kernels at the shapes this path gives them, first run here, against
    # their plain versions: the paged kernels at `decode_fused`'s pool (4 slots, 8 x
    # 32 heads, pages of 8, 4 pages a slot); flash f32 and CE f32 at the induction
    # training's rows (8 x S, S = 32 + new tokens + 10 + 2: 92 in the bench, 68
    # here), the target's 4 x 32 heads and dim 128, the draft's 2 x 16 and dim 32,
    # over the fixture vocabulary's padded head
    vocab = get_tokenizer().vocab_size
    v_pad = cfg.replace(vocab_size=vocab).padded_vocab_size
    paged_main = check_kernel(dev, dict(n=4, h=cfg.heads, d=cfg.head_dim, p=8, mp=4),
                              "bench decode_fused", main_pair=(torch.float32, torch.float32))
    for seq in (92, 32 + SPEC_MAX_NEW + 12):
        for h, d, dim in ((4, 32, 128), (2, 16, 32)):
            check_flash(dev, 8, h, seq, d, torch.float32, False)
            check_ce(dev, 8 * seq, dim, vocab, torch.float32, v_pad=v_pad)
    args = dict(device=dev)
    runs = {"serving": (serving.bench_serving, {}),
            "paged_kv": (serving.bench_paged_kv, {}),
            "spec_decode": (serving.bench_spec_decode, {"train_steps": SPEC_STEPS,
                                                         "max_new": SPEC_MAX_NEW}),
            "serve_dispatch_attribution": (serving.bench_serve_dispatch_attribution, {}),
            "decode_fused": (serving.bench_decode_fused, {}),
            "fleet_serving": (serving.bench_fleet_serving, {}),
            "serve_trace_overhead": (serving.bench_serve_trace_overhead, {}),
            "metrics_overhead": (serving.bench_metrics_overhead, {})}
    recs, counts, walls = {}, {}, {}
    for name, (record, extra) in runs.items():
        t0 = time.perf_counter()
        reset_counts()
        rec = record(cfg, 1, requests=SERVING_REQUESTS, **args, **extra)
        counts[name] = {k: v for k, v in read_counts().items() if v}
        walls[name] = time.perf_counter() - t0
        bad = serving.key_mismatches(name, rec)
        failed = errors_in(rec, name)
        if failed or bad:
            raise AssertionError(f"{name}: errors at {failed}, keys {bad}, record {rec}")
        recs[name] = rec
        _free()
    held = [x["replicas"] for x in recs["fleet_serving"]["rungs"]]
    if held != [1, 2, 4]:
        raise AssertionError(f"fleet_serving: rungs of {held} replicas, not 1, 2 and 4")
    r = recs
    print(f"  serving: continuous {r['serving']['continuous']['tokens_per_sec']} tokens/s, "
          f"serial {r['serving']['serial']['tokens_per_sec']}, serial_cached "
          f"{r['serving']['serial_cached']['tokens_per_sec']}; speedup "
          f"{r['serving']['speedup']}, vs cached {r['serving']['speedup_vs_cached']} ({smi})",
          flush=True)
    pk = r["paged_kv"]
    print(f"  paged_kv: ring {pk['ring']['tokens_per_sec']} / paged "
          f"{pk['paged']['tokens_per_sec']} / int8 {pk['paged_int8']['tokens_per_sec']} "
          f"tokens/s, slots at equal HBM {pk['slots_at_equal_hbm_ratio']}, int8 agreement "
          f"{pk['int8_token_agreement']}, prefix {pk['prefix']}", flush=True)
    sd = r["spec_decode"]
    print(f"  spec_decode: train {sd['train']}; t0 ngram speedup {sd['t0']['ngram']['speedup']}"
          f" (accept {sd['t0']['ngram']['accept_rate']}), model "
          f"{sd['t0']['model']['speedup']} (accept {sd['t0']['model']['accept_rate']}); t0.8 "
          f"ngram {sd['t0.8']['ngram']['speedup']}, model {sd['t0.8']['model']['speedup']}",
          flush=True)
    da = r["serve_dispatch_attribution"]
    print(f"  serve_dispatch_attribution: {da['quanta']} quanta, dispatch_frac "
          f"{da['dispatch_frac']}, {da['mean_dispatch_ms_per_quantum']} / "
          f"{da['mean_device_ms_per_quantum']} ms a quantum", flush=True)
    df = r["decode_fused"]
    print(f"  decode_fused: unfused_q1 {df['unfused_q1']['tokens_per_sec']} / fused_q1 "
          f"{df['fused_q1']['tokens_per_sec']} / fused_loop {df['fused_loop']['tokens_per_sec']}"
          f" tokens/s; kernel_speedup {df['kernel_speedup']}, amortization_speedup "
          f"{df['amortization_speedup']}", flush=True)
    fs = r["fleet_serving"]
    print(f"  fleet_serving: {[(x['replicas'], x['tokens_per_sec']) for x in fs['rungs']]} "
          f"tokens/s, scaling_2x_vs_1 {fs['scaling_2x_vs_1']}, disagg {fs['disagg_prefill']}",
          flush=True)
    for name in ("serve_trace_overhead", "metrics_overhead"):
        print(f"  {name}: off {r[name]['tokens_per_sec_off']} / on "
              f"{r[name]['tokens_per_sec_on']} tokens/s, overhead {r[name]['overhead_frac']}",
              flush=True)
    print(f"  walls (s): { {k: round(v, 1) for k, v in walls.items()} }", flush=True)
    faults = [f"{n} tokens differ with the plane on" for n in ("serve_trace_overhead",
                                                             "metrics_overhead")
              if r[n]["tokens_bit_identical"] is not True]
    faults += [f"{n} parity_ok false" for n in ("paged_kv", "decode_fused", "fleet_serving")
               if r[n]["parity_ok"] is not True]
    faults += [f"{n} trace_complete {t}" for n, t in (
        ("serve_dispatch_attribution", da["trace_complete"]),
        *((f"decode_fused.{k}", df[k]["trace_complete"])
          for k in ("unfused_q1", "fused_q1", "fused_loop"))) if t != 1.0]
    ticks = cfg.num_layers * 2 * (df["fused_q1"]["decode_steps"]
                                  + df["fused_loop"]["decode_steps"])
    want_paged = paged_want(ticks)
    got_paged = {k: counts["decode_fused"].get(k, 0) for k in want_paged}
    if got_paged != want_paged:
        faults.append(f"decode_fused paged launches {got_paged} != {want_paged} (8 layers x 2 "
                      f"runs x the fused rungs' ticks)")
    tgt_steps, draft_steps = SPEC_STEPS
    flash = 4 * tgt_steps + 2 * draft_steps  # the target's 4 layers, the draft's 2
    want_train = {"flash_forward": flash, "flash_backward_dcap": flash,
                  "flash_backward_dkv": flash, "flash_backward_dq": flash,
                  "ce_forward_f32": tgt_steps + draft_steps,
                  "ce_backward_dw_f32": tgt_steps + draft_steps,
                  "ce_backward_dh_f32": tgt_steps + draft_steps}
    if counts["spec_decode"] != want_train:
        faults.append(f"spec_decode launches {counts['spec_decode']} != {want_train}")
    print(f"  launches by record: {counts}", flush=True)
    if faults:
        raise AssertionError(f"phase 45: {faults}")
    return {"records": recs, "counts": counts, "walls": walls,
            "paged": dict(paged_main, pool="float32", compute="float32")}


# phase 39's recipe 1: 2112 rows of batch 64, 33 steps (windows close at
# steps 9, 17, 25 and 33)
RESILIENCE_ARGV = ["--dim", "768", "--head_dim", "64", "--heads", "12", "--num_layers", "12",
                   "--sequence_length", "512", "--batch_size", "64", "--epochs", "1",
                   "--dataset_slice", "1088", "--device", "cuda"]  # 17 steps of 64 rows
ROLLBACK_ROWS = ["--dataset_slice", "1600"]  # phase 39 (c): 25 steps, 8 after the rollback


@contextlib.contextmanager
def launches_per_step():
    """Each `train.train_step` call's kernel launches, as `fit` makes them
    (the launch counters are host-side, so no sync is needed)."""
    real, steps = train_mod.train_step, []

    def counted(*args, **kwargs):
        before = read_counts()
        out = real(*args, **kwargs)
        after = read_counts()
        steps.append({k: after[k] - before[k] for k in after})
        return out

    train_mod.train_step = counted
    try:
        yield steps
    finally:
        train_mod.train_step = real


def resilient_run(label: str, work: Path, extra=()) -> tuple:
    """Recipe 1 at RESILIENCE_ARGV + `extra` in `work`, through
    `recovery.run_recipe` as the recipe's `__main__`: (exit code, the fit's
    result or None, wall)."""
    work.mkdir(parents=True, exist_ok=True)
    box = {}

    def main(argv):
        box["result"] = single.main(argv)

    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        code = recovery.run_recipe(main, RESILIENCE_ARGV + list(extra))
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    result = box.get("result")
    windows = ([(w["step"], w["loss"]) for w in result.metrics["train_windows"]]
               if result is not None else None)
    print(f"  {label} ({' '.join(extra) or 'no flags'}): exit {code}, wall {wall:.2f} s, "
          f"windows (step, loss) {windows}", flush=True)
    return code, result, wall


def _same_windows(got: list, want: list, spread, what: str) -> None:
    """`got` windows equal `want` bit for bit, or, where the control runs
    themselves differ run to run (`spread`, None when not measured), within
    that spread."""
    if got == want:
        return
    if spread is None or len(got) != len(want) or any(
            g["step"] != w["step"] or abs(g["loss"] - w["loss"]) > spread
            for g, w in zip(got, want)):
        raise AssertionError(f"{what}: windows {got} != {want} (control spread {spread})")


def resilience_on_card(dev, smi: str) -> dict:
    """Phase 39 (see the module docstring)."""
    work = ROOT / "build" / "chip_smoke_resilience"
    shutil.rmtree(work, ignore_errors=True)
    walls = {}

    # the control saves asynchronously every 8 steps and keeps 2 ((d)):
    # saving moves no window
    keep = ["--checkpoint_every", "8", "--async_checkpoint", "--keep_checkpoints", "2"]
    code, a, walls["control, async keep 2"] = resilient_run("(a) control", work / "a", keep)
    if code != 0:
        raise AssertionError(f"the control run exited {code}")
    cfg, control = a.config, a.metrics["train_windows"]
    tokens = 64 * 511
    want = dict(**{f"paged_{k}": 0 for k in pa.launches},
                **{f"flash_{k}": cfg.num_layers for k in fa.launches if not k.endswith("_f32")},
                **{f"flash_{k}": 0 for k in fa.launches if k.endswith("_f32")},
                **ce_want(1, tokens, cfg), **{f"moe_{k}": 0 for k in moe_gemm.launches})
    state_bytes = _disk_bytes(work / "a" / a.checkpoint_path)
    kept = [p.name for p in ckpt_lib.all_checkpoints(work / "a" / "checkpoints")]
    if kept != ["checkpoint-16.pt", "checkpoint-17.pt"]:
        raise AssertionError(f"async keep 2: published {kept}")
    _free()

    # (b) preempt, then --resume latest in the same directory
    code, _, walls["preempt"] = resilient_run("(b) preempt", work / "b",
                                              ["--chaos_spec", "sigterm@9"])
    meta = ckpt_lib.read_meta(work / "b" / "checkpoints" / "checkpoint-9.pt")
    print(f"  (b) sidecar: {meta}", flush=True)
    # the state at step 9 without --debug_nans, for phase 40 (e)
    shutil.copyfile(work / "b" / "checkpoints" / "checkpoint-9.pt", PREEMPT9)
    if code != recovery.EXIT_PREEMPTED or not meta or (
            meta["preempted"], meta["epoch"], meta["batch_in_epoch"]) != (True, 0, 9):
        raise AssertionError(f"sigterm@9: exit {code}, meta {meta}")
    code, b, walls["resume"] = resilient_run("(b) resume", work / "b", ["--resume", "latest"])
    resumed = b.metrics["train_windows"] if b is not None else None
    spread = None
    if code != 0 or resumed != control[1:]:
        # not bit for bit: the spread of a second control bounds the gap
        _, a2, walls["control 2"] = resilient_run("(a) control again", work / "a2")
        spread = max(abs(x["loss"] - y["loss"]) for x, y in zip(a2.metrics["train_windows"],
                                                                 control))
        print(f"  the control's windows differ run to run by up to {spread:.3e}: not bitwise "
              f"deterministic outside the port's kernels (phase 6 holds the flash and CE "
              f"kernels to the same bits on a second run)", flush=True)
        del a2
    if code != 0:
        raise AssertionError(f"--resume latest exited {code}")
    _same_windows(resumed, control[1:], spread, "(b) preempt and resume")
    del b
    shutil.rmtree(work / "b")
    _free()

    # (c) a rollback, and the control restored from its target
    with launches_per_step() as steps:
        code, c, walls["rollback"] = resilient_run("(c) rollback", work / "c", ROLLBACK_ROWS + [
            "--checkpoint_every", "8", "--chaos_spec", "nan_loss@12", "--spike_threshold", "6",
            "--on_anomaly", "rollback"])
    if code != 0:
        raise AssertionError(f"the rollback run exited {code}")
    [rb] = c.metrics["events"]["rollbacks"]
    print(f"  (c) rollback {rb}", flush=True)
    if (rb["anomaly_step"], rb["target_step"], rb["quarantined"]) != (
            17, 8, ["checkpoint-16.pt.quarantined-0001"]) or c.state.step != 16:
        raise AssertionError(f"rollback {rb}, final step {c.state.step}")
    bad = [i for i, got in enumerate(steps) if got != want]
    print(f"  (c) launches in each of its {len(steps)} steps (8 replayed): "
          f"{'all' if not bad else len(steps) - len(bad)} equal phase 7's per-step counts "
          f"{ {k: v for k, v in want.items() if v} }", flush=True)
    if len(steps) != 25 or bad:
        raise AssertionError(f"rollback run launches: steps {bad} of {len(steps)}: "
                             f"{[steps[i] for i in bad[:2]]} != {want}")
    post = c.metrics["train_windows"][rb["windows_before"]:]
    del c
    _free()
    code, cc, walls["restored control"] = resilient_run("(c) restored control", work / "cc",
                                                        ROLLBACK_ROWS + [
        "--resume", str(work / "c" / "checkpoints" / "checkpoint-8.pt"),
        "--chaos_spec", "skip@17"])
    if code != 0 or not post:
        raise AssertionError(f"restored control exited {code}; post-rollback windows {post}")
    _same_windows(post, cc.metrics["train_windows"], spread, "(c) rollback vs restored control")
    del cc
    shutil.rmtree(work / "c")
    shutil.rmtree(work / "cc")
    _free()

    # (d) exit codes 77 and 76, async saves and retention
    sentinel = ["--chaos_spec", "nan_loss@4", "--spike_threshold", "6"]
    for label, extra, want_code in (
            ("(d) budget 0", ["--on_anomaly", "rollback", "--max_rollbacks", "0"], 77),
            ("(d) abort", ["--spike_action", "abort"], 76)):
        code, _, walls[label] = resilient_run(label, work / "d", sentinel + extra)
        autopsy = work / "d" / "checkpoints" / "checkpoint-9.pt"
        if code != want_code or not autopsy.exists():
            raise AssertionError(f"{label}: exit {code} (want {want_code}), {autopsy}")
        shutil.rmtree(work / "d")
    _free()
    flags = parse_flags(RESILIENCE_ARGV + keep)
    saver = ckpt_lib.AsyncCheckpointer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apath = saver.save_auto(a.state, "auto", flags, directory=work / "async")
    call_s = time.perf_counter() - t0
    saver.wait()
    async_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spath = ckpt_lib.save_auto(a.state, "auto", flags, directory=work / "sync")
    sync_s = time.perf_counter() - t0
    same = all(x.read_bytes() == y.read_bytes() for x, y in (
        (apath, spath), (apath.with_suffix(".json"), spath.with_suffix(".json")),
        (work / "a" / "checkpoints" / "checkpoint-17.pt", spath)))
    print(f"  (d) the control published {kept}; async == sync bytes (and the run's own "
          f"checkpoint-17.pt): {same}", flush=True)
    print(f"  save of the {state_bytes / 1e9:.3f} GB state ({smi}): sync {sync_s:.3f} s; async "
          f"{call_s:.3f} s on the training thread (the snapshot), {async_s:.3f} s until "
          f"durable", flush=True)
    if not same:
        raise AssertionError("the async writer's bytes differ from the sync writer's")
    del a
    shutil.rmtree(work)
    _free()
    print(f"  phase 39 walls (s): { {k: round(v, 2) for k, v in walls.items()} }", flush=True)
    return dict(walls=walls, sync_s=sync_s, async_call_s=call_s, async_s=async_s,
                state_bytes=state_bytes)


TELEMETRY_ROWS = ["--dataset_slice", "1088"]  # 17 steps of 64 rows: windows at 9 and 17
PREEMPT9 = ROOT / "build" / "chip_smoke_preempt9.pt"  # phase 39 (b)'s step-9 state
TELEMETRY_ON = ["--metrics_log", "run.jsonl", "--metrics_dir", "md", "--log_grad_norms",
                "--divergence_check_freq", "8", "--hang_timeout", "60"]
TELEMETRY_KINDS = {"train", "divergence_check", "validation", "epoch", "metrics"}
PORT_KERNELS = ("flash_fwd_kernel_tc", "ce_fwd_wgmma_kernel")  # a Chrome trace must name them


def _tool(name: str, *args) -> None:
    """`python tools/<name>.py args` (jax-free); raises unless it exits 0."""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / f"{name}.py"), *map(str, args)],
                          capture_output=True, text=True)
    print(f"  tools/{name}.py: exit {proc.returncode}; "
          f"{(proc.stdout.strip().splitlines() or [''])[0][:120]}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"tools/{name}.py {args}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")


def _trace_names_kernels(path: Path, what: str) -> None:
    text = path.read_text()
    missing = [k for k in PORT_KERNELS if k not in text]
    print(f"  {what}: {path.name}, {len(text) / 1e6:.1f} MB, names "
          f"{[k for k in PORT_KERNELS if k in text]}", flush=True)
    if missing:
        raise AssertionError(f"{what} {path} names no {missing}")


def _same_state(a, b, what: str) -> None:
    if a.metrics["train_windows"] != b.metrics["train_windows"]:
        raise AssertionError(f"{what}: windows {a.metrics['train_windows']} != "
                             f"{b.metrics['train_windows']}")
    for (n, x), y in zip(_named(a.state.params).items(), _named(b.state.params).values()):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: parameter {n} differs")


def telemetry_on_card(dev, smi: str) -> dict:
    """Phase 40 (see the module docstring); (e) reads phase 39's PREEMPT9."""
    work = ROOT / "build" / "chip_smoke_telemetry"
    shutil.rmtree(work, ignore_errors=True)
    walls = {}

    # (a) telemetry on, every step's launches counted; (b) off
    with launches_per_step() as steps:
        code, on, walls["on"] = resilient_run("(a) telemetry on", work / "on",
                                              TELEMETRY_ROWS + TELEMETRY_ON)
    code_off, off, walls["off"] = resilient_run("(b) telemetry off", work / "off",
                                                TELEMETRY_ROWS)
    if code != 0 or code_off != 0:
        raise AssertionError(f"telemetry on exited {code}, off {code_off}")
    cfg = on.config
    want = dict(**{f"paged_{k}": 0 for k in pa.launches},
                **{f"flash_{k}": cfg.num_layers for k in fa.launches if not k.endswith("_f32")},
                **{f"flash_{k}": 0 for k in fa.launches if k.endswith("_f32")},
                **ce_want(1, 64 * 511, cfg), **{f"moe_{k}": 0 for k in moe_gemm.launches})
    bad = [i for i, got in enumerate(steps) if got != want]
    print(f"  (a) launches in each of its {len(steps)} steps: "
          f"{'all' if not bad else len(steps) - len(bad)} equal phase 7's per-step counts "
          f"{ {k: v for k, v in want.items() if v} }", flush=True)
    if len(steps) != 17 or bad:
        raise AssertionError(f"telemetry run launches: steps {bad} of {len(steps)}: "
                             f"{[steps[i] for i in bad[:2]]} != {want}")
    _same_state(on, off, "telemetry on vs off")
    records = [json.loads(line) for line in (work / "on" / "run.jsonl").read_text().splitlines()]
    kinds = {r["kind"] for r in records}
    train = [r for r in records if r["kind"] == "train"]
    for r in train:
        hbm = r.get("hbm") or {}
        if not (r["mfu"] is not None and 0.0 < r["mfu"] < 1.0 and hbm
                and hbm["peak_bytes_in_use"] <= hbm["bytes_limit"]):
            raise AssertionError(f"train record {r}")
    xla = [r["fn"] for r in records if r["kind"] == "xla"]  # the comm audit's (phase 43)
    if (not TELEMETRY_KINDS <= kinds or xla != ["train_step", "eval_step"]
            or [r["step"] for r in train] != [9, 17]):
        raise AssertionError(f"JSONL kinds {sorted(kinds)}, xla {xla}, windows "
                             f"{[r['step'] for r in train]}")
    tokens = 8 * 64 * 511  # a window's tokens
    tps = {k: r.metrics["tokens_per_sec"] for k, r in (("on", on), ("off", off))}
    print(f"  (a)/(b) bit for bit: windows {on.metrics['train_windows']}, every parameter; "
          f"kinds {sorted(kinds)}", flush=True)
    for r in train:
        print(f"  (a) window at step {r['step']}: {r['window_s']:.4f} s, tokens/s "
              f"{r['tokens_per_sec']:.1f}, mfu {r['mfu']:.4f}, goodput {r['goodput']:.4f}, "
              f"grad_norm {r['grad_norm']:.4f}, update_norm {r['update_norm']:.4e}, "
              f"param_norm {r['param_norm']:.2f}, hbm {r.get('hbm')} ({smi})", flush=True)
    print(f"  window of 8 steps by the meter ({smi}): telemetry on "
          f"{tokens / tps['on']:.4f} s ({tps['on']:.1f} tokens/s, MFU "
          f"{on.metrics['mfu']:.4f}), off {tokens / tps['off']:.4f} s ({tps['off']:.1f} "
          f"tokens/s): on/off {tps['off'] / tps['on']:.4f}", flush=True)
    _tool("report", work / "on" / "run.jsonl")
    result = dict(walls=walls, mfu=on.metrics["mfu"], tps=tps, counts=steps[0],
                  peak=max(r["hbm"]["peak_bytes_in_use"] for r in train),
                  window_s=[r["window_s"] for r in train])
    del on
    _free()

    # (c) a hang at step 5 under a 1 s deadline, the anomaly trace armed
    code, hang, walls["hang"] = resilient_run("(c) hang", work / "hang", TELEMETRY_ROWS + [
        "--chaos_spec", "hang@5:3", "--hang_timeout", "1", "--trace_on_anomaly", "2",
        "--debug_dir", "dbg", "--metrics_log", "run.jsonl"])
    if code != 0 or hang.state.step != 17:
        raise AssertionError(f"the hang run exited {code} at step {hang.state.step}")
    dbg = work / "hang" / "dbg"
    bundles = {p: json.loads(p.read_text()) for p in sorted(dbg.glob("bundle-*-hang-*.json"))}
    [(path, bundle)] = [(p, b) for p, b in bundles.items() if b["step"] == 5]
    main_stack = next(f for n, f in bundle["stacks"].items() if n.startswith("MainThread"))
    mem = bundle["memory"] or {}
    print(f"  (c) {len(bundles)} hang bundle(s) at steps {[b['step'] for b in bundles.values()]};"
          f" step 5's stuck {bundle['stuck_for_s']} s, memory {mem}, device "
          f"{bundle['process'].get('device_kind')}", flush=True)
    if not (any("sleep" in line for line in main_stack) and mem.get("bytes_limit")):
        raise AssertionError(f"bundle {path}: training stack {main_stack[-3:]}, memory {mem}")
    records = [json.loads(line) for line in (work / "hang" / "run.jsonl").read_text().splitlines()]
    events = [(r["kind"], r.get("event"), r.get("step")) for r in records
              if r["kind"] in ("watchdog", "anomaly_trace")]
    print(f"  (c) records {events}", flush=True)
    if ("anomaly_trace", "stopped", 11) not in events or not any(
            k == "watchdog" and e == "hang" for k, e, _ in events):
        raise AssertionError(f"hang records {events}")
    _tool("flightview", dbg)
    _trace_names_kernels(dbg / "anomaly_trace" / "trace-p00000.json", "(c) anomaly trace")
    rec = FlightRecorder()
    for i in range(256):
        rec.record("step", step=i, epoch=0)
    t0 = time.perf_counter()
    write_bundle(work / "timing", "timing", step=17, recorder=rec, probes={"x": lambda: 1},
                 config=parse_flags(RESILIENCE_ARGV), device=dev)
    result["bundle_s"] = time.perf_counter() - t0
    print(f"  a bundle with a full ring (256 records) and the card's memory block: "
          f"{result['bundle_s'] * 1e3:.2f} ms ({smi})", flush=True)
    del hang
    _free()

    # (d) --profile_dir over 3 steps
    code, prof, walls["profile"] = resilient_run("(d) profile", work / "prof", [
        "--dataset_slice", "192", "--profile_dir", "prof"])
    if code != 0 or prof.state.step != 3:
        raise AssertionError(f"the profiled run exited {code}")
    _trace_names_kernels(work / "prof" / "prof" / "trace-p00000.json", "(d) --profile_dir trace")
    del prof
    _free()

    # (e) --debug_nans on the healthy run's first window: preempted at step
    # 9, its checkpoint's bytes (every parameter and the AdamW state) equal
    # those phase 39's preempt run wrote at step 9 without the flag
    code, _, walls["debug_nans"] = resilient_run("(e) debug_nans", work / "nans", TELEMETRY_ROWS
                                                 + ["--debug_nans", "--chaos_spec", "sigterm@9"])
    got = work / "nans" / "checkpoints" / "checkpoint-9.pt"
    if code != recovery.EXIT_PREEMPTED or got.read_bytes() != PREEMPT9.read_bytes():
        raise AssertionError(f"the --debug_nans run exited {code}; its step-9 state equals the "
                             f"run's without the flag: {got.read_bytes() == PREEMPT9.read_bytes()}")
    print("  (e) --debug_nans, one window: the step-9 state (every parameter and the AdamW "
          "moments) bit for bit the state without it (phase 39 (b)'s)", flush=True)
    PREEMPT9.unlink()
    del off
    shutil.rmtree(work)
    _free()
    print(f"  phase 40 walls (s): { {k: round(v, 2) for k, v in walls.items()} }", flush=True)
    return result


SERVE_SLO = "ttft<=250ms@p99;tpot<=40ms@p95;e2e<=2s@p99"  # tpukit's --slo example
SERVE_KINDS = {"serve", "slo", "serve_summary", "trace_event", "trace", "metrics"}
SHORT = 16  # phase 41's sampled, n-gram, MoE and entry-point runs: one wave of 16 slots


def _serve_telemetry(work: Path) -> dict:
    """Every serving telemetry plane on, writing under `work`."""
    work.mkdir(parents=True)
    return dict(logger=StepLogger(str(work / "serve.jsonl")), recorder=FlightRecorder(),
                tracer=TraceRecorder(), metrics=MetricRegistry(), slo=parse_slo(SERVE_SLO),
                metrics_dir=str(work / "metrics"))


def _telemetry_pair(params, cfg, serve, reqs, dev, eos, work: Path, what: str, **kw) -> dict:
    """`reqs` served with telemetry on, then off: the same tokens bit for
    bit, the same decode steps and prefill dispatches and the same
    launches; the on run's records checked as (c)."""
    got = {}
    for label in ("on", "off"):
        tel = _serve_telemetry(work) if label == "on" else {}
        reset_counts()
        engine, outs = serve_run(params, cfg, serve, reqs, dev, eos, **kw, **tel)
        check_outputs(outs, reqs, cfg)
        got[label] = (engine, outs, read_counts())
    (on, on_outs, on_counts), (off, off_outs, off_counts) = got["on"], got["off"]
    _same_tokens({"on": on_outs, "off": off_outs}, "off", [r.rid for r in reqs], what)
    sched = lambda e: (e.steps, e.prefill_dispatches)
    if sched(on) != sched(off) or on_counts != off_counts:
        raise AssertionError(f"{what}: telemetry on {sched(on)} {on_counts} != off "
                             f"{sched(off)} {off_counts}")
    _check_serve_records(on, work / "serve.jsonl", what)
    return dict(on=on.last_summary, off=off.last_summary, counts=on_counts, steps=on.steps)


def _check_serve_records(engine, path: Path, what: str) -> list:
    """(c): tpukit's serving kinds; each window's named seconds (`other`
    among them) sum to its `window_s`; every request's span tree closed
    and complete, none dropped."""
    engine.logger.close()
    recs = [json.loads(line) for line in open(path)]
    windows = [r for r in recs if r["kind"] == "serve"]
    trees = [r for r in recs if r["kind"] == "trace"]
    s = engine.last_summary
    drift = max((abs(sum(w["seconds"].values()) - w["window_s"]) for w in windows), default=0)
    print(f"  {what}: {len(windows)} serve windows (seconds sum to window_s within "
          f"{drift:.2e} s), {len(trees)} span trees, trace_complete {s['trace_complete']}, "
          f"trace_dropped {s['trace_dropped']}, SLO compliance {s['slo_overall_compliance']}",
          flush=True)
    kinds = {r["kind"] for r in recs}
    if (kinds != SERVE_KINDS or not windows or drift > 1e-6
            or any(w["other_s"] != w["seconds"]["other"] for w in windows)
            or len(trees) != s["requests"]
            or not all(t["closed"] and t["complete"] for t in trees)
            or s["trace_complete"] != 1.0 or s["trace_dropped"] != 0):
        raise AssertionError(f"{what}: records {sorted(kinds)}, windows {len(windows)}, drift "
                             f"{drift}, trees {len(trees)} of {s['requests']}, "
                             f"trace_complete {s['trace_complete']}, dropped "
                             f"{s['trace_dropped']}")
    return recs


def _split_line(s: dict) -> str:
    return " / ".join(f"{k} {s[k]:.4f}" for k in (
        "prefill_s", "decode_s", "sync_s", "other_s", "dispatch_overhead_s", "device_s"))


TELEMETRY_TIMED = 16  # phase 41 (a)'s runs: one wave of phase 4's 16 slots (32 until the
#                      serving records of phase 45 came)


def serving_telemetry_on_card(dev, smi: str) -> dict:
    """Phase 41 (see the module docstring)."""
    work = ROOT / "build" / "chip_smoke_serve_obs"
    shutil.rmtree(work, ignore_errors=True)
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    serve_run(params, cfg, serve, reqs[:4], dev, eos)  # warm-up
    # (a) the cost: on, off, three times each, alternated, on the first
    # TELEMETRY_TIMED requests
    timed = reqs[:TELEMETRY_TIMED]
    runs, first = [], None
    for i, on in enumerate((True, False) * 3):
        tel = _serve_telemetry(work / f"a{i}") if on else {}
        reset_counts()
        t0 = time.perf_counter()
        engine, outs = serve_run(params, cfg, serve, timed, dev, eos, **tel)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if k.startswith("paged_")}
        s = engine.last_summary
        want = paged_want(cfg.num_layers * engine.steps)
        print(f"  (a) run {i} telemetry {'on ' if on else 'off'}: {s['generated_tokens']} tokens "
              f"in {wall:.4f} s ({s['generated_tokens'] / wall:.1f} tokens/s), "
              f"{engine.steps} ticks; {_split_line(s)}; paged launches {counts}", flush=True)
        check_outputs(outs, timed, cfg)
        if counts != want or engine.steps == 0:
            raise AssertionError(f"(a) run {i}: paged launches {counts} != {want}")
        if first is None:
            first = outs
        _same_tokens({"this": outs, "first": first}, "first", [r.rid for r in timed],
                     f"(a) run {i}")
        if on:
            recs = _check_serve_records(engine, work / f"a{i}" / "serve.jsonl", f"(a) run {i}")
            t0 = time.perf_counter()
            trees = trace_lib.build_trees(engine.tracer.snapshot())
            trees_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            publish_snapshot(engine.metrics_dir, 0, engine.metrics, time_s=time.time())
            publish_ms = 1e3 * (time.perf_counter() - t0)
            windows = sum(r["kind"] == "serve" for r in recs)
            print(f"  (a) run {i}: build_trees over the whole ring ({len(engine.tracer)} events, "
                  f"{len(trees)} trees) {trees_ms:.3f} ms, one snapshot publish "
                  f"{publish_ms:.3f} ms; the engine does both at each of its {windows} windows "
                  f"(and at its summary)", flush=True)
        runs.append(dict(on=on, wall=wall, tokens_per_s=s["generated_tokens"] / wall,
                         summary=s, counts=counts, trees_ms=trees_ms if on else None,
                         publish_ms=publish_ms if on else None))
    med = lambda on: float(np.median([r["tokens_per_s"] for r in runs if r["on"] == on]))
    ratio = med(True) / med(False)
    print(f"  (a) median tokens/s on {med(True):.1f}, off {med(False):.1f}: on/off {ratio:.4f} "
          f"({smi})", flush=True)

    # (b) tokens on == off: sampled (paged, fused) and n-gram speculation on
    # the ring over the repetitive stream; C8: the verify span, not decode
    sampled = _telemetry_pair(params, cfg, dataclasses.replace(serve, **SAMPLED), reqs[:SHORT],
                              dev, eos, work / "b_sampled", "(b) sampled t 0.8 top-k 40")
    rep = synthetic_request_stream(get_tokenizer(), len(reqs), seed=0,
                                   max_new_tokens=serve.max_new_tokens, buckets=serve.buckets,
                                   stream_profile="repetitive")[:SHORT]
    ngram_cfg = dataclasses.replace(serve, page_size=0, prefill_chunk=0, fused_decode=False,
                                    spec_k=4, draft="ngram")
    ngram = _telemetry_pair(params, cfg, ngram_cfg, rep, dev, eos, work / "b_ngram",
                            "(b) ngram spec_k 4 on the ring")
    for label, s in (("on", ngram["on"]), ("off", ngram["off"])):
        print(f"  (b) ngram, telemetry {label}: {_split_line(s)}; draft_s {s['draft_s']:.4f}, "
              f"verify_s {s['verify_s']:.4f}", flush=True)
        if not (s["decode_s"] == 0.0 and s["verify_s"] > 0):
            raise AssertionError(f"(b) ngram: decode_s {s['decode_s']}, verify_s "
                                 f"{s['verify_s']} (C8: the quantum is a verify span)")
    del params
    _free()

    # (d) the entry point in a process of its own, started now: its start-up
    # overlaps the MoE pair, which times nothing
    cli = work / "cli"
    cli.mkdir()
    argv = (WIDTH_FLAGS + STREAM_FLAGS + ["--requests", str(SHORT)] + PAGED_FLAGS +
            ["--metrics_log", "serve.jsonl", "--metrics_dir", "metrics", "--slo", SERVE_SLO])
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tpukit_torch.serve", *argv], cwd=cli,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    # the MoE model (8 experts, pallas), paged and fused: rows 4 and 8
    mcfg, mparams, mserve, _, _ = build(dev, fused=True, num_experts=8)
    moe = _telemetry_pair(mparams, mcfg, mserve, reqs[:SHORT], dev, eos, work / "moe",
                          "MoE paged fused")
    forwards = moe["on"]["prefill_dispatches"] + moe["steps"]
    paged = paged_want(mcfg.num_layers * moe["steps"])
    print(f"  MoE: grouped forward launches {moe['counts']['moe_forward_up']} = "
          f"{mcfg.num_layers} x ({moe['on']['prefill_dispatches']} prefill dispatches + "
          f"{moe['steps']} ticks); paged {[moe['counts'][k] for k in paged]}", flush=True)
    if moe["counts"]["moe_forward_up"] != mcfg.num_layers * forwards or any(
            moe["counts"][k] != v for k, v in paged.items()):
        raise AssertionError(f"MoE with telemetry: launches {moe['counts']}")
    del mparams
    _free()

    # (d) the entry point's run, and tpukit's tools on its files
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"  (d) python -m tpukit_torch.serve {' '.join(argv)}: exit {proc.returncode} "
          f"{time.perf_counter() - t0:.1f} s after its start", flush=True)
    print("    " + "\n    ".join(l for l in stdout.splitlines() if l.startswith(
        ("serving grid", "served", "paged KV", "e2e", "traces", "WARNING", "SLO"))), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the entry point exited {proc.returncode}:\n{stderr[-3000:]}")
    _tool("report", cli / "serve.jsonl", "--min_trace_complete", "1.0")
    _tool("traceview", cli / "serve.jsonl", "--out", cli / "trace.json")
    events = json.loads((cli / "trace.json").read_text())["traceEvents"]
    merged = cli / "metrics" / "metrics-merged.json"
    print(f"  (d) the Chrome trace loads: {len(events)} events; {merged.name}: "
          f"{merged.exists()}", flush=True)
    if not events or not merged.exists():
        raise AssertionError(f"(d): {len(events)} trace events, {merged} exists "
                             f"{merged.exists()}")
    shutil.rmtree(work)
    return dict(runs=runs, ratio=ratio, sampled=sampled, ngram=ngram, moe=moe,
                counts=runs[0]["counts"])


FLEET_SHORT = 16  # phase 42's deadline and MoE runs: one wave of 16 slots a replica


def _fleet_run(params, cfg, serve, reqs, dev, eos, fleet: FleetConfig, **kw) -> dict:
    """`reqs` through a `FleetRouter` on `dev`, launch counts from zero:
    the router, every engine it built (killed and retired ones too, in
    build order), the tokens, the wall and the counts."""
    built = []
    real = FleetRouter._build_replica

    def keep(self, idx, log=True):
        eng = real(self, idx, log)
        built.append(eng)
        return eng

    FleetRouter._build_replica = keep
    try:
        router = FleetRouter(params, cfg, serve, fleet, eos_id=eos, device=dev, **kw)
        reset_counts()
        t0 = time.perf_counter()
        comps = router.run(list(reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        FleetRouter._build_replica = real
    rids = [c.rid for c in comps]
    if len(rids) != len(set(rids)) or router.last_summary["duplicate_completions"]:
        raise AssertionError(f"a request completed twice: {sorted(rids)}")
    return dict(router=router, engines=built, outs={c.rid: np.asarray(c.ids) for c in comps},
                comps=comps, wall=wall, counts=read_counts(), s=router.last_summary)


def _fleet_line(what: str, run: dict) -> str:
    s, e = run["s"], run["engines"]
    return (f"{what}: {s['requests']} requests / {s['generated_tokens']} tokens in "
            f"{run['wall']:.3f} s ({s['generated_tokens'] / run['wall']:.1f} tokens/s), "
            f"replica ticks {[x.steps for x in e]}, prefill dispatches "
            f"{[x.prefill_dispatches for x in e]}, kills {s['kills']}, requeued "
            f"{s['requeued']}, peak replicas {s['replicas_peak']}")


def _paged_formula(run: dict, layers: int, what: str) -> int:
    """The paged kernels launch layers x the ticks of every replica."""
    ticks = sum(e.steps for e in run["engines"])
    paged = {k: v for k, v in run["counts"].items() if k.startswith("paged_")}
    if paged != paged_want(layers * ticks) or ticks == 0:
        raise AssertionError(f"{what}: paged launches {paged} != {layers} x {ticks} ticks")
    return ticks


FLEET_TIMED = 16  # phase 42 (a)'s timed turns: a quarter of phase 4's 64 requests


def serving_fleet_on_card(dev, smi: str, greedy: dict) -> dict:
    """Phase 42 (see the module docstring)."""
    work = ROOT / "build" / "chip_smoke_fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}

    # (a) tokens/s: phase 4's engine (bf16, 12 layers), one engine and a
    # fleet of two replicas on this card, in turns after a warm-up, on the
    # first FLEET_TIMED requests of phase 4's stream
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    timed = reqs[:FLEET_TIMED]
    two = FleetConfig(replicas=2, window_steps=8)
    serve_run(params, cfg, serve, reqs[:4], dev, eos)
    _fleet_run(params, cfg, serve, reqs[:4], dev, eos, two)
    speed = {"single": [], "fleet": []}
    for label in ("single", "fleet", "fleet", "single"):
        if label == "single":
            reset_counts()
            t0 = time.perf_counter()
            engine, outs = serve_run(params, cfg, serve, timed, dev, eos)
            wall = time.perf_counter() - t0
            ticks = engine.steps
            counts = {k: v for k, v in read_counts().items() if k.startswith("paged_")}
            if counts != paged_want(cfg.num_layers * ticks):
                raise AssertionError(f"(a) single: paged launches {counts}")
            tps = engine.last_summary["generated_tokens"] / wall
        else:
            run = _fleet_run(params, cfg, serve, timed, dev, eos, two)
            ticks = _paged_formula(run, cfg.num_layers, "(a) fleet")
            outs, wall = run["outs"], run["wall"]
            tps = run["s"]["generated_tokens"] / wall
            out["paged_bf16"] = run["counts"]["paged_scores"]
            if run["s"]["tokens_per_sec"] is None:
                raise AssertionError("(a) fleet_summary without tokens/s")
        check_outputs(outs, timed, cfg)
        speed[label].append(tps)
        print(f"  (a) {label}: {wall:.3f} s, {tps:.1f} tokens/s, {ticks} ticks "
              f"(summed over replicas); paged launches = {cfg.num_layers} x ticks", flush=True)
    med = {k: float(np.median(v)) for k, v in speed.items()}
    out["tokens_per_s"] = med
    print(f"  (a) bf16 12 layers, {len(timed)} requests ({smi}): one engine {med['single']:.1f} "
          f"tokens/s, fleet of 2 {med['fleet']:.1f} (ratio {med['fleet'] / med['single']:.4f}; "
          f"phase 4 {greedy['tokens_per_s']:.1f})", flush=True)
    del params
    _free()

    # f32 greedy, 4 layers (phase 5's): the single engine's tokens
    cfg, params, serve, reqs, eos = build(dev, fused=True, num_layers=4,
                                          compute_dtype=torch.float32)
    _, single_outs = serve_run(params, cfg, serve, reqs, dev, eos)
    rids = [r.rid for r in reqs]
    fleet = _fleet_run(params, cfg, serve, reqs, dev, eos, two)
    _same_tokens({"fleet": fleet["outs"], "single": single_outs}, "single", rids,
                 "(a) fleet of 2")
    _paged_formula(fleet, cfg.num_layers, "(a) f32 fleet")
    print("  " + _fleet_line("(a) f32 fleet of 2", fleet) + "; tokens == one engine's",
          flush=True)

    # (c) disaggregated prefill: one worker, two decode replicas
    tracer = TraceRecorder(capacity=1 << 16)
    dis = _fleet_run(params, cfg, serve, reqs, dev, eos,
                     FleetConfig(replicas=2, window_steps=8, disagg_prefill=True),
                     tracer=tracer)
    _same_tokens({"disagg": dis["outs"], "single": single_outs}, "single", rids,
                 "(c) disaggregated prefill")
    _paged_formula(dis, cfg.num_layers, "(c) decode replicas")  # the worker: none
    worker = dis["router"].prefill
    hand = [e for e in tracer.snapshot() if e["ev"] == "handoff"]
    claimed = sum(e.allocator.stats.prefix_pages_reused for e in dis["engines"])
    copied = sum(e["pages"] for e in hand)
    copy_ms = [1e3 * e["copy_s"] for e in hand]
    if (any(e.prefill_dispatches for e in dis["engines"]) or worker.steps
            or worker.prefill_dispatches == 0 or len(hand) != len(reqs)):
        raise AssertionError(f"(c) decode prefill dispatches "
                             f"{[e.prefill_dispatches for e in dis['engines']]}, worker "
                             f"ticks {worker.steps}, handoffs {len(hand)}")
    out["disagg"] = dict(handoffs=len(hand), claimed=claimed, copied=copied,
                         copy_ms_median=float(np.median(copy_ms)),
                         copy_ms_max=float(np.max(copy_ms)),
                         worker_prefill_dispatches=worker.prefill_dispatches)
    print(f"  " + _fleet_line("(c) disaggregated prefill", dis) + f"; tokens == one "
          f"engine's; worker: {worker.prefill_dispatches} prefill dispatches, 0 ticks; "
          f"{len(hand)} handoffs: {claimed} pages claimed, {copied} pages copied, the "
          f"copy's host wall median {out['disagg']['copy_ms_median']:.3f} ms, max "
          f"{out['disagg']['copy_ms_max']:.3f} ms ({smi})", flush=True)

    # (g) the entry point in processes of their own, started after
    # the timed parts: their start-up overlaps the token checks below
    tel = ["--metrics_log", "fleet.jsonl", "--slo", SERVE_SLO]
    base = WIDTH_FLAGS + STREAM_FLAGS + ["--requests", str(FLEET_SHORT)] + PAGED_FLAGS
    cli = {
        "router": base + ["--replicas", "2", "--fleet_kill", "replica_kill@8:1"] + tel,
        "procs": base + ["--replicas", "2", "--fleet_procs", "--fleet_dir", "fleet",
                         "--replica_timeout", "120", "--fleet_kill", "replica_sigkill@6:1",
                         "--metrics_log", "fleet.jsonl"],
    }
    procs = {}
    for name, argv in cli.items():
        (work / name).mkdir()
        procs[name] = (subprocess.Popen([sys.executable, "-m", "tpukit_torch.serve", *argv],
                                        cwd=work / name, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), time.perf_counter())
    try:
        # (b) a replica killed mid-stream: each request once, (a)'s tokens
        kill = _fleet_run(params, cfg, serve, reqs, dev, eos,
                          FleetConfig(replicas=2, window_steps=8, kill_spec="replica_kill@8:1"))
        _same_tokens({"kill": kill["outs"], "single": single_outs}, "single", rids,
                     "(b) replica_kill@8:1")
        _paged_formula(kill, cfg.num_layers, "(b) kill")
        if kill["s"]["kills"] != 1 or kill["s"]["per_replica"][1]["fate"] != "killed":
            raise AssertionError(f"(b) kill summary {kill['s']}")
        out["requeued"] = kill["s"]["requeued"]
        print("  " + _fleet_line("(b) replica_kill@8:1", kill) + "; tokens == one engine's, "
              "each request once", flush=True)

        # (d) autoscale: one replica grows to two and drains back to one
        trickle = [dataclasses.replace(reqs[i], rid=1000 + i, arrival_s=3.0 + 0.2 * i)
                   for i in range(4)]
        auto_log = ListLog()
        auto = _fleet_run(params, cfg, serve, reqs[:32] + trickle, dev, eos,
                          FleetConfig(replicas=1, max_replicas=2, window_steps=2,
                                      scale_up_occupancy=0.9, scale_down_occupancy=0.45),
                          logger=auto_log)
        want = {r.rid: single_outs[r.rid] for r in reqs[:32]}
        want.update({1000 + i: single_outs[reqs[i].rid] for i in range(4)})
        _same_tokens({"auto": auto["outs"], "want": want}, "want", list(want), "(d) autoscale")
        events = [(r["event"], r.get("replica")) for r in auto_log.recs
                  if r["kind"] == "fleet_event"]
        order = [events.index(e) if e in events else -1 for e in
                 (("scale_up", 1), ("scale_down", 1), ("scale_down_complete", 1))]
        s = auto["s"]
        if (-1 in order or order != sorted(order) or s["replicas_peak"] != 2
                or s["replicas_final"] != 1 or s["scale_downs"] < 1):
            raise AssertionError(f"(d) autoscale events {events}, summary {s}")
        out["autoscale_events"] = events
        print(f"  (d) autoscale: events {events}; peak {s['replicas_peak']}, final "
              f"{s['replicas_final']}; tokens == one engine's", flush=True)

        # (e) a request stuck past EOS, with a deadline: evicted, a prefix
        short = reqs[:FLEET_SHORT]
        stuck = short[2].rid
        dl_log = ListLog()
        dl = _fleet_run(params, cfg, serve,
                        [dataclasses.replace(r, deadline_ms=500.0) if r.rid == stuck else r
                         for r in short], dev, eos,
                        FleetConfig(replicas=2, window_steps=8,
                                    kill_spec=f"stuck_request@{stuck}"), logger=dl_log)
        got, ref = dl["outs"][stuck], single_outs[stuck]
        miss = [r for r in dl_log.recs if r["kind"] == "deadline_miss"]
        reason = {c.rid: c.reason for c in dl["comps"]}[stuck]
        if (reason != "deadline" or len(miss) != 1 or not np.array_equal(got, ref[: len(got)])
                or dl["s"]["deadline_misses"] != 1):
            raise AssertionError(f"(e) deadline: reason {reason}, misses {miss}")
        _same_tokens({"dl": dl["outs"], "single": single_outs}, "single",
                     [r.rid for r in short if r.rid != stuck], "(e) the other requests")
        print(f"  (e) stuck_request@{stuck}, deadline 500 ms: evicted, reason deadline, "
              f"{miss[0]['over_ms']} ms over, {len(got) - len(short[2].ids)} tokens, a prefix "
              f"of the run without it; the other {FLEET_SHORT - 1} requests' tokens unchanged",
              flush=True)
        del params
        _free()

        # (f) the MoE model (8 experts, pallas), two replicas
        mcfg, mparams, mserve, mreqs, _ = build(dev, fused=True, num_experts=8)
        moe = _fleet_run(mparams, mcfg, mserve, mreqs[:FLEET_SHORT], dev, eos, two)
        check_outputs(moe["outs"], mreqs[:FLEET_SHORT], mcfg)
        mticks = _paged_formula(moe, mcfg.num_layers, "(f) MoE fleet")
        forwards = sum(e.prefill_dispatches + e.steps for e in moe["engines"])
        if moe["counts"]["moe_forward_up"] != mcfg.num_layers * forwards:
            raise AssertionError(f"(f) grouped forward launches {moe['counts']} != "
                                 f"{mcfg.num_layers} x {forwards}")
        out["moe_counts"] = moe["counts"]
        print("  " + _fleet_line("(f) MoE fleet of 2", moe) + f"; grouped forward "
              f"{moe['counts']['moe_forward_up']} = {mcfg.num_layers} x {forwards} forwards, "
              f"paged = {mcfg.num_layers} x {mticks} ticks", flush=True)
        del mparams
        _free()
        out["paged_counts"] = fleet["counts"]

        # (g) the entry point's two runs and tools/report.py on each JSONL
        for name, (proc, t0) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            print(f"  (g) python -m tpukit_torch.serve {' '.join(cli[name])}: exit "
                  f"{proc.returncode}, {time.perf_counter() - t0:.1f} s after its start",
                  flush=True)
            print("    " + "\n    ".join(l for l in stdout.splitlines() if l.startswith(
                ("fleet", "process fleet", "  failures", "  e2e", "  traces", "  SLO",
                 "  WARNING"))), flush=True)
            try:
                if proc.returncode != 0:
                    raise AssertionError(f"(g) {name} exited {proc.returncode}")
                gates = ["--min_fleet_tps", "1"]
                if name == "router":  # the process fleet's workers trace nothing
                    gates += ["--min_trace_complete", "1.0"]
                _tool("report", work / name / "fleet.jsonl", *gates)
                recs = [json.loads(l)
                        for l in (work / name / "fleet.jsonl").read_text().splitlines()]
                [s] = [r for r in recs if r["kind"] == "fleet_summary"]
                if (s["requests"] != FLEET_SHORT or s["duplicate_completions"] or s["kills"] != 1
                        or not s["requeued"] and name == "router"):
                    raise AssertionError(f"(g) {name}: fleet_summary {s}")
            except AssertionError as exc:
                raise AssertionError(f"{exc}\n(g) {name}'s stderr (its workers' too):\n"
                                     f"{stderr[-4000:]}") from None
            out[f"cli_{name}"] = dict(tokens_per_sec=s["tokens_per_sec"], kills=s["kills"],
                                      requeued=s["requeued"], wall_s=s["wall_s"])
            if name == "procs":
                codes = {d.get("code") for d in s["deaths"]}
                print(f"    deaths {s['deaths']}, worker exit codes {s['worker_exit_codes']}",
                      flush=True)
                if -9 not in codes:
                    raise AssertionError(f"(g) procs: no SIGKILLed worker in {s['deaths']}")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    shutil.rmtree(work)
    return out


GRID_REQUESTS = 16  # phase 46's bf16 run: one wave of a replica's 16 slots
GRID_F32 = 32  # phase 46's f32 token check: the first half of phase 5's stream


def _running(pid: int) -> bool:
    """Whether process `pid` runs (a zombie no longer does)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _grid_launches(run: dict, layers: int, what: str) -> list:
    """Phase 46: each rank of each grid replica launched each paged kernel
    layers x its replica's ticks (its own count, reported as its world
    closed); every rank process has exited. Returns the scores launches,
    a list a replica."""
    got = []
    for e in run["engines"]:
        want = paged_want(layers * e.steps)
        ranks = [{f"paged_{k}": v for k, v in c["paged_attention"].items()}
                 for c in e.rank_launches or []]
        if len(ranks) != len(e.devices) or e.steps == 0 or any(r != want for r in ranks):
            raise AssertionError(f"{what}: replica {e.replica}'s ranks launched {ranks}, "
                                 f"want {want} each ({layers} x {e.steps} ticks)")
        got.append([r["paged_scores"] for r in ranks])
    alive = [p for e in run["engines"] for p in e.pids() if _running(p)]
    if alive:
        raise AssertionError(f"{what}: rank processes {alive} outlived the run")
    return got


def grid_fleet_on_card(dev, smi: str, fused32: dict, single_tps: float) -> dict:
    """Phase 46 (see the module docstring). First the paged kernels against
    their plain versions at a grid rank's shape (6 of the 12 heads, every
    dtype pair; the path's is f32 pages, bf16 compute). Both fleets' worlds
    start together (eight rank processes), before anything is timed or
    run; each fleet's rank launches are counted from their start.
    `single_tps` is one engine's tokens/s on the same 16 requests (phase 42
    (a)'s median)."""
    cards = [dev] * 4  # two worlds of two gloo ranks a fleet, all on this card
    two = FleetConfig(replicas=2, devices_per_replica=2, window_steps=8)
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    rank_heads = cfg.heads // two.devices_per_replica  # model 2: the grid asserted below
    rank_shape = check_kernel(dev, {**serving_shape(cfg, serve), "h": rank_heads}, "grid rank")
    cfg32, params32, serve32, reqs32, _ = build(dev, fused=True, num_layers=4,
                                                compute_dtype=torch.float32)
    timed, reqs32 = reqs[:GRID_REQUESTS], reqs32[:GRID_F32]
    t0 = time.perf_counter()
    routers = [FleetRouter(p, c, sv, two, eos_id=eos, device=dev, devices=cards)
               for p, c, sv in ((params, cfg, serve), (params32, cfg32, serve32))]
    runs = []
    try:
        worlds = [list(r._replicas.values()) for r in routers]
        axes = [w.grid for ws in worlds for w in ws]  # waits for every rank's start
        start_s = time.perf_counter() - t0
        if axes != [{"data": 1, "model": 2}] * 4:
            raise AssertionError(f"grids {axes}")
        for router, ws, stream, c in zip(routers, worlds, (timed, reqs32), (cfg, cfg32)):
            comps = router.run(list(stream))
            torch.cuda.synchronize()
            run = dict(engines=ws, outs={x.rid: np.asarray(x.ids) for x in comps},
                       s=router.last_summary)
            check_outputs(run["outs"], stream, c)
            if run["s"]["params_placements"] != 2 or run["s"]["duplicate_completions"]:
                raise AssertionError(f"grid fleet summary {run['s']}")
            run["launches"] = _grid_launches(run, c.num_layers, "grid fleet")
            runs.append(run)
    finally:
        for router in routers:
            router.close()
    grid, grid32 = runs
    _same_tokens({"grid": grid32["outs"], "phase 5": fused32}, "phase 5",
                 [r.rid for r in reqs32], "(b) f32 grid fleet")
    s = grid["s"]
    out = dict(launches=grid["launches"], launches_f32=grid32["launches"], start_s=start_s,
               grid_tps=s["generated_tokens"] / s["wall_s"], single_tps=single_tps,
               at_rank_shape=rank_shape)
    print(f"  both fleets' worlds (8 gloo ranks on this card) started in {start_s:.1f} s", flush=True)
    print(f"  (a) bf16 12 layers, {GRID_REQUESTS} requests ({smi}): 2 replicas x model 2 (two "
          f"gloo ranks each, 6 heads a rank, on this card) {out['grid_tps']:.1f} tokens/s over "
          f"the router's wall {s['wall_s']:.3f} s; one engine {single_tps:.1f} tokens/s (phase "
          f"42 (a)'s; ratio {out['grid_tps'] / single_tps:.4f}); replica ticks "
          f"{[e.steps for e in grid['engines']]}, each rank's paged launches "
          f"{out['launches']} = {cfg.num_layers} x its replica's ticks; every rank exited",
          flush=True)
    print(f"  (b) f32 4 layers, {len(reqs32)} requests: the grid fleet's tokens == phase 5's "
          f"engine's; replica ticks {[e.steps for e in grid32['engines']]}, each rank's paged "
          f"launches {out['launches_f32']}", flush=True)
    del params, params32
    _free()
    return out


class ListLog:
    """A logger that keeps its records (`log(**record)`)."""

    def __init__(self):
        self.recs = []

    def log(self, **rec):
        self.recs.append(rec)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] in GLOO_FLAGS:
        return gloo_rank(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs one CUDA GPU",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")

    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    phase("build")
    build_all()

    # the serving run of phase 4 fixes the kernels' shapes for phase 3
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    shape = serving_shape(cfg, serve)

    phase("kernel vs plain")
    main_pair = check_kernel(dev, shape, "serving")
    paged_shapes = {label: check_kernel(dev, {**shape, **cut}, label)
                    for label, cut in PAGED_SHAPES.items()}

    phase("serve (GPT-2 small width, bf16, fused decode)")
    serve_run(params, cfg, serve, reqs[:4], dev, eos)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engine, outs = serve_run(params, cfg, serve, reqs, dev, eos)
    wall = time.perf_counter() - t0
    paged_counts = {k: v for k, v in read_counts().items() if k.startswith("paged_")}
    s = engine.last_summary
    print(f"served {s['requests']} requests / {s['generated_tokens']} tokens in "
          f"{wall:.3f} s ({s['generated_tokens'] / wall:.1f} tokens/s), occupancy "
          f"{s['mean_occupancy']:.3f}, decode ticks {engine.steps}, prefill "
          f"{s['prefill_s']:.3f} s / decode {s['decode_s']:.3f} s / sync {s['sync_s']:.3f} s, "
          f"kv_bytes {s['kv_bytes']}, max_live_slots {s['max_live_slots']}, prefix hits "
          f"{s['prefix_hits']}, max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    paged = paged_want(cfg.num_layers * engine.steps)
    print(f"paged_attend launches {paged_counts}: 3 kernels a call x "
          f"{cfg.num_layers} layers x {engine.steps} decode ticks = {paged}", flush=True)
    check_outputs(outs, reqs, cfg)
    if paged_counts != paged or engine.steps == 0:
        raise AssertionError(f"paged kernel launches {paged_counts} != {paged}")
    greedy = dict(tokens_per_s=s["generated_tokens"] / wall, prefill_s=s["prefill_s"],
                  decode_s=s["decode_s"], sync_s=s["sync_s"])

    phase("fused vs unfused (f32 compute, 4 layers)")
    cfg32, params32, serve32, _, _ = build(dev, fused=True, num_layers=4,
                                            compute_dtype=torch.float32)
    runs = {}
    for label, kw in (("fused", {}), ("unfused", dict(fused_decode=False)),
                      ("int8", dict(kv_dtype="int8"))):
        _, runs[label] = serve_run(params32, cfg32, dataclasses.replace(serve32, **kw),
                                   reqs, dev, eos)
        check_outputs(runs[label], reqs, cfg32)
    for r in reqs:
        a, b = runs["fused"][r.rid], runs["unfused"][r.rid]
        if not np.array_equal(a, b):
            m = min(len(a), len(b))
            pos = int(np.flatnonzero(a[:m] != b[:m])[0]) if (a[:m] != b[:m]).any() else m
            raise AssertionError(f"fused and unfused tokens diverge: rid {r.rid}, "
                                 f"position {pos}")
    agree = agreement(runs["int8"], runs["fused"])
    print(f"fused == unfused on all {len(reqs)} requests "
          f"({sum(len(v) for v in runs['fused'].values())} tokens incl. prompts); "
          f"int8 pages agree on {agree:.4f} of tokens (gate 0.9)", flush=True)
    if agree < 0.9:
        raise AssertionError(f"int8 token agreement {agree} < 0.9")

    phase("training kernels vs plain (the slice's shapes)")
    trained = check_training_kernels(dev)

    phase("attention crossover: eager xla path against the flash kernels")
    attention_crossover(dev)

    phase("train step at full width (gpt-small-dim768, batch 64, S 512, bf16)")
    step = train_full_width(dev)
    del step["state"]

    phase("train step through kernels == through plain versions (f32, 2 layers)")
    kernel_vs_plain_steps(dev)

    phase("recipe 1 end to end (GPT-2-small width, fixture corpus)")
    recipe_end_to_end(dev)

    phase("MoE kernels vs plain (grouped-expert FFN, 8 x 768 -> 3072 -> 768)")
    moe_runs = check_moe_kernels(dev)
    moe_main, moe_decode = moe_runs["equal"], moe_runs["decode"]

    phase("MoE train step at full width (gpt-small-dim768-e8, batch 32, S 512, bf16)")
    moe_step = moe_train_full_width(dev)

    phase("MoE train step through kernels == through plain versions (f32, 2 layers, top-2)")
    moe_kernel_vs_plain_steps(dev)

    phase("recipe 8 end to end (GPT-2-small width, 8 experts, pallas, fixture corpus)")
    moe_run = moe_recipe_end_to_end(dev)

    phase("MoE serving (GPT-2 small width, 8 experts, pallas, bf16, fused decode)")
    moe_served = moe_serving(dev)

    phase("MoE fused vs unfused vs plain (f32 compute, 4 layers)")
    moe32 = moe_fused_vs_unfused(dev)

    # recipes 2 and 3 run in a world of one over NCCL, destroyed after them
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        phase("DDP and FSDP at full width (gpt-small-dim768, batch 64, S 512, bf16, NCCL "
              "world of one)")
        dp_full_width(dev, step)

        phase("DDP and FSDP steps == single-device steps (f32, 2 layers)")
        dp_equals_single(dev)

        phase("recipes 2 and 3 end to end (GPT-2-small width, fixture corpus)")
        recipe_end_to_end(dev, ddp_recipe, "recipe 2", metrics_log=str(XLA_LOG))
        recipe_end_to_end(dev, fsdp_recipe, "recipe 3")

    phase("threefry on the card (random bits, uniforms, keys, Gumbel noise, the sampler)")
    threefry_on_card(dev)

    phase("sampled serving (GPT-2 small width, bf16, t 0.8, top-k 40, fused decode)")
    sampled_serving(dev, greedy)

    phase("ring serving (GPT-2 small width, bf16, page_size 0; MoE on the ring)")
    ring = ring_serving(dev, greedy)

    phase("speculative serving (ngram on the repetitive stream, draft model; spec_k 4)")
    spec = speculative_serving(dev, ring)

    phase("dropout training (gpt-small-dim768, batch 64, S 512, bf16, dropout 0.1)")
    dropout_training(dev, step)

    # recipes 4 and 5 run in a world of one over NCCL (one stage), destroyed after them
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        phase("pipeline: GPipe and 1F1B at full width (gpt-small-dim768, batch 64, S 512, "
              "bf16, M 4, NCCL world of one)")
        piped = pipeline_full_width(dev, step)

        phase("pipeline steps == single-device steps (f32, 2 layers, M 4)")
        pipeline_equals_single(dev)

        phase("recipes 4 and 5 end to end (GPT-2-small width, fixture corpus)")
        recipe_end_to_end(dev, pipe_recipe, "recipe 4", kernels=("flash_",))
        recipe_end_to_end(dev, pipe_ddp_recipe, "recipe 5", kernels=("flash_",))

    phase("checkpoints in tpukit's formats (recipe 1, GPT-2-small width)")
    ckpt_runs = checkpoint_formats(dev)

    phase("serve the recipe's checkpoint (GPT-2-small width, bf16, fused decode)")
    serve_checkpoints(dev, ckpt_runs, greedy)

    phase("serve an MoE checkpoint and a draft checkpoint")
    serve_moe_and_draft(dev, moe_run, spec, ckpt_runs)
    del ckpt_runs, moe_run, spec
    _free()

    # recipe 6 and the serving grid run in a world of one over NCCL
    t_tp = time.perf_counter()
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        phase("tensor parallel at full width (gpt-small-dim768, batch 64, S 512, bf16, NCCL "
              "world of one)")
        tp_run = tp_full_width(dev, step)

        phase("TP steps == single-device steps (f32, 2 layers; model 2 over two gloo ranks)")
        tp_equals_single(dev)

        phase("recipe 6 end to end (GPT-2-small width, fixture corpus)")
        recipe_end_to_end(dev, tp_recipe, "recipe 6", kernels=("flash_",))

        phase("dense serving through the serving grid (pick_serve_grid -> TensorParallel)")
        tp_served = tp_serving(dev, runs["fused"], moe32)
    print(f"phases 30-33: {time.perf_counter() - t_tp:.1f} s", flush=True)
    _free()

    # recipe 7 runs in a world of one over NCCL
    t_cp = time.perf_counter()
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        phase("context parallel at full width (gpt-small-dim768, bf16, 32768 tokens a step: "
              "ring B16 x S2048, Ulysses B4 x S8192, NCCL world of one)")
        cp_runs = cp_full_width(dev, step)

        phase("CP steps == single-device steps (f32, 2 layers; Ulysses seq 2 over two gloo "
              "ranks)")
        cp_equals_single(dev)

        phase("recipe 7 end to end, ring and Ulysses (GPT-2-small width, fixture corpus)")
        recipe_end_to_end(dev, ring_recipe, "recipe 7 (ring)", kernels=("ce_",))
        recipe_end_to_end(dev, ring_recipe, "recipe 7 (ulysses)",
                          extra=("--cp_attention", "ulysses"))
    print(f"phases 34-36: {time.perf_counter() - t_cp:.1f} s", flush=True)
    _free()

    # MoE under DataParallel in a world of one over NCCL; EP over gloo ranks
    t_ep = time.perf_counter()
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        phase("MoE under DataParallel == SingleDevice (e8 rung, NCCL world of one); EP on "
              "(data 1, expert 2) over two gloo ranks == the single device (f32, 2 layers)")
        ep = ep_equals_single(dev)
        ep_counts = ep["counts"]
    print(f"phase 37: {time.perf_counter() - t_ep:.1f} s", flush=True)
    _free()

    # the quantized wires: DataParallel / FSDP in a world of one over NCCL,
    # DataParallel int8 over two gloo ranks, phase 37's exchange at int8 and bf16
    t_q = time.perf_counter()
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        phase("quantized collectives and gradient buckets: DDP and FSDP at --comm_dtype int8 "
              "and f32 --grad_buckets 4 (gpt-small-dim768, NCCL world of one); DDP int8 over "
              "two gloo ranks == the step in one process; EP (data 1, expert 2) int8 and bf16 "
              "exchanges")
        quant_runs = quant_full_width(dev, step)
        quant_pairs = quant_gloo_and_ep(dev, ep)
    print(f"phase 38: {time.perf_counter() - t_q:.1f} s", flush=True)
    _free()

    t_r = time.perf_counter()
    phase("resilience on the card: recipe 1 (GPT-2-small width, batch 64, S 512, 33 steps) "
          "preempted and resumed, rolled back, aborted (76, 77), async saves kept 2")
    resilience_on_card(dev, smi)
    print(f"phase 39: {time.perf_counter() - t_r:.1f} s", flush=True)

    t_t = time.perf_counter()
    phase("training telemetry on the card: recipe 1 (GPT-2-small width, batch 64, S 512, 17 "
          "steps) with the JSONL, metrics, norms, checksums and the watchdog, against it off; "
          "a hang bundle and its anomaly trace; --profile_dir; --debug_nans")
    telemetry = telemetry_on_card(dev, smi)
    print(f"phase 40: {time.perf_counter() - t_t:.1f} s ({smi}); chip_smoke so far "
          f"{time.perf_counter() - _START:.1f} s", flush=True)

    t_s = time.perf_counter()
    phase("serving telemetry on the card: phase 4's engine and stream with request traces, "
          "the metrics plane, --slo, the JSONL and a metrics dir, against them off; sampled, "
          "n-gram and MoE on and off; python -m tpukit_torch.serve and tpukit's tools")
    serving = serving_telemetry_on_card(dev, smi)
    print(f"phase 41: {time.perf_counter() - t_s:.1f} s ({smi}); chip_smoke so far "
          f"{time.perf_counter() - _START:.1f} s", flush=True)

    t_f = time.perf_counter()
    phase("serving fleet on the card: FleetRouter over ServeEngine replicas at phase 4's "
          "width (tokens/s beside one engine; f32 tokens with a kill, disaggregated prefill, "
          "autoscale, a deadline; MoE replicas); python -m tpukit_torch.serve --replicas 2 "
          "and --fleet_procs with a real SIGKILL")
    fleet = serving_fleet_on_card(dev, smi, greedy)
    print(f"phase 42: {time.perf_counter() - t_f:.1f} s ({smi}); chip_smoke so far "
          f"{time.perf_counter() - _START:.1f} s", flush=True)

    t_a = time.perf_counter()
    phase("comm audit and native tokenizer on the card: phase 38's DDP int8 and FSDP f32 "
          "--grad_buckets 4 steps, phase 11's e8 step under EP, phase 33's serving-grid "
          "decode and phase 38's DDP int8 over two gloo ranks, linted against their plans; "
          "recipe 2's kind=\"xla\" records through tools/report.py; the native tokenizer")
    per_step = lambda run: {k: v // len(run["losses"])  # noqa: E731
                            for k, v in run["counts"].items()}
    audits = {f"{label} (phase 38)": dict(quant_runs[label]["audit"],
                                          want=per_step(quant_runs[label]))
              for label in QUANT_AUDITED}
    audits["e8 under EP 1 x 1 (phase 11)"] = dict(moe_step["audit"], want=per_step(moe_step))
    grid = tp_served["audit"]
    audits["serving grid decode (phase 33)"] = dict(
        grid, want=paged_want(grid["layers"] * grid["ticks"]))
    audited = comm_audit_and_tokenizer(dev, audits, quant_pairs["dp_gloo_audit"], smi)
    print(f"phase 43: {time.perf_counter() - t_a:.1f} s ({smi}); chip_smoke so far "
          f"{time.perf_counter() - _START:.1f} s", flush=True)

    t_b = time.perf_counter()
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        phase("the bench twin (python -m tpukit_torch.bench's headline and comm_overlap at "
              "2 steps, NCCL world of one)")
        bench_twin = bench_twin_on_card(dev, smi)
    print(f"phase 44: {time.perf_counter() - t_b:.1f} s ({smi}); chip_smoke so far "
          f"{time.perf_counter() - _START:.1f} s", flush=True)
    _free()

    t_s = time.perf_counter()
    phase("the bench twin's serving records (tpukit_torch/bench/serving.py: serving, paged_kv, "
          "spec_decode, serve_dispatch_attribution, decode_fused, fleet_serving and both "
          "overheads at 8 requests, spec trained 100 / 150 steps and 24 new tokens; a world "
          "of one)")
    bench_served = bench_serving_on_card(dev, smi)
    print(f"phase 45: {time.perf_counter() - t_s:.1f} s ({smi}); chip_smoke so far "
          f"{time.perf_counter() - _START:.1f} s", flush=True)
    served_counts = bench_served["counts"]

    t_g = time.perf_counter()
    phase("fleet replicas over a model-parallel grid (item 19b): FleetRouter, 2 replicas x "
          "devices_per_replica 2 on this card, each a world of two gloo ranks (model 2); "
          "phase 4's engine on 16 requests beside one engine; f32 4 layers == one engine")
    grid_fleet = grid_fleet_on_card(dev, smi, runs["fused"], fleet["tokens_per_s"]["single"])
    print(f"phase 46: {time.perf_counter() - t_g:.1f} s ({smi}); chip_smoke so far "
          f"{time.perf_counter() - _START:.1f} s", flush=True)

    def under_bench_serving(key):  # phase 45's launches of `key`, by record
        return {n: c[key] for n, c in served_counts.items() if c.get(key)}

    fl, ce = trained["flash"], trained["ce"]
    tel = telemetry["counts"]  # one step of phase 40's telemetry run (all 17 equal)

    def entry(name, source, replaces, launches, res, way, err, library_ms, **extra):
        bound, bound_by = res[f"{way}_bound"]
        return {"name": name, "route": "cuda", "source": f"tpukit_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": res[f"{way}_ms"], "call_ms": res[f"{way}_call_ms"],
                "plain_ms": res[f"{way}_plain_ms"], "bound_ms": bound, "bound_by": bound_by,
                "library_ms": library_ms, **extra}

    c, mc = step["counts"], moe_step["counts"]

    def ep_shapes(way):  # phase 10's timings of a rank's bank under EP
        return {f"E_local {e} x {MOE_ROUTED['experts'] * MOE_ROUTED['batch'] * 80 // e} rows": {
            k: moe_runs[f"ep_local{e}"][f"{way}{k}"]
            for k in ("_ms", "_call_ms", "_plain_ms", "_bound", "_err")}
            for e in EP_LOCAL_EXPERTS}
    under_cp = lambda key: {k: r["counts"][key] for k, r in cp_runs.items()}

    def under_quant(key):  # phase 38's full-width runs, and rank 0 of the gloo pair (f32)
        out = {k: r["counts"][key] for k, r in quant_runs.items()}
        f32 = {"flash_forward": "flash_forward", "ce_forward": "ce_forward_f32"}.get(key)
        if f32 is not None:
            out["ddp int8, 2 gloo ranks, f32 2 layers (rank 0)"] = \
                quant_pairs["ddp_int8_gloo"][f32]
        return out
    phase("kernel results")
    print(json.dumps({"kernels": [
        {"name": "paged_attend", "route": "cuda",
         "source": "tpukit_torch/csrc/paged_attention.cu",
         "replaces": "tpukit/ops/paged_attention.py:105",
         "launches": paged_counts["paged_scores"], "library_ms": None, **main_pair,
         "kernels_per_call": 3,
         "launches_by_kernel": {k[len("paged_"):]: v for k, v in paged_counts.items()},
         "launches_under_tp": tp_served["counts"]["paged_scores"],
         "launches_under_serving_telemetry": serving["counts"]["paged_scores"],
         "launches_under_fleet": fleet["paged_bf16"],
         "launches_under_fleet_f32_4_layers": fleet["paged_counts"]["paged_scores"],
         "launches_under_grid_fleet_by_rank": grid_fleet["launches"],
         "at_grid_rank_shape": grid_fleet["at_rank_shape"],
         "launches_under_comm_audit": grid["counts"]["paged_scores"],
         "launches_under_bench_serving": under_bench_serving("paged_scores"),
         "at_bench_decode_fused_shape": bench_served["paged"],
         "shapes": paged_shapes},
        entry("flash_attention_fwd", "flash_attention.cu", "tpukit/ops/pallas_attention.py:178",
              c["flash_forward"], fl, "fwd", fl["fwd_err"], fl["fwd_library_ms"],
              launches_under_pipeline={k: r["counts"]["flash_forward"]
                                       for k, r in piped.items()},
              launches_under_tp=tp_run["counts"]["flash_forward"],
              launches_under_cp=under_cp("flash_forward"),
              launches_under_quant=under_quant("flash_forward"),
              launches_under_telemetry=tel["flash_forward"],
              launches_under_comm_audit={k: a["counts"]["flash_forward"]
                                         for k, a in audits.items() if "flash_forward" in
                                         a["counts"]},
              launches_under_bench=bench_twin["headline_launches"]["flash_forward"],
              launches_under_bench_serving=under_bench_serving("flash_forward"),
              at_ulysses_shape=trained["flash_8192"]),
        entry("flash_attention_bwd", "flash_attention.cu", "tpukit/ops/pallas_attention.py:259",
              c["flash_backward_dkv"], fl, "bwd", fl["bwd_err"], fl["bwd_library_ms"],
              also_replaces=["tpukit/ops/pallas_attention.py:346",
                             "tpukit/ops/pallas_attention.py:389"],
              kernels_per_call=3, launches_by_kernel={"dcap": c["flash_backward_dcap"],
                                                      "dkv": c["flash_backward_dkv"],
                                                      "dq": c["flash_backward_dq"]},
              launches_under_pipeline={k: r["counts"]["flash_backward_dkv"]
                                       for k, r in piped.items()},
              launches_under_tp=tp_run["counts"]["flash_backward_dkv"],
              launches_under_cp=under_cp("flash_backward_dkv"),
              launches_under_quant=under_quant("flash_backward_dkv"),
              launches_under_telemetry=tel["flash_backward_dkv"],
              launches_under_bench_serving=under_bench_serving("flash_backward_dkv")),
        entry("fused_head_ce_fwd", "fused_head_ce.cu", "tpukit/ops/fused_head_ce.py:65",
              c["ce_forward"], ce, "fwd", ce["fwd_err"], None,
              kernels_per_call=2, launches_by_kernel={"forward": c["ce_forward"],
                                                      "combine": c["ce_forward_combine"]},
              launches_under_cp=under_cp("ce_forward"),
              launches_under_quant=under_quant("ce_forward"),
              launches_under_telemetry=tel["ce_forward"],
              launches_under_bench_serving=under_bench_serving("ce_forward_f32")),
        entry("fused_head_ce_bwd", "fused_head_ce.cu", "tpukit/ops/fused_head_ce.py:134",
              c["ce_backward_dw"], ce, "bwd", ce["bwd_err"], None,
              kernels_per_call=4 * c["ce_backward_dw"] // c["ce_forward"],
              launches_by_kernel={k: c[f"ce_backward_{k}"]
                                  for k in ("d", "dh", "dh_combine", "dw")},
              unfused_ms=ce["unfused_ms"], launches_under_cp=under_cp("ce_backward_dw"),
              launches_under_quant=under_quant("ce_backward_dw"),
              launches_under_telemetry=tel["ce_backward_dw"],
              launches_under_bench_serving=under_bench_serving("ce_backward_dw_f32")),
        entry("moe_grouped_ffn_fwd", "moe_gemm.cu", "tpukit/ops/moe_gemm.py:110",
              mc["moe_forward_up"], moe_main, "fwd", moe_main["fwd_err"], None,
              kernels_per_call=2, launches_by_kernel={"up": mc["moe_forward_up"],
                                                      "down": mc["moe_forward_down"],
                                                      "combine": mc["moe_forward_combine"]},
              library_products_ms=moe_main["fwd_library_products_ms"],
              units=moe_main["units"],
              launches_under_comm_audit=audits["e8 under EP 1 x 1 (phase 11)"]["counts"][
                  "moe_forward_up"],
              launches_under_ep_f32={k: ep_counts[f"forward_{k}_f32"] for k in ("up", "down")},
              **{f"launches_under_ep_{c}_exchange": {
                  k: quant_pairs[f"ep_{c}"][f"forward_{k}_f32"] for k in ("up", "down")}
                 for c in QUANT_EXCHANGES},
              at_ep_shapes=ep_shapes("fwd")),
        entry("moe_grouped_ffn_fwd_decode", "moe_gemm.cu", "tpukit/ops/moe_gemm.py:110",
              moe_served["counts"]["moe_forward_up"], moe_decode, "fwd", moe_decode["fwd_err"],
              None, kernels_per_call=4, launches_by_kernel={
                  k: moe_served["counts"][f"moe_forward_{k}"] for k in ("up", "down", "combine")},
              library_products_ms=moe_decode["fwd_library_products_ms"],
              units=moe_decode["units"],
              launches_under_data_grid_f32=tp_served["moe_forward_up"],
              launches_under_serving_telemetry_16=serving["moe"]["counts"]["moe_forward_up"],
              launches_under_fleet_16=fleet["moe_counts"]["moe_forward_up"]),
        entry("moe_grouped_ffn_bwd", "moe_gemm.cu", "tpukit/ops/moe_gemm.py:145",
              mc["moe_backward_dh"], moe_main, "bwd", moe_main["bwd_err"], None,
              kernels_per_call=4, launches_by_kernel={
                  k: mc[f"moe_backward_{k}"] for k in ("dz2", "dh", "dx", "dw")},
              library_products_ms=moe_main["bwd_library_products_ms"],
              launches_under_ep_f32={k: ep_counts[f"backward_{k}_f32"]
                                     for k in ("dh", "dx", "dwu", "dwd")},
              **{f"launches_under_ep_{c}_exchange": {
                  k: quant_pairs[f"ep_{c}"][f"backward_{k}_f32"]
                  for k in ("dh", "dx", "dwu", "dwd")} for c in QUANT_EXCHANGES},
              at_ep_shapes=ep_shapes("bwd")),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
