#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and triton; imports nothing of JAX.  Phases
(each one raises, and the script exits non-zero, on any failure):

1. build   — compile the ten CUDA libraries (LayerNorm and RMSNorm
             fwd/bwd; RoPE; the fused decode kernels with their
             contiguous-cache and int8-weight variants, the largest build;
             flash attention fwd/bwd; fused Adam; the block quantizer; fused
             Adam8bit; the LAMB phases; dropout; the quantized collectives'
             int8 codec), one nvcc each, started together,
             while Triton compiles the softmax and bias_act kernels; print
             build seconds and the ptxas register / shared-memory / spill
             lines (and any wgmma serialization warning; each kernel by
             its name and template arguments, the flash kernels' ALiBi
             instances as ``*_alibi_kernel``), and the dynamic shared
             memory a block of each wgmma flash kernel takes (forward, dQ,
             dK/dV);
2. kernels — each kernel against its plain PyTorch version at the serving
             path's shapes, fp32 and bf16 (and fp16 for the kernels of the
             fp16 training path and for the tensor-core norm_qkv and
             proj_norm, bit-equal on a repeat), with the tolerances of TOL below
             (the flash-decode kernel in fp32, bf16 and fp16 at depths
             1..1024 across page boundaries and on its chunk edges, 2047 keys
             of a 2048-token window, a shuffled page table, 256- and 16-token
             pages, bit-equal on a repeat),
             every RoPE form (x [..., S, D], q and k in the projections'
             layout with one table or per-row tables, the backward, the
             fused decode's QKV rows) bit-equal to its plain version in
             fp32, bf16 and fp16, with fp32 tables and tables in x's dtype,
             both signs, partial rd and strided views, and on a repeat;
             then CUDA-event timings (median of TIME_SAMPLES (25) samples of 20 calls;
             the GEMV kernels cycle through enough weight copies to miss
             the 50 MB L2, as 32 layers do; RoPE at its four path shapes,
             the serve prefill's q + k [1, 64, 32 + 8, 128], generate()'s
             prefill [8, 256, 32 + 8, 128], a decode step's QKV rows
             [8, 32 + 8, 128] and llama-1b4's q + k [4, 2048, 16 + 16, 128]
             forward and backward: device us alone and from a CUDA graph,
             call ms, host us a call, ``copy_`` of the same bytes, the
             bound) beside the plain version, the
             PyTorch library call where one exists, ``torch.matmul`` of
             the same activations and weights as a yardstick for the three
             GEMV kernels, and the bound (norm_qkv and proj_norm also at
             gpt2-xl's shapes, each with its share of the bound, its host
             time a call, and ptxas's registers, shared memory and spills
             of their tensor-core kernels; the paged flash-decode at the serve
             profile's depths, at 300 and 2048 keys and at gpt2-xl's heads,
             each beside its own bound, its device time a launch after a
             128 MB read (L2 cold) and its host time a call, and ptxas's
             registers and spills of its instances); then the four training kernels
             at llama-1b4's training shapes (flash attention fwd and bwd
             on [4, 16, 2048, 128], RMSNorm bwd on [8192, 2048] and
             mixtral-8x7b's [8192, 4096], each with its device time by
             kernel, Adam over
             a [24, 2048, 5632] leaf, three steps), fp32 and bf16, plus a
             ragged S, with bit-equal repeats of each backward, and the
             serving kernels at the training shapes (RMSNorm fwd on
             [8192, 2048], RoPE on q and k [4, 2048, 16 + 16, 128] forward
             and backward, bit-equal); then the flash kernels' ALiBi
             instances against the plain version with the JAX ALiBi bias:
             bloom-1b7's training shape [4, 16, 2048, 128] bf16, and 12
             heads (interpolated slopes) at head dims 64 and 32 and a
             ragged S, fp32 and bf16; timed at the training shape beside
             the plain version and SDPA given the ALiBi + causal bias as a
             float [1, H, S, S] mask (its forward; its backward; both),
             with each kernel's device time; then the four training
             kernels' timings beside SDPA, ``F.rms_norm``'s autograd
             backward and torch's fused AdamW as yardsticks, with the
             device time of the flash forward and of each of the
             backward's three kernels (delta, dQ, dK/dV; also at
             gpt2-xl's shape);
             the same checks and timings for the fp16 instances of the
             flash kernels (every head dim, with and without ALiBi, beside
             SDPA in fp16) and of fused Adam (fp16 params, beside
             ``AdamW(fused=True)`` over fp16 params), RMSNorm, LayerNorm
             and RoPE in fp16, and the overflow check: do past fp16's
             range gives non-finite grads, and grads past it come out inf
             where the plain fp32 value is past 65520, never clamped;
             then the four decode kernels again at gpt2-xl's shapes and
             branches ([8, 1600], LayerNorm with a bias, tanh-GeLU without
             a gate, 25 heads of 64 with one query head per KV head) and
             Adam on its [1600] and [48, 1600] leaves;
             then the gpt2-xl kernels: LayerNorm fwd and bwd at
             [8192, 1600], bloom-1b7's [8192, 2048], [8, 1600] and ragged
             shapes (fwd and bwd bit-equal on a second call; the bwd's
             timing at both training shapes, with its device and host time
             a call),
             scaled masked softmax with and without a causal
             mask at [4, 25, 1024, 1024] and at a row length that is no
             power of two, bias_act for each activation at [8192, 6400],
             flash attention fwd and bwd at [8, 25, 1024, 64], fp32 and
             bf16, and their timings beside ``F.layer_norm`` (and its
             autograd backward), ``torch.softmax`` and ``F.gelu(x + b)``;
             then the optimizers' kernels at the [24, 2048, 5632] leaf and
             a ragged one, three steps: fused Adam8bit (bf16 params with
             stochastic rounding, fp32 params; fp32 and bf16 grads; blocks
             512 and 4096), the two LAMB phases (norms bit-equal on a
             repeat) and quantize (bits 8 and 4, blocks 128 / 512 / 2048),
             and their timings beside the plain versions and the bound
             (PyTorch has no call for these functions); then generate()'s
             kernels: flash_decode over the contiguous [2, 8, Hkv, Smax,
             Dh] cache at layer 1 (Smax 512, 1025, 64 and 2048, depths
             1..Smax as one scalar and one a row and on the chunk edges,
             fp32, bf16 and fp16, ALiBi, gpt2-xl's 25 heads of 64,
             bit-equal on a repeat) and the int8 bodies of the three GEMVs (bf16,
             at llama3-8b's shapes, gpt2-xl's branches and a ragged N; the
             int8 proj_norm and MLP also at 1 and 12 rows and bit-equal on a
             repeat), timed beside the plain version, SDPA on the same cold
             work (contiguous flash_decode, 264 deep in a 512 cache and 2048
             in a 2048 cache, K/V cycled through > 100 MB) or ``torch.matmul`` of a
             bf16 weight (the int8 GEMVs' yardstick) and the bound; the int8
             MLP's device time split between its two launches, at llama3-8b's
             and gpt2-xl's shapes, with ptxas's registers for its kernels;
             RMSNorm's call at the serving and the training shape beside
             ``F.rms_norm``, its public ``rms_norm()`` call, and the host
             microseconds of each stage of its call path (perf_counter_ns
             over 20000 calls a stage), and the same stages of LayerNorm's
             call at [8, 1600], beside ``F.layer_norm`` at [8, 1600] and
             [64, 1600]; both forwards at their serve, prefill and train
             shapes (LayerNorm [8, 1600], [64, 1600], [8192, 1600],
             [8192, 2048]; RMSNorm [8, 4096], [64, 4096], [1600, 4096],
             [8192, 2048]): device us a launch alone (x cycled past the
             L2) and from a CUDA graph, call ms and host us, beside the
             bound, ``F.layer_norm`` / ``F.rms_norm`` timed alike, and the
             device time of ``copy_`` over the same bytes;
3. reference — a small fp32 model served on the card (kernels) and on the
             CPU (plain versions) must give the same greedy tokens, on the
             default fused decode path and on ``use_fused_decode: False``,
             over the paged and the fixed-slot layout; the int8 KV cache
             (paged serving with a prefix hit, fixed-slot, ``generate()``)
             and mixtral-tiny (serving and ``generate()``) the same way;
             and the same small model trained 3 steps on the card (TF32
             off) and on the CPU: losses and final weights agree; each for a
             llama-shaped and a gpt2-shaped model (learned positions,
             LayerNorm, GeLU, a plain MLP), and the same models through
             ``init_inference(...).generate()`` (fp32 fused and unfused,
             int8 weights fused): the same tokens on both; the llama-tiny
             preset as it is (8 heads of 32: flash at head dim 32) trained
             3 steps, card against CPU, and the mixtral-tiny preset as it
             is (4 layers, 8 experts top-2) the same way, its loss with the
             MoE aux term; a small BLOOM (ALiBi, 12 heads)
             and a small GPT-NeoX (the parallel residual, rotary_pct 0.25),
             each through ``config_from_hf``, trained 3 fp32 steps, card
             against CPU; then the llama-shaped model on the new optimizer
             paths: FusedLamb and Adam8bit over fp32 masters, Adam8bit
             master-free bf16;
   ops     — the ops of the public kernel library that no model path
             calls, driven through the library's wrappers:
             ``scaled_masked_softmax`` with a causal mask and ``bias_act``
             at gpt2-xl's shapes, ``quantize`` -> ``dequantize`` (8 and 4
             bits) and ``pack_int4`` -> ``unpack_int4`` on the
             [24, 2048, 5632] fp32 leaf; the fp16 instances on no train
             path: bloom-1b7's attention in fp16 through
             ``flash_attention(..., alibi=True)`` forward and backward and
             an fp16 leaf through ``fused_adam_update``; their launches
             are counted over this phase;
4. serve   — the main path: ``init_serving(causal_lm("llama3-8b"),
             {"dtype": "bfloat16", ...})`` with the default decode (fused)
             at full width and depth with random bf16 weights from seed 0,
             8 greedy requests, then a second wave with an exact repeat and
             a shared-prefix request; launch counters are zeroed just before
             and read just after, and must match the path's launch plan;
             then one more wave under torch.profiler (device busy share,
             top kernels, each kernel's device time per launch); then the
             unfused decode path on the same weights, a shorter wave with
             its own launch plan; then the same for ``gpt2-xl`` at full
             width and depth (LayerNorm in place of RMSNorm, no RoPE);
   generate — the main path of the sixth slice:
             ``init_inference(causal_lm("llama3-8b"), {"dtype":
             "bfloat16", "max_out_tokens": 1024}).generate()`` at full
             width and depth (random bf16 weights from seed 0): 8 greedy
             prompts of 200 tokens x 64 new, 3 of them with an EOS id (the
             cache reused), top-k 50 sampling twice from one seed; each
             call's launches equal to its plan; a profiled call; then the
             same with ``{"dtype": "int8"}`` (resident weight bytes equal
             to the count from the leaf shapes; the share of greedy tokens
             equal to the bf16 run's) and a short int8 wave through
             ``init_serving``, the int8 engine built from the module moved
             to the host (its peak below bf16's);
   fixed_slot_serve, kv_int8 — llama3-8b again: the serve waves on
             ``paged_kv_cache: false`` (fused, the contiguous flash_decode
             at per-row positions), then ``quantize_kv_cache: true`` (one
             serve wave and one ``generate()``, the unfused loop): launches
             equal to their plans, cache bytes, tok/s, peak memory, the
             share of greedy tokens equal to the bf16 paged / bf16 runs;
   mixtral_serve — mixtral-8x7b at full width with 8 layers (11.87B
             parameters, bf16, seed 0) on the one card: the serve waves and
             ``generate()`` of 8 x 200 + 64, rms_norm and rope launches
             equal to the plan, tok/s, peak memory, the busy share;
5. train   — the training path, after the serve phase has released its
             memory: ``deepspeed_tpu_torch.initialize(causal_lm(
             "llama-1b4"), config)`` at full width and depth, random fp32
             weights from seed 0, bf16 compute, FusedAdam, WarmupLR,
             clipping, micro 4 x gas 2 x S 2048, 5 ``train_step``s on one
             repeated batch of seeded random tokens; losses finite and
             falling, launch counters (zeroed just before, read just
             after) equal to the path's plan; then one step under
             torch.profiler; then ``fp16_train``: the same cell with
             ``"fp16": {"enabled": true}`` in place of bf16 (fp16 compute
             over fp32 masters, dynamic loss scale from 2^16), five
             applied steps after any skipped for an overflow, each step's
             loss scale and skip flag printed, the fp16 flash kernels'
             launches equal to the plan, its median step beside the bf16
             phase's; then the same for ``gpt2-xl`` at full width and
             depth (micro 8 x gas 2 x S 1024, the preset's full-layer
             remat); then llama-1b4 twice more, the same way: config A
             (``adam8bit_train``: ``bf16.master_weights: false``, a bf16
             accumulator, Adam8bit; the optimizer state's bytes must equal
             the count from the leaf shapes and every master be bf16) and
             config B (``lamb_train``: FusedLamb over fp32 masters), each
             with its peak memory beside the FusedAdam phase's; then
             ``bloom_train``: bloom-1b7 (D 2048, 24 layers, 16 heads of
             128, vocab 250880; 1.722B) built from its published
             config.json through ``config_from_hf`` and
             ``CausalLM(cfg, seed=0)``, at full width and depth, remat
             ``mlp_dots``, with TRAIN_CONFIG at micro 4 x gas 2 x S 2048,
             5 steps: every attention call through the ALiBi flash
             kernels, launches equal to the plan; then ``mixtral_train``:
             mixtral-8x7b at full width (D 4096, F 14336, 8 experts
             top-2, 32/8 heads of 128) cut to 2 of its 32 layers (3.165B
             parameters), TRAIN_CONFIG at micro 4 x gas 2 x S 2048, MFU
             over the active parameters (the attention, the router, 2 of
             8 experts and the head); each train phase reports
             the mean of steps 2-5 and the median of steps 3-5;
   zero_offload_* — ZeRO-Offload of the optimizer state (fp32 masters and
             moments on the host, the host C++ Adam built by g++):
             ``zero_offload_reference`` (the llama-tiny preset, 3 fp32
             steps, card == CPU, and the nvme backend bit-equal to cpu);
             ``zero_offload_train`` (llama2-7b at full width, bf16 over
             host AdamW, micro 2 x gas 2 x S 2048, remat full, 4 steps, as
             deep as 80 % of MemAvailable holds: the host's cores and
             memory, each step's split into fwd/bwd, D2H, host step and
             H2D, the host step's GB/s, tokens/s, MFU, peak, host state
             bytes, what FusedAdam would hold; no optimizer state on the
             card); ``zero_offload_nvme`` (llama-1b4 at 4 layers with the
             state in NVMe files: bit-equal to the cpu backend, aio read
             and write GB/s, save, a fresh engine's load and a bit-equal
             step 4); ``bloom_fp16_offload_train`` (bloom-1b7 in fp16 with
             host Adam, beside device FusedAdam: the same skips, losses
             within 1e-3, the fp16 ALiBi flash kernels on a train path);
             zero_offload_train cut to ZERO_OFFLOAD_TRAIN_LAYERS for the
             smoke's time;
   param_offload_* — ZeRO-Infinity (``offload_param`` + ``offload_optimizer``
             cpu: params, grads and accumulators on the host too, one layer
             at a time on the card): ``param_offload_reference`` (the
             llama-tiny preset, 3 fp32 steps: card == CPU, prefetch off
             bit-equal to on, ``int8_masters`` + ``int8_stream`` card ==
             CPU with at least 1.3x fewer h2d bytes than a bf16 relay,
             every slot reused after its readers' event, launches equal to
             the streamed plan, the peak flat from 4 layers to
             PARAM_OFFLOAD_DEEP_LAYERS);
             ``param_offload_train`` (llama2-7b at full width as deep as
             80 % of MemAvailable holds at 18 B a parameter, bf16 over host
             AdamW, micro 2 x gas 2 x S 2048, 3 steps, run before the
             phases that pin host memory: each step's split, h2d / d2h
             bytes and their device copy time, prefetch hits, tokens/s,
             MFU, the peak against the bf16 params and its parts; checks
             the peak below the bf16 params, only the slots between steps,
             launches equal to the streamed plan, losses falling);
   zero_*  — ZeRO stages 1-3 over torch.distributed (NCCL, a world of
             one over a ``FileStore`` under ``build/``, no socket):
             ``zero_reference`` (llama-1b4 at full width cut to
             ZERO_REFERENCE_LAYERS layers, TRAIN_CONFIG, 3 steps from seed
             0 at stage 0 on the plain path, then stages 1, 2 and 3 over
             the group: losses, grad norms and masters bit-equal to stage
             0's, every stage's collectives counted, the CE weight exactly
             1.0); ``zero_train`` (llama-1b4 at full width and depth at
             stage 3, threshold 0, bf16 over fp32 masters, micro 4 x gas 2
             x S 2048, 5 steps and a profiled one: step time, tokens/s,
             MFU, peak, the collectives' calls and bytes a step, the
             device's busy share; launches equal to the train plan);
   comm_quant — the blockwise int8 codec of the quantized collectives
             (``csrc/comm_quant.cu``): both kernels bit-equal to their
             plain versions at llama-1b4's leaves flat (the stacked MLP
             leaf [24, 2048, 5632] included), fp32 and bf16, blocks 256
             and 200, as one row and as 4 destination rows, the dequantizer
             summing 4 sources and concatenating them; each timed against
             its bytes bound; ``q_all_gather_flat`` and
             ``q_reduce_scatter_flat`` over the world-one NCCL group (they
             quantize at one rank too: their launches are the path's);
             ``initialize`` with ZeRO++ (qw + qg + hpz 2), stage 2's
             ``grad_all_reduce`` and ``overlap_comm`` at stage 3 with both
             sites: at world 1 the JAX engine leaves each inert, so the
             port's inert keys, their reasons and one step bit-equal to
             zero_reference's plain path are checked;
   checkpoint — after the ``train`` phase, its cell again (llama-1b4 cut
             to CHECKPOINT_LAYERS, TRAIN_CONFIG, 5 steps), then ``save_checkpoint`` into a
             temporary directory (the free space printed first and
             checked against the tag's bytes with a 20 % margin), step 6,
             a fresh engine with other random weights, ``load_checkpoint``
             (the manifest's sha256 verified) and step 6 again: loss and
             grad norm bit-equal; ``init_inference(causal_lm("llama-1b4"),
             {"dtype": "bfloat16"}, checkpoint=dir)`` gives logits
             bit-equal to ``init_inference(params=)`` over the saved
             masters; then the same save, load and step 6 for
             ADAM8BIT_CONFIG; bytes written, save and load seconds and
             GB/s beside the card's name and power limit; each tag deleted
             in a finally; launches counted over the phase, each kernel of
             its path at least once;
6. report  — the card's name and power limit, the kernels JSON line, and
             last the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# H100 SXM 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98 GHz,
# from the fp32 rate above (128 lanes an SM, two flops an FMA): a quarter of
# it, one operation a lane a cycle
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4
# kernel vs plain version: fp32 elementwise 1e-5 (same formula, another
# reduction order); fp32 GEMV 1e-4 (sums of up to 14336 products in another
# order: ~sqrt(K) * 2^-24 of the partial sums); fp32 attention 2e-4 (online
# vs dense softmax, the bound tests/unit/test_fused_decode.py holds); bf16
# 2e-2 (one bf16 rounding of each output, and of the rows rounded before a
# product); fp16 (the norms, RoPE, flash attention and Adam of the fp16
# training path) the bf16 bound over 8: fp16 keeps three more mantissa bits
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2.5e-3}
GEMV_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2.5e-3}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2, "float16": 2.5e-3}
# llama3-8b decode shapes: 8 slots
B, D, H, HKV, DH, F = 8, 4096, 32, 8, 128, 14336
# the serve phases' prompt lengths; the profiled wave: each prompt cut to
# PROFILE_PROMPT tokens, PROFILE_NEW new
SERVE_LENS = (17, 45, 64, 100, 128, 180, 256, 300)
PROFILE_PROMPT, PROFILE_NEW = 40, 24
NQKV = (H + 2 * HKV) * DH


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_identity() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# CUDA-event samples a timing takes by default (50 until the comm_quant
# phase joined the smoke: cut for its 600 s aim, as ROADMAP.md names)
TIME_SAMPLES = 25


def time_ms(torch, fn, samples=TIME_SAMPLES, inner=20, warmup=10):
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_us(torch, fn, n=20, reps=10):
    """Device us a call of ``fn`` replayed from a CUDA graph of ``n`` calls
    (CUDA events over ``reps`` replays): the device's time a call with the
    host's launches taken out, programmatic dependences kept."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()                        # the wrappers' scratch for s, eagerly
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) * 1e3 / (reps * n)


def host_us(torch, fn, calls=2000, batch=100, warmup=50):
    """Host microseconds a call of ``fn`` (perf_counter_ns over ``calls``
    calls, the device drained every ``batch`` so that its queue never
    fills)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(calls // batch):
        t = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        total += time.perf_counter_ns() - t
        torch.cuda.synchronize()
    return total / calls / 1e3


def bound_ms(nbytes, flops, peak=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cycler(items):
    """A callable returning the next item on each call (round robin)."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]
    return nxt


def kernel_label(entry):
    """A mangled entry name as ``name<args>`` (the template's ints and
    bools), for the ptxas lines; the first 70 characters if it does not
    parse."""
    m = re.match(r"_ZN(\d+)", entry)
    if m is None:
        return entry[:70]
    rest = entry[m.end() + int(m.group(1)):]      # past the namespace
    m = re.match(r"(\d+)", rest)
    if m is None:
        return entry[:70]
    n = int(m.group(1))
    name, args = rest[m.end():m.end() + n], rest[m.end() + n:]
    targs = []
    if args.startswith("I"):
        for kind, val in re.findall(r"L([ib])(\d+)E", args.split("EE")[0] + "E"):
            targs.append(val if kind == "i" else ("true" if val == "1" else "false"))
    return f"{name}<{', '.join(targs)}>" if targs else name


def phase_build(torch, dev):
    from deepspeed_tpu_torch.ops.kernels import build
    from deepspeed_tpu_torch.ops.kernels import softmax

    results = {}

    def cuda_build(name):
        t0 = time.perf_counter()
        try:
            results[name] = build.load_library(name)
        except Exception as e:          # re-raised on the main thread
            results[name] = e
        results[name + "_s"] = time.perf_counter() - t0

    libs = ("layer_norm", "rope", "decode", "flash_attention", "fused_adam",
            "quantizer", "fused_adam8bit", "fused_lamb", "dropout", "comm_quant")
    threads = [threading.Thread(target=cuda_build, args=(n,)) for n in libs]
    for th in threads:
        th.start()
    c = torch.ones(8, 64, device=dev, dtype=torch.bfloat16)
    t1 = time.perf_counter()
    softmax.scaled_masked_softmax_triton(c, c, 1.0)
    softmax.scaled_masked_softmax_triton(c)
    softmax.bias_act_triton(c, c[0], "gelu")
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t1
    for th in threads:
        th.join()
    flash_ptxas = {}   # the wgmma flash kernels' ptxas lines, by name<D>
    for name in libs:
        if isinstance(results[name], Exception):
            raise results[name]
        lib = results[name]
        print(f"build: nvcc {lib.path.name} {results[name + '_s']:.2f}s "
              f"(0.00 = reused)")
        # one line per entry function; of decode's 68 instantiations only
        # the bf16 ones (the serving and generate paths') are printed
        entry, n_entries, spilled = "", 0, []
        for ln in lib.ptxas_info:
            if "Compiling entry" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
                n_entries += 1
            elif "spill stores" in ln:
                m = re.search(r"(\d+) bytes spill stores", ln)
                if m and int(m.group(1)):
                    spilled.append(f"{kernel_label(entry)}: {ln}")
            elif "Used" in ln and (name != "decode" or "bfloat16" in entry):
                used = ln.split(":", 1)[1].strip()
                print(f"  ptxas: {kernel_label(entry)}: {used}")
                if name == "flash_attention" and "wgmma" in entry:
                    flash_ptxas[kernel_label(entry)] = used
        print(f"  ptxas: {n_entries} entry functions, {len(spilled)} spill"
              + "".join(f"\n  ptxas spill: {s}" for s in spilled))
        for ln in lib.ptxas_info:
            if "Performance" in ln:
                print(f"  ptxas: {ln}")
        if name == "flash_attention":
            fwd, bwd = lib.lib.ds_flash_fwd_smem_bytes, lib.lib.ds_flash_bwd_smem_bytes
            print("  dynamic shared memory a block of the wgmma kernels: " + "; ".join(
                f"D {d}: forward {fwd(d)} B, dQ {bwd(d, 0)} B, dK/dV {bwd(d, 1)} B"
                for d in (32, 64, 128)))
    print(f"build: triton softmax (with and without a mask) and bias_act "
          f"compile+first launch {ops_s:.2f}s")
    out = {name: results[name + "_s"] for name in libs}
    out["softmax"] = ops_s
    out["flash_ptxas"] = flash_ptxas
    return out


def _randn(torch, shape, gen, dev, scale=1.0):
    return torch.randn(shape, device=dev, generator=gen).mul_(scale)


def _assert_close(torch, got, want, tol, what):
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    except AssertionError as e:
        raise RuntimeError(f"chip_smoke: {what} disagrees with its plain "
                           f"version: {e}") from None
    return float((got.float() - want.float()).abs().max())


def _assert_f16_ulp(torch, got, want, what):
    """fp16 got within one fp16 ulp of want in every element (the same fp32
    value on each side, rounded to fp16: a hair between the two fp32
    values can straddle a rounding boundary, no more); max abs err."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 11)
    ulp = torch.where(w == 0, 2.0 ** -24, ulp.clamp_min(2.0 ** -24))
    d = (got.float() - w).abs()
    worst = float((d / ulp).max())
    check(worst <= 1, f"{what} disagrees with its plain version: {worst:g} "
          f"fp16 ulps apart")
    return float(d.max())


def _check_adam_f16_step(torch, adam, before, after, g, step, kw, what):
    """One fp16-param Adam step, from the state ``before`` (p, m, v) to
    ``after``, held to the plain version's step from the same state: p
    within one fp16 ulp (the same fp32 update, each side rounded to fp16;
    held step by step, since an ulp carried from a larger |p| is many ulps
    of a p that lands near zero), m and v within ADAM_TOL (near 0.1 under
    unit grads, far above it).  Returns (p max abs err, m/v max abs err,
    the count of p's elements that differ)."""
    ref = [t.clone() for t in before]
    adam.fused_adam_update_plain(ref[0], g, ref[1], ref[2], step, **kw)
    e_p = _assert_f16_ulp(torch, after[0], ref[0], f"{what} p, step {step}")
    e_mv = max(_assert_close(torch, got, want, ADAM_TOL,
                             f"{what} {name}, step {step}")
               for got, want, name in zip(after[1:], ref[1:], ("m", "v")))
    return e_p, e_mv, int((after[0] != ref[0]).sum())


def _check_moved(torch, p, p0, what):
    """More than 98 % of p moved from p0 (lr 1e-2 x step moves it by many
    fp16 ulps): a kernel that never writes p back fails."""
    moved = float((p != p0).float().mean())
    check(moved > 0.98, f"{what}: only {moved:.4f} of p moved in 3 steps")
    return moved


def check_old_kernels(torch, dev, gen):
    """RMSNorm and RoPE against their plain versions, fp32, bf16 and fp16;
    bf16 and fp16 max abs errors."""
    from deepspeed_tpu_torch.ops.kernels import layer_norm

    errs = {"rms_norm": 0.0, "rms_norm_f16": 0.0}
    for dtype_name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        for rows in (8, 64):
            x = _randn(torch, (rows, D), gen, dev, 3).to(dt)
            g = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).to(dt)
            y = layer_norm.rms_norm_cuda(x, g, 1e-5)
            torch.cuda.synchronize()
            e = _assert_close(torch, y, layer_norm.rms_norm_plain(x, g, 1e-5),
                              TOL[dtype_name], f"rms_norm {dtype_name}")
            check(torch.equal(y, layer_norm.rms_norm_cuda(x, g, 1e-5)),
                  f"rms_norm {dtype_name} [{rows}, {D}]: two calls differ")
            if dtype_name != "float32":
                key = "rms_norm" + ("_f16" if dtype_name == "float16" else "")
                errs[key] = max(errs[key], e)
    errs.update(check_rope(torch, dev, gen))
    return errs


def _rope_equal(torch, got, want, what):
    """The RoPE kernel's outputs ``got`` equal to the plain version's
    ``want`` bit for bit (each operation rounded as the plain one rounds
    it), contiguous; their max abs difference (0)."""
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.is_contiguous(),
              f"{what}: {tuple(g.shape)} against {tuple(w.shape)}")
        check(torch.equal(g, w), f"{what}: not bit-equal to the plain version, "
              f"max abs diff {float((g.float() - w.float()).abs().max()):.3g}")
    return 0.0


def check_rope(torch, dev, gen):
    """Every RoPE form against its plain version with ``torch.equal``, fp32,
    bf16 and fp16, tables in fp32 and in x's dtype, at the paths' heads
    (llama3-8b's 32 + 8 of 128; llama-tiny's 8 + 4 of 32; 64-wide heads) and
    a ragged one (48 wide, rd 24: the element-by-element instance), the
    whole head and a quarter of it rotated (gpt-neox rotary_pct 0.25):
    ``partial_rope`` on [B, H, S, D] tensors and strided views, both signs;
    ``rope_qk`` from the projections' [B, S, Hx, D] views with one table
    and with per-row tables, and its backward; ``rope_qkv_rows`` on a
    decode step's QKV rows at a scalar and at per-row positions; each
    call's outputs equal to a second call's.  The decode rows also through
    a CUDA graph.  Returns the max abs errors (0 when all hold)."""
    from deepspeed_tpu_torch.ops.kernels import rope

    n = 0
    for dtype_name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        for (b, s, h, hk, d, rd) in ((1, 64, H, HKV, DH, DH), (8, 1, H, HKV, DH, DH),
                                     (2, 33, 8, 4, 32, 32), (2, 17, 4, 4, 64, 16),
                                     (2, 9, 3, 1, 128, 32), (3, 5, 2, 1, 48, 24)):
            for tdt in (dt,) if dt is torch.float32 else (dt, torch.float32):
                what = (f"rope {dtype_name} [{b}, {s}, {h}+{hk}, {d}] rd {rd}, "
                        f"{str(tdt)[6:]} table")
                cos, sin = rope.rope_angles(torch.arange(7, 7 + s, device=dev), rd,
                                            theta=500000.0)
                cos, sin = cos.to(tdt), sin.to(tdt)
                q = _randn(torch, (b, s, h * d), gen, dev).to(dt).view(b, s, h, d)
                k = _randn(torch, (b, s, hk * d), gen, dev).to(dt).view(b, s, hk, d)
                for neg in (False, True):
                    sn = -sin if neg else sin
                    for x in (q.transpose(1, 2), q.transpose(1, 2).contiguous()):
                        got = rope.partial_rope_cuda(x, cos, sin, neg)
                        _rope_equal(torch, (got, rope.partial_rope_cuda(x, cos, sin, neg)),
                                    (rope.partial_rope_plain(x, cos, sn),) * 2,
                                    f"{what} partial_rope neg={neg}")
                        n += 1
                got = rope.rope_qk_cuda(q, k, cos, sin)
                _rope_equal(torch, got + rope.rope_qk_cuda(q, k, cos, sin),
                            rope.rope_qk_plain(q, k, cos, sin) * 2, f"{what} rope_qk")
                dq = _randn(torch, (b, h, s, d), gen, dev).to(dt)
                dk = _randn(torch, (b, s, hk, d), gen, dev).to(dt).transpose(1, 2)
                got = rope.rope_qk_cuda(dq, dk, cos, sin, backward=True)
                want = tuple(rope.partial_rope_plain(g, cos, -sin).transpose(1, 2)
                             .contiguous() for g in (dq, dk))
                again = rope.rope_qk_cuda(dq, dk, cos, sin, backward=True)
                _rope_equal(torch, got + again, want * 2, f"{what} rope_qk backward")
                pos = torch.randint(0, 4000, (b, s), device=dev, generator=gen)
                pc, ps = rope.rope_angles(pos.reshape(-1), rd, theta=500000.0)
                pc, ps = (t.reshape(b, s, -1).to(tdt) for t in (pc, ps))
                _rope_equal(torch, rope.rope_qk_cuda(q, k, pc, ps),
                            rope.rope_qk_plain(q, k, pc, ps), f"{what} rope_qk per-row")
                got = rope.rope_qk_cuda(dq, dk, pc, ps, backward=True)
                want = tuple(rope.rope_rows_plain(g, pc, -ps).transpose(1, 2).contiguous()
                             for g in (dq, dk))
                _rope_equal(torch, got, want, f"{what} rope_qk per-row backward")
                qkv = _randn(torch, (b, (h + 2 * hk) * d), gen, dev).to(dt)
                for rows in (1, b) if b > 1 else (1,):
                    c1, s1 = (t.to(tdt) for t in rope.rope_angles(
                        pos[:rows, 0], rd, theta=500000.0))
                    got = rope.rope_qkv_rows_cuda(qkv, c1, s1, h, hk, d)
                    wq, wk = rope.rope_qkv_rows_plain(qkv, c1, s1, h, hk, d)
                    _rope_equal(torch, got + rope.rope_qkv_rows_cuda(qkv, c1, s1, h, hk, d),
                                (wq, wk.contiguous()) * 2,
                                f"{what} rope_qkv_rows, {rows} table rows")
                n += 6
    # the decode rows replayed from a CUDA graph: the same bits as eagerly
    qkv = _randn(torch, (B, NQKV), gen, dev).to(torch.bfloat16)
    c1, s1 = rope.rope_angles(torch.arange(B, device=dev) * 97, DH, theta=500000.0)
    want = rope.rope_qkv_rows_cuda(qkv, c1, s1, H, HKV, DH)
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        rope.rope_qkv_rows_cuda(qkv, c1, s1, H, HKV, DH)
    torch.cuda.current_stream().wait_stream(st)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=st):
        got = rope.rope_qkv_rows_cuda(qkv, c1, s1, H, HKV, DH)
    g.replay()
    torch.cuda.synchronize()
    _rope_equal(torch, got, want, "rope_qkv_rows replayed from a CUDA graph")
    print(f"kernels: rope, {n} form x shape x dtype x table cases and a CUDA-graph "
          f"replay, each bit-equal to its plain version and to a second call")
    return {"rope": 0.0, "rope_f16": 0.0}


# the decode shapes of the two served models (8 slots each): widths, heads,
# the norm kind and the MLP (gated silu, or a plain tanh-GeLU MLP)
DECODE_MODELS = {
    "llama3-8b": dict(D=D, H=H, HKV=HKV, DH=DH, F=F, kind="rmsnorm",
                      act="silu", glu=True),
    "gpt2-xl": dict(D=1600, H=25, HKV=25, DH=64, F=6400, kind="layernorm",
                    act="gelu", glu=False)}


def decode_inputs(torch, dev, gen, dt, copies=1, model="llama3-8b"):
    """Activations and ``copies`` sets of one layer's weights at ``model``'s
    decode shapes (weights scaled as the model's init; ``nbias`` is the
    norm's bias, which only LayerNorm has; ``wg`` only a gated MLP)."""
    m = DECODE_MODELS[model]
    d, f, hd = m["D"], m["F"], m["H"] * m["DH"]
    nqkv = (m["H"] + 2 * m["HKV"]) * m["DH"]

    def w(shape, fan_in):
        return [(_randn(torch, shape, gen, dev, fan_in ** -0.5)).to(dt)
                for _ in range(copies)]
    return {
        "x": _randn(torch, (B, d), gen, dev, 2).to(dt),
        "scale": (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(dt),
        "nbias": ((0.1 * torch.randn(d, device=dev, generator=gen)).to(dt)
                  if m["kind"] == "layernorm" else None),
        "wqkv": w((d, nqkv), d), "wo": w((hd, d), hd),
        "ctx": _randn(torch, (B, hd), gen, dev).to(dt),
        "resid": _randn(torch, (B, d), gen, dev, 2).to(dt),
        "h": _randn(torch, (B, d), gen, dev).to(dt),
        "wu": w((d, f), d), "wg": w((d, f), d) if m["glu"] else [None],
        "wd": w((f, d), f),
    }


def paged_inputs(torch, dev, gen, dt, page, pos, layers=2, model="llama3-8b",
                 window=1024):
    """A stacked [layers, P, Hkv, page, Dh] pool behind a shuffled page table
    with a ``window``-token window per slot (the serve pool's 1024), q
    [B, H, Dh], and pos [B]; with ``layers`` None an unstacked pool."""
    import numpy as np

    m = DECODE_MODELS[model]
    maxp = window // page
    P = B * maxp + 1
    lead = () if layers is None else (layers,)
    k = _randn(torch, lead + (P, m["HKV"], page, m["DH"]), gen, dev).to(dt)
    v = _randn(torch, lead + (P, m["HKV"], page, m["DH"]), gen, dev).to(dt)
    perm = np.random.default_rng(page).permutation(B * maxp) + 1
    table = torch.from_numpy(perm.reshape(B, maxp)).to(dev)
    q = _randn(torch, (B, m["H"], m["DH"]), gen, dev).to(dt)
    return q, k, v, torch.tensor(pos, device=dev), table


def check_decode_kernels(torch, dev, gen, model):
    """The four fused decode kernels against their plain versions at
    ``model``'s path shapes and branches (norm kind, activation, gate or
    none, heads per KV head), fp32 and bf16, and fp16 for the three GEMVs
    on the tensor cores (norm_qkv, proj_norm and the MLP, two calls
    bit-equal in bf16 and fp16) and for flash_decode (every dtype: depths
    across pages and on its chunk edges, 2047 keys of a 2048 window, two
    calls bit-equal);
    returns the bf16 max abs errors."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    m = DECODE_MODELS[model]
    kind, act, dh = m["kind"], m["act"], m["DH"]
    errs = {}
    for dtype_name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        bf = dtype_name == "bfloat16"
        t = decode_inputs(torch, dev, gen, dt, model=model)
        wqkv, wo = t["wqkv"][0], t["wo"][0]
        wu, wg, wd = t["wu"][0], t["wg"][0], t["wd"][0]
        nbias = t["nbias"]
        ref_bias = torch.zeros_like(t["scale"]) if nbias is None else nbias
        out = {}
        y = dk.fused_norm_qkv_cuda(t["x"], t["scale"], nbias, wqkv,
                                   kind=kind, eps=1e-5)
        torch.cuda.synchronize()
        out["fused_norm_qkv"] = _assert_close(
            torch, y, dk._norm_qkv_ref(t["x"], t["scale"], ref_bias, wqkv,
                                       None, kind=kind, eps=1e-5),
            GEMV_TOL[dtype_name], f"fused_norm_qkv {model} {dtype_name}")
        r, h = dk.fused_proj_norm_cuda(t["ctx"], t["resid"], wo, None,
                                       t["scale"], nbias, kind=kind,
                                       eps=1e-5, parallel=False)
        torch.cuda.synchronize()
        wr, wh = dk._proj_norm_ref(t["ctx"], t["resid"], wo, None, t["scale"],
                                   ref_bias, kind=kind, eps=1e-5,
                                   parallel=False)
        out["fused_proj_norm"] = max(
            _assert_close(torch, r, wr, GEMV_TOL[dtype_name],
                          f"fused_proj_norm r {model} {dtype_name}"),
            _assert_close(torch, h, wh, GEMV_TOL[dtype_name],
                          f"fused_proj_norm h {model} {dtype_name}"))
        if dtype_name != "float32":
            # the tensor cores' split merge and norm are ordered: same bits
            y2 = dk.fused_norm_qkv_cuda(t["x"], t["scale"], nbias, wqkv,
                                        kind=kind, eps=1e-5)
            r2, h2 = dk.fused_proj_norm_cuda(t["ctx"], t["resid"], wo, None,
                                             t["scale"], nbias, kind=kind,
                                             eps=1e-5, parallel=False)
            if not (torch.equal(y, y2) and torch.equal(r, r2) and torch.equal(h, h2)):
                raise AssertionError(f"norm_qkv / proj_norm {model} {dtype_name}: "
                                     "two calls differ")
        y = dk.fused_mlp_cuda(t["h"], t["resid"], wu, wd, wg, act=act)
        torch.cuda.synchronize()
        out["fused_mlp"] = _assert_close(
            torch, y, dk._mlp_ref(t["h"], t["resid"], wu, wg, wd, None,
                                  None, None, act=act),
            GEMV_TOL[dtype_name], f"fused_mlp {model} {dtype_name}")
        if dtype_name != "float32":     # the down launch's split merge is ordered
            check(torch.equal(y, dk.fused_mlp_cuda(t["h"], t["resid"], wu, wd, wg,
                                                   act=act)),
                  f"fused_mlp {model} {dtype_name}: two calls differ")
        del t, wqkv, wo, wu, wg, wd
        # depths 1..1024 (pos 0..1023) across page boundaries and on the
        # chunk edges (C - 1, C, C + 1 keys); the ordered merge: same bits
        C = dk.fd_chunk(dh, torch.empty(0, dtype=dt).element_size())
        fd = 0.0
        for page in (256, 16):
            for alibi in (False, True):
                q, k, v, pos, table = paged_inputs(
                    torch, dev, gen, dt, page,
                    [0, 254, 255, 256, 299, 300, 1022, 1023] if alibi else
                    [C - 2, C - 1, C, 2 * C, 3 * C + 1, 511, 1022, 1023],
                    model=model)
                for layer in (0, 1):
                    y = dk.flash_decode_paged_cuda(
                        q, k, v, pos, table, scale=dh ** -0.5, layer=layer,
                        alibi=alibi)
                    torch.cuda.synchronize()
                    what = (f"flash_decode {model} {dtype_name} page {page} "
                            f"alibi {alibi} layer {layer}")
                    fd = max(fd, _assert_close(
                        torch, y, dk._flash_decode_paged_ref(
                            q, k, v, pos, table, scale=dh ** -0.5,
                            layer=layer, alibi=alibi),
                        ATTN_TOL[dtype_name], what))
                    check(torch.equal(y, dk.flash_decode_paged_cuda(
                        q, k, v, pos, table, scale=dh ** -0.5, layer=layer,
                        alibi=alibi)), f"{what}: two calls differ")
                del q, k, v
        # 2047 keys in a 2048-slot window of 256-token pages
        q, k, v, pos, table = paged_inputs(torch, dev, gen, dt, 256,
                                           [2046] * B, layers=None, model=model,
                                           window=2048)
        y = dk.flash_decode_paged_cuda(q, k, v, pos, table, scale=dh ** -0.5)
        torch.cuda.synchronize()
        fd = max(fd, _assert_close(
            torch, y, dk._flash_decode_paged_ref(
                q, k, v, pos, table, scale=dh ** -0.5, layer=None,
                alibi=False),
            ATTN_TOL[dtype_name], f"flash_decode {model} {dtype_name} 2047 "
            f"keys"))
        del q, k, v
        out["flash_decode"] = fd
        if dtype_name == "float16":
            print(f"decode kernels vs plain at {model}'s shapes, float16 within "
                  f"2.5e-3 (norm_qkv, proj_norm, the MLP on the tensor cores and "
                  f"flash_decode bit-equal on a repeat): max abs err norm_qkv "
                  f"{out['fused_norm_qkv']:.3g}, proj_norm "
                  f"{out['fused_proj_norm']:.3g}, mlp {out['fused_mlp']:.3g}, "
                  f"flash_decode {fd:.3g}")
        if bf:
            errs = out
    print(f"decode kernels vs plain at {model}'s shapes (D {m['D']}, "
          f"{m['H']}/{m['HKV']} heads of {dh}, F {m['F']}, {kind}, {act}"
          f"{' gated' if m['glu'] else ', no gate'}): fp32 GEMV within 1e-4, "
          "attention 2e-4, bf16 within 2e-2 (norm_qkv, proj_norm, the MLP and "
          "flash_decode bit-equal on a repeat); bf16 max abs err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def norm_host_path(torch, kind, x, *scale, calls=20000):
    """Host microseconds a call of each stage of a norm forward's call path
    (``kind`` "rms_norm" at x [8, 4096] with g, or "layer_norm" at x
    [8, 1600] with g and b; bf16), each stage timed alone with
    perf_counter_ns over ``calls`` calls (the device drained every 1000):
    the stages of the shared-check path the wrappers took before their lean
    path (dispatch, a check_kernel_input call a tensor and the shape test,
    empty_like, entering torch.cuda.device, current_stream().cuda_stream,
    the ctypes call that launches, check_launch), the lean path's
    replacements, and whole calls: the kernel's wrapper, the public
    function, the shared-check path rebuilt from its stages, and the
    library call (F.rms_norm, F.layer_norm)."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln
    from deepspeed_tpu_torch.ops.kernels.build import bind, check_launch, load_library
    from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES,
                                                        check_kernel_input,
                                                        raw_stream, use_kernel)

    layer = kind == "layer_norm"
    n = x.shape[-1]
    rows = x.numel() // n
    idx = x.get_device()
    code = KERNEL_DTYPES[x.dtype]
    built = load_library("layer_norm")
    fwd = bind("layer_norm", "ds_layer_norm_fwd" if layer else "ds_rms_norm_fwd",
               ln._LN_FWD_ARGS if layer else ln._RMS_FWD_ARGS)
    names = ("gamma", "beta")[:len(scale)]
    wrapper, public = getattr(ln, kind + "_cuda"), getattr(ln, kind)
    y = torch.empty_like(x)

    def launch(out, stream):
        return fwd(x.data_ptr(), *(t.data_ptr() for t in scale), out.data_ptr(), rows, n,
                   1e-5, code, stream, idx)

    def grad():
        return torch.is_grad_enabled() and (x.requires_grad
                                            or any(t.requires_grad for t in scale))

    def dispatch():
        if not grad():
            use_kernel(x)

    def checks():
        check_kernel_input(f"{kind} x", x, x.device)
        for name, t in zip(names, scale):
            check_kernel_input(f"{kind} {name}", t, x.device, dtype=x.dtype)
        return any(t.shape != (n,) for t in scale)

    def shared_check_path():
        dispatch()
        if checks():
            raise ValueError("shape")
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            err = launch(out, torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(built, kind, err)
        return out

    def device_context():
        with torch.cuda.device(x.device):
            pass

    def lean_checks():
        return (KERNEL_DTYPES.get(x.dtype) is None or not x.is_contiguous()
                or any(t.dtype is not x.dtype or t.get_device() != idx
                       or t.shape != (n,) or not t.is_contiguous() for t in scale))

    stream = raw_stream(idx)
    stages = {
        f"dispatch ({kind}, use_kernel)": dispatch,
        f"checks ({1 + len(scale)} check_kernel_input + shape)": checks,
        "empty_like": lambda: torch.empty_like(x),
        "device context (torch.cuda.device)": device_context,
        "stream lookup (current_stream().cuda_stream)":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "ctypes call + launch": lambda: launch(y, stream),
        "check_launch": lambda: check_launch(built, kind, 0),
        "lean dispatch (is_cuda)": lambda: grad() or x.is_cuda,
        "lean checks (one attribute pass)": lean_checks,
        "lean stream (raw_stream)": lambda: raw_stream(idx),
        "whole: shared-check path": shared_check_path,
        f"whole: {kind}_cuda": lambda: wrapper(x, *scale, 1e-5),
        f"whole: {kind}()": lambda: public(x, *scale, 1e-5),
    }
    if layer:
        stages["whole: F.layer_norm"] = lambda: F_.layer_norm(x, (n,), *scale, 1e-5)
    elif hasattr(F_, "rms_norm"):
        stages["whole: F.rms_norm"] = lambda: F_.rms_norm(x, (n,), *scale, 1e-5)
    out = {name: host_us(torch, fn, calls, batch=1000, warmup=200)
           for name, fn in stages.items()}
    print(f"{kind} host path at x{list(x.shape)} bf16, us a call ({calls} calls "
          f"each, perf_counter_ns): " + "; ".join(f"{k} {v:.3f}"
                                                  for k, v in out.items()))
    return out


# the host's sleep at each end of a profiled window, inside the session.
# On the H100 machine the profiler places the device's records up to ~4.3 ms
# off the host's clock, either way, and drops a record it places outside its
# window: unpadded, 5 of 600 sessions of 200 copies lost some records, padded
# by 5 or 50 ms none of 1200 (profiler_probe.py)
PROFILE_PAD_S = 0.02


# the kernel of torch.cuda._sleep, launched at the start of a profile
# session of device_us_a_call and left out of its counts
MARKER_KERNEL = "spin_kernel"


def profile_pad():
    time.sleep(PROFILE_PAD_S)


def raw_records(prof, name):
    """Device records named ``name`` among kineto's raw results, before
    torch parses them into events: a record missing there was dropped by
    kineto or CUPTI."""
    try:
        return sum(name in e.name() for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CUDA"))
    except AttributeError:          # another torch's profiler internals
        return None


def device_us_a_call(torch, call, what, calls=200, sessions=2):
    """Device us a call of ``call`` under torch.profiler (every kernel it
    launches, the mean over ``calls`` calls), and the kernels' names.  Each
    kernel must be launched once a call: a session that comes back with
    fewer records than calls is taken once more, printed as a repeat, and a
    second loss fails.  A marker kernel opens each session (some card
    processes lose a session's first record, PERF.md §7); its record is
    left out."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profile_pad()
            # a marker launch ahead of the calls: in a process whose
            # sessions each lose their first record, the marker's is lost
            torch.cuda._sleep(1)
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            profile_pad()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        marker = [e for e in ev if MARKER_KERNEL in e.key]
        ev = [e for e in ev if MARKER_KERNEL not in e.key]
        if not marker:
            print(f"{what}: profile session {session} lost the marker's record "
                  f"({raw_records(prof, MARKER_KERNEL)} in kineto's raw results)")
        if ev and all(e.count == calls for e in ev):
            return (sum(e.self_device_time_total for e in ev) / calls,
                    sorted({e.key[:60] for e in ev}))
        print(f"{what}: profile session {session} holds "
              f"{[(e.key[:40], e.count, raw_records(prof, e.key)) for e in ev]} "
              f"(name, records, kineto's raw records) of {calls} calls"
              + ("; a repeat of the window follows" if session < sessions else ""))
    raise RuntimeError(f"chip_smoke: {what}: no profile session in {sessions} held a "
                       f"record of every launch")


# the forwards' path shapes: serve (decode rows), prefill, train
NORM_FWD_SHAPES = {"layer_norm": ((8, 1600), (64, 1600), (8192, 1600), (8192, 2048)),
                   "rms_norm": ((8, 4096), (64, 4096), (1600, 4096), (8192, 2048))}


def norm_fwd_times(torch, dev, kind, checked=True):
    """The ``kind`` forward ("layer_norm" or "rms_norm") and its library
    call (F.layer_norm, F.rms_norm) at each NORM_FWD_SHAPES shape, bf16:
    {"RxN": {"bound_us", "kernel": {...}, "library": {...}}}, each side's
    device us a launch under the profiler with x cycled through copies past
    the 50 MB L2 ("alone") and the kernels' names, device us a call replayed
    from a CUDA graph of 20 calls on 20 copies (``graph_us``), the call
    under CUDA events (``ms``) and the host's us a call; and, as a yardstick
    of the rate a stream of the same bytes reaches, the device us of
    ``y.copy_(x)`` (x read once, y written once) on the same copies
    (``copy_us``).  Each kernel is held to the plain version first (2e-2, a
    second call bit-equal) when ``checked``."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln

    layer = kind == "layer_norm"
    cuda, plain = getattr(ln, kind + "_cuda"), getattr(ln, kind + "_plain")
    out = {}
    for rows, n in NORM_FWD_SHAPES[kind]:
        gen = torch.Generator(device=dev).manual_seed(0)
        copies = max(2, min(4096, -(-128 * 2 ** 20 // (rows * n * 2))))
        xs = (_randn(torch, (copies, rows, n), gen, dev, 3) + (1.5 if layer else 0)
              ).to(torch.bfloat16)
        g = (1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(torch.bfloat16)
        b = (0.1 * torch.randn(n, device=dev, generator=gen)).to(torch.bfloat16)
        scale = (g, b) if layer else (g,)
        what = f"{kind} [{rows},{n}]"
        if checked:
            got, again = cuda(xs[0], *scale, 1e-5), cuda(xs[0], *scale, 1e-5)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{what}: two calls differ")
            _assert_close(torch, got, plain(xs[0], *scale, 1e-5), TOL["bfloat16"], what)
        nxt = cycler(list(xs))
        lib = None
        if layer:
            def lib(x):
                return F_.layer_norm(x, (n,), g, b, 1e-5)
        elif hasattr(F_, "rms_norm"):
            def lib(x):
                return F_.rms_norm(x, (n,), g, 1e-5)
        y = torch.empty_like(xs[0])
        r = out[f"{rows}x{n}"] = {
            "bound_us": bound_ms((2 * rows * n + len(scale) * n) * 2,
                                 (8 if layer else 4) * rows * n)[0] * 1e3,
            "copy_us": device_us_a_call(torch, lambda: y.copy_(nxt()), f"{what} copy_",
                                        calls=200 if rows < 1024 else 50)[0]}
        for who, fn in (("kernel", lambda x: cuda(x, *scale, 1e-5)), ("library", lib)):
            if fn is None:
                continue
            alone, names = device_us_a_call(torch, lambda: fn(nxt()), f"{what} {who}",
                                            calls=200 if rows < 1024 else 50)
            r[who] = {"device_us": alone, "kernels": names,
                      "graph_us": graph_us(torch, lambda: fn(nxt())),
                      "ms": time_ms(torch, lambda: fn(xs[0])),
                      "host_us": host_us(torch, lambda: fn(xs[0]), calls=2000)}
        k, lib_r = r["kernel"], r.get("library")
        check(any(f"{kind}_fwd_" in name for name in k["kernels"]),
              f"{what}: the profile holds {k['kernels']}")
        print(f"time {what} bf16: device {k['device_us']:.3f} us alone, "
              f"{k['graph_us']:.3f} from a graph, call {k['ms']:.5f} ms, host "
              f"{k['host_us']:.3f} us; bound {r['bound_us']:.3f} us "
              f"({100 * r['bound_us'] / k['device_us']:.1f} % of alone), copy_ of the same "
              f"bytes {r['copy_us']:.3f} us; {k['kernels']}"
              + (f"; library device {lib_r['device_us']:.3f} us alone, "
                 f"{lib_r['graph_us']:.3f} from a graph, call {lib_r['ms']:.5f} ms, host "
                 f"{lib_r['host_us']:.3f} us ({lib_r['kernels']})" if lib_r else ""))
        del xs, y
    return out


# RoPE's path shapes, bf16: (name, B, S, H, Hkv, form): the serve phase's
# prefill chunk and generate()'s padded prefill (8 prompts of 200 in the 256
# bucket) at llama3-8b's heads, a decode step's QKV rows (8 slots, per-row
# positions, fp32 tables), llama-1b4's training q and k, forward and backward
ROPE_SHAPES = (("serve_prefill", 1, 64, 32, 8, "qk"),
               ("generate_prefill", 8, 256, 32, 8, "qk"),
               ("decode_rows", 8, 1, 32, 8, "rows"),
               ("train", 4, 2048, 16, 16, "qk"),
               ("train_bwd", 4, 2048, 16, 16, "bwd"))


def rope_times(torch, dev):
    """The RoPE kernel at each ROPE_SHAPES shape (head dim 128), bf16:
    {name: {...}} with the device us a launch under the profiler with the
    inputs cycled through copies past the 50 MB L2 ("alone"), the device us
    a call replayed from a CUDA graph of 20 calls on 20 copies
    (``graph_us``), the call under CUDA events (``ms``), the host's us a
    call, the plain version's call (``plain_ms``; not at the training
    shape), the bound (q and k read once and written once, the cos and sin
    rows read once) and, as a yardstick of the rate a stream of those bytes
    reaches, the device us of ``copy_`` of q's and k's bytes.  Each form is
    held to its plain version first (bit-equal, a second call too)."""
    from deepspeed_tpu_torch.ops.kernels import rope

    bf = torch.bfloat16
    out = {}
    for name, b, s, h, hk, form in ROPE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        d = DH
        elems = b * s * (h + hk) * d            # q's and k's elements
        copies = max(2, min(2048, -(-128 * 2 ** 20 // (elems * 2))))
        if form == "rows":
            pos = torch.arange(b, device=dev) * 37 + 100
            cos, sin = rope.rope_angles(pos, d, theta=500000.0)       # fp32
            xs = [(x,) for x in _randn(torch, (copies, b, (h + 2 * hk) * d), gen,
                                        dev).to(bf)]

            def fn(x):
                return rope.rope_qkv_rows(x, cos, sin, h, hk, d)

            def plain(x):
                return rope.rope_qkv_rows_plain(x, cos, sin, h, hk, d)
        else:
            cos, sin = (t.to(bf) for t in rope.rope_angles(
                torch.arange(s, device=dev), d, theta=500000.0))
            if form == "qk":
                xs = [(qq.view(b, s, h, d), kk.view(b, s, hk, d)) for qq, kk in zip(
                    _randn(torch, (copies, b, s, h * d), gen, dev).to(bf),
                    _randn(torch, (copies, b, s, hk * d), gen, dev).to(bf))]

                def fn(q, k):
                    return rope.rope_qk(q, k, cos, sin)

                def plain(q, k):
                    return rope.rope_qk_plain(q, k, cos, sin)
            else:
                xs = list(zip(_randn(torch, (copies, b, h, s, d), gen, dev).to(bf),
                              _randn(torch, (copies, b, hk, s, d), gen, dev).to(bf)))

                def fn(dq, dk):
                    return rope.rope_qk_cuda(dq, dk, cos, sin, backward=True)

                def plain(dq, dk):
                    return tuple(rope.partial_rope_plain(g, cos, -sin).transpose(1, 2)
                                 .contiguous() for g in (dq, dk))
        what = f"rope {name} {form} [{b}, {s}, {h}+{hk}, {d}]"
        _rope_equal(torch, fn(*xs[0]) + fn(*xs[0]), plain(*xs[0]) * 2, what)
        nxt = cycler(xs)
        src = torch.empty(copies, elems, device=dev, dtype=bf)
        dst = torch.empty_like(src[0])
        nsrc = cycler(list(src))
        nbytes = 2 * elems * 2 + 2 * cos.numel() * cos.element_size()
        b_ms, b_by = bound_ms(nbytes, 3 * elems)
        calls = 200 if elems < 2 ** 22 else 50
        alone, names = device_us_a_call(torch, lambda: fn(*nxt()), what, calls=calls)
        r = out[name] = {
            "shape": f"{form} [{b}, {s}, {h}+{hk}, {d}] bf16", "bound_us": b_ms * 1e3,
            "bound_by": b_by, "device_us": alone, "kernels": names,
            "graph_us": graph_us(torch, lambda: fn(*nxt())),
            "ms": time_ms(torch, lambda: fn(*xs[0])),
            "host_us": host_us(torch, lambda: fn(*xs[0]), calls=2000),
            "copy_us": device_us_a_call(torch, lambda: dst.copy_(nsrc()),
                                        f"{what} copy_", calls=calls)[0],
            "plain_ms": (time_ms(torch, lambda: plain(*xs[0]), samples=20)
                         if elems < 2 ** 22 else None)}
        check(any("rope_kernel" in k for k in names), f"{what}: the profile holds {names}")
        print(f"time {what} bf16: device {r['device_us']:.3f} us alone, "
              f"{r['graph_us']:.3f} from a graph, call {r['ms']:.5f} ms, host "
              f"{r['host_us']:.3f} us; bound {r['bound_us']:.3f} us ({b_by}, "
              f"{100 * r['bound_us'] / r['device_us']:.1f} % of alone), copy_ of q's "
              f"and k's bytes {r['copy_us']:.3f} us; plain "
              + ("n/a" if r["plain_ms"] is None else f"{r['plain_ms']:.5f} ms")
              + f"; {names}")
        del xs, src, dst
    return out


def time_old_kernels(torch, dev, gen, errs):
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import layer_norm

    out = {}
    bf = torch.bfloat16
    x = _randn(torch, (B, D), gen, dev).to(bf)
    g = torch.ones(D, device=dev, dtype=bf)
    lib_ms = None
    if hasattr(F_, "rms_norm"):
        lib_ms = time_ms(torch, lambda: F_.rms_norm(x, (D,), g, 1e-5))
    b_ms, b_by = bound_ms(2 * x.numel() * 2 + g.numel() * 2, 4 * x.numel())
    out["rms_norm"] = {
        "shape": "x[8,4096] bf16",
        "ms": time_ms(torch, lambda: layer_norm.rms_norm_cuda(x, g, 1e-5)),
        "public_ms": time_ms(torch, lambda: layer_norm.rms_norm(x, g, 1e-5)),
        "plain_ms": time_ms(torch, lambda: layer_norm.rms_norm_plain(x, g, 1e-5)),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["rms_norm"],
        "host_us": norm_host_path(torch, "rms_norm", x, g),
        "fwd_shapes": norm_fwd_times(torch, dev, "rms_norm")}
    r = out["rms_norm"]
    print(f"time rms_norm x[8,4096] bf16: rms_norm_cuda {r['ms']:.5f} ms, the "
          f"public rms_norm() {r['public_ms']:.5f} ms, F.rms_norm "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.5f}'} ms")
    # the same kernel at llama-1b4's training rows, beside F.rms_norm there
    xt = _randn(torch, (TB * TS, TD), gen, dev).to(bf)
    gt = torch.ones(TD, device=dev, dtype=bf)
    r["train_ms"] = time_ms(torch, lambda: layer_norm.rms_norm_cuda(xt, gt, 1e-5))
    r["train_library_ms"] = (time_ms(torch, lambda: F_.rms_norm(xt, (TD,), gt, 1e-5))
                             if hasattr(F_, "rms_norm") else None)
    r["train_bound_ms"] = bound_ms(2 * xt.numel() * 2 + TD * 2, 4 * xt.numel())[0]
    print(f"time rms_norm x[8192,2048] bf16 (training shape): kernel "
          f"{r['train_ms']:.5f} ms, F.rms_norm {r['train_library_ms']} ms, bound "
          f"{r['train_bound_ms']:.6f} ms")
    del xt
    # RoPE: the kernel line's numbers at the serve prefill's q + k, one
    # launch; every path shape under path_shapes
    shapes = rope_times(torch, dev)
    r = shapes["serve_prefill"]
    out["rope"] = {
        "shape": "q + k [1, 64, 32 + 8, 128] bf16 (serve prefill), one launch",
        "ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": None,
        "bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"],
        "max_abs_err": errs["rope"], "device_us": r["device_us"],
        "graph_us": r["graph_us"], "host_us": r["host_us"],
        "decode_rows_ms": shapes["decode_rows"]["ms"],
        "train_ms": shapes["train"]["ms"],
        "train_bound_ms": shapes["train"]["bound_us"] / 1e3,
        "path_shapes": shapes}
    return out


def time_decode_kernels(torch, dev, gen, errs):
    """bf16 at the llama3-8b decode shapes (norm_qkv, proj_norm and the MLP
    also at gpt2-xl's, with their device time alone and host time a call:
    gemv16_times; the paged flash_decode: flash_decode_paged_times).  The
    GEMV kernels cycle through weight copies totalling > 100 MB, so each
    call streams its weights from HBM as the 32-layer path does; cuBLAS's
    products of the same shapes are timed beside them (``matmul_ms``, never
    called by the port)."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    out = {}
    zeros = torch.zeros(D, device=dev, dtype=bf)
    g16 = gemv16_times(torch, dev, gen, profile=True, int8=False)

    # fused_norm_qkv: x [8,4096] . wqkv [4096,6144]
    t = decode_inputs(torch, dev, gen, bf, copies=3)
    x, s = t["x"], t["scale"]
    nw = cycler(t["wqkv"])
    nbytes = (x.numel() + s.numel() + D * NQKV + B * NQKV) * 2
    b_ms, b_by = bound_ms(nbytes, 2 * B * D * NQKV, BF16_FLOPS_PER_S)
    out["fused_norm_qkv"] = {
        "shape": "x[8,4096] . wqkv[4096,6144] bf16",
        "plain_ms": time_ms(torch, lambda: dk._norm_qkv_ref(
            x, s, zeros, nw(), None, kind="rmsnorm", eps=1e-5), samples=10),
        "matmul_ms": time_ms(torch, lambda: torch.matmul(x, nw())),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_norm_qkv"]}
    del t, nw

    # fused_proj_norm: ctx [8,4096] . wo [4096,4096] + resid, norm
    t = decode_inputs(torch, dev, gen, bf, copies=4)
    ctx, resid = t["ctx"], t["resid"]
    nw = cycler(t["wo"])
    nbytes = (ctx.numel() + resid.numel() + H * DH * D + D + 2 * B * D) * 2
    b_ms, b_by = bound_ms(nbytes, 2 * B * H * DH * D, BF16_FLOPS_PER_S)
    out["fused_proj_norm"] = {
        "shape": "ctx[8,4096] . wo[4096,4096] bf16",
        "plain_ms": time_ms(torch, lambda: dk._proj_norm_ref(
            ctx, resid, nw(), None, s, zeros, kind="rmsnorm", eps=1e-5,
            parallel=False), samples=10),
        "matmul_ms": time_ms(torch, lambda: torch.matmul(ctx, nw())),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_proj_norm"]}
    del t, nw

    # fused_mlp: h [8,4096] . (wg, wu [4096,14336]) -> a . wd [14336,4096]
    t = decode_inputs(torch, dev, gen, bf)
    h, r = t["h"], t["resid"]
    wu, wg, wd = t["wu"][0], t["wg"][0], t["wd"][0]
    a = torch.randn(B, F, device=dev, generator=gen).to(bf)
    nbytes = (2 * h.numel() + 3 * D * F + B * D) * 2
    b_ms, b_by = bound_ms(nbytes, 6 * B * D * F, BF16_FLOPS_PER_S)
    out["fused_mlp"] = {
        "shape": "h[8,4096] . wg,wu[4096,14336], a . wd[14336,4096] bf16",
        "plain_ms": time_ms(torch, lambda: dk._mlp_ref(
            h, r, wu, wg, wd, None, None, None, act="silu"), samples=10),
        "matmul_ms": time_ms(torch, lambda: (torch.matmul(h, wg),
                                             torch.matmul(h, wu),
                                             torch.matmul(a, wd))),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_mlp"]}
    del t, wu, wg, wd
    # cuBLAS's two products at gpt2-xl's MLP shape, weights cycled past the L2
    m2 = DECODE_MODELS["gpt2-xl"]
    h2 = _randn(torch, (B, m2["D"]), gen, dev).to(bf)
    a2 = _randn(torch, (B, m2["F"]), gen, dev).to(bf)
    gw = cycler([(_randn(torch, (m2["D"], m2["F"]), gen, dev).to(bf),
                  _randn(torch, (m2["F"], m2["D"]), gen, dev).to(bf)) for _ in range(3)])

    def gpt2_matmuls():
        w1, w2 = gw()
        return torch.matmul(h2, w1), torch.matmul(a2, w2)
    out["fused_mlp"]["gpt2_matmul_ms"] = time_ms(torch, gpt2_matmuls)
    del gw

    # the tensor-core GEMVs at both models' shapes, and ptxas's lines
    ptx = gemv16_ptxas()
    for k in ("fused_norm_qkv", "fused_proj_norm", "fused_mlp"):
        for model, pre in (("llama3-8b", ""), ("gpt2-xl", "gpt2_")):
            for what, r in g16.items():
                if what.startswith(f"{model} {k[len('fused_'):]}"):
                    sfx = what[len(f"{model} {k[len('fused_'):]}"):].replace(" ", "_")
                    for f, v in r.items():
                        out[k][pre + f + sfx] = v
        out[k]["ptxas"] = [ln for ln in ptx if k[len("fused_"):] in ln]
        for ln in out[k]["ptxas"]:
            print(f"  ptxas {ln}")

    for name, b2 in gpt2_decode_bounds().items():
        out[name]["gpt2_bound_ms"] = b2
    # flash_decode: its gpt2-xl bound at the serve profile's depths
    out["flash_decode"] = flash_decode_paged_times(torch, dev, gen)
    out["flash_decode"]["max_abs_err"] = errs["flash_decode"]
    out["flash_decode"]["ptxas"] = flash_decode_ptxas()
    for ln in out["flash_decode"]["ptxas"]:
        print(f"  ptxas {ln}")
    for k in ("fused_norm_qkv", "fused_proj_norm", "fused_mlp"):
        r = out[k]
        # the bound over the device time alone (weights cycled past the L2)
        r["bound_share"] = r["bound_ms"] * 1e3 / r["device_us"]
        r["gpt2_bound_share"] = r["gpt2_bound_ms"] * 1e3 / r["gpt2_device_us"]
        print(f"time {k} bf16 (tensor cores): llama3-8b device {r['device_us']:.2f} us "
              f"alone, bound {r['bound_ms'] * 1e3:.3f} us ({100 * r['bound_share']:.1f} % "
              f"of it), call {r['ms']:.5f} ms, host {r['host_us']:.3f} us a call; gpt2-xl "
              f"device {r['gpt2_device_us']:.2f} us, bound {r['gpt2_bound_ms'] * 1e3:.3f} "
              f"us ({100 * r['gpt2_bound_share']:.1f} %), call {r['gpt2_ms']:.5f} ms, host "
              f"{r['gpt2_host_us']:.3f} us")
    r = out["fused_mlp"]
    print(f"time fused_mlp bf16: replayed from a CUDA graph (PDL's overlap counted once) "
          f"llama3-8b {r['graph_us']:.2f} us, gpt2-xl {r['gpt2_graph_us']:.2f} us; cuBLAS's "
          f"products (matmul_ms, timed only) llama3-8b {r['matmul_ms']:.5f} ms, gpt2-xl "
          f"{r['gpt2_matmul_ms']:.5f} ms")
    return out


def fd_bound(keys, m, pages=0, esz=2):
    """The bound of one flash_decode call over rows attending ``keys`` keys
    each at ``model``'s heads: q read and out written once, each K/V row up
    to each depth read once, the depths and the page-table entries read
    (8 bytes each); 4 flops a key and head dim (QK^T, PV)."""
    n = sum(keys)
    nbytes = (2 * len(keys) * m["H"] * m["DH"] + 2 * n * m["HKV"] * m["DH"]) * esz \
        + 8 * (len(keys) + pages)
    return bound_ms(nbytes, 4 * n * m["H"] * m["DH"], BF16_FLOPS_PER_S)


def serve_profile_keys():
    """Keys each slot attends halfway through the serve profile's decode
    (``phase_profile``: the prompts cut to PROFILE_PROMPT tokens, then
    PROFILE_NEW new): the depth its flash_decode device time is read at."""
    return [min(n, PROFILE_PROMPT) + PROFILE_NEW // 2 for n in SERVE_LENS]


def cold_device_us(torch, call, what, flush, kernel="flash_decode_kernel"):
    """Device us of one flash_decode launch under the profiler (mean of 50),
    a 128 MB read (``flush``) before each, so that the launch finds its K/V
    out of the L2 as on the path, and the L2 full of clean lines (a write
    would leave dirty lines, whose write-back the launch would pay)."""
    def flushed():
        flush.sum()
        return call()
    return kernel_split(torch, flushed, (kernel,), what, calls=50)[kernel]


def flash_decode_paged_times(torch, dev, gen, kernel="flash_decode_kernel"):
    """The paged flash_decode, bf16, 256-token pages, at llama3-8b's heads:
    at the serve profile's depths (``serve_profile_keys``: the row's main
    shape, in a 1024-token window, the serve pool's) and at 300 keys, each
    beside its own bound; at gpt2-xl's heads at the same depths; 2048 keys
    in a 2048-token window; and at the profile's depths in a one-page
    window, whose grid holds no block that returns at once (against the
    1024 window's, the cost of those blocks).  "ms": a call under CUDA
    events, each on the next of 8 stacked layers (K/V > 100 MB); "device_us":
    a launch under the profiler after a 128 MB read (``cold_device_us``);
    "bound_share": the bound over that device time; "host_us": the host's
    time a call; ``kernel``: the kernel's name in the profile."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    flush = torch.ones(32 << 20, dtype=torch.float32, device=dev)
    keys = serve_profile_keys()
    out = {"shape": f"q[8,32,128], 8 slots {keys[0]}/{keys[1]} keys deep "
                    f"(the serve profile's), 256-token pages, 1024 window, bf16",
           "library_ms": None}

    def case(model, pos, window=1024, layers=8):
        m = DECODE_MODELS[model]
        q, k, v, p, table = paged_inputs(torch, dev, gen, bf, 256, pos,
                                         layers=layers, model=model,
                                         window=window)
        nl = cycler(list(range(layers)))
        sc = m["DH"] ** -0.5

        def call():
            return dk.flash_decode_paged_cuda(q, k, v, p, table, scale=sc,
                                              layer=nl())
        pages = sum(x // 256 + 1 for x in pos)
        b_ms, b_by = fd_bound([x + 1 for x in pos], m, pages)
        r = {"ms": time_ms(torch, call), "bound_ms": b_ms, "bound_by": b_by,
             "device_us": cold_device_us(torch, call,
                                         f"flash_decode paged {model} "
                                         f"{max(pos) + 1} keys, window {window}",
                                         flush, kernel)}
        r["bound_share"] = r["bound_ms"] * 1e3 / r["device_us"]
        return r, call, (q, k, v, p, table)

    pos = [n - 1 for n in keys]
    r, call, (q, k, v, p, table) = case("llama3-8b", pos)
    out.update(r)
    out["host_us"] = host_us(torch, call)
    out["plain_ms"] = time_ms(torch, lambda: dk._flash_decode_paged_ref(
        q, k, v, p, table, scale=DH ** -0.5, layer=1, alibi=False), samples=10)
    del q, k, v
    r, _, _ = case("llama3-8b", [299] * B)
    out.update({f"{f}_300": x for f, x in r.items()})
    r, call, _ = case("gpt2-xl", pos)
    out.update({f"gpt2_{f}": x for f, x in r.items()})
    out["gpt2_host_us"] = host_us(torch, call)
    r, _, _ = case("llama3-8b", [2047] * B, window=2048, layers=2)
    out.update({f"{f}_2048": x for f, x in r.items()})
    r, _, _ = case("llama3-8b", pos, window=256)
    out["one_page_device_us"] = r["device_us"]
    print(f"time flash_decode paged bf16 (llama3-8b heads, device us a launch "
          f"after a 128 MB read): serve depths {keys[0]}/{keys[1]} keys "
          f"{out['device_us']:.2f} (bound {out['bound_ms'] * 1e3:.3f}, "
          f"{100 * out['bound_share']:.1f} %; {out['one_page_device_us']:.2f} in "
          f"a one-page window: no block returning at once), call "
          f"{out['ms']:.5f} ms, host {out['host_us']:.3f} us; 300 keys "
          f"{out['device_us_300']:.2f} (bound {out['bound_ms_300'] * 1e3:.3f}, "
          f"{100 * out['bound_share_300']:.1f} %); 2048 keys "
          f"{out['device_us_2048']:.2f} (bound {out['bound_ms_2048'] * 1e3:.3f}, "
          f"{100 * out['bound_share_2048']:.1f} %); gpt2-xl heads "
          f"{out['gpt2_device_us']:.2f} (bound {out['gpt2_bound_ms'] * 1e3:.3f}, "
          f"{100 * out['gpt2_bound_share']:.1f} %), host "
          f"{out['gpt2_host_us']:.3f} us")
    return out


def flash_decode_contig_times(torch, dev, gen, kernel="flash_decode_kernel"):
    """The contiguous flash_decode, bf16, llama3-8b's heads: 8 rows 264 deep
    in a 512-token cache (generate()'s cell: 200-token prompts, 64 new; the
    row's main shape) and 2048 deep in a 2048-token cache, each call on the
    next of 8 (2) stacked layers (K/V > 100 MB), beside the plain version
    and SDPA on the same cold work (GQA; a boolean mask by position where
    the depth is short of the cache), and the bound; "device_us", "host_us"
    and "bound_share" as ``flash_decode_paged_times``."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    flush = torch.ones(32 << 20, dtype=torch.float32, device=dev)
    m = DECODE_MODELS["llama3-8b"]
    out = {}
    for depth, Smax, layers, sfx in ((264, 512, 8, ""), (2048, 2048, 2, "_2048")):
        k = _randn(torch, (layers, B, HKV, Smax, DH), gen, dev).to(bf)
        v = _randn(torch, (layers, B, HKV, Smax, DH), gen, dev).to(bf)
        q = _randn(torch, (B, H, DH), gen, dev).to(bf)
        pos = depth - 1
        nl = cycler(list(range(layers)))
        mask = None if depth == Smax else (
            torch.arange(Smax, device=dev) <= pos)[None, None, None, :] \
            .expand(B, 1, 1, Smax)
        q4 = q[:, :, None, :]

        def call():
            return dk.flash_decode_contig_cuda(q, k, v, pos, scale=DH ** -0.5,
                                               layer=nl())

        def library():
            i = nl()
            return F_.scaled_dot_product_attention(q4, k[i], v[i],
                                                   attn_mask=mask,
                                                   enable_gqa=True)
        b_ms, b_by = fd_bound([depth] * B, m)
        out.update({
            "ms" + sfx: time_ms(torch, call),
            "library_ms" + sfx: time_ms(torch, library),
            "plain_ms" + sfx: time_ms(torch, lambda: dk._flash_decode_ref(
                q, k[0], v[0], pos, scale=DH ** -0.5), samples=10),
            "bound_ms" + sfx: b_ms, "bound_by" + sfx: b_by,
            "device_us" + sfx: cold_device_us(
                torch, call, f"flash_decode contiguous {depth} keys", flush,
                kernel)})
        out["bound_share" + sfx] = b_ms * 1e3 / out["device_us" + sfx]
        if not sfx:
            out["host_us"] = host_us(torch, call)
        del k, v
    out["shape"] = ("q[8,32,128], cache [8,8,8,512,128] cycled by layer, 264 "
                    "deep, bf16")
    print(f"time flash_decode contiguous bf16 (llama3-8b heads, device us a "
          f"launch after a 128 MB read): 264 keys {out['device_us']:.2f} "
          f"(bound {out['bound_ms'] * 1e3:.3f}, {100 * out['bound_share']:.1f} "
          f"%), call {out['ms']:.5f} ms, SDPA {out['library_ms']:.5f} ms, host "
          f"{out['host_us']:.3f} us; 2048 keys {out['device_us_2048']:.2f} "
          f"(bound {out['bound_ms_2048'] * 1e3:.3f}, "
          f"{100 * out['bound_share_2048']:.1f} %), call {out['ms_2048']:.5f} "
          f"ms, SDPA {out['library_ms_2048']:.5f} ms")
    return out


def flash_decode_ptxas():
    """ptxas's registers and spills of flash_decode_kernel, one line an
    instantiation (dtype, query heads a block's registers hold)."""
    from deepspeed_tpu_torch.ops.kernels import build

    lines, entry = [], ""
    for ln in build.load_library("decode").ptxas_info:
        if "Compiling entry" in ln:
            entry = ln
        elif "flash_decode_kernel" in entry and ("Used" in ln or "spill" in ln):
            m = re.search(r"flash_decode_kernelI(\w+?)Li(\d+)EE", entry)
            ty = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}.get(
                m.group(1), m.group(1)) if m else ""
            name = f"flash_decode_kernel<{ty}, {m.group(2)}>" if m else entry[:90]
            lines.append(f"{name}: {ln.split(':')[-1].strip()}")
    return lines


def gemv16_times(torch, dev, gen, profile=False, int8=True):
    """The tensor-core GEMVs at the decode paths' shapes, 8 rows: the bf16
    fused_norm_qkv and fused_proj_norm at llama3-8b's and gpt2-xl's (gpt2-xl
    with LayerNorm's bias and the projections' biases), the bf16 fused_mlp
    at both (gpt2-xl with its biases), and the int8 fused_norm_qkv and
    fused_proj_norm at llama3-8b's; each call on the next of weight copies
    totalling > 100 MB,
    so that it streams its weights from HBM as the path does.  Returns
    {"<model> <kernel>": {"ms": a call under CUDA events, "host_us": the
    host's time a call, and with ``profile`` "device_us": the kernels'
    device time a call under the profiler (mean of 200; the MLP's two
    launches summed, each in "split")}}."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    out = {}

    def measure(what, call, names):
        out[what] = {"ms": time_ms(torch, call), "host_us": host_us(torch, call)}
        try:        # an older checkout's wrappers (gemv16_probe.py --tree) may not capture
            out[what]["graph_us"] = graph_us(torch, call)
        except RuntimeError as e:
            print(f"{what}: no CUDA graph replay: {e}")
        if profile:
            split = kernel_split(torch, call, names, what, calls=200)
            out[what]["device_us"] = sum(split.values())
            if len(names) > 1:
                out[what]["split"] = split

    for model in ("llama3-8b", "gpt2-xl"):
        m = DECODE_MODELS[model]
        d, hd, f, kind = m["D"], m["H"] * m["DH"], m["F"], m["kind"]
        nqkv = (m["H"] + 2 * m["HKV"]) * m["DH"]
        x = _randn(torch, (B, d), gen, dev, 2).to(bf)
        ctx = _randn(torch, (B, hd), gen, dev).to(bf)
        resid = _randn(torch, (B, d), gen, dev, 2).to(bf)
        s = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(bf)
        nb, bq, bo, bu, bd = ((0.1 * torch.randn(n, device=dev, generator=gen)).to(bf)
                              if kind == "layernorm" else None
                              for n in (d, nqkv, d, f, d))
        for name, k, n in (("norm_qkv", d, nqkv), ("proj_norm", hd, d)):
            nw = cycler([_randn(torch, (k, n), gen, dev, k ** -0.5).to(bf)
                         for _ in range(-(-(100 << 20) // (2 * k * n)))])
            if name == "norm_qkv":
                def call():
                    return dk.fused_norm_qkv_cuda(x, s, nb, nw(), bq, kind=kind,
                                                  eps=1e-5)
            else:
                def call():
                    return dk.fused_proj_norm_cuda(ctx, resid, nw(), bo, s, nb,
                                                   kind=kind, eps=1e-5,
                                                   parallel=False)
            measure(f"{model} {name}", call, (name,))
            del nw
        per = (3 if m["glu"] else 2) * d * f * 2
        mw = cycler([(_randn(torch, (d, f), gen, dev, d ** -0.5).to(bf),
                      _randn(torch, (d, f), gen, dev, d ** -0.5).to(bf) if m["glu"] else None,
                      _randn(torch, (f, d), gen, dev, f ** -0.5).to(bf))
                     for _ in range(-(-(100 << 20) // per))])

        def mlp():
            wu, wg, wd = mw()
            return dk.fused_mlp_cuda(x, resid, wu, wd, wg, bu, None, bd, act=m["act"])
        measure(f"{model} mlp", mlp, ("mlp_act", "mlp_down"))
        del mw
    if not int8:
        return out
    x = _randn(torch, (B, D), gen, dev, 2).to(bf)
    s = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).to(bf)
    nw = cycler([_int8_weight(torch, (D, NQKV), gen, dev) for _ in range(5)])

    def qkv8():
        w, ws = nw()
        return dk.fused_norm_qkv_int8_cuda(x, s, None, w, ws, kind="rmsnorm", eps=1e-5)
    measure("llama3-8b norm_qkv_int8", qkv8, ("norm_qkv",))
    del nw
    ctx = _randn(torch, (B, H * DH), gen, dev).to(bf)
    resid = _randn(torch, (B, D), gen, dev, 2).to(bf)
    pw = cycler([_int8_weight(torch, (H * DH, D), gen, dev) for _ in range(6)])

    def proj8():
        w, ws = pw()
        return dk.fused_proj_norm_int8_cuda(ctx, resid, w, ws, None, s, None,
                                            kind="rmsnorm", eps=1e-5, parallel=False)
    measure("llama3-8b proj_norm_int8", proj8, ("proj_norm",))
    return out


def gemv16_ptxas():
    """ptxas's registers, shared memory and spills of the tensor-core
    core's kernels (norm_qkv, proj_norm, the MLP's two launches: bf16 and
    fp16; the int8 norm_qkv: TMA or cp.async), one line an instantiation."""
    from deepspeed_tpu_torch.ops.kernels import build

    lines, entry = [], ""
    for ln in build.load_library("decode").ptxas_info:
        if "Compiling entry" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "_mma_kernel" in entry and "mlp_act_int8" not in entry \
                and "mlp_down_int8" not in entry and ("Used" in ln or "spill" in ln):
            ty = " bf16" if "13__nv_bfloat16" in entry else " fp16" if "6__half" in entry else ""
            lines.append(f"{kernel_label(entry)}{ty}: {ln.split(':')[-1].strip()}")
    return lines


def gpt2_decode_bounds():
    """The bounds of the three decode GEMVs at gpt2-xl's decode shapes, bf16,
    8 slots (LayerNorm with a bias, biases on every projection, a plain
    tanh-GeLU MLP), counted as the llama3-8b rows count them: each input
    read once, each output written once (flash_decode's:
    ``flash_decode_paged_times``)."""
    m = DECODE_MODELS["gpt2-xl"]
    d, f, n = m["D"], m["F"], (m["H"] + 2 * m["HKV"]) * m["DH"]
    bf = 2
    rows = {
        "fused_norm_qkv": ((B * d + 2 * d + d * n + n + B * n) * bf, 2 * B * d * n),
        "fused_proj_norm": ((2 * B * d + d * d + 3 * d + 2 * B * d) * bf, 2 * B * d * d),
        "fused_mlp": ((2 * B * d + 2 * d * f + f + d + B * d) * bf, 4 * B * d * f),
    }
    out = {name: bound_ms(nb, fl, BF16_FLOPS_PER_S)[0] for name, (nb, fl) in rows.items()}
    print("gpt2-xl decode bounds (bf16, 8 slots): " + ", ".join(
        f"{k} {v:.6f} ms" for k, v in out.items()))
    return out


def check_contig_decode(torch, dev, gen):
    """flash_decode over generate()'s contiguous cache against
    ``_flash_decode_ref``: llama3-8b's decode shape (8 rows, 32/8 heads of
    128) over a stacked [2, 8, 8, Smax, 128] cache read at layer 1, Smax
    512, 1025 (generate()'s default bucket), 64 and 2048, depths 1..Smax as
    one scalar and one a row, on the chunk edges (C - 1, C, C + 1 keys) and
    2047 keys of the 2048 cache, fp32, bf16 and fp16, once with ALiBi; then
    gpt2-xl's 25 heads of 64 (one query head a KV head).  Two calls give the
    same bits.  Returns the bf16 max abs err."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    err = 0.0
    cases = [("llama3-8b", 512, False), ("llama3-8b", 1025, False),
             ("llama3-8b", 64, False), ("llama3-8b", 1025, True),
             ("llama3-8b", 2048, False), ("gpt2-xl", 512, False)]
    for dtype_name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        for model, Smax, alibi in cases:
            m = DECODE_MODELS[model]
            C = dk.fd_chunk(m["DH"], torch.empty(0, dtype=dt).element_size())
            k = _randn(torch, (2, B, m["HKV"], Smax, m["DH"]), gen, dev).to(dt)
            v = _randn(torch, (2, B, m["HKV"], Smax, m["DH"]), gen, dev).to(dt)
            q = _randn(torch, (B, m["H"], m["DH"]), gen, dev).to(dt)
            rows = torch.linspace(0, Smax - 2, B, device=dev).long()
            edges = torch.tensor([C - 2, C - 1, C, 0, 2 * C, 3 * C - 1,
                                  Smax - 2, Smax - 1], device=dev).clamp(
                                      0, Smax - 1)
            for pos in (Smax - 2, Smax // 2, 0, rows, C - 2, C - 1,
                        min(C, Smax - 1), edges):
                y = dk.flash_decode_contig_cuda(q, k, v, pos,
                                                scale=m["DH"] ** -0.5,
                                                layer=1, alibi=alibi)
                torch.cuda.synchronize()
                what = (f"flash_decode contiguous {model} {dtype_name} Smax "
                        f"{Smax} alibi {alibi} pos "
                        f"{pos if isinstance(pos, int) else 'per row'}")
                e = _assert_close(
                    torch, y, dk._flash_decode_ref(q, k[1], v[1], pos,
                                                   scale=m["DH"] ** -0.5,
                                                   alibi=alibi),
                    ATTN_TOL[dtype_name], what)
                check(torch.equal(y, dk.flash_decode_contig_cuda(
                    q, k, v, pos, scale=m["DH"] ** -0.5, layer=1,
                    alibi=alibi)), f"{what}: two calls differ")
                if dtype_name == "bfloat16":
                    err = max(err, e)
            del k, v
    print(f"flash_decode contiguous vs plain: [2, 8, Hkv, Smax, Dh] at layer "
          f"1, Smax 512 / 1025 / 64 / 2048, depths 1..Smax scalar and per "
          f"row, on the chunk edges and 2047 keys, ALiBi, llama3-8b and gpt2-xl "
          f"heads: fp32 within 2e-4, bf16 within 2e-2, fp16 within 2.5e-3, "
          f"bit-equal on a repeat; bf16 max abs err {err:.3g}")
    return err


def _int8_weight(torch, shape, gen, dev):
    """int8 codes and [N] fp32 scales of a random bf16 weight, quantized
    as the int8 engine quantizes (models/quant.py)."""
    from deepspeed_tpu_torch.models.quant import quantize_weight

    w = _randn(torch, shape, gen, dev, shape[0] ** -0.5).to(torch.bfloat16)
    qt = quantize_weight(w)
    return qt.q, qt.scale.reshape(-1)


def check_int8_gemvs(torch, dev, gen):
    """The int8 bodies of the three GEMV kernels against their plain
    versions (``_deq`` then the bf16 product): llama3-8b's decode shapes,
    gpt2-xl's branches (LayerNorm with a bias, tanh-GeLU, no gate) and a
    ragged N (a last column tile part full), bf16 within GEMV_TOL.  Returns
    the max abs errs at llama3-8b's shapes."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    errs = {}
    shapes = [("llama3-8b", D, H * DH, F, NQKV, "rmsnorm", "silu", True),
              ("gpt2-xl", 1600, 1600, 6400, 4800, "layernorm", "gelu", False),
              ("ragged", 256, 192, 200, 200, "rmsnorm", "gelu_exact", True)]
    for name, d, m, f, n, kind, act, glu in shapes:
        x = _randn(torch, (B, d), gen, dev, 2).to(bf)
        sc = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(bf)
        nb = (0.1 * torch.randn(d, device=dev, generator=gen)).to(bf) \
            if kind == "layernorm" else None
        ref_b = torch.zeros_like(sc) if nb is None else nb
        bias = (lambda k: (0.1 * torch.randn(k, device=dev, generator=gen)).to(bf)
                ) if kind == "layernorm" else (lambda k: None)
        w, ws = _int8_weight(torch, (d, n), gen, dev)
        bq = bias(n)
        y = dk.fused_norm_qkv_int8_cuda(x, sc, nb, w, ws, bq, kind=kind,
                                        eps=1e-5)
        torch.cuda.synchronize()
        e1 = _assert_close(torch, y, dk._norm_qkv_ref(
            x, sc, ref_b, w, bq, kind=kind, eps=1e-5, wscale=ws),
            GEMV_TOL["bfloat16"], f"fused_norm_qkv int8 {name}")
        ctx = _randn(torch, (B, m), gen, dev).to(bf)
        resid = _randn(torch, (B, d), gen, dev, 2).to(bf)
        wo, wos = _int8_weight(torch, (m, d), gen, dev)
        bo = bias(d)
        r, h = dk.fused_proj_norm_int8_cuda(ctx, resid, wo, wos, bo, sc, nb,
                                            kind=kind, eps=1e-5,
                                            parallel=False)
        torch.cuda.synchronize()
        wr, wh = dk._proj_norm_ref(ctx, resid, wo, bo, sc, ref_b, kind=kind,
                                   eps=1e-5, parallel=False, wscale=wos)
        e2 = max(_assert_close(torch, r, wr, GEMV_TOL["bfloat16"],
                               f"fused_proj_norm int8 r {name}"),
                 _assert_close(torch, h, wh, GEMV_TOL["bfloat16"],
                               f"fused_proj_norm int8 h {name}"))
        again = dk.fused_proj_norm_int8_cuda(ctx, resid, wo, wos, bo, sc, nb,
                                             kind=kind, eps=1e-5, parallel=False)
        check(torch.equal(r, again[0]) and torch.equal(h, again[1]),
              f"fused_proj_norm int8 {name}: two calls differ")
        for rows in (1, 12):        # one row; two passes of 8
            c1 = _randn(torch, (rows, m), gen, dev).to(bf)
            r1 = _randn(torch, (rows, d), gen, dev, 2).to(bf)
            got = dk.fused_proj_norm_int8_cuda(c1, r1, wo, wos, bo, sc, nb, kind=kind,
                                               eps=1e-5, parallel=False)
            want = dk._proj_norm_ref(c1, r1, wo, bo, sc, ref_b, kind=kind, eps=1e-5,
                                     parallel=False, wscale=wos)
            for i in range(2):
                _assert_close(torch, got[i], want[i], GEMV_TOL["bfloat16"],
                              f"fused_proj_norm int8 {'rh'[i]} {name} at {rows} rows")
        hh = _randn(torch, (B, d), gen, dev).to(bf)
        wu, su = _int8_weight(torch, (d, f), gen, dev)
        wd, sd = _int8_weight(torch, (f, d), gen, dev)
        wg, sg = _int8_weight(torch, (d, f), gen, dev) if glu else (None, None)
        bu, bd = bias(f), bias(d)
        y = dk.fused_mlp_int8_cuda(hh, resid, wu, wd, wg, (su, sg, sd), bu,
                                   None, bd, act=act)
        torch.cuda.synchronize()
        e3 = _assert_close(torch, y, dk._mlp_ref(
            hh, resid, wu, wg, wd, bu, None, bd, act=act,
            wscales=(su, sg, sd)), GEMV_TOL["bfloat16"],
            f"fused_mlp int8 {name}")
        check(torch.equal(y, dk.fused_mlp_int8_cuda(
            hh, resid, wu, wd, wg, (su, sg, sd), bu, None, bd, act=act)),
            f"fused_mlp int8 {name}: two calls differ")
        for rows in (1, 12):        # one row; two passes of 8
            h1 = _randn(torch, (rows, d), gen, dev).to(bf)
            r1 = _randn(torch, (rows, d), gen, dev).to(bf)
            _assert_close(torch, dk.fused_mlp_int8_cuda(
                h1, r1, wu, wd, wg, (su, sg, sd), bu, None, bd, act=act),
                dk._mlp_ref(h1, r1, wu, wg, wd, bu, None, bd, act=act,
                            wscales=(su, sg, sd)), GEMV_TOL["bfloat16"],
                f"fused_mlp int8 {name} at {rows} rows")
        if name == "llama3-8b":
            errs = {"fused_norm_qkv_int8": e1, "fused_proj_norm_int8": e2,
                    "fused_mlp_int8": e3}
        print(f"int8 GEMVs vs plain at {name} (D {d}, N {n}, F {f}, {kind}, "
              f"{act}{' gated' if glu else ', no gate'}): bf16 within 2e-2; "
              f"max abs err norm_qkv {e1:.3g}, proj_norm {e2:.3g}, mlp "
              f"{e3:.3g} (proj_norm and mlp also at 1 and 12 rows and "
              f"bit-equal on a repeat)")
        del w, wo, wu, wd, wg
    return errs


def time_generate_kernels(torch, dev, gen, errs):
    """The contiguous flash_decode (``flash_decode_contig_times``); the
    int8 GEMVs at llama3-8b's decode shapes, cycling through weight copies
    past the 50 MB L2, beside the plain version and ``torch.matmul`` of the
    bf16 weight as a yardstick (no PyTorch call reads int8 weights)."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    out = {"flash_decode_contig": flash_decode_contig_times(torch, dev, gen)}
    out["flash_decode_contig"]["max_abs_err"] = errs["flash_decode_contig"]
    out["flash_decode_contig"]["ptxas"] = flash_decode_ptxas()

    zeros = torch.zeros(D, device=dev, dtype=bf)
    x = _randn(torch, (B, D), gen, dev, 2).to(bf)
    s = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).to(bf)
    wq = [_int8_weight(torch, (D, NQKV), gen, dev) for _ in range(4)]
    nw = cycler(wq)
    dense = (_randn(torch, (D, NQKV), gen, dev) * D ** -0.5).to(bf)
    nbytes = (x.numel() + s.numel() + B * NQKV) * 2 + D * NQKV + 4 * NQKV
    b_ms, b_by = bound_ms(nbytes, 2 * B * D * NQKV, BF16_FLOPS_PER_S)

    def qkv_plain():
        w, ws = nw()
        return dk._norm_qkv_ref(x, s, zeros, w, None, kind="rmsnorm",
                                eps=1e-5, wscale=ws)
    def qkv8():
        return dk.fused_norm_qkv_int8_cuda(x, s, None, *nw(), kind="rmsnorm", eps=1e-5)
    out["fused_norm_qkv_int8"] = {
        "shape": "x[8,4096] . wqkv[4096,6144] int8 + fp32 scales, bf16",
        "ms": time_ms(torch, qkv8),
        "plain_ms": time_ms(torch, qkv_plain, samples=10),
        "matmul_ms": time_ms(torch, lambda: torch.matmul(x, dense)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_norm_qkv_int8"],
        "host_us": host_us(torch, qkv8),
        "device_us": kernel_split(torch, qkv8, ("norm_qkv",),
                                  "fused_norm_qkv int8 x[8,4096]", calls=200)["norm_qkv"],
        "ptxas": [ln for ln in gemv16_ptxas() if "norm_qkv_int8" in ln]}
    r = out["fused_norm_qkv_int8"]
    r["bound_share"] = r["bound_ms"] * 1e3 / r["device_us"]
    print(f"time fused_norm_qkv int8 (tensor cores): device {r['device_us']:.2f} us alone, "
          f"bound {r['bound_ms'] * 1e3:.3f} us ({100 * r['bound_share']:.1f} % of it), call "
          f"{r['ms']:.5f} ms, host {r['host_us']:.3f} us a call; " + "; ".join(r["ptxas"]))
    del wq, nw, dense

    ctx = _randn(torch, (B, H * DH), gen, dev).to(bf)
    resid = _randn(torch, (B, D), gen, dev, 2).to(bf)
    wo = [_int8_weight(torch, (H * DH, D), gen, dev) for _ in range(6)]
    nw = cycler(wo)
    dense = (_randn(torch, (H * DH, D), gen, dev) * D ** -0.5).to(bf)
    nbytes = (ctx.numel() + resid.numel() + D + 2 * B * D) * 2 \
        + H * DH * D + 4 * D
    b_ms, b_by = bound_ms(nbytes, 2 * B * H * DH * D, BF16_FLOPS_PER_S)

    def proj():
        w, ws = nw()
        return dk.fused_proj_norm_int8_cuda(ctx, resid, w, ws, None, s, None,
                                            kind="rmsnorm", eps=1e-5,
                                            parallel=False)

    def proj_plain():
        w, ws = nw()
        return dk._proj_norm_ref(ctx, resid, w, None, s, zeros,
                                 kind="rmsnorm", eps=1e-5, parallel=False,
                                 wscale=ws)
    out["fused_proj_norm_int8"] = {
        "shape": "ctx[8,4096] . wo[4096,4096] int8 + fp32 scales, bf16",
        "ms": time_ms(torch, proj),
        "plain_ms": time_ms(torch, proj_plain, samples=10),
        "matmul_ms": time_ms(torch, lambda: torch.matmul(ctx, dense)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_proj_norm_int8"],
        "host_us": host_us(torch, proj),
        "graph_us": graph_us(torch, proj),
        "device_us": kernel_split(torch, proj, ("proj_norm_int8_mma_kernel",),
                                  "fused_proj_norm int8 ctx[8,4096]",
                                  calls=200)["proj_norm_int8_mma_kernel"],
        "ptxas": [ln for ln in gemv16_ptxas() if "proj_norm_int8" in ln]}
    r = out["fused_proj_norm_int8"]
    r["bound_share"] = r["bound_ms"] * 1e3 / r["device_us"]
    print(f"time fused_proj_norm int8 (tensor cores, cooperative): device "
          f"{r['device_us']:.2f} us alone, {r['graph_us']:.2f} us replayed from a CUDA "
          f"graph, bound {r['bound_ms'] * 1e3:.3f} us ({100 * r['bound_share']:.1f} % of "
          f"it), call {r['ms']:.5f} ms, host {r['host_us']:.3f} us a call; "
          + "; ".join(r["ptxas"]))
    del wo, nw, dense

    h = _randn(torch, (B, D), gen, dev).to(bf)
    wu, su = _int8_weight(torch, (D, F), gen, dev)
    wg, sg = _int8_weight(torch, (D, F), gen, dev)
    wd, sd = _int8_weight(torch, (F, D), gen, dev)
    a = torch.randn(B, F, device=dev, generator=gen).to(bf)
    dwu = (_randn(torch, (D, F), gen, dev) * D ** -0.5).to(bf)
    dwd = (_randn(torch, (F, D), gen, dev) * F ** -0.5).to(bf)
    nbytes = (2 * h.numel() + B * D) * 2 + 3 * D * F + 4 * (2 * F + D)
    b_ms, b_by = bound_ms(nbytes, 6 * B * D * F, BF16_FLOPS_PER_S)
    tags = {"fused_mlp_int8": ("mlp_act_int8_mma_kernel", "mlp_down_int8_mma_kernel")}
    out["fused_mlp_int8"] = {
        "shape": "h[8,4096] . wg,wu[4096,14336], a . wd[14336,4096] int8 + "
                 "fp32 scales, bf16",
        "ms": time_ms(torch, lambda: dk.fused_mlp_int8_cuda(
            h, resid, wu, wd, wg, (su, sg, sd), act="silu")),
        "plain_ms": time_ms(torch, lambda: dk._mlp_ref(
            h, resid, wu, wg, wd, None, None, None, act="silu",
            wscales=(su, sg, sd)), samples=10),
        "matmul_ms": time_ms(torch, lambda: (torch.matmul(h, dwu),
                                             torch.matmul(h, dwu),
                                             torch.matmul(a, dwd))),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_mlp_int8"],
        "device_us_split": kernel_split(torch, lambda: dk.fused_mlp_int8_cuda(
            h, resid, wu, wd, wg, (su, sg, sd), act="silu"),
            tags["fused_mlp_int8"], "fused_mlp int8 h[8,4096]")}
    del wu, wg, wd, dwu, dwd, a
    # gpt2-xl's decode MLP (no gate, tanh-GeLU): 4 weight copies, 82 MB, past L2
    d2, f2 = 1600, 6400
    h2 = _randn(torch, (B, d2), gen, dev).to(bf)
    r2 = _randn(torch, (B, d2), gen, dev).to(bf)
    ws = [(_int8_weight(torch, (d2, f2), gen, dev), _int8_weight(torch, (f2, d2), gen, dev))
          for _ in range(4)]
    nw = cycler(ws)

    def gpt2_mlp(fn):
        (wu2, su2), (wd2, sd2) = nw()
        return fn(wu2, su2, wd2, sd2)
    kern = lambda wu2, su2, wd2, sd2: dk.fused_mlp_int8_cuda(  # noqa: E731
        h2, r2, wu2, wd2, None, (su2, None, sd2), act="gelu")
    row = out["fused_mlp_int8"]
    row["gpt2_ms"] = time_ms(torch, lambda: gpt2_mlp(kern))
    row["gpt2_plain_ms"] = time_ms(torch, lambda: gpt2_mlp(
        lambda wu2, su2, wd2, sd2: dk._mlp_ref(h2, r2, wu2, None, wd2, None, None, None,
                                               act="gelu", wscales=(su2, None, sd2))),
        samples=10)
    row["gpt2_bound_ms"] = bound_ms((2 * h2.numel() + B * d2) * 2 + 2 * d2 * f2
                                    + 4 * (f2 + d2), 4 * B * d2 * f2, BF16_FLOPS_PER_S)[0]
    row["gpt2_device_us_split"] = kernel_split(
        torch, lambda: gpt2_mlp(kern), tags["fused_mlp_int8"], "fused_mlp int8 h[8,1600]")
    row["ptxas"] = mlp_int8_ptxas()
    print(f"time fused_mlp_int8 h[8,1600] . wu[1600,6400], a . wd[6400,1600] "
          f"int8 (gpt2-xl): kernel {row['gpt2_ms']:.5f} ms, plain "
          f"{row['gpt2_plain_ms']:.5f} ms, bound {row['gpt2_bound_ms']:.6f} ms")
    return out


def mlp_int8_ptxas():
    """ptxas's registers, shared memory and spills of the int8 MLP's
    kernels, one line an instantiation."""
    from deepspeed_tpu_torch.ops.kernels import build

    lines, entry = [], ""
    for ln in build.load_library("decode").ptxas_info:
        if "Compiling entry" in ln:
            entry = ln
        elif "int8_mma_kernel" in entry and ("Used" in ln or "spill" in ln):
            m = re.search(r"(mlp_\w+?_int8_mma_kernel)I(\w+?)EEEv", entry)
            args = ", ".join(v if t == "i" else ("true", "false")[v == "0"]
                             for t, v in re.findall(r"L([ib])(\d+)", m.group(2))) if m else ""
            lines.append(f"{m.group(1)}<{args}>: {ln.split(':')[-1].strip()}" if m else ln)
    return lines


# llama-1b4 training shapes: micro 4 x S 2048, D 2048, 16 heads of 128,
# the [24, 2048, 5632] MLP leaf for Adam
TB, TS, TD, TH, TDH, TL, TF = 4, 2048, 2048, 16, 128, 24, 5632
MD = 4096           # mixtral-8x7b's width: its train rows are [TB * TS, MD]
# the RMSNorm backward's partials kernels (rms_norm_bwd_row_kernel,
# rms_norm_bwd_kernel) and their ordered sum
RMS_BWD_KERNELS = ("rms_norm_bwd_", "rms_dg_reduce_kernel")
# flash gradients: relative Frobenius error, fp32 1e-4 (sums of up to S
# recomputed products in another order), bf16 2e-2 (p and ds rounded to
# bf16 before each product, as the reference kernel does); RMSNorm dγ (a
# sum over 8192 rows) relative 1e-4 fp32 / 2e-2 bf16; Adam 1e-6 (the same
# fp32 formula, three steps); fp16 the bf16 bounds over 8 (three more
# mantissa bits), and an fp16 Adam param TOL (one rounding of the update)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2.5e-3}
# flash output o, relative Frobenius on top of the elementwise ATTN_TOL:
# late causal rows average many keys, so |o| there is ~0.04 and a fixed
# 2e-2 atol alone would hide an error of a quarter of them; fp32 1e-5, bf16
# 1e-2 (p rounded to bf16 before P.V, then o to bf16; measured ~3e-3), fp16
# 1.25e-3 (the same roundings in fp16)
O_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1.25e-3}
ADAM_TOL = 1e-6


def _rel_err(got, want):
    return float((got.float() - want.float()).norm()
                 / max(float(want.float().norm()), 1.0))


def _lse_plain(torch, q, k, scale, bias=None):
    S = q.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return torch.logsumexp(logits.masked_fill(~mask, -1e30), -1)


def check_flash(torch, dev, gen, dtype_name, shape, alibi=False):
    """Flash fwd (o, lse) and bwd (dq, dk, dv) against mha_reference and
    its autograd on the same inputs (under ``alibi`` the ALiBi instances
    against the reference with the JAX ALiBi bias); two backward calls must
    give the same bits.  Returns (o max abs err, o relative err, grads max
    abs err, grads max rel err)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    dt = getattr(torch, dtype_name)
    fwd, bwd = fa.wrappers(dt, alibi)     # the instances of dt and ALiBi
    what = f"flash{' alibi' if alibi else ''}"
    q, k, v, do = (_randn(torch, shape, gen, dev).to(dt) for _ in range(4))
    scale = shape[-1] ** -0.5
    bias = fa._alibi_ref_bias(q, k, alibi)
    o, lse = fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    want_o = fa.mha_reference(q, k, v, bias=bias)
    e_o = _assert_close(torch, o, want_o, ATTN_TOL[dtype_name],
                        f"{what} fwd o {dtype_name} {shape}")
    rel_o = _rel_err(o, want_o)
    check(rel_o < O_REL_TOL[dtype_name], f"{what} fwd o {dtype_name} {shape}: "
          f"relative error {rel_o}")
    _assert_close(torch, lse, _lse_plain(torch, q, k, scale, bias), 1e-4,
                  f"{what} fwd lse {dtype_name} {shape}")
    grads = bwd(q, k, v, o, lse, do, True, scale)
    again = bwd(q, k, v, o, lse, do, True, scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"{what} bwd {dtype_name} {shape}: two calls differ")
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    fa.mha_reference(*ref, bias=bias).backward(do.float())
    rel = [_rel_err(g, r.grad) for g, r in zip(grads, ref)]
    check(max(rel) < GRAD_TOL[dtype_name], f"{what} bwd {dtype_name} {shape}: "
          f"relative errors dq/dk/dv {rel}")
    e_g = max(float((g.float() - r.grad).abs().max()) for g, r in zip(grads, ref))
    return e_o, rel_o, e_g, max(rel)


def check_train_kernels(torch, dev, gen):
    """The training path's kernels against their plain versions at the
    training shapes (and a ragged S, and llama-tiny's head dim 32), fp32,
    bf16 and fp16: the four new ones, and RMSNorm fwd and RoPE (q and k in
    one launch forward and backward, bit-equal) that serving also runs; bf16
    and fp16 max abs errors (fp16's keys end in ``_f16``)."""
    from deepspeed_tpu_torch.models.layers import rope_cache
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln
    from deepspeed_tpu_torch.ops.kernels import rope

    errs = {}
    for dtype_name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        f16 = "_f16" if dtype_name == "float16" else ""
        for shape in ((TB, TH, TS, TDH), (2, 3, 200, TDH), (2, 8, 333, 32)):
            e_o, rel_o, e_g, rel = check_flash(torch, dev, gen, dtype_name, shape)
            print(f"train kernels: flash {dtype_name} {list(shape)}: o max abs "
                  f"err {e_o:.3g}, relative (Frobenius) {rel_o:.3g}; dq/dk/dv "
                  f"max abs err {e_g:.3g}, max relative (Frobenius) {rel:.3g}")
            if dtype_name != "float32" and shape[2] == TS:
                errs["flash_attention_fwd" + f16] = e_o
                errs["flash_attention_bwd" + f16] = e_g
        # RoPE on q and k [4, 2048, 16 + 16, 128] in the projections' layout
        # with the path's cos/sin (rope_cache, cast to the compute dtype):
        # the forward, one launch, and the backward, one launch
        q = _randn(torch, (TB, TS, TH * TDH), gen, dev).to(dt).view(TB, TS, TH, TDH)
        k = _randn(torch, (TB, TS, TH * TDH), gen, dev).to(dt).view(TB, TS, TH, TDH)
        cos, sin = (c.to(dt) for c in rope_cache(TS, TDH, 10000.0, device=dev))
        _rope_equal(torch, rope.rope_qk_cuda(q, k, cos, sin),
                    rope.rope_qk_plain(q, k, cos, sin),
                    f"rope_qk {dtype_name} train shape")
        dq, dk = (t.transpose(1, 2).contiguous() for t in (q, k))
        _rope_equal(torch, rope.rope_qk_cuda(dq, dk, cos, sin, backward=True),
                    tuple(rope.partial_rope_plain(g, cos, -sin).transpose(1, 2)
                          .contiguous() for g in (dq, dk)),
                    f"rope_qk backward {dtype_name} train shape")
        print(f"train kernels: rope q + k {dtype_name} [4, 2048, 16+16, 128], forward "
              f"and backward: bit-equal to the plain version")
        del q, k, dq, dk
        if dtype_name != "float32":
            errs["rope_train" + f16] = 0.0
        x = _randn(torch, (TB * TS, TD), gen, dev, 3).to(dt)
        g = (1 + 0.1 * torch.randn(TD, device=dev, generator=gen)).to(dt)
        e = _assert_close(torch, ln.rms_norm_cuda(x, g, 1e-5),
                          ln.rms_norm_plain(x, g, 1e-5), TOL[dtype_name],
                          f"rms_norm {dtype_name} train shape")
        print(f"train kernels: rms_norm {dtype_name} [8192, 2048]: max abs err "
              f"{e:.3g}")
        if dtype_name != "float32":
            errs["rms_norm_train" + f16] = e
        dy = _randn(torch, (TB * TS, TD), gen, dev).to(dt)
        dx, dg = ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)
        dx2, dg2 = ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)
        torch.cuda.synchronize()
        check(torch.equal(dx, dx2) and torch.equal(dg, dg2),
              f"rms_norm_bwd {dtype_name}: two calls differ")
        want_dx, want_dg = ln.rms_norm_bwd_plain(x, g, dy, 1e-5)
        e = _assert_close(torch, dx, want_dx, TOL[dtype_name],
                          f"rms_norm_bwd dx {dtype_name}")
        rel = _rel_err(dg, want_dg)
        check(rel < GRAD_TOL[dtype_name], f"rms_norm_bwd dγ {dtype_name}: "
              f"relative error {rel}")
        print(f"train kernels: rms_norm_bwd {dtype_name} [8192, 2048]: dx max "
              f"abs err {e:.3g}, dγ relative {rel:.3g}")
        if dtype_name != "float32":
            errs["rms_norm_bwd" + f16] = e
        del x, dy, dx, dx2, want_dx
        # mixtral-8x7b's and llama3-8b's rows, [8192, 4096]: the row kernel
        x = _randn(torch, (TB * TS, MD), gen, dev, 3).to(dt)
        g = (1 + 0.1 * torch.randn(MD, device=dev, generator=gen)).to(dt)
        dy = _randn(torch, (TB * TS, MD), gen, dev).to(dt)
        dx, dg = ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)
        dx2, dg2 = ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)
        torch.cuda.synchronize()
        check(torch.equal(dx, dx2) and torch.equal(dg, dg2),
              f"rms_norm_bwd {dtype_name} [8192, 4096]: two calls differ")
        want_dx, want_dg = ln.rms_norm_bwd_plain(x, g, dy, 1e-5)
        e = _assert_close(torch, dx, want_dx, TOL[dtype_name],
                          f"rms_norm_bwd dx {dtype_name} [8192, 4096]")
        rel = _rel_err(dg, want_dg)
        check(rel < GRAD_TOL[dtype_name], f"rms_norm_bwd dγ {dtype_name} [8192, "
              f"4096]: relative error {rel}")
        print(f"train kernels: rms_norm_bwd {dtype_name} [8192, 4096]: dx max "
              f"abs err {e:.3g}, dγ relative {rel:.3g}")
        if dtype_name != "float32":
            errs["rms_norm_bwd_wide" + f16] = e
        del x, dy, dx, dx2, want_dx
    # Adam: the path's case (fp32 masters and accumulator) and bf16 grads
    n = TL * TD * TF
    for g_name in ("float32", "bfloat16"):
        p = _randn(torch, (n,), gen, dev)
        m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        ref = [p.clone(), m.clone(), v.clone()]
        for step in (1, 2, 3):
            gr = _randn(torch, (n,), gen, dev, 1e-3).to(getattr(torch, g_name))
            kw = dict(lr=3e-4 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=0.1, adam_w_mode=True)
            adam.fused_adam_update_cuda(p, gr, m, v, step, **kw)
            adam.fused_adam_update_plain(ref[0], gr, ref[1], ref[2], step, **kw)
        torch.cuda.synchronize()
        e = max(_assert_close(torch, got, want, ADAM_TOL, f"fused_adam {what} "
                              f"(grads {g_name})")
                for got, want, what in zip((p, m, v), ref, ("p", "m", "v")))
        print(f"train kernels: fused_adam fp32 params, {g_name} grads, "
              f"[{n}] x 3 steps: p/m/v max abs err {e:.3g}")
        if g_name == "float32":
            errs["fused_adam"] = e
        del p, m, v, ref, gr
    # the fp16-param instance (the op library's path for an fp16 leaf):
    # fp16 params and unit-scale fp16 grads, three steps at lr 1e-2 x step,
    # so each step moves p by ~1e-2, many fp16 ulps (_check_adam_f16_step)
    p = _randn(torch, (n,), gen, dev).half()
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    p0, e, e_mv, n_diff = p.clone(), 0.0, 0.0, 0
    for step in (1, 2, 3):
        gr = _randn(torch, (n,), gen, dev).half()
        kw = dict(lr=1e-2 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=0.1, adam_w_mode=True)
        before = (p.clone(), m.clone(), v.clone())
        adam.fused_adam_update_f16_cuda(p, gr, m, v, step, **kw)
        e_s, e_mv_s, d = _check_adam_f16_step(torch, adam, before, (p, m, v),
                                              gr, step, kw, "fused_adam f16")
        e, e_mv, n_diff = max(e, e_s), max(e_mv, e_mv_s), n_diff + d
        del before
    moved = _check_moved(torch, p, p0, "fused_adam f16")
    print(f"train kernels: fused_adam fp16 params and grads, [{n}] x 3 steps, "
          f"each from the same state as its plain version: p max abs err "
          f"{e:.3g} ({n_diff} of 3 x {n} differ, by one ulp at most; {moved:.5f}"
          f" of p moved), m/v {e_mv:.3g}")
    errs["fused_adam_f16"] = e
    del p, p0, m, v, gr
    torch.cuda.empty_cache()
    return errs


def check_flash_overflow(torch, dev):
    """What the fp16 loss scaler needs of the fp16 flash kernels, with and
    without ALiBi, at [1, 4, 2048, 128]: do scaled past fp16's range (2^16
    times standard normal values: inf wherever |do| > ~1) gives non-finite
    dq, dk and dv; and a finite do of 30000 in every element makes dv_j =
    30000 times column j's sum of p, past fp16's range for the early keys:
    the kernel's dv is inf wherever the plain version's fp32 value is past
    65520 * 1.01, and finite wherever it is below 65504 * 0.99 (no clamp to
    the largest finite value).  Head 3's slope 2^-8 keeps ~256 keys in view
    under ALiBi.  Returns the count of inf elements of dv in that head."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (_randn(torch, (1, 4, TS, TDH), gen, dev).half() for _ in range(4))
    scale = TDH ** -0.5
    out = {}
    for alibi in (False, True):
        fwd, bwd = fa.wrappers(torch.float16, alibi)
        o, lse = fwd(q, k, v, True, scale)
        past = (do.float() * 65536).half()
        grads = bwd(q, k, v, o, lse, past, True, scale)
        torch.cuda.synchronize()
        check(bool(torch.isinf(past).any()) and all(
            not bool(torch.isfinite(g).all()) for g in grads),
            f"flash f16 (alibi {alibi}): do past fp16's range left a grad finite")
        big = torch.full_like(do, 30000.0)
        dv = bwd(q, k, v, o, lse, big, True, scale)[2][0, 3].float()
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        fa.mha_reference(*ref, bias=fa._alibi_ref_bias(q, k, alibi)).backward(
            big.float())
        want = ref[2].grad[0, 3].abs()
        over = want > 65520 * 1.01
        check(bool(over.any()) and bool(torch.isinf(dv[over]).all())
              and bool(torch.isfinite(dv[want < 65504 * 0.99]).all()),
              f"flash f16 (alibi {alibi}): dv past fp16's range is not inf")
        out[alibi] = int(torch.isinf(dv).sum())
        print(f"train kernels: flash fp16 overflow (alibi {alibi}): do x 2^16 "
              f"gives non-finite dq, dk, dv; do = 30000 gives {out[alibi]} inf "
              f"of dv's {dv.numel()} in head 3, where the plain fp32 value is "
              f"past 65520 ({int(over.sum())} past 1.01 x)")
        del grads, dv, ref, want
    torch.cuda.empty_cache()
    return out


def check_alibi_flash(torch, dev, gen):
    """The ALiBi instances of the flash kernels against their plain version:
    bloom-1b7's training shape [4, 16, 2048, 128] in bf16 and fp16, and 12
    heads (slopes that interpolate) at head dims 64 and 32 and a ragged S,
    fp32, bf16 and fp16; bf16 and fp16 max abs errors at the training
    shape."""
    errs = {}
    for dtype_name, shape in (("bfloat16", (TB, TH, TS, TDH)),
                              ("float16", (TB, TH, TS, TDH)),
                              ("float32", (2, 12, 200, 64)),
                              ("bfloat16", (2, 12, 200, 64)),
                              ("float16", (2, 12, 200, 64)),
                              ("float32", (2, 12, 333, 32)),
                              ("bfloat16", (2, 12, 333, 32)),
                              ("float16", (2, 12, 333, 32))):
        e_o, rel_o, e_g, rel = check_flash(torch, dev, gen, dtype_name, shape,
                                           alibi=True)
        print(f"alibi kernels: flash {dtype_name} {list(shape)}: o max abs err "
              f"{e_o:.3g}, relative (Frobenius) {rel_o:.3g}; dq/dk/dv max abs "
              f"err {e_g:.3g}, max relative (Frobenius) {rel:.3g}")
        if shape == (TB, TH, TS, TDH):
            f16 = "_f16" if dtype_name == "float16" else ""
            errs[f"flash_attention_fwd{f16}_alibi"] = e_o
            errs[f"flash_attention_bwd{f16}_alibi"] = e_g
        else:   # (o, grads) max abs errors
            key = f"d{shape[-1]}_s{shape[2]}_{dtype_name}"
            errs.setdefault("alibi_h12", {})[key] = [e_o, e_g]
    torch.cuda.empty_cache()
    return errs


# the flash kernels by the names the profiler shows: the forward; the
# backward's dQ, delta pre-pass and dK/dV (dQ first: the call count is read
# from the first, and the pre-pass is shared with the ALiBi instances)
FLASH_KERNELS = {"fwd": ("flash_fwd_wgmma_kernel",),
                 "bwd": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_delta_kernel",
                         "flash_bwd_dkv_wgmma_kernel"),
                 "fwd_alibi": ("flash_fwd_wgmma_alibi_kernel",),
                 "bwd_alibi": ("flash_bwd_dq_wgmma_alibi_kernel",
                               "flash_bwd_delta_kernel",
                               "flash_bwd_dkv_wgmma_alibi_kernel"),
                 "fwd_f16": ("flash_fwd_wgmma_f16_kernel",),
                 "bwd_f16": ("flash_bwd_dq_wgmma_f16_kernel",
                             "flash_bwd_delta_f16_kernel",
                             "flash_bwd_dkv_wgmma_f16_kernel"),
                 "fwd_f16_alibi": ("flash_fwd_wgmma_f16_alibi_kernel",),
                 "bwd_f16_alibi": ("flash_bwd_dq_wgmma_f16_alibi_kernel",
                                   "flash_bwd_delta_f16_kernel",
                                   "flash_bwd_dkv_wgmma_f16_alibi_kernel")}


def span_ms(prof, tags):
    """The device time, in ms, of the union of the intervals of every kernel
    in ``prof`` whose name holds one of ``tags``: launches that overlap (a
    programmatic dependent beside the tail of its primary) count once."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and any(t in e.name for t in tags))
    total, lo, hi = 0.0, None, None
    for a, b in iv:
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def kernel_split(torch, call, names, what, calls=10, sessions=2):
    """Device time of each kernel (``names``) of one call under
    torch.profiler (the mean of ``calls`` calls), in us.  A session that
    holds none of the kernels is taken once more, printed as a repeat:
    on the H100 a session now and then comes back without them, in no
    fixed place.  One that holds some of them, or a second loss, fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profile_pad()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            profile_pad()
        events = prof.key_averages()
        split = {}
        for e in events:
            for name in names:
                if name in e.key:
                    split[name] = e.self_device_time_total / e.count
        if split or session == sessions:
            break
        print(f"{what}: profile session {session} holds none of {names} "
              f"({len(events)} kinds of event: "
              f"{sorted(e.key[:50] for e in events)[:4]}); a repeat of the "
              f"window follows")
    check(len(split) == len(names), f"{what}: profile kernels {split}")
    print(f"{what} device us a call: " + ", ".join(
        f"{n} {t:.2f}" for n, t in split.items())
        + f"; total {sum(split.values()):.2f}")
    return split


def flash_split(torch, call, what, shape):
    """Device time of each kernel of one flash forward or backward call
    (``what``: a key of FLASH_KERNELS), in us."""
    return kernel_split(torch, call, FLASH_KERNELS[what], f"flash {what} {shape}")


def _time_flash(torch, dev, gen, errs, dt):
    """The flash forward and backward instances of ``dt`` (bf16 or fp16) at
    llama-1b4's training shape, beside the plain version, SDPA on the same
    inputs and the bound (the same for both types: Hopper runs dense fp16
    and bf16 at one tensor-core rate)."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    f16 = "_f16" if dt == torch.float16 else ""
    name = "fp16" if f16 else "bf16"
    fwd, bwd = fa.wrappers(dt, False)
    out = {}
    shape = (TB, TH, TS, TDH)
    q, k, v, do = (_randn(torch, shape, gen, dev).to(dt) for _ in range(4))
    scale = TDH ** -0.5
    causal_pairs = TB * TH * TS * (TS + 1) // 2        # (row, key) pairs visible
    fwd_flops = 4 * causal_pairs * TDH                 # q k^T and p v
    b_ms, b_by = bound_ms(4 * q.numel() * 2 + TB * TH * TS * 4, fwd_flops,
                          BF16_FLOPS_PER_S)
    out["flash_attention_fwd" + f16] = {
        "shape": f"q, k, v [4,16,2048,128] {name}, causal",
        "ms": time_ms(torch, lambda: fwd(q, k, v, True, scale),
                      samples=20, inner=10),
        "plain_ms": time_ms(torch, lambda: fa.mha_reference(q, k, v), samples=5,
                            inner=3, warmup=2),
        "library_ms": time_ms(torch, lambda: F_.scaled_dot_product_attention(
            q, k, v, is_causal=True), samples=20, inner=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["flash_attention_fwd" + f16],
        "device_us_split": flash_split(torch, lambda: fwd(
            q, k, v, True, scale), "fwd" + f16, "[4,16,2048,128]")}
    o, lse = fwd(q, k, v, True, scale)
    # the backward's least work: the five products s, dp, dv, dq, dk
    b_ms, b_by = bound_ms(8 * q.numel() * 2 + TB * TH * TS * 4,
                          2.5 * fwd_flops, BF16_FLOPS_PER_S)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = fa.mha_reference(*ref)
    lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F_.scaled_dot_product_attention(*lib, is_causal=True)
    out["flash_attention_bwd" + f16] = {
        "shape": f"q, k, v, o, do [4,16,2048,128] {name}, causal (three "
                 f"launches: delta, dQ, dK/dV)",
        "ms": time_ms(torch, lambda: bwd(
            q, k, v, o, lse, do, True, scale), samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
            ref_out, ref, do.float(), retain_graph=True), samples=5, inner=3,
            warmup=2),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib, do, retain_graph=True), samples=20, inner=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["flash_attention_bwd" + f16],
        "device_us_split": flash_split(torch, lambda: bwd(
            q, k, v, o, lse, do, True, scale), "bwd" + f16, "[4,16,2048,128]")}
    del q, k, v, do, o, lse, ref, ref_out, lib, lib_out
    torch.cuda.empty_cache()
    return out


def time_train_kernels(torch, dev, gen, errs):
    """bf16 at the llama-1b4 training shapes (Adam: fp32 masters and grads
    over the [24, 2048, 5632] MLP leaf); the flash kernels' fp16 instances
    at the same shape beside SDPA in fp16, and Adam's fp16-param instance
    on the leaf beside ``AdamW(fused=True)`` over fp16 params."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln

    bf = torch.bfloat16
    out = {}
    x = _randn(torch, (TB * TS, TD), gen, dev).to(bf)
    dy = _randn(torch, (TB * TS, TD), gen, dev).to(bf)
    g = torch.ones(TD, device=dev, dtype=bf)
    b_ms, b_by = bound_ms((3 * x.numel() + 2 * TD) * 2, 10 * x.numel())
    # the library call: F.rms_norm's autograd backward on the same inputs
    lx, lg = x.clone().requires_grad_(), g.clone().requires_grad_()
    ly = F_.rms_norm(lx, (TD,), lg, eps=1e-5)
    out["rms_norm_bwd"] = {
        "shape": "x, dy [8192,2048] bf16",
        "ms": time_ms(torch, lambda: ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)),
        "plain_ms": time_ms(torch, lambda: ln.rms_norm_bwd_plain(x, g, dy, 1e-5),
                            samples=10),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            ly, (lx, lg), dy, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["rms_norm_bwd"],
        "device_us_split": kernel_split(
            torch, lambda: ln.rms_norm_bwd_cuda(x, g, dy, 1e-5), RMS_BWD_KERNELS,
            "rms_norm_bwd [8192,2048]", calls=20)}
    del x, dy, lx, lg, ly
    # mixtral-8x7b's train rows, [8192, 4096]: the row kernel
    x = _randn(torch, (TB * TS, MD), gen, dev).to(bf)
    dy = _randn(torch, (TB * TS, MD), gen, dev).to(bf)
    g = torch.ones(MD, device=dev, dtype=bf)
    lx, lg = x.clone().requires_grad_(), g.clone().requires_grad_()
    ly = F_.rms_norm(lx, (MD,), lg, eps=1e-5)
    b_ms, _ = bound_ms((3 * x.numel() + 2 * MD) * 2, 10 * x.numel())
    out["rms_norm_bwd"].update({
        "wide_shape": "x, dy [8192,4096] bf16 (mixtral-8x7b's train rows)",
        "wide_ms": time_ms(torch, lambda: ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)),
        "wide_plain_ms": time_ms(torch, lambda: ln.rms_norm_bwd_plain(
            x, g, dy, 1e-5), samples=10),
        "wide_library_ms": time_ms(torch, lambda: torch.autograd.grad(
            ly, (lx, lg), dy, retain_graph=True)),
        "wide_bound_ms": b_ms, "wide_max_abs_err": errs["rms_norm_bwd_wide"],
        "wide_device_us_split": kernel_split(
            torch, lambda: ln.rms_norm_bwd_cuda(x, g, dy, 1e-5), RMS_BWD_KERNELS,
            "rms_norm_bwd [8192,4096]", calls=20)})
    del x, dy, lx, lg, ly

    for dt in (bf, torch.float16):
        out.update(_time_flash(torch, dev, gen, errs, dt))
    n = TL * TD * TF
    p, gr = _randn(torch, (n,), gen, dev), _randn(torch, (n,), gen, dev, 1e-3)
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              adam_w_mode=True)
    b_ms, b_by = bound_ms(28 * n, 16 * n)
    lp = p.clone().requires_grad_()
    lp.grad = gr.clone()
    lib_opt = torch.optim.AdamW([lp], lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
    out["fused_adam"] = {
        "shape": f"fp32 params, grads, m, v [{n}] (the [24,2048,5632] MLP leaf)",
        "ms": time_ms(torch, lambda: adam.fused_adam_update_cuda(
            p, gr, m, v, 5, **kw), samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: adam.fused_adam_update_plain(
            p, gr, m, v, 5, **kw), samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lib_opt.step, samples=20, inner=5),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["fused_adam"]}
    del p, gr, m, v, lp, lib_opt
    # the fp16-param instance: fp16 p and g, fp32 m and v (22 bytes a
    # parameter); PyTorch's fused AdamW over fp16 params keeps fp16 moments
    p, gr = _randn(torch, (n,), gen, dev).half(), _randn(torch, (n,), gen, dev, 1e-3).half()
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    b_ms, b_by = bound_ms(22 * n, 16 * n)
    lp = p.clone().requires_grad_()
    lp.grad = gr.clone()
    lib_opt = torch.optim.AdamW([lp], lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
    out["fused_adam_f16"] = {
        "shape": f"fp16 params and grads, fp32 m, v [{n}] (the [24,2048,5632] "
                 f"MLP leaf)",
        "ms": time_ms(torch, lambda: adam.fused_adam_update_f16_cuda(
            p, gr, m, v, 5, **kw), samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: adam.fused_adam_update_plain(
            p, gr, m, v, 5, **kw), samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lib_opt.step, samples=20, inner=5),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["fused_adam_f16"]}
    del p, gr, m, v, lp, lib_opt
    torch.cuda.empty_cache()
    return out


def alibi_causal_mask(torch, H, S, dev, dtype):
    """ALiBi's bias with the causal mask as one float [1, H, S, S] tensor
    (-inf above the diagonal): what SDPA takes as ``attn_mask``."""
    from deepspeed_tpu_torch.models.layers import alibi_bias

    pos = torch.arange(S, device=dev)
    bias = alibi_bias(H, pos, pos)[None]
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    return bias.masked_fill(~keep, float("-inf")).to(dtype)


def time_alibi_flash(torch, dev, gen, errs):
    """The ALiBi flash kernels at bloom-1b7's training shape [4, 16, 2048,
    128], bf16 and fp16, causal: the call beside the plain version and SDPA
    given the ALiBi + causal bias as a float mask (the library's nearest
    call; timed only), forward and forward + backward, with each kernel's
    device time.  The bound is the non-ALiBi rows' (the same products; the
    bias is elementwise work under them)."""
    out = {}
    for dt in (torch.bfloat16, torch.float16):
        out.update(_time_alibi_flash(torch, dev, gen, errs, dt))
    for name in out:
        out[name]["max_abs_err_h12"] = errs["alibi_h12"]
    return out


def _time_alibi_flash(torch, dev, gen, errs, dt):
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    f16 = "_f16" if dt == torch.float16 else ""
    name = "fp16" if f16 else "bf16"
    fwd, bwd = fa.wrappers(dt, True)
    shape = (TB, TH, TS, TDH)
    q, k, v, do = (_randn(torch, shape, gen, dev).to(dt) for _ in range(4))
    scale = TDH ** -0.5
    bias = fa._alibi_ref_bias(q, k, True)
    mask = alibi_causal_mask(torch, TH, TS, dev, dt)
    causal_pairs = TB * TH * TS * (TS + 1) // 2
    fwd_flops = 4 * causal_pairs * TDH
    out = {}
    b_ms, b_by = bound_ms(4 * q.numel() * 2 + TB * TH * TS * 4, fwd_flops,
                          BF16_FLOPS_PER_S)
    out[f"flash_attention_fwd{f16}_alibi"] = {
        "shape": f"q, k, v [4,16,2048,128] {name}, causal, ALiBi",
        "ms": time_ms(torch, lambda: fwd(q, k, v, True, scale),
                      samples=20, inner=10),
        "plain_ms": time_ms(torch, lambda: fa.mha_reference(q, k, v, bias=bias),
                            samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lambda: F_.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), samples=20, inner=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs[f"flash_attention_fwd{f16}_alibi"],
        "device_us_split": flash_split(torch, lambda: fwd(
            q, k, v, True, scale), f"fwd{f16}_alibi", "[4,16,2048,128]")}
    o, lse = fwd(q, k, v, True, scale)
    b_ms, b_by = bound_ms(8 * q.numel() * 2 + TB * TH * TS * 4,
                          2.5 * fwd_flops, BF16_FLOPS_PER_S)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref_out = fa.mha_reference(*ref, bias=bias)
    lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F_.scaled_dot_product_attention(*lib, attn_mask=mask)

    def library_fwd_bwd():
        y = F_.scaled_dot_product_attention(*lib, attn_mask=mask)
        return torch.autograd.grad(y, lib, do)
    out[f"flash_attention_bwd{f16}_alibi"] = {
        "shape": f"q, k, v, o, do [4,16,2048,128] {name}, causal, ALiBi "
                 f"(three launches: delta, dQ, dK/dV)",
        "ms": time_ms(torch, lambda: bwd(
            q, k, v, o, lse, do, True, scale), samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
            ref_out, ref, do.float(), retain_graph=True), samples=5, inner=3,
            warmup=2),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib, do, retain_graph=True), samples=20, inner=5),
        # forward and backward together, the kernels' and SDPA's
        "library_fwd_bwd_ms": time_ms(torch, library_fwd_bwd, samples=20,
                                      inner=5),
        "fwd_bwd_ms": time_ms(torch, lambda: (fwd(q, k, v, True, scale), bwd(
            q, k, v, o, lse, do, True, scale)), samples=20, inner=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs[f"flash_attention_bwd{f16}_alibi"],
        "device_us_split": flash_split(torch, lambda: bwd(
            q, k, v, o, lse, do, True, scale), f"bwd{f16}_alibi", "[4,16,2048,128]")}
    del q, k, v, do, o, lse, ref, ref_out, lib, lib_out, bias, mask
    torch.cuda.empty_cache()
    return out


# the optimizers' kernels: every operation of fused_adam8bit, fused_lamb
# and quantize is an IEEE-rounded intrinsic (no FMA contraction), so the
# codes, scales, moments and stochastically rounded params EQUAL their plain
# versions'; LAMB's p is held within 1e-5 relative (its norms are summed in
# another order than torch.linalg.vector_norm's), the norms within 1e-5
# relative and bit-equal on a repeat
LAMB_TOL = 1e-5
# the leaf sizes: the [24, 2048, 5632] MLP leaf, and a ragged one (at block
# 512 neither a multiple of the block nor giving 32-row multiples)
BIG_LEAF, RAGGED = TL * TD * TF, 1000003


def _adam8bit_state(torch, dev, n, block):
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as k8

    rows = k8.state_rows(n, block)
    codes = torch.zeros(rows, block, dtype=torch.int8, device=dev)
    return [codes, torch.ones(rows, 1, device=dev), codes.clone(),
            torch.ones(rows, 1, device=dev)]


def check_optimizer_kernels(torch, dev, gen):
    """fused_adam8bit, the two LAMB phases and quantize against their plain
    versions at the path's largest leaf and a ragged one, three steps;
    returns the max abs errors (all 0 when equal)."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as k8
    from deepspeed_tpu_torch.ops.kernels import fused_lamb as kl
    from deepspeed_tpu_torch.ops.kernels import quantizer as kq

    errs = {"fused_adam8bit": 0.0, "fused_lamb_phase1": 0.0,
            "fused_lamb_scale": 0.0, "quantize": 0.0}
    # Adam8bit: config A (bf16 params and grads, stochastic rounding), bf16
    # params with fp32 grads, and fp32 params (no rounding) with fp32 and
    # bf16 grads; block 512 (the default) and the largest, 4096
    cases = [(BIG_LEAF, 512, "bfloat16", "bfloat16", True),
             (BIG_LEAF, 512, "float32", "float32", False),
             (RAGGED, 512, "bfloat16", "float32", True),
             (RAGGED, 4096, "float32", "bfloat16", False)]
    for n, block, p_name, g_name, sr in cases:
        p = _randn(torch, (n,), gen, dev).to(getattr(torch, p_name))
        st = _adam8bit_state(torch, dev, n, block)
        rp, rst = p.clone(), [t.clone() for t in st]
        for step in (1, 2, 3):
            g = _randn(torch, (n,), gen, dev, 1e-3).to(getattr(torch, g_name))
            kw = dict(lr=3e-4 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=0.1, seed=k8.sr_seed(step, 3), sr=sr)
            k8.fused_adam8bit_update_cuda(p, g, *st, step, **kw)
            k8.fused_adam8bit_update_plain(rp, g, *rst, step, **kw)
        torch.cuda.synchronize()
        e = float((p.float() - rp.float()).abs().max())
        codes = [int((a.int() - b.int()).abs().max()) for a, b in
                 ((st[0], rst[0]), (st[2], rst[2]))]
        check(torch.equal(p, rp) and all(torch.equal(a, b) for a, b in
                                         zip(st, rst)),
              f"fused_adam8bit {p_name} params / {g_name} grads, n {n}, block "
              f"{block}, sr {sr}: p max abs err {e}, codes max diff {codes}")
        print(f"optimizer kernels: fused_adam8bit {p_name} params, {g_name} "
              f"grads, sr {sr}, [{n}] at block {block} x 3 steps: p, codes and "
              f"scales equal to the plain version")
        del p, st, rp, rst, g
    # LAMB: fp32 (config B), the big leaf and the ragged one
    for n in (BIG_LEAF, RAGGED):
        p = _randn(torch, (n,), gen, dev)
        m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        rp, rm, rv = p.clone(), m.clone(), v.clone()
        for step in (1, 2, 3):
            g = _randn(torch, (n,), gen, dev, 1e-3)
            kw = dict(beta1=0.9, beta2=0.95, eps=1e-6, weight_decay=0.1)
            m0, v0 = m.clone(), v.clone()
            stats = kl.lamb_phase1_cuda(p, g, m, v, step, lr=3e-4 * step, **kw)
            again = kl.lamb_phase1_cuda(p, g, m0, v0, step, lr=3e-4 * step, **kw)
            kl.lamb_scale_cuda(p, m, v, stats, step, **kw)
            want = kl.lamb_phase1_plain(rp, g, rm, rv, step, lr=3e-4 * step, **kw)
            kl.lamb_scale_plain(rp, rm, rv, want, step, **kw)
            torch.cuda.synchronize()
            check(torch.equal(stats, again), f"lamb phase 1 [{n}]: two calls "
                  f"give other norms: {stats.tolist()} vs {again.tolist()}")
            _assert_close(torch, stats, want, LAMB_TOL, f"lamb stats [{n}]")
            del m0, v0
        check(torch.equal(m, rm) and torch.equal(v, rv),
              f"lamb phase 1 [{n}]: moments differ from the plain version")
        rel = _rel_err(p, rp)
        e = _assert_close(torch, p, rp, LAMB_TOL, f"lamb scale [{n}]")
        check(rel < LAMB_TOL, f"lamb [{n}]: relative error {rel}")
        print(f"optimizer kernels: fused_lamb fp32 [{n}] x 3 steps: moments "
              f"equal, norms bit-equal on a repeat, stats {stats.tolist()} vs "
              f"plain {want.tolist()}; p max abs err {e:.3g}, relative "
              f"(Frobenius) {rel:.3g}")
        if n == BIG_LEAF:
            errs["fused_lamb_scale"] = e
            errs["fused_lamb_phase1"] = float((stats - want).abs().max())
        del p, m, v, rp, rm, rv, g
    # quantize: bits 8 and 4 at blocks 128 / 512 / 2048, the big fp32 leaf
    # at the library's default block (2048) and a ragged bf16 size
    x = _randn(torch, (BIG_LEAF,), gen, dev, 3)
    xr = _randn(torch, (RAGGED,), gen, dev, 3).to(torch.bfloat16)
    for bits in (8, 4):
        for t, block in ((x, 2048), (xr, 128), (xr, 512), (xr, 2048)):
            q, sc, pad = kq.quantize_cuda(t, bits, block)
            wq, ws, wpad = kq.quantize_plain(t, bits, block)
            torch.cuda.synchronize()
            check(pad == wpad and torch.equal(q, wq) and torch.equal(sc, ws),
                  f"quantize bits {bits} block {block} [{t.numel()}] "
                  f"{t.dtype}: codes or scales differ from the plain version")
        print(f"optimizer kernels: quantize bits {bits}, fp32 [{BIG_LEAF}] at "
              f"block 2048 and bf16 [{RAGGED}] at 128 / 512 / 2048: codes and "
              f"scales equal")
    del x, xr, q, sc, wq, ws
    torch.cuda.empty_cache()
    return errs


def time_optimizer_kernels(torch, dev, gen, errs):
    """The three optimizer kernels at the [24, 2048, 5632] leaf: Adam8bit as
    config A runs it (bf16 params and grads, stochastic rounding) and over
    fp32 masters, LAMB's two phases in fp32, quantize on fp32 at block
    2048.  PyTorch has no call computing the same functions."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as k8
    from deepspeed_tpu_torch.ops.kernels import fused_lamb as kl
    from deepspeed_tpu_torch.ops.kernels import quantizer as kq

    n = BIG_LEAF
    out = {}
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    for p_name, bpp in (("bfloat16", 10), ("float32", 16)):
        dt = getattr(torch, p_name)
        p = _randn(torch, (n,), gen, dev).to(dt)
        g = _randn(torch, (n,), gen, dev, 1e-3).to(dt)
        st = _adam8bit_state(torch, dev, n, 512)
        sr = p_name == "bfloat16"
        rows = st[0].shape[0]
        # each input read once, each output written once: p, g, the two
        # codes and the two scales; ~40 fp32 operations an element
        b_ms, b_by = bound_ms(bpp * n + 16 * rows, 40 * n)
        r = {"shape": f"{p_name} params and grads [{n}], block 512"
                      + (", stochastic rounding" if sr else ""),
             "ms": time_ms(torch, lambda: k8.fused_adam8bit_update_cuda(
                 p, g, *st, 5, seed=7, sr=sr, **kw), samples=20, inner=5),
             "plain_ms": time_ms(torch, lambda: k8.fused_adam8bit_update_plain(
                 p, g, *st, 5, seed=7, sr=sr, **kw), samples=3, inner=2,
                 warmup=1),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             "max_abs_err": errs["fused_adam8bit"]}
        if sr:
            out["fused_adam8bit"] = r
        else:
            out["fused_adam8bit"]["fp32_masters"] = {
                k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
        del p, g, st
        torch.cuda.empty_cache()

    p, g = _randn(torch, (n,), gen, dev), _randn(torch, (n,), gen, dev, 1e-3)
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    lkw = dict(beta1=0.9, beta2=0.95, eps=1e-6, weight_decay=0.1)
    stats = kl.lamb_phase1_cuda(p, g, m, v, 5, lr=3e-4, **lkw)
    b_ms, b_by = bound_ms(24 * n, 20 * n)            # reads p g m v, writes m v
    out["fused_lamb_phase1"] = {
        "shape": f"fp32 params, grads, m, v [{n}] (phase 1 and the reduce)",
        "ms": time_ms(torch, lambda: kl.lamb_phase1_cuda(p, g, m, v, 5, lr=3e-4,
                                                         **lkw),
                      samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: kl.lamb_phase1_plain(
            p, g, m, v, 5, lr=3e-4, **lkw), samples=3, inner=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_lamb_phase1"]}
    b_ms, b_by = bound_ms(16 * n, 12 * n)            # reads p m v, writes p
    out["fused_lamb_scale"] = {
        "shape": f"fp32 params, m, v [{n}]",
        "ms": time_ms(torch, lambda: kl.lamb_scale_cuda(p, m, v, stats, 5, **lkw),
                      samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: kl.lamb_scale_plain(
            p, m, v, stats, 5, **lkw), samples=3, inner=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_lamb_scale"],
        # the whole LAMB update must read p, g, m, v and write p, m, v
        "whole_update_bound_ms": bound_ms(28 * n, 32 * n)[0]}
    del p, g, m, v
    torch.cuda.empty_cache()

    x = _randn(torch, (n,), gen, dev, 3)
    nb = -(-n // 2048)
    b_ms, b_by = bound_ms(5 * n + 4 * nb, 4 * n)
    out["quantize"] = {
        "shape": f"fp32 x [{n}], 8 bits, block 2048",
        "ms": time_ms(torch, lambda: kq.quantize_cuda(x, 8, 2048), samples=20,
                      inner=5),
        "plain_ms": time_ms(torch, lambda: kq.quantize_plain(x, 8, 2048),
                            samples=3, inner=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["quantize"]}
    del x
    torch.cuda.empty_cache()
    return out


# gpt2-xl shapes: micro 8 x S 1024, D 1600, 25 heads of 64, F 6400; decode
# rows = 8 slots; softmax over the scores of 4 sequences
GB, GS, GD, GH, GDH, GF, GSB = 8, 1024, 1600, 25, 64, 6400, 4
# softmax, beside the elementwise TOL: each output within one rounding of
# its own size (fp32 1e-5 relative; bf16 2^-8 relative, taken as 8e-3), with
# a 1e-6 floor: a 1024-wide row's probabilities are ~1e-3, and an absolute
# 2e-2 alone would pass them wholly wrong
SOFTMAX_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _ln_inputs(torch, dev, gen, dt, shape):
    n = shape[-1]
    x = (_randn(torch, shape, gen, dev, 3) + 1.5).to(dt)
    g = (1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(dt)
    b = (0.1 * torch.randn(n, device=dev, generator=gen)).to(dt)
    dy = _randn(torch, shape, gen, dev).to(dt)
    return x, g, b, dy


def _gpt2_flash_check(torch, dev, gen, dtype_name):
    e_o, rel_o, e_g, rel = check_flash(torch, dev, gen, dtype_name,
                                       (GB, GH, GS, GDH))
    print(f"gpt2 kernels: flash {dtype_name} {[GB, GH, GS, GDH]}: o max abs "
          f"err {e_o:.3g}, relative (Frobenius) {rel_o:.3g}; dq/dk/dv max "
          f"abs err {e_g:.3g}, max relative (Frobenius) {rel:.3g}")
    torch.cuda.empty_cache()


def check_gpt2_kernels(torch, dev, gen):
    """The gpt2 family's kernels against their plain versions, fp32 and
    bf16: LayerNorm fwd and bwd, scaled masked softmax, bias_act, and flash
    attention at gpt2-xl's shape, and in fp16 LayerNorm and flash; bf16 and
    fp16 max abs errors at the path shapes."""
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln
    from deepspeed_tpu_torch.ops.kernels import softmax as sm

    errs = {}
    for dtype_name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        bf = dtype_name == "bfloat16"
        f16 = dtype_name == "float16"
        # the streaming warps at gpt2-xl's and bloom-1b7's training rows
        # (D 1600, 2048), the row kernel at the decode and prefill rows and a
        # ragged row count, then the block-per-row path (n no multiple of the
        # 16-byte vector; n past 2048)
        for shape in ((GB * GS, GD), (GB, GD), (64, GD), (37, GD), (GB * GS, 2048),
                      (5, 100), (3, 4096)):
            x, g, b, dy = _ln_inputs(torch, dev, gen, dt, shape)
            y = ln.layer_norm_cuda(x, g, b, 1e-5)
            torch.cuda.synchronize()
            e = _assert_close(torch, y, ln.layer_norm_plain(x, g, b, 1e-5),
                              TOL[dtype_name], f"layer_norm {dtype_name} {shape}")
            check(torch.equal(y, ln.layer_norm_cuda(x, g, b, 1e-5)),
                  f"layer_norm {dtype_name} {shape}: two calls differ")
            got = ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
            again = ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"layer_norm_bwd {dtype_name} {shape}: two calls differ")
            want = ln.layer_norm_bwd_plain(x, g, dy, 1e-5)
            e_dx = _assert_close(torch, got[0], want[0], TOL[dtype_name],
                                 f"layer_norm_bwd dx {dtype_name} {shape}")
            rel = max(_rel_err(got[1], want[1]), _rel_err(got[2], want[2]))
            check(rel < GRAD_TOL[dtype_name], f"layer_norm_bwd dγ/dβ "
                  f"{dtype_name} {shape}: relative error {rel}")
            print(f"gpt2 kernels: layer_norm {dtype_name} {list(shape)}: y max "
                  f"abs err {e:.3g}; bwd dx {e_dx:.3g}, dγ/dβ relative "
                  f"{rel:.3g}, second call bit-equal")
            if bf and shape == (GB * GS, GD):
                errs["layer_norm"], errs["layer_norm_bwd"] = e, e_dx
            if bf and shape == (GB * GS, 2048):
                errs["layer_norm_bwd_bloom"] = e_dx
            if f16 and shape == (GB * GS, GD):
                errs["layer_norm_f16"], errs["layer_norm_bwd_f16"] = e, e_dx
            del x, dy, y, got, again, want
        if f16:     # softmax and bias_act are on no fp16 path
            _gpt2_flash_check(torch, dev, gen, dtype_name)
            continue
        # a causal [S, S] bool mask and a per-sequence [B, 1, n] int padding
        # mask, each read through its strides; n = 1000 is no power of two
        causal = torch.ones(GS, GS, dtype=torch.bool, device=dev).tril()
        padding = torch.ones(3, 1, 1000, dtype=torch.int32, device=dev)
        padding[1, :, 640:] = 0
        for shape, mask in (((GSB, GH, GS, GS), None),
                            ((GSB, GH, GS, GS), causal),
                            ((3, 7, 1000), None), ((3, 7, 1000), padding)):
            x = _randn(torch, shape, gen, dev, 4).to(dt)
            y = sm.scaled_masked_softmax_triton(x, mask, GDH ** -0.5)
            torch.cuda.synchronize()
            want = sm.scaled_masked_softmax_plain(x, mask, GDH ** -0.5)
            what = (f"softmax {dtype_name} {list(shape)} "
                    f"{'masked' if mask is not None else 'no mask'}")
            e = _assert_close(torch, y, want, TOL[dtype_name], what)
            try:
                torch.testing.assert_close(y.float(), want.float(), atol=1e-6,
                                           rtol=SOFTMAX_RTOL[dtype_name])
            except AssertionError as err:
                raise RuntimeError(f"chip_smoke: {what}: relative check: "
                                   f"{err}") from None
            print(f"gpt2 kernels: {what}: max abs err {e:.3g}, each output "
                  f"within {SOFTMAX_RTOL[dtype_name]:g} relative")
            if bf and shape[-1] == GS:
                errs["scaled_masked_softmax"] = max(
                    errs.get("scaled_masked_softmax", 0.0), e)
            del x, y, want
        x = _randn(torch, (GB * GS, GF), gen, dev, 3).to(dt)
        b = _randn(torch, (GF,), gen, dev).to(dt)
        for act in ("gelu", "relu", "silu", "identity"):
            y = sm.bias_act_triton(x, b, act)
            torch.cuda.synchronize()
            e = _assert_close(torch, y, sm.bias_act_plain(x, b, act),
                              TOL[dtype_name], f"bias_act {act} {dtype_name}")
            print(f"gpt2 kernels: bias_act {act} {dtype_name} "
                  f"[{GB * GS}, {GF}]: max abs err {e:.3g}")
            if bf:
                errs["bias_act"] = max(errs.get("bias_act", 0.0), e)
        del x, y
        _gpt2_flash_check(torch, dev, gen, dtype_name)
    # Adam on gpt2-xl's small leaves: the final norm's [1600] vector and a
    # stacked [48, 1600] norm leaf (fp32 masters and accumulator), three
    # steps against the plain update
    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam

    for shape in ((GD,), (48, GD)):
        p = _randn(torch, shape, gen, dev)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        ref = [p.clone(), m.clone(), v.clone()]
        for step in (1, 2, 3):
            gr = _randn(torch, shape, gen, dev, 1e-3)
            kw = dict(lr=3e-4 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=0.1, adam_w_mode=True)
            adam.fused_adam_update_cuda(p, gr, m, v, step, **kw)
            adam.fused_adam_update_plain(ref[0], gr, ref[1], ref[2], step, **kw)
        torch.cuda.synchronize()
        e = max(_assert_close(torch, got, want, ADAM_TOL,
                              f"fused_adam {what} {list(shape)}")
                for got, want, what in zip((p, m, v), ref, ("p", "m", "v")))
        print(f"gpt2 kernels: fused_adam fp32 {list(shape)} x 3 steps: p/m/v "
              f"max abs err {e:.3g}")
        errs["fused_adam_gpt2"] = max(errs.get("fused_adam_gpt2", 0.0), e)
    return errs


def time_gpt2_kernels(torch, dev, gen, errs):
    """bf16 at gpt2-xl's shapes, beside the plain version, the PyTorch
    library call of the same function, and the bound from bytes."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln
    from deepspeed_tpu_torch.ops.kernels import softmax as sm

    bf = torch.bfloat16
    out = {}
    x, g, b, dy = _ln_inputs(torch, dev, gen, bf, (GB * GS, GD))
    b_ms, b_by = bound_ms((2 * x.numel() + 2 * GD) * 2, 8 * x.numel())
    out["layer_norm"] = {
        "shape": "x [8192,1600] bf16",
        "ms": time_ms(torch, lambda: ln.layer_norm_cuda(x, g, b, 1e-5)),
        "plain_ms": time_ms(torch, lambda: ln.layer_norm_plain(x, g, b, 1e-5),
                            samples=10),
        "library_ms": time_ms(torch, lambda: F_.layer_norm(x, (GD,), g, b, 1e-5)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["layer_norm"]}
    # the call at the serving path's rows (decode 8, a prefill chunk 64)
    # beside F.layer_norm there, the host's stages of the call at 8 rows,
    # and each path shape's device time alone and from a graph
    r = out["layer_norm"]
    for pre, rows in (("decode_rows_", GB), ("prefill_rows_", 64)):
        xs = x[:rows].contiguous()
        r[pre + "ms"] = time_ms(torch, lambda: ln.layer_norm_cuda(xs, g, b, 1e-5))
        r["library_" + pre + "ms"] = time_ms(
            torch, lambda: F_.layer_norm(xs, (GD,), g, b, 1e-5))
        print(f"time layer_norm x[{rows},{GD}] bf16: layer_norm_cuda {r[pre + 'ms']:.5f} "
              f"ms, F.layer_norm {r['library_' + pre + 'ms']:.5f} ms")
        if rows == GB:
            r["host_us"] = norm_host_path(torch, "layer_norm", xs, g, b)
    del xs
    r["fwd_shapes"] = norm_fwd_times(torch, dev, "layer_norm")
    # the backward at gpt2-xl's and bloom-1b7's training rows: the call under
    # CUDA events, its two launches' device time under the profiler, the
    # host's time a call, beside the plain version, F.layer_norm's autograd
    # backward and the bound
    for pre, n in (("", GD), ("bloom_", 2048)):
        if n != GD:
            x, g, b, dy = _ln_inputs(torch, dev, gen, bf, (GB * GS, n))
        lib = [t.detach().clone().requires_grad_() for t in (x, g, b)]
        lib_y = F_.layer_norm(lib[0], (n,), lib[1], lib[2], 1e-5)
        b_ms, b_by = bound_ms((3 * x.numel() + 3 * n) * 2, 14 * x.numel())

        def call():
            return ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
        split = kernel_split(torch, call, ("layer_norm_bwd_", "layer_norm_dgb_sum_kernel"),
                             f"layer_norm_bwd x [{GB * GS},{n}]", calls=50)
        row = {"shape": f"x, dy [{GB * GS},{n}] bf16 (two launches)",
               "ms": time_ms(torch, call),
               "plain_ms": time_ms(torch, lambda: ln.layer_norm_bwd_plain(x, g, dy, 1e-5),
                                   samples=10),
               "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                   lib_y, lib, dy, retain_graph=True)),
               "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": errs["layer_norm_bwd" + ("_bloom" if pre else "")],
               "device_us": sum(split.values()), "device_us_split": split,
               "host_us": host_us(torch, call, calls=1000)}
        if pre:
            out["layer_norm_bwd"].update({pre + k: v for k, v in row.items()})
        else:
            out["layer_norm_bwd"] = row
        print(f"time layer_norm_bwd bf16 [{GB * GS}, {n}]: device {row['device_us']:.2f} "
              f"us a call ({', '.join(f'{k} {v:.2f}' for k, v in split.items())}), bound "
              f"{b_ms * 1e3:.3f} us ({100 * b_ms * 1e3 / row['device_us']:.1f} % of it), "
              f"call {row['ms']:.5f} ms, host {row['host_us']:.3f} us a call, plain "
              f"{row['plain_ms']:.5f} ms, F.layer_norm backward {row['library_ms']:.5f} ms")
        del x, dy, lib, lib_y

    # softmax: scale 1 so that torch.softmax computes the same function
    x = _randn(torch, (GSB, GH, GS, GS), gen, dev, 0.5).to(bf)
    causal = torch.ones(GS, GS, dtype=torch.bool, device=dev).tril()
    b_ms, b_by = bound_ms(2 * x.numel() * 2, 5 * x.numel())
    bm_ms, _ = bound_ms(2 * x.numel() * 2 + causal.numel(), 5 * x.numel())
    out["scaled_masked_softmax"] = {
        "shape": "x [4,25,1024,1024] bf16, no mask (masked: a causal "
                 "[1024,1024] bool mask)",
        "ms": time_ms(torch, lambda: sm.scaled_masked_softmax_triton(x),
                      samples=20, inner=10),
        "plain_ms": time_ms(torch, lambda: sm.scaled_masked_softmax_plain(x),
                            samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lambda: torch.softmax(x, -1), samples=20,
                              inner=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "masked_ms": time_ms(torch, lambda: sm.scaled_masked_softmax_triton(
            x, causal), samples=20, inner=10),
        "masked_plain_ms": time_ms(
            torch, lambda: sm.scaled_masked_softmax_plain(x, causal),
            samples=5, inner=3, warmup=2),
        "masked_bound_ms": bm_ms,
        "max_abs_err": errs["scaled_masked_softmax"]}
    del x

    x = _randn(torch, (GB * GS, GF), gen, dev, 3).to(bf)
    b = _randn(torch, (GF,), gen, dev).to(bf)
    b_ms, b_by = bound_ms((2 * x.numel() + GF) * 2, 12 * x.numel())
    out["bias_act"] = {
        "shape": "x [8192,6400] bf16, gelu",
        "ms": time_ms(torch, lambda: sm.bias_act_triton(x, b, "gelu"),
                      samples=20, inner=10),
        "plain_ms": time_ms(torch, lambda: sm.bias_act_plain(x, b, "gelu"),
                            samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lambda: F_.gelu(x + b, approximate="tanh"),
                              samples=20, inner=10),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["bias_act"]}
    del x
    torch.cuda.empty_cache()
    return out


def time_flash_gpt2_shape(torch, dev, gen):
    """Flash attention fwd and bwd at gpt2-xl's shape, bf16, beside SDPA and
    the bound (the kernels' own table rows are timed at llama-1b4's)."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    bf = torch.bfloat16
    q, k, v, do = (_randn(torch, (GB, GH, GS, GDH), gen, dev).to(bf)
                   for _ in range(4))
    scale = GDH ** -0.5
    fwd_flops = 4 * (GB * GH * GS * (GS + 1) // 2) * GDH
    o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
    lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F_.scaled_dot_product_attention(*lib, is_causal=True)
    out = {
        "shape": "q, k, v [8,25,1024,64] bf16, causal",
        "fwd_ms": time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale),
                          samples=20, inner=10),
        "fwd_library_ms": time_ms(
            torch, lambda: F_.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
            samples=20, inner=10),
        "fwd_bound_ms": bound_ms(4 * q.numel() * 2 + GB * GH * GS * 4,
                                 fwd_flops, BF16_FLOPS_PER_S)[0],
        "fwd_device_us_split": flash_split(
            torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale), "fwd",
            "[8,25,1024,64]"),
        "bwd_ms": time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, True, scale), samples=20, inner=5),
        "bwd_library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib, do, retain_graph=True), samples=20, inner=5),
        "bwd_bound_ms": bound_ms(8 * q.numel() * 2 + GB * GH * GS * 4,
                                 2.5 * fwd_flops, BF16_FLOPS_PER_S)[0],
        "bwd_device_us_split": flash_split(
            torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True,
                                                  scale), "bwd", "[8,25,1024,64]")}
    del q, k, v, do, o, lse, lib, lib_out
    torch.cuda.empty_cache()
    return out


def time_head_gemms(torch, dev, gen):
    """What gpt2's odd vocabulary costs: the three GEMMs of one 2048-row
    chunk of the tied head and blockwise CE (logits = x @ tok^T, dx =
    dlogits @ tok, dtok = dlogits^T @ x) in bf16 at V = 50257, whose
    [rows, V] operands have an unaligned leading dimension, beside the same
    at V = 50304 (a multiple of 64, llama-1b4's).  The port does not pad:
    the width is the model's."""
    bf = torch.bfloat16
    x = _randn(torch, (2048, GD), gen, dev).to(bf)
    out = {}
    for V in (50257, 50304):
        tok = _randn(torch, (V, GD), gen, dev, 0.02).to(bf)
        dl = _randn(torch, (2048, V), gen, dev).to(bf)
        out[V] = (time_ms(torch, lambda: x @ tok.t(), samples=10, inner=5),
                  time_ms(torch, lambda: dl @ tok, samples=10, inner=5),
                  time_ms(torch, lambda: dl.t() @ x, samples=10, inner=5))
        del tok, dl
    # a step: gas 2 x 4 chunks, the logits computed in the forward and again
    # in the backward (the chunk is checkpointed)
    per_step = {V: 8 * (2 * f + d + w) for V, (f, d, w) in out.items()}
    print("head GEMMs, one [2048, 1600] chunk against the tied [V, 1600] "
          "embedding, bf16: " + "; ".join(
              f"V={V}: logits {f:.3f} ms, dx {d:.3f} ms, dtok {w:.3f} ms "
              f"({per_step[V]:.1f} ms a 16384-token step)"
              for V, (f, d, w) in out.items())
          + f"; the odd width costs {per_step[50257] - per_step[50304]:.1f} ms "
            f"a step")
    torch.cuda.empty_cache()


def phase_kernels(torch, dev):
    print(f"kernels: timings take the median of {TIME_SAMPLES} samples of 20 calls "
          "(50 before the comm_quant phase joined: cut for the 600 s aim)")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = check_old_kernels(torch, dev, gen)
    print(f"kernels vs plain: fp32 within 1e-5, bf16 within 2e-2, fp16 within "
          f"2.5e-3; max abs err rms_norm bf16 {errs['rms_norm']:.3g} / fp16 "
          f"{errs['rms_norm_f16']:.3g}, rope {errs['rope']:.3g} / "
          f"{errs['rope_f16']:.3g}")
    errs.update(check_decode_kernels(torch, dev, gen, "llama3-8b"))
    gpt2_decode = check_decode_kernels(torch, dev, gen, "gpt2-xl")
    errs.update(check_train_kernels(torch, dev, gen))
    errs.update(check_alibi_flash(torch, dev, gen))
    overflow_inf = check_flash_overflow(torch, dev)
    errs.update(check_gpt2_kernels(torch, dev, gen))
    errs.update(check_optimizer_kernels(torch, dev, gen))
    errs["flash_decode_contig"] = check_contig_decode(torch, dev, gen)
    errs.update(check_int8_gemvs(torch, dev, gen))
    errs.update(check_dropout(torch, dev))
    out = time_old_kernels(torch, dev, gen, errs)
    out.update(time_decode_kernels(torch, dev, gen, errs))
    out.update(time_train_kernels(torch, dev, gen, errs))
    out.update(time_alibi_flash(torch, dev, gen, errs))
    out.update(time_gpt2_kernels(torch, dev, gen, errs))
    out.update(time_optimizer_kernels(torch, dev, gen, errs))
    out.update(time_generate_kernels(torch, dev, gen, errs))
    out.update(time_dropout(torch, dev, errs))
    out["rms_norm"]["max_abs_err_train_shape"] = errs["rms_norm_train"]
    out["rope"]["max_abs_err_train_shape"] = errs["rope_train"]
    # fp16 max abs errors of the kernels the fp16 path shares with bf16
    for name in ("rms_norm", "rope"):
        out[name]["max_abs_err_f16"] = errs[name + "_f16"]
        out[name]["max_abs_err_train_shape_f16"] = errs[name + "_train_f16"]
    for name in ("rms_norm_bwd", "layer_norm", "layer_norm_bwd"):
        out[name]["max_abs_err_f16"] = errs[name + "_f16"]
    out["rms_norm_bwd"]["wide_max_abs_err_f16"] = errs["rms_norm_bwd_wide_f16"]
    out["flash_attention_bwd_f16"]["overflow_inf_dv"] = overflow_inf[False]
    out["flash_attention_bwd_f16_alibi"]["overflow_inf_dv"] = overflow_inf[True]
    for name, e in gpt2_decode.items():
        out[name]["max_abs_err_gpt2_shape"] = e
    out["fused_adam"]["max_abs_err_gpt2_shape"] = errs["fused_adam_gpt2"]
    for name, r in out.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        mm = (f", torch.matmul yardstick {r['matmul_ms']:.5f} ms"
              if "matmul_ms" in r else "")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {lib} ms{mm}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    gpt2_flash = time_flash_gpt2_shape(torch, dev, gen)
    out["flash_attention_fwd"]["gpt2_shape"] = gpt2_flash
    out["flash_attention_bwd"]["gpt2_shape"] = gpt2_flash
    print("time flash attention {shape}: fwd kernel {fwd_ms:.5f} ms, SDPA "
          "{fwd_library_ms:.5f} ms, bound {fwd_bound_ms:.6f} ms; bwd kernel "
          "{bwd_ms:.5f} ms, SDPA bwd {bwd_library_ms:.5f} ms, bound "
          "{bwd_bound_ms:.6f} ms".format(**gpt2_flash))
    time_head_gemms(torch, dev, gen)
    return out



# dropout at llama-1b4's training activations [micro, S, D], the rate the
# dropout_train cell runs
DROPOUT_SHAPE = (4, 2048, 2048)
DROPOUT_RATE = 0.1
# no TPU kernel: the JAX package's dropout is plain jnp, fused by XLA
DROPOUT_SITE = "deepspeed_tpu/models/transformer.py:704"
# SASS opcodes of 32-bit integer work, counted for the dropout kernel's
# bound: IMAD issues to the FMA pipe, the rest to the integer (ALU) pipe;
# the two run side by side, each at 64 lanes an SM a cycle on Hopper
INT_OPCODES = {"IADD3", "IMAD", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT",
               "IMNMX", "IADD", "LOP", "SHL", "SHR", "IABS", "VIMNMX", "ISCADD"}


def dropout_int_ops():
    """32-bit integer operations an element of the bf16 dropout kernel, from
    its SASS: the integer instructions of ``dropout_kernel<__nv_bfloat16,
    8>`` (its rolled loop's body of 8 unrolled hashes, the one-element tail
    and the prologue) over the 9 elements those hashes serve.  Returns
    (ALU-pipe ops an element, IMAD ops an element, {opcode: count})."""
    import os

    from deepspeed_tpu_torch.ops.kernels import build

    lib = build.load_library("dropout")
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-400:]}")
    for body in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        fname = body.split("\n", 1)[0]
        if "dropout_kernel" not in fname or "bfloat16" not in fname or "Li8E" not in fname:
            continue
        hist = {}
        for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)",
                             body):
            hist[op] = hist.get(op, 0) + 1
        n_int = sum(c for op, c in hist.items() if op in INT_OPCODES)
        check(n_int > 20 * 3 * 9, f"dropout SASS: {n_int} integer instructions "
              f"for 9 hashes: {hist}")
        imad = hist.get("IMAD", 0)
        return (n_int - imad) / 9, imad / 9, hist
    raise RuntimeError("chip_smoke: dropout_kernel<bf16, 8> not in the SASS")


def check_dropout(torch, dev):
    """The dropout kernel against its plain version, bit for bit, forward
    and backward, in fp32, bf16 and fp16, at llama-1b4's training shape and
    at shapes with a tail past the last 16-byte vector, at rates 0.1 and
    0.5; the kept share at the training shape within 6 binomial standard
    deviations of 1 - rate."""
    from deepspeed_tpu_torch.ops.kernels import dropout as kd
    from deepspeed_tpu_torch.utils import prng

    gen = torch.Generator(device=dev).manual_seed(11)
    shares = {}
    for name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, name)
        for shape in (DROPOUT_SHAPE, (1000003,), (3, 5, 7, 9)):
            x = _randn(torch, shape, gen, dev, 3.0).to(dt)
            for rate in (DROPOUT_RATE, 0.5):
                key = prng.prng_key(len(shape) * 1000 + int(rate * 10))
                y = kd.dropout_cuda(x, key, rate)
                dx = kd.dropout_bwd_cuda(x, key, rate)
                want = kd.dropout_plain(x, key, rate)
                check(torch.equal(y, want) and torch.equal(dx, want),
                      f"dropout {name} {shape} rate {rate}: kernel != plain")
                if shape == DROPOUT_SHAPE:
                    n, p = x.numel(), 1.0 - rate
                    kept = float((want != 0).sum()) / n
                    check(abs(kept - p) <= 6 * (p * (1 - p) / n) ** 0.5,
                          f"dropout keeps {kept} of {shape} at rate {rate}")
                    shares[(name, rate)] = kept
            del x
    torch.cuda.empty_cache()
    print("kernels vs plain: dropout forward and backward bit-equal in fp32, "
          f"bf16 and fp16 at {list(DROPOUT_SHAPE)}, [1000003], [3, 5, 7, 9], "
          f"rates {DROPOUT_RATE} and 0.5; kept share at the training shape "
          + ", ".join(f"{k[0]} {k[1]}: {v:.6f}" for k, v in shares.items()))
    return {"dropout": 0.0, "dropout_bwd": 0.0}


def time_dropout(torch, dev, errs):
    """The dropout kernel at DROPOUT_SHAPE bf16, forward and backward (the
    same kernel on dy): call ms under CUDA events, device us a launch under
    the profiler, the plain version, ``F.dropout`` as a yardstick (Philox
    bits: another function, so no library_ms), and the bound: the largest
    of x read and y written once over the HBM rate, the SASS's integer
    operations an element on the ALU pipe over the INT32 rate, and its
    IMADs, which issue to the FMA pipe beside them, over the same rate."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.kernels import dropout as kd
    from deepspeed_tpu_torch.utils import prng

    gen = torch.Generator(device=dev).manual_seed(12)
    x = _randn(torch, DROPOUT_SHAPE, gen, dev).to(torch.bfloat16)
    key = prng.prng_key(2024)
    n = x.numel()
    alu_el, imad_el, hist = dropout_int_ops()
    ops_el = alu_el + imad_el
    b_ms, b_by = bound_ms(2 * 2 * n, max(alu_el, imad_el) * n,
                          peak=INT32_OPS_PER_S)
    out = {}
    for name, fn in (("dropout", kd.dropout_cuda), ("dropout_bwd", kd.dropout_bwd_cuda)):
        dev_us, kernels = device_us_a_call(
            torch, lambda: fn(x, key, DROPOUT_RATE), name, calls=50)
        out[name] = {
            "shape": f"bf16 {list(DROPOUT_SHAPE)}, rate {DROPOUT_RATE}",
            "ms": time_ms(torch, lambda: fn(x, key, DROPOUT_RATE),
                          samples=20, inner=10),
            "plain_ms": time_ms(torch, lambda: kd.dropout_plain(x, key, DROPOUT_RATE),
                                samples=3, inner=1, warmup=1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": errs[name], "device_us": dev_us,
            "int_ops_an_element": {"alu": alu_el, "imad": imad_el},
            "f_dropout_ms": time_ms(torch, lambda: F.dropout(x, DROPOUT_RATE),
                                    samples=20, inner=10)}
    r = out["dropout"]
    print(f"time dropout bf16 {list(DROPOUT_SHAPE)}: forward {r['device_us']:.2f} "
          f"us a launch on the device ({r['ms']:.5f} ms a call), backward "
          f"{out['dropout_bwd']['device_us']:.2f} us; bound {1e3 * b_ms:.2f} us "
          f"({b_by}: {4 * n / 1e6:.1f} MB at 3.35 TB/s is "
          f"{4 * n / HBM_BYTES_PER_S * 1e6:.2f} us; of the SASS's {ops_el:.2f} "
          f"integer operations an element, {alu_el:.2f} on the ALU pipe at "
          f"{INT32_OPS_PER_S / 1e12:.2f} TOP/s is "
          f"{alu_el * n / INT32_OPS_PER_S * 1e6:.2f} us, {imad_el:.2f} IMADs on "
          f"the FMA pipe {imad_el * n / INT32_OPS_PER_S * 1e6:.2f} us), "
          f"{100 * 1e3 * b_ms / r['device_us']:.1f} % of it; plain "
          f"{r['plain_ms']:.3f} ms; F.dropout (Philox bits, another function) "
          f"{r['f_dropout_ms']:.5f} ms; SASS {sorted(hist.items())}")
    del x
    torch.cuda.empty_cache()
    return out


def check_offload_grads(torch, dev, layers=4):
    """``offload_dots`` (the matmul outputs through pinned host memory) at
    llama-1b4's full width and its training batch, cut to ``layers`` so
    that the run without remat fits beside it: loss and every gradient
    bit-equal to no remat, in bf16, with dropout on."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import prng

    model = deepspeed_tpu_torch.causal_lm("llama-1b4", seed=0, num_layers=layers,
                                          dtype=torch.bfloat16, dropout=DROPOUT_RATE)
    micro, S = TRAIN_CELLS["llama-1b4"]
    gen = torch.Generator(device=dev).manual_seed(3)
    tok = torch.randint(0, model.config.vocab_size, (micro, S), device=dev,
                        generator=gen)
    out = {}
    for remat, policy in ((False, "full"), (True, "offload_dots")):
        model.config.remat, model.config.remat_policy = remat, policy
        leaves = []

        def copy(t):
            if isinstance(t, dict):
                return {k: copy(v) for k, v in t.items()}
            leaves.append(t.detach().clone().requires_grad_())
            return leaves[-1]
        params = copy(model.params())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        loss = model.apply(params, tok, tok, rngs=prng.prng_key(5))
        loss.backward()
        torch.cuda.synchronize()
        out[policy if remat else "none"] = (
            loss.detach(), [p.grad for p in leaves], time.perf_counter() - t,
            torch.cuda.max_memory_allocated(dev) / 2**30)
        del params, loss
    (l0, g0, t0, m0), (l1, g1, t1, m1) = out["none"], out["offload_dots"]
    check(torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1)),
          "offload_dots: loss or gradients differ from no remat")
    print(f"offload_dots check: llama-1b4 D 2048 cut to {layers} layers, bf16, "
          f"dropout {DROPOUT_RATE}, [{micro}, {S}] tokens: loss and all "
          f"{len(g0)} gradients bit-equal to no remat; forward+backward "
          f"{t1:.3f}s against {t0:.3f}s, peak {m1:.2f} against {m0:.2f} GiB")
    del model, out
    torch.cuda.empty_cache()


# this slice's optimizers at llama-1b4's full width, depth cut to fit the
# smoke's time: (config type, params)
NEW_OPTIMIZERS = {"Lion": {"lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.1},
                  "Adagrad": {"lr": 1e-2},
                  "SGD": {"lr": 1e-1, "momentum": 0.9, "nesterov": True},
                  "Muon": {"lr": 2e-2, "weight_decay": 0.1}}
OPTIMIZER_LEG_LAYERS = 4


def optimizer_section(opt):
    """The config section of one of NEW_OPTIMIZERS: the optimizer, and
    TRAIN_CONFIG's WarmupLR up to its own learning rate."""
    params = NEW_OPTIMIZERS[opt]
    return {"optimizer": {"type": opt, "params": params},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_max_lr": params["lr"], "warmup_num_steps": 2}}}


def phase_optimizer_legs(torch, dev, peaks, medians):
    """Each of this slice's optimizers (plain foreach torch, no kernel)
    trains llama-1b4 at full width, cut to OPTIMIZER_LEG_LAYERS layers, 3
    steps: step time and optimizer state bytes, beside FusedAdam at the
    same depth."""
    legs = {"adam_l4_train": phase_train(
        torch, dev, "llama-1b4", "adam_l4_train", None, peaks, medians,
        model_over={"num_layers": OPTIMIZER_LEG_LAYERS}, steps_wanted=3,
        profile=False)}
    for opt in NEW_OPTIMIZERS:
        legs[opt] = phase_train(
            torch, dev, "llama-1b4", f"{opt.lower()}_train",
            optimizer_section(opt), peaks, medians,
            model_over={"num_layers": OPTIMIZER_LEG_LAYERS}, steps_wanted=3,
            profile=False)
    return legs


# small fp32 models of the two families for the card-against-CPU phases
SMALL = {
    "llama-tiny": dict(num_layers=2, hidden_size=256, intermediate_size=512,
                       num_heads=8, num_kv_heads=2, vocab_size=1024),
    # learned positions, LayerNorm, GeLU, a plain MLP, heads of 64
    "gpt2-small": dict(num_layers=2, hidden_size=256, intermediate_size=1024,
                       num_heads=4, vocab_size=1024, max_seq_len=512),
    # 8 experts, top-2, as the preset
    "mixtral-tiny": dict(num_layers=2, hidden_size=256, intermediate_size=512,
                         num_heads=8, num_kv_heads=2, vocab_size=1024)}


def small_model(torch, preset):
    """The small fp32 reference model of ``preset`` on the CPU, its
    embedding widened so greedy picks sit far from ties (through gpt2's
    tied head a wide token table alone makes each step repeat its input,
    so the position table is widened further)."""
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm(preset, device="cpu", **SMALL[preset])
    with torch.no_grad():
        if model.config.position == "learned":
            model.embed.tok.mul_(16.0)
            model.embed.pos.mul_(80.0)
        else:
            model.embed.tok.mul_(40.0)
    return model


def serve_card_and_cpu(torch, dev, model, cfg, waves, what, **kw):
    """The same waves of (prompt, new tokens) through ``init_serving`` on
    the CPU and on the card: each request's tokens and prefix hits, equal
    on both, returned from the card's run, with the card engine's decode
    path (fused) and layout (paged)."""
    import deepspeed_tpu_torch

    outs = []
    for d in ("cpu", dev):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=d, **kw)
        path = (serve.engine._dparams is not None, serve.paged)
        got = []
        for wave in waves:
            reqs = [serve.submit(p, max_new_tokens=n) for p, n in wave]
            serve.run()
            got += [(r.output_tokens, r.prefix_hit_tokens) for r in reqs]
        if serve.pool is not None:
            serve.pool.check_no_leak()
        outs.append(got)
        serve.close()
    check(outs[0] == outs[1], f"{what}: card vs CPU tokens differ: {outs}")
    check(all(r[0] for r in outs[1]), f"{what}: a request gave no tokens")
    return outs[1], path


def generate_card_and_cpu(torch, dev, model, cfg, batch, what, new=16):
    """``init_inference(model, cfg).generate(batch)`` on the CPU and on
    the card, token-identical; returns the card's output and its engine's
    ``_dparams is not None`` (the fused path)."""
    import deepspeed_tpu_torch

    outs, fused = [], []
    for d in ("cpu", dev):
        eng = deepspeed_tpu_torch.init_inference(model, cfg, device=d)
        fused.append(eng._dparams is not None)
        outs.append(eng.generate(batch, max_new_tokens=new).cpu())
        del eng
    check(torch.equal(outs[0], outs[1]), f"{what}: card vs CPU tokens "
          f"differ: {outs}")
    return outs[1], fused[1]


def phase_reference(torch, dev, preset):
    """The port on the card against the port on the CPU, small fp32 model,
    on the default fused decode path and on the unfused one, over the paged
    and the fixed-slot layout."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 matmuls
    model = small_model(torch, preset)
    prompts = [np.random.default_rng(i).integers(0, 1024, n)
               for i, n in enumerate((70, 9, 130))]
    for paged, fused in ((True, True), (True, False), (False, True),
                         (False, False)):
        cfg = {"dtype": "float32", "max_out_tokens": 512,
               "kv_page_tokens": 64, "paged_kv_cache": paged}
        if not fused:
            cfg["use_fused_decode"] = False
        layout = "paged" if paged else "fixed-slot"
        got, path = serve_card_and_cpu(torch, dev, model, cfg,
                                       [[(p, 16) for p in prompts]],
                                       f"{layout} fused={fused}", num_slots=2,
                                       prefill_chunk=32)
        check(path == (fused, paged), f"{layout} fused={fused}: wrong path")
        print(f"reference: small fp32 {preset} model, {layout} layout, "
              f"{'fused' if fused else 'unfused'} decode, card == CPU on "
              f"{len(prompts)} requests x 16 tokens "
              f"({len({t for o, _ in got for t in o})} distinct)")
    # generate(): the contiguous cache; fp32 fused and unfused, and int8
    # weights (bf16 activations) on the fused path
    batch = np.stack([np.random.default_rng(10 + i).integers(0, 1024, 70)
                      for i in range(3)])
    for dtype, fused in (("float32", True), ("float32", False),
                         ("int8", True)):
        cfg = {"dtype": dtype, "max_out_tokens": 512}
        if not fused:
            cfg["use_fused_decode"] = False
        out, path = generate_card_and_cpu(torch, dev, model, cfg, batch,
                                          f"generate {dtype} fused={fused}")
        check(path is fused, f"generate {dtype} fused={fused}: wrong decode "
              f"path")
        print(f"reference: small {preset} model, generate() {dtype}"
              f"{' weights' if dtype == 'int8' else ''}, "
              f"{'fused' if fused else 'unfused'} decode, card == CPU on "
              f"{len(batch)} rows x 16 tokens "
              f"({len(set(out[:, 70:].reshape(-1).tolist()))} distinct)")


def phase_reference_kv_int8(torch, dev):
    """The int8 KV cache, card against CPU on the small fp32 llama: paged
    serving where a second wave repeats a prompt (a prefix-cache hit: the
    scale planes gathered, scattered and copied with the codes),
    fixed-slot serving, and ``generate()``; all on the unfused loop."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    model = small_model(torch, "llama-tiny")
    prompts = [np.random.default_rng(20 + i).integers(0, 1024, n)
               for i, n in enumerate((70, 9, 130))]
    waves = [[(p, 16) for p in prompts], [(prompts[2], 16)]]
    for paged in (True, False):
        cfg = {"dtype": "float32", "max_out_tokens": 512, "kv_page_tokens": 64,
               "paged_kv_cache": paged, "quantize_kv_cache": True}
        got, path = serve_card_and_cpu(torch, dev, model, cfg, waves,
                                       f"int8 KV paged={paged}", num_slots=2,
                                       prefill_chunk=32)
        check(path == (False, paged), f"int8 KV paged={paged}: wrong path")
        hit = got[-1][1]
        check((hit > 0) is paged, f"int8 KV paged={paged}: prefix hit {hit}")
        layout = f"paged (repeat: prefix hit {hit})" if paged else "fixed-slot"
        print(f"reference: small fp32 llama-tiny, int8 KV cache, {layout}, "
              f"card == CPU on {len(got)} requests x 16 tokens")
    batch = np.stack([np.random.default_rng(30 + i).integers(0, 1024, 70)
                      for i in range(3)])
    out, fused = generate_card_and_cpu(
        torch, dev, model, {"dtype": "float32", "max_out_tokens": 512,
                            "quantize_kv_cache": True}, batch,
        "generate int8 KV")
    check(not fused, "generate int8 KV: took the fused path")
    print(f"reference: small fp32 llama-tiny, int8 KV cache, generate() "
          f"unfused, card == CPU on {len(batch)} rows x 16 tokens "
          f"({len(set(out[:, 70:].reshape(-1).tolist()))} distinct)")


def phase_reference_moe(torch, dev):
    """mixtral-tiny (2 layers, D 256, 8 experts, top-2), fp32, card against
    CPU: paged serving (chunked prefill, a repeat hitting the prefix
    cache) and ``generate()`` token-identical, on the unfused loop (the
    router in fp32, TF32 off)."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    model = small_model(torch, "mixtral-tiny")
    prompts = [np.random.default_rng(40 + i).integers(0, 1024, n)
               for i, n in enumerate((70, 9, 130))]
    cfg = {"dtype": "float32", "max_out_tokens": 512, "kv_page_tokens": 64}
    got, path = serve_card_and_cpu(
        torch, dev, model, cfg, [[(p, 16) for p in prompts], [(prompts[0], 16)]],
        "mixtral-tiny serving", num_slots=2, prefill_chunk=32)
    check(path == (False, True), "mixtral-tiny serving: wrong path")
    batch = np.stack([np.random.default_rng(50 + i).integers(0, 1024, 70)
                      for i in range(3)])
    out, fused = generate_card_and_cpu(torch, dev, model, cfg, batch,
                                       "mixtral-tiny generate")
    check(not fused, "mixtral-tiny: took the fused path")
    print(f"reference: small fp32 mixtral-tiny (8 experts, top-2), serving "
          f"{len(got)} requests x 16 tokens (repeat: prefix hit {got[-1][1]}) "
          f"and generate() {len(batch)} rows x 16 tokens, card == CPU "
          f"({len(set(out[:, 70:].reshape(-1).tolist()))} distinct)")


KERNELS = ("rms_norm", "rope", "fused_norm_qkv", "flash_decode",
           "fused_proj_norm", "fused_mlp", "rms_norm_bwd",
           "flash_attention_fwd", "flash_attention_bwd", "fused_adam",
           "layer_norm", "layer_norm_bwd", "scaled_masked_softmax", "bias_act",
           "quantize", "fused_adam8bit", "fused_lamb_phase1", "fused_lamb_scale",
           "flash_decode_contig", "fused_norm_qkv_int8", "fused_proj_norm_int8",
           "fused_mlp_int8", "flash_attention_fwd_alibi",
           "flash_attention_bwd_alibi", "flash_attention_fwd_f16",
           "flash_attention_bwd_f16", "flash_attention_fwd_f16_alibi",
           "flash_attention_bwd_f16_alibi", "fused_adam_f16", "dropout",
           "dropout_bwd", "quantize_blockwise", "dequantize_blockwise")


def launch_counters():
    from deepspeed_tpu_torch.ops.kernels import (apply_rotary_pos_emb, bias_act,
                                                 fused_adam8bit_update,
                                                 fused_adam_update, lamb_phase1,
                                                 lamb_scale, layer_norm_bwd,
                                                 quantize, rms_norm,
                                                 rms_norm_bwd,
                                                 scaled_masked_softmax)
    from deepspeed_tpu_torch.ops.kernels import comm_quant as cq
    from deepspeed_tpu_torch.ops.kernels import decode as dk
    from deepspeed_tpu_torch.ops.kernels import dropout as drop
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam
    from deepspeed_tpu_torch.ops.kernels.layer_norm import layer_norm

    return {"rms_norm": rms_norm, "rope": apply_rotary_pos_emb,
            "fused_norm_qkv": dk.fused_norm_qkv,
            "flash_decode": dk.flash_decode,
            "fused_proj_norm": dk.fused_proj_norm, "fused_mlp": dk.fused_mlp,
            "rms_norm_bwd": rms_norm_bwd,
            "flash_attention_fwd": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "fused_adam": fused_adam_update, "layer_norm": layer_norm,
            "layer_norm_bwd": layer_norm_bwd,
            "scaled_masked_softmax": scaled_masked_softmax,
            "bias_act": bias_act, "quantize": quantize,
            "fused_adam8bit": fused_adam8bit_update,
            "fused_lamb_phase1": lamb_phase1, "fused_lamb_scale": lamb_scale,
            "flash_decode_contig": dk.flash_decode_contig_cuda,
            "fused_norm_qkv_int8": dk.fused_norm_qkv_int8_cuda,
            "fused_proj_norm_int8": dk.fused_proj_norm_int8_cuda,
            "fused_mlp_int8": dk.fused_mlp_int8_cuda,
            "flash_attention_fwd_alibi": fa.flash_fwd_alibi_cuda,
            "flash_attention_bwd_alibi": fa.flash_attention_bwd_alibi,
            "flash_attention_fwd_f16": fa.flash_fwd_f16_cuda,
            "flash_attention_bwd_f16": fa.flash_attention_bwd_f16,
            "flash_attention_fwd_f16_alibi": fa.flash_fwd_f16_alibi_cuda,
            "flash_attention_bwd_f16_alibi": fa.flash_attention_bwd_f16_alibi,
            "fused_adam_f16": adam.fused_adam_update_f16_cuda,
            "dropout": drop.dropout, "dropout_bwd": drop.dropout_bwd,
            "quantize_blockwise": cq.quantize_blockwise,
            "dequantize_blockwise": cq.dequantize_blockwise}


def zero_counts():
    for fn in launch_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in launch_counters().items()}


def norm_kernel(cfg):
    return "layer_norm" if cfg.norm == "layernorm" else "rms_norm"


def launch_plan(cfg, chunks, steps, fused, contig=False):
    """Launches a run must make: per prefill chunk 2L+1 norms (RMSNorm or
    LayerNorm, as the model has it) and, for a RoPE model, L RoPEs (q and k
    in one launch); per decode step either 4 fused calls per layer and the
    final norm (fused) or 2L+1 norms (unfused: the int8 KV cache and the
    MoE MLP decode there), and for a RoPE model L RoPEs.  ``contig``: the
    fixed-slot layout, whose fused attention is the contiguous-cache
    flash_decode."""
    L = cfg.num_layers
    plan = {k: 0 for k in KERNELS}
    if cfg.position == "rope":
        plan["rope"] = L * (chunks + steps)
    if fused:
        plan[norm_kernel(cfg)] = (2 * L + 1) * chunks + steps
        for k in KERNELS[2:6]:
            plan[k] = L * steps
        if contig:
            plan["flash_decode_contig"], plan["flash_decode"] = \
                plan["flash_decode"], 0
    else:
        plan[norm_kernel(cfg)] = (2 * L + 1) * (chunks + steps)
    return plan


def add_plans(*plans):
    return {k: sum(p[k] for p in plans) for k in KERNELS}


def phase_ops(torch, dev):
    """The ops of the public kernel library that no model path calls,
    driven through the library's wrappers: at gpt2-xl's shapes (bf16) the
    scores of one layer over 4 sequences through ``scaled_masked_softmax``
    with a causal mask and the MLP's pre-activation through ``bias_act``;
    the [24, 2048, 5632] fp32 MLP leaf of llama-1b4 through ``quantize`` ->
    ``dequantize`` at 8 and 4 bits, the 4-bit codes through ``pack_int4``
    -> ``unpack_int4``; and the fp16 instances that no train path runs:
    bloom-1b7's attention [4, 16, 2048, 128] in fp16 through
    ``flash_attention(..., alibi=True)`` forward and backward (autograd),
    and an fp16 [2048, 5632] leaf through ``fused_adam_update`` three steps.
    The launch counts are read over these calls, and each result is held to
    the op's plain version (TOL, and SOFTMAX_RTOL on each probability; the
    quantizer's codes and scales equal; ATTN_TOL, O_REL_TOL and GRAD_TOL;
    the fp16 Adam leaf as :func:`_check_adam_f16_step` holds it), the round
    trip to half a code step."""
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam
    from deepspeed_tpu_torch.ops.kernels import quantizer as kq
    from deepspeed_tpu_torch.ops.kernels import softmax as sm

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    scores = _randn(torch, (GSB, GH, GS, GS), gen, dev, 4).to(bf)
    causal = torch.ones(GS, GS, dtype=torch.bool, device=dev).tril()
    up = _randn(torch, (GB * GS, GF), gen, dev, 3).to(bf)
    b_up = _randn(torch, (GF,), gen, dev).to(bf)
    w = _randn(torch, (TL, TD, TF), gen, dev, 0.02)
    qkv = [_randn(torch, (TB, TH, TS, TDH), gen, dev).half().requires_grad_()
           for _ in range(3)]
    do = _randn(torch, (TB, TH, TS, TDH), gen, dev).half()
    leaf = _randn(torch, (TD, TF), gen, dev).half()
    m, v = torch.zeros(leaf.shape, device=dev), torch.zeros(leaf.shape, device=dev)
    states = []     # the leaf's (p, m, v) before each step and after the last
    grads = [_randn(torch, (TD, TF), gen, dev).half() for _ in range(3)]
    adam_kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    zero_counts()
    probs = K.scaled_masked_softmax(scores, causal, scale=GDH ** -0.5)
    a = K.bias_act(up, b_up, "gelu")
    o = fa.flash_attention(*qkv, alibi=True)
    o.backward(do)
    for step, g in enumerate(grads, 1):
        states.append((leaf.clone(), m.clone(), v.clone()))
        K.fused_adam_update(leaf, g, m, v, step, lr=1e-2 * step, **adam_kw)
    states.append((leaf, m, v))
    quant = {}
    for bits in (8, 4):
        q, sc, pad = K.quantize(w, bits=bits)
        back = K.dequantize(q, sc, pad, w.shape)
        if bits == 4:
            packed = K.pack_int4(q)
            unpacked = K.unpack_int4(packed, q.numel()).view(q.shape)
        quant[bits] = (q, sc, pad, back)
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict({name: 0 for name in KERNELS}, scaled_masked_softmax=1,
                bias_act=1, quantize=2, flash_attention_fwd_f16_alibi=1,
                flash_attention_bwd_f16_alibi=1, fused_adam_f16=3)
    check(launches == want, f"ops launches {launches} != {want}")
    ref_in = [t.detach().float().requires_grad_() for t in qkv]
    want_o = fa.mha_reference(*ref_in, bias=fa._alibi_ref_bias(qkv[0], qkv[1], True))
    want_o.backward(do.float())
    o, want_o = o.detach(), want_o.detach()
    e_o = _assert_close(torch, o, want_o.half(), ATTN_TOL["float16"],
                        "ops: flash_attention fp16 alibi o")
    rel = [_rel_err(t.grad, r.grad) for t, r in zip(qkv, ref_in)]
    check(_rel_err(o, want_o) < O_REL_TOL["float16"] and max(rel) < GRAD_TOL["float16"],
          f"ops: flash_attention fp16 alibi: o relative {_rel_err(o, want_o)}, "
          f"grads {rel}")
    e_p = e_mv = 0.0
    for step, g in enumerate(grads, 1):
        e_s, e_mv_s, _ = _check_adam_f16_step(
            torch, adam, states[step - 1], states[step], g, step,
            dict(adam_kw, lr=1e-2 * step), "ops: fused_adam fp16")
        e_p, e_mv = max(e_p, e_s), max(e_mv, e_mv_s)
    moved = _check_moved(torch, leaf, states[0][0], "ops: fused_adam fp16")
    print(f"ops: flash_attention fp16 alibi [4, 16, 2048, 128] forward and "
          f"backward through the library's wrapper: o max abs err {e_o:.3g}, "
          f"grads max relative (Frobenius) {max(rel):.3g}; fused_adam_update "
          f"on an fp16 [2048, 5632] leaf x 3 steps: p max abs err {e_p:.3g} "
          f"({moved:.5f} of p moved), m/v {e_mv:.3g}; launches "
          f"{launches['flash_attention_fwd_f16_alibi']}"
          f" / {launches['flash_attention_bwd_f16_alibi']} / "
          f"{launches['fused_adam_f16']}")
    del qkv, do, o, ref_in, want_o, leaf, m, v, states, grads
    for bits, (q, sc, pad, back) in quant.items():
        wq, ws, wpad = kq.quantize_plain(w, bits, 2048)
        check(pad == wpad and torch.equal(q, wq) and torch.equal(sc, ws),
              f"ops: quantize {bits} bits differs from its plain version")
        step = torch.repeat_interleave(sc, 2048)[: w.numel()].view(w.shape)
        # half a code, plus the fp32 rounding of q * scale (up to 127
        # codes x 2^-24 of a code step)
        err = float(((back - w).abs() / step).max())
        check(back.shape == w.shape and err <= 0.5 + 1e-4,
              f"ops: dequantize({bits} bits) is {err} code steps off")
        print(f"ops: quantize -> dequantize {bits} bits, fp32 "
              f"{list(w.shape)} at block 2048: codes and scales equal to the "
              f"plain version's, round trip within {err:.4f} of a code step")
    check(torch.equal(unpacked, quant[4][0]) and packed.numel() * 2 == w.numel(),
          "ops: unpack_int4(pack_int4(q)) != q")
    print(f"ops: pack_int4 -> unpack_int4 of the {w.numel()} 4-bit codes: "
          f"{packed.numel()} bytes, unpacked equal")
    del w, quant, back, packed, unpacked
    plain = sm.scaled_masked_softmax_plain(scores, causal, GDH ** -0.5)
    e_s = _assert_close(torch, probs, plain, TOL["bfloat16"], "ops: softmax")
    check(bool(torch.isclose(probs.float(), plain.float(), atol=1e-6,
                             rtol=SOFTMAX_RTOL["bfloat16"]).all()),
          "ops: softmax: a probability is off by more than one rounding")
    e_a = _assert_close(torch, a, sm.bias_act_plain(up, b_up, "gelu"),
                        TOL["bfloat16"], "ops: bias_act gelu")
    print(f"ops: scaled_masked_softmax [4, 25, 1024, 1024] (causal bool mask "
          f"read by strides) and bias_act gelu [8192, 6400] through the "
          f"library's wrappers: max abs err vs plain {e_s:.3g} / {e_a:.3g}; "
          f"launches softmax {launches['scaled_masked_softmax']}, bias_act "
          f"{launches['bias_act']}, quantize {launches['quantize']}")
    torch.cuda.empty_cache()
    return launches


def timed(torch, spent, name, fn):
    """Wrap an engine phase with synchronizes to attribute device time."""
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
    return wrapper


SERVE_NEWS = (32, 40, 48, 56, 64, 36, 44, 52)


def serve_waves(torch, serve, vocab, repeat_equal=True):
    """The serve phases' traffic: wave 1, 8 greedy requests of SERVE_LENS
    prompt tokens and SERVE_NEWS new; wave 2, an exact repeat of the last
    request and a request sharing 128 tokens with the sixth's prompt.
    Every request must end by length with its count; ``repeat_equal``: the
    repeat must give its cold run's tokens (an MoE model's capacity couples
    a row to the rows beside it, so there it is reported, not required).
    Returns (prompts, wave 1, wave 2, wall seconds)."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n) for n in SERVE_LENS]
    t0 = time.perf_counter()
    wave1 = [serve.submit(p, max_new_tokens=n)
             for p, n in zip(prompts, SERVE_NEWS)]
    serve.run()
    shared = np.concatenate([prompts[5][:128], rng.integers(0, vocab, 60)])
    wave2 = [serve.submit(prompts[7], max_new_tokens=SERVE_NEWS[7]),
             serve.submit(shared, max_new_tokens=48)]
    serve.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for req, n in zip(wave1 + wave2, SERVE_NEWS + (SERVE_NEWS[7], 48)):
        check(req.finish_reason == "length" and len(req.output_tokens) == n,
              f"request {req.request_id}: {req.finish_reason} with "
              f"{len(req.output_tokens)} tokens, want length/{n}")
        check(all(0 <= t < vocab for t in req.output_tokens),
              "token id out of range")
    if repeat_equal:
        check(wave2[0].output_tokens == wave1[7].output_tokens,
              "the exact repeat diverged from its cold run")
    return prompts, wave1, wave2, wall


def token_share(a, b):
    """The share of tokens equal position for position over request pairs."""
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def phase_serve(torch, dev, preset, keep=None):
    """The serving cell of ``preset``: the serve waves on the fused paged
    path, launches equal to the plan, then a profiled wave and the unfused
    path.  ``keep`` (a dict) receives the waves' tokens."""
    import gc

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm(preset, dtype=torch.bfloat16, seed=0)
    cfg = model.config
    L = cfg.num_layers
    # the default config: no use_fused_decode key, so the fused decode path
    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "paged_kv_cache": True,
                       "prefix_caching": True, "max_out_tokens": 1024},
        num_slots=8, prefill_chunk=64)
    torch.cuda.synchronize()
    check(serve.engine._dparams is not None, "the default config did not "
          "build the kernel-injected view")
    print(f"serve: {preset} D={cfg.hidden_size} L={L} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} V={cfg.vocab_size} "
          f"{cfg.norm}, {cfg.position} positions, bf16 random weights (seed 0), "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, "
          f"page {serve.pool.page} x {serve.pool.num_pages - 1}, fused "
          f"decode, built in {time.perf_counter() - t0:.1f}s")

    # phase timers: a synchronize around each prefill chunk and decode block
    # attributes device time to the phase (the smoke run trades the
    # engine's host/device overlap for this attribution)
    spent = {"prefill": 0.0, "decode": 0.0}
    serve._prefill = timed(torch, spent, "prefill", serve._prefill)
    serve._block = timed(torch, spent, "decode", serve._block)

    zero_counts()
    prompts, wave1, wave2, wall = serve_waves(torch, serve, cfg.vocab_size)
    launches = read_counts()
    if keep is not None:
        keep["tokens"] = [r.output_tokens for r in wave1 + wave2]
    hits = [r.prefix_hit_tokens for r in wave2]
    check(sum(hits) > 0, f"wave 2 missed the prefix cache: {hits}")
    serve.pool.check_no_leak()
    serve.prefix_cache.check_no_leak()
    st = serve.stats
    steps = st["decode_blocks"] * serve._K
    plan = launch_plan(cfg, st["prefill_chunks"], steps, fused=True)
    check(launches == plan, f"launches {launches} != path plan {plan}")
    check(all(launches[k] > 0 for k in (norm_kernel(cfg),) + KERNELS[2:6]),
          f"a serving kernel never ran: {launches}")
    print(f"serve: 10 requests in {wall:.2f}s; prefill {st['prefill_tokens']} "
          f"tokens in {st['prefill_chunks']} chunks, "
          f"{st['prefill_tokens'] / spent['prefill']:.1f} tok/s; decode "
          f"{st['decode_tokens']} tokens in {steps} steps of {serve.num_slots} "
          f"slots, {st['decode_tokens'] / spent['decode']:.1f} tok/s; "
          f"prefix hits wave 2 {hits}; launches {launches}")
    print(f"serve: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    first = {len(p): r.output_tokens[0] for p, r in zip(prompts, wave1)}
    del serve._prefill, serve._block       # drop the phase timers
    device_ms = phase_profile(torch, serve, prompts)
    serve.close()
    del serve
    phase_unfused(torch, model, prompts, first)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, device_ms


def phase_profile(torch, serve, prompts):
    """After the main path: one more 8-request wave under torch.profiler —
    device busy share of the wall clock, the kernels that take the device
    time, and each kernel's device time per launch (fused_mlp: per call of
    its two launches)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [p[:PROFILE_PROMPT] for p in prompts]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_pad()
        t0 = time.perf_counter()
        for p in reqs:
            serve.submit(p, max_new_tokens=PROFILE_NEW)
        serve.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        profile_pad()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"profile: fused decode, 8 x (40 prompt + 24 new) tokens, wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%, idle "
          f"{100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    print(f"profile: host self time {sum(e.self_cpu_time_total for e in host) / 1e3:.1f}"
          f" ms in profiled ops; top:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x {e.key[:60]}")
    out = {}
    tags = {"rms_norm": ("rms_norm_fwd_",), "rope": ("rope_kernel",),
            "layer_norm": ("layer_norm_fwd_",),
            "fused_norm_qkv": ("norm_qkv_mma_kernel",),
            "flash_decode": ("flash_decode_kernel",),
            "fused_proj_norm": ("proj_norm_mma_kernel",),
            "fused_mlp": ("mlp_act_mma_kernel", "mlp_down_mma_kernel")}
    for name, keys in tags.items():
        parts = [[e for e in kernels if tag in e.key] for tag in keys]
        n = sum(e.count for e in parts[0])
        out[name] = None
        if not n:                       # not a kernel of this model's path
            continue
        total = sum(e.self_device_time_total for p in parts for e in p)
        out[name] = total / n / 1e3
        split = ""
        if len(parts) > 1 and n:
            split = " (" + " + ".join(
                f"{tag} {sum(e.self_device_time_total for e in p) / n / 1e3:.5f}"
                for tag, p in zip(keys, parts)) + ")"
        if len(parts) > 1:      # the launches' union: PDL's overlap counted once
            out[name + "_span"] = span_ms(prof, keys) / n
            split += f"; {out[name + '_span']:.5f} ms their union a call"
        print(f"profile: {name} device time per launch {out[name]:.5f} ms over "
              f"{n} launches{split}")
    check(out["fused_mlp"] is not None and out["fused_norm_qkv"] is not None,
          f"serve profile: no launch of {tags['fused_mlp']} or {tags['fused_norm_qkv']}")
    return out


# generate()'s llama3-8b cell: 8 prompts of 200 tokens, 64 new
GEN_ROWS, GEN_PROMPT, GEN_NEW = 8, 200, 64


def generate_plan(cfg, forwards, int8=False, fused=True):
    """Launches one generate() call must make: its prefill (one forward over
    the padded prompt bucket: 2L+1 norms and, for a RoPE model, L RoPEs, q
    and k in one launch) and ``forwards`` decode steps, each L calls of the
    four fused kernels (the contiguous flash_decode; the int8 bodies of the
    three GEMVs with int8 weights), for a RoPE model L RoPEs, and the final
    norm; unfused (the int8 KV cache, the MoE MLP), each step 2L+1 norms
    and L RoPEs."""
    L = cfg.num_layers
    if not fused:
        return launch_plan(cfg, 1, forwards, fused=False)
    plan = {k: 0 for k in KERNELS}
    plan[norm_kernel(cfg)] = 2 * L + 1 + forwards
    if cfg.position == "rope":
        plan["rope"] = L * (1 + forwards)
    sfx = "_int8" if int8 else ""
    for k in ("fused_norm_qkv", "fused_proj_norm", "fused_mlp"):
        plan[k + sfx] = L * forwards
    plan["flash_decode_contig"] = L * forwards
    return plan


def decode_forwards(n_new, n_max, eos, unroll):
    """Decode forwards of one generate() call that returned ``n_new`` new
    tokens a row: the loop forwards after every step but the last (n_max
    steps: n_max - 1).  With an EOS id it reads the device every ``unroll``
    steps, so it stops at the first multiple of ``unroll`` at or past the
    step that finished the last row: up to unroll - 1 masked tail steps,
    whose tokens are cut off."""
    if not eos:
        return n_max - 1
    return min(-(-n_new // unroll) * unroll, n_max) - 1


def resident_weight_bytes(*trees):
    """Device bytes of weight trees (an inference engine's plain tree
    ``_params`` and kernel-injected view ``_dparams``), each storage counted
    once (the view's per-layer leaves are views of the tree)."""
    from deepspeed_tpu_torch.models.quant import is_qtensor

    seen = {}

    def visit(t):
        if isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                visit(v)
        else:
            for x in ((t.q, t.scale) if is_qtensor(t) else (t,)):
                st = x.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    for tree in trees:
        visit(tree)
    return sum(seen.values())


def weight_bytes_from_shapes(cfg, int8):
    """The same count from the leaf shapes alone: 2 bytes an element (bf16);
    with int8 weights the stacked layer matmuls and the head 1 byte an
    element plus a 4-byte scale a column of each layer; the injected view
    adds the concatenated QKV (codes and scales with int8)."""
    from deepspeed_tpu_torch.models.transformer import param_shapes

    total = 0

    def walk(spec, path):
        nonlocal total
        if isinstance(spec, dict):
            for k, v in spec.items():
                walk(v, path + (k,))
            return
        shape = spec[0]
        n = math.prod(shape)
        quant = int8 and ((path[0] == "layers" and len(shape) >= 3)
                          or path == ("lm_head",))
        total += n + 4 * (n // shape[-2]) if quant else 2 * n
    walk(param_shapes(cfg), ())
    L, D = cfg.num_layers, cfg.hidden_size
    nqkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    total += L * D * nqkv + 4 * L * nqkv if int8 else 2 * L * D * nqkv
    if cfg.use_bias or cfg.qkv_bias:
        total += 2 * L * nqkv
    return total


def phase_generate_profile(torch, eng, prompts, int8):
    """One more greedy generate() (8 rows, 24 new tokens) under
    torch.profiler: device busy share of the wall clock, the top kernels and
    each kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_pad()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=24)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        profile_pad()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"profile: generate(), {len(prompts)} x ({prompts.shape[1]} prompt + "
          f"24 new) tokens, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
          f"{100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    print(f"profile: host self time "
          f"{sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms in "
          f"profiled ops; top:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:60]}")
    # each body has kernels of its own, whose names do not hold each other
    # (so two kinds are never counted together): the int8 norm_qkv and
    # proj_norm run norm_qkv_int8_mma_kernel and proj_norm_int8_mma_kernel,
    # bf16 the tensor-core *_mma_kernel ones; the int8 MLP has kernels of its
    # own
    sfx = "_int8" if int8 else ""
    tags = {"rms_norm": ("rms_norm_fwd_",), "rope": ("rope_kernel",),
            "fused_norm_qkv" + sfx: ("norm_qkv_int8_mma_kernel" if int8
                                     else "norm_qkv_mma_kernel",),
            "flash_decode_contig": ("flash_decode_kernel",),
            "fused_proj_norm" + sfx: ("proj_norm_int8_mma_kernel" if int8
                                      else "proj_norm_mma_kernel",),
            "fused_mlp": ("mlp_act_mma_kernel", "mlp_down_mma_kernel"),
            "fused_mlp_int8": ("mlp_act_int8_mma_kernel", "mlp_down_int8_mma_kernel")}
    out = {}
    for name, keys in tags.items():
        parts = [[e for e in kernels if tag in e.key] for tag in keys]
        n = sum(e.count for e in parts[0])
        if not n:
            continue
        out[name] = sum(e.self_device_time_total for p in parts
                        for e in p) / n / 1e3
        split = ""
        if len(parts) > 1:        # the launches of one call, in ms a call
            out[name + "_split"] = {tag: sum(e.self_device_time_total for e in p) / n / 1e3
                                    for tag, p in zip(keys, parts)}
            split = " (" + " + ".join(f"{tag} {v:.5f}" for tag, v
                                      in out[name + "_split"].items()) + ")"
            out[name + "_span"] = span_ms(prof, keys) / n
            split += f"; {out[name + '_span']:.5f} ms their union a call"
        print(f"profile: {name} device time per launch {out[name]:.5f} ms "
              f"over {n} launches{split}")
    for name in (("fused_norm_qkv_int8", "fused_mlp_int8") if int8
                 else ("fused_norm_qkv", "fused_mlp")):
        check(name in out, f"generate profile: no launch of {tags[name]}")
    return out


def host_available_gib():
    """MemAvailable of /proc/meminfo in GiB (None where there is none)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return None


def phase_generate(torch, dev, keep=None):
    """The main path of this slice: ``init_inference(causal_lm("llama3-8b"),
    {"dtype": ..., "max_out_tokens": 1024}).generate()`` at full width and
    depth, random bf16 weights from seed 0, in bf16 (``generate``) and with
    int8 weights (``generate_int8``) on one model.  Each: 8 greedy prompts
    of 200 tokens x 64 new; 3 of them with an EOS id from the first call's
    output (the cache is reused: no rebind); top-k 50 sampling twice from
    one seed (equal outputs); each call's launches, zeroed just before and
    read just after, equal to its plan; then a profiled call.  int8: the
    resident weight bytes equal the count from the leaf shapes, the share of
    greedy tokens equal to the bf16 run's, and a short int8 wave through
    ``init_serving``.  The int8 engine is built from the module moved to
    the host first (bf16, 16 GB of host memory): each layer slice goes to
    the card and is quantized there, so no bf16 copy stays beside the
    codes; its peak device memory must be below the bf16 engine's.
    ``keep`` (a dict) receives the bf16 greedy tokens.  Returns {path:
    (launches of the first call, device ms a launch)}."""
    import gc

    import numpy as np

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm("llama3-8b", dtype=torch.bfloat16,
                                          seed=0)
    cfg = model.config
    print(f"generate: llama3-8b D={cfg.hidden_size} L={cfg.num_layers} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} V={cfg.vocab_size}, bf16 "
          f"random weights (seed 0), built in {time.perf_counter() - t0:.1f}s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (GEN_ROWS, GEN_PROMPT))
    runs, greedy, peaks = {}, {}, {}
    for name, dtype in (("generate", "bfloat16"), ("generate_int8", "int8")):
        int8 = dtype == "int8"
        if int8:
            avail = host_available_gib()
            t = time.perf_counter()
            model.to("cpu")
            print(f"{name}: the bf16 module moved to the host in "
                  f"{time.perf_counter() - t:.1f}s (host memory available "
                  f"before: {avail if avail is None else round(avail, 1)} "
                  f"GiB)")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = deepspeed_tpu_torch.init_inference(
            model, {"dtype": dtype, "max_out_tokens": 1024})
        torch.cuda.synchronize()
        check(eng._dparams is not None, f"{name}: no kernel-injected view")
        held = resident_weight_bytes(eng._params, eng._dparams)
        want = weight_bytes_from_shapes(cfg, int8)
        check(held == want, f"{name}: {held} resident weight bytes, the leaf "
              f"shapes give {want}")
        plain = resident_weight_bytes(eng._params)
        print(f"{name}: engine built in {time.perf_counter() - t0:.1f}s; "
              f"resident weights {held} B = the count from the leaf shapes "
              f"({plain / 1e9:.3f} GB plain tree + {(held - plain) / 1e9:.3f} "
              f"GB injected QKV)")
        spent = {"prefill": 0.0}
        eng._prefill = timed(torch, spent, "prefill", eng._prefill)
        unroll = int(eng.config.decode_unroll)

        def call(rows, what, eos=None, **kw):
            zero_counts()
            spent["prefill"] = 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = eng.generate(rows, eos_token_id=eos, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = read_counts()
            n_max = kw["max_new_tokens"]
            n_new = out.shape[1] - rows.shape[1]
            fw = decode_forwards(n_new, n_max, eos is not None, unroll)
            plan = generate_plan(cfg, fw, int8)
            check(launches == plan, f"{name} {what}: launches {launches} != "
                  f"plan {plan}")
            check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                  f"{name} {what}: token id out of range")
            dec = wall - spent["prefill"]
            print(f"{name} {what}: {tuple(out.shape)} in {wall:.3f}s; prefill "
                  f"{rows.size} tokens {rows.size / spent['prefill']:.1f} "
                  f"tok/s; decode {fw} steps x {rows.shape[0]} rows "
                  f"{fw * rows.shape[0] / dec:.1f} tok/s; launches = plan "
                  f"({fw} forwards)")
            return out.cpu(), launches

        out, launches = call(prompts, "greedy", max_new_tokens=GEN_NEW)
        check(out.shape == (GEN_ROWS, GEN_PROMPT + GEN_NEW),
              f"{name}: greedy shape {tuple(out.shape)}")
        check(torch.equal(out[:, :GEN_PROMPT], torch.from_numpy(prompts)),
              f"{name}: the prompt is not the output's prefix")
        greedy[name] = out
        rebinds = eng.cache_rebinds
        eos = int(out[0, GEN_PROMPT + 1])
        out3, _ = call(prompts[:3], "eos", eos=eos, max_new_tokens=GEN_NEW)
        check(eng.cache_rebinds == rebinds, f"{name}: batch 3 rebound the cache")
        stopped = []
        for r in range(3):
            new = out3[r, GEN_PROMPT:]
            hit = (new == eos).nonzero()
            if len(hit):
                check(bool((new[int(hit[0]):] == eos).all()),
                      f"{name}: row {r} not EOS-padded after its EOS")
                stopped.append((r, int(hit[0]) + 1))
        check(stopped, f"{name}: no row reached EOS {eos}")
        print(f"{name} eos: EOS {eos}; rows stopped at their n-th new token "
              f"{stopped}; cache rebinds {eng.cache_rebinds}")
        samples = [call(prompts, "top-k 50 sample", max_new_tokens=32,
                        do_sample=True, top_k=50,
                        rng=torch.Generator(device=dev).manual_seed(1234))[0]
                   for _ in range(2)]
        check(torch.equal(*samples), f"{name}: sampling from one seed differs")
        print(f"{name} sample: two top-k 50 draws from one seed are equal "
              f"({len(set(samples[0][:, GEN_PROMPT:].reshape(-1).tolist()))} "
              f"distinct tokens)")
        del eng._prefill
        device_ms = phase_generate_profile(torch, eng, prompts, int8)
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"{name}: peak device memory {peaks[name]:.2f} GiB")
        runs[name] = (launches, device_ms)
        del eng
    check(peaks["generate_int8"] < peaks["generate"],
          f"generate_int8 peaks at {peaks['generate_int8']:.2f} GiB, not below "
          f"bf16 generate's {peaks['generate']:.2f} GiB")
    print(f"generate_int8: peak device memory {peaks['generate_int8']:.2f} GiB "
          f"beside bf16 generate's {peaks['generate']:.2f} GiB")
    if keep is not None:
        keep["greedy"] = greedy["generate"]
    share = float((greedy["generate_int8"][:, GEN_PROMPT:]
                   == greedy["generate"][:, GEN_PROMPT:]).float().mean())
    print(f"generate_int8: {100 * share:.1f}% of the greedy tokens equal the "
          f"bf16 run's (position for position; the JAX test asks >= 75% on "
          f"its tiny model)")
    phase_int8_serve(torch, model, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def phase_int8_serve(torch, model, prompts):
    """A short int8 wave through ``init_serving``: 4 requests x 32 tokens
    on the paged fused path, the paged flash_decode beside the int8 GEMVs;
    launches equal to the serving plan with the GEMVs on their int8
    bodies."""
    import gc

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "int8", "max_out_tokens": 1024},
        num_slots=8, prefill_chunk=64)
    check(serve.engine._dparams is not None, "int8 serving: no injected view")
    zero_counts()
    t0 = time.perf_counter()
    reqs = [serve.submit(p, max_new_tokens=32) for p in prompts[:4]]
    serve.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    for r in reqs:
        check(r.finish_reason == "length" and len(r.output_tokens) == 32,
              f"int8 serving: {r.finish_reason} / {len(r.output_tokens)}")
    st = serve.stats
    plan = launch_plan(model.config, st["prefill_chunks"],
                       st["decode_blocks"] * serve._K, fused=True)
    for k in ("fused_norm_qkv", "fused_proj_norm", "fused_mlp"):
        plan[k + "_int8"], plan[k] = plan[k], 0
    check(launches == plan, f"int8 serving launches {launches} != {plan}")
    serve.pool.check_no_leak()
    print(f"int8 serve: 4 requests x 32 tokens in {wall:.2f}s, "
          f"{st['prefill_chunks']} prefill chunks, "
          f"{st['decode_blocks'] * serve._K} decode steps; launches = plan "
          f"(paged flash_decode {launches['flash_decode']}, int8 GEMVs "
          f"{launches['fused_norm_qkv_int8']} / "
          f"{launches['fused_proj_norm_int8']} / {launches['fused_mlp_int8']})")
    serve.close()


def cache_bytes(cache):
    """Device bytes of a KV cache's planes (the x_dtype anchor aside)."""
    return sum(v.numel() * v.element_size() for v in cache.values()
               if v.dim() > 0)


def serve_rates(st, spent, K):
    """(prefill tok/s, decode tok/s, decode steps) of a serving run timed
    by :func:`timed`."""
    steps = st["decode_blocks"] * K
    return (st["prefill_tokens"] / spent["prefill"],
            st["decode_tokens"] / spent["decode"], steps)


def phase_fixed_and_kv_int8(torch, dev, serve_keep, gen_keep):
    """The two KV variants of the llama3-8b serving cell, on a fresh model
    from seed 0 (the weights ``serve`` and ``generate`` used):

    - ``fixed_slot_serve``: ``paged_kv_cache: false``, the serve waves of
      ``phase_serve`` on the default fused decode (the contiguous-cache
      flash_decode at per-row positions); launches equal to the plan,
      prefill and decode tok/s, peak memory, and the share of greedy tokens
      equal to the paged run's;
    - ``kv_int8``: ``quantize_kv_cache: true`` (the unfused loop), wave 1
      of the serve waves through ``init_serving`` and one ``generate()``
      (8 x 200 prompt tokens + 64 new); the cache's bytes against the bf16
      cache of the same shape (expected (128 + 4) / 256 = 0.516 a
      head-row), the share of greedy tokens equal to the bf16 cache's runs
      (serve wave 1, and bf16 ``generate``), tok/s, peak memory; launches
      of the wave and the call together equal to their plans.
    Returns {"fixed_slot_serve": (launches, {}), "kv_int8": (launches, {})}."""
    import gc

    import numpy as np

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm("llama3-8b", dtype=torch.bfloat16,
                                          seed=0)
    cfg = model.config
    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "paged_kv_cache": False,
                       "max_out_tokens": 1024}, num_slots=8, prefill_chunk=64)
    torch.cuda.synchronize()
    check(serve.engine._dparams is not None and not serve.paged,
          "fixed_slot_serve: not the fused fixed-slot path")
    print(f"fixed_slot_serve: llama3-8b bf16 (seed 0), {serve.num_slots} "
          f"slots x {serve.cache_len} tokens, contiguous cache "
          f"{cache_bytes(serve._cache) / 1e9:.3f} GB, fused decode, built in "
          f"{time.perf_counter() - t0:.1f}s")
    spent = {"prefill": 0.0, "decode": 0.0}
    serve._prefill = timed(torch, spent, "prefill", serve._prefill)
    serve._block = timed(torch, spent, "decode", serve._block)
    zero_counts()
    _, wave1, wave2, wall = serve_waves(torch, serve, cfg.vocab_size)
    fixed_launches = read_counts()
    st = serve.stats
    pre, dec, steps = serve_rates(st, spent, serve._K)
    plan = launch_plan(cfg, st["prefill_chunks"], steps, fused=True,
                       contig=True)
    check(fixed_launches == plan, f"fixed_slot_serve launches "
          f"{fixed_launches} != plan {plan}")
    check(st["prefix_hit_tokens"] == 0 and st["preempted"] == 0,
          f"fixed_slot_serve: a prefix hit or a preemption: {st}")
    share = token_share([r.output_tokens for r in wave1 + wave2],
                        serve_keep["tokens"])
    print(f"fixed_slot_serve: 10 requests in {wall:.2f}s; prefill "
          f"{st['prefill_tokens']} tokens in {st['prefill_chunks']} chunks, "
          f"{pre:.1f} tok/s; decode {st['decode_tokens']} tokens in {steps} "
          f"steps, {dec:.1f} tok/s; launches = plan (flash_decode_contig "
          f"{fixed_launches['flash_decode_contig']}); {100 * share:.1f}% of "
          f"the greedy tokens equal the paged run's; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    serve.close()
    del serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    kv_cfg = {"dtype": "bfloat16", "quantize_kv_cache": True,
              "max_out_tokens": 1024}
    serve = deepspeed_tpu_torch.init_serving(model, config=kv_cfg,
                                             num_slots=8, prefill_chunk=64)
    check(serve.engine._dparams is None and serve.paged,
          "kv_int8: not the unfused paged path")
    planes = serve._cache
    check(planes["k"].dtype == torch.int8 and planes["k_scale"].dtype ==
          torch.float32, "kv_int8: the cache is not int8 with fp32 scales")
    got = cache_bytes(planes)
    bf16 = 2 * planes["k"].numel() * 2
    ratio = got / bf16
    check(ratio <= 0.52, f"kv_int8: cache bytes {got} are {ratio:.4f} of the "
          f"bf16 cache's {bf16}")
    spent = {"prefill": 0.0, "decode": 0.0}
    serve._prefill = timed(torch, spent, "prefill", serve._prefill)
    serve._block = timed(torch, spent, "decode", serve._block)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_LENS]
    zero_counts()
    t = time.perf_counter()
    reqs = [serve.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, SERVE_NEWS)]
    serve.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for r, n in zip(reqs, SERVE_NEWS):
        check(r.finish_reason == "length" and len(r.output_tokens) == n,
              f"kv_int8 serve: {r.finish_reason} / {len(r.output_tokens)}")
    serve.pool.check_no_leak()
    st = serve.stats
    pre, dec, steps = serve_rates(st, spent, serve._K)
    serve_plan = launch_plan(cfg, st["prefill_chunks"], steps, fused=False)
    s_share = token_share([r.output_tokens for r in reqs],
                          serve_keep["tokens"][:len(reqs)])
    print(f"kv_int8: int8 KV cache {got / 1e9:.4f} GB = {ratio:.4f} of the "
          f"bf16 cache's {bf16 / 1e9:.4f} GB (expected (128 + 4) / 256 = "
          f"0.5156); serve wave 1, {len(reqs)} requests in {wall:.2f}s: "
          f"prefill {pre:.1f} tok/s, decode {st['decode_tokens']} tokens in "
          f"{steps} steps {dec:.1f} tok/s; {100 * s_share:.1f}% of the greedy "
          f"tokens equal the bf16 paged run's")
    serve.close()
    del serve
    gc.collect()
    torch.cuda.empty_cache()
    eng = deepspeed_tpu_torch.init_inference(model, kv_cfg)
    check(eng._dparams is None, "kv_int8 generate: took the fused path")
    spent = {"prefill": 0.0}
    eng._prefill = timed(torch, spent, "prefill", eng._prefill)
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (GEN_ROWS, GEN_PROMPT))
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(rows, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    out = out.cpu()
    check(out.shape == (GEN_ROWS, GEN_PROMPT + GEN_NEW) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"kv_int8 generate: {tuple(out.shape)} or an id out of range")
    check(eng._cache["k"].dtype == torch.int8, "kv_int8 generate: bf16 cache")
    plan = add_plans(serve_plan, generate_plan(cfg, GEN_NEW - 1, fused=False))
    check(launches == plan, f"kv_int8 launches {launches} != plan {plan}")
    g_share = float((out[:, GEN_PROMPT:] == gen_keep["greedy"][:, GEN_PROMPT:]
                     ).float().mean())
    dec = (GEN_NEW - 1) * GEN_ROWS / (wall - spent["prefill"])
    print(f"kv_int8 generate: {tuple(out.shape)} in {wall:.3f}s; prefill "
          f"{rows.size / spent['prefill']:.1f} tok/s; decode {dec:.1f} tok/s; "
          f"{100 * g_share:.1f}% of the greedy tokens equal bf16 generate's; "
          f"launches (wave + call) = plan; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"fixed_slot_serve": (fixed_launches, {}),
            "kv_int8": (launches, {})}


# the mixtral cell: mixtral-8x7b at full width, 8 of its 32 layers (the
# 32-layer preset is 93 GB in bf16 and does not fit one card; 16 fit, and
# 8 keep the smoke in its time)
MIXTRAL_LAYERS = 8


def phase_mixtral(torch, dev):
    """``mixtral_serve``: mixtral-8x7b at full width (D 4096, 32/8 heads, F
    14336, 8 experts top-2, vocab 32000, rope theta 1e6) with
    MIXTRAL_LAYERS layers,
    bf16 random weights from seed 0, on one card: the serve waves through
    ``init_serving`` (paged, prefix cache; the repeat's share of equal
    tokens reported: capacity couples rows), then
    ``init_inference(...).generate()`` of 8 x 200 prompt tokens + 64 new,
    both on the unfused loop (every expert's weights read each step, as
    the JAX dense [E, C, D] contraction reads them); launches of the waves
    and the call (rms_norm, rope) equal to their plans; parameters, build
    time, peak memory, prefill and decode tok/s; then a 16-token
    ``generate()`` under torch.profiler for the device's busy share."""
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm("mixtral-8x7b", dtype=torch.bfloat16,
                                          seed=0, num_layers=MIXTRAL_LAYERS)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "prefix_caching": True,
                       "max_out_tokens": 1024}, num_slots=8, prefill_chunk=64)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    check(serve.engine._dparams is None, "mixtral: took the fused path")
    print(f"mixtral_serve: mixtral-8x7b D={cfg.hidden_size} L={cfg.num_layers} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} F={cfg.intermediate_size} "
          f"E={cfg.num_experts} top-{cfg.num_experts_per_tok} "
          f"V={cfg.vocab_size}, bf16 random weights (seed 0), "
          f"{n_params / 1e9:.3f}B params ({2 * n_params / 1e9:.2f} GB), paged "
          f"KV {cache_bytes(serve._cache) / 1e9:.3f} GB, built in {build:.1f}s")
    spent = {"prefill": 0.0, "decode": 0.0}
    serve._prefill = timed(torch, spent, "prefill", serve._prefill)
    serve._block = timed(torch, spent, "decode", serve._block)
    zero_counts()
    _, wave1, wave2, wall = serve_waves(torch, serve, cfg.vocab_size,
                                        repeat_equal=False)
    st = serve.stats
    pre, dec, steps = serve_rates(st, spent, serve._K)
    serve_plan = launch_plan(cfg, st["prefill_chunks"], steps, fused=False)
    hits = [r.prefix_hit_tokens for r in wave2]
    check(sum(hits) > 0, f"mixtral wave 2 missed the prefix cache: {hits}")
    serve.pool.check_no_leak()
    rep = token_share([wave2[0].output_tokens], [wave1[7].output_tokens])
    print(f"mixtral_serve: 10 requests in {wall:.2f}s; prefill "
          f"{st['prefill_tokens']} tokens in {st['prefill_chunks']} chunks, "
          f"{pre:.1f} tok/s; decode {st['decode_tokens']} tokens in {steps} "
          f"steps of {serve.num_slots} slots, {dec:.1f} tok/s; prefix hits "
          f"wave 2 {hits}; the repeat equals its cold run at "
          f"{100 * rep:.1f}% of its tokens")
    serve.close()
    del serve
    gc.collect()
    torch.cuda.empty_cache()
    eng = deepspeed_tpu_torch.init_inference(
        model, {"dtype": "bfloat16", "max_out_tokens": 1024})
    check(eng._dparams is None, "mixtral generate: took the fused path")
    spent = {"prefill": 0.0}
    eng._prefill = timed(torch, spent, "prefill", eng._prefill)
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (GEN_ROWS, GEN_PROMPT))
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(rows, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    out = out.cpu()
    check(out.shape == (GEN_ROWS, GEN_PROMPT + GEN_NEW) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"mixtral generate: {tuple(out.shape)} or an id out of range")
    plan = add_plans(serve_plan, generate_plan(cfg, GEN_NEW - 1, fused=False))
    check(launches == plan, f"mixtral launches {launches} != plan {plan}")
    check(launches["rms_norm"] > 0 and launches["rope"] > 0,
          "mixtral: rms_norm or rope never ran")
    dec_g = (GEN_NEW - 1) * GEN_ROWS / (wall - spent["prefill"])
    print(f"mixtral generate: {tuple(out.shape)} in {wall:.3f}s; prefill "
          f"{rows.size} tokens {rows.size / spent['prefill']:.1f} tok/s; "
          f"decode {GEN_NEW - 1} steps x {GEN_ROWS} rows {dec_g:.1f} tok/s "
          f"({1e3 * (wall - spent['prefill']) / (GEN_NEW - 1):.2f} ms a "
          f"step); {len(set(out[:, GEN_PROMPT:].reshape(-1).tolist()))} "
          f"distinct new tokens; launches (waves + call) = plan (rms_norm "
          f"{launches['rms_norm']}, rope {launches['rope']})")
    del eng._prefill
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_pad()
        t = time.perf_counter()
        eng.generate(rows, max_new_tokens=16)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
        profile_pad()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"mixtral profile: generate 8 x (200 + 16), wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    print(f"mixtral_serve: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {}


# the train cells: preset -> (micro batch, sequence length); 16384 tokens a
# step each with gas 2
TRAIN_CELLS = {"llama-1b4": (4, 2048), "gpt2-xl": (8, 1024),
               "bloom-1b7": (4, 2048), "mixtral-8x7b": (4, 2048),
               "llama2-7b": (2, 2048)}
# mixtral_train: mixtral-8x7b's full width cut to 2 of its 32 layers
# (3.165B parameters; FusedAdam over fp32 masters keeps ~20 bytes a
# parameter, ~63 GB, on the 80 GB card)
MIXTRAL_TRAIN_LAYERS = 2
# bloom-1b7's published config.json (bigscience/bloom-1b7 on the HF hub;
# BigScience BLOOM, arXiv 2211.05100 Table 3): D 2048, 24 layers, 16 heads
# of 128, the padded vocabulary; config_from_hf maps it to ALiBi, the
# embedding LayerNorm, biases, LayerNorm, tanh GeLU, F = 4 D, a tied head
BLOOM_1B7 = {"model_type": "bloom", "n_embed": 2048, "n_layer": 24,
             "n_head": 16, "vocab_size": 250880, "layer_norm_epsilon": 1e-5,
             "hidden_dropout": 0.0, "attention_dropout": 0.0}


def config_through_hf(hf):
    """The port's ModelConfig of a HF config.json written with ``hf``: the
    path a user takes with a checkpoint, without weights."""
    import os
    import tempfile

    from deepspeed_tpu_torch.module_inject import config_from_hf

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump(hf, fh)
        return config_from_hf(d)


def train_model(preset, seed=0, **over):
    """A train cell's model on the card, random weights from ``seed``:
    bloom-1b7 through config_from_hf (remat ``mlp_dots``, as llama-1b4),
    mixtral-8x7b cut to MIXTRAL_TRAIN_LAYERS layers, the others from their
    preset with ``over`` laid over it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import CausalLM

    if preset == "mixtral-8x7b":
        return deepspeed_tpu_torch.causal_lm(preset, seed=seed,
                                             num_layers=MIXTRAL_TRAIN_LAYERS)
    if preset != "bloom-1b7":
        return deepspeed_tpu_torch.causal_lm(preset, seed=seed, **over)
    cfg = config_through_hf(BLOOM_1B7)
    cfg.remat, cfg.remat_policy = True, "mlp_dots"
    return CausalLM(cfg, seed=seed)
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "FusedAdam", "params": {
        "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
    "gradient_clipping": 1.0}
# config A, the memory rung: master-free bf16 (bf16 params and accumulator,
# Adam8bit's int8 moments and stochastic rounding); config B: FusedLamb over
# fp32 masters; each merged over TRAIN_CONFIG
ADAM8BIT_CONFIG = {"bf16": {"enabled": True, "master_weights": False},
                   "data_types": {"grad_accum_dtype": "bf16"},
                   "optimizer": dict(TRAIN_CONFIG["optimizer"], type="Adam8bit")}
LAMB_CONFIG = {"optimizer": dict(TRAIN_CONFIG["optimizer"], type="FusedLamb")}
# the fp16 cell: TRAIN_CONFIG with fp16 in place of bf16, the default
# dynamic scale (2^16, window 1000, hysteresis 2) over fp32 masters
FP16_CONFIG = {"bf16": {"enabled": False}, "fp16": {"enabled": True}}


def optimizer_plan(optimizer, steps):
    """Launches of the optimizer's kernels over ``steps`` steps: FusedAdam
    one a leaf, Adam8bit one a leaf of at least ``min_quant_size`` (the
    smaller keep fp32 moments and plain torch), FusedLamb one phase-1 call
    (phase 1 and the reduce) and one scale launch a leaf; the offload
    path's host optimizer none (C++ on the host)."""
    from deepspeed_tpu_torch.ops.adam import Adam8bit, FusedAdam
    from deepspeed_tpu_torch.ops.lamb import FusedLamb

    if not hasattr(optimizer, "param_groups"):
        return {}
    leaves = [p for g in optimizer.param_groups for p in g["params"]]
    if isinstance(optimizer, Adam8bit):
        return {"fused_adam8bit": steps * sum(map(optimizer.quantized, leaves))}
    if isinstance(optimizer, FusedLamb):
        return {"fused_lamb_phase1": steps * len(leaves),
                "fused_lamb_scale": steps * len(leaves)}
    if isinstance(optimizer, FusedAdam) and optimizer.fused:
        return {"fused_adam": steps * len(leaves)}
    return {}           # Lion, Adagrad, SGD, Muon: plain foreach torch


def adam8bit_state_bytes(optimizer):
    """The state's bytes reckoned from the leaf shapes alone: two int8
    ``[nb_pad, block]`` code arrays and two fp32 ``[nb_pad, 1]`` scales a
    quantized leaf, two fp32 ``[n]`` moments a small one."""
    from deepspeed_tpu_torch.ops.kernels.fused_adam8bit import state_rows

    total = 0
    for g in optimizer.param_groups:
        for p in g["params"]:
            n = p.numel()
            if n >= optimizer.min_quant_size:
                rows = state_rows(n, optimizer.block)
                total += 2 * rows * optimizer.block + 2 * 4 * rows
            else:
                total += 2 * 4 * n
    return total


def train_plan(cfg, micros, steps, optimizer, f16=False, bucket_remat=False):
    """Launches a training run must make.  Per micro-batch: 2L+1 norm
    forwards (RMSNorm or LayerNorm) and as many backwards, one more of each
    (a LayerNorm) for BLOOM's embedding norm, L flash forward and L flash
    backward calls (the ALiBi instances for an ALiBi model, the fp16 ones
    under ``f16``) and, for a RoPE model, L RoPE forwards and L backwards
    (the same kernel; q and k in one launch).  Remat adds forwards in the
    backward: the MLP policies recompute the MLP's norm (+L norm forwards),
    the whole-layer policies run the layer's forward again up to its last
    saved tensor (+2L norm forwards, +L flash forwards, +L RoPEs).  The optimizer's launches
    as ``optimizer_plan`` counts them over the ``steps`` applied steps (an
    fp16 step skipped for an overflow launches none); no decode kernel.
    Dropout (``cfg.dropout > 0``) launches its forward twice a layer (the
    attention's and the MLP's output) and its backward twice a layer.  A
    recompute under ``torch.utils.checkpoint`` stops at the last saved
    tensor, and the MLP's dropout is its body's last operation: so
    ``mlp_only`` (and an MoE MLP under ``mlp_dots``) redoes none, the
    whole-layer checkpoint (``full``, ``dots``) the attention's alone (+L);
    the replay of the saved-dots bodies reruns them whole: ``mlp_dots``
    +L, ``offload_dots`` +2L.  ``bucket_remat`` (the ``overlap_comm``
    schedule's layer buckets under ``torch.utils.checkpoint``, around the
    model's own policy) runs each layer's forward once more in the
    backward, up to its last saved tensor, the MLP's saved dots: +2L norm
    forwards, +L flash forwards, +L RoPEs (no dropout here)."""
    L = cfg.num_layers
    mlp = bool(cfg.remat) and cfg.remat_policy in ("mlp_only", "mlp_dots")
    full = (bool(cfg.remat) and not mlp) or bucket_remat
    check(not (bucket_remat and (cfg.dropout > 0 or (cfg.remat and not mlp))),
          "train_plan: bucket remat is counted over an MLP policy without dropout")
    rope = cfg.position == "rope"
    flash = ("flash_attention_{}" + ("_f16" if f16 else "")
             + ("_alibi" if cfg.position == "alibi" else ""))
    plan = {k: 0 for k in KERNELS}
    plan[norm_kernel(cfg)] = (2 * L + 1 + L * mlp + 2 * L * full) * micros
    plan[norm_kernel(cfg) + "_bwd"] = (2 * L + 1) * micros
    if cfg.embed_norm:
        plan["layer_norm"] += micros
        plan["layer_norm_bwd"] += micros
    plan.update({"rope": (2 * L + L * full) * micros * rope,
                 flash.format("fwd"): (L + L * full) * micros,
                 flash.format("bwd"): L * micros})
    if cfg.dropout > 0:
        offload = full and cfg.remat_policy == "offload_dots"
        dots_mlp = mlp and cfg.remat_policy == "mlp_dots" and not cfg.is_moe
        plan["dropout"] = (2 * L + L * dots_mlp + L * (full and not offload)
                           + 2 * L * offload) * micros
        plan["dropout_bwd"] = 2 * L * micros
    plan.update(optimizer_plan(optimizer, steps))
    return plan


def phase_train_reference(torch, dev, preset, remat_policy, dropout=0.0):
    """A small fp32 model trained 3 steps on the card (kernels, TF32 off)
    and on the CPU (plain versions) from the same weights and tokens:
    per-step losses within rtol 1e-4 and final weights within atol 1e-4
    (fp32 sums in another order; Adam's normalised step keeps the weight
    difference near lr * 1e-4).  With ``dropout`` both devices draw the
    same masks (JAX's threefry bits), so the bounds hold as they are."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import dropout as kd

    torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(SMALL[preset], remat=True, remat_policy=remat_policy,
                dropout=dropout)
    cfg = dict(TRAIN_CONFIG, bf16={"enabled": False},
               train_micro_batch_size_per_gpu=2)
    tok = np.random.default_rng(0).integers(0, 1024, (4, 200))   # ragged S
    runs = {}
    for d in ("cpu", dev):
        model = deepspeed_tpu_torch.causal_lm(preset, device="cpu", seed=0,
                                              **over)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=d)
        before = kd.dropout.launches + kd.dropout_bwd.launches
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        check((kd.dropout.launches + kd.dropout_bwd.launches > before)
              == (d != "cpu" and dropout > 0), f"{preset} {d}: dropout launches")
        runs[str(d)] = (losses, [p.cpu() for p in engine.master])
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    check(all(math.isfinite(x) for x in lg), f"card losses {lg}")
    for a, b in zip(lc, lg):
        check(abs(a - b) <= 1e-4 * abs(a), f"card vs CPU losses {lg} vs {lc}")
    diff = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(diff <= 1e-4, f"card vs CPU weights differ by {diff}")
    print(f"reference: small fp32 {preset} model (L 2, D 256, Dh "
          f"{256 // SMALL[preset]['num_heads']}, S 200, remat {remat_policy}, "
          f"dropout {dropout}) trained 3 steps, card == CPU: losses {lg} vs "
          f"{lc}, weights max abs diff {diff:.3g}")


def phase_preset_train_reference(torch, dev):
    """The llama-tiny preset as it is (D 256, 8 heads of 32, 4 layers,
    vocab 32000: flash attention at head dim 32) trained 3 fp32 steps on the
    card and on the CPU: the bounds of phase_train_reference."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(TRAIN_CONFIG, bf16={"enabled": False},
               train_micro_batch_size_per_gpu=2)
    tok = np.random.default_rng(0).integers(0, 32000, (4, 200))
    runs = {}
    for d in ("cpu", dev):
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                              seed=0)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=d)
        before = fa.flash_attention.launches
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        check((fa.flash_attention.launches > before) == (d != "cpu"),
              "the card run did not launch flash attention")
        runs[str(d)] = (losses, [p.cpu() for p in engine.master])
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    cfg_m = model.config
    check(all(math.isfinite(x) for x in lg) and lg[-1] < lg[0],
          f"llama-tiny card losses {lg}")
    for a, b in zip(lc, lg):
        check(abs(a - b) <= 1e-4 * abs(a), f"llama-tiny card vs CPU losses "
              f"{lg} vs {lc}")
    diff = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(diff <= 1e-4, f"llama-tiny card vs CPU weights differ by {diff}")
    print(f"reference: the llama-tiny preset unmodified (L {cfg_m.num_layers}, "
          f"D {cfg_m.hidden_size}, {cfg_m.num_heads} heads of "
          f"{cfg_m.head_dim}, V {cfg_m.vocab_size}, S 200) trained 3 fp32 "
          f"steps, card == CPU: losses {lg} vs {lc}, weights max abs diff "
          f"{diff:.3g}")


def phase_mixtral_train_reference(torch, dev, **over):
    """The mixtral-tiny preset as it is (D 256, 8 heads of 32, 4 layers, 8
    experts top-2, vocab 32000; ``over`` laid over it, such as dropout with
    Random Token Selection, whose permutations then come from the dropout
    key chain on both devices) trained 3 fp32 steps on the card and on the
    CPU from the same weights and tokens: the bounds of
    phase_train_reference (the router in fp32 with TF32 off on both); the
    card run launches the flash kernels and the RMSNorm backward."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(TRAIN_CONFIG, bf16={"enabled": False},
               train_micro_batch_size_per_gpu=2)
    tok = np.random.default_rng(0).integers(0, 32000, (4, 200))
    runs = {}
    for d in ("cpu", dev):
        model = deepspeed_tpu_torch.causal_lm("mixtral-tiny", device="cpu",
                                              seed=0, **over)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=d)
        before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
                  ln.rms_norm_bwd.launches)
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        after = (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
                 ln.rms_norm_bwd.launches)
        check(all((a > b) == (d != "cpu") for a, b in zip(after, before)),
              f"mixtral-tiny {d}: flash fwd, flash bwd, rms_norm_bwd launches "
              f"{before} -> {after}")
        runs[str(d)] = (losses, [p.cpu() for p in engine.master])
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    cfg_m = model.config
    check(all(math.isfinite(x) for x in lg) and lg[-1] < lg[0],
          f"mixtral-tiny card losses {lg}")
    for a, b in zip(lc, lg):
        check(abs(a - b) <= 1e-4 * abs(a), f"mixtral-tiny card vs CPU losses "
              f"{lg} vs {lc}")
    diff = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(diff <= 1e-4, f"mixtral-tiny card vs CPU weights differ by {diff}")
    print(f"reference: the mixtral-tiny preset unmodified (L {cfg_m.num_layers}, "
          f"D {cfg_m.hidden_size}, {cfg_m.num_heads} heads of {cfg_m.head_dim}, "
          f"{cfg_m.num_experts} experts top-{cfg_m.num_experts_per_tok}, V "
          f"{cfg_m.vocab_size}, S 200{''.join(f', {k} {v}' for k, v in over.items())}"
          f") trained 3 fp32 steps, card == CPU: losses {lg} vs {lc} (each with "
          f"its aux term), weights max abs diff {diff:.3g}")


# small fp32 models of the families the HF import brings to training: a
# BLOOM (ALiBi with 12 heads, whose slopes interpolate; the embedding
# LayerNorm; biases) and a GPT-NeoX (the parallel residual, rotary_pct 0.25)
SMALL_HF = {
    "bloom": {"model_type": "bloom", "n_embed": 384, "n_layer": 2,
              "n_head": 12, "vocab_size": 1024},
    "gpt_neox": {"model_type": "gpt_neox", "hidden_size": 256,
                 "intermediate_size": 512, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "vocab_size": 1024,
                 "max_position_embeddings": 512, "rotary_pct": 0.25,
                 "use_parallel_residual": True, "hidden_act": "gelu"}}


def phase_hf_train_reference(torch, dev):
    """A small BLOOM and a small GPT-NeoX (each through config_from_hf,
    remat ``mlp_dots``) trained 3 fp32 steps on the card (kernels, TF32 off;
    BLOOM's attention through the ALiBi instances) and on the CPU from the
    same weights and tokens: the bounds of phase_train_reference."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import CausalLM
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(TRAIN_CONFIG, bf16={"enabled": False},
               train_micro_batch_size_per_gpu=2)
    tok = np.random.default_rng(0).integers(0, 1024, (4, 200))   # ragged S
    for arch, hf in SMALL_HF.items():
        mcfg = config_through_hf(hf)
        mcfg.remat, mcfg.remat_policy = True, "mlp_dots"
        counter = fa.flash_fwd_alibi_cuda if arch == "bloom" else fa.flash_attention
        runs = {}
        for d in ("cpu", dev):
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=CausalLM(mcfg, device="cpu", seed=0), config=cfg, device=d)
            before = counter.launches
            losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
            check((counter.launches > before) == (d != "cpu"),
                  f"{arch}: the card run did not launch its flash kernel")
            runs[str(d)] = (losses, [p.cpu() for p in engine.master])
        (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
        check(all(math.isfinite(x) for x in lg) and lg[-1] < lg[0],
              f"{arch}: card losses {lg}")
        for a, b in zip(lc, lg):
            check(abs(a - b) <= 1e-4 * abs(a), f"{arch}: card vs CPU losses "
                  f"{lg} vs {lc}")
        diff = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
        check(diff <= 1e-4, f"{arch}: card vs CPU weights differ by {diff}")
        print(f"reference: small fp32 {arch} through config_from_hf (L "
              f"{mcfg.num_layers}, D {mcfg.hidden_size}, {mcfg.num_heads} heads "
              f"of {mcfg.head_dim}, {mcfg.position} positions, parallel "
              f"residual {mcfg.parallel_residual}, S 200) trained 3 steps, card "
              f"== CPU: losses {lg} vs {lc}, weights max abs diff {diff:.3g}")


def phase_optimizer_reference(torch, dev):
    """The small llama-shaped model trained 3 steps on the card (kernels,
    TF32 off) and on the CPU (plain versions) from the same weights and
    tokens, once per new optimizer path:

    - FusedLamb over fp32 masters: losses within rtol 1e-4 and weights
      within atol 1e-4, as the FusedAdam reference;
    - Adam8bit over fp32 masters: losses within 1e-4; 99 % of the weights
      within 1e-4 and all within 1e-4 + lr / 16: where a gradient 1e-6
      apart moves a value across a .5 code boundary, that element's step
      moves by one code of m (1/127 of its row's absmax) over sqrt(v);
    - Adam8bit master-free bf16 (bf16 accumulator, stochastic rounding with
      the same noise on both): losses within 2e-2 relative and every
      floating leaf bf16 on both;
    - Lion, Adagrad, SGD (Nesterov) and Muon over fp32 masters: losses
      within rtol 1e-4 and weights within atol 1e-4, except Lion's: its
      update is the sign of a sum, which flips where the sum is within
      rounding of zero, so at most 0.1 % of its weights may differ, by at
      most 2 lr."""
    import numpy as np

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(SMALL["llama-tiny"], remat=True, remat_policy="mlp_dots")
    lr = TRAIN_CONFIG["optimizer"]["params"]["lr"]
    cases = {
        "FusedLamb fp32": dict(optimizer=dict(TRAIN_CONFIG["optimizer"],
                                              type="FusedLamb"),
                               bf16={"enabled": False}),
        "Adam8bit fp32": dict(optimizer=dict(TRAIN_CONFIG["optimizer"],
                                             type="Adam8bit"),
                              bf16={"enabled": False}),
        "Adam8bit master-free bf16": ADAM8BIT_CONFIG,
        **{f"{opt} fp32": dict(optimizer_section(opt), bf16={"enabled": False})
           for opt in NEW_OPTIMIZERS}}
    tok = np.random.default_rng(0).integers(0, 1024, (4, 200))
    for name, section in cases.items():
        cfg = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2, **section)
        runs = {}
        for d in ("cpu", dev):
            model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                                  seed=0, **over)
            engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                        device=d)
            losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
            runs[str(d)] = (losses, [p.cpu() for p in engine.master])
        (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
        check(all(math.isfinite(x) for x in lg), f"{name}: card losses {lg}")
        check(lg[-1] < lg[0] and lc[-1] < lc[0], f"{name}: losses did not fall "
              f"{lg} / {lc}")
        diffs = torch.cat([(a.float() - b.float()).abs().reshape(-1)
                           for a, b in zip(pc, pg)])
        if name.endswith("bf16"):
            for a, b in zip(lc, lg):
                check(abs(a - b) <= 2e-2 * abs(a), f"{name}: losses {lg} vs {lc}")
            check(all(p.dtype == torch.bfloat16 for p in pc + pg),
                  f"{name}: a master is not bf16")
        else:
            for a, b in zip(lc, lg):
                check(abs(a - b) <= 1e-4 * abs(a), f"{name}: losses {lg} vs {lc}")
            close = float((diffs <= 1e-4).float().mean())
            if name.startswith("Lion"):
                lion_lr = NEW_OPTIMIZERS["Lion"]["lr"]
                ok = float(diffs.max()) <= 2.02 * lion_lr and close >= 0.999
            elif name.startswith("Adam8bit"):
                ok = float(diffs.max()) <= 1e-4 + lr / 16 and close >= 0.99
            else:
                ok = float(diffs.max()) <= 1e-4
            check(ok, f"{name}: weights differ by up to {float(diffs.max())} "
                  f"({100 * close:.2f} % within 1e-4)")
        print(f"reference: small {name} (llama-tiny L 2, D 256, S 200) trained "
              f"3 steps, card vs CPU: losses {lg} vs {lc}, weights max abs "
              f"diff {float(diffs.max()):.3g}")


def active_params(engine, cfg):
    """The parameters a token's forward multiplies by: every parameter of a
    dense model (its tied token table as the head); for an MoE model the
    attention, the router, top-k of the E experts and the head, without the
    token table, which a token only looks up."""
    n = sum(p.numel() for p in engine.master)
    if not cfg.is_moe:
        return n
    experts = sum(p.numel() for path, p in zip(engine._paths, engine.master)
                  if path in ("layers.mlp.w_up", "layers.mlp.w_gate",
                              "layers.mlp.w_down"))
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    tok = cfg.vocab_size * cfg.hidden_size if not cfg.tie_embeddings else 0
    return n - tok - experts * (E - k) // E


def phase_train(torch, dev, preset, name="train", section=None, peaks=None,
                medians=None, model_over=None, steps_wanted=5, profile=True,
                on_step=None, report=None):
    """The training path at the preset's full width and depth, with
    TRAIN_CONFIG (FusedAdam over fp32 masters) or ``section`` merged over
    it and ``model_over`` over the preset; records its peak device memory
    in ``peaks[name]`` and its median step in ``medians[name]``.  Five
    applied steps (``steps_wanted``): under fp16 as many more as overflows
    skip, each step printed with its loss scale and skip flag; then one
    profiled step (``profile``).  ``on_step(engine)`` runs after each step
    and ``report(engine, info)`` (the steps, the mean and median step, the
    peak, the parameter and token counts) before the engine is let go."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.adam import Adam8bit

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = train_model(preset, **(model_over or {}))
    cfg = model.config
    micro, S = TRAIN_CELLS[preset]
    L, gas = cfg.num_layers, 2
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(TRAIN_CONFIG, **(section or {}),
                                 train_micro_batch_size_per_gpu=micro))
    opt = engine.optimizer
    n_params = sum(p.numel() for p in engine.master)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (gas * micro, S), device=dev,
                           generator=gen)
    torch.cuda.synchronize()
    master = str(engine.master_dtype).replace("torch.", "")
    compute = str(engine.compute_dtype).replace("torch.", "")
    fp16 = engine.fp16_enabled
    host = (f" ({opt.opt_type} on the {opt.backend} host, fp32 host masters)"
            if engine._offload else "")
    moe = (f" E={cfg.num_experts} top-{cfg.num_experts_per_tok} (capacity "
           f"factor {cfg.moe_capacity_factor})" if cfg.is_moe else "")
    print(f"{name}: {preset} D={cfg.hidden_size} L={L} H={cfg.num_heads}/"
          f"{cfg.num_kv_heads} F={cfg.intermediate_size}{moe} V={cfg.vocab_size} "
          f"{'tied' if cfg.tie_embeddings else 'untied'}, {cfg.norm}, "
          f"{cfg.position} positions, embed_norm {cfg.embed_norm}, bias "
          f"{cfg.use_bias}, {cfg.activation}, dropout {cfg.dropout}, remat "
          f"{cfg.remat_policy}; "
          f"{n_params / 1e9:.4f}B {master} params in "
          f"{len(engine.master)} leaves, {type(opt).__name__}{host}, {compute} compute"
          f"{f' (loss scale {engine.loss_scale:g}, dynamic)' if fp16 else ''}, "
          f"{str(engine.grad_accum_dtype).replace('torch.', '')} accumulator, "
          f"micro {micro} x gas {gas} x S {S}; built in "
          f"{time.perf_counter() - t0:.1f}s")
    if isinstance(opt, Adam8bit):
        check(all(p.dtype == engine.master_dtype for p in engine.master),
              f"{name}: a master is not {master}")
    zero_counts()
    steps = []      # (loss, grad norm, next lr, wall s, skipped)
    while sum(not x[4] for x in steps) < steps_wanted:
        check(len(steps) < 12, f"{name}: {len(steps)} steps, most skipped: {steps}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        scale = engine.loss_scale
        loss = float(engine.train_step((tokens, tokens)))
        torch.cuda.synchronize()
        steps.append((loss, engine.get_global_grad_norm(), engine.get_lr()[0],
                      time.perf_counter() - t, engine._last_overflow))
        if on_step is not None:
            on_step(engine)
        print(f"{name}: step {len(steps)} loss {steps[-1][0]:.5f} grad norm "
              f"{steps[-1][1]:.4f} next lr {steps[-1][2]:.3e} wall "
              f"{steps[-1][3]:.3f}s" + (f" loss scale {scale:g} skipped "
                                        f"{steps[-1][4]}" if fp16 else ""))
    launches = read_counts()
    applied = [x for x in steps if not x[4]]
    check(all(math.isfinite(x[0]) for x in steps)
          and all(math.isfinite(x[1]) for x in applied),
          f"non-finite loss or grad norm: {steps}")
    check(applied[-1][0] < applied[0][0], f"loss did not fall: {steps}")
    check(engine.skipped_steps == len(steps) - len(applied)
          and engine.global_steps == len(applied), f"{name}: skips {steps}")
    sched = getattr(engine, "_overlap_sched", None)
    plan = train_plan(cfg, gas * len(steps), len(applied), opt, f16=fp16,
                      bucket_remat=sched is not None and sched.remat)
    check(launches == plan, f"{name} launches {launches} != path plan {plan}")
    if isinstance(opt, Adam8bit):
        held, want = opt.state_bytes(), adam8bit_state_bytes(opt)
        check(held == want, f"{name}: optimizer state {held} bytes, the leaf "
              f"shapes give {want}")
        print(f"{name}: optimizer state {held} bytes ({held / n_params:.4f} a "
              f"parameter: int8 codes, fp32 scales, the small leaves' fp32 "
              f"moments) = the count from the leaf shapes; every master "
              f"{master}")
    if hasattr(opt, "state_bytes") and not isinstance(opt, Adam8bit):
        print(f"{name}: {type(opt).__name__} state {opt.state_bytes()} bytes "
              f"({opt.state_bytes() / n_params:.4f} a parameter)")
    tokens_per_step = gas * micro * S
    steady = statistics.mean(x[3] for x in applied[1:])
    median = statistics.median(x[3] for x in applied[2:])
    if medians is not None:
        medians[name] = median
    attn_flops = 6 * L * gas * micro * cfg.num_heads * S * S * cfg.head_dim
    active = active_params(engine, cfg)
    flops = 6 * active * tokens_per_step + attn_flops
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peaks is not None:
        peaks[name] = peak
    beside = (f" (FusedAdam phase: {peaks['train']:.2f} GiB)"
              if peaks and name != "train" and "train" in peaks else "")
    if medians and name != "train" and "train" in medians:
        beside += f"; the bf16 FusedAdam phase's median step {medians['train']:.4f}s"
    print(f"{name}: steady step (mean of applied steps 2-{len(applied)}) "
          f"{steady:.4f}s, "
          f"{tokens_per_step / steady:.1f} tokens/s, MFU "
          f"{100 * flops / steady / BF16_FLOPS_PER_S:.2f}%; median of applied "
          f"steps 3-{len(applied)} {median:.4f}s, {tokens_per_step / median:.1f} "
          f"tokens/s, MFU "
          f"{100 * flops / median / BF16_FLOPS_PER_S:.2f}% (6N + attention "
          f"{flops / 1e12:.1f} TFLOP per step over 989 TFLOP/s"
          f"{f', N = {active / 1e9:.4f}B active' if cfg.is_moe else ''}; "
          f"recomputed forwards not counted), peak device "
          f"memory {peak:.2f} GiB{beside}; launches {launches}")
    device_ms = phase_train_profile(torch, engine, tokens) if profile else {}
    if report is not None:
        report(engine, {"steps": steps, "steady": steady, "median": median,
                        "peak_gib": peak, "n_params": n_params,
                        "tokens_per_step": tokens_per_step, "flops": flops,
                        "launches": launches})
    del engine, model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches, device_ms


# the checkpoint phase's path: the train path's kernels, then Adam8bit's
CHECKPOINT_KERNELS = ("rms_norm", "rms_norm_bwd", "rope", "flash_attention_fwd",
                      "flash_attention_bwd", "fused_adam", "fused_adam8bit")


def tag_bytes(engine):
    """The bytes a save of ``engine`` writes: every master and every leaf
    of its optim_states payload (counted from the live tensors)."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import \
        tree_flatten_with_path

    leaves = [p for p in engine.master] + [
        x for _, x in tree_flatten_with_path(engine._optim_payload())]
    return sum(x.numel() * x.element_size() for x in leaves)


def manifest_bytes(ckpt_dir):
    with open(f"{ckpt_dir}/MANIFEST.json") as fh:
        return sum(f["nbytes"] for f in json.load(fh)["files"].values())


# the checkpoint phase's depth: llama-1b4 cut from 24 to 1 layer to keep
# the smoke in its time (the save and the verified load hash
# every byte on one core: 158 s for the full-depth tags; 2 layers until
# the overlap and offload-over-ranks phases joined the smoke)
CHECKPOINT_LAYERS = 1


def checkpoint_round(torch, dev, name, section, ident, infer=False):
    """llama-1b4 at full width, CHECKPOINT_LAYERS deep, under TRAIN_CONFIG (``section``
    merged over it), 5 steps as the train phase takes them; save to a
    temporary directory; step 6; a fresh engine (other random weights)
    loads the tag and takes step 6 again: loss and grad norm bit-equal.
    With ``infer``, ``init_inference(checkpoint=)`` gives logits bit-equal
    to ``init_inference(params=)`` over the saved engine's masters.  The
    tag is deleted in a finally."""
    import gc
    import shutil
    import tempfile

    import deepspeed_tpu_torch

    micro, S = TRAIN_CELLS["llama-1b4"]
    cfg = dict(TRAIN_CONFIG, **(section or {}),
               train_micro_batch_size_per_gpu=micro)

    def build(seed):
        gc.collect()
        torch.cuda.empty_cache()
        return deepspeed_tpu_torch.initialize(
            model=train_model("llama-1b4", seed=seed, num_layers=CHECKPOINT_LAYERS),
            config=cfg)[0]

    def step(engine):
        loss = float(engine.train_step((tokens, tokens)))
        torch.cuda.synchronize()
        return loss, engine.get_global_grad_norm()

    engine = build(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, engine.module.config.vocab_size, (2 * micro, S),
                           device=dev, generator=gen)
    prompt = tokens[:1, :128]
    losses = [step(engine) for _ in range(5)]
    check(all(math.isfinite(x) for pair in losses for x in pair),
          f"{name}: non-finite loss or grad norm {losses}")
    root = tempfile.mkdtemp(prefix="ds_ckpt_")
    try:
        need = tag_bytes(engine)
        free = shutil.disk_usage(root).free
        print(f"{name}: tag {need / 1e9:.3f} GB ({len(engine.master)} masters "
              f"{engine.master[0].dtype}, {type(engine.optimizer).__name__}; "
              f"llama-1b4 cut to {CHECKPOINT_LAYERS} of its 24 layers for the "
              f"smoke's 600 s aim); {free / 1e9:.3f} GB free in {root}")
        check(free >= 1.2 * need, f"{name}: {free / 1e9:.1f} GB free cannot "
              f"hold the {need / 1e9:.1f} GB tag with a 20 % margin")
        t = time.perf_counter()
        ckpt_dir = engine.save_checkpoint(root)
        save_s = time.perf_counter() - t
        written = manifest_bytes(ckpt_dir)
        check(written >= need, f"{name}: wrote {written} bytes < {need}")
        want_logits = None
        if infer:
            eng = deepspeed_tpu_torch.init_inference(
                engine.module, {"dtype": "bfloat16"}, params=engine.params())
            want_logits = eng(prompt)
            del eng
        want = step(engine)
        del engine
        engine = build(1)
        t = time.perf_counter()
        loaded, _ = engine.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        check(loaded == ckpt_dir, f"{name}: loaded {loaded}, saved {ckpt_dir}")
        got = step(engine)
        print(f"{name}: {ident}: wrote {written} bytes in {save_s:.3f} s "
              f"({written / save_s / 1e9:.3f} GB/s, the sha256 of each leaf "
              f"and the manifest's pass included); loaded in {load_s:.3f} s "
              f"({written / load_s / 1e9:.3f} GB/s, the manifest's sha256 "
              f"pass included)")
        print(f"{name}: steps 1-5 {losses}; step 6 (loss, grad norm) before "
              f"the save's engine {want}, after the load {got}")
        check(got == want, f"{name}: step 6 after the load {got} != {want}")
        del engine
        if infer:
            gc.collect()
            torch.cuda.empty_cache()
            eng = deepspeed_tpu_torch.init_inference(
                deepspeed_tpu_torch.causal_lm("llama-1b4", num_layers=CHECKPOINT_LAYERS),
                {"dtype": "bfloat16"},
                checkpoint=root)
            got_logits = eng(prompt)
            check(got_logits.shape == want_logits.shape
                  and bool(torch.isfinite(got_logits).all())
                  and torch.equal(got_logits, want_logits),
                  f"{name}: init_inference(checkpoint=) logits differ from "
                  f"init_inference(params=) by "
                  f"{(got_logits.float() - want_logits.float()).abs().max()}")
            print(f"{name}: init_inference(checkpoint=) logits "
                  f"{tuple(got_logits.shape)} bit-equal to init_inference("
                  f"params=) over the saved masters")
            del eng
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"bytes": written, "save_s": save_s, "load_s": load_s}


def phase_checkpoint(torch, dev):
    """Save, load into a fresh engine and resume the llama-1b4 train cell
    bit-equal, under FusedAdam over fp32 masters (with the inference
    engine's load) and under master-free Adam8bit; launches counted over
    the whole phase, each of the path's kernels at least once."""
    ident = gpu_identity()
    zero_counts()
    stats = {"checkpoint": checkpoint_round(torch, dev, "checkpoint", None,
                                            ident, infer=True),
             "checkpoint_adam8bit": checkpoint_round(
                 torch, dev, "checkpoint_adam8bit", ADAM8BIT_CONFIG, ident)}
    launches = read_counts()
    for k in CHECKPOINT_KERNELS:
        check(launches[k] > 0, f"checkpoint: {k} never launched on its path")
    print(f"checkpoint: {json.dumps(stats)}; launches {launches}")
    return launches, {}


def phase_train_profile(torch, engine, tokens):
    """One more train step under torch.profiler: device busy share, the top
    kernels, and each training kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_pad()
        t0 = time.perf_counter()
        engine.train_step((tokens, tokens))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        profile_pad()
    # the optimizer's record_function range also shows device time: it is a
    # span over the Adam kernels, not a kernel, so it is left out; copies
    # between the host and the card (offload_dots' side stream, beside the
    # kernels) are counted apart from the busy time
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0
              and not e.key.startswith("Optimizer.")]
    host_copy = [e for e in events if "HtoD" in e.key or "DtoH" in e.key]
    kernels = [e for e in events if e not in host_copy]
    busy = sum(e.self_device_time_total for e in kernels)
    micro, S = tokens.shape[0] // 2, tokens.shape[1]
    copies = "".join(f", {e.key} {e.self_device_time_total / 1e3:.1f} ms over "
                     f"{e.count} copies" for e in host_copy)
    print(f"profile: one train step (gas 2 x micro {micro} x {S}), wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%)"
          f"{copies}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    # device time by kind of kernel: the library's GEMMs (the unaligned
    # head GEMM of an odd vocabulary apart), the port's kernels, PyTorch's
    # elementwise, reduction and copy kernels, whatever is left
    groups = {"GEMM (cuBLAS)": 0.0, "GEMM, unaligned (cutlass align1)": 0.0,
              "flash attention": 0.0, "norm fwd+bwd": 0.0, "rope": 0.0,
              "adam": 0.0, "adam8bit": 0.0, "lamb": 0.0, "dropout": 0.0,
              "PyTorch elementwise/reduce/copy": 0.0, "other": 0.0}
    for e in kernels:
        key = e.key
        if "align1" in key:
            g = "GEMM, unaligned (cutlass align1)"
        elif any(t in key for t in ("nvjet", "gemm", "cutlass", "cublas")):
            g = "GEMM (cuBLAS)"
        elif "flash_" in key:
            g = "flash attention"
        elif "norm_" in key or "rms_dg_reduce" in key:
            g = "norm fwd+bwd"
        elif "rope_kernel" in key:
            g = "rope"
        elif "adam_kernel" in key:
            g = "adam"
        elif "adam8bit_kernel" in key:
            g = "adam8bit"
        elif "lamb_" in key:
            g = "lamb"
        elif "dropout_kernel" in key:
            g = "dropout"
        elif "at::native" in key or "Memcpy" in key or "Memset" in key:
            g = "PyTorch elementwise/reduce/copy"
        else:
            g = "other"
        groups[g] += e.self_device_time_total
    print("profile: device time by kind: " + ", ".join(
        f"{g} {t / 1e3:.1f} ms ({100 * t / busy:.1f}%)"
        for g, t in groups.items() if t))
    tags = {"rms_norm": ("rms_norm_fwd_",), "rope": ("rope_kernel",),
            "rms_norm_bwd": RMS_BWD_KERNELS,
            "layer_norm": ("layer_norm_fwd_",),
            "layer_norm_bwd": ("layer_norm_bwd_", "layer_norm_dgb_sum_kernel"),
            "flash_attention_fwd": FLASH_KERNELS["fwd"],
            "flash_attention_bwd": FLASH_KERNELS["bwd"],
            "flash_attention_fwd_alibi": FLASH_KERNELS["fwd_alibi"],
            "flash_attention_bwd_alibi": FLASH_KERNELS["bwd_alibi"],
            "flash_attention_fwd_f16": FLASH_KERNELS["fwd_f16"],
            "flash_attention_bwd_f16": FLASH_KERNELS["bwd_f16"],
            "fused_adam": ("adam_kernel",),
            "fused_adam8bit": ("adam8bit_kernel",),
            "fused_lamb_phase1": ("lamb_phase1_kernel", "lamb_reduce_kernel"),
            "fused_lamb_scale": ("lamb_scale_kernel",),
            # the forward and the backward launch one kernel: both together
            "dropout": ("dropout_kernel",)}
    out = {}
    for name, keys in tags.items():
        parts = [[e for e in kernels if tag in e.key] for tag in keys]
        n = sum(e.count for e in parts[0])
        out[name] = None
        if not n:                       # not a kernel of this model's path
            continue
        total = sum(e.self_device_time_total for p in parts for e in p)
        out[name] = total / n / 1e3
        split = ""
        if len(parts) > 1 and n:
            split = " (" + " + ".join(
                f"{tag} {sum(e.self_device_time_total for e in p) / n / 1e3:.5f}"
                for tag, p in zip(keys, parts)) + ")"
        print(f"profile: {name} device time per call on the train path "
              f"{out[name]:.5f} ms over {n} calls{split}")
    return out


# ZeRO over torch.distributed: llama-1b4 at stage 3 (threshold 0: every
# leaf a dim divides is sharded) at a world of one, and the stages' check
# at 4 layers of its full width
ZERO3_SECTION = {"zero_optimization": {"stage": 3,
                                       "stage3_param_persistence_threshold": 0}}
# (4 until the overlap phases joined the smoke; cut for its 600 s aim)
ZERO_REFERENCE_LAYERS = 2
# overlap_comm: the layer-bucketed schedule, a bucket a layer
ZERO_OVERLAP = {"overlap_comm": True, "overlap_bucket_layers": 1}


def zero_group(torch):
    """Join a world-one NCCL group over a ``FileStore`` under ``build/``."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"zero_store_{os.getpid()}")
    if os.path.exists(path):
        os.remove(path)
    comm.init_distributed(device="cuda", store=dist.FileStore(path, 1), rank=0,
                          world_size=1, verbose=False)
    check(comm.get_world_size() == 1 and
          dist.get_backend() == "nccl", "zero: not a world-one NCCL group")
    return path


def phase_zero_reference(torch, dev):
    """Stages 0-3 at llama-1b4's full width cut to ZERO_REFERENCE_LAYERS
    layers, TRAIN_CONFIG, 3 steps each from seed 0 on the same tokens:
    stage 0 on the plain path (no process group), then stages 1, 2 and 3
    over a world-one NCCL group, where every collective returns its input
    and the CE weight is 1.0.  Losses, grad norms and masters bit-equal to
    stage 0's; each stage's collectives ran (all_reduce and all_gather from
    stage 1, reduce_scatter and all_to_all from 2: llama's optimizer state
    shards on another dim than most of its grads)."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm

    micro, S = TRAIN_CELLS["llama-1b4"]
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    gen = torch.Generator(device=dev).manual_seed(0)
    ref = None
    store = None
    print(f"zero_reference: llama-1b4 at full width cut to {ZERO_REFERENCE_LAYERS} of "
          f"its 24 layers for the smoke's 600 s aim (zero_overlap_reference too)")
    try:
        for stage in (0, 1, 2, 3):
            if stage == 1:
                store = zero_group(torch)
            model = train_model("llama-1b4", num_layers=ZERO_REFERENCE_LAYERS)
            cfg = model.config
            if ref is None:
                tokens = torch.randint(0, cfg.vocab_size, (gas * micro, S),
                                       device=dev, generator=gen)
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=model, config=dict(TRAIN_CONFIG, zero_optimization={
                    "stage": stage, "stage3_param_persistence_threshold": 0}))
            comm.reset_counters()
            steps = []
            for _ in range(3):
                loss = float(engine.train_step((tokens, tokens)))
                steps.append((loss, engine.get_global_grad_norm()))
            torch.cuda.synchronize()
            counts = comm.counters()
            masters = [t.detach().clone() for _, t in
                       sorted(_flat_tree(engine.params()).items())]
            plan = engine._plan or []
            print(f"zero_reference: stage {stage} ({'plain path' if stage == 0 else 'NCCL world 1'}) "
                  f"losses {[x[0] for x in steps]} grad norms "
                  f"{[x[1] for x in steps]}; leaves sharded: param "
                  f"{sum(p.param for p in plan)}, optimizer state "
                  f"{sum(p.opt for p in plan)}, accumulator {sum(p.acc for p in plan)} "
                  f"of {len(engine.master)}; optimizer slices of their own "
                  f"{sum(engine._own_opt(p) for p in plan)}; collectives "
                  f"{json.dumps(counts)}")
            if stage == 0:
                check(not engine._dist and not counts,
                      "zero_reference: stage 0 without a group ran a collective")
                ref = (steps, masters)
            else:
                check(engine._dist, f"zero_reference: stage {stage} not distributed")
                want = {"all_reduce", "all_gather"} | (
                    {"reduce_scatter", "all_to_all"} if stage >= 2 else set())
                ran = {op for op, c in counts.items() if c["calls"] > 0}
                check(want <= ran, f"zero_reference: stage {stage} ran {ran}, "
                      f"not {want}")
                weight = engine._ce_weight((tokens[:micro], tokens[:micro]))
                check(float(weight) == 1.0, f"zero_reference: CE weight {weight}")
                check(steps == ref[0], f"zero_reference: stage {stage} steps "
                      f"{steps} != stage 0's {ref[0]}")
                bad = [i for i, (a, b) in enumerate(zip(masters, ref[1]))
                       if not torch.equal(a, b)]
                check(not bad, f"zero_reference: stage {stage} masters differ "
                      f"from stage 0's at leaves {bad}")
                print(f"zero_reference: stage {stage} bit-equal to stage 0 "
                      f"(losses, grad norms, {len(masters)} masters)")
            del engine, model, masters
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        comm.destroy()
        if store and os.path.exists(store):
            os.remove(store)
    return {"tokens": tokens, "steps": ref[0], "masters": ref[1]}


def phase_zero_overlap_reference(torch, dev, ref):
    """``overlap_comm`` at stages 1, 2 and 3 over a world-one NCCL group at
    zero_reference's cut (llama-1b4's width, ZERO_REFERENCE_LAYERS layers,
    its tokens), bucket 1 layer: each bit-equal to stage 0's run there
    (losses, grad norms, masters), which the same stage without overlap
    equals (zero_reference); and each micro-batch's per-bucket collectives
    (comm counters) the schedule's plan, op by op in calls and bytes."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm

    tokens = ref["tokens"]
    store = zero_group(torch)
    try:
        for stage in (1, 2, 3):
            model = train_model("llama-1b4", num_layers=ZERO_REFERENCE_LAYERS)
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=model, config=dict(TRAIN_CONFIG, zero_optimization=dict(
                    ZERO_OVERLAP, stage=stage, stage3_param_persistence_threshold=0)))
            check(engine._overlap, f"zero_overlap_reference: stage {stage} took "
                  f"the plain schedule ({engine._overlap_reason})")
            sched = engine._overlap_sched
            steps = []
            for _ in range(3):
                loss = float(engine.train_step((tokens, tokens)))
                steps.append((loss, engine.get_global_grad_norm()))
                check(sched.last_counts == sched.plan_counts(),
                      f"zero_overlap_reference: stage {stage} micro-batch ran "
                      f"{sched.last_counts}, the plan is {sched.plan_counts()}")
            torch.cuda.synchronize()
            masters = [t.detach().clone() for _, t in
                       sorted(_flat_tree(engine.params()).items())]
            check(steps == ref["steps"], f"zero_overlap_reference: stage {stage} "
                  f"steps {steps} != the plain path's {ref['steps']}")
            bad = [i for i, (a, b) in enumerate(zip(masters, ref["masters"]))
                   if not torch.equal(a, b)]
            check(not bad, f"zero_overlap_reference: stage {stage} masters differ "
                  f"from the plain path's at leaves {bad}")
            print(f"zero_overlap_reference: stage {stage}, {len(sched.bucket_infos())} "
                  f"buckets (remat {sched.remat}), bit-equal to the plain path "
                  f"(losses {[x[0] for x in steps]}, grad norms, {len(masters)} "
                  f"masters); a micro-batch's collectives = the plan "
                  f"{json.dumps(sched.plan_counts())}; hideable share "
                  f"{sched.hideable_comm_fraction():.4f}")
            del engine, model, masters
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        comm.destroy()
        if os.path.exists(store):
            os.remove(store)


# comm_quant: the codec of the quantized collectives at llama-1b4's leaves,
# flat as ZeRO++ holds them; the stacked MLP leaf is the largest (276.8M)
COMM_QUANT_LEAVES = ((50304, 2048), (24, 2048, 2048), (24, 2048, 5632),
                     (24, 2048), (2048,))
COMM_QUANT_BIG = (24, 2048, 5632)
COMM_QUANT_RANKS = 4        # the probe's fsdp world: a reduce-scatter's rows
# comm_quantization.block's default, and a block that is no power of two
COMM_QUANT_BLOCKS = (256, 200)
# no TPU kernel: the JAX codec is plain jnp that XLA fuses into each
# collective's program
COMM_QUANT_SITE = "deepspeed_tpu/comm/quant.py:111"
COMM_DEQUANT_SITE = "deepspeed_tpu/comm/quant.py:126"
# the world-one configs of the three quantized paths, over TRAIN_CONFIG, and
# what the JAX engine says of each there
COMM_QUANT_ENGINES = {
    "zeropp": ({"zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 0,
        "zero_quantized_weights": True, "zero_quantized_gradients": True,
        "zero_hpz_partition_size": 2}},
        ["zero_optimization.zero_quantized_weights",
         "zero_optimization.zero_quantized_gradients",
         "zero_optimization.zero_hpz_partition_size"],
        "needs an fsdp mesh axis > 1"),
    "grad_all_reduce": ({"zero_optimization": {"stage": 2},
                         "comm_quantization": {"grad_all_reduce": True,
                                               "error_feedback": True}},
                        ["comm_quantization.grad_all_reduce"],
                        "no data-parallel axis > 1 — there is no all-reduce "
                        "to quantize"),
    "overlap_q": ({"zero_optimization": dict(
        ZERO_OVERLAP, stage=3, stage3_param_persistence_threshold=0),
        "comm_quantization": {"all_gather": True, "reduce_scatter": True}},
        [], None)}


def check_comm_quant(torch, dev):
    """Both codec kernels against their plain versions, bit for bit: at
    each of COMM_QUANT_LEAVES flat, fp32 and bf16, each block of
    COMM_QUANT_BLOCKS, as one row (a gather's shard: dequantized back) and
    as COMM_QUANT_RANKS destination rows (a reduce-scatter's: summed over
    the rows in fp32, and concatenated in the input's dtype with each row's
    padding stripped), and the error-feedback form (the input less its
    codes times their scales); the first block of each input zeros (scale
    0)."""
    from deepspeed_tpu_torch.ops.kernels import comm_quant as kq

    gen = torch.Generator(device=dev).manual_seed(13)
    P = COMM_QUANT_RANKS
    checked = 0
    for shape in COMM_QUANT_LEAVES:
        x32 = _randn(torch, shape, gen, dev).reshape(-1)
        x32.mul_(torch.exp(_randn(torch, (x32.numel() // 2048 + 1,), gen, dev)
                           ).repeat_interleave(2048)[:x32.numel()])
        x32[:max(COMM_QUANT_BLOCKS)] = 0.0
        n = x32.numel()
        for name in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, name))
            for block in COMM_QUANT_BLOCKS:
                for rows in (1, P):
                    what = f"comm_quant {name} {list(shape)} block {block} rows {rows}"
                    q, s = kq.quantize_blockwise_cuda(x, block, rows)
                    qp, sp = kq.quantize_blockwise_plain(x, block, rows)
                    check(torch.equal(q, qp) and torch.equal(s, sp),
                          f"{what}: quantize kernel != plain")
                    del qp, sp
                    keep = n // rows
                    outs = ([(True, torch.float32), (False, x.dtype)] if rows > 1
                            else [(False, torch.float32)])
                    for add, dt in outs:
                        got = kq.dequantize_blockwise_cuda(q, s, keep, add, dt)
                        want = kq.dequantize_blockwise_plain(q, s, keep, add, dt)
                        check(torch.equal(got, want), f"{what}: dequantize "
                              f"(sum {add}, {dt}) kernel != plain")
                        checked += 1
                    # the error-feedback residual of the input's codes
                    base = x32 if name == "float32" else x.float()
                    got = kq.dequantize_error_cuda(base, q, s)
                    want = kq.dequantize_error_plain(base, q, s)
                    check(torch.equal(got, want), f"{what}: dequantize_error "
                          "kernel != plain")
                    checked += 1
                    del q, s, got, want, base
            del x
        del x32
        torch.cuda.empty_cache()
    print(f"kernels vs plain: comm_quant quantize_blockwise and dequantize_blockwise "
          f"(its sum, concatenation and error forms) bit-equal ({checked} dequantize "
          f"checks) at llama-1b4's leaves "
          f"{[list(s) for s in COMM_QUANT_LEAVES]} flat, fp32 and bf16, blocks "
          f"{list(COMM_QUANT_BLOCKS)}, as 1 row and as {P} destination rows "
          f"(summed over them, and concatenated)")
    return {"quantize_blockwise": 0.0, "dequantize_blockwise": 0.0}


def time_comm_quant(torch, dev, errs):
    """The codec at the stacked MLP leaf [24, 2048, 5632], block 256: the
    quantizer on fp32 grads as COMM_QUANT_RANKS destination rows (qgZ's
    reduce-scatter) and on the bf16 shard as one row (qwZ's gather); the
    dequantizer summing the 4 sources' codes into fp32 (the reduce side)
    and concatenating them in bf16 (the gather side), and its error form
    on the fp32 grads (q_all_reduce's residual).  Call ms under CUDA
    events (one launch a call, of 0.2-1 ms: no profiler window, whose
    records some processes lose), the plain version, and the bytes bound:
    each input read once, each output written once (4 bytes a block's
    scale)."""
    from deepspeed_tpu_torch.ops.kernels import comm_quant as kq

    gen = torch.Generator(device=dev).manual_seed(14)
    P, block = COMM_QUANT_RANKS, COMM_QUANT_BLOCKS[0]
    g = _randn(torch, COMM_QUANT_BIG, gen, dev).reshape(-1)
    w = g.to(torch.bfloat16)
    n = g.numel()
    nb = n // block                   # every row whole blocks here
    q, s = kq.quantize_blockwise_cuda(g, block, P)
    shape = f"fp32 {list(COMM_QUANT_BIG)} as {P} rows, block {block}"

    def timed(call, plain):
        return (time_ms(torch, call, samples=10, inner=5, warmup=3),
                time_ms(torch, plain, samples=3, inner=1, warmup=1))

    out = {}
    ms, plain = timed(lambda: kq.quantize_blockwise_cuda(g, block, P),
                      lambda: kq.quantize_blockwise_plain(g, block, P))
    b_ms, b_by = bound_ms(4 * n + n + 4 * nb, 0)
    bf_ms, bf_plain = timed(lambda: kq.quantize_blockwise_cuda(w, block),
                            lambda: kq.quantize_blockwise_plain(w, block))
    bf_b, _ = bound_ms(2 * n + n + 4 * nb, 0)
    out["quantize_blockwise"] = {
        "shape": shape, "ms": ms, "plain_ms": plain, "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["quantize_blockwise"],
        "bf16_shape": f"bf16 {list(COMM_QUANT_BIG)} as 1 row", "bf16_ms": bf_ms,
        "bf16_plain_ms": bf_plain, "bf16_bound_ms": bf_b}
    keep = n // P
    ms, plain = timed(lambda: kq.dequantize_blockwise_cuda(q, s, keep, True),
                      lambda: kq.dequantize_blockwise_plain(q, s, keep, True))
    b_ms, b_by = bound_ms(n + 4 * nb + 4 * keep, 0)
    cat_ms, cat_plain = timed(
        lambda: kq.dequantize_blockwise_cuda(q, s, keep, False, torch.bfloat16),
        lambda: kq.dequantize_blockwise_plain(q, s, keep, False, torch.bfloat16))
    cat_b, _ = bound_ms(n + 4 * nb + 2 * n, 0)
    err_ms, err_plain = timed(lambda: kq.dequantize_error_cuda(g, q, s),
                              lambda: kq.dequantize_error_plain(g, q, s))
    err_b, _ = bound_ms(n + 4 * nb + 4 * n + 4 * n, 0)
    out["dequantize_blockwise"] = {
        "shape": f"int8 codes of {shape}, summed over the {P} sources into fp32",
        "ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
        "bound_by": b_by, "max_abs_err": errs["dequantize_blockwise"],
        "concat_shape": f"the same {P} sources concatenated in bf16",
        "concat_ms": cat_ms, "concat_plain_ms": cat_plain, "concat_bound_ms": cat_b,
        "error_shape": "the error form on the fp32 grads and their codes",
        "error_ms": err_ms, "error_plain_ms": err_plain, "error_bound_ms": err_b}
    for name, r in out.items():
        extra = ("bf16", r["bf16_ms"], r["bf16_plain_ms"], r["bf16_bound_ms"]) \
            if name == "quantize_blockwise" else \
            ("concat bf16", r["concat_ms"], r["concat_plain_ms"], r["concat_bound_ms"])
        print(f"time {name} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library none, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f} % of it; "
              f"{extra[0]}: kernel {extra[1]:.5f} ms, plain {extra[2]:.5f} ms, "
              f"bound {extra[3]:.6f} ms"
              + (f"; error form: kernel {r['error_ms']:.5f} ms, plain "
                 f"{r['error_plain_ms']:.5f} ms, bound {r['error_bound_ms']:.6f} ms"
                 if "error_ms" in r else ""))
    del g, w, q, s
    torch.cuda.empty_cache()
    return out


def phase_comm_quant(torch, dev, ref):
    """The codec's kernels checked and timed; then, over the world-one NCCL
    group, ``q_all_gather_flat`` (a bf16 shard of the MLP leaf, as qwZ
    gathers) and ``q_reduce_scatter_flat`` (its fp32 grads, as qgZ
    scatters) with the launch counts set to 0 just before and read just
    after (each quantizes once and dequantizes once), each result equal to
    the plain codec's round trip of the same input, and their wire bytes
    beside the dense twin's; then ``initialize`` with each of
    COMM_QUANT_ENGINES at zero_reference's cut, one step on its tokens:
    the inert keys and reasons of the JAX engine's gates at world 1, no
    codec launch, and the step's loss and grad norm bit-equal to the plain
    path's first.  Returns (the codec's timings, the path's launches)."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import collectives_q as cq
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops.kernels import comm_quant as kq

    timings = time_comm_quant(torch, dev, check_comm_quant(torch, dev))
    gen = torch.Generator(device=dev).manual_seed(15)
    block = COMM_QUANT_BLOCKS[0]
    g = _randn(torch, COMM_QUANT_BIG, gen, dev).reshape(-1)
    w = g.to(torch.bfloat16)
    n = g.numel()
    store = zero_group(torch)
    try:
        comm.reset_counters()
        zero_counts()
        gathered = cq.q_all_gather_flat(w, None, block=block)
        reduced = cq.q_reduce_scatter_flat(g, None, block=block)
        torch.cuda.synchronize()
        launches = read_counts()
        qc = comm.q_counters()
        check(launches["quantize_blockwise"] == 2 and launches["dequantize_blockwise"] == 2
              and sum(launches.values()) == 4,
              f"comm_quant: the collectives launched {launches}")
        qw, sw = kq.quantize_blockwise_plain(w, block)
        check(torch.equal(gathered, kq.dequantize_blockwise_plain(qw, sw, n)),
              "comm_quant: q_all_gather_flat != the plain codec's round trip")
        qg, sg = kq.quantize_blockwise_plain(g, block)
        check(torch.equal(reduced, kq.dequantize_blockwise_plain(qg, sg, n, True)),
              "comm_quant: q_reduce_scatter_flat != the plain codec's round trip")
        del gathered, reduced, qw, sw, qg, sg
        print(f"comm_quant: q_all_gather_flat (bf16 {list(COMM_QUANT_BIG)}) and "
              f"q_reduce_scatter_flat (fp32) over NCCL at world 1 equal the plain "
              f"codec's round trip; launches {launches['quantize_blockwise']} "
              f"quantize, {launches['dequantize_blockwise']} dequantize; wire "
              + "; ".join(f"{op} {r['bytes']} B against the dense twin's "
                          f"{r['dense_bytes']} B ({r['dense_dtype']})"
                          for op, r in sorted(qc.items())))
        tokens = ref["tokens"]
        for name, (section, inert, reason) in COMM_QUANT_ENGINES.items():
            model = train_model("llama-1b4", num_layers=ZERO_REFERENCE_LAYERS)
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=model, config=dict(TRAIN_CONFIG, **section))
            check(engine._inert_config_keys == inert,
                  f"comm_quant {name}: inert keys {engine._inert_config_keys}, "
                  f"the JAX engine's {inert}")
            if name == "zeropp":
                got = (engine._zeropp, engine._zeropp_reason)
            elif name == "grad_all_reduce":
                got = (engine._qcomm_grads, engine._qcomm_grads_reason)
            else:
                qopts = engine._overlap_sched.qcomm
                got = (qopts.all_gather or qopts.reduce_scatter, None)
                check(engine._overlap, f"comm_quant {name}: not on the overlap "
                      f"schedule ({engine._overlap_reason})")
            check(got == (False, reason), f"comm_quant {name}: gate {got}, the "
                  f"JAX engine's (False, {reason!r})")
            zero_counts()
            loss = float(engine.train_step((tokens, tokens)))
            step = (loss, engine.get_global_grad_norm())
            torch.cuda.synchronize()
            codec = (kq.quantize_blockwise.launches, kq.dequantize_blockwise.launches)
            check(codec == (0, 0), f"comm_quant {name}: the codec launched {codec} "
                  "at world 1")
            check(step == ref["steps"][0], f"comm_quant {name}: step {step} != the "
                  f"plain path's {ref['steps'][0]}")
            print(f"comm_quant: {name} at world 1 inert as in the JAX engine "
                  f"(keys {inert}, reason {reason!r}); step 1 bit-equal to the "
                  f"plain path: loss {step[0]}, grad norm {step[1]}")
            del engine, model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        comm.destroy()
        if os.path.exists(store):
            os.remove(store)
    del g, w
    return timings, launches


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat_tree(v, path) if isinstance(v, dict) else {path: v})
    return out


def phase_zero_overlap_train(torch, dev, peaks, medians):
    """zero_train's cell with ``overlap_comm`` (bucket 1 layer): llama-1b4
    at full width and depth at stage 3 over a world-one NCCL group, where
    each collective is a copy: it proves the bucketed schedule at scale (a
    micro-batch's collectives the plan, the layer buckets' recompute in the
    launch plan) and shows its cost; no communication can hide on one
    card.  Its median step, MFU and peak are printed beside zero_train's."""
    from deepspeed_tpu_torch.comm import comm

    seen = []
    store = zero_group(torch)
    try:
        def on_step(engine):
            sched = engine._overlap_sched
            seen.append(sched.last_counts == sched.plan_counts())

        def report(engine, info):
            sched = engine._overlap_sched
            check(engine._overlap and all(seen), "zero_overlap_train: a "
                  f"micro-batch's collectives left the plan {sched.plan_counts()}")
            mfu = 100 * info["flops"] / info["median"] / BF16_FLOPS_PER_S
            zt = medians.get("zero_train", float("nan"))
            print(f"zero_overlap_train: {len(sched.bucket_infos())} buckets, "
                  f"median step {info['median']:.4f}s, MFU {mfu:.2f}%, peak "
                  f"{info['peak_gib']:.2f} GiB, beside zero_train's median "
                  f"{zt:.4f}s (peak {peaks.get('zero_train', float('nan')):.2f} GiB) "
                  f"and train's {medians.get('train', float('nan')):.4f}s; a "
                  f"micro-batch's collectives {json.dumps(sched.plan_counts())}, "
                  f"hideable share {sched.hideable_comm_fraction():.4f} (a world "
                  f"of one: every collective a copy)")

        out = phase_train(torch, dev, "llama-1b4", "zero_overlap_train",
                          {"zero_optimization": dict(ZERO3_SECTION["zero_optimization"],
                                                     **ZERO_OVERLAP)},
                          peaks, medians, on_step=on_step, report=report)
    finally:
        comm.destroy()
        if os.path.exists(store):
            os.remove(store)
    return out


def phase_zero_train(torch, dev, peaks, medians):
    """llama-1b4 at full width and depth at stage 3 over a world-one NCCL
    group (phase_train with ZERO3_SECTION): its steps, tokens/s, MFU,
    peak, launches against the train plan and profile, and the
    collectives' calls and bytes a step (the difference of the counters
    after the last two steps)."""
    from deepspeed_tpu_torch.comm import comm

    snaps = []
    store = zero_group(torch)
    try:
        comm.reset_counters()
        out = phase_train(torch, dev, "llama-1b4", "zero_train", ZERO3_SECTION,
                          peaks, medians,
                          on_step=lambda engine: snaps.append(comm.counters()),
                          report=lambda engine, info: print(
                              f"zero_train: leaves sharded: param "
                              f"{sum(p.param for p in engine._plan)}, optimizer "
                              f"state {sum(p.opt for p in engine._plan)}, "
                              f"accumulator {sum(p.acc for p in engine._plan)} of "
                              f"{len(engine._plan)}; optimizer slices of their own "
                              f"{sum(engine._own_opt(p) for p in engine._plan)} "
                              f"({sum(t.numel() for p, t in zip(engine._plan, engine._opt_params) if engine._own_opt(p)) * 4 / 2**30:.2f} GiB fp32)"))
    finally:
        comm.destroy()
        if os.path.exists(store):
            os.remove(store)
    last, prev = snaps[-1], snaps[-2]
    step = {op: {k: last[op][k] - prev.get(op, {}).get(k, 0) for k in ("calls", "bytes")}
            for op in last}
    check(all(step.get(op, {}).get("calls", 0) > 0
              for op in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")),
          f"zero_train: a collective did not run in a step: {step}")
    print(f"zero_train: collectives a step {json.dumps(step)}, "
          f"{sum(v['bytes'] for v in step.values()) / 1e9:.3f} GB in all "
          f"(NCCL at a world of one: each a copy on the card)")
    return out


# ZeRO-Offload of the optimizer state (zero_optimization.offload_optimizer):
# the fp32 masters and moments on the host, stepped by the host C++ Adam
ZERO_OFFLOAD = {"zero_optimization": {"stage": 0, "offload_optimizer": {
    "device": "cpu"}}}
ADAMW_SECTION = {"optimizer": dict(TRAIN_CONFIG["optimizer"], type="AdamW")}
# host bytes a parameter: the fp32 master and two fp32 moments; the relay's
# bf16 grad staging; and what the bf16-grad Adam step moves (reads p, m, v
# and a bf16 grad, writes p, m, v and a bf16 param)
HOST_STATE_BYTES, GRAD_STAGE_BYTES, BF16G_STEP_BYTES = 12, 2, 28
# zero_offload_nvme's depth: llama-1b4 cut to 1 layer for the smoke's
# 600 s aim; its save and verified load hash every byte on one core
NVME_LAYERS = 1
# zero_offload_train's depth for the smoke's 600 s aim (host memory alone
# allows ~25 of 32): param_offload_train carries llama2-7b and the host
# AdamW at scale
ZERO_OFFLOAD_TRAIN_LAYERS = 2
# the bloom fp16 legs' applied steps, for the smoke's 600 s aim (the host
# step of bloom-1b7 takes ~3.5 s)
BLOOM_FP16_STEPS = 3
NVME_AIO_THREADS = 4     # of the host's 8 cores; the aio section's default is 1


def host_memory():
    """(MemTotal, MemAvailable) of /proc/meminfo in bytes, and the cores."""
    vals = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                vals[key] = int(val.split()[0]) * 1024
    return vals["MemTotal"], vals["MemAvailable"], os.cpu_count()


def process_rss():
    """This process's resident host memory in bytes (/proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def offload_host_bytes(preset, layers):
    """Host bytes a bf16 offload run of ``preset`` at ``layers`` holds:
    the host states, the relay's grad staging, and its two H2D buffers of
    the largest leaf in bf16; with the parameter count."""
    from deepspeed_tpu_torch.models.config import get_model_config
    from deepspeed_tpu_torch.models.transformer import param_shapes

    def sizes(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from sizes(v)
            else:
                yield math.prod(v[0])

    leaves = list(sizes(param_shapes(get_model_config(preset, num_layers=layers))))
    n = sum(leaves)
    return (HOST_STATE_BYTES + GRAD_STAGE_BYTES) * n + 2 * 2 * max(leaves), n


def phase_zero_offload_reference(torch, dev):
    """The llama-tiny preset (D 256, 8 heads of 32, 4 layers, vocab 32000)
    with ``offload_optimizer: cpu``, 3 fp32 steps on the card and on the
    CPU from the same weights and tokens: losses within rtol 1e-4 and the
    host masters within atol 1e-4, the bounds of phase_train_reference;
    then the card with ``nvme`` (a temporary directory): its host masters
    and losses bit-equal to the card's cpu backend."""
    import shutil
    import tempfile

    import numpy as np

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(TRAIN_CONFIG, **ZERO_OFFLOAD, **ADAMW_SECTION,
               bf16={"enabled": False}, train_micro_batch_size_per_gpu=2)
    tok = np.random.default_rng(0).integers(0, 32000, (4, 200))
    root = tempfile.mkdtemp(prefix="ds_swap_")
    nvme = dict(cfg, zero_optimization={"stage": 0, "offload_optimizer": {
        "device": "nvme", "nvme_path": root}})
    runs = {}
    try:
        for name, d, c in (("cpu", "cpu", cfg), ("card", dev, cfg),
                           ("card nvme", dev, nvme)):
            model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", seed=0)
            engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=c,
                                                        device=d)
            check(engine._offload_opt.backend == c["zero_optimization"][
                "offload_optimizer"]["device"], f"{name}: backend")
            losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
            runs[name] = (losses, [m.clone() for m in engine._offload_opt.masters()])
            del engine, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (lc, pc), (lg, pg), (ln, pn) = runs["cpu"], runs["card"], runs["card nvme"]
    check(all(math.isfinite(x) for x in lg) and lg[-1] < lg[0],
          f"zero_offload_reference: card losses {lg}")
    for a, b in zip(lc, lg):
        check(abs(a - b) <= 1e-4 * abs(a), f"zero_offload_reference: card vs CPU "
              f"losses {lg} vs {lc}")
    diff = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(diff <= 1e-4, f"zero_offload_reference: card vs CPU host masters "
          f"differ by {diff}")
    check(ln == lg and all(torch.equal(a, b) for a, b in zip(pn, pg)),
          f"zero_offload_reference: nvme {ln} against cpu backend {lg}")
    print(f"reference: zero_offload_reference, the llama-tiny preset (L 4, D 256, "
          f"V 32000, S 200) with offload_optimizer cpu (host C++ AdamW), 3 fp32 "
          f"steps, card == CPU: losses {lg} vs {lc}, host masters max abs diff "
          f"{diff:.3g}; nvme backend on the card bit-equal to the cpu backend "
          f"(losses {ln}, every host master)")


def phase_zero_offload_train(torch, dev, peaks, medians, keep=None):
    """llama2-7b at full width (D 4096, 32/32 heads, F 11008, vocab 32000),
    bf16 compute over fp32 host masters (host C++ AdamW), WarmupLR,
    clipping 1.0, micro 2 x gas 2 x S 2048, remat full, 4 steps.  The
    deepest depth whose host states (12 B a parameter) and relay staging
    fit in 80 % of MemAvailable, at most ZERO_OFFLOAD_TRAIN_LAYERS (each
    cut printed with its reason).  Prints each step's split (fwd/bwd, D2H, host step,
    H2D), the host step's rate at 28 B a parameter, tokens/s, MFU, peak
    device memory and host state bytes, and what FusedAdam would hold on
    the card at the same depth (computed, not run); checks that the card
    holds no optimizer state and that no relay buffer was reused before its
    copy landed."""
    import gc

    gc.collect()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()     # pinned blocks cached by earlier phases
    ident = gpu_identity()
    total, avail, cores = host_memory()
    full = 32
    budget = 0.8 * avail
    need_full, n_full = offload_host_bytes("llama2-7b", full)
    layers = full
    while layers > 1 and offload_host_bytes("llama2-7b", layers)[0] > budget:
        layers -= 1
    fits = layers
    layers = min(layers, ZERO_OFFLOAD_TRAIN_LAYERS)
    need, n = offload_host_bytes("llama2-7b", layers)
    check(need <= budget, f"zero_offload_train: even 1 layer needs {need} B of "
          f"host memory against {budget:.0f}")
    print(f"zero_offload_train: {ident}; host MemTotal {total} B "
          f"({total / 2**30:.2f} GiB), MemAvailable {avail} B "
          f"({avail / 2**30:.2f} GiB), {cores} cores")
    if layers < fits:
        print(f"zero_offload_train: depth cut {full} -> {layers} layers for the "
              f"smoke's 600 s aim (param_offload_train carries llama2-7b and the "
              f"host AdamW at scale); the host would hold {fits} "
              f"({layers} layers need {need / 1e9:.2f} GB)")
    elif layers < full:
        print(f"zero_offload_train: depth cut {full} -> {layers} layers: at "
              f"{full} layers the host states ({HOST_STATE_BYTES} B x "
              f"{n_full / 1e9:.4f}B params) and the relay's staging need "
              f"{need_full / 1e9:.2f} GB, more than 80 % of MemAvailable "
              f"({budget / 1e9:.2f} GB); {layers} layers need {need / 1e9:.2f} GB")
    else:
        print(f"zero_offload_train: all {full} layers: {need / 1e9:.2f} GB of host "
              f"states and staging within 80 % of MemAvailable ({budget / 1e9:.2f} GB)")
    splits = []
    out = {}

    def on_step(engine):
        splits.append(engine.offload_split())

    def report(engine, info):
        opt = engine._offload_opt
        dev_bytes = sum(p.numel() * p.element_size()
                        for p in engine.master + engine.grad_acc)
        allocated = torch.cuda.memory_allocated(dev)
        check(allocated <= dev_bytes + 2**28,
              f"zero_offload_train: {allocated} B on the card, params and "
              f"accumulator are {dev_bytes} B: something else stayed there")
        check(all(not t.is_cuda for t in opt.masters()) and not engine.master[0].dtype
              == torch.float32, "zero_offload_train: a master on the card")
        log = engine._relay.reuse_log
        check(log and all(after for *_, after in log),
              f"zero_offload_train: a relay buffer reused before its copy "
              f"landed: {log[:4]}")
        waited = sum(not fired for _, _, fired, _ in log)
        for k, sp in enumerate(splits, 1):
            wall = info["steps"][k - 1][3] * 1e3
            print(f"zero_offload_train: step {k} split ms: fwd/bwd "
                  f"{wall - sp['step']:.1f}, apply {sp['step']:.1f} = prep "
                  f"{sp['prep']:.1f} + D2H wait {sp.get('d2h_wait', 0):.1f} "
                  f"(device span {sp.get('d2h_ms', float('nan')):.1f}) + host step "
                  f"{sp['host_step']:.1f} + H2D issue {sp.get('h2d_issue', 0):.1f} "
                  f"+ H2D wait {sp.get('h2d_wait', 0):.1f} (device span "
                  f"{sp.get('h2d_ms', float('nan')):.1f}); wall {wall:.1f}")
        host_s = statistics.mean(sp["host_step"] for sp in splits[1:]) / 1e3
        n_p = info["n_params"]
        rate = BF16G_STEP_BYTES * n_p / host_s / 1e9
        act = info["peak_gib"] * 2**30 - dev_bytes
        fused = 16 * n_p + 2 * n_p + act
        out.update(host_step_s=host_s, host_gbs=rate, state_bytes=opt.state_bytes(),
                   fused_bytes=fused, layers=layers, pinned=engine._relay.pinned_bytes())
        if keep is not None:     # for zero_offload_stage2's bit-equality
            keep.update(layers=layers, host_step_s=host_s,
                        steps=[(x[0], x[1]) for x in info["steps"]],
                        masters=[m.clone() for m in opt.masters()],
                        params=[m.detach().cpu() for m in engine.master])
        print(f"zero_offload_train: {ident}, {cores} cores, MemTotal "
              f"{total / 2**30:.2f} GiB: host step (mean of steps 2-{len(splits)}) "
              f"{host_s * 1e3:.1f} ms over {n_p / 1e9:.4f}B params = "
              f"{rate:.2f} GB/s at {BF16G_STEP_BYTES} B a parameter "
              f"(ds_adam_step_bf16g over {opt._stepper._pool._max_workers} "
              f"threads); host state {opt.state_bytes()} B "
              f"({opt.state_bytes() / n_p:.1f} a parameter), relay staging "
              f"{engine._relay.pinned_bytes()} B pinned; card: {dev_bytes} B of "
              f"bf16 params and fp32 accumulator, peak {info['peak_gib']:.2f} GiB; "
              f"FusedAdam at this depth would hold {fused / 2**30:.2f} GiB on the "
              f"card (16 B a parameter of fp32 masters, moments and accumulator, "
              f"2 B of bf16 compute copy, {act / 2**30:.2f} GiB of activations "
              f"as measured here); relay buffers reused {len(log)} times, each "
              f"after its copy landed ({waited} waited for it)")

    section = dict(ZERO_OFFLOAD, **ADAMW_SECTION)
    launches, device_ms = phase_train(
        torch, dev, "llama2-7b", "zero_offload_train", section, peaks, medians,
        model_over={"num_layers": layers}, steps_wanted=4, profile=False,
        on_step=on_step, report=report)
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()     # give the pinned staging back
    return launches, device_ms


def phase_zero_offload_stage2(torch, dev, peaks, medians, ref):
    """zero_offload_train's llama2-7b leg (``ref``: its depth, steps, host
    masters and card params) at ZeRO stage 2 over a world-one NCCL group,
    cpu offload: the host optimizer steps this rank's slices (the whole
    leaves at a world of one), the accumulator reduce-scattered, the
    updated slices gathered into the bf16 compute copy.  Bit-equal to the
    stage-0 run: each step's loss and grad norm, every host master and
    card param.  Prints the host step's time beside stage 0's."""
    import gc

    from deepspeed_tpu_torch.comm import comm

    gc.collect()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()
    splits = []

    def report(engine, info):
        opt = engine._offload_opt
        check(engine._dist and engine.zero_stage == 2 and engine._offload,
              "zero_offload_stage2: not the stage-2 offload path")
        steps = [(x[0], x[1]) for x in info["steps"]]
        check(steps == ref["steps"], f"zero_offload_stage2: steps {steps} != "
              f"stage 0's {ref['steps']}")
        bad = [i for i, (a, b) in enumerate(zip(opt.masters(), ref["masters"]))
               if not torch.equal(a, b)]
        check(not bad, f"zero_offload_stage2: host masters differ from stage 0's "
              f"at leaves {bad}")
        bad = [i for i, (a, b) in enumerate(zip(engine.master, ref["params"]))
               if not torch.equal(a.cpu(), b)]
        check(not bad, f"zero_offload_stage2: card params differ at leaves {bad}")
        host_s = statistics.mean(sp["host_step"] for sp in splits[1:]) / 1e3
        print(f"zero_offload_stage2: llama2-7b L{ref['layers']} at stage 2 over "
              f"NCCL world 1, bit-equal to zero_offload_train's stage 0 (losses "
              f"{[x[0] for x in steps]}, grad norms, {len(ref['masters'])} host "
              f"masters, the card's bf16 params); host step {host_s * 1e3:.1f} ms "
              f"against stage 0's {ref['host_step_s'] * 1e3:.1f} ms; host state "
              f"{opt.state_bytes()} B; median step {info['median']:.4f}s")

    store = zero_group(torch)
    try:
        section = {"zero_optimization": {"stage": 2, "offload_optimizer": {
            "device": "cpu"}}, **ADAMW_SECTION}
        out = phase_train(torch, dev, "llama2-7b", "zero_offload_stage2", section,
                          peaks, medians, model_over={"num_layers": ref["layers"]},
                          steps_wanted=4, profile=False,
                          on_step=lambda engine: splits.append(engine.offload_split()),
                          report=report)
    finally:
        comm.destroy()
        if os.path.exists(store):
            os.remove(store)
        if hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()
    ref.clear()
    return out


# ZeRO-Infinity (offload_param): the params and the grads in host memory too
PARAM_OFFLOAD = {"zero_optimization": {
    "stage": 0, "offload_optimizer": {"device": "cpu"},
    "offload_param": {"device": "cpu"}}}
# host bytes a parameter under offload_param: the fp32 master and two fp32
# moments, the compute-dtype (bf16) host copy, the fp32 accumulator
PARAM_OFFLOAD_HOST_BYTES = 12 + 2 + 4
# the reference's extra depth: the peak must not grow by more than the
# extra layers' boundary activations
PARAM_OFFLOAD_DEEP_LAYERS = 8
# param_offload_train's depth for the smoke's 600 s aim beside the zero phases (host
# memory holds ~20 of 32 layers; each took ~0.6 s of a step's 12 s)
PARAM_OFFLOAD_TRAIN_LAYERS = 12
PEAK_ROUNDING = 4 << 20


def streamed_plan(cfg, micros):
    """Launches a streamed (``offload_param``) run must make.  Per
    micro-batch: the forward loop's 2L norm forwards, the head's final norm
    (forward and backward), each layer's backward recomputing its forward
    under autograd whatever the remat policy (2L norm forwards more, L flash
    forwards, L RoPEs) and then its backward (2L norm backwards, L flash
    backwards, L RoPE backwards); one more LayerNorm each way for an
    embedding norm; dropout twice a layer in each forward and twice a layer
    backward.  No optimizer kernel: the host C++ Adam steps."""
    L = cfg.num_layers
    rope = cfg.position == "rope"
    plan = {k: 0 for k in KERNELS}
    plan[norm_kernel(cfg)] = (4 * L + 1) * micros
    plan[norm_kernel(cfg) + "_bwd"] = (2 * L + 1) * micros
    if cfg.embed_norm:
        plan["layer_norm"] += 2 * micros
        plan["layer_norm_bwd"] += micros
    plan["rope"] = 3 * L * micros * rope
    flash = "flash_attention_{}" + ("_alibi" if cfg.position == "alibi" else "")
    plan[flash.format("fwd")] = 2 * L * micros
    plan[flash.format("bwd")] = L * micros
    if cfg.dropout > 0:
        plan["dropout"] = 4 * L * micros
        plan["dropout_bwd"] = 2 * L * micros
    return plan


def phase_param_offload_reference(torch, dev):
    """The llama-tiny preset (D 256, 8 heads of 32, 4 layers, vocab 32000,
    S 200) with ``offload_param`` + ``offload_optimizer`` cpu, 3 fp32 steps
    of gas 2 (AdamW, WarmupLR, clipping 1.0), on the card and on the CPU
    from the same weights and tokens: losses within rtol 1e-4 and the host
    masters within atol 1e-4 (phase_train_reference's bounds); on the card
    prefetch off bit-equal to prefetch on; with ``int8_masters`` +
    ``int8_stream`` the card against the CPU within rtol 1e-3 and the h2d
    bytes at least 1.3x below a bf16 relay's for the same transfers (half
    the dense fp32 run's); every slot reused only after its readers' event
    (the copy's start event after it); launches equal to the streamed plan.
    No model-sized buffer on the card: the preset's params are 85 % token
    table and head, whose segment alone (the head, its grads, the logits)
    outweighs the params, so the check is that the peak does not grow with
    depth: the same run at PARAM_OFFLOAD_DEEP_LAYERS layers peaks within
    the extra layers' boundary activations of the 4-layer run, plus
    PEAK_ROUNDING for the caching allocator (a large block is not split
    when the rest would be 1 MiB or less, so a peak moves by up to that
    much an allocation), where a whole-program step would add their params
    and grads (11.6 MB of each here)."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.config import get_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(TRAIN_CONFIG, **ADAMW_SECTION, bf16={"enabled": False},
                train_micro_batch_size_per_gpu=2)
    tok = np.random.default_rng(0).integers(0, 32000, (4, 200))
    int8 = {"zero_optimization": {
        "stage": 0, "offload_optimizer": {"device": "cpu", "int8_masters": True},
        "offload_param": {"device": "cpu", "int8_stream": True}}}
    no_prefetch = {"zero_optimization": dict(PARAM_OFFLOAD["zero_optimization"],
                                             offload_param={"device": "cpu",
                                                            "prefetch": False})}
    runs = {}
    for name, d, over, layers in (("cpu", "cpu", PARAM_OFFLOAD, 4),
                                  ("card", dev, PARAM_OFFLOAD, 4),
                                  ("card no prefetch", dev, no_prefetch, 4),
                                  ("cpu int8", "cpu", int8, 4),
                                  ("card int8", dev, int8, 4),
                                  ("card deep", dev, PARAM_OFFLOAD,
                                   PARAM_OFFLOAD_DEEP_LAYERS)):
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", seed=0,
                                              num_layers=layers)
        engine = deepspeed_tpu_torch.initialize(model=model, config=dict(base, **over),
                                                device=d)[0]
        check(engine._streamed is not None, f"{name}: not streamed")
        on_card = d != "cpu"
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        st = engine._streamed.streamer
        run = {"losses": losses, "h2d": st.h2d_bytes,
               "masters": [m.clone() for m in engine._offload_opt.masters()],
               "hits": (st.prefetch_hits, st.prefetch_misses)}
        if on_card:
            torch.cuda.synchronize(dev)
            run["peak"] = torch.cuda.max_memory_allocated(dev)
            run["launches"] = read_counts()
            gaps = st.reuse_gaps_ms()
            check(len(gaps) == len(st.reuse_log) and gaps
                  and min(gaps) >= 0, f"param_offload_reference {name}: a slot "
                  f"reused before its readers' event: {gaps[:8]}")
            run["gaps"] = gaps
            run["param_bytes"] = sum(m.numel() for m in engine.master) * 4
            run["boundary"] = 2 * 200 * model.config.hidden_size * 4
        runs[name] = run
        del engine, model, st
    lc, lg = runs["cpu"]["losses"], runs["card"]["losses"]
    check(all(math.isfinite(x) for x in lg) and lg[-1] < lg[0],
          f"param_offload_reference: card losses {lg}")
    for a, b in zip(lc, lg):
        check(abs(a - b) <= 1e-4 * abs(a), f"param_offload_reference: card vs "
              f"CPU losses {lg} vs {lc}")
    diff = max(float((a - b).abs().max()) for a, b in
               zip(runs["cpu"]["masters"], runs["card"]["masters"]))
    check(diff <= 1e-4, f"param_offload_reference: card vs CPU host masters "
          f"differ by {diff}")
    off = runs["card no prefetch"]
    check(off["losses"] == lg and all(torch.equal(a, b) for a, b in
                                      zip(off["masters"], runs["card"]["masters"])),
          f"param_offload_reference: prefetch off {off['losses']} against on {lg}")
    takes = 6 * (2 * 4 - 1)
    check(runs["card"]["hits"] == (takes, 0) and off["hits"] == (0, takes),
          f"param_offload_reference: prefetch hits/misses {runs['card']['hits']} "
          f"(on), {off['hits']} (off)")
    li, lci = runs["card int8"]["losses"], runs["cpu int8"]["losses"]
    for a, b in zip(lci, li):
        check(abs(a - b) <= 1e-3 * abs(a), f"param_offload_reference: int8 card "
              f"vs CPU losses {li} vs {lci}")
    bf16_relay = runs["card"]["h2d"] / 2
    ratio = bf16_relay / runs["card int8"]["h2d"]
    check(ratio >= 1.3, f"param_offload_reference: int8 h2d "
          f"{runs['card int8']['h2d']} B only {ratio:.3f}x below a bf16 relay's")
    for name, layers in (("card", 4), ("card deep", PARAM_OFFLOAD_DEEP_LAYERS)):
        plan = streamed_plan(get_model_config("llama-tiny", num_layers=layers), 6)
        check(runs[name]["launches"] == plan, f"param_offload_reference {name}: "
              f"launches {runs[name]['launches']} != streamed plan {plan}")
    shallow, deep = runs["card"], runs["card deep"]
    grow = deep["peak"] - shallow["peak"]
    allowed = (PARAM_OFFLOAD_DEEP_LAYERS - 4) * shallow["boundary"] + PEAK_ROUNDING
    extra_params = deep["param_bytes"] - shallow["param_bytes"]
    check(grow <= allowed, f"param_offload_reference: peak {shallow['peak']} B at "
          f"4 layers, {deep['peak']} B at {PARAM_OFFLOAD_DEEP_LAYERS}: grew "
          f"{grow} B, more than the extra boundary activations and the "
          f"allocator's rounding ({allowed} B)")
    print(f"reference: param_offload_reference, the llama-tiny preset (L 4, D "
          f"256, V 32000, S 200) with offload_param + offload_optimizer cpu, 3 "
          f"fp32 steps, card == CPU: losses {lg} vs {lc}, host masters max abs "
          f"diff {diff:.3g}; prefetch off bit-equal (hits/misses on "
          f"{runs['card']['hits']}, off {off['hits']}); int8_masters + "
          f"int8_stream card {li} vs CPU {lci}, h2d {runs['card int8']['h2d']} B "
          f"against {bf16_relay:.0f} B for a bf16 relay ({ratio:.3f}x fewer); "
          f"{len(shallow['gaps'])} slot reuses, each copy starting "
          f"{min(shallow['gaps']):.4f}-{max(shallow['gaps']):.4f} ms after its "
          f"readers' event; peak {shallow['peak']} B at 4 layers "
          f"({shallow['param_bytes']} B of fp32 params), {deep['peak']} B at "
          f"{PARAM_OFFLOAD_DEEP_LAYERS} ({deep['param_bytes']} B): +{grow} B "
          f"against {extra_params} B more params (and as much again of grads) "
          f"that a whole-program step would hold; launches equal to the "
          f"streamed plan at both depths")


def param_offload_host_bytes(preset, layers):
    """Host bytes a bf16 ``offload_param`` run of ``preset`` at ``layers``
    holds (PARAM_OFFLOAD_HOST_BYTES a parameter, and the grads' page-locked
    ring of two layers in bf16), the parameter count, one layer's
    parameters."""
    from deepspeed_tpu_torch.models.config import get_model_config
    from deepspeed_tpu_torch.models.transformer import param_shapes

    tree = param_shapes(get_model_config(preset, num_layers=layers))

    def sizes(t):
        for v in t.values():
            if isinstance(v, dict):
                yield from sizes(v)
            else:
                yield math.prod(v[0])

    n = sum(sizes(tree))
    per_layer = sum(sizes(tree["layers"])) // layers
    return PARAM_OFFLOAD_HOST_BYTES * n + 2 * 2 * per_layer, n, per_layer


def phase_param_offload_train(torch, dev, peaks, medians):
    """llama2-7b at full width (D 4096, 32/32 heads of 128, F 11008, vocab
    32000), bf16 compute over fp32 host masters (host C++ AdamW), WarmupLR,
    clipping 1.0, micro 2 x gas 2 x S 2048, 3 steps, with ``offload_param``
    + ``offload_optimizer`` cpu: the params, the grads and the accumulators
    in host memory, a layer at a time on the card.  As deep as 80 % of
    MemAvailable holds at PARAM_OFFLOAD_HOST_BYTES a parameter and the
    staging (printed with the reason).  Prints the host's cores and memory,
    the page-locking time, each step's split (forward stream, backward
    stream with the accumulation, host norm and clip, host step, cast into
    the page-locked copy), the h2d and d2h bytes with their GB/s over the
    streaming wall time, the compute stream's wait for copies, the prefetch
    hits and misses, tokens/s, MFU, the peak device memory beside its parts
    (boundary activations, slots, one layer's grads, the head segment:
    counted from the shapes) and what zero_offload_train's path holds on
    the card at this depth (bf16 params and fp32 accumulator, 6 B a
    parameter, before activations).  Checks: the peak below the model's
    bf16 parameter bytes; between steps the card holds only the slots
    (within 256 MiB); launches equal to the streamed plan (the backward's
    recomputed forward counted); losses finite and falling."""
    import gc

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()
    ident = gpu_identity()
    total, avail, cores = host_memory()
    full, budget = 32, 0.8 * avail
    need_full, n_full, _ = param_offload_host_bytes("llama2-7b", full)
    layers = full
    while layers > 1 and param_offload_host_bytes("llama2-7b", layers)[0] > budget:
        layers -= 1
    by_memory = layers
    layers = min(layers, PARAM_OFFLOAD_TRAIN_LAYERS)
    need, n, per_layer = param_offload_host_bytes("llama2-7b", layers)
    check(need <= budget, f"param_offload_train: even 1 layer needs {need} B of "
          f"host memory against {budget:.0f}")
    print(f"param_offload_train: {ident}; host MemTotal {total} B "
          f"({total / 2**30:.2f} GiB), MemAvailable {avail} B "
          f"({avail / 2**30:.2f} GiB), {cores} cores")
    if layers < by_memory:
        print(f"param_offload_train: depth cut {by_memory} -> {layers} layers "
              f"(PARAM_OFFLOAD_TRAIN_LAYERS) for the smoke's 600 s aim, beside "
              f"the zero phases; host memory holds {by_memory}")
    if by_memory < full:
        print(f"param_offload_train: depth cut {full} -> {by_memory} layers: at "
              f"{full} layers the host holds {PARAM_OFFLOAD_HOST_BYTES} B x "
              f"{n_full / 1e9:.4f}B params (fp32 masters and moments 12, the "
              f"bf16 host copy 2, the fp32 accumulator 4) and the grads' ring: "
              f"{need_full / 1e9:.2f} GB, more than 80 % of MemAvailable "
              f"({budget / 1e9:.2f} GB); {layers} layers need {need / 1e9:.2f} GB")
    else:
        print(f"param_offload_train: all {full} layers: {need / 1e9:.2f} GB "
              f"within 80 % of MemAvailable ({budget / 1e9:.2f} GB)")
    micro, S = TRAIN_CELLS["llama2-7b"]
    gas = 2
    base_alloc = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm("llama2-7b", seed=0, num_layers=layers)
    cfg = model.config
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=dict(TRAIN_CONFIG, **PARAM_OFFLOAD, **ADAMW_SECTION,
                                 train_micro_batch_size_per_gpu=micro))[0]
    check(engine._streamed is not None and not any(p.is_cuda for p in engine.master)
          and not any(a.is_cuda for a in engine.grad_acc),
          "param_offload_train: a param or an accumulator on the card")
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.master)
    check(n_params == n, f"param_offload_train: {n_params} params, the shapes "
          f"give {n}")
    st = engine._streamed.streamer
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (gas * micro, S), device=dev,
                           generator=gen)
    torch.cuda.synchronize(dev)
    after_build = torch.cuda.memory_allocated(dev) - base_alloc
    print(f"param_offload_train: llama2-7b D={cfg.hidden_size} L={layers} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} F={cfg.intermediate_size} "
          f"V={cfg.vocab_size}, {n_params / 1e9:.4f}B params: bf16 host copy "
          f"page-locked in {engine._pin_seconds:.2f}s "
          f"({2 * n_params / engine._pin_seconds / 1e9:.2f} GB/s of "
          f"cudaHostRegister), built in {build_s:.1f}s (the fp32 model made on "
          f"the card, then moved to the host); host optimizer state "
          f"{engine._offload_opt.state_bytes()} B; {st.staging_slots} slots of "
          f"{st.slot_bytes() // st.staging_slots} B; card after the build "
          f"{after_build} B")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    steps, splits, between = [], [], []
    for k in range(3):
        st.reset_counters()
        engine._streamed.d2h_seconds()       # its marks from 0
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        loss = float(engine.train_step((tokens, tokens)))
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        sp = engine.offload_split()
        stall = st.stall_seconds()
        h2d_s, d2h_s = st.copy_seconds(), engine._streamed.d2h_seconds()
        layer_h2d = st.takes * st.layer_payload_bytes()
        layer_d2h = gas * layers * st.layer_payload_bytes()
        steps.append((loss, engine.get_global_grad_norm(), wall))
        splits.append((sp, st.h2d_bytes, st.d2h_bytes, st.prefetch_hits,
                       st.prefetch_misses, stall))
        between.append(torch.cuda.memory_allocated(dev) - base_alloc)
        stream_s = (sp["fwd"] + sp["bwd"]) / 1e3
        print(f"param_offload_train: step {k + 1} loss {loss:.5f} grad norm "
              f"{steps[-1][1]:.4f} wall {wall:.3f}s = forward stream "
              f"{sp['fwd'] / 1e3:.3f}s + backward stream with the accumulation "
              f"{sp['bwd'] / 1e3:.3f}s (2 micro-batches) + host norm "
              f"{sp['norm'] / 1e3:.3f}s + clip {sp['clip'] / 1e3:.3f}s + host "
              f"step {sp['host_step'] / 1e3:.3f}s + cast into the page-locked copy "
              f"{sp['cast'] / 1e3:.3f}s + zero {sp['zero'] / 1e3:.3f}s; h2d "
              f"{st.h2d_bytes} B ({st.h2d_bytes / stream_s / 1e9:.2f} GB/s over "
              f"the streaming wall; the layer copies {layer_h2d} B in "
              f"{h2d_s:.3f}s of device copy time, {layer_h2d / h2d_s / 1e9:.2f} "
              f"GB/s), d2h {st.d2h_bytes} B ({st.d2h_bytes / stream_s / 1e9:.2f} "
              f"GB/s over the streaming wall; the layer grads {layer_d2h} B in "
              f"{d2h_s:.3f}s, {layer_d2h / d2h_s / 1e9:.2f} GB/s); prefetch hits "
              f"{st.prefetch_hits}, misses {st.prefetch_misses}; the compute "
              f"stream waited {stall * 1e3:.1f} ms for copies; card between "
              f"steps {between[-1]} B")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [x[0] for x in steps]
    check(all(math.isfinite(x[0]) and math.isfinite(x[1]) for x in steps)
          and losses[-1] < losses[0], f"param_offload_train: losses {losses}")
    plan = streamed_plan(cfg, gas * len(steps))
    check(launches == plan, f"param_offload_train launches {launches} != "
          f"streamed plan {plan}")
    bf16_bytes = 2 * n_params
    check(peak < bf16_bytes, f"param_offload_train: peak {peak} B not below the "
          f"model's {bf16_bytes} B of bf16 params")
    slots = st.slot_bytes()
    check(all(b <= slots + (256 << 20) for b in between),
          f"param_offload_train: between steps the card held {between} B, the "
          f"slots {slots} B")
    boundary = (layers + 1) * micro * S * cfg.hidden_size * 2
    layer_grads = 2 * per_layer
    V, D = cfg.vocab_size, cfg.hidden_size
    head = 2 * 2 * V * D + micro * (S - 1) * V * (2 + 4 + 4)
    offload_opt_bytes = 6 * n_params
    tokens_per_step = gas * micro * S
    wall = statistics.mean(x[2] for x in steps[1:])
    attn = 6 * layers * gas * micro * cfg.num_heads * S * S * cfg.head_dim
    flops = 6 * n_params * tokens_per_step + attn
    peaks["param_offload_train"] = peak / 2**30
    medians["param_offload_train"] = statistics.median(x[2] for x in steps)
    print(f"param_offload_train: {ident}; steady step (mean of steps 2-3) "
          f"{wall:.4f}s, {tokens_per_step / wall:.1f} tokens/s, MFU "
          f"{100 * flops / wall / BF16_FLOPS_PER_S:.2f}% (6N + attention "
          f"{flops / 1e12:.1f} TFLOP a step over 989 TFLOP/s; the backward's "
          f"recomputed forward not counted); peak device memory {peak} B "
          f"({peak / 2**30:.2f} GiB) against {bf16_bytes} B of bf16 params; its "
          f"parts from the shapes: boundary activations {boundary} B, slots "
          f"{slots} B, one layer's bf16 grads {layer_grads} B, the head segment "
          f"(bf16 head and its grads, bf16 logits, their fp32 copy and grads) "
          f"{head} B, the rest (a layer's recomputed activations, the embedding "
          f"segment) {peak - boundary - slots - layer_grads - head} B; "
          f"zero_offload_train's path (offload_optimizer alone) at this "
          f"depth holds {offload_opt_bytes} B ({offload_opt_bytes / 2**30:.2f} "
          f"GiB) of bf16 params and fp32 accumulator on the card before its "
          f"activations; launches {launches}")
    del engine, model, tokens, st
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()
    print(f"param_offload_train: after the engine is let go, this process "
          f"holds {process_rss() / 2**30:.2f} GiB of host memory; MemAvailable "
          f"{host_memory()[1] / 2**30:.2f} GiB (freed memory comes back to it "
          f"slowly)")
    return launches, {}


def phase_zero_offload_nvme(torch, dev):
    """llama-1b4 at full width cut to NVME_LAYERS layers, bf16 over fp32
    host masters: 3 steps on the cpu backend, then 3 on ``nvme`` (state
    files in a temporary directory): losses and host masters bit-equal.
    The aio read and write rates over the state files (a read of each file
    just written: the page cache is warm).  Then save, load into a fresh
    engine (other random weights, another swap directory) and take step 4:
    loss, grad norm and host masters bit-equal to step 4 without the
    reload."""
    import gc
    import shutil
    import tempfile

    import deepspeed_tpu_torch

    ident = gpu_identity()
    micro, S = TRAIN_CELLS["llama-1b4"]
    root = tempfile.mkdtemp(prefix="ds_nvme_")
    tokens = None

    def build(seed, device, swap=None):
        gc.collect()
        torch.cuda.empty_cache()
        off = {"device": device, **({"nvme_path": swap} if swap else {})}
        cfg = dict(TRAIN_CONFIG, **ADAMW_SECTION, train_micro_batch_size_per_gpu=micro,
                   zero_optimization={"stage": 0, "offload_optimizer": off},
                   aio={"thread_count": NVME_AIO_THREADS})
        return deepspeed_tpu_torch.initialize(
            model=train_model("llama-1b4", seed=seed, num_layers=NVME_LAYERS),
            config=cfg)[0]

    def step(engine):
        loss = float(engine.train_step((tokens, tokens)))
        torch.cuda.synchronize()
        return loss, engine.get_global_grad_norm()

    zero_counts()
    try:
        t = time.perf_counter()
        eng = build(0, "cpu")
        print(f"zero_offload_nvme: cpu-backend engine built in "
              f"{time.perf_counter() - t:.3f} s")
        gen = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.randint(0, eng.module.config.vocab_size, (2 * micro, S),
                               device=dev, generator=gen)
        want = [step(eng) for _ in range(3)]
        masters = [m.clone() for m in eng._offload_opt.masters()]
        del eng
        t = time.perf_counter()
        eng = build(0, "nvme", os.path.join(root, "swap_a"))
        print(f"zero_offload_nvme: nvme engine built (state files written) in "
              f"{time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        got = [step(eng) for _ in range(3)]
        wall = time.perf_counter() - t
        opt = eng._offload_opt
        check(got == want and all(torch.equal(a, b) for a, b in
                                  zip(opt.masters(), masters)),
              f"zero_offload_nvme: nvme {got} against the cpu backend {want}")
        sw = opt._swapper
        t = time.perf_counter()
        bufs = [sw.read_sync(i) for i in range(len(opt._sizes))]
        read_s = time.perf_counter() - t
        nbytes = sum(b.numel() * 4 for b in bufs)
        t = time.perf_counter()
        for i, b in enumerate(bufs):
            sw.write_sync(i, b)
        write_s = time.perf_counter() - t
        del bufs
        free = shutil.disk_usage(root).free
        print(f"zero_offload_nvme: {ident}; llama-1b4 D 2048 cut to {NVME_LAYERS} "
              f"layer(s) (the smoke's 600 s aim: its save and load hash every "
              f"byte on one core), {sum(opt._sizes) / 1e9:.4f}B params in {len(opt._sizes)} "
              f"state files ({nbytes} B, [master, exp_avg, exp_avg_sq] fp32); 3 "
              f"steps {wall:.3f}s, losses and grad norms {got} and every host "
              f"master bit-equal to the cpu backend; aio ({NVME_AIO_THREADS} threads, "
              f"1 MiB blocks): read {nbytes / read_s / 1e9:.3f} GB/s (warm page "
              f"cache), write {nbytes / write_s / 1e9:.3f} GB/s; {free / 1e9:.1f} "
              f"GB free in {root}")
        t = time.perf_counter()
        tag = eng.save_checkpoint(os.path.join(root, "ckpt"))
        save_s = time.perf_counter() - t
        want4 = step(eng)
        masters4 = [m.clone() for m in eng._offload_opt.masters()]
        del eng
        eng = build(1, "nvme", os.path.join(root, "swap_b"))
        t = time.perf_counter()
        loaded, _ = eng.load_checkpoint(os.path.join(root, "ckpt"))
        load_s = time.perf_counter() - t
        check(loaded == tag, f"zero_offload_nvme: loaded {loaded}, saved {tag}")
        got4 = step(eng)
        check(got4 == want4 and all(torch.equal(a, b) for a, b in
                                    zip(eng._offload_opt.masters(), masters4)),
              f"zero_offload_nvme: step 4 after the reload {got4} != {want4}")
        print(f"zero_offload_nvme: saved {manifest_bytes(tag)} B (offload_states "
              f"in the manifest) in {save_s:.3f} s, fresh engine loaded it in "
              f"{load_s:.3f} s (verify included); step 4 (loss, grad "
              f"norm) {got4} and every host master bit-equal to step 4 without "
              f"the reload {want4}")
        del eng
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = read_counts()
    for k in ("rms_norm", "rms_norm_bwd", "rope", "flash_attention_fwd",
              "flash_attention_bwd"):
        check(launches[k] > 0, f"zero_offload_nvme: {k} never launched")
    check(launches["fused_adam"] == 0, "zero_offload_nvme: a device Adam launch")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {}


def phase_bloom_fp16_offload(torch, dev, peaks, medians):
    """bloom-1b7 (nothing cut) in fp16 (dynamic scale from 2^16) with
    ``offload_optimizer: cpu``, BLOOM_FP16_STEPS applied steps, each printed
    with its loss scale and skip: the fp16 ALiBi flash instances on a train
    path, and the overflow skip of the host-stepped step.  Beside it the
    same cell with device FusedAdam: the same skips, and losses within the
    fp16 train gate's rtol 1e-3 (``tests/test_torch_fp16.py``)."""
    print(f"bloom_fp16_offload_train: {BLOOM_FP16_STEPS} steps each (5 in "
          f"the other train cells) for the smoke's 600 s aim")
    runs = {}

    def keep(name):
        return lambda engine, info: runs.__setitem__(name, info["steps"])

    phase_train(torch, dev, "bloom-1b7", "bloom_fp16_train", FP16_CONFIG, peaks,
                medians, steps_wanted=BLOOM_FP16_STEPS, profile=False,
                report=keep("device"))
    result = phase_train(torch, dev, "bloom-1b7", "bloom_fp16_offload_train",
                         dict(FP16_CONFIG, **ZERO_OFFLOAD), peaks, medians,
                         steps_wanted=BLOOM_FP16_STEPS, profile=False,
                         report=keep("offload"))
    dev_steps, off_steps = runs["device"], runs["offload"]
    check([x[4] for x in off_steps] == [x[4] for x in dev_steps],
          f"bloom_fp16_offload_train: skips {[x[4] for x in off_steps]} against "
          f"FusedAdam's {[x[4] for x in dev_steps]}")
    for a, b in zip(off_steps, dev_steps):
        check(abs(a[0] - b[0]) <= 1e-3 * abs(b[0]),
              f"bloom_fp16_offload_train: losses {[x[0] for x in off_steps]} "
              f"against FusedAdam's {[x[0] for x in dev_steps]}")
    launches = result[0]
    for k in ("flash_attention_fwd_f16_alibi", "flash_attention_bwd_f16_alibi"):
        check(launches[k] > 0, f"bloom_fp16_offload_train: {k} never launched")
    print(f"bloom_fp16_offload_train: losses {[x[0] for x in off_steps]} and "
          f"skips {[x[4] for x in off_steps]} against device FusedAdam's "
          f"{[x[0] for x in dev_steps]} / {[x[4] for x in dev_steps]} (rtol 1e-3)")
    return result


def clocked(spent, name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept in ``spent[name]`` and
    printed with the host's MemAvailable after it."""
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    spent[name] = time.perf_counter() - t
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"chip_smoke: phase {name} {spent[name]:.1f}s, host MemAvailable "
          f"{host_available_gib():.2f} GiB, card allocated after it "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return out


def phase_unfused(torch, model, prompts, first):
    """The unfused decode path on the same weights (no copy: the model's
    own tensors), a shorter wave with its own launch plan; each request's
    first token comes from the shared prefill and must match the fused
    run's."""
    import deepspeed_tpu_torch

    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "use_fused_decode": False,
                       "max_out_tokens": 1024},
        params=model.params(), num_slots=8, prefill_chunk=64)
    check(serve.engine._dparams is None, "use_fused_decode: False still "
          "built the kernel-injected view")
    spent = {"prefill": 0.0, "decode": 0.0}
    serve._prefill = timed(torch, spent, "prefill", serve._prefill)
    serve._block = timed(torch, spent, "decode", serve._block)
    picks = [p for p in prompts if len(p) in (17, 64, 100, 128)]
    zero_counts()
    reqs = [serve.submit(p, max_new_tokens=16) for p in picks]
    serve.run()
    torch.cuda.synchronize()
    launches = read_counts()
    for p, r in zip(picks, reqs):
        check(r.finish_reason == "length" and len(r.output_tokens) == 16,
              f"unfused request: {r.finish_reason} / {len(r.output_tokens)}")
        check(r.output_tokens[0] == first[len(p)], "unfused first token "
              "differs from the fused run's (same prefill)")
    serve.pool.check_no_leak()
    st = serve.stats
    steps = st["decode_blocks"] * serve._K
    plan = launch_plan(model.config, st["prefill_chunks"], steps, fused=False)
    check(launches == plan, f"unfused launches {launches} != plan {plan}")
    print(f"unfused: {len(reqs)} requests, decode {st['decode_tokens']} "
          f"tokens in {steps} steps, "
          f"{st['decode_tokens'] / spent['decode']:.1f} tok/s; prefill "
          f"{st['prefill_tokens'] / spent['prefill']:.1f} tok/s; launches "
          f"{launches}")
    serve.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    spent = {}      # each phase's wall seconds, for the smoke's budget
    c = functools.partial(clocked, spent)
    flash_ptxas = c("build", phase_build, torch, dev)["flash_ptxas"]
    timings = c("kernels", phase_kernels, torch, dev)
    for name in KERNELS:
        if name.startswith("flash_attention_"):   # its wgmma kernels' ptxas
            timings[name]["ptxas"] = {
                k: v for k, v in flash_ptxas.items()
                if ("alibi" in k) == ("alibi" in name) and ("f16" in k) == (
                    "f16" in name) and ("bwd" in k) == ("bwd" in name)}
    for preset, policy in (("llama-tiny", "mlp_dots"), ("gpt2-small", "full")):
        c(f"reference_{preset}", phase_reference, torch, dev, preset)
        c(f"train_reference_{preset}", phase_train_reference, torch, dev, preset,
          policy)
    c("train_reference_dropout", phase_train_reference, torch, dev, "llama-tiny",
      "mlp_dots", DROPOUT_RATE)
    c("reference_kv_int8", phase_reference_kv_int8, torch, dev)
    c("reference_moe", phase_reference_moe, torch, dev)
    c("preset_train_reference", phase_preset_train_reference, torch, dev)
    c("mixtral_train_reference", phase_mixtral_train_reference, torch, dev)
    c("mixtral_train_reference_rts", phase_mixtral_train_reference, torch, dev,
      dropout=DROPOUT_RATE, moe_use_rts=True)
    c("hf_train_reference", phase_hf_train_reference, torch, dev)
    c("optimizer_reference", phase_optimizer_reference, torch, dev)
    c("zero_offload_reference", phase_zero_offload_reference, torch, dev)
    c("param_offload_reference", phase_param_offload_reference, torch, dev)
    zref = c("zero_reference", phase_zero_reference, torch, dev)
    c("zero_overlap_reference", phase_zero_overlap_reference, torch, dev, zref)
    cq_timings, cq_launches = c("comm_quant", phase_comm_quant, torch, dev, zref)
    timings.update(cq_timings)
    del zref
    # each path: (launch counts of its run, device ms per call in its profile)
    peaks, medians = {}, {}
    serve_keep, gen_keep = {}, {}
    offload_ref = {}      # zero_offload_train's run, for zero_offload_stage2
    runs = {"ops": (c("ops", phase_ops, torch, dev), {}),
            "comm_quant": (cq_launches, {}),
            "serve": c("serve", phase_serve, torch, dev, "llama3-8b", keep=serve_keep),
            "gpt2_serve": c("gpt2_serve", phase_serve, torch, dev, "gpt2-xl"),
            **c("generate", phase_generate, torch, dev, keep=gen_keep),
            **c("fixed_and_kv_int8", phase_fixed_and_kv_int8, torch, dev,
                serve_keep, gen_keep),
            "mixtral_serve": c("mixtral_serve", phase_mixtral, torch, dev),
            "train": c("train", phase_train, torch, dev, "llama-1b4", "train",
                       peaks=peaks, medians=medians),
            "zero_train": c("zero_train", phase_zero_train, torch, dev, peaks,
                            medians),
            "zero_overlap_train": c("zero_overlap_train", phase_zero_overlap_train,
                                    torch, dev, peaks, medians),
            "checkpoint": c("checkpoint", phase_checkpoint, torch, dev),
            "fp16_train": c("fp16_train", phase_train, torch, dev, "llama-1b4",
                            "fp16_train", FP16_CONFIG, peaks, medians),
            "gpt2_train": c("gpt2_train", phase_train, torch, dev, "gpt2-xl",
                            "gpt2_train", peaks=peaks),
            "adam8bit_train": c("adam8bit_train", phase_train, torch, dev,
                                "llama-1b4", "adam8bit_train", ADAM8BIT_CONFIG,
                                peaks),
            "lamb_train": c("lamb_train", phase_train, torch, dev, "llama-1b4",
                            "lamb_train", LAMB_CONFIG, peaks),
            "bloom_train": c("bloom_train", phase_train, torch, dev, "bloom-1b7",
                             "bloom_train", peaks=peaks),
            "mixtral_train": c("mixtral_train", phase_train, torch, dev,
                               "mixtral-8x7b", "mixtral_train", peaks=peaks),
            "dropout_train": c("dropout_train", phase_train, torch, dev,
                               "llama-1b4", "dropout_train", peaks=peaks,
                               medians=medians,
                               model_over={"dropout": DROPOUT_RATE}),
            # before the phases that pin host memory: the host memory that
            # a pinned buffer held comes back to MemAvailable only slowly
            "param_offload_train": c("param_offload_train",
                                     phase_param_offload_train, torch, dev,
                                     peaks, medians),
            "zero_offload_train": c("zero_offload_train", phase_zero_offload_train,
                                    torch, dev, peaks, medians, offload_ref),
            "zero_offload_stage2": c("zero_offload_stage2", phase_zero_offload_stage2,
                                     torch, dev, peaks, medians, offload_ref),
            "offload_train": c(
                "offload_train", phase_train, torch, dev, "llama-1b4",
                "offload_train",
                {"activation_checkpointing": {"cpu_checkpointing": True}},
                peaks, medians),
            **c("optimizer_legs", phase_optimizer_legs, torch, dev, peaks, medians),
            "zero_offload_nvme": c("zero_offload_nvme", phase_zero_offload_nvme,
                                   torch, dev),
            "bloom_fp16_offload_train": c("bloom_fp16_offload",
                                          phase_bloom_fp16_offload, torch, dev,
                                          peaks, medians)}
    c("offload_grads", check_offload_grads, torch, dev)
    print(f"chip_smoke: phase seconds {json.dumps({k: round(v, 1) for k, v in spent.items()})}")
    ident = gpu_identity()
    src = "deepspeed_tpu_torch/csrc/decode.cu"
    fa_src = "deepspeed_tpu_torch/csrc/flash_attention.cu"
    ln_src = "deepspeed_tpu_torch/csrc/layer_norm.cu"
    sm_src = "deepspeed_tpu_torch/ops/kernels/softmax.py"
    lamb_src = "deepspeed_tpu_torch/csrc/fused_lamb.cu"
    pallas = "deepspeed_tpu/ops/pallas/"
    # name, route, source, the TPU kernel's file:line and function, and the
    # path whose run gives ``launches``
    table = [
        ("rms_norm", "cuda", ln_src, "layer_norm.py:200", "rms_norm", "serve"),
        ("rope", "cuda", "deepspeed_tpu_torch/csrc/rope.cu",
         "rope.py:62", "_rope_fwd (and _rope_bwd_vjp, rope.py:89, through the "
         "same kernel)", "serve"),
        ("fused_norm_qkv", "cuda", src, "decode.py:123", "fused_norm_qkv", "serve"),
        ("flash_decode", "cuda", src, "decode.py:252", "_flash_decode_paged",
         "serve"),
        ("fused_proj_norm", "cuda", src, "decode.py:433", "fused_proj_norm",
         "serve"),
        ("fused_mlp", "cuda", src, "decode.py:546", "fused_mlp", "serve"),
        ("rms_norm_bwd", "cuda", ln_src, "layer_norm.py:228", "_rms_norm_bwd_vjp",
         "train"),
        ("flash_attention_fwd", "cuda", fa_src, "flash_attention.py:149",
         "_flash_fwd", "train"),
        ("flash_attention_bwd", "cuda", fa_src, "flash_attention.py:283",
         "_flash_bwd", "train"),
        ("fused_adam", "cuda", "deepspeed_tpu_torch/csrc/fused_adam.cu",
         "fused_adam.py:53", "fused_adam_update", "train"),
        ("layer_norm", "cuda", ln_src, "layer_norm.py:115", "layer_norm",
         "gpt2_serve"),
        ("layer_norm_bwd", "cuda", ln_src, "layer_norm.py:151",
         "_layer_norm_bwd_vjp", "gpt2_train"),
        ("scaled_masked_softmax", "triton", sm_src, "softmax.py:39",
         "scaled_masked_softmax (both pallas_call sites, :57 and :67)", "ops"),
        ("bias_act", "triton", sm_src, "softmax.py:92", "bias_act", "ops"),
        ("quantize", "cuda", "deepspeed_tpu_torch/csrc/quantizer.cu",
         "quantizer.py:36", "quantize", "ops"),
        ("fused_adam8bit", "cuda", "deepspeed_tpu_torch/csrc/fused_adam8bit.cu",
         "fused_adam8bit.py:64", "fused_adam8bit_update", "adam8bit_train"),
        ("fused_lamb_phase1", "cuda", lamb_src, "fused_lamb.py:68",
         "fused_lamb_update (_lamb_phase1_kernel, pallas_call :110, and the "
         "trust-ratio combine after it)", "lamb_train"),
        ("fused_lamb_scale", "cuda", lamb_src, "fused_lamb.py:68",
         "fused_lamb_update (_scale_kernel, pallas_call :128)", "lamb_train"),
        ("flash_decode_contig", "cuda", src, "decode.py:319",
         "flash_decode (contiguous cache: _flash_decode_kernel, pallas_call "
         ":390)", "generate"),
        ("fused_norm_qkv_int8", "cuda", src, "decode.py:123",
         "fused_norm_qkv (quant=True: _deq, decode.py:88)", "generate_int8"),
        ("fused_proj_norm_int8", "cuda", src, "decode.py:433",
         "fused_proj_norm (quant=True)", "generate_int8"),
        ("fused_mlp_int8", "cuda", src, "decode.py:546",
         "fused_mlp (quant=True)", "generate_int8"),
        ("flash_attention_fwd_alibi", "cuda", fa_src, "flash_attention.py:149",
         "_flash_fwd (alibi=True: the bias at :111-112, pallas_call :161)",
         "bloom_train"),
        ("flash_attention_bwd_alibi", "cuda", fa_src, "flash_attention.py:283",
         "_flash_bwd (alibi=True: dQ :217-218, pallas_call :301; dK/dV "
         ":263-264, pallas_call :319)", "bloom_train"),
        ("flash_attention_fwd_f16", "cuda", fa_src, "flash_attention.py:149",
         "_flash_fwd (float16, pallas_call :161)", "fp16_train"),
        ("flash_attention_bwd_f16", "cuda", fa_src, "flash_attention.py:283",
         "_flash_bwd (float16, pallas_call :301 and :319)", "fp16_train"),
        ("flash_attention_fwd_f16_alibi", "cuda", fa_src, "flash_attention.py:149",
         "_flash_fwd (float16, alibi=True)", "bloom_fp16_offload_train"),
        ("flash_attention_bwd_f16_alibi", "cuda", fa_src, "flash_attention.py:283",
         "_flash_bwd (float16, alibi=True)", "bloom_fp16_offload_train"),
        ("fused_adam_f16", "cuda", "deepspeed_tpu_torch/csrc/fused_adam.cu",
         "fused_adam.py:53", "fused_adam_update (float16 params, pallas_call "
         ":103)", "ops"),
        ("dropout", "cuda", "deepspeed_tpu_torch/csrc/dropout.cu",
         DROPOUT_SITE, "_dropout (plain jnp: no pallas_call)", "dropout_train"),
        ("dropout_bwd", "cuda", "deepspeed_tpu_torch/csrc/dropout.cu",
         DROPOUT_SITE, "_dropout's transpose under jax.grad (plain jnp: no "
         "pallas_call)", "dropout_train"),
        ("quantize_blockwise", "cuda", "deepspeed_tpu_torch/csrc/comm_quant.cu",
         COMM_QUANT_SITE, "quantize_blockwise (plain jnp, fused by XLA into "
         "each quantized collective: no pallas_call)", "comm_quant"),
        ("dequantize_blockwise", "cuda", "deepspeed_tpu_torch/csrc/comm_quant.cu",
         COMM_DEQUANT_SITE, "dequantize_blockwise and the collectives' "
         "dequantize-and-sum (comm/collectives_q.py; plain jnp: no "
         "pallas_call)", "comm_quant"),
    ]
    check([row[0] for row in table] == list(KERNELS), "kernel table out of step")
    kernels = []
    for name, route, source, where, fn_name, path in table:
        t = timings[name]
        launches, device_ms = runs[path]
        site = where if where.startswith("deepspeed_tpu/") else pallas + where
        k = {"name": name, "route": route, "source": source,
             "replaces": site,
             "tpu_kernel": f"{site.split(':')[0]}:{fn_name}",
             "launches": launches[name], "launches_on": path,
             "launches_by_path": {p: r[0][name] for p, r in runs.items()},
             "max_abs_err": t["max_abs_err"], "ms": t["ms"], "kernel_ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"],
             "shape": t["shape"],
             "device_ms_by_path": {p: r[1][name] for p, r in runs.items()
                                   if r[1].get(name) is not None}}
        k["device_ms_on_path"] = k["device_ms_by_path"].get(path)
        if runs[path][1].get(name + "_split"):
            k["device_ms_split_on_path"] = runs[path][1][name + "_split"]
        spans = {p: r[1][name + "_span"] for p, r in runs.items()
                 if r[1].get(name + "_span") is not None}
        if spans:       # a two-launch kernel's union a call, PDL's overlap once
            k["device_ms_span_by_path"] = spans
        for extra in ("matmul_ms", "max_abs_err_train_shape",
                      "max_abs_err_gpt2_shape", "decode_rows_ms",
                      "masked_ms", "masked_plain_ms", "masked_bound_ms",
                      "gpt2_shape", "fp32_masters", "whole_update_bound_ms",
                      "train_ms", "train_bound_ms", "device_us_split",
                      "public_ms", "host_us", "train_library_ms", "gpt2_ms",
                      "gpt2_plain_ms", "gpt2_bound_ms", "gpt2_device_us_split",
                      "ptxas", "library_fwd_bwd_ms", "fwd_bwd_ms",
                      "max_abs_err_h12", "max_abs_err_f16",
                      "max_abs_err_train_shape_f16", "overflow_inf_dv",
                      "bound_share", "gpt2_bound_share", "gpt2_host_us",
                      "device_us", "gpt2_device_us", "one_page_device_us",
                      "ms_300", "bound_ms_300", "device_us_300",
                      "bound_share_300", "ms_2048", "bound_ms_2048",
                      "device_us_2048", "bound_share_2048", "library_ms_2048",
                      "plain_ms_2048", "split", "gpt2_split", "gpt2_matmul_ms",
                      "graph_us", "gpt2_graph_us", "bloom_shape", "bloom_ms",
                      "bloom_plain_ms", "bloom_library_ms", "bloom_bound_ms",
                      "bloom_max_abs_err", "bloom_device_us", "bloom_device_us_split",
                      "bloom_host_us", "fwd_shapes", "prefill_rows_ms",
                      "library_decode_rows_ms", "library_prefill_rows_ms",
                      "path_shapes", "wide_shape", "wide_ms", "wide_plain_ms",
                      "wide_library_ms", "wide_bound_ms", "wide_max_abs_err",
                      "wide_device_us_split", "wide_max_abs_err_f16",
                      "int_ops_an_element", "f_dropout_ms", "bf16_shape", "bf16_ms", "bf16_plain_ms", "bf16_bound_ms",
                      "concat_shape", "concat_ms", "concat_plain_ms",
                      "concat_bound_ms", "error_shape", "error_ms",
                      "error_plain_ms", "error_bound_ms"):
            if extra in t:
                k[extra] = t[extra]
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms",
                                                "max_abs_err")),
              f"{name}: a non-finite number")
        check(k["launches"] > 0, f"{name}: no launch on its path")
        kernels.append(k)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
