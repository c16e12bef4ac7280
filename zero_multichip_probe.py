#!/usr/bin/env python3
"""ZeRO stages over NCCL across the cards of one host, under torchrun.

    python3 zero_multichip_probe.py [--ranks 4] [--layers 4] [--out DIR]

Needs ``--ranks`` CUDA cards; imports nothing of JAX.  The script builds
the port's kernels (``chip_smoke.phase_build``), then:

1. on card 0 alone, with no process group: llama-1b4 at full width cut to
   ``--layers`` layers, chip_smoke's ``TRAIN_CONFIG`` (bf16 over fp32
   masters, FusedAdam, WarmupLR, clipping 1.0), 3 steps of a global batch
   of ``4 * ranks`` rows x gas 2 x S 2048 at stage 0 (the reference), and
   the same with cpu offload (host C++ AdamW: the offload reference); then
   llama-1b4 at full depth, micro 4 x gas 2, 5 steps, plain and with cpu
   offload (the one-card step, and the one-card host step);
2. ``python -m torch.distributed.run --standalone --nproc_per_node=ranks``
   of this script with ``--rank-run``: each rank joins the NCCL group that
   torchrun describes through ``deepspeed_tpu_torch.initialize`` (rank,
   world, ``cuda:LOCAL_RANK`` from the environment; the rendezvous on
   localhost) and trains on its rows (micro 4) the variants of
   ``VARIANTS`` that ``--check`` names: stages 0-3, ``overlap_comm``
   (bucket 1 layer) at stages 1-3, cpu offload at stage 2, and the
   quantized paths: ZeRO++ with qwZ + qgZ (``zpp``) and with hpZ over
   subgroups of 2 (``zpp_hpz2``), stage 2's int8 gradient all-reduce with
   error feedback (``2q``) and the overlap schedule at stage 3 with int8
   gathers and reduce-scatters (``3oq``); the cut model 3 steps each, then
   the full depth 5 steps each (``--timed`` names the variants timed
   there); every rank writes ``<out>/rank{r}.json``.

    python3 zero_multichip_probe.py --check 2,3,3o,zpp,zpp_hpz2,2q,3oq \
        --timed 2,3,3o,zpp,zpp_hpz2,2q,3oq

runs the quantized variants beside their dense ones, cut and at full
depth.

It prints, beside the card's name and power limit: each dense variant's
losses and grad norms against its one-card reference (bf16 bounds: losses
rtol 1e-3, grad norms 1e-2; the ranks' batches run other GEMM shapes than
the one card's), each quantized variant's against its dense variant's on
the same ranks (Q_LOSS_RTOL, Q_NORM_RTOL: an int8 code carries up to half
a step of 1/127 of its block's absmax, in every gathered weight under
qwZ and every reduced grad under qgZ), whether every rank returned the
same losses and the same full params (a hash, at full depth a
fingerprint of the bits on the card), the collectives' calls and bytes a
step (and under overlap whether each micro-batch's collectives were the
bucket plan; under int8 the wire bytes of the codes and scales against
the dense twin's, as ``comm.q_counters()`` records them, or for the
overlap schedule as its plan lists them), and for the full depth each
variant's median step (steps 3-5) on the slowest rank, tokens/s over all
cards, MFU a card, the peak device memory a rank, the one-card step
beside them and, under offload, the host step a rank against one card's.
It exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECK_STEPS, TIMED_STEPS, MICRO, S = 3, 5, 4, 2048
# name -> (stage, overlap_comm, cpu offload of the optimizer state, more
# config, the dense variant a quantized one is held to)
_QW_QG = {"zero_quantized_weights": True, "zero_quantized_gradients": True}
VARIANTS = {"0": (0, False, False, {}, None), "1": (1, False, False, {}, None),
            "2": (2, False, False, {}, None), "3": (3, False, False, {}, None),
            "1o": (1, True, False, {}, None), "2o": (2, True, False, {}, None),
            "3o": (3, True, False, {}, None), "2off": (2, False, True, {}, None),
            "zpp": (3, False, False, {"zero_optimization": _QW_QG}, "3"),
            "zpp_hpz2": (3, False, False, {"zero_optimization": dict(
                _QW_QG, zero_hpz_partition_size=2)}, "3"),
            "2q": (2, False, False, {"comm_quantization": {
                "grad_all_reduce": True, "error_feedback": True}}, "2"),
            "3oq": (3, True, False, {"comm_quantization": {
                "all_gather": True, "reduce_scatter": True}}, "3o")}
CHECK = "0,1,2,3,1o,2o,3o,2off"
TIMED = "0,3,1o,2o,3o,2off"
# a quantized variant against its dense one: the int8 codes' rounding in
# the gathered weights and the reduced grads moves the loss and the norm
# by far more than bf16 does, far less than the JAX suite's own int8
# against dense bounds (rtol 0.05 on losses, 0.15 on ZeRO++ trajectories)
Q_LOSS_RTOL, Q_NORM_RTOL = 1e-2, 5e-2


def _config(variant, micro):
    import chip_smoke

    stage, overlap, offload, extra, _ = VARIANTS[variant]
    zero = {"stage": stage, "stage3_param_persistence_threshold": 0}
    cfg = dict(chip_smoke.TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro)
    if overlap:
        zero.update(chip_smoke.ZERO_OVERLAP)
    if offload:
        zero["offload_optimizer"] = {"device": "cpu"}
        cfg.update(chip_smoke.ADAMW_SECTION)
    zero.update(extra.get("zero_optimization", {}))
    cfg["zero_optimization"] = zero
    if "comm_quantization" in extra:
        cfg["comm_quantization"] = extra["comm_quantization"]
    return cfg


def _quantized(engine) -> bool:
    """Whether the engine took an int8 path."""
    sched = engine._overlap_sched
    return bool(engine._zeropp or engine._qcomm_grads
                or (sched is not None and (sched.qcomm.all_gather
                                           or sched.qcomm.reduce_scatter)))


def _q_bytes(engine, counts_q, micros):
    """(wire bytes, dense twin bytes) of the int8 collectives over the run:
    ``comm.q_counters()``, or for the overlap schedule (whose int8
    collectives run unrecorded, as the JAX schedule's) its plan's int8
    entries times the micro-batches run."""
    sched = engine._overlap_sched
    if sched is not None:
        q = [e for e in sched.comm_plan_entries() if e[0].startswith("q_")]
        return (micros * sum(e[2] for e in q), micros * sum(e[5][0] for e in q))
    return (sum(sum(r["bytes"].values()) for r in counts_q.values()),
            sum(r["dense_bytes"] for r in counts_q.values()))


def _tokens(torch, vocab, rows, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randint(0, vocab, (rows, S), device=dev, generator=gen)


def _train(torch, engine, batch, steps):
    """(loss, grad norm, wall s, host step ms or None) a step; under
    overlap, whether every micro-batch's collectives were the plan."""
    out = []
    sched = engine._overlap_sched
    planned = True
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(engine.train_step(batch))
        torch.cuda.synchronize()
        host = engine.offload_split().get("host_step") if engine._offload else None
        out.append((loss, engine.get_global_grad_norm(), time.perf_counter() - t, host))
        if sched is not None:
            planned &= sched.last_counts == sched.plan_counts()
    return out, planned


def _params_fingerprint(torch, engine):
    """A fingerprint of the full params' bits on the card (a collective at
    stage 3 and under ZeRO++): a leaf at a time, the fp32 bits as int64
    weighted by their position and summed (integer sums wrap exactly, in
    any order)."""
    params = engine.params()
    out = []
    for path in sorted(engine._paths):
        leaf = params
        for k in path.split("."):
            leaf = leaf[k]
        bits = leaf.detach().float().reshape(-1).view(torch.int32).long()
        pos = torch.arange(1, bits.numel() + 1, device=bits.device) % 1000003
        out.append(int((bits * pos).sum()))
        del bits, pos
    return out


def _params_hash(engine) -> str:
    """sha256 of the full params (a collective at stage 3)."""
    h = hashlib.sha256()
    params = engine.params()
    for path in sorted(engine._paths):
        leaf = params
        for k in path.split("."):
            leaf = leaf[k]
        h.update(leaf.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_run(args) -> None:
    """One rank under torchrun: the cut model at stages 0-3, then the full
    depth at stages 0 and 3."""
    import torch

    import chip_smoke
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops.kernels import comm_quant as kq

    # the models are built on this rank's card before initialize joins
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    out = {"check": {}, "timed": {}}
    rank = world = None
    timed = args.timed.split(",") if args.timed else []
    check = args.check.split(",") if args.check else []
    for part, layers, variants, steps in (("check", args.layers, check, CHECK_STEPS),
                                          ("timed", None, timed, TIMED_STEPS)):
        for stage in variants:
            over = {} if layers is None else {"num_layers": layers}
            model = chip_smoke.train_model("llama-1b4", **over)
            engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                        config=_config(stage, MICRO))
            check_overlap = VARIANTS[stage][1]
            chip_smoke.check(engine._overlap == check_overlap,
                             f"variant {stage}: overlap {engine._overlap}")
            rank, world = comm.get_rank(), comm.get_world_size()
            dev = engine.device
            glob = _tokens(torch, model.config.vocab_size, 2 * MICRO * world, dev)
            # this rank's rows of each global micro-batch
            rows = glob.view(2, MICRO * world, S)[:, rank * MICRO:(rank + 1) * MICRO]
            batch = rows.reshape(2 * MICRO, S).contiguous()
            quant = VARIANTS[stage][4] is not None
            chip_smoke.check(_quantized(engine) == quant,
                             f"variant {stage}: int8 path {_quantized(engine)} "
                             f"(inert keys {engine._inert_config_keys})")
            torch.cuda.reset_peak_memory_stats(dev)
            comm.reset_counters()
            kq.quantize_blockwise.launches = kq.dequantize_blockwise.launches = 0
            steps_out, planned = _train(torch, engine, (batch, batch), steps)
            counts = comm.counters()
            codec = {"quantize_blockwise": kq.quantize_blockwise.launches,
                     "dequantize_blockwise": kq.dequantize_blockwise.launches}
            shapes = (engine._zpp_shapes if engine._zeropp
                      else [pl.shape for pl in engine._plan])
            res = {"steps": steps_out, "counters": counts, "planned": planned,
                   "codec_launches": codec,
                   "q_counters": comm.q_counters(),
                   "q_bytes": (_q_bytes(engine, comm.q_counters(), 2 * steps)
                               if quant else None),
                   "inert": engine._inert_config_keys,
                   "host_state_bytes": (engine._offload_opt.state_bytes()
                                        if engine._offload else None),
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "n_params": sum(int(math.prod(s)) for s in shapes),
                   "device": str(dev)}
            if part == "check":
                res["params_sha256"] = _params_hash(engine)
            else:
                res["params_fingerprint"] = _params_fingerprint(torch, engine)
            out[part][str(stage)] = res
            del engine, model
            torch.cuda.empty_cache()
    comm.barrier()
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    comm.destroy()


def _one_card(torch, dev, layers, micro, steps, variant="0"):
    """Stage 0 on card 0 with no process group (``variant`` "0", or "0off":
    the same with cpu offload)."""
    import chip_smoke
    import deepspeed_tpu_torch

    over = {} if layers is None else {"num_layers": layers}
    model = chip_smoke.train_model("llama-1b4", **over)
    cfg = _config("2off" if variant == "0off" else "0", micro)
    cfg["zero_optimization"] = dict(cfg["zero_optimization"], stage=0)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg)
    check_plain = not engine._dist
    tok = _tokens(torch, model.config.vocab_size, 2 * micro, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    steps_out, _ = _train(torch, engine, (tok, tok), steps)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cfg = model.config
    del engine, model
    torch.cuda.empty_cache()
    return steps_out, peak, cfg, check_plain


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "zero_multichip"))
    p.add_argument("--rank-run", action="store_true")
    p.add_argument("--check", default=CHECK,
                   help="the variants checked at --layers (comma-separated)")
    p.add_argument("--timed", default=TIMED,
                   help="the variants timed at full depth (comma-separated)")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    os.makedirs(args.out, exist_ok=True)
    if args.rank_run:
        rank_run(args)
        return 0
    import torch

    import chip_smoke
    from chip_smoke import BF16_FLOPS_PER_S, check

    check(torch.cuda.device_count() >= args.ranks,
          f"{args.ranks} ranks need {args.ranks} cards, "
          f"{torch.cuda.device_count()} here")
    dev = torch.device("cuda:0")
    print(chip_smoke.gpu_identity())
    chip_smoke.phase_build(torch, dev)
    refs = {}
    checked = args.check.split(",") if args.check else []
    offloads = any(VARIANTS[v][2] for v in checked)
    for variant in ("0", "0off") if offloads else ("0",):
        ref, _, _, plain = _one_card(torch, dev, args.layers, MICRO * args.ranks,
                                     CHECK_STEPS, variant)
        check(plain, "the one-card reference took the distributed path")
        refs[variant] = ref
        print(f"one card, stage 0{' cpu offload' if variant == '0off' else ''}, "
              f"{args.layers} layers, micro {MICRO * args.ranks} x gas 2 x S {S}: "
              f"losses {[x[0] for x in ref]} grad norms {[x[1] for x in ref]}")
    one, one_peak, cfg, _ = _one_card(torch, dev, None, MICRO, TIMED_STEPS)
    one_med = statistics.median(x[2] for x in one[2:])
    print(f"one card, stage 0, llama-1b4 {cfg.num_layers} layers, micro {MICRO} x gas 2: "
          f"median step {one_med:.4f}s, peak {one_peak:.2f} GiB")
    one_host = None
    if "2off" in args.timed.split(","):
        off, off_peak, _, _ = _one_card(torch, dev, None, MICRO, TIMED_STEPS, "0off")
        one_host = statistics.median(x[3] for x in off[2:])
        print(f"one card, stage 0 cpu offload, llama-1b4 {cfg.num_layers} layers: "
              f"median step {statistics.median(x[2] for x in off[2:]):.4f}s, host step "
              f"{one_host:.1f} ms, peak {off_peak:.2f} GiB")
    for name in os.listdir(args.out):
        if name.startswith("rank") and name.endswith(".json"):
            os.remove(os.path.join(args.out, name))
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc_per_node={args.ranks}", os.path.abspath(__file__),
                          "--rank-run", "--layers", str(args.layers), "--out", args.out,
                          "--check", args.check, "--timed", args.timed],
                         cwd=ROOT, timeout=1500)
    print(f"torchrun: rc {run.returncode} in {time.perf_counter() - t:.1f}s")
    check(run.returncode == 0, "torchrun failed")
    ranks = []
    for r in range(args.ranks):
        with open(os.path.join(args.out, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    ok = True

    def rel(got, want, i):
        return max(abs(a[i] - b[i]) / abs(b[i]) for a, b in zip(got, want))

    def q_line(res, steps):
        """A quantized variant's int8 wire bytes a step a rank against the
        dense twin's, by op."""
        wire, dense = res["q_bytes"]
        ops = {op: {"calls": r["calls"] // steps, "bytes": r["bytes"]}
               for op, r in res["q_counters"].items()}
        launches = {k: v // steps for k, v in res["codec_launches"].items()}
        return (f"int8 wire {wire / steps / 1e9:.4f} GB a step a rank against the "
                f"dense twin's {dense / steps / 1e9:.4f} GB "
                f"({wire / dense:.4f} of it){'; ' + json.dumps(ops) if ops else ''}; "
                f"codec launches a step a rank {json.dumps(launches)}")

    for stage in args.check.split(",") if args.check else []:
        got = ranks[0]["check"][stage]
        dense = VARIANTS[stage][4]
        ref = (ranks[0]["check"][dense]["steps"] if dense
               else refs["0off" if VARIANTS[stage][2] else "0"])
        same = all(rk["check"][stage]["steps"][i][:2] == got["steps"][i][:2]
                   and rk["check"][stage]["params_sha256"] == got["params_sha256"]
                   for rk in ranks for i in range(CHECK_STEPS))
        dl, dn = rel(got["steps"], ref, 0), rel(got["steps"], ref, 1)
        planned = dense is not None or all(rk["check"][stage]["planned"] for rk in ranks)
        lb, nb = (Q_LOSS_RTOL, Q_NORM_RTOL) if dense else (1e-3, 1e-2)
        good = same and planned and dl <= lb and dn <= nb and not got["inert"]
        ok &= good
        per_step = {op: {k: v[k] // CHECK_STEPS for k in ("calls", "bytes")}
                    for op, v in got["counters"].items()}
        print(f"world {args.ranks} stage {stage}: losses {[x[0] for x in got['steps']]} "
              f"grad norms {[x[1] for x in got['steps']]}; against "
              f"{'variant ' + dense if dense else 'one card'}: losses "
              f"{dl:.2e}, grad norms {dn:.2e} relative (bounds {lb:g}, {nb:g}); every "
              f"rank the same losses and params: {same}; collectives a step "
              f"{json.dumps(per_step)}"
              f"{'; each micro-batch the bucket plan: ' + str(planned) if VARIANTS[stage][1] and not dense else ''}"
              f"{'; ' + q_line(got, CHECK_STEPS) if dense else ''}"
              f"{'; host state a rank ' + str(got['host_state_bytes']) + ' B' if VARIANTS[stage][2] else ''}; "
              f"peak {max(rk['check'][stage]['peak_gib'] for rk in ranks):.2f} GiB; "
              f"{'ok' if good else 'FAILED'}")
    tokens = 2 * MICRO * S * args.ranks
    attn = 6 * cfg.num_layers * 2 * MICRO * cfg.num_heads * S * S * cfg.head_dim
    timed = args.timed.split(",") if args.timed else []
    for stage in timed:
        res = ranks[0]["timed"][stage]
        meds = [statistics.median(x[2] for x in rk["timed"][stage]["steps"][2:])
                for rk in ranks]
        if VARIANTS[stage][2]:
            hosts = [statistics.median(x[3] for x in rk["timed"][stage]["steps"][2:])
                     for rk in ranks]
            print(f"world {args.ranks} stage {stage}: host step a rank (median of steps "
                  f"3-5) {[round(h, 1) for h in hosts]} ms against one card's "
                  f"{one_host:.1f} ms; host state a rank "
                  f"{ranks[0]['timed'][stage]['host_state_bytes']} B")
        same = all(rk["timed"][stage]["steps"][i][:2] == res["steps"][i][:2]
                   and rk["timed"][stage]["params_fingerprint"] == res["params_fingerprint"]
                   for rk in ranks for i in range(TIMED_STEPS))
        ok &= same
        dense = VARIANTS[stage][4]
        against = ""
        if dense:
            good = not res["inert"]
            if dense in timed:
                want = ranks[0]["timed"][dense]["steps"]
                dl, dn = rel(res["steps"], want, 0), rel(res["steps"], want, 1)
                good &= dl <= Q_LOSS_RTOL and dn <= Q_NORM_RTOL
                against = (f"against variant {dense}: losses {dl:.2e}, grad norms "
                           f"{dn:.2e} relative (bounds {Q_LOSS_RTOL:g}, {Q_NORM_RTOL:g}); ")
            ok &= good
            against += q_line(res, TIMED_STEPS) + f"; {'ok' if good else 'FAILED'}; "
        med = max(meds)
        n = res["n_params"]
        flops = 6 * n * 2 * MICRO * S + attn            # a card's share
        counts = res["counters"]
        gb = sum(v["bytes"] for v in counts.values()) / TIMED_STEPS / 1e9
        print(f"world {args.ranks} stage {stage}, llama-1b4 {cfg.num_layers} layers, "
              f"micro {MICRO} x gas 2 a rank: losses {[x[0] for x in res['steps']]} "
              f"grad norms {[x[1] for x in res['steps']]}; every rank the same losses "
              f"and params: {same}; {against}median step {med:.4f}s (ranks "
              f"{[round(m, 4) for m in meds]}), {tokens / med:.1f} tokens/s over "
              f"{args.ranks} cards ({tokens / med / args.ranks:.1f} a card; one card "
              f"{2 * MICRO * S / one_med:.1f}), MFU {100 * flops / med / BF16_FLOPS_PER_S:.2f}% "
              f"a card; peak {max(rk['timed'][stage]['peak_gib'] for rk in ranks):.2f} GiB "
              f"a rank (one card {one_peak:.2f}); collectives {gb:.3f} GB a step a rank "
              f"{json.dumps({op: v['calls'] // TIMED_STEPS for op, v in counts.items()})} calls")
    check(ok, "a variant missed its reference or the ranks differ")
    print(json.dumps({"ok": True, "ranks": args.ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
