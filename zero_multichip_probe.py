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
   localhost) and trains on its rows (micro 4) every variant of
   ``VARIANTS``: stages 0-3, ``overlap_comm`` (bucket 1 layer) at stages
   1-3 and cpu offload at stage 2; the cut model 3 steps each, then the
   full depth 5 steps each (``--timed`` names the variants timed there);
   every rank writes ``<out>/rank{r}.json``.

It prints, beside the card's name and power limit: each variant's losses
and grad norms against its one-card reference (bf16 bounds: losses rtol
1e-3, grad norms 1e-2; the ranks' batches run other GEMM shapes than the
one card's), whether every rank returned the same losses and the same
full params (a hash), the collectives' calls and bytes a step (and under
overlap whether each micro-batch's collectives were the bucket plan), and
for the full depth each variant's median step (steps 3-5) on the slowest
rank, tokens/s over all cards, MFU a card, the peak device memory a rank,
the one-card step beside them and, under offload, the host step a rank
against one card's.  It exits non-zero when a check fails.
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
# name -> (stage, overlap_comm, cpu offload of the optimizer state)
VARIANTS = {"0": (0, False, False), "1": (1, False, False), "2": (2, False, False),
            "3": (3, False, False), "1o": (1, True, False), "2o": (2, True, False),
            "3o": (3, True, False), "2off": (2, False, True)}
TIMED = "0,3,1o,2o,3o,2off"


def _config(variant, micro):
    import chip_smoke

    stage, overlap, offload = VARIANTS[variant]
    zero = {"stage": stage, "stage3_param_persistence_threshold": 0}
    cfg = dict(chip_smoke.TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro)
    if overlap:
        zero.update(chip_smoke.ZERO_OVERLAP)
    if offload:
        zero["offload_optimizer"] = {"device": "cpu"}
        cfg.update(chip_smoke.ADAMW_SECTION)
    cfg["zero_optimization"] = zero
    return cfg


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

    # the models are built on this rank's card before initialize joins
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    out = {"check": {}, "timed": {}}
    rank = world = None
    timed = args.timed.split(",") if args.timed else []
    for part, layers, variants, steps in (("check", args.layers, list(VARIANTS), CHECK_STEPS),
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
            torch.cuda.reset_peak_memory_stats(dev)
            comm.reset_counters()
            steps_out, planned = _train(torch, engine, (batch, batch), steps)
            counts = comm.counters()
            res = {"steps": steps_out, "counters": counts, "planned": planned,
                   "host_state_bytes": (engine._offload_opt.state_bytes()
                                        if engine._offload else None),
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "n_params": sum(int(math.prod(pl.shape)) for pl in engine._plan),
                   "device": str(dev)}
            if part == "check":
                res["params_sha256"] = _params_hash(engine)
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
    for variant in ("0", "0off"):
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
                          "--timed", args.timed],
                         cwd=ROOT, timeout=1500)
    print(f"torchrun: rc {run.returncode} in {time.perf_counter() - t:.1f}s")
    check(run.returncode == 0, "torchrun failed")
    ranks = []
    for r in range(args.ranks):
        with open(os.path.join(args.out, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    ok = True
    for stage in VARIANTS:
        got = ranks[0]["check"][stage]
        ref = refs["0off" if VARIANTS[stage][2] else "0"]
        same = all(rk["check"][stage]["steps"][i][:2] == got["steps"][i][:2]
                   and rk["check"][stage]["params_sha256"] == got["params_sha256"]
                   for rk in ranks for i in range(CHECK_STEPS))
        dl = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got["steps"], ref))
        dn = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got["steps"], ref))
        planned = all(rk["check"][stage]["planned"] for rk in ranks)
        good = same and planned and dl <= 1e-3 and dn <= 1e-2
        ok &= good
        per_step = {op: {k: v[k] // CHECK_STEPS for k in ("calls", "bytes")}
                    for op, v in got["counters"].items()}
        print(f"world {args.ranks} stage {stage}: losses {[x[0] for x in got['steps']]} "
              f"grad norms {[x[1] for x in got['steps']]}; against one card: losses "
              f"{dl:.2e}, grad norms {dn:.2e} relative; every rank the same losses "
              f"and params: {same}; collectives a step {json.dumps(per_step)}"
              f"{'; each micro-batch the bucket plan: ' + str(planned) if VARIANTS[stage][1] else ''}"
              f"{'; host state a rank ' + str(got['host_state_bytes']) + ' B' if VARIANTS[stage][2] else ''}; "
              f"peak {max(rk['check'][stage]['peak_gib'] for rk in ranks):.2f} GiB; "
              f"{'ok' if good else 'FAILED'}")
    tokens = 2 * MICRO * S * args.ranks
    attn = 6 * cfg.num_layers * 2 * MICRO * cfg.num_heads * S * S * cfg.head_dim
    for stage in args.timed.split(",") if args.timed else []:
        meds = [statistics.median(x[2] for x in rk["timed"][stage]["steps"][2:])
                for rk in ranks]
        if VARIANTS[stage][2]:
            hosts = [statistics.median(x[3] for x in rk["timed"][stage]["steps"][2:])
                     for rk in ranks]
            print(f"world {args.ranks} stage {stage}: host step a rank (median of steps "
                  f"3-5) {[round(h, 1) for h in hosts]} ms against one card's "
                  f"{one_host:.1f} ms; host state a rank "
                  f"{ranks[0]['timed'][stage]['host_state_bytes']} B")
        med = max(meds)
        n = ranks[0]["timed"][stage]["n_params"]
        flops = 6 * n * 2 * MICRO * S + attn            # a card's share
        counts = ranks[0]["timed"][stage]["counters"]
        gb = sum(v["bytes"] for v in counts.values()) / TIMED_STEPS / 1e9
        print(f"world {args.ranks} stage {stage}, llama-1b4 {cfg.num_layers} layers, "
              f"micro {MICRO} x gas 2 a rank: median step {med:.4f}s (ranks "
              f"{[round(m, 4) for m in meds]}), {tokens / med:.1f} tokens/s over "
              f"{args.ranks} cards ({tokens / med / args.ranks:.1f} a card; one card "
              f"{2 * MICRO * S / one_med:.1f}), MFU {100 * flops / med / BF16_FLOPS_PER_S:.2f}% "
              f"a card; peak {max(rk['timed'][stage]['peak_gib'] for rk in ranks):.2f} GiB "
              f"a rank (one card {one_peak:.2f}); collectives {gb:.3f} GB a step a rank "
              f"{json.dumps({op: v['calls'] // TIMED_STEPS for op, v in counts.items()})} calls")
    check(ok, "a stage missed the one-card reference or the ranks differ")
    print(json.dumps({"ok": True, "ranks": args.ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
