#!/usr/bin/env python3
"""How often a short torch.profiler session on one CUDA card comes back
without some or all of its kernels' records, with and without host sleeps
around the profiled calls, and with the host's cores idle or kept busy.

    python3 profiler_probe.py [--sessions N] [--pads 0,0.005,0.05] [--load 0,8]
    python3 profiler_probe.py --card-tests EXPR
    python3 profiler_probe.py --smoke-kernels N

Each session profiles 200 calls of ``y.copy_(x)`` at [8, 1600] bf16 (the
shortest session ``chip_smoke.device_us_a_call`` takes) and, as a longer
one, 10 calls of a [4096, 4096] bf16 matmul.  A session is whole when every
kernel or copy it holds has a record for each call.  For every session the
probe also reads the gaps between the first call's runtime launch (host
clock) and the first record on the device, and between the last record on
the device and the end of the synchronize that waits for it: a negative
gap means the device's records were placed outside the host's window.
``--load K`` keeps K processes spinning on the host while the sessions run
(stopped at the end).  Prints the card's name and power limit and one JSON
line of counts and gaps; imports nothing of JAX.

``--card-tests EXPR`` runs the card tests ``-k EXPR`` of
``tests/test_torch_cuda.py`` in this process with every profiler session
of their ``_profiled_kernels`` counted: sessions alternate between CUDA
activities alone and CPU and CUDA together, and a session is lost when it
misses a kernel the test asks for (it is taken again, up to 8 times).
Prints each session and one JSON line of the counts by activities.

``--first-record N`` runs N fresh processes, each 24 sessions of 50
``copy_`` calls at [8, 1600] bf16, alternately with and without a marker
launch (``torch.cuda._sleep``) ahead of the calls, and counts for each
session the copies' records three ways: among kineto's raw results
(``prof.profiler.kineto_results.events()``), among the profiler's events and
in ``key_averages()``, with the offset of the first device record from
the trace's start.  A record missing from all three was dropped by kineto
or CUPTI before torch parsed the trace; one in the raw results alone, by
torch's parsing.  One JSON line a session, one of the counts at the end.

``--smoke-kernels N`` builds the kernels (``chip_smoke.phase_build``), then
runs ``chip_smoke.phase_build`` and ``phase_kernels`` in N fresh processes,
one after another, and counts in each the ``device_us_a_call`` sessions
that lost their opening marker's record, that lost a call's record, and
whether the phase passed; one JSON line of the counts.  ``--fresh-build``
empties the kernel cache (``build/torch_kernels``) and gives Triton a new
cache directory before each process, so that each builds every kernel
itself, as a first smoke run does.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def gaps(prof):
    """(first device start - first host launch, last host sync end - last
    device end) in us, from the session's events."""
    dev, launch, sync = [], [], []
    for e in prof.events():
        r = e.time_range
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev.append((r.start, r.end))
        elif e.name.startswith(("cudaLaunchKernel", "cudaMemcpyAsync", "cuLaunchKernel")):
            launch.append(r.start)
        elif e.name.startswith(("cudaDeviceSynchronize", "cudaStreamSynchronize")):
            sync.append(r.end)
    if not dev or not launch or not sync:
        return None, None
    return (min(a for a, _ in dev) - min(launch), max(sync) - max(b for _, b in dev))


def session(torch, call, calls, pad):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        time.sleep(pad)
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    whole = bool(ev) and all(e.count == calls for e in ev)
    return whole, bool(ev), gaps(prof)


def smoke_kernels(n, fresh=False) -> int:
    """chip_smoke's kernels phase in ``n`` processes: the marker's and the
    calls' lost records, and the phase's result, each process."""
    import os
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, torch; sys.path.insert(0, {root!r}); import chip_smoke as c; "
            "d = torch.device('cuda'); c.phase_build(torch, d){kernels}")
    subprocess.run([sys.executable, "-c", code.format(root=root, kernels="")],
                   cwd=root, capture_output=True, check=True)
    rows = []
    env = dict(os.environ)
    for i in range(n):
        if fresh:
            shutil.rmtree(os.path.join(root, "build", "torch_kernels"),
                          ignore_errors=True)
            env["TRITON_CACHE_DIR"] = tempfile.mkdtemp(prefix="triton_")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", code.format(
            root=root, kernels="; c.phase_kernels(torch, d)")], cwd=root,
            capture_output=True, text=True, env=env)
        out = run.stdout + run.stderr
        row = {"process": i, "fresh_build": fresh, "rc": run.returncode,
               "marker_lost": out.count("lost the marker's record"),
               "call_record_lost": out.count(" calls; a repeat")
               + out.count("no profile session"),
               "split_session_empty": out.count("holds none of"),
               "s": round(time.perf_counter() - t0, 1)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"smoke_kernels": rows}))
    return 0


def first_record_child(sessions: int) -> int:
    """One process of ``--first-record``: see the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x = torch.randn(8, 1600, device=dev).to(torch.bfloat16)
    y = torch.empty_like(x)
    for _ in range(3):
        y.copy_(x)
    torch.cuda.synchronize()
    calls = 50
    for k in range(sessions):
        marker = k % 2 == 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            if marker:
                torch.cuda._sleep(1)
            for _ in range(calls):
                y.copy_(x)
            torch.cuda.synchronize()
            time.sleep(0.02)
        res = prof.profiler.kineto_results
        start = res.trace_start_ns()
        raw = [e for e in res.events() if str(e.device_type()).endswith("CUDA")]
        copies = [e for e in raw if "Memcpy" in e.name()]
        events = [e for e in prof.events() if "Memcpy" in e.name
                  and str(getattr(e, "device_type", "")).endswith("CUDA")]
        avg = sum(e.count for e in prof.key_averages() if "Memcpy" in e.key
                  and e.self_device_time_total > 0)
        first = min((e.start_ns() for e in raw), default=None)
        print(json.dumps({"session": k, "marker": marker, "calls": calls,
                          "raw_copies": len(copies), "events": len(events),
                          "key_averages": avg,
                          "marker_raw": sum("spin" in e.name() for e in raw),
                          "first_device_ms": None if first is None
                          else (first - start) / 1e6}), flush=True)
    return 0


def first_record(n: int) -> int:
    """``--first-record``: the child in ``n`` fresh processes; the counts."""
    rows = []
    for i in range(n):
        run = subprocess.run([sys.executable, __file__, "--first-record-child", "24"],
                             capture_output=True, text=True)
        got = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith("{")]
        for r in got:
            r["process"] = i
        lost = [r for r in got if r["key_averages"] < r["calls"]]
        print(json.dumps({"process": i, "rc": run.returncode, "sessions": len(got),
                          "lost": len(lost), "lost_rows": lost[:6]}), flush=True)
        if run.returncode:
            print(run.stderr[-2000:], flush=True)
        rows.extend(got)
    summary = {}
    for r in rows:
        key = ("marker" if r["marker"] else "plain") + (
            " whole" if r["key_averages"] == r["calls"] else
            " raw_lost" if r["raw_copies"] < r["calls"] else " parse_lost")
        summary[key] = summary.get(key, 0) + 1
    print(json.dumps({"first_record": summary, "processes": n}))
    return 0


def card_tests(expr) -> int:
    """The card tests ``-k expr`` with their profiler sessions counted by
    activities (see the module docstring)."""
    import pytest
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tests.test_torch_cuda as cuda_tests

    counts = {}

    def profiled(fn, want=(), sessions=8):
        for calls in range(1, sessions + 1):
            acts = ([ProfilerActivity.CUDA] if calls % 2 else
                    [ProfilerActivity.CPU, ProfilerActivity.CUDA])
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                time.sleep(0.02)
                fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
            names = [e.key for e in prof.key_averages()
                     if e.self_device_time_total > 0]
            whole = all(any(w in k for k in names) for w in want)
            key = f"{'+'.join(a.name for a in acts)} {'whole' if whole else 'lost'}"
            counts[key] = counts.get(key, 0) + 1
            print(f"session {calls} {key}: {len(names)} kernels", flush=True)
            if whole:
                break
        return names, calls

    cuda_tests._profiled_kernels = profiled
    rc = pytest.main(["--noconftest", "-m", "cuda", "tests/test_torch_cuda.py",
                      "-q", "-p", "no:cacheprovider", "-s", "-k", expr])
    print(json.dumps({"profiler_probe_card_tests": counts, "pytest_rc": int(rc)}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=300)
    ap.add_argument("--pads", default="0,0.005,0.05")
    ap.add_argument("--load", default="0,8")
    ap.add_argument("--card-tests", default=None)
    ap.add_argument("--smoke-kernels", type=int, default=0)
    ap.add_argument("--fresh-build", action="store_true")
    ap.add_argument("--first-record", type=int, default=0)
    ap.add_argument("--first-record-child", type=int, default=0)
    args = ap.parse_args()
    if args.first_record_child:
        return first_record_child(args.first_record_child)
    import torch

    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if args.card_tests is not None:
        return card_tests(args.card_tests)
    if args.smoke_kernels:
        return smoke_kernels(args.smoke_kernels, args.fresh_build)
    if args.first_record:
        return first_record(args.first_record)
    dev = torch.device("cuda")
    x = torch.randn(8, 1600, device=dev).to(torch.bfloat16)
    y = torch.empty_like(x)
    a = torch.randn(4096, 4096, device=dev).to(torch.bfloat16)
    cases = {"copy_[8,1600]x200": (lambda: y.copy_(x), 200),
             "matmul[4096]x10": (lambda: a @ a, 10)}
    for call, _ in cases.values():
        for _ in range(3):
            call()
    torch.cuda.synchronize()
    result = []
    for load in (int(v) for v in args.load.split(",")):
        spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(load)]
        try:
            for pad in (float(v) for v in args.pads.split(",")):
                for name, (call, calls) in cases.items():
                    n = args.sessions if calls > 10 else max(1, args.sessions // 5)
                    t0, runs = time.perf_counter(), [session(torch, call, calls, pad)
                                                     for _ in range(n)]
                    first = [g[0] for _, _, g in runs if g[0] is not None]
                    last = [g[1] for _, _, g in runs if g[1] is not None]
                    row = {"load": load, "pad_s": pad, "case": name, "sessions": n,
                           "not_whole": sum(not w for w, _, _ in runs),
                           "empty": sum(not e for _, e, _ in runs),
                           "first_gap_us": [min(first), statistics.median(first)]
                           if first else None,
                           "last_gap_us": [min(last), statistics.median(last)]
                           if last else None,
                           "s": time.perf_counter() - t0}
                    print(json.dumps(row), flush=True)
                    result.append(row)
        finally:
            for p in spin:
                p.kill()
                p.wait()
    print(json.dumps({"profiler_probe": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
