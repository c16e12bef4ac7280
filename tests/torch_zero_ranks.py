"""Rank processes for the port's data-parallel tests: no jax here.

:class:`RankGroup` spawns ``world`` processes that join one gloo process
group over a ``FileStore`` in a temporary directory (no socket), run
``fn(rank, world, *args)`` and send back its result; a rank that raises,
or a group that does not finish within ``timeout`` seconds, fails the
test that reads the results (the ranks are killed).  A spawned child
re-imports this module and the module of ``fn``, so neither may import
jax; each collective also times out on its own (``collective_timeout``).

The scenarios the ranks run are here too (:func:`train_run` and its
callers), as the CPU tests hold them against the JAX engine.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _entry(rank, world, store_path, fn, args, results, collective_timeout):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from deepspeed_tpu_torch.comm import comm

        comm.init_distributed(
            device="cpu", rank=rank, world_size=world, verbose=False,
            store=dist.FileStore(store_path, world),
            timeout=datetime.timedelta(seconds=collective_timeout))
        out = fn(rank, world, *args)
        results.put((rank, "ok", out))
        comm.destroy()
    except BaseException:                  # sent to the test, which fails
        results.put((rank, "error", traceback.format_exc()))


class RankGroup:
    """``world`` spawned ranks running ``fn``; :meth:`results` waits for
    them."""

    def __init__(self, world: int, fn: Callable, args: tuple = (),
                 timeout: float = 240.0, collective_timeout: float = 120.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._dir = tempfile.mkdtemp(prefix="ds_ranks_")
        self._q = ctx.Queue()
        self._procs = [ctx.Process(target=_entry, daemon=True,
                                   args=(r, world, os.path.join(self._dir, "store"),
                                         fn, args, self._q, collective_timeout))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._out: Optional[List[Any]] = None

    def results(self) -> List[Any]:
        """Each rank's result, in rank order (raises for a failed rank or a
        timeout)."""
        if self._out is not None:
            return self._out
        got: Dict[int, Any] = {}
        errors = []
        try:
            for _ in range(self.world):
                rank, status, out = self._q.get(timeout=self.timeout)
                if status == "ok":
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        except queue.Empty:
            errors.append(f"ranks {sorted(set(range(self.world)) - set(got))} "
                          f"did not finish in {self.timeout:.0f} s")
        finally:
            for p in self._procs:
                p.join(timeout=5 if not errors else 0.1)
                if p.is_alive():
                    p.kill()
            shutil.rmtree(self._dir, ignore_errors=True)
        if errors:
            raise RuntimeError("\n".join(errors))
        self._out = [got[r] for r in range(self.world)]
        return self._out

    def close(self) -> None:
        """Kill any rank still running (results never read)."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        shutil.rmtree(self._dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def flat(tree: Dict[str, Any], prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, path)
        else:
            yield path, v


def rank_rows(batch, rank: int, world: int):
    """Rank ``rank``'s rows of a stacked global batch ``[gas, micro *
    world, ...]`` (a leaf, a tuple or a dict of them)."""
    if isinstance(batch, dict):
        return {k: rank_rows(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(rank_rows(x, rank, world) for x in batch)
    mb = batch.shape[1] // world
    return np.ascontiguousarray(batch[:, rank * mb:(rank + 1) * mb])


def build_engine(preset: str, model_kw: dict, np_params, config: dict):
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm(preset, device="cpu", **model_kw)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=np_params, config=config, device="cpu")
    return engine


def full_params(engine) -> Dict[str, np.ndarray]:
    """The engine's full params as numpy (a collective at stage 3)."""
    return {k: v.detach().float().numpy().copy() for k, v in flat(engine.params())}


def overlap_info(engine) -> Optional[Dict[str, Any]]:
    """The engine's overlap schedule as plain data (None without one): its
    comm plan entries, buckets, leaf assignment, the counters of its last
    micro-batch, and the inert config keys."""
    sched = engine._overlap_sched
    if sched is None:
        return None
    return {"entries": [tuple(e) for e in sched.comm_plan_entries()],
            "infos": [tuple(i) for i in sched.bucket_infos()],
            "assignment": sched.bucket_assignment(), "last": sched.last_counts,
            "plan_counts": sched.plan_counts(),
            "hideable": sched.hideable_comm_fraction()}


def offload_info(engine) -> Optional[Dict[str, Any]]:
    """The host optimizer's slices as plain data (None without offload):
    its fp32 masters in its leaf order, each leaf's place (full shape and
    this rank's region, None for a whole leaf), its paths, its state bytes
    and its swap directory's parent's entries (nvme)."""
    import os

    opt = getattr(engine, "_offload_opt", None)
    if opt is None:
        return None
    swap = None
    if opt.backend == "nvme":
        swap = sorted(os.listdir(os.path.dirname(opt._swapper.dir)))
    return {"masters": [m.numpy().copy() for m in opt.masters()],
            "places": engine._offload_places(), "paths": list(opt._paths),
            "bytes": opt.state_bytes(), "swap_dirs": swap,
            "step_count": opt.step_count}


def train_run(rank, world, preset, model_kw, np_params, config, batches,
              save_dir=None, save_after=None):
    """Train on this rank's rows of each global batch; returns per step
    (loss, grad norm), the full params, the overlap schedule's data and,
    when ``save_dir`` is given, saves after step ``save_after``."""
    engine = build_engine(preset, model_kw, np_params, config)
    steps, scaler = [], []
    for i, b in enumerate(batches):
        loss = engine.train_step(rank_rows(b, rank, world))
        steps.append((float(loss), engine.get_global_grad_norm()))
        scaler.append((engine._last_overflow, engine.loss_scale, engine.global_steps))
        if save_dir is not None and i + 1 == save_after:
            engine.save_checkpoint(save_dir, tag="resume")
    return {"steps": steps, "params": full_params(engine), "scaler": scaler,
            "overlap": overlap_info(engine), "inert": engine._inert_config_keys,
            "offload": offload_info(engine)}


def overlap_ckpt_scenarios(rank, world, preset, model_kw, np_params, configs,
                           batches, root):
    """Tags across ``overlap_comm``: for each of ``configs`` (``"on"`` and
    ``"off"``) an engine trains two steps, saves a tag ``root/<name>`` and
    takes the third; a fresh engine of the other setting loads that tag and
    takes the third."""
    import os

    out = {}
    for name, cfg in configs.items():
        engine = build_engine(preset, model_kw, np_params, cfg)
        for b in batches[:2]:
            engine.train_step(rank_rows(b, rank, world))
        saved = full_params(engine)
        engine.save_checkpoint(os.path.join(root, name), tag="t")
        loss = engine.train_step(rank_rows(batches[2], rank, world))
        run = (float(loss), engine.get_global_grad_norm())
        other = "off" if name == "on" else "on"
        fresh = build_engine(preset, model_kw, np_params, configs[other])
        fresh.load_checkpoint(os.path.join(root, name))
        loaded = full_params(fresh)
        loss = fresh.train_step(rank_rows(batches[2], rank, world))
        out[name] = {"saved": saved, "run": run, "loaded": loaded,
                     "loaded_overlap": fresh._overlap,
                     "resumed": (float(loss), fresh.get_global_grad_norm()),
                     "params": full_params(fresh), "run_params": full_params(engine)}
    return out


def state_numels(engine) -> List[Any]:
    """Per leaf: (path, master numel, [optimizer state numels], accumulator
    numel, pdim, odim, param, opt, acc)."""
    out = []
    for i, (path, m) in enumerate(zip(engine._paths, engine.master)):
        p = engine._opt_params[i]
        st = [v.numel() for v in engine.optimizer.state[p].values()
              if torch.is_tensor(v) and v.dim() > 0]
        pl = engine._plan[i]
        out.append((path, m.numel(), st, engine.grad_acc[i].numel(), pl.pdim,
                    pl.odim, pl.param, pl.opt, pl.acc))
    return out


def zeropp_run(rank, world, preset, model_kw, np_params, config, batches,
               root=None, other=None):
    """The ZeRO++ path: train, and with ``root`` save a tag after step 2
    and the 16-bit export after step 3; a fresh engine loads the tag and
    takes step 3; an engine of the ``other`` config refuses the tag."""
    import os

    engine = build_engine(preset, model_kw, np_params, config)
    out = {"zeropp": engine._zeropp, "reason": engine._zeropp_reason,
           "inert": engine._inert_config_keys}
    steps = []
    for i, b in enumerate(batches):
        if root is not None and i == 2:
            engine.save_checkpoint(root, tag="t")
            out["saved"] = full_params(engine)
        loss = engine.train_step(rank_rows(b, rank, world))
        steps.append((float(loss), engine.get_global_grad_norm()))
    out.update(steps=steps, params=full_params(engine), qcounts=None)
    if root is None:
        return out
    from deepspeed_tpu_torch.comm import comm

    comm.reset_counters()
    export = engine.save_16bit_model(os.path.join(root, "export"))
    fresh = build_engine(preset, model_kw, np_params, config)
    fresh.load_checkpoint(root, tag="t")
    out["loaded"] = full_params(fresh)
    loss = fresh.train_step(rank_rows(batches[2], rank, world))
    out["resumed"] = (float(loss), fresh.get_global_grad_norm())
    out["resumed_params"] = full_params(fresh)
    out["export"] = export
    if other is not None:
        wrong = build_engine(preset, model_kw, np_params, other)
        try:
            wrong.load_checkpoint(root, tag="t")
            out["refused"] = None
        except ValueError as exc:
            out["refused"] = str(exc)
    return out


def collectives_run(rank, world, inputs, block):
    """Every quantized collective on this rank's rows of ``inputs`` (name
    -> [world, ...] arrays), over the world (and hpZ subgroups of 2 at
    world 4); their outputs as numpy, and the q counters."""
    from deepspeed_tpu_torch.comm import collectives_q as cq
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.comm import quantized as rq

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(inputs[name][rank]))

    def n(x):
        return x.detach().float().numpy().copy()

    comm.reset_counters()
    out = {}
    x1, x2 = t("ar"), t("ar2")
    o1, r1 = cq.q_all_reduce(x1, None, block=block, residual=torch.zeros_like(x1))
    o2, r2 = cq.q_all_reduce(x2, None, block=block, residual=r1)
    out["q_all_reduce_ef"] = [n(o1), n(r1), n(o2), n(r2)]
    o3, _ = cq.q_all_reduce(t("ar_bf16").to(torch.bfloat16), None, block=block,
                            mean=False)
    out["q_all_reduce_sum_bf16"] = [n(o3)]
    tree, _ = cq.q_all_reduce_tree({"a": x1, "b": [t("ar2")]}, None, block=block)
    out["q_all_reduce_tree"] = [n(tree["a"]), n(tree["b"][0])]
    out["q_all_gather"] = [n(cq.q_all_gather(t("ag").to(torch.bfloat16), None,
                                             block=block))]
    out["q_all_gather_flat"] = [n(cq.q_all_gather_flat(t("agf"), None, block=block))]
    out["q_all_gather_dim"] = [n(cq.q_all_gather_dim(t("agd"), None, 1, block=block))]
    if world == 4:
        groups = [comm.new_group([0, 1]), comm.new_group([2, 3])]
        out["q_all_gather_flat_hpz"] = [n(cq.q_all_gather_flat(
            t("agf"), groups[rank // 2], block=block))]
    out["q_reduce_scatter_flat"] = [n(cq.q_reduce_scatter_flat(t("rsf"), None,
                                                               block=block))]
    out["q_reduce_scatter"] = [n(cq.q_reduce_scatter(t("rs"), None, block=block))]
    out["q_reduce_scatter_dim"] = [n(cq.q_reduce_scatter_dim(t("rsd"), None, 1,
                                                             block=block))]
    out["q_all_to_all"] = [n(cq.q_all_to_all(t("a2a"), None, 1, 0, block=block))]
    out["quantized_all_gather"] = [n(rq.quantized_all_gather(t("ag"), None, block))]
    out["quantized_reduce_scatter"] = [n(rq.quantized_reduce_scatter(t("rs"), None,
                                                                     block))]
    out["all_to_all_single_quantized"] = [n(comm.all_to_all_single(
        t("a2a"), None, 1, 2, quantized=True, quant_block=block))]
    out["q_counters"] = comm.q_counters()
    return out


def engine_gates(rank, world, preset, model_kw, config):
    """An engine's gates, without a step: the inert keys and the paths."""
    model_over = dict(model_kw)
    engine = build_engine(preset, model_over, None, config)
    sched = engine._overlap_sched
    return {"inert": engine._inert_config_keys, "zeropp": engine._zeropp,
            "zeropp_reason": engine._zeropp_reason,
            "qcomm": engine._qcomm_grads, "qcomm_reason": engine._qcomm_grads_reason,
            "overlap": engine._overlap,
            "qopts": tuple(sched.qcomm) if sched is not None else None}


def zero_scenarios(rank, world, cases):
    """Every world-``world`` case in one group: ``cases`` maps a name to
    ``(kind, kwargs)``."""
    from deepspeed_tpu_torch.comm import comm

    out = {}
    for name, (kind, kw) in cases.items():
        comm.reset_counters()
        if kind == "train":
            res = train_run(rank, world, **kw)
        elif kind == "bytes":
            engine = build_engine(kw["preset"], kw["model_kw"], kw["np_params"],
                                  kw["config"])
            engine.train_step(rank_rows(kw["batch"], rank, world))
            res = {"numels": state_numels(engine)}
        elif kind == "gathered":
            res = gathered_run(rank, world, **kw)
        elif kind == "overlap_ckpt":
            res = overlap_ckpt_scenarios(rank, world, **kw)
        elif kind == "zeropp":
            res = zeropp_run(rank, world, **kw)
        elif kind == "collectives":
            res = collectives_run(rank, world, **kw)
        elif kind == "gates":
            res = engine_gates(rank, world, **kw)
        else:
            raise ValueError(kind)
        res["counters"] = comm.counters()
        out[name] = res
    return out


def gathered_run(rank, world, preset, model_kw, np_params, config, batches):
    """``GatheredParameters`` over a stage-3 engine: rank 0 halves the
    token table (rank 1 writes another value, which the broadcast must
    replace), every rank reads the change back, then one step."""
    import deepspeed_tpu_torch

    engine = build_engine(preset, model_kw, np_params, config)
    with deepspeed_tpu_torch.zero.GatheredParameters(engine=engine,
                                                     modifier_rank=0) as p:
        tok = p["embed"]["tok"]
        if rank == 0:
            tok.mul_(0.5)
        else:
            tok.fill_(7.0)
    seen = full_params(engine)["embed.tok"]
    loss = float(engine.train_step(rank_rows(batches[0], rank, world)))
    return {"seen": seen, "steps": [(loss, engine.get_global_grad_norm())],
            "params": full_params(engine)}


def ckpt_scenarios(rank, world, preset, model_kw, np_params, config, batches,
                   port_dir, jax_dir):
    """Checkpoints over ranks: train two steps, save a tag into
    ``port_dir``, take the third (the run not interrupted); a fresh engine
    loads the tag and takes the third; another loads the JAX engine's tag in
    ``jax_dir`` and takes the third."""
    engine = build_engine(preset, model_kw, np_params, config)
    run = []
    for i, b in enumerate(batches):
        if i == 2:
            engine.save_checkpoint(port_dir, tag="resume")
            saved = full_params(engine)
        loss = engine.train_step(rank_rows(b, rank, world))
        run.append((float(loss), engine.get_global_grad_norm()))
    out = {"run": run, "run_params": full_params(engine), "saved": saved}
    for name, where in (("resumed", port_dir), ("from_jax", jax_dir)):
        fresh = build_engine(preset, model_kw, np_params, config)
        fresh.load_checkpoint(where)
        loaded = full_params(fresh)
        loss = fresh.train_step(rank_rows(batches[2], rank, world))
        out[name] = {"loaded": loaded, "global_steps": fresh.global_steps,
                     "step": (float(loss), fresh.get_global_grad_norm()),
                     "params": full_params(fresh)}
    return out
