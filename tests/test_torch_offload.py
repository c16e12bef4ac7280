"""ZeRO-Offload of the optimizer state in the port against the JAX package,
on the CPU.

Inputs come from numpy with a seed; the JAX engine runs on a one-device
mesh at stage 0, the port's engine with ``device="cpu"``.  Checked:

- the host steppers (``csrc/cpu_adam.cpp``, built here with the JAX
  builder's flags): the port's Adam (fp32 and bf16 grads), Adagrad and Lion
  over three steps bit-equal to the JAX package's classes, and within rtol
  1e-5 (atol 1e-6, as the JAX package's own native-against-numpy test) of
  each one's plain torch version;
- the NVMe backend bit-equal to the cpu backend, and its ``state_{i}.bin``
  files read by the other package's swapper, both ways;
- the engine against the JAX engine, three steps of gas 2 with AdamW,
  WarmupLR and clipping 1.0.  fp32 compute at ``tests/test_torch_train.
  py``'s bounds: loss and grad norm rtol 1e-5, host masters atol 1e-4.
  bf16 compute (the bf16-grad host step) and fp16 compute (one forced
  overflow) at the bounds their rounding allows: the two packages round
  the forward's 16-bit activations at other places, which moves the loss
  by ~2e-4 relative in bf16 (~5e-6 in fp16) and a grad norm by ~3e-3; so
  losses rtol 1e-3, grad norms 1e-2, and the masters 95 % within 1e-4 and
  all within 1e-2 (where a gradient element near zero changes sign, Adam's
  normalised step moves by up to 2 lr); the skips, the loss scales and
  ``global_steps`` equal;
- the memory contract, the choice of host optimizer, the int8 host store
  against the JAX class's codes and scales, and the refusals.
"""

import logging
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.ops.adagrad import DeepSpeedCPUAdagrad as JAdagrad
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JAdam
from deepspeed_tpu.ops.lion import DeepSpeedCPULion as JLion
from deepspeed_tpu.runtime.swap_tensor import OptimizerStateSwapper as JSwapper
from deepspeed_tpu.runtime.zero.offload import OffloadedOptimizer as JOffloaded
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.ops.adagrad import DeepSpeedCPUAdagrad, adagrad_step_plain
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, adam_step_plain
from deepspeed_tpu_torch.ops.aio import aio_handle
from deepspeed_tpu_torch.ops.lion import DeepSpeedCPULion, lion_step_plain
from deepspeed_tpu_torch.runtime.swap_tensor import OptimizerStateSwapper
from deepspeed_tpu_torch.runtime.zero.offload import OffloadedOptimizer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
ADAMW = {"lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW", "params": ADAMW},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
        "gradient_clipping": 1.0, "steps_per_print": 10**9}


def _off(device="cpu", **kw):
    return {"zero_optimization": {"stage": 0, "offload_optimizer": dict(
        device=device, **kw)}}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


# ---------------------------------------------------------------------------
# (a) the host steppers
# ---------------------------------------------------------------------------

STEPPERS = {
    "adam": dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                 adamw_mode=True),
    "adam_l2": dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                    adamw_mode=False),
    "adagrad": dict(lr=1e-2, eps=1e-10, weight_decay=0.01),
    "lion": dict(lr=1e-3, betas=(0.9, 0.99), weight_decay=0.01),
}
CLASSES = {"adam": (JAdam, DeepSpeedCPUAdam), "adam_l2": (JAdam, DeepSpeedCPUAdam),
           "adagrad": (JAdagrad, DeepSpeedCPUAdagrad), "lion": (JLion, DeepSpeedCPULion)}
STATES = {"adam": ("exp_avg", "exp_avg_sq"), "adam_l2": ("exp_avg", "exp_avg_sq"),
          "adagrad": ("exp_avg_sq",), "lion": ("exp_avg",)}


def _plain_step(family, p, g, st, step, kw):
    if family.startswith("adam"):
        adam_step_plain(p, g, st["exp_avg"], st["exp_avg_sq"], step, kw["lr"],
                        kw["betas"], kw["eps"], kw["weight_decay"], kw["adamw_mode"])
    elif family == "adagrad":
        adagrad_step_plain(p, g, st["exp_avg_sq"], kw["lr"], kw["eps"],
                           kw["weight_decay"])
    else:
        lion_step_plain(p, g, st["exp_avg"], kw["lr"], kw["betas"],
                        kw["weight_decay"])


@pytest.mark.parametrize("n", [1000, 150001])      # one chunk; the pool's chunks
@pytest.mark.parametrize("family", list(STEPPERS))
def test_host_stepper_bit_equal_to_jax_and_near_its_plain_version(family, n):
    kw = STEPPERS[family]
    jcls, tcls = CLASSES[family]
    p0 = _np((n,), 0)
    jopt = jcls(params=[p0.copy()], **kw)
    topt = tcls(params=[_t(p0)], **kw)
    plain_p = _t(p0)
    plain_st = {k: torch.zeros(n) for k in STATES[family]}
    for step in (1, 2, 3):
        g = _np((n,), step, 0.5)
        jopt.step([g])
        topt.step([_t(g)])
        _plain_step(family, plain_p, _t(g), plain_st, step, kw)
    _eq(topt.params[0], jopt.params[0], "params")
    for k in STATES[family]:
        _eq(topt.state[0][k], jopt.state[0][k], k)
        np.testing.assert_allclose(topt.state[0][k].numpy(), plain_st[k].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(topt.params[0].numpy(), plain_p.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1000, 150001])
def test_bf16_grad_adam_step_bit_equal_to_jax(n):
    """``ds_adam_step_bf16g``: bf16 grads in, bf16 params out (round to
    nearest even), the fp32 master and moments stepped, through each
    package's ``OffloadedOptimizer.step_leaf_bf16``."""
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    p0 = _np((n,), 0)
    jopt = JOffloaded({"w": p0}, **kw)
    topt = OffloadedOptimizer({"w": _t(p0)}, **kw)
    pp, pm, pv = _t(p0), torch.zeros(n), torch.zeros(n)
    for step in (1, 2, 3):
        g = _np((n,), step, 0.5)
        gj = g.astype(ml_dtypes.bfloat16)
        gt = _t(g).to(torch.bfloat16)
        _eq(gt.view(torch.int16), gj.view(np.int16), "bf16 grads")
        outj = np.empty(n, ml_dtypes.bfloat16)
        outt = torch.empty(n, dtype=torch.bfloat16)
        for opt, args in ((jopt, (gj, outj)), (topt, (gt, outt))):
            opt.begin_step(lr=kw["lr"] * step)
            opt.step_leaf_bf16(0, *args)
            opt.end_step()
        _eq(outt.view(torch.int16), outj.view(np.int16), "bf16 params")
        adam_step_plain(pp, gt.float(), pm, pv, step, kw["lr"] * step, kw["betas"],
                        kw["eps"], kw["weight_decay"], True)
    for a, b in zip(topt._leaf_states(0), jopt._leaf_states(0)):
        _eq(a, b)
    assert torch.equal(outt, topt.masters()[0].to(torch.bfloat16))
    np.testing.assert_allclose(topt.masters()[0].numpy(), pp.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_a_host_library_that_does_not_build_raises(monkeypatch, tmp_path):
    """No fallback: without g++ the host steppers raise at construction."""
    from deepspeed_tpu_torch.ops.op_builder import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "_CACHE", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        DeepSpeedCPUAdam()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        aio_handle()


# ---------------------------------------------------------------------------
# (b) the NVMe backend and its state files
# ---------------------------------------------------------------------------

def _tree():
    return {"a": _np((300,), 1), "b": {"c": _np((70001,), 2), "d": _np((5, 7), 3)}}


def _grads(opt, step):
    return [_np((s,), 10 * step + i) for i, s in enumerate(opt._sizes)]


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("family", ["adam", "adagrad", "lion"])
def test_nvme_backend_bit_equal_to_cpu_backend(family, pipeline, tmp_path):
    tree = _tree()
    kw = dict(lr=1e-2, opt_type=family, weight_decay=0.01)
    cpu = OffloadedOptimizer(jax.tree.map(_t, tree), **kw)
    nvme = OffloadedOptimizer(jax.tree.map(_t, tree), backend="nvme",
                              swap_dir=str(tmp_path), pipeline=pipeline,
                              pipeline_write=pipeline, **kw)
    for step in (1, 2, 3):
        gs = _grads(cpu, step)
        out_c = cpu.step([_t(g) for g in gs])
        out_n = nvme.step([_t(g) for g in gs])
        for a, b in zip(out_n, out_c):
            _eq(a, b)
    for i in range(len(cpu._sizes)):
        for a, b in zip(nvme._leaf_states(i), cpu._leaf_states(i)):
            _eq(a, b)
    assert sorted(os.listdir(tmp_path)) == [f"state_{i}.bin" for i in range(3)]
    # state_dict of one backend loads into the other
    fresh = OffloadedOptimizer(jax.tree.map(_t, tree), **kw)
    fresh.load_state_dict(nvme.state_dict())
    assert fresh.step_count == 3
    for i in range(len(cpu._sizes)):
        for a, b in zip(fresh._leaf_states(i), cpu._leaf_states(i)):
            _eq(a, b)


def test_state_files_cross_read_between_the_packages(tmp_path):
    """The port's ``state_{i}.bin`` read by the JAX swapper, and the JAX
    optimizer's read by the port's: the same bytes in the same layout."""
    tree = _tree()
    dp, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    popt = OffloadedOptimizer(jax.tree.map(_t, tree), backend="nvme", swap_dir=dp,
                              lr=1e-2)
    jopt = JOffloaded(tree, backend="nvme", swap_dir=dj, lr=1e-2)
    assert popt._paths == jopt._paths and popt._sizes == jopt._sizes
    for step in (1, 2):
        gs = _grads(popt, step)
        popt.step([_t(g) for g in gs])
        jopt.step(gs)
    jsw = JSwapper(dp, popt._sizes, n_slots=3)
    psw = OptimizerStateSwapper(dj, jopt._sizes, n_slots=3)
    for i in range(3):
        _eq(jsw.read_sync(i), torch.cat(popt._leaf_states(i)), f"port leaf {i}")
        _eq(psw.read_sync(i), np.concatenate(jopt._leaf_states(i)), f"jax leaf {i}")
        # the two runs took the same steps from the same inputs
        _eq(psw.read_sync(i), jsw.read_sync(i), f"leaf {i}")


def test_nvme_failures_raise(tmp_path):
    """An nvme backend that cannot open its path raises, and so does a
    read of a state file that is not there: never a quiet fallback."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        OffloadedOptimizer({"w": torch.ones(8)}, backend="nvme",
                           swap_dir=str(blocker / "swap"))
    sw = OptimizerStateSwapper(str(tmp_path / "empty"), [8], n_slots=3)
    with pytest.raises(RuntimeError, match="nvme read failed"):
        sw.read_sync(0)
    with pytest.raises(ValueError, match="nvme_path"):
        deepspeed_tpu_torch.initialize(
            model=t_causal_lm("llama-tiny", device="cpu", **TINY),
            config=dict(BASE, **_off("nvme")), device="cpu")


# ---------------------------------------------------------------------------
# (c) the engine against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "fp32": {},
    "bf16": {"bf16": {"enabled": True}},
    # hysteresis 1 halves the scale at the first overflow: from 2^17 the
    # second step overflows, the third does not
    "fp16_skip": {"fp16": {"enabled": True, "initial_scale_power": 17,
                           "hysteresis": 1}},
}


@pytest.fixture(scope="module")
def jax_init():
    jm = j_causal_lm("llama-tiny", **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jm, params, jax.tree.map(np.asarray, params)


def _batches(n):
    rng = np.random.default_rng(7)
    return [rng.integers(0, TINY["vocab_size"], (4, 32)) for _ in range(n)]


def _record(eng, tok):
    loss = float(eng.train_step((tok, tok)))
    return (loss, float(eng.get_global_grad_norm()), bool(eng._last_overflow),
            float(eng.loss_scale), int(eng.global_steps))


@pytest.fixture(scope="module")
def engine_runs(jax_init, tmp_path_factory):
    from deepspeed_tpu.comm import mesh as mesh_mod

    jm, params, np_params = jax_init
    prev = mesh_mod._GLOBAL_MESH
    out = {}
    try:
        mesh = build_mesh(devices=jax.devices()[:1])
        for name, over in ENGINE_CASES.items():
            cfg = dict(BASE, **_off(), **over)
            je = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                          config=cfg, mesh=mesh)[0]
            te = deepspeed_tpu_torch.initialize(
                model=t_causal_lm("llama-tiny", device="cpu", **TINY),
                model_parameters=np_params, config=cfg, device="cpu")[0]
            recs = [(_record(je, tok), _record(te, tok)) for tok in _batches(3)]
            out[name] = dict(je=je, te=te, recs=recs)
        # the same bf16 run on the nvme backend, port only
        cfg = dict(BASE, **_off("nvme", nvme_path=str(tmp_path_factory.mktemp("swap"))),
                   **ENGINE_CASES["bf16"])
        te = deepspeed_tpu_torch.initialize(
            model=t_causal_lm("llama-tiny", device="cpu", **TINY),
            model_parameters=np_params, config=cfg, device="cpu")[0]
        out["nvme_bf16"] = dict(te=te, recs=[_record(te, tok) for tok in _batches(3)])
    finally:
        mesh_mod._GLOBAL_MESH = prev
    return out


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_steps_match_the_jax_engine(engine_runs, case):
    strict = case == "fp32"
    for (j, t) in engine_runs[case]["recs"]:
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5 if strict else 1e-3)
        np.testing.assert_allclose(t[1], j[1], rtol=1e-5 if strict else 1e-2)
        assert t[2:] == j[2:]          # skip, loss scale, global_steps
    te, je = engine_runs[case]["te"], engine_runs[case]["je"]
    assert te._offload_opt.step_count == je._offload_opt.step_count
    if case == "fp16_skip":
        assert [r[1][2] for r in engine_runs[case]["recs"]] == [False, True, False]
        assert te.skipped_steps == 1 and te.global_steps == 2


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_host_masters_match_the_jax_engine(engine_runs, case):
    te, je = engine_runs[case]["te"], engine_runs[case]["je"]
    assert te._offload_opt._paths == je._offload_opt._paths
    d = np.concatenate([np.abs(a.numpy() - b).ravel() for a, b in
                        zip(te._offload_opt.masters(), je._offload_opt.masters())])
    if case == "fp32":
        assert d.max() <= 1e-4
    else:
        assert d.max() <= 1e-2 and (d <= 1e-4).mean() >= 0.95, (d.max(), (d <= 1e-4).mean())
    # the card's params are the host masters in the compute dtype
    for j, m in zip(te._offload_order, te._offload_opt.masters()):
        assert torch.equal(te.master[j].reshape(-1), m.to(te.compute_dtype))


def test_nvme_engine_bit_equal_to_cpu_engine(engine_runs):
    cpu, nvme = engine_runs["bf16"], engine_runs["nvme_bf16"]
    assert [r[1] for r in cpu["recs"]] == nvme["recs"]
    for a, b in zip(nvme["te"]._offload_opt.masters(), cpu["te"]._offload_opt.masters()):
        _eq(a, b)
    for a, b in zip(nvme["te"].master, cpu["te"].master):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (d) the memory contract, (e) the choice of host optimizer
# ---------------------------------------------------------------------------

def test_offload_engine_holds_no_optimizer_state(engine_runs):
    """The port's form of ``test_cpu_offload_device_holds_no_optimizer_
    state``: the engine itself holds only the compute-dtype params, the
    accumulators and the loss scale; every optimizer tensor is the host
    optimizer's, fp32 on the host and never a view of a param."""
    te = engine_runs["bf16"]["te"]
    assert te.optimizer is te._offload_opt and te._offload_device == "cpu"
    assert all(p.dtype == torch.bfloat16 for p in te.master)
    assert all(a.dtype == torch.float32 for a in te.grad_acc)
    held = [v for v in vars(te).values() if torch.is_tensor(v)]
    held += [x for v in vars(te).values() if isinstance(v, list)
             for x in v if torch.is_tensor(x)]
    ptrs = {t.data_ptr() for t in te.master + te.grad_acc}
    assert all(t.data_ptr() in ptrs or t.dim() == 0 for t in held)
    opt = te._offload_opt
    host = opt.masters() + [a for aux in opt._aux for a in aux]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in host)
    assert not {t.data_ptr() for t in host} & ptrs
    assert opt.state_bytes() == 12 * sum(p.numel() for p in te.master)


@pytest.mark.parametrize("opt_type,family,stepper", [
    ("Adagrad", "adagrad", DeepSpeedCPUAdagrad), ("Lion", "lion", DeepSpeedCPULion),
    ("SGD", "adam", DeepSpeedCPUAdam), ("client", "adam", DeepSpeedCPUAdam)])
def test_offload_picks_the_host_optimizer_as_the_jax_engine(jax_init, caplog,
                                                            opt_type, family, stepper):
    from deepspeed_tpu.comm import mesh as mesh_mod

    jm, params, np_params = jax_init
    section = ({"optimizer": {"type": opt_type, "params": {"lr": 1e-2}}}
               if opt_type != "client" else {})
    cfg = dict(BASE, **_off(), **section)
    model = t_causal_lm("llama-tiny", device="cpu", **TINY)
    client = (torch.optim.SGD(list(model.parameters()), lr=0.1)
              if opt_type == "client" else None)
    with caplog.at_level(logging.WARNING):
        te = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu",
                                            model_parameters=np_params,
                                            optimizer=client)[0]
    assert te._offload_opt.opt_type == family
    assert type(te._offload_opt._stepper) is stepper
    if opt_type == "SGD":
        assert "stepped by DeepSpeedCPUAdam" in caplog.text
    if opt_type == "client":
        assert "client optimizer (SGD) is ignored" in caplog.text
    prev = mesh_mod._GLOBAL_MESH
    try:
        je = deepspeed_tpu.initialize(
            model=jm, model_parameters=params, config=cfg,
            mesh=build_mesh(devices=jax.devices()[:1]),
            optimizer=None if client is None else optax.sgd(0.1))[0]
    finally:
        mesh_mod._GLOBAL_MESH = prev
    assert je._offload_opt.opt_type == family
    for tok in _batches(2):        # WarmupLR's first lr is 0
        _record(te, tok)
        _record(je, tok)
    d = np.concatenate([np.abs(a.numpy() - b).ravel() for a, b in
                        zip(te._offload_opt.masters(), je._offload_opt.masters())])
    if family == "lion":
        # the sign of a sum flips where the sum is within rounding of zero
        assert d.max() <= 2.02 * 3e-3 and (d <= 1e-4).mean() >= 0.999
    else:
        assert d.max() <= 1e-4


def test_the_deprecated_cpu_offload_spelling_offloads():
    """``zero_optimization.cpu_offload: true`` is ``offload_optimizer:
    {device: cpu}``, as the JAX config reads it."""
    te = deepspeed_tpu_torch.initialize(
        model=t_causal_lm("llama-tiny", device="cpu", **TINY),
        config=dict(BASE, zero_optimization={"stage": 0, "cpu_offload": True}),
        device="cpu")[0]
    assert te._offload and te._offload_opt.backend == "cpu"


# ---------------------------------------------------------------------------
# (f) int8 host masters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["adam", "adagrad", "lion"])
def test_int8_masters_codes_and_scales_equal_the_jax_class(family):
    tree = _tree()
    kw = dict(lr=1e-2, opt_type=family, weight_decay=0.01, int8_masters=True,
              quant_block=64)
    popt = OffloadedOptimizer(jax.tree.map(_t, tree), **kw)
    jopt = JOffloaded(tree, **kw)
    for step in (1, 2):
        gs = _grads(popt, step)
        for a, b in zip(popt.step([_t(g) for g in gs]), jopt.step(gs)):
            _eq(a, b)
    for i in range(3):
        for (pq, ps), (jq, js) in zip(
                [popt._master_q[i]] + [a[i] for a in popt._aux_q],
                [jopt._master_q[i]] + [a[i] for a in jopt._aux_q]):
            _eq(pq, jq, "codes")
            _eq(ps, js, "scales")
    assert popt.relay_leaf(0)[0].dtype == np.int8


def test_int8_masters_engine_relays_codes_and_refuses_nvme(jax_init, tmp_path):
    _, _, np_params = jax_init
    cfg = dict(BASE, **_off(int8_masters=True, quant_block=64),
               bf16={"enabled": True})
    te = deepspeed_tpu_torch.initialize(
        model=t_causal_lm("llama-tiny", device="cpu", **TINY),
        model_parameters=np_params, config=cfg, device="cpu")[0]
    recs = [_record(te, tok) for tok in _batches(2)]
    assert recs[-1][0] < 10 and te._offload_opt.step_count == 2
    # the card's params are the dequantized codes in the compute dtype
    for j, m in zip(te._offload_order, te._offload_opt.masters()):
        assert torch.equal(te.master[j].reshape(-1), m.to(torch.bfloat16))
    with pytest.raises(ValueError, match="int8_masters"):
        OffloadedOptimizer({"w": torch.ones(8)}, backend="nvme",
                           int8_masters=True, swap_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# (h) refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero,item", [
    ({"stage": 0, "offload_param": {"device": "cpu", "stream_grads": False}},
     "the whole-program offload_param path"),
    # ids kept from when every stage >= 1 was refused; offload_optimizer
    # runs at every stage now, offload_param beyond stage 0 is refused
    pytest.param({"stage": 1, "offload_param": {"device": "cpu"}},
                 "item 2e, offload_param across ranks",
                 id="zero1-ZeRO 1-3 over torch.distributed"),
    pytest.param({"stage": 3, "offload_optimizer": {"device": "cpu"},
                  "offload_param": {"device": "nvme", "nvme_path": "/x"}},
                 "item 2e, offload_param across ranks",
                 id="zero2-ZeRO 1-3 over torch.distributed")])
def test_unported_offload_settings_are_refused_naming_their_item(zero, item):
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.initialize(
            model=t_causal_lm("llama-tiny", device="cpu", **TINY),
            config=dict(BASE, zero_optimization=zero), device="cpu")
