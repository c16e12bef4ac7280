"""The port's Adam8bit and LAMB against the JAX package, on the CPU.

Inputs and noise come from numpy with a seed; weights cross over with
``jax_params_to_torch``.  A CPU tensor runs each kernel wrapper's plain
version; the JAX side runs its jnp path (``impl="xla"``) and its Pallas
kernel in interpret mode (``impl="interpret"``).  Tolerances, with their
reasons:

- ``fused_adam8bit`` one step from the same state, no stochastic
  rounding: new p within 1e-6 relative (the same fp32 formula; XLA may
  contract a product and a sum into one FMA); codes within one step, at
  no more than 1e-3 of the positions (a value within one rounding of a .5
  boundary, or, in interpret mode, a scale folded into a product with the
  fp32 reciprocal of 127: see ``tests/test_torch_quantizer.py``); scales
  within 2 ulp (an absmax of values one FMA contraction apart, then that
  folded reciprocal);
- stochastic rounding cannot run in interpret mode on the CPU (no PRNG
  lowering), and the port's noise is its own hash, so it is held to JAX's
  jnp path by its distribution: every result is one of the two bf16
  neighbours of the fp32 update, and over 64 seeds the mean rounding error
  of both is under 0.02 of a bf16 ulp (its standard error is ~0.003);
- ``fused_lamb_update`` plain against interpret and xla: 1e-6 (the norms
  summed in another order move the trust ratio by a few ulp);
- engines, llama-tiny with 2 layers over 3 steps (one-device mesh, fp32
  unless stated): FusedLamb and Lamb weights within 1e-5 (LAMB's update is
  scaled to ||p|| per leaf, so a 1e-7 relative difference in the grads
  stays a 1e-7 relative difference of the step); Adam8bit: at least 99 %
  of the weights within 1e-6 and every weight within lr / 16: one int8
  code of m is 1/127 of its row's absmax, and where the two sides round a
  code differently that element's step moves by up to one code over
  sqrt(v), a few hundredths of lr here (lr / 16 is still a sixteenth of
  one Adam step, so a wrong formula fails); master-free bf16 (Adam8bit,
  bf16 accumulator): losses agree
  within 2e-2 relative (bf16 weights and the stochastic rounding's
  different noise), fall on both, and every leaf is bf16 on both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.ops.adam.fused_adam import fused_adam as j_fused_adam
from deepspeed_tpu.ops.pallas import fused_adam8bit as j8
from deepspeed_tpu.ops.pallas import fused_lamb as jlamb
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from deepspeed_tpu_torch.ops.adam import Adam8bit, FusedAdam
from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as t8
from deepspeed_tpu_torch.ops.kernels import fused_lamb as tlamb
from deepspeed_tpu_torch.ops.lamb import FusedLamb
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.optimizer import build_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
KW8 = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pad2d(x, rows, block):
    flat = np.zeros(rows * block, x.dtype)
    flat[: x.size] = x.reshape(-1)
    return flat.reshape(rows, block)


# ---------------------------------------------------------------------------
# fused_adam8bit
# ---------------------------------------------------------------------------

def _adam8bit_state(n, block, steps, seed):
    """A state reached by ``steps`` plain updates of an fp32 leaf (non-zero
    codes and scales), and the leaf itself."""
    rows = t8.state_rows(n, block)
    p = torch.from_numpy(_np((n,), seed))
    mq = torch.zeros(rows, block, dtype=torch.int8)
    vq = torch.zeros(rows, block, dtype=torch.int8)
    ms, vs = torch.ones(rows, 1), torch.ones(rows, 1)
    for t in range(1, steps + 1):
        g = torch.from_numpy(_np((n,), seed + 100 + t, 0.1))
        t8.fused_adam8bit_update_plain(p, g, mq, ms, vq, vs, t, lr=1e-2, **KW8)
    return p, mq, ms, vq, vs


def _codes_close(j, t):
    d = np.abs(np.asarray(j).astype(np.int32) - t.numpy().astype(np.int32))
    assert d.max(initial=0) <= 1
    assert (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("n,block,pdtype", [(5000, 128, np.float32),
                                            (20000, 512, np.float32),
                                            (9000, 1024, jnp.bfloat16),
                                            (4096, 4096, np.float32)])
@pytest.mark.parametrize("step", [1, 2, 3])
def test_fused_adam8bit_matches_jax_from_the_same_state(impl, n, block, pdtype,
                                                        step):
    """One step from the same state at steps 1-3; ragged n (neither a
    multiple of the block nor filling 32 rows), the padding rows compared
    too; bf16 params without stochastic rounding."""
    p, mq, ms, vq, vs = _adam8bit_state(n, block, step - 1, seed=step)
    g = _np((n,), 7 * step, 0.1)
    rows = mq.shape[0]
    tp = p.to(torch.bfloat16) if pdtype == jnp.bfloat16 else p.clone()
    c1, c2 = t8.bias_corrections(step, KW8["beta1"], KW8["beta2"])
    lr = 1e-2 * step
    out = j8.fused_adam8bit_update(
        jnp.asarray(_pad2d(tp.float().numpy(), rows, block)).astype(pdtype),
        jnp.asarray(_pad2d(g, rows, block)), jnp.asarray(mq.numpy()),
        jnp.asarray(ms.numpy()), jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()),
        c1, c2, lr, 0, b1=KW8["beta1"], b2=KW8["beta2"], eps=KW8["eps"],
        wd=KW8["weight_decay"], sr=False, impl=impl)
    # the JAX inputs may share the state's memory (a zero-copy transfer on
    # the CPU) and JAX runs asynchronously: finish it before the port
    # updates the state in place
    out = jax.block_until_ready(out)
    t8.fused_adam8bit_update(tp, torch.from_numpy(g), mq, ms, vq, vs, step,
                             lr=lr, **KW8)
    jp = np.asarray(out[0].astype(jnp.float32)).reshape(-1)[:n]
    if pdtype == np.float32:
        np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=1e-6)
    else:       # each the bf16 rounding of fp32 values 1e-6 apart
        np.testing.assert_array_max_ulp(tp.float().numpy(), jp, maxulp=1 << 16)
    for j, t in ((out[1], mq), (out[3], vq)):
        _codes_close(j, t)
    for j, t in ((out[2], ms), (out[4], vs)):
        np.testing.assert_array_max_ulp(np.asarray(j), t.numpy(), maxulp=2)


def test_fused_adam8bit_never_writes_p_past_n_and_keeps_padding_rows():
    n, block = 1000, 128                                # 8 rows of 32
    buf = torch.full((n + 24,), 7.0)
    p = buf[:n]
    rows = t8.state_rows(n, block)
    mq = torch.zeros(rows, block, dtype=torch.int8)
    vq = torch.zeros_like(mq)
    ms, vs = torch.ones(rows, 1), torch.ones(rows, 1)
    t8.fused_adam8bit_update(p, torch.from_numpy(_np((n,), 1)), mq, ms, vq, vs,
                             1, lr=1e-2, **KW8)
    assert bool((buf[n:] == 7.0).all())
    assert rows == 32
    assert bool((ms[8:] == 1).all() and (vs[8:] == 1).all())
    assert int(mq[8:].abs().max()) == 0 and int(mq[7, n - 7 * block:].abs().max()) == 0


def test_fused_adam8bit_refuses_a_wrong_layout():
    n = 1000
    p, g = torch.zeros(n), torch.zeros(n)
    s = torch.ones(8, 1)
    q = torch.zeros(8, 128, dtype=torch.int8)          # not rounded up to 32 rows
    with pytest.raises(ValueError, match="rows"):
        t8.fused_adam8bit_update(p, g, q, s, q.clone(), s.clone(), 1, lr=1e-3)
    with pytest.raises(ValueError, match="power of two"):
        Adam8bit([torch.zeros(4)], block_size=384)


def test_mix32_on_tensors_equals_the_integer_hash():
    xs = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF]
    xs += list(np.random.default_rng(0).integers(0, 1 << 32, 1000, dtype=np.int64))
    got = t8._mix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [t8.mix32_int(int(x)) for x in xs]
    # a known value: the hash is a bijection of 32-bit words, not the identity
    assert t8.mix32_int(1) != 1 and len(set(got)) == len(set(xs))
    # the seed follows the JAX int32 wrap: count * 1000003 + i * 7919
    assert t8.sr_seed(3000, 2) == (3000 * 1000003 + 2 * 7919) % (1 << 32)
    assert t8.sr_seed(1, 0) == 1000003


def _neighbours(x32):
    """The two bf16 values around each fp32 value, the smaller magnitude
    first (equal when exact)."""
    bits = x32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    down = bits & 0xFFFF0000
    up = torch.where((bits & 0xFFFF) != 0, down + 0x10000, down)
    as_f = lambda b: torch.where(b >= 1 << 31, b - (1 << 32), b).to(
        torch.int32).view(torch.float32)
    return as_f(down), as_f(up)


def test_stochastic_rounding_is_unbiased_and_follows_jax_in_distribution():
    """The fp32 update of a bf16 leaf over 64 seeds, port and JAX's jnp
    path: each rounded value is one of the two bf16 neighbours of the fp32
    update, it rounds up about as often as its position between them says,
    and the mean error over all elements is near zero."""
    n, block, seeds = 4096, 128, 64                      # 32 rows: JAX's tile
    rows = t8.state_rows(n, block)
    p = torch.from_numpy(_np((n,), 0)).to(torch.bfloat16)
    g = torch.from_numpy(_np((n,), 1, 0.1))
    zq = torch.zeros(rows, block, dtype=torch.int8)
    ones = torch.ones(rows, 1)
    exact = p.float()
    t8.fused_adam8bit_update(exact, g, zq.clone(), ones.clone(), zq.clone(),
                             ones.clone(), 1, lr=1e-3, **KW8)
    lo, hi = _neighbours(exact)
    moving = hi != lo               # hi is the larger magnitude
    ulp = (hi - lo).double()[moving]
    frac = (exact.double() - lo.double())[moving] / ulp
    assert int(moving.sum()) > n // 2
    c1, c2 = t8.bias_corrections(1, KW8["beta1"], KW8["beta2"])
    ups = {"port": [], "jax": []}
    for s in range(seeds):
        tp = p.clone()
        t8.fused_adam8bit_update(tp, g, zq.clone(), ones.clone(), zq.clone(),
                                 ones.clone(), 1, lr=1e-3, seed=s, sr=True,
                                 **KW8)
        out = j8.fused_adam8bit_update(
            jnp.asarray(p.float().numpy()).astype(jnp.bfloat16).reshape(rows, block),
            jnp.asarray(g.numpy()).reshape(rows, block), jnp.asarray(zq.numpy()),
            jnp.ones((rows, 1)), jnp.asarray(zq.numpy()), jnp.ones((rows, 1)),
            c1, c2, 1e-3, s, b1=KW8["beta1"], b2=KW8["beta2"], eps=KW8["eps"],
            wd=KW8["weight_decay"], sr=True, impl="xla")
        jgot = torch.from_numpy(np.asarray(out[0].astype(jnp.float32))).reshape(-1)
        for key, got in (("port", tp.float()), ("jax", jgot)):
            assert bool(((got == lo) | (got == hi)).all()), key
            ups[key].append((got == hi)[moving].double())
    for key, draws in ups.items():
        rate = torch.stack(draws).mean(0)
        # 64 draws of each element: standard error <= 0.0625, mean abs
        # deviation ~0.04; over ~4000 elements the mean bias ~0.002
        assert float((rate - frac).mean().abs()) < 0.02, key
        assert float((rate - frac).abs().mean()) < 0.06, key
    # the port's noise does not repeat from seed to seed
    assert not torch.equal(ups["port"][0], ups["port"][1])


# ---------------------------------------------------------------------------
# fused_lamb
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("n,wd", [(1000, 0.0), (4099, 0.01), (128 * 600, 0.1)])
def test_fused_lamb_update_matches_jax_over_three_steps(impl, n, wd):
    """A ragged leaf (no multiple of the 128-lane tile), one that is, and
    the weight decay on and off."""
    p = _np((n,), 0)
    jp, jm, jv = jnp.asarray(p), jnp.zeros(n), jnp.zeros(n)
    tp, tm, tv = torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)
    before = (tlamb.lamb_phase1.launches, tlamb.lamb_scale.launches)
    for step in (1, 2, 3):
        g = _np((n,), step, 0.1)
        kw = dict(lr=1e-2 * step, beta1=0.9, beta2=0.999, eps=1e-6,
                  weight_decay=wd)
        jp, jm, jv = jlamb.fused_lamb_update(jp, jnp.asarray(g), jm, jv,
                                             jnp.int32(step), impl=impl, **kw)
        stats = tlamb.fused_lamb_update(tp, torch.from_numpy(g), tm, tv, step,
                                        **kw)
        assert stats.shape == (3,)
        assert float(stats[0]) > 0 and float(stats[1]) > 0
    assert (tlamb.lamb_phase1.launches, tlamb.lamb_scale.launches) == before
    for j, t in ((jp, tp), (jm, tm), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_lamb_trust_ratio_is_one_for_a_zero_leaf():
    """``where(w > 0 & u > 0, w / u, 1)``: a zero parameter takes the plain
    Adam step at lr."""
    n = 300
    p, m, v = torch.zeros(n), torch.zeros(n), torch.zeros(n)
    g = torch.from_numpy(_np((n,), 1))
    stats = tlamb.fused_lamb_update(p, g, m, v, 1, lr=0.5)
    assert float(stats[0]) == 0.0 and float(stats[2]) == 0.5
    jp, *_ = jlamb.fused_lamb_update(jnp.zeros(n), jnp.asarray(g.numpy()),
                                     jnp.zeros(n), jnp.zeros(n), jnp.int32(1),
                                     lr=0.5, impl="xla")
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the optimizers and the builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("type_name,params,cls,fused,eps", [
    ("FusedLamb", {}, FusedLamb, True, 1e-6),
    ("FusedLamb", {"torch_lamb": True}, FusedLamb, False, 1e-8),
    ("Lamb", {}, FusedLamb, False, 1e-8),
    ("FusedLamb", {"eps": 1e-5}, FusedLamb, True, 1e-5),
    ("Adam8bit", {}, Adam8bit, None, 1e-8),
    ("AdamW8bit", {"block_size": 128, "min_quant_size": 64}, Adam8bit, None,
     1e-8)])
def test_build_optimizer_maps_the_new_types(type_name, params, cls, fused, eps):
    opt = build_optimizer(type_name, dict(params, lr=1e-3), [torch.zeros(8)])
    assert type(opt) is cls and opt.param_groups[0]["eps"] == eps
    if fused is not None:
        assert opt.fused is fused
    else:
        assert opt.block == params.get("block_size", 512)
        assert opt.min_quant_size == params.get("min_quant_size", 4096)
        assert opt.updates_are_new_params


@pytest.mark.parametrize("type_name", ["OneBitAdam", "ZeroOneAdam",
                                       "OneBitLamb", "onebit_adam",
                                       "Zero-One-Adam"])
def test_build_optimizer_still_refuses_the_rest(type_name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(type_name, {}, [torch.zeros(8)])


def test_adam8bit_state_layout_and_bytes():
    big, small = torch.zeros(5000), torch.zeros(100)
    opt = Adam8bit([big, small], lr=1e-3, block_size=128)
    opt.step(grads=[torch.ones(5000), torch.ones(100)])
    st = opt.state[big]
    assert st["m_q"].shape == (64, 128) and st["m_q"].dtype == torch.int8
    assert st["m_scale"].shape == (64, 1) and st["v_scale"].dtype == torch.float32
    assert set(opt.state[small]) == {"m_q", "v_q"}
    assert opt.state[small]["m_q"].dtype == torch.float32
    assert opt.state_bytes() == 2 * 64 * 128 + 2 * 64 * 4 + 2 * 100 * 4


def _schedule_case(opt_cls, j_opt, **kw):
    """One leaf, three steps, a WarmupLR from 0: the port's optimizer and
    the JAX transformation from the same grads."""
    params = {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
              "warmup_num_steps": 4, "warmup_type": "linear"}
    js, ts = (jlr.get_lr_schedule("WarmupLR", params),
              tlr.get_lr_schedule("WarmupLR", params))
    p0 = _np((300,), 0)
    jx = j_opt(js, **kw)
    jparams = {"w": jnp.asarray(p0)}
    jstate = jx.init(jparams)
    tp = torch.from_numpy(p0.copy())
    topt = opt_cls([tp], lr=ts, **kw)
    lrs, moved = [], []
    for step in (1, 2, 3):
        g = _np((300,), 10 + step)
        lrs.append(topt.current_lr(topt.param_groups[0]))
        before = tp.clone()
        upd, jstate = jx.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = {"w": jparams["w"] + upd["w"]}
        topt.step(grads=[torch.from_numpy(g)])
        moved.append(not torch.equal(before, tp))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jparams["w"]),
                                   rtol=1e-6, atol=1e-6)
    return lrs, moved, ts


def test_fused_lamb_takes_the_schedule_at_the_1_based_count():
    lrs, moved, ts = _schedule_case(FusedLamb, jlamb.fused_lamb, eps=1e-6)
    assert lrs == [float(ts(1)), float(ts(2)), float(ts(3))]
    assert moved == [True, True, True]        # lr(1) > 0 moves the first step


def test_fused_adam_takes_the_schedule_at_the_0_based_count():
    lrs, moved, ts = _schedule_case(FusedAdam, j_fused_adam, eps=1e-8)
    assert lrs == [float(ts(0)), float(ts(1)), float(ts(2))]
    assert moved == [False, True, True]       # lr(0) == 0: the first step stays


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _config(opt_type, **over):
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": opt_type, "params": {
               "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0, "steps_per_print": 10**9}
    cfg.update(over)
    return cfg


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _train_both(cfg, steps=3):
    """The JAX engine (one-device mesh) and the port's from the same
    params and batches; returns both engines and their per-step losses."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev_mesh = mesh_mod._GLOBAL_MESH
    try:
        jm = j_causal_lm("llama-tiny", **TINY)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        np_params = jax.tree.map(np.asarray, params)
        tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
        mesh = build_mesh(devices=jax.devices()[:1])
        jeng, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                            config=cfg, mesh=mesh)
        teng, *_ = deepspeed_tpu_torch.initialize(
            model=tm, model_parameters=np_params, config=cfg, device="cpu")
        tok = np.random.default_rng(10).integers(
            0, TINY["vocab_size"], (4, 32)).reshape(2, 2, 32)
        losses = {"j": [], "t": []}
        for _ in range(steps):
            for key, eng in (("j", jeng), ("t", teng)):
                losses[key].append(float(eng.train_step((tok, tok))))
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    return jeng, teng, losses


def _weights(jeng, teng):
    jflat = dict(_flat(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), jeng.state.params)))
    tflat = dict(_flat(torch_params_to_numpy(
        {k: v for k, v in teng.params().items()})))
    assert set(jflat) == set(tflat)
    return jflat, tflat


@pytest.mark.parametrize("opt_type", ["FusedLamb", "Lamb"])
def test_lamb_engines_match_jax(opt_type):
    jeng, teng, losses = _train_both(_config(opt_type))
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=1e-5)
    assert losses["t"][2] < losses["t"][0]
    jflat, tflat = _weights(jeng, teng)
    for path in jflat:
        np.testing.assert_allclose(tflat[path], jflat[path], atol=1e-5, rtol=0,
                                   err_msg=path)
    assert teng.optimizer.fused is (opt_type == "FusedLamb")


def test_adam8bit_engine_matches_jax():
    cfg = _config("Adam8bit")
    jeng, teng, losses = _train_both(cfg)
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=1e-5)
    assert losses["t"][2] < losses["t"][0]
    jflat, tflat = _weights(jeng, teng)
    lr = cfg["optimizer"]["params"]["lr"]
    diffs = np.concatenate([np.abs(tflat[k] - jflat[k]).reshape(-1)
                            for k in jflat])
    assert (diffs <= 1e-6).mean() >= 0.99
    for path in jflat:
        np.testing.assert_allclose(tflat[path], jflat[path], atol=lr / 16,
                                   rtol=0, err_msg=path)
    # the state compares with JAX's element for element: same layout, codes
    # within one step; scales within 1/127 relative (after three steps a
    # row's absmax may itself be one code of an earlier step apart)
    assert all(p.dtype == torch.float32 for p in teng.master)
    opt = teng.optimizer
    jst = jeng.state.opt_state
    names = dict(zip(teng._paths, teng.master))
    jmq = dict(_flat(jax.tree.map(np.asarray, jst.m_q)))
    jms = dict(_flat(jax.tree.map(np.asarray, jst.m_scale)))
    for path, p in names.items():
        st = opt.state[p]
        assert tuple(st["m_q"].shape) == jmq[path].shape, path
        if opt.quantized(p):
            _codes_close(jmq[path], st["m_q"])
            np.testing.assert_allclose(st["m_scale"].numpy(), jms[path],
                                       rtol=1 / 127, err_msg=path)


def test_master_free_bf16_adam8bit_engine_follows_jax():
    cfg = _config("Adam8bit", bf16={"enabled": True, "master_weights": False},
                  data_types={"grad_accum_dtype": "bf16"})
    jeng, teng, losses = _train_both(cfg, steps=4)
    assert losses["j"][-1] < losses["j"][0] and losses["t"][-1] < losses["t"][0]
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=2e-2)
    assert all(p.dtype == torch.bfloat16 for p in teng.master)
    assert all(a.dtype == torch.bfloat16 for a in teng.grad_acc)
    assert all(v.dtype == torch.bfloat16 for _, v in _flat(teng.params()))
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(jeng.state.params))
    # the compute copy is the masters themselves: no second bf16 copy
    assert all(b is p for b, p in zip(teng._compute_bufs, teng.master))


def test_master_free_with_a_round_to_nearest_optimizer_warns(caplog):
    tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
    cfg = _config("FusedAdam", bf16={"enabled": True, "master_weights": False})
    with caplog.at_level("WARNING"):
        eng, *_ = deepspeed_tpu_torch.initialize(model=tm, config=cfg,
                                                 device="cpu")
    assert "sub-ulp" in caplog.text
    assert all(p.dtype == torch.bfloat16 for p in eng.master)
