"""fp16 training in the port against the JAX package, on the CPU.

``fp16.enabled``: float16 compute over fp32 masters, the loss scaled
before the backward, and a step whose accumulated gradients hold an inf or
a NaN skipped while the dynamic scaler halves its scale.  Inputs and
weights come from numpy with a seed; a CPU tensor runs each kernel
wrapper's plain version, the JAX side its jnp path (``impl="xla"``) and,
for the kernels, its Pallas kernel in interpret mode.  Tolerances, with
their reasons:

- the loss scaler: bit-equal (the same fp32 halvings, doublings and floor;
  the same integer trackers);
- ``fused_adam_update`` with fp16 params: p bit-equal (both round the same
  fp32 update to fp16), m and v within 1e-6 (interpret mode sums in
  another order: 3e-8 seen);
- flash attention in fp16 against ``impl="xla"``: 1e-3, one fp16 rounding
  (2^-10 relative at worst) of outputs computed in fp32 in another order;
  against ``impl="interpret"`` 4e-3 elementwise and 1e-3 as a relative
  Frobenius error: the Pallas kernel rounds p and ds to fp16 before its
  products and the plain version does not (2e-3 and 3.8e-4 seen);
- engines, llama-tiny with 2 layers over 3 steps at a static scale of 128:
  losses and grad norms rtol 1e-3 (fp16 activations rounded at other
  places than XLA's fused fp32 chains, each rounding 2^-11 relative; 9e-5
  seen), against the bf16 parity tests' 2e-2; final params: at least
  99.8 % within 2e-4 (a fifteenth of lr 3e-3) and every one within 2 lr.
  A gradient element that is a near-cancelling fp16 sum comes out of the
  two packages' roundings with another small value, even another sign,
  and Adam's early steps (m_hat / sqrt(v_hat) near +-1 whatever the size)
  turn that into up to one step of lr at each of the two applied steps
  (WarmupLR's first is lr 0): 0.1 % of the weights, by up to 1.24 lr, here;
  FusedLamb's trust ratio keeps them all within 2.2e-4;
- the overflow skip: flags, scales and skip counts equal per step, and the
  state of a skipped step bit-equal to the state before it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from deepspeed_tpu.ops.pallas.fused_adam import fused_adam_update as j_adam
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.config import FP16Config as JFP16Config
from deepspeed_tpu.runtime.fp16 import loss_scaler as j_scaler
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfa
from deepspeed_tpu_torch.ops.kernels import fused_adam as tadam
from deepspeed_tpu_torch.runtime import engine as tengine
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.config import FP16Config as TFP16Config
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as t_scaler
from deepspeed_tpu_torch.runtime.utils import has_overflow
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
FP16_MAX = 65504.0      # the largest finite fp16
FP16_INF_FROM = 65520.0  # round to nearest takes this and above to inf


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the loss scaler
# ---------------------------------------------------------------------------

def _scaler_cfg(dynamic, hysteresis, consecutive, window, power):
    return dict(enabled=True, loss_scale=0.0 if dynamic else 1000.0,
                initial_scale_power=power, hysteresis=hysteresis,
                consecutive_hysteresis=consecutive, loss_scale_window=window,
                min_loss_scale=1.0)


def _same_state(js, ts):
    assert np.asarray(js.scale, np.float32).tobytes() == ts.scale.numpy().tobytes()
    assert (int(js.growth_tracker), int(js.hysteresis_tracker),
            int(js.skipped_steps)) == (ts.growth_tracker, ts.hysteresis_tracker,
                                       ts.skipped_steps)


@pytest.mark.parametrize("window", [1, 2, 3, 4])
@pytest.mark.parametrize("consecutive", [False, True])
@pytest.mark.parametrize("hysteresis", [1, 2, 3])
@pytest.mark.parametrize("dynamic", [True, False])
def test_loss_scaler_update_matches_jax(dynamic, hysteresis, consecutive, window):
    """Bit-equal states over 40 overflow flags (each 0.4 likely), from
    make_state: from 2^3 with a floor of 1 and from 2^16 (a dynamic scale
    moves in both; a static scale of 1000 only counts skips)."""
    kw = dict(dynamic=dynamic, loss_scale_window=window, min_loss_scale=1.0,
              hysteresis=hysteresis, consecutive_hysteresis=consecutive)
    scales = set()
    for power, seed in ((3, 0), (16, 1)):
        cfg = _scaler_cfg(dynamic, hysteresis, consecutive, window, power)
        js = j_scaler.make_state(JFP16Config(**cfg))
        ts = t_scaler.make_state(TFP16Config(**cfg))
        _same_state(js, ts)
        for flag in np.random.default_rng(seed).random(40) < 0.4:
            js = j_scaler.update(js, jnp.asarray(flag), **kw)
            ts = t_scaler.update(ts, bool(flag), **kw)
            _same_state(js, ts)
            scales.add(float(ts.scale))
    assert ts.skipped_steps > 0
    assert (len(scales) > 2) is dynamic


def test_dynamic_loss_scaler_shim_matches_jax():
    flags = np.random.default_rng(3).random(30) < 0.3
    js = j_scaler.DynamicLossScaler(init_scale=2**10, scale_window=4,
                                    min_scale=2.0, hysteresis=2)
    ts = t_scaler.DynamicLossScaler(init_scale=2**10, scale_window=4,
                                    min_scale=2.0, hysteresis=2)
    for flag in flags:
        js.update_scale(bool(flag))
        ts.update_scale(bool(flag))
        assert js.cur_scale == ts.cur_scale
        _same_state(js.state, ts.state)


@pytest.mark.parametrize("values,want", [
    ([[1.0, -2.0], [3.0]], False),
    ([[1.0, float("nan")], [3.0]], True),
    ([[1.0], [float("-inf"), 0.0]], True),
    ([[3e38, 3e38, 3e38], [1e30]], False)])   # its fp32 sum of squares is inf
def test_has_overflow_is_any_non_finite_element(values, want):
    from deepspeed_tpu.runtime.utils import has_overflow as j_has_overflow

    assert bool(j_has_overflow([jnp.asarray(v, jnp.float32) for v in values])) is want
    assert bool(has_overflow([torch.tensor(v) for v in values])) is want


# ---------------------------------------------------------------------------
# (b) the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("section,error", [
    ({"fp16": {"enabled": True}}, None),
    ({"fp16": {"enabled": True, "loss_scale": 128, "hysteresis": 3,
               "loss_scale_window": 50, "min_loss_scale": 4}}, None),
    ({"fp16": {"enabled": True}, "data_types": {"grad_accum_dtype": "fp32"}}, None),
    ({"fp16": {"enabled": True}, "bf16": {"enabled": True}}, "both"),
    ({"fp16": {"enabled": True}, "data_types": {"grad_accum_dtype": "bf16"}},
     "fp32 gradient accumulation")])
def test_fp16_config_matches_jax(section, error):
    cfg = {"train_batch_size": 8, **section}
    if error:
        with pytest.raises(ValueError, match=error):
            JConfig(cfg)
        with pytest.raises(ValueError, match=error):
            TConfig(cfg)
        return
    j, t = JConfig(cfg), TConfig(cfg)
    assert j.dtype() == jnp.float16 and t.dtype() == torch.float16
    assert t.master_dtype() == torch.float32 == t.grad_accum_dtype()
    assert (t.fp16_enabled, t.loss_scale, t.dynamic_loss_scale) == (
        j.fp16_enabled, j.loss_scale, j.dynamic_loss_scale)
    assert t.fp16.model_dump() == j.fp16.model_dump()


def test_fp16_engine_keeps_fp32_masters_and_accumulators():
    model = t_causal_lm("llama-tiny", device="cpu", **TINY)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_micro_batch_size_per_gpu": 2,
                             "fp16": {"enabled": True}}, device="cpu")
    assert eng.compute_dtype == torch.float16 and eng.loss_scale == 2.0 ** 16
    assert all(p.dtype == torch.float32 for p in eng.master)
    assert all(a.dtype == torch.float32 for a in eng.grad_acc)
    tok = np.random.default_rng(0).integers(0, TINY["vocab_size"], (2, 16))
    eng.train_step((tok, tok))
    assert all(t.dtype == torch.float16 for t in eng._compute_bufs)
    assert eng.skipped_steps + eng.global_steps == 1


def test_bf16_and_fp32_steps_take_no_overflow_read(monkeypatch):
    """Only fp16 reads an overflow flag on the host: the bf16 and fp32
    steps never build one."""
    def refuse(_):
        raise AssertionError("overflow test outside fp16")
    monkeypatch.setattr(tengine, "has_overflow", refuse)
    tok = np.random.default_rng(0).integers(0, TINY["vocab_size"], (2, 16))
    for bf16 in (False, True):
        model = t_causal_lm("llama-tiny", device="cpu", **TINY)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, config={"train_micro_batch_size_per_gpu": 2,
                                 "bf16": {"enabled": bf16}}, device="cpu")
        eng.train_step((tok, tok))
        assert eng.loss_scale == 1.0 and eng.global_steps == 1


# ---------------------------------------------------------------------------
# (c), (d) the engines
# ---------------------------------------------------------------------------

def _ds_config(fp16, opt_type="FusedAdam"):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": opt_type, "params": {
                "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
            "gradient_clipping": 1.0, "steps_per_print": 10**9, "fp16": fp16}


def _engines(cfg):
    """Both engines from the same JAX-initialised params (one-device mesh;
    the JAX engine makes it the global one, which is put back)."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev_mesh = mesh_mod._GLOBAL_MESH
    try:
        jm = j_causal_lm("llama-tiny", **TINY)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
        jeng, *_ = deepspeed_tpu.initialize(
            model=jm, model_parameters=params, config=cfg,
            mesh=build_mesh(devices=jax.devices()[:1]))
        teng, *_ = deepspeed_tpu_torch.initialize(
            model=tm, model_parameters=jax.tree.map(np.asarray, params),
            config=cfg, device="cpu")
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    return jeng, teng


def _tokens():
    return np.random.default_rng(10).integers(
        0, TINY["vocab_size"], (4, 32)).reshape(2, 2, 32)   # [gas, micro, S]


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _params_match(jeng, teng, lr):
    jflat = dict(_flat(jax.tree.map(np.asarray, jeng.state.params)))
    tflat = dict(_flat(torch_params_to_numpy(teng.params())))
    assert set(jflat) == set(tflat)
    assert all(tflat[path].dtype == np.float32 for path in tflat)
    diff = np.concatenate([np.abs(tflat[p] - jflat[p]).ravel() for p in jflat])
    assert (diff <= 2e-4).mean() >= 0.998 and diff.max() <= 2 * lr


@pytest.mark.parametrize("opt_type", ["FusedAdam", "FusedLamb"])
def test_fp16_static_scale_engine_matches_jax(opt_type):
    """Three steps at a static scale of 128: per-step losses and grad
    norms, then the final fp32 masters (FusedLamb over fp32 masters runs
    under fp16 with no code of its own)."""
    jeng, teng = _engines(_ds_config({"enabled": True, "loss_scale": 128},
                                     opt_type))
    tok = _tokens()
    losses = []
    for _ in range(3):
        jl, tl = float(jeng.train_step((tok, tok))), float(teng.train_step((tok, tok)))
        assert tl == pytest.approx(jl, rel=1e-3)
        assert teng.get_global_grad_norm() == pytest.approx(
            jeng.get_global_grad_norm(), rel=1e-3)
        assert teng.loss_scale == jeng.loss_scale == 128.0
        assert not teng._last_overflow and teng.skipped_steps == 0
        losses.append(tl)
    assert losses[-1] < losses[0]
    assert teng.global_steps == jeng.global_steps == 3
    _params_match(jeng, teng, lr=3e-3)


class _Peak(TorchDispatchMode):
    """The largest finite magnitude of any fp16 tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.peak = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if torch.is_tensor(t) and t.dtype == torch.float16 and t.numel():
                f = t.float()
                f = f[torch.isfinite(f)]
                if f.numel():
                    self.peak = max(self.peak, float(f.abs().max()))
        return out


def _opt_count(opt_state):
    leaves = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "count")) if hasattr(x, "count")]
    assert len(leaves) == 1
    return int(leaves[0].count)


def test_fp16_overflow_skips_match_jax():
    """Dynamic scale from 2^24, hysteresis 1, window 3, one repeated batch:
    the first steps overflow and halve the scale until it fits, then every
    third clean step doubles it and the next step overflows again, now with
    Adam's moments in place.  Per step the overflow flag, the scale, the
    skip count and global_steps equal the JAX engine's; a skipped step
    leaves params, moments and the optimizer count bit-equal; the next
    applied step's learning rate is the JAX optimizer's.

    Why each flag is decisive, not a rounding away from flipping: the
    largest finite |value| of any fp16 tensor the port's step makes is
    measured under a dispatch mode.  A clean step's is at most 0.95 x
    65504.  A skipped step changes nothing and the batch repeats, so its
    backward is the next clean step's times scale_skipped / scale_clean, a
    power of two, exactly; that scaled peak is at least 1.05 x 65520, where
    fp16's round to nearest gives inf.  The largest values are sums without
    cancellation, where the two packages differ by their roundings, about
    1e-3 relative: a 5 % margin cannot be crossed by them.  (Here the clean
    steps reach 0.92 x 65504 once the model has trained a few steps: the
    margin narrows as the gradients grow, which is what the dynamic scale
    answers.)"""
    fp16 = {"enabled": True, "initial_scale_power": 24, "hysteresis": 1,
            "loss_scale_window": 3}
    cfg = _ds_config(fp16)
    jeng, teng = _engines(cfg)
    schedule = jlr.get_lr_schedule("WarmupLR", cfg["scheduler"]["params"])
    tok = _tokens()
    rows = []
    while len(rows) < 16 or rows[-1][1]:     # end on an applied step
        assert len(rows) < 32
        before = ([p.clone() for p in teng.master],
                  [{k: v.clone() for k, v in st.items()}
                   for st in teng.optimizer.state.values()],
                  teng.optimizer.count, teng.global_steps)
        scale = teng.loss_scale
        jeng.train_step((tok, tok))
        with _Peak() as peak:
            teng.train_step((tok, tok))
        skipped = teng._last_overflow
        assert skipped == bool(jeng._last_overflow)
        assert teng.loss_scale == jeng.loss_scale
        assert teng.skipped_steps == jeng.skipped_steps
        assert teng.global_steps == jeng.global_steps
        assert teng.optimizer.count == _opt_count(jeng.state.opt_state)
        if skipped:
            assert all(torch.equal(a, b) for a, b in zip(before[0], teng.master))
            assert len(before[1]) == len(teng.optimizer.state)
            for old, st in zip(before[1], teng.optimizer.state.values()):
                assert all(torch.equal(old[k], st[k]) for k in st)
            assert (teng.optimizer.count, teng.global_steps) == before[2:]
        else:
            assert teng.global_steps == before[3] + 1
        # the learning rate the optimizer applies next: JAX's at its count
        assert teng.optimizer.current_lr(teng.optimizer.param_groups[0]) == \
            pytest.approx(float(schedule(_opt_count(jeng.state.opt_state))),
                          rel=1e-7)
        rows.append((scale, skipped, peak.peak))
    skips = [r[1] for r in rows]
    assert skips[:7] == [True] * 7 and not skips[7]     # 2^24 .. 2^18 overflow
    assert sum(skips[7:]) >= 2                          # regrown, overflowed again
    assert teng.global_steps == len(rows) - sum(skips)
    for i, (scale, skipped, peak) in enumerate(rows):
        if not skipped:
            assert peak <= 0.95 * FP16_MAX, (i, rows)
            continue
        j = next(j for j in range(i + 1, len(rows)) if not rows[j][1])
        assert rows[j][2] * scale / rows[j][0] >= 1.05 * FP16_INF_FROM, (i, rows)


# ---------------------------------------------------------------------------
# (e), (f) the kernels' plain versions in fp16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("g_dtype", [np.float16, np.float32])
def test_fused_adam_update_fp16_params_match_jax(impl, g_dtype):
    n = 1000
    p = _np((n,), 0).astype(np.float16)
    jp, jm, jv = jnp.asarray(p), jnp.zeros(n), jnp.zeros(n)
    tp, tm, tv = torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)
    before = tadam.fused_adam_update_f16_cuda.launches
    for step in (1, 2, 3):
        g = _np((n,), step).astype(g_dtype)
        kw = dict(lr=1e-2 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=0.1, adam_w_mode=True)
        jp, jm, jv = j_adam(jp, jnp.asarray(g), jm, jv, jnp.int32(step),
                            impl=impl, **kw)
        tadam.fused_adam_update(tp, torch.from_numpy(g), tm, tv, step, **kw)
    assert tadam.fused_adam_update_f16_cuda.launches == before   # plain version
    assert jp.dtype == jnp.float16 and tp.dtype == torch.float16
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_allclose(np.asarray(jm), tm.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("B,H,S,D", [(2, 4, 128, 32), (1, 12, 200, 64),
                                     (1, 2, 256, 128)])
def test_flash_attention_fp16_and_grads_match_jax(impl, alibi, B, H, S, D):
    q, k, v, do = (_np((B, H, S, D), i).astype(np.float16) for i in range(4))
    out, vjp = jax.vjp(lambda a, b, c: j_flash(
        a, b, c, causal=True, block_q=64, block_k=64, impl=impl, alibi=alibi),
        q, k, v)
    jgrads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    counts = [fn.launches for fn in tfa.wrappers(torch.float16, alibi)]
    to = tfa.flash_attention(*leaves, alibi=alibi)
    to.backward(torch.from_numpy(do))
    assert [fn.launches for fn in tfa.wrappers(torch.float16, alibi)] == counts
    tol = 1e-3 if impl == "xla" else 4e-3
    for j, t in [(out, to)] + [(g, leaf.grad) for g, leaf in zip(jgrads, leaves)]:
        assert t.dtype == torch.float16 and j.dtype == jnp.float16
        j32, t32 = np.asarray(j, np.float32), t.detach().float().numpy()
        np.testing.assert_allclose(t32, j32, rtol=tol, atol=tol)
        rel = np.linalg.norm(t32 - j32) / max(np.linalg.norm(j32), 1.0)
        assert rel < (1e-4 if impl == "xla" else 1e-3)


@pytest.mark.parametrize("chunk", [0, 16, 24])
def test_fp16_cross_entropy_matches_jax(chunk):
    """The loss in fp16: the head product in fp16, logits cast to fp32
    (dense, or blocks of ``chunk`` rows, the last one padded), the loss and
    the fp16 grads of x and the head against the JAX functions at
    jnp.float16: rtol 1e-3 (the same fp16 products summed in another
    order; 2^-11 relative a rounding)."""
    from deepspeed_tpu.models import transformer as jtr
    from deepspeed_tpu_torch.models import transformer as ttr

    B, S, D, V = 2, 20, 16, 50
    x = _np((B, S, D), 0).astype(np.float16)
    head = _np((D, V), 1, 0.3).astype(np.float16)
    labels = np.random.default_rng(2).integers(-1, V, (B, S))

    def jloss(a, h):
        if chunk:
            return jtr.blockwise_cross_entropy(a, h, labels, chunk=chunk, z_loss=1e-3)
        return jtr.cross_entropy(a @ h, labels, z_loss=1e-3)

    jl, (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    tlab = torch.from_numpy(labels)
    tl = (ttr.blockwise_cross_entropy(tx, th, tlab, chunk, z_loss=1e-3) if chunk
          else ttr.cross_entropy(tx @ th, tlab, z_loss=1e-3))
    tl.backward()
    assert tl.dtype == torch.float32 and tx.grad.dtype == torch.float16
    assert float(tl) == pytest.approx(float(jl), rel=1e-3)
    for j, t in ((jgx, tx.grad), (jgh, th.grad)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   rtol=1e-3, atol=1e-4)
