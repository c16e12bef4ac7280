"""The port's training path against the JAX package, on the CPU.

Inputs come from numpy with a seed; weights cross over with
``jax_params_to_torch``.  A CPU tensor runs each kernel wrapper's plain
version; the JAX side runs its jnp reference (``impl="xla"``) and, for the
kernels, its Pallas kernel in interpret mode (``impl="interpret"``, small
blocks).  Everything is fp32.  Tolerances, with their reasons:

- kernels' vjps and Adam: 1e-5 (the same formulas; sums in another order);
- model loss 1e-5 and grads 1e-4 (fp32 matmuls and reductions in another
  order, accumulated over two layers and the loss);
- engine: loss and grad norm rtol 1e-5, lr 1e-7 (the same fp32 schedule),
  params atol 1e-4 after three Adam steps: Adam divides each moment by
  sqrt(v) + 1e-8, so a grad element near 1e-8 turns a 1e-7 relative grad
  difference into a visible step difference of at most a few lr * 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops.pallas import apply_rotary_pos_emb as j_rope
from deepspeed_tpu.ops.pallas import rms_norm as j_rms_norm
from deepspeed_tpu.ops.pallas import rope_angles as j_rope_angles
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from deepspeed_tpu.ops.pallas.flash_attention import mha_reference as j_mha
from deepspeed_tpu.ops.pallas.fused_adam import fused_adam_update as j_adam
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfa
from deepspeed_tpu_torch.ops.kernels import fused_adam as tadam
from deepspeed_tpu_torch.ops.kernels import layer_norm as tln
from deepspeed_tpu_torch.ops.kernels import rope as trope
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, dtype=np.float32),
                               t.detach().float().numpy(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 96)])
def test_rms_norm_vjp_matches_jax(impl, shape):
    x, dy = _np(shape, 0, 3.0), _np(shape, 1)
    g = 1 + 0.1 * _np(shape[-1:], 2)
    y, vjp = jax.vjp(lambda a, b: j_rms_norm(a, b, 1e-5, impl), x, g)
    jdx, jdg = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    before = tln.rms_norm_bwd.launches
    ty = tln.rms_norm(tx, tg, eps=1e-5)
    ty.backward(torch.from_numpy(dy))
    assert tln.rms_norm_bwd.launches == before     # plain version on the CPU
    _close(y, ty)
    _close(jdx, tx.grad)
    _close(jdg, tg.grad)
    dx, dgam = tln.rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(dy), eps=1e-5)
    _close(jdx, dx)
    _close(jdg, dgam)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_rope_vjp_matches_jax(impl):
    x, dy = _np((2, 4, 16, 32), 0), _np((2, 4, 16, 32), 1)
    cos, sin = j_rope_angles(jnp.arange(16), 32, theta=10000.0)
    _, vjp = jax.vjp(lambda a: j_rope(a, cos, sin, impl), x)
    (jdx,) = vjp(jnp.asarray(dy))
    tc, ts = trope.rope_angles(torch.arange(16), 32, theta=10000.0)
    tx = torch.from_numpy(x).requires_grad_()
    trope.apply_rotary_pos_emb(tx, tc, ts).backward(torch.from_numpy(dy))
    _close(jdx, tx.grad)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("B,H,S,D", [(2, 2, 128, 64), (1, 3, 64, 32),
                                     (1, 2, 256, 128)])
def test_flash_attention_and_grads_match_jax(impl, B, H, S, D):
    q, k, v, do = (_np((B, H, S, D), i) for i in range(4))
    block = 128 if S >= 256 else 64     # 128-row blocks where S holds two
    out, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, causal=True, block_q=block,
                                               block_k=block, impl=impl), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = tfa.flash_attention.launches
    to = tfa.flash_attention(*leaves)
    to.backward(torch.from_numpy(do))
    assert tfa.flash_attention.launches == before
    _close(out, to)
    for jg, leaf in zip(jgrads, leaves):
        _close(jg, leaf.grad)


def test_plain_attention_follows_mha_reference_when_s_differs_from_sk():
    """The S != Sk hazard (ROADMAP.md queue 3): ``mha_reference`` offsets
    the causal mask by Sk - S, the Pallas kernel masks rows >= cols.  The
    port's plain version follows ``mha_reference``; its kernel refuses
    S != Sk."""
    q, k, v = _np((1, 2, 32, 64), 0), _np((1, 2, 64, 64), 1), _np((1, 2, 64, 64), 2)
    want = j_mha(q, k, v, causal=True)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(want, got)
    pallas = j_flash(q, k, v, causal=True, block_q=32, block_k=32, impl="interpret")
    assert not np.allclose(np.asarray(pallas), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_update_matches_jax_over_three_steps(impl, adam_w_mode):
    n = 1000                           # not a multiple of the 128-lane tile
    p = _np((n,), 0)
    jp, jm, jv = jnp.asarray(p), jnp.zeros(n), jnp.zeros(n)
    tp, tm, tv = torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)
    for step in (1, 2, 3):
        g = _np((n,), step)
        kw = dict(lr=1e-2 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=0.1, adam_w_mode=adam_w_mode)
        jp, jm, jv = j_adam(jp, jnp.asarray(g), jm, jv, jnp.int32(step),
                            impl=impl, **kw)
        tadam.fused_adam_update(tp, torch.from_numpy(g), tm, tv, step, **kw)
    for j, t in ((jp, tp), (jm, tm), (jv, tv)):
        _close(j, t)


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_max_lr": 3e-4, "warmup_num_steps": 5}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 7, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_max_lr": 1e-3,
                       "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 4,
                        "warmup_max_lr": 2e-3, "warmup_min_ratio": 0.1}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 4, "decay_step_size": 3,
                  "decay_lr_rate": 0.1}),
    ("LRRangeTest", {"lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True})])
def test_lr_schedules_match_jax(name, params):
    js, ts = jlr.get_lr_schedule(name, params), tlr.get_lr_schedule(name, params)
    for step in range(25):
        assert float(ts(step)) == pytest.approx(float(js(step)), rel=1e-6, abs=1e-12)
    shim = tlr.LRSchedulerShim(ts)
    shim.step()
    assert shim.get_last_lr() == [float(ts(1))]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _models(**over):
    cfg = dict(TINY, **over)
    jm = j_causal_lm("llama-tiny", **cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = t_causal_lm("llama-tiny", device="cpu", **cfg)
    np_params = jax.tree.map(np.asarray, params)
    return jm, params, tm, np_params


def _tokens(B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _torch_loss_and_grads(tm, np_params, *batch):
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    for _, t in _flat(tp):
        t.requires_grad_()
    loss = tm.apply(tp, *(torch.from_numpy(np.asarray(b)) for b in batch))
    loss.backward()
    return loss, {path: t.grad for path, t in _flat(tp)}


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "mlp_dots")])
def test_causal_lm_loss_and_grads_match_jax(remat, policy):
    jm, params, tm, np_params = _models(remat=remat, remat_policy=policy)
    tok = _tokens()
    mask = (np.random.default_rng(1).random(tok.shape) > 0.2).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.apply(p, tok, tok, loss_mask=mask))(params)
    tloss, tgrads = _torch_loss_and_grads(tm, np_params, tok, tok, mask)
    _close(jloss, tloss)
    jflat = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert set(jflat) == set(tgrads)
    for path, g in tgrads.items():
        _close(jflat[path], g, 1e-4)
    logits_j = jm.apply(params, tok)
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    _close(logits_j, tm.apply(tp, torch.from_numpy(tok)), 1e-4)


@pytest.mark.parametrize("policy", ["mlp_only", "mlp_dots", "full", "dots"])
def test_remat_policies_give_the_same_grads(policy):
    _, _, tm, np_params = _models()
    tok = _tokens(seed=3)
    tm.config.remat = False
    loss0, g0 = _torch_loss_and_grads(tm, np_params, tok, tok)
    tm.config.remat, tm.config.remat_policy = True, policy
    loss1, g1 = _torch_loss_and_grads(tm, np_params, tok, tok)
    assert torch.equal(loss0, loss1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


@pytest.mark.parametrize("over", [{"mlp_bias": True},
                                  {"mlp_bias": True, "glu": False,
                                   "activation": "gelu"}])
def test_mlp_dots_gives_the_same_grads_with_biases_and_without_a_gate(over):
    _, _, tm, np_params = _models(**over)
    tok = _tokens(seed=5)
    tm.config.remat = False
    loss0, g0 = _torch_loss_and_grads(tm, np_params, tok, tok)
    tm.config.remat, tm.config.remat_policy = True, "mlp_dots"
    loss1, g1 = _torch_loss_and_grads(tm, np_params, tok, tok)
    assert torch.equal(loss0, loss1)
    assert any("b_up" in path for path in g0)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _backward_matmuls(tm, np_params, tok):
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    for _, t in _flat(tp):
        t.requires_grad_()
    loss = tm.apply(tp, torch.from_numpy(tok), torch.from_numpy(tok))
    with _CountMatmuls() as count:
        loss.backward()
    return count.n


@pytest.mark.parametrize("policy,recomputed", [("mlp_only", 2), ("mlp_dots", 0)])
def test_mlp_remat_reruns_the_matmuls_only_under_mlp_only(policy, recomputed):
    """``mlp_dots`` keeps the MLP's matmul outputs (JAX
    ``dots_with_no_batch_dims_saveable``) and its backward runs no more
    matmuls than no remat; ``mlp_only`` reruns the up and gate projections
    of each layer (the non-reentrant checkpoint stops once the saved tensors
    are rebuilt, and the down projection's output is not one of them)."""
    _, _, tm, np_params = _models()
    tok = _tokens(seed=4)
    tm.config.remat = False
    base = _backward_matmuls(tm, np_params, tok)
    tm.config.remat, tm.config.remat_policy = True, policy
    got = _backward_matmuls(tm, np_params, tok)
    assert got - base == recomputed * TINY["num_layers"]


@pytest.mark.parametrize("chunk,masked", [(16, False), (24, True), (64, False)])
def test_blockwise_cross_entropy_matches_dense_and_jax(chunk, masked):
    """Chunks that divide the tokens, leave a padded last chunk, and exceed
    them; loss and both grads against dense CE, loss against the JAX
    blockwise CE."""
    B, S, D, V = 2, 20, 16, 50
    x, head = _np((B, S, D), 0), _np((D, V), 1, 0.3)
    labels = np.random.default_rng(2).integers(-1, V, (B, S))
    mask = ((np.random.default_rng(3).random((B, S)) > 0.3).astype(np.int32)
            if masked else None)
    tm = None if mask is None else torch.from_numpy(mask)
    tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    got = ttr.blockwise_cross_entropy(tx, th, torch.from_numpy(labels), chunk,
                                      z_loss=1e-3, mask=tm)
    got.backward()
    gx, gh = tx.grad, th.grad
    tx.grad = th.grad = None
    want = ttr.cross_entropy(tx @ th, torch.from_numpy(labels), z_loss=1e-3, mask=tm)
    want.backward()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(gx, tx.grad, rtol=TOL, atol=TOL)
    torch.testing.assert_close(gh, th.grad, rtol=TOL, atol=TOL)
    jwant = jtr.blockwise_cross_entropy(x, head, labels, chunk=chunk, z_loss=1e-3,
                                        mask=mask)
    _close(jwant, got)


def test_loss_tail_chunks_past_2_pow_28_logits():
    """The auto rule: B*S*V > 2^28 takes the blockwise path (llama-1b4 at
    micro 4 x 2048 x 50304 does)."""
    _, _, tm, _ = _models()
    calls = []
    orig = ttr.blockwise_cross_entropy
    try:
        ttr.blockwise_cross_entropy = lambda *a, **k: calls.append(k["chunk"]) or orig(*a, **k)
        h = torch.zeros(1, 4, TINY["hidden_size"])
        labels = torch.zeros(1, 4, dtype=torch.long)
        fn = {"scale": torch.ones(TINY["hidden_size"])}
        head = torch.zeros(TINY["hidden_size"], TINY["vocab_size"])
        tm._loss_tail(fn, head, h, labels, None)
        assert calls == []
        tm.config.vocab_size = (1 << 28) // 4 + 1       # only the rule reads it
        tm._loss_tail(fn, head, h, labels, None)
        assert calls == [2048]
    finally:
        ttr.blockwise_cross_entropy = orig


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

DS_CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
             "optimizer": {"type": "FusedAdam", "params": {
                 "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
             "scheduler": {"type": "WarmupLR", "params": {
                 "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
             "gradient_clipping": 1.0, "steps_per_print": 10**9}


@pytest.fixture(scope="module")
def engines_trained():
    """Both engines from the same params: three train_steps (stacked
    [gas, micro, S] batches), then one step through the forward /
    backward / step trio."""
    # the JAX engine makes its one-device mesh the process-global one; a
    # module-scoped fixture runs before the per-test guard that restores the
    # global mesh, so this fixture puts the previous one back itself (or
    # later files in the same worker build their engines on one device)
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev_mesh = mesh_mod._GLOBAL_MESH
    try:
        jm, params, tm, np_params = _models()
        mesh = build_mesh(devices=jax.devices()[:1])
        jeng, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                            config=DS_CONFIG, mesh=mesh)
        teng, topt, _, tsched = deepspeed_tpu_torch.initialize(
            model=tm, model_parameters=np_params, config=DS_CONFIG, device="cpu")
        assert topt is teng.optimizer and tsched is teng.lr_scheduler
        rec = {"j": [], "t": []}
        tok = _tokens(B=4, S=32, seed=10).reshape(2, 2, 32)      # one repeated batch
        for step in range(3):
            for key, eng in (("j", jeng), ("t", teng)):
                loss = eng.train_step((tok, tok))
                rec[key].append((float(loss), eng.get_global_grad_norm(),
                                 eng.get_lr()[0]))
        tok = _tokens(B=4, S=32, seed=20)
        for key, eng in (("j", jeng), ("t", teng)):
            for i in range(2):
                micro = tok[2 * i:2 * i + 2]
                loss = eng(( micro, micro))
                assert eng.backward(loss) is loss
                assert eng.is_gradient_accumulation_boundary() == (i == 1)
                eng.step()
            rec[key].append((float(loss), eng.get_global_grad_norm(), eng.get_lr()[0]))
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    return jeng, teng, rec


def test_engine_matches_jax_engine_per_step(engines_trained):
    _, teng, rec = engines_trained
    assert len(rec["t"]) == 4 and teng.global_steps == 4
    for (jl, jn, jlr), (tl, tn, tlr_) in zip(rec["j"], rec["t"]):
        assert tl == pytest.approx(jl, rel=TOL)
        assert tn == pytest.approx(jn, rel=TOL)
        assert tlr_ == pytest.approx(jlr, rel=1e-7)
    assert rec["t"][2][0] < rec["t"][0][0]            # it learns
    assert teng.optimizer.count == 4


def test_engine_final_params_match_jax(engines_trained):
    jeng, teng, _ = engines_trained
    jflat = dict(_flat(jax.tree.map(np.asarray, jeng.state.params)))
    tflat = dict(_flat(torch_params_to_numpy(teng.params())))
    assert set(jflat) == set(tflat)
    for path in jflat:
        np.testing.assert_allclose(tflat[path], jflat[path], atol=1e-4, rtol=0,
                                   err_msg=path)


def test_engine_eval_mode_and_bf16_compute():
    """evaluate() leaves the weights alone; bf16 compute keeps fp32 masters
    and an fp32 accumulator, and its loss is near the fp32 loss (bf16
    rounding of weights and activations: 2e-2)."""
    _, _, tm, np_params = _models()
    tok = _tokens(B=4, S=32, seed=5)
    losses = {}
    for bf16 in (False, True):
        cfg = dict(DS_CONFIG, bf16={"enabled": bf16})
        tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
        eng, *_ = deepspeed_tpu_torch.initialize(model=tm, model_parameters=np_params,
                                                 config=cfg, device="cpu")
        before = [p.clone() for p in eng.master]
        eng.eval()
        losses[bf16] = float(eng((tok[:2], tok[:2])))
        assert all(torch.equal(a, b) for a, b in zip(before, eng.master))
        eng.train()
        eng.train_step((tok, tok))
        assert all(p.dtype == torch.float32 for p in eng.master)
        assert all(a.dtype == torch.float32 for a in eng.grad_acc)
        assert all(float(a.abs().max()) == 0.0 for a in eng.grad_acc)
    assert losses[True] == pytest.approx(losses[False], rel=2e-2)


def test_config_sections_and_defaults():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = DeepSpeedConfig({"train_batch_size": 8, "gradient_accumulation_steps": 2,
                           "data_types": {"grad_accum_dtype": "bf16"},
                           "tensorboard": {"enabled": False}})
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps) == (8, 4, 2)
    assert cfg.grad_accum_dtype() == torch.bfloat16 and cfg.optimizer is None
    with pytest.raises(ValueError, match="Inconsistent"):
        DeepSpeedConfig({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
                         "gradient_accumulation_steps": 2})
    _, _, tm, _ = _models()
    eng, opt, _, sched = deepspeed_tpu_torch.initialize(model=tm, config={},
                                                        device="cpu")
    assert sched is None and eng.get_lr() == [0.0]
    assert opt.fused is False and opt.param_groups[0]["lr"] == 1e-3   # AdamW
