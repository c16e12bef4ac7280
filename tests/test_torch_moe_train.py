"""The port's MoE training path against the JAX package, on the CPU.

Inputs come from numpy with a seed; weights cross over with
``jax_params_to_torch``.  Everything is fp32.  Tolerances, with their
reasons:

- ``moe_mlp``: output, aux loss and the gradients with respect to x,
  ``gate_w``, ``w_up``, ``w_gate`` and ``w_down`` within rtol/atol 1e-5
  (the same fp32 operations; sums, the scatter-add and its gather in
  another order), for both dispatch forms, with and without dropping,
  GLU and plain, top-1 and top-2;
- ``CausalLM.apply`` with labels (the loss with its aux term): loss 1e-5
  and every parameter's gradient 1e-4, as the dense model's test
  (``tests/test_torch_train.py``: matmuls and reductions in another order
  over two layers and the loss), under remat none, ``full``, ``mlp_only``
  and ``mlp_dots``;
- the engine: 3 FusedAdam steps, per-step loss and grad norm rtol 1e-5,
  final params atol 1e-4, as the dense engine's test;
- Random Token Selection: the gradients with remat equal those without,
  bit for bit (the recompute draws the same permutation from the same
  content-derived seed).  Its permutations are not the JAX package's (a
  ``torch.Generator`` against ``jax.random``), so it is held to JAX by the
  properties of ``tests/test_torch_moe.py``, not by value.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
D, F, E = 64, 96, 4
TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, num_experts=4)


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, dtype=np.float32),
                               t.detach().float().numpy(), rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


# ---------------------------------------------------------------------------
# moe_mlp
# ---------------------------------------------------------------------------

def _moe_cfg(**over):
    base = dict(num_experts=E, num_experts_per_tok=2, moe_capacity_factor=1.25,
                moe_drop_tokens=True, moe_use_rts=False, moe_dispatch="scatter",
                activation="silu", glu=True)
    base.update(over)
    return SimpleNamespace(**base)


def _moe_params(seed, glu=True):
    rng = np.random.default_rng(seed)
    p = {"gate_w": rng.uniform(-D ** -0.5, D ** -0.5, (D, E)) * 8.0,
         "w_up": rng.uniform(-D ** -0.5, D ** -0.5, (E, D, F)),
         "w_down": rng.uniform(-F ** -0.5, F ** -0.5, (E, F, D))}
    if glu:
        p["w_gate"] = rng.uniform(-D ** -0.5, D ** -0.5, (E, D, F))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _moe_grads(cfg, p, x, r, coef):
    """(y, aux, grads) of ``sum(y * r) + coef * aux`` in both packages:
    grads keyed ``x`` and the parameter names."""
    def jobj(jp, jx):
        y, aux = jmoe.moe_mlp(jp, jx, cfg)
        return jnp.sum(y * r) + coef * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jobj, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = tmoe.moe_mlp(tp, tx, cfg)
    ((ty * torch.from_numpy(r)).sum() + coef * taux).backward()
    jg = {"x": jgx, **jgp}
    tg = {"x": tx.grad, **{k: t.grad for k, t in tp.items()}}
    return (jy, jaux, jg), (ty, taux, tg)


MLP_CASES = [(disp, drop, glu, k) for disp in ("scatter", "einsum")
             for drop in (True, False) for glu in (True, False) for k in (1, 2)]


@pytest.mark.parametrize("dispatch,drop,glu,k", MLP_CASES)
def test_moe_mlp_output_aux_and_grads_match_jax(dispatch, drop, glu, k):
    """[2, 24, D] tokens over 4 experts (under dropping, capacity factor
    1.0: C = 12 of 48 at top-1 and 24 at top-2, and tokens are dropped):
    the output, the aux loss and the gradients of ``sum(y * r) + 0.7 *
    aux`` within 1e-5."""
    cfg = _moe_cfg(moe_dispatch=dispatch, moe_drop_tokens=drop, glu=glu,
                   num_experts_per_tok=k, activation="silu" if glu else "gelu",
                   moe_capacity_factor=1.0)
    p = _moe_params(3 + k, glu)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    r = rng.standard_normal((2, 24, D)).astype(np.float32)
    (jy, jaux, jg), (ty, taux, tg) = _moe_grads(cfg, p, x, r, 0.7)
    _close(jy, ty)
    assert abs(float(taux.detach()) - float(jaux)) <= 1e-6
    assert set(tg) == set(jg) == {"x", *p}
    for name in tg:
        assert tg[name] is not None and bool(tg[name].abs().sum() > 0), name
        _close(jg[name], tg[name])
    # the routing dropped tokens exactly when the capacity says so
    N = 48
    C = tmoe.compute_capacity(N, E, k, 1.0) if drop else N
    gates = tmoe.router_gates(torch.from_numpy(x).reshape(N, D),
                              torch.from_numpy(p["gate_w"]))
    _, pos, _, _ = tmoe.topk_assignments(gates, k, C)
    assert (int((pos >= C).sum()) > 0) == drop


@pytest.mark.parametrize("k", [1, 2])
def test_moe_aux_gradient_flows_through_the_mean_gate(k):
    """The aux loss alone: its gradient reaches the router through the mean
    gate (the token fraction comes from a one-hot and carries none), and
    equals JAX's; at k = 1 the task loss alone reaches the router through
    the raw gate, which top-1 keeps unnormalised."""
    cfg = _moe_cfg(num_experts_per_tok=k)
    p = _moe_params(11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 40, D)).astype(np.float32)
    r = rng.standard_normal((1, 40, D)).astype(np.float32)
    (_, _, jg), (_, _, tg) = _moe_grads(cfg, p, x, np.zeros_like(r), 1.0)
    for name in ("x", "gate_w"):
        _close(jg[name], tg[name])
    assert bool(tg["gate_w"].abs().sum() > 0)
    assert all(tg[n] is None or not bool(tg[n].abs().sum() > 0)
               for n in ("w_up", "w_gate", "w_down"))
    # the same aux from the router probabilities alone, its one-hot fixed
    gates = tmoe.router_gates(torch.from_numpy(x).reshape(40, D),
                              torch.from_numpy(p["gate_w"]))
    onehot = torch.nn.functional.one_hot(gates.argmax(-1), E).float()
    _, _, _, aux = tmoe.topk_assignments(gates, k, 40)
    torch.testing.assert_close(aux, E * (gates.mean(0) * onehot.mean(0)).sum())
    (_, _, jg), (_, _, tg) = _moe_grads(cfg, p, x, r, 0.0)
    _close(jg["gate_w"], tg["gate_w"])
    assert bool(tg["gate_w"].abs().sum() > 0)


# ---------------------------------------------------------------------------
# the model: the loss with its aux term
# ---------------------------------------------------------------------------

def _models(**over):
    cfg = dict(TINY, **over)
    jm = j_causal_lm("mixtral-tiny", **cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    # a router 8x wider spreads its logits away from ties
    params["layers"]["mlp"]["gate_w"] = params["layers"]["mlp"]["gate_w"] * 8.0
    tm = t_causal_lm("mixtral-tiny", device="cpu", **cfg)
    np_params = jax.tree.map(np.asarray, params)
    return jm, params, tm, np_params


def _tokens(B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S))


def _torch_loss_and_grads(tm, np_params, *batch):
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    for _, t in _flat(tp):
        t.requires_grad_()
    loss = tm.apply(tp, *(torch.from_numpy(np.asarray(b)) for b in batch))
    loss.backward()
    return loss, {path: t.grad for path, t in _flat(tp)}


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "mlp_only"), (True, "mlp_dots")])
def test_causal_lm_moe_loss_and_grads_match_jax(remat, policy):
    """mixtral-tiny (2 layers, D 64, 4 experts top-2): the loss with its
    aux term and every parameter's gradient against ``jax.grad`` of the
    JAX ``CausalLM.apply`` under the same remat policy."""
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
        assert g is not None, path
        _close(jflat[path], g, 1e-4)
    assert bool(tgrads["layers.mlp.gate_w"].abs().sum() > 0)


def test_moe_loss_adds_the_layers_aux_times_its_coefficient():
    """The loss minus the loss at ``moe_aux_loss_coef`` 0 is the coefficient
    times the sum of the layers' aux losses, as in the JAX package."""
    jm, params, tm, np_params = _models()
    jm0, _, tm0, _ = _models(moe_aux_loss_coef=0.0)
    tok = _tokens(seed=2)
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    base, plain = (float(m.apply(tp, torch.from_numpy(tok), torch.from_numpy(tok)))
                   for m in (tm, tm0))
    jbase, jplain = (float(m.apply(params, tok, tok)) for m in (jm, jm0))
    assert tm.config.moe_aux_loss_coef == 0.01 and base > plain
    assert base - plain == pytest.approx(jbase - jplain, rel=1e-4)
    assert plain == pytest.approx(jplain, rel=TOL)


def test_moe_rts_grads_equal_under_remat():
    """With ``moe_use_rts`` and a capacity that drops tokens, the remat
    policies recompute the MoE MLP with the same permutation (its seed is
    the content's fp32 sum): loss and gradients bit-equal to no remat."""
    _, _, tm, np_params = _models(moe_use_rts=True, moe_capacity_factor=0.5)
    tok = _tokens(seed=3)
    tm.config.remat = False
    loss0, g0 = _torch_loss_and_grads(tm, np_params, tok, tok)
    for policy in ("full", "mlp_only", "mlp_dots"):
        tm.config.remat, tm.config.remat_policy = True, policy
        loss1, g1 = _torch_loss_and_grads(tm, np_params, tok, tok)
        assert torch.equal(loss0, loss1), policy
        for path in g0:
            assert torch.equal(g0[path], g1[path]), (policy, path)
    # RTS decided which tokens were dropped: the same model without it differs
    tm.config.remat, tm.config.moe_use_rts = False, False
    loss2, _ = _torch_loss_and_grads(tm, np_params, tok, tok)
    assert not torch.equal(loss0, loss2)


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
    """Both engines from the same params: three train_steps on one repeated
    [gas, micro, S] batch."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev_mesh = mesh_mod._GLOBAL_MESH
    try:
        jm, params, tm, np_params = _models()
        mesh = build_mesh(devices=jax.devices()[:1])
        jeng, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                            config=DS_CONFIG, mesh=mesh)
        teng, *_ = deepspeed_tpu_torch.initialize(
            model=tm, model_parameters=np_params, config=DS_CONFIG, device="cpu")
        rec = {"j": [], "t": []}
        tok = _tokens(B=4, S=32, seed=10).reshape(2, 2, 32)
        for _ in range(3):
            for key, eng in (("j", jeng), ("t", teng)):
                loss = eng.train_step((tok, tok))
                rec[key].append((float(loss), eng.get_global_grad_norm(),
                                 eng.get_lr()[0]))
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    return jeng, teng, rec


def test_moe_engine_matches_jax_engine_per_step(engines_trained):
    _, teng, rec = engines_trained
    assert len(rec["t"]) == 3 and teng.global_steps == 3
    for (jl, jn, jlr), (tl, tn, tlr_) in zip(rec["j"], rec["t"]):
        assert tl == pytest.approx(jl, rel=TOL)
        assert tn == pytest.approx(jn, rel=TOL)
        assert tlr_ == pytest.approx(jlr, rel=1e-7)
    assert rec["t"][2][0] < rec["t"][0][0]            # it learns
    assert teng.optimizer.count == 3


def test_moe_engine_final_params_match_jax(engines_trained):
    """Every leaf after 3 steps, the [L, E, D, F] experts and the router
    among them, within atol 1e-4 of the JAX engine's."""
    jeng, teng, _ = engines_trained
    jflat = dict(_flat(jax.tree.map(np.asarray, jeng.state.params)))
    tflat = dict(_flat(torch_params_to_numpy(teng.params())))
    assert set(jflat) == set(tflat)
    assert tflat["layers.mlp.w_up"].shape == (2, 4, 64, 128)
    for path in jflat:
        np.testing.assert_allclose(tflat[path], jflat[path], atol=1e-4, rtol=0,
                                   err_msg=path)
