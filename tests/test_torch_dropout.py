"""Dropout in the port against the JAX package, on the CPU: the threefry
key chain, the plain dropout, and training through ``initialize``.

Inputs come from numpy with a seed; weights cross over with
``jax_params_to_torch``.  These tests hold the port to jax 0.9.0's default
PRNG, ``threefry2x32`` with ``jax_threefry_partitionable`` on: the
autouse fixture below asserts that default, so a jax whose default draws
other bits fails here loudly instead of drifting.  Tolerances, with their
reasons:

- ``utils/prng.py`` against ``jax.random`` (keys, bits, bernoulli masks,
  permutations): bit for bit;
- the plain dropout, forward and ``jax.grad``, against ``jax.jit(
  _dropout)``: bit for bit, in fp32, bf16 and fp16;
- engines, llama-tiny with 2 layers over 3 steps with dropout 0.1 (fp32):
  losses and grad norms rtol 1e-5, weights atol 1e-4
  (``tests/test_torch_train.py``: the same fp32 model summed in another
  order; the masks are equal, so dropout adds no difference);
- MoE Random Token Selection from a key: the same permutation, so the same
  tokens kept, and outputs within 1e-5 (``tests/test_torch_moe.py``).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.models.transformer import _dropout as j_dropout
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jac
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from deepspeed_tpu_torch.ops.kernels.dropout import dropout, dropout_bwd
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as tac
from deepspeed_tpu_torch.utils import prng
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
MODELS = {"llama": ("llama-tiny", {}),
          "parallel": ("llama-tiny", {"parallel_residual": True}),
          "mixtral_rts": ("mixtral-tiny", {"num_experts": 4, "moe_use_rts": True,
                                           "moe_capacity_factor": 0.5})}
DENSE = ["llama", "parallel"]      # mixtral_rts: tests/test_torch_dropout_moe.py
POLICIES = [None, "full", "dots", "mlp_only", "mlp_dots", "offload_dots"]
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "FusedAdam", "params": {
              "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
          "scheduler": {"type": "WarmupLR", "params": {
              "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
          "gradient_clipping": 1.0, "steps_per_print": 10**9}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


@pytest.fixture(autouse=True)
def partitionable_threefry():
    """jax 0.9.0's default, which the port's key chain follows."""
    assert jax.config.jax_threefry_partitionable, (
        "jax's default PRNG bits changed: deepspeed_tpu_torch/utils/prng.py "
        "follows jax_threefry_partitionable=True")
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _key_tuple(jkey):
    return tuple(int(v) for v in np.asarray(jkey).tolist())


# ---------------------------------------------------------------------------
# the key chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_prng_matches_jax_random_bit_for_bit(seed):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    assert key == _key_tuple(jkey)
    for n in (1, 2, 3, 24):
        assert prng.split(key, n) == [_key_tuple(k) for k in jax.random.split(jkey, n)]
    for d in (0, 1, 17, 2**32 - 1):
        assert prng.fold_in(key, d) == _key_tuple(jax.random.fold_in(jkey, d))
    for shape in ((7,), (3, 5), (2, 3, 5), (2, 3, 5, 7), (1, 129, 3)):
        np.testing.assert_array_equal(
            prng.random_bits(key, shape).numpy(),
            np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
        for p in (0.9, 0.5, 0.3):
            np.testing.assert_array_equal(
                prng.bernoulli(key, p, shape).numpy(),
                np.asarray(jax.random.bernoulli(jkey, p, shape)))
    for n in (1, 2, 10, 1000) + ((70001,) if seed == 42 else ()):
        # 70001 takes two sort rounds
        np.testing.assert_array_equal(prng.permutation(key, n).numpy(),
                                      np.asarray(jax.random.permutation(jkey, n)))


def test_permutation_sorts_stably_as_lax_sort_key_val():
    """JAX's shuffle sorts by 32-bit keys with ``lax.sort_key_val``, which
    is stable by default; ties are rare at n << 2^16, so force them: one
    round over a tiny key space, both sides stable."""
    import inspect

    assert inspect.signature(jax.lax.sort_key_val).parameters["is_stable"].default
    keys = np.array([3, 1, 3, 1, 2, 3, 1], np.uint32)
    _, jv = jax.lax.sort_key_val(jnp.asarray(keys), jnp.arange(7))
    order = torch.argsort(torch.from_numpy(keys.astype(np.int64)), stable=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the plain dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_dropout_and_its_grad_equal_jax_bit_for_bit(dtype, rate):
    jdt, tdt = DTYPES[dtype]
    fwd = jax.jit(j_dropout, static_argnums=2)
    grad = jax.jit(jax.grad(lambda x, k, g: (j_dropout(x, k, rate) * g)
                            .astype(jnp.float32).sum()))
    for i, shape in enumerate(((64, 513), (3, 5, 7, 9))):
        x32, g32 = _np(shape, 10 + i, 3.0), _np(shape, 20 + i)
        key = prng.prng_key(100 + i)
        jx = jnp.asarray(x32).astype(jdt)
        tx = torch.from_numpy(x32).to(tdt).requires_grad_()
        ty = dropout(tx, key, rate)
        np.testing.assert_array_equal(
            ty.detach().float().numpy(),
            np.asarray(fwd(jx, jax.random.PRNGKey(100 + i), rate)
                       .astype(jnp.float32)))
        jg = grad(jx, jax.random.PRNGKey(100 + i), jnp.asarray(g32).astype(jdt))
        (tg,) = torch.autograd.grad(ty, tx, torch.from_numpy(g32).to(tdt))
        np.testing.assert_array_equal(tg.float().numpy(),
                                      np.asarray(jg.astype(jnp.float32)))
        np.testing.assert_array_equal(
            dropout_bwd(torch.from_numpy(g32).to(tdt), key, rate).float().numpy(),
            tg.float().numpy())


def test_plain_dropout_reads_the_logical_index_and_takes_empty_tensors():
    x = torch.from_numpy(_np((6, 10), 3))
    key = prng.prng_key(1)
    view = x.t()                                   # non-contiguous
    np.testing.assert_array_equal(dropout(view, key, 0.5).numpy(),
                                  dropout(view.contiguous(), key, 0.5).numpy())
    assert dropout(torch.zeros(0, 4), key, 0.1).shape == (0, 4)


# ---------------------------------------------------------------------------
# training and evaluation through initialize
# ---------------------------------------------------------------------------

def _pair(model, over, policy, cfg=CONFIG, model_parameters=True):
    """The JAX engine (one-device mesh) and the port's for one model; the
    caller restores the global mesh."""
    preset, extra = MODELS[model]
    spec = dict(TINY, dropout=0.1, **extra, **over)
    spec.update(remat=policy is not None, remat_policy=policy or "full")
    jm = j_causal_lm(preset, **spec)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    np_params = jax.tree.map(np.asarray, params)
    tm = t_causal_lm(preset, device="cpu", **spec)
    mesh = build_mesh(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, model_parameters=params if model_parameters else None,
        config=cfg, mesh=mesh)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=np_params if model_parameters else None,
        config=cfg, device="cpu")
    return jeng, teng, np_params


@pytest.fixture
def restore_mesh():
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev = mesh_mod._GLOBAL_MESH
    yield
    mesh_mod._GLOBAL_MESH = prev


def _tok(seed=10):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (4, 32))


def _weights(jeng, teng):
    jflat = {k: np.asarray(v) for k, v in
             _flat(jax.tree.map(np.asarray, jeng.state.params))}
    tflat = dict(_flat(torch_params_to_numpy(teng.params())))
    assert set(jflat) == set(tflat)
    return jflat, tflat


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p or "none")
@pytest.mark.parametrize("model", DENSE)
def test_dropout_training_follows_the_jax_engine(model, policy, restore_mesh):
    """Three train_steps from the same seed under each remat policy: the
    same masks (and, for mixtral, the same RTS permutations) on both sides,
    so losses, grad norms and weights agree; dropout did act (the first
    loss is not the model's loss without a key)."""
    jeng, teng, np_params = _pair(model, {}, policy)
    tok = _tok().reshape(2, 2, 32)
    runs = {"j": [], "t": []}
    for _ in range(3):
        for key, eng in (("j", jeng), ("t", teng)):
            loss = float(eng.train_step((tok, tok)))
            runs[key].append((loss, eng.get_global_grad_norm()))
    np.testing.assert_allclose(np.array(runs["t"]), np.array(runs["j"]), rtol=1e-5)
    jflat, tflat = _weights(jeng, teng)
    for path in jflat:
        np.testing.assert_allclose(tflat[path], jflat[path], atol=1e-4, rtol=0,
                                   err_msg=path)
    assert teng._rng == _key_tuple(jeng._rng)
    tm = teng.module
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    plain = float(tm.apply(tp, torch.from_numpy(tok[0]), torch.from_numpy(tok[0])))
    assert plain != pytest.approx(runs["t"][0][0], rel=1e-4)


def test_eval_draws_dropout_as_the_jax_engine_does(restore_mesh):
    """The JAX engine's eval passes the step's key to the model, so eval
    drops too and every call draws a new key; the port follows."""
    jeng, teng, _ = _pair("llama", {}, None)
    tok = _tok(5)
    out = {}
    for key, eng in (("j", jeng), ("t", teng)):
        eng.eval()
        out[key] = [float(eng((tok[:2], tok[:2]))) for _ in range(2)]
        eng.train()
    np.testing.assert_allclose(out["t"], out["j"], rtol=1e-5)
    assert out["t"][0] != out["t"][1]
    assert teng._rng == _key_tuple(jeng._rng)


@pytest.mark.parametrize("with_params", [True, False])
def test_engine_key_chain_follows_the_jax_engine(with_params, restore_mesh):
    """PRNGKey(seed), split for each train_step, forward and eval; an
    engine built without model_parameters takes one split more (the JAX
    engine's lazy init from the first batch)."""
    cfg = dict(CONFIG, seed=1234)
    jeng, teng, _ = _pair("llama", {}, None, cfg=cfg,
                          model_parameters=with_params)
    tok = _tok(6)
    for eng in (jeng, teng):
        eng.train_step((tok, tok))
        eng((tok[:2], tok[:2]))
        eng.step()
        eng.eval()
        eng((tok[:2], tok[:2]))
    assert teng._rng == _key_tuple(jeng._rng)


def test_resume_with_dropout_follows_the_jax_engine_resume(tmp_path, restore_mesh):
    """Neither engine saves its key: a resumed run starts the chain again
    from the seed, so it is not the uninterrupted run in either package.
    The port's resume equals the JAX engine's resume."""
    jeng, teng, _ = _pair("llama", {}, None)
    tok = _tok(8).reshape(2, 2, 32)
    for eng in (jeng, teng):
        for _ in range(2):
            eng.train_step((tok, tok))
    jeng.save_checkpoint(str(tmp_path / "j"))
    teng.save_checkpoint(str(tmp_path / "t"))
    straight = float(teng.train_step((tok, tok)))
    jres, tres, _ = _pair("llama", {}, None)
    jres.load_checkpoint(str(tmp_path / "j"))
    tres.load_checkpoint(str(tmp_path / "t"))
    losses = [float(e.train_step((tok, tok))) for e in (jres, tres)]
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    assert losses[1] != pytest.approx(straight, rel=1e-6)
    assert tres._rng == _key_tuple(jres._rng)


@pytest.mark.parametrize("policy,warned", [("mlp_dots", True), ("full", False),
                                           ("offload_dots", False)])
def test_cpu_checkpointing_maps_to_offload_dots_as_the_jax_engine(
        policy, warned, caplog, restore_mesh):
    cfg = dict(CONFIG, activation_checkpointing={"cpu_checkpointing": True,
                                                 "policy": policy})
    with caplog.at_level(logging.WARNING):
        jeng, teng, _ = _pair("llama", {}, None, cfg=cfg)
    for eng in (jeng, teng):
        assert eng.module.config.remat and (
            eng.module.config.remat_policy == "offload_dots")
    port_msgs = [r.getMessage() for r in caplog.records
                 if r.name.startswith("deepspeed_tpu_torch")]
    assert any("cpu_checkpointing overrides" in m for m in port_msgs) == warned
    tok = _tok(9).reshape(2, 2, 32)
    with caplog.at_level(logging.WARNING):
        losses = [float(e.train_step((tok, tok))) for e in (jeng, teng)]
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    assert any("without the host memory-space move" in r.getMessage()
               for r in caplog.records if r.name.startswith("deepspeed_tpu_torch"))


def test_serving_and_logits_draw_nothing_without_a_key():
    """``apply`` with no key drops nothing, as the JAX ``apply``: the
    logits equal the JAX model's."""
    spec = dict(TINY, dropout=0.5)
    jm = j_causal_lm("llama-tiny", **spec)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = t_causal_lm("llama-tiny", device="cpu", **spec)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    tok = _tok(3)
    np.testing.assert_allclose(tm.apply(tp, torch.from_numpy(tok)).numpy(),
                               np.asarray(jm.apply(params, tok)), rtol=1e-4,
                               atol=1e-4)
    key = prng.prng_key(4)
    dropped = tm.apply(tp, torch.from_numpy(tok), rngs={"dropout": key})
    np.testing.assert_allclose(
        dropped.numpy(), np.asarray(jm.apply(params, tok, rngs={
            "dropout": jax.random.PRNGKey(4)})), rtol=1e-4, atol=1e-4)


def test_activation_checkpointing_api_replays_dropout_and_tracks_keys():
    """``checkpoint`` recomputes with the same keys (the masks repeat, so
    the grads equal the plain run's); the tracker forks the JAX tracker's
    keys; ``configure`` records the section."""
    x = torch.from_numpy(_np((4, 9), 2)).requires_grad_()
    w = torch.from_numpy(_np((9, 9), 3)).requires_grad_()
    key = prng.prng_key(11)

    def fn(a, b):
        return dropout(a @ b, key, 0.3).tanh().sum()
    g0 = torch.autograd.grad(fn(x, w), (x, w))
    g1 = torch.autograd.grad(tac.checkpoint(fn, x, w), (x, w))
    g2 = torch.autograd.grad(tac.checkpoint_wrapper(fn)(x, w), (x, w))
    for a, b, c in zip(g0, g1, g2):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(TypeError):
        tac.checkpoint(fn, x, w, policy="dots")
    tac.model_parallel_cuda_manual_seed(5)
    jac.model_parallel_cuda_manual_seed(5)
    for _ in range(2):
        with tac.get_cuda_rng_tracker().fork() as tk, \
                jac.get_cuda_rng_tracker().fork() as jk:
            assert tk == _key_tuple(jk)
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    tac.configure(deepspeed_config=DeepSpeedConfig(
        {"train_batch_size": 1,
         "activation_checkpointing": {"cpu_checkpointing": True}}))
    assert tac._CONFIG["cpu_checkpointing"] and tac.is_configured()
