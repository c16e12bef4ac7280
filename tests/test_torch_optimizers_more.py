"""The port's Lion, Adagrad, SGD and Muon, a client optimizer and
``FusedAdam(bias_correction=False)`` against the JAX package, on the CPU.

Params, grads and batches come from numpy with a seed; weights cross over
with ``jax_params_to_torch``.  The JAX side is ``build_optimizer`` (optax's
``lion``, ``adagrad``, ``sgd`` and the package's own ``muon``) and the JAX
engine on a one-device mesh.  Tolerances, with their reasons:

- one optimizer, three steps under WarmupLR on the same params and grads:
  Lion, Adagrad and SGD rtol 1e-6 (the same fp32 formulas; XLA may fuse a
  product and a sum into one FMA, and ``rsqrt`` may differ by an ulp);
  Muon 1e-5 relative to the largest weight of a leaf (five Newton-Schulz
  products, each summed in another order than XLA's, move the
  orthogonalized update by a few ulp of its largest entry);
- engines, llama-tiny with 2 layers over 3 steps (fp32): losses and grad
  norms rtol 1e-5 and weights atol 1e-5 (``tests/test_torch_train.py``:
  the same fp32 model summed in another order); Lion's update is the sign
  of a sum, so an element whose sum is within rounding of zero may flip,
  and its weights are held at atol 2 lr (one flipped sign) on at most
  0.1 % of the elements and 1e-5 on the rest;
- checkpoints: loaded state bit-equal to the tag's bytes, and the two
  steps after a load within the engine tolerance above.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.optimizer import build_optimizer as j_build
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from deepspeed_tpu_torch.ops.adagrad import Adagrad
from deepspeed_tpu_torch.ops.adam import FusedAdam, Muon
from deepspeed_tpu_torch.ops.adam.muon import newton_schulz
from deepspeed_tpu_torch.ops.lion import Lion
from deepspeed_tpu_torch.ops.sgd import SGD
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.checkpoint_engine import ShardedCheckpointEngine
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (keystr,
                                                                   tree_flatten_with_path)
from deepspeed_tpu_torch.runtime.optimizer import build_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
WARMUP = {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2, "warmup_num_steps": 4,
          "warmup_type": "linear"}
# (type, params, port class)
OPTIMIZERS = {
    "Lion": ("Lion", {"betas": [0.9, 0.95], "weight_decay": 0.1}, Lion),
    "Lion_default": ("Lion", {}, Lion),
    "Adagrad": ("Adagrad", {"eps": 1e-8}, Adagrad),
    "DeepSpeedCPUAdagrad": ("DeepSpeedCPUAdagrad", {}, Adagrad),
    "SGD": ("SGD", {}, SGD),
    "SGD_momentum": ("SGD", {"momentum": 0.9}, SGD),
    "SGD_nesterov": ("SGD", {"momentum": 0.9, "nesterov": True}, SGD),
    "Muon": ("Muon", {"weight_decay": 0.1}, Muon),
    "Muon_plain_momentum": ("Muon", {"nesterov": False, "momentum": 0.9}, Muon),
}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tree():
    """A params tree with the leaf kinds the optimizers tell apart: a
    stacked [L, m, n] matrix (m > n and m < n), a 2-D matrix, a stacked
    norm scale [L, D], a vector, a 4-D MoE leaf and an embedding that Muon
    excludes by name."""
    return {"embed": {"tok": _np((32, 8), 1)},
            "layers": {"attn": {"wq": _np((2, 8, 12), 2), "wo": _np((2, 12, 8), 3)},
                       "attn_norm": {"scale": _np((2, 8), 4)},
                       "moe": {"w_up": _np((2, 3, 8, 6), 5)}},
            "final_norm": {"scale": _np((8,), 6)},
            "proj": _np((6, 10), 7)}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _names(paths):
    return ["".join(f"[{k!r}]" for k in p.split(".")) for p in paths]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax_build_optimizer(name):
    """Three steps under WarmupLR from 0 (the 0-based count: the first step
    applies lr 0, and moves nothing but optax's state) on the same params
    and grads, every leaf compared after each step."""
    type_name, params, cls = OPTIMIZERS[name]
    js, ts = (jlr.get_lr_schedule("WarmupLR", WARMUP),
              tlr.get_lr_schedule("WarmupLR", WARMUP))
    tree = _tree()
    jx = j_build(type_name, params, lr=js)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jx.init(jparams)
    paths = [p for p, _ in _flat(tree)]
    tparams = [torch.from_numpy(v.copy()) for _, v in _flat(tree)]
    topt = build_optimizer(type_name, params, tparams, lr=ts, names=_names(paths))
    assert type(topt) is cls
    for step in (1, 2, 3):
        grads = {p: _np(v.shape, 100 * step + i) for i, (p, v) in
                 enumerate(_flat(tree))}
        jgrads = jax.tree_util.tree_unflatten(          # both sort dict keys
            jax.tree_util.tree_structure(jparams),
            [jnp.asarray(grads[p]) for p in paths])
        upd, jstate = jx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.step(grads=[torch.from_numpy(grads[p]) for p in paths])
        jflat = dict(_flat(jax.tree.map(np.asarray, jparams)))
        for p, t in zip(paths, tparams):
            if cls is Muon:
                np.testing.assert_allclose(
                    t.numpy(), jflat[p], rtol=0,
                    atol=1e-5 * float(np.abs(jflat[p]).max()), err_msg=p)
            else:
                np.testing.assert_allclose(t.numpy(), jflat[p], rtol=1e-6,
                                           atol=1e-7, err_msg=p)
    assert topt.count == 3


def test_muon_orthogonalizes_what_the_jax_muon_does():
    """The embedding is excluded by its path; the 4-D MoE leaf and the
    vector keep the momentum update; a stacked [L, D] norm scale is 2-D
    and is orthogonalized, as in the JAX package."""
    tree = _tree()
    paths = [p for p, _ in _flat(tree)]
    opt = Muon([torch.from_numpy(v) for _, v in _flat(tree)], names=_names(paths))
    excluded = {p for p, t in zip(paths, opt.all_params())
                if opt.excluded[id(t)]}
    assert excluded == {"embed.tok"}
    x = torch.from_numpy(_np((3, 5, 9), 11))
    o = newton_schulz(x)
    # the quintic iteration drives singular values near 1, not to 1
    sv = torch.linalg.svdvals(o)
    assert float(sv.min()) > 0.5 and float(sv.max()) < 1.5


@pytest.mark.parametrize("type_name,params,cls", [
    ("lion", {}, Lion), ("ADAGRAD", {}, Adagrad),
    ("deepspeed_cpu_adagrad", {}, Adagrad), ("sgd", {"momentum": 0.5}, SGD),
    ("muon", {"ns_steps": 3}, Muon)])
def test_build_optimizer_maps_the_config_names(type_name, params, cls):
    opt = build_optimizer(type_name, dict(params, lr=1e-3), [torch.zeros(4, 4)])
    assert type(opt) is cls and opt.param_groups[0]["lr"] == 1e-3
    if cls is Adagrad:
        assert opt.param_groups[0]["eps"] == 1e-10
    if cls is Muon:
        assert opt.param_groups[0]["ns_steps"] == 3


def test_fused_adam_takes_bias_correction_false_and_still_corrects():
    """The JAX class accepts the flag and always corrects: so does the
    port's, bit for bit against the default and held to the JAX class."""
    p0, g = _np((300,), 0), _np((300,), 1)
    ps = {}
    for flag in (True, False):
        p = torch.from_numpy(p0.copy())
        opt = FusedAdam([p], lr=1e-2, bias_correction=flag, fused=True)
        for _ in range(2):
            opt.step(grads=[torch.from_numpy(g)])
        ps[flag] = p
    assert torch.equal(ps[True], ps[False])
    jx = JFusedAdam(lr=1e-2, bias_correction=False)
    jp = {"w": jnp.asarray(p0)}
    st = jx.init(jp)
    for _ in range(2):
        upd, st = jx.update({"w": jnp.asarray(g)}, st, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(ps[False].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
        "gradient_clipping": 1.0, "steps_per_print": 10**9}
ENGINE_CASES = ["Lion", "Adagrad", "DeepSpeedCPUAdagrad", "SGD_nesterov", "Muon"]


def _config(name):
    type_name, params, _ = OPTIMIZERS[name]
    return dict(BASE, optimizer={"type": type_name,
                                 "params": dict(params, lr=3e-3)})


def _engines(cfg, *, t_optimizer=None, j_optimizer=None):
    """The JAX engine (one-device mesh) and the port's from the same
    params."""
    jm = j_causal_lm("llama-tiny", **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    np_params = jax.tree.map(np.asarray, params)
    tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
    mesh = build_mesh(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                        config=cfg, mesh=mesh,
                                        optimizer=j_optimizer)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=np_params, config=cfg, device="cpu",
        optimizer=t_optimizer(tm) if t_optimizer else None)
    return jeng, teng


def _batches(n, seed=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], (4, 32)) for _ in range(n)]


def _run(eng, batches):
    return [(float(eng.train_step((t, t))), eng.get_global_grad_norm())
            for t in batches]


def _weights(jeng, teng):
    jflat = dict(_flat(jax.tree.map(np.asarray, jeng.state.params)))
    tflat = dict(_flat(torch_params_to_numpy(teng.params())))
    assert set(jflat) == set(tflat)
    return jflat, tflat


@pytest.fixture
def restore_mesh():
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev = mesh_mod._GLOBAL_MESH
    yield
    mesh_mod._GLOBAL_MESH = prev


def _check_weights(jflat, tflat, lion_lr=None):
    for path in jflat:
        if lion_lr is None:
            np.testing.assert_allclose(tflat[path], jflat[path], atol=1e-5,
                                       rtol=0, err_msg=path)
        else:
            d = np.abs(tflat[path] - jflat[path])
            assert d.max() <= 2 * lion_lr * 1.01, path
            assert (d > 1e-5).mean() <= 1e-3, path


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_trains_like_the_jax_engine(name, restore_mesh):
    cfg = _config(name)
    jeng, teng = _engines(cfg)
    batches = _batches(1) * 3                      # one repeated batch
    jrun, trun = _run(jeng, batches), _run(teng, batches)
    np.testing.assert_allclose(np.array(trun), np.array(jrun), rtol=1e-5)
    assert trun[2][0] < trun[0][0]
    assert type(teng.optimizer) is OPTIMIZERS[name][2]
    assert teng.optimizer.count == 3
    _check_weights(*_weights(jeng, teng),
                   lion_lr=3e-3 if name.startswith("Lion") else None)


def test_client_optimizer_takes_precedence_like_the_jax_engine(restore_mesh):
    """A client optimizer wins over the config's section in both engines:
    optax.sgd beside the port's SGD built from the masters by a callable,
    and a torch.optim.SGD instance over the model's parameters."""
    cfg = dict(BASE, optimizer={"type": "Lion", "params": {"lr": 1.0}})
    jeng, teng = _engines(cfg, j_optimizer=optax.sgd(0.05),
                          t_optimizer=lambda tm: (lambda ps: SGD(ps, lr=0.05)))
    assert type(teng.optimizer) is SGD and teng.client_optimizer is not None
    batches = _batches(3)
    jrun, trun = _run(jeng, batches), _run(teng, batches)
    np.testing.assert_allclose(np.array(trun), np.array(jrun), rtol=1e-5)
    _check_weights(*_weights(jeng, teng))
    _, teng2 = _engines(cfg, t_optimizer=lambda tm: torch.optim.SGD(
        tm.parameters(), lr=0.05))
    assert isinstance(teng2.optimizer, torch.optim.SGD)
    trun2 = _run(teng2, batches)
    np.testing.assert_allclose(np.array(trun2), np.array(jrun), rtol=1e-5)
    _check_weights(*_weights(jeng, teng2))
    with pytest.raises(NotImplementedError, match="jax_state"):
        teng2._optim_payload()


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _np32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy().copy() if x.is_floating_point() \
            else x.detach().numpy().copy()
    a = np.array(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _port_optim(teng):
    return {keystr(k): _np32(v) for k, v in
            tree_flatten_with_path(teng._optim_payload())}


def _jax_optim(jeng):
    st = jeng.state
    optim = {"opt_state": st.opt_state, "grad_acc": st.grad_acc,
             "global_steps": st.global_steps, "scaler": tuple(st.scaler)}
    return {jax.tree_util.keystr(k): _np32(v) for k, v in
            jax.tree_util.tree_flatten_with_path(optim)[0]}


def _tag_optim(tag):
    return {k: _np32(v) for k, v in ShardedCheckpointEngine().load(
        os.path.join(tag, "optim_states")).items()}


def _bit_equal(got, want, what):
    assert set(got) == set(want), f"{what}: {sorted(set(got) ^ set(want))}"
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


CKPT_CASES = ["Lion", "Adagrad", "SGD_nesterov", "Muon"]


@pytest.fixture(scope="module", params=CKPT_CASES)
def round_trip(request, tmp_path_factory):
    """Both packages save after two steps; a fresh engine of each loads the
    other's tag; all four take two more steps."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    name = request.param
    cfg = _config(name)
    root = tmp_path_factory.mktemp(f"opt_{name}")
    prev = mesh_mod._GLOBAL_MESH
    try:
        ja, ta = _engines(cfg)
        first, then = _batches(2, 3), _batches(2, 4)
        _run(ja, first)
        _run(ta, first)
        jtag, ttag = ja.save_checkpoint(str(root / "jax")), ta.save_checkpoint(
            str(root / "port"))
        saved = _port_optim(ta)
        jb, tb = _engines(cfg)
        tb.load_checkpoint(str(root / "jax"))
        jb.load_checkpoint(str(root / "port"))
        loaded = {"tb": _port_optim(tb), "jb": _jax_optim(jb)}
        counts = (ta.optimizer.count, tb.optimizer.count)
        runs = {k: _run(e, then) for k, e in
                (("ja", ja), ("ta", ta), ("jb", jb), ("tb", tb))}
    finally:
        mesh_mod._GLOBAL_MESH = prev
    return dict(name=name, jtag=jtag, ttag=ttag, saved=saved, loaded=loaded,
                runs=runs, counts=counts)


def test_port_loads_the_jax_optimizer_state_bit_equal(round_trip):
    _bit_equal(round_trip["loaded"]["tb"], _tag_optim(round_trip["jtag"]),
               "port from the JAX tag")
    assert round_trip["counts"] == (2, 2)


def test_jax_loads_the_port_optimizer_state_bit_equal(round_trip):
    tag = _tag_optim(round_trip["ttag"])
    _bit_equal(tag, round_trip["saved"], "the port's tag")
    _bit_equal(round_trip["loaded"]["jb"], tag, "JAX from the port's tag")


def test_training_goes_on_alike_after_either_optimizer_load(round_trip):
    runs = round_trip["runs"]
    for got, want in (("tb", "ja"), ("jb", "ta")):
        np.testing.assert_allclose(np.array(runs[got]), np.array(runs[want]),
                                   rtol=1e-5, err_msg=f"{got} against {want}")
