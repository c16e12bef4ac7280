"""Checkpoints of the port's training engine against the JAX package's, on
the CPU: a tag either package writes loads in the other, for every
optimizer type the port accepts.

Per config, both engines start from the same params and take two steps on
the same batches; each saves.  A fresh port engine loads the JAX tag and a
fresh JAX engine (one-device mesh) loads the port's, and every engine
takes two more steps.  Checked:

- the loaded state, bit for bit: the masters, the accumulator, every
  optimizer leaf (moments, int8 codes and scales, counts), the step count,
  the loss scaler's four scalars and the LR schedule's step, against the
  tag's bytes;
- the port's own tag resumes bit-equal to the port's uninterrupted run;
- the two packages' ``index_p0.json`` of the same state: the same key
  strings, shapes and dtypes; ``client_state.json``: the same keys and
  values (``world_size`` apart: the JAX engine counts the process's
  devices, the port its one card);
- training goes on alike: losses and grad norms of the two steps after the
  load against the other package's, rtol 1e-5 (``tests/test_torch_train.
  py``: the same fp32 formulas summed in another order), except two
  configs whose compute is not fp32: fp16 compute 1e-3
  (``tests/test_torch_fp16.py``: fp16 activations rounded at other places
  than XLA's fused fp32 chains) and master-free bf16 Adam8bit 2e-2
  (``tests/test_torch_optimizers.py``: bf16 weights, and stochastic
  rounding whose noise is each package's own).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.runtime.checkpoint_engine import ShardedCheckpointEngine
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (keystr,
                                                                   tree_flatten_with_path)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
        "gradient_clipping": 1.0, "steps_per_print": 10**9}
ADAM = {"lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}
CONFIGS = {
    "FusedAdam": {"optimizer": {"type": "FusedAdam", "params": ADAM}},
    "torch_adam": {"optimizer": {"type": "FusedAdam",
                                 "params": dict(ADAM, torch_adam=True)}},
    "Adam_l2": {"optimizer": {"type": "Adam",
                              "params": dict(ADAM, adam_w_mode=False)}},
    "AdamW": {"optimizer": {"type": "AdamW", "params": ADAM}},
    "Adam8bit": {"optimizer": {"type": "Adam8bit", "params": ADAM}},
    "FusedLamb": {"optimizer": {"type": "FusedLamb", "params": ADAM}},
    "Lamb": {"optimizer": {"type": "Lamb", "params": ADAM}},
    "fp16": {"optimizer": {"type": "FusedAdam", "params": ADAM},
             "fp16": {"enabled": True}},
    "master_free_adam8bit": {"optimizer": {"type": "Adam8bit", "params": ADAM},
                             "bf16": {"enabled": True, "master_weights": False},
                             "data_types": {"grad_accum_dtype": "bf16"}},
}
TOL = {"fp16": 1e-3, "master_free_adam8bit": 2e-2}


def _np32(x):
    """A copy of a JAX or torch leaf as numpy, bf16 widened to fp32 (exact)."""
    if torch.is_tensor(x):
        x = x.detach().float() if x.is_floating_point() else x.detach()
        return x.numpy().copy()
    a = np.array(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _batches(n):
    rng = np.random.default_rng(7)
    return [rng.integers(0, TINY["vocab_size"], (4, 32)) for _ in range(n)]


def _steps(eng, batches):
    out = []
    for tok in batches:
        loss = float(eng.train_step((tok, tok)))
        out.append((loss, eng.get_global_grad_norm()))
    return out


def _jax_state_leaves(jeng):
    """Every saved leaf of a JAX engine by its key: model_states and
    optim_states as its save writes them."""
    st = jeng.state
    optim = {"opt_state": st.opt_state, "grad_acc": st.grad_acc,
             "global_steps": st.global_steps, "scaler": tuple(st.scaler)}
    return ({jax.tree_util.keystr(k): _np32(v) for k, v in
             jax.tree_util.tree_flatten_with_path(st.params)[0]},
            {jax.tree_util.keystr(k): _np32(v) for k, v in
             jax.tree_util.tree_flatten_with_path(optim)[0]})


def _port_state_leaves(teng):
    return ({keystr(k): _np32(v) for k, v in
             tree_flatten_with_path(teng._nest(teng.master))},
            {keystr(k): _np32(v) for k, v in
             tree_flatten_with_path(teng._optim_payload())})


def _tag_leaves(tag_dir):
    eng = ShardedCheckpointEngine()
    return tuple({k: _np32(v) for k, v in
                  eng.load(os.path.join(tag_dir, sub)).items()}
                 for sub in ("model_states", "optim_states"))


def _assert_bit_equal(got, want, what):
    assert set(got) == set(want), f"{what}: keys differ"
    for key in want:
        assert got[key].shape == want[key].shape, f"{what} {key}"
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{what} {key}")


@pytest.fixture(scope="module", params=list(CONFIGS))
def round_trip(request, tmp_path_factory):
    """Both packages save after two steps and load the other's tag; every
    engine then takes two more steps."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    name = request.param
    cfg = dict(BASE, **CONFIGS[name])
    root = tmp_path_factory.mktemp(f"ckpt_{name}")
    dj, dt = str(root / "jax"), str(root / "port")
    first, then = _batches(2), _batches(4)[2:]
    prev_mesh = mesh_mod._GLOBAL_MESH
    try:
        jm = j_causal_lm("llama-tiny", **TINY)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        np_params = jax.tree.map(np.asarray, params)
        mesh = build_mesh(devices=jax.devices()[:1])

        def jax_engine():
            return deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                            config=cfg, mesh=mesh)[0]

        def port_engine():
            tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
            return deepspeed_tpu_torch.initialize(
                model=tm, model_parameters=np_params, config=cfg,
                device="cpu")[0]

        ja, ta = jax_engine(), port_engine()
        _steps(ja, first)
        _steps(ta, first)
        tags = (ja.save_checkpoint(dj), ta.save_checkpoint(dt))
        saved_port = _port_state_leaves(ta)
        tb, tc, jb = port_engine(), port_engine(), jax_engine()
        loaded = {"tb": tb.load_checkpoint(dj), "tc": tc.load_checkpoint(dt),
                  "jb": jb.load_checkpoint(dt)}
        after_load = {"tb": _port_state_leaves(tb), "jb": _jax_state_leaves(jb),
                      "tb_lr": tb.get_lr()[0], "jb_lr": jb.get_lr()[0],
                      "ta_lr": ta.get_lr()[0], "ja_lr": ja.get_lr()[0]}
        runs = {k: _steps(e, then) for k, e in
                (("ja", ja), ("ta", ta), ("tb", tb), ("tc", tc), ("jb", jb))}
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    return dict(name=name, dj=dj, dt=dt, loaded=loaded, saved_port=saved_port,
                after_load=after_load, runs=runs, tags=tags)


def test_port_loads_the_jax_tag_bit_equal(round_trip):
    rt = round_trip
    ckpt_dir, client = rt["loaded"]["tb"]
    assert ckpt_dir == rt["tags"][0] and client == {}
    model, optim = rt["after_load"]["tb"]
    tag_model, tag_optim = _tag_leaves(rt["tags"][0])
    _assert_bit_equal(model, tag_model, "masters")
    _assert_bit_equal(optim, tag_optim, "optim_states")
    assert rt["after_load"]["tb_lr"] == pytest.approx(rt["after_load"]["ja_lr"],
                                                      rel=1e-7)


def test_jax_loads_the_port_tag_bit_equal(round_trip):
    rt = round_trip
    assert rt["loaded"]["jb"][0] == rt["tags"][1]
    model, optim = rt["after_load"]["jb"]
    tag_model, tag_optim = _tag_leaves(rt["tags"][1])
    _assert_bit_equal(model, tag_model, "JAX params")
    _assert_bit_equal(optim, tag_optim, "JAX optim_states")
    # and the tag holds the port's live state at the save, bit for bit
    _assert_bit_equal(tag_model, rt["saved_port"][0], "port masters")
    _assert_bit_equal(tag_optim, rt["saved_port"][1], "port optim state")
    assert rt["after_load"]["jb_lr"] == pytest.approx(rt["after_load"]["ta_lr"],
                                                      rel=1e-7)


def test_port_resumes_its_own_tag_bit_equal(round_trip):
    runs = round_trip["runs"]
    assert runs["tc"] == runs["ta"]


def test_training_goes_on_alike_after_either_load(round_trip):
    runs, tol = round_trip["runs"], TOL.get(round_trip["name"], 1e-5)
    for got, want in (("tb", "ja"), ("jb", "ta")):
        np.testing.assert_allclose(np.array(runs[got]), np.array(runs[want]),
                                   rtol=tol, err_msg=f"{got} against {want}")


def test_index_files_and_client_state_agree(round_trip):
    jtag, ttag = round_trip["tags"]
    for sub in ("model_states", "optim_states"):
        with open(os.path.join(jtag, sub, "index_p0.json")) as fh:
            jidx = json.load(fh)
        with open(os.path.join(ttag, sub, "index_p0.json")) as fh:
            tidx = json.load(fh)
        assert list(tidx) == list(jidx), sub
        for key in jidx:
            assert (tidx[key]["shape"], tidx[key]["dtype"]) == (
                jidx[key]["shape"], jidx[key]["dtype"]), key
    with open(os.path.join(jtag, "client_state.json")) as fh:
        jmeta = json.load(fh)
    with open(os.path.join(ttag, "client_state.json")) as fh:
        tmeta = json.load(fh)
    # the JAX engine's world_size counts the process's devices (8 on the
    # test mesh's host), the port's its one card; the data-parallel size
    # is 1 on both
    assert tmeta.pop("world_size") == 1 and jmeta.pop("world_size") == jax.device_count()
    assert tmeta == jmeta
    with open(os.path.join(jtag, "MANIFEST.json")) as fh:
        jman = json.load(fh)
    with open(os.path.join(ttag, "MANIFEST.json")) as fh:
        tman = json.load(fh)
    assert set(tman) == set(jman) and set(tman["files"]) == set(jman["files"])
    for key in ("format_version", "tag", "zero_stage", "global_steps"):
        assert tman[key] == jman[key], key
    assert tman["world_size"] == 1
