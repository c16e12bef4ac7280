"""Checkpoints of the port's ZeRO ranks against the JAX engine's, on the
CPU: tags cross world sizes and stages both ways.

Two gloo ranks of the port (``tests/torch_zero_ranks.py``) train
llama-tiny at stage 3 for two steps and save; the JAX engine trains at
``fsdp=2``, stage 2, for two steps and saves.  Each side then loads the
other's tag (the port's ranks at stage 3, the JAX engine at ``fsdp=2``),
and a port engine at world 1, stage 0, loads the ranks' tag.  Every
resumed engine takes the third step, which is held to the run that was
not interrupted: bit-equal for the port's ranks resuming their own tag;
at ``tests/test_torch_zero.py``'s fp32 bounds (losses rtol 2e-5, grad
norms 1e-4, masters atol 1e-4) across packages or world sizes, where the
sums run in another order.  The loaded masters are bit-equal to the saved
ones every time, and ``zero_to_fp32`` and the universal reader give the
full params from the ranks' tag.
"""

import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as jmesh_mod
from deepspeed_tpu.comm.mesh import build_mesh as j_build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu_torch.checkpoint import DeepSpeedCheckpoint
from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint
from tests.test_torch_zero import (TINY, close_params, config, init_params,
                                   token_batches)
from tests.torch_zero_ranks import RankGroup, ckpt_scenarios, flat
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEP_RTOL, NORM_RTOL = 2e-5, 1e-4


def _jax_engine(params, cfg):
    mesh = j_build_mesh(fsdp=2, devices=jax.devices()[:2])
    return deepspeed_tpu.initialize(model=j_causal_lm("llama-tiny", **TINY["llama-tiny"]),
                                    model_parameters=params, config=cfg, mesh=mesh)[0]


def _step(engine, batch):
    loss = engine.train_step(batch)
    return float(loss), engine.get_global_grad_norm()


@pytest.fixture(scope="module")
def tags(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero_ckpt")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    params = init_params("llama-tiny")
    batches = token_batches(2, seed=11)
    prev = jmesh_mod._GLOBAL_MESH
    try:
        # the JAX engine's stage-2 tag first: the ranks load it
        ja = _jax_engine(params, config(2))
        _step(ja, batches[0])
        _step(ja, batches[1])
        ja.save_checkpoint(jax_dir, tag="jax")
        jax_third = _step(ja, batches[2])
        group = RankGroup(2, ckpt_scenarios, (
            "llama-tiny", TINY["llama-tiny"], params, config(3), batches,
            port_dir, jax_dir))
        ranks = group.results()
        # the ranks' stage-3 tag into the JAX engine at fsdp=2 ...
        jb = _jax_engine(params, config(3))
        jb.load_checkpoint(port_dir)
        jax_loaded = dict(flat(jax.tree.map(np.asarray, jb.state.params)))
        jax_resumed = _step(jb, batches[2])
        # ... and into a port engine at world 1, stage 0 (micro 4: the same
        # global batch)
        one = deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                                **TINY["llama-tiny"]),
            model_parameters=params, device="cpu",
            config=dict(config(0), train_micro_batch_size_per_gpu=4))[0]
        one.load_checkpoint(port_dir)
        one_loaded = {k: v.detach().numpy().copy() for k, v in flat(one.params())}
        one_step = _step(one, batches[2])
        one_params = {k: v.detach().numpy().copy() for k, v in flat(one.params())}
    finally:
        jmesh_mod._GLOBAL_MESH = prev
    return dict(ranks=ranks, port_dir=port_dir, jax_third=jax_third,
                jax_loaded=jax_loaded, jax_resumed=jax_resumed,
                one_loaded=one_loaded, one_step=one_step, one_params=one_params,
                ja_params=dict(flat(jax.tree.map(np.asarray, ja.state.params))))


def _bit_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def test_ranks_write_their_slices_and_rank0_the_rest(tags):
    """``shard_p{rank}.bin`` and ``index_p{rank}.json`` from each rank, one
    chunk a sharded leaf on each, a replicated leaf's chunk on rank 0 only;
    the manifest and client state say world 2, stage 3."""
    tag = os.path.join(tags["port_dir"], "resume")
    model = os.path.join(tag, "model_states")
    assert sorted(os.listdir(model)) == ["index_p0.json", "index_p1.json",
                                         "shard_p0.bin", "shard_p1.bin"]
    idx = [json.load(open(os.path.join(model, f"index_p{r}.json"))) for r in (0, 1)]
    for key in idx[0]:
        chunks = [len(i[key]["chunks"]) for i in idx]
        assert chunks in ([1, 1], [1, 0]), (key, chunks)
    assert sum(len(i["['layers']['attn']['wq']"]["chunks"]) for i in idx) == 2
    with open(os.path.join(tag, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    with open(os.path.join(tag, "client_state.json")) as fh:
        meta = json.load(fh)
    assert meta["world_size"] == 2 and meta["zero_stage"] == 3
    assert meta["data_parallel_size"] == 2
    assert json.dumps(manifest).count('"zero_stage": 3') == 1


def test_ranks_resume_their_own_tag_bit_equal(tags):
    for rank in tags["ranks"]:
        resumed = rank["resumed"]
        _bit_equal(resumed["loaded"], rank["saved"], "loaded masters")
        assert resumed["global_steps"] == 3        # two loaded, one taken
        assert resumed["step"] == rank["run"][2]
        _bit_equal(resumed["params"], rank["run_params"], "params after the step")


def test_ranks_at_stage3_resume_the_jax_stage2_tag(tags):
    """The JAX engine's ``fsdp=2`` stage-2 tag (params replicated, moments
    and accumulator in two chunks) into port ranks at stage 3."""
    for rank in tags["ranks"]:
        got = rank["from_jax"]
        np.testing.assert_allclose(got["step"][0], tags["jax_third"][0], rtol=STEP_RTOL)
        np.testing.assert_allclose(got["step"][1], tags["jax_third"][1], rtol=NORM_RTOL)
        close_params(got["params"], tags["ja_params"])


def test_jax_engine_resumes_the_ranks_stage3_tag(tags):
    rank0 = tags["ranks"][0]
    _bit_equal({k: np.asarray(v, np.float32) for k, v in tags["jax_loaded"].items()},
               rank0["saved"], "JAX params loaded")
    np.testing.assert_allclose(tags["jax_resumed"][0], rank0["run"][2][0], rtol=STEP_RTOL)
    np.testing.assert_allclose(tags["jax_resumed"][1], rank0["run"][2][1], rtol=NORM_RTOL)


def test_world1_stage0_resumes_the_ranks_stage3_tag(tags):
    rank0 = tags["ranks"][0]
    _bit_equal(tags["one_loaded"], rank0["saved"], "world-1 masters loaded")
    np.testing.assert_allclose(tags["one_step"][0], rank0["run"][2][0], rtol=STEP_RTOL)
    np.testing.assert_allclose(tags["one_step"][1], rank0["run"][2][1], rtol=NORM_RTOL)
    close_params(tags["one_params"], rank0["run_params"])


def test_zero_to_fp32_and_universal_read_the_ranks_tag(tags):
    saved = tags["ranks"][0]["saved"]
    flat32 = get_fp32_state_dict_from_zero_checkpoint(tags["port_dir"])
    _bit_equal({k.replace("/", "."): v.numpy() for k, v in flat32.items()}, saved,
               "zero_to_fp32")
    ck = DeepSpeedCheckpoint(tags["port_dir"])
    assert ck.zero_stage == 3 and ck.world_size == 2
    _bit_equal({k: v.numpy() for k, v in flat(ck.load_params())}, saved, "universal")
