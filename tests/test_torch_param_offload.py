"""ZeRO-Infinity parameter streaming (``offload_param``) in the port against
the JAX package's streamed engine, on the CPU.

The oracle is the JAX engine on a one-device mesh at stage 0 with
``offload_param: {device: cpu}`` and ``offload_optimizer: {device: cpu}``,
driven through ``forward`` / ``step`` and read through its losses, grad
norms, ``_np_params`` (its compute-dtype host copy) and
``_offload_opt.masters()``; never through ``state.params``, whose lazy
refresh fails on JAX's CPU backend (``annotate_device_placement``),
as does its ``train_step`` (it reads ``state``).  Both engines start from
the same JAX-initialised params and take three steps of gas 2 (micro 2, S
32) with AdamW, WarmupLR and clipping 1.0 on tokens from a seed.

Tolerances:

- fp32 (llama-tiny, a tied learned-position gpt2, mixtral-tiny for the
  aux cotangent, dropout 0.1 with JAX's threefry keys): losses and grad
  norms rtol 1e-5, host masters and the host copy atol 1e-4 (the bounds of
  ``tests/test_torch_train.py``; measured ~2e-7 apart, ~1e-6 for MoE);
- bf16: the bf16 bounds of ``tests/test_torch_offload.py``'s header:
  losses rtol 1e-3, grad norms 1e-2, masters 95 % within 1e-4 and all
  within 1e-2, since the two packages round the forward's bf16 activations
  at other places (measured: losses ~3e-4 apart, masters max 6.2e-3);
- ``int8_masters`` + ``int8_stream`` in fp32: losses rtol 1e-5, grad norms
  1e-4, masters all within 5e-3 and 95 % within 1e-4: a value within
  rounding of a code boundary lands on the other code (one step of its
  block's absmax / 127), which the next steps carry (measured: losses
  1e-6 apart, masters max 2.3e-3); the h2d bytes equal the JAX codec's
  payload for the same transfers;
- among the port's own runs (prefetch on / off, nvme / cpu backends, save /
  load / step), bit for bit; the streamed run against the port's own
  ``offload_optimizer`` run (its whole-program path) in fp32
  within the fp32 bounds above.
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
from deepspeed_tpu.comm.quant import quantize_tree_np
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
ADAMW = {"lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW", "params": ADAMW},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
        "gradient_clipping": 1.0, "steps_per_print": 10**9}
STEPS, GAS, MICRO, S = 3, 2, 2, 32


def _zero(p_off=None, o_off=None):
    return {"zero_optimization": {
        "stage": 0, "offload_optimizer": dict({"device": "cpu"}, **(o_off or {})),
        "offload_param": dict({"device": "cpu"}, **(p_off or {}))}}


INT8 = _zero({"int8_stream": True}, {"int8_masters": True, "quant_block": 64})
# name: (preset, model overrides, config overrides)
CASES = {
    "fp32": ("llama-tiny", {}, {}),
    "bf16": ("llama-tiny", {}, {"bf16": {"enabled": True}}),
    "gpt2_tied": ("gpt2-small", {}, {}),
    "mixtral": ("mixtral-tiny", {"num_experts": 4}, {}),
    "dropout": ("llama-tiny", {"dropout": 0.1}, {}),
    "int8": ("llama-tiny", {}, INT8),
}


def _cfg(over):
    cfg = dict(BASE, **_zero())
    cfg.update(over)
    return cfg


def _batches(vocab=256):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (GAS * MICRO, S)) for _ in range(STEPS)]


def _micro(tok):
    return [(tok[i * MICRO:(i + 1) * MICRO], tok[i * MICRO:(i + 1) * MICRO])
            for i in range(GAS)]


def _train(eng, batches):
    """forward gas times, then step: ``(losses, grad norms)``."""
    losses, norms = [], []
    for tok in batches:
        losses += [float(eng.forward(b)) for b in _micro(tok)]
        eng.step()
        norms.append(float(eng.get_global_grad_norm()))
    return losses, norms


def _port(preset, over, np_params, cfg, **kw):
    return deepspeed_tpu_torch.initialize(
        model=t_causal_lm(preset, device="cpu", **TINY, **over),
        model_parameters=np_params, config=cfg, device="cpu", **kw)[0]


def _jax_init(preset, over):
    jm = j_causal_lm(preset, **TINY, **over)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jm, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs():
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev = mesh_mod._GLOBAL_MESH
    out = {}
    try:
        mesh = build_mesh(devices=jax.devices()[:1])
        for name, (preset, over, cfg_over) in CASES.items():
            jm, params, np_params = _jax_init(preset, over)
            cfg = _cfg(cfg_over)
            je = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                          config=cfg, mesh=mesh)[0]
            assert je._streamed is not None
            te = _port(preset, over, np_params, cfg)
            out[name] = dict(je=je, te=te, j=_train(je, _batches()),
                             t=_train(te, _batches()), np_params=np_params)
    finally:
        mesh_mod._GLOBAL_MESH = prev
    return out


def _master_diffs(te, je):
    assert te._offload_opt._paths == je._offload_opt._paths
    return np.concatenate([np.abs(a.numpy() - b).ravel() for a, b in
                           zip(te._offload_opt.masters(), je._offload_opt.masters())])


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_losses_and_grad_norms_match_the_jax_engine(runs, case):
    r = runs[case]
    (jl, jn), (tl, tn) = r["j"], r["t"]
    loss_tol, norm_tol = {"bf16": (1e-3, 1e-2), "int8": (1e-5, 1e-4)}.get(case, (1e-5, 1e-5))
    np.testing.assert_allclose(tl, jl, rtol=loss_tol)
    np.testing.assert_allclose(tn, jn, rtol=norm_tol)
    assert r["te"].global_steps == STEPS == r["te"]._offload_opt.step_count
    assert r["te"]._offload_opt.step_count == r["je"]._offload_opt.step_count
    assert all(np.isfinite(tl))


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_host_masters_and_copy_match_the_jax_engine(runs, case):
    """The host optimizer's fp32 masters against JAX's, and the port's host
    copy (the compute-dtype params the next forward streams) against JAX's
    ``_np_params``; the copy is the masters cast to the compute dtype."""
    te, je = runs[case]["te"], runs[case]["je"]
    d = _master_diffs(te, je)
    if case == "bf16":
        assert d.max() <= 1e-2 and (d <= 1e-4).mean() >= 0.95, (d.max(), (d <= 1e-4).mean())
    elif case == "int8":
        assert d.max() <= 5e-3 and (d <= 1e-4).mean() >= 0.95, (d.max(), (d <= 1e-4).mean())
    else:
        assert d.max() <= 1e-4, d.max()
    jleaves = dict(zip(je._offload_opt._paths, jax.tree.leaves(je._np_params)))
    assert all(t.device.type == "cpu" and t.dtype == te.compute_dtype for t in te.master)
    for i, j in enumerate(te._offload_order):
        want = np.asarray(jleaves[te._offload_opt._paths[i]], np.float32)
        got = te.master[j].float().numpy()
        tol = 1e-2 if case in ("bf16", "int8") else 1e-4
        assert np.abs(got - want).max() <= tol
        assert torch.equal(te.master[j].reshape(-1),
                           te._offload_opt.masters()[i].to(te.compute_dtype))


def test_int8_stream_moves_the_jax_codec_bytes(runs):
    """The int8 relay's h2d bytes equal what the JAX codec's payloads
    (``quantize_tree_np``: int8 codes and fp32 scales) weigh for the same
    transfers: a micro-batch's forward takes L layers, its backward L-1
    (layer L-1's forward copy is kept), the embedding twice and the head
    once.  Against the same transfers as a bf16 relay, at least 1.3x fewer
    bytes (the JAX package's own ratio); the dense fp32 run's bytes are the
    same count at 4 bytes a parameter."""
    L = TINY["num_layers"]
    micro = STEPS * GAS
    np_params = runs["int8"]["np_params"]
    layer = jax.tree.map(lambda a: a[0], np_params["layers"])
    head = {"final_norm": np_params["final_norm"], "head": np_params["lm_head"]}

    def q_bytes(tree):
        return quantize_tree_np(tree, 64).nbytes

    def dense(tree):
        return sum(a.size * 4 for a in jax.tree.leaves(tree))

    want = micro * ((2 * L - 1) * q_bytes(layer) + 2 * q_bytes(np_params["embed"])
                    + q_bytes(head))
    got = runs["int8"]["te"]._streamed.streamer.h2d_bytes
    assert got == want
    fp32 = micro * ((2 * L - 1) * dense(layer) + 2 * dense(np_params["embed"])
                    + dense(head))
    assert runs["fp32"]["te"]._streamed.streamer.h2d_bytes == fp32
    assert (fp32 / 2) / got >= 1.3


def test_prefetch_off_is_bit_equal_and_counts_misses(runs):
    """The transport never changes the numbers: prefetch off gives the
    losses and host masters of prefetch on bit for bit; every take of the
    prefetching run but a micro-batch's first finds its layer in flight,
    and with prefetch off every take misses."""
    on = runs["bf16"]["te"]
    off = _port("llama-tiny", {}, runs["bf16"]["np_params"],
                _cfg({"bf16": {"enabled": True}, **_zero({"prefetch": False})}))
    assert _train(off, _batches()) == runs["bf16"]["t"]
    for a, b in zip(off._offload_opt.masters(), on._offload_opt.masters()):
        assert torch.equal(a, b)
    L, micro = TINY["num_layers"], STEPS * GAS
    s_on, s_off = on._streamed.streamer, off._streamed.streamer
    assert s_on.takes == s_off.takes == micro * (2 * L - 1)
    assert (s_on.prefetch_hits, s_on.prefetch_misses) == (micro * (2 * L - 1), 0)
    assert (s_off.prefetch_hits, s_off.prefetch_misses) == (0, micro * (2 * L - 1))


def test_slots_are_handed_out_in_turn_and_held_layer_skipped(runs):
    """Two slots: the forward fills them in turn; the last layer's forward
    copy stays held for the backward, so the backward's first prefetch
    takes the other slot."""
    st = runs["fp32"]["te"]._streamed.streamer
    assert st.staging_slots == 2 and len(st._slots) == 2
    # one micro-batch of two layers: fwd 0 -> slot 0, fwd 1 -> slot 1,
    # bwd 0 -> slot 0 again (slot 1 still holds layer 1)
    # and the next micro-batch's forward: fwd 0 -> slot 1, fwd 1 -> slot 0
    first = [(slot, old, new) for slot, old, new, *_ in st.reuse_log[:3]]
    assert first == [(0, 0, 0), (1, 1, 0), (0, 0, 1)]


def test_nvme_optimizer_backend_bit_equal_to_cpu(runs, tmp_path):
    """``offload_param: nvme`` keeps the params in host memory, as the JAX
    engine does; with the optimizer state in NVMe files (offload_param's
    ``nvme_path`` when no offload_optimizer section is given), the run is
    the cpu backend's bit for bit."""
    cfg = dict(BASE, bf16={"enabled": True}, zero_optimization={
        "stage": 0, "offload_param": {"device": "nvme", "nvme_path": str(tmp_path)}})
    te = _port("llama-tiny", {}, runs["bf16"]["np_params"], cfg)
    assert te._offload_opt.backend == "nvme"
    assert _train(te, _batches()) == runs["bf16"]["t"]
    for a, b in zip(te._offload_opt.masters(), runs["bf16"]["te"]._offload_opt.masters()):
        assert torch.equal(a, b)


def test_streamed_run_against_the_port_offload_optimizer_run(runs):
    """The streamed path and the port's whole-program optimizer-offload path
    compute the same step from the same inputs; in fp32 within the fp32
    bounds (the streamed backward recomputes each layer and adds the head's
    and the layers' grads to the host accumulators one by one)."""
    off = deepspeed_tpu_torch.initialize(
        model=t_causal_lm("llama-tiny", device="cpu", **TINY),
        model_parameters=runs["fp32"]["np_params"],
        config=dict(BASE, zero_optimization={"stage": 0, "offload_optimizer": {
            "device": "cpu"}}), device="cpu")[0]
    assert off._streamed is None
    losses, norms = _train(off, _batches())
    np.testing.assert_allclose(runs["fp32"]["t"][0], losses, rtol=1e-5)
    np.testing.assert_allclose(runs["fp32"]["t"][1], norms, rtol=1e-5)
    d = max(float((a - b).abs().max()) for a, b in zip(
        off._offload_opt.masters(), runs["fp32"]["te"]._offload_opt.masters()))
    assert d <= 1e-4


def test_evaluate_streams_the_forward_loss(runs):
    """At dropout 0, ``evaluate`` (the streamed forward, no grads) gives the
    loss the next training forward returns on the same params, and the
    whole-program ``apply`` on the host copy agrees; neither changes the
    accumulators."""
    te = _port("llama-tiny", {}, runs["fp32"]["np_params"], _cfg({}))
    tok = _batches()[0][:MICRO]
    te.eval()
    ev = te((tok, tok))
    assert all(float(a.abs().sum()) == 0 for a in te.grad_acc)
    te.train()
    tr = te.forward((tok, tok))
    assert float(ev) == float(tr)
    t = torch.as_tensor(tok).long()
    np.testing.assert_allclose(float(te.module.apply(te.params(), t, t)), float(ev),
                               rtol=1e-6)
    # the module's parameters are the engine's host copy
    held = te.module.state_dict(keep_vars=True)
    assert all(held[path].data_ptr() == m.data_ptr() for path, m in zip(te._paths, te.master))


def test_save_load_resumes_bit_equal_and_the_jax_offload_engine_loads_it(runs, tmp_path):
    """Two steps, save, a fresh engine loads the tag and takes step 3 bit
    for bit as the uninterrupted run; the tag is the optimizer-offload layout
    (compute-dtype params in ``model_states``, ``offload_states/``), which
    the JAX engine under ``offload_optimizer`` alone loads: its host masters
    and moments bit-equal to the port's, its step count the same."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    np_params = runs["bf16"]["np_params"]
    cfg = _cfg({"bf16": {"enabled": True}})
    batches = _batches()
    a = _port("llama-tiny", {}, np_params, cfg)
    _train(a, batches[:2])
    tag = a.save_checkpoint(str(tmp_path), tag="t2")
    assert sorted(p.name for p in (tmp_path / "t2").iterdir()) == [
        "MANIFEST.json", "client_state.json", "model_states", "offload_states",
        "optim_states"]
    want = _train(a, batches[2:])
    b = _port("llama-tiny", {}, np_params, cfg)
    b.load_checkpoint(str(tmp_path), tag="t2")
    assert b.global_steps == 2 and b._offload_opt.step_count == 2
    assert _train(b, batches[2:]) == want
    for x, y in zip(b._offload_opt.masters(), a._offload_opt.masters()):
        assert torch.equal(x, y)
    for x, y in zip(b.master, a.master):
        assert torch.equal(x, y)

    jm, params, _ = _jax_init("llama-tiny", {})
    prev = mesh_mod._GLOBAL_MESH
    try:
        je = deepspeed_tpu.initialize(
            model=jm, model_parameters=params, mesh=build_mesh(devices=jax.devices()[:1]),
            config=dict(BASE, bf16={"enabled": True}, zero_optimization={
                "stage": 0, "offload_optimizer": {"device": "cpu"}}))[0]
        je.load_checkpoint(str(tmp_path), tag="t2")
    finally:
        mesh_mod._GLOBAL_MESH = prev
    assert je._offload_opt.step_count == 2
    port = _port("llama-tiny", {}, np_params, cfg)
    port.load_checkpoint(str(tmp_path), tag="t2")
    for i in range(len(port._offload_opt._sizes)):
        for x, y in zip(port._offload_opt._leaf_states(i), je._offload_opt._leaf_states(i)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert tag.endswith("t2")


def test_offload_param_alone_and_cpu_offload_params(runs, caplog):
    """``offload_param`` without ``offload_optimizer`` turns on the host
    optimizer on its device, as the JAX engine does; ``cpu_offload_params``
    is accepted and changes nothing."""
    cfg = dict(BASE, zero_optimization={"stage": 0, "offload_param": {"device": "cpu"},
                                        "cpu_offload_params": True})
    with caplog.at_level(logging.INFO):
        te = _port("llama-tiny", {}, runs["fp32"]["np_params"], cfg)
    assert "streamed per-layer fwd/bwd active" in caplog.text
    assert te._offload and te._offload_opt.backend == "cpu" and te._streamed is not None
    assert _train(te, _batches()) == runs["fp32"]["t"]
    plain = deepspeed_tpu_torch.initialize(
        model=t_causal_lm("llama-tiny", device="cpu", **TINY), device="cpu",
        config=dict(BASE, zero_optimization={"stage": 0, "cpu_offload_params": True}))[0]
    assert not plain._offload and plain._streamed is None


class _NoSegments:
    """A functional model without ``stream_segments``."""

    def __init__(self):
        self.inner = t_causal_lm("llama-tiny", device="cpu", **TINY)

    def params(self):
        return self.inner.params()

    def apply(self, params, *batch, **kw):
        return self.inner.apply(params, *batch, **kw)


@pytest.mark.parametrize("what", ["stream_grads", "loss_fn", "no_segments",
                                  "apply_with_param_offload", "batch_form"])
def test_the_whole_program_path_is_refused(what):
    """What the JAX engine sends through its whole-program path (which
    fails on JAX's CPU backend in the JAX package itself) raises,
    naming the ROADMAP item."""
    match = "item 2e, the whole-program offload_param path"
    cfg = _cfg({})
    tok = np.zeros((2, 8), np.int64)
    with pytest.raises(NotImplementedError, match=match):
        if what == "stream_grads":
            _port("llama-tiny", {}, None, _cfg(_zero({"stream_grads": False})))
        elif what == "loss_fn":
            _port("llama-tiny", {}, None, cfg, loss_fn=lambda p, b, r: 0.0)
        elif what == "no_segments":
            deepspeed_tpu_torch.initialize(model=_NoSegments(), config=cfg, device="cpu")
        elif what == "apply_with_param_offload":
            model = t_causal_lm("llama-tiny", device="cpu", **TINY)
            model.config.param_offload = True
            deepspeed_tpu_torch.initialize(model=model, config=BASE, device="cpu")
        else:
            _port("llama-tiny", {}, None, cfg).forward((tok, tok, tok))


def test_fp16_with_offload_param_raises_the_jax_value_error():
    with pytest.raises(ValueError, match="offload_param does not support fp16"):
        _port("llama-tiny", {}, None, _cfg({"fp16": {"enabled": True}}))
