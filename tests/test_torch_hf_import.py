"""The port's HF checkpoint import, and the families it brings to training
(BLOOM: ALiBi and the embedding LayerNorm; GPT-NeoX: the parallel
residual), against the JAX package on the CPU.

Tiny checkpoints are written by the ``transformers`` library itself, as
``tests/unit/test_hf_import.py`` writes them (the same configurations, with
every zero bias perturbed so a dropped bias would show).  Tolerances:
``hf_to_params`` exactly (the same numpy operations on the same arrays);
logits 1e-4 against the JAX model (fp32 sums in another order over two
layers) and 2e-3 against HF (the JAX test's bound); training as
tests/test_torch_train.py: loss and grad norm rtol 1e-5, the learning rate
1e-7, weights atol 1e-4 after three Adam steps.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models.transformer import CausalLM as JCausalLM
from deepspeed_tpu.module_inject import containers as jct
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from deepspeed_tpu_torch.models.transformer import CausalLM
from deepspeed_tpu_torch.module_inject import containers as tct
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

transformers = pytest.importorskip("transformers")

KINDS = ["gpt2", "llama", "opt", "qwen2", "gpt_neox", "bloom", "gptj",
         "mixtral"]


def _save_tiny(tmp_path, kind: str) -> str:
    torch.manual_seed(0)
    out = str(tmp_path / kind)
    if kind == "gpt2":
        cfg = transformers.GPT2Config(
            vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        model = transformers.GPT2LMHeadModel(cfg)
    elif kind == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, tie_word_embeddings=False)
        model = transformers.LlamaForCausalLM(cfg)
    elif kind == "opt":
        cfg = transformers.OPTConfig(
            vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            word_embed_proj_dim=32, dropout=0.0, do_layer_norm_before=True)
        model = transformers.OPTForCausalLM(cfg)
    elif kind == "qwen2":
        cfg = transformers.Qwen2Config(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, tie_word_embeddings=False)
        model = transformers.Qwen2ForCausalLM(cfg)
    elif kind == "gpt_neox":
        cfg = transformers.GPTNeoXConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, rotary_pct=0.25,
            use_parallel_residual=True, tie_word_embeddings=False,
            hidden_dropout=0.0, attention_dropout=0.0)
        model = transformers.GPTNeoXForCausalLM(cfg)
    elif kind == "bloom":
        cfg = transformers.BloomConfig(
            vocab_size=128, hidden_size=32, n_layer=2, n_head=4,
            hidden_dropout=0.0, attention_dropout=0.0)
        model = transformers.BloomForCausalLM(cfg)
    elif kind == "gptj":
        cfg = transformers.GPTJConfig(
            vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
            rotary_dim=4, n_inner=64, resid_pdrop=0.0, embd_pdrop=0.0,
            attn_pdrop=0.0, tie_word_embeddings=False)
        model = transformers.GPTJForCausalLM(cfg)
    else:
        cfg = transformers.MixtralConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=4, num_experts_per_tok=2,
            max_position_embeddings=64, tie_word_embeddings=False)
        model = transformers.MixtralForCausalLM(cfg)
    model.eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") and p.abs().sum() == 0:
                p.add_(torch.randn_like(p) * 0.05)
    model.save_pretrained(out, safe_serialization=True)
    return out


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("kind", KINDS)
def test_config_and_hf_to_params_match_jax(tmp_path, kind):
    """The same ModelConfig, field for field, and the same parameter tree,
    array for array (names, shapes, dtypes and bits)."""
    path = _save_tiny(tmp_path, kind)
    assert tct.is_hf_checkpoint(path) and jct.is_hf_checkpoint(path)
    tcfg, jcfg = tct.config_from_hf(path), jct.config_from_hf(path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    sd = tct.load_hf_state_dict(path)
    assert tct.detect_arch(tct._strip_prefix(sd)) == kind
    got = dict(_flat(tct.hf_to_params(sd, tcfg)))
    want = dict(_flat(jct.hf_to_params(jct.load_hf_state_dict(path), jcfg)))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and np.array_equal(got[name], arr), name


def test_is_hf_checkpoint_refuses_other_layouts(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    assert not tct.is_hf_checkpoint(str(tmp_path))
    (tmp_path / "shard_p0.bin").write_bytes(b"")
    assert not tct.is_hf_checkpoint(str(tmp_path))
    assert not tct.is_hf_checkpoint(str(tmp_path / "missing"))


@pytest.mark.parametrize("kind", ["bloom", "gpt_neox", "gptj"])
def test_causal_lm_from_hf_logits_match_jax_and_hf(tmp_path, kind):
    path = _save_tiny(tmp_path, kind)
    toks = np.array([[1, 5, 9, 2, 77, 31, 8, 4]], np.int64)
    model = tct.causal_lm_from_hf(path, device="cpu")
    assert isinstance(model, CausalLM)
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in model.parameters())
    got = model.apply(model.params(), torch.from_numpy(toks)).numpy()
    jm, jparams = jct.causal_lm_from_hf(path)
    jm.config.remat = False
    want = np.asarray(jm.apply(jparams, jnp.asarray(toks, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    hf = transformers.AutoModelForCausalLM.from_pretrained(path).eval()
    with torch.no_grad():
        np.testing.assert_allclose(got, hf(torch.from_numpy(toks)).logits.numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_causal_lm_from_hf_casts_to_the_asked_dtype(tmp_path):
    path = _save_tiny(tmp_path, "bloom")
    model = tct.causal_lm_from_hf(path, device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.config.position == "alibi" and model.config.embed_norm


# ---------------------------------------------------------------------------
# training the imported families: 3 steps against the JAX engine
# ---------------------------------------------------------------------------

DS_CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
             "optimizer": {"type": "FusedAdam", "params": {
                 "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
             "scheduler": {"type": "WarmupLR", "params": {
                 "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
             "gradient_clipping": 1.0, "steps_per_print": 10**9}

# a tiny BLOOM with 12 heads (slopes that interpolate) and a tiny GPT-NeoX
# (parallel residual, rotary_pct 0.25, exact GeLU); config.json alone
TINY_HF = {
    "bloom": {"model_type": "bloom", "hidden_size": 96, "n_layer": 2,
              "n_head": 12, "vocab_size": 256, "seq_length": 128},
    "gpt_neox": {"model_type": "gpt_neox", "hidden_size": 64,
                 "intermediate_size": 128, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "vocab_size": 256,
                 "max_position_embeddings": 128, "rotary_pct": 0.25,
                 "use_parallel_residual": True, "hidden_act": "gelu"}}


def _configs(tmp_path, arch, **over):
    path = tmp_path / arch
    path.mkdir()
    (path / "config.json").write_text(json.dumps(TINY_HF[arch]))
    tcfg, jcfg = tct.config_from_hf(str(path)), jct.config_from_hf(str(path))
    for cfg in (tcfg, jcfg):
        for k, v in over.items():
            setattr(cfg, k, v)
    return tcfg, jcfg


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


@pytest.mark.parametrize("arch,remat", [("bloom", False), ("bloom", True),
                                        ("gpt_neox", False), ("gpt_neox", True)])
def test_imported_family_loss_and_grads_match_jax(tmp_path, arch, remat):
    """Loss and every gradient of the training forward, without remat and
    under the ``mlp_dots`` body (which carries the parallel residual)."""
    tcfg, jcfg = _configs(tmp_path, arch, remat=remat, remat_policy="mlp_dots")
    jm = JCausalLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tok = _tokens(2, 40, 1)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(p, tok, tok))(params)
    tm = CausalLM(tcfg, device="cpu")
    tp = deepspeed_tpu_torch.models.jax_params_to_torch(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")
    for _, t in _flat(tp):
        t.requires_grad_()
    tloss = tm.apply(tp, torch.from_numpy(tok), torch.from_numpy(tok))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    jflat = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    tflat = {k: t.grad for k, t in _flat(tp)}
    assert set(jflat) == set(tflat)
    for name, g in tflat.items():
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["mlp_only", "mlp_dots", "full", "dots"])
def test_parallel_residual_remat_policies_give_the_same_grads(tmp_path, policy):
    tcfg, _ = _configs(tmp_path, "gpt_neox")
    tok = torch.from_numpy(_tokens(2, 24, 2))
    grads = []
    for remat in (False, True):
        tcfg.remat, tcfg.remat_policy = remat, policy
        tm = CausalLM(tcfg, device="cpu", seed=3)
        leaves = []

        def grad_leaf(tree):
            if isinstance(tree, dict):
                return {k: grad_leaf(v) for k, v in tree.items()}
            leaves.append(tree.detach().clone().requires_grad_())
            return leaves[-1]
        loss = tm.apply(grad_leaf(tm.params()), tok, tok)
        loss.backward()
        grads.append((loss, [t.grad for t in leaves]))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("arch", sorted(TINY_HF))
def test_imported_family_trains_like_the_jax_engine(tmp_path, arch):
    """Three train_steps (one repeated [gas, micro, S] batch) from the same
    weights on both engines, the JAX one on a one-device mesh: per-step
    loss, grad norm and lr, then the final weights."""
    tcfg, jcfg = _configs(tmp_path, arch, remat=True, remat_policy="mlp_dots")
    jm = JCausalLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    mesh = build_mesh(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                        config=DS_CONFIG, mesh=mesh)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalLM(tcfg, device="cpu"),
        model_parameters=jax.tree.map(np.asarray, params), config=DS_CONFIG,
        device="cpu")
    tok = _tokens(4, 48, 10).reshape(2, 2, 48)
    rec = {"j": [], "t": []}
    for _ in range(3):
        for key, eng in (("j", jeng), ("t", teng)):
            loss = eng.train_step((tok, tok))
            rec[key].append((float(loss), eng.get_global_grad_norm(),
                             eng.get_lr()[0]))
    for (jl, jn, jlr), (tl, tn, tlr) in zip(rec["j"], rec["t"]):
        assert tl == pytest.approx(jl, rel=1e-5)
        assert tn == pytest.approx(jn, rel=1e-5)
        assert tlr == pytest.approx(jlr, rel=1e-7)
    assert rec["t"][2][0] < rec["t"][0][0]
    jflat = dict(_flat(jax.tree.map(np.asarray, jeng.state.params)))
    tflat = dict(_flat(torch_params_to_numpy(teng.params())))
    assert set(jflat) == set(tflat)
    for name in jflat:
        np.testing.assert_allclose(tflat[name], jflat[name], atol=1e-4, rtol=0,
                                   err_msg=name)
