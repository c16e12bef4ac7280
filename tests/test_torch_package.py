"""Package rules of the port: no JAX, and the GPU is the default device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu", "flax",
                                  "optax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "def jaxish():\n"
            "    return {m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')}\n"
            "before = jaxish()\n"
            "import deepspeed_tpu_torch, deepspeed_tpu_torch.serving\n"
            "import deepspeed_tpu_torch.models.convert\n"
            "import deepspeed_tpu_torch.runtime.engine\n"
            "print(sorted(jaxish() - before))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"dtype": "float32", "use_fused_decode": False}
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1)
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_serving(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    serve = deepspeed_tpu_torch.init_serving(model, cfg, device="cpu")
    assert serve.device == torch.device("cpu")
    assert serve.engine._params["embed"]["tok"].device.type == "cpu"


@pytest.mark.parametrize("over", [
    {"paged_kv_cache": False}, {"quantize_kv_cache": True},
    {"kv_host_tier_pages": 4}, {"dtype": "int8"},
    {"tensor_parallel": {"tp_size": 2}}])
def test_unported_options_are_refused(over):
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    cfg = {"dtype": "float32", "use_fused_decode": False, **over}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_serving(model, cfg, device="cpu")


@pytest.mark.parametrize("over,fused", [
    ({}, True), ({"use_fused_decode": None}, True),
    ({"use_fused_decode": True}, True), ({"use_fused_decode": False}, False),
    ({"use_fused_decode": False, "replace_with_kernel_inject": True}, False)])
def test_fused_decode_is_the_default(over, fused):
    """The JAX policy: the kernel-injected view is built unless the config
    opts out with use_fused_decode=False (which wins over
    replace_with_kernel_inject), and set_params rebuilds it."""
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    serve = deepspeed_tpu_torch.init_serving(model, {"dtype": "float32",
                                                     **over}, device="cpu")
    assert (serve.engine._dparams is not None) is fused
    if fused:
        old = serve.engine._dparams
        serve.set_params(model.params())
        assert serve.engine._dparams is not None
        assert serve.engine._dparams is not old


def test_unported_decode_variants_are_refused():
    """What the fused path does not carry yet raises naming the ROADMAP:
    int8 weights in each GEMV kernel, and flash_decode over a contiguous
    cache (no page table)."""
    from deepspeed_tpu_torch.ops.kernels import decode as tdec

    x = torch.zeros(2, 16)
    w = torch.zeros(16, 16)
    s = torch.ones(16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.fused_norm_qkv(x, s, None, w, wscale=s)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.fused_proj_norm(x, x, w, None, s, wscale=s)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.fused_mlp(x, x, w, w, wscales=(s, s, s))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.flash_decode(torch.zeros(2, 4, 8), torch.zeros(2, 2, 64, 8),
                          torch.zeros(2, 2, 64, 8), torch.tensor([1, 2]))


def test_kernel_input_checks_raise():
    """The kernel wrappers check what they are given before any build: a
    non-contiguous input or a mismatched gamma raises, it is never copied
    or cast behind the caller's back."""
    from deepspeed_tpu_torch.ops.kernels.common import check_kernel_input

    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_input("x", x.t(), x.device)
    with pytest.raises(TypeError):
        check_kernel_input("x", x.to(torch.int32), x.device)
    with pytest.raises(TypeError):
        check_kernel_input("g", x, x.device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        check_kernel_input("x", x, torch.device("meta"))


def test_initialize_without_a_card_raises(monkeypatch):
    import deepspeed_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=model, config={})
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={},
                                                device="cpu")
    assert engine.device == torch.device("cpu")


@pytest.mark.parametrize("section", [
    {"zero_optimization": {"stage": 1}}, {"zero_optimization": {"stage": 3}},
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"fp16": {"enabled": True}}, {"comm_quantization": {"all_gather": True}},
    {"pipeline": {"stages": 2}}, {"mesh": {"tp": 2}},
    {"tensor_parallel": {"tp_size": 2}}, {"tensorboard": {"enabled": True}},
    {"flops_profiler": {"enabled": True}}, {"watchdog": {"enabled": True}},
    {"activation_checkpointing": {"cpu_checkpointing": True}},
    {"optimizer": {"type": "Lion", "params": {}}},
    {"optimizer": {"type": "Muon", "params": {}}},
    {"optimizer": {"type": "OneBitAdam", "params": {}}}])
def test_unported_training_config_sections_are_refused(section):
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(model=model, config=section,
                                       device="cpu")


@pytest.mark.parametrize("over", [
    {"dropout": 0.1}, {"num_experts": 4}, {"parallel_residual": True},
    {"position": "alibi"},
    {"remat": True, "remat_policy": "offload_dots"}])
def test_unported_training_model_options_are_refused(over):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.config import get_model_config
    from deepspeed_tpu_torch.models.transformer import CausalLM

    cfg = get_model_config("llama-tiny", num_layers=1)
    model = CausalLM(cfg, device="cpu")      # a dense llama's parameters
    for k, v in over.items():
        setattr(model.config, k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(model=model, config={}, device="cpu")
