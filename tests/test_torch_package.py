"""Package rules of the port: no JAX, and the GPU is the default device."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "gemv16_probe.py",
    ROOT / "flash_decode_probe.py", ROOT / "rope_probe.py",
    ROOT / "zero_multichip_probe.py"]


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


@pytest.mark.parametrize("part", ["runtime/checkpoint_engine/atomic.py",
                                  "runtime/checkpoint_engine/sharded.py",
                                  "runtime/checkpoint_engine/checkpoint_engine.py",
                                  "checkpoint/universal.py",
                                  "utils/zero_to_fp32.py",
                                  "utils/tensor_fragment.py",
                                  "runtime/dataloader.py"])
def test_import_rule_covers_the_checkpoint_modules(part):
    """The checkpoint stack is copied in and trimmed, never imported from
    the JAX package: the import rule above walks each of its files."""
    assert ROOT / "deepspeed_tpu_torch" / part in PORT_FILES


@pytest.mark.parametrize("part", ["moe/__init__.py", "moe/sharded_moe.py",
                                  "moe/layer.py"])
def test_import_rule_covers_the_moe_modules(part):
    """The MoE package is the port's own copy: the import rule above walks
    each of its files."""
    assert ROOT / "deepspeed_tpu_torch" / part in PORT_FILES


@pytest.mark.parametrize("part", [
    "utils/prng.py", "ops/kernels/dropout.py", "ops/plain_optimizer.py",
    "ops/lion/__init__.py", "ops/adagrad/__init__.py", "ops/sgd/__init__.py",
    "ops/adam/muon.py", "runtime/activation_checkpointing/__init__.py",
    "runtime/activation_checkpointing/checkpointing.py"])
def test_import_rule_covers_the_dropout_and_optimizer_modules(part):
    """The threefry chain, the dropout wrapper, the plain optimizers and the
    activation checkpointing API are written for the port (no jax.random,
    no optax): the import rule above walks each of their files."""
    assert ROOT / "deepspeed_tpu_torch" / part in PORT_FILES


@pytest.mark.parametrize("part", [
    "ops/op_builder/native.py", "ops/adam/cpu_adam.py", "ops/aio/__init__.py",
    "comm/quant.py", "runtime/swap_tensor/optimizer_swapper.py",
    "runtime/zero/offload.py", "runtime/zero/relay.py"])
def test_import_rule_covers_the_offload_modules(part):
    """The host optimizer, its builder, the aio handle, the swapper, the
    int8 host codec and the relay are the port's own copies: the import
    rule above walks each of their files."""
    assert ROOT / "deepspeed_tpu_torch" / part in PORT_FILES


@pytest.mark.parametrize("part", ["runtime/zero/streaming.py",
                                  "runtime/zero/stream_grad.py"])
def test_import_rule_covers_the_streaming_modules(part):
    """ZeRO-Infinity's streamer and streamed forward and backward are the
    port's own: the import rule above walks each of their files."""
    assert ROOT / "deepspeed_tpu_torch" / part in PORT_FILES


@pytest.mark.parametrize("part", ["comm/comm.py", "comm/mesh.py",
                                  "runtime/zero/partition.py",
                                  "runtime/zero/partition_parameters.py"])
def test_import_rule_covers_the_zero_modules(part):
    """The collectives, the mesh, the stages' partitions and ``zero.Init`` /
    ``GatheredParameters`` are the port's own copies: the import rule above
    walks each of their files."""
    assert ROOT / "deepspeed_tpu_torch" / part in PORT_FILES


def test_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "def jaxish():\n"
            "    return {m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')}\n"
            "before = jaxish()\n"
            "import deepspeed_tpu_torch, deepspeed_tpu_torch.serving\n"
            "import deepspeed_tpu_torch.models.convert\n"
            "import deepspeed_tpu_torch.runtime.engine\n"
            "import deepspeed_tpu_torch.module_inject\n"
            "import deepspeed_tpu_torch.checkpoint\n"
            "import deepspeed_tpu_torch.runtime.checkpoint_engine\n"
            "import deepspeed_tpu_torch.runtime.dataloader\n"
            "import deepspeed_tpu_torch.utils.zero_to_fp32\n"
            "import deepspeed_tpu_torch.moe\n"
            "import deepspeed_tpu_torch.utils.prng\n"
            "import deepspeed_tpu_torch.ops.kernels.dropout\n"
            "import deepspeed_tpu_torch.ops.lion, deepspeed_tpu_torch.ops.sgd\n"
            "import deepspeed_tpu_torch.ops.adagrad, deepspeed_tpu_torch.ops.adam\n"
            "import deepspeed_tpu_torch.runtime.activation_checkpointing\n"
            "import deepspeed_tpu_torch.runtime.zero.stream_grad\n"
            "import deepspeed_tpu_torch.comm.comm, deepspeed_tpu_torch.comm.mesh\n"
            "import deepspeed_tpu_torch.runtime.zero.partition\n"
            "import deepspeed_tpu_torch.runtime.zero.partition_parameters\n"
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
    {"kv_host_tier_pages": 4}, {"checkpoint": "ckpt_dir"},
    {"tensor_parallel": {"tp_size": 2}}])
def test_unported_options_are_refused(over):
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    cfg = {"dtype": "float32", "use_fused_decode": False, **over}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_serving(model, cfg, device="cpu")


@pytest.mark.parametrize("over,paged,quant", [
    ({"paged_kv_cache": False}, False, False),
    ({"quantize_kv_cache": True}, True, True),
    ({"paged_kv_cache": False, "quantize_kv_cache": True}, False, True)])
def test_fixed_slot_and_int8_kv_options_are_served(over, paged, quant):
    """The fixed-slot layout and the int8 KV cache, once refused, are
    served: the layout and the cache's dtype follow the config, and an
    int8 cache decodes on the unfused loop."""
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    serve = deepspeed_tpu_torch.init_serving(model, {"dtype": "float32",
                                                     **over}, device="cpu")
    assert serve.paged is paged and (serve.pool is not None) is paged
    assert (serve._cache["k"].dtype == torch.int8) is quant
    assert (serve.engine._dparams is None) is quant
    req = serve.submit(np.arange(5), max_new_tokens=3)
    serve.run()
    assert req.finish_reason == "length" and len(req.output_tokens) == 3


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
    """What the fused path does not carry: int8 weights beside activations
    other than bf16 (the int8 engine serves in bf16) raise in each GEMV
    kernel, on the CPU as on the card, and the int8 KV cache raises naming
    the ROADMAP in ``decode_step``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import fused_decode as tfd
    from deepspeed_tpu_torch.ops.kernels import decode as tdec

    x = torch.zeros(2, 16)
    w = torch.zeros(16, 16, dtype=torch.int8)
    s = torch.ones(16)
    with pytest.raises(TypeError, match="bfloat16"):
        tdec.fused_norm_qkv(x, s, None, w, wscale=s)
    with pytest.raises(TypeError, match="bfloat16"):
        tdec.fused_proj_norm(x, x, w, None, s, wscale=s)
    with pytest.raises(TypeError, match="bfloat16"):
        tdec.fused_mlp(x, x, w, w, wscales=(s, s, s))
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    dparams = tfd.inject_decode_params(model.params(), model.config)
    cache = {"k": torch.zeros(1, 2, 4, 16, 32, dtype=torch.int8),
             "v": torch.zeros(1, 2, 4, 16, 32, dtype=torch.int8),
             "k_scale": torch.zeros(1, 2, 4, 16, 1),
             "v_scale": torch.zeros(1, 2, 4, 16, 1)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfd.decode_step(model.config, dparams,
                        torch.zeros(2, 1, dtype=torch.long), cache, 3)


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


_REFUSED = [
    # the comm_quantization sites that need the parallel meshes, and ZeRO++
    # beside offload_param over ranks, checked through the config at that world
    ({"comm_quantization": {"all_to_all": True}, "mesh": {"ep": 2}}, 2),
    ({"comm_quantization": {"sequence_ring": True}, "mesh": {"sp": 2}}, 2),
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True,
                            "offload_param": {"device": "cpu"}}}, 2),
    ({"zero_optimization": {"stage": 1, "offload_param": {"device": "cpu"}}}, 1),
    ({"pipeline": {"stages": 2}}, 1), ({"mesh": {"tp": 2}}, 1),
    ({"tensor_parallel": {"tp_size": 2}}, 1), ({"tensorboard": {"enabled": True}}, 1),
    ({"flops_profiler": {"enabled": True}}, 1), ({"watchdog": {"enabled": True}}, 1),
    ({"zero_optimization": {"offload_param": {"device": "cpu", "stream_grads": False}}}, 1),
    ({"optimizer": {"type": "ZeroOneAdam", "params": {}}}, 1),
    ({"optimizer": {"type": "OneBitLamb", "params": {}}}, 1),
    ({"optimizer": {"type": "OneBitAdam", "params": {}}}, 1)]


@pytest.mark.parametrize("section,world", [pytest.param(s, w, id=f"section{i}")
                                           for i, (s, w) in enumerate(_REFUSED)])
def test_unported_training_config_sections_are_refused(section, world):
    """At a world of one through ``initialize``; at a larger world through
    the config the engine parses there."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    if world > 1:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DeepSpeedConfig(section, world_size=world)
        return
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", num_layers=1,
                                          device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(model=model, config=section,
                                       device="cpu")


@pytest.mark.parametrize("over", [
    {"param_offload": True}, {"num_experts": 4, "param_offload": True},
    {"dropout": 0.1, "remat": True, "remat_policy": "offload_dots",
     "param_offload": True}])
def test_unported_training_model_options_are_refused(over):
    """``param_offload`` on a model trained through ``apply`` (the JAX
    package's whole-program path, its layer weights moved in from host
    memory inside the program; the port trains ``offload_param`` through
    the model's stream segments instead) raises naming ROADMAP.md, also
    beside dropout and ``offload_dots``, which train."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.config import get_model_config
    from deepspeed_tpu_torch.models.transformer import CausalLM

    cfg = get_model_config("llama-tiny", num_layers=1)
    model = CausalLM(cfg, device="cpu")      # a dense llama's parameters
    for k, v in over.items():
        setattr(model.config, k, v)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.*the whole-program offload_param path"):
        deepspeed_tpu_torch.initialize(model=model, config={}, device="cpu")


def _kernel_names():
    """The kernels the port defines: every ``__global__`` function in
    ``csrc/*.cu`` and every Triton kernel under ``ops/kernels``."""
    names = set()
    for cu in (ROOT / "deepspeed_tpu_torch" / "csrc").glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
            cu.read_text()))
    for py in (ROOT / "deepspeed_tpu_torch" / "ops" / "kernels").glob("*.py"):
        names.update(re.findall(r"@triton\.jit\s+def\s+(\w+)", py.read_text()))
    return names


def _profile_tags():
    """Every kernel name chip_smoke.py matches in a profile: the strings in
    the values of each ``tags`` dict and of ``FLASH_KERNELS``."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    found = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)):
            continue
        if not any(isinstance(t, ast.Name) and t.id in ("tags", "FLASH_KERNELS")
                   for t in node.targets):
            continue
        for value in node.value.values:
            items = value.elts if isinstance(value, (ast.Tuple, ast.List)) else [value]
            found.update(c.value for c in items
                         if isinstance(c, ast.Constant) and isinstance(c.value, str))
    return sorted(found)


PROFILE_TAGS = _profile_tags()


def test_chip_smoke_has_profile_tags():
    """RMSNorm's forward has three kernels (a row in registers, streaming
    rows, a block a row), read together by their common prefix."""
    assert {"flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
            "rms_norm_fwd_", "layer_norm_fwd_"} <= set(PROFILE_TAGS)


@pytest.mark.parametrize("tag", PROFILE_TAGS)
def test_profile_tags_name_kernels_that_exist(tag):
    """chip_smoke.py reads a kernel's device time by a substring of its
    name; a tag that names no kernel would read as None, silently."""
    assert any(tag in n for n in _kernel_names()), (
        f"chip_smoke.py profiles {tag!r}, which is in no kernel name of the port")
