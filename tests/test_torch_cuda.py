"""The port's kernels against their plain versions, on the CUDA card.

Marked ``cuda``: they skip where there is no card (the skip is decided
inside the ``cuda_device`` fixture, so every worker collects the same
tests).  Run them on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: fp32 rtol/atol 1e-5 (same formula, a different reduction
order); bf16 rtol/atol 2e-2 (one bf16 rounding of each output).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import layer_norm as tln
from deepspeed_tpu_torch.ops.kernels import rope as trope

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, dtype, dev, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(a) * scale).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (64, 4096), (3, 5, 4096),
                                   (7, 100)])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype, shape):
    """Path shapes (decode rows = num_slots, prefill rows = chunk) plus an
    odd row length that takes the element-by-element path."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0)
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    before = tln.rms_norm.launches
    got = tln.rms_norm(x, g, eps=1e-5)
    torch.cuda.synchronize()
    assert tln.rms_norm.launches == before + 1
    want = tln.rms_norm_plain(x, g, eps=1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_rms_norm_kernel_refuses_bad_inputs(cuda_device):
    x = torch.ones(4, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tln.rms_norm(x.t(), torch.ones(4, device=cuda_device))
    with pytest.raises(TypeError):
        tln.rms_norm(x, torch.ones(64, device=cuda_device,
                                   dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tln.rms_norm(x, torch.ones(32, device=cuda_device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 64, 128), (1, 8, 64, 128),
                                   (1, 32, 17, 128), (2, 3, 5, 48)])
def test_rope_kernel_matches_plain(cuda_device, dtype, shape):
    S, D = shape[-2], shape[-1]
    x = _randn(shape, 2, dtype, cuda_device)
    pos = torch.arange(100, 100 + S, device=cuda_device)
    cos, sin = trope.rope_angles(pos, D, theta=500000.0)
    cos, sin = cos.to(dtype), sin.to(dtype)
    before = trope.apply_rotary_pos_emb.launches
    got = trope.apply_rotary_pos_emb(x, cos, sin)
    torch.cuda.synchronize()
    assert trope.apply_rotary_pos_emb.launches == before + 1
    want = trope.rope_plain(x, cos, sin)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_rope_kernel_refuses_bad_inputs(cuda_device):
    x = torch.ones(1, 2, 4, 8, device=cuda_device)
    cos = torch.ones(4, 4, device=cuda_device)
    with pytest.raises(ValueError):
        trope.apply_rotary_pos_emb(x.transpose(1, 2), cos, cos)
    with pytest.raises(ValueError):
        trope.apply_rotary_pos_emb(x, cos[:3], cos[:3])


def test_serving_on_card_matches_cpu(cuda_device):
    """A small fp32 model served on the card (kernels) and on the CPU
    (plain versions): token-identical greedy outputs."""
    import deepspeed_tpu_torch

    over = dict(num_layers=2, hidden_size=128, intermediate_size=256,
                num_heads=4, num_kv_heads=2, vocab_size=512)
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **over)
    with torch.no_grad():
        model.embed.tok.mul_(40.0)       # spread the logits away from ties
    cfg = {"dtype": "float32", "use_fused_decode": False,
           "max_out_tokens": 64, "kv_page_tokens": 16}
    prompts = [np.random.default_rng(i).integers(0, 512, n)
               for i, n in enumerate((23, 9, 40))]
    outs = []
    for dev in ("cpu", cuda_device):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=dev,
                                                 num_slots=2,
                                                 prefill_chunk=16)
        reqs = [serve.submit(p, max_new_tokens=12) for p in prompts]
        serve.run()
        serve.pool.check_no_leak()
        outs.append([r.output_tokens for r in reqs])
    assert outs[0] == outs[1]
