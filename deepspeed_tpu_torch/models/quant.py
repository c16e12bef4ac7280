"""Quantized weight tensors for serving, PyTorch port.

Counterpart of ``deepspeed_tpu/models/quant.py``: a weight is stored as
int8 codes with a per-output-column fp32 scale, and ``QTensor.astype``
dequantizes, so model code written as ``h @ w`` (``w[li]`` for a stacked
layer leaf) takes quantized or dense weights unchanged.  The decode path
never dequantizes a whole weight: the fused kernels read the codes and the
scales (``ops/kernels/decode.py``, ``wscale``/``wscales``).  Device memory:
one byte a weight plus four a column; a decode step is bound by its weight
bytes, so int8 is a throughput lever as well as a memory one.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

# XLA folds the JAX quantizer's ``absmax / 127.0`` into a product with the
# fp32 reciprocal (the engine quantizes under jit); the port computes the
# same product, so both packages give the same scales.
_INV_QMAX = 1.0 / 127.0


class QTensor:
    """int8 payload ``q`` and a broadcastable fp32 ``scale`` ([..., 1, N]
    for a [..., K, N] weight).  Quacks like a tensor for what model code
    touches: ``.shape``, ``.dtype``, ``.numel()``, indexing of the leading
    (layer) dims, ``.astype`` and ``@`` from either side."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return torch.int8

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def numel(self) -> int:
        return self.q.numel()

    def astype(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize: the fp32 product of code and scale, cast to ``dtype``."""
        return (self.q.float() * self.scale).to(dtype)

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading dims (the layer of a stacked leaf); the last two
        stay whole."""
        return QTensor(self.q[idx], self.scale[idx])

    def __matmul__(self, other):
        return self.astype(other.dtype) @ other

    def __rmatmul__(self, other):
        return other @ self.astype(other.dtype)

    def __repr__(self) -> str:
        return f"QTensor(int8{tuple(self.q.shape)}, scale{tuple(self.scale.shape)})"


def is_qtensor(x: Any) -> bool:
    return isinstance(x, QTensor)


def quantize_weight(w: torch.Tensor, axis: int = -2,
                    place: Optional[Callable] = None) -> QTensor:
    """Symmetric per-output-column int8: absmax over the contraction axis
    (default -2, the d_in of a [..., d_in, d_out] matmul weight), scale 1
    where a column is all zero, codes rounded half to even and clipped to
    ±127.  ``place`` maps each slice to the tensor that is quantized (the
    serving engine's move to its device and dtype), so the codes land
    where it puts them.  A stacked leaf is quantized one leading index at a
    time into codes and scales allocated once: the placed copy and the fp32
    temporaries stay one layer's size."""
    if w.dim() >= 3 and axis in (-2, w.dim() - 2):
        q = scale = None
        for i in range(w.shape[0]):
            part = quantize_weight(w[i], axis=-2, place=place)
            if q is None:
                q = part.q.new_empty((w.shape[0],) + tuple(part.q.shape))
                scale = part.scale.new_empty((w.shape[0],)
                                             + tuple(part.scale.shape))
            q[i], scale[i] = part.q, part.scale
            del part
        return QTensor(q, scale)
    if place is not None:
        w = place(w)
    w32 = w.float()
    absmax = torch.amax(w32.abs(), dim=axis, keepdim=True)
    inv = torch.tensor(_INV_QMAX, dtype=torch.float32, device=w.device)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax * inv)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def quantize_layer_params(params: Any, cfg=None,
                          place: Optional[Callable] = None) -> Any:
    """Quantize the transformer-layer matmul weights of a parameter tree:
    leaves of 3 or more dims under ``layers`` (stacked [L, d_in, d_out]
    weights; the 2-d leaves there are stacked vectors) and ``lm_head``.
    Embeddings, norms and biases stay dense, and so does an MoE model's
    MLP.  A leaf that is already a :class:`QTensor` is kept as it is.
    ``place`` is :func:`quantize_weight`'s, applied slice by slice to the
    quantized leaves only; the others are returned untouched."""
    out = dict(params)
    skip_mlp = bool(getattr(cfg, "is_moe", False))

    def walk(tree, in_mlp):
        if isinstance(tree, dict):
            return {k: walk(v, in_mlp or k == "mlp") for k, v in tree.items()}
        if is_qtensor(tree) or (skip_mlp and in_mlp) or tree.dim() < 3:
            return tree
        return quantize_weight(tree, place=place)

    if "layers" in out:
        out["layers"] = walk(out["layers"], False)
    head = out.get("lm_head")
    if head is not None and not is_qtensor(head) and head.dim() >= 2:
        out["lm_head"] = quantize_weight(head, place=place)
    return out


def dequantize_tree(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """QTensor leaves -> dense tensors of ``dtype`` (for paths that need
    plain parameters)."""
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    return params.astype(dtype) if is_qtensor(params) else params
