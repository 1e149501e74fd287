"""Plain PyTorch RMSNorm and a CPU emulation of the kernel's order of summation.

``rms_norm_ref`` is the formula of ``models.layers.rms_norm``, written out
here so that the kernel package imports no model code, plus ``residual +``
for the post-norm form.  ``rms_norm_emulation`` repeats what
``csrc/rms_norm.cu`` does on a plan of ``ops.launch_plan``: each thread's
squares summed in its order, the butterfly over the row's lanes, the warps
in warp order, then ``* fl(1/d)`` (``torch.mean``'s factor on the card);
the rounding points after the sum are the chain's.
"""

from __future__ import annotations

import torch

__all__ = ["rms_norm_ref", "rms_norm_emulation"]


def _epilogue(x, var, scale, eps, residual):
    """The chain after the fp32 variance: the rounding points of ``layers.rms_norm``."""
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = x * inv * scale
    return y if residual is None else residual + y


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """Variance in fp32, the normalise in x's dtype; ``residual +`` it where given."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return _epilogue(x, var, scale, eps, residual)


def rms_norm_emulation(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                       residual: torch.Tensor | None = None) -> torch.Tensor:
    """``rms_norm_ref`` with the kernel's fp32 sum, on the threads and vectors
    that ``ops.launch_plan`` gives x's rows and width."""
    from repro_torch.kernels.rms_norm import ops

    d = x.shape[-1]
    rows = x.reshape(-1, d)
    per_vec = ops.VECTOR_BYTES // x.element_size()
    plan = ops.launch_plan(rows.shape[0], d, x.element_size())
    sq = rows.to(torch.float32).square().reshape(-1, plan.nvec, per_vec)
    tpr = plan.tpr
    part = torch.zeros(rows.shape[0], tpr, dtype=torch.float32, device=x.device)
    lanes = torch.arange(tpr, device=x.device)
    for j in range(plan.vpt):
        i = lanes + j * tpr
        live = i < plan.nvec
        vec = sq[:, i.clamp(max=plan.nvec - 1)]  # (rows, tpr, per_vec)
        for k in range(per_vec):
            part = torch.where(live, part + vec[:, :, k], part)
    o = min(tpr, 32) // 2
    while o:
        part = part + part[:, lanes ^ o]
        o //= 2
    total = part[:, 0]
    for w in range(1, tpr // 32):
        total = total + part[:, 32 * w]
    var = total * (torch.tensor(1.0) / torch.tensor(float(d))).to(x.device)  # fp32 1.0f / d
    return _epilogue(x, var.reshape(*x.shape[:-1], 1), scale, eps, residual)

