"""What "the norm kernel agrees with ``layers.rms_norm``" means, for the CPU
emulation of its order of summation and for the kernel on the card.

The kernel keeps every rounding point of the plain chain; only its fp32 sum
of squares runs in another order.  So in bf16 a row is either bit-equal to
the chain, or its ``inv = bf16(rsqrt(var + eps))`` lies one bf16 ulp off
(the two sums straddle a rounding boundary of ``inv``), and then the row
equals the chain run with that neighbouring ``inv``, bit for bit.  One ulp
of ``inv`` is up to 2^-7 of it, so ``x * inv`` moves up to 2 ulps, and its
two roundings (``x * inv``, ``* scale``) up to one more: each element lies
within 3 bf16 ulps.  Such rows are rare: at least 99.9% of rows must be
bit-equal.  In fp32 every element lies within 2e-6 of the larger of
the norm's and the output's magnitude.
"""

import torch

from repro_torch.models import layers as L

MIN_EQUAL_ROWS = 0.999
FP32_REL = 2e-6
BF16_ULPS = 3


def _bf16_step(inv: torch.Tensor, k: int) -> torch.Tensor:
    """Positive bf16 values moved k ulps."""
    bits = inv.view(torch.int16) + k
    return bits.view(torch.bfloat16)


def _ulp_bf16(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |t| (the smallest normal's below it)."""
    a = t.abs().float().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def plain(x, scale, eps, residual=None, inv=None):
    """The chain of ``layers.rms_norm`` (+ residual), with ``inv`` given or its own."""
    if inv is None:
        return L.rms_norm(x, scale, eps) if residual is None else residual + L.rms_norm(
            x, scale, eps)
    y = x * inv * scale
    return y if residual is None else residual + y


def check_close(got, x, scale, eps, residual=None) -> dict:
    """Assert ``got`` agrees with the chain on (x, scale, eps, residual) as the
    module docstring says; returns the share of bit-equal rows and the widest
    element gap in ulps (bf16) or relative (fp32)."""
    want = plain(x, scale, eps, residual)
    d = x.shape[-1]
    g, w = got.reshape(-1, d), want.reshape(-1, d)
    y = L.rms_norm(x, scale, eps).reshape(-1, d)
    mag = torch.maximum(y.abs().float(), w.abs().float())
    gap = (g.float() - w.float()).abs()
    if x.dtype == torch.float32:
        rel = float((gap / mag.clamp(min=1e-30)).max()) if gap.numel() else 0.0
        assert bool((gap <= FP32_REL * mag).all()), f"fp32 gap {rel:.3g} of the magnitude"
        return {"equal_rows": float((g == w).all(-1).float().mean()), "max_rel": rel}
    equal = (g == w).all(-1)
    share = float(equal.float().mean())
    assert share >= MIN_EQUAL_ROWS, f"{share:.6f} of rows bit-equal"
    ulps = float((gap / _ulp_bf16(mag)).max()) if gap.numel() else 0.0
    assert ulps <= BF16_ULPS, f"an element {ulps} bf16 ulps off"
    odd = (~equal).nonzero().flatten()
    if len(odd):
        xr = x.reshape(-1, d)[odd]
        rr = residual.reshape(-1, d)[odd] if residual is not None else None
        var = xr.to(torch.float32).square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        near = [plain(xr, scale, eps, rr, _bf16_step(inv, k)) for k in (-1, 1)]
        hit = (g[odd] == near[0]).all(-1) | (g[odd] == near[1]).all(-1)
        assert bool(hit.all()), f"{int((~hit).sum())} rows differ otherwise than by inv's ulp"
    return {"equal_rows": share, "max_ulps": ulps}
