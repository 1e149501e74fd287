"""Fused pruned-ADC QAT first layer: the kernel wrappers and the autograd Function.

``fused_qat_first_layer`` replaces the unfused pair

    h = adc.quantize_pruned_ste(x, mask, n_bits)   # comparator bank, STE
    h @ w + b                                       # first-layer matmul

inside ``core.qat.mlp_forward``, for a whole population at once.  The
po2 weight quantizer stays outside (its own STE chains through the ``w``
gradient returned here), so callers pass the already-quantized weight.

Kernels (``csrc/fused_qat.cu``, CUDA C++ for ``sm_90a``; see the note at
the top of that file for what bounds them and how the design answers):

* ``fused_forward``  -- K2, replaces ``_fwd_kernel`` of
  ``src/repro/kernels/fused_qat/fused_qat.py``; a block per (tile of
  samples, row), a thread an element in its comparator stage and an output
  in its matmul stage, planned from shapes alone by ``forward_plan`` so
  that the CPU tests can check the plan;
* ``fused_backward`` -- K3, replaces ``_bwd_kernel`` there; the dequantized
  activations are recomputed from ``x``, never saved.  One launch a call,
  dw summed in a fixed tree over samples that
  ``ref.fused_backward_emulation`` repeats on the CPU.
* ``qat_step`` -- one training step of a population, K2 and K3 unchanged
  and three kernels around them (``qat_step_prep``, ``qat_step_head``,
  ``qat_step_update``), five launches in all, planned by ``prep_plan``,
  ``head_plan`` and ``update_plan``, on the buffers of ``StepBuffers``.
  They replace no TPU kernel: they replace the chain of plain ops the
  trainer runs around K2/K3 (``core.trainer``: the po2 quantizer, the
  hidden layers, the cross-entropy, autograd's backward and the momentum
  update), with the same bits; ``ref.qat_step`` writes them out in plain
  ops.

Device rule: a tensor on the CPU takes the plain PyTorch version in
``ref``; a tensor on CUDA launches the kernel or raises.  There is no
fallback between the two.  ``LAUNCHES`` counts kernel launches, one per
wrapper call that launches, so a run can show its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.core.sums import fixed_sum
from repro_torch.kernels import _build
from repro_torch.kernels.fused_qat import ref
from repro_torch.kernels.pruned_quant.ref import make_tables

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "ForwardPlan",
    "forward_plan",
    "fused_forward",
    "fused_backward",
    "FusedQAT",
    "fused_qat_first_layer",
    "PrepPlan",
    "prep_plan",
    "HeadPlan",
    "head_plan",
    "UpdatePlan",
    "update_plan",
    "StepBuffers",
    "qat_step",
]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_qat.cu"]
MAX_SHARED_BYTES = 48 * 1024  # default dynamic shared memory of one forward block
MAX_THREADS = 1024  # threads of one forward block (csrc FWD_MAX_THREADS)
MAX_ROWS = 65535  # grid.y carries the population axis
TILE = 16  # samples a forward block, chosen by measurement on the card (PERF.md)

# the training step's kernels (csrc QS_MAX_LAYERS, QS_MAX_WIDTH): layers of
# the MLP, units of a hidden or output layer (the head's per-thread sums)
MAX_LAYERS = 4
MAX_WIDTH = 32
STEP_THREADS = 256  # threads of a prep or update block
HEAD_THREADS = 768  # threads of a head block (csrc QS_HEAD_THREADS): a warp a batch sum
RED_COLS = 32  # batch sums a pass of the head's shared-memory tree takes (B not 32 * 2^k)
WARP_TREE_MAX_B = 32 * 32  # the largest batch of the head's warp tree (csrc lane_tree<32>)
# (hidden units, classes) of the one-hidden-layer MLPs whose head instance has
# its widths known at compile time (csrc qat_step_head): the six datasets'
HEAD_WIDTHS = ((5, 3), (3, 3), (3, 2))

LAUNCHES = {"fused_qat_forward": 0, "fused_qat_backward": 0, "qat_step_prep": 0,
            "qat_step_head": 0, "qat_step_update": 0}

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Net(ctypes.Structure):
    """csrc ``QatNet``: the layer sizes and, a layer each, the pointers of the
    weight, bias, their velocities, the quantized weight and the gradients."""

    _fields_ = [("n_layers", _int), ("sizes", _int * (MAX_LAYERS + 1))] + [
        (name, _vp * MAX_LAYERS) for name in ("w", "b", "vw", "vb", "wq", "gw", "gb")]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, loaded once per process (hashing sources is not free)."""
    lib = _build.load_library("fused_qat", SOURCES)
    lib.fused_qat_forward.argtypes = [_vp] * 6 + [_int] * 5 + [_float] + [_int] * 4 + [_vp]
    lib.fused_qat_forward.restype = _int
    lib.fused_qat_backward.argtypes = [_vp] * 7 + [_int] * 5 + [_float, _vp]
    lib.fused_qat_backward.restype = _int
    net = ctypes.POINTER(_Net)
    lib.qat_step_prep.argtypes = ([_vp, _vp, _int, _int, _int, _vp, _vp, net, _vp, _vp]
                                  + [_int] * 5 + [_vp])
    lib.qat_step_prep.restype = _int
    lib.qat_step_head.argtypes = [_vp] * 5 + [net, _vp] + [_int] * 5 + [_vp]
    lib.qat_step_head.restype = _int
    lib.qat_step_update.argtypes = [net, _vp, _vp, _int, _int, _float] + [_int] * 3 + [_vp]
    lib.qat_step_update.restype = _int
    lib.fused_qat_error_string.argtypes = [_int]
    lib.fused_qat_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build (or find) the kernels' shared library; returns its path."""
    return Path(_lib()._name)


def _check(x, thr, ids, w, other, other_name: str, other_shape) -> tuple[int, ...]:
    """Validate the kernels' inputs; returns (P, B, C, T, F)."""
    if x.ndim != 3 or thr.ndim != 3 or ids.ndim != 3 or w.ndim != 3:
        raise ValueError("x, thr, ids and w must be (P, B, C), (P, C, T), (P, C, T), (P, C, F)")
    P, B, C = x.shape
    T, F = thr.shape[2], w.shape[2]
    want = {
        "thr": (thr, (P, C, T), torch.float32),
        "ids": (ids, (P, C, T), torch.int32),
        "w": (w, (P, C, F), torch.float32),
        other_name: (other, other_shape(P, B, F), torch.float32),
    }
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type == "cuda":
        for name, t in [("x", x), *((n, v[0]) for n, v in want.items())]:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")
        if P < 1 or B < 1 or C < 1 or F < 1:
            raise ValueError(f"empty launch: P={P} B={B} C={C} F={F}")
        if P > MAX_ROWS:
            raise ValueError(f"population {P} exceeds the kernel's grid limit {MAX_ROWS}")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return P, B, C, T, F


def _launch_check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.fused_qat_error_string(err).decode()}")


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """K2's launch: block (bx, p) covers samples [bx * tile, + tile) of row p,
    clipped to B.  In its comparator stage thread t takes element t of those
    samples' x rows, (sample t // C, channel t % C); in its matmul stage,
    output t, (sample t // F, unit t % F).  Threads past the tile's elements
    (or outputs) idle in that stage."""

    tile: int           # samples a block
    threads: int        # tile * max(C, F), rounded up to a warp
    grid_x: int         # tiles of a row; grid.y is P
    shared_bytes: int   # thr, ids (C * T each), w (C * F) and the h tile (tile * C)


def forward_plan(P: int, B: int, C: int, F: int, T: int) -> ForwardPlan:
    """The launch of a (P, B, C) -> (P, B, F) forward: TILE samples a block,
    fewer where the batch is smaller, where max(C, F) channels or units would
    need more than MAX_THREADS threads, or where the h tile would not fit in
    MAX_SHARED_BYTES beside the tables; raises ValueError where even one
    sample a block does not fit."""
    if P < 1 or B < 1 or C < 1 or F < 1:
        raise ValueError(f"empty launch: P={P} B={B} C={C} F={F}")
    width = max(C, F)
    if width > MAX_THREADS:
        raise ValueError(
            f"C={C}, F={F}: one sample a block needs {width} threads; "
            f"a block holds at most {MAX_THREADS}")
    fixed = 4 * (2 * C * T + C * F)  # the row's tables and weights
    fits = (MAX_SHARED_BYTES - fixed) // (4 * C)  # samples whose h tile fits beside them
    if fits < 1:
        raise ValueError(
            f"C={C}, T={T}, F={F}: the row's tables, weights and one sample need "
            f"{fixed + 4 * C} bytes of shared memory a block; the kernel takes at most "
            f"{MAX_SHARED_BYTES}")
    tile = min(TILE, MAX_THREADS // width, fits, B)
    return ForwardPlan(tile, -(-tile * width // 32) * 32, -(-B // tile),
                       fixed + 4 * tile * C)


def fused_forward(x, thr, ids, w, b, scale: float) -> torch.Tensor:
    """K2: (P, B, F) = (x + (level(x)*scale - x)) @ w + b, row by row."""
    P, B, C, T, F = _check(x, thr, ids, w, b, "b", lambda P, B, F: (P, F))
    if x.device.type == "cpu":
        return ref.fused_forward_tables(x, thr, ids, w, b, scale)
    plan = forward_plan(P, B, C, F, T)
    lib = _lib()
    out = torch.empty((P, B, F), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_qat_forward(
            x.data_ptr(), thr.data_ptr(), ids.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), P, B, C, T, F, float(scale), plan.tile, plan.threads,
            plan.grid_x, plan.shared_bytes, stream,
        )
    _launch_check(lib, err, "fused_qat_forward")
    LAUNCHES["fused_qat_forward"] += 1
    return out


def fused_backward(x, thr, ids, w, g, scale: float, need_dx: bool = True):
    """K3: (dx (P, B, C) or None, dw (P, C, F)) from the output gradient g."""
    P, B, C, T, F = _check(x, thr, ids, w, g, "g", lambda P, B, F: (P, B, F))
    if x.device.type == "cpu":
        return ref.fused_backward_tables(x, thr, ids, w, g, scale, need_dx)
    lib = _lib()
    dev = x.device
    dx = torch.empty((P, B, C), dtype=torch.float32, device=dev) if need_dx else None
    dw = torch.empty((P, C, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_qat_backward(
            x.data_ptr(), thr.data_ptr(), ids.data_ptr(), w.data_ptr(), g.data_ptr(),
            dx.data_ptr() if need_dx else None, dw.data_ptr(),
            P, B, C, T, F, float(scale), stream,
        )
    _launch_check(lib, err, "fused_qat_backward")
    LAUNCHES["fused_qat_backward"] += 1
    return dx, dw


class FusedQAT(torch.autograd.Function):
    """K2 forward, K3 backward; the STE makes the quantizer's gradient the identity.

    The tables are searched by the GA, not trained: no gradient for them.
    ``db`` is the batch sum of ``g`` in the fixed order of ``fixed_sum``.
    """

    @staticmethod
    def forward(ctx, x, thr, ids, w, b, scale):
        ctx.save_for_backward(x, thr, ids, w)
        ctx.scale = scale
        return fused_forward(x, thr, ids, w, b, scale)

    @staticmethod
    def backward(ctx, g):
        x, thr, ids, w = ctx.saved_tensors
        g = g.contiguous()
        dx, dw = fused_backward(x, thr, ids, w, g, ctx.scale, need_dx=ctx.needs_input_grad[0])
        db = fixed_sum(g, 1) if ctx.needs_input_grad[4] else None
        return dx, None, None, dw, db, None


def fused_qat_first_layer(x, mask, w, b, n_bits: int = 4, vref: float = 1.0,
                          tables=None) -> torch.Tensor:
    """Fused pruned-ADC quantize + first-layer QAT matmul, STE gradient.

    Args:
      x:    (P, B, C) analog inputs in [0, vref).
      mask: (P, C, 2^N) boolean keep-masks (level 0 is never a comparator).
      w:    (P, C, F) first-layer weights, already po2-quantized.
      b:    (P, F) bias.
      tables: ``make_tables(mask, n_bits, vref)`` where the caller keeps them
        (then ``mask`` is not read).
    Returns: (P, B, F) float32 pre-activations.
    """
    thr, ids = make_tables(mask, n_bits, vref) if tables is None else tables
    return FusedQAT.apply(
        x.contiguous(), thr, ids, w.contiguous(), b.contiguous(), vref / (1 << n_bits)
    )


# ---------------------------------------------------------------------------
# the training step: K2 and K3 with three kernels around them
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class StepBuffers:
    """What a training step of a population reads and writes, every tensor
    (P, ...) on one device.

    ``params``, ``vel``: the MLP's weights ``w{i}`` (P, sizes[i], sizes[i+1])
    and biases ``b{i}`` (P, sizes[i+1]), and their momentum velocities, both
    updated in place; ``thr``, ``ids``: the masks' comparator tables (P, C,
    2^N - 1) (``pruned_quant.ref.make_tables``); ``wb``, ``ab``: each row's
    weight and activation widths (P,); ``w``: the loss weights (P, B);
    ``denom``: their sum, at least 1 (P,); ``idx``: a block's minibatch
    indices (P, S, B) int64; ``lr``, ``gate``: its learning rates and update
    gates (P, S).  Step j reads column j of the block.
    """

    params: dict[str, torch.Tensor]
    vel: dict[str, torch.Tensor]
    thr: torch.Tensor
    ids: torch.Tensor
    wb: torch.Tensor
    ab: torch.Tensor
    w: torch.Tensor
    denom: torch.Tensor
    idx: torch.Tensor
    lr: torch.Tensor
    gate: torch.Tensor


def _check_sizes(P: int, sizes) -> tuple[int, ...]:
    sizes = tuple(int(n) for n in sizes)
    if len(sizes) < 2 or min(sizes) < 1 or P < 1:
        raise ValueError(f"empty step: P={P}, layer sizes {sizes}")
    if len(sizes) - 1 > MAX_LAYERS:
        raise ValueError(f"{len(sizes) - 1} layers; the step's kernels take at most {MAX_LAYERS}")
    if P > MAX_ROWS:
        raise ValueError(f"population {P} exceeds the kernels' grid limit {MAX_ROWS}")
    return sizes


@dataclasses.dataclass(frozen=True)
class PrepPlan:
    """``qat_step_prep``'s launch: block (bx, p) takes elements [bx * threads,
    + threads) of row p, the B x C gathered inputs (and the B labels), then
    every weight."""

    threads: int
    grid_x: int


def prep_plan(P: int, B: int, sizes) -> PrepPlan:
    """Raises ValueError where the step's kernels cannot take the MLP."""
    sizes = _check_sizes(P, sizes)
    n = B * sizes[0] + sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return PrepPlan(STEP_THREADS, -(-n // STEP_THREADS))


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """``qat_step_head``'s launch: one block of ``threads`` a row, holding the
    row's layers after the first (weights and biases, pre-activations,
    activations, gradients), each sample's label and loss-term gradient, and
    for a batch that is not 32 * 2^k the (B, red_cols) table of its batch
    sums, in ``shared_bytes`` of shared memory."""

    threads: int
    red_cols: int       # 0: a warp a batch sum; else the sums a pass of the table takes
    shared_bytes: int


def head_plan(P: int, B: int, sizes) -> HeadPlan:
    """Raises ValueError where a row does not fit one block: a layer wider
    than MAX_WIDTH, or more shared memory than MAX_SHARED_BYTES."""
    sizes = _check_sizes(P, sizes)
    if B < 1:
        raise ValueError(f"empty batch: B={B}")
    width = max(sizes[1:])
    if width > MAX_WIDTH:
        raise ValueError(f"layer sizes {sizes}: a hidden or output layer of {width} units; "
                         f"the head takes at most {MAX_WIDTH}")
    rest = sum(a * b + b for a, b in zip(sizes[1:-1], sizes[2:]))
    warp_tree = 32 <= B <= WARP_TREE_MAX_B and B & (B - 1) == 0
    red_cols = 0 if warp_tree else min(RED_COLS, rest + sizes[1])
    floats = rest + B * (2 * sum(sizes[1:-1]) + sum(sizes[1:]) + 2 + red_cols)
    if 4 * floats > MAX_SHARED_BYTES:
        raise ValueError(f"layer sizes {sizes}, B={B}: a row needs {4 * floats} bytes of "
                         f"shared memory; one block takes at most {MAX_SHARED_BYTES}")
    return HeadPlan(HEAD_THREADS, red_cols, 4 * floats)


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """``qat_step_update``'s launch: block (bx, p) updates elements [bx *
    threads, + threads) of row p's parameters, weight then bias a layer."""

    threads: int
    grid_x: int


def update_plan(P: int, sizes) -> UpdatePlan:
    """Raises ValueError where the step's kernels cannot take the MLP."""
    sizes = _check_sizes(P, sizes)
    n = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    return UpdatePlan(STEP_THREADS, -(-n // STEP_THREADS))


def _net(sizes, params, vel, wq, gw, gb) -> _Net:
    net = _Net(n_layers=len(sizes) - 1)
    for i, n in enumerate(sizes):
        net.sizes[i] = n
    for i in range(len(sizes) - 1):
        net.w[i], net.b[i] = params[f"w{i}"].data_ptr(), params[f"b{i}"].data_ptr()
        net.vw[i], net.vb[i] = vel[f"w{i}"].data_ptr(), vel[f"b{i}"].data_ptr()
        net.wq[i], net.gb[i] = wq[i].data_ptr(), gb[i].data_ptr()
        if gw[i] is not None:
            net.gw[i] = gw[i].data_ptr()
    return net


def qat_step(X_tr, y_tr, buf: StepBuffers, j: int, momentum: float) -> None:
    """Training step ``j`` of every row of ``buf``, in place.

    ``X_tr`` (N, C) float32 and ``y_tr`` (N,) int64 are the training split
    that ``buf.idx`` points into.  A CPU tensor takes ``ref.qat_step``; on
    CUDA qat_step_prep, K2, qat_step_head, K3 and qat_step_update launch,
    or it raises.
    """
    if X_tr.device.type == "cpu":
        return ref.qat_step(X_tr, y_tr, buf, j, momentum)
    if X_tr.device.type != "cuda":
        raise ValueError(f"unsupported device {X_tr.device}")
    sizes = ref.layer_sizes(buf.params)
    P, S, B = buf.idx.shape
    N, C = X_tr.shape
    if C != sizes[0] or X_tr.dtype != torch.float32 or y_tr.dtype != torch.int64:
        raise ValueError(f"X_tr {tuple(X_tr.shape)} {X_tr.dtype}, y_tr {y_tr.dtype}: expected "
                         f"(N, {sizes[0]}) float32 and int64 labels")
    if buf.idx.dtype != torch.int64 or not 0 <= j < S:
        raise ValueError(f"step {j} of a block of {S}, idx {buf.idx.dtype}")
    prep, head, upd = prep_plan(P, B, sizes), head_plan(P, B, sizes), update_plan(P, sizes)
    dev = X_tr.device
    f32 = dict(dtype=torch.float32, device=dev)
    pairs = list(zip(sizes[:-1], sizes[1:]))
    xg = torch.empty((P, B, C), **f32)
    yg = torch.empty((P, B), dtype=torch.int32, device=dev)
    wq = [torch.empty((P, a, b), **f32) for a, b in pairs]
    gw = [None] + [torch.empty((P, a, b), **f32) for a, b in pairs[1:]]
    gb = [torch.empty((P, b), **f32) for _, b in pairs]
    g0 = torch.empty((P, B, sizes[1]), **f32)
    net = _net(sizes, buf.params, buf.vel, wq, gw, gb)
    scale = 1.0 / (buf.thr.shape[-1] + 1)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qat_step_prep(X_tr.data_ptr(), buf.idx.data_ptr(), S, j, N, y_tr.data_ptr(),
                                buf.wb.data_ptr(), ctypes.byref(net), xg.data_ptr(),
                                yg.data_ptr(), P, B, C, prep.threads, prep.grid_x, stream)
        _launch_check(lib, err, "qat_step_prep")
        LAUNCHES["qat_step_prep"] += 1
        z1 = fused_forward(xg, buf.thr, buf.ids, wq[0], buf.params["b0"], scale)
        err = lib.qat_step_head(z1.data_ptr(), yg.data_ptr(), buf.w.data_ptr(),
                                buf.denom.data_ptr(), buf.ab.data_ptr(), ctypes.byref(net),
                                g0.data_ptr(), P, B, head.red_cols, head.threads,
                                head.shared_bytes, stream)
        _launch_check(lib, err, "qat_step_head")
        LAUNCHES["qat_step_head"] += 1
        _, dw0 = fused_backward(xg, buf.thr, buf.ids, wq[0], g0, scale, need_dx=False)
        net.gw[0] = dw0.data_ptr()
        err = lib.qat_step_update(ctypes.byref(net), buf.lr.data_ptr(), buf.gate.data_ptr(), S,
                                  j, float(momentum), P, upd.threads, upd.grid_x, stream)
        _launch_check(lib, err, "qat_step_update")
        LAUNCHES["qat_step_update"] += 1
