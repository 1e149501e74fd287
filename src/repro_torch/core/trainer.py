"""Population QAT inner loop of the ADC-aware GA (port of ``repro.core.trainer``).

The reference evaluates a population as one compiled program,
``jit(vmap(scan(train_one)))``.  Here the row program is written out over a
leading population axis P and run in blocks of ``EvalConfig.block_steps``
(S) training steps:

* heterogeneous batch sizes: every step draws ``max_batch`` samples with
  replacement and weights the loss with ``i < batch_size``;
* heterogeneous epoch budgets: every row runs ``max_steps`` and a row's
  parameters freeze once its own step budget
  ``min(max(ep * ceil(n / bs) * step_scale, 1), max_steps)`` is spent
  (its momentum velocity keeps updating, as in the reference);
* precisions and learning rate enter the quantizers and the optimiser as
  per-row values, and so do the genome axes' activation selectors and
  per-layer weight widths (``EvalConfig.genome_axes``).

**Static buffers and the CUDA graph.**  A call pads P up to the next
multiple of ``pad_granule`` (the bucket) by repeating its last row, as the
reference does, and drops the padded rows' results.  Each bucket owns one
set of static buffers: parameters and momentum velocity, masks and bit
widths (and the genome axes' selectors and widths), the loss weights, and
one block's minibatch indices, learning rates and update gates, which are
copied in on the stream before each block.  A block is the same code on
every device (:func:`_train_block`).  A step of the ADC-only genome is
``kernels.fused_qat.ops.qat_step``: on the card five launches (K2, K3 and
three kernels around them), on the CPU its plain version; the genome axes
train through the chain of ``core.qat`` ops and autograd
(:func:`_chain_step`).  The masks' comparator tables are made once a call,
into the bucket's buffers.  On the card a block is captured once
per (bucket, block length) with ``torch.cuda.graph`` and replayed
``max_steps / S`` times, plus a tail
graph when S does not divide ``max_steps``; graphs are cached per
evaluator in one private memory pool.  Nothing in a block reads a value
back to the host, so a call enqueues its whole training and evaluation
without waiting: ``evaluate.dispatch`` returns a ``resolve()`` that waits
on a CUDA event, the counterpart of the reference's asynchronous dispatch.

**Threads.**  A capture runs in ``capture_error_mode="thread_local"``: a
call that cannot be captured (a host read, a synchronising copy) fails on
the capturing thread, while other threads may make any CUDA call on their
own streams meanwhile.  The evaluation service (``core.eval_service``)
needs this: its request threads fit surrogate screens on the card while
its scheduler thread captures a new bucket; the mode checks less and
captures the same launches, so no bit changes.  One thread trains an
evaluator: the launch counters below are exact only while no other thread
launches K2/K3 during a capture.

**Spans** (``repro_torch.spans``, nothing while recording is off): a call
records the draws, the staging of host tensors and copies, each new graph's
warm-up and capture, and the launches.

``graph=None`` means a graph on the card and the plain loop on the CPU;
``graph=False`` on the card is an explicit eager run (what ``chip_smoke.py``'s
placement phase and ``cardbench/tools/divergence.py`` step through);
``graph=True`` on the CPU raises.  A failed capture or replay raises and
never falls back to the eager loop.  The fused QAT layer's launch counters
(``kernels.fused_qat.ops.LAUNCHES``) count what runs: a capture adds
nothing, each replay adds the launches its graph holds, and the warm-up
steps before a capture (real launches) count as launches.

Randomness is drawn up front by :func:`draw_rows` from a CPU
``torch.Generator`` seeded from ``(cfg.seed, row seed)``, so a row's draw
does not depend on the device or on the other rows.  The row program
(:func:`make_row_program`) takes those draws as inputs, which lets the
parity tests hand it the reference's own initial weights and minibatch
indices.  A row's result is a function of its own inputs only: every
reduction inside a step is ordered by the row alone (see ``core.qat``).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import chromosome, qat
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_qat import ops as qat_ops
from repro_torch.kernels.pruned_quant.ref import make_tables
from repro_torch.parallel import sharding as shd

__all__ = [
    "EvalConfig",
    "draw_rows",
    "make_row_program",
    "make_population_evaluator",
    "make_island_evaluator",
    "device_count",
]

# the spans of an evaluator call (``repro_torch.spans``): the CPU draws; host
# tensors, schedules and copies in; warm-up and capture; the launches
SPAN_DRAW, SPAN_STAGE = "trainer.draw", "trainer.stage"
SPAN_CAPTURE, SPAN_ENQUEUE = "trainer.capture", "trainer.enqueue"

# eager steps a capture runs first on a side stream (lazy initialisation of
# the autograd engine and the allocator), as torch.cuda.graphs documents
WARMUP_STEPS = 3


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    max_batch: int = 128
    max_steps: int = 600          # step-loop length for every chromosome
    step_scale: float = 1.0       # global shrink factor of the step budgets
    momentum: float = 0.9
    seed: int = 0
    pad_granule: int = 4          # population bucket size
    # S: training steps a block (and a CUDA graph) holds.  On an H100 every
    # S from 10 to 200 gave the same step time within 2-10% and a capture
    # costs about 3 + S eager steps, so the smallest (PERF.md)
    block_steps: int = 10
    # generalized-genome gene groups (core.chromosome.AXES).  Beyond "adc",
    # each enabled axis adds one per-row array to every call, in canonical
    # order: "act" -> (n_hidden,) int activation selectors, "wprec" ->
    # (n_layers,) fp32 per-layer weight widths (0.0 = ternary).  The
    # default runs the ADC-only step: the same launches on the same buffers.
    genome_axes: tuple[str, ...] = ("adc",)


def _extra_names(cfg: EvalConfig) -> tuple[str, ...]:
    """The slots of the extra per-row arrays ``cfg.genome_axes`` adds, canonical order."""
    axes = chromosome.normalize_axes(cfg.genome_axes)
    return tuple(n for ax, n in (("act", "act_sel"), ("wprec", "wprec")) if ax in axes)


@spans.spanned(SPAN_DRAW)
def draw_rows(seeds, cfg: EvalConfig, mlp_cfg: qat.MLPConfig, n_train: int):
    """Initial parameters and minibatch indices of each row, on the CPU.

    Returns ``(params0, idx)``: ``params0`` the stacked ``init_mlp``
    dict (leading axis P) and ``idx`` an int64 (P, max_steps, max_batch)
    tensor of training-sample indices, drawn with replacement.
    """
    params, idx = [], []
    for s in np.asarray(seeds, np.int64).reshape(-1):
        gen = torch.Generator().manual_seed((int(cfg.seed) << 32) + int(s))
        params.append(qat.init_mlp(gen, mlp_cfg))
        idx.append(torch.randint(0, n_train, (cfg.max_steps, cfg.max_batch), generator=gen))
    params0 = {k: torch.cat([p[k] for p in params]) for k in params[0]}
    return params0, torch.stack(idx)


def _schedules(bs, ep, lr, n_train: int, cfg: EvalConfig):
    """Per-row (P, max_steps) learning rates and parameter-update gates, on the CPU.

    Computed row by row, in fp32 with the reference's op order, so a row's
    schedule does not depend on how many rows share the call.
    """
    t = torch.arange(cfg.max_steps, dtype=torch.float32)
    lrs, gates = [], []
    for b, e, r in zip(bs.tolist(), ep.tolist(), lr.tolist()):
        b32, e32, r32 = (torch.tensor(v, dtype=torch.float32) for v in (b, e, r))
        steps_per_epoch = torch.ceil(n_train / b32)
        budget = torch.clamp(
            torch.clamp(e32 * steps_per_epoch * cfg.step_scale, min=1.0),
            max=float(cfg.max_steps),
        )
        frac = torch.clamp(t / budget, max=1.0)
        lrs.append(r32 * 0.5 * (1.0 + torch.cos(math.pi * frac)))
        gates.append((t < budget).to(torch.float32))
    return torch.stack(lrs), torch.stack(gates)


def _host(x, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` from an array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", dtype)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(dtype)


def _pad_rows(t: torch.Tensor, bucket: int) -> torch.Tensor:
    """Repeat the last row up to ``bucket`` rows (valid rows whose results are dropped)."""
    n = t.shape[0]
    if n == bucket:
        return t
    return torch.cat([t, t[-1:].expand((bucket - n,) + tuple(t.shape[1:]))])


class _Slots(qat_ops.StepBuffers):
    """The static buffers of one bucket: a block reads and writes only these.

    A step's (``ops.StepBuffers``), the masks, and the genome axes' rows."""

    def __init__(self, n: int, mlp_cfg: qat.MLPConfig, cfg: EvalConfig, dev):
        sizes = mlp_cfg.layer_sizes
        f32 = dict(dtype=torch.float32, device=dev)
        params = {}
        for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
            params[f"w{i}"] = torch.zeros((n, fi, fo), **f32).requires_grad_(True)
            params[f"b{i}"] = torch.zeros((n, fo), **f32).requires_grad_(True)
        # the masks' comparator tables (make_tables), made once a call
        T = (1 << mlp_cfg.adc_bits) - 1
        S = min(cfg.block_steps, cfg.max_steps)
        super().__init__(
            params=params, vel={k: torch.zeros_like(v) for k, v in params.items()},
            thr=torch.zeros((n, sizes[0], T), **f32),
            ids=torch.zeros((n, sizes[0], T), dtype=torch.int32, device=dev),
            wb=torch.zeros(n, **f32), ab=torch.zeros(n, **f32),
            w=torch.zeros((n, cfg.max_batch), **f32), denom=torch.zeros(n, **f32),
            idx=torch.zeros((n, S, cfg.max_batch), dtype=torch.int64, device=dev),
            lr=torch.zeros((n, S), **f32), gate=torch.zeros((n, S), **f32))
        self.masks = torch.zeros((n, sizes[0], 1 << mlp_cfg.adc_bits), dtype=torch.bool,
                                 device=dev)
        # the genome axes' rows (None when the axis is off: the ADC-only step)
        n_layers = len(sizes) - 1
        names = _extra_names(cfg)
        # the ADC-only genome trains through the fused step (ops.qat_step)
        self.fused = not names
        self.act_sel = (torch.zeros((n, n_layers - 1), dtype=torch.int64, device=dev)
                        if "act_sel" in names else None)
        self.wprec = torch.zeros((n, n_layers), **f32) if "wprec" in names else None


def _chain_step(X_tr, y_tr, mlp_cfg: qat.MLPConfig, momentum: float, s: _Slots,
                j: int) -> None:
    """Training step ``j`` of every row as a chain of plain ops: ``mlp_forward``
    (K2/K3 on the card), ``cross_entropy``, autograd's backward, the momentum
    update.  The genome axes train through it; for the ADC-only genome it is
    what ``ops.qat_step`` fuses."""
    P = s.masks.shape[0]
    params = list(s.params.values())
    it = s.idx[:, j]
    logits = qat.mlp_forward(s.params, X_tr[it], mlp_cfg, s.masks, s.wb, s.ab,
                             act_sel=s.act_sel, layer_weight_bits=s.wprec,
                             tables=(s.thr, s.ids))
    # each row's loss: sum(w * ce) / max(sum(w), 1); rows add up
    # independently, so one backward gives every row its own gradient
    loss = ((s.w * qat.cross_entropy(logits, y_tr[it])) / s.denom[:, None]).sum()
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        lr_t, on = s.lr[:, j], s.gate[:, j]
        for (k, p), g in zip(s.params.items(), grads):
            shape = (P,) + (1,) * (p.ndim - 1)
            v = s.vel[k]
            v.copy_(momentum * v - lr_t.view(shape) * g)
            p.add_(on.view(shape) * v)


def _train_block(X_tr, y_tr, mlp_cfg: qat.MLPConfig, momentum: float, s: _Slots,
                 n_steps: int) -> None:
    """``n_steps`` training steps of every row, reading and updating ``s`` in place.

    Step j takes column j of the block's indices, learning rates and gates.
    The eager loop, the CPU and the captured graph all run this function:
    the ADC-only genome through ``ops.qat_step`` (five kernels on the card,
    its plain version on the CPU), the genome axes through ``_chain_step``.
    """
    for j in range(n_steps):
        if s.fused:
            qat_ops.qat_step(X_tr, y_tr, s, j, momentum)
        else:
            _chain_step(X_tr, y_tr, mlp_cfg, momentum, s, j)


class _Block:
    """One captured block of ``n`` steps on one bucket's buffers."""

    def __init__(self, run, n: int, pool):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                run(1)
        torch.cuda.current_stream().wait_stream(side)
        before = dict(qat_ops.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: a call that cannot be captured still fails on this
            # thread; other threads' CUDA calls (a service's screens) go on
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                run(n)
        finally:
            # the wrappers counted during the capture, where nothing launched:
            # those counts belong to the replays
            self.launches = {k: qat_ops.LAUNCHES[k] - before[k] for k in before}
            qat_ops.LAUNCHES.update(before)

    def replay(self) -> None:
        self.graph.replay()
        for k, v in self.launches.items():
            qat_ops.LAUNCHES[k] += v


class _Program:
    """The population's training on one device: buffers by bucket, graphs by block."""

    def __init__(self, X_tr, y_tr, X_te, y_te, mlp_cfg, cfg: EvalConfig, dev, graph):
        if cfg.block_steps < 1:
            raise ValueError(f"block_steps must be >= 1, got {cfg.block_steps}")
        self.mlp_cfg, self.cfg, self.dev, self.graph = mlp_cfg, cfg, dev, graph
        self.X_tr = self._put(_host(X_tr, torch.float32))
        self.y_tr = self._put(_host(y_tr, torch.int64))
        self.X_te = self._put(_host(X_te, torch.float32))
        self.y_te = self._put(_host(y_te, torch.int64))
        self.n_train = self.X_tr.shape[0]
        self.slots: dict[int, _Slots] = {}
        self.blocks: dict[tuple[int, int], _Block] = {}
        self.pool = torch.cuda.graph_pool_handle() if graph else None
        # calls, graphs captured, the eager steps their warm-ups ran, replays,
        # and the calls that trained through the fused step (ops.qat_step)
        self.stats = {"calls": 0, "captures": 0, "warmup_steps": 0, "replays": 0,
                      "fused_calls": 0}

    def _put(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device, copied without making the host wait."""
        if self.dev.type == "cpu":
            return t
        return t.pin_memory().to(self.dev, non_blocking=True)

    def _copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src if self.dev.type == "cpu" else src.pin_memory(), non_blocking=True)

    def bucket(self, P: int) -> int:
        g = max(int(self.cfg.pad_granule), 1)
        return -(-P // g) * g

    def _block_lengths(self) -> list[int]:
        S = min(self.cfg.block_steps, self.cfg.max_steps)
        full, tail = divmod(self.cfg.max_steps, S)
        return [S] * full + ([tail] if tail else [])

    def launch(self, masks, wb, ab, bs, ep, lr, params0, idx, extra=()):
        """Enqueue the training and evaluation of P rows; returns ``(acc, slots, P)``.

        ``extra`` holds the genome axes' per-row arrays (``EvalConfig.genome_axes``,
        canonical order).  ``acc`` is the (bucket,) accuracy on the device and
        ``slots`` the bucket's buffers, holding the trained parameters until
        the next call on that bucket.  Nothing is read back to the host.
        """
        with spans.span(SPAN_STAGE):
            cfg = self.cfg
            names = _extra_names(cfg)
            if len(extra) != len(names):
                raise TypeError(f"genome axes {tuple(cfg.genome_axes)} expect {len(names)} "
                                f"extra row arrays, got {len(extra)}")
            masks = _host(masks, torch.bool)
            P = masks.shape[0]
            if P < 1:
                raise ValueError("an evaluator call needs at least one row")
            n = self.bucket(P)
            self.stats["calls"] += 1
            bs_h = _host(bs, torch.int64)
            lr_h, gate_h = _schedules(bs_h, _host(ep, torch.int64), _host(lr, torch.float32),
                                      self.n_train, cfg)
            w_h = (torch.arange(cfg.max_batch) < bs_h[:, None]).to(torch.float32)
            rows = {
                "masks": masks, "wb": _host(wb, torch.float32), "ab": _host(ab, torch.float32),
                # integer-valued: exact in any order
                "w": w_h, "denom": torch.clamp(w_h.sum(-1), min=1.0),
            }
            for name, v in zip(names, extra):
                rows[name] = _host(v, torch.int64 if name == "act_sel" else torch.float32)
            idx = _host(idx, torch.int64)
            if idx.shape[1:] != (cfg.max_steps, cfg.max_batch):
                raise ValueError(f"idx is {tuple(idx.shape)}, expected (P, {cfg.max_steps}, "
                                 f"{cfg.max_batch})")
            idx = self._put(_pad_rows(idx, n))
            lr_d = self._put(_pad_rows(lr_h, n))
            gate_d = self._put(_pad_rows(gate_h, n))
            s = self.slots.get(n)
            if s is None:
                s = self.slots[n] = _Slots(n, self.mlp_cfg, cfg, self.dev)
            self.stats["fused_calls"] += s.fused
            for k, v in rows.items():
                self._copy(getattr(s, k), _pad_rows(v, n))
            thr, ids = make_tables(s.masks, self.mlp_cfg.adc_bits)
            s.thr.copy_(thr)
            s.ids.copy_(ids)
            lengths = self._block_lengths()

            def load_block(t0: int, m: int) -> None:
                s.idx[:, :m].copy_(idx[:, t0:t0 + m])
                s.lr[:, :m].copy_(lr_d[:, t0:t0 + m])
                s.gate[:, :m].copy_(gate_d[:, t0:t0 + m])

            def run(m: int) -> None:
                _train_block(self.X_tr, self.y_tr, self.mlp_cfg, cfg.momentum, s, m)

            if self.graph:
                # capture before the parameters are loaded: the warm-up steps
                # train on the buffers, which are then reset
                load_block(0, lengths[0])
        if self.graph:
            for m in sorted(set(lengths)):
                if (n, m) not in self.blocks:
                    with spans.span(SPAN_CAPTURE):
                        self.blocks[(n, m)] = _Block(run, m, self.pool)
                    self.stats["captures"] += 1
                    self.stats["warmup_steps"] += WARMUP_STEPS
        with spans.span(SPAN_STAGE), torch.no_grad():
            for k, p in s.params.items():
                self._copy(p, _pad_rows(_host(params0[k], torch.float32), n))
                s.vel[k].zero_()
        with spans.span(SPAN_ENQUEUE):
            t0 = 0
            for m in lengths:
                load_block(t0, m)
                if self.graph:
                    self.blocks[(n, m)].replay()
                    self.stats["replays"] += 1
                else:
                    run(m)
                t0 += m
            with torch.no_grad():
                logits = qat.mlp_forward(s.params, self.X_te.expand(n, -1, -1), self.mlp_cfg,
                                         s.masks, s.wb, s.ab, act_sel=s.act_sel,
                                         layer_weight_bits=s.wprec, tables=(s.thr, s.ids))
                acc = qat.accuracy(logits, self.y_te.expand(n, -1))
        return acc, s, P


def _use_graph(dev: torch.device, graph: bool | None) -> bool:
    if graph is None:
        return dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError("CUDA graphs run on the card; the CPU runs the plain loop "
                         "(pass graph=None or graph=False)")
    return bool(graph)


def make_row_program(X_tr, y_tr, X_te, y_te, mlp_cfg: qat.MLPConfig, cfg: EvalConfig,
                     device=None, graph: bool | None = None):
    """Returns ``train_rows(masks, wb, ab, bs, ep, lr, params0, idx, *extra) -> (acc, params)``.

    ``acc`` is the (P,) fp32 test-set accuracy of each row after its QAT
    run, ``params`` the final stacked parameters.  Per-row inputs are
    leading-axis stacked arrays or tensors: masks (P, C, 2^N) bool, wb/ab
    (P,) fp32 bit widths, bs/ep (P,) int, lr (P,) fp32; ``params0`` and
    ``idx`` come from :func:`draw_rows` (or from the reference, in tests);
    ``extra`` the genome axes' arrays (``EvalConfig.genome_axes``: act
    selectors (P, n_hidden), then wprec widths (P, n_layers)).
    ``graph``: None = a CUDA graph on the card, the plain loop on the CPU.
    The returned function carries ``.stats`` (calls, captures, warm-up
    steps, replays, fused calls).
    """
    dev = resolve_device(device)
    prog = _Program(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, dev, _use_graph(dev, graph))

    def train_rows(masks, wb, ab, bs, ep, lr, params0, idx, *extra):
        acc, s, P = prog.launch(masks, wb, ab, bs, ep, lr, params0, idx, extra)
        return acc[:P], {k: v.detach()[:P].clone() for k, v in s.params.items()}

    train_rows.stats = prog.stats
    return train_rows


def device_count(dev: torch.device) -> int:
    """Devices of ``dev``'s type an evaluator may be rebuilt on (the CPU is one)."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _device_grid(mesh, device, n_devices: int | None, build) -> shd.DeviceGrid:
    """The grid an evaluator trains on: the first ``n_devices`` devices of
    ``mesh`` or, without ``mesh``, ``device`` alone (``n_devices`` then only
    has to be available); ``build(devices=...)`` makes the grid."""
    if mesh is not None:
        return mesh if n_devices is None else build(devices=list(mesh.devices)[:n_devices])
    dev = resolve_device(device)
    if n_devices is not None and not 1 <= n_devices <= device_count(dev):
        raise ValueError(f"n_devices={n_devices}, but {device_count(dev)} {dev.type} "
                         "device(s) are available")
    return build(devices=[dev])


def make_population_evaluator(X_tr, y_tr, X_te, y_te, mlp_cfg: qat.MLPConfig,
                              cfg: EvalConfig = EvalConfig(), device=None,
                              graph: bool | None = None, n_devices: int | None = None,
                              *, mesh: shd.DeviceGrid | None = None):
    """Returns ``evaluate(masks, wb, ab, bs, ep, lr, seeds, *extra) -> np.ndarray (P,)``.

    The test-set accuracy of each row after QAT, a pure function of the
    row (its training seed arrives as an input, derived upstream from the
    genome bytes), whatever rows share the call.  ``extra`` holds one
    array per genome axis beyond "adc" (``cfg.genome_axes``, canonical
    order), as in the reference.  ``evaluate.dispatch(...)``
    enqueues the same call and returns ``resolve()``, which waits for it;
    ``evaluate.rebuild(n_devices)`` gives a fresh evaluator (an empty graph
    cache) on the first ``n_devices`` devices.

    ``mesh``: a ``parallel.sharding.DeviceGrid`` (``population_mesh``);
    without it the evaluator trains on ``device`` alone, a ``(1,)`` grid.
    The rows are padded to a multiple of ``max(pad_granule, n)`` rounded
    up to the device count n and split over the grid's ``data`` axis as the
    reference's ``logical_sharding(..., population_rules())`` splits them;
    each device trains its block with its own row program (its own CUDA
    graphs on a card), and the accuracies are gathered on the host.  A
    row's result does not depend on its block, so any grid gives the bits
    of one device.
    """
    grid = _device_grid(mesh, device, n_devices, shd.population_mesh)
    run = _GridPrograms(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, graph, grid)
    rules = shd.population_rules()
    # a bucket the data axis divides, or the rows would be replicated
    granule = -(-max(cfg.pad_granule, 1) // grid.size) * grid.size

    def plan(P: int) -> tuple[int, tuple]:
        bucket = -(-P // granule) * granule
        return bucket, shd.logical_spec((bucket,), ("population",), grid, rules)

    def dispatch(*rows):
        P = int(np.shape(rows[0])[0])
        bucket, spec = plan(P)
        resolve_all = run.dispatch((bucket,), spec, [_pad_to(a, bucket) for a in rows])
        return lambda: resolve_all()[:P]

    def evaluate(*rows) -> np.ndarray:
        return dispatch(*rows)()

    def rebuild(n: int | None = None):
        """A fresh evaluator (empty graph cache) on the first ``n`` devices."""
        return make_population_evaluator(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, device, graph,
                                         n, mesh=mesh)

    evaluate.dispatch = dispatch
    evaluate.rebuild = rebuild
    evaluate.stats = run.stats
    evaluate.mesh = grid
    evaluate.granule = granule
    evaluate.plan = plan
    evaluate.programs = run
    return evaluate


def make_island_evaluator(X_tr, y_tr, X_te, y_te, mlp_cfg: qat.MLPConfig,
                          cfg: EvalConfig = EvalConfig(), num_islands: int = 1, device=None,
                          graph: bool | None = None, n_devices: int | None = None,
                          *, mesh: shd.DeviceGrid | None = None):
    """Returns ``evaluate(batches) -> [(B_i,) accuracies, ...]`` for the stacked island driver.

    ``batches`` is one ``(masks, wb, ab, bs, ep, lr, seeds, *extra)``
    tuple per island (``num_islands`` of them, zero-row batches allowed;
    ``extra`` per ``cfg.genome_axes`` as in the population evaluator).  Each
    island is padded to ONE common bucket (the largest island rounded up
    to the granule) by repeating its last row, an empty island by a filler
    row from the first non-empty one, as the reference's ``_launch`` does;
    the islands are stacked (K, bucket) and the results split back per
    island.  A row's result is the population evaluator's, bit for bit.
    ``.dispatch(batches)`` returns a ``resolve()``; ``.rebuild(n_devices)``
    a fresh evaluator.

    ``mesh``: an ``(island, data)`` ``DeviceGrid`` (``island_mesh``);
    without it ``device`` alone, a ``(1, 1)`` grid, which trains all the
    islands as one population call of ``num_islands * bucket`` rows.  The
    granule is ``pad_granule`` rounded up to the group size, and the stack
    is split as the reference's ``logical_sharding(..., island_rules())``
    splits it: islands over the ``island`` axis (all of them on every group
    when K does not divide it), rows over ``data``; each device trains its
    block.  The programs are a population evaluator's on the same grid, so
    its ``stats`` count them.
    """
    if num_islands < 1:
        raise ValueError(f"num_islands must be >= 1, got {num_islands}")
    grid = _device_grid(mesh, device, n_devices,
                        lambda devices: shd.island_mesh(num_islands, devices=devices))
    run = make_population_evaluator(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, device, graph,
                                    mesh=grid).programs
    rules = shd.island_rules()
    # rows split within an island's group: the granule divides the group
    group = max(int(grid.shape.get("data", 1)), 1)
    granule = -(-max(cfg.pad_granule, 1) // group) * group

    def plan(sizes) -> tuple[int, tuple]:
        bucket = -(-max(sizes) // granule) * granule
        spec = shd.logical_spec((num_islands, bucket), ("island", "population"), grid, rules)
        return bucket, spec

    def dispatch(batches):
        if len(batches) != num_islands:
            raise ValueError(f"expected {num_islands} island batches, got {len(batches)}")
        sizes = [int(np.shape(b[0])[0]) for b in batches]
        if not any(sizes):
            return lambda: [np.zeros((0,), np.float32) for _ in sizes]
        bucket, spec = plan(sizes)
        # filler for zero-row islands: any valid chromosome, results unused
        filler = next([np.asarray(a)[:1] for a in b] for b, n in zip(batches, sizes) if n)
        stacked = [np.stack([_pad_to(np.asarray(b[j]) if n else filler[j], bucket)
                             for b, n in zip(batches, sizes)])
                   for j in range(len(filler))]
        resolve_all = run.dispatch((num_islands, bucket), spec, stacked)

        def resolve():
            accs = resolve_all()
            return [accs[i, :n] for i, n in enumerate(sizes)]

        return resolve

    def evaluate(batches):
        return dispatch(batches)()

    def rebuild(n: int | None = None):
        """A fresh island evaluator (empty graph cache) on the first ``n`` devices."""
        return make_island_evaluator(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, num_islands, device,
                                     graph, n, mesh=mesh)

    evaluate.dispatch = dispatch
    evaluate.rebuild = rebuild
    evaluate.stats = run.stats
    evaluate.mesh = grid
    evaluate.granule = granule
    evaluate.plan = plan
    return evaluate


# ---------------------------------------------------------------------------
# evaluators on a device grid
# ---------------------------------------------------------------------------

def _pad_to(a, n: int) -> np.ndarray:
    a = np.asarray(a)
    return a if a.shape[0] == n else np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], 0)])


def device_blocks(shape: tuple[int, ...], spec: tuple, grid: shd.DeviceGrid) -> list[tuple]:
    """Each grid device's block of an array of leading ``shape`` laid out by
    ``spec`` (``parallel.sharding.logical_spec``): a tuple of slices, one per
    dim; a replicated dim is whole on every device."""
    sizes = grid.shape
    coords = np.unravel_index(np.arange(grid.size), grid.dims)
    out = []
    for dev in range(grid.size):
        where = {a: int(coords[i][dev]) for i, a in enumerate(grid.axis_names)}
        blk = []
        for dim, entry in zip(shape, spec):
            axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
            n, part = 1, 0
            for a in axes:
                n, part = n * sizes[a], part * sizes[a] + where[a]
            step = dim // n
            blk.append(slice(part * step, (part + 1) * step))
        out.append(tuple(blk))
    return out


class _StatsSum(Mapping):
    """The row programs' ``.stats`` summed on every read."""

    def __init__(self, progs):
        self._progs = progs

    def __getitem__(self, key):
        return sum(p.stats[key] for p in self._progs)

    def __iter__(self):
        return iter(self._progs[0].stats)

    def __len__(self):
        return len(self._progs[0].stats)


class _GridPrograms:
    """One row program a device of ``grid``; a call trains each device's
    block of a padded (..., bucket) stack and gathers the accuracies."""

    def __init__(self, X_tr, y_tr, X_te, y_te, mlp_cfg, cfg: EvalConfig, graph, grid):
        # the grid pads to its buckets; a device trains exactly its block
        local = dataclasses.replace(cfg, pad_granule=1)
        self.cfg, self.mlp_cfg, self.grid = cfg, mlp_cfg, grid
        self.progs = [_Program(X_tr, y_tr, X_te, y_te, mlp_cfg, local, resolve_device(d),
                               _use_graph(resolve_device(d), graph))
                      for d in grid.devices]
        self.stats = _StatsSum(self.progs)
        self.n_train = self.progs[0].n_train

    def dispatch(self, shape: tuple[int, ...], spec: tuple, rows: list):
        """``rows``: (masks, wb, ab, bs, ep, lr, seeds, *extra), each with
        leading dims ``shape``.  Returns ``resolve() -> np.ndarray(shape)``."""
        lead = len(shape)
        flat = [np.asarray(a).reshape((-1,) + np.shape(a)[lead:]) for a in rows]
        params0, idx = draw_rows(flat[6], self.cfg, self.mlp_cfg, self.n_train)
        params0 = {k: v.reshape(shape + tuple(v.shape[1:])) for k, v in params0.items()}
        idx = idx.reshape(shape + tuple(idx.shape[1:]))
        pending = []
        for prog, blk in zip(self.progs, device_blocks(shape, spec, self.grid)):
            def cut(a, blk=blk):
                b = a[blk]
                return b.reshape((-1,) + tuple(b.shape[lead:]))

            masks, wb, ab, bs, ep, lr, _, *extra = (cut(np.asarray(a)) for a in rows)
            acc, _, n = prog.launch(masks, wb, ab, bs, ep, lr,
                                    {k: cut(v) for k, v in params0.items()}, cut(idx), extra)
            with spans.span(SPAN_ENQUEUE):
                pending.append((blk, _to_host(acc[:n], prog.dev)))

        def resolve() -> np.ndarray:
            out = np.empty(shape, np.float32)
            for blk, get in pending:
                out[blk] = get().reshape(out[blk].shape)
            return out

        return resolve


def _to_host(acc: torch.Tensor, dev: torch.device):
    """``get() -> np.ndarray`` of ``acc``: on a card a copy into pinned host
    memory and an event, so nothing waits until ``get`` is called."""
    if dev.type == "cpu":
        out = acc.numpy()
        return lambda: out
    host = torch.empty(acc.shape, dtype=acc.dtype, pin_memory=True)
    with torch.cuda.device(dev):
        host.copy_(acc, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def get() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return get
