"""Batched serving driver: continuous-batching decode loop with KV caches.

The port of the JAX package's ``launch/serve.py``.  Request lifecycle:
prompts arrive -> each prompt is fed through the decode path into its cache
slot -> the decode loop advances ALL active requests one token per step ->
finished requests retire and their slots are refilled (continuous
batching).  The scheduling, the greedy argmax over ``[:vocab_size]`` and the
returned fields are the reference's, line for line.

The cache comes from the model's ``cache_specs(max_batch, max_len)``, as
in the reference: (L, B, max_len) KV caches for the dense, MoE and VLM
families; the fp32 wkv states and token-shift buffers for rwkv6 (no
``max_len``); the SSM and conv states and one KV cache per shared-attention
invocation for zamba2; for whisper, self caches of ``max_target_len`` and
zeroed cross caches of ``max_len`` positions (the reference serves
whisper's decoder alone).  On a CUDA device every ``decode_step`` runs the
decode attention as the hand-written flash-decode kernel K5: once per layer
(dense, MoE, VLM), twice per layer for whisper (self and cross), once per
shared-attention invocation for zamba2, never for rwkv6.  Everything runs
under ``torch.inference_mode()``.

The reference's caveat, kept: ``feed_slot`` pushes each prompt token
through ``decode_step`` over the whole batch.  For the KV-cache families
that is harmless (another slot's extra write lands at a position the next
step writes again with the same values).  For rwkv6 and zamba2 it advances
every other slot's recurrent state (wkv state, token shifts, conv and SSD
states) by its pending token again, and a reused slot starts from the
previous request's state: their tokens depend on the schedule, in both
packages alike.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b          # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b     # any LM arch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --full --layers 24
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu          # plain path
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import build_model, init_cache

__all__ = ["ServeConfig", "Request", "run", "main"]


@dataclasses.dataclass
class ServeConfig:
    arch: str = "yi-9b"
    reduced: bool = True
    max_batch: int = 4
    max_len: int = 64
    n_requests: int = 8
    prompt_len: int = 8
    gen_len: int = 16
    seed: int = 0
    # decode-step at which request i becomes available (continuous
    # batching under staggered arrival); shorter than n_requests pads
    # with 0 = available immediately.  () = the all-at-once batch queue.
    arrival_steps: tuple[int, ...] = ()
    device: str | None = None  # None = "cuda"
    # depth cut of the config (None = its own): phi3.5-moe's 32 layers do
    # not fit one 80 GB card in bf16, 24 do
    n_layers: int | None = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    generated: list[int] = dataclasses.field(default_factory=list)

    def done(self, gen_len: int) -> bool:
        return len(self.generated) >= gen_len


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def run(cfg: ServeConfig, params: dict | None = None) -> dict:
    """Serve ``cfg.n_requests`` random prompts; ``params=None`` draws them from ``cfg.seed``.

    ``params`` carries a parameter dict in (tests hand the reference's
    across with ``convert.lm_params_from_jax``).
    """
    dev = resolve_device(cfg.device)
    model_cfg = registry.get(cfg.arch)
    if cfg.reduced:
        model_cfg = registry.reduced(model_cfg)
    if cfg.n_layers is not None:
        model_cfg = dataclasses.replace(model_cfg, n_layers=cfg.n_layers)
    model = build_model(model_cfg)
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(cfg.seed))
    rng = np.random.default_rng(cfg.seed)

    requests = [
        Request(i, rng.integers(0, model_cfg.vocab_size, cfg.prompt_len).astype(np.int32))
        for i in range(cfg.n_requests)
    ]
    # arrival schedule: request i joins the pending queue once the decode
    # clock reaches arrival_steps[i] (0 / unspecified = immediately).
    # Stable sort keeps submission order among same-step arrivals, so the
    # default () is exactly the original all-at-once queue.
    arrivals = list(cfg.arrival_steps) + [0] * (cfg.n_requests - len(cfg.arrival_steps))
    schedule = sorted(zip(arrivals, requests), key=lambda t: t[0])
    next_arrival = 0
    pending: list[Request] = []
    active: list[Request | None] = [None] * cfg.max_batch
    first_token_step: dict[int, int] = {}
    finish_step: dict[int, int] = {}
    peak_active = 0

    cache = init_cache(model, cfg.max_batch, cfg.max_len, dev)
    kv_len = torch.zeros((cfg.max_batch,), dtype=torch.int32, device=dev)
    cur_tok = torch.zeros((cfg.max_batch,), dtype=torch.int32, device=dev)

    decode = model.decode_step
    steps = 0
    _sync(dev)
    t0 = time.perf_counter()

    def feed_slot(slot, req, cache, kv_len, cur_tok):
        """Prefill-by-decode: push prompt tokens through the decode path
        (the reference does so to keep one compiled program for everything)."""
        kv_len[slot] = 0
        for t in req.prompt:
            cur_tok[slot] = int(t)
            logits, cache = decode(params, cur_tok, cache, kv_len)
            kv_len[slot] += 1
        nxt = int(torch.argmax(logits[slot, : model_cfg.vocab_size]))
        cur_tok[slot] = nxt
        req.generated.append(nxt)
        return cache, kv_len, cur_tok

    while next_arrival < len(schedule) or pending or any(
        r is not None for r in active
    ):
        # admit requests whose arrival step has come
        while next_arrival < len(schedule) and schedule[next_arrival][0] <= steps:
            pending.append(schedule[next_arrival][1])
            next_arrival += 1
        # refill empty slots (continuous batching): a late arrival takes
        # over the cache slot of whichever request finished before it
        for slot in range(cfg.max_batch):
            if active[slot] is None and pending:
                req = pending.pop(0)
                active[slot] = req
                cache, kv_len, cur_tok = feed_slot(slot, req, cache, kv_len, cur_tok)
                first_token_step[req.rid] = steps
        n_active = sum(r is not None for r in active)
        peak_active = max(peak_active, n_active)
        if n_active == 0:
            steps += 1  # idle tick: the next arrival is still in the future
            continue
        # one decode step for the whole batch
        logits, cache = decode(params, cur_tok, cache, kv_len)
        kv_len = kv_len + torch.tensor(
            [1 if r is not None else 0 for r in active], dtype=torch.int32, device=dev
        )
        steps += 1
        nxt = torch.argmax(logits[:, : model_cfg.vocab_size], dim=-1).cpu().numpy()
        for slot, req in enumerate(active):
            if req is None:
                continue
            req.generated.append(int(nxt[slot]))
            if req.done(cfg.gen_len):
                finish_step[req.rid] = steps
                active[slot] = None
        cur_tok = torch.as_tensor(nxt, dtype=torch.int32).to(dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in requests)
    return {
        "requests": {r.rid: r.generated for r in requests},
        "decode_steps": steps,
        "tokens_generated": total_tokens,
        "tokens_per_s": total_tokens / max(dt, 1e-9),
        # continuous-batching telemetry (as the reference returns it)
        "peak_active": peak_active,
        "first_token_step": first_token_step,
        "finish_step": finish_step,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="the published widths, not reduced")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (e.g. 24 for phi3.5-moe --full)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    out = run(
        ServeConfig(
            arch=args.arch,
            reduced=not args.full,
            n_requests=args.n_requests,
            max_batch=args.max_batch,
            gen_len=args.gen_len,
            device=args.device,
            n_layers=args.layers,
        )
    )
    print(
        f"served {len(out['requests'])} requests, {out['tokens_generated']} tokens "
        f"in {out['decode_steps']} batched steps ({out['tokens_per_s']:.1f} tok/s)"
    )


if __name__ == "__main__":
    main()
