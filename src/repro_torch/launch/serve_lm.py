"""Batched serving demo on the port: continuous batching with KV caches.

The twin of the reference's ``examples/serve_lm.py``, with its flag
(``--arch``, any arch of ``configs/``) and ``--device`` (the card by
default, ``cpu`` for the plain path).  Serves a reduced model with more
requests than batch slots (10 requests, 4 slots), so the
continuous-batching refill path is exercised; prints per-request
generations and throughput.  Prompts are fed through the decode path, as
in the reference, so on the card every step runs the flash-decode kernel
K5 (``kernels/decode_attn``; none for the attention-free rwkv6).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--arch yi-9b] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_mod

__all__ = ["config", "run", "main"]

GEN_LEN = 12


def config(arch: str = "yi-9b", device: str | None = None) -> serve_mod.ServeConfig:
    return serve_mod.ServeConfig(
        arch=arch, reduced=True, max_batch=4, n_requests=10,
        prompt_len=6, gen_len=GEN_LEN, max_len=32, device=device,
    )


def run(arch: str = "yi-9b", device: str | None = None, params: dict | None = None) -> dict:
    """``serve.run``'s output for the demo, plus ``lines``: what ``main`` prints,
    one string a line.  ``params=None`` draws the parameters on the device from
    the config's seed; a dict is served as given.  Raises if a request got
    fewer than GEN_LEN tokens."""
    dev = resolve_device(device).type
    out = serve_mod.run(config(arch, dev), params=params)
    lines = [f"request {rid}: {toks}" for rid, toks in sorted(out["requests"].items())]
    # the port compiles no program: on the card the loop's wall clock holds K5's
    # first launch, and its nvcc build on a checkout where it is not built yet
    timed = ("incl. K5's first launch and, on a fresh checkout, its build" if dev == "cuda"
             else "plain PyTorch on the CPU")
    lines += ["", f"{out['tokens_generated']} tokens over {out['decode_steps']} batched "
                  f"decode steps ({out['tokens_per_s']:.1f} tok/s, {timed})"]
    short = {rid: len(t) for rid, t in out["requests"].items() if len(t) < GEN_LEN}
    if short:
        raise RuntimeError(f"requests finished with fewer than {GEN_LEN} tokens: {short}")
    lines.append("OK: all requests completed")
    return {**out, "lines": lines}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    print("\n".join(run(args.arch, args.device)["lines"]))


if __name__ == "__main__":
    main()
