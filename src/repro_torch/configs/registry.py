"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from repro_torch.configs import (
    arctic_480b,
    command_r_35b,
    deepseek_v3,
    internvl2_26b,
    k_exaone_236b,
    mistral_nemo_12b,
    phi35_moe_42b,
    qwen3_32b,
    rwkv6_1p6b,
    whisper_medium,
    yi_9b,
    zamba2_2p7b,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        command_r_35b.CONFIG,
        yi_9b.CONFIG,
        qwen3_32b.CONFIG,
        mistral_nemo_12b.CONFIG,
        rwkv6_1p6b.CONFIG,
        arctic_480b.CONFIG,
        phi35_moe_42b.CONFIG,
        zamba2_2p7b.CONFIG,
        internvl2_26b.CONFIG,
        whisper_medium.CONFIG,
    )
}


# architectures the port serves that the JAX package has no twin of: found
# by ``get``, left out of ``ARCHS`` (the tests hold ``ARCHS`` to the
# reference's registry)
PORT_ONLY: dict[str, ModelConfig] = {c.name: c for c in (k_exaone_236b.CONFIG,
                                                          deepseek_v3.CONFIG)}


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PORT_ONLY:
        return PORT_ONLY[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(PORT_ONLY)}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for the CPU tests (the reference's cut, field
    for field).  Every family builds at full width too: ``chip_smoke.py``
    serves yi-9b, phi3.5-moe (depth cut), rwkv6, zamba2, internvl2 and
    whisper on the card."""
    over: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(cfg.n_kv_heads * 4 // cfg.n_heads, 1),
        d_ff=128,
        vocab_size=503,  # deliberately non-multiple of the pad unit
        dtype="float32",
        ssm_chunk=8,
    )
    if cfg.family == "moe":
        over.update(n_experts=4, top_k=2, expert_d_ff=96)
    if cfg.experts_held:
        # two periods of the window pattern, window 4, 4 of 8 experts held
        over.update(n_layers=2 * len(cfg.window_pattern), head_dim=16, window=min(cfg.window, 4),
                    n_experts=8, experts_held=4, n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.kv_lora_rank:
        # one dense layer and three expert layers; 4 groups of 2 experts, the
        # top-2 from the best 2 groups, so that the group limit binds
        over.update(n_layers=4, first_dense_layers=1, n_kv_heads=4, head_dim=24, q_lora_rank=32,
                    kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    n_group=4, topk_group=2)
    if cfg.family == "hybrid":
        over.update(n_layers=4, attn_every=2, ssm_state=16, ssm_head_dim=16)
    if cfg.family == "ssm":
        over.update(n_heads=4, n_kv_heads=4)
    if cfg.family == "vlm":
        over.update(frontend_len=8)
    if cfg.family == "audio":
        over.update(encoder_layers=2, max_target_len=16)
    return dataclasses.replace(cfg, **over)
