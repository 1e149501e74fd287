"""internvl2-26b [vlm] — InternViT (stub) + InternLM2 backbone. [arXiv:2404.16821]

The ViT frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, 256, d_model) in [0,1); the paper's
PrunedQuantFrontend digitises them (DESIGN.md §5 — the VLM is one of the
two assigned archs where the ADC technique applies natively).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend_len=256,  # pixel-unshuffled patch tokens per image
    use_pruned_frontend=True,
)
