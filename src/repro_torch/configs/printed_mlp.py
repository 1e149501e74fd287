"""The paper's own architecture: bespoke printed MLPs, one per UCI dataset.

These parameterise ``core.codesign``.  Topologies follow the printed-MLP
literature: one hidden layer sized per dataset, 4-bit ADC inputs, 8-bit
pow2 weights.
"""

from repro_torch.core.codesign import CodesignConfig

PAPER_DATASETS = ("balance", "breast_cancer", "cardio", "mammographic", "seeds", "vertebral3")


def codesign_config(dataset: str, full: bool = False) -> CodesignConfig:
    """``full=True`` ~= the paper's search budget; False = CI-scale."""
    if full:
        return CodesignConfig(
            dataset=dataset, pop_size=24, n_generations=16, step_scale=1.0, max_steps=600
        )
    return CodesignConfig(
        dataset=dataset, pop_size=12, n_generations=6, step_scale=0.5, max_steps=300
    )
