"""Fused pruned-ADC QAT first layer (kernels K2 forward and K3 backward)."""

from repro_torch.kernels.fused_qat.ops import fused_qat_first_layer
