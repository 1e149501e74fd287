"""The pruned flash-ADC comparator bank (kernel K1), its tables and plain encoder."""

from repro_torch.kernels.pruned_quant.ops import pruned_quantize
