"""RMSNorm with the post-norm residual add, one kernel, and its plain version."""

from repro_torch.kernels.rms_norm.ops import rms_norm
