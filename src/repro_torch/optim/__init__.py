"""Optimizers of the port (the JAX package's ``optim``, built from scratch as
there): pure ``(init, update)`` pairs over flat dicts of tensors, the states
NamedTuples with the reference's field names, so ``launch/train`` writes the
same checkpoint keys.  Not ``torch.optim``: the arithmetic is the
reference's (fp32 moments of bf16 parameters, the decay inside the update,
bias corrections ``b ** step`` in fp32)."""

from repro_torch.optim.adamw import adamw  # noqa: F401
from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.sgd import sgd_momentum  # noqa: F401
from repro_torch.optim.schedule import cosine_warmup, constant  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm  # noqa: F401
from repro_torch.optim.compress import compress_gradients, decompress_gradients  # noqa: F401
