"""Multi-device layer of the port: logical-axis sharding on ``DeviceMesh`` /
DTensor (``sharding``) and GPipe over a ``stage`` group (``pipeline``)."""

from repro_torch.parallel.sharding import (  # noqa: F401
    LOGICAL_RULES,
    constrain,
    logical_sharding,
    logical_spec,
    shard_tree,
)
