"""What the benchmark reads from the port's model configuration, on the CPU.

``cardbench/drivers/long_prefill.py`` checks the program's K-EXAONE config
against the configuration file (``check_config``) and refuses any weight
layout but its reference's (``exaone_moe.weight_shapes``); here both hold at
full width, from the specs alone, with nothing allocated.  And every
setting only the port's architectures change is a field of the one
``ModelConfig``: ``dataclasses.replace`` takes it on a configuration the
JAX package also has.
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench.drivers import long_prefill  # noqa: E402
from cardbench.reference import exaone_moe  # noqa: E402

CONFIG = "k-exaone-236b-a23b"
# each port-only setting and a value other than its default (K-EXAONE's)
PORT_ONLY = dict(rms_norm_eps=1e-5, window=128, window_pattern="LLLG", post_norm=True,
                 first_dense_layers=1, experts_held=8, routed_scale=2.5, n_shared_experts=1)


def test_kexaone_layout_and_port_only_fields():
    config = json.loads((ROOT / "cardbench" / "configs" / f"{CONFIG}.json").read_text())
    run = types.SimpleNamespace(config=config, cell={"config": CONFIG})
    cfg = long_prefill.check_config(run)
    assert cfg is registry.get(config["arch"])
    specs = build_model(cfg).param_specs()
    got = {name: tuple(shape) for name, (shape, _, _) in specs.items()}
    assert got == exaone_moe.weight_shapes(long_prefill.sizes(config))

    base = registry.get("internvl2-26b")
    assert {k: getattr(base, k) for k in PORT_ONLY} != PORT_ONLY
    for k, v in PORT_ONLY.items():
        changed = dataclasses.replace(base, **{k: v})
        assert getattr(changed, k) == v
        assert dataclasses.replace(changed, **{k: getattr(base, k)}) == base
