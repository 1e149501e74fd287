"""Fault tolerance of GA campaigns: failure injection, the straggler watchdog, elastic runs."""

from repro_torch.runtime.elastic import DrillConfig, ElasticGARunner  # noqa: F401
from repro_torch.runtime.failure import FailureInjector  # noqa: F401
from repro_torch.runtime.straggler import StragglerWatchdog  # noqa: F401
