"""Runtime policies: failure injection, the straggler watchdog, elastic runs (the
mesh shape, re-meshing an LM run, GA campaigns), and the evaluation service's
admission control and deadlines."""

from repro_torch.runtime.admission import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
    AdmissionError,
    RequestWatchdog,
)
from repro_torch.runtime.elastic import (  # noqa: F401
    DrillConfig,
    ElasticGARunner,
    ElasticRunner,
    choose_mesh_shape,
)
from repro_torch.runtime.failure import FailureInjector  # noqa: F401
from repro_torch.runtime.straggler import StragglerWatchdog  # noqa: F401
