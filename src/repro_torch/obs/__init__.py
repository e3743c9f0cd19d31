"""repro_torch.obs — the observability layer, a port of ``repro.obs``.

Three legs (see each submodule):

* :mod:`repro_torch.obs.tracing` — nested host-side spans over the compile
  pipeline and the serving step loop, exported as Chrome-trace/Perfetto
  JSON.
* :mod:`repro_torch.obs.metrics` — typed metrics registry (counters /
  gauges / fixed-bucket histograms) with Prometheus text exposition and
  JSON snapshots.  ``core.stats`` is a thin compat shim over it.
* :mod:`repro_torch.obs.accuracy` — predicted-against-measured
  activation-peak accounting (``plan_accuracy``).

Import discipline: nothing in this package imports ``repro_torch.core``
(``core.stats`` imports us; a cycle would break the package), and nothing
touches ``torch.cuda`` at import time.
"""
from . import accuracy, clock, metrics, tracing  # noqa: F401
from .accuracy import PlanAccuracy, watermark_graph  # noqa: F401
from .clock import ManualClock  # noqa: F401
from .metrics import REGISTRY, MetricsRegistry, default_registry  # noqa: F401
from .tracing import TRACER, span, traced  # noqa: F401
