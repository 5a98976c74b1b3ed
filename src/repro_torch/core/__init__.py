"""HADES core of the port: object table, pool with its free rings, MIAD,
backends, collector, Page Utilization, the window protocol and object
engine, the `Hades` frontend, and the byte-granular `SimHeap`."""
from repro_torch.core import object_table  # noqa: F401
from repro_torch.core.engine import Engine, EngineOptions  # noqa: F401
from repro_torch.core.frontend import Hades, HadesOptions  # noqa: F401
from repro_torch.core.pool import PoolConfig, make_config  # noqa: F401
