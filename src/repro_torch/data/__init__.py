"""Data substrate of the port (numpy copies of `repro/data`): YCSB
workloads (`ycsb.py`), the ten data-structure access topologies of the
paper's Table 1 (`structures.py`), CrestKV (`crestkv.py`), which runs them
over SimHeap, and the LM token pipeline (`lm.py`)."""
from repro_torch.data.ycsb import WORKLOADS, ZipfianKeys  # noqa: F401
from repro_torch.data.structures import STRUCTURES, make_structure  # noqa: F401
