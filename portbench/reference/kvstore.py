"""A plain key-value store with YCSB's semantics: a table of fixed-width
records, reads return the value last written to the key, updates replace
it. It holds every record on the device as one fp32 tensor; the control
(`lag=1`) acknowledges each update but applies it one window late, which
breaks the guarantee that an acknowledged write is read back."""
from __future__ import annotations

import torch


class Store:
    def __init__(self, values: torch.Tensor, lag: int = 0):
        self.values = values.clone()
        self.lag = lag
        self._pending = []

    def read(self, keys: torch.Tensor) -> torch.Tensor:
        return self.values[keys.long()]

    def update(self, keys: torch.Tensor, rows: torch.Tensor) -> None:
        """Rows for one key written twice in a call are equal."""
        self._pending.append((keys.long(), rows))
        while len(self._pending) > self.lag:
            k, r = self._pending.pop(0)
            self.values[k] = r
