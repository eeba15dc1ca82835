"""
Historical data logging sinks for the serving loops (a copy of
``ics_wt_physicsengine_tpu/utils/history.py``, which holds no JAX code).

The reference lists historical logging as future work twice: CSV-style
logging (reference README.md:441-447) and "Historical data logging
(Parquet format)" on the Phase 3 roadmap (reference README.md:443). The
orchestrator's ``--log-csv`` covers the first; ``ParquetHistoryLogger``
(``--log-parquet``) covers the second: a streaming columnar sink that
flushes fixed-size row groups through ``pyarrow.parquet.ParquetWriter``.

Crash durability: a Parquet file is only readable once its footer is
written, and ``ParquetWriter`` writes the footer in ``close()`` — a flush
alone does NOT make the file valid, so a crash/SIGKILL mid-run loses the
history back to the last finalized file. Two mitigations: ``rotate_groups``
(``--log-parquet-rotate``) closes and finalizes a part file every N row
groups and starts the next (``plant.parquet`` ->
``plant.part00000.parquet``, ``...part00001...``; ``tools/plot_history.py``
reads the whole part family), bounding loss to the open part; and
``--log-csv`` remains the line-buffered fully crash-safe option.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


class ParquetHistoryLogger:
    """Streaming Parquet sink: buffer rows, flush row groups of
    ``rows_per_group``, finalize on close. One fixed schema derived from
    ``fields`` (all float64 except listed ``int_fields``).

    ``rotate_groups``: close + finalize the current file every that many
    row groups and open the next sequential part file, so only the open
    part is at risk on a crash (see module docstring). ``None`` (default)
    disables rotation and writes a single file named exactly ``path`` that
    is readable only after a clean ``close()``.
    """

    def __init__(self, path: str, fields: List[str],
                 int_fields: Optional[List[str]] = None,
                 rows_per_group: int = 256,
                 rotate_groups: Optional[int] = None):
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover - env-dependent
            raise RuntimeError(
                "--log-parquet needs pyarrow (unavailable); use --log-csv"
            ) from e
        self._pa = pa
        self._pq = pq
        ints = set(int_fields or ())
        self.fields = list(fields)
        self._schema = pa.schema(
            [(f, pa.int64() if f in ints else pa.float64())
             for f in self.fields])
        self._rows_per_group = int(rows_per_group)
        self._rotate_groups = (int(rotate_groups)
                               if rotate_groups else None)
        self._buffer: List[Dict] = []
        self.path = path
        self._part = 0
        self._groups_in_part = 0
        self._writer = pq.ParquetWriter(self._current_path(), self._schema)

    def _current_path(self) -> str:
        if self._rotate_groups is None:
            return self.path
        root, ext = os.path.splitext(self.path)
        return f"{root}.part{self._part:05d}{ext or '.parquet'}"

    def log(self, row: Dict) -> None:
        self._buffer.append(row)
        if len(self._buffer) >= self._rows_per_group:
            self._flush()

    def _flush(self, rotate: bool = True) -> None:
        if not self._buffer:
            return
        cols = {f: [r.get(f) for r in self._buffer] for f in self.fields}
        self._writer.write_table(
            self._pa.table(cols, schema=self._schema))
        self._buffer.clear()
        self._groups_in_part += 1
        if (rotate and self._rotate_groups is not None
                and self._groups_in_part >= self._rotate_groups):
            self._writer.close()          # footer written; part is durable
            self._part += 1
            self._groups_in_part = 0
            self._writer = self._pq.ParquetWriter(self._current_path(),
                                                  self._schema)

    def close(self) -> None:
        self._flush(rotate=False)   # final close follows; no empty tail part
        self._writer.close()
