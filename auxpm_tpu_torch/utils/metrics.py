"""JSONL metrics / observability (stdlib only).

Counterpart of ``auxpm_tpu/utils/metrics.py``: per-window metrics written as
one JSON line each: shrink and probe counts (sampler health), log L̂ mean
(estimator health), wall-clock.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

logger = logging.getLogger("auxpm_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(asctime)s auxpm] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("AUXPM_LOGLEVEL", "INFO"))


class MetricsWriter:
    """Append-only JSONL metrics file (no file when ``path`` is None);
    ``quiet`` also keeps the records out of the log (the ranks of a sharded
    run that do not report)."""

    def __init__(self, path=None, quiet=False):
        self.path = path
        self.quiet = quiet
        self.t0 = time.time()
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def write(self, record: dict):
        record = {"t": round(time.time() - self.t0, 3), **record}
        if self._fh:
            self._fh.write(json.dumps(record, default=float) + "\n")
            self._fh.flush()
        if self.quiet:
            return
        logger.info(
            " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
            )
        )

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
