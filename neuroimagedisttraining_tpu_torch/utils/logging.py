"""Experiment logging: the reference's per-experiment log file
``LOG/<dataset>/<identity>.log`` (message-only lines) beside a JSONL
stream ``<identity>.metrics.jsonl`` with one record per ``metrics`` call
(``round``, seconds since the logger started, and the values). Every
numeric value of a record is also set in the metrics registry
(``obs/metrics.py``, ``nidt_exp_metric{key}``), so a ``/metrics`` scrape
sees what the JSONL file records."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping


class ExperimentLogger:
    """File log and JSONL metrics of one experiment identity."""

    def __init__(self, log_dir: str, dataset: str, identity: str):
        self.dir = os.path.join(log_dir, dataset)
        os.makedirs(self.dir, exist_ok=True)
        self.identity = identity
        self.log_path = os.path.join(self.dir, identity + ".log")
        self.jsonl_path = os.path.join(self.dir, identity + ".metrics.jsonl")
        self._log = logging.getLogger(f"nidt_torch.exp.{identity}")
        self._log.setLevel(logging.INFO)
        self._log.propagate = False
        # loggers are cached by name: drop the handlers an earlier logger of
        # the same identity left, or every line would be written twice
        self.close()
        fh = logging.FileHandler(self.log_path)
        fh.setFormatter(logging.Formatter("%(message)s"))
        self._log.addHandler(fh)
        self._t0 = time.monotonic()

    def metrics(self, round_idx: int, **values: Any) -> None:
        """Append one metrics record for a round and log it."""
        rec: dict[str, Any] = {"round": int(round_idx),
                               "t": round(time.monotonic() - self._t0, 3)}
        for k, v in values.items():
            rec[k] = _jsonable(v)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        publish_registry(round_idx, rec)
        self._log.info("round %d metrics: %s", round_idx,
                       {k: rec[k] for k in values})

    def close(self) -> None:
        for h in list(self._log.handlers):
            h.close()
            self._log.removeHandler(h)


def publish_registry(round_idx: int, rec: Mapping[str, Any]) -> None:
    """A metrics record's numbers as gauges (the last value wins) keyed
    by name, nested dicts flattened with ``_``, and the round in
    ``nidt_exp_round``."""
    from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
    from neuroimagedisttraining_tpu_torch.obs import names as obs_names

    g = obs_metrics.gauge(
        obs_names.EXP_METRIC,
        "per-round experiment metrics (ExperimentLogger.metrics)",
        labelnames=("key",))
    obs_metrics.gauge(
        obs_names.EXP_ROUND,
        "last round index ExperimentLogger.metrics recorded",
    ).set(int(round_idx))

    def put(prefix: str, v: Any) -> None:
        if isinstance(v, Mapping):
            for k2, v2 in v.items():
                put(f"{prefix}_{k2}", v2)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            g.labels(key=prefix).set(float(v))

    for k, v in rec.items():
        if k not in ("round", "t"):
            put(k, v)


def _jsonable(v: Any) -> Any:
    """Tensors and numpy values as Python numbers and lists."""
    if isinstance(v, Mapping):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "tolist"):
        return v.tolist()
    return v
