"""Experiment logging: the reference's per-experiment log file
``LOG/<dataset>/<identity>.log`` (message-only lines: the resolved config
first, then the engine's announcements and the round metrics), echoed to
stdout unless ``console=False``, beside a JSONL stream
``<identity>.metrics.jsonl`` with one record per ``metrics`` call
(``round``, seconds since the logger started, and the values). Every
numeric value of a record is also set in the metrics registry
(``obs/metrics.py``, ``nidt_exp_metric{key}``), so a ``/metrics`` scrape
sees what the JSONL file records. ``get_logger`` is the console logger
with the process id in each line."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Mapping


def get_logger(name: str = "nidt", process_id: int = 0) -> logging.Logger:
    """Console logger with the process id in the format (the original
    code's fedml_api/utils/logger.py:7-33)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            f"[p{process_id}] %(asctime)s %(levelname)s %(name)s: "
            "%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class ExperimentLogger:
    """File log and JSONL metrics of one experiment identity; its lines
    are echoed to stdout unless ``console=False``."""

    def __init__(self, log_dir: str, dataset: str, identity: str,
                 console: bool = True):
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
        if console:
            ch = logging.StreamHandler(sys.stdout)
            ch.setFormatter(logging.Formatter("%(message)s"))
            self._log.addHandler(ch)
        self._t0 = time.monotonic()

    def info(self, msg: str, *args: Any) -> None:
        self._log.info(msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self._log.warning(msg, *args)

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
