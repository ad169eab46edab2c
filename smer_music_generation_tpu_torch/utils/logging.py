"""Logging + metrics utilities.

``logger_init`` mirrors the reference's file+console pattern
(``log.py:6-25``; ``coloredlogs`` is replaced by a plain formatter).
``MetricsLogger`` is the wandb-replacement: scalar metrics appended as
JSONL so runs are machine-readable without external services
(reference logs through ``wandb.log``, ``train.py:819-880``).

Host copy of ``smer_music_generation_tpu/utils/logging.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

_FORMAT = "%(asctime)s : %(levelname)s : %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def logger_init(logfile: Optional[str] = None, append: bool = False, name: str = "smer") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.handlers = []
    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter(_FORMAT, datefmt=_DATEFMT)

    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(formatter)
    logger.addHandler(console)

    if logfile:
        os.makedirs(os.path.dirname(os.path.abspath(logfile)), exist_ok=True)
        fh = logging.FileHandler(logfile, mode="a" if append else "w")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class RunIdentity:
    """wandb-style run identity + resume semantics without the service.

    The reference resumes a run by wandb id with a config override
    (``train.py:202-222``).  Here a ``run.json`` beside the metrics file
    records {run_id, config, resume history}; re-opening the same output
    dir RESUMES the run (same id, a resume record appended), and a config
    that differs from the recorded one is surfaced as a diff so silent
    config drift across resumes cannot happen.
    """

    def __init__(self, output_dir: str, config: Optional[Dict] = None,
                 logger: Optional[logging.Logger] = None):
        import uuid

        self.path = os.path.join(output_dir, "run.json")
        os.makedirs(output_dir, exist_ok=True)
        self.config_diff: Dict[str, tuple] = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                meta = json.load(f)
            self.run_id = meta["run_id"]
            self.resumed = True
            old = meta.get("config") or {}
            # config=None means "no override" (meta keeps its config), so
            # it must not diff as every-key-changed-to-None
            new = config if config is not None else old
            for k in sorted(set(old) | set(new)):
                if old.get(k) != new.get(k):
                    self.config_diff[k] = (old.get(k), new.get(k))
            meta.setdefault("resumes", []).append(
                {"time": time.time(),
                 "config_diff": {k: list(v) for k, v in self.config_diff.items()}}
            )
            if config:
                meta["config"] = config  # override wins, like wandb resume
        else:
            self.run_id = uuid.uuid4().hex[:8]
            self.resumed = False
            meta = {"run_id": self.run_id, "created": time.time(),
                    "config": config or {}, "resumes": []}
        with open(self.path, "w") as f:
            json.dump(meta, f, indent=2)
        if logger and self.resumed:
            logger.info(f"resuming run {self.run_id}")
            for k, (a, b) in self.config_diff.items():
                logger.warning(f"config override on resume: {k}: {a!r} -> {b!r}")


def _json_ok(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


class MetricsLogger:
    """Append-only JSONL scalar metrics sink."""

    def __init__(self, path: Optional[str] = None, run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self._fh is None:
            return
        record = {"_time": time.time()}
        if self.run_id is not None:
            record["_run"] = self.run_id
        if step is not None:
            record["_step"] = int(step)
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        try:
            line = json.dumps(record)
        except TypeError:
            # non-serializable values (arrays, objects) must degrade, not
            # kill the training step that logged them
            line = json.dumps(
                {k: v if _json_ok(v) else repr(v) for k, v in record.items()}
            )
        self._fh.write(line + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
