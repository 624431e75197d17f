"""Experiment tracking (reference: MLFlowTracker, trn_utils.py:216-312).

Logs flattened config params, EMA-smoothed batch losses, and epoch
metrics. Uses mlflow when importable; otherwise writes an
mlflow-compatible local layout: ``{tmp}/tracking/{exp}/{uid}/params.json``
plus a ``metrics.jsonl`` stream — the same information, greppable.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class Tracker:
    def __init__(self, cfg, uid: str, enabled: bool = True):
        """enabled=False makes every method a no-op — tracking is a
        rank-0-only side effect (ref exec_func_if_main_proc +
        MLFlowTracker, trn_utils.py:124-129,216-312): every rank starting
        an mlflow run would create N duplicate runs per experiment."""
        self.cfg = cfg
        self.uid = uid
        self.enabled = enabled
        self._mlflow = None
        self._metrics_f = None
        if not enabled:
            return
        exp_name = f"{cfg.expm.exp_name}_{cfg.task_type}"
        try:  # pragma: no cover - mlflow not present in hermetic env
            import mlflow

            mlflow.set_experiment(exp_name)
            mlflow.start_run(run_name=uid)
            self._mlflow = mlflow
        except Exception:
            pass
        self.dir = Path(cfg.misc.tmp_path) / "tracking" / exp_name / uid
        self.dir.mkdir(parents=True, exist_ok=True)
        self._metrics_f = open(self.dir / "metrics.jsonl", "a")

    def log_params(self, flat_params: Dict):
        if not self.enabled:
            return
        with open(self.dir / "params.json", "w") as f:
            json.dump({k: str(v) for k, v in flat_params.items()}, f, indent=0)
        if self._mlflow:
            items = list(flat_params.items())
            for i in range(0, len(items), 100):  # mlflow 100-key chunks
                self._mlflow.log_params(
                    {k: str(v)[:250] for k, v in items[i : i + 100]}
                )

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None):
        if not self.enabled:
            return
        rec = {"ts": time.time(), "step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()
        if self._mlflow:
            self._mlflow.log_metrics(
                {k: float(v) for k, v in metrics.items()}, step=step
            )

    def log_artifact(self, path):
        if self._mlflow:
            self._mlflow.log_artifact(str(path))

    def end_run(self):
        if self._metrics_f is not None:
            self._metrics_f.close()
        if self._mlflow:
            self._mlflow.end_run()
