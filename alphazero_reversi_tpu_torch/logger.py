"""Logging and metrics: console, file, JSON lines and (optional) TensorBoard.

The port's own copy of ``alphazero_reversi_tpu/logger.py``: stdlib logging
to the console and ``<log_dir>/<run>/training.log``, a config snapshot per
run, and the same ``Logger`` surface. Every ``log_metrics`` call also
appends one JSON object ``{"step": ..., <name>: <value>, ...}`` to
``<run>/metrics.jsonl``, so a run's metrics are readable without
TensorBoard. With ``use_tensorboard`` the scalars, histograms
(``log_histogram``) and projector embeddings (``log_embedding``) also go to
a ``SummaryWriter`` when the ``tensorboard`` package is installed; where it
is not, the logger warns once and goes on with the JSON metrics.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict


class Logger:
    """Run logger: ``training.log``, ``metrics.jsonl`` and the config
    snapshot in ``<log_dir>/<run_name>``, plus the console if ``verbose``."""

    def __init__(self, log_dir: str, run_name: str = "run",
                 level: str = "INFO", use_tensorboard: bool = True,
                 verbose: bool = True, file_output: bool = True):
        """``file_output=False`` makes a logger that writes nothing: no run
        dir, ``training.log``, ``metrics.jsonl``, TensorBoard or snapshots;
        the console only, if ``verbose``. The ranks of a data-parallel run
        other than rank 0 log so, and rank 0 owns the files."""
        self.run_dir = os.path.join(os.path.abspath(log_dir), run_name)
        self.metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self._file_output = file_output
        if file_output:
            os.makedirs(self.run_dir, exist_ok=True)
        self._tb = None
        self._use_tb = use_tensorboard and file_output

        self.logger = logging.getLogger(f"alphazero_torch.{run_name}")
        self.logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        self.logger.handlers.clear()
        self.logger.propagate = False
        fmt = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        if file_output:
            fh = logging.FileHandler(os.path.join(self.run_dir,
                                                  "training.log"))
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)
        if verbose:
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            self.logger.addHandler(sh)
        if not self.logger.handlers:  # silent, not logging's last resort
            self.logger.addHandler(logging.NullHandler())

    # -- plain logging ----------------------------------------------------
    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self.logger.error(msg, *args)

    # -- tensorboard ------------------------------------------------------
    @property
    def writer(self):
        if self._tb is None and self._use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                self._use_tb = False  # warn once, then JSON metrics only
                self.warning("TensorBoard is unavailable (%s); metrics go "
                             "to %s only", e, self.metrics_path)
                return None
            self._tb = SummaryWriter(log_dir=self.run_dir)
        return self._tb

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        """Scalars to ``metrics.jsonl`` and TensorBoard, plus one info
        line."""
        items = {k: float(v) for k, v in metrics.items()}
        if self._file_output:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps({"step": step, **items}) + "\n")
        if self.writer is not None:
            for k, v in items.items():
                self.writer.add_scalar(k, v, step)
        self.info("step %d: %s", step,
                  ", ".join(f"{k}={v:.5g}" for k, v in items.items()))

    def log_histogram(self, tag: str, values, step: int) -> None:
        """A histogram of ``values`` (a tensor or array) to TensorBoard."""
        if self.writer is not None:
            self.writer.add_histogram(tag, values, step)

    def log_embedding(self, tag: str, embedding, metadata=None,
                      label_img=None, step: int = 0) -> None:
        """An ``[N, D]`` embedding (tensor or array) to TensorBoard's
        projector, with one ``metadata`` label per row."""
        if self.writer is not None:
            self.writer.add_embedding(embedding, metadata=metadata,
                                      label_img=label_img, tag=tag,
                                      global_step=step)

    def log_model_graph(self, graph_text: str) -> None:
        """The model's structure (the module's ``repr``) to
        ``model_graph.txt`` in the run dir and to TensorBoard as text."""
        if not self._file_output:
            return
        with open(os.path.join(self.run_dir, "model_graph.txt"), "w") as f:
            f.write(graph_text)
        self.log_text("model/graph", f"```\n{graph_text}\n```")

    def log_learning_rate(self, lr: float, step: int) -> None:
        """LR scalar (one optimizer group)."""
        if self.writer is not None:
            self.writer.add_scalar("lr/group_0", float(lr), step)

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        if self.writer is not None:
            self.writer.add_text(tag, text, step)

    def log_config(self, config_dict: Dict[str, Any]) -> None:
        """Config snapshot into the run dir."""
        if not self._file_output:
            return
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(config_dict, f, indent=2)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


def setup_logger(log_dir: str, run_name: str = "run", **kwargs) -> Logger:
    """Factory matching the JAX package's ``setup_logger``."""
    return Logger(log_dir, run_name, **kwargs)
