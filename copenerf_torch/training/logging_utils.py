"""Scalar/metrics logging (port copy of
``copenerf_tpu/training/logging_utils.py``).

The reference logs to tensorboardX (``train.py:96,125-141``). Here the
primary sink is an append-only JSONL file (works everywhere, greppable);
TensorBoard is attached when the package is importable.
"""

from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, out_dir: str, enabled: bool = True):
        """``enabled=False`` makes every method a no-op — used by
        non-primary processes in multi-host training so N processes don't
        append interleaved lines to the same scalars.jsonl."""
        self._f = None
        self._tb = None
        if not enabled:
            return
        self.log_dir = os.path.join(out_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter  # optional

            self._tb = SummaryWriter(self.log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int):
        if self._f is not None:
            self._f.write(json.dumps({"t": time.time(), "tag": tag,
                                      "value": float(value),
                                      "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self):
        if self._f is not None:
            self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
