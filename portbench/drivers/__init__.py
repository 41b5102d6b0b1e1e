"""The general traffic generator: one driver a kind of traffic, ``Driver`` in
``portbench/drivers/<kind>.py``, found by the ``kind`` that a traffic file
names and configured by that file's parameters and a configuration's sizes.

A driver builds the inputs from the seed (``portbench.scene``) and the
program's entry on them; ``warm_up`` runs its first units while recording
what the comparison needs (``readings``), then more to warm up; ``unit``
runs one unit of the window; ``counts`` gives (units run in the window,
units that failed); ``unit_flop`` the model's operations in one unit
(``portbench.work``). After the window ``release`` frees the program,
``reference`` recomputes the first units with the plain reference
(``portbench/reference/``), and ``compare`` gives the numbers held to the
cell's limits.
"""

from __future__ import annotations

import importlib
import os


def load(kind: str):
    """The ``Driver`` class of traffic kind ``kind``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{kind}.py")
    if kind.startswith("_") or not os.path.isfile(path):
        raise ValueError(f"no driver for traffic kind {kind!r}: {path}")
    return importlib.import_module(f"{__name__}.{kind}").Driver
