"""The share of the untraced step time in which the card idles while the
host is in the step's glue: ``device_idle_pct.train``'s reading times the
share of the profiled stretch's idle time put down to a program span under
``copenerf.step`` and under no ``copenerf.kernel.*`` span."""

from portbench import spans
from portbench.metrics._common import idle_pct


def read(run):
    lay = spans.layers(run)
    idle = idle_pct(run, "train")
    if lay is None or idle is None:
        return None
    spans.report(run)
    share = lay.glue_idle_share()
    return None if share is None else idle * share
