"""Syncs a train step: copies from the card to the host launched under
``copenerf.step``, in the profiled stretch (each one waits for the card)."""

from portbench import spans


def read(run):
    lay = spans.layers(run)
    if run.kind != "train" or lay is None or run.units <= 0:
        return None
    spans.report(run)
    return lay.by_span().get(spans.STEP, {}).get("syncs", 0) / run.units
