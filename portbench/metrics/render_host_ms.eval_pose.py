"""Host milliseconds a pose step in the render pass of the pose loss
(``copenerf.render`` under ``copenerf.pose.loss``), inclusive, from the
spans stretch."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "eval_pose", "copenerf.render",
                         "copenerf.pose.loss")
