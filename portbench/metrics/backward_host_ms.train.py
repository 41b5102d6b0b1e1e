"""Host milliseconds a train step in ``total.backward()``
(``copenerf.step.backward``, the autograd engine's thread included, as the
step's thread waits for it), less the host side of the kernel launches in
it (``copenerf.kernel.*``: K1-bwd's span holds the wait for K1-bwd at its
unpack), from the spans stretch. The backward's other sync waits for the
card too, so it is read only where the card idles much of a step
(``tanks_family.train_s1``)."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "train", "copenerf.step.backward",
                         less=spans.KERNEL)
