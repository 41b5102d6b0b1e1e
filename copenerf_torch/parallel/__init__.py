"""Data parallelism over GPUs, one process per card (port of
``copenerf_tpu/parallel/``): ``distributed`` joins the processes and
reduces gradients, ``mesh`` splits and gathers the ray axis."""
