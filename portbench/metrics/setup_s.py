"""Process start to the window's first step: imports, the kernels'
library, the inputs, the program's set-up and the warm-up."""


def read(run):
    return run.setup_s
