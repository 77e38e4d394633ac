"""Set-up: from the process's start to the first timed step (host clock).
Building the kernels, making the inputs, the program's first steps and the
warm-up all count."""


def read(run):
    return run.setup_s
