"""Set-up: from the process's start to the window's, the environment
made, the caps tuned, the kernels built or loaded and one member run."""


def read(rec):
    return rec.setup_s
