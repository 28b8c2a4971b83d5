"""From the start of the process to the start of the window: imports,
scene build, kernel builds and the warm-up frames."""


def read(run):
    return run.setup_s
