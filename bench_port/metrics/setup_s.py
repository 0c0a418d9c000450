"""Process start to the first timed step, s."""


def read(run):
    return run.setup_s
