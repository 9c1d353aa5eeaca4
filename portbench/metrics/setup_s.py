"""Process start to the first timed request: imports, kernel load,
input generation and the capped warm-up request (host clock)."""


def read(run):
    return run.setup_s
