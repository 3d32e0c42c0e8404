"""Process start to the first timed op: imports, keys and traffic, the
bulk load and the warm-up."""


def read(run):
    return run["setup"]["setup_s"]
