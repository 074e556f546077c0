"""setup_s: seconds from the start of run.py to the first timed query:
imports, the graph drawn on the card, the kernels loaded (built on a
checkout's first run) and the warm-up queries."""


def read(run):
    return run.setup_s
