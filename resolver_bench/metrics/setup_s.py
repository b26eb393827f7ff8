"""setup_s: process start to the window's start: imports, the traffic,
the engine's build and warm-up, the prefill (host clock)."""


def read(run):
    return run.setup_s
