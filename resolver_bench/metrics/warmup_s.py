"""warmup_s: the engine's build and the warm-up of the programs this
traffic uses, the program's own share of setup_s (host clock)."""


def read(run):
    return run.warmup_s
