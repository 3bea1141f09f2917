"""From the process's start to the window's first item: the graph made from
the seed, the program's pack, kernel builds where the checkout has none,
and the warm-up (host clock)."""


def read(run):
    return run.setup_s
