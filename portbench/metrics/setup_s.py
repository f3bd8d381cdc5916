"""setup_s (s): process start to the window's opening -- imports, the
kernel libraries (built on a checkout's first run), seeded weights on the
card, packing, the engine, and the warm-up to steady state."""


def read(run):
    return run.setup_s
