"""frames_per_s: every frame whose batch completed inside the window, over
the window's seconds (host clock)."""


def read(r):
    return r.frames / r.seconds
