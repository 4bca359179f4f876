"""setup_s: from the process's start to the first timed batch (imports,
the card's start, the frames, the pipeline's build with its host tables,
the kernels' library, the warm-up)."""


def read(r):
    return r.setup_s
