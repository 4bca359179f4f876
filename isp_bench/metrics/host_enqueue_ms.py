"""host_enqueue_ms: the mean host time of BuiltPipeline.__call__ over the
window's calls, from the call to its return (no sync): the chain's
Python and launches."""


def read(r):
    return 1e3 * sum(r.enqueue_s) / len(r.enqueue_s) if r.enqueue_s else None
