"""peak_device_mib: the caching allocator's peak, torch.cuda.max_memory_allocated(),
over set-up and the window (reset at the start of the run), without the
outputs of the batch the check keeps (run.Stream.peak_bytes), in MiB:
what the ISP takes from the networks that share its card."""


def read(r):
    return r.peak_bytes / 2**20 if r.peak_bytes else None
