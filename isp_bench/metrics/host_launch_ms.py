"""host_launch_ms: the mean host time a recorded call of the pipeline (the
program's span isp_call) spends inside the hand-written kernels' C entries,
in ms: the program's span table (utils/profiling.span_table), which holds
the calls of the traced segment alone, since the program records only
while a torch.profiler session is active. Nothing where no call was
recorded, or where the program keeps no span table."""


def read(r):
    if r.trace is None:
        return None
    try:
        from raw_image_pipeline_tpu_torch.utils.profiling import CALL_SPAN, span_table
    except ImportError:
        return None
    table = span_table()
    call = table.get(CALL_SPAN)
    if call is None or not call.count:
        return None
    return 1e3 * sum(row.launch_s for row in table.values()) / call.count
