"""host_python_ms: the mean host time a recorded call of the pipeline (the
program's span isp_call) spends outside the hand-written kernels' C
entries, in ms: Python, PyTorch's own dispatch (the packs' stacks, the
allocations) and the spans themselves. From the program's span table
(utils/profiling.span_table), filled only while a torch.profiler session
is active, so over the traced segment's calls. Nothing where no call was
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
    launches = sum(row.launch_s for row in table.values())
    return 1e3 * (call.total_s - launches) / call.count
