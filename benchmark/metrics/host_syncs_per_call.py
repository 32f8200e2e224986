"""Host calls that wait for the card (stream, device and event
synchronizes, blocking copies) made inside the program's spans, a traced
call: each pageable upload, ``.cpu()`` or ``.item()`` inside a call."""

from benchmark.program_spans import host_syncs_per_call


def read(run):
    return host_syncs_per_call(run)
