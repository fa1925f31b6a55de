"""Token step (`serving/runtime/scheduler.py`'s chunk build,
`serving/runtime/chunk_graph.py`): the prompt rows the window's chunk
steps computed over the rows they launched, in percent.  A program that
launches its chunk at the width of the lanes that prefill writes both on
each step's ``counter`` event (``chunk_rows``, ``chunk_rows_launched``).
On a program whose events lack them, every chunk is ``n_lanes x
prefill_chunk`` rows (the fixed shape it launches): the launched rows are
that times the window's steps that carried a chunk (a ``prefill_chunk``
event between a step's ``counter`` event and the one before), and the
prompt rows the ``width`` of those events."""


def read(run):
    rows = launched = 0             # from the counters
    widths = chunk_steps = 0        # from the chunk events
    seen = False
    step_widths = 0
    for t, kind, _, _, d in run.events or ():
        if t > run.seconds:
            break
        if kind == "prefill_chunk":
            step_widths += d["width"]
        elif kind == "counter":
            if "chunk_rows_launched" in d:
                seen = True
                rows += d["chunk_rows"]
                launched += d["chunk_rows_launched"]
            widths += step_widths
            chunk_steps += step_widths > 0
            step_widths = 0
    if not seen:
        rows = widths
        launched = chunk_steps * run.n_lanes \
            * run.cell.config["serving"]["prefill_chunk"]
    return 100.0 * rows / launched if launched else None
