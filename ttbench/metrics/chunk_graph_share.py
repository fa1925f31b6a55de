"""Token step (`serving/runtime/chunk_graph.py`, `serving/engine.py`):
the share of the window's steps that carried a prefill chunk whose chunk
pass was a CUDA graph's replay, in percent.  A step carried a chunk if a
``prefill_chunk`` event falls inside it (between its ``counter`` event
and the one before); the replays are the ``chunk_graph_replays`` field
of the tracer's ``counter`` events, which only a program that graphs its
chunk pass writes."""


def read(run):
    chunk_steps = replays = 0
    seen = carried = False
    for t, kind, _, _, d in run.events or ():
        if t > run.seconds:
            break
        if kind == "prefill_chunk":
            carried = True
        elif kind == "counter":
            if "chunk_graph_replays" in d:
                seen = True
                replays += d["chunk_graph_replays"]
            chunk_steps += carried
            carried = False
    if not seen or not chunk_steps:
        return None
    return 100.0 * replays / chunk_steps
