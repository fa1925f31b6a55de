"""The token step's prefill-chunk pass, recorded once as a CUDA graph and
replayed on every step that carries a chunk.

A chunked paged serve runs a prefill chunk in almost every step, always
at the shape ``(n_lanes, prefill_chunk)`` (the stepper pads every lane)
and through every layer.  Launched op by op, the chunk's dispatch costs
the host about as long as the card spends on it.  `ChunkGraph` records
the pass (`serving.engine.make_token_step`'s ``chunk_pass``: the
embedding gather, every segment's chunk, the last-row pick, the head and
its argmax) on one pool, and replays it: before each replay the step's
`PrefillChunk` and page table are copied, device to device, into the
graph's own input tensors; the first tokens are read from its output
tensor.  The graph writes the pool's leaves in place, as the eager pass
does, and runs the same kernels on the same shapes.

The replay runs on a stream of its own, after what the step queued
before it, and the step queues its decode meanwhile: the token step
begins the chunk before the decode and takes its tokens after it
(`ChunkGraph.run` returns the function that makes the step's stream wait
for the replay).  The two touch other pages: a lane that prefills does
not decode, and what both write to the garbage page is at position -1.
So the card runs the chunk while the host dispatches the decode and
reads its gates, and the step ends when the later of the two does.

The recording runs the pass on an idle chunk (every row at position -1,
every write into the garbage page), once eagerly on a side stream, as
PyTorch's CUDA graphs ask (the kernels load, cuBLAS gets its workspace on
that stream, a split kernel its tickets), then under capture on that
stream, then replays it once, so that the first replay of a serve is not
the graph's first.  It changes no lane's state, reads nothing back on
the host and uploads nothing.  A graph holds the addresses of the pool
it was recorded on: it keeps those leaves alive and serves that pool
alone (`pool_key`).

The kernels' wrappers count and report a launch when they are called,
which under capture launches nothing: the recording holds back what they
report (`kernels.build.held_launches`) and each replay counts and reports
it again (`kernels.build.replay_launches`), so the ``launches`` counters
and the launch recorders see one launch a layer a chunk step, as with
the eager pass.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import PrefillChunk
from repro_torch.models.param import tree_leaves

__all__ = ["ChunkGraph", "idle_chunk", "pool_key"]


def pool_key(caches) -> tuple:
    """The address of every leaf of ``caches``: what a graph recorded on
    them reads and writes."""
    return tuple(leaf.data_ptr() for leaf in tree_leaves(caches))


def idle_chunk(lanes: int, width: int, device) -> PrefillChunk:
    """A chunk in which no lane prefills (as the stepper's idle chunk):
    rows at position -1, writes into the garbage page 0; made on the
    device, with no upload."""
    def full(shape, fill=0, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return PrefillChunk(
        tok=full((lanes, width)), pos=full((lanes, width), -1),
        dest_page=full((lanes, width)), dest_slot=full((lanes, width)),
        start=full((lanes,)), last_idx=full((lanes,)),
        emit=full((lanes,), False, torch.bool),
        active=full((lanes,), False, torch.bool))


def _record(fn, side):
    """``fn()`` run once on the stream ``side``, then recorded there as a
    CUDA graph: (graph, what ``fn`` returned under capture, the launches
    the wrappers reported under capture).  Neither run's launches
    count."""
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with build.held_launches(), torch.cuda.stream(side):
        fn()
        with build.held_launches() as held:
            graph.capture_begin()
            try:
                out = fn()
            finally:
                graph.capture_end()
    main.wait_stream(side)
    return graph, out, held


class ChunkGraph:
    """``chunk_pass(caches, page_table, chunk) -> t0`` recorded on the
    pool ``caches`` for chunks of ``lanes`` x ``width`` rows and page
    tables ``table_width`` wide."""

    def __init__(self, chunk_pass, caches, lanes: int, width: int,
                 table_width: int, device):
        self.key = pool_key(caches)
        self.pool = tree_leaves(caches)       # the graph writes these
        self.chunk = idle_chunk(lanes, width, device)
        self.table = torch.zeros((lanes, table_width), dtype=torch.int32,
                                 device=device)
        self.stream = torch.cuda.Stream(device)
        self.graph, self.t0, self.launches = _record(
            lambda: chunk_pass(caches, self.table, self.chunk), self.stream)
        # a split launch's tickets, at the address the graph holds
        self.tickets = build.ticket_buffers()
        self.graph.replay()

    def run(self, page_table: torch.Tensor, chunk: PrefillChunk):
        """Replay on ``chunk`` and ``page_table``, on the graph's stream
        after the work queued so far on the current one.  Returns the
        function that makes the current stream wait for the replay, and
        reports its launches, and gives the first tokens (B,) i32: the
        graph's output tensor, which the next replay overwrites."""
        main = torch.cuda.current_stream(self.stream.device)
        self.table.copy_(page_table)
        for mine, theirs in zip(self.chunk, chunk):
            mine.copy_(theirs)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.graph.replay()

        def finish():
            main.wait_stream(self.stream)
            build.replay_launches(self.launches)
            return self.t0

        return finish
