"""The token step's prefill-chunk pass at the width of the lanes that
prefill, recorded as one CUDA graph a lane bucket and replayed on every
step that carries a chunk.

A chunked paged serve runs a prefill chunk in almost every step, through
every layer, but only a few of its lanes prefill at once.  The stepper
packs the lanes that prefill into the first rows of a chunk as wide as
the narrowest lane BUCKET that holds them (`lane_buckets`: the powers of
two below ``n_lanes``, then ``n_lanes``), and the chunk's lane map says
which lane each row is; the rows past them are idle (position -1,
writes into the garbage page) and map to the sink past the last lane.
The pass gathers its rows' page-table rows through the map and returns
the first tokens in lane space.

Launched op by op, the chunk's dispatch costs the host about as long as
the card spends on it.  `ChunkGraph` records the pass (`serving.engine.make_token_step`'s ``chunk_pass``:
the page-table gather, the embedding gather, every segment's chunk, the
last-row pick, the head, its argmax and the scatter to lane space) on
one pool, once a bucket, and replays the bucket of the step: before each
replay the step's `PrefillChunk` and page table are copied, device to
device, into that graph's own input tensors; the first tokens are read
from its output tensor.  The graphs write the pool's leaves in place, as
the eager pass does, and run the same kernels on the same shapes.

The replay runs on a stream of its own, after what the step queued
before it, and the step queues its decode meanwhile: the token step
begins the chunk before the decode and takes its tokens after it
(`ChunkGraph.run` returns the function that makes the step's stream wait
for the replay).  The two touch other pages: a lane that prefills does
not decode, and what both write to the garbage page is at position -1.
So the card runs the chunk while the host dispatches the decode and
reads its gates, and the step ends when the later of the two does.  The
buckets' graphs share that stream and the page-table input, and one
replays at a time.

The recordings run the pass on idle chunks (every row at position -1,
every write into the garbage page): once eagerly on the stream, at the
widest bucket, as PyTorch's CUDA graphs ask (the kernels load, cuBLAS
gets its workspace on that stream, a split kernel its tickets, which
every narrower bucket's launch finds too), then each bucket under
capture on that stream, widest first, and each graph replays once, so
that the first replay of a serve is not the graph's first.  A recording
changes no lane's state, reads nothing back on the host and uploads
nothing.  A graph holds the addresses of the pool it was recorded on:
it keeps those leaves alive and serves that pool alone (`pool_key`).

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

__all__ = ["ChunkGraph", "idle_chunk", "lane_bucket", "lane_buckets",
           "pool_key"]


def lane_buckets(n_lanes: int) -> tuple[int, ...]:
    """The chunk's widths in lanes: the powers of two below ``n_lanes``,
    then ``n_lanes``."""
    out = []
    b = 1
    while b < n_lanes:
        out.append(b)
        b *= 2
    return (*out, n_lanes)


def lane_bucket(k: int, n_lanes: int) -> int:
    """The narrowest bucket of `lane_buckets` that holds ``k`` lanes (the
    narrowest of all for none)."""
    return next(b for b in lane_buckets(n_lanes) if b >= k)


def pool_key(caches) -> tuple:
    """The address of every leaf of ``caches``: what a graph recorded on
    them reads and writes."""
    return tuple(leaf.data_ptr() for leaf in tree_leaves(caches))


def idle_chunk(rows: int, width: int, n_lanes: int,
               device) -> PrefillChunk:
    """A chunk of ``rows`` rows in which no lane prefills (as the
    stepper's idle chunk): rows at position -1, writes into the garbage
    page 0, every row mapped to the sink lane ``n_lanes``; made on the
    device, with no upload."""
    def full(shape, fill=0, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return PrefillChunk(
        tok=full((rows, width)), pos=full((rows, width), -1),
        dest_page=full((rows, width)), dest_slot=full((rows, width)),
        start=full((rows,)), last_idx=full((rows,)),
        emit=full((n_lanes,), False, torch.bool),
        active=full((rows,), False, torch.bool),
        lane=full((rows,), n_lanes))


def _warm(fn, side):
    """``fn()`` run once on the stream ``side``, its launches not
    counted: what a recording there needs first."""
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    with build.held_launches(), torch.cuda.stream(side):
        fn()
    main.wait_stream(side)


def _record(fn, side):
    """``fn()`` recorded on the stream ``side`` as a CUDA graph, after
    `_warm` there: (graph, what ``fn`` returned under capture, the
    launches the wrappers reported under capture, which do not count)."""
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with build.held_launches() as held, torch.cuda.stream(side):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    return graph, out, held


class _Bucket:
    """One bucket's graph: the pass recorded on chunks of ``rows`` rows,
    with its own chunk input and first-token output."""

    def __init__(self, chunk_pass, caches, table, rows: int, n_lanes: int,
                 width: int, stream, device):
        self.chunk = idle_chunk(rows, width, n_lanes, device)
        self.graph, self.t0, self.launches = _record(
            lambda: chunk_pass(caches, table, self.chunk), stream)
        # a split launch's tickets, at the address the graph holds
        self.tickets = build.ticket_buffers()
        self.graph.replay()


class ChunkGraph:
    """``chunk_pass(caches, page_table, chunk) -> t0`` recorded on the
    pool ``caches`` once for each bucket of `lane_buckets` (``n_lanes``),
    for chunks ``width`` rows deep and page tables ``table_width``
    wide."""

    def __init__(self, chunk_pass, caches, n_lanes: int, width: int,
                 table_width: int, device):
        self.key = pool_key(caches)
        self.pool = tree_leaves(caches)       # the graphs write these
        self.table = torch.zeros((n_lanes, table_width), dtype=torch.int32,
                                 device=device)
        self.stream = torch.cuda.Stream(device)
        widest = idle_chunk(n_lanes, width, n_lanes, device)
        _warm(lambda: chunk_pass(caches, self.table, widest), self.stream)
        self.buckets = {
            rows: _Bucket(chunk_pass, caches, self.table, rows, n_lanes,
                          width, self.stream, device)
            for rows in sorted(lane_buckets(n_lanes), reverse=True)}

    def run(self, page_table: torch.Tensor, chunk: PrefillChunk):
        """Replay the graph of ``chunk``'s bucket on ``chunk`` and
        ``page_table``, on the graphs' stream after the work queued so
        far on the current one.  Returns the function that makes the
        current stream wait for the replay, and reports its launches,
        and gives the first tokens (n_lanes,) i32: the graph's output
        tensor, which its next replay overwrites."""
        bucket = self.buckets[chunk.tok.shape[0]]
        main = torch.cuda.current_stream(self.stream.device)
        self.table.copy_(page_table)
        for mine, theirs in zip(bucket.chunk, chunk):
            mine.copy_(theirs)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            bucket.graph.replay()

        def finish():
            main.wait_stream(self.stream)
            build.replay_launches(bucket.launches)
            return bucket.t0

        return finish
