"""Strategy (`strategy/`, `core/`): segments the strategies probed
(``seg_policy``) per token emitted, over the window's steps."""

from ttbench.lib.layer import logged_steps


def read(run):
    steps = logged_steps(run)
    tokens = sum(int(s.emit.sum()) for s in steps)
    return sum(s.seg_policy for s in steps) / tokens if tokens else None
