"""Token step (`serving/engine.py`): the lane probes the strategies
asked for (``seg_policy``) over the lane slots the launched segments
computed (``seg_batch`` times the lanes), in percent, over the window's
steps.  The rest is work a lane-granular dispatch would not do."""

from ttbench.lib.layer import logged_steps


def read(run):
    steps = logged_steps(run)
    launched = sum(s.seg_batch for s in steps) * run.n_lanes
    probed = sum(s.seg_policy for s in steps)
    return 100.0 * probed / launched if launched else None
