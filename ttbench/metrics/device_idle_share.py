"""Device: the share of the profiled span A with no kernel, copy or set
running on the card, in percent."""

from ttbench.lib.layer import profile


def read(run):
    phase = profile(run)
    a = phase.profile.get("a") if phase else None
    if not a or a["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - a["busy_s"] / a["window_s"])
