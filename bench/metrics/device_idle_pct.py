"""device_idle_pct: the share of wall time in which no operation ran on
the card, from torch.profiler over a steady stretch of the window (graph
rounds), both ends synchronised. Layer: device."""
UNIT = "%"


def read(run):
    s = run.profile.read() if run.profile is not None else None
    if not s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
