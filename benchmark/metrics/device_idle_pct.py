"""device_idle_pct: the share of the traced work's time in which no kernel
or copy ran on the card: 1 - the union of the device intervals over that
time.

The time is the same work timed untraced where the kind timed it
(``work["wall_s"]``: the sweep, where tracing a cell of ~36 000 launches
adds about a third to its host time), else the traced stretch's length
(the transform calls, whose untraced time is too close to their busy time
to be read apart from it: there the share includes the tracer's own
cost)."""


def read(ctx):
    t, w = ctx["trace"], ctx["work"]
    span = w.get("wall_s") or t.get("window_s")
    if not span or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / span)
