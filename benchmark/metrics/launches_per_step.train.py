"""Device operations the profiler saw in the traced training window, per
train step (forward, backward and the update)."""


def read(run):
    t = run.get("trace")
    n = run.get("work", {}).get("steps")
    if t is None or not n or t.n_device_events == 0:
        return None
    return t.launches() / n
