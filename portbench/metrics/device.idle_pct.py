"""1 - (union of the device's kernel and copy intervals) / wall time of the
profiled slice, % (pb.trace)."""


def read(run):
    return run.profile["idle_pct"] if run.profile else None
