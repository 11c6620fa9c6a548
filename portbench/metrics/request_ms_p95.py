"""The 95th percentile of every request completed in the window, each timed
on the host clock from the call into the entry to its return."""

from pb.stats import latencies_ms, percentile


def read(run):
    rec = run.window["records"]
    return percentile(latencies_ms(rec), 95.0) if rec else None
