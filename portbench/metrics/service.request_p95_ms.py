"""The 95th percentile of every request completed in the traced window,
each timed on the host clock from the call into the entry to its return.
In the closed-loop serve cells this tail swings too widely between runs to
hold a bound end to end (``request_ms_p95``), so it is read here."""

from pb.stats import latencies_ms, percentile


def read(run):
    rec = run.window["records"]
    return percentile(latencies_ms(rec), 95.0) if rec else None
