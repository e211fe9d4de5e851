"""The 95th percentile of how late the open-loop generator sent a request
after it was due, in ms: a lagging generator shows here."""


def read(run):
    return run.record.get('lag_p95_ms')
