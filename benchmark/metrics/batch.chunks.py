"""Mean chunks a request dispatches over every route
(``kernels/batch.py``'s ``route_counts`` and checkpointed chunks, reset
before each request)."""


def read(run):
    rs = run.counted()
    return sum(r.chunks for r in rs) / len(rs) if rs else None
