"""Mean seconds a request spends in Python's garbage collector
(``gc.callbacks``)."""


def read(run):
    rs = run.counted()
    return sum(r.gc_s for r in rs) / len(rs) if rs else None
