"""Mean seconds a request spends in the pipeline's merge call
(``batched_progressive_merge``: the device merge), by the benchmark's clock."""


def read(run):
    rs = [r.stages["progressive_merge"] for r in run.counted() if "progressive_merge" in r.stages]
    return sum(rs) / len(rs) if rs else None
