"""Mean seconds a request spends in the pipeline's all-pairs call
(``batched_all_pairs``), by the benchmark's clock around it."""


def read(run):
    rs = [r.stages["all_pairs"] for r in run.counted() if "all_pairs" in r.stages]
    return sum(rs) / len(rs) if rs else None
