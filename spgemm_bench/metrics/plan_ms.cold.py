"""Mean time of ``pipeline.prepare_*_state`` (the host planners,
``ops/bucketed.plan_buckets`` or ``ops/blockdense.plan_blockdense``) over
the traced run's cold calls: the benchmark's ``plan`` span (host
clock)."""


def read(run):
    s = run.spans.get("plan")
    return 1e3 * sum(s) / len(s) if s else None
