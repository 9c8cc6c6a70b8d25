"""Mean time of ``pipeline.choose_engine`` over the traced run's cold
calls: the benchmark's ``route`` span around it (host clock)."""


def read(run):
    s = run.spans.get("route")
    return 1e3 * sum(s) / len(s) if s else None
