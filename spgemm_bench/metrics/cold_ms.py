"""The window's cold calls' summed time over their number (host clock):
each call from a host CSR to C on the host."""


def read(run):
    if not run.calls:
        return None
    return 1e3 * sum(c["end"] - c["start"] for c in run.calls) \
        / len(run.calls)
