"""Slots the bucketed plan lays out over the products it holds: the
plan's own counters (``BucketPlan.stats()``: ``area_slots`` and
``intprod``), read from the state the benchmark holds."""


def read(run):
    st = run.counters.get("plan", {})
    if st.get("engine") != "bucketed" or not st.get("intprod"):
        return None
    return st["area_slots"] / st["intprod"]
