"""Capacity cache of the PyTorch port: persist the per-row nnz(C) counts
(``crow``) an engine learns on its first call, so a later process warms
its plan on the host and its first call takes the warm path (no readback
of the counts).  The port's counterpart of
``mh_spgemm_tpu/bench/plan_cache.py``.

A fresh plan is warmed through ``ops/bucketed.warm_plan_from_crow`` or
``ops/blockdense.warm_blockplan_from_crow``, the same functions the first
call's readback runs.  Records are keyed by the matrix (name, shape, nnz
and a digest of its pattern), the engine, every config field that shapes
the port's plans, the device type and a planner version salt, so a stale
or foreign record can only miss.  A broken record is a miss, never a
failure.

Records are looked up in, and saved to, ``$MHSPGEMM_PLAN_CACHE``, then
``~/.cache/mh_spgemm_torch/plan_cache``.  The JAX package's committed
records (``data/plan_cache/``) were learned by its own planner under its
own key, which no port record can match: the port neither reads them
nor writes there.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

# Bump when the port's plan_buckets / plan_blockdense change class or
# capacity semantics: orphans every existing record.
PLAN_CACHE_VERSION = "torch-1"

_HOME_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                         "mh_spgemm_torch", "plan_cache")


def _dirs() -> list:
    env = os.environ.get("MHSPGEMM_PLAN_CACHE")
    return ([env] if env else []) + [_HOME_DIR]


def _pattern_digest(A) -> str:
    """Digest of a CSR pattern: all of ``ptr`` and a fixed sample of
    ``col``."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(A.ptr, np.int64)).tobytes())
    col = np.asarray(A.col)
    step = max(1, col.size // 4096)
    h.update(np.ascontiguousarray(col[::step].astype(np.int64)).tobytes())
    return h.hexdigest()[:16]


def cache_key(name: str, A, engine: str, config, device) -> str:
    """Key of a record: the matrix, the engine, the port's plan-shaping
    config fields, the device type and the version salt."""
    parts = (PLAN_CACHE_VERSION, name, A.M, A.N, A.nnz, _pattern_digest(A),
             engine, config.value_dtype, config.min_bucket_width,
             config.bucket_area_cap, config.dma_fill, config.esc_tail,
             config.ozaki, config.planned, torch.device(device).type)
    return hashlib.sha1(repr(parts).encode()).hexdigest()[:24]


def _find(key: str) -> Optional[str]:
    for d in _dirs():
        p = os.path.join(d, f"{key}.npz")
        if os.path.exists(p):
            return p
    return None


def try_warm(state, name: str, A, engine: str, config) -> bool:
    """Warm ``state.plan`` (a bucketed or block-dense state that has not
    run) from a cached record.  Returns True on a hit."""
    path = _find(cache_key(name, A, engine, config, state.device))
    if path is None:
        return False
    try:
        with np.load(path) as z:
            crow = z["crow"]
            if crow.shape[0] != state.plan.m:
                return False
            if engine == "bucketed":
                from ..ops.bucketed import warm_plan_from_crow
                warm_plan_from_crow(state.plan, crow)
            elif engine == "blockdense":
                from ..ops.blockdense import warm_blockplan_from_crow
                warm_blockplan_from_crow(state.plan, crow,
                                         int(z["ext_area"]),
                                         int(z["ext_nplanes"]))
            else:
                return False
        return True
    except Exception:  # noqa: BLE001 - a broken record is a miss
        return False


def save(state, name: str, A, engine: str, config) -> Optional[str]:
    """Persist the counts a plan learned on its first call.  Returns the
    path written, or None (nothing learned yet, a record already there,
    or nowhere writable)."""
    plan = state.plan
    if getattr(plan, "crow_h", None) is None:
        return None
    key = cache_key(name, A, engine, config, state.device)
    if _find(key):
        return None
    rec = {"crow": np.asarray(plan.crow_h).astype(np.int32)}
    if engine == "blockdense":
        if plan.ext_area is None:
            return None
        rec["ext_area"] = np.int64(plan.ext_area)
        rec["ext_nplanes"] = np.int64(plan.ext_nplanes)
    for d in _dirs():
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{key}.npz")
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **rec)
            os.replace(tmp, path)
            return path
        except OSError:
            continue
    return None
