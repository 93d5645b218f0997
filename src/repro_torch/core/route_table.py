"""RouteTable: per-op crossover rules for the QueryEngine, versioned,
fingerprinted and persisted as the reference's ``repro.core.route_table``
(its schema 1, field for field).

The port's routes are brute force (the all-pairs match matrix), the
traversal kernels and the general walk (``core.traversal``, a host loop
of PyTorch operations on the card). A :class:`RouteRule` per op kind
(``spatial`` / ``knn`` / ``callback``) holds the thresholds and the
kernels' block size for that op; a :class:`RouteTable` bundles the rules
with the schema version, the :func:`hardware_fingerprint` of the machine
that measured them and the build engine.

The rule fields keep the reference's names. ``pallas_min_queries`` /
``pallas_min_leaves``: below these the loop route serves a batch the
kernels could take. ``pallas_max_nodes`` / ``pallas_max_capacity``: caps
on the tree's node count and on a query's buffer width (fill capacity,
k, a callback state's row) above which the loop route serves it. The
reference's caps are a TPU's VMEM; the card's walks read the tree and
write their buffers in device memory, so the port's defaults leave them
uncapped and admit every batch the kernels can take (the kNN kernel's
own limit is ``kernels.bvh_traverse.KNN_MAX_K``). ``block_q``: the
threads of a block of the spatial, kNN and callback walks (one query a
thread); 256 by default, and up to ``kernels.bvh_traverse.MAX_BLOCK_Q``.

``build_engine`` names the LBVH build of ``core.lbvh.build``: "pallas" is
the port's CUDA build (``csrc/morton.cu``, ``karras.cu``,
``lbvh_tail.cu``; the reference's name for its fused build, kept so that
one schema serves both packages), "ref" its plain PyTorch pipeline, and
"auto" leaves the choice to the next step of the lookup order.

Lookup order (most to least specific), as the reference's:

  1. explicit per-call or per-index policy (``ExecutionPolicy.route_table``)
  2. engine-level table                    (``EngineConfig.route_table``)
  3. ``REPRO_ENGINE_FORCE``                (pins a route outright; checked
                                            inside the engine's ``_pick``)
  4. the port's persisted table            (``ROUTE_TABLE_TORCH.json`` /
                                            ``$REPRO_TORCH_ROUTE_TABLE``)
  5. built-in defaults                     (:meth:`RouteTable.default`)

The port reads its own file, never the reference's ``ROUTE_TABLE.json``:
a table is applied only where its fingerprint names the same framework
(a ``"torch"`` key), backend and device kind as this process. A table
changes which route serves a batch, never the result: every route is
exact (``tests/test_torch_route_table.py`` holds adversarial tables to
one another).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings

__all__ = ["RouteRule", "RouteTable", "SCHEMA_VERSION", "OPS", "UNCAPPED",
           "hardware_fingerprint", "default_route_table",
           "validate_route_table"]

SCHEMA_VERSION = 1

#: ops the engine distinguishes when routing (a table may carry any
#: subset; missing ops fall back to the "default" rule)
OPS = ("spatial", "knn", "callback")

#: the cap that admits every tree and buffer (a JSON int)
UNCAPPED = 1 << 62

_ENV_TABLE = "REPRO_TORCH_ROUTE_TABLE"   # a path, or "off" to disable
_DEFAULT_BASENAME = "ROUTE_TABLE_TORCH.json"
BUILD_ENGINES = ("auto", "pallas", "ref")


def hardware_fingerprint() -> dict:
    """The framework, backend and device a measurement was taken on;
    stamped into every tuned table."""
    import torch
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "cpu_count": os.cpu_count() or 1,
    }


def _framework(fp: dict):
    return "torch" if "torch" in fp else "jax" if "jax" in fp else None


def _fingerprints_compatible(a: dict, b: dict) -> bool:
    """Same framework, backend and device kind: the measured crossovers
    transfer. A table the reference measured (a ``"jax"`` key) never
    applies to the port, on any device."""
    return (_framework(a) is not None and _framework(a) == _framework(b)
            and a.get("backend") == b.get("backend")
            and a.get("device_kind") == b.get("device_kind"))


@dataclasses.dataclass(frozen=True)
class RouteRule:
    """Crossover thresholds for one op kind (the module docstring).

    bf_max_work:          brute force serves a batch while N * Q is at
                          most this.
    pallas_min_queries /
    pallas_min_leaves:    below these the loop route serves the batch.
    pallas_max_nodes:     trees of more nodes than this take the loop.
    pallas_max_capacity:  fill capacities, k and callback state rows
                          wider than this take the loop.
    block_q:              threads a block of the walks (a query each).
    """
    bf_max_work: int = 1 << 22
    pallas_min_queries: int = 0
    pallas_min_leaves: int = 0
    pallas_max_nodes: int = UNCAPPED
    pallas_max_capacity: int = UNCAPPED
    block_q: int = 256

    def replace(self, **kw) -> "RouteRule":
        return dataclasses.replace(self, **kw)


_RULE_FIELDS = tuple(f.name for f in dataclasses.fields(RouteRule))


@dataclasses.dataclass(frozen=True)
class RouteTable:
    """Versioned per-hardware routing policy; immutable, safe to share
    across engines and threads."""
    rules: dict            # op -> RouteRule ("default" is the fallback)
    fingerprint: dict = dataclasses.field(default_factory=dict)
    build_engine: str = "auto"      # "pallas" | "ref" | "auto" (lbvh.build)
    schema_version: int = SCHEMA_VERSION
    source: str = "defaults"        # "defaults"|"synthesized"|"autotuned"|path
    measurements: dict = dataclasses.field(default_factory=dict)

    def rule(self, op: str) -> RouteRule:
        return self.rules.get(op) or self.rules.get("default") or RouteRule()

    @classmethod
    def default(cls) -> "RouteTable":
        """The built-in rule for every op: brute force below N * Q = 2^22,
        else the kernels wherever they can take the batch, 256 threads a
        block."""
        return cls(rules={"default": RouteRule()})

    @classmethod
    def single(cls, *, build_engine: str = "auto", source: str = "synthesized",
               **rule_fields) -> "RouteTable":
        """One rule applied to every op: the table the deprecated
        EngineConfig crossover fields lower to, and the way to pin
        thresholds in tests."""
        bad = set(rule_fields) - set(_RULE_FIELDS)
        if bad:
            raise TypeError(f"unknown RouteRule fields {sorted(bad)}; "
                            f"valid: {_RULE_FIELDS}")
        return cls(rules={"default": RouteRule(**rule_fields)},
                   build_engine=build_engine, source=source)

    def to_dict(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "fingerprint": dict(self.fingerprint),
            "build_engine": self.build_engine,
            "rules": {op: dataclasses.asdict(r)
                      for op, r in sorted(self.rules.items())},
            "measurements": self.measurements,
        }

    @classmethod
    def from_dict(cls, d: dict, *, source: str = "dict") -> "RouteTable":
        problems = validate_route_table(d)
        if problems:
            raise ValueError(
                f"invalid RouteTable ({source}): " + "; ".join(problems))
        rules = {op: RouteRule(**{k: int(v) for k, v in row.items()
                                  if k in _RULE_FIELDS})
                 for op, row in d["rules"].items()}
        return cls(rules=rules, fingerprint=d.get("fingerprint", {}),
                   build_engine=d.get("build_engine", "auto"),
                   schema_version=d["schema_version"], source=source,
                   measurements=d.get("measurements", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "RouteTable":
        """Load and validate; a corrupt table raises ValueError."""
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict(d, source=path)


def validate_route_table(d) -> list[str]:
    """The schema check: a list of problems, empty for a valid table. The
    same dicts pass and fail as under the reference's check."""
    problems: list[str] = []
    if not isinstance(d, dict):
        return [f"table must be a JSON object, got {type(d).__name__}"]
    ver = d.get("schema_version")
    if ver != SCHEMA_VERSION:
        problems.append(f"schema_version={ver!r}, expected {SCHEMA_VERSION}")
    rules = d.get("rules")
    if not isinstance(rules, dict) or not rules:
        problems.append("missing/empty 'rules' object")
        return problems
    for op, row in rules.items():
        if op not in OPS and op != "default":
            problems.append(f"unknown op {op!r} (valid: {OPS + ('default',)})")
        if not isinstance(row, dict):
            problems.append(f"rules[{op!r}] must be an object")
            continue
        for k, v in row.items():
            if k not in _RULE_FIELDS:
                problems.append(f"rules[{op!r}] has unknown field {k!r}")
            elif not isinstance(v, int) or isinstance(v, bool) or v < 0:
                problems.append(f"rules[{op!r}].{k} must be a non-negative "
                                f"int, got {v!r}")
        bq = row.get("block_q")
        if isinstance(bq, int) and not isinstance(bq, bool) and bq > 0 \
                and (bq & (bq - 1)):
            problems.append(f"rules[{op!r}].block_q={bq} is not a power of 2")
    be = d.get("build_engine", "auto")
    if be not in BUILD_ENGINES:
        problems.append(f"build_engine={be!r} not in {BUILD_ENGINES}")
    return problems


# --- the ambient table ------------------------------------------------------

#: seconds between two looks at the file system for the ambient table
#: (a look stats one or two paths, tens of microseconds where system
#: calls are slow, and the engine asks for the table at every routing
#: decision)
RECHECK_S = 1.0
_clock = time.monotonic
_CACHE: dict = {}      # (path, mtime) -> the table, or None when ignored
_LOOKED: dict = {}     # $REPRO_TORCH_ROUTE_TABLE -> (when, table)


def _default_path() -> str | None:
    env = os.environ.get(_ENV_TABLE)
    if env:
        return None if env.lower() in ("off", "none", "0") else env
    # the checkout: src/repro_torch/core/route_table.py -> its root
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for cand in (os.path.join(root, _DEFAULT_BASENAME),
                 os.path.join(os.getcwd(), _DEFAULT_BASENAME)):
        if os.path.exists(cand):
            return cand
    return None


def default_route_table() -> RouteTable | None:
    """The ambient persisted table (lookup step 4), or None when none is
    persisted or it was measured on another framework or device (then
    with a RuntimeWarning). Cached per (path, mtime), so a new tuning is
    read without a restart: the files are looked at again after
    ``RECHECK_S`` seconds, and at once when ``$REPRO_TORCH_ROUTE_TABLE``
    changes."""
    env = os.environ.get(_ENV_TABLE)
    seen = _LOOKED.get(env)
    if seen is not None and _clock() - seen[0] < RECHECK_S:
        return seen[1]
    table = _look()
    _LOOKED.clear()
    _LOOKED[env] = (_clock(), table)
    return table


def _look() -> RouteTable | None:
    path = _default_path()
    if path is None or not os.path.exists(path):
        return None
    key = (path, os.path.getmtime(path))
    if key in _CACHE:
        return _CACHE[key]
    table = RouteTable.load(path)      # a corrupt table raises
    fp = hardware_fingerprint()
    if not _fingerprints_compatible(table.fingerprint, fp):
        got = table.fingerprint
        warnings.warn(
            f"ignoring persisted route table {path}: it was measured with "
            f"{_framework(got)} on {got.get('backend')}/"
            f"{got.get('device_kind')} but this process runs torch on "
            f"{fp['backend']}/{fp['device_kind']}; run `python -m "
            "repro_torch.launch.autotune` on this machine",
            RuntimeWarning, stacklevel=3)
        table = None
    _CACHE.clear()
    _CACHE[key] = table
    return table


def _reset_cache() -> None:
    """Forget the cached ambient table (tests)."""
    _CACHE.clear()
    _LOOKED.clear()
