"""Communication volumes of distributed SpMV/Krylov programs, counted
from their compiled HLO.

Wall-clock scaling on a virtual CPU mesh is noise (N virtual devices
time-share a few host cores), so this module measures the thing that IS
exact there and platform-free: the communication structure. The compiled
HLO of a distributed program names every collective with its per-shard
shape; we count them — total, and inside while-loop bodies (= per solver
iteration). Times of the collectives come only from runs on real cards.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional

import jax

# bytes per element for HLO shape parsing
_DTYPE_BYTES = {
    "f64": 8, "u64": 8, "s64": 8, "c64": 8,
    "f32": 4, "u32": 4, "s32": 4,
    "bf16": 2, "f16": 2, "u16": 2, "s16": 2,
    "pred": 1, "u8": 1, "s8": 1,
}

_COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "collective-permute", "reduce-scatter",
    "all-to-all",
)

_SHAPE_RE = re.compile(r"\b([a-z]+\d*)\[([\d,]*)\]")
# result type = everything between '= ' and the op name
_OP_RE = re.compile(
    r"=\s+(.*?)\s+(" + "|".join(_COLLECTIVE_KINDS) + r")(-start)?\(")
_WHILE_BODY_RE = re.compile(r"\bwhile\(.*body=\s*%?([\w.\-]+)")
_COMPUTATION_START_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\()")


@dataclasses.dataclass
class CollectiveOp:
    kind: str          # all-reduce / all-gather / collective-permute / ...
    bytes: int         # per-shard result bytes (full gathered size for AG)
    computation: str   # HLO computation the op appears in
    in_loop_body: bool  # inside a while-loop body => executes per iteration


@dataclasses.dataclass
class CollectiveStats:
    ops: List[CollectiveOp]

    @property
    def per_iteration(self) -> List[CollectiveOp]:
        return [o for o in self.ops if o.in_loop_body]

    @property
    def setup(self) -> List[CollectiveOp]:
        return [o for o in self.ops if not o.in_loop_body]

    def summary(self, per_iteration: Optional[bool] = None
                ) -> Dict[str, Dict[str, int]]:
        """{kind: {count, bytes}} over all ops / loop-body ops / setup."""
        if per_iteration is None:
            sel = self.ops
        elif per_iteration:
            sel = self.per_iteration
        else:
            sel = self.setup
        out: Dict[str, Dict[str, int]] = {}
        for o in sel:
            d = out.setdefault(o.kind, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += o.bytes
        return out


def _shape_bytes(type_str: str) -> int:
    """Sum bytes over every array shape in an HLO result type (handles
    tuples like '(f32[16]{0}, u32[])')."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        elems = 1
        if dims:
            for d in dims.split(","):
                elems *= int(d)
        total += elems * _DTYPE_BYTES[dtype]
    return total


def hlo_collective_stats(hlo_text: str) -> CollectiveStats:
    """Parse optimized HLO text into per-collective byte counts.

    Ops inside while-loop *body* computations are flagged per-iteration.
    Async pairs (all-reduce-start / -done) count once (the -start).

    Known limits (acceptable for the programs this models, and pinned by
    tests/test_dist.py's exact per-iteration counts): (1) only ops
    LEXICALLY inside a while-body computation are classified
    per-iteration — a collective in a computation the body merely calls
    would count as setup; the repo's solver programs keep their
    collectives at body top level after XLA inlining. (2) ``-start`` ops
    parse the full tuple result type, so an async op whose tuple carries
    both operand and result shapes is counted at up to 2x its wire
    bytes; the distributed solvers' collectives all lower to the
    synchronous forms on the CPU mesh where this model is measured."""
    body_names = set(_WHILE_BODY_RE.findall(hlo_text))
    ops: List[CollectiveOp] = []
    current = ""
    for line in hlo_text.splitlines():
        if line and not line[0].isspace():
            m = _COMPUTATION_START_RE.match(line.strip())
            if m:
                current = m.group(1)
            continue
        m = _OP_RE.search(line)
        if not m:
            continue
        type_str, kind = m.group(1), m.group(2)
        ops.append(CollectiveOp(
            kind=kind, bytes=_shape_bytes(type_str), computation=current,
            in_loop_body=current in body_names))
    return CollectiveStats(ops)


def measure_collectives(fn: Callable, *args, **kwargs) -> CollectiveStats:
    """Compile fn(*args) (jit if not already) and return its collective
    stats. Runs entirely at compile time — nothing executes on devices."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    compiled = jitted.lower(*args, **kwargs).compile()
    return hlo_collective_stats(compiled.as_text())
