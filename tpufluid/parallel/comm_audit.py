"""Static accounting of a sharded step's collective traffic.

Walks the jaxpr of a (jitted) sharded step and sums the bytes moved by
every ``ppermute`` / ``all_gather`` equation, keeping conditionally
executed collectives (inside ``lax.cond`` branches — the far-mover
path) separate from the unconditional per-step ones.

This pins the documented per-step volume (``resident_comm_formula``) to
the CODE: the per-direction volume must equal what the traced step
actually ships, so a refactor that adds traffic fails
tests/test_shard.py::test_resident_comm_volume_matches_model. The
design it audits is the row-band halo exchange of
tpufluid/parallel/shard.py (make_sharded_resident_step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import jax
import numpy as np

COLLECTIVES = ("ppermute", "all_gather", "psum", "psum2", "psum_invariant",
               "all_reduce", "reduce_scatter")


@dataclasses.dataclass
class CollectiveOp:
    primitive: str
    shape: tuple
    dtype: str
    nbytes: int
    conditional: bool  # inside a lax.cond branch (may not run every step)
    looped: bool = False  # inside a scan/while body (runs trip-count times)


def _sub_jaxprs(eqn):
    """Yield every jaxpr nested in an equation's params (pjit bodies,
    shard_map bodies, scan/while/cond branches, closed_call, ...)."""
    for v in eqn.params.values():
        vs = v if isinstance(v, (list, tuple)) else (v,)
        for item in vs:
            j = getattr(item, "jaxpr", None)
            if j is not None and hasattr(j, "eqns"):
                yield j  # ClosedJaxpr -> inner Jaxpr
            elif hasattr(item, "eqns"):
                yield item  # bare Jaxpr


def collect_collectives(closed_jaxpr) -> List[CollectiveOp]:
    out: List[CollectiveOp] = []

    def visit(jaxpr, conditional, looped):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name in COLLECTIVES:
                for var in eqn.invars:
                    aval = getattr(var, "aval", None)
                    if aval is None or not hasattr(aval, "shape"):
                        continue
                    nbytes = int(np.prod(aval.shape, dtype=np.int64)
                                 * np.dtype(aval.dtype).itemsize)
                    out.append(CollectiveOp(
                        primitive=name, shape=tuple(aval.shape),
                        dtype=str(np.dtype(aval.dtype)), nbytes=nbytes,
                        conditional=conditional, looped=looped))
            sub_conditional = conditional or name == "cond"
            sub_looped = looped or name in ("scan", "while")
            for sub in _sub_jaxprs(eqn):
                visit(sub, sub_conditional, sub_looped)

    visit(closed_jaxpr.jaxpr, False, False)
    return out


def audit_step(fn, *example_args) -> dict:
    """Trace ``fn`` on ``example_args`` and account its collectives.

    Returns a dict with:
      ppermute_bytes_total        sum over all unconditional ppermutes
      ppermute_bytes_per_dir      total / 2 (send_right + send_left are
                                  symmetric in the row-band design)
      all_gather_bytes_conditional  far-mover packets (cond-gated)
      psum_scalars                number of unconditional psum operands
      ops                         the raw CollectiveOp list

    Assumptions (enforced): ``fn`` must be a SINGLE step — a collective
    found inside a ``lax.scan``/``while_loop`` body runs trip-count
    times but is counted once, so audit_step raises on any looped
    collective rather than silently undercounting. The per-direction
    split assumes the row-band design's symmetric left/right traffic
    (each boundary exchange is a matched send_right + send_left pair,
    shard.py phases 2 and 4).
    """
    jaxpr = jax.make_jaxpr(fn)(*example_args)
    ops = collect_collectives(jaxpr)
    loop_ops = [o for o in ops if o.looped]
    if loop_ops:
        raise ValueError(
            "audit_step only supports single-step functions: found "
            f"{len(loop_ops)} collective(s) inside scan/while bodies "
            "whose trip counts are not statically accounted: "
            + ", ".join(f"{o.primitive}{o.shape}" for o in loop_ops))
    pp = [o for o in ops if o.primitive == "ppermute" and not o.conditional]
    pp_cond = [o for o in ops if o.primitive == "ppermute" and o.conditional]
    ag = [o for o in ops if o.primitive == "all_gather"]
    psums = [o for o in ops
             if o.primitive.startswith(("psum", "all_reduce"))
             and not o.conditional]
    total = sum(o.nbytes for o in pp)
    return dict(
        ppermute_bytes_total=total,
        ppermute_bytes_per_dir=total // 2,
        ppermute_bytes_conditional=sum(o.nbytes for o in pp_cond),
        all_gather_bytes_conditional=sum(
            o.nbytes for o in ag if o.conditional),
        all_gather_bytes_unconditional=sum(
            o.nbytes for o in ag if not o.conditional),
        psum_scalars=len(psums),
        ops=ops,
    )


def resident_comm_formula(spec) -> dict:
    """The documented per-direction volume of the row-band resident step
    (shard.py phases 2 and 4): one packed boundary row plus a two-row
    (pos, vel) halo — 3 rows x 4 f32 fields of [K, Gxp] — plus the
    i32[Gxp] boundary cell-count row and the i32[2] halo occupancy."""
    from ..ops import resident as residentops
    k = spec.settings.cell_capacity
    gxp = residentops._gxp(spec.settings)
    field_row = k * gxp * 4
    return dict(
        payload_bytes_per_dir=3 * 4 * field_row,
        occupancy_bytes_per_dir=gxp * 4 + 2 * 4,
        bytes_per_dir=3 * 4 * field_row + gxp * 4 + 2 * 4,
        far_packet_bytes=spec.far_capacity * 5 * 4,
    )
