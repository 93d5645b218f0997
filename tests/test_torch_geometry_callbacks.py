"""Callback states over the remaining geometries on four paths: the
reference's walk and its Pallas callback kernel (interpret mode), the
port's callback-kernel twin and its loop walk, bit for bit, on the
boundary scenes of ``test_torch_geometry_query`` over one tree built by
the reference and carried across.
"""
import functools

import numpy as np
import pytest

from test_torch_geometry_query import (  # noqa: F401
    CPU, N, Q, TREE, _factories, assert_states, both, jx,
    one_torch_thread, scene, value_arrays)
from repro_torch import convert
from repro_torch.core import predicates as TP
from repro_torch.core import traversal as TT
from repro_torch.core.index import _bcast_state
from repro_torch.kernels import bvh_callback as TK


@functools.lru_cache(maxsize=None)
def _carried(vkind, dim, n):
    """(jax tree, port tree carried across, jax values, port values)."""
    j = jx()
    varr = value_arrays(vkind, n, dim)
    jv, tv = both(vkind, varr)
    jtree = j["L"].build(j["G"].to_boxes(jv))
    from repro_torch.core.lbvh import FIELDS
    ttree = convert.lbvh_from_numpy({f: np.asarray(getattr(jtree, f))
                                     for f in FIELDS}, CPU)
    return jtree, ttree, jv, tv


@pytest.mark.parametrize("name", ["counting", "collect_first_k"])
@pytest.mark.parametrize("vkind,dim,qkind", [
    ("triangles", 3, "spheres"), ("triangles", 2, "points"),
    ("segments", 3, "spheres"), ("tetrahedra", 3, "points"),
    ("kdops", 3, "spheres")])
def test_callback_states_on_four_paths(vkind, dim, qkind, name):
    """The reference's walk and Pallas callback kernel (interpret), the
    port's kernel twin and loop walk: final states bit-identical, on the
    boundary scenes."""
    j = jx()
    jtree, ttree, jv, tv = _carried(vkind, dim, N)
    varr, qarr = scene(vkind, dim, N, qkind, True)
    jq, tq = both(qkind, qarr)
    jp, tp = j["P"].intersects(jq), TP.intersects(tq)
    (jcb, js0), (tcb, ts0) = _factories(name)
    js0b, ts0b = j["bcast"](js0, Q), _bcast_state(ts0, Q, CPU)
    want = j["T"].traverse(jtree, jv, jp, jcb, js0b)
    assert_states(want, j["kernel"](*(getattr(jtree, f) for f in TREE), jv,
                                    jp, jcb, js0b, bq=64, interpret=True))
    assert_states(want, TK.bvh_traverse_callback(
        *(getattr(ttree, f) for f in TREE), tv, tp, tcb, ts0b))
    assert_states(want, TT.traverse(ttree, tv, tp, tcb, ts0b))


