"""PyTorch port vs the JAX package: the sharding specs
(``repro_torch.launch.sharding`` against ``repro.launch.sharding``) for
every architecture at full width on both production meshes, computed on
abstract meshes (axis names and sizes, no devices), and the layout of
``named``'s DTensor placements against the reference's
``NamedSharding.devices_indices_map``.

The reference stacks a module list's layers along a leading axis that
its rules never shard; the port keeps one module a layer, so a layer
parameter's spec is the reference's without that leading entry, matched
through ``convert``'s names. ZeRO-1 decides on the reference's stacked
shapes; where the reference picks the layer axis (Mamba2-780m's a_log,
d_skip, dt_bias and conv_wx on 16 x 16, whose 48 layers tie 48 heads)
the port's spec is the reference's without that entry too, and the test
names those leaves.
"""
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import all_archs, get_config as j_get_config
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro_torch.configs import get_config
from repro_torch.convert import _ref_path
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as TSH
from repro_torch.launch import specs as TSP

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = all_archs()
CELLS = [(a, m) for a in ARCHS for m in MESHES]

#: leaves whose ZeRO-1 dim is the reference's layer axis
LAYER_AXIS_ZERO1 = {("mamba2-780m", "16x16"): {
    ("layers", "mamba", "a_log"), ("layers", "mamba", "d_skip"),
    ("layers", "mamba", "dt_bias"), ("layers", "mamba", "conv_wx")}}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), TM.AbstractMesh(shape, axes)


_REF = {}


def _ref_structs(arch):
    if arch not in _REF:
        cfg = j_get_config(arch)
        _REF[arch] = (JSP.params_struct(cfg), cfg)
    return _REF[arch]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_leaf_spec(specs, name):
    """The reference's spec of port parameter `name` (its leading layer
    entry dropped for a stacked leaf) and whether it was stacked."""
    path, layer = _ref_path(name)
    spec = tuple(_at(specs, path))
    return (spec[1:], spec[0]) if layer is not None else (spec, None)


def _port_model(arch):
    return TSP.params_struct(get_config(arch))


_PORT = {}


def _port(arch):
    if arch not in _PORT:
        _PORT[arch] = _port_model(arch)
    return _PORT[arch]


@pytest.mark.parametrize("arch,mesh", CELLS)
@pytest.mark.parametrize("expert_2d", [False, True])
def test_param_specs_match_the_reference(arch, mesh, expert_2d):
    jmesh, tmesh = _meshes(mesh)
    ps, _ = _ref_structs(arch)
    want = JSH.param_specs(ps, jmesh, expert_2d=expert_2d)
    model = _port(arch)
    got = TSH.param_specs(model, tmesh, expert_2d=expert_2d)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        ref, lead = _ref_leaf_spec(want, name)
        assert lead is None
        assert tuple(spec) == ref, (name, spec, ref)


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_zero1_and_opt_state_specs_match_the_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    ps, _ = _ref_structs(arch)
    jp = JSH.param_specs(ps, jmesh)
    want = JSH.zero1_specs(jp, ps, jmesh)
    wopt = JSH.opt_state_specs(jp, ps, jmesh)
    model = _port(arch)
    tp = TSH.param_specs(model, tmesh)
    got = TSH.zero1_specs(tp, model, tmesh)
    gopt = TSH.opt_state_specs(tp, model, tmesh)
    layer_axis = set()
    for name, spec in got.items():
        ref, lead = _ref_leaf_spec(want, name)
        assert tuple(spec) == ref, (name, spec, ref)
        if lead is not None:
            layer_axis.add(_ref_path(name)[0])
        for key in ("m", "v"):
            assert tuple(gopt[key][name]) == _ref_leaf_spec(
                wopt[key], name)[0]
    assert layer_axis == LAYER_AXIS_ZERO1.get((arch, mesh), set())
    assert tuple(gopt["step"]) == tuple(wopt["step"]) == ()
    # without zero1 the moments take the parameters' specs
    assert TSH.opt_state_specs(tp, model, tmesh, zero1=False)["m"] == tp


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("batch", [1, 32, 128, 256, 48, 8])
def test_batch_spec_and_logical_rules(mesh, batch):
    jmesh, tmesh = _meshes(mesh)
    assert tuple(TSH.batch_spec(tmesh, batch)) == \
        tuple(JSH.batch_spec(jmesh, batch))
    assert TSH.logical_rules(tmesh) == JSH.logical_rules(jmesh)


DECODE = [(a, m, s) for a in ARCHS for m in MESHES
          for s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,mesh,shape", DECODE)
def test_cache_specs_match_the_reference(arch, mesh, shape):
    jmesh, tmesh = _meshes(mesh)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    ok, _ = TSP.cell_applicable(cfg, shape)
    assert ok == JSP.cell_applicable(jcfg, shape)[0]
    if not ok:
        return
    batch = TSP.SHAPES[shape].global_batch
    want = JSH.cache_specs(jcfg, JSP.cache_struct(jcfg, shape), jmesh, batch)
    cache = TSP.cache_struct(cfg, shape)
    ref = JSP.cache_struct(jcfg, shape)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    got = TSH.cache_specs(cfg, cache, tmesh, batch)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_shapes_and_input_specs_match_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in TSP.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JSP.SHAPES.items()}
    assert TSP.ENC_LEN_DECODE == JSP.ENC_LEN_DECODE
    for arch in ARCHS:
        for shape in TSP.SHAPES:
            got = TSP.input_specs(get_config(arch), shape)
            want = JSP.input_specs(j_get_config(arch), shape)
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())


def test_params_struct_is_the_reference_tree_on_meta():
    for arch in ("tinyllama-1.1b", "deepseek-v3-671b", "zamba2-7b",
                 "seamless-m4t-medium"):
        model = TSP.params_struct(get_config(arch))
        ps, _ = _ref_structs(arch)
        for name, p in model.named_parameters():
            assert p.device.type == "meta"
            path, layer = _ref_path(name)
            ref = _at(ps, path)
            shape = ref.shape[1:] if layer is not None else ref.shape
            assert tuple(p.shape) == tuple(shape), name
            assert str(p.dtype).removeprefix("torch.") == str(ref.dtype)


# ---------------------------------------------------------------------------
# placements: the shards each rank keeps against the reference's layout
# ---------------------------------------------------------------------------

PLACED = [((8, 4, 6), ("model", None, None)),
          ((8, 4, 6), (("pod", "data"), "model", None)),
          ((6, 16), (None, ("pod", "data", "model"))),
          ((8, 4), ("data", "model")),
          ((8, 4, 4), ("model", "pod", "data")),
          ((8, 4), ())]


def _reference_index_maps():
    """{case: [per device position in the mesh: index slices]} from the
    reference's NamedSharding on a (2, 2, 2) mesh of 8 host devices."""
    import os
    import subprocess
    import sys
    code = f"""
import json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import AxisType, make_mesh
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                 axis_types=(AxisType.Auto,) * 3)
flat = list(np.asarray(mesh.devices).reshape(-1))
out = []
for shape, spec in {PLACED!r}:
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    out.append([[[s.start or 0, s.stop if s.stop is not None else n]
                 for s, n in zip(m[d], shape)] for d in flat])
print(json.dumps(out))
"""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(
                   os.path.dirname(os.path.abspath(__file__))), "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    import json
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_named_placements_lay_out_shards_as_the_reference():
    """Every rank of an 8-rank world (each a fake process group in turn)
    keeps, through ``named`` and ``to_dtensor``, exactly the slice of the
    full array that the reference's NamedSharding gives the device at
    its position in the mesh; a ("pod", "data") dim is pod-major."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    want = _reference_index_maps()
    assert not dist.is_initialized()
    try:
        for rank in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=8)
            mesh = TM.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
            for (shape, spec), maps in zip(PLACED, want):
                full = torch.arange(math.prod(shape)).reshape(shape)
                local = TSH.to_dtensor(full, mesh, TSH.P(*spec)).to_local()
                sl = tuple(slice(a, b) for a, b in maps[rank])
                assert torch.equal(local, full[sl]), (rank, spec)
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_placements_refuse_axes_out_of_the_meshes_order():
    mesh = TM.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        TSH.named(mesh, TSH.P(("data", "pod")))
    assert TSH.P(("data",), None) == ("data", None)
    assert tuple(TSH.P(("data",))) == tuple(JP(("data",)))
