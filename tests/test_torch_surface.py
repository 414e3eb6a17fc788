"""Every public signature of the port against the JAX package's.

For each module of ``sdf_tools_tpu`` (but the two that hold the Pallas
kernels, whose counterpart is ``ops/edt_cuda.py``), each public function
and class defined there, and each public member of those classes (their
``__init__`` included), the port's module at the same path must have the
same name, and every parameter of the JAX signature must appear in the
port's. The exceptions are ``ALLOWED``, each with its reason and its
counterpart in the port; a second case fails when an exception goes stale
(the port gained the name, or the JAX package lost it). Imports only.
"""
import importlib
import inspect
import pkgutil

import pytest

import sdf_tools_tpu

# the Pallas kernels: their counterpart is ops/edt_cuda.py, and PERF.md's
# kernel table holds each of them against its Hopper kernel
NOT_MIRRORED = {"sdf_tools_tpu.ops.edt_pallas", "sdf_tools_tpu.ops.edt_cht"}

_PYTREE = "JAX pytree plumbing: the fields jax.tree_util keeps static; the port's grids are plain dataclasses"
_MESH = "a JAX device list; the port's mesh is laid over the ranks of the torch.distributed group"
_PLANE_GRID = "the port takes the grid whole (values, meta and oob_value of one SdfGrid)"

# (module under sdf_tools_tpu, qualified name, parameter or None for the
# member itself) -> (reason, the port's parameters that stand in for it)
ALLOWED = {
    ("grid", "GridMeta.META_FIELDS", None): (_PYTREE, ()),
    ("grid", "SdfGrid.META_FIELDS", None): (_PYTREE, ()),
    ("grid", "CollisionMap.META_FIELDS", None): (_PYTREE, ()),
    ("grid", "TaggedCollisionMap.META_FIELDS", None): (_PYTREE, ()),
    ("grid", "SdfGrid.meta_static", None): (_PYTREE + " (a static slot that nothing in the JAX package reads)", ()),
    ("grid", "SdfGrid.__init__", "meta_static"): (_PYTREE, ()),
    ("ops.render_plane", "plane_sweep_depth", "values"): (_PLANE_GRID, ("sdf",)),
    ("ops.render_plane", "plane_sweep_depth", "meta"): (_PLANE_GRID, ("sdf",)),
    ("ops.render_plane", "plane_sweep_depth", "oob_value"): (_PLANE_GRID, ("sdf",)),
    ("ops.render_plane", "plane_sweep_depth", "interpret"): (
        "Pallas interpret mode: the port runs K8 on a CUDA tensor and its plain version on a CPU one", ()),
    ("ops.render_plane", "plane_sweep_depth", "refine_iters"): (
        "read only by the bisect refine; the JAX package resolves its refine mode to the secant, which the"
        " port ports and which takes no iteration count", ()),
    ("parallel.runtime", "initialize", "coordinator_address"): (
        "jax.distributed's coordinator; torch.distributed's rendezvous address", ("init_method",)),
    ("parallel.runtime", "initialize", "num_processes"): ("jax.distributed's process count", ("world_size",)),
    ("parallel.runtime", "initialize", "process_id"): ("jax.distributed's process index", ("rank",)),
    ("parallel.runtime", "process_mesh", "devices"): (_MESH, ("axis_sizes",)),
    ("parallel.sharded", "make_mesh", "devices"): (_MESH, ("axis_sizes",)),
}


def _jax_modules():
    names = ["sdf_tools_tpu"] + [m.name for m in pkgutil.walk_packages(sdf_tools_tpu.__path__, "sdf_tools_tpu.")]
    return [n for n in names if n not in NOT_MIRRORED]


MODULES = _jax_modules()


def _short(module_name: str) -> str:
    return module_name[len("sdf_tools_tpu."):] if "." in module_name else ""


def _port_module(short: str):
    return importlib.import_module("sdf_tools_tpu_torch" + (f".{short}" if short else ""))


def _members(cls):
    """(name, object) of a class's own public members and its ``__init__``,
    as stored in the class (staticmethod, classmethod, property, attribute)."""
    for name, obj in vars(cls).items():
        if name.startswith("_") and name != "__init__":
            continue
        yield name, obj


def _params(obj):
    """The parameter names of a callable member, or None (an attribute, a
    property, a callable without a signature)."""
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if not callable(obj) or isinstance(obj, type):
        return None
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _public(module):
    """(name, object) of the public functions and classes defined in ``module``."""
    for name, obj in vars(module).items():
        if name.startswith("_") or not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", None) == module.__name__:
            yield name, obj


def _lookup(short: str, qualname: str, port: bool):
    """The object at ``qualname`` in the JAX module or the port's, without
    binding; raises AttributeError where it is missing."""
    obj = _port_module(short) if port else importlib.import_module("sdf_tools_tpu" + (f".{short}" if short else ""))
    for part in qualname.split("."):
        obj = inspect.getattr_static(obj, part)
    return obj


def _gaps(short: str):
    """Every (qualified name, parameter or None) of the JAX module that the
    port's module lacks."""
    jax_mod = importlib.import_module("sdf_tools_tpu" + (f".{short}" if short else ""))
    port_mod = _port_module(short)
    gaps = []
    for name, obj in _public(jax_mod):
        if not hasattr(port_mod, name):
            gaps.append((name, None))
            continue
        pairs = [(name, obj, getattr(port_mod, name))] if inspect.isfunction(obj) else []
        if inspect.isclass(obj):
            port_cls = getattr(port_mod, name)
            for member, mobj in _members(obj):
                try:
                    pairs.append((f"{name}.{member}", mobj, inspect.getattr_static(port_cls, member)))
                except AttributeError:
                    gaps.append((f"{name}.{member}", None))
        for qualname, jobj, pobj in pairs:
            jp = _params(jobj)
            if jp is None:
                continue
            pp = _params(pobj) or []
            gaps += [(qualname, p) for p in jp if p not in pp]
    return gaps


@pytest.mark.parametrize("module", MODULES, ids=[_short(m) or "sdf_tools_tpu" for m in MODULES])
def test_port_has_every_public_name_and_parameter(module):
    short = _short(module)
    unexplained = [gap for gap in _gaps(short) if (short, *gap) not in ALLOWED]
    assert unexplained == [], f"sdf_tools_tpu_torch.{short or ''}: missing (name, parameter) {unexplained}"


@pytest.mark.parametrize("entry", sorted(ALLOWED, key=str), ids=lambda e: ":".join(str(x) for x in e))
def test_allow_list_entry_is_current(entry):
    """The JAX package still has the name, the port still lacks it, the
    reason is given and the port's stand-ins exist."""
    short, qualname, param = entry
    reason, stand_ins = ALLOWED[entry]
    assert reason
    jobj = _lookup(short, qualname, port=False)
    if param is None:
        with pytest.raises(AttributeError):
            _lookup(short, qualname, port=True)
        return
    pobj = _lookup(short, qualname, port=True)
    assert param in _params(jobj), f"the JAX package no longer has {qualname}({param})"
    port_params = _params(pobj)
    assert param not in port_params, f"the port now has {qualname}({param}): drop the entry"
    for p in stand_ins:
        assert p in port_params, f"{qualname}: the port's stand-in {p!r} is gone"


def test_walk_reaches_every_listed_module():
    """The walk reaches every module the allow-list names and the signed
    field's, and the modules it leaves out still exist."""
    walked = {_short(m) for m in MODULES}
    assert {short for short, _, _ in ALLOWED} | {"ops.edt"} <= walked
    for name in NOT_MIRRORED:
        importlib.import_module(name)
