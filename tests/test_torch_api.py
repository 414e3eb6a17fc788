"""The port's public surface against the JAX package's.

The JAX package's ``__all__`` minus the port's must be exactly the names
still to port, and ROADMAP.md's queue A must name each of them: a slice
that ports a name updates this list, and one that forgets fails here.
"""
import pathlib

import sdf_tools_tpu
import sdf_tools_tpu_torch

REPO = pathlib.Path(__file__).resolve().parents[1]
STILL_MISSING = {"scene", "sparse", "viz"}


def test_missing_public_names_are_listed():
    missing = set(sdf_tools_tpu.__all__) - set(sdf_tools_tpu_torch.__all__)
    assert missing == STILL_MISSING


def test_missing_names_are_queued_in_roadmap():
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue = roadmap[roadmap.index("### A. Modules to port"):roadmap.index("### B.")]
    for name in sorted(STILL_MISSING):
        assert f"`{name}.py`" in queue, name


def test_port_exports_what_it_lists():
    for name in sdf_tools_tpu_torch.__all__:
        assert hasattr(sdf_tools_tpu_torch, name), name
    shared = set(sdf_tools_tpu.__all__) & set(sdf_tools_tpu_torch.__all__)
    for name in shared:
        assert callable(getattr(sdf_tools_tpu, name)) == callable(getattr(sdf_tools_tpu_torch, name)), name
