"""The port's multislice rank layout (`cluster/mesh.py`) against the JAX
package's hybrid ICI x DCN mesh, on the CPU.

- `hybrid_mesh_shapes` (a copy) equals the reference's for every
  ``(data, model, seq, pipe)`` shape of at most 16 ranks and 1, 2, 4 or 8
  slices.
- The port's rank grid over `with_fake_slices` equals the device ids of
  the reference's `make_mesh(spec, devices=with_fake_slices(...))` (the
  real `mesh_utils.create_hybrid_device_mesh` placement) for data 8 over
  2 slices, data 1 x pipe 2 over 2, data 2 x pipe 4 over 4 (where the
  layout is not row-major) and data 4 x model 2 over 2.
- Both of the reference's warnings: a slice count no DCN-tolerant axis
  can place, and a layout that fails (slices of unequal size).
- Four spawned gloo ranks (`torch_multislice_cases.py`): DP steps on a
  data = 4 mesh over two fake slices end with the row-major mesh's params
  bit for bit, and data 2 x pipe 2 over two slices whose ranks interleave
  gives each rank the coordinates and axis groups of its hybrid grid.
"""

from __future__ import annotations

import itertools
import logging
import math
import tempfile

import jax
import numpy as np
import pytest

from dist_mnist_tpu.cluster import mesh as jmesh
from dist_mnist_tpu_torch.cluster import mesh as tmesh

import torch_multislice_cases as cases
import torch_ranks


@pytest.fixture(scope="module", autouse=True)
def _own_temp_root(tmp_path_factory):
    """A temp root of this module's own, set before the suite's
    per-test leak check reads it: that check looks for stray temp dirs,
    and tests that run at the same time in other processes make such dirs
    under the shared root. What these tests leak still lands where the
    check looks."""
    shared = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("temp_root"))
    yield
    tempfile.tempdir = shared


def _shapes(max_ranks: int = 16):
    sizes = range(1, max_ranks + 1)
    return [s for s in itertools.product(sizes, repeat=4)
            if math.prod(s) <= max_ranks]


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
def test_hybrid_mesh_shapes_equal_the_reference(slices):
    shapes = _shapes()
    assert len(shapes) > 100
    for shape in shapes:
        assert tmesh.hybrid_mesh_shapes(shape, slices) == \
            jmesh.hybrid_mesh_shapes(shape, slices), shape


GRID_CASES = [((8, 1, 1, 1), 2), ((1, 1, 1, 2), 2), ((2, 1, 1, 4), 4),
              ((4, 2, 1, 1), 2)]


@pytest.mark.parametrize("shape,slices", GRID_CASES,
                         ids=[f"{'x'.join(map(str, s))}/{k}"
                              for s, k in GRID_CASES])
def test_rank_grid_equals_the_reference_hybrid_mesh(shape, slices):
    n = math.prod(shape)
    spec = dict(zip(("data", "model", "seq", "pipe"), shape))
    want = jmesh.make_mesh(jmesh.MeshSpec(**spec),
                           devices=jmesh.with_fake_slices(
                               jax.devices()[:n], slices))
    ids = np.vectorize(lambda d: d.id)(want.devices)
    got = tmesh.rank_grid(shape, tmesh.with_fake_slices(range(n), slices))
    np.testing.assert_array_equal(got, ids)
    if shape == (2, 1, 1, 4):
        # slice k is pipe k: not the row-major order
        assert not np.array_equal(got, np.arange(n).reshape(shape))
        assert got[1, 0, 0, 2] == 2 * 2 + 1


def test_fake_slices_tag_contiguous_blocks():
    tags = tmesh.with_fake_slices(range(8), 2)
    assert [t.slice_index for t in tags] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert tmesh.slice_count(tags) == 2
    with pytest.raises(ValueError):
        tmesh.with_fake_slices(range(8), 3)


def test_unplaceable_slice_factor_warns(caplog):
    with caplog.at_level(logging.WARNING,
                         logger="dist_mnist_tpu_torch.cluster.mesh"):
        grid = tmesh.rank_grid((3, 2, 1, 1),
                               tmesh.with_fake_slices(range(6), 2))
    np.testing.assert_array_equal(grid, np.arange(6).reshape(3, 2, 1, 1))
    assert any("cannot place" in r.message for r in caplog.records)


def test_layout_failure_warns_and_takes_row_major(caplog):
    uneven = [tmesh.SliceTag(r, 0 if r < 3 else 1) for r in range(8)]
    with caplog.at_level(logging.WARNING,
                         logger="dist_mnist_tpu_torch.cluster.mesh"):
        grid = tmesh.rank_grid((8, 1, 1, 1), uneven)
    np.testing.assert_array_equal(grid, np.arange(8).reshape(8, 1, 1, 1))
    assert any("falling back" in r.message and "MULTISLICE" in r.message
               for r in caplog.records)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (16, 28, 28, 1), np.uint8),
             "label": rng.integers(0, 10, (16,), np.int32)}
    return torch_ranks.run_ranks(cases.multislice_cases, 4,
                                 tmp_path_factory.mktemp("slices"), batch,
                                 timeout=180)


def test_dp_steps_on_two_slices_equal_the_row_major_mesh(four_ranks):
    for rank in four_ranks:
        assert rank["sliced_grid"] == [[[[0]]], [[[1]]], [[[2]]], [[[3]]]]
        for key in rank["row_major"]:
            for leaf in rank["row_major"][key]:
                np.testing.assert_array_equal(rank["sliced"][key][leaf],
                                              rank["row_major"][key][leaf])
        for key in rank["row_major"]:
            for leaf in rank["row_major"][key]:
                np.testing.assert_array_equal(
                    rank["sliced"][key][leaf],
                    four_ranks[0]["sliced"][key][leaf])


def test_interleaved_slices_give_each_rank_its_hybrid_coordinates(
        four_ranks):
    # slice 0 = ranks 0, 2 holds data 0; slice 1 = ranks 1, 3 holds data 1
    grid = np.array(four_ranks[0]["hybrid_grid"])
    np.testing.assert_array_equal(grid[:, 0, 0, :], [[0, 2], [1, 3]])
    for r, rank in enumerate(four_ranks):
        d, m, s, p = rank["hybrid"]["coords"]
        assert grid[d, m, s, p] == r
        assert rank["hybrid"]["groups"] == {
            "data": sorted(grid[:, 0, 0, p].tolist()),
            "pipe": sorted(grid[d, 0, 0, :].tolist())}
        assert rank["hybrid"]["sums"] == {
            "data": float(grid[:, 0, 0, p].sum()),
            "pipe": float(grid[d, 0, 0, :].sum())}
        assert rank["hybrid"]["model_chief"] == r
