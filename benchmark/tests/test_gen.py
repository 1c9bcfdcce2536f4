"""The frozen generator gives the program's samples bit for bit."""

import numpy as np
import pytest

from benchmark.benchlib import gen, pool


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17])
def test_frozen_generator_matches_program(seed):
    from psignn_tpu_torch.data.fem import solve_poisson
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    rng_a = np.random.default_rng(seed)
    rng_b = np.random.default_rng(seed)
    for radius in (0.6, 1.0, 2.0):
        ours = gen.psignn_sample_from_fem(gen.solve_poisson(
            gen.blob_mesh(radius, 0.08, rng_a), radius, rng_a))
        mesh = blob_mesh(radius=radius, hsize=0.08, rng=rng_b)
        theirs = psignn_sample_from_fem(solve_poisson(mesh, radius, rng_b))
        assert sorted(ours) == sorted(theirs)
        for key in ours:
            assert ours[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_pool_is_the_same_for_every_run_seed_and_order_varies():
    tr = dict(radii=[0.6, 1.0], meshes_per_radius=2, hsize=0.08,
              pool_seed=0)
    a, b = pool.mesh_pool(tr), pool.mesh_pool(tr)
    assert [s["n"] for s in a] == [s["n"] for s in b]
    o1, o2 = pool.request_order(4, 1), pool.request_order(4, 2 ** 40 + 3)
    first = [o1(k) for k in range(8)]
    assert sorted(first[:4]) == sorted(first[4:]) == [0, 1, 2, 3]
    assert first == [pool.request_order(4, 1)(k) for k in range(8)]
    assert first != [o2(k) for k in range(8)]
    assert pool.request_order(4, -5)(0) in range(4)


def test_cached_pool_is_the_drawn_pool():
    tr = dict(radii=[0.6, 1.0], meshes_per_radius=2, hsize=0.08,
              pool_seed=7)
    drawn = pool._draw(tr)
    for _ in range(2):                    # the run that keeps, the next
        kept = pool.mesh_pool(tr)
        assert len(kept) == len(drawn)
        for a, b in zip(drawn, kept):
            for key in pool.KEYS:
                assert a[key].dtype == b["sample"][key].dtype
                np.testing.assert_array_equal(a[key], b["sample"][key])
