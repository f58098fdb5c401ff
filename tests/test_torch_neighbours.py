"""The port's cell list (core/neighbours.py) against the JAX package's:
tests/test_neighbours.py's patterns on the port, and the bucket arrays equal
to JAX's after a build and after a sequence of move_particle calls."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from particlesmc_tpu.core import neighbours as JNB
from particlesmc_tpu.core.geometry import dist2 as j_dist2
from particlesmc_tpu_torch.core import neighbours as TNB

torch.set_num_threads(1)


def _random_chains(n=100, d=3, box_l=9.0, seeds=(0, 1)):
    pos = np.stack([np.random.default_rng(s).uniform(0, box_l, (n, d)) for s in seeds])
    return pos, np.full((len(seeds), d), box_l)


def _build(pos, box, spec):
    return TNB.build_cell_list(torch.tensor(pos), torch.tensor(box), TNB.CellSpec(spec.ncells, spec.cap))


def _assert_equal(tl, jls):
    """A batched port CellList equals the JAX lists of its chains."""
    for f in ("bucket", "count", "cell_of", "overflow"):
        np.testing.assert_array_equal(
            getattr(tl, f).numpy(), np.stack([np.asarray(getattr(j, f)) for j in jls]), err_msg=f
        )


def test_spec_sizing_matches_jax():
    for box, rcut, n, cap in ((np.full(3, 9.0), 2.5, 100, None), (np.full(3, 6.0), 2.5, 100, None),
                              (np.array([12.0, 7.5]), 2.5, 300, None), (np.full(3, 9.0), 2.5, 100, 5)):
        j, t = JNB.make_spec(box, rcut, n, cap), TNB.make_spec(box, rcut, n, cap)
        assert (j is None) == (t is None)
        if j is not None:
            assert (t.ncells, t.cap, t.total, t.n_neighbour_cells) == (j.ncells, j.cap, j.total, j.n_neighbour_cells)
    assert TNB.make_spec(np.full(3, 6.0), 2.5, 100) is None  # fewer than 3 cells: dense


def test_build_matches_jax():
    pos, box = _random_chains(n=200)
    spec = JNB.make_spec(box[0], 2.5, 200)
    tl = _build(pos, box, spec)
    _assert_equal(tl, [JNB.build_cell_list(jnp.asarray(p), jnp.asarray(box[0]), spec) for p in pos])
    # every particle exactly once, counts summing to N
    assert (tl.count.sum(dim=1) == 200).all()
    for b in range(2):
        ids = sorted(int(x) for x in tl.bucket[b].reshape(-1) if x >= 0)
        assert ids == list(range(200))
    x = torch.tensor(pos[:, :7])
    np.testing.assert_array_equal(
        TNB.cell_index(x, torch.tensor(box)[:, None], TNB.CellSpec(spec.ncells, spec.cap)).numpy(),
        np.stack([np.asarray(JNB.cell_index(jnp.asarray(p[:7]), jnp.asarray(box[0]), spec)) for p in pos]),
    )


def test_candidates_complete_and_match_jax():
    """Every particle within rcut of a query is a candidate, and the
    candidate vector is JAX's, lane for lane."""
    pos, box = _random_chains()
    spec = JNB.make_spec(box[0], 2.5, 100)
    tspec = TNB.CellSpec(spec.ncells, spec.cap)
    tl = _build(pos, box, spec)
    q = [0, 13, 57, 99]
    x = torch.tensor(pos[:, q])  # [B, Q, d]
    cands = TNB.candidates_around(x, torch.tensor(box), tl, tspec).numpy()
    assert cands.shape == (2, 4, 27 * spec.cap)
    for b in range(2):
        jl = JNB.build_cell_list(jnp.asarray(pos[b]), jnp.asarray(box[b]), spec)
        for k, qi in enumerate(q):
            xq = jnp.asarray(pos[b, qi])
            np.testing.assert_array_equal(cands[b, k], np.asarray(JNB.candidates_around(xq, jnp.asarray(box[b]), jl, spec)))
            r2 = np.asarray(j_dist2(jnp.asarray(pos[b]), xq, jnp.asarray(box[b])))
            assert set(np.flatnonzero(r2 <= 2.5**2).tolist()) <= set(int(c) for c in cands[b, k] if c >= 0)
    np.testing.assert_array_equal(
        TNB.neighbour_cells_of(x, torch.tensor(box)[:, None], tspec)[0, 0].numpy(),
        np.asarray(JNB.neighbour_cells_of(jnp.asarray(pos[0, 0]), jnp.asarray(box[0]), spec)),
    )


def test_move_particle_matches_jax_and_rebuild():
    """200 random moves per chain (positions may leave the box): the
    incremental lists equal JAX's incremental lists array for array, and a
    fresh build up to the order within each bucket."""
    pos, box = _random_chains(n=100)
    spec = JNB.make_spec(box[0], 2.5, 100)
    tspec = TNB.CellSpec(spec.ncells, spec.cap)
    tl = _build(pos, box, spec)
    jls = [JNB.build_cell_list(jnp.asarray(p), jnp.asarray(box[0]), spec) for p in pos]
    move = jax.jit(JNB.move_particle)
    rng = np.random.default_rng(1)
    pos = pos.copy()
    for _ in range(200):
        i = rng.integers(0, 100, 2)
        newx = rng.uniform(-5, 14, (2, 3))
        pos[[0, 1], i] = newx
        new_cell = TNB.cell_index(torch.tensor(newx), torch.tensor(box), tspec)
        tl = TNB.move_particle(tl, torch.tensor(i), new_cell)
        for b in range(2):
            jc = JNB.cell_index(jnp.asarray(newx[b]), jnp.asarray(box[b]), spec)
            assert int(jc) == int(new_cell[b])
            jls[b] = move(jls[b], jnp.asarray(i[b], jnp.int32), jc)
    _assert_equal(tl, jls)
    fresh = _build(pos, box, spec)
    assert not tl.overflow.any()
    np.testing.assert_array_equal(tl.count.numpy(), fresh.count.numpy())
    np.testing.assert_array_equal(tl.cell_of.numpy(), fresh.cell_of.numpy())
    for b in range(2):
        for c in range(spec.total):
            a = sorted(int(x) for x in tl.bucket[b, c] if x >= 0)
            assert a == sorted(int(x) for x in fresh.bucket[b, c] if x >= 0)


def test_overflow_flag():
    """A too-small cap sets the flag at the build (only in the chain that
    overflows), and a dropped insert sets it on a move."""
    pos, box = _random_chains(n=100)
    tight = TNB.CellSpec(ncells=(3, 3, 3), cap=2)
    tl = TNB.build_cell_list(torch.tensor(pos), torch.tensor(box), tight)
    assert tl.overflow.all()
    assert (tl.count <= 2).all()
    spec = TNB.CellSpec(ncells=(3, 3, 3), cap=12)
    x = np.concatenate([pos[:1, :40], np.full((1, 1, 3), 0.5)], axis=1)  # 1 particle in cell 0
    x[0, :11] = 0.5  # 12 particles in cell 0: full
    tl = TNB.build_cell_list(torch.tensor(x), torch.tensor(box[:1]), spec)
    assert not tl.overflow.any() and int(tl.count[0, 0]) == 12
    far = int(np.argmax(tl.cell_of[0].numpy() != 0))
    out = TNB.move_particle(tl, torch.tensor([far]), torch.tensor([0]))
    assert out.overflow.all() and not tl.overflow.any()  # functional: the input is kept
    assert int(out.count[0, 0]) == 12 and int(out.cell_of[0, far]) == 0
