"""The spatial decomposition's process-group transport: two gloo ranks on
the CPU, spawned by torch.multiprocessing in a fresh interpreter, each
stepping its own slab and exchanging halo columns by messages, against the
single-process device-list run of the same sweep. Neither this file nor the
ranks import JAX or the JAX package.

Run as a script (`python tests/test_torch_spatial_gloo.py PORT OUTDIR`) it
spawns the two ranks, each writing its final state to OUTDIR."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, CALLS = 2, 2


def _sweep(mesh):
    """Two calls of the Displacement + DoubleUniform sweep on the wide 2D
    system (16 x 4 cells) over `mesh`."""
    from particlesmc_tpu_torch.core.energy import initialize_energy
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import checkerboard as CB
    from particlesmc_tpu_torch.parallel import spatial as SP
    from tests.test_torch_inputs import wide_config

    pos, sp, box, rho = wide_config(seed=6)
    table = T.KobAndersen(device="cpu")
    st = initialize_energy(make_system(pos, sp, rho, 5.0, box=box, device="cpu"), table)
    spec = CB.make_cb_spec(st.box[0].numpy(), table.max_cutoff, st.n_particles)
    pool = (MB.displacement(0.1, 0.8), MB.discrete_swap(0, 1, 0.2))
    hs = SP.build_spatial_hyper_sweep_fn(spec, table, st.n_particles, mesh, inner=3, pool=pool)
    cb = CB.init_cb_state(st, spec, seed=21, n_moves=2)
    params = MB.init_pool_params(pool, device="cpu")
    for _ in range(CALLS):
        cb = hs(cb, params)
    return cb


def _rank(rank, world, port, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from particlesmc_tpu_torch.parallel import mesh as PM

    PM.init_distributed("cpu", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        mesh = PM.make_mesh(world, "cpu", group="world")
        cb = _sweep(mesh)
        block = PM.shard_chains({"x": torch.arange(4.0)}, mesh)["x"]
        rank0 = PM.replicate(torch.tensor([float(rank)]), mesh)
        bad = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "particlesmc_tpu"})
        torch.save({
            "position": cb.system.position, "species": cb.system.species, "energy": cb.system.energy,
            "attempted": cb.attempted, "accepted": cb.accepted, "backend": dist.get_backend(), "bad": bad,
            "first": mesh.first, "block": block, "rank0": rank0,
        }, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_ranks_match_device_list(tmp_path):
    """Each of the two gloo ranks ends with the single-process two-slab
    run's state, bitwise; no rank imported JAX."""
    from particlesmc_tpu_torch.parallel import mesh as PM

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(_free_port()), str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = _sweep(PM.make_mesh(RANKS, "cpu"))
    assert int(ref.accepted.sum()) > 50 and int(ref.accepted[:, 1].sum()) > 0
    for r in range(RANKS):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["backend"] == "gloo" and got["first"] == r and got["bad"] == []
        assert got["block"].tolist() == [2.0 * r, 2.0 * r + 1] and got["rank0"].tolist() == [0.0]
        assert torch.equal(got["position"], ref.system.position)
        assert torch.equal(got["species"], ref.system.species)
        assert torch.equal(got["attempted"], ref.attempted) and torch.equal(got["accepted"], ref.accepted)
        np.testing.assert_allclose(got["energy"].numpy(), ref.system.energy.numpy(), rtol=1e-13)


if __name__ == "__main__":
    torch.multiprocessing.spawn(_rank, args=(RANKS, int(sys.argv[1]), sys.argv[2]), nprocs=RANKS, join=True)
