"""The chain shards' process-group path: two gloo ranks on the CPU, spawned
by torch.multiprocessing in a fresh interpreter, each sweeping its block of
tools/multiprocess_common.build_batch's recipe (N = 64 KA-LJ in 3D, rho 0.8,
T 1.5, f64, sigma 0.1, 8 chains, 2 sweeps of the sequential kernel) and
all-gathering the chains, against the single-process run. Neither this file
nor the ranks import JAX or the JAX package.

Run as a script (`python tests/test_torch_chain_gloo.py PORT OUTDIR`) it
spawns the two ranks, each writing the gathered state to OUTDIR."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, CHAINS, SWEEPS = 2, 8, 2


def _batch():
    """build_batch's recipe in the port: one jittered lattice, 20% B, on
    every chain; the chains differ by their draws."""
    from particlesmc_tpu_torch.core.energy import initialize_energy
    from particlesmc_tpu_torch.core.state import make_system
    from particlesmc_tpu_torch.models import tables as T
    from particlesmc_tpu_torch.moves import base as MB
    from particlesmc_tpu_torch.moves import kernel as K

    n, dim, rho, temp = 64, 3, 0.8, 1.5
    rng = np.random.default_rng(11)
    L = (n / rho) ** (1 / dim)
    per = int(np.ceil(n ** (1 / dim)))
    a = L / per
    grid = np.stack(np.meshgrid(*[np.arange(per) * a + a / 2] * dim, indexing="ij"), -1).reshape(-1, dim)[:n]
    pos = grid + rng.uniform(-0.05 * a, 0.05 * a, (n, dim))
    species = (rng.random(n) < 0.2).astype(np.int32) + 1
    table = T.KobAndersen(device="cpu")
    st = initialize_energy(make_system(pos, species, rho, temp, device="cpu"), table).repeat(CHAINS)
    pool = (MB.displacement(0.1),)
    config = K.KernelConfig(pool=pool, table=table, cell_spec=None)
    return K.init_mc_state(st, config, seed=5), MB.init_pool_params(pool, device="cpu"), K.build_run_fn(config, n)


def run(mesh=None):
    """SWEEPS sweeps of every chain: in one process without `mesh`, else
    this rank's block of the process group's mesh, gathered."""
    from particlesmc_tpu_torch.parallel import mesh as PM

    mc, params, run_fn = _batch()
    if mesh is None:
        return run_fn(mc, params, SWEEPS)
    block = run_fn(PM.shard_chains(mc, mesh), PM.replicate(params, mesh), SWEEPS)
    return block, PM.gather_chains(block, mesh)


def _rank(rank, world, port, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from particlesmc_tpu_torch.parallel import mesh as PM

    PM.init_distributed("cpu", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        block, mc = run(PM.make_mesh(world, "cpu", group="world"))
        bad = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "particlesmc_tpu"})
        torch.save({
            "block": tuple(block.chains), "block_energy": block.system.energy,
            "position": mc.system.position, "energy": mc.system.energy, "chains": mc.chains,
            "attempted": mc.attempted, "accepted": mc.accepted, "backend": dist.get_backend(), "bad": bad,
        }, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_chain_shards_match_one_process(tmp_path):
    """Each rank sweeps its 4 chains; the all-gathered energies, positions
    and counters equal the single-process port run bitwise; no rank
    imported JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(_free_port()), str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = run()
    assert int(ref.accepted.sum()) > 0
    n = CHAINS // RANKS
    for r in range(RANKS):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["backend"] == "gloo" and got["bad"] == [] and got["chains"] is None
        assert got["block"] == (r * n, (r + 1) * n, CHAINS)
        assert torch.equal(got["block_energy"], ref.system.energy[r * n:(r + 1) * n])
        assert torch.equal(got["energy"], ref.system.energy)
        assert torch.equal(got["position"], ref.system.position)
        assert torch.equal(got["attempted"], ref.attempted) and torch.equal(got["accepted"], ref.accepted)


if __name__ == "__main__":
    torch.multiprocessing.spawn(_rank, args=(RANKS, int(sys.argv[1]), sys.argv[2]), nprocs=RANKS, join=True)
