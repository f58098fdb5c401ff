"""The yardstick's operation count against a brute-force count of pairs,
and the plain reference's energy against a direct double loop, on tiny
systems in 2D and 3D."""

import itertools
import math

import pytest
import torch

from perfbench import count, generate, spec
from perfbench.reference.energy import form, total_energy

CONFIGS = {name: spec.load_json(spec.ROOT / f"perfbench/configs/{name}.json") for name in ("ka3d-n10k", "jbb2d-n1000")}


def tiny(cfg, n, chains, seed=5):
    system = dict(cfg["system"], n=n)
    g = generate.start(system, cfg["start"], chains, seed, torch.device("cpu"))
    box = torch.full((chains, system["dim"]), g["box_side"], dtype=torch.float64)
    return g["position"], g["species"], box


def pair_energy(cfg, si, sj, r2):
    """u(r2) of one pair from the published formula, in plain Python."""
    pot = cfg["potential"]
    eps, sig = pot["eps"][si][sj], pot["sigma"][si][sj]
    rcut = pot["rcut_over_sigma"] * sig
    if r2 > rcut * rcut:
        return 0.0
    lj = lambda rr: 4 * eps * ((sig * sig / rr) ** 6 - (sig * sig / rr) ** 3)  # noqa: E731
    if pot["form"] == "lennard_jones":
        return lj(r2) - lj(rcut * rcut)
    c = pot["smoothing"]
    return lj(r2) + 4 * eps * (c["C0"] + c["C2"] * r2 / sig**2 + c["C4"] * r2 * r2 / sig**4)


def min_image_r2(xi, xj, L):
    return sum(((a - b) - L * round((a - b) / L)) ** 2 for a, b in zip(xi, xj))


@pytest.mark.parametrize("name,n", [("ka3d-n10k", 400), ("jbb2d-n1000", 120)])
def test_reference_energy_is_the_double_loop(name, n):
    cfg = CONFIGS[name]
    pos, sp, box = tiny(cfg, n, 2)
    got = total_energy(pos, sp, box, cfg["potential"])
    for b in range(2):
        x, s, L = pos[b].tolist(), sp[b].tolist(), float(box[b, 0])
        want = sum(pair_energy(cfg, s[i], s[j], min_image_r2(x[i], x[j], L)) for i in range(n) for j in range(i + 1, n))
        assert abs(float(got[b]) - want) <= 1e-10 * max(1.0, abs(want))


# the smallest sizes with 4 cells per dimension, as the program's grid needs
@pytest.mark.parametrize("name,n", [("ka3d-n10k", 1300), ("jbb2d-n1000", 120)])
def test_operation_count_is_the_brute_force_pair_count(name, n):
    cfg = CONFIGS[name]
    pot = cfg["potential"]
    sigma, inner = 0.06, 8
    pos, sp, box = tiny(cfg, n, 2)
    ops, nbytes, parts = count.submove_cost(pos, sp, box, pot, sigma, inner, torch.float32)
    d = pos.shape[-1]
    L = float(box[0, 0])
    nc = count.grid(L, count.max_cutoff(pot), d)[0]
    side = L / nc
    body = form(pot["form"]).BODY_OPS
    per_lane = 2 * (3 * d - 1) + 4
    cell_means = []
    for b in range(2):
        x, s = pos[b].tolist(), sp[b].tolist()
        cell_of = [tuple(min(nc - 1, int(math.floor(c / side))) for c in xi) for xi in x]
        members = {}
        for i, c in enumerate(cell_of):
            members.setdefault(c, []).append(i)
        for c, idx in members.items():
            hood = {tuple((c[k] + o[k]) % nc for k in range(d)) for o in itertools.product((-1, 0, 1), repeat=d)}
            block = [j for h in hood for j in members.get(h, [])]
            total = 0.0
            for i in idx:
                stay = 1.0
                for k in range(d):
                    lo = c[k] * side
                    stay *= 0.5 * (math.erf((lo + side - x[i][k]) / (sigma * math.sqrt(2))) - math.erf((lo - x[i][k]) / (sigma * math.sqrt(2))))
                near = 0
                for j in block:
                    if j == i:
                        continue
                    rc = pot["rcut_over_sigma"] * pot["sigma"][s[i]][s[j]]
                    near += min_image_r2(x[i], x[j], L) <= rc * rc
                total += stay * ((len(block) - 1) * per_lane + 2 * body * near)
            cell_means.append(total / len(idx))
    want = sum(cell_means) / len(cell_means)
    assert abs(ops - want) <= 1e-9 * want
    assert nbytes > 0 and parts["cells"] == [nc] * d
