"""Configuration/trajectory file formats: XYZ, EXYZ, LAMMPS dump (this
package's own copy of particlesmc_tpu/io/formats.py, numpy only).

Re-implements the reference's three dialects exactly (readers and writers), so
files are interchangeable with the Julia package:
- XYZ: in-house dialect, header `N` + metadata line with `columns:...`,
  `cell:Lx,Ly[,Lz]`, `rho:`, `T:` (reference src/IO/xyz.jl:39-84); bonds appended
  after the frame as `N_bonds\ncolumns:bond\ni j` (src/IO/xyz.jl:61-77).
- EXYZ: extended-XYZ with `Lattice="9 floats"` diagonal box and
  `Properties=name:T:dim` triples (reference src/IO/exyz.jl:8-62); bonds as
  `N_bonds\nProperties=bond:I:2\ni j`.
- LAMMPS: `ITEM: TIMESTEP/NUMBER OF ATOMS/BOX BOUNDS/ATOMS` dump
  (reference src/IO/lammps.jl:63-106); 2D written with dummy z-bounds.

Parsed configurations are plain dicts of numpy arrays:
{N, d, box, species, position, metadata[, molecule, bond_pairs]}
(mirrors reference src/IO/IO.jl:41-100). Species/molecule ids stay 1-based
here (file convention); conversion to 0-based happens in state construction.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np


class FormatError(ValueError):
    pass


def _split(line: str) -> List[str]:
    return line.split()


# ---------------------------------------------------------------------------
# Column-info parsing
# ---------------------------------------------------------------------------


def _parse_columns_xyz(column_str: str, d: int) -> Dict[str, tuple]:
    """`columns:molecule,species,position` → {name: (dim, index)} with 0-based
    token index (reference src/IO/xyz.jl:12-37)."""
    info = {}
    index = 0
    for name in column_str.split(","):
        if name == "molecule":
            info["molecule"] = (1, index)
        elif name == "species":
            info["species"] = (1, index)
        elif name == "position":
            info["pos"] = (d, index)
        elif name == "bond":
            info["bond"] = (2, index)
        elif name == "btype":
            info["btype"] = (1, index)
        else:
            raise FormatError(f"column {name!r} is not supported")
        index += 1
    return info


def _parse_columns_exyz(column_str: str) -> Dict[str, tuple]:
    """`Properties=molecule:I:1:species:S:1:pos:R:3` → {name: (dim, index)}
    (reference src/IO/exyz.jl:8-26). Leading empty name tokens are skipped."""
    toks = column_str.split(":")
    info = {}
    i = 0
    index = 0
    types = ("S", "I", "R")
    while i < len(toks):
        if i + 2 < len(toks) + 1 and i + 1 < len(toks) and toks[i + 1] in types:
            name = toks[i]
            dim = int(toks[i + 2])
            info[name] = (dim, index)
            index += dim
            i += 3
        else:
            i += 1
    return info


def _parse_columns_lammps(column_str: str) -> Dict[str, tuple]:
    """`ITEM: ATOMS [molecule] type x y [z]` → {name: (dim, index)}
    (reference src/IO/lammps.jl:35-61)."""
    cols = column_str.split()
    if cols[:2] == ["ITEM:", "ATOMS"]:
        cols = cols[2:]
    info = {}
    for index, name in enumerate(cols):
        if name == "molecule":
            info["molecule"] = (1, index)
        elif name == "type":
            info["species"] = (1, index)
        elif name == "x":
            dim = 3 if {"x", "y", "z"} <= set(cols) else 2
            info["pos"] = (dim, index)
        elif name in ("y", "z"):
            continue
        else:
            raise FormatError(f"column {name!r} is not supported")
    return info


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


def _read_frame_lines(lines, start, info, N):
    species = np.ones(N, np.int64)
    molecule = None
    if "molecule" in info:
        molecule = np.zeros(N, np.int64)
    pos_d, pos_i = info["pos"]
    position = np.zeros((N, pos_d), np.float64)
    sp_i = info["species"][1] if "species" in info else None
    mol_i = info["molecule"][1] if "molecule" in info else None
    for k in range(N):
        toks = _split(lines[start + k])
        if sp_i is not None:
            species[k] = int(toks[sp_i])
        if mol_i is not None:
            molecule[k] = int(toks[mol_i])
        position[k] = [float(t) for t in toks[pos_i : pos_i + pos_d]]
    return species, molecule, position


def _read_bond_pairs(lines, n_bonds, col_index=0):
    pairs = np.zeros((n_bonds, 2), np.int64)
    for k in range(n_bonds):
        toks = _split(lines[k])
        pairs[k] = (int(toks[col_index]), int(toks[col_index + 1]))
    return pairs


def read_xyz(text: str, frame: int = 0) -> Dict:
    """Parse the in-house XYZ dialect (reference src/IO/xyz.jl:39-51)."""
    lines = text.splitlines()
    N = int(lines[0].strip())
    meta = _split(lines[1])
    cell_tok = next(t for t in meta if t.startswith("cell:"))
    box = np.array([float(v) for v in cell_tok[len("cell:") :].split(",")])
    d = len(box)
    col_tok = next(t for t in meta if t.startswith("columns:"))
    info = _parse_columns_xyz(col_tok[len("columns:") :], d)

    start = (N + 2) * frame + 2
    species, molecule, position = _read_frame_lines(lines, start, info, N)
    out = dict(N=N, d=d, box=box, species=species, position=position, metadata=meta)
    if molecule is not None:
        out["molecule"] = molecule
        # bonds section: N_bonds line + `columns:bond` + pairs (src/IO/xyz.jl:61-77)
        brow = start + N
        if brow >= len(lines):
            raise FormatError("No bonds found in the file")
        n_bonds = int(lines[brow].strip())
        bcols = _parse_columns_xyz(lines[brow + 1].replace("columns:", ""), d)
        if "bond" not in bcols:
            raise FormatError("Bond array is not written in the XYZ file")
        out["bond_pairs"] = _read_bond_pairs(lines[brow + 2 :], n_bonds, bcols["bond"][1])
    return out


def read_exyz(text: str, frame: int = 0) -> Dict:
    """Parse extended-XYZ (reference src/IO/exyz.jl:28-48)."""
    lines = text.splitlines()
    N = int(lines[0].strip())
    meta_line = lines[1]
    m = re.search(r'Lattice="(.*?)"', meta_line)
    if m is None:
        raise FormatError("Invalid Lattice line format")
    lat = np.array([float(v) for v in m.group(1).split()])
    if lat.size != 9:
        raise FormatError("Lattice matrix must have 9 elements")
    diag = lat.reshape(3, 3).diagonal()
    cm = re.search(r"Properties=(\S*)", meta_line)
    info = _parse_columns_exyz(cm.group(1))
    pos_d = info["pos"][0]
    box = diag[:pos_d].copy()

    start = (N + 2) * frame + 2
    species, molecule, position = _read_frame_lines(lines, start, info, N)
    out = dict(N=N, d=pos_d, box=box, species=species, position=position, metadata=_split(meta_line))
    if molecule is not None:
        out["molecule"] = molecule
        brow = start + N
        if brow >= len(lines):
            raise FormatError("No bonds found in the file")
        n_bonds = int(lines[brow].strip())
        bm = re.search(r"Properties=(\S*)", lines[brow + 1])
        binfo = _parse_columns_exyz(bm.group(1)) if bm else _parse_columns_xyz(
            lines[brow + 1].replace("columns:", ""), pos_d
        )
        if "bond" not in binfo:
            raise FormatError("Bond array is not written in the EXYZ file")
        out["bond_pairs"] = _read_bond_pairs(lines[brow + 2 :], n_bonds, binfo["bond"][1])
    return out


def read_lammps(text: str, frame: int = 0) -> Dict:
    """Parse a LAMMPS dump frame (reference src/IO/lammps.jl:75-86)."""
    lines = text.splitlines()

    def find(tag, from_=0):
        for i in range(from_, len(lines)):
            if tag in lines[i]:
                return i
        raise FormatError(f"missing {tag!r}")

    base = 0
    for _ in range(frame):
        base = find("ITEM: TIMESTEP", base) + 1
    nat = find("ITEM: NUMBER OF ATOMS", base)
    N = int(lines[nat + 1])
    bb = find("ITEM: BOX BOUNDS", base)
    bounds = [[float(v) for v in _split(lines[bb + 1 + k])] for k in range(3)]
    box3 = np.array([hi - lo for lo, hi in bounds])
    ai = find("ITEM: ATOMS", base)
    info = _parse_columns_lammps(lines[ai])
    pos_d = info["pos"][0]
    box = box3[:pos_d]

    species, molecule, position = _read_frame_lines(lines, ai + 1, info, N)
    out = dict(N=N, d=pos_d, box=box, species=species, position=position, metadata=[])
    if molecule is not None:
        out["molecule"] = molecule
    return out


_READERS = {"xyz": read_xyz, "exyz": read_exyz, "lammps": read_lammps}
_EXT_TO_FORMAT = {
    ".xyz": "xyz",
    ".exyz": "exyz",
    ".lmp": "lammps",
    ".lammpstrj": "lammps",
    ".lammps": "lammps",
}
FORMAT_EXTENSION = {"xyz": ".xyz", "exyz": ".exyz", "lammps": ".lammpstrj"}


def format_for_path(path: str) -> str:
    """Format dispatch by extension (reference src/IO/IO.jl:27-39)."""
    for ext, fmt in _EXT_TO_FORMAT.items():
        if str(path).endswith(ext):
            return fmt
    raise FormatError(f"Unsupported file format: {path}")


def read_configuration(path: str, frame: int = 0) -> Dict:
    fmt = format_for_path(path)
    with open(path) as f:
        return _READERS[fmt](f.read(), frame)


def read_trajectory(path: str) -> List[Dict]:
    """Parse every frame of an appended XYZ/EXYZ trajectory file.

    Trajectory frames carry no bond sections (the reference stores bonds only
    in last-frames, src/IO/IO.jl:383-391), so bonds are not expected here.
    Each returned dict additionally has "step" extracted from the frame
    header (`step:` in the XYZ dialect, `Time=` in EXYZ).
    """
    fmt = format_for_path(path)
    if fmt not in ("xyz", "exyz"):
        raise FormatError("read_trajectory supports the xyz/exyz dialects")
    with open(path) as f:
        lines = f.read().splitlines()
    frames: List[Dict] = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        N = int(lines[i].strip())
        header = lines[i + 1]
        if fmt == "xyz":
            m = re.search(r"columns:(\S+)", header)
            cm = re.search(r"cell:(\S+)", header)
            box = np.array([float(v) for v in cm.group(1).split(",")])
            info = _parse_columns_xyz(m.group(1), len(box))
            sm = re.search(r"step:(\S+)", header)
            step = int(sm.group(1)) if sm else len(frames)
        else:
            lm = re.search(r'Lattice="(.*?)"', header)
            lat = np.array([float(v) for v in lm.group(1).split()]).reshape(3, 3)
            cm = re.search(r"Properties=(\S*)", header)
            info = _parse_columns_exyz(cm.group(1))
            box = lat.diagonal()[: info["pos"][0]].copy()
            sm = re.search(r"Time=(\S+)", header)
            step = int(float(sm.group(1))) if sm else len(frames)
        species, molecule, position = _read_frame_lines(lines, i + 2, info, N)
        fr = dict(
            N=N, d=len(box), box=box, species=species, position=position, step=step
        )
        if molecule is not None:
            fr["molecule"] = molecule
        frames.append(fr)
        i += N + 2
    return frames


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------


def _fmt_pos(position_row: Sequence[float], digits: int) -> str:
    return " ".join(f"{v:.{digits}f}" for v in position_row)


def _frame_rows(species, position, molecule, digits):
    rows = []
    for k in range(len(species)):
        lead = f"{molecule[k]} " if molecule is not None else ""
        rows.append(f"{lead}{species[k]} {_fmt_pos(position[k], digits)}")
    return rows


def _bond_rows(bond_pairs) -> List[str]:
    return [f"{i} {j}" for i, j in bond_pairs]


def write_xyz_frame(
    species,
    position,
    box,
    step: int,
    rho: float,
    T: float,
    molecule=None,
    bond_pairs=None,
    digits: int = 6,
) -> str:
    """One XYZ frame (header per reference src/IO/xyz.jl:79-84)."""
    N = len(species)
    cell = ",".join(repr(float(b)) for b in box)
    molcol = "molecule," if molecule is not None else ""
    lines = [
        str(N),
        f"step:{step} columns:{molcol}species,position dt:1 cell:{cell} rho:{float(rho)} T:{float(T)}",
    ]
    lines += _frame_rows(species, position, molecule, digits)
    if bond_pairs is not None:
        lines += [str(len(bond_pairs)), "columns:bond"] + _bond_rows(bond_pairs)
    return "\n".join(lines) + "\n"


def write_exyz_frame(
    species,
    position,
    box,
    step: int,
    molecule=None,
    bond_pairs=None,
    digits: int = 6,
) -> str:
    """One EXYZ frame (header per reference src/IO/exyz.jl:54-62, 91-96)."""
    N = len(species)
    d = len(box)
    if d == 2:
        lat = f"{float(box[0])} 0.0 0.0 0.0 {float(box[1])} 0.0 0.0 0.0 0.0"
    elif d == 3:
        lat = f"{float(box[0])} 0.0 0.0 0.0 {float(box[1])} 0.0 0.0 0.0 {float(box[2])}"
    else:
        raise FormatError("Box vector must have 2 or 3 elements.")
    molcol = "molecule:I:1" if molecule is not None else ""
    lines = [
        str(N),
        f'Lattice="{lat}" Properties={molcol}:species:S:1:pos:R:{d} Time={step}',
    ]
    lines += _frame_rows(species, position, molecule, digits)
    if bond_pairs is not None:
        lines += [str(len(bond_pairs)), "Properties=bond:I:2"] + _bond_rows(bond_pairs)
    return "\n".join(lines) + "\n"


def write_lammps_frame(
    species,
    position,
    box,
    step: int,
    molecule=None,
    bond_pairs=None,
    digits: int = 6,
) -> str:
    """One LAMMPS dump frame (header per reference src/IO/lammps.jl:88-106)."""
    if bond_pairs is not None:
        raise FormatError("LAMMPS format does not support bonds format yet.")
    d = len(box)
    lines = ["ITEM: TIMESTEP", str(step), "ITEM: NUMBER OF ATOMS", str(len(species))]
    lines.append("ITEM: BOX BOUNDS pp pp pp")
    for i in range(d):
        lines.append(f"0.0 {float(box[i])}")
    if d == 2:
        lines.append("-0.1 0.1")
    molcol = "molecule " if molecule is not None else ""
    axes = "x y" if d == 2 else "x y z"
    lines.append(f"ITEM: ATOMS {molcol}type {axes}")
    lines += _frame_rows(species, position, molecule, digits)
    return "\n".join(lines) + "\n"


_WRITERS = {"xyz": write_xyz_frame, "exyz": write_exyz_frame, "lammps": write_lammps_frame}


def write_frame(fmt: str, **kwargs) -> str:
    """One frame in `fmt`; only the xyz dialect takes `rho` and `T`."""
    return _WRITERS[fmt](**kwargs)
