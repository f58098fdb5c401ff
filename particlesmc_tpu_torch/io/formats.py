"""Configuration/trajectory file formats: XYZ, EXYZ, LAMMPS dump (this
package's own copy of particlesmc_tpu/io/formats.py, numpy only).

Re-implements the reference's three dialects exactly (readers and writers), so
files are interchangeable with the Julia package:
- XYZ: in-house dialect, header `N` + metadata line with `columns:...`,
  `cell:Lx,Ly[,Lz]`, `rho:`, `T:` (reference src/IO/xyz.jl:39-84).
- EXYZ: extended-XYZ with `Lattice="9 floats"` diagonal box and
  `Properties=name:T:dim` triples (reference src/IO/exyz.jl:8-62).
- LAMMPS: `ITEM: TIMESTEP/NUMBER OF ATOMS/BOX BOUNDS/ATOMS` dump
  (reference src/IO/lammps.jl:63-106); 2D written with dummy z-bounds.

Parsed configurations are plain dicts of numpy arrays:
{N, d, box, species, position, metadata[, molecule]}
(mirrors reference src/IO/IO.jl:41-100). Species ids stay 1-based here (file
convention); conversion to 0-based happens in state construction. A molecule
column is read so that the loader can refuse molecular systems; their bond
sections come with ROADMAP.md queue 1 item 7.
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


def _frame_rows(species, position, digits):
    return [f"{species[k]} {_fmt_pos(position[k], digits)}" for k in range(len(species))]


def write_xyz_frame(
    species,
    position,
    box,
    step: int,
    rho: float,
    T: float,
    digits: int = 6,
) -> str:
    """One XYZ frame (header per reference src/IO/xyz.jl:79-84)."""
    N = len(species)
    cell = ",".join(repr(float(b)) for b in box)
    lines = [
        str(N),
        f"step:{step} columns:species,position dt:1 cell:{cell} rho:{float(rho)} T:{float(T)}",
    ]
    lines += _frame_rows(species, position, digits)
    return "\n".join(lines) + "\n"


def write_exyz_frame(
    species,
    position,
    box,
    step: int,
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
    lines = [
        str(N),
        f'Lattice="{lat}" Properties=:species:S:1:pos:R:{d} Time={step}',
    ]
    lines += _frame_rows(species, position, digits)
    return "\n".join(lines) + "\n"


def write_lammps_frame(
    species,
    position,
    box,
    step: int,
    digits: int = 6,
) -> str:
    """One LAMMPS dump frame (header per reference src/IO/lammps.jl:88-106)."""
    d = len(box)
    lines = ["ITEM: TIMESTEP", str(step), "ITEM: NUMBER OF ATOMS", str(len(species))]
    lines.append("ITEM: BOX BOUNDS pp pp pp")
    for i in range(d):
        lines.append(f"0.0 {float(box[i])}")
    if d == 2:
        lines.append("-0.1 0.1")
    axes = "x y" if d == 2 else "x y z"
    lines.append(f"ITEM: ATOMS type {axes}")
    lines += _frame_rows(species, position, digits)
    return "\n".join(lines) + "\n"


_WRITERS = {"xyz": write_xyz_frame, "exyz": write_exyz_frame, "lammps": write_lammps_frame}


def write_frame(fmt: str, **kwargs) -> str:
    """One frame in `fmt`; only the xyz dialect takes `rho` and `T`."""
    return _WRITERS[fmt](**kwargs)
