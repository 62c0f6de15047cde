"""Dry run of every cell on the production meshes, the counterpart of
``repro/launch/dryrun.py``, on the CPU with no process group:

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
        --shape train_4k --mesh multipod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

For each cell at (16, 16) and (2, 16, 16) (``--mesh singlepod``,
``multipod`` or ``both``) it builds the cell for one rank
(``launch.steps.build_cell`` on an ``AbstractMesh`` at the first rank's
coordinate) and reports the bytes that rank holds in
parameters, optimizer state, other state (KV caches, RQ histograms, the
negative pool) and batch, read from the layouts and the ``meta`` tensors
(nothing is allocated), with ``model_flops`` and the cell's notes.  One
JSON record a line on stdout, or in ``--out`` (a path the caller names,
or ``build/dryrun.jsonl`` with ``--out build``).

XLA's memory, cost and collective analyses have no counterpart: the
port compiles nothing ahead of a run.  The header and every record say
so; no such figure is reported.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch

from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.steps import Cell, all_cells, build_cell

NO_XLA = ("not reported: XLA's memory, cost and collective analyses have no "
          "counterpart in the port, which compiles nothing ahead of a run")
MESHES = {"singlepod": False, "multipod": True}


def tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a tree: dicts, lists, tuples, named tuples,
    dataclasses and modules (their parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def cell_record(cell: Cell, mesh_kind: str, coords: Sequence[int],
                build_s: float) -> Dict[str, Any]:
    """One rank's bytes of a cell by role, its FLOPs and notes."""
    parts = {k: nbytes(cell.parts.get(k)) for k in
             ("params", "opt_state", "state", "batch")}
    return {"arch": cell.arch_id, "shape": cell.shape_name,
            "mesh": mesh_kind, "rank_coords": list(coords),
            "bytes": dict(parts, total=sum(parts.values())),
            "model_flops": cell.model_flops, "notes": cell.notes,
            "build_s": build_s, "xla_analyses": NO_XLA}


def run(cells: List[tuple], meshes: Sequence[str]) -> List[Dict[str, Any]]:
    out = []
    for mesh_kind in meshes:
        mesh = abstract_production_mesh(MESHES[mesh_kind])
        for arch_id, shape_name in cells:
            t0 = time.perf_counter()
            cell = build_cell(arch_id, shape_name, mesh)
            out.append(cell_record(cell, mesh_kind, mesh.coords,
                                   time.perf_counter() - t0))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=("singlepod", "multipod", "both"))
    ap.add_argument("--list", action="store_true",
                    help="print the cells and exit")
    ap.add_argument("--out", help="write the records to this file (or to "
                                  "build/dryrun.jsonl for 'build')")
    a = ap.parse_args(argv)
    cells = [(x, s) for x, s in all_cells()
             if (a.arch is None or x == a.arch)
             and (a.shape is None or s == a.shape)]
    if a.list:
        for x, s in cells:
            print(f"{x} {s}")
        return 0
    if not cells:
        print("no such cell", file=sys.stderr)
        return 1
    meshes = list(MESHES) if a.mesh == "both" else [a.mesh]
    header = {"dryrun": "repro_torch", "cells": len(cells),
              "meshes": meshes, "device": "meta (nothing allocated)",
              "xla_analyses": NO_XLA}
    records = run(cells, meshes)
    lines = [json.dumps(header)] + [json.dumps(r) for r in records]
    if a.out:
        path = os.path.join("build", "dryrun.jsonl") if a.out == "build" \
            else a.out
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {len(records)} records to {path}")
    else:
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
