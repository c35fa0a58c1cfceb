"""Tiny versions of the benchmark's cells for the CPU tests."""

from __future__ import annotations

from ldbench import manifest


def tiny_cell(name: str, n_sites: int = 500, n_ind: int = 16,
              warm_sites: int = 120) -> tuple:
    bench = manifest.load_benchmark()
    cell = manifest.cell(name, bench)
    cell.update(n_sites=n_sites, warm_sites=warm_sites)
    cell["config"] = dict(cell["config"], n_ind=n_ind)
    return bench, cell
