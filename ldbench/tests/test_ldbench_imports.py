"""The import check: at a run's start and once the window has closed,
no loaded module may be JAX or the JAX package, by whole top-level
name."""

from __future__ import annotations

import sys
import types

from ldbench import guard, run


def test_top_level_names_compare_whole():
    assert guard.forbidden_modules(["ngsld_tpu_torch", "ngsld_tpu_torch.cli",
                                    "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(["ngsld_tpu.engine", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "ngsld_tpu"]


def test_a_run_refuses_to_start_with_jax_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "converge.snp128_rnd10", "--seed", "1",
                   "--seconds", "1"], require_card=False)
    assert rc != 0
    cap = capsys.readouterr()
    assert cap.out == "" and "jax" in cap.err


def test_a_run_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "converge.snp128_rnd10", "--seed", "1",
                   "--seconds", "1"])
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == ""


def test_the_program_loads_no_forbidden_module():
    import ngsld_tpu_torch.engine  # noqa: F401
    import ldbench.run  # noqa: F401
    assert guard.forbidden_modules() == []
