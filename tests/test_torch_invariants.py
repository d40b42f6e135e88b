"""The repo's invariant linter over the port, on the CPU.

`tools/check_invariants.py` checks the package named `lachain_tpu` under a
root: determinism of the consensus modules (rule D), the lock order over
every lock and the tracer and metrics singletons (L), persist before
transmit (P), evidence counted only after it is persisted (E) and the
metric names' suffixes (M). Here it runs over the port, through a
temporary root whose `lachain_tpu` is a symbolic link to
`lachain_tpu_torch/`, and must find no violation.
"""
from __future__ import annotations

import importlib.util
import os

import torch

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _linter():
    spec = importlib.util.spec_from_file_location(
        "check_invariants", os.path.join(_ROOT, "tools", "check_invariants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_has_no_invariant_violation(tmp_path, capsys):
    os.symlink(os.path.join(_ROOT, "lachain_tpu_torch"), tmp_path / "lachain_tpu")
    assert _linter().run(str(tmp_path)) == 0
    out = capsys.readouterr()
    assert out.out == ""  # one line a violation
    assert "check_invariants: 0 violation(s)" in out.err
