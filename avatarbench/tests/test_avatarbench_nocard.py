"""A real run that finds no card fails and prints no result; the check
for JAX compares whole top-level names."""

import sys

import torch

from avatarbench import run


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cloud-train", "--seed", "5000000001",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert '"correct"' not in out.out
    assert "no CUDA device" in out.err


def test_forbidden_modules_by_whole_name(monkeypatch):
    assert "gaussianavatars_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "gaussianavatars_tpu.ops", object())
    assert run.forbidden_modules() == ["gaussianavatars_tpu", "jax"]
