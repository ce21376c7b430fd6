"""A run with the timed path broken underneath comes out not correct."""

import pytest
import torch

from avatarbench.tests import tiny


def _unchanged(monkeypatch):
    from gaussianavatars_torch.train import optim

    def apply(params, grads, mu, nu, count, lrs):
        return params, mu, nu, count + 1

    monkeypatch.setattr(optim, "apply", apply)


def _stale_in_window(monkeypatch):
    """Sound through the warm-up's steps, then a step that returns its
    state unchanged, as a stale replay would."""
    from gaussianavatars_torch.train import optim
    real, calls = optim.apply, []

    def apply(params, grads, mu, nu, count, lrs):
        calls.append(1)
        if len(calls) <= 3:              # the tiny warm-up's steps
            return real(params, grads, mu, nu, count, lrs)
        return params, mu, nu, count + 1

    monkeypatch.setattr(optim, "apply", apply)


def _half_rows(monkeypatch):
    from gaussianavatars_torch.train import loop
    real = loop.compute_losses

    def compute_losses(image, gt, *args):
        rows = image.shape[1] // 2
        return real(image[:, :rows], gt[:, :rows], *args)

    monkeypatch.setattr(loop, "compute_losses", compute_losses)


def _altered(monkeypatch):
    from gaussianavatars_torch.train import loop
    real = loop.rasterize

    def rasterize(*args, **kwargs):
        out = real(*args, **kwargs)
        image = out.image.clone()
        image[:, :8, :8] = torch.clamp(image[:, :8, :8] + 0.05, 0.0, 1.0)
        return out._replace(image=image)

    monkeypatch.setattr(loop, "rasterize", rasterize)


@pytest.mark.parametrize("workload,fault", [
    ("avatar-train", _unchanged), ("avatar-train", _half_rows),
    ("cloud-train", _unchanged), ("cloud-train", _half_rows),
    ("cloud-train", _stale_in_window),
    ("avatar-replay", _altered), ("avatar-replay-native", _altered)])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = tiny.run(workload)
    assert not out["correct"], out["check"]
