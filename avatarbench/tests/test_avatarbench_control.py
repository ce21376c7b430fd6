"""The lower-precision control on the card: the reference with TF32 on,
in the program's place, must fail the cell's limits (run on the chip by
`python -m pytest avatarbench/tests -m chip`; skipped without a card).
The benchmark's runs do not run it; `python -m avatarbench.readings
--control` reads it at the cells' own sizes."""

import pytest

from avatarbench import check, harness, readings
from avatarbench.tests import tiny


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["avatar-train", "cloud-train",
                                      "avatar-replay"])
def test_tf32_control_fails(cuda_device, workload):
    _, _, cfg, tr, limits = harness.find_cell(tiny.ROOT, workload)
    tr = dict(tr, width=401, height=275, timesteps=min(tr["timesteps"], 4),
              check_frames=4)
    out = readings.control_reading(cfg, tr, limits, 6_000_000_001,
                                   cuda_device)
    correct, _ = check.judge(out["numbers"], limits)
    assert not correct, out["numbers"]
