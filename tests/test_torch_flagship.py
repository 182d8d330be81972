"""The port at flagship widths against the JAX reference's golden.

tests/golden/flagship_lio.npz holds three runs of the reference at
`LIOConfig()` (scripts/make_flagship_golden.py): bench.py's batch (B=4 x
16 scans, the main path, `replay_batch`), tests/test_flagship.py's
40-scan dual-lidar drive (`replay`) and scripts/street_drive.py's
500-scan canyon drive (`replay`).  Each runs here through the port on
the CPU, from the same numpy inputs, and is held against the golden by
`make_flagship_golden.compare`, whose bounds the script states:

* the inputs' digests bit for bit (the port's `make_sequence` is the
  reference's input construction, copied);
* flags and stamps exactly; counts within twice the reference's own
  spread (the golden run against the reference's runs at bench.py's input
  perturbations, 1e-5 to 3e-5 m), which is 0 wherever the reference
  never moves them;
* pose_p within 0.01 m up to the scan where the reference's own spread
  first exceeds 0.01 m, and within twice that spread from there;
  pose_q and sv_min likewise from their floors;
* the final maps and the ATE within twice the spread (full runs only).

The street drive runs its first STREET_SCANS scans (init at scan 8, the
first post-init scans that make x observable, and the re-anchoring after
them); all 500 run on the card (chip_smoke.py phase 16,
street_drive_torch.py --golden).  Why the bounds follow the reference's
own spread is in ROADMAP queue 3: from the reference's pre-step state the
port's step is the reference's (tests/test_torch_flagship_teacher.py),
and a replay at these widths amplifies the last bits of any step.

Nothing of the JAX package is imported: the test reads the npz.
"""

import functools

import pytest
import torch

torch.set_num_threads(1)

from chip_smoke import golden_module  # noqa: E402
from mmloam_tpu_torch import pipeline, replay  # noqa: E402
from mmloam_tpu_torch.config import LIOConfig  # noqa: E402
from mmloam_tpu_torch.data import synthetic  # noqa: E402

STREET_SCANS = 60
CFG = LIOConfig()
fg = golden_module()


@functools.lru_cache(maxsize=None)
def _golden():
    return fg.load()


def port_run(run, n_scans=None):
    """`run`'s inputs (its first `n_scans`) through the port on the CPU,
    as `fg.result` digests a run (final maps and ATE for a full run)."""
    T, B = fg.RUNS[run][3], fg.RUNS[run][4]
    n = T if n_scans is None else n_scans
    scans, gts = fg.build(run, replay.make_sequence, synthetic, CFG,
                          n_scans=n)
    dev = torch.device("cpu")
    sc = pipeline.scan_from_numpy(scans, dev)
    if B:
        final, outs = replay.replay_batch(replay.stack_states(
            [pipeline.init_state(CFG, device=dev) for _ in range(B)]), sc,
            CFG)
    else:
        final, outs = replay.replay(pipeline.init_state(CFG, device=dev),
                                    sc, CFG)
    return fg.result(outs, final if n == T else None, scans, gts,
                     lambda a: a.numpy())


@pytest.mark.parametrize("run,n_scans", [("batch", None), ("one", None),
                                         ("street", STREET_SCANS)])
def test_port_matches_reference_golden(run, n_scans):
    got = port_run(run, n_scans)
    bad, seen = fg.compare(_golden()[run], got, n=n_scans)
    print(f"{run}: {seen}")
    assert not bad, f"{run}: {bad}"
