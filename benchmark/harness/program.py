"""The system under test: `mmloam_tpu_torch`'s replay entries, driven as a
user drives them, and the counters and the cached graph they leave.

A job is one call of the traffic's entry from a fresh state:
`replay.replay_batch` over all lanes (a fleet), or `replay.replay` over
one sequence.  Its inputs are the cell's scans on the card, every point
moved by the job's shift (`job_scans`).  Nothing here reads a value of
the program's that the benchmark does not report.
"""

from __future__ import annotations

import torch

from . import spec as specmod


class Program:
    def __init__(self, config_values, traffic, device):
        from mmloam_tpu_torch import config, pipeline, replay

        self.pipeline, self.replay = pipeline, replay
        self.cfg = specmod.build_config(config.LIOConfig, config_values)
        self.traffic = traffic
        self.device = device
        self.one = traffic["entry"] == "replay"
        if traffic["entry"] not in ("replay", "replay_batch"):
            raise ValueError(f"no entry {traffic['entry']!r}")
        if self.one and traffic["lanes"] != 1:
            raise ValueError("the one-sequence entry replays one lane")

    def sizes(self):
        """What the generator needs of the configuration."""
        c = self.cfg
        return (c.scan.max_pts_per_line, c.scan.hori_max_pts_per_line,
                c.imu.max_samples, c.imu.gnorm)

    def to_device(self, scans):
        """The generator's (T, B, ...) arrays as the entry's ScanInput on
        the card: (T, B, ...) for a fleet, (T, ...) for one sequence."""
        leaves = {f: torch.as_tensor(a, device=self.device)
                  for f, a in scans.items()}
        if self.one:
            leaves = {f: a[:, 0] for f, a in leaves.items()}
        return self.pipeline.ScanInput(**leaves)

    def fresh(self):
        """A fresh state: B lanes stacked, or one lane."""
        init = lambda: self.pipeline.init_state(self.cfg, device=self.device)
        if self.one:
            return init()
        return self.replay.stack_states(
            [init() for _ in range(self.traffic["lanes"])])

    def run(self, state, scans):
        """One call of the entry: (final state, outputs stacked over
        scans, (T, B, ...) or (T, ...))."""
        if self.one:
            return self.replay.replay(state, scans, self.cfg)
        return self.replay.replay_batch(state, scans, self.cfg)

    def runner(self):
        """The cached graph of the card's replay (None before a call)."""
        return self.replay._GRAPHS.get(self.device)

    def launches(self):
        """The kernels' launch counters: K1, K2, K3."""
        from mmloam_tpu_torch.ops import assoc, eigh, map_insert

        return dict(k1=map_insert.LAUNCHES, k2=assoc.LAUNCHES,
                    k3=eigh.LAUNCHES)

    def release(self):
        """Free the cached graph with its buffers and memory pools."""
        self.replay.clear_graphs()


def job_scans(scans, shift):
    """`scans` with every point of both lidars moved by `shift` metres
    along each axis (new tensors, the same for the program and the
    reference: one float32 add on the card)."""
    return scans._replace(pts=scans.pts + shift,
                          hori_pts=scans.hori_pts + shift)
