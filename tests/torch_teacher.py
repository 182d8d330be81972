"""Teacher-forced steps of the port against the JAX reference (shared by
tests/test_torch_pipeline.py and the mode tests).

`teacher_record` runs the reference's jitted `step_core` + `apply_inserts`
over a hall sequence and keeps, at chosen scans, the pre-step state and
what the reference made of that scan; its per-scan outputs are the
reference's replay of the sequence.  `check_teacher_step` hands such a
state to the port (`state_from_numpy`), runs the port's `step_core` and
holds every output against the reference: discrete outputs exactly, poses
within POSE_ATOL m, map sums within SUM_ATOL with meta lanes exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmloam_tpu import pipeline as jp
from mmloam_tpu import replay as jr
from mmloam_tpu.data import synthetic as jsyn

from mmloam_tpu_torch import pipeline as tp

POSE_ATOL = 1e-5
SUM_ATOL = 1e-5


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def hall(cfg, n_scans, range_noise, seed=0, **kw):
    """The hall sequence as numpy ScanInputs (the input both packages
    take)."""
    return jr.make_sequence(jsyn.default_world(),
                            jsyn.Trajectory(speed=0.8, z_amp=0.15), 0.0,
                            n_scans, cfg, n_az=360, dtype=np.float32,
                            range_noise=range_noise, seed=seed,
                            to_device=False, **kw)


def teacher_record(cfg, n_scans, keep, **scan_kw):
    """The reference's step_core + apply_inserts over the hall scans 0 ..
    n_scans-1 (3 mm range noise, seed 1).  Returns (rec, outs, scans):
    rec[t] for t in `keep` holds the pre-step state, the scan, what
    step_core returned and the state after the inserts; outs is the
    StepOutput of every scan (numpy, stacked), the reference's replay."""
    scans, gt_R, gt_p = hall(cfg, n_scans, 0.003, seed=1, **scan_kw)

    @jax.jit
    def parts(s, sc):
        s1, out, pend = jp.step_core(s, sc, cfg)
        return s1, out, pend, jp.apply_inserts(s1, pend, cfg)

    st = jp.init_state(cfg)
    rec, outs = {}, []
    for t in range(n_scans):
        sc = jax.tree.map(lambda a: jnp.asarray(a[t]), scans)
        s1, out, pend, s2 = parts(st, sc)
        outs.append(jax.tree.map(np.asarray, out))
        if t in keep:
            rec[t] = dict(state=jax.tree.map(np.asarray, st),
                          scan=jax.tree.map(lambda a: a[t], scans),
                          core=jax.tree.map(np.asarray, (s1, out, pend)),
                          after=jax.tree.map(np.asarray, s2))
        st = s2
    outs = jax.tree.map(lambda *xs: np.stack(xs), *outs)
    return rec, outs, (scans, gt_R, gt_p)


def assert_maps(got, want, name, atol=SUM_ATOL):
    """Meta lanes exactly, sum lanes within atol, at any row width."""
    got, want = np_(got), np.asarray(want)
    s3 = 3 * (want.shape[-1] // 4)
    np.testing.assert_array_equal(got[:, s3:], want[:, s3:], err_msg=name)
    np.testing.assert_allclose(got[:, :s3], want[:, :s3], atol=atol,
                               err_msg=name)


def check_teacher_step(rec, inited, cfg, scale=1.0, stack_rtol=0.0,
                       map_atol=SUM_ATOL, count_slack=None):
    """The port's step_core (+ apply_inserts) from the reference's pre-step
    state `rec["state"]` against what the reference made of the scan.
    Float bounds are the default step's times `scale`; with `stack_rtol`,
    each re-deskewed stack point is held within POSE_ATOL * scale +
    stack_rtol * its range (a rotation error grows with range), and the
    inserted map sums `map_atol`.  Every stack of the window (corner, surf
    and, under cfg.use_nonfeature, non) and every map is checked.
    `count_slack` ({output name: n}) lets a discrete count differ by at
    most n, for a step whose allowance the caller states."""
    count_slack = count_slack or {}
    sj, (cj_state, cj_out, cj_pend), aj = (rec["state"], rec["core"],
                                           rec["after"])
    assert bool(sj.inited) == inited
    st = tp.state_from_numpy(sj, device="cpu")
    # the handover itself is lossless, both ways
    back = tp.state_to_numpy(st)
    assert type(back) is type(st)
    for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a.astype(b.dtype))
    scan = tp.scan_from_numpy(rec["scan"], device="cpu")
    s1, out, pend = tp.step_core(st, scan, cfg)

    for name in ("fail", "degenerate", "inited", "n_corner", "n_surf",
                 "fast_rotation", "hori_merged", "n_assoc_line",
                 "n_assoc_plane", "t"):
        got, want = np_(getattr(out, name)), np.asarray(getattr(cj_out, name))
        if name in count_slack:
            assert abs(int(got) - int(want)) <= count_slack[name], (
                name, int(got), int(want))
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("pose_p", "pose_q"):
        np.testing.assert_allclose(np_(getattr(out, name)),
                                   getattr(cj_out, name),
                                   atol=POSE_ATOL * scale, err_msg=name)
    np.testing.assert_allclose(np_(out.sv_min), cj_out.sv_min,
                               rtol=1e-4 * scale)

    # window: poses to POSE_ATOL; velocity/bias columns are less observed
    # and move with the LM iterates' rounding, so they get 1e-4
    x, xj = np_(s1.x), cj_state.x
    np.testing.assert_allclose(x[:, 0:6], xj[:, 0:6], atol=POSE_ATOL * scale)
    np.testing.assert_allclose(x[:, 6:15], xj[:, 6:15], atol=1e-4 * scale)
    np.testing.assert_array_equal(np_(s1.frame_valid), cj_state.frame_valid)
    np.testing.assert_array_equal(np_(s1.inited), cj_state.inited)
    np.testing.assert_array_equal(np_(s1.prior.valid), cj_state.prior.valid)
    np.testing.assert_allclose(np_(s1.prior.x0), cj_state.prior.x0,
                               atol=1e-4 * scale)
    np.testing.assert_array_equal(np_(s1.kf_count), cj_state.kf_count)
    np.testing.assert_array_equal(np_(s1.kf_phase), cj_state.kf_phase)
    # lin_J/lin_r come out of an f32 Schur complement whose pseudo-inverse
    # threshold sits inside the eigenvalue noise: the reference's own jit
    # and eager runs disagree there, so they are held in
    # test_torch_estimator.py::test_marginalize against that spread
    names = ("corner", "surf") + (("non",) if cfg.use_nonfeature else ())
    for name in names:
        np.testing.assert_array_equal(np_(getattr(s1.stacks, name + "_mask")),
                                      getattr(cj_state.stacks,
                                              name + "_mask"), err_msg=name)
        got, want = np_(getattr(s1.stacks, name)), getattr(cj_state.stacks,
                                                           name)
        if stack_rtol:
            err = np.linalg.norm(got - want, axis=-1)
            bound = POSE_ATOL * scale + stack_rtol * np.linalg.norm(want,
                                                                   axis=-1)
            assert (err <= bound).all(), (name, (err - bound).max())
        else:
            np.testing.assert_allclose(got, want, atol=POSE_ATOL * scale,
                                       err_msg=name)
    np.testing.assert_array_equal(np_(pend.do_map), cj_pend.do_map)
    np.testing.assert_array_equal(np_(pend.do_map_local),
                                  cj_pend.do_map_local)
    np.testing.assert_allclose(np_(s1.last_map_pos), cj_state.last_map_pos,
                               atol=POSE_ATOL * scale)
    np.testing.assert_allclose(np_(pend.p), cj_pend.p, atol=POSE_ATOL * scale)
    if cfg.use_nonfeature:
        np.testing.assert_array_equal(np_(pend.non_mask), cj_pend.non_mask)
        np.testing.assert_allclose(np_(pend.non), cj_pend.non,
                                   atol=POSE_ATOL * scale)

    s2 = tp.apply_inserts(s1, pend, cfg)
    for name in tp.MAP_FIELDS:
        assert_maps(getattr(s2, name).cells, getattr(aj, name).cells, name,
                    map_atol)
    # the scatter insert returns new maps: the step's input maps are intact
    assert_maps(s1.vm_surf.cells, sj.vm_surf.cells, "input map")
    return s1, out
