"""The ported slice as a whole against the JAX package, on the CPU: the
two-agent construction of tests/test_frontend.py (320x240, 128 tracks,
7 frames), bootstrap field by field, then both multi-agent runners frame by
frame with the JAX RANSAC draws replayed into the port."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mqslam_tpu.core import camera as jcam
from mqslam_tpu.frontend import synthetic as jsyn, tracker as jtrk
from mqslam_tpu.ops import features as jfeat

from mqslam_tpu_torch import convert
from mqslam_tpu_torch.core import quat as tquat, se3 as tse3
from mqslam_tpu_torch.frontend import synthetic as tsyn, tracker as ttrk
from mqslam_tpu_torch.ops import features as tfeat, lk as tlk, pnp as tpnp
from mqslam_tpu_torch.utils import cuda_graph

F, SIZE, PLANE_Z = 300.0, (320, 240), 4.0
CAL9 = np.array([F, F, 0, SIZE[0] / 2, SIZE[1] / 2, 0, 0, 0, 0], np.float32)
N_FRAMES = 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the tier-1 command's parallel workers,
    torch's default threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state_fields(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()
            if k != "key"}


def ransac_scores_from_keys(keys, n_frames, n_hyp, K):
    """Replay the JAX tracker's key chain: per frame ``key, k = split(key)``
    and ``uniform(k, (n_hyp, K))``.  Returns [n_frames, A, n_hyp, K]."""
    out = []
    for key in keys:
        per_frame = []
        for _ in range(n_frames):
            key, k_ransac = jax.random.split(key)
            per_frame.append(np.asarray(
                jax.random.uniform(k_ransac, (n_hyp, K))))
        out.append(np.stack(per_frame))
    return np.stack(out, axis=1)


@pytest.fixture(scope="module")
def fleet():
    """Two agents: images, init correspondences, JAX and port bootstraps."""
    jcal = jcam.Cal3DS2.from_array(jnp.asarray(CAL9))
    jcfg = jtrk.TrackerConfig(max_tracks=128, target_keypoints=100)
    tcal = convert.cal_from_numpy(CAL9, device="cpu")
    tcfg = convert.config_from_jax(jcfg)
    agents = []
    for a, seed in enumerate((3, 9)):
        tex = jsyn.make_texture(np.random.RandomState(seed))
        P_list = []
        for i in range(N_FRAMES):
            P = np.eye(4)
            P[:3, 3] = [-0.06 * i, 0.02 * i * (a + 1), 0.0]
            P_list.append(P)
        imgs = jsyn.render_plane_sequence(np.stack(P_list), tex, size=SIZE,
                                          f=F, plane_z=PLANE_Z)
        uv, valid = jfeat.detect_corners(jnp.asarray(imgs[0]),
                                         max_corners=96, cell=12)
        uv = np.asarray(uv)[np.asarray(valid)][:64].astype(np.float32)
        objp = jsyn.backproject_to_plane(
            uv, P_list[0], F, (SIZE[0] / 2, SIZE[1] / 2), PLANE_Z
        ).astype(np.float32)
        key = jax.random.PRNGKey(10 + a)
        jst = jtrk.bootstrap(uv, objp, jcal, imgs[0], jcfg, key)
        tst = ttrk.bootstrap(uv, objp, tcal, imgs[0], tcfg, device="cpu")
        agents.append(dict(imgs=imgs, uv=uv, objp=objp, key=key, jst=jst,
                           tst=tst))
    return dict(jcal=jcal, jcfg=jcfg, tcal=tcal, tcfg=tcfg, agents=agents)


def test_synthetic_copy_matches():
    """The port's own copy of the NumPy renderer is the same function."""
    t1 = jsyn.make_texture(np.random.RandomState(5), size=256)
    t2 = tsyn.make_texture(np.random.RandomState(5), size=256)
    np.testing.assert_array_equal(t1, t2)
    P = np.eye(4)[None]
    np.testing.assert_array_equal(
        jsyn.render_plane_sequence(P, t1, size=(64, 48)),
        tsyn.render_plane_sequence(P, t2, size=(64, 48)))


def test_detect_corners_on_first_frame(fleet):
    """Same corners, same order, on a rendered frame (valid entries; pad
    entries are unordered -inf ties)."""
    img = fleet["agents"][0]["imgs"][0]
    uv_j, v_j = jfeat.detect_corners(jnp.asarray(img), max_corners=96,
                                     cell=12)
    uv_t, v_t = tfeat.detect_corners(torch.tensor(img), max_corners=96,
                                     cell=12)
    v_j = np.asarray(v_j)
    np.testing.assert_array_equal(v_j, v_t.numpy())
    np.testing.assert_array_equal(np.asarray(uv_j)[v_j], uv_t.numpy()[v_j])


@pytest.mark.parametrize("a", [0, 1])
def test_bootstrap_parity(fleet, a):
    """Field by field through convert.state_from_numpy.  Poses: atol 1e-4
    (20 GN steps in f32, sums in another order); integer / bool fields and
    the refilled corners: exact."""
    ag = fleet["agents"][a]
    ref = convert.state_from_numpy(jax_state_fields(ag["jst"]), device="cpu")
    got = ag["tst"]
    act = ref.active.numpy()
    for name in ("active", "triangulated", "n_objp", "group_id",
                 "objp_group"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ref, name).numpy(), name)
    np.testing.assert_array_equal(got.objp_idx.numpy()[act],
                                  ref.objp_idx.numpy()[act])
    for name in ("base_uv", "cur_uv"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[act],
                                      getattr(ref, name).numpy()[act], name)
    for name in ("rvec", "tvec", "rvec_keyfr", "tvec_keyfr"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name).numpy(), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got.objp.numpy(), ref.objp.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.objp_color.numpy(),
                               ref.objp_color.numpy(), atol=1e-3)
    # and back out again
    back = convert.state_to_numpy(got)
    assert set(back) == set(ttrk.TrackerState._fields)
    assert back["active"].dtype == np.bool_


def _stack_states(states):
    return ttrk.TrackerState(*(torch.stack(x) for x in zip(*states)))


@pytest.fixture(scope="module")
def both_runs(fleet):
    ags = fleet["agents"]
    imgs = np.stack([ag["imgs"] for ag in ags])
    jstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[ag["jst"] for ag in ags])
    jrun = jtrk.make_multi_agent_runner(fleet["jcal"], fleet["jcfg"])
    jfinal, (jacc, jrv, jtv) = jax.block_until_ready(
        jrun(jstates, jnp.asarray(imgs)))
    cfg = fleet["tcfg"]
    scores = ransac_scores_from_keys([ag["key"] for ag in ags], N_FRAMES - 1,
                                     cfg.ransac_hypotheses, cfg.max_tracks)
    # start the port from the JAX bootstrap, so that this test holds the
    # runner alone to the reference
    tstates = convert.state_from_numpy(jax_state_fields(jstates),
                                       device="cpu")
    trun = ttrk.make_multi_agent_runner(fleet["tcal"], cfg, device="cpu")
    res = trun(tstates, imgs, ransac_scores=scores)
    return dict(jax=(jfinal, np.asarray(jacc), np.asarray(jrv),
                     np.asarray(jtv)), torch=res, scores=scores, imgs=imgs,
                tstates=tstates)


def test_multi_agent_runner_matches_jax(both_runs):
    """Frame by frame and agent by agent: ``accepted`` equal; poses within
    2e-3 (the JAX runner takes its XLA LK path on the CPU, whose window cap
    is one pixel looser than the tiled semantics the port has: the
    reference's own test bounds that gap at 2e-3 px of flow)."""
    jfinal, jacc, jrv, jtv = both_runs["jax"]
    tfinal, (tacc, trv, ttv) = both_runs["torch"]
    assert (jacc > 0).all() and (jacc == 2).any(), jacc
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    np.testing.assert_allclose(ttv.numpy(), jtv, atol=2e-3)
    np.testing.assert_allclose(trv.numpy(), jrv, atol=2e-3)
    # landmark counts: equal, or within 3 where a fresh landmark sits on
    # the 1 px reprojection gate
    assert np.abs(tfinal.n_objp.numpy() - np.asarray(jfinal.n_objp)
                  ).max() <= 3
    assert np.abs(tfinal.active.numpy().sum(1)
                  - np.asarray(jfinal.active).sum(1)).max() <= 3


def test_kf_gate_modes_agree(fleet, both_runs):
    """The keyframe gate's two outcomes agree where both are allowed: on a
    frame where no keyframe fires the runners skip ``kf_phase``;
    ``finalize`` selects by ``is_kf``, so running it all the same gives the
    same state and output, bit for bit."""
    cfg = fleet["tcfg"]
    _, _, step_pyr = ttrk.make_step(fleet["tcal"], cfg, device="cpu")
    pf = step_pyr.post_flow
    a = 0
    assert both_runs["jax"][1][0, a] == 1      # accepted, not a keyframe
    st = ttrk.TrackerState(*(x[a] for x in both_runs["tstates"]))
    pad = tlk.lk_pad(cfg.lk_win)
    pyr = [tlk.build_pyramid(torch.tensor(both_runs["imgs"][a, i]),
                             cfg.lk_levels, pad=pad) for i in (0, 1)]
    new_uv, st_of, err_of = tlk.lk_track_pyr(
        pyr[0], pyr[1], st.cur_uv, st.active, win=cfg.lk_win, prepad=True)
    t = pf.track_phase(st, new_uv, st_of, err_of,
                       torch.tensor(both_runs["scores"][0, a]), None)
    assert not bool(t.is_kf)
    s1, o1 = pf.finalize(st, t, pf.no_kf_phase(st, t))
    s2, o2 = pf.finalize(st, t, pf.kf_phase(st, t, pyr[1][0]))
    for name, x, y in zip(s1._fields + o1._fields, s1 + o1, s2 + o2):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), name)


def test_scan_runner_matches_multi_agent(fleet, both_runs):
    """One agent through make_scan_runner (the A = 1 LK call) reproduces
    its column of the atlas run: same arithmetic per track, so accepted is
    equal and poses agree to float roundoff (atol 1e-5)."""
    cfg = fleet["tcfg"]
    run1 = ttrk.make_scan_runner(fleet["tcal"], cfg, device="cpu")
    _, (tacc, trv, ttv) = both_runs["torch"]
    a = 1
    st = ttrk.TrackerState(*(x[a] for x in both_runs["tstates"]))
    _, (acc1, rv1, tv1) = run1(st, both_runs["imgs"][a],
                               ransac_scores=both_runs["scores"][:, a])
    np.testing.assert_array_equal(acc1.numpy(), tacc[:, a].numpy())
    np.testing.assert_allclose(tv1.numpy(), ttv[:, a].numpy(), atol=1e-5)
    np.testing.assert_allclose(rv1.numpy(), trv[:, a].numpy(), atol=1e-5)


def test_generator_draws_and_collect(fleet, both_runs):
    """Without injected scores the runner draws from the generator, and
    ``collect=True`` appends the six track-level outputs."""
    cfg = fleet["tcfg"]
    run = ttrk.make_multi_agent_runner(fleet["tcal"], cfg, collect=True,
                                       device="cpu")
    imgs = both_runs["imgs"][:, :3]
    outs = [run(both_runs["tstates"], imgs,
                generator=torch.Generator().manual_seed(s))[1]
            for s in (1, 1)]
    assert len(outs[0]) == 9
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert outs[0][3].shape == (2, 2, cfg.max_tracks, 2)
    assert (outs[0][0] > 0).all()


def test_landmark_store_full(fleet, both_runs):
    """The store fills up to M exactly: landmarks land on distinct slots
    n_objp .. M-1, the one that reaches slot M-1 is kept there, tracks
    beyond capacity stay untriangulated, and the order in which duplicate
    writes would have been applied plays no part (the stored rows equal
    the first rows of a run with room to spare)."""
    jfinal, jacc, _, _ = both_runs["jax"]
    kf_frame = int(np.argmax((jacc == 2).any(axis=1)))
    n0 = both_runs["tstates"].n_objp.numpy()
    M = int(n0.max()) + 5          # room for 5 new landmarks at most
    cfg = convert.config_from_jax(dict(
        fleet["tcfg"].__dict__, max_landmarks=M))
    st = both_runs["tstates"]
    st = st._replace(objp=st.objp[:, :M].clone(),
                     objp_color=st.objp_color[:, :M].clone(),
                     objp_group=st.objp_group[:, :M].clone())
    run = ttrk.make_multi_agent_runner(fleet["tcal"], cfg, collect=True,
                                       device="cpu")
    imgs = both_runs["imgs"][:, :kf_frame + 2]
    final, outs = run(st, imgs, ransac_scores=both_runs["scores"])
    new_lm = outs[6][kf_frame].numpy()            # [A, K]
    kf = outs[0][kf_frame].numpy() == 2
    assert kf.any()
    for a in np.nonzero(kf)[0]:
        assert final.n_objp[a] == M
        assert new_lm[a].sum() == M - n0[a]
        slots = final.objp_idx[a].numpy()[new_lm[a]]
        np.testing.assert_array_equal(np.sort(slots), np.arange(n0[a], M))
        assert np.isfinite(final.objp[a].numpy()).all()
        assert (np.abs(final.objp[a, M - 1].numpy()) > 0).any()
    # the stored landmarks are the first M - n0 of the unconstrained run
    full_run = ttrk.make_multi_agent_runner(fleet["tcal"], fleet["tcfg"],
                                            device="cpu")
    full_final, _ = full_run(both_runs["tstates"], imgs,
                             ransac_scores=both_runs["scores"])
    for a in np.nonzero(kf)[0]:
        np.testing.assert_array_equal(final.objp[a].numpy(),
                                      full_final.objp[a, :M].numpy())


def test_cpu_fleet_runner_goes_through_both_graphed(fleet, both_runs,
                                                    monkeypatch):
    """On the CPU the fleet runner takes the card's one path: the track
    phase through its ``Graphed`` once a frame-group, the keyframe branch
    through its own once a keyframe group (each run eagerly there), with
    outputs bit-equal to the runner's unwatched run and ``accepted`` equal
    to the JAX run's."""
    calls = collections.Counter()

    class Counted(cuda_graph.Graphed):
        def __call__(self, *args):
            calls[self.name] += 1
            return super().__call__(*args)
    monkeypatch.setattr(cuda_graph, "Graphed", Counted)
    run = ttrk.make_multi_agent_runner(fleet["tcal"], fleet["tcfg"],
                                       device="cpu")
    final, outs = run(both_runs["tstates"], both_runs["imgs"],
                      ransac_scores=both_runs["scores"])
    jacc = both_runs["jax"][1]
    kf_groups = int((jacc == 2).any(axis=1).sum())
    assert kf_groups >= 1
    assert calls == {"fleet.track_graph": N_FRAMES - 1,
                     "fleet.kf_graph": kf_groups}
    np.testing.assert_array_equal(outs[0].numpy(), jacc)
    ref_final, ref_outs = both_runs["torch"]
    for x, y in zip(tuple(final) + tuple(outs),
                    tuple(ref_final) + tuple(ref_outs)):
        assert torch.equal(x, y)


class HostOps(TorchDispatchMode):
    """Counts the ATen calls that make or move host data: ``lift_fresh``
    (``torch.tensor`` and a Python number stored into a tensor),
    ``copy_``, ``_to_copy`` onto another device, and ``_local_scalar_dense``
    (a read back to the host).  On a card each is a copy or a wait that no
    CUDA graph can capture."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if name in ("lift_fresh", "copy_", "_local_scalar_dense") or (
                name == "_to_copy" and "device" in kwargs):
            self.ops[name] += 1
        return func(*args, **kwargs)


def _first_group(fleet, both_runs):
    """The two agents' states and their flow over the first frame pair,
    as the track phase takes them ([A, K, ...])."""
    cfg = fleet["tcfg"]
    st = both_runs["tstates"]
    pad = tlk.lk_pad(cfg.lk_win)
    flows = []
    for a in range(st.active.shape[0]):
        pyr = [tlk.build_pyramid(torch.tensor(both_runs["imgs"][a, i]),
                                 cfg.lk_levels, pad=pad) for i in (0, 1)]
        flows.append(tlk.lk_track_pyr(pyr[0], pyr[1], st.cur_uv[a],
                                      st.active[a], win=cfg.lk_win,
                                      prepad=True))
    return st, [torch.stack(x) for x in zip(*flows)]


def test_ransac_draw_made_outside_is_pnp_ransacs(fleet, both_runs):
    """The fleet runner's CUDA graph takes the RANSAC draw as ``scores``,
    made before the replay by ``pnp.ransac_draw``: handed in, it
    gives the track phase of ``pnp_ransac`` drawing from a generator seeded
    alike, bit for bit, and leaves the generator where ``pnp_ransac`` does."""
    cfg = fleet["tcfg"]
    _, _, step_pyr = ttrk.make_step(fleet["tcal"], cfg, device="cpu")
    pf = step_pyr.post_flow
    st, flow = _first_group(fleet, both_runs)
    g_in, g_out = (torch.Generator().manual_seed(21) for _ in range(2))
    inside = pf.track_phase(st, *flow, None, g_in)
    drawn = tpnp.ransac_draw(st.active.shape[0], cfg.ransac_hypotheses,
                             cfg.max_tracks, torch.float32, "cpu", g_out)
    outside = pf.track_phase(st, *flow, drawn)
    for name, x, y in zip(ttrk.TrackInterm._fields, inside, outside):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), name)
    assert torch.equal(g_in.get_state(), g_out.get_state())
    assert not bool(inside.rejected.any())


@pytest.mark.parametrize("batch_R,batch_t", [((), ()), ((2, 5), (2, 5)),
                                             ((), (4,)), ((3, 1), (1, 2))])
def test_from_R_t_is_built_on_the_device(batch_R, batch_t):
    """``se3.from_R_t`` returns [R t; 0 0 0 1] with no host data moved:
    no ``torch.tensor``, no copy (the fleet's track phase reaches it inside
    its CUDA graph); ``quat.identity`` likewise."""
    g = torch.Generator().manual_seed(4)
    R = torch.randn(batch_R + (3, 3), generator=g)
    t = torch.randn(batch_t + (3,), generator=g)
    with HostOps() as host:
        P = tse3.from_R_t(R, t)
        q = tquat.identity()
    assert not host.ops, host.ops
    batch = np.broadcast_shapes(batch_R, batch_t)
    want = np.zeros(batch + (4, 4), np.float32)
    want[..., :3, :3] = R.numpy()
    want[..., :3, 3] = t.numpy()
    want[..., 3, 3] = 1.0
    np.testing.assert_array_equal(P.numpy(), want)
    np.testing.assert_array_equal(q.numpy(), [0, 0, 0, 1])


def test_track_phase_moves_no_host_data(fleet, both_runs):
    """Once the Jacobi constants are cached (the graph's warm-up does
    that), the track phase with its draw handed in makes no host tensor,
    no copy and no read-back: nothing a CUDA graph cannot capture."""
    cfg = fleet["tcfg"]
    _, _, step_pyr = ttrk.make_step(fleet["tcal"], cfg, device="cpu")
    pf = step_pyr.post_flow
    st, flow = _first_group(fleet, both_runs)
    drawn = tpnp.ransac_draw(st.active.shape[0], cfg.ransac_hypotheses,
                             cfg.max_tracks, torch.float32, "cpu",
                             torch.Generator())
    pf.track_phase(st, *flow, drawn)
    with HostOps() as host:
        pf.track_phase(st, *flow, drawn)
    assert not host.ops, host.ops


@pytest.fixture(scope="module")
def kf_group(fleet, both_runs):
    """The first frame-group where an agent keyframed, as the fleet runner
    reaches its keyframe branch: the runner, the states before the group,
    the track phase's intermediates, the level-0 tiles and the new frames."""
    cfg = fleet["tcfg"]
    g = int(np.argmax((both_runs["jax"][1] == 2).any(axis=1)))
    run = ttrk.make_multi_agent_runner(fleet["tcal"], cfg, collect=True,
                                       device="cpu")
    st = both_runs["tstates"]
    if g:
        st, _ = run(st, both_runs["imgs"][:, :g + 1],
                    ransac_scores=both_runs["scores"])
    A, K = st.active.shape
    pad = tlk.lk_pad(cfg.lk_win)
    frames = torch.tensor(both_runs["imgs"][:, g:g + 2])
    pyrs = [tlk.build_pyramid(frames[:, i], cfg.lk_levels, pad=pad)
            for i in (0, 1)]
    atlas = [[lv.reshape(-1, lv.shape[-1]) for lv in p] for p in pyrs]
    new_uv, st_of, err_of = tlk.lk_track_pyr(
        atlas[0], atlas[1], st.cur_uv.reshape(A * K, 2),
        st.active.reshape(A * K), win=cfg.lk_win, prepad=True,
        atlas_tiles=A, atlas_contiguous=True)
    _, _, step_pyr = ttrk.make_step(fleet["tcal"], cfg, device="cpu")
    pf = step_pyr.post_flow
    t = pf.track_phase(st, new_uv.reshape(A, K, 2), st_of.reshape(A, K),
                       err_of.reshape(A, K),
                       torch.tensor(both_runs["scores"][g]))
    assert bool(t.is_kf.any())
    return dict(g=g, run=run, pf=pf, cfg=cfg, states=st, t=t,
                tiles0=pyrs[1][0], new=frames[:, 1])


def test_keyframe_branch_moves_no_host_data(kf_group):
    """Once the Jacobi constants are cached (the graph's warm-up does
    that), the fleet runner's keyframe branch (kf_phase, finalize, the
    refill and the select, as ``run.kf_branch`` wraps them for the CUDA
    graph) makes no host tensor, no copy and no read-back."""
    k = kf_group
    args = (*k["states"], *k["t"], k["tiles0"], k["new"])
    k["run"].kf_branch(*args)
    with HostOps() as host:
        k["run"].kf_branch(*args)
    assert not host.ops, host.ops


@pytest.mark.parametrize("keyframed", [(True, True), (True, False)])
def test_keyframe_branch_is_the_inline_sequence(kf_group, both_runs,
                                                keyframed):
    """``run.kf_branch`` on contiguous copies of its inputs (what the CUDA
    graph's static buffers hold) gives, bit for bit, the states and outputs
    of the inline sequence kf_phase -> finalize -> refill -> select on the
    tensors as the runner holds them: on the group as it came, where both
    agents keyframed, and with the second agent's keyframe taken away (the
    select keeps its state unrefilled); on the group as it came, the
    runner's own states and outputs too."""
    k = kf_group
    pf, st = k["pf"], k["states"]
    t = k["t"]._replace(is_kf=k["t"].is_kf & torch.tensor(keyframed))
    assert t.is_kf.tolist() == list(keyframed)
    kf_out = pf.kf_phase(st, t, k["tiles0"])
    want_st, want_out = pf.finalize(st, t, kf_out)
    want_st = ttrk._select_states(want_out.accepted == 2, want_st,
                                  ttrk._refill(want_st, k["new"], k["cfg"]))

    def static(a):
        s = torch.empty(a.shape, dtype=a.dtype)
        s.copy_(a)
        return s
    got_st, got_out = k["run"].kf_branch(*(static(a) for a in (
        *st, *t, k["tiles0"], k["new"])))
    for name, x, y in zip(want_st._fields + want_out._fields,
                          want_st + want_out, got_st + got_out):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), name)
    if not all(keyframed):
        assert not torch.equal(got_st.active[1], ttrk._refill(
            got_st, k["new"], k["cfg"]).active[1])
        return
    g = k["g"]
    fin, outs = k["run"](st, both_runs["imgs"][:, g:g + 2],
                         ransac_scores=both_runs["scores"][g:g + 1])
    for name, x, y in zip(ttrk.TrackerState._fields, fin, got_st):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), name)
    for name, x in zip(("accepted", "rvec", "tvec", "cur_uv", "track_alive",
                        "track_triangulated", "new_landmarks", "pnp_inlier",
                        "objp_idx"), outs):
        np.testing.assert_array_equal(x[0].numpy(),
                                      getattr(got_out, name).numpy(), name)
