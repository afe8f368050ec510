"""mqslam_tpu_torch.ba's CG path (the corridor generator, the COO, packed
and banded layouts, ``solve_delta``, ``_auto_layout`` and ``lm_solve(method=
"cg")``) against mqslam_tpu.ba on the CPU.

Tolerances: the generator and every layout table equal (host NumPy in both
packages); ``apply_chunked`` equal to the plain gather bit for bit; each
layout's applies against the port's COO form at the JAX package's own
bounds (``tests/test_banded.py``: W^T, W and Hcc 1e-5 relative, W M W^T and
the preconditioner blocks 1e-4).  CG is float32 in both packages and its
truncated solves amplify the order of the sums: a converged solve is held
at 1e-4 relative, a truncated one (80 iterations) against a float64 run of
the same port code — the port's error at most twice the JAX package's
(measured 0.5-0.9x) — and the layouts against each other at
``test_banded.py``'s 5e-3.  Whole LM solves: cost histories 5e-4 relative
and camera centres 5e-4 m (measured 1.7e-4 and 1.4e-4).  torch runs on one
thread here so that its sums have one order."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ba import problem as jp, solver as js, synthetic as jsyn
from mqslam_tpu.ba.banded import build_banded_layout as jax_banded
from mqslam_tpu.ba.packed import build_chunked_gather as jax_chunked
from mqslam_tpu.ba.packed import build_packed_layout as jax_packed
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import banded as tb, packed as tpk
from mqslam_tpu_torch.ba import problem as tp, solver as ts
from mqslam_tpu_torch.ba import synthetic as tsyn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_fields(J):
    f = {k: np.asarray(v) for k, v in J._asdict().items() if k != "init"}
    f["init"] = {k: np.asarray(v) for k, v in J.init._asdict().items()}
    return f


def obs_args(P):
    return (P.obs_pose, P.obs_point, P.obs_valid, P.n_poses, P.n_points)


def rel(a, b):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("F,ppf", [(24, 6), (64, 8), (64, 12)])
def test_corridor_generator_equal(F, ppf):
    J, vj = jsyn.generate_corridor_problem(nr_frames=F, points_per_frame=ppf)
    T, vt = tsyn.generate_corridor_problem(nr_frames=F, points_per_frame=ppf,
                                           device="cpu")
    pairs = [(jax_fields(J), T), (
        {k: np.asarray(x) for k, x in vj._asdict().items()}, vt)]
    for fields, obj in pairs:
        for k, a in fields.items():
            if k == "init":
                for kk, aa in a.items():
                    t = getattr(obj.init, kk).numpy()
                    assert t.dtype == aa.dtype and np.array_equal(t, aa), kk
                continue
            t = getattr(obj, k).numpy()
            assert t.dtype == a.dtype and t.shape == a.shape, k
            assert np.array_equal(t, a), k
    assert T.n_poses == F and T.n_points == F * ppf


@pytest.fixture(scope="module")
def corridors():
    """Both packages' corridor problems, layouts and first linearizations
    at (64, 12) and at (256, 6), where the packed layout's pose-id gather
    builds its pack-row form."""
    out = {}
    for F, ppf in ((64, 12), (256, 6)):
        J, _ = jsyn.generate_corridor_problem(F, ppf)
        T, _ = tsyn.generate_corridor_problem(F, ppf, device="cpu")
        out[F] = dict(
            J=J, T=T, jpk=jax_packed(*obs_args(J)),
            tpk=tpk.build_packed_layout(*obs_args(T)),
            jbd=jax_banded(*obs_args(J)), tbd=tb.build_banded_layout(
                *obs_args(T)),
            lj=js.linearize(J, J.init), lt=ts.linearize(T, T.init))
    return out


def equal_ints(t, j, name):
    a = np.asarray(j)
    assert t.dtype == torch.int32 and a.dtype == np.int32, name
    assert t.shape == a.shape and np.array_equal(t.numpy(), a), name


@pytest.mark.parametrize("F", [64, 256])
def test_packed_tables_equal(corridors, F):
    c = corridors[F]
    j, t = c["jpk"], c["tpk"]
    for k in ("fslot", "pslot", "pid_f", "fid_p"):
        equal_ints(getattr(t, k), getattr(j, k), k)
    assert (t.Kf, t.Kp) == (j.Kf, j.Kp)
    for g in ("wg_fid", "wg_pid"):
        a, b = getattr(j, g), getattr(t, g)
        assert (a is None) == (b is None), g
        if a is not None:
            for k in ("chunk_src", "chunk_len", "ext_ids"):
                equal_ints(getattr(b, k), getattr(a, k), f"{g}.{k}")
            assert (b.n_src, b.G, b.rows, b.K) == (a.n_src, a.G, a.rows, a.K)
    assert (t.wg_fid is not None) == (F == 256)


@pytest.mark.parametrize("F", [64, 256])
def test_banded_tables_equal(corridors, F):
    c = corridors[F]
    j, t = c["jbd"], c["tbd"]
    for k in ("slot_obs", "slot_point", "point_slot", "op_ids_banded",
              "op_ids_left", "left_pids", "left_obs_f", "left_obs_col"):
        equal_ints(getattr(t, k), getattr(j, k), k)
    for k in ("F", "P", "J", "Ks", "n_obs", "n_banded", "n_left", "L"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.L > 0 and t.n_banded > t.n_left


def test_chunked_gather():
    """A run table with one broken chunk and a dead row: the pack-row
    gather equals the plain gather bit for bit, its tables equal the JAX
    package's; with too many broken chunks the builder refuses."""
    n_src, G = 40, 8
    rng = np.random.RandomState(0)
    ids = np.full((6, 13), n_src, np.int64)
    for r in range(5):
        n = rng.randint(3, 14)
        ids[r, :n] = rng.randint(0, n_src - 13) + np.arange(n)
    ids[2, 4] = 7                                      # a broken chunk
    t = tpk.build_chunked_gather(ids, n_src, G=G, max_broken_frac=0.2,
                                 device="cpu")
    j = jax_chunked(ids, n_src, G=G, max_broken_frac=0.2)
    for k in ("chunk_src", "chunk_len", "ext_ids"):
        equal_ints(getattr(t, k), getattr(j, k), k)
    assert t.ext_ids.shape[0] == 1
    v = torch.tensor(rng.randn(n_src, 3).astype(np.float32))
    plain = torch.cat([v, torch.zeros(1, 3)])[torch.tensor(ids)]
    assert torch.equal(tpk.apply_chunked(t, v), plain)
    assert tpk.build_chunked_gather(ids, n_src, G=G, device="cpu") is None
    assert jax_chunked(ids, n_src, G=G) is None


def hooks_for(c, layout, lam=1e-3):
    hpp_solve, Hpp_inv = ts._hpp_damped(c["lt"], lam)
    return ts._layout_hooks(c["T"], c["lt"], layout, None, hpp_solve,
                            Hpp_inv)


@pytest.mark.parametrize("F,kind", [(64, "banded"), (64, "packed"),
                                    (256, "banded"), (256, "packed")])
def test_applies_match_coo(corridors, F, kind):
    """Each layout's W^T, W, Hcc-obs, W M W^T and preconditioner blocks
    against the port's COO form, which matches the JAX package's COO
    applies on the same vectors."""
    c = corridors[F]
    T, lt = c["T"], c["lt"]
    layout = c["tbd" if kind == "banded" else "tpk"]
    rng = np.random.RandomState(0)
    v = torch.tensor(rng.randn(T.n_poses, 6).astype(np.float32))
    t = torch.tensor(rng.randn(T.n_points, 3).astype(np.float32))
    with ts._exact_f32():
        coo, lay = hooks_for(c, None), hooks_for(c, layout)
        assert rel(lay.wt_full(v), coo.wt_full(v)) < 1e-5
        assert rel(lay.w_full(t), coo.w_full(t)) < 1e-5
        assert rel(lay.hcc(v), coo.hcc(v)) < 1e-5
        assert rel(lay.corr(v), coo.corr(v)) < 1e-4
        assert rel(lay.pre(), coo.pre()) < 1e-4
        hcc = ts._hcc_apply(T, lt, v)
    J, lj = c["J"], c["lj"]
    vj, tj = jnp.asarray(v.numpy()), jnp.asarray(t.numpy())
    assert rel(coo.wt_full(v), js._w_t_apply(J, lj, vj)) < 1e-5
    assert rel(coo.w_full(t), js._w_apply(J, lj, tj)) < 1e-5
    assert rel(hcc, js._hcc_apply(J, lj, vj)) < 1e-5
    assert rel(ts._hcc_rest(T, lt, v), js._hcc_rest(J, lj, vj)) < 1e-5


def cube_problems(seed):
    """The 2-robot cube in both packages with observations and odometry
    randomly invalidated (some poses lose every observation, some landmarks
    keep one), one pose and one landmark masked, as
    ``tests/test_ba.py::test_dense_and_cg_agree_under_masking`` masks."""
    J = jp.problem_from_ba_data(jsyn.generate_cube_scenario(nr_cameras=2))
    rng = np.random.RandomState(seed)
    f = jax_fields(J)
    f["obs_valid"] = f["obs_valid"] & (rng.rand(len(f["obs_valid"])) > 0.4)
    f["odo_valid"] = f["odo_valid"] & (rng.rand(len(f["odo_valid"])) > 0.5)
    f["pose_valid"] = f["pose_valid"].copy()
    f["pose_valid"][rng.randint(1, J.n_poses)] = False
    f["point_valid"] = f["point_valid"].copy()
    f["point_valid"][rng.randint(4, J.n_points)] = False
    J = J._replace(**{k: jnp.asarray(f[k]) for k in (
        "obs_valid", "odo_valid", "pose_valid", "point_valid")})
    return J, convert.problem_from_numpy(f, "cpu"), f


@pytest.mark.parametrize("seed", [1, 2])
def test_solve_delta_coo_masked_cube(seed):
    J, T, f = cube_problems(seed)
    lj, lt = js.linearize(J, J.init), ts.linearize(T, T.init)
    dcj, dpj, _ = js.solve_delta(J, lj, jnp.float32(1e-3), cg_iters=3000,
                                 cg_tol=1e-12)
    dct, dpt, _ = ts.solve_delta(T, lt, 1e-3, cg_iters=3000, cg_tol=1e-12)
    assert rel(dct, dcj) < 1e-4 and rel(dpt, dpj) < 1e-4
    masked = np.flatnonzero(~f["pose_valid"])
    assert float(dct[masked].abs().max()) == 0.0
    assert float(dpt[np.flatnonzero(~f["point_valid"])].abs().max()) == 0.0
    # the same solve as the dense path's
    dcd, _ = ts.solve_delta_dense(T, lt, 1e-3)
    assert rel(dct, dcd) < 1e-4
    # the iteration count, run to the budget
    _, _, ij = js.solve_delta(J, lj, jnp.float32(1e-3), cg_iters=50,
                              cg_tol=0.0)
    _, _, it = ts.solve_delta(T, lt, 1e-3, cg_iters=50, cg_tol=0.0)
    assert it.dtype == torch.int32 and int(it) == int(ij) == 50


def test_solve_delta_layouts_corridor(corridors):
    """80 CG iterations from the same linearization: every layout's step is
    as close to a float64 run of the port as the JAX package's is; the
    layouts agree with each other; the count is the budget."""
    c = corridors[64]
    J, T, lj, lt = c["J"], c["T"], c["lj"], c["lt"]
    T64 = tp.problem_to(T, "cpu", torch.float64)
    l64 = ts.linearize(T64, T64.init)
    ref = ts.solve_delta(T64, l64, 1e-3, cg_iters=80, cg_tol=0.0)
    port = {}
    for name, jl, tl in (("coo", None, None), ("packed", c["jpk"], c["tpk"]),
                         ("banded", c["jbd"], c["tbd"])):
        dcj, dpj, ij = js.solve_delta(J, lj, jnp.float32(1e-3), cg_iters=80,
                                      cg_tol=0.0, layout=jl)
        dct, dpt, it = ts.solve_delta(T, lt, 1e-3, cg_iters=80, cg_tol=0.0,
                                      layout=tl)
        assert int(it) == int(ij) == 80
        for t, j, r in ((dct, dcj, ref[0]), (dpt, dpj, ref[1])):
            assert rel(t, r) <= 2 * rel(j, r), name
        port[name] = (dct, dpt)
    for a in port:
        for b in port:
            assert rel(port[a][0], port[b][0]) < 5e-3, (a, b)
            assert rel(port[a][1], port[b][1]) < 5e-3, (a, b)


def structure(op, opt, ov, F, P):
    return types.SimpleNamespace(obs_pose=op, obs_point=opt, obs_valid=ov,
                                 n_poses=F, n_points=P)


def test_auto_layout_choices(corridors):
    """``_auto_layout`` picks the JAX package's kind: the banded grid on the
    corridors; on a short one (16, 8), whatever the JAX package picks;
    nothing (COO) on a problem whose observations all sit on one pose and
    on one with no valid observation."""
    short = (jsyn.generate_corridor_problem(16, 8)[0],
             tsyn.generate_corridor_problem(16, 8, device="cpu")[0])
    kinds = [(type(js._auto_layout(J)).__name__,
              type(ts._auto_layout(T)).__name__)
             for J, T in ((corridors[64]["J"], corridors[64]["T"]), short)]
    O, F, P = 512, 64, 64
    op = np.zeros(O, np.int32)
    opt = np.arange(O, dtype=np.int32) % P
    for args in ((op, opt, np.ones(O, bool), F, P),
                 (np.zeros(8, np.int32), np.zeros(8, np.int32),
                  np.zeros(8, bool), 4, 4)):
        j = js._auto_layout(structure(*map(jnp.asarray, args[:3]),
                                      *args[3:]))
        t = ts._auto_layout(structure(*map(torch.tensor, args[:3]),
                                      *args[3:]))
        kinds.append((type(j).__name__, type(t).__name__))
    assert [t for t, _ in kinds] == [p for _, p in kinds], kinds
    assert kinds[0][1] == "BandedLayout"
    assert kinds[2][1] == kinds[3][1] == "NoneType"


@pytest.fixture(scope="module")
def corridor_lm():
    J, _ = jsyn.generate_corridor_problem(64, 8)
    T, _ = tsyn.generate_corridor_problem(64, 8, device="cpu")
    return J, T


@pytest.mark.parametrize("kind", ["coo", "packed", "banded"])
def test_lm_solve_cg(corridor_lm, kind):
    """``lm_solve(method="cg")`` over each layout against the JAX
    package's (8 iterations, 300 CG iterations).  LM starts at lam0 = 1e-4:
    below it the first damped system is indefinite (the dense Cholesky
    fails at 1e-5), so truncated CG returns a different meaningless step
    in each package, and whether LM accepts it decides the rest of the
    run, in the JAX package's own layouts too (``tests/test_ba.py`` lets
    them drift 2 %)."""
    J, T = corridor_lm
    build = {"coo": (lambda *a: None, lambda *a: None),
             "packed": (jax_packed, tpk.build_packed_layout),
             "banded": (jax_banded, tb.build_banded_layout)}[kind]
    jl, tl = build[0](*obs_args(J)), build[1](*obs_args(T))
    assert (tl is None) == (kind == "coo")
    kw = dict(max_iters=8, method="cg", cg_iters=300, lam0=1e-4)
    vj, hj = js.lm_solve(J, layout=jl, **kw)
    vt, ht = ts.lm_solve(T, layout=tl, **kw)
    assert len(ht) == len(hj) and ht[-1] < 1e-2 * ht[0]
    np.testing.assert_allclose(ht, hj, rtol=5e-4)
    np.testing.assert_allclose(vt.pose_t.numpy(), np.asarray(vj.pose_t),
                               atol=5e-4)


def test_lm_solve_device_cg(corridor_lm):
    """The device-loop entry point passes the CG settings through to the
    host loop it wraps."""
    _, T = corridor_lm
    vh, hh = ts.lm_solve(T, max_iters=3, method="cg", cg_iters=40,
                         cg_tol=1e-3)
    vd, hd, n = ts.lm_solve_device(T, max_iters=3, method="cg", cg_iters=40,
                                   cg_tol=1e-3)
    assert hd == hh and n == len(hh) - 1
    assert torch.equal(vd.pose_t, vh.pose_t)


def duplicated(J):
    """The JAX problem's fields with the first valid observation copied
    into the first padding slot: one (pose, point) pair seen twice."""
    f = jax_fields(J)
    n = int(f["obs_valid"].sum())
    assert n < len(f["obs_valid"])
    for k in ("obs_uv", "obs_pose", "obs_cam", "obs_point", "obs_sigma",
              "obs_valid"):
        f[k] = f[k].copy()
        f[k][n] = f[k][0]
    return f


def test_banded_refuses_duplicates(corridor_lm):
    """A duplicated observation: the port's banded builder refuses the
    problem and ``"auto"`` takes the packed layout, whose solve matches COO
    (a converged solve at lam = 1e-2; at 1e-3 float32 resolves the step to
    8e-3 only, in every solver, dense included) and whose LM run matches
    COO's; the JAX package's banded grid keeps one of the two observations
    while its Grams hold both, and its solve differs from its own COO by
    8.5e-3."""
    J0, _ = corridor_lm
    f = duplicated(J0)
    T = convert.problem_from_numpy(f, "cpu")
    J = J0._replace(**{k: jnp.asarray(f[k]) for k in (
        "obs_uv", "obs_pose", "obs_cam", "obs_point", "obs_sigma",
        "obs_valid")})
    assert tb.build_banded_layout(*obs_args(T)) is None
    auto = ts._auto_layout(T)
    assert isinstance(auto, tpk.PackedLayout)
    lt = ts.linearize(T, T.init)
    kw = dict(cg_iters=400, cg_tol=1e-7)
    dca, dpa, _ = ts.solve_delta(T, lt, 1e-2, layout=auto, **kw)
    dcc, dpc, _ = ts.solve_delta(T, lt, 1e-2, **kw)
    assert rel(dca, dcc) < 1e-4 and rel(dpa, dpc) < 1e-4
    lm = dict(max_iters=4, method="cg", cg_iters=150, lam0=1e-4)
    _, ha = ts.lm_solve(T, **lm)
    _, hc = ts.lm_solve(T, layout=None, **lm)
    np.testing.assert_allclose(ha, hc, rtol=1e-4)
    jbl = jax_banded(*obs_args(J))
    assert jbl is not None
    lj = js.linearize(J, J.init)
    dcb, _, _ = js.solve_delta(J, lj, jnp.float32(1e-2), layout=jbl, **kw)
    dcj, _, _ = js.solve_delta(J, lj, jnp.float32(1e-2), **kw)
    assert rel(dcb, dcj) > 2e-3
    assert rel(dcc, dcj) < 5e-4


def test_past_the_dense_gates():
    """A 700-pose corridor is past ``dense_method_ok``: ``"auto"`` takes
    CG over the banded grid and lowers the cost."""
    T, _ = tsyn.generate_corridor_problem(700, 2, device="cpu")
    assert not ts.dense_method_ok(T)
    assert isinstance(ts._auto_layout(T), tb.BandedLayout)
    v, hist = ts.lm_solve(T, max_iters=2, cg_iters=20)
    assert len(hist) == 3 and hist[-1] < hist[0]


def test_skew_sum():
    q = torch.arange(5 * 3 * 2, dtype=torch.float32).reshape(5, 3, 2)
    ref = torch.zeros(5 + 3, 2)
    for k in range(3):
        ref[k:k + 5] += q[:, k]
    assert torch.equal(tb._skew_sum(q), ref[:5])
