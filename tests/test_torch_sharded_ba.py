"""The port's sharded BA (``ba.packed``'s and ``ba.banded``'s sharded
layouts, ``ba.solver``'s group path, ``parallel.sharded_ba``) against
mqslam_tpu's on the CPU.

Tolerances: the sharded layout tables and the observation permutation equal
the JAX package's as integers.  The applies of every rank's block, summed
over the ranks, against the port's single-device applies over the same
layout at 1e-5 relative (both given the same damped point inverse: the
banded grid's permuted observation order changes Hpp's last bits, and the
ill-conditioned inverse of a weakly constrained landmark turns those into
1e-4 in W M W^T; the float64 math agrees to 1e-13).  One sharded LM
iteration against the JAX package's over its 8-device mesh at 1e-4
relative.  Whole solves: cost histories at 5e-3 relative, the JAX
package's own bound between its sharded and single-device solves.

In-process ranks are threads: ``ThreadRanks`` stands in for
``torch.distributed`` and sums the ranks' tensors in rank order where an
``all_reduce`` would (a loop over ranks in place of the collective).  The
two-process solve runs real gloo ranks in child processes that import no
JAX.  torch runs on one thread here so that its sums have one order."""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from mqslam_tpu.ba import problem as jp, synthetic as jsyn
from mqslam_tpu.ba.banded import build_sharded_banded_layout as jax_sbl
from mqslam_tpu.ba.packed import build_sharded_packed_layout as jax_spl
from mqslam_tpu.parallel import sharded_ba as jsb
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import banded as tb, packed as tpk
from mqslam_tpu_torch.ba import solver as ts
from mqslam_tpu_torch.ba import synthetic as tsyn
from mqslam_tpu_torch.parallel import multihost, sharded_ba as tsb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ThreadRanks:
    """n ranks as n threads of this process, standing in for
    ``torch.distributed``: ``all_reduce`` sums the ranks' tensors in rank
    order and writes the sum into each."""

    ReduceOp = dist.ReduceOp

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()

    def get_rank(self, group=None):
        return self.local.rank

    def get_world_size(self, group=None):
        return self.n

    def all_reduce(self, x, op=None, group=None):
        self.slots[self.local.rank] = x
        self.barrier.wait(60)
        total = self.slots[0].clone()
        for y in self.slots[1:]:
            total = total + y
        self.barrier.wait(60)
        x.copy_(total)

    def run(self, fn):
        """fn(rank) in every rank's thread; the ranks' results."""
        out, err = [None] * self.n, []

        def body(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:   # noqa: BLE001  (re-raised below)
                err.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        if err:
            raise err[0]
        return out


@pytest.fixture
def thread_ranks(monkeypatch):
    """make(n): a ThreadRanks that the solver and the sharded solve use in
    place of ``torch.distributed``."""
    def make(n):
        fake = ThreadRanks(n)
        monkeypatch.setattr(ts, "dist", fake)
        monkeypatch.setattr(tsb, "dist", fake)
        return fake
    return make


def jax_fields(J):
    f = {k: np.asarray(v) for k, v in J._asdict().items() if k != "init"}
    f["init"] = {k: np.asarray(v) for k, v in J.init._asdict().items()}
    return f


def rel(a, b):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def problems():
    """The 2-robot cube (``tests/test_parallel.py``'s) and the corridor at
    F = 64, in both packages: the same problem field by field."""
    cube = jp.problem_from_ba_data(jsyn.generate_cube_scenario(
        nr_cameras=2, nr_frames=20, seed=0))
    corr, _ = jsyn.generate_corridor_problem(nr_frames=64,
                                             points_per_frame=8)
    out = {}
    for name, J in (("cube", cube), ("corridor", corr)):
        out[name] = dict(J=J, T=convert.problem_from_numpy(jax_fields(J),
                                                            device="cpu"))
    return out


def padded_ids(T, n):
    P = tsb.pad_problem_for_shards(T, n)
    return (P.obs_pose, P.obs_point, P.obs_valid, T.n_poses, T.n_points, n)


def as_numpy(args):
    return tuple(np.asarray(a) if torch.is_tensor(a) else a for a in args)


CASES = [(p, n) for p in ("cube", "corridor") for n in (2, 4, 8)]


@pytest.mark.parametrize("name,n", CASES)
def test_sharded_packed_tables_equal_jax(problems, name, n):
    args = padded_ids(problems[name]["T"], n)
    lj = jax_spl(*as_numpy(args))
    lt = tpk.build_sharded_packed_layout(*args)
    assert lj is not None and lt is not None
    for f in lt._fields:
        a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the explicit rows of one rank, padded alike in both packages
    Jp = jsb.pad_problem_for_shards(problems[name]["J"], n)
    Tp = tsb.pad_problem_for_shards(problems[name]["T"], n)
    for f in tsb._OBS_FIELDS:
        assert np.array_equal(np.asarray(getattr(Jp, f)),
                              getattr(Tp, f).numpy()), f
    per = Tp.obs_pose.shape[0] // n
    loc = tsb.local_rows(problems[name]["T"], n - 1, n)
    assert np.array_equal(loc.obs_point.numpy(),
                          Tp.obs_point[(n - 1) * per:].numpy())


@pytest.mark.parametrize("name,n", CASES)
def test_sharded_banded_tables_equal_jax(problems, name, n):
    """Tables, permutation and pad mask as integers; the cube's observation
    runs are too short for the grid in both packages (None)."""
    args = padded_ids(problems[name]["T"], n)
    bj = jax_sbl(*as_numpy(args))
    bt = tb.build_sharded_banded_layout(*args)
    assert (bj is None) == (bt is None) == (name == "cube")
    if bt is None:
        return
    (lj, pj, vj), (lt, pt, vt) = bj, bt
    for f in lt._fields:
        a, b = getattr(lj, f), getattr(lt, f)
        if torch.is_tensor(b):
            assert np.array_equal(np.asarray(a), b.numpy()), f
        else:
            assert a == b, f
    assert np.array_equal(np.asarray(pj), pt.numpy())
    assert np.array_equal(np.asarray(vj), vt.numpy())
    Jperm = jax.tree_util.tree_map(
        np.asarray, jsb.pad_problem_for_shards(problems[name]["J"], n))
    from mqslam_tpu.ba.banded import permute_obs as jax_permute
    Jperm = jax_permute(Jperm, pj, vj)
    Tperm = tb.permute_obs(tsb.pad_problem_for_shards(problems[name]["T"],
                                                      n), pt, vt)
    for f in tsb._OBS_FIELDS:
        assert np.array_equal(np.asarray(getattr(Jperm, f)),
                              getattr(Tperm, f).numpy()), f


def test_degenerate_and_uneven_cases_return_none():
    """``tests/test_parallel.py``'s degenerate distributions: both packages
    build or refuse alike; no valid observation, observation rows that do
    not split, and (banded) poses that do not split are refused."""
    O, F, Pn = 512, 256, 64
    cases = [
        (np.zeros(O, np.int32), np.arange(O, dtype=np.int32) % Pn,
         np.ones(O, bool), F, Pn, 8),
        (np.repeat(np.arange(8, dtype=np.int32), O // 8),
         np.zeros(O, np.int32), np.ones(O, bool), F, Pn, 8),
        (np.zeros(O, np.int32), np.zeros(O, np.int32), np.zeros(O, bool),
         F, Pn, 8),
        (np.zeros(O - 1, np.int32), np.zeros(O - 1, np.int32),
         np.ones(O - 1, bool), F, Pn, 8),
    ]
    for i, args in enumerate(cases):
        lj = jax_spl(*args)
        lt = tpk.build_sharded_packed_layout(*args, device="cpu")
        assert (lj is None) == (lt is None), i
        if lt is not None:
            for f in lt._fields:
                assert np.array_equal(np.asarray(getattr(lj, f)),
                                      getattr(lt, f).numpy()), (i, f)
    assert tpk.build_sharded_packed_layout(*cases[2], device="cpu") is None
    assert tpk.build_sharded_packed_layout(*cases[3], device="cpu") is None
    # a corridor whose 24 poses do not split over 5 ranks
    T, _ = tsyn.generate_corridor_problem(24, 6, device="cpu")
    ids = (T.obs_pose, T.obs_point, T.obs_valid, T.n_poses, T.n_points)
    assert tb.build_banded_layout(*ids) is not None
    assert tb.build_sharded_banded_layout(*ids, 5) is None
    assert jax_sbl(*as_numpy(ids), 5) is None


def _applies(hooks, v, t):
    return dict(hcc=hooks.hcc(v), corr=hooks.corr(v), w_full=hooks.w_full(t),
                wt_full=hooks.wt_full(v), pre=hooks.pre())


@pytest.mark.parametrize("kind", ["coo", "packed", "banded"])
@pytest.mark.parametrize("n", [2, 8])
def test_shard_summed_applies_equal_single_device(problems, thread_ranks,
                                                  kind, n):
    """Each rank's linearization and applies over its block, reduced over
    the ranks (``_packed_ops_rows``, the sharded banded hooks, the COO
    rows), against the single-device applies of the same layout."""
    T = problems["corridor"]["T"]
    lam = 1e-3
    ids = (T.obs_pose, T.obs_point, T.obs_valid, T.n_poses, T.n_points)
    single = {"coo": None, "packed": tpk.build_packed_layout(*ids),
              "banded": tb.build_banded_layout(*ids)}[kind]
    lin = ts.linearize(T, T.init)
    hpp_solve, Hpp_inv = ts._hpp_damped(lin, lam)
    g = torch.Generator().manual_seed(0)
    v = torch.randn((T.n_poses, 6), generator=g)
    t = torch.randn((T.n_points, 3), generator=g)
    with ts._exact_f32():
        ref = _applies(ts._layout_hooks(T, lin, single, None, hpp_solve,
                                        Hpp_inv), v, t)
    ranks = thread_ranks(n)

    def rank(r):
        padded = tsb.pad_problem_for_shards(T, n)
        if kind == "banded":
            lay, padded = tsb.build_banded_for_mesh(padded, "group")
        else:
            lay = (tsb.build_layout_for_mesh(padded, "group")
                   if kind == "packed" else None)
        loc = tsb.shard_problem_for_mesh(padded, "group")
        lin_r = ts.linearize(loc, loc.init, group="group")
        with ts._exact_f32():
            hooks = ts._layout_hooks(loc, lin_r, lay, None, hpp_solve,
                                     Hpp_inv, group="group")
            return lin_r, _applies(hooks, v, t)

    outs = ranks.run(rank)
    for lin_r, applies in outs:
        for f in ("g_pose", "g_point", "Hpp", "diag_pose"):
            assert rel(getattr(lin_r, f), getattr(lin, f)) <= 1e-5, f
        assert abs(float(lin_r.cost) / float(lin.cost) - 1) <= 1e-6
        bad = {k: rel(x, ref[k]) for k, x in applies.items()
               if rel(x, ref[k]) > 1e-5}
        assert not bad, bad
    # every rank holds the same reduced result
    for k in ref:
        assert all(torch.equal(o[1][k], outs[0][1][k]) for o in outs), k


def test_sharded_iteration_matches_jax_mesh(problems, thread_ranks):
    """One ``make_sharded_lm_iteration`` (COO rows) over 8 ranks against
    the JAX package's over its 8-device mesh, and against the port's
    single-device linearize + solve_delta."""
    J, T = problems["cube"]["J"], problems["cube"]["T"]
    lam, iters = 1e-4, 400
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("data",))
    Js = jsb.shard_problem_for_mesh(J, mesh)
    dcj, dpj, cj = jsb.make_sharded_lm_iteration(mesh, cg_iters=iters)(
        Js, Js.init, jnp.float32(lam))
    ranks = thread_ranks(8)
    it = tsb.make_sharded_lm_iteration("group", cg_iters=iters)

    def rank(r):
        loc = tsb.shard_problem_for_mesh(T, "group")
        return it(loc, loc.init, lam)

    outs = ranks.run(rank)
    lin = ts.linearize(T, T.init)
    dc1, dp1, _ = ts.solve_delta(T, lin, lam, cg_iters=iters, cg_tol=1e-10)
    for dc, dp, c in outs:
        assert rel(dc, dcj) <= 1e-4 and rel(dp, dpj) <= 1e-4
        assert abs(float(c) / float(cj) - 1) <= 1e-4
        assert rel(dc, dc1) <= 1e-4 and rel(dp, dp1) <= 1e-4


def test_group_refusals(problems):
    """A single-device layout with a group, or a block of a sharded banded
    layout of two ranks without one, is refused; a one-rank block of either
    sharded layout runs without a group (no reduction: its rows are all the
    rows) and gives the single-device step."""
    T = problems["corridor"]["T"]
    ids = (T.obs_pose, T.obs_point, T.obs_valid, T.n_poses, T.n_points)
    lin = ts.linearize(T, T.init)
    for lay in (tpk.build_packed_layout(*ids), tb.build_banded_layout(*ids)):
        with pytest.raises(ValueError, match="single-device"):
            ts.solve_delta(T, lin, 1e-3, group="group", layout=lay)
    sb2, perm2, valid2 = tb.build_sharded_banded_layout(*ids, 2)
    T2 = tb.permute_obs(T, perm2, valid2)
    with pytest.raises(ValueError, match="process group"):
        ts.solve_delta(T2, ts.linearize(T2, T2.init), 1e-3,
                       layout=tpk.layout_shard(sb2, 0))
    dc1, dp1, _ = ts.solve_delta(T, lin, 1.0, cg_iters=300)
    sb, perm, valid = tb.build_sharded_banded_layout(*ids, 1)
    T1 = tb.permute_obs(T, perm, valid)
    sp = tpk.layout_shard(tpk.build_sharded_packed_layout(*ids, 1), 0)
    for prob, lay in ((T, sp), (T1, tpk.layout_shard(sb, 0))):
        dc, dp, _ = ts.solve_delta(prob, ts.linearize(prob, prob.init), 1.0,
                                   cg_iters=300, layout=lay)
        assert rel(dc, dc1) <= 1e-4 and rel(dp, dp1) <= 1e-4


WORKER = r"""
import json, sys
import numpy as np, torch
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.parallel import multihost, sharded_ba
rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                     backend="gloo", timeout_s=60)
z = np.load(src)
fields = {k: z[k] for k in z.files if not k.startswith("init.")}
fields["init"] = {k[5:]: z[k] for k in z.files if k.startswith("init.")}
prob = convert.problem_from_numpy(fields, device="cpu")
group = torch.distributed.group.WORLD
v, hist = sharded_ba.sharded_lm_solve(prob, group, max_iters=8,
                                      cg_iters=300)
v2, hist2, n = sharded_ba.sharded_lm_solve_device(prob, group, max_iters=8,
                                                  cg_iters=300)
with open(dst, "w") as f:
    json.dump(dict(hist=hist, hist_device=hist2, n=n,
                   pose_t=v.pose_t.tolist(),
                   pose_t_device=v2.pose_t.tolist()), f)
torch.distributed.destroy_process_group()
"""


def test_sharded_lm_solve_two_gloo_processes(problems, tmp_path):
    """``sharded_lm_solve`` (and ``sharded_lm_solve_device``) in two gloo
    processes on the cube against the JAX package's ``sharded_lm_solve``
    over its 8-device mesh and the port's single-device
    ``lm_solve(method="cg")``: histories within 5e-3 relative."""
    J, T = problems["cube"]["J"], problems["cube"]["T"]
    f = jax_fields(J)
    flat = {k: v for k, v in f.items() if k != "init"}
    flat.update({"init." + k: v for k, v in f["init"].items()})
    np.savez(tmp_path / "prob.npz", **flat)
    port = multihost.free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(port),
         str(tmp_path / "prob.npz"), str(tmp_path / f"out{r}.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, logs[r][-3000:]
    outs = [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(2)]
    # both ranks hold the same result; the device entry point is a wrapper
    assert outs[0] == outs[1]
    hist = outs[0]["hist"]
    assert outs[0]["hist_device"] == hist and outs[0]["n"] == len(hist) - 1
    assert outs[0]["pose_t_device"] == outs[0]["pose_t"]

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("data",))
    _, hj = jsb.sharded_lm_solve(J, mesh, max_iters=8, cg_iters=300)
    v1, h1 = ts.lm_solve(T, max_iters=8, cg_iters=300, method="cg")
    for ref in (hj, h1):
        m = min(len(ref), len(hist))
        np.testing.assert_allclose(hist[:m], ref[:m], rtol=5e-3)
        assert abs(hist[-1] / ref[-1] - 1) <= 5e-3
    np.testing.assert_allclose(outs[0]["pose_t"], v1.pose_t.numpy(),
                               atol=1e-3)
